"""Demo-file validator — ``python -m arp_tpu_torch.data.validate <file.hdf5>`` (copy of arp_tpu/data/validate.py).

Verifies a demonstration HDF5 against the schema the recorder writes
(``ob``/``act``/``reward``/``done``, all leading ``(N, num_frames)``) and the
invariants the dataset and the labeler rely on (trajectory boundaries, rtg
semantics) before a training run spends device time on it.

Checks (errors fail, warnings print; ``--strict`` promotes warnings):
  * required keys, consistent (N, F) leading dims, expected dtypes;
  * frames uint8 (N, F, H, W, 3);
  * ``done[:, -1]`` marks at least one trajectory end and the file ends on
    one (otherwise the last episode was truncated mid-write);
  * frame-stacking consistency: within a trajectory, row t's window shifts
    row t-1's by one (the deque semantics every consumer assumes);
  * labeled reward/rtg keys (if present): shape (N, F), finite, and the rtg
    column is the suffix-cumsum of the reward column per trajectory
    (gamma=1 check, warning only — other gammas are valid).

Exit code 0 = clean (or warnings without --strict), 1 = invalid.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np


class Report:
    def __init__(self):
        self.errors: list[str] = []
        self.warnings: list[str] = []

    def error(self, msg: str):
        self.errors.append(msg)

    def warn(self, msg: str):
        self.warnings.append(msg)


def validate_file(
    path: str, image_key: str = "ob", sample_rows: int = 64, strict_stacking: bool = True
) -> Report:
    """``strict_stacking=False`` demotes the frame-window shift check to a
    warning — synthetic datasets (test fixtures, ablation data) are
    legitimate trainer inputs that need not share the recorder's deque
    construction; pipeline-produced files always do."""
    import h5py

    rep = Report()
    try:
        g = h5py.File(path, "r")
    except OSError as e:
        rep.error(f"cannot open: {e}")
        return rep
    with g:
        for key in (image_key, "act", "done"):
            if key not in g:
                rep.error(f"missing required dataset {key!r}")
        if rep.errors:
            return rep

        frames, act, done = g[image_key], g["act"], g["done"]
        # rank guards first: everything below indexes dim 1, and a
        # rank-deficient dataset must report, not traceback
        if frames.ndim != 5 or frames.shape[-1] != 3:
            rep.error(f"{image_key}: expected (N, F, H, W, 3), got {frames.shape}")
            return rep
        if done.ndim != 2:
            rep.error(f"done: expected (N, F), got {done.shape}")
            return rep
        n, f = frames.shape[:2]
        if frames.dtype != np.uint8:
            rep.error(f"{image_key}: expected uint8 frames, got {frames.dtype}")
        for key in ("act", "reward", "done"):
            if key in g and g[key].shape[:2] != (n, f):
                rep.error(f"{key}: leading dims {g[key].shape[:2]} != {(n, f)}")
        if "reward" not in g:
            rep.warn("no 'reward' dataset (ok for unscored demos)")
        if act.dtype.kind not in "iu":
            rep.error(f"act: expected integer actions, got {act.dtype}")

        done_col = np.asarray(done[:, -1]).astype(bool)
        n_traj = int(done_col.sum())
        if n_traj == 0:
            rep.error("done[:, -1] marks no trajectory ends")
        elif not done_col[-1]:
            rep.error("file does not end on a trajectory boundary (truncated write?)")

        # deque-stacking spot check on a row sample: row t's first F-1 window
        # entries equal row t-1's last F-1, except across episode boundaries
        if f > 1 and n > 1:
            rng = np.random.default_rng(0)
            rows = np.unique(rng.integers(1, n, size=min(sample_rows, n - 1)))
            for t in rows:
                if done_col[t - 1]:
                    continue  # new episode starts at t
                if not np.array_equal(frames[t, :-1], frames[t - 1, 1:]):
                    sink = rep.error if strict_stacking else rep.warn
                    sink(
                        f"{image_key}: frame window at row {t} does not shift "
                        f"row {t - 1} by one (stacking broken)"
                    )
                    break

        # labeled keys the pipeline writes or reads (labeler.py target_keys,
        # procgen_dataset.py _reward_dataset_key):
        #   {img}_{model}_reward[_{inst}] (+ the reference's _pos_reward
        #   variant) pairing with {img}_{model}_pos_rtg[_{inst}]
        bounds = np.concatenate([[0], np.nonzero(done_col)[0] + 1])
        for key in g:
            m = re.match(
                rf"^{re.escape(image_key)}_(?P<model>.+?)_(?:pos_)?reward(?P<inst>_\w+)?$",
                key,
            )
            if m is None:
                continue
            rtg_key = f"{image_key}_{m.group('model')}_pos_rtg{m.group('inst') or ''}"
            if g[key].shape[:2] != (n, f) or g[key].ndim != 2:
                rep.error(f"{key}: shape {g[key].shape} != {(n, f)}")
                continue
            r = np.asarray(g[key][:, -1], np.float64)
            if not np.isfinite(r).all():
                rep.error(f"{key}: non-finite rewards")
            if rtg_key not in g:
                rep.warn(f"{key} present without {rtg_key}")
                continue
            if g[rtg_key].ndim != 2 or g[rtg_key].shape[:2] != (n, f):
                rep.error(f"{rtg_key}: shape {g[rtg_key].shape} != {(n, f)}")
                continue
            rtg = np.asarray(g[rtg_key][:, -1], np.float64)
            gamma1 = all(
                np.allclose(rtg[a:b], np.cumsum(r[a:b][::-1])[::-1], atol=1e-3)
                for a, b in zip(bounds[:-1], bounds[1:])
            )
            if not gamma1:
                rep.warn(
                    f"{rtg_key} is not the gamma=1 suffix-cumsum of {key} "
                    "(fine if labeled with gamma<1; otherwise re-label)"
                )
    return rep


def main():
    parser = argparse.ArgumentParser(description="Validate a demonstration HDF5 file.")
    parser.add_argument("paths", nargs="+")
    parser.add_argument("--image_key", default="ob")
    parser.add_argument("--strict", action="store_true",
                        help="treat warnings as errors")
    args = parser.parse_args()

    bad = False
    for path in args.paths:
        rep = validate_file(path, image_key=args.image_key)
        for w in rep.warnings:
            print(f"[WARN] {path}: {w}")
        for e in rep.errors:
            print(f"[ERROR] {path}: {e}")
        if rep.errors or (args.strict and rep.warnings):
            bad = True
        else:
            print(f"[OK] {path}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
