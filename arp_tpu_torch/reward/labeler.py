"""Offline reward labeling on one GPU — ``python -m arp_tpu_torch.reward.labeler``.

Port of arp_tpu/reward/labeler.py for one host.  It reads a demonstration
HDF5 file, computes CLIP rewards for every step's last stacked frame, and
writes the same datasets as the JAX labeler, in place:

    {img_key}_{model_type}_reward[_{inst_type}]   (T, num_frames) gzip
    {img_key}_{model_type}_pos_rtg[_{inst_type}]  (T, num_frames) gzip

each stamped with ``tokenizer_identity`` and ``encode_recipe`` attributes (the
port's recipe starts with ``torch;``).  All frames stream through the batched
engine; the per-trajectory cumsum and frame re-stacking run on the host
afterwards.

:func:`label_group` holds the logic and takes any h5py-like group (``get``,
``[key]`` slicing, ``create_dataset``, ``attrs``); :func:`label_rewards`
opens the file.  ``h5py`` is imported only there.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data.instructions import get_clip_instruct, get_clip_special_instruct
from ..ops.rewards import discount_cumsum, stack_frames
from .engine import ClipRewardEngine


class LastFrameWindow:
    """Lazy ``ds[:, -1]`` row-window view of an HDF5 dataset.

    The engine's producer thread slices ``frames[start:start+batch]`` per
    chunk; handing it this view makes each slice an O(batch) read, so host
    memory stays O(batch) instead of O(file).
    """

    def __init__(self, ds, start: int = 0, stop: int | None = None):
        self._ds = ds
        self._start = start
        self._stop = ds.shape[0] if stop is None else min(stop, ds.shape[0])
        self.shape = (self._stop - self._start,) + tuple(ds.shape[2:])

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, sl):
        if not isinstance(sl, slice):
            idx = int(sl)
            if idx < 0:
                idx += self.shape[0]
            if not 0 <= idx < self.shape[0]:
                raise IndexError(sl)
            return self._ds[self._start + idx, -1]
        lo, hi, step = sl.indices(self.shape[0])
        if step != 1:
            raise ValueError("LastFrameWindow supports contiguous slices only")
        return self._ds[self._start + lo : self._start + hi, -1]


def get_traj_boundaries(g) -> tuple[list[int], int, int]:
    """Trajectory start indices from done/rewards/is_terminal/time datasets."""
    done_key = None
    for key in ("done", "rewards", "is_terminal"):
        if g.get(key) is not None:
            done_key = key
            break
    if done_key is not None:
        len_data, num_frames = g[done_key].shape[:2]
        traj_idx = list(np.nonzero(g[done_key][:, -1])[0] + 1)
        traj_idx.insert(0, 0)
    else:
        len_data, num_frames = g["time"].shape[:2]
        traj_idx = list(np.where(g["time"][:, -1, 0] == 1.0)[0])
        traj_idx.append(len(g["time"]))
    return traj_idx, len_data, num_frames


def label_group(
    g,
    text,
    engine: ClipRewardEngine,
    image_keys: str = "ob",
    model_type: str = "clip",
    inst_type: str = "none",
    num_frames_override: int | None = None,
    gamma: float = 1.0,
    progress: bool = True,
) -> dict:
    """Label one open h5py-like group in place.  Returns timing/throughput stats."""
    traj_idx, len_data, num_frames = get_traj_boundaries(g)
    num_frames = num_frames_override or num_frames

    target_keys = [f"{model_type}_reward", f"{model_type}_pos_rtg"]
    if inst_type != "none":
        target_keys = [f"{k}_{inst_type}" for k in target_keys]

    stats = {"frames": 0, "seconds": 0.0}
    goal_conditioned = "goal_conditioned" in model_type
    identity = "goal_conditioned" if goal_conditioned else engine.tokenizer_identity
    trajs = [slice(traj_idx[i], min(traj_idx[i + 1], len_data)) for i in range(len(traj_idx) - 1)]

    for img_key in image_keys.split(", "):
        t0 = time.perf_counter()
        rewards = np.zeros(len_data, np.float32)
        if goal_conditioned:
            # per-trajectory goals: the last frame of each trajectory
            for traj in trajs:
                frames = LastFrameWindow(g[img_key], traj.start, traj.stop)
                rewards[traj] = engine.goal_rewards(frames, goal_index=-1)
        else:
            # one streamed pass; the lazy view keeps host memory O(batch)
            rewards[:] = engine.text_rewards(LastFrameWindow(g[img_key]), text)
        elapsed = time.perf_counter() - t0
        stats["frames"] += len_data
        stats["seconds"] += elapsed

        # per-trajectory return-to-go + frame re-stacking (host)
        reward_rows = np.zeros((len_data, num_frames), np.float32)
        rtg_rows = np.zeros((len_data, num_frames), np.float32)
        for traj in trajs:
            r = rewards[traj]
            reward_rows[traj] = stack_frames(r, num_frames)
            rtg_rows[traj] = stack_frames(discount_cumsum(r, gamma), num_frames)

        for suffix, data in zip(target_keys, (reward_rows, rtg_rows)):
            key = f"{img_key}_{suffix}"
            if g.get(key) is None:
                g.create_dataset(
                    key,
                    compression="gzip",
                    chunks=(1, num_frames),
                    maxshape=(len_data, num_frames),
                    data=data,
                )
            else:
                g[key][...] = data
            g[key].attrs["tokenizer_identity"] = identity
            g[key].attrs["encode_recipe"] = engine.encode_recipe
        if progress:
            print(f"[{img_key}] {len_data} rows in {elapsed:.2f}s = {len_data / elapsed:.1f} frames/s")

    stats["fps"] = stats["frames"] / max(stats["seconds"], 1e-9)
    return stats


def label_rewards(
    data_path: str,
    text,
    image_keys: str = "ob",
    model_type: str = "clip",
    engine: ClipRewardEngine | None = None,
    inst_type: str = "none",
    num_frames_override: int | None = None,
    batch_size: int = 256,
    variables=None,
    gamma: float = 1.0,
    progress: bool = True,
    device: str = "cuda",
) -> dict:
    """Label an HDF5 demo file in place.  Returns timing/throughput stats."""
    import h5py

    if engine is None:
        engine = ClipRewardEngine(batch_size=batch_size, variables=variables, device=device)
    with h5py.File(data_path, "a") as g:
        return label_group(
            g, text, engine, image_keys=image_keys, model_type=model_type,
            inst_type=inst_type, num_frames_override=num_frames_override,
            gamma=gamma, progress=progress,
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description="Label demonstrations with CLIP rewards (PyTorch, one GPU).")
    parser.add_argument("--data_path", type=str, required=True, help="demo HDF5 file, labeled in place")
    parser.add_argument("--env_name", type=str, default="coinrun")
    parser.add_argument("--env_type", type=str, default="none")
    parser.add_argument("--image_keys", type=str, default="ob")
    parser.add_argument("--model_type", type=str, default="clip")
    parser.add_argument("--vl_checkpoint", type=str, default=None,
                        help=".npz engine spec written by arp_tpu's ClipRewardEngine.save_npz")
    parser.add_argument("--inst_type", type=str, default="none")
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--bf16", action="store_true", help="run the image tower in bfloat16")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    if args.model_type.startswith("clip_ft"):
        raise NotImplementedError("the fine-tuned (clip_ft) reward engine is not ported yet")
    env_name = args.env_name if args.env_type == "none" else f"{args.env_name}_{args.env_type}"
    if args.inst_type != "none":
        text = get_clip_special_instruct(env_name, args.inst_type)
    else:
        text = get_clip_instruct(env_name)
    print(f"[INFO] env_name: {env_name}\t instruction: {text}")

    engine_kwargs = dict(
        batch_size=args.batch_size,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device,
    )
    if args.vl_checkpoint:
        engine = ClipRewardEngine.from_npz(args.vl_checkpoint, **engine_kwargs)
    else:
        engine = ClipRewardEngine(**engine_kwargs)
    stats = label_rewards(
        args.data_path,
        text,
        image_keys=args.image_keys,
        model_type=args.model_type,
        engine=engine,
        inst_type=args.inst_type,
    )
    print(f"[DONE] {stats['frames']} frames @ {stats['fps']:.1f} frames/s")


if __name__ == "__main__":
    main()
