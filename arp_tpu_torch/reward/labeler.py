"""Offline reward labeling on one GPU — ``python -m arp_tpu_torch.reward.labeler``.

Port of arp_tpu/reward/labeler.py.  It reads a demonstration HDF5 file,
computes CLIP rewards for every step's last stacked frame, and writes the same
datasets as the JAX labeler, in place:

    {img_key}_{model_type}_reward[_{inst_type}]   (T, num_frames) gzip
    {img_key}_{model_type}_pos_rtg[_{inst_type}]  (T, num_frames) gzip

each stamped with ``tokenizer_identity`` and ``encode_recipe`` attributes (the
port's recipe starts with ``torch;``).  All frames stream through the batched
engine; the per-trajectory cumsum and frame re-stacking run on the host
afterwards.

:func:`label_group` holds the logic and takes any h5py-like group (``get``,
``[key]`` slicing, ``create_dataset``, ``attrs``); :func:`label_rewards`
opens the file.  ``h5py`` is imported only there and in
:func:`merge_reward_shards`.

Several hosts: each labels a contiguous whole-trajectory share of the file
(:func:`shard_trajectory_range`, ``num_hosts`` / ``host_index``) and writes a
``.rshard{i}.npz`` sidecar beside it (HDF5 has no safe concurrent writers);
:func:`merge_reward_shards` (``--merge``) checks them and writes the datasets a
single host would have written.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.instructions import get_clip_instruct, get_clip_special_instruct
from ..ops.rewards import discount_cumsum, stack_frames
from ..parallel.mesh import mesh_from_count
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


def shard_trajectory_range(traj_idx, len_data: int, num_hosts: int, host_index: int):
    """Contiguous, disjoint, whole-trajectory share of the rows for this host.

    A trajectory goes to the host whose row range ``[round(len_data * h / num_hosts), ...)`` its
    start falls in, so every host derives the same partition from the same file, the union covers
    every row once, and no trajectory's cumsum crosses hosts.  Returns
    ``(traj_lo, traj_hi, row_lo, row_hi)``: trajectory indices into the segment list, rows
    ``[row_lo, row_hi)``.
    """
    if not 0 <= host_index < num_hosts:
        raise ValueError(f"host_index {host_index} is not in [0, {num_hosts})")
    starts = np.asarray(traj_idx[:-1])
    bounds = np.round(len_data * np.arange(num_hosts + 1) / num_hosts).astype(int)
    owner = np.searchsorted(bounds[1:], starts, side="right")
    mine = np.nonzero(owner == host_index)[0]
    if len(mine) == 0:
        return 0, 0, 0, 0
    traj_lo, traj_hi = int(mine[0]), int(mine[-1]) + 1
    row_lo = int(traj_idx[traj_lo])
    row_hi = int(min(traj_idx[traj_hi], len_data))
    return traj_lo, traj_hi, row_lo, row_hi


def _shard_path(data_path: str, target_key_base: str, host_index: int) -> str:
    return f"{data_path}.{target_key_base}.rshard{host_index}.npz"


def _target_keys(model_type: str, inst_type: str) -> list[str]:
    keys = [f"{model_type}_reward", f"{model_type}_pos_rtg"]
    return keys if inst_type == "none" else [f"{k}_{inst_type}" for k in keys]


def _write_rows(g, key: str, data: np.ndarray, identity: str, recipe: str) -> None:
    len_data, num_frames = data.shape
    if g.get(key) is None:
        g.create_dataset(key, compression="gzip", chunks=(1, num_frames), maxshape=(len_data, num_frames), data=data)
    else:
        g[key][...] = data
    g[key].attrs["tokenizer_identity"] = identity
    g[key].attrs["encode_recipe"] = recipe


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
    num_hosts: int = 1,
    host_index: int = 0,
) -> dict:
    """Label one open h5py-like group.  Returns timing/throughput stats.

    One host (``num_hosts=1``): writes the datasets in place.  Several: labels this host's rows
    only and writes nothing; ``stats["shard"]`` holds what :func:`label_rewards` saves as the
    host's sidecar."""
    traj_idx, len_data, num_frames = get_traj_boundaries(g)
    num_frames = num_frames_override or num_frames
    target_keys = _target_keys(model_type, inst_type)

    stats = {"frames": 0, "seconds": 0.0}
    goal_conditioned = "goal_conditioned" in model_type
    identity = "goal_conditioned" if goal_conditioned else engine.tokenizer_identity
    traj_lo, traj_hi, row_lo, row_hi = shard_trajectory_range(traj_idx, len_data, num_hosts, host_index)
    n_rows = row_hi - row_lo
    # this host's trajectories, as row slices relative to row_lo
    trajs = [slice(traj_idx[i] - row_lo, min(traj_idx[i + 1], len_data) - row_lo) for i in range(traj_lo, traj_hi)]

    payload = {}
    for img_key in image_keys.split(", "):
        t0 = time.perf_counter()
        rewards = np.zeros(n_rows, np.float32)
        if n_rows == 0:
            # more hosts than trajectories leaves a share empty: the engine is skipped (it takes no
            # empty batch), and the empty sidecar is still written, since the merge needs every one
            pass
        elif goal_conditioned:
            # per-trajectory goals: the last frame of each trajectory
            for traj in trajs:
                frames = LastFrameWindow(g[img_key], row_lo + traj.start, row_lo + traj.stop)
                rewards[traj] = engine.goal_rewards(frames, goal_index=-1)
        else:
            # one streamed pass; the lazy view keeps host memory O(batch)
            rewards[:] = engine.text_rewards(LastFrameWindow(g[img_key], row_lo, row_hi), text)
        elapsed = time.perf_counter() - t0
        stats["frames"] += n_rows
        stats["seconds"] += elapsed

        # per-trajectory return-to-go + frame re-stacking (host)
        reward_rows = np.zeros((n_rows, num_frames), np.float32)
        rtg_rows = np.zeros((n_rows, num_frames), np.float32)
        for traj in trajs:
            r = rewards[traj]
            reward_rows[traj] = stack_frames(r, num_frames)
            rtg_rows[traj] = stack_frames(discount_cumsum(r, gamma), num_frames)

        if num_hosts == 1:
            for suffix, data in zip(target_keys, (reward_rows, rtg_rows)):
                _write_rows(g, f"{img_key}_{suffix}", data, identity, engine.encode_recipe)
        else:
            payload[f"{img_key}__reward"] = reward_rows
            payload[f"{img_key}__rtg"] = rtg_rows
        if progress:
            print(f"[{img_key}] host {host_index}/{num_hosts} rows [{row_lo}:{row_hi}) in {elapsed:.2f}s = "
                  f"{n_rows / max(elapsed, 1e-9):.1f} frames/s")

    stats["fps"] = stats["frames"] / max(stats["seconds"], 1e-9)
    stats["rows"] = (row_lo, row_hi)
    if num_hosts > 1:
        stats["shard"] = dict(row_lo=row_lo, row_hi=row_hi, len_data=len_data, num_frames=num_frames,
                              num_hosts=num_hosts, image_keys=image_keys, target_keys=np.asarray(target_keys),
                              tokenizer_identity=identity, encode_recipe=engine.encode_recipe, **payload)
    return stats


def label_rewards(
    data_path: str,
    text,
    image_keys: str = "ob",
    model_type: str = "clip",
    engine: ClipRewardEngine | None = None,
    use_crop: bool = False,
    inst_type: str = "none",
    num_frames_override: int | None = None,
    batch_size: int = 256,
    resize_mode: str = "pil",
    variables=None,
    gamma: float = 1.0,
    progress: bool = True,
    num_hosts: int = 1,
    host_index: int = 0,
    device: str = "cuda",
) -> dict:
    """Label an HDF5 demo file.  Returns timing/throughput stats.

    One host: writes the datasets in place.  Several: this host's share goes to the sidecar
    ``<data_path>.<model_type>_reward[_<inst_type>].rshard<host_index>.npz`` and the file is only
    read; :func:`merge_reward_shards` assembles the sidecars afterwards.  ``use_crop``,
    ``resize_mode`` and ``batch_size`` configure the engine built when none is given."""
    import h5py

    if engine is None:
        engine = ClipRewardEngine(batch_size=batch_size, resize_mode=resize_mode, use_crop=use_crop,
                                  variables=variables, device=device)
    with h5py.File(data_path, "a" if num_hosts == 1 else "r") as g:
        stats = label_group(
            g, text, engine, image_keys=image_keys, model_type=model_type,
            inst_type=inst_type, num_frames_override=num_frames_override,
            gamma=gamma, progress=progress, num_hosts=num_hosts, host_index=host_index,
        )
    shard = stats.pop("shard", None)
    if shard is not None:
        np.savez_compressed(_shard_path(data_path, _target_keys(model_type, inst_type)[0], host_index), **shard)
    return stats


def merge_reward_shards(data_path: str, model_type: str = "clip", inst_type: str = "none",
                        cleanup: bool = True) -> dict:
    """Assemble the ``.rshard{i}.npz`` sidecars of a several-host run into the HDF5 file.

    Refuses a missing shard (FileNotFoundError), an unreadable one, one that disagrees with shard 0
    on the file's geometry, lacks an array or holds one of the wrong shape, overlapping rows and
    rows no shard covers (ValueError); then writes the datasets and stamps a single host writes.
    Run on one host after every labeling host finished."""
    import h5py

    target_keys = _target_keys(model_type, inst_type)

    def load_shard(h):
        path = _shard_path(data_path, target_keys[0], h)
        if not os.path.exists(path):
            raise FileNotFoundError(f"missing reward shard {path}: host {h} never finished "
                                    f"(or wrote under different --model_type/--inst_type flags)")
        try:
            s = np.load(path, allow_pickle=False)
            s.get("row_lo")  # read the zip directory now
        except Exception as e:  # zipfile and format errors: a truncated write
            raise ValueError(f"corrupted reward shard {path}: {e}") from e
        return path, s

    _, first = load_shard(0)
    num_hosts = int(first["num_hosts"])
    len_data = int(first["len_data"])
    num_frames = int(first["num_frames"])
    image_keys = str(first["image_keys"])
    identity = str(first["tokenizer_identity"])
    recipe = str(first["encode_recipe"]) if "encode_recipe" in first else "custom"

    shards = [load_shard(h) for h in range(num_hosts)]
    covered = np.zeros(len_data, bool)
    for path, s in shards:
        lo, hi = int(s["row_lo"]), int(s["row_hi"])
        # a truncated or foreign sidecar is refused here, not zero-filled into the merged dataset
        geometry = (int(s["num_hosts"]), int(s["len_data"]), int(s["num_frames"]))
        if geometry != (num_hosts, len_data, num_frames):
            raise ValueError(f"inconsistent shard {path}: (num_hosts, len_data, num_frames)={geometry} "
                             f"!= shard0's ({num_hosts}, {len_data}, {num_frames})")
        for img_key in image_keys.split(", "):
            for part in ("reward", "rtg"):
                name = f"{img_key}__{part}"
                if name not in s:
                    raise ValueError(f"corrupted reward shard {path}: missing array {name}")
                if s[name].shape != (hi - lo, num_frames):
                    raise ValueError(f"corrupted reward shard {path}: {name} has shape {s[name].shape}, "
                                     f"expected ({hi - lo}, {num_frames}) for rows [{lo}:{hi})")
        if covered[lo:hi].any():
            raise ValueError(f"overlapping shard rows [{lo}:{hi}) in {path}")
        covered[lo:hi] = True
    if not covered.all():
        missing = np.nonzero(~covered)[0]
        raise ValueError(f"shards cover {int(covered.sum())}/{len_data} rows (first uncovered row: {int(missing[0])})")

    with h5py.File(data_path, "a") as g:
        for img_key in image_keys.split(", "):
            for suffix, part in zip(target_keys, ("reward", "rtg")):
                data = np.zeros((len_data, num_frames), np.float32)
                for _, s in shards:
                    data[int(s["row_lo"]): int(s["row_hi"])] = s[f"{img_key}__{part}"]
                _write_rows(g, f"{img_key}_{suffix}", data, identity, recipe)
    for _, s in shards:
        s.close()
    if cleanup:
        for h in range(num_hosts):
            os.remove(_shard_path(data_path, target_keys[0], h))
    return {"num_hosts": num_hosts, "rows": len_data}


def default_data_path(args) -> str:
    """The collect stage's output file for these flags: its directory name
    (``data/procgen_dataset.py::dataset_dirname``) and ``data_{split}.hdf5``."""
    from ..data.procgen_dataset import dataset_dirname

    dirname = dataset_dirname(
        args.env_name,
        distribution_mode=args.distribution_mode,
        start_level=args.start_level,
        num_levels=args.num_levels,
        num_demonstrations=args.num_demonstrations,
        num_frames=args.num_frames,
        enable_filter=args.enable_filter,
        env_type=args.env_type,
    )
    return os.path.join(args.base_path, dirname, f"data_{args.split}.hdf5")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Label demonstrations with CLIP rewards (PyTorch, one GPU).")
    parser.add_argument("--env_name", type=str, default="coinrun")
    parser.add_argument("--env_type", type=str, default="none")
    parser.add_argument("--num_levels", type=int, default=500)
    parser.add_argument("--start_level", type=int, default=0)
    parser.add_argument("--distribution_mode", type=str, default="hard")
    parser.add_argument("--image_keys", type=str, default="ob")
    parser.add_argument("--data_path", type=str, default=None,
                        help="demo HDF5 file, labeled in place; default: the collect stage's file for the "
                             "flags below (default_data_path)")
    parser.add_argument("--base_path", type=str, default="./demonstrations")
    parser.add_argument("--num_demonstrations", type=int, default=500)
    parser.add_argument("--num_frames", type=int, default=8)
    parser.add_argument("--split", type=str, default="train",
                        help="which data_{split}.hdf5 to label when --data_path is not given")
    parser.add_argument("--enable_filter", type=lambda s: s.lower() in ("1", "true"), default=True,
                        help="must match the collect stage (affects the dirname suffix)")
    parser.add_argument("--model_type", type=str, default="clip")
    parser.add_argument("--model_ckpt_dir", type=str, default=None,
                        help="the fine-tuned adapter of --model_type clip_ft*: a directory the port's "
                             "finetune CLI wrote, or a pickle of arp_tpu's adapter params")
    parser.add_argument("--vl_checkpoint", type=str, default=None,
                        help=".npz engine spec written by ClipRewardEngine.save_npz (either package's)")
    parser.add_argument("--use_crop", type=lambda s: s.lower() in ("1", "true"), default=False,
                        help="center-crop each frame to half its side before the resize")
    parser.add_argument("--inst_type", type=str, default="none")
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--resize_mode", type=str, default="pil", choices=["pil", "host", "fast"],
                        help="pil: Pillow's bicubic on the card; host: the same bytes resized on the host "
                             "in C++ before the copy; fast: the antialiased float bicubic")
    parser.add_argument("--bf16", action="store_true", help="run the image tower in bfloat16")
    parser.add_argument("--int8", action="store_true",
                        help="int8 weight-only quantization (not applied with --vl_checkpoint, as in arp_tpu's labeler)")
    parser.add_argument("--fast", action="store_true",
                        help="packed fused-QKV encode path (ops/vit_infer.py)")
    parser.add_argument("--fast_int8", action="store_true",
                        help="static-int8 encode (calibrated on the first batch)")
    parser.add_argument("--fast_score_bf16", action=argparse.BooleanOptionalAction, default=None,
                        help="bf16 attention scores/softmax on the fast paths. Unset = the "
                             "engine's default (True, as in arp_tpu); --no-fast_score_bf16 forces "
                             "the fp32-softmax recipe. On CUDA kernel K1's softmax is fp32 either "
                             "way; the flag then acts only under int8 attention")
    parser.add_argument("--fast_int8_attn", action=argparse.BooleanOptionalAction, default=None,
                        help="w8a8 attention on the int8 fast path (int8 QK^T and P@V with "
                             "static scales; needs --fast_int8). Unset = the engine's default "
                             "(True under --fast_int8, as in arp_tpu)")
    parser.add_argument("--mesh_dp", type=int, default=0,
                        help="shard encode batches data-parallel over this many local devices of --device "
                             "(-1 = all; 0 = one device, no mesh)")
    parser.add_argument("--num_hosts", type=int, default=1,
                        help="hosts splitting this file (whole-trajectory contiguous shares; each host "
                             "writes a .rshard{i}.npz sidecar; assemble them with --merge)")
    parser.add_argument("--host_index", type=int, default=0, help="this host's share in [0, num_hosts)")
    parser.add_argument("--merge", action="store_true",
                        help="merge the .rshard{i}.npz sidecars of a --num_hosts run into the HDF5 file and "
                             "exit (once, after every host finished)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    env_name = args.env_name if args.env_type == "none" else f"{args.env_name}_{args.env_type}"
    if args.inst_type != "none":
        text = get_clip_special_instruct(env_name, args.inst_type)
    else:
        text = get_clip_instruct(env_name)
    print(f"[INFO] env_name: {env_name}\t instruction: {text}")

    data_path = args.data_path or default_data_path(args)
    if args.merge:
        stats = merge_reward_shards(data_path, model_type=args.model_type, inst_type=args.inst_type)
        print(f"[DONE] merged {stats['num_hosts']} host shards covering {stats['rows']} rows")
        return
    mesh = mesh_from_count(args.mesh_dp, device_type=torch.device(args.device).type)
    if mesh is not None:
        print(f"[INFO] labeling data-parallel over {mesh.size} devices")

    fast_kwargs = dict(fast_encode=args.fast, fast_int8=args.fast_int8, fast_score_bf16=args.fast_score_bf16,
                       fast_int8_attn=args.fast_int8_attn)
    engine_kwargs = dict(batch_size=args.batch_size, resize_mode=args.resize_mode, use_crop=args.use_crop,
                         device=args.device, compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                         mesh=mesh, **fast_kwargs)
    if args.model_type.startswith("clip_ft"):
        if args.model_ckpt_dir is None:
            raise ValueError("specify --model_ckpt_dir (adapter checkpoint)")
        from ..finetune.reward import ClipFtRewardEngine, load_adapter_params

        engine = ClipFtRewardEngine(adapter_params=load_adapter_params(args.model_ckpt_dir),
                                    batch_size=args.batch_size, use_crop=args.use_crop, device=args.device,
                                    mesh=mesh, **fast_kwargs)
    elif args.vl_checkpoint:  # the spec's engine takes no --int8, as arp_tpu's labeler builds it
        engine = ClipRewardEngine.from_npz(args.vl_checkpoint, **engine_kwargs)
    else:
        engine = ClipRewardEngine(quantize_weights=args.int8, **engine_kwargs)
    stats = label_rewards(
        data_path,
        text,
        image_keys=args.image_keys,
        model_type=args.model_type,
        engine=engine,
        inst_type=args.inst_type,
        num_hosts=args.num_hosts,
        host_index=args.host_index,
    )
    print(f"[DONE] {stats['frames']} frames @ {stats['fps']:.1f} frames/s")
    if args.num_hosts > 1:
        print(f"[INFO] shard rows {stats['rows']} written; run --merge after all hosts finish")


if __name__ == "__main__":
    main()
