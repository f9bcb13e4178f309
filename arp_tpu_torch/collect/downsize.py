"""Re-render demonstrations at low resolution (port of arp_tpu/collect/downsize.py; the reference's
downsize_demonstrations.py).

``downsize_by_replay`` walks a demo directory's ``traj_state_{i}.npy`` files,
restores each state into a low-resolution env and writes a new HDF5 whose
observations align with the original steps; it needs an env with
``set_state`` (the Procgen wrapper on the real engine or on the port's stub
and native engine, or FakeProcgen).  ``downsize_by_resize`` downsizes the
recorded frames themselves with the Pillow-exact bicubic resize
(ops/preprocess.py::resize_bicubic_pil_packed), on the device the caller names.

    python -m arp_tpu_torch.collect.downsize --data_path d/data_train.hdf5 --out_path small.hdf5 \\
        [--out_size 64] [--mode resize|replay] [--game_name coinrun] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops.preprocess import resize_bicubic_pil_packed
from .recorder import stack_episode_frames


def downsize_by_resize(data_path: str, out_path: str, out_size: int = 64, image_key: str = "ob",
                       device="cuda") -> None:
    """Downsize the recorded frames with the bit-exact Pillow bicubic resize on ``device`` (the card
    unless the caller asks for the CPU), 64 rows of the file at a time; other keys are copied."""
    import h5py

    dev = resolve_device(device)
    with h5py.File(data_path, "r") as g, h5py.File(out_path, "w") as out:
        for key in g.keys():
            if key != image_key:
                out.create_dataset(key, data=g[key][...], compression="gzip")
                continue
            ob = g[key]  # (T, F, H, W, C)
            T, F = ob.shape[:2]
            h, w, c = ob.shape[2:]
            ds = out.create_dataset(key, shape=(T, F, out_size, out_size, c), dtype=np.uint8, compression="gzip",
                                    chunks=(1, F, out_size, out_size, c))
            for t in range(0, T, 64):
                block = ob[t:t + 64]
                packed = torch.from_numpy(np.ascontiguousarray(block).reshape(-1, h, w * c)).to(dev)
                small = resize_bicubic_pil_packed(packed, c, out_size, out_size).to(torch.uint8).cpu().numpy()
                ds[t:t + 64] = small.reshape(block.shape[:2] + (out_size, out_size, c))


def downsize_by_replay(demo_dir: str, out_path: str, env, image_key: str = "ob", num_frames: int = 8) -> None:
    """Replay the saved engine states in a low-res env and record its frames, episode by episode."""
    import h5py

    episodes = sorted(
        (f for f in os.listdir(demo_dir) if f.startswith("traj_state_") and f.endswith(".npy")),
        # numeric episode order: lexicographic would put traj_state_10 before traj_state_2
        key=lambda f: int(f[len("traj_state_"):-len(".npy")]),
    )
    with h5py.File(out_path, "w") as out:
        ds = None
        for ep_file in episodes:
            states = np.load(os.path.join(demo_dir, ep_file), allow_pickle=True)
            env.reset()
            frames = [np.asarray(env.set_state(state)["image"][image_key]) for state in states]
            stacked = stack_episode_frames(np.stack(frames), num_frames)
            if ds is None:
                ds = out.create_dataset(image_key, data=stacked, compression="gzip",
                                        maxshape=(None,) + stacked.shape[1:], chunks=(1,) + stacked.shape[1:])
            else:
                ds.resize(ds.shape[0] + stacked.shape[0], axis=0)
                ds[-stacked.shape[0]:] = stacked


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Downsize demonstrations (resize, or replay the engine states).")
    p.add_argument("--data_path", required=True)
    p.add_argument("--out_path", required=True)
    p.add_argument("--out_size", type=int, default=64)
    p.add_argument("--mode", choices=["resize", "replay"], default="resize")
    p.add_argument("--game_name", default="coinrun")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mode == "resize":
        downsize_by_resize(args.data_path, args.out_path, args.out_size, device=args.device)
    else:
        from ..envs.procgen import Procgen

        env = Procgen(args.game_name, {}, image_resolution="low")
        downsize_by_replay(os.path.dirname(args.data_path), args.out_path, env)


if __name__ == "__main__":
    main()
