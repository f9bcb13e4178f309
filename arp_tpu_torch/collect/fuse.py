"""Fuse two env-type demo files at a ratio (port of arp_tpu/collect/fuse.py; the reference's fuse_data.py).

Takes ``ratio`` of the trajectories of file A and ``1 - ratio`` of file B,
each drawn by a permutation from ``np.random.default_rng(seed)``, into a new
HDF5 with the same schema.  ``python -m arp_tpu_torch.collect.fuse --path_a a.hdf5
--path_b b.hdf5 --out out.hdf5 [--ratio 0.5] [--seed 0]``.
"""

from __future__ import annotations

import argparse

import numpy as np


def _traj_slices(g):
    idx = list(np.nonzero(g["done"][:, -1])[0] + 1)
    idx.insert(0, 0)
    return [(idx[i], idx[i + 1]) for i in range(len(idx) - 1)]


def fuse(path_a: str, path_b: str, out_path: str, ratio: float = 0.5, seed: int = 0) -> None:
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path_a, "r") as ga, h5py.File(path_b, "r") as gb, h5py.File(out_path, "w") as go:
        slices_a = _traj_slices(ga)
        slices_b = _traj_slices(gb)
        n_a = int(round(len(slices_a) * ratio))
        n_b = int(round(len(slices_b) * (1.0 - ratio)))
        picked = [(ga, slices_a[s]) for s in rng.permutation(len(slices_a))[:n_a].tolist()] + [
            (gb, slices_b[s]) for s in rng.permutation(len(slices_b))[:n_b].tolist()]
        keys = [k for k in ga.keys() if k in gb]
        out = {k: [g[k][lo:hi] for g, (lo, hi) in picked] for k in keys}
        for k in keys:
            data = np.concatenate(out[k], axis=0)
            go.create_dataset(k, data=data, compression="gzip", chunks=(1,) + data.shape[1:])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Fuse two demo files at a ratio of their trajectories.")
    p.add_argument("--path_a", required=True)
    p.add_argument("--path_b", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    fuse(args.path_a, args.path_b, args.out, args.ratio, args.seed)


if __name__ == "__main__":
    main()
