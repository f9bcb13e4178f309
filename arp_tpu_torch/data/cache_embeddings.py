"""Frozen-encoder embedding cache — ``python -m arp_tpu_torch.data.cache_embeddings``
(port of arp_tpu/data/cache_embeddings.py).

Encodes every step's last frame once through the CLIP reward engine's image
tower (eval preprocessing, no augmentation) and writes the L2-normalized
embeddings into the demo HDF5 as ``{key}_{name}_emb``; the policies read them
with ``transfer_type="..._cached"`` (the dataset's ``use_cached_embeddings``)
and train only the decision transformer and its heads.  Cached embeddings see
un-augmented frames, where the reference augments before the frozen encoder.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def cache_clip_embeddings(data_path: str, engine, image_keys: str = "ob", name: str = "clip") -> dict:
    """Write L2-normalized CLIP embeddings of every step's last frame; returns {key: shape}."""
    import h5py

    from ..reward.labeler import LastFrameWindow

    stats = {}
    with h5py.File(data_path, "a") as g:
        for key in image_keys.split(", "):
            # the lazy window keeps host memory O(batch) whatever the file's size
            emb = engine.encode_image_features(LastFrameWindow(g[key]), normalize=True)
            out_key = f"{key}_{name}_emb"
            if out_key in g:
                del g[out_key]
            g.create_dataset(out_key, data=emb.astype(np.float32), compression="gzip")
            stats[key] = emb.shape
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="Precompute frozen-encoder embeddings (PyTorch, one GPU).")
    p.add_argument("--data_path", required=True)
    p.add_argument("--image_keys", default="ob")
    p.add_argument("--model_name", default="vit_b16")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fast", action="store_true", help="packed fused-QKV encode path (ops/vit_infer.py)")
    p.add_argument("--fast_int8", action="store_true", help="static-int8 encode (calibrated on the first batch)")
    p.add_argument("--fast_score_bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="bf16 attention scores/softmax on the fast paths. Unset = the engine's default "
                        "(True, as in arp_tpu); --no-fast_score_bf16 forces fp32 softmax")
    p.add_argument("--fast_int8_attn", action=argparse.BooleanOptionalAction, default=None,
                   help="w8a8 attention on the int8 fast path (needs --fast_int8). Unset = the engine's "
                        "default (True under --fast_int8, as in arp_tpu)")
    p.add_argument("--mesh_dp", type=int, default=0,
                   help="shard encode batches data-parallel over this many local devices of --device "
                        "(-1 = all; 0 = one device, no mesh)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ..parallel.mesh import mesh_from_count
    from ..reward.engine import ClipRewardEngine

    mesh = mesh_from_count(args.mesh_dp, device_type=torch.device(args.device).type)
    if mesh is not None:
        print(f"[INFO] encoding data-parallel over {mesh.size} devices")

    # the weights: the local OpenAI checkpoint of --model_name (models/clip/model.py::load_model_vars)
    engine = ClipRewardEngine(model_name=args.model_name, batch_size=args.batch_size, resize_mode="pil",
                              device=args.device, compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                              fast_encode=args.fast, fast_int8=args.fast_int8, fast_score_bf16=args.fast_score_bf16,
                              fast_int8_attn=args.fast_int8_attn, mesh=mesh)
    stats = cache_clip_embeddings(args.data_path, engine, args.image_keys)
    print(f"[DONE] cached embeddings: {stats}")


if __name__ == "__main__":
    main()
