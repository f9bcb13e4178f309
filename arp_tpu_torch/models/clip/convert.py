"""arp_tpu (Flax) CLIP variables -> arp_tpu_torch state dict: the weight bridge.

The port's module tree mirrors the Flax one (see model.py), so a parameter's
name is its Flax path joined with dots, and the leaves map as:

    Dense      kernel (in, out)  -> weight (out, in)   (transposed)
    LayerNorm  scale             -> weight
    Embed      embedding         -> weight
    bias, class_embedding, positional_embedding, logit_scale -> same name

The input is what ``arp_tpu`` holds: ``{"params": {...}}`` as nested
mappings (a Flax FrozenDict works) or flattened ``"params/a/b/c"`` keys, as
``arp_tpu``'s ``ClipRewardEngine.save_npz`` writes them.  Values are anything
``numpy.asarray`` takes.  Reading a spec needs only numpy.
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    flat = {}
    for key, value in tree.items():
        path = prefix + tuple(str(key).split("/"))
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def flax_to_torch(variables_np: Mapping) -> dict[str, torch.Tensor]:
    """Flax CLIP variables (ViT towers) -> ``CLIP.load_state_dict`` input, float32."""
    flat = _flatten(variables_np)
    state = {}
    for path, value in flat.items():
        if path[0] != "params":
            raise NotImplementedError(
                f"variable collection {path[0]!r} ({'/'.join(path)}): only ViT CLIP "
                "params are ported (ModifiedResNet batch_stats are not)"
            )
        *mods, leaf = path[1:]
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim != 2:
                raise NotImplementedError(f"{'/'.join(path)}: only Dense kernels are ported, got {arr.shape}")
            leaf, arr = "weight", arr.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        state[".".join([*mods, leaf])] = torch.tensor(arr)
    return state


def read_engine_spec(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Read an ``arp_tpu`` ``ClipRewardEngine.save_npz`` spec: (meta, flat variables)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, flat
