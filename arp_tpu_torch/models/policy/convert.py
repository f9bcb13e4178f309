"""arp_tpu (Flax) policy and M3AE params -> arp_tpu_torch state dicts: the weight bridge.

The port's module trees mirror the Flax ones, so a parameter's name is its
Flax path joined with dots, and the leaves map as:

    Dense      kernel (in, out)            -> weight (out, in)      (transposed)
    Conv       kernel (h, w, in, out)      -> weight (out, in, h, w)
    qkv        kernel (in, 3 * dim)        -> kernel                (kept fused, Flax layout)
    heads      Dense_k/kernel (E, in, out) -> kernel                (the vmapped ensemble axis leads)
    LayerNorm  scale                       -> weight
    Embed      embedding                   -> weight
    bias, cls_token, residual_weight, the type embeddings -> same name

The input is what ``arp_tpu`` holds: a ``params`` tree of nested mappings (a
Flax FrozenDict works), with or without the ``{"params": ...}`` wrapper.
Values are anything ``numpy.asarray`` takes.  The converters of the
reference's pickled checkpoints are not ported (no such file ships with the
repository).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..clip.convert import _flatten


def flax_params_to_torch(params: Mapping, skip=lambda path: False) -> dict[str, torch.Tensor]:
    """A Flax ``params`` tree -> a state dict by the rules above; ``skip(path)`` drops a leaf."""
    tree = params["params"] if "params" in params else params
    state = {}
    for path, value in _flatten(tree).items():
        if skip(path):
            continue
        *mods, leaf = path
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel" and "heads" not in mods and mods[-1] != "qkv":
            if arr.ndim == 2:
                leaf, arr = "weight", arr.T
            elif arr.ndim == 4:
                leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
            else:
                raise NotImplementedError(f"{'/'.join(path)}: no rule for a kernel of shape {arr.shape}")
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        # reshape: ascontiguousarray makes a 0-d array 1-d, and a scalar parameter is 0-d
        state[".".join([*mods, leaf])] = torch.tensor(np.ascontiguousarray(arr)).reshape(arr.shape)
    return state


def flax_m3ae_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax M3AE / MAE variables -> the port module's ``load_state_dict`` input, float32.

    The encoder side only: the decoder, its projections and the mask
    embeddings are dropped, as the port's modules hold no decoder.
    """
    return flax_params_to_torch(variables, skip=lambda path: path[0].startswith("decoder") or path[0].endswith("mask_embedding"))


def flax_policy_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ARPDT / BC / GCBC ``params`` -> ``BasePolicy.load_trained_state_dict`` input, float32.

    A tower trained inside the policy (``use_from_scratch``) sits under
    ``pt_model`` and converts by the same rules; a CLIP tower keeps its q/k/v
    Dense kernels apart, an M3AE tower its fused ``qkv/kernel``.
    """
    return flax_params_to_torch(params, skip=lambda path: path[0] == "pt_model" and (
        path[1].startswith("decoder") or path[1].endswith("mask_embedding")))
