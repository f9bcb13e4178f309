"""arp_tpu (Flax) fine-tuning params -> arp_tpu_torch state dicts: the weight bridge.

The adapter's module tree mirrors the Flax one (``image_adapter.Dense_0.weight``
for ``image_adapter/Dense_0/kernel``), so its params convert by the rules of
:func:`arp_tpu_torch.models.policy.convert.flax_params_to_torch`: Dense kernels
transposed, the three scalars as they are.

The image decoder's ``ConvTranspose_k`` kernels take one more step.  Flax's
transposed convolution (``transpose_kernel=False``, "SAME" padding, stride 2,
kernel 4) correlates the stride-dilated input with the kernel as it is;
``torch.nn.ConvTranspose2d`` correlates it with the kernel flipped in both
spatial axes.  So the kernel (h, w, in, out) becomes (in, out, h, w), flipped.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..models.clip.convert import _flatten
from ..models.policy.convert import flax_params_to_torch


def flax_adapter_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``ClipMultiscaleAdapter`` params (with or without the ``{"params": ...}`` wrapper) ->
    ``ClipMultiscaleAdapter.load_state_dict`` input, float32."""
    return flax_params_to_torch(params)


def flax_decoder_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``LatentImageDecoder`` params -> the port module's ``load_state_dict`` input, float32."""
    tree = params["params"] if "params" in params else params
    transposed = {path: value for path, value in _flatten(tree).items() if path[0].startswith("ConvTranspose")}
    state = flax_params_to_torch(tree, skip=lambda path: path in transposed)
    for (*mods, leaf), value in transposed.items():
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            leaf, arr = "weight", arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        state[".".join([*mods, leaf])] = torch.tensor(np.ascontiguousarray(arr)).reshape(arr.shape)
    return state
