"""Reference PPG experts (torch ``.jd`` files) and the Flax-layout bridge (port of arp_tpu/collect/convert_ppg.py).

The reference collects demos with shipped torch PPG experts loaded by ``torch.load(model_path)``
(data/PPG/collect_procgen_data.py:31): whole pickled ``PhasicValueModel`` objects whose classes live
in the reference's ``phasic_policy_gradient`` package.

  * :func:`load_torch_ppg_state_dict` unpickles a ``.jd`` without that package (or gym3): a class it
    cannot import resolves to a stub ``nn.Module`` subclass, so the module tree's parameters come back
    and ``state_dict()`` walks them.  A file holding a plain state dict loads too;
  * :func:`convert_torch_ppg_state_dict` maps that state dict onto the JAX package's Flax tree
    (conv OIHW -> HWIO, the dense kernel's CHW -> HWC column order, ``{key}_vhead`` -> ``vf_head``);
  * :func:`flax_ppg_to_torch` / :func:`torch_ppg_to_flax` carry a Flax-layout tree (numpy) to the
    port's :class:`~arp_tpu_torch.collect.ppg.PhasicValueModel` state dict and back: each Dense
    kernel transposed, each Conv kernel HWIO <-> OIHW (the port's Impala flattens in (h, w, c) order,
    so the dense kernel's columns stay);
  * :func:`load_reference_ppg_expert` is the one call from a ``.jd`` path to a model with
    ``pool_padding="torch"`` (the reference's pooling alignment), weights loaded.

Inputs are [0, 1]-scaled frames (the torch model divides by 255 inside: the same numbers).
"""

from __future__ import annotations

import pickle
from typing import Mapping

import numpy as np
import torch
from torch import nn


def load_torch_ppg_state_dict(path: str) -> dict:
    """A numpy state dict from a reference ``.jd`` torch pickle (a whole model or a state dict),
    without the reference's ``phasic_policy_gradient`` or gym3 packages."""

    class _StubModule(nn.Module):
        def __init__(self, *args, **kwargs):
            super().__init__()

    class _StubObject:
        def __init__(self, *args, **kwargs):
            pass

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                # torch modules need nn.Module's machinery to restore their parameter and buffer
                # dicts; anything else only needs a shell
                if "gym3" in module or name.endswith("Type") or name in ("REAL", "DISCRETE"):
                    return _StubObject
                return type(name, (_StubModule,), {})

    class _PickleShim:
        Unpickler = _Unpickler
        load = staticmethod(lambda f, **kw: _Unpickler(f).load())

    with open(path, "rb") as f:
        obj = torch.load(f, map_location="cpu", weights_only=False, pickle_module=_PickleShim)
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    elif isinstance(obj, Mapping):
        sd = obj
    else:
        raise ValueError(f"unsupported checkpoint object {type(obj)!r}")
    return {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v) for k, v in sd.items()}


def _conv(sd, key):
    # torch OIHW -> Flax HWIO
    return {"kernel": np.transpose(sd[f"{key}.weight"], (2, 3, 1, 0)), "bias": sd[f"{key}.bias"]}


def _dense(sd, key):
    return {"kernel": np.transpose(sd[f"{key}.weight"]), "bias": sd[f"{key}.bias"]}


def _dense_from_chw(sd, key, chw):
    """A dense layer over a flattened feature map: torch flattens (C, H, W), Flax (H, W, C)."""
    c, h, w = chw
    weight = sd[f"{key}.weight"]  # (out, C*H*W)
    weight = weight.reshape(weight.shape[0], c, h, w).transpose(0, 2, 3, 1)
    weight = weight.reshape(weight.shape[0], h * w * c)
    return {"kernel": np.transpose(weight), "bias": sd[f"{key}.bias"]}


def _convert_impala(sd, prefix, inshape, chans=(16, 32, 32), nblock=2):
    out = {}
    h, w, _ = inshape
    for s, _ch in enumerate(chans):
        out[f"stack{s}_firstconv"] = _conv(sd, f"{prefix}.stacks.{s}.firstconv")
        h, w = (h + 1) // 2, (w + 1) // 2
        for b in range(nblock):
            out[f"stack{s}_block{b}_conv0"] = _conv(sd, f"{prefix}.stacks.{s}.blocks.{b}.conv0")
            out[f"stack{s}_block{b}_conv1"] = _conv(sd, f"{prefix}.stacks.{s}.blocks.{b}.conv1")
    out["dense"] = _dense_from_chw(sd, f"{prefix}.dense", (chans[-1], h, w))
    return out


def convert_torch_ppg_state_dict(sd: Mapping[str, np.ndarray], inshape=(64, 64, 3), arch: str = "dual",
                                 chans=(16, 32, 32), nblock: int = 2) -> dict:
    """A reference torch PhasicValueModel state dict -> the PhasicValueModel params in the Flax layout."""
    params = {
        "pi_enc": _convert_impala(sd, "pi_enc.cnn", inshape, chans, nblock),
        "pi_head": _dense(sd, "pi_head"),
        "aux_vf_head": _dense(sd, "aux_vf_head"),
    }
    if arch == "dual":
        params["vf_enc"] = _convert_impala(sd, "vf_enc.cnn", inshape, chans, nblock)
        params["vf_head"] = _dense(sd, "vf_vhead")
    else:  # shared / detach keep their value head under the pi key
        params["vf_head"] = _dense(sd, "pi_vhead")
    return params


def flax_ppg_to_torch(params: Mapping) -> dict:
    """PhasicValueModel params in the Flax layout (``{"pi_enc": {"stack0_firstconv": {"kernel", "bias"}}}``
    ..., or wrapped in ``{"params": ...}``) -> the port's state dict, float32."""
    if "params" in params and "pi_enc" not in params:
        params = params["params"]
    state = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if hasattr(value, "items"):
                walk(value, prefix + [key])
                continue
            arr = np.asarray(value, np.float32)
            if key == "kernel":
                key, arr = "weight", (arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1))
            state[".".join(prefix + [key])] = torch.tensor(np.array(arr, order="C"))

    walk(params, [])
    return state


def torch_ppg_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """The port's PhasicValueModel state dict -> its params in the Flax layout (nested dicts of
    float32 numpy): the inverse of :func:`flax_ppg_to_torch`."""
    params: dict = {}
    for name, value in state.items():
        *mods, leaf = name.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            leaf, arr = "kernel", (arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0))
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(arr, order="C")
    return params


def load_reference_ppg_expert(path: str, num_actions: int = 15, inshape=(64, 64, 3), arch: str = "dual"):
    """A ``.jd`` file -> (model, ``{"params": Flax-layout tree}``): the model (on the CPU, in eval mode)
    holds the weights and pools with torch's alignment, so converted experts act as the reference's."""
    from .ppg import PhasicValueModel

    sd = load_torch_ppg_state_dict(path)
    arch_found = "dual" if any(k.startswith("vf_enc.") for k in sd) else arch
    params = convert_torch_ppg_state_dict(sd, inshape=inshape, arch=arch_found)
    model = PhasicValueModel(num_actions=num_actions, arch=arch_found, pool_padding="torch")
    model.load_state_dict(flax_ppg_to_torch(params))  # the lazy input layers take the file's shapes
    return model.eval(), {"params": params}
