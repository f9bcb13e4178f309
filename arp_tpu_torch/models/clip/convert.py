"""arp_tpu (Flax) CLIP variables -> arp_tpu_torch state dict: the weight bridge.

The port's module tree mirrors the Flax one (see model.py), so a parameter's
name is its Flax path joined with dots, and the leaves map as:

    Dense      kernel (in, out)  -> weight (out, in)   (transposed)
    Conv       kernel HWIO       -> weight OIHW        (the ResNet towers)
    LayerNorm, BatchNorm  scale  -> weight
    Embed      embedding         -> weight
    batch_stats  mean / var      -> running_mean / running_var (BatchNorm buffers)
    bias, class_embedding, positional_embedding, logit_scale -> same name

The input is what ``arp_tpu`` holds: ``{"params": {...}, "batch_stats": {...}}`` as nested
mappings (a Flax FrozenDict works) or flattened ``"params/a/b/c"`` keys, as
``ClipRewardEngine.save_npz`` writes them (both packages').  Values are
anything ``numpy.asarray`` takes.  Reading a spec needs only numpy.
:func:`torch_to_flax` is the inverse: a state dict back to the Flax tree.

:func:`convert_torch_clip_vars` is the other way in: an OpenAI CLIP state dict
(``torch.jit.load(...).state_dict()``, fused ``in_proj`` attention, a Conv2d
patch embedding; or a ModifiedResNet's convolutions, BatchNorms and attention
pool) to the same Flax-layout variables, as numpy, with ``batch_stats`` for a
ResNet as the JAX package's converter returns them.
"""

from __future__ import annotations

import json
import re
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


_STATS = {"mean": "running_mean", "var": "running_var"}


def flax_to_torch(variables_np: Mapping) -> dict[str, torch.Tensor]:
    """Flax CLIP variables (``params``, and a ResNet's ``batch_stats``) -> ``CLIP.load_state_dict``
    input, float32."""
    flat = _flatten(variables_np)
    state = {}
    for path, value in flat.items():
        if path[0] not in ("params", "batch_stats"):
            raise NotImplementedError(
                f"variable collection {path[0]!r} ({'/'.join(path)}): only params and batch_stats convert")
        *mods, leaf = path[1:]
        arr = np.asarray(value, dtype=np.float32)
        if path[0] == "batch_stats":
            if leaf not in _STATS:
                raise NotImplementedError(f"{'/'.join(path)}: a BatchNorm statistic is mean or var")
            leaf = _STATS[leaf]
        elif leaf == "kernel":
            if arr.ndim == 2:
                leaf, arr = "weight", arr.T
            elif arr.ndim == 4:
                leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
            else:
                raise NotImplementedError(f"{'/'.join(path)}: a Dense or Conv kernel is 2-D or 4-D, got {arr.shape}")
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        state[".".join([*mods, leaf])] = torch.tensor(np.array(arr, order="C"))
    return state


def torch_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """A CLIP state dict -> ``{"params": ...}`` (and ``"batch_stats"`` for a ResNet) in the Flax
    layout, float32 numpy: the inverse of :func:`flax_to_torch`.  A 2-D ``weight`` is a Dense kernel
    (transposed), or the token embedding's table; a 4-D one a Conv kernel (OIHW -> HWIO); a 1-D one a
    LayerNorm or BatchNorm scale.  A numeric name part joins the one before it (``resblocks.0``,
    ``layer1.0``, ``downsample.1``), as in the Flax names."""
    params: dict = {}
    stats: dict = {}
    for name, value in state.items():
        parts = []
        for part in name.split("."):
            if part.isdigit() and parts:
                parts[-1] = f"{parts[-1]}.{part}"
            else:
                parts.append(part)
        *mods, leaf = parts
        arr = value.detach().to("cpu", torch.float32).numpy()
        tree = params
        if leaf in ("running_mean", "running_var"):
            tree, leaf = stats, leaf.removeprefix("running_")
        elif leaf == "weight":
            if arr.ndim == 2:
                leaf, arr = ("embedding", arr) if mods[-1] == "token_embedding" else ("kernel", arr.T)
            elif arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 1:
                leaf = "scale"
            else:
                raise NotImplementedError(f"{name}: a {arr.ndim}-D weight has no Flax counterpart here")
        elif leaf not in ("bias", "class_embedding", "positional_embedding", "logit_scale"):
            raise NotImplementedError(f"{name}: only a float CLIP's parameters convert (not int8 weights)")
        _set(tree, [*mods, leaf], np.array(arr, order="C"))
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def _set(tree: dict, path: list, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = np.asarray(value)


def _unflatten(flat: dict) -> dict:
    """{path tuple: leaf} -> nested dicts: the inverse of :func:`_flatten`."""
    tree: dict = {}
    for path, value in flat.items():
        _set(tree, list(path), value)
    return tree


def _convert_transformer(out: dict, base_path: list, torch_prefix: str, sd: Mapping) -> None:
    """OpenAI resblocks -> the Flax tree: ``in_proj`` (3D, D) split into query / key / value Dense
    kernels (transposed), ``out_proj`` -> out, LayerNorm weight -> scale."""
    n_blocks = 0
    while f"{torch_prefix}resblocks.{n_blocks}.ln_1.weight" in sd:
        n_blocks += 1
    for i in range(n_blocks):
        tp, path = f"{torch_prefix}resblocks.{i}.", base_path + [f"resblocks.{i}"]
        for ln in ("ln_1", "ln_2"):
            _set(out, path + [ln, "scale"], sd[tp + ln + ".weight"])
            _set(out, path + [ln, "bias"], sd[tp + ln + ".bias"])
        w, b = sd[tp + "attn.in_proj_weight"], sd[tp + "attn.in_proj_bias"]
        d = w.shape[1]
        for j, name in enumerate(("query", "key", "value")):
            _set(out, path + ["attn", name, "kernel"], w[j * d : (j + 1) * d].T)
            _set(out, path + ["attn", name, "bias"], b[j * d : (j + 1) * d])
        _set(out, path + ["attn", "out", "kernel"], sd[tp + "attn.out_proj.weight"].T)
        _set(out, path + ["attn", "out", "bias"], sd[tp + "attn.out_proj.bias"])
        for mlp in ("c_fc", "c_proj"):
            _set(out, path + ["mlp", mlp, "kernel"], sd[tp + "mlp." + mlp + ".weight"].T)
            _set(out, path + ["mlp", mlp, "bias"], sd[tp + "mlp." + mlp + ".bias"])


def _convert_resnet_visual(params: dict, batch_stats: dict, sd: Mapping) -> None:
    """The ModifiedResNet tower: Conv2d OIHW -> HWIO kernels, BatchNorm2d -> scale / bias and
    ``batch_stats`` mean / var, stage blocks ``layerS.J``, the attention pool's q / k / v / c
    projections -> query / key / value / out (transposed)."""
    def conv(path, key):
        _set(params, path + ["kernel"], sd[key].transpose(2, 3, 1, 0))

    def bn(path, key):
        _set(params, path + ["scale"], sd[key + ".weight"])
        _set(params, path + ["bias"], sd[key + ".bias"])
        _set(batch_stats, path + ["mean"], sd[key + ".running_mean"])
        _set(batch_stats, path + ["var"], sd[key + ".running_var"])

    for i in (1, 2, 3):
        conv(["visual", f"conv{i}"], f"visual.conv{i}.weight")
        bn(["visual", f"bn{i}"], f"visual.bn{i}")
    blocks = sorted({m.group(1) for k in sd for m in [re.match(r"visual\.(layer\d+\.\d+)\.", k)] if m})
    for bk in blocks:
        path = ["visual", bk]
        for j in (1, 2, 3):
            conv(path + [f"conv{j}"], f"visual.{bk}.conv{j}.weight")
            bn(path + [f"bn{j}"], f"visual.{bk}.bn{j}")
        if f"visual.{bk}.downsample.0.weight" in sd:
            conv(path + ["downsample.0"], f"visual.{bk}.downsample.0.weight")
            bn(path + ["downsample.1"], f"visual.{bk}.downsample.1")
    ap = "visual.attnpool."
    _set(params, ["visual", "attnpool", "positional_embedding"], sd[ap + "positional_embedding"])
    for torch_name, flax_name in (("q_proj", "query"), ("k_proj", "key"), ("v_proj", "value"), ("c_proj", "out")):
        _set(params, ["visual", "attnpool", flax_name, "kernel"], sd[ap + torch_name + ".weight"].T)
        _set(params, ["visual", "attnpool", flax_name, "bias"], sd[ap + torch_name + ".bias"])


def _convert_vit_visual(params: dict, sd: Mapping) -> None:
    # Conv2d patch embedding (F, C, P, P) -> Dense kernel (P*P*C, F) in (p_row, p_col, channel) order
    w = sd["visual.conv1.weight"]
    _set(params, ["visual", "conv1", "kernel"], w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]))
    _set(params, ["visual", "class_embedding"], sd["visual.class_embedding"])
    _set(params, ["visual", "positional_embedding"], sd["visual.positional_embedding"])
    for ln in ("ln_pre", "ln_post"):
        _set(params, ["visual", ln, "scale"], sd[f"visual.{ln}.weight"])
        _set(params, ["visual", ln, "bias"], sd[f"visual.{ln}.bias"])
    _convert_transformer(params, ["visual", "transformer"], "visual.transformer.", sd)
    if "visual.proj" in sd:
        _set(params, ["visual", "proj", "kernel"], sd["visual.proj"])


def convert_torch_clip_vars(sd: Mapping) -> dict:
    """An OpenAI CLIP state dict (numpy or tensor values; ViT or ModifiedResNet) -> ``{"params": ...}``
    in the Flax layout, with ``"batch_stats"`` for a ResNet."""
    sd = {k: np.asarray(v) for k, v in sd.items() if "num_batches_tracked" not in k}
    for meta in ("context_length", "input_resolution", "vocab_size"):
        sd.pop(meta, None)
    params: dict = {}
    batch_stats: dict = {}
    if "visual.conv1.weight" in sd and "visual.class_embedding" in sd:
        _convert_vit_visual(params, sd)
    else:
        _convert_resnet_visual(params, batch_stats, sd)
    _set(params, ["text", "token_embedding", "embedding"], sd["token_embedding.weight"])
    _set(params, ["text", "positional_embedding"], sd["positional_embedding"])
    _convert_transformer(params, ["text", "transformer"], "transformer.", sd)
    _set(params, ["text", "ln_final", "scale"], sd["ln_final.weight"])
    _set(params, ["text", "ln_final", "bias"], sd["ln_final.bias"])
    _set(params, ["text", "text_projection", "kernel"], sd["text_projection"])
    _set(params, ["logit_scale"], sd["logit_scale"])
    return {"params": params, "batch_stats": batch_stats} if batch_stats else {"params": params}


def read_engine_spec(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Read an ``arp_tpu`` ``ClipRewardEngine.save_npz`` spec: (meta, flat variables)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, flat
