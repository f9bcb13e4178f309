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
Values are anything ``numpy.asarray`` takes.  :func:`torch_policy_to_flax`
is the inverse of :func:`flax_policy_to_torch`.

The reference's own policy checkpoints name their modules another way:
:func:`convert_reference_policy_params` and
:func:`export_reference_policy_params` rename numpy trees in the Flax layout
between the two, as the JAX package's ``models/policy/convert.py`` does:

  * the reference's policy transformer uses auto-generated names
    (policy/Block_i/Attention_0/Dense_0 ...), the port's tree is named
    (policy/blocks_i/attn/qkv ...);
  * the reference's "ensemble" heads are ``[nn.Sequential(...)] * N``, a list
    of ONE module instance, which flax deduplicates to one parameter set
    (only ``action_outputs_0`` exists).  All N members are the same, so the
    single head is broadcast into every slot of the port's EnsembleHeads,
    which reproduces the reference's output exactly.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..clip.convert import _flatten, _unflatten
from ..m3ae import convert_reference_m3ae_params


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


def _is_decoder_leaf(path) -> bool:
    """A leaf of the autoencoder's decoder side (Flax creates them only when ``__call__`` is initialised)."""
    return path[0].startswith("decoder") or path[0].endswith("mask_embedding")


def flax_m3ae_to_torch(variables: Mapping, decoder: bool = False) -> dict[str, torch.Tensor]:
    """Flax M3AE / MAE variables -> the port module's ``load_state_dict`` input, float32.

    By default the encoder side only: the decoder, its projection, type embeddings and output
    heads and the mask embeddings are dropped, for a module built as the policies build it.
    ``decoder=True`` carries the whole autoencoder tree, for a module built with ``decoder=True``
    (the output heads' ``Dense_i`` / ``LayerNorm_i`` by the rules above).
    """
    return flax_params_to_torch(variables, skip=(lambda path: False) if decoder else _is_decoder_leaf)


def flax_policy_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ARPDT / BC / GCBC ``params`` -> ``BasePolicy.load_trained_state_dict`` input, float32.

    A tower trained inside the policy (``use_from_scratch``) sits under
    ``pt_model`` and converts by the same rules; a CLIP tower keeps its q/k/v
    Dense kernels apart, an M3AE tower its fused ``qkv/kernel``.  A pipelined
    policy's ``policy/stacked_blocks`` (JAX's ``pp_stages > 1`` layout) comes
    out under the flat names ``policy.blocks_i``, which every layout of the port loads.
    """
    from ..layers import unstack_transformer_params

    tree = params["params"] if "params" in params else params
    if "policy" in tree and "stacked_blocks" in tree["policy"]:
        tree = dict(tree, policy=unstack_transformer_params(tree["policy"]))
    return flax_params_to_torch(tree, skip=lambda path: path[0] == "pt_model" and _is_decoder_leaf(path[1:]))


# the Embed modules: the discrete actions' (the reference's policies act in Procgen's 15) and the towers' tokens
_EMBEDDINGS = ("action_input", "text_embedding", "token_embedding")


def flax_path(name: str, ndim: int) -> tuple:
    """The Flax path of the port's parameter ``name`` of rank ``ndim``: a 2-D ``weight`` is a Dense
    kernel, or an Embed table where its module is one of ``_EMBEDDINGS``; a 4-D one a Conv kernel; a
    1-D one a LayerNorm scale.  A numeric name part joins the one before it (``resblocks.0``), as in
    the Flax names."""
    parts = []
    for part in name.split("."):
        if part.isdigit() and parts:
            parts[-1] = f"{parts[-1]}.{part}"
        else:
            parts.append(part)
    *mods, leaf = parts
    if leaf == "weight":
        if ndim == 2:
            leaf = "embedding" if mods[-1] in _EMBEDDINGS else "kernel"
        elif ndim == 4:
            leaf = "kernel"
        elif ndim == 1:
            leaf = "scale"
        else:
            raise NotImplementedError(f"{name}: a {ndim}-D weight has no Flax counterpart here")
    return (*mods, leaf)


def torch_policy_to_flax(state: Mapping[str, torch.Tensor], pp_stages: int = 1) -> dict:
    """A policy (or M3AE / MAE) state dict -> its ``params`` tree in the Flax layout, float32 numpy:
    the inverse of :func:`flax_policy_to_torch` and :func:`flax_m3ae_to_torch`, leaf for leaf, the
    names by :func:`flax_path` (Dense kernels transposed, Conv kernels OIHW -> HWIO).  ``pp_stages``
    above 1 writes the policy's blocks stacked in that many stages, JAX's pipelined layout."""
    from ..layers import stack_transformer_params

    flat = {}
    for name, value in state.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        path = flax_path(name, arr.ndim)
        if path[-1] == "kernel" and not name.endswith("kernel"):
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        flat[path] = np.array(arr, order="C")
    tree = _unflatten(flat)
    if pp_stages > 1:
        tree["policy"] = stack_transformer_params(tree["policy"], pp_stages)
    return tree


def convert_reference_policy_params(ref_params, num_ensembles: int = 5) -> dict:
    """Map reference ARPDT / BC / GCBC params onto the port's policy tree (Flax layout, numpy).

    The single deduplicated head (``action_outputs_0``, ``return_outputs_0``) is broadcast to
    ``num_ensembles`` members; a head deeper than two Dense layers raises.  Returns
    ``{"params": tree}``, as the JAX package's does.
    """
    ref_params = dict(ref_params)
    if "params" in ref_params:
        ref_params = dict(ref_params["params"])
    out_flat = {}
    if "policy" in ref_params:
        # the shared transformer: the m3ae auto-name mapper, its trailing LayerNorm_0 under 'policy' -> 'norm'
        mapped = _flatten(convert_reference_m3ae_params({"policy": ref_params.pop("policy")})["params"])
        for path, v in mapped.items():
            out_flat[tuple("norm" if p == "LayerNorm_0" else p for p in path)] = v

    def convert_heads(prefix: str):
        head0 = ref_params.pop(f"{prefix}_0", None)
        if head0 is None:
            return
        for i in range(1, num_ensembles):  # the other aliases, if a checkpoint materialized them
            ref_params.pop(f"{prefix}_{i}", None)
        flat = _flatten(head0)
        layer_map = {"layers_0": "Dense_0", "layers_2": "Dense_1"}  # the ReLU between is no module
        unknown = sorted({p[0] for p in flat if p[0] not in layer_map})
        if unknown:
            raise NotImplementedError(
                f"head {prefix!r} has unmapped layers {unknown}: checkpoints "
                "with output_head_depth > 0 need the head mapper extended "
                "(models/policy/convert.py)"
            )
        for path, v in flat.items():
            v = np.asarray(v)
            out_flat[(prefix, "heads", layer_map[path[0]]) + path[1:]] = np.ascontiguousarray(
                np.broadcast_to(v[None], (num_ensembles,) + v.shape))

    convert_heads("action_outputs")
    convert_heads("return_outputs")
    # identically named leaves (action_input, rtg_input, state_input, patch_emb, image_text_input,
    # residual_weight, the adapter, impala, ...)
    for path, v in _flatten(ref_params).items():
        out_flat[path] = np.asarray(v)
    return {"params": _unflatten(out_flat)}


def export_reference_policy_params(params, ensemble_mode: str = "require_tied") -> dict:
    """Inverse of :func:`convert_reference_policy_params`: the port's tree under the reference's
    names (numpy), the ensemble collapsed to the one head the reference holds.

    ``ensemble_mode``: ``"require_tied"`` (the default) raises unless every member is the same,
    and the export is then exact; ``"first"`` exports member 0; ``"mean"`` the parameters' mean
    (which approximates, but does not equal, the ensemble's mean output through the head).
    """
    if ensemble_mode not in ("require_tied", "first", "mean"):
        raise ValueError(f"unknown ensemble_mode {ensemble_mode!r}")
    params = dict(params)
    if "params" in params:
        params = dict(params["params"])
    out_flat = {}

    def export_heads(prefix: str):
        tree = params.pop(prefix, None)
        if tree is None:
            return
        layer_map = {"Dense_0": "layers_0", "Dense_1": "layers_2"}
        for path, v in _flatten(tree).items():
            # path = ("heads", "Dense_i", leaf); the ensemble leads
            if path[0] != "heads" or path[1] not in layer_map:
                raise NotImplementedError(
                    f"head {prefix!r} has unmapped subtree {path}: only the "
                    "2-layer EnsembleHeads layout is exportable "
                    "(models/policy/convert.py)"
                )
            v = np.asarray(v)
            if ensemble_mode == "require_tied":
                if not all(np.array_equal(v[0], v[i]) for i in range(1, v.shape[0])):
                    raise ValueError(
                        f"{prefix}/{'/'.join(path)}: ensemble members have "
                        "diverged; the reference head cannot represent them "
                        "exactly — re-export with ensemble_mode='first' or "
                        "'mean' (lossy collapse)"
                    )
                member = v[0]
            elif ensemble_mode == "first":
                member = v[0]
            else:
                member = v.mean(axis=0)
            out_flat[(f"{prefix}_0", layer_map[path[1]]) + path[2:]] = np.asarray(member)

    export_heads("action_outputs")
    export_heads("return_outputs")
    policy = params.pop("policy", None)
    if policy is not None:  # the named tree -> the reference's auto-generated names
        for path, v in _flatten(policy).items():
            new_parts = []
            for i, p in enumerate(path):
                prev_block = new_parts and new_parts[-1].startswith("Block_")
                if p.startswith("blocks_"):
                    new_parts.append("Block_" + p.split("_")[1])
                elif p == "norm1" and prev_block:
                    new_parts.append("LayerNorm_0")
                elif p == "norm2" and prev_block:
                    new_parts.append("LayerNorm_1")
                elif p == "attn" and prev_block:
                    new_parts.append("Attention_0")
                elif p == "mlp" and prev_block:
                    new_parts.append("FeedForward_0")
                elif p == "qkv" and new_parts and new_parts[-1] == "Attention_0":
                    new_parts.append("Dense_0")
                elif p == "attn_out" and new_parts and new_parts[-1] == "Attention_0":
                    new_parts.append("Dense_1")
                elif p == "norm" and i == 0:
                    new_parts.append("LayerNorm_0")  # the Transformer's trailing LayerNorm
                else:
                    new_parts.append(p)
            out_flat[("policy",) + tuple(new_parts)] = np.asarray(v)
    # identically named leaves pass through (action_input, rtg_input, patch_emb, the adapter, ...)
    for path, v in _flatten(params).items():
        out_flat[path] = np.asarray(v)
    return _unflatten(out_flat)
