"""Shared transformer layers (port of arp_tpu/models/layers.py).

One implementation serves every policy model (ARPDT / BC / GCBC) and the M3AE
encoder.  The module tree mirrors the Flax one, so a parameter's name is its
Flax path joined with dots (``blocks_0.attn.qkv.kernel``); see
models/policy/convert.py for how the leaves map.  As in the Flax layers:

  * attention runs through :func:`arp_tpu_torch.ops.attention.dot_product_attention`
    with a lazy mask spec: kernel K1 on CUDA, the plain version on the CPU.
    An ALiBi bias or dropout on the probabilities takes the plain attention
    explicitly on every device, as the JAX package takes its XLA path for them;
  * q, k and v come from ONE fused ``(in, 3 * dim)`` ``qkv/kernel`` parameter;
  * LayerNorm eps is 1e-6 (Flax's default), its statistics are float32 and its
    output is rounded to ``ln_dtype``; GELU is the tanh approximation;
  * ``compute_dtype`` runs a block's matmuls in that dtype with float32
    layernorms and residual stream; ``ln_dtype`` (frozen towers only) keeps the
    layernorm outputs and the residual stream in that dtype too;
  * every random draw (dropout masks, stochastic depth) comes from the
    ``generator`` the caller passes down (Flax: the "dropout" and "drop_path"
    rngs); without one, torch's global generator.

:class:`MLP` is the M3AE decoders' output head.

Several devices: an ``Attention`` or ``FeedForward`` whose ``tp`` is set holds
its tp share of the heads or hidden units (parallel/tensor_parallel.py);
:class:`PipelinedTransformer` runs its stage of the block stack over the
mesh's pp axis (parallel/pipeline.py), and :func:`stack_transformer_params` /
:func:`unstack_transformer_params` move Flax trees between the flat layout and
JAX's ``stacked_blocks``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, reference_attention
from ..ops.masks import MaskSpec, combine_padding, materialize_mask
from ..parallel.tensor_parallel import copy_to_tp, row_parallel

LN_EPS = 1e-6  # flax nn.LayerNorm default


def get_attention_slopes(n: int):
    """ALiBi-style head slopes."""

    def power_of_2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * start ** i for i in range(n)]

    if math.log2(n).is_integer():
        return power_of_2(n)
    closest = 2 ** math.floor(math.log2(n))
    return power_of_2(closest) + get_attention_slopes(2 * closest)[0::2][: n - closest]


def resolve_compute_dtype(name) -> Optional[torch.dtype]:
    """Config string -> ``compute_dtype``: "float32" means default precision (None)."""
    return None if name == "float32" else getattr(torch, name)


def dense(x: torch.Tensor, linear: nn.Linear, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Flax ``Dense(dtype=dtype)``: input and parameters promoted to ``dtype``, or to their common type."""
    dt = dtype or torch.promote_types(x.dtype, linear.weight.dtype)
    bias = None if linear.bias is None else linear.bias.to(dt)
    return F.linear(x.to(dt), linear.weight.to(dt), bias)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None, tp=None,
            dim: int = -1) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each entry with probability 1 - rate, scaled by 1 / (1 - rate).

    ``tp`` (a module's tp share, parallel/mesh.py::Split): ``x`` is share ``tp.rank`` of ``tp.size``
    contiguous ones along ``dim`` of the unsplit model's tensor.  The mask is drawn at the full width, as
    the unsplit model draws it, and this rank keeps its share: every tp rank drops what one process drops,
    and the generator's later draws stay one process's."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    shape = list(x.shape)
    if tp is not None:
        shape[dim] *= tp.size
    keep = torch.rand(shape, device=x.device, generator=generator) < keep_prob
    if tp is not None:
        keep = keep.narrow(dim, tp.rank * x.shape[dim], x.shape[dim])
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=dtype)``: float32 statistics and affine, output in ``dtype``
    (None: the common type of input and parameters)."""
    dt = dtype or torch.promote_types(x.dtype, norm.weight.dtype)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps).to(dt)


class FeedForward(nn.Module):
    """Pre-activation MLP: fc1 -> act -> drop -> fc2 -> drop."""

    def __init__(self, in_dim: int, dim: int = 256, out_dim: int = 256, dropout: float = 0.0,
                 use_bias: bool = False, activation: str = "gelu", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if activation not in ("gelu", "quick_gelu"):
            raise ValueError(activation)
        self.activation, self.dropout, self.dtype = activation, dropout, dtype
        self.tp = None  # its Split once split over tp: fc1 column- and fc2 row-parallel
        self.fc1 = nn.Linear(in_dim, dim, bias=use_bias)
        self.fc2 = nn.Linear(dim, out_dim, bias=use_bias)
        for fc in (self.fc1, self.fc2):
            nn.init.xavier_uniform_(fc.weight)
            if use_bias:
                nn.init.zeros_(fc.bias)

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        drop = 0.0 if deterministic else self.dropout
        x = dense(copy_to_tp(x, self.tp), self.fc1, self.dtype)
        x = F.gelu(x, approximate="tanh") if self.activation == "gelu" else x * torch.sigmoid(1.702 * x)
        x = dropout(x, drop, generator, self.tp)
        x = dense(x, self.fc2, self.dtype) if self.tp is None else row_parallel(x, self.fc2, self.dtype, self.tp)
        return dropout(x, drop, generator)


class DenseQKV(nn.Module):
    """q/k/v projection with one fused parameter, ``kernel`` (in_dim, 3 * dim) in the
    Flax layout (+ optional ``bias`` (3 * dim,)); returns the three projections."""

    def __init__(self, in_dim: int, dim: int, use_bias: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.kernel = nn.Parameter(torch.empty(in_dim, 3 * dim))
        nn.init.normal_(self.kernel, std=in_dim ** -0.5)  # lecun_normal's scale
        self.bias = nn.Parameter(torch.zeros(3 * dim)) if use_bias else None

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y.chunk(3, dim=-1)


class Attention(nn.Module):
    """Multi-head self-attention with a lazy mask spec."""

    def __init__(self, dim: int, num_heads: int = 8, use_bias: bool = False, att_drop: float = 0.0,
                 proj_drop: float = 0.0, alibi_bias: bool = False, dtype: Optional[torch.dtype] = None,
                 score_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.att_drop, self.proj_drop, self.alibi_bias = att_drop, proj_drop, alibi_bias
        self.dtype, self.score_dtype = dtype, score_dtype
        self.tp = None  # its Split once split over tp: this rank's heads in qkv, attn_out row-parallel
        self.qkv = DenseQKV(dim, dim, use_bias=use_bias, dtype=dtype)
        self.attn_out = nn.Linear(dim, dim, bias=use_bias)
        nn.init.normal_(self.attn_out.weight, std=dim ** -0.5)
        if use_bias:
            nn.init.zeros_(self.attn_out.bias)

    def forward(self, x, deterministic: bool = True, mask_spec: MaskSpec = MaskSpec("causal"), kv_padding=None,
                generator: Optional[torch.Generator] = None):
        b, n, _ = x.shape
        head_dim = self.dim // self.num_heads
        heads, first = self.num_heads, 0
        if self.tp is not None:  # this rank's heads
            heads = self.num_heads // self.tp.size
            first = self.tp.rank * heads
        q, k, v = (t.view(b, n, heads, head_dim) for t in self.qkv(copy_to_tp(x, self.tp)))
        score_dtype = self.score_dtype or torch.float32

        bias = None
        if self.alibi_bias:
            # slope_h * k_index, independent of q, added to the already-scaled scores
            slopes = torch.tensor(get_attention_slopes(self.num_heads)[first:first + heads], dtype=torch.float32,
                                  device=x.device)
            bias = (slopes[:, None, None] * torch.arange(n, dtype=torch.float32, device=x.device)[None, None, :])[None]
            bias = bias.expand(1, heads, n, n)

        if self.att_drop > 0 and not deterministic:
            # dropout on the attention probabilities: the plain attention, spelled out
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * head_dim ** -0.5
            if bias is not None:
                s = s + bias
            mask = combine_padding(materialize_mask(mask_spec, n, device=x.device)[None, None], kv_padding)
            s = torch.where(mask, s, torch.tensor(torch.finfo(s.dtype).min, dtype=s.dtype, device=s.device))
            p = dropout(torch.softmax(s, dim=-1), self.att_drop, generator, self.tp, dim=1)
            out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
        elif bias is not None:
            # kernel K1 takes no dense bias, as the Pallas kernel takes none
            out = reference_attention(q, k, v, mask_spec, kv_padding, bias=bias, score_dtype=score_dtype)
        else:
            out = dot_product_attention(q, k, v, spec=mask_spec, kv_padding=kv_padding, score_dtype=score_dtype)
        out = out.reshape(b, n, heads * head_dim)
        if self.tp is None:
            out = dense(out, self.attn_out, self.dtype)
        else:
            out = row_parallel(out, self.attn_out, self.dtype, self.tp)
        return dropout(out, 0.0 if deterministic else self.proj_drop, generator)


class DropPath(nn.Module):
    """Stochastic depth: drops a sample's whole branch with probability ``dropout_prob``."""

    def __init__(self, dropout_prob: float = 0.0):
        super().__init__()
        self.dropout_prob = dropout_prob

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        if deterministic or self.dropout_prob == 0.0:
            return x
        keep_prob = 1 - self.dropout_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        noise = torch.rand(shape, dtype=torch.float32, device=x.device, generator=generator)
        return (x / keep_prob) * torch.floor(keep_prob + noise).to(x.dtype)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, dim: int = 256, num_heads: int = 8, mlp_ratio: int = 4, att_drop: float = 0.0,
                 drop: float = 0.0, drop_path: float = 0.0, alibi_bias: bool = False,
                 use_attn_bias: bool = True, mlp_bias: bool = False, activation: str = "gelu",
                 compute_dtype: Optional[torch.dtype] = None, ln_dtype: Optional[torch.dtype] = None,
                 score_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype, self.ln_dtype = compute_dtype, ln_dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, use_bias=use_attn_bias, att_drop=att_drop, proj_drop=drop,
                              alibi_bias=alibi_bias, dtype=compute_dtype, score_dtype=score_dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = FeedForward(dim, dim * mlp_ratio, dim, drop, use_bias=mlp_bias, activation=activation,
                               dtype=compute_dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, deterministic: bool = True, mask_spec: MaskSpec = MaskSpec("causal"), kv_padding=None,
                generator: Optional[torch.Generator] = None):
        y = layer_norm(x, self.norm1, self.ln_dtype or torch.float32)
        if self.compute_dtype is not None:
            y = y.to(self.compute_dtype)
        y = self.drop_path(self.attn(y, deterministic, mask_spec, kv_padding, generator), deterministic, generator)
        x = x + y.to(x.dtype)

        y = layer_norm(x, self.norm2, self.ln_dtype or torch.float32)
        if self.compute_dtype is not None:
            y = y.to(self.compute_dtype)
        y = self.drop_path(self.mlp(y, deterministic, generator), deterministic, generator)
        return x + y.to(x.dtype)


def _replaying(block: nn.Module, generator: Optional[torch.Generator]):
    """``block`` for ``torch.utils.checkpoint``: its recomputation on the backward pass draws
    the masks the forward drew from ``generator`` and leaves the generator as it found it
    (the checkpoint replays torch's global generators itself)."""
    if generator is None:
        return block
    start, calls = generator.get_state(), []

    def run(*args):
        if not calls:
            calls.append(True)
            return block(*args)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return block(*args)
        finally:
            generator.set_state(now)

    return run


class Transformer(nn.Module):
    """Stack of pre-LN blocks (``blocks_0`` ...) with a final LayerNorm (``norm``).

    ``return_intermediates=True`` also returns the list of every block's
    output (what the Flax stack sows as ``intermediate_layer_{i}``).
    ``remat`` recomputes each block on the backward pass
    (``torch.utils.checkpoint``).
    """

    def __init__(self, emb_dim: int = 1024, depth: int = 24, att_drop: float = 0.0, drop: float = 0.0,
                 drop_path: float = 0.0, num_heads: int = 16, mlp_ratio: int = 4, alibi_bias: bool = False,
                 mlp_bias: bool = False, activation: str = "gelu", remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, ln_dtype: Optional[torch.dtype] = None,
                 score_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depth, self.remat, self.ln_dtype = depth, remat, ln_dtype
        for i in range(depth):
            self.add_module(f"blocks_{i}", Block(
                emb_dim, num_heads, mlp_ratio, att_drop, drop, drop_path, alibi_bias, mlp_bias=mlp_bias,
                activation=activation, compute_dtype=compute_dtype, ln_dtype=ln_dtype, score_dtype=score_dtype))
        self.norm = nn.LayerNorm(emb_dim, eps=LN_EPS)

    def forward(self, x, deterministic: bool = True, mask_spec: MaskSpec = MaskSpec("causal"), kv_padding=None,
                return_intermediates: bool = False, generator: Optional[torch.Generator] = None):
        if self.ln_dtype is not None:
            x = x.to(self.ln_dtype)
        intermediates = []
        for i in range(self.depth):
            block = getattr(self, f"blocks_{i}")
            if self.remat and torch.is_grad_enabled() and x.requires_grad:
                from torch.utils.checkpoint import checkpoint

                x = checkpoint(_replaying(block, generator), x, deterministic, mask_spec, kv_padding, generator,
                               use_reentrant=False)
            else:
                x = block(x, deterministic, mask_spec, kv_padding, generator)
            if return_intermediates:
                intermediates.append(x)
        out = layer_norm(x, self.norm, self.ln_dtype)
        return (out, intermediates) if return_intermediates else out


class PipelinedTransformer(nn.Module):
    """:class:`Transformer`'s stack pipelined over the mesh's ``pp`` axis (JAX's ``PipelinedTransformer``).

    The same math as :class:`Transformer`: stage s of ``stages`` holds blocks ``s * depth / stages`` ..
    under their flat names (``blocks_i``), so the state of every stage together is the flat stack's;
    microbatches (``gcd(batch, microbatches)`` of them) cross the stages by
    parallel/pipeline.py::pipeline_apply, and every pp rank applies ``norm`` to the outputs.  Every
    block is built, in the flat stack's order, before the other stages' are dropped: a seed gives the
    flat stack's initial weights, and the parameters built after it are alike on every stage.  JAX's
    Flax tree holds the blocks stacked (``stacked_blocks``, leading axes (stages, depth / stages)):
    :func:`stack_transformer_params` and :func:`unstack_transformer_params` move between the two.

    Dropout and drop-path must be 0, as JAX refuses them (no random stream crosses the pipelined
    region); ``remat`` runs each stage again on the backward pass.
    """

    def __init__(self, emb_dim: int = 1024, depth: int = 24, num_heads: int = 16, mlp_ratio: int = 4,
                 alibi_bias: bool = False, mlp_bias: bool = False, activation: str = "gelu", stages: int = 2,
                 microbatches: int = 2, mesh=None, remat: bool = False, compute_dtype: Optional[torch.dtype] = None,
                 att_drop: float = 0.0, drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        if att_drop or drop or drop_path:
            raise ValueError("a pipelined transformer needs dropout and drop_path disabled (no random stream "
                             "crosses the pipelined region, as in JAX)")
        if mesh is None:
            raise ValueError("PipelinedTransformer needs the device mesh (its pp axis)")
        pp = mesh["pp"]
        if pp.size() != stages or depth % stages:
            raise ValueError(f"depth {depth} in {stages} stages over a pp axis of {pp.size()}")
        from ..parallel.mesh import Split

        self.mesh, self.stages, self.microbatches, self.remat = mesh, stages, microbatches, remat
        per = depth // stages
        self.stage = pp.get_local_rank()
        self.own = list(range(self.stage * per, (self.stage + 1) * per))
        split = Split("pp", pp.get_group(), stages, self.stage)
        for i in range(depth):
            block = Block(emb_dim, num_heads, mlp_ratio, alibi_bias=alibi_bias, mlp_bias=mlp_bias,
                          activation=activation, compute_dtype=compute_dtype)
            if i in self.own:
                for p in block.parameters():
                    p.mesh_split = split
                self.add_module(f"blocks_{i}", block)
        self.norm = nn.LayerNorm(emb_dim, eps=LN_EPS)

    def forward(self, x, deterministic: bool = True, mask_spec: MaskSpec = MaskSpec("causal"), kv_padding=None,
                return_intermediates: bool = False, generator: Optional[torch.Generator] = None):
        from ..parallel.pipeline import pipeline_apply

        del deterministic, generator  # no dropout here
        if kv_padding is not None or return_intermediates:
            raise ValueError("the pipelined stack takes no key padding and returns no intermediates")
        blocks = [getattr(self, f"blocks_{i}") for i in self.own]

        def stage_fn(act):
            for block in blocks:
                act = block(act, True, mask_spec)
            return act

        params = [p for block in blocks for p in block.parameters() if p.requires_grad]
        # the batch splits into microbatches; a small batch (the first forward's) into fewer
        x = pipeline_apply(stage_fn, params, x, self.mesh, math.gcd(x.shape[0], self.microbatches), remat=self.remat)
        return layer_norm(x, self.norm, None)


def stack_transformer_params(params: dict, stages: int) -> dict:
    """A flat :class:`Transformer` Flax tree (``blocks_i/...``, ``norm``; numpy) -> JAX's
    ``PipelinedTransformer`` layout (``stacked_blocks`` with leading axes (stages, depth / stages), ``norm``)."""
    import numpy as np

    depth = len([k for k in params if k.startswith("blocks_")])
    if depth % stages:
        raise ValueError(f"depth {depth} does not split into {stages} stages")

    def stack(*leaves):
        if isinstance(leaves[0], Mapping):
            return {k: stack(*(leaf[k] for leaf in leaves)) for k in leaves[0]}
        arr = np.stack([np.asarray(leaf) for leaf in leaves])
        return arr.reshape((stages, depth // stages) + arr.shape[1:])

    return {"stacked_blocks": stack(*(params[f"blocks_{i}"] for i in range(depth))), "norm": params["norm"]}


def unstack_transformer_params(params: dict) -> dict:
    """Inverse of :func:`stack_transformer_params`."""
    import numpy as np

    def first_leaf(tree):
        return first_leaf(next(iter(tree.values()))) if isinstance(tree, Mapping) else np.asarray(tree)

    stacked = params["stacked_blocks"]
    s, per = first_leaf(stacked).shape[:2]

    def pick(tree, i):
        if isinstance(tree, Mapping):
            return {k: pick(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i // per, i % per]

    out = {f"blocks_{i}": pick(stacked, i) for i in range(s * per)}
    out["norm"] = params["norm"]
    return out


class AdapterMLP(nn.Module):
    """Parameter-efficient adapter MLP: ``Dense_0`` ... with a relu after each, the last too."""

    def __init__(self, in_dim: int, hidden_dim: int = 1024, output_dim: int = 1024, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for k in range(num_layers):
            layer = nn.Linear(dims[k], dims[k + 1])
            nn.init.xavier_uniform_(layer.weight)
            nn.init.zeros_(layer.bias)
            self.add_module(f"Dense_{k}", layer)

    def forward(self, x):
        for k in range(self.num_layers):
            x = F.relu(dense(x, getattr(self, f"Dense_{k}")))
        return x


class MLP(nn.Module):
    """Residual MLP head of the M3AE decoders: an optional input LayerNorm, then ``depth`` times
    Dense -> tanh-GELU -> LayerNorm (the residual added from the second on), then the output Dense.

    The submodules carry Flax's auto names: ``LayerNorm_0`` is the input norm when there is one,
    the k-th hidden layer's Dense and LayerNorm are ``Dense_k`` and ``LayerNorm_{k + input_norm}``,
    and the output Dense is ``Dense_{depth}``.  LayerNorm eps 1e-6, Dense kernels xavier-uniform.
    """

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, depth: int, input_norm: bool = True):
        super().__init__()
        self.depth, self.input_norm = depth, input_norm
        if input_norm:
            self.LayerNorm_0 = nn.LayerNorm(in_dim, eps=LN_EPS)
        dims = [in_dim] + [hidden_dim] * depth
        for k in range(depth + 1):
            layer = nn.Linear(dims[k], hidden_dim if k < depth else output_dim)
            nn.init.xavier_uniform_(layer.weight)
            nn.init.zeros_(layer.bias)
            self.add_module(f"Dense_{k}", layer)
            if k < depth:
                self.add_module(f"LayerNorm_{k + int(input_norm)}", nn.LayerNorm(hidden_dim, eps=LN_EPS))

    def forward(self, x):
        if self.input_norm:
            x = layer_norm(x, self.LayerNorm_0, None)
        for k in range(self.depth):
            y = F.gelu(dense(x, getattr(self, f"Dense_{k}")), approximate="tanh")
            y = layer_norm(y, getattr(self, f"LayerNorm_{k + int(self.input_norm)}"), None)
            x = x + y if k > 0 else y
        return dense(x, getattr(self, f"Dense_{self.depth}"))
