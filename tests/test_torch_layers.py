"""Shared layers of the port against the Flax layers: same numpy-seeded inputs, same
weights carried across by the bridge.  float32, atol 1e-5 (both sum in float32 in
other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu import utils as jutils
from arp_tpu.models import layers as jl
from arp_tpu.ops.masks import MaskSpec as JMaskSpec
from arp_tpu_torch import utils as tutils
from arp_tpu_torch.config import Config, update_config
from arp_tpu_torch.models import layers as tl
from arp_tpu_torch.models.policy.convert import flax_params_to_torch
from arp_tpu_torch.ops.masks import MaskSpec

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models: more intra-op threads only fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5
DIM, HEADS, N, B = 32, 4, 12, 3
MASKS = {"none": ("none", 0, 0), "causal": ("causal", 0, 0), "dt": ("dt", 2, 4)}


def _x(seed=0, shape=(B, N, DIM)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _randomize(params, seed):
    """Flax init leaves biases at zero and LN scales at one: give every leaf seeded values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(np.float32)), params)


def _load(module, params):
    module.load_state_dict(flax_params_to_torch(jax.device_get(params)))
    return module.eval()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("dim,length", [(32, 7), (64, 16), (768, 4)])
def test_1d_sincos_pos_embed(dim, length):
    _close(tutils.get_1d_sincos_pos_embed(dim, length), jutils.get_1d_sincos_pos_embed(dim, length), 1e-6)


@pytest.mark.parametrize("dim,length", [(32, 4), (64, 16), (768, 256)])
def test_2d_sincos_pos_embed(dim, length):
    got = tutils.get_2d_sincos_pos_embed(dim, length)
    assert got.shape == (1, length, dim) and got.dtype == torch.float32
    # sin and cos of arguments up to 15 in float32: a few ulps of 1
    _close(got, jutils.get_2d_sincos_pos_embed(dim, length), 2e-6)


def test_pos_embed_is_cached_per_device():
    assert tutils.get_1d_sincos_pos_embed(32, 5) is tutils.get_1d_sincos_pos_embed(32, 5, "cpu")


@pytest.mark.parametrize("fn", ["symlog", "symexp"])
def test_symlog_symexp(fn):
    x = np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32) * 3
    got, want = getattr(tutils, fn)(torch.from_numpy(x)), getattr(jutils, fn)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)  # symexp reaches 1e3


@pytest.mark.parametrize("n", [1, 2, 8, 12, 20])
def test_attention_slopes(n):
    assert tl.get_attention_slopes(n) == jl.get_attention_slopes(n)


def test_resolve_compute_dtype():
    assert tl.resolve_compute_dtype("float32") is None
    assert tl.resolve_compute_dtype("bfloat16") is torch.bfloat16


def test_config_is_a_plain_tree():
    cfg = Config(a=1, sub=dict(b=2, c=3))
    update_config(cfg, dict(sub=dict(b=5), d=7))
    assert cfg.sub.b == 5 and cfg.sub.c == 3 and cfg.d == 7 and cfg["a"] == 1
    assert isinstance(cfg.sub, Config) and cfg.get("missing", 9) == 9
    copy = cfg.copy()
    copy.sub.b = 6
    assert cfg.sub.b == 5
    with pytest.raises(AttributeError):
        cfg.missing


@pytest.mark.parametrize("activation", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("use_bias", [False, True])
def test_feed_forward(activation, use_bias):
    x = _x(1)
    jm = jl.FeedForward(dim=64, out_dim=DIM, use_bias=use_bias, activation=activation)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    tm = _load(tl.FeedForward(DIM, 64, DIM, use_bias=use_bias, activation=activation), params)
    _close(tm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("use_bias", [False, True])
def test_dense_qkv_keeps_the_fused_kernel(use_bias):
    x = _x(2)
    jm = jl.DenseQKV(DIM, use_bias=use_bias)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    tm = tl.DenseQKV(DIM, DIM, use_bias=use_bias)
    state = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    assert state["kernel"].shape == (DIM, 3 * DIM)  # one fused parameter, Flax layout
    tm.load_state_dict(state)
    for got, want in zip(tm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x))):
        _close(got, want)


@pytest.mark.parametrize("padding", [False, True])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("mask", list(MASKS))
def test_attention(mask, alibi, padding):
    x = _x(3)
    pad = None
    if padding:
        pad = np.zeros((B, N), np.float32)
        pad[0, 9:] = 1
        pad[2, 5:] = 1
    jm = jl.Attention(DIM, HEADS, use_bias=True, alibi_bias=alibi)
    jspec, tspec = JMaskSpec(*MASKS[mask]), MaskSpec(*MASKS[mask])
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), True, jspec)["params"], 4)
    tm = _load(tl.Attention(DIM, HEADS, use_bias=True, alibi_bias=alibi), params)
    want = jm.apply({"params": params}, jnp.asarray(x), True, jspec, None if pad is None else jnp.asarray(pad))
    got = tm(torch.from_numpy(x), True, tspec, None if pad is None else torch.from_numpy(pad))
    _close(got, want)


def test_attention_probability_dropout_takes_the_plain_path():
    """att_drop > 0 while training: finite, and differs from the deterministic output."""
    tm = tl.Attention(DIM, HEADS, use_bias=True, att_drop=0.5)
    x = torch.from_numpy(_x(4))
    torch.manual_seed(0)
    dropped = tm(x, deterministic=False, mask_spec=MaskSpec("causal"))
    plain = tm(x, deterministic=True, mask_spec=MaskSpec("causal"))
    assert torch.isfinite(dropped).all() and not torch.allclose(dropped, plain)


def test_drop_path():
    x = torch.ones(64, 3, 5)
    dp = tl.DropPath(0.5)
    assert dp(x, deterministic=True) is x and tl.DropPath(0.0)(x, deterministic=False) is x
    out = dp(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    rows = out.flatten(1)
    assert set(rows.unique().tolist()) == {0.0, 2.0}  # a row is dropped whole or scaled by 1 / keep
    assert (rows.min(1).values == rows.max(1).values).all()


@pytest.mark.parametrize("mask", list(MASKS))
def test_block(mask):
    x = _x(5)
    jspec, tspec = JMaskSpec(*MASKS[mask]), MaskSpec(*MASKS[mask])
    jm = jl.Block(DIM, HEADS, mlp_ratio=2, mlp_bias=True)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), True, jspec)["params"], 6)
    tm = _load(tl.Block(DIM, HEADS, mlp_ratio=2, mlp_bias=True), params)
    _close(tm(torch.from_numpy(x), True, tspec), jm.apply({"params": params}, jnp.asarray(x), True, jspec))


def _transformer_pair(seed, **kw):
    x = _x(seed)
    jm = jl.Transformer(emb_dim=DIM, depth=2, num_heads=HEADS, mlp_ratio=2, sow_intermediates=True, **{
        k: (jnp.dtype(v) if k.endswith("dtype") and v is not None else v) for k, v in kw.items()})
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), True, JMaskSpec("none"))["params"], seed + 1)
    tkw = {k: (getattr(torch, v) if k.endswith("dtype") and v is not None else v) for k, v in kw.items()}
    tm = _load(tl.Transformer(emb_dim=DIM, depth=2, num_heads=HEADS, mlp_ratio=2, **tkw), params)
    return x, jm, params, tm


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("mask", list(MASKS))
def test_transformer_and_intermediates(mask, alibi):
    x, jm, params, tm = _transformer_pair(7, alibi_bias=alibi, mlp_bias=True)
    jspec, tspec = JMaskSpec(*MASKS[mask]), MaskSpec(*MASKS[mask])
    want, state = jm.apply({"params": params}, jnp.asarray(x), True, jspec, mutable=["intermediates"])
    got, inter = tm(torch.from_numpy(x), True, tspec, return_intermediates=True)
    _close(got, want)
    assert len(inter) == 2
    for i, t in enumerate(inter):
        _close(t, state["intermediates"][f"intermediate_layer_{i}"][0])
    _close(tm(torch.from_numpy(x), True, tspec), want)  # without the list: the output alone


def _cos(a, b):
    a, b = np.asarray(a, np.float32).reshape(-1), np.asarray(b, np.float32).reshape(-1)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


@pytest.mark.parametrize("kw", [
    dict(compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16", ln_dtype="bfloat16"),
    dict(compute_dtype="bfloat16", ln_dtype="bfloat16", score_dtype="bfloat16"),
], ids=["compute_bf16", "ln_bf16", "score_bf16"])
def test_transformer_bf16_recipes(kw):
    """bf16 recipes by cosine against the JAX run of the same recipe (XLA's CPU backend
    keeps excess precision between bf16 ops, torch rounds each): > 0.999; and the
    output dtype is the recipe's."""
    x, jm, params, tm = _transformer_pair(9, mlp_bias=True, **kw)
    want = jm.apply({"params": params}, jnp.asarray(x), True, JMaskSpec("none"))
    got = tm(torch.from_numpy(x), True, MaskSpec("none"))
    assert got.dtype == (torch.bfloat16 if "ln_dtype" in kw else torch.float32)
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    assert _cos(got.float().detach().numpy(), np.asarray(want.astype(jnp.float32))) > 0.999


def test_transformer_remat_gives_the_same_output_and_gradients():
    x, _, params, tm = _transformer_pair(11, mlp_bias=True)
    tr = _load(tl.Transformer(emb_dim=DIM, depth=2, num_heads=HEADS, mlp_ratio=2, mlp_bias=True, remat=True), params)
    a = torch.from_numpy(x).requires_grad_()
    b = torch.from_numpy(x).requires_grad_()
    ya, yb = tm(a, True, MaskSpec("causal")), tr(b, True, MaskSpec("causal"))
    torch.testing.assert_close(ya, yb, atol=0, rtol=0)
    ya.sum().backward()
    yb.sum().backward()
    torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=0)


def test_adapter_mlp():
    x = _x(12, (5, DIM))
    jm = jl.AdapterMLP(hidden_dim=DIM, output_dim=DIM, num_layers=2)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 13)
    tm = _load(tl.AdapterMLP(DIM, DIM, DIM, 2), params)
    _close(tm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)))
