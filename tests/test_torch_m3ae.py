"""The port's M3AE / MAE encoders against the Flax modules: same numpy-seeded inputs,
same weights through the bridge.  float32, atol 2e-5 (the JAX package's own bound
between its two M3AE paths)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.models import m3ae as jm3ae
from arp_tpu_torch.models import m3ae as tm3ae
from arp_tpu_torch.models.policy.convert import flax_m3ae_to_torch

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models: more intra-op threads only fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


DEPTH, HEADS, EMB = 2, 4, 64
PATCH, IMG = 8, 32
NPATCH = (IMG // PATCH) ** 2
PATCH_DIM = PATCH * PATCH * 3
VOCAB = 97
ATOL = 2e-5
CFG = dict(model_type=None, emb_dim=EMB, depth=DEPTH, num_heads=HEADS, dec_emb_dim=32, dec_depth=1,
           dec_num_heads=2, mlp_ratio=2)


def inputs(seed=1, batch=3, text_len=7):
    rng = np.random.default_rng(seed)
    patch = rng.normal(size=(batch, NPATCH, PATCH_DIM)).astype(np.float32)
    goal = rng.normal(size=(batch, NPATCH, PATCH_DIM)).astype(np.float32)
    ids = rng.integers(0, VOCAB, size=(batch, text_len)).astype(np.int32)
    pad = np.zeros((batch, text_len), np.float32)
    pad[:, 5:] = 1.0  # the last two tokens are padding
    pad[0, :] = 1.0  # and one row is padding throughout: its output must stay finite
    return patch, goal, ids, pad


def make_pair(text: bool = True, use_type: bool = True, seed: int = 0, **cfg_over):
    """A Flax encoder with seeded weights (every leaf moved off its init value) and its port."""
    cfg = dict(CFG, use_type_embedding=use_type, **cfg_over)
    patch, _, ids, pad = inputs()
    if text:
        jmodel = jm3ae.MaskedMultimodalAutoencoder(config_updates=cfg, text_vocab_size=VOCAB)
        variables = jmodel.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(patch), jnp.asarray(ids),
                                jnp.asarray(pad), method=jmodel.forward_representation, deterministic=True)
        tmodel = tm3ae.MaskedMultimodalAutoencoder(cfg, text_vocab_size=VOCAB, image_output_dim=PATCH_DIM)
    else:
        jmodel = jm3ae.MaskedAutoencoder(config_updates=cfg)
        variables = jmodel.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(patch),
                                method=jmodel.forward_representation, deterministic=True)
        tmodel = tm3ae.MaskedAutoencoder(cfg, image_output_dim=PATCH_DIM)
    rng = np.random.default_rng(seed + 100)
    variables = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32)), variables)
    tmodel.load_state_dict(flax_m3ae_to_torch(jax.device_get(variables)))  # strict: every name and shape
    return jmodel, variables, tmodel.eval()


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=atol)


@pytest.mark.parametrize("patch_size", [8, 16])
def test_extract_patches(patch_size):
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    got = tm3ae.extract_patches(torch.from_numpy(x), patch_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm3ae.extract_patches(jnp.asarray(x), patch_size)))


@pytest.mark.parametrize("module", ["MaskedMultimodalAutoencoder", "MaskedAutoencoder"])
@pytest.mark.parametrize("updates", [None, dict(model_type="small"), dict(model_type="debug"),
                                     dict(model_type=None, emb_dim=48, depth=3),
                                     dict(model_type="custom", emb_dim=48)],
                         ids=["default", "small", "debug", "explicit", "unknown_name"])
def test_default_config_and_presets(module, updates):
    want = getattr(jm3ae, module).get_default_config(updates).to_dict()
    got = getattr(tm3ae, module).get_default_config(updates)
    assert dict(got) == want


@pytest.mark.parametrize("use_type", [True, False])
def test_m3ae_image_only(use_type):
    jmodel, variables, tmodel = make_pair(use_type=use_type)
    patch = inputs()[0]
    want = jmodel.apply(variables, jnp.asarray(patch), None, None, method=jmodel.forward_representation,
                        deterministic=True)
    close(tmodel.forward_representation(torch.from_numpy(patch), None, None, deterministic=True), want)


def test_m3ae_with_text_and_padding():
    jmodel, variables, tmodel = make_pair()
    patch, _, ids, pad = inputs()
    want = jmodel.apply(variables, jnp.asarray(patch), jnp.asarray(ids), jnp.asarray(pad),
                        method=jmodel.forward_representation, deterministic=True)
    got = tmodel.forward_representation(torch.from_numpy(patch), torch.from_numpy(ids).long(),
                                        torch.from_numpy(pad), deterministic=True)
    assert got.shape == (3, 1 + NPATCH + 7, EMB) and torch.isfinite(got).all()
    close(got, want)


def test_m3ae_goal_joint():
    jmodel, variables, tmodel = make_pair()
    patch, goal, _, _ = inputs()
    want = jmodel.apply(variables, jnp.asarray(patch), jnp.asarray(goal),
                        method=jmodel.forward_gc_representations, deterministic=True)
    got = tmodel.forward_gc_representations(torch.from_numpy(patch), torch.from_numpy(goal), deterministic=True)
    assert got.shape == (3, 1 + 2 * NPATCH, EMB)
    close(got, want)


def test_m3ae_intermediates():
    jmodel, variables, tmodel = make_pair()
    patch = inputs()[0]
    want, states = jmodel.apply(variables, jnp.asarray(patch), None, None, method=jmodel.forward_representation,
                                deterministic=True, capture_intermediates=True, mutable=["intermediates"])
    got, inter = tmodel.forward_representation(torch.from_numpy(patch), None, None, deterministic=True,
                                               return_intermediates=True)
    close(got, want)
    assert len(inter) == DEPTH
    for i, t in enumerate(inter):
        close(t, states["intermediates"]["encoder"][f"intermediate_layer_{i}"][0])


def test_mae_forward_representation():
    jmodel, variables, tmodel = make_pair(text=False, use_type=False)
    patch = inputs()[0]
    want = jmodel.apply(variables, jnp.asarray(patch), method=jmodel.forward_representation, deterministic=True)
    close(tmodel.forward_representation(torch.from_numpy(patch), deterministic=True), want)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("score", ["float32", "bfloat16"])
def test_m3ae_frozen_bf16_recipe(score):
    """The full-cast recipe (bf16 tower, bf16 layernorm outputs and residual stream)
    against the JAX run of the same recipe, and against float32: the JAX package's
    bound for this recipe is cosine > 0.99 (tests/test_frozen_bf16.py)."""
    over = dict(compute_dtype="bfloat16", ln_dtype="bfloat16", score_dtype=score)
    jmodel, variables, tmodel = make_pair(**over)
    jref, _, tref = make_pair()
    patch = inputs()[0]
    cast = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), variables)
    want = jmodel.apply(cast, jnp.asarray(patch), None, None, method=jmodel.forward_representation,
                        deterministic=True)
    got = tmodel.to(torch.bfloat16).forward_representation(torch.from_numpy(patch), None, None, deterministic=True)
    f32 = tref.forward_representation(torch.from_numpy(patch), None, None, deterministic=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _cos(got.float().detach().numpy(), np.asarray(want.astype(jnp.float32))) > 0.999
    assert _cos(got.float().detach().numpy(), f32.detach().numpy()) > 0.99


def test_load_m3ae_model_vars_reads_the_ports_own_state_dict(tmp_path, monkeypatch):
    """The port's own format stays readable from an explicit ``.pt`` path; by name only the reference's
    pickle is looked up (F6), never a ``.pt`` beside it."""
    _, _, tmodel = make_pair()
    torch.save(tmodel.state_dict(), tmp_path / "tower.pt")
    torch.save(tmodel.state_dict(), tmp_path / "m3ae_base_params.pt")
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(tmp_path))
    by_path = tm3ae.load_m3ae_model_vars(str(tmp_path / "tower.pt"))
    assert set(by_path) == set(tmodel.state_dict())
    torch.testing.assert_close(by_path["cls_token"], tmodel.cls_token.detach(), atol=0, rtol=0)
    with pytest.raises(FileNotFoundError, match="m3ae_base_params.pkl"):
        tm3ae.load_m3ae_model_vars("vit_b16")
    with pytest.raises(FileNotFoundError, match="m3ae checkpoint not found"):
        tm3ae.load_m3ae_model_vars("vit_l16")


def test_load_m3ae_model_vars_reads_the_reference_pickle_by_name(tmp_path, monkeypatch):
    """F6: by name, ``m3ae_base_params.pkl`` in ``$ARP_TPU_CHECKPOINT_DIR`` (the JAX exporter's file),
    renamed and bridged leaf for leaf."""
    _, variables, tmodel = make_pair()
    with open(tmp_path / "m3ae_base_params.pkl", "wb") as f:
        pickle.dump(jm3ae.export_reference_m3ae_params(variables), f)
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(tmp_path))
    state = tm3ae.load_m3ae_model_vars("vit_b16")
    want = flax_m3ae_to_torch(jax.device_get(variables))
    assert set(state) == set(want) == set(tmodel.state_dict())
    for name, value in want.items():
        torch.testing.assert_close(state[name], value, atol=0, rtol=0)
