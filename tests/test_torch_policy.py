"""The port's policies (ARPDT / BC / GCBC) against the Flax policies: the same numpy-seeded
batch, the same weights through the bridge, every transfer type.

float32: every output key within atol 1e-5.  frozen_bf16 and frozen_int8: the JAX tests'
cosine bounds on action_pred (0.98 bf16 against float32, 0.95 int8 against bf16).  The
configuration's resolution rules: case by case against get_policy_default_config."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.models import m3ae as jm3ae
from arp_tpu.models.clip import CLIP as JCLIP
from arp_tpu.models.clip import model as jclip_mod
from arp_tpu.models.policy import models as jpol
from arp_tpu_torch.models.clip import CLIP as TCLIP
from arp_tpu_torch.models.clip import flax_to_torch
from arp_tpu_torch.models.clip import model as tclip_mod
from arp_tpu_torch.models.policy import convert
from arp_tpu_torch.models.policy import models as tpol

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models: more intra-op threads only fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


WINDOW, IMG, PATCH, BATCH = 2, 32, 16, 2
NPATCH = (IMG // PATCH) ** 2
ATOL = 1e-5
TINY = dict(model_type=None, emb_dim=32, dec_emb_dim=16, depth=2, dec_depth=1, num_heads=4, dec_num_heads=4,
            mlp_ratio=2)
TINY_CLIP = dict(embed_dim=16, vocab_size=97, vision_num_layers=1, vision_features=64, vision_patch_size=16,
                 text_features=16, text_num_heads=4, text_num_layers=1)


def base_config(**over):
    cfg = dict(model_type="vit_debug", transfer_type="none", emb_dim=32, depth=2, num_heads=4, mlp_ratio=2,
               use_discrete_action=True, num_ensembles=3)
    cfg.update(over)
    return cfg


def make_batch(seed, views=("ob",), with_goal=False, with_text=False, with_state=False, continuous=False,
               with_rtg=True, emb_dim=None, img=IMG, text_len=16):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    batch = {"instruct": None, "text_padding_mask": None}
    if emb_dim is None:
        batch["image"] = {v: f32(BATCH, WINDOW, img, img, 3) for v in views}
    else:
        batch["image_emb"] = {v: f32(BATCH, WINDOW, emb_dim) for v in views}
        if with_goal:
            batch["goal_emb"] = {v: f32(BATCH, WINDOW, emb_dim) for v in views}
    batch["action"] = f32(BATCH, WINDOW, 7) if continuous else rng.integers(0, 15, size=(BATCH, WINDOW)).astype(np.int32)
    if with_rtg:
        batch["rtg"] = {v: f32(BATCH, WINDOW, 1) * 3 for v in views}
    if with_goal and emb_dim is None:
        batch["goal"] = {v: f32(BATCH, WINDOW, img, img, 3) for v in views}
    if with_state:
        batch["state"] = f32(BATCH, WINDOW, 5)
    if with_text:
        batch["instruct"] = rng.integers(1, 97, size=(BATCH, text_len)).astype(np.int32)
        batch["instruct"][:, 11:] = 0  # CLIP's pad id
        pad = np.zeros((BATCH, text_len), np.float32)
        pad[:, 11:] = 1.0
        batch["text_padding_mask"] = pad
    return batch


def _jax_batch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _randomize(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.normal(size=p.shape).astype(np.float32)), tree)


def fake_m3ae_vars(text=True, seed=11):
    """Seeded tiny M3AE (or MAE) variables in the Flax layout: the frozen tower's weights."""
    probe = jnp.zeros((1, NPATCH, PATCH * PATCH * 3), jnp.float32)
    if text:
        model = jm3ae.MaskedMultimodalAutoencoder(config_updates=dict(TINY), text_vocab_size=jpol.BERT_VOCAB_SIZE)
        variables = model.init({"params": jax.random.PRNGKey(seed)}, probe, jnp.zeros((1, 16), jnp.int32),
                               jnp.zeros((1, 16), jnp.float32), method=model.forward_representation,
                               deterministic=True)
    else:
        model = jm3ae.MaskedAutoencoder(config_updates=dict(TINY, use_type_embedding=False))
        variables = model.init({"params": jax.random.PRNGKey(seed)}, probe, method=model.forward_representation,
                               deterministic=True)
    return _randomize(variables, seed + 1)


def fake_clip_vars(image_size, seed=5):
    model = JCLIP(**TINY_CLIP)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, image_size, image_size, 3), jnp.float32),
                           jnp.zeros((1, 77), jnp.int32))
    return _randomize(variables, seed + 1, 0.02)


@pytest.fixture
def towers(monkeypatch):
    """Tiny frozen towers behind both packages' loaders and CLIP tables; returns the port's
    ``pt_variables`` for a transfer type."""
    m3ae_vars, mae_vars = fake_m3ae_vars(True), fake_m3ae_vars(False)
    clip_vars = {32: fake_clip_vars(32), 224: fake_clip_vars(224)}
    size = {"value": 32}

    def load_m3ae(name, checkpoint_dir=None):
        return mae_vars if name == "mae" else m3ae_vars

    monkeypatch.setattr(jm3ae, "load_m3ae_model_vars", lambda name, checkpoint_dir=None: load_m3ae(size.get("kind")))
    monkeypatch.setitem(jclip_mod.MODELS, "tiny_test", lambda **kw: JCLIP(**{**TINY_CLIP, **kw}))
    monkeypatch.setattr(jclip_mod, "load_model_vars", lambda name, **kw: clip_vars[size["value"]])
    monkeypatch.setitem(tclip_mod.MODELS, "tiny_test",
                        lambda **kw: TCLIP(**{**TINY_CLIP, "image_size": size["value"], **kw}))

    def pt_variables(transfer_type, clip_size=32):
        size["value"] = clip_size
        if transfer_type.startswith("clip"):
            return flax_to_torch(jax.device_get(clip_vars[clip_size]))
        size["kind"] = "mae" if transfer_type.startswith("mae") else "m3ae"
        return convert.flax_m3ae_to_torch(jax.device_get(load_m3ae(size["kind"])))

    pt_variables.m3ae_vars = m3ae_vars
    return pt_variables


def run_pair(cls, cfg, batch, num_actions=15, pt=None, qpacks=(None, None), load_all=True):
    """The Flax policy with seeded weights and its port on one batch: (outputs, outputs, models)."""
    jmodel = getattr(jpol, cls)(config_updates=cfg, num_actions=num_actions, patch_dim=PATCH, frozen_qpack=qpacks[0])
    jbatch = _jax_batch(batch)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    params = _randomize(jmodel.init(rngs, jbatch, deterministic=True)["params"], 21)
    jout = jmodel.apply({"params": params}, jbatch, deterministic=True)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tmodel = getattr(tpol, cls)(cfg, num_actions=num_actions, patch_dim=PATCH, pt_variables=pt,
                                    frozen_qpack=qpacks[1]).eval()
    with torch.no_grad():
        tmodel(batch, deterministic=True)  # the lazy layers take their shapes
        state = convert.flax_policy_to_torch(jax.device_get(params))
        if not load_all:  # a tower that Flax never ran has no params there: keep the port's own
            state = {**tmodel.trained_state_dict(), **state}
        tmodel.load_trained_state_dict(state)
        tout = tmodel(batch, deterministic=True)
    return jout, tout, (jmodel, params, tmodel)


def assert_outputs_close(jout, tout, atol=ATOL):
    assert set(tout) == set(jout)
    for key, want in jout.items():
        np.testing.assert_allclose(tout[key].detach().numpy(), np.asarray(want), atol=atol, rtol=0, err_msg=key)


def _cos(a, b):
    a = (a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)).reshape(-1)
    b = (b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)).reshape(-1)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


# --- float32 parity, every transfer type ----------------------------------------------------

NONE_CASES = {
    "arpdt": ("ARPDT", {}, {}),
    "bc": ("BC", {}, {}),
    "gcbc_warns_and_ignores_the_goal": ("GCBC", {}, dict(with_goal=True)),
    "arpdt_causal_mask": ("ARPDT", dict(model_type=None), {}),
    "arpdt_preset_debug": ("ARPDT", dict(model_type="debug"), {}),
    "arpdt_state_input": ("ARPDT", {}, dict(with_state=True)),
    "bc_state_input": ("BC", {}, dict(with_state=True)),
    "arpdt_symlog": ("ARPDT", dict(use_symlog=True), {}),
    "arpdt_two_views": ("ARPDT", {}, dict(views=("ob", "side"))),
    "arpdt_alibi": ("ARPDT", dict(alibi_bias=True), {}),
    "arpdt_five_ensembles_lambda": ("ARPDT", dict(num_ensembles=5, lambda_return_pred=0.3), {}),
}


@pytest.mark.parametrize("case", list(NONE_CASES))
def test_transfer_none(case):
    cls, over, batch_kw = NONE_CASES[case]
    jout, tout, _ = run_pair(cls, base_config(**over), make_batch(1, with_rtg=cls == "ARPDT", **batch_kw))
    assert ("return_pred" in tout) == (cls == "ARPDT")
    assert_outputs_close(jout, tout)


@pytest.mark.parametrize("cls", ["ARPDT", "BC"])
@pytest.mark.parametrize("quat", [False, True])
def test_continuous_actions(cls, quat):
    cfg = base_config(use_discrete_action=False)
    batch = make_batch(2, continuous=True, with_rtg=cls == "ARPDT")
    if quat:  # normalize_quterion slices the TIME axis [3:7]: give it a window that long
        rng = np.random.default_rng(3)
        batch = {"image": {"ob": rng.normal(size=(BATCH, 8, IMG, IMG, 3)).astype(np.float32)},
                 "action": rng.normal(size=(BATCH, 8, 7)).astype(np.float32),
                 "rtg": {"ob": rng.normal(size=(BATCH, 8, 1)).astype(np.float32)},
                 "instruct": None, "text_padding_mask": None}
    jmodel = getattr(jpol, cls)(config_updates=cfg, num_actions=7, patch_dim=PATCH, normalize_quterion=quat)
    jbatch = _jax_batch(batch)
    params = _randomize(jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, deterministic=True)["params"], 4)
    jout = jmodel.apply({"params": params}, jbatch, deterministic=True)
    tmodel = getattr(tpol, cls)(cfg, num_actions=7, patch_dim=PATCH, normalize_quterion=quat).eval()
    with torch.no_grad():
        tmodel(batch, deterministic=True)
        tmodel.load_trained_state_dict(convert.flax_policy_to_torch(jax.device_get(params)))
        tout = tmodel(batch, deterministic=True)
    assert float(tout["acc"]) == 0.0
    assert_outputs_close(jout, tout)
    greedy = tmodel.greedy_action(batch)
    np.testing.assert_allclose(greedy.detach().numpy(), np.asarray(jout["action_pred"][:, -1]), atol=ATOL)


CLIP_CASES = {
    "arpdt_frozen": ("ARPDT", {}, {}, 32),
    "arpdt_frozen_text": ("ARPDT", dict(use_text=True), dict(with_text=True, text_len=77), 32),
    "arpdt_frozen_adapter_text": ("ARPDT", dict(use_adapter=True, use_text=True), dict(with_text=True, text_len=77), 32),
    "bc_frozen_resizes_to_224_bicubic": ("BC", {}, dict(with_text=True, text_len=77), 224),
    "gcbc_frozen_enlarges_and_shrinks": ("GCBC", {}, dict(with_goal=True, img=48), 224),
    "arpdt_from_scratch_text": ("ARPDT", dict(use_from_scratch=True, use_text=True), dict(with_text=True, text_len=77), 32),
    "arpdt_from_scratch_adapter": ("ARPDT", dict(use_from_scratch=True, use_adapter=True), {}, 32),
    "arpdt_two_views": ("ARPDT", {}, dict(views=("ob", "side")), 32),
}


@pytest.mark.parametrize("case", list(CLIP_CASES))
def test_transfer_clip(case, towers):
    cls, over, batch_kw, clip_size = CLIP_CASES[case]
    cfg = base_config(transfer_type="clip_tiny_test", **over)
    pt = None if over.get("use_from_scratch") else towers("clip", clip_size)
    towers("clip", clip_size)  # the tables' image size, for the from-scratch tower too
    jout, tout, (_, _, tmodel) = run_pair(cls, cfg, make_batch(5, with_rtg=cls == "ARPDT", **batch_kw), pt=pt,
                                          load_all=not over.get("use_from_scratch"))
    assert_outputs_close(jout, tout)
    frozen = not over.get("use_from_scratch")
    assert any(k.startswith("pt_model.") for k in tmodel.trained_state_dict()) != frozen
    assert all(not p.requires_grad for p in tmodel.pt_model.parameters()) == frozen


def test_transfer_clip_impala_backbone(towers):
    cfg = base_config(transfer_type="clip_tiny_test", use_impala_backbone=True, use_from_scratch=True)
    towers("clip", 32)
    jout, tout, _ = run_pair("ARPDT", cfg, make_batch(6), load_all=False)
    assert_outputs_close(jout, tout, atol=5e-5)  # three conv stacks deep


CACHED_CASES = {
    "clip_cached_arpdt": ("ARPDT", "clip_tiny_test_cached", {}, {}),
    "clip_cached_arpdt_adapter": ("ARPDT", "clip_tiny_test_cached", dict(use_adapter=True), {}),
    "clip_cached_text": ("ARPDT", "clip_tiny_test_cached", dict(use_text=True), dict(with_text=True, text_len=77)),
    "m3ae_cached_bc": ("BC", "m3ae_vit_b16_cached", {}, dict(with_text=True)),
    "m3ae_cached_gcbc_goal_emb": ("GCBC", "m3ae_vit_b16_cached", {}, dict(with_goal=True)),
    "m3ae_cached_gcbc_goal_emb_shared_adapter": ("GCBC", "m3ae_vit_b16_cached", dict(use_adapter=True),
                                                 dict(with_goal=True, views=("ob", "side"))),
}


@pytest.mark.parametrize("case", list(CACHED_CASES))
def test_transfer_cached(case, towers):
    cls, transfer, over, batch_kw = CACHED_CASES[case]
    pt = towers("clip", 32) if over.get("use_text") else None
    batch = make_batch(8, emb_dim=24, with_rtg=cls == "ARPDT", **batch_kw)
    jout, tout, _ = run_pair(cls, base_config(transfer_type=transfer, **over), batch, pt=pt)
    assert_outputs_close(jout, tout)


def test_cached_gcbc_needs_goal_embeddings():
    model = tpol.GCBC(base_config(transfer_type="m3ae_vit_b16_cached"), num_actions=15, patch_dim=PATCH)
    with pytest.raises(AssertionError, match="goal embeddings"):
        model(make_batch(9, emb_dim=24, with_rtg=False))
    with pytest.raises(AssertionError, match="cached mode has no live text tower"):
        tpol.BC(base_config(transfer_type="m3ae_vit_b16_cached", use_text=True), num_actions=15, patch_dim=PATCH)


def test_frozen_bf16_clip_and_compute_dtype(towers):
    batch = make_batch(11)
    pt = towers("clip", 32)
    _, ref, _ = run_pair("ARPDT", base_config(transfer_type="clip_tiny_test"), batch, pt=pt)
    for over in (dict(frozen_bf16=True), dict(compute_dtype="bfloat16")):
        jout, tout, (_, _, tmodel) = run_pair("ARPDT", base_config(transfer_type="clip_tiny_test", **over), batch, pt=pt)
        assert tmodel.pt_model.visual.conv1.weight.dtype == torch.bfloat16
        assert _cos(ref["action_pred"], tout["action_pred"]) > 0.98
        assert _cos(jout["action_pred"], tout["action_pred"]) > 0.98


# --- the configuration's resolution rules --------------------------------------------------

CONFIG_CASES = {
    "defaults": {},
    "vit_name_keeps_explicit_dims": dict(model_type="vit_base", emb_dim=96, depth=3),
    "preset_tiny": dict(model_type="tiny"),
    "preset_base": dict(model_type="base"),
    "preset_debug": dict(model_type="debug"),
    "preset_width_suffix_l": dict(model_type="smalll"),
    "preset_width_suffix_xl": dict(model_type="hugexl"),
    "unknown_suffix_keeps_dims": dict(model_type="smallish", emb_dim=64),
    "frozen_bf16": dict(frozen_bf16=True),
    "frozen_bf16_f32_scores": dict(frozen_bf16=True, frozen_score_dtype="float32"),
    "frozen_bf16_explicit_sub_score_wins": dict(frozen_bf16=True, frozen_score_dtype="float32",
                                                m3ae=dict(score_dtype="bfloat16")),
    "frozen_int8_implies_bf16_and_int8_attn": dict(frozen_int8=True, transfer_type="m3ae_vit_b16"),
    "frozen_int8_attn_true_forces_int8": dict(frozen_int8_attn="true", transfer_type="m3ae_vit_b16"),
    "frozen_int8_attn_one": dict(frozen_int8_attn="1"),
    "frozen_int8_attn_false_keeps_int8": dict(frozen_int8=True, frozen_int8_attn="false"),
    "frozen_int8_attn_zero": dict(frozen_int8_attn="0"),
    "frozen_int8_attn_auto_off": dict(transfer_type="m3ae_vit_b16"),
    "remat_propagates": dict(remat=True),
    "remat_explicit_sub": dict(remat=True, mae=dict(remat=True)),
    "compute_dtype_propagates": dict(compute_dtype="bfloat16"),
    "compute_dtype_explicit_sub_wins": dict(compute_dtype="bfloat16", m3ae=dict(compute_dtype="float16")),
    "sub_config_updates": dict(m3ae=dict(model_type="small"), mae=dict(model_type=None, emb_dim=48, depth=3)),
    "mae_type_embedding_off_by_default": dict(mae=dict(drop=0.1)),
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_config_resolution(case):
    want = jpol.get_policy_default_config(CONFIG_CASES[case]).to_dict()
    got = tpol.get_policy_default_config(CONFIG_CASES[case])
    assert {k: dict(v) if isinstance(v, dict) else v for k, v in got.items()} == want


def test_config_rejections():
    with pytest.raises(AssertionError, match="frozen_bf16"):
        tpol.get_policy_default_config(dict(frozen_bf16=True, use_from_scratch=True))
    with pytest.raises(AssertionError):
        tpol.get_policy_default_config(dict(frozen_int8_attn="maybe"))
    # a pipelined policy needs the mesh it pipelines over, as JAX's asserts it
    with pytest.raises(ValueError, match="pp_stages"):
        tpol.ARPDT(base_config(pp_stages=2), num_actions=15, patch_dim=PATCH)
    with pytest.raises(ValueError, match="Unsupported transfer type"):
        tpol.ARPDT(base_config(transfer_type="resnet"), num_actions=15, patch_dim=PATCH)
    # no OpenAI checkpoint where the JAX package looks for one (F5: the port reads the same file)
    with pytest.raises(FileNotFoundError, match=r"CLIP checkpoint not found at .*vit_b32\.npy"):
        tpol.ARPDT(base_config(transfer_type="clip_vit_b32"), num_actions=15, patch_dim=PATCH)


# --- losses, heads, decoding, state -----------------------------------------------------------


def test_losses():
    rng = np.random.default_rng(16)
    logits = rng.normal(size=(3, 4, 15)).astype(np.float32)
    labels = rng.integers(0, 15, size=(3, 4)).astype(np.int32)
    jl, ja = jpol.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 15)
    tl_, ta = tpol.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long(), 15)
    np.testing.assert_allclose(float(tl_), float(jl), atol=1e-6)
    assert float(ta) == pytest.approx(float(ja))
    np.testing.assert_allclose(float(tpol.mse_loss(torch.from_numpy(logits), torch.zeros(3, 4, 15))),
                               float(jpol.mse_loss(jnp.asarray(logits), 0.0)), rtol=1e-6)


def test_ensemble_heads_one_batched_matmul():
    x = np.random.default_rng(17).normal(size=(3, 4, 32)).astype(np.float32)
    jm = jpol.EnsembleHeads(5, 32, 7)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 18)
    tm = tpol.EnsembleHeads(5, 32, 32, 7)
    state = convert.flax_params_to_torch(jax.device_get(params))
    assert state["heads.Dense_0.kernel"].shape == (5, 32, 32) and state["heads.Dense_1.kernel"].shape == (5, 32, 7)
    tm.load_state_dict(state)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(jm.apply({"params": params}, jnp.asarray(x))),
                               atol=ATOL, rtol=0)


def test_greedy_and_sampled_decoding():
    batch = make_batch(19)
    batch = {**batch, "image": {"ob": np.repeat(batch["image"]["ob"], 4, 0)}, "action": np.repeat(batch["action"], 4, 0),
             "rtg": {"ob": np.repeat(batch["rtg"]["ob"], 4, 0)}}
    batch["image"]["ob"] = batch["image"]["ob"] + np.random.default_rng(0).normal(size=batch["image"]["ob"].shape).astype(np.float32)
    jmodel = jpol.ARPDT(config_updates=base_config(), num_actions=15, patch_dim=PATCH)
    params = _randomize(jmodel.init({"params": jax.random.PRNGKey(0)}, _jax_batch(batch), deterministic=True)["params"], 20)
    tmodel = tpol.ARPDT(base_config(), num_actions=15, patch_dim=PATCH).eval()
    with torch.no_grad():
        tmodel(batch, deterministic=True)
        tmodel.load_trained_state_dict(convert.flax_policy_to_torch(jax.device_get(params)))
        greedy = tmodel.greedy_action(batch)
        np.testing.assert_array_equal(greedy.numpy(), np.asarray(jmodel.apply({"params": params}, _jax_batch(batch), method=jmodel.greedy_action)))
        np.testing.assert_allclose(tmodel.greedy_return(batch).numpy(),
                                   np.asarray(jmodel.apply({"params": params}, _jax_batch(batch), method=jmodel.greedy_return)), atol=ATOL)
        gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
        cold = tmodel.sample_action(batch, gen(42), 1e-4)
        assert torch.equal(cold, greedy)  # temperature -> 0 is the greedy action
        assert torch.equal(tmodel.sample_action(batch, gen(42), 50.0), tmodel.sample_action(batch, gen(42), 50.0))
        hots = [tmodel.sample_action(batch, gen(k), 50.0) for k in range(5)]
        assert any(not torch.equal(hots[0], h) for h in hots[1:]), "high-temperature samples never varied"
