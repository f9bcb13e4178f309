"""The port's policies over the frozen M3AE / MAE tower against the Flax policies: every m3ae_* and
mae_* branch in float32 (atol 1e-5), frozen_bf16 and frozen_int8 by the JAX tests' cosine bounds on
action_pred (0.98 bf16 against float32, 0.95 int8 against bf16), build_frozen_qpack end to end, and
what the trained state holds.  Helpers and the tiny towers come from test_torch_policy.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.models import m3ae as jm3ae
from arp_tpu.models.policy import models as jpol
from arp_tpu_torch.models import m3ae as tm3ae
from arp_tpu_torch.models.policy import models as tpol

from test_torch_policy import (  # noqa: F401 (towers is a fixture)
    IMG, NPATCH, PATCH, TINY, WINDOW, _cos, _jax_batch, assert_outputs_close, base_config, make_batch, run_pair, towers,
)

M3AE_CASES = {
    "arpdt": ("ARPDT", "m3ae", {}, {}),
    "arpdt_adapter": ("ARPDT", "m3ae", dict(use_adapter=True), {}),
    "arpdt_text": ("ARPDT", "m3ae", dict(use_text=True), dict(with_text=True)),
    "arpdt_text_off_ignores_instruct": ("ARPDT", "m3ae", {}, dict(with_text=True)),
    "bc_reads_instruct": ("BC", "m3ae", {}, dict(with_text=True)),
    "arpdt_intermediate": ("ARPDT", "m3ae", dict(use_intermediate=True), {}),
    "arpdt_intermediate_text_adapter": ("ARPDT", "m3ae", dict(use_intermediate=True, use_text=True, use_adapter=True),
                                        dict(with_text=True)),
    "gcbc_goal_joint": ("GCBC", "m3ae", {}, dict(with_goal=True)),
    "gcbc_goal_joint_adapter": ("GCBC", "m3ae", dict(use_adapter=True), dict(with_goal=True)),
    "arpdt_two_views": ("ARPDT", "m3ae", {}, dict(views=("ob", "side"))),
    "arpdt_from_scratch": ("ARPDT", "m3ae", dict(use_from_scratch=True), {}),
    "gcbc_from_scratch": ("GCBC", "m3ae", dict(use_from_scratch=True), dict(with_goal=True)),
    "mae_bc": ("BC", "mae", {}, {}),
    "mae_arpdt_adapter": ("ARPDT", "mae", dict(use_adapter=True), {}),
    "mae_from_scratch": ("ARPDT", "mae", dict(use_from_scratch=True), {}),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models: more intra-op threads only fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tower_cfg(kind, **over):
    cfg = base_config(transfer_type=f"{kind}_vit_b16", **over)
    cfg[kind] = dict(TINY, use_type_embedding=False) if kind == "mae" else dict(TINY)
    return cfg


@pytest.mark.parametrize("case", list(M3AE_CASES))
def test_transfer_m3ae_and_mae(case, towers):
    cls, kind, over, batch_kw = M3AE_CASES[case]
    pt = towers(kind)
    jout, tout, (_, _, tmodel) = run_pair(cls, _tower_cfg(kind, **over), make_batch(7, with_rtg=cls == "ARPDT", **batch_kw),
                                          pt=None if over.get("use_from_scratch") else pt,
                                          load_all=not over.get("use_from_scratch"))
    assert_outputs_close(jout, tout)
    if over.get("use_intermediate"):
        assert tmodel.image_text_input.in_features == TINY["depth"] * TINY["emb_dim"] * (
            1 + NPATCH + (16 if over.get("use_text") else 0))


# --- frozen_bf16 and frozen_int8, by the JAX tests' cosine bounds ------------------------------


@pytest.mark.parametrize("cls,batch_kw", [("ARPDT", {}), ("GCBC", dict(with_goal=True))])
def test_frozen_bf16_m3ae(cls, batch_kw, towers):
    batch = make_batch(10, with_rtg=cls == "ARPDT", **batch_kw)
    pt = towers("m3ae")
    _, ref, _ = run_pair(cls, _tower_cfg("m3ae"), batch, pt=pt)
    jout, tout, (_, _, tmodel) = run_pair(cls, _tower_cfg("m3ae", frozen_bf16=True), batch, pt=pt)
    assert next(tmodel.pt_model.parameters()).dtype == torch.bfloat16  # the tower is cast once, at construction
    assert all(v.dtype == torch.float32 for v in tmodel.trained_state_dict().values())
    assert tout["action_pred"].dtype == torch.float32 and np.isfinite(float(tout["loss"]))
    assert _cos(ref["action_pred"], tout["action_pred"]) > 0.98
    assert _cos(jout["action_pred"], tout["action_pred"]) > 0.98  # the same recipe in the two packages


def _qpacks(batch, m3ae_vars, pt, with_goal=False, text=False, kind="m3ae"):
    """The calibrated int8 pack of each package, from the policy's own patches."""
    from arp_tpu.ops import m3ae_infer as jinfer
    from arp_tpu_torch.ops import m3ae_infer as tinfer

    def patches(tree):
        image = np.stack(list(tree.values()))
        return image.reshape((-1,) + image.shape[-3:])

    patch = patches(batch["image"])
    jkw, tkw = {}, {}
    if with_goal:
        goal = patches(batch["goal"])
        jkw["goal_patch"] = jm3ae.extract_patches(jnp.asarray(goal), PATCH)
        tkw["goal_patch"] = tm3ae.extract_patches(torch.from_numpy(goal), PATCH)
    if text:
        n = patch.shape[0] // batch["instruct"].shape[0]
        ids, pad = np.tile(batch["instruct"], (n, 1)), np.tile(batch["text_padding_mask"], (n, 1))
        jkw.update(text_ids=jnp.asarray(ids), text_padding_mask=jnp.asarray(pad))
        tkw.update(text_ids=torch.from_numpy(ids).long(), text_padding_mask=torch.from_numpy(pad))
    jq = jinfer.build_m3ae_qpack(m3ae_vars, TINY["depth"], TINY["num_heads"],
                                 jm3ae.extract_patches(jnp.asarray(patch), PATCH), **jkw)
    tq = tinfer.build_m3ae_qpack(pt, TINY["depth"], TINY["num_heads"],
                                 tm3ae.extract_patches(torch.from_numpy(patch), PATCH), **tkw)
    return jq, tq


INT8_CASES = {
    "arpdt": ("ARPDT", dict(frozen_int8=True), {}),
    "arpdt_bf16_attention": ("ARPDT", dict(frozen_int8=True, frozen_int8_attn="false"), {}),
    "arpdt_int8_attn_forces_int8": ("ARPDT", dict(frozen_int8_attn="true"), {}),
    "gcbc_goal": ("GCBC", dict(frozen_int8=True), dict(with_goal=True)),
    "arpdt_text": ("ARPDT", dict(frozen_int8=True, use_text=True), dict(with_text=True)),
    "arpdt_intermediate": ("ARPDT", dict(frozen_int8=True, use_intermediate=True), {}),
}


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_frozen_int8_m3ae(case, towers):
    cls, over, batch_kw = INT8_CASES[case]
    batch = make_batch(12, with_rtg=cls == "ARPDT", **batch_kw)
    pt = towers("m3ae")
    bf16_over = {k: v for k, v in over.items() if not k.startswith("frozen_int8")}
    _, ref, _ = run_pair(cls, _tower_cfg("m3ae", frozen_bf16=True, **bf16_over), batch, pt=pt)
    qpacks = _qpacks(batch, towers.m3ae_vars, pt, with_goal="goal" in batch, text=bool(over.get("use_text")))
    jout, tout, (_, _, tmodel) = run_pair(cls, _tower_cfg("m3ae", **over), batch, pt=pt, qpacks=qpacks)
    assert tmodel._frozen_fast_int8() and tmodel._int8_attn() == (over.get("frozen_int8_attn") != "false")
    assert np.isfinite(float(tout["loss"]))
    assert _cos(ref["action_pred"], tout["action_pred"]) > 0.95
    assert _cos(jout["action_pred"], tout["action_pred"]) > 0.95  # the same recipe in the two packages


def test_frozen_int8_mae(towers):
    batch = make_batch(13, with_rtg=False)
    pt = towers("mae")
    mae_vars = jm3ae.load_m3ae_model_vars("vit_b16")
    _, ref, _ = run_pair("BC", _tower_cfg("mae", frozen_bf16=True), batch, pt=pt)
    qpacks = _qpacks(batch, mae_vars, pt)
    jout, tout, _ = run_pair("BC", _tower_cfg("mae", frozen_int8=True), batch, pt=pt, qpacks=qpacks)
    assert _cos(ref["action_pred"], tout["action_pred"]) > 0.95
    assert _cos(jout["action_pred"], tout["action_pred"]) > 0.95


def test_frozen_int8_requires_a_pack(towers):
    model = tpol.ARPDT(_tower_cfg("m3ae", frozen_int8=True), num_actions=15, patch_dim=PATCH, pt_variables=towers("m3ae"))
    with pytest.raises(AssertionError, match="frozen_qpack"):
        model(make_batch(14), deterministic=True)


@pytest.mark.parametrize("mode", ["image", "goal", "text"])
def test_build_frozen_qpack_end_to_end(mode, towers):
    """Raw uint8 frames -> a calibrated pack that fits a policy encoding eval-transformed frames,
    bit-equal weights and amaxes within the bf16 calibration's 2% of the JAX package's pack."""
    from arp_tpu_torch.ops.augment import make_eval_transform

    rng = np.random.default_rng(15)
    raw = {"image": {"ob": rng.integers(0, 255, size=(2, WINDOW, IMG, IMG, 3)).astype(np.uint8)},
           "rtg": {"ob": rng.normal(size=(2, WINDOW, 1)).astype(np.float32)},
           "action": rng.integers(0, 15, size=(2, WINDOW)).astype(np.int32),
           "goal": None, "instruct": None, "text_padding_mask": None}
    over, cls = dict(frozen_int8=True), "ARPDT"
    if mode == "goal":
        raw["goal"] = {"ob": rng.integers(0, 255, size=(2, WINDOW, IMG, IMG, 3)).astype(np.uint8)}
        cls = "GCBC"
    if mode == "text":
        raw["instruct"] = rng.integers(1, 97, size=(2, 16)).astype(np.int32)
        raw["text_padding_mask"] = np.zeros((2, 16), np.float32)
        over["use_text"] = True
    cfg = _tower_cfg("m3ae", **over)
    pt = towers("m3ae")
    jq, jamax = jpol.build_frozen_qpack(cfg, _jax_batch({k: v for k, v in raw.items() if v is not None}) | {
        k: None for k, v in raw.items() if v is None}, PATCH, image_size=IMG, use_goal=mode == "goal", return_amax=True)
    tq, tamax = tpol.build_frozen_qpack(cfg, raw, PATCH, image_size=IMG, use_goal=mode == "goal",
                                        m3ae_loader=lambda name: pt, return_amax=True, device="cpu")
    assert torch.equal(tq["layers"]["wfc_q"], torch.from_numpy(np.array(jq["layers"]["wfc_q"])))
    for site, want in jamax["layers"].items():
        np.testing.assert_allclose(tamax["layers"][site].numpy(), np.asarray(want), rtol=2e-2, err_msg=site)
    again = tpol.build_frozen_qpack(cfg, raw, PATCH, image_size=IMG, m3ae_loader=lambda name: pt, amax=tamax,
                                   device="cpu")
    assert torch.equal(again["layers"]["a_fc"], tq["layers"]["a_fc"]) and torch.equal(again["img_w_q"], tq["img_w_q"])

    transform = make_eval_transform(image_size=IMG, device="cpu")
    model_batch = dict(raw, image={"ob": transform(raw["image"]["ob"].reshape(-1, IMG, IMG, 3)).reshape(2, WINDOW, IMG, IMG, 3)})
    if mode == "goal":
        model_batch["goal"] = {"ob": transform(raw["goal"]["ob"].reshape(-1, IMG, IMG, 3)).reshape(2, WINDOW, IMG, IMG, 3)}
    ref = tpol.__dict__[cls](_tower_cfg("m3ae", frozen_bf16=True, **{k: v for k, v in over.items() if k == "use_text"}),
                             num_actions=15, patch_dim=PATCH, pt_variables=pt).eval()
    fast = tpol.__dict__[cls](cfg, num_actions=15, patch_dim=PATCH, pt_variables=pt, frozen_qpack=tq).eval()
    with torch.no_grad():
        torch.manual_seed(0)
        a = ref(model_batch, deterministic=True)
        fast(model_batch, deterministic=True)
        fast.load_trained_state_dict(ref.trained_state_dict())
        b = fast(model_batch, deterministic=True)
    assert _cos(a["action_pred"], b["action_pred"]) > 0.95


def test_build_frozen_qpack_asks_for_cuda_unless_told_cpu(towers):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    pt = towers("m3ae")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tpol.build_frozen_qpack(_tower_cfg("m3ae", frozen_int8=True), {"image": {}}, PATCH, image_size=IMG,
                                m3ae_loader=lambda name: pt)


# --- state and gradients ----------------------------------------------------------------------


def test_trained_state_excludes_the_frozen_tower_and_round_trips(towers):
    batch = make_batch(22)
    cfg = _tower_cfg("m3ae", use_adapter=True)
    a = tpol.ARPDT(cfg, num_actions=15, patch_dim=PATCH, pt_variables=towers("m3ae")).eval()
    with torch.no_grad():
        out_a = a(batch, deterministic=True)
    state = a.trained_state_dict()
    assert not any(k.startswith("pt_model.") for k in state) and "residual_weight" in state
    assert "AdapterMLP_0.Dense_0.weight" in state and "state_input.weight" not in state  # never run: still lazy
    b = a.clone_sharing_frozen()
    assert b.pt_model is a.pt_model and b.policy is not a.policy
    torch.manual_seed(1)
    with torch.no_grad():
        for p in b.policy.parameters():
            p.add_(0.1 * torch.randn_like(p))
        assert not torch.allclose(b(batch, deterministic=True)["action_pred"], out_a["action_pred"])
        b.load_trained_state_dict(state)
        torch.testing.assert_close(b(batch, deterministic=True)["action_pred"], out_a["action_pred"], atol=0, rtol=0)
    with pytest.raises(RuntimeError, match="does not fit"):
        b.load_trained_state_dict({k: v for k, v in state.items() if k != "residual_weight"})
    with pytest.raises(RuntimeError, match="does not fit"):
        b.load_trained_state_dict({**state, "stray.weight": torch.zeros(1)})


def test_gradients_reach_the_policy_and_not_the_frozen_tower(towers):
    model = tpol.ARPDT(_tower_cfg("m3ae", use_adapter=True), num_actions=15, patch_dim=PATCH, pt_variables=towers("m3ae"))
    model(make_batch(23), deterministic=True)["loss"].backward()
    assert model.image_text_input.weight.grad.abs().max() > 0 and model.residual_weight.grad is not None
    assert all(p.grad is None for p in model.pt_model.parameters())
