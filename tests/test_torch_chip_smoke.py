"""chip_smoke.py's pieces on the CPU: its random weights have the Flax layout,
its in-memory demo group labels like an HDF5 file, and without a GPU it
exits non-zero and prints no result."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from arp_tpu.models.clip import CLIP as FlaxCLIP
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE
from arp_tpu_torch.models.clip import CLIP, MODELS, flax_to_torch
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.reward.engine import ClipRewardEngine
from arp_tpu_torch.reward.labeler import label_group, label_rewards


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def test_random_weights_have_the_flax_layout():
    images = jnp.zeros((1, TINY_CLIP_IMG_SIZE, TINY_CLIP_IMG_SIZE, 3))
    flax_vars = FlaxCLIP(**TINY_CLIP_CFG).init(jax.random.PRNGKey(0), images, jnp.zeros((1, 77), jnp.int32))
    ours = chip_smoke.random_clip_variables(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, seed=0)
    assert _shapes(ours) == _shapes(flax_vars)


def test_random_vit_b16_weights_fill_the_port_model():
    from arp_tpu_torch.models.clip import CONFIGS

    state = flax_to_torch(chip_smoke.random_clip_variables(CONFIGS["vit_b16"], 224, seed=0))
    model = MODELS["vit_b16"]()
    model.load_state_dict(state)  # strict: every name and shape matches
    assert float(model.logit_scale.exp()) == pytest.approx(chip_smoke.LOGIT_SCALE)


def _tiny_engine():
    model = CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE)
    model.load_state_dict(flax_to_torch(chip_smoke.random_clip_variables(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, 1)))
    return ClipRewardEngine(model=model, batch_size=8, tokenizer=Char97Tokenizer(), device="cpu")


def test_memory_group_labels_like_an_hdf5_file(tmp_path):
    engine = _tiny_engine()
    group = chip_smoke.demo_group(30, 2, 48, seed=0)
    path = str(tmp_path / "demo.hdf5")
    with h5py.File(path, "w") as f:
        for key in ("ob", "act", "done"):
            f.create_dataset(key, data=np.asarray(group[key]))
    stats = label_group(group, "collect the coin.", engine, progress=False)
    label_rewards(path, "collect the coin.", engine=engine, progress=False)
    assert stats["frames"] == 30
    with h5py.File(path, "r") as f:
        for key in ("ob_clip_reward", "ob_clip_pos_rtg"):
            np.testing.assert_array_equal(np.asarray(group[key]), f[key][:])
            assert group[key].attrs == dict(f[key].attrs)


def test_exits_nonzero_without_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::flash_fwd_kernel<float, 64>(Params)", "k1_attention"),
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel<64>((anonymous namespace)::Params, int)", "k1_attention"),
    ("void (anonymous namespace)::flash_fwd_simt_kernel<128>((anonymous namespace)::Params, int)", "k1_attention"),
    ("void (anonymous namespace)::int8_gemm_kernel<__nv_bfloat16>(__nv_bfloat16 const*, float const*)",
     "k2_int8_gemm"),
    ("void (anonymous namespace)::int8_gemm_kernel<__nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, float const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int, int, (anonymous namespace)::Plan)", "k2_int8_gemm"),
    ("void (anonymous namespace)::int8_matmul_kernel<float>(float const*, signed char const*)", "k3_int8_matmul"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>", "layernorm"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", "elementwise"),
])
def test_kernel_kind_names_each_kernel(name, kind):
    assert chip_smoke.kernel_kind(name) == kind


def test_kernels_line_lists_all_three_with_their_tpu_kernels():
    """Each entry has the contract's fields; source and replaces point at real files and lines."""
    import json
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    timing = {"ms": 1.0, "plain_ms": 2.0, "shape": [1, 2, 3], "library_ms": None,
              **chip_smoke.bound(3.35e9, 989e9, "bf16")}
    line = json.loads(json.dumps({"kernels": [chip_smoke.kernel_entry(name, 7, 0.5, timing)
                                              for name in chip_smoke.KERNELS]}))
    assert [k["name"] for k in line["kernels"]] == ["flash_attn_fwd", "int8_gemm", "int8_matmul"]
    for entry in line["kernels"]:
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms"} <= set(entry)
        assert entry["bound_ms"] == 1.0 and entry["bound_by"] == "bytes" and entry["library_ms"] is None
        assert entry["route"] == "cuda" and os.path.isfile(os.path.join(repo, entry["source"]))
        path, lineno = entry["replaces"].split(":")
        with open(os.path.join(repo, path)) as f:
            assert f.read().splitlines()[int(lineno) - 1].lstrip().startswith("def ")


@pytest.mark.parametrize("nbytes,ops,kind,ms,by", [
    (3.35e9, 989e9, "bf16", 1.0, "bytes"),  # a tie goes to bytes
    (3.35e9, 4 * 989e9, "bf16", 4.0, "operations"),
    (2 * 3.35e9, 1979e9, "int8", 2.0, "bytes"),
    (0.0, 67e9, "f32", 1.0, "operations"),
])
def test_bound_is_the_larger_of_bytes_and_operations(nbytes, ops, kind, ms, by):
    b = chip_smoke.bound(nbytes, ops, kind)
    assert b["bound_ms"] == pytest.approx(ms) and b["bound_by"] == by
    assert b["bound_ms"] == max(b["bytes_ms"], b["operations_ms"]) and b["operations_at"] == kind


def test_bf16_ulps():
    x = torch.tensor([1.0, 3.0, -100.0, 0.0])
    up = torch.nextafter(x.bfloat16(), torch.full((4,), 1e9, dtype=torch.bfloat16))
    assert chip_smoke.bf16_ulps(up, x) == 1.0
    assert chip_smoke.bf16_ulps(x, x) == 0.0
    tiny = torch.tensor([1e-7, -3e-7])
    assert chip_smoke.bf16_ulps(tiny, 2 * tiny) > 100  # many bf16 ulps of so small a number
    assert chip_smoke.bf16_ulps(tiny, 2 * tiny, floor=chip_smoke.TANH_GELU_TAIL_UNIT) < 0.5


@pytest.mark.parametrize("log,faults", [
    ("ptxas info    : Used 168 registers, used 16 barriers\n"
     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n", 0),
    ("    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads\n", 1),
    ("    16 bytes stack frame, 0 bytes spill stores, 12 bytes spill loads\n", 1),
    ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to "
     "insufficient register resources for the wgmma pipeline in function 'f'\n", 1),
    ("ptxas info    : (C7508) Potential Performance Loss: 'setmaxnreg' ignored to maintain minimum register "
     "requirements in function 'f'\n"
     "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n", 2),
    ("", 0),
])
def test_ptxas_faults_finds_serialized_wgmma_ignored_setmaxnreg_and_spills(log, faults):
    assert len(chip_smoke.ptxas_faults(log)) == faults


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dense", "strided", "offset"])
def test_k2_inputs_layouts_are_what_k2_takes(layout, dtype):
    """A strided x is a column slice (row stride > K), an offset x starts 16 bytes into its allocation
    (on the card, where allocations start on 512 bytes: 16 bytes into a 128-byte line); both keep
    16-byte aligned rows, which is all that K2's wrapper asks."""
    from arp_tpu_torch.ops import quantization

    gen = torch.Generator().manual_seed(0)
    x, a, wq, ws, bias, wq_t = chip_smoke.k2_inputs(37, 96, 40, dtype, gen, quantization, layout)
    assert x.shape == (37, 96) and x.dtype == dtype and x.stride(1) == 1
    assert x.data_ptr() % 16 == 0 and (x.stride(0) * x.element_size()) % 16 == 0
    assert (x.stride(0) > 96) == (layout == "strided")
    if layout == "offset":
        assert x.storage_offset() * x.element_size() == 16
    assert wq.shape == (96, 40) and wq_t.shape == (40, 96) and wq_t.is_contiguous()
    assert float(a) == pytest.approx(1.05 * float(x.float().abs().max()))


@pytest.mark.parametrize("label", list(chip_smoke.K2_RAGGED))
def test_k2_ragged_cases_are_shapes_k2_takes(label):
    """Every extra case of chip_smoke's k2 phase keeps K % 32 == 0 and N % 8 == 0, and runs through
    the wrapper's plain version on the CPU at a tenth of its rows."""
    from arp_tpu_torch.ops import quantization, vit_infer

    m, k, n, dtype, act, layout, margin, with_bias = chip_smoke.K2_RAGGED[label]
    assert k % 32 == 0 and n % 8 == 0
    m = max(1, m // 10)
    gen = torch.Generator().manual_seed(1)
    x, a, wq, ws, bias, wq_t = chip_smoke.k2_inputs(m, k, n, dtype, gen, quantization, layout, margin)
    out = vit_infer.fused_int8_matmul(x, a, wq, ws, bias if with_bias else None, act, wq_t=wq_t)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    clamped = (x.float().abs() > a).any().item()
    assert clamped == (margin < 1.0)


# --- the policy path's phases ------------------------------------------------------------------

TINY_M3AE = dict(emb_dim=32, depth=2, num_heads=4, mlp_ratio=2)


def test_random_m3ae_weights_have_the_flax_layout():
    """The encoder side of Flax's own init tree, name for name and shape for shape, and a strict load."""
    from arp_tpu.models import m3ae as jm3ae
    from arp_tpu_torch.models import m3ae as tm3ae
    from arp_tpu_torch.models.policy import flax_m3ae_to_torch

    cfg = dict(model_type=None, dec_emb_dim=16, dec_depth=1, dec_num_heads=2, **TINY_M3AE)
    model = jm3ae.MaskedMultimodalAutoencoder(config_updates=cfg, text_vocab_size=101)
    flax_vars = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 768)), jnp.zeros((1, 5), jnp.int32),
                           jnp.zeros((1, 5)), method=model.forward_representation, deterministic=True)
    ours = chip_smoke.random_m3ae_variables(TINY_M3AE, 16, 101, seed=0)
    want = {k: v for k, v in _shapes(flax_vars).items()
            if not k[1].startswith("decoder") and not k[1].endswith("mask_embedding")}
    assert _shapes(ours) == want
    port = tm3ae.MaskedMultimodalAutoencoder(cfg, text_vocab_size=101)
    port.load_state_dict(flax_m3ae_to_torch(ours))  # strict
    again = chip_smoke.random_m3ae_variables(TINY_M3AE, 16, 101, seed=0)
    np.testing.assert_array_equal(ours["params"]["cls_token"], again["params"]["cls_token"])


def test_new_k2_sites_are_shapes_k2_takes_and_k1_cases_fit_the_tower():
    for label, (m, k, n, dtype, act) in chip_smoke.K2_M3AE_SITES.items():
        assert k % 32 == 0 and n % 8 == 0 and act in ("none", "gelu_tanh"), label
        assert m == 512 * (256 if label == "m3ae_img" else 257)
    assert chip_smoke.K2_M3AE_SITES["m3ae_fc"][4] == "gelu_tanh" and chip_smoke.K2_M3AE_SITES["m3ae_img"][3] == torch.float32
    assert chip_smoke.LABEL_ROWS.max() < chip_smoke.LABEL_FRAMES
    done = np.asarray(chip_smoke.demo_group(chip_smoke.LABEL_FRAMES, 2, 8, 0)["done"])[:, -1]
    assert {84, 169, 255} == set(np.flatnonzero(done)) <= set(chip_smoke.LABEL_ROWS)


def test_k1_recorder_notes_shapes_and_keeps_the_count():
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops.masks import MaskSpec

    real = attn.flash_attention_fwd
    calls = []
    fake = lambda q, k, v, spec, pad=None: calls.append(1) or q  # noqa: E731
    fake.launches = 5
    attn.flash_attention_fwd = fake
    try:
        with chip_smoke.K1Recorder() as rec:
            q = torch.zeros(2, 12, 8, 16)
            attn.flash_attention_fwd(q, q, q, MaskSpec("dt", 1, 3), None)
            attn.flash_attention_fwd(q, q, q, MaskSpec("dt", 1, 3), torch.zeros(2, 12))
            attn.flash_attention_fwd.launches += 1  # as the wrapper counts, through its module's name
        assert attn.flash_attention_fwd is fake and fake.launches == 6 and len(calls) == 2
        assert rec.counts() == {"dt n=12 h=8 d=16 float32": 1, "dt n=12 h=8 d=16 float32 padded": 1}
    finally:
        attn.flash_attention_fwd = real


def test_launch_shapes_note_each_kernel_call_and_keep_the_counts():
    """LaunchShapes stands in for K1's and K2's wrappers (K2's under both module names), notes each call by
    the key k1_check / k2_check give their cases, leaves the launch counts the wrappers' own, and restores."""
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import m3ae_infer, vit_infer
    from arp_tpu_torch.ops.masks import MaskSpec

    real_k1, real_k2 = attn.flash_attention_fwd, vit_infer.fused_int8_matmul
    fake_k1 = lambda q, k, v, spec, pad=None: q  # noqa: E731
    fake_k1.launches = 3
    attn.flash_attention_fwd = fake_k1
    try:
        x = torch.randn(6, 64)
        wq = torch.randint(-127, 128, (64, 16), dtype=torch.int8)
        a, ws = torch.tensor(3.0), torch.full((1, 16), 0.01)
        with chip_smoke.LaunchShapes() as shapes:
            q = torch.zeros(2, 12, 8, 16)
            attn.flash_attention_fwd(q, q, q, MaskSpec("dt", 1, 3), None)
            attn.flash_attention_fwd.launches += 1  # as the wrapper counts, through its module's name
            m3ae_infer.fused_int8_matmul(x, a, wq, ws, None, "gelu_tanh")
            vit_infer.fused_int8_matmul(x.bfloat16(), a, wq, ws)
        assert attn.flash_attention_fwd is fake_k1 and fake_k1.launches == 4
        assert vit_infer.fused_int8_matmul is real_k2 and m3ae_infer.fused_int8_matmul is real_k2
        assert dict(shapes.k1) == {chip_smoke.k1_key(2, 12, 8, 16, MaskSpec("dt", 1, 3), False, torch.float32): 1}
        assert dict(shapes.k2) == {chip_smoke.k2_key(6, 64, 16, torch.float32, "gelu_tanh"): 1,
                                   chip_smoke.k2_key(6, 64, 16, torch.bfloat16, "none"): 1}
        assert chip_smoke.k1_key(2, 12, 8, 16, MaskSpec("dt", 1, 3), True, torch.bfloat16) == "dt/1/3 b=2 n=12 h=8 d=16 bfloat16 padded"
    finally:
        attn.flash_attention_fwd = real_k1


def test_plain_kernels_compute_what_the_kernels_compute_and_restore():
    """plain_kernels puts each kernel's plain version in the wrapper's place: K1's with float32 scores, out in
    q's dtype; K2's the reference; the wrappers come back after."""
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import m3ae_infer, vit_infer
    from arp_tpu_torch.ops.masks import MaskSpec

    real_k1, real_k2 = attn.flash_attention_fwd, vit_infer.fused_int8_matmul
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, 4, 16, generator=gen).bfloat16() for _ in range(3))
    x = torch.randn(5, 64, generator=gen)
    wq = torch.randint(-127, 128, (64, 16), dtype=torch.int8, generator=gen)
    a, ws = torch.tensor(3.0), torch.full((1, 16), 0.01)
    with chip_smoke.plain_kernels():
        got = attn.flash_attention_fwd(q, k, v, MaskSpec("causal"))
        out = m3ae_infer.fused_int8_matmul(x, a, wq, ws, None, "gelu_tanh")
    want = attn.reference_attention(q.float(), k.float(), v.float(), MaskSpec("causal")).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(out, vit_infer.fused_int8_matmul_reference(x, a, wq, ws, None, "gelu_tanh"))
    assert attn.flash_attention_fwd is real_k1 and vit_infer.fused_int8_matmul is real_k2
    assert m3ae_infer.fused_int8_matmul is real_k2
    with chip_smoke.plain_kernels(k1=False):
        assert attn.flash_attention_fwd is real_k1 and vit_infer.fused_int8_matmul is not real_k2


def test_policy_path_phases_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The m3ae, policy, train and serve phases end to end on the CPU at a tiny tower width and few frames:
    their control flow, shapes and comparisons.  What only the card can show (a kernel's launches,
    the profile) is left out."""
    from arp_tpu_torch import serve
    from arp_tpu_torch.models import m3ae as m3ae_lib
    from arp_tpu_torch.models import policy as policy_lib
    from arp_tpu_torch.models.policy import flax_m3ae_to_torch
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import m3ae_infer, quantization, vit_infer

    for name, value in dict(DEVICE="cpu", M3AE_DIMS=TINY_M3AE, M3AE_CFG=dict(model_type=None, **TINY_M3AE),
                            M3AE_FRAMES=3, CPU_FRAMES=2, BERT_VOCAB=211, POLICY_BATCH=2, POLICY_WINDOW=2,
                            SERVE_SESSIONS=3, SERVE_STEPS=3, TRAIN_WARMUP=1, TRAIN_TIMED=1).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(policy_lib.models, "BERT_VOCAB_SIZE", 211)
    monkeypatch.setattr(chip_smoke, "device_profile", lambda run: {"rehearsal": True})
    real_check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: real_check(ok or "launch" in what, what))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}

    chip_smoke.phase_m3ae(counters, attn, m3ae_lib, m3ae_infer, flax_m3ae_to_torch)
    _, keep = chip_smoke.phase_policy(counters, attn, policy_lib, flax_m3ae_to_torch)
    chip_smoke.phase_train(counters, attn, policy_lib, flax_m3ae_to_torch)
    chip_smoke.phase_serve(counters, keep, policy_lib, serve)
    import json

    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    by_phase = {}
    for line in lines:
        by_phase.setdefault(line["phase"], []).append(line)
    assert len(by_phase["m3ae"]) == 18 and {(m["mode"], m["stream"]) for m in by_phase["m3ae"]} == {
        (mode, stream) for mode in ("module_f32", "module_bf16", "packed_f32", "packed_bf16", "int8", "int8_attn")
        for stream in ("image", "text", "goal")}
    assert all(m["cosine_vs_cpu"] > 0.9999 for m in by_phase["m3ae"])  # the same device twice
    assert [p["mode"] for p in by_phase["policy"]] == ["float32", "frozen_bf16", "frozen_int8"]
    assert by_phase["policy"][1]["cosine_vs_float32"] > 0.98 and by_phase["policy"][2]["cosine_vs_frozen_bf16"] > 0.95
    assert [p["mode"] for p in by_phase["train"]] == ["float32", "frozen_bf16", "frozen_int8"]
    assert all(t["frames"] == 4 and t["trained_params"] > 0 for t in by_phase["train"])
    compared = by_phase["train_vs_cpu"][0]  # the same device twice: equal
    for run in (compared["end_to_end"], compared["same_tower_output"]):
        assert run["loss_abs_err"] == 0.0 and run["grad_err_rel_to_max"] == 0.0 and run["adapter_relu_units_flipped"] == 0
        assert run["entries_left_out_for_flips"] == 0
    assert by_phase["serve"][0]["requests"] == 9 and by_phase["serve"][0]["actions_differing_from_direct_forward"] == 0
    assert by_phase["serve_reload"][0]["health_step"] == 7


def test_random_adapter_weights_have_the_flax_layout():
    """random_adapter_variables gives Flax's own init tree of the adapter, name for name and shape for shape."""
    from arp_tpu.finetune.adapter_model import ClipMultiscaleAdapter as JAdapter
    from arp_tpu.models.clip.model import CONFIGS as JCONFIGS
    from arp_tpu_torch.finetune.adapter_model import ClipMultiscaleAdapter
    from arp_tpu_torch.finetune.convert import flax_adapter_to_torch
    from test_finetune import TINY_CFG, make_batch, tiny_tokens

    JCONFIGS["tiny_smoke_layout"] = TINY_CFG
    try:
        model = JAdapter(clip_model_name="tiny_smoke_layout", action_dim=7)
        clip_vars = FlaxCLIP(**TINY_CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                                              jnp.asarray(tiny_tokens(1)))
        params = model.init({"params": jax.random.PRNGKey(1), "aug": jax.random.PRNGKey(2)}, clip_vars,
                            make_batch(np.random.default_rng(0)), train=False)
    finally:
        del JCONFIGS["tiny_smoke_layout"]
    ours = chip_smoke.random_adapter_variables(TINY_CFG, 0, 7, seed=0)
    assert _shapes(ours) == _shapes(params)
    ClipMultiscaleAdapter(clip_config=TINY_CFG, action_dim=7).load_state_dict(flax_adapter_to_torch(ours))  # strict


def test_finetune_phases_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The finetune and slice_ft phases end to end on the CPU at a tiny CLIP width and few frames: their
    control flow, shapes and comparisons (the same device twice: equal).  What only the card can show
    (the kernels' launches, the profile) is left out."""
    import json

    from arp_tpu_torch.models.clip import model as tclip_model
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import quantization, vit_infer

    tiny = dict(embed_dim=16, vocab_size=600, vision_num_layers=3, vision_features=64, vision_patch_size=16,
                text_features=16, text_num_heads=4, text_num_layers=2)
    monkeypatch.setitem(tclip_model.CONFIGS, "tiny_smoke", tiny)
    for name, value in dict(DEVICE="cpu", FT_CLIP="tiny_smoke", FT_BATCH=2, FT_CPU_BATCH=2, FT_FRAME=40,
                            FT_WARMUP=1, FT_TIMED=1, FT_LABEL_FRAMES=9, FT_ROWS=np.array([0, 2, 8]),
                            FT_BATCH_LABEL=4).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "device_profile", lambda run: {"rehearsal": True})
    real_check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: real_check(ok or "launch" in what, what))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    weights = chip_smoke.ft_weights()
    chip_smoke.phase_finetune(counters, weights)
    chip_smoke.phase_slice_ft(counters, weights, label_group, vit_infer)
    assert vit_infer.fused_int8_matmul is counters["int8_gemm"]  # the F2 check put K2's wrapper back
    by_phase = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            record = json.loads(line)
            by_phase.setdefault(record["phase"], []).append(record)
    compared = by_phase["finetune_vs_cpu"][0]
    assert compared["loss_rel_err"] == 0.0 and compared["grad_err_rel_to_max"] == 0.0
    assert compared["param_err_rel_to_max"] == 0.0 and sum(compared["relu_units_flipped"].values()) == 0
    step = by_phase["finetune"][0]
    assert step["quadruples"] == 2 and step["trained_params"] > 0 and np.isfinite(step["loss"])
    assert {"preprocess_ms", "clip_encode_ms", "adapter_forward_backward_adamw_ms"} <= set(step)
    assert [r["mode"] for r in by_phase["slice_ft"]] == list(chip_smoke.FT_MODES)
    # the engine runs its last batch at its own size: at batch 4 the 9 frames leave row 8 alone, where the CPU
    # engine encodes it among 3 rows.  Float32 rounding in module_f32 and fast_int8 (measured 6e-7, 1e-6); a bf16
    # trunk's rounding in the other two (measured 1.4e-2, 6.5e-3), held to the phase's bf16 bound (BF16_COS_MAE
    # times the engine's logit scale)
    for r in by_phase["slice_ft"]:
        bound = 1e-5 if r["mode"] in ("module_f32", "fast_int8") else r["mae_bound"]
        assert r["frames"] == 9 and r["reward_mae_vs_cpu"] < bound, r
    f2 = by_phase["f2"][0]
    assert f2["frames"] == 9 and f2["k2_vs_plain_on_card_mae"] == 0.0  # on the CPU both runs are the plain version


def test_engine_spec_is_the_jax_package_s_layout(tmp_path):
    """write_engine_spec writes what ClipRewardEngine.save_npz writes: both packages' from_npz read it and
    score as an engine on the same variables does."""
    from arp_tpu.reward.engine import ClipRewardEngine as JEngine

    variables = chip_smoke.random_clip_variables(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, seed=3)
    spec = chip_smoke.write_engine_spec(str(tmp_path / "tiny.npz"), variables, TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE)
    frames = np.random.default_rng(0).integers(0, 256, size=(5, 48, 48, 3), dtype=np.uint8)
    jengine, tengine = JEngine.from_npz(spec, batch_size=8), ClipRewardEngine.from_npz(spec, batch_size=8, device="cpu")
    direct = ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE), variables=variables,
                              batch_size=8, device="cpu", image_size=TINY_CLIP_IMG_SIZE)
    ids = np.asarray(Char97Tokenizer()("collect the coin."))
    want = direct.text_rewards(frames, ids)
    np.testing.assert_allclose(tengine.text_rewards(frames, ids), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jengine.text_rewards(frames, ids)), want, atol=1e-4)


def test_rollout_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The rollout phase end to end on the CPU at a tiny tower and CLIP width, few envs and steps: build_test_step
    sequential and in a wave, frozen_bf16 and frozen_int8, the clip_ft rollout, the card-vs-CPU comparison
    (the same device twice: equal).  What only the card can show (the kernels' launches, the profile) is left
    out."""
    import json

    from arp_tpu_torch.models import policy as policy_lib
    from arp_tpu_torch.models.clip import model as tclip_model
    from arp_tpu_torch.models.policy import flax_m3ae_to_torch
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import quantization, vit_infer

    tiny = dict(embed_dim=16, vocab_size=600, vision_num_layers=3, vision_features=64, vision_patch_size=16,
                text_features=16, text_num_heads=4, text_num_layers=2)
    monkeypatch.setitem(tclip_model.CONFIGS, "tiny_smoke", tiny)
    for name, value in dict(DEVICE="cpu", FT_CLIP="tiny_smoke", M3AE_DIMS=TINY_M3AE,
                            M3AE_CFG=dict(model_type=None, **TINY_M3AE), BERT_VOCAB=211, POLICY_WINDOW=2,
                            ROLLOUT_EPISODE_LEN=3, ROLLOUT_ENVS=2, ROLLOUT_SEQ_EPISODES=1, ROLLOUT_FT_STEPS=2,
                            ROLLOUT_PROFILE_STEPS=2, ROLLOUT_CPU_ENVS=2, ROLLOUT_CPU_STEPS=2).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(policy_lib.models, "BERT_VOCAB_SIZE", 211)
    monkeypatch.setattr(chip_smoke, "device_profile", lambda run: (run(), {"rehearsal": True})[1])
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    _, shapes = chip_smoke.phase_rollout(counters, chip_smoke.ft_weights(), policy_lib, flax_m3ae_to_torch)
    by_phase = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            record = json.loads(line)
            by_phase.setdefault(record["phase"], []).append(record)
    runs = {r["run"]: r for r in by_phase["rollout"]}
    assert list(runs) == ["a_sequential_frozen_bf16", "b_parallel_frozen_bf16", "b_parallel_frozen_int8",
                          "c_parallel_clip_ft_frozen_bf16"]
    assert runs["a_sequential_frozen_bf16"]["envs"] == 1 and runs["a_sequential_frozen_bf16"]["videos"] == 1
    assert runs["b_parallel_frozen_int8"]["env_steps"] == 2 * runs["b_parallel_frozen_int8"]["policy_calls"]
    for r in runs.values():
        assert r["rtg_min"] < r["rtg_first"] or r["rtg_max"] > r["rtg_first"]
        assert r["policy_ms_a_step"] > 0 and r["reward_ms_a_step"] > 0 and r["steps_per_s"] > 0
    assert runs["b_parallel_frozen_bf16"]["recipe"].startswith("torch;float32")
    assert runs["c_parallel_clip_ft_frozen_bf16"]["recipe"].startswith("torch;clip_ft;module;float32")
    compared = by_phase["rollout_vs_cpu"][0]
    assert compared["actions_differing_above_margin"] == 0 and compared["rtg_max_abs_err"] == 0.0
    assert compared["reward_max_abs_err"] <= 1e-5 and compared["reward_range"][0] < compared["reward_range"][1]
    assert compared["env_steps_above_margin"] + compared["env_steps_below_margin"] == 4 and compared["rtg_moved"] > 0
    assert compared["engine_batch"] == 64
    assert by_phase["profile"][0]["mode"] == "rollout_parallel_frozen_bf16"
    # the steps at the first and the full window held against the plain versions (on the CPU: the same)
    held = {r["run"]: r for r in by_phase["rollout_vs_plain"]}
    assert list(held) == ["b_parallel_frozen_bf16", "b_parallel_frozen_int8"]
    assert all(r["windows"] == [1, 2] and r["envs"] == 2 and r["min_env_cosine"] > 1 - 1e-9 for r in held.values())
    # the shapes noted over the metered runs: K2 only in the int8 wave (on the CPU attention never reaches K1's
    # wrapper), at every site, on each call's one new frame a env (the window cache gives the others back);
    # the bf16 runs' launches were not counted
    assert not shapes.k1 and by_phase["rollout_kernel_shapes"][0]["k2"] == dict(shapes.k2)
    tokens = 257  # 256 px frames in 16 px patches, and the CLS token
    sites = {(int(key.split()[0][2:]), key.split()[-1]) for key in shapes.k2}
    assert {m for m, _ in sites} == {2 * t for t in (tokens, tokens - 1)}
    assert {act for _, act in sites} == {"none", "gelu_tanh"}
    # the engine's ViT on a step's frames, at their own size: K1 holds the sequential run's, the card-vs-CPU
    # run's and a wave's
    import inspect

    assert 'cases[f"rollout_engine_vit_b{b}"] = (b, TOKENS,' in inspect.getsource(chip_smoke.phase_k1)


def test_reward_serve_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The reward_serve phase end to end on the CPU at a tiny CLIP width, few frames and clients: the host
    resize's bytes, the server over the three engines behind real HTTP with every wire format, the direct
    calls, the CPU comparisons (the same device twice: equal), host against pil, and the labeling run.  What
    only the card can show (the kernels' launches and shapes) is left out."""
    import json

    from arp_tpu_torch.models.clip import model as tclip_model
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import preprocess, quantization, vit_infer

    tiny = dict(embed_dim=16, vocab_size=49408, vision_num_layers=1, vision_features=64, vision_patch_size=16,
                text_features=16, text_num_heads=4, text_num_layers=1)
    monkeypatch.setitem(tclip_model.CONFIGS, "tiny_smoke", tiny)
    for name, value in dict(DEVICE="cpu", SERVE_CLIP="tiny_smoke", SERVE_IMAGE=32, SERVE_BATCH=8, BATCH=4,
                            SERVE_REQUEST_FRAMES=5, SERVE_FRAME=48, SERVE_CLIENTS=2, SERVE_LABEL_FRAMES=9,
                            SERVE_LABEL_SIZE=40).items():
        monkeypatch.setattr(chip_smoke, name, value)
    real_check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: real_check(ok or "launch" in what, what))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    launches, shapes = chip_smoke.phase_reward_serve(counters, preprocess)
    # on the CPU attention never reaches K1's wrapper; K2's takes its plain version, noted at the int8 engine's sites
    assert set(launches) == set(counters) and not shapes.k1
    # a request's 5 frames at their own size (final 5, conv1 20, the layers 25) and a goal's 1 frame (1, 4, 5)
    assert {key.split()[0] for key in shapes.k2} == {"m=1", "m=4", "m=5", "m=20", "m=25"}
    by_phase = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            record = json.loads(line)
            by_phase.setdefault(record["phase"], []).append(record)
    assert [r["frames"][1] for r in by_phase["host_resize"]] == [48, 40] and by_phase["arps"][0]["records"] == 12
    assert all(r["bytes_differing_from_reference"] == r["bytes_differing_from_card"] == 0 for r in by_phase["host_resize"])
    runs = {r["mode"]: r for r in by_phase["reward_serve"]}
    assert list(runs) == list(chip_smoke.SERVE_MODES)
    for mode, r in runs.items():
        assert r["requests"] == 2 * 9 and r["frames"] == 2 * 9 * 5 and r["health"]["frames_served"] == r["frames"]
        assert r["served_vs_direct_max_abs_err"] == 0.0 and r["reward_mae_vs_cpu"] == 0.0, mode
        assert set(r["latency_ms_median"]) == {"all"} | {f"{kind}_{fmt}" for kind in ("text", "goal")
                                                        for fmt in chip_smoke.SERVE_FORMATS}
        assert 0 < r["engine_busy_share"] <= 1 and r["requests_per_s"] > 0
    assert "resize=host" in runs["f32_host"]["recipe"] and runs["fast_int8"]["recipe"].startswith("torch;packed;int8")
    assert by_phase["reward_serve_host_vs_pil"][0] == {"phase": "reward_serve_host_vs_pil", "rewards_differing": 0,
                                                       "of": 2 * 9 * 5}
    labeled = {r["resize_mode"]: r for r in by_phase["label_host_vs_pil"]}
    assert set(labeled) == {"pil", "host"} and all(r["frames"] == 9 for r in labeled.values())


def test_reward_serve_cases_are_held_by_the_kernel_checks():
    """Every K2 site of the server's fast_int8 engine on a request of 16 frames (its own size under the batch of
    64), the timed serve sites, are shapes K2 takes, and phase_k2 holds them; the requests' wire formats are the
    server's routes."""
    import inspect
    import json

    for label, (m, k, n, dtype, act) in chip_smoke.K2_SERVE_SITES.items():
        assert m == 16 * 197 == 3_152 and k % 32 == 0 and n % 8 == 0, label
    k2 = inspect.getsource(chip_smoke.phase_k2)
    assert "for b in sorted({SERVE_REQUEST_FRAMES, SERVE_WARM_FRAMES, 1}):" in k2
    assert 'cases[f"reward_serve_{label}_b{b}"] = (m // BATCH * b,' in k2
    assert 'cases[f"reward_serve_vit_b{b}"] = (b, TOKENS,' in inspect.getsource(chip_smoke.phase_k1)
    path, body, headers = chip_smoke.reward_request("goal", "raw", np.zeros((2, 4, 4, 3), np.uint8),
                                                    goal=np.ones((4, 4, 3), np.uint8))
    assert path == "/v1/reward/goal_raw" and len(body) == 3 * 48 and headers["X-Goal-Shape"] == "4,4,3"
    path, body, headers = chip_smoke.reward_request("text", "b64", np.zeros((2, 4, 4, 3), np.uint8), text="a b")
    assert path == "/v1/reward/text" and json.loads(body)["frames_shape"] == [2, 4, 4, 3]


def test_reference_checkpoint_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The reference_checkpoint phase end to end on the CPU at a tiny tower width and batch: the export of the
    policy and its tower, the by-name and --load_checkpoint reads, action_pred against the in-memory model
    (the same device: equal), cost/flops with and without the plain kernels (equal), the train steps.  What
    only the card can show (a kernel's launches) is left out; $ARP_TPU_CHECKPOINT_DIR is restored."""
    import json
    import os

    from arp_tpu_torch.models import policy as policy_lib
    from arp_tpu_torch.models.policy import flax_m3ae_to_torch
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import quantization, vit_infer

    for name, value in dict(DEVICE="cpu", M3AE_DIMS=TINY_M3AE, M3AE_CFG=dict(model_type=None, **TINY_M3AE),
                            CPU_FRAMES=2, BERT_VOCAB=211, POLICY_BATCH=2, POLICY_WINDOW=2).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(policy_lib.models, "BERT_VOCAB_SIZE", 211)
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", "/nonexistent/towers")
    real_check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: real_check(ok or "launch" in what, what))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    totals, noted = chip_smoke.phase_reference_checkpoint(counters, policy_lib, flax_m3ae_to_torch)
    assert os.environ["ARP_TPU_CHECKPOINT_DIR"] == "/nonexistent/towers"
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    runs = [line for line in lines if line["phase"] == "reference_checkpoint"]
    assert [r["mode"] for r in runs] == ["frozen_bf16", "frozen_int8"]
    for r in runs:
        assert r["action_pred_max_abs_vs_in_memory"] == 0.0 and r["tower_equal"] and r["qpack_equal"]
        assert r["start_step"] == chip_smoke.REF_STEP and r["state_step"] == 0
        assert r["cost_flops"] == r["cost_flops_plain_kernels"] > 0 and r["step_ms"] > 0 and np.isfinite(r["loss"])
    assert runs[1]["cost_flops"] == runs[0]["cost_flops"]  # the int8 tower makes the bf16 tower's products
    phase = [line for line in lines if line["phase"] == "reference_checkpoint_phase"][0]
    assert phase["tower_bytes"] > 0 and phase["policy_bytes"] > 0 and phase["policy_read_s"] > 0
    # on the CPU attention never reaches K1's wrapper; K2's wrapper takes the int8 tower's sites, frames 2 x 2
    assert not noted.k1 and {int(k.split()[0][2:]) for k in noted.k2} == {4 * 256, 4 * 257}  # patches; tokens
    assert totals == dict.fromkeys(counters, 0)


def test_downsize_shapes_are_resize_cases():
    """phase_resize holds collect/downsize.py's 4x and 8x downscales, as the resize on the CPU gives them."""
    from arp_tpu_torch.ops import preprocess

    rng = np.random.default_rng(0)
    for size in (256, 512):
        frames = rng.integers(0, 256, size=(1, size, size, 3), dtype=np.uint8)
        got = preprocess.resize_bicubic_pil_packed(torch.from_numpy(frames.reshape(1, size, size * 3)), 3, 64, 64)
        want = preprocess.resize_bicubic_pil_reference(frames, 64, 64).reshape(1, 64, 64 * 3)
        assert np.array_equal(got.numpy(), want.astype(np.float32))


def test_ppg_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The ppg phase end to end on the CPU at a few envs and steps: the CLI's run on the native engine, timed by
    iteration and part, the minibatch steps, the card-vs-CPU iteration (the same device twice: equal) and the
    stand-in .jd expert's greedy actions.  The profile (only the card's) is left out."""
    import json

    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import quantization, vit_infer

    for name, value in dict(DEVICE="cpu", PPG_CPU_ENVS=2, PPG_CPU_STEPS=4, PPG_GREEDY_FRAMES=6, PPG_STEP_TIMED=1,
                            PPG_FLAGS=dict(chip_smoke.PPG_FLAGS, num_envs=2, segment_length=4)).items():
        monkeypatch.setattr(chip_smoke, name, value)
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    launches = chip_smoke.phase_ppg(counters)
    assert launches == dict.fromkeys(counters, 0)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    by_phase = {line["phase"]: line for line in lines}
    run = by_phase["ppg"]
    assert len(run["iterations"]) == 3 and set(run["iterations"][1]) == {"collect_s", "update_s", "aux_s",
                                                                         "env_steps_per_s"}
    assert "aux_s" not in run["iterations"][0] and run["frames_a_segment"] == 8 and run["pickle_bytes"] > 0
    assert by_phase["ppg_steps"]["ppo_minibatch"] == 2 and by_phase["ppg_steps"]["aux_minibatch"] == 4
    compared = by_phase["ppg_vs_cpu"]  # the same device twice: equal, free-running and forced
    assert compared["minibatches"] == 12 and len(compared["steps"]) == 12
    assert [s["phase"] for s in compared["steps"]] == ["vf"] * 8 + ["pi"] * 4
    for key in ("forced_loss_max_rel_err", "forced_grad_max_err_rel_to_max", "forced_param_max_err_rel_to_max",
                "free_loss_max_rel_err", "free_param_err_rel_to_max"):
        assert compared[key] == 0.0, key
    assert compared["card_relu_flips"] == 0 and compared["card_pool_moves"] == 0
    assert 0 < compared["f64_vs_cpu_param_err_rel_to_max"] < 1e-2
    assert by_phase["ppg_jd"]["greedy_differ_on_clear_margins"] == 0 and by_phase["ppg_jd"]["logits_max_abs_err"] == 0.0
    assert by_phase["ppg_jd"]["pool_padding"] == "torch"


def test_reference_ppg_state_dict_is_what_the_reference_loader_reads():
    """The stand-in .jd's names and dense column order: the port's converter gives back the same model."""
    from arp_tpu_torch.collect.convert_ppg import convert_torch_ppg_state_dict, flax_ppg_to_torch
    from arp_tpu_torch.collect.ppg import PhasicValueModel

    state = PhasicValueModel(frame_shape=(64, 64, 3)).state_dict()
    ref = {k: v.numpy() for k, v in chip_smoke.reference_ppg_state_dict(state).items()}
    assert "pi_enc.cnn.stacks.2.blocks.1.conv1.weight" in ref and "vf_vhead.bias" in ref and "aux_vf_head.bias" in ref
    back = flax_ppg_to_torch(convert_torch_ppg_state_dict(ref))
    assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)


def test_clip_resnet_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The clip_resnet phase on the CPU at a narrow ResNet (published depth pattern cut to one block a stage) and
    a few frames: the bridge from the random Flax-layout weights and statistics, labeling in float32 and bf16,
    the MAE checks; the launches (only the card's) are left out."""
    import json

    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import quantization, vit_infer

    tiny = {"resnet_50": dict(embed_dim=32, vocab_size=49408, vision_num_layers=(1, 1, 1, 1), vision_features=8,
                              text_features=32, text_num_heads=4, text_num_layers=1)}
    for name, value in dict(DEVICE="cpu", LABEL_FRAMES=6, LABEL_ROWS=np.array([0, 1, 5]), BATCH=4,
                            CPU_FRAMES=2).items():
        monkeypatch.setattr(chip_smoke, name, value)
    real_check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: real_check(ok or "K1" in what, what))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    totals, noted = chip_smoke.phase_clip_resnet(counters, ClipRewardEngine, CLIP, tiny, flax_to_torch, label_group)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    runs = [line for line in lines if line["phase"] == "clip_resnet"]
    assert [r["dtype"] for r in runs] == ["float32", "bfloat16"]
    # the same device, another batch (2 against 4): the CPU's convolutions sum in another order
    assert runs[0]["reward_mae_vs_cpu"] <= 1e-5 and runs[0]["frames"] == 6 and runs[0]["recipe"].startswith("torch;float32")
    assert runs[1]["reward_mae_vs_cpu"] <= runs[1]["mae_bound"]
    assert totals == dict.fromkeys(counters, 0) and not noted.k1  # on the CPU attention never reaches K1's wrapper


def test_resnet_random_weights_have_the_flax_layout():
    """random_clip_variables for a ResNet config: the Flax init's params and batch_stats, shape for shape."""
    from arp_tpu.models.clip.model import CONFIGS as FLAX_CONFIGS

    cfg = dict(FLAX_CONFIGS["resnet_50"], vision_features=8, embed_dim=32, text_features=32, text_num_heads=4,
               text_num_layers=1, vocab_size=97)
    want = jax.eval_shape(lambda: FlaxCLIP(**cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                       jnp.zeros((1, 77), jnp.int32)))
    got = chip_smoke.random_clip_variables(cfg, 64, 0)
    assert _shapes(got) == _shapes(want)
    assert set(got) == {"params", "batch_stats"}


def test_new_phases_and_their_path_kernels_are_pinned():
    """main runs the ppg, clip_resnet and pretrain_m3ae phases, counts their launches from 0, holds the ResNet and
    pretraining paths' K1 shapes, lets the PPG path launch none of the port's kernels and the pretraining path K1."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert 'path_launches["ppg"] = phase_ppg(counters)' in src
    assert 'path_launches["clip_resnet"], resnet_shapes = phase_clip_resnet(' in src
    assert '("clip_resnet", resnet_shapes)' in src
    assert '"ppg": ()' in src and '"clip_resnet": ("flash_attn_fwd",)' in src
    assert 'path_launches["pretrain_m3ae"], pretrain_shapes = phase_pretrain_m3ae(counters)' in src
    assert '("pretrain_m3ae", pretrain_shapes)' in src and '"pretrain_m3ae": ("flash_attn_fwd",)' in src
    assert chip_smoke.PPG_FLAGS == dict(vec_env="native", num_envs=64, segment_length=256, total_iterations=3, n_pi=2,
                                        arch="dual", reward_norm=True)
    assert chip_smoke.RESNET_CLIP == "resnet_50"
    # the ResNet text tower's K1 shape (one instruction at 77 tokens, 8 heads of 64) is one k1_check holds
    assert "slice_ft_text" in inspect.getsource(chip_smoke.phase_k1)


def test_rn50x64_text_tower_k1_shape_is_held():
    """The RN50x64 labeling cell's text tower launches K1 at one instruction of 77 tokens, 16 heads of 64,
    causal with key padding: a shape that k1_check holds against the plain version."""
    import inspect

    from arp_tpu_torch.models.clip import CONFIGS

    cfg = CONFIGS["resnet_50x64"]
    assert (cfg["text_num_heads"], cfg["text_features"] // cfg["text_num_heads"]) == (16, 64)
    src = inspect.getsource(chip_smoke.phase_k1)
    assert 'cases["rn50x64_text"] = (1, 77, 16, 64, MaskSpec("causal"), instruction_pad)' in src


@pytest.mark.parametrize("pool_padding", ["same", "torch"])
def test_impala_branches_replay_another_run_s_relus_and_pools(pool_padding):
    """ImpalaBranches: a replayed forward computes what the noting run computed, and counts where its own
    branches differ (here: none of the replay's; one flipped ReLU input after a nudge across 0)."""
    from arp_tpu_torch.models.impala import ImpalaCNN

    torch.manual_seed(0)
    cnn = ImpalaCNN(pool_padding=pool_padding)
    x = torch.rand(2, 16, 16, 3)
    with torch.no_grad():
        want = cnn(x)
    with chip_smoke.ImpalaBranches() as noted:
        noted.start_step()
        with torch.no_grad():
            assert torch.equal(cnn(x), want)
    assert len(noted.steps[0]) == 3 + 3 * 2 * 2 + 2  # 3 pools, 2 ReLUs a block, the flatten's and the dense's
    with chip_smoke.ImpalaBranches(replay=noted.steps) as replayed:
        replayed.start_step()
        with torch.no_grad():
            assert torch.equal(cnn(x), want)
    assert replayed.relu_flips == 0 and replayed.pool_moves == 0
    from arp_tpu_torch.models import impala

    assert impala.F is torch.nn.functional


def test_random_m3ae_autoencoder_weights_have_the_flax_layout():
    """With ``decoder`` the whole tree of Flax's ``__call__`` init, name for name and shape for shape, and a strict
    load into the port's autoencoder."""
    from arp_tpu.models import m3ae as jm3ae
    from arp_tpu_torch.models import m3ae as tm3ae
    from arp_tpu_torch.models.policy import flax_m3ae_to_torch

    cfg = dict(model_type=None, dec_emb_dim=16, dec_depth=1, dec_num_heads=2, **TINY_M3AE)
    model = jm3ae.MaskedMultimodalAutoencoder(config_updates=cfg, text_vocab_size=101)
    flax_vars = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                                                  jnp.zeros((1, 4, 768)), jnp.zeros((1, 5), jnp.int32),
                                                  jnp.zeros((1, 5)), deterministic=True))
    ours = chip_smoke.random_m3ae_variables(dict(cfg, dec_emb_dim=16, dec_depth=1), 16, 101, seed=0, decoder=True)
    assert _shapes(ours) == _shapes(flax_vars)
    port = tm3ae.MaskedMultimodalAutoencoder(cfg, text_vocab_size=101, decoder=True)
    port.load_state_dict(flax_m3ae_to_torch(ours, decoder=True))  # strict


def test_pretrain_cases_are_shapes_k1_takes_at_the_trainer_s_default_model():
    """The two K1 cases of the pretraining path: the encoder (64, 81, 12, 64) and the decoder at head_dim 32
    (64, 321, 16, 32), both padded, from the JAX trainer's default model and flags."""
    import inspect

    from arp_tpu.models import m3ae as jm3ae
    from arp_tpu_torch.ops.attention import _HEAD_DIMS
    from arp_tpu_torch.train import pretrain_m3ae as tpre

    jcfg = jm3ae.MaskedMultimodalAutoencoder.get_default_config()
    flags = tpre.flag_defaults()
    assert chip_smoke.PRETRAIN_MODEL is None and {k: flags["model"][k] for k in jcfg} == dict(jcfg)
    assert (chip_smoke.PRETRAIN_BATCH, chip_smoke.PRETRAIN_IMAGE, chip_smoke.PRETRAIN_PATCH, chip_smoke.PRETRAIN_TEXT) == (
        flags["batch_size"], flags["image_size"], flags["patch_size"], flags["text_length"])
    assert (chip_smoke.PRETRAIN_LR, chip_smoke.PRETRAIN_WD) == (flags["lr"], flags["weight_decay"])
    enc_n = 1 + int(chip_smoke.PRETRAIN_PATCHES * (1 - jcfg.image_mask_ratio)) + int(chip_smoke.PRETRAIN_TEXT * (1 - jcfg.text_mask_ratio))
    dec_n = 1 + chip_smoke.PRETRAIN_PATCHES + chip_smoke.PRETRAIN_TEXT
    assert (enc_n, jcfg.num_heads, jcfg.emb_dim // jcfg.num_heads) == (81, 12, 64)
    assert (dec_n, jcfg.dec_num_heads, jcfg.dec_emb_dim // jcfg.dec_num_heads) == (321, 16, 32)
    assert 32 in _HEAD_DIMS and 64 in _HEAD_DIMS
    src = inspect.getsource(chip_smoke.phase_k1)
    assert 'cases["pretrain_encoder"] = (b, enc_n, 12, 64, MaskSpec("none"), enc_pad)' in src
    assert 'cases["pretrain_decoder_d32"] = (b, dec_n, 16, 32, MaskSpec("none"), dec_pad)' in src
    assert '"pretrain_decoder_d32": (cases["pretrain_decoder_d32"], (torch.float32,))' in src


def test_pretrain_m3ae_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The pretrain_m3ae phase end to end on the CPU at a tiny autoencoder and batch: the bridge from the random
    Flax-layout weights, FramesWithText over the in-memory frames, the card-vs-CPU step (the same device twice:
    equal), the timed steps, ResNet18's train-mode forward against the CPU's (equal).  What only the card can show
    (K1's launches, the profile, the plain backward's time) is left out."""
    import json

    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import quantization, vit_infer

    for name, value in dict(DEVICE="cpu", PRETRAIN_MODEL=dict(model_type="custom", emb_dim=32, depth=2, num_heads=4,
                                                              dec_emb_dim=16, dec_depth=1, dec_num_heads=2, mlp_ratio=2),
                            PRETRAIN_BATCH=3, PRETRAIN_CPU_BATCH=2, PRETRAIN_IMAGE=32, PRETRAIN_PATCH=8,
                            PRETRAIN_PATCHES=16, PRETRAIN_KEPT_PATCHES=4, PRETRAIN_TEXT=16, PRETRAIN_WARMUP=1,
                            PRETRAIN_TIMED=2, RESNET_BATCH=2, RESNET_SIZE=32, RESNET_OUTPUTS=5).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "device_profile", lambda run: {"rehearsal": True})
    real_check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: real_check(ok or "launch" in what, what))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    launches, noted = chip_smoke.phase_pretrain_m3ae(counters)
    assert launches == dict.fromkeys(counters, 0) and not noted.k1  # on the CPU attention never reaches K1's wrapper
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    by_phase = {line["phase"]: line for line in lines}
    setup = by_phase["pretrain_m3ae_setup"]
    assert setup["config"]["emb_dim"] == 32 and setup["vocab"] == 30522 and setup["instruction_tokens"] > 0
    compared = by_phase["pretrain_m3ae_vs_cpu"]  # the same device twice: equal
    assert compared["batch"] == 2 and compared["loss_rel_err"] == 0.0 and compared["grad_err_rel_to_max"] == 0.0
    assert compared["param_max_abs_err"] == 0.0 and compared["param_entries"] > compared["param_entries_left_out"]
    run = by_phase["pretrain_m3ae"]
    assert run["batch"] == 3 and len(run["step_ms"]) == 2 and np.isfinite(run["loss"]) and run["learning_rate"] > 0
    assert run["flops_a_step"] > 0 and run["f32_peak_share"] > 0
    assert run["k1_plain_backward_share"] is None and run["peak_memory_bytes"] is None
    resnet = by_phase["resnet18_train_vs_cpu"]
    assert resnet["out_max_abs_err"] == 0.0 and resnet["batch_stats_max_abs_err"] == 0.0 and resnet["batch_stats_moved"]


def test_free_port_is_free_and_a_world_of_one_starts_on_it():
    """The distributed phase's start: a port nothing listens on, a process group of one over it (gloo on the
    CPU, NCCL on the card), its (1, 1, 1, 1) mesh over JAX's four axes."""
    import socket

    from arp_tpu_torch.parallel.distributed import initialize, shutdown
    from arp_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    port = chip_smoke.free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))  # free: binding succeeds
    assert initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=1, process_id=0, device="cpu") == (0, 1)
    try:
        assert torch.distributed.get_backend() == "gloo"
        mesh = create_mesh(MeshConfig(dp=1), "cpu")
        assert tuple(mesh.shape) == (1, 1, 1, 1) and mesh.mesh_dim_names == ("dp", "fsdp", "tp", "pp")
    finally:
        shutdown()
    assert not torch.distributed.is_initialized()


def test_max_rel_diff_is_each_tensor_s_relative_to_its_largest():
    want = {"a": torch.tensor([2.0, -4.0]), "b": torch.zeros(3), "c": torch.ones(0)}
    assert chip_smoke.max_rel_diff(want, want) == 0.0
    assert chip_smoke.max_rel_diff({"a": torch.tensor([2.0, -3.0]), "b": torch.zeros(3), "c": torch.ones(0)},
                                   want) == 0.25
    assert chip_smoke.max_rel_diff({"a": want["a"], "b": torch.tensor([0.0, 1e-3, 0.0]), "c": torch.ones(0)},
                                   want) == pytest.approx(1e-3)


def test_distributed_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The distributed phase end to end on the CPU at a tiny width over gloo: (a) the world of one, every
    wrapped step against its unwrapped one (the same values: equal), the FSDP2 checkpoint restored unwrapped;
    (b) two spawned ranks against one process within the phase's bound, which the two faults exceed.  What
    only the card can show (K1's and K2's launches, NCCL, peak memory) is left out."""
    import json

    from arp_tpu_torch.models.clip import model as tclip_model
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import quantization, vit_infer

    tiny = dict(embed_dim=16, vocab_size=600, vision_num_layers=2, vision_features=64, vision_patch_size=16,
                text_features=16, text_num_heads=4, text_num_layers=2)
    monkeypatch.setitem(tclip_model.CONFIGS, "tiny_smoke", tiny)
    for name, value in dict(DEVICE="cpu", M3AE_DIMS=TINY_M3AE, M3AE_CFG=dict(model_type=None, **TINY_M3AE),
                            CPU_FRAMES=2, POLICY_BATCH=4, POLICY_WINDOW=2, DIST_TIMED=1,
                            PRETRAIN_MODEL=dict(model_type="custom", emb_dim=32, depth=2, num_heads=4, dec_emb_dim=16,
                                                dec_depth=1, dec_num_heads=2, mlp_ratio=2),
                            PRETRAIN_BATCH=2, PRETRAIN_IMAGE=32, PRETRAIN_PATCH=8, PRETRAIN_TEXT=16,
                            FT_CLIP="tiny_smoke", FT_BATCH=2, FT_FRAME=40,
                            PPG_FLAGS=dict(chip_smoke.PPG_FLAGS, num_envs=2, segment_length=4)).items():
        monkeypatch.setattr(chip_smoke, name, value)
    real_check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: real_check(ok or "launch" in what, what))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    launches, noted = chip_smoke.phase_distributed(counters)
    # on the CPU nothing launches; attention never reaches K1's wrapper, and K2's takes its plain version at the
    # frozen_int8 tower's sites (M = 4 x 2 frames x 257 tokens)
    assert launches == dict.fromkeys(counters, 0) and not noted.k1 and noted.k2
    assert not torch.distributed.is_initialized()
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    parts = [line for line in lines if line["phase"] == "distributed"]
    assert parts[0]["part"] == "start" and parts[0]["backend"] == "gloo" and parts[0]["mesh"] == [1, 1, 1, 1]
    one = {p["mode"]: p for p in parts if p.get("part") == "world_of_one"}
    assert list(one) == ["float32", "frozen_int8", "pretrain_m3ae", "finetune", "ppg"]
    for mode in ("float32", "frozen_int8", "pretrain_m3ae"):
        for wrap in ("ddp", "fsdp"):
            assert one[mode][wrap]["max_rel_param_diff"] == 0.0
            assert one[mode][wrap]["losses"] == one[mode]["unwrapped"]["losses"]
    assert one["float32"]["fsdp"]["checkpoint_bit_equal"] and one["float32"]["ddp"]["ms"] > 0
    assert one["finetune"]["ddp"]["max_rel_param_diff"] == 0.0 and one["ppg"]["bit_equal"]
    two = [p for p in parts if p.get("part") == "two_gloo_ranks_one_card"][0]
    assert max(two["param_diff_rel_to_largest_move"]) <= chip_smoke.DIST_TWO_RANK_MOVE_REL and two["worst_tensor"]["name"]
    # the held figure sees a wrong average: a rank that skips the all-reduce, a step on half the batch
    assert set(two["faults_rel_to_largest_move"]) == {"no_all_reduce", "half_the_batch"}
    assert min(two["faults_rel_to_largest_move"].values()) > chip_smoke.DIST_TWO_RANK_MOVE_REL
    assert [r["rows"] for r in two["ranks"]] == [2, 2] and len(two["one_process"]["losses"]) == chip_smoke.DIST_STEPS
    assert not [p for p in parts if p.get("part") == "nccl_two_ranks_one_card"]  # the card's probe only


def test_distributed_phase_joins_the_path_launches_and_the_held_shapes():
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert 'path_launches["distributed"], dist_shapes = phase_distributed(counters)' in src
    assert '("distributed", dist_shapes)' in src
    assert "distributed" not in src.split("path_kernels = ")[1].split("}")[0]  # K1 and K2 both, as the train path


def test_mesh_tp_pp_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The mesh_tp_pp phase end to end on the CPU at a tiny width: (a) the engines over one share, two shares
    and a copying replica against the unmeshed engine (float32 within the bound, the int8 pack bit-equal);
    (b) tp 2 and pp 2 over two spawned gloo ranks against one process within the bound, which both faults
    exceed.  What only the card can show (launches, gloo's CUDA point to point) is left out."""
    import json

    from arp_tpu_torch.models.clip import CLIP, CONFIGS, flax_to_torch
    from arp_tpu_torch.models.clip import model as tclip_model
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import quantization, vit_infer
    from arp_tpu_torch.reward.engine import ClipRewardEngine

    tiny = dict(embed_dim=16, vocab_size=600, vision_num_layers=2, vision_features=64, vision_patch_size=16,
                text_features=16, text_num_heads=4, text_num_layers=2)
    monkeypatch.setitem(tclip_model.CONFIGS, "tiny_smoke", tiny)
    for name, value in dict(DEVICE="cpu", M3AE_DIMS=TINY_M3AE, M3AE_CFG=dict(model_type=None, **TINY_M3AE),
                            CPU_FRAMES=2, POLICY_BATCH=4, POLICY_WINDOW=2, MESH_CLIP="tiny_smoke", MESH_FRAMES=16,
                            BATCH=8, TP_PP_MICROBATCHES=2, TP_PP_TIMED=1).items():
        monkeypatch.setattr(chip_smoke, name, value)
    real_check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: real_check(ok or "launch" in what, what))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    launches, noted = chip_smoke.phase_mesh_tp_pp(counters, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch)
    # on the CPU nothing launches; K2's wrapper takes its plain version at the int8 engine's shares
    assert launches == dict.fromkeys(counters, 0) and not noted.k1 and noted.k2
    assert not torch.distributed.is_initialized()
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    parts = [line for line in lines if line["phase"] == "mesh_tp_pp"]
    engines = {p["mode"]: p for p in parts if p["part"] == "engine"}
    assert list(engines) == ["float32", "fast_int8", "int8_weights"]
    assert engines["float32"]["two_shares"]["replicas"] == 2 and engines["float32"]["mesh_of_one"]["replicas"] == 1
    assert engines["float32"]["replica_copy"]["devices"] == ["cpu", "cpu:0"]
    assert engines["fast_int8"]["two_shares"]["pack_bit_equal"] and engines["fast_int8"]["mesh_of_one"]["bit_equal"]
    two = [p for p in parts if p["part"] == "two_gloo_ranks_tp_pp"][0]
    for case in ("tp", "pp"):
        assert max(two[case]["param_diff_rel_to_largest_move"]) <= chip_smoke.DIST_TWO_RANK_MOVE_REL
        assert max(two[case]["loss_rel_err"]) <= chip_smoke.DIST_TWO_RANK_LOSS_REL and two[case]["ranks_equal"]
    for fault in ("tp_no_row_reduce", "pp_summed_cotangent"):
        assert min(two[fault]["param_diff_rel_to_largest_move"]) > chip_smoke.DIST_TWO_RANK_MOVE_REL
    assert [r["local_heads"] for r in two["tp"]["ranks"]] == [4, 4]
    assert [r["own_blocks"] for r in two["pp"]["ranks"]] == [["blocks_0"], ["blocks_1"]]
    assert not [p for p in parts if p["part"] == "gloo_p2p_cuda"]  # the card's probe only


def test_mesh_tp_pp_phase_joins_the_path_launches_and_the_held_shapes():
    """The phase's launches count on its path (K1, K2 and K3 all required), its shapes are held by k1_check /
    k2_check, and the tp / pp policy shapes and the engine share are k1_check cases."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert 'path_launches["mesh_tp_pp"], mesh_shapes = phase_mesh_tp_pp(' in src
    assert '("mesh_tp_pp", mesh_shapes)' in src
    assert '"mesh_tp_pp": ("flash_attn_fwd", "int8_gemm", "int8_matmul")' in src
    k1 = inspect.getsource(chip_smoke.phase_k1)
    for case in ("mesh_share_vit", "tp_policy_d16_dt_n12", "pp_policy_d16_dt_n12"):
        assert f'cases["{case}"]' in k1
    assert 'cases[f"mesh_share_{label}"]' in inspect.getsource(chip_smoke.phase_k2)


def test_mesh_tp_pp_path_launches_leave_the_faults_out():
    """The kernels line counts the tp and pp runs' K1 launches and holds their shapes; the fault runs are
    broken programs, not the path, and count nowhere."""
    def run(launches, shape):
        return {"k1_launches": launches, "k1_shapes": {shape: launches}, "k2_shapes": {}}

    ranks = [{"tp": run(3, "tp"), "tp_no_row_reduce": run(100, "tp_fault"), "pp": run(5, "pp"),
              "pp_summed_cotangent": run(1000, "pp_fault")} for _ in range(2)]
    got = chip_smoke.tp_pp_path_launches(ranks)
    assert got["k1_launches"] == 16
    assert dict(got["k1"]) == {"tp": 6, "pp": 10} and not got["k2"]


def test_drivers_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The drivers phase end to end on the CPU: the tensorstore line, the tiny reward CLIP's step against the CPU
    (the same device twice: equal), the timed steps, the spec's round trip and its rewards (equal).  What only the
    card can show (K1's launches and shapes) is left out."""
    import json

    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops import quantization, vit_infer

    for name, value in dict(DEVICE="cpu", DRIVERS_CLIP_BATCH=4, DRIVERS_WARMUP=1, DRIVERS_TIMED=2,
                            DRIVERS_REWARD_FRAMES=8, DRIVERS_ENGINE_BATCH=8).items():
        monkeypatch.setattr(chip_smoke, name, value)
    real_check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: real_check(ok or "launch" in what, what))
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}
    launches, noted = chip_smoke.phase_drivers(counters)
    assert launches == dict.fromkeys(counters, 0) and not noted.k1  # on the CPU attention never reaches K1's wrapper
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    parts = {line["part"]: line for line in lines if line["phase"] == "drivers"}
    assert list(parts) == ["tensorstore", "tiny_clip_vs_cpu", "tiny_clip"]
    assert parts["tensorstore"]["tensorstore"] is True and parts["tensorstore"]["version"]  # this box has it
    compared = parts["tiny_clip_vs_cpu"]
    assert compared["loss_rel_err"] == 0.0 and compared["grad_err_rel_to_max"] == 0.0
    assert compared["param_max_abs_err"] == 0.0 and compared["param_entries"] > compared["param_entries_left_out"]
    run = parts["tiny_clip"]
    assert run["batch"] == 4 and len(run["step_ms"]) == 2 and np.isfinite(run["loss"])
    assert run["spec_reward_mae_vs_cpu"] == 0.0 and run["spec_reward_frames"] == 8


def test_drivers_phase_joins_the_path_launches_and_its_shapes_are_k1_cases():
    """main counts the phase's launches on its own path (K1 required), holds its shapes with k1_check, and the
    kernels line carries a drivers column; the K1 cases are the tiny CLIP's shapes: 17 tokens of 2 heads of 64
    (32 px at patch 8, 128 wide) and 77 text tokens of 4 heads of 16, the four texts' padding."""
    import inspect

    from arp_tpu_torch.drivers import stub_benchmark as sb
    from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer

    src = inspect.getsource(chip_smoke.main)
    assert 'path_launches["drivers"], drivers_shapes = phase_drivers(counters)' in src
    assert '("drivers", drivers_shapes)' in src and '"drivers": ("flash_attn_fwd",)' in src
    assert "launches_by_path" in src and "for path, c in path_launches.items()" in src  # the column: every path
    assert chip_smoke.drivers_attention_dims() == ((17, 2, 64), (77, 4, 16))
    tokens = chip_smoke.drivers_tokens()
    np.testing.assert_array_equal(tokens, Char97Tokenizer()(sb.clip_texts("coinrun")))
    assert tokens.shape == (4, 77) and (tokens == 0).any(axis=1).all()  # every text padded
    k1 = inspect.getsource(chip_smoke.phase_k1)
    for case in ("drivers_clip_vit", "drivers_clip_text", "drivers_engine_vit", "drivers_engine_vit_rewards",
                 "drivers_engine_text"):
        assert f'cases["{case}"]' in k1
    for timed in ("drivers_clip_vit", "drivers_clip_text"):  # timed beside their bound, on the kernels line
        assert f'"{timed}": (cases["{timed}"], (torch.float32,))' in k1 and f'"{timed}_float32"' in src
    assert (chip_smoke.DRIVERS_CLIP_BATCH, chip_smoke.DRIVERS_CLIP_STEPS) == (sb.SMOKE["clip_batch"],
                                                                            sb.SMOKE["clip_steps"])
    assert (chip_smoke.DRIVERS_LOSS_REL, chip_smoke.DRIVERS_GRAD_REL, chip_smoke.DRIVERS_PARAM_ATOL) == (
        chip_smoke.PRETRAIN_LOSS_REL, chip_smoke.PRETRAIN_GRAD_REL, chip_smoke.PRETRAIN_PARAM_ATOL)
