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
