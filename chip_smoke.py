#!/usr/bin/env python3
"""Smoke run of the PyTorch port (arp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a machine with one GPU

Phases, each printing one JSON line:
  1. device  — requires CUDA; prints the card's name and power limit.
  2. build   — builds kernel K1 (arp_tpu_torch/csrc/flash_attn_fwd.cu) with nvcc.
  3. k1      — K1 against the plain attention on the card, float32 and bfloat16,
               over the slice's shapes, the masks, ragged N and a fully masked
               row; K1 and the plain version timed with CUDA events.
  4. resize  — the packed bit-exact resize on the card against the numpy
               fixed-point reference, byte for byte.
  5. slice   — reward labeling at full CLIP ViT-B/16 width (random weights from
               a seed, in arp_tpu's Flax layout, through the weight bridge) on an
               in-memory demo group, in float32 and bfloat16; K1 must have been
               launched; 8 rows recomputed by a CPU engine on the same weights.
               Then one more labeling pass per dtype under torch.profiler:
               device time by kernel kind and the device's idle share.
Then the kernel table and, last, ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

SEED = 0
K1_SOURCE = "arp_tpu_torch/csrc/flash_attn_fwd.cu"
K1_REPLACES = "arp_tpu/ops/attention.py:66"
# K1 against the plain version on the same inputs.  float32: both sum in fp32
# in different orders (online vs full-row softmax), measured ~1e-6 at N <= 257.
# bfloat16: the plain version runs on float32 upcasts of the same bf16 inputs,
# K1 rounds its output to bf16 (half an ulp is 2^-9 relative), measured ~8e-3.
K1_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Labeling rewards of the CUDA engine against the CPU engine on 8 rows.
# float32: BASELINE.json's reward-MAE target.  bfloat16: the JAX package's own
# bf16 engine bound (cosine MAE 0.05, tests/test_quantization.py:140) times
# logit_scale.
F32_REWARD_MAE = 1e-4
BF16_COS_MAE = 0.05
LOGIT_SCALE = 100.0  # exp(logit_scale) of trained CLIP


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def random_clip_variables(cfg: dict, image_size: int, seed: int) -> dict:
    """Random CLIP ViT weights in arp_tpu's Flax variable layout, from a numpy seed.

    Dense kernels ~ N(0, 1/fan_in), LayerNorm scales ~ 1, small biases and
    embeddings, and logit_scale = log(100) as in trained CLIP.
    """
    rng = np.random.default_rng(seed)
    normal = lambda shape, std: (std * rng.standard_normal(shape, dtype=np.float32))  # noqa: E731

    def dense(n_in, n_out, bias=True):
        d = {"kernel": normal((n_in, n_out), n_in ** -0.5)}
        if bias:
            d["bias"] = normal((n_out,), 0.02)
        return d

    def layer_norm(f):
        return {"scale": 1.0 + normal((f,), 0.02), "bias": normal((f,), 0.02)}

    def transformer(f, layers):
        blocks = {}
        for i in range(layers):
            blocks[f"resblocks.{i}"] = {
                "ln_1": layer_norm(f),
                "attn": {name: dense(f, f) for name in ("query", "key", "value", "out")},
                "ln_2": layer_norm(f),
                "mlp": {"c_fc": dense(f, 4 * f), "c_proj": dense(4 * f, f)},
            }
        return blocks

    fv, ft, e, p = cfg["vision_features"], cfg["text_features"], cfg["embed_dim"], cfg["vision_patch_size"]
    n_tokens = (image_size // p) ** 2 + 1
    visual = {
        "conv1": dense(p * p * 3, fv, bias=False),
        "class_embedding": normal((fv,), fv ** -0.5),
        "positional_embedding": normal((n_tokens, fv), fv ** -0.5),
        "ln_pre": layer_norm(fv),
        "transformer": transformer(fv, cfg["vision_num_layers"]),
        "ln_post": layer_norm(fv),
        "proj": dense(fv, e, bias=False),
    }
    text = {
        "token_embedding": {"embedding": normal((cfg["vocab_size"], ft), 0.02)},
        "positional_embedding": normal((77, ft), 0.01),
        "transformer": transformer(ft, cfg["text_num_layers"]),
        "ln_final": layer_norm(ft),
        "text_projection": dense(ft, e, bias=False),
    }
    return {"params": {"visual": visual, "text": text,
                       "logit_scale": np.asarray(np.log(LOGIT_SCALE), np.float32)}}


class MemoryDataset(np.ndarray):
    """An ndarray with an ``attrs`` dict, standing in for an h5py dataset."""

    def __new__(cls, data):
        ds = np.array(data).view(cls)
        ds.attrs = {}
        return ds


class MemoryGroup(dict):
    """The part of an h5py group the labeler uses, held in memory."""

    def create_dataset(self, key, data, **_storage_options):
        self[key] = MemoryDataset(data)
        return self[key]


def demo_group(n: int, num_frames: int, size: int, seed: int) -> MemoryGroup:
    """Demo group like the collect stage's: ob (n, F, size, size, 3) uint8, act, done (3 trajectories)."""
    rng = np.random.default_rng(seed)
    g = MemoryGroup()
    g.create_dataset("ob", rng.integers(0, 256, size=(n, num_frames, size, size, 3), dtype=np.uint8))
    g.create_dataset("act", rng.integers(0, 15, size=(n, num_frames)).astype(np.int64))
    done = np.zeros((n, num_frames), bool)
    done[n // 3 - 1, -1] = done[2 * n // 3 - 1, -1] = done[n - 1, -1] = True
    g.create_dataset("done", done)
    return g


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches, after a warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_kind(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "k1_attention"
    if any(tag in n for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    if "layer_norm" in n:
        return "layernorm"
    if "memcpy" in n:
        return "copy"
    return "elementwise"


def device_profile(run) -> dict:
    """Device time by kernel kind and the device's idle share over ``run()`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(bool(spans), "the profiler saw no device activity")
    kernel_ms = defaultdict(float)
    busy, (lo, hi) = 0.0, spans[0][:2]
    for start, end, name in spans:
        kernel_ms[kernel_kind(name)] += (end - start) / 1e3
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "kernel_ms": dict(kernel_ms)}


def phase_k1(attn, MaskSpec) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(b, n, h, d, dtype):
        return [torch.randn(b, n, h, d, generator=gen, device="cuda").to(dtype) for _ in range(3)]

    def pad_from_lengths(n, lengths):
        return torch.arange(n, device="cuda")[None, :] >= torch.tensor(lengths, device="cuda")[:, None]

    vit = (256, 197, 12, 64, MaskSpec("none"), None)
    text = (4, 77, 8, 64, MaskSpec("causal"), pad_from_lengths(77, [77, 12, 5, 40]))
    cases = {"vit_b16": vit, "text": text, "dt": (2, 96, 4, 64, MaskSpec("dt", 2, 4), None)}
    for n in (1, 65, 129, 257):
        cases[f"ragged_n{n}_causal"] = (2, n, 3, 64, MaskSpec("causal"), None)
        cases[f"ragged_n{n}_pad"] = (2, n, 3, 64, MaskSpec("none"), pad_from_lengths(n, [n, max(1, n // 3)]))
    dead = torch.zeros(2, 150, dtype=torch.bool, device="cuda")
    dead[0] = True  # every key of batch row 0 is padding
    for kind in ("none", "causal"):
        cases[f"fully_masked_{kind}"] = (2, 150, 2, 64, MaskSpec(kind), dead)
    cases["fully_masked_dt"] = (2, 150, 2, 64, MaskSpec("dt", 2, 4), dead)

    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for label, (b, n, h, d, spec, pad) in cases.items():
            q, k, v = inputs(b, n, h, d, dtype)
            got = attn.flash_attention_fwd(q, k, v, spec, pad)
            want = attn.reference_attention(q.float(), k.float(), v.float(), spec, pad)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == want.shape, f"K1 {label} {name}: {got.dtype} {got.shape}")
            errors[(label, dtype)] = (got.float() - want).abs().max().item()
    max_err = {str(dt).removeprefix("torch."): max(e for (_, d), e in errors.items() if d == dt)
               for dt in K1_ATOL}
    emit("k1_check", cases=len(cases), atol={str(k).removeprefix("torch."): v for k, v in K1_ATOL.items()},
         max_abs_err=max_err)
    for (label, dtype), err in errors.items():
        check(err <= K1_ATOL[dtype], f"K1 {label} {dtype}: max abs err {err} > {K1_ATOL[dtype]}")

    timings = {}
    for label, (b, n, h, d, spec, pad) in (("vit_b16", vit), ("text", text)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = inputs(b, n, h, d, dtype)
            kernel = lambda: attn.flash_attention_fwd(q, k, v, spec, pad)  # noqa: E731
            plain = lambda: attn.reference_attention(q, k, v, spec, pad)  # noqa: E731
            # interleaved: plain, kernel, kernel, plain
            p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
            name = str(dtype).removeprefix("torch.")
            timings[f"{label}_{name}"] = {"shape": [b, n, h, d], "mask": spec.kind,
                                          "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
    emit("k1_time", timings=timings)
    return {"max_abs_err": max_err, "timings": timings}


def phase_resize(preprocess) -> None:
    rng = np.random.default_rng(SEED)
    for size in (256, 64):
        frames = rng.integers(0, 256, size=(8, size, size, 3), dtype=np.uint8)
        packed = torch.from_numpy(frames.reshape(8, size, size * 3)).cuda()
        got = preprocess.resize_bicubic_pil_packed(packed, 3, 224, 224)
        want = preprocess.resize_bicubic_pil_reference(frames, 224, 224).reshape(8, 224, 224 * 3)
        got = got.cpu().numpy()
        check(np.array_equal(got, want.astype(np.float32)),
              f"resize {size}->224 on the card differs from the numpy reference "
              f"({int((got != want).sum())} bytes)")
        emit("resize", frames=[8, size, size, 3], out=[224, 224], byte_identical=True)


def phase_slice(attn, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch, label_group) -> int:
    cfg = CONFIGS["vit_b16"]
    t0 = time.perf_counter()
    variables = random_clip_variables(cfg, 224, SEED)
    state = flax_to_torch(variables)
    g_src = demo_group(512, 2, 256, SEED)
    text = "the goal is to collect the coin."
    emit("slice_setup", model="vit_b16", config=cfg, params=int(sum(t.numel() for t in state.values())),
         ob=list(g_src["ob"].shape), seconds=time.perf_counter() - t0)

    def engine(device, dtype, batch_size):
        model = CLIP(**cfg, image_size=224)
        model.load_state_dict(state)
        return ClipRewardEngine(model=model, batch_size=batch_size, compute_dtype=dtype, device=device)

    rows = np.array([0, 1, 169, 170, 300, 340, 341, 511])
    cpu = engine("cpu", torch.float32, 8)
    want = cpu.text_rewards(np.asarray(g_src["ob"][rows, -1]), text)
    check(np.isfinite(want).all(), "CPU engine rewards are not finite")

    launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        eng = engine("cuda", dtype, 256)
        g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
        eng.text_rewards(g["ob"][:256, -1], text)  # warm-up batch
        torch.cuda.synchronize()
        attn.flash_attention_fwd.launches = 0
        stats = label_group(g, text, eng, progress=False)
        run_launches = attn.flash_attention_fwd.launches

        reward, rtg = np.asarray(g["ob_clip_reward"]), np.asarray(g["ob_clip_pos_rtg"])
        mae = float(np.abs(reward[rows, -1] - want).mean())
        bound = F32_REWARD_MAE if dtype == torch.float32 else BF16_COS_MAE * eng.logit_scale
        emit("slice", dtype=name, frames=stats["frames"], seconds=stats["seconds"], fps=stats["fps"],
             batch_size=256, k1_launches=run_launches, reward_mae_vs_cpu=mae, mae_bound=bound,
             reward_max_abs_err_vs_cpu=float(np.abs(reward[rows, -1] - want).max()),
             reward_mean=float(reward[:, -1].mean()), reward_std=float(reward[:, -1].std()),
             recipe=eng.encode_recipe)
        check(run_launches > 0, f"labeling in {name} never launched K1")
        check(reward.shape == (512, 2) and rtg.shape == (512, 2), f"{name}: dataset shapes {reward.shape} {rtg.shape}")
        check(np.isfinite(reward).all() and np.isfinite(rtg).all(), f"{name}: non-finite rewards")
        check(g["ob_clip_reward"].attrs["encode_recipe"].startswith("torch;"), "encode_recipe lacks the torch; prefix")
        for lo, hi in ((0, 170), (170, 341), (341, 512)):
            r = reward[lo:hi, -1]
            check(np.allclose(rtg[lo:hi, -1], np.cumsum(r[::-1])[::-1], rtol=1e-4, atol=1e-3),
                  f"{name}: return-to-go of rows [{lo}, {hi}) is not the suffix sum of its rewards")
        check(mae <= bound, f"{name} reward MAE vs the CPU engine {mae} > {bound}")
        launches += run_launches
        g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
        emit("profile", dtype=name, frames=512,
             **device_profile(lambda: label_group(g, text, eng, progress=False)))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from arp_tpu_torch.models.clip import CLIP, CONFIGS, flax_to_torch
    from arp_tpu_torch.ops import _build, preprocess
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops.masks import MaskSpec
    from arp_tpu_torch.reward.engine import ClipRewardEngine
    from arp_tpu_torch.reward.labeler import label_group

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib, log = _build.build("flash_attn_fwd")
    attn.flash_attention_fwd.launches = 0
    emit("build", kernel="flash_attn_fwd", seconds=time.perf_counter() - t0, library=str(lib),
         ptxas=[line.strip() for line in log.splitlines() if "registers" in line or "spill" in line])

    k1 = phase_k1(attn, MaskSpec)
    phase_resize(preprocess)
    launches = phase_slice(attn, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch, label_group)

    vit = k1["timings"]["vit_b16_float32"]
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": k1["max_abs_err"]["float32"],
        "ms": vit["ms"], "plain_ms": vit["plain_ms"], "shape": vit["shape"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
