#!/usr/bin/env python3
"""Smoke run of the PyTorch port (arp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a machine with one GPU

Phases, each printing one JSON line:
  1. device  — requires CUDA; prints the card's name and power limit.
  2. build   — builds the three kernels from arp_tpu_torch/csrc with nvcc, one
               nvcc each, all started together: K1 (flash_attn_fwd.cu), K2
               (int8_gemm.cu), K3 (int8_matmul.cu); ptxas's register lines.
  3. k1      — K1 against the plain attention on the card, float32 and bfloat16,
               over the slice's shapes, the masks, ragged N and a fully masked
               row; K1, the plain version and one scaled_dot_product_attention
               call (the library yardstick) timed with CUDA events.
  4. k2      — K2 against its plain version at the six ViT-B/16 int8 sites at
               batch 256, ragged M, N and K, a strided and an offset x, no
               bias, values beyond the scale and round-half-to-even ties,
               within one bf16 ulp; K2, the plain version, a bf16 torch.matmul
               with the same epilogue and torch._int_mm (the product alone)
               timed, each site with its share of the bound and the bytes its
               route moves from L2 into shared memory.
  5. k3      — K3 against its plain version at the MLP and attention shapes at
               batch 256 in float32 and bf16, and a ragged M, N and K; K3, the
               plain version and one matmul on the dequantized weight timed.
  6. resize  — the packed bit-exact resize on the card against the numpy
               fixed-point reference, byte for byte: 256 and 64 -> 224 (CLIP's
               input) and 256 and 512 -> 64 (collect/downsize.py's).
  7. slice   — reward labeling at full CLIP ViT-B/16 width (random weights from
               a seed, in arp_tpu's Flax layout, through the weight bridge) on an
               in-memory demo group of 256 frames, in float32 and bfloat16; K1 must have been
               launched; 8 rows recomputed by a CPU engine on the same weights.
               Then one more labeling pass per dtype under torch.profiler:
               device time by kernel kind and the device's idle share.
  8. slice_fast — the same labeling through the packed and int8 engines: fast
               f32, fast bf16, fast_int8 with and without int8 attention, and
               quantize_weights f32.  Each engine's kernel launches (counts set
               to 0 just before its labeling run), its reward MAE against a CPU
               engine of the same mode on the 8 rows, and its mean feature
               cosine against the f32 standard engine; then one profiled
               labeling pass of each engine.
  9. m3ae    — the frozen M3AE tower of the policy at full width (768 / 12 layers /
               12 heads, patch 16 on 256 px: 257 tokens a frame; BERT vocabulary;
               random weights from a seed in the Flax layout, through the bridge) on
               512 frames: the module in float32 and in the frozen_bf16 recipe, the
               packed forward in float32 and bf16, the int8 forward with and without
               int8 attention (calibrated on the first 8 frames); image-only, with
               padded text, and goal-joint (513 tokens).  Each against the port's CPU
               run of the same mode on 8 frames; K1's and K2's launches a call.
 10. policy  — ARPDT at the flagship configuration (jobs/train_procgen.sh: vit_base,
               m3ae_vit_b16, adapter, window 4, 15 actions) at batch 128 x window 4,
               with float32 towers, frozen_bf16 and frozen_int8: action_pred against
               the CPU run of its first two sequences, K1 at head_dim 16 under the dt mask, ms
               a forward, and one profiled forward of each mode.
 11. train   — ARPDT train steps at the same configuration and batch, through the trainer's
               functions (train/common.py, parallel/step.py): random crop and color jitter
               on the card, the loss, the backward (K1 with its plain backward under the
               dt mask), the optax-exact AdamW update; float32, frozen_bf16 and frozen_int8
               towers.  In float32 first one step on the card and on the CPU from one
               state, batch and drawn augmentation (two sequences): loss, gradients and
               updated parameters.  Then per mode: ms a step (median of 5 after 2), frames/s,
               peak device memory, the step split into forward, backward and update, K1's
               and K2's launches a step, the plain attention backward's share, one profiled
               step; the frozen tower unchanged, every trained parameter moved.
 12. serve   — the policy server (frozen_int8, max_batch 8, window 4) behind its HTTP
               front on 127.0.0.1: warmup, 8 sessions x 6 /v1/act requests from 8
               client threads, every action against the direct greedy_action on that
               session's window, batching, a checkpoint save + /v1/reload, latencies.
 13. finetune — the ARP-DT+ fine-tuning step at the flagship configuration
               (arp_tpu/finetune/train.py: CLIP ViT-B/16, the adapter at its default widths,
               15 actions, AdamW at lr 1e-4 and weight decay 1e-4, VIP and inverse-dynamics
               losses) on 32 quadruples of 512 x 512 frames, through the CLI's functions:
               first one step of 4 quadruples on the card and on the CPU from the same
               weights and jitter draw (loss, gradients outside the rows of ReLU units that
               flipped, params after AdamW), then ms a step (median of 5 after 2), peak
               memory, the split into preprocessing, CLIP encodes and the rest, K1's
               launches, one profiled step.
 14. slice_ft — the clip_ft reward engine labeling the 256-frame demo group in four modes
               (module float32, packed with float32 scores, packed bf16, fast_int8): frames/s,
               launches, reward MAE against a CPU engine of the same mode; on fast_int8 the
               F2 measurement (the same calibrated trunk through K2 and through K2's plain
               version on the card).
 15. rollout — stage 5 at the flagship policy configuration through the trainer's
               build_test_step (vit_base ARPDT over the m3ae_vit_b16 tower, adapter, window 4,
               15 actions; vl_type clip with rewards from a CLIP ViT-B/16 engine spec of random
               weights, written as the JAX package's save_npz writes one): FakeProcgen at 64 x 64
               with episodes cut to 64 steps; (a) the sequential batch_rollout, 1 env x 2
               episodes, frozen_bf16; (b) one wave of 10 lockstep envs (num_test_episodes 10) in
               frozen_bf16 and frozen_int8; (c) 10 envs x 16 steps with the clip_ft engine on the
               finetune phase's adapter.  Each: steps/s, env-steps/s, ms a step split into policy,
               reward and env + transform, launches, the rtg trace (it must move).  Then one
               profiled window (10 envs x 8 steps) and (d) the card against the CPU: 4 envs x 6
               steps with float32 towers on both from one set of weights and seeds, the card
               following the CPU's actions; greedy actions equal wherever the CPU's top-2 logits
               are more than 1e-3 apart, rtg windows within 1e-4.
 16. reward_serve — the reward server (arp_tpu_torch/reward/serve.py) on 127.0.0.1 at full CLIP ViT-B/16
               width over engines at its batch of 64: float32 with resize_mode "pil", float32 with "host" (the
               C++ resize on the host), fast_int8 warmed (calibrated) on FakeProcgen frames.  4 client threads
               send text requests in the three wire formats (JSON lists, base64, raw bytes) and goal requests
               with and without a goal, 16 frames of 64 x 64 each: every served reward against the direct engine
               call (1e-6), each mode against a CPU engine of the same mode on 4 frames (float32 1e-4, int8
               0.05 x exp(logit_scale), both calibrated on the same frames), host against pil (equal), the host
               resize against the numpy reference and the card's resize (0 bytes); median latency per format,
               requests/s, frames/s, the engine's busy share from /v1/health; ARPS records written and read
               back through the native reader (zlib).  Then the labeling demo group
               with resize_mode "host" beside "pil": frames/s, equal rewards.  K1 and K2 shapes noted
               (LaunchShapes) and held by k1_check / k2_check, as the rollout's are.
 17. reference_checkpoint — the flagship ARPDT (the policy phase's configuration; 5 heads tied) written in
               the reference's format by save_reference_checkpoint, its M3AE tower as m3ae_base_params.pkl in
               a temporary $ARP_TPU_CHECKPOINT_DIR, and read back without flax: the tower by name, the policy
               through the trainer's --load_checkpoint code (train/main.py::start_from_reference_checkpoint),
               in frozen_bf16 and frozen_int8.  action_pred at 128 x 4 against the same model built from the
               weights in memory (equal, or within that model's own run-to-run spread), one cost/flops count
               with the kernels and with their plain versions (equal), two train steps timed; the pickles'
               sizes and write / read times; launches and shapes noted and held, as the rollout's are.
 18. ppg     — stage 1's PPG expert through train_ppg's CLI on the card: the port's C++ engine at 64 px,
               64 envs x 256 steps, arch dual, 4 minibatches, 6 aux epochs, reward normalization; cut to 3
               iterations with n_pi 2 (one aux phase).  Each iteration's collect / update / aux seconds and
               env-steps/s, peak memory, one profiled iteration (device only), ms a PPO and an aux minibatch
               step; one iteration's updates (separate phases, n_epoch_vf 2) on the card against the CPU from one
               params draw and one recorded segment, free-running and teacher-forced through the CPU's
               branches; a stand-in reference expert written as a .jd, its greedy actions on the card against
               the CPU's.  No kernel of the port runs here.
 19. clip_resnet — labeling the demo group with a ResNet-50 CLIP engine (random weights and BatchNorm
               statistics) in float32 and bf16 at batch 256: frames/s, reward MAE against a CPU engine on 8
               rows, one profiled pass; K1's launches (the text tower) and their shapes, held by k1_check.
 20. pretrain_m3ae — M3AE pretraining through train/pretrain_m3ae.py's functions at the JAX trainer's default
               model (base: 768 / 12 / 12, the decoder 512 / 8 / 16 at head_dim 32, the 30,522-token text head),
               batch 64 of 256 px uint8 frames with the tokenized instruction (FramesWithText over an in-memory
               stand-in of the dataset), random weights from numpy seed 0 in the Flax layout through the bridge:
               one step of 4 against the CPU's from one state, batch and masking draw (loss, gradients, params
               after clip + AdamW), then ms a step (median of 5 after 2), frames/s, peak memory, K1's launches and
               shapes (every attention through K1 forward, plain backward, with key padding: (64, 81, 12, 64) and
               (64, 321, 16, 32), both held by k1_check), the plain backward's share, one profiled step; then
               ResNet18 (models/resnet.py) in train mode at 64 x 64, batch 64, on the card against the CPU:
               outputs and updated batch_stats.
 21. distributed — training over several processes (arp_tpu_torch/parallel/): (a) a real NCCL world of one
               started in-process on a free port of 127.0.0.1: the train phase's flagship step (float32 and
               frozen_int8 towers, 128 x 4) unwrapped, wrapped by DistributedDataParallel and by FSDP2 over
               the (1, 1) mesh, three AdamW steps each from one state, batch and generator: params within 1e-6
               relative and the losses equal, ms a step and peak memory of each; the FSDP2 state saved whole
               and restored unwrapped, bit for bit; one pretraining step (base model with the decoder, K1 at
               head_dim 32) unwrapped, by DDP and by FSDP2; one fine-tuning step (32 quadruples, the VIP
               loss's inner mean over the group) unwrapped and by DDP; one PPG minibatch step with the
               gradients averaged over the group against the step without (bit for bit).  K1's and K2's
               launches counted from 0 in the wrapped runs, their shapes held by k1_check / k2_check.
               (b) two gloo ranks sharing the card (spawned processes on cuda:0, DDP, 64 of the 128 rows
               each, three clipped-SGD steps) against one process on the 128 rows: params within 1e-4 of
               one process's largest move, losses within 1e-5 relative, K1's launches in each rank; two
               faults run in one process (rank 0's rows alone, as a rank that skips the all-reduce, and
               half the batch) held above that bound; whether NCCL takes two ranks on one device.
 22. mesh_tp_pp — the rest of the parallel layer.  (a) The reward engines' local-device mesh
               (parallel/mesh.py::mesh_from_count, --mesh_dp) at full CLIP ViT-B/16 width, batch 256, on
               1,024 frames: the standard float32 engine with no mesh, mesh_from_count(-1) (the one card),
               two shares of 128 on cuda:0, and a replica that copies the weights (cuda:0 and "cuda");
               fast_int8 with no mesh, one card and two shares; quantize_weights float32 with no mesh and two
               shares.  float32 rewards against the unmeshed engine within 1e-5 relative / 1e-6 (and whether
               bit-equal); fast_int8's calibrated pack bit-equal, rewards within 0.05 x exp(logit_scale);
               frames/s of each; K1, K2 and K3 launches and shapes.  (b) The float32 flagship over two gloo
               ranks sharing the card, three clipped-SGD steps on the 128 rows, at tp 2 (4 heads a rank) and
               at pp 2 (one block a stage, 4 microbatches), each against one process: params within 1e-4 of
               one process's largest move, losses within 1e-5; a tp rank that skips the row-parallel
               all-reduce and a pipeline that sums the outputs' cotangent over pp read above that bound;
               every K1 shape the ranks launch held by k1_check; whether gloo takes CUDA tensors in send /
               recv.
 23. drivers — the device half of arp_tpu_torch/drivers (stub_benchmark's tiny reward CLIP; the drivers
               themselves read HDF5 and run only where h5py is): whether tensorstore imports (the reader of the
               JAX package's orbax directories); one training step of REWARD_CLIP_CFG at 32 px on the smoke batch
               of 32 with four texts on the card and on the CPU from one init and batch (loss 1e-5 relative,
               gradients 1e-4 of the largest, params after Adam 2e-5 outside the entries whose gradient is under
               1e-4 of the largest); ms a step (median of 5 after 2) with K1's launches and shapes (forward, the
               plain backward: vision and text causal + padding at head_dim 16, held by k1_check); the trained
               tower's save_npz -> from_npz and its rewards on 64 frames on the card against a CPU engine (1e-4).
Each timed shape of k1, k2 and k3 also carries ``bound_ms``: the least time the
card could take, the larger of the bytes the function must move over the memory
rate and its operations over the peak rate of their type (PEAK below).
Then the kernel table and, last, ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from collections import Counter, defaultdict

import numpy as np
import torch

SEED = 0
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "flash_attn_fwd": ("arp_tpu_torch/csrc/flash_attn_fwd.cu", "arp_tpu/ops/attention.py:66"),
    "int8_gemm": ("arp_tpu_torch/csrc/int8_gemm.cu", "arp_tpu/ops/vit_infer.py:341"),
    "int8_matmul": ("arp_tpu_torch/csrc/int8_matmul.cu", "arp_tpu/ops/quantization.py:38"),
}
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
# The int8 engines on the card against the CPU engine of the same mode, both
# calibrated on the same 8 frames: they run the same int8 arithmetic, and the
# bf16 roundings that differ between cuBLAS and the CPU (the bf16 bound's
# cause) move some activations across an int8 rounding edge, one step each.
# So the bound is the bf16 one.
INT8_COS_MAE = 0.05
LOGIT_SCALE = 100.0  # exp(logit_scale) of trained CLIP
# Mean feature cosine against the f32 standard engine on the card: the JAX
# package's own bounds (tests/test_vit_infer.py:59, :82, :102;
# tests/test_quantization.py:80).
MIN_COSINE = {"fast_f32": 0.995, "fast_bf16": 0.995, "fast_int8": 0.97, "fast_int8_bf16_attn": 0.98,
              "quantize_weights_f32": 0.99}
# K3 against its plain version, relative to the largest output: both sum K
# exact products in float32 in other orders (K3 scales the sum, the plain
# version every weight; the tensor cores' float32 adds may truncate where an
# FMA rounds), ~K * 2^-24 of it at worst, held to 1e-4; with bf16 x, add one
# bf16 rounding of the largest output (2^-7): an output near zero can round
# to another bf16 value by many of its own ulps.
K3_F32_REL = 1e-4
K3_BF16_REL = K3_F32_REL + 2.0 ** -7
BATCH = 256
TOKENS = 197  # ViT-B/16 at 224 px: 196 patches + CLS
LABEL_FRAMES = 256  # the labeling phases' demo group: one batch (three trajectories)
LABEL_ROWS = np.array([0, 1, 84, 85, 150, 169, 170, 255])  # recomputed by a CPU engine: the trajectories' ends too
# The policy path: M3AE base at patch 16 on 256 px, BERT vocabulary, 512 frames a forward
M3AE_DIMS = dict(emb_dim=768, depth=12, num_heads=12, mlp_ratio=4)  # M3AE base
M3AE_CFG = dict(model_type=None, **M3AE_DIMS)
M3AE_TOKENS = 257
M3AE_FRAMES = 512
TEXT_LEN = 16
BERT_VOCAB = 30522
CPU_FRAMES = 8  # what the CPU run of a mode recomputes
# The tower and the policy on the card against the port's CPU run of the same mode.
# float32: both sum in float32 in other orders through 12 layers.  The others by cosine,
# with the JAX package's own bounds for each recipe against float32
# (tests/test_frozen_bf16.py:143; tests/test_m3ae_infer.py:120, :152, :179; tests/test_frozen_bf16.py:195;
# tests/test_frozen_int8.py:106): the card rounds bf16 where the CPU does not (K1's
# softmax is float32 whatever score_dtype says), and that moves int8 values one step.
F32_ATOL = 1e-4
TOWER_MIN_COSINE = {"module_bf16": 0.99, "packed_bf16": 0.995, "int8": 0.98, "int8_attn": 0.97}
POLICY_MIN_COSINE = {"frozen_bf16": 0.98, "frozen_int8": 0.95}
# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA's data sheet,
# dense rates): device memory in bytes/s, operations/s by operand type.
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time for ``nbytes`` moved once and ``ops`` operations of type ``kind``, in ms."""
    by_bytes, by_ops = nbytes / PEAK["bytes"] * 1e3, ops / PEAK[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_ms": by_bytes, "operations_ms": by_ops, "operations_at": kind}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def random_clip_variables(cfg: dict, image_size: int, seed: int) -> dict:
    """Random CLIP weights in arp_tpu's Flax variable layout, from a numpy seed.

    Dense kernels ~ N(0, 1/fan_in), LayerNorm scales ~ 1, small biases and
    embeddings, and logit_scale = log(100) as in trained CLIP.  A ResNet config
    (``vision_num_layers`` a tuple) gets the ModifiedResNet tower of
    :func:`random_resnet_visual` and its ``batch_stats``.
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

    ft, e = cfg["text_features"], cfg["embed_dim"]
    stats = None
    if isinstance(cfg["vision_num_layers"], tuple):
        visual, stats = random_resnet_visual(cfg, image_size, normal, dense, rng)
    else:
        fv, p = cfg["vision_features"], cfg["vision_patch_size"]
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
    variables = {"params": {"visual": visual, "text": text,
                            "logit_scale": np.asarray(np.log(LOGIT_SCALE), np.float32)}}
    if stats is not None:
        variables["batch_stats"] = {"visual": stats}
    return variables


def random_resnet_visual(cfg: dict, image_size: int, normal, dense, rng) -> tuple[dict, dict]:
    """The ModifiedResNet tower's params and BatchNorm statistics in the Flax layout: convolutions
    ~ N(0, 1/fan_in) (HWIO), BatchNorm scales ~ 1 (each block's last one ~ 0.25, so that 16 residual
    sums stay near unit scale), small biases and running means, running variances
    in [0.5, 1.5], the attention pool's projections as Dense."""
    params, stats = {}, {}

    def conv(name, k, c_in, c_out, node):
        node[name] = {"kernel": normal((k, k, c_in, c_out), (k * k * c_in) ** -0.5)}

    def bn(name, c, node, stat_node, scale=1.0):
        node[name] = {"scale": scale * (1.0 + normal((c,), 0.02)), "bias": normal((c,), 0.02)}
        stat_node[name] = {"mean": normal((c,), 0.02), "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}

    w = cfg["vision_features"]
    for i, (c_in, c_out) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), start=1):
        conv(f"conv{i}", 3, c_in, c_out, params)
        bn(f"bn{i}", c_out, params, stats)
    c_in = w
    for stage, n_blocks in enumerate(cfg["vision_num_layers"], start=1):
        f = w * 2 ** (stage - 1)
        for j in range(n_blocks):
            block, block_stats = {}, {}
            conv("conv1", 1, c_in, f, block)
            bn("bn1", f, block, block_stats)
            conv("conv2", 3, f, f, block)
            bn("bn2", f, block, block_stats)
            conv("conv3", 1, f, 4 * f, block)
            bn("bn3", 4 * f, block, block_stats, scale=0.25)
            if j == 0:  # stride 2 (stages 2-4) or a wider output: the shortcut's projection
                conv("downsample.0", 1, c_in, 4 * f, block)
                bn("downsample.1", 4 * f, block, block_stats)
            params[f"layer{stage}.{j}"], stats[f"layer{stage}.{j}"] = block, block_stats
            c_in = 4 * f
    params["attnpool"] = {"positional_embedding": normal(((image_size // 32) ** 2 + 1, c_in), c_in ** -0.5),
                          **{name: dense(c_in, c_in) for name in ("query", "key", "value")},
                          "out": dense(c_in, cfg["embed_dim"])}
    return params, stats


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


def ptxas_faults(log: str) -> list:
    """ptxas's lines that a kernel of the port must not have: serialized wgmma
    (C7515), an ignored setmaxnreg (C7508), registers spilled to local memory."""
    return [line.strip() for line in log.splitlines()
            if "C7515" in line or "C7508" in line or re.search(r"\b[1-9]\d* bytes spill", line)]


def kernel_kind(name: str) -> str:
    n = name.lower()
    if "multi_tensor_apply" in n or "foreach" in n:
        return "optimizer"
    if "flash_fwd" in n:
        return "k1_attention"
    if "int8_gemm_kernel" in n:
        return "k2_int8_gemm"
    if "int8_matmul_kernel" in n:
        return "k3_int8_matmul"
    if any(tag in n for tag in ("convolve", "conv2d", "fprop", "dgrad", "wgrad", "winograd", "implicit_gemm")):
        return "convolution"
    if any(tag in n for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    if "layer_norm" in n:
        return "layernorm"
    if "memcpy" in n:
        return "copy"
    return "elementwise"


def device_profile(run) -> dict:
    """Device time by kernel kind and of the eight longest kernels, and the idle share, over ``run()``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary(prof, wall_us)


def profile_summary(prof, wall_us: float) -> dict:
    """What :func:`device_profile` reports, from a finished ``torch.profiler`` run over ``wall_us``."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(bool(spans), "the profiler saw no device activity")
    kernel_ms, by_name = defaultdict(float), defaultdict(float)
    busy, (lo, hi) = 0.0, spans[0][:2]
    for start, end, name in spans:
        kernel_ms[kernel_kind(name)] += (end - start) / 1e3
        by_name[name[:120]] += (end - start) / 1e3
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "kernel_ms": dict(kernel_ms), "top_kernels_ms": dict(largest)}


def phase_k1(attn, MaskSpec, materialize_mask) -> dict:
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
    # the policy blocks (128 wide, 8 heads: head_dim 16) while a session's window grows 1 -> 4,
    # ARPDT's three tokens a step: ragged, tiny, under one tile
    for n in (3, 6, 9, 12):
        cases[f"policy_d16_dt_n{n}"] = (128, n, 8, 16, MaskSpec("dt", 1, 3), None)
        cases[f"policy_d16_causal_n{n}"] = (128, n, 8, 16, MaskSpec("causal"), None)
    # the M3AE tower at the 512 frames the policy path sends: image-only, image + 16 text tokens
    # (padded keys, every text length 0..16; row 0's text is padding throughout), goal-joint
    text_pad = torch.zeros(M3AE_FRAMES, M3AE_TOKENS + TEXT_LEN, dtype=torch.bool, device="cuda")
    text_pad[:, M3AE_TOKENS:] = pad_from_lengths(TEXT_LEN, [i % (TEXT_LEN + 1) for i in range(M3AE_FRAMES)])
    cases["m3ae_n257"] = (M3AE_FRAMES, M3AE_TOKENS, 12, 64, MaskSpec("none"), None)
    cases["m3ae_text_n273_pad"] = (M3AE_FRAMES, M3AE_TOKENS + TEXT_LEN, 12, 64, MaskSpec("none"), text_pad)
    cases["m3ae_goal_n513"] = (M3AE_FRAMES, 2 * M3AE_TOKENS - 1, 12, 64, MaskSpec("none"), None)
    # ARP-DT+: a fine-tuning step's vision call (three images a quadruple) and text call (the
    # instruction's tokens, padded), and the clip_ft engine's one text
    instruction_pad = torch.from_numpy(ft_tokens() == 0).to("cuda")
    cases["finetune_vit"] = (3 * FT_BATCH, TOKENS, 12, 64, MaskSpec("none"), None)
    cases["finetune_text"] = (FT_BATCH, 77, 8, 64, MaskSpec("causal"),
                              instruction_pad.expand(FT_BATCH, 77).contiguous())
    cases["slice_ft_text"] = (1, 77, 8, 64, MaskSpec("causal"), instruction_pad)
    # the rollout: the tower at B * w frames while the window fills (w = 1..4; B = 1 sequential, the
    # card-vs-CPU run's envs, a wave's), the policy blocks at those batches, the reward engine's ViT at
    # build_test_step's batch (the text is slice_ft_text's)
    for b in sorted({1, ROLLOUT_CPU_ENVS, ROLLOUT_ENVS}):
        for w in range(1, POLICY_WINDOW + 1):
            cases[f"rollout_tower_b{b * w}"] = (b * w, M3AE_TOKENS, 12, 64, MaskSpec("none"), None)
            cases[f"rollout_policy_b{b}_n{3 * w}"] = (b, 3 * w, 8, 16, MaskSpec("dt", 1, 3), None)
    cases["rollout_engine_vit"] = (ROLLOUT_ENGINE_BATCH, TOKENS, 12, 64, MaskSpec("none"), None)
    # the reward server: its engine's ViT at (SERVE_BATCH, 197), float32 and (calibrating fast_int8) bf16, and
    # the text tower at one instruction (slice_ft_text's shape) or a list of two
    cases["reward_serve_vit"] = (SERVE_BATCH, TOKENS, 12, 64, MaskSpec("none"), None)
    cases["reward_serve_text_b2"] = (2, 77, 8, 64, MaskSpec("causal"), pad_from_lengths(77, [12, 9]))
    # M3AE pretraining at batch 64 (the JAX trainer's default model): the encoder over cls + 64 kept patches + 16
    # kept text tokens, the decoder at head_dim 32 over cls + 256 patches + 64 text tokens; the keys padded where
    # the (kept) text is, every text length from 0 up
    b, kept_text = PRETRAIN_BATCH, PRETRAIN_TEXT // 4
    enc_n, dec_n = 1 + PRETRAIN_KEPT_PATCHES + kept_text, 1 + PRETRAIN_PATCHES + PRETRAIN_TEXT
    enc_pad = torch.zeros(b, enc_n, dtype=torch.bool, device="cuda")
    enc_pad[:, enc_n - kept_text:] = pad_from_lengths(kept_text, [i % (kept_text + 1) for i in range(b)])
    dec_pad = torch.zeros(b, dec_n, dtype=torch.bool, device="cuda")
    dec_pad[:, dec_n - PRETRAIN_TEXT:] = pad_from_lengths(PRETRAIN_TEXT, [i % (PRETRAIN_TEXT + 1) for i in range(b)])
    cases["pretrain_encoder"] = (b, enc_n, 12, 64, MaskSpec("none"), enc_pad)
    cases["pretrain_decoder_d32"] = (b, dec_n, 16, 32, MaskSpec("none"), dec_pad)
    # mesh_tp_pp: an engine share of 128 frames; the policy blocks at tp 2 (4 heads a rank) and at pp 2 (a
    # microbatch of 32)
    cases["mesh_share_vit"] = (BATCH // 2, TOKENS, 12, 64, MaskSpec("none"), None)
    cases["tp_policy_d16_dt_n12"] = (POLICY_BATCH, 3 * POLICY_WINDOW, 8 // 2, 16, MaskSpec("dt", 1, 3), None)
    cases["pp_policy_d16_dt_n12"] = (POLICY_BATCH // TP_PP_MICROBATCHES, 3 * POLICY_WINDOW, 8, 16,
                                     MaskSpec("dt", 1, 3), None)
    # the drivers: stub_benchmark's tiny reward CLIP, its training step (vision, and text causal + padding at
    # head_dim 16, under a gradient) and its engine at the driver's batch (one instruction)
    (vit_n, vit_h, vit_d), (_, text_h, text_d) = drivers_attention_dims()
    drivers_pad = torch.from_numpy(drivers_tokens() == 0).to("cuda")
    cases["drivers_clip_vit"] = (DRIVERS_CLIP_BATCH, vit_n, vit_h, vit_d, MaskSpec("none"), None)
    cases["drivers_clip_text"] = (len(drivers_pad), 77, text_h, text_d, MaskSpec("causal"), drivers_pad)
    cases["drivers_engine_vit"] = (DRIVERS_ENGINE_BATCH, vit_n, vit_h, vit_d, MaskSpec("none"), None)
    cases["drivers_engine_text"] = (1, 77, text_h, text_d, MaskSpec("causal"), drivers_pad[:1])

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
            del q, k, v, got, want
    max_err = {str(dt).removeprefix("torch."): max(e for (_, d), e in errors.items() if d == dt)
               for dt in K1_ATOL}
    emit("k1_check", cases=len(cases), atol={str(k).removeprefix("torch."): v for k, v in K1_ATOL.items()},
         max_abs_err=max_err)
    for (label, dtype), err in errors.items():
        check(err <= K1_ATOL[dtype], f"K1 {label} {dtype}: max abs err {err} > {K1_ATOL[dtype]}")

    timings = {}  # every timed shape is one of the checked cases
    timed = {"vit_b16": (vit, K1_ATOL), "text": (text, K1_ATOL), "m3ae_n257": (cases["m3ae_n257"], K1_ATOL),
             "m3ae_goal_n513": (cases["m3ae_goal_n513"], (torch.bfloat16,)),
             "policy_d16_dt_n12": (cases["policy_d16_dt_n12"], K1_ATOL),
             "finetune_vit": (cases["finetune_vit"], (torch.float32,)),
             "finetune_text": (cases["finetune_text"], (torch.float32,)),
             "pretrain_encoder": (cases["pretrain_encoder"], (torch.float32,)),
             "pretrain_decoder_d32": (cases["pretrain_decoder_d32"], (torch.float32,)),
             "drivers_clip_vit": (cases["drivers_clip_vit"], (torch.float32,)),
             "drivers_clip_text": (cases["drivers_clip_text"], (torch.float32,))}
    for label, ((b, n, h, d, spec, pad), dtypes) in timed.items():
        # what this mask lets through: the products and exponentials that must be made
        allowed = materialize_mask(spec, n, device="cuda")[None].expand(b, n, n)
        if pad is not None:
            allowed = allowed & ~pad[:, None, :]
        pairs = int(allowed.sum().item()) * h
        sdpa_mask = None if spec.kind == "none" and pad is None else allowed[:, None]
        for dtype in dtypes:
            q, k, v = inputs(b, n, h, d, dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, N, D) views
            # the library yardstick; timed here, used nowhere in the port
            t = interleaved_ms(
                plain=lambda: attn.reference_attention(q, k, v, spec, pad),
                kernel=lambda: attn.flash_attention_fwd(q, k, v, spec, pad),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask))
            name = str(dtype).removeprefix("torch.")
            # q, k, v read once, o written once; 2 D flops a pair for q k^T and 2 D for p v.
            # float32 inputs need float32 products (K1_ATOL): the SIMT peak.
            timings[f"{label}_{name}"] = {
                "shape": [b, n, h, d], "mask": spec.kind, "ms": t["kernel"], "plain_ms": t["plain"],
                "library_ms": t["library"], "library": "scaled_dot_product_attention",
                **bound(4 * q.numel() * q.element_size(), 4 * d * pairs, "bf16" if dtype == torch.bfloat16 else "f32")}
    emit("k1_time", timings=timings)
    checked = {k1_key(b, n, h, d, spec, pad is not None, dtype)
               for b, n, h, d, spec, pad in cases.values() for dtype in K1_ATOL}
    return {"max_abs_err": max_err, "timings": timings, "checked": checked}


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """Largest |got - want| in units of the bf16 ulp of the larger of the two, the unit no smaller than ``floor``."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), (exp - 8).clamp(min=-133))  # 8 significant bits
    return ((got - want).abs() / ulp.clamp(min=floor)).max().item()


# The tanh-GELU below v = -4: 0.5 v (1 + tanh) with 1 + tanh a few multiples of 2^-24, so a
# tanh argument that differs in its last bit (the plain version's own kernel may contract an
# FMA) moves the result by 0.5 |v| 2^-24 <= 2^-22, many bf16 ulps of so small a number.
# There the unit of K2's one-ulp bound is 2^-20 instead.
TANH_GELU_TAIL_UNIT = 2.0 ** -20


def interleaved_ms(**fns) -> dict:
    """Each fn timed twice, in the order a, b, ..., ..., b, a; the mean of its two runs."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(cuda_ms(fns[n]))
    return {n: sum(t) / 2 for n, t in times.items()}


# K2's sites on the int8 path at batch 256: label -> (M, K, N, x dtype, act)
K2_SITES = {
    "conv1": (BATCH * (TOKENS - 1), 768, 768, torch.float32, "none"),
    "qkv": (BATCH * TOKENS, 768, 2304, torch.bfloat16, "none"),
    "attn_out": (BATCH * TOKENS, 768, 768, torch.bfloat16, "none"),
    "fc": (BATCH * TOKENS, 768, 3072, torch.bfloat16, "quickgelu"),
    "proj": (BATCH * TOKENS, 3072, 768, torch.bfloat16, "none"),
    "final": (BATCH, 768, 512, torch.bfloat16, "none"),
}


# K2's sites in the M3AE tower at 512 frames (M = 512 * 257): the image embedding reads float32
# patches, the fc site has the tanh-GELU epilogue; each also checked with the other epilogue
M3AE_M = M3AE_FRAMES * M3AE_TOKENS
K2_M3AE_SITES = {
    "m3ae_img": (M3AE_FRAMES * (M3AE_TOKENS - 1), 768, 768, torch.float32, "none"),
    "m3ae_qkv": (M3AE_M, 768, 2304, torch.bfloat16, "none"),
    "m3ae_attn_out": (M3AE_M, 768, 768, torch.bfloat16, "none"),
    "m3ae_fc": (M3AE_M, 768, 3072, torch.bfloat16, "gelu_tanh"),
    "m3ae_proj": (M3AE_M, 3072, 768, torch.bfloat16, "none"),
}


# K2's sites under the reward server's fast_int8 engine at its batch of 64 (reward/serve.py): M = 64 * 197
SERVE_BATCH = 64
K2_SERVE_SITES = {f"serve_{label}": (SERVE_BATCH * TOKENS, k, n, dtype, act)
                  for label, (_, k, n, dtype, act) in K2_SITES.items() if label in ("qkv", "attn_out", "fc", "proj")}


def k2_inputs(m, k, n, dtype, gen, quant, layout="dense", margin=1.05):
    """x (m, k), its scale, the int8 weight with scales, a bias, the (n, k) weight.

    ``layout``: "dense"; "strided", a column slice of a wider tensor (row
    stride k + 64); "offset", a base 16 but not 128 bytes aligned.
    ``margin`` < 1 puts values beyond the scale, so that the clamp works.
    """
    if layout == "strided":
        x = torch.randn(m, k + 64, generator=gen, device=gen.device).to(dtype)[:, 32:32 + k]
    elif layout == "offset":
        flat = torch.randn(m * k + 64, generator=gen, device=gen.device).to(dtype)
        x = flat[16 // flat.element_size():][:m * k].view(m, k)
    else:
        x = torch.randn(m, k, generator=gen, device=gen.device).to(dtype)
    w = torch.randn(k, n, generator=gen, device=gen.device) * k ** -0.5
    wq, ws = quant.quantize_array(w)
    bias = 0.02 * torch.randn(n, generator=gen, device=gen.device)
    a = x.float().abs().amax() * margin  # 1.05: as calibrate_vit + quantize_packed's margin
    return x, a, wq, ws, bias, wq.t().contiguous()


# K2 beyond the sites: label -> (M, K, N, x dtype, act, layout, margin, bias).  Shapes that
# break a tiled design: M, N and K off the 128 x 256 x 64 tiles, one tile, one row.
K2_RAGGED = {
    "m1_k32_n8": (1, 32, 8, torch.bfloat16, "none", "dense", 1.05, True),
    "m63_k96_n264": (63, 96, 264, torch.float32, "quickgelu", "dense", 1.05, True),
    "m64_k800_n520": (64, 800, 520, torch.bfloat16, "quickgelu", "dense", 1.05, True),
    "m127_k800_n264_no_bias": (127, 800, 264, torch.bfloat16, "none", "dense", 1.05, False),
    "m129_k96_n520_strided": (129, 96, 520, torch.bfloat16, "quickgelu", "strided", 1.05, True),
    "m129_k3072_n264_strided_f32": (129, 3072, 264, torch.float32, "none", "strided", 1.05, True),
    "m1003_k768_n768_offset": (1003, 768, 768, torch.bfloat16, "none", "offset", 1.05, True),
    "m1003_k768_n768_offset_f32": (1003, 768, 768, torch.float32, "quickgelu", "offset", 1.05, False),
    "m1003_k768_n2304_clamped": (1003, 768, 2304, torch.bfloat16, "quickgelu", "dense", 0.4, True),
    "m1003_k3072_n768_clamped_f32": (1003, 3072, 768, torch.float32, "none", "dense", 0.4, True),
    "m4099_k768_n3072": (4099, 768, 3072, torch.bfloat16, "quickgelu", "dense", 1.05, True),
}


def phase_k2(vi, quant) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {label: (*site, "dense", 1.05, True) for label, site in K2_SITES.items()}
    for m in (1, 129, 1003):
        for dtype in (torch.float32, torch.bfloat16):
            cases[f"ragged_m{m}_{str(dtype).removeprefix('torch.')}"] = (m, 768, 2304, dtype, "quickgelu", "dense", 1.05, True)
    cases.update(K2_RAGGED)
    for label, (m, k, n, dtype, act) in K2_M3AE_SITES.items():
        cases[label] = (m, k, n, dtype, act, "dense", 1.05, True)
        other = "none" if act == "gelu_tanh" else "gelu_tanh"
        cases[f"{label}_{other}"] = (m, k, n, dtype, other, "dense", 1.05, True)
    for m in (1, 129, 1003):  # the tanh-GELU over ragged rows, and beyond the scale
        cases[f"ragged_m{m}_gelu_tanh"] = (m, 768, 3072, torch.bfloat16, "gelu_tanh", "dense", 1.05, True)
    cases["m1003_k768_n3072_gelu_tanh_clamped_f32"] = (1003, 768, 3072, torch.float32, "gelu_tanh", "dense", 0.4, True)
    for label, (m, k, n, dtype, act) in K2_SITES.items():  # every site of the reward server's fast_int8 engine
        cases[f"reward_serve_{label}"] = (m // BATCH * SERVE_BATCH, k, n, dtype, act, "dense", 1.05, True)
    for label, (m, k, n, dtype, act) in K2_SITES.items():  # mesh_tp_pp: two engine shares of 128 frames
        cases[f"mesh_share_{label}"] = (m // 2, k, n, dtype, act, "dense", 1.05, True)
    for w in range(1, POLICY_WINDOW + 1):  # the frozen_int8 tower in a rollout wave while the window fills
        for label, (_, k, n, dtype, act) in K2_M3AE_SITES.items():
            m = ROLLOUT_ENVS * w * (M3AE_TOKENS - 1 if label == "m3ae_img" else M3AE_TOKENS)
            cases[f"rollout_{label}_m{m}"] = (m, k, n, dtype, act, "dense", 1.05, True)
    errors = {}
    for label, (m, k, n, dtype, act, layout, margin, with_bias) in cases.items():
        x, a, wq, ws, bias, wq_t = k2_inputs(m, k, n, dtype, gen, quant, layout, margin)
        bias = bias if with_bias else None
        before = vi.fused_int8_matmul.launches
        got = vi.fused_int8_matmul(x, a, wq, ws, bias, act, wq_t=wq_t)
        check(vi.fused_int8_matmul.launches == before + 1, f"K2 {label}: not one launch a call")
        want = vi.fused_int8_matmul_reference(x, a, wq, ws, bias, act)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16 and got.shape == (m, n), f"K2 {label}: {got.dtype} {tuple(got.shape)}")
        errors[label] = {"ulps": bf16_ulps(got, want, TANH_GELU_TAIL_UNIT if act == "gelu_tanh" else 0.0),
                         "max_abs_err": (got.float() - want.float()).abs().max().item()}
        del x, got, want

    # ties: a = 127 makes x * 127/a = x, so x = k + 0.5 lands exactly half-way;
    # an identity weight with unit scales reads the int8 values back
    ties = torch.arange(-127, 127, device="cuda", dtype=torch.float32) + 0.5  # 254 ties
    x = torch.cat([ties, torch.tensor([3.0, 127.0], device="cuda")]).repeat(64, 1)  # (64, 256)
    eye = torch.eye(256, dtype=torch.int8, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        got = vi.fused_int8_matmul(x.to(dtype), torch.tensor(127.0, device="cuda"), eye,
                                   torch.ones(1, 256, device="cuda"))
        torch.cuda.synchronize()
        check(torch.equal(got.float(), torch.round(x)),
              f"K2 ties in {dtype}: {int((got.float() != torch.round(x)).sum())} of {x.numel()} not rounded half to even")
    emit("k2_check", cases=len(cases), ties="round half to even, 2 x 16,256 ties",
         max_bf16_ulps=max(e["ulps"] for e in errors.values()), errors=errors)
    for label, e in errors.items():
        check(e["ulps"] <= 1.0, f"K2 {label}: {e['ulps']} bf16 ulps from the plain version (bound 1)")

    timings = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (m, k, n, dtype, act) in {**K2_SITES, **K2_M3AE_SITES, **K2_SERVE_SITES}.items():
        x, a, wq, ws, bias, wq_t = k2_inputs(m, k, n, dtype, gen, quant)
        w16 = quant.dequantize_array(wq, ws).bfloat16()

        def bf16_site():
            out = (x.bfloat16() @ w16).float() + bias
            if act == "quickgelu":
                out = out * torch.sigmoid(1.702 * out)
            elif act == "gelu_tanh":
                out = torch.nn.functional.gelu(out, approximate="tanh")
            return out.bfloat16()

        fns = dict(plain=lambda: vi.fused_int8_matmul_reference(x, a, wq, ws, bias, act),
                   kernel=lambda: vi.fused_int8_matmul(x, a, wq, ws, bias, act, wq_t=wq_t),
                   bf16=bf16_site)
        # The library yardstick is the int8 product alone, on the int8 values K2 makes,
        # quantized beforehand: no prologue (quantizing x) and no epilogue (scales, bias, GELU, cast).
        int_mm = getattr(torch, "_int_mm", None)
        library_note = "this torch has no torch._int_mm"
        if int_mm is not None:
            library_note = "torch._int_mm: the int8 product alone, no prologue or epilogue"
            x8 = vi._quantize_x(x, a).to(torch.int8)
            fns["library"] = lambda: int_mm(x8, wq)
        t = interleaved_ms(**fns)
        # x read once, the int8 weight, its scales and the bias once, bf16 out written once
        nbytes = x.numel() * x.element_size() + k * n + 8 * n + 2 * m * n
        limit = bound(nbytes, 2 * m * k * n, "int8")
        plan = vi.k2_plan(m, k, n, x.element_size(), sms)
        timings[label] = {"shape": [m, k, n], "x": str(dtype).removeprefix("torch."), "act": act,
                          "ms": t["kernel"], "plain_ms": t["plain"], "bf16_matmul_ms": t["bf16"],
                          "library_ms": t.get("library"), "library": library_note,
                          "tops": 2 * m * k * n / t["kernel"] / 1e9, **limit,
                          "share_of_bound": limit["bound_ms"] / t["kernel"],
                          "route": plan["route"], "units": plan["units"], "l2_to_smem_bytes": plan["l2_bytes"],
                          "l2_to_smem_tb_s": plan["l2_bytes"] / t["kernel"] / 1e9}
    emit("k2_time", sms=sms, timings=timings)
    for label in ("fc", "proj", "qkv", "attn_out"):
        check(timings[label]["ms"] < timings[label]["bf16_matmul_ms"],
              f"K2 {label}: {timings[label]['ms']} ms is not faster than the bf16 matmul with the same "
              f"epilogue, {timings[label]['bf16_matmul_ms']} ms")
    return {"max_abs_err": max(e["max_abs_err"] for e in errors.values()),
            "max_bf16_ulps": max(e["ulps"] for e in errors.values()), "timings": timings,
            "checked": {k2_key(m, k, n, dtype, act) for m, k, n, dtype, act, *_ in cases.values()}}


# K3's shapes under quantize_weights at batch 256 (M, K, N); ragged M, N and K last
K3_SHAPES = {"attn_768x768": (BATCH * TOKENS, 768, 768), "fc_768x3072": (BATCH * TOKENS, 768, 3072),
             "proj_3072x768": (BATCH * TOKENS, 3072, 768), "ragged": (1003, 200, 130)}


def phase_k3(quant) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    errors, timings = {}, {}
    for label, (m, k, n) in K3_SHAPES.items():
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        q, s = quant.quantize_array(w)
        for dtype in (torch.float32, torch.bfloat16):
            name = f"{label}_{str(dtype).removeprefix('torch.')}"
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            got = quant.int8_matmul(x, q, s)
            want = quant.int8_matmul_reference(x, q, s)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == (m, n), f"K3 {name}: {got.dtype} {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            errors[name] = {"max_abs_err": err, "rel_to_max": err / want.float().abs().max().item(),
                            "bound": K3_F32_REL if dtype == torch.float32 else K3_BF16_REL}
            split = quant.int8_matmul_split_reference(x, q, s)  # the same arithmetic, other summation order
            errors[name]["rel_to_split_reference"] = ((got.float() - split.float()).abs().max()
                                                      / split.float().abs().max()).item()
            if label != "ragged":
                # The library yardstick: one matmul on the weight dequantized beforehand
                # (the plain version less its dequantize pass).
                w32 = quant.dequantize_array(q, s)
                fns = dict(plain=lambda: quant.int8_matmul_reference(x, q, s),
                           kernel=lambda: quant.int8_matmul(x, q, s),
                           library=lambda: x.float() @ w32)
                if dtype == torch.bfloat16:  # other numbers: it rounds the weight to bf16
                    w16 = w32.to(torch.bfloat16)
                    fns["library_bf16"] = lambda: x @ w16
                t = interleaved_ms(**fns)
                # x read once, int8 q and its scales once, out written once.  Operations: the
                # exact bf16 products on the tensor cores, one pass for bf16 x and three for the
                # three pieces of a float32 x (no float32 rate of the card holds K3's time back).
                passes = 1 if dtype == torch.bfloat16 else 3
                nbytes = x.numel() * x.element_size() + k * n + 4 * n + m * n * x.element_size()
                timings[name] = {"shape": [m, k, n], "ms": t["kernel"], "plain_ms": t["plain"],
                                 "library_ms": t["library"], "library": "x.float() @ dequantized weight (cuBLAS)",
                                 "library_bf16_weight_ms": t.get("library_bf16"),
                                 "tflops": 2 * m * k * n / t["kernel"] / 1e9, "bf16_passes": passes,
                                 **bound(nbytes, passes * 2 * m * k * n, "bf16")}
    emit("k3_check", cases=len(errors), errors=errors)
    for name, e in errors.items():
        check(e["rel_to_max"] <= e["bound"], f"K3 {name}: error {e['rel_to_max']} of the largest output > {e['bound']}")
    emit("k3_time", timings=timings)
    return {"max_abs_err": max(e["max_abs_err"] for n, e in errors.items() if n.endswith("float32")),
            "timings": timings}


def phase_resize(preprocess) -> None:
    """The CLIP input sizes (256 and 64 -> 224) and collect/downsize.py's (256 and 512 -> 64, where a 4x and
    an 8x downscale widen the bicubic filter's support)."""
    rng = np.random.default_rng(SEED)
    for size, out in ((256, 224), (64, 224), (256, 64), (512, 64)):
        frames = rng.integers(0, 256, size=(8, size, size, 3), dtype=np.uint8)
        packed = torch.from_numpy(frames.reshape(8, size, size * 3)).cuda()
        got = preprocess.resize_bicubic_pil_packed(packed, 3, out, out)
        want = preprocess.resize_bicubic_pil_reference(frames, out, out).reshape(8, out, out * 3)
        got = got.cpu().numpy()
        check(np.array_equal(got, want.astype(np.float32)),
              f"resize {size}->{out} on the card differs from the numpy reference "
              f"({int((got != want).sum())} bytes)")
        emit("resize", frames=[8, size, size, 3], out=[out, out], byte_identical=True)


def phase_slice(attn, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch, label_group) -> int:
    cfg = CONFIGS["vit_b16"]
    t0 = time.perf_counter()
    variables = random_clip_variables(cfg, 224, SEED)
    state = flax_to_torch(variables)
    g_src = demo_group(LABEL_FRAMES, 2, 256, SEED)
    text = "the goal is to collect the coin."
    emit("slice_setup", model="vit_b16", config=cfg, params=int(sum(t.numel() for t in state.values())),
         ob=list(g_src["ob"].shape), seconds=time.perf_counter() - t0)

    def engine(device, dtype, batch_size):
        model = CLIP(**cfg, image_size=224)
        model.load_state_dict(state)
        return ClipRewardEngine(model=model, batch_size=batch_size, compute_dtype=dtype, device=device)

    rows = LABEL_ROWS
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
        check(reward.shape == (LABEL_FRAMES, 2) and rtg.shape == (LABEL_FRAMES, 2),
              f"{name}: dataset shapes {reward.shape} {rtg.shape}")
        check(np.isfinite(reward).all() and np.isfinite(rtg).all(), f"{name}: non-finite rewards")
        check(g["ob_clip_reward"].attrs["encode_recipe"].startswith("torch;"), "encode_recipe lacks the torch; prefix")
        third = LABEL_FRAMES // 3  # demo_group's three trajectories
        for lo, hi in ((0, third), (third, 2 * LABEL_FRAMES // 3), (2 * LABEL_FRAMES // 3, LABEL_FRAMES)):
            r = reward[lo:hi, -1]
            check(np.allclose(rtg[lo:hi, -1], np.cumsum(r[::-1])[::-1], rtol=1e-4, atol=1e-3),
                  f"{name}: return-to-go of rows [{lo}, {hi}) is not the suffix sum of its rewards")
        check(mae <= bound, f"{name} reward MAE vs the CPU engine {mae} > {bound}")
        launches += run_launches
        g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
        emit("profile", dtype=name, frames=LABEL_FRAMES,
             **device_profile(lambda: label_group(g, text, eng, progress=False)))
    return launches


# slice_fast's engines: label -> ClipRewardEngine knobs.  fast_f32 pins float32
# scores so that the card (K1's softmax is float32) and the CPU run one recipe.
FAST_MODES = {
    "fast_f32": dict(fast_encode=True, fast_score_bf16=False),
    "fast_bf16": dict(fast_encode=True, compute_dtype=torch.bfloat16),
    "fast_int8": dict(fast_int8=True),
    "fast_int8_bf16_attn": dict(fast_int8=True, fast_int8_attn=False),
    "quantize_weights_f32": dict(quantize_weights=True),
}


def launch_counts(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def phase_slice_fast(counters, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch, label_group) -> dict:
    """Labeling through the packed and int8 engines; returns each kernel's launches over their runs."""
    cfg = CONFIGS["vit_b16"]
    state = flax_to_torch(random_clip_variables(cfg, 224, SEED))
    g_src = demo_group(LABEL_FRAMES, 2, 256, SEED)
    text = "the goal is to collect the coin."
    rows = LABEL_ROWS
    frames8 = np.asarray(g_src["ob"][rows, -1])

    def engine(device, batch_size, **knobs):
        model = CLIP(**cfg, image_size=224)
        model.load_state_dict(state)
        return ClipRewardEngine(model=model, batch_size=batch_size, device=device, **knobs)

    def cosine(a, b):
        return float(np.mean(np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))))

    ref = engine("cuda", BATCH).encode_image_features(frames8)  # the f32 standard engine
    totals = dict.fromkeys(counters, 0)
    for label, knobs in FAST_MODES.items():
        cpu = engine("cpu", 8, **knobs)
        want = cpu.text_rewards(frames8, text)  # an int8 engine calibrates on these 8 frames
        del cpu
        eng = engine("cuda", BATCH, **knobs)
        eng.text_rewards(frames8, text)  # the same first batch: 8 frames padded with the last one
        feat_cos = cosine(eng.encode_image_features(frames8), ref)
        g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        stats = label_group(g, text, eng, progress=False)
        launches = launch_counts(counters)

        reward = np.asarray(g["ob_clip_reward"])
        mae = float(np.abs(reward[rows, -1] - want).mean())
        cos_mae = F32_REWARD_MAE if label.endswith("f32") else (INT8_COS_MAE if "int8" in label else BF16_COS_MAE)
        bound = cos_mae if label.endswith("f32") else cos_mae * eng.logit_scale
        emit("slice_fast", mode=label, knobs={k: str(v) for k, v in knobs.items()}, frames=stats["frames"],
             seconds=stats["seconds"], fps=stats["fps"], batch_size=BATCH, launches=launches,
             reward_mae_vs_cpu=mae, mae_bound=bound, feature_cosine_vs_f32=feat_cos,
             cosine_bound=MIN_COSINE[label], reward_mean=float(reward[:, -1].mean()),
             reward_std=float(reward[:, -1].std()), recipe=eng.encode_recipe)
        check(reward.shape == (LABEL_FRAMES, 2) and np.isfinite(reward).all(), f"{label}: rewards {reward.shape}")
        check(launches["flash_attn_fwd"] > 0, f"{label}: labeling never launched K1")
        if "int8" in label:
            check(launches["int8_gemm"] > 0, f"{label}: labeling never launched K2")
        if label.startswith("quantize_weights"):
            check(launches["int8_matmul"] > 0, f"{label}: labeling never launched K3")
        check(mae <= bound, f"{label}: reward MAE vs the CPU engine {mae} > {bound}")
        check(feat_cos >= MIN_COSINE[label], f"{label}: feature cosine {feat_cos} < {MIN_COSINE[label]}")
        for name, n in launches.items():
            totals[name] += n
        g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
        emit("profile", mode=label, frames=LABEL_FRAMES, **device_profile(lambda: label_group(g, text, eng, progress=False)))
        del eng
        torch.cuda.empty_cache()
    return totals


def random_m3ae_variables(cfg: dict, patch_dim: int, vocab: int, seed: int, decoder: bool = False) -> dict:
    """Random M3AE weights in arp_tpu's Flax variable layout, from a numpy seed.

    ``cfg`` holds emb_dim, depth, mlp_ratio (and dec_emb_dim, dec_depth with ``decoder``).  Dense
    kernels ~ N(0, 1/fan_in), the fused ``qkv/kernel`` (emb_dim, 3 emb_dim), LayerNorm scales ~ 1,
    small biases, text embedding ~ N(0, 1) as Flax initializes it, cls token, mask and type
    embeddings ~ N(0, 0.02).  The encoder side only, as the policies' towers hold it; with
    ``decoder`` the whole autoencoder, as Flax's ``__call__`` init creates it (output heads of
    depth 0: one ``Dense_0`` each).
    """
    rng = np.random.default_rng(seed)
    normal = lambda shape, std: (std * rng.standard_normal(shape, dtype=np.float32))  # noqa: E731

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), n_in ** -0.5), "bias": normal((n_out,), 0.02)}

    def layer_norm(e):
        return {"scale": 1.0 + normal((e,), 0.02), "bias": normal((e,), 0.02)}

    def transformer(e, depth):
        hidden = e * cfg["mlp_ratio"]
        stack = {"norm": layer_norm(e)}
        for i in range(depth):
            stack[f"blocks_{i}"] = {
                "norm1": layer_norm(e), "attn": {"qkv": dense(e, 3 * e), "attn_out": dense(e, e)},
                "norm2": layer_norm(e), "mlp": {"fc1": dense(e, hidden), "fc2": dense(hidden, e)},
            }
        return stack

    e = cfg["emb_dim"]
    params = {
        "text_embedding": {"embedding": normal((vocab, e), 1.0)},
        "image_embedding": dense(patch_dim * patch_dim * 3, e),
        "encoder_image_type_embedding": normal((1, 1, e), 0.02),
        "encoder_text_type_embedding": normal((1, 1, e), 0.02),
        "cls_token": normal((1, 1, e), 0.02),
        "encoder": transformer(e, cfg["depth"]),
    }
    if decoder:
        d = cfg["dec_emb_dim"]
        params.update({
            "decoder": transformer(d, cfg["dec_depth"]),
            "decoder_input_projection": dense(e, d),
            "decoder_image_type_embedding": normal((1, 1, d), 0.02),
            "decoder_text_type_embedding": normal((1, 1, d), 0.02),
            "image_mask_embedding": normal((1, 1, d), 0.02),
            "text_mask_embedding": normal((1, 1, d), 0.02),
            "decoder_image_output": {"Dense_0": dense(d, patch_dim * patch_dim * 3)},
            "decoder_text_output": {"Dense_0": dense(d, vocab)},
        })
    return {"params": params}


def cosine(a, b) -> float:
    a, b = a.detach().float().cpu().flatten().double(), b.detach().float().cpu().flatten().double()
    return float(a @ b / (a.norm() * b.norm() + 1e-12))


def k1_key(b, n, h, d, spec, padded: bool, dtype) -> str:
    """A K1 shape as k1_check holds it and a path launches it."""
    return (f"{spec.kind}/{spec.num_obs_token}/{spec.num_token_per_step} b={b} n={n} h={h} d={d} "
            f"{str(dtype).removeprefix('torch.')}{' padded' if padded else ''}")


def k2_key(m, k, n, dtype, act) -> str:
    """A K2 shape as k2_check holds it and a path launches it."""
    return f"m={m} k={k} n={n} {str(dtype).removeprefix('torch.')} {act}"


class KernelStandIn:
    """While in place, ``k1(real, *args)`` stands in for K1's wrapper (``attention.flash_attention_fwd``)
    and ``k2(real, *args)`` for K2's (``vit_infer.fused_int8_matmul`` and ``m3ae_infer``'s import of it);
    None leaves a kernel alone.  The launch counts stay the wrappers' own."""

    class _Fn:
        def __init__(self, real, fn):
            self.real, self.fn = real, fn

        def __call__(self, *args, **kwargs):
            return self.fn(self.real, *args, **kwargs)

        launches = property(lambda self: self.real.launches,  # a wrapper counts through its module's name
                            lambda self, n: setattr(self.real, "launches", n))

    def __init__(self, k1=None, k2=None):
        from arp_tpu_torch.ops import attention, m3ae_infer, vit_infer

        self.sites = ([(attention, "flash_attention_fwd", k1)] if k1 else []) + (
            [(vit_infer, "fused_int8_matmul", k2), (m3ae_infer, "fused_int8_matmul", k2)] if k2 else [])

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self.sites]
        for mod, name, fn in self.sites:
            setattr(mod, name, self._Fn(getattr(mod, name), fn))
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self.saved):
            setattr(mod, name, real)


class K1Recorder(KernelStandIn):
    """While in place, notes (mask kind, N, heads, head_dim, dtype, padding, whether q, k or v need a
    gradient) of every K1 launch; the launch count stays the wrapper's own."""

    def __init__(self):
        self.shapes = []

        def k1(real, q, k, v, spec, kv_padding=None):
            self.shapes.append((spec.kind, q.shape[1], q.shape[2], q.shape[3], str(q.dtype).removeprefix("torch."),
                                kv_padding is not None, any(x.requires_grad for x in (q, k, v))))
            return real(q, k, v, spec, kv_padding)

        super().__init__(k1=k1)

    def counts(self) -> dict:
        out = defaultdict(int)
        for shape in self.shapes:
            out["{} n={} h={} d={} {}{}{}".format(*shape[:5], " padded" if shape[5] else "",
                                                   " grad" if shape[6] else "")] += 1
        return dict(out)


class LaunchShapes(KernelStandIn):
    """While in place, counts K1's and K2's calls (on the card: launches) by ``k1_key`` / ``k2_key``."""

    def __init__(self):
        self.k1, self.k2 = Counter(), Counter()

        def k1(real, q, k, v, spec, kv_padding=None):
            self.k1[k1_key(*q.shape, spec, kv_padding is not None, q.dtype)] += 1
            return real(q, k, v, spec, kv_padding)

        def k2(real, x, a_scale, wq, w_scale, bias=None, act="none", wq_t=None):
            self.k2[k2_key(*x.shape, wq.shape[1], x.dtype, act)] += 1
            return real(x, a_scale, wq, w_scale, bias, act, wq_t=wq_t)

        super().__init__(k1, k2)


def plain_kernels(k1: bool = True, k2: bool = True) -> KernelStandIn:
    """K1 and K2 replaced by their plain versions on whatever device the tensors are (K1's: float32
    scores and softmax, out in q's dtype); nothing launches."""
    from arp_tpu_torch.ops import attention, vit_infer

    def plain_k1(real, q, k, v, spec, kv_padding=None):
        return attention.reference_attention(q.float(), k.float(), v.float(), spec, kv_padding).to(q.dtype)

    def plain_k2(real, x, a_scale, wq, w_scale, bias=None, act="none", wq_t=None):
        return vit_infer.fused_int8_matmul_reference(x, a_scale, wq, w_scale, bias, act)

    return KernelStandIn(plain_k1 if k1 else None, plain_k2 if k2 else None)


DEVICE = "cuda"  # where the policy path's phases run (a CPU rehearsal of their control flow sets "cpu")


def sync() -> None:
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def host_ms(fn, iters: int = 3) -> float:
    """Mean wall time of ``fn`` in ms, each run ended by a synchronize, after a warm-up."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def m3ae_inputs(frames: int, seed: int):
    """Normalized-frame patches, goal patches, BERT ids and their padding (row 0 all padding), on the CPU."""
    rng = np.random.default_rng(seed)
    patch = rng.standard_normal((frames, M3AE_TOKENS - 1, 768), dtype=np.float32)
    goal = rng.standard_normal((frames, M3AE_TOKENS - 1, 768), dtype=np.float32)
    ids = rng.integers(0, BERT_VOCAB, size=(frames, TEXT_LEN))
    lengths = rng.integers(1, TEXT_LEN + 1, size=frames)
    lengths[0] = 0
    pad = (np.arange(TEXT_LEN)[None, :] >= lengths[:, None]).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (patch, goal, ids, pad))


def phase_m3ae(counters, attn, m3ae_lib, m3ae_infer, flax_m3ae_to_torch) -> dict:
    """The frozen tower at full width in six modes over three token streams; returns each kernel's launches."""
    depth, heads, width = M3AE_DIMS["depth"], M3AE_DIMS["num_heads"], M3AE_DIMS["emb_dim"]
    t0 = time.perf_counter()
    variables = random_m3ae_variables(M3AE_DIMS, 16, BERT_VOCAB, SEED)
    state = flax_m3ae_to_torch(variables)
    patch, goal, ids, pad = m3ae_inputs(M3AE_FRAMES, SEED)
    emit("m3ae_setup", config=dict(M3AE_CFG, patch=16, image=256, vocab=BERT_VOCAB), params=int(sum(t.numel() for t in state.values())),
         frames=M3AE_FRAMES, tokens=M3AE_TOKENS, seconds=time.perf_counter() - t0)
    bf16_cfg = dict(M3AE_CFG, compute_dtype="bfloat16", ln_dtype="bfloat16", score_dtype="bfloat16")

    def module(cfg, dtype, device):
        m = m3ae_lib.MaskedMultimodalAutoencoder(cfg, text_vocab_size=BERT_VOCAB)
        m.load_state_dict(state)
        return m.requires_grad_(False).to(device=device, dtype=dtype).eval()

    def tower(mode, device):
        """``run(patch, **stream)`` -> float32 tokens of one mode on ``device``; int8 packs calibrate per stream."""
        if mode in ("module_f32", "module_bf16"):
            m = module(M3AE_CFG if mode == "module_f32" else bf16_cfg,
                       torch.float32 if mode == "module_f32" else torch.bfloat16, device)

            def run(p, text_ids=None, text_padding_mask=None, goal_patch=None):
                if goal_patch is not None:
                    return m.forward_gc_representations(p, goal_patch, deterministic=True).float()
                return m.forward_representation(p, text_ids, text_padding_mask, deterministic=True).float()
            return run
        on = {k: v.to(device) for k, v in state.items()}
        if mode in ("packed_f32", "packed_bf16"):
            dt = torch.float32 if mode == "packed_f32" else torch.bfloat16
            packed = m3ae_infer.pack_m3ae_params(on, depth, dtype=dt)
            return lambda p, **kw: m3ae_infer.m3ae_encode(packed, p, heads, compute_dtype=dt, **kw)
        packs = {}

        def run(p, **kw):
            key = tuple(sorted(kw))
            if key not in packs:  # calibrated on the first 8 frames of this stream
                packs[key] = m3ae_infer.build_m3ae_qpack(on, depth, heads, p[:CPU_FRAMES],
                                                         **{k: v[:CPU_FRAMES] for k, v in kw.items()})
            # the JAX tests' recipes: float32 scores, and bf16 scores under int8 attention
            return m3ae_infer.m3ae_encode_int8(packs[key], p, heads, int8_attn=mode == "int8_attn",
                                               score_dtype=torch.bfloat16 if mode == "int8_attn" else torch.float32, **kw)
        return run

    streams = {"image": {}, "text": dict(text_ids=ids, text_padding_mask=pad), "goal": dict(goal_patch=goal)}
    k2_a_call = {"image": 1 + 4 * depth, "text": 1 + 4 * depth, "goal": 2 + 4 * depth}
    totals = dict.fromkeys(counters, 0)
    for mode in ("module_f32", "module_bf16", "packed_f32", "packed_bf16", "int8", "int8_attn"):
        cpu_run, gpu_run = tower(mode, "cpu"), tower(mode, DEVICE)
        for stream, kw in streams.items():
            t0 = time.perf_counter()
            with torch.no_grad():
                want = cpu_run(patch[:CPU_FRAMES], **{k: v[:CPU_FRAMES] for k, v in kw.items()})
            cpu_seconds = time.perf_counter() - t0
            on_card = {k: v.to(DEVICE) for k, v in kw.items()}
            p = patch.to(DEVICE)
            with torch.no_grad():
                gpu_run(p[:CPU_FRAMES], **{k: v[:CPU_FRAMES] for k, v in on_card.items()})  # builds; calibrates an int8 pack
                sync()
                for fn in counters.values():
                    fn.launches = 0
                with K1Recorder() as rec:
                    got = gpu_run(p, **on_card)
                sync()
                launches = launch_counts(counters)
                ms = host_ms(lambda: gpu_run(p, **on_card))
            tokens = M3AE_TOKENS + (TEXT_LEN if stream == "text" else M3AE_TOKENS - 1 if stream == "goal" else 0)
            check(got.shape == (M3AE_FRAMES, tokens, width) and got.dtype == torch.float32, f"m3ae {mode} {stream}: {got.shape}")
            check(bool(torch.isfinite(got).all()), f"m3ae {mode} {stream}: non-finite tokens")
            err = (got[:CPU_FRAMES].cpu() - want).abs().max().item()
            cos = cosine(got[:CPU_FRAMES], want)
            emit("m3ae", mode=mode, stream=stream, frames=M3AE_FRAMES, tokens=tokens, ms=ms, fps=M3AE_FRAMES / ms * 1e3,
                 launches=launches, k1_shapes=rec.counts(), max_abs_err_vs_cpu=err, cosine_vs_cpu=cos,
                 bound=F32_ATOL if mode.endswith("f32") else TOWER_MIN_COSINE[mode], cpu_seconds=cpu_seconds)
            if mode.endswith("f32"):
                check(err <= F32_ATOL, f"m3ae {mode} {stream}: max abs err vs the CPU run {err} > {F32_ATOL}")
            else:
                check(cos >= TOWER_MIN_COSINE[mode], f"m3ae {mode} {stream}: cosine vs the CPU run {cos} < {TOWER_MIN_COSINE[mode]}")
            want_k1 = 0 if mode == "int8_attn" else depth
            want_k2 = k2_a_call[stream] if mode.startswith("int8") else 0
            check(launches["flash_attn_fwd"] == want_k1 and launches["int8_gemm"] == want_k2,
                  f"m3ae {mode} {stream}: launches {launches}, expected K1 {want_k1} and K2 {want_k2} a call")
            for name, n in launches.items():
                totals[name] += n
            del got, p, on_card
        del cpu_run, gpu_run
        torch.cuda.empty_cache()
    return totals


POLICY_BATCH, POLICY_WINDOW = 128, 4
SERVE_SESSIONS, SERVE_STEPS = 8, 6  # 48 /v1/act requests from 8 client threads
POLICY_CFG = dict(model_type="vit_base", transfer_type="m3ae_vit_b16", use_adapter=True, use_discrete_action=True,
                  emb_dim=128, depth=2, num_heads=8)
POLICY_MODES = {"float32": {}, "frozen_bf16": dict(frozen_bf16=True), "frozen_int8": dict(frozen_int8=True)}


def policy_batch(batch: int, window: int, seed: int) -> tuple[dict, dict]:
    """(raw uint8 batch, the same through the eval transform as float32 numpy) in the trainer's layout."""
    from arp_tpu_torch.ops.augment import make_eval_transform

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(batch, window, 256, 256, 3), dtype=np.uint8)
    raw = {"image": {"ob": frames}, "rtg": {"ob": rng.uniform(0, 1, size=(batch, window, 1)).astype(np.float32)},
           "action": rng.integers(0, 15, size=(batch, window)).astype(np.int32), "instruct": None,
           "text_padding_mask": None}
    transform = make_eval_transform(image_size=256, device=DEVICE)
    image = torch.cat([transform(frames[i:i + 16].reshape(-1, 256, 256, 3)).cpu() for i in range(0, batch, 16)])
    return raw, dict(raw, image={"ob": image.reshape(batch, window, 256, 256, 3).numpy()})


def head_batch(batch: dict, n: int) -> dict:
    return {k: ({kk: vv[:n] for kk, vv in v.items()} if isinstance(v, dict) else None if v is None else v[:n])
            for k, v in batch.items()}


def phase_policy(counters, attn, policy_lib, flax_m3ae_to_torch) -> tuple[dict, dict]:
    """ARPDT at the flagship configuration in three tower modes; returns (launches, what the serve phase reuses)."""
    pt = flax_m3ae_to_torch(random_m3ae_variables(M3AE_DIMS, 16, BERT_VOCAB, SEED))
    raw, batch = policy_batch(POLICY_BATCH, POLICY_WINDOW, SEED)
    small = head_batch(batch, CPU_FRAMES // POLICY_WINDOW)  # two sequences: 8 frames, the CPU run's share
    on_card = {k: ({kk: torch.from_numpy(vv).to(DEVICE) for kk, vv in v.items()} if isinstance(v, dict)
                   else None if v is None else torch.from_numpy(v).to(DEVICE)) for k, v in batch.items()}
    frames = POLICY_BATCH * POLICY_WINDOW
    totals, outputs, trained, keep = dict.fromkeys(counters, 0), {}, None, {}
    for mode, over in POLICY_MODES.items():
        cfg = dict(POLICY_CFG, m3ae=M3AE_CFG, **over)
        qpack = {"cpu": None, DEVICE: None}
        if mode == "frozen_int8":  # calibrated on the raw frames of the first two sequences
            for device in qpack:
                qpack[device] = policy_lib.build_frozen_qpack(cfg, head_batch(raw, 2), 16, image_size=256,
                                                              m3ae_loader=lambda name: pt, device=device)

        def build(device):
            torch.manual_seed(SEED)
            model = policy_lib.ARPDT(cfg, num_actions=15, patch_dim=16, pt_variables=pt,
                                     frozen_qpack=qpack[device]).to(device).eval()
            with torch.no_grad():
                model(small, deterministic=True)  # the lazy layers take their shapes; on the card: builds
                if trained is not None:
                    model.load_trained_state_dict(trained)
            return model

        cpu_model = build("cpu")
        if trained is None:
            trained = cpu_model.trained_state_dict()  # one set of trained weights for every mode and device
        t0 = time.perf_counter()
        with torch.no_grad():
            want = cpu_model(small, deterministic=True)["action_pred"]
        cpu_seconds = time.perf_counter() - t0
        del cpu_model
        model = build(DEVICE)
        with torch.inference_mode():
            model(on_card, deterministic=True)
            sync()
            for fn in counters.values():
                fn.launches = 0
            with K1Recorder() as rec:
                out = model(on_card, deterministic=True)
            sync()
            launches = launch_counts(counters)
            ms = host_ms(lambda: model(on_card, deterministic=True))
        pred = out["action_pred"]
        outputs[mode] = pred
        check(pred.shape == (POLICY_BATCH, POLICY_WINDOW, 15) and bool(torch.isfinite(pred).all()), f"policy {mode}: {pred.shape}")
        check(all(bool(torch.isfinite(out[k]).all()) for k in ("return_pred", "loss", "acc", "trans_loss", "return_loss")),
              f"policy {mode}: a non-finite output")
        few = pred[:want.shape[0]]  # the counted batch-128 forward's own rows against the CPU run of them
        err, cos = (few.cpu() - want).abs().max().item(), cosine(few, want)
        info = dict(mode=mode, batch=POLICY_BATCH, window=POLICY_WINDOW, frames=frames, ms=ms, fps=frames / ms * 1e3,
                    launches=launches, k1_shapes=rec.counts(), max_abs_err_vs_cpu=err, cosine_vs_cpu=cos, cpu_seconds=cpu_seconds)
        if mode == "float32":
            check(err <= F32_ATOL, f"policy float32: action_pred max abs err vs the CPU run {err} > {F32_ATOL}")
        else:
            check(cos >= POLICY_MIN_COSINE[mode], f"policy {mode}: cosine vs the CPU run {cos} < {POLICY_MIN_COSINE[mode]}")
            against = "float32" if mode == "frozen_bf16" else "frozen_bf16"
            info[f"cosine_vs_{against}"] = cosine(pred, outputs[against])
            check(info[f"cosine_vs_{against}"] >= POLICY_MIN_COSINE[mode],
                  f"policy {mode}: cosine vs {against} on the card {info[f'cosine_vs_{against}']} < {POLICY_MIN_COSINE[mode]}")
        emit("policy", **info)
        d16 = sum(n for shape, n in rec.counts().items() if shape.startswith("dt n=12 h=8 d=16 float32"))
        check(d16 == POLICY_CFG["depth"], f"policy {mode}: K1 at head_dim 16 under the dt mask launched {d16} times a forward")
        tower_k1 = 0 if mode == "frozen_int8" else M3AE_DIMS["depth"]  # frozen_int8_attn "auto": the int8 attention is not K1
        check(launches["flash_attn_fwd"] == tower_k1 + POLICY_CFG["depth"]
              and launches["int8_gemm"] == (1 + 4 * M3AE_DIMS["depth"] if mode == "frozen_int8" else 0),
              f"policy {mode}: launches {launches}")
        for name, n in launches.items():
            totals[name] += n
        with torch.inference_mode():
            emit("profile", mode=f"policy_{mode}", frames=frames,
                 **device_profile(lambda: model(on_card, deterministic=True)))
        if mode == "frozen_int8":
            keep = dict(model=model, cfg=cfg, pt=pt, qpack=qpack[DEVICE])
        else:
            del model
        torch.cuda.empty_cache()
    return totals, keep


TRAIN_WARMUP, TRAIN_TIMED = 2, 5  # steps before the timed ones, and the timed ones (their median is ms a step)
TRAIN_FLAGS = dict(lr=5e-4, lr_schedule="cos", warmup_epochs=10, epochs=50, weight_decay=5e-5, clip_gradient=10.0,
                   augmentations="random_crop,color_jitter")  # jobs/train_procgen.sh:41-75
TRAIN_STEPS_PER_EPOCH = 1000  # a nominal epoch: it only places the warmup's end for the schedule
# The card's step against the CPU's on the same state, batch and drawn augmentation
# (compare_step_with_cpu): the tolerances of tests/test_torch_train_step.py (loss 1e-5;
# gradients 1e-4 of the largest entry; updated parameters 2e-5 at lr 5e-4, leaving out entries
# whose gradient is within the gradient tolerance of 0, where Adam's first step moves by +-lr
# on the sign alone).
TRAIN_LOSS_ATOL, TRAIN_GRAD_REL, TRAIN_PARAM_ATOL = 1e-5, 1e-4, 2e-5
# of the adapter's 768 hidden units, how many may flip their ReLU for some token between the card's
# tower output and the CPU's (compare_step_with_cpu)
TRAIN_MAX_FLIPPED_UNITS = 8
ADAPTER_IN = "AdapterMLP_0.Dense_0"  # the adapter's first Linear, behind the ReLU


def train_flags(cfg: dict):
    """The trainer's flags for ``cfg``, as the CLI holds them (the model's config resolved)."""
    from arp_tpu_torch.config import Config
    from arp_tpu_torch.models.policy import get_policy_default_config

    return Config(TRAIN_FLAGS, model=get_policy_default_config(cfg), use_vl=True, vl_type="clip", patch_dim=16,
                  encode_image_size=0,
                  data=dict(use_task_reward=False, image_size=256, augmentations=TRAIN_FLAGS["augmentations"]))


def _flat(tree, prefix=""):
    """A pack's tensors by dotted name."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v
    return out


def compare_step_with_cpu(flags, build, augment, small_cpu, small_card) -> dict:
    """One float32 step on the card and on the CPU from one state, batch (two sequences) and drawn
    augmentation: the loss, the gradients and the updated parameters.

    Twice on the card: end to end, and with the frozen tower's output replaced by the CPU's.  The
    adapter's ReLUs make the gradient a piecewise function of the tower's output: where the card's
    tower (K1 in float32, held to the CPU at 1e-4 by the m3ae and policy phases) moves a
    pre-activation across 0, that unit's row of the adapter's first Linear takes another gradient,
    a difference no tolerance on the gradient bounds.  So the end-to-end step is held on its loss,
    on at most TRAIN_MAX_FLIPPED_UNITS such units, and on every gradient and updated parameter
    outside their rows; the step on the CPU's tower output is held on all of them.  Returns the
    trained weights every run started from (the CPU model's first ones).
    """
    from arp_tpu_torch.parallel.step import TrainState
    from arp_tpu_torch.train import common

    drawn = augment.draw(CPU_FRAMES, torch.Generator().manual_seed(SEED))
    trained = {}

    def one_step(device, small, tower_out=None):
        model = build(device)
        if not trained:
            trained.update({k: v.clone() for k, v in model.trained_state_dict().items()})
        model.load_trained_state_dict(trained)
        seen = {}
        tower = model.pt_model.forward_representation

        def forward_representation(*args, **kwargs):  # notes the tower's output, or gives the one asked for
            out = tower(*args, **kwargs)
            seen["tower"] = out.detach().cpu()
            seen["tower_used"] = seen["tower"] if tower_out is None else tower_out
            return out if tower_out is None else tower_out.to(out.device)

        model.pt_model.forward_representation = forward_representation
        on = [{k: v.to(device) for k, v in p.items()} for p in drawn]
        state = TrainState.create(model, common.build_optimizer(flags, lambda count: flags.lr, model))
        loss_fn = common.make_loss_fn(model, lambda images, generator: augment.apply(images, on), 256, False)
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, small, torch.Generator(device=device).manual_seed(SEED))
        loss.backward()
        grads = [p.grad.detach().clone() for _, p in state.params]
        state.apply_gradients(grads)
        sync()
        return dict(loss=float(loss.detach()), grads=[g.cpu() for g in grads], names=[n for n, _ in state.params],
                    params=[p.detach().cpu() for _, p in state.params], seconds=time.perf_counter() - t0, **seen)

    cpu = one_step("cpu", small_cpu)
    gmax = max(float(g.abs().max()) for g in cpu["grads"])
    settled = [g.abs() > TRAIN_GRAD_REL * gmax for g in cpu["grads"]]

    def adapter_pre(tower_out):  # the adapter's first pre-activations, on the CPU, from a tower output
        return torch.nn.functional.linear(tower_out, trained[f"{ADAPTER_IN}.weight"], trained[f"{ADAPTER_IN}.bias"])

    def against_cpu(run):
        flips = (adapter_pre(cpu["tower"]) > 0) != (adapter_pre(run["tower_used"]) > 0)
        units = flips.flatten(0, -2).any(0)  # the adapter units whose ReLU went the other way for some token
        keep = [torch.ones_like(g, dtype=torch.bool) for g in cpu["grads"]]
        for name, m in zip(cpu["names"], keep):
            if name in (f"{ADAPTER_IN}.weight", f"{ADAPTER_IN}.bias"):
                m[units] = False
        errs = [float(((a - b).abs() * m).max()) / gmax for a, b, m in zip(cpu["grads"], run["grads"], keep)]
        worst = max(range(len(errs)), key=errs.__getitem__)
        param_err = max(float(((a - b).abs() * m * k).max())
                        for a, b, m, k in zip(cpu["params"], run["params"], settled, keep))
        return dict(loss_abs_err=abs(cpu["loss"] - run["loss"]), grad_err_rel_to_max=errs[worst],
                    worst_grad=run["names"][worst], param_max_abs_err=param_err,
                    adapter_relu_flips=int(flips.sum()), adapter_relu_units_flipped=int(units.sum()),
                    entries_left_out_for_flips=sum(int((~m).sum()) for m in keep))

    e2e = one_step(DEVICE, small_card)
    end_to_end = against_cpu(e2e)
    same_tower = against_cpu(one_step(DEVICE, small_card, tower_out=cpu["tower"]))
    emit("train_vs_cpu", mode="float32", sequences=CPU_FRAMES // POLICY_WINDOW, loss_cpu=cpu["loss"],
         grad_max_abs=gmax, tower_max_abs_err=float((e2e["tower"] - cpu["tower"]).abs().max()),
         end_to_end=end_to_end, same_tower_output=same_tower, param_entries=sum(p.numel() for p in cpu["params"]),
         param_entries_left_out=sum(int((~m).sum()) for m in settled), lr=flags.lr, cpu_seconds=cpu["seconds"])
    for run, what in ((end_to_end, "end to end"), (same_tower, "on the CPU's tower output")):
        check(run["loss_abs_err"] <= TRAIN_LOSS_ATOL, f"train step loss {what}: card vs CPU {run['loss_abs_err']}")
        check(run["grad_err_rel_to_max"] <= TRAIN_GRAD_REL,
              f"train step gradients {what}: card vs CPU {run['grad_err_rel_to_max']} of the largest entry "
              f"({run['worst_grad']})")
        check(run["param_max_abs_err"] <= TRAIN_PARAM_ATOL,
              f"train step updated params {what}: card vs CPU max abs {run['param_max_abs_err']}")
    check(end_to_end["adapter_relu_units_flipped"] <= TRAIN_MAX_FLIPPED_UNITS,
          f"train step end to end: {end_to_end['adapter_relu_units_flipped']} adapter units flipped, "
          f"more than {TRAIN_MAX_FLIPPED_UNITS}")
    check(same_tower["adapter_relu_flips"] == 0, "train step on the CPU's tower output: an adapter ReLU flipped")
    return trained


def to_device(tree: dict, device) -> dict:
    """A batch of numpy leaves (None kept) as tensors on ``device``."""
    return {k: (to_device(v, device) if isinstance(v, dict) else None if v is None else torch.from_numpy(v).to(device))
            for k, v in tree.items()}


def phase_train(counters, attn, policy_lib, flax_m3ae_to_torch) -> dict:
    """ARPDT train steps at the flagship configuration in three tower modes, through the trainer's own
    functions (train/common.py, parallel/step.py); returns each kernel's launches in the counted steps."""
    from arp_tpu_torch.ops.attention import reference_attention
    from arp_tpu_torch.ops.augment import make_augment_fn
    from arp_tpu_torch.ops.masks import MaskSpec
    from arp_tpu_torch.parallel.step import TrainState, make_train_step
    from arp_tpu_torch.train import common

    pt = flax_m3ae_to_torch(random_m3ae_variables(M3AE_DIMS, 16, BERT_VOCAB, SEED))
    raw, _ = policy_batch(POLICY_BATCH, POLICY_WINDOW, SEED)
    small = head_batch(raw, CPU_FRAMES // POLICY_WINDOW)  # two sequences, the CPU run's share

    on_card = to_device(raw, DEVICE)
    frames = POLICY_BATCH * POLICY_WINDOW
    totals, trained = dict.fromkeys(counters, 0), None
    for mode, over in POLICY_MODES.items():
        cfg = dict(POLICY_CFG, m3ae=M3AE_CFG, **over)
        flags = train_flags(cfg)
        schedule = common.build_lr_schedule(flags, TRAIN_STEPS_PER_EPOCH, TRAIN_STEPS_PER_EPOCH * flags.epochs)
        augment = make_augment_fn(flags.data.augmentations, image_size=256, source_size=flags.data.image_size)

        def build(device):
            """The model on ``device`` as the trainer builds it, its first forward run, with the phase's trained weights."""
            qpack = common.maybe_build_frozen_qpack(flags, small, use_goal=False, device=device,
                                                    m3ae_loader=lambda name: pt)
            torch.manual_seed(SEED)
            model = common.build_model(flags, 15, frozen_qpack=qpack, pt_variables=pt).to(device)
            with torch.no_grad():
                model(to_device(head_batch(small, 1), device), deterministic=True)  # the lazy layers take their shapes
                if trained is not None:
                    model.load_trained_state_dict(trained)
            return model

        if mode == "float32":
            trained = compare_step_with_cpu(flags, build, augment, to_device(small, "cpu"), to_device(small, DEVICE))

        model = build(DEVICE)
        state = TrainState.create(model, common.build_optimizer(flags, schedule, model))
        # the steps run where the warmup ends (lr 5e-4): a step from 0 moves a parameter by lr(0) = 0
        state.step = state.opt_state.count = TRAIN_FLAGS["warmup_epochs"] * TRAIN_STEPS_PER_EPOCH
        loss_fn = common.make_loss_fn(model, augment, 256, False)
        step = make_train_step(loss_fn, learning_rate_fn=schedule)
        tower = {f"pt_model.{k}": v.detach().clone() for k, v in model.pt_model.state_dict().items()}
        if model.frozen_qpack is not None:
            tower.update({f"qpack.{k}": v.clone() for k, v in _flat(model.frozen_qpack).items()})
        before = {n: p.detach().clone() for n, p in state.params}
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        for _ in range(TRAIN_WARMUP):
            step(state, on_card, gen)
        sync()
        for fn in counters.values():
            fn.launches = 0
        with K1Recorder() as rec:
            _, aux = step(state, on_card, gen)
        sync()
        launches = launch_counts(counters)
        if DEVICE != "cpu":
            torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(TRAIN_TIMED):
            t0 = time.perf_counter()
            _, aux = step(state, on_card, gen)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() if DEVICE != "cpu" else None
        ms = float(np.median(times))
        # one more step split into its forward, backward and optimizer update, each synced
        split = {}
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, on_card, gen)
        sync()
        split["forward_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loss.backward()
        sync()
        split["backward_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        state.apply_gradients([p.grad for _, p in state.params])
        sync()
        split["optimizer_ms"] = (time.perf_counter() - t0) * 1e3
        for _, p in state.params:
            p.grad = None
        loss_value = float(aux["loss"])
        check(np.isfinite(loss_value), f"train {mode}: loss {loss_value}")
        now = {f"pt_model.{k}": v for k, v in model.pt_model.state_dict().items()}
        if model.frozen_qpack is not None:
            now.update({f"qpack.{k}": v for k, v in _flat(model.frozen_qpack).items()})
        changed = [k for k, v in tower.items() if not torch.equal(v, now[k])]
        check(not changed, f"train {mode}: the frozen tower changed: {changed[:4]}")
        check(all(p.grad is None for p in model.pt_model.parameters()), f"train {mode}: a tower parameter has a gradient")
        still = [n for n, p in state.params if torch.equal(before[n], p.detach())]
        check(not still, f"train {mode}: trained parameters that did not move: {still}")
        shapes = rec.counts()
        dt_grad = sum(n for shape, n in shapes.items()
                      if shape.startswith(f"dt n={3 * POLICY_WINDOW} h=8 d=16 float32") and shape.endswith(" grad"))
        check(dt_grad == POLICY_CFG["depth"], f"train {mode}: K1 under the dt mask with grad enabled launched {dt_grad} "
                                               f"times a step, expected {POLICY_CFG['depth']} ({shapes})")
        tower_k1 = 0 if mode == "frozen_int8" else M3AE_DIMS["depth"]  # frozen_int8_attn "auto": int8 attention
        check(launches["flash_attn_fwd"] == tower_k1 + POLICY_CFG["depth"]
              and launches["int8_gemm"] == (1 + 4 * M3AE_DIMS["depth"] if mode == "frozen_int8" else 0),
              f"train {mode}: launches {launches}")
        for name, n in launches.items():
            totals[name] += n
        # the plain backward that FlashAttention runs for the policy blocks, at the step's shape
        k1_bwd_ms = None
        if DEVICE != "cpu":
            n_tok = 3 * POLICY_WINDOW  # obs, rtg and action tokens a timestep
            q, k, v = (torch.randn(POLICY_BATCH, n_tok, 8, 16, device=DEVICE, requires_grad=True) for _ in range(3))
            spec, g_out = MaskSpec("dt", 1, 3), torch.randn(POLICY_BATCH, n_tok, 8, 16, device=DEVICE)
            k1_bwd_ms = cuda_ms(lambda: torch.autograd.grad(reference_attention(q, k, v, spec), (q, k, v), g_out))
        emit("train", mode=mode, batch=POLICY_BATCH, window=POLICY_WINDOW, frames=frames, ms=ms, step_ms=times,
             fps=frames / ms * 1e3, peak_memory_bytes=peak, loss=loss_value, learning_rate=aux["learning_rate"],
             launches=launches, k1_shapes=shapes, trained_params=sum(p.numel() for _, p in state.params), **split,
             k1_plain_backward_ms_a_call=k1_bwd_ms,
             k1_plain_backward_share=None if k1_bwd_ms is None else POLICY_CFG["depth"] * k1_bwd_ms / ms)
        emit("profile", mode=f"train_{mode}", frames=frames, **device_profile(lambda: step(state, on_card, gen)))
        del model, state, step, tower, now, before
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    return totals


def phase_serve(counters, keep, policy_lib, serve) -> dict:
    """The policy server with the frozen_int8 policy behind real HTTP; returns each kernel's launches over the requests."""
    import tempfile
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from arp_tpu_torch.ops.augment import make_eval_transform

    sessions, steps, window = SERVE_SESSIONS, SERVE_STEPS, POLICY_WINDOW

    def post(url, payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    with tempfile.TemporaryDirectory() as ckpt_dir:
        model = keep["model"]
        policy_fn, load_latest = serve.reloadable_policy(model, ckpt_dir)
        transform = make_eval_transform(image_size=256, device=DEVICE)
        server = serve.PolicyServer(policy_fn=policy_fn, transform_obs_fn=transform, window_size=window, max_batch=8,
                                    batch_wait_ms=20.0, reload_fn=load_latest)
        httpd = server.make_http_server("127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            t0 = time.perf_counter()
            warmed = server.warmup(transform(np.zeros((256, 256, 3), np.uint8)))
            sync()
            emit("serve_warmup", shapes=len(warmed), seconds=time.perf_counter() - t0)
            check(warmed == [(w, b) for w in range(1, window + 1) for b in (1, 2, 4, 8)], f"warmup covered {warmed}")

            rng = np.random.default_rng(SEED)
            frames = rng.integers(0, 256, size=(sessions, steps, 256, 256, 3), dtype=np.uint8)
            rewards = rng.uniform(0, 1, size=(sessions, steps))
            barrier = threading.Barrier(sessions)
            for fn in counters.values():
                fn.launches = 0

            def episode(s):
                """One client: its requests, and a shadow of the session's window for the direct forward."""
                sid = post(url + "/v1/session", {"return_to_go": 10.0, "scale": 10.0})["session_id"]
                shadow = serve.PolicySession(window, 10.0, 10.0)
                log = []
                for t in range(steps):
                    reward = float(rewards[s, t]) if t else None
                    body = json.dumps({"session_id": sid, "observation": frames[s, t].tolist(), "reward": reward}).encode()
                    barrier.wait()  # the sessions' step-t requests leave together
                    t1 = time.perf_counter()
                    req = urllib.request.Request(url + "/v1/act", data=body, headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=300) as resp:
                        out = json.loads(resp.read())
                    latency = time.perf_counter() - t1
                    shadow.push(transform(frames[s, t]).cpu().numpy(), reward)
                    log.append((shadow.inputs(), out["action"], latency, out["rtg"], shadow.rtg * shadow.scale))
                    shadow.record_action(out["action"])
                post(url + "/v1/session/close", {"session_id": sid})
                return log

            t0 = time.perf_counter()
            with ThreadPoolExecutor(sessions) as pool:
                logs = list(pool.map(episode, range(sessions)))
            seconds = time.perf_counter() - t0
            launches = launch_counts(counters)
            health = json.loads(urllib.request.urlopen(url + "/v1/health", timeout=60).read())
            wrong = 0
            for log in logs:
                for inputs, action, _, rtg, shadow_rtg in log:
                    wrong += int(policy_fn(inputs)[0]) != action or abs(rtg - shadow_rtg) > 1e-4
            latencies = sorted(lat for log in logs for _, _, lat, _, _ in log)
            emit("serve", requests=sessions * steps, sessions=sessions, client_threads=sessions, seconds=seconds,
                 requests_per_s=sessions * steps / seconds, latency_ms_median=latencies[len(latencies) // 2] * 1e3,
                 latency_ms_max=latencies[-1] * 1e3, actions_differing_from_direct_forward=wrong, launches=launches,
                 batching=health["batching"], payload="a 256 x 256 x 3 frame as nested JSON lists, about 0.7 MB a request")
            check(wrong == 0, f"{wrong} served actions differ from the direct greedy_action on the session's window")
            check(health["batching"]["mean_batch_occupancy"] > 1 and health["batching"]["batched_requests"] == sessions * steps,
                  f"no batching: {health['batching']}")
            check(launches["flash_attn_fwd"] > 0 and launches["int8_gemm"] > 0, f"the requests launched {launches}")
            check(health["sessions"] == 0 and "checkpoint" not in health, f"health after the episodes: {health}")

            # other weights, saved as a checkpoint, reloaded while the server runs
            first = [log[0][0] for log in logs]
            old_actions = [log[0][1] for log in logs]
            for seed in range(SEED + 1, SEED + 6):  # seeded weights whose actions differ from the served ones
                torch.manual_seed(seed)
                other = policy_lib.ARPDT(keep["cfg"], num_actions=15, patch_dim=16, pt_variables=keep["pt"],
                                         frozen_qpack=keep["qpack"]).to(DEVICE).eval()
                with torch.inference_mode():
                    new_actions = [int(other.greedy_action(inputs)[0]) for inputs in first]
                if new_actions != old_actions:
                    break
            serve.save_policy_state(ckpt_dir, 7, other)
            reloaded = post(url + "/v1/reload", {})
            served = []
            for s in range(sessions):
                sid = post(url + "/v1/session", {"return_to_go": 10.0, "scale": 10.0})["session_id"]
                served.append(post(url + "/v1/act", {"session_id": sid, "observation": frames[s, 0].tolist()})["action"])
            health = json.loads(urllib.request.urlopen(url + "/v1/health", timeout=60).read())
            emit("serve_reload", reloaded=reloaded, health_step=health.get("checkpoint", {}).get("step"),
                 actions_before=old_actions, actions_after=served, actions_of_the_new_weights=new_actions)
            check(reloaded == {"status": "reloaded", "step": 7} and health["checkpoint"]["step"] == 7, f"reload: {reloaded} {health}")
            check(served == new_actions, f"after the reload the server gives {served}, the new weights {new_actions}")
            check(served != old_actions, "the reload changed no action")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    return launches


# --- ARP-DT+: the adapter's fine-tuning step and the clip_ft reward engine --------------------------

FT_CLIP = "vit_b16"  # the flagship configuration: arp_tpu/finetune/train.py:30-49
FT_BATCH, FT_CPU_BATCH = 32, 4  # quadruples a step; the CPU run's share
FT_FRAME = 512  # the quadruple dataset's default image_size (arp_tpu/finetune/dataset.py:35)
FT_LR = FT_WD = 1e-4
FT_ACTIONS = 15
FT_WARMUP, FT_TIMED = 2, 5
FT_TEXT = "the goal is to collect the coin."
FT_LABEL_FRAMES, FT_ROWS, FT_BATCH_LABEL = LABEL_FRAMES, LABEL_ROWS, BATCH  # slice_ft: the labeling phases' demo group
# The card's step against the CPU's on the same weights, quadruples and jitter draw (float32 on both,
# sums in other orders; K1's float32 body against the plain attention, ~1e-6): the loss within 1e-4
# relative; the gradients within 1e-4 of the largest entry, outside the rows of the adapter units
# whose ReLU input changed sign between the two runs (at most FT_MAX_FLIPPED_UNITS of them: such a
# unit's row takes another gradient, a difference no tolerance bounds, as in the train phase); after
# one AdamW step the parameters within 1e-5 of the largest entry, outside those rows and the entries
# whose gradient the two runs do not give to a tenth of itself: Adam's first step moves an entry by
# lr * g / (|g| + 1e-8), +-lr on the sign of g alone, so a gradient near 0 whose sign the sums'
# order decides moves its entry by 2 lr (2e-4) more on one side than on the other.
FT_LOSS_REL, FT_GRAD_REL, FT_PARAM_REL, FT_MAX_FLIPPED_UNITS = 1e-4, 1e-4, 1e-5, 8
FT_RELU_LINEARS = tuple(f"{m}.Dense_{k}" for m in ("image_adapter", "text_adapter", "inverse_layer") for k in (0, 1))
# slice_ft's engines: label -> ClipFtRewardEngine knobs (its packed trunk is bf16 in every mode)
FT_MODES = {
    "module_f32": {},
    "fast_f32_scores": dict(fast_encode=True, fast_score_bf16=False),
    "fast_bf16": dict(fast_encode=True),
    "fast_int8": dict(fast_int8=True),
}


def random_adapter_variables(cfg: dict, hidden_dim: int, action_dim: int, seed: int) -> dict:
    """Random ClipMultiscaleAdapter params in arp_tpu's Flax layout, from a numpy seed: the adapters'
    kernels xavier-uniform with zero biases and the intermediate projections lecun-normal, as Flax
    initializes them; the scalars at their initial values."""
    rng = np.random.default_rng(seed)
    L, dv, dt, e = cfg["text_num_layers"], cfg["vision_features"], cfg["text_features"], cfg["embed_dim"]
    hid = hidden_dim or 2 * e
    feat = dt * L + e

    def lecun(n_in, n_out):
        return {"kernel": np.clip(rng.standard_normal((n_in, n_out), dtype=np.float32), -2, 2) * np.float32(
            n_in ** -0.5 / 0.87962566103423978)}

    def mlp(n_in, n_hidden, n_out):
        out = {}
        for k, (a, b) in enumerate(((n_in, n_hidden), (n_hidden, n_out))):
            limit = np.float32(np.sqrt(6.0 / (a + b)))
            out[f"Dense_{k}"] = {"kernel": rng.uniform(-limit, limit, (a, b)).astype(np.float32),
                                 "bias": np.zeros(b, np.float32)}
        return out

    return {"params": {
        "image_intermediate_linear": lecun(dv * L, dt * L), "text_intermediate_linear": lecun(dt * L, dt * L),
        "image_adapter": mlp(feat, hid * (L + 1), feat), "text_adapter": mlp(feat, hid * (L + 1), feat),
        "inverse_layer": mlp(4 * feat, hid, action_dim),
        "image_residual_weight": np.float32(4.0), "text_residual_weight": np.float32(4.0),
        "lambda_id": np.float32(np.log(1 / 0.07)),
    }}


def quadruples(n: int, size: int, tokens: np.ndarray, seed: int) -> dict:
    """A fine-tuning batch as ProcgenActionDataset's loader gives it: four (n, size, size, 3) uint8 frames,
    the instruction's tokens (n, 1, 77), r and the action."""
    rng = np.random.default_rng(seed)
    batch = {f"image{i}": {"ob": rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)} for i in range(4)}
    batch["instruct"] = np.repeat(np.asarray(tokens, np.int32)[None], n, axis=0)
    batch["r"] = rng.integers(0, 2, size=(n, 1)).astype(np.int32)
    batch["action"] = rng.integers(0, FT_ACTIONS, size=(n,)).astype(np.int64)
    return batch


def on_device(tree, device):
    return {k: on_device(v, device) if isinstance(v, dict) else torch.from_numpy(np.asarray(v)).to(device)
            for k, v in tree.items()}


def ft_clip(cfg: dict, state: dict, device):
    from arp_tpu_torch.models.clip import CLIP

    clip = CLIP(**cfg, image_size=224)
    clip.load_state_dict(state)
    return clip.eval().requires_grad_(False).to(device)


def ft_adapter(cfg: dict, adapter_state: dict, device):
    from arp_tpu_torch.finetune.adapter_model import ClipMultiscaleAdapter

    adapter = ClipMultiscaleAdapter(clip_config=cfg, action_dim=FT_ACTIONS)
    adapter.load_state_dict(adapter_state)
    return adapter.to(device)


def ft_step_on(device, cfg, clip_state, adapter_state, batch, draws) -> dict:
    """One fine-tuning step of the CLI's pieces on ``device`` with given draws: the loss, every gradient,
    the ReLU Linears' outputs and the parameters after one AdamW step, on the host."""
    from arp_tpu_torch.finetune.train import build_optimizer
    from arp_tpu_torch.parallel.step import TrainState

    clip, adapter = ft_clip(cfg, clip_state, device), ft_adapter(cfg, adapter_state, device)
    pre, hooks = {}, []

    def note(mod, inp, out, name):  # an AdapterMLP's ReLU inputs, from its input and (not yet updated) weights
        with torch.no_grad():
            x = inp[0]
            for k in range(mod.num_layers):
                x = torch.nn.functional.linear(x, getattr(mod, f"Dense_{k}").weight, getattr(mod, f"Dense_{k}").bias)
                pre[f"{name}.Dense_{k}"] = x.cpu()
                x = torch.relu(x)

    for name in ("image_adapter", "text_adapter", "inverse_layer"):
        hooks.append(adapter.get_submodule(name).register_forward_hook(
            lambda mod, inp, out, name=name: note(mod, inp, out, name)))
    state = TrainState.create(adapter, build_optimizer(adapter, FT_LR, FT_WD))
    t0 = time.perf_counter()
    loss, metrics = adapter(clip, on_device(batch, device), train=True,
                            draws={"apply": draws["apply"].to(device),
                                   "jitter": {k: v.to(device) for k, v in draws["jitter"].items()}})
    loss.backward()
    grads = [p.grad.detach().clone() for _, p in state.params]
    state.apply_gradients(grads)
    sync()
    for h in hooks:
        h.remove()
    names = [n for n, _ in state.params]
    out = dict(loss=float(loss.detach()), names=names, grads=dict(zip(names, (g.cpu() for g in grads))),
               params={n: p.detach().cpu() for n, p in state.params}, pre=pre, seconds=time.perf_counter() - t0)
    del clip, adapter, state, grads
    return out


def compare_ft_step_with_cpu(cfg, clip_state, adapter_state, tokens) -> dict:
    """The card's fine-tuning step against the CPU's on FT_CPU_BATCH quadruples (see FT_LOSS_REL)."""
    from arp_tpu_torch.finetune.adapter_model import ClipMultiscaleAdapter

    small = quadruples(FT_CPU_BATCH, FT_FRAME, tokens, SEED + 1)
    draws = ClipMultiscaleAdapter.draw_preprocess(torch.Generator().manual_seed(SEED))
    draws["apply"] = torch.tensor(True)  # the jitter applied, so that both runs go through it
    cpu = ft_step_on("cpu", cfg, clip_state, adapter_state, small, draws)
    card = ft_step_on(DEVICE, cfg, clip_state, adapter_state, small, draws)
    gmax = max(float(g.abs().max()) for g in cpu["grads"].values())
    pmax = max(float(p.abs().max()) for p in cpu["params"].values())
    keep = {n: torch.ones_like(g, dtype=torch.bool) for n, g in cpu["grads"].items()}
    flipped = {}
    for name in FT_RELU_LINEARS:  # the units whose ReLU input changed sign for some row
        units = ((cpu["pre"][name] > 0) != (card["pre"][name] > 0)).any(0)
        flipped[name] = int(units.sum())
        keep[f"{name}.weight"][units] = False
        keep[f"{name}.bias"][units] = False
    grad_err = {n: float(((cpu["grads"][n] - card["grads"][n]).abs() * keep[n]).max()) / gmax for n in cpu["names"]}
    settled = {n: ((g - card["grads"][n]).abs() * 10 <= g.abs()) & keep[n] for n, g in cpu["grads"].items()}
    param_err = {n: float(((cpu["params"][n] - card["params"][n]).abs() * settled[n]).max()) / pmax
                 for n in cpu["names"]}
    worst_g, worst_p = max(grad_err, key=grad_err.get), max(param_err, key=param_err.get)
    result = dict(quadruples=FT_CPU_BATCH, loss_cpu=cpu["loss"], loss_card=card["loss"],
                  loss_rel_err=abs(cpu["loss"] - card["loss"]) / abs(cpu["loss"]), grad_max_abs=gmax,
                  grad_err_rel_to_max=grad_err[worst_g], worst_grad=worst_g, param_max_abs=pmax,
                  param_err_rel_to_max=param_err[worst_p], worst_param=worst_p, relu_units_flipped=flipped,
                  entries_left_out_for_flips=sum(int((~m).sum()) for m in keep.values()),
                  entries_left_out_unsettled_grad=sum(int((~s).sum()) for s in settled.values()),
                  param_entries=sum(p.numel() for p in cpu["params"].values()), cpu_seconds=cpu["seconds"])
    emit("finetune_vs_cpu", **result)
    check(result["loss_rel_err"] <= FT_LOSS_REL, f"finetune step loss: card vs CPU {result['loss_rel_err']} relative")
    check(sum(flipped.values()) <= FT_MAX_FLIPPED_UNITS,
          f"finetune step: {sum(flipped.values())} adapter units flipped their ReLU, more than {FT_MAX_FLIPPED_UNITS}")
    check(result["grad_err_rel_to_max"] <= FT_GRAD_REL,
          f"finetune step gradients: card vs CPU {result['grad_err_rel_to_max']} of the largest entry ({worst_g})")
    check(result["param_err_rel_to_max"] <= FT_PARAM_REL,
          f"finetune step params after AdamW: card vs CPU {result['param_err_rel_to_max']} of the largest ({worst_p})")
    return result


def ft_tokens() -> np.ndarray:
    """FT_TEXT's (1, 77) tokens, as the dataset and the engine tokenize it."""
    from arp_tpu_torch.models.clip.tokenizer import build_tokenizer

    return np.asarray(build_tokenizer(truncate=True)(FT_TEXT))


def ft_weights():
    """The flagship CLIP and adapter weights from the seed, through the two bridges, with the tokens of FT_TEXT."""
    from arp_tpu_torch.finetune.convert import flax_adapter_to_torch
    from arp_tpu_torch.models.clip import CONFIGS, flax_to_torch

    cfg = CONFIGS[FT_CLIP]
    clip_state = flax_to_torch(random_clip_variables(cfg, 224, SEED))
    adapter_state = flax_adapter_to_torch(random_adapter_variables(cfg, 0, FT_ACTIONS, SEED + 1))
    return cfg, clip_state, adapter_state, ft_tokens()


def phase_finetune(counters, weights) -> dict:
    """The ARP-DT+ fine-tuning step at the flagship widths through the CLI's functions; returns each kernel's
    launches over the timed steps."""
    from arp_tpu_torch.finetune.train import build_optimizer, make_loss_fn
    from arp_tpu_torch.parallel.step import TrainState, make_train_step

    cfg, clip_state, adapter_state, tokens = weights
    compared = compare_ft_step_with_cpu(cfg, clip_state, adapter_state, tokens)
    clip, adapter = ft_clip(cfg, clip_state, DEVICE), ft_adapter(cfg, adapter_state, DEVICE)
    state = TrainState.create(adapter, build_optimizer(adapter, FT_LR, FT_WD))
    step = make_train_step(make_loss_fn(clip, train=True))
    batch = on_device(quadruples(FT_BATCH, FT_FRAME, tokens, SEED + 2), DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    before = {n: p.detach().clone() for n, p in state.params}
    for _ in range(FT_WARMUP):
        step(state, batch, gen)
    sync()
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(FT_TIMED):
        t0 = time.perf_counter()
        _, aux = step(state, batch, gen)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated() if DEVICE != "cpu" else None
    ms = float(np.median(times))
    # one more step split into the preprocessing, the frozen CLIP's encodes and the rest (the adapter's
    # forward and backward, AdamW), each part synced on the host clock
    split = defaultdict(float)

    def timed(part, fn):
        def run(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            split[part] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    adapter.preprocess = timed("preprocess_ms", adapter.preprocess)
    clip.encode_image = timed("clip_encode_ms", clip.encode_image)
    clip.encode_text = timed("clip_encode_ms", clip.encode_text)
    t0 = time.perf_counter()
    step(state, batch, gen)
    sync()
    split["adapter_forward_backward_adamw_ms"] = (time.perf_counter() - t0) * 1e3 - split["preprocess_ms"] - split[
        "clip_encode_ms"]
    del adapter.preprocess, clip.encode_image, clip.encode_text
    loss = float(aux["loss"])
    check(np.isfinite(loss), f"finetune: loss {loss}")
    still = [n for n, p in state.params if torch.equal(before[n], p.detach())]
    check(not still, f"finetune: parameters that did not move: {still}")
    check(all(p.grad is None for p in clip.parameters()), "finetune: a CLIP parameter has a gradient")
    k1_step = cfg["vision_num_layers"] + cfg["text_num_layers"]  # one vision call of 3B rows, one text call
    check(launches["flash_attn_fwd"] == FT_TIMED * k1_step and launches["int8_gemm"] == 0,
          f"finetune: launches {launches} over {FT_TIMED} steps, expected K1 {FT_TIMED * k1_step}, K2 0")
    emit("finetune", clip=FT_CLIP, quadruples=FT_BATCH, frame=FT_FRAME, encoded_frames=3 * FT_BATCH,
         ms=ms, step_ms=times, quadruples_per_s=FT_BATCH / ms * 1e3, peak_memory_bytes=peak, loss=loss,
         launches=launches, trained_params=sum(p.numel() for _, p in state.params), **split,
         vs_cpu={k: compared[k] for k in ("loss_rel_err", "grad_err_rel_to_max", "param_err_rel_to_max",
                                          "relu_units_flipped")})
    emit("profile", mode="finetune", frames=4 * FT_BATCH, **device_profile(lambda: step(state, batch, gen)))
    del clip, adapter, state, step, batch, before
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return launches


def phase_slice_ft(counters, weights, label_group, vit_infer) -> dict:
    """The clip_ft engine on the labeling demo group in four modes, each against a CPU engine of the same
    mode; the F2 measurement on fast_int8; returns each kernel's launches over the labeling runs."""
    from arp_tpu_torch.finetune.reward import ClipFtRewardEngine
    from arp_tpu_torch.models.clip import CLIP

    cfg, clip_state, adapter_state, _ = weights
    g_src = demo_group(FT_LABEL_FRAMES, 2, 256, SEED)
    rows = FT_ROWS
    frames = np.asarray(g_src["ob"][:, -1])
    frames8 = frames[rows]

    adapters = {device: ft_adapter(cfg, adapter_state, device) for device in ("cpu", DEVICE)}  # built once

    def engine(device, batch_size, **knobs):
        model = CLIP(**cfg, image_size=224)
        model.load_state_dict(clip_state)
        return ClipFtRewardEngine(adapter_state, model=model, clip_config=cfg, batch_size=batch_size, device=device,
                                  adapter=adapters[device], **knobs)

    totals = dict.fromkeys(counters, 0)
    for label, knobs in FT_MODES.items():
        cpu = engine("cpu", len(rows), **knobs)
        want = cpu.text_rewards(frames8, FT_TEXT)  # an int8 engine calibrates on these frames
        del cpu
        eng = engine(DEVICE, FT_BATCH_LABEL, **knobs)
        eng.text_rewards(frames8, FT_TEXT)  # the same first batch: the rows, padded with the last one
        g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
        sync()
        for fn in counters.values():
            fn.launches = 0
        stats = label_group(g, FT_TEXT, eng, model_type="clip_ft", progress=False)
        launches = launch_counts(counters)
        reward = np.asarray(g["ob_clip_ft_reward"])
        mae = float(np.abs(reward[rows, -1] - want).mean())
        # module_f32: BASELINE.json's float32 target.  The packed trunk is bf16 in every other mode (its
        # softmax float32 in K1 on the card whatever the score dtype): the bf16 bound of the slice_fast
        # phase; fast_int8 the int8 bound of slice_fast (one integer arithmetic, with the bf16 roundings
        # that differ between the card and the CPU moving values across an int8 edge)
        bound = F32_REWARD_MAE if label == "module_f32" else (
            INT8_COS_MAE if "int8" in label else BF16_COS_MAE) * eng.logit_scale
        emit("slice_ft", mode=label, knobs={k: str(v) for k, v in knobs.items()}, frames=stats["frames"],
             seconds=stats["seconds"], fps=stats["fps"], batch_size=FT_BATCH_LABEL, launches=launches,
             reward_mae_vs_cpu=mae, mae_bound=bound, reward_mean=float(reward[:, -1].mean()),
             reward_std=float(reward[:, -1].std()), recipe=eng.encode_recipe)
        check(reward.shape == (FT_LABEL_FRAMES, 2) and np.isfinite(reward).all(), f"slice_ft {label}: rewards")
        check(launches["flash_attn_fwd"] > 0, f"slice_ft {label}: labeling never launched K1")
        check((launches["int8_gemm"] > 0) == ("int8" in label), f"slice_ft {label}: K2 launches {launches['int8_gemm']}")
        check(mae <= bound, f"slice_ft {label}: reward MAE vs the CPU engine {mae} > {bound}")
        for name, n in launches.items():
            totals[name] += n
        g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
        emit("profile", mode=f"slice_ft_{label}", frames=FT_LABEL_FRAMES,
             **device_profile(lambda: label_group(g, FT_TEXT, eng, model_type="clip_ft", progress=False)))
        if label == "fast_int8":
            f2_measurement(eng, frames, want, rows, vit_infer)
        del eng
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    del adapters
    return totals


def f2_measurement(eng, frames, want, rows, vit_infer) -> dict:
    """ROADMAP's F2: the calibrated fast_int8 trunk on the card twice on the same frames, once through K2
    (its quick-GELU with ex2.approx / rcp.approx) and once through K2's plain version on the card's
    tensors, called in K2's place for this check only; the reward MAE between the two runs, and each
    run's against the CPU engine on the rows it recomputed."""
    with_k2 = eng.text_rewards(frames, FT_TEXT)
    before = vit_infer.fused_int8_matmul.launches
    with plain_kernels(k1=False):
        with_plain = eng.text_rewards(frames, FT_TEXT)
    check(vit_infer.fused_int8_matmul.launches == before, "F2: the plain run launched K2")
    result = dict(frames=len(frames), k2_vs_plain_on_card_mae=float(np.abs(with_k2 - with_plain).mean()),
                  k2_vs_plain_on_card_max=float(np.abs(with_k2 - with_plain).max()),
                  k2_vs_cpu_mae=float(np.abs(with_k2[rows] - want).mean()),
                  plain_on_card_vs_cpu_mae=float(np.abs(with_plain[rows] - want).mean()), rows=len(rows))
    emit("f2", **result)
    return result


# --- stage 5: rollout eval with on-the-fly rewards ---------------------------------------------------

ROLLOUT_EPISODE_LEN = 64  # steps an episode: the flagship's 500 (jobs/train_procgen.sh:37) cut to fit the run
ROLLOUT_ENVS = 10  # the flagship's num_test_episodes: one wave of eval_parallel_envs=10
ROLLOUT_SEQ_EPISODES = 2  # the sequential batch_rollout: one env, two episodes
ROLLOUT_FT_STEPS = 16  # the clip_ft rollout: ROLLOUT_ENVS envs for this many steps
ROLLOUT_PROFILE_STEPS = 8  # the profiled window: ROLLOUT_ENVS envs for this many steps
ROLLOUT_CPU_ENVS, ROLLOUT_CPU_STEPS = 4, 6  # the card against the CPU, float32 towers
ROLLOUT_RETURN_TO_GO = 1000.0  # the dataset stand-in's return-to-go (the JAX default when a dataset has none)
ROLLOUT_ENGINE_BATCH = 64  # the reward engine's batch in build_test_step (arp_tpu_torch/train/common.py)
# The card's greedy action must be the CPU's wherever the CPU's two largest logits are further apart
# than this (float32 towers on both: sums in other orders through 12 layers, ~1e-5 on the logits).
# Each step's rewards must agree within BASELINE.json's 1e-4 (F32_REWARD_MAE, on every reward); the
# rtg windows then within steps * (1e-4 / scale + a float32 ulp of the first rtg) (rollout_rtg_atol).
ROLLOUT_MARGIN = 1e-3
# One rollout step's policy logits through the kernels against the same step with K1 and K2 replaced by
# their plain versions on the card: only the kernels' own roundings differ (K1 within K1_ATOL, K2 within
# one bf16 ulp, which can move an int8 value one step).  The card against the CPU in frozen_int8, which
# has those and every other rounding, gives a cosine of 0.9998 (the policy phase); a wrong tile or row
# at the rollout's shapes gives an env's logits far off.  Each env's logits: cosine at least this.
ROLLOUT_PLAIN_MIN_COSINE = 0.999


def rollout_rtg_atol(scale: float, steps: int, first_rtg: float) -> float:
    return steps * (F32_REWARD_MAE / scale + float(np.spacing(np.float32(first_rtg))))


class RolloutDataset:
    """What build_test_step reads of the training dataset (return_to_go, scale, reward_min), in memory:
    the card's machine has no h5py."""

    return_to_go = ROLLOUT_RETURN_TO_GO
    reward_min = 0.0

    def __init__(self):
        from arp_tpu_torch.data.procgen_dataset import compute_scale

        self.scale = compute_scale(self.return_to_go)

    def tokenizer(self, text):
        raise RuntimeError("use_text is off on the flagship configuration")


def write_engine_spec(path: str, variables: dict, cfg: dict, image_size: int) -> str:
    """An engine spec (config, tokenizer tag, image size and the Flax variables flattened by "/"), for
    ``--vl_checkpoint <spec>.npz``: written by the port's ClipRewardEngine.save_npz, in the JAX package's
    layout."""
    from arp_tpu_torch.models.clip import CLIP
    from arp_tpu_torch.reward.engine import ClipRewardEngine

    ClipRewardEngine(model=CLIP(**cfg, image_size=image_size), variables=variables, batch_size=1,
                     device="cpu").save_npz(path)
    return path


def rollout_flags(spec: str, mode: dict, **over):
    """The trainer's flags at the flagship configuration (jobs/train_procgen.sh:29-38) with a fake-env
    rollout eval whose rewards come from ``spec``."""
    from arp_tpu_torch.config import Config
    from arp_tpu_torch.models.policy import get_policy_default_config
    from arp_tpu_torch.train.main import flag_defaults

    flags = Config(flag_defaults())
    flags.update(dict(game_name="coinrun", use_vl=True, vl_type="clip", vl_checkpoint=spec, eval_env="fake",
                      window_size=POLICY_WINDOW, episode_length=ROLLOUT_EPISODE_LEN, num_test_episodes=ROLLOUT_ENVS,
                      eval_parallel_envs=ROLLOUT_ENVS, patch_dim=16, device=DEVICE), **over)
    flags.model = get_policy_default_config(dict(POLICY_CFG, m3ae=M3AE_CFG, **mode))
    return flags


def clone_inputs(batch: dict) -> dict:
    return {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                else v.clone() if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}


class RolloutMeter:
    """While in place, times the policy's forwards and the engine's encodes (each synced) on ``model`` and
    ``engine``, and notes each policy call's envs and newest rtg."""

    def __init__(self, model, engine, keep=()):
        self.ms = {"policy_ms": 0.0, "reward_ms": 0.0}
        self.calls, self.env_steps, self.rtg = 0, 0, []
        self.keep, self.kept = keep, []  # copies of the inputs of the policy calls numbered in ``keep`` (from 1)
        self._undo = [(model, "greedy_action")]
        self._wrap(model, "greedy_action", "policy_ms", note=True)
        if engine is not None:
            for name in ("encode_text_features", "_batched_image_features"):
                self._wrap(engine, name, "reward_ms")
                self._undo.append((engine, name))

    def _wrap(self, obj, name, field, note=False):
        real = getattr(obj, name)

        def run(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            sync()
            self.ms[field] += (time.perf_counter() - t0) * 1e3
            if note:
                batch = args[0]
                self.calls += 1
                self.env_steps += int(batch["action"].shape[0])
                self.rtg.append(batch["rtg"]["ob"][:, -1, 0].float().cpu().numpy().copy())  # the window rolls in place
                if self.calls in self.keep:
                    self.kept.append(clone_inputs(batch))
            return out

        setattr(obj, name, run)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for obj, name in self._undo:
            delattr(obj, name)  # the class's method again

    def summary(self, wall_ms: float) -> dict:
        rtg = np.concatenate(self.rtg) if self.rtg else np.zeros(0)
        return dict(policy_calls=self.calls, env_steps=self.env_steps, wall_ms=wall_ms,
                    steps_per_s=self.calls / wall_ms * 1e3, env_steps_per_s=self.env_steps / wall_ms * 1e3,
                    ms_a_step=wall_ms / max(self.calls, 1),
                    policy_ms_a_step=self.ms["policy_ms"] / max(self.calls, 1),
                    reward_ms_a_step=self.ms["reward_ms"] / max(self.calls, 1),
                    env_and_transform_ms_a_step=(wall_ms - self.ms["policy_ms"] - self.ms["reward_ms"])
                    / max(self.calls, 1),
                    rtg_first=float(rtg[0]) if rtg.size else None, rtg_min=float(rtg.min()) if rtg.size else None,
                    rtg_max=float(rtg.max()) if rtg.size else None)


def rollout_policy(flags, pt, trained, qpack, small, device):
    """The flagship ARPDT of ``flags`` on ``device`` through the trainer's build_model: the frozen tower
    ``pt``, the trained weights ``trained`` (None: the seed's own, returned)."""
    from arp_tpu_torch.train.common import build_model

    torch.manual_seed(SEED)
    model = build_model(flags, 15, frozen_qpack=qpack, pt_variables=pt).to(device).eval()
    with torch.no_grad():
        model(small, deterministic=True)  # the lazy layers take their shapes
        if trained is not None:
            model.load_trained_state_dict(trained)
    return model


def metered_rollout(label, model, engine, counters, shapes, run, keep=(), **info) -> tuple[dict, list]:
    """``run()`` (a rollout, returning its metric and what else to record) once with the policy's forwards
    and the engine's encodes timed, the kernels' launches counted from 0 and their shapes noted in
    ``shapes`` (a LaunchShapes); checks the metrics and that
    the rtg moved, emits the record; returns the launches and copies of the inputs of the policy calls
    numbered in ``keep``."""
    with RolloutMeter(model, engine, keep) as meter, shapes:
        sync()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        metric, extra = run()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        launches = launch_counts(counters)
    record = dict(run=label, **info, **extra, metric={k: float(v) for k, v in metric.items()}, launches=launches,
                  recipe=engine.encode_recipe, **meter.summary(wall))
    check(all(np.isfinite(v) for v in record["metric"].values()), f"rollout {label}: metrics {record['metric']}")
    check(record["rtg_min"] < record["rtg_first"] or record["rtg_max"] > record["rtg_first"],
          f"rollout {label}: the rtg trace never moved from {record['rtg_first']}")
    emit("rollout", **record)
    return launches, meter.kept


def run_test_step(label, flags, model, counters, shapes, keep=()):
    """One call of build_test_step's eval at ``flags`` with ``model`` on the card, metered; returns (its
    launches, the engine build_test_step built, the instruction it scores against, the kept inputs)."""
    from arp_tpu_torch.ops.augment import make_eval_transform
    from arp_tpu_torch.train import common

    built = []
    real = common.build_reward_engine
    common.build_reward_engine = lambda *a, **k: built.append(real(*a, **k)) or built[-1]
    try:
        transform = make_eval_transform(image_size=common.model_image_size(flags), device=DEVICE)
        step_fn = common.build_test_step(flags, model, RolloutDataset(), transform, False, device=DEVICE)
    finally:
        common.build_reward_engine = real
    engine, text = built[0]
    check(engine is not None, f"rollout {label}: no reward engine: a rollout with a constant rtg proves nothing")

    def run():
        metric, _, videos = step_fn(model, SEED)
        return metric, {"videos": len(videos)}

    launches, kept = metered_rollout(label, model, engine, counters, shapes, run, keep, envs=flags.eval_parallel_envs or 1,
                                     episodes=flags.num_test_episodes, episode_length=flags.episode_length, text=text)
    return launches, engine, text, kept


def hold_against_plain(label, model, steps, counters) -> dict:
    """The policy's forward on the rollout inputs ``steps`` through the kernels, and again with K1 and K2
    replaced by their plain versions on the same device; each env's logits (every slot) compared."""
    with torch.no_grad():
        got = [model(x, deterministic=True)["action_pred"].float() for x in steps]
        before = launch_counts(counters)
        with plain_kernels():
            want = [model(x, deterministic=True)["action_pred"].float() for x in steps]
        check(launch_counts(counters) == before, f"rollout {label} vs plain: the plain run launched a kernel")
    env_cos = [cosine(g[i], w[i]) for g, w in zip(got, want) for i in range(g.shape[0])]
    result = dict(run=label, windows=[int(x["action"].shape[1]) for x in steps], envs=int(got[0].shape[0]),
                  min_env_cosine=min(env_cos), bound=ROLLOUT_PLAIN_MIN_COSINE,
                  max_abs_err=max((g - w).abs().max().item() for g, w in zip(got, want)),
                  greedy_differing=sum(int((g[:, -1].argmax(-1) != w[:, -1].argmax(-1)).sum()) for g, w in zip(got, want)))
    emit("rollout_vs_plain", **result)
    check(result["min_env_cosine"] >= ROLLOUT_PLAIN_MIN_COSINE,
          f"rollout {label}: an env's logits through the kernels have cosine {result['min_env_cosine']} with the "
          f"plain versions' < {ROLLOUT_PLAIN_MIN_COSINE}")
    return result


def greedy_with_logits(model, inputs):
    with torch.no_grad():
        logits = model(inputs, deterministic=True)["action_pred"][:, -1, :].float()
    return logits.argmax(-1), logits


def compare_rollout_with_cpu(flags, pt, trained, small, spec, text) -> dict:
    """The float32 flagship rollout of ROLLOUT_CPU_ENVS envs for ROLLOUT_CPU_STEPS steps on the CPU, then on
    the card with the CPU's actions (so both see one trajectory): every step's rewards, every call's greedy
    action where the CPU's top-2 logit margin exceeds ROLLOUT_MARGIN, and the rtg windows.  The card's
    engine runs at build_test_step's batch; the CPU's at the envs' (the padding rows are scored by
    neither)."""
    from arp_tpu_torch.envs.fake import FakeProcgen
    from arp_tpu_torch.envs.rollout import parallel_rollout
    from arp_tpu_torch.ops.augment import make_eval_transform
    from arp_tpu_torch.reward.engine import ClipRewardEngine

    ds = RolloutDataset()
    runs = {}
    for side, device in (("cpu", "cpu"), ("card", DEVICE)):
        model = rollout_policy(flags, pt, trained, None, small, device)
        engine = ClipRewardEngine.from_npz(spec, batch_size=ROLLOUT_CPU_ENVS if side == "cpu" else ROLLOUT_ENGINE_BATCH,
                                           resize_mode="pil", use_crop=False, device=device)
        notes, rewards = [], []
        cpu_notes = runs.get("cpu")

        def scored(frames, txt_feat, real=engine.text_rewards_with_features, rewards=rewards):
            out = real(frames, txt_feat)
            rewards.append(np.array(out, copy=True))
            return out

        engine.text_rewards_with_features = scored

        def policy_fn(inputs, rngs):
            action, logits = greedy_with_logits(model, inputs)
            notes.append(dict(rtg=inputs["rtg"]["ob"].float().cpu().numpy().copy(), logits=logits.cpu().numpy(),
                              action=action.cpu().numpy()))
            # the card follows the CPU's trajectory, so that every later step compares like with like
            return action if cpu_notes is None else torch.from_numpy(cpu_notes[len(notes) - 1]["action"])

        t0 = time.perf_counter()
        parallel_rollout(rng=SEED, envs=[FakeProcgen("coinrun", {"episode_length": ROLLOUT_CPU_STEPS,
                                                                 "record_video": False})
                                         for _ in range(ROLLOUT_CPU_ENVS)],
                         policy_fn=policy_fn, transform_obs_fn=make_eval_transform(256, device=device),
                         episode_length=ROLLOUT_CPU_STEPS, window_size=flags.window_size,
                         return_to_go=ds.return_to_go, scale=ds.scale, reward_engine=engine, vl_type="clip",
                         text=text, use_crop=flags.use_crop, device=device)
        runs[side], runs[f"{side}_seconds"], runs[f"{side}_rewards"] = notes, time.perf_counter() - t0, rewards
        del model, engine
    cpu, card = runs["cpu"], runs["card"]
    check(len(cpu) == len(card) == ROLLOUT_CPU_STEPS, f"rollout vs cpu: {len(cpu)} and {len(card)} policy calls")
    check(len(runs["cpu_rewards"]) == len(runs["card_rewards"]) == ROLLOUT_CPU_STEPS,
          f"rollout vs cpu: {len(runs['cpu_rewards'])} and {len(runs['card_rewards'])} reward calls")
    reward_err = max(float(np.abs(g - c).max()) for c, g in zip(runs["cpu_rewards"], runs["card_rewards"]))
    rtg_atol = rollout_rtg_atol(ds.scale, ROLLOUT_CPU_STEPS, ds.return_to_go / ds.scale)
    decided = below = differ = 0
    rtg_err = logit_err = 0.0
    for c, g in zip(cpu, card):
        top2 = np.sort(c["logits"], axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        sure = margin > ROLLOUT_MARGIN
        decided += int(sure.sum())
        below += int((~sure).sum())
        differ += int((g["action"][sure] != c["action"][sure]).sum())
        rtg_err = max(rtg_err, float(np.abs(g["rtg"] - c["rtg"]).max()))
        logit_err = max(logit_err, float(np.abs(g["logits"] - c["logits"]).max()))
    rtg_moved = float(np.abs(cpu[-1]["rtg"][:, -1] - cpu[0]["rtg"][:, -1]).max())
    result = dict(envs=ROLLOUT_CPU_ENVS, steps=ROLLOUT_CPU_STEPS, engine_batch=ROLLOUT_ENGINE_BATCH,
                  env_steps_above_margin=decided, env_steps_below_margin=below, actions_differing_above_margin=differ,
                  margin=ROLLOUT_MARGIN, reward_max_abs_err=reward_err, reward_atol=F32_REWARD_MAE,
                  reward_range=[float(np.min(runs["cpu_rewards"])), float(np.max(runs["cpu_rewards"]))],
                  rtg_max_abs_err=rtg_err, rtg_atol=rtg_atol, rtg_moved=rtg_moved,
                  logits_max_abs_err=logit_err, cpu_seconds=runs["cpu_seconds"], card_seconds=runs["card_seconds"])
    emit("rollout_vs_cpu", **result)
    check(differ == 0, f"rollout vs cpu: {differ} greedy actions differ above the margin {ROLLOUT_MARGIN}")
    check(reward_err <= F32_REWARD_MAE, f"rollout vs cpu: rewards {reward_err} apart > {F32_REWARD_MAE}")
    check(rtg_err <= rtg_atol, f"rollout vs cpu: rtg windows {rtg_err} apart > {rtg_atol}")
    check(rtg_moved > 0, "rollout vs cpu: the rtg never moved")
    return result


def phase_rollout(counters, weights, policy_lib, flax_m3ae_to_torch) -> dict:
    """Stage 5 at the flagship configuration through build_test_step (jobs/train_procgen.sh:29-38: vit_base
    ARPDT over the frozen m3ae_vit_b16 tower, adapter, window 4, 15 actions; vl_type clip, rewards from a
    CLIP ViT-B/16 engine spec of random weights; 10 test episodes), on FakeProcgen at 64 x 64 with episodes
    cut to ROLLOUT_EPISODE_LEN steps: (a) the sequential batch_rollout, 1 env and 2 episodes, frozen_bf16;
    (b) one wave of 10 lockstep envs in frozen_bf16 and in frozen_int8; (c) 10 envs for ROLLOUT_FT_STEPS
    steps with the clip_ft engine on the fine-tuning phase's adapter; then one profiled window, and (d) the
    card against the CPU.  The steps of (b) at the first and the full window are held against the same
    steps through the kernels' plain versions.  Returns each kernel's launches over (a)-(c), and the
    shapes K1 and K2 ran at over (a)-(c) and the profiled window (LaunchShapes)."""
    import tempfile

    from arp_tpu_torch.envs.fake import FakeProcgen
    from arp_tpu_torch.envs.rollout import parallel_rollout
    from arp_tpu_torch.finetune.reward import ClipFtRewardEngine
    from arp_tpu_torch.models.clip import CLIP
    from arp_tpu_torch.ops.augment import make_eval_transform
    from arp_tpu_torch.train.common import maybe_build_frozen_qpack

    cfg, clip_state, adapter_state, _ = weights
    t0 = time.perf_counter()
    pt = flax_m3ae_to_torch(random_m3ae_variables(M3AE_DIMS, 16, BERT_VOCAB, SEED))
    raw, batch = policy_batch(2, POLICY_WINDOW, SEED)
    small = head_batch(batch, 1)
    totals = dict.fromkeys(counters, 0)
    keep = (1, POLICY_WINDOW)  # the policy calls held against the plain versions: the first and a full window
    shapes = LaunchShapes()  # in place over (a)-(c) and the profiled window only
    with tempfile.TemporaryDirectory() as tmp:
        spec = write_engine_spec(f"{tmp}/clip_{FT_CLIP}.npz", random_clip_variables(cfg, 224, SEED), cfg, 224)
        emit("rollout_setup", clip=FT_CLIP, spec_bytes=os.path.getsize(spec), policy=dict(POLICY_CFG, m3ae=M3AE_CFG),
             episode_length=ROLLOUT_EPISODE_LEN, envs=ROLLOUT_ENVS, seconds=time.perf_counter() - t0)
        flags = {name: rollout_flags(spec, mode) for name, mode in POLICY_MODES.items()}
        trained = rollout_policy(flags["float32"], pt, None, None, small, "cpu").trained_state_dict()

        bf16 = rollout_policy(flags["frozen_bf16"], pt, trained, None, small, DEVICE)
        seq = rollout_flags(spec, POLICY_MODES["frozen_bf16"], eval_parallel_envs=0,
                            num_test_episodes=ROLLOUT_SEQ_EPISODES)
        launches, _, text, _ = run_test_step("a_sequential_frozen_bf16", seq, bf16, counters, shapes)
        for name, n in launches.items():
            totals[name] += n
        launches, engine, _, kept = run_test_step("b_parallel_frozen_bf16", flags["frozen_bf16"], bf16, counters, shapes, keep)
        for name, n in launches.items():
            totals[name] += n
        hold_against_plain("b_parallel_frozen_bf16", bf16, kept, counters)
        qpack = maybe_build_frozen_qpack(flags["frozen_int8"], head_batch(raw, 2), use_goal=False, device=DEVICE,
                                         m3ae_loader=lambda name: pt)
        int8 = rollout_policy(flags["frozen_int8"], pt, trained, qpack, small, DEVICE)
        launches, _, _, kept = run_test_step("b_parallel_frozen_int8", flags["frozen_int8"], int8, counters, shapes, keep)
        for name, n in launches.items():
            totals[name] += n
        hold_against_plain("b_parallel_frozen_int8", int8, kept, counters)
        del int8, qpack, kept

        # (c) the clip_ft engine on the fine-tuning phase's adapter, as build_test_step builds it from a
        # --vl_checkpoint (module trunk, batch 64, the rollout crops on the host)
        clip = CLIP(**cfg, image_size=224)
        clip.load_state_dict(clip_state)
        ft = ClipFtRewardEngine(adapter_state, model=clip, clip_config=cfg, batch_size=ROLLOUT_ENGINE_BATCH,
                                use_crop=False, device=DEVICE)
        ds, env_conf = RolloutDataset(), {"episode_length": ROLLOUT_FT_STEPS, "record_video": False}
        common = dict(transform_obs_fn=make_eval_transform(256, device=DEVICE), window_size=POLICY_WINDOW,
                      return_to_go=ds.return_to_go, scale=ds.scale, text=text, use_crop=True, device=DEVICE)

        def greedy(inputs, rngs):
            return bf16.greedy_action(inputs)

        with torch.no_grad():
            launches, _ = metered_rollout(
                "c_parallel_clip_ft_frozen_bf16", bf16, ft, counters, shapes, lambda: (parallel_rollout(
                    rng=SEED, envs=[FakeProcgen("coinrun", dict(env_conf)) for _ in range(ROLLOUT_ENVS)],
                    policy_fn=greedy, episode_length=ROLLOUT_FT_STEPS, reward_engine=ft, vl_type="clip_ft",
                    **common), {}), envs=ROLLOUT_ENVS, episode_length=ROLLOUT_FT_STEPS)
        for name, n in launches.items():
            totals[name] += n
        del ft, clip

        # one profiled window of the lockstep eval (frozen_bf16, the CLIP engine of (b))
        with torch.no_grad(), shapes:
            emit("profile", mode="rollout_parallel_frozen_bf16", envs=ROLLOUT_ENVS, steps=ROLLOUT_PROFILE_STEPS,
                 **device_profile(lambda: parallel_rollout(
                     rng=SEED, envs=[FakeProcgen("coinrun", {"episode_length": ROLLOUT_PROFILE_STEPS,
                                                             "record_video": False}) for _ in range(ROLLOUT_ENVS)],
                     policy_fn=greedy, episode_length=ROLLOUT_PROFILE_STEPS, reward_engine=engine,
                     vl_type="clip", **common)))
        del bf16, engine
        emit("rollout_kernel_shapes", k1=dict(shapes.k1), k2=dict(shapes.k2))
        compare_rollout_with_cpu(flags["float32"], pt, trained, small, spec, text)
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return totals, shapes


# --- the reward server: reward/serve.py over the labeling engines -------------------------------------

SERVE_CLIP = "vit_b16"  # the reference's reward model
SERVE_IMAGE = 224
SERVE_REQUEST_FRAMES, SERVE_FRAME = 16, 64  # a rollout worker's request: 16 frames of 64 x 64 x 3
SERVE_CLIENTS = 4  # concurrent client threads
SERVE_CPU_FRAMES, SERVE_WARM_FRAMES = 4, 8  # the CPU engine's frames; the frames the servers warm up (int8: calibrate) on
SERVE_LABEL_FRAMES, SERVE_LABEL_SIZE = LABEL_FRAMES, 256  # the host-vs-pil labeling run: the slice's demo group
SERVE_TEXTS = ("the goal is to collect the coin.", ["the goal is to collect the coin.", "reach the end of the level."])
# label -> engine knobs; every mode on the engine batch of reward/serve.py
SERVE_MODES = {"f32_pil": dict(resize_mode="pil"), "f32_host": dict(resize_mode="host"),
               "fast_int8": dict(fast_int8=True)}
SERVE_FORMATS = ("lists", "b64", "raw")
# Served rewards against the direct engine call on the same frames: the same computation (bit-equal expected).
SERVED_ATOL = 1e-6


def serve_frames(n: int, seed: int) -> np.ndarray:
    """Real-like observations: FakeProcgen's rendered levels (a grid world's agent and goal blocks), n seeds."""
    from arp_tpu_torch.envs.fake import FakeProcgen

    env = FakeProcgen("coinrun", {"image_size": SERVE_FRAME, "record_video": False})
    return np.stack([env.reset(seed * 10_000 + i)["image"]["ob"] for i in range(n)])


def reward_request(kind: str, fmt: str, frames: np.ndarray, text=None, goal=None) -> tuple:
    """(path, body bytes, headers) of one reward request in one wire format."""
    import base64
    from urllib.parse import quote

    def b64(a):
        return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()

    if fmt == "raw":
        headers = {"X-Frames-Shape": ",".join(map(str, frames.shape))}
        body = frames.tobytes()
        if kind == "text":
            headers["X-Text"] = quote(text)
        elif goal is not None:
            headers["X-Goal-Shape"] = ",".join(map(str, goal.shape))
            body += goal.tobytes()
        return f"/v1/reward/{kind}_raw", body, headers
    payload = {"frames": frames.tolist()} if fmt == "lists" else {"frames_b64": b64(frames),
                                                                    "frames_shape": list(frames.shape)}
    if kind == "text":
        payload["text"] = text
    elif goal is not None:
        payload.update({"goal": goal.tolist()} if fmt == "lists" else {"goal_b64": b64(goal),
                                                                       "goal_shape": list(goal.shape)})
    return f"/v1/reward/{kind}", json.dumps(payload).encode(), {"Content-Type": "application/json"}


def serve_requests(client: int) -> list:
    """One client's requests: in each wire format a text request, a goal request with a goal and one
    without (the goal is then the last frame); raw text must be one string (X-Text)."""
    frames = serve_frames(SERVE_REQUEST_FRAMES * 3 * len(SERVE_FORMATS) + 1, SEED + 1 + client)
    out, k = [], 0
    for i, fmt in enumerate(SERVE_FORMATS):
        text = SERVE_TEXTS[0] if fmt == "raw" else SERVE_TEXTS[(client + i) % 2]
        for kind, goal in (("text", None), ("goal", frames[-1]), ("goal", None)):
            batch = frames[k: k + SERVE_REQUEST_FRAMES]
            k += SERVE_REQUEST_FRAMES
            out.append(dict(kind=kind, fmt=fmt, frames=batch, text=text if kind == "text" else None, goal=goal,
                            request=reward_request(kind, fmt, batch, text, goal)))
    return out


def drive_reward_server(server, url: str) -> tuple[list, float]:
    """SERVE_CLIENTS threads send their requests at once; returns [(request, rewards, latency s)], wall s."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    plans = [serve_requests(c) for c in range(SERVE_CLIENTS)]

    def client(plan):
        done = []
        for req in plan:
            path, body, headers = req["request"]
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(url + path, data=body, headers=headers),
                                        timeout=300) as resp:
                rewards = json.loads(resp.read())["rewards"]
            done.append((req, np.asarray(rewards, np.float32), time.perf_counter() - t0))
        return done

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        results = [r for done in pool.map(client, plans) for r in done]
    sync()
    return results, time.perf_counter() - t0


def direct_rewards(engine, req) -> np.ndarray:
    if req["kind"] == "text":
        out = engine.text_rewards(req["frames"], req["text"])
    elif req["goal"] is not None:
        out = engine.goal_rewards_vs(req["frames"], req["goal"])
    else:
        out = engine.goal_rewards(req["frames"], goal_index=-1)
    return np.asarray(out, np.float32)


def phase_reward_serve(counters, preprocess) -> tuple[dict, "LaunchShapes"]:
    """The reward server (reward/serve.py) at full CLIP ViT-B/16 width on 127.0.0.1, over engines at
    its batch of 64: float32 with the card's resize (pil), float32 with the host's (host), fast_int8 warmed
    (calibrated) on real-like frames.  SERVE_CLIENTS client threads send text requests in the three wire
    formats and goal requests with and without a goal, 16 frames of 64 x 64 each.  Every served reward
    against the direct engine call; each mode against a CPU engine of the same mode; host against pil; the
    host resize byte for byte; the ARPS reader on frames.  Then one labeling run of the slice's demo group
    with resize_mode "host" beside "pil".  Returns each kernel's launches over the server drives and the
    labeling runs, and the shapes K1 and K2 ran at over them (LaunchShapes)."""
    import tempfile
    import threading
    import urllib.request

    from arp_tpu_torch.data import arps
    from arp_tpu_torch.models.clip import CLIP, CONFIGS, flax_to_torch
    from arp_tpu_torch.reward.engine import ClipRewardEngine
    from arp_tpu_torch.reward.labeler import label_group
    from arp_tpu_torch.reward.serve import RewardServer

    cfg = CONFIGS[SERVE_CLIP]
    state = flax_to_torch(random_clip_variables(cfg, SERVE_IMAGE, SEED))

    def engine(device, batch_size, **knobs):
        model = CLIP(**cfg, image_size=SERVE_IMAGE)
        model.load_state_dict(state)
        return ClipRewardEngine(model=model, batch_size=batch_size, device=device, **knobs)

    # the host resize: the numpy reference's bytes, and the card's packed resize's
    rng = np.random.default_rng(SEED)
    for size in (SERVE_FRAME, SERVE_LABEL_SIZE):
        frames = rng.integers(0, 256, size=(8, size, size, 3), dtype=np.uint8)
        host = preprocess.resize_bicubic_pil_host(frames, SERVE_IMAGE, SERVE_IMAGE)
        ref = preprocess.resize_bicubic_pil_reference(frames, SERVE_IMAGE, SERVE_IMAGE)
        card = preprocess.resize_bicubic_pil_packed(torch.from_numpy(frames.reshape(8, size, size * 3)).to(DEVICE), 3,
                                                    SERVE_IMAGE, SERVE_IMAGE).cpu().numpy()
        diff_ref, diff_card = int((host != ref).sum()), int((host.reshape(card.shape) != card).sum())
        emit("host_resize", frames=list(frames.shape), out=[SERVE_IMAGE, SERVE_IMAGE], bytes_differing_from_reference=diff_ref,
             bytes_differing_from_card=diff_card)
        check(diff_ref == 0 and diff_card == 0, f"host resize {size}->{SERVE_IMAGE}: {diff_ref} bytes off the "
              f"reference, {diff_card} off the card's")

    warm = serve_frames(SERVE_WARM_FRAMES, SEED)
    probe = serve_frames(SERVE_CPU_FRAMES, SEED + 100)
    # the ARPS reader's library (linked with zlib) builds on this machine and reads back what was written
    with tempfile.TemporaryDirectory() as tmp:
        shard = os.path.join(tmp, "ob.arps")
        arps.write_arps(shard, np.concatenate([warm, probe]))
        reader = arps.ArpsReader(shard)
        back = reader.read_batch(np.arange(len(warm) + len(probe))[::-1])
        reader.close()
    emit("arps", records=len(back), library=str(arps.native_lib()._name))
    check(np.array_equal(back[::-1], np.concatenate([warm, probe])), "ARPS records read back differ")
    totals, shapes, served = dict.fromkeys(counters, 0), LaunchShapes(), {}
    for mode, knobs in SERVE_MODES.items():
        # the CPU engine of the same mode; an int8 one calibrated on the warm-up frames, as the card's server is
        int8 = bool(knobs.get("fast_int8"))
        cpu = engine("cpu", SERVE_WARM_FRAMES if int8 else SERVE_CPU_FRAMES, **knobs)
        if int8:
            cpu.encode_image_features(warm)
        want = cpu.text_rewards(probe, SERVE_TEXTS[0])
        del cpu
        eng = engine(DEVICE, SERVE_BATCH, **knobs)
        server = RewardServer(eng)
        t0 = time.perf_counter()
        server.warmup(warm)  # the warm-up frames pad to the batch with copies of the last: the same amaxes
        sync()
        warm_s = time.perf_counter() - t0
        httpd = server.make_http_server("127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            for fn in counters.values():
                fn.launches = 0
            with shapes:
                results, wall = drive_reward_server(server, url)
                launches = launch_counts(counters)
            health = json.loads(urllib.request.urlopen(url + "/v1/health", timeout=60).read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), f"{mode}: the server thread did not stop")
        served[mode] = [r for _, r, _ in results]
        off = max(float(np.abs(got - direct_rewards(eng, req)).max()) for req, got, _ in results)
        mae = float(np.abs(direct_rewards(eng, dict(kind="text", frames=probe, text=SERVE_TEXTS[0])) - want).mean())
        bound = INT8_COS_MAE * eng.logit_scale if int8 else F32_REWARD_MAE
        latencies = defaultdict(list)
        for req, _, seconds in results:
            latencies[f"{req['kind']}_{req['fmt']}"].append(seconds * 1e3)
            latencies["all"].append(seconds * 1e3)
        frames_served = sum(len(req["frames"]) for req, _, _ in results)
        emit("reward_serve", mode=mode, recipe=eng.encode_recipe, batch_size=SERVE_BATCH, clients=SERVE_CLIENTS,
             requests=len(results), frames=frames_served, seconds=wall, requests_per_s=len(results) / wall,
             frames_per_s=frames_served / wall, warmup_s=warm_s,
             latency_ms_median={k: float(np.median(v)) for k, v in latencies.items()},
             latency_ms_max=float(max(latencies["all"])), health=health,
             engine_busy_share=health["busy_seconds"] / wall, launches=launches,
             served_vs_direct_max_abs_err=off, served_bound=SERVED_ATOL, reward_mae_vs_cpu=mae, mae_bound=bound,
             cpu_frames=SERVE_CPU_FRAMES)
        check(all(np.isfinite(r).all() and r.shape == (SERVE_REQUEST_FRAMES,) for r in served[mode]),
              f"{mode}: served rewards not finite or of the wrong shape")
        check(health["frames_served"] == frames_served and health["cached_texts"] == len(SERVE_TEXTS),
              f"{mode}: health {health}")
        check(off <= SERVED_ATOL, f"{mode}: served rewards {off} from the direct engine call (bound {SERVED_ATOL})")
        check(mae <= bound, f"{mode}: reward MAE vs the CPU engine {mae} > {bound}")
        check(launches["flash_attn_fwd"] > 0, f"{mode}: the requests never launched K1")
        if int8:
            check(launches["int8_gemm"] > 0, f"{mode}: the requests never launched K2")
        for name, n in launches.items():
            totals[name] += n
        del eng, server
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    differ = sum(int((a != b).sum()) for a, b in zip(served["f32_host"], served["f32_pil"]))
    emit("reward_serve_host_vs_pil", rewards_differing=differ, of=sum(len(r) for r in served["f32_pil"]))
    check(differ == 0, f"{differ} rewards of the host engine differ from the pil engine's")

    # labeling the slice's demo group with the host resize, beside the card's
    g_src = demo_group(SERVE_LABEL_FRAMES, 2, SERVE_LABEL_SIZE, SEED)
    labeled = {}
    for mode in ("pil", "host"):
        eng = engine(DEVICE, BATCH, resize_mode=mode)
        eng.text_rewards(g_src["ob"][:BATCH, -1], SERVE_TEXTS[0])  # warm-up batch
        g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
        sync()
        for fn in counters.values():
            fn.launches = 0
        with shapes:
            stats = label_group(g, SERVE_TEXTS[0], eng, progress=False)
            launches = launch_counts(counters)
        labeled[mode] = np.asarray(g["ob_clip_reward"])
        emit("label_host_vs_pil", resize_mode=mode, frames=stats["frames"], seconds=stats["seconds"], fps=stats["fps"],
             batch_size=BATCH, launches=launches, recipe=eng.encode_recipe)
        check(launches["flash_attn_fwd"] > 0, f"labeling with resize_mode={mode} never launched K1")
        for name, n in launches.items():
            totals[name] += n
        del eng
    check(np.array_equal(labeled["host"], labeled["pil"]), "labeling with the host resize differs from the card's: "
          f"{int((labeled['host'] != labeled['pil']).sum())} rewards")
    emit("reward_serve_kernel_shapes", k1=dict(shapes.k1), k2=dict(shapes.k2))
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return totals, shapes


REF_MODES = ("frozen_bf16", "frozen_int8")  # the towers of the policy built through --load_checkpoint
REF_STEP, REF_EPOCH = 12000, 12  # where the exported run stood: the file's step and epoch


def tie_heads(state: dict) -> dict:
    """Every ensemble member of the heads set to member 0: the one head a reference checkpoint holds."""
    return {k: (v[:1].expand_as(v).clone() if ".heads." in k else v) for k, v in state.items()}


def phase_reference_checkpoint(counters, policy_lib, flax_m3ae_to_torch) -> tuple[dict, "LaunchShapes"]:
    """The flagship ARPDT written in the reference's format and started from it, as a user holding the
    reference's weights starts the port: the policy as a reference pickle (save_reference_checkpoint) and
    its M3AE tower as m3ae_base_params.pkl in $ARP_TPU_CHECKPOINT_DIR, read back without flax (the tower
    by name, the policy through the trainer's --load_checkpoint code), in frozen_bf16 and frozen_int8.
    action_pred at batch 128 x window 4 against the same model built from the weights in memory, one
    train step timed and counted (cost/flops, with and without the plain kernels); returns the launches of
    the loaded models' forwards and steps, and their shapes."""
    import pickle
    import tempfile

    from arp_tpu_torch.checkpoint import load_reference_checkpoint, save_reference_checkpoint
    from arp_tpu_torch.models.m3ae import export_reference_m3ae_params, load_m3ae_model_vars
    from arp_tpu_torch.ops.augment import make_augment_fn
    from arp_tpu_torch.parallel.step import TrainState, make_train_step
    from arp_tpu_torch.train import common
    from arp_tpu_torch.train.main import start_from_reference_checkpoint

    t_phase = time.perf_counter()
    variables = random_m3ae_variables(M3AE_DIMS, 16, BERT_VOCAB, SEED)
    pt = flax_m3ae_to_torch(variables)
    raw, _ = policy_batch(POLICY_BATCH, POLICY_WINDOW, SEED)
    small = head_batch(raw, CPU_FRAMES // POLICY_WINDOW)  # the int8 calibration's frames, as phase_train's
    on_card = to_device(raw, DEVICE)
    totals, noted, trained = dict.fromkeys(counters, 0), LaunchShapes(), None
    saved_dir = os.environ.get("ARP_TPU_CHECKPOINT_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["ARP_TPU_CHECKPOINT_DIR"] = tmp
        try:
            policy_path, tower_path = os.path.join(tmp, "model_best.pkl"), os.path.join(tmp, "m3ae_base_params.pkl")
            t0 = time.perf_counter()
            with open(tower_path, "wb") as f:  # the reference's own pickle of its tower's params
                pickle.dump(export_reference_m3ae_params(variables), f, protocol=4)
            files = {"tower_write_s": time.perf_counter() - t0, "tower_bytes": os.path.getsize(tower_path)}
            t0 = time.perf_counter()
            tower_state = load_m3ae_model_vars("vit_b16")  # by name, as the policy's loader reads it
            files["tower_read_s"] = time.perf_counter() - t0
            check(tower_state.keys() == pt.keys() and all(torch.equal(tower_state[k], pt[k]) for k in pt),
                  "reference_checkpoint: the tower read back from m3ae_base_params.pkl differs from its weights")
            del tower_state
            for mode in REF_MODES:
                cfg = dict(POLICY_CFG, m3ae=M3AE_CFG, **POLICY_MODES[mode])
                flags = train_flags(cfg)
                schedule = common.build_lr_schedule(flags, TRAIN_STEPS_PER_EPOCH, TRAIN_STEPS_PER_EPOCH * flags.epochs)

                def build(in_memory: bool):
                    """The model as the trainer builds it; its tower from ``pt`` or (None) by name from the file."""
                    loader = (lambda name: pt) if in_memory else None
                    qpack = common.maybe_build_frozen_qpack(flags, small, use_goal=False, device=DEVICE,
                                                            m3ae_loader=loader)
                    torch.manual_seed(SEED)
                    model = common.build_model(flags, 15, frozen_qpack=qpack,
                                               pt_variables=pt if in_memory else None).to(DEVICE)
                    with torch.no_grad():
                        model(to_device(head_batch(small, 1), DEVICE), deterministic=True)  # the lazy layers
                    return model

                memory = build(True)
                if trained is None:  # one set of trained weights (5 heads tied) for both modes, exported once
                    trained = tie_heads(memory.trained_state_dict())
                    t0 = time.perf_counter()
                    save_reference_checkpoint(policy_path, trained, step=REF_STEP, epoch=REF_EPOCH,
                                              variant=dict(transfer_type=cfg["transfer_type"]))
                    files.update(policy_write_s=time.perf_counter() - t0, policy_bytes=os.path.getsize(policy_path))
                    t0 = time.perf_counter()
                    load_reference_checkpoint(policy_path)
                    files["policy_read_s"] = time.perf_counter() - t0
                with torch.no_grad():
                    memory.load_trained_state_dict(trained)
                with torch.inference_mode():
                    want = memory(on_card, deterministic=True)["action_pred"].float()
                    again = memory(on_card, deterministic=True)["action_pred"].float()
                spread = float((again - want).abs().max())
                tower_memory = {k: v.clone() for k, v in memory.pt_model.state_dict().items()}
                qpack_memory = {k: v.clone() for k, v in _flat(memory.frozen_qpack or {}).items()}
                del memory, again
                t0 = time.perf_counter()
                loaded = build(False)
                state = TrainState.create(loaded, common.build_optimizer(flags, schedule, loaded))
                start = start_from_reference_checkpoint(state, policy_path)
                build_s, state_step = time.perf_counter() - t0, state.step
                check(start == REF_STEP and state.step == 0 and state.opt_state.count == 0
                      and not any(bool(m.any()) for m in state.opt_state.mu + state.opt_state.nu),
                      f"reference_checkpoint {mode}: start {start}, step {state.step}, count {state.opt_state.count}")
                tower_equal = all(torch.equal(v, tower_memory[k]) for k, v in loaded.pt_model.state_dict().items())
                qpack_equal = all(torch.equal(v, qpack_memory[k]) for k, v in _flat(loaded.frozen_qpack or {}).items())
                check(tower_equal, f"reference_checkpoint {mode}: the tower read by name differs from the in-memory one")
                loss_fn = common.make_loss_fn(loaded, make_augment_fn(flags.data.augmentations, image_size=256,
                                                                      source_size=flags.data.image_size), 256, False)
                step = make_train_step(loss_fn, learning_rate_fn=schedule)
                gen = torch.Generator(device=DEVICE).manual_seed(SEED)
                sync()
                for fn in counters.values():
                    fn.launches = 0
                with noted:  # the main path: the loaded model's forward, its cost/flops and two train steps
                    with torch.inference_mode():
                        got = loaded(on_card, deterministic=True)["action_pred"].float()
                    flops = common.flops_analysis(step.gradients, state, on_card, gen)
                    times = []
                    for _ in range(2):
                        t0 = time.perf_counter()
                        _, aux = step(state, on_card, gen)
                        sync()
                        times.append((time.perf_counter() - t0) * 1e3)
                launches = launch_counts(counters)
                with plain_kernels():
                    flops_plain = common.flops_analysis(step.gradients, state, on_card, gen)
                err = float((got - want).abs().max())
                check(got.shape == (POLICY_BATCH, POLICY_WINDOW, 15) and bool(torch.isfinite(got).all()),
                      f"reference_checkpoint {mode}: action_pred {tuple(got.shape)}")
                check(err <= spread, f"reference_checkpoint {mode}: the loaded model's action_pred is {err} off the "
                      f"in-memory model's, beyond its own run-to-run spread {spread}")
                check(flops > 0 and flops == flops_plain,
                      f"reference_checkpoint {mode}: cost/flops {flops} with the kernels, {flops_plain} with the plain versions")
                check(np.isfinite(float(aux["loss"])), f"reference_checkpoint {mode}: loss {float(aux['loss'])}")
                check(launches["flash_attn_fwd"] > 0 and (launches["int8_gemm"] > 0) == (mode == "frozen_int8"),
                      f"reference_checkpoint {mode}: launches {launches}")
                emit("reference_checkpoint", mode=mode, batch=POLICY_BATCH, window=POLICY_WINDOW,
                     action_pred_max_abs_vs_in_memory=err, in_memory_run_to_run_max_abs=spread,
                     tower_equal=tower_equal, qpack_equal=qpack_equal, start_step=start, state_step=state_step,
                     build_and_load_s=build_s, step_ms=times[-1], first_step_ms=times[0], cost_flops=flops,
                     cost_flops_plain_kernels=flops_plain, loss=float(aux["loss"]),
                     learning_rate=aux["learning_rate"], launches=launches)
                for name, n in launches.items():
                    totals[name] += n
                del loaded, state, step, loss_fn, tower_memory, qpack_memory
                if DEVICE != "cpu":
                    torch.cuda.empty_cache()
        finally:
            if saved_dir is None:
                os.environ.pop("ARP_TPU_CHECKPOINT_DIR", None)
            else:
                os.environ["ARP_TPU_CHECKPOINT_DIR"] = saved_dir
    emit("reference_checkpoint_phase", seconds=time.perf_counter() - t_phase, launches=totals,
         k1_shapes=dict(noted.k1), k2_shapes=dict(noted.k2), **files)
    return totals, noted


# The PPG expert (stage 1): train_ppg at 64 envs x 256 steps on the native engine at 64 px, arch dual,
# PPGConfig's 4 minibatches and 6 aux epochs, reward_norm; cut to 3 iterations (of the CLI's 1,000) with
# n_pi 2 (of 32) so that one aux phase runs
PPG_FLAGS = dict(vec_env="native", num_envs=64, segment_length=256, total_iterations=3, n_pi=2, arch="dual",
                 reward_norm=True)
PPG_PROFILED_ITERATION = 1  # collect + updates + the aux phase
PPG_STEP_TIMED = 3  # minibatch steps timed (after one warm-up) for ms a step
# The card against the CPU: one iteration's updates (separate phases, n_epoch_vf 2: 12 minibatch steps) from
# one params draw and one recorded segment (8 envs x 32 steps: the CPU's share).  Adam's normalized steps
# amplify rounding from one step to the next (a gradient near zero moves its weight by +-lr on the sign of a
# rounding), so the free-running iteration is reported beside a float64 run's distance from the CPU's float32,
# and each step is held teacher-forced: from the CPU's state before it, on its minibatch, through the CPU's
# branches (each ReLU's sign and max pool's argmax; the card's own flips are counted).  A step's loss as the
# CPU tests hold the port to JAX; its gradient 1e-4 of the largest entry; the params after it 1e-4 of the
# largest entry, outside entries whose gradient at that step is below PPG_GRAD_REL of its largest
PPG_CPU_ENVS, PPG_CPU_STEPS = 8, 32
PPG_LOSS_REL, PPG_GRAD_REL, PPG_PARAM_REL = 1e-5, 1e-4, 1e-4
PPG_GREEDY_FRAMES, PPG_MARGIN = 512, 1e-3  # the .jd expert's greedy actions, card vs CPU


class PPGMeter:
    """While in place, times each iteration of ``collect/ppg.py::learn``: its collect (Gym3Roller.collect), its
    PPO updates (policy_phase) and its aux phase, each ended by a synchronize, and profiles one iteration."""

    def __init__(self, n_pi: int, profiled: int):
        from arp_tpu_torch.collect import ppg

        self.ppg, self.n_pi, self.profiled = ppg, n_pi, profiled
        self.iterations, self.profile, self._prof, self._t_prof = [], None, None, 0.0
        self.first_start = self.last_end = None  # of the timed parts, on the host's clock

    def _timed(self, part, fn):
        def wrapped(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            self.first_start = self.first_start or t0
            if part == "collect":
                self.iterations.append({})
                if len(self.iterations) - 1 == self.profiled and DEVICE != "cpu":
                    from torch.profiler import ProfilerActivity, profile

                    # the device's activity alone: recording every host op would slow the host-bound collect
                    self._prof = profile(activities=[ProfilerActivity.CUDA])
                    self._prof.__enter__()
                    self._t_prof = t0
            out = fn(*args, **kwargs)
            sync()
            it = len(self.iterations) - 1
            self.last_end = time.perf_counter()
            self.iterations[-1][f"{part}_s"] = self.last_end - t0
            last = "aux" if (it + 1) % self.n_pi == 0 else "update"
            if part == last and self._prof is not None:
                self._prof.__exit__(None, None, None)
                self.profile = profile_summary(self._prof, (time.perf_counter() - self._t_prof) * 1e6)
                self._prof = None
            return out

        return wrapped

    def __enter__(self):
        self.saved = [(self.ppg.Gym3Roller, "collect", self.ppg.Gym3Roller.collect),
                      (self.ppg, "policy_phase", self.ppg.policy_phase), (self.ppg, "aux_phase", self.ppg.aux_phase)]
        for (owner, name, fn), part in zip(self.saved, ("collect", "update", "aux")):
            setattr(owner, name, self._timed(part, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def reference_ppg_state_dict(state: dict) -> dict:
    """A port PhasicValueModel's state dict (dual) under the reference's torch names: a stand-in for a
    shipped expert's ``.jd`` (its Impala stacks under ``cnn.stacks``, the value head ``vf_vhead``, the
    dense kernel's columns in (C, H, W) order)."""
    out = {}
    for name, value in state.items():
        name = re.sub(r"_enc\.stack(\d)_block(\d)_", r"_enc.cnn.stacks.\1.blocks.\2.", name)
        name = re.sub(r"_enc\.stack(\d)_firstconv", r"_enc.cnn.stacks.\1.firstconv", name)
        if name.endswith("_enc.dense.weight"):  # (256, H*W*C) in (h, w, c) order -> (c, h, w) order
            c = 32
            hw = value.shape[1] // c
            h = int(round(hw ** 0.5))
            value = value.reshape(value.shape[0], h, hw // h, c).permute(0, 3, 1, 2).reshape(value.shape[0], -1)
        name = name.replace("_enc.dense", "_enc.cnn.dense")
        out["vf_vhead" + name[len("vf_head"):] if name.startswith("vf_head") else name] = value.clone()
    return out


class ImpalaBranches:
    """While in place, models/impala.py's ReLUs and max pools note their branches in call order (each ReLU
    input's sign, each pool's argmax), a list a step; given another run's lists (``replay``), they take
    those branches instead of their own and count where their own differ.  So the card computes the CPU's
    piecewise-linear function, and only its arithmetic can differ."""

    def __init__(self, replay=None):
        from arp_tpu_torch.models import impala

        self.impala, self.replay, self.steps = impala, replay, []
        self.relu_flips = self.pool_moves = 0

    def start_step(self):
        self.steps.append([])
        self.k, self.relu_flips, self.pool_moves = 0, 0, 0

    def relu(self, x):
        mask = x > 0
        if self.replay is not None:
            want = self.replay[len(self.steps) - 1][self.k].to(x.device)
            self.k += 1
            self.relu_flips += int((want != mask).sum())
            return x * want
        self.steps[-1].append(mask.cpu())
        return torch.relu(x)

    def max_pool2d(self, x, kernel, stride, padding=0):
        out, idx = torch.nn.functional.max_pool2d(x, kernel, stride, padding, return_indices=True)
        if self.replay is None:
            self.steps[-1].append(idx.cpu())
            return out
        want = self.replay[len(self.steps) - 1][self.k].to(x.device)
        self.k += 1
        self.pool_moves += int((want != idx).sum())
        out = x.flatten(2).gather(2, want.flatten(2)).view(want.shape)
        # the layout max_pool2d gives (channels-last in, channels-last out): the next convolution's algorithm
        return out.contiguous(memory_format=torch.channels_last) if x.is_contiguous(
            memory_format=torch.channels_last) and not x.is_contiguous() else out

    def __getattr__(self, name):  # torch.nn.functional's other functions
        return getattr(torch.nn.functional, name)

    def __enter__(self):
        self.saved, self.impala.F = self.impala.F, self
        return self

    def __exit__(self, *exc):
        self.impala.F = self.saved


def ppg_iteration_on(device, state: dict, seg: dict, config, forced=None, dtype=torch.float32) -> dict:
    """One iteration's updates (collect/ppg.py::policy_phase) on ``device`` in ``dtype`` from ``state`` and a
    recorded segment.  Each minibatch step is noted: its phase, loss metrics, gradient (from its Adam
    moments), the params after it and, for a free run, the state before it and its branches
    (:class:`ImpalaBranches`).  ``forced``: such a run; each step then starts from its state before that
    step and takes its branches."""
    from arp_tpu_torch.collect import ppg
    from arp_tpu_torch.parallel.step import TrainState
    from arp_tpu_torch.train.common import AdamWState

    model = ppg.PhasicValueModel(arch=config.arch)
    model.load_state_dict(state)
    model.to(device, dtype)
    tstate = TrainState.create(model, ppg.make_adam(config, len(list(model.parameters()))))
    ppo_step, _, _, _, pi_step, vf_step, init_phase_opts = ppg.make_ppg_steps(model, config)
    branches = ImpalaBranches(None if forced is None else forced["branches"])
    notes = []

    def host(tensors):
        return [t.detach().cpu().clone() for t in tensors]

    def noting(phase, step):
        def wrapped(params, opt, batch):
            if forced is not None:
                before = forced["notes"][len(notes)]["before"]
                with torch.no_grad():
                    for (_, p), v in zip(params, before["params"]):
                        p.copy_(v)
                opt = AdamWState(before["count"], [m.to(device) for m in before["mu"]],
                                 [v.to(device) for v in before["nu"]])
            before = dict(params=host(p for _, p in params), count=opt.count, mu=host(opt.mu), nu=host(opt.nu))
            branches.start_step()
            params, new_opt, metrics = step(params, opt, batch)
            grads = [(a.detach().cpu() - 0.9 * b) / (1 - 0.9) for a, b in zip(new_opt.mu, before["mu"])]
            notes.append(dict(phase=phase, metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                              after=host(p for _, p in params), before=before if forced is None else None,
                              relu_flips=branches.relu_flips, pool_moves=branches.pool_moves))
            return params, new_opt, metrics

        return wrapped

    obs = torch.from_numpy(seg["obs"].reshape(-1, *seg["obs"].shape[2:])).to(device, dtype)
    flat = {"obs": obs, "act": torch.from_numpy(seg["act"].reshape(-1).astype(np.int64)).to(device),
            "logp_old": torch.from_numpy(seg["logp"].reshape(-1)).to(device, dtype),
            "adv": torch.from_numpy(seg["adv"].reshape(-1)).to(device, dtype),
            "vtarg": torch.from_numpy(seg["vtarg"].reshape(-1)).to(device, dtype)}
    t0 = time.perf_counter()
    with branches:
        ppg.policy_phase((ppo_step, noting("pi", pi_step), noting("vf", vf_step)), tstate,
                         init_phase_opts(tstate.params), flat, np.random.default_rng(SEED), config,
                         lambda m, prefix="": None)
    sync()
    return dict(notes=notes, names=[n for n, _ in tstate.params], branches=branches.steps,
                seconds=time.perf_counter() - t0)


def compare_ppg_iteration_with_cpu(model_state: dict, seg: dict, config) -> dict:
    """The card's iteration against the CPU's: free-running (beside the card's own float64 against the CPU's
    float32) and teacher-forced step by step through the CPU's branches; see PPG_CPU_ENVS."""
    cpu = ppg_iteration_on("cpu", model_state, seg, config)
    card = ppg_iteration_on(DEVICE, model_state, seg, config)
    forced = ppg_iteration_on(DEVICE, model_state, seg, config, forced=cpu)
    f64 = ppg_iteration_on(DEVICE, model_state, seg, config, dtype=torch.float64)

    def loss_rel(a, b):
        return max(abs(x["metrics"]["loss"] - y["metrics"]["loss"]) / abs(x["metrics"]["loss"])
                   for x, y in zip(a["notes"], b["notes"]))

    def params_rel(a_params, b_params, masks=None):
        pmax = max(float(p.abs().max()) for p in a_params)
        masks = masks or [None] * len(a_params)
        return max(float(((x.double() - y.double()).abs() * (1 if m is None else m)).max())
                   for x, y, m in zip(a_params, b_params, masks)) / pmax

    steps, left_out = [], 0
    for x, y in zip(cpu["notes"], forced["notes"]):
        gmax = max(float(g.abs().max()) for g in x["grads"])
        settled = [~((g != 0) & (g.abs() <= PPG_GRAD_REL * gmax)) for g in x["grads"]]
        left_out = max(left_out, sum(int((~m).sum()) for m in settled))
        grad_errs = [float((a - b).abs().max()) / gmax for a, b in zip(x["grads"], y["grads"])]
        worst = max(range(len(grad_errs)), key=grad_errs.__getitem__)
        steps.append(dict(
            phase=x["phase"], loss_rel_err=abs(x["metrics"]["loss"] - y["metrics"]["loss"]) / abs(x["metrics"]["loss"]),
            grad_err_rel_to_max=grad_errs[worst], worst_grad=cpu["names"][worst],
            param_err_rel_to_max=params_rel(x["after"], y["after"], settled),
            card_relu_flips=y["relu_flips"], card_pool_moves=y["pool_moves"]))
    last = lambda run: run["notes"][-1]["after"]  # noqa: E731
    return dict(
        minibatches=len(cpu["notes"]), steps=steps,
        forced_loss_max_rel_err=max(s["loss_rel_err"] for s in steps),
        forced_grad_max_err_rel_to_max=max(s["grad_err_rel_to_max"] for s in steps),
        forced_param_max_err_rel_to_max=max(s["param_err_rel_to_max"] for s in steps),
        card_relu_flips=sum(s["card_relu_flips"] for s in steps), card_pool_moves=sum(s["card_pool_moves"] for s in steps),
        free_loss_max_rel_err=loss_rel(cpu, card), free_param_err_rel_to_max=params_rel(last(cpu), last(card)),
        f64_vs_cpu_loss_max_rel_err=loss_rel(f64, cpu),
        f64_vs_cpu_param_err_rel_to_max=params_rel(last(f64), last(cpu)),
        entries_left_out_max=left_out, param_entries=sum(p.numel() for p in last(cpu)),
        cpu_seconds=cpu["seconds"], card_seconds=card["seconds"], card_f64_seconds=f64["seconds"])


def phase_ppg(counters) -> dict:
    """Stage 1's device half: a PPG expert trained through train_ppg's CLI on the native engine's venv (64 envs x
    256 steps), timed by iteration and part; ms of a PPO and an aux minibatch step; one iteration's updates on
    the card against the CPU; a stand-in reference expert (.jd) acting greedily on the card as on the CPU.
    Returns the kernels' launches over the CLI's run (this path runs none of them)."""
    import tempfile

    from arp_tpu_torch.collect import ppg, train_ppg
    from arp_tpu_torch.collect.convert_ppg import load_reference_ppg_expert
    from arp_tpu_torch.collect.reward_normalizer import RewardNormalizer
    from arp_tpu_torch.envs.native_engine import NativeProcgenGym3

    from arp_tpu_torch.envs.native_engine import native_lib

    t_phase = time.perf_counter()
    native_lib()  # the C++ engine's g++ build at first use, outside the timed run
    native_s = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as tmp:
        argv = [f"--{k}={v}" for k, v in PPG_FLAGS.items()] + [
            f"--seed={SEED}", f"--device={DEVICE}", f"--logging.output_dir={tmp}",
            f"--checkpoint_path={os.path.join(tmp, 'ppg.pkl')}"]
        flags = train_ppg.parse_flags(argv)
        config = train_ppg.ppg_config(flags)
        meter = PPGMeter(config.n_pi, PPG_PROFILED_ITERATION)
        if DEVICE != "cpu":
            torch.cuda.reset_peak_memory_stats()
        sync()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with meter:  # the main path: the CLI's run
            state, history = train_ppg.main(argv)
        sync()
        t_end = time.perf_counter()
        wall = t_end - t0
        launches = launch_counts(counters)
        peak = torch.cuda.max_memory_allocated() if DEVICE != "cpu" else 0
        pickle_bytes = os.path.getsize(os.path.join(tmp, "ppg.pkl"))
    frames = config.num_envs * config.segment_length
    check(len(history) == flags.total_iterations and all(np.isfinite(v) for r in history for v in r.values()),
          f"ppg: history {history}")
    check("kl" in history[PPG_PROFILED_ITERATION], "ppg: the aux phase did not run")
    check(not any(launches.values()), f"ppg: the PPG path launched a kernel of the port: {launches}")
    for it in meter.iterations:
        it["env_steps_per_s"] = frames / it["collect_s"]
    emit("ppg", flags=PPG_FLAGS, cuts={"total_iterations": "3 of the CLI's 1,000", "n_pi": "2 of 32"},
         frames_a_segment=frames, iterations=meter.iterations, wall_s=wall, native_build_s=native_s,
         setup_s=meter.first_start - t0, wrapup_s=t_end - meter.last_end, peak_memory_gb=peak / 2 ** 30,
         history=history, pickle_bytes=pickle_bytes, launches=launches)
    emit("ppg_profile", iteration=PPG_PROFILED_ITERATION, **(meter.profile or {}))

    # ms a minibatch step at the run's sizes, on the trained model
    ppo_step, aux_step, *_ = ppg.make_ppg_steps(state.model, config)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    n_ppo = frames // config.minibatches
    n_aux = config.n_pi * frames // config.aux_minibatches
    on = dict(device=DEVICE)
    ppo_batch = {"obs": torch.rand(n_ppo, 64, 64, 3, generator=gen, **on),
                 "act": torch.randint(0, 15, (n_ppo,), generator=gen, **on),
                 "logp_old": torch.full((n_ppo,), -2.7, **on), "adv": torch.randn(n_ppo, generator=gen, **on),
                 "vtarg": torch.randn(n_ppo, generator=gen, **on)}
    aux_batch = {"obs": torch.rand(n_aux, 64, 64, 3, generator=gen, **on), "vtarg": torch.randn(n_aux, generator=gen, **on),
                 "old_logits": torch.randn(n_aux, 15, generator=gen, **on)}
    steps = {"ppo": host_ms(lambda: ppo_step(state, ppo_batch), iters=PPG_STEP_TIMED),
             "aux": host_ms(lambda: aux_step(state, aux_batch), iters=PPG_STEP_TIMED)}
    emit("ppg_steps", ppo_minibatch=n_ppo, ppo_step_ms=steps["ppo"], aux_minibatch=n_aux, aux_step_ms=steps["aux"])
    del ppo_batch, aux_batch, state

    # the card against the CPU: one params draw, one recorded segment (on the CPU's model), one iteration
    cmp_config = ppg.PPGConfig(num_envs=PPG_CPU_ENVS, segment_length=PPG_CPU_STEPS, ppo_epochs=1, vf_epochs=2)
    model = ppg.PhasicValueModel(frame_shape=(64, 64, 3), generator=torch.Generator().manual_seed(SEED))
    model_state = {k: v.clone() for k, v in model.state_dict().items()}
    _, _, act, *_ = ppg.make_ppg_steps(model, cmp_config)
    venv = NativeProcgenGym3(game_name="coinrun", num=PPG_CPU_ENVS, resolution=64, episode_length=1000, rand_seed=SEED)
    roller = ppg.Gym3Roller(venv, lambda f, g: act(torch.from_numpy(f), g))
    seg, _ = roller.collect(torch.Generator().manual_seed(SEED), PPG_CPU_STEPS)
    seg["reward"] = RewardNormalizer(PPG_CPU_ENVS, gamma=cmp_config.gamma).normalize_segment(seg["reward"], seg["done"])
    adv, vtarg = ppg.compute_gae(seg["reward"], seg["value"], seg["done"], seg["last_value"])
    seg["adv"] = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    seg["vtarg"] = vtarg.astype(np.float32)
    compared = compare_ppg_iteration_with_cpu(model_state, seg, cmp_config)
    emit("ppg_vs_cpu", frames=PPG_CPU_ENVS * PPG_CPU_STEPS, ppo_epochs=1, vf_epochs=2, **compared)
    check(compared["forced_loss_max_rel_err"] <= PPG_LOSS_REL,
          f"ppg: card vs CPU step losses {compared['forced_loss_max_rel_err']}")
    check(compared["forced_grad_max_err_rel_to_max"] <= PPG_GRAD_REL,
          f"ppg: card vs CPU step gradients {compared['forced_grad_max_err_rel_to_max']} of the largest entry")
    check(compared["forced_param_max_err_rel_to_max"] <= PPG_PARAM_REL,
          f"ppg: card vs CPU params after a step {compared['forced_param_max_err_rel_to_max']} of the largest entry")
    check(np.isfinite(compared["free_loss_max_rel_err"]), "ppg: the free-running iteration's losses")

    # a reference expert's .jd (a stand-in: the port model's weights under the reference's names), greedy
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model1000_IC100007936.jd")
        torch.save(reference_ppg_state_dict(model_state), path)
        expert, _ = load_reference_ppg_expert(path)
    frames_jd = torch.from_numpy(seg["obs"].reshape(-1, 64, 64, 3)[:PPG_GREEDY_FRAMES])
    with torch.no_grad():
        want = expert(frames_jd)[0]
        got = expert.to(DEVICE)(frames_jd.to(DEVICE))[0].cpu()
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > PPG_MARGIN
    differ = int(((got.argmax(-1) != want.argmax(-1)) & clear).sum())
    emit("ppg_jd", frames=int(frames_jd.shape[0]), logits_max_abs_err=float((got - want).abs().max()),
         greedy_differ_on_clear_margins=differ, clear_margins=int(clear.sum()), pool_padding=expert.pool_padding,
         seconds=time.perf_counter() - t_phase)
    check(differ == 0, f"ppg: {differ} greedy actions of the .jd expert differ on the card")
    return launches


RESNET_CLIP = "resnet_50"  # the ModifiedResNet labeling cell: CONFIGS["resnet_50"] at its published widths, 224 px


def phase_clip_resnet(counters, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch, label_group) -> tuple[dict, "LaunchShapes"]:
    """Labeling the demo group with a ResNet-50 CLIP engine (random weights and BatchNorm statistics from numpy
    seed 0 in the Flax layout, through the weight bridge), float32 and bf16 at batch 256: frames/s, reward MAE
    against a CPU engine on 8 rows, one profiled pass; the text tower's K1 launches and their shapes."""
    cfg = CONFIGS[RESNET_CLIP]
    t0 = time.perf_counter()
    state = flax_to_torch(random_clip_variables(cfg, 224, SEED))
    g_src = demo_group(LABEL_FRAMES, 2, 256, SEED)
    text = "the goal is to collect the coin."

    def engine(device, dtype, batch_size):
        model = CLIP(**cfg, image_size=224)
        model.load_state_dict(state)
        return ClipRewardEngine(model=model, batch_size=batch_size, compute_dtype=dtype, device=device)

    cpu = engine("cpu", torch.float32, CPU_FRAMES)
    want = cpu.text_rewards(np.asarray(g_src["ob"][LABEL_ROWS, -1]), text)
    check(np.isfinite(want).all(), "clip_resnet: CPU engine rewards are not finite")
    emit("clip_resnet_setup", model=RESNET_CLIP, params=int(sum(t.numel() for t in state.values())),
         ob=list(g_src["ob"].shape), cpu_reward_std=float(want.std()), seconds=time.perf_counter() - t0)
    totals, noted = dict.fromkeys(counters, 0), LaunchShapes()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        eng = engine(DEVICE, dtype, BATCH)
        eng.text_rewards(g_src["ob"][:BATCH, -1], text)  # warm-up batch
        sync()
        g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
        for fn in counters.values():
            fn.launches = 0
        with noted:
            stats = label_group(g, text, eng, progress=False)
        launches = launch_counts(counters)
        reward = np.asarray(g["ob_clip_reward"])
        mae = float(np.abs(reward[LABEL_ROWS, -1] - want).mean())
        bound = F32_REWARD_MAE if dtype == torch.float32 else BF16_COS_MAE * eng.logit_scale
        emit("clip_resnet", dtype=name, frames=stats["frames"], seconds=stats["seconds"], fps=stats["fps"],
             batch_size=BATCH, launches=launches, reward_mae_vs_cpu=mae, mae_bound=bound,
             reward_max_abs_err_vs_cpu=float(np.abs(reward[LABEL_ROWS, -1] - want).max()),
             reward_mean=float(reward[:, -1].mean()), reward_std=float(reward[:, -1].std()),
             recipe=eng.encode_recipe)
        check(reward.shape == (LABEL_FRAMES, 2) and np.isfinite(reward).all(), f"clip_resnet {name}: rewards")
        check(mae <= bound, f"clip_resnet {name}: reward MAE vs the CPU engine {mae} > {bound}")
        check(launches["flash_attn_fwd"] > 0, f"clip_resnet {name}: the text tower never launched K1")
        for k, n in launches.items():
            totals[k] += n
        if dtype == torch.float32 and DEVICE != "cpu":
            g = MemoryGroup((k, g_src[k]) for k in ("ob", "act", "done"))
            emit("clip_resnet_profile", dtype=name, frames=LABEL_FRAMES,
                 **device_profile(lambda: label_group(g, text, eng, progress=False)))
        del eng
    emit("clip_resnet_phase", seconds=time.perf_counter() - t0, launches=totals, k1_shapes=dict(noted.k1))
    return totals, noted


# M3AE pretraining: train/pretrain_m3ae.py's default model (MaskedMultimodalAutoencoder.get_default_config(), model_type
# base: 768 wide, 12 layers, 12 heads; the decoder 512 wide, 8 layers, 16 heads: head_dim 32), batch 64 of 256 px
# frames, patch 16, 64 text tokens, the BERT vocabulary; the JAX trainer's lr and weight decay.
PRETRAIN_MODEL = None  # config updates of the model (None: the trainer's default)
PRETRAIN_BATCH, PRETRAIN_IMAGE, PRETRAIN_PATCH, PRETRAIN_TEXT = 64, 256, 16, 64
PRETRAIN_PATCHES = (PRETRAIN_IMAGE // PRETRAIN_PATCH) ** 2
PRETRAIN_KEPT_PATCHES = PRETRAIN_PATCHES // 4  # image_mask_ratio 0.75 (text_mask_ratio too)
PRETRAIN_LR, PRETRAIN_WD = 1.5e-4, 0.05
PRETRAIN_STEPS_PER_EPOCH = 1000  # a nominal epoch: it only places the warmup's end (1 epoch of 10) for the schedule
PRETRAIN_WARMUP, PRETRAIN_TIMED = 2, 5
PRETRAIN_CPU_BATCH = 4  # the card's step against the CPU's
# The card's step against the CPU's from one state, batch and masking draw: the train phase's bounds (loss 1e-5
# relative; gradients 1e-4 of the largest entry; params after AdamW 2e-5, outside the entries whose CPU gradient is
# within the gradient bound of 0, where Adam's first step moves by +-lr on the sign alone).
PRETRAIN_LOSS_REL, PRETRAIN_GRAD_REL, PRETRAIN_PARAM_ATOL = 1e-5, 1e-4, 2e-5
RESNET_BATCH, RESNET_SIZE, RESNET_OUTPUTS = 64, 64, 1000  # ResNet18's train-mode forward, card vs CPU
RESNET_ATOL = 1e-4


class PretrainFrames:
    """An in-memory stand-in for ProcgenDataset as train/pretrain_m3ae.py's FramesWithText reads it: one stacked
    frame a row (the machine with the card has no h5py)."""

    env_name = "coinrun"

    def __init__(self, frames: np.ndarray):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def _read_frames(self, key: str, index: int) -> np.ndarray:
        return self.frames[index][None]


def random_flax_like(tree: dict, rng) -> dict:
    """Random values for a Flax variable tree of these names and shapes: kernels ~ N(0, 1/fan_in), scales and
    variances ~ 1 + |N(0, 0.1)|, biases and means ~ N(0, 0.1)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = random_flax_like(value, rng)
        elif key == "kernel":
            out[key] = rng.standard_normal(value.shape, dtype=np.float32) * np.float32(np.prod(value.shape[:-1]) ** -0.5)
        elif key in ("scale", "var"):
            out[key] = 1.0 + np.abs(0.1 * rng.standard_normal(value.shape, dtype=np.float32))
        else:
            out[key] = 0.1 * rng.standard_normal(value.shape, dtype=np.float32)
    return out


def compare_pretrain_step_with_cpu(build, loss_fn, batch: dict, batch_on, build_optimizer) -> dict:
    """One pretraining step on the card and on the CPU from one state, batch and masking draw (both drawn from
    one CPU generator): loss, gradients and params after clip + AdamW (a fresh state at the schedule's peak lr)."""
    from arp_tpu_torch.parallel.step import TrainState

    def one_step(device):
        model = build(device)
        state = TrainState.create(model, build_optimizer(model, lambda count: PRETRAIN_LR, PRETRAIN_WD))
        t0 = time.perf_counter()
        loss, aux = loss_fn(model, batch_on(batch, device), torch.Generator().manual_seed(SEED))
        loss.backward()
        grads = [p.grad.detach().clone() for _, p in state.params]
        state.apply_gradients(grads)
        sync()
        return dict(loss=float(loss.detach()), text_acc=float(aux["text_acc"]), grads=[g.cpu() for g in grads],
                    names=[n for n, _ in state.params], params=[p.detach().cpu() for _, p in state.params],
                    seconds=time.perf_counter() - t0)

    cpu, card = one_step("cpu"), one_step(DEVICE)
    gmax = max(float(g.abs().max()) for g in cpu["grads"])
    errs = [float((a - b).abs().max()) / gmax for a, b in zip(cpu["grads"], card["grads"])]
    worst = max(range(len(errs)), key=errs.__getitem__)
    settled = [g.abs() > PRETRAIN_GRAD_REL * gmax for g in cpu["grads"]]
    param_err = max(float(((a - b).abs() * m).max()) for a, b, m in zip(cpu["params"], card["params"], settled))
    out = dict(batch=len(batch["image"]), loss_cpu=cpu["loss"],
               loss_rel_err=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]), text_acc_cpu=cpu["text_acc"],
               text_acc_card=card["text_acc"], grad_max_abs=gmax, grad_err_rel_to_max=errs[worst],
               worst_grad=cpu["names"][worst], param_max_abs_err=param_err,
               param_entries=sum(p.numel() for p in cpu["params"]),
               param_entries_left_out=sum(int((~m).sum()) for m in settled), lr=PRETRAIN_LR,
               cpu_seconds=cpu["seconds"])
    emit("pretrain_m3ae_vs_cpu", **out)
    check(out["loss_rel_err"] <= PRETRAIN_LOSS_REL, f"pretrain step loss: card vs CPU {out['loss_rel_err']} relative")
    check(out["grad_err_rel_to_max"] <= PRETRAIN_GRAD_REL,
          f"pretrain step gradients: card vs CPU {out['grad_err_rel_to_max']} of the largest entry ({out['worst_grad']})")
    check(param_err <= PRETRAIN_PARAM_ATOL, f"pretrain step params after AdamW: card vs CPU max abs {param_err}")
    return out


def resnet18_train_forward_vs_cpu() -> dict:
    """ResNet18 (models/resnet.py) in train mode at 64 x 64, batch 64, random weights and batch statistics in the
    Flax layout through the bridge: the outputs and the updated batch_stats on the card against the CPU."""
    from arp_tpu_torch.models import resnet
    from arp_tpu_torch.models.clip.convert import flax_to_torch, torch_to_flax

    rng = np.random.default_rng(SEED)
    state = flax_to_torch(random_flax_like(torch_to_flax(resnet.ResNet18(num_outputs=RESNET_OUTPUTS).state_dict()), rng))
    x = torch.from_numpy(rng.standard_normal((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3), dtype=np.float32))

    def run(device):
        model = resnet.ResNet18(num_outputs=RESNET_OUTPUTS)
        model.load_state_dict(state)
        model.to(device)
        with torch.no_grad():
            out = model(x.to(device), train=True)
        sync()
        # copies: on the CPU .cpu() is the buffer itself, which the timed forwards below update
        return out.cpu(), {k: v.to("cpu", copy=True) for k, v in model.state_dict().items() if "running" in k}, model

    out_cpu, stats_cpu, _ = run("cpu")
    out_card, stats_card, model = run(DEVICE)
    x_card = x.to(DEVICE)
    with torch.no_grad():
        ms = host_ms(lambda: model(x_card, train=True))
    res = dict(batch=RESNET_BATCH, size=RESNET_SIZE, outputs=RESNET_OUTPUTS, ms_a_forward=ms,
               out_max_abs_err=float((out_card - out_cpu).abs().max()),
               batch_stats_max_abs_err=max(float((stats_card[k] - stats_cpu[k]).abs().max()) for k in stats_cpu),
               batch_stats_moved=all(not torch.equal(stats_cpu[k], state[k]) for k in stats_cpu), atol=RESNET_ATOL)
    emit("resnet18_train_vs_cpu", **res)
    check(bool(torch.isfinite(out_card).all()), "resnet18: non-finite outputs on the card")
    check(res["out_max_abs_err"] <= RESNET_ATOL, f"resnet18 train forward: card vs CPU {res['out_max_abs_err']}")
    check(res["batch_stats_max_abs_err"] <= RESNET_ATOL,
          f"resnet18 batch_stats: card vs CPU {res['batch_stats_max_abs_err']}")
    check(res["batch_stats_moved"], "resnet18: train mode left some batch statistics as they were")
    return res


def phase_pretrain_m3ae(counters) -> tuple[dict, "LaunchShapes"]:
    """M3AE pretraining on the card through train/pretrain_m3ae.py's functions (FramesWithText over an in-memory
    batch, prepare, the loss, the decay mask and clip + AdamW, parallel/step.py's step): first one step of
    PRETRAIN_CPU_BATCH against the CPU's, then ms a step (median of PRETRAIN_TIMED after PRETRAIN_WARMUP),
    frames/s, peak memory, K1's launches and shapes (every attention of the step: K1 forward, plain backward), the
    plain backward's share, one profiled step; then ResNet18's train-mode forward against the CPU's."""
    from arp_tpu_torch.data.loader import DataLoader
    from arp_tpu_torch.models import m3ae as m3ae_lib
    from arp_tpu_torch.models.policy import flax_m3ae_to_torch
    from arp_tpu_torch.ops.attention import reference_attention
    from arp_tpu_torch.ops.masks import MaskSpec
    from arp_tpu_torch.parallel.step import TrainState, make_train_step
    from arp_tpu_torch.train import pretrain_m3ae as tpre
    from arp_tpu_torch.train.common import flops_analysis, warmup_cosine_decay_schedule

    t0 = time.perf_counter()
    cfg = m3ae_lib.MaskedMultimodalAutoencoder.get_default_config(PRETRAIN_MODEL)
    vocab, patch_dim = tpre.BERT_VOCAB_SIZE, PRETRAIN_PATCH * PRETRAIN_PATCH * 3
    state = flax_m3ae_to_torch(random_m3ae_variables(cfg, PRETRAIN_PATCH, vocab, SEED, decoder=True), decoder=True)
    frames = np.random.default_rng(SEED).integers(0, 256, size=(PRETRAIN_BATCH, PRETRAIN_IMAGE, PRETRAIN_IMAGE, 3),
                                                  dtype=np.uint8)
    loader = DataLoader(tpre.FramesWithText(PretrainFrames(frames), PRETRAIN_TEXT), PRETRAIN_BATCH, shuffle=False,
                        num_workers=0)
    batch = next(iter(loader))
    loss_fn = tpre.make_loss_fn(PRETRAIN_IMAGE, PRETRAIN_PATCH)

    def build(device):
        model = m3ae_lib.MaskedMultimodalAutoencoder(cfg, text_vocab_size=vocab, image_output_dim=patch_dim,
                                                     decoder=True)
        model.load_state_dict(state)  # strict: the whole autoencoder tree through the bridge
        return model.to(device)

    emit("pretrain_m3ae_setup", config={k: cfg[k] for k in ("model_type", "emb_dim", "depth", "num_heads",
                                                             "dec_emb_dim", "dec_depth", "dec_num_heads", "mlp_ratio")},
         params=int(sum(t.numel() for t in state.values())), batch=PRETRAIN_BATCH, image=PRETRAIN_IMAGE,
         patch=PRETRAIN_PATCH, text=PRETRAIN_TEXT, vocab=vocab,
         instruction_tokens=int((batch["text_padding_mask"][0] == 0).sum()), seconds=time.perf_counter() - t0)
    compared = compare_pretrain_step_with_cpu(build, loss_fn, {k: v[:PRETRAIN_CPU_BATCH] for k, v in batch.items()},
                                              tpre.batch_on, tpre.build_optimizer)

    model = build(DEVICE)
    warmup = PRETRAIN_STEPS_PER_EPOCH  # warmup_epochs 1.0 of 10 epochs
    schedule = warmup_cosine_decay_schedule(0.0, PRETRAIN_LR, warmup, 10 * PRETRAIN_STEPS_PER_EPOCH)
    st = TrainState.create(model, tpre.build_optimizer(model, schedule, PRETRAIN_WD))
    st.step = st.opt_state.count = warmup  # where the warmup ends: a step from 0 moves a parameter by lr(0) = 0
    step = make_train_step(loss_fn, learning_rate_fn=schedule)
    on_card = tpre.batch_on(batch, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    before = {n: p.detach().clone() for n, p in st.params}
    for _ in range(PRETRAIN_WARMUP):
        step(st, on_card, gen)
    # the operations of a step's gradient computation (cost/flops: matmuls and attention products, K1's by formula)
    flops = flops_analysis(step.gradients, st, on_card, gen)
    check(flops > 0, "pretrain_m3ae: the step's operations could not be counted")
    sync()
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    times = []
    with LaunchShapes() as noted, K1Recorder() as rec:
        for _ in range(PRETRAIN_TIMED):
            t1 = time.perf_counter()
            _, aux = step(st, on_card, gen)
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
    launches = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated() if DEVICE != "cpu" else None
    ms = float(np.median(times))
    loss_value = float(aux["loss"])
    check(np.isfinite(loss_value), f"pretrain_m3ae: loss {loss_value}")
    still = [n for n, p in st.params if torch.equal(before[n], p.detach())]
    check(not still, f"pretrain_m3ae: trained parameters that did not move: {still[:4]}")
    per_step = cfg.depth + cfg.dec_depth  # every block's attention: K1 forward; the backward is the plain one
    check(launches["flash_attn_fwd"] == per_step * PRETRAIN_TIMED and launches["int8_gemm"] == 0,
          f"pretrain_m3ae: launches {launches}, expected K1 {per_step} a step")
    shapes = rec.counts()
    check(sum(shapes.values()) == launches["flash_attn_fwd"] and all(s.endswith(" padded grad") for s in shapes),
          f"pretrain_m3ae: a K1 launch without key padding or a gradient: {shapes}")
    # the plain backward that FlashAttention runs, at the step's two shapes
    bwd_ms, bwd_share = None, None
    if DEVICE != "cpu":
        bwd_ms = {}
        enc_n, dec_n = 1 + PRETRAIN_KEPT_PATCHES + PRETRAIN_TEXT // 4, 1 + PRETRAIN_PATCHES + PRETRAIN_TEXT
        for label, n, h, d in (("encoder", enc_n, cfg.num_heads, cfg.emb_dim // cfg.num_heads),
                               ("decoder", dec_n, cfg.dec_num_heads, cfg.dec_emb_dim // cfg.dec_num_heads)):
            q, k, v = (torch.randn(PRETRAIN_BATCH, n, h, d, device=DEVICE, requires_grad=True) for _ in range(3))
            pad = torch.zeros(PRETRAIN_BATCH, n, device=DEVICE)
            pad[:, n - 8:] = 1.0
            g_out = torch.randn(PRETRAIN_BATCH, n, h, d, device=DEVICE)
            bwd_ms[label] = cuda_ms(lambda: torch.autograd.grad(
                reference_attention(q, k, v, MaskSpec("none"), pad), (q, k, v), g_out))
        bwd_share = (cfg.depth * bwd_ms["encoder"] + cfg.dec_depth * bwd_ms["decoder"]) / ms
    emit("pretrain_m3ae", batch=PRETRAIN_BATCH, ms=ms, step_ms=times, fps=PRETRAIN_BATCH / ms * 1e3,
         flops_a_step=flops, tflops_per_s=flops / ms * 1e-9, f32_peak_share=flops / ms * 1e3 / PEAK["f32"],
         peak_memory_bytes=peak, loss=loss_value, image_loss=float(aux["image_loss"]),
         text_loss=float(aux["text_loss"]), text_acc=float(aux["text_acc"]), learning_rate=aux["learning_rate"],
         launches=launches, k1_shapes=shapes, k1_keys=dict(noted.k1),
         trained_params=sum(p.numel() for _, p in st.params), k1_plain_backward_ms_a_call=bwd_ms,
         k1_plain_backward_share=bwd_share)
    emit("profile", mode="pretrain_m3ae", frames=PRETRAIN_BATCH, **device_profile(lambda: step(st, on_card, gen)))
    del model, st, step, on_card, before
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    resnet = resnet18_train_forward_vs_cpu()
    emit("pretrain_m3ae_phase", seconds=time.perf_counter() - t0, launches=launches, card_vs_cpu=compared,
         resnet18=resnet)
    return launches, noted


# -- phase distributed: the train state wrapped for several processes ------------------------------------

DIST_STEPS = 3  # steps of each variant held against the unwrapped run
DIST_TIMED = 3  # steps timed after them (their median is ms a step)
DIST_MODES = ("float32", "frozen_int8")  # the train phase's flagship towers that the wrappers run
# A world of one process: the wrapper's all-reduce and FSDP2's all-gather and reduce-scatter over one rank
# move the same float32 values, so the wrapped steps equal the unwrapped ones; held to 1e-6 relative.
DIST_WORLD_OF_ONE_REL = 1e-6
# Two ranks on one card over gloo (each on 64 of the 128 rows): the gradient is the sum of two halves,
# averaged, against one process's sum over 128 rows: float32 rounding.  The params are held to 1e-4 of the
# largest move of one process's params over the run (a tensor's own largest entry is no scale for a bias
# that starts at 0); the card read 2.02e-5 there.  A rank that skips the all-reduce, or a step on half the
# batch, must read above it: the phase runs both faults in one process and holds them there.  Losses: 1e-5.
# SGD (clip 10, lr 0.01): Adam's first step turns a rounding of a near-zero gradient into +-lr.
DIST_TWO_RANK_MOVE_REL, DIST_TWO_RANK_LOSS_REL = 1e-4, 1e-5
DIST_SGD_LR, DIST_SGD_CLIP = 0.01, 10.0
DIST_TWO_RANK_TIMEOUT_S = 600.0
DIST_NCCL_PROBE_TIMEOUT_S = 90.0
# what the two spawned ranks take from this module as the parent holds it (a CPU rehearsal shrinks them)
DIST_SHARED = ("DEVICE", "SEED", "POLICY_BATCH", "POLICY_WINDOW", "POLICY_CFG", "POLICY_MODES", "M3AE_CFG", "M3AE_DIMS",
               "TRAIN_FLAGS", "TRAIN_STEPS_PER_EPOCH", "CPU_FRAMES", "DIST_STEPS", "DIST_TIMED", "DIST_SGD_LR",
               "DIST_SGD_CLIP")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now (the process group's store takes it)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(worker, tmp: str, store: str, timeout_s: float, what: str) -> None:
    """``worker(rank, 2, <tmp>/<store>, tmp)`` in two spawned processes; fails after ``timeout_s``, killing them."""
    t0 = time.perf_counter()
    context = torch.multiprocessing.start_processes(worker, args=(2, os.path.join(tmp, store), tmp), nprocs=2,
                                                    join=False, start_method="spawn")
    try:
        while not context.join(timeout=5):
            check(time.perf_counter() - t0 < timeout_s, f"{what}: timed out")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()


class ClippedSGD:
    """``optax.chain(clip_by_global_norm(clip), sgd(lr))`` on the port's train state (the two-rank
    comparison's optimizer): the norm over whole tensors (tp shares and pp stages too), the step shard by
    shard."""

    def __init__(self, lr: float, clip: float):
        self.lr, self.clip = lr, clip

    def init(self, params):
        from arp_tpu_torch.train.common import AdamWState

        return AdamWState(0, [], [])

    @torch.no_grad()
    def update(self, params, grads, state):
        from arp_tpu_torch.parallel.mesh import split_of
        from arp_tpu_torch.parallel.step import local_part
        from arp_tpu_torch.train.common import AdamWState, global_sum_of_squares

        local = [local_part(g) for g in grads]
        norm = torch.sqrt(global_sum_of_squares(local, list(grads), [split_of(p) for p in params]))
        clipped = torch._foreach_mul(torch._foreach_div(local, norm), self.clip)
        keep = norm < self.clip
        steps = [torch.where(keep, g, c) for g, c in zip(local, clipped)]
        torch._foreach_add_([local_part(p) for p in params], torch._foreach_mul(steps, -self.lr))
        return AdamWState(state.count + 1, [], [])


def max_rel_diff(got: dict, want: dict) -> float:
    """The largest entry difference of two state dicts, each tensor's relative to its largest entry."""
    return max(per_tensor_rel_diff(got, want).values(), default=0.0)


def per_tensor_rel_diff(got: dict, want: dict) -> dict:
    """Each tensor's largest entry difference relative to its largest entry (absolute where that is 0)."""
    out = {}
    for k, w in want.items():
        g, w = torch.as_tensor(got[k]).double(), torch.as_tensor(w).double()
        scale = float(w.abs().max()) if w.numel() else 0.0
        diff = float((g - w).abs().max()) if w.numel() else 0.0
        out[k] = diff / scale if scale > 0 else diff
    return out


def rel_to_largest(got: dict, want: dict, start: dict = None) -> float:
    """The largest entry difference of two state dicts relative to the largest entry of ``want`` (or,
    given ``start``, to the largest move from ``start``)."""
    diff = max((float((torch.as_tensor(got[k]).double() - torch.as_tensor(w).double()).abs().max())
                for k, w in want.items() if torch.as_tensor(w).numel()), default=0.0)
    ref = {k: torch.as_tensor(w).double() - (0 if start is None else torch.as_tensor(start[k]).double())
           for k, w in want.items()}
    scale = max((float(r.abs().max()) for r in ref.values() if r.numel()), default=0.0)
    return diff / scale if scale > 0 else diff


def peak_reset() -> None:
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes():
    return torch.cuda.max_memory_allocated() if DEVICE != "cpu" else None


def policy_setup(mode: str, pt: dict, raw: dict):
    """(flags, schedule, augment, qpack) of the train phase's flagship at ``mode``."""
    from arp_tpu_torch.ops.augment import make_augment_fn
    from arp_tpu_torch.train import common

    flags = train_flags(dict(POLICY_CFG, m3ae=M3AE_CFG, **POLICY_MODES[mode]))
    schedule = common.build_lr_schedule(flags, TRAIN_STEPS_PER_EPOCH, TRAIN_STEPS_PER_EPOCH * flags.epochs)
    augment = make_augment_fn(flags.data.augmentations, image_size=256, source_size=flags.data.image_size)
    small = head_batch(raw, CPU_FRAMES // POLICY_WINDOW)
    qpack = common.maybe_build_frozen_qpack(flags, small, use_goal=False, device=DEVICE, m3ae_loader=lambda name: pt)
    return flags, schedule, augment, qpack


def policy_model(flags, qpack, pt: dict, raw: dict, trained=None):
    """The flagship policy on the card as the trainer builds it, its first forward run (the lazy layers take
    their shapes), with ``trained`` loaded when given."""
    from arp_tpu_torch.train import common

    torch.manual_seed(SEED)
    model = common.build_model(flags, 15, frozen_qpack=qpack, pt_variables=pt).to(DEVICE)
    with torch.no_grad():
        model(to_device(head_batch(raw, 1), DEVICE), deterministic=True)
        if trained is not None:
            model.load_trained_state_dict(trained)
    return model


def run_policy_steps(state, step, batch, steps: int, timed: int) -> dict:
    """``steps`` steps, each drawing from the trainer's (SEED, step) generator, then ``timed`` more timed:
    losses, ms, peak memory."""
    from arp_tpu_torch.train.main import step_generator

    losses = []
    for i in range(steps):
        _, aux = step(state, batch, step_generator(SEED, i, DEVICE))
        losses.append(float(aux["loss"]))
    sync()
    peak_reset()
    times = []
    for i in range(steps, steps + timed):
        t0 = time.perf_counter()
        step(state, batch, step_generator(SEED, i, DEVICE))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "ms": float(np.median(times)) if times else None, "step_ms": times,
            "peak_memory_bytes": peak_bytes()}


def run_variant(counters, shapes, launches: dict, wrapped: bool, state, step, batch, steps: int, timed: int) -> dict:
    """:func:`run_policy_steps` of one variant and its gathered params; a wrapped variant's launches are
    counted from 0 into ``launches`` and their shapes noted in ``shapes``."""
    from arp_tpu_torch.parallel.mesh import gather_to_host

    for fn in counters.values():
        fn.launches = 0
    if wrapped:
        with shapes:
            run = run_policy_steps(state, step, batch, steps, timed)
        for name, n in launch_counts(counters).items():
            launches[name] += n
    else:
        run = run_policy_steps(state, step, batch, steps, timed)
    run["params"] = gather_to_host(state.model)
    return run


def hold_world_of_one(mode: str, out: dict, launches: dict, **info) -> None:
    """Every wrapped run of ``out`` against ``out["unwrapped"]``: params within DIST_WORLD_OF_ONE_REL of
    each tensor's largest entry and the losses equal; then the phase's line."""
    base = out["unwrapped"]
    for wrap, run in out.items():
        if wrap == "unwrapped":
            continue
        run["max_rel_param_diff"] = max_rel_diff(run["params"], base["params"])
        check(run["max_rel_param_diff"] <= DIST_WORLD_OF_ONE_REL,
              f"distributed {mode} {wrap}: params {run['max_rel_param_diff']} relative from the unwrapped run's")
        check(run["losses"] == base["losses"], f"distributed {mode} {wrap}: losses {run['losses']} != {base['losses']}")
    emit("distributed", part="world_of_one", mode=mode, launches=launches, **info,
         **{wrap: {k: v for k, v in run.items() if k != "params"} for wrap, run in out.items()})


def world_of_one_policy(counters, shapes, mesh, mode: str, pt: dict, raw: dict, checkpoint_dir=None) -> dict:
    """The flagship train step unwrapped, wrapped by DistributedDataParallel, and by FSDP2 over the (1, 1)
    mesh, from one state, batch and generator: DIST_STEPS steps each, the wrapped runs' params and losses
    against the unwrapped run's; ms a step and peak memory of each.  With ``checkpoint_dir`` the FSDP2
    state is saved whole and restored into an unwrapped state: bit for bit.  Launches are counted (and
    their shapes noted) in the wrapped runs."""
    from arp_tpu_torch.checkpoint import CheckpointManager
    from arp_tpu_torch.parallel.mesh import data_share, gather_to_host
    from arp_tpu_torch.parallel.step import TrainState, fully_shard_train_state, make_train_step, shard_train_state
    from arp_tpu_torch.train import common

    flags, schedule, augment, qpack = policy_setup(mode, pt, raw)
    batch = to_device(raw, DEVICE)
    start = {k: v.detach().clone() for k, v in policy_model(flags, qpack, pt, raw).trained_state_dict().items()}
    out, launches = {}, dict.fromkeys(counters, 0)
    for wrap in ("unwrapped", "ddp", "fsdp"):
        model = policy_model(flags, qpack, pt, raw, start)
        state = TrainState.create(model, common.build_optimizer(flags, schedule, model))
        # where the warmup ends (lr 5e-4): a step from 0 moves a parameter by lr(0) = 0
        state.step = state.opt_state.count = TRAIN_FLAGS["warmup_epochs"] * TRAIN_STEPS_PER_EPOCH
        on = None if wrap == "unwrapped" else mesh
        # FSDP2 over the (1, 1) mesh: the fsdp path's own check, which one card can run
        state = fully_shard_train_state(state, on) if wrap == "fsdp" else shard_train_state(state, on)
        step = make_train_step(common.make_loss_fn(model, augment, 256, False, share=data_share(on)), mesh=on,
                               learning_rate_fn=schedule)
        out[wrap] = run = run_variant(counters, shapes, launches, on is not None, state, step, batch, DIST_STEPS,
                                      DIST_TIMED)
        if wrap == "fsdp" and checkpoint_dir is not None:
            moments = gather_to_host(list(state.opt_state.mu) + list(state.opt_state.nu))
            CheckpointManager(checkpoint_dir).save(state.step, state, metadata={"step": state.step})
            fresh = policy_model(flags, qpack, pt, raw)
            back = TrainState.create(fresh, common.build_optimizer(flags, schedule, fresh))
            back, _ = CheckpointManager(checkpoint_dir).restore(back)
            restored = list(back.opt_state.mu) + list(back.opt_state.nu)
            run["checkpoint_bit_equal"] = (
                all(torch.equal(run["params"][k], v.cpu()) for k, v in fresh.trained_state_dict().items())
                and all(torch.equal(a, b.cpu()) for a, b in zip(moments, restored)))
            check(run["checkpoint_bit_equal"], f"distributed {mode}: the FSDP2 checkpoint did not restore bit for bit")
            del fresh, back
        del model, state, step
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    hold_world_of_one(mode, out, launches, batch=POLICY_BATCH, window=POLICY_WINDOW)
    return launches


def world_of_one_pretrain(counters, shapes, mesh) -> dict:
    """One M3AE pretraining step at the trainer's default model with the decoder (K1 at head_dim 32), batch
    PRETRAIN_BATCH, unwrapped, by DistributedDataParallel and by FSDP2: params and losses held."""
    from arp_tpu_torch.data.loader import DataLoader
    from arp_tpu_torch.models import m3ae as m3ae_lib
    from arp_tpu_torch.models.policy import flax_m3ae_to_torch
    from arp_tpu_torch.parallel.step import TrainState, fully_shard_train_state, make_train_step, shard_train_state
    from arp_tpu_torch.train import pretrain_m3ae as tpre
    from arp_tpu_torch.train.common import warmup_cosine_decay_schedule

    cfg = m3ae_lib.MaskedMultimodalAutoencoder.get_default_config(PRETRAIN_MODEL)
    vocab, patch_dim = tpre.BERT_VOCAB_SIZE, PRETRAIN_PATCH * PRETRAIN_PATCH * 3
    weights = flax_m3ae_to_torch(random_m3ae_variables(cfg, PRETRAIN_PATCH, vocab, SEED, decoder=True), decoder=True)
    frames = np.random.default_rng(SEED).integers(0, 256, size=(PRETRAIN_BATCH, PRETRAIN_IMAGE, PRETRAIN_IMAGE, 3),
                                                  dtype=np.uint8)
    batch = tpre.batch_on(next(iter(DataLoader(tpre.FramesWithText(PretrainFrames(frames), PRETRAIN_TEXT),
                                               PRETRAIN_BATCH, shuffle=False, num_workers=0))), DEVICE)
    warmup = PRETRAIN_STEPS_PER_EPOCH
    schedule = warmup_cosine_decay_schedule(0.0, PRETRAIN_LR, warmup, 10 * PRETRAIN_STEPS_PER_EPOCH)
    out, launches = {}, dict.fromkeys(counters, 0)
    for wrap in ("unwrapped", "ddp", "fsdp"):
        model = m3ae_lib.MaskedMultimodalAutoencoder(cfg, text_vocab_size=vocab, image_output_dim=patch_dim,
                                                     decoder=True)
        model.load_state_dict(weights)
        model.to(DEVICE)
        state = TrainState.create(model, tpre.build_optimizer(model, schedule, PRETRAIN_WD))
        state.step = state.opt_state.count = warmup
        on = None if wrap == "unwrapped" else mesh
        # FSDP2 over the (1, 1) mesh: the fsdp path's own check, which one card can run
        state = fully_shard_train_state(state, on) if wrap == "fsdp" else shard_train_state(state, on)
        step = make_train_step(tpre.make_loss_fn(PRETRAIN_IMAGE, PRETRAIN_PATCH), mesh=on, learning_rate_fn=schedule)
        out[wrap] = run_variant(counters, shapes, launches, on is not None, state, step, batch, 1, 0)
        del model, state, step
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    hold_world_of_one("pretrain_m3ae", out, launches, batch=PRETRAIN_BATCH)
    return launches


def world_of_one_finetune(counters, shapes, mesh) -> dict:
    """One ARP-DT+ fine-tuning step at the flagship widths (FT_BATCH quadruples of FT_FRAME px) unwrapped and
    by DistributedDataParallel with the VIP loss's inner mean over the process group: params and loss held."""
    from arp_tpu_torch.finetune.train import build_optimizer, make_loss_fn
    from arp_tpu_torch.parallel.step import TrainState, make_train_step, shard_train_state

    cfg, clip_state, adapter_state, tokens = ft_weights()
    clip = ft_clip(cfg, clip_state, DEVICE)
    batch = on_device(quadruples(FT_BATCH, FT_FRAME, tokens, SEED + 2), DEVICE)
    out, launches = {}, dict.fromkeys(counters, 0)
    for wrap in ("unwrapped", "ddp"):
        adapter = ft_adapter(cfg, adapter_state, DEVICE)
        on = None if wrap == "unwrapped" else mesh
        if on is not None:
            adapter.batch_group = on["dp"].get_group()
        state = shard_train_state(TrainState.create(adapter, build_optimizer(adapter, FT_LR, FT_WD)), on)
        step = make_train_step(make_loss_fn(clip, train=True), mesh=on)
        out[wrap] = run_variant(counters, shapes, launches, on is not None, state, step, batch, 1, 0)
        del adapter, state, step
    hold_world_of_one("finetune", out, launches, quadruples=FT_BATCH)
    del clip, batch
    return launches


def world_of_one_ppg() -> dict:
    """One PPG minibatch step (PPO, 4,096 frames of 64 px) with the gradients averaged over the process
    group, against the same step without: the updated params bit for bit, with cuDNN's deterministic
    convolutions (its default backward adds in any order, so two runs of one step differ)."""
    from arp_tpu_torch.collect import ppg as ppg_lib
    from arp_tpu_torch.parallel.step import TrainState

    config = ppg_lib.PPGConfig(num_envs=PPG_FLAGS["num_envs"], segment_length=PPG_FLAGS["segment_length"])
    n = PPG_FLAGS["num_envs"] * PPG_FLAGS["segment_length"] // config.minibatches
    rng = np.random.default_rng(SEED)
    batch = {"obs": torch.from_numpy(rng.random((n, 64, 64, 3), dtype=np.float32)).to(DEVICE),
             "act": torch.from_numpy(rng.integers(0, 15, size=n)).to(DEVICE),
             "logp_old": torch.from_numpy(np.full(n, -np.log(15), np.float32)).to(DEVICE),
             "adv": torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(DEVICE),
             "vtarg": torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(DEVICE)}
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for wrap, sync_fn in (("unwrapped", None), ("averaged", ppg_lib.average_over_ranks)):
        model = ppg_lib.PhasicValueModel(num_actions=15, arch="dual", frame_shape=(64, 64, 3),
                                         generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
        state = TrainState.create(model, ppg_lib.make_adam(config, len(list(model.parameters()))))
        ppo_step = ppg_lib.make_ppg_steps(model, config, sync=sync_fn)[0]
        ppo_step(state, batch)
        sync()
        t0 = time.perf_counter()
        _, metrics = ppo_step(state, batch)
        sync()
        out[wrap] = {"ms": (time.perf_counter() - t0) * 1e3, "loss": float(metrics["loss"]),
                     "params": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
        del model, state
    torch.backends.cudnn.deterministic = deterministic
    equal = all(torch.equal(out["averaged"]["params"][k], v) for k, v in out["unwrapped"]["params"].items())
    check(equal and out["averaged"]["loss"] == out["unwrapped"]["loss"],
          "distributed ppg: the averaged minibatch step differs from the unwrapped one")
    emit("distributed", part="world_of_one", mode="ppg", minibatch=n, bit_equal=equal,
         **{wrap: {k: v for k, v in run.items() if k != "params"} for wrap, run in out.items()})
    return out


def _two_rank_worker(rank: int, world: int, store: str, tmp: str) -> None:
    """One of the two gloo ranks sharing the card: the flagship float32 step under DistributedDataParallel
    on this rank's 64 of the 128 rows, DIST_STEPS clipped-SGD steps from the parent's state."""
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.parallel.distributed import initialize, shutdown
    from arp_tpu_torch.parallel.mesh import MeshConfig, batch_share, create_mesh, data_share, gather_to_host
    from arp_tpu_torch.parallel.step import TrainState, make_train_step, shard_train_state
    from arp_tpu_torch.train import common

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(init_method=f"file://{store}", num_processes=world, process_id=rank, device="cpu")
    try:
        given = torch.load(os.path.join(tmp, "two_rank_start.pt"), weights_only=False)
        globals().update(given["shared"])
        pt, raw = given["pt"], given["raw"]
        mesh = create_mesh(MeshConfig(dp=-1), "cpu")  # gloo: the card's tensors go through the host
        flags, _, augment, qpack = policy_setup("float32", pt, raw)
        model = policy_model(flags, qpack, pt, raw, given["start"])
        state = shard_train_state(TrainState.create(model, ClippedSGD(DIST_SGD_LR, DIST_SGD_CLIP)), mesh)
        step = make_train_step(common.make_loss_fn(model, augment, 256, False, share=data_share(mesh)), mesh=mesh)
        attn.flash_attention_fwd.launches = 0
        run = run_policy_steps(state, step, to_device(batch_share(raw, mesh), DEVICE), DIST_STEPS, DIST_TIMED)
        launches = attn.flash_attention_fwd.launches
        run.update(params=gather_to_host(state.model), k1_launches=launches, rows=POLICY_BATCH // world)
        torch.save(run, os.path.join(tmp, f"two_rank_{rank}.pt"))
    finally:
        shutdown()


def one_process_policy_run(pt: dict, raw: dict, start: dict, share=(0, 1), timed: int = 0) -> dict:
    """DIST_STEPS clipped-SGD steps of the flagship float32 step in this process from ``start`` on the rows
    of ``raw``, as the ``share`` (index, count) of a global batch; the run and its params."""
    from arp_tpu_torch.parallel.mesh import gather_to_host
    from arp_tpu_torch.parallel.step import TrainState, make_train_step
    from arp_tpu_torch.train import common

    flags, _, augment, qpack = policy_setup("float32", pt, raw)
    model = policy_model(flags, qpack, pt, raw, start)
    state = TrainState.create(model, ClippedSGD(DIST_SGD_LR, DIST_SGD_CLIP))
    step = make_train_step(common.make_loss_fn(model, augment, 256, False, share=share))
    run = run_policy_steps(state, step, to_device(raw, DEVICE), DIST_STEPS, timed)
    run["params"] = gather_to_host(state.model)
    del model, state, step, qpack
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return run


def two_ranks_on_one_card(pt: dict, raw: dict, tmp: str) -> dict:
    """(b): the flagship float32 step over two gloo ranks that share the card (spawned processes, DDP,
    64 rows each), against one process on the 128 rows from the same state and draws.  Two faults run in
    one process show that the held figure sees a wrong average: rank 0's rows alone (a rank that skips
    the all-reduce) and the first half of the batch as a batch of its own."""
    flags, _, _, qpack = policy_setup("float32", pt, raw)
    start = {k: v.detach().cpu().clone() for k, v in policy_model(flags, qpack, pt, raw).trained_state_dict().items()}
    del qpack
    one = one_process_policy_run(pt, raw, start, timed=DIST_TIMED)
    half = head_batch(raw, POLICY_BATCH // 2)
    faults = {name: rel_to_largest(one_process_policy_run(pt, half, start, share)["params"], one["params"], start)
              for name, share in (("no_all_reduce", (0, 2)), ("half_the_batch", (0, 1)))}
    torch.save({"pt": pt, "raw": raw, "start": start, "shared": {k: globals()[k] for k in DIST_SHARED}},
               os.path.join(tmp, "two_rank_start.pt"))
    t0 = time.perf_counter()
    spawn_ranks(_two_rank_worker, tmp, "store2", DIST_TWO_RANK_TIMEOUT_S, "distributed two ranks")
    ranks = [torch.load(os.path.join(tmp, f"two_rank_{r}.pt"), weights_only=False) for r in range(2)]
    diffs = [rel_to_largest(r["params"], one["params"]) for r in ranks]
    moves = [rel_to_largest(r["params"], one["params"], start) for r in ranks]
    tensors = per_tensor_rel_diff(ranks[0]["params"], one["params"])
    worst = max(tensors, key=tensors.get)
    loss_rel = [max(abs(a - b) / abs(b) for a, b in zip(r["losses"], one["losses"])) for r in ranks]
    check(max(moves) <= DIST_TWO_RANK_MOVE_REL,
          f"distributed two ranks: params {moves} of the largest move from one process's")
    check(min(faults.values()) > DIST_TWO_RANK_MOVE_REL,
          f"distributed two ranks: a wrong average reads {faults}, within the bound {DIST_TWO_RANK_MOVE_REL}")
    check(max(loss_rel) <= DIST_TWO_RANK_LOSS_REL,
          f"distributed two ranks: losses {loss_rel} relative from one process's")
    k1 = [r["k1_launches"] for r in ranks]
    check(min(k1) > 0, f"distributed two ranks: K1 launches {k1}")
    out = {"one_process": {k: v for k, v in one.items() if k != "params"},
           "ranks": [{k: v for k, v in r.items() if k != "params"} for r in ranks],
           "param_diff_rel_to_largest_move": moves, "param_diff_rel_to_largest": diffs, "loss_rel_err": loss_rel,
           "faults_rel_to_largest_move": faults,
           "worst_tensor": {"name": worst, "rel_to_its_largest": tensors[worst],
                            "its_largest": float(one["params"][worst].abs().max()),
                            "its_largest_move": float((one["params"][worst] - start[worst]).abs().max())},
           "seconds": time.perf_counter() - t0,
           "optimizer": f"clipped SGD lr {DIST_SGD_LR} clip {DIST_SGD_CLIP}"}
    emit("distributed", part="two_gloo_ranks_one_card", mode="float32", batch=POLICY_BATCH, **out)
    return out


def _nccl_probe_worker(rank: int, world: int, store: str) -> None:
    from arp_tpu_torch.parallel.distributed import initialize, shutdown

    initialize(init_method=f"file://{store}", num_processes=world, process_id=rank, device="cuda:0", timeout_s=60)
    try:
        t = torch.ones(1, device="cuda:0")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
    finally:
        shutdown()


def nccl_two_ranks_one_card(tmp: str) -> dict:
    """Whether NCCL takes two ranks on one device: two spawned processes on cuda:0, one all-reduce."""
    t0 = time.perf_counter()
    context = torch.multiprocessing.start_processes(_nccl_probe_worker, args=(2, os.path.join(tmp, "store_nccl")),
                                                    nprocs=2, join=False, start_method="spawn")
    outcome, error = "accepted", None
    try:
        while not context.join(timeout=5):
            if time.perf_counter() - t0 > DIST_NCCL_PROBE_TIMEOUT_S:
                outcome = "timed out"
                break
    except Exception as e:  # a rank raised: NCCL refused the layout
        outcome, error = "refused", str(e)[-1500:]
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
    duplicate = error is not None and "Duplicate GPU" in error
    out = {"outcome": outcome, "duplicate_gpu_detected": duplicate, "error_tail": error,
           "seconds": time.perf_counter() - t0}
    emit("distributed", part="nccl_two_ranks_one_card", **out)
    return out


def phase_distributed(counters) -> tuple[dict, "LaunchShapes"]:
    """(a) A real NCCL world of one started in-process: the flagship train step (float32 and frozen_int8
    towers), a pretraining step, a fine-tuning step and a PPG minibatch step wrapped as several processes
    wrap them, each held against its unwrapped step, and an FSDP2 checkpoint restored unwrapped; (b) two
    gloo ranks sharing the card against one process; whether NCCL takes two ranks on one device.  Returns the
    launches of (a)'s wrapped runs and their shapes."""
    import tempfile

    from arp_tpu_torch.models.policy import flax_m3ae_to_torch
    from arp_tpu_torch.parallel.distributed import initialize, shutdown
    from arp_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    pt = flax_m3ae_to_torch(random_m3ae_variables(M3AE_DIMS, 16, BERT_VOCAB, SEED))
    raw, _ = policy_batch(POLICY_BATCH, POLICY_WINDOW, SEED)
    shapes = LaunchShapes()
    launches = dict.fromkeys(counters, 0)
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        t0 = time.perf_counter()
        rank, world = initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=1, process_id=0, device=DEVICE)
        check((rank, world) == (0, 1), f"distributed: the world of one is {(rank, world)}")
        backend = torch.distributed.get_backend()
        check(backend == ("nccl" if DEVICE != "cpu" else "gloo"), f"distributed: backend {backend}")
        mesh = create_mesh(MeshConfig(dp=1), DEVICE)
        emit("distributed", part="start", backend=backend, port=port, mesh=list(mesh.shape),
             seconds=time.perf_counter() - t0)
        try:
            for mode in DIST_MODES:
                done = world_of_one_policy(counters, shapes, mesh, mode, pt, raw,
                                           checkpoint_dir=os.path.join(tmp, "ckpt") if mode == "float32" else None)
                for name, n in done.items():
                    launches[name] += n
            for done in (world_of_one_pretrain(counters, shapes, mesh), world_of_one_finetune(counters, shapes, mesh)):
                for name, n in done.items():
                    launches[name] += n
            world_of_one_ppg()
        finally:
            shutdown()
        two_ranks_on_one_card(pt, raw, tmp)
        if DEVICE != "cpu":
            nccl_two_ranks_one_card(tmp)
    return launches, shapes


# -- mesh_tp_pp: the engines' local-device mesh, tensor and pipeline parallelism ---------------------------

MESH_CLIP = "vit_b16"  # the labeling cell's tower
MESH_FRAMES = 1024  # frames a timed labeling run: four batches of 256, after a warm-up batch
MESH_F32_RTOL, MESH_F32_ATOL = 1e-5, 1e-6  # JAX's sharded-engine bound (tests/test_finetune.py:364-372)
TP_PP_MICROBATCHES = 4  # the trainer's --mesh_pp_microbatches default
TP_PP_TIMED = 2  # steps timed after the held ones
GLOO_P2P_PROBE_TIMEOUT_S = 60.0
# what the spawned ranks take from this module as the parent holds it
TP_PP_SHARED = DIST_SHARED + ("TP_PP_MICROBATCHES", "TP_PP_TIMED")


def mesh_setups(devices_two, devices_copy):
    """label -> the engine's mesh: none, every card of the machine, two shares on one card, a copying replica."""
    from arp_tpu_torch.parallel.mesh import LocalMesh, mesh_from_count

    one = mesh_from_count(-1, devices=None if DEVICE != "cpu" else ["cpu"])
    return {"none": None, "mesh_of_one": one, "two_shares": LocalMesh(devices_two),
            "replica_copy": LocalMesh(devices_copy)}


MESH_MODES = {"float32": ({}, ("none", "mesh_of_one", "two_shares", "replica_copy")),
              "fast_int8": (dict(fast_int8=True), ("none", "mesh_of_one", "two_shares")),
              "int8_weights": (dict(quantize_weights=True), ("none", "two_shares"))}


def _pack_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _pack_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _pack_leaves(v)]
    return [tree.detach().cpu()] if isinstance(tree, torch.Tensor) else []


def mesh_engines(counters, shapes, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch) -> dict:
    """(a): labeling through the engines' local-device mesh against the unmeshed engine of the same mode; returns
    the kernels' launches over the meshed runs (noted in ``shapes``)."""
    cfg = CONFIGS[MESH_CLIP]
    state = flax_to_torch(random_clip_variables(cfg, 224, SEED))
    frames = np.random.default_rng(SEED).integers(0, 256, (MESH_FRAMES, 64, 64, 3), dtype=np.uint8)
    text = "the goal is to collect the coin."
    dev = torch.device(DEVICE, 0) if DEVICE != "cpu" else torch.device("cpu")
    copy_dev = torch.device("cuda") if DEVICE != "cpu" else torch.device("cpu", 0)
    setups = mesh_setups([dev, dev], [dev, copy_dev])
    launches = dict.fromkeys(counters, 0)
    for mode, (knobs, labels) in MESH_MODES.items():
        runs = {}
        for label in labels:
            model = CLIP(**cfg, image_size=224)
            model.load_state_dict(state)
            eng = ClipRewardEngine(model=model, batch_size=BATCH, device=DEVICE, mesh=setups[label], **knobs)
            eng.text_rewards(frames[:BATCH], text)  # a warm-up batch; the int8 engines calibrate on it
            sync()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            if setups[label] is not None:
                with shapes:
                    rewards = eng.text_rewards(frames, text)
            else:
                rewards = eng.text_rewards(frames, text)
            sync()
            seconds = time.perf_counter() - t0
            run = {"rewards": rewards, "fps": MESH_FRAMES / seconds, "seconds": seconds,
                   "launches": launch_counts(counters), "replicas": 0 if eng._replicas is None else len(eng._replicas),
                   "devices": [] if setups[label] is None else [str(d) for d in setups[label].devices]}
            if eng._fast_q is not None:
                run["pack"] = _pack_leaves(eng._fast_q)
            if setups[label] is not None:
                for name, n in run["launches"].items():
                    launches[name] += n
            runs[label] = run
            del eng, model
            if DEVICE != "cpu":
                torch.cuda.empty_cache()
        base = runs["none"]
        bound = INT8_COS_MAE * LOGIT_SCALE if mode == "fast_int8" else None  # int8 weights: K3 is row by row
        for label, run in runs.items():
            if label == "none":
                continue
            diff = np.abs(run["rewards"] - base["rewards"])
            run.update(bit_equal=bool(np.array_equal(run["rewards"], base["rewards"])), max_abs_diff=float(diff.max()),
                       fps_vs_none=run["fps"] / base["fps"])
            check(np.isfinite(run["rewards"]).all() and run["rewards"].shape == (MESH_FRAMES,),
                  f"mesh_tp_pp {mode} {label}: rewards {run['rewards'].shape}")
            if mode == "fast_int8":
                run["pack_bit_equal"] = len(run["pack"]) == len(base["pack"]) and all(
                    torch.equal(a, b) for a, b in zip(run["pack"], base["pack"]))
                check(run["pack_bit_equal"], f"mesh_tp_pp {mode} {label}: the calibrated pack differs from the unmeshed one")
            if bound is None:
                check(np.allclose(run["rewards"], base["rewards"], rtol=MESH_F32_RTOL, atol=MESH_F32_ATOL),
                      f"mesh_tp_pp {mode} {label}: rewards {run['max_abs_diff']} from the unmeshed engine's")
            else:
                check(run["max_abs_diff"] <= bound, f"mesh_tp_pp {mode} {label}: rewards {run['max_abs_diff']} > {bound}")
            kernels = {"float32": ("flash_attn_fwd",), "fast_int8": ("int8_gemm",), "int8_weights": ("int8_matmul",)}
            for name in kernels[mode]:
                check(run["launches"][name] > 0, f"mesh_tp_pp {mode} {label}: never launched {name}")
        emit("mesh_tp_pp", part="engine", mode=mode, frames=MESH_FRAMES, batch_size=BATCH,
             bound=bound or {"rtol": MESH_F32_RTOL, "atol": MESH_F32_ATOL},
             **{label: {k: v for k, v in run.items() if k not in ("rewards", "pack")} for label, run in runs.items()})
    return launches


def tp_pp_model(layout: str, mesh, pt: dict, raw: dict, start: dict):
    """(flags, augment, model) of the float32 flagship on ``mesh`` at ``layout`` ("tp": built whole, split by
    shard_train_state; "pp": its blocks in two stages), its first forward run, ``start`` loaded."""
    from arp_tpu_torch.parallel.mesh import load_full_state
    from arp_tpu_torch.train import common

    flags, _, augment, qpack = policy_setup("float32", pt, raw)
    if layout == "pp":
        flags.model.pp_stages, flags.model.pp_microbatches = 2, TP_PP_MICROBATCHES
    torch.manual_seed(SEED)
    model = common.build_model(flags, 15, frozen_qpack=qpack, pt_variables=pt, mesh=mesh).to(DEVICE)
    with torch.no_grad():
        model(to_device(head_batch(raw, 1), DEVICE), deterministic=True)
        load_full_state(model, start)
    return flags, augment, model


def _tp_pp_worker(rank: int, world: int, store: str, tmp: str) -> None:
    """One of the two gloo ranks sharing the card: the float32 flagship at tp 2 and at pp 2, and each with its
    fault, DIST_STEPS clipped-SGD steps on the 128 rows from the parent's state."""
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.parallel import pipeline, tensor_parallel
    from arp_tpu_torch.parallel.distributed import initialize, shutdown
    from arp_tpu_torch.parallel.mesh import MeshConfig, create_mesh, data_share, gather_to_host
    from arp_tpu_torch.parallel.step import TrainState, make_train_step, shard_train_state
    from arp_tpu_torch.train import common

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(init_method=f"file://{store}", num_processes=world, process_id=rank, device="cpu")
    faults = {"tp_no_row_reduce": (tensor_parallel, "reduce_from_tp", lambda x, tp: x),
              "pp_summed_cotangent": (pipeline, "_output_cotangent", tensor_parallel.all_reduce_sum)}
    try:
        given = torch.load(os.path.join(tmp, "tp_pp_start.pt"), weights_only=False)
        globals().update(given["shared"])
        pt, raw, start = given["pt"], given["raw"], given["start"]
        out = {}
        for case in ("tp", "tp_no_row_reduce", "pp", "pp_summed_cotangent"):
            layout = case[:2]
            mesh = create_mesh(MeshConfig(dp=1, tp=2) if layout == "tp" else MeshConfig(dp=1, pp=2), "cpu")
            module, name, fault = faults.get(case, (None, None, None))
            real = getattr(module, name) if module is not None else None
            if module is not None:
                setattr(module, name, fault)
            try:
                _, augment, model = tp_pp_model(layout, mesh, pt, raw, start)
                state = shard_train_state(TrainState.create(model, ClippedSGD(DIST_SGD_LR, DIST_SGD_CLIP)), mesh)
                step = make_train_step(common.make_loss_fn(model, augment, 256, False, share=data_share(mesh)),
                                       mesh=mesh)
                shapes = LaunchShapes()
                attn.flash_attention_fwd.launches = 0
                with shapes:
                    run = run_policy_steps(state, step, to_device(raw, DEVICE), DIST_STEPS,
                                           TP_PP_TIMED if case == layout else 0)
                run.update(params=gather_to_host(state.model), k1_launches=attn.flash_attention_fwd.launches,
                           k1_shapes=dict(shapes.k1), k2_shapes=dict(shapes.k2))
                if case == "tp":
                    split = model.policy.blocks_0.attn
                    run.update(local_heads=split.num_heads // split.tp.size,
                               qkv_share=list(split.qkv.kernel.shape), fc1_share=list(model.policy.blocks_0.mlp.fc1.weight.shape))
                if case == "pp":
                    run["own_blocks"] = sorted({n.split(".")[1] for n, _ in model.named_parameters()
                                                if n.startswith("policy.blocks_")})
                out[case] = run
            finally:
                if module is not None:
                    setattr(module, name, real)
            del model, state, step
            if DEVICE != "cpu":
                torch.cuda.empty_cache()
        torch.save(out, os.path.join(tmp, f"tp_pp_{rank}.pt"))
    finally:
        shutdown()


def tp_pp_two_ranks(pt: dict, raw: dict, tmp: str) -> dict:
    """(b): the float32 flagship at tp 2 and pp 2 over two gloo ranks sharing the card, each against one process
    on the same 128 rows from the same state and draws; the two faults held above the bound.  Returns the K1
    launches and the shapes of the tp and pp runs; the faults' runs are not the path's."""
    flags, _, _, qpack = policy_setup("float32", pt, raw)
    start = {k: v.detach().cpu().clone() for k, v in policy_model(flags, qpack, pt, raw).trained_state_dict().items()}
    del qpack
    one = one_process_policy_run(pt, raw, start, timed=TP_PP_TIMED)
    torch.save({"pt": pt, "raw": raw, "start": start, "shared": {k: globals()[k] for k in TP_PP_SHARED}},
               os.path.join(tmp, "tp_pp_start.pt"))
    t0 = time.perf_counter()
    spawn_ranks(_tp_pp_worker, tmp, "store_tp_pp", DIST_TWO_RANK_TIMEOUT_S, "mesh_tp_pp two ranks")
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"tp_pp_{r}.pt"), weights_only=False) for r in range(2)]
    out = {}
    for case in ranks[0]:
        runs = [r[case] for r in ranks]
        moves = [rel_to_largest(r["params"], one["params"], start) for r in runs]
        loss_rel = [max(abs(a - b) / abs(b) for a, b in zip(r["losses"], one["losses"])) for r in runs]
        same = all(torch.equal(runs[0]["params"][k], runs[1]["params"][k]) for k in runs[0]["params"])
        out[case] = {"param_diff_rel_to_largest_move": moves, "loss_rel_err": loss_rel, "ranks_equal": same,
                     "ranks": [{k: v for k, v in r.items() if k not in ("params", "k1_shapes", "k2_shapes")}
                               for r in runs]}
        if case in ("tp", "pp"):
            check(max(moves) <= DIST_TWO_RANK_MOVE_REL,
                  f"mesh_tp_pp {case}: params {moves} of the largest move from one process's")
            check(max(loss_rel) <= DIST_TWO_RANK_LOSS_REL, f"mesh_tp_pp {case}: losses {loss_rel} relative")
            check(same, f"mesh_tp_pp {case}: the two ranks end with different full parameters")
            check(min(r["k1_launches"] for r in runs) > 0, f"mesh_tp_pp {case}: a rank never launched K1")
        else:
            check(min(moves) > DIST_TWO_RANK_MOVE_REL,
                  f"mesh_tp_pp {case}: the fault reads {moves}, within the bound {DIST_TWO_RANK_MOVE_REL}")
    path = tp_pp_path_launches(ranks)
    emit("mesh_tp_pp", part="two_gloo_ranks_tp_pp", batch=POLICY_BATCH, microbatches=TP_PP_MICROBATCHES,
         bound=DIST_TWO_RANK_MOVE_REL, loss_bound=DIST_TWO_RANK_LOSS_REL, seconds=seconds,
         one_process={k: v for k, v in one.items() if k != "params"}, k1_shapes=dict(path["k1"]), **out,
         optimizer=f"clipped SGD lr {DIST_SGD_LR} clip {DIST_SGD_CLIP}")
    return path


def tp_pp_path_launches(ranks: list) -> dict:
    """The K1 launches and the K1 / K2 shapes of the ranks' tp and pp runs.  The faults' runs are broken
    programs, not the path: their launches stay in the phase's own line."""
    k1_shapes, k2_shapes = Counter(), Counter()
    for run in (r[case] for r in ranks for case in ("tp", "pp")):
        k1_shapes.update(run["k1_shapes"])
        k2_shapes.update(run["k2_shapes"])
    return {"k1": k1_shapes, "k2": k2_shapes,
            "k1_launches": sum(r[case]["k1_launches"] for r in ranks for case in ("tp", "pp"))}


def _gloo_p2p_probe_worker(rank: int, world: int, store: str, tmp: str) -> None:
    from arp_tpu_torch.parallel.distributed import initialize, shutdown

    initialize(init_method=f"file://{store}", num_processes=world, process_id=rank, device="cpu", timeout_s=30)
    try:
        if rank == 0:
            torch.distributed.send(torch.arange(4, dtype=torch.float32, device="cuda:0") + 1, 1)
        else:
            buf = torch.zeros(4, device="cuda:0")
            torch.distributed.recv(buf, 0)
            torch.cuda.synchronize()
            if not torch.equal(buf.cpu(), torch.arange(4, dtype=torch.float32) + 1):
                raise RuntimeError(f"gloo received {buf.cpu().tolist()}")
    finally:
        shutdown()


def gloo_p2p_on_cuda(tmp: str) -> dict:
    """Whether gloo takes CUDA tensors in send / recv: two spawned ranks, one send of four floats on cuda:0."""
    t0 = time.perf_counter()
    context = torch.multiprocessing.start_processes(_gloo_p2p_probe_worker, args=(2, os.path.join(tmp, "store_p2p"), tmp),
                                                    nprocs=2, join=False, start_method="spawn")
    outcome, error = "accepted", None
    try:
        while not context.join(timeout=5):
            if time.perf_counter() - t0 > GLOO_P2P_PROBE_TIMEOUT_S:
                outcome = "timed out"
                break
    except Exception as e:  # a rank raised or died: gloo refused the CUDA tensor
        outcome, error = "refused", str(e)[-1500:]
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
    out = {"outcome": outcome, "error_tail": error, "seconds": time.perf_counter() - t0,
           "transport": "host copies under gloo (parallel/pipeline.py)"}
    emit("mesh_tp_pp", part="gloo_p2p_cuda", **out)
    return out


def phase_mesh_tp_pp(counters, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch) -> tuple[dict, "LaunchShapes"]:
    """(a) the engines' local-device mesh; (b) tp and pp over two gloo ranks on the card; whether gloo takes
    CUDA tensors point to point.  Returns the launches of (a)'s meshed runs and (b)'s ranks, and the shapes
    both launched."""
    import tempfile

    from arp_tpu_torch.models.policy import flax_m3ae_to_torch

    t0 = time.perf_counter()
    shapes = LaunchShapes()
    launches = mesh_engines(counters, shapes, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch)
    pt = flax_m3ae_to_torch(random_m3ae_variables(M3AE_DIMS, 16, BERT_VOCAB, SEED))
    raw, _ = policy_batch(POLICY_BATCH, POLICY_WINDOW, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = tp_pp_two_ranks(pt, raw, tmp)
        if DEVICE != "cpu":
            gloo_p2p_on_cuda(tmp)
    shapes.k1.update(ranks["k1"])
    shapes.k2.update(ranks["k2"])
    launches["flash_attn_fwd"] += ranks["k1_launches"]
    emit("mesh_tp_pp", part="end", launches=launches, seconds=time.perf_counter() - t0)
    return launches, shapes


# -- phase drivers: the device half of the drivers (stub_benchmark's tiny reward CLIP) -----------------------

DRIVERS_CLIP_BATCH = 32  # stub_benchmark's smoke clip_batch
DRIVERS_CLIP_STEPS = 80  # its smoke clip_steps: the length of the step's cosine schedule
DRIVERS_WARMUP, DRIVERS_TIMED = 2, 5
DRIVERS_ENGINE_BATCH = 256  # the driver's engines' batch (train_tiny_clip, stage_label)
DRIVERS_REWARD_FRAMES = 64
# The card's step against the CPU's from one init and batch: the train phase's bounds (loss 1e-5 relative;
# gradients 1e-4 of the largest entry; params after Adam 2e-5, outside the entries whose CPU gradient is within
# the gradient bound of 0, where Adam's first step moves by +-lr on the sign alone).  The spec's rewards: the
# float32 labeling bound.
DRIVERS_LOSS_REL, DRIVERS_GRAD_REL, DRIVERS_PARAM_ATOL = 1e-5, 1e-4, 2e-5


def drivers_tokens() -> np.ndarray:
    """The tiny reward CLIP's four texts (the instruction and three distractors) as Char97 ids, (4, 77)."""
    from arp_tpu_torch.drivers import stub_benchmark as sb
    from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer

    return Char97Tokenizer()(sb.clip_texts(sb.SPLITS["reward"]["game"])).astype(np.int64)


def drivers_attention_dims() -> tuple:
    """((tokens, heads, head_dim) of the vision tower, (77, heads, head_dim) of the text tower) of the tiny reward CLIP."""
    from arp_tpu_torch.drivers import stub_benchmark as sb

    cfg = sb.REWARD_CLIP_CFG
    vision = ((sb.IMG // cfg["vision_patch_size"]) ** 2 + 1, cfg["vision_features"] // 64, 64)
    return vision, (77, cfg["text_num_heads"], cfg["text_features"] // cfg["text_num_heads"])


def tensorstore_probe() -> dict:
    """Whether tensorstore (the JAX package's orbax directories' reader) imports here, and its version."""
    import importlib.metadata

    try:
        import tensorstore  # noqa: F401
    except Exception as e:  # missing, or broken
        return {"tensorstore": False, "version": None, "error": repr(e)}
    return {"tensorstore": True, "version": importlib.metadata.version("tensorstore")}


def phase_drivers(counters) -> tuple[dict, "LaunchShapes"]:
    """The drivers' device half, from arrays (the card's machine has no h5py): stub_benchmark's tiny reward CLIP
    (REWARD_CLIP_CFG at 32 px, the smoke batch of 32, four texts).  Whether tensorstore imports; one training step
    on the card and on the CPU from one init and batch (loss, gradients, params after Adam); then ms a step (median
    of DRIVERS_TIMED after DRIVERS_WARMUP) with K1's launches and shapes (forward on the card, plain backward);
    the trained tower's save_npz -> from_npz round trip and its rewards on DRIVERS_REWARD_FRAMES frames on the
    card against a CPU engine of the same spec."""
    import tempfile

    from arp_tpu_torch.drivers import stub_benchmark as sb
    from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
    from arp_tpu_torch.reward.engine import ClipRewardEngine

    t0 = time.perf_counter()
    emit("drivers", part="tensorstore", **tensorstore_probe())
    variables = sb.init_reward_clip_variables(SEED)
    ids = drivers_tokens()
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, size=(DRIVERS_CLIP_BATCH, sb.IMG, sb.IMG, 3), dtype=np.uint8)
    prog = rng.uniform(0, 1, DRIVERS_CLIP_BATCH).astype(np.float32)

    def inputs(device):
        return tuple(torch.from_numpy(a).to(device) for a in (frames, prog, ids))

    def one_step(device):
        model = sb.reward_clip_model(variables).to(device)
        opt, state = sb.clip_optimizer(model, DRIVERS_CLIP_STEPS)
        loss, grads = sb.clip_gradients(model, *inputs(device))
        opt.update([p.detach() for p in model.parameters()], grads, state)
        sync()
        return dict(loss=float(loss), grads=[g.cpu() for g in grads],
                    params=[p.detach().cpu() for p in model.parameters()], names=[n for n, _ in model.named_parameters()])

    cpu, card = one_step("cpu"), one_step(DEVICE)
    gmax = max(float(g.abs().max()) for g in cpu["grads"])
    errs = [float((a - b).abs().max()) / gmax for a, b in zip(cpu["grads"], card["grads"])]
    worst = max(range(len(errs)), key=errs.__getitem__)
    settled = [g.abs() > DRIVERS_GRAD_REL * gmax for g in cpu["grads"]]
    param_err = max(float(((a - b).abs() * m).max()) for a, b, m in zip(cpu["params"], card["params"], settled))
    compared = dict(batch=DRIVERS_CLIP_BATCH, loss_cpu=cpu["loss"],
                    loss_rel_err=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]), grad_max_abs=gmax,
                    grad_err_rel_to_max=errs[worst], worst_grad=cpu["names"][worst], param_max_abs_err=param_err,
                    param_entries=sum(p.numel() for p in cpu["params"]),
                    param_entries_left_out=sum(int((~m).sum()) for m in settled))
    emit("drivers", part="tiny_clip_vs_cpu", **compared)
    check(compared["loss_rel_err"] <= DRIVERS_LOSS_REL,
          f"drivers: tiny CLIP step loss, card vs CPU {compared['loss_rel_err']} relative")
    check(compared["grad_err_rel_to_max"] <= DRIVERS_GRAD_REL,
          f"drivers: tiny CLIP step gradients, card vs CPU {errs[worst]} of the largest ({compared['worst_grad']})")
    check(param_err <= DRIVERS_PARAM_ATOL, f"drivers: tiny CLIP params after Adam, card vs CPU max abs {param_err}")

    model = sb.reward_clip_model(variables).to(DEVICE)
    opt, state = sb.clip_optimizer(model, DRIVERS_CLIP_STEPS)
    on_card = inputs(DEVICE)
    for _ in range(DRIVERS_WARMUP):
        state, _ = sb.clip_step(model, opt, state, *on_card)
    sync()
    reward_frames = rng.integers(0, 256, size=(DRIVERS_REWARD_FRAMES, sb.IMG, sb.IMG, 3), dtype=np.uint8)
    text = sb.clip_texts(sb.SPLITS["reward"]["game"])[0]
    for fn in counters.values():
        fn.launches = 0
    times = []
    with tempfile.TemporaryDirectory() as tmp, LaunchShapes() as noted, K1Recorder() as rec:
        for _ in range(DRIVERS_TIMED):
            t1 = time.perf_counter()
            state, loss = sb.clip_step(model, opt, state, *on_card)
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
        step_shapes = rec.counts()
        # the spec, as train_tiny_clip writes it and stage_label reads it
        with torch.no_grad():
            model.logit_scale.fill_(float(np.float32(np.log(100.0))))
        spec = os.path.join(tmp, "reward_clip.npz")
        ClipRewardEngine(model=model, batch_size=DRIVERS_ENGINE_BATCH, image_size=sb.IMG, tokenizer=Char97Tokenizer(),
                         device=DEVICE).save_npz(spec)
        t1 = time.perf_counter()
        card_engine = ClipRewardEngine.from_npz(spec, batch_size=DRIVERS_ENGINE_BATCH, device=DEVICE)
        got = card_engine.text_rewards(reward_frames, text)
        reward_ms = (time.perf_counter() - t1) * 1e3
        launches = launch_counts(counters)
        want = ClipRewardEngine.from_npz(spec, batch_size=DRIVERS_REWARD_FRAMES, device="cpu").text_rewards(
            reward_frames, text)
    mae = float(np.abs(got - want).mean())
    vision_layers, text_layers = sb.REWARD_CLIP_CFG["vision_num_layers"], sb.REWARD_CLIP_CFG["text_num_layers"]
    per_step = vision_layers + text_layers  # every block's attention: K1 forward, the plain backward
    ms = float(np.median(times))
    emit("drivers", part="tiny_clip", batch=DRIVERS_CLIP_BATCH, ms=ms, step_ms=times,
         fps=DRIVERS_CLIP_BATCH / ms * 1e3, loss=float(loss), launches=launches, k1_step_shapes=step_shapes, k1_keys=dict(noted.k1),
         spec_reward_frames=DRIVERS_REWARD_FRAMES, spec_reward_ms=reward_ms, spec_reward_mae_vs_cpu=mae,
         seconds=time.perf_counter() - t0)
    check(np.isfinite(float(loss)), f"drivers: tiny CLIP loss {float(loss)}")
    check(mae <= F32_REWARD_MAE, f"drivers: the spec's rewards on the card vs the CPU engine, MAE {mae}")
    check(launches["flash_attn_fwd"] == per_step * (DRIVERS_TIMED + 1) and launches["int8_gemm"] == 0
          and launches["int8_matmul"] == 0,
          f"drivers: launches {launches}, expected K1 {per_step} a step and {per_step} for the spec's rewards")
    check(sum(step_shapes.values()) == per_step * DRIVERS_TIMED and all(k.endswith(" grad") for k in step_shapes),
          f"drivers: a K1 launch of the step without a gradient: {step_shapes}")
    return launches, noted


def kernel_entry(name: str, launches: int, max_abs_err: float, timing: dict, **extra) -> dict:
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
            "shape": timing["shape"], **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from arp_tpu_torch import serve
    from arp_tpu_torch.models import m3ae as m3ae_lib
    from arp_tpu_torch.models import policy as policy_lib
    from arp_tpu_torch.models.clip import CLIP, CONFIGS, flax_to_torch
    from arp_tpu_torch.models.policy import flax_m3ae_to_torch
    from arp_tpu_torch.ops import _build, m3ae_infer, preprocess, quantization, vit_infer
    from arp_tpu_torch.ops import attention as attn
    from arp_tpu_torch.ops.masks import MaskSpec, materialize_mask
    from arp_tpu_torch.reward.engine import ClipRewardEngine
    from arp_tpu_torch.reward.labeler import label_group

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build_all(tuple(KERNELS))
    emit("build", seconds=time.perf_counter() - t0, kernels={
        name: {"library": str(lib),
               "ptxas": [line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line or "Performance Loss" in line
                         or "C75" in line]}
        for name, (lib, log) in built.items()})
    for name, (_, log) in built.items():
        check(not ptxas_faults(log), f"ptxas on {name}: {ptxas_faults(log)}")
    counters = {"flash_attn_fwd": attn.flash_attention_fwd, "int8_gemm": vit_infer.fused_int8_matmul,
                "int8_matmul": quantization.int8_matmul}

    k1 = phase_k1(attn, MaskSpec, materialize_mask)
    k2 = phase_k2(vit_infer, quantization)
    k3 = phase_k3(quantization)
    phase_resize(preprocess)
    launches = dict.fromkeys(KERNELS, 0)
    launches["flash_attn_fwd"] = phase_slice(attn, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch, label_group)
    for name, n in phase_slice_fast(counters, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch, label_group).items():
        launches[name] += n
    for name, n in launches.items():
        check(n > 0, f"the labeling runs never launched {name}")
    # the policy's serving path: the tower alone, the policy, the server; each run's launches
    # are counted from 0 just before it
    path_launches = {"m3ae": phase_m3ae(counters, attn, m3ae_lib, m3ae_infer, flax_m3ae_to_torch)}
    path_launches["policy"], keep = phase_policy(counters, attn, policy_lib, flax_m3ae_to_torch)
    path_launches["train"] = phase_train(counters, attn, policy_lib, flax_m3ae_to_torch)
    path_launches["serve"] = phase_serve(counters, keep, policy_lib, serve)
    del keep
    # ARP-DT+: the adapter's fine-tuning step, and labeling with the clip_ft engine
    weights = ft_weights()
    path_launches["finetune"] = phase_finetune(counters, weights)
    path_launches["slice_ft"] = phase_slice_ft(counters, weights, label_group, vit_infer)
    # stage 5: rollout eval with on-the-fly rewards through build_test_step
    path_launches["rollout"], shapes = phase_rollout(counters, weights, policy_lib, flax_m3ae_to_torch)
    del weights
    # the reward server over the labeling engines, and labeling with the host resize
    path_launches["reward_serve"], serve_shapes = phase_reward_serve(counters, preprocess)
    # the flagship written in the reference's format and started from it (--load_checkpoint)
    path_launches["reference_checkpoint"], ref_shapes = phase_reference_checkpoint(counters, policy_lib,
                                                                                   flax_m3ae_to_torch)
    # stage 1's device half: the PPG expert; and labeling with a ModifiedResNet CLIP
    path_launches["ppg"] = phase_ppg(counters)
    path_launches["clip_resnet"], resnet_shapes = phase_clip_resnet(counters, ClipRewardEngine, CLIP, CONFIGS,
                                                                    flax_to_torch, label_group)
    # M3AE pretraining: the train step at the JAX trainer's default model, and ResNet18's train-mode forward
    path_launches["pretrain_m3ae"], pretrain_shapes = phase_pretrain_m3ae(counters)
    # several processes: the wrapped train states in a world of one over NCCL, two gloo ranks on the card
    path_launches["distributed"], dist_shapes = phase_distributed(counters)
    # the rest of the parallel layer: the engines' local-device mesh, tp and pp over two gloo ranks on the card
    path_launches["mesh_tp_pp"], mesh_shapes = phase_mesh_tp_pp(counters, ClipRewardEngine, CLIP, CONFIGS, flax_to_torch)
    # the drivers' device half: stub_benchmark's tiny reward CLIP trained through K1, and its engine spec
    path_launches["drivers"], drivers_shapes = phase_drivers(counters)
    for path, noted in (("rollout", shapes), ("reward_serve", serve_shapes), ("reference_checkpoint", ref_shapes),
                        ("clip_resnet", resnet_shapes), ("pretrain_m3ae", pretrain_shapes),
                        ("distributed", dist_shapes), ("mesh_tp_pp", mesh_shapes), ("drivers", drivers_shapes)):
        unheld = sorted(set(noted.k1) - k1["checked"]) + sorted(set(noted.k2) - k2["checked"])
        check(not unheld, f"the {path} runs launched kernels at shapes that no check held against the plain "
              f"version: {unheld}")
    # the PPG path runs no kernel of the port (convolutions); the ResNet engine runs K1 in its text tower
    path_kernels = {"finetune": ("flash_attn_fwd",), "ppg": (), "clip_resnet": ("flash_attn_fwd",),
                    "pretrain_m3ae": ("flash_attn_fwd",), "drivers": ("flash_attn_fwd",),
                    "mesh_tp_pp": ("flash_attn_fwd", "int8_gemm", "int8_matmul")}  # others: K1, K2
    for path, counts in path_launches.items():
        for name in path_kernels.get(path, ("flash_attn_fwd", "int8_gemm")):
            check(counts[name] > 0, f"the {path} runs never launched {name}")
        for name in ("flash_attn_fwd", "int8_gemm", "int8_matmul"):
            launches[name] += counts.get(name, 0)

    def shapes(timings, labels):
        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {label: {key: timings[label][key] for key in keys} for label in labels}

    fc = k2["timings"]["fc"]
    k1_f32 = k1["timings"]["vit_b16_float32"]
    print(json.dumps({"kernels": [
        kernel_entry("flash_attn_fwd", launches["flash_attn_fwd"], k1["max_abs_err"]["bfloat16"],
                     k1["timings"]["vit_b16_bfloat16"], dtype="bfloat16",
                     float32={"max_abs_err": k1["max_abs_err"]["float32"],
                              **{key: k1_f32[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
                     launches_by_path={"labeling": launches["flash_attn_fwd"] - sum(c["flash_attn_fwd"] for c in path_launches.values()),
                                       **{path: c["flash_attn_fwd"] for path, c in path_launches.items()}},
                     policy_path=shapes(k1["timings"], ("m3ae_n257_bfloat16", "m3ae_n257_float32", "m3ae_goal_n513_bfloat16",
                                                        "policy_d16_dt_n12_float32", "policy_d16_dt_n12_bfloat16")),
                     finetune_path=shapes(k1["timings"], ("finetune_vit_float32", "finetune_text_float32")),
                     pretrain_path=shapes(k1["timings"], ("pretrain_encoder_float32", "pretrain_decoder_d32_float32")),
                     drivers_path=shapes(k1["timings"], ("drivers_clip_vit_float32", "drivers_clip_text_float32"))),
        kernel_entry("int8_gemm", launches["int8_gemm"], k2["max_abs_err"], fc,
                     bf16_matmul_ms=fc["bf16_matmul_ms"], max_bf16_ulps=k2["max_bf16_ulps"],
                     launches_by_path={"labeling": launches["int8_gemm"] - sum(c["int8_gemm"] for c in path_launches.values()),
                                       **{path: c["int8_gemm"] for path, c in path_launches.items()}},
                     policy_path=shapes(k2["timings"], tuple(K2_M3AE_SITES)),
                     serve_path=shapes(k2["timings"], tuple(K2_SERVE_SITES))),
        kernel_entry("int8_matmul", launches["int8_matmul"], k3["max_abs_err"],
                     k3["timings"]["fc_768x3072_float32"], dtype="float32",
                     launches_by_path={"labeling": launches["int8_matmul"] - sum(c.get("int8_matmul", 0) for c in path_launches.values()),
                                       **{path: c.get("int8_matmul", 0) for path, c in path_launches.items()}}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
