"""The ARPDT flagship's train step (arXiv:2309.10790; jobs/train_procgen.sh) as plain functions.

One step: the batch's frames augmented on the device from the step's generator (a random 0.8 crop
resized back with bilinear weights, then color jitter, as the JAX trainer's ``random_crop`` and
``color_jitter``), the frozen M3AE ViT-B/16 tower (Geng et al., arXiv:2205.14204) over each frame's
patches, the gated adapter, the return-conditioned transformer over (observation, return, action)
tokens under the decision-transformer mask, the ensembles' action and return heads, cross entropy plus
the return's squared error, then optax's ``chain(clip_by_global_norm, adamw)`` at the warmup-cosine
schedule.  Weights are a dict in the PyTorch port's names; the tower's are ``pt_model.*``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .clip import attention

LN_EPS = 1e-6
PROCGEN_MEAN = (0.5762, 0.5503, 0.5213)
PROCGEN_STD = (0.3207, 0.3169, 0.3307)
_TO_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))
_GRAY = (0.299, 0.587, 0.114)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The trainer's stream for one step: a function of (seed, step)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


# -- augmentation ---------------------------------------------------------------------------------

def bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize``'s bilinear (triangle) kernel, antialiased when it
    shrinks, each output's weights summing to 1."""
    inv = n_in / n_out
    kscale = max(np.float32(inv), np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * np.float32(inv) - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kscale
    w = np.maximum(np.float32(0), 1 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = ((sample >= -0.5) & (sample <= n_in - 0.5))[None, :]
    return np.where(inside, w, 0).astype(np.float32)


def draw(n: int, size: int, crop: int, gen: torch.Generator) -> dict:
    """The step's draws in the trainer's order: crop corners (rows, then columns), then brightness,
    contrast and saturation factors in [0.6, 1.4] and the hue in [-0.5, 0.5]."""
    dev = gen.device
    out = {"y0": torch.randint(0, size - crop + 1, (n,), generator=gen, device=dev),
           "x0": torch.randint(0, size - crop + 1, (n,), generator=gen, device=dev)}
    for name, lo, hi in (("brightness", 0.6, 1.4), ("contrast", 0.6, 1.4), ("saturation", 0.6, 1.4),
                         ("hue", -0.5, 0.5)):
        out[name] = torch.rand(n, generator=gen, device=dev) * (hi - lo) + lo
    return out


def _crop_weights(offsets: torch.Tensor, size: int, crop: int) -> torch.Tensor:
    base = torch.from_numpy(bilinear_matrix(crop, size)).to(offsets.device)
    rows = torch.arange(size, device=offsets.device)[None, :] - offsets[:, None]
    inside = (rows >= 0) & (rows < crop)
    return base[rows.clamp(0, crop - 1)] * inside[..., None].float()


def augment(frames: torch.Tensor, d: dict, crop: int) -> torch.Tensor:
    """uint8 (n, S, S, 3) -> normalized float32 (n, S, S, 3) with the draws ``d``."""
    n, size = frames.shape[0], frames.shape[1]
    x = frames.float() / torch.full((), 255.0, device=frames.device)
    x = torch.einsum("nhwc,nhH->nHwc", x, _crop_weights(d["y0"], size, crop))
    x = torch.einsum("nhwc,nwW->nhWc", x, _crop_weights(d["x0"], size, crop))
    gray_w = torch.tensor(_GRAY, device=x.device)
    x = x * d["brightness"][:, None, None, None]
    mean = (x * gray_w).sum(-1, keepdim=True).mean(dim=(1, 2, 3), keepdim=True)
    x = mean + (x - mean) * d["contrast"][:, None, None, None]
    gray = (x * gray_w).sum(-1, keepdim=True)
    x = gray + (x - gray) * d["saturation"][:, None, None, None]
    theta = (d["hue"] * math.pi).double()
    cos_t, sin_t = torch.cos(theta).float(), torch.sin(theta).float()
    one, zero = torch.ones_like(cos_t), torch.zeros_like(cos_t)
    rot = torch.stack([torch.stack([one, zero, zero], -1), torch.stack([zero, cos_t, -sin_t], -1),
                       torch.stack([zero, sin_t, cos_t], -1)], -2)
    to_yiq = torch.tensor(_TO_YIQ, device=x.device)
    x = torch.einsum("nhwc,ndc->nhwd", x, torch.linalg.inv(to_yiq) @ rot @ to_yiq).clamp(0.0, 1.0)
    return (x - torch.tensor(PROCGEN_MEAN, device=x.device)) / torch.tensor(PROCGEN_STD, device=x.device)


# -- the frozen tower and the policy ---------------------------------------------------------------

def sincos(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / np.power(np.float32(10000.0), np.arange(dim // 2, dtype=np.float32) / np.float32(dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float32), omega.astype(np.float32))
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(dim: int, length: int) -> np.ndarray:
    side = int(round(length ** 0.5))
    axis = np.arange(side, dtype=np.float32)
    grid = np.stack(np.meshgrid(axis, axis), axis=0).reshape(2, 1, side, side)
    return np.concatenate([sincos(dim // 2, grid[0]), sincos(dim // 2, grid[1])], axis=1)


def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def block(w: dict, name: str, x: torch.Tensor, heads: int, mask=None, mlp_bias: bool = True) -> torch.Tensor:
    """A pre-norm block: fused qkv (Flax layout, with bias), attention, out projection; tanh-GELU MLP."""
    b, n, d = x.shape
    y = _ln(w, f"{name}.norm1", x)
    qkv = y @ w[f"{name}.attn.qkv.kernel"] + w[f"{name}.attn.qkv.bias"]
    q, k, v = (t.reshape(b, n, heads, d // heads) for t in qkv.chunk(3, dim=-1))
    a = attention(q, k, v, mask).reshape(b, n, d)
    x = x + F.linear(a, w[f"{name}.attn.attn_out.weight"], w[f"{name}.attn.attn_out.bias"])
    y = _ln(w, f"{name}.norm2", x)
    bias = (lambda k: w[f"{name}.mlp.{k}.bias"]) if mlp_bias else (lambda k: None)  # noqa: E731
    y = F.gelu(F.linear(y, w[f"{name}.mlp.fc1.weight"], bias("fc1")), approximate="tanh")
    return x + F.linear(y, w[f"{name}.mlp.fc2.weight"], bias("fc2"))


def tower(w: dict, images: torch.Tensor, depth: int, heads: int, patch: int = 16) -> torch.Tensor:
    """The frozen M3AE encoder on normalized (n, S, S, 3) images: [cls, patches] -> (n, 1 + N, D)."""
    n, s = images.shape[0], images.shape[1]
    g = s // patch
    x = images.reshape(n, g, patch, g, patch, 3).permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, patch * patch * 3)
    p = "pt_model."
    x = F.linear(x, w[p + "image_embedding.weight"], w[p + "image_embedding.bias"])
    x = x + torch.from_numpy(sincos_2d(x.shape[-1], g * g)).to(x.device)[None]
    x = x + w[p + "encoder_image_type_embedding"]
    x = torch.cat([w[p + "cls_token"].expand(n, 1, -1), x], dim=1)
    for i in range(depth):
        x = block(w, f"{p}encoder.blocks_{i}", x, heads)
    return _ln(w, p + "encoder.norm", x)


def heads(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """The ensemble's two-layer heads, averaged: (..., D) -> (..., out)."""
    h = F.relu(torch.einsum("rd,edh->erh", x.reshape(-1, x.shape[-1]), w[f"{name}.heads.Dense_0.kernel"])
               + w[f"{name}.heads.Dense_0.bias"][:, None, :])
    out = torch.einsum("erh,eho->ero", h, w[f"{name}.heads.Dense_1.kernel"]).mean(dim=0)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def dt_mask(n: int, per_step: int, obs: int, device) -> torch.Tensor:
    i = torch.arange(n, device=device)
    q, k = i[:, None], i[None, :]
    return (k <= q) | ((q // per_step == k // per_step) & (q % per_step < obs) & (k % per_step < obs))


def policy(w: dict, emb: torch.Tensor, rtg: torch.Tensor, action: torch.Tensor, cfg: dict) -> tuple:
    """(action logits, return predictions), each (B, T, .), from the tower's (B * T, 1 + N, D) output,
    returns-to-go (B, T, 1) and actions (B, T); the actions' slot of the last step may hold a placeholder,
    which no prediction of that step sees."""
    b, t = action.shape
    res = torch.sigmoid(w["residual_weight"])
    a = F.relu(F.linear(emb, w["AdapterMLP_0.Dense_0.weight"], w["AdapterMLP_0.Dense_0.bias"]))
    a = F.relu(F.linear(a, w["AdapterMLP_0.Dense_1.weight"], w["AdapterMLP_0.Dense_1.bias"]))
    emb = (res * a + (1 - res) * emb).reshape(b, t, -1)
    obs = torch.tanh(F.linear(emb, w["image_text_input.weight"], w["image_text_input.bias"]))
    ret = F.linear(rtg, w["rtg_input.weight"])
    act = w["action_input.weight"][action]
    x = torch.cat([obs, ret, act], dim=-1).reshape(b, 3 * t, -1)
    mask = dt_mask(3 * t, 3, 1, x.device)[None, None]
    for i in range(cfg["depth"]):
        x = block(w, f"policy.blocks_{i}", x, cfg["num_heads"], mask, mlp_bias=False)
    x = _ln(w, "policy.norm", x)
    return heads(w, "action_outputs", x[:, 1::3]), heads(w, "return_outputs", x[:, 0::3])


def loss(w: dict, emb: torch.Tensor, rtg: torch.Tensor, action: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The ARPDT loss: cross entropy of the actions (the mean over every logit's entry) plus the return's
    squared error."""
    logits, ret_pred = policy(w, emb, rtg, action, cfg)
    onehot = F.one_hot(action, logits.shape[-1]).float()
    ce = (-onehot * F.log_softmax(logits, dim=-1)).mean()
    return ce + cfg["lambda_return_pred"] * torch.square(ret_pred - rtg).mean()


def eval_transform(frames: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 (n, h, w, 3) -> (n, size, size, 3): ``jax.image.resize``'s bilinear, /255, Procgen's mean and std."""
    x = frames.float()
    if x.shape[1] != size:
        x = torch.einsum("nhwc,hH->nHwc", x, torch.from_numpy(bilinear_matrix(x.shape[1], size)).to(x.device))
    if x.shape[2] != size:
        x = torch.einsum("nhwc,wW->nhWc", x, torch.from_numpy(bilinear_matrix(x.shape[2], size)).to(x.device))
    x = x / 255.0
    return (x - torch.tensor(PROCGEN_MEAN, device=x.device)) / torch.tensor(PROCGEN_STD, device=x.device)


# -- the optimizer -----------------------------------------------------------------------------------

def learning_rate(count: int, peak: float, warmup: int, total: int) -> float:
    """optax's warmup_cosine_decay_schedule from 0 to ``peak`` and down to 0, in float32."""
    f = np.float32
    if count < warmup:
        frac = f(1) - f(min(max(count, 0), warmup)) / f(warmup)
        return float((f(0) - f(peak)) * frac + f(peak))
    c = f(min(count - warmup, total - warmup))
    return float(f(peak) * (f(0.5) * (f(1) + np.cos(f(math.pi) * c / f(total - warmup)))))


def adamw(params: dict, grads: dict, state: dict, lr: float, wd: float, clip: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One optax ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps, wd))`` step, in place; ``state``
    holds ``count``, ``mu`` and ``nu``."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    state["count"] += 1
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(state["count"]))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(state["count"]))
    for k, p in params.items():
        g = grads[k] * scale
        state["mu"][k] = (1 - b1) * g + b1 * state["mu"][k]
        state["nu"][k] = (1 - b2) * g * g + b2 * state["nu"][k]
        update = (state["mu"][k] / c1) / (torch.sqrt(state["nu"][k] / c2) + eps) + wd * p
        p.data.add_(update, alpha=-lr)


def train_steps(weights: dict, trained: list, batches: list, cfg: dict, seed: int, first_step: int,
                device, frames_block: int = 128) -> dict:
    """``len(batches)`` steps from ``weights`` (trained names in ``trained``), each on a host batch
    {"image": (B, T, S, S, 3) uint8, "rtg": (B, T, 1), "action": (B, T)}; returns each step's loss, the
    first step's clipped gradient and the trained parameters after the last step."""
    frozen = {k: v for k, v in weights.items() if k not in trained}
    params = {k: weights[k].detach().clone().requires_grad_(True) for k in trained}
    state = {"count": first_step, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
             "nu": {k: torch.zeros_like(p) for k, p in params.items()}}
    crop = int(cfg["image_size"] * (int(cfg["image_size"] * 0.8) / cfg["image_size"]))
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        step = first_step + i
        frames = torch.from_numpy(batch["image"]).to(device)
        b, t = frames.shape[:2]
        frames = frames.reshape(b * t, *frames.shape[2:])
        d = draw(b * t, frames.shape[1], crop, step_generator(seed, step, device))
        with torch.no_grad():
            emb = torch.cat([tower(frozen, augment(frames[s:s + frames_block], {k: v[s:s + frames_block]
                             for k, v in d.items()}, crop), cfg["tower_depth"], cfg["tower_heads"], cfg["patch"])
                             for s in range(0, b * t, frames_block)])
        value = loss({**frozen, **params}, emb, torch.from_numpy(batch["rtg"]).to(device).float(),
                     torch.from_numpy(batch["action"]).to(device).long(), cfg)
        grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
        losses.append(float(value.detach()))
        if first_grad is None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = 1.0 if float(norm) < cfg["clip_gradient"] else cfg["clip_gradient"] / float(norm)
            first_grad = {k: g * scale for k, g in grads.items()}
        lr = learning_rate(state["count"], cfg["lr"], cfg["warmup_steps"], cfg["total_steps"])
        with torch.no_grad():
            adamw(params, grads, state, lr, cfg["weight_decay"], cfg["clip_gradient"])
    return {"losses": losses, "first_grad": first_grad, "params": {k: p.detach() for k, p in params.items()}}
