"""The ARPDT flagship's train step under data parallelism, as plain functions (``arpdt.py``'s step, shard by
shard).

A global batch of ``shards`` x B rows splits into contiguous shards of B rows, one a rank.  The step's draws
are made for the whole global batch from the step's (seed, step) stream, and each shard's frames take their
rows' draws; each shard's loss (the mean over its rows) and its gradient are computed apart, and the step's
gradient is their mean (the ranks' all-reduce), its loss the mean of the shards' losses (the ranks' average of
the loss they report).  Then ``arpdt.adamw``'s update, the same on every rank.
"""

from __future__ import annotations

import torch

from . import arpdt


def train_steps(weights: dict, trained: list, batches: list, cfg: dict, seed: int, first_step: int, device,
                shards: int, frames_block: int = 128) -> dict:
    """``len(batches)`` steps from ``weights`` on global host batches {"image": (shards * B, T, S, S, 3) uint8,
    "rtg": (shards * B, T, 1), "action": (shards * B, T)}; returns each step's loss, the first step's clipped
    gradient and the trained parameters after the last step, as ``arpdt.train_steps`` does."""
    frozen = {k: v for k, v in weights.items() if k not in trained}
    params = {k: weights[k].detach().clone().requires_grad_(True) for k in trained}
    state = {"count": first_step, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
             "nu": {k: torch.zeros_like(p) for k, p in params.items()}}
    size = cfg["image_size"]
    crop = int(size * (int(size * 0.8) / size))
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        step = first_step + i
        rows, t = batch["action"].shape
        b = rows // shards
        d = arpdt.draw(rows * t, size, crop, arpdt.step_generator(seed, step, device))
        shard_losses, grads = [], {k: torch.zeros_like(p) for k, p in params.items()}
        for s in range(shards):
            frames = torch.from_numpy(batch["image"][s * b:(s + 1) * b]).to(device)
            frames = frames.reshape(b * t, *frames.shape[2:])
            mine = {k: v[s * b * t:(s + 1) * b * t] for k, v in d.items()}
            with torch.no_grad():
                emb = torch.cat([arpdt.tower(frozen, arpdt.augment(frames[o:o + frames_block],
                                                                   {k: v[o:o + frames_block] for k, v in mine.items()},
                                                                   crop),
                                             cfg["tower_depth"], cfg["tower_heads"], cfg["patch"])
                                 for o in range(0, b * t, frames_block)])
            value = arpdt.loss({**frozen, **params}, emb,
                               torch.from_numpy(batch["rtg"][s * b:(s + 1) * b]).to(device).float(),
                               torch.from_numpy(batch["action"][s * b:(s + 1) * b]).to(device).long(), cfg)
            for k, g in zip(params, torch.autograd.grad(value, list(params.values()))):
                grads[k] += g
            shard_losses.append(float(value.detach()))
        grads = {k: g / shards for k, g in grads.items()}
        losses.append(sum(shard_losses) / shards)
        if first_grad is None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = 1.0 if float(norm) < cfg["clip_gradient"] else cfg["clip_gradient"] / float(norm)
            first_grad = {k: g * scale for k, g in grads.items()}
        lr = arpdt.learning_rate(state["count"], cfg["lr"], cfg["warmup_steps"], cfg["total_steps"])
        with torch.no_grad():
            arpdt.adamw(params, grads, state, lr, cfg["weight_decay"], cfg["clip_gradient"])
    return {"losses": losses, "first_grad": first_grad, "params": {k: p.detach() for k, p in params.items()}}
