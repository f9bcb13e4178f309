"""Position embeddings and symlog (port of arp_tpu/utils.py).

The sin-cos tables are computed in numpy float32 with the JAX package's
operations in its order, once for each (width, length), then moved to the
device that asks and kept there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _sincos_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float32)
    omega = omega / np.float32(embed_dim / 2.0)
    omega = np.float32(1.0) / np.power(np.float32(10000.0), omega)
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float32), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


@functools.lru_cache(maxsize=None)
def _sincos_1d(embed_dim: int, length: int) -> np.ndarray:
    return _sincos_from_grid(embed_dim, np.arange(length, dtype=np.float32))[None]


@functools.lru_cache(maxsize=None)
def _sincos_2d(embed_dim: int, length: int) -> np.ndarray:
    grid_size = int(length ** 0.5)
    assert grid_size * grid_size == length, "2d pos embed needs a square token grid"
    assert embed_dim % 2 == 0
    axis = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(axis, axis), axis=0).reshape([2, 1, grid_size, grid_size])  # w goes first
    emb_h = _sincos_from_grid(embed_dim // 2, grid[0])
    emb_w = _sincos_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)[None]


@functools.lru_cache(maxsize=None)
def _on_device(table, embed_dim: int, length: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(table(embed_dim, length)).to(device)


def get_1d_sincos_pos_embed(embed_dim: int, length: int, device="cpu") -> torch.Tensor:
    """(1, length, embed_dim) float32 on ``device``."""
    return _on_device(_sincos_1d, embed_dim, length, torch.device(device))


def get_2d_sincos_pos_embed(embed_dim: int, length: int, device="cpu") -> torch.Tensor:
    """(1, length, embed_dim) float32 on ``device``, for a square grid of ``length`` tokens."""
    return _on_device(_sincos_2d, embed_dim, length, torch.device(device))


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log(1 + torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)
