"""CLIP (Radford et al., arXiv:2103.00020; openai/CLIP clip/model.py) as plain functions over a state dict.

The state dict's names are the PyTorch port's (``visual.transformer.resblocks.0.attn.query.weight``...):
the benchmark makes one set of weights and hands the same tensors to the program and to this file.
Pre-norm blocks with LayerNorm eps 1e-5, separate q, k, v and out projections, quick-GELU MLPs; the image
tower embeds 16 x 16 patches in (row, column, channel) order with a bias-free projection, prepends the class
token and projects its final LayerNorm; the text tower is causal with key padding on id 0 and pools the
highest id (the end-of-text token).  Attention's scores and softmax are float32, the masked scores -1e30.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import resize as resize_lib

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _linear(sd, name, x):
    return F.linear(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"))


def _ln(sd, name, x):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], 1e-5)


def attention(q, k, v, mask=None):
    """q, k, v: (B, N, H, D); ``mask`` (B or 1, 1, N, N) True where a key is seen."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    return torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2)


def _block(sd, name, x, heads, mask=None):
    b, n, d = x.shape
    y = _ln(sd, f"{name}.ln_1", x)
    split = lambda t: t.reshape(b, n, heads, d // heads)  # noqa: E731
    a = attention(split(_linear(sd, f"{name}.attn.query", y)), split(_linear(sd, f"{name}.attn.key", y)),
                  split(_linear(sd, f"{name}.attn.value", y)), mask)
    x = x + _linear(sd, f"{name}.attn.out", a.reshape(b, n, d))
    y = _linear(sd, f"{name}.mlp.c_fc", _ln(sd, f"{name}.ln_2", x))
    return x + _linear(sd, f"{name}.mlp.c_proj", y * torch.sigmoid(1.702 * y))


def preprocess(frames: torch.Tensor, image_size: int, patch: int) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized patches (B, (S / P)^2, P * P * 3): Pillow's bicubic resize to S,
    /255, CLIP's mean and std, patches in (row, column, channel) order."""
    if frames.shape[1:3] != (image_size, image_size):
        frames = resize_lib.resize(frames, image_size)
    x = frames.to(torch.float32) / 255.0
    x = (x - torch.tensor(CLIP_MEAN, device=x.device)) / torch.tensor(CLIP_STD, device=x.device)
    b, n = x.shape[0], image_size // patch
    x = x.reshape(b, n, patch, n, patch, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n * n, patch * patch * 3)


def image_features(sd: dict, patches: torch.Tensor, layers: int, heads: int) -> torch.Tensor:
    """Unnormalized (B, embed) features of the image tower."""
    x = _linear(sd, "visual.conv1", patches)
    cls = sd["visual.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + sd["visual.positional_embedding"][None, : x.shape[1] + 1]
    x = _ln(sd, "visual.ln_pre", x)
    for i in range(layers):
        x = _block(sd, f"visual.transformer.resblocks.{i}", x, heads)
    return _linear(sd, "visual.proj", _ln(sd, "visual.ln_post", x[:, 0]))


def text_features(sd: dict, tokens: torch.Tensor, layers: int, heads: int) -> torch.Tensor:
    """Unnormalized (T, embed) features of the text tower on (T, 77) ids."""
    n = tokens.shape[1]
    x = sd["text.token_embedding.weight"][tokens] + sd["text.positional_embedding"][None, :n]
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    mask = (causal[None] & (tokens != 0)[:, None, :])[:, None]
    for i in range(layers):
        x = _block(sd, f"text.transformer.resblocks.{i}", x, heads, mask)
    x = _ln(sd, "text.ln_final", x)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
    return _linear(sd, "text.text_projection", x)


def normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def text_rewards(sd: dict, cfg: dict, frames: torch.Tensor, tokens: torch.Tensor, block: int = 256) -> np.ndarray:
    """exp(logit_scale) * cos(image, text) for uint8 (N, H, W, 3) frames on the device, in blocks of rows;
    the mean over the texts' rewards when several are given."""
    txt = normalized(text_features(sd, tokens, cfg["text_num_layers"], cfg["text_num_heads"]))
    scale = torch.exp(sd["logit_scale"])
    out = []
    for s in range(0, frames.shape[0], block):
        x = preprocess(frames[s:s + block], cfg["image_size"], cfg["vision_patch_size"])
        img = normalized(image_features(sd, x, cfg["vision_num_layers"], cfg["vision_features"] // 64))
        out.append((scale * img @ txt.T).mean(dim=1))
    return torch.cat(out).double().cpu().numpy()
