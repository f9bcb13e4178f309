"""CLIP's ModifiedResNet image tower (Radford et al., arXiv:2103.00020, the appendix's CLIP-ResNet table;
openai/CLIP clip/model.py ``ModifiedResNet``, ``Bottleneck``, ``AttentionPool2d``) as plain functions over a
state dict, with ``clip.py``'s text tower, normalisation and scoring.

The state dict's names are the PyTorch port's (``visual.layer1.0.conv1.weight``, ``visual.layer1.0.bn1.
running_mean``, ``visual.attnpool.query.weight``...): the benchmark makes one set of weights, the BatchNorm
statistics included, and hands the same tensors to the program and to this file.  The tower: a stem of three
3x3 convolutions (the first at stride 2), each with BatchNorm and ReLU, then a 2x2 average pool; four stages of
Bottleneck blocks (1x1, 3x3, 1x1 convolutions, width x 4 out) whose first block of stages 2-4 downsamples by a
2x2 average pool after its 3x3 convolution, and whose shortcut, where the shape changes, is an average pool,
a 1x1 convolution and BatchNorm; then the attention pool: the map's positions and their mean as tokens, a
learned positional embedding, one query (the mean token) over all of them, width / 64 heads, an output
projection.  BatchNorm is written out in eval mode: (x - mean) / sqrt(var + 1e-5) * scale + shift.

Departures from openai/CLIP, each the port's layout and none in the arithmetic: images arrive channels-last
(N, S, S, 3) and are moved to channels-first once; the attention pool's q, k, v and output projections are
four Linears with biases (openai's ``q_proj`` ... ``c_proj``), attention written as matmuls and a softmax in
float32 instead of ``F.multi_head_attention_forward``; the input is resized with Pillow's bicubic
(``resize.py``) from the frame to the tower's side instead of CLIP's resize, center crop and PIL round trip.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import clip as ref_clip
from . import resize as resize_lib

BN_EPS = 1e-5
STRIDES = (1, 2, 2, 2)


def batch_norm(sd: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm on channels-first ``x``, written out."""
    shape = (1, -1, 1, 1)
    mean, var = sd[f"{name}.running_mean"].view(shape), sd[f"{name}.running_var"].view(shape)
    return (x - mean) / torch.sqrt(var + BN_EPS) * sd[f"{name}.weight"].view(shape) + sd[f"{name}.bias"].view(shape)


def conv_bn(sd: dict, conv: str, bn: str, x: torch.Tensor, padding: int = 0, stride: int = 1) -> torch.Tensor:
    return batch_norm(sd, bn, F.conv2d(x, sd[f"{conv}.weight"], stride=stride, padding=padding))


def bottleneck(sd: dict, name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = F.relu(conv_bn(sd, f"{name}.conv1", f"{name}.bn1", x))
    out = F.relu(conv_bn(sd, f"{name}.conv2", f"{name}.bn2", out, padding=1))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = conv_bn(sd, f"{name}.conv3", f"{name}.bn3", out)
    if f"{name}.downsample.0.weight" in sd:
        if stride > 1:
            x = F.avg_pool2d(x, stride)
        x = conv_bn(sd, f"{name}.downsample.0", f"{name}.downsample.1", x)
    return F.relu(out + x)


def attention_pool(sd: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, C, H, W) map -> (N, embed): the mean token's attention over [mean, positions]."""
    n, c = x.shape[:2]
    tokens = x.flatten(2).transpose(1, 2)  # (N, H * W, C), positions in row-major order
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1) + sd["visual.attnpool.positional_embedding"]
    p = "visual.attnpool"
    d = c // heads
    q = F.linear(tokens[:, :1], sd[f"{p}.query.weight"], sd[f"{p}.query.bias"]).view(n, 1, heads, d).transpose(1, 2)
    k = F.linear(tokens, sd[f"{p}.key.weight"], sd[f"{p}.key.bias"]).view(n, -1, heads, d).transpose(1, 2)
    v = F.linear(tokens, sd[f"{p}.value.weight"], sd[f"{p}.value.bias"]).view(n, -1, heads, d).transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2)) / float(np.sqrt(d))
    out = torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(n, c)
    return F.linear(out, sd[f"{p}.out.weight"], sd[f"{p}.out.bias"])


def image_features(sd: dict, images: torch.Tensor, num_layers, width: int) -> torch.Tensor:
    """Unnormalized (N, embed) features of normalized channels-last (N, S, S, 3) images."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(conv_bn(sd, "visual.conv1", "visual.bn1", x, padding=1, stride=2))
    x = F.relu(conv_bn(sd, "visual.conv2", "visual.bn2", x, padding=1))
    x = F.relu(conv_bn(sd, "visual.conv3", "visual.bn3", x, padding=1))
    x = F.avg_pool2d(x, 2)
    for stage, (blocks, stride) in enumerate(zip(num_layers, STRIDES), start=1):
        for i in range(blocks):
            x = bottleneck(sd, f"visual.layer{stage}.{i}", x, stride if i == 0 else 1)
    return attention_pool(sd, x, width * 32 // 64)


def preprocess(frames: torch.Tensor, image_size: int) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> normalized float32 (N, S, S, 3): Pillow's bicubic resize to S, /255, CLIP's
    mean and std."""
    if frames.shape[1:3] != (image_size, image_size):
        frames = resize_lib.resize(frames, image_size)
    x = frames.to(torch.float32) / 255.0
    return (x - torch.tensor(ref_clip.CLIP_MEAN, device=x.device)) / torch.tensor(ref_clip.CLIP_STD, device=x.device)


def text_rewards(sd: dict, cfg: dict, frames: torch.Tensor, tokens: torch.Tensor, block: int = 64) -> np.ndarray:
    """exp(logit_scale) * cos(image, text) for uint8 (N, H, W, 3) frames on the device, in blocks of rows; the
    mean over the texts' rewards when several are given."""
    txt = ref_clip.normalized(ref_clip.text_features(sd, tokens, cfg["text_num_layers"], cfg["text_num_heads"]))
    scale = torch.exp(sd["logit_scale"])
    out = []
    for s in range(0, frames.shape[0], block):
        x = preprocess(frames[s:s + block], cfg["image_size"])
        img = ref_clip.normalized(image_features(sd, x, cfg["vision_num_layers"], cfg["vision_features"]))
        out.append((scale * img @ txt.T).mean(dim=1))
    return torch.cat(out).double().cpu().numpy()
