"""Shared smoke and test fixtures (port of arp_tpu/testing.py): a tiny CLIP engine, the toy
tokenizer, the scripted expert.

They back the test suite's five-stage pipeline on the port's own code
(collect -> label -> train -> eval).  Nothing here is imported by the
package's production paths.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.clip.tokenizer import Char97Tokenizer as TinyTokenizer

# The tiny CLIP wherever ViT-B/16 weights are not needed; vocab_size stays with TinyTokenizer's ids.
TINY_CLIP_CFG = dict(
    embed_dim=32,
    vocab_size=97,
    vision_num_layers=2,
    vision_features=64,
    vision_patch_size=8,
    text_features=32,
    text_num_heads=4,
    text_num_layers=2,
)
TINY_CLIP_IMG_SIZE = 32  # engines resize frames to this


def make_tiny_clip_engine(batch_size: int = 8, device="cuda", **engine_kwargs):
    """The port's ClipRewardEngine over a tiny CLIP of random weights (torch's init from seed 0,
    without touching the global generator), on ``device`` (the card unless the caller asks for
    the CPU)."""
    from .models.clip import CLIP
    from .reward.engine import ClipRewardEngine

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE)
    engine_kwargs.setdefault("resize_mode", "pil")
    return ClipRewardEngine(model=model, batch_size=batch_size, image_size=TINY_CLIP_IMG_SIZE,
                            tokenizer=TinyTokenizer(), device=device, **engine_kwargs)


def scripted_coin_expert(obs):
    """Walks the FakeProcgen agent (red block) toward the goal (gold block) by pixel positions:
    good enough to produce 'expert' demos."""
    img = np.asarray(obs["image"]["ob"])
    gold = np.argwhere((img[:, :, 0] > 200) & (img[:, :, 1] > 180) & (img[:, :, 2] < 100))
    red = np.argwhere((img[:, :, 0] > 150) & (img[:, :, 1] < 100))
    if len(gold) == 0 or len(red) == 0:
        return 0
    gy, gx = gold.mean(axis=0)
    ay, ax = red.mean(axis=0)
    if abs(gx - ax) > abs(gy - ay):
        return 1 if gx > ax else 0
    return 3 if gy > ay else 2
