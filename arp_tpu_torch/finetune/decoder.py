"""Image decoder probing frozen CLIP latents (port of arp_tpu/finetune/decoder.py).

A transposed-convolution decoder trained with MSE reconstruction from frozen
CLIP image features: the probe of how much visual detail the reward model's
representation keeps.  Layout and arithmetic follow the Flax module: channels
last at the interface, ``Dense_0`` -> (start_hw, start_hw, ch), stride-2
``ConvTranspose_k`` ("SAME") with the tanh GELU until the side reaches
``out_hw``, a bilinear resize (:func:`arp_tpu_torch.ops.augment.resize_image`)
when it overshoots, ``Conv_0`` 3 x 3 and a sigmoid.  finetune/convert.py
bridges the Flax params.

Usage::

    decoder = LatentImageDecoder(feature_dim=512, out_hw=224)
    loss = reconstruction_loss(decoder, features, images)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.augment import resize_image


class LatentImageDecoder(nn.Module):
    """feature vector (B, feature_dim) -> image (B, out_hw, out_hw, 3) in [0, 1]."""

    def __init__(self, feature_dim: int, out_hw: int = 224, base_channels: int = 256, start_hw: int = 7):
        super().__init__()
        self.out_hw, self.start_hw, self.base_channels = out_hw, start_hw, base_channels
        self.Dense_0 = nn.Linear(feature_dim, start_hw * start_hw * base_channels)
        ch, hw, k = base_channels, start_hw, 0
        while hw < out_hw:
            out = max(ch // 2, 16)
            # padding 1 with kernel 4 and stride 2: Flax's "SAME" (2 zeros on each side of the dilated input)
            self.add_module(f"ConvTranspose_{k}", nn.ConvTranspose2d(ch, out, 4, stride=2, padding=1))
            ch, hw, k = out, hw * 2, k + 1
        self.num_up = k
        self.Conv_0 = nn.Conv2d(ch, 3, 3, padding=1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        b = features.shape[0]
        x = self.Dense_0(features).reshape(b, self.start_hw, self.start_hw, self.base_channels)
        x = x.permute(0, 3, 1, 2)
        hw = self.start_hw
        for k in range(self.num_up):
            x = F.gelu(getattr(self, f"ConvTranspose_{k}")(x), approximate="tanh")
            hw *= 2
        if hw != self.out_hw:
            x = resize_image(x.permute(0, 2, 3, 1), self.out_hw, self.out_hw, "bilinear").permute(0, 3, 1, 2)
        x = self.Conv_0(x)
        return torch.sigmoid(x.permute(0, 2, 3, 1))


def reconstruction_loss(decoder: LatentImageDecoder, features: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """Mean squared reconstruction error; ``images`` (B, out_hw, out_hw, 3) in [0, 1]."""
    return torch.mean((decoder(features) - images) ** 2)
