"""Impala CNN visual backbone (port of arp_tpu/models/impala.py).

Three down-stacks of 16/32/32 channels, two residual blocks each, max-pool
downsampling, flatten -> 256 wide with a final relu.  Inputs are
(batch, h, w, c) as in the Flax module; the convolutions run channels-first
inside, and the flatten goes back to (h, w, c) order, so the Flax ``dense``
kernel carries over unchanged.  Parameter names are the Flax ones
(``stack0_firstconv`` ...); the first layer's input channels are inferred at
the first call.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn


def _same_max_pool(x, pool_padding: str):
    """3x3 max pool, stride 2: XLA's SAME padding (the odd cell goes to the far
    side), or torch's symmetric pad of 1."""
    if pool_padding != "same":
        return F.max_pool2d(x, 3, 2, 1)
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dim first
        total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


class ImpalaCNN(nn.Module):
    def __init__(self, chans: Sequence[int] = (16, 32, 32), outsize: int = 256, nblock: int = 2,
                 final_relu: bool = True, pool_padding: str = "same"):
        super().__init__()
        self.chans, self.nblock, self.final_relu, self.pool_padding = tuple(chans), nblock, final_relu, pool_padding
        in_ch = None
        for s, out_ch in enumerate(self.chans):
            conv = nn.LazyConv2d(out_ch, 3, padding=1) if in_ch is None else nn.Conv2d(in_ch, out_ch, 3, padding=1)
            self.add_module(f"stack{s}_firstconv", conv)
            for b in range(nblock):
                self.add_module(f"stack{s}_block{b}_conv0", nn.Conv2d(out_ch, out_ch, 3, padding=1))
                self.add_module(f"stack{s}_block{b}_conv1", nn.Conv2d(out_ch, out_ch, 3, padding=1))
            in_ch = out_ch
        self.dense = nn.LazyLinear(outsize)

    def forward(self, x):
        # x: (batch [* timestep], h, w, c), scaled to [0, 1]
        x = x.permute(0, 3, 1, 2)
        for s in range(len(self.chans)):
            x = getattr(self, f"stack{s}_firstconv")(x)
            x = _same_max_pool(x, self.pool_padding)
            for b in range(self.nblock):
                y = getattr(self, f"stack{s}_block{b}_conv0")(F.relu(x))
                y = getattr(self, f"stack{s}_block{b}_conv1")(F.relu(y))
                x = x + y
        x = F.relu(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        x = self.dense(x)
        return F.relu(x) if self.final_relu else x
