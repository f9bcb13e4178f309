"""Published peaks of one NVIDIA H100 SXM and the operation and byte counts of the benchmark's work.

The peaks are NVIDIA's data sheet's dense rates at the card's full 700 W limit.
Float32 work is held against TF32's tensor-core peak: no arithmetic that keeps
float32 results runs faster on this card, so a share of it cannot pass 100%.
The counts are the benchmark's own, from shapes alone; the program's counters
are not read.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def attention_cost(b: int, n: int, h: int, d: int, dtype: str = "float32") -> tuple[float, float]:
    """(operations, bytes) of one attention forward over (b, n, h, d) q, k, v: q k^T and p v dense, whatever the
    mask, and q, k, v read and the output written once."""
    flops = 4.0 * b * h * n * n * d
    nbytes = 4.0 * b * n * h * d * DTYPE_BYTES[dtype]
    return flops, nbytes


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time for ``flops`` operations in ``dtype`` and ``nbytes`` moved once."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def transformer_flops(tokens: int, width: int, layers: int, mlp_ratio: int = 4) -> float:
    """Forward operations of ``layers`` pre-norm blocks on one sequence of ``tokens``: the q, k, v and out
    projections, the MLP, and attention's two products."""
    linear = 2.0 * tokens * layers * (4 * width * width + 2 * mlp_ratio * width * width)
    attention = 4.0 * tokens * tokens * width * layers
    return linear + attention


def vit_flops_per_frame(width: int, layers: int, patch: int, image: int, out_dim: int, channels: int = 3) -> float:
    """One image through a CLIP ViT tower: the patch embedding, the blocks over patches + CLS, the projection."""
    patches = (image // patch) ** 2
    embed = 2.0 * patches * patch * patch * channels * width
    return embed + transformer_flops(patches + 1, width, layers) + 2.0 * width * out_dim


def policy_flops_per_sequence(window: int, width: int, depth: int, tokens: int, tower_width: int, actions: int,
                              ensemble: int, tokens_per_step: int = 3, mlp_ratio: int = 4) -> float:
    """One ARPDT forward on one sequence of ``window`` frames, the frozen tower left out: the adapter's two
    layers on each of a frame's ``tokens`` tower outputs, the image input over all of them, the blocks over
    ``tokens_per_step * window`` tokens, and the ensembles' two-layer action and return heads."""
    adapter = 2.0 * window * tokens * 2 * tower_width * tower_width
    image_in = 2.0 * window * tokens * tower_width * width
    blocks = transformer_flops(tokens_per_step * window, width, depth, mlp_ratio)
    heads = 2.0 * window * ensemble * (2 * width * width + width * actions + width)
    return adapter + image_in + blocks + heads
