"""Operation counts of CLIP's ModifiedResNet image tower (the benchmark's own, from shapes alone), beside
``roofline.py``, whose peaks they are held against.

A convolution of k x k kernels from c_in to c_out channels over an h x w output makes 2 * h * w * c_in * c_out
* k * k operations (a multiply and an add per kernel entry and output).  BatchNorm, ReLU and the average pools
are elementwise and not counted; nor are the resize and the normalisation before the tower.
"""

from __future__ import annotations

STRIDES = (1, 2, 2, 2)
EXPANSION = 4


def conv_layers(width: int, num_layers, image: int) -> list:
    """(name, output side, c_in, c_out, kernel side) of each convolution of the tower on ``image``² inputs,
    in the order they run."""
    half, side = width // 2, image // 2
    out = [("conv1", side, 3, half, 3), ("conv2", side, half, half, 3), ("conv3", side, half, width, 3)]
    side //= 2  # the stem's 2 x 2 average pool
    c_in = width
    for stage, (blocks, stride) in enumerate(zip(num_layers, STRIDES), start=1):
        w = width * 2 ** (stage - 1)
        for i in range(blocks):
            s = stride if i == 0 else 1
            name = f"layer{stage}.{i}"
            out += [(f"{name}.conv1", side, c_in, w, 1), (f"{name}.conv2", side, w, w, 3),
                    (f"{name}.conv3", side // s, w, w * EXPANSION, 1)]
            if s > 1 or c_in != w * EXPANSION:
                out.append((f"{name}.downsample.0", side // s, c_in, w * EXPANSION, 1))
            c_in, side = w * EXPANSION, side // s
    return out


def conv_flops_per_frame(width: int, num_layers, image: int) -> float:
    return sum(2.0 * s * s * c_in * c_out * k * k for _, s, c_in, c_out, k in conv_layers(width, num_layers, image))


def attnpool_flops_per_frame(width: int, image: int, out_dim: int) -> float:
    """The attention pool: keys and values of the (image / 32)² + 1 tokens, the mean token's query, its scores
    and weighted sum over every token, and the output projection."""
    c, tokens = width * 32, (image // 32) ** 2 + 1
    return 2.0 * (2 * tokens * c * c + c * c + 2 * tokens * c + c * out_dim)


def flops_per_frame(width: int, num_layers, image: int, out_dim: int) -> float:
    """One image through the tower: the convolutions and the attention pool."""
    return conv_flops_per_frame(width, num_layers, image) + attnpool_flops_per_frame(width, image, out_dim)
