"""Port preprocessing (arp_tpu_torch/ops/preprocess.py) against arp_tpu's and Pillow.

The packed resize must give the same bytes as JAX's
``resize_bicubic_pil_packed``, as Pillow's ``Image.resize(BICUBIC)`` and as
the port's numpy fixed-point reference; the normalized patches must equal
JAX's ``clip_preprocess_packed_patches`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import arp_tpu.ops.preprocess as jpre
import arp_tpu_torch.ops.preprocess as tpre

SIZES = [(48, 32), (64, 32), (256, 32), (48, 224), (64, 224), (256, 224)]


def _frames(seed, b, size):
    return np.random.default_rng(seed).integers(0, 256, size=(b, size, size, 3), dtype=np.uint8)


def _pillow(frames, out):
    return np.stack([np.asarray(Image.fromarray(f).resize((out, out), Image.BICUBIC)) for f in frames])


@pytest.mark.parametrize("size,out", SIZES)
def test_packed_resize_bytes_match_jax_and_pillow(size, out):
    frames = _frames(size + out, 2, size)
    packed = frames.reshape(2, size, size * 3)
    got = tpre.resize_bicubic_pil_packed(torch.from_numpy(packed), 3, out, out)
    assert got.dtype == torch.float32 and got.shape == (2, out, out * 3)
    got = got.numpy().reshape(2, out, out, 3)
    want_jax = np.asarray(jpre.resize_bicubic_pil_packed(jnp.asarray(packed, jnp.float32), 3, out, out))
    np.testing.assert_array_equal(got, want_jax.reshape(2, out, out, 3))
    np.testing.assert_array_equal(got, _pillow(frames, out))
    np.testing.assert_array_equal(got, tpre.resize_bicubic_pil_reference(frames, out, out))


@pytest.mark.parametrize("size,out,patch", [(48, 32, 8), (64, 224, 16), (224, 224, 16), (256, 224, 16)])
def test_packed_patches_equal_jax(size, out, patch):
    frames = _frames(size * 7 + out, 3, size)
    packed = frames.reshape(3, size, size * 3)
    got = tpre.clip_preprocess_packed_patches(torch.from_numpy(packed), 3, out, patch).numpy()
    want = np.asarray(jpre.clip_preprocess_packed_patches(jnp.asarray(packed), 3, out, patch))
    assert got.shape == ((3, (out // patch) ** 2, patch * patch * 3))
    np.testing.assert_array_equal(got, want)


def test_patches_are_normalized_pillow_pixels_in_row_col_channel_order():
    frames = _frames(3, 2, 64)
    got = tpre.clip_preprocess_packed_patches(torch.from_numpy(frames.reshape(2, 64, 192)), 3, 32, 8)
    img = (_pillow(frames, 32) / 255.0 - np.array(tpre.CLIP_MEAN)) / np.array(tpre.CLIP_STD)
    # patch (i, j) holds rows 8i..8i+7, cols 8j..8j+7, channels innermost
    want = img.reshape(2, 4, 8, 4, 8, 3).transpose(0, 1, 3, 2, 4, 5).reshape(2, 16, 192)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("in_size,out_size", [(256, 224), (64, 224), (48, 32), (97, 13)])
def test_coefficient_tables_equal_jax(in_size, out_size):
    for got, want in zip(tpre._pil_coeffs(in_size, out_size), jpre._pil_coeffs(in_size, out_size)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tpre._pil_matmul_operands(in_size, out_size, 3),
                         jpre._pil_matmul_operands(in_size, out_size, 3)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_float32_split_is_exact_at_the_largest_partial_sums():
    """All-255 frames drive every partial sum to its maximum; the float32
    three-way split must still give Pillow's bytes (a bf16 result would not)."""
    frames = np.full((1, 256, 256, 3), 255, np.uint8)
    frames[0, ::2, ::3] = 0  # sharp edges: negative lobes, clipping at 0 and 255
    got = tpre.resize_bicubic_pil_packed(torch.from_numpy(frames.reshape(1, 256, 768)), 3, 224, 224)
    np.testing.assert_array_equal(got.numpy().reshape(1, 224, 224, 3), _pillow(frames, 224))
