"""The trainer's random augmentations of the port against arp_tpu/ops/augment.py.

JAX draws inside each op from folded keys; the port draws from a
torch.Generator.  So these tests replay JAX's own key splits to get the
parameters it drew (per image: ``split(rng, B + 1)``, then ``fold_in(key, i)``
for the i-th op, then the op's own splits) and hold the port's apply to JAX's
whole output: within 1e-5 (the images are in [0, 1] before the normalization;
both sides compute in float32 in the same order, the sums of the resize
products and of the gray mean in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.ops import augment as jaug
from arp_tpu_torch.ops import augment as taug

ATOL = 1e-5


def jax_draws(rng, n: int, augs: str, image_size: int, source_size: int) -> list:
    """The parameters JAX's make_augment_fn draws for n images from ``rng``, in the port's layout."""
    names = [a.strip() for a in augs.split(",") if a.strip()]
    crop = taug.crop_side(image_size, source_size)
    keys = jax.random.split(rng, n + 1)[:-1]
    out = []
    for i, name in enumerate(names):
        per = [jax.random.fold_in(k, i) for k in keys]
        if name == "random_crop":
            ys, xs = zip(*(jax.random.split(k) for k in per))
            draw = lambda ks: torch.tensor([int(jax.random.randint(k, (), 0, image_size - crop + 1)) for k in ks])  # noqa: E731
            out.append({"y0": draw(ys), "x0": draw(xs)})
        elif name == "color_jitter":
            split = [jax.random.split(k, 4) for k in per]
            p = {}
            for j, (field, amount) in enumerate(taug.JITTER.items()):
                lo, hi = (-amount, amount) if field == "hue" else (max(0.0, 1 - amount), 1 + amount)
                p[field] = torch.tensor([float(jax.random.uniform(s[j], (), minval=lo, maxval=hi)) for s in split])
            out.append(p)
        else:
            out.append({"angle": torch.tensor([float(jax.random.uniform(k, (), minval=-taug.MAX_ANGLE_DEG,
                                                                        maxval=taug.MAX_ANGLE_DEG)) for k in per])})
    return out


def _images(n, size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("augs,image_size,source_size", [
    ("random_crop", 32, 32),
    ("color_jitter", 32, 32),
    ("rotate", 32, 32),
    ("random_crop, color_jitter", 32, 32),  # the trainer's default
    ("random_crop,color_jitter,rotate", 24, 40),  # resized first; the crop scaled to the resized side
])
def test_make_augment_fn_matches_jax(augs, image_size, source_size):
    images = _images(6, source_size)
    rng = jax.random.PRNGKey(3)
    want, _ = jaug.make_augment_fn(augs, image_size=image_size, source_size=source_size)(jnp.asarray(images), rng)
    port = taug.make_augment_fn(augs, image_size=image_size, source_size=source_size)
    got = port.apply(torch.from_numpy(images), jax_draws(rng, 6, augs, image_size, source_size))
    assert got.dtype == torch.float32 and got.shape == (6, image_size, image_size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_crop_side_is_jax_s():
    for image_size, source_size in ((256, 256), (256, 512), (224, 256), (24, 40)):
        crop = int(source_size * 0.8)
        assert taug.crop_side(image_size, source_size) == int(image_size * (crop / source_size))


def test_draws_come_from_the_generator():
    port = taug.make_augment_fn("random_crop,color_jitter,rotate", image_size=32, source_size=32)
    a = port.draw(64, torch.Generator().manual_seed(1))
    b = port.draw(64, torch.Generator().manual_seed(1))
    c = port.draw(64, torch.Generator().manual_seed(2))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not all(torch.equal(x[k], y[k]) for x, y in zip(a, c) for k in x)
    crop, jitter, rot = a
    assert crop["y0"].min() >= 0 and crop["y0"].max() <= 32 - port.crop and len(set(crop["x0"].tolist())) > 1
    assert 0.6 <= float(jitter["brightness"].min()) and float(jitter["brightness"].max()) <= 1.4
    assert -0.5 <= float(jitter["hue"].min()) and float(jitter["hue"].max()) <= 0.5
    assert -30 <= float(rot["angle"].min()) and float(rot["angle"].max()) <= 30
    images = torch.from_numpy(_images(4, 32))
    assert not torch.equal(port(images, torch.Generator().manual_seed(1)), port(images, torch.Generator().manual_seed(2)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mixup_cutmix_matches_jax_with_the_same_draws(seed):
    rng_np = np.random.default_rng(seed)
    images = rng_np.uniform(0, 1, size=(5, 16, 12, 3)).astype(np.float32)
    labels = rng_np.integers(0, 7, size=5)
    rng = jax.random.PRNGKey(seed)
    want_img, want_lab = jaug.mixup_cutmix(rng, jnp.asarray(images), jnp.asarray(labels), 7)
    perm_rng, mix_rng, cut_rng, switch_rng, box_rng = jax.random.split(rng, 5)
    params = {"perm": torch.from_numpy(np.array(jax.random.permutation(perm_rng, 5))),
              "use_cutmix": bool(jax.random.uniform(switch_rng, ()) < 0.5),
              "lam_mix": float(jax.random.beta(mix_rng, 0.8, 0.8, ())),
              "lam_cut": float(jax.random.beta(cut_rng, 1.0, 1.0, ())),
              "cy": int(jax.random.randint(box_rng, (), 0, 16)),
              "cx": int(jax.random.randint(jax.random.fold_in(box_rng, 1), (), 0, 12))}
    got_img, got_lab = taug.apply_mixup_cutmix(torch.from_numpy(images), torch.from_numpy(labels), 7, params)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_lab.numpy(), np.asarray(want_lab), atol=1e-6, rtol=0)


def test_mixup_cutmix_draws():
    draws = [taug.draw_mixup_cutmix(6, 16, 16, torch.Generator().manual_seed(s)) for s in range(40)]
    assert {d["use_cutmix"] for d in draws} == {True, False}
    assert all(0.0 < d["lam_mix"] < 1.0 and 0.0 < d["lam_cut"] < 1.0 for d in draws)
    assert all(sorted(d["perm"].tolist()) == list(range(6)) and 0 <= d["cy"] < 16 for d in draws)
    lam = np.array([d["lam_cut"] for d in draws])
    assert 0.3 < lam.mean() < 0.7  # Beta(1, 1) is uniform
