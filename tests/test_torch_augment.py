"""The port's resize, eval transform and Impala CNN against the JAX package's.

The two resizes are ``jax.image.resize``'s "bilinear" and "bicubic" as separable weight
matrices: atol 1e-5 on [0, 255] inputs scaled to [0, 1], shrinking (antialiased) and enlarging."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.models.impala import ImpalaCNN as JImpala
from arp_tpu.ops import augment as jaug
from arp_tpu_torch.models.impala import ImpalaCNN
from arp_tpu_torch.models.policy.convert import flax_params_to_torch
from arp_tpu_torch.ops import augment as taug


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models: more intra-op threads only fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [(64, 224), (256, 224), (32, 224), (224, 64), (48, 48), (50, 33)])
def test_resize_image_is_jax_image_resize(method, src, dst):
    x = np.random.default_rng(src + dst).uniform(0, 1, size=(2, src, src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method=method)
    got = taug.resize_image(torch.from_numpy(x), dst, dst, method)
    assert got.shape == (2, dst, dst, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_resize_image_one_axis_and_unknown_method():
    x = np.random.default_rng(0).uniform(0, 1, size=(40, 56, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (40, 28, 3), method="bicubic")
    np.testing.assert_allclose(taug.resize_image(torch.from_numpy(x), 40, 28, "bicubic").numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="unknown resize method"):
        taug.resize_image(torch.from_numpy(x), 8, 8, "lanczos3")


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resize_weights_sum_to_one_and_antialias(method):
    w = taug.resize_weight_matrix(256, 64, method)
    assert w.shape == (256, 64) and w.dtype == np.float32
    np.testing.assert_allclose(w.sum(0), 1.0, atol=1e-6)
    # shrinking by 4 widens the kernel by 4: more taps than the same kernel enlarging
    assert (w[:, 10] != 0).sum() > (taug.resize_weight_matrix(64, 256, method)[:, 40] != 0).sum()


def test_normalize():
    x = np.random.default_rng(1).uniform(0, 1, size=(4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(taug.normalize(torch.from_numpy(x)).numpy(), np.asarray(jaug.normalize(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    assert taug.PROCGEN_MEAN == jaug.PROCGEN_MEAN and taug.PROCGEN_STD == jaug.PROCGEN_STD


@pytest.mark.parametrize("src,size,batched", [(64, 32, True), (64, 64, False), (32, 64, True), (64, 48, False)])
def test_eval_transform(src, size, batched):
    shape = (3, src, src, 3) if batched else (src, src, 3)
    frames = np.random.default_rng(2).integers(0, 256, size=shape, dtype=np.uint8)
    want = jaug.make_eval_transform(image_size=size)(jnp.asarray(frames))
    got = taug.make_eval_transform(image_size=size, device="cpu")(frames)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_eval_transform_asks_for_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        taug.make_eval_transform(image_size=32)


@pytest.mark.parametrize("pool_padding", ["same", "torch"])
@pytest.mark.parametrize("size", [32, 21])
def test_impala_cnn(pool_padding, size):
    x = np.random.default_rng(3).uniform(0, 1, size=(2, size, size, 3)).astype(np.float32)
    jm = JImpala(pool_padding=pool_padding)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32)), params)
    tm = ImpalaCNN(pool_padding=pool_padding)
    with torch.no_grad():
        tm(torch.from_numpy(x))  # the lazy first conv and dense take their shapes
        tm.load_state_dict(flax_params_to_torch(jax.device_get(params)))
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": params}, jnp.asarray(x))), atol=1e-4, rtol=1e-5)
