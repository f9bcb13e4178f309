"""The port's ResNet v1 (ResNet18 / ResNet50) and DenseResnet against the Flax modules: the same
numpy-seeded inputs, Flax's params and batch_stats carried across by the bridge
(models/clip/convert.py::flax_to_torch) and back; eval and train mode, the updated batch_stats
too.  Narrow widths; float32 within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.models import resnet as jresnet
from arp_tpu_torch.models import resnet as tresnet
from arp_tpu_torch.models.clip.convert import _flatten, flax_to_torch, torch_to_flax

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def perturbed(variables, seed):
    """Every parameter moved off its init value (the zero scales too), running variances kept positive."""
    rng = np.random.default_rng(seed)

    def move(path, p):
        p = np.asarray(p)
        noise = 0.1 * rng.normal(size=p.shape).astype(np.float32)
        return p + np.abs(noise) if path[-1].key == "var" else p + noise

    return jax.tree_util.tree_map_with_path(move, jax.device_get(variables))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


# ResNet50 at 64 px: at 32 px its last stage is 1 x 1, and train mode's statistics over the batch's 4
# values a channel turn float32 rounding into 2.4e-5 (JAX) and 1.4e-5 (the port) against a float64 run
@pytest.mark.parametrize("name,size", [("ResNet18", 32), ("ResNet18", 29), ("ResNet50", 64)])
@pytest.mark.parametrize("train", [False, True])
def test_resnet_matches_flax(name, size, train):
    x = np.random.default_rng(size).normal(size=(4, size, size, 3)).astype(np.float32)
    jmodel = getattr(jresnet, name)(num_outputs=5, num_filters=8 if name == "ResNet18" else 4)
    variables = perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tmodel = getattr(tresnet, name)(num_outputs=5, num_filters=8 if name == "ResNet18" else 4)
    tmodel.load_state_dict(flax_to_torch(variables))  # strict: every name and shape
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=train, mutable=["batch_stats"] if train else False))
    want = apply(variables, jnp.asarray(x))
    got = tmodel(torch.from_numpy(x), train=train)
    close(got, want[0] if train else want)
    stats = _flatten(torch_to_flax(tmodel.state_dict())["batch_stats"])
    new_stats = _flatten(want[1]["batch_stats"] if train else variables["batch_stats"])
    assert set(stats) == set(new_stats)
    for path, value in new_stats.items():
        np.testing.assert_allclose(stats[path], np.asarray(value), atol=TOL, rtol=TOL, err_msg="/".join(path))


def test_resnet_tree_and_init_follow_flax():
    """Name for name and shape for shape Flax's tree (params and batch_stats), the last norm of each
    block starting at a zero scale, and SAME padding (0, 1) at stride 2 on an even side."""
    x = jnp.zeros((1, 32, 32, 3))
    for name in ("ResNet18", "ResNet34", "ResNet50"):
        want = jax.eval_shape(lambda: getattr(jresnet, name)(num_outputs=3, num_filters=4).init(jax.random.PRNGKey(0), x))
        model = getattr(tresnet, name)(num_outputs=3, num_filters=4)
        got = {k: v.shape for k, v in _flatten(torch_to_flax(model.state_dict())).items()}
        assert got == {k: tuple(v.shape) for k, v in _flatten(want).items()}, name
    block = tresnet.ResNet18(num_outputs=3).ResNetBlock_0
    assert torch.equal(block.BatchNorm_1.weight, torch.zeros(64)) and torch.equal(block.BatchNorm_0.weight, torch.ones(64))
    assert tresnet._same_pads(torch.zeros(1, 1, 8, 8), 3, 2) == [0, 1, 0, 1]
    assert tresnet._same_pads(torch.zeros(1, 1, 7, 7), 3, 2) == [1, 1, 1, 1]
    assert tresnet._same_pads(torch.zeros(1, 1, 8, 8), 1, 2) == [0, 0, 0, 0]


def test_dense_resnet_matches_flax():
    x = np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)
    jmodel = jresnet.DenseResnet(features=32, num_blocks=2, num_outputs=3)
    variables = perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    tmodel = tresnet.DenseResnet(features=32, num_blocks=2, num_outputs=3)
    tmodel(torch.from_numpy(x))  # the input layer takes its width, as at Flax's init
    tmodel.load_state_dict(flax_to_torch(variables))  # strict
    close(tmodel(torch.from_numpy(x)), jmodel.apply(variables, jnp.asarray(x)))
    block = tresnet.DenseResnetBlock(16, 32)
    jblock = jresnet.DenseResnetBlock(32)
    bvars = perturbed(jblock.init(jax.random.PRNGKey(1), jnp.asarray(x)), 3)
    block.load_state_dict(flax_to_torch(bvars))  # the projection where the width changes
    close(block(torch.from_numpy(x)), jblock.apply(bvars, jnp.asarray(x)))
