"""Reference PPG experts (``.jd``) in the port (arp_tpu_torch/collect/convert_ppg.py) against arp_tpu's loader.

A ``.jd`` is built as tests/test_ppg_convert.py builds one: the independent torch replica of the
reference's PhasicValueModel pickled whole with its classes under ``phasic_policy_gradient``, that
package then removed from ``sys.modules``.  The port's loader reads it (and a plain state dict file),
maps it as JAX's ``convert_torch_ppg_state_dict`` does, and its model's logits, value and aux value
match JAX's ``load_reference_ppg_expert`` within 1e-5.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from arp_tpu.collect.convert_ppg import convert_torch_ppg_state_dict as j_convert
from arp_tpu.collect.convert_ppg import load_reference_ppg_expert as j_load_expert
from arp_tpu_torch.collect.convert_ppg import (convert_torch_ppg_state_dict, flax_ppg_to_torch,
                                               load_reference_ppg_expert, load_torch_ppg_state_dict,
                                               torch_ppg_to_flax)
from tests.test_ppg_convert import FAKE_PKG, TorchEncoderShell, TorchPhasicValueModel, _fake_package_save


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _obs(n=4, seed=0):
    return np.random.default_rng(seed).random((n, 64, 64, 3)).astype(np.float32)


def _against_jax(model, j_model, j_vars, obs):
    with torch.no_grad():
        got = model(torch.from_numpy(obs))
    want = j_model.apply(j_vars, jnp.asarray(obs))
    for g, w, name in zip(got, want, ("logits", "value", "aux_value")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    return got


def test_whole_pickled_model_loads_and_acts_as_jax(tmp_path):
    torch.manual_seed(0)
    tmodel = TorchPhasicValueModel().eval()
    path = _fake_package_save(tmp_path, tmodel)
    assert FAKE_PKG not in sys.modules
    model, variables = load_reference_ppg_expert(path)
    assert model.pool_padding == "torch" and model.arch == "dual" and not model.training
    j_model, j_vars = j_load_expert(path)
    got_tree, want_tree = _leaves(variables), _leaves(j_vars)
    assert got_tree.keys() == want_tree.keys()
    assert all(np.array_equal(got_tree[k], want_tree[k]) for k in want_tree)
    obs = _obs()
    got = _against_jax(model, j_model, j_vars, obs)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(obs))
    for g, r in zip(got, ref):  # the reference's own forward, through torch's pooling
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)


def test_plain_state_dict_file_loads_and_acts_as_jax(tmp_path):
    torch.manual_seed(2)
    tmodel = TorchPhasicValueModel()
    path = str(tmp_path / "sd.jd")
    torch.save(tmodel.state_dict(), path)
    sd = load_torch_ppg_state_dict(path)
    assert sd["pi_head.weight"].shape == (15, 256) and "pi_enc.cnn.stacks.0.firstconv.weight" in sd
    model, _ = load_reference_ppg_expert(path)
    j_model, j_vars = j_load_expert(path)
    _against_jax(model, j_model, j_vars, _obs(3, 1))


class _SharedReference(nn.Module):
    """The reference's "shared" arch: one encoder, its value head named pi_vhead."""

    def __init__(self):
        super().__init__()
        self.pi_enc = TorchEncoderShell()
        self.pi_head = nn.Linear(256, 15)
        self.pi_vhead = nn.Linear(256, 1)
        self.aux_vf_head = nn.Linear(256, 1)


def test_shared_arch_reads_its_value_head_from_pi_vhead(tmp_path):
    torch.manual_seed(3)
    path = str(tmp_path / "shared.jd")
    torch.save(_SharedReference().state_dict(), path)
    model, variables = load_reference_ppg_expert(path, arch="shared")
    assert model.arch == "shared" and "vf_enc" not in variables["params"]
    j_model, j_vars = j_load_expert(path, arch="shared")
    _against_jax(model, j_model, j_vars, _obs(2, 4))


@pytest.mark.parametrize("inshape", [(64, 64, 3), (32, 32, 3)])
def test_conversion_equals_jax_and_round_trips(inshape):
    torch.manual_seed(4)
    sd = {k: v.detach().numpy() for k, v in TorchPhasicValueModel().state_dict().items()}
    if inshape != (64, 64, 3):  # the dense layer's width follows the frames
        sd["pi_enc.cnn.dense.weight"] = np.random.default_rng(0).normal(size=(256, 32 * 4 * 4)).astype(np.float32)
        sd["vf_enc.cnn.dense.weight"] = np.random.default_rng(1).normal(size=(256, 32 * 4 * 4)).astype(np.float32)
    got, want = _leaves(convert_torch_ppg_state_dict(sd, inshape=inshape)), _leaves(j_convert(sd, inshape=inshape))
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    state = flax_ppg_to_torch(convert_torch_ppg_state_dict(sd, inshape=inshape))
    back = _leaves(torch_ppg_to_flax(state))
    assert back.keys() == want.keys() and all(np.array_equal(back[k], want[k]) for k in want)
