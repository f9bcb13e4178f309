"""The M3AE tower's reference checkpoint in the port (F6), against arp_tpu's exporter and loader.

The name mappers on tests/test_m3ae_export.py's tiny model: the port's export equals arp_tpu's
leaf for leaf, and the round trip through both converters is exact.  The by-name ``.pkl`` load
(``load_m3ae_model_vars("vit_b16")``) on that test's setup gives the port's tower an output equal
to the Flax tower's on arp_tpu's loaded variables (float32, atol 2e-5, the bound of
tests/test_torch_m3ae.py), and the variables themselves equal bit for bit.
"""

import pickle

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.models import m3ae as jm3ae
from arp_tpu_torch.models import m3ae as tm3ae
from arp_tpu_torch.models.policy.convert import flax_m3ae_to_torch
from test_m3ae_export import TINY, _tiny_model_and_params

ATOL = 2e-5


def leaves(tree):
    return {p: np.asarray(v) for p, v in flax.traverse_util.flatten_dict(flax.core.unfreeze(tree)).items()}


def assert_trees_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg="/".join(path))


@pytest.mark.parametrize("mlp_name", ["FeedForward_0", "TransformerMLP_0"])
def test_export_and_convert_match_jax(mlp_name):
    _, params, _ = _tiny_model_and_params()
    numpy_params = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(params))
    want = jm3ae.export_reference_m3ae_params(params)
    got = tm3ae.export_reference_m3ae_params(numpy_params)
    assert_trees_equal(got, want)
    if mlp_name != "FeedForward_0":  # the reference's other spelling of its MLP
        flat = {tuple(mlp_name if p == "FeedForward_0" else p for p in path): v
                for path, v in flax.traverse_util.flatten_dict(got).items()}
        got = want = flax.traverse_util.unflatten_dict(flat)
    assert_trees_equal(tm3ae.convert_reference_m3ae_params(got), jm3ae.convert_reference_m3ae_params(want))
    assert_trees_equal(tm3ae.convert_reference_m3ae_params(got), params)  # the round trip is exact


def test_loader_reads_exported_pickle_by_name(tmp_path, monkeypatch):
    model, params, probe = _tiny_model_and_params()
    with open(tmp_path / "m3ae_base_params.pkl", "wb") as f:
        pickle.dump(jm3ae.export_reference_m3ae_params(params), f)
    jloaded = jm3ae.load_m3ae_model_vars("vit_b16", checkpoint_dir=str(tmp_path))
    want = model.apply(jloaded, probe, None, None, method=model.forward_representation, deterministic=True)

    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(tmp_path))
    state = tm3ae.load_m3ae_model_vars("vit_b16")
    bridged = flax_m3ae_to_torch(jax.device_get(jloaded))
    assert set(state) == set(bridged) and all(torch.equal(state[k], bridged[k]) for k in state)
    tower = tm3ae.MaskedMultimodalAutoencoder(dict(TINY), text_vocab_size=model.text_vocab_size,
                                              image_output_dim=8 * 8 * 3).eval()
    result = tower.load_state_dict(state, strict=False)
    assert result.missing_keys == ["text_embedding.weight"] and not result.unexpected_keys  # Flax ran no text
    with torch.no_grad():
        got = tower.forward_representation(torch.tensor(np.asarray(probe)), None, None, deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert tm3ae.load_m3ae_model_vars(str(tmp_path / "m3ae_base_params.pkl")).keys() == state.keys()  # by path too
