"""chip_smoke.py's pieces on the CPU: its random weights have the Flax layout,
its in-memory demo group labels like an HDF5 file, and without a GPU it
exits non-zero and prints no result."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from arp_tpu.models.clip import CLIP as FlaxCLIP
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE
from arp_tpu_torch.models.clip import CLIP, MODELS, flax_to_torch
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.reward.engine import ClipRewardEngine
from arp_tpu_torch.reward.labeler import label_group, label_rewards


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def test_random_weights_have_the_flax_layout():
    images = jnp.zeros((1, TINY_CLIP_IMG_SIZE, TINY_CLIP_IMG_SIZE, 3))
    flax_vars = FlaxCLIP(**TINY_CLIP_CFG).init(jax.random.PRNGKey(0), images, jnp.zeros((1, 77), jnp.int32))
    ours = chip_smoke.random_clip_variables(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, seed=0)
    assert _shapes(ours) == _shapes(flax_vars)


def test_random_vit_b16_weights_fill_the_port_model():
    from arp_tpu_torch.models.clip import CONFIGS

    state = flax_to_torch(chip_smoke.random_clip_variables(CONFIGS["vit_b16"], 224, seed=0))
    model = MODELS["vit_b16"]()
    model.load_state_dict(state)  # strict: every name and shape matches
    assert float(model.logit_scale.exp()) == pytest.approx(chip_smoke.LOGIT_SCALE)


def _tiny_engine():
    model = CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE)
    model.load_state_dict(flax_to_torch(chip_smoke.random_clip_variables(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, 1)))
    return ClipRewardEngine(model=model, batch_size=8, tokenizer=Char97Tokenizer(), device="cpu")


def test_memory_group_labels_like_an_hdf5_file(tmp_path):
    engine = _tiny_engine()
    group = chip_smoke.demo_group(30, 2, 48, seed=0)
    path = str(tmp_path / "demo.hdf5")
    with h5py.File(path, "w") as f:
        for key in ("ob", "act", "done"):
            f.create_dataset(key, data=np.asarray(group[key]))
    stats = label_group(group, "collect the coin.", engine, progress=False)
    label_rewards(path, "collect the coin.", engine=engine, progress=False)
    assert stats["frames"] == 30
    with h5py.File(path, "r") as f:
        for key in ("ob_clip_reward", "ob_clip_pos_rtg"):
            np.testing.assert_array_equal(np.asarray(group[key]), f[key][:])
            assert group[key].attrs == dict(f[key].attrs)


def test_exits_nonzero_without_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""
