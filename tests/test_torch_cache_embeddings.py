"""The port's embedding cache against arp_tpu's: ``cache_clip_embeddings`` writes ``{key}_{name}_emb``
within 1e-5 of JAX's (the float32 engines' parity bound of tests/test_torch_reward_engine.py) on the same
weights, the port's and JAX's datasets read the cache back alike (``use_cached_embeddings``), and the CLI
builds its engine from ``--model_name`` with the flags reaching it."""

import shutil

import h5py
import jax
import numpy as np
import pytest
import torch

from arp_tpu.data import procgen_dataset as jds
from arp_tpu.data.cache_embeddings import cache_clip_embeddings as j_cache
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, make_tiny_clip_engine
from arp_tpu_torch.data import cache_embeddings as tcache
from arp_tpu_torch.data import procgen_dataset as tds
from arp_tpu_torch.models.clip import CLIP
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.parallel import mesh as tmesh
from arp_tpu_torch.reward import engine as tengine
from test_dataset import NAME, make_file
from test_torch_train_data import assert_tree_equal


@pytest.fixture(scope="module")
def jax_engine():
    return make_tiny_clip_engine(batch_size=8)


@pytest.fixture
def files(tmp_path):
    make_file(tmp_path, "train", img=20)
    return tmp_path


def test_cache_matches_jax_and_the_datasets_read_it(files, jax_engine):
    path = str(files / NAME / "data_train.hdf5")
    jax_path = str(files / "jax.hdf5")
    shutil.copy(path, jax_path)
    variables = jax.tree_util.tree_map(np.asarray, jax_engine.variables)
    engine = tengine.ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE), variables=variables,
                                      tokenizer=Char97Tokenizer(), batch_size=8, device="cpu")
    assert tcache.cache_clip_embeddings(path, engine) == j_cache(jax_path, jax_engine) == {"ob": (24, 32)}
    assert tcache.cache_clip_embeddings(path, engine) == {"ob": (24, 32)}  # a second run replaces the dataset
    with h5py.File(path, "r") as got, h5py.File(jax_path, "r") as want:
        emb = got["ob_clip_emb"][:]
        assert emb.dtype == np.float32 and got["ob_clip_emb"].compression == "gzip"
        np.testing.assert_allclose(emb, want["ob_clip_emb"][:], atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(emb, engine.encode_image_features(got["ob"][:, -1]), atol=0)
    cfg = dict(path=str(files), image_size=8, num_frames=8, window_size=4, use_cached_embeddings=True)
    ours, theirs = tds.ProcgenDataset(cfg, dataset_name=NAME), jds.ProcgenDataset(cfg, dataset_name=NAME)
    for i in range(len(ours)):
        sample = ours[i]
        assert_tree_equal(theirs[i], sample, f"[{i}]")
        np.testing.assert_array_equal(sample["image_emb"]["ob"][-1], emb[(i + ours.random_start_offset) % len(ours)])
    ours.close()


def test_cli_builds_the_engine_from_its_flags(files, jax_engine, monkeypatch, capsys):
    """--model_name reads that model's local checkpoint (stood in for here by the tiny tower's variables);
    --fast_int8 reaches the engine; --mesh_dp 2 shards it over two CPU shares (the CPU is one device: the
    test lists it twice) and caches the same embeddings, and more devices than there are raise."""
    variables = jax.tree_util.tree_map(np.asarray, jax_engine.variables)
    built = []

    def load(name):
        assert name == "tiny"
        return variables

    monkeypatch.setitem(tengine.MODELS, "tiny", lambda: CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE))
    monkeypatch.setitem(tengine.IMAGE_RESOLUTION, "tiny", TINY_CLIP_IMG_SIZE)
    monkeypatch.setattr(tengine, "load_model_vars", load)
    real_init = tengine.ClipRewardEngine.__init__
    monkeypatch.setattr(tengine.ClipRewardEngine, "__init__",
                        lambda self, *a, **k: (built.append(k), real_init(self, *a, **k))[1])
    path = str(files / NAME / "data_train.hdf5")
    tcache.main(["--data_path", path, "--model_name", "tiny", "--batch_size", "8", "--device", "cpu",
                 "--fast_int8"])
    assert "[DONE] cached embeddings: {'ob': (24, 32)}" in capsys.readouterr().out
    assert built[0]["fast_int8"] is True and built[0]["resize_mode"] == "pil" and built[0]["batch_size"] == 8
    with h5py.File(path, "r") as g:
        assert g["ob_clip_emb"].shape == (24, 32) and np.isfinite(g["ob_clip_emb"][:]).all()
        one = g["ob_clip_emb"][:]
    monkeypatch.setattr(tmesh, "local_devices", lambda device_type: [torch.device("cpu")] * 2)
    tcache.main(["--data_path", path, "--model_name", "tiny", "--batch_size", "8", "--device", "cpu",
                 "--fast_int8", "--mesh_dp", "2"])
    assert "[INFO] encoding data-parallel over 2 devices" in capsys.readouterr().out
    assert built[1]["mesh"].shape["dp"] == 2
    with h5py.File(path, "r") as g:
        np.testing.assert_allclose(g["ob_clip_emb"][:], one, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="requested 100000 devices"):
        tcache.main(["--data_path", path, "--mesh_dp", "100000", "--device", "cpu"])
