"""The port's dataset, loader, tokenizer and validator against arp_tpu's on the same synthetic files.

Every field of every sample and of every loader batch must be equal: the
port's data modules are copies of the JAX package's numpy code.
"""

import h5py
import numpy as np
import pytest

from arp_tpu.data import loader as jloader
from arp_tpu.data import procgen_dataset as jds
from arp_tpu.data import validate as jvalidate
from arp_tpu_torch.data import loader as tloader
from arp_tpu_torch.data import procgen_dataset as tds
from arp_tpu_torch.data import validate as tvalidate
from test_dataset import NAME, make_file


def assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture
def files(tmp_path):
    make_file(tmp_path, "train")
    make_file(tmp_path, "val", n=16)
    with h5py.File(tmp_path / NAME / "data_train.hdf5", "a") as g:
        n = g["ob"].shape[0]
        g.create_dataset("ob_clip_emb", data=np.random.default_rng(2).normal(size=(n, 12)).astype(np.float32))
        g.create_dataset("pos", data=np.random.default_rng(3).normal(size=(n, 8, 3)).astype(np.float32))
    return tmp_path


CONFIGS = {
    "vl": dict(use_vl=True, window_size=4),
    "vl_normalize_offset": dict(use_vl=True, use_normalize=True, window_size=3),
    "plain_subset": dict(num_subset=1, window_size=4),
    "cached_embeddings_state": dict(use_vl=True, use_cached_embeddings=True, state_key="pos", state_dim=3,
                                    window_size=4),
}


@pytest.mark.parametrize("case", list(CONFIGS))
def test_every_sample_matches_jax(files, case):
    cfg = dict(path=str(files), image_size=8, num_frames=8, **CONFIGS[case])
    offset = 0.25 if case == "vl_normalize_offset" else None
    want = jds.ProcgenDataset(cfg, dataset_name=NAME, start_offset_ratio=offset, split="train")
    got = tds.ProcgenDataset(cfg, dataset_name=NAME, start_offset_ratio=offset, split="train")
    assert len(got) == len(want) and got.num_actions == want.num_actions and got.obs_shape == want.obs_shape
    if cfg.get("use_vl"):
        assert (got.return_to_go, got.scale, got.reward_min) == (want.return_to_go, want.scale, want.reward_min)
        assert_tree_equal(want.rtgs, got.rtgs)
    for seed in (0, 7):
        want.set_epoch_seed(seed)
        got.set_epoch_seed(seed)
        for i in range(len(want)):
            assert_tree_equal(want[i], got[i], f"[{i}]")
    got.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_and_skip_batches_match_jax(files, workers):
    cfg = dict(path=str(files), image_size=8, num_frames=8, use_vl=True, window_size=4)
    make = lambda mod, lib: lib.DataLoader(mod.ProcgenDataset(cfg, dataset_name=NAME, split="train"),  # noqa: E731
                                           batch_size=5, shuffle=True, num_workers=workers, seed=3)
    want, got = make(jds, jloader), make(tds, tloader)
    assert len(got) == len(want) == 24 // 5
    for wb, gb in zip(list(want) + list(want), list(got) + list(got)):  # two epochs: reshuffled alike
        assert_tree_equal(wb, gb)
    for skip in (0, 3, 6):
        w_it, g_it = make(jds, jloader).epochs(skip_batches=skip), make(tds, tloader).epochs(skip_batches=skip)
        for _ in range(5):
            assert_tree_equal(next(w_it), next(g_it))
    assert got.state() == want.state()


def test_tokenizer_hash_fallback_matches_jax(monkeypatch):
    """No vocabulary file here: the deterministic hash vocabulary, id for id; CLIP BPE too."""
    monkeypatch.delenv("ARP_TPU_BERT_VOCAB", raising=False)
    texts = ["the goal is to collect the coin.", "navigate a maze, to collect the yellow cheese.", "",
             "One two THREE four five six seven eight nine ten eleven twelve"]
    for use_bert, max_length in ((True, 77), (True, 8), (False, 77)):
        want = jds.build_instruction_tokenizer(use_bert, max_length)
        got = tds.build_instruction_tokenizer(use_bert, max_length)
        for text in texts:
            assert_tree_equal(want(text), got(text), text)


def test_dataset_dirname_and_compute_scale():
    from arp_tpu.utils import compute_scale

    for args in (("coinrun",), ("maze", "easy", 5, 10, 20, 4, False, "aisc")):
        assert tds.dataset_dirname(*args) == jds.dataset_dirname(*args)
    for rtg in (0.0, 4.0, 7.0, 49.0, 51.0, 900.0, 1200.0, -300.0):
        assert tds.compute_scale(rtg) == compute_scale(rtg)


def _corrupt(path, how):
    with h5py.File(path, "a") as g:
        if how == "truncated":
            g["done"][-1, -1] = False
        elif how == "stacking":
            g["ob"][2, 0] = 255 - g["ob"][2, 0]
        elif how == "rtg":
            g.create_dataset("ob_clip_pos_rtg", data=g["ob_clip_reward"][:] + 1.0)
        elif how == "nan_reward":
            g["ob_clip_reward"][0, -1] = np.nan
        elif how == "no_act":
            del g["act"]
        elif how == "float_frames":
            data = g["ob"][:].astype(np.float32)
            del g["ob"]
            g.create_dataset("ob", data=data)


@pytest.mark.parametrize("how", ["clean", "truncated", "stacking", "rtg", "nan_reward", "no_act", "float_frames"])
def test_validate_file_errors_and_warnings_match_jax(files, how):
    path = str(files / NAME / "data_train.hdf5")
    _corrupt(path, how)
    for strict in (True, False):
        want = jvalidate.validate_file(path, strict_stacking=strict)
        got = tvalidate.validate_file(path, strict_stacking=strict)
        assert (got.errors, got.warnings) == (want.errors, want.warnings)
    missing = tvalidate.validate_file(str(files / "nope.hdf5"))
    assert any("cannot open" in e for e in missing.errors)
