"""The port's ARPS shards, host resize and ``resize_mode="host"`` engine against arp_tpu's.

Shards are byte-identical across the two packages in both directions (the
native readers and ``force_python``), including a record zlib cannot shrink,
which is stored raw, and ``convert_hdf5``.  The host resize differs from
JAX's in 0 bytes.  The host engine gives the JAX host engine's rewards (1e-5,
the float32 engines' parity bound of tests/test_torch_reward_engine.py) and the
port's own pil engine's bit for bit.  ``ProcgenDataset(use_arps=True)`` gives
the HDF5 path's and JAX's samples, field for field.
"""

import os

import h5py
import jax
import numpy as np
import pytest

from arp_tpu.data import arps as jarps
from arp_tpu.data import procgen_dataset as jds
from arp_tpu.ops import preprocess as jpre
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, make_tiny_clip_engine
from arp_tpu_torch import native
from arp_tpu_torch.data import arps as tarps
from arp_tpu_torch.data import procgen_dataset as tds
from arp_tpu_torch.models.clip import CLIP
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.ops import preprocess as tpre
from arp_tpu_torch.reward.engine import ClipRewardEngine
from test_dataset import NAME, make_file
from test_torch_train_data import assert_tree_equal


def _records():
    rng = np.random.default_rng(0)
    u8 = np.zeros((5, 6, 7, 3), np.uint8)
    u8[1] = rng.integers(0, 256, size=(6, 7, 3), dtype=np.uint8)  # incompressible: stored raw
    u8[3] = 9
    return {
        "u8": u8,
        "i32": rng.integers(-5, 5, size=(4, 3)).astype(np.int32),
        "i64": np.arange(12, dtype=np.int64).reshape(3, 2, 2),
        "f32": rng.normal(size=(4, 5)).astype(np.float32),
    }


def _payload_sizes(path):
    r = tarps.ArpsReader(path, force_python=True)
    sizes = np.diff(r._py_offsets.astype(np.int64))
    return sizes, r._record_bytes


@pytest.mark.parametrize("kind", list(_records()))
@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "raw"])
def test_shards_are_byte_identical_and_read_across_packages(tmp_path, kind, compress):
    data = _records()[kind]
    ours, theirs = str(tmp_path / "port.arps"), str(tmp_path / "jax.arps")
    tarps.write_arps(ours, data, compress=compress)
    jarps.write_arps(theirs, data, compress=compress)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    idx = [len(data) - 1, 0, 1, 1]
    for path in (ours, theirs):
        for force_python in (False, True):
            for reader_cls in (tarps.ArpsReader, jarps.ArpsReader):
                r = reader_cls(path, num_threads=3, force_python=force_python)
                assert (len(r), tuple(r.record_shape), r.dtype) == (len(data), data.shape[1:], data.dtype)
                np.testing.assert_array_equal(r.read_batch(idx), data[idx])
                r.close()
    if kind == "u8" and compress:
        sizes, record_bytes = _payload_sizes(ours)
        assert sizes[1] == record_bytes and sizes[0] < record_bytes  # the random record raw, zeros compressed


def test_convert_hdf5_is_byte_identical_to_jax(tmp_path):
    src = str(tmp_path / "demo.hdf5")
    rng = np.random.default_rng(1)
    with h5py.File(src, "w") as g:
        g.create_dataset("ob", data=rng.integers(0, 256, size=(6, 2, 8, 8, 3), dtype=np.uint8))
        g.create_dataset("done", data=rng.integers(0, 2, size=(6, 2)).astype(bool))  # bool -> uint8
        g.create_dataset("rtg", data=rng.normal(size=(6, 2)))  # float64 -> float32
    ours = tarps.convert_hdf5(src, str(tmp_path / "port"))
    theirs = jarps.convert_hdf5(src, str(tmp_path / "jax"))
    assert sorted(ours) == sorted(theirs) == ["done", "ob", "rtg"]
    for key in ours:
        with open(ours[key], "rb") as a, open(theirs[key], "rb") as b:
            assert a.read() == b.read(), key
    assert not [f for f in os.listdir(tmp_path / "port") if ".tmp." in f]  # renamed into place
    r = tarps.ArpsReader(ours["done"])
    assert r.dtype == np.uint8 and r.read_batch([0, 5]).shape == (2, 2)


def test_reader_refuses_bad_files_and_indices(tmp_path):
    bad = tmp_path / "bad.arps"
    bad.write_bytes(b"NOPE" + bytes(40))
    for force_python in (False, True):
        with pytest.raises(IOError):
            tarps.ArpsReader(str(bad), force_python=force_python)
    good = str(tmp_path / "good.arps")
    tarps.write_arps(good, np.zeros((3, 4), np.uint8))
    with pytest.raises(IOError, match="rc=2"):
        tarps.ArpsReader(good).read_batch([3])
    with pytest.raises(IndexError):
        tarps.ArpsReader(good, force_python=True).read_batch([3])


def test_a_failed_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    """Without g++ the native reader and the host resize raise; JAX's reader would switch to Python."""
    monkeypatch.setattr(tarps, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    tarps.native_lib.cache_clear()
    path = str(tmp_path / "x.arps")
    tarps.write_arps(path, np.zeros((2, 3), np.uint8))
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tarps.ArpsReader(path)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tpre.resize_bicubic_pil_host(np.zeros((1, 8, 8, 3), np.uint8), 4, 4)
        np.testing.assert_array_equal(tarps.ArpsReader(path, force_python=True).read_batch([1]), np.zeros((1, 3)))
    finally:
        tarps.native_lib.cache_clear()


def test_the_library_builds_from_the_port_s_source():
    """The reader and the host resize come from the port's own arps.cpp, built under build/arp_tpu_torch/."""
    assert tarps.SOURCE.parent == native.SOURCE_DIR and "arp_tpu_torch" in tarps.SOURCE.parts
    lib = tarps.native_lib()
    assert hasattr(lib, "arps_read_batch") and hasattr(lib, "pil_resize_batch")
    assert os.path.dirname(lib._name) == str(tarps.BUILD_DIR) and "arp_tpu_torch" in lib._name


@pytest.mark.parametrize("size,out", [(64, 224), (256, 224), ((37, 53), 31)], ids=["64to224", "256to224", "odd"])
def test_host_resize_is_byte_identical_to_jax(size, out):
    h, w = size if isinstance(size, tuple) else (size, size)
    frames = np.random.default_rng(h).integers(0, 256, size=(3, h, w, 3), dtype=np.uint8)
    got = tpre.resize_bicubic_pil_host(frames, out, out, num_threads=2)
    assert got.dtype == np.uint8 and got.shape == (3, out, out, 3)
    assert int((got != jpre.resize_bicubic_pil_host(frames, out, out)).sum()) == 0
    assert int((got != tpre.resize_bicubic_pil_reference(frames, out, out)).sum()) == 0


@pytest.fixture(scope="module")
def variables():
    return jax.tree_util.tree_map(np.asarray, make_tiny_clip_engine(batch_size=8).variables)


def _engine(variables, **kwargs):
    return ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE), variables=variables,
                            tokenizer=Char97Tokenizer(), batch_size=8, device="cpu", **kwargs)


@pytest.mark.parametrize("use_crop", [False, True], ids=["no_crop", "crop"])
def test_host_engine_matches_jax_and_the_pil_engine(variables, use_crop):
    """Host mode keeps the packed path under use_crop, as JAX's does; the card's resize from image_size to
    image_size is skipped, so host and pil rewards are one computation."""
    frames = np.random.default_rng(5).integers(0, 256, size=(11, 48, 48, 3), dtype=np.uint8)
    host = _engine(variables, resize_mode="host", use_crop=use_crop)
    jax_host = make_tiny_clip_engine(batch_size=8, resize_mode="host", use_crop=use_crop)
    assert host._packed and host.encode_recipe == "torch;" + jax_host.encode_recipe.split(";", 1)[1]
    text = "collect the coin."
    got = host.text_rewards(frames, text)
    np.testing.assert_allclose(got, jax_host.text_rewards(frames, text), atol=1e-5)
    np.testing.assert_allclose(host.goal_rewards(frames), jax_host.goal_rewards(frames), atol=1e-5)
    if not use_crop:
        np.testing.assert_array_equal(got, _engine(variables, resize_mode="pil").text_rewards(frames, text))
    else:  # the pil engine crops on the device through the unpacked path: the same bytes reach the tower
        np.testing.assert_allclose(got, _engine(variables, resize_mode="pil", use_crop=True).text_rewards(frames, text),
                                   atol=1e-5)


def test_host_engine_takes_the_packed_fast_paths(variables):
    frames = np.random.default_rng(6).integers(0, 256, size=(8, 40, 40, 3), dtype=np.uint8)
    fast_host = _engine(variables, resize_mode="host", fast_encode=True, fast_score_bf16=False)
    fast_pil = _engine(variables, resize_mode="pil", fast_encode=True, fast_score_bf16=False)
    assert fast_host._fast is not None and "resize=host" in fast_host.encode_recipe
    np.testing.assert_array_equal(fast_host.encode_image_features(frames), fast_pil.encode_image_features(frames))


@pytest.fixture
def files(tmp_path):
    make_file(tmp_path, "train")
    return tmp_path


@pytest.mark.parametrize("cfg", [dict(window_size=4), dict(use_vl=True, window_size=3)], ids=["plain", "vl"])
def test_dataset_use_arps_matches_hdf5_and_jax(files, cfg):
    cfg = dict(path=str(files), image_size=8, num_frames=8, **cfg)
    hdf5 = tds.ProcgenDataset(cfg, dataset_name=NAME)
    ours = tds.ProcgenDataset(dict(cfg, use_arps=True), dataset_name=NAME)
    shard = files / NAME / "data_train.hdf5.arps" / "ob.arps"
    assert shard.exists() and set(ours._arps) == {"ob"}
    theirs = jds.ProcgenDataset(dict(cfg, use_arps=True), dataset_name=NAME)  # reads the port's shard
    for seed in (0, 3):
        for ds in (hdf5, ours, theirs):
            ds.set_epoch_seed(seed)
        for i in range(len(hdf5)):
            want = hdf5[i]
            assert_tree_equal(want, ours[i], f"[{i}]")
            assert_tree_equal(want, theirs[i], f"[{i}]")
    mtime = shard.stat().st_mtime_ns
    tds.ProcgenDataset(dict(cfg, use_arps=True), dataset_name=NAME).close()  # converted once
    assert shard.stat().st_mtime_ns == mtime
    ours.close()
    hdf5.close()
