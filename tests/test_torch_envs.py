"""The port's environments (arp_tpu_torch/envs/) against the JAX package's: the same seeds and action
streams give the same frames, rewards, dones and state blobs, byte for byte.

FakeProcgen (the numpy random stream of a level), the state codec (the C++ engine's wire format),
the gym3 stub behind the Procgen wrapper (``ARP_TPU_FAKE_ENGINE=1``), and the port's native engine
(its own gridenv.cpp, built with g++ at first use) against the Python stub."""

import numpy as np
import pytest

from arp_tpu.envs import fake as jfake
from arp_tpu.envs import gym3_stub as jstub
from arp_tpu.envs import procgen as jprocgen
from arp_tpu.envs import state_codec as jcodec
from arp_tpu_torch.envs import fake as tfake
from arp_tpu_torch.envs import gym3_stub as tstub
from arp_tpu_torch.envs import procgen as tprocgen
from arp_tpu_torch.envs import state_codec as tcodec
from test_envs_rollout import _sample_state

FAKE_CASES = {
    "default_64px_grid8": {},
    "32px_grid4_short": {"image_size": 32, "grid": 4, "episode_length": 7},
    "hidden_goal": {"image_size": 16, "grid": 3, "hidden_goal": True, "episode_length": 9},
    "no_video_two_views": {"record_video": False, "image_key": "ob, side", "image_size": 16, "grid": 5},
}


@pytest.mark.parametrize("case", list(FAKE_CASES))
def test_fake_procgen_episode_stream_is_jax_s(case):
    """Three episodes from seeded resets under one seeded action stream (actions 0-5: moves and no-ops),
    then a get_state / set_state round trip: every frame, reward, done, info and state equal."""
    conf = FAKE_CASES[case]
    jenv, tenv = jfake.FakeProcgen("coinrun", dict(conf)), tfake.FakeProcgen("coinrun", dict(conf))
    assert dict(tenv.config) == {k: jenv.config[k] for k in jenv.config}
    rng = np.random.default_rng(0)
    for ep in range(3):
        jo, to = jenv.reset(7 + ep), tenv.reset(7 + ep)
        for key in jo["image"]:
            assert jo["image"][key].dtype == to["image"][key].dtype == np.uint8
            np.testing.assert_array_equal(jo["image"][key], to["image"][key])
        done = False
        while not done:
            a = rng.integers(0, 6)
            jo, jr, done, jinfo = jenv.step(a)
            to, tr, tdone, tinfo = tenv.step(np.asarray(a))
            assert (jr, done) == (tr, tdone)
            np.testing.assert_array_equal(jo["image"]["ob"], to["image"]["ob"])
            assert (jinfo["episode_len"], jinfo["terminal"]) == (tinfo["episode_len"], tinfo["terminal"])
            assert (jinfo["vid"] is None) == (tinfo["vid"] is None)
            if jinfo["vid"] is not None:
                np.testing.assert_array_equal(jinfo["vid"], tinfo["vid"])
    js, ts = jenv.get_state(), tenv.get_state()
    assert js["i"] == ts["i"] and np.array_equal(js["agent"], ts["agent"]) and np.array_equal(js["goal"], ts["goal"])
    jenv.step(1), tenv.step(1)
    np.testing.assert_array_equal(jenv.set_state(js)["image"]["ob"], tenv.set_state(ts)["image"]["ob"])


@pytest.mark.parametrize("game,env_type", [("coinrun", "none"), ("maze", "none"), ("maze_aisc", "aisc"),
                                           ("coinrun_aisc", "none")])
def test_state_codec_bytes_and_round_trip(game, env_type):
    data = _sample_state(game)
    if "_" in game or env_type == "aisc":
        data.update(random_percent=50, key_penalty=1, step_penalty=0, rand_region=5, continue_after_coin=1)
    blob = tcodec.encode_state(data, env_type=env_type)
    assert blob == jcodec.encode_state(data, env_type=env_type)
    back = tcodec.decode_state(blob, env_type=env_type)
    assert back == jcodec.decode_state(blob, env_type=env_type)
    assert tcodec.encode_state(back, env_type=env_type) == blob  # decode(encode(x)) re-encodes to the same bytes
    for k, v in data.items():
        assert back[k] == pytest.approx(v) if isinstance(v, float) else back[k] == v, k
    with pytest.raises(ValueError, match="sentinel"):
        tcodec.decode_state(blob[:-4] + b"\x00\x00\x00\x00", env_type=env_type)


STUB = dict(game_name="coinrun", num=3, resolution=32, grid=5, episode_length=7, num_levels=10, start_level=2,
            rand_seed=11)


def _streams_equal(a, b, steps=40, seed=0):
    rng = np.random.default_rng(seed)
    for step in range(steps):  # 40 steps of 7-step episodes: many auto-resets
        rew_a, obs_a, first_a = a.observe()
        rew_b, obs_b, first_b = b.observe()
        np.testing.assert_array_equal(rew_a, rew_b, err_msg=f"step {step}")
        np.testing.assert_array_equal(first_a, first_b, err_msg=f"step {step}")
        np.testing.assert_array_equal(obs_a["rgb"], obs_b["rgb"], err_msg=f"step {step}")
        ac = rng.integers(0, 6, size=a.num)
        a.act(ac)
        b.act(ac)
    assert a.get_state() == b.get_state()


@pytest.mark.parametrize("game,env_type", [("coinrun", "none"), ("maze", "aisc")])
def test_gym3_stub_stream_and_blobs_are_jax_s(game, env_type):
    ctor = dict(STUB, game_name=game, env_type=env_type)
    assert [tstub.place_entities(s, 9) for s in range(20)] == [jstub.place_entities(s, 9) for s in range(20)]
    _streams_equal(jstub.FakeProcgenGym3(**ctor), tstub.FakeProcgenGym3(**ctor))
    # a blob of one package restores into the other
    j, t = jstub.FakeProcgenGym3(**ctor), tstub.FakeProcgenGym3(**dict(ctor, rand_seed=99))
    j.act(np.array([1, 3, 0]))
    t.callmethod("set_state", j.callmethod("get_state"))
    assert t.callmethod("get_state") == j.callmethod("get_state")
    np.testing.assert_array_equal(t.observe()[1]["rgb"], j.observe()[1]["rgb"])


def test_procgen_wrapper_over_the_stub_is_jax_s(monkeypatch):
    """``ARP_TPU_FAKE_ENGINE=1``: the Procgen wrapper's real branches (the eval level block, a fresh
    engine per reset, the inner env found by its set_state, blob restore + re-render) as JAX's."""
    monkeypatch.setenv("ARP_TPU_FAKE_ENGINE", "1")
    conf = {"episode_length": 6, "record_every": 2}
    for resolution in ("high", "low"):
        jenv = jprocgen.Procgen("maze", dict(conf), image_resolution=resolution)
        tenv = tprocgen.Procgen("maze", dict(conf), image_resolution=resolution)
        assert tenv._level_range() == jenv._level_range() == (500, 1000)
        rng = np.random.default_rng(1)
        for ep in range(2):
            np.testing.assert_array_equal(jenv.reset(3 + ep)["image"]["ob"], tenv.reset(3 + ep)["image"]["ob"])
            done = False
            while not done:
                a = int(rng.integers(0, 4))
                jo, jr, done, jinfo = jenv.step(a)
                to, tr, tdone, tinfo = tenv.step(a)
                assert (jr, done, jinfo["episode_len"]) == (tr, tdone, tinfo["episode_len"])
                np.testing.assert_array_equal(jo["image"]["ob"], to["image"]["ob"])
                assert (jinfo["vid"] is None) == (tinfo["vid"] is None)
        state = jenv.get_state()
        assert isinstance(state[0], bytes) and tenv.get_state() == state
        tenv.step(1)
        np.testing.assert_array_equal(tenv.set_state(state)["image"]["ob"], jenv.set_state(state)["image"]["ob"])


def test_procgen_without_the_engine_raises_as_jax(monkeypatch):
    monkeypatch.delenv("ARP_TPU_FAKE_ENGINE", raising=False)
    import builtins

    real_import = builtins.__import__

    def no_gym(name, *args, **kwargs):
        if name == "gym":
            raise ImportError("No module named 'gym'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_gym)
    with pytest.raises(ImportError, match="ARP_TPU_FAKE_ENGINE=1"):
        tprocgen.Procgen("coinrun", {})


def test_native_engine_stream_is_the_python_stub_s():
    """The port's native engine (built with g++ from its own gridenv.cpp into build/arp_tpu_torch/native/)
    against the Python stub: one stream, byte-identical blobs both ways, and the wrapper on it."""
    from arp_tpu_torch.envs import native_engine

    lib_path = native_engine.build_native()
    assert lib_path.parent == native_engine.BUILD_DIR and "arp_tpu_torch" in lib_path.parts
    _streams_equal(tstub.FakeProcgenGym3(**STUB), native_engine.NativeProcgenGym3(**STUB))
    py, nat = tstub.FakeProcgenGym3(**STUB), native_engine.NativeProcgenGym3(**dict(STUB, rand_seed=99))
    py.act(np.array([1, 3, 0]))
    nat.callmethod("set_state", py.callmethod("get_state"))
    assert nat.callmethod("get_state") == py.callmethod("get_state")
    nat._lib.grid_set_episode_counter(nat._handle, py._episode_counter)  # blobs carry no level counter
    _streams_equal(py, nat, steps=10, seed=3)
    assert nat.episode_counter == py._episode_counter
    env = tstub.make_fake_gym_env("coinrun", engine="native", resolution=32, grid=4, episode_length=5)
    ref = jstub.make_fake_gym_env("coinrun", engine="python", resolution=32, grid=4, episode_length=5)
    np.testing.assert_array_equal(env.reset(), ref.reset())
    for a in (1, 3, 1, 3, 0, 2):
        got, want = env.step(a), ref.step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:3] == want[1:3]


def test_native_engine_build_failure_raises(monkeypatch, tmp_path):
    """No compiler, or a failing build: the engine raises with the reason, as JAX's refuses to construct."""
    from arp_tpu_torch import native
    from arp_tpu_torch.envs import native_engine

    monkeypatch.setattr(native_engine, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native_engine.native_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native_engine.NativeProcgenGym3(**STUB)
        monkeypatch.setattr(native.shutil, "which", lambda name: "/bin/false")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native_engine.build_native()
        assert not list(tmp_path.iterdir())  # no half-written library left behind
    finally:
        native_engine.native_lib.cache_clear()
