"""The port's PPG expert (arp_tpu_torch/collect/ppg.py) against arp_tpu's, on the CPU at the model's own
widths (64 x 64 frames).

The same numpy inputs from a seed go to the JAX function and to the port's: the model's forward in
each arch and pooling (weights through ``flax_ppg_to_torch``), GAE, one PPO / pi + vf / aux step
(losses 1e-5, gradients 1e-4 of the largest entry, params after Adam 1e-5; a vf leaf bit-still under
the pi loss), a whole iteration's updates from one JAX-recorded segment in the combined and the
separate branch with the aux phase (params 1e-4 of the largest entry), the rollers' segments under a
fixed action stream, and ``learn``'s kill-and-resume against an uninterrupted run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as FlaxTrainState

from arp_tpu.collect import ppg as jppg
from arp_tpu.envs.fake import FakeProcgen as JFakeProcgen
from arp_tpu.envs.gym3_stub import FakeProcgenGym3 as JFakeGym3
from arp_tpu_torch.collect import ppg as tppg
from arp_tpu_torch.collect.convert_ppg import flax_ppg_to_torch, torch_ppg_to_flax
from arp_tpu_torch.envs.fake import FakeProcgen
from arp_tpu_torch.envs.gym3_stub import FakeProcgenGym3
from arp_tpu_torch.parallel.step import TrainState

FRAME = (64, 64, 3)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _flax_params(arch="dual", pool="same", seed=0):
    model = jppg.PhasicValueModel(num_actions=15, arch=arch, pool_padding=pool)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + FRAME, jnp.float32))["params"]
    return model, _np_tree(params)


def _port_model(params, arch="dual", pool="same"):
    model = tppg.PhasicValueModel(num_actions=15, arch=arch, pool_padding=pool)
    model.load_state_dict(flax_ppg_to_torch(params))
    return model


def _port_tree(names, tensors):
    return torch_ppg_to_flax(dict(zip(names, tensors)))


def _assert_trees_close(got, want, rel, what):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys(), what
    scale = max(float(np.abs(v).max()) for v in want.values())
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= rel * scale, f"{what}: {worst} > {rel} x {scale}"


def _batch(n, seed, old_logits=False):
    rng = np.random.default_rng(seed)
    batch = {"obs": rng.random((n,) + FRAME).astype(np.float32),
             "act": rng.integers(0, 15, n).astype(np.int32),
             "logp_old": (-np.abs(rng.normal(size=n)) - 1.5).astype(np.float32),
             "adv": rng.normal(size=n).astype(np.float32),
             "vtarg": rng.normal(size=n).astype(np.float32)}
    if old_logits:
        batch["old_logits"] = rng.normal(size=(n, 15)).astype(np.float32)
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["dual", "shared", "detach"])
@pytest.mark.parametrize("pool", ["same", "torch"])
def test_forward_matches_flax(arch, pool):
    model, params = _flax_params(arch, pool, seed=1)
    port = _port_model(params, arch, pool)
    obs = np.random.default_rng(2).random((5,) + FRAME).astype(np.float32)
    want = model.apply({"params": params}, jnp.asarray(obs))
    with torch.no_grad():
        got = port(torch.from_numpy(obs))
    for g, w, name in zip(got, want, ("logits", "value", "aux_value")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    back = _leaves(torch_ppg_to_flax(port.state_dict()))
    assert back.keys() == _leaves(params).keys()
    assert all(np.array_equal(back[k], v) for k, v in _leaves(params).items())


def test_init_draws_as_flax_does():
    """The port's own init: Flax's tree and shapes, lecun-normal spreads, zero biases, orthogonal(0.1) heads."""
    _, params = _flax_params(seed=0)
    port = tppg.PhasicValueModel(frame_shape=FRAME, generator=torch.Generator().manual_seed(3))
    mine = _leaves(torch_ppg_to_flax(port.state_dict()))
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in _leaves(params).items()}
    for k, v in mine.items():
        if k[-1] == "bias":
            assert not v.any(), k
        elif k[0].endswith("head"):
            np.testing.assert_allclose(v.T @ v, 0.01 * np.eye(v.shape[1]), atol=1e-6, err_msg=str(k))
        else:
            fan_in = int(np.prod(v.shape[:-1]))
            assert abs(v.std() * np.sqrt(fan_in) - 1.0) < 0.1 and np.abs(v).max() <= 2 / 0.8796 / np.sqrt(fan_in) + 1e-6
    again = tppg.PhasicValueModel(frame_shape=FRAME, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(port.state_dict().values(), again.state_dict().values()))


def test_compute_gae_equal():
    rng = np.random.default_rng(0)
    T, N = 9, 4
    r, v = rng.normal(size=(T, N)).astype(np.float32), rng.normal(size=(T, N)).astype(np.float32)
    d = (rng.random((T, N)) < 0.2).astype(np.float32)
    last = rng.normal(size=N).astype(np.float32)
    for got, want in zip(tppg.compute_gae(r, v, d, last, 0.99, 0.9), jppg.compute_gae(r, v, d, last, 0.99, 0.9)):
        np.testing.assert_array_equal(got, want)


def _jax_steps(model, config):
    return jppg.make_ppg_steps(model, config)


def test_ppo_and_aux_steps_match_jax():
    """One combined PPO step, then one aux step, from the same params and batches."""
    config = jppg.PPGConfig(lr=5e-4)
    model, params = _flax_params(seed=4)
    j_ppo, j_aux, *_ = _jax_steps(model, config)
    jstate = FlaxTrainState.create(apply_fn=model.apply, params=params, tx=optax.adam(config.lr))
    port = _port_model(params)
    tconfig = tppg.PPGConfig(lr=5e-4)
    state = TrainState.create(port, tppg.make_adam(tconfig, len(list(port.parameters()))))
    names = [n for n, _ in state.params]
    t_ppo, t_aux, *_ = tppg.make_ppg_steps(port, tconfig)

    for step_name, batch in (("ppo", _batch(12, 5)), ("aux", _batch(12, 6, old_logits=True))):
        if step_name == "aux":
            batch = {k: batch[k] for k in ("obs", "vtarg", "old_logits")}
            jstate, jm = j_aux(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            state, tm = t_aux(state, _to_torch(batch))
        else:
            jstate, jm = j_ppo(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            state, tm = t_ppo(state, _to_torch(batch))
        assert jm.keys() == tm.keys()
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=f"{step_name} {k}")
        # the first moment after the update: (1 - b1) g + b1 mu_before, the gradient's trace
        j_mu = _np_tree(jstate.opt_state[0].mu)
        _assert_trees_close(_port_tree(names, state.opt_state.mu), j_mu, 1e-4, f"{step_name} first moment")
        got, want = _leaves(_port_tree(names, [p for _, p in state.params])), _leaves(_np_tree(jstate.params))
        assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-5, step_name
    assert state.step == int(jstate.step) == 2


def test_pi_and_vf_steps_match_jax_and_keep_the_other_phase_still():
    config = jppg.PPGConfig(lr=5e-4, ppo_epochs=1, vf_epochs=2)
    model, params = _flax_params(seed=7)
    _, _, _, _, j_pi, j_vf, j_init = _jax_steps(model, config)
    port = _port_model(params)
    tconfig = tppg.PPGConfig(lr=5e-4, ppo_epochs=1, vf_epochs=2)
    state = TrainState.create(port, tppg.make_adam(tconfig, len(list(port.parameters()))))
    names = [n for n, _ in state.params]
    _, _, _, _, t_pi, t_vf, t_init = tppg.make_ppg_steps(port, tconfig)
    j_pi_opt, j_vf_opt = j_init(params)
    t_pi_opt, t_vf_opt = t_init(state.params)
    batch = _batch(10, 8)
    jparams = params
    for phase in ("vf", "pi"):
        before = {n: p.detach().clone() for n, p in state.params}
        if phase == "vf":
            jparams, j_vf_opt, jm = j_vf(jparams, j_vf_opt, {k: jnp.asarray(v) for k, v in batch.items()})
            _, t_vf_opt, tm = t_vf(state.params, t_vf_opt, _to_torch(batch))
            j_mu, t_mu = j_vf_opt[0].mu, t_vf_opt.mu
        else:
            jparams, j_pi_opt, jm = j_pi(jparams, j_pi_opt, {k: jnp.asarray(v) for k, v in batch.items()})
            _, t_pi_opt, tm = t_pi(state.params, t_pi_opt, _to_torch(batch))
            j_mu, t_mu = j_pi_opt[0].mu, t_pi_opt.mu
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=f"{phase} {k}")
        _assert_trees_close(_port_tree(names, t_mu), _np_tree(j_mu), 1e-4, f"{phase} first moment")
        got = _leaves(_port_tree(names, [p for _, p in state.params]))
        want = _leaves(_np_tree(jparams))
        assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-5, phase
        # a leaf the phase's loss does not reach stays bit-equal
        still = ("vf_enc.stack0_firstconv.weight", "vf_head.weight") if phase == "pi" else (
            "pi_head.weight", "aux_vf_head.bias")
        for n in still:
            assert torch.equal(dict(state.params)[n], before[n]), (phase, n)
        moved = "pi_head.weight" if phase == "pi" else "vf_head.weight"
        assert not torch.equal(dict(state.params)[moved], before[moved])


def test_logits_of_in_chunks_equals_one_call(monkeypatch):
    monkeypatch.setattr(tppg, "LOGITS_CHUNK", 3)
    _, params = _flax_params(seed=9)
    port = _port_model(params)
    *_, logits_of, _, _, _ = tppg.make_ppg_steps(port, tppg.PPGConfig())
    obs = torch.from_numpy(np.random.default_rng(1).random((8,) + FRAME).astype(np.float32))
    with torch.no_grad():
        whole = port(obs)[0]
    np.testing.assert_allclose(logits_of(obs).numpy(), whole.numpy(), atol=1e-6)


def _jax_segment(num_envs=3, T=10, seed=11):
    """A segment recorded by the JAX package's Gym3Roller with JAX's act on random params, and its flat
    batch as JAX's learn builds it (reward normalization, GAE, whitening)."""
    model, params = _flax_params(seed=seed)
    _, _, j_act, _, _, _, _ = _jax_steps(model, jppg.PPGConfig())
    venv = JFakeGym3(game_name="coinrun", num=num_envs, resolution=64, grid=4, episode_length=6, rand_seed=seed)
    roller = jppg.Gym3Roller(venv, lambda frames, rng: j_act(params, jnp.asarray(frames), rng))
    seg, _ = roller.collect(jax.random.PRNGKey(seed), T)
    seg = _np_tree(seg)
    from arp_tpu.collect.reward_normalizer import RewardNormalizer

    seg["reward"] = RewardNormalizer(num_envs, gamma=0.999).normalize_segment(seg["reward"], seg["done"])
    adv, vtarg = jppg.compute_gae(seg["reward"], seg["value"], seg["done"], seg["last_value"])
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    flat = {"obs": seg["obs"].reshape((-1,) + FRAME), "act": seg["act"].reshape(-1),
            "logp_old": seg["logp"].reshape(-1), "adv": adv.reshape(-1).astype(np.float32),
            "vtarg": vtarg.reshape(-1).astype(np.float32)}
    return model, params, flat


def _jax_iteration(model, params, flat, config, it, seed, aux):
    """learn's update block of arp_tpu/collect/ppg.py for one iteration, with JAX's own steps."""
    ppo_step, aux_step, _, logits_of, pi_step, vf_step, init_phase_opts = jppg.make_ppg_steps(model, config)
    state = FlaxTrainState.create(apply_fn=model.apply, params=params, tx=optax.adam(config.lr))
    perm_rng = np.random.default_rng(seed + it)
    n = flat["act"].shape[0]
    put = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    if config.ppo_epochs == config.vf_epochs:
        for _ in range(config.ppo_epochs):
            for mb in np.array_split(perm_rng.permutation(n), config.minibatches):
                state, _ = ppo_step(state, put({k: v[mb] for k, v in flat.items()}))
    else:
        pi_opt, vf_opt = init_phase_opts(state.params)
        p = state.params
        for _ in range(config.vf_epochs):
            for mb in np.array_split(perm_rng.permutation(n), config.minibatches):
                p, vf_opt, _ = vf_step(p, vf_opt, put({k: v[mb] for k, v in flat.items()}))
        for _ in range(config.ppo_epochs):
            for mb in np.array_split(perm_rng.permutation(n), config.minibatches):
                p, pi_opt, _ = pi_step(p, pi_opt, put({k: v[mb] for k, v in flat.items()}))
        state = state.replace(params=p)
    if aux:
        old_logits = np.asarray(logits_of(state.params, jnp.asarray(flat["obs"])))
        m = flat["obs"].shape[0]
        for _ in range(config.aux_epochs):
            for mb in np.array_split(perm_rng.permutation(m), config.aux_minibatches):
                state, _ = aux_step(state, put({"obs": flat["obs"][mb], "vtarg": flat["vtarg"][mb],
                                                "old_logits": old_logits[mb]}))
    return _np_tree(state.params)


def _port_iteration(params, flat, config, it, seed, aux):
    port = _port_model(params)
    state = TrainState.create(port, tppg.make_adam(config, len(list(port.parameters()))))
    ppo_step, aux_step, _, logits_of, pi_step, vf_step, init_phase_opts = tppg.make_ppg_steps(port, config)
    phase_opts = init_phase_opts(state.params) if config.ppo_epochs != config.vf_epochs else None
    perm_rng = np.random.default_rng(seed + it)
    tflat = {k: torch.from_numpy(v.astype(np.int64) if k == "act" else v) for k, v in flat.items()}
    acc = {}

    def _acc(m, prefix=""):
        for k, v in m.items():
            acc.setdefault(prefix + k, []).append(v)

    state, _ = tppg.policy_phase((ppo_step, pi_step, vf_step), state, phase_opts, tflat, perm_rng, config, _acc)
    if aux:
        state = tppg.aux_phase((aux_step, logits_of), state, [{"obs": tflat["obs"], "vtarg": tflat["vtarg"]}],
                               perm_rng, config, _acc)
    assert all(np.isfinite(float(v)) for vs in acc.values() for v in vs)
    return torch_ppg_to_flax(port.state_dict()), acc


@pytest.mark.parametrize("epochs,aux", [((1, 1), True), ((1, 2), False)], ids=["combined_and_aux", "separate"])
def test_one_iteration_from_a_jax_segment_matches_jax(epochs, aux):
    """The aux phase is held after the combined branch.  After the separate branch the state's own Adam is
    fresh when the aux phase starts, and the KL term's gradient at its anchor (the current logits) is zero
    up to rounding: Adam's first normalized step turns that rounding into +-lr moves of pi_head, in JAX as
    in the port (measured: 818 of its 3840 weights differ by up to 8e-4), so no two implementations agree
    there."""
    model, params, flat = _jax_segment()
    kw = dict(lr=5e-4, ppo_epochs=epochs[0], vf_epochs=epochs[1], minibatches=2, aux_epochs=1, aux_minibatches=2)
    want = _jax_iteration(model, params, flat, jppg.PPGConfig(**kw), it=3, seed=0, aux=aux)
    got, acc = _port_iteration(params, flat, tppg.PPGConfig(**kw), it=3, seed=0, aux=aux)
    _assert_trees_close(got, want, 1e-4, "params after the iteration")
    assert "vf_loss" in acc and ("kl" in acc) == aux and ("vf_vf_loss" in acc) == (epochs[0] != epochs[1])


def _scripted_act_fn(num_actions=4):
    """A pure function of the frames: the same action stream for both packages' rollers."""

    def act_fn(frames, rng):
        del rng
        f = np.asarray(frames)
        acts = (f.reshape(f.shape[0], -1).sum(axis=1) * 255).astype(np.int64) % num_actions
        return acts.astype(np.int32), np.zeros(len(f), np.float32), np.zeros(len(f), np.float32)

    return act_fn


@pytest.mark.parametrize("engine", ["python", "native"])
def test_gym3_roller_segments_equal_jax(engine):
    ctor = dict(game_name="coinrun", num=3, resolution=16, grid=4, episode_length=6, rand_seed=5)
    if engine == "native":
        from arp_tpu.envs.native_engine import NativeProcgenGym3 as JNative
        from arp_tpu.envs.native_engine import native_lib as j_native_lib
        from arp_tpu_torch.envs.native_engine import NativeProcgenGym3 as TNative

        if j_native_lib() is None:
            pytest.skip("the JAX package's libgridenv.so is unavailable")
        jvenv, tvenv = JNative(**ctor), TNative(**ctor)
    else:
        jvenv, tvenv = JFakeGym3(**ctor), FakeProcgenGym3(**ctor)
    jroller = jppg.Gym3Roller(jvenv, _scripted_act_fn())
    troller = tppg.Gym3Roller(tvenv, _scripted_act_fn())
    want, _ = jroller.collect(jax.random.PRNGKey(0), 20)
    got, _ = troller.collect(torch.Generator().manual_seed(0), 20)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert troller.ep_returns == jroller.ep_returns and len(troller.ep_returns) > 0
    np.testing.assert_array_equal(troller._running, jroller._running)
    # gym3 semantics: a goal reward coincides with a done flag
    assert np.all(got["done"][got["reward"] == 10.0] == 1.0)


def test_roller_segments_equal_jax():
    conf = {"episode_length": 7, "image_size": 16, "grid": 3}
    jroller = jppg.Roller([JFakeProcgen("coinrun", conf) for _ in range(2)], _scripted_act_fn(), seed=4)
    troller = tppg.Roller([FakeProcgen("coinrun", conf) for _ in range(2)], _scripted_act_fn(), seed=4)
    want, _ = jroller.collect(jax.random.PRNGKey(0), 15)
    got, _ = troller.collect(torch.Generator().manual_seed(0), 15)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert troller.ep_returns == jroller.ep_returns and len(troller.ep_returns) > 0


class _StatelessVenv:
    """A gym3 venv whose observation is fixed and whose reward is a function of the action alone: a run
    resumed from a checkpoint sees what an uninterrupted run sees."""

    def __init__(self, num):
        self.num = num
        self._rgb = np.random.default_rng(0).integers(0, 256, size=(num, 16, 16, 3), dtype=np.uint8)
        self._rew = np.zeros(num, np.float32)

    def observe(self):
        return self._rew.copy(), {"rgb": self._rgb.copy()}, np.zeros(self.num, bool)

    def act(self, ac):
        self._rew = (np.asarray(ac) % 3 == 0).astype(np.float32)


def test_learn_killed_and_resumed_equals_an_uninterrupted_run(tmp_path):
    config = tppg.PPGConfig(num_envs=2, segment_length=6, minibatches=2, n_pi=2, aux_epochs=1, aux_minibatches=2,
                            ppo_epochs=1, vf_epochs=2, lr=1e-3)
    kw = dict(config=config, seed=3, venv_fn=lambda seed: _StatelessVenv(2), device="cpu")
    whole, whole_hist = tppg.learn(None, total_iterations=4, **kw)
    ckpt = str(tmp_path / "ppg")
    _, first = tppg.learn(None, total_iterations=2, checkpoint_dir=ckpt, save_every=1, **kw)  # killed here
    resumed, hist = tppg.learn(None, total_iterations=4, checkpoint_dir=ckpt, save_every=1, **kw)
    assert [r["iteration"] for r in hist] == [0, 1, 2, 3] and hist[:2] == first
    assert hist == whole_hist
    for (n, a), (_, b) in zip(resumed.params, whole.params):
        assert torch.equal(a, b), n
    assert resumed.opt_state.count == whole.opt_state.count > 0 and resumed.step == whole.step
    assert any(k.startswith("vf_") for k in hist[-1]) and "kl" in hist[1]


def test_learn_runs_with_aux_phase_and_records_jax_keys():
    def env_fn():
        return FakeProcgen("coinrun", {"episode_length": 12, "image_size": 16, "grid": 3})

    config = tppg.PPGConfig(num_envs=3, segment_length=8, n_pi=1, aux_epochs=1, minibatches=2, lr=1e-3)
    _, history = tppg.learn(env_fn, config, total_iterations=1, seed=0, device="cpu")

    def jenv_fn():
        return JFakeProcgen("coinrun", {"episode_length": 12, "image_size": 16, "grid": 3})

    _, jhist = jppg.learn(jenv_fn, jppg.PPGConfig(**vars(config)), total_iterations=1, seed=0)
    assert [set(r) for r in history] == [set(r) for r in jhist] and "kl" in history[0]
    assert all(np.isfinite(v) for r in history for v in r.values())


def test_learn_refuses_a_mesh():
    """A mesh outside the process group it was built in (several processes are ported:
    tests/test_torch_parallel_trainers.py)."""
    with pytest.raises(RuntimeError, match="process group"):
        tppg.learn(None, mesh=object(), device="cpu")
