"""The port's rollouts (arp_tpu_torch/envs/rollout.py) against the JAX package's: batch_rollout and
parallel_rollout on FakeProcgen (32 px, grid 4) with a tiny ARPDT (the same weights through the
bridge, greedy actions) and the tiny CLIP engines of both packages on the same weights.

Every policy call is recorded on both sides: the chosen actions must be equal, the rtg windows
within 1e-5, the action windows equal, the image windows (the eval transform's output; on the port's
side tensors on the device the rollout was given) within 1e-5, and the metrics equal.  Cases: text
rewards, a host-side crop, normalized rewards, goal-conditioned rewards with the engine state
restored from a demo file, the clip_ft engine, the pre-step frame the reward scores, the window
layout (the action slot's 0 placeholder), no episodes at all, and the int8 engines' calibration on
the rollout's first frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.envs import rollout as jroll
from arp_tpu.envs.fake import FakeProcgen as JFake
from arp_tpu.finetune.reward import ClipFtRewardEngine as JFtEngine
from arp_tpu.ops.augment import make_eval_transform as j_eval_transform
from arp_tpu.testing import make_tiny_clip_engine
from arp_tpu_torch.envs import rollout as troll
from arp_tpu_torch.envs.fake import FakeProcgen as TFake
from arp_tpu_torch.finetune.convert import flax_adapter_to_torch
from arp_tpu_torch.finetune.reward import ClipFtRewardEngine
from arp_tpu_torch.ops.augment import make_eval_transform as t_eval_transform
from test_torch_policy import base_config, make_batch, run_pair
from test_torch_reward_engine import _port_engine

RTG_ATOL = 1e-5
EP_LEN, WINDOW, N_ENVS = 6, 3, 3
FAKE = {"episode_length": EP_LEN, "image_size": 32, "grid": 4}
TEXT = "collect the coin."


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def policies():
    """(JAX greedy fn, the port's model): a tiny vit_debug ARPDT with seeded weights through the bridge."""
    _, _, (jmodel, params, tmodel) = run_pair("ARPDT", base_config(), make_batch(1))
    jit_greedy = jax.jit(lambda p, inputs: jmodel.apply({"params": p}, inputs, method=jmodel.greedy_action))
    return (lambda inputs: jit_greedy(params, inputs)), tmodel


@pytest.fixture(scope="module")
def clip_engines():
    jax_engine = make_tiny_clip_engine(batch_size=8)
    return jax_engine, _port_engine(jax_engine)


class Recorder:
    """A policy_fn that notes each call's windows (as numpy) and returns its greedy action."""

    def __init__(self, act):
        self.act, self.calls = act, []

    def __call__(self, inputs, rngs):
        note = {"action": np.array(inputs["action"]), "rtg": np.array(inputs["rtg"]["ob"]),
                "image": np.array(inputs["image"]["ob"])}
        if inputs.get("goal") is not None:
            note["goal"] = np.array(inputs["goal"]["ob"])
        if isinstance(inputs["action"], torch.Tensor):
            note["device"] = {inputs["action"].device.type, inputs["image"]["ob"].device.type,
                              inputs["rtg"]["ob"].device.type}
        out = self.act(inputs)
        note["chosen"] = np.array(out).reshape(-1)
        self.calls.append(note)
        return out


def jax_policy(jgreedy):
    def act(inputs):
        merged = dict(inputs)
        for k in ("instruct", "text_padding_mask"):  # what build_test_step's policy fills in
            merged.setdefault(k, None)
        return jgreedy(jax.tree_util.tree_map(jnp.asarray, merged))
    return Recorder(act)


def port_policy(tmodel):
    def act(inputs):
        with torch.no_grad():
            return tmodel.greedy_action(inputs)
    return Recorder(act)


def assert_same_calls(jrec, trec):
    assert len(jrec.calls) == len(trec.calls) > 0
    for t, (j, p) in enumerate(zip(jrec.calls, trec.calls)):
        np.testing.assert_array_equal(p["chosen"], j["chosen"], err_msg=f"call {t}: actions")
        np.testing.assert_array_equal(p["action"], j["action"], err_msg=f"call {t}: action window")
        assert p["rtg"].dtype == j["rtg"].dtype == np.float32
        np.testing.assert_allclose(p["rtg"], j["rtg"], atol=RTG_ATOL, rtol=0, err_msg=f"call {t}: rtg window")
        np.testing.assert_allclose(p["image"], j["image"], atol=1e-5, rtol=0, err_msg=f"call {t}: image window")
        assert ("goal" in p) == ("goal" in j)
        if "goal" in j:
            np.testing.assert_allclose(p["goal"], j["goal"], atol=1e-5, rtol=0, err_msg=f"call {t}: goal window")
        assert p["device"] == {"cpu"}


def assert_same_metric(jm, tm):
    assert set(jm) == set(tm)
    for k in jm:
        assert np.isnan(jm[k]) == np.isnan(tm[k]) and (np.isnan(jm[k]) or jm[k] == tm[k]), (k, jm[k], tm[k])


def run_both(kind, policies, j_engine, t_engine, n_episodes=2, conf=FAKE, **kw):
    """One rollout of ``kind`` in each package on the same seeds; returns (JAX recorder, port recorder)."""
    jgreedy, tmodel = policies
    jrec, trec = jax_policy(jgreedy), port_policy(tmodel)
    common = dict(episode_length=conf["episode_length"], window_size=WINDOW, return_to_go=30.0, scale=10.0,
                  text=TEXT, **kw)
    if kind == "batch":
        jm = jroll.batch_rollout(rng=jax.random.PRNGKey(0), data_aug_rng=None, env=JFake("coinrun", dict(conf)),
                                 policy_fn=jrec, transform_obs_fn=j_eval_transform(32), num_episodes=n_episodes,
                                 reward_engine=j_engine, **common)
        tm = troll.batch_rollout(rng=0, data_aug_rng=None, env=TFake("coinrun", dict(conf)), policy_fn=trec,
                                 transform_obs_fn=t_eval_transform(32, device="cpu"), num_episodes=n_episodes,
                                 reward_engine=t_engine, device="cpu", **common)
        assert_same_metric(jm[0], tm[0])
        assert len(jm[2]) == len(tm[2])
        for jv, tv in zip(jm[2], tm[2]):
            np.testing.assert_array_equal(jv, tv)
    else:
        jm = jroll.parallel_rollout(rng=jax.random.PRNGKey(0), envs=[JFake("coinrun", dict(conf)) for _ in range(N_ENVS)],
                                    policy_fn=jrec, transform_obs_fn=j_eval_transform(32), reward_engine=j_engine,
                                    **common)
        tm = troll.parallel_rollout(rng=0, envs=[TFake("coinrun", dict(conf)) for _ in range(N_ENVS)], policy_fn=trec,
                                    transform_obs_fn=t_eval_transform(32, device="cpu"), reward_engine=t_engine,
                                    device="cpu", **common)
        assert_same_metric(jm, tm)
    assert_same_calls(jrec, trec)
    return jrec, trec


@pytest.mark.parametrize("kind", ["batch", "parallel"])
@pytest.mark.parametrize("case", ["clip", "use_crop", "use_normalize", "no_engine"])
def test_rollout_with_text_rewards_matches_jax(policies, clip_engines, kind, case):
    kw = {"use_crop": dict(use_crop=True), "use_normalize": dict(use_normalize=True, reward_min={"ob": -2.5}),
          "clip": {}, "no_engine": {}}[case]
    engines = (None, None) if case == "no_engine" else clip_engines
    _, trec = run_both(kind, policies, *engines, **kw)
    rtg_seen = {float(c["rtg"][0, -1, 0]) for c in trec.calls}
    assert (len(rtg_seen) == 1) == (case == "no_engine")  # the rtg moves exactly when an engine scores


def _goal_eval_dir(tmp_path):
    """A goal-eval demo file with the engine states of its trajectories (the JAX collect stage's)."""
    from arp_tpu.collect.recorder import collect_demonstrations

    env = JFake("coinrun", {"episode_length": 20, "image_size": 32, "grid": 4})
    rng = np.random.default_rng(0)
    collect_demonstrations(env, lambda obs: int(rng.integers(0, 4)), str(tmp_path / "data_test.hdf5"),
                           num_episodes=N_ENVS, game_name="coinrun", num_frames=4, seed=0)
    return str(tmp_path)


@pytest.mark.parametrize("kind", ["batch", "parallel"])
def test_goal_conditioned_rollout_with_state_restore_matches_jax(policies, clip_engines, kind, tmp_path):
    """Goal rewards against the trajectories' last frames, each episode started from its saved state;
    batch_rollout reads the file itself, parallel_rollout is given the goals and states and feeds the goals
    to the policy."""
    path = _goal_eval_dir(tmp_path)
    kw = dict(vl_type="clip_goal_conditioned")
    if kind == "batch":
        kw.update(eval_data_path=path, data_name="data_test.hdf5")
        jrec, _ = run_both("batch", policies, *clip_engines, n_episodes=N_ENVS, **kw)
    else:
        f, traj_idx = troll.open_goal_eval(path, "data_test.hdf5", N_ENVS)
        with f:
            pairs = [troll.load_goal_and_state(path, f, traj_idx, ep) for ep in range(N_ENVS)]
        kw.update(goal_images=np.stack([g for g, _ in pairs]), initial_states=[s for _, s in pairs],
                  feed_goal_to_policy=True)
        jrec, _ = run_both("parallel", policies, *clip_engines, **kw)
    assert "goal" in jrec.calls[0]
    with pytest.raises(AssertionError, match="trajectories"):
        troll.open_goal_eval(path, "data_test.hdf5", N_ENVS + 1)  # one more boundary than episodes needed


@pytest.fixture(scope="module")
def ft_engines():
    """The clip_ft engines of both packages on one tiny adapter (the port's through finetune/convert.py)."""
    from arp_tpu.models.clip import model as jclip_model
    from test_finetune import TINY_CFG, TinyAdapter, make_batch as ft_batch, tiny_tokens

    rng = np.random.default_rng(0)
    clip_vars = jclip_model.CLIP(**TINY_CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                                                 jnp.asarray(tiny_tokens(1)))
    model = TinyAdapter(action_dim=15)
    params = model.init({"params": jax.random.PRNGKey(1), "aug": jax.random.PRNGKey(2)}, clip_vars, ft_batch(rng),
                        train=False)["params"]
    kw = dict(batch_size=4, image_size=224, tokenizer=lambda text: tiny_tokens(1), clip_config=TINY_CFG)
    return (JFtEngine(adapter_params=params, clip_variables=clip_vars, adapter=model, **kw),
            ClipFtRewardEngine(adapter_params=flax_adapter_to_torch(jax.tree_util.tree_map(np.asarray, params)),
                               clip_variables=jax.tree_util.tree_map(np.asarray, clip_vars), device="cpu", **kw))


@pytest.mark.parametrize("kind", ["batch", "parallel"])
def test_rollout_with_clip_ft_rewards_matches_jax(policies, ft_engines, kind):
    run_both(kind, policies, *ft_engines, n_episodes=1, vl_type="clip_ft",
             conf=dict(FAKE, episode_length=4))


class StubEngine:
    """Scores nothing; notes the frames each reward call is given."""

    def __init__(self):
        self.frames_seen = []

    def encode_text_features(self, text):
        return np.ones((1, 4), np.float32)

    def text_rewards_with_features(self, frames, txt_feat):
        self.frames_seen.append(np.asarray(frames).copy())
        return np.arange(frames.shape[0], dtype=np.float32)

    def text_rewards(self, frames, text):
        return self.text_rewards_with_features(frames, None)


@pytest.mark.parametrize("kind", ["batch", "parallel"])
def test_rewards_score_the_pre_step_frame_as_jax(policies, kind):
    """Each reward call gets the frame the policy just acted on (the first is the reset frame), the same
    frames as JAX's, and the rtg falls by that call's reward."""
    jstub, tstub = StubEngine(), StubEngine()
    _, trec = run_both(kind, policies, jstub, tstub, n_episodes=1)
    assert len(jstub.frames_seen) == len(tstub.frames_seen) > 1
    for j, t in zip(jstub.frames_seen, tstub.frames_seen):
        np.testing.assert_array_equal(t, j)
    first = [TFake("coinrun", dict(FAKE)).reset(42 + i)["image"]["ob"] for i in range(tstub.frames_seen[0].shape[0])]
    np.testing.assert_array_equal(tstub.frames_seen[0], np.stack(first))
    rtg = trec.calls[1]["rtg"][:, -1, 0]
    np.testing.assert_allclose(rtg, 3.0 - np.arange(rtg.shape[0]) / 10.0, rtol=0, atol=1e-6)


def test_parallel_inputs_match_batch_rollout_inputs(policies):
    """The window layout: the current slot's action is the 0 placeholder while the policy decides, the
    earlier slots pair a_k with obs_k; one env in parallel_rollout sees what batch_rollout feeds."""
    _, tmodel = policies
    seq, par = port_policy(tmodel), port_policy(tmodel)
    conf = dict(FAKE, grid=5)
    common = dict(episode_length=EP_LEN, window_size=WINDOW, return_to_go=10.0, scale=10.0,
                  transform_obs_fn=t_eval_transform(32, device="cpu"), device="cpu")
    troll.batch_rollout(rng=0, data_aug_rng=None, env=TFake("coinrun", dict(conf)), policy_fn=seq, num_episodes=1,
                        **common)
    troll.parallel_rollout(rng=0, envs=[TFake("coinrun", dict(conf))], policy_fn=par, **common)
    assert len(seq.calls) == len(par.calls) > WINDOW
    for t, (s, p) in enumerate(zip(seq.calls, par.calls)):
        for key in ("action", "rtg", "image"):
            np.testing.assert_array_equal(p[key], s[key], err_msg=f"t={t} {key}")
        assert s["action"][0, -1] == 0 and s["action"].shape[1] == min(t + 1, WINDOW)
        if t:
            assert s["action"][0, -2] == seq.calls[t - 1]["chosen"][0]


def test_episode_accounting_and_no_episodes(policies):
    """batch_rollout counts an episode's length only when it ends (done); parallel_rollout counts a timeout as
    episode_length and freezes a finished env's rtg; no episodes give NaN metrics."""
    _, tmodel = policies
    right = lambda inputs, rngs: torch.ones(inputs["action"].shape[0], dtype=torch.long)  # noqa: E731
    conf = dict(FAKE, grid=8, image_size=32, episode_length=3)  # too short to reach any goal
    metric, _, _ = troll.batch_rollout(rng=0, data_aug_rng=None, env=TFake("coinrun", dict(conf)), policy_fn=right,
                                       episode_length=2, window_size=WINDOW, num_episodes=2, device="cpu")
    assert metric["episode_length"] == 0.0 and metric["success_rate"] == 0.0
    metric = troll.parallel_rollout(rng=0, envs=[TFake("coinrun", dict(conf)) for _ in range(2)], policy_fn=right,
                                    episode_length=2, window_size=WINDOW, device="cpu")
    assert metric["episode_length"] == 2.0
    metric, info, videos = troll.batch_rollout(rng=0, data_aug_rng=None, env=TFake("coinrun", dict(conf)),
                                               policy_fn=right, num_episodes=0, device="cpu")
    assert all(np.isnan(v) for v in metric.values()) and videos == []
    jmetric = jroll.batch_rollout(rng=None, data_aug_rng=None, env=JFake("coinrun", dict(conf)), policy_fn=right,
                                  num_episodes=0)[0]
    assert_same_metric(jmetric, metric)


def test_cuda_windows_without_a_gpu_raise():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the windows would go there")
    with pytest.raises(RuntimeError, match="cuda"):
        troll.parallel_rollout(rng=0, envs=[TFake("coinrun", dict(FAKE))], policy_fn=lambda inputs, rngs: None)


@pytest.mark.parametrize("kind", ["batch", "parallel"])
def test_int8_engines_calibrate_on_the_rollout_s_first_frames(policies, clip_engines, kind):
    """A fast_int8 engine calibrates on its first batch: in a rollout that is the first step's frames (one frame,
    sequential; the N reset frames, lockstep), in both packages.  Each engine after the rollout scores as a fresh
    engine of its package calibrated on exactly those frames, and the two packages' engines, calibrated on the same
    frames, agree within the int8 bound of tests/test_torch_fast_engine.py."""
    jax_base, _ = clip_engines
    jeng, teng = make_tiny_clip_engine(batch_size=8, fast_int8=True), _port_engine(jax_base, fast_int8=True)
    jrec, trec = jax_policy(policies[0]), port_policy(policies[1])
    common = dict(episode_length=3, window_size=WINDOW, return_to_go=30.0, scale=10.0, text=TEXT)
    if kind == "batch":
        jroll.batch_rollout(rng=None, data_aug_rng=None, env=JFake("coinrun", dict(FAKE)), policy_fn=jrec,
                            transform_obs_fn=j_eval_transform(32), reward_engine=jeng, num_episodes=1, **common)
        troll.batch_rollout(rng=0, data_aug_rng=None, env=TFake("coinrun", dict(FAKE)), policy_fn=trec,
                            transform_obs_fn=t_eval_transform(32, device="cpu"), reward_engine=teng, num_episodes=1,
                            device="cpu", **common)
        first = TFake("coinrun", dict(FAKE)).reset(42)["image"]["ob"][None]
    else:
        jroll.parallel_rollout(rng=None, envs=[JFake("coinrun", dict(FAKE)) for _ in range(N_ENVS)], policy_fn=jrec,
                               transform_obs_fn=j_eval_transform(32), reward_engine=jeng, **common)
        troll.parallel_rollout(rng=0, envs=[TFake("coinrun", dict(FAKE)) for _ in range(N_ENVS)], policy_fn=trec,
                               transform_obs_fn=t_eval_transform(32, device="cpu"), reward_engine=teng, device="cpu",
                               **common)
        first = np.stack([TFake("coinrun", dict(FAKE)).reset(42 + i)["image"]["ob"] for i in range(N_ENVS)])
    probe = np.random.default_rng(9).integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    fresh_j, fresh_t = make_tiny_clip_engine(batch_size=8, fast_int8=True), _port_engine(jax_base, fast_int8=True)
    fresh_j.text_rewards(first, TEXT), fresh_t.text_rewards(first, TEXT)  # calibrate on the first step's frames
    np.testing.assert_array_equal(teng.text_rewards(probe, TEXT), fresh_t.text_rewards(probe, TEXT))
    np.testing.assert_array_equal(np.asarray(jeng.text_rewards(probe, TEXT)), np.asarray(fresh_j.text_rewards(probe, TEXT)))
    np.testing.assert_allclose(teng.text_rewards(probe, TEXT), np.asarray(jeng.text_rewards(probe, TEXT)),
                               rtol=0.12, atol=0.12)
