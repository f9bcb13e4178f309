"""The port's rollout eval (train/common.py::build_test_step, resolve_goal_eval_data), the trainer's
eval with its best checkpoint, and the eval CLI, against the JAX package's.

  * the reward engine build_test_step builds for each flag combination is the JAX package's choice
    (tests/test_trainer_e2e.py::test_build_test_step_selects_clip_ft_engine): the clip_ft engine on the
    adapter of ``--vl_checkpoint``, an ``.npz`` spec, base CLIP (with a warning for clip_ft without a
    checkpoint), none with a warning when no CLIP checkpoint exists; None for ``*_cached`` towers;
  * build_test_step end to end (a tiny ARPDT through the bridge, an ``.npz`` engine spec written by the
    JAX package) gives JAX's metrics, sequential and in waves of parallel envs;
  * the trainer with ``--eval_env=fake`` evaluates, keeps ``best.pt`` on the eval return and logs
    ``best_eval_score``; the eval CLI in a subprocess evaluates what it wrote;
  * temperature sampling is deterministic under one seed and goes through ``sample_action``."""

import ast
import json
import logging
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from arp_tpu.ops.augment import make_eval_transform as j_eval_transform
from arp_tpu.testing import make_tiny_clip_engine
from arp_tpu.train import common as jcommon
from arp_tpu_torch.config import Config
from arp_tpu_torch.ops.augment import make_eval_transform as t_eval_transform
from arp_tpu_torch.train import common as tcommon
from arp_tpu_torch.train import eval as teval
from arp_tpu_torch.train import main as tmain
from test_torch_policy import base_config, make_batch, run_pair
from test_trainer_e2e import make_labeled_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def eval_flags(**over):
    flags = Config(
        model=dict(transfer_type="none"), episode_length=5, env_eval_env_type="none", env_distribution_mode="hard",
        env_num_levels=500, env_start_level=0, env_hidden_goal=False, eval_env="fake", game_name="coinrun",
        use_vl=True, vl_type="clip", vl_checkpoint="", use_crop=True, reward_bf16=False, num_test_episodes=3,
        window_size=3, return_to_go=0.0, eval_data_path="", eval_data_name="", eval_with_goal=False,
        eval_instruct="", eval_parallel_envs=0, eval_temperature=0.0, eval_goal_shift=0,
        data=dict(inst_type="none", use_normalize=False, num_frames=4, path="."),
    )
    for key, value in over.items():
        node, *path = key.split(".")
        if path:
            flags[node][path[0]] = value
        else:
            flags[key] = value
    return flags


class DS:
    """The dataset's part build_test_step reads."""

    return_to_go = 30.0
    scale = 10.0
    reward_min = 0.0

    def tokenizer(self, text):
        return np.zeros(8, np.int32), np.ones(8, np.float32)


# --- the engine choice -----------------------------------------------------------------------------


class Spy:
    """Stands in for an engine class: notes how it was built."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def __call__(self, *args, **kwargs):
        self.log.append((self.name, args, kwargs))
        return SimpleNamespace()

    def from_npz(self, path, **kwargs):
        self.log.append((self.name + ".from_npz", (path,), kwargs))
        return SimpleNamespace()


def _dtype_name(v):
    return str(v).rsplit(".", 1)[-1].removesuffix("'>") if not isinstance(v, (str, int, float, bool)) else v


def _spied_choices(monkeypatch, flags):
    """(JAX's engine construction, the port's), each as (class, args, kwargs with dtypes by name)."""
    import arp_tpu.finetune.reward as jft
    import arp_tpu.reward.engine as jeng
    import arp_tpu_torch.finetune.reward as tft
    import arp_tpu_torch.reward.engine as teng

    logs = {"jax": [], "torch": []}
    for side, eng, ft in (("jax", jeng, jft), ("torch", teng, tft)):
        monkeypatch.setattr(eng, "ClipRewardEngine", Spy(logs[side], "ClipRewardEngine"))
        monkeypatch.setattr(ft, "ClipFtRewardEngine", Spy(logs[side], "ClipFtRewardEngine"))
        monkeypatch.setattr(ft, "load_adapter_params", lambda p: {"loaded_from": p})

    class M:  # the JAX side builds a jitted apply it never calls here
        def apply(self, *a, **k):
            return None

        greedy_action = sample_action = apply

    assert callable(jcommon.build_test_step(flags, M(), DS(), lambda x: x, use_text=False))
    assert callable(tcommon.build_test_step(flags, None, DS(), lambda x: x, use_text=False, device="cpu"))
    out = []
    for side in ("jax", "torch"):
        kw = [(name, args, {k: _dtype_name(v) for k, v in kwargs.items() if k != "device"}) for name, args, kwargs
              in logs[side]]
        out.append(kw)
    return out


@pytest.mark.parametrize("case", ["clip_ft_checkpoint", "npz_spec", "npz_spec_bf16", "default", "clip_ft_fallback"])
def test_engine_choice_is_jax_s(monkeypatch, tmp_path, caplog, case):
    ckpt = {"clip_ft_checkpoint": str(tmp_path / "adapter"), "npz_spec": "tower.npz", "npz_spec_bf16": "tower.npz"}
    flags = eval_flags(vl_type="clip_ft" if case.startswith("clip_ft") else "clip", vl_checkpoint=ckpt.get(case, ""),
                       reward_bf16=case.endswith("bf16"))
    with caplog.at_level(logging.WARNING, logger="arp_tpu_torch.train.common"):
        jax_built, port_built = _spied_choices(monkeypatch, flags)
    assert port_built == jax_built and len(port_built) == 1
    name = port_built[0][0]
    assert name == {"clip_ft_checkpoint": "ClipFtRewardEngine", "npz_spec": "ClipRewardEngine.from_npz",
                    "npz_spec_bf16": "ClipRewardEngine.from_npz"}.get(case, "ClipRewardEngine")
    assert port_built[0][2]["use_crop"] is False  # the rollout crops on the host, once
    assert ("fall back to base CLIP" in caplog.text) == (case == "clip_ft_fallback")


def test_no_clip_checkpoint_means_no_engine_with_a_warning(monkeypatch, tmp_path, caplog):
    """Without a CLIP checkpoint both packages warn and evaluate with a constant rtg."""
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.delenv("ARP_TPU_ALLOW_DOWNLOAD", raising=False)  # the JAX loader's opt-in fetch stays off
    flags = eval_flags()
    captured = []
    real = tcommon.build_reward_engine
    monkeypatch.setattr(tcommon, "build_reward_engine", lambda *a, **k: captured.append(real(*a, **k)) or captured[-1])
    with caplog.at_level(logging.WARNING):
        assert callable(tcommon.build_test_step(flags, None, DS(), lambda x: x, use_text=False, device="cpu"))
    assert captured[0][0] is None and captured[0][1] is not None
    assert "rtg stays constant" in caplog.text
    with pytest.raises(FileNotFoundError):  # what JAX's engine raises there too, before it warns
        from arp_tpu.models.clip.model import load_model_vars

        load_model_vars("vit_b16", download_dir=str(tmp_path))


def test_cached_towers_missing_instructions_and_the_default_device(caplog, monkeypatch):
    flags = eval_flags(**{"model.transfer_type": "m3ae_vit_b16_cached"})
    with caplog.at_level(logging.WARNING):
        assert tcommon.build_test_step(flags, None, DS(), None, use_text=False, device="cpu") is None
    assert jcommon.build_test_step(flags, None, DS(), None, use_text=False) is None
    assert "rollout eval disabled" in caplog.text
    # an engine but no instruction for the game: JAX's error with its guidance
    import arp_tpu.reward.engine as jeng
    import arp_tpu_torch.reward.engine as teng

    for eng in (jeng, teng):
        monkeypatch.setattr(eng, "ClipRewardEngine", lambda **kw: SimpleNamespace())
    flags = eval_flags(game_name="no_such_game")
    with pytest.raises(ValueError, match="eval_instruct"):
        jcommon.build_test_step(flags, None, DS(), None, use_text=False)
    with pytest.raises(ValueError, match="eval_instruct"):
        tcommon.build_reward_engine(flags, device="cpu")
    # the default device is the card: without one, asking for it raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcommon.build_test_step(eval_flags(use_vl=False), None, DS(), None, use_text=False)


@pytest.mark.parametrize("case", ["explicit_train_file", "explicit_plain_data_file", "explicit_name", "derived", "none"])
def test_resolve_goal_eval_data_is_jax_s(tmp_path, case):
    d = tmp_path / "eval"
    d.mkdir()
    (d / ("data.hdf5" if case == "explicit_plain_data_file" else "data_train.hdf5")).write_bytes(b"")
    over = {"explicit_train_file": dict(eval_data_path=str(d)), "explicit_plain_data_file": dict(eval_data_path=str(d)),
            "explicit_name": dict(eval_data_path=str(d), eval_data_name="x.hdf5"),
            "derived": dict(eval_with_goal=True, num_test_episodes=7, **{"data.path": str(tmp_path)}),
            "none": {}}[case]
    flags = eval_flags(**over)
    assert tcommon.resolve_goal_eval_data(flags) == jcommon.resolve_goal_eval_data(flags)


# --- build_test_step end to end against JAX --------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny ARPDT in both packages (one set of weights) and an engine spec written by the JAX package."""
    _, _, (jmodel, params, tmodel) = run_pair("ARPDT", base_config(), make_batch(1))
    spec = str(tmp_path_factory.mktemp("spec") / "tower.npz")
    make_tiny_clip_engine(batch_size=8).save_npz(spec)
    return jmodel, params, tmodel, spec


@pytest.mark.parametrize("parallel", [0, 2], ids=["sequential", "parallel_waves"])
def test_build_test_step_gives_jax_s_metrics(tiny, parallel):
    """3 episodes of FakeProcgen (64 px, resized to the policy's 32): one env after another, or waves of 2
    and 1 lockstep envs; host crop on, rewards from the .npz spec on both sides."""
    jmodel, params, tmodel, spec = tiny
    flags = eval_flags(vl_checkpoint=spec, eval_parallel_envs=parallel)
    jstep = jcommon.build_test_step(flags, jmodel, DS(), j_eval_transform(32), use_text=False)
    tstep = tcommon.build_test_step(flags, tmodel, DS(), t_eval_transform(32, device="cpu"), False, device="cpu")
    (jm, jinfo, jvid), (tm, tinfo, tvid) = jstep(SimpleNamespace(params=params), jax.random.PRNGKey(0)), tstep(None, 0)
    assert {k: float(v) for k, v in tm.items()} == {k: float(v) for k, v in jm.items()}
    assert tinfo["episode_len"] == jinfo["episode_len"] and len(tvid) == len(jvid)
    if parallel:
        empty = tcommon.build_test_step(eval_flags(vl_checkpoint=spec, eval_parallel_envs=2, num_test_episodes=0),
                                        tmodel, DS(), t_eval_transform(32, device="cpu"), False, device="cpu")
        assert all(np.isnan(v) for v in empty(None, 0)[0].values())


def test_temperature_sampling_is_seeded_and_goes_through_sample_action(tiny, monkeypatch):
    """JAX folds a call counter into its key; the port seeds a torch.Generator by (seed, call): the same seed
    draws the same actions, another seed others, every draw through sample_action with the temperature."""
    _, _, tmodel, spec = tiny
    draws = []
    real = type(tmodel).sample_action

    def spy(self, batch, generator, temperature=1.0):
        out = real(self, batch, generator, temperature)
        draws.append((temperature, generator.initial_seed(), out.tolist()))
        return out

    monkeypatch.setattr(type(tmodel), "sample_action", spy)
    monkeypatch.setattr(type(tmodel), "greedy_action", lambda *a, **k: pytest.fail("greedy under a temperature"))
    flags = eval_flags(vl_checkpoint=spec, eval_temperature=0.7, eval_parallel_envs=3, episode_length=8)
    step = tcommon.build_test_step(flags, tmodel, DS(), t_eval_transform(32, device="cpu"), False, device="cpu")
    runs = []
    for seed in (5, 5, 6):
        draws.clear()
        step(None, seed)
        runs.append(list(draws))
    assert runs[0] == runs[1] and len(runs[0]) > 1
    assert {t for t, _, _ in runs[0]} == {0.7}
    assert [s for _, s, _ in runs[0]] == [tcommon.eval_generator(5, i, "cpu").initial_seed() for i in range(len(runs[0]))]
    assert [a for _, _, a in runs[2]] != [a for _, _, a in runs[0]]


# --- the trainer's eval and the eval CLI -----------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory, tiny):
    """Two epochs of the trainer CLI with a fake-env rollout eval every epoch and --checkpoint_dir."""
    root = tmp_path_factory.mktemp("eval_e2e")
    demos = str(root / "demos")
    make_labeled_dataset(demos)
    common = ["--device=cpu", "--batch_size=8", "--window_size=4", "--use_vl=True",
              "--vl_type=clip", f"--vl_checkpoint={tiny[3]}", "--use_crop=False", "--game_name=coinrun",
              "--eval_env=fake", "--num_test_episodes=2", "--episode_length=4", "--model.model_type=vit_debug",
              "--model.transfer_type=none", "--model.emb_dim=32", "--model.depth=2", "--model.num_heads=4",
              f"--data.path={demos}", "--data.image_size=32", "--data.num_frames=8", "--data.window_size=4",
              "--data.num_demonstrations=20", "--data.use_vl=True"]
    ckpt, out = str(root / "ckpt"), str(root / "out")
    tmain.main(common + ["--epochs=2", "--dataloader_n_workers=0", "--warmup_epochs=0", "--lr=1e-3", "--lr_schedule=fixed", "--log_freq=2",
                         "--val_every_epochs=0", "--test_every_epochs=1", f"--checkpoint_dir={ckpt}",
                         f"--logging.output_dir={out}"])
    run = os.path.join(out, os.listdir(out)[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return SimpleNamespace(common=common, ckpt=ckpt, records=records, root=root)


def test_trainer_evaluates_and_keeps_the_best_checkpoint(trained):
    tests = [r for r in trained.records if "test/return" in r]
    assert [r["step"] for r in tests] == [6, 11]  # every epoch of 6 steps, and the last step
    assert all({"test/episode_length", "test/success_rate"} <= set(r) for r in tests)
    best = max(r["test/return"] for r in tests)
    assert trained.records[-1]["best_eval_score"] == best
    with open(os.path.join(trained.ckpt, "best.json")) as f:
        saved = json.load(f)
    assert saved["score"] == best and saved["step"] in (7, 12)
    state = torch.load(os.path.join(trained.ckpt, "best.pt"), weights_only=True)
    assert state["score"] == best and set(state) >= {"step", "state", "optimizer", "metadata"}


def test_eval_cli_in_a_subprocess_evaluates_the_trainer_s_checkpoint(trained, capsys):
    argv = trained.common + [f"--checkpoint_dir={trained.ckpt}", f"--logging.output_dir={trained.root / 'eval_out'}",
                             "--eval_parallel_envs=2"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "arp_tpu_torch.train.eval", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "restored step 12" in proc.stderr
    got = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert set(got) == {"return", "episode_length", "success_rate"} and all(np.isfinite(v) for v in got.values())
    teval.main(argv)  # in-process on the same checkpoint: the same numbers
    assert ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1]) == got
    with pytest.raises(FileNotFoundError, match="x.pkl"):  # the flag reads a reference pickle now
        teval.main(argv + ["--load_checkpoint=x.pkl"])


def test_eval_cli_frozen_int8_takes_the_training_run_s_scales(tmp_path, monkeypatch):
    """--model.frozen_int8: the trainer saves its calibration scales beside the checkpoints; the eval CLI
    builds its pack from them, as the JAX eval CLI does, and calibrates only when they are absent."""
    import chip_smoke
    from arp_tpu_torch.models import policy
    from arp_tpu_torch.models.m3ae import export_reference_m3ae_params

    built = []  # whether each pack came from saved scales
    real_build = policy.build_frozen_qpack
    monkeypatch.setattr(policy, "build_frozen_qpack",
                        lambda *a, **kw: built.append(kw.get("amax") is not None) or real_build(*a, **kw))
    dims = dict(emb_dim=32, depth=2, num_heads=4, mlp_ratio=2)
    towers = tmp_path / "towers"
    towers.mkdir()
    with open(towers / "m3ae_base_params.pkl", "wb") as f:  # the reference's pickle, as the JAX package reads it
        pickle.dump(export_reference_m3ae_params(chip_smoke.random_m3ae_variables(dims, 8, 30522, seed=1)), f)
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(towers))
    demos = str(tmp_path / "demos")
    make_labeled_dataset(demos, n=24)
    common = ["--device=cpu", "--window_size=2", "--use_vl=False", "--vl_type=clip", "--model.model_type=vit_debug",
              "--model.emb_dim=32", "--model.depth=1", "--model.num_heads=4", "--model.transfer_type=m3ae_vit_b16",
              "--model.frozen_int8=True", "--model.use_adapter=True", "--patch_dim=8", "--encode_image_size=32",
              *(f"--model.m3ae.{k}={v}" for k, v in dict(model_type="custom", **dims).items()),
              f"--data.path={demos}", "--data.image_size=32", "--data.num_frames=8", "--data.window_size=2",
              "--data.num_demonstrations=20", "--eval_env=fake", "--episode_length=3", "--num_test_episodes=1",
              f"--checkpoint_dir={tmp_path / 'ckpt'}"]
    tmain.main(common + ["--epochs=1", "--batch_size=8", "--dataloader_n_workers=0", "--val_every_epochs=0",
                         "--test_every_epochs=0", f"--logging.output_dir={tmp_path / 'o1'}"])
    teval.main(common + [f"--logging.output_dir={tmp_path / 'o2'}"])
    assert built == [False, True]
