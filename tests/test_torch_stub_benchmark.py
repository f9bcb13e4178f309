"""arp_tpu_torch.drivers.stub_benchmark: the method-ordering benchmark on the port (the counterpart of
tests/test_stub_benchmark_resume.py, and the port's own checks).

* The JAX script's five resume tests against the port's copy, its ``run`` monkeypatched (no CLI runs):
  TRAIN_DONE markers, per-run eval sidecars, the follow-behind eval, a partial matrix, the report.
* ADVICE.md's three findings, fixed in the port: ordering claims on matched seeds, RUN_ORDER against
  SPLITS, TRAIN_DONE carrying the flags' hash.
* The collect stage writes what the JAX script's writes, byte for byte.
* One tiny-CLIP step from a Flax init carried across, against the JAX script's step: loss within 1e-5
  relative, gradients within 1e-4 of the largest, params after Adam within 2e-5 outside the entries whose
  gradient is under 1e-4 of the largest (Adam's first step moves an entry by +-lr on its gradient's sign).
* The engine spec both ways: the port's ``.npz`` read by JAX's ``ClipRewardEngine.from_npz`` and JAX's by
  the port's, rewards within 1e-4.
"""

import importlib.util
import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arp_tpu.models.clip import CLIP as JCLIP
from arp_tpu.ops.preprocess import clip_preprocess as jclip_preprocess
from arp_tpu.reward.engine import ClipRewardEngine as JEngine
from arp_tpu_torch.drivers import stub_benchmark as sb
from arp_tpu_torch.models.clip.convert import _flatten, torch_to_flax
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.reward.engine import ClipRewardEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_REL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 2e-5
MAE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_stub_benchmark", os.path.join(REPO, "scripts",
                                                                                     "stub_benchmark.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _matrix(seeds):
    return [(split, method, seed) for split, method in sb.RUN_ORDER for seed in seeds]


def _mark_trained(out, split, method, seed, cfg=sb.SMOKE):
    ckpt = os.path.join(out, f"ckpt_{split}_{method}_s{seed}")
    os.makedirs(ckpt, exist_ok=True)
    with open(os.path.join(ckpt, "TRAIN_DONE"), "w") as f:
        f.write(sb.flags_fingerprint(sb.train_cmd(str(out), cfg, split, method, seed, "cpu")) + "\n")


# --- the JAX script's resume tests, on the port's copy ----------------------------------------------


def test_stage_train_skips_done_runs(tmp_path, monkeypatch):
    seeds = [0]
    matrix = _matrix(seeds)
    assert len(matrix) == 5  # reward: arpdt / bc / gcbc, goal: bc / gcbc
    for split, method, seed in matrix[:2]:
        _mark_trained(tmp_path, split, method, seed)
    launched = []

    def fake_run(cmd, env, log_path, retries=2):
        ckpt = [a for a in cmd if a.startswith("--checkpoint_dir=")][0]
        launched.append(os.path.basename(ckpt.split("=", 1)[1]))
        assert "--device=cpu" in cmd and cmd[2] == "arp_tpu_torch.train.main"

    monkeypatch.setattr(sb, "run", fake_run)
    for split, method, seed in matrix[2:]:  # the trainer makes its checkpoint directory
        (tmp_path / f"ckpt_{split}_{method}_s{seed}").mkdir()
    sb.stage_train(str(tmp_path), sb.SMOKE, seeds, device="cpu")
    assert launched == [f"ckpt_{s}_{m}_s{d}" for s, m, d in matrix[2:]]
    launched.clear()  # every run now carries its marker: a second pass launches nothing
    sb.stage_train(str(tmp_path), sb.SMOKE, seeds, device="cpu")
    assert launched == []


def _variant_matrix(seeds, sep):
    return [(split, method, seed, variant) for split, method in sb.RUN_ORDER for seed in seeds
            for variant, _, _ in sb.eval_variants(split, method, sep)]


SEP = {"expert_return_p90": 70.0, "anti": {"return_mean": -556.0}, "random": {"return_mean": -203.0}}


def test_stage_eval_resumes_from_sidecars(tmp_path, monkeypatch):
    seeds = [0]
    (tmp_path / "label_separation.json").write_text(json.dumps(SEP))
    matrix = _variant_matrix(seeds, SEP)
    assert ("reward", "arpdt", 0, "primary") in matrix and ("reward", "arpdt", 0, "rtg_anti") in matrix
    assert ("goal", "gcbc", 0, "goalswap") in matrix
    assert len(matrix) == 5 * 2 + 4 + 2  # 5 runs x {primary, greedy} + the rtg sweep + 2 gcbc swaps
    split0, method0, seed0, variant0 = matrix[0]
    done = {"success_rate": 0.75, "return": 1.25}
    (tmp_path / f"eval_{split0}_{method0}_s{seed0}_{variant0}.json").write_text(json.dumps(done))
    launched = []

    def fake_run(cmd, env, log_path, retries=2):
        launched.append(os.path.basename(log_path))
        assert cmd[2] == "arp_tpu_torch.train.eval" and "--device=cpu" in cmd
        assert f"--num_test_episodes={sb.SMOKE['episodes']}" in cmd  # a probe runs at most the config's episodes
        with open(log_path, "w") as f:
            f.write("noise line\n{'success_rate': 0.5, 'return': 0.0}\n")

    monkeypatch.setattr(sb, "run", fake_run)
    for split, method, seed, _ in matrix:
        _mark_trained(tmp_path, split, method, seed)
    results = sb.stage_eval(str(tmp_path), sb.SMOKE, seeds, device="cpu")
    key0 = f"{split0}/{method0}/s{seed0}/{variant0}"
    assert results[key0] == done  # from the sidecar, not run again
    assert f"eval_{split0}_{method0}_s{seed0}_{variant0}.log" not in launched
    assert len(launched) == len(matrix) - 1
    for split, method, seed, variant in matrix[1:]:
        sidecar = tmp_path / f"eval_{split}_{method}_s{seed}_{variant}.json"
        assert json.loads(sidecar.read_text()) == {"success_rate": 0.5, "return": 0.0}
    raw = json.loads((tmp_path / "eval_raw.json").read_text())
    assert set(raw) == {f"{s}/{m}/s{d}/{v}" for s, m, d, v in matrix}


def test_stage_eval_follow_behind_skips_untrained(tmp_path, monkeypatch):
    seeds = [0]
    sep = {"expert_return_p90": 70.0, "anti": {"return_mean": -556.0}}
    (tmp_path / "label_separation.json").write_text(json.dumps(sep))
    runs = list(dict.fromkeys((s, m, d) for s, m, d, _ in _variant_matrix(seeds, sep)))
    _mark_trained(tmp_path, *runs[0])  # only the first (split, method, seed) has finished training
    launched = []

    def fake_run(cmd, env, log_path, retries=2):
        launched.append(os.path.basename(log_path))
        with open(log_path, "w") as f:
            f.write("{'success_rate': 0.5, 'return': 0.0}\n")

    monkeypatch.setattr(sb, "run", fake_run)
    with pytest.raises(RuntimeError, match="still training"):
        sb.stage_eval(str(tmp_path), sb.SMOKE, seeds, device="cpu")
    n_first = len(sb.eval_variants(runs[0][0], runs[0][1], sep))
    assert len(launched) == n_first  # only the trained run's variants
    assert len(json.loads((tmp_path / "eval_raw.json").read_text())) == n_first  # the partial raw exists


def test_stage_report_partial_matrix(tmp_path):
    seeds = [0, 1]
    raw = {f"reward/arpdt/s{s}/{v}": {"success_rate": 0.4, "return": 4.0, "episode_length": 20.0}
           for s in seeds for v in ("primary", "greedy")}
    (tmp_path / "eval_raw.json").write_text(json.dumps(raw))
    results = sb.stage_report(str(tmp_path), seeds, window=1)
    assert results["partial"] is True
    assert results["table"]["reward"]["arpdt"]["seeds_evaluated"] == seeds
    assert results["table"]["reward"]["bc"] is None
    assert results["ordering"] == {"reward_split_arpdt_gt_bc": None, "goal_split_gcbc_gt_bc": None}
    md = sb.render_results_markdown(results)
    assert "PARTIAL matrix" in md and "pending" in md and "(not yet evaluated)" in md


def _full_raw(seeds, sr):
    raw = {}
    for split, sc in sb.SPLITS.items():
        for method in sc["methods"]:
            for s in seeds:
                for variant, _, _ in sb.eval_variants(split, method, SEP):
                    if variant.startswith("rtg_"):
                        v = {"rtg_anti": 0.1, "rtg_zero": 0.2, "rtg_expert_p90": 0.55, "rtg_expert_2x": 0.5}[variant]
                    elif variant == "goalswap":
                        v = 0.1
                    else:
                        v = sr[variant][method]
                    raw[f"{split}/{method}/s{s}/{variant}"] = {"success_rate": v, "return": v * 10,
                                                               "episode_length": 20.0}
    return raw


def test_stage_report_table_probes_and_docs(tmp_path):
    seeds = [0, 1]
    (tmp_path / "label_separation.json").write_text(json.dumps(SEP))
    sr = {"primary": {"arpdt": 0.6, "bc": 0.2, "gcbc": 0.3}, "greedy": {"arpdt": 0.5, "bc": 0.2, "gcbc": 0.25}}
    (tmp_path / "eval_raw.json").write_text(json.dumps(_full_raw(seeds, sr)))
    results = sb.stage_report(str(tmp_path), seeds, window=1)
    assert results["ordering"] == {"reward_split_arpdt_gt_bc": True, "goal_split_gcbc_gt_bc": True}
    assert results["ordering_seeds"] == {"reward_split_arpdt_gt_bc": seeds, "goal_split_gcbc_gt_bc": seeds}
    probe = results["probes"]["rtg_monotonicity"]
    assert probe["responds"] is True and probe["mean_curve"]["anti"] == 0.1
    swap = results["probes"]["goal_swap"]["goal"]
    assert swap["reads_goal"] is True and swap["true_minus_swapped_mean"] > 0
    doc = tmp_path / "DOC.md"
    doc.write_text("# title\n\n<!-- RESULTS_TABLE -->\n\ntail\n")
    sb.write_docs_table(results, str(doc))
    text = doc.read_text()
    assert "| reward | arpdt | 0.600" in text and "tail" in text and "partial" not in text
    assert text.count("<!-- RESULTS_TABLE -->") == 1
    sb.write_docs_table(results, str(doc))  # idempotent: a rerun replaces the region
    assert doc.read_text().count("| reward | arpdt | 0.600") == 1


# --- ADVICE.md's three findings --------------------------------------------------------------------


def test_ordering_is_claimed_on_matched_seeds_only(tmp_path):
    """arpdt evaluated on seeds 0, 1, 2, bc on seed 0 alone: the claim compares seed 0 with seed 0.  Over
    the unmatched subsets (the JAX script's way) arpdt's mean 0.5 beats bc's 0.3; on seed 0 it does not."""
    per_seed = {"arpdt": {0: 0.1, 1: 0.7, 2: 0.7}, "bc": {0: 0.3}}
    raw = {f"reward/{m}/s{s}/{v}": {"success_rate": x, "return": 0.0} for m, d in per_seed.items()
           for s, x in d.items() for v in ("primary", "greedy")}
    (tmp_path / "eval_raw.json").write_text(json.dumps(raw))
    results = sb.stage_report(str(tmp_path), [0, 1, 2], window=1)
    assert results["table"]["reward"]["arpdt"]["success_rate_mean"] == pytest.approx(0.5)
    assert results["ordering"]["reward_split_arpdt_gt_bc"] is False
    assert results["ordering_seeds"]["reward_split_arpdt_gt_bc"] == [0]
    assert results["ordering"]["goal_split_gcbc_gt_bc"] is None
    md = sb.render_results_markdown(results)
    assert "**False** (partial: on seeds 0 only)" in md and "goal-split GCBC > BC = pending" in md


def test_run_order_must_hold_every_pair_of_splits():
    sb.check_run_order(sb.SPLITS, sb.RUN_ORDER)  # the module's own pass (also checked at import)
    grown = dict(sb.SPLITS, goal=dict(sb.SPLITS["goal"], methods=("bc", "gcbc", "arpdt")))
    with pytest.raises(ValueError, match="RUN_ORDER"):
        sb.check_run_order(grown, sb.RUN_ORDER)
    with pytest.raises(ValueError, match="once each"):
        sb.check_run_order(sb.SPLITS, sb.RUN_ORDER + (("goal", "bc"),))


def test_train_done_names_the_flags_it_was_trained_under(tmp_path, monkeypatch):
    """A marker without the hash (the JAX script's "ok"), or one written under other flags, is not done."""
    launched = []
    monkeypatch.setattr(sb, "run", lambda cmd, env, log_path, retries=2: launched.append(cmd))
    split, method = sb.RUN_ORDER[0]
    ckpt = tmp_path / f"ckpt_{split}_{method}_s0"
    ckpt.mkdir()
    (ckpt / "TRAIN_DONE").write_text("ok\n")
    windowed = dict(sb.SMOKE, window=1)
    _mark_trained(tmp_path, *sb.RUN_ORDER[1], 0, cfg=windowed)  # trained at window 1, asked for window 4
    for pair in sb.RUN_ORDER[2:]:
        _mark_trained(tmp_path, *pair, 0)
    sb.stage_train(str(tmp_path), sb.SMOKE, [0], device="cpu")
    assert [c[[a.startswith("--checkpoint_dir") for a in c].index(True)].rsplit("/", 1)[1] for c in launched] == [
        f"ckpt_{s}_{m}_s0" for s, m in sb.RUN_ORDER[:2]]
    cmd = sb.train_cmd(str(tmp_path), sb.SMOKE, split, method, 0, "cpu")
    assert sb.train_done(str(ckpt), cmd) and not sb.train_done(str(ckpt), cmd[:-1] + ["--device=cuda"])
    assert (ckpt / "TRAIN_DONE").read_text().strip() == sb.flags_fingerprint(cmd)
    assert sb.flags_fingerprint(["/another/python"] + cmd[1:]) == sb.flags_fingerprint(cmd)  # the interpreter aside


# --- the collect stage, the tiny CLIP, the engine spec ------------------------------------------------


def test_collect_stage_writes_what_the_jax_script_writes(tmp_path):
    jax_mod = _jax_script()
    cfg = dict(sb.SMOKE, train_eps=5, val_eps=2, eval_eps=2)
    sb.stage_collect(str(tmp_path / "port"), cfg)
    jax_mod.stage_collect(str(tmp_path / "jax"), cfg)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax") for d, _, fs in os.walk(tmp_path / "jax")
                   for f in fs)
    assert len([f for f in files if f.endswith(".hdf5")]) == 6 and any(f.endswith(".npz") for f in files)
    for rel in files:
        port, jax_file = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.endswith(".hdf5"):
            with h5py.File(port, "r") as a, h5py.File(jax_file, "r") as b:
                assert set(a) == set(b), rel
                for key in b:
                    np.testing.assert_array_equal(a[key][:], b[key][:], err_msg=f"{rel}:{key}")
        elif rel.endswith(".npz"):
            a, b = np.load(port), np.load(jax_file)
            for key in b.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{rel}:{key}")
        else:  # a recorded state: an array of dicts of arrays
            got, want = np.load(port, allow_pickle=True), np.load(jax_file, allow_pickle=True)
            assert got.shape == want.shape, rel
            for a, b in zip(got.ravel(), want.ravel()):
                assert set(a) == set(b), rel
                for key in b:
                    np.testing.assert_array_equal(a[key], b[key], err_msg=f"{rel}:{key}")


def _jax_clip_step(variables, frames, prog, ids, steps):
    """The JAX script's step (scripts/stub_benchmark.py, train_tiny_clip), on one batch."""
    model = JCLIP(**sb.REWARD_CLIP_CFG)
    tx = optax.adam(optax.cosine_decay_schedule(1e-3, steps))
    n = ids.shape[0]

    def loss_fn(v):
        img_f, txt_f = model.apply(v, jclip_preprocess(frames, image_size=sb.IMG), ids)
        cos = img_f @ txt_f.T
        target = jnp.concatenate([(prog - sb.REWARD_BASE)[:, None], jnp.zeros((prog.shape[0], n - 1))], 1)
        w = jnp.asarray([1.0] + [1.0 / (n - 1)] * (n - 1))
        return jnp.mean(w * (cos - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(variables)
    updates, _ = tx.update(grads, tx.init(variables))
    return float(loss), grads, optax.apply_updates(variables, updates)


def _flax_leaves(tree):
    return {"/".join(k): np.asarray(v) for k, v in _flatten(jax.tree_util.tree_map(np.asarray, dict(tree))).items()}


def test_tiny_clip_step_matches_the_jax_script_s_step():
    model = JCLIP(**sb.REWARD_CLIP_CFG)
    tok = Char97Tokenizer()
    ids = tok(sb.clip_texts("coinrun"))
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, sb.IMG, sb.IMG, 3), jnp.float32), jnp.asarray(ids[:1])))
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(8, sb.IMG, sb.IMG, 3), dtype=np.uint8)
    prog = rng.uniform(0, 1, size=8).astype(np.float32)
    want_loss, want_grads, want_params = _jax_clip_step(jax.tree_util.tree_map(jnp.asarray, variables),
                                                        jnp.asarray(frames), jnp.asarray(prog), jnp.asarray(ids), 80)

    port = sb.reward_clip_model(variables)
    opt, state = sb.clip_optimizer(port, 80)
    t_frames, t_prog, t_ids = torch.from_numpy(frames), torch.from_numpy(prog), torch.from_numpy(ids.astype(np.int64))
    loss, grads = sb.clip_gradients(port, t_frames, t_prog, t_ids)
    names = [n for n, _ in port.named_parameters()]
    got_grads = _flax_leaves(torch_to_flax(dict(zip(names, grads))))
    state, loss_before = sb.clip_step(port, opt, state, t_frames, t_prog, t_ids)
    assert state.count == 1 and float(loss_before) == float(loss)
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)

    want_grads = _flax_leaves(want_grads)
    assert set(got_grads) == set(want_grads) and len(want_grads) > 40
    largest = max(np.abs(g).max() for g in want_grads.values())
    for path, g in want_grads.items():
        assert np.abs(got_grads[path] - g).max() <= GRAD_REL * largest, path
    got_params, want_params = _flax_leaves(torch_to_flax(port.state_dict())), _flax_leaves(want_params)
    left_out = 0
    for path, p in want_params.items():
        keep = np.abs(want_grads[path]) >= GRAD_REL * largest
        left_out += int((~keep).sum())
        assert np.abs(got_params[path] - p)[keep].max(initial=0.0) <= PARAM_ATOL, path
    assert left_out < sum(p.size for p in want_params.values()) // 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_engine_spec_reads_both_ways(tmp_path, writer):
    frames = np.random.default_rng(5).integers(0, 256, size=(20, sb.IMG, sb.IMG, 3), dtype=np.uint8)
    text = sb.clip_texts("coinrun")[0]
    path = str(tmp_path / "reward_clip.npz")
    if writer == "port":
        model = sb.reward_clip_model(sb.init_reward_clip_variables(1))
        written = ClipRewardEngine(model=model, batch_size=8, image_size=sb.IMG, tokenizer=Char97Tokenizer(),
                                   device="cpu")
        written.save_npz(path)
        read = JEngine.from_npz(path, batch_size=8)
    else:
        from arp_tpu.models.clip.tokenizer import Char97Tokenizer as JTokenizer

        model = JCLIP(**sb.REWARD_CLIP_CFG)
        variables = model.init(jax.random.PRNGKey(2), jnp.zeros((1, sb.IMG, sb.IMG, 3)),
                               jnp.asarray(JTokenizer()([text])))
        written = JEngine(model=model, variables=variables, batch_size=8, image_size=sb.IMG, tokenizer=JTokenizer())
        written.save_npz(path)
        read = ClipRewardEngine.from_npz(path, batch_size=8, device="cpu")
    got, want = read.text_rewards(frames, text), written.text_rewards(frames, text)
    assert got.shape == want.shape == (20,) and np.abs(got - want).mean() <= MAE
    assert read.tokenizer_identity == "char97" and read.image_size == sb.IMG
