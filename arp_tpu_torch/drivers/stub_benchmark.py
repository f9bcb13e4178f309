"""Method-ordering benchmark on the stub engine, through the port's CLIs.

The port of the JAX package's ``scripts/stub_benchmark.py``.  The reference's paper protocol
(README.md:36-43) needs the real Procgen engine and pretrained weights; what can be run here is the
method's ordering claims, end to end through the pipeline's CLIs, with a reward model that
correlates with progress:

  * **reward split** (visible goal, mixed-quality demos): ARPDT, the CLIP-reward-conditioned decision
    transformer, must beat BC.  The demos mix expert, anti-expert and random episodes; greedy BC
    imitates the mixture while ARPDT conditioned on a high return-to-go decodes the expert mode.  The
    return signal comes from a tiny CLIP *trained* (regressed onto progress) on the demo frames, then
    used by the labeler and, at eval, by the online reward engine (``--vl_checkpoint <spec>.npz``).
  * **goal split** (hidden goal): GCBC must beat BC.  ``FakeProcgen`` with ``hidden_goal=True`` draws
    no goal block, so only GCBC's hindsight goal frame carries the target.

Every method trains the same from-scratch tiny-M3AE policy on the same budget; only the
conditioning differs.  Every stage runs the port's own code: ``collect/recorder.py``'s
``TrajectoryRecorder``, ``reward/labeler.py``'s ``label_rewards``, ``python -m
arp_tpu_torch.train.main`` and ``arp_tpu_torch.train.eval`` (lockstep waves, the same initial states
restored from a shared goal-eval dataset).

    python -m arp_tpu_torch.drivers.stub_benchmark --output ./stub_results --seeds 0,1,2
    python -m arp_tpu_torch.drivers.stub_benchmark --smoke --device cpu   # wiring check, minutes

``--stage {collect,clip,label,train,eval,report}`` reruns one stage from the artifacts of the earlier
ones under ``--output``.  ``--device {cuda,cpu}`` (cuda unless cpu is asked for) is where the tiny
CLIP trains, the labeling engine runs and the train / eval CLIs run; collection is host code.

What differs from the JAX script, on purpose (ADVICE.md's three findings on it, fixed here rather
than copied):

  * an ordering claim compares two methods on the seeds both were evaluated on (results.json's
    ``ordering_seeds``), never on unmatched subsets of a truncated matrix, where a method's mean over
    three seeds would be set against another's over one;
  * ``RUN_ORDER`` must hold exactly the (split, method) pairs of ``SPLITS`` (:func:`check_run_order`,
    at import): a method added to ``SPLITS`` alone would never train, and the report would wait
    for it forever;
  * ``TRAIN_DONE`` holds a hash of the training command's flags (:func:`flags_fingerprint`), and a
    marker whose hash differs counts as not done: an output directory that holds checkpoints
    trained under other flags trains them again instead of evaluating stale ones.

And ``--device`` takes cuda or cpu (the JAX script's cpu or tpu); the children run with
``PYTHONPATH`` set to the repository and the JAX package's environment variables dropped; a probe
runs at most the configuration's ``episodes`` (``PROBE_EPISODES`` otherwise), so that the smoke
configuration's six goal-eval episodes hold its probes.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_JAX_VARIABLE_PREFIXES = ("JAX_", "XLA_", "TPU_", "LIBTPU")

GRID = 8
IMG = 32
EP_LEN = 24  # the expert's worst case is 2 * (GRID - 1) = 14 steps
MAX_EP = 30  # the recorder's keep bound (failed episodes end at EP_LEN < this)

# the two splits; the game names only label the datasets and instructions (the same dynamics)
SPLITS = {
    "reward": dict(game="coinrun", hidden_goal=False, methods=("arpdt", "bc", "gcbc")),
    "goal": dict(game="maze", hidden_goal=True, methods=("bc", "gcbc")),
}

FULL = dict(train_eps=150, val_eps=30, eval_eps=110, clip_steps=2500, clip_batch=128, epochs=15, batch_size=64,
            episodes=100, parallel_envs=10)
SMOKE = dict(train_eps=16, val_eps=6, eval_eps=6, clip_steps=80, clip_batch=32, epochs=2, batch_size=8, episodes=4,
             parallel_envs=2)

# The reward model regresses (progress - REWARD_BASE): without a baseline longer episodes out-accumulate
# shorter ones whatever their quality; with it, wandering below the baseline accumulates negative return.
# REWARD_BASE sits above the uniform-start mean progress (0.625 on an 8 x 8 grid).  (The JAX script's
# comments give the pilot measurements behind these choices.)
REWARD_BASE = 0.7

# The reward model's tower (an engine spec is self-contained, so it may differ from TINY_CLIP_CFG).
REWARD_CLIP_CFG = dict(
    embed_dim=64, vocab_size=97, vision_num_layers=3, vision_features=128,
    vision_patch_size=8, text_features=64, text_num_heads=4, text_num_layers=2,
)

# Train / eval order: both ordering claims complete earliest; (reward, gcbc) is in neither, so it runs last.
RUN_ORDER = (("reward", "arpdt"), ("reward", "bc"), ("goal", "bc"), ("goal", "gcbc"), ("reward", "gcbc"))

# Eval decode: seeded temperature sampling (greedy decode on shared initial states makes collapsed
# policies bit-identical across methods and seeds); the probes run fewer episodes.
EVAL_TEMPERATURE = 0.7
PROBE_EPISODES = 60
GOAL_SHIFT = 7  # goal-swap probe: episode ep gets episode ep + 7's goal
RTG_PROBE_ORDER = ("anti", "zero", "expert_p90", "expert_2x")


def check_run_order(splits: dict, run_order) -> None:
    """Raise unless ``run_order`` holds exactly the (split, method) pairs of ``splits``, once each."""
    pairs = {(split, method) for split, sc in splits.items() for method in sc["methods"]}
    if set(run_order) != pairs or len(run_order) != len(pairs):
        raise ValueError(f"RUN_ORDER {sorted(run_order)} does not hold the (split, method) pairs of SPLITS "
                         f"{sorted(pairs)} once each")


check_run_order(SPLITS, RUN_ORDER)


def stage_env() -> dict:
    """The CLIs' environment: the repository first on ``PYTHONPATH``, the JAX package's variables dropped."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(_JAX_VARIABLE_PREFIXES)}
    env["PYTHONPATH"] = os.pathsep.join([REPO_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


# -- stage: collect ------------------------------------------------------------


def make_policy(env, kind: str, rng, eps: float = 0.1):
    """State-based acting policies (a pixel expert cannot see a hidden goal)."""

    def act(_obs):
        if kind == "random" or rng.random() < eps:
            return int(rng.integers(0, 4))
        s = env.get_state()
        d = np.asarray(s["goal"]) - np.asarray(s["agent"])
        if kind == "anti":
            d = -d
        if abs(d[1]) >= abs(d[0]) and d[1] != 0:
            return 1 if d[1] > 0 else 0
        if d[0] != 0:
            return 3 if d[0] > 0 else 2
        return int(rng.integers(0, 4))

    return act


def manhattan_progress(state):
    s = np.asarray(state["agent"]), np.asarray(state["goal"])
    dist = float(np.abs(s[0] - s[1]).sum())
    return 1.0 - dist / (2.0 * (GRID - 1))


def collect_file(path, game, hidden_goal, schedule, seed0, success_filter, progress_path=None):
    """Collect ``schedule`` (a list of (kind, eps)) episodes into one HDF5 file through the recorder;
    optionally save each row's progress."""
    from ..collect.recorder import TrajectoryRecorder
    from ..envs.fake import FakeProcgen

    env = FakeProcgen(game, {"episode_length": EP_LEN, "image_size": IMG, "grid": GRID, "hidden_goal": hidden_goal,
                             "record_video": False})
    rec = TrajectoryRecorder(path, game_name=game, num_frames=8, max_episode_length=MAX_EP)
    rng = np.random.default_rng(seed0)
    progress_rows, kinds = [], []
    attempt = 0
    for kind, eps in schedule:
        while True:  # with success_filter, retry until one episode is kept
            obs = env.reset(seed0 + attempt)
            attempt += 1
            policy = make_policy(env, kind, rng, eps)
            rec.begin_episode(obs, env.get_state())
            ep_progress = [manhattan_progress(env.get_state())]
            done = False
            while not done:
                a = policy(obs)
                obs, r, done, _ = env.step(a)
                rec.record_step(obs, a, r, done, env.get_state())
                ep_progress.append(manhattan_progress(env.get_state()))
            if rec.end_episode(success_filter=success_filter):
                # the recorder keeps frames[:T] (T actions): the first T entries
                progress_rows.extend(ep_progress[: len(ep_progress) - 1])
                kinds.append(kind)
                break
    if progress_path is not None:
        np.savez(progress_path, progress=np.asarray(progress_rows, np.float32), kinds=np.asarray(kinds))
    return rec.num_recorded, kinds


def dataset_dir(root, game, n):
    from ..data.procgen_dataset import dataset_dirname

    return os.path.join(root, dataset_dirname(game, num_demonstrations=n, num_frames=8, env_type="none"))


def stage_collect(out, cfg):
    n_tr, n_val, n_ev = cfg["train_eps"], cfg["val_eps"], cfg["eval_eps"]

    def mixture(n):
        # 40% expert / 40% anti-expert / 20% random: no behaviour mode holds a plurality at a state,
        # so greedy BC cannot recover the expert from counts alone
        n_e, n_a = int(n * 0.4), int(n * 0.4)
        return [("expert", 0.1)] * n_e + [("anti", 0.1)] * n_a + [("random", 0.0)] * (n - n_e - n_a)

    for split, sc in SPLITS.items():
        ddir = dataset_dir(os.path.join(out, f"demos_{split}"), sc["game"], n_tr)
        os.makedirs(ddir, exist_ok=True)
        expert_only = split == "goal"
        for part, n, seed in (("train", n_tr, 0), ("val", n_val, 50_000)):
            sched = [("expert", 0.1)] * n if expert_only else mixture(n)
            kept, _ = collect_file(os.path.join(ddir, f"data_{part}.hdf5"), sc["game"], sc["hidden_goal"], sched, seed,
                                   success_filter=expert_only,
                                   progress_path=os.path.join(ddir, f"progress_{part}.npz"))
            print(f"[collect] {split}/{part}: {kept} episodes -> {ddir}")
        # the held-out goal-eval dataset: expert episodes with their states; every method is evaluated
        # from these initial states (set_state)
        edir = os.path.join(out, f"eval_{split}")
        os.makedirs(edir, exist_ok=True)
        kept, _ = collect_file(os.path.join(edir, "data_train.hdf5"), sc["game"], sc["hidden_goal"],
                               [("expert", 0.05)] * n_ev, 10_000, success_filter=True)
        print(f"[collect] {split}/eval-goals: {kept} episodes -> {edir}")


# -- stage: clip (train the tiny reward model) ---------------------------------


def clip_texts(game: str) -> list:
    """The instruction (the regression's positive text) and three distractors (regressed onto 0)."""
    from ..data.instructions import get_clip_instruct, get_clip_special_instruct

    return [get_clip_instruct(game), get_clip_special_instruct(game, "misinfo"),
            get_clip_special_instruct(game, "random1"), "the agent wanders without reaching the coin."]


def init_reward_clip_variables(seed: int) -> dict:
    """REWARD_CLIP_CFG's tower at IMG px in the Flax variable layout, drawn from a numpy seed: Dense
    kernels ~ N(0, 1 / fan_in), zero biases, unit LayerNorms, small embeddings, logit_scale log(1 / 0.07)."""
    cfg = REWARD_CLIP_CFG
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def dense(n_in, n_out, bias=True):
        d = {"kernel": normal((n_in, n_out), n_in ** -0.5)}
        if bias:
            d["bias"] = np.zeros(n_out, np.float32)
        return d

    def layer_norm(f):
        return {"scale": np.ones(f, np.float32), "bias": np.zeros(f, np.float32)}

    def transformer(f, layers):
        return {f"resblocks.{i}": {"ln_1": layer_norm(f),
                                   "attn": {k: dense(f, f) for k in ("query", "key", "value", "out")},
                                   "ln_2": layer_norm(f), "mlp": {"c_fc": dense(f, 4 * f), "c_proj": dense(4 * f, f)}}
                for i in range(layers)}

    fv, p, ft, e = cfg["vision_features"], cfg["vision_patch_size"], cfg["text_features"], cfg["embed_dim"]
    visual = {"conv1": dense(p * p * 3, fv, bias=False), "class_embedding": normal((fv,), fv ** -0.5),
              "positional_embedding": normal(((IMG // p) ** 2 + 1, fv), fv ** -0.5), "ln_pre": layer_norm(fv),
              "transformer": transformer(fv, cfg["vision_num_layers"]), "ln_post": layer_norm(fv),
              "proj": dense(fv, e, bias=False)}
    text = {"token_embedding": {"embedding": normal((cfg["vocab_size"], ft), 0.02)},
            "positional_embedding": normal((77, ft), 0.01), "transformer": transformer(ft, cfg["text_num_layers"]),
            "ln_final": layer_norm(ft), "text_projection": dense(ft, e, bias=False)}
    return {"params": {"visual": visual, "text": text, "logit_scale": np.asarray(np.log(1 / 0.07), np.float32)}}


def reward_clip_model(variables: dict):
    """The port's CLIP of REWARD_CLIP_CFG at IMG px, holding ``variables`` (the Flax layout), on the CPU."""
    from ..models.clip import CLIP, flax_to_torch

    model = CLIP(**REWARD_CLIP_CFG, image_size=IMG)
    model.load_state_dict(flax_to_torch(variables))
    return model


def clip_loss(model, frames, prog, ids):
    """The regression's loss on a batch: uint8 frames (B, IMG, IMG, 3), float32 progress (B,), token ids
    (n_texts, 77); weight 1 on the instruction, 1 / (n_texts - 1) on each distractor."""
    import torch

    from ..ops.preprocess import clip_preprocess

    img_f = model.encode_image(clip_preprocess(frames, image_size=IMG))
    txt_f = model.encode_text(ids)
    cos = img_f @ txt_f.T  # (B, n_texts)
    n = ids.shape[0]
    target = torch.cat([(prog - REWARD_BASE)[:, None], torch.zeros(prog.shape[0], n - 1, device=prog.device)], 1)
    w = torch.tensor([1.0] + [1.0 / (n - 1)] * (n - 1), device=prog.device)
    return torch.mean(w * (cos - target) ** 2)


def clip_gradients(model, frames, prog, ids):
    """(loss, the gradient of every parameter of ``model``, in ``model.parameters()``'s order; zeros where
    the loss does not read a parameter, logit_scale's, as JAX's gradient gives them)."""
    import torch

    params = list(model.parameters())
    loss = clip_loss(model, frames, prog, ids)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def clip_optimizer(model, steps: int):
    """``optax.adam(optax.cosine_decay_schedule(1e-3, steps))`` over ``model.parameters()``: the port's
    optax-exact AdamW without decay or clipping; returns (optimizer, its initial state)."""
    from ..train.common import AdamW, cosine_decay_schedule

    params = list(model.parameters())
    opt = AdamW(cosine_decay_schedule(1e-3, steps), 0.0, [False] * len(params), clip=None)
    return opt, opt.init([p.detach() for p in params])


def clip_step(model, opt, opt_state, frames, prog, ids):
    """One Adam step of the regression; returns (the new optimizer state, the loss before the step)."""
    loss, grads = clip_gradients(model, frames, prog, ids)
    return opt.update([p.detach() for p in model.parameters()], grads, opt_state), loss


def train_tiny_clip(out, cfg, seed=0, device="cuda"):
    """Regress cosine(frame, instruction) onto progress-to-goal (and onto 0 for the distractor texts) on
    the reward split's demo frames, through the preprocessing the engine applies when it labels and
    evaluates; write the engine spec and the held-out statistics."""
    import h5py
    import torch

    from ..device import resolve_device
    from ..models.clip.tokenizer import Char97Tokenizer
    from ..reward.engine import ClipRewardEngine

    device = resolve_device(device)
    game = SPLITS["reward"]["game"]
    ddir = dataset_dir(os.path.join(out, "demos_reward"), game, cfg["train_eps"])

    def load(part):
        with h5py.File(os.path.join(ddir, f"data_{part}.hdf5"), "r") as f:
            frames = f["ob"][:, -1]  # row t's last stacked frame = obs_t
        prog = np.load(os.path.join(ddir, f"progress_{part}.npz"))["progress"]
        assert len(frames) == len(prog), (len(frames), len(prog))
        return frames, prog

    frames, prog = load("train")
    vframes, vprog = load("val")
    tok = Char97Tokenizer()
    texts = clip_texts(game)
    ids = torch.from_numpy(tok(texts).astype(np.int64)).to(device)
    model = reward_clip_model(init_reward_clip_variables(seed)).to(device)
    opt, opt_state = clip_optimizer(model, cfg["clip_steps"])
    drng = np.random.default_rng(seed)
    loss = None
    for i in range(cfg["clip_steps"]):
        sel = drng.integers(0, len(frames), size=cfg["clip_batch"])
        opt_state, loss = clip_step(model, opt, opt_state, torch.from_numpy(frames[sel]).to(device),
                                    torch.from_numpy(prog[sel]).to(device), ids)
        if i % 250 == 0:
            print(f"[clip] step {i}: loss {float(loss):.4f}")

    # reward magnitude: the stock OpenAI towers ship exp(logit_scale) = 100, which keeps the labeled
    # return-to-go inside the dataset's coinrun `max // 100 * 100` convention
    with torch.no_grad():
        model.logit_scale.fill_(float(np.float32(np.log(100.0))))
    engine = ClipRewardEngine(model=model, batch_size=256, image_size=IMG, tokenizer=tok, device=device)
    spec = os.path.join(out, "reward_clip.npz")
    engine.save_npz(spec)

    # the held-out correlation: the point of training the reward model
    r = engine.text_rewards(vframes, texts[0])
    corr = float(np.corrcoef(r, vprog)[0, 1])
    corr_t = float(np.corrcoef(r, vprog - REWARD_BASE)[0, 1])
    r_neg = engine.text_rewards(vframes, texts[1])
    stats = {"val_pearson_progress": corr, "val_pearson_target": corr_t, "reward_base": REWARD_BASE,
             "val_reward_mean_pos": float(r.mean()), "val_reward_mean_distractor": float(r_neg.mean()),
             "final_loss": float(loss)}
    print(f"[clip] held-out pearson(reward, progress) = {corr:.3f}; {stats}")
    with open(os.path.join(out, "clip_stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    return spec, stats


# -- stage: label ---------------------------------------------------------------


def stage_label(out, cfg, device="cuda"):
    from ..data.instructions import get_clip_instruct
    from ..reward.engine import ClipRewardEngine
    from ..reward.labeler import label_rewards

    engine = ClipRewardEngine.from_npz(os.path.join(out, "reward_clip.npz"), batch_size=256, device=device)
    for split, sc in SPLITS.items():
        ddir = dataset_dir(os.path.join(out, f"demos_{split}"), sc["game"], cfg["train_eps"])
        for part in ("train", "val"):
            label_rewards(os.path.join(ddir, f"data_{part}.hdf5"), get_clip_instruct(sc["game"]), engine=engine,
                          progress=False)
        print(f"[label] {split}: train+val labeled ({sc['game']})")
    sep = separation_report(out, cfg)
    with open(os.path.join(out, "label_separation.json"), "w") as f:
        json.dump(sep, f, indent=1)


def separation_report(out, cfg):
    """Labeled-return statistics by demo kind on the reward split: the discrimination that the
    return-conditioned method depends on, saved so that a failed ordering is attributable."""
    import h5py

    game = SPLITS["reward"]["game"]
    ddir = dataset_dir(os.path.join(out, "demos_reward"), game, cfg["train_eps"])
    with h5py.File(os.path.join(ddir, "data_train.hdf5"), "r") as f:
        done = f["done"][:, -1]
        r = f["ob_clip_reward"][:, -1]
    kinds = np.load(os.path.join(ddir, "progress_train.npz"), allow_pickle=True)["kinds"]
    bounds = np.concatenate([[0], np.nonzero(done)[0] + 1])
    rets = np.array([r[a:b].sum() for a, b in zip(bounds[:-1], bounds[1:])])
    sep = {}
    for k in dict.fromkeys(kinds.tolist()):
        sel = kinds == k
        sep[k] = {"n": int(sel.sum()), "return_mean": float(rets[sel].mean()), "return_std": float(rets[sel].std())}
        print(f"[label] separation {k:7s}: return {sep[k]['return_mean']:8.1f} ± {sep[k]['return_std']:.1f} "
              f"(n={sep[k]['n']})")
    if {"expert", "anti"} <= sep.keys():
        ok = sep["expert"]["return_mean"] > sep["anti"]["return_mean"]
        sep["expert_gt_anti"] = bool(ok)
        print(f"[label] expert > anti labeled return: {ok}")
    # the return-conditioned method's eval target: an expert-level return (the 90th percentile of the
    # expert episodes), not the noisy dataset maximum
    sep["expert_return_p90"] = float(np.percentile(rets[kinds == "expert"], 90))
    return sep


# -- stages: train / eval --------------------------------------------------------


def method_flags(method, spec):
    if method == "arpdt":
        # lambda_return_pred 0.1: on this mixed-quality set the return-prediction loss would otherwise
        # out-weigh the action loss about 6:1
        return ["--use_vl=True", "--vl_type=clip", "--data.use_vl=True", "--data.vl_type=clip",
                f"--vl_checkpoint={spec}", "--model.lambda_return_pred=0.1"]
    if method == "gcbc":
        return ["--use_vl=False", "--vl_type=GCBC", "--data.use_vl=False"]
    return ["--use_vl=False", "--vl_type=clip", "--data.use_vl=False"]


def common_flags(split, cfg, out, seed):
    sc = SPLITS[split]
    data_root = os.path.join(out, f"demos_{split}")
    # window 1 removes the action-history leak of window 4 (the JAX script's notes, docs/STUB_BENCHMARK.md)
    w = cfg.get("window", 4)
    return [
        f"--seed={seed}",
        # un-augmented at the native 32 px: the reference augmentations crop the goal out of this grid
        # and recolour the state's colour coding
        "--data.augmentations=", f"--encode_image_size={IMG}",
        f"--game_name={sc['game']}", f"--window_size={w}", "--use_crop=False",
        f"--episode_length={EP_LEN}", "--eval_env=fake",
        f"--env_hidden_goal={sc['hidden_goal']}",
        # the same from-scratch tiny-M3AE policy for every method
        "--model.model_type=vit_debug", "--model.transfer_type=m3ae_vit_b16",
        "--model.use_from_scratch=True",
        "--model.m3ae.model_type=custom", "--model.m3ae.emb_dim=32",
        "--model.m3ae.dec_emb_dim=16", "--model.m3ae.depth=2",
        "--model.m3ae.dec_depth=1", "--model.m3ae.num_heads=4",
        "--model.m3ae.dec_num_heads=4", "--model.m3ae.mlp_ratio=2",
        "--model.emb_dim=32", "--model.depth=2", "--model.num_heads=4",
        "--model.mlp_ratio=2", "--model.num_ensembles=2",
        f"--data.path={data_root}", f"--data.image_size={IMG}",
        "--data.num_frames=8", f"--data.window_size={w}",
        f"--data.num_demonstrations={cfg['train_eps']}",
    ]


def run(cmd, env, log_path, retries: int = 2):
    """Run one CLI; retry on failure (a flake must not kill a multi-hour seed matrix)."""
    for attempt in range(retries + 1):
        with open(log_path, "w") as log:
            proc = subprocess.run(cmd, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
        if proc.returncode == 0:
            return
        with open(log_path) as f:
            tail = f.read()[-4000:]
        if attempt < retries:
            print(f"[retry {attempt + 1}/{retries}] rc={proc.returncode}: {' '.join(cmd[:4])}...", flush=True)
            continue
        raise RuntimeError(f"failed (rc={proc.returncode}): {' '.join(cmd)}\n{tail}")


def checkpoint_dir(out, split, method, seed):
    return os.path.join(out, f"ckpt_{split}_{method}_s{seed}")


def train_cmd(out, cfg, split, method, seed, device="cuda"):
    spec = os.path.abspath(os.path.join(out, "reward_clip.npz"))
    return ([sys.executable, "-m", "arp_tpu_torch.train.main",
             f"--epochs={cfg['epochs']}", "--warmup_epochs=0",
             f"--batch_size={cfg['batch_size']}", "--lr=1e-3",
             "--dataloader_n_workers=0", "--val_every_epochs=0",
             f"--test_every_epochs={cfg['epochs']}",
             "--num_test_episodes=0",
             f"--checkpoint_dir={checkpoint_dir(out, split, method, seed)}",
             f"--logging.output_dir={os.path.join(out, 'logs')}"]
            + common_flags(split, cfg, out, seed) + method_flags(method, spec) + [f"--device={device}"])


def flags_fingerprint(cmd) -> str:
    """The sha256 of a training command's module and flags (the interpreter's path aside)."""
    return hashlib.sha256(json.dumps(list(cmd[1:])).encode()).hexdigest()


def train_done(ckpt: str, cmd) -> bool:
    """Whether ``ckpt``'s TRAIN_DONE marker names this command's flags."""
    marker = os.path.join(ckpt, "TRAIN_DONE")
    if not os.path.exists(marker):
        return False
    with open(marker) as f:
        return f.read().strip() == flags_fingerprint(cmd)


def stage_train(out, cfg, seeds, device="cuda"):
    env = stage_env()
    for split, method in RUN_ORDER:
        for seed in seeds:
            ckpt = checkpoint_dir(out, split, method, seed)
            cmd = train_cmd(out, cfg, split, method, seed, device)
            if train_done(ckpt, cmd):
                print(f"[train] {split}/{method} seed={seed}: done, skipping", flush=True)
                continue
            print(f"[train] {split}/{method} seed={seed}", flush=True)
            run(cmd, env, os.path.join(out, f"train_{split}_{method}_s{seed}.log"))
            with open(os.path.join(ckpt, "TRAIN_DONE"), "w") as f:
                f.write(flags_fingerprint(cmd) + "\n")


def _read_json(path, default):
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


def eval_variants(split, method, sep):
    """(name, extra flags, episodes) of the eval runs of a (split, method): ``primary`` feeds the ordering
    table, ``greedy`` records the reference's argmax protocol, ``rtg_*`` / ``goalswap`` probe whether the
    policy reads its conditioning token (a flat rtg curve or no goal-swap drop says it does not)."""
    variants = [("primary", [f"--eval_temperature={EVAL_TEMPERATURE}"], None), ("greedy", [], None)]
    if method == "arpdt" and sep:
        p90 = sep["expert_return_p90"]
        targets = {"anti": sep.get("anti", {}).get("return_mean", -500.0), "zero": 0.0, "expert_p90": p90,
                   "expert_2x": 2.0 * p90}
        for name, rtg in targets.items():
            variants.append((f"rtg_{name}", [f"--eval_temperature={EVAL_TEMPERATURE}", f"--return_to_go={rtg}"],
                             PROBE_EPISODES))
    if method == "gcbc":
        variants.append(("goalswap", [f"--eval_temperature={EVAL_TEMPERATURE}", f"--eval_goal_shift={GOAL_SHIFT}"],
                         PROBE_EPISODES))
    return variants


def stage_eval(out, cfg, seeds, device="cuda"):
    env = stage_env()
    spec = os.path.abspath(os.path.join(out, "reward_clip.npz"))
    sep = _read_json(os.path.join(out, "label_separation.json"), {})
    expert_rtg = sep.get("expert_return_p90")
    results = {}
    not_ready = 0
    for split, method in RUN_ORDER:
        eval_dir = os.path.abspath(os.path.join(out, f"eval_{split}"))
        for seed in seeds:
            for variant, extra, episodes in eval_variants(split, method, sep):
                key = f"{split}/{method}/s{seed}/{variant}"
                per_run = os.path.join(out, f"eval_{split}_{method}_s{seed}_{variant}.json")
                if os.path.exists(per_run):  # resume: already measured
                    with open(per_run) as f:
                        results[key] = json.load(f)
                    print(f"[eval] {key}: done, skipping", flush=True)
                    continue
                ckpt = checkpoint_dir(out, split, method, seed)
                if not train_done(ckpt, train_cmd(out, cfg, split, method, seed, device)):
                    # a follow-behind worker: the checkpoint is still training (or was trained under other
                    # flags); skip now and fail the pass at the end, so that the worker retries
                    not_ready += 1
                    continue
                log = os.path.join(out, f"eval_{split}_{method}_s{seed}_{variant}.log")
                cmd = ([sys.executable, "-m", "arp_tpu_torch.train.eval",
                        f"--checkpoint_dir={ckpt}",
                        f"--num_test_episodes={min(episodes or cfg['episodes'], cfg['episodes'])}",
                        f"--eval_parallel_envs={cfg['parallel_envs']}",
                        # shared held-out initial states and goal frames: every method restores the same episodes
                        f"--eval_data_path={eval_dir}",
                        "--eval_data_name=data_train.hdf5",
                        f"--logging.output_dir={os.path.join(out, 'logs')}"]
                       + common_flags(split, cfg, out, seed) + method_flags(method, spec) + extra
                       + [f"--device={device}"])
                if (method == "arpdt" and expert_rtg is not None
                        and not any(a.startswith("--return_to_go") for a in extra)):
                    cmd.append(f"--return_to_go={expert_rtg}")  # an expert-level return (separation_report)
                print(f"[eval] {key}", flush=True)
                run(cmd, env, log)
                with open(log) as f:
                    lines = [line for line in f.read().splitlines() if line.startswith("{")]
                results[key] = ast.literal_eval(lines[-1])
                with open(per_run, "w") as f:
                    json.dump(results[key], f, indent=1)
    with open(os.path.join(out, "eval_raw.json"), "w") as f:
        json.dump(results, f, indent=1)
    if not_ready:
        raise RuntimeError(f"{not_ready} eval runs skipped (checkpoints still training); partial eval_raw.json "
                           "written — retry the eval stage")
    return results


# -- stage: report ---------------------------------------------------------------


def stage_report(out, seeds, window=None):
    with open(os.path.join(out, "eval_raw.json")) as f:
        raw = json.load(f)
    clip_stats = _read_json(os.path.join(out, "clip_stats.json"), {})
    sep = _read_json(os.path.join(out, "label_separation.json"), {})

    def sr(split, method, seed, variant):
        return raw[f"{split}/{method}/s{seed}/{variant}"]["success_rate"]

    # a truncated matrix still reports: each method aggregates the seeds whose primary and greedy
    # sidecars exist and records which they were
    table = {}
    missing = []
    for split, sc in SPLITS.items():
        table[split] = {}
        for method in sc["methods"]:
            avail = [s for s in seeds
                     if f"{split}/{method}/s{s}/primary" in raw and f"{split}/{method}/s{s}/greedy" in raw]
            missing += [f"{split}/{method}/s{s}" for s in seeds if s not in avail]
            if not avail:
                table[split][method] = None
                continue
            vals = {v: [sr(split, method, s, v) for s in avail] for v in ("primary", "greedy")}
            ret = [raw[f"{split}/{method}/s{s}/primary"]["return"] for s in avail]
            table[split][method] = {
                "success_rate_mean": float(np.mean(vals["primary"])),
                "success_rate_std": float(np.std(vals["primary"])),
                "return_mean": float(np.mean(ret)),
                "per_seed_success": [float(x) for x in vals["primary"]],
                "greedy_success_mean": float(np.mean(vals["greedy"])),
                "seeds_evaluated": list(avail),
            }

    # conditioning-sensitivity probes: does the policy read its conditioning token
    probes = {}
    if "arpdt" in SPLITS["reward"]["methods"]:
        curves = []
        for s in seeds:
            curve = {name: float(sr("reward", "arpdt", s, f"rtg_{name}")) for name in RTG_PROBE_ORDER
                     if f"reward/arpdt/s{s}/rtg_{name}" in raw}
            if curve:
                curves.append(curve)
        mean_curve = {name: float(np.mean([c[name] for c in curves])) for name in RTG_PROBE_ORDER
                      if curves and all(name in c for c in curves)}
        vals = [mean_curve[n] for n in RTG_PROBE_ORDER if n in mean_curve]
        probes["rtg_monotonicity"] = {
            "targets": {n: (sep.get(n, {}).get("return_mean") if n == "anti" else 0.0 if n == "zero" else
                            sep.get("expert_return_p90", 0.0) * (2.0 if n == "expert_2x" else 1.0))
                        for n in mean_curve},
            "mean_curve": mean_curve,
            "per_seed": curves,
            # the paper's mechanism: success rises with the conditioning target up to the expert level
            "responds": bool(len(vals) >= 2 and vals[-2] > vals[0]),
            "monotone_pairs": (float(np.mean([vals[i + 1] >= vals[i] for i in range(len(vals) - 1)]))
                               if len(vals) > 1 else None),
        }
    goalswap = {}
    for split, sc in SPLITS.items():
        if "gcbc" not in sc["methods"]:
            continue
        drops = [float(sr(split, "gcbc", s, "primary")) - float(raw[f"{split}/gcbc/s{s}/goalswap"]["success_rate"])
                 for s in seeds if f"{split}/gcbc/s{s}/goalswap" in raw and f"{split}/gcbc/s{s}/primary" in raw]
        if drops:
            # a goal-reading policy loses success when fed a mismatched goal frame
            goalswap[split] = {"true_minus_swapped_mean": float(np.mean(drops)), "per_seed": drops,
                               "reads_goal": bool(np.mean(drops) > 0)}
    if goalswap:
        probes["goal_swap"] = goalswap

    def claim(split, a, b):
        """(a > b on mean sampled success over the seeds both were evaluated on, those seeds); (None, [])
        until some seed has both."""
        ra, rb = table.get(split, {}).get(a), table.get(split, {}).get(b)
        if ra is None or rb is None:
            return None, []
        both = [s for s in ra["seeds_evaluated"] if s in rb["seeds_evaluated"]]
        if not both:
            return None, []
        mean = lambda m: float(np.mean([sr(split, m, s, "primary") for s in both]))  # noqa: E731
        return bool(mean(a) > mean(b)), both

    claims = {"reward_split_arpdt_gt_bc": claim("reward", "arpdt", "bc"),
              "goal_split_gcbc_gt_bc": claim("goal", "gcbc", "bc")}
    results = {"table": table, "ordering": {k: v for k, (v, _) in claims.items()},
               "ordering_seeds": {k: s for k, (_, s) in claims.items()}, "probes": probes,
               "clip": clip_stats, "seeds": list(seeds), "partial": bool(missing), "missing_runs": missing,
               "config": {"grid": GRID, "image": IMG, "episode_length": EP_LEN, "window": window,
                          "eval_temperature": EVAL_TEMPERATURE, "episodes": FULL["episodes"]}}
    with open(os.path.join(out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(render_results_markdown(results))
    print(f"results written to {os.path.join(out, 'results.json')}")
    return results


def render_results_markdown(results):
    """The results table, generated from results.json (so a document that holds it cannot drift)."""
    seeds = results["seeds"]
    lines = ["| Split | Method | Success (sampled T=%.1f) | Greedy | Return | Seeds |"
             % results["config"].get("eval_temperature", 0.0),
             "|---|---|---|---|---|---|"]
    for split, methods in results["table"].items():
        for m, r in methods.items():
            if r is None:
                lines.append(f"| {split} | {m} | (not yet evaluated) | — | — | 0 |")
                continue
            n = len(r.get("seeds_evaluated", seeds))
            lines.append(f"| {split} | {m} | {r['success_rate_mean']:.3f} ± {r['success_rate_std']:.3f} "
                         f"| {r.get('greedy_success_mean', float('nan')):.3f} | {r['return_mean']:.2f} | {n} |")
    o, on = results["ordering"], results.get("ordering_seeds", {})

    def fmt(key):
        if o[key] is None:
            return "pending"
        matched = on.get(key, seeds)
        note = "" if list(matched) == list(seeds) else f" (partial: on seeds {', '.join(map(str, matched))} only)"
        return f"**{o[key]}**{note}"

    lines.append("")
    if results.get("partial"):
        lines.append(f"**PARTIAL matrix** — {len(results['missing_runs'])} runs not yet evaluated: "
                     + ", ".join(results["missing_runs"]) + ".")
    lines.append(f"Ordering (each on the seeds both methods were evaluated on): reward-split ARPDT > BC = "
                 f"{fmt('reward_split_arpdt_gt_bc')}, goal-split GCBC > BC = {fmt('goal_split_gcbc_gt_bc')}.")
    p = results.get("probes", {})
    if "rtg_monotonicity" in p:
        curve = " → ".join(f"{k}:{v:.3f}" for k, v in p["rtg_monotonicity"]["mean_curve"].items())
        lines.append(f"ARPDT rtg-conditioning curve (mean success): {curve} "
                     f"(responds: **{p['rtg_monotonicity']['responds']}**).")
    for split, g in p.get("goal_swap", {}).items():
        lines.append(f"GCBC goal-swap drop ({split} split): {g['true_minus_swapped_mean']:+.3f} "
                     f"(reads goal: **{g['reads_goal']}**).")
    return "\n".join(lines)


def write_docs_table(results, docs_path):
    """Put the generated table between the RESULTS_TABLE markers of ``docs_path``."""
    begin, end = "<!-- RESULTS_TABLE -->", "<!-- /RESULTS_TABLE -->"
    with open(docs_path) as f:
        text = f.read()
    if begin not in text:
        raise SystemExit(f"{docs_path} has no {begin} marker")
    if end not in text:  # a single marker: make it a region
        text = text.replace(begin, begin + "\n" + end)
    head, rest = text.split(begin, 1)
    _, tail = rest.split(end, 1)
    with open(docs_path, "w") as f:
        f.write(head + begin + "\n" + render_results_markdown(results) + "\n" + end + tail)
    print(f"[report] wrote results table into {docs_path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--output", default="./stub_results")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--stage", default="all", choices=["all", "collect", "clip", "label", "train", "eval", "report"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tiny CLIP trains, the labeling engine and the train / eval CLIs run "
                        "(collection is host code)")
    p.add_argument("--window", type=int, default=None,
                   help="policy window_size (default: the config's; 1 is the clean return-conditioning test, "
                        "4 the reference default)")
    p.add_argument("--data_from", default=None,
                   help="reuse the collect / clip / label artifacts of another --output directory (symlinked)")
    p.add_argument("--write_docs", default=None,
                   help="after report: put the generated results table into this markdown file's "
                        "RESULTS_TABLE region")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)

    cfg = dict(SMOKE if args.smoke else FULL)
    if args.window is not None:
        cfg["window"] = args.window
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.smoke:
        seeds = seeds[:1]
    out = os.path.abspath(args.output)
    os.makedirs(out, exist_ok=True)

    stages = [args.stage] if args.stage != "all" else ["collect", "clip", "label", "train", "eval", "report"]
    if args.data_from:
        src = os.path.abspath(args.data_from)
        for name in ("demos_reward", "demos_goal", "eval_reward", "eval_goal", "reward_clip.npz", "clip_stats.json",
                     "label_separation.json"):
            dst = os.path.join(out, name)
            if not os.path.exists(dst):
                os.symlink(os.path.join(src, name), dst)
        stages = [s for s in stages if s not in ("collect", "clip", "label")]
        print(f"[data_from] linked artifacts from {src}; stages = {stages}")
    for st in stages:
        if st == "collect":
            stage_collect(out, cfg)
        elif st == "clip":
            train_tiny_clip(out, cfg, device=args.device)
        elif st == "label":
            stage_label(out, cfg, device=args.device)
        elif st == "train":
            stage_train(out, cfg, seeds, device=args.device)
        elif st == "eval":
            stage_eval(out, cfg, seeds, device=args.device)
        elif st == "report":
            results = stage_report(out, seeds, window=cfg.get("window"))
            if args.write_docs:
                write_docs_table(results, args.write_docs)


if __name__ == "__main__":
    main()
