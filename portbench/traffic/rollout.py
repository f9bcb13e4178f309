"""Stage 5, the eval rollout: ``build_test_step``'s ``test_step_fn``, run back to back.

Set-up builds the flagship policy (weights drawn on the card from the seed, as the train traffic's) and the
rollout eval as the trainer builds it: ``eval_parallel_envs`` lockstep envs of the port's FakeProcgen, greedy
actions, rewards from the configuration's reward engine (``clip_vit_b16``, its weights drawn from the seed)
on every frame.  The benchmark reaches the engine by standing in for ``train/common.py::build_reward_engine``
while set-up builds the step: the stand-in asks the real one for the eval's instruction and hands back the
engine built on the seed's weights with the options the real one gives a spec (batch 64, Pillow resize, no
crop, float32).  A short eval warms every shape up.  The window runs evals with seeds drawn from ``--seed``
until ``--seconds`` have passed, the last one to its end.

Wrappers from the benchmark around the engine's public calls, the policy's ``greedy_action`` (a forward
hook keeps the logits it chose from) and the envs' ``reset`` and ``step`` note what each step gave; with
``--trace 1`` they also synchronise and time the engine and the policy.  The reference follows the program
step by step: from the frames the envs gave and the actions the program chose, it works out every step's
rewards, the policy's logits on the same windows and the return-to-go trace.
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..reference import arpdt as ref
from ..trace import window_marker
from . import label, train

HERE = Path(__file__).resolve().parent.parent


class _Dataset:
    """What ``build_test_step`` reads of the training dataset: the return-to-go and its scale."""

    def __init__(self, return_to_go: float):
        from arp_tpu_torch.data.procgen_dataset import compute_scale

        self.return_to_go, self.reward_min = return_to_go, 0.0
        self.scale = compute_scale(return_to_go)


class _Recorder:
    """Notes each eval's steps: the frames the engine scored, its rewards, the policy's rtg, logits and
    actions, and which envs were stepped; with ``timed`` also the engine's and the policy's seconds."""

    def __init__(self, model, engine, env_cls, timed: bool):
        self.timed, self.evals = timed, []
        self.seconds = {"reward": 0.0, "policy": 0.0}
        self._undo, self._obs = [], {}
        self._logits = None
        self._hook = model.register_forward_hook(self._note_logits)
        self._wrap(engine, "text_rewards_with_features", "reward", self._note_rewards)
        self._wrap(engine, "encode_text_features", "reward", None)
        self._wrap(model, "greedy_action", "policy", self._note_policy)
        for name, note in (("reset", self._note_reset), ("step", self._note_env_step)):
            real = getattr(env_cls, name)
            setattr(env_cls, name, self._env_wrapper(real, note))
            self._undo.append((env_cls, name, real))

    def _sync(self):
        if self.timed and torch.cuda.is_available():
            torch.cuda.synchronize()

    def _wrap(self, obj, name, field, note):
        real = getattr(obj, name)
        self._undo.append((obj, name, obj.__dict__.get(name)))

        def run(*args, **kwargs):
            self._sync()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            self._sync()
            self.seconds[field] += time.perf_counter() - t0
            if note is not None:
                note(args, out)
            return out

        setattr(obj, name, run)

    @staticmethod
    def _env_wrapper(real, note):
        def run(env, *args, **kwargs):
            out = real(env, *args, **kwargs)
            note(env, out)
            return out

        return run

    def _note_obs(self, env, obs):
        self._obs[id(env)] = np.array(obs["image"]["ob"])

    def _note_logits(self, module, args, output):
        self._logits = output["action_pred"][:, -1].detach().clone()

    def _note_reset(self, env, out):
        if not self.evals or self.evals[-1]["steps"]:
            self.evals.append({"envs": [], "steps": []})
        self.evals[-1]["envs"].append(id(env))
        self._note_obs(env, out)

    def _note_policy(self, args, out):
        batch = args[0]
        ev = self.evals[-1]
        ev["steps"].append({"obs": np.stack([self._obs[e] for e in ev["envs"]]),
                            "rtg": batch["rtg"]["ob"][:, -1, 0].detach().clone(),
                                        "logits": self._logits, "actions": out.detach().clone(), "stepped": {}})

    def _note_rewards(self, args, out):
        step = self.evals[-1]["steps"][-1]
        step["rewards"] = np.array(out, np.float64)

    def _note_env_step(self, env, out):
        self.evals[-1]["steps"][-1]["stepped"][id(env)] = bool(out[2])
        self._note_obs(env, out[0])

    def close(self):
        self._hook.remove()
        for obj, name, before in reversed(self._undo):
            if before is None and not isinstance(obj, type):
                delattr(obj, name)  # the class's method again
            else:
                setattr(obj, name, before)


class Traffic:
    def __init__(self, config: dict, params: dict, seed: int, device, fault: str | None = None):
        from arp_tpu_torch.envs.fake import FakeProcgen
        from arp_tpu_torch.ops.augment import make_eval_transform
        from arp_tpu_torch.reward.engine import ClipRewardEngine
        from arp_tpu_torch.train import common
        from arp_tpu_torch.train.main import flag_defaults

        self.config, self.params, self.seed, self.device = config, params, seed, device
        with open(HERE / "configs" / f"{config['reward_config']}.json") as f:
            self.reward_config = json.load(f)
        clip_model, self.clip_state = label.build_clip(self.reward_config, seed, device)
        fl = train.flags(config, params)
        defaults = flag_defaults()
        defaults["data"].update(fl.data)
        fl.data = defaults["data"]
        defaults.update(fl)
        fl = type(fl)(defaults)
        fl.update(dict(game_name=params["game"], eval_env="fake", window_size=config["window"],
                       episode_length=config["env"]["episode_length"], num_test_episodes=params["envs"],
                       eval_parallel_envs=params["envs"], vl_checkpoint="", device=str(device)))
        self.model, _, self.tower, self.trained = train.build_policy(fl, config, params, seed, device)
        self.model.eval()
        self.engine = ClipRewardEngine(model=clip_model, batch_size=params["engine_batch"], resize_mode="pil",
                                       use_crop=False, device=device)
        if fault == "answer_altered":
            label.alter_one_answer(self.engine)
        real, found = common.build_reward_engine, []

        def stand_in(flags_obj, device="cuda"):
            _, text = real(flags_obj, device)
            found.append(text)
            return self.engine, text

        dataset = _Dataset(params["return_to_go"])
        self.scale, self.rtg0 = dataset.scale, params["return_to_go"] / dataset.scale
        transform = make_eval_transform(image_size=config["image_size"], device=device)
        common.build_reward_engine = stand_in
        try:
            self.step_fn = common.build_test_step(fl, self.model, dataset, transform, False, device=device)
            short = type(fl)(fl)
            short.episode_length = config["window"] + 1
            warm = common.build_test_step(short, self.model, dataset, transform, False, device=device)
        finally:
            common.build_reward_engine = real
        self.text = found[0]
        self.use_crop = bool(fl.use_crop)
        self.env_cls = FakeProcgen
        warm(self.model, seed)  # every window length and the engine's one batch
        self.recorder = None
        self.evals_done = 0

    def window(self, seconds: float, prof=None) -> dict:
        self.recorder = _Recorder(self.model, self.engine, self.env_cls, timed=prof is not None)
        rng = np.random.default_rng([int(self.seed), 9])
        steps = 0
        try:
            with window_marker(prof):
                start = time.perf_counter()
                while time.perf_counter() - start < seconds:
                    self.step_fn(self.model, int(rng.integers(2 ** 31)))
                    steps += len(self.recorder.evals[-1]["steps"]) * self.params["envs"]
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                elapsed = time.perf_counter() - start
        finally:
            self.recorder.close()
        lockstep = sum(len(e["steps"]) for e in self.recorder.evals)
        work = {"reward_ms": 1e3 * self.recorder.seconds["reward"] / lockstep,
                "policy_ms": 1e3 * self.recorder.seconds["policy"] / lockstep} if prof is not None else {}
        return {"metrics": {"rollout_env_steps_per_s": steps / elapsed}, "attempted": len(self.recorder.evals),
                "failed": 0, "work": work}

    def release(self) -> None:
        self.program = self.recorder.evals
        for e in self.program:
            for s in e["steps"]:
                for k in ("rtg", "logits", "actions"):
                    s[k] = s[k].double().cpu().numpy()
        del self.model, self.engine, self.step_fn, self.recorder
        gc.collect()

    def _reference(self, tf32: bool = False) -> list:
        """For each eval, each step's (rewards, logits, rtg) as the reference works them out."""
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return [self._reference_eval(e, tf32) for e in self.program]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before

    @torch.no_grad()
    def _reference_eval(self, ev: dict, tf32: bool) -> list:
        c, n, w = self.config, self.params["envs"], self.config["window"]
        weights = {**self.tower, **self.trained}
        rtg = np.full(n, self.rtg0, np.float32)  # the rollout's rtg is float32, decremented in float32
        done = np.zeros(n, bool)
        embs, rtgs, out = [], [], []
        for t, step in enumerate(ev["steps"]):
            obs = step["obs"]
            frames = obs
            if self.use_crop:  # the rollout scores the center half of each frame
                h, w_ = obs.shape[1] // 2, obs.shape[2] // 2
                top, left = (obs.shape[1] - h) // 2, (obs.shape[2] - w_) // 2
                frames = np.ascontiguousarray(obs[:, top:top + h, left:left + w_])
            rewards = label.reference_rewards(self.clip_state, self.reward_config, frames, self.text, self.device,
                                              tf32)
            x = ref.eval_transform(torch.from_numpy(obs).to(self.device), c["image_size"])
            embs.append(ref.tower(weights, x, c["tower_depth"], c["tower_heads"], c["patch"]))
            rtgs.append(rtg.copy())
            lo = max(0, t - w + 1)
            k = t - lo + 1  # the window's slots: the newest k steps
            emb = torch.stack(embs[-k:], dim=1).reshape(-1, *embs[-1].shape[1:])
            r = torch.from_numpy(np.stack(rtgs[-k:], axis=1)[..., None]).float().to(self.device)
            acts = [ev["steps"][s]["actions"] for s in range(lo, t)] + [np.zeros(n)]
            a = torch.from_numpy(np.stack(acts, axis=1)).long().to(self.device)
            logits, _ = ref.policy(weights, emb, r, a, c)
            out.append((rewards, logits[:, -1].double().cpu().numpy(), rtg.copy()))
            rtg = np.where(done, rtg, rtg - rewards.astype(np.float32) / np.float32(self.scale))
            done = done | np.array([step["stepped"].get(e, True) for e in ev["envs"]])
            embs = embs[-w:]
            rtgs = rtgs[-w:]
        return out

    def _gaps(self, got: list, want: list) -> dict:
        reward = logit = rtg = 0.0
        for ev_got, ev_want in zip(got, want):
            for (r_g, l_g, t_g), (r_w, l_w, t_w) in zip(ev_got, ev_want):
                reward = max(reward, float(np.max(np.abs(r_g - r_w))))
                logit = max(logit, float(np.max(np.abs(l_g - l_w))))
                rtg = max(rtg, float(np.max(np.abs(t_g - t_w))))
        return {"reward_gap": reward, "logit_gap": logit, "rtg_gap": rtg}

    def _program(self) -> list:
        return [[(s["rewards"], s["logits"], s["rtg"]) for s in e["steps"]] for e in self.program]

    def compare(self) -> dict:
        gaps = self._gaps(self._program(), self._reference())
        return {k: (v, self.params["limits"][k]) for k, v in gaps.items()}

    def control(self) -> dict:
        return self._gaps(self._reference(tf32=True), self._reference())
