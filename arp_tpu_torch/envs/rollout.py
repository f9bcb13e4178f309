"""Evaluation rollouts: host env stepping, the policy and the rewards on the card (port of the JAX
package's ``envs/rollout.py``).

The reference rollout loop (arp_dt/envs/rollout_procgen.py) runs a policy with
batch 1, steps the C++ env on the host and scores each frame with CLIP on the
fly, lowering the return-to-go the policy is conditioned on.  Here, as in the
JAX package:

  * the CLIP reward comes from the port's reward engine (reward/engine.py, or
    the clip_ft engine), the same one that labels;
  * ``batch_rollout`` keeps the reference's sequential semantics (one env, the
    rtg lowered by each step's reward / scale); ``parallel_rollout`` steps N
    env copies in lockstep so that the policy and the reward model see real
    batches.

Placement.  The policy's input windows (images through ``transform_obs_fn``,
rtg, actions) are tensors on ``device`` (the card unless the caller asks for
the CPU), rolled in place, one slot a step: a transformed frame is never
copied back to the host.  The host keeps what the env and the engine need:
the raw uint8 frames, the rewards and the current rtg, which it writes into
the window's newest slot (one small copy a step).  The policy's actions come
to the host once a step, for the envs.  The windows hold the values JAX's
hold: the current frame's action slot is a 0 placeholder while the policy
decides and takes the chosen action after; the rtg is lowered with the
pre-step frame; an env that is done keeps a frozen rtg.

The windows also carry a cache of the frozen tower's outputs (:class:`TowerRing`, one a view, handed to the
policy as ``inputs["tower_cache"]``), rolled with the frames: a policy with a frozen tower sends only the
newest slot of each window through it, and reads the other slots' outputs back.  The cache lives and dies with
one rollout's windows, so weights that change between two evals are never served from an old one.  A policy
that does not know the key ignores it.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..profiling import span
from ..serve import to_host


def _crop_half(frames: np.ndarray) -> np.ndarray:
    """Center-crop to half size (the reference's label_reward.py arithmetic); accepts batched
    (N, H, W, C) or a single (H, W, C) frame."""
    from ..ops.preprocess import center_crop_np

    single = frames.ndim == 3
    x = frames[None] if single else frames
    x = center_crop_np(x, x.shape[1] // 2, x.shape[2] // 2)
    return x[0] if single else x


def compute_step_reward(engine, vl_type: str, obs_image, text=None, goal_image=None, use_crop=False):
    """Per-step reward, same semantics as the reference vl_reward fns."""
    frames = np.asarray(obs_image)[None]
    if use_crop:
        frames = _crop_half(frames)
    if vl_type in ("clip", "clip_ft"):
        return float(engine.text_rewards(frames, text)[0])
    if vl_type in ("clip_goal_conditioned", "clip_ft_goal_conditioned"):
        goal = np.asarray(goal_image)
        if use_crop:
            goal = _crop_half(goal)
        return float(engine.goal_rewards_vs(frames, goal)[0])
    raise ValueError(vl_type)


def open_goal_eval(eval_data_path: str, data_name: str, num_episodes: int):
    """Open a goal-eval demo file and compute trajectory boundaries.

    Shared by batch_rollout and the parallel eval (train/common.py::build_test_step) so
    the boundary/goal conventions cannot diverge.  Returns (h5file, traj_idx);
    the caller closes the file.
    """
    import h5py

    f = h5py.File(os.path.join(eval_data_path, data_name), "r")
    traj_idx = list(np.nonzero(f["done"][:, -1])[0] + 1)
    traj_idx.insert(0, 0)
    # needs one MORE boundary than episodes: episode ep reads traj_idx[ep + 1]
    if len(traj_idx) - 1 < num_episodes:
        f.close()
        raise AssertionError(f"eval file has {len(traj_idx) - 1} trajectories < num_episodes {num_episodes}")
    return f, traj_idx


def load_goal_and_state(eval_data_path: str, eval_hdf5, traj_idx, ep: int):
    """Episode ep's goal frame (last frame of its eval trajectory) and the
    engine state blob to restore at t=0 (traj_state_{ep}.npy row 0)."""
    goal = eval_hdf5["ob"][traj_idx[ep + 1] - 1, -1]
    state = np.load(
        os.path.join(eval_data_path, f"traj_state_{ep}.npy"), allow_pickle=True
    )[0]
    return goal, state


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """A policy output, a transformed frame batch or raw frames as a tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device)


def _shift(buf: torch.Tensor) -> None:
    """Shift the slots (dim 1) one toward the past in place (slot by slot: no overlapping copy, no temporary);
    the newest slot keeps its value until it is written."""
    for j in range(buf.shape[1] - 1):
        buf[:, j].copy_(buf[:, j + 1])


class TowerRing:
    """The frozen tower's outputs for one view's window slots in one rollout, rolled as the windows roll their
    frames and filled by the policy's encode (``BasePolicy._frozen_frames``), so that each frame goes through
    the tower once and not once for every window it sits in.

    ``buf`` (n, W, L, ...): each env's and slot's outputs of L layers, allocated at the first fill.  The slots
    ``[W - pending - held, W - pending)`` hold outputs: ``pending`` counts the slots pushed since the last fill.
    ``owner``: the policy that computed the outputs; ``fixed``: the inputs besides the frame (the instruction's
    row and its padding) it computed them with, None for the frame alone."""

    def __init__(self, window_size: int):
        self.window_size = window_size
        self.buf: Optional[torch.Tensor] = None
        self.held = self.pending = 0
        self.owner = self.fixed = None

    def push(self) -> None:
        """A new step: every slot one toward the past; the newest has no output yet."""
        if self.buf is not None:
            _shift(self.buf)
        self.pending += 1

    def keep_if(self, owner, fixed: Optional[tuple]) -> None:
        """Drop the outputs unless ``owner`` computed them, with the inputs ``fixed`` besides the frame (two
        policies called on one rollout's windows each encode the whole window)."""
        same = owner is self.owner and (fixed is None) == (self.fixed is None) and (
            fixed is None or all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(fixed, self.fixed)))
        if not same:
            self.buf, self.held, self.owner = None, 0, owner
            self.fixed = None if fixed is None else tuple(t.clone() for t in fixed)

    def missing(self, w: int) -> int:
        """How many of the ``w`` newest slots need the tower: those pushed since the last fill, or all ``w`` when
        an older one of them holds no output."""
        k = min(self.pending, w)
        return k if self.held >= w - k else w

    def fill(self, new: Optional[torch.Tensor], w: int) -> torch.Tensor:
        """``new`` (n, k, L, ...): the tower's outputs for the ``k`` newest slots (None when :meth:`missing` gave
        0); gives the ``w`` newest slots' (n, w, L, ...), a view of the ring."""
        size = self.window_size
        if new is not None:
            k = new.shape[1]
            if self.buf is None:
                self.buf = new.new_empty((new.shape[0], size, *new.shape[2:]))
            self.buf[:, size - k:] = new
            # the outputs held before stay next to the new ones only when no slot between them went unfilled
            self.held = min(size, self.held + k) if k == self.pending else k
            self.pending = 0
        return self.buf[:, size - w:]


class _Windows:
    """The policy's input windows of ``n`` envs on ``device``: per view (n, W, ...) images and
    (n, W, 1) rtg, and (n, W) int32 actions.  The newest slot is the current step; the windows are
    first filled with the first step, and ``inputs`` hands out the ``valid`` newest slots, with the views'
    rings of tower outputs (:class:`TowerRing`) under ``tower_cache``."""

    def __init__(self, first: dict, rtg: dict, window_size: int, device: torch.device):
        n = next(iter(first.values())).shape[0]
        self.image = {k: v[:, None].repeat_interleave(window_size, dim=1).contiguous() for k, v in first.items()}
        self.rtg = {k: torch.as_tensor(r[:, None, None]).repeat(1, window_size, 1).to(device) for k, r in rtg.items()}
        self.action = torch.zeros((n, window_size), dtype=torch.int32, device=device)
        self.tower_cache = {k: TowerRing(window_size) for k in first}
        self.window_size, self.valid, self.device = window_size, 1, device

    @staticmethod
    def _roll(buf: torch.Tensor, new) -> None:
        """Shift one slot toward the past in place and write ``new`` into the newest."""
        _shift(buf)
        buf[:, -1] = new

    def push(self, frames: dict, rtg: dict) -> None:
        """A new step: its frames (on the device) and rtg (host (n,) float32), the 0 action placeholder."""
        for k, v in frames.items():
            self._roll(self.image[k], v)
            self.tower_cache[k].push()
        for k, r in rtg.items():
            self._roll(self.rtg[k], torch.as_tensor(r[:, None]).to(self.device))
        self._roll(self.action, 0)
        self.valid += 1

    def set_action(self, actions) -> None:
        """The chosen action into the current step's slot."""
        self.action[:, -1] = _as_tensor(actions, self.device).to(torch.int32).reshape(-1)

    def inputs(self, goal: Optional[torch.Tensor] = None) -> dict:
        w = min(self.valid, self.window_size)
        inputs = {
            "image": {k: v[:, -w:] for k, v in self.image.items()},
            "rtg": {k: v[:, -w:] for k, v in self.rtg.items()},
            "action": self.action[:, -w:],
            "instruct": None,
            "text_padding_mask": None,
            "tower_cache": self.tower_cache,
        }
        if goal is not None:
            inputs["goal"] = {"ob": goal[:, None].expand(goal.shape[0], w, *goal.shape[1:])}
        return inputs


def batch_rollout(
    rng,
    data_aug_rng,
    env,
    policy_fn: Callable,
    transform_obs_fn: Optional[Callable] = None,
    transform_action_fn: Optional[Callable] = None,
    episode_length: int = 2500,
    window_size: int = 4,
    num_episodes: int = 1,
    return_to_go: float = 100.0,
    scale: float = 100.0,
    reward_engine=None,
    vl_type: str = "clip",
    text=None,
    reward_min=0.0,
    use_normalize: bool = False,
    use_crop: bool = False,
    eval_data_path: Optional[str] = None,
    data_name: str = "data.hdf5",
    device="cuda",
):
    """Sequential eval rollout (reference parity: rollout_procgen.py:24-182).

    ``policy_fn(inputs=..., rngs=rng)`` gets the windows (batch 1) on ``device`` and returns the
    action (a tensor or array of one).  Returns (metric, info, videos).
    """
    del data_aug_rng  # the eval transform is deterministic
    device = resolve_device(device)
    transform_action_fn = transform_action_fn or (lambda x: x)

    eval_hdf5 = None
    eval_traj_idx = None
    if eval_data_path is not None:
        eval_hdf5, eval_traj_idx = open_goal_eval(eval_data_path, data_name, num_episodes)

    def transform(frame):
        x = np.asarray(frame)[None]
        return _as_tensor(x if transform_obs_fn is None else transform_obs_fn(x), device)

    image_keys = env.config.image_key.split(", ")
    ep_returns = []
    ep_lens = 0.0
    videos = []
    info = {"vid": None, "episode_len": 0}

    try:
        for ep in range(num_episodes):
            ep_reward = 0.0
            rtg = {key: np.full(1, return_to_go / scale, dtype=np.float32) for key in image_keys}
            goal_image = goal_input = None
            if eval_hdf5 is not None:
                goal_image, initial_state = load_goal_and_state(eval_data_path, eval_hdf5, eval_traj_idx, ep)
                env.reset()
                obs = env.set_state(initial_state)
                goal_input = transform(goal_image)
            else:
                obs = env.reset(env.config.rand_seed + ep)
            windows = _Windows({k: transform(obs["image"][k]) for k in image_keys}, rtg, window_size, device)

            for t in range(episode_length):
                if t > 0:
                    windows.push({k: transform(obs["image"][k]) for k in image_keys}, rtg)
                action = transform_action_fn(to_host(policy_fn(inputs=windows.inputs(goal_input), rngs=rng))[0])
                windows.set_action(np.asarray(action).reshape(1))

                next_obs, reward, done, info = env.step(action)

                ep_reward += float(reward)
                if reward_engine is not None:
                    # the pre-step frame: the one the policy acted on
                    for key in obs["image"]:
                        r = compute_step_reward(
                            reward_engine, vl_type, obs["image"][key], text=text,
                            goal_image=goal_image, use_crop=use_crop,
                        )
                        if use_normalize:
                            rmin = reward_min[key] if isinstance(reward_min, dict) else reward_min
                            rtg[key] = rtg[key] - (r - rmin) / scale
                        else:
                            rtg[key] = rtg[key] - r / scale
                obs = next_obs

                if done:
                    # done-only accumulation is reference parity (rollout_procgen.py:171): an
                    # episode that exhausts episode_length without done contributes 0 here;
                    # parallel_rollout counts the cap instead
                    ep_lens += info["episode_len"]
                    break

            ep_returns.append(ep_reward)
            if info.get("vid") is not None:
                videos.append(info["vid"])
    finally:
        if eval_hdf5 is not None:
            eval_hdf5.close()

    if num_episodes == 0:
        # degrade like a skipped eval, as build_test_step's parallel eval does
        nan = np.float32("nan")
        return {"return": nan, "episode_length": nan, "success_rate": nan}, info, videos

    metric = {
        "return": np.float32(sum(ep_returns) / num_episodes),
        "episode_length": np.float32(ep_lens / num_episodes),
        # success = any positive return (Procgen's sparse completion reward)
        "success_rate": np.float32(np.mean([r > 0 for r in ep_returns])),
    }
    return metric, info, videos


def parallel_rollout(
    rng,
    envs: list,
    policy_fn: Callable,
    transform_obs_fn: Optional[Callable] = None,
    episode_length: int = 500,
    window_size: int = 4,
    return_to_go: float = 100.0,
    scale: float = 100.0,
    reward_engine=None,
    vl_type: str = "clip",
    text=None,
    reward_min=0.0,
    use_normalize: bool = False,
    use_crop: bool = False,
    goal_images=None,
    initial_states=None,
    feed_goal_to_policy: bool = False,
    seed_offset: int = 0,
    device="cuda",
):
    """Lockstep rollout over N host envs with batched inference on ``device``.

    The policy and the reward model see (N, window, ...) batches every step.
    Finished episodes keep stepping a frozen no-op until all are done (their
    rewards stop accumulating, their rtg stays); an episode that never ends
    counts ``episode_length``.

    ``initial_states``: optional length-N list of env state blobs — each env
    resets then restores its state (goal-conditioned eval, as batch_rollout's
    traj_state_{ep}.npy restore).  ``feed_goal_to_policy``: window
    ``goal_images`` into the policy inputs under "goal"/"ob" (GCBC eval).
    """
    device = resolve_device(device)
    n = len(envs)
    image_keys = envs[0].config.image_key.split(", ")

    if initial_states is not None:
        if len(initial_states) != n:
            raise ValueError(f"{len(initial_states)} initial states for {n} envs")
        obs = []
        for env, state in zip(envs, initial_states):
            env.reset()
            obs.append(env.set_state(state))
    else:
        obs = [env.reset(env.config.rand_seed + seed_offset + i) for i, env in enumerate(envs)]
    done = np.zeros(n, bool)
    total_reward = np.zeros(n, np.float64)
    ep_lens = np.zeros(n, np.int64)

    text_feat = None
    goal_feats = None
    if reward_engine is not None and vl_type in ("clip", "clip_ft"):
        text_feat = reward_engine.encode_text_features(text)
    elif reward_engine is not None and "goal_conditioned" in vl_type:
        if goal_images is None:
            raise ValueError("a goal-conditioned rollout needs goal_images (N, H, W, C)")
        goals = np.asarray(goal_images)
        if use_crop:
            goals = _crop_half(goals)
        goal_feats = reward_engine.encode_image_features(goals, normalize=False)

    def transform(frames):
        frames = np.asarray(frames)
        return _as_tensor(frames if transform_obs_fn is None else transform_obs_fn(frames), device)

    rtg_now = {key: np.full(n, return_to_go / scale, np.float32) for key in image_keys}
    windows = _Windows({key: transform(np.stack([o["image"][key] for o in obs])) for key in image_keys},
                       rtg_now, window_size, device)

    goal_input = None
    if feed_goal_to_policy:
        if goal_images is None:
            raise ValueError("feed_goal_to_policy needs goal_images")
        goal_input = transform(np.asarray(goal_images))  # (N, ...) constant per episode

    for t in range(episode_length):
        with span("rollout.step"):
            with span("rollout.policy"):
                out = policy_fn(inputs=windows.inputs(goal_input), rngs=rng)
                actions = to_host(out)  # one copy from the card a step, for the envs
                # the chosen action into the CURRENT frame's slot (a 0 placeholder during the policy call):
                # slot k pairs a_k with obs_k, the pairing training used
                windows.set_action(out)

            # rtg decrements use the PRE-step frame, the obs the policy just acted on; envs already
            # done before this step keep a frozen rtg
            if reward_engine is not None:
                with span("rollout.reward"):
                    for key in image_keys:
                        frames = np.stack([np.asarray(o["image"][key]) for o in obs])
                        if use_crop:
                            frames = _crop_half(frames)
                        if vl_type in ("clip", "clip_ft"):
                            rewards = reward_engine.text_rewards_with_features(frames, text_feat)
                        elif "goal_conditioned" in vl_type:
                            rewards = reward_engine.goal_rewards_with_features(frames, goal_feats)
                        else:
                            raise ValueError(f"parallel_rollout: unsupported vl_type {vl_type}")
                        if use_normalize:
                            rmin = reward_min[key] if isinstance(reward_min, dict) else reward_min
                            rewards = rewards - rmin
                        rtg_now[key] = np.where(done, rtg_now[key], rtg_now[key] - rewards / scale)

            with span("rollout.env"):
                raw_frames = {key: [] for key in image_keys}
                step_rewards = np.zeros(n, np.float64)
                for i, env in enumerate(envs):
                    if done[i]:
                        for key in image_keys:
                            raw_frames[key].append(np.asarray(obs[i]["image"][key]))
                        continue
                    o, r, d, info = env.step(int(actions[i]))
                    obs[i] = o
                    step_rewards[i] = r
                    if d:
                        done[i] = True
                        ep_lens[i] = info["episode_len"]
                    for key in image_keys:
                        raw_frames[key].append(np.asarray(o["image"][key]))
                total_reward += step_rewards

            # the new obs into the windows; its action slot is the 0 placeholder until the next call
            with span("rollout.push"):
                windows.push({key: transform(np.stack(raw_frames[key])) for key in image_keys}, rtg_now)

        if done.all():
            break

    ep_lens = np.where(ep_lens == 0, episode_length, ep_lens)
    return {
        "return": np.float32(total_reward.mean()),
        "episode_length": np.float32(ep_lens.mean()),
        "success_rate": np.float32((total_reward > 0).mean()),
    }
