"""Trajectory recording to the demo schema (port of arp_tpu/collect/recorder.py).

Re-design of the reference's gym3 ``TrajectoryRecorderWrapper``: accumulates
per-episode (obs, action, reward, done, engine state), frame-stacks
observations into ``(T, num_frames, H, W, C)`` with first-frame back-fill,
filters episodes by the per-game success threshold and a max-length cap, and
appends to gzip HDF5 datasets with the reference keys (ob / act / done /
reward) plus per-episode engine-state ``.npy`` files for goal-conditioned
evaluation.  numpy and h5py only (h5py imported where a file is written); the
datasets are byte for byte the JAX package's on the same env and actions.
"""

from __future__ import annotations

import os

import numpy as np

# per-game expert filters (the reference's trajectory_recorder.py)
_FILTER_THRESHOLDS = {
    "coinrun": 10.0,
    "maze": 10.0,
    "bossfight": 10.0,
    "starpilot": 30.0,
    "bigfish": 1.0,
}


def filter_condition(game_name: str, episode_reward: float) -> bool:
    for key, thr in _FILTER_THRESHOLDS.items():
        if key in game_name:
            return episode_reward >= thr
    return episode_reward > 0.0


def stack_episode_frames(frames: np.ndarray, num_frames: int) -> np.ndarray:
    """(T, ...) -> (T, num_frames, ...); row t = frames[t-F+1..t], back-filled with frame 0."""
    T = frames.shape[0]
    idx = np.arange(T)[:, None] - (num_frames - 1) + np.arange(num_frames)[None, :]
    idx = np.clip(idx, 0, T - 1)
    return frames[idx]


class TrajectoryRecorder:
    """Collects episodes from an env (the arp_tpu_torch.envs interface) into HDF5.

    Usage::

        rec = TrajectoryRecorder("out/data.hdf5", game_name="coinrun")
        while rec.num_recorded < N:
            obs = env.reset(seed); rec.begin_episode(obs, env.get_state())
            while not done:
                obs, r, done, info = env.step(a)
                rec.record_step(obs, a, r, done, env.get_state())
            rec.end_episode(success_filter=True)
    """

    def __init__(self, data_path: str, game_name: str = "coinrun", num_frames: int = 8, image_key: str = "ob",
                 max_episode_length: int = 1000, save_states: bool = True):
        self.data_path = data_path
        self.game_name = game_name
        self.num_frames = num_frames
        self.image_key = image_key
        self.max_episode_length = max_episode_length
        self.save_states = save_states
        self.num_recorded = 0
        self.num_filtered = 0
        self._reset_buffers()
        os.makedirs(os.path.dirname(os.path.abspath(data_path)), exist_ok=True)

    def _reset_buffers(self):
        self._frames: list = []
        self._actions: list = []
        self._rewards: list = []
        self._states: list = []

    def begin_episode(self, obs, state=None):
        self._reset_buffers()
        self._frames.append(np.asarray(obs["image"][self.image_key]))
        if state is not None:
            self._states.append(state)

    def record_step(self, obs, action, reward, done, state=None):
        self._frames.append(np.asarray(obs["image"][self.image_key]))
        self._actions.append(int(np.asarray(action).reshape(())))
        self._rewards.append(float(reward))
        if state is not None:
            self._states.append(state)

    def end_episode(self, success_filter: bool = True) -> bool:
        """Finalize; returns True if the episode was kept."""
        episode_reward = float(np.sum(self._rewards))
        T = len(self._actions)
        keep = 0 < T < self.max_episode_length
        if success_filter:
            keep = keep and filter_condition(self.game_name, episode_reward)
        if not keep:
            self.num_filtered += 1
            self._reset_buffers()
            return False

        # aligned: obs_t, act_t, reward_t, done_t for t in [0, T)
        stacked = stack_episode_frames(np.stack(self._frames[:T]), self.num_frames)
        actions = stack_episode_frames(np.asarray(self._actions, np.int64), self.num_frames)
        rewards = stack_episode_frames(np.asarray(self._rewards, np.float32), self.num_frames)
        done = np.zeros(T, bool)
        done[-1] = True
        self._append_hdf5(ob=stacked, act=actions, reward=rewards, done=stack_episode_frames(done, self.num_frames))
        if self.save_states and self._states:
            state_path = os.path.join(os.path.dirname(self.data_path), f"traj_state_{self.num_recorded}.npy")
            np.save(state_path, np.asarray(self._states[:T], dtype=object), allow_pickle=True)
        self.num_recorded += 1
        self._reset_buffers()
        return True

    def _append_hdf5(self, **arrays):
        import h5py

        with h5py.File(self.data_path, "a") as g:
            for key, data in arrays.items():
                name = self.image_key if key == "ob" else key
                if name not in g:
                    g.create_dataset(name, data=data, compression="gzip", chunks=(1,) + data.shape[1:],
                                     maxshape=(None,) + data.shape[1:])
                else:
                    ds = g[name]
                    ds.resize(ds.shape[0] + data.shape[0], axis=0)
                    ds[-data.shape[0]:] = data


def collect_demonstrations(env, policy_fn, data_path: str, num_episodes: int, game_name: str = "coinrun",
                           num_frames: int = 8, success_filter: bool = True, seed: int = 0,
                           random_action_prob: float = 0.0, max_attempts_factor: int = 50, paired_policy_env=None,
                           max_episode_length: int = 1000) -> TrajectoryRecorder:
    """Collect expert demos with an acting policy.

    ``paired_policy_env``: an optional low-resolution env kept in sync through get_state /
    set_state: the policy acts on its observations while the recorder stores the high-res frames
    (the reference's dual-resolution collection).  ``random_action_prob``: optional action
    corruption, drawn from ``np.random.default_rng(seed)``.
    """
    rng = np.random.default_rng(seed)
    rec = TrajectoryRecorder(data_path, game_name=game_name, num_frames=num_frames,
                             max_episode_length=max_episode_length)
    attempts = 0
    while rec.num_recorded < num_episodes and attempts < num_episodes * max_attempts_factor:
        ep_seed = seed + attempts
        obs = env.reset(ep_seed)
        if paired_policy_env is not None:
            paired_policy_env.reset(ep_seed)
            # set_state syncs the paired low-res engine and returns its re-rendered observation
            policy_obs = paired_policy_env.set_state(env.get_state())
        else:
            policy_obs = obs
        rec.begin_episode(obs, env.get_state() if hasattr(env, "get_state") else None)
        done = False
        while not done:
            action = policy_fn(policy_obs)
            if random_action_prob > 0 and rng.uniform() < random_action_prob:
                action = int(rng.integers(0, 15))
            obs, reward, done, info = env.step(action)
            policy_obs = paired_policy_env.set_state(env.get_state()) if paired_policy_env is not None else obs
            rec.record_step(obs, action, reward, done, env.get_state() if hasattr(env, "get_state") else None)
        rec.end_episode(success_filter=success_filter)
        attempts += 1
    return rec
