"""Backward-discounted running reward normalizer (port of arp_tpu/collect/reward_normalizer.py, PPG support).

As the reference's phasic_policy_gradient/reward_normalizer.py: rewards are
divided by the running standard deviation of a backward-discounted return
estimate, then clipped.  numpy float64 throughout, as the JAX package's.
"""

from __future__ import annotations

import numpy as np


class RunningMeanStd:
    def __init__(self, epsilon: float = 1e-4, shape=()):
        self.mean = np.zeros(shape, np.float64)
        self.var = np.ones(shape, np.float64)
        self.count = epsilon

    def update(self, x: np.ndarray):
        x = np.asarray(x, np.float64)
        batch_mean = x.mean(axis=0)
        batch_var = x.var(axis=0)
        batch_count = x.shape[0]
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        self.mean = self.mean + delta * batch_count / tot
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + delta**2 * self.count * batch_count / tot
        self.var = m2 / tot
        self.count = tot


class RewardNormalizer:
    """r_norm = clip(r / std(backward-discounted returns), +-cliprew)."""

    def __init__(self, num_envs: int, gamma: float = 0.99, cliprew: float = 10.0, epsilon: float = 1e-8):
        self.rms = RunningMeanStd(shape=())
        self.gamma = gamma
        self.cliprew = cliprew
        self.epsilon = epsilon
        self._ret = np.zeros(num_envs, np.float64)

    def state_dict(self) -> dict:
        """The running statistics, for a checkpoint."""
        return {
            "mean": np.asarray(self.rms.mean, np.float64),
            "var": np.asarray(self.rms.var, np.float64),
            "count": np.float64(self.rms.count),
            "ret": np.asarray(self._ret, np.float64).copy(),
        }

    def load_state_dict(self, d: dict):
        self.rms.mean = np.asarray(d["mean"], np.float64)
        self.rms.var = np.asarray(d["var"], np.float64)
        self.rms.count = float(d["count"])
        self._ret = np.asarray(d["ret"], np.float64).copy()

    def __call__(self, rewards: np.ndarray, dones: np.ndarray) -> np.ndarray:
        self._ret = self._ret * self.gamma + rewards
        self.rms.update(self._ret)
        self._ret[np.asarray(dones, bool)] = 0.0
        return np.clip(rewards / np.sqrt(self.rms.var + self.epsilon), -self.cliprew, self.cliprew)

    def normalize_segment(self, rewards: np.ndarray, dones: np.ndarray) -> np.ndarray:
        """The whole-segment form (the reference's ppo.py): rewards and dones are time-major (T, N);
        the running return carries across segments and resets after an episode's end, and the
        whole segment is scaled by the std updated on this segment's returns."""
        rewards = np.asarray(rewards, np.float64)
        rets = np.zeros_like(rewards)
        prev = self._ret
        for t in range(rewards.shape[0]):
            prev = rets[t] = rewards[t] + self.gamma * prev
            prev = np.where(np.asarray(dones[t], bool), 0.0, prev)
        self._ret = prev
        self.rms.update(rets.reshape(-1))
        return np.clip(rewards / np.sqrt(self.rms.var + self.epsilon), -self.cliprew, self.cliprew).astype(np.float32)
