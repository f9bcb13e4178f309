"""Procgen environment wrapper (port of the JAX package's ``envs/procgen.py``; the real C++
engine via gym, when installed).

Behavioral parity with arp_dt/envs/procgen.py: the unseen-level evaluation
split (start_level shifted past the training block, num_levels doubled unless
``use_train_levels``), fresh env per reset with an explicit seed, frame
recording on every ``record_every``-th episode, and an episode-length cap
folded into ``done``.

The procgen pip forks (procgen / procgenAISC / procgen_highres*) are not
available in every environment — construction raises a clear error then; use
arp_tpu_torch.envs.FakeProcgen for engine-free testing, or set
``ARP_TPU_FAKE_ENGINE=1`` (the gym3-faithful stub) or ``=native`` (its C++
engine).
"""

from __future__ import annotations

from typing import Union

import numpy as np
from ..config import Config, update_config

_ENV_ID_TEMPLATES = {
    # (eval_env_type == none, high resolution) -> gym id template
    (True, True): "procgen-highres-{game}-v0",
    (True, False): "procgen-{game}-v0",
    (False, True): "procgen-highres-aisc-{game}_{env_type}-v0",
    (False, False): "procgen-aisc-{game}-v0",
}


class Procgen:
    @staticmethod
    def get_default_config(updates=None) -> Config:
        config = Config()
        config.image_key = "ob"
        config.state_key = ""
        config.episode_length = 1000
        config.record_video = True
        config.record_every = 50
        config.distribution_mode = "hard"
        config.num_levels = 500
        config.start_level = 0
        config.eval_start_level = 500
        config.rand_seed = 42
        config.eval_env_type = "none"
        config.use_train_levels = False
        return update_config(config, updates)

    def __init__(self, game_name: str, update, image_resolution: str = "high"):
        self.config = self.get_default_config(update)
        self.game_name = game_name
        self._image_resolution = image_resolution
        self._episode_index = 0
        self._record_current_episode = True
        self._recorded_images: list = []
        self._step_count = 0
        self._create_env()

    # -- engine management -----------------------------------------------------

    def _level_range(self) -> tuple[int, int]:
        """Train levels, or the disjoint eval block shifted past them."""
        if self.config.use_train_levels:
            return self.config.start_level, self.config.num_levels
        return (
            self.config.start_level + self.config.num_levels,
            self.config.num_levels * 2,
        )

    def _env_id(self) -> str:
        template = _ENV_ID_TEMPLATES[
            (self.config.eval_env_type == "none", self._image_resolution == "high")
        ]
        return template.format(game=self.game_name, env_type=self.config.eval_env_type)

    def _create_env(self, rand_seed: int = 42):
        import os

        fake = os.environ.get("ARP_TPU_FAKE_ENGINE")
        if fake:
            # gym3-faithful stub (real state-codec blobs): every branch below
            # and in get_state/set_state runs exactly as against the real
            # engine — only the C++ dynamics are simulated.  "native" selects
            # the C++ vectorized engine (envs/native_engine.py) with the
            # identical surface and dynamics.
            from .gym3_stub import make_fake_gym_env

            start_level, num_levels = self._level_range()
            self._env = make_fake_gym_env(
                game_name=self.game_name,
                distribution_mode=self.config.distribution_mode,
                num_levels=num_levels,
                start_level=start_level,
                rand_seed=rand_seed,
                env_type=self.config.eval_env_type,
                resolution=256 if self._image_resolution == "high" else 64,
                episode_length=self.config.episode_length,
                engine="native" if fake == "native" else "python",
            )
            return
        try:
            import gym
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "The procgen C++ engine (gym + procgen forks) is not installed. "
                "Install procgen/procgenAISC/procgen_highres, or use "
                "arp_tpu_torch.envs.FakeProcgen for engine-free rollouts, or set "
                "ARP_TPU_FAKE_ENGINE=1 for the gym3-faithful stub."
            ) from e
        start_level, num_levels = self._level_range()
        self._env = gym.make(
            id=self._env_id(),
            distribution_mode=self.config.distribution_mode,
            num_levels=num_levels,
            start_level=start_level,
            rand_seed=rand_seed,
        )

    # -- gym surface -----------------------------------------------------------

    @property
    def observation_space(self):
        return self._env.observation_space

    @property
    def action_space(self):
        return self._env.action_space

    def reset(self, rand_seed: int = 42):
        # a fresh engine per episode keeps level sampling reproducible per seed
        self._create_env(rand_seed=rand_seed)
        obs = self._env.reset()
        self._step_count = 0
        self._episode_index += 1
        self._record_current_episode = (
            self.config.record_video and self._episode_index % self.config.record_every == 0
        )
        self._recorded_images = [obs]
        return self.get_image_state(obs)

    def step(self, action: Union[int, np.ndarray]):
        obs, reward, terminal, _ = self._env.step(action)
        self._recorded_images.append(obs)
        self._step_count += 1

        done = bool(terminal) or self._step_count == self.config.episode_length
        vid = None
        if done and self._record_current_episode:
            vid = np.array(self._recorded_images)
        info = {"vid": vid, "episode_len": self._step_count, "terminal": terminal}
        return self.get_image_state(obs), reward, done, info

    def get_image_state(self, obs):
        res = {"image": {key: obs for key in self.config.image_key.split(", ")}}
        if self.config.state_key != "":
            res["state"] = np.concatenate(
                [obs[k] for k in self.config.state_key.split(", ")]
            )
        return res

    # -- engine save-state access (gym3 wrappers expose get/set_state) ---------

    def _inner_env(self):
        env = self._env
        for _ in range(8):
            if hasattr(env, "set_state"):
                return env
            env = getattr(env, "env", env)
        return env

    def get_state(self):
        return self._inner_env().get_state()

    def set_state(self, state):
        inner = self._inner_env()
        inner.set_state(state)
        rgb = inner.observe()[1]["rgb"][0]
        self._recorded_images.append(rgb)
        return self.get_image_state(rgb)
