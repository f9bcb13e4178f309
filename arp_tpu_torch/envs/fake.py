"""Scripted fake environment implementing the Procgen wrapper interface (port of the JAX package's
``envs/fake.py``, the same dynamics, rendering and random stream).

Used for rollout/eval without the Procgen C++ engine.  Dynamics: an agent dot
moves on a small grid toward a goal dot; action 0-3 moves left/right/up/down,
others no-op.  Reaching the goal gives +10 and ends the episode (mirrors
CoinRun's sparse terminal reward).  Observations are rendered uint8 (H, W, 3)
frames, deterministic given the seed: ``reset(seed)`` draws the level from
``np.random.default_rng(seed)`` exactly as the JAX package's FakeProcgen does,
so both give the same episode stream byte for byte.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from ..config import Config, update_config


class FakeProcgen:
    @staticmethod
    def get_default_config(updates=None) -> Config:
        config = Config()
        config.image_key = "ob"
        config.state_key = ""
        config.episode_length = 100
        config.record_video = True
        config.record_every = 1
        config.distribution_mode = "hard"
        config.num_levels = 500
        config.start_level = 0
        config.eval_start_level = 500
        config.rand_seed = 42
        config.eval_env_type = "none"
        config.use_train_levels = False
        config.image_size = 64
        config.grid = 8
        # hidden_goal: do not render the gold goal block, so the observation alone carries no
        # information about the target (a goal-conditioned policy reads it from its goal frame).
        # Dynamics, terminal reward and get_state / set_state are unchanged.
        config.hidden_goal = False
        return update_config(config, updates)

    def __init__(self, game_name: str = "coinrun", update=None, image_resolution: str = "high"):
        self.config = self.get_default_config(update)
        self.game_name = game_name
        self._episode_index = 0
        self._record_current_episode = True
        self._recorded_images: list = []
        self._i = 0
        self._rng = np.random.default_rng(self.config.rand_seed)
        self.action_space_n = 15
        self._agent = np.zeros(2, np.int32)
        self._goal = np.zeros(2, np.int32)

    def _render(self) -> np.ndarray:
        size = self.config.image_size
        cell = size // self.config.grid
        img = np.full((size, size, 3), 30, np.uint8)
        if not self.config.hidden_goal:
            gy, gx = self._goal * cell
            img[gy : gy + cell, gx : gx + cell] = (255, 215, 0)  # goal: gold
        ay, ax = self._agent * cell
        img[ay : ay + cell, ax : ax + cell] = (200, 30, 30)  # agent: red
        return img

    def reset(self, rand_seed: int = 42):
        self._rng = np.random.default_rng(rand_seed)
        g = self.config.grid
        self._agent = self._rng.integers(0, g, size=2).astype(np.int32)
        while True:
            self._goal = self._rng.integers(0, g, size=2).astype(np.int32)
            if not np.array_equal(self._goal, self._agent):
                break
        self._i = 0
        self._episode_index += 1
        self._record_current_episode = (
            self.config.record_video and self._episode_index % self.config.record_every == 0
        )
        self._recorded_images.clear()
        obs = self._render()
        self._recorded_images.append(obs)
        return self.get_image_state(obs)

    def step(self, action: Union[int, np.ndarray]):
        action = int(np.asarray(action).reshape(()))
        g = self.config.grid
        delta = {0: (0, -1), 1: (0, 1), 2: (-1, 0), 3: (1, 0)}.get(action, (0, 0))
        self._agent = np.clip(self._agent + np.asarray(delta, np.int32), 0, g - 1)
        self._i += 1

        terminal = bool(np.array_equal(self._agent, self._goal))
        reward = 10.0 if terminal else 0.0
        obs = self._render()
        self._recorded_images.append(obs)

        done = terminal or self._i == self.config.episode_length
        vid = np.array(self._recorded_images) if (done and self._record_current_episode) else None
        info = {"vid": vid, "episode_len": self._i, "terminal": terminal}
        return self.get_image_state(obs), reward, done, info

    def get_image_state(self, obs):
        res = {"image": {}}
        for k in self.config.image_key.split(", "):
            res["image"][k] = obs
        return res

    # engine-state stubs (the real wrapper exposes the C++ engine's get_state / set_state
    # through gym3 callmethods)
    def get_state(self):
        return {"agent": self._agent.copy(), "goal": self._goal.copy(), "i": self._i}

    def set_state(self, state):
        self._agent = np.asarray(state["agent"], np.int32).copy()
        self._goal = np.asarray(state["goal"], np.int32).copy()
        self._i = int(state["i"])
        obs = self._render()
        self._recorded_images.append(obs)
        return self.get_image_state(obs)
