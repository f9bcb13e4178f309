"""gym3-faithful fake Procgen engine backed by real state-codec blobs (port of the JAX
package's ``envs/gym3_stub.py``, the same dynamics, levels and blobs).

``envs/fake.py`` exercises the env interface, but its get_state / set_state
trade plain dicts, nothing like what a run against the real engine sees.  The
reference's glue talks to gym3 venvs whose ``callmethod("get_state")`` returns
opaque C++ save-state byte blobs.

This module provides that exact surface over the FakeProcgen grid dynamics:

  * :class:`FakeProcgenGym3` — gym3 venv API (``num``, ``observe``, ``act``,
    ``get_state``, ``set_state``, ``callmethod``) where states are byte blobs
    encoded with :mod:`arp_tpu_torch.envs.state_codec` using the real
    coinrun/maze (+AISC) schemas, the wire format of the C++ engine;
  * :func:`make_fake_gym_env` — a gym-style wrapper chain (``.env`` nesting,
    ``reset``/``step``) mimicking what ``gym.make("procgen-*")`` returns, so
    :class:`arp_tpu_torch.envs.procgen.Procgen` runs its real branches
    (inner-env discovery, blob set_state + re-render via ``observe()[1]["rgb"]``).
    Enabled in Procgen via ``ARP_TPU_FAKE_ENGINE=1``.

Dual-resolution pairing works exactly like the real engine: a state blob from
a 256x256 venv restored into a 64x64 venv re-renders the same logical scene
at the lower resolution.
"""

from __future__ import annotations

import numpy as np

from .state_codec import ENTITY_SCHEMA, FLOAT, decode_state, encode_state

_ACTION_DELTAS = {0: (0, -1), 1: (0, 1), 2: (-1, 0), 3: (1, 0)}

_U64 = (1 << 64) - 1


def _splitmix64(state: int):
    """One splitmix64 draw; returns (new_state, value). Bit-for-bit identical
    to the C++ engine's generator (arp_tpu_torch/native/gridenv.cpp) so the Python stub and
    the native engine produce the same levels from the same seed."""
    state = (state + 0x9E3779B97F4A7C15) & _U64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return state, z ^ (z >> 31)


def place_entities(seed: int, grid: int):
    """Deterministic level layout: agent (ay, ax) and goal (gy, gx) cells.

    The level is a pure function of (seed, grid), shared by FakeProcgenGym3
    and the native C++ engine (parity-tested in tests/test_torch_envs.py)."""
    s = seed & _U64
    s, v = _splitmix64(s)
    ay = v % grid
    s, v = _splitmix64(s)
    ax = v % grid
    while True:
        s, v = _splitmix64(s)
        gy = v % grid
        s, v = _splitmix64(s)
        gx = v % grid
        if (gy, gx) != (ay, ax):
            return ay, ax, gy, gx


def _blank_entity() -> dict:
    ent = {name: (0.0 if kind == FLOAT else 0) for name, kind in ENTITY_SCHEMA}
    ent["collision_margin"] = 0.0
    return ent


def _template_state(game_name: str, env_type: str, distribution_mode: str, grid: int) -> dict:
    """A full schema-complete engine-state dict with engine-plausible defaults."""
    data = {
        "SERIALIZE_VERSION": 0,
        "game_name": game_name.split("_")[0],
        "paint_vel_info": 0,
        "use_generated_assets": 0,
        "use_monochrome_assets": 0,
        "restrict_themes": 0,
        "use_backgrounds": 1,
        "center_agent": 0,
        "debug_mode": 0,
        "distribution_mode": {"easy": 0, "hard": 1, "extreme": 2, "memory": 10, "exploration": 20}.get(
            distribution_mode, 1
        ),
        "use_sequential_levels": 0,
    }
    if "_" in game_name or env_type == "aisc":
        data.update(random_percent=0, key_penalty=0, step_penalty=0, rand_region=0,
                    continue_after_coin=0)
    data.update(
        use_easy_jump=0, plain_assets=0, physics_mode=0, grid_step=0,
        level_seed_low=0, level_seed_high=0, game_type=0, game_n=0,
        level_seed_is_seeded=1, level_seed_str="", rand_is_seeded=1, rand_str="",
        step_data_reward=0.0, step_data_done=0, step_data_level_complete=0,
        action=0, timeout=1000, current_level_seed=0, prev_level_seed=0,
        episodes_remaining=0, episodes_done=0, last_reward_timer=0,
        last_reward=0.0, default_action=0, fixed_asset_seed=0, cur_time=0,
        is_waiting_for_sleep=0, grid_size=grid * grid, entities=[],
        use_procgen_background=1, background_index=0, bg_tile_ratio=0.0,
        bg_pct_x=0.0, char_dim=1.0, last_move_action=0, move_action=0,
        special_action=0, mixrate=0.5, maxspeed=0.5, max_jump=1.5,
        action_vx=0.0, action_vy=0.0, action_vrot=0.0, center_x=0.0,
        center_y=0.0, random_agent_start=1, has_useful_vel_info=1,
        step_rand_int=0, asset_rand_is_seeded=1, asset_rand_str="",
        main_width=grid, main_height=grid, out_of_bounds_object=1, unit=1.0,
        view_dim=float(grid), x_off=0.0, y_off=0.0, visibility=1.0,
        min_visibility=0.0, grid_w=grid, grid_h=grid,
        grid_data=[0] * (grid * grid),
    )
    if "coinrun" in game_name:
        data.update(last_agent_y=0.0, wall_theme=0, has_support=True,
                    facing_right=True, is_on_crate=False, gravity=0.2,
                    air_control=0.15)
    elif "maze" in game_name:
        data.update(maze_dim=grid, world_dim=grid)
    return data


class FakeProcgenGym3:
    """gym3 venv surface over grid dynamics with real-format state blobs.

    Dynamics per env: an agent moves toward a goal on a ``grid`` x ``grid``
    board; reaching it gives +10 and ends the episode (auto-reset with the
    next level seed, gym3 semantics: the post-act ``observe`` reports the
    reward and ``first=True`` for the new episode).
    """

    def __init__(
        self,
        game_name: str = "coinrun",
        num: int = 1,
        resolution: int = 256,
        grid: int = 8,
        episode_length: int = 1000,
        distribution_mode: str = "hard",
        num_levels: int = 500,
        start_level: int = 0,
        rand_seed: int = 42,
        env_type: str = "none",
    ):
        self.num = num
        self.game_name = game_name
        self.resolution = resolution
        self.grid = grid
        self.episode_length = episode_length
        self.distribution_mode = distribution_mode
        self.num_levels = max(1, num_levels)
        self.start_level = start_level
        self.env_type = env_type
        self._episode_counter = rand_seed
        self._agent = np.zeros((num, 2), np.int32)
        self._goal = np.zeros((num, 2), np.int32)
        self._seed = np.zeros(num, np.int64)
        self._t = np.zeros(num, np.int64)
        self._rew = np.zeros(num, np.float32)
        self._first = np.ones(num, bool)
        for i in range(num):
            self._new_episode(i)

    # -- dynamics --------------------------------------------------------------

    def _new_episode(self, i: int):
        # level seed drawn from the [start_level, start_level+num_levels) block
        seed = self.start_level + (self._episode_counter % self.num_levels)
        self._episode_counter += 1
        ay, ax, gy, gx = place_entities(seed, self.grid)
        self._agent[i] = (ay, ax)
        self._goal[i] = (gy, gx)
        self._seed[i] = seed
        self._t[i] = 0
        self._first[i] = True

    def _render(self, i: int) -> np.ndarray:
        size = self.resolution
        cell = max(1, size // self.grid)
        img = np.full((size, size, 3), 30, np.uint8)
        gy, gx = self._goal[i] * cell
        img[gy : gy + cell, gx : gx + cell] = (255, 215, 0)
        ay, ax = self._agent[i] * cell
        img[ay : ay + cell, ax : ax + cell] = (200, 30, 30)
        return img

    # -- gym3 API --------------------------------------------------------------

    def observe(self):
        rgb = np.stack([self._render(i) for i in range(self.num)])
        return self._rew.copy(), {"rgb": rgb}, self._first.copy()

    def act(self, ac):
        ac = np.asarray(ac).reshape(self.num)
        for i in range(self.num):
            delta = _ACTION_DELTAS.get(int(ac[i]), (0, 0))
            self._agent[i] = np.clip(self._agent[i] + np.asarray(delta), 0, self.grid - 1)
            self._t[i] += 1
            terminal = bool(np.array_equal(self._agent[i], self._goal[i]))
            self._rew[i] = 10.0 if terminal else 0.0
            self._first[i] = False
            if terminal or self._t[i] >= self.episode_length:
                self._new_episode(i)  # gym3 auto-reset; sets first=True

    # -- engine save states (real wire format) ---------------------------------

    def _state_dict(self, i: int) -> dict:
        data = _template_state(self.game_name, self.env_type, self.distribution_mode, self.grid)
        agent = _blank_entity()
        agent["x"], agent["y"] = float(self._agent[i][1]) + 0.5, float(self._agent[i][0]) + 0.5
        agent["type"] = 0  # PLAYER
        goal = _blank_entity()
        goal["x"], goal["y"] = float(self._goal[i][1]) + 0.5, float(self._goal[i][0]) + 0.5
        goal["type"] = 1  # GOAL / COIN
        data["entities"] = [agent, goal]
        data["cur_time"] = int(self._t[i])
        data["current_level_seed"] = int(self._seed[i])
        data["level_seed_low"] = int(self._seed[i])
        data["timeout"] = int(self.episode_length)
        return data

    def get_state(self):
        return [encode_state(self._state_dict(i), env_type=self.env_type) for i in range(self.num)]

    def set_state(self, states):
        assert len(states) == self.num, (len(states), self.num)
        for i, blob in enumerate(states):
            data = decode_state(blob, env_type=self.env_type)
            ents = data["entities"]
            assert len(ents) >= 2, "blob carries no agent/goal entities"
            self._agent[i] = (int(ents[0]["y"]), int(ents[0]["x"]))
            self._goal[i] = (int(ents[1]["y"]), int(ents[1]["x"]))
            self._t[i] = int(data["cur_time"])
            self._seed[i] = int(data["current_level_seed"])
            self._first[i] = False
            self._rew[i] = 0.0

    def callmethod(self, method: str, *args):
        if method == "get_state":
            return self.get_state()
        if method == "set_state":
            return self.set_state(args[0])
        raise AttributeError(f"FakeProcgenGym3 has no callmethod {method!r}")


# -- gym-style wrapper chain (what gym.make('procgen-*') hands back) -----------


class _Gym3ToGym:
    """Innermost adapter holding the gym3 core (exposes its state methods)."""

    def __init__(self, core: FakeProcgenGym3):
        self.core = core
        # Procgen._inner_env discovers the state surface by hasattr walk
        self.get_state = core.get_state
        self.set_state = core.set_state
        self.callmethod = core.callmethod
        self.observe = core.observe

    def reset(self):
        _, obs, _ = self.core.observe()
        return obs["rgb"][0]

    def step(self, action):
        self.core.act(np.asarray([action]))
        rew, obs, first = self.core.observe()
        # gym3 -> gym: `first` after an act means the episode just ended and
        # the engine auto-reset; report it as terminal (procgen's own gym
        # adapter behaves the same way)
        return obs["rgb"][0], float(rew[0]), bool(first[0]), {}


class _GymWrapper:
    """One transparent wrapper level (gym.Wrapper stand-in)."""

    def __init__(self, env):
        self.env = env

    def reset(self):
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)

    @property
    def observation_space(self):
        return None

    @property
    def action_space(self):
        return None


def make_fake_gym_env(
    game_name: str,
    distribution_mode: str = "hard",
    num_levels: int = 500,
    start_level: int = 0,
    rand_seed: int = 42,
    env_type: str = "none",
    resolution: int = 256,
    grid: int = 8,
    episode_length: int = 1000,
    engine: str = "python",
):
    """A gym-like env over the gym3 stub, nested like the real procgen wrappers
    (rollout_procgen.py reaches the engine at env._env.env.env.env).

    ``engine="native"`` backs the same surface with the C++ vectorized engine
    (envs/native_engine.py) — identical dynamics and blobs, native hot path."""
    if engine == "native":
        from .native_engine import NativeProcgenGym3 as core_cls
    elif engine == "python":
        core_cls = FakeProcgenGym3
    else:
        raise ValueError(f"unknown fake-engine kind {engine!r} (python|native)")
    core = core_cls(
        game_name=game_name,
        num=1,
        resolution=resolution,
        grid=grid,
        episode_length=episode_length,
        distribution_mode=distribution_mode,
        num_levels=num_levels,
        start_level=start_level,
        rand_seed=rand_seed,
        env_type=env_type,
    )
    return _GymWrapper(_GymWrapper(_Gym3ToGym(core)))
