"""Native C++ vectorized grid engine behind the gym3 venv surface (port of the JAX package's
``envs/native_engine.py``).

The reference's environments are C++ (the Procgen forks), driven through
gym3's vectorized ``act`` / ``observe``: the per-step work (dynamics + RGB
render) runs in native code while Python orchestrates.
:class:`NativeProcgenGym3` is the equivalent for the fake grid dynamics: batch
stepping and threaded batch rendering in C++ (the port's own copy of the
engine, ``arp_tpu_torch/native/gridenv.cpp``), the save-state blobs still
encoded with the wire-format codec in Python, and levels a pure splitmix64
function of (seed, grid) shared bit for bit with
:class:`arp_tpu_torch.envs.gym3_stub.FakeProcgenGym3`: the two engines give
identical episode streams from identical constructor arguments.

The library is built with ``g++`` at first use into
``build/arp_tpu_torch/native/`` at the root of the checkout, its file name
carrying a hash of the source and the flags.  Without ``g++``, or when the
build fails, constructing the engine raises with the compiler's output.

Select it with ``ARP_TPU_FAKE_ENGINE=native`` (the Procgen wrapper routes
through :func:`gym3_stub.make_fake_gym_env`), or construct it directly.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from ..native import BUILD_DIR, SOURCE_DIR, build_library
from .gym3_stub import FakeProcgenGym3

SOURCE = SOURCE_DIR / "gridenv.cpp"


def build_native() -> Path:
    """Compile ``native/gridenv.cpp`` unless already built; returns the library's path.

    Raises RuntimeError when ``g++`` is missing or the build fails."""
    return build_library(SOURCE, "gridenv", BUILD_DIR)


@functools.lru_cache(maxsize=None)
def native_lib() -> ctypes.CDLL:
    """The grid engine's library, built at first use and loaded once per process."""
    lib = ctypes.CDLL(str(build_native()))
    i64 = ctypes.c_int64
    lib.grid_create.restype = ctypes.c_void_p
    lib.grid_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, i64, i64, i64, i64]
    lib.grid_destroy.restype = None
    lib.grid_destroy.argtypes = [ctypes.c_void_p]
    lib.grid_act.restype = None
    lib.grid_act.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.grid_observe.restype = None
    lib.grid_observe.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.grid_get_core.restype = None
    lib.grid_get_core.argtypes = [ctypes.c_void_p, ctypes.POINTER(i64)]
    lib.grid_set_core.restype = None
    lib.grid_set_core.argtypes = [ctypes.c_void_p, ctypes.POINTER(i64)]
    lib.grid_episode_counter.restype = i64
    lib.grid_episode_counter.argtypes = [ctypes.c_void_p]
    lib.grid_set_episode_counter.restype = None
    lib.grid_set_episode_counter.argtypes = [ctypes.c_void_p, i64]
    return lib


class NativeProcgenGym3(FakeProcgenGym3):
    """gym3 surface over the C++ engine; drop-in for FakeProcgenGym3.

    The hot path (``act``, ``observe``) runs entirely in native code; the cold
    path (state blobs) reuses the parent's codec-backed encode/decode over a
    core-state snapshot fetched from C++.
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
        self._handle = None  # __del__ safety if anything below raises
        self._lib = native_lib()
        # config attrs: identical names and semantics to the parent
        self.num = num
        self.game_name = game_name
        self.resolution = resolution
        self.grid = grid
        self.episode_length = episode_length
        self.distribution_mode = distribution_mode
        self.num_levels = max(1, num_levels)
        self.start_level = start_level
        self.env_type = env_type
        self._handle = self._lib.grid_create(
            num, grid, resolution, episode_length, self.num_levels, start_level, rand_seed
        )
        if not self._handle:
            raise RuntimeError("grid_create failed")
        # parent-named arrays: refreshed from native for the blob paths
        self._agent = np.zeros((num, 2), np.int32)
        self._goal = np.zeros((num, 2), np.int32)
        self._seed = np.zeros(num, np.int64)
        self._t = np.zeros(num, np.int64)
        self._rew = np.zeros(num, np.float32)
        self._first = np.ones(num, bool)
        self._rew_buf = np.zeros(num, np.float32)
        self._first_buf = np.zeros(num, np.uint8)
        self._rgb_buf = np.zeros((num, resolution, resolution, 3), np.uint8)
        self._core_buf = np.zeros((num, 6), np.int64)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.grid_destroy(handle)
            self._handle = None

    @property
    def episode_counter(self) -> int:
        return int(self._lib.grid_episode_counter(self._handle))

    # -- gym3 hot path (native) ------------------------------------------------------

    def observe(self):
        self._lib.grid_observe(
            self._handle,
            self._rew_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._first_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._rgb_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return (
            self._rew_buf.copy(),
            {"rgb": self._rgb_buf.copy()},
            self._first_buf.astype(bool),
        )

    def act(self, ac):
        ac = np.ascontiguousarray(np.asarray(ac).reshape(self.num), dtype=np.int32)
        self._lib.grid_act(self._handle, ac.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    # -- save states (codec blobs via the parent, core state from C++) ---------------

    def _refresh_core(self):
        self._lib.grid_get_core(
            self._handle, self._core_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        self._agent[:] = self._core_buf[:, 0:2]
        self._goal[:] = self._core_buf[:, 2:4]
        self._t[:] = self._core_buf[:, 4]
        self._seed[:] = self._core_buf[:, 5]

    def get_state(self):
        self._refresh_core()
        return super().get_state()

    def set_state(self, states):
        super().set_state(states)  # decode blobs into the parent-named arrays
        core = np.empty((self.num, 6), np.int64)
        core[:, 0:2] = self._agent
        core[:, 2:4] = self._goal
        core[:, 4] = self._t
        core[:, 5] = self._seed
        core = np.ascontiguousarray(core)
        self._lib.grid_set_core(self._handle, core.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
