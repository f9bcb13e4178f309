"""Checkpoints (port of arp_tpu/checkpoint.py, in the port's own format).

This module is the one owner of ``<directory>/step_<n>.pt``.  Every such file
holds ``step`` and ``state`` (the policy's trained state dict): that is all
:func:`save_policy_state` writes and all :func:`load_policy_state` (the
server's reader) needs.  The trainer's :class:`CheckpointManager` adds the
optimizer's state (``optimizer``: count, and mu and nu by parameter name),
``metadata`` and the best eval score so far.  So ``arp_tpu_torch.serve``
serves what the trainer writes.  ``n`` is the number of updates the state has
had: a resumed run starts at step ``n`` with the loader fast-forwarded by
``n`` batches, and continues as an uninterrupted run would.  The frozen_int8
calibration scales stay in ``frozen_int8_amax.npz`` beside the step files, as
in the JAX package (``train.common.save_frozen_amax``): a restore rebuilds the
int8 pack from them.

Files appear under their names only once complete (written to ``.tmp``, then
renamed); the newest ``max_to_keep`` steps are kept.  The best model is
``best.pt`` (state and score in one file) with its score in ``best.json``.
Saves are synchronous, so :meth:`CheckpointManager.wait` has nothing to wait for.

Over several processes (parallel/mesh.py) every rank calls :meth:`CheckpointManager.save`
and ``save_best``: the state is gathered whole (a sharded tensor's gather is a
collective), rank 0 alone writes, and the ranks meet at a barrier.  The file is
the full state, whatever the world size or the sharding: a run saved at 2
ranks under fsdp resumes at 1 rank exactly, and the other way round
(:meth:`CheckpointManager.restore` cuts each tensor back to the state's layout).

The reference's own format, a pickle of ``{"step", "epoch", "variant",
"state"}`` with a flax TrainState, is read by :func:`load_pickle` /
:func:`load_reference_checkpoint` and written by :func:`save_pickle` /
:func:`save_reference_checkpoint`, all without flax, optax, jax or
cloudpickle (arp_tpu_torch/_pickle_compat.py).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from . import _pickle_compat
from .parallel.distributed import barrier, process_index
from .parallel.mesh import gather_to_host

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


def step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.pt")


def saved_steps(directory: str) -> list:
    """The n of every ``step_<n>.pt`` in ``directory``, ascending ([] when it does not exist)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(directory) if (m := _STEP_FILE.match(name)))


def latest_step(directory: str) -> Optional[int]:
    """The largest n with a ``step_<n>.pt`` in ``directory``, or None."""
    steps = saved_steps(directory)
    return steps[-1] if steps else None


def _atomic_save(obj, path: str) -> str:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def policy_payload(step: int, model) -> dict:
    """What every ``step_<n>.pt`` holds: the step and the policy's full trained state dict (the flat
    model's, whatever the layout: fsdp shards, tp shares and pp stages gathered)."""
    return {"step": int(step), "state": gather_to_host(model)}


def state_payload(state, metadata: Optional[dict] = None) -> dict:
    """A train state as one host dict: :func:`policy_payload`, the optimizer's count and full moments
    keyed by parameter name, and the metadata."""
    from .parallel.mesh import gather_named, split_of

    splits = {n: split_of(p) for n, p in state.params if split_of(p) is not None}
    names = [n for n, _ in state.params]
    opt = state.opt_state
    return dict(
        policy_payload(state.step, state.model),
        optimizer={"count": int(opt.count), "mu": gather_named(dict(zip(names, opt.mu)), splits),
                   "nu": gather_named(dict(zip(names, opt.nu)), splits)},
        metadata=dict(metadata or {}),
    )


def save_policy_state(directory: str, step: int, model) -> str:
    """Write ``model``'s trained state dict and ``step`` as ``step_<step>.pt``; returns the path.

    The file appears under its name only once it is complete, so a reload
    never reads half of one.
    """
    os.makedirs(directory, exist_ok=True)
    return _atomic_save(policy_payload(step, model), step_path(directory, step))


def _load_step(directory: str, step: Optional[int] = None) -> dict:
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no step_<n>.pt checkpoint in {directory}")
    return torch.load(step_path(directory, step), map_location="cpu", weights_only=True)


def load_policy_state(directory: str, step: Optional[int] = None) -> tuple[dict, dict]:
    """(trained state dict, metadata with ``step``) of ``step_<step>.pt``, the newest by default;
    none there raises.  Needs no optimizer: the server's way."""
    saved = _load_step(directory, step)
    return saved["state"], dict(saved.get("metadata", {}), step=saved["step"])


def load_best_state(directory: str) -> tuple[dict, dict]:
    """(trained state dict, metadata with ``step`` and ``score``) of ``best.pt`` in ``directory``."""
    saved = torch.load(os.path.join(directory, "best.pt"), map_location="cpu", weights_only=True)
    return saved["state"], dict(saved.get("metadata", {}), step=saved["step"])


class CheckpointManager:
    """Save, restore and keep the best of train states in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_score = -np.inf
        best = os.path.join(self.directory, "best.json")
        if os.path.exists(best):  # a resumed run keeps the best so far
            with open(best) as f:
                self.best_score = float(json.load(f).get("score", -np.inf))

    def steps(self) -> list:
        return saved_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def save(self, step: int, state, metadata: Optional[dict] = None, wait: bool = False):
        """Write ``state`` as ``step_<step>.pt`` (complete before it appears); keep the newest files.
        Over several processes every rank calls it and rank 0 writes."""
        del wait  # synchronous
        payload = state_payload(state, metadata)
        payload["best_score"] = float(self.best_score)
        if process_index() == 0:
            _atomic_save(payload, step_path(self.directory, step))
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(step_path(self.directory, old))
        barrier()

    def save_best(self, step: int, state, score: float, metadata: Optional[dict] = None) -> bool:
        """Keep ``state`` as the best model when ``score`` beats the best so far (every rank calls
        it with the same score; rank 0 writes)."""
        if score <= self.best_score:
            return False
        self.best_score = float(score)
        payload = state_payload(state, dict(metadata or {}, step=step, score=float(score)))
        payload["score"] = float(score)
        if process_index() == 0:
            _atomic_save(payload, os.path.join(self.directory, "best.pt"))
            tmp = os.path.join(self.directory, f".best.json.tmp.{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump({"step": step, "score": float(score)}, f)
            os.replace(tmp, os.path.join(self.directory, "best.json"))
        barrier()
        return True

    def restore(self, state, step: Optional[int] = None):
        """Load a saved step into ``state`` (model, optimizer, step) in place, each tensor laid out as
        the state's (sharded, split over tp, a pp stage or whole); returns (state, metadata)."""
        from .parallel.mesh import distribute_like, load_full_state, split_of
        from .parallel.step import unwrap

        saved = _load_step(self.directory, step)
        load_full_state(unwrap(state.model), saved["state"])
        opt = saved["optimizer"]
        names = [n for n, _ in state.params]
        staged = any(split_of(p) is not None and split_of(p).axis == "pp" for _, p in state.params)
        # a pp stage holds its own blocks' moments; the file holds every stage's
        if not set(names) <= set(opt["mu"]) or (not staged and len(names) != len(opt["mu"])):
            raise RuntimeError("the checkpoint's optimizer state does not fit the model's trained parameters")
        params = [p for _, p in state.params]
        state.opt_state = type(state.opt_state)(int(opt["count"]),
                                                [distribute_like(opt["mu"][n], p) for n, p in zip(names, params)],
                                                [distribute_like(opt["nu"][n], p) for n, p in zip(names, params)])
        state.step = int(saved["step"])
        meta = dict(saved.get("metadata", {}), step=state.step)
        return state, meta

    def restore_params(self, step: Optional[int] = None):
        """(trained state dict, metadata) of a saved step: :func:`load_policy_state` on this directory."""
        return load_policy_state(self.directory, step)

    def wait(self):
        """Saves are synchronous: nothing is in flight."""


def save_pickle(obj, path: str) -> None:
    """Pickle ``obj`` to ``path`` in the reference's format: a :class:`_pickle_compat.ReferenceTrainState`
    in it is written as flax's ``TrainState``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        _pickle_compat.dump(obj, f)


def load_pickle(path: str):
    """Read a reference-format pickle (the JAX package's cloudpickle, or :func:`save_pickle`'s) without
    flax, optax, jax or cloudpickle: a flax TrainState comes back as a ``ReferenceTrainState``, a
    FrozenDict as a dict, a jax array as numpy, an optax object or a function as a placeholder."""
    with open(path, "rb") as f:
        return _pickle_compat.load(f)


def _looks_like_reference_policy(params) -> bool:
    try:
        keys = set(params.keys())
    except AttributeError:
        return False
    return "action_outputs_0" in keys or (
        "policy" in keys and any(k.startswith("Block_") for k in params["policy"].keys())
    )


def load_reference_checkpoint(path: str) -> dict:
    """Load a reference-format pickle checkpoint (``{step, epoch, variant, state}``).

    A reference policy tree (auto-named ``policy/Block_i/...``, one deduplicated ensemble head) is
    converted to the port's Flax-layout tree (numpy), the head broadcast to 5 members whatever the
    model's count, as the JAX package's loader does.  :func:`reference_policy_state` gives the
    policy's state dict.
    """
    from .models.policy.convert import convert_reference_policy_params

    data = load_pickle(path)
    state = data.get("state") if isinstance(data, dict) else None
    params = getattr(state, "params", None) if state is not None else None
    if params is not None and _looks_like_reference_policy(params):
        data["state"] = state.replace(params=convert_reference_policy_params(params)["params"])
    return data


def reference_policy_state(data: dict) -> dict:
    """The policy's state dict (``BasePolicy.load_trained_state_dict`` input) of what
    :func:`load_reference_checkpoint` returned: its ``state.params`` through the weight bridge."""
    from .models.policy.convert import flax_policy_to_torch

    state = data["state"]
    params = state.params if hasattr(state, "params") else state["params"]
    return flax_policy_to_torch(params)


def save_reference_checkpoint(path: str, params, *, step: int = 0, epoch: int = 0, variant: Optional[dict] = None,
                              ensemble_mode: str = "require_tied", pp_stages: int = 1) -> None:
    """Export policy params as a reference-format pickle checkpoint.

    ``params``: the policy's state dict (``trained_state_dict()``), or the policy itself (laid out over a
    mesh or not; every rank calls it then).  ``pp_stages`` above 1 writes the blocks stacked, as the JAX
    package writes a pipelined policy (``policy/stacked_blocks``).  Writes ``{"step", "epoch", "variant", "state"}``, ``state`` a flax ``TrainState`` when
    unpickled with flax (the JAX package's ``load_reference_checkpoint`` and trainer, the
    reference's eval driver read ``state.params``), with ``step`` 0 and the params renamed to the
    reference's names as float32 numpy (models/policy/convert.py::export_reference_policy_params,
    with its ``ensemble_mode`` collapse).

    Unlike the JAX package's file, ``apply_fn``, ``tx`` and ``opt_state`` are None: the optax chain
    cannot be written without optax.  The JAX package's export carries only a freshly initialized
    optimizer state, and none of its readers uses it.
    """
    from .models.policy.convert import export_reference_policy_params, torch_policy_to_flax

    params = gather_to_host(params)  # a laid-out state whole (every rank calls it then)
    exported = export_reference_policy_params(torch_policy_to_flax(params, pp_stages), ensemble_mode=ensemble_mode)
    state = _pickle_compat.ReferenceTrainState(step=0, apply_fn=None, params=exported, tx=None, opt_state=None)
    save_pickle({"step": int(step), "epoch": int(epoch), "variant": dict(variant or {}), "state": state}, path)
