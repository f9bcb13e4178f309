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

Not ported: ``load_reference_checkpoint`` and the reference-pickle exporters
(ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

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


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _atomic_save(obj, path: str) -> str:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def policy_payload(step: int, model) -> dict:
    """What every ``step_<n>.pt`` holds: the step and the policy's trained state dict."""
    return {"step": int(step), "state": _host(model.trained_state_dict())}


def state_payload(state, metadata: Optional[dict] = None) -> dict:
    """A train state as one host dict: :func:`policy_payload`, the optimizer's count and moments
    keyed by parameter name, and the metadata."""
    names = [n for n, _ in state.params]
    opt = state.opt_state
    return dict(
        policy_payload(state.step, state.model),
        optimizer={"count": int(opt.count), "mu": dict(zip(names, _host(list(opt.mu)))),
                   "nu": dict(zip(names, _host(list(opt.nu))))},
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
        """Write ``state`` as ``step_<step>.pt`` (complete before it appears); keep the newest files."""
        del wait  # synchronous
        payload = state_payload(state, metadata)
        payload["best_score"] = float(self.best_score)
        _atomic_save(payload, step_path(self.directory, step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(step_path(self.directory, old))

    def save_best(self, step: int, state, score: float, metadata: Optional[dict] = None) -> bool:
        """Keep ``state`` as the best model when ``score`` beats the best so far."""
        if score <= self.best_score:
            return False
        self.best_score = float(score)
        payload = state_payload(state, dict(metadata or {}, step=step, score=float(score)))
        payload["score"] = float(score)
        _atomic_save(payload, os.path.join(self.directory, "best.pt"))
        tmp = os.path.join(self.directory, f".best.json.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({"step": step, "score": float(score)}, f)
        os.replace(tmp, os.path.join(self.directory, "best.json"))
        return True

    def restore(self, state, step: Optional[int] = None):
        """Load a saved step into ``state`` (model, optimizer, step) in place; returns (state, metadata)."""
        saved = _load_step(self.directory, step)
        state.model.load_trained_state_dict(saved["state"])
        opt = saved["optimizer"]
        names = [n for n, _ in state.params]
        if sorted(names) != sorted(opt["mu"]):
            raise RuntimeError("the checkpoint's optimizer state does not fit the model's trained parameters")
        dev = [p.device for _, p in state.params]
        state.opt_state = type(state.opt_state)(int(opt["count"]), [opt["mu"][n].to(d) for n, d in zip(names, dev)],
                                                [opt["nu"][n].to(d) for n, d in zip(names, dev)])
        state.step = int(saved["step"])
        meta = dict(saved.get("metadata", {}), step=state.step)
        return state, meta

    def restore_params(self, step: Optional[int] = None):
        """(trained state dict, metadata) of a saved step: :func:`load_policy_state` on this directory."""
        return load_policy_state(self.directory, step)

    def wait(self):
        """Saves are synchronous: nothing is in flight."""


def load_reference_checkpoint(path: str):
    """The reference's pickled checkpoints: not ported yet."""
    raise NotImplementedError(
        f"loading a reference-format checkpoint ({path}) is not ported yet (ROADMAP Queue 1, item 10)"
    )
