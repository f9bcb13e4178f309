"""Metrics logging (port of arp_tpu/logging_utils.py): a local JSONL stream, and wandb when
asked for (``online``) and importable.

Each experiment writes ``<output_dir>/<experiment_id>/metrics.jsonl`` and
``variant.json``; :meth:`MetricsLogger.log_video` writes rollout videos beside them.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import uuid
from copy import copy
from socket import gethostname
from typing import Optional

import numpy as np

from .config import Config, update_config


class MetricsLogger:
    @staticmethod
    def get_default_config(updates=None) -> Config:
        config = Config()
        config.online = False
        config.prefix = "arp-tpu"
        config.project = "arp-tpu-procgen"
        config.output_dir = "/tmp/arp_tpu"
        config.random_delay = 0.0
        config.experiment_id = None
        config.experiment_name = None
        config.notes = None
        return update_config(config, updates)

    def __init__(self, config, variant: Optional[dict] = None, enable: bool = True):
        self.enable = enable
        self.config = self.get_default_config(config)

        if self.config.experiment_name is None:
            self.config.experiment_name = uuid.uuid4().hex[:8]
        if self.config.experiment_id is None:
            self.config.experiment_id = uuid.uuid4().hex[:8]
        if self.config.prefix:
            self.config.experiment_id = f"{self.config.prefix}--{self.config.experiment_id}"

        self._variant = copy(variant or {})
        self._variant.setdefault("hostname", gethostname())

        self.run = None
        self._jsonl = None
        if self.enable:
            if not self.config.output_dir:
                self.config.output_dir = tempfile.mkdtemp()
            else:
                self.config.output_dir = os.path.join(self.config.output_dir, self.config.experiment_id)
            os.makedirs(self.config.output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(self.config.output_dir, "metrics.jsonl"), "a")
            with open(os.path.join(self.config.output_dir, "variant.json"), "w") as f:
                json.dump(_jsonable(self._variant), f, indent=2, default=str)
            if self.config.online:
                if self.config.random_delay > 0:
                    time.sleep(np.random.uniform(0, self.config.random_delay))  # stagger the workers' wandb.init
                try:
                    import wandb

                    self.run = wandb.init(reinit=True, config=self._variant, project=self.config.project,
                                          dir=self.config.output_dir, name=self.config.experiment_name,
                                          id=self.config.experiment_id, notes=self.config.notes)
                except Exception:
                    self.run = None

    def log(self, metrics: dict, step: Optional[int] = None):
        if not self.enable:
            return
        record = _jsonable(metrics)
        record["_time"] = time.time()
        if step is not None:
            record["_step"] = step
        self._jsonl.write(json.dumps(record, default=str) + "\n")
        self._jsonl.flush()
        if self.run is not None:
            self.run.log(metrics, step=step)

    def log_video(self, key: str, frames: np.ndarray, fps: int = 20):
        """frames: (T, H, W, C) uint8 -> mp4 in the output dir (a GIF without an mp4 backend).
        Best effort, as in the JAX package: a failure to encode (no imageio) is logged, not raised."""
        if not self.enable:
            return
        try:
            from .video import save_video

            path = os.path.join(self.config.output_dir, f"{key.replace('/', '_')}.mp4")
            path = save_video(frames, path, fps=fps)  # the path it wrote: .gif when it fell back
            self.log({f"{key}_path": path})
        except Exception as e:  # video encoding is best-effort
            self.log({f"{key}_error": str(e)})

    @property
    def output_dir(self):
        return self.config.output_dir

    @property
    def experiment_id(self):
        return self.config.experiment_id

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self.run is not None:
            self.run.finish()


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.generic, np.ndarray)) and np.asarray(v).size == 1:
            out[k] = float(np.asarray(v).reshape(()))
        elif hasattr(v, "item") and getattr(v, "numel", lambda: getattr(v, "size", 2))() == 1:
            out[k] = v.item()
        elif isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
        else:
            out[k] = str(v)
    return out
