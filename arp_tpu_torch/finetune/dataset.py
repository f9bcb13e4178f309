"""Quadruple dataset for CLIP fine-tuning (port of arp_tpu/finetune/dataset.py).

Each item holds the last stacked frame at indices [traj_start, t, t+1,
traj_end] of the trajectory containing t, the terminal indicator
r = 1(t+1 == traj_end), the tokenized CLIP instruction and the action label.

``action_at``: the reference takes the action at the trajectory start, which
makes the inverse-dynamics target independent of (o_t, o_{t+1}).  The default
is "index" (the action taken at t); "traj_start" gives the reference's.

numpy only; ``h5py`` is imported when a dataset opens its file.
"""

from __future__ import annotations

import numpy as np

from ..config import Config, update_config
from ..data.instructions import get_clip_instruct
from ..models.clip.tokenizer import build_tokenizer


class ProcgenActionDataset:
    @staticmethod
    def get_default_config(updates=None) -> Config:
        config = Config()
        config.path = "../demonstrations"
        config.start_index = 0
        config.max_length = int(1e9)
        config.image_size = 512
        config.num_frames = 8
        config.image_key = "ob"
        config.action_dim = 15
        config.num_demonstrations = 200
        config.window_size = 8
        config.env_type = "none"
        config.action_at = "index"  # "index" | "traj_start" (the reference's)
        # distance-constrained pair sampling (sample_next_index)
        config.target_ratio = 0.8
        config.threshold = 20
        return update_config(config, updates)

    def __init__(self, update, dataset_name="coinrun", split="train", tokenizer=None):
        import h5py

        self.config = self.get_default_config(update)
        self.dataset_name = dataset_name
        self.h5_file = h5py.File(f"{self.config.path}/{dataset_name}/data_{split}.hdf5", "r")
        self.env_name = dataset_name.split("_")[0]
        if self.config.env_type != "none":
            self.env_name = f"{self.env_name}_{self.config.env_type}"
        self.traj_idx = list(np.nonzero(self.h5_file["done"][:, -1])[0] + 1)
        self.traj_idx.insert(0, 0)
        self.idx_to_traj = np.zeros(self.h5_file["done"].shape[0], np.int32)
        for i in range(len(self.traj_idx) - 1):
            self.idx_to_traj[self.traj_idx[i] : self.traj_idx[i + 1]] = i
        self._tokenize = tokenizer or build_tokenizer(truncate=True)
        instruct = get_clip_instruct(self.env_name) or ""
        self._instruct = np.asarray(self._tokenize(instruct)).astype(np.int32)

    def __len__(self):
        return min(self.h5_file["ob"].shape[0] - self.config.start_index, self.config.max_length)

    def sample_next_index(self, index, traj_elems, rng: np.random.Generator):
        """Two trajectory indices at least ``threshold`` steps from ``index``, drawn from ``rng``.

        Rejection-samples up to 10 times, then falls back to the clamped index +- threshold
        pair; threshold = min(len * target_ratio, threshold).  (The reference's sampler, which
        its ``__getitem__`` does not use.)
        """
        traj_elems = np.asarray(traj_elems)
        threshold = min(int(len(traj_elems) * self.config.target_ratio), self.config.threshold)
        for _ in range(10):
            next_index = rng.choice(traj_elems, 2)
            if np.all(np.abs(next_index - index) >= threshold):
                return list(next_index)
        return [max(index - threshold, traj_elems[0]), min(index + threshold, traj_elems[-1])]

    def __getitem__(self, index):
        index = index + self.config.start_index
        traj = self.idx_to_traj[index]
        start = self.traj_idx[traj]
        end = self.traj_idx[traj + 1] - 1
        indices = sorted([start, index, min(index + 1, end), end])

        res = {f"image{i}": {} for i in range(4)}
        for i, idx in enumerate(indices):
            for key in self.config.image_key.split(", "):
                res[f"image{i}"][key] = self.h5_file[key][idx][-1]
        res["r"] = np.array([int(indices[-2] == indices[-1])], np.int32)
        res["instruct"] = self._instruct
        action_idx = start if self.config.action_at == "traj_start" else index
        res["action"] = np.asarray(self.h5_file["act"][action_idx][-1])
        return res

    @property
    def num_actions(self):
        return self.config.action_dim
