"""HDF5-backed Procgen demonstration dataset (port of arp_tpu/data/procgen_dataset.py).

A copy of the JAX package's numpy dataset: the same file layout, trajectory
indexing, RTG preprocessing (min-normalization, per-trajectory discounted
cumsum, frame stacking), hindsight goal sampling, window slicing and
instruction tokenization.  Its ``ConfigDict`` is the port's
:class:`arp_tpu_torch.config.Config`.  ``h5py`` is imported when a file is
opened, so that the train step's modules import where it is missing.

Per-host sharding: ``start_offset_ratio = process_index / process_count``.
``use_arps``: the image keys are converted once into ARPS shards beside the
file (``<file>.hdf5.arps/{key}.arps``, data/arps.py) and their records read
through the native reader.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import Config, update_config
from ..ops.rewards import discount_cumsum, stack_frames
from .instructions import get_m3ae_instruct


def compute_scale(return_to_go) -> float:
    """Power of ten that puts the normalized return-to-go in roughly [0.5, 5] (arp_tpu/utils.py)."""
    s = str(abs(int(return_to_go)))  # int(-0.5) is "0": sign-free digits
    max_digit = int(s[0])
    n = len(s) - 1 if max_digit < 5 else len(s)
    return pow(10, n)


def _hash_ids(instruct: str, max_length: int):
    """The deterministic hash vocabulary: word -> id in [1000, 29000), PAD = 1.0 in the mask."""
    words = instruct.lower().replace(".", " .").replace(",", " ,").split()
    ids = np.zeros(max_length, np.int32)
    for i, w in enumerate(words[:max_length]):
        h = 2166136261
        for ch in w.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        ids[i] = 1000 + (h % 28000)
    pad = np.ones(max_length, np.float32)
    pad[: min(len(words), max_length)] = 0.0
    return ids, pad


def build_instruction_tokenizer(use_bert: bool = True, max_length: int = 77, vocab_path: Optional[str] = None):
    """Instruction tokenizer: BERT wordpiece (a local vocabulary file, else the hash fallback) or CLIP BPE.

    Returns fn(text) -> (ids int32[max_length], padding_mask float32[max_length]) with
    padding_mask 1.0 = PAD.  The vocabulary is looked up in the explicit path,
    ``$ARP_TPU_BERT_VOCAB``, ``arp_tpu_torch/assets/`` and the cache; nothing is fetched.
    """
    if use_bert:
        from ..models.clip.tokenizer import resolve_asset

        tokenizer = None
        vocab_path = resolve_asset("bert_base_uncased_vocab.txt", explicit=vocab_path, env_var="ARP_TPU_BERT_VOCAB")
        if vocab_path:
            from transformers import BertTokenizer

            tokenizer = BertTokenizer(vocab_file=vocab_path)

        def tokenizer_fn(instruct: str):
            if len(instruct) == 0:
                return np.zeros(max_length, np.int32), np.ones(max_length, np.float32)
            if tokenizer is not None:
                enc = tokenizer(instruct, padding="max_length", truncation=True, max_length=max_length,
                                return_tensors="np", add_special_tokens=False)
                return enc["input_ids"][0].astype(np.int32), 1.0 - enc["attention_mask"][0].astype(np.float32)
            return _hash_ids(instruct, max_length)

        return tokenizer_fn

    from ..models.clip.tokenizer import build_tokenizer as build_clip_tokenizer

    clip_tok = build_clip_tokenizer(truncate=True)

    def tokenizer_fn(instruct: str):
        ids = np.asarray(clip_tok(instruct)[0]).astype(np.int32)
        # an all-ones mask, as the reference's: the CLIP text tower ignores it
        return ids, np.ones(max_length, np.float32)

    return tokenizer_fn


class ProcgenDataset:
    @staticmethod
    def get_default_config(updates=None) -> Config:
        config = Config()
        config.path = "../demonstrations"
        config.start_index = 0
        config.max_length = int(1e9)
        config.random_start = False
        config.image_size = 512
        config.num_frames = 8
        config.state_key = ""
        config.state_dim = 0
        config.image_key = "ob"
        config.action_dim = 15
        config.num_demonstrations = 200
        config.num_subset = -1
        config.window_size = 8
        config.use_bert_tokenizer = True
        config.tokenizer_max_length = 77
        config.augmentations = "random_crop,color_jitter"
        config.enable_filter = True
        config.scale = 100.0
        config.use_task_reward = False
        config.use_normalize = False
        config.train_env_type = "none"
        config.use_vl = False
        config.vl_type = "clip"
        config.inst_type = "none"
        # read image records through ARPS shards (converted once beside the HDF5; C++ decompression)
        config.use_arps = False
        # precomputed frozen-encoder embeddings ({key}_{name}_emb) instead of raw frames
        config.use_cached_embeddings = False
        config.embedding_name = "clip"
        return update_config(config, updates)

    def __init__(self, update, dataset_name="reach_target", start_offset_ratio=None, split="train"):
        import h5py

        self.config = self.get_default_config(update)
        assert self.config.path != ""
        self.dataset_name = dataset_name
        self.split = split

        path = f"{self.config.path}/{dataset_name}/data_{split}.hdf5"
        self.data_path = path
        self.h5_file = h5py.File(path, "r")

        self.env_name = dataset_name.split("_")[0]
        if self.config.train_env_type != "none":
            self.env_name = f"{self.env_name}_{self.config.train_env_type}"

        h5_num_frames = self.h5_file["ob"][0].shape[0]
        # strictly greater, as the reference asserts
        assert h5_num_frames > self.config.window_size, (
            f"file has {h5_num_frames} stacked frames <= window_size {self.config.window_size}"
        )
        self.window_size = self.config.window_size

        self.tokenizer = build_instruction_tokenizer(self.config.use_bert_tokenizer, self.config.tokenizer_max_length)
        self.h5_file_traj_idx = self.get_traj_idx()

        # after h5_file_traj_idx: __len__ reads it when num_subset != -1
        if self.config.random_start:
            self.random_start_offset = np.random.default_rng().choice(len(self))
        elif start_offset_ratio is not None:
            self.random_start_offset = int(len(self) * start_offset_ratio) % len(self)
        else:
            self.random_start_offset = 0
        self.idx_to_traj = self.index_to_traj()
        self._arps = {}
        if self.config.use_arps:
            self._init_arps(path)
        if self.config.use_vl and not self.config.use_task_reward:
            # task-reward mode reads h5["rtg"] and never the VL rtgs
            self.rtgs = self.preprocess_rtgs()
        # the tokenized instruction is one per dataset
        instruct = get_m3ae_instruct(self.env_name) or ""
        self._instruct_ids, self._instruct_pad = self.tokenizer(instruct)
        self._epoch_seed = 0

    def set_epoch_seed(self, seed: int) -> None:
        """Seed of the per-item stream (hindsight goals); the loader sets it once an epoch."""
        self._epoch_seed = int(seed)

    def _init_arps(self, h5_path: str) -> None:
        from .arps import ArpsReader, convert_hdf5

        shard_dir = h5_path + ".arps"
        keys = self.config.image_key.split(", ")
        if not all(os.path.exists(os.path.join(shard_dir, f"{k}.arps")) for k in keys):
            convert_hdf5(h5_path, shard_dir, keys=keys)
        for k in keys:
            self._arps[k] = ArpsReader(os.path.join(shard_dir, f"{k}.arps"))

    def _read_frames(self, key: str, index: int):
        if key in self._arps:
            return self._arps[key].read_batch([index])[0]
        return self.h5_file[key][index]

    def close(self) -> None:
        for reader in self._arps.values():
            reader.close()
        self.h5_file.close()

    def __len__(self):
        if self.split == "train" and self.config.num_subset != -1:
            return self.h5_file_traj_idx[self.config.num_subset]
        return min(self.h5_file["ob"].shape[0] - self.config.start_index, self.config.max_length)

    def get_traj_idx(self):
        traj_idx = list(np.nonzero(self.h5_file["done"][:, -1])[0] + 1)
        traj_idx.insert(0, 0)
        return traj_idx

    def index_to_traj(self):
        idx_to_traj = np.zeros(self.h5_file["done"].shape[0], dtype=np.int32)
        for i in range(len(self.h5_file_traj_idx) - 1):
            idx_to_traj[self.h5_file_traj_idx[i]: self.h5_file_traj_idx[i + 1]] = i
        return idx_to_traj

    def _reward_dataset_key(self, image_key: str) -> str:
        """``{key}_{vl_type}_pos_reward`` (the reference's) or ``{key}_{vl_type}_reward`` (the labeler's)."""
        suffix = "" if self.config.inst_type == "none" else f"_{self.config.inst_type}"
        for cand in (f"{image_key}_{self.config.vl_type}_pos_reward{suffix}",
                     f"{image_key}_{self.config.vl_type}_reward{suffix}"):
            if cand in self.h5_file:
                return cand
        raise KeyError(
            f"no labeled rewards for {image_key!r}/{self.config.vl_type!r} in {self.dataset_name}; "
            f"run arp_tpu_torch.reward.labeler first"
        )

    def preprocess_rtgs(self):
        """Min-normalize rewards, per-trajectory cumsum, frame-stack; pick the return-to-go and scale."""
        image_keys = self.config.image_key.split(", ")
        reward = {key: self.h5_file[self._reward_dataset_key(key)][:, -1].astype(np.float32) for key in image_keys}
        self.reward_min = {key: float(np.min(r)) for key, r in reward.items()}
        self.reward_max = {key: float(np.max(r)) for key, r in reward.items()}

        if self.config.use_normalize:
            reward = {key: r - self.reward_min[key] for key, r in reward.items()}

        rtgs = {}
        for key, r in reward.items():
            rows = np.zeros((len(r), self.config.num_frames), np.float32)
            for i in range(len(self.h5_file_traj_idx) - 1):
                sl = slice(self.h5_file_traj_idx[i], self.h5_file_traj_idx[i + 1])
                rows[sl] = stack_frames(discount_cumsum(r[sl], 1.0), self.config.num_frames)
            rtgs[key] = rows

        all_rtgs = np.concatenate([v.reshape(-1) for v in rtgs.values()])
        if "coinrun" in self.env_name:
            self.return_to_go = float(np.max(all_rtgs) // 100 * 100)
        else:
            self.return_to_go = float(np.quantile(all_rtgs, 0.9) // 100 * 100)
        self.scale = compute_scale(self.return_to_go)
        self.config.scale = self.scale
        return rtgs

    def process_index(self, index):
        index = (index + self.random_start_offset) % len(self)
        return index + self.config.start_index

    def __getitem__(self, index):
        index = self.process_index(index)
        # a per-index stream: hindsight-goal draws repeat across runs, workers and resumes
        rng = np.random.RandomState((self._epoch_seed + index) % (2 ** 31 - 1))
        res = {"image": {}, "rtg": {}, "goal": {}}
        traj = self.idx_to_traj[index]
        traj_start = self.h5_file_traj_idx[traj]
        traj_end = self.h5_file_traj_idx[traj + 1]
        # hindsight goals: uniform over the future of the same trajectory, one draw an image key
        image_keys = self.config.image_key.split(", ")
        goal_indices = {key: min(int(rng.randint(index, traj_end)), self.h5_file["ob"].shape[0] - 1)
                        for key in image_keys}
        if self.config.use_cached_embeddings:
            res["image_emb"] = {}
            res["goal_emb"] = {}

            def emb_window(emb_key, center):
                # a window of per-step embeddings; steps before the trajectory start repeat it
                w = self.window_size
                idx = np.clip(np.arange(center - w + 1, center + 1), traj_start, center)
                lo, hi = int(idx[0]), int(idx[-1])
                block = self.h5_file[emb_key][lo: hi + 1]
                return block[idx - lo].astype(np.float32)

            for key in image_keys:
                emb_key = f"{key}_{self.config.embedding_name}_emb"
                res["image_emb"][key] = emb_window(emb_key, index)
                res["goal_emb"][key] = emb_window(emb_key, goal_indices[key])
        for key in image_keys:
            res["image"][key] = self._read_frames(key, index)[-self.window_size:]
            res["goal"][key] = self._read_frames(key, goal_indices[key])[-self.window_size:]
            if self.config.use_vl:
                if self.config.use_task_reward:
                    rtg = (
                        self.h5_file["rtg"][index][-self.window_size:][..., None]
                        - self.h5_file["rtg"][index][-self.window_size][..., None]
                    ) / self.config.scale
                else:
                    rtg = self.rtgs[key][index][-self.window_size:][..., None] / self.config.scale
                res["rtg"][key] = rtg.astype(np.float32)
        if self.config.state_key != "":
            res["state"] = np.concatenate(
                [self.h5_file[k][index] for k in self.config.state_key.split(", ")], axis=-1
            )[-self.window_size:]
        res["action"] = self.h5_file["act"][index][-self.window_size:]
        res["instruct"] = self._instruct_ids
        res["text_padding_mask"] = self._instruct_pad
        return res

    @property
    def num_actions(self):
        return self.config.action_dim

    @property
    def obs_shape(self):
        res = {"image": {}, "rtg": {}}
        for key in self.config.image_key.split(", "):
            res["image"][key] = (self.config.image_size, self.config.image_size, 3)
            res["rtg"][key] = (1,)
        if self.config.state_key != "":
            res["state"] = self.config.state_dim
        return res


def dataset_dirname(game_name: str, distribution_mode: str = "hard", start_level: int = 0, num_levels: int = 500,
                    num_demonstrations: int = 200, num_frames: int = 8, enable_filter: bool = True,
                    env_type: str = "none") -> str:
    """The dataset directory's name, as the reference names it."""
    name = f"{game_name}_{distribution_mode}_level{start_level}to{num_levels}_num{num_demonstrations}_frame{num_frames}"
    if not enable_filter:
        name += "_unfiltered"
    if env_type != "none":
        name += f"_{env_type}"
    return name
