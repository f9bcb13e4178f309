"""Batched CLIP reward engine on one GPU (port of arp_tpu/reward/engine.py, standard path).

Per fixed-size padded batch of uint8 frames:

    packed (B, H, W*C) frames -> bit-exact Pillow resize, normalize, patchify
    -> ViT image tower (attention through kernel K1 on CUDA)
    -> L2-normalized or raw float32 features

A producer thread slices and pads host chunks and pins them, so the HDF5 read
of the next batches overlaps the device's work on this one; each chunk goes
to the device with a ``non_blocking`` copy, and the device work is queued
without waiting.  Rewards are computed on the host in numpy, as in the JAX
engine:

  * text rewards: ``exp(logit_scale) * cos(f_img, f_text)``, the mean over
    texts when several are given;
  * goal-conditioned rewards: ``-||f_img - f_goal||_2`` on unnormalized features.

With ``compute_dtype=torch.bfloat16`` the image tower's weights and inputs are
cast to bf16; the text tower and ``logit_scale`` stay float32, as in the JAX
engine, which casts only inside its image-encode program.

Not ported yet (each raises ``NotImplementedError``): the ``host`` and
``fast`` resize modes, ``use_crop``, ``quantize_weights``, the
``fast_encode``/``fast_int8`` paths and ``mesh``.  The TPU's 64-multiple
batch guard is left out.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.clip.convert import flax_to_torch, read_engine_spec
from ..models.clip.model import CLIP, MODELS
from ..models.clip.tokenizer import Char97Tokenizer, build_tokenizer
from ..ops.preprocess import clip_preprocess_packed_patches

_DTYPES = (torch.float32, torch.bfloat16)


class ClipRewardEngine:
    """Streams uint8 frames through preprocess + encode on ``device``; scores on the host.

    Args:
      model_name: key into ``arp_tpu_torch.models.clip.MODELS`` (default CLIP
        ViT-B/16), used when ``model`` is None.
      variables: CLIP weights in ``arp_tpu``'s Flax layout (nested mappings or
        flattened ``"params/a/b"`` keys; see ``models/clip/convert.py``).  May
        be None only when ``model`` already holds its weights: loading the
        OpenAI checkpoints is not ported yet.
      batch_size: fixed device batch; inputs are padded to multiples.
      compute_dtype: torch.float32 or torch.bfloat16 for the image tower.
      device: where the towers run, e.g. "cuda" or "cpu".  CUDA without a GPU
        raises.
    """

    def __init__(
        self,
        model_name: str = "vit_b16",
        variables=None,
        batch_size: int = 256,
        resize_mode: str = "pil",
        use_crop: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        tokenizer=None,
        model: Optional[CLIP] = None,
        device: Union[str, torch.device] = "cuda",
        quantize_weights: bool = False,
        fast_encode: bool = False,
        fast_int8: bool = False,
        mesh=None,
    ):
        unported = {
            "resize_mode != 'pil'": resize_mode != "pil",
            "use_crop": use_crop,
            "quantize_weights": quantize_weights,
            "fast_encode": fast_encode,
            "fast_int8": fast_int8,
            "mesh": mesh is not None,
        }
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(f"ClipRewardEngine({what}) is not ported yet (ROADMAP.md)")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {_DTYPES}, got {compute_dtype}")
        self.device = resolve_device(device)
        if variables is None and model is None:
            raise NotImplementedError("loading the OpenAI CLIP checkpoints is not ported yet: pass variables")
        if model is None:
            model = MODELS[model_name]()
        if variables is not None:
            model.load_state_dict(flax_to_torch(variables))
        model.eval().to(self.device)
        model.visual.to(compute_dtype)
        self.model = model
        self.logit_scale = float(np.exp(model.logit_scale.item()))
        self.batch_size = batch_size
        self.image_size = model.image_size
        self.compute_dtype = compute_dtype
        self._tokenizer = tokenizer
        # provenance stamped onto labeled datasets; "torch;" keeps port labels
        # apart from the JAX engine's
        dtype_name = str(compute_dtype).removeprefix("torch.")
        self._recipe = f"torch;{dtype_name};score=float32;resize=pil;crop=0;wq=0"

    @classmethod
    def from_npz(cls, path: str, **engine_kwargs):
        """Rebuild an engine from an ``arp_tpu`` ``ClipRewardEngine.save_npz`` spec.

        ``engine_kwargs`` set runtime knobs (batch_size, compute_dtype,
        device, ...); the model config, weights, tokenizer and image size come
        from the file.
        """
        meta, flat = read_engine_spec(path)
        cfg = dict(meta["clip_config"])
        if isinstance(cfg["vision_num_layers"], list):
            raise NotImplementedError("the ModifiedResNet image towers are not ported yet")
        tokenizer = Char97Tokenizer() if meta["tokenizer"] == "char97" else None
        # "bpe:<sha16>"/"fallback"/"custom": leave None -> the engine lazily
        # builds the standard BPE tokenizer (same vocab given the merges file)
        model = CLIP(**cfg, image_size=meta["image_size"])
        return cls(model=model, variables=flat, tokenizer=tokenizer, **engine_kwargs)

    # -- tokenization ---------------------------------------------------------

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            self._tokenizer = build_tokenizer(truncate=True)
        return self._tokenizer

    def tokenize(self, text: Union[str, Sequence[str]]) -> np.ndarray:
        return np.asarray(self.tokenizer(text))

    @property
    def tokenizer_identity(self) -> str:
        """Provenance string for labeled outputs: "bpe:<sha16>" with the real
        merges file, "fallback" under the byte-level fallback vocab, "custom"
        for injected tokenizers without identity metadata."""
        tok = getattr(self.tokenizer, "tokenizer", None)
        return getattr(tok, "identity", None) or "custom"

    @property
    def encode_recipe(self) -> str:
        """Provenance string for the numeric path that produces rewards."""
        return self._recipe

    # -- feature extraction ---------------------------------------------------

    @torch.inference_mode()
    def _encode_chunk(self, frames: torch.Tensor, normalize: bool) -> torch.Tensor:
        """One device batch of packed uint8 frames (B, H, W*C) -> float32 features."""
        x = clip_preprocess_packed_patches(
            frames, channels=3, image_size=self.image_size,
            patch_size=self.model.vision_patch_size,
        )
        feat = self.model.encode_image(x.to(self.compute_dtype), normalize=False).float()
        if normalize:
            feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
        return feat

    def _batched_image_features(self, frames, normalize: bool) -> np.ndarray:
        """Encode (N, H, W, C) uint8 frames in fixed-size padded batches.

        ``frames`` is anything that slices like an array (an ndarray, or the
        labeler's lazy HDF5 window).
        """
        n = frames.shape[0]
        if n == 0:
            raise ValueError("no frames to encode")
        bs = self.batch_size
        pin = self.device.type == "cuda"

        def host_stage(start: int) -> torch.Tensor:
            chunk = np.asarray(frames[start : start + bs])
            if chunk.shape[0] < bs:
                pad = np.repeat(chunk[-1:], bs - chunk.shape[0], axis=0)
                chunk = np.concatenate([chunk, pad], axis=0)
            # (B, H, W, C) -> packed (B, H, W*C)
            chunk = torch.from_numpy(np.ascontiguousarray(chunk).reshape(bs, chunk.shape[1], -1))
            return chunk.pin_memory() if pin else chunk

        outputs = []
        starts = list(range(0, n, bs))
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = deque(pool.submit(host_stage, s) for s in starts[:2])
            for k in range(len(starts)):
                if k + 2 < len(starts):
                    pending.append(pool.submit(host_stage, starts[k + 2]))
                chunk = pending.popleft().result()
                outputs.append(self._encode_chunk(chunk.to(self.device, non_blocking=True), normalize))
        return torch.cat(outputs).cpu().numpy()[:n]

    def encode_image_features(self, frames, normalize: bool = True) -> np.ndarray:
        """Public batched image-feature extraction (streaming, padded batches)."""
        return self._batched_image_features(frames, normalize=normalize)

    @torch.inference_mode()
    def encode_text_features(self, text: Union[str, Sequence[str], np.ndarray]) -> np.ndarray:
        """L2-normalized float32 text features, (n_text, embed_dim)."""
        tokens = self.tokenize(text) if isinstance(text, (str, list, tuple)) else np.asarray(text)
        tokens = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        return self.model.encode_text(tokens, normalize=True).float().cpu().numpy()

    # -- rewards --------------------------------------------------------------

    def text_rewards_with_features(self, frames, txt_feat: np.ndarray) -> np.ndarray:
        """Text rewards against precomputed (normalized) text features."""
        img_feat = self._batched_image_features(frames, normalize=True)
        logits_per_text = self.logit_scale * (txt_feat @ img_feat.T)  # (n_text, N)
        if logits_per_text.shape[0] > 1:
            return logits_per_text.mean(axis=0)
        return logits_per_text[0]

    def text_rewards(self, frames, text: Union[str, Sequence[str], np.ndarray]) -> np.ndarray:
        """logit_scale * cosine(image, text); averaged over multiple texts."""
        return self.text_rewards_with_features(frames, self.encode_text_features(text))

    def goal_rewards_with_features(self, frames, goal_feat: np.ndarray) -> np.ndarray:
        """-||f(img) - f(goal)||_2 against precomputed unnormalized goal
        features ((D,) shared or (N, D) per-frame)."""
        feats = self._batched_image_features(frames, normalize=False)
        return -np.linalg.norm(feats - np.atleast_2d(goal_feat), axis=-1)

    def goal_rewards(self, frames, goal_index: int = -1) -> np.ndarray:
        """-||f(img) - f(goal)||_2 on unnormalized features; the goal is the
        frame at ``goal_index`` within ``frames``."""
        feats = self._batched_image_features(frames, normalize=False)
        return -np.linalg.norm(feats - feats[goal_index][None], axis=-1)

    def goal_rewards_vs(self, frames, goal_frame: np.ndarray) -> np.ndarray:
        """Goal rewards against an explicit goal image."""
        goal = self._batched_image_features(goal_frame[None], normalize=False)[0]
        return self.goal_rewards_with_features(frames, goal)
