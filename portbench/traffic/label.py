"""Stage 2, labeling: a closed loop of the labeler's call on one engine.

Each call is ``ClipRewardEngine.text_rewards_with_features`` on one demo episode of host uint8 frames
(``frames_per_call`` of ``frame_size``² × 3), with the instruction's text features computed in set-up as the
labeler caches them.  The episodes cycle through a pool of ``episodes`` drawn from the seed.  Every reward of
every call is compared with the reference's reward for its frame.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import roofline, weights
from ..reference import clip as ref_clip
from ..reference import tokenizer as ref_tokenizer
from ..trace import window_marker

CLIP_KEYS = ("vocab_size", "embed_dim", "text_features", "text_num_layers", "text_num_heads", "vision_features",
             "vision_num_layers", "vision_patch_size")


def build_clip(config: dict, seed: int, device):
    """The port's CLIP module on ``device`` with weights drawn from the seed, and the weights' copies."""
    from arp_tpu_torch.models.clip.model import CLIP

    with torch.device(device):
        model = CLIP(**{k: config[k] for k in CLIP_KEYS}, image_size=config["image_size"])
    return model, weights.fill(model.named_parameters(), seed, device, stream=1)


def instruction(params: dict, seed: int) -> str:
    return params["instructions"][int(np.random.default_rng(seed).integers(len(params["instructions"])))]


def reference_rewards(state: dict, config: dict, frames: np.ndarray, text: str, device, tf32: bool = False):
    """The reference's rewards for (N, H, W, 3) host frames, in float32 (TF32 under ``tf32``)."""
    tokens = torch.from_numpy(ref_tokenizer.tokenize(text)).to(device)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            return ref_clip.text_rewards(state, config, torch.from_numpy(frames).to(device), tokens)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class Traffic:
    def __init__(self, config: dict, params: dict, seed: int, device, fault: str | None = None):
        from arp_tpu_torch.reward.engine import ClipRewardEngine

        self.config, self.params, self.device = config, params, device
        self.model, self.state = build_clip(config, seed, device)
        self.engine = ClipRewardEngine(model=self.model, batch_size=params["batch_size"],
                                       resize_mode=params["resize_mode"], device=device)
        if fault == "answer_altered":
            alter_one_answer(self.engine)
        n, size = params["frames_per_call"], params["frame_size"]
        pool = weights.uint8_frames((params["episodes"], n, size, size, 3), seed, device, stream=2)
        self.pool = pool.cpu().numpy()
        del pool
        self.text = instruction(params, seed)
        self.txt_feat = self.engine.encode_text_features(self.text)
        self.engine.text_rewards_with_features(self.pool[0], self.txt_feat)  # warm-up: the window's one shape
        self.calls = []

    def window(self, seconds: float, prof=None) -> dict:
        episodes = len(self.pool)
        with window_marker(prof):
            start = time.perf_counter()
            while True:
                ep = len(self.calls) % episodes
                self.calls.append((ep, self.engine.text_rewards_with_features(self.pool[ep], self.txt_feat)))
                if time.perf_counter() - start >= seconds:
                    break
            elapsed = time.perf_counter() - start
        c = self.config
        frames = len(self.calls) * self.pool.shape[1]
        per_frame = roofline.vit_flops_per_frame(c["vision_features"], c["vision_num_layers"],
                                                 c["vision_patch_size"], c["image_size"], c["embed_dim"])
        tokens = (c["image_size"] // c["vision_patch_size"]) ** 2 + 1
        heads = c["vision_features"] // 64
        work = {"model_flops": frames * per_frame, "dtype": c["dtype"],
                "k1": {"64": [self.params["batch_size"], tokens, heads, 64, c["dtype"]]}}
        return {"metrics": {"label_frames_per_s": frames / elapsed}, "attempted": len(self.calls), "failed": 0,
                "work": work}

    def release(self) -> None:
        del self.engine, self.model
        gc.collect()

    def _reference(self, tf32: bool = False) -> np.ndarray:
        shape = self.pool.shape
        flat = reference_rewards(self.state, self.config, self.pool.reshape(-1, *shape[2:]), self.text,
                                 self.device, tf32)
        return flat.reshape(shape[:2])

    def compare(self) -> dict:
        want = self._reference()
        gap = max(float(np.max(np.abs(np.asarray(r, np.float64) - want[ep]))) for ep, r in self.calls)
        return {"reward_gap": (gap, self.params["limits"]["reward_gap"])}

    def control(self) -> dict:
        want, low = self._reference(), self._reference(tf32=True)
        return {"reward_gap": float(np.max(np.abs(low - want)))}


def alter_one_answer(engine) -> None:
    """A fault: the engine's twentieth answer has its first reward moved by 1."""
    real, calls = engine.text_rewards_with_features, []

    def altered(frames, txt_feat):
        out = np.array(real(frames, txt_feat))
        calls.append(1)
        if len(calls) == 20:
            out[0] += 1.0
        return out

    engine.text_rewards_with_features = altered
