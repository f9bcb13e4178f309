"""Stage 2, labeling with a CLIP ModifiedResNet tower: ``label.py``'s closed loop of the labeler's call,
``ClipRewardEngine.text_rewards_with_features`` on one demo episode of host uint8 frames a call, the text
features computed in set-up, the episodes cycling through a pool drawn from the seed.

What differs from ``label.py``: the weights (``weights_resnet.py``: convolutions by fan-in, BatchNorm's
statistics drawn), the operation count (``roofline_resnet.py``), the reference (``reference/clip_resnet.py``),
the control (the reference with TF32 on in both matmuls and convolutions) and the work a traced run reads: the
convolutions' operations and the window's change in the engine's ``tower_seconds`` (absent on a program
without that counter).  Every reward of every call is compared with the reference's for its frame.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import roofline_resnet, weights, weights_resnet
from ..reference import clip_resnet as ref_rn
from ..reference import tokenizer as ref_tokenizer
from ..trace import window_marker
from . import label


@contextlib.contextmanager
def tf32_scope(on: bool):
    """TF32 in float32 matmuls and cuDNN convolutions while the block runs, as ``on`` says; the flags as
    they were after it."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


class Traffic(label.Traffic):
    def __init__(self, config: dict, params: dict, seed: int, device, fault: str | None = None):
        from arp_tpu_torch.models.clip.model import CLIP
        from arp_tpu_torch.reward.engine import ClipRewardEngine

        self.config, self.params, self.device = config, params, device
        with torch.device(device):
            self.model = CLIP(**{k: config[k] for k in label.CLIP_KEYS}, image_size=config["image_size"])
        self.state = weights_resnet.fill(self.model, seed, device)
        self.engine = ClipRewardEngine(model=self.model, batch_size=params["batch_size"],
                                       resize_mode=params["resize_mode"], device=device)
        if fault in FAULTS:
            FAULTS[fault](self.engine)
        n, size = params["frames_per_call"], params["frame_size"]
        pool = weights.uint8_frames((params["episodes"], n, size, size, 3), seed, device, stream=2)
        self.pool = pool.cpu().numpy()
        del pool
        self.text = label.instruction(params, seed)
        self.txt_feat = self.engine.encode_text_features(self.text)
        self.engine.text_rewards_with_features(self.pool[0], self.txt_feat)  # warm-up: the window's shapes
        self.calls = []

    def window(self, seconds: float, prof=None) -> dict:
        episodes = len(self.pool)
        tower_before = getattr(self.engine, "tower_seconds", None)
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
        layers = (c["vision_features"], c["vision_num_layers"], c["image_size"])
        work = {"model_flops": frames * roofline_resnet.flops_per_frame(*layers, c["embed_dim"]), "dtype": c["dtype"],
                "conv_flops": frames * roofline_resnet.conv_flops_per_frame(*layers)}
        if tower_before is not None:
            work["tower_s"] = self.engine.tower_seconds - tower_before
        return {"metrics": {"label_frames_per_s": frames / elapsed}, "attempted": len(self.calls), "failed": 0,
                "work": work}

    def _reference(self, tf32: bool = False) -> np.ndarray:
        shape = self.pool.shape
        tokens = torch.from_numpy(ref_tokenizer.tokenize(self.text)).to(self.device)
        frames = torch.from_numpy(self.pool.reshape(-1, *shape[2:])).to(self.device)
        with tf32_scope(tf32), torch.no_grad():
            flat = ref_rn.text_rewards(self.state, self.config, frames, tokens)
        return flat.reshape(shape[:2])

    def compare(self) -> dict:
        self.want = self._reference()
        return {"reward_gap": (self._gap(self.want), self.params["limits"]["reward_gap"])}

    def _gap(self, want: np.ndarray) -> float:
        return max(float(np.max(np.abs(np.asarray(r, np.float64) - want[ep]))) for ep, r in self.calls)

    def detail(self) -> dict:
        """The last ``compare``'s gap, and what makes it a check: the spread of the reference's rewards across
        an episode's frames (the standard deviation and the range, the smallest over the episodes), which a call
        answered on its frames in another order would read as its gap."""
        want = self.want
        return {"reward_gap": self._gap(want), "reward_std": float(want.std(axis=1).min()),
                "reward_range": float(np.ptp(want, axis=1).min()), "reward_mean": float(want.mean())}


def _on_second_call(engine, change) -> None:
    """A fault: the engine's second answer (the window's first; the first is the warm-up's) is ``change``d."""
    real, calls = engine.text_rewards_with_features, []

    def faulty(frames, txt_feat):
        calls.append(1)
        return change(real, frames, txt_feat) if len(calls) == 2 else real(frames, txt_feat)

    engine.text_rewards_with_features = faulty


def _altered(real, frames, txt_feat):
    out = np.array(real(frames, txt_feat))
    out[0] += 1.0
    return out


def _shuffled(real, frames, txt_feat):
    """The call's frames answered in reverse order: every reward right, each at another frame's place."""
    return real(np.ascontiguousarray(frames[::-1]), txt_feat)


FAULTS = {"answer_altered": lambda engine: _on_second_call(engine, _altered),
          "frames_shuffled": lambda engine: _on_second_call(engine, _shuffled)}
