"""CLIP multiscale adapter, the ARP-DT+ reward model (port of arp_tpu/finetune/adapter_model.py).

A frozen CLIP ViT whose per-block CLS (image) and EOT (text) features are
concatenated with the final embedding, projected, passed through gated
adapter MLPs, and trained with

  * the VIP loss over (first, t, t+1, last) quadruples:
      (1-γ)·E[-s_0] + log(ε + E[exp(-(r + γ·s_2 - s_1))]),  γ = 0.98
  * an inverse-dynamics loss predicting the action from
      (f(o_t) ∥ f(text), f(o_{t+1}) ∥ f(text)), weighted by a learnable λ;
  * optionally a time-contrastive triplet loss (off by default).

The frozen CLIP (an ``arp_tpu_torch.models.clip.CLIP``) is passed in to every
call and runs under ``torch.no_grad()``: its parameters are not the adapter's,
no optimizer sees them, and autograd keeps none of its activations.  Its
attention takes kernel K1 on CUDA.  The adapter's parameter names are its Flax
paths joined with dots (finetune/convert.py is the bridge).

Kept from the reference, each pinned by a test:
  * the vision intermediates read only the first ``text_num_layers`` blocks
    (the text tower's depth);
  * the residual gate is ``res·feature + (1-res)·adapter(feature)`` with
    ``res = sigmoid(weight)``, weight 4.0 at init;
  * ``lambda_id`` is a raw multiplier of the inverse-dynamics loss;
  * ``AdapterMLP`` applies a ReLU after its last Linear too, so the action
    logits are >= 0;
  * text features of (B, n_text, 77) tokens are the mean over n_text; the EOT
    token is the argmax of the ids.

Random draws: ``draw_preprocess`` takes the training augmentation's parameters
(one color-jitter draw shared by the whole batch, applied with probability
0.75) from the caller's ``torch.Generator``; ``preprocess`` applies them.

Several processes: the VIP loss's ``log(ε + E[exp(...)])`` is not a mean of
per-example terms, so a mean of the ranks' losses would be another loss.  With
``batch_group`` set (finetune/train.py under ``--mesh_dp``), the inner mean is
the global batch's, through an autograd-aware all-reduce of the rows' sum: the
average of the ranks' gradients is then the global batch's gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.clip.model import CONFIGS
from ..models.layers import AdapterMLP
from ..ops.augment import apply_color_jitter, draw_color_jitter
from ..ops.preprocess import CLIP_MEAN, CLIP_STD, clip_preprocess

JITTER = dict(brightness=0.1, contrast=0.2, saturation=0.2, hue=0.03)  # kornia ColorJitter of the reference
JITTER_P = 0.75


def _lecun_normal_(weight: torch.Tensor) -> None:
    """Flax ``Dense``'s default kernel init: a normal of variance 1 / fan_in truncated at 2 sigma."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class ClipMultiscaleAdapter(nn.Module):
    """The adapter head over a frozen CLIP; ``clip_config`` (default ``CONFIGS[clip_model_name]``)
    gives the widths.  ``hidden_dim`` 0 means twice the CLIP embedding width."""

    def __init__(self, clip_model_name: str = "vit_b16", clip_config: Optional[dict] = None, hidden_dim: int = 0,
                 action_dim: int = 15, num_layers: int = 2, use_discrete_action: bool = True,
                 use_vip_loss: bool = True, use_id_loss: bool = True, goal_conditioned: bool = False,
                 gamma: float = 0.98, use_tcn_loss: bool = False, tcn_margin: float = 1.0):
        super().__init__()
        cfg = clip_config or CONFIGS[clip_model_name]
        # the TEXT tower's depth, for the vision intermediates too (the reference's quirk)
        self.num_clip_layers = L = cfg["text_num_layers"]
        visual_dim, text_dim, embed_dim = cfg["vision_features"], cfg["text_features"], cfg["embed_dim"]
        hid_dim = hidden_dim or 2 * embed_dim
        feat_dim = text_dim * L + embed_dim
        self.action_dim, self.use_discrete_action = action_dim, use_discrete_action
        self.use_vip_loss, self.use_id_loss, self.use_tcn_loss = use_vip_loss, use_id_loss, use_tcn_loss
        self.goal_conditioned, self.gamma, self.tcn_margin = goal_conditioned, gamma, tcn_margin
        self.image_intermediate_linear = nn.Linear(visual_dim * L, text_dim * L, bias=False)
        self.text_intermediate_linear = nn.Linear(text_dim * L, text_dim * L, bias=False)
        for linear in (self.image_intermediate_linear, self.text_intermediate_linear):
            _lecun_normal_(linear.weight)
        self.image_adapter = AdapterMLP(feat_dim, hid_dim * (L + 1), feat_dim, num_layers)
        self.text_adapter = AdapterMLP(feat_dim, hid_dim * (L + 1), feat_dim, num_layers)
        self.inverse_layer = AdapterMLP(4 * feat_dim, hid_dim, action_dim, num_layers)
        self.image_residual_weight = nn.Parameter(torch.tensor(4.0))
        self.text_residual_weight = nn.Parameter(torch.tensor(4.0))
        self.lambda_id = nn.Parameter(torch.tensor(math.log(1 / 0.07), dtype=torch.float32))
        # the process group whose ranks hold the other shares of the batch (None: the batch is whole)
        self.batch_group = None

    @property
    def device(self) -> torch.device:
        return self.lambda_id.device

    # -- the checkpoint's view (arp_tpu_torch/checkpoint.py): the adapter holds only trained state ----

    def trained_state_dict(self) -> dict:
        return self.state_dict()

    def load_trained_state_dict(self, state: dict) -> None:
        self.load_state_dict(state)

    # -- encoders ------------------------------------------------------------------------------------

    def adapt_image_features(self, intermediate_cls: torch.Tensor, final: torch.Tensor) -> torch.Tensor:
        """The head over a trunk's outputs: per-layer CLS tokens (B, L * visual_dim, layers 0..L-1
        in order) and the projected final embedding (B, embed_dim) -> normalized feature.  The
        module trunk (:meth:`encode_image`) and the packed trunk (finetune/reward.py) both end here."""
        intermediate = self.image_intermediate_linear(intermediate_cls)
        feature = torch.cat([intermediate, final], dim=-1)
        res = torch.sigmoid(self.image_residual_weight)
        adapted = res * feature + (1.0 - res) * self.image_adapter(feature)
        return adapted / torch.linalg.vector_norm(adapted, dim=-1, keepdim=True)

    def encode_image(self, clip, image: torch.Tensor) -> torch.Tensor:
        """Preprocessed (B, 224, 224, 3) images, or their ViT patches -> normalized multiscale feature."""
        with torch.no_grad():
            final, inter = clip.encode_image(image, normalize=False, return_intermediates=True)
            cls = torch.cat([inter[i][:, 0, :] for i in range(self.num_clip_layers)], dim=-1)
        return self.adapt_image_features(cls, final)

    def encode_text(self, clip, text: torch.Tensor) -> torch.Tensor:
        """(B, 77) or (B, n_text, 77) integer tokens -> normalized feature (the mean over n_text)."""
        text_shape = text.shape
        if text.ndim == 3:
            text = text.reshape(-1, text_shape[-1])
        with torch.no_grad():
            final, inter = clip.encode_text(text, normalize=False, return_intermediates=True)
            eot, rows = text.argmax(-1), torch.arange(text.shape[0], device=text.device)
            feats = torch.cat([inter[i][rows, eot] for i in range(self.num_clip_layers)], dim=-1)
        intermediate = self.text_intermediate_linear(feats)
        feature = torch.cat([intermediate, final], dim=-1)
        res = torch.sigmoid(self.text_residual_weight)
        adapted = res * feature + (1.0 - res) * self.text_adapter(feature)
        adapted = adapted / torch.linalg.vector_norm(adapted, dim=-1, keepdim=True)
        if len(text_shape) == 3:
            adapted = adapted.reshape(text_shape[0], text_shape[1], -1).mean(dim=1)
        return adapted

    # -- preprocessing -------------------------------------------------------------------------------

    @staticmethod
    def draw_preprocess(generator: torch.Generator) -> dict:
        """The training augmentation's parameters: the 0.75 coin first, then one color-jitter
        draw for the whole batch."""
        apply = torch.rand((), generator=generator, device=generator.device) < JITTER_P
        return {"apply": apply, "jitter": draw_color_jitter(1, generator, **JITTER)}

    @staticmethod
    def preprocess(x: torch.Tensor, train: bool = False, params: Optional[dict] = None) -> torch.Tensor:
        """uint8 (B, H, W, 3) -> CLIP input ("fast" resize to 224); ``train`` with ``params``
        (:meth:`draw_preprocess`) adds the batch-shared color jitter: undo the normalization,
        clip to [0, 1], jitter, normalize again."""
        x = clip_preprocess(x, resize_mode="fast")
        if train and params is not None:
            mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
            std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
            raw = torch.clamp(x * std + mean, 0.0, 1.0)
            n = raw.shape[0]
            jittered = apply_color_jitter(raw, {k: v.to(x.device).expand(n) for k, v in params["jitter"].items()})
            raw = torch.where(params["apply"].to(x.device), jittered, raw)
            x = (raw - mean) / std
        return x

    # -- losses --------------------------------------------------------------------------------------

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the global batch: over this rank's rows, or with ``batch_group``
        over every rank's equal share (an all-reduce the gradient flows back through)."""
        if self.batch_group is None:
            return torch.mean(x)
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        total = all_reduce(torch.sum(x), group=self.batch_group)
        return total / (x.numel() * dist.get_world_size(self.batch_group))

    @staticmethod
    def tcn_distance(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return torch.sum((x1 - x2) ** 2, dim=-1)

    def tcn_loss(self, anchor, positive, negative) -> torch.Tensor:
        """Triplet hinge: mean(max(0, margin + d(a, p) - d(a, n)))."""
        d_pos, d_neg = self.tcn_distance(anchor, positive), self.tcn_distance(anchor, negative)
        return torch.mean(torch.clamp(self.tcn_margin + d_pos - d_neg, min=0.0))

    def forward(self, clip, batch: dict, train: bool = True, generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None):
        """(loss, metrics by image key) of a batch: ``image0`` .. ``image3`` (dicts key -> (B, H, W, 3)
        uint8), ``instruct``, ``action``, ``r``.  ``train`` draws the augmentation from ``generator``,
        or takes ``draws`` (:meth:`draw_preprocess`'s output) when given."""
        dev = self.device

        def on(t):
            return torch.as_tensor(t).to(dev)

        if train and draws is None:
            draws = self.draw_preprocess(generator)
        total_loss, metrics = 0.0, {}
        n_enc = 4 if self.goal_conditioned else 3
        for key in batch["image1"]:
            b = batch["image1"][key].shape[0]
            total_image = torch.cat([on(batch[f"image{i}"][key]) for i in range(4)], dim=0)
            processed = self.preprocess(total_image, train=train, params=draws)
            # the three (or four) encodes are independent by row: one batch of 3B (4B) rows
            feats = self.encode_image(clip, processed[: n_enc * b]).split(b)
            f0, f1, f2 = feats[:3]
            if self.goal_conditioned:
                f3 = feats[3]
                score_0 = -torch.linalg.vector_norm(f3 - f0, dim=-1)
                score_1 = -torch.linalg.vector_norm(f3 - f1, dim=-1)
                score_2 = -torch.linalg.vector_norm(f3 - f2, dim=-1)
                cond = f3
            else:
                logit_scale = torch.exp(clip.logit_scale.detach().float())
                text_feat = self.encode_text(clip, on(batch["instruct"]).long())
                score_0 = logit_scale * torch.sum(f0 * text_feat, dim=-1)
                score_1 = logit_scale * torch.sum(f1 * text_feat, dim=-1)
                score_2 = logit_scale * torch.sum(f2 * text_feat, dim=-1)
                cond = text_feat

            r = on(batch["r"]).reshape(-1).float() - 1.0
            vip_loss = (1 - self.gamma) * (-torch.mean(score_0)) + torch.log(
                1e-8 + self.batch_mean(torch.exp(-(r + self.gamma * score_2 - score_1))))

            concat = torch.cat([torch.cat([f1, cond], -1), torch.cat([f2, cond], -1)], dim=-1)
            action_logits = self.inverse_layer(concat)
            if self.use_discrete_action:
                labels = on(batch["action"]).reshape(-1).long()
                log_probs = F.log_softmax(action_logits, dim=-1)
                id_loss = -torch.mean(log_probs.gather(-1, labels[:, None])[:, 0])
                metrics[f"{key}_id_acc"] = torch.mean((action_logits.argmax(-1) == labels).float())
            else:
                id_loss = torch.mean((action_logits - on(batch["action"]).float()) ** 2)

            if self.use_vip_loss:
                total_loss = total_loss + vip_loss
            if self.use_id_loss:
                total_loss = total_loss + self.lambda_id * id_loss  # a raw multiplier, as in the reference
            if not self.use_vip_loss and not self.use_id_loss:
                total_loss = total_loss + vip_loss + id_loss
            if self.use_tcn_loss:
                # anchor f(o_t), positive f(o_{t+1}), negative f(o_start)
                tcn = self.tcn_loss(f1, f2, f0)
                total_loss = total_loss + tcn
                metrics[f"{key}_tcn_loss"] = tcn
            metrics[f"{key}_vip_loss"] = vip_loss
            metrics[f"{key}_id_loss"] = id_loss
        return total_loss, metrics
