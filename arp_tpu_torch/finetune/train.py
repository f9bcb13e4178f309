"""CLIP adapter fine-tuning on GPUs — ``python -m arp_tpu_torch.finetune.train`` (port of arp_tpu/finetune/train.py).

The frozen CLIP (random weights from the seed with ``--clip_checkpoint
random``, a local OpenAI checkpoint otherwise: ``load_model_vars``) and the
multiscale adapter, trained by ``optax.adamw(lr, weight_decay)`` written out
(``train/common.py::AdamW`` without clipping; every parameter decays, the
three scalars too) on ``ProcgenActionDataset`` quadruples; the validation loss
after each epoch keeps the best model (``best.pt``), and the final state is
saved as ``step_<n>.pt`` (arp_tpu_torch/checkpoint.py).  The flags are the JAX
CLI's (dotted ``--data.*`` / ``--logging.*``, ``--x=v`` or ``--x v``) plus
``--device`` (cuda unless ``cpu`` is asked for).  The training augmentation is
drawn on the card from one ``torch.Generator`` seeded with ``--seed``.

``ARP_TPU_TINY_CLIP=1`` registers the ``tiny_test`` CLIP config for tests, as
the JAX CLI does, with a vocabulary that holds the tokenizer's ids (the JAX
config's 97 does not: Flax's embedding turns an id beyond it into NaN, torch's
raises).

Several GPUs: ``torchrun --nproc_per_node=N -m arp_tpu_torch.finetune.train
--mesh_dp=N``.  Every rank builds the same loader from the same seed and takes
its rows of each batch (parallel/mesh.py::batch_share), the adapter wrapped in
``DistributedDataParallel``; the VIP loss's inner mean is the global batch's
(adapter_model.py::batch_mean), the batch-shared color jitter is one draw from
the shared generator (the adapter draws nothing per row: it has no dropout), the
validation metrics are averaged over the ranks, and rank 0 logs and writes
``best.pt`` and ``step_<n>.pt``.
"""

from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch

from ..checkpoint import CheckpointManager, refuse_jax_run
from ..config import flag_leaves, parse_flag_tree
from ..data.loader import DataLoader
from ..device import resolve_device
from ..logging_utils import MetricsLogger
from ..models.clip.convert import flax_to_torch
from ..models.clip.model import CLIP, CONFIGS, load_model_vars
from ..parallel.distributed import initialize
from ..parallel.mesh import MeshConfig, batch_share, create_mesh, data_share
from ..parallel.step import TrainState, make_eval_step, make_train_step, shard_train_state, trainable_parameters
from ..train.common import AdamW
from .adapter_model import ClipMultiscaleAdapter
from .dataset import ProcgenActionDataset

log = logging.getLogger("arp_tpu_torch.finetune")

TINY_CLIP = dict(embed_dim=16, vocab_size=49408, vision_num_layers=2, vision_features=64, vision_patch_size=8,
                 text_features=16, text_num_heads=4, text_num_layers=2)
CLIP_IMAGE_SIZE = 224  # the adapter's preprocessing always feeds 224 x 224 into the tower


def flag_defaults() -> dict:
    """The JAX CLI's flags and defaults, and ``device``."""
    return dict(
        seed=42, epochs=10, batch_size=32, lr=1e-4, weight_decay=1e-4, log_freq=50,
        dataset_name="coinrun_hard_level0to500_num500_frame8", clip_model="vit_b16", clip_checkpoint="",
        use_vip_loss=True, use_id_loss=True, use_tcn_loss=False, goal_conditioned=False, checkpoint_dir="",
        image_size=224, data=ProcgenActionDataset.get_default_config(), logging=MetricsLogger.get_default_config(),
        mesh_dp=-1, device="cuda",
    )


def build_optimizer(model, lr: float, weight_decay: float) -> AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)`` over the adapter's parameters: a constant lr,
    no clipping, every parameter decays."""
    return AdamW(lambda count: lr, weight_decay, [True] * len(trainable_parameters(model)), clip=None)


def make_loss_fn(clip, train: bool):
    """``loss_fn(model, batch, generator) -> (loss, metrics with loss)`` of the adapter on ``clip``."""

    def loss_fn(model, batch, generator):
        loss, metrics = model(clip, batch, train=train, generator=generator)
        return loss, dict(metrics, loss=loss)

    return loss_fn


def build_clip(name: str, checkpoint: str, device) -> CLIP:
    """The frozen CLIP: random weights from torch's seeded generator (``random``), else a local
    OpenAI checkpoint (``checkpoint`` or the default path of ``name``)."""
    model = CLIP(**CONFIGS[name], image_size=CLIP_IMAGE_SIZE)
    if checkpoint != "random":
        model.load_state_dict(flax_to_torch(load_model_vars(name, checkpoint_path=checkpoint or None)))
    return model.eval().requires_grad_(False).to(device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    flags = parse_flag_tree(flag_defaults(), argv, "Fine-tune the CLIP multiscale adapter (PyTorch, GPUs).")
    refuse_jax_run(flags.checkpoint_dir)  # before any work: a JAX run's directory does not resume here
    process_index, _ = initialize(device=flags.device)
    device = resolve_device(flags.device)
    mesh = create_mesh(MeshConfig(dp=flags.mesh_dp), device)
    np.random.seed(flags.seed)
    random.seed(flags.seed)
    torch.manual_seed(flags.seed)
    logger = MetricsLogger(config=flags.logging, variant=dict(flag_leaves(flags)), enable=process_index == 0)

    train_dataset = ProcgenActionDataset(flags.data, dataset_name=flags.dataset_name, split="train")
    val_dataset = ProcgenActionDataset(flags.data, dataset_name=flags.dataset_name, split="val")
    train_loader = DataLoader(train_dataset, flags.batch_size, shuffle=True, seed=flags.seed)
    # drop_last=False: a val split smaller than batch_size must not be empty, and the best
    # model's choice sees the tail batch
    val_loader = DataLoader(val_dataset, flags.batch_size, shuffle=False, seed=flags.seed, drop_last=False)

    if os.environ.get("ARP_TPU_TINY_CLIP") == "1":
        CONFIGS["tiny_test"] = TINY_CLIP

    model = ClipMultiscaleAdapter(
        clip_model_name=flags.clip_model, action_dim=train_dataset.num_actions, use_vip_loss=flags.use_vip_loss,
        use_id_loss=flags.use_id_loss, use_tcn_loss=flags.use_tcn_loss, goal_conditioned=flags.goal_conditioned,
    ).to(device)
    clip = build_clip(flags.clip_model, flags.clip_checkpoint, device)
    # the optimizer after the adapter's first forward, in the JAX CLI's order (model.init on a batch)
    with torch.no_grad():
        model(clip, next(iter(train_loader)), train=False)
    state = TrainState.create(model, build_optimizer(model, flags.lr, flags.weight_decay))
    if mesh is not None:
        model.batch_group = mesh["dp"].get_group()
    # a loss without the text (goal_conditioned) leaves the text adapter without a gradient, and the
    # VIP loss alone the inverse layer and lambda_id
    unreached = flags.goal_conditioned or (flags.use_vip_loss and not flags.use_id_loss)
    state = shard_train_state(state, mesh, find_unused_parameters=unreached)
    ckpt = CheckpointManager(flags.checkpoint_dir) if flags.checkpoint_dir else None
    train_step = make_train_step(make_loss_fn(clip, train=True), mesh=mesh)
    val_step = make_eval_step(make_loss_fn(clip, train=False), mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(flags.seed)
    shares = data_share(mesh)[1]

    def mine(batch):
        """This rank's rows; a tail batch that does not split goes whole to every rank."""
        rows = len(batch["action"])
        return batch_share(batch, mesh) if rows % shares == 0 else batch

    step, best_val = 0, np.inf
    for epoch in range(flags.epochs):
        for batch in train_loader:
            state, metrics = train_step(state, batch_share(batch, mesh), generator)
            if step % flags.log_freq == 0:
                logged = {f"train_{k}": float(v) for k, v in metrics.items() if k != "train_state_step"}
                logger.log(dict(logged, step=step, epoch=epoch))
            step += 1
        val_losses = [float(val_step(state, mine(batch), None)["loss"]) for batch in val_loader]
        val_loss = float(np.mean(val_losses)) if val_losses else np.inf
        logger.log({"val_loss": val_loss, "epoch": epoch, "step": step})
        if ckpt is not None and val_loss < best_val:
            best_val = val_loss
            ckpt.save_best(step, state, -val_loss, metadata={"epoch": epoch})
    if ckpt is not None:
        ckpt.save(step, state, metadata={"epoch": flags.epochs}, wait=True)
    logger.close()


if __name__ == "__main__":
    main()
