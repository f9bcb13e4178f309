"""M3AE pretraining on GPUs — ``python -m arp_tpu_torch.train.pretrain_m3ae`` (port of arp_tpu/train/pretrain_m3ae.py).

Masked multimodal autoencoding (image-patch MSE + text cross entropy) on demonstration
frames and their game's instruction, producing an M3AE whose encoder the policy models
load (the same module tree; ``decoder=True`` adds the decoder side, models/m3ae.py).

The flags are the JAX trainer's, under argparse, with the same dotted names for the
nested configs (``--model.emb_dim=...``, ``--data.path=...``,
``--logging.output_dir=...``); ``--device`` (cuda unless ``cpu`` is asked for) is the
port's.  As in the JAX trainer:

  * a sample is the last stacked frame of a dataset row and the tokenized instruction
    (:class:`FramesWithText`); the loader shuffles with the flags' seed, and the first
    epoch's shuffle is spent before training, as JAX's ``next(iter(loader))`` spends it;
  * the frames are scaled to [0, 1] and resized (bilinear, antialiased when shrinking,
    as ``jax.image.resize``) only when their side is not ``image_size``, then cut into
    patches (:func:`prepare`);
  * the loss is ``patch_mse_loss`` on the dropped patches plus the per-sequence cross
    entropy on the dropped, unpadded text tokens, with ``text_acc`` logged;
  * the optimizer is ``clip_by_global_norm(1.0)`` then AdamW on the warmup-cosine
    schedule (train/common.py::AdamW, optax's written out), with JAX's ``decay_mask``
    computed on the Flax path names (:func:`decay_mask`);
  * with ``--checkpoint_dir`` the state is saved at the end of every epoch.

What differs, on purpose: checkpoints are the port's ``step_<n>.pt`` files
(checkpoint.py::CheckpointManager; JAX writes orbax directories, which the port
reads with tensorstore but does not write, and a directory that holds only JAX's
raises), and a step's masking draws come from a generator seeded by (seed, step),
not JAX's key chain.

Several GPUs: ``torchrun --nproc_per_node=N -m arp_tpu_torch.train.pretrain_m3ae
--mesh_dp=N`` (or ``--mesh_fsdp``).  JAX loads the global batch in one process and
shards it over the devices; here every rank builds the same loader from the same
seed and takes its rows (parallel/mesh.py::batch_share), so N ranks see the
batches of one.  The masking permutation is one a batch, drawn from the shared
(seed, step) generator: the same on every rank; the dropout masks are each
rank's own, from (seed, step, rank).  The losses are per-sequence
means averaged over the batch, so the average of the ranks' gradients is the
global batch's.  Rank 0 logs and writes the checkpoints.
"""

from __future__ import annotations

import logging
import random
import sys

import numpy as np
import torch

from ..checkpoint import CheckpointManager, refuse_jax_run
from ..config import Config, flag_leaves, parse_flag_tree
from ..data.instructions import get_m3ae_instruct
from ..data.loader import DataLoader
from ..data.procgen_dataset import ProcgenDataset, build_instruction_tokenizer
from ..device import resolve_device
from ..logging_utils import MetricsLogger
from ..models.m3ae import (
    MaskedMultimodalAutoencoder,
    cross_entropy_loss_and_accuracy,
    extract_patches,
    patch_mse_loss,
)
from ..models.policy.convert import flax_path
from ..ops.augment import resize_image
from ..ops.quantization import true_divide
from ..parallel.distributed import initialize
from ..parallel.mesh import MeshConfig, batch_share, create_mesh, data_share
from ..parallel.step import TrainState, make_train_step, shard_train_state, trainable_parameters
from .common import AdamW, rank_generator, warmup_cosine_decay_schedule
from .main import step_generator

log = logging.getLogger("arp_tpu_torch.pretrain_m3ae")

BERT_VOCAB_SIZE = 30522


def flag_defaults() -> dict:
    """The JAX trainer's flags and defaults, and ``device``."""
    return dict(
        seed=42, epochs=10, batch_size=64, lr=1.5e-4, weight_decay=0.05, warmup_epochs=1.0, log_freq=50,
        dataset_name="coinrun_hard_level0to500_num500_frame8", patch_size=16, image_size=256, text_length=64,
        unpaired_text_ratio=0.0, checkpoint_dir="", mesh_dp=-1, mesh_fsdp=1,
        model=MaskedMultimodalAutoencoder.get_default_config(), data=ProcgenDataset.get_default_config(),
        logging=MetricsLogger.get_default_config(), device="cuda",
    )


def parse_flags(argv=None) -> Config:
    return parse_flag_tree(flag_defaults(), argv, "Pretrain an M3AE on demonstration frames (PyTorch, GPUs).")


class FramesWithText:
    """Wraps ProcgenDataset rows into (image, text) pretraining samples."""

    def __init__(self, dataset, text_length: int):
        self.dataset = dataset
        tokenizer = build_instruction_tokenizer(True, text_length)
        self.text, self.pad = tokenizer(get_m3ae_instruct(dataset.env_name) or "")

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return {"image": self.dataset._read_frames("ob", i)[-1],  # the last stacked frame
                "text": self.text, "text_padding_mask": self.pad}


def prepare(image: torch.Tensor, image_size: int, patch_size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, N, P*P*3) patches of [0, 1] values at ``image_size``."""
    image = true_divide(image.to(torch.float32), 255.0)
    if image.shape[1] != image_size:
        image = resize_image(image, image_size, image_size, "bilinear")
    return extract_patches(image, patch_size)


def make_loss_fn(image_size: int, patch_size: int, share=(0, 1)):
    """``loss_fn(model, batch, generator) -> (loss, aux)`` for parallel/step.py: the masking draws
    come from ``generator``.  ``share`` (index, count; parallel/mesh.py::data_share): the batch is this
    rank's share of the global batch; the masking draws stay the shared stream's, and the dropout
    masks come from train/common.py::rank_generator over a copy of it, so from (seed, step, rank)."""

    def loss_fn(model, batch, generator):
        patches = prepare(batch["image"], image_size, patch_size)
        text = batch["text"].long()
        pad = batch["text_padding_mask"].to(torch.float32)
        dropout = None
        if share[1] > 1:
            fork = torch.Generator(device=generator.device)
            fork.set_state(generator.get_state())
            dropout = rank_generator(fork, share[0])
        image_out, text_out, image_mask, text_mask = model(patches, text, pad, deterministic=False,
                                                           generator=generator, dropout_generator=dropout)
        img_loss = patch_mse_loss(image_out, patches, image_mask)
        txt_loss, txt_acc = cross_entropy_loss_and_accuracy(text_out, text, (1.0 - pad) * text_mask)
        return img_loss + txt_loss, {"image_loss": img_loss, "text_loss": txt_loss, "text_acc": txt_acc}

    return loss_fn


def decay_mask(model, params) -> list:
    """JAX's ``decay_mask`` for the (name, parameter) pairs ``params``: a leaf decays unless some
    component of its Flax path contains one of the model's ``no_decay_list()`` names as a
    substring (so biases, LayerNorm scales and the decoder's type embeddings decay)."""
    no_decay = model.no_decay_list()
    return [not any(nd in part for nd in no_decay for part in flax_path(name, p.ndim)) for name, p in params]


def build_optimizer(model, schedule, weight_decay: float) -> AdamW:
    """``chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay, mask=decay_mask))``."""
    return AdamW(schedule, weight_decay, decay_mask(model, trainable_parameters(model)), clip=1.0)


def batch_on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    flags = parse_flags(argv)
    refuse_jax_run(flags.checkpoint_dir)  # before any work: a JAX run's directory does not resume here
    process_index, _ = initialize(device=flags.device)
    device = resolve_device(flags.device)
    mesh = create_mesh(MeshConfig(dp=flags.mesh_dp, fsdp=flags.mesh_fsdp), device)
    np.random.seed(flags.seed)
    random.seed(flags.seed)
    torch.manual_seed(flags.seed)
    logger = MetricsLogger(config=flags.logging, variant=dict(flag_leaves(flags)), enable=process_index == 0)

    base = ProcgenDataset(flags.data, dataset_name=flags.dataset_name, split="train")
    dataset = FramesWithText(base, flags.text_length)
    loader = DataLoader(dataset, flags.batch_size, shuffle=True, seed=flags.seed)
    # JAX draws its init sample with next(iter(loader)), which spends the first epoch's shuffle
    loader.set_state({"epoch": loader.state()["epoch"] + 1})

    model = MaskedMultimodalAutoencoder(flags.model, text_vocab_size=BERT_VOCAB_SIZE,
                                        image_output_dim=flags.patch_size * flags.patch_size * 3,
                                        decoder=True).to(device)
    steps_per_epoch = max(1, len(dataset) // flags.batch_size)
    total_steps = steps_per_epoch * flags.epochs
    warmup_steps = min(int(flags.warmup_epochs * steps_per_epoch), max(total_steps - 1, 0))
    schedule = warmup_cosine_decay_schedule(0.0, flags.lr, warmup_steps, total_steps)
    state = shard_train_state(TrainState.create(model, build_optimizer(model, schedule, flags.weight_decay)), mesh)
    step_fn = make_train_step(make_loss_fn(flags.image_size, flags.patch_size, data_share(mesh)), mesh=mesh,
                              learning_rate_fn=schedule)
    ckpt = CheckpointManager(flags.checkpoint_dir) if flags.checkpoint_dir else None

    step = 0
    for epoch in range(flags.epochs):
        for batch in loader:
            state, aux = step_fn(state, batch_on(batch_share(batch, mesh), device),
                                 step_generator(flags.seed, step, device))
            if step % flags.log_freq == 0:
                logged = {k: float(v) for k, v in aux.items()}
                logged.update(step=step, epoch=epoch)
                logger.log(logged)
            step += 1
        if ckpt is not None:
            ckpt.save(step, state, metadata={"epoch": epoch})
    log.info("pretraining done: %d steps", step)
    logger.close()


if __name__ == "__main__":
    sys.exit(main())
