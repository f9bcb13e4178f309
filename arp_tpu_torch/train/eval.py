"""Standalone rollout evaluation — ``python -m arp_tpu_torch.train.eval`` (port of the JAX package's
``train/eval.py``; the reference's ``python -m arp_dt.local_run_procgen``).

Restores a policy from a reference-format pickle (``--load_checkpoint``, read
as the JAX CLI reads it: ``state.params``) or from the trainer's
``--checkpoint_dir`` (its newest ``step_<n>.pt``; ``best.pt`` when it holds no
step file), rebuilds the dataset
to recover return_to_go / scale, runs the rollout eval with on-the-fly CLIP
rewards (train/common.py::build_test_step) and logs the returns and videos.

The flags are the JAX CLI's, under argparse with dotted names for the nested
configs (``--model.transfer_type=m3ae_vit_b16``), plus ``--device`` (cuda
unless ``cpu`` is asked for).  With ``--model.frozen_int8`` the tower's int8
pack takes the scales the training run saved beside its checkpoints
(``frozen_int8_amax.npz``) and calibrates on a training batch only when they
are absent.
"""

from __future__ import annotations

import logging
import os
import random
import sys

import numpy as np
import torch

from ..checkpoint import (
    latest_step,
    load_best_state,
    load_policy_state,
    load_reference_checkpoint,
    reference_policy_state,
)
from ..config import Config, flag_leaves, parse_flag_tree
from ..data.instructions import get_m3ae_instruct
from ..data.loader import DataLoader
from ..data.procgen_dataset import ProcgenDataset, dataset_dirname
from ..device import resolve_device
from ..logging_utils import MetricsLogger
from ..models.policy import get_policy_default_config
from ..ops.augment import make_eval_transform
from .common import (
    _host_batch_to_arrays,
    build_model,
    build_test_step,
    get_dummy_input,
    maybe_build_frozen_qpack,
    model_image_size,
)

log = logging.getLogger("arp_tpu_torch.eval")


def flag_defaults() -> dict:
    """The JAX eval CLI's flags and defaults, and ``device``."""
    return dict(
        seed=42, load_checkpoint="", checkpoint_dir="", batch_size=2, weight_decay=1e-4, clip_gradient=1e9,
        window_size=4, use_text=False, num_test_episodes=100,
        # > 1: batched lockstep eval (waves of N envs)
        eval_parallel_envs=0,
        # 0.0 = greedy (reference parity); > 0 = seeded temperature sampling (BasePolicy.sample_action)
        eval_temperature=0.0,
        # pair episode ep's initial state with episode (ep + shift)'s goal frame (parallel eval only)
        eval_goal_shift=0,
        return_to_go=0.0, scale=10.0, game_name="coinrun", use_vl=True, vl_type="clip", vl_checkpoint="",
        use_crop=True, eval_data_path="", eval_data_name="", eval_with_goal=False, eval_instruct="",
        episode_length=500, eval_env="fake", env_eval_env_type="none", env_distribution_mode="hard",
        env_num_levels=500, env_start_level=0, env_hidden_goal=False, reward_bf16=False, patch_dim=16,
        encode_image_size=0, logging=MetricsLogger.get_default_config(), model=get_policy_default_config(),
        data=ProcgenDataset.get_default_config(), device="cuda",
    )


def parse_flags(argv=None) -> Config:
    return parse_flag_tree(flag_defaults(), argv, "Rollout-evaluate an ARP-DT / BC / GCBC policy (PyTorch).")


def restore_policy_state(checkpoint_dir: str) -> tuple[dict, dict]:
    """(trained state dict, metadata) of the newest ``step_<n>.pt`` in ``checkpoint_dir``, else of
    its ``best.pt``; neither raises FileNotFoundError."""
    if latest_step(checkpoint_dir) is not None:
        return load_policy_state(checkpoint_dir)
    if os.path.exists(os.path.join(checkpoint_dir, "best.pt")):
        return load_best_state(checkpoint_dir)
    raise FileNotFoundError(f"no step_<n>.pt or best.pt checkpoint in {checkpoint_dir}")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    flags = parse_flags(argv)
    if not (flags.load_checkpoint or flags.checkpoint_dir):
        raise ValueError("pass --load_checkpoint (pickle) or --checkpoint_dir (the trainer's checkpoints)")
    device = resolve_device(flags.device)
    np.random.seed(flags.seed)
    random.seed(flags.seed)
    torch.manual_seed(flags.seed)
    logger = MetricsLogger(config=flags.logging, variant=dict(flag_leaves(flags)))

    flags.model.use_discrete_action = True
    dataset_name = dataset_dirname(flags.game_name, flags.env_distribution_mode, flags.env_start_level,
                                   flags.env_num_levels, flags.data.num_demonstrations, flags.data.num_frames,
                                   flags.data.enable_filter, flags.data.train_env_type)
    train_dataset = ProcgenDataset(update=flags.data, dataset_name=dataset_name, split="train")
    use_goal = "GCBC" in flags.vl_type
    frozen_qpack = None
    if flags.model.get("frozen_int8", False):
        # the scales the training run saved win; calibrate on a small training batch only without them
        loader = DataLoader(train_dataset, batch_size=min(8, len(train_dataset)), shuffle=False, num_workers=0,
                            seed=flags.seed)
        sample = _host_batch_to_arrays(next(iter(loader)), flags.use_text, use_goal)
        frozen_qpack = maybe_build_frozen_qpack(flags, sample, use_goal, checkpoint_dir=flags.checkpoint_dir,
                                                device=device)
    model = build_model(flags, train_dataset.num_actions, frozen_qpack=frozen_qpack).to(device)
    dummy = get_dummy_input(flags, train_dataset)
    if flags.use_text:
        ids, pad = train_dataset.tokenizer(get_m3ae_instruct(flags.game_name) or "")
        dummy["instruct"], dummy["text_padding_mask"] = ids[None], pad[None]
    if flags.load_checkpoint:
        data = load_reference_checkpoint(flags.load_checkpoint)
        state, source = reference_policy_state(data), flags.load_checkpoint
        meta = {"step": data.get("step")}
    else:
        (state, meta), source = restore_policy_state(flags.checkpoint_dir), flags.checkpoint_dir
    with torch.no_grad():
        model(dummy, deterministic=True)  # the lazy layers take their shapes
        model.load_trained_state_dict(state)
    log.info("restored step %s from %s", meta.get("step"), source)

    eval_transform = make_eval_transform(image_size=model_image_size(flags), device=device)
    test_step_fn = build_test_step(flags, model, train_dataset, eval_transform, flags.use_text, device=device)
    if test_step_fn is None:
        raise SystemExit(f"cannot rollout-eval a cached-embedding policy (transfer_type={flags.model.transfer_type}): "
                         "no live encoder for env frames — evaluate the live-encoder equivalent instead")
    metric, _, videos = test_step_fn(model, flags.seed)

    logged = {f"eval/{k}": float(v) for k, v in metric.items()}
    logger.log(logged)
    log.info("eval metrics: %s", logged)
    for i, video in enumerate(videos[:5]):
        logger.log_video(f"media/eval_rollout_{i}", video)
    logger.close()
    print({k: float(v) for k, v in metric.items()})


if __name__ == "__main__":
    sys.exit(main())
