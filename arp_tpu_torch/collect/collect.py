"""Demo collection CLI: ``python -m arp_tpu_torch.collect.collect`` (port of arp_tpu/collect/collect.py).

The reference's ``python -m collect_procgen_data``: roll a trained PPG policy (greedy), record the
high-resolution frames and engine states into the demo schema (``collect/recorder.py``), with the
per-game expert filter and optional random-action corruption.  ``--model_path`` is a reference
``.jd`` expert (``convert_ppg.load_reference_ppg_expert``) or either package's ``train_ppg`` pickle;
without it the policy is random.  ``--dual_res`` pairs a low-resolution engine for the policy with the
recorder's high-resolution one (state-synced).  The flags are the JAX CLI's, parsed as ``train_ppg``
parses its own, plus ``--device`` (the policy's; cuda unless cpu is asked for); each step's frame
goes to the device once.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import parse_flag_tree
from ..device import resolve_device
from .recorder import collect_demonstrations


def flag_defaults() -> dict:
    return dict(
        seed=42, game_name="coinrun", model_path="", num_episodes=500, num_frames=8, split="train",
        out_dir="./demonstrations", distribution_mode="hard", num_levels=500, start_level=0, env_type="none",
        random_action_prob=0.0, enable_filter=True, fake_env=False, dual_res=True, episode_length=1000,
        # the dirname's demo count: the TRAIN split's (train and val share one directory), so val
        # collection passes --num_episodes=50 --num_demonstrations=500; 0 -> num_episodes
        num_demonstrations=0, device="cuda",
    )


def load_policy(model_path: str, device):
    """The greedy PPG policy of ``model_path`` (``.jd`` or pickle) on ``device``."""
    if model_path.endswith(".jd"):
        from .convert_ppg import load_reference_ppg_expert

        model, _ = load_reference_ppg_expert(model_path)
        return model.to(device)
    from ..checkpoint import load_pickle
    from .eval_ppg import params_of, policy_from_params

    return policy_from_params(params_of(load_pickle(model_path)), device)


def main(argv=None):
    flags = parse_flag_tree(flag_defaults(), argv, "Collect PPG expert demonstrations (PyTorch).")
    from ..data.procgen_dataset import dataset_dirname

    dirname = dataset_dirname(
        flags.game_name, distribution_mode=flags.distribution_mode, start_level=flags.start_level,
        num_levels=flags.num_levels, num_demonstrations=flags.num_demonstrations or flags.num_episodes,
        num_frames=flags.num_frames, enable_filter=flags.enable_filter, env_type=flags.env_type,
    )
    data_path = os.path.join(flags.out_dir, dirname, f"data_{flags.split}.hdf5")

    if flags.model_path:
        device = resolve_device(flags.device)
        model = load_policy(flags.model_path, device)

        def policy_fn(obs):
            frame = np.asarray(obs["image"]["ob"], np.float32)[None] / 255.0
            with torch.no_grad():
                logits, _, _ = model(torch.from_numpy(frame).to(device))
            return int(logits.argmax(-1)[0])
    else:
        rng = np.random.default_rng(flags.seed)

        def policy_fn(obs):
            return int(rng.integers(0, 15))

    env_conf = {
        "episode_length": flags.episode_length, "distribution_mode": flags.distribution_mode,
        "num_levels": flags.num_levels, "start_level": flags.start_level, "use_train_levels": True,
        # the collected variant must match the dirname's suffix (collect_procgen_data.py:162)
        "eval_env_type": flags.env_type,
    }
    paired = None
    if flags.fake_env:
        from ..envs.fake import FakeProcgen

        env = FakeProcgen(flags.game_name, {"episode_length": flags.episode_length})
    else:
        from ..envs.procgen import Procgen

        env = Procgen(flags.game_name, env_conf, image_resolution="high")
        if flags.dual_res:
            paired = Procgen(flags.game_name, env_conf, image_resolution="low")

    rec = collect_demonstrations(
        env, policy_fn, data_path, num_episodes=flags.num_episodes, game_name=flags.game_name,
        num_frames=flags.num_frames, success_filter=flags.enable_filter, seed=flags.seed,
        random_action_prob=flags.random_action_prob, paired_policy_env=paired,
        # the reference keeps T < 1000 (trajectory_recorder.py:127); the cap follows the timeout, and
        # without the filter timed-out episodes are kept
        max_episode_length=flags.episode_length if flags.enable_filter else flags.episode_length + 1,
    )
    print(f"[DONE] recorded {rec.num_recorded} episodes ({rec.num_filtered} filtered) -> {data_path}")
    return rec


if __name__ == "__main__":
    main()
