"""Evaluate a trained PPG policy (port of arp_tpu/collect/eval_ppg.py; parity with data/PPG/eval.py).

``python -m arp_tpu_torch.collect.eval_ppg --checkpoint ppg.pkl [--fake_env] [--device cpu]``: the
checkpoint is either package's ``train_ppg --checkpoint_path`` pickle (``{"params", "history"}``), a
TrainState pickle (read without flax, ``checkpoint.py::load_pickle``) or a raw Flax-layout tree.
Sampled (not greedy) actions come from a generator seeded by ``seed``: reproducible, not JAX's bits.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from .convert_ppg import flax_ppg_to_torch
from .ppg import PhasicValueModel


def policy_from_params(params, device="cuda") -> PhasicValueModel:
    """The PhasicValueModel (num_actions 15, dual, "same" pooling, as the JAX CLIs build it) holding a
    Flax-layout params tree, in eval mode on ``device``; the lazy input layers take their shapes from
    the tree."""
    model = PhasicValueModel(num_actions=15)
    model.load_state_dict(flax_ppg_to_torch(params))
    return model.eval().to(resolve_device(device))


def params_of(data):
    """The params tree of what a checkpoint pickle holds: ``{"params": ...}``, a TrainState, or the tree."""
    if isinstance(data, dict) and "params" in data:
        return data["params"]
    if hasattr(data, "params"):
        return data.params
    return data


def evaluate(params, envs, num_episodes: int = 10, greedy: bool = True, seed: int = 0, device="cuda"):
    key = envs[0].config.image_key.split(", ")[0]
    obs = [e.reset(seed + i) for i, e in enumerate(envs)]
    model = policy_from_params(params, device)
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed)
    returns = []
    ep = 0
    running = np.zeros(len(envs))
    while ep < num_episodes:
        frames = np.stack([np.asarray(o["image"][key], np.float32) / 255.0 for o in obs])
        with torch.no_grad():
            logits, _, _ = model(torch.from_numpy(frames).to(dev))
            if greedy:
                actions = logits.argmax(-1)
            else:
                actions = torch.multinomial(torch.softmax(logits, -1), 1, generator=generator)[:, 0]
        actions = actions.cpu().numpy()
        for i, env in enumerate(envs):
            o, r, d, info = env.step(int(actions[i]))
            running[i] += r
            if d:
                returns.append(running[i])
                running[i] = 0.0
                ep += 1
                o = env.reset(seed + 1000 + ep)
            obs[i] = o
    return {
        "mean_return": float(np.mean(returns)),
        "num_episodes": len(returns),
        "success_rate": float(np.mean(np.asarray(returns) > 0)),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a trained PPG policy (PyTorch).")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--game_name", default="coinrun")
    p.add_argument("--num_episodes", type=int, default=10)
    p.add_argument("--num_envs", type=int, default=4)
    p.add_argument("--fake_env", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..checkpoint import load_pickle

    params = params_of(load_pickle(args.checkpoint))
    if args.fake_env:
        from ..envs.fake import FakeProcgen

        envs = [FakeProcgen(args.game_name, {}) for _ in range(args.num_envs)]
    else:
        from ..envs.procgen import Procgen

        envs = [Procgen(args.game_name, {}, image_resolution="low") for _ in range(args.num_envs)]
    metrics = evaluate(params, envs, num_episodes=args.num_episodes, device=args.device)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
