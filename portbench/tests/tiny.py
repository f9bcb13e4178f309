"""Tiny widths of each cell, for the CPU runs of the tests: every cell's traffic, reference and comparison
at sizes that take seconds."""

from __future__ import annotations

TINY_CLIP = dict(vocab_size=600, embed_dim=32, text_features=32, text_num_layers=2, text_num_heads=2,
                 vision_features=64, vision_num_layers=2, vision_patch_size=8, image_size=32)
TINY_ARPDT = dict(emb_dim=16, depth=2, num_heads=2, num_ensembles=2, tower_width=64, tower_depth=2, tower_heads=4,
                  patch=8, image_size=32, env={"name": "FakeProcgen", "image_size": 64, "episode_length": 8})

# cell -> (configuration over, parameters over)
CELLS = {
    "label.vitb16.f32": (TINY_CLIP, dict(batch_size=8, frames_per_call=20, frame_size=40, episodes=2)),
    "train.arpdt.f32": (TINY_ARPDT, dict(batch=4, window=2, pool_batches=4)),
    "rollout.arpdt.f32.e10": (TINY_ARPDT, dict(envs=3, engine_batch=8)),
    "reward_serve.vitb16.c4": (TINY_CLIP, dict(batch_size=8, requests=6, frames=4, size=40, rate=25.0)),
}


def tiny_reward_config(monkeypatch) -> None:
    """The rollout's reward engine at the tiny CLIP widths."""
    import portbench.traffic.rollout as rollout

    real = rollout.json.load
    monkeypatch.setattr(rollout.json, "load", lambda f: {**real(f), **TINY_CLIP})
