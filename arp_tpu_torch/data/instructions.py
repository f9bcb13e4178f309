"""CLIP instruction text for Procgen tasks (the labeler's two lookups from arp_tpu/data/instructions.py).

Copied so that the port's labeler, and anything that imports it, loads no
module of the JAX package.  The strings must match the originals exactly:
they are CLIP prompts, and changing a word changes every labeled reward.
"""

from __future__ import annotations


def get_clip_instruct(task: str) -> str:
    return {
        "coinrun": "the goal is to collect the coin.",
        "coinrun_aisc": "the goal is to collect the coin.",
        "maze": "navigate a maze to collect the yellow cheese.",
        "maze_aisc": "navigate a maze to collect the yellow cheese.",
        "maze_yellowline": "navigate a maze to collect the yellow line.",
        "maze_redline_yellowgem": "navigate a maze to collect the red line.",
    }.get(task)


def get_clip_special_instruct(env_name: str, inst_type: str) -> str:
    """Ablation prompts: random / misinformation instructions."""
    if inst_type == "random1":
        return "His voice echoed through the empty hallway."
    if inst_type == "random2":
        return (
            "NeurIPS 2023 will be held again at the at the New Orleans "
            "Ernest N. Morial Convention Center."
        )
    if inst_type == "misinfo":
        if "coinrun" in env_name:
            return "The agent must go to the far right of the level."
        if env_name == "maze_aisc":
            return "navigate a maze to reacth to the top right corner."
        if env_name == "maze_yellowline":
            return "navigate a maze to collect yellow gem."
    elif inst_type == "misinfo2":
        if "coinrun" in env_name:
            return "The goal is to collect the red strawberry."
    elif inst_type == "misinfo3":
        if "coinrun" in env_name:
            return "The goal is to reach the saw."
    elif inst_type == "misinfo4":
        if "coinrun" in env_name:
            return "The goal is to jump as high as you can."
    raise ValueError("You must pass any condition.")
