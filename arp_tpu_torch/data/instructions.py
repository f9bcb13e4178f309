"""Language instruction assets for Procgen tasks (copy of arp_tpu/data/instructions.py).

Copied so that the port loads no module of the JAX package.  The strings must
match the originals exactly: they are CLIP / M3AE conditioning prompts, and
changing a word changes every labeled reward.
"""

from __future__ import annotations


def get_m3ae_instruct(task: str) -> str:
    return {
        "coinrun": "the goal is to collect the coin.",
        "coinrun_aisc": "the goal is to collect the coin.",
        "maze": "navigate a maze to collect the yellow cheese.",
        "maze_aisc": "navigate a maze to collect the yellow cheese.",
        "maze_yellowline": "navigate a maze to collect the yellow line.",
        "maze_redline_yellowgem": "navigate a maze to collect the red line.",
    }.get(task)


def get_clip_instruct(task: str) -> str:
    return {
        "coinrun": "the goal is to collect the coin.",
        "coinrun_aisc": "the goal is to collect the coin.",
        "maze": "navigate a maze to collect the yellow cheese.",
        "maze_aisc": "navigate a maze to collect the yellow cheese.",
        "maze_yellowline": "navigate a maze to collect the yellow line.",
        "maze_redline_yellowgem": "navigate a maze to collect the red line.",
    }.get(task)


def get_eval_instruct(game_name: str) -> str | None:
    """Instruction for on-the-fly eval rewards, with a base-game fallback.

    The reference keys the eval instruction on ``{game}_{eval_env_type}``
    (main_procgen.py:560-566), but its instruction maps have no entries for
    three of its own five paper eval splits (``coinrun_aisc_gem``,
    ``maze_redline``, ``maze_reddiag_redstraight_yellowgem``) — there
    ``get_clip_instruct`` returns None and the reference crashes in
    ``clip.tokenize``.  Here the lookup falls back to the base game's
    instruction with a loud warning so every paper split evaluates out of
    the box; pass ``--eval_instruct`` on the train/eval CLIs to supply
    task-specific text instead.
    """
    text = get_clip_instruct(game_name)
    if text is not None:
        return text
    base = game_name.split("_", 1)[0]
    text = get_clip_instruct(base)
    if text is not None:
        import logging

        logging.warning(
            "no instruction asset for eval env %r; falling back to the base "
            "game's instruction %r — pass --eval_instruct for task-specific "
            "text (the reference has no asset for this split either and "
            "would crash)",
            game_name,
            text,
        )
    return text


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


# Short per-game instructions for instruction-conditioned baselines
# (InstructRL-style).  Subset used by the CoinRun/Maze benchmark splits.
PROCGEN_INSTRUCT_SHORT = {
    "coinrun": (
        "A simple platformer. The goal is to collect the coin at the far right "
        "of the level, and the player spawns on the far left. The agent must "
        "dodge stationary saw obstacles, enemies that pace back and forth, and "
        "chasms that lead to death."
    ),
    "maze": (
        "The player must navigate a maze to find the yellow cheese and earn a "
        "reward. Mazes are range in size from 3x3 to 25x25. The player may "
        "move up, down, left or right to navigate the maze."
    ),
}

# Positive/negative prompt pairs for contrastive reward shaping per env type.
PROCGEN_PROMPTS = {
    "coinrun": {
        "pos": ["the goal is to collect the coin."],
        "neg": ["the agent wanders without reaching the coin."],
    },
    "coinrun_aisc": {
        "pos": ["the goal is to collect the coin."],
        "neg": ["the agent goes to the far right without the coin."],
    },
    "maze": {
        "pos": ["navigate a maze to collect the yellow cheese."],
        "neg": ["the mouse is lost in the maze."],
    },
    "maze_aisc": {
        "pos": ["navigate a maze to collect the yellow cheese."],
        "neg": ["the mouse is lost in the maze."],
    },
}
