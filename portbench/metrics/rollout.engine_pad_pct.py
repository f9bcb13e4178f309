"""rollout.engine_pad_pct: The padding's share of the frames the reward engine encoded for the rollout's rewards
(%): the ``padded`` and ``frames`` counts of the ``engine.images`` spans under ``rollout.reward``."""

from portbench.spans import padded_pct


def read(record: dict):
    return padded_pct("engine.images", "rollout.reward")
