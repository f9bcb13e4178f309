"""rollout.reward_ms: the synchronised time of the reward engine's public calls a lockstep step (ms), noted by the
benchmark's wrappers in a traced run."""

from portbench.readers import span_ms


def read(record: dict):
    return span_ms(record, "reward_ms")
