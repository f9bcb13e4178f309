"""rollout.reward_span_ms: The rewards' time a lockstep step (ms): the frames' stack, the reward engine's call,
which ends in its fetch from the card, and the return-to-go update; program spans ``rollout.reward`` over the
count of ``rollout.step``."""

from portbench.spans import ms_per_root


def read(record: dict):
    return ms_per_root("rollout.reward", "rollout.step")
