"""rollout.push_ms: The time a lockstep step takes to transform the new frames, copy them to the card and roll
them into the policy's windows (ms): program spans ``rollout.push`` over the count of ``rollout.step``."""

from portbench.spans import ms_per_root


def read(record: dict):
    return ms_per_root("rollout.push", "rollout.step")
