"""rollout.env_ms: The host envs' time a lockstep step (ms): program spans ``rollout.env`` over the count of
``rollout.step``."""

from portbench.spans import ms_per_root


def read(record: dict):
    return ms_per_root("rollout.env", "rollout.step")
