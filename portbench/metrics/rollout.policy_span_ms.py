"""rollout.policy_span_ms: The policy's time a lockstep step (ms): its greedy forward and the actions' copy to the
host, which waits for the card; program spans ``rollout.policy`` over the count of ``rollout.step``."""

from portbench.spans import ms_per_root


def read(record: dict):
    return ms_per_root("rollout.policy", "rollout.step")
