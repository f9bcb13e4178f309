"""label.host_wait_pct: The time the reward engine waited for its producer thread's next chunk (sliced, padded
and pinned on the host) over the labeling window (%); program spans ``engine.host_wait``."""

from portbench.spans import share_of_window_pct


def read(record: dict):
    return share_of_window_pct(record, "engine.host_wait")
