"""train.feed_wait_ms: The time the train loop waited on its prefetch queue a step (ms): program spans
``prefetch.wait`` over the count of ``train.step``."""

from portbench.spans import ms_per_root


def read(record: dict):
    return ms_per_root("prefetch.wait", "train.step")
