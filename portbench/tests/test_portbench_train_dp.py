"""The data-parallel train cell at tiny widths on the CPU, over gloo: two ranks, the harness's process rank 0
and one child process, the reference as the mean over the two shards.  A sound run is correct and reports the
train cell's metrics; a run whose loss leaves half of each rank's rows out, or whose state is left unchanged,
is not."""

from __future__ import annotations

import pytest

from portbench import run
from portbench.tests.tiny import TINY_ARPDT

PARAMS = dict(ranks=2, batch=2, window=2, pool_batches=3)


@pytest.mark.parametrize("fault", [None, "half_batch", "unchanged"])
def test_two_ranks_correct_only_when_sound(fault):
    result = run.run_cell("train.arpdt.f32.dp4", 2 ** 31 + 23, 1.0, False, device="cpu", config_over=TINY_ARPDT,
                          params_over=PARAMS, fault=fault)
    assert result["correct"] == (fault is None), result["checks"]
    assert result["attempted"] > 0 and set(result["metrics"]) == {"train_step_ms", "setup_s"}
