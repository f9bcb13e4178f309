"""On the card: each cell's control, the reference computed in TF32 put in the program's place, comes out
above the cell's limits, while the program's own run comes out below them, at the cell's widths with fewer
frames, steps or requests than a run has.  Skips without CUDA (decided inside the test).

    python -m pytest portbench/tests/test_portbench_control.py -q      # on a machine with an H100
"""

from __future__ import annotations

import pytest

from portbench import run

# fewer frames, steps or requests than a run, the widths and batch shapes as the cell's
SMALLER = {"label.vitb16.f32": dict(frames_per_call=512, episodes=1),
           "train.arpdt.f32": dict(pool_batches=3),
           "rollout.arpdt.f32.e10": {},
           "reward_serve.vitb16.c4": dict(requests=16)}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALLER))
def test_control_fails_where_the_program_passes(cell, card):
    import importlib

    data, config = run.load_cell(cell)
    params = {**data["params"], **SMALLER[cell]}
    module = importlib.import_module(f"portbench.traffic.{data['traffic']}")
    traffic = module.Traffic(config, params, 2 ** 31 + 101, card)
    out = traffic.window(3.0)
    traffic.release()
    checks = traffic.compare()
    control = traffic.control()
    assert out["failed"] == 0 and all(v <= limit for v, limit in checks.values()), checks
    assert any(control[k] > limit for k, (_, limit) in checks.items()), (control, checks)
