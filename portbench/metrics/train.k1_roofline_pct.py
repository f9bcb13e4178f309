"""train.k1_roofline_pct: K1's least time over its launches in the training window (the tower's (512, 257, 12, 64) and
the policy's dt-masked (128, 12, 8, 16), float32) over K1's device time (%)."""

from portbench.readers import k1_roofline_pct as read  # noqa: F401
