"""label.k1_roofline_pct: K1's least time over its launches in the labeling window, (256, 197, 12, 64) float32 each,
over K1's device time (%)."""

from portbench.readers import k1_roofline_pct as read  # noqa: F401
