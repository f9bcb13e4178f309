"""label.mfu_pct: The CLIP image tower's operations in the labeling window (35.1 GFLOP a frame by formula, frames
returned) over the window and float32's 495 TFLOP/s (%)."""

from portbench.readers import mfu_pct as read  # noqa: F401
