"""train.mfu_pct: A training step's operations by formula (the frozen tower's forward on 512 frames, the policy's
forward and backward) times the steps, over the window and float32's 495 TFLOP/s (%)."""

from portbench.readers import mfu_pct as read  # noqa: F401
