"""train.idle_pct: The share of the training window in which no kernel, copy or set ran on the card (%)."""

from portbench.readers import idle_pct as read  # noqa: F401
