"""serve.engine_busy_pct: The reward server's own busy seconds behind its lock (its /v1/health counter) over the
window (%)."""

from portbench.readers import engine_busy_pct as read  # noqa: F401
