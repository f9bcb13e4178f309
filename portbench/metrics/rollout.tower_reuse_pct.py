"""rollout.tower_reuse_pct: The share of the window frames the policy's frozen tower needed that the rollout's
window cache gave back instead of encoding them again (%): the ``reused`` and ``encoded`` counts of the
``policy.tower`` spans under ``rollout.policy``.  A program without the span gives ``None``."""

from portbench.spans import program_spans


def read(record: dict):
    recorded = program_spans() or ()
    policy = {s.span_id for s in recorded if s.name == "rollout.policy"}
    found = [s for s in recorded if s.name == "policy.tower" and s.parent_id in policy]
    if not found:
        return None
    reused = sum(s.attrs["reused"] for s in found)
    return 100.0 * reused / (reused + sum(s.attrs["encoded"] for s in found))
