"""What the span metrics read: the program's host spans (``arp_tpu_torch.profiling``), which it records while a
``torch.profiler`` runs, so in a traced run those of the window.  A program without them gives ``None``, and the
metric is left out of the line."""

from __future__ import annotations

from typing import Optional


def program_spans() -> Optional[list]:
    """The spans the program recorded, or None when it records none."""
    try:
        from arp_tpu_torch.profiling import spans
    except ImportError:
        return None
    return spans()


def share_of_window_pct(record: dict, name: str) -> Optional[float]:
    """The summed time of the spans ``name`` over the window (%)."""
    found = [s for s in program_spans() or () if s.name == name]
    if not found:
        return None
    return 100.0 * sum(s.end_ns - s.start_ns for s in found) / 1e9 / record["window_s"]


def ms_per_root(name: str, root: str) -> Optional[float]:
    """The summed time of the spans ``name`` over the count of the spans ``root`` (ms)."""
    recorded = program_spans() or ()
    roots = sum(1 for s in recorded if s.name == root)
    if not roots:
        return None
    return sum(s.end_ns - s.start_ns for s in recorded if s.name == name) / 1e6 / roots


def padded_pct(name: str, parent: str) -> Optional[float]:
    """The padding's share of the frames the spans ``name`` under the spans ``parent`` encoded (%)."""
    recorded = program_spans() or ()
    parents = {s.span_id for s in recorded if s.name == parent}
    found = [s for s in recorded if s.name == name and s.parent_id in parents]
    if not found:
        return None
    padded = sum(s.attrs["padded"] for s in found)
    return 100.0 * padded / (padded + sum(s.attrs["frames"] for s in found))
