"""What the metric readers share. A reader gets the run's ``Run`` and
returns a number, or None where it finds nothing to read (a ``stats`` key
the program did not fill, no traced kernel of its patterns): the harness
then leaves the metric out of the line."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from . import roofline


class Run(NamedTuple):
    setup_s: float
    window_s: float
    facts: dict  # the cell's readings of the window (``Cell.facts`` of its driver module)
    trace: Optional[object]  # trace.DeviceTrace of a traced run, else None


def stat_values(run: Run, key: str) -> Optional[List]:
    """Every call's ``stats[key]``, or None where a call lacks it."""
    stats = run.facts.get("stats") or []
    if not stats or any(key not in s for s in stats):
        return None
    return [s[key] for s in stats]


def interval_ms_per_unit(run: Run, key: str) -> Optional[float]:
    """The summed length of ``stats[key]``'s (start, end) intervals, in ms,
    over the number of units (batches) the window completed."""
    values = stat_values(run, key)
    units = run.facts.get("units")
    if values is None or not units:
        return None
    return 1e3 * sum(b - a for ivs in values for a, b in ivs) / units


def seconds_ms_per_chunk(run: Run, key: str) -> Optional[float]:
    """A per-call ``stats[key]`` in seconds, summed, in ms a chunk."""
    values = stat_values(run, key)
    chunks = run.facts.get("chunks")
    if values is None or not chunks:
        return None
    return 1e3 * sum(values) / chunks


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if len(values) else None


def idle_pct(run: Run) -> Optional[float]:
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def roofline_pct(run: Run, patterns: Sequence[str]) -> Optional[float]:
    """The window's stage bytes at the card's peak bandwidth, over the
    summed device time of the kernels that match ``patterns``."""
    tr = run.trace
    if tr is None or not run.facts.get("stage_bytes"):
        return None
    return roofline.share_pct(run.facts["stage_bytes"], tr.kernel_s(patterns))
