"""The traced run's readings: the card's operations from ``torch.profiler``.

``DeviceTrace`` profiles the window (CPU and CUDA activities) and keeps
every device operation (kernels, copies, sets) as (name, start, end) in
``time.perf_counter`` seconds; a marker opened with the window maps the
profiler's clock onto the host's. ``label`` names an idle stretch of the
card by the host spans the program recorded meanwhile (its ``stats``).
"""

from __future__ import annotations

import re
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]
Span = Tuple[str, float, float]

MARK = "portbench.window"


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The sorted, disjoint union of ``intervals``."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:160]


class DeviceTrace:
    """Profile a block; afterwards ``ops`` holds the device operations and
    ``t0``, ``t1`` the block's bounds, all in ``time.perf_counter`` seconds."""

    def __init__(self):
        self.ops: List[Tuple[str, float, float]] = []
        self.t0 = self.t1 = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        events = self._prof.events()
        mark = next((e for e in events if e.name == MARK), None)
        if mark is None:
            return False
        shift = self.t0 - mark.time_range.start / 1e6
        # the device's operations: kernels, copies and sets, not the
        # annotations that mirror CPU ranges (the window's marker) on it
        self.ops = [(e.name, e.time_range.start / 1e6 + shift, e.time_range.end / 1e6 + shift)
                    for e in events if e.device_type == DeviceType.CUDA and e.name != MARK
                    and not getattr(e, "is_user_annotation", False)]
        return False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Interval]:
        return union(clip(((a, b) for _, a, b in self.ops), self.t0, self.t1))

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_s(self, patterns: Sequence[str]) -> Optional[float]:
        """Summed device time of the operations whose name matches one of
        ``patterns`` (regular expressions); None where none does."""
        rx = [re.compile(p) for p in patterns]
        hits = [b - a for name, a, b in self.ops if any(r.search(name) for r in rx)]
        return sum(hits) if hits else None

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for name, a, b in self.ops:
            total[short_name(name)] = total.get(short_name(name), 0.0) + (b - a)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: Sequence[Span] = (), n: int = 10) -> List[list]:
        """The ``n`` longest stretches of the window in which the card ran
        nothing, each named by the ``spans`` that ran on the host meanwhile."""
        edges = [self.t0] + [x for iv in self.busy() for x in iv] + [self.t1]
        gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:n]
        return [[label(spans, a, b), b - a] for a, b in gaps]


def label(spans: Sequence[Span], a: float, b: float) -> str:
    """The spans (label, start, end) that overlap [a, b] by a tenth of it or
    more, joined by '+', the longest overlap first; "no span" where none
    does."""
    over: Dict[str, float] = {}
    for name, s, e in spans:
        o = min(b, e) - max(a, s)
        if o > 0:
            over[name] = over.get(name, 0.0) + o
    names = [k for k, v in sorted(over.items(), key=lambda kv: -kv[1]) if v >= 0.1 * (b - a)]
    return "+".join(names) if names else "no span"
