"""Profiling harness: a ``torch.profiler`` trace of a block, and a
wall-clock stage timer.

Counterpart of the JAX package's ``utils/profiling.py``, whose trace is
``jax.profiler``'s: here the trace holds the block's host operations and, on
a card, its CUDA kernels and copies, and is written as a Chrome trace (open
it in ``chrome://tracing`` or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None, *, device="cuda") -> Iterator[object]:
    """Profile the enclosed block with ``torch.profiler`` (host activity,
    and CUDA activity unless ``device="cpu"``) and write its Chrome trace to
    ``log_dir/trace.json`` (by default a ``pixo_tpu_torch_trace`` directory
    under the temporary directory). Yields the profiler, whose
    ``key_averages()`` sum the block's time by operation and kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "pixo_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"torch profiler trace written to {path}", file=sys.stderr)


class stage_timer:
    """Wall-clock stage timer reporting MP/s (CLI --verbose analog)."""

    def __init__(self, name: str, megapixels: Optional[float] = None, stream=None):
        self.name = name
        self.megapixels = megapixels
        self.stream = stream  # resolved at exit so capture wrappers work
        self.elapsed = 0.0

    def __enter__(self) -> "stage_timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.elapsed = time.perf_counter() - self._t0
        rate = f"  ({self.megapixels / self.elapsed:.1f} MP/s)" if self.megapixels else ""
        print(f"{self.name}: {self.elapsed * 1000:.2f} ms{rate}", file=self.stream or sys.stderr)
        return False
