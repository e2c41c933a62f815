"""Helpers: the profiling harness, synthetic inputs and the shared-library
builder."""

from .profiling import profile_trace, stage_timer
from .synthetic import (
    synth_checkerboard,
    synth_gradient,
    synth_noise,
    synth_solid,
    synth_text_like,
)

__all__ = [
    "profile_trace",
    "stage_timer",
    "synth_checkerboard",
    "synth_gradient",
    "synth_noise",
    "synth_solid",
    "synth_text_like",
]
