"""Thumbnails completed over the whole window."""
UNIT, SOURCE = "images/s", "host_clock"


def read(run):
    return run.facts["images"] / run.window_s if run.window_s > 0 else None
