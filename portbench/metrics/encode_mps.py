"""Input megapixels whose JPEG files came out, over the whole window."""
UNIT, SOURCE = "MP/s", "host_clock"


def read(run):
    return run.facts["megapixels"] / run.window_s if run.window_s > 0 else None
