"""95th percentile, over the window's batches, of a batch's time from its
handover to the stream to its files coming out (the harness's clock)."""
from portbench.readers import percentile

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", "stream", "encode_mps"


def read(run):
    return percentile(run.facts.get("unit_ms") or [], 95)


def count(run):
    return len(run.facts.get("unit_ms") or [])
