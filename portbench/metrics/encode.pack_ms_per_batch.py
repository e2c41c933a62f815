"""The stream's pack stage: its (start, end) intervals, stats["pack_iv"],
summed, a batch."""
from portbench.readers import interval_ms_per_unit

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "host pack", "encode_mps"


def read(run):
    return interval_ms_per_unit(run, "pack_iv")
