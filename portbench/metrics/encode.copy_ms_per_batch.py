"""The stream's copy stage (the wait on the card and the copies back):
stats["copy_iv"] summed, a batch."""
from portbench.readers import interval_ms_per_unit

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "d2h", "encode_mps"


def read(run):
    return interval_ms_per_unit(run, "copy_iv")
