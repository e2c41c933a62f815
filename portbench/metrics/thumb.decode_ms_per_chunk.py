"""The thumbnail call's host decode stage: stats["decode_wait_s"], summed
over the calls, a chunk."""
from portbench.readers import seconds_ms_per_chunk

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "host decode", "thumbs_per_s"


def read(run):
    return seconds_ms_per_chunk(run, "decode_wait_s")
