"""The thumbnail call's copy back and host pack: stats["pack_s"], summed
over the calls, a chunk."""
from portbench.readers import seconds_ms_per_chunk

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "d2h + host pack", "thumbs_per_s"


def read(run):
    return seconds_ms_per_chunk(run, "pack_s")
