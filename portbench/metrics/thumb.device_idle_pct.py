"""Share of the traced window in which the card ran no kernel, copy or set."""
from portbench.readers import idle_pct

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "thumbs_per_s"


def read(run):
    return idle_pct(run)
