"""The encode's device stage against the card's bandwidth: each batch's
pixels in and its route's arrays out, at 3.35 TB/s, over the summed time
of the coefficient and compaction kernels (escalations included)."""
from portbench.readers import roofline_pct

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels", "encode_mps"
PATTERNS = [r"\bcoeffs_kernel\b", r"\bcompact_kernel\b"]


def read(run):
    return roofline_pct(run, PATTERNS)
