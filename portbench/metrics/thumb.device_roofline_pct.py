"""The thumbnail's device stage against the card's bandwidth: each source's
coefficient planes (a JPEG) or decoded pixels (any other file) in, each
chunk's compacted thumbnails out at its route, at 3.35 TB/s, over the
summed time of the IDCT, resize, coefficient and compaction kernels."""
from portbench.readers import roofline_pct

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels", "thumbs_per_s"
PATTERNS = [r"\bidct_planes_kernel\b", r"\bresize_lanczos3_\w*kernel\b", r"\bcoeffs_kernel\b",
            r"\bcompact_kernel\b"]


def read(run):
    return roofline_pct(run, PATTERNS)
