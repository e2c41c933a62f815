"""The JPEG encode stream: ``encode_jpeg_stream_overlapped`` fed batches of
host images in a closed loop.

The mix's pool of distinct images is laid out once, in set-up, as whole
batches in an order drawn from the seed, so the window hands the stream
views of one array and copies nothing. The stream pulls a batch whenever it
has room; the loop hands batches until ``seconds`` have passed, then the
stream finishes what it holds and the clock stops.

Of the window's batches the files of the first pass over the pool and of a
sample drawn from the seed (one in ``SAMPLE``) are kept for the comparison
after the window; of the others only the count of files. Keeping every file
would grow the process by gigabytes a window, which no encode service does.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .. import generate, roofline
from ..reference import jpeg_encode, tiers

REF_CHUNK = 16  # images a reference call holds on the device
SAMPLE = 8  # one in SAMPLE of the batches after the first pass is kept


class Record(NamedTuple):
    t0: float  # the window's start
    window_s: float
    handed: List[float]  # when the stream took each batch
    done: List[float]  # when each batch's files came out
    counts: List[int]  # how many files each batch gave
    kept: Dict[int, List[bytes]]  # the kept batches' files, by batch index
    stats: dict  # the stream's stats (dispatch_t, copy_iv, pack_iv)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pixo_tpu_torch import JpegOptions, Subsampling

        o = config["options"]
        self.config, self.traffic, self.device = config, traffic, device
        self.mode = o["subsampling"]
        self.quality = o["quality"]
        self.opts = JpegOptions(width=o["width"], height=o["height"], quality=o["quality"],
                                subsampling=Subsampling(o["subsampling"]))
        self.sources = generate.make_sources(traffic, seed, device)
        batch = traffic["batch"]
        if traffic["pool"] % batch:
            raise ValueError("the pool must hold whole batches")
        self.order = generate.order(traffic, traffic["pool"], seed)
        laid = np.stack([self.sources[i].pixels for i in self.order])
        self.batches = [laid[i: i + batch] for i in range(0, len(laid), batch)]
        self.batch_sources = [self.order[i: i + batch] for i in range(0, len(laid), batch)]
        self.keep_draw = np.random.default_rng(int(seed) + 1)

    def _stream(self, batches, stats=None):
        from pixo_tpu_torch.parallel import encode_jpeg_stream_overlapped

        c = self.config
        return encode_jpeg_stream_overlapped(batches, self.opts, device=self.device,
                                             host_workers=c["host_workers"], depth=c["depth"],
                                             stats=stats)

    def stand_in(self, per_source: List[bytes]) -> None:
        """Put in the entry's place one that hands each batch the files
        ``per_source`` holds for its sources (the control)."""
        index = {id(b): k for k, b in enumerate(self.batches)}

        def stream(batches, stats=None):
            for b in batches:
                yield [per_source[i] for i in self.batch_sources[index[id(b)]]]

        self._stream = stream

    def warm(self) -> None:
        """Every distinct batch once through the stream."""
        for _ in self._stream(iter(self.batches)):
            pass

    def window(self, seconds: float) -> Record:
        handed: List[float] = []
        done: List[float] = []
        counts: List[int] = []
        kept: Dict[int, List[bytes]] = {}
        keep = self.keep_draw.random(1 << 16) < 1 / SAMPLE
        keep[: len(self.batches)] = True
        stats: dict = {}
        t0 = time.perf_counter()

        def feed():
            k = 0
            while time.perf_counter() - t0 < seconds:
                handed.append(time.perf_counter())
                yield self.batches[k % len(self.batches)]
                k += 1

        for out in self._stream(feed(), stats):
            done.append(time.perf_counter())
            if keep[len(counts) % len(keep)]:
                kept[len(counts)] = out
            counts.append(len(out))
        return Record(t0, time.perf_counter() - t0, handed, done, counts, kept, stats)

    def release(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, device, rnd=None):
        """(each source's file, each source's most nonzero ACs in a block)."""
        pixels = torch.from_numpy(np.stack([s.pixels for s in self.sources]))
        zz = torch.cat([jpeg_encode.coefficients(pixels[i: i + REF_CHUNK].to(device), self.quality,
                                                 self.mode, rnd).cpu()
                        for i in range(0, len(pixels), REF_CHUNK)]).numpy()
        h, w = pixels.shape[1:3]
        pattern = jpeg_encode.PATTERNS[self.mode]

        def encode(i):
            return jpeg_encode.frame(jpeg_encode.pack_scan(zz[i], pattern), w, h, self.quality, self.mode)

        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            files = list(ex.map(encode, range(len(zz))))
        return files, tiers.nonzero_acs(zz).max(axis=1)

    def judge(self, rec: Record, expected) -> dict:
        files, _ = expected
        batch = self.traffic["batch"]
        missing = (len(rec.handed) - len(rec.counts)) * batch
        missing += sum(max(0, batch - n) for n in rec.counts)
        mismatched = sum(max(0, n - batch) for n in rec.counts)
        compared = 0
        for k, out in rec.kept.items():
            want = [files[i] for i in self.batch_sources[k % len(self.batches)]]
            mismatched += sum(a != b for a, b in zip(out, want))
            compared += min(len(out), len(want))
        return {"mismatched_files": mismatched, "missing_files": missing, "compared_files": compared}

    def facts(self, rec: Record, expected) -> dict:
        """What the metric readers read of this window."""
        _, most = expected
        o = self.opts
        images = sum(rec.counts)
        routes = [tiers.tier(int(most[src].max())) for src in self.batch_sources]
        stage = sum(roofline.encode_stage_bytes(len(self.batch_sources[k % len(routes)]), o.height,
                                                o.width, self.mode, routes[k % len(routes)])
                    for k in range(len(rec.counts)))
        return {
            "images": images,
            "megapixels": images * o.width * o.height / 1e6,
            "units": len(rec.counts),
            "unit_ms": [(d - h) * 1e3 for h, d in zip(rec.handed, rec.done)],
            "unit_end_s": [d - rec.t0 for d in rec.done],
            "stats": [rec.stats],
            "stage_bytes": stage,
            "routes": routes,
            "spans": spans(rec.stats),
        }


def spans(stats: dict) -> list:
    """The stream's own host intervals (its ``stats``) as (label, start,
    end), to name the card's idle stretches in a traced run."""
    return ([("d2h copy stage", a, b) for a, b in stats.get("copy_iv", ())]
            + [("host pack", a, b) for a, b in stats.get("pack_iv", ())])
