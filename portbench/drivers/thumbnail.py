"""The thumbnail farm: ``thumbnail_pipeline`` called on lists of files in a
closed loop.

Every call takes the same list of ``files_per_call`` files: the mix's pool
of distinct sources cycled in an order drawn from the seed. The loop starts
a call while ``seconds`` have not passed; the clock stops when the call in
flight returns.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import List, NamedTuple

import numpy as np
import torch

from .. import generate, roofline
from ..reference import jpeg_decode, jpeg_encode, resize, tiers


class Record(NamedTuple):
    t0: float  # the window's start
    window_s: float
    calls: List[tuple]  # (start, end) of each call
    thumbs: List[List[bytes]]  # each call's thumbnails
    stats: List[dict]  # each call's stats


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.sources = generate.make_sources(traffic, seed, device)
        self.order = generate.order(traffic, traffic["files_per_call"], seed)
        self.files = [self.sources[i].data for i in self.order]

    def _call(self, files, stats=None):
        from pixo_tpu_torch.parallel import thumbnail_pipeline

        c = self.config
        return thumbnail_pipeline(files, thumb_size=c["thumb_size"], quality=c["quality"],
                                  host_workers=c["host_workers"], chunk_size=c["chunk_size"],
                                  device=self.device, stats=stats)

    def stand_in(self, per_source: List[bytes]) -> None:
        """Put in the entry's place one that returns, for each file, the
        thumbnail ``per_source`` holds for its source (the control)."""
        index = {id(s.data): i for i, s in enumerate(self.sources)}
        self._call = lambda files, stats=None: [per_source[index[id(f)]] for f in files]

    def warm(self) -> None:
        """One call whose first chunk holds every source and whose second is
        as long as the call's last chunk."""
        chunk = self.config["chunk_size"]
        cycled = [self.sources[i % len(self.sources)].data for i in range(max(chunk, len(self.sources)))]
        self._call(cycled + self.files[: len(self.files) % chunk])

    def window(self, seconds: float) -> Record:
        calls, thumbs, stats = [], [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            s: dict = {}
            a = time.perf_counter()
            thumbs.append(self._call(self.files, s))
            calls.append((a, time.perf_counter()))
            stats.append(s)
        return Record(t0, time.perf_counter() - t0, calls, thumbs, stats)

    def release(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _source_pixels(self, src, device) -> torch.Tensor:
        if src.zz is None:  # the file holds exactly these pixels
            return torch.from_numpy(src.pixels).to(device)
        box = self.traffic["container"]
        h, w = src.pixels.shape[:2]
        lum, chrom = jpeg_encode.quant_tables(box["quality"])
        sampling = [(2, 2), (1, 1), (1, 1)] if box["subsampling"] == "420" else [(1, 1)] * 3
        dec = jpeg_decode.Decoded(w, h, sampling, [lum, chrom, chrom], src.zz)
        return jpeg_decode.pixels(dec, device)

    def reference(self, device, rnd=None):
        """(each source's thumbnail, its thumbnail's most nonzero ACs in a
        block). A JPEG source's pixels come from the coefficients it was
        written from: its entropy coding is lossless
        (``reference.jpeg_decode.decode_coefficients`` gives them back)."""
        c = self.config
        t = c["thumb_size"]

        def one(src):
            px = self._source_pixels(src, device)
            thumb = resize.lanczos3(px[None], t, t, rnd)
            zz = jpeg_encode.coefficients(thumb, c["quality"], "444", rnd).cpu().numpy()[0]
            scan = jpeg_encode.pack_scan(zz, jpeg_encode.PATTERNS["444"])
            return jpeg_encode.frame(scan, t, t, c["quality"], "444"), int(tiers.nonzero_acs(zz).max())

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            done = list(ex.map(one, self.sources))
        return [d[0] for d in done], np.array([d[1] for d in done])

    def judge(self, rec: Record, expected) -> dict:
        want = [expected[0][i] for i in self.order]
        mismatched = missing = compared = 0
        for out in rec.thumbs:
            missing += max(0, len(want) - len(out))
            mismatched += max(0, len(out) - len(want))
            mismatched += sum(a != b for a, b in zip(out, want))
            compared += min(len(out), len(want))
        return {"mismatched_files": mismatched, "missing_files": missing, "compared_files": compared}

    def facts(self, rec: Record, expected) -> dict:
        _, most = expected
        c, t = self.config, self.config["thumb_size"]
        chunk = c["chunk_size"]
        chunks = [self.order[i: i + chunk] for i in range(0, len(self.order), chunk)]
        routes = [tiers.tier(int(most[ch].max())) for ch in chunks]
        src_bytes = sum(roofline.thumb_source_bytes(self.sources[i].pixels.shape, self.sources[i].zz)
                        for i in self.order)
        out_bytes = sum(roofline.thumb_out_bytes(len(ch), t, r) for ch, r in zip(chunks, routes))
        images = sum(len(x) for x in rec.thumbs)
        return {
            "images": images,
            "units": len(rec.thumbs),
            "chunks": len(rec.thumbs) * len(chunks),
            "unit_ms": [(b - a) * 1e3 for a, b in rec.calls],
            "unit_end_s": [b - rec.t0 for _, b in rec.calls],
            "stats": rec.stats,
            "stage_bytes": len(rec.thumbs) * (src_bytes + out_bytes),
            "routes": routes,
        }
