"""The benchmark's one traffic generator: inputs made from ``--seed``.

A traffic mix (``portbench/traffic/<name>.json``) is data this module reads:

- ``images``: the content and its size. ``"photo"`` is a synthetic
  photograph: a smooth illumination field, objects (the cells of a warped
  Voronoi partition, each a colour of its own) whose edges are blurred as a
  lens blurs them, band-limited texture of an amplitude drawn per object,
  and optional sensor grain (``grain_sigma`` levels a channel, white).
- ``pool``: how many distinct images; ``order`` cycles them.
- ``container``: none (the images themselves are the input), ``"jpeg"``
  (baseline, standard tables, written by ``reference.jpeg_encode``) or
  ``"png"`` (8-bit RGB, a filter a row chosen by the least sum of absolute
  differences, zlib at ``zlib_level``).

Pixels are made on ``device`` with a ``torch.Generator`` seeded from the
seed, in a few large calls, and copied to the host once. The same seed on
the same device gives the same inputs; the card and the CPU give different
ones.
"""

from __future__ import annotations

import concurrent.futures
import struct
import zlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .reference import jpeg_encode

CHUNK = 16  # images made by one set of calls


class Source(NamedTuple):
    """One distinct input: its file bytes (None where the input is the
    pixel array itself), its pixels on the host, and for a JPEG the
    quantized zigzag coefficients it was written from."""

    data: Optional[bytes]
    pixels: np.ndarray
    zz: Optional[np.ndarray]


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


def _uniform(gen, shape, device, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _blur(x: torch.Tensor, sigma: float, dims=(-2, -1)) -> torch.Tensor:
    """Separable Gaussian blur over ``dims`` by shifted adds, edges
    repeated; exact and deterministic on any device."""
    if sigma <= 0:
        return x
    radius = max(1, int(round(3 * sigma)))
    w = torch.exp(-0.5 * (torch.arange(-radius, radius + 1, dtype=torch.float32) / sigma) ** 2)
    w = (w / w.sum()).tolist()
    for dim in dims:
        n = x.shape[dim]
        out = torch.zeros_like(x)
        for k, wk in enumerate(w):
            idx = torch.clamp(torch.arange(n, device=x.device) + k - radius, 0, n - 1)
            out += wk * x.index_select(dim, idx)
        x = out
    return x


def _smooth_noise(gen, m, c, h, w, scale, device):
    """[m, c, h, w] noise of unit-ish deviation whose detail is about
    ``scale`` pixels: a coarse normal grid, bicubically upsampled."""
    gh, gw = max(2, h // scale + 2), max(2, w // scale + 2)
    coarse = _normal(gen, (m, c, gh, gw), device)
    return F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)


def photos(gen, m: int, h: int, w: int, p: dict, device) -> torch.Tensor:
    """[m, h, w, 3] uint8 synthetic photographs (the module's docstring)."""
    dev = device
    base = _uniform(gen, (m, 3, 1, 1), dev, p["base"][0], p["base"][1])
    illum = p["illum_amp"] * _smooth_noise(gen, m, 1, h, w, max(h, w) // 3, dev)
    tint = p["illum_tint"] * _smooth_noise(gen, m, 3, h, w, max(h, w) // 2, dev)
    k = p["objects"]
    cy = _uniform(gen, (m, k, 1, 1), dev, 0, h)
    cx = _uniform(gen, (m, k, 1, 1), dev, 0, w)
    warp = p["warp_px"] * _smooth_noise(gen, m, 2, h, w, p["warp_scale_px"], dev)
    yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, h, 1) + warp[:, :1]
    xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, 1, w) + warp[:, 1:]
    label = torch.zeros((m, h, w), dtype=torch.int64, device=dev)  # the nearest centre
    best = None
    for j in range(k):
        d = ((yy - cy[:, j: j + 1]) ** 2 + (xx - cx[:, j: j + 1]) ** 2)[:, 0]
        if best is None:
            best = d
            continue
        closer = d < best
        best = torch.where(closer, d, best)
        label = torch.where(closer, torch.full_like(label, j), label)
    colour = p["object_sd"] * _normal(gen, (m, k, 3), dev)
    amp = _uniform(gen, (m, k), dev, p["texture_amp"][0], p["texture_amp"][1])
    objects = torch.gather(colour, 1, label.view(m, -1, 1).expand(-1, -1, 3)).view(m, h, w, 3)
    objects = _blur(objects.permute(0, 3, 1, 2), p["edge_blur_px"])
    amp_map = _blur(torch.gather(amp, 1, label.view(m, -1)).view(m, 1, h, w), p["edge_blur_px"])
    texture = sum(wt * _smooth_noise(gen, m, 1, h, w, s, dev)
                  for s, wt in zip(p["texture_scales_px"], p["texture_weights"]))
    chroma = p["texture_chroma"] * _smooth_noise(gen, m, 3, h, w, p["texture_scales_px"][0], dev)
    img = base + illum + tint + objects + amp_map * (texture + chroma)
    if p.get("grain_sigma", 0):
        img = img + p["grain_sigma"] * _normal(gen, (m, 3, h, w), dev)
    return img.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _png(pixels: np.ndarray, level: int) -> bytes:
    """An 8-bit RGB PNG: each row's filter (None, Sub, Up, Average, Paeth)
    the one of least sum of absolute signed bytes, then zlib."""
    h, w, _ = pixels.shape
    x = pixels.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - (a + b) // 2, x - paeth]) & 0xFF  # [5, h, row]
    signed = np.where(cands > 127, 256 - cands, cands).sum(-1)  # [5, h]
    choice = signed.argmin(0)
    rows = np.concatenate([choice[:, None], cands[choice, np.arange(h)]], axis=1).astype(np.uint8)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def make_pixels(images: dict, n: int, seed: int, device) -> torch.Tensor:
    """[n, h, w, 3] uint8 on ``device``: the mix's ``images``, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    make = {"photo": photos}[images["kind"]]
    h, w = images["height"], images["width"]
    return torch.cat([make(gen, min(CHUNK, n - i), h, w, images, device) for i in range(0, n, CHUNK)])


def make_sources(traffic: dict, seed: int, device, workers: int = 8) -> List[Source]:
    """The mix's pool of distinct inputs from ``seed`` (``pool`` of them)."""
    n = traffic["pool"]
    px_dev = make_pixels(traffic["images"], n, seed, device)
    px = px_dev.cpu().numpy()
    box = traffic.get("container")
    if box is None:
        return [Source(None, px[i], None) for i in range(n)]
    if box["format"] == "jpeg":
        zz = jpeg_encode.coefficients(px_dev, box["quality"], box["subsampling"]).cpu().numpy()
        h, w = px.shape[1:3]

        def write(i):
            scan = jpeg_encode.pack_scan(zz[i], jpeg_encode.PATTERNS[box["subsampling"]])
            return jpeg_encode.frame(scan, w, h, box["quality"], box["subsampling"])
    elif box["format"] == "png":
        zz = [None] * n

        def write(i):
            return _png(px[i], box["zlib_level"])
    else:
        raise ValueError(f"unknown container {box['format']!r}")
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        files = list(ex.map(write, range(n)))
    return [Source(files[i], px[i], zz[i]) for i in range(n)]


def order(traffic: dict, count: int, seed: int) -> np.ndarray:
    """Which source each of ``count`` inputs is: the pool cycled, each
    cycle in an order drawn from ``seed``."""
    pool = traffic["pool"]
    rng = np.random.default_rng(int(seed))
    cycles = -(-count // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(cycles)])[:count]
