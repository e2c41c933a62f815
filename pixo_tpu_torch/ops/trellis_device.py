"""Batched trellis quantization: the plain version.

Counterpart of the JAX package's ``ops/trellis_device.py``: the per-block
Viterbi DP of the JAX package's ``jpeg/trellis.py`` (<=5 candidates a coefficient, <=8
surviving states, zero-run tracking with ZRL and EOB rate estimates), run as
a loop over the 63 AC positions with the whole batch of blocks in flight.
The states are fixed [B, 8] tensors; an invalid slot carries +inf cost.

Exactness: the same int16 output as the host library's DP
(``core.cpp::trellis::trellis_block``), tie-breaks included, whose bytes
``pixo_tpu.jpeg.encode`` emits. Float work is f32 in its operation order,
``(cost + rate) + lambda * (d * d)``. Its state list is reproduced as a merge
of fixed entries on (cost, insertion order): a nonzero candidate v is one
(v, run 0) entry whose cost is the least over the parents (ties to the
lowest parent), in order 1-4 (its candidate slot); the zero candidate gives
a child of every parent, in order 5 x the parent. The JAX package's jit DP
and its Python mirror differ from the host library in two places, and the
port follows the library in both:

- they merge zero children that reach the same run into the cheaper one
  (pixo's (value, run) map); the library keeps both, which can take a slot
  from another state and, rarely, change an AC of the result;
- the DC: they round dct / q exactly, the library as ``floor(x + 0.5)`` or
  ``ceil(x - 0.5)`` in f32 (+-1, not 0, at +-0.49999997).

The candidates round half away from zero with an exact correction, so no
f32 boundary flips.

The tests use this version, and so does ``ops/kernels.py::trellis_quantize``
for a tensor on the CPU; on a card that wrapper runs the kernel
``csrc/trellis.cu``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

MAX_STATES = 8
NCAND = 5


def _rate_lut() -> np.ndarray:
    """f32 LUT over rs = (run << 4) | category of the host's f64 rate
    estimate (the JAX package's ``jpeg/trellis.py::_est_ac_rate``): the Huffman length
    estimate plus the category's bits."""
    table = {
        0x00: 4.0, 0x01: 2.0, 0x02: 2.5, 0x03: 3.0, 0x04: 4.0,
        0x11: 3.0, 0x12: 4.0, 0x21: 4.0, 0xF0: 10.0,
    }
    lut = np.empty(256, np.float32)
    for rs in range(256):
        hufflen = table.get(rs, 3.0 + (rs >> 4) * 0.5 + (rs & 0x0F) * 0.3)
        lut[rs] = np.float32(hufflen + float(rs & 0x0F))
    return lut


RATE_LUT = _rate_lut()


def round_half_away_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact round half away from zero of f32 values: f32 ``floor(|x| +
    0.5)`` can cross an integer the exact sum does not, so two exact
    compares re-derive the bucket m - 0.5 <= |x| < m + 0.5."""
    ax = x.abs()
    m = torch.floor(ax + 0.5)
    m = torch.where(ax >= m + 0.5, m + 1, m)
    m = torch.where(ax < m - 0.5, m - 1, m)
    return torch.where(x < 0, -m, m)


def round_half_away_host(x: torch.Tensor) -> torch.Tensor:
    """The host library's DC rounding: ``floor(x + 0.5)`` for x >= 0, else
    ``ceil(x - 0.5)``, each sum rounded to f32."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def block_tables(lum_zz, chrom_zz, pattern: Sequence[int], n: int, device) -> torch.Tensor:
    """[n, 64] f32: block i's zigzag table, the chroma one where
    ``pattern[i % len(pattern)]`` is not 0."""
    lum = torch.as_tensor(np.asarray(lum_zz, np.float32).reshape(64), device=device)
    chrom = torch.as_tensor(np.asarray(chrom_zz, np.float32).reshape(64), device=device)
    pat = torch.as_tensor(np.asarray(pattern, np.int64), device=device)
    chroma = pat[torch.arange(n, device=device) % len(pattern)] != 0
    return torch.where(chroma[:, None], chrom[None, :], lum[None, :])


def _first_min(x: torch.Tensor, dim: int):
    """(min, index of its first occurrence) along ``dim``."""
    m = x.min(dim=dim, keepdim=True).values
    idx = torch.arange(x.shape[dim], device=x.device).reshape([-1 if d == dim % x.dim() else 1
                                                                for d in range(x.dim())])
    first = torch.where(x == m, idx, x.shape[dim]).min(dim=dim).values
    return m.squeeze(dim), first


def _category(av: torch.Tensor) -> torch.Tensor:
    """Bit length of |v| (0 for 0), up to 16."""
    pow2 = torch.tensor([1 << k for k in range(16)], dtype=av.dtype, device=av.device)
    return (av[..., None] >= pow2).sum(-1)


def _step(cost, run, coef, q, lam, lut):
    """One zigzag position for the whole batch: the states' (cost [B, 8],
    run [B, 8]) -> the next ones, with each new state's (parent, value).
    The valid states are sorted by cost, as the merge leaves them."""
    inf = torch.tensor(float("inf"), device=cost.device)
    b = cost.shape[0]
    fq = coef / q
    fl = torch.floor(fq)
    rd = round_half_away_exact(fq)
    ce = torch.ceil(fq)
    ext = torch.where(fq >= 0, ce + 1, fl - 1)
    # nonzero candidate slots in host insertion order: [fl, rd, ce, ext]
    nz = torch.stack([fl, rd, ce, ext], dim=-1)  # [B, 4]
    nzvalid = torch.stack([fl != 0, (rd != 0) & (rd != fl), (ce != 0) & (ce != fl) & (ce != rd),
                           fq.abs() > 1.5], dim=-1)
    nz_i = nz.to(torch.int64)

    d = coef[:, None] - nz * q[:, None]
    ld = lam * (d * d)  # [B, 4]
    cat = _category(nz_i.abs())  # [B, 4]
    rs = (run[:, :, None] << 4) | cat.clamp(max=15)[:, None, :]  # [B, 8, 4]
    rate = torch.where(cat[:, None, :] < 16, lut[rs], torch.zeros((), device=cost.device))
    svalid = torch.isfinite(cost)
    full = (cost[:, :, None] + rate) + ld[:, None, :]
    full = torch.where(svalid[:, :, None], full, inf)
    cost_nz, par_nz = _first_min(full, 1)  # ties -> the lowest parent
    cost_nz = torch.where(nzvalid, cost_nz, inf)
    order_nz = torch.arange(1, NCAND, device=cost.device).expand(b, NCAND - 1)

    # zero children: one per state
    nr = run + 1
    wrap = nr >= 16
    zrate = torch.where(wrap, torch.tensor(10.0, device=cost.device),
                        torch.tensor(0.0, device=cost.device))
    znr = torch.where(wrap, torch.zeros_like(nr), nr)
    zcost = (cost + zrate) + lam * (coef * coef)[:, None]  # an invalid parent's stays inf
    zorder = (torch.arange(MAX_STATES, device=cost.device) * NCAND).expand(b, MAX_STATES)

    # merge <=12 entries by (cost, insertion order): a finite entry's rank
    # is the count of entries before it (the orders are unique)
    costs = torch.cat([zcost, cost_nz], dim=1)
    orders = torch.cat([zorder, order_nz], dim=1)
    runs = torch.cat([znr, torch.zeros_like(par_nz)], dim=1)
    vals = torch.cat([torch.zeros_like(znr), nz_i], dim=1)
    pars = torch.cat([torch.arange(MAX_STATES, device=cost.device).expand(b, MAX_STATES), par_nz], dim=1)
    c_e, c_f = costs[:, :, None], costs[:, None, :]
    before = (c_f < c_e) | ((c_f == c_e) & (orders[:, None, :] < orders[:, :, None]))
    rank = before.sum(dim=2)
    slot = torch.where(torch.isfinite(costs) & (rank < MAX_STATES), rank, MAX_STATES)
    n_cost = torch.full((b, MAX_STATES + 1), float("inf"), device=cost.device)
    n_run, n_par, n_val = (torch.zeros((b, MAX_STATES + 1), dtype=torch.int64, device=cost.device)
                           for _ in range(3))
    for dst, src in ((n_cost, costs), (n_run, runs), (n_par, pars), (n_val, vals)):
        dst.scatter_(1, slot, src)  # every finite entry has a slot of its own; the rest go to the last
    keep = slice(0, MAX_STATES)
    return n_cost[:, keep], n_run[:, keep], n_par[:, keep], n_val[:, keep]


def trellis_quantize_batch_plain(dct_zz: torch.Tensor, lum_zz, chrom_zz, pattern: Sequence[int],
                                 lam: float = 1.0) -> torch.Tensor:
    """[B, 64] f32 zigzag DCT -> [B, 64] int16 on ``dct_zz``'s device. Block
    i takes the chroma zigzag table where ``pattern[i % len(pattern)]`` is
    not 0 (B need not be a multiple of the pattern: the flat index works
    across images whose block count is)."""
    dev = dct_zz.device
    dct = dct_zz.to(torch.float32)
    b = dct.shape[0]
    q = block_tables(lum_zz, chrom_zz, pattern, b, dev)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
    lut = torch.as_tensor(RATE_LUT, device=dev)
    dc = round_half_away_host(dct[:, 0] / q[:, 0]).to(torch.int16)

    cost = torch.full((b, MAX_STATES), float("inf"), device=dev)
    cost[:, 0] = 0.0
    run = torch.zeros((b, MAX_STATES), dtype=torch.int64, device=dev)
    parents, values = [], []
    for zz in range(1, 64):
        cost, run, par, val = _step(cost, run, dct[:, zz], q[:, zz], lam_t, lut)
        parents.append(par)
        values.append(val)

    finals = cost + torch.where(run > 0, torch.tensor(4.0, device=dev), torch.tensor(0.0, device=dev))
    _, idx = _first_min(finals, 1)  # ties -> the lowest index
    idx = idx[:, None]
    path = [None] * 63
    for t in range(62, -1, -1):
        path[t] = values[t].gather(1, idx)
        idx = parents[t].gather(1, idx)
    return torch.cat([dc[:, None], torch.cat(path, dim=1).to(torch.int16)], dim=1)
