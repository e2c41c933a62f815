"""Host-side JPEG entropy packing in Python: the baseline scan packer and
the symbol counter.

Copied from the JAX package's ``jpeg/packer.py``. The port packs and counts
with the host library (``native_pack_scan*``, ``native_count_symbols``) and
on the card (``ops/kernels.py::count_symbols``); these two functions are the
reference's Python tier, kept as the tests' oracles.

Consumes the device-emitted zigzag coefficient stream [nblocks, 64] int16
(scan order, raw DC values) and produces the entropy-coded scan bytes.

Parity targets:
  - ``encode_block`` (pixo ``src/jpeg/huffman.rs:423-481``): DC diff
    category + one's-complement value bits, AC run-length with ZRL(0xF0)
    and EOB(0x00).
  - restart handling (``src/jpeg/mod.rs:1408-1445``): flush + RSTn after
    every `interval` MCUs except after the last, DC predictors reset.
  - ``count_block`` (``src/jpeg/mod.rs:826-860``): symbol histograms for
    optimized Huffman tables, mirroring the same restart resets.

The host library implements the same contract; the tests hold the two
equal.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..bits import BitWriterMsb
from .tables import HuffmanTables


def _category(value: int) -> int:
    return int(abs(value)).bit_length()


def pack_scan(
    zz: np.ndarray,
    pattern: Sequence[int],
    tables: HuffmanTables,
    restart_interval: Optional[int] = None,
) -> bytes:
    """Pack a baseline scan.

    zz: [nblocks, 64] int16 zigzag coefficients in scan order.
    pattern: component id (0=Y, 1=Cb, 2=Cr) for each block within an MCU.
    """
    writer = BitWriterMsb()
    bpm = len(pattern)
    nblocks = zz.shape[0]
    assert nblocks % bpm == 0
    total_mcus = nblocks // bpm

    dc_codes = (tables.dc_lum_codes, tables.dc_chrom_codes, tables.dc_chrom_codes)
    dc_lens = (tables.dc_lum_lengths, tables.dc_chrom_lengths, tables.dc_chrom_lengths)
    ac_codes = (tables.ac_lum_codes, tables.ac_chrom_codes, tables.ac_chrom_codes)
    ac_lens = (tables.ac_lum_lengths, tables.ac_chrom_lengths, tables.ac_chrom_lengths)

    prev_dc = [0, 0, 0]
    rst_idx = 0
    zz_list = zz.tolist()  # python ints: much faster in the scalar loop

    for mcu in range(total_mcus):
        base = mcu * bpm
        for k, comp in enumerate(pattern):
            block = zz_list[base + k]
            dcc, dcl = dc_codes[comp], dc_lens[comp]
            acc, acl = ac_codes[comp], ac_lens[comp]

            dc = block[0]
            diff = dc - prev_dc[comp]
            prev_dc[comp] = dc
            cat = _category(diff)
            writer.write_bits(int(dcc[cat]), int(dcl[cat]))
            if cat > 0:
                bits = (diff - 1) if diff < 0 else diff
                writer.write_bits(bits & ((1 << cat) - 1), cat)

            zero_run = 0
            for i in range(1, 64):
                ac = block[i]
                if ac == 0:
                    zero_run += 1
                    continue
                while zero_run >= 16:
                    writer.write_bits(int(acc[0xF0]), int(acl[0xF0]))
                    zero_run -= 16
                ac_cat = _category(ac)
                rs = (zero_run << 4) | ac_cat
                writer.write_bits(int(acc[rs]), int(acl[rs]))
                bits = (ac - 1) if ac < 0 else ac
                writer.write_bits(bits & ((1 << ac_cat) - 1), ac_cat)
                zero_run = 0
            if zero_run > 0:
                writer.write_bits(int(acc[0x00]), int(acl[0x00]))

        if restart_interval:
            mcu_count = mcu + 1
            if mcu_count % restart_interval == 0 and mcu_count < total_mcus:
                writer.flush()
                writer.write_bytes(bytes([0xFF, 0xD0 + (rst_idx & 0x07)]))
                rst_idx = (rst_idx + 1) & 0x07
                prev_dc = [0, 0, 0]

    return writer.finish()


def count_symbols(
    zz: np.ndarray,
    pattern: Sequence[int],
    restart_interval: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Histogram DC/AC symbols for optimized Huffman table construction.

    Returns (dc_lum[12], dc_chrom[12], ac_lum[256], ac_chrom[256]) counts.
    """
    dc_counts = np.zeros((2, 12), dtype=np.int64)
    ac_counts = np.zeros((2, 256), dtype=np.int64)
    bpm = len(pattern)
    total_mcus = zz.shape[0] // bpm
    prev_dc = [0, 0, 0]
    zz_list = zz.tolist()

    for mcu in range(total_mcus):
        base = mcu * bpm
        for k, comp in enumerate(pattern):
            block = zz_list[base + k]
            t = 0 if comp == 0 else 1
            dc = block[0]
            diff = dc - prev_dc[comp]
            prev_dc[comp] = dc
            dc_counts[t][_category(diff)] += 1
            zero_run = 0
            for i in range(1, 64):
                ac = block[i]
                if ac == 0:
                    zero_run += 1
                    continue
                while zero_run >= 16:
                    ac_counts[t][0xF0] += 1
                    zero_run -= 16
                ac_counts[t][(zero_run << 4) | _category(ac)] += 1
                zero_run = 0
            if zero_run > 0:
                ac_counts[t][0x00] += 1
        if restart_interval:
            mcu_count = mcu + 1
            if mcu_count % restart_interval == 0 and mcu_count < total_mcus:
                prev_dc = [0, 0, 0]

    return dc_counts[0], dc_counts[1], ac_counts[0], ac_counts[1]
