"""Batched device analysis and layout transforms for PNG lossless reductions.

Counterpart of the JAX package's ``ops/reduce_analysis.py``. The per-image
reduction decisions of ``png/reduce.py::maybe_reduce_color_type`` (pixo
``src/png/mod.rs:683-836``) are all-reduce predicates: all-gray, all-opaque,
and a <=256-unique-colors palette screen. For the batch encode they run over
the whole batch at once on its device, so a balanced-preset batch falls back
to the per-image encode only for the images where an image-dependent layout
(palette indices, sub-8-bit packing) may apply.

Routing is conservative by construction: an image is batched only when the
predicates *prove* the per-image path would take the same layout
(passthrough / alpha-strip / gray-alpha), so batched bytes always equal the
per-image encoder's output. The palette screen mirrors the host's sampled
early rejection (``png/reduce.py::build_palette``): a strided sample with
>256 unique colors proves the full image has >256; samples <=256 route to
the per-image path where ``build_palette`` makes the exact decision.

Unlike the JAX package, ``transform_png_group`` keeps its result on the
device, where the filter kernel reads it.
"""

from __future__ import annotations

import torch

from ..png.reduce import _SAMPLE_CAP


def analyze_png_batch(px: torch.Tensor):
    """[B, N, 3|4] uint8 tensor -> host bool arrays (all_gray, all_opaque,
    palette_possible), one entry per image."""
    n = px.shape[1]
    stride = max(n // _SAMPLE_CAP, 1)
    all_gray = ((px[..., 0] == px[..., 1]) & (px[..., 1] == px[..., 2])).all(dim=1)
    # int64 keys: the sort of uint32 is not supported on every device
    r, g, b = (px[..., k].to(torch.int64) for k in range(3))
    if px.shape[-1] == 4:
        all_opaque = (px[..., 3] == 255).all(dim=1)
        a = px[..., 3].to(torch.int64)
    else:
        all_opaque = torch.ones(px.shape[0], dtype=torch.bool, device=px.device)
        a = 255
    keys = (r << 24) | (g << 16) | (b << 8) | a
    samp = torch.sort(keys[:, ::stride], dim=1).values
    nuniq = (samp[:, 1:] != samp[:, :-1]).sum(dim=1) + 1
    flags = torch.stack([all_gray, all_opaque, nuniq <= 256]).cpu().numpy()
    return flags[0], flags[1], flags[2]


def transform_png_group(px_group: torch.Tensor, mode: str, opt_alpha: bool) -> torch.Tensor:
    """One group's layout transform, on its device. ``px_group`` is
    [Bg, N, bpp_in] uint8; returns [Bg, N * bpp_out] uint8.

    mode: "pass" (identity + optional alpha-zeroing), "strip" (RGBA->RGB),
    "ga" (RGBA->GrayAlpha). Alpha-zeroing mirrors ``optimize_alpha``
    (``src/png/mod.rs:633-671``): color channels of fully transparent pixels
    are cleared.
    """
    if mode == "strip":
        out = px_group[..., :3]
    else:
        out = px_group[..., [0, 3]] if mode == "ga" else px_group
        if opt_alpha and out.shape[-1] in (2, 4):
            alpha = out[..., -1:]
            colors = torch.where(alpha == 0, torch.zeros_like(out[..., :-1]), out[..., :-1])
            out = torch.cat([colors, alpha], dim=-1)
    return out.reshape(out.shape[0], -1)
