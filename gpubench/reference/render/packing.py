"""Quantized splat record words: the fixed-point grids and their inverse.

Counterpart of `splat_renderer_tpu/render/packing.py`.  A record is three
u32 words (the depth key rides separately):

  w_pos: cx_fx (u16, px*pos_scale, offset +256 px) | cy_fx << 16
  w_ro:  radius_fx (u16, px*pos_scale) | angle_u8 << 16 | ratio_u8 << 24
  w_rgb: r8 | g8 << 8 | b8 << 16 | opacity_u8 << 24

PyTorch's `torch.uint32` has no shift operators on the CPU, so the port
holds every word as an int64 tensor whose values lie in [0, 2**32) and does
its bit arithmetic there; `as_int32_bits` hands the same bit patterns to
the CUDA kernel as int32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import RenderConfig

POS_MAX = 65535.0
COLOR_SCALE = 255.0
ANGLE_SCALE = 255.0 / (2.0 * math.pi)  # angle+pi -> [0, 255]
RATIO_SCALE = 255.0
# Dequantization MULTIPLIES by these reciprocal constants, never divides:
# every compositor must decode bit-identically, and a divide's rounding is
# not shared by every backend.
INV_COLOR_SCALE = 1.0 / 255.0
INV_ANGLE_SCALE = 2.0 * math.pi / 255.0
INV_RATIO_SCALE = 1.0 / 255.0

U32_MASK = 0xFFFFFFFF


def depth_bits(depth: torch.Tensor) -> torch.Tensor:
    """f32 depth -> monotonic-order u32 keys (IEEE-754 sign flip), as
    int64.  +inf (culled) sorts last."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & U32_MASK
    sign = bits >> 31
    return torch.where(sign == 1, (~bits) & U32_MASK, bits | 0x80000000)


def as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 tensors with the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_words(
    w_pos: torch.Tensor, w_ro: torch.Tensor, w_rgb: torch.Tensor, cfg: RenderConfig
) -> Tuple[torch.Tensor, ...]:
    """Words (int64) -> (cx, cy, radius, opacity, r, g, b, angle, ratio)
    float32, on the grids' exact values."""
    ps, po = cfg.pos_scale, cfg.pos_offset
    inv_ps = 1.0 / ps
    f = lambda x: x.to(torch.float32)
    cx = f(w_pos & 0xFFFF) * inv_ps - po
    cy = f(w_pos >> 16) * inv_ps - po
    r = f(w_ro & 0xFFFF) * inv_ps
    ang = f((w_ro >> 16) & 0xFF) * INV_ANGLE_SCALE - math.pi
    ratio = f(w_ro >> 24) * INV_RATIO_SCALE
    cr = f(w_rgb & 0xFF) * INV_COLOR_SCALE
    cg = f((w_rgb >> 8) & 0xFF) * INV_COLOR_SCALE
    cb = f((w_rgb >> 16) & 0xFF) * INV_COLOR_SCALE
    op = f(w_rgb >> 24) * INV_COLOR_SCALE
    return cx, cy, r, op, cr, cg, cb, ang, ratio
