"""A kernel's least time on one H100 and its share of the roofline.

The operation table, the peaks and the byte counts are a frozen copy of the
port's smoke script's (`chip_smoke.py`: `OPS`, `bound`, `stream_bound`).
The evaluation counts come from the reference's own fold of the frame or
step (`reference/frame.py::fold_blend`, `reference/fit.py`), counted up to
each pixel's stop: the work these inputs need, whatever a kernel does.
"""

from __future__ import annotations

# Peak rates of one H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes/s, FP32
# FLOP/s outside the tensor cores, and the special-function units (16
# results per SM per clock for exp2/rcp on compute capability 9.0 x 132
# SMs x 1.98 GHz boost).
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SFU_OP_S = 132 * 16 * 1.98e9

# Operations per (record, pixel) evaluation, isotropic Gaussian profile:
# every evaluation runs the support test (dx, dy, dx^2 + dy^2, compare: 6
# flops); evaluations inside the support do the rest (flops, SFU results).
OPS = {  # kernel -> (support-test flops, flops inside, SFU ops inside)
    "tile_blend": (6, 12, 1),
    "tile_blend_diff_fwd": (6, 14, 1),
    # one pass over the forward's outputs: alpha recompute 4, transmittance
    # 2, w = gC.c + gD.d 7, dL/da 8, its chain to op, r, cx, cy 14, colour
    # and depth 8
    "tile_blend_diff_bwd": (6, 43, 1),
}


def least_seconds(kernel: str, n_bytes: float, evals: int, inside: int) -> float:
    """The larger of the bytes over HBM bandwidth and the operations over
    their peak rates."""
    test, flops_in, sfu_in = OPS[kernel]
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max((evals * test + inside * flops_in) / FP32_FLOP_S, inside * sfu_in / SFU_OP_S)
    return max(t_bytes, t_ops)


def blend_bytes(num_tiles: int, tile_pixels: int, pairs: int, records: int,
                words: int = 3, outs: int = 4) -> int:
    """K1's bytes read once and written once: the offsets, one rank per pair
    read, `words` u32 words per record read, `outs` floats per pixel written."""
    return ((num_tiles + 1) * 4 + pairs * 4 + records * 4 * words
            + num_tiles * tile_pixels * 4 * outs)


def diff_fwd_bytes(num_tiles: int, tile_pixels: int, pairs: int, records: int,
                   planes: int) -> int:
    """K4's bytes: offsets, ranks, each read record's planes, colour and
    alpha out."""
    return (num_tiles + 1) * 4 + pairs * 4 + records * planes * 4 + num_tiles * tile_pixels * 4 * 4


def diff_bwd_bytes(num_tiles: int, tile_pixels: int, pairs: int, records: int,
                   planes: int) -> int:
    """K5's bytes: offsets, ranks, the read records' planes, the forward's
    outputs and the cotangents in, a gradient row per read record out."""
    return ((num_tiles + 1) * 4 + pairs * 4 + records * planes * 4
            + 2 * num_tiles * tile_pixels * 4 * 4 + records * planes * 4)


def share_percent(least_s: float, kernel_s: float):
    """100 x least time / kernel time, or None where no kernel time was read."""
    if kernel_s <= 0.0:
        return None
    return 100.0 * least_s / kernel_s
