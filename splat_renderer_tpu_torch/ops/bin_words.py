"""The binner's CUDA kernels: the projector's words to per-tile runs.

`bin_words` runs `csrc/bin_words.cu` on CUDA tensors and returns what
`render/binning.py::bin_packed_words_plain` returns on the same device over
the live pairs, bit for bit: offsets, counts, pair_rank[:P], pair_tile[:P]
and the rec_* planes (P = offsets[-1]).  The tail [P, N*cap) holds the
sentinel tile in pair_tile and rank 0 in pair_rank (the plain path's tail
holds the sorted-out sentinel slots' records); nothing reads past P.
`launches["bin_words"]` (`ops/build.py`) counts its calls.
`render/binning.py::bin_packed_words` calls it for CUDA tensors; CPU tensors
take the plain path.

A call is two library calls around one 4-byte read-back: the footprint
kernel and the scan of the records' live-pair counts, then P, the live
pairs, read to the host to size the sort, then the emit kernel, the radix
sort of the P pairs and the ranges.  Every buffer, cub's scratch included,
is allocated here with `torch.empty` on the words' device; the kernels run
on its current stream.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from ..config import RenderConfig
from ..render.packing import INV_ANGLE_SCALE, INV_RATIO_SCALE
from .build import Entry, check_tensor

# csrc Footprint enum
ISOTROPIC, ELLIPSE, SQUARE = 0, 1, 2
_WORDS = ("dkeys", "w_pos", "w_ro", "w_rgb")
_P, _I, _LL, _ULL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
_SCRATCH = Entry("bin_words", "bin_words_scratch", [_I, _I, _I, _P])
_COUNT = Entry("bin_words", "bin_words_count", [_P] * 6 + [_I] + [_P] * 8 + [_ULL, _P])
_PAIRS = Entry("bin_words", "bin_words_pairs",
               [_P] * 3 + [_I, _I, _LL] + [_I] * 3 + [_P] * 4 + [_ULL] + [_P] * 5)


def footprint_model(cfg: RenderConfig) -> int:
    """The plain path's footprint: `_footprint_cols` takes the oriented
    extents for oriented configs, the square's for opaque quads."""
    if not cfg.oriented:
        return ISOTROPIC
    return SQUARE if cfg.opaque and cfg.quad else ELLIPSE


@functools.lru_cache(maxsize=None)
def _scalars(cfg: RenderConfig):
    """cfg's numbers as the kernel's Geometry: the plain path's Python
    floats rounded to float32, and its ints."""
    floats = (ctypes.c_float * 11)(
        1.0 / cfg.pos_scale, cfg.pos_offset, INV_ANGLE_SCALE, math.pi, INV_RATIO_SCALE,
        cfg.bounds_margin, cfg.min_screen_radius, float(cfg.tile_w), float(cfg.tile_h),
        float(cfg.width), float(cfg.height),
    )
    ints = (ctypes.c_int * 5)(
        cfg.tiles_x, cfg.tiles_y, cfg.tiles_per_splat_cap, footprint_model(cfg),
        int(not (cfg.opaque and cfg.quad)),
    )
    return floats, ints


def _check(dkeys, w_pos, w_ro, w_rgb, cfg: RenderConfig) -> None:
    """Raise ValueError on what the kernels do not take, before anything is
    built or loaded."""
    words = dict(zip(_WORDS, (dkeys, w_pos, w_ro, w_rgb)))
    n = dkeys.shape[0] if dkeys.dim() == 1 else -1
    for name, t in words.items():
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be 1-d of the length of dkeys, got shape "
                             f"{tuple(t.shape)} against {tuple(dkeys.shape)}")
    cap = cfg.tiles_per_splat_cap
    if n * cap >= 2**31:
        raise ValueError(f"{n} records x cap {cap} = {n * cap} pair slots: the kernel "
                         "indexes them in int32 and takes fewer than 2**31")
    if not 1 <= cap < 4096 or max(cfg.tiles_x, cfg.tiles_y) >= 2**15:
        raise ValueError(f"cap {cap} or {cfg.tiles_x} x {cfg.tiles_y} tiles out of the "
                         "kernel's window packing (cap < 4096, tiles a side < 2**15)")
    for name, t in words.items():
        check_tensor(name, t, torch.int64, dkeys.device)  # int64 holding u32 words
    if dkeys.device.type != "cuda":
        raise ValueError(f"no binner kernel for device {dkeys.device}")


def bin_words(
    dkeys: torch.Tensor,  # (N,) int64 depth keys
    w_pos: torch.Tensor,  # (N,) int64 words
    w_ro: torch.Tensor,
    w_rgb: torch.Tensor,
    cfg: RenderConfig,
    with_depth: bool = False,
) -> Dict[str, torch.Tensor]:
    """The binner's kernels: {"offsets", "counts", "pair_rank", "pair_tile",
    "rec_pos", "rec_ro", "rec_rgb"} (and "rec_depth" with_depth), int32,
    shaped as `bin_packed_words` documents them.  Raises ValueError on
    inputs the kernels do not take (see `_check`)."""
    _check(dkeys, w_pos, w_ro, w_rgb, cfg)
    n, cap, num_tiles = dkeys.shape[0], cfg.tiles_per_splat_cap, cfg.num_tiles
    slots = n * cap
    end_bit = 32 + num_tiles.bit_length()
    device = dkeys.device
    i32 = dict(dtype=torch.int32, device=device)
    out = {k: torch.empty(n, **i32) for k in ("rec_pos", "rec_ro", "rec_rgb")}
    if with_depth:
        out["rec_depth"] = torch.empty(n, **i32)
    foot = torch.empty(n, dtype=torch.int64, device=device)  # an int2 a record
    cnt = torch.empty(n + 1, **i32)
    off = torch.empty(n + 1, **i32)
    fscalars, iscalars = _scalars(cfg)
    scratch_bytes = (ctypes.c_ulonglong * 2)()
    # the scan's scratch, the footprint kernel and the scan
    _SCRATCH(n, 0, end_bit, scratch_bytes, device=device)
    scratch = torch.empty(max(scratch_bytes[0], 1), dtype=torch.uint8, device=device)
    _COUNT.launch(
        device,
        dkeys.data_ptr(), w_pos.data_ptr(), w_ro.data_ptr(), w_rgb.data_ptr(), fscalars,
        iscalars, n, out["rec_pos"].data_ptr(), out["rec_ro"].data_ptr(),
        out["rec_rgb"].data_ptr(), out["rec_depth"].data_ptr() if with_depth else None,
        foot.data_ptr(), cnt.data_ptr(), off.data_ptr(), scratch.data_ptr(), scratch_bytes[0])
    p = int(off[n])  # the one read-back: P sizes the sort
    # the sort's scratch, the emit kernel, the sort and the ranges
    _SCRATCH(n, p, end_bit, scratch_bytes, device=device)
    scratch = torch.empty(max(scratch_bytes[1], 1), dtype=torch.uint8, device=device)
    keys_in = torch.empty(p, dtype=torch.int64, device=device)
    keys_out = torch.empty(p, dtype=torch.int64, device=device)
    vals_in = torch.empty(p, **i32)
    out["pair_rank"] = torch.empty(slots, **i32)
    out["pair_tile"] = torch.empty(slots, **i32)
    out["offsets"] = torch.empty(num_tiles + 1, **i32)
    out["counts"] = torch.empty(num_tiles, **i32)
    _PAIRS.launch(
        device,
        dkeys.data_ptr(), foot.data_ptr(), off.data_ptr(), n, p, slots, cfg.tiles_x,
        num_tiles, end_bit, keys_in.data_ptr(), keys_out.data_ptr(), vals_in.data_ptr(),
        scratch.data_ptr(), scratch_bytes[1], out["pair_rank"].data_ptr(),
        out["pair_tile"].data_ptr(), out["offsets"].data_ptr(), out["counts"].data_ptr(),
        count="bin_words")
    return out
