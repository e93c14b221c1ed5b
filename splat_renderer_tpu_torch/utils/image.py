"""Minimal dependency-free PNG writer and reader for frame output.

Counterpart of `splat_renderer_tpu/utils/image.py`: the PNG code is the same
stdlib + numpy host code (equal arrays give byte-identical files);
`to_uint8_rows` quantizes a device tensor on its device.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .._torch_util import to_numpy


def to_uint8(img) -> np.ndarray:
    """(…) float [0, 1] -> uint8 on the host: round(x * 255), NaN as 0."""
    arr = to_numpy(img)
    # in-place pipeline: one allocation instead of four
    x = arr * np.float32(255.0)
    x += np.float32(0.5)
    np.nan_to_num(x, copy=False)
    np.clip(x, 0, 255, out=x)
    return x.astype(np.uint8)


def to_uint8_rows(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float32 [0, 1] tensor -> (H, W*3) uint8 flat raster rows,
    on the tensor's device.

    The twin of `to_uint8` for device tensors: quantizing on the device
    makes the device-to-host copy a quarter of the float image's.  The flat
    row layout is the one the viewer ships and `unflatten_rows` undoes on
    the host."""
    x = torch.clamp(torch.nan_to_num(img) * 255.0 + 0.5, 0.0, 255.0)
    return x.to(torch.uint8).reshape(img.shape[0], -1)


def unflatten_rows(arr, width: int) -> np.ndarray:
    """(..., H, W*3) flat interleaved raster rows -> (..., H, W, 3), on the
    host: the inverse of the `flat=True` output layout of render_sequence /
    render_views and of `to_uint8_rows`."""
    a = to_numpy(arr)
    return a.reshape(a.shape[:-1] + (width, 3))


def write_png(path: str, img, fast: bool = True) -> None:
    """img: (H, W, 3) float [0,1] or uint8.

    fast=True (default) uses PNG filter 1 (Sub) with a vectorized diff and
    zlib level 1 (Sub-filtered natural images compress fine at level 1).
    fast=False keeps filter 0 + level 6 for marginally smaller files.
    """
    arr = to_numpy(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    h, w = arr.shape[:2]
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)

    flat = arr.reshape(h, w * 3)
    if fast:
        # filter 1 (Sub): delta against the previous PIXEL's byte — turns
        # smooth gradients into near-zero runs that fast deflate eats
        sub = flat.copy()
        sub[:, 3:] = flat[:, 3:] - flat[:, :-3]
        rows = np.concatenate(
            [np.full((h, 1), 1, np.uint8), sub], axis=1
        )
        level = 1
    else:
        rows = np.concatenate(
            [np.zeros((h, 1), np.uint8), flat], axis=1
        )
        level = 6
    raw = rows.tobytes()
    _write_png_chunks(path, w, h, bit_depth=8, color_type=2, raw=raw,
                      level=level)


def _write_png_chunks(
    path: str, w: int, h: int, bit_depth: int, color_type: int,
    raw: bytes, level: int,
) -> None:
    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal stdlib-only PNG reader — write_png/write_png16's inverse,
    plus enough generality for externally-produced training data (the
    dataset loader, data.py): color types 0 (gray), 2 (RGB), 4 (gray+A),
    6 (RGBA); bit depths 8 and 16; all five scanline filters; no interlace.

    Returns (H, W) or (H, W, C) uint8/uint16 exactly as stored (use
    load_image for float [0, 1] RGB).  Filters None/Sub/Up are vectorized;
    Average/Paeth fall back to a per-pixel row loop (correct, slower —
    write_png never emits them)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(raw):
        (ln,) = struct.unpack(">I", raw[pos:pos + 4])
        tag = raw[pos + 4:pos + 8]
        data = raw[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
        pos += 12 + ln
    if ihdr is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, color, comp, filt, interlace = ihdr
    if comp or filt or interlace:
        raise ValueError(f"{path}: unsupported compression/filter/interlace")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if channels is None or depth not in (8, 16):
        raise ValueError(f"{path}: unsupported color type {color}/{depth}-bit")
    bpp = channels * (depth // 8)  # filter unit: one pixel's bytes
    stride = w * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + stride)
    ftypes = rows[:, 0]
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint32)
    for y in range(h):
        cur = rows[y, 1:].astype(np.uint32)
        ft = int(ftypes[y])
        if ft == 0:
            rec = cur
        elif ft == 1:  # Sub: recon[x] = raw[x] + recon[x - bpp]
            g = cur.reshape(w, bpp)
            rec = np.cumsum(g, axis=0, dtype=np.uint32).reshape(-1) & 0xFF
            # cumsum of the raw bytes IS the recon mod 256 (addition chains)
        elif ft == 2:  # Up
            rec = (cur + prev) & 0xFF
        elif ft == 3:  # Average — horizontal recurrence: per-pixel loop
            rec = np.zeros((stride,), np.uint32)
            for x in range(stride):
                left = rec[x - bpp] if x >= bpp else 0
                rec[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            rec = np.zeros((stride,), np.uint32)
            for x in range(stride):
                a = int(rec[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad filter type {ft}")
        out[y] = rec.astype(np.uint8)
        prev = rec
    if depth == 16:
        arr = np.ascontiguousarray(out).view(">u2").astype(np.uint16)
        arr = arr.reshape(h, w, channels)
    else:
        arr = out.reshape(h, w, channels)
    return arr[:, :, 0] if channels == 1 else arr


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] from a PNG of any supported layout —
    the fit-from-disk target format (gray broadcasts to RGB; alpha, if
    present, is dropped — datasets carry it as a separate channel file)."""
    arr = read_png(path)
    scale = np.float32(1.0 / (65535.0 if arr.dtype == np.uint16 else 255.0))
    x = arr.astype(np.float32) * scale
    if x.ndim == 2:
        return np.repeat(x[:, :, None], 3, axis=2)
    if x.shape[2] == 2:  # gray + alpha
        return np.repeat(x[:, :, :1], 3, axis=2)
    return x[:, :, :3]


def write_png16(path: str, img) -> None:
    """img: (H, W) uint16, or float in [0, 1] (scaled to the full u16
    range).  16-bit grayscale PNG — the standard lossless container for
    depth maps (datagen's G-buffer depth channel).  Filter 0 + deflate
    level 1: depth rasters are piecewise-smooth, Sub filtering on the
    big-endian byte stream would split each sample across two deltas for
    no gain."""
    arr = to_numpy(img)
    if arr.dtype != np.uint16:
        x = np.asarray(arr, np.float32) * np.float32(65535.0)
        x += np.float32(0.5)
        np.nan_to_num(x, copy=False)
        np.clip(x, 0, 65535, out=x)
        arr = x.astype(np.uint16)
    h, w = arr.shape
    be = np.ascontiguousarray(arr.astype(">u2")).view(np.uint8).reshape(h, w * 2)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), be], axis=1)
    _write_png_chunks(path, w, h, bit_depth=16, color_type=0,
                      raw=rows.tobytes(), level=1)
