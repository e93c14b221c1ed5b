"""The differentiable tile blend: CUDA forward and backward kernels inside
one `torch.autograd.Function`, and their plain PyTorch twin.

`blend_planes` composites continuous (N,) record planes (render/diff.py's
"kernel" method).  For CUDA tensors its forward launches the hand-written
Hopper kernel `tile_blend_diff_forward` and its backward
`tile_blend_diff_backward` (csrc/tile_blend_diff.cu, which replaces the JAX
package's Pallas kernels `ops/tile_blend_diff.py::_make_fwd_kernel` and
`_make_bwd_kernel`); a failed build or launch raises, nothing falls back.
For CPU tensors it runs `blend_planes_plain`, the same function in plain
PyTorch, differentiated by autograd.  The launch counter `launches` of
`ops/build.py` counts the kernels' launches under "tile_blend_diff_forward"
and "tile_blend_diff_backward".

Semantics are those of the JAX package's `blend_planes_pallas`: no early
exit, alpha clamped at ALPHA_CAP, colour and expected depth accumulated
under the same blend weights; gradients reach every plane, depth through
its value only (the compositing order is structure), and isotropic
profiles give angle and ratio zero gradients.

The backward kernel computes the blend adjoint from back-to-front
recurrences, without the TPU kernel's division by 1 - alpha (see the csrc
header), in one pass over the pair stream: when a gradient will be asked
for, the forward kernel also leaves each pixel's transmittance at the start
of every backward chunk (`bwd_chunk(cfg)` records), and the backward walks a
tile's chunks last to first from those.  `diff_fold_plain` is the forward's
sequential fold and `diff_residuals_plain` its residual, in the kernel's row
layout (`residual_row0`); `blend_adjoint_plain` is the backward's recurrence
on that residual, in plain PyTorch.  The tests hold them against the
kernels, autograd and the JAX package; nothing on the card's path calls
them.  Gradient routing is deterministic: the backward kernel writes each
pair's row at its pre-sort slot `c * n + rank` (unique, so an assignment),
the cap slots of a record are summed by a reshape, and ranks go back to
input order through `src`.  No float atomics anywhere, so two runs give the
same bits.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._torch_util import maximum, minimum, rdiv
from ..config import RenderConfig
from ..render.binning import Binned, bin_planes_diff, diff_fields
from ..render.blend import ellipse_cos_sin, segmented_exclusive_product
from .build import Entry, check_tensor

ALPHA_CAP = 1.0 - 1e-7  # shared with render/compositor.py's differentiable mode
MAX_TILE_PIXELS = 1024  # one thread per pixel, one CTA per tile
# The backward keeps T_i and shape_i of a chunk's evaluations in shared
# memory, 8 bytes per (record, pixel): this budget fixes the chunk.
_BWD_STATE_BYTES = 64 * 1024
_PAIR_CHUNK = 1024  # pairs per step of the twin's walk over the pair stream

_PLANE_NAMES = ("cx", "cy", "radius", "opacity", "r", "g", "b", "angle", "ratio", "depth")

TileOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 6 + [_F] * 4 + [_P]  # _scalars(cfg), then the stream
_FORWARD = Entry("tile_blend_diff", "tile_blend_diff_forward", [_P] * 7 + _TAIL)
_BACKWARD = Entry("tile_blend_diff", "tile_blend_diff_backward", [_P] * 9 + _TAIL)
_LAUNCH_INFO = Entry("tile_blend_diff", "tile_blend_diff_launch_info", [_I] * 5 + [_P])


def bwd_chunk(cfg: RenderConfig) -> int:
    """Records per backward chunk at cfg's tile shape: 32 (one mask word)
    for tiles of up to 256 pixels, 16 up to 512, 8 above."""
    fit = _BWD_STATE_BYTES // (8 * cfg.tile_pixels)
    return 32 if fit >= 32 else 16 if fit >= 16 else 8


def launch_info(cfg: RenderConfig, forward: bool = False) -> dict:
    """What the backward kernel (or with `forward`, the forward kernel as the
    training step launches it, residuals and all) gets on the current CUDA
    device at cfg's profile and tile shape: registers per thread, resident
    CTAs per SM (the occupancy query's answer), SMs, dynamic shared memory
    bytes, the backward's chunk."""
    out = (ctypes.c_int * 4)()
    _LAUNCH_INFO(int(cfg.oriented), cfg.tile_w, cfg.tile_h, bwd_chunk(cfg), int(forward), out)
    regs, per_sm, sms, smem = out
    return dict(registers=regs, ctas_per_sm=per_sm, sms=sms, smem_bytes=smem,
                bwd_chunk=bwd_chunk(cfg))


def _check_launchable(binned: Binned, cfg: RenderConfig) -> torch.device:
    device = binned["offsets"].device
    if device.type != "cuda":
        raise ValueError(f"no differentiable tile-blend kernel for device {device}")
    tp = cfg.tile_pixels
    if tp > MAX_TILE_PIXELS or tp % 32:
        raise ValueError(
            f"tile {cfg.tile_w}x{cfg.tile_h} has {tp} pixels; the kernels run one "
            f"thread per pixel: a multiple of 32, at most {MAX_TILE_PIXELS}"
        )
    for name in ("offsets", "pair_rank", "pair_slot"):
        check_tensor(f"binned[{name!r}]", binned[name], torch.int32, device)
    planes = binned["planes"]
    # copied to a contiguous, aligned block before a launch (_aligned_planes)
    check_tensor("binned['planes']", planes, torch.float32, device,
                 shape=(planes.shape[0], len(diff_fields(cfg))), contiguous=False)
    return device


def _scalars(cfg: RenderConfig):
    return (bwd_chunk(cfg), cfg.num_tiles, cfg.tiles_x, cfg.tile_w, cfg.tile_h, int(cfg.oriented),
            cfg.min_screen_radius, cfg.bounds_margin * cfg.bounds_margin,
            -0.5 / (cfg.sigma * cfg.sigma), ALPHA_CAP)


def residual_rows(binned: Binned, cfg: RenderConfig, chunk: int) -> int:
    """Rows of the forward's residual for `chunk`-record chunks: room for the
    chunks of every tile of a stream of up to n * cap pairs."""
    return (binned["planes"].shape[0] * cfg.tiles_per_splat_cap) // chunk + cfg.num_tiles + 1


def residual_row0(binned: Binned, chunk: int) -> torch.Tensor:
    """(T,) int64: the residual row of each tile's first chunk,
    offsets[t] // chunk + t (csrc chunk_row); tile t's chunk c is row
    row0[t] + c.  No two tiles' rows overlap."""
    offsets = binned["offsets"].to(torch.int64)
    return offsets[:-1] // chunk + torch.arange(offsets.numel() - 1, device=offsets.device)


def residual_rows_used(binned: Binned, chunk: int) -> torch.Tensor:
    """The residual rows that hold a chunk of some tile, ascending (int64)."""
    counts = (binned["offsets"][1:] - binned["offsets"][:-1]).to(torch.int64)
    n = (counts + chunk - 1) // chunk
    first = torch.repeat_interleave(residual_row0(binned, chunk), n)
    base = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    return first + torch.arange(first.numel(), device=first.device) - base


def _aligned_planes(binned: Binned) -> torch.Tensor:
    """The record planes as the kernels read them: contiguous, and 16-byte
    aligned for the forward's 16-byte row loads and the backward's
    asynchronous row copies."""
    planes = binned["planes"].detach().contiguous()
    return planes if planes.data_ptr() % 16 == 0 else planes.clone()


def diff_forward(
    binned: Binned, cfg: RenderConfig, residuals: bool = False
) -> Tuple[torch.Tensor, ...]:
    """Launch the forward kernel on `bin_planes_diff`'s stream (CUDA
    tensors only).  Returns (tile_color (T, tp, 3), tile_alpha (T, tp),
    tile_depth (T, tp)); tiles with no records come out as 0.

    residuals: a fourth output, what `diff_backward` reads: t_start (rows,
    tp) float32, every pixel's transmittance at the start of each chunk of
    `bwd_chunk(cfg)` records; tile t's chunks start at row
    offsets[t] // bwd_chunk + t, which needs no table and no host sync."""
    device = _check_launchable(binned, cfg)
    t, tp = cfg.num_tiles, cfg.tile_pixels
    planes = _aligned_planes(binned)
    t_start = None
    if residuals:
        rows = residual_rows(binned, cfg, bwd_chunk(cfg))
        t_start = torch.empty((rows, tp), dtype=torch.float32, device=device)
    tile_color = torch.empty((t, tp, 3), dtype=torch.float32, device=device)
    tile_alpha = torch.empty((t, tp), dtype=torch.float32, device=device)
    tile_depth = torch.empty((t, tp), dtype=torch.float32, device=device)
    _FORWARD.launch(
        device,
        binned["offsets"].data_ptr(), binned["pair_rank"].data_ptr(),
        planes.data_ptr(), tile_color.data_ptr(), tile_alpha.data_ptr(),
        tile_depth.data_ptr(),
        None if t_start is None else t_start.data_ptr(), *_scalars(cfg),
        count="tile_blend_diff_forward",
    )
    outs = (tile_color, tile_alpha, tile_depth)
    return outs + (t_start,) if residuals else outs


def diff_backward(
    binned: Binned, cfg: RenderConfig, cotangents: TileOutputs, t_start: torch.Tensor
) -> torch.Tensor:
    """Launch the backward kernel (CUDA tensors only) and route its
    per-pair rows to input order.  `cotangents` are the gradients of the
    forward's (tile_color, tile_alpha, tile_depth); `t_start` is the fourth
    output of `diff_forward(binned, cfg, residuals=True)` on the same
    stream.  Returns (N, nf) gradients in diff_fields order."""
    device = _check_launchable(binned, cfg)
    n, nf = binned["planes"].shape
    cap = cfg.tiles_per_splat_cap
    rows = residual_rows(binned, cfg, bwd_chunk(cfg))
    check_tensor("t_start (the residuals of diff_forward(binned, cfg, residuals=True))",
                 t_start, torch.float32, device, shape=(rows, cfg.tile_pixels))
    planes = _aligned_planes(binned)
    cots = [c.to(torch.float32).contiguous() for c in cotangents]
    grad_slots = torch.zeros((cap * n, nf), dtype=torch.float32, device=device)
    _BACKWARD.launch(
        device,
        binned["offsets"].data_ptr(), binned["pair_rank"].data_ptr(),
        binned["pair_slot"].data_ptr(), planes.data_ptr(),
        *(c.data_ptr() for c in cots), t_start.data_ptr(),
        grad_slots.data_ptr(), *_scalars(cfg),
        count="tile_blend_diff_backward",
    )
    per_rank = grad_slots.view(cap, n, nf).sum(0)  # fixed order: deterministic
    grads = torch.empty_like(per_rank)
    grads[binned["src"]] = per_rank  # src is a permutation: an assignment
    return grads


class _BlendPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, *plane_args):
        binned = bin_planes_diff(dict(zip(_PLANE_NAMES, plane_args)), cfg)
        ctx.cfg, ctx.binned = cfg, binned
        # the backward's residuals only when a gradient can be asked for
        need = any(ctx.needs_input_grad)
        outs = diff_forward(binned, cfg, residuals=need)
        ctx.t_start = outs[3] if need else None
        return outs[:3]

    @staticmethod
    def backward(ctx, g_color, g_alpha, g_depth):
        cfg = ctx.cfg
        grads = diff_backward(ctx.binned, cfg, (g_color, g_alpha, g_depth), ctx.t_start)
        cols = grads.unbind(1)
        zero = torch.zeros_like(cols[0])
        g_ang, g_ratio = (cols[7], cols[8]) if cfg.oriented else (zero, zero)
        return (None,) + cols[:7] + (g_ang, g_ratio, cols[-1])


def blend_planes(
    cfg: RenderConfig,
    cx: torch.Tensor,
    cy: torch.Tensor,
    radius: torch.Tensor,
    opacity: torch.Tensor,
    cr: torch.Tensor,
    cg: torch.Tensor,
    cb: torch.Tensor,
    angle: torch.Tensor,
    ratio: torch.Tensor,
    depth: torch.Tensor,
) -> TileOutputs:
    """Differentiable tile blend of continuous (N,) record planes.

    Returns (tile_color (T, tp, 3), tile_alpha (T, tp), tile_depth (T, tp));
    tile_depth is the alpha-weighted depth sum under the colour's blend
    weights.  CUDA tensors run the kernels, CPU tensors the plain twin."""
    planes = (cx, cy, radius, opacity, cr, cg, cb, angle, ratio, depth)
    device = cx.device
    if device.type == "cpu":
        return blend_planes_plain(cfg, *planes)
    if device.type != "cuda":
        raise ValueError(f"no differentiable tile-blend kernel for device {device}")
    return _BlendPlanes.apply(cfg, *planes)


def diff_cut2(planes: torch.Tensor, cfg: RenderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cut2, rr) of (N, nf) record planes as the kernels stage them for the
    warp culling test (`tile_blend.cull_live_plain`): the cutoff on dist2,
    -1 below min_screen_radius, and the ellipse's ratio (1 when isotropic)."""
    r = planes[:, 2]
    rr = maximum(planes[:, 8], 1e-3) if cfg.oriented else torch.ones_like(r)
    scale = r * rr if cfg.oriented else r
    margin2 = cfg.bounds_margin * cfg.bounds_margin
    return torch.where(r >= cfg.min_screen_radius, margin2 * (scale * scale), -1.0), rr


def _pair_alpha(cfg: RenderConfig, rec: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """(a_raw, a) of each (pair, pixel): the kernels' op sequence
    (`inv_s2`, `nd2`, the clamp at ALPHA_CAP) over (c, nf) records."""
    cx, cy, r, op = rec[:, 0:1], rec[:, 1:2], rec[:, 2:3], rec[:, 3:4]
    dx = px - cx
    dy = py - cy
    if cfg.oriented:
        rr = maximum(rec[:, 8:9], 1e-3)
        ca, sa = ellipse_cos_sin(rec[:, 7:8])
        u = ca * dx + sa * dy
        vr = (-sa * dx + ca * dy) * rr
        dist2 = u * u + vr * vr
        scale = r * rr
    else:
        dist2 = dx * dx + dy * dy
        scale = r
    scale2 = scale * scale
    inv_s2 = rdiv(1.0, maximum(scale2, 1e-12))
    margin2 = cfg.bounds_margin * cfg.bounds_margin
    inv_2sigma2 = 0.5 / (cfg.sigma * cfg.sigma)
    inside = (r >= cfg.min_screen_radius) & (dist2 <= margin2 * scale2)
    shape = torch.where(inside, torch.exp(-inv_2sigma2 * (dist2 * inv_s2)), 0.0)
    a_raw = op * shape
    return a_raw, minimum(a_raw, ALPHA_CAP)


def blend_planes_plain(
    cfg: RenderConfig,
    cx: torch.Tensor,
    cy: torch.Tensor,
    radius: torch.Tensor,
    opacity: torch.Tensor,
    cr: torch.Tensor,
    cg: torch.Tensor,
    cb: torch.Tensor,
    angle: torch.Tensor,
    ratio: torch.Tensor,
    depth: torch.Tensor,
) -> TileOutputs:
    """`blend_planes` in plain PyTorch, on any device; autograd gives its
    gradients.  Bins the planes, then `blend_binned_plain`."""
    planes = dict(zip(_PLANE_NAMES, (cx, cy, radius, opacity, cr, cg, cb, angle, ratio, depth)))
    return blend_binned_plain(bin_planes_diff(planes, cfg), cfg)


def blend_binned_plain(binned: Binned, cfg: RenderConfig) -> TileOutputs:
    """The forward kernel's function in plain PyTorch over a
    `bin_planes_diff` stream; differentiable in binned["planes"].

    The tile-sorted pair stream is walked in chunks: per chunk every pair's
    alpha over its tile's pixels, the within-chunk transmittance as a
    segmented exclusive product, colour and depth folded in with
    `index_add`, and each tile's transmittance carried across chunks.
    Autograd keeps (pairs x tile_pixels) intermediates: hold it against the
    kernels at moderate sizes.  It is not `compositor.render_tiles`, the
    independent reference (see that module's docstring for why both stay).
    """
    rec_planes = binned["planes"]
    device = rec_planes.device
    num_tiles, tp, tw = cfg.num_tiles, cfg.tile_pixels, cfg.tile_w
    n_pairs = int(binned["offsets"][-1])
    lane = torch.arange(tp, device=device)
    lx = (lane % tw).to(torch.float32) + 0.5
    ly = (lane // tw).to(torch.float32) + 0.5

    f32 = dict(dtype=torch.float32, device=device)
    color = torch.zeros((num_tiles, tp, 3), **f32)
    depth_acc = torch.zeros((num_tiles, tp), **f32)
    trans = torch.ones((num_tiles, tp), **f32)
    for lo in range(0, n_pairs, _PAIR_CHUNK):
        hi = min(lo + _PAIR_CHUNK, n_pairs)
        tiles = binned["pair_tile"][lo:hi].to(torch.int64)
        # index_select, not advanced indexing: its backward is a serial
        # index_add, where PyTorch's CPU backward of a repeated-index gather
        # adds with parallel atomics and is not bit-deterministic
        rec = rec_planes.index_select(0, binned["pair_rank"][lo:hi].to(torch.int64))  # (c, nf)
        pxc = ((tiles % cfg.tiles_x).to(torch.float32) * tw)[:, None] + lx[None, :]
        pyc = ((tiles // cfg.tiles_x).to(torch.float32) * cfg.tile_h)[:, None] + ly[None, :]
        _, a = _pair_alpha(cfg, rec, pxc, pyc)  # (c, tp)
        q = 1.0 - a
        same = tiles[1:] == tiles[:-1]
        starts = torch.cat([same.new_ones(1), ~same])
        t_local = segmented_exclusive_product(q, starts)
        carry = trans.index_select(0, tiles)
        weight = a * t_local * carry
        color = color.index_add(0, tiles, weight[:, :, None] * rec[:, None, 4:7])
        depth_acc = depth_acc.index_add(0, tiles, weight * rec[:, -1:])
        # a tile's run inside a chunk is one segment: fold its product at
        # the segment's last pair
        ends = torch.cat([~same, same.new_ones(1)])
        trans = trans.index_put((tiles[ends],), (carry * t_local * q)[ends])
    return color, 1.0 - trans, depth_acc


def diff_fold_plain(
    binned: Binned, cfg: RenderConfig, chunk: int = 0, stop_at_zero: bool = False
) -> Tuple[torch.Tensor, ...]:
    """The forward kernel's fold in plain float32 PyTorch: per pixel, record
    after record in run order, w = a T, C += rgb w, D += d w, T *= 1 - a,
    with the kernel's alpha (`_pair_alpha`).  Returns (tile_color, tile_alpha,
    tile_depth) and, with `chunk` > 0, the residual: t_start in the
    kernel's row layout (`residual_row0`, `residual_rows` rows), T before
    the first record of every `chunk` records; rows no chunk uses are 0.

    stop_at_zero: a pixel whose T is exactly 0 takes nothing more, as the
    kernel's pixels stop; with finite planes that changes no bit.

    The tiles advance together, one record index per step, so the Python
    loop runs as many steps as the heaviest tile has records."""
    planes = binned["planes"].detach()
    device = planes.device
    num_tiles, tp, tw = cfg.num_tiles, cfg.tile_pixels, cfg.tile_w
    offsets = binned["offsets"].to(torch.int64)
    counts = offsets[1:] - offsets[:-1]
    # the state lives in tile order heaviest first: the tiles still walking
    # at record index k are a prefix
    order = torch.sort(counts, descending=True, stable=True).indices
    left = counts[order].tolist()
    lane = torch.arange(tp, device=device)
    lx = (lane % tw).to(torch.float32) + 0.5
    ly = (lane // tw).to(torch.float32) + 0.5
    px = ((order % cfg.tiles_x) * tw).to(torch.float32)[:, None] + lx
    py = ((order // cfg.tiles_x) * cfg.tile_h).to(torch.float32)[:, None] + ly
    first = offsets[:-1][order]
    f32 = dict(dtype=torch.float32, device=device)
    color = torch.zeros((num_tiles, tp, 3), **f32)
    depth = torch.zeros((num_tiles, tp), **f32)
    trans = torch.ones((num_tiles, tp), **f32)
    t_start = None
    if chunk:
        t_start = torch.zeros((residual_rows(binned, cfg, chunk), tp), **f32)
        row0 = residual_row0(binned, chunk)[order]
    walking = num_tiles
    for k in range(left[0] if left else 0):
        while left[walking - 1] <= k:
            walking -= 1
        m = walking
        if chunk and k % chunk == 0:
            t_start[row0[:m] + k // chunk] = trans[:m]
        rec = planes.index_select(0, binned["pair_rank"][first[:m] + k].to(torch.int64))
        _, a = _pair_alpha(cfg, rec, px[:m], py[:m])  # (m, tp)
        w = a * trans[:m]
        c_new = color[:m] + rec[:, None, 4:7] * w[:, :, None]
        d_new = depth[:m] + rec[:, -1:] * w
        t_new = trans[:m] * (1.0 - a)
        if stop_at_zero:
            stopped = trans[:m] == 0.0
            c_new = torch.where(stopped[:, :, None], color[:m], c_new)
            d_new = torch.where(stopped, depth[:m], d_new)
            t_new = torch.where(stopped, trans[:m], t_new)
        color[:m], depth[:m], trans[:m] = c_new, d_new, t_new
    back = torch.empty_like(order)
    back[order] = torch.arange(num_tiles, device=device)
    outs = (color[back], 1.0 - trans[back], depth[back])
    return outs + (t_start,) if chunk else outs


def diff_residuals_plain(binned: Binned, cfg: RenderConfig, chunk: int) -> torch.Tensor:
    """The forward kernel's residual in plain PyTorch: every pixel's T at
    the start of each `chunk` records, a sequential float32 product, at row
    offsets[t] // chunk + t + c of tile t's chunk c (`diff_fold_plain`)."""
    return diff_fold_plain(binned, cfg, chunk)[3]


def blend_adjoint_plain(
    binned: Binned, cfg: RenderConfig, cotangents: TileOutputs, chunk: int = 32
) -> torch.Tensor:
    """The backward kernel's recurrence in plain float32 PyTorch: (N, nf)
    gradients of sum(outputs * cotangents) with respect to
    binned["planes"], in rank order.

    Per tile: the forward's residual (`diff_residuals_plain`) holds every
    pixel's T at the start of each `chunk` records; the chunks are walked
    last to first with R (what follows a record, seen through it) and Q
    (the product of 1 - a behind it) carried along; inside a chunk T_i is
    rebuilt forward from the chunk's start and the adjoint dL/da_i = T_i
    (w_i - R_i + gA Q_i) runs back to front, chained to the fields term for
    term as csrc/tile_blend_diff.cu does.  T_i is the same product in the
    same order whatever the chunk, so the result does not depend on it.  A
    Python loop over every record of every tile: for tests at small sizes.
    """
    planes = binned["planes"].detach()
    nf = planes.shape[1]
    g_color, g_alpha, g_depth = (c.to(torch.float32) for c in cotangents)
    tp, tw = cfg.tile_pixels, cfg.tile_w
    margin2 = cfg.bounds_margin * cfg.bounds_margin
    neg = -0.5 / (cfg.sigma * cfg.sigma)
    lane = torch.arange(tp, device=planes.device)
    lx = (lane % tw).to(torch.float32) + 0.5
    ly = (lane // tw).to(torch.float32) + 0.5
    offsets = binned["offsets"].tolist()
    t_start = diff_residuals_plain(binned, cfg, chunk)
    row0 = residual_row0(binned, chunk).tolist()
    grads = torch.zeros_like(planes)
    for t in range(cfg.num_tiles):
        lo, hi = offsets[t], offsets[t + 1]
        if hi == lo:
            continue
        ranks = binned["pair_rank"][lo:hi].to(torch.int64)
        rec = planes.index_select(0, ranks)
        col = lambda k: rec[:, k:k + 1]  # noqa: E731
        r, op, d = col(2), col(3), col(nf - 1)
        dx = (float((t % cfg.tiles_x) * tw) + lx)[None, :] - col(0)
        dy = (float((t // cfg.tiles_x) * cfg.tile_h) + ly)[None, :] - col(1)
        if cfg.oriented:
            ratio = col(8)
            rr = maximum(ratio, 1e-3)
            ca, sa = ellipse_cos_sin(col(7))
            u = ca * dx + sa * dy
            vr = (-sa * dx + ca * dy) * rr
            dist2 = u * u + vr * vr
            scale = r * rr
        else:
            dist2 = dx * dx + dy * dy
            scale = r
        scale2 = scale * scale
        inv_s2 = rdiv(1.0, maximum(scale2, 1e-12))
        inside = (r >= cfg.min_screen_radius) & (dist2 <= margin2 * scale2)
        nd2 = dist2 * inv_s2
        shape = torch.where(inside, torch.exp(neg * nd2), 0.0)
        a_raw = op * shape
        a = minimum(a_raw, ALPHA_CAP)  # (m, tp)
        m = a.shape[0]
        gc, ga_out, gd = g_color[t], g_alpha[t], g_depth[t]
        w_pan = ((col(4) * gc[:, 0] + col(5) * gc[:, 1]) + col(6) * gc[:, 2]) + d * gd

        t_i = torch.empty_like(a)
        r_i, q_i = torch.empty_like(a), torch.empty_like(a)
        r_acc = torch.zeros(tp, dtype=torch.float32, device=planes.device)
        q_acc = torch.ones_like(r_acc)
        for c in range((m + chunk - 1) // chunk - 1, -1, -1):
            i0, i1 = c * chunk, min(m, (c + 1) * chunk)
            trans = t_start[row0[t] + c]  # the forward's residual
            for i in range(i0, i1):  # T_i forward inside the chunk
                t_i[i] = trans
                trans = trans * (1.0 - a[i])
            for i in range(i1 - 1, i0 - 1, -1):  # R_i, Q_i back to front
                r_i[i], q_i[i] = r_acc, q_acc
                r_acc = w_pan[i] * a[i] + (1.0 - a[i]) * r_acc
                q_acc = q_acc * (1.0 - a[i])

        g_a = t_i * ((w_pan - r_i) + ga_out * q_i)
        g_prod = torch.where(inside & (a_raw < ALPHA_CAP), g_a, 0.0)
        g_nd2 = ((g_prod * op) * neg) * shape
        g_dist2 = g_nd2 * inv_s2
        at = torch.where(inside, a * t_i, 0.0)
        s2 = (g_nd2 * nd2).sum(1, keepdim=True)
        alive = (scale2 > 1e-12).to(torch.float32)
        rows = torch.zeros((m, nf), dtype=torch.float32, device=planes.device)
        if cfg.oriented:
            g_u = (g_dist2 * 2.0) * u
            g_vr = (g_dist2 * 2.0) * vr
            rows[:, 0:1] = (-(g_u * ca + g_vr * (-sa * rr))).sum(1, keepdim=True)
            rows[:, 1:2] = (-(g_u * sa + g_vr * (ca * rr))).sum(1, keepdim=True)
            s8 = (g_u * dx + (g_vr * dy) * rr).sum(1, keepdim=True)
            s9 = (g_u * dy - (g_vr * dx) * rr).sum(1, keepdim=True)
            s10 = (g_vr * vr).sum(1, keepdim=True)
            rows[:, 7:8] = -s8 * sa + s9 * ca
            g_rr = s10 / rr + ((s2 * -2.0) * alive) / rr
            rows[:, 8:9] = torch.where(ratio >= 1e-3, g_rr, 0.0)
        else:
            rows[:, 0:1] = ((g_dist2 * -2.0) * dx).sum(1, keepdim=True)
            rows[:, 1:2] = ((g_dist2 * -2.0) * dy).sum(1, keepdim=True)
        rows[:, 2:3] = ((s2 * -2.0) * alive) / maximum(r, 1e-9)
        rows[:, 3] = (g_prod * shape).sum(1)
        for k in range(3):
            rows[:, 4 + k] = (gc[:, k] * at).sum(1)
        rows[:, nf - 1] = (gd * at).sum(1)
        grads.index_add_(0, ranks, rows)
    return grads
