"""The reference frame: scene -> splats -> words -> per-tile runs -> image.

Everything here is plain PyTorch over the frozen copies beside it.  The
blend is the exact front-to-back fold of the frame's semantics, walked one
record at a time for every pixel of every tile at once: per pixel,
w = alpha * T, colour += rgb * w, T *= 1 - alpha, and the pixel takes
nothing more once T <= eps (after the record that brought it there).
While it folds it counts the work those semantics need: the (record,
pixel) evaluations up to each pixel's stop, those inside a record's
support, and the pairs and records that some pixel still alive reads.

`rnd` is the control's hook: the identity for the reference, a rounding to
bfloat16 for the control (`bf16`), applied to every floating value one
stage hands to the next and to the fold's running sums.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .config import PointConfig, RenderConfig
from .points import curvature_probe, derive_splats, project_to_surface, seed_scene_points
from .render.binning import bin_packed_words
from .render.blend import splat_alpha_planes
from .render.compositor import tiles_to_image
from .render.packing import U32_MASK, unpack_words
from .render.projector import splat_screen_words
from .render.sh import apply_sh
from .sdf.scene import SDFScene

Rounding = Callable[[torch.Tensor], torch.Tensor]


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to bfloat16 and back: the control's storage."""
    return x.to(torch.bfloat16).to(torch.float32)


def model_splats(scene: SDFScene, generator: torch.Generator, n: int, pcfg: PointConfig,
                 rcfg: RenderConfig, rnd: Rounding = exact) -> Dict[str, torch.Tensor]:
    """The modeler: n points seeded from `generator` on the scene's box,
    projected to the surface, probed for curvature, turned into splats."""
    params = scene.params(generator.device)
    pts = seed_scene_points(generator, scene, params, n, pcfg)
    pts = project_to_surface(scene, params, pts, pcfg.descent_steps)
    normals, scales = curvature_probe(scene, params, pts, pcfg)
    splats = derive_splats(pts, normals, scales, rcfg)
    return {k: rnd(v) for k, v in splats.items()}


def lit_splats(splats, sh, cam_pos, rnd: Rounding = exact):
    """SH lighting along the camera ray (the static scene's colours)."""
    out = apply_sh(splats, sh, cam_pos)
    return dict(out, **{k: rnd(out[k]) for k in ("cr", "cg", "cb")})


def words_and_bins(splats, camera, rcfg: RenderConfig):
    words = splat_screen_words(splats, camera["view_proj"], camera["cam_pos"], rcfg)
    binned = bin_packed_words(words["dk"], words["w_pos"], words["w_ro"], words["w_rgb"], rcfg)
    return words, binned


CHUNK = 32  # record positions a step of the folds takes at once


def run_positions(offsets, k0: int, kk: int, tiles_m, cnt_m, pair_rank):
    """(ranks (kk, m), valid (kk, m)) of record positions k0 .. k0+kk-1 of
    the m tiles `tiles_m` whose runs hold `cnt_m` records; past a tile's
    run the rank repeats its last record and valid is False."""
    pos = torch.arange(k0, k0 + kk, device=offsets.device)[:, None]
    valid = pos < cnt_m[None, :]
    at = offsets[:-1][tiles_m][None, :] + torch.minimum(pos, (cnt_m - 1)[None, :])
    return pair_rank[at].to(torch.int64), valid


def fold_blend(binned, rcfg: RenderConfig, eps: Optional[float] = None,
               rnd: Rounding = exact):
    """The exact fold of every tile's run, record position by record
    position for all tiles at once (the alphas of CHUNK positions are
    evaluated together; the fold itself stays sequential).

    Returns (tile_color (T, tp, 3), tile_alpha (T, tp), counts) where counts
    has "evals" (record, pixel) evaluations up to each pixel's stop,
    "inside" those inside the record's support, "pairs" the pairs that some
    pixel of their tile still alive reads and "records" the records read
    by at least one such pair."""
    eps = rcfg.transmittance_eps if eps is None else float(eps)
    offsets = binned["offsets"].to(torch.int64)
    device = offsets.device
    num_tiles, tp, tw = rcfg.num_tiles, rcfg.tile_pixels, rcfg.tile_w
    u32 = lambda w: w.to(torch.int64) & U32_MASK  # noqa: E731
    cx, cy, r, op, cr, cg, cb, ang, ratio = unpack_words(
        u32(binned["rec_pos"]), u32(binned["rec_ro"]), u32(binned["rec_rgb"]), rcfg)
    rgb = torch.stack([cr, cg, cb], dim=-1)
    counts = offsets[1:] - offsets[:-1]
    # heaviest first, so the tiles still walking at position k are a prefix
    tiles = torch.sort(counts, descending=True, stable=True).indices
    cnt = counts[tiles]
    cnt_host = cnt.cpu().tolist()
    lane = torch.arange(tp, device=device)
    px = ((tiles % rcfg.tiles_x).to(torch.float32)[:, None] * tw
          + ((lane % tw).to(torch.float32) + 0.5))
    py = ((tiles // rcfg.tiles_x).to(torch.float32)[:, None] * rcfg.tile_h
          + ((lane // tw).to(torch.float32) + 0.5))
    color = torch.zeros((num_tiles, tp, 3), dtype=torch.float32, device=device)
    trans = torch.ones((num_tiles, tp), dtype=torch.float32, device=device)
    alive = trans > eps
    evals = torch.zeros((), dtype=torch.int64, device=device)
    inside = torch.zeros_like(evals)
    pairs = torch.zeros_like(evals)
    read = torch.zeros(cx.shape[0], dtype=torch.int32, device=device)
    max_c = cnt_host[0] if cnt_host else 0
    m = num_tiles
    for k0 in range(0, max_c, CHUNK):
        while m > 0 and cnt_host[m - 1] <= k0:
            m -= 1
        kk = min(CHUNK, max_c - k0)
        rank, valid = run_positions(offsets, k0, kk, tiles[:m], cnt[:m], binned["pair_rank"])
        col = lambda v: v[rank][:, :, None]  # noqa: E731
        a = splat_alpha_planes(col(cx), col(cy), col(r), col(op), col(ang), col(ratio),
                               px[:m][None], py[:m][None], rcfg)
        a = rnd(torch.where(valid[:, :, None], a, 0.0))  # (kk, m, tp)
        rgb_k = rgb[rank]  # (kk, m, 3)
        hist = torch.empty_like(a, dtype=torch.bool)
        t, c, al = trans[:m], color[:m], alive[:m]
        for j in range(kk):
            hist[j] = al
            take = al & (a[j] > 0.0)
            w = torch.where(take, a[j] * t, 0.0)
            c = rnd(c + rgb_k[j][:, None, :] * w[:, :, None])
            t = rnd(torch.where(take, t * (1.0 - a[j]), t))
            al = t > eps
        trans[:m], color[:m], alive[:m] = t, c, al
        live = hist & valid[:, :, None]
        evals += live.sum()
        inside += (live & (a > 0.0)).sum()
        any_live = live.any(2)
        pairs += any_live.sum()
        read.scatter_reduce_(0, rank.reshape(-1), any_live.reshape(-1).to(torch.int32), "amax")
    back = torch.empty_like(tiles)
    back[tiles] = torch.arange(num_tiles, device=device)
    stats = {"evals": int(evals), "inside": int(inside), "pairs": int(pairs),
             "records": int(read.sum())}
    return color[back], 1.0 - trans[back], stats


def render(splats, camera, rcfg: RenderConfig, rnd: Rounding = exact):
    """(words, binned, image, counts) of one frame of `splats`."""
    words, binned = words_and_bins(splats, camera, rcfg)
    color, alpha, counts = fold_blend(binned, rcfg, rnd=rnd)
    return words, binned, rnd(tiles_to_image(color, alpha, rcfg)), counts
