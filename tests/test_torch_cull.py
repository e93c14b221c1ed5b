"""The kernels' warp-level culling test, in its plain PyTorch mirror, against
the twin's alphas: a (record, warp rectangle) pair is never culled when the
twin's arithmetic gives any pixel of that warp an alpha above 0.

The CUDA kernels (csrc/tile_blend.cu, csrc/tile_blend_diff.cu) skip, per
warp, the records whose support cannot reach the warp's rectangle of pixel
centres.  `ops/tile_blend.py::cull_live_plain` is that test with the same
float32 operations in the same order, `warp_pixels` the kernels' pixel to
lane mapping, `staged_cut2` the cutoff as the kernels stage it.  Seeded
numpy inputs for every profile and tile shape, and a `hypothesis` search
that puts the centre on, and a few ulps around, the distance at which the
warp's nearest pixel leaves the support.  The differentiable blend's
kernels run the same test on `bin_planes_diff` streams, against the diff
twin's alphas.

The forward kernel's residual (each pixel's T at the start of every
backward chunk) in its plain mirror `diff_residuals_plain`: its row layout,
and the kernel's exact-zero stop, which changes no bit of any output.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.ops.tile_blend import (
    cull_live_plain, nonempty_tiles, staged_cut2, warp_pixels, warp_rects,
)
from splat_renderer_tpu_torch.ops.tile_blend_diff import (
    _PLANE_NAMES, _pair_alpha, blend_binned_plain, bwd_chunk, diff_cut2, diff_fold_plain,
    diff_residuals_plain, residual_row0,
)
from splat_renderer_tpu_torch.render.binning import bin_planes_diff
from splat_renderer_tpu_torch.render.blend import splat_alpha_planes

PROFILES = {
    "isotropic": {},
    "oriented": dict(oriented=True),
    "ewa": dict(oriented=True, ellipse="ewa"),
    "opaque": dict(opaque=True, oriented=True),
    "quad": dict(opaque=True, oriented=True, quad=True),
    "opaque_iso": dict(opaque=True),
    "quad_iso": dict(opaque=True, quad=True),
}
TILES = {"16x16": dict(tile_size=16), "32x16": dict(tile_size=32, tile_height=16),
         "12x12": dict(tile_size=12)}


def _config(profile, tiles):
    return tpt.RenderConfig(width=256, height=128, **PROFILES[profile], **TILES[tiles])


def _missed(cfg, cx, cy, r, op, ang, ratio, ox, oy):
    """(culled although some pixel has alpha > 0, live, all) over (record,
    warp) pairs of the tile whose origin is (ox, oy)."""
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
    cx, cy, r, op, ang, ratio = map(f32, (cx, cy, r, op, ang, ratio))
    tp, tw = cfg.tile_pixels, cfg.tile_w
    pix = torch.arange(tp)
    px = (ox + pix % tw).to(torch.float32) + 0.5
    py = (oy + pix // tw).to(torch.float32) + 0.5
    col = lambda v: v[:, None]  # noqa: E731
    alpha = splat_alpha_planes(col(cx), col(cy), col(r), col(op), col(ang), col(ratio),
                               px[None, :], py[None, :], cfg)  # (n, tp)
    lanes = warp_pixels(cfg)  # (warps, 32)
    touched = (alpha[:, lanes] > 0).any(-1)  # (n, warps)
    rect = warp_rects(cfg)
    cut2, rr = staged_cut2(r, op, ratio, cfg)
    live = cull_live_plain(col(cx), col(cy), col(cut2), col(rr),
                           ox + rect[None, :, 0], ox + rect[None, :, 1],
                           oy + rect[None, :, 2], oy + rect[None, :, 3],
                           cfg.oriented, cfg.opaque and cfg.quad)
    return int((touched & ~live).sum()), int(live.sum()), live.numel(), int(touched.sum())


def _missed_diff(cfg, cx, cy, r, op, ang, ratio, ox, oy):
    """`_missed` on the tile at (ox, oy) of a `bin_planes_diff` stream, with
    the diff twin's alphas and the diff kernels' staged cutoff."""
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
    n = len(cx)
    cols = dict(zip(_PLANE_NAMES, map(f32, (cx, cy, r, op, np.full(n, 0.5), np.full(n, 0.5),
                                            np.full(n, 0.5), ang, ratio,
                                            np.linspace(1.0, 9.0, n)))))
    binned = bin_planes_diff(cols, cfg)
    t = (oy // cfg.tile_h) * cfg.tiles_x + ox // cfg.tile_w
    lo, hi = int(binned["offsets"][t]), int(binned["offsets"][t + 1])
    rec = binned["planes"].index_select(0, binned["pair_rank"][lo:hi].long())
    pix = torch.arange(cfg.tile_pixels)
    px = (ox + pix % cfg.tile_w).to(torch.float32) + 0.5
    py = (oy + pix // cfg.tile_w).to(torch.float32) + 0.5
    _, alpha = _pair_alpha(cfg, rec, px[None], py[None])  # (pairs, tp)
    touched = (alpha[:, warp_pixels(cfg)] > 0).any(-1)  # (pairs, warps)
    rect = warp_rects(cfg)
    cut2, rr = diff_cut2(rec, cfg)
    col = lambda v: v[:, None]  # noqa: E731
    live = cull_live_plain(col(rec[:, 0]), col(rec[:, 1]), col(cut2), col(rr),
                           ox + rect[None, :, 0], ox + rect[None, :, 1],
                           oy + rect[None, :, 2], oy + rect[None, :, 3], cfg.oriented, False)
    return int((touched & ~live).sum()), int(live.sum()), live.numel(), int(touched.sum())


# the packed-word streams of every profile and tile shape; the
# differentiable blend's streams of its two profiles
CULL_CASES = [pytest.param("words", p, t, id=f"{p}-{t}") for p in sorted(PROFILES)
              for t in sorted(TILES)] + [
    pytest.param("diff", p, t, id=f"diff-{p}-{t}") for p in ("isotropic", "oriented")
    for t in ("16x16", "32x16")]


@pytest.mark.parametrize("stream,profile,tiles", CULL_CASES)
def test_cull_never_drops_a_contributing_record(stream, profile, tiles):
    cfg = _config(profile, tiles)
    rng = np.random.default_rng(sorted(PROFILES).index(profile) * 7 + sorted(TILES).index(tiles))
    n = 6000
    ox, oy = 3 * cfg.tile_w, 2 * cfg.tile_h
    cx = rng.uniform(ox - 25, ox + cfg.tile_w + 25, n)
    cy = rng.uniform(oy - 25, oy + cfg.tile_h + 25, n)
    r = rng.uniform(0.2, 9.0, n)
    r[:50] = rng.uniform(0.0, cfg.min_screen_radius, 50)  # below the cull radius
    op = rng.uniform(0.0, 1.0, n)
    op[50:100] = 0.0
    ang = rng.uniform(-np.pi, np.pi, n)
    ratio = rng.uniform(0.0, 1.0, n)
    ratio[100:150] = 0.0  # clamped to 1e-3: the thinnest ellipse
    missed_of = _missed if stream == "words" else _missed_diff
    missed, live, total, touched = missed_of(cfg, cx, cy, r, op, ang, ratio, ox, oy)
    assert missed == 0
    assert touched > 0
    # the test is not vacuous: it does cull, and what it keeps is not far
    # above what contributes (the oriented bound is the major axis' circle)
    assert live < 0.8 * total
    assert live >= touched


@settings(deadline=None, max_examples=60, derandomize=True)
@given(
    profile=st.sampled_from(sorted(PROFILES)),
    tiles=st.sampled_from(sorted(TILES)),
    r=st.floats(0.5, 12.0, width=32),
    side=st.sampled_from(["left", "right", "above", "below", "corner"]),
    along=st.floats(0.0, 1.0),
    ulps=st.integers(-3, 3),
    ratio=st.floats(0.0, 1.0, width=32),
    ang=st.floats(-3.125, 3.125, width=32),
    warp=st.integers(0, 15),
)
def test_cull_at_the_cutoff(profile, tiles, r, side, along, ulps, ratio, ang, warp):
    """The centre sits where the warp's nearest pixel centre is at the
    support's edge (as the isotropic cutoff puts it), moved by a few ulps."""
    cfg = _config(profile, tiles)
    rect = warp_rects(cfg)
    x0, x1, y0, y1 = (float(v) for v in rect[warp % rect.shape[0]])
    ox, oy = 5 * cfg.tile_w, 1 * cfg.tile_h
    reach = np.float32(r) * np.float32(1.0 if cfg.opaque else cfg.bounds_margin)
    if side == "left":
        cx, cy = ox + x0 - reach, oy + y0 + along * (y1 - y0)
    elif side == "right":
        cx, cy = ox + x1 + reach, oy + y0 + along * (y1 - y0)
    elif side == "above":
        cx, cy = ox + x0 + along * (x1 - x0), oy + y0 - reach
    elif side == "below":
        cx, cy = ox + x0 + along * (x1 - x0), oy + y1 + reach
    else:
        th = along * np.pi / 2
        cx, cy = ox + x1 + reach * np.cos(th), oy + y1 + reach * np.sin(th)
    cx, cy = np.float32(cx), np.float32(cy)
    for _ in range(abs(ulps)):
        cx = np.nextafter(cx, np.float32(np.inf if ulps > 0 else -np.inf))
        cy = np.nextafter(cy, np.float32(np.inf if ulps > 0 else -np.inf))
    one = lambda v: np.array([v], np.float32)  # noqa: E731
    missed, _, _, _ = _missed(cfg, one(cx), one(cy), one(r), one(1.0), one(ang), one(ratio),
                              ox, oy)
    assert missed == 0


def test_isotropic_cull_is_tight_at_the_edge():
    """Exactness both ways on an axis: a record whose support just reaches
    the warp's nearest pixel centre is live, one ulp short it is culled."""
    cfg = _config("isotropic", "16x16")
    x0, x1, y0, y1 = (float(v) for v in warp_rects(cfg)[0])
    r = np.float32(2.0)
    cut2, rr = staged_cut2(torch.tensor([r]), torch.ones(1), torch.ones(1), cfg)
    reach = np.sqrt(np.float32(cut2[0]))  # exactly representable: margin * r
    assert np.float32(reach * reach) == np.float32(cut2[0])
    t = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    cy = t(y0)
    args = (cut2, rr, t(x0), t(x1), t(y0), t(y1), False)
    assert bool(cull_live_plain(t(x1 + reach), cy, *args))
    assert not bool(cull_live_plain(t(np.nextafter(np.float32(x1 + reach), np.float32(np.inf))),
                                    cy, *args))


@pytest.mark.parametrize("tiles,warps,block", [("16x16", 8, (8, 4)), ("32x16", 16, (8, 4)),
                                                ("12x12", 5, None)])
def test_warp_pixels_cover_the_tile(tiles, warps, block):
    cfg = _config("isotropic", tiles)
    pix = warp_pixels(cfg)
    assert pix.shape == (warps, 32)
    assert sorted(set(pix.reshape(-1).tolist())) == list(range(cfg.tile_pixels))
    if block is not None:  # compact 8x4 blocks
        x, y = pix % cfg.tile_w, pix // cfg.tile_w
        assert bool(((x.amax(1) - x.amin(1)) == block[0] - 1).all())
        assert bool(((y.amax(1) - y.amin(1)) == block[1] - 1).all())
        assert pix.unique().numel() == cfg.tile_pixels


def test_tile_list_is_by_count_and_complete():
    """The persistent kernel's queue: every nonempty tile once, heaviest
    first, ties in tile order; the empty tiles after them."""
    counts = torch.tensor([0, 5, 0, 9, 5, 1, 0, 9], dtype=torch.int32)
    tile_list, n_list = nonempty_tiles(counts)
    assert tile_list.dtype == torch.int32 and n_list.dtype == torch.int32
    assert int(n_list) == 5
    assert tile_list.tolist()[:5] == [3, 7, 1, 4, 5]
    assert sorted(tile_list.tolist()) == list(range(8))


@pytest.mark.parametrize("tiles,want", [("16x16", 32), ("32x16", 16), ("12x12", 32)])
def test_backward_chunk_fits_the_shared_memory_budget(tiles, want):
    cfg = _config("isotropic", tiles)
    assert bwd_chunk(cfg) == want
    assert bwd_chunk(tpt.RenderConfig(width=64, height=64, tile_size=32)) == 8


@pytest.mark.parametrize("tiles", ["16x16", "32x16"])
@pytest.mark.parametrize("profile", ["isotropic", "oriented", "quad", "quad_iso"])
def test_cull_against_the_pixels_still_alive(profile, tiles):
    """The kernels shrink a warp's rectangle to the pixels that have not
    stopped: the test must hold for the bounding rectangle of any subset of
    a warp's pixels, against that subset's alphas."""
    cfg = _config(profile, tiles)
    rng = np.random.default_rng(11)
    n = 3000
    ox, oy = 2 * cfg.tile_w, 3 * cfg.tile_h
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
    cx = f32(rng.uniform(ox - 20, ox + cfg.tile_w + 20, n))
    cy = f32(rng.uniform(oy - 20, oy + cfg.tile_h + 20, n))
    r, op = f32(rng.uniform(0.3, 7.0, n)), f32(rng.uniform(0.1, 1.0, n))
    ang, ratio = f32(rng.uniform(-np.pi, np.pi, n)), f32(rng.uniform(0.0, 1.0, n))
    lanes = warp_pixels(cfg)  # (warps, 32)
    keep = torch.as_tensor(rng.uniform(size=lanes.shape) < 0.3)
    keep[:, 0] = True  # at least one pixel alive per warp
    px = (ox + lanes % cfg.tile_w).to(torch.float32) + 0.5
    py = (oy + lanes // cfg.tile_w).to(torch.float32) + 0.5
    big = torch.tensor(3.0e38)
    x0, x1 = torch.where(keep, px, big).amin(1), torch.where(keep, px, -big).amax(1)
    y0, y1 = torch.where(keep, py, big).amin(1), torch.where(keep, py, -big).amax(1)
    col = lambda v: v[:, None, None]  # noqa: E731
    alpha = splat_alpha_planes(col(cx), col(cy), col(r), col(op), col(ang), col(ratio),
                               px[None], py[None], cfg)  # (n, warps, 32)
    touched = ((alpha > 0) & keep[None]).any(-1)
    cut2, rr = staged_cut2(r, op, ratio, cfg)
    live = cull_live_plain(cx[:, None], cy[:, None], cut2[:, None], rr[:, None],
                           x0[None], x1[None], y0[None], y1[None],
                           cfg.oriented, cfg.opaque and cfg.quad)
    assert int((touched & ~live).sum()) == 0
    assert int(touched.sum()) > 0 and int(live.sum()) < 0.7 * live.numel()


# ---- the forward kernel's residual and its exact-zero stop ----

def _diff_stream(profile, n=600, width=96, height=64, seed=3):
    cfg = tpt.RenderConfig(width=width, height=height, tiles_per_splat_cap=8, **PROFILES[profile])
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(-4, width + 4, n), rng.uniform(-4, height + 4, n),
            rng.uniform(0.3, 5.0, n), rng.uniform(0.2, 1.0, n),
            rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n),
            rng.uniform(-np.pi, np.pi, n), rng.uniform(0.1, 1.0, n), rng.uniform(1, 9, n)]
    planes = {k: torch.tensor(c, dtype=torch.float32) for k, c in zip(_PLANE_NAMES, cols)}
    return cfg, bin_planes_diff(planes, cfg)


@pytest.mark.parametrize("profile", ["isotropic", "oriented"])
def test_residual_layout_is_one_product_for_every_chunk(profile):
    """Each nonempty tile's first row is 1, and the row of a record index
    holds the same bits whatever the chunk."""
    cfg, binned = _diff_stream(profile, n=1500)
    counts = binned["counts"].tolist()
    assert max(counts) > 64
    res = {c: (diff_residuals_plain(binned, cfg, c), residual_row0(binned, c)) for c in (8, 16, 32)}
    for t, cnt in enumerate(counts):
        if cnt == 0:
            continue
        for c, (rows, row0) in res.items():
            assert bool((rows[int(row0[t])] == 1.0).all())
        for i in range(0, cnt, 32):
            want = res[32][0][int(res[32][1][t]) + i // 32]
            for c in (8, 16):
                rows, row0 = res[c]
                assert torch.equal(rows[int(row0[t]) + i // c], want), (t, i, c)


def test_residual_last_product_is_one_minus_alpha():
    """With one-record chunks the last row of a tile times 1 - a of its last
    record is its T: 1 - alpha of the twin within 1e-6, and the fold's."""
    cfg, binned = _diff_stream("isotropic", n=300)
    rows = diff_residuals_plain(binned, cfg, 1)
    row0 = residual_row0(binned, 1)
    color, alpha, depth = blend_binned_plain(binned, cfg)
    fold = diff_fold_plain(binned, cfg)
    lane = torch.arange(cfg.tile_pixels)
    for t, cnt in enumerate(binned["counts"].tolist()):
        if cnt == 0:
            continue
        last = binned["planes"][binned["pair_rank"][int(binned["offsets"][t + 1]) - 1].long()]
        px = float((t % cfg.tiles_x) * cfg.tile_w) + (lane % cfg.tile_w).float() + 0.5
        py = float((t // cfg.tiles_x) * cfg.tile_h) + (lane // cfg.tile_w).float() + 0.5
        _, a = _pair_alpha(cfg, last[None], px[None], py[None])
        trans = rows[int(row0[t]) + cnt - 1] * (1.0 - a[0])
        assert float((trans - (1.0 - alpha[t])).abs().max()) <= 1e-6
        assert torch.equal(1.0 - trans, fold[1][t])
    for got, want in zip(fold, (color, alpha, depth)):
        assert float((got - want).abs().max()) <= 1e-6


def _deep_planes(n=400):
    """n opacity-1 records over one 16x16 tile, wide enough to reach all of
    it: every pixel's T underflows to exactly 0."""
    rng = np.random.default_rng(5)
    cols = [rng.uniform(0, 16, n), rng.uniform(0, 16, n), rng.uniform(8.0, 16.0, n),
            np.ones(n), rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n),
            rng.uniform(-np.pi, np.pi, n), rng.uniform(0.5, 1.0, n), rng.uniform(1, 9, n)]
    return {k: torch.tensor(c, dtype=torch.float32) for k, c in zip(_PLANE_NAMES, cols)}


def _deep_tile(profile, n=400):
    cfg = tpt.RenderConfig(width=16, height=16, **PROFILES[profile])
    return cfg, bin_planes_diff(_deep_planes(n), cfg)


@pytest.mark.parametrize("profile", ["isotropic", "oriented"])
def test_exact_zero_stop_changes_no_bit(profile):
    """The kernel stops a pixel at T == 0: a sequential fold that stops
    there gives colour, alpha, depth and residual rows bit-equal to one that
    does not."""
    cfg, binned = _deep_tile(profile)
    assert binned["counts"].tolist() == [400]
    go = diff_fold_plain(binned, cfg, 32)
    stop = diff_fold_plain(binned, cfg, 32, stop_at_zero=True)
    # T reached exactly 0 at every pixel before the last chunk started
    assert bool((go[3][int(residual_row0(binned, 32)[0]) + 400 // 32] == 0.0).all())
    assert bool((go[1] == 1.0).all())
    for a, b in zip(go, stop):
        assert torch.equal(a, b)



@pytest.mark.parametrize("field", ["r", "opacity"])
def test_exact_zero_stop_on_non_finite_planes(field):
    """A NaN colour or opacity in the last record of a tile whose pixels all
    reached T == 0 before it.  The kernel's fold (it stops at T == 0) takes
    nothing from that record and stays finite, bit-equal to the stream
    without the NaN.  The twin and the JAX package's Pallas forward
    (interpret mode) fold it in with weight 0 * NaN and agree on where
    their outputs are NaN: `bin_planes_diff`'s clamp passes NaN through, as
    JAX's clip does.  A divergence on non-finite input only, documented
    here: finite planes are the kernels' domain (csrc/tile_blend_diff.cu)."""
    import jax.numpy as jnp

    import splat_renderer_tpu as spt
    from splat_renderer_tpu.ops.tile_blend_diff import blend_planes_pallas

    cfg = tpt.RenderConfig(width=16, height=16)
    planes = _deep_planes()
    last = int(torch.argmax(planes["depth"]))
    planes[field] = planes[field].clone()
    planes[field][last] = float("nan")
    binned = bin_planes_diff(planes, cfg)
    assert int(binned["pair_rank"][399]) == 399  # the deepest record is last
    assert bool(torch.isnan(binned["planes"][399]).any())

    _, clean = _deep_tile("isotropic")
    stop = diff_fold_plain(binned, cfg, 32, stop_at_zero=True)
    for got, want in zip(stop, diff_fold_plain(clean, cfg, 32, stop_at_zero=True)):
        assert torch.equal(got, want)
    twin = blend_binned_plain(binned, cfg)
    jax_out = blend_planes_pallas(spt.RenderConfig(width=16, height=16), 1024, True,
                                  *(jnp.asarray(planes[k].numpy()) for k in _PLANE_NAMES))
    assert bool(torch.isnan(twin[0]).any())
    for t, j in zip(twin, jax_out):
        assert np.array_equal(torch.isnan(t).numpy(), np.isnan(np.asarray(j)))
