"""The binner's CUDA kernels (`ops/bin_words.py`, csrc/bin_words.cu) against
the plain path `bin_packed_words_plain`.

The `gpu` tests hold the kernels' outputs bit-equal to the plain path on
the same CUDA words (offsets, counts, the live pairs, the record planes),
and the tail past the live pairs to its contract, and skip where torch
sees no CUDA device; the rest run on the CPU: the dispatch, the wrapper's
input checks, the footprint model and scalars a config hands the kernel,
and the plain path's tail.  The file imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_bin_words.py
"""

import numpy as np
import pytest
import torch

import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.camera import camera_tensors
from splat_renderer_tpu_torch.convert import splats_from_numpy
from splat_renderer_tpu_torch.ops import build
from splat_renderer_tpu_torch.ops.build import launches
from splat_renderer_tpu_torch.ops.bin_words import (
    ELLIPSE, ISOTROPIC, SQUARE, _scalars, bin_words, footprint_model,
)
from splat_renderer_tpu_torch.render.binning import (
    _INF_KEY, _compact_nearest, bin_packed_words, bin_packed_words_plain, footprint_rows,
)
from splat_renderer_tpu_torch.render.projector import splat_screen_words
from splat_renderer_tpu_torch.utils import profiling

W, H = 200, 120
PROFILES = {
    "isotropic": lambda **kw: tpt.RenderConfig(width=W, height=H, **kw),
    "oriented": lambda **kw: tpt.RenderConfig(width=W, height=H, oriented=True, **kw),
    "surface": lambda **kw: tpt.surface_render_config(W, H, **kw),
    "quad": lambda **kw: tpt.surface_render_config(W, H, quad=True, **kw),
}
TILES = {"16x16": dict(tile_size=16), "32x16": dict(tile_size=32, tile_height=16)}
KEYS = ("offsets", "counts", "rec_pos", "rec_ro", "rec_rgb")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the binner's kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture
def unloaded(monkeypatch):
    """The binner's library taken out of the loaded libraries for the test,
    and put back after it: a test that renders on the card earlier in the
    session may have loaded it."""
    monkeypatch.delitem(build._libs, "bin_words", raising=False)


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _words(cfg, n, seed, device="cpu", culled=0.05):
    """Record words (int64 dk, w_pos, w_ro, w_rgb) on cfg's grids: centres
    on and around the frame, a tenth on tile edges and a twentieth on the
    frame's edges; radii from 0 (below min_screen_radius) to four tiles
    (footprints the cap shrinks); depth keys from 40 values (ties) with a
    share culled (+inf, and above it)."""
    rng = np.random.default_rng(seed)
    ps, po = cfg.pos_scale, cfg.pos_offset
    cx = rng.uniform(-2 * cfg.tile_w, W + 2 * cfg.tile_w, n)
    cy = rng.uniform(-2 * cfg.tile_h, H + 2 * cfg.tile_h, n)
    kind = rng.uniform(0, 1, n)
    on_tile = kind < 0.1
    cx[on_tile] = cfg.tile_w * rng.integers(0, cfg.tiles_x + 1, on_tile.sum())
    cy[on_tile] = cfg.tile_h * rng.integers(0, cfg.tiles_y + 1, on_tile.sum())
    on_edge = (kind >= 0.1) & (kind < 0.15)
    cx[on_edge] = rng.choice([0.0, W - 1 / ps, W, -1 / ps], on_edge.sum())
    r = np.where(rng.uniform(0, 1, n) < 0.1, rng.uniform(0, 0.6, n),
                 rng.uniform(0.5, 4 * cfg.tile_w, n))
    fx = lambda v: np.clip(np.rint((v + po) * ps), 0, 65535).astype(np.int64)  # noqa: E731
    w_pos = fx(cx) | (fx(cy) << 16)
    w_ro = (np.clip(np.rint(r * ps), 0, 65535).astype(np.int64)
            | (rng.integers(0, 256, n) << 16) | (rng.integers(0, 256, n) << 24))
    w_rgb = rng.integers(0, 2**32, n, dtype=np.int64)
    depth = rng.choice(rng.uniform(0.5, 5.0, 40).astype(np.float32), n)
    dk = depth.view(np.int32).astype(np.int64) | 0x80000000
    dead = rng.uniform(0, 1, n) < culled
    dk[dead] = rng.choice([_INF_KEY, 0xFFC00000], dead.sum())
    return [torch.from_numpy(a).to(device) for a in (dk, w_pos, w_ro, w_rgb)]


def _assert_bit_equal(got, want, n):
    """Every output equal over the live pairs; the tails to their contract."""
    p = int(want["offsets"][-1])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.int32, k
        assert got[k].shape == want[k].shape, k
    for k in KEYS + (("rec_depth",) if "rec_depth" in want else ()):
        differ = int((got[k] != want[k]).sum())
        assert differ == 0, f"{k}: {differ} of {want[k].numel()} differ"
    for k in ("pair_rank", "pair_tile"):
        differ = int((got[k][:p] != want[k][:p]).sum())
        assert differ == 0, f"{k}[:{p}]: {differ} differ"
    _assert_tail(got, n)


def _assert_tail(binned, n):
    p = int(binned["offsets"][-1])
    num_tiles = binned["counts"].shape[0]
    assert bool((binned["pair_tile"][p:] == num_tiles).all())
    tail = binned["pair_rank"][p:]
    assert bool(((tail >= 0) & (tail < max(n, 1))).all())


def _assert_canonical_runs(binned, dk):
    """Each tile's run in ascending (depth key, input index) order."""
    p = int(binned["offsets"][-1])
    rank = binned["pair_rank"][:p].long()
    tile, key = binned["pair_tile"][:p], dk[rank]
    up = lambda a: a[1:] > a[:-1]  # noqa: E731
    same = lambda a: a[1:] == a[:-1]  # noqa: E731
    ordered = up(tile) | (same(tile) & (up(key) | (same(key) & up(rank))))
    assert bool(ordered.all())


# ---- CPU ----

@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_cpu_takes_the_plain_path(profile, unloaded):
    """On the CPU `bin_packed_words` is the plain path bit for bit: nothing
    launched, nothing loaded, `pairs` counted."""
    cfg = PROFILES[profile](tiles_per_splat_cap=8)
    words = _words(cfg, 3000, seed=1)
    before = launches["bin_words"]
    with profiling.recording() as rec:
        got = bin_packed_words(*words, cfg, with_depth=True)
    want = bin_packed_words_plain(*words, cfg, with_depth=True)
    assert launches["bin_words"] == before
    assert "bin_words" not in build._libs
    assert rec.counter("pairs", within="bin") == int(want["offsets"][-1]) > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_plain_tail_holds_the_sentinel(profile):
    """The plain path's tail: the sentinel tile, and records' indices in
    [0, N); the runs in canonical order; offsets and counts agree."""
    cfg = PROFILES[profile](tiles_per_splat_cap=4)
    words = _words(cfg, 2000, seed=2)
    out = bin_packed_words_plain(*words, cfg)
    _assert_tail(out, 2000)
    _assert_canonical_runs(out, words[0])
    assert torch.equal(out["offsets"][1:] - out["offsets"][:-1], out["counts"])


def _meta(n, dtype=torch.int64):
    return [torch.empty(n, dtype=dtype, device="meta") for _ in range(4)]


REJECTS = {
    "cpu": (lambda cfg: _words(cfg, 64, seed=3), "no binner kernel for device cpu"),
    "int32": (lambda cfg: [w.to(torch.int32) for w in _words(cfg, 64, seed=3)], "int64"),
    "slots": (lambda cfg: _meta(2**31 // cfg.tiles_per_splat_cap), r"2\*\*31"),
    "strided": (lambda cfg: [w[::2] for w in _words(cfg, 64, seed=3)], "not contiguous"),
    "length": (lambda cfg: _words(cfg, 64, seed=3)[:3] + [torch.zeros(63, dtype=torch.int64)],
               "1-d of the length"),
    "devices": (lambda cfg: _meta(64)[:3] + [torch.zeros(64, dtype=torch.int64)],
                r"w_rgb must be .* on meta, got .* on cpu"),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_wrapper_rejects_before_loading(case, unloaded):
    """CPU tensors, int32 words, N * cap >= 2**31 slots, strided words,
    words of two lengths or on two devices: each raises ValueError before
    the library is built or loaded."""
    cfg = PROFILES["isotropic"](tiles_per_splat_cap=8)
    make, match = REJECTS[case]
    before = launches["bin_words"]
    with pytest.raises(ValueError, match=match):
        bin_words(*make(cfg), cfg)
    assert launches["bin_words"] == before
    assert "bin_words" not in build._libs


def test_wrapper_rejects_an_unpackable_window(unloaded):
    """A cap of 4096 or more, or 2**15 tiles a side, is out of the kernel's
    packed window: refused before anything loads."""
    words = _meta(64)
    for cfg in (tpt.RenderConfig(width=W, height=H, tiles_per_splat_cap=4096),
                tpt.RenderConfig(width=2**15 + 1, height=H, tile_size=1)):
        with pytest.raises(ValueError, match="window packing"):
            bin_words(*words, cfg)
    assert "bin_words" not in build._libs


def test_footprint_model_and_prune_per_config():
    """The footprint `_footprint_cols` takes (isotropic unless oriented; the
    square only for oriented opaque quads) and the prune `_diag_prune`
    applies (all but opaque quads, oriented or not)."""
    rc = tpt.RenderConfig
    cases = {
        (False, False, False): (ISOTROPIC, 1), (True, False, False): (ELLIPSE, 1),
        (True, True, False): (ELLIPSE, 1), (True, False, True): (ELLIPSE, 1),
        (True, True, True): (SQUARE, 0), (False, True, True): (ISOTROPIC, 0),
    }
    for (oriented, opaque, quad), (model, prune) in cases.items():
        cfg = rc(oriented=oriented, opaque=opaque, quad=quad)
        assert footprint_model(cfg) == model
        assert _scalars(cfg)[1][3:] == [model, prune]


@pytest.mark.parametrize("tiles", sorted(TILES))
def test_scalars_are_the_plain_paths_float32(tiles):
    """The kernel's float scalars are cfg's Python numbers rounded to
    float32, as PyTorch rounds them against a float32 tensor."""
    cfg = tpt.RenderConfig(width=1920, height=1080, bounds_margin=1.3, **TILES[tiles])
    floats, ints = _scalars(cfg)
    want = (1.0 / cfg.pos_scale, cfg.pos_offset, 2.0 * np.pi / 255.0, np.pi, 1.0 / 255.0,
            cfg.bounds_margin, cfg.min_screen_radius, cfg.tile_w, cfg.tile_h, 1920, 1080)
    assert list(floats) == [float(np.float32(v)) for v in want]
    assert list(ints)[:3] == [cfg.tiles_x, cfg.tiles_y, cfg.tiles_per_splat_cap]


# ---- on the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1, 4, 8])
@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_kernel_bit_equal_to_plain(cuda, profile, tiles, cap):
    """Offsets, counts, the live pairs and the record planes equal the plain
    path on the same CUDA words bit for bit (with the depth plane at cap 4
    and 8), on words that sit on the frame's and the tiles' edges, tie on
    their depth keys and reach past the cap; the tail holds the sentinel
    tile and ranks in [0, N); each run is in canonical order."""
    cfg = PROFILES[profile](tiles_per_splat_cap=cap, **TILES[tiles])
    n = 20_000
    words = _words(cfg, n, seed=10 + cap, device=cuda)
    with_depth = cap > 1
    before = launches["bin_words"]
    got = bin_packed_words(*words, cfg, with_depth=with_depth)
    assert launches["bin_words"] == before + 1
    want = bin_packed_words_plain(*words, cfg, with_depth=with_depth)
    torch.cuda.synchronize()
    assert int(want["offsets"][-1]) > n // 2
    _assert_bit_equal(got, want, n)
    _assert_canonical_runs(got, words[0])


@pytest.mark.gpu
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_compact_to_bit_equal(cuda, profile):
    """compact_to below N: the kernel bins the kept records as the plain
    path bins them."""
    cfg = PROFILES[profile](tiles_per_splat_cap=8)
    words = _words(cfg, 10_000, seed=20, device=cuda)
    got = bin_packed_words(*words, cfg, compact_to=3000, with_depth=True)
    want = bin_packed_words_plain(*_compact_nearest(3000, *words), cfg, with_depth=True)
    torch.cuda.synchronize()
    assert got["rec_pos"].shape == (3000,)
    _assert_bit_equal(got, want, 3000)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["culled", "off_screen", "empty"])
def test_no_live_pairs(cuda, case):
    """P = 0 (every record culled, every record off screen, no records):
    zero offsets and counts, the whole of pair_tile the sentinel."""
    cfg = PROFILES["oriented"](tiles_per_splat_cap=4)
    n = {"culled": 5000, "off_screen": 5000, "empty": 0}[case]
    words = _words(cfg, n, seed=30, device=cuda)
    if case == "culled":
        words[0] = torch.full_like(words[0], _INF_KEY)
    elif case == "off_screen":
        words[1] = torch.full_like(words[1], 0)  # centre at (-pos_offset, -pos_offset)
        words[2] = words[2] & ~0xFFFF | int(16 * cfg.pos_scale)  # radius 16 px
    got = bin_packed_words(*words, cfg, with_depth=True)
    want = bin_packed_words_plain(*words, cfg, with_depth=True)
    torch.cuda.synchronize()
    assert int(got["offsets"].abs().sum()) == 0 and int(got["counts"].abs().sum()) == 0
    assert got["pair_tile"].shape == (n * 4,)
    _assert_bit_equal(got, want, n)


@pytest.mark.gpu
def test_launches_and_counters(cuda):
    """One wrapper call a binning, counted under "bin_words" whether or not
    tracing is on; while tracing, `pairs` counts each call's offsets[-1],
    under `bin`."""
    cfg = PROFILES["surface"](tiles_per_splat_cap=8)
    words = _words(cfg, 4000, seed=40, device=cuda)
    before = launches["bin_words"]
    with profiling.recording() as rec:
        made = [int(bin_packed_words(*words, cfg)["offsets"][-1]) for _ in range(3)]
    assert launches["bin_words"] == before + 3
    assert rec.report()["bin"]["calls"] == 3
    assert rec.counter("pairs", within="bin") == sum(made)
    bin_packed_words(*words, cfg)  # tracing off: launched, not recorded
    assert launches["bin_words"] == before + 4
    assert rec.counter("pairs", within="bin") == sum(made)


@pytest.mark.gpu
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_kernel_footprints_are_footprint_rows(cuda, profile):
    """The rows of each record's pairs (first row, row count) are the
    footprint `footprint_rows` gives the tile bands; records without pairs
    have h = 0 there.  The diagonal prune drops a corner, never a row."""
    cfg = PROFILES[profile](tiles_per_splat_cap=8)
    n = 20_000
    words = _words(cfg, n, seed=50, device=cuda)
    got = bin_packed_words(*words, cfg)
    ty0, h = footprint_rows(words[0], words[1], words[2], cfg)
    p = int(got["offsets"][-1])
    rank = got["pair_rank"][:p].long()
    row = got["pair_tile"][:p].long() // cfg.tiles_x
    lo = torch.full((n,), 2**31, dtype=torch.int64, device=cuda).scatter_reduce(0, rank, row, "amin")
    hi = torch.full((n,), -1, dtype=torch.int64, device=cuda).scatter_reduce(0, rank, row, "amax")
    live = hi >= 0
    assert torch.equal(live, h > 0)
    assert torch.equal(lo[live], ty0[live])
    assert torch.equal((hi - lo + 1)[live], h[live])


@pytest.mark.gpu
def test_projector_words_at_1080p(cuda):
    """1M projected splats at 1080p, 32x16 tiles, cap 4 (the demo frame's
    shape): the kernel's binning bit-equal to the plain path's."""
    cfg = tpt.RenderConfig(width=1920, height=1080, base_radius=0.008,
                           tiles_per_splat_cap=4, tile_size=32, tile_height=16)
    rng = np.random.default_rng(60)
    n = 1_000_000
    pos = rng.uniform(-1, 1, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {"px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
              "radius": rng.uniform(0.002, 0.02, n), "cr": rng.uniform(0, 1, n),
              "cg": rng.uniform(0, 1, n), "cb": rng.uniform(0, 1, n),
              "opacity": rng.uniform(0.2, 1.0, n),
              "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2]}
    cam = camera_tensors(tpt.Camera(aspect=1920 / 1080).arrays(), cuda)
    w = splat_screen_words(splats_from_numpy(planes, cuda), cam["view_proj"], cam["cam_pos"],
                           cfg)
    words = [w[k] for k in ("dk", "w_pos", "w_ro", "w_rgb")]
    got = bin_packed_words(*words, cfg)
    want = bin_packed_words_plain(*words, cfg)
    torch.cuda.synchronize()
    assert int(want["offsets"][-1]) > n
    _assert_bit_equal(got, want, n)
