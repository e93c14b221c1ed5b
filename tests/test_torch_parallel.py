"""The PyTorch port's multi-device paths (`splat_renderer_tpu_torch.
parallel`, `fit_splats_dp`) on real gloo ranks on the CPU, against the JAX
package's `parallel` on the 8-device CPU mesh and against the port's own
single-device paths.

The ranks run in spawned processes (tests/torch_parallel_ranks.py, which
imports no JAX), once for each world size (1, 2 and 4), with every check of
that size in the one spawn; the JAX side's inputs and outputs cross as
numpy arrays.  jax.random cannot be reproduced in torch, so the band frame
takes the splats of JAX's `fold_in(key, rank)` shards.

Gates, with their reasons:
- `depth_band` and `over_merge`: bit-equal (integer bands from the same
  float32 roundings; elementwise float32);
- `compact_to`: the per-tile record-word runs equal to JAX's pair stream;
- the depth-band frame: within 3e-5 of JAX's single-device frame at
  eps 0 (tests/test_sharding.py's gate), within 0.0101 of the eps-0 frame
  at the default eps (each band's blend stops at its own floor), its stats
  equal to JAX's `depth_band` over the same eager words;
- the tile bands: each rank's band bit-equal to the frame's stream cut at
  the band and blended by the same tile blend (the kernel blends a tile
  from its run alone, so on the card that is the single-device frame,
  tests/test_torch_gpu.py; the CPU twin chunks its pair stream from the
  stream's start, so a cut stream rounds its chunks differently), also on
  a portrait frame whose bands have a finer screen grid than the frame,
  where every record decodes to its frame position bit for bit; the
  gathered views within 3e-5 of the single-device frames at eps 0 and
  within 0.0101 of them at the default eps;
- view-DP records: within 2e-5 of JAX's `render_views_data_parallel`;
- `fit_splats_dp`: the loss curve within 1e-4 relative of JAX's (each
  package sums per-view losses and gradients in its own order; see
  tests/test_torch_fit.py), theta identical on every rank;
- world size 1: every path bit-equal to its single-device path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import splat_renderer_tpu as spt
from splat_renderer_tpu import fit as jfit
from splat_renderer_tpu.parallel import band as jband
from splat_renderer_tpu.parallel import make_mesh as j_make_mesh
from splat_renderer_tpu.parallel import render_views_data_parallel as j_views_dp
from splat_renderer_tpu.render import bin_splats as j_bin_splats
from splat_renderer_tpu.render import render_tiles as j_render_tiles
from splat_renderer_tpu.render.binning import bin_packed_words as j_bin_packed_words
from splat_renderer_tpu.render.binning import canonical_sort_data as j_canonical_sort
from splat_renderer_tpu.render.blend import over_merge as j_over_merge
from splat_renderer_tpu.render.pipeline import model_points as j_model_points
from splat_renderer_tpu.render.pipeline import splat_screen_data as j_screen_data
from splat_renderer_tpu.render.projector import splat_screen_words as j_words
import torch

import splat_renderer_tpu_torch as tpt
import splat_renderer_tpu_torch.parallel as tpar
from splat_renderer_tpu_torch.render.binning import bin_packed_words
from splat_renderer_tpu_torch.render.blend import over_merge

from torch_parallel_ranks import run_ranks

WORLDS = (2, 4)
BAND = dict(width=64, height=64, base_radius=0.08, tiles_per_splat_cap=4)
N_BAND = 1024
INF_KEY = 0xFF800000
# depth keys of depths 0.5 to 8 (packing.depth_bits), and one in the middle
KEY_LO, KEY_HI = 0x80000000 | 0x3F000000, 0x80000000 | 0x41000000
TIE_KEY = (KEY_LO + KEY_HI) // 2


def _j_scene():
    return spt.SDFScene(spt.smooth_union(
        0.15, spt.Sphere(id="s1", radius=0.5),
        spt.Box(id="b1", position=(0.6, 0, 0), size=(0.3, 0.3, 0.3))))


def _j_depth_band(dk: np.ndarray, world: int, sp: int) -> np.ndarray:
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]), ("sp",))
    fn = jax.jit(jax.shard_map(lambda d: jband.depth_band(d, "sp", sp), mesh=mesh,
                               in_specs=P("sp"), out_specs=P("sp"), check_vma=False))
    return np.asarray(fn(jnp.asarray(dk, jnp.uint32)))


def _depth_keys() -> np.ndarray:
    """4000 depth keys: spread values, one value repeated 600 times where
    the cuts land, the range's ends, and culled (+inf) keys."""
    g = np.random.default_rng(11)
    dk = g.integers(KEY_LO, KEY_HI, 4000, dtype=np.int64)
    dk[:600] = TIE_KEY
    dk[600:602] = (KEY_LO, KEY_HI)
    dk[602:800] = INF_KEY
    return g.permutation(dk).astype(np.uint32)


def _band_scene(world: int):
    """tests/test_sharding.py's band scene, modeled by JAX in `world`
    fold_in shards; its single-device frame (render_tiles over the
    canonical records), its eager words and JAX's bands of them."""
    scene = _j_scene()
    rcfg = spt.RenderConfig(**BAND)
    pcfg = spt.PointConfig(descent_steps=3)
    key = jax.random.PRNGKey(0)
    model = jax.jit(lambda p, k: j_model_points(scene, p, k, N_BAND // world, pcfg, rcfg))
    shards = [model(scene.params(), jax.random.fold_in(key, d)) for d in range(world)]
    splats = jax.tree.map(lambda *xs: jnp.concatenate(xs), *shards)
    arrays = spt.orbit_ring(1, aspect=1.0)
    camera = {k: jnp.asarray(v[0]) for k, v in arrays.items()}
    ds = j_canonical_sort(j_screen_data(splats, camera, rcfg), rcfg)
    ref = np.asarray(jax.jit(lambda d: j_render_tiles(d, j_bin_splats(d, rcfg), rcfg))(ds))
    dk = np.asarray(j_words(splats, camera["view_proj"], camera["cam_pos"], rcfg)["dk"])
    return {
        "shards": [{k: np.asarray(v) for k, v in s.items()} for s in shards],
        "splats": {k: np.asarray(v) for k, v in splats.items()},
        "camera": {k: np.asarray(v[0]) for k, v in arrays.items()},
        "reference": ref, "dk": dk, "bands": _j_depth_band(dk, world, world),
    }


def _view_records() -> np.ndarray:
    """tests/test_sharding.py::TestViewDP's 8 x 64 random records."""
    rng = np.random.default_rng(0)
    n, v = 64, 8
    data = np.zeros((v, n, 10), np.float32)
    data[..., 0] = rng.uniform(0, 32, (v, n))
    data[..., 1] = rng.uniform(0, 32, (v, n))
    data[..., 2] = rng.uniform(1, 6, (v, n))
    data[..., 3] = rng.uniform(0.2, 1.0, (v, n))
    data[..., 4:7] = rng.uniform(0, 1, (v, n, 3))
    data[..., 7] = rng.uniform(1, 9, (v, n))
    data[..., 9] = 1.0
    return data


FIT_CFG = dict(width=32, height=32, base_radius=0.1, tiles_per_splat_cap=16)


@pytest.fixture(scope="module")
def jax_fit():
    """tests/test_fit.py::TestFitDP's two fits on JAX's 8-device mesh: 150
    splats, 8 views at 32x32, colours from grey (10 steps) and SH from zero
    (12 steps)."""
    scene = spt.SDFScene(spt.union(
        spt.Sphere(id="a", radius=0.5), spt.Box(id="b", position=(0.5, 0, 0), size=(0.3, 0.3, 0.3))))
    model_cfg = spt.RenderConfig(width=48, height=48, base_radius=0.08, tiles_per_splat_cap=16)
    splats = jax.jit(lambda p, k: j_model_points(scene, p, k, 150, spt.PointConfig(), model_cfg))(
        scene.params(), jax.random.PRNGKey(0))
    cfg = spt.RenderConfig(**FIT_CFG)
    arrays = [spt.Camera(azimuth=0.4 + 2.0 * np.pi * v / 8, elevation=0.3, aspect=1.0).arrays()
              for v in range(8)]
    cams_l = [{k: jnp.asarray(a) for k, a in c.items()} for c in arrays]
    cams = jax.tree.map(lambda *xs: jnp.stack(xs), *cams_l)
    n = splats["px"].shape[0]
    rng = np.random.default_rng(13)
    sh_true = {c: jnp.asarray(rng.normal(scale=0.25, size=(3, n)).astype(np.float32))
               for c in ("r", "g", "b")}
    mesh = j_make_mesh(dp=8, sp=1)
    init = {k: jnp.full_like(splats[k], 0.5) for k in ("cr", "cg", "cb")}
    targets = jnp.stack(jfit.render_targets(splats, cams_l, cfg, method="tiles"))
    _, losses = jfit.fit_splats_dp(splats, cams, targets, mesh, cfg, fields=("cr", "cg", "cb"),
                                   steps=10, lr=5e-2, method="tiles", init=init)
    targets_sh = jnp.stack(jfit.render_targets(splats, cams_l, cfg, method="tiles", sh=sh_true))
    sh0 = {c: jnp.zeros_like(v) for c, v in sh_true.items()}
    _, losses_sh, sh_fit = jfit.fit_splats_dp(splats, cams, targets_sh, mesh, cfg, fields=(),
                                              steps=12, lr=5e-2, method="tiles", sh=sh0,
                                              fit_sh=True)
    npd = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return {
        "inputs": {"splats": npd(splats), "cfg": FIT_CFG, "method": "tiles",
                   "cameras": {k: np.stack([c[k] for c in arrays]) for k in arrays[0]},
                   "targets": np.asarray(targets), "targets_sh": np.asarray(targets_sh),
                   "init": npd(init), "sh0": npd(sh0)},
        "losses": {"colors": np.asarray(losses), "sh": np.asarray(losses_sh)},
        "sh": npd(sh_fit),
    }


_RUNS = {}


def _run(world, tmp_path_factory, jax_fit):
    if world in _RUNS:
        return _RUNS[world]
    workdir = str(tmp_path_factory.mktemp(f"ranks{world}"))
    if world == 1:
        sc = None
        inputs = {"single": {"cfg": BAND, "n": N_BAND, "seed": 3,
                             "cameras": spt.orbit_ring(2, aspect=1.0),
                             "records": _view_records()}}
    else:
        sc = _band_scene(world)
        dp, sp = (1, 2) if world == 2 else (2, 2)
        inputs = {
            "depth_band": _depth_keys(),
            "band": {"cfg": BAND, "camera": sc["camera"], "shards": sc["shards"], "n": N_BAND,
                     "slack": 2.0},
            "multichip": {
                "headline": {"dp": dp, "sp": sp, "cfg": BAND, "n": 1024, "seed": 7,
                             "cameras": spt.orbit_ring(4, aspect=1.0)},
                # bands 800 or 400 px tall on a 64x1600 frame: the band's
                # screen grid is twice as fine as the frame's
                "portrait": {"dp": 1, "sp": world, "n": 512, "seed": 8,
                             "cfg": dict(BAND, height=1600),
                             "cameras": spt.orbit_ring(1, aspect=64 / 1600)},
            },
            "views": {"data": _view_records(), "cfg": dict(width=32, height=32)},
            "fit": jax_fit["inputs"],
        }
    _RUNS[world] = (run_ranks(world, inputs, workdir), sc)
    return _RUNS[world]


@pytest.fixture
def ranks(request, tmp_path_factory, jax_fit):
    return _run(request.param, tmp_path_factory, jax_fit)


def _by_world(*worlds):
    return pytest.mark.parametrize("ranks", worlds, indirect=True, ids=lambda w: f"world{w}")


# ---- single-process parity: over_merge and compact_to ----


def test_over_merge_bit_equal_to_jax():
    g = np.random.default_rng(5)
    ca, cb = (g.uniform(0, 1, (6, 40, 3)).astype(np.float32) for _ in range(2))
    aa, ab = (g.uniform(0, 1, (6, 40)).astype(np.float32) for _ in range(2))
    aa[0] = 1.0  # an opaque front layer
    want = j_over_merge(*(jnp.asarray(x) for x in (ca, aa, cb, ab)))
    got = over_merge(*(torch.from_numpy(x) for x in (ca, aa, cb, ab)))
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def _compact_words(oriented: bool):
    """JAX-projected words of 2000 random splats (50 bit-equal depth ties,
    a few culled) at 64x48."""
    g = np.random.default_rng(3)
    n = 2000
    pos = g.uniform(-1, 1, (n, 3))
    pos[: n // 50] *= 6.0
    nrm = g.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {"px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
              "radius": g.uniform(0.005, 0.09, n), "cr": g.uniform(0, 1, n),
              "cg": g.uniform(0, 1, n), "cb": g.uniform(0, 1, n),
              "opacity": g.uniform(0.2, 1.0, n),
              "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2]}
    planes = {k: v.astype(np.float32) for k, v in planes.items()}
    for k in planes:
        planes[k][100:150] = planes[k][50:100]
    kw = dict(width=64, height=48, tiles_per_splat_cap=8, oriented=oriented)
    cam = spt.Camera(aspect=64 / 48).arrays()
    jc = spt.RenderConfig(**kw)
    w = j_words({k: jnp.asarray(v) for k, v in planes.items()}, jnp.asarray(cam["view_proj"]),
                jnp.asarray(cam["cam_pos"]), jc)
    return jc, tpt.RenderConfig(**kw), [np.asarray(w[k]) for k in ("dk", "w_pos", "w_ro", "w_rgb")]


@pytest.mark.parametrize("oriented", [False, True], ids=["two_word", "three_word"])
@pytest.mark.parametrize("k", [700, 1900, 5000], ids=["k700", "k1900", "k_above_n"])
def test_compact_to_runs_equal_jax(oriented, k):
    """bin_packed_words(compact_to=k): per tile, the same records' words in
    the same order as JAX's compacted pair stream (the 2-word stream keeps
    w_rgb whole; the 3-word stream every word), below the valid count
    (1997 of 2000 are visible here) and above n."""
    jc, tc, words = _compact_words(oriented)
    assert 1900 < int((words[0] < INF_KEY).sum()) < 2000
    jb = jax.jit(lambda *w: j_bin_packed_words(*w, jc, 1024, compact_to=k))(*words)
    tb = bin_packed_words(*(torch.from_numpy(w.astype(np.int64)) for w in words), tc,
                          compact_to=k)
    np.testing.assert_array_equal(tb["counts"].numpy(), np.asarray(jb["counts"]))
    np.testing.assert_array_equal(tb["offsets"].numpy(), np.asarray(jb["offsets"]))
    live = int(tb["offsets"][-1])
    assert live > 500
    assert tb["rec_pos"].shape == (min(k, 2000),)
    rank = tb["pair_rank"].numpy()[:live]
    pair_w = np.asarray(jb["pair_w"])
    sections = ("rec_pos", "rec_ro", "rec_rgb") if oriented else ("rec_rgb",)
    first = 0 if oriented else 1
    for i, name in enumerate(sections):
        got = tb[name].numpy()[rank].view(np.uint32)
        want = pair_w[:, (first + i) * 128:(first + i + 1) * 128].reshape(-1)[:live]
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_compact_to_keeps_the_nearest_in_input_order():
    """The kept records are the k first in (depth key, input index) order,
    in input order, also through depth-key ties; class_caps still raises."""
    g = np.random.default_rng(4)
    n, k = 300, 120
    dk = torch.from_numpy((0x80000000 | g.integers(0, 30, n) << 20).astype(np.int64))
    ids = torch.arange(n, dtype=torch.int64)
    tc = tpt.RenderConfig(width=32, height=32)
    out = bin_packed_words(dk, ids, ids, ids, tc, compact_to=k)
    kept = torch.sort(torch.sort(dk, stable=True).indices[:k]).values
    assert torch.equal(out["rec_rgb"].long(), kept)
    with pytest.raises(NotImplementedError):
        bin_packed_words(dk, ids, ids, ids, tc, class_caps=(10, 10))
    with pytest.raises(ValueError):
        bin_packed_words(dk, ids, ids, ids, tc, compact_to=0)


# ---- ranks ----


@_by_world(*WORLDS)
def test_mesh_layout_and_device_errors(ranks):
    res, _ = ranks
    world = len(res)
    for r, out in enumerate(res):
        assert out["mesh"] == (1, world, r, 0, r)
        err = out["errors"]
        assert err["too_many"] == f"need {world + 1} devices, have {world}"
        assert "needs an nccl group" in err["cuda_with_gloo"]
        assert "needs an nccl group" in err["default_device"]  # the default is cuda:LOCAL_RANK


@_by_world(*WORLDS)
def test_depth_band_bit_equal_to_jax(ranks):
    res, _ = ranks
    world = len(res)
    dk = _depth_keys()
    for sp in (3, world):
        want = _j_depth_band(dk, world, sp)
        for out in res:
            np.testing.assert_array_equal(out["depth_band"][sp], want, err_msg=f"sp={sp}")
        assert len(np.unique(want)) == sp
        assert np.all(want[dk >= INF_KEY] == sp - 1)
    # the 600 tied keys share a band, and a cut lands on their bucket
    tied = want[dk == TIE_KEY]
    assert len(np.unique(tied)) == 1
    below = (dk < TIE_KEY) & (dk >= TIE_KEY - (KEY_HI - KEY_LO) // 256)
    assert want[below].max() < tied[0]


@_by_world(*WORLDS)
def test_band_frame_matches_jax_single_device(ranks):
    res, sc = ranks
    world = len(res)
    for out in res:  # the image is replicated
        np.testing.assert_array_equal(out["band"]["eps0"]["img"], res[0]["band"]["eps0"]["img"])
    band = res[0]["band"]
    np.testing.assert_allclose(band["eps0"]["img"], sc["reference"], atol=3e-5, rtol=0)
    early = np.abs(band["default"]["img"] - band["eps0"]["img"]).max()
    assert early <= 0.0101
    # stats: JAX's depth_band over the same eager words, counted as
    # JAX's band_frame_fn counts them
    valid = sc["dk"] < INF_KEY
    bands = sc["bands"]
    src = np.arange(N_BAND) // (N_BAND // world)
    counts = [int((valid & (bands == b)).sum()) for b in range(world)]
    want = {"band_max_count": max(counts), "routed_records": int((valid & (bands != src)).sum()),
            "valid_records": int(valid.sum())}
    for label in ("eps0", "default"):
        got = band[label]
        assert {k: int(got[k]) for k in want} == want
        assert not bool(got["band_overflow"]) and got["capacity"] == 2 * N_BAND // world
    assert want["routed_records"] > 0
    wm = band["wire_model"]
    assert wm["a2a_egress_bytes_per_device"] == (world - 1) * (N_BAND // world) * 16
    assert wm["gather_ingress_bytes_per_device"] == (world - 1) * 16 * 256 * 16


@_by_world(*WORLDS)
def test_band_overflow_flagged_and_finite(ranks):
    res, _ = ranks
    over = res[0]["band"]["overflow"]
    assert bool(over["band_overflow"])
    assert int(over["band_max_count"]) > over["capacity"]
    assert np.all(np.isfinite(over["img"]))


def _check_tile_band_views(res, label, n_views):
    """Every rank's band equal to the frame's stream cut at it, bit for
    bit; the gathered views near the single-device frames (eps 0: 3e-5;
    default eps: 0.0101 of the eps-0 frame)."""
    for out in res:
        for e in out["multichip"][label].values():
            assert e["band_equal"] and e["decode_exact"]
    head = res[0]["multichip"][label]
    bg = np.asarray(spt.RenderConfig().background)
    for v in range(n_views):
        assert np.mean(np.abs(head["eps0"]["views"][v] - bg)) > 1e-3, f"view {v} empty"
    np.testing.assert_allclose(head["eps0"]["views"], head["eps0"]["reference"], atol=3e-5,
                               rtol=0)
    assert np.abs(head["default"]["views"] - head["eps0"]["reference"]).max() <= 0.0101
    assert np.abs(head["default"]["reference"] - head["eps0"]["reference"]).max() <= 0.0101
    return head


@_by_world(*WORLDS)
def test_tile_band_views_bit_equal_to_single_device(ranks):
    res, _ = ranks
    world = len(res)
    dp, sp = (1, 2) if world == 2 else (2, 2)
    for out in res:
        for e in out["multichip"]["headline"].values():
            assert e["local_shape"] == (4 // dp, 64 // sp, 64, 3)
    head = _check_tile_band_views(res, "headline", 4)
    assert head["default"]["views"].shape == (4, 64, 64, 3)


@_by_world(*WORLDS)
def test_portrait_tile_bands_requantize_exactly(ranks):
    """64x1600: the frame's screen grid is 1/16 px, its bands' 1/32 px
    (pos_scale grows as max(width, height) shrinks).  The band words are
    requantized by the exact factor 2: every record of a band's runs
    decodes to its frame position less the band's origin, bit for bit, and
    each band equals the frame's stream cut at it."""
    res, _ = ranks
    world = len(res)
    for out in res:
        for e in out["multichip"]["portrait"].values():
            assert (e["frame_scale"], e["band_scale"]) == (16.0, 32.0)
            assert e["local_shape"] == (1, 1600 // world, 64, 3)
    por = _check_tile_band_views(res, "portrait", 1)
    assert por["default"]["views"].shape == (1, 1600, 64, 3)


@_by_world(*WORLDS)
def test_validation_errors(ranks):
    res, _ = ranks
    for out in res:
        for name, msg in out["validation"].items():
            assert "divisible" in msg, name
        err = out["fit_errors"]
        assert "must divide over" in err["views"]
        assert "nothing to fit" in err["fields"]
        assert "needs an initial sh" in err["sh"]


@pytest.fixture(scope="module")
def jax_views():
    return np.asarray(j_views_dp(jnp.asarray(_view_records()), j_make_mesh(dp=8, sp=1),
                                 spt.RenderConfig(width=32, height=32)))


@_by_world(*WORLDS)
def test_views_data_parallel_matches_jax(ranks, jax_views):
    res, _ = ranks
    want = jax_views
    assert all(out["views"] is None for out in res[1:])
    np.testing.assert_allclose(res[0]["views"], want, atol=2e-5, rtol=0)


@_by_world(*WORLDS)
@pytest.mark.parametrize("label", ["colors", "sh"])
def test_fit_splats_dp_matches_jax(ranks, jax_fit, label):
    res, _ = ranks
    got = res[0]["fit"][label]
    want = jax_fit["losses"][label]
    assert got["losses"].shape == want.shape and got["losses"][-1] < got["losses"][0] / 2.0
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4, atol=0)
    for out in res[1:]:  # theta (and the losses) are the same bits on every rank
        np.testing.assert_array_equal(out["fit"][label]["losses"], got["losses"])
        for k, v in got["fitted"].items():
            np.testing.assert_array_equal(out["fit"][label]["fitted"][k], v, err_msg=k)
        for c, v in got.get("sh", {}).items():
            np.testing.assert_array_equal(out["fit"][label]["sh"][c], v, err_msg=c)
    if label == "sh":
        for c, v in jax_fit["sh"].items():
            np.testing.assert_allclose(got["sh"][c], v, atol=1e-4, rtol=0, err_msg=c)


@_by_world(1)
@pytest.mark.parametrize("path", ["band", "multichip", "views", "fit"])
def test_world_one_bit_equal_to_single_device(ranks, path):
    res, _ = ranks
    assert res[0]["single"][path] is True


def _band_words(width, height, oriented, n=1500):
    """Projected words of n random splats, a few of them wide enough for
    the tile cap (4) to shrink their footprints."""
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.convert import splats_from_numpy
    from splat_renderer_tpu_torch.render.projector import splat_screen_words

    g = np.random.default_rng(21)
    pos = g.uniform(-1, 1, (n, 3))
    nrm = g.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {"px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
              "radius": g.uniform(0.005, 0.12, n), "cr": g.uniform(0, 1, n),
              "cg": g.uniform(0, 1, n), "cb": g.uniform(0, 1, n),
              "opacity": g.uniform(0.2, 1.0, n),
              "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2]}
    cfg = tpt.RenderConfig(width=width, height=height, tiles_per_splat_cap=4, oriented=oriented)
    cam = camera_tensors(tpt.Camera(aspect=width / height).arrays(), "cpu")
    spl = splats_from_numpy({k: v.astype(np.float32) for k, v in planes.items()}, "cpu")
    return cfg, splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)


@pytest.mark.parametrize("oriented", [False, True], ids=["isotropic", "oriented"])
@pytest.mark.parametrize("shape", [(96, 64), (32, 1600)], ids=["landscape", "portrait"])
def test_render_band_bins_only_its_records(shape, oriented):
    """render_band bins only the records whose footprint reaches its band,
    and its image equals the frame's stream cut at the band and blended
    by the same tile blend, bit for bit (sp 2 and 4; the portrait bands
    sit on a finer grid than the frame)."""
    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles
    from splat_renderer_tpu_torch.parallel.sharding import _band_cfg, band_records, band_stream
    from splat_renderer_tpu_torch.render.compositor import tiles_to_image

    cfg, w = _band_words(*shape, oriented)
    words = [w[k] for k in ("dk", "w_pos", "w_ro", "w_rgb")]
    full = bin_packed_words(*words, cfg)
    live = int((full["counts"] > 0).sum())
    assert live > cfg.num_tiles // 3
    for sp in (2, 4):
        band_cfg = _band_cfg(cfg, sp)
        assert band_cfg.pos_scale == (32.0 if shape[1] == 1600 else cfg.pos_scale)
        kept = [band_records(w, b, cfg, band_cfg)["dk"].shape[0] for b in range(sp)]
        assert 0 < max(kept) < w["dk"].shape[0], kept
        for b in range(sp):
            got = tpar.render_band(w, b, cfg, sp)
            want = tiles_to_image(*blend_tiles(band_stream(full, b, cfg, band_cfg), band_cfg),
                                  band_cfg)
            assert torch.equal(got, want), (sp, b)


def test_band_config_raises_where_footprints_outreach_the_grid_margin():
    from splat_renderer_tpu_torch.parallel.sharding import _band_cfg

    cfg = tpt.RenderConfig(width=64, height=64)
    assert _band_cfg(cfg, 2).height == 32 and _band_cfg(cfg, 1) == cfg
    with pytest.raises(ValueError, match="divisible"):
        _band_cfg(cfg, 3)
    with pytest.raises(ValueError, match="pos_offset|margin"):
        _band_cfg(tpt.RenderConfig(width=1024, height=1024, tile_size=32,
                                   tiles_per_splat_cap=400), 2)
    assert set(tpar.__all__) >= {"make_mesh", "render_band", "multichip_frame_fn",
                                 "render_views_data_parallel", "depth_band", "band_frame_fn"}
