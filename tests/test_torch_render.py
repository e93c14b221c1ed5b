"""The PyTorch port's projector, binner and oracle against the JAX
package's, on the same numpy splats and camera: record words and per-tile
record order bit-equal, oracle images within 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.render.binning import (
    bin_splats as j_bin_splats,
    bin_splats_packed as j_bin_splats_packed,
    canonical_sort_data as j_canonical_sort_data,
)
from splat_renderer_tpu.render.oracle import render_oracle as j_render_oracle
from splat_renderer_tpu.render.packing import depth_bits as j_depth_bits
from splat_renderer_tpu.render.projector import (
    splat_screen_records as j_records,
    splat_screen_words as j_words,
)
import splat_renderer_tpu_torch.config as tcfg
from splat_renderer_tpu_torch.convert import camera_from_numpy, splats_from_numpy
from splat_renderer_tpu_torch.render.binning import bin_packed_words
from splat_renderer_tpu_torch.render.oracle import render_oracle
from splat_renderer_tpu_torch.render.packing import depth_bits, unpack_words
from splat_renderer_tpu_torch.render.projector import (
    splat_screen_records,
    splat_screen_words,
)

W, H = 96, 64

PROFILES = {
    "isotropic": {},
    "oriented": dict(oriented=True),
    "ewa": dict(oriented=True, ellipse="ewa"),
    "opaque": dict(opaque=True, oriented=True, color_mode="normal_signed",
                   light_ambient=0.3, light_diffuse=0.7),
    "quad": dict(opaque=True, oriented=True, quad=True),
    "aa": dict(aa_dilation=0.3),
}


def random_splats(seed, n=2500, spread=1.0, r_lo=0.005, r_hi=0.06):
    """Numpy splat planes scattered around the origin, some behind the
    camera and some off screen, with random unit normals."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3))
    pos[: n // 50] *= 6.0  # a few far outside the frustum / behind the eye
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {
        "px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
        "radius": rng.uniform(r_lo, r_hi, n),
        "cr": rng.uniform(0, 1, n), "cg": rng.uniform(0, 1, n),
        "cb": rng.uniform(0, 1, n), "opacity": rng.uniform(0.2, 1.0, n),
        "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2],
    }
    return {k: v.astype(np.float32) for k, v in planes.items()}


def camera(aspect, **kw):
    return spt.Camera(aspect=aspect, **kw).arrays()


def both(kw):
    return spt.RenderConfig(**kw), tcfg.RenderConfig(**kw)


def run_both(fn_j, fn_t, planes, cam, jc, tc):
    j = fn_j({k: jnp.asarray(v) for k, v in planes.items()},
             jnp.asarray(cam["view_proj"]), jnp.asarray(cam["cam_pos"]), jc)
    tcam = camera_from_numpy(cam, "cpu")
    t = fn_t(splats_from_numpy(planes, "cpu"), tcam["view_proj"], tcam["cam_pos"], tc)
    return j, t


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_words_bit_equal(profile):
    kw = dict(width=W, height=H, tiles_per_splat_cap=8, **PROFILES[profile])
    jc, tc = both(kw)
    planes = random_splats(7)
    j, t = run_both(j_words, splat_screen_words, planes, camera(W / H), jc, tc)
    for k in ("dk", "w_pos", "w_ro", "w_rgb"):
        got = t[k].numpy()
        assert got.min() >= 0 and got.max() < 2**32, k
        np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(j[k]), err_msg=k)
    np.testing.assert_array_equal(t["depth"].numpy(), np.asarray(j["depth"]))


@pytest.mark.parametrize("profile", ["isotropic", "ewa"])
def test_records_bit_equal_and_unpack(profile):
    kw = dict(width=W, height=H, **PROFILES[profile])
    jc, tc = both(kw)
    planes = random_splats(8)
    j, t = run_both(j_records, splat_screen_records, planes, camera(W / H), jc, tc)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    tcam = camera_from_numpy(camera(W / H), "cpu")
    w = splat_screen_words(splats_from_numpy(planes, "cpu"), tcam["view_proj"],
                           tcam["cam_pos"], tc)
    fields = unpack_words(w["w_pos"], w["w_ro"], w["w_rgb"], tc)
    # unpack order (cx, cy, r, op, r, g, b, ang, ratio) vs record columns
    for f, col in zip(fields, (0, 1, 2, 3, 4, 5, 6, 8, 9)):
        np.testing.assert_array_equal(f.numpy(), t[:, col].numpy())


def test_depth_bits_order_and_bits():
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.uniform(0.01, 100, 500), [np.inf, 0.0, 3.0, 3.0]]).astype(np.float32)
    got = depth_bits(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(j_depth_bits(jnp.asarray(d))))
    np.testing.assert_array_equal(np.argsort(got, kind="stable"), np.argsort(d, kind="stable"))


BIN_CASES = {
    "iso16": dict(tiles_per_splat_cap=8),
    "iso32x16cap4": dict(tile_size=32, tile_height=16, tiles_per_splat_cap=4),
    "oriented32x16": dict(tile_size=32, tile_height=16, tiles_per_splat_cap=4,
                          oriented=True),
    "quad16": dict(tiles_per_splat_cap=8, opaque=True, oriented=True, quad=True),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_binning_matches_jax(case):
    kw = dict(width=W, height=H, **BIN_CASES[case])
    jc, tc = both(kw)
    # a symmetric duplicate block makes bit-equal depth ties
    planes = random_splats(9, r_hi=0.09)
    for k in planes:
        planes[k][100:150] = planes[k][50:100]
    cam = camera(W / H)
    jrec, tw = run_both(j_records, splat_screen_words, planes, cam, jc, tc)
    tb = bin_packed_words(tw["dk"], tw["w_pos"], tw["w_ro"], tw["w_rgb"], tc)

    # jitted for speed: the binners' integer outputs equal the eager ones
    jp = jax.jit(j_bin_splats_packed, static_argnums=(1, 2))(jrec, jc, 1024)
    np.testing.assert_array_equal(tb["counts"].numpy(), np.asarray(jp["counts"]))
    np.testing.assert_array_equal(tb["offsets"].numpy(), np.asarray(jp["offsets"]))

    jb = jax.jit(lambda r: j_bin_splats(j_canonical_sort_data(r, jc), jc))(jrec)
    joff, jsplat = np.asarray(jb["offsets"]), np.asarray(jb["pair_splat"])
    toff, trank = tb["offsets"].numpy(), tb["pair_rank"].numpy()
    np.testing.assert_array_equal(toff, joff)
    assert toff[-1] > 0
    for t in range(tc.num_tiles):
        np.testing.assert_array_equal(trank[toff[t]:toff[t + 1]],
                                      jsplat[joff[t]:joff[t + 1]], err_msg=f"tile {t}")
    # the canonical order really is (depth key, input index)
    dk = tw["dk"].numpy()
    order = tb["order"].numpy()
    np.testing.assert_array_equal(order, np.lexsort((np.arange(dk.size), dk)))
    assert np.all(tb["pair_tile"].numpy()[toff[-1]:] == tc.num_tiles)


@pytest.mark.parametrize("profile", ["isotropic", "oriented", "quad"])
def test_oracle_matches_jax(profile):
    kw = dict(width=48, height=32, **PROFILES[profile])
    jc, tc = both(kw)
    planes = random_splats(10, n=600, r_hi=0.09)
    j, t = run_both(j_records, splat_screen_records, planes, camera(48 / 32), jc, tc)
    want = np.asarray(j_render_oracle(j, jc))
    got = render_oracle(t, tc).numpy()
    assert got.shape == (32, 48, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_unsupported_binning_options_raise():
    tc = tcfg.RenderConfig(width=32, height=32)
    z = torch.zeros(4, dtype=torch.int64)
    for cfg, kw in ((tc.replace(fast_math=True), {}),
                    (tc.replace(depth_key_order=True), {}),
                    (tc, dict(compact_to=2)), (tc, dict(class_caps=(1, 1)))):
        with pytest.raises(NotImplementedError):
            bin_packed_words(z, z, z, z, cfg, **kw)
    # the G-buffer stream is ported: it returns the depth plane
    assert "rec_depth" in bin_packed_words(z, z, z, z, tc, with_depth=True)
