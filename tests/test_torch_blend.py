"""The tile blend's plain PyTorch twin (the CUDA kernel's CPU stand-in)
against the JAX package's Pallas kernels in interpret mode, both schedules
(kernel="tile", the Engine default, and kernel="flat"), and against the JAX
oracle: the same numpy record stream through both, images within 2e-5 at
eps = 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.ops.tile_blend import render_tiles_pallas
from splat_renderer_tpu.render.binning import bin_splats_packed
from splat_renderer_tpu.render.oracle import render_oracle as j_render_oracle
from splat_renderer_tpu.render.packing import (
    depth_bits as j_depth_bits,
    pack_records,
    quantize_screen_data,
)
import splat_renderer_tpu_torch.config as tcfg
from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
from splat_renderer_tpu_torch.render.binning import bin_packed_words
from splat_renderer_tpu_torch.render.compositor import tiles_to_image

ATOL = 2e-5

PROFILES = {
    "isotropic": {},
    "oriented": dict(oriented=True),
    "opaque": dict(opaque=True),
    "quad": dict(opaque=True, oriented=True, quad=True),
}
TILES = {"16x16": dict(tile_size=16), "32x16": dict(tile_size=32, tile_height=16)}


def random_records(seed, n, cfg, r_lo=1.0, r_hi=8.0, opacity=None):
    """(N, 10) screen records [cx, cy, r, op, rgb, depth, angle, ratio]
    scattered over (and just beyond) the viewport, with repeated depths."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 10.0, n)
    depth[n // 2: n // 2 + 20] = depth[:20]  # bit-equal depth ties
    cols = [
        rng.uniform(-10, cfg.width + 10, n), rng.uniform(-10, cfg.height + 10, n),
        rng.uniform(r_lo, r_hi, n),
        rng.uniform(0.3, 1.0, n) if opacity is None else np.full(n, opacity),
        rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n),
        depth, rng.uniform(-np.pi, np.pi, n), rng.uniform(0.1, 1.0, n),
    ]
    return np.column_stack(cols).astype(np.float32)


def port_binned(q, cfg):
    """The JAX package's quantized records as the port's binned stream."""
    words = [torch.from_numpy(np.asarray(w).astype(np.int64)) for w in pack_records(q, cfg)]
    dk = torch.from_numpy(np.asarray(j_depth_bits(q[:, 7])).astype(np.int64))
    tc = tcfg.RenderConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    return bin_packed_words(dk, *words, tc), tc


# every profile on at least one tile shape; isotropic and quad on both
CASES = [("isotropic", "16x16"), ("isotropic", "32x16"), ("oriented", "32x16"),
         ("opaque", "16x16"), ("quad", "16x16"), ("quad", "32x16")]


@pytest.mark.parametrize("profile,tiles", CASES)
def test_twin_matches_pallas_kernels_and_oracle(profile, tiles):
    cfg = spt.RenderConfig(width=64, height=48, tiles_per_splat_cap=16,
                           **PROFILES[profile], **TILES[tiles])
    q = quantize_screen_data(jnp.asarray(random_records(1, 150, cfg)), cfg)
    binned, tc = port_binned(q, cfg)
    tile_color, tile_alpha = blend_tiles(binned, tc, eps=0.0)  # CPU: the twin
    got = tiles_to_image(tile_color, tile_alpha, tc).numpy()
    assert got.shape == (48, 64, 3) and np.isfinite(got).all()

    st = jax.jit(bin_splats_packed, static_argnums=(1, 2))(q, cfg, 1024)
    for kernel in ("tile", "flat"):
        want = render_tiles_pallas(q, st, cfg, block=1024, eps=0.0,
                                   interpret=True, kernel=kernel)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=kernel)
    np.testing.assert_allclose(got, np.asarray(j_render_oracle(q, cfg)),
                               atol=ATOL, rtol=0, err_msg="oracle")
    # empty tiles come out clear: colour 0, alpha 0
    empty = binned["counts"].numpy() == 0
    assert np.all(tile_alpha.numpy()[empty] == 0.0)
    assert np.all(tile_color.numpy()[empty] == 0.0)


@pytest.mark.parametrize("profile", ["isotropic", "opaque"])
def test_early_exit_within_eps_of_exact(profile):
    cfg = spt.RenderConfig(width=32, height=32, tiles_per_splat_cap=16,
                           **PROFILES[profile])
    q = quantize_screen_data(
        jnp.asarray(random_records(2, 300, cfg, r_lo=3.0, r_hi=10.0, opacity=0.99)), cfg)
    binned, tc = port_binned(q, cfg)
    exact = tiles_to_image(*blend_tiles_plain(binned, tc, eps=0.0), tc)
    early = tiles_to_image(*blend_tiles_plain(binned, tc, eps=0.01), tc)
    diff = float((early - exact).abs().max())
    assert diff <= 0.0101
    # the floor actually engaged somewhere: near-opaque pixels saturate
    assert float((1.0 - blend_tiles_plain(binned, tc, eps=0.0)[1]).min()) <= 0.01


@pytest.mark.parametrize("pair_chunk", [7, 64, 4096])
def test_twin_is_chunk_invariant(pair_chunk):
    """Chunk boundaries cut tiles' runs anywhere; the result may differ only
    by float rounding."""
    cfg = spt.RenderConfig(width=48, height=32, tiles_per_splat_cap=16, oriented=True)
    q = quantize_screen_data(jnp.asarray(random_records(3, 200, cfg)), cfg)
    binned, tc = port_binned(q, cfg)
    ref = blend_tiles_plain(binned, tc, eps=0.0)
    got = blend_tiles_plain(binned, tc, eps=0.0, pair_chunk=pair_chunk)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_wrapper_rejects_devices_without_a_kernel():
    cfg = tcfg.RenderConfig(width=32, height=32)
    binned = {"offsets": torch.zeros(cfg.num_tiles + 1, dtype=torch.int32, device="meta")}
    with pytest.raises(ValueError, match="no tile-blend kernel"):
        blend_tiles(binned, cfg)
