"""The PyTorch port's config copy against the JAX package's: fields,
defaults, derived properties and presets over a grid of configs."""

import dataclasses

import pytest

import splat_renderer_tpu.config as jcfg
import splat_renderer_tpu_torch.config as tcfg

_DERIVED = ("tile_w", "tile_h", "r_cap", "pos_offset", "pos_scale", "tiles_x",
            "tiles_y", "num_tiles", "tile_pixels")

_GRID = [
    {},
    dict(width=64, height=48),
    dict(width=1920, height=1080, tile_size=32, tile_height=16,
         tiles_per_splat_cap=4, base_radius=0.008),
    dict(width=1280, height=720, tiles_per_splat_cap=8, base_radius=0.015),
    dict(width=4000, height=3000, tile_size=8, bounds_margin=1.3),
    dict(width=33, height=17, tile_size=16, tile_height=8, tiles_per_splat_cap=9),
    dict(width=256, height=256, opaque=True, oriented=True, quad=True,
         ellipse="ewa", aa_dilation=0.3),
]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_field_names_and_defaults_match():
    for cls in ("PointConfig", "RenderConfig"):
        j, t = getattr(jcfg, cls)(), getattr(tcfg, cls)()
        assert _fields(j) == _fields(t), cls


@pytest.mark.parametrize("kw", _GRID, ids=[str(i) for i in range(len(_GRID))])
def test_derived_properties_match(kw):
    j, t = jcfg.RenderConfig(**kw), tcfg.RenderConfig(**kw)
    assert _fields(j) == _fields(t)
    for name in _DERIVED:
        assert getattr(j, name) == getattr(t, name), name
    assert _fields(j.replace(sigma=0.7)) == _fields(t.replace(sigma=0.7))


@pytest.mark.parametrize("preset", ["turbo_render_config", "surface_render_config"])
def test_presets_match(preset):
    for args, kw in (((), {}), ((640, 480), dict(tiles_per_splat_cap=8))):
        j = getattr(jcfg, preset)(*args, **kw)
        t = getattr(tcfg, preset)(*args, **kw)
        assert _fields(j) == _fields(t)


def test_oversized_frame_raises_in_both():
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError, match="u16 screen"):
            mod.RenderConfig(width=70_000, height=10).pos_scale
