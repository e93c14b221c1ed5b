"""The PyTorch port's static-scene path against the JAX package's: 3DGS
`.ply` files byte-identical for the same arrays and loaded planes equal
(SH channel-major layout, dead slots, foreign headers), and
`SplatEngine.frame` with SH colour within 2e-5 of the JAX SplatEngine's
exact oracle on the same splats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.render.pipeline import (
    SplatEngine as JSplatEngine,
    render_splats as j_render_splats,
)
from splat_renderer_tpu.render.sh import apply_sh as j_apply_sh
from splat_renderer_tpu.utils.ply import load_ply as j_load_ply, save_ply as j_save_ply
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.convert import (
    camera_from_numpy,
    sh_from_numpy,
    splats_from_numpy,
)
from splat_renderer_tpu_torch.render.pipeline import SplatEngine, render_splats
from splat_renderer_tpu_torch.render.sh import apply_sh
from splat_renderer_tpu_torch.utils.ply import PLY_THIN, SH_C0, load_ply, save_ply

W, H = 64, 48


def _scene_arrays(seed=0, n=600, sh_rows=15, dead=True):
    """Numpy splat planes around the origin with unit normals (one pointing
    straight down: the quaternion's degenerate branch), unclipped base
    colours, some dead slots, and SH bands."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.7, 0.7, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[0] = (0.0, 0.0, -1.0)
    planes = {
        "px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
        "radius": rng.uniform(0.01, 0.08, n),
        "cr": rng.uniform(-0.1, 1.1, n), "cg": rng.uniform(-0.1, 1.1, n),
        "cb": rng.uniform(-0.1, 1.1, n), "opacity": rng.uniform(0.2, 1.0, n),
        "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2],
    }
    if dead:
        planes["radius"][5::7] = 0.0
    planes = {k: v.astype(np.float32) for k, v in planes.items()}
    sh = None
    if sh_rows:
        sh = {c: rng.normal(scale=0.1, size=(sh_rows, n)).astype(np.float32)
              for c in ("r", "g", "b")}
    return planes, sh


def _as_jax(tree):
    return None if tree is None else {k: jnp.asarray(v) for k, v in tree.items()}


def _same_loaded(t_loaded, j_loaded):
    for k, v in j_loaded.items():
        np.testing.assert_array_equal(t_loaded[k].numpy(), np.asarray(v), err_msg=k)
        assert t_loaded[k].dtype == torch.float32
    assert set(t_loaded) == set(j_loaded)


@pytest.mark.parametrize("sh_rows", [0, 3, 15], ids=["no_sh", "sh_deg1", "sh_deg3"])
def test_ply_files_and_planes_equal_jax(tmp_path, sh_rows):
    planes, sh = _scene_arrays(1, sh_rows=sh_rows)
    tp, jp = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    save_ply(tp, splats_from_numpy(planes, "cpu"),
             None if sh is None else sh_from_numpy(sh, "cpu"))
    j_save_ply(jp, _as_jax(planes), _as_jax(sh))
    t_bytes = open(tp, "rb").read()
    assert t_bytes == open(jp, "rb").read()
    assert len(t_bytes) > 1000
    # numpy inputs write the same file as tensors
    save_ply(tp, planes, sh)
    assert open(tp, "rb").read() == t_bytes

    live = planes["radius"] > 0
    got = load_ply(tp, device="cpu")
    _same_loaded(got, j_load_ply(jp))
    assert got["px"].shape == (int(live.sum()),)  # dead slots are dropped
    t_spl, t_sh = load_ply(tp, with_sh=True, device="cpu")
    j_spl, j_sh = j_load_ply(jp, with_sh=True)
    _same_loaded(t_spl, j_spl)
    if sh_rows == 0:
        assert t_sh is None and j_sh is None
        return
    _same_loaded(t_sh, j_sh)
    # channel-major f_rest layout: row k of channel c is the file's
    # f_rest_{c * m + k}; the unclipped base colour survives
    for c in ("r", "g", "b"):
        assert t_sh[c].shape == (sh_rows, int(live.sum()))
        np.testing.assert_array_equal(t_sh[c].numpy(), sh[c][:, live])
    np.testing.assert_allclose(t_spl["cr"].numpy(), planes["cr"][live], atol=1e-6)
    assert float(t_spl["cr"].min()) < 0.0 < 1.0 < float(t_spl["cr"].max())
    np.testing.assert_allclose(t_spl["nz"].numpy(), planes["nz"][live], atol=1e-5)
    # the JAX package's loaded scene converts to the port's
    c_spl = splats_from_numpy({k: np.asarray(v) for k, v in j_spl.items()}, "cpu")
    c_sh = sh_from_numpy({k: np.asarray(v) for k, v in j_sh.items()}, "cpu")
    _same_loaded(c_spl, j_spl)
    _same_loaded(c_sh, j_sh)


def _write_foreign(path, case):
    """Foreign files, as tests/test_ply.py writes them."""
    rng = np.random.default_rng(0)
    if case in ("full_3dgs", "ascii", "partial_bands"):
        n, extra = 8, {"full_3dgs": 9, "ascii": 3, "partial_bands": 12}[case]
        props = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
        props += [f"f_rest_{i}" for i in range(extra)]
        props += ["opacity", "scale_0", "scale_1", "scale_2",
                  "rot_0", "rot_1", "rot_2", "rot_3"]
        fmt = "ascii" if case == "ascii" else "binary_little_endian"
        header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
        header += [f"property float {p}" for p in props] + ["end_header"]
        rec = np.empty((n,), np.dtype([(p, "<f4") for p in props]))
        for p in props:
            rec[p] = rng.normal(size=n).astype(np.float32)
        rec["rot_0"], rec["rot_1"], rec["rot_2"], rec["rot_3"] = 1, 0, 0, 0
        rec["scale_0"], rec["scale_1"], rec["scale_2"] = np.log(0.2), np.log(0.1), np.log(0.01)
        body = rec.tobytes()
    elif case == "element_before_vertex":
        header = ["ply", "format binary_little_endian 1.0", "element camera 1",
                  "property float cx", "property float cy", "element vertex 4",
                  "property float x", "property float y", "property double z", "end_header"]
        vert = np.empty((4,), np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f8")]))
        vert["x"], vert["y"], vert["z"] = np.arange(4), np.arange(4) + 10, np.arange(4) + 20
        body = np.asarray([9.0, 9.0], "<f4").tobytes() + vert.tobytes()
    elif case == "list_element":
        header = ["ply", "format binary_little_endian 1.0", "element face 2",
                  "property list uchar int vertex_indices", "element vertex 1",
                  "property float x", "end_header"]
        body = b""
    else:
        raise AssertionError(case)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode() + body)


@pytest.mark.parametrize("case", ["full_3dgs", "partial_bands", "element_before_vertex"])
def test_foreign_ply_loads_as_jax(tmp_path, case):
    p = str(tmp_path / "f.ply")
    _write_foreign(p, case)
    _same_loaded(load_ply(p, device="cpu"), j_load_ply(p))
    t_spl, t_sh = load_ply(p, with_sh=True, device="cpu")
    j_spl, j_sh = j_load_ply(p, with_sh=True)
    _same_loaded(t_spl, j_spl)
    if case == "element_before_vertex":
        assert t_sh is None and j_sh is None
        np.testing.assert_array_equal(t_spl["pz"].numpy(), np.arange(4) + 20)
        # no scales, no rotation: unit radius, the first axis as the normal
        np.testing.assert_array_equal(t_spl["nx"].numpy(), np.ones(4))
        np.testing.assert_array_equal(t_spl["radius"].numpy(), np.ones(4))
        return
    _same_loaded(t_sh, j_sh)
    # 9 rest columns are 3 per channel (degree 1); 12 are 4 per channel,
    # truncated to the largest complete degree (3 rows)
    assert t_sh["r"].shape == (3, 8)
    np.testing.assert_allclose(t_spl["radius"].numpy(), np.sqrt(0.2 * 0.1), rtol=1e-5)
    np.testing.assert_allclose(t_spl["nz"].numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("case,match", [("ascii", "binary_little_endian"),
                                        ("list_element", "list-typed"),
                                        ("not_ply", "not a PLY")])
def test_foreign_ply_rejected_as_jax(tmp_path, case, match):
    p = str(tmp_path / "bad.ply")
    if case == "not_ply":
        open(p, "wb").write(b"not a ply\n")
    else:
        _write_foreign(p, case)
    for loader, kw in ((load_ply, dict(device="cpu")), (j_load_ply, {})):
        with pytest.raises(ValueError, match=match):
            loader(p, **kw)


def test_ply_constants_match_jax():
    from splat_renderer_tpu.utils import ply as j_ply

    assert (SH_C0, PLY_THIN) == (j_ply.SH_C0, j_ply.PLY_THIN)


@pytest.fixture(scope="module")
def static_scene():
    planes, sh = _scene_arrays(2, n=1500, dead=False)
    return planes, sh


@pytest.mark.parametrize("profile", ["isotropic", "oriented"])
def test_splat_engine_sh_frame_matches_jax(static_scene, profile):
    """SplatEngine.frame lights with SH per frame, then projects, bins and
    blends: within 2e-5 of what the JAX SplatEngine computes on its exact
    oracle (apply_sh, then the oracle splat chain), with the early exit off
    (transmittance_eps 0).  The JAX side runs eagerly: under jit its
    projector may move a colour or an angle by one quantization step."""
    planes, sh = static_scene
    kw = dict(width=W, height=H, tiles_per_splat_cap=8, transmittance_eps=0.0,
              oriented=profile == "oriented")
    jc, tc = spt.RenderConfig(**kw), tpt.RenderConfig(**kw)
    tspl, tsh = splats_from_numpy(planes, "cpu"), sh_from_numpy(sh, "cpu")
    jspl, jsh = _as_jax(planes), _as_jax(sh)
    jeng = JSplatEngine(jspl, jc, sh=jsh, compositor="oracle")
    assert jeng.n == planes["px"].size
    eng = SplatEngine(tspl, tc, sh=tsh, device="cpu")
    assert eng.n == planes["px"].size and eng.scene is None
    frames = []
    for az in (0.5, 2.0):
        cam = spt.Camera(aspect=W / H, azimuth=az, elevation=0.3).arrays()
        jcam = {k: jnp.asarray(v) for k, v in cam.items()}
        j_lit = j_apply_sh(jspl, jsh, jcam["cam_pos"])
        want = np.asarray(j_render_splats(j_lit, jcam, jc, "oracle"))
        tcam = camera_from_numpy(cam, "cpu")
        got = eng.frame(tcam)
        for ch in ("cr", "cg", "cb"):
            np.testing.assert_allclose(apply_sh(tspl, tsh, tcam["cam_pos"])[ch].numpy(),
                                       np.asarray(j_lit[ch]), atol=1e-6, rtol=0)
        assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
        # the frame is apply_sh followed by the splat chain
        lit = apply_sh(tspl, tsh, tcam["cam_pos"])
        assert torch.equal(got, render_splats(lit, tcam, tc, device="cpu"))
        frames.append(got)
    assert float((frames[0] - frames[1]).abs().max()) > 0.05  # the camera moved
    # the jitted JAX engine itself, to one quantization step of a few records
    j_frame = np.asarray(jeng.frame(jcam, jax.random.PRNGKey(0)))
    assert np.abs(j_frame - frames[1].numpy()).mean() < 1e-5

    # SH changes the colour: the same camera without bands differs
    flat = SplatEngine(tspl, tc, device="cpu").frame(tcam, None)
    assert float((flat - frames[1]).abs().max()) > 0.01
    # the schedules give one image; the generator is not used
    xp = SplatEngine(tspl, tc, sh=tsh, blend_kernel="tile_xp", device="cpu")
    assert torch.equal(xp.frame(tcam, torch.Generator().manual_seed(9)), frames[1])
    assert torch.equal(SplatEngine(tspl, tc, sh=tsh, blend_kernel="flat",
                                   device="cpu").frame(tcam), frames[1])


def test_splat_engine_checks_and_cpu_profile(static_scene):
    planes, sh = static_scene
    tc = tpt.RenderConfig(width=W, height=H)
    tspl, tsh = splats_from_numpy(planes, "cpu"), sh_from_numpy(sh, "cpu")
    with pytest.raises(ValueError, match="unknown blend kernel"):
        SplatEngine(tspl, tc, blend_kernel="tile_xq", device="cpu")
    with pytest.raises(ValueError, match="unknown blend kernel"):
        tpt.Engine(tpt.SDFScene(tpt.Sphere(id="a")), blend_kernel="nope", device="cpu")
    with pytest.raises(ValueError, match="expected"):
        SplatEngine(tspl, tc, sh=tsh, device="meta")
    with pytest.raises(TypeError):
        SplatEngine(tspl, tc)  # no default device
    eng = SplatEngine(tspl, tc, sh=tsh, device="cpu")
    cam = camera_from_numpy(spt.Camera(aspect=W / H).arrays(), "cpu")
    # only the card's clock times the stages: nothing to report on the CPU
    assert eng.stage_profile(cam, None) == {}
