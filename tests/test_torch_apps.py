"""The port's command-line front ends (`splat_renderer_tpu_torch.apps`) on
the CPU at small sizes: datagen's files read by both packages'
`load_dataset`, datagen against the JAX package's `datagen.py`, fit_demo's
loss and `.ply` (read by the JAX package), checkpoint and resume, demo's
two engines over HTTP, and the refusal to run on a card that is not
there."""

import dataclasses
import importlib
import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.utils.ply import load_ply as j_load_ply
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch import sdf as tsdf
from splat_renderer_tpu_torch.apps import datagen, demo, fit_demo
from splat_renderer_tpu_torch.convert import splats_from_numpy
from splat_renderer_tpu_torch.utils.image import read_png
from splat_renderer_tpu_torch.utils.ply import save_ply
from splat_renderer_tpu_torch.viewer import make_server

# tests/test_apps.py::TestGBufferViews::test_datagen_gbuffer_dataset's arguments
DATAGEN_ARGS = ["--views", "2", "--steps", "1", "--points", "400", "--width", "48",
                "--height", "48", "--base-radius", "0.08", "--gbuffer", "--device", "cpu"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("ds")
    manifest = datagen.main(["--out", str(out)] + DATAGEN_ARGS)
    return out, manifest


def test_datagen_gbuffer_dataset_reads_in_both_packages(dataset):
    out, manifest = dataset
    assert manifest == json.loads((out / "manifest.json").read_text())
    assert (manifest["width"], manifest["height"], manifest["fov_deg"]) == (48, 48, 45.0)
    assert len(manifest["frames"]) == 2
    for fr in manifest["frames"]:
        for k in ("file", "depth_file", "alpha_file"):
            assert (out / fr[k]).exists()
        assert fr["depth_max"] >= fr["depth_min"] > 0.0
        assert read_png(str(out / fr["file"])).shape == (48, 48, 3)
    want = spt.load_dataset(str(out), gbuffer=True)
    got = tpt.load_dataset(str(out), gbuffer=True, device="cpu")
    assert len(got["images"]) == len(want["images"]) == 2
    for k in ("images", "depth", "alpha"):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got["cameras"], want["cameras"]):
        for k in ("view_proj", "cam_pos"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    # the views are not empty: the demo scene covers part of each
    assert all(float(a.max()) > 0.5 for a in got["alpha"])


def test_datagen_matches_the_jax_script(tmp_path, monkeypatch):
    """The port's datagen and the JAX package's `datagen.py` at the
    arguments above over 2 steps: the manifests' files, steps, times and
    cameras are equal, and so are the animated scene parameters each step
    renders.  The two draw their surface samples from different random
    generators, so their images differ; each view's depth range, mean
    depth and alpha coverage agree within what that sampling moves
    (under 1% and 0.01 here)."""
    args = DATAGEN_ARGS[:DATAGEN_ARGS.index("--steps") + 1] + ["2"] \
        + DATAGEN_ARGS[DATAGEN_ARGS.index("--steps") + 2:DATAGEN_ARGS.index("--device")]
    seen = {"jax": [], "port": []}

    def recorder(cls, name, to_numpy):
        params = cls.params

        def record(self, *a, **k):
            p = params(self, *a, **k)
            seen[name].append({i: {f: np.array(to_numpy(v)) for f, v in d.items()}
                               for i, d in p.items()})
            return p
        monkeypatch.setattr(cls, "params", record)

    recorder(spt.SDFScene, "jax", np.asarray)
    recorder(tsdf.SDFScene, "port", lambda v: v.numpy())
    jax_datagen = importlib.import_module("datagen")
    monkeypatch.setattr(sys, "argv", ["datagen.py", "--out", str(tmp_path / "jax")] + args)
    jax_datagen.main()
    got = datagen.main(["--out", str(tmp_path / "port")] + args + ["--device", "cpu"])
    want = json.loads((tmp_path / "jax" / "manifest.json").read_text())

    assert len(seen["jax"]) == len(seen["port"]) == 2

    def by_id(p):  # blend nodes are numbered per process: key them by value
        named = {i: d for i, d in p.items() if not i.startswith("smin_")}
        return named, sorted(float(d["k"]) for i, d in p.items() if i.startswith("smin_"))

    for j, t in zip(seen["jax"], seen["port"]):
        (jn, jk), (tn, tk) = by_id(j), by_id(t)
        assert jn.keys() == tn.keys() and jk == tk
        for i in jn:
            for f in jn[i]:
                np.testing.assert_array_equal(tn[i][f], jn[i][f], err_msg=f"{i}.{f}")
    assert {k: v for k, v in got.items() if k != "frames"} == \
        {k: v for k, v in want.items() if k != "frames"}
    assert len(got["frames"]) == len(want["frames"]) == 4
    for g, w in zip(got["frames"], want["frames"]):
        for k in ("file", "step", "time", "view_proj", "cam_pos", "depth_file", "alpha_file"):
            assert g[k] == w[k], k
        for k in ("depth_min", "depth_max"):
            assert abs(g[k] - w[k]) <= 0.01 * w[k], (g["file"], k, g[k], w[k])
    jds = spt.load_dataset(str(tmp_path / "jax"), gbuffer=True)
    tds = tpt.load_dataset(str(tmp_path / "port"), gbuffer=True, device="cpu")
    for jd, td, ja, ta in zip(jds["depth"], tds["depth"], jds["alpha"], tds["alpha"]):
        jd, td, ja, ta = np.asarray(jd), td.numpy(), np.asarray(ja), ta.numpy()
        assert abs(float((ta > 0.5).mean()) - float((ja > 0.5).mean())) <= 0.01
        j_mean, t_mean = float(jd[ja > 0.5].mean()), float(td[ta > 0.5].mean())
        assert abs(t_mean - j_mean) <= 0.01 * j_mean


class _Stop(Exception):
    pass


def _named_params(params, to_numpy):
    """Scene parameters of the named primitives (blend nodes are numbered
    per process)."""
    return {i: {f: np.array(to_numpy(v)) for f, v in d.items()}
            for i, d in params.items() if not i.startswith("smin_")}


@pytest.mark.parametrize("extra", [[], ["--surface"], ["--aa", "0.3", "--points", "700"]],
                         ids=["default", "surface", "aa"])
def test_demo_builds_what_the_jax_script_serves(monkeypatch, extra):
    """The port's `demo.build` against the engine and animation the JAX
    package's `demo.py` hands to `serve`, at the same arguments: the same
    render configuration and point count, and the same scene parameters
    after the animation at a few times.  With --surface the port draws the
    upstream app's quads at full size (`quad=True`, cap 16), where the JAX
    script draws opaque ellipses at cap 8; nothing else differs."""
    jax_demo = importlib.import_module("demo")
    served = {}

    def fake_serve(engine, port=8000, animate=None):
        served.update(engine=engine, animate=animate)
        raise _Stop

    monkeypatch.setattr(jax_demo, "serve", fake_serve)
    monkeypatch.setattr(sys, "argv", ["demo.py"] + extra)
    with pytest.raises(_Stop):
        jax_demo.main()
    eng, animate = demo.build(demo.parse_args(extra + ["--device", "cpu"]), torch.device("cpu"))
    want = served["engine"]
    want_rcfg = dataclasses.asdict(want.rcfg)
    if "--surface" in extra:
        assert (want_rcfg["quad"], want_rcfg["tiles_per_splat_cap"]) == (False, 8)
        want_rcfg.update(quad=True, tiles_per_splat_cap=16)
    assert dataclasses.asdict(eng.rcfg) == want_rcfg
    assert dataclasses.asdict(eng.pcfg) == dataclasses.asdict(want.pcfg)
    assert eng.n == want.n
    for t in (0.0, 0.7, 2.5):
        animate(t)
        served["animate"](t)
        got = _named_params(eng.scene.params(torch.device("cpu")), lambda v: v.numpy())
        exp = _named_params(want.scene.params(), np.asarray)
        assert got.keys() == exp.keys()
        for i in exp:
            for f in exp[i]:
                np.testing.assert_array_equal(got[i][f], exp[i][f], err_msg=f"t={t} {i}.{f}")


def test_fit_demo_sets_up_what_the_jax_script_fits(monkeypatch):
    """The port's fit_demo against the JAX package's `fit_demo.py` at the
    same arguments, up to the call of `fit_splats`: the same render
    configuration, cameras, fields, steps, learning rate and method (the
    JAX package's "pallas" is the port's "kernel"), the same number of
    splats and the same flat start for the appearance fields.  The two draw
    their surface samples from different random generators, so the splats
    and targets themselves differ."""
    import splat_renderer_tpu.fit as j_fit
    import splat_renderer_tpu_torch.fit as t_fit

    calls = {}

    def capture(name):
        def fit_splats(splats, cameras, targets, cfg, **kw):
            calls[name] = dict(splats=splats, cameras=cameras, targets=targets, cfg=cfg, **kw)
            raise _Stop
        return fit_splats

    monkeypatch.setattr(j_fit, "fit_splats", capture("jax"))
    monkeypatch.setattr(t_fit, "fit_splats", capture("port"))
    args = ["--steps", "7", "--n", "200", "--size", "32", "--views", "2", "--lr", "0.05",
            "--fields", "cr,cg,cb,opacity,px,radius"]
    monkeypatch.setattr(sys, "argv", ["fit_demo.py"] + args + ["--method", "pallas"])
    with pytest.raises(_Stop):
        importlib.import_module("fit_demo").main()
    with pytest.raises(_Stop):
        fit_demo.main(args + ["--method", "kernel", "--device", "cpu"])
    j, t = calls["jax"], calls["port"]
    assert dataclasses.asdict(t["cfg"]) == dataclasses.asdict(j["cfg"])
    assert (j["method"], t["method"]) == ("pallas", "kernel")
    for k in ("fields", "steps", "lr", "log_every", "checkpoint_every", "resume", "fit_sh"):
        assert t[k] == j[k], k
    assert len(t["cameras"]) == len(j["cameras"]) == 2
    for tc, jc in zip(t["cameras"], j["cameras"]):
        for k in ("view_proj", "cam_pos"):
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    assert t["splats"]["px"].shape == tuple(j["splats"]["px"].shape) == (200,)
    assert t["init"].keys() == j["init"].keys()
    for k in ("cr", "cg", "cb", "opacity"):
        assert bool((t["init"][k] == 0.5).all()) and bool((np.asarray(j["init"][k]) == 0.5).all())
    for k in ("px", "radius"):  # geometry starts from the truth plus 0.02-scale noise
        off = (t["init"][k] - t["splats"][k]).abs()
        assert 0.0 < float(off.mean()) < 0.05
    assert t["targets"][0].shape == tuple(j["targets"][0].shape) == (32, 32, 3)


def test_fit_demo_lowers_loss_and_writes_ply(tmp_path):
    ply = str(tmp_path / "fit.ply")
    fitted, losses = fit_demo.main(["--steps", "15", "--n", "300", "--size", "32",
                                    "--ply-out", ply, "--device", "cpu"])
    assert losses.shape == (15,) and bool(torch.isfinite(losses).all())
    assert float(losses[-1]) < 0.5 * float(losses[0])
    planes = j_load_ply(ply)
    assert planes["px"].shape == (300,)
    for k in ("px", "py", "pz"):
        np.testing.assert_array_equal(np.asarray(planes[k]), fitted[k].numpy())
    for k in ("cr", "cg", "cb", "opacity"):
        np.testing.assert_allclose(np.asarray(planes[k]), fitted[k].numpy(), atol=1e-6)


def test_fit_demo_dataset_mode_and_resume(dataset, tmp_path):
    out, _ = dataset
    ck = str(tmp_path / "state.npz")
    args = ["--dataset", str(out), "--n", "300", "--method", "kernel",
            "--depth-weight", "0.2", "--checkpoint", ck, "--device", "cpu"]
    _, first = fit_demo.main(args + ["--steps", "4"])
    _, resumed = fit_demo.main(args + ["--steps", "6"])
    _, straight = fit_demo.main(args[:-4] + ["--steps", "6", "--device", "cpu"])
    assert torch.equal(resumed[:4], first)
    assert torch.equal(resumed, straight)
    assert float(straight[-1]) < float(straight[0])
    with pytest.raises(SystemExit, match="tiles or kernel"):
        fit_demo.main(["--dataset", str(out), "--method", "oracle", "--depth-weight", "0.2",
                       "--steps", "1", "--device", "cpu"])


def _serve_one_frame(engine, animate):
    httpd = make_server(engine, port=0, animate=animate, profile_stages=False)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        r = urllib.request.urlopen(
            f"http://127.0.0.1:{httpd.server_address[1]}/frame?az=0.5&t=0.7&raw=1", timeout=60)
        body = r.read()
        assert r.status == 200 and httpd.render_loop.error is None
        h, w = int(r.headers["x-h"]), int(r.headers["x-w"])
        return np.frombuffer(body, np.uint8).reshape(h, w, 3)
    finally:
        httpd.shutdown()
        httpd.render_loop.stop()
        httpd.server_close()
        th.join(timeout=10)
        assert not th.is_alive()


def test_demo_serves_the_sdf_scene_and_a_ply(tmp_path):
    args = demo.parse_args(["--width", "40", "--height", "32", "--points", "500",
                            "--device", "cpu"])
    eng, animate = demo.build(args, torch.device("cpu"))
    assert isinstance(eng, tpt.Engine) and eng.n == 500
    frame = _serve_one_frame(eng, animate)
    assert frame.shape == (32, 40, 3) and frame.max() > 0

    g = np.random.default_rng(0)
    n = 400
    planes = {k: g.uniform(-0.5, 0.5, n) for k in ("px", "py", "pz")}
    planes.update({k: g.uniform(0.2, 1.0, n) for k in ("cr", "cg", "cb", "opacity")})
    planes["radius"] = g.uniform(0.02, 0.06, n)
    nrm = g.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes.update(nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2])
    sh = {c: torch.from_numpy(g.normal(0, 0.1, (3, n)).astype(np.float32)) for c in "rgb"}
    ply = str(tmp_path / "scene.ply")
    save_ply(ply, splats_from_numpy(planes, "cpu"), sh=sh)
    args = demo.parse_args(["--ply", ply, "--width", "40", "--height", "32",
                            "--device", "cpu"])
    eng, animate = demo.build(args, torch.device("cpu"))
    assert isinstance(eng, tpt.SplatEngine) and animate is None and eng.sh is not None
    frame = _serve_one_frame(eng, animate)
    assert frame.shape == (32, 40, 3) and frame.max() > 0


def test_no_card_no_run(monkeypatch, tmp_path):
    """--device cuda (the default) without a card raises before any work;
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: datagen.main(["--out", str(tmp_path / "x")]),
                lambda: fit_demo.main(["--steps", "1"]),
                lambda: demo.main(["--port", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    assert not (tmp_path / "x").exists()
