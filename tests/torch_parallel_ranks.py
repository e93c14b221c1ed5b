"""Rank bodies of tests/test_torch_parallel.py: the port's multi-device
paths on real gloo ranks on the CPU.

`run_ranks(world, inputs, workdir)` spawns `world` processes (the spawn
method; a `file://` store under `workdir`, so concurrent test workers share
no port), runs `rank_body` in each and returns every rank's result dict.
A rank that fails or hangs fails the call within its timeout, with the
rank's traceback.  This module imports no JAX, so each child stays light:
the test passes in JAX's outputs as numpy arrays.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback

import numpy as np

RANK_TIMEOUT_S = 150  # the whole spawn; a collective gives up after COLLECTIVE_TIMEOUT_S
COLLECTIVE_TIMEOUT_S = 60


def run_ranks(world: int, inputs: dict, workdir: str) -> list:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = os.path.join(workdir, "store")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, inputs, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(workdir, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0 and r not in hung:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if hung or errors:
        raise RuntimeError(f"world {world}: ranks {hung} hung past {RANK_TIMEOUT_S} s; "
                           + "\n".join(errors))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, store: str, inputs: dict, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        res = rank_body(rank, world, inputs)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy()


def _scene():
    import splat_renderer_tpu_torch as tpt

    return tpt.SDFScene(tpt.smooth_union(
        0.15, tpt.Sphere(id="s1", radius=0.5),
        tpt.Box(id="b1", position=(0.6, 0, 0), size=(0.3, 0.3, 0.3))))


def _error(fn) -> str:
    """The message of the ValueError fn raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def rank_body(rank: int, world: int, inp: dict) -> dict:
    """Every check of one spawn; keys of `inp` select the phases."""
    import torch

    import splat_renderer_tpu_torch as tpt
    from splat_renderer_tpu_torch import fit as tfit
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.convert import sh_from_numpy, splats_from_numpy
    from splat_renderer_tpu_torch.parallel import (
        band_frame_fn, depth_band, gather_views, make_mesh, multichip_frame_fn,
        rank_generator, render_views_data_parallel,
    )
    from splat_renderer_tpu_torch.parallel.sharding import gather_splats
    from splat_renderer_tpu_torch.render.pipeline import model_points, render_splats

    res = {}
    flat = make_mesh(dp=1, sp=world, device="cpu")
    res["mesh"] = (flat.dp, flat.sp, flat.rank, flat.dp_index, flat.sp_index)
    res["errors"] = {
        "too_many": _error(lambda: make_mesh(dp=world + 1, sp=1, device="cpu")),
        "cuda_with_gloo": _error(lambda: make_mesh(dp=world, sp=1, device="cuda:0")),
        "default_device": _error(lambda: make_mesh(dp=world, sp=1)),
    }

    if "depth_band" in inp:
        dk_all = torch.from_numpy(inp["depth_band"].astype(np.int64))
        n_local = dk_all.shape[0] // world
        local = dk_all[rank * n_local:(rank + 1) * n_local]
        res["depth_band"] = {}
        for sp in (world, 3):
            band = depth_band(local, flat.group, sp)
            res["depth_band"][sp] = _np(gather_splats({"b": band}, flat)["b"])

    scene = _scene()
    pcfg = tpt.PointConfig(descent_steps=3)
    if "band" in inp:
        b = inp["band"]
        rcfg = tpt.RenderConfig(**b["cfg"])
        cam = camera_tensors(b["camera"], "cpu")
        local = splats_from_numpy(b["shards"][rank], "cpu")
        out = {}
        rcfg0 = rcfg.replace(transmittance_eps=0.0)
        for label, slack, cfg in (("eps0", b["slack"], rcfg0), ("default", b["slack"], rcfg),
                                  ("overflow", 0.05, rcfg0)):
            fn = band_frame_fn(scene, flat, b["n"], pcfg, cfg, band_slack=slack)
            img, stats = fn.from_splats(local, cam)
            out[label] = {"img": _np(img), "capacity": fn.capacity,
                          **{k: _np(v) for k, v in stats.items()}}
        out["wire_model"] = fn.wire_model
        res["band"] = out

    if "multichip" in inp:
        res["multichip"] = {}
        for label, m in inp["multichip"].items():
            mesh = make_mesh(dp=m["dp"], sp=m["sp"], device="cpu")
            cams = camera_tensors(m["cameras"], "cpu")
            entry = {}
            for eps_label, eps in (("default", None), ("eps0", 0.0)):
                rcfg = tpt.RenderConfig(**m["cfg"])
                rcfg = rcfg if eps is None else rcfg.replace(transmittance_eps=eps)
                fn = multichip_frame_fn(scene, mesh, m["n"], pcfg, rcfg)
                local = fn(scene.params("cpu"), cams, m["seed"])
                full = fn.gather(local)
                mine = model_points(scene, scene.params("cpu"),
                                    rank_generator(m["seed"], rank, "cpu"), m["n"] // world,
                                    pcfg, rcfg, device="cpu")
                cut, exact = _frame_band_cut(gather_splats(mine, mesh), cams, mesh, rcfg,
                                             fn.band_cfg)
                e = {"local_shape": tuple(local.shape), "band_equal": torch.equal(local, cut),
                     "decode_exact": exact, "band_scale": fn.band_cfg.pos_scale,
                     "frame_scale": rcfg.pos_scale}
                if rank == 0:
                    # the single-device frames of the same splats: every
                    # rank's rank_generator stream, concatenated in rank order
                    parts = [model_points(scene, scene.params("cpu"),
                                          rank_generator(m["seed"], r, "cpu"), m["n"] // world,
                                          pcfg, rcfg, device="cpu") for r in range(world)]
                    splats = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
                    ref = [render_splats(splats, {k: v[i] for k, v in cams.items()}, rcfg,
                                         device="cpu") for i in range(cams["view_proj"].shape[0])]
                    e["views"] = _np(full)
                    e["reference"] = _np(torch.stack(ref))
                entry[eps_label] = e
            res["multichip"][label] = entry
        res["validation"] = {
            "tiles_y": _error(lambda: multichip_frame_fn(
                scene, flat, 1024, pcfg, tpt.RenderConfig(width=64, height=16 * (world + 1)))),
            "points": _error(lambda: multichip_frame_fn(
                scene, flat, 1023, pcfg, tpt.RenderConfig(width=64, height=64))),
            "band_points": _error(lambda: band_frame_fn(
                scene, flat, 1023, pcfg, tpt.RenderConfig(width=64, height=64))),
        }

    if "views" in inp:
        v = inp["views"]
        dp_mesh = make_mesh(dp=world, sp=1, device="cpu")
        local = render_views_data_parallel(torch.from_numpy(v["data"]), dp_mesh,
                                           tpt.RenderConfig(**v["cfg"]))
        full = gather_views(local, dp_mesh)
        res["views"] = None if full is None else _np(full)

    if "fit" in inp:
        f = inp["fit"]
        dp_mesh = make_mesh(dp=world, sp=1, device="cpu")
        cfg = tpt.RenderConfig(**f["cfg"])
        splats = splats_from_numpy(f["splats"], "cpu")
        cams = camera_tensors(f["cameras"], "cpu")
        targets = torch.from_numpy(f["targets"])
        res["fit"] = {}
        for label, tgt, kw in (
            ("colors", targets, dict(fields=("cr", "cg", "cb"), steps=10,
                                     init=splats_from_numpy(f["init"], "cpu"))),
            ("sh", torch.from_numpy(f["targets_sh"]),
             dict(fields=(), steps=12, sh=sh_from_numpy(f["sh0"], "cpu"), fit_sh=True)),
        ):
            out = tfit.fit_splats_dp(splats, cams, tgt, dp_mesh, cfg, lr=5e-2,
                                     method=f["method"], **kw)
            entry = {"losses": _np(out[1]), "fitted": {k: _np(t) for k, t in out[0].items()}}
            if len(out) == 3:
                entry["sh"] = {c: _np(t) for c, t in out[2].items()}
            res["fit"][label] = entry
        res["fit_errors"] = {
            "views": _error(lambda: tfit.fit_splats_dp(
                splats, {k: t[:world + 1] for k, t in cams.items()}, targets[:world + 1],
                dp_mesh, cfg)),
            "fields": _error(lambda: tfit.fit_splats_dp(splats, cams, targets, dp_mesh, cfg,
                                                        fields=())),
            "sh": _error(lambda: tfit.fit_splats_dp(splats, cams, targets, dp_mesh, cfg,
                                                    fit_sh=True)),
        }

    if "single" in inp:
        res["single"] = _world_one(inp["single"])
    return res


def _frame_band_cut(splats, cams, mesh, rcfg, band_cfg):
    """This rank's band of its views as the frame's stream cuts it: every
    record binned on the frame, the band's runs taken out (`band_stream`)
    and blended by the same tile blend.  Also whether every record of the
    band's runs decodes on the band's grid to its frame position less the
    band's origin, bit for bit."""
    import torch

    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles
    from splat_renderer_tpu_torch.parallel.sharding import band_stream
    from splat_renderer_tpu_torch.render.binning import bin_packed_words
    from splat_renderer_tpu_torch.render.compositor import tiles_to_image
    from splat_renderer_tpu_torch.render.multiview import camera_at
    from splat_renderer_tpu_torch.render.packing import U32_MASK, unpack_words
    from splat_renderer_tpu_torch.render.projector import splat_screen_words

    vl = cams["view_proj"].shape[0] // mesh.dp
    y0 = mesh.sp_index * band_cfg.height
    out, exact = [], True
    for i in range(mesh.dp_index * vl, (mesh.dp_index + 1) * vl):
        cam = camera_at(cams, i)
        w = splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], rcfg)
        binned = bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], rcfg)
        stream = band_stream(binned, mesh.sp_index, rcfg, band_cfg)
        out.append(tiles_to_image(*blend_tiles(stream, band_cfg), band_cfg))
        used = stream["pair_rank"].long()
        geo = [unpack_words(*(b[k].long() & U32_MASK for k in ("rec_pos", "rec_ro", "rec_rgb")),
                            c)[:3] for b, c in ((binned, rcfg), (stream, band_cfg))]
        (fx, fy, fr), (bx, by, br) = [[t[used] for t in g] for g in geo]
        exact &= (torch.equal(bx, fx) and torch.equal(by, fy - y0) and torch.equal(br, fr))
    return torch.stack(out), exact


def _world_one(s: dict) -> dict:
    """World size 1: each parallel path against its single-device path."""
    import torch

    import splat_renderer_tpu_torch as tpt
    from splat_renderer_tpu_torch import fit as tfit
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.parallel import (
        band_frame_fn, make_mesh, multichip_frame_fn, rank_generator,
        render_views_data_parallel,
    )
    from splat_renderer_tpu_torch.render.binning import bin_splats, canonical_sort_data
    from splat_renderer_tpu_torch.render.compositor import render_tiles
    from splat_renderer_tpu_torch.render.multiview import camera_at
    from splat_renderer_tpu_torch.render.pipeline import model_points, render_splats

    mesh = make_mesh(device="cpu")
    scene = _scene()
    pcfg = tpt.PointConfig(descent_steps=3)
    rcfg = tpt.RenderConfig(**s["cfg"])
    splats = model_points(scene, scene.params("cpu"), rank_generator(s["seed"], 0, "cpu"),
                          s["n"], pcfg, rcfg, device="cpu")
    cams = camera_tensors(s["cameras"], "cpu")
    v = cams["view_proj"].shape[0]
    ref = [render_splats(splats, camera_at(cams, i), rcfg, device="cpu") for i in range(v)]
    out = {}
    img, stats = band_frame_fn(scene, mesh, splats["px"].shape[0], pcfg, rcfg).from_splats(
        splats, camera_at(cams, 0))
    out["band"] = torch.equal(img, ref[0]) and int(stats["routed_records"]) == 0
    views = multichip_frame_fn(scene, mesh, splats["px"].shape[0], pcfg, rcfg).from_splats(
        splats, cams)
    out["multichip"] = torch.equal(views, torch.stack(ref))
    data = torch.from_numpy(s["records"])
    loop = []
    for i in range(data.shape[0]):
        ds = canonical_sort_data(data[i])
        loop.append(render_tiles(ds, bin_splats(ds, rcfg), rcfg))
    out["views"] = torch.equal(render_views_data_parallel(data, mesh, rcfg), torch.stack(loop))
    targets = torch.stack(ref)
    init = {k: torch.full_like(splats[k], 0.5) for k in ("cr", "cg", "cb")}
    kw = dict(fields=("cr", "cg", "cb", "opacity"), steps=3, lr=5e-2, init=init)
    dp_fit, dp_losses = tfit.fit_splats_dp(splats, cams, targets, mesh, rcfg, **kw)
    one_fit, one_losses = tfit.fit_splats(splats, [camera_at(cams, i) for i in range(v)],
                                          list(targets), rcfg, **kw)
    out["fit"] = torch.equal(dp_losses, one_losses) and all(
        torch.equal(dp_fit[k], one_fit[k]) for k in one_fit)
    return out
