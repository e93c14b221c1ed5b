"""The reference's work counts against a brute-force count, and its
hand-written blend adjoint against autograd, on tiny streams."""

import json

import pytest
import torch

from gpubench import inputs, roofline
from gpubench.bench import HERE
from gpubench.reference import fit as ref_fit
from gpubench.reference import frame as ref
from gpubench.reference.camera import Camera
from gpubench.reference.config import PointConfig, RenderConfig
from gpubench.reference.render.blend import splat_alpha_planes
from gpubench.reference.render.packing import U32_MASK, unpack_words


def tiny_frame(seed=3, n=600, **render):
    cfg = RenderConfig(width=64, height=48, base_radius=0.06, tiles_per_splat_cap=4, **render)
    gen = torch.Generator().manual_seed(seed)
    demo = json.loads((HERE / "scenes" / "demo.json").read_text())
    splats = ref.model_splats(inputs.build(demo, inputs.reference_sdf()), gen, n, PointConfig(),
                              cfg)
    cam = {k: torch.as_tensor(v, dtype=torch.float32)
           for k, v in Camera(aspect=64 / 48).arrays().items()}
    return cfg, splats, cam


def brute_counts(binned, cfg, eps):
    """Per tile, per pixel, record after record: evaluations until the
    pixel's T <= eps (the record that brings it there included)."""
    u32 = lambda w: w.to(torch.int64) & U32_MASK  # noqa: E731
    cx, cy, r, op, _, _, _, ang, ratio = unpack_words(
        u32(binned["rec_pos"]), u32(binned["rec_ro"]), u32(binned["rec_rgb"]), cfg)
    off = binned["offsets"].tolist()
    evals = inside = pairs = 0
    read = set()
    for t in range(cfg.num_tiles):
        ranks = binned["pair_rank"][off[t]:off[t + 1]].tolist()
        alive_at = [0] * len(ranks)
        for p in range(cfg.tile_pixels):
            px = (t % cfg.tiles_x) * cfg.tile_w + p % cfg.tile_w + 0.5
            py = (t // cfg.tiles_x) * cfg.tile_h + p // cfg.tile_w + 0.5
            trans = 1.0
            for i, k in enumerate(ranks):
                if not trans > eps:
                    break
                a = float(splat_alpha_planes(cx[k], cy[k], r[k], op[k], ang[k], ratio[k],
                                             torch.tensor(px), torch.tensor(py), cfg))
                evals += 1
                alive_at[i] = 1
                if a > 0.0:
                    inside += 1
                    trans = float(torch.tensor(trans, dtype=torch.float32)
                                  * (1.0 - torch.tensor(a, dtype=torch.float32)))
        pairs += sum(alive_at)
        read |= {k for k, on in zip(ranks, alive_at) if on}
    return {"evals": evals, "inside": inside, "pairs": pairs, "records": len(read)}


@pytest.mark.parametrize("eps", [0.0, 0.01, 0.5])
def test_fold_counts_match_a_brute_force_count(eps):
    cfg, splats, cam = tiny_frame()
    _, binned = ref.words_and_bins(splats, cam, cfg)
    _, _, counts = ref.fold_blend(binned, cfg, eps=eps)
    want = brute_counts(binned, cfg, eps)
    assert {k: counts[k] for k in want} == want
    assert counts["evals"] > counts["inside"] > 0


def test_least_time_is_the_larger_bound():
    # operations bound: 1e9 evaluations, all inside
    t = roofline.least_seconds("tile_blend", 1e6, 10**9, 10**9)
    assert t == pytest.approx(max(18e9 / roofline.FP32_FLOP_S, 1e9 / roofline.SFU_OP_S))
    # bytes bound
    assert roofline.least_seconds("tile_blend", 3.35e12, 1, 1) == pytest.approx(1.0)
    assert roofline.share_percent(1.0, 4.0) == 25.0
    assert roofline.share_percent(1.0, 0.0) is None


def test_adjoint_matches_autograd_of_the_fold():
    cfg, splats, cam = tiny_frame(seed=5, n=400)
    sh = {c: 0.1 * torch.randn((15, 400), generator=torch.Generator().manual_seed(i))
          for i, c in enumerate("rgb")}
    with torch.no_grad():
        planes = ref_fit.planes_of(splats, sh, cam, cfg)
    binned = ref_fit.bin_planes_diff(planes, cfg)
    target = torch.rand((cfg.height, cfg.width, 3), generator=torch.Generator().manual_seed(9))
    loss_of = lambda img: ((img - target) ** 2).mean()  # noqa: E731
    _, _, grads, counts = ref_fit.render_and_grad(binned, cfg, loss_of)

    # the same fold, differentiated by autograd
    leaf = binned["planes"].detach().clone().requires_grad_(True)
    off = binned["offsets"].tolist()
    tp, tw = cfg.tile_pixels, cfg.tile_w
    colors, alphas = [], []
    for t in range(cfg.num_tiles):
        p = torch.arange(tp)
        px = ((t % cfg.tiles_x) * tw + p % tw).float() + 0.5
        py = ((t // cfg.tiles_x) * cfg.tile_h + p // tw).float() + 0.5
        c, trans = torch.zeros(tp, 3), torch.ones(tp)
        for k in binned["pair_rank"][off[t]:off[t + 1]].tolist():
            a = ref_fit._alpha(cfg, leaf[k:k + 1], px[None], py[None])["a"][0]
            c = c + leaf[k, 4:7][None] * (a * trans)[:, None]
            trans = trans * (1.0 - a)
        colors.append(c)
        alphas.append(1.0 - trans)
    img = ref_fit.tiles_to_image(torch.stack(colors), torch.stack(alphas), cfg)
    (want,) = torch.autograd.grad(loss_of(img), leaf)
    rel = ((grads - want).abs().amax(0) / (want.abs().amax(0) + 1e-12))[:7]
    assert float(rel.max()) < 1e-4
    assert counts["evals"] >= counts["inside"] > 0


@pytest.mark.parametrize("t", [0.0, 0.37, 2.5])
def test_the_demo_scene_file_is_the_programs_demo_scene(t):
    """The scene file and its animation give the program's own demo scene
    (`render.pipeline.demo_scene`, `animate_demo`) parameter for parameter."""
    from splat_renderer_tpu_torch.render.pipeline import animate_demo, demo_scene

    demo = json.loads((HERE / "scenes" / "demo.json").read_text())
    got = inputs.build(demo, inputs.program_sdf())
    inputs.animate(got, demo, t)
    want = demo_scene()
    animate_demo(want, t)
    nodes = [(type(n).__name__, n.params())
             for sc in (got, want) for n in sc.primitives() + sc.operations()]
    half = len(nodes) // 2
    assert len(nodes) == 2 * half and half == 5
    for (ta, pa), (tb, pb) in zip(nodes[:half], nodes[half:]):
        assert ta == tb and pa.keys() == pb.keys()
        for name in pa:
            assert torch.equal(torch.as_tensor(pa[name]), torch.as_tensor(pb[name])), (ta, name)
