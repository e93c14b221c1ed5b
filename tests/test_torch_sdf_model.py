"""The modeler's CUDA kernels (`ops/sdf_model.py`, csrc/sdf_model.cu) and
the CSG tree as a program (`sdf/program.py`), against the plain path.

The `gpu` tests hold the kernels' splat planes bit-equal to the plain
path's on the card (the demo scene at 1M points, the surface preset's
planes, random trees over all 13 node kinds, points on box edges and
faces, at a sphere's centre and on smooth-union seams, trees deeper than
the stack holds in walk order), one launch each a frame and no read-back,
and read off the card how torch's reductions associate where the plain
path reduces; they skip where torch sees no CUDA device.  The rest run on
the CPU in seconds: the program and the packed parameter block against the
tree's walk, every node kind; the program run in plain torch against the
tree; the stack it needs; the trees the kernels do not take, which raise
on a CUDA device; the dispatch; the constants the kernels share with the
Python side.  The file imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_sdf_model.py
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from splat_renderer_tpu_torch import PointConfig, RenderConfig
from splat_renderer_tpu_torch.config import surface_render_config
from splat_renderer_tpu_torch.ops import sdf_model
from splat_renderer_tpu_torch.ops.build import launches
from splat_renderer_tpu_torch.points import derive_splats, seed_scene_points
from splat_renderer_tpu_torch.render import pipeline
from splat_renderer_tpu_torch.render.pipeline import (
    demo_scene, model_points, modeler_program, surface_splats,
)
from splat_renderer_tpu_torch.sdf import (
    Box, Capsule, Cylinder, Ellipsoid, RoundBox, SDFScene, Sphere, Torus, intersection,
    smooth_intersection, smooth_subtraction, smooth_union, subtraction, union,
)
from splat_renderer_tpu_torch.sdf import program as program_module
from splat_renderer_tpu_torch.sdf.program import (
    CODES, OPERATIONS, PRIMITIVES, STACK_LIMIT, SWAPPED, flatten, pack_params, program_for,
)
from splat_renderer_tpu_torch.sdf.scene import OpNode
from splat_renderer_tpu_torch.utils import profiling

CSRC = Path(sdf_model.__file__).resolve().parent.parent / "csrc" / "sdf_model.cu"


def _prim(kind: str, i: int, rng):
    pos = rng.uniform(-0.4, 0.4, 3)
    make = {
        "sphere": lambda: Sphere(f"p{i}", pos, radius=rng.uniform(0.2, 0.5)),
        "box": lambda: Box(f"p{i}", pos, size=rng.uniform(0.1, 0.4, 3)),
        "torus": lambda: Torus(f"p{i}", pos, major_radius=rng.uniform(0.3, 0.5),
                               minor_radius=rng.uniform(0.05, 0.2)),
        "capsule": lambda: Capsule(f"p{i}", pos, height=rng.uniform(0.2, 0.8),
                                   radius=rng.uniform(0.1, 0.3)),
        "cylinder": lambda: Cylinder(f"p{i}", pos, height=rng.uniform(0.2, 0.8),
                                     radius=rng.uniform(0.1, 0.3)),
        "ellipsoid": lambda: Ellipsoid(f"p{i}", pos, radii=rng.uniform(0.15, 0.5, 3)),
        "round_box": lambda: RoundBox(f"p{i}", pos, size=rng.uniform(0.15, 0.4, 3),
                                      rounding=rng.uniform(0.02, 0.1)),
    }
    return make[kind]()


PRIM_KINDS = ("sphere", "box", "torus", "capsule", "cylinder", "ellipsoid", "round_box")
OPS = {"union": union, "intersection": intersection, "subtraction": subtraction,
       "smooth_union": smooth_union, "smooth_intersection": smooth_intersection,
       "smooth_subtraction": smooth_subtraction}
KINDS = PRIM_KINDS + tuple(OPS)
PRIMITIVE_CODES = {CODES[cls] for cls in PRIMITIVES}


def _op(kind: str, a, b, rng):
    if kind.startswith("smooth"):
        return OPS[kind](float(rng.uniform(0.02, 0.15)), a, b)
    return OPS[kind](a, b)


def _tree_with(kind: str, seed: int = 0) -> SDFScene:
    """A three-level tree holding node kind `kind`, the others drawn."""
    rng = np.random.default_rng(seed)
    prims = [_prim(kind if kind in PRIM_KINDS and j == 1 else str(rng.choice(PRIM_KINDS)), j,
                   rng) for j in range(4)]
    top = kind if kind in OPS else str(rng.choice(list(OPS)))
    left = _op(str(rng.choice(list(OPS))), prims[0], prims[1], rng)
    right = _op(str(rng.choice(list(OPS))), prims[2], prims[3], rng)
    return SDFScene(_op(top, left, right, rng))


def _random_tree(rng, depth: int, counter) -> object:
    if depth == 0 or rng.random() < 0.3:
        counter[0] += 1
        return _prim(str(rng.choice(PRIM_KINDS)), counter[0], rng)
    a, b = _random_tree(rng, depth - 1, counter), _random_tree(rng, depth - 1, counter)
    return _op(str(rng.choice(list(OPS))), a, b, rng)


def _walk(node, out):
    """The tree's postfix walk, as `SDFScene.sdf` evaluates it: (class,
    node id or None)."""
    if isinstance(node, OpNode):
        _walk(node.children[0], out)
        _walk(node.children[1], out)
        out.append((type(node.operation), getattr(node.operation, "id", None)))
    else:
        out.append((type(node), node.id))
    return out


def _chain(depth: int) -> SDFScene:
    """A right-deep chain of `depth` spheres under unions: evaluated left
    first it would need a stack `depth` deep."""
    node = Sphere(f"c{depth}", (0.0, 0.0, 0.0), radius=0.1)
    for j in range(depth - 1, 0, -1):
        node = union(Sphere(f"c{j}", (0.1 * j, 0.0, 0.0), radius=0.1), node)
    return SDFScene(node)


def _balanced(k: int) -> SDFScene:
    """A balanced tree of 2**k spheres under unions: it needs k + 1 slots."""
    nodes = [Sphere(f"b{j}", (0.1 * j, 0.0, 0.0), radius=0.1) for j in range(2 ** k)]
    while len(nodes) > 1:
        nodes = [union(a, b) for a, b in zip(nodes[::2], nodes[1::2])]
    return SDFScene(nodes[0])


def _skewed_with(kind: str, seed: int = 0) -> SDFScene:
    """A right-deep chain of five primitives under a left-deep top, holding
    node kind `kind`, the others drawn: its operations come swapped and
    not."""
    rng = np.random.default_rng(seed)
    prims = [_prim(kind if kind in PRIM_KINDS and j == 2 else str(rng.choice(PRIM_KINDS)), j,
                   rng) for j in range(6)]
    node = prims[4]
    for j in range(3, -1, -1):
        op = kind if kind in OPS and j == 0 else str(rng.choice(list(OPS)))
        node = _op(op, prims[j], node, rng)
    return SDFScene(_op(str(rng.choice(list(OPS))), node, prims[5], rng))


def _run(program, scene, params, p):
    """The program run in plain torch the way the kernels walk it: the
    parameters read back out of the packed block, a swapped operation's
    operands handed back in the tree's order."""
    block = pack_params(program, params)
    nodes = {getattr(node, "id", None): node for node in scene.primitives() + scene.operations()}
    owner, blk, at = {}, {}, 0
    for node_id, key, width in program.layout:
        owner.setdefault(node_id, at)
        blk.setdefault(node_id, {})[key] = block[at:at + width].reshape(
            params[node_id][key].shape)
        at += width
    by_offset = {at: node_id for node_id, at in owner.items()}
    classes = {code: cls for cls, code in CODES.items()}
    stack = []
    for code, at in program.code:
        cls = classes[code & ~SWAPPED]
        if cls in PRIMITIVES:
            node_id = by_offset[at]
            stack.append(nodes[node_id].sdg(p - blk[node_id]["center"], blk[node_id]))
            continue
        top, below = stack.pop(), stack.pop()
        a, b = (top, below) if code & SWAPPED else (below, top)
        op = nodes[by_offset[at]] if OPERATIONS[cls] else cls()
        stack.append(op.apply(a, b, blk[op.id] if OPERATIONS[cls] else {}))
    assert len(stack) == 1
    return stack[0]


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the modeler's kernels run only on the card")
    return torch.device("cuda")


# ---- CPU ----

@pytest.mark.parametrize("kind", KINDS)
def test_program_and_block_match_the_walk(kind):
    """The program is the tree's postfix walk, each node's code its class's
    and its offset the start of its own parameters in the block; the block
    holds every node's parameters in the program's order, each once."""
    scene = _tree_with(kind)
    params = scene.params("cpu")
    program = flatten(scene)
    walk = _walk(scene._root, [])
    assert [c for c, _ in program.code] == [CODES[cls] for cls, _ in walk]
    assert kind in {cls.kind for cls, _ in walk}
    block = pack_params(program, params)
    assert block.dtype == torch.float32 and block.shape == (program.size,)
    expected, seen = [], set()
    for (cls, node_id), (_, at) in zip(walk, program.code):
        keys = {**PRIMITIVES, **OPERATIONS}[cls]
        if not keys:
            continue
        values = torch.cat([params[node_id][k].reshape(-1) for k in keys])
        assert torch.equal(block[at:at + values.numel()], values), (cls.kind, node_id)
        if node_id not in seen:
            seen.add(node_id)
            expected.append(values)
    assert torch.equal(block, torch.cat(expected))
    first = {}
    for (cls, node_id), pair in zip(walk, program.code):
        first.setdefault(node_id, pair)
    assert list(program.bounds) == [first[p.id] for p in scene.primitives()]


def test_a_shared_node_is_packed_once():
    """A primitive that appears twice reads one run of the block."""
    s = Sphere("s", (0.1, 0.0, 0.0), radius=0.3)
    scene = SDFScene(smooth_union(0.1, s, union(Box("b", size=(0.2, 0.2, 0.2)), s)))
    program = flatten(scene)
    assert [at for code, at in program.code if code == CODES[Sphere]] == [0, 0]
    assert program.size == 4 + 6 + 1
    assert [row[:2] for row in program.layout] == [
        ("s", "center"), ("s", "radius"), ("b", "center"), ("b", "size"),
        (scene.operations()[0].id, "k")]


def test_stack_depth_and_the_limit(monkeypatch):
    """Of two subtrees the deeper comes first: a right-deep chain needs 2
    slots however long (each union but the innermost swapped), a balanced tree of 2**k leaves k + 1; a tree
    needing more than STACK_LIMIT does not flatten."""
    for n in (STACK_LIMIT, STACK_LIMIT + 1, 40):
        program = flatten(_chain(n))
        assert program.depth == 2
        ops = [c for c, _ in program.code if c & ~SWAPPED not in PRIMITIVE_CODES]
        assert [bool(c & SWAPPED) for c in ops] == [False] + [True] * (n - 2)
    for k in range(5):
        assert flatten(_balanced(k)).depth == k + 1
    assert flatten(demo_scene()).depth == 2
    monkeypatch.setattr(program_module, "STACK_LIMIT", 3)
    assert flatten(_balanced(2)).depth == 3
    assert flatten(_balanced(3)) is None


@pytest.mark.parametrize("kind", KINDS)
def test_the_program_runs_as_the_tree(kind):
    """Run in plain torch as the kernels walk it, the program gives the
    tree's distance and gradient bit for bit, on a tree whose operations
    come swapped and not, and on the balanced one."""
    for scene in (_skewed_with(kind, 3), _tree_with(kind, 4)):
        program = flatten(scene)
        assert kind in {cls.kind for cls in CODES if CODES[cls] in
                        {c & ~SWAPPED for c, _ in program.code}}
        params = scene.params("cpu")
        p = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (256, 3))
                             .astype(np.float32))
        got, want = _run(program, scene, params, p), scene.sdf(p, params)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    swapped = [c for c, _ in flatten(_skewed_with(kind, 3)).code if c & SWAPPED]
    assert len(swapped) == 3  # the chain's but its innermost


class _Ball(Sphere):
    pass


def _untaken(case: str, monkeypatch) -> SDFScene:
    if case == "empty":
        return SDFScene()
    if case == "subclass":
        return SDFScene(union(Sphere("a"), _Ball("b")))
    if case == "one_child":
        return SDFScene(OpNode(union(Sphere("a"), Sphere("b")).operation, [Sphere("a")]))
    monkeypatch.setattr(program_module, "STACK_LIMIT", 3)
    return _balanced(3)


UNTAKEN = ["empty", "subclass", "one_child", "deep"]


@pytest.mark.parametrize("case", UNTAKEN)
def test_trees_the_kernels_do_not_take(case, monkeypatch):
    """No program for an empty scene, a class the table does not name, an
    operation short of two children or a tree beyond the stack limit."""
    assert flatten(_untaken(case, monkeypatch)) is None


@pytest.mark.parametrize("case", UNTAKEN)
def test_on_cuda_a_tree_the_kernels_do_not_take_raises(case, monkeypatch):
    """On a CUDA device the kernels take the call or it raises; on the CPU
    the plain path takes it."""
    scene = _untaken(case, monkeypatch)
    with pytest.raises(ValueError, match="the modeler's kernels cannot evaluate this scene"):
        modeler_program(scene, "cuda")
    assert modeler_program(scene, "cpu") is None
    assert modeler_program(demo_scene(), "cuda") is not None


@pytest.mark.parametrize("case", ["float64_points", "float64_params", "grad_points",
                                  "grad_params"])
def test_the_descent_rejects_other_dtypes_and_gradients(case):
    """The kernels take float32 and carry no gradient: points or parameters
    of another dtype are refused by name, and one that requires a gradient
    is refused while grad mode is on (under no_grad only the CPU device is
    left to refuse)."""
    scene = demo_scene()
    params = scene.params("cpu")
    pts = torch.zeros(4, 3)
    if case == "float64_points":
        pts = pts.double()
    elif case == "float64_params":
        params["box1"]["size"] = params["box1"]["size"].double()
    elif case == "grad_points":
        pts.requires_grad_(True)
    else:
        params["sphere2"]["radius"].requires_grad_(True)
    program = flatten(scene)
    block = pack_params(program, params)
    match = {"float64_points": "pts must be", "float64_params": "params block must be"}
    with pytest.raises(ValueError, match=match.get(case, "carry no gradient")):
        sdf_model.descend(program, block, PointConfig(), pts=pts)
    if case.startswith("grad"):
        with torch.no_grad(), pytest.raises(ValueError, match="no modeler kernel for device"):
            sdf_model.descend(program, block, PointConfig(), pts=pts)


def test_the_cache_follows_the_operations_ids():
    """Two scenes of one structure hash whose operations carry other ids
    get programs that name their own ids."""
    a, b = demo_scene(), demo_scene()
    assert a.structure_hash() == b.structure_hash()
    ids = lambda p: [row[0] for row in p.layout if row[1] == "k"]  # noqa: E731
    assert ids(program_for(a)) == [op.id for op in reversed(a.operations())]
    assert ids(program_for(b)) == [op.id for op in reversed(b.operations())]
    assert program_for(a) is program_for(a)


def test_the_cache_follows_the_node_classes():
    """A subclassed primitive shares its base's kind, so its scene has the
    structure hash of one without it; the cache still hands it no program."""
    plain = SDFScene(union(Sphere("a"), Sphere("b")))
    sub = SDFScene(union(Sphere("a"), _Ball("b")))
    assert plain.structure_hash() == sub.structure_hash()
    assert program_for(plain) is not None
    assert program_for(sub) is None


def test_pack_rejects_a_parameter_of_another_width():
    scene = demo_scene()
    params = scene.params("cpu")
    params["sphere1"]["radius"] = torch.ones(3)
    with pytest.raises(ValueError, match=r"params\['sphere1'\]\['radius'\] has 3 values"):
        pack_params(flatten(scene), params)


def test_constants_shared_with_the_kernels():
    """The csrc Code enum lists the program's classes in CODES' order,
    kStack is STACK_LIMIT, kSwapped is SWAPPED, the rows are derive_splats' keys in order, and
    the probe's scalars are the plain path's as the card rounds them."""
    src = CSRC.read_text()
    enum = re.search(r"enum Code \{([^}]*)\}", src).group(1)
    names = [w.strip() for w in enum.replace("\n", " ").split(",") if w.strip()]
    kinds = [re.sub(r"(?<!^)(?=[A-Z])", "_", n[1:]).lower() for n in names]
    assert kinds == [cls.kind for cls in CODES]
    assert int(re.search(r"constexpr int kStack = (\d+);", src).group(1)) == STACK_LIMIT
    assert int(re.search(r"constexpr int kSwapped = 1 << (\d+);", src).group(1)) == \
        SWAPPED.bit_length() - 1
    pts, nrm, sc = torch.zeros(2, 3), torch.ones(2, 3), torch.ones(2)
    assert tuple(derive_splats(pts, nrm, sc, RenderConfig())) == sdf_model.PLANES
    s = list(sdf_model.probe_scalars(1_000_000, PointConfig(), surface_render_config()))
    f32 = np.float32
    assert s == [float(v) for v in (f32(0.02), f32(1.0) / f32(6.0), f32(2.0), f32(0.01),
                                    f32(0.99), f32(0.025), f32(1.0))]


def test_kernel_path_hands_the_kernels_seed_points_draws(monkeypatch):
    """Where a program is found, model_points draws seed_points' uniforms
    from the generator in its order, packs the block and hands both to
    the descent, then the probe; the spans are model/seed, model/descent
    and model/curvature.  (Fake kernels on the CPU.)"""
    calls = []

    def fake_descend(program, block, pcfg, **start):
        calls.append(("descend", program, block, start))
        return torch.zeros(11, start["uniforms"][0].shape[0])

    def fake_probe(program, block, out, pcfg, rcfg):
        calls.append(("probe", program, block, out))
        return dict(zip(sdf_model.PLANES, out.unbind(0)))

    scene = demo_scene()
    monkeypatch.setattr(pipeline, "modeler_program", lambda s, d: flatten(s))
    monkeypatch.setattr(pipeline, "descend", fake_descend)
    monkeypatch.setattr(pipeline, "probe", fake_probe)
    params = scene.params("cpu")
    with profiling.recording() as rec:
        splats = model_points(scene, params, torch.Generator().manual_seed(5), 300,
                              PointConfig(), RenderConfig(), device="cpu")
    assert [c[0] for c in calls] == ["descend", "probe"]
    g = torch.Generator().manual_seed(5)
    uf, uv = calls[0][3]["uniforms"]
    assert torch.equal(uf, torch.rand(300, generator=g))
    assert torch.equal(uv, torch.rand((300, 2), generator=g))
    assert torch.equal(calls[0][2], pack_params(flatten(scene), params))
    assert calls[1][2] is calls[0][2] and tuple(splats) == sdf_model.PLANES
    assert set(rec.report()) == {"model", "model/seed", "model/descent", "model/curvature"}


def test_wrappers_reject_what_the_kernels_cannot_take():
    """Checked before any library loads: a block of another length or
    dtype, a CPU block, both or neither start."""
    scene = demo_scene()
    program = flatten(scene)
    block = pack_params(program, scene.params("cpu"))
    pcfg = PointConfig()
    with pytest.raises(ValueError, match="params block"):
        sdf_model.descend(program, block[:-1], pcfg, pts=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="params block"):
        sdf_model.descend(program, block.double(), pcfg, pts=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="no modeler kernel for device cpu"):
        sdf_model.descend(program, block, pcfg, pts=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="no modeler kernel"):
        sdf_model.probe(program, block, torch.zeros(11, 4), pcfg, RenderConfig())


# ---- on the card ----

def _bit_equal(got, want):
    """Every plane equal bit for bit (NaN where the other has NaN)."""
    assert list(got) == list(want)
    for k in want:
        a, b = got[k].cpu(), want[k].cpu()
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, k
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b)), f"{k}: NaN elsewhere"
        differ = int((a.view(torch.int32) != b.view(torch.int32))[~nan].sum())
        assert differ == 0, f"{k}: {differ} of {a.numel()} differ"


def _plain_model(scene, params, seed, n, pcfg, rcfg, device):
    g = torch.Generator(device=device).manual_seed(seed)
    pts = seed_scene_points(g, scene, params, n, pcfg)
    return pipeline._plain_splats(scene, params, pts, pcfg, rcfg)


def _kernel_model(scene, params, seed, n, pcfg, rcfg, device):
    g = torch.Generator(device=device).manual_seed(seed)
    before = launches["sdf_descent"], launches["sdf_probe"]
    got = model_points(scene, params, g, n, pcfg, rcfg, device=device)
    assert (launches["sdf_descent"], launches["sdf_probe"]) == (before[0] + 1, before[1] + 1)
    return got


def _rand(shape, rng):
    return (rng.uniform(0.5, 1.0, shape) * np.exp2(rng.integers(-6, 6, shape))
            * rng.choice([-1.0, 1.0], shape)).astype(np.float32)


def _trees(x, n):
    """Every association of a sum over x's last n columns' values."""
    def assoc(leaves):
        if len(leaves) == 1:
            yield leaves[0]
            return
        first, rest = leaves[0], leaves[1:]
        for r in range(len(rest)):
            for left in itertools.combinations(rest, r):
                right = tuple(v for v in rest if v not in left)
                for lt in assoc((first,) + left):
                    for rt in assoc(right):
                        yield (lt, rt)

    def ev(t):
        return x[..., t] if isinstance(t, int) else (ev(t[0]) + ev(t[1])).astype(np.float32)

    return {str(t): ev(t) for t in assoc(tuple(range(n)))}


def _matching(cands, want):
    return sorted(k for k, v in cands.items() if np.array_equal(v.view(np.int32),
                                                                 want.view(np.int32)))


@pytest.mark.gpu
def test_reduction_orders_on_the_card(cuda):
    """How torch associates on the card where the plain path reduces, as
    csrc/sdf_model.cu's header states: the sum over a 3-wide last dim
    (N, 3), (6, N, 3) and (7, N, 3); vector_norm over it; the mean over 6
    rows and its factor; the sum and cumsum of a 6-vector; a Python-scalar
    divisor as a multiply by the float32 reciprocal."""
    rng = np.random.default_rng(11)
    for shape in [(100_000, 3), (6, 50_000, 3), (7, 50_000, 3)]:
        x = _rand(shape, rng)
        want = torch.sum(torch.from_numpy(x).to(cuda), dim=-1).cpu().numpy()
        assert _matching(_trees(x, 3), want) == ["((0, 2), 1)"], shape
        sq = (x * x).astype(np.float32)
        norm = torch.linalg.vector_norm(torch.from_numpy(x).to(cuda), dim=-1,
                                        keepdim=len(shape) == 3).cpu().numpy()
        mine = np.sqrt(((sq[..., 0] + sq[..., 2]).astype(np.float32) + sq[..., 1])
                       .astype(np.float32).astype(np.float64)).astype(np.float32)
        assert np.array_equal(norm.reshape(mine.shape).view(np.int32), mine.view(np.int32))
    for n in (1000, 1_000_000):
        x = _rand((6, n), rng)
        want = torch.mean(torch.from_numpy(x).to(cuda), dim=0).cpu().numpy()
        factor = np.float32(n) / np.float32(6 * n)
        cands = {k: (v * factor).astype(np.float32)
                 for k, v in _trees(np.moveaxis(x, 0, -1), 6).items()}
        assert _matching(cands, want) == ["((((0, 4), (1, 5)), 2), 3)"], n
    xs = np.abs(_rand((2000, 6), rng))
    sums = torch.stack([torch.sum(torch.from_numpy(r).to(cuda)) for r in xs]).cpu().numpy()
    cums = torch.stack([torch.cumsum(torch.from_numpy(r).to(cuda), 0) for r in xs]).cpu().numpy()
    assert _matching(_trees(xs, 6), sums) == ["(((0, 4), 2), ((1, 5), 3))"]
    run = xs[:, 0]
    for k in range(1, 6):
        run = (run + xs[:, k]).astype(np.float32)
        assert np.array_equal(cums[:, k].view(np.int32), run.view(np.int32)), k
    x = _rand((100_000,), rng)
    got = (torch.from_numpy(x).to(cuda) / 0.3).cpu().numpy()
    want = (x * (np.float32(1.0) / np.float32(0.3))).astype(np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("rcfg", [RenderConfig(base_radius=0.008), surface_render_config()],
                         ids=["gaussian", "surface"])
def test_demo_scene_bit_equal_at_1m(cuda, rcfg):
    """The demo scene at 1M points, animated: the two launches' planes are
    the plain path's bit for bit, in the benchmark's Gaussian and surface
    configurations."""
    scene, pcfg = demo_scene(), PointConfig()
    for t, seed in ((0.0, 1), (1.3, 2)):
        pipeline.animate_demo(scene, t)
        params = scene.params(cuda)
        _bit_equal(_kernel_model(scene, params, seed, 1_000_000, pcfg, rcfg, cuda),
                   _plain_model(scene, params, seed, 1_000_000, pcfg, rcfg, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(12))
def test_random_trees_bit_equal(cuda, seed):
    """Random trees over every primitive and operation kind, each kind in
    a tree of its own and in drawn ones, both colour modes."""
    rng = np.random.default_rng(seed)
    scenes = [_tree_with(KINDS[seed], seed), _tree_with(KINDS[seed + 1], seed + 100),
              SDFScene(_random_tree(rng, 4, [0]))]
    pcfg = PointConfig(descent_steps=int(rng.integers(1, 8)))
    for j, scene in enumerate(scenes):
        rcfg = surface_render_config() if j % 2 else RenderConfig()
        params = scene.params(cuda)
        _bit_equal(_kernel_model(scene, params, seed, 50_000, pcfg, rcfg, cuda),
                   _plain_model(scene, params, seed, 50_000, pcfg, rcfg, cuda))


def _special_points(cuda):
    """Points on a box's edges and faces and at its corners, at the
    spheres' centres (the length clamps), on the smooth union's seams and
    far off."""
    rng = np.random.default_rng(4)
    box_c, half = np.array([0.6, 0.0, 0.0]), np.array([0.3, 0.3, 0.3])
    pts = []
    for signs in itertools.product((-1.0, 0.0, 1.0), repeat=3):
        for _ in range(40):
            u = rng.uniform(-1, 1, 3)
            p = np.where(np.array(signs) != 0, np.array(signs), u)
            pts.append(box_c + half * p)
    pts += [np.zeros(3), np.array([0.0, 0.6, 0.0]), box_c]
    for t in np.linspace(-1.0, 1.0, 400):  # the seams: between the sphere and the box
        pts.append(np.array([0.3 + 0.05 * t, 0.4 * t, 0.1 * t]))
        pts.append(np.array([0.1 * t, 0.35 + 0.05 * t, 0.2 * t]))
    pts += list(rng.uniform(-3, 3, (200, 3)))
    return torch.tensor(np.array(pts), dtype=torch.float32, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [0, 1, 5])
def test_special_points_bit_equal(cuda, steps):
    """surface_splats from the points it is handed (a strided view too):
    box edges, faces and corners, the spheres' centres, the seams."""
    scene, pcfg = demo_scene(), PointConfig(descent_steps=steps)
    params = scene.params(cuda)
    pts = _special_points(cuda)
    strided = torch.cat([pts, pts[:, :1]], dim=1)[:, :3]
    for p in (pts, strided):
        for rcfg in (RenderConfig(), surface_render_config()):
            before = launches["sdf_descent"]
            got = surface_splats(scene, params, p, pcfg, rcfg)
            assert launches["sdf_descent"] == before + 1
            _bit_equal(got, pipeline._plain_splats(scene, params, p, pcfg, rcfg))


@pytest.mark.gpu
def test_deep_trees_bit_equal(cuda):
    """Trees deeper than the stack taken in walk order: a right-deep chain
    of 40 and skewed trees of every operation kind, their operations
    swapped, one launch of each kernel."""
    scenes = [_chain(40)] + [_skewed_with(kind, 7) for kind in OPS]
    for j, scene in enumerate(scenes):
        params = scene.params(cuda)
        _bit_equal(_kernel_model(scene, params, j, 20_000, PointConfig(), RenderConfig(), cuda),
                   _plain_model(scene, params, j, 20_000, PointConfig(), RenderConfig(), cuda))


@pytest.mark.gpu
def test_no_host_read_back(cuda):
    """A frame's modeler synchronises nothing with the host: CUDA's sync
    debug mode set to "error" lets it through."""
    scene, pcfg, rcfg = demo_scene(), PointConfig(), RenderConfig()
    params = scene.params(cuda)
    _kernel_model(scene, params, 0, 5000, pcfg, rcfg, cuda)  # built and loaded outside
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _kernel_model(scene, params, 1, 5000, pcfg, rcfg, cuda)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    _bit_equal(got, _plain_model(scene, params, 1, 5000, pcfg, rcfg, cuda))
