"""No run of the benchmark loads JAX or the JAX package, and the reference
loads nothing of the program: checked in fresh interpreters, comparing
each module's top-level name (before the first dot) whole."""

import json
import subprocess
import sys

from gpubench.bench import FORBIDDEN, forbidden_modules
from gpubench.tests.conftest import ROOT

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_after(imports: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cells_modules_load_neither_jax_nor_the_jax_package():
    names = top_level_after(
        "import gpubench.run, gpubench.bench, gpubench.drivers.frames, gpubench.drivers.fit, "
        "gpubench.control\n"
        "import splat_renderer_tpu_torch, splat_renderer_tpu_torch.fit, "
        "splat_renderer_tpu_torch.render.pipeline, splat_renderer_tpu_torch.ops.tile_blend, "
        "splat_renderer_tpu_torch.ops.tile_blend_diff\n"
        "from gpubench import bench\n"
        "for m in bench.load_spec()['per_layer']: bench.load_reader(m['name'])")
    assert "splat_renderer_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_after(
        "import gpubench.reference.frame, gpubench.reference.fit, gpubench.reference.camera")
    assert not names & ({"splat_renderer_tpu_torch"} | set(FORBIDDEN))


def test_the_check_compares_whole_top_level_names():
    assert forbidden_modules(["splat_renderer_tpu_torch.fit", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["splat_renderer_tpu.render", "jax.numpy"]) == [
        "jax", "splat_renderer_tpu"]
