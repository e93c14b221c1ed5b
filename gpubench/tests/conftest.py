"""Shared fixtures of the benchmark's CPU tests: a tiny copy of the
benchmark's data files, so a whole cell runs on the CPU in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def tiny_tree(dst: Path) -> Path:
    """A root holding BENCHMARK.json and
    gpubench/{configs,scenes,traffic,drivers,metrics} with every
    configuration cut to 3,000 splats at 96x64 (radius grown so the splats
    cover pixels) and the blend's early stop at eps 0, where the
    CPU twin's chunked stop and the kernels' per-pixel stop agree, and
    every traffic mix checking and tracing its first few frames or steps."""
    (dst / "gpubench").mkdir(parents=True)
    for d in ("configs", "scenes", "traffic", "drivers", "metrics"):
        shutil.copytree(ROOT / "gpubench" / d, dst / "gpubench" / d)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        p = dst / c["file"]
        cfg = json.loads(p.read_text())
        cfg["n"] = 3000
        cfg["render"].update(width=96, height=64, base_radius=0.06, transmittance_eps=0.0)
        p.write_text(json.dumps(cfg))
    for p in (dst / "gpubench" / "traffic").glob("*.json"):
        tr = json.loads(p.read_text())
        if tr["kind"] == "frames":
            tr.update(warmup_frames=1, check_range=4, trace_frames=3)
        else:
            tr.update(warmup_steps=1, trace_steps=2)
        p.write_text(json.dumps(tr))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_tree(tmp_path / "tree")


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
