"""Readings that set an opaque-quad frame cell's limits: the program's and
its planted faults'.

    python3 -m gpubench.surface_control --workload surface_1m_1080p --seeds 11 12 13 \
        [--program] [--faults]

`gpubench.control` reads the cell's control (the reference in bfloat16)
and the program; its planted early stop (T <= 0.05) reads 0 here, since
every alpha of an opaque quad is 1 and T falls to 0 at the first covering
record.  So the opaque fold's own faults are planted here, each under the
program's timed path (module attributes the program looks up at each
call), and read as the check reads the program:

- "ellipse_for_quad": the blend handed the opaque ellipse for the quads
  (K1's SHAPE 1 on the card, the twin's ellipse coverage on the CPU);
- "ellipse_footprint": the binner handed the ellipse's footprint and its
  corner prune for the quads (B1's ELLIPSE model);
- "farthest_wins": each tile's run reversed before the blend, so the
  farthest covering quad wins.

For each seed it draws the check's frames as a run of the cell would and
prints one JSON line: for the sound program (--program) and each fault
(--faults), the largest of each number the check compares over the
frames, and for each frame the reference's pairs and the pairs its fold
walks before every pixel of their tile has stopped.  A limit lies above
every sound reading of the program and below the control's and every
fault's.  This is not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import random
import sys
from typing import Dict, Iterator

import torch

from . import bench
from .drivers import frames
from .tracing import seed_of

PIPELINE = "splat_renderer_tpu_torch.render.pipeline"
BLEND = "splat_renderer_tpu_torch.ops.tile_blend"


def reversed_runs(binned: dict) -> dict:
    """`binned` with each tile's run of pair ranks in reverse order."""
    off = binned["offsets"].to(torch.int64)
    n = int(off[-1])
    tile = binned["pair_tile"][:n].to(torch.int64)
    src = off[tile] + off[tile + 1] - 1 - torch.arange(n, device=off.device)
    rank = binned["pair_rank"].clone()
    rank[:n] = binned["pair_rank"][src]
    return dict(binned, pair_rank=rank)


def _ellipse_for_quad(blend_tiles):
    def planted(binned, cfg, *a, **k):
        return blend_tiles(binned, cfg.replace(quad=False), *a, **k)
    return planted


def _ellipse_footprint(bin_packed_words):
    def planted(dk, w_pos, w_ro, w_rgb, cfg, *a, **k):
        return bin_packed_words(dk, w_pos, w_ro, w_rgb, cfg.replace(quad=False), *a, **k)
    return planted


def _farthest_wins(blend_tiles):
    def planted(binned, *a, **k):
        return blend_tiles(reversed_runs(binned), *a, **k)
    return planted


# fault -> (program module, attribute, the attribute's replacement from the original)
FAULTS = {
    "ellipse_for_quad": (BLEND, "blend_tiles", _ellipse_for_quad),
    "ellipse_footprint": (PIPELINE, "bin_packed_words", _ellipse_footprint),
    "farthest_wins": (BLEND, "blend_tiles", _farthest_wins),
}


@contextlib.contextmanager
def planted(fault: str) -> Iterator[None]:
    """The program with `fault` planted under its timed path, for the
    block."""
    module, attr, make = FAULTS[fault]
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def program_frames(config: dict, traffic: dict, seed: int, device, check_at) -> Dict[int, dict]:
    """The program's checked frames, each rendered by the cell's engine and
    captured at the program's entries."""
    st = frames.Setup(config, traffic, seed, device)
    spans = frames.Spans(device, timed=False)
    for name, target in frames.CAPTURE.items():
        spans.wrap(target, name)
    spans.capturing = True
    try:
        return {fi: frames.program_frame(spans, st.frame(fi)) for fi in check_at}
    finally:
        spans.restore()


def readings(workload: str, seed: int, device, program: bool, faults: bool = False,
             root=bench.ROOT) -> dict:
    spec = bench.load_spec(root)
    config, traffic = bench.cell_parts(spec, workload, root / "gpubench")
    rng = random.Random(seed_of(seed, 0xC4EC))
    check_at = sorted(rng.sample(range(traffic["check_range"]), traffic["check_frames"]))
    got = {}
    if program:
        got["program"] = program_frames(config, traffic, seed, device, check_at)
    for fault in (FAULTS if faults else ()):
        with planted(fault):
            got[fault] = program_frames(config, traffic, seed, device, check_at)
    out = {"seed": seed, "frames": check_at, "pairs": {}, "walked": {}}
    keys = ("splats", "words", "binned", "image")
    for fi in check_at:
        ref = frames.reference_frame(config, traffic, seed, fi, device)
        want = dict(zip(keys, ref[:4]))
        out["pairs"][str(fi)] = int(want["binned"]["offsets"][-1])
        out["walked"][str(fi)] = ref[4]["pairs"]
        for key, by_frame in got.items():
            for k, v in frames.gaps(config, by_frame[fi], want).items():
                out.setdefault(key, {})[k] = max(out.get(key, {}).get(k, 0.0), v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench.surface_control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--faults", action="store_true",
                   help="the readings of each opaque fault planted under the timed path")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.surface_control: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for s in a.seeds:
        print(json.dumps(readings(a.workload, s, dev, a.program, a.faults)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
