"""Run one cell of `BENCHMARK.json` once and print its result line.

The harness is driven by data.  A cell names a configuration and a traffic
mix; `configs/<config>.json` holds the configuration's sizes and the limits
of its checks, and names its scene, `scenes/<scene>.json`;
`traffic/<mix>.json` holds the mix's parameters, and its `kind` names the
driver that reads them, `drivers/<kind>.py` (`frames`: a render loop;
`fit`: an optimiser loop).  Each per-layer metric is a reader of its own in
`metrics/<metric>.py`.  A new configuration, scene, mix, driver or metric
is a new file (and a new `BENCHMARK.json` entry); no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level module names that no run of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "splat_renderer_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"gpubench: no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(spec: dict, workload: str, here: Path = HERE):
    """(configuration file, traffic file) of a cell, each as a dict; a
    configuration's `scene` names a scene file, which replaces the name."""
    cell = find(spec["workloads"], workload, "workload")
    conf = find(spec["configs"], cell["config"], "config")
    config = load_json(here.parent / conf["file"])
    if isinstance(config.get("scene"), str):
        config["scene"] = load_json(here / "scenes" / f"{config['scene']}.json")
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json")
    return config, traffic


def load_driver(kind: str, here: Path = HERE):
    """The module `drivers/<kind>.py` of the tree at `here`, whose `run`
    drives a cell's window; its relative imports reach this package."""
    path = here / "drivers" / f"{kind}.py"
    if not kind.isidentifier() or not path.is_file():
        raise SystemExit(f"gpubench: no driver for traffic kind {kind!r}")
    name = f"{__package__}.drivers.{kind}"
    if path.resolve() == (HERE / "drivers" / f"{kind}.py").resolve():
        return importlib.import_module(name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics with
    trace 0, its per-layer metrics with trace 1."""
    e2e = [m for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def load_reader(name: str, here: Path = HERE):
    """The module of `metrics/<name>.py`."""
    path = here / "metrics" / f"{name}.py"
    mod_name = "gpubench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card() -> Dict[str, str]:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        name, limit = [s.strip() for s in out.splitlines()[0].split(",")]
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"name": "unknown", "power_limit": "unknown"}


def result_line(out: dict, metrics: List[dict], device: dict, trace: bool) -> str:
    """The result's JSON line: correct, attempted, failed, metrics, device,
    breakdown (traced) and, last, every number compared beside its limit."""
    vals = {}
    for m in metrics:
        v = out["metrics"].get(m["name"])
        if v is None:
            log(f"gpubench: metric {m['name']} found nothing to read in this run; left out")
            continue
        vals[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = out["checks"]
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values()) \
        and out["failed"] == 0
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": vals, "device": device}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return json.dumps(line)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path = ROOT) -> str:
    """Run the cell on `device` (a torch.device) and return its result line."""
    import torch

    spec = load_spec(root)
    here = root / "gpubench"
    config, traffic = cell_parts(spec, workload, here)
    metrics = cell_metrics(spec, workload, trace)
    readers = {m["name"]: load_reader(m["name"], here) for m in metrics
               if m["name"] in {p["name"] for p in spec["per_layer"]}}
    driver = load_driver(traffic["kind"], here)
    out = driver.run(config=config, traffic=traffic, seed=seed, seconds=seconds,
                     trace=trace, device=device, readers=readers, t_start=t_start)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"gpubench: the run loaded {', '.join(found)}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["window_s"]
    if device.type == "cuda":
        c = card()
        log(f"gpubench: {c['name']}, power limit {c['power_limit']}")
    line = result_line(out, metrics, dev, trace)
    # the numbers compared, each beside its limit, as the last lines on stderr
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    return line
