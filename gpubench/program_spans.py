"""The program's own spans and counters, read from the benchmark's side.

The program records a span at each of its layer edges and counts the pairs
each binning makes (`splat_renderer_tpu_torch.utils.profiling`), while its
recorder is on.  Importing this module turns it on.  Only the readers of
per-layer metrics import it, and a run loads them only with `--trace 1`, so
a run that gives the end-to-end metrics leaves the recorder off.  A
program without the recorder reads None everywhere, and nothing raises.

Every reading is taken once a traced run, at its end: the recorder's
report (span metrics read the median over every call of the run, which the
warm-up and the profiled items hardly move), its counters, and the
device's idle gaps in the host stretch filed under the innermost program
span the host was in (`gaps_by_span`), logged on stderr.
"""

from __future__ import annotations

import statistics
import sys
from typing import List, Optional, Sequence, Tuple

from . import timeline


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from splat_renderer_tpu_torch.utils import profiling
    except ImportError:
        return None
    need = ("enable", "enabled", "disable", "reset", "report", "intervals", "counter")
    return profiling if all(hasattr(profiling, a) for a in need) else None


def enable() -> None:
    """Turn the program's recorder on, with no records, unless it is on."""
    prof = recorder()
    if prof is not None and not prof.enabled():
        prof.reset()
        prof.enable()


enable()


def clock_offset_us(items: Sequence[Tuple[float, float]],
                    item_spans: Sequence[Tuple[float, float]]) -> Optional[float]:
    """The profiler's clock (us) less `time.perf_counter` (in us): the
    median over the items' starts and ends, each item timed on both."""
    n = min(len(items), len(item_spans))
    if not n:
        return None
    return statistics.median([s[j] - i[j] * 1e6 for i, s in zip(items[:n], item_spans[:n])
                              for j in (0, 1)])


def gaps_by_span(device: Sequence[Tuple[float, float, str]],
                 items: Sequence[Tuple[float, float]],
                 item_spans: Sequence[Tuple[float, float]],
                 intervals: Sequence[Tuple[str, Optional[str], float, float]],
                 k: int = 10) -> Tuple[List[List], float]:
    """The device's idle gaps inside the item spans, in seconds, summed by
    the innermost program span open when each began (`intervals`, host
    seconds, shifted onto the profiler's clock by `clock_offset_us`): the
    k largest, and the idle time in all."""
    off = clock_offset_us(items, item_spans)
    if off is None:
        return [], 0.0
    lo, hi = item_spans[0][0], item_spans[-1][1]
    spans = [(a * 1e6 + off, b * 1e6 + off, name) for name, _, a, b in intervals
             if b * 1e6 + off > lo and a * 1e6 + off < hi]
    dev = [(s, e) for s, e, _ in device]
    total = sum(b - a for a, b in timeline.gaps(dev, lo, hi)) / 1e6
    return [[n, v / 1e6] for n, v in timeline.gap_causes(dev, spans, lo, hi, k)], total


class Readings:
    """What a traced run's program recorded, read once at its end."""

    def __init__(self, run, prof):
        self.run = run
        self.report = prof.report()
        self.counts = {w: prof.counter("pairs", within=w) for w in ("frame", "fit/step")}
        host = run.host_timeline
        if host is not None:
            gaps, idle = gaps_by_span(host.device, host.items, host.item_spans,
                                      prof.intervals())
            log(f"gpubench: the host stretch's device idle gaps by program span, s "
                f"(of {idle:.6f} s idle): {gaps}")
        prof.disable()


_last: Optional[Readings] = None


def readings(run) -> Optional[Readings]:
    """The run's readings (taken at the first call for this run), or None
    where the program has no recorder or it was off."""
    global _last
    if _last is not None and _last.run is run:
        return _last
    prof = recorder()
    if prof is None or not prof.enabled():
        return None
    _last = Readings(run, prof)
    return _last


def span_ms(run, name: str, field: str) -> Optional[float]:
    """A field of the span's report ("device_ms_median", "host_ms_median",
    ...), or None where the span never ran."""
    r = readings(run)
    if r is None or name not in r.report:
        return None
    return r.report[name][field]


def pairs_per_call(run, within: str) -> Optional[float]:
    """Millions of pairs binned a call of the span `within`: the pairs
    counted while it was the outermost open span, over its calls."""
    r = readings(run)
    if r is None or within not in r.report or within not in r.counts:
        return None  # the span never ran, or no reader counts under it
    return r.counts[within] / r.report[within]["calls"] / 1e6
