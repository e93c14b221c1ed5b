"""pairs.batch: the (tile, record) pairs binned in a batch, in millions: the program's `pairs`
counter (`offsets[-1]` of every binning, `render.binning._pair_stage`) over the binnings made
inside `views` spans in the traced run, divided by its `views` calls."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    r = program_spans.readings(run)
    if r is None or "views" not in r.report:
        return None
    n = program_spans.recorder().counter("pairs", within="views")
    return n / r.report["views"]["calls"] / 1e6 if n else None
