"""pairs.step: the (tile, record) pairs binned a fit step, in millions: the program's
`pairs` counter (`offsets[-1]` of every binning, `render.binning._pair_stage`) over the
binnings made inside `fit/step` spans in the traced run, divided by its `fit/step` calls."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    return program_spans.pairs_per_call(run, "fit/step")
