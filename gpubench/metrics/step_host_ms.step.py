"""step_host_ms.step: the host's time through a fit step, in ms: the median, over
every step of the traced run, of the host-clock time of the program's `fit/step` span (one
step of `fit.fit_splats`, from the loss's inputs to Adam's return)."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    return program_spans.span_ms(run, "fit/step", "host_ms_median")
