"""views_host_ms.batch: the host's time to issue an 8-view batch, in ms: the median, over every
call of the traced run, of the host-clock time from the entry of the program's `views` span
(`render_views`) to its return, before the caller's copy to the host and synchronize."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    return program_spans.span_ms(run, "views", "host_ms_median")
