"""frame_host_ms.frame: the host's time to issue a frame, in ms: the median, over
every call of the traced run, of the host-clock time from the entry of the program's `frame`
span (`Engine.frame`, and so `SplatEngine.frame`) to its return, before the caller's
synchronize."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    return program_spans.span_ms(run, "frame", "host_ms_median")
