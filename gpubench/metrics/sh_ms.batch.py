"""sh_ms.batch: SH lighting (`render/sh.py::apply_sh`, one call a view) in a batch, in ms: the mean
CUDA-event ms of the program's `sh` span times its calls a `views` span, over every call of the
traced run."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    r = program_spans.readings(run)
    if r is None or "sh" not in r.report or "views" not in r.report:
        return None
    per_batch = r.report["sh"]["calls"] / r.report["views"]["calls"]
    return r.report["sh"]["device_ms_mean"] * per_batch
