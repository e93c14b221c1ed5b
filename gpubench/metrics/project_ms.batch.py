"""project_ms.batch: the projector's device time in a batch, in ms: the mean CUDA-event ms of the
program's `project` span (`splat_screen_words`, the whole call) times its calls a `views` span
(one a view), over every call of the traced run."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    r = program_spans.readings(run)
    if r is None or "project" not in r.report or "views" not in r.report:
        return None
    per_batch = r.report["project"]["calls"] / r.report["views"]["calls"]
    return r.report["project"]["device_ms_mean"] * per_batch
