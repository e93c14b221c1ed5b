"""blend_ms.batch: the tile blend (`ops/tile_blend.py::blend_tiles`: K1 and its wrapper, one call a
view) in a batch, in ms: the mean CUDA-event ms of the program's `blend` span times its calls a
`views` span, over every call of the traced run."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    r = program_spans.readings(run)
    if r is None or "blend" not in r.report or "views" not in r.report:
        return None
    per_batch = r.report["blend"]["calls"] / r.report["views"]["calls"]
    return r.report["blend"]["device_ms_mean"] * per_batch
