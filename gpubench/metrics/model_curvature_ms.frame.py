"""model_curvature_ms.frame: the modeler's curvature probe, in ms: the median,
over every call of the traced run, of the CUDA-event time of the program's `model/curvature`
span (`curvature_probe` in `render.pipeline.surface_splats`)."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    return program_spans.span_ms(run, "model/curvature", "device_ms_median")
