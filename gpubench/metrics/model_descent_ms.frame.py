"""model_descent_ms.frame: the modeler's k-step surface descent, in ms: the
median, over every call of the traced run, of the CUDA-event time of the program's
`model/descent` span (`project_to_surface` in `render.pipeline.surface_splats`)."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    return program_spans.span_ms(run, "model/descent", "device_ms_median")
