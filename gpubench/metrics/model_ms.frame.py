"""model_ms.frame: the modeler, the mean CUDA-event ms from the entry of
`splat_renderer_tpu_torch.render.pipeline:model_points` to its return, over every call of
the traced window."""

WRAP = {"model_points": "splat_renderer_tpu_torch.render.pipeline:model_points"}


def read(run):
    return run.span_ms("model_points")
