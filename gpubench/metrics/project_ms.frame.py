"""project_ms.frame: the projector, the mean CUDA-event ms from the entry of
`splat_renderer_tpu_torch.render.pipeline:splat_screen_words` to its return, over every call
of the traced window."""

WRAP = {"splat_screen_words": "splat_renderer_tpu_torch.render.pipeline:splat_screen_words"}


def read(run):
    return run.span_ms("splat_screen_words")
