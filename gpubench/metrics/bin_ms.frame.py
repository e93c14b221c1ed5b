"""bin_ms.frame: the binner, the mean CUDA-event ms from the entry of
`splat_renderer_tpu_torch.render.pipeline:bin_packed_words` to its return, over every call
of the traced window."""

WRAP = {"bin_packed_words": "splat_renderer_tpu_torch.render.pipeline:bin_packed_words"}


def read(run):
    return run.span_ms("bin_packed_words")
