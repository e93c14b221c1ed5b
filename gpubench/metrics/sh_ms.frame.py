"""sh_ms.frame: SH lighting, the mean CUDA-event ms from the entry of
`splat_renderer_tpu_torch.render.pipeline:apply_sh` to its return, over every call of the
traced window."""

WRAP = {"apply_sh": "splat_renderer_tpu_torch.render.pipeline:apply_sh"}


def read(run):
    return run.span_ms("apply_sh")
