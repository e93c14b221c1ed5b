"""adam_ms.step: the optimizer, the mean CUDA-event ms from the entry of
`splat_renderer_tpu_torch.fit:adam_update` to its return, over every call of the traced
window."""

WRAP = {"adam_update": "splat_renderer_tpu_torch.fit:adam_update"}


def read(run):
    return run.span_ms("adam_update")
