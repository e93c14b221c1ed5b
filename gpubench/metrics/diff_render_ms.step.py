"""diff_render_ms.step: the training forward (records, bin_planes_diff, K4), the mean CUDA-
event ms from the entry of `splat_renderer_tpu_torch.fit:render_diff` to its return, over
every call of the traced window."""

WRAP = {"render_diff": "splat_renderer_tpu_torch.fit:render_diff"}


def read(run):
    return run.span_ms("render_diff")
