"""blend_ms.frame: the tile blend (K1 and its wrapper), the mean CUDA-event ms from the entry
of `splat_renderer_tpu_torch.ops.tile_blend:blend_tiles` to its return, over every call of
the traced window."""

WRAP = {"blend_tiles": "splat_renderer_tpu_torch.ops.tile_blend:blend_tiles"}


def read(run):
    return run.span_ms("blend_tiles")
