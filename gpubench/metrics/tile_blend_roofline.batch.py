"""tile_blend_roofline.batch: the tile blend (K1)'s share of its roofline on oriented records, in %,
over the first 2 views of the traced stretch: the least time the H100 needs for the work these
views need over the device time of the first 2 launches of `tile_blend_kernel<true, ...>` (the
ORIENTED instantiation).  The work is counted by the reference's own fold up to each pixel's
stop (`drivers/views.py`'s `blend_counts`: evaluations, those inside the support, pairs and records
read), the bytes as `roofline.blend_bytes` counts them, the operations by the table below: an
oriented evaluation's support test rotates the offset into the ellipse's frame."""

from gpubench.roofline import FP32_FLOP_S, HBM_BYTES_S, SFU_OP_S, blend_bytes, share_percent

KERNEL = "tile_blend_kernel<true,"
VIEWS = 2
# an oriented evaluation: dx, dy 2; u = c dx + s dy 3; v = (c dy - s dx) rr 4; u^2 + v^2 3;
# the compare 1.  Inside the support the isotropic profile's 12 flops and 1 SFU result
# (`roofline.OPS["tile_blend"]`): the exponent, the alpha and the fold.
TEST_FLOPS, INSIDE_FLOPS, INSIDE_SFU = 13, 12, 1


def read(run):
    counts_of = getattr(run, "blend_counts", None)
    rcfg = getattr(run, "render_config", None)
    if counts_of is None or rcfg is None:
        return None
    kernel_s = run.timeline.kernel_s(KERNEL, VIEWS)
    if kernel_s <= 0.0:
        return None
    least = 0.0
    for c in counts_of(VIEWS):
        n_bytes = blend_bytes(rcfg.num_tiles, rcfg.tile_pixels, c["pairs"], c["records"])
        t_ops = max((c["evals"] * TEST_FLOPS + c["inside"] * INSIDE_FLOPS) / FP32_FLOP_S,
                    c["inside"] * INSIDE_SFU / SFU_OP_S)
        least += max(n_bytes / HBM_BYTES_S, t_ops)
    return share_percent(least, kernel_s)
