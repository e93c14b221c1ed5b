"""quad_blend_roofline.frame: the tile blend (K1)'s share of its roofline on opaque oriented
quads, in %, over the first 2 frames of the traced stretch: the least time the H100 needs for
the work these frames need over the device time of the first 2 launches of
`tile_blend_kernel<true, 2, ...>` (ORIENTED, SHAPE 2: the opaque quad).  The work is counted by
the reference's own fold up to each pixel's stop (`drivers/frames.py`'s roofline hook: evaluations,
those inside the support, pairs and records read), the bytes as `roofline.blend_bytes` counts
them, the operations by the table below, registered in `roofline.OPS` under its own key."""

from gpubench import roofline

OPS = "quad_blend"
KERNEL = "tile_blend_kernel<true, 2,"
ITEMS = 2
# A quad evaluation's support test: dx, dy 2; u = c dx + s dy 3; vr = (c dy - s dx) rr 4;
# u^2, vr^2 2; the two compares 2: 13 flops.  Inside the support the opaque fold alone: w =
# alpha T 1, the colour's three multiply-adds 6, T (1 - alpha) 2: 9 flops, no exponent and no
# SFU result.
TEST_FLOPS, INSIDE_FLOPS, INSIDE_SFU = 13, 9, 0
roofline.OPS.setdefault(OPS, (TEST_FLOPS, INSIDE_FLOPS, INSIDE_SFU))


def read(run):
    return run.roofline(OPS, KERNEL, ITEMS)
