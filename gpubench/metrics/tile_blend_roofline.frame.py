"""tile_blend_roofline.frame: the tile blend (K1)'s share of its roofline, in %, over the first
2 frames of the traced stretch: the least time the H100 needs for the work these inputs need
(`roofline.least_seconds`, counted by the reference's own fold up to each pixel's stop) over
the device time of `tile_blend_kernel` in the same frames."""

OPS = "tile_blend"
KERNEL = "tile_blend_kernel"
ITEMS = 2


def read(run):
    return run.roofline(OPS, KERNEL, ITEMS)
