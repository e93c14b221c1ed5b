"""diff_bwd_roofline.step: the differentiable blend's backward (K5)'s share of its roofline, in
%, over the first 2 steps of the traced stretch: the least time the H100 needs for the work
these inputs need (`roofline.least_seconds`, counted by the reference's own fold up to each
pixel's stop) over the device time of `diff_bwd_kernel` in the same steps."""

OPS = "tile_blend_diff_bwd"
KERNEL = "diff_bwd_kernel"
ITEMS = 2


def read(run):
    return run.roofline(OPS, KERNEL, ITEMS)
