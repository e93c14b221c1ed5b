"""diff_fwd_roofline.step: the differentiable blend's forward (K4)'s share of its roofline, in
%, over the first 2 steps of the traced stretch: the least time the H100 needs for the work
these inputs need (`roofline.least_seconds`, counted by the reference's own fold up to each
pixel's stop) over the device time of `diff_fwd_kernel` in the same steps."""

OPS = "tile_blend_diff_fwd"
KERNEL = "diff_fwd_kernel"
ITEMS = 2


def read(run):
    return run.roofline(OPS, KERNEL, ITEMS)
