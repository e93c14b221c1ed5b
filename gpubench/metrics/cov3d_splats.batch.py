"""cov3d_splats.batch: the splats projected as full-covariance 3D Gaussians in a batch, in
millions: the program's `cov3d_splats` counter (N for each `ellipse="cov3d"` call of
`splat_screen_words`) over the calls made inside `views` spans in the traced run, divided by its
`views` calls.  8 views of 2M Gaussians read 16.0."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    r = program_spans.readings(run)
    if r is None or "views" not in r.report:
        return None
    n = program_spans.recorder().counter("cov3d_splats", within="views")
    return n / r.report["views"]["calls"] / 1e6 if n else None
