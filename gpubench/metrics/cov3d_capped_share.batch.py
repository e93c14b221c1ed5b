"""cov3d_capped_share.batch: the share of a batch's live Gaussian records, in %, whose radius sits
at the cap r_cap: the Gaussians whose major standard deviation the record format clamps at
sigma * r_cap (2.67 px at 16-px tiles and tiles_per_splat_cap 8), drawn smaller than their
covariance.  The program's counters `cov3d_capped` over `cov3d_live`
(`render/projector.py::count_cov3d`), made inside `views` spans in the traced run."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    r = program_spans.readings(run)
    if r is None or "views" not in r.report:
        return None
    live = program_spans.recorder().counter("cov3d_live", within="views")
    if not live:
        return None
    return 100.0 * program_spans.recorder().counter("cov3d_capped", within="views") / live
