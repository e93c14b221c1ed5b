"""blend_walked.frame: the tile blend's walk a frame, in millions of run positions: the program's
`blend_walked` counter (`ops/tile_blend.py`: each tile's run positions taken before every pixel
of the tile had stopped, or the whole run; K1's per-tile kernel adds them into a device scalar,
one atomic a CTA) over the blends made inside `frame` spans in the traced run, divided by its
`frame` calls.  Against `pairs.frame` it says how much of the binned work the early stop leaves.
A program without the counter reads None."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    r = program_spans.readings(run)
    if r is None or "frame" not in r.report:
        return None
    walked = program_spans.recorder().counter("blend_walked", within="frame")
    if not walked:
        return None  # nothing counted it: every frame with a pair walks one
    return walked / r.report["frame"]["calls"] / 1e6
