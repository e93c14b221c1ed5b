"""project_roofline.batch: the projector kernel's `cov3d` instantiations' share of their bytes
roofline, in %, over the first batch of the traced stretch: the bytes its 8 calls must move
(`project_words_bytes.py` beside this file: the planes read at their strides, the words and
depth written) over 3.35 TB/s, over the device time of those 8 launches of
`project_words_kernel<3, ...>` in the device-only profile."""

import importlib.util
from pathlib import Path

from gpubench.roofline import HBM_BYTES_S, share_percent

KERNEL = "project_words_kernel<3,"  # the "cov3d" instantiations (csrc Ellipse kCov3d = 3)

_spec = importlib.util.spec_from_file_location(
    "gpubench_metric_project_words_bytes", Path(__file__).with_name("project_words_bytes.py"))
project_words_bytes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(project_words_bytes)


def read(run):
    calls = getattr(run, "projector_calls", None)
    if not calls:
        return None
    kernel_s = run.timeline.kernel_s(KERNEL, len(calls))
    if kernel_s <= 0.0:
        return None
    least = sum(project_words_bytes.call_bytes(c) for c in calls) / HBM_BYTES_S
    return share_percent(least, kernel_s)
