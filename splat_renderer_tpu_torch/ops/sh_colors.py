"""SH lighting's CUDA kernel (S1): a call's lit colours in one launch.

`sh_colors` launches `csrc/sh_colors.cu` on CUDA tensors and returns what
`render/sh.py::apply_sh_plain` returns, bit for bit: the splats with cr,
cg and cb replaced by the rows of one fresh (3, N) float32 tensor;
`launches["sh_colors"]` (`ops/build.py`) counts its launches.
`render/sh.py::apply_sh` calls it for CUDA tensors through which no
gradient can flow; the CPU and autograd take the plain path.  The kernel
replaces no TPU kernel (the JAX package's `apply_sh` is plain jnp that XLA
fuses): it replaces the plain path's ~150 launches a call.

Every input is read in place at its own strides: the planes may be
columns of (N, 3) tensors, the coefficients rows of one (3, R, N) tensor,
the camera a view of a (V, 3) tensor.  Nothing here reads back from the
device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from .build import Entry, check_tensor

# the kernel's plane order (csrc Plane enum)
PLANES = ("px", "py", "pz", "cr", "cg", "cb")
CHANNELS = ("r", "g", "b")

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_FORWARD = Entry("sh_colors", "sh_colors_forward",
                 [_P, _P, _P, _LL, _P, _P, _LL, ctypes.c_int, _P])
# the planes' and coefficient tensors' pointers; the planes' strides, then
# each coefficient tensor's (row, element) strides
_POINTERS, _STRIDES = ctypes.c_void_p * 9, ctypes.c_longlong * 12


@functools.lru_cache(maxsize=None)
def float32s(scalars: Tuple[float, ...]) -> ctypes.Array:
    """`scalars` as a C float array.  ctypes rounds each double to the
    nearest float32, as PyTorch rounds a scalar against a float32 tensor."""
    return (ctypes.c_float * len(scalars))(*scalars)


def sh_colors(
    splats: Dict[str, torch.Tensor],
    sh: Dict[str, torch.Tensor],  # {"r"|"g"|"b": (R, N)}
    cam_pos: torch.Tensor,  # (3,)
    degree: int,
    scalars: Tuple[float, ...],
) -> Dict[str, torch.Tensor]:
    """One kernel launch: `dict(splats)` with cr, cg, cb lit by bands
    1..`degree` of `sh` along the direction from `cam_pos`, equal bit for
    bit to `apply_sh_plain(splats, sh, cam_pos, degree)` on the same CUDA
    device.  `scalars` are the plain path's 15 Python scalars in csrc
    Consts order (`render/sh.py::KERNEL_SCALARS`: -SH_C1, SH_C1, SH_C2,
    SH_C3 and the squared length's floor).  Every plane, coefficient and
    the camera live on the planes' device as float32; raises ValueError on
    anything else."""
    px = splats["px"]
    device = px.device
    if px.dim() != 1:
        raise ValueError(f"splats['px'] must be 1-d, got shape {tuple(px.shape)}")
    n = px.shape[0]
    if len(scalars) != 15:
        raise ValueError(f"the SH kernel takes 15 scalars, got {len(scalars)}")
    if degree not in (1, 2, 3):
        raise ValueError(f"the SH kernel evaluates degree 1, 2 or 3, not {degree}")
    # the kernel reads every input at its own strides
    for name in PLANES:
        check_tensor(f"splats[{name!r}]", splats[name], torch.float32, device, (n,),
                     contiguous=False)
    if sh["r"].dim() != 2:
        raise ValueError(f"sh['r'] must be 2-d (rows, N), got shape {tuple(sh['r'].shape)}")
    rows = sh["r"].shape[0]
    for ch in CHANNELS:
        check_tensor(f"sh[{ch!r}]", sh[ch], torch.float32, device, (rows, n), contiguous=False)
    need = (degree + 1) ** 2 - 1  # the rest bands of degrees 1..degree
    if rows < need:
        raise ValueError(f"degree {degree} needs {need} coefficient rows, sh has {rows}")
    check_tensor("cam_pos", cam_pos, torch.float32, device, (3,), contiguous=False)
    if device.type != "cuda":
        raise ValueError(f"no SH kernel for device {device}")

    planes = [splats[k] for k in PLANES]
    coeffs = [sh[ch] for ch in CHANNELS]
    out = torch.empty((3, n), dtype=torch.float32, device=device)
    _FORWARD.launch(
        device,
        _POINTERS(*[t.data_ptr() for t in planes + coeffs]),
        _STRIDES(*[t.stride(0) for t in planes], *[s for t in coeffs for s in t.stride()]),
        cam_pos.data_ptr(), cam_pos.stride(0), float32s(scalars), out.data_ptr(), n, degree,
        count="sh_colors",
    )
    cr, cg, cb = out.unbind(0)
    return dict(splats, cr=cr, cg=cg, cb=cb)
