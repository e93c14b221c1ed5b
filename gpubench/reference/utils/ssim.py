"""SSIM and the 3DGS training loss ((1 - lam) * L1 + lam * (1 - SSIM)).

Counterpart of `splat_renderer_tpu/utils/ssim.py`: Wang et al. 2004 with an
11x11 Gaussian window (sigma 1.5) and SAME zero padding, per channel, then
the mean; the convention of the original 3DGS trainer.

The separable blur is written as 11 shifted multiply-adds in float32, not
as a convolution: on CUDA a float32 convolution runs through cuDNN in TF32
by default, whose error is comparable to C2 on near-flat regions and can
push SSIM above 1.  `ssim_np` and `quality_gate` are the host-side numpy
scoreboard, copied from the JAX package unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_WINDOW = 11
_SIGMA = 1.5
_C1 = 0.01**2  # (k1 * max_val)^2, max_val = 1.0
_C2 = 0.03**2


def _gauss_kernel(device) -> torch.Tensor:
    x = torch.arange(_WINDOW, dtype=torch.float32, device=device) - (_WINDOW - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * _SIGMA**2))
    return g / torch.sum(g)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable 11x11 Gaussian blur of (C, H, W), SAME zero padding."""
    g = _gauss_kernel(x.device)
    pad = (_WINDOW - 1) // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (pad, pad))
    x = sum(g[k] * xp[..., k:k + w] for k in range(_WINDOW))
    xp = F.pad(x, (0, 0, pad, pad))
    return sum(g[k] * xp[..., k:k + h, :] for k in range(_WINDOW))


def _chan_first(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) or (H, W) -> (C, H, W)."""
    img = img.to(torch.float32)
    return img[None] if img.ndim == 2 else img.permute(2, 0, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two images in [0, 1], (H, W, 3) or (H, W) -> scalar;
    differentiable in both arguments."""
    x, y = _chan_first(img1), _chan_first(img2)
    mu_x, mu_y = _blur(x), _blur(y)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    var_x = _blur(x * x) - mu_xx
    var_y = _blur(y * y) - mu_yy
    cov = _blur(x * y) - mu_xy
    num = (2.0 * mu_xy + _C1) * (2.0 * cov + _C2)
    den = (mu_xx + mu_yy + _C1) * (var_x + var_y + _C2)
    return torch.mean(num / den)


def ssim_np(img1, img2) -> float:
    """Host-side (numpy, float64) mean SSIM, for published quality numbers:
    the same convention as `ssim`, with no device in the loop."""
    x = np.asarray(img1, np.float64)
    y = np.asarray(img2, np.float64)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {x.shape} vs {y.shape}")
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        raise ValueError("non-finite pixels in SSIM input")
    if x.ndim == 2:
        x, y = x[None], y[None]
    else:
        x, y = np.moveaxis(x, -1, 0), np.moveaxis(y, -1, 0)

    xs = np.arange(_WINDOW, dtype=np.float64) - (_WINDOW - 1) / 2.0
    g = np.exp(-(xs**2) / (2.0 * _SIGMA**2))
    g /= g.sum()

    def blur(a):  # separable SAME-zero-padded Gaussian over (C, H, W)
        pad = (_WINDOW - 1) // 2
        b = np.apply_along_axis(
            lambda r: np.convolve(np.pad(r, pad), g, mode="valid"), 1, a
        )
        return np.apply_along_axis(
            lambda r: np.convolve(np.pad(r, pad), g, mode="valid"), 2, b
        )

    mu_x, mu_y = blur(x), blur(y)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    var_x = blur(x * x) - mu_xx
    var_y = blur(y * y) - mu_yy
    cov = blur(x * y) - mu_xy
    num = (2.0 * mu_xy + _C1) * (2.0 * cov + _C2)
    den = (mu_xx + mu_yy + _C1) * (var_x + var_y + _C2)
    return float(np.mean(num / den))


def quality_gate(img, exact, lo: float = -1e-4, hi: float = 1.0 + 1e-4) -> float:
    """Range-asserted host SSIM: both images finite and inside [0, 1] (the
    blend cannot leave it), and the result inside [-1, 1]; raises
    AssertionError otherwise."""
    for name, a in (("img", np.asarray(img)), ("exact", np.asarray(exact))):
        if not np.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite pixels "
                                 f"(n={np.size(a) - np.isfinite(a).sum()})")
        mn, mx = float(a.min()), float(a.max())
        if mn < lo or mx > hi:
            raise AssertionError(f"{name}: pixel range [{mn}, {mx}] outside "
                                 f"[{lo}, {hi}] — out-of-range render output")
    s = ssim_np(img, exact)
    if not (-1.0 - 1e-6 <= s <= 1.0 + 1e-6):
        raise AssertionError(f"SSIM {s} outside [-1, 1] — metric corrupt")
    return s


def dssim_l1(img: torch.Tensor, target: torch.Tensor, lam: float = 0.2) -> torch.Tensor:
    """The 3DGS fitting objective: (1 - lam) * L1 + lam * (1 - SSIM)."""
    l1 = torch.mean(torch.abs(img - target))
    return (1.0 - lam) * l1 + lam * (1.0 - ssim(img, target))


def image_loss(name: str):
    """Loss registry for fit.py: "l2" (MSE), "l1", or "ssim" (the 3DGS
    L1/D-SSIM mix) -> fn(img, target) -> scalar."""
    losses = {
        "l2": lambda a, b: torch.mean((a - b) ** 2),
        "l1": lambda a, b: torch.mean(torch.abs(a - b)),
        "ssim": dssim_l1,
    }
    if name not in losses:
        raise ValueError(f"unknown loss {name!r} (use one of {sorted(losses)})")
    return losses[name]
