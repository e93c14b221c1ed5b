"""Small tensor helpers shared by the port's modules."""

from __future__ import annotations

import numpy as np
import torch


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """`c / t` as one IEEE divide.

    PyTorch evaluates `python_scalar / tensor` as `t.reciprocal() * c`,
    which rounds twice; jnp divides once.  Every `scalar / tensor` in the
    port goes through here so its values stay bit-equal to the JAX
    package's.
    """
    return torch.full_like(t, c) / t


def div(t: torch.Tensor, c: float) -> torch.Tensor:
    """`t / c` as one IEEE divide.

    On CUDA, PyTorch divides by a Python scalar as `t * (1 / c)`, which
    rounds twice; this keeps the divisor a tensor so every device divides
    once, as jnp does.
    """
    return t / torch.full_like(t, c)


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.

    PyTorch's CPU `sqrt` is not correctly rounded (about 0.7% of float32
    inputs come out one ulp off), and the projector's words must match the
    JAX package's bit for bit.  A float64 square root rounded to float32 is
    correctly rounded (53 >= 2*24 + 2 bits), on every device.
    """
    return torch.sqrt(t.to(torch.float64)).to(t.dtype)


def maximum(t: torch.Tensor, c: float) -> torch.Tensor:
    """`jnp.maximum(t, c)`: the gradient splits in half where t == c.

    `torch.clamp` passes the whole gradient at a bound, `jnp.maximum` and
    `jnp.clip` give each side half; `torch.maximum` with a tensor bound
    splits as jnp does.  The bound is a 0-dim CPU tensor, which PyTorch
    takes beside a tensor on any device, like a Python scalar."""
    return torch.maximum(t, torch.tensor(c, dtype=t.dtype))


def minimum(t: torch.Tensor, c: float) -> torch.Tensor:
    """`jnp.minimum(t, c)`, with jnp's gradient at a tie (see `maximum`)."""
    return torch.minimum(t, torch.tensor(c, dtype=t.dtype))


def clip(t: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(t, lo, hi)`, with jnp's gradient at the bounds."""
    return minimum(maximum(t, lo), hi)


def to_numpy(a) -> np.ndarray:
    """A tensor on any device, or anything array-like, as a numpy array on
    the host (dtype kept)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def same_device(t: torch.Tensor, device) -> bool:
    """Whether tensor `t` lives on `device` (an index-less "cuda" matches
    the current CUDA device)."""
    d = torch.device(device)
    if t.device.type != d.type:
        return False
    if d.index is None or d.type != "cuda":
        return True
    return t.device.index == d.index


def check_device(device, **tensors: torch.Tensor) -> None:
    """Raise unless every named tensor lives on `device`."""
    for name, t in tensors.items():
        if not same_device(t, device):
            raise ValueError(f"{name} is on {t.device}, expected {device}")
