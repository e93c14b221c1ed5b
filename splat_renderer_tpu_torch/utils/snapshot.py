"""Splat-set snapshots and training-state checkpoints (.npz).

Counterpart of `splat_renderer_tpu/utils/snapshot.py`.  A splat set is
stored as array-of-structs fields (position/color/normal (N, 3)), the
interchange layout of the JAX package's snapshots.  Checkpoints are nested
dicts/lists of tensors whose leaves are keyed by their path in the JAX
package's `keystr` form (`['theta']['cr']`), so a JAX `fit_splats`
checkpoint's leaves can be read by the same names (`convert.
theta_from_checkpoint`).
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np
import torch

from ..points.properties import Splats, splats_from_aos


def save_splats(path: str, splats: Splats) -> None:
    f = lambda *ks: np.stack([splats[k].detach().cpu().numpy() for k in ks], -1)  # noqa: E731
    np.savez_compressed(
        path,
        position=f("px", "py", "pz"),
        radius=splats["radius"].detach().cpu().numpy(),
        color=f("cr", "cg", "cb"),
        opacity=splats["opacity"].detach().cpu().numpy(),
        normal=f("nx", "ny", "nz"),
    )


def load_splats(path: str, device) -> Splats:
    with np.load(path) as z:
        t = lambda k: torch.as_tensor(z[k], device=device)  # noqa: E731
        return splats_from_aos(t("position"), t("radius"), t("color"),
                               t("opacity"), t("normal"))


def checkpoint_file(path: str) -> str:
    """The on-disk file of a checkpoint path: np.savez appends '.npz' to
    suffix-less names, so existence checks must too."""
    return path if path.endswith(".npz") else path + ".npz"


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(key path, leaf) pairs; dict keys in sorted order, as jax flattens."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def save_pytree(path: str, tree) -> None:
    """Checkpoint a nested dict/list of tensors, keyed by path.  The write
    is atomic (temp file + os.replace): a crash mid-save keeps the previous
    checkpoint."""
    path = checkpoint_file(path)
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, **{k: torch.as_tensor(v).detach().cpu().numpy() for k, v in _leaves(tree)}
    )
    os.replace(tmp, path)


def load_pytree(path: str, like):
    """Load a `save_pytree` archive into the structure of `like`, each leaf
    onto the device of `like`'s leaf (values and shapes are the saved
    ones)."""
    with np.load(checkpoint_file(path)) as z:
        def build(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: build(v, f"{prefix}[{k!r}]") for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(build(v, f"{prefix}[{i}]") for i, v in enumerate(tree))
            return torch.as_tensor(z[prefix], device=torch.as_tensor(tree).device)

        return build(like)
