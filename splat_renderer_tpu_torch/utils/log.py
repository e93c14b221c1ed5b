"""Logging: the engine's notices through one standard logger, so a host
application configures them (`logging.getLogger("splat_renderer_tpu_torch")`).

Counterpart of `splat_renderer_tpu/utils/log.py`.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("splat_renderer_tpu_torch")


def log_rebuild(structure_hash: str) -> None:
    """New per-structure frame state: the notice an Engine gives once for
    each scene structure it has not seen (the JAX package compiles a new
    frame program there)."""
    logger.info("new frame state for scene structure %s", structure_hash)


def log_point_budget(n: int, num_primitives: int) -> None:
    logger.info("point budget: %d points for %d primitive(s)", n, num_primitives)
