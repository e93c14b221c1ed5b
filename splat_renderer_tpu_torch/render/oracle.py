"""Sequential compositing oracle: exact, O(N x pixels), the fidelity gate.

Counterpart of `splat_renderer_tpu/render/oracle.py`: every splat is blended
against every pixel in canonical front-to-back order, in chunks carrying
per-pixel (colour, transmittance); within a chunk the over-operator is an
exclusive segmented product (exact, no log/exp).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from .binning import canonical_sort_data
from .blend import (
    composite_over_background,
    segmented_exclusive_product,
    splat_alpha_planes,
)


def pixel_grid(cfg: RenderConfig, device) -> torch.Tensor:
    """(H*W, 2) pixel-centre coordinates (+0.5)."""
    ys, xs = torch.meshgrid(
        torch.arange(cfg.height, dtype=torch.float32, device=device),
        torch.arange(cfg.width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([xs + 0.5, ys + 0.5], dim=-1).reshape(-1, 2)


def render_oracle(
    splat_data: torch.Tensor,  # (N, 10) quantized screen records, ANY order
    cfg: RenderConfig,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Render the exact (H, W, 3) image, blending all N splats front to back
    against every pixel."""
    chunk = chunk or cfg.blend_chunk
    data = canonical_sort_data(splat_data)
    n = data.shape[0]
    pad = (-n) % chunk
    if pad:
        # padded splats get radius 0 -> zero alpha everywhere
        data = torch.cat([data, data.new_zeros((pad, data.shape[1]))])
    chunks = data.reshape(-1, chunk, data.shape[1])

    pix = pixel_grid(cfg, data.device)
    px, py = pix[:, 0], pix[:, 1]
    hw = px.shape[0]
    starts = torch.zeros(chunk, dtype=torch.bool, device=data.device)
    starts[0] = True
    color = torch.zeros((3, hw), dtype=torch.float32, device=data.device)
    trans = torch.ones(hw, dtype=torch.float32, device=data.device)
    for cd in chunks:
        a = splat_alpha_planes(
            cd[:, 0:1], cd[:, 1:2], cd[:, 2:3], cd[:, 3:4], cd[:, 8:9],
            cd[:, 9:10], px[None, :], py[None, :], cfg,
        )  # (chunk, HW)
        t_local = segmented_exclusive_product(1.0 - a, starts)
        weight = a * t_local * trans[None, :]
        # elementwise fp32 fold (no matmul, so no TF32 question on the card)
        color = color + (weight[:, None, :] * cd[:, 4:7, None]).sum(0)
        trans = trans * torch.prod(1.0 - a, dim=0)
    img = composite_over_background(color.T, 1.0 - trans, cfg)
    return img.reshape(cfg.height, cfg.width, 3)
