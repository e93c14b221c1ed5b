"""Multi-device rendering over torch.distributed: view-DP x tile-band SP.

Counterpart of `splat_renderer_tpu/parallel/sharding.py`.  The JAX package
runs one controller over a device `Mesh` under `shard_map`; the port runs
one process per rank (`torchrun`, or any `init_process_group`), each
driving one device, and its collectives are torch.distributed's:

- **dp (view parallel)**: the views split over the dp axis; exact, no
  communication.
- **sp (space parallel)**: the modeler splits the points over every rank
  (its stages are elementwise), one world all_gather collects the splat
  planes, and the compositor splits the image into horizontal tile bands,
  one per sp index.

Rank r of a mesh is dp_index * sp + sp_index: the order of JAX's tiled
all_gather over "sp" and then "dp", so one world all_gather puts the splats
in the rank-major order of the single-device reference.

Devices: NCCL groups drive `cuda:{LOCAL_RANK}` (the default), gloo groups
the CPU, which the caller names (`device="cpu"`).  Any other pairing
raises; nothing falls back to the CPU.

Random numbers: `jax.random.fold_in(key, rank)` becomes `rank_generator`, a
`torch.Generator` per rank seeded from numpy's `SeedSequence([seed, rank])`.
torch cannot reproduce jax.random's streams, so every frame function also
takes the rank's own splats (`from_splats`), which parity tests fill with
the splats of JAX's shards.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._torch_util import check_device
from ..camera import CameraArrays
from ..config import PointConfig, RenderConfig
from ..points.properties import Splats
from ..render.binning import (
    Binned, bin_packed_words, bin_splats, canonical_sort_data, footprint_rows,
)
from ..render.compositor import render_tiles, tiles_to_image
from ..render.multiview import camera_at, view_count
from ..render.packing import U32_MASK, as_int32_bits
from ..render.pipeline import model_points
from ..render.projector import splat_screen_words
from ..sdf.scene import Params, SDFScene

# torch >= 2.13 names it all_gather_single; older releases only have the old name
all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) layout of a process group's ranks, seen from one rank.

    group: the mesh's ranks; rank: this process's rank in it,
    dp_index * sp + sp_index.  dp_group: the ranks that share this rank's
    sp_index (its dp axis); sp_group: those that share its dp_index (its sp
    axis).  device: the device this rank drives."""

    dp: int
    sp: int
    rank: int
    group: dist.ProcessGroup
    dp_group: dist.ProcessGroup
    sp_group: dist.ProcessGroup
    device: torch.device

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp

    @property
    def root(self) -> int:
        """The global rank of the mesh's rank 0 (where views are gathered)."""
        return dist.get_global_rank(self.group, 0)


def _check_backend(backend: str, device: torch.device) -> None:
    if device.type == "cuda":
        if "nccl" not in backend:
            raise ValueError(f"device {device} needs an nccl group; the group is {backend} "
                             "(a gloo group drives device='cpu')")
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: torch sees no CUDA device")
        if device.index is not None and device.index >= torch.cuda.device_count():
            raise ValueError(f"device {device}: only {torch.cuda.device_count()} CUDA devices")
    elif device.type == "cpu":
        if "gloo" not in backend:
            raise ValueError(f"device cpu needs a gloo group; the group is {backend}")
    else:
        raise ValueError(f"no collectives for device {device}")


def make_mesh(dp: int = 1, sp: int = 1, group: Optional[dist.ProcessGroup] = None,
              device=None) -> Mesh:
    """Lay the ranks of `group` (default: the world) out as a (dp, sp) mesh.

    dp shards views, sp shards points (in the modeler) and image tile bands
    (in the compositor).  The group needs dp * sp ranks: fewer raise
    ValueError("need N devices, have M"); more raise too.  Every rank calls
    make_mesh with the same arguments, and the group spans the world,
    since `dist.new_group` (the dp and sp subgroups) needs every rank of
    the world.  device: default `cuda:{LOCAL_RANK}` (an NCCL group); a
    gloo group needs device="cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    group = dist.group.WORLD if group is None else group
    n = dp * sp
    ranks = dist.get_process_group_ranks(group)
    if len(ranks) < n:
        raise ValueError(f"need {n} devices, have {len(ranks)}")
    if len(ranks) > n or n != dist.get_world_size():
        raise ValueError(f"a {dp}x{sp} mesh needs a group of exactly {n} ranks that spans "
                         f"the world; this one has {len(ranks)} of {dist.get_world_size()}")
    sp_groups = [dist.new_group([ranks[d * sp + s] for s in range(sp)]) for d in range(dp)]
    dp_groups = [dist.new_group([ranks[d * sp + s] for d in range(dp)]) for s in range(sp)]
    rank = dist.get_rank(group)
    if device is None:
        device = f"cuda:{os.environ.get('LOCAL_RANK', rank)}"
    device = torch.device(device)
    _check_backend(dist.get_backend(group), device)
    return Mesh(dp=dp, sp=sp, rank=rank, group=group, dp_group=dp_groups[rank % sp],
                sp_group=sp_groups[rank // sp], device=device)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The random stream of `rank` under `seed` (the port's
    `fold_in(key, rank)`): a torch.Generator on `device` seeded with the
    first 64-bit word of `numpy.random.SeedSequence([seed, rank])`, so ranks
    draw distinct, independent streams, the same on every run."""
    word = int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(word)


def gather_splats(local: Splats, mesh: Mesh) -> Splats:
    """One world all_gather of the splat planes: (n_local,) per rank ->
    (n,) in rank order on every rank."""
    keys = sorted(local)
    mine = torch.stack([local[k] for k in keys])  # (P, n_local)
    out = torch.empty((mesh.size * len(keys), mine.shape[1]), dtype=mine.dtype,
                      device=mine.device)
    all_gather_into(out, mine, group=mesh.group)  # the concatenated form: gloo has no other
    planes = out.reshape(mesh.size, len(keys), -1).transpose(0, 1).reshape(len(keys), -1)
    return {k: planes[i] for i, k in enumerate(keys)}


def _band_cfg(rcfg: RenderConfig, sp: int) -> RenderConfig:
    """The RenderConfig of one horizontal band of tiles (the last band's
    rows past the frame are cropped when views are gathered).  Raises where
    a splat's footprint could reach a band from farther away than the
    screen grid's margin (`pos_offset`), which `render_band` relies on."""
    if rcfg.tiles_y % sp:
        raise ValueError(
            f"tiles_y={rcfg.tiles_y} must be divisible by sp={sp} "
            f"(pad height to a multiple of {sp * rcfg.tile_h})"
        )
    ps = rcfg.pos_scale
    # quantized radius <= r_cap + half a grid step; oriented footprints add
    # one grid step of slack (binning._footprint_cols)
    reach = rcfg.bounds_margin * (rcfg.r_cap + 0.5 / ps) + 1.0 / ps
    if reach >= rcfg.pos_offset:
        raise ValueError(f"footprints reach {reach:.1f} px beyond their band, past the "
                         f"screen grid's {rcfg.pos_offset} px margin: lower tiles_per_splat_cap")
    return rcfg.replace(height=min(rcfg.tiles_y // sp * rcfg.tile_h, rcfg.height))


def band_stream(binned: Binned, band_index: int, rcfg: RenderConfig,
                band_cfg: RenderConfig) -> Binned:
    """The runs of one tile band of a stream binned on the frame's grid,
    in the band's frame.

    The band's tiles are a contiguous range of the tile-sorted pairs, so
    their runs are the frame's runs (exact by construction: the
    footprints were cut in the frame).  The records shift up by the
    band's origin y0 on the band's grid.  Where the band's grid is finer
    than the frame's (a portrait frame whose bands are narrower than its
    width: pos_scale grows with 1 / max(width, height)), every fixed-point
    field is multiplied by the power-of-two ratio of the two grids, which
    is exact, so every record decodes to the same floats less y0 and the
    band's pixels come out bit for bit as the full frame's.  A record that
    reaches the band lies within `pos_offset` of it (`_band_cfg`), so its
    shifted words fit the u16 fields; the others are clamped and never
    read.  Reads the band's first and last offsets on the host."""
    tb = band_cfg.num_tiles
    t0 = band_index * tb
    lo, hi = binned["offsets"][[t0, t0 + tb]].tolist()
    m = int(band_cfg.pos_scale // rcfg.pos_scale)
    y0_fx = int(band_index * band_cfg.tiles_y * band_cfg.tile_h * band_cfg.pos_scale)
    u32 = lambda w: w.to(torch.int64) & U32_MASK  # noqa: E731
    pos, ro = u32(binned["rec_pos"]), u32(binned["rec_ro"])
    u16 = lambda v: torch.clamp(v, 0, 0xFFFF)  # noqa: E731
    cx = u16((pos & 0xFFFF) * m)
    cy = u16((pos >> 16) * m - y0_fx)
    r = u16((ro & 0xFFFF) * m)
    return {
        "offsets": binned["offsets"][t0:t0 + tb + 1] - lo,
        "counts": binned["counts"][t0:t0 + tb],
        "pair_rank": binned["pair_rank"][lo:hi],
        "pair_tile": binned["pair_tile"][lo:hi] - t0,
        "rec_pos": as_int32_bits(cx | (cy << 16)),
        "rec_ro": as_int32_bits((ro & ~0xFFFF) | r),
        "rec_rgb": binned["rec_rgb"],
    }


def band_records(words: Dict[str, torch.Tensor], band_index: int, rcfg: RenderConfig,
                 band_cfg: RenderConfig) -> Dict[str, torch.Tensor]:
    """The words of the records whose footprint reaches tile band
    `band_index`, in input order: their footprints' tile rows on the
    frame (`footprint_rows`) meet the band's.  Reads their count on the
    host (the selection's size)."""
    rows = band_cfg.tiles_y
    r0 = band_index * rows
    ty0, h = footprint_rows(words["dk"], words["w_pos"], words["w_ro"], rcfg)
    idx = torch.nonzero((h > 0) & (ty0 < r0 + rows) & (ty0 + h > r0)).squeeze(1)
    return {k: words[k][idx] for k in ("dk", "w_pos", "w_ro", "w_rgb")}


def render_band(
    words: Dict[str, torch.Tensor],  # splat_screen_words(..., rcfg) of the full splat set
    band_index: int,
    rcfg: RenderConfig,
    sp: int,
) -> torch.Tensor:
    """Render horizontal tile band `band_index` of `sp`: (H/sp, W, 3).

    The word chain on the band: the records that reach it
    (`band_records`; at sp = 1 the band is the frame and every record is
    kept), so the pair expansion and sort cover about 1/sp of the frame's
    records, binned by `bin_packed_words` on the frame's grid; the band's runs in its own frame (`band_stream`); the tile blend
    (the CUDA kernel for CUDA tensors, its plain twin on the CPU).  The
    footprints are the frame's (a footprint that the tile cap shrinks or
    the band's edge cuts covers the frame's tiles; the band's own config
    would clamp and re-centre it), so each band's runs are the frame's
    runs of its tiles, and the kernel, which blends each tile from its run
    alone, gives the single-device frame's pixels bit for bit."""
    from ..ops.tile_blend import blend_tiles

    band_cfg = _band_cfg(rcfg, sp)
    w = words if sp == 1 else band_records(words, band_index, rcfg, band_cfg)
    binned = bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], rcfg)
    return tiles_to_image(*blend_tiles(band_stream(binned, band_index, rcfg, band_cfg), band_cfg),
                          band_cfg)


class MultichipFrame:
    """The frame step of `multichip_frame_fn`, on one rank.

    `frame(params, cameras, seed)` models this rank's n / (dp * sp) points
    from `rank_generator(seed, rank)`; `frame.from_splats(local, cameras)`
    takes them instead.  Either way the splats are all-gathered and the
    rank renders band sp_index of its V / dp views: (V / dp, H / sp, W, 3).
    `frame.gather(local)` assembles (V, H, W, 3) on the mesh's rank 0."""

    def __init__(self, scene: SDFScene, mesh: Mesh, n: int, pcfg: PointConfig,
                 rcfg: RenderConfig):
        if n % mesh.size:
            raise ValueError(f"point count {n} must be divisible by {mesh.size}")
        self.band_cfg = _band_cfg(rcfg, mesh.sp)
        self.scene, self.mesh, self.pcfg, self.rcfg = scene, mesh, pcfg, rcfg
        self.n_local = n // mesh.size

    def __call__(self, params: Params, cameras: CameraArrays, seed: int) -> torch.Tensor:
        mesh = self.mesh
        g = rank_generator(seed, mesh.rank, mesh.device)
        local = model_points(self.scene, params, g, self.n_local, self.pcfg, self.rcfg,
                             device=mesh.device)
        return self.from_splats(local, cameras)

    def from_splats(self, local: Splats, cameras: CameraArrays) -> torch.Tensor:
        mesh = self.mesh
        v = view_count(cameras)
        if v % mesh.dp:
            raise ValueError(f"view count {v} must be divisible by dp={mesh.dp}")
        check_device(mesh.device, **{f"splats[{k!r}]": t for k, t in local.items()},
                     view_proj=cameras["view_proj"])
        splats = gather_splats(local, mesh)
        vl = v // mesh.dp
        out = []
        for i in range(mesh.dp_index * vl, (mesh.dp_index + 1) * vl):
            cam = camera_at(cameras, i)
            words = splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], self.rcfg)
            out.append(render_band(words, mesh.sp_index, self.rcfg, mesh.sp))
        return torch.stack(out)

    def gather(self, local: torch.Tensor) -> Optional[torch.Tensor]:
        return gather_views(local, self.mesh, bands=self.mesh.sp, height=self.rcfg.height)


def multichip_frame_fn(
    scene: SDFScene,
    mesh: Mesh,
    n: int,
    pcfg: PointConfig,
    rcfg: RenderConfig,
) -> MultichipFrame:
    """The multi-device frame step: the modeler shards n points over all
    dp * sp ranks, the splats are all-gathered, and each rank composites
    its (sp-sharded) tile band of its (dp-sharded) views (`MultichipFrame`).
    Raises ValueError ("divisible") where n does not divide over the ranks
    or tiles_y over sp."""
    return MultichipFrame(scene, mesh, n, pcfg, rcfg)


def gather_views(local: torch.Tensor, mesh: Mesh, bands: int = 1,
                 height: Optional[int] = None) -> Optional[torch.Tensor]:
    """Assemble every rank's (V_local, H_band, ...) views on the mesh's
    rank 0, which gets (V, bands * H_band, ...) cropped to `height`; every
    other rank gets None.  Rank r holds views block r // bands and band
    r % bands (bands = 1 for outputs split over views only)."""
    lst: Optional[List[torch.Tensor]] = None
    if mesh.rank == 0:
        lst = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.gather(local.contiguous(), lst, dst=mesh.root, group=mesh.group)
    if lst is None:
        return None
    parts = torch.stack(lst)  # (size, Vl, Hb, ...)
    rest = tuple(parts.shape[3:])
    size, vl, hb = parts.shape[:3]
    parts = parts.reshape((size // bands, bands, vl, hb) + rest).transpose(1, 2)
    img = parts.reshape((size // bands * vl, bands * hb) + rest)
    return img if height is None else img[:, :height]


def render_views_data_parallel(
    splats_data: torch.Tensor,  # (V, N, 10) per-view screen records
    mesh: Mesh,
    rcfg: RenderConfig,
) -> torch.Tensor:
    """View-DP compositing of per-view float records: the view axis splits
    over every rank of the mesh, with no communication.  Each view runs
    the record path of the JAX package (`canonical_sort_data`,
    `bin_splats`, the plain tile compositor `render_tiles`), which is no
    kernel there either.  Returns this rank's (V / size, H, W, 3);
    `gather_views(local, mesh)` assembles all V."""
    check_device(mesh.device, splats_data=splats_data)
    v = splats_data.shape[0]
    if v % mesh.size:
        raise ValueError(f"view count {v} must be divisible by {mesh.size}")
    vl = v // mesh.size
    out = []
    for i in range(mesh.rank * vl, (mesh.rank + 1) * vl):
        ds = canonical_sort_data(splats_data[i])
        out.append(render_tiles(ds, bin_splats(ds, rcfg), rcfg))
    return torch.stack(out)
