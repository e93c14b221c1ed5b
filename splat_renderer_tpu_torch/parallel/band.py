"""Depth-band splat-parallel compositing: shard the binning and the blend.

Counterpart of `splat_renderer_tpu/parallel/band.py`.  The tile-band mode
(parallel/sharding.py) all-gathers the whole splat set and shards the
pixels: every rank projects all N splats and bins those that reach its
band.  This mode shards the splats themselves by global depth:

1. each rank models and projects its n / sp splats (packed words);
2. a 256-bucket histogram of the depth keys, summed over the group, is cut
   into sp near-equal global depth bands (`depth_band`);
3. one `all_to_all_single` routes every record to its band's rank, in a
   static (sp, n_local) masked layout: slots of other bands carry the
   sentinel key 0xFFFFFFFF, and records culled by the projection are not
   routed;
4. each rank bins its band, compacted to a fixed capacity
   (`bin_packed_words(compact_to=)`), so the pair-scale work is about 1/sp
   of the frame's, and blends it into per-tile premultiplied partials;
5. the partials are all-gathered and folded in band order with the
   associative `over_merge`.

Why this is exact: band b holds a contiguous range of the canonical
(depth key, global input index) order, so every record of band b
composites before every record of band b + 1 in every tile, and the fold
reproduces the single-device composite.  Equal keys never straddle a band
(the cut compares whole buckets), and the in-band tie-break is the global
input index: row s of the received (sp, n_local) block came from rank s, so
the flat row index is the rank-major input index.  Each band's blend stops
a pixel at its own transmittance floor, so the frame equals the
single-device one within float rounding only with the early exit off
(rcfg.transmittance_eps = 0); with it on, the floor bounds the difference.

The stages run under spans (`utils.profiling.span`, "band/..."), so a
recording (`utils.profiling.recording`) or a trace (`utils.profiling.trace`)
of a frame splits its time by stage.

A band keeps at most ceil(band_slack * n / sp) records; the deepest ones
of an over-full band are dropped and flagged in the stats, never garbage.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .._torch_util import check_device
from ..camera import CameraArrays
from ..config import PointConfig, RenderConfig
from ..points.properties import Splats
from ..render.binning import bin_packed_words
from ..render.blend import over_merge
from ..render.compositor import tiles_to_image
from ..render.packing import U32_MASK, as_int32_bits
from ..render.pipeline import model_points
from ..render.projector import splat_screen_words
from ..sdf.scene import Params, SDFScene
from ..utils.profiling import span
from .sharding import Mesh, all_gather_into, rank_generator

N_BUCKETS = 256
INF_KEY = 0xFF800000  # packing.depth_bits(+inf): culled records
SENTINEL = 0xFFFFFFFF  # routing slots of another band
WORDS = ("dk", "w_pos", "w_ro", "w_rgb")


def depth_band(dk: torch.Tensor, group: Optional[dist.ProcessGroup], sp: int) -> torch.Tensor:
    """Assign each local record (int64 depth keys, `packing.depth_bits`) a
    global depth band in [0, sp) (int64).

    The keys' range over the group (all_reduce MIN) is cut into 256 equal
    key-space buckets; the bucket histogram is summed over the group
    (all_reduce SUM) and its cumulative counts are cut into sp near-equal
    bands: band k starts at the first bucket whose cumulative count
    reaches k/sp of the total.  Culled records go to the last bucket.
    `sp` is the band count, which need not be the group's size.  The float
    steps round as the JAX package's do (`rel * 256 / span`, two
    roundings; the cut at `total * (k / sp)` in float32), so the bands
    are bit-equal to its `depth_band`; counts up to 2**24 are exact in
    float32 there."""
    valid = dk < INF_KEY
    # one MIN reduction carries the max as its negation
    ext = torch.stack([torch.where(valid, dk, INF_KEY).min(), -torch.where(valid, dk, 0).max()])
    dist.all_reduce(ext, op=dist.ReduceOp.MIN, group=group)
    mn, mx = ext[0], -ext[1]
    span = torch.clamp(mx - mn, min=1).to(torch.float32)
    rel = (torch.where(valid, dk, mn) - mn).to(torch.float32)
    bucket = torch.clamp((rel * float(N_BUCKETS) / span).to(torch.int32), 0, N_BUCKETS - 1)
    bucket = torch.where(valid, bucket, N_BUCKETS - 1).to(torch.int64)
    hist = torch.bincount(bucket, minlength=N_BUCKETS)
    dist.all_reduce(hist, group=group)
    cum = torch.cumsum(hist, 0).to(torch.float32)
    total = cum[-1]
    band = torch.zeros_like(bucket)
    for k in range(1, sp):
        target = total * torch.tensor(k / sp, dtype=torch.float32, device=dk.device)
        split_bucket = (cum < target).sum()
        band = band + (bucket >= split_bucket).to(torch.int64)
    return band


def band_words(words: torch.Tensor, band: torch.Tensor, b: int) -> torch.Tensor:
    """(4, m) word columns (dk, w_pos, w_ro, w_rgb; int64) with every slot
    that does not hold a visible record of band b replaced by the routing
    sentinel (key 0xFFFFFFFF, words 0): the row that band b's rank
    receives from the rank holding these records."""
    keep = (band == b) & (words[0] < INF_KEY)
    sentinel = torch.tensor([SENTINEL, 0, 0, 0], dtype=words.dtype, device=words.device)
    return torch.where(keep[None, :], words, sentinel[:, None])


def fold_bands(colors: Sequence[torch.Tensor], alphas: Sequence[torch.Tensor]):
    """Fold per-band partials front to back (band 0 is the nearest)."""
    out_c, out_a = colors[0], alphas[0]
    for c, a in zip(colors[1:], alphas[1:]):
        out_c, out_a = over_merge(out_c, out_a, c, a)
    return out_c, out_a


class BandFrame:
    """The frame step of `band_frame_fn`, on one rank.

    `frame(params, camera, seed)` models this rank's n / sp points from
    `rank_generator(seed, rank)`; `frame.from_splats(local, camera)` takes
    them instead.  Both return (image (H, W, 3), the same on every rank,
    stats), stats = {"band_overflow": bool, "band_max_count",
    "routed_records", "valid_records"} (0-dim tensors, the same on every
    rank).  `frame.wire_model` gives the bytes each rank moves per frame."""

    def __init__(self, scene: SDFScene, mesh: Mesh, n: int, pcfg: PointConfig,
                 rcfg: RenderConfig, band_slack: float = 1.5):
        sp = mesh.size
        if n % sp:
            raise ValueError(f"point count {n} must be divisible by sp={sp}")
        self.scene, self.mesh, self.pcfg, self.rcfg = scene, mesh, pcfg, rcfg
        self.sp = sp
        self.n_local = n // sp
        self.capacity = max(1, int(math.ceil(band_slack * self.n_local)))
        # per-frame wire volumes of the two collectives' buffers: 4 u32 words
        # a routed slot; 3 colour + 1 alpha float32 a tile pixel
        self.wire_model = {
            "sp": sp,
            "n_local": self.n_local,
            "a2a_egress_bytes_per_device": (sp - 1) * self.n_local * 4 * 4,
            "gather_ingress_bytes_per_device": (
                (sp - 1) * rcfg.num_tiles * rcfg.tile_pixels * 4 * 4
            ),
        }

    def __call__(self, params: Params, camera: CameraArrays, seed: int):
        mesh = self.mesh
        g = rank_generator(seed, mesh.rank, mesh.device)
        local = model_points(self.scene, params, g, self.n_local, self.pcfg, self.rcfg,
                             device=mesh.device)
        return self.from_splats(local, camera)

    def from_splats(self, local: Splats, camera: CameraArrays):
        from ..ops.tile_blend import blend_tiles

        mesh, sp, rcfg = self.mesh, self.sp, self.rcfg
        check_device(mesh.device, **{f"splats[{k!r}]": t for k, t in local.items()},
                     view_proj=camera["view_proj"])
        with span("band/project"):
            w = splat_screen_words(local, camera["view_proj"], camera["cam_pos"], rcfg)
            words = torch.stack([w[k] for k in WORDS])  # (4, n_local) int64
        with span("band/depth_band"):
            band = depth_band(words[0], mesh.group, sp)

        with span("band/route"):
            # the (sp, 4, n_local) layout: block b goes to rank b, which gets
            # block s from rank s; u32 bit patterns on the wire (16 B a slot)
            send = as_int32_bits(torch.stack([band_words(words, band, b) for b in range(sp)]))
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=mesh.group)
            received = (recv.to(torch.int64) & U32_MASK).transpose(0, 1).reshape(4, -1)

        # this band's capacity nearest records, binned and blended into
        # premultiplied partials (no background)
        with span("band/bin"):
            n_valid = (received[0] < INF_KEY).sum()
            binned = bin_packed_words(*received, rcfg, compact_to=self.capacity)
        with span("band/blend"):
            tile_color, tile_alpha = blend_tiles(binned, rcfg)
        with span("band/merge"):
            mine = torch.cat([tile_color, tile_alpha[..., None]], dim=-1)  # (T, tp, 4)
            parts = torch.empty((sp * mine.shape[0],) + tuple(mine.shape[1:]),
                                dtype=mine.dtype, device=mine.device)
            all_gather_into(parts, mine, group=mesh.group)
            parts = parts.reshape((sp,) + tuple(mine.shape))
            img = tiles_to_image(*fold_bands(parts[..., :3], parts[..., 3]), rcfg)

        with span("band/stats"):
            valid = words[0] < INF_KEY
            max_count = n_valid.reshape(1)
            dist.all_reduce(max_count, op=dist.ReduceOp.MAX, group=mesh.group)
            sums = torch.stack([(valid & (band != mesh.rank)).sum(), valid.sum()])
            dist.all_reduce(sums, group=mesh.group)
        return img, {
            "band_overflow": max_count[0] > self.capacity,
            "band_max_count": max_count[0],
            "routed_records": sums[0],
            "valid_records": sums[1],
        }


def band_frame_fn(
    scene: SDFScene,
    mesh: Mesh,
    n: int,
    pcfg: PointConfig,
    rcfg: RenderConfig,
    band_slack: float = 1.5,
) -> BandFrame:
    """The depth-band splat-parallel frame step over every rank of the mesh
    as one flat sp axis (`BandFrame`).  band_slack sizes each band's record
    capacity (ceil(band_slack * n / sp))."""
    return BandFrame(scene, mesh, n, pcfg, rcfg, band_slack)
