"""Compartmentalization plans and the packed layout (port of
``repro.core.compartments``).

A parameter "tree" in the port is a flat mapping from the reference's
leaf names (``"layers/attn/wq"``) to tensors or shapes.  The reference
orders leaves as ``jax.tree_util.tree_flatten_with_path`` does over
nested dicts -- keys sorted at every level -- which is the order of the
names sorted by their ``/``-separated components (:func:`leaf_order`).
That order fixes every ``seed_tag``, every packed offset and every
segment seed, so it is reproduced exactly.

The packed layout's per-tile tables (``pt_*``/``rt_*``) are built with
vectorized numpy and only on request: the CUDA kernels never read them.
They read the small per-segment tables instead
(:func:`segment_tables`), and each CUDA block finds its
segment by a binary search over a prefix sum of blocks per segment.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np

# Normalizations the packed kernels support (factor-style scales).
PACKABLE_NORMALIZATIONS = ("rsqrt_dim", "exact", "none")


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Projection plan for one leaf (see the reference's ``LeafPlan``)."""

    name: str
    leaf_idx: int
    shape: tuple[int, ...]
    stacked: bool
    n_stack: int           # number of compartments carried by this leaf
    size: int              # flat size per compartment
    dim: int               # d_k per compartment
    seed_tag: int          # unique per-leaf PRNG domain separator

    @property
    def n_coeffs(self) -> int:
        return self.n_stack * self.dim


@dataclasses.dataclass(frozen=True)
class Plan:
    leaves: tuple[LeafPlan, ...]
    total_dim: int
    total_params: int
    distribution: str = "normal"
    normalization: str = "rsqrt_dim"
    flatten: bool = False
    pad: int = 0

    @property
    def reduction_factor(self) -> float:
        return self.total_params / max(self.total_dim, 1)

    @property
    def packable(self) -> bool:
        """True when the packed two-launch step supports this plan."""
        return self.normalization in PACKABLE_NORMALIZATIONS

    def packed(self, pos_block: int = 512,
               dir_block: int = 8) -> "PackedLayout":
        return packed_layout(self, pos_block, dir_block)

    def describe(self) -> str:
        """The reference's one-line-per-leaf summary, character for
        character."""
        lines = [
            f"Plan: D={self.total_params:,} -> d={self.total_dim:,} "
            f"({self.reduction_factor:.1f}x reduction), "
            f"dist={self.distribution}, norm={self.normalization}"
        ]
        for lp in self.leaves:
            lines.append(
                f"  {lp.name}: shape={lp.shape} "
                f"{'stacked L=' + str(lp.n_stack) if lp.stacked else 'single'}"
                f" Q={lp.size:,} d_k={lp.dim}"
            )
        return "\n".join(lines)


def leaf_order(names) -> list[str]:
    """Leaf names in the reference's pytree order."""
    return sorted(names, key=lambda n: n.split("/"))


def _shape_of(x) -> tuple[int, ...]:
    return tuple(int(s) for s in (x.shape if hasattr(x, "shape") else x))


def _allocate(weights: np.ndarray, total_dim: int, min_dim: int) -> np.ndarray:
    """Largest-remainder allocation of total_dim coefficients by weight."""
    w = weights / weights.sum()
    raw = w * total_dim
    dims = np.maximum(np.floor(raw).astype(int), min_dim)
    deficit = total_dim - dims.sum()
    if deficit > 0:
        order = np.argsort(-(raw - np.floor(raw)))
        for i in range(deficit):
            dims[order[i % len(dims)]] += 1
    return dims


def make_plan(
    params: Mapping[str, Any],
    total_dim: int,
    *,
    granularity: str = "layer",
    allocation: str = "proportional",
    distribution: str = "normal",
    normalization: str = "rsqrt_dim",
    is_stacked: Callable[[str], bool] | None = None,
    min_dim: int = 1,
    n_compartments: int = 1,
) -> Plan:
    """Compartment plan for a flat ``{leaf name: tensor or shape}`` map;
    the same plan the reference builds for the equivalent pytree."""
    if granularity not in ("global", "even", "leaf", "layer"):
        raise ValueError(f"unknown granularity {granularity!r}")
    if allocation not in ("proportional", "sqrt", "uniform"):
        raise ValueError(f"unknown allocation {allocation!r}")

    names = leaf_order(params)
    shapes = [_shape_of(params[n]) for n in names]

    if granularity in ("global", "even"):
        k = 1 if granularity == "global" else max(1, n_compartments)
        d_total = int(sum(int(np.prod(s, dtype=np.int64)) for s in shapes))
        pad = (-d_total) % k
        size = (d_total + pad) // k
        lp = LeafPlan(
            name="<flat>", leaf_idx=0, shape=(k, size), stacked=(k > 1),
            n_stack=k, size=size, dim=min(max(min_dim, total_dim // k),
                                          size),
            seed_tag=0,
        )
        return Plan(
            leaves=(lp,), total_dim=lp.n_coeffs, total_params=d_total,
            distribution=distribution, normalization=normalization,
            flatten=True, pad=pad,
        )

    entries = []  # (name, leaf_idx, shape, stacked, n_stack, size)
    for i, (name, shape) in enumerate(zip(names, shapes)):
        stacked = (
            granularity == "layer"
            and is_stacked is not None
            and is_stacked(name)
            and len(shape) >= 2
        )
        if stacked:
            n_stack = shape[0]
            size = int(np.prod(shape[1:], dtype=np.int64))
        else:
            n_stack = 1
            size = int(np.prod(shape, dtype=np.int64))
        entries.append((name, i, shape, stacked, n_stack, size))

    total_params = sum(n * s for *_, n, s in entries)
    if allocation == "proportional":
        weights = np.array([n * s for *_, n, s in entries], dtype=np.float64)
    elif allocation == "sqrt":
        weights = np.sqrt(np.array([n * s for *_, n, s in entries],
                                   dtype=np.float64))
    else:
        weights = np.ones(len(entries), dtype=np.float64)

    budgets = _allocate(weights, total_dim, min_dim)
    plans = []
    for (name, idx, shape, stacked, n_stack, size), budget in zip(entries,
                                                                  budgets):
        dim = max(min_dim, int(round(budget / n_stack)))
        dim = min(dim, size)  # never more directions than parameters
        plans.append(LeafPlan(name=name, leaf_idx=idx, shape=shape,
                              stacked=stacked, n_stack=n_stack, size=size,
                              dim=dim, seed_tag=idx))
    return Plan(
        leaves=tuple(plans),
        total_dim=sum(p.n_coeffs for p in plans),
        total_params=total_params,
        distribution=distribution,
        normalization=normalization,
    )


def make_even_plan(n_params: int, n_compartments: int, total_dim: int, *,
                   distribution: str = "normal",
                   normalization: str = "rsqrt_dim") -> Plan:
    """Plan for K even compartments over one flattened vector (paper Fig.
    4): a single ``"flat"`` leaf of shape (K, n_params / K) whose stack
    axis is the compartment axis.  The caller flattens the parameters."""
    if n_params % n_compartments != 0:
        raise ValueError(
            f"even plan requires K | D (got D={n_params}, K={n_compartments}); "
            "pad the flattened vector first"
        )
    size = n_params // n_compartments
    dim = max(1, total_dim // n_compartments)
    lp = LeafPlan(name="flat", leaf_idx=0, shape=(n_compartments, size),
                  stacked=True, n_stack=n_compartments, size=size,
                  dim=min(dim, size), seed_tag=0)
    return Plan(leaves=(lp,), total_dim=lp.n_coeffs, total_params=n_params,
                distribution=distribution, normalization=normalization)


# ---------------------------------------------------------------------------
# packed layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class PackedLayout:
    """Host-side static description of the packed two-launch step (see
    the reference's ``PackedLayout``): each segment's parameters are
    zero-padded to a multiple of ``pos_block`` in one ``(q_packed,)``
    buffer, its coordinates to a multiple of ``dir_block`` in one
    ``(d_packed,)`` buffer."""

    pos_block: int
    dir_block: int
    n_segments: int
    q_packed: int
    d_packed: int
    seg_leaf: np.ndarray      # index into plan.leaves
    seg_layer: np.ndarray     # layer index within the (possibly) stacked leaf
    seg_size: np.ndarray      # valid parameter count Q_k
    seg_dim: np.ndarray       # valid coefficient count d_k
    seg_psize: np.ndarray     # Q_k padded to pos_block
    seg_pdim: np.ndarray      # d_k padded to dir_block
    seg_param_off: np.ndarray  # segment start in the packed parameter buffer
    seg_coord_off: np.ndarray  # segment start in the packed coordinate buffer
    coord_valid: np.ndarray   # (d_packed,) 1.0 on live slots, 0.0 on padding
    coord_inv_sqrt_q: np.ndarray  # rsqrt_dim factors per slot (0 on padding)

    @property
    def n_proj_tiles(self) -> int:
        return int(((self.seg_pdim // self.dir_block)
                    * (self.seg_psize // self.pos_block)).sum())

    @property
    def n_recon_tiles(self) -> int:
        return self.n_proj_tiles

    # -- the reference's per-tile tables, built on request ----------------

    @functools.cached_property
    def _proj_tiles(self) -> dict[str, np.ndarray]:
        return self._tiles(position_innermost=True)

    @functools.cached_property
    def _recon_tiles(self) -> dict[str, np.ndarray]:
        return self._tiles(position_innermost=False)

    def _tiles(self, *, position_innermost: bool) -> dict[str, np.ndarray]:
        """Linearized (segment, dir-block, pos-block) tiles: position-
        innermost per (segment, dir-block) for the projection,
        direction-innermost per (segment, pos-block) for the apply."""
        pb, db = self.pos_block, self.dir_block
        n_di = self.seg_pdim // db
        n_pj = self.seg_psize // pb
        counts = n_di * n_pj
        seg = np.repeat(np.arange(self.n_segments, dtype=np.int64), counts)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        local = np.arange(int(counts.sum()), dtype=np.int64) - start[seg]
        if position_innermost:
            di, pj = local // n_pj[seg], local % n_pj[seg]
            init = pj == 0
        else:
            pj, di = local // n_di[seg], local % n_di[seg]
            init = di == 0
        return {
            "seg": seg.astype(np.int32),
            "row0": (di * db).astype(np.uint32),
            "col0": (pj * pb).astype(np.uint32),
            "gblk": (self.seg_param_off[seg] // pb + pj).astype(np.int32),
            "cblk": (self.seg_coord_off[seg] // db + di).astype(np.int32),
            "init": init.astype(np.int32),
            "q": self.seg_size[seg].astype(np.int32),
        }

    pt_seg = property(lambda self: self._proj_tiles["seg"])
    pt_row0 = property(lambda self: self._proj_tiles["row0"])
    pt_col0 = property(lambda self: self._proj_tiles["col0"])
    pt_gblk = property(lambda self: self._proj_tiles["gblk"])
    pt_ublk = property(lambda self: self._proj_tiles["cblk"])
    pt_init = property(lambda self: self._proj_tiles["init"])
    pt_q = property(lambda self: self._proj_tiles["q"])
    rt_seg = property(lambda self: self._recon_tiles["seg"])
    rt_row0 = property(lambda self: self._recon_tiles["row0"])
    rt_col0 = property(lambda self: self._recon_tiles["col0"])
    rt_gblk = property(lambda self: self._recon_tiles["gblk"])
    rt_sblk = property(lambda self: self._recon_tiles["cblk"])
    rt_init = property(lambda self: self._recon_tiles["init"])
    rt_q = property(lambda self: self._recon_tiles["q"])

    @functools.cached_property
    def param_valid(self) -> np.ndarray:
        """(q_packed,) 1.0 on live parameter slots, 0.0 on padding."""
        out = np.zeros((self.q_packed,), np.float32)
        for off, size in zip(self.seg_param_off, self.seg_size):
            out[off: off + size] = 1.0
        return out


@functools.lru_cache(maxsize=32)
def segment_tables(layout: PackedLayout, pos_chunk: int
                   ) -> dict[str, np.ndarray]:
    """Small (n_segments,)-sized tables for the kernels.

    ``size``/``psize``/``pdim``/``param_off``/``coord_off`` describe each
    segment; ``proj_blocks`` is the prefix sum (n_segments + 1 entries) of
    projection blocks per segment -- one block per (dir-block, chunk of
    ``pos_chunk`` consecutive pos-blocks) -- and ``recon_blocks`` the
    prefix sum of apply blocks, one per pos-block."""
    n_pj = layout.seg_psize // layout.pos_block
    n_chunk = -(-n_pj // pos_chunk)
    n_di = layout.seg_pdim // layout.dir_block
    return {
        "size": layout.seg_size.astype(np.int64),
        "psize": layout.seg_psize.astype(np.int64),
        "pdim": layout.seg_pdim.astype(np.int32),
        "param_off": layout.seg_param_off.astype(np.int64),
        "coord_off": layout.seg_coord_off.astype(np.int64),
        "n_chunk": n_chunk.astype(np.int32),
        "proj_blocks": np.concatenate(
            [[0], np.cumsum(n_di * n_chunk)]).astype(np.int64),
        "recon_blocks": np.concatenate(
            [[0], np.cumsum(n_pj)]).astype(np.int64),
    }


@functools.lru_cache(maxsize=32)
def packed_layout(plan: Plan, pos_block: int = 512,
                  dir_block: int = 8) -> PackedLayout:
    """Precompute the packed layout for a plan (host-side, vectorized)."""
    n_stack = np.array([lp.n_stack for lp in plan.leaves], np.int64)
    seg_leaf = np.repeat(np.arange(len(plan.leaves)), n_stack).astype(
        np.int32)
    seg_layer = np.concatenate(
        [np.arange(n) for n in n_stack]).astype(np.int32)
    seg_size = np.repeat([lp.size for lp in plan.leaves], n_stack).astype(
        np.int64)
    seg_dim = np.repeat([lp.dim for lp in plan.leaves], n_stack).astype(
        np.int64)

    seg_psize = -(-seg_size // pos_block) * pos_block
    seg_pdim = -(-seg_dim // dir_block) * dir_block
    seg_param_off = np.concatenate([[0], np.cumsum(seg_psize)[:-1]])
    seg_coord_off = np.concatenate([[0], np.cumsum(seg_pdim)[:-1]])
    d_packed = int(seg_pdim.sum())

    slot = np.arange(d_packed, dtype=np.int64)
    seg_of_slot = np.searchsorted(seg_coord_off, slot, side="right") - 1
    within = slot - seg_coord_off[seg_of_slot]
    coord_valid = (within < seg_dim[seg_of_slot]).astype(np.float32)
    coord_inv_sqrt_q = coord_valid / np.sqrt(
        seg_size[seg_of_slot].astype(np.float64)).astype(np.float32)

    return PackedLayout(
        pos_block=pos_block,
        dir_block=dir_block,
        n_segments=int(seg_leaf.shape[0]),
        q_packed=int(seg_psize.sum()),
        d_packed=d_packed,
        seg_leaf=seg_leaf,
        seg_layer=seg_layer,
        seg_size=seg_size,
        seg_dim=seg_dim,
        seg_psize=seg_psize.astype(np.int64),
        seg_pdim=seg_pdim.astype(np.int64),
        seg_param_off=seg_param_off.astype(np.int64),
        seg_coord_off=seg_coord_off.astype(np.int64),
        coord_valid=coord_valid,
        coord_inv_sqrt_q=coord_inv_sqrt_q,
    )


# ---------------------------------------------------------------------------
# model-axis sharded packed layout (slab-resident theta)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPackedLayout:
    """The packed layout split into ``n_shards`` theta slabs over a model
    axis (see the reference's ``ShardedPackedLayout``).

    Each rank of the model group owns one contiguous ``q_slab``-float slab
    of the packed parameter buffer, zero-padded from ``base.q_packed`` to
    ``q_padded = n_shards * q_slab``; slab boundaries snap to
    ``pos_block``, so shard ``i`` owns the pos-blocks ``[i *
    blocks_per_shard, (i + 1) * blocks_per_shard)``.  Coordinates,
    optimizer state and the exchange stay (d_packed,)-replicated; only
    theta is sharded.

    The kernels read the base layout's per-segment tables and the slab's
    window (:func:`sharded_segment_tables`).  The reference's stacked
    per-shard tile tables (``pt_*``/``rt_*``, (n_shards, n_tiles)) are
    built with numpy on request only, for the parity tests."""

    base: PackedLayout
    n_shards: int
    q_slab: int               # per-rank slab length (pos_block-aligned)
    q_padded: int             # n_shards * q_slab >= base.q_packed
    blocks_per_shard: int

    pos_block = property(lambda self: self.base.pos_block)
    dir_block = property(lambda self: self.base.dir_block)
    n_segments = property(lambda self: self.base.n_segments)
    d_packed = property(lambda self: self.base.d_packed)
    coord_valid = property(lambda self: self.base.coord_valid)
    coord_inv_sqrt_q = property(lambda self: self.base.coord_inv_sqrt_q)

    def slab_range(self, shard: int) -> tuple[int, int]:
        """``[start, stop)`` of shard ``shard``'s slab in the padded
        buffer."""
        return shard * self.q_slab, (shard + 1) * self.q_slab

    def seg_windows(self, shard: int) -> tuple[np.ndarray, np.ndarray]:
        """Per segment, the ``[lo, hi)`` columns (segment-local, live
        positions only) that lie in shard ``shard``'s slab; ``lo == hi``
        where the segment has none there."""
        b = self.base
        start, stop = self.slab_range(shard)
        lo = np.clip(start - b.seg_param_off, 0, b.seg_size)
        hi = np.clip(stop - b.seg_param_off, 0, b.seg_size)
        return lo, np.maximum(hi, lo)

    def live_values(self, shard: int) -> int:
        """Live basis values one pass generates for shard ``shard``."""
        lo, hi = self.seg_windows(shard)
        return int((self.base.seg_dim * (hi - lo)).sum())

    def generated_values(self, shard: int) -> int:
        """Basis values one pass generates for shard ``shard`` (8-row
        dir-blocks, padded rows included)."""
        lo, hi = self.seg_windows(shard)
        return int((self.base.seg_pdim * (hi - lo)).sum())

    @functools.cached_property
    def param_valid(self) -> np.ndarray:
        """(n_shards, q_slab) validity rows: the base's plus a zero
        tail."""
        return np.concatenate([
            self.base.param_valid,
            np.zeros(self.q_padded - self.base.q_packed, np.float32),
        ]).reshape(self.n_shards, self.q_slab)

    # -- the reference's stacked per-shard tile tables, built on request --

    @functools.cached_property
    def _stacked(self) -> dict[str, np.ndarray]:
        return _sharded_tile_tables(self)

    pt_seg = property(lambda self: self._stacked["pt_seg"])
    pt_row0 = property(lambda self: self._stacked["pt_row0"])
    pt_col0 = property(lambda self: self._stacked["pt_col0"])
    pt_gblk = property(lambda self: self._stacked["pt_gblk"])
    pt_ublk = property(lambda self: self._stacked["pt_ublk"])
    pt_init = property(lambda self: self._stacked["pt_init"])
    pt_q = property(lambda self: self._stacked["pt_q"])
    rt_seg = property(lambda self: self._stacked["rt_seg"])
    rt_row0 = property(lambda self: self._stacked["rt_row0"])
    rt_col0 = property(lambda self: self._stacked["rt_col0"])
    rt_gblk = property(lambda self: self._stacked["rt_gblk"])
    rt_sblk = property(lambda self: self._stacked["rt_sblk"])
    rt_init = property(lambda self: self._stacked["rt_init"])
    rt_q = property(lambda self: self._stacked["rt_q"])

    @property
    def n_proj_tiles(self) -> int:
        return int(self.pt_seg.shape[1])

    @property
    def n_recon_tiles(self) -> int:
        return int(self.rt_seg.shape[1])

    def worker_tables(self, k_workers: int) -> "ShardedWorkerReconTables":
        return sharded_worker_recon_tables(self, k_workers)


@functools.lru_cache(maxsize=32)
def sharded_packed_layout(layout: PackedLayout,
                          n_shards: int) -> ShardedPackedLayout:
    """Split a packed layout into ``n_shards`` pos_block-aligned slabs."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    bps = -(-(layout.q_packed // layout.pos_block) // n_shards)
    q_slab = bps * layout.pos_block
    return ShardedPackedLayout(base=layout, n_shards=n_shards,
                               q_slab=q_slab, q_padded=n_shards * q_slab,
                               blocks_per_shard=bps)


@functools.lru_cache(maxsize=64)
def sharded_segment_tables(slayout: ShardedPackedLayout, shard: int,
                           pos_chunk: int) -> dict[str, np.ndarray]:
    """Shard ``shard``'s window over the base segment tables, for the
    sharded projection kernel.

    The projection grid is the unsharded one (one CUDA block per
    (segment, dir-block, chunk of ``pos_chunk`` pos-blocks)) restricted
    to the chunks that meet the slab: segment s contributes
    ``n_chunk[s]`` chunks from ``chunk_lo[s]`` on, each clipped to the
    live columns ``[col_lo[s], col_hi[s])``.  A segment with no column
    in the slab keeps one empty chunk per dir-block, so every coordinate
    of the partial is written (zero) and one sum over the model group
    completes it.  ``proj_blocks`` is the prefix sum of the blocks."""
    if not 0 <= shard < slayout.n_shards:
        raise ValueError(f"shard {shard} outside [0, {slayout.n_shards})")
    b = slayout.base
    pb = b.pos_block
    lo, hi = slayout.seg_windows(shard)
    live = hi > lo
    # pos-blocks of the window, segment-local: [lo // pb, ceil(hi / pb))
    first = lo // pb
    last = -(-hi // pb)
    chunk_lo = np.where(live, first // pos_chunk, 0)
    n_chunk = np.where(live, -(-last // pos_chunk) - chunk_lo, 1)
    n_di = b.seg_pdim // b.dir_block
    return {
        "col_lo": np.where(live, lo, 0).astype(np.int64),
        "col_hi": np.where(live, hi, 0).astype(np.int64),
        "chunk_lo": chunk_lo.astype(np.int32),
        "n_chunk": n_chunk.astype(np.int32),
        "proj_blocks": np.concatenate(
            [[0], np.cumsum(n_di * n_chunk)]).astype(np.int64),
    }


def _sharded_tile_tables(slayout: ShardedPackedLayout
                         ) -> dict[str, np.ndarray]:
    """The reference's stacked per-shard tile tables (its
    ``sharded_packed_layout`` body, vectorized per shard): projection
    tiles of the slab with a first-LOCAL-visit init plus zero-init no-ops
    for absent coordinate blocks; apply tiles of the slab's whole
    (segment, pos-block) groups plus q=0 passthrough tiles for its
    padding blocks; each shard length-padded with q=0/init=0 copies of
    its last tile."""
    b = slayout.base
    bps = slayout.blocks_per_shard
    d_blocks = b.d_packed // b.dir_block
    names = ("seg", "row0", "col0", "gblk", "blk", "init", "q")
    proj, recon = [], []
    for s in range(slayout.n_shards):
        lo, hi = s * bps, (s + 1) * bps
        idx = np.flatnonzero((b.pt_gblk >= lo) & (b.pt_gblk < hi))
        ublk = b.pt_ublk[idx].astype(np.int64)
        init = np.zeros(idx.shape[0], np.int64)
        if idx.size:
            init[np.unique(ublk, return_index=True)[1]] = 1
        missing = np.setdiff1d(np.arange(d_blocks, dtype=np.int64), ublk)
        z = np.zeros(missing.shape[0], np.int64)
        proj.append([
            np.concatenate([b.pt_seg[idx], z]),
            np.concatenate([b.pt_row0[idx], z]),
            np.concatenate([b.pt_col0[idx], z]),
            np.concatenate([b.pt_gblk[idx].astype(np.int64) - lo, z]),
            np.concatenate([ublk, missing]),
            np.concatenate([init, np.ones_like(z)]),
            np.concatenate([b.pt_q[idx], z]),
        ])
        idx = np.flatnonzero((b.rt_gblk >= lo) & (b.rt_gblk < hi))
        gblk = b.rt_gblk[idx].astype(np.int64) - lo
        missing = np.setdiff1d(np.arange(bps, dtype=np.int64), gblk)
        z = np.zeros(missing.shape[0], np.int64)
        recon.append([
            np.concatenate([b.rt_seg[idx], z]),
            np.concatenate([b.rt_row0[idx], z]),
            np.concatenate([b.rt_col0[idx], z]),
            np.concatenate([gblk, missing]),
            np.concatenate([b.rt_sblk[idx], z]),
            np.concatenate([b.rt_init[idx], np.ones_like(z)]),
            np.concatenate([b.rt_q[idx], z]),
        ])
    dtypes = (np.int32, np.uint32, np.uint32, np.int32, np.int32, np.int32,
              np.int32)
    out = {}
    for prefix, blk, shards in (("pt", "ublk", proj), ("rt", "sblk", recon)):
        n = max(c[0].shape[0] for c in shards)
        shards = [_pad_tile_rows(c, n) for c in shards]
        for i, (name, dtype) in enumerate(zip(names, dtypes)):
            key = f"{prefix}_{blk if name == 'blk' else name}"
            out[key] = np.stack([c[i] for c in shards]).astype(dtype)
    return out


def _pad_tile_rows(cols: list[np.ndarray], n_tiles: int) -> list[np.ndarray]:
    """Length-pad a shard's 7 tile columns (init at 5, q at 6) to
    ``n_tiles`` rows with q=0/init=0 copies of its last tile."""
    cur = int(cols[0].shape[0])
    out = [np.concatenate([c.astype(np.int64),
                           np.repeat(c[-1:].astype(np.int64), n_tiles - cur)])
           for c in cols]
    out[5][cur:] = 0
    out[6][cur:] = 0
    return out


class ShardedWorkerReconTables(NamedTuple):
    """Per-shard K-worker apply tiles, stacked to (n_shards, n_tiles):
    each shard's apply tiles with every (segment, pos-block) group
    repeated K times, worker in the middle, directions innermost, the
    init flag on worker 0 only (the reference's
    ``_expand_worker_groups``).  ``seed_idx`` indexes the worker-major
    (K * n_segments,) seed table, ``sblk`` the (K * d_packed / 8)
    coordinate blocks."""

    seed_idx: np.ndarray
    row0: np.ndarray
    col0: np.ndarray
    q: np.ndarray
    init: np.ndarray
    gblk: np.ndarray
    sblk: np.ndarray

    @property
    def n_tiles(self) -> int:
        return int(self.seed_idx.shape[1])


def _expand_worker_groups(cols: dict[str, np.ndarray], n_segments: int,
                          d_blocks: int, k_workers: int
                          ) -> list[np.ndarray]:
    """Repeat every (segment, pos-block) group of apply tiles -- a run
    starting at an init flag -- K times, worker in the middle."""
    init = cols["init"]
    starts = np.flatnonzero(init == 1)
    lengths = np.diff(np.append(starts, init.shape[0]))
    span = np.repeat(lengths, lengths * k_workers)   # group length per tile
    offset = (np.arange(init.shape[0] * k_workers)
              - np.repeat(starts * k_workers, lengths * k_workers))
    worker = offset // span
    tile = np.repeat(starts, lengths * k_workers) + offset % span
    return [
        worker * n_segments + cols["seg"][tile],
        cols["row0"][tile],
        cols["col0"][tile],
        cols["q"][tile],
        np.where(worker == 0, init[tile], 0),
        cols["gblk"][tile],
        worker * d_blocks + cols["sblk"][tile],
    ]


@functools.lru_cache(maxsize=32)
def sharded_worker_recon_tables(slayout: ShardedPackedLayout,
                                k_workers: int) -> ShardedWorkerReconTables:
    """Worker-expand every shard's apply tiles (host-side, on request)."""
    if k_workers < 1:
        raise ValueError(f"k_workers must be >= 1, got {k_workers}")
    d_blocks = slayout.d_packed // slayout.dir_block
    per = [_expand_worker_groups(
        {k: getattr(slayout, f"rt_{k}")[s].astype(np.int64)
         for k in ("seg", "row0", "col0", "q", "init", "gblk", "sblk")},
        slayout.n_segments, d_blocks, k_workers)
        for s in range(slayout.n_shards)]
    dtypes = (np.int32, np.uint32, np.uint32, np.int32, np.int32, np.int32,
              np.int32)
    return ShardedWorkerReconTables(*(
        np.stack([p[i] for p in per]).astype(dt)
        for i, dt in enumerate(dtypes)))
