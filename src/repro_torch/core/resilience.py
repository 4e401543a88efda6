"""Coordinate-replay resilience (port of ``repro.core.resilience``):
micro-checkpoints, a non-finite step guard, a replica-divergence sentinel
and seeded fault injection for the packed two-launch RBD step.

One optimizer step is fully determined by ``(base_seed, step,
post-exchange coordinate buffer)`` -- kilobytes, not gigabytes:

* :class:`ReplayLog` -- an append-only, CRC-framed log of the
  post-exchange packed coordinates (and squared row norms when the step
  has them), byte for byte the reference's format.  Full snapshots are
  SPARSE; :func:`recover` restores the newest valid one and replays the
  logged updates through ``SubspaceOptimizer.apply_exchanged``, the code
  the live step runs after its exchange, so the resumed state is
  bit-identical to the uninterrupted run.  No gradient is recomputed:
  each record is one reconstruct-apply launch.
* the non-finite step guard -- :func:`guard_transition` and the
  ``REASON_*`` codes.  The optimizer checks the (d,)-sized coordinate
  buffers (a NaN or Inf anywhere in the gradient reaches the projection),
  rejects the step with the parameters and optimizer state untouched,
  counts it and backs the effective learning rate off by scaling the
  post-optimizer coordinates.  The decision stays on the device: every
  value here is a 0-d tensor, never read by the host inside the step.
* the replica-divergence sentinel -- :func:`state_checksum` folds the
  replicated coordinate-space state into a 16-bit integer-valued float32
  scalar that survives a mean over up to 256 ranks exactly, so it rides
  the one coordinate exchange as one extra element.  Repair is
  :func:`resync_from_worker0`, one broadcast a buffer from rank 0 of the
  data group, run only after a detection.
* :class:`FaultPlan` -- deterministic, seedable fault injection: NaN/Inf
  into the packed gradient, corruption of a received exchange payload, or
  a host-side kill (:class:`SimulatedWorkerKill`).  The step counter is a
  host integer in the port, so the injectors decide on the host which
  step they hit; the value they write is the reference's.

On the model-sharded slabs (``SubspaceOptimizer.model_axis``) all of it
runs on each rank's slab: the sentinel's share of the slab rides the
model group's completion all-reduce (:func:`sentinel_words`), so every
rank of the mesh folds one whole-buffer checksum; a snapshot holds the
whole (q_padded,) buffer, gathered over the writer's model group
(:func:`snapshot_params`); :func:`recover` hands each rank its own slab of
it and replays the log on that slab.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import struct
import warnings
import zlib
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.transforms import _map, leaves

# ---------------------------------------------------------------------------
# reason codes (every recovery path is reason-coded)
# ---------------------------------------------------------------------------

REASON_OK = 0
REASON_NONFINITE_LOCAL = 1  # local projection produced NaN/Inf coords
REASON_NONFINITE_EXCHANGE = 2  # post-exchange buffer non-finite
REASON_REPLICA_DIVERGENCE = 3  # sentinel checksums disagree
REASON_CKPT_CORRUPT = 4  # snapshot failed CRC/sidecar validation
REASON_LOG_TRUNCATED = 5  # torn replay-log tail dropped
REASON_RESYNC = 6  # state re-broadcast from worker 0
REASON_WORKER_KILLED = 7  # simulated kill (fault harness)

_REASON_NAMES = {
    REASON_OK: "ok",
    REASON_NONFINITE_LOCAL: "nonfinite_local",
    REASON_NONFINITE_EXCHANGE: "nonfinite_exchange",
    REASON_REPLICA_DIVERGENCE: "replica_divergence",
    REASON_CKPT_CORRUPT: "ckpt_corrupt",
    REASON_LOG_TRUNCATED: "log_truncated",
    REASON_RESYNC: "resync_from_worker0",
    REASON_WORKER_KILLED: "worker_killed",
}


def reason_name(code) -> str:
    return _REASON_NAMES.get(int(code), f"unknown({int(code)})")


class ReplicaDivergenceError(RuntimeError):
    """Hard-failure mode of the divergence sentinel."""


class SimulatedWorkerKill(RuntimeError):
    """Raised by the fault harness to simulate a mid-run worker death."""


# ---------------------------------------------------------------------------
# non-finite step guard
# ---------------------------------------------------------------------------


class GuardConfig(NamedTuple):
    """LR-backoff policy of the non-finite step guard.  All three values
    are powers of two times small integers, so the float32 scale
    arithmetic (and the ``scale == 1.0`` fixed point) is exact."""

    backoff: float = 0.5  # scale multiplier on a rejected step
    recovery: float = 1.25  # scale multiplier on an accepted step
    min_scale: float = 0.015625  # floor (1/64) of the effective-LR scale


class GuardState(NamedTuple):
    nonfinite_count: torch.Tensor  # int32, total rejected steps
    lr_scale: torch.Tensor  # float32, effective-LR multiplier in (0, 1]
    last_reason: torch.Tensor  # int32, REASON_* of the last step


def guard_init(device=None) -> GuardState:
    return GuardState(
        nonfinite_count=torch.zeros((), dtype=torch.int32, device=device),
        lr_scale=torch.ones((), dtype=torch.float32, device=device),
        last_reason=torch.zeros((), dtype=torch.int32, device=device),
    )


def _reason_tensor(reason, device) -> torch.Tensor:
    if isinstance(reason, torch.Tensor):
        return reason.to(torch.int32)
    # a fill on the device, not a host-to-device copy
    return torch.full((), int(reason), dtype=torch.int32, device=device)


def guard_transition(cfg: GuardConfig, state: GuardState, reason) -> GuardState:
    """A rejected step (``reason != OK``) backs the effective-LR scale off
    by ``cfg.backoff`` (floored at ``cfg.min_scale``) and counts the event;
    an accepted one recovers the scale by ``cfg.recovery`` (capped at
    exactly 1.0, a fixed point: a healthy run multiplies its coordinates by
    exactly 1.0, bit-identically to no guard at all).  Device tensors in,
    device tensors out."""
    reason = _reason_tensor(reason, state.lr_scale.device)
    ok = reason == REASON_OK
    scale = torch.where(
        ok,
        torch.clamp_max(state.lr_scale * cfg.recovery, 1.0),
        torch.clamp_min(state.lr_scale * cfg.backoff, cfg.min_scale),
    )
    count = state.nonfinite_count + torch.logical_not(ok).to(torch.int32)
    return GuardState(nonfinite_count=count, lr_scale=scale, last_reason=reason)


def all_finite(*arrays) -> torch.Tensor:
    """0-d bool tensor: every element of every non-None tensor is finite
    (on the device; nothing is read by the host)."""
    ok = None
    for a in arrays:
        if a is not None:
            f = torch.isfinite(a).all()
            ok = f if ok is None else torch.logical_and(ok, f)
    return torch.ones((), dtype=torch.bool) if ok is None else ok


# ---------------------------------------------------------------------------
# replica-divergence sentinel
# ---------------------------------------------------------------------------

# elements summed at a time: each chunk widens to int64 on its own (the
# sum's dtype conversion copies its input), so the sgd rider over the
# whole packed buffer never holds an int64 copy of it
_CHECKSUM_CHUNK = 1 << 24


def _tree_leaves(tree) -> list:
    """The tensors of a tree in the reference's ``tree_leaves`` order:
    NamedTuple fields in order, dict keys sorted, sequences in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _bits_sum(x: torch.Tensor) -> torch.Tensor:
    """int64 sum of the leaf's 32-bit words (float bit patterns, or the
    integers themselves): equal modulo 2**32 to the reference's uint32
    sum, whose words agree with these as signed and unsigned."""
    x = x.detach()
    flat = x.reshape(-1)
    if x.is_floating_point():
        flat = flat.to(torch.float32).view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, flat.numel(), _CHECKSUM_CHUNK):
        total = total + flat[i: i + _CHECKSUM_CHUNK].sum(dtype=torch.int64)
    return total


def state_checksum(tree) -> torch.Tensor:
    """16-bit wraparound checksum of a tree, as an integer-valued float32
    0-d tensor.

    Float leaves contribute their exact bit patterns, so any single-ulp
    divergence (and -0.0 against 0.0) flips the sum.  The 16-bit fold keeps
    a sum over ranks below 2**24: a mean over K <= 256 ranks is exact in
    float32 whenever all inputs agree, so ``mean(c) != c`` is a sound
    divergence test with no false positives."""
    total = None
    for leaf in _tree_leaves(tree):
        s = _bits_sum(torch.as_tensor(leaf))
        total = s if total is None else total + s.to(total.device)
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return _fold(total)


def _fold(total: torch.Tensor) -> torch.Tensor:
    """An int64 word sum -> its 16-bit wraparound fold, as float32."""
    total = total & 0xFFFFFFFF
    folded = (total ^ (total >> 16)) & 0xFFFF
    return folded.to(torch.float32)


def sentinel_rider(opt_state, packed_params) -> torch.Tensor:
    """The scalar that rides the coordinate exchange: checksum of the
    replicated coordinate-space optimizer state when it has tensor leaves
    (momentum/adam), else of the packed parameter buffer (sgd is
    stateless, but its parameters must stay replicated all the same)."""
    if _tree_leaves(opt_state):
        return state_checksum(opt_state)
    return state_checksum(packed_params)


def sentinel_words(opt_state, slab) -> torch.Tensor:
    """This rank's share of the sentinel on the model-sharded slabs: a
    (2,) float32 tensor that rides the model group's completion
    all-reduce (summed there, with the coordinates' partial sums).

    sgd: the 32-bit word sum of this rank's slab modulo 2**32, as its low
    and high 16-bit halves.  Each half summed over m <= 256 ranks stays
    below 2**24, so the sum is exact in float32, and
    :func:`sentinel_rider_of_words` reassembles the word sum of the whole
    padded buffer -- whose padding words are zero, so its fold is the
    unsharded step's rider.  momentum / adam: the replicated state's
    checksum (:func:`state_checksum`) and a zero; the completed sum is m
    times the checksum when the group agrees.  Either way every rank of
    the model group folds the same rider, so a slab or a state that
    diverges on one rank is seen by every data group: all ranks of the
    mesh reach one verdict with no collective added."""
    if _tree_leaves(opt_state):
        c = state_checksum(opt_state)
        return torch.stack([c, torch.zeros_like(c)])
    w = _bits_sum(slab) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16]).to(torch.float32)


def sentinel_rider_of_words(words, m: int, opt_state) -> torch.Tensor:
    """The rider every rank of a model group of ``m`` folds from the
    group's summed :func:`sentinel_words`: the whole buffer's checksum
    (sgd), or the mean of the ranks' state checksums (momentum / adam:
    the reference's rider when the group agrees, a value off every
    checksum's integer grid or off the other groups' when it does not)."""
    if _tree_leaves(opt_state):
        return words[0] / m
    w = words.to(torch.int64)
    return _fold(w[0] + (w[1] << 16))


def sentinel_check(local, exchanged, step, every: int) -> torch.Tensor:
    """0-d bool tensor: this step is a sentinel step (``step % every ==
    0``, decided on the host: the port's step counter is a host integer)
    AND the exchanged checksum(s) disagree with the local one.
    ``exchanged`` is the mean over the group (shared_basis) or the
    gathered (K,) vector (independent_bases)."""
    if exchanged.dim():
        mismatch = torch.any(exchanged != local)
    else:
        mismatch = exchanged != local
    if int(step) % int(every) != 0:
        return torch.zeros_like(mismatch)
    return mismatch


def resync_from_worker0(tree, axis_name):
    """Reason-coded repair (REASON_RESYNC): every rank adopts rank 0's copy
    of ``tree``, one broadcast a tensor over the data group (counted as
    ``distributed.COLLECTIVES["resync"]``).  A state-sized exchange: run it
    AFTER the sentinel fires, never inside the step (the per-step exchange
    stays at one collective).  Host integers are already equal on every
    rank and pass through.  Returns a tree of fresh tensors."""
    from repro_torch.core import distributed

    group = distributed.process_group(axis_name)
    src = dist.get_global_rank(group, 0) if group is not dist.group.WORLD \
        else 0

    def broadcast(node):
        if not isinstance(node, torch.Tensor):
            return node
        buf = node.detach().clone().contiguous()
        dist.broadcast(buf, src=src, group=group)
        distributed.COLLECTIVES["resync"] += 1
        return buf

    return _map(broadcast, tree)


# ---------------------------------------------------------------------------
# seeded fault injection
# ---------------------------------------------------------------------------

FAULT_KINDS = ("nan_grad", "inf_grad", "corrupt_collective", "kill")


class FaultEvent(NamedTuple):
    step: int  # rbd step index at which the fault fires
    kind: str  # one of FAULT_KINDS
    worker: int = 0  # targeted worker (rank in the data group / stacked row)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault schedule.  The injectors key on the rbd step
    counter (a host integer); ``kill`` events are host-side
    (:meth:`kill_steps` + :class:`SimulatedWorkerKill`)."""

    events: tuple = ()

    @classmethod
    def single(cls, step: int, kind: str, worker: int = 0) -> "FaultPlan":
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        return cls((FaultEvent(step, kind, worker),))

    @classmethod
    def from_seed(
        cls,
        seed: int,
        n_steps: int,
        *,
        kinds=FAULT_KINDS,
        n_events: int = 3,
        k_workers: int = 1,
    ) -> "FaultPlan":
        """Seeded random schedule over ``n_steps`` steps x ``k_workers``
        workers: the reference's events for the same arguments."""
        r = random.Random(int(seed))
        events = sorted(
            FaultEvent(
                r.randrange(n_steps), r.choice(tuple(kinds)), r.randrange(k_workers)
            )
            for _ in range(n_events)
        )
        return cls(tuple(events))

    def of(self, *kinds: str) -> tuple:
        return tuple(e for e in self.events if e.kind in kinds)

    def without(self, *kinds: str) -> "FaultPlan":
        """A copy without the given kinds (the resume harness drops the
        already-fired ``kill`` so recovery does not re-die)."""
        return FaultPlan(tuple(e for e in self.events if e.kind not in kinds))

    def kill_steps(self) -> tuple:
        return tuple(e.step for e in self.of("kill"))


def inject_grad_faults(plan, step, packed_grads, worker_index=None):
    """NaN/Inf into element 0 of the packed gradient buffer on the event's
    step.  ``worker_index`` (this rank's index in the data group) targets
    one rank; with the sequential simulation's stacked (K, q) gradients
    the event's worker row is hit instead.  Functional: the input is
    cloned before a write, and left alone on a step no event hits."""
    if plan is None:
        return packed_grads
    g = packed_grads
    step = int(step)
    for ev in plan.of("nan_grad", "inf_grad"):
        if step != ev.step:
            continue
        if worker_index is not None and int(worker_index) != ev.worker:
            continue
        bad = float("nan") if ev.kind == "nan_grad" else float("inf")
        g = g.clone() if g is packed_grads else g
        if worker_index is None and g.dim() == 2:
            g[ev.worker, 0] = bad
        else:
            g[0] = bad
    return g


def inject_collective_faults(plan, step, coords, worker_index):
    """Corruption of a RECEIVED exchange payload: on the event's step the
    targeted rank's post-exchange coordinate buffer gets an Inf in element
    0 (of every row), as if its incoming link flipped bits.  Other ranks
    see clean data -- the divergence seed the sentinel exists to catch."""
    if plan is None:
        return coords
    for ev in plan.of("corrupt_collective"):
        if int(step) == ev.step and int(worker_index) == ev.worker:
            coords = coords.clone()
            coords[..., 0] = float("inf")
    return coords


# ---------------------------------------------------------------------------
# coordinate replay log (append-only, CRC-framed)
# ---------------------------------------------------------------------------


class ReplayRecord(NamedTuple):
    step: int  # rbd step index the record reproduces
    reason: int  # REASON_* the guard assigned to that step
    lr_scale: float  # informational (replay re-derives it)
    coords: Optional[np.ndarray]  # post-exchange coords; None = rejected
    row_sq: Optional[np.ndarray]  # squared row norms (when the step has them)


class RecoveryEvent(NamedTuple):
    step: int
    reason: int
    detail: str = ""


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


class ReplayLog:
    """Append-only CRC-framed coordinate log, byte for byte the
    reference's format.

    Layout: ``MAGIC | u32 meta_len | meta_json | u32 crc32(meta)`` then
    per record ``REC | body | u32 crc32(body)`` with
    ``body = u32 step | u32 reason | f32 lr_scale | u32 nbytes |
    payload``.  The payload is the float32 bytes of the post-exchange
    coordinate buffer (followed by its squared row norms when the step
    carries them); a rejected step logs an EMPTY payload -- its replay
    applies the same sanitized zeros the live step applied.  Reading stops
    (with a warning) at the first torn or corrupt frame; appending to an
    existing log truncates that torn tail first."""

    MAGIC = b"RBDRLOG1"
    REC = b"REC0"

    def __init__(self, path: str, *, meta: Optional[dict] = None, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        if os.path.exists(path) and os.path.getsize(path):
            existing, _, end, truncated = self._read_raw(path)
            if truncated:
                warnings.warn(
                    f"{path}: torn tail truncated before append", stacklevel=2
                )
            self.meta = existing
            self._fh = open(path, "r+b")
            self._fh.truncate(end)
            self._fh.seek(end)
        else:
            if meta is None:
                raise ValueError("a new replay log needs meta")
            self.meta = dict(meta)
            blob = json.dumps(self.meta, sort_keys=True).encode("utf-8")
            self._fh = open(path, "wb")
            self._fh.write(
                self.MAGIC
                + struct.pack("<I", len(blob))
                + blob
                + struct.pack("<I", zlib.crc32(blob))
            )
            self._flush()

    def append(self, step: int, reason: int, lr_scale: float, coords=None, row_sq=None):
        parts = []
        if coords is not None:
            parts.append(np.asarray(_to_numpy(coords), np.float32).tobytes())
            if row_sq is not None:
                parts.append(np.asarray(_to_numpy(row_sq), np.float32).tobytes())
        payload = b"".join(parts)
        body = struct.pack(
            "<IIfI", int(step), int(reason), float(lr_scale), len(payload)
        )
        body += payload
        self._fh.write(self.REC + body + struct.pack("<I", zlib.crc32(body)))
        self._flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _flush(self):
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    # -- reading ------------------------------------------------------------

    @classmethod
    def _read_raw(cls, path: str):
        """(meta, [(step, reason, lr_scale, payload_bytes)], end_offset,
        truncated) -- stops at the first bad frame."""
        with open(path, "rb") as fh:
            blob = fh.read()
        hdr = len(cls.MAGIC)
        if len(blob) < hdr + 4 or not blob.startswith(cls.MAGIC):
            raise ValueError(f"{path}: not a replay log (bad magic)")
        (mlen,) = struct.unpack_from("<I", blob, hdr)
        off = hdr + 4
        meta_raw = blob[off : off + mlen]
        off += mlen
        if len(meta_raw) != mlen or off + 4 > len(blob):
            raise ValueError(f"{path}: corrupt replay-log header")
        (mcrc,) = struct.unpack_from("<I", blob, off)
        off += 4
        if zlib.crc32(meta_raw) != mcrc:
            raise ValueError(f"{path}: replay-log header CRC mismatch")
        meta = json.loads(meta_raw.decode("utf-8"))
        raw, end, truncated = [], off, False
        n = len(blob)
        while off < n:
            try:
                if blob[off : off + 4] != cls.REC:
                    raise ValueError("bad record magic")
                body_off = off + 4
                step, reason, lr_scale, nbytes = struct.unpack_from(
                    "<IIfI", blob, body_off
                )
                payload_off = body_off + 16
                crc_off = payload_off + nbytes
                if crc_off + 4 > n:
                    raise ValueError("short record")
                (crc,) = struct.unpack_from("<I", blob, crc_off)
                if zlib.crc32(blob[body_off:crc_off]) != crc:
                    raise ValueError("record CRC mismatch")
            except (struct.error, ValueError):
                truncated = True
                break
            raw.append((step, reason, lr_scale, blob[payload_off:crc_off]))
            off = crc_off + 4
            end = off
        return meta, raw, end, truncated

    @classmethod
    def read(cls, path: str):
        """(meta, [ReplayRecord], truncated) -- truncated=True means a
        torn/corrupt tail was dropped (warned, reason-coded upstream)."""
        meta, raw, _, truncated = cls._read_raw(path)
        if truncated:
            warnings.warn(
                f"{path}: torn replay-log tail ignored "
                f"({len(raw)} valid records kept)",
                stacklevel=2,
            )
        shape = tuple(meta["coords_shape"])
        has_norms = bool(meta.get("has_norms", True))
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        records = []
        for step, reason, lr_scale, payload in raw:
            coords = row_sq = None
            if payload:
                flat = np.frombuffer(payload, np.float32)
                expected = count * (2 if has_norms else 1)
                if flat.size != expected:
                    raise ValueError(
                        f"{path}: record {step} payload has {flat.size} "
                        f"floats, meta expects {expected}"
                    )
                coords = flat[:count].reshape(shape)
                if has_norms:
                    row_sq = flat[count:].reshape(shape)
            records.append(ReplayRecord(step, reason, lr_scale, coords, row_sq))
        return meta, records, truncated


def replay_meta(sub_opt) -> dict:
    """Replay-log metadata for a SubspaceOptimizer's packed step (the
    reference's keys and values, so the two packages write one header)."""
    t = sub_opt.transform
    plan = t.plan
    d = plan.packed().d_packed
    joint = sub_opt.joint_subspace
    return {
        "format": 1,
        "base_seed": int(t.base_seed),
        "optimizer": sub_opt.optimizer,
        "mode": sub_opt.mode,
        "normalization": plan.normalization,
        "k_workers": int(sub_opt.k_workers),
        "d_packed": int(d),
        "coords_shape": [int(sub_opt.k_workers), int(d)] if joint else [int(d)],
        "has_norms": bool((not joint) or plan.normalization == "exact"),
    }


# ---------------------------------------------------------------------------
# recovery: restore snapshot + replay coordinates (no gradients)
# ---------------------------------------------------------------------------


def _device_of(params) -> torch.device:
    return leaves(params)[0].device


def _sharded(sub_opt, params) -> bool:
    """Whether ``params`` is the stored form of the model-sharded slabs:
    this rank's (q_slab,) slab, or the list of a group's slabs in turn."""
    if isinstance(params, (list, tuple)):
        return True
    slayout = sub_opt.sharded_layout()
    return (slayout is not None and isinstance(params, torch.Tensor)
            and params.shape[-1] != slayout.q_padded)


def snapshot_params(sub_opt, params):
    """The stored parameters as a snapshot holds them: on the slabs the
    whole (q_padded,) buffer, the reference's ``prepare_params`` shape --
    a list of slabs (in turn) concatenated, this rank's slab all-gathered
    over its model group (one D-sized collective, counted in
    ``distributed.SNAPSHOT_COLLECTIVES``; every rank of the group calls
    it at the same step); anything else as it is."""
    from repro_torch.core import distributed

    if not _sharded(sub_opt, params):
        return params
    if isinstance(params, (list, tuple)):
        return torch.cat(list(params))
    full = params.new_empty((sub_opt.sharded_layout().q_padded,))
    return distributed.all_gather_slabs(full, params, sub_opt.model_axis,
                                        snapshot=True)


def _restore_template(sub_opt, state):
    """``state`` with the params a snapshot holds (shape, dtype and device
    only: no memory behind the (q_padded,) slab template)."""
    if not _sharded(sub_opt, state.params):
        return state
    like = leaves(state.params)[0]
    full = like.new_zeros(()).expand(sub_opt.sharded_layout().q_padded)
    return state._replace(params=full)


def _stored_like(sub_opt, full, like):
    """A snapshot's (q_padded,) buffer -> the stored form of ``like``:
    this rank's slab, or every slab of the group in turn."""
    if not _sharded(sub_opt, like):
        return full
    if isinstance(like, (list, tuple)):
        return [sub_opt.slab_of(full, s).clone() for s in range(len(like))]
    return sub_opt.slab_of(full).clone()


def replay_records(sub_opt, state, records):
    """Apply logged coordinate records on top of ``state`` through
    ``SubspaceOptimizer.apply_exchanged`` -- the post-exchange code the
    live step runs, so replay is bit-exact by construction: one
    reconstruct-apply launch a record, no projection, no collective.  On
    the model-sharded slabs each rank replays the records on its own slab
    (the shards in turn: on each slab of the list), one slab apply a
    record a slab.  Returns ``(new_state, n_applied)``."""
    if not records:
        return state, 0
    guarded = sub_opt.guard is not None
    has_norms = (not sub_opt.joint_subspace) or (
        sub_opt.transform.plan.normalization == "exact"
    )
    device = _device_of(state.params)
    params = state.params
    rbd = state.rbd_state
    opt_state = state.opt_state
    guard = getattr(state, "guard", ())
    zeros = None
    n = 0
    for rec in records:
        if rec.coords is None:
            if not guarded:
                raise ValueError(
                    "rejected-step record in an unguarded replay "
                    f"(step {rec.step}, reason {reason_name(rec.reason)})"
                )
            if zeros is None:
                zeros = sub_opt._coord_template(
                    device, sub_opt.plan_execution())
            coords = zeros
            sq = torch.ones_like(zeros) if has_norms else None
        else:
            coords = torch.from_numpy(np.array(rec.coords)).to(device)
            sq = (
                torch.from_numpy(np.array(rec.row_sq)).to(device)
                if rec.row_sq is not None
                else None
            )
        reason = _reason_tensor(rec.reason, device) if guarded else None
        params, rbd, opt_state, guard = sub_opt.apply_exchanged(
            params, coords, sq, rbd, opt_state, guard_state=guard, reason=reason
        )
        n += 1
    new_state = state._replace(
        params=params, rbd_state=rbd, opt_state=opt_state, step=state.step + n
    )
    if hasattr(state, "guard"):
        new_state = new_state._replace(guard=guard)
    return new_state, n


def skip_batches(data, n: int):
    """Advance a data stream past ``n`` already-consumed batches: O(1)
    through a counter stream's ``skip(n)``
    (:class:`repro_torch.data.synthetic.CounterStream`), else n throwaway
    ``next()`` calls; either way the (n+1)-th batch of the resumed stream
    equals the (n+1)-th batch of an uninterrupted one."""
    if n <= 0:
        return data
    skip = getattr(data, "skip", None)
    if callable(skip):
        skip(n)
        return data
    for _ in range(n):
        next(data)
    return data


def recover(cfg, sub_opt, template_state):
    """Restore the newest VALID snapshot under ``cfg.directory`` and replay
    the coordinate log forward.  ``template_state`` is the fresh init state
    (the restore template, and the replay base when the log starts at step
    0 and no snapshot exists yet).  On the model-sharded slabs every rank
    reads the whole (q_padded,) buffer of the snapshot and keeps its own
    slab (the shards in turn: every slab), then replays on it.  Returns
    ``(state, info)``; ``state`` is None when there is nothing to recover.
    Every degraded path lands a reason-coded :class:`RecoveryEvent` in
    ``info['events']``."""
    from repro_torch.checkpoint import io as ckpt_io

    info = {
        "snapshot_step": None,
        "replayed": 0,
        "truncated": False,
        "events": [],
    }
    if not cfg.directory:
        return None, info
    snap_dir = os.path.join(cfg.directory, "snapshots")
    log_path = os.path.join(cfg.directory, "replay.log")
    steps = ckpt_io.valid_steps(snap_dir) if os.path.isdir(snap_dir) else []
    if os.path.isdir(snap_dir):
        n_skipped = len(
            [f for f in os.listdir(snap_dir) if f.endswith(".npz")]
        ) - len(steps)
        if n_skipped > 0:
            info["events"].append(
                RecoveryEvent(
                    max(steps) if steps else -1,
                    REASON_CKPT_CORRUPT,
                    f"{n_skipped} corrupt/partial snapshot(s) skipped",
                )
            )
    state = None
    for s in sorted(steps, reverse=True):
        # newest intact snapshot wins; a structurally valid pair that fails
        # payload/CRC verification is reason-coded and skipped -- the log
        # replays the extra distance from an older snapshot
        try:
            state = ckpt_io.restore(
                snap_dir, _restore_template(sub_opt, template_state), s)
            state = state._replace(params=_stored_like(
                sub_opt, state.params, template_state.params))
        except (ValueError, OSError) as e:
            info["events"].append(
                RecoveryEvent(
                    s,
                    REASON_CKPT_CORRUPT,
                    f"snapshot step {s} failed verification ({e}); "
                    "falling back to an older one",
                )
            )
            continue
        info["snapshot_step"] = s
        break
    records = []
    if os.path.exists(log_path):
        _, records, truncated = ReplayLog.read(log_path)
        info["truncated"] = truncated
        if truncated:
            info["events"].append(
                RecoveryEvent(
                    records[-1].step if records else -1,
                    REASON_LOG_TRUNCATED,
                    "torn replay-log tail dropped",
                )
            )
    if state is None:
        if not records:
            return None, info
        # log exists but no usable snapshot: replay from the fresh init
        state = template_state
    base = int(state.step)
    todo = [r for r in records if r.step >= base]
    run = []
    for i, rec in enumerate(todo):
        if rec.step != base + i:
            info["events"].append(
                RecoveryEvent(
                    rec.step,
                    REASON_LOG_TRUNCATED,
                    f"non-contiguous record (expected step {base + i}); "
                    "replay stops here",
                )
            )
            break
        run.append(rec)
    state, n = replay_records(sub_opt, state, run)
    info["replayed"] = n
    return state, info


# ---------------------------------------------------------------------------
# config + host-side monitor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """One switchboard for every resilience feature.  ``directory`` turns
    on the replay log + sparse snapshots; ``guard`` the non-finite step
    guard; ``sentinel_every`` the divergence sentinel (0 = off);
    ``fault_plan`` the injection harness (tests only)."""

    directory: Optional[str] = None
    snapshot_every: int = 50
    guard: Optional[GuardConfig] = None
    sentinel_every: int = 0
    on_divergence: str = "fail"  # "fail" | "repair" (launcher resyncs)
    fault_plan: Optional[FaultPlan] = None
    fsync: bool = True

    @property
    def any_enabled(self) -> bool:
        return bool(
            self.directory
            or self.guard
            or self.sentinel_every
            or self.fault_plan
        )


def _host_snapshot(state) -> Any:
    """A TrainState with its host step counters as the reference's int32
    ``step`` and uint32 ``rbd_state.step``, so a snapshot restores in
    either package (the checkpoint writer copies the tensors to the
    host, as the reference's ``jax.device_get`` does)."""
    rbd = state.rbd_state
    if hasattr(rbd, "step"):
        state = state._replace(rbd_state=rbd._replace(step=np.uint32(rbd.step)))
    return state._replace(step=np.int32(state.step))


class ResilienceMonitor:
    """Host-side companion of the guarded train step: appends replay
    records, writes sparse snapshots, accumulates reason-coded
    :class:`RecoveryEvent`s, and raises :class:`ReplicaDivergenceError` in
    the hard-failure mode.  Call :meth:`observe` after every step with the
    post-step state and the step's metrics dict.

    Over a data group of several ranks only its rank 0 writes the log and
    the snapshots: the coordinate state and theta are replicated over the
    group, so one writer is enough (every rank reads them on resume).  On
    the model-sharded slabs the writer is data index 0 and model index 0;
    at a snapshot step every rank of its model group gathers its slab
    into the whole buffer the writer saves (:func:`snapshot_params`)."""

    def __init__(self, cfg: ResilienceConfig, sub_opt):
        from repro_torch.core import distributed

        self.cfg = cfg
        self.sub_opt = sub_opt
        self.events: list = []
        self.log: Optional[ReplayLog] = None
        first_data = (not distributed.is_group(sub_opt.axis_name)
                      or distributed.axis_index(sub_opt.axis_name) == 0)
        # the writer's model group gathers the slabs for a snapshot
        self.gathers = bool(cfg.directory) and first_data
        self.writer = first_data and (
            not distributed.is_group(sub_opt.model_axis)
            or distributed.axis_index(sub_opt.model_axis) == 0)
        if cfg.directory and self.writer:
            os.makedirs(self.snapshot_dir, exist_ok=True)
            self.log = ReplayLog(
                os.path.join(cfg.directory, "replay.log"),
                meta=replay_meta(sub_opt),
                fsync=cfg.fsync,
            )

    @property
    def snapshot_dir(self) -> str:
        return os.path.join(self.cfg.directory, "snapshots")

    def should_kill(self, step: int) -> bool:
        plan = self.cfg.fault_plan
        return plan is not None and any(
            e.step == step for e in plan.of("kill")
        )

    def snapshot(self, state) -> Optional[str]:
        """RAW packed TrainState snapshot (params stay packed: replay
        operates on the stored representation; slabs are gathered into
        the (q_padded,) buffer first), copied to the host.  Returns the
        path, or None on a rank that only gathered."""
        from repro_torch.checkpoint import io as ckpt_io

        state = state._replace(
            params=snapshot_params(self.sub_opt, state.params))
        if not self.writer:
            return None
        return ckpt_io.save(
            self.snapshot_dir, _host_snapshot(state), int(state.step)
        )

    def observe(self, state, metrics, *, step: Optional[int] = None) -> list:
        """Returns the new RecoveryEvents for this step (also kept on
        ``self.events``).  ``step``: the 0-based step index (default
        ``state.step - 1``)."""
        step = int(state.step) - 1 if step is None else int(step)
        new: list = []
        reason = int(metrics.get("guard_reason", REASON_OK))
        lr_scale = float(metrics.get("guard_lr_scale", 1.0))
        if reason != REASON_OK:
            new.append(
                RecoveryEvent(
                    step,
                    reason,
                    f"step rejected ({reason_name(reason)}); "
                    f"effective-lr scale -> {lr_scale:g}",
                )
            )
        if self.log is not None:
            if reason == REASON_OK:
                self.log.append(
                    step,
                    reason,
                    lr_scale,
                    coords=metrics["replay_coords"],
                    row_sq=metrics.get("replay_row_sq"),
                )
            else:
                self.log.append(step, reason, lr_scale)
        every = self.cfg.snapshot_every
        if self.gathers and every and (step + 1) % every == 0:
            self.snapshot(state)
        if bool(metrics.get("sentinel_diverged", False)):
            new.append(
                RecoveryEvent(
                    step,
                    REASON_REPLICA_DIVERGENCE,
                    "coordinate-state checksums disagree across workers",
                )
            )
        self.events.extend(new)
        if any(e.reason == REASON_REPLICA_DIVERGENCE for e in new):
            if self.cfg.on_divergence == "fail":
                raise ReplicaDivergenceError(
                    f"replica divergence detected at step {step} "
                    "(sentinel checksum mismatch)"
                )
        return new


__all__ = [
    "REASON_OK",
    "REASON_NONFINITE_LOCAL",
    "REASON_NONFINITE_EXCHANGE",
    "REASON_REPLICA_DIVERGENCE",
    "REASON_CKPT_CORRUPT",
    "REASON_LOG_TRUNCATED",
    "REASON_RESYNC",
    "REASON_WORKER_KILLED",
    "reason_name",
    "ReplicaDivergenceError",
    "SimulatedWorkerKill",
    "GuardConfig",
    "GuardState",
    "guard_init",
    "guard_transition",
    "all_finite",
    "state_checksum",
    "sentinel_rider",
    "sentinel_check",
    "resync_from_worker0",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "inject_grad_faults",
    "inject_collective_faults",
    "ReplayRecord",
    "RecoveryEvent",
    "ReplayLog",
    "replay_meta",
    "replay_records",
    "skip_batches",
    "recover",
    "ResilienceConfig",
    "ResilienceMonitor",
]
