"""Subspace adapters: per-tenant (base_seed, coords) personalization
(port of ``repro.serve.adapters``).

The paper's compression story turned into a serving product: a tenant's
entire personalization state is the d low-dimensional coordinates it
trained plus the uint32 seed its random basis regenerates from --
``4*d + 4`` bytes against ``4*D`` for a dense delta (``D/d`` ~ 1000x
for the paper's regimes).  This module holds the host-side state:

* :class:`AdapterSpec` -- the immutable (adapter_id, base_seed,
  coords[, row_sq]) payload; ``row_sq`` (per-direction squared row
  norms) rides along only when the plan uses 'exact' normalization,
  where it is part of the reproducibility contract.
* :class:`AdapterRegistry` -- id -> spec lookup with kilobyte-scale
  export/import through ``checkpoint.io.save_named``/``load_named``
  (same atomic-write + CRC32-sidecar discipline as the step
  checkpoints; a bit flip in a stored adapter is a load-time
  ValueError, not a silently wrong tenant).
* :class:`AdapterCache` -- LRU over MATERIALIZED dense packed deltas
  (device tensors), keyed by base_seed, bounded by a device-memory byte
  budget.  Every eviction is reason-coded (``EVICT_*``) so the serving
  log can distinguish capacity pressure from explicit invalidation from
  never-cacheable oversize deltas.

Which tenants deserve cache residency is a bytes-for-operations trade:
cache hits apply at the cost of one add over device memory, misses
regenerate their basis in the kernel from the seed (see ``serve.apply``)
and cost generation work but zero resident bytes.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Iterable

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io

__all__ = [
    "AdapterSpec",
    "AdapterRegistry",
    "AdapterCache",
    "EVICT_CAPACITY",
    "EVICT_EXPLICIT",
    "EVICT_OVERSIZE",
    "evict_reason_name",
]

# Eviction reason codes (logged alongside every eviction; mirrors the
# reason-code discipline of core.resilience).
EVICT_CAPACITY = 0  # LRU victim: budget pressure from a newer insert
EVICT_EXPLICIT = 1  # invalidate(): adapter updated or tenant offboarded
EVICT_OVERSIZE = 2  # single delta exceeds the whole budget; never cached

_EVICT_NAMES = {
    EVICT_CAPACITY: "capacity",
    EVICT_EXPLICIT: "explicit",
    EVICT_OVERSIZE: "oversize",
}


def evict_reason_name(code: int) -> str:
    return _EVICT_NAMES.get(code, f"unknown({code})")


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """One tenant's personalization payload.

    ``coords`` are the NORMALIZED low-dimensional coordinates in packed
    order (length ``layout.d_packed``); the dense delta they imply is
    ``-(coords * norm_factor) @ P(base_seed)``.  ``row_sq`` must be
    present iff the plan normalizes with 'exact' (the stored squared
    row norms of the tenant's basis, length ``d_packed``).
    """

    adapter_id: str
    base_seed: int
    coords: np.ndarray
    row_sq: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "base_seed", int(np.uint32(self.base_seed)))
        coords = np.ascontiguousarray(self.coords, dtype=np.float32).reshape(-1)
        object.__setattr__(self, "coords", coords)
        if self.row_sq is not None:
            row_sq = np.ascontiguousarray(self.row_sq, dtype=np.float32).reshape(-1)
            if row_sq.shape != coords.shape:
                raise ValueError(
                    f"row_sq shape {row_sq.shape} != coords shape {coords.shape}"
                )
            object.__setattr__(self, "row_sq", row_sq)

    @property
    def d(self) -> int:
        return int(self.coords.shape[0])

    @property
    def nbytes(self) -> int:
        """Wire/storage size of the payload: coords (+ row norms) + the
        4-byte seed."""
        n = self.coords.nbytes + 4
        if self.row_sq is not None:
            n += self.row_sq.nbytes
        return n

    def to_tree(self) -> dict:
        tree = {
            "base_seed": np.uint32(self.base_seed),
            "coords": self.coords,
        }
        if self.row_sq is not None:
            tree["row_sq"] = self.row_sq
        return tree

    @classmethod
    def from_tree(cls, adapter_id: str, tree: dict) -> "AdapterSpec":
        row_sq = np.asarray(tree["row_sq"]) if "row_sq" in tree else None
        return cls(
            adapter_id=adapter_id,
            base_seed=int(np.asarray(tree["base_seed"])),
            coords=np.asarray(tree["coords"]),
            row_sq=row_sq,
        )


class AdapterRegistry:
    """id -> AdapterSpec, with the invariant that base_seed is unique
    across live adapters (the seed doubles as the delta-cache key, so
    two tenants sharing a seed would alias each other's deltas)."""

    def __init__(self):
        self._specs: dict[str, AdapterSpec] = {}
        self._seed_to_id: dict[int, str] = {}

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._specs

    def ids(self) -> list[str]:
        return sorted(self._specs)

    def register(self, spec: AdapterSpec) -> None:
        owner = self._seed_to_id.get(spec.base_seed)
        if owner is not None and owner != spec.adapter_id:
            raise ValueError(
                f"base_seed {spec.base_seed} already registered to "
                f"adapter {owner!r} (seed doubles as the cache key)"
            )
        old = self._specs.get(spec.adapter_id)
        if old is not None:
            del self._seed_to_id[old.base_seed]
        self._specs[spec.adapter_id] = spec
        self._seed_to_id[spec.base_seed] = spec.adapter_id

    def get(self, adapter_id: str) -> AdapterSpec:
        try:
            return self._specs[adapter_id]
        except KeyError:
            raise KeyError(f"unknown adapter {adapter_id!r}") from None

    def remove(self, adapter_id: str) -> AdapterSpec:
        spec = self.get(adapter_id)
        del self._specs[adapter_id]
        del self._seed_to_id[spec.base_seed]
        return spec

    # -- kilobyte-scale persistence (checkpoint.io named exports) -----

    def export(self, directory: str, adapter_id: str) -> str:
        """One adapter -> ``<directory>/adapter_<id>.npz`` + CRC
        sidecar.  ~4*d bytes of payload; the basis itself is never
        stored (it regenerates from base_seed)."""
        spec = self.get(adapter_id)
        return ckpt_io.save_named(
            directory,
            spec.to_tree(),
            f"adapter_{adapter_id}",
            extra_meta={"adapter_id": adapter_id, "d": spec.d},
        )

    def export_all(self, directory: str) -> list[str]:
        return [self.export(directory, aid) for aid in self.ids()]

    @staticmethod
    def import_spec(directory: str, adapter_id: str) -> AdapterSpec:
        """Verified load (CRC per array; raises ValueError on damage)."""
        arrays, meta = ckpt_io.load_named(directory, f"adapter_{adapter_id}")
        if meta.get("adapter_id", adapter_id) != adapter_id:
            raise ValueError(
                f"export claims adapter_id {meta.get('adapter_id')!r}, "
                f"expected {adapter_id!r}"
            )
        return AdapterSpec.from_tree(adapter_id, arrays)

    def import_adapter(self, directory: str, adapter_id: str) -> AdapterSpec:
        spec = self.import_spec(directory, adapter_id)
        self.register(spec)
        return spec


class AdapterCache:
    """LRU cache of materialized per-tenant packed deltas, keyed by
    base_seed, bounded by ``budget_bytes`` of device memory.

    ``get`` refreshes recency; ``put`` inserts then evicts
    least-recently-used entries until the budget holds, recording every
    eviction as ``(seed, reason_code)``.  A delta larger than the
    entire budget is rejected up front (EVICT_OVERSIZE) rather than
    flushing the whole cache for an entry that cannot fit anyway.
    """

    def __init__(self, budget_bytes: int):
        if budget_bytes < 0:
            raise ValueError("budget_bytes must be >= 0")
        self.budget_bytes = int(budget_bytes)
        self._entries: OrderedDict[int, object] = OrderedDict()
        self._nbytes: dict[int, int] = {}
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.evictions: list[tuple[int, int]] = []

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, seed: int) -> bool:
        return int(seed) in self._entries

    def keys(self) -> Iterable[int]:
        return list(self._entries)

    @staticmethod
    def _size_of(delta) -> int:
        if isinstance(delta, torch.Tensor):
            return delta.element_size() * delta.numel()
        return int(np.dtype(delta.dtype).itemsize * int(np.prod(delta.shape)))

    def get(self, seed: int):
        """The cached delta for ``seed`` (refreshing LRU recency) or
        None on miss.  Hit/miss counters feed the serving stats."""
        seed = int(seed)
        entry = self._entries.get(seed)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(seed)
        self.hits += 1
        return entry

    def _drop(self, seed: int, reason: int) -> None:
        self._entries.pop(seed)
        self.bytes_used -= self._nbytes.pop(seed)
        self.evictions.append((seed, reason))

    def put(self, seed: int, delta) -> bool:
        """Insert a materialized delta; returns False (with an
        EVICT_OVERSIZE record) when it can never fit."""
        seed = int(seed)
        size = self._size_of(delta)
        if size > self.budget_bytes:
            self.evictions.append((seed, EVICT_OVERSIZE))
            return False
        if seed in self._entries:
            self._drop(seed, EVICT_EXPLICIT)
        self._entries[seed] = delta
        self._nbytes[seed] = size
        self.bytes_used += size
        while self.bytes_used > self.budget_bytes:
            victim = next(iter(self._entries))
            self._drop(victim, EVICT_CAPACITY)
        return True

    def invalidate(self, seed: int) -> bool:
        """Explicit removal (adapter re-trained / tenant offboarded)."""
        seed = int(seed)
        if seed not in self._entries:
            return False
        self._drop(seed, EVICT_EXPLICIT)
        return True

    def stats(self) -> dict:
        by_reason: dict[str, int] = {}
        for _, reason in self.evictions:
            name = evict_reason_name(reason)
            by_reason[name] = by_reason.get(name, 0) + 1
        return {
            "entries": len(self._entries),
            "bytes_used": self.bytes_used,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": len(self.evictions),
            "evictions_by_reason": by_reason,
        }
