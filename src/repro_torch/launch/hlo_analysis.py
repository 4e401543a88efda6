"""Analysis of one traced step: kernel ops, collectives and their
payloads, flops, bytes and memory (port of ``repro.launch.hlo_analysis``).

The reference reads XLA's optimized HLO (collective payloads weighted by
while-loop trip counts) and the traced jaxpr (``pallas_call`` and
collective sites).  PyTorch has neither: here the function runs once,
eagerly, under a dispatch mode (:class:`StepTracer`) that sees every op
the step dispatches -- on ``meta`` tensors in the dry run's fake world
(:mod:`repro_torch.launch.dryrun`; nothing is computed or allocated), or
on CPU or CUDA tensors.  Each hand-written kernel is one op of the
``repro_torch`` namespace (``torch.ops.repro_torch.<name>``, registered
by the kernel modules), each collective one ``c10d`` op.  A Python loop
runs every trip, so every count is of the unrolled step and no trip
count is needed; the reference's static site counts and this module's
executed counts agree wherever a site is not inside a loop, which is the
contract the tests hold (two launches, one coordinate-sized collective).
On the CPU a wrapper takes its kernel's plain version and no op is
dispatched, so kernel counts need meta (or CUDA) tensors.

* :func:`trace` -- one run of ``fn`` under the tracer: a :class:`Trace`.
* :func:`count_kernel_calls` (alias :func:`count_pallas_calls`) -- the
  number of ``repro_torch`` op calls.
* :func:`collective_sites` -- ``(primitive, payload elements)`` of every
  c10d op, named by the reference's jaxpr primitives (:data:`C10D_OPS`).
* :func:`assert_coordinate_exchange` -- the paper's communication
  contract, the reference's parameters and assertions.
* :func:`collective_bytes` -- per-device result bytes by the reference's
  five HLO collective kinds.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels.rbd_step import OP_NAMESPACE

# c10d op -> (the reference's HLO kind, its jaxpr primitive, the argument
# holding the input (whose elements are the payload, as the reference
# counts a primitive's invars), the argument holding the result (whose
# bytes an HLO line's result shape gives)).  Every all-reduce of the port
# is a SUM (a pmean is a SUM and a divide, as jax lowers ``pmean`` to
# ``psum``); the resilience repair's broadcast from rank 0 is the
# reference's ``all_gather(x)[0]``.  An op not listed raises.
C10D_OPS = {
    "allreduce_": ("all-reduce", "psum", 0, 0),
    "allreduce_coalesced_": ("all-reduce", "psum", 0, 0),
    "allgather_": ("all-gather", "all_gather", 1, 0),
    "_allgather_base_": ("all-gather", "all_gather", 1, 0),
    "allgather_coalesced_": ("all-gather", "all_gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", "all_gather", 1, 0),
    "broadcast_": ("all-gather", "all_gather", 0, 0),
    "reduce_scatter_": ("reduce-scatter", "reduce_scatter", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", "reduce_scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "reduce_scatter",
                                         1, 0),
    "alltoall_": ("all-to-all", "all_to_all", 1, 0),
    "alltoall_base_": ("all-to-all", "all_to_all", 1, 0),
    "send": ("collective-permute", "ppermute", 0, 0),
    "recv_": ("collective-permute", "ppermute", 0, 0),
}

# cards of one NVLink domain (one H100 node): a group whose ranks lie in
# more than one such block crosses nodes
NODE_SIZE = 8


class Collective(NamedTuple):
    """One executed collective."""

    op: str              # the c10d op (``allreduce_``)
    kind: str            # the reference's HLO kind (``all-reduce``)
    primitive: str       # the reference's jaxpr primitive (``psum``)
    elements: int        # payload elements (the input's)
    result_bytes: int    # bytes of the result on this rank
    group_size: int      # ranks in the group
    crosses_nodes: bool  # the group's ranks span more than one node


@dataclasses.dataclass
class Trace:
    """What one run of a function dispatched."""

    kernel_calls: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    flops: int = 0                # FlopCounterMode's formulas; 0 for a
                                  # kernel op (no formula, as a Pallas call
                                  # without a cost estimate)
    bytes_accessed: int = 0       # every non-view op's inputs + outputs
    argument_bytes: int = 0       # the arguments' storages
    output_bytes: int = 0         # the result's storages
    peak_bytes: int = 0           # live storages at their largest
    n_ops: int = 0
    seconds: float = 0.0
    result: Any = None

    @property
    def temp_bytes(self) -> int:
        """The peak beyond the arguments (XLA's ``temp_size_in_bytes``)."""
        return self.peak_bytes - self.argument_bytes


def _tensors(x) -> list:
    """The tensors in ``x``: a tensor, or (nested) lists, tuples and dicts
    of them (an op's arguments and outputs)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        out = []
        for y in x:
            if isinstance(y, torch.Tensor):
                out.append(y)
            elif isinstance(y, (list, tuple, dict)):
                out.extend(_tensors(y))
        return out
    if isinstance(x, dict):
        return _tensors(list(x.values()))
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` on the device (0 for a tensor on the host: the step's
    host-side work, e.g. seed folding, moves no device bytes)."""
    if t.device.type == "cpu":
        return 0
    return t.numel() * t.element_size()


def _storage_bytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


class StepTracer(TorchDispatchMode):
    """Records kernel ops, collectives, flops, bytes and live memory of
    the ops dispatched while active.  Live memory is the bytes of every
    distinct device storage alive: the arguments' (:meth:`hold`) and every
    op output's until it is freed (a weak reference on its storage).
    Bytes and memory leave out tensors on the host; flops count every op,
    as ``FlopCounterMode`` does."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self._class: dict = {}
        self.trace = Trace()
        self._seen: set = set()
        self._live = 0

    # -- memory -------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "cpu":      # device memory only
            return
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._seen:
            return
        size = storage.nbytes()
        self._seen.add(key)
        self._live += size
        self.trace.peak_bytes = max(self.trace.peak_bytes, self._live)
        weakref.finalize(storage, self._free, key, size)

    def _free(self, key, size) -> None:
        self._seen.discard(key)
        self._live -= size

    def hold(self, args) -> None:
        """Count ``args``' storages as live from the start (the arguments
        of the traced function)."""
        before = self._live
        for t in _tensors(args):
            self._track(t)
        self.trace.argument_bytes += self._live - before

    # -- collectives --------------------------------------------------
    def _collective(self, func, args, kwargs) -> None:
        name = func._opname
        if name not in C10D_OPS:
            raise NotImplementedError(
                f"c10d op {func} is not in hlo_analysis.C10D_OPS: its kind "
                "and payload are unknown, and a collective is never dropped")
        kind, prim, i_in, i_out = C10D_OPS[name]
        schema_args = func._schema.arguments
        pg = None
        for i, a in enumerate(schema_args):
            if a.name == "process_group":
                pg = args[i] if i < len(args) else kwargs.get(a.name)
        group = dist.ProcessGroup.unbox(pg) if pg is not None else None
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else [dist.get_rank()])
        self.trace.collectives.append(Collective(
            name, kind, prim,
            sum(t.numel() for t in _tensors(args[i_in])),
            sum(t.numel() * t.element_size()
                for t in _tensors(args[i_out])),
            len(ranks), len({r // NODE_SIZE for r in ranks}) > 1))

    def _classify(self, func):
        """(namespace, flop formula or None, is a view) of an op."""
        c = (func.namespace, self._flops.get(func._overloadpacket),
             func.is_view)
        self._class[func] = c
        return c

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, flops, is_view = self._class.get(func) or self._classify(func)
        tr = self.trace
        tr.n_ops += 1
        if ns == OP_NAMESPACE:
            tr.kernel_calls.append(func._opname)
        elif ns == "c10d":
            self._collective(func, args, kwargs)
        if flops is not None:
            tr.flops += int(flops(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if not is_view:
            n = sum(_nbytes(t) for t in outs)
            n += sum(_nbytes(t) for t in _tensors(args))
            if kwargs:
                n += sum(_nbytes(t) for t in _tensors(kwargs))
            tr.bytes_accessed += n
        for t in outs:
            self._track(t)
        return out


def trace(fn: Callable, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once under a :class:`StepTracer` and
    return what it dispatched (``Trace.result`` is the return value)."""
    tracer = StepTracer()
    tracer.hold((args, kwargs))
    t0 = time.perf_counter()
    with tracer:
        result = fn(*args, **kwargs)
    tr = tracer.trace
    tr.seconds = time.perf_counter() - t0
    tr.result = result
    seen: set = set()
    for t in _tensors(result):
        key = t.untyped_storage()._cdata
        if key not in seen and t.device.type != "cpu":
            seen.add(key)
            tr.output_bytes += _storage_bytes(t)
    return tr


def collective_bytes(tr: Trace) -> dict[str, float]:
    """Per-device result bytes of the traced step's collectives, summed
    by the reference's HLO kinds (only the kinds present).  The trace is
    of the unrolled step, so no trip count weights a site."""
    totals: dict[str, float] = {}
    for c in tr.collectives:
        totals[c.kind] = totals.get(c.kind, 0.0) + float(c.result_bytes)
    return totals


# ---------------------------------------------------------------------------
# kernel-launch accounting
# ---------------------------------------------------------------------------


def count_kernel_calls(fn, *args, **kwargs) -> int:
    """Number of ``repro_torch`` kernel op calls in one run of ``fn`` (the
    reference's ``count_pallas_calls``).  On meta or CUDA tensors every
    wrapper call that reaches its kernel is one op call; the reference
    counts static sites, so the two agree where no launch is inside a
    loop -- the packed step's contract."""
    return len(trace(fn, *args, **kwargs).kernel_calls)


count_pallas_calls = count_kernel_calls


def collective_sites(fn, *args, **kwargs) -> list[tuple[str, int]]:
    """``(primitive, payload elements)`` of every collective one run of
    ``fn`` issues, in order, named by the reference's jaxpr primitives
    (:data:`C10D_OPS`); a c10d op not in that table raises."""
    return _sites(trace(fn, *args, **kwargs))


def _sites(tr: Trace) -> list[tuple[str, int]]:
    return [(c.primitive, c.elements) for c in tr.collectives]


def assert_coordinate_exchange(fn, *args, payload: int, n_params: int,
                               kinds=("pmean", "psum"),
                               n_launches: int | None = 2,
                               widened: bool = False,
                               extra: int = 0,
                               model_axis: int | None = None) -> None:
    """Assert the packed sharedseed communication contract on one run of
    ``fn(*args)`` (the reference's parameters and assertions):

    * exactly ``n_launches`` kernel op calls (``None`` skips it);
    * exactly ONE non-scalar collective, whose primitive is in ``kinds``
      (``("pmean", "psum")`` for shared_basis -- the port's pmean is a
      ``psum`` site, as jax's -- ``("all_gather",)`` for
      independent_bases) with exactly ``payload`` elements, the packed
      (d,) coordinate buffer;
    * nothing D-sized (``n_params`` elements) crosses the wire.

    ``widened=True``: the 'exact' normalization's (2 * d_packed,)
    coords+norms buffer (pass the plain d_packed; the doubling happens
    here).  ``extra``: elements on top of the (possibly widened) payload
    -- the sentinel's one rider scalar.  ``model_axis``: the element
    count of the model-sharded step's completion psum over the model
    group; the contract is then exactly TWO non-scalar collectives, that
    psum and the data-axis exchange.  One run is traced for all of it (the
    reference traces twice; a step run twice would update its state
    twice)."""
    if widened:
        payload = 2 * payload
    payload += extra
    tr = trace(fn, *args)
    if n_launches is not None:
        got = len(tr.kernel_calls)
        assert got == n_launches, (
            f"expected {n_launches} kernel op calls, got {got}: "
            f"{tr.kernel_calls}")
    sites = _sites(tr)
    big = [s for s in sites if s[1] > 1]
    if model_axis is not None:
        assert len(big) == 2, (
            "expected exactly TWO non-scalar collectives (the model-axis "
            "completion psum + the data-axis coordinate exchange), got "
            f"{big or sites}")
        completion = [s for s in big if s == ("psum", model_axis)]
        assert completion, (
            f"no model-axis completion psum of {model_axis} elements in "
            f"{big}")
        rest = list(big)
        rest.remove(completion[0])
        kind, n = rest[0]
    else:
        assert len(big) == 1, (
            "expected exactly ONE non-scalar collective (the packed "
            f"coordinate exchange), got {big or sites}")
        kind, n = big[0]
    assert kind in kinds, (f"exchange primitive {kind!r} not in {kinds}",
                           sites)
    assert n == payload, (
        f"exchange payload {n} != packed coordinate buffer {payload}"
        + (" (widened coords+norms)" if widened else ""))
    assert all(n != n_params for _, n in sites), (
        f"a D-sized ({n_params}) collective exists", sites)
