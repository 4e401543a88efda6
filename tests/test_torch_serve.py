"""Port parity of multi-tenant serving below the model: the plain version
of the B-adapter apply kernel and its public API, the serving apply
paths, adapter files, the LRU delta cache and the scheduler -- each
against ``repro.serve`` / ``repro.core.projector`` on the same inputs
(made with numpy; Pallas in interpret mode for one case).  The model-level
engines are in test_torch_decode.py.

Tolerances (as test_torch_projector.py holds ``reconstruct_apply_packed``,
for the same reasons): seeds bit-exact; each row of theta within 1e-5 of
the largest update + 2 ulp of the largest parameter (float32 sums in
another order, per dir-block); adapter files bit for bit.  Within the
port: rows bit-identical to the single-tenant apply; materialize-then-add
within 1e-5 of the fused path (the reference's bound), bit-exact with one
dir-block per compartment.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compartments as ref_comp
from repro.core import projector as ref_proj
from repro.serve import adapters as ref_adapters
from repro.serve import apply as ref_apply
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import compartments, projector
from repro_torch.kernels import rbd_step
from repro_torch.serve import apply as serve_apply
from repro_torch.serve.adapters import (EVICT_CAPACITY, EVICT_EXPLICIT,
                                        EVICT_OVERSIZE, AdapterCache,
                                        AdapterRegistry, AdapterSpec,
                                        evict_reason_name)
from repro_torch.serve.scheduler import DECODE, DONE, PREFILL, Scheduler
from test_torch_projector import _assert_theta_close

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

NAME = "reconstruct_apply_packed_adapters"


def _case(shapes, dim, **plan_kw):
    """Reference and port plans, layouts and packed theta for parameters
    drawn with numpy."""
    rs = np.random.default_rng(0)
    params = {k: rs.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    rplan = ref_comp.make_plan(params, dim, **plan_kw)
    plan = compartments.make_plan(shapes, dim, **plan_kw)
    rl = rplan.packed(pos_block=128, dir_block=8)
    lay = plan.packed(pos_block=128, dir_block=8)
    rtheta = np.asarray(ref_proj.pack_tree(
        {k: jnp.asarray(v) for k, v in params.items()}, rplan, rl))
    theta = projector.pack_tree(
        {k: torch.from_numpy(v) for k, v in params.items()}, plan, lay)
    np.testing.assert_array_equal(theta.numpy(), rtheta)
    return rplan, rl, plan, lay, theta


@pytest.fixture(scope="module")
def small():
    # the reference's fixture shapes (tests/test_serve.py)
    return _case({"w1": (40, 33), "w2": (57,), "w3": (9, 21)}, 48,
                 granularity="leaf")


def _mk_specs(layout, n, seed0=50, spec=AdapterSpec):
    rs = np.random.default_rng(7)
    coords = [0.1 * rs.normal(size=layout.d_packed) for _ in range(n)]
    return [spec(f"t{i}", seed0 + i, coords[i]) for i in range(n)]


def _ref_specs(specs):
    return [ref_adapters.AdapterSpec(s.adapter_id, s.base_seed, s.coords,
                                     s.row_sq) for s in specs]


def _assert_rows_close(got, want, theta):
    for a in range(want.shape[0]):
        _assert_theta_close(got[a], want[a], theta)


# ---------------------------------------------------------------------------
# the B-adapter apply against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_adapters", [1, 3, 5])
def test_adapter_apply_matches_reference_oracle(small, n_adapters):
    rplan, rl, plan, lay, theta = small
    specs = _mk_specs(lay, n_adapters)
    seeds, coords, _ = serve_apply.specs_to_batch(specs, plan, lay,
                                                   device="cpu")
    rseeds, rcoords, _ = ref_apply.specs_to_batch(_ref_specs(specs), rplan,
                                                 rl)
    aseg = projector.adapter_segment_seeds(plan, seeds)
    raseg = np.asarray(ref_proj.adapter_segment_seeds(rplan, rseeds))
    np.testing.assert_array_equal(aseg.numpy().view(np.uint32), raseg)

    scale = np.asarray(rcoords) * np.asarray(
        ref_proj._packed_norm_factor(rplan, rl, None))
    want = np.asarray(ref_proj._reconstruct_apply_packed_adapters_jnp(
        jnp.asarray(raseg), jnp.asarray(scale), jnp.asarray(theta.numpy()),
        rl, n_adapters, rplan.distribution))
    before = rbd_step.CALLS[NAME]
    out = projector.reconstruct_apply_packed_adapters(
        coords, plan, seeds, theta, backend="cuda", layout=lay,
        prepacked=True)
    assert rbd_step.CALLS[NAME] == before + 1
    assert out.shape == (n_adapters, lay.q_packed)
    _assert_rows_close(out.numpy(), want, theta.numpy())
    # padding columns copy theta: exactly zero in every row
    assert (out.numpy()[:, _invalid(lay)] == 0).all()
    # each row is the port's single-tenant apply, bit for bit
    for a, spec in enumerate(specs):
        single = projector.reconstruct_apply_packed(
            coords[a], plan, spec.base_seed, theta, 1.0, layout=lay,
            prepacked=True)
        assert torch.equal(out[a], single)


def _invalid(layout):
    valid = np.zeros(layout.q_packed, bool)
    for off, size in zip(layout.seg_param_off, layout.seg_size):
        valid[off: off + size] = True
    return ~valid


def test_adapter_apply_matches_interpret_mode_pallas(small):
    rplan, rl, plan, lay, theta = small
    specs = _mk_specs(lay, 3)
    rseeds, rcoords, _ = ref_apply.specs_to_batch(_ref_specs(specs), rplan,
                                                 rl)
    want = np.asarray(ref_proj.reconstruct_apply_packed_adapters(
        rcoords, rplan, rseeds, jnp.asarray(theta.numpy()), backend="pallas",
        layout=rl, prepacked=True))
    got = serve_apply.apply_adapters_fused(theta, specs, plan, lay)
    _assert_rows_close(got.numpy(), want, theta.numpy())


def test_adapter_apply_unpacked_params_gain_an_adapter_axis(small):
    rplan, rl, plan, lay, theta = small
    specs = _mk_specs(lay, 2)
    seeds, coords, _ = serve_apply.specs_to_batch(specs, plan, lay,
                                                   device="cpu")
    params = projector.unpack_tree(theta, plan, lay, {
        "w1": torch.empty(40, 33), "w2": torch.empty(57),
        "w3": torch.empty(9, 21)})
    tree = projector.reconstruct_apply_packed_adapters(coords, plan, seeds,
                                                       params)
    packed = projector.reconstruct_apply_packed_adapters(
        coords, plan, seeds, theta, layout=lay, prepacked=True)
    assert {k: tuple(v.shape) for k, v in tree.items()} == {
        "w1": (2, 40, 33), "w2": (2, 57), "w3": (2, 9, 21)}
    for a in range(2):
        row = projector.unpack_tree(packed[a], plan, lay, params)
        for k in row:
            assert torch.equal(tree[k][a], row[k])


def test_exact_normalization_needs_row_sq_and_matches_reference(small):
    rplan, rl, plan, lay, theta = small
    rplan_x = dataclasses.replace(rplan, normalization="exact")
    plan_x = dataclasses.replace(plan, normalization="exact")
    specs = _mk_specs(lay, 2)
    with pytest.raises(ValueError, match="row norms"):
        serve_apply.apply_adapters_fused(theta, specs, plan_x, lay)
    seeds, coords, _ = serve_apply.specs_to_batch(specs, plan, lay,
                                                   device="cpu")
    with pytest.raises(ValueError, match="row_sq"):
        projector.reconstruct_apply_packed_adapters(
            coords, plan_x, seeds, theta, layout=lay, prepacked=True)
    rs = np.random.default_rng(3)
    specs_x = [dataclasses.replace(s, row_sq=rs.uniform(0.5, 2.0,
                                                          lay.d_packed))
               for s in specs]
    got = serve_apply.apply_adapters_fused(theta, specs_x, plan_x, lay)
    want = np.asarray(ref_apply.apply_adapters_fused(
        jnp.asarray(theta.numpy()), _ref_specs(specs_x), rplan_x, rl))
    _assert_rows_close(got.numpy(), want, theta.numpy())


def test_orthonormal_is_refused(small):
    _, _, plan, lay, theta = small
    plan_o = dataclasses.replace(plan, normalization="orthonormal")
    seeds, coords, _ = serve_apply.specs_to_batch(_mk_specs(lay, 1), plan,
                                                  lay, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        projector.reconstruct_apply_packed_adapters(
            coords, plan_o, seeds, theta, layout=lay, prepacked=True)


# ---------------------------------------------------------------------------
# serving apply paths
# ---------------------------------------------------------------------------


def test_materialize_then_add_matches_fused(small):
    _, _, plan, lay, theta = small
    specs = _mk_specs(lay, 3)
    fused = serve_apply.apply_adapters_fused(theta, specs, plan, lay)
    deltas = serve_apply.materialize_deltas(specs, plan, lay, device="cpu")
    np.testing.assert_allclose((theta + deltas).numpy(), fused.numpy(),
                               atol=1e-5, rtol=0)
    again = serve_apply.materialize_deltas(specs, plan, lay, device="cpu")
    assert torch.equal(deltas, again)
    assert torch.equal(fused, serve_apply.apply_adapters_fused(
        theta, specs, plan, lay))


def test_materialize_then_add_bit_exact_single_dir_block():
    _, _, plan, lay, theta = _case({"a": (30, 11), "b": (77,)}, 12,
                                   granularity="leaf", allocation="uniform")
    assert all(lp.dim <= 8 for lp in plan.leaves)
    specs = _mk_specs(lay, 2)
    fused = serve_apply.apply_adapters_fused(theta, specs, plan, lay)
    deltas = serve_apply.materialize_deltas(specs, plan, lay, device="cpu")
    assert torch.equal(theta + deltas, fused)


def test_personalize_routes_hits_and_misses(small):
    rplan, rl, plan, lay, theta = small
    specs = _mk_specs(lay, 3)
    cache = AdapterCache(budget_bytes=10 * 4 * lay.q_packed)
    calls = rbd_step.CALLS[NAME]
    buf1, info1 = serve_apply.personalize(theta, specs, plan, lay,
                                          cache=cache, pin_misses=True)
    assert info1 == {"hits": 0, "misses": 3, "fused_launches": 1}
    assert rbd_step.CALLS[NAME] == calls + 1      # all misses: one call
    buf2, info2 = serve_apply.personalize(theta, specs, plan, lay,
                                          cache=cache, pin_misses=True)
    assert info2 == {"hits": 3, "misses": 0, "fused_launches": 0}
    assert rbd_step.CALLS[NAME] == calls + 1      # hits: plain adds
    assert torch.equal(buf1, buf2)
    buf3, info3 = serve_apply.personalize(theta, specs, plan, lay)
    assert info3 == {"hits": 0, "misses": 3, "fused_launches": 1}
    assert rbd_step.CALLS[NAME] == calls + 2
    np.testing.assert_allclose(buf3.numpy(), buf1.numpy(), atol=1e-5,
                               rtol=0)
    # a mixed batch: one hit, one miss -> one call for the miss
    cache2 = AdapterCache(budget_bytes=10 * 4 * lay.q_packed)
    serve_apply.personalize(theta, specs[:1], plan, lay, cache=cache2,
                            pin_misses=True)
    buf4, info4 = serve_apply.personalize(theta, specs[:2], plan, lay,
                                          cache=cache2)
    assert info4 == {"hits": 1, "misses": 1, "fused_launches": 1}
    assert torch.equal(buf4[0], buf1[0])
    assert torch.equal(buf4[1], buf3[1])
    # against the reference's personalize (jnp oracle), to tolerance
    want, rinfo = ref_apply.personalize(jnp.asarray(theta.numpy()),
                                        _ref_specs(specs), rplan, rl)
    assert rinfo == info3
    _assert_rows_close(buf3.numpy(), np.asarray(want), theta.numpy())


# ---------------------------------------------------------------------------
# adapter files: the reference's format, both directions
# ---------------------------------------------------------------------------


def _two_specs(spec=AdapterSpec):
    rs = np.random.default_rng(0)
    return (spec("alice", 123, rs.normal(size=24)),
            spec("bob", 124, rs.normal(size=24),
                 row_sq=rs.uniform(0.5, 2.0, 24)))


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_adapter_files_cross_import_bit_for_bit(tmp_path, direction):
    if direction == "port_to_reference":
        writer, reader = AdapterRegistry(), ref_adapters.AdapterRegistry
        specs = _two_specs()
    else:
        writer, reader = ref_adapters.AdapterRegistry(), AdapterRegistry
        specs = _two_specs(ref_adapters.AdapterSpec)
    for s in specs:
        writer.register(s)
    paths = writer.export_all(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["adapter_alice.npz",
                                                    "adapter_bob.npz"]
    reg = reader()
    for s in specs:
        got = reg.import_adapter(str(tmp_path), s.adapter_id)
        assert got.base_seed == s.base_seed
        assert got.coords.dtype == np.float32
        np.testing.assert_array_equal(got.coords, s.coords)
        if s.row_sq is None:
            assert got.row_sq is None
        else:
            np.testing.assert_array_equal(got.row_sq, s.row_sq)
        assert got.nbytes == s.nbytes
    assert specs[0].nbytes == 4 * 24 + 4 and specs[1].nbytes == 8 * 24 + 4


def test_named_export_sidecar_matches_reference(tmp_path):
    from repro.checkpoint import io as ref_io

    tree = {"b": np.uint32(7), "a": {"x": np.arange(5, dtype=np.float32),
                                     "y": [np.ones(2), np.zeros(3)]}}
    ckpt_io.save_named(str(tmp_path / "port"), tree, "t", {"k": 1})
    ref_io.save_named(str(tmp_path / "ref"), tree, "t", {"k": 1})
    port_meta = open(tmp_path / "port" / "t.json").read()
    assert port_meta == open(tmp_path / "ref" / "t.json").read()
    for d in ("port", "ref"):
        arrays, meta = ckpt_io.load_named(str(tmp_path / d), "t")
        assert sorted(arrays) == ["a::x", "a::y::0", "a::y::1", "b"]
        back = ckpt_io.load_named(str(tmp_path / d), "t", template=tree)
        np.testing.assert_array_equal(back["a"]["x"], tree["a"]["x"])
        assert back["b"] == 7 and isinstance(back["a"]["y"], list)


@pytest.mark.parametrize("registry", [AdapterRegistry,
                                      ref_adapters.AdapterRegistry])
def test_adapter_import_detects_corruption(tmp_path, registry):
    reg = AdapterRegistry()
    reg.register(AdapterSpec("eve", 9, np.arange(16, dtype=np.float32)))
    path = reg.export(str(tmp_path), "eve")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(ValueError):
        registry.import_spec(str(tmp_path), "eve")
    assert os.path.exists(path)


def test_registry_rejects_seed_aliasing():
    reg = AdapterRegistry()
    reg.register(AdapterSpec("a", 5, np.zeros(4)))
    with pytest.raises(ValueError, match="cache key"):
        reg.register(AdapterSpec("b", 5, np.ones(4)))
    # re-registering the SAME id (adapter update) frees the old seed
    reg.register(AdapterSpec("a", 6, np.ones(4)))
    reg.register(AdapterSpec("b", 5, np.ones(4)))
    assert reg.ids() == ["a", "b"] and len(reg) == 2
    assert reg.remove("a").base_seed == 6 and "a" not in reg


# ---------------------------------------------------------------------------
# LRU cache: budget, recency, reason codes
# ---------------------------------------------------------------------------


def _delta(v, n=8, kind="torch"):
    if kind == "torch":
        return torch.full((n,), float(v))         # 32 bytes each
    return np.full((n,), float(v), np.float32)


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_cache_lru_eviction_reason_codes(kind):
    cache = AdapterCache(budget_bytes=64)  # room for two 32-byte deltas
    assert cache.put(1, _delta(1, kind=kind))
    assert cache.put(2, _delta(2, kind=kind))
    assert cache.get(1) is not None  # refresh 1 -> LRU victim is 2
    assert cache.put(3, _delta(3, kind=kind))
    assert cache.evictions == [(2, EVICT_CAPACITY)]
    assert 2 not in cache and 1 in cache and 3 in cache
    assert cache.invalidate(1)
    assert cache.evictions[-1] == (1, EVICT_EXPLICIT)
    assert not cache.invalidate(1)
    assert not cache.put(4, _delta(4, n=64, kind=kind))  # 256 B > 64 B
    assert cache.evictions[-1] == (4, EVICT_OVERSIZE)
    assert 4 not in cache and 3 in cache  # nothing was flushed
    st = cache.stats()
    assert st["entries"] == 1 and st["bytes_used"] == 32
    by_reason = {"capacity": 1, "explicit": 1, "oversize": 1}
    assert st["evictions_by_reason"] == by_reason
    codes = (EVICT_CAPACITY, EVICT_EXPLICIT, EVICT_OVERSIZE)
    assert [evict_reason_name(c) for c in codes] == list(by_reason)
    assert (codes == (ref_adapters.EVICT_CAPACITY,
                      ref_adapters.EVICT_EXPLICIT,
                      ref_adapters.EVICT_OVERSIZE))


def test_cache_hit_miss_counters():
    cache = AdapterCache(budget_bytes=1024)
    assert cache.get(7) is None
    cache.put(7, _delta(7))
    assert bool((cache.get(7) == 7.0).all())
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 1
    cache.put(7, _delta(8))
    assert cache.stats()["bytes_used"] == 32
    assert cache.evictions[-1] == (7, EVICT_EXPLICIT)


# ---------------------------------------------------------------------------
# scheduler: continuous-batching invariants (tests/test_serve.py's cases)
# ---------------------------------------------------------------------------


def test_scheduler_admit_retire_invariants():
    s = Scheduler(n_slots=2)
    rids = [s.submit(np.arange(3), 4) for _ in range(3)]
    admitted = s.admit()
    assert [slot for slot, _ in admitted] == [0, 1]
    assert [r.rid for _, r in admitted] == rids[:2]  # FIFO
    assert s.pending() == 1 and s.admit() == []  # no free slot
    for slot, _ in admitted:
        assert s.request(rids[slot]).state == PREFILL
        s.mark_prefilled(slot)
    assert {r.rid for _, r in s.active()} == set(rids[:2])
    for t in range(4):
        finished = s.record_token(0, t)
    assert finished
    req = s.retire(0)
    assert req.state == DONE and s.slots[0] is None
    assert s.request(rids[1]).state == DECODE
    nxt = s.admit()
    assert nxt == [(0, s.request(rids[2]))]
    assert s.n_admitted == 3
    s.mark_prefilled(0)
    req2 = s.slots[0]
    req2.eos_id = 99
    assert not s.record_token(0, 1)
    assert s.record_token(0, 99)
    assert s.retire(0).tokens == [1, 99]
    s.record_token(1, 5)
    with pytest.raises(AssertionError):
        s.record_token(0, 1)  # empty slot
    with pytest.raises(AssertionError):
        s.retire(0)  # empty slot
    for t in range(3):
        s.record_token(1, t)
    s.retire(1)
    assert s.all_done()
    res = s.results()
    assert set(res) == set(rids) and list(res[rids[2]]) == [1, 99]


def test_scheduler_rejects_bad_requests():
    s = Scheduler(n_slots=1)
    with pytest.raises(ValueError):
        s.submit(np.array([], np.int32), 4)
    with pytest.raises(ValueError):
        s.submit(np.arange(3), 0)
    with pytest.raises(ValueError):
        Scheduler(n_slots=0)


def test_scheduler_is_the_references_on_a_random_trace():
    """The same random submit / admit / record / retire trace through both
    schedulers gives the same slots, states and results."""
    from repro.serve.scheduler import Scheduler as RefScheduler

    rs = np.random.default_rng(5)
    ours, ref = Scheduler(3), RefScheduler(3)
    for _ in range(60):
        if rs.random() < 0.3:
            n, eos = int(rs.integers(1, 5)), int(rs.integers(0, 4))
            assert ours.submit(np.arange(2), n, eos_id=eos) == ref.submit(
                np.arange(2), n, eos_id=eos)
        got, want = ours.admit(), ref.admit()
        assert [(s, r.rid) for s, r in got] == [(s, r.rid) for s, r in want]
        for slot, _ in got:
            ours.mark_prefilled(slot)
            ref.mark_prefilled(slot)
        for slot, _ in ours.active():
            tok = int(rs.integers(0, 4))
            if ours.record_token(slot, tok):
                ours.retire(slot)
            if ref.record_token(slot, tok):
                ref.retire(slot)
        assert ([r and (r.rid, r.state) for r in ours.slots]
                == [r and (r.rid, r.state) for r in ref.slots])
    assert {k: v.tolist() for k, v in ours.results().items()} == {
        k: v.tolist() for k, v in ref.results().items()}
