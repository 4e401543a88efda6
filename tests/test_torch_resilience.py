"""Port parity of coordinate-replay resilience (``repro_torch.core.
resilience``, the step checkpoints of ``repro_torch.checkpoint.io`` and the
guarded packed step) against the reference on the same numpy inputs.

* primitives: the guard transition bit for bit on sequences of reasons;
  the sentinel checksum and rider equal to the reference's on states
  converted from it, and a one-ulp flip (or -0.0) changes them; the
  sentinel check; ``FaultPlan.from_seed`` events; the injectors'
  positions; every reason code named as the reference names it;
* ``ReplayLog``: the port's file byte for byte the reference's, each
  package reading the other's log; torn tail, bit flip, bad magic, no
  meta;
* step checkpoints: the reference's five cases on the port, and a
  ``TrainState`` snapshot written by either package restoring in the
  other with the same keys;
* the guarded step on the reference's ragged fixture (sgd / momentum /
  adam x shared basis / the K = 3 independent-bases simulation): the
  healthy guarded step bit-identical to the port's unguarded one, within
  tolerance of the reference's guarded step (Normal samples differ by an
  ulp, so float32 sums differ: theta within 1e-4 of the cumulative update
  + 4 ulp of the largest parameter, the optimizer state within 1e-4 of
  its largest entry, as in test_torch_workers_sim.py), a NaN step leaving
  parameters and optimizer state bit-untouched with the reference's guard
  state;
* resume: 3 optimizers x 2 modes x both CPU backends of the port (``torch``
  and the kernels' plain versions, ``cuda``), bit-exact against the port's
  own uninterrupted run (the reference's guarded-adam bit-exact checks
  depend on the machine), with the reference's ``snapshot_step`` and
  ``replayed``; the rejected-step replay and recovery's degraded paths.
"""

import dataclasses
import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_io
from repro.core import make_plan as ref_make_plan
from repro.core import projector as ref_proj
from repro.core import resilience as ref_res
from repro.core.rbd import RandomBasesTransform as RefTransform
from repro.optim.subspace import SubspaceOptimizer as RefSubspace
from repro.train.step import TrainState as RefTrainState
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import compartments
from repro_torch.core import resilience as res
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.optim import subspace
from repro_torch.optim.transforms import AdamState
from repro_torch.train.step import TrainState

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

EPS32 = 2.0 ** -23
OPTIMIZERS = ["sgd", "momentum", "adam"]
MODES = [("shared_basis", 1), ("independent_bases", 3)]

# ---------------------------------------------------------------------------
# the reference's ragged fixture (tests/test_resilience.py)
# ---------------------------------------------------------------------------

SHAPES = {"w": (48, 20), "layers/k": (3, 40, 10), "s": (), "odd": (7, 73),
          "long": (700,)}


def _ref_params():
    return {
        "w": jnp.ones((48, 20)),
        "layers": {"k": jnp.ones((3, 40, 10))},
        "s": jnp.ones(()),
        "odd": jnp.ones((7, 73)),
        "long": jnp.ones((700,)),
    }


@functools.cache
def _ref_plan(normalization="exact"):
    return ref_make_plan(_ref_params(), 96, granularity="layer",
                         is_stacked=lambda n: n.startswith("layers"),
                         normalization=normalization)


@functools.cache
def _plan(normalization="exact"):
    return compartments.make_plan(
        SHAPES, 96, granularity="layer",
        is_stacked=lambda n: n.startswith("layers"),
        normalization=normalization)


def _ref_sub(*, optimizer="momentum", mode="shared_basis", k_workers=1,
             guarded=True, capture=True, sentinel_every=0, fault_plan=None,
             normalization="exact"):
    return RefSubspace(
        transform=RefTransform(_ref_plan(normalization), base_seed=11,
                               redraw=True, backend="jnp"),
        learning_rate=0.3, use_packed=True, optimizer=optimizer, mode=mode,
        k_workers=k_workers, params_template=_ref_params(),
        guard=ref_res.GuardConfig() if guarded else None,
        capture_coords=capture, sentinel_every=sentinel_every,
        fault_plan=fault_plan)


def _sub(*, optimizer="momentum", backend="cuda", mode="shared_basis",
         k_workers=1, guarded=True, capture=True, sentinel_every=0,
         fault_plan=None, normalization="exact"):
    return subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(_plan(normalization), base_seed=11,
                                       redraw=True, backend=backend),
        learning_rate=0.3, use_packed=True, optimizer=optimizer, mode=mode,
        k_workers=k_workers,
        guard=res.GuardConfig() if guarded else None,
        capture_coords=capture, sentinel_every=sentinel_every,
        fault_plan=fault_plan)


@functools.cache
def _theta0() -> np.ndarray:
    plan = _ref_plan()
    return np.asarray(ref_proj.pack_tree(_ref_params(), plan, plan.packed()))


@functools.cache
def _grads_np(k_workers: int, key: int) -> np.ndarray:
    """The reference fixture's packed gradients of one step: (q,) or the
    K workers' stacked (K, q) (keys 7 * key + w)."""
    plan = _ref_plan()

    def one(k):
        kk = jax.random.PRNGKey(k)
        g = jax.tree_util.tree_map(lambda p: jax.random.normal(kk, p.shape),
                                   _ref_params())
        return np.asarray(ref_proj.pack_tree(g, plan, plan.packed()))

    if k_workers > 1:
        return np.stack([one(7 * key + w) for w in range(k_workers)])
    return one(key)


def _init_state(sub):
    return TrainState(
        params=torch.from_numpy(_theta0().copy()),
        rbd_state=sub.init_rbd_state(),
        opt_state=sub.init_opt_state(device="cpu"),
        step=0,
        guard=res.guard_init() if sub.guard is not None else ())


def _ref_init_state(sub):
    return RefTrainState(
        params=jnp.asarray(_theta0()),
        rbd_state=sub.init_rbd_state(_ref_params()),
        opt_state=sub.init_opt_state(_ref_params()),
        step=jnp.zeros((), jnp.int32),
        guard=ref_res.guard_init() if sub.guard is not None else ())


def _metrics(sub, aux):
    m = {}
    if sub.guard is not None:
        m["guard_reason"] = aux.reason
        m["guard_lr_scale"] = aux.guard.lr_scale
    if sub.capture_coords:
        m["replay_coords"] = aux.coords
        if not isinstance(aux.row_sq, tuple):
            m["replay_row_sq"] = aux.row_sq
    if sub.sentinel_every:
        m["sentinel_diverged"] = aux.diverged
    return m


def _drive(sub, state, keys, monitor=None):
    """One port step per gradient key, the monitor fed what the training
    loop feeds it (grad faults fire before the projection)."""
    k = sub.k_workers if sub.joint_subspace else 1
    for key in keys:
        g = torch.from_numpy(_grads_np(k, key).copy())
        if sub.fault_plan is not None:
            g = res.inject_grad_faults(sub.fault_plan, key, g)
        p, r, o, aux = sub.step(state.params, g, state.rbd_state,
                                state.opt_state, state.guard)
        state = TrainState(p, r, o, state.step + 1,
                           aux.guard if sub.guard is not None else
                           state.guard)
        if monitor is not None:
            monitor.observe(state, _metrics(sub, aux))
    return state


def _ref_drive(sub, state, keys, monitor=None, step_fn=None):
    k = sub.k_workers if sub.joint_subspace else 1
    step_fn = step_fn if step_fn is not None else jax.jit(sub.step)
    for key in keys:
        g = jnp.asarray(_grads_np(k, key))
        if sub.fault_plan is not None:
            g = ref_res.inject_grad_faults(sub.fault_plan, jnp.uint32(key), g)
        p, r, o, aux = step_fn(state.params, g, state.rbd_state,
                               state.opt_state, state.guard)
        state = RefTrainState(p, r, o, state.step + 1,
                              aux.guard if sub.guard is not None else
                              state.guard)
        if monitor is not None:
            monitor.observe(state, _metrics(sub, aux))
    return state


def _leaves(tree):
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in res._tree_leaves(tree)]


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

REASON_SEQUENCES = [
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [2] * 12 + [0] * 3,
    [0, 1, 0, 2, 3, 0, 0, 1, 1, 0, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
]


@pytest.mark.parametrize("seq", range(len(REASON_SEQUENCES)))
def test_guard_transition_matches_reference_bit_for_bit(seq):
    cfg, ref_cfg = res.GuardConfig(), ref_res.GuardConfig()
    st, ref_st = res.guard_init(), ref_res.guard_init()
    for reason in REASON_SEQUENCES[seq]:
        st = res.guard_transition(cfg, st, reason)
        ref_st = ref_res.guard_transition(ref_cfg, ref_st, reason)
        for a, b in zip(st, ref_st):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape == ()
            assert a.tobytes() == b.tobytes()
    # the 1.0 fixed point and the floor, as the reference's test reads them
    if seq == 0:
        assert float(st.lr_scale) == 1.0 and int(st.nonfinite_count) == 1
    if seq == 1:
        assert float(ref_st.lr_scale) == 0.015625 * 1.25 ** 3


def _ref_adam_state():
    rs = np.random.default_rng(3)
    mu = rs.standard_normal((3, 97)).astype(np.float32)
    nu = np.abs(rs.standard_normal((3, 97))).astype(np.float32)
    from repro.optim.transforms import AdamState as RefAdam

    return RefAdam(jnp.asarray(mu), jnp.asarray(nu),
                   jnp.asarray(7, jnp.int32))


def _port_adam_state(ref):
    return AdamState(torch.from_numpy(np.array(ref.mu)),
                     torch.from_numpy(np.array(ref.nu)),
                     torch.tensor(int(ref.count), dtype=torch.int32))


@pytest.mark.parametrize("chunk", [None, 64])
def test_state_checksum_matches_reference_and_is_ulp_sensitive(
        chunk, monkeypatch):
    if chunk is not None:   # the chunked int64 sum, chunks of 64 words
        monkeypatch.setattr(res, "_CHECKSUM_CHUNK", chunk)
    tree = {"m": np.linspace(-1.0, 1.0, 197).astype(np.float32),
            "n": np.zeros((5,), np.float32)}
    port = {k: torch.from_numpy(v) for k, v in tree.items()}
    c = res.state_checksum(port)
    assert c.dtype == torch.float32 and c.shape == ()
    v = float(c)
    assert v == float(ref_res.state_checksum(
        {k: jnp.asarray(x) for k, x in tree.items()}))
    assert v == int(v) and 0 <= v < 65536
    bumped = dict(port, m=port["m"].clone())
    bumped["m"][11] = torch.nextafter(bumped["m"][11], torch.tensor(2.0))
    assert float(res.state_checksum(bumped)) != v
    signed = dict(port, n=port["n"].clone())
    signed["n"][0] = -0.0
    assert float(res.state_checksum(signed)) != v
    # a state converted from the reference's: adam (mu, nu, int32 count)
    ref_adam = _ref_adam_state()
    adam = _port_adam_state(ref_adam)
    assert float(res.state_checksum(adam)) == float(
        ref_res.state_checksum(ref_adam))
    flipped = adam._replace(nu=adam.nu.clone())
    flipped.nu.view(-1)[200] = torch.nextafter(flipped.nu.view(-1)[200],
                                               torch.tensor(9.0))
    assert float(res.state_checksum(flipped)) != float(
        res.state_checksum(adam))


def test_sentinel_rider_matches_reference():
    params = np.arange(8.0, dtype=np.float32)
    ref_adam = _ref_adam_state()
    adam = _port_adam_state(ref_adam)
    tparams = torch.from_numpy(params)
    assert float(res.sentinel_rider(adam, tparams)) == float(
        ref_res.sentinel_rider(ref_adam, jnp.asarray(params)))
    # sgd has no state leaves: the packed params are the checksum target
    assert float(res.sentinel_rider((), tparams)) == float(
        ref_res.sentinel_rider((), jnp.asarray(params)))
    assert float(res.sentinel_rider((), tparams)) == float(
        res.state_checksum(tparams))


@pytest.mark.parametrize("local,exchanged,step,every", [
    (7.0, 9.0, 0, 2), (7.0, 9.0, 1, 2), (7.0, 7.0, 0, 2),
    (7.0, [7.0, 7.0, 9.0], 4, 2), (7.0, [7.0, 7.0, 7.0], 4, 2),
    (7.0, [7.0, 9.0], 3, 2), (5.0, 6.0, 9, 3)])
def test_sentinel_check_matches_reference(local, exchanged, step, every):
    got = res.sentinel_check(torch.tensor(local),
                             torch.tensor(exchanged), step, every)
    want = ref_res.sentinel_check(jnp.float32(local),
                                  jnp.asarray(exchanged, jnp.float32),
                                  step, every)
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == bool(want)


@pytest.mark.parametrize("seed", [0, 7, 8, 123])
def test_fault_plan_from_seed_matches_reference(seed):
    for n_steps, n_events, k in ((50, 4, 3), (10, 3, 1), (7, 9, 5)):
        got = res.FaultPlan.from_seed(seed, n_steps, n_events=n_events,
                                      k_workers=k)
        want = ref_res.FaultPlan.from_seed(seed, n_steps, n_events=n_events,
                                           k_workers=k)
        assert [tuple(e) for e in got.events] == \
            [tuple(e) for e in want.events]
    plan = res.FaultPlan.from_seed(seed, 50, n_events=6, k_workers=3)
    assert plan.without("kill").of("kill") == ()
    assert res.FaultPlan.single(3, "kill").kill_steps() == (3,)
    with pytest.raises(ValueError, match="unknown fault kind"):
        res.FaultPlan.single(0, "meteor_strike")


def test_injectors_hit_the_reference_positions():
    cases = [
        # (plan, step, shape, worker_index)
        (("nan_grad", 2, 0), 1, (8,), None),
        (("nan_grad", 2, 0), 2, (8,), None),
        (("inf_grad", 0, 1), 0, (3, 8), None),
        (("inf_grad", 0, 1), 0, (8,), 0),
        (("inf_grad", 0, 1), 0, (8,), 1),
    ]
    for (kind, at, worker), step, shape, widx in cases:
        plan = res.FaultPlan.single(at, kind, worker=worker)
        ref_plan = ref_res.FaultPlan.single(at, kind, worker=worker)
        g = torch.ones(shape)
        got = res.inject_grad_faults(plan, step, g, worker_index=widx)
        want = ref_res.inject_grad_faults(
            ref_plan, jnp.uint32(step), jnp.ones(shape),
            worker_index=None if widx is None else jnp.uint32(widx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(g, torch.ones(shape))   # the input untouched
    for coords_shape in ((4,), (3, 4)):
        for widx in (1, 2):
            plan = res.FaultPlan.single(3, "corrupt_collective", worker=2)
            ref_plan = ref_res.FaultPlan.single(3, "corrupt_collective",
                                                worker=2)
            for step in (2, 3):
                got = res.inject_collective_faults(
                    plan, step, torch.ones(coords_shape), widx)
                want = ref_res.inject_collective_faults(
                    ref_plan, jnp.uint32(step), jnp.ones(coords_shape),
                    jnp.uint32(widx))
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_every_reason_code_named_as_the_reference():
    for code in range(9):
        assert res.reason_name(code) == ref_res.reason_name(code)
    for code in range(8):
        assert "unknown" not in res.reason_name(code)
    assert "unknown" in res.reason_name(99)
    assert set(res.__all__) == set(ref_res.__all__)
    for name in ref_res.__all__:
        if name.startswith("REASON_") or name == "FAULT_KINDS":
            assert getattr(res, name) == getattr(ref_res, name)


def test_all_finite_is_a_device_bool():
    a, b = torch.ones(5), torch.ones(3)
    assert bool(res.all_finite(a, None, b))
    b[1] = float("inf")
    ok = res.all_finite(a, b)
    assert ok.dtype == torch.bool and ok.shape == () and not bool(ok)
    assert not bool(res.all_finite(torch.tensor([float("nan")])))


# ---------------------------------------------------------------------------
# replay log
# ---------------------------------------------------------------------------


def _log_meta(d=4):
    return {"format": 1, "coords_shape": [d], "has_norms": True}


def _write_log(mod, path):
    c0 = np.arange(4, dtype=np.float32)
    s0 = np.full(4, 2.0, np.float32)
    conv = (torch.from_numpy if mod is res else jnp.asarray)
    with mod.ReplayLog(path, meta=_log_meta()) as log:
        log.append(0, mod.REASON_OK, 1.0, coords=conv(c0), row_sq=conv(s0))
        log.append(1, mod.REASON_NONFINITE_LOCAL, 0.5)  # rejected
        log.append(2, mod.REASON_OK, 0.625, coords=conv(c0 + 1),
                   row_sq=conv(s0))
    return c0, s0


def test_replay_log_bytes_equal_reference_and_cross_read(tmp_path):
    port, ref = str(tmp_path / "port.log"), str(tmp_path / "ref.log")
    c0, s0 = _write_log(res, port)
    _write_log(ref_res, ref)
    assert open(port, "rb").read() == open(ref, "rb").read()
    for reader in (res.ReplayLog, ref_res.ReplayLog):
        for path in (port, ref):
            meta, records, truncated = reader.read(path)
            assert not truncated and meta["coords_shape"] == [4]
            assert [r.step for r in records] == [0, 1, 2]
            np.testing.assert_array_equal(records[0].coords, c0)
            np.testing.assert_array_equal(records[0].row_sq, s0)
            assert records[1].coords is None and records[1].row_sq is None
            assert records[1].reason == res.REASON_NONFINITE_LOCAL
            np.testing.assert_array_equal(records[2].coords, c0 + 1)
    # the port appends to the reference's log (and back) byte for byte
    with res.ReplayLog(ref) as log:
        log.append(3, 0, 1.0, coords=torch.ones(4), row_sq=torch.ones(4))
    with ref_res.ReplayLog(port) as log:
        log.append(3, 0, 1.0, coords=jnp.ones(4), row_sq=jnp.ones(4))
    assert open(port, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("mode,k", MODES)
@pytest.mark.parametrize("norm", ["exact", "rsqrt_dim"])
def test_replay_meta_equals_reference(mode, k, norm):
    got = res.replay_meta(_sub(mode=mode, k_workers=k, normalization=norm))
    want = ref_res.replay_meta(_ref_sub(mode=mode, k_workers=k,
                                        normalization=norm))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_replay_log_torn_tail_dropped_and_truncated_on_reopen(tmp_path):
    path = str(tmp_path / "replay.log")
    c = torch.ones(4)
    with res.ReplayLog(path, meta=_log_meta()) as log:
        log.append(0, 0, 1.0, coords=c, row_sq=c)
        log.append(1, 0, 1.0, coords=c, row_sq=c)
    whole = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(whole - 3)  # tear the last record mid-frame
    with pytest.warns(UserWarning, match="torn"):
        _, records, truncated = res.ReplayLog.read(path)
    assert truncated and [r.step for r in records] == [0]
    with pytest.warns(UserWarning, match="torn"):
        log = res.ReplayLog(path)
    with log:
        log.append(1, 0, 1.0, coords=c + 1, row_sq=c)
    _, records, truncated = res.ReplayLog.read(path)
    assert not truncated and [r.step for r in records] == [0, 1]
    np.testing.assert_array_equal(records[1].coords, (c + 1).numpy())


def test_replay_log_record_crc_detects_bitflip(tmp_path):
    path = str(tmp_path / "replay.log")
    c = torch.ones(4)
    with res.ReplayLog(path, meta=_log_meta()) as log:
        log.append(0, 0, 1.0, coords=c, row_sq=c)
        log.append(1, 0, 1.0, coords=c, row_sq=c)
    with open(path, "r+b") as fh:
        data = bytearray(fh.read())
        first_rec = data.index(b"REC0")
        data[first_rec + 4 + 16 + 2] ^= 0x40
        fh.seek(0)
        fh.write(data)
    with pytest.warns(UserWarning, match="torn"):
        _, records, truncated = res.ReplayLog.read(path)
    assert truncated and records == []


def test_replay_log_refuses_bad_magic_and_a_new_log_without_meta(tmp_path):
    path = str(tmp_path / "not_a_log")
    with open(path, "wb") as fh:
        fh.write(b"something else entirely")
    with pytest.raises(ValueError, match="bad magic"):
        res.ReplayLog.read(path)
    with pytest.raises(ValueError, match="meta"):
        res.ReplayLog(str(tmp_path / "x.log"))


# ---------------------------------------------------------------------------
# step checkpoints (the reference's five cases, on the port)
# ---------------------------------------------------------------------------


def _tree(v=0.0):
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3) + v,
            "b": {"c": np.float32(3.5) + v}}


def _assert_trees_equal(a, b):
    la = [np.asarray(x) for _, x in ckpt_io._leaves_with_path(a)]
    lb = [np.asarray(x) for _, x in ckpt_io._leaves_with_path(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_checkpoint_roundtrip_with_crc_sidecar(tmp_path):
    d = str(tmp_path)
    ckpt_io.save(d, _tree(), 3)
    meta = json.load(open(os.path.join(d, "ckpt_00000003.json")))
    assert meta["step"] == 3 and set(meta["crc32"]) == set(meta["keys"])
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    _assert_trees_equal(ckpt_io.restore(d, _tree(), 3), _tree())
    assert ckpt_io.latest_step(d) == 3
    # the sidecar is the reference's, byte for byte
    ref_io.save(str(tmp_path / "ref"), _tree(), 3)
    assert open(os.path.join(d, "ckpt_00000003.json")).read() == open(
        tmp_path / "ref" / "ckpt_00000003.json").read()


def test_stray_npz_without_sidecar_skipped(tmp_path):
    d = str(tmp_path)
    ckpt_io.save(d, _tree(), 1)
    os.remove(os.path.join(d, "ckpt_00000001.json"))
    ckpt_io.save(d, _tree(), 0)
    with pytest.warns(UserWarning, match="sidecar"):
        assert ckpt_io.latest_step(d) == 0


def test_corrupt_npz_falls_back_to_older_checkpoint(tmp_path):
    d = str(tmp_path)
    ckpt_io.save(d, _tree(0.0), 1)
    ckpt_io.save(d, _tree(5.0), 2)
    with open(os.path.join(d, "ckpt_00000002.npz"), "r+b") as fh:
        fh.seek(40)
        fh.write(b"\xde\xad\xbe\xef" * 8)
    with pytest.warns(UserWarning, match="corrupt"):
        out = ckpt_io.restore(d, _tree())
    _assert_trees_equal(out, _tree(0.0))
    with pytest.raises(ValueError):
        ckpt_io.restore(d, _tree(), 2)


def test_corrupt_sidecar_json_skipped(tmp_path):
    d = str(tmp_path)
    ckpt_io.save(d, _tree(0.0), 1)
    ckpt_io.save(d, _tree(5.0), 2)
    with open(os.path.join(d, "ckpt_00000002.json"), "w") as fh:
        fh.write("{ not json")
    with pytest.warns(UserWarning, match="corrupt"):
        assert ckpt_io.valid_steps(d) == [1]
    with pytest.warns(UserWarning):
        out = ckpt_io.restore(d, _tree())
    _assert_trees_equal(out, _tree(0.0))


def test_crc_catches_silent_array_corruption(tmp_path):
    d = str(tmp_path)
    ckpt_io.save(d, _tree(), 0)
    base = os.path.join(d, "ckpt_00000000")
    data = dict(np.load(base + ".npz"))
    key = sorted(data)[0]
    data[key] = data[key] + 1  # same shape/dtype, different bytes
    with open(base + ".npz", "wb") as fh:
        np.savez(fh, **data)
    with pytest.raises(ValueError, match="CRC32"):
        ckpt_io.restore(d, _tree(), 0)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_train_state_snapshots_cross_restore(optimizer, tmp_path):
    """A TrainState snapshot written by the reference restores in the port
    and the other way round: the same keys (``.params``,
    ``.opt_state::.mu``, ``.guard::.lr_scale`` ...), dtypes and bits."""
    ref_sub, _ = _ref_step(optimizer, "shared_basis", 1)
    sub = _sub(optimizer=optimizer)
    ref_state, _ = _ref_guarded(optimizer, "shared_basis", 1)
    state = _drive(sub, _init_state(sub), range(3))
    ref_mon = ref_res.ResilienceMonitor(ref_res.ResilienceConfig(
        directory=str(tmp_path / "ref")), ref_sub)
    mon = res.ResilienceMonitor(res.ResilienceConfig(
        directory=str(tmp_path / "port")), sub)
    ref_mon.snapshot(ref_state)
    mon.snapshot(state)
    ref_mon.log.close()
    mon.log.close()
    ref_meta = json.load(open(tmp_path / "ref/snapshots/ckpt_00000003.json"))
    meta = json.load(open(tmp_path / "port/snapshots/ckpt_00000003.json"))
    assert meta["keys"] == ref_meta["keys"]
    assert meta["dtypes"] == ref_meta["dtypes"]
    assert meta["shapes"] == ref_meta["shapes"]
    assert ".params" in meta["keys"] and ".guard::.lr_scale" in meta["keys"]
    # the reference's snapshot into the port's template, and back
    got = ckpt_io.restore(str(tmp_path / "ref/snapshots"), _init_state(sub),
                          3)
    assert got.step == 3 and got.rbd_state.step == 3
    _assert_states_equal(got.params, ref_state.params)
    _assert_states_equal(got.opt_state, ref_state.opt_state)
    _assert_states_equal(got.guard, ref_state.guard)
    back = ref_io.restore(str(tmp_path / "port/snapshots"),
                          jax.device_get(_ref_init_state(ref_sub)), 3)
    assert int(back.step) == 3 and int(back.rbd_state.step) == 3
    _assert_states_equal(back.params, state.params)
    _assert_states_equal(back.opt_state, state.opt_state)
    _assert_states_equal(back.guard, state.guard)


# ---------------------------------------------------------------------------
# the guarded step on the ragged fixture
# ---------------------------------------------------------------------------


@functools.cache
def _ref_step(optimizer, mode, k):
    """The reference's guarded, capturing optimizer and its jitted step
    (one compile a config, shared by the tests that run it)."""
    sub = _ref_sub(optimizer=optimizer, mode=mode, k_workers=k)
    return sub, jax.jit(sub.step)


@functools.cache
def _ref_guarded(optimizer, mode, k):
    """The reference's guarded step, 3 healthy steps and one NaN step from
    theta0."""
    sub, step_fn = _ref_step(optimizer, mode, k)
    s3 = _ref_drive(sub, _ref_init_state(sub), range(3), step_fn=step_fn)
    st = _ref_init_state(sub)
    g = jnp.asarray(_nan_grads(k))
    nan = step_fn(st.params, g, st.rbd_state, st.opt_state, st.guard)
    return jax.device_get(s3), jax.device_get(nan)


def _nan_grads(k):
    g = _grads_np(k, 0).copy()
    if k > 1:
        g[1, 0] = np.inf   # one worker's row (the reference's joint case)
    else:
        g[3] = np.nan
    return g


@pytest.mark.parametrize("mode,k", MODES)
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_guarded_step_vs_unguarded_and_reference(optimizer, mode, k):
    guarded = _sub(optimizer=optimizer, mode=mode, k_workers=k)
    plain = _sub(optimizer=optimizer, mode=mode, k_workers=k, guarded=False,
                 capture=False)
    assert guarded.resilience_active and not plain.resilience_active
    s_g = _drive(guarded, _init_state(guarded), range(3))
    s_p = _drive(plain, _init_state(plain), range(3))
    # the healthy guarded step is the unguarded step, bit for bit
    assert torch.equal(s_g.params, s_p.params)
    _assert_states_equal(s_g.opt_state, s_p.opt_state)
    assert float(s_g.guard.lr_scale) == 1.0
    assert int(s_g.guard.nonfinite_count) == 0
    # ... and the reference's guarded step within tolerance
    ref3, _ = _ref_guarded(optimizer, mode, k)
    want, theta0 = np.asarray(ref3.params), _theta0()
    tol = (1e-4 * np.abs(want - theta0).max()
           + 4 * EPS32 * np.abs(want).max())
    np.testing.assert_allclose(s_g.params.numpy(), want, rtol=0, atol=tol)
    for a, b in zip(_leaves(s_g.opt_state), _leaves(ref3.opt_state)):
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max())
        else:
            np.testing.assert_array_equal(a, b)
    _assert_states_equal(s_g.guard, ref3.guard)


@pytest.mark.parametrize("mode,k", MODES)
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_nonfinite_step_rejected_bit_untouched(optimizer, mode, k, backend):
    """A NaN (an Inf in one worker's row) propagates into the projected
    coordinates; the guard rejects, the parameters and optimizer state
    come back bit-identical while the basis schedule advances, and the
    guard state is the reference's."""
    sub = _sub(optimizer=optimizer, mode=mode, k_workers=k, backend=backend)
    state = _init_state(sub)
    p, r, o, aux = sub.step(state.params, torch.from_numpy(_nan_grads(k)),
                            state.rbd_state, state.opt_state, state.guard)
    assert torch.equal(p, state.params)
    _assert_states_equal(o, state.opt_state)
    assert int(aux.reason) == res.REASON_NONFINITE_LOCAL
    assert r.step == 1
    _, (ref_p, _, ref_o, ref_aux) = _ref_guarded(optimizer, mode, k)
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref_p))
    _assert_states_equal(o, ref_o)
    _assert_states_equal(aux.guard, ref_aux.guard)
    assert int(aux.reason) == int(ref_aux.reason)


def test_subspace_resilience_fields_default_off():
    sub = _sub(guarded=False, capture=False)
    assert sub.guard is None and sub.sentinel_every == 0
    assert not sub.capture_coords and sub.fault_plan is None
    assert not sub.resilience_active
    assert dataclasses.replace(sub, sentinel_every=4).resilience_active
    # the unguarded step's aux keeps its resilience fields empty
    st = _init_state(sub)
    *_, aux = sub.step(st.params, torch.from_numpy(_grads_np(1, 0).copy()),
                       st.rbd_state, st.opt_state)
    assert aux.coords == () and aux.guard == () and aux.diverged == ()


def test_sentinel_rides_the_simulation_and_agrees():
    sub = _sub(optimizer="adam", mode="independent_bases", k_workers=3,
               sentinel_every=1)
    st = _init_state(sub)
    *_, aux = sub.step(st.params, torch.from_numpy(_grads_np(3, 0).copy()),
                       st.rbd_state, st.opt_state, st.guard)
    assert aux.diverged.dtype == torch.bool and not bool(aux.diverged)


# ---------------------------------------------------------------------------
# recovery = snapshot + coordinate replay, bit-exact
# ---------------------------------------------------------------------------


@functools.cache
def _ref_recovery_info(mode, k, tmp):
    """The reference's snapshot_step / replayed for the matrix schedule
    (5 steps, snapshot every 3, crash before step 4)."""
    cfg = ref_res.ResilienceConfig(directory=os.path.join(tmp, mode),
                                   snapshot_every=3,
                                   guard=ref_res.GuardConfig())
    sub, step_fn = _ref_step("sgd", mode, k)
    monitor = ref_res.ResilienceMonitor(cfg, sub)
    _ref_drive(sub, _ref_init_state(sub), range(4), monitor, step_fn=step_fn)
    monitor.log.close()
    recovered, info = ref_res.recover(cfg, sub, _ref_init_state(sub))
    return info["snapshot_step"], info["replayed"], int(recovered.step)


@pytest.fixture(scope="module")
def ref_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ref_recovery"))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mode,k", MODES)
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_resume_bit_exact(optimizer, mode, k, backend, tmp_path, ref_tmp):
    """Train, crash, restore + replay, continue: theta, the optimizer state
    and the guard state bit-identical to the uninterrupted run;
    snapshot_every=3 makes recovery replay a record on top of a mid-run
    snapshot."""
    n_steps, crash_at = 5, 4
    cfg = res.ResilienceConfig(directory=str(tmp_path / "res"),
                               snapshot_every=3, guard=res.GuardConfig())
    sub = _sub(optimizer=optimizer, mode=mode, k_workers=k, backend=backend)
    ref = _drive(sub, _init_state(sub), range(n_steps))
    monitor = res.ResilienceMonitor(cfg, sub)
    _drive(sub, _init_state(sub), range(crash_at), monitor)
    monitor.log.close()
    recovered, info = res.recover(cfg, sub, _init_state(sub))
    assert recovered is not None and recovered.step == crash_at
    assert (info["snapshot_step"], info["replayed"], recovered.step) == \
        _ref_recovery_info(mode, k, ref_tmp) == (3, 1, crash_at)
    done = _drive(sub, recovered, range(crash_at, n_steps))
    assert torch.equal(done.params, ref.params)
    _assert_states_equal(done.opt_state, ref.opt_state)
    _assert_states_equal(done.guard, ref.guard)


def test_resume_replays_rejected_steps_bit_exact(tmp_path):
    """A rejected (NaN) step logs an EMPTY payload; its replay applies the
    same sanitized zeros and guard transition the live step did."""
    fault = res.FaultPlan.single(1, "nan_grad")
    cfg = res.ResilienceConfig(directory=str(tmp_path / "res"),
                               snapshot_every=100, guard=res.GuardConfig(),
                               fault_plan=fault)
    sub = _sub(optimizer="adam", fault_plan=fault)
    ref = _drive(sub, _init_state(sub), range(4))
    assert int(ref.guard.nonfinite_count) == 1
    monitor = res.ResilienceMonitor(cfg, sub)
    _drive(sub, _init_state(sub), range(3), monitor)
    monitor.log.close()
    assert [e.reason for e in monitor.events] == [res.REASON_NONFINITE_LOCAL]
    _, records, _ = res.ReplayLog.read(monitor.log.path)
    assert records[1].coords is None
    recovered, info = res.recover(cfg, sub, _init_state(sub))
    assert info["snapshot_step"] is None and info["replayed"] == 3
    done = _drive(sub, recovered, range(3, 4))
    assert torch.equal(done.params, ref.params)
    _assert_states_equal(done.opt_state, ref.opt_state)
    assert int(done.guard.nonfinite_count) == 1
    # an unguarded replay refuses a rejected record
    with pytest.raises(ValueError, match="unguarded"):
        res.replay_records(_sub(optimizer="adam", guarded=False),
                           _init_state(sub), records)


def test_recover_skips_corrupt_snapshot_with_reason_code(tmp_path):
    cfg = res.ResilienceConfig(directory=str(tmp_path / "res"),
                               snapshot_every=2, guard=res.GuardConfig())
    sub = _sub()
    monitor = res.ResilienceMonitor(cfg, sub)
    ref = _drive(sub, _init_state(sub), range(5), monitor)
    monitor.log.close()
    newest = os.path.join(monitor.snapshot_dir, "ckpt_00000004.npz")
    with open(newest, "r+b") as fh:
        fh.seek(30)
        fh.write(b"\x00" * 64)
    recovered, info = res.recover(cfg, sub, _init_state(sub))
    assert info["snapshot_step"] == 2 and info["replayed"] == 3
    assert any(e.reason == res.REASON_CKPT_CORRUPT for e in info["events"])
    assert torch.equal(recovered.params, ref.params)


def test_recover_truncated_log_stops_at_tear(tmp_path):
    cfg = res.ResilienceConfig(directory=str(tmp_path / "res"),
                               snapshot_every=100, guard=res.GuardConfig())
    sub = _sub()
    monitor = res.ResilienceMonitor(cfg, sub)
    mid = _drive(sub, _init_state(sub), range(3), monitor)
    size_3 = os.path.getsize(monitor.log.path)
    _drive(sub, mid, range(3, 5), monitor)
    monitor.log.close()
    with open(monitor.log.path, "r+b") as fh:
        fh.truncate(size_3 + 11)  # tear inside record 3
    with pytest.warns(UserWarning, match="torn"):
        recovered, info = res.recover(cfg, sub, _init_state(sub))
    assert info["truncated"] and info["replayed"] == 3
    assert any(e.reason == res.REASON_LOG_TRUNCATED for e in info["events"])
    assert torch.equal(recovered.params, mid.params)


def test_recover_empty_directory_returns_none(tmp_path):
    cfg = res.ResilienceConfig(directory=str(tmp_path / "void"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        state, info = res.recover(cfg, _sub(), _init_state(_sub()))
    assert state is None and info["replayed"] == 0 and info["events"] == []


def test_reference_replay_raises_on_slabs_where_the_port_replays():
    """ROADMAP.md Queue C 32: the reference's ``replay_records`` calls
    ``apply_exchanged`` outside any ``shard_map``, so on the model-sharded
    slabs its ``axis_index('model')`` is unbound and the resume raises;
    the port replays the same record on each slab -- one slab apply a
    slab, no projection -- and lands on the unsharded replay's buffer."""
    from repro_torch.kernels import rbd_step

    m = 2
    rec = res.ReplayRecord(
        step=0, reason=res.REASON_OK, lr_scale=1.0,
        coords=np.random.default_rng(4).standard_normal(
            _plan().packed().d_packed).astype(np.float32),
        row_sq=np.random.default_rng(5).random(
            _plan().packed().d_packed).astype(np.float32) + 0.5)
    ref = dataclasses.replace(_ref_sub(), model_sharded=True,
                              model_axis="model", model_shards=m)
    theta = jnp.asarray(ref.prepare_params(_ref_params()))
    ref_state = _ref_init_state(ref)._replace(params=theta)
    with pytest.raises(NameError, match="unbound axis name: model"):
        ref_res.replay_records(ref, ref_state, [ref_res.ReplayRecord(*rec)])

    single = _sub()
    sharded = dataclasses.replace(single, model_sharded=True,
                                  model_axis="model", model_shards=m)
    assert np.asarray(theta).shape == (sharded.sharded_layout().q_padded,)
    padded = torch.from_numpy(np.asarray(theta).copy())
    state = _init_state(sharded)._replace(
        params=[sharded.slab_of(padded, s).clone() for s in range(m)])
    rbd_step.reset_counts()
    out, n = res.replay_records(sharded, state, [rec])
    assert n == 1 and out.step == 1
    assert {k: v for k, v in rbd_step.CALLS.items() if v} == {
        "reconstruct_apply_packed_sharded": m}
    want, _ = res.replay_records(single, _init_state(single), [rec])
    got = torch.cat(out.params)
    q = single.transform.plan.packed().q_packed
    assert torch.equal(got[:q], want.params)
    assert bool((got[q:] == 0).all())
    _assert_states_equal(out.opt_state, want.opt_state)
    _assert_states_equal(out.guard, want.guard)
