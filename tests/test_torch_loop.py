"""Port parity of the single-process loop ``train.loop.train`` against the
reference's ``repro.train.loop.train`` on the reduced qwen2-0.5b (the
packed step: the port's kernels' plain versions, the reference's jnp
backend), from the reference's initial parameters and batches.

* one 4-step run in each package with momentum, one global compartment
  of rbd-dim 16 (the reference traces every segment's seed folds op by
  op: a layer plan would add ~10 s to its compile), an evaluation
  every 2 steps, a checkpoint every 3, the guard, the replay log with a
  snapshot every 2 and a NaN gradient at step 1:
  the losses within 1e-5 (relative), the history's records (steps, keys,
  scalar metrics within 1e-5 relative plus 1e-6 absolute, guard codes
  exactly) and eval records (within 1e-5), and the recovery events'
  (step, reason) pairs equal; the port's checkpoint restores through the
  reference's ``checkpoint.io`` onto the reference's state template, with
  the parameters within 1e-4 of the reference's own checkpoint of the
  same step (three steps of float32 rounding, test_torch_steps.py);
* kill and resume with the replay log: a port run killed before step 3,
  then resumed from its directory, ends bit for bit the uninterrupted
  port run (one intra-op thread), with no new recovery event;
* ``grad_accum_steps`` 2 on the layer plan: the loop's losses and theta
  equal ``launch.train.run_training``'s on the same stream bit for bit,
  and the stream gave 2 batches a step (against the reference's loop:
  tests/test_torch_loop_accum.py);
* ``device="cuda"`` without a card raises, and the loop returns two
  values without resilience.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_ckpt
from repro.configs import get_config as ref_config
from repro.configs.base import RBDConfig as RefRBDConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import compartments as ref_comp
from repro.core import resilience as ref_res
from repro.data import synthetic as ref_data
from repro.models import get_model as ref_model
from repro.train import loop as ref_loop
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.core import resilience as res
from repro_torch.data import synthetic
from repro_torch.launch import train as launcher
from repro_torch.models.registry import Model, get_model, params_from_reference
from repro_torch.train import loop
from repro_torch.train import step as steplib

# One intra-op thread: bit-exact resume (and the suite runs several test
# processes at once).
torch.set_num_threads(1)

STEPS = 4
DIM = 16
# one flattened compartment: the reference traces the seed folds of every
# segment op by op, ~10 s of its compile on the layer plan
PLAN = "global"
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


def _ref_tcfg(cfg):
    return RefTrainConfig(model=cfg, optimizer="momentum",
                          rbd=RefRBDConfig(total_dim=DIM, backend="jnp",
                                           packed="on", granularity=PLAN),
                          learning_rate=0.5, steps=STEPS, batch_size=2,
                          seq_len=16)


def _tcfg(cfg, granularity=PLAN, **kw):
    kw = {"steps": STEPS, **kw}
    return TrainConfig(model=cfg, optimizer="momentum",
                       rbd=RBDConfig(total_dim=DIM, backend="cuda",
                                     granularity=granularity),
                       learning_rate=0.5, batch_size=2, seq_len=16, **kw)


def _ref_rcfg(directory, kill=False):
    events = [ref_res.FaultEvent(1, "nan_grad")]
    return ref_res.ResilienceConfig(
        directory=str(directory), snapshot_every=2,
        guard=ref_res.GuardConfig(),
        fault_plan=ref_res.FaultPlan(tuple(events)))


def _rcfg(directory, kill=False):
    events = [res.FaultEvent(1, "nan_grad")]
    if kill:
        events.append(res.FaultEvent(3, "kill"))
    return res.ResilienceConfig(
        directory=str(directory), snapshot_every=2, guard=res.GuardConfig(),
        fault_plan=res.FaultPlan(tuple(events)))


def _starting_from(model, params):
    """``model`` whose ``init`` returns a copy of ``params`` (the
    reference's initial parameters: jax.random cannot be reproduced)."""

    class Start(Model):
        def init(self, seed=0, *, device="cuda"):
            return {k: v.clone().to(device) for k, v in params.items()}

    return Start(**{f.name: getattr(model, f.name)
                    for f in dataclasses.fields(Model)})


def _torch_batches(batches):
    return iter([{k: torch.from_numpy(np.array(v)).long()
                  for k, v in b.items()} for b in batches])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    rcfg = ref_config("qwen2-0.5b").reduced(compute_dtype="float32")
    rmodel = ref_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(rparams)
    named = {ref_comp._leaf_name(p): np.asarray(x) for p, x in flat}
    stream = ref_data.lm_batches(0, 2, 16, rcfg.vocab)
    batches = [jax.device_get(next(stream)) for _ in range(STEPS + 1)]
    eval_batch = batches[-1]

    ref_eval = jax.jit(lambda p: ref_step.make_loss_fn(rmodel)(
        p, eval_batch)[0])
    r_state, r_hist, r_mon = ref_loop.train(
        rmodel, _ref_tcfg(rcfg), iter(batches[:STEPS]),
        eval_fn=ref_eval, eval_every=2,
        log_every=1, checkpoint_dir=str(d / "ref_ckpt"), checkpoint_every=3,
        resilience=_ref_rcfg(d / "ref_res"))

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = _starting_from(get_model(cfg),
                           params_from_reference(named, device="cpu"))
    loss = steplib.make_loss_fn(model)
    t_eval = next(_torch_batches([eval_batch]))

    def port(directory, **kw):
        return loop.train(
            model, _tcfg(cfg), _torch_batches(batches[:STEPS]),
            eval_fn=lambda p: loss(p, t_eval)[0], eval_every=2,
            log_every=1, checkpoint_dir=str(d / "ckpt"), checkpoint_every=3,
            resilience=_rcfg(directory, **kw), device="cpu")

    p_state, p_hist, p_mon = port(d / "res")
    with pytest.raises(res.SimulatedWorkerKill, match="kills step 3"):
        port(d / "killed", kill=True)
    resumed = loop.train(
        model, _tcfg(cfg), _torch_batches(batches[:STEPS]),
        resilience=_rcfg(d / "killed"), resume=True, device="cpu",
        verbose=False)
    return dict(dir=d, rmodel=rmodel, r=(r_state, r_hist, r_mon),
                p=(p_state, p_hist, p_mon), resumed=resumed, model=model,
                cfg=cfg)


def test_losses_and_history_match_reference(runs):
    _, r_hist, _ = runs["r"]
    _, p_hist, _ = runs["p"]
    assert [h["step"] for h in p_hist] == [h["step"] for h in r_hist] \
        == list(range(STEPS))
    for r, p in zip(r_hist, p_hist):
        assert set(p) == set(r), (sorted(p), sorted(r))
        for k in r:
            if k in ("wall", "step"):
                continue
            if k.startswith("guard_"):
                assert p[k] == r[k], (r["step"], k)
            elif k in ("loss", "ce", "eval"):
                np.testing.assert_allclose(p[k], r[k], rtol=LOSS_RTOL,
                                           err_msg=f"{k} step {r['step']}")
            else:
                np.testing.assert_allclose(p[k], r[k], rtol=LOSS_RTOL,
                                           atol=1e-6,
                                           err_msg=f"{k} step {r['step']}")
    # step 1's NaN gradient was rejected in both packages
    assert r_hist[1]["guard_reason"] == p_hist[1]["guard_reason"] \
        == res.REASON_NONFINITE_LOCAL


def test_eval_records_match_reference(runs):
    _, r_hist, _ = runs["r"]
    _, p_hist, _ = runs["p"]
    r_eval = {h["step"]: h["eval"] for h in r_hist if "eval" in h}
    p_eval = {h["step"]: h["eval"] for h in p_hist if "eval" in h}
    assert sorted(p_eval) == sorted(r_eval) == [1, 3]
    for s in r_eval:
        np.testing.assert_allclose(p_eval[s], r_eval[s], rtol=LOSS_RTOL)


def test_recovery_events_match_reference(runs):
    _, _, r_mon = runs["r"]
    _, _, p_mon = runs["p"]
    assert [(e.step, e.reason) for e in p_mon.events] == \
        [(e.step, e.reason) for e in r_mon.events] == \
        [(1, res.REASON_NONFINITE_LOCAL)]


def test_checkpoint_restores_through_the_reference(runs):
    r_state = runs["r"][0]
    d = runs["dir"]
    # the reference's template: its state with the parameter tree
    r_opt = ref_step.make_train_step(runs["rmodel"], _ref_tcfg(
        ref_config("qwen2-0.5b").reduced(compute_dtype="float32")),
        return_optimizer=True, resilience=_ref_rcfg(d / "tmpl"))[2]
    template = r_state._replace(params=r_opt.materialize_params(
        r_state.params))
    assert ref_ckpt.latest_step(str(d / "ckpt")) == 2
    got = ref_ckpt.restore(str(d / "ckpt"), template)
    want = ref_ckpt.restore(str(d / "ref_ckpt"), template)
    g_leaves = jax.tree_util.tree_leaves(got.params)
    w_leaves = jax.tree_util.tree_leaves(want.params)
    assert len(g_leaves) == len(w_leaves) > 0
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL)
    assert int(got.step) == int(want.step) == 3


def test_kill_and_resume_is_bit_exact(runs):
    p_state, _, _ = runs["p"]
    r_state, _, r_mon = runs["resumed"]
    assert r_state.step == p_state.step == STEPS
    assert torch.equal(r_state.params, p_state.params)
    for a, b in zip(res._tree_leaves(r_state.opt_state),
                    res._tree_leaves(p_state.opt_state)):
        assert torch.equal(a, b)
    assert torch.equal(r_state.guard.lr_scale, p_state.guard.lr_scale)
    assert int(r_state.guard.nonfinite_count) == 1
    # snapshot 2 and record 2 survive the kill before step 3: nothing new
    assert r_mon.events == []


def test_grad_accum_matches_the_launcher(runs):
    cfg = runs["cfg"]
    stream = synthetic.lm_batches(0, 2, 16, cfg.vocab, device="cpu")
    # the launcher's plan (layer granularity)
    tcfg = _tcfg(cfg, granularity="layer", grad_accum_steps=2)
    state, hist = loop.train(get_model(cfg), tcfg, stream, log_every=1,
                             device="cpu")
    assert stream.step == 2 * STEPS
    ref = launcher.run_training(cfg, steps=STEPS, batch=2, seq=16,
                                grad_accum_steps=2, lr=0.5, rbd_dim=DIM,
                                optimizer="momentum", rbd_backend="cuda",
                                device="cpu")
    assert [h["loss"] for h in hist] == ref.losses
    assert torch.equal(state.params, ref.state.params)


def test_cuda_without_a_card_raises_and_plain_returns_two():
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    data = synthetic.lm_batches(0, 2, 8, cfg.vocab, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            loop.train(model, _tcfg(cfg), data)
    out = loop.train(model, dataclasses.replace(_tcfg(cfg), steps=1), data,
                     verbose=False, device="cpu")
    assert len(out) == 2 and out[0].step == 1 and out[1] == []
