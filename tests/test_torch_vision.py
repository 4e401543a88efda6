"""Port parity of the paper's image models (``repro_torch.models.vision``)
and their synthetic data (``repro_torch.data.synthetic``) against
``repro.models.vision`` and ``repro.data.synthetic``: the leaves and
parameter counts at both geometries, ``apply`` and the loss gradient of
FC, CNN and ResNet8 from the reference's parameters and images carried
across through numpy, the class templates, one ``rbd_gradient`` step on
the per-leaf path.  The reference's acceptance run of RBD on FC
(tests/test_system.py:55) runs on the card, on the per-leaf kernels
(chip_smoke.py phase 21): on the CPU its 120 steps of the plain
generator take two minutes.

Tolerances: logits within 1e-5 of their largest magnitude and each
leaf's gradient within 2e-5 of its largest magnitude (float32
convolutions and matmuls summed in another order; measured at most 8e-7
and 1.4e-6 of it); the class templates bit for bit.  The RBD sketch and
the new parameters within 1e-4 of the largest update + 2 ulp of the
largest value (tests/test_torch_per_leaf.py's gate: normal samples
differ from XLA's by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compartments as ref_comp
from repro.core import projector as ref_proj
from repro.core.rbd import RandomBasesTransform as RefTransform
from repro.data import synthetic as ref_data
from repro.models import vision as ref_vision
from repro_torch.core import compartments, projector
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.data import synthetic
from repro_torch.models import vision

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

LOGITS_RTOL = 1e-5
GRAD_RTOL = 2e-5
EPS32 = 2.0 ** -23
MNIST, CIFAR = (28, 28, 1), (32, 32, 3)
# the reference's parameter counts (the paper's for FC and CNN)
COUNTS = {("fc", MNIST): 101_770, ("fc", CIFAR): 394_634,
          ("cnn", MNIST): 93_322, ("cnn", CIFAR): 122_570,
          ("resnet8", MNIST): 77_418, ("resnet8", CIFAR): 77_706}
# ResNet8 at 32x32 runs its stride-2 convolutions on even inputs, where
# XLA's SAME pads 0 before and 1 after
APPLY_CASES = [("fc", (14, 14, 1)), ("cnn", CIFAR), ("resnet8", CIFAR)]


def _named(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_comp._leaf_name(p): np.asarray(x) for p, x in flat}


def _nest(named: dict) -> dict:
    out = {}
    for name, v in named.items():
        node, leaf = name.split("/")
        out.setdefault(node, {})[leaf] = jnp.asarray(v)
    return out


def _torch(named: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in named.items()}


def _reference(name, shape, n=4):
    """The reference's parameters (numpy, by leaf name) and a batch of its
    mixture images."""
    init, _ = ref_vision.get_vision_model(name)
    params = _named(jax.jit(lambda k: init(k, shape))(jax.random.PRNGKey(0)))
    x, y = jax.jit(lambda k: ref_data.mixture_images(
        k, n, shape=shape, noise=0.8))(jax.random.PRNGKey(7))
    return params, np.asarray(x), np.asarray(y)


def _ref_loss(apply):
    def loss(p, x, y):
        logp = jax.nn.log_softmax(apply(p, x))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    return loss


def _loss(apply, p, x, y):
    return torch.nn.functional.cross_entropy(apply(p, x), y)


@pytest.mark.parametrize("name", sorted(vision.MODELS))
@pytest.mark.parametrize("shape", [MNIST, CIFAR], ids=["mnist", "cifar"])
def test_leaves_and_counts_match_reference(name, shape):
    init, _ = vision.get_vision_model(name)
    p = init(0, shape, device="cpu")
    rinit, _ = ref_vision.get_vision_model(name)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: rinit(jax.random.PRNGKey(0), shape)))
    want = {ref_comp._leaf_name(k): tuple(v.shape) for k, v in flat}
    assert list(p) == list(want)
    assert {k: tuple(v.shape) for k, v in p.items()} == want
    assert {v.dtype for v in p.values()} == {torch.float32}
    assert vision.count_params(p) == COUNTS[(name, shape)]
    assert all(bool((p[k] == 0).all()) for k in p if k.endswith("/b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init(0, shape)


@pytest.mark.parametrize("name,shape", APPLY_CASES,
                         ids=[f"{n}-{s[0]}x{s[2]}" for n, s in APPLY_CASES])
def test_apply_and_gradient_match_reference(name, shape, monkeypatch):
    named, x, y = _reference(name, shape)
    _, rapply = ref_vision.get_vision_model(name)
    want = np.asarray(jax.jit(rapply)(_nest(named), jnp.asarray(x)))
    rgrads = _named(jax.jit(jax.grad(_ref_loss(rapply)))(
        _nest(named), jnp.asarray(x), jnp.asarray(y)))
    _, apply = vision.get_vision_model(name)
    p = {k: v.requires_grad_(True) for k, v in _torch(named).items()}
    tx = torch.from_numpy(np.array(x))
    ty = torch.from_numpy(np.array(y)).long()
    logits = apply(p, tx)
    atol = LOGITS_RTOL * np.abs(want).max()
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=atol)
    grads = torch.autograd.grad(_loss(apply, p, tx, ty), list(p.values()))
    for (k, g) in zip(p, grads):
        np.testing.assert_allclose(
            g.numpy(), rgrads[k], rtol=0,
            atol=GRAD_RTOL * np.abs(rgrads[k]).max(), err_msg=k)
    if name == "resnet8":
        # symmetric padding (torch's padding=1) is not XLA's SAME at
        # stride 2: it shifts every strided output and fails the check
        monkeypatch.setattr(vision, "_same_pads",
                            lambda n, k, s: ((k - 1) // 2, (k - 1) // 2))
        with torch.no_grad():
            sym = apply(p, tx).numpy()
        assert np.abs(sym - want).max() > 100 * atol


@pytest.mark.parametrize("seed,n_classes,shape", [
    (0, 10, MNIST), (3, 10, CIFAR), (1, 4, (14, 14, 1))])
def test_class_templates_bit_for_bit(seed, n_classes, shape):
    got = synthetic._class_templates(seed, n_classes, shape)
    want = ref_data._class_templates(seed, n_classes, shape)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_mixture_dataset_draws():
    """Labels in range, images the class template plus noise of the given
    scale, batch i a function of (seed, i) alone (skip is O(1))."""
    shape = (14, 14, 1)
    stream = synthetic.mixture_dataset(2, 256, shape=shape, noise=0.8,
                                       device="cpu")
    x, y = next(stream)
    assert tuple(x.shape) == (256, *shape) and x.dtype == torch.float32
    assert tuple(y.shape) == (256,) and y.dtype == torch.int64
    assert 0 <= int(y.min()) and int(y.max()) < 10
    t = torch.from_numpy(synthetic._class_templates(2, 10, shape))
    assert 0.78 < float((x - t[y]).std()) < 0.82
    x1, _ = next(stream)
    again = synthetic.mixture_dataset(2, 256, shape=shape, noise=0.8,
                                      device="cpu")
    assert torch.equal(next(again)[0], x)
    assert torch.equal(next(again.skip(0))[0], x1)
    assert not torch.equal(x1, x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            next(synthetic.mixture_dataset(0, 2))


def test_rbd_gradient_step_matches_reference():
    """One step of the reference's acceptance loop (tests/test_system.py):
    the plan of make_plan(params, 128), the sketch of the loss gradient
    (``rbd_gradient``, per leaf, backend jnp / the port's ``torch`` and
    ``cuda`` -- the per-leaf kernels' plain versions here) at step 0's
    seed, theta - 2.0 * sketch, on FC at 14x14x1 (the reference's
    per-leaf jnp path compiles each leaf's generation: seconds a leaf)."""
    named, x, y = _reference("fc", (14, 14, 1))
    _, rapply = ref_vision.get_vision_model("fc")
    rparams = _nest(named)
    rplan = ref_comp.make_plan(rparams, 128)
    rt = RefTransform(rplan, 0)
    g = jax.grad(_ref_loss(rapply))(rparams, jnp.asarray(x), jnp.asarray(y))
    rsketch = _named(ref_proj.rbd_gradient(g, rplan, rt.step_seed(0)))
    plan = compartments.make_plan(_torch(named), 128)
    for a, b in zip(plan.leaves, rplan.leaves, strict=True):
        assert (a.name, a.shape, a.dim, a.seed_tag) == (
            b.name, tuple(b.shape), b.dim, b.seed_tag)
    t = RandomBasesTransform(plan, 0)
    assert int(t.step_seed(0)) & 0xFFFFFFFF == int(rt.step_seed(0))
    grads = _torch(_named(g))
    for backend in ("torch", "cuda"):
        sketch = projector.rbd_gradient(grads, plan, t.step_seed(0),
                                        backend=backend)
        for k, want in rsketch.items():
            tol = 1e-4 * np.abs(want).max() + 2 * EPS32 * np.abs(want).max()
            np.testing.assert_allclose(sketch[k].numpy(), want, rtol=0,
                                       atol=tol, err_msg=(backend, k))
            new = (torch.from_numpy(named[k]) - 2.0 * sketch[k]).numpy()
            rnew = named[k] - np.float32(2.0) * want
            upd = np.abs(rnew - named[k]).max()
            np.testing.assert_allclose(
                new, rnew, rtol=0,
                atol=1e-4 * upd + 2 * EPS32 * np.abs(rnew).max(),
                err_msg=(backend, k))
