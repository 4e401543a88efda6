"""The reference's tests/test_system.py::test_lm_training_reduces_loss on
the port: reduced tinyllama, the packed two-launch step (its plain
versions on the CPU), 30 steps at lr 0.5, total_dim 512."""

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.data import synthetic
from repro_torch.models.registry import get_model
from repro_torch.train import step as steplib

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)


def test_lm_training_reduces_loss():
    """The reference's tests/test_system.py::test_lm_training_reduces_loss
    on the port's packed path (plain versions on the CPU)."""
    cfg = get_config("tinyllama-1.1b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=512,
                                                backend="cuda"),
                       learning_rate=0.5, steps=30)
    init_state, train_step = steplib.make_train_step(model, tcfg,
                                                     device="cpu")
    state = init_state(0)
    data = synthetic.lm_batches(0, 8, 64, cfg.vocab, device="cpu")
    losses = []
    for _ in range(30):
        state, m = train_step(state, next(data))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses[::10]
