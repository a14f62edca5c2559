"""The port's kg_completion example (``repro_torch.examples``) on the
CPU (serve_batch and train_lm: tests/test_torch_examples_launch.py):

- at its own settings its loss falls (the example's own assert), from
  the port's own initial weights;
- its ``PathCorpus`` batches equal ``repro``'s bit for bit at every one
  of the 30 steps (paths are a bit-identity promise of the port);
- started from ``repro``'s initial parameters and AdamW state, carried
  across through ``params_from_numpy`` and ``adamw.state_from_numpy``
  as tests/test_torch_training.py does, every logged loss of the 30
  steps is within ``LOSS_RTOL`` = 1e-5 relative of ``repro``'s: that
  file's tolerance (XLA:CPU and torch's CPU matmuls sum in other orders
  in float32).
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.configs.base import ArchConfig as JArchConfig
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs.base import ArchConfig
from repro_torch.examples import kg_completion
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer
from torch_example_parity import run_port

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel test workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _repro_corpus():
    return jpipe.PathCorpus(graph=rc.power_law(500, 5.0, seed=11), k=4,
                            seq_len=32, global_batch=8)


def test_kg_completion_learns_at_its_own_settings():
    text, values = run_port("kg_completion")
    assert text.splitlines()[-1] == "OK"
    (s0, first), (s1, last) = values["first"], values["last"]
    assert (s0, s1) == (0, kg_completion.STEPS - 1)
    assert np.isfinite(first) and last < first
    assert [s for s, _ in values["log"]] == [0, 5, 10, 15, 20, 25, 29]


def test_kg_completion_corpus_equals_repro():
    want, got = _repro_corpus(), kg_completion.corpus("cpu")
    assert got.vocab == want.vocab
    for step in range(kg_completion.STEPS):
        a, b = got.batch_at(step), want.batch_at(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes(), (step, key)


def test_kg_completion_losses_equal_repro_from_its_weights(monkeypatch):
    data = _repro_corpus()
    jcfg = JArchConfig(vocab=data.vocab, **kg_completion.ARCH)
    jtr = JTrainer(jcfg, jadamw.OptimizerConfig(**kg_completion.OPT),
                   JTrainerConfig(steps=kg_completion.STEPS, log_every=5))
    jparams, jstate = jax.tree.map(np.asarray, jtr.init_state())
    jtr.fit(data)

    cfg = ArchConfig(vocab=data.vocab, **kg_completion.ARCH)

    def carried(self):
        return (ttf.params_from_numpy(cfg, jparams, device="cpu"),
                adamw.state_from_numpy(cfg, jstate, device="cpu"))

    monkeypatch.setattr(Trainer, "init_state", carried)
    _, values = run_port("kg_completion")
    want = [(r["step"], r["loss"]) for r in jtr.metrics_log]
    assert [s for s, _ in values["log"]] == [s for s, _ in want]
    np.testing.assert_allclose([x for _, x in values["log"]],
                               [x for _, x in want], rtol=LOSS_RTOL)
