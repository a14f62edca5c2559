"""Every registry arch trains on the port as on ``repro`` (the port's
counterpart of ``repro``'s ``test_arch_smoke_forward_and_train_step``),
part one: the attention-only archs, dense (internlm2, llama3.2, mistral,
starcoder2), vlm (phi3-vision), audio (musicgen), and llama4-maverick,
whose ``reduced()`` is a tailed moe plan.  The other archs and the
repairs are in tests/test_torch_train_recurrent.py (two files keep each
under the suite's 30 s guideline).  Cases and tolerances:
tests/torch_train_parity.py.
"""
import pytest
import torch

import torch_train_parity as tp

ARCHS = ["internlm2_1p8b", "llama3p2_1b", "mistral_large_123b",
         "starcoder2_7b", "phi3_vision_4p2b", "musicgen_large",
         "llama4_maverick_400b_a17b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", ARCHS)
def test_train_step_equals_repro(case):
    """Loss (moe aux included), every gradient and one AdamW step."""
    tp.check_case(case)
