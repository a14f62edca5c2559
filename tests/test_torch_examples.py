"""The port's PathEnum examples (``repro_torch.examples``) against
``repro``'s scripts (``examples/*.py``) on the CPU: quickstart,
fraud_detection, batch_serving and streaming_serving here; async_serving
and multi_tenant_serving in tests/test_torch_examples_serving.py.

Each example prints ``repro``'s lines with the same numbers, times
masked (tests/torch_example_parity.py); none of their lines follows
the wall clock.  quickstart's
``index: ... KiB`` line holds ``LightweightIndex.memory_bytes`` to
``repro``'s end to end.  Without ``--device`` every example asks for
the card, and raises where there is none.
"""
import importlib

import pytest
import torch

import repro.core as rc
from repro_torch import examples
from torch_example_parity import EXAMPLES, assert_same_lines


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel test workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quickstart_prints_repro_lines_and_index_bytes():
    lines, values = assert_same_lines("quickstart")
    assert any(line.startswith("  index: ") and "KiB" in line
               for line in lines)
    g = rc.layered_dag(layers=4, width=8, fanout=3.0, seed=7)
    s, t, k = values["query"]
    assert (s, t, k) == (g.n - 2, g.n - 1, 5)
    assert values["index_bytes"] == rc.build_index(g, s, t, k).memory_bytes()
    assert values["results"] == values["oracle_paths"] == 166


def test_fraud_detection_prints_repro_lines():
    _, values = assert_same_lines("fraud_detection")
    assert values["flagged"] == len(values["cycles"]) == 10


def test_batch_serving_prints_repro_lines():
    _, values = assert_same_lines("batch_serving")
    assert values["cold_cache"] == (40, 10)
    assert values["total_results"] == sum(values["counts"])


def test_streaming_serving_prints_repro_lines():
    _, values = assert_same_lines("streaming_serving")
    assert values["async"][2:] == (12, 2, 10)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
@pytest.mark.parametrize("name", examples.NAMES)
def test_example_asks_for_the_card_by_default(name):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA"):
        mod.main([])


def test_example_names_cover_repro_scripts():
    assert sorted(examples.NAMES) == sorted(
        p.stem for p in EXAMPLES.glob("*.py"))
    assert set(examples.CLOCK_BOUND) <= set(examples.PATHENUM)
