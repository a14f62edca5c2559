"""The port's async_serving and multi_tenant_serving examples against
``repro``'s scripts on the CPU (the rest: tests/test_torch_examples.py).

Their printed lines are equal with times masked; the lines in
``CLOCK_BOUND_LINES`` are left out, each for the reason beside it.
async_serving's result counts, which the example asserts equal to the
sync server's, are compared in full.
"""
import pytest
import torch

from torch_example_parity import assert_same_lines

# lines of an example's output left out of the comparison, by prefix
CLOCK_BOUND_LINES = {
    "async_serving": {
        "  SLO (50 ms) met on ": (
            "how many lights meet their 50 ms deadline, and in how many "
            "micro-batches they go, follows the wall clock: the same run "
            "gives 20/20 alone and 0/20 on a loaded host"),
    },
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel test workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_async_serving_prints_repro_lines():
    _, values = assert_same_lines("async_serving",
                                  CLOCK_BOUND_LINES["async_serving"])
    assert values["lights"] == 20 and values["rejected"] == 0
    assert sum(values["counts"].values()) == 1_731_535


def test_multi_tenant_serving_prints_repro_lines():
    _, values = assert_same_lines("multi_tenant_serving")
    shed, ok_steady, rejections, _ = values["async"]
    assert (shed, ok_steady, rejections) == (4, 3, 4)
    assert values["retired"] == (0, "rejected_unknown_graph")
