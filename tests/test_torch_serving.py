"""The port's ``ServeEngine`` against ``repro``'s, on the CPU.

Both engines serve the same requests with the same weights (``repro``'s
``init_params``, handed to the port by ``params_from_numpy``), on
tests/test_serving.py's tiny config and prompts: FIFO admission, prompt
replay through batched decode steps, continuous re-fill, the EOS,
``max_tokens`` and ``max_len - 1`` stops, and ``steps_run``.  Outputs
must be equal token for token.  The two packages' float32 logits differ
by rounding (well under 1e-4, the bound tests/test_torch_models.py
holds), so a greedy token could flip only where two logits tie that
closely; if a token ever differs, the test requires that the two top
logits at that step lie within 1e-4 and compares no further.

The port writes its cache in place, so entries at or past a slot's
length may differ from ``repro``'s; every entry below it must agree.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import transformer as jtf
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import Request, ServeEngine

TIE_TOL = 1e-4
CFG_ARGS = dict(name="tiny_serve", family="dense", num_layers=2, d_model=64,
                num_heads=4, kv_heads=2, d_ff=128, vocab=97, head_dim=16,
                attn_chunk=16, tie_embeddings=True)
JCFG = JArchConfig(**CFG_ARGS)
CFG = ArchConfig(**CFG_ARGS)
PROMPTS = [[5, 9, 13], [2, 7], [40, 41, 42, 43]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    jparams = jtf.init_params(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, ttf.params_from_numpy(CFG, tree, device="cpu")


def _serve(weights, reqs, impl=None, **kw):
    """Both engines on copies of ``reqs`` = [(uid, prompt, max_tokens,
    eos_id)]; returns (port engine, port results, repro engine, repro
    results)."""
    jparams, tparams = weights
    jeng = JServeEngine(JCFG, jparams, **kw)
    teng = ServeEngine(CFG, tparams, device="cpu", impl=impl, **kw)
    for uid, prompt, n, eos in reqs:
        p = np.asarray(prompt, np.int32)
        jeng.submit(JRequest(uid=uid, prompt=p, max_tokens=n, eos_id=eos))
        teng.submit(Request(uid=uid, prompt=p, max_tokens=n, eos_id=eos))
    return teng, teng.run(), jeng, jeng.run()


def _teacher_logits(tparams, tokens, max_len):
    """The port's logits after each of ``tokens``, fed one at a time."""
    cache = ttf.init_cache(CFG, 1, max_len, device="cpu")
    lens = torch.zeros(1, dtype=torch.int32)
    out = []
    for tok in tokens:
        lg, cache = ttf.decode_step(tparams, CFG, torch.tensor([tok]), cache,
                                    lens)
        out.append(lg[0])
        lens = lens + 1
    return out


def _assert_equal_or_tied(weights, reqs, got, want, max_len):
    """Equal outputs, or a first difference at a near-tie of the port's
    two top logits."""
    assert set(got) == set(want)
    prompts = {uid: list(p) for uid, p, _, _ in reqs}
    for uid in want:
        g, w = got[uid], list(want[uid])
        diff = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if diff is None:
            assert len(g) == len(w), uid
            continue
        seq = prompts[uid] + g[:diff]
        logits = _teacher_logits(weights[1], seq, max_len)[-1]
        top2 = torch.topk(logits, 2).values
        assert float(top2[0] - top2[1]) < TIE_TOL, (uid, diff, g, w)


def _assert_caches_agree_below_lengths(teng, jeng):
    jk, jv = jeng.cache["supers"]["b0_attn"]
    lens = np.asarray(jeng.lens)
    assert teng.lens.tolist() == lens.tolist()
    for b, n in enumerate(lens):
        for t, j in ((teng.cache["k"], jk), (teng.cache["v"], jv)):
            np.testing.assert_allclose(t[:, b, :n].numpy(),
                                       np.asarray(j)[:, b, :n], atol=TIE_TOL,
                                       rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_engine_matches_repro(weights, impl):
    reqs = [(uid, p, 6, None) for uid, p in enumerate(PROMPTS)]
    teng, got, jeng, want = _serve(weights, reqs, impl=impl, batch_slots=2,
                                   max_len=64)
    _assert_equal_or_tied(weights, reqs, got, want, 64)
    assert teng.steps_run == jeng.steps_run
    _assert_caches_agree_below_lengths(teng, jeng)


def test_more_requests_than_slots(weights):
    reqs = [(uid, [uid + 3], 3, None) for uid in range(5)]
    teng, got, jeng, want = _serve(weights, reqs, batch_slots=2, max_len=32)
    assert len(got) == 5 and all(len(v) == 3 for v in got.values())
    _assert_equal_or_tied(weights, reqs, got, want, 32)
    assert teng.steps_run == jeng.steps_run
    assert all(s is None for s in teng.slots) and not teng.queue


def test_eos_stops_a_request(weights):
    first = [(uid, p, 8, None) for uid, p in enumerate(PROMPTS)]
    _, plain, _, _ = _serve(weights, first, batch_slots=2, max_len=64)
    eos = plain[0][2]                      # request 0's third token
    reqs = [(uid, p, 8, eos) for uid, p in enumerate(PROMPTS)]
    teng, got, jeng, want = _serve(weights, reqs, batch_slots=2, max_len=64)
    assert got[0] == plain[0][:plain[0].index(eos) + 1]
    _assert_equal_or_tied(weights, reqs, got, want, 64)
    assert teng.steps_run == jeng.steps_run


def test_max_len_stops_a_request(weights):
    reqs = [(0, [3, 1, 4, 1, 5], 50, None), (1, [9, 2], 4, None),
            (2, [6, 5, 3], 50, None)]
    teng, got, jeng, want = _serve(weights, reqs, batch_slots=2, max_len=12)
    # a 5-token prompt leaves room for max_len - 1 - 4 = 7 tokens
    assert len(got[0]) == 7
    _assert_equal_or_tied(weights, reqs, got, want, 12)
    assert teng.steps_run == jeng.steps_run
    _assert_caches_agree_below_lengths(teng, jeng)


def test_slot_reuse_does_not_leak(weights):
    """A request served in a slot that others used before gives what it
    gives in a fresh engine."""
    probe = (9, [40, 41, 42, 43], 6, None)
    _, alone, _, _ = _serve(weights, [probe], batch_slots=1, max_len=64)
    reqs = [(0, [5, 9, 13, 17, 21, 25], 9, None), probe]
    teng, got, jeng, want = _serve(weights, reqs, batch_slots=1, max_len=64)
    assert got[9] == alone[9]
    _assert_equal_or_tied(weights, reqs, got, want, 64)


def test_sampling_is_seeded(weights):
    _, tparams = weights
    outs = []
    for seed in (3, 3, 4):
        eng = ServeEngine(CFG, tparams, batch_slots=2, max_len=32,
                          temperature=1.0, seed=seed, device="cpu")
        for uid, p in enumerate(PROMPTS):
            eng.submit(Request(uid=uid, prompt=np.asarray(p, np.int32),
                               max_tokens=8))
        outs.append(eng.run())
    assert outs[0] == outs[1] and outs[0] != outs[2]
    assert all(0 <= t < CFG.vocab for v in outs[2].values() for t in v)


def test_submit_rejects_bad_prompts(weights):
    eng = ServeEngine(CFG, weights[1], batch_slots=1, max_len=4,
                      device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=np.zeros(0, np.int32)))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=1, prompt=np.zeros(5, np.int32)))
    eng.submit(Request(uid=2, prompt=np.zeros(4, np.int32), max_tokens=3))
    assert len(eng.run()[2]) == 1           # stops at max_len - 1
    with pytest.raises(ValueError, match="params"):
        ServeEngine(CFG, {"embed": torch.zeros(1, device="meta")},
                    device="cpu")
