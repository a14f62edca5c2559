"""The port's vlm, audio, moe, ssm and hybrid families against
``repro``'s, on the CPU.

Each case takes ``repro``'s parameters (``init_params`` from a JAX key)
to the port through ``params_from_numpy``, so both packages run the same
weights on the same numpy inputs: the six configs' ``reduced()``, plus a
tailed hybrid (``recurrentgemma_9b.reduced()`` with 5 layers: (rec, rec,
attn) once, then a (rec, rec) tail).  llama4's ``reduced()`` is itself
tailed: (moe, dense) once, then (moe,).

Tolerances: 1e-4 on logits, K/V and states (order 1), as
tests/test_torch_models.py: XLA:CPU and torch's CPU kernels sum in other
orders in float32 through a few layers of width 128.  The scans need no
more: the SSD chunk recurrence runs in the same order in both packages,
and the RG-LRU's Hillis-Steele scan and ``repro``'s associative scan
multiply decays in (0, 1), whose products differ by a few float32 ulps.
2e-3 for a decode chain against the whole-sequence forward of the same
package, ``repro``'s own bound (tests/test_models.py): the recurrent and
chunked forms of a scan sum in other orders.

Two mismatches inside ``repro`` (ROADMAP.md §3), where the port is held
to its own forward or to its own solo runs instead:
- ``repro``'s ``prefill`` skips the tail layers, so for a tailed plan
  its logits are not its forward's last position; the port's prefill
  equals ``repro``'s forward there.
- ``repro``'s ``ServeEngine`` finds the slot axis from shapes, and takes
  a tail layer's (B, W-1, C) conv window along axis 1 when B == W - 1;
  at 3 slots on the tailed hybrid the port equals its solo runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.training import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.training import step as tstep

ATOL = 1e-4
DECODE_ATOL = 2e-3
FAMILY_ARCHS = ["phi3_vision_4p2b", "musicgen_large", "qwen3_moe_30b_a3b",
                "llama4_maverick_400b_a17b", "mamba2_780m",
                "recurrentgemma_9b"]
TAILED = "recurrentgemma_9b_tail"
CASES = FAMILY_ARCHS + [TAILED]
PROMPTS = [[5, 9, 13, 7, 3], [2, 7, 11], [40, 41, 42, 43], [17, 4]]
SERVE_TOKENS = 6


def _cfgs(case):
    """(repro's config, the port's) for a case id."""
    arch = TAILED.rsplit("_", 1)[0] if case == TAILED else case
    j, t = jconfigs.get_arch(arch).reduced(), tconfigs.get_arch(arch).reduced()
    if case == TAILED:
        j = dataclasses.replace(j, num_layers=5)
        t = dataclasses.replace(t, num_layers=5)
    return j, t


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=CASES)
def model(request):
    """(case, repro config, port config, repro params, port params)."""
    jcfg, tcfg = _cfgs(request.param)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return (request.param, jcfg, tcfg, jparams,
            ttf.params_from_numpy(tcfg, tree, device="cpu"))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _prefix(cfg, B, seed=1):
    P = max(cfg.frontend_len, 2)
    return np.random.default_rng(seed).standard_normal(
        (B, P, cfg.d_model)).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _jforward(jcfg):
    """``repro``'s forward, jitted (one compile instead of an eager
    tail's many)."""
    return jax.jit(lambda p, b: jtf.forward(p, jcfg, b))


def _tailed(cfg):
    return bool(jtf.layer_plan(cfg)[2])


def test_layer_kinds_flatten_repro_plan():
    for case in CASES + ["internlm2_1p8b"]:
        jcfg, tcfg = _cfgs(case) if case != "internlm2_1p8b" else (
            jconfigs.get_arch(case).reduced(),
            tconfigs.get_arch(case).reduced())
        pat, ns, tail = jtf.layer_plan(jcfg)
        assert ttf.layer_kinds(tcfg) == tuple(pat) * ns + tuple(tail)
        assert len(ttf.layer_kinds(tcfg)) == tcfg.num_layers
    assert ttf.layer_kinds(_cfgs(TAILED)[1]) == ("rec", "rec", "attn",
                                                 "rec", "rec")
    assert ttf.layer_kinds(_cfgs("llama4_maverick_400b_a17b")[1]) == (
        "moe", "dense", "moe")


def test_forward_matches_repro(model):
    """Logits and the ``moe_balance`` aux over 40 positions (not a
    multiple of ssm_chunk = 16: the SSD pads and cuts), with the prefix
    for vlm and audio."""
    _case, jcfg, tcfg, jparams, tparams = model
    toks = _tokens(tcfg, 2, 40)
    batch = {"tokens": toks}
    if tcfg.frontend != "none":
        batch["prefix_emb"] = _prefix(tcfg, 2)
    want, jaux = _jforward(jcfg)(jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    got, taux = ttf.forward(tparams, tcfg,
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    assert got.shape == (2, 40, tcfg.vocab)
    _close(got, want)
    assert set(taux) == set(jaux) == {"moe_balance"}
    assert taux["moe_balance"].dtype == torch.float32
    _close(taux["moe_balance"], jaux["moe_balance"], 1e-5)
    if tcfg.family != "moe":
        assert float(taux["moe_balance"]) == 0.0


@pytest.mark.parametrize("with_prefix", [False, True])
def test_prefill_matches_repro(model, with_prefix):
    """Prefill logits (and K/V of the super-blocks' attention layers)
    against ``repro``'s prefill; on a tailed plan against ``repro``'s
    forward, which runs the tail that ``repro``'s prefill skips.  A
    prefix is ignored by configs without a frontend, in both."""
    _case, jcfg, tcfg, jparams, tparams = model
    toks = _tokens(tcfg, 2, 24, seed=1)
    batch = {"tokens": toks}
    if with_prefix:
        batch["prefix_emb"] = _prefix(tcfg, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jcache, jlen = jax.jit(jstep.make_prefill(jcfg))(jparams, jb)
    tl, tcache, tlen = tstep.make_prefill(tcfg)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.shape == (2, 1, tcfg.vocab)
    assert tlen.dtype == torch.int32 and tlen.tolist() == [24, 24]
    if _tailed(jcfg):
        full, _ = _jforward(jcfg)(jparams, jb)
        _close(tl[:, 0], np.asarray(full)[:, -1])
        assert np.abs(np.asarray(jl)[:, 0]
                      - np.asarray(full)[:, -1]).max() > 1e-2
    else:
        _close(tl, jl)
    kinds = ttf.layer_kinds(tcfg)
    attn_layers = [i for i, k in enumerate(kinds) if k in ttf.ATTN_KINDS]
    if not attn_layers:
        assert tcache == {}
        return
    assert tcache["k"].shape == (len(attn_layers), 2, 24, tcfg.kv_heads,
                                 tcfg.hd)
    pat, ns, _ = jtf.layer_plan(jcfg)
    for j, kind in enumerate(pat):
        if kind not in ttf.ATTN_KINDS:
            assert jcache[f"b{j}_{kind}"] is None
            continue
        jk, jv = jcache[f"b{j}_{kind}"]
        for si in range(ns):
            a = attn_layers.index(si * len(pat) + j)
            _close(tcache["k"][a], np.asarray(jk)[si])
            _close(tcache["v"][a], np.asarray(jv)[si])


@pytest.fixture(scope="module")
def chain(model):
    """20 decode steps of both packages from a zero cache, lengths
    starting at (0, 2) (past the reduced window of 16 for the hybrid):
    (tokens, repro's logits, cache; the port's logits, cache)."""
    return _decode_chain(model)


def _decode_chain(model, steps=20):
    _case, jcfg, tcfg, jparams, tparams = model
    B, max_len = 2, 24
    toks = _tokens(tcfg, B, steps, seed=3)
    jcache = jtf.init_cache(jcfg, B, max_len)
    tcache = ttf.init_cache(tcfg, B, max_len, device="cpu")
    step = jax.jit(lambda p, t, c, l: jtf.decode_step(p, jcfg, t, c, l))
    lens = np.array([0, 2], np.int32)
    jls, tls = [], []
    for i in range(steps):
        jl, jcache = step(jparams, jnp.asarray(toks[:, i]), jcache,
                          jnp.asarray(lens))
        tl, tcache = ttf.decode_step(tparams, tcfg,
                                     torch.from_numpy(toks[:, i]), tcache,
                                     torch.from_numpy(lens))
        jls.append(np.asarray(jl))
        tls.append(tl)
        lens = lens + 1
    return toks, jls, jcache, tls, tcache


def test_decode_chain_matches_repro(model, chain):
    """20 steps: every step's logits, then the whole cache (K/V ring
    buffers wrapped for the hybrid; conv windows and h of the recurrent
    layers), through ``cache_from_numpy`` of ``repro``'s."""
    _case, jcfg, tcfg, _, _ = model
    _toks, jls, jcache, tls, tcache = chain
    for jl, tl in zip(jls, tls):
        _close(tl, jl)
    want = ttf.cache_from_numpy(tcfg, jax.tree.map(np.asarray, jcache),
                                device="cpu")
    assert set(want) == set(tcache)
    for g, w in zip(ttf.cache_tensors(tcache), ttf.cache_tensors(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w.numpy())


def test_cache_round_trips_repro_layout(model):
    """``init_cache`` has ``repro``'s shapes and dtypes leaf for leaf,
    and ``cache_from_numpy`` of ``repro``'s zero cache equals it."""
    _case, jcfg, tcfg, _, _ = model
    jcache = jax.tree.map(np.asarray, jtf.init_cache(jcfg, 3, 20))
    got = ttf.init_cache(tcfg, 3, 20, device="cpu")
    want = ttf.cache_from_numpy(tcfg, jcache, device="cpu")
    assert list(got) == list(want)
    for g, w in zip(ttf.cache_tensors(got), ttf.cache_tensors(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert not g.any()


def test_decode_chain_matches_forward(model, chain):
    """The port's decode chain against its own forward over the same
    tokens (the recurrent forms against the chunked scans), for the row
    that starts at length 0.  The forward's MoE drops tokens past an
    expert's capacity and decode never does, so the forward runs here
    with a capacity factor of E, which drops none."""
    _case, _jcfg, tcfg, _, tparams = model
    toks, _jls, _jc, tls, _tc = chain
    if tcfg.attn_window:
        toks = toks[:, :tcfg.attn_window]
    if tcfg.num_experts:
        tcfg = dataclasses.replace(tcfg,
                                   capacity_factor=float(tcfg.num_experts))
    full, _ = ttf.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    for i in range(toks.shape[1]):
        _close(tls[i][0], full[0, i].numpy(), DECODE_ATOL)


def _serve(tcfg, tparams, slots, prompts=PROMPTS):
    eng = ServeEngine(tcfg, tparams, batch_slots=slots, max_len=32,
                      device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=np.asarray(p, np.int32),
                           max_tokens=SERVE_TOKENS))
    return eng.run(), eng.steps_run


def _serve_repro(jcfg, jparams, slots, prompts=PROMPTS):
    eng = JServeEngine(jcfg, jparams, batch_slots=slots, max_len=32)
    for uid, p in enumerate(prompts):
        eng.submit(JRequest(uid=uid, prompt=np.asarray(p, np.int32),
                            max_tokens=SERVE_TOKENS))
    return eng.run(), eng.steps_run


@pytest.mark.parametrize("slots", [2, 4])
def test_serve_engine_matches_repro(model, slots):
    """Greedy outputs and engine steps equal ``repro``'s token for token,
    prompts replayed through decode steps with re-fill at 2 slots."""
    _case, jcfg, tcfg, jparams, tparams = model
    got = _serve(tcfg, tparams, slots)
    want = _serve_repro(jcfg, jparams, slots)
    assert got == want
    assert all(len(v) == SERVE_TOKENS for v in got[0].values())


def test_tailed_hybrid_three_slots_equals_solo_runs():
    """At 3 slots (= conv_width - 1) on the tailed hybrid the port serves
    each request as it serves it alone; ``repro``'s engine takes the
    tail's conv windows along the wrong axis there and differs."""
    jcfg, tcfg = _cfgs(TAILED)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = ttf.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = PROMPTS[:3]
    got, _ = _serve(tcfg, tparams, 3, prompts)
    for uid, p in enumerate(prompts):
        alone, _ = _serve(tcfg, tparams, 1, [p])
        assert got[uid] == alone[0]
    want, _ = _serve_repro(jcfg, jparams, 3, prompts)
    assert want[0] != got[0]


def test_replay_leaves_other_slots_state_bit_identical(model):
    """A replay step of one slot leaves every other slot's recurrent
    state (conv window and h) bit for bit as it was and its K/V below its
    length, and advances its own state; a reset zeroes only its slot."""
    _case, _jcfg, tcfg, _, tparams = model
    eng = ServeEngine(tcfg, tparams, batch_slots=3, max_len=32,
                      device="cpu")
    for slot, tok in ((0, 5), (1, 9), (2, 13), (1, 4)):
        eng._step_single_slot(slot, tok)

    def states():
        return [x for kind in ("rec", "ssm") if kind in eng.cache
                for x in eng.cache[kind]]

    before = [x.clone() for x in states()]
    kv = {k: eng.cache[k].clone() for k in ("k", "v") if k in eng.cache}
    lens = eng.lens.tolist()
    assert lens == [1, 2, 1]
    eng._step_single_slot(1, 21)
    assert len(before) == (2 if tcfg.family in ("ssm", "hybrid") else 0)
    for x, y in zip(states(), before):
        assert torch.equal(x[:, 0], y[:, 0])
        assert torch.equal(x[:, 2], y[:, 2])
        assert not torch.equal(x[:, 1], y[:, 1])
    for k, y in kv.items():
        for j in (0, 2):
            assert torch.equal(eng.cache[k][:, j, :lens[j]],
                               y[:, j, :lens[j]])
    everything = [x.clone() for x in ttf.cache_tensors(eng.cache)]
    eng._reset_slot(1)
    for x, y in zip(ttf.cache_tensors(eng.cache), everything):
        assert not x[:, 1].any()
        assert torch.equal(x[:, 0], y[:, 0])
        assert torch.equal(x[:, 2], y[:, 2])
    assert eng.lens.tolist() == [1, 0, 1]


def test_params_keep_float32_leaves(model):
    """``init_params`` in bfloat16 keeps the same leaves float32 as
    ``repro``'s (router, ``A_log``, ``D``, ``dt_bias``, ``lam``), and has
    the tree of ``params_from_numpy`` leaf for leaf."""
    _case, jcfg, tcfg, _, tparams = model
    j16 = jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    p16 = ttf.init_params(tcfg, 3, device="cpu", dtype=torch.bfloat16)

    def f32_names(tree, f32):
        return {path[-1].key for path, x in
                jax.tree_util.tree_leaves_with_path(tree) if x.dtype == f32}

    assert f32_names(p16, torch.float32) == f32_names(j16, jnp.float32)
    assert f32_names(p16, torch.float32) <= set(ttf.FLOAT32_LEAVES)
    flat16 = jax.tree_util.tree_leaves_with_path(p16)
    flat32 = dict(jax.tree_util.tree_leaves_with_path(tparams))
    assert len(flat16) == len(flat32)
    for path, x in flat16:
        assert x.shape == flat32[path].shape, path
        assert x.dtype in (torch.float32, torch.bfloat16)
    assert sum(x.numel() for x in jax.tree.leaves(p16)) == sum(
        x.size for x in jax.tree.leaves(j16))


# ---------------------------------------------------------------------------
# the modules one by one
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_causal_conv1d_and_step_match_repro():
    """The depthwise conv over a sequence, and its step chain from a zero
    window, against ``repro``'s and against each other."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    full = tlayers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    _close(full, jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w)))
    jstate = jnp.zeros((2, 3, 6), jnp.float32)
    tstate = torch.zeros((2, 3, 6))
    for t in range(x.shape[1]):
        jy, jstate = jlayers.causal_conv1d_step(jnp.asarray(x[:, t]), jstate,
                                                jnp.asarray(w))
        ty, tstate = tlayers.causal_conv1d_step(torch.from_numpy(x[:, t]),
                                                tstate, torch.from_numpy(w))
        _close(ty, jy)
        _close(tstate, jstate)
        _close(ty, full[:, t].numpy())


@pytest.fixture(scope="module")
def moe_params():
    """qwen3-moe's reduced MoE (E = 4, K = 2): the configs and both
    parameter sets."""
    jcfg, tcfg = _cfgs("qwen3_moe_30b_a3b")
    jp = jmoe.init_moe(jax.random.PRNGKey(2), jcfg)
    return jcfg, tcfg, jp, _np_tree(jp)


def _moe_input(tcfg, tp, seed, B, L):
    """An input drawn from ``seed`` and the expert loads of its top-k
    routing."""
    x = np.random.default_rng(seed).standard_normal(
        (B, L, tcfg.d_model)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, tcfg.d_model)
                          @ tp["router"], dim=-1)
    ids = torch.topk(probs, tcfg.top_k, dim=-1).indices
    return x, torch.bincount(ids.reshape(-1), minlength=tcfg.num_experts)


@pytest.mark.parametrize("B,L,cap", [
    (1, 4, 2),      # 4·2/4·1.25 = 2.5: half to even, 2 (floor(x + .5): 3)
    (2, 6, 8),      # 7.5 -> 8
    (3, 5, 9),      # 9.375 -> 9
])
def test_moe_ffn_matches_repro(moe_params, B, L, cap):
    """``moe_ffn`` forward (capacity-bounded, with overflow) and decode
    (exact per-token gather), outputs and the balance aux.  The seed is
    the first whose routing overflows an expert; at the half-even
    capacity, one that loads an expert with exactly 3 pairs, where a
    capacity of 3 would keep a pair that 2 drops.  The outputs here are
    of order 100 (``init_dense`` scales the stacked experts by the fan-in
    of their first axis, E), so they are held to 1e-5 of their largest
    magnitude, the 1e-4 on order-1 values of the rest of the file."""
    jcfg, tcfg, jp, tp = moe_params
    for seed in range(64):
        x, loads = _moe_input(tcfg, tp, seed, B, L)
        over = int(loads.max()) > cap
        if over and (cap != 2 or 3 in loads.tolist()):
            break
    assert over, "no seed overflowed an expert"
    assert int(max(1, round(B * L * tcfg.top_k / tcfg.num_experts
                            * tcfg.capacity_factor))) == cap
    jmoe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=(2, 3))
    for decode in (False, True):
        jo, jaux = jmoe_ffn(jp, jnp.asarray(x), jcfg, decode)
        to, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, decode=decode)
        assert to.shape == x.shape and to.dtype == torch.float32
        _close(to, jo, 1e-5 * float(np.abs(np.asarray(jo)).max()))
        _close(taux["moe_balance"], jaux["moe_balance"], 1e-5)
    full, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    exact, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, decode=True)
    assert (full - exact).abs().max() > 1e-3        # a pair was dropped


def test_ssd_forward_and_decode_chain_match_repro():
    """``ssd_forward`` at L = 37 (padded to 48 over chunks of 16, and cut
    back), then 37 decode steps from a zero state: each step's output and
    the final (conv window, h) against ``repro``'s, and the outputs
    against the forward's."""
    jcfg, tcfg = _cfgs("mamba2_780m")
    jp = jssm.init_ssm(jax.random.PRNGKey(3), jcfg)
    tp = _np_tree(jp)
    x = np.random.default_rng(5).standard_normal(
        (2, 37, tcfg.d_model)).astype(np.float32)
    full = tssm.ssd_forward(tp, torch.from_numpy(x), tcfg)
    assert full.shape == x.shape
    _close(full, jax.jit(lambda p, x: jssm.ssd_forward(p, x, jcfg))(
        jp, jnp.asarray(x)))
    jstate = jssm.init_ssm_state(jcfg, 2)
    tstate = tssm.init_ssm_state(tcfg, 2, device="cpu")
    step = jax.jit(lambda p, x_t, s: jssm.ssd_decode_step(p, x_t, s, jcfg))
    for t in range(x.shape[1]):
        jy, jstate = step(jp, jnp.asarray(x[:, t]), jstate)
        ty, tstate = tssm.ssd_decode_step(tp, torch.from_numpy(x[:, t]),
                                          tstate, tcfg)
        _close(ty, jy)
        _close(ty, full[:, t].numpy(), DECODE_ATOL)
    assert tstate[1].dtype == torch.float32
    for g, w in zip(tstate, jstate):
        _close(g, w)


def test_rglru_forward_and_decode_chain_match_repro():
    """``rglru_forward`` (the Hillis-Steele scan over L = 37) and 37
    decode steps from a zero state, against ``repro``'s and against each
    other."""
    jcfg, tcfg = _cfgs("recurrentgemma_9b")
    jp = jrglru.init_rglru(jax.random.PRNGKey(4), jcfg)
    tp = _np_tree(jp)
    x = np.random.default_rng(6).standard_normal(
        (2, 37, tcfg.d_model)).astype(np.float32)
    full = trglru.rglru_forward(tp, torch.from_numpy(x), tcfg)
    _close(full, jax.jit(lambda p, x: jrglru.rglru_forward(p, x, jcfg))(
        jp, jnp.asarray(x)))
    jstate = jrglru.init_rglru_state(jcfg, 2)
    tstate = trglru.init_rglru_state(tcfg, 2, device="cpu")
    step = jax.jit(lambda p, x_t, s: jrglru.rglru_decode_step(p, x_t, s,
                                                              jcfg))
    for t in range(x.shape[1]):
        jy, jstate = step(jp, jnp.asarray(x[:, t]), jstate)
        ty, tstate = trglru.rglru_decode_step(tp, torch.from_numpy(x[:, t]),
                                              tstate, tcfg)
        _close(ty, jy)
        _close(ty, full[:, t].numpy(), DECODE_ATOL)
    for g, w in zip(tstate, jstate):
        _close(g, w)


@pytest.mark.parametrize("L", [1, 2, 5, 16, 37])
def test_linear_scan_equals_a_loop(L):
    """The Hillis-Steele scan against h_t = a_t·h_{t-1} + v_t in a loop."""
    gen = torch.Generator().manual_seed(L)
    a = torch.rand((2, L, 3), generator=gen)
    v = torch.randn((2, L, 3), generator=gen)
    h, want = torch.zeros(2, 3), []
    for t in range(L):
        h = a[:, t] * h + v[:, t]
        want.append(h)
    _close(trglru.linear_scan(a, v), torch.stack(want, 1).numpy(), 1e-6)
