"""The port's LM stack (``repro_torch.models``, ``configs``,
``training.step``) against ``repro``'s, on the CPU.

``repro``'s parameters (``init_params`` from a JAX key) go to the port
through ``params_from_numpy``, so both packages run the same weights on
the same numpy tokens.  The port runs both attention paths: ``impl="xla"``
(the chunked plain path) and ``impl="flash"`` (the kernel path, which on
CPU tensors runs K6's and K7's plain versions).  ``repro``'s transformer
always takes its chunked XLA path.

Tolerances: 1e-4 on logits (order 1) and K/V (order 1) between the
packages, because XLA:CPU and torch's CPU matmuls sum in different
orders in float32 through a few layers of width 128; 2e-3 for decode
against the whole-sequence forward, ``repro``'s own bound
(tests/test_models.py), because the per-token path multiplies (1, d)
rows where the forward multiplies (S, d) blocks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.training import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.training import step as tstep

ATOL = 1e-4
DECODE_ATOL = 2e-3
ARCHS = ["internlm2_1p8b", "llama3p2_1b"]
IMPLS = ["xla", "flash"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(cfg, repro params, port params) for a reduced dense arch."""
    cfg = jconfigs.get_arch(request.param).reduced()
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jparams, ttf.params_from_numpy(cfg, tree, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_configs_equal_repro():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for name in jconfigs.ARCH_IDS:
        t, j = tconfigs.get_arch(name), jconfigs.get_arch(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert dataclasses.asdict(t.reduced()) == \
            dataclasses.asdict(j.reduced()), name
        assert t.param_count() == j.param_count()
        assert ttf.layer_plan(t) == jtf.layer_plan(j)
    assert tconfigs.get_arch("internlm2-1.8b").name == "internlm2_1p8b"


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_repro(model, impl):
    cfg, jparams, tparams = model
    toks = _tokens(cfg, 2, 64)          # two q-chunks of attn_chunk = 32
    want, _ = jtf.forward(jparams, cfg, {"tokens": jnp.asarray(toks)})
    got, _ = ttf.forward(tparams, cfg, {"tokens": torch.from_numpy(toks)},
                         impl=impl)
    assert got.shape == (2, 64, cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_repro(model, impl):
    cfg, jparams, tparams = model
    toks = _tokens(cfg, 2, 40, seed=1)
    jl, jcache, jlen = jstep.make_prefill(cfg)(jparams,
                                               {"tokens": jnp.asarray(toks)})
    tl, tcache, tlen = tstep.make_prefill(cfg, impl=impl)(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 1, cfg.vocab)
    _close(tl, jl)
    jk, jv = jcache["b0_attn"]
    _close(tcache["k"], jk)
    _close(tcache["v"], jv)
    assert tlen.dtype == torch.int32 and tlen.tolist() == np.asarray(
        jlen).tolist()


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_matches_repro(model, impl):
    """Three steps from a random cache with unequal lengths: logits and
    the cache below each row's new length."""
    cfg, jparams, tparams = model
    B, S = 2, 24
    rng = np.random.default_rng(2)
    shape = (cfg.num_layers, B, S, cfg.kv_heads, cfg.hd)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    jcache = {"supers": {"b0_attn": (jnp.asarray(k0), jnp.asarray(v0))}}
    tcache = ttf.cache_from_numpy(cfg, {"supers": {"b0_attn": (k0, v0)}},
                                  device="cpu")
    lens = np.array([5, 9], np.int32)
    step = jax.jit(lambda p, t, c, l: jtf.decode_step(p, cfg, t, c, l))
    toks = _tokens(cfg, B, 3, seed=3)
    for i in range(3):
        jl, jcache = step(jparams, jnp.asarray(toks[:, i]), jcache,
                          jnp.asarray(lens))
        tl, tcache = ttf.decode_step(tparams, cfg,
                                     torch.from_numpy(toks[:, i]), tcache,
                                     torch.from_numpy(lens), impl=impl)
        _close(tl, jl)
        lens = lens + 1
    jk, jv = jcache["supers"]["b0_attn"]
    for b in range(B):
        _close(tcache["k"][:, b, :lens[b]], np.asarray(jk)[:, b, :lens[b]])
        _close(tcache["v"][:, b, :lens[b]], np.asarray(jv)[:, b, :lens[b]])


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_then_decode_matches_forward(model, impl):
    """Prefill P tokens, copy the cache into a longer one, decode the rest
    token by token: every logit equals the whole-sequence forward's."""
    cfg, _, tparams = model
    B, P, S = 2, 12, 20
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=4))
    full, _ = ttf.forward(tparams, cfg, {"tokens": toks}, impl="xla")
    logits, pcache, lens = ttf.prefill(tparams, cfg, {"tokens": toks[:, :P]},
                                       impl=impl)
    _close(logits[:, 0], full[:, P - 1], DECODE_ATOL)
    cache = ttf.init_cache(cfg, B, S, device="cpu")
    cache["k"][:, :, :P] = pcache["k"]
    cache["v"][:, :, :P] = pcache["v"]
    serve = tstep.make_serve_step(cfg, impl=impl)
    for i in range(P, S):
        nxt, cache, lg = serve(tparams, toks[:, i], cache, lens)
        _close(lg, full[:, i], DECODE_ATOL)
        assert torch.equal(nxt, lg.argmax(-1).to(torch.int32))
        lens = lens + 1


def test_attention_module_matches_repro_both_impls():
    """``attention`` itself against ``repro``'s with the same impl, for
    prefill (flash: repro's Pallas kernel in interpret mode) and decode."""
    cfg = dataclasses.replace(jconfigs.get_arch("internlm2_1p8b").reduced(),
                              attn_chunk=16)
    rng = np.random.default_rng(5)
    jp = jattn.init_attention(jax.random.PRNGKey(1), cfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    shape = (2, 40, cfg.kv_heads, cfg.hd)
    ck, cv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    clen = np.array([7, 39], np.int32)
    for impl in IMPLS:
        jo, (jk, jv) = jattn.attention(jp, jnp.asarray(x), cfg,
                                       jnp.asarray(pos), impl=impl)
        to, (tk, tv) = tattn.attention(tp, torch.from_numpy(x), cfg,
                                       torch.from_numpy(pos.copy()),
                                       impl=impl)
        _close(to, jo)
        _close(tk, jk)
        _close(tv, jv)
        x1 = x[:, :1]
        jo, (jck, _) = jattn.attention(
            jp, jnp.asarray(x1), cfg, jnp.asarray(clen[:, None]), impl=impl,
            kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
            cache_len=jnp.asarray(clen))
        tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        to, (tck2, _) = tattn.attention(
            tp, torch.from_numpy(x1), cfg, torch.from_numpy(clen[:, None]),
            impl=impl, kv_cache=(tck, tcv), cache_len=torch.from_numpy(clen))
        assert tck2 is tck                  # written in place
        _close(to, jo)
        _close(tck, jck)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mamba2_780m",
                                  "recurrentgemma_9b", "phi3_vision_4p2b",
                                  "musicgen_large"])
def test_other_families_raise(arch):
    """The families past dense raise no NotImplementedError any more
    (tests/test_torch_families.py holds them against ``repro``): every
    entry point runs on the CPU, and what raises now is a parameter list
    that does not fit the config's layer plan."""
    cfg = tconfigs.get_arch(arch).reduced()
    params = ttf.init_params(cfg, 0, device="cpu")
    assert len(params["layers"]) == cfg.num_layers
    toks = torch.zeros(1, 4, dtype=torch.long)
    logits, aux = ttf.forward(params, cfg, {"tokens": toks})
    assert logits.shape == (1, 4, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert set(aux) == {"moe_balance"}
    cache = ttf.init_cache(cfg, 1, 8, device="cpu")
    lg, cache = ttf.decode_step(params, cfg, toks[:, 0], cache,
                                torch.zeros(1, dtype=torch.int32))
    assert torch.allclose(lg, logits[:, 0], atol=DECODE_ATOL)
    short = {**params, "layers": params["layers"][:-1]}
    with pytest.raises(ValueError, match="layers for a plan of"):
        ttf.forward(short, cfg, {"tokens": toks})


def test_forward_aux_matches_repro(model):
    """``forward``'s aux is ``repro``'s: ``{"moe_balance"}``, a float32
    0 for the dense family."""
    cfg, jparams, tparams = model
    toks = _tokens(cfg, 1, 8)
    _, jaux = jtf.forward(jparams, cfg, {"tokens": jnp.asarray(toks)})
    _, taux = ttf.forward(tparams, cfg, {"tokens": torch.from_numpy(toks)})
    assert set(taux) == set(jaux) == {"moe_balance"}
    assert taux["moe_balance"].dtype == torch.float32
    assert float(taux["moe_balance"]) == float(jaux["moe_balance"]) == 0.0


def test_init_params_shapes_and_seed():
    cfg = tconfigs.get_arch("internlm2_1p8b").reduced()
    a = ttf.init_params(cfg, 7, device="cpu")
    b = ttf.init_params(cfg, 7, device="cpu")
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(cfg, jax.random.PRNGKey(0)))
    ref = ttf.params_from_numpy(cfg, tree, device="cpu")
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_a) == len(flat_ref)
    for path, x in flat_a:
        assert x.shape == flat_ref[path].shape and x.dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a),
                                                  jax.tree.leaves(b)))
    n = sum(x.numel() for x in jax.tree.leaves(a))
    assert n == cfg.param_count() + cfg.d_model     # + the final norm
    std = float(a["layers"][0]["attn"]["wq"].std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
