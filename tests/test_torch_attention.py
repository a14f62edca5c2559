"""The port's attention kernels (plain versions, on the CPU) against
``repro``'s: K6 ``flash_attention`` and K7 ``decode_attention``.

The same numpy inputs, drawn from a seed, go through ``repro``'s Pallas
kernels (interpret mode, through ``ops``), ``repro``'s references
(``ref.mha_ref``, ``ref.decode_attention_ref``) and the port's wrappers,
which on CPU tensors run their plain versions and count no launch.  The
CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances are ``repro``'s own (tests/test_kernels.py): 2e-5 in float32,
because the online softmax sums in another order than one softmax over
the row; 2e-2 in bfloat16, because the two frameworks round the bfloat16
products and P at different places.  Inputs are O(1) normals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import attention as jattn
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import flash_attention as kf
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normals(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    """The arrays as jax and torch tensors of ``dtype`` (bf16 rounding is
    round-to-nearest-even in both, so the two sides get equal inputs)."""
    j = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return j, t


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), atol=tol,
                               rtol=0)


def _flash_inputs(seed, B, Lq, Lk, H, Hkv, D, dtype):
    arrays = _normals(seed, (B, Lq, H, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D))
    return _both(arrays, dtype)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,H,Hkv,D", [
    (128, 4, 4, 16),     # group 1
    (256, 8, 4, 32),     # group 2
    (128, 8, 2, 64),     # group 4
    (128, 8, 1, 128),    # group 8
    (128, 4, 2, 96),     # phi3-vision's head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_ref(L, H, Hkv, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(L + D, 2, L, L, H, Hkv, D,
                                               dtype)
    got = kf.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    if dtype == "float32":     # one interpret-mode compile per shape
        _close(got, ops.flash_attention(jq, jk, jv, causal=True), TOL[dtype])
    _close(got, ref.mha_ref(jq, jk, jv, causal=True), TOL[dtype])


@pytest.mark.parametrize("window", [32, 200])
def test_flash_plain_window(window):
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(3, 1, 256, 256, 4, 2, 32,
                                               "float32")
    got = kf.flash_attention(tq, tk, tv, causal=True, window=window)
    _close(got, ops.flash_attention(jq, jk, jv, causal=True, window=window),
           TOL["float32"])
    _close(got, ref.mha_ref(jq, jk, jv, causal=True, window=window),
           TOL["float32"])


@pytest.mark.parametrize("Lq,Lk,window", [
    (100, 100, None),    # ragged, Lq == Lk: repro pads
    (128, 256, None),    # Lq < Lk, tile-aligned: repro's kernel offsets rows
    (37, 100, None),     # Lq < Lk, ragged: repro falls back to mha_ref
    (64, 192, 48),       # Lq < Lk with a window
])
def test_flash_plain_ragged_and_offset(Lq, Lk, window):
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(Lq + Lk, 2, Lq, Lk, 4, 2, 32,
                                               "float32")
    got = kf.flash_attention(tq, tk, tv, causal=True, window=window)
    _close(got, ops.flash_attention(jq, jk, jv, causal=True, window=window),
           TOL["float32"])
    _close(got, ref.mha_ref(jq, jk, jv, causal=True, window=window),
           TOL["float32"])


def test_flash_plain_not_causal_and_scale():
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(4, 1, 64, 96, 4, 1, 16,
                                               "float32")
    got = kf.flash_attention(tq, tk, tv, causal=False, scale=0.3)
    _close(got, ref.mha_ref(jq, jk, jv, causal=False, scale=0.3),
           TOL["float32"])


# ---------------------------------------------------------------------------
# K6 in float32 on the tensor cores: the error budget of the TF32 split
# ---------------------------------------------------------------------------

def _tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to the
    nearest, ties away from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(x):
    """A float32 as the tensor cores read a TF32 operand: the low 13 bits
    ignored."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b):
    """a @ b as the kernel takes it on the tensor cores: each operand split
    into hi = tf32(x) and lo = x - hi (read with its low bits cut), the
    product hi·hi + hi·lo + lo·hi with float32 sums (hi·hi apart from the
    two cross products)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def _split_attention(q, k, v, *, causal=True, window=None, split=True):
    """Attention in the kernel's arithmetic, in its order: Q scaled by
    scale·log2(e), S = Q K^T as split products, masked with -1e30,
    P = exp2(S - max), then P V as split products over max(l, 1e-30).
    ``split=False`` takes plain TF32 products (hi·hi alone)."""
    B, Lq, H, D = q.shape
    Lk, group = k.shape[1], H // k.shape[2]
    mm = _split_mm if split else (lambda a, b: _tf32(a) @ _tf32(b))
    qh = q.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(group, 2).permute(0, 2, 3, 1)
    vh = v.repeat_interleave(group, 2).permute(0, 2, 1, 3)
    s = mm(qh * np.float32(1.0 / np.sqrt(D) * np.log2(np.e)), kh)
    if causal:
        rows = torch.arange(Lq)[:, None] + (Lk - Lq)
        cols = torch.arange(Lk)[None, :]
        mask = rows >= cols
        if window is not None:
            mask &= rows - cols < window
        s = s.masked_fill(~mask, -1e30)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    out = mm(p, vh) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.permute(0, 2, 1, 3)


# the kernel's tile edges (128 query rows, 32 keys; 64 and 16 at D = 256)
SPLIT_SHAPES = [
    (63, 63, 4, 2, 16, None),
    (65, 129, 4, 1, 32, None),       # Lq < Lk
    (127, 127, 8, 2, 64, 40),        # window across a KV tile
    (129, 255, 4, 4, 128, None),     # Lq < Lk, ragged both
    (129, 129, 4, 2, 256, 20),       # D = 256 with a window
]


@pytest.mark.parametrize("Lq,Lk,H,Hkv,D,window", SPLIT_SHAPES)
def test_flash_split_tf32_within_float32_contract(Lq, Lk, H, Hkv, D, window):
    """Three split TF32 products hold 2e-5 against the plain version and
    ``repro``'s ``ref.mha_ref`` on O(1) inputs."""
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(Lq * D + Lk, 1, Lq, Lk, H,
                                               Hkv, D, "float32")
    got = _split_attention(tq, tk, tv, window=window)
    want = kf.flash_attention_plain(tq, tk, tv, window=window)
    assert (got - want).abs().max().item() <= TOL["float32"]
    _close(got, ref.mha_ref(jq, jk, jv, causal=True, window=window),
           TOL["float32"])


# q and k ×8 put the logits 64× past O(1): the plain float32 version itself
# is then about 1e-4 from the float64 answer, so neither it nor the split
# can hold 2e-5 against the other.  Both are held to the float64 answer:
# the split's error at most this many times the plain version's.  The two
# round at different places, so their largest errors trade places (the
# split's is 0.85-1.83 times the plain version's at these shapes); plain
# TF32, or a split that drops a cross product, lands hundreds of times
# over.
SPLIT_LARGE_RATIO = 4.0


@pytest.mark.parametrize("D", kf.HEAD_DIMS)
def test_flash_split_tf32_large_logits(D):
    q, k, v = _normals(D, (1, 129, 4, D), (1, 255, 2, D), (1, 255, 2, D))
    tq, tk, tv = (torch.from_numpy(x) for x in (q * 8, k * 8, v))
    exact = kf.flash_attention_plain(tq.double(), tk.double(), tv.double())
    plain_err = (kf.flash_attention_plain(tq, tk, tv) - exact).abs().max()
    split_err = (_split_attention(tq, tk, tv) - exact).abs().max()
    tf32_err = (_split_attention(tq, tk, tv, split=False)
                - exact).abs().max()
    assert split_err <= SPLIT_LARGE_RATIO * plain_err, (split_err, plain_err)
    assert tf32_err > 20 * SPLIT_LARGE_RATIO * plain_err, (tf32_err,
                                                            plain_err)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,Hkv,D", [(8, 8, 16), (8, 2, 32), (8, 1, 64),
                                     (16, 8, 128), (8, 4, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_ref(H, Hkv, D, dtype):
    B, S = 3, 777
    arrays = _normals(H + D, (B, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    lens = np.array([3, 500, 777], np.int32)
    got = kd.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    jl = jnp.asarray(lens)
    if dtype == "float32" and Hkv < H:     # one interpret compile per shape
        _close(got, ops.decode_attention(jq, jk, jv, jl), TOL[dtype])
    _close(got, ref.decode_attention_ref(jq, jk, jv, jl), TOL[dtype])


# ---------------------------------------------------------------------------
# the attention module's two paths
# ---------------------------------------------------------------------------

def test_xla_attention_matches_repro():
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(9, 2, 128, 128, 8, 2, 32,
                                               "float32")
    for window in (None, 16):
        got = tattn._xla_attention(tq, tk, tv, causal=True, window=window,
                                   q_chunk=32)
        want = jattn._xla_attention(jq, jk, jv, causal=True, window=window,
                                    q_chunk=32)
        _close(got, want, TOL["float32"])
        _close(got, ref.mha_ref(jq, jk, jv, causal=True, window=window),
               TOL["float32"])


def test_impl_default_and_values():
    x = torch.zeros(1, 2, 4)
    assert tattn.resolve_impl(None, x) == "xla"
    assert tattn.resolve_impl("flash", x) == "flash"
    with pytest.raises(ValueError):
        tattn.resolve_impl("pallas", x)


# ---------------------------------------------------------------------------
# the wrappers: CPU tensors count no launch, bad inputs raise
# ---------------------------------------------------------------------------

def test_cpu_calls_count_no_launch_and_build_nothing():
    kernels.reset_launch_counts()
    loaded = dict(_build._loaded)
    _, (tq, tk, tv) = _flash_inputs(5, 1, 16, 16, 2, 1, 16, "float32")
    kf.flash_attention(tq, tk, tv)
    kd.decode_attention(tq[:, 0].contiguous(), tk, tv,
                        torch.tensor([7], dtype=torch.int32))
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 0 and counts["decode_attention"] == 0
    assert _build._loaded == loaded


def test_wrappers_reject_bad_inputs():
    _, (tq, tk, tv) = _flash_inputs(6, 1, 16, 16, 2, 1, 48, "float32")
    with pytest.raises(ValueError, match="head dim"):
        kf.flash_attention(tq, tk, tv)
    _, (tq, tk, tv) = _flash_inputs(6, 1, 16, 16, 2, 1, 32, "float32")
    with pytest.raises(TypeError):
        kf.flash_attention(tq, tk.to(torch.bfloat16), tv)
    with pytest.raises(TypeError):
        kf.flash_attention(tq.half(), tk.half(), tv.half())
    with pytest.raises(ValueError, match="contiguous"):
        kf.flash_attention(tq.transpose(1, 2).contiguous().transpose(1, 2),
                           tk, tv)
    with pytest.raises(ValueError):
        kf.flash_attention(tq, tk[:, :, :1].expand(1, 16, 3, 32).contiguous(),
                           tv[:, :, :1].expand(1, 16, 3, 32).contiguous())
    q1 = tq[:, 0].contiguous()
    with pytest.raises(ValueError, match="lengths"):
        kd.decode_attention(q1, tk, tv, torch.tensor([1.0]))
    with pytest.raises(ValueError, match="head dim"):
        kd.decode_attention(torch.zeros(1, 2, 8), torch.zeros(1, 4, 1, 8),
                            torch.zeros(1, 4, 1, 8),
                            torch.tensor([2], dtype=torch.int32))
    with pytest.raises(TypeError):
        kd.decode_attention(q1.to(torch.bfloat16), tk, tv,
                            torch.tensor([2], dtype=torch.int32))


# ---------------------------------------------------------------------------
# K7's split across the cache: the plain split-and-combine, the host's
# choice of splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 100, 150, 300, 512])
def test_decode_split_plain_matches_plain_and_ref(chunk):
    """Chunks of 64 end exactly at length 64 and leave S = 300 ragged;
    the row of length 1 leaves every chunk but the first empty; the row
    of length 0 gives zeros (the one-softmax versions give NaN there)."""
    B, S, H, Hkv, D = 4, 300, 8, 2, 16
    arrays = _normals(17, (B, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    lens = np.array([0, 1, 64, 299], np.int32)
    got = kd.decode_attention_split_plain(tq, tk, tv, torch.from_numpy(lens),
                                          chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    plain = kd.decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    np.testing.assert_allclose(got[1:].numpy(), plain[1:].numpy(), atol=1e-6,
                               rtol=0)
    want = np.asarray(ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)))
    np.testing.assert_allclose(got[1:].numpy(), want[1:], atol=1e-6, rtol=0)


def test_decode_split_plain_bfloat16_and_clamped_lengths():
    B, S, H, Hkv, D = 2, 130, 4, 1, 32
    arrays = _normals(18, (B, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    _, (tq, tk, tv) = _both(arrays, "bfloat16")
    lens = torch.tensor([500, 65], dtype=torch.int32)   # 500 clamps to S
    got = kd.decode_attention_split_plain(tq, tk, tv, lens, chunk=64)
    assert got.dtype == torch.bfloat16
    want = kd.decode_attention_plain(tq, tk, tv, lens.clamp(0, S))
    assert (got.float() - want.float()).abs().max().item() <= TOL["bfloat16"]


def test_decode_splits_choice():
    """Never reads the lengths (it is not given them), always at least one
    split, chunks cover S with no chunk wholly past it, none shorter than
    ``MIN_CHUNK`` once split, and enough blocks to fill the SMs."""
    import inspect
    assert list(inspect.signature(kd.decode_splits).parameters) == [
        "batch", "kv_heads", "seq_len", "num_sms"]
    assert kd.decode_splits(8, 8, 1024, 132) == (1, 1024)  # the engine's
    rng = np.random.default_rng(19)
    shapes = [(16, 8, 32768, 132), (1, 1, 0, 132), (1, 1, 1, 132),
              (4, 2, 5000, 132), (64, 8, 4096, 132), (512, 8, 65536, 132)]
    shapes += [tuple(int(x) for x in (rng.integers(1, 65),
                                      rng.choice([1, 2, 4, 8, 32]),
                                      rng.integers(0, 200_000),
                                      rng.choice([1, 8, 114, 132])))
               for _ in range(200)]
    for B, Hkv, S, sms in shapes:
        splits, chunk = kd.decode_splits(B, Hkv, S, sms)
        assert splits >= 1 and chunk >= 1 and splits * chunk >= S
        assert S == 0 or (splits - 1) * chunk < S
        if splits > 1:
            assert chunk >= kd.MIN_CHUNK
            assert B * Hkv * (splits - 1) < kd.BLOCKS_PER_SM * sms
    splits, _ = kd.decode_splits(16, 8, 32768, 132)
    assert 16 * 8 * splits >= 132 * 2
