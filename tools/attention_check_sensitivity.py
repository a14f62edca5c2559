"""What the bfloat16 attention checks of ``chip_smoke.py`` can see.

On the inputs of the smoke's fixed K6 and K7 lines (the same seed), this
holds against each plain version (a) the kernel's output and (b) plain
outputs with one part of the work left out: one KV tile of 64 positions
for K6 (at the start, the middle and the end of the causal range, and
inside the 2048 window), one of K7's splits, or 1024 of its positions.
It prints one JSON line per case with the absolute error and
``scaled_err``, and whether each passes the smoke's limits: a check that
lets a left-out case through cannot see that fault.  Needs a CUDA card:

    python3 tools/attention_check_sensitivity.py [--seed 0]
"""
import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import decode_attention as kd  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402


def flash_without(q, k, v, lo, hi, window=None):
    """The plain K6 with keys [lo, hi) left out of every row past hi."""
    D = q.shape[-1]
    Lq, Lk, group = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    kq, vq = (x.repeat_interleave(group, 2) for x in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kq).float() / math.sqrt(D)
    qi = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    ki = torch.arange(Lk, device=q.device)[None, :]
    keep = (qi >= ki) & ~((ki >= lo) & (ki < hi) & (qi >= hi))
    if window:
        keep &= (qi - ki) < window
    p = torch.softmax(logits.masked_fill(~keep, float("-inf")), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), vq).to(q.dtype)


def decode_without(q, kc, vc, lengths, lo, hi):
    """The plain K7 with cache positions [lo, hi) left out."""
    D, S, group = q.shape[-1], kc.shape[1], q.shape[1] // kc.shape[2]
    kq, vq = (x.repeat_interleave(group, 2) for x in (kc, vc))
    logits = torch.einsum("bhd,bshd->bhs", q, kq).float() / math.sqrt(D)
    pos = torch.arange(S, device=q.device)[None, None, :]
    keep = (pos < lengths[:, None, None]) & ~((pos >= lo) & (pos < hi))
    p = torch.softmax(logits.masked_fill(~keep, float("-inf")), -1)
    return torch.einsum("bhs,bshd->bhd", p.to(vc.dtype), vq).to(q.dtype)


def report(case, got, want):
    err = cs.max_abs_err(torch, [got], [want])
    scaled = cs.scaled_err(torch, got, want)
    rel_tol = cs.ATTN_REL_TOL["torch.bfloat16"]
    print(json.dumps({"case": case, "max_abs_err": err, "scaled_err": scaled,
                      "passes_abs": err <= cs.ATTN_TOL["torch.bfloat16"],
                      "passes_scaled": scaled <= rel_tol}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed
    if not torch.cuda.is_available():
        sys.exit("attention_check_sensitivity: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 6)               # as attention_kernel_phase

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    B, L, H, Hkv, D = 1, 4096, 16, 8, 128
    q, k, v = (normal(B, L, h, D).to(torch.bfloat16) for h in (H, Hkv, Hkv))
    want = kf.flash_attention_plain(q, k, v)
    report("k6_causal_kernel", kf.flash_attention(q, k, v), want)
    for lo in (0, 2048, L - 128):
        report(f"k6_causal_without_keys_{lo}", flash_without(q, k, v, lo,
                                                             lo + 64), want)
    want = kf.flash_attention_plain(q, k, v, window=2048)
    report("k6_window_2048_kernel", kf.flash_attention(q, k, v, window=2048),
           want)
    report("k6_window_2048_without_keys_3008",
           flash_without(q, k, v, 3008, 3072, 2048), want)
    del q, k, v, want
    torch.cuda.empty_cache()

    B, S = 16, 32768
    rng = np.random.default_rng(seed + 7)
    lengths = torch.from_numpy(rng.integers(S // 2, S + 1, B).astype(
        np.int32)).to(dev)
    q = normal(B, H, D).to(torch.bfloat16)
    kc, vc = (normal(B, S, Hkv, D).to(torch.bfloat16) for _ in range(2))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, chunk = kd.decode_splits(B, Hkv, S, sms)
    print(json.dumps({"k7_splits": splits, "k7_chunk": chunk}), flush=True)
    want = kd.decode_attention_plain(q, kc, vc, lengths)
    report("k7_long_cache_kernel", kd.decode_attention(q, kc, vc, lengths),
           want)
    for c in (0, splits // 2):
        report(f"k7_long_cache_without_split_{c}",
               decode_without(q, kc, vc, lengths, c * chunk, (c + 1) * chunk),
               want)
    report("k7_long_cache_without_positions_8192_9215",
           decode_without(q, kc, vc, lengths, 8192, 9216), want)


if __name__ == "__main__":
    main()
