#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PathEnum (``src/repro_torch``) on one
NVIDIA GPU and hold every kernel of its main path against its plain
PyTorch version.

Run from the root of a checkout:  ``python3 chip_smoke.py``
(``--seed`` picks the queries, ``--n`` the vertex count of the large
graph; the defaults are what the numbers in PERF.md come from).

Phases, one JSON line each (``{"phase": ...}``):

0. ``lint``    — the port's static analysis over this checkout
   (``repro_torch.analysis.lint_repo``, what ``python -m
   repro_torch.analysis --strict`` runs): files, findings, suppressed
   findings and seconds.  Any finding fails the run, so a tree that
   breaks the port's contract (a fallback that hides a kernel, a JAX
   import, a narrow rank cost, ...) cannot pass.  In a checkout without
   the markdown documents that ``doc-links`` reads, that one rule is
   skipped and the line names the missing documents (``skipped``).
1. ``env``     — torch/CUDA versions and the seconds the kernel build took
   (every ``csrc/*.cu`` compiled by nvcc, all at once).
2. ``kernel``  — each kernel against its plain version on the card at the
   main path's shapes: exact equality (all values are integers or
   float32 integers), median time from CUDA events, the plain version's
   time, a one-call PyTorch yardstick where one exists, and the least
   time the card could take (``bound_ms``: bytes over 3.35 TB/s or
   operations over 67 TFLOP/s float32, whichever is larger).  K2 (one
   deque round, one launch of its persistent kernel) is compared on the
   regions the host reads back (``deque_contract``), each timed call starts
   from a fresh state restored outside the timed window, and the line
   gives its launches and loop iterations; K1, K2, K3 and K4 also give
   ``device_ms``, the card's part of a call, and K4 its time over the
   transpose (``transposed_ms``).  Then the ``bfs_dense`` line: K4 as one
   launch for a whole bounded BFS, forward and over the transpose, at the
   small phase's shape (n = 2000, k = 4), against k plain relaxations.
3. ``large``   — the main path at scale: ``erdos_renyi(n, 16.0)`` held on
   the card, queries at k = 8 through
   ``PathEnum(backend="device", use_device_index=True).query``: device
   index build, planner, IDX-DFS in the resident work deque (K2, whose
   kernel runs K1's per-row logic) for full enumerations, and on K1's hop
   entry in the host loop for ``first_n`` (the line gives its hops and K1
   launches).
4. ``small``   — the device walk-count DP (K3, K4), which runs only on
   graphs of at most 2048 vertices: ``power_law(2000, 6.0, seed=3)`` with
   ``mode="join"`` and with ``mode="auto"`` at a τ low enough that the
   full estimator runs; each query's K4 launches equal its bounded BFS
   (one launch each).
5. ``batch``   — the batch engine on the same large graph through
   ``BatchPathEnum(backend="device").run``: the stacked BFS on the card,
   the host index builds, and three legs.  ``fused``: ``--batch`` k = 8
   queries with pairwise distinct s and t, all enumerated together in
   fused launches of K5.  ``shared``: 4 sources × 4 targets of those
   queries, with duplicates, run twice (overlap groups share one prefix
   walk; the second run hits the index cache).  ``first_n``: the fused
   leg again with ``first_n=1000``.
6. ``check``   — the main path's results against the port's host backend
   run on the same indexes (counts, paths, Fig.-6 stats, plans, DP
   tables), every batch item against a solo host run of its index, and
   the small graph's paths against the recursive oracle.
7. ``serve``   — the HcPE front-ends on the card: tenants ``social`` (the
   large graph) and ``small`` (the small phase's) in one
   ``GraphRegistry``, one ``BatchPathEnum(backend="device")`` behind an
   ``HcPEServer`` and two ``AsyncHcPEServer``s.  Lines ``sync`` (40
   requests: the batch picks counting, 8 with ``first_n=1000`` and paths,
   8 duplicates, 8 on ``small``; counts against the batch phase's checked
   results and a host run) and ``sync_warm`` (the same, all cached);
   ``async`` (a seeded burst of 64, deadlines 50/200/1000 ms or none,
   equal to the sync answers; then a lone full walk on K2 and a lone
   ``first_n`` walk on K1's hop); ``deadline`` (enforced 0 ms deadlines:
   unexhausted subsets); ``mutate`` (``registry.mutate`` drops an edge of
   the first pick's paths and adds 64: no stale index, every re-served
   pick equal to a host walk of a host build on the new version, no path
   over the removed edge; a second mutation may leave at most a tenth of
   a graph copy more on the card); ``metrics`` (both servers' snapshots,
   no counter identity broken).  Then ``serve_check``: K5, K2 and K1's
   hop launched in the phase, no attention kernel.
8. ``ranked``  — ranked (any-k), constrained and baseline enumeration
   through the entry points.  ``ranked_hops``: the large phase's queries
   with ``order="hops"`` (full, and ``first_n=1000``) on the bucketed
   driver over K1's hop entry, equal row for row to the host heap and to
   the unranked exhausted walk, the top n its prefix (buckets drained,
   K1 hop launches, stats).  ``ranked_weight``: seeded non-negative
   float64 weights on every edge, ``order="weight"`` (device index, host
   heap): the unranked paths re-sorted by ``rank.path_costs`` and
   ``canonical_perm``.  ``ranked_join``: the small graph, both orders,
   ``mode="join"`` and ``"dfs"``, against the rank-order oracle.
   ``constrained``: ``AccumulativeValue`` with and without
   ``monotone_upper`` and ``ActionSequence`` on the large queries,
   against the unranked paths post-filtered over the graph's own edge
   ids; an ``edge_predicate_mask`` on the small graph against the oracle.
   ``serve_ranked``: the large graph as a weighted tenant beside the
   weightless small one behind a fresh engine, an ``HcPEServer`` batch
   and an ``AsyncHcPEServer`` burst of both orders with and without
   ``first_n`` on 4 picks, each answer equal to the solo ``PathEnum``
   result, one ``order="weight"`` request on the small tenant
   ``rejected_no_weights``, no failed micro-batch.  ``baseline``:
   ``generic_dfs`` (Alg. 1) on the small graph, its count equal to
   PathEnum's and its Fig.-6 ``edges_accessed`` beside the index walk's.
   Each line names the backend its queries resolved to.  Then
   ``ranked_check``: K1's hop launched, K5, K2 and the attention kernels
   never.
9. ``mesh``    — the mesh engine (``repro_torch.distributed``) over the
   large graph at k = 8 on the batch phase's picks.  ``mesh_1``: a 1 x 1
   NCCL ``DeviceMesh`` in this process (``compat.make_mesh`` on a free
   local port, the process group destroyed afterwards):
   ``DistributedPathEnum.query_batch_stats``, its distances equal to
   ``batched_index_distances``, its walk-count tables within rtol 1e-5
   of ``repro``'s recurrence written out in float64 (one sparse product
   a level; float32 atomics sum larger counts in any order) and at or
   above the host ``walk_count_dp`` of each pick's index (which drops
   the edges into s and out of t that the mesh DP keeps: the line says
   how many picks it counts more walks for); then ``enumerate_batch``
   counting and with ``first_n=1000`` on one default engine, equal to
   the batch phase's checked results (lines ``mesh_1_stats``,
   ``mesh_1``: stage seconds, the row's share (queries and keys owned,
   BFS, engine and gather seconds, payload bytes), ``BatchTiming``,
   edge bytes a rank, peak ``max_memory_allocated``, collective calls
   and bytes, launches).  ``mesh_gloo2``: two spawned processes on the
   one card, a 1 x 2 gloo mesh (the edges split in two; gloo reduces on
   the host, ``"wire": "host"``), loading the graph's arrays from a
   temporary file this script writes; their tables equal ``mesh_1``'s
   (distances exactly, DP within rtol 1e-5).  ``mesh_split2``: two such
   processes as a 2 x 1 gloo mesh (data = 2; NCCL refuses two ranks on
   one card), ``enumerate_batch`` on the same legs, each row
   enumerating the picks whose source it owns (s mod 2) on one default
   engine a rank, each leg's launches counted from 0 just before it;
   both ranks' gathered items equal ``mesh_1``'s (the fused flag apart),
   with its cache stats and non-fused counters (a line a leg: queries
   owned, each rank's wall, ``BatchTiming`` and stage seconds, the
   call's wall beside ``mesh_1``'s, gather calls and bytes, K5 launches
   a rank).  ``wire``: ``compressed_all_reduce`` of a float32 tree of
   lm100m's parameter shapes (107 M elements) from the seed, on the 2 x
   1 gloo ranks and on a 1 x 1 NCCL group in this process; each rank's
   sum bit-identical to the int64 sum of every rank's quantized values,
   rebuilt from the seeds; the bytes on the wire beside an int32
   carry's and float32's, and on NCCL the ms of packing, the
   all-reduces and unpacking.  Then ``mesh_check``: K5 launched in
   ``mesh_1`` and on each rank of ``mesh_split2``, K3, K4, K6 and K7
   never in ``mesh_1``.
10. ``kernel``  — the attention kernels K6 and K7 against their plain
   versions at fixed shapes: K6 at (B=1, L=4096, H=16, Hkv=8, D=128),
   causal, windowed (2048), and with Lq < Lk, each in float32 (the
   split-TF32 kernel) and bfloat16 (the wgmma kernel); K7
   over a long cache (B=16, S=32768, lengths from the seed in [S/2, S])
   in float32 and bfloat16; then at phi3-vision's head dim 96 (32 query
   and 32 KV heads): K6 at L = 4096, causal, and K7 over a 32768-long
   cache of 4 rows, both dtypes.  Each within its tolerance (2e-5 in float32,
   2e-2 in bfloat16: the online softmax sums in another order; bfloat16
   also within 2^-4 of |want| + the rms of want's row, element by
   element, ``scaled_err``, and on that measure no further from the
   plain version in float32 than 1.5 times the plain bfloat16 version
   is), timed
   (``ms`` per call as a caller sees it, ``device_ms`` the card's part
   with the launches queued ahead) beside its plain version,
   ``scaled_dot_product_attention`` as the one-call yardstick, and its
   bound (bfloat16 operations over 989 TFLOP/s; K6 in float32 three TF32
   products per operation over 495 TFLOP/s, with ``simt_bound_ms``, its
   operations over the 67 TFLOP/s of float32 FMAs, beside it).
11. ``lm``      — the LM serving path at full width and depth:
   ``internlm2_1p8b`` (24 layers, d_model 2048, 16 query and 8 KV heads
   of 128, vocab 92544) in float32 with random weights from the seed.
   ``make_prefill`` on 2 prompts of 2048 tokens (K6 in every layer), then
   a ``ServeEngine`` with 8 slots and max_len 1024 serving 16 greedy
   requests (prompts of 8–64 tokens, 32 new tokens each; K7 in every
   layer of every step).  Then K6 and K7 are held against their plain
   versions at the shapes this phase gave them (``kernel`` lines).
12. ``lm_check`` — against the port's own plain path on the card, TF32
   off: the prefill's last logits against ``forward(impl="xla")``; four
   served requests teacher-forced through ``decode_step`` (K7), every
   position's logits against ``forward(impl="xla")`` over the same
   tokens; every served token equal to the plain argmax wherever the
   plain top-two margin exceeds the tolerance (2e-3 on logits of order
   1: float32 sums in other orders through 24 layers stay far below it,
   a bfloat16 computation would not).
13. ``lm_bf16`` — the same weights cast to bfloat16 (3.78 GB) with a
   bfloat16 cache: the same prefill and the same 16 requests, with its
   own ``lm_bf16_trace`` and K6/K7 ``kernel`` lines at its shapes (K6 on
   the wgmma kernel, K7 in bfloat16).
14. ``lm_bf16_check`` — the bfloat16 prefill's last logits from the
   kernels and from ``forward(impl="xla")`` in bfloat16, each against
   the float32 plain path on the same bfloat16-rounded weights: the
   kernels' error may be at most 1.5 times the plain path's.  Both
   errors are printed, and K6's share of the prefill.
15. ``families`` — the five families past dense at full width, random
   weights from the seed.  First K6 and K7 at recurrentgemma-9b's
   attention (``kernel`` lines, both dtypes: K6 at (1, 4096, 16, 1, 256)
   with its 2048 window, K7 over an 8-slot ring buffer of 2048
   positions).  Then one leg each: phi3-vision (2 × 512 prompt tokens,
   a 256-row ``prefix_emb``), musicgen (2 × 512, 64 rows), mamba2 (2 ×
   512; no attention kernel may launch) and recurrentgemma (1 × 4096, so
   the window bites) in float32; qwen3-moe (2 × 512) and llama4-maverick
   cut to one (moe, dense) super-block (2 × 512) in bfloat16.  Each leg:
   a timed prefill, 8 greedy requests (8–32 prompt tokens, 16 new) on an
   8-slot engine, peak ``max_memory_allocated``, its launches, a traced
   decode step (``families_trace``), K6 and K7 ``kernel`` lines at the
   shapes the leg gave them (case = the arch), and ``families_check``
   lines: float32 legs as ``lm_check`` on two requests, and
   recurrentgemma also two requests decoded on a 16-position ring, so
   it wraps, against the plain forward with a 16-position window;
   bfloat16 legs by ``moe_check``, the served prefill and two
   teacher-forced requests' decode, every path on the kernel path's
   expert routes and the routes each takes on its own counted:
   qwen3-moe under ``lm_bf16_check``'s rule at all 48 layers (its
   float32 reference casts each layer when it reads it), llama4 against
   the plain bfloat16 path.
16. ``train`` — LM training through ``Trainer.fit``, float32 with TF32
   off.  ``train``: llama3.2-1b at full width and depth (16 layers, d
   2048, vocab 128,256, 1.24 B parameters), float32 AdamW state, remat,
   ``SyntheticLM`` 8 × 1024 tokens, 6 steps: seconds a step (median of
   steps 2–6), tokens/s, loss and grad_norm a step, stragglers, peak
   ``max_memory_allocated``, finite values and moved parameters; then
   ``train_microbatches``: the first step with ``microbatches=2``
   against 1 (loss within 1e-5, grad_norm within 1e-4 relative) and a
   traced step.  ``train_ssm``: mamba2-780m at full width (48 SSD
   layers, chunks of 128), 2 steps of 2 × 512.  ``train_restart``:
   ``launch.train``'s lm100m preset, 8 steps with ``ckpt_every=4`` into
   a temporary directory (deleted afterwards), the restored tree equal
   to the saved one bit for bit, a second Trainer that resumes at step 8
   and runs to 12, and two uninterrupted 12-step runs: the restart's
   parameters within ``TRAIN_RESTART_LR_FRACTION`` of the summed
   learning rate, or ``TRAIN_RESTART_SPREAD`` times the two fresh runs'
   own spread where that is larger.  ``train_corpus``:
   ``launch.train.main`` with ``--data path_corpus`` on the card, the
   corpus's batches on the card equal to the CPU's, K1's hop entry
   launched.  Then ``train_check``: no K6 or K7 launch in the phase,
   and both raise on CUDA inputs that require grad.
17. ``shard`` — the LM's mesh layout (``distributed.sharding``,
   ``distributed.constraints``, DTensor).  The dry-run cells start first,
   each in a process of its own on the host (``--dryrun-cell``).
   ``shard_train``: the ``train`` leg's llama3.2-1b, 8 × 1024, 4 steps
   through ``Trainer(mesh=make_local_mesh())``, a 1 × 1 NCCL mesh with
   every parameter and state leaf a DTensor, against an unsharded
   Trainer from the same seed (loss and parameters within 1e-6 relative:
   on one rank every redistribute is a no-op), seconds a step beside the
   ``train`` leg's, peak ``max_memory_allocated``, a traced step.
   ``shard_serve``: the ``lm`` phase's internlm2-1.8b with DTensor
   parameters, batch and cache: a prefill of 2 × 2048 and 16 decode
   steps of 8 slots, K6 and K7 on local shards through ``local_map`` in
   every attention call (``models.attention.mesh_routes``), logits
   within 2e-5 of the unsharded kernel path.  (No gloo mesh of two
   processes on the card: DTensor's functional all-gather crashes over
   gloo on CUDA tensors, ``tools/gloo_cuda_collectives.py``; multi-rank
   layouts are held by the CPU tests.)  ``dryrun``: the three production
   cells of ``DRYRUN_CELLS`` on fake process groups of 256 and 512
   ranks (status, FLOPs, argument and peak bytes, collective bytes a
   device).  ``dryrun_check``: the dry run of ``shard_train``'s step on
   a (1, 1) fake mesh against the card: argument bytes and
   ``FlopCounterMode``'s FLOPs equal, the peak estimate within
   ``DRYRUN_PEAK_RATIO`` of ``max_memory_allocated``.  Then
   ``shard_check``: no K6 or K7 launch in ``shard_train``.
18. ``examples`` — the nine examples (``repro_torch.examples``,
   ``repro``'s ``examples/*.py`` under the same names) through their
   ``main(["--device", "cuda"])``, what they print sent to stderr: a line
   each with its seconds on the card, its launches and the card's name
   and power limit.  Each must return (its own asserts hold) and launch
   the kernels ``EXAMPLE_KERNELS`` names (none in fraud_detection and
   train_lm, K7 in serve_batch).  The six PathEnum examples (quickstart,
   fraud_detection, batch_serving, multi_tenant_serving, async_serving,
   streaming_serving) must return the values of their ``--device cpu``
   run, which calls the plain versions (``cpu_seconds``), but for those
   ``examples.CLOCK_BOUND`` names (``excepted``: async_serving's SLO-met
   count and micro-batches, which follow the wall clock).  Then
   ``examples_check``.

The launch counts are set to 0 just before phase 3 and read just after
phase 5, and set to 0 again just before phase 7, phase 8, the
``mesh_1`` leg and, in each rank, each ``mesh_split2`` leg of phase 9,
phase 11, phase 13, each leg of phase 15,
phase 16, the ``shard_train`` and ``shard_serve`` legs of phase 17 and
each example of phase 18, each read just after its phase, leg or
example.  K5 is held against its plain
version at the shape of the fused leg's largest dispatch, once by entry:
the masks (a ``kernel`` line timed on a member table already on the
card, with ``device_ms`` beside it; ``list_entry_ms`` times the
list-taking entry, which builds and copies the table) and the hop, which
the fused expand calls (the ``frontier_fused_hop`` ``kernel`` line: the
entry's ``ms`` and ``device_ms`` on the rows unpadded, ``dispatch_ms``
for the whole fused expand, drained after each call, and its device
operations, at most 5).  K1's
hop entry is held against its plain version at the largest hop of the
large phase's ``first_n`` leg (the ``frontier_hop`` ``kernel`` line: the
entry's ``ms`` and ``device_ms``, ``hop_ms`` for the whole hop as the
driver pays it, drained, and its device operations, at most 7).  Last,
the script prints the ``kernels`` line (K1–K7, K6 as its two kernels;
``frontier_hop``, ``frontier_fused_hop`` and ``bfs_dense`` beside K1, K5
and K4, whose counts take every launch of their kernel from either
entry), the card's name and
power limit as nvidia-smi gives them, and the ``ok`` line.
Any failed check exits non-zero before those lines.  Without a CUDA
device, or outside a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM data sheet, float32 outside MMA
BF16_OPS_PER_S = 989e12          # H100 SXM data sheet, dense bf16 MMA
TF32_OPS_PER_S = 495e12          # H100 SXM data sheet, dense TF32 MMA

K_LARGE = 8
TAU = 1e5
CHUNK = 16384
PICK_SECONDS = 150.0             # probe budget for the large queries
RANKED_FIRST_N = 1000            # the ranked phase's top-n requests

PATHENUM_KERNELS = ("frontier_masks", "frontier_hop", "frontier_fused_masks",
                    "frontier_fused_hop", "frontier_deque_round",
                    "counting_spmm", "minplus_spmv", "bfs_dense")
LM_KERNELS = ("flash_attention", "decode_attention")
LM_BF16_KERNELS = ("flash_attention_sm90", "decode_attention")
# kernels the mesh phase must not launch: the DP and BFS run as torch
# scatters over the edge list, and no attention runs
MESH_KERNELS_OFF = ("counting_spmm", "minplus_spmv", "bfs_dense",
                    "flash_attention", "flash_attention_sm90",
                    "decode_attention")
# repro's own kernel tolerances (tests/test_kernels.py): the online
# softmax sums in another order than one softmax over the row
ATTN_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
# bfloat16 also holds each element to its own size: |got - want| at most
# this fraction of |want| + the rms of want's row (over D).  The absolute
# 2e-2 alone is twice a typical output over a long row (about 0.01), so
# it could not see a dropped chunk or KV tile (0.9 or more on this
# measure).  The plain versions round their logits to bfloat16 and the
# kernels do not, which alone puts them up to about 0.03 apart; against
# the plain version in float32 the kernel's error, on the same measure,
# may be at most BF16_ERR_RATIO times the plain bfloat16 version's
ATTN_REL_TOL = {"torch.bfloat16": 2.0 ** -4}
LM_ARCH = "internlm2_1p8b"
LM_TOL = 2e-3                    # logits of order 1, float32, 24 layers
# the bfloat16 leg: K6/K7's logit error against the float32 plain path
# may be at most this multiple of the plain bfloat16 path's error
BF16_ERR_RATIO = 1.5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def lint_phase() -> None:
    """The ``lint`` phase: ``repro_torch.analysis`` over this checkout.
    Prints each finding, then the phase's line, and fails on any finding
    (``--strict``)."""
    from repro_torch.analysis import ALL_PASSES, lint_repo
    from repro_torch.analysis.passes.docs import documents

    t0 = time.perf_counter()
    # a checkout of the program alone may leave out the markdown documents;
    # doc-links would then report their absence, not a fault of the port,
    # so it runs only where every document it reads is present
    missing = [d for d in documents(ROOT) if not (ROOT / d).exists()]
    rules = [p.name for p in ALL_PASSES
             if not (missing and p.name == "doc-links")]
    report = lint_repo(ROOT, rules=rules)
    seconds = time.perf_counter() - t0
    for f in report.findings:
        print(f.render(), flush=True)
    emit({"phase": "lint", "files": report.files,
          "findings": len(report.findings),
          "suppressed": report.suppressed, "seconds": seconds,
          "skipped": {"doc-links": missing} if missing else {}})
    check(report.exit_code(strict=True) == 0,
          f"the port does not lint clean: {len(report.findings)} "
          f"finding(s) (python -m repro_torch.analysis --strict): "
          + "; ".join(f.render() for f in report.findings[:5]))


def time_ms(torch, fn, reps: int, warmup: int = 2, batches: int = 3
            ) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``batches``
    such runs, after ``warmup`` calls.  The host's launch cost is
    included where it exceeds the device's time, as a caller sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def bound(nbytes: float, ops: float, peak: float = FP32_OPS_PER_S
          ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scaled_err(torch, got, want) -> float:
    """Largest |got - want| / (|want| + rms of want's row over the last
    dimension): an error in units of the element's own size, which no
    row's smallness hides.  Rows where the plain version is not finite
    (K7's length-0 rows: NaN there, zeros from the kernel) are left
    out."""
    if not want.numel():
        return 0.0
    w = want.double()
    ok = torch.isfinite(w).all(-1, keepdim=True)
    w = torch.where(ok, w, 0.0)
    d = torch.where(ok, (got.double() - w).abs(), 0.0)
    rms = w.square().mean(-1, keepdim=True).sqrt()
    return (d / (w.abs() + rms).clamp_min(1e-30)).max().item()


def max_abs_err(torch, got, want) -> float:
    """Largest |got - want| over paired tensors (0 when equal)."""
    err = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
              f"{tuple(b.shape)} {b.dtype}")
        if a.numel():
            d = (a.double() - b.double()).abs().max().item()
            err = max(err, d)
    return err


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def host_level_chunk(np, en, idx, rows_max):
    """The widest host frontier level of the index's walk (depth <= k-2),
    cut to ``rows_max`` rows: the rows a deque pop hands to K1."""
    k = idx.k
    paths = np.full((1, k + 1), -1, np.int32)
    paths[0, 0] = idx.s
    best = (paths, 0)
    for d in range(k - 1):
        if paths.shape[0] >= best[0].shape[0]:
            best = (paths[:rows_max], d)
        exp = en._expand_chunk(idx, paths, d, en.EnumStats())
        if exp is None:
            break
        parent, _pos, vnew, _emit, cont = exp
        sel = np.nonzero(cont)[0]
        if sel.size == 0:
            break
        paths = paths[parent[sel]].copy()
        paths[:, d + 1] = vnew[sel]
    return best


def round_work(np, en, idx, chunk_size, pops):
    """Rows read, candidate edges and rows written by the first ``pops``
    chunks of the host walk (the same chunks a deque round pops)."""
    k = idx.k
    root = np.full((1, k + 1), -1, np.int32)
    root[0, 0] = idx.s
    work = [(root, 0)]
    rows_in = edges = rows_out = done = 0
    while work and done < pops:
        paths, depth = work.pop()
        done += 1
        st = en.EnumStats()
        exp = en._expand_chunk(idx, paths, depth, st)
        rows_in += paths.shape[0]
        edges += st.edges_accessed
        if exp is None:
            continue
        parent, _pos, vnew, emit_m, cont = exp
        rows_out += int(emit_m.sum())
        if depth + 1 < k and cont.any():
            sel = np.nonzero(cont)[0]
            rows = paths[parent[sel]].copy()
            rows[:, depth + 1] = vnew[sel]
            rows_out += rows.shape[0]
            for st0 in reversed(range(0, rows.shape[0], chunk_size)):
                work.append((rows[st0:st0 + chunk_size], depth + 1))
    return rows_in, edges, rows_out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def pick_large_queries(np, tc, ops, en, est, g, count, seed, dev):
    """Up to ``count`` (s, t) pairs drawn from ``seed``, pairwise distinct
    in s and in t, whose k=8 index has at least DEVICE_AUTO_MIN_EDGES
    edges, is planned as IDX-DFS (Eq. 5 below τ) and fits the resident
    deque's slot budget; probing stops after PICK_SECONDS."""
    rng = np.random.default_rng(seed)
    picked, probes = [], 0
    t_end = time.perf_counter() + PICK_SECONDS
    while len(picked) < count and time.perf_counter() < t_end:
        s, t = (int(x) for x in rng.choice(g.n, 2, replace=False))
        if any(s == p[0] or t == p[1] for p in picked):
            continue
        probes += 1
        idx = tc.build_index_device(g, s, t, K_LARGE, device=dev)
        if idx.num_index_edges < en.DEVICE_AUTO_MIN_EDGES:
            continue
        if est.preliminary_estimate(idx) > TAU:
            continue
        max_deg = int((idx.fwd_end[:, K_LARGE] - idx.fwd_begin).max())
        if ops.deque_config(K_LARGE + 1, CHUNK, max_deg).cap \
                > en.DEVICE_SLOT_BUDGET:
            continue
        picked.append((s, t, idx))
    check(len(picked) > 0, f"no query qualified in {probes} probes")
    return picked, probes


def deque_contract(cfg, out):
    """The regions of a deque round's outputs that the host reads back
    (``ops.DequeConfig``): the scalars, ``arena[:arena_cap]``, the meta
    slots below ``max_chunks`` and ``emitbuf``/``emitlen[:n_emit]``.
    The CUDA round writes only these; the plain round's masked scatters
    also write the scratch past them."""
    arena, md, ml, top, nc, eb, el, ne, ctr, pops = out
    n = int(ne)
    return [top.reshape(1), nc.reshape(1), ne.reshape(1), ctr,
            pops.reshape(1), arena[:cfg.arena_cap], md[:cfg.max_chunks],
            ml[:cfg.max_chunks], eb[:n], el[:n]]


def deque_round_row(torch, np, en, ops, idx, cfg, dev):
    """K2, one round from a fresh deque, against its plain version on the
    regions the host reads back.  Every timed call starts from the same
    fresh state, restored by copies outside the timed window: ``ms`` is
    the median over calls of CUDA events around one call (the host's
    launch cost included), ``device_ms`` the card's part (the call queued
    behind ``torch.cuda._sleep``)."""
    k1 = idx.k + 1
    root = np.full(k1, -1, np.int32)
    root[0] = idx.s
    fresh = ops.frontier_deque_init(root, cfg=cfg, device=dev)
    work = [x.clone() for x in fresh]
    da = idx.device_arrays()
    rargs = (da.begin, da.end, da.dst, idx.t)

    def restore():
        for w, f in zip(work, fresh):
            w.copy_(f)
        torch.cuda.synchronize()

    def timed(fn, reps, sleep=False):
        times = []
        for _ in range(reps):
            restore()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            if sleep:
                torch.cuda._sleep(20_000_000)
            start.record()
            fn(*work, *rargs, cfg=cfg)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    restore()
    launches0 = ops.deque_rounds
    got = ops.frontier_deque_round(*work, *rargs, cfg=cfg)
    got = [x.clone() for x in got]
    launches = ops.deque_rounds - launches0
    iterations = ops.last_round_iterations()
    restore()
    want = ops.frontier_deque_round_plain(*work, *rargs, cfg=cfg)
    err = max_abs_err(torch, deque_contract(cfg, got),
                      deque_contract(cfg, want))
    check(err == 0, f"frontier_deque_round differs from its plain version: "
                    f"{err}")
    pops = int(got[9])
    check(launches == 1, f"one round took {launches} launches")
    check(iterations <= pops + 1,
          f"{iterations} loop iterations for {pops} pops")
    del got, want
    r_in, r_edges, r_out = round_work(np, en, idx, CHUNK, pops)
    nbytes = r_in * (k1 * 4 + 8) + r_edges * 4 + r_out * (k1 * 4 + 4)
    b_ms, b_by = bound(nbytes, r_edges * (k1 + 4))
    row = dict(
        max_abs_err=err,
        ms=timed(ops.frontier_deque_round, 7),
        device_ms=timed(ops.frontier_deque_round, 5, sleep=True),
        plain_ms=timed(ops.frontier_deque_round_plain, 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=dict(block_rows=cfg.block_rows, max_deg=cfg.max_deg,
                   round_pops=cfg.round_pops, pops=pops,
                   launches=launches, loop_iterations=iterations,
                   grid_syncs=2 * pops + 1, rows_in=r_in, edges=r_edges,
                   rows_out=r_out))
    del work, fresh
    return row


def kernel_phase(torch, np, en, ops, fe, sr, idx, dev):
    """Each kernel against its plain version, timed, at the path's shapes."""
    rows = {}
    k1 = idx.k + 1
    max_deg = int((idx.fwd_end[:, idx.k] - idx.fwd_begin).max())
    cfg = ops.deque_config(k1, CHUNK, max_deg)
    da = idx.device_arrays()

    # K1 at a deque pop's shape: block_rows rows, the index's pow2 fan-out
    real, depth = host_level_chunk(np, en, idx, cfg.block_rows)
    C = cfg.block_rows
    padded = np.full((C, k1), -1, np.int32)
    padded[:real.shape[0]] = real
    p = torch.from_numpy(padded).to(dev)
    meta = torch.tensor([depth, idx.t], dtype=torch.int32).to(dev)
    args = (p, da.begin, da.end, da.dst, meta)
    got = fe.frontier_masks(*args, max_deg=cfg.max_deg)
    want = fe.frontier_masks_plain(*args, max_deg=cfg.max_deg)
    err = max_abs_err(torch, got, want)
    check(err == 0, f"frontier_masks differs from its plain version: {err}")
    last = real[:, depth].astype(np.int64)
    edges = int((idx.fwd_end[last, idx.k - depth - 1]
                 - idx.fwd_begin[last]).sum())
    nbytes = (real.shape[0] * ((depth + 1) * 4 + 8) + (C - real.shape[0]) * 4
              + edges * 4 + 3 * C * cfg.max_deg * 4 + 16)
    b_ms, b_by = bound(nbytes, edges * (depth + 4))
    rows["frontier_masks"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fe.frontier_masks(*args,
                                                    max_deg=cfg.max_deg), 50),
        device_ms=device_ms(torch, lambda: fe.frontier_masks(
            *args, max_deg=cfg.max_deg), 50),
        plain_ms=time_ms(torch, lambda: fe.frontier_masks_plain(
            *args, max_deg=cfg.max_deg), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=dict(rows=C, real_rows=int(real.shape[0]), k1=k1, depth=depth,
                   max_deg=cfg.max_deg, edges=edges))

    # K2: one round from a fresh deque on the same index
    rows["frontier_deque_round"] = deque_round_row(torch, np, en, ops, idx,
                                                   cfg, dev)

    # K3 at n = 2048, q = 1 (the DP's shape) and q = 128
    rng = np.random.default_rng(5)
    n = 2048
    a = torch.from_numpy((rng.random((n, n)) < 0.01).astype(np.float32))
    a = a.to(dev)
    k3 = {}
    for q in (1, 128):
        x = torch.from_numpy(rng.integers(0, 16, (n, q)).astype(np.float32))
        x = x.to(dev)
        got = sr.counting_spmm(a, x)
        want = sr.counting_spmm_plain(a, x)
        err = max_abs_err(torch, [got], [want])
        check(err == 0, f"counting_spmm q={q} differs: {err}")
        b_ms, b_by = bound(n * n * 4 + 2 * n * q * 4, 2 * n * n * q)
        k3[q] = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: sr.counting_spmm(a, x), 50),
            device_ms=device_ms(torch, lambda: sr.counting_spmm(a, x), 50),
            plain_ms=time_ms(torch, lambda: sr.counting_spmm_plain(a, x), 50),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(torch, lambda: torch.matmul(a, x), 50),
            library_device_ms=device_ms(torch, lambda: torch.matmul(a, x),
                                        50),
            shape=dict(n=n, q=q))
    rows["counting_spmm"] = k3[1]
    emit({"phase": "kernel", "name": "counting_spmm", "q": 128, **k3[128]})

    # K4 at n = 2048
    inf = 1e9
    adj = torch.from_numpy(np.where(rng.random((n, n)) < 0.003, 1.0, inf)
                           .astype(np.float32)).to(dev)
    dist = np.full(n, inf, np.float32)
    dist[rng.choice(n, 16, replace=False)] = rng.integers(0, 4, 16)
    d = torch.from_numpy(dist).to(dev)
    err = 0.0
    for tr in (False, True):
        got = sr.minplus_spmv(adj, d, inf=inf, transposed=tr)
        want = sr.minplus_spmv_plain(adj, d, inf=inf, transposed=tr)
        err = max(err, max_abs_err(torch, [got], [want]))
    check(err == 0, f"minplus_spmv differs from its plain version: {err}")
    b_ms, b_by = bound(n * n * 4 + 2 * n * 4, 2 * n * n)
    rows["minplus_spmv"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: sr.minplus_spmv(adj, d, inf=inf), 50),
        device_ms=device_ms(torch, lambda: sr.minplus_spmv(adj, d, inf=inf),
                            50),
        transposed_ms=time_ms(torch, lambda: sr.minplus_spmv(
            adj, d, inf=inf, transposed=True), 50),
        transposed_device_ms=device_ms(torch, lambda: sr.minplus_spmv(
            adj, d, inf=inf, transposed=True), 50),
        plain_ms=time_ms(torch, lambda: sr.minplus_spmv_plain(adj, d,
                                                              inf=inf), 50),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: (adj + d[:, None]).amin(0), 50),
        shape=dict(n=n))
    for name, row in rows.items():
        emit({"phase": "kernel", "name": name, **row})
    return rows


def bfs_dense_row(torch, np, tc, est, ops, sr, g_small, dev):
    """K4 as one launch for a whole bounded BFS (``ops.bfs_dense``) at the
    small phase's shape: the dense adjacency of the index the planner
    builds for 1104 -> 997 at k = 4 on the small graph, from s forward and
    from t over the transpose, against k plain relaxations."""
    idx = tc.build_index(g_small, 1104, 997, 4, device=dev)
    wadj, _amat, inf = est._dense_adjacency(idx)
    n, k = wadj.shape[0], idx.k
    err = 0.0
    for src, tr in ((idx.s, False), (idx.t, True)):
        got = ops.bfs_dense(wadj, src, k, inf=inf, transposed=tr)
        want = sr.bfs_dense_plain(wadj, src, k, inf=inf, transposed=tr)
        err = max(err, max_abs_err(torch, [got], [want]))
    check(err == 0, f"bfs_dense differs from its plain version: {err}")
    # the adjacency read once, the output written once; k relaxations of
    # an add and a min per entry
    b_ms, b_by = bound(n * n * 4 + n * 4, 2 * k * n * n)
    row = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.bfs_dense(wadj, idx.s, k, inf=inf),
                   50),
        device_ms=device_ms(torch, lambda: ops.bfs_dense(wadj, idx.s, k,
                                                         inf=inf), 50),
        transposed_ms=time_ms(torch, lambda: ops.bfs_dense(
            wadj, idx.t, k, inf=inf, transposed=True), 50),
        transposed_device_ms=device_ms(torch, lambda: ops.bfs_dense(
            wadj, idx.t, k, inf=inf, transposed=True), 50),
        plain_ms=time_ms(torch, lambda: sr.bfs_dense_plain(
            wadj, idx.s, k, inf=inf), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=dict(n=n, k=k))
    emit({"phase": "kernel", "name": "bfs_dense", **row})
    return row


def record_largest_hop(ops):
    """Wrap ``ops.frontier_expand_readback`` (looked up at call time by the
    solo host-looped driver) so the arguments of its largest call (rows
    × fan-out) are kept; returns the record and a function that unwraps
    it."""
    orig = ops.frontier_expand_readback
    seen = {"slots": -1, "calls": 0}

    def wrapped(paths, begin, end, dst, *, depth, t, max_deg,
                want_cont=True):
        seen["calls"] += 1
        slots = len(paths) * max_deg
        if slots > seen["slots"]:
            seen.update(slots=slots, args=(paths, begin, end, dst),
                        kw=dict(depth=depth, t=t, max_deg=max_deg,
                                want_cont=want_cont))
        return orig(paths, begin, end, dst, depth=depth, t=t,
                    max_deg=max_deg, want_cont=want_cont)

    ops.frontier_expand_readback = wrapped

    def restore():
        ops.frontier_expand_readback = orig
    return seen, restore


def device_ops(torch, fn, reps: int):
    """Device operations (kernels, copies, memsets) and the card's busy
    microseconds per call of ``fn``, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (len(evs) / reps,
            sum(e.device_time_total for e in evs) / reps if evs else None)


def hop_kernel_row(torch, np, fe, ops, largest, dev):
    """K1's hop entry against its plain version at the largest hop of the
    large phase's ``first_n`` leg: ``ms`` and ``device_ms`` time the entry
    on the chunk already on the card; ``hop_ms`` the whole
    ``ops.frontier_expand_readback`` (copy in, hop, head and rows back),
    as the host-looped driver pays a hop, with its device operations and
    the card's busy time per hop from the profiler."""
    paths, begin, end, dst = largest["args"]
    kw = largest["kw"]
    rows, k1 = paths.shape
    md = 1 << max(kw["max_deg"] - 1, 0).bit_length()
    p = torch.from_numpy(np.ascontiguousarray(paths)).to(dev)
    meta = torch.tensor([kw["depth"], kw["t"]], dtype=torch.int32).to(dev)
    hop_kw = dict(max_deg=md, want_cont=kw["want_cont"])

    def run():
        return fe.frontier_hop(p, begin, end, dst, meta, **hop_kw)
    got = run()
    want = fe.frontier_hop_plain(p, begin, end, dst, meta, **hop_kw)
    ne, nc = int(want[2][4]), int(want[2][5])
    err = max_abs_err(torch, [got[2], got[0][:ne], got[1][:nc]],
                      [want[2], want[0][:ne], want[1][:nc]])
    check(err == 0, f"frontier_hop differs from its plain version: {err}")
    host = ops.frontier_expand_readback(paths, begin, end, dst, **kw)
    check(host[2] == want[2][:3].tolist(), "frontier_expand_readback's "
                                           "counters differ")
    edges, depth = int(want[2][0]), kw["depth"]
    valid = int((paths[:, depth] >= 0).sum())
    # the chunk, each valid row's begin/end gathers, one dst read per
    # candidate edge, each child row written once, [depth, t] and the head
    nbytes = (rows * k1 * 4 + valid * 8 + edges * 4 + (ne + nc) * k1 * 4
              + 8 + 32)
    b_ms, b_by = bound(nbytes, edges * (depth + 4))
    n_ops, busy = device_ops(torch, lambda: ops.frontier_expand_readback(
        paths, begin, end, dst, **kw), 20)
    check(n_ops <= 7, f"a first_n hop makes {n_ops} device operations")
    row = dict(
        max_abs_err=err, ms=time_ms(torch, run, 50),
        device_ms=device_ms(torch, run, 50),
        hop_ms=dispatch_ms(torch, lambda: ops.frontier_expand_readback(
            paths, begin, end, dst, **kw), 50),
        device_ops=n_ops, device_busy_us=busy,
        plain_ms=time_ms(torch, lambda: fe.frontier_hop_plain(
            p, begin, end, dst, meta, **hop_kw), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=dict(rows=rows, k1=k1, depth=depth, max_deg=md,
                   want_cont=kw["want_cont"], edges=edges, n_emit=ne,
                   n_cont=nc, valid_rows=valid, hops_in_leg=largest["calls"]))
    emit({"phase": "kernel", "name": "frontier_hop", **row})
    return row


def large_phase(torch, tc, kernels, g, queries, dev):
    """The main path at scale; returns the outputs to check later and the
    largest hop of the ``first_n`` leg."""
    pe = tc.PathEnum(tau=TAU, chunk_size=CHUNK, backend="device",
                     use_device_index=True, device=dev)
    fe = kernels.frontier_expand
    runs = []
    largest = None
    for i, (s, t, _idx) in enumerate(queries):
        legs = [("count_only", dict(count_only=True))]
        if i == 0:
            legs += [("paths", dict(count_only=False)),
                     ("first_n", dict(first_n=1000))]
        for leg, kw in legs:
            rounds0 = kernels.ops.deque_rounds
            k1_0, hops0 = fe.launches, fe.hop_launches
            seen, restore = record_largest_hop(kernels.ops)
            torch.cuda.synchronize()
            try:
                out = pe.query(g, s, t, K_LARGE, **kw)
            finally:
                restore()
            r = out.result
            rounds = kernels.ops.deque_rounds - rounds0
            if leg == "first_n":
                largest = seen
            runs.append((s, t, leg, kw, out, rounds))
            emit({"phase": "large", "s": s, "t": t, "k": K_LARGE, "leg": leg,
                  "index_edges": out.index.num_index_edges,
                  "index_device_bytes":
                      out.index.device_arrays().memory_bytes(),
                  "plan": out.plan.method,
                  "preliminary": out.plan.preliminary,
                  "count": r.count, "stats": vars(r.stats),
                  "exhausted": r.exhausted, "deque_rounds": rounds,
                  "last_round_iterations":
                      kernels.ops.last_round_iterations() if rounds else None,
                  "hops": seen["calls"],
                  "k1_launches": fe.launches - k1_0,
                  "k1_hop_launches": fe.hop_launches - hops0,
                  "index_s": out.timing.index_seconds,
                  "plan_s": out.timing.optimize_seconds,
                  "enum_s": out.timing.enumerate_seconds})
    check(largest is not None and largest["calls"] > 0,
          "the first_n leg made no hop")
    return runs, largest


def small_phase(np, tc, sr, g, dev):
    """The device DP on a graph small enough for it (n <= 2048)."""
    runs = []
    rng = np.random.default_rng(3)
    queries = [(1104, 997, 4)]
    while len(queries) < 3:
        s, t = (int(x) for x in rng.choice(g.n, 2, replace=False))
        if tc.build_index(g, s, t, 5, device=dev).num_index_edges >= 64:
            queries.append((s, t, 5))
    for s, t, k in queries:
        for mode, tau in (("join", TAU), ("auto", 1.0)):
            pe = tc.PathEnum(tau=tau, backend="device", device=dev)
            k4, bfs = sr.minplus_launches, sr.bfs_launches
            out = pe.query(g, s, t, k, mode=mode)
            k4, bfs = sr.minplus_launches - k4, sr.bfs_launches - bfs
            check(k4 == bfs, f"small {s}->{t}: {k4} K4 launches for {bfs} "
                             f"bounded BFS")
            runs.append((s, t, k, mode, tau, out))
            dp = out.plan.dp
            emit({"phase": "small", "s": s, "t": t, "k": k, "mode": mode,
                  "tau": tau, "plan": out.plan.method, "cut": out.plan.cut,
                  "dp_backend": dp.backend_used if dp else None,
                  "count": out.result.count, "bfs_dense_calls": bfs,
                  "k4_launches": k4,
                  "plan_s": out.timing.optimize_seconds,
                  "enum_s": out.timing.enumerate_seconds})
    return runs


def shared_queries(tc, est, g, picks, dev):
    """The shared leg's batch: the first 4 sources × first 4 targets of
    the picks, cross pairs kept where Eq. 5 stays below τ (so no pair
    explodes the check), the first two pairs repeated.  Returns the
    queries and an index per (s, t) for the check."""
    idxs = {(s, t): idx for s, t, idx in picks[:4]}
    for s, _t, _idx in picks[:4]:
        for _s, t, _idx2 in picks[:4]:
            if (s, t) in idxs or s == t:
                continue
            idx = tc.build_index_device(g, s, t, K_LARGE, device=dev)
            if est.preliminary_estimate(idx) <= TAU:
                idxs[(s, t)] = idx
    pairs = list(idxs)
    queries = [(s, t, K_LARGE) for s, t in pairs + pairs[:2]]
    return queries, idxs


def record_largest_fused(ops):
    """Wrap ``ops.frontier_expand_fused`` (looked up at call time by the
    fused driver) so the arguments of its largest call (rows × fan-out)
    are kept; returns the record and a function that unwraps it."""
    orig = ops.frontier_expand_fused
    seen = {"slots": -1}

    def wrapped(paths, rank, tvec, depthv, begins, ends, dsts, wantc, *,
                max_deg, member_table=None):
        slots = len(paths) * max_deg
        if slots > seen["slots"]:
            seen.update(slots=slots, args=(paths, rank, tvec, depthv,
                                           begins, ends, dsts),
                        wantc=wantc, max_deg=max_deg,
                        member_table=member_table)
        return orig(paths, rank, tvec, depthv, begins, ends, dsts, wantc,
                    max_deg=max_deg, member_table=member_table)

    ops.frontier_expand_fused = wrapped

    def restore():
        ops.frontier_expand_fused = orig
    return seen, restore


def engine_index_bytes(tc, eng, g, items):
    """Device bytes of the index arrays the engine's cache holds for a
    batch's distinct queries, and how many of those indexes hold device
    arrays at all (a host walk never makes them).  Reads the cache with
    ``peek``, so its LRU order and counters stay as they are, and makes
    no arrays an index has not made itself."""
    mh = tc.batch.edge_mask_hash(None)
    nbytes = held = 0
    for s, t, k in {(i.s, i.t, i.k) for i in items}:
        idx = eng.cache.peek((tc.DEFAULT_GRAPH_ID, s, t, k, mh,
                              int(g.version)))
        check(idx is not None, f"{s}->{t}: no index in the engine's cache")
        arrays = idx.__dict__.get("_device_arrays")  # made on first use
        if arrays is not None:
            nbytes += arrays.memory_bytes()
            held += 1
    return {"index_device_bytes": nbytes, "indexes_on_device": held}


def batch_phase(torch, tc, fe, ops, g, picks, shared, dev, nbatch):
    """The batch engine's three legs; returns the outputs to check."""
    eng = tc.BatchPathEnum(tau=TAU, chunk_size=CHUNK, backend="device",
                           device=dev)
    fused_qs = [(s, t, K_LARGE) for s, t, _ in picks[:nbatch]]
    shared_qs, shared_idx = shared
    index_of = dict(shared_idx)
    index_of.update({(s, t): idx for s, t, idx in picks[:nbatch]})
    largest, restore = record_largest_fused(ops)
    runs = []
    legs = [("fused", fused_qs, {}), ("shared", shared_qs, {}),
            ("shared_again", shared_qs, {}),
            ("first_n", fused_qs, {"first_n": 1000})]
    try:
        for leg, qs, kw in legs:
            k5 = fe.fused_launches
            torch.cuda.synchronize()
            out = eng.run(g, qs, count_only=False, **kw)
            torch.cuda.synchronize()
            k5 = fe.fused_launches - k5
            tm = out.timing
            emit({"phase": "batch", "leg": leg, "queries": len(qs),
                  "distinct": out.distinct_queries,
                  "distance_s": tm.distance_seconds,
                  "index_s": tm.index_seconds,
                  "optimize_s": tm.optimize_seconds,
                  "enumerate_s": tm.enumerate_seconds,
                  "total_s": tm.total_seconds,
                  "queries_per_s": out.throughput_qps,
                  "fused_queries": out.fused_queries,
                  "fused_dispatches": out.fused_dispatches,
                  "k5_launches": k5,
                  "sharing_groups": out.sharing_groups,
                  "shared_queries": out.shared_queries,
                  "cache_hits": out.cache_stats.hits,
                  "cache_misses": out.cache_stats.misses,
                  **engine_index_bytes(tc, eng, g, out.items),
                  "plans": sorted({i.plan.method for i in out.items}),
                  "results": out.total_results})
            runs.append((leg, kw, out, k5))
            if leg == "fused":
                restore()
    finally:
        restore()
    fused_out = runs[0][2]
    check(fused_out.fused_queries == len(fused_qs),
          f"fused leg: {fused_out.fused_queries} of {len(fused_qs)} "
          f"queries fused")
    check(fused_out.fused_dispatches >= 1 and runs[0][3] >= 1,
          "fused leg: no fused dispatch / K5 launch")
    check(runs[1][2].sharing_groups >= 1, "shared leg: no sharing group")
    again = runs[2][2].cache_stats
    check(again.hits == len(shared_qs) and again.misses == 0,
          f"shared leg, second run: cache {again}")
    return runs, index_of, largest


def dispatch_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the host clock with the card
    drained after each call, as a driver pays a dispatch whose results it
    reads back before the next."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def fused_kernel_row(torch, np, fe, ops, largest, dev):
    """K5's masks entry against its plain version at the fused leg's
    largest dispatch, padded as the fused expand's CPU route pads it.
    ``ms`` and ``device_ms`` time the masks entry on a member table
    already on the card; ``list_entry_ms`` the list-taking entry, which
    builds and copies the table.  The fused expand launches K5's hop
    entry (``fused_hop_kernel_row``)."""
    paths, rank, tvec, depthv, begins, ends, dsts = largest["args"]
    rank = np.asarray(rank)
    rows, k1 = paths.shape
    C = 1 << max(max(rows, 8) - 1, 0).bit_length()
    md = 1 << max(largest["max_deg"] - 1, 0).bit_length()
    padded = np.full((C, k1), -1, np.int32)
    padded[:rows] = paths
    rk = np.zeros(C, np.int32)
    rk[:rows] = rank
    args = (torch.from_numpy(padded).to(dev), torch.from_numpy(rk).to(dev),
            torch.from_numpy(np.asarray(tvec, np.int32)).to(dev),
            torch.from_numpy(np.asarray(depthv, np.int32)).to(dev),
            begins, ends, dsts)
    # the entry the fused expand calls, on a member table on the card
    table = torch.from_numpy(fe.fused_member_table(
        begins, ends, dsts, k1max=k1, device=dev)).to(dev)

    def run():
        return fe.frontier_fused_masks_table(*args[:4], table, max_deg=md)
    want = fe.frontier_fused_masks_plain(*args, max_deg=md)
    got = run()
    err = max(max_abs_err(torch, got, want), max_abs_err(
        torch, fe.frontier_fused_masks(*args, max_deg=md), want))
    check(err == 0, f"frontier_fused_masks differs from its plain version: "
                    f"{err}")
    m = len(begins)
    depth_rows = np.asarray(depthv)[rank].astype(np.int64)
    last = paths[np.arange(rows), depth_rows].astype(np.int64)
    valid = last >= 0
    # each valid row's candidate edges: end[last, k - depth - 1] - begin
    # in its own member's index, as the kernel reads them
    cnt = np.zeros(rows, np.int64)
    for j in range(m):
        sel = np.flatnonzero(valid & (rank == j))
        if sel.size:
            k1m = ends[j].shape[1]
            b = min(max(k1m - 2 - int(depthv[j]), 0), k1m - 1)
            v = torch.from_numpy(last[sel]).to(dev)
            cnt[sel] = (ends[j][v, b] - begins[j][v]).cpu().numpy()
    edges = int(cnt.sum())
    check(edges == int(got[3][:, 0].sum()),
          f"K5 edge count {edges} vs its counters {int(got[3][:, 0].sum())}")
    # bytes the kernel must move: each valid row's prefix up to its own
    # depth and its begin/end gathers, one int32 of each other row (the
    # PAD rows'), the rank tags, one dst read per candidate edge, three
    # int32 outputs per slot, the member table, t, depth and counters
    nbytes = (int(((depth_rows[valid] + 1) * 4 + 8).sum())
              + int((C - valid.sum()) * 4) + C * 4 + edges * 4
              + 3 * C * md * 4 + m * (5 * 8 + 8) + m * 16)
    # per candidate edge: one compare per prefix entry, plus the range,
    # emit, continue and clip tests
    n_ops = int((cnt * (depth_rows + 4)).sum())
    b_ms, b_by = bound(nbytes, n_ops)
    row = dict(bound_ops=n_ops,
        max_abs_err=err, ms=time_ms(torch, run, 50),
        device_ms=device_ms(torch, run, 50),
        list_entry_ms=time_ms(torch, lambda: fe.frontier_fused_masks(
            *args, max_deg=md), 50),
        plain_ms=time_ms(torch, lambda: fe.frontier_fused_masks_plain(
            *args, max_deg=md), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=dict(rows=C, real_rows=rows, members=m, k1=k1, max_deg=md,
                   edges=edges, valid_rows=int(valid.sum())))
    emit({"phase": "kernel", "name": "frontier_fused_masks", **row})
    return row


def fused_hop_kernel_row(torch, np, fe, ops, largest, dev, masks_row):
    """K5's hop entry against its plain version at the fused leg's largest
    dispatch, on the rows unpadded, as the fused expand hands them to the
    card: ``ms`` and ``device_ms`` time the entry on rows and a member
    table already on the card; ``dispatch_ms`` the whole
    ``ops.frontier_expand_fused`` (the copy in and the hop), drained after
    each call, with its device operations (at most 5) and the card's busy
    time per dispatch from the profiler.  The bound counts the masks
    line's inputs (``masks_row``'s edges) and each child row written
    once."""
    paths, rank, tvec, depthv, begins, ends, dsts = largest["args"]
    rank = np.asarray(rank, np.int32)
    rows, k1 = paths.shape
    m = len(begins)
    md = 1 << max(largest["max_deg"] - 1, 0).bit_length()
    wantc = np.asarray(largest["wantc"], bool)
    p, rk, tv, dv, wc = (torch.from_numpy(np.ascontiguousarray(x, np.int32))
                         .to(dev) for x in (paths, rank, tvec, depthv,
                                            wantc))
    table = torch.from_numpy(fe.fused_member_table(
        begins, ends, dsts, k1max=k1, device=dev)).to(dev)

    def run():
        return fe.frontier_fused_hop(p, rk, tv, dv, wc, table, max_deg=md)

    def dispatch():
        return ops.frontier_expand_fused(
            paths, rank, tvec, depthv, begins, ends, dsts, wantc,
            max_deg=largest["max_deg"], member_table=largest["member_table"])
    got = run()
    want = fe.frontier_fused_hop_plain(p, rk, tv, dv, wc, begins, ends, dsts,
                                       max_deg=md)
    head = want[2]
    ne, nc = int(head[:m].sum()), int(head[m:2 * m].sum())
    out = dispatch()
    err = max(max_abs_err(torch, [got[2], got[0][:ne], got[1][:nc]],
                          [head, want[0][:ne], want[1][:nc]]),
              max_abs_err(torch, [out[2].as_strided((6 * m,), (1,)),
                                  out[0][:ne], out[1][:nc]],
                          [head, want[0][:ne], want[1][:nc]]))
    check(err == 0, f"frontier_fused_hop differs from its plain version: "
                    f"{err}")
    edges = masks_row["shape"]["edges"]
    check(edges == int(head[2 * m:].view(m, 4)[:, 0].sum()),
          "K5's hop and masks count different edges")
    depth_rows = np.asarray(depthv)[rank].astype(np.int64)
    valid = paths[np.arange(rows), depth_rows] >= 0
    # each valid row's prefix to its depth and its begin/end gathers, one
    # int32 of each other row, the rank tags, one dst read per candidate
    # edge, the member table, t, depth and wantc, the head, and each child
    # row written once
    nbytes = (int(((depth_rows[valid] + 1) * 4 + 8).sum())
              + int((rows - valid.sum()) * 4) + rows * 4 + edges * 4
              + m * (5 * 8 + 12) + 24 * m + (ne + nc) * k1 * 4)
    cnt_ops = masks_row["bound_ops"]
    b_ms, b_by = bound(nbytes, cnt_ops)
    n_ops, busy = device_ops(torch, dispatch, 20)
    check(n_ops <= 5, f"a fused dispatch makes {n_ops} device operations")
    row = dict(
        max_abs_err=err, ms=time_ms(torch, run, 50),
        device_ms=device_ms(torch, run, 50),
        dispatch_ms=dispatch_ms(torch, dispatch, 50),
        device_ops=n_ops, device_busy_us=busy,
        plain_ms=time_ms(torch, lambda: fe.frontier_fused_hop_plain(
            p, rk, tv, dv, wc, begins, ends, dsts, max_deg=md), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=dict(rows=rows, members=m, k1=k1, max_deg=md, edges=edges,
                   n_emit=ne, n_cont=nc, valid_rows=int(valid.sum()),
                   last_hop_members=int((~wantc).sum())))
    emit({"phase": "kernel", "name": "frontier_fused_hop", **row})
    return row


def check_batch(tc, batch_runs, index_of, dev):
    """Every batch item against a solo host run of the same index: count,
    paths and order, stats and exhausted; plans against the host plan."""
    for leg, kw, out, _k5 in batch_runs:
        for item in out.items:
            idx = index_of[(item.s, item.t)]
            tag = f"batch {leg} {item.s}->{item.t}"
            plan = tc.plan_query(idx, tau=TAU, backend="host")
            check((item.plan.method, item.plan.cut, item.plan.preliminary)
                  == (plan.method, plan.cut, plan.preliminary),
                  f"{tag}: plan differs")
            if plan.method == "dfs":
                host = tc.enumerate_paths_idx(idx, chunk_size=CHUNK,
                                              backend="host", device=dev,
                                              **kw)
            else:
                host = tc.enumerate_paths_join(idx, cut=plan.cut,
                                               max_partials=20_000_000, **kw)
            r = item.result
            check(r.count == host.count, f"{tag}: count {r.count} vs "
                                         f"{host.count}")
            check(r.stats == host.stats, f"{tag}: stats {r.stats} vs "
                                         f"{host.stats}")
            check(r.as_tuples() == host.as_tuples(), f"{tag}: paths differ")
            check(r.exhausted == host.exhausted, f"{tag}: exhausted differs")
        if leg == "fused":
            check(all(i.fused for i in out.items),
                  f"batch {leg}: an item did not run fused")


def check_phase(np, tc, large_runs, small_runs, g_small, dev):
    """Main-path results against the host backend and the oracle."""
    for s, t, leg, kw, out, rounds in large_runs:
        idx = out.index
        host = tc.enumerate_paths_idx(idx, chunk_size=CHUNK, backend="host",
                                      device=dev, **kw)
        r = out.result
        tag = f"large {s}->{t} {leg}"
        check(r.count == host.count, f"{tag}: count {r.count} vs "
                                     f"{host.count}")
        check(r.stats == host.stats, f"{tag}: stats {r.stats} vs "
                                     f"{host.stats}")
        check(r.as_tuples() == host.as_tuples(), f"{tag}: paths differ")
        check(r.exhausted == host.exhausted, f"{tag}: exhausted differs")
        plan = tc.plan_query(idx, tau=TAU, backend="host")
        check((out.plan.method, out.plan.cut, out.plan.preliminary)
              == (plan.method, plan.cut, plan.preliminary),
              f"{tag}: plan differs")
        if "first_n" not in kw:
            check(rounds > 0, f"{tag}: the resident deque never ran")
        if r.paths.shape[0]:
            check(bool((r.paths[:, 0] == s).all()
                       and (r.paths[np.arange(r.paths.shape[0]),
                                    r.lengths] == t).all()),
                  f"{tag}: a path does not run from s to t")
    for s, t, k, mode, tau, out in small_runs:
        tag = f"small {s}->{t} k={k} {mode}"
        host = tc.PathEnum(tau=tau, backend="host", device=dev).query(
            g_small, s, t, k, mode=mode)
        a, b = out.result, host.result
        check(a.count == b.count and a.stats == b.stats
              and a.as_tuples() == b.as_tuples(), f"{tag}: results differ")
        pa, pb = out.plan, host.plan
        check((pa.method, pa.cut, pa.t_dfs, pa.t_join)
              == (pb.method, pb.cut, pb.t_dfs, pb.t_join),
              f"{tag}: plans differ")
        if mode == "auto":
            check(pa.dp is not None and pa.dp.backend_used == "device",
                  f"{tag}: the device DP did not produce the plan")
            for f in ("c_to", "c_from", "q_prefix", "q_suffix"):
                check(np.array_equal(getattr(pa.dp, f), getattr(pb.dp, f)),
                      f"{tag}: DP table {f} differs from the host DP")
            check(bool(np.isfinite(pa.dp.c_to).all()),
                  f"{tag}: non-finite DP values")
        if k == 4:
            want = tc.oracle.enumerate_paths(g_small, s, t, k)
            check(sorted(a.as_tuples()) == want,
                  f"{tag}: paths differ from the oracle")


# ---------------------------------------------------------------------------
# the HcPE serving front-ends (HcPEServer, AsyncHcPEServer, GraphRegistry)
# ---------------------------------------------------------------------------

SERVE_KERNELS = ("frontier_fused_masks", "frontier_deque_round",
                 "frontier_hop")


def record_engine_runs(eng):
    """Wrap the engine's ``run`` (both servers call ``engine.run``) so
    every ``BatchOutput`` is kept for its timing split; returns the list
    and a function that unwraps it."""
    outputs = []
    orig = eng.run

    def run(*args, **kw):
        out = orig(*args, **kw)
        outputs.append(out)
        return out

    eng.run = run

    def restore():
        del eng.run
    return outputs, restore


def tenant_index_bytes(eng, graph_id):
    """Device bytes of the index arrays the engine's cache holds for one
    tenant, read without touching the LRU order or the counters."""
    return sum(idx.__dict__["_device_arrays"].memory_bytes()
               for key, idx in eng.cache._entries.items()
               if key[0] == graph_id and "_device_arrays" in idx.__dict__)


def percentiles(np, values):
    v = np.asarray(values, np.float64)
    return {f"p{q}_ms": float(np.percentile(v, q)) if v.size else 0.0
            for q in (50, 90, 99)}


def serve_line(np, kernels, eng, leg, outputs, launches0, extra):
    """One ``serve`` line: the engine's time split over the leg's runs,
    the cache, the tenants' index device bytes and the leg's launches."""
    now = kernels.launch_counts()
    emit({"phase": "serve", "leg": leg,
          "engine_runs": len(outputs),
          "distance_s": sum(o.timing.distance_seconds for o in outputs),
          "index_s": sum(o.timing.index_seconds for o in outputs),
          "optimize_s": sum(o.timing.optimize_seconds for o in outputs),
          "enumerate_s": sum(o.timing.enumerate_seconds for o in outputs),
          "fused_queries": sum(o.fused_queries for o in outputs),
          "index_device_bytes": {gid: tenant_index_bytes(eng, gid)
                                 for gid in ("social", "small")},
          "launches": {n: now[n] - launches0[n] for n in now}, **extra})
    outputs.clear()
    return now


def response_key(r):
    return (r.graph_id, r.s, r.t, r.k, r.count_only, r.first_n)


def serve_requests(np, serving, picks, g_small, seed):
    """The sync leg's requests: the picks at k = 8 counting; the first 8
    again with ``first_n=1000`` and their paths; 8 in-batch duplicates;
    8 queries at k = 4 on the small tenant."""
    Q = serving.PathQueryRequest
    rng = np.random.default_rng(seed + 18)
    reqs = [Q(uid=0, s=s, t=t, k=K_LARGE, graph_id="social")
            for s, t, _ in picks[:16]]
    reqs += [Q(uid=0, s=s, t=t, k=K_LARGE, graph_id="social",
               count_only=False, first_n=1000) for s, t, _ in picks[:8]]
    reqs += [Q(uid=0, s=s, t=t, k=K_LARGE, graph_id="social")
             for s, t, _ in picks[:8]]
    while len(reqs) < 40:
        s, t = (int(x) for x in rng.choice(g_small.n, 2, replace=False))
        reqs.append(Q(uid=0, s=s, t=t, k=4, graph_id="small"))
    for uid, r in enumerate(reqs):
        r.uid = uid
    return reqs


def serve_phase(torch, np, tc, kernels, serving, g, g_small, picks, full,
                lone_paths, dev, seed):
    """The HcPE front-ends on the card: one engine behind an
    ``HcPEServer`` and two ``AsyncHcPEServer``s, two tenants in one
    ``GraphRegistry``; legs ``sync``, ``sync_warm``, ``async``,
    ``deadline``, ``mutate`` and ``metrics``.  ``full`` maps each pick's
    (s, t) to its full result (the batch phase's, checked against the
    host backend); ``lone_paths`` is the large phase's full walk of the
    first pick."""
    import asyncio
    import gc

    reg = serving.GraphRegistry()
    reg.register("social", g)
    reg.register("small", g_small)
    eng = tc.BatchPathEnum(tau=TAU, chunk_size=CHUNK, backend="device",
                           device=dev)
    sync = serving.HcPEServer(reg, eng)
    outputs, restore = record_engine_runs(eng)
    t_phase = time.perf_counter()
    try:
        launches = kernels.launch_counts()

        # sync: one serve of 40 requests, then the same list warm
        reqs = serve_requests(np, serving, picks, g_small, seed)
        small_host = tc.PathEnum(tau=TAU, backend="host", device=dev)
        answers = {}
        for leg in ("sync", "sync_warm"):
            t0 = time.perf_counter()
            resps, rep = sync.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(all(r.status == serving.STATUS_OK for r in resps),
                  f"serve {leg}: a request was not served")
            for q, r in zip(reqs, resps):
                key = response_key(q)
                if q.graph_id == "social":
                    want = full[(q.s, q.t)]
                    n_want = (want.count if q.first_n is None
                              else min(want.count, q.first_n))
                else:
                    n_want = small_host.count(g_small, q.s, q.t, q.k)
                check(r.count == n_want, f"serve {leg} {key}: count "
                                         f"{r.count} vs {n_want}")
                if key in answers:
                    a = answers[key]
                    check(r.count == a.count and (
                        (r.paths is None and a.paths is None)
                        or np.array_equal(r.paths, a.paths)),
                        f"serve {leg} {key}: answer differs from the "
                        f"first one")
                answers.setdefault(key, r)
                if r.paths is not None and r.count:
                    check(bool((r.paths[:, 0] == q.s).all()),
                          f"serve {leg} {key}: a path does not start at s")
            if leg == "sync_warm":
                check(all(r.index_cached for q, r in zip(reqs, resps)
                          if q.graph_id == "social"),
                      "serve sync_warm: a social response missed the cache")
                check(rep.cache.misses == 0,
                      f"serve sync_warm: cache {rep.cache}")
            launches = serve_line(np, kernels, eng, leg, outputs, launches, {
                "requests": len(reqs), "distinct": rep.distinct_queries,
                "wall_s": wall, "queries_per_s": len(reqs) / wall,
                "p50_ms": rep.p50_ms, "p90_ms": rep.p90_ms,
                "p99_ms": rep.p99_ms,
                "cache_hits": rep.cache.hits,
                "cache_misses": rep.cache.misses,
                "tenant_cache": {k: vars(v) for k, v in
                                 rep.tenant_cache.items()},
                "deduplicated": sum(r.deduplicated for r in resps),
                "sharing_groups": rep.sharing_groups,
                "results": rep.total_results})

        # async: a seeded burst of 64 over the same keys, then two lone
        # submits on the first pick (a full walk on K2, first_n on K1)
        rng = np.random.default_rng(seed + 1800)
        Q = serving.PathQueryRequest
        burst = []
        for uid in range(64):
            j = int(rng.integers(0, 16))
            s, t, _ = picks[j]
            opts = ({"count_only": False, "first_n": 1000}
                    if j < 8 and rng.integers(0, 2) else {})
            burst.append(Q(uid=uid, s=s, t=t, k=K_LARGE, graph_id="social",
                           deadline_ms=[50.0, 200.0, 1000.0, None][
                               int(rng.integers(0, 4))], **opts))
        s0, t0_, _ = picks[0]
        lone = [Q(uid=100, s=s0, t=t0_, k=K_LARGE, graph_id="social",
                  count_only=False),
                Q(uid=101, s=s0, t=t0_, k=K_LARGE, graph_id="social",
                  count_only=False, first_n=1000)]
        asrv = serving.AsyncHcPEServer(reg, eng, batch_window_ms=2.0,
                                       enforce_deadlines=False)

        async def drive_async():
            async with asrv:
                got = await asrv.serve(burst)
                return got, [await asrv.submit(r) for r in lone]
        t0 = time.perf_counter()
        got, lone_got = asyncio.run(drive_async())
        wall = time.perf_counter() - t0
        for q, r in zip(burst, got):
            a = answers[response_key(q)]
            check(r.status == serving.STATUS_OK and r.count == a.count
                  and ((r.paths is None and a.paths is None)
                       or np.array_equal(r.paths, a.paths)),
                  f"serve async uid {q.uid}: differs from the sync leg")
        full_walk, first_n = lone_got
        check(full_walk.count == lone_paths.count
              and full_walk.paths.shape[0] == full_walk.count
              and sorted(map(tuple, full_walk.paths.tolist()))
              == sorted(map(tuple, lone_paths.paths.tolist())),
              "serve async: the lone full walk differs from the large "
              "phase's")
        a = answers[response_key(lone[1])]
        check(first_n.count == a.count and np.array_equal(first_n.paths,
                                                           a.paths),
              "serve async: the lone first_n walk differs from the sync "
              "leg's")
        stats = asrv.stats
        graded = [r for r in got if r.slo_met is not None]
        launches = serve_line(np, kernels, eng, "async", outputs, launches, {
            "requests": len(burst) + len(lone), "wall_s": wall,
            "queries_per_s": (len(burst) + len(lone)) / wall,
            **percentiles(np, [r.total_ms for r in got]),
            "queue_ms_mean": stats.queue_ms_total / stats.completed,
            "service_ms_mean": stats.service_ms_total / stats.completed,
            "total_ms_mean": stats.total_ms_total / stats.completed,
            "micro_batches": stats.micro_batches,
            "slo_met_share": sum(r.slo_met for r in graded) / len(graded),
            "lone_total_ms": [r.total_ms for r in lone_got],
            "cache_hits": eng.cache.stats.hits,
            "cache_misses": eng.cache.stats.misses})

        # deadline: enforced deadlines of 0 ms stop before the first chunk
        dsrv = serving.AsyncHcPEServer(reg, eng, batch_window_ms=2.0,
                                       enforce_deadlines=True)
        dl_reqs = [Q(uid=200 + i, s=s, t=t, k=K_LARGE, graph_id="social",
                     count_only=False, deadline_ms=0.0)
                   for i, (s, t, _) in enumerate(picks[:4])]

        async def drive_deadline():
            async with dsrv:
                return await dsrv.serve(dl_reqs)
        t0 = time.perf_counter()
        dl_got = asyncio.run(drive_deadline())
        wall = time.perf_counter() - t0
        for q, r in zip(dl_reqs, dl_got):
            want = set(full[(q.s, q.t)].as_tuples())
            got_paths = {tuple(int(v) for v in row if v >= 0)
                         for row in r.paths}
            check(r.status == serving.STATUS_OK and not r.exhausted
                  and r.slo_met is False and got_paths <= want
                  and r.paths.shape[0] == r.count,
                  f"serve deadline uid {q.uid}: {r.count} paths, "
                  f"exhausted {r.exhausted}, slo_met {r.slo_met}")
        launches = serve_line(np, kernels, eng, "deadline", outputs,
                              launches, {
                                  "requests": len(dl_reqs), "wall_s": wall,
                                  "counts": [r.count for r in dl_got],
                                  **percentiles(np, [r.total_ms
                                                     for r in dl_got])})

        # mutate: drop an edge of the first pick's paths, add 64 random
        # edges; re-serve 8 picks against a host run on the new version
        first = lone_paths.paths[0]
        removed = (int(first[0]), int(first[1]))
        mrng = np.random.default_rng(seed + 18000)
        added = mrng.integers(0, g.n, (64, 2))
        added = added[(added[:, 0] != removed[0]) | (added[:, 1] != removed[1])]
        mem, mutate_s = [], []
        t0 = time.perf_counter()
        reg.mutate("social", remove=np.array([removed]), add=added)
        mutate_s.append(time.perf_counter() - t0)
        gc.collect()
        mem.append(torch.cuda.memory_allocated(dev))
        snap = sync.metrics_snapshot()
        check(snap.tenants["social"].graph_version == 1
              and eng.cache.tenant_len("social") == 0
              and tenant_index_bytes(eng, "social") == 0,
              f"serve mutate: version {snap.tenants['social'].graph_version}"
              f", {eng.cache.tenant_len('social')} entries left")
        m_reqs = [Q(uid=300 + i, s=s, t=t, k=K_LARGE, graph_id="social",
                    count_only=False) for i, (s, t, _) in
                  enumerate(picks[:8])]
        t0 = time.perf_counter()
        m_got, m_rep = sync.serve(m_reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g1 = reg.get("social")
        host_stats = tc.EnumStats()
        t1 = time.perf_counter()
        dists = tc.batched_index_distances(
            g1, [(q.s, q.t, K_LARGE) for q in m_reqs], device=dev)
        for q, r, d in zip(m_reqs, m_got, dists):
            idx = tc.build_index(g1, q.s, q.t, K_LARGE,
                                 dist_fn=lambda *_a, _d=d: _d, device=dev)
            plan = tc.plan_query(idx, tau=TAU, backend="host")
            if plan.method == "dfs":
                host = tc.enumerate_paths_idx(idx, chunk_size=CHUNK,
                                              backend="host", device=dev)
            else:
                host = tc.enumerate_paths_join(idx, cut=plan.cut,
                                               max_partials=20_000_000)
            host_stats.merge(host.stats)
            tag = f"serve mutate {q.s}->{q.t}"
            check(not r.index_cached, f"{tag}: served off a stale index")
            check(r.count == host.count and np.array_equal(r.paths,
                                                           host.paths),
                  f"{tag}: count {r.count} vs the host's {host.count}, or "
                  f"paths differ")
            hops = {(int(a), int(b)) for row in r.paths
                    for a, b in zip(row[:-1], row[1:]) if b >= 0}
            check(removed not in hops, f"{tag}: a path uses the removed "
                                       f"edge {removed}")
        host_s = time.perf_counter() - t1
        check(m_rep.enum_stats == host_stats,
              f"serve mutate: stats {m_rep.enum_stats} vs {host_stats}")
        del g1, idx, host, dists
        t0 = time.perf_counter()
        reg.mutate("social", add=mrng.integers(0, g.n, (64, 2)))
        mutate_s.append(time.perf_counter() - t0)
        gc.collect()
        mem.append(torch.cuda.memory_allocated(dev))
        graph_bytes = g.to(dev).memory_bytes()
        check(mem[1] - mem[0] <= 0.1 * graph_bytes,
              f"serve mutate: {mem[1] - mem[0]} more bytes on the card "
              f"after the second mutation (one graph copy: {graph_bytes})")
        launches = serve_line(np, kernels, eng, "mutate", outputs, launches, {
            "requests": len(m_reqs), "wall_s": wall,
            "queries_per_s": len(m_reqs) / wall,
            "p50_ms": m_rep.p50_ms, "p90_ms": m_rep.p90_ms,
            "p99_ms": m_rep.p99_ms, "mutate_s": mutate_s,
            "removed_edge": removed,
            "cache_hits": m_rep.cache.hits,
            "cache_misses": m_rep.cache.misses,
            "host_check_s": host_s,
            "memory_allocated_after_mutation": mem,
            "graph_device_bytes": graph_bytes,
            "counts": [r.count for r in m_got]})
    finally:
        restore()

    # metrics: both servers' snapshots hold their counter identities
    snaps = {"sync": sync.metrics_snapshot(), "async": asrv.metrics_snapshot(),
             "deadline": dsrv.metrics_snapshot()}
    for name, snap in snaps.items():
        check(snap.violations() == [],
              f"serve metrics {name}: {snap.violations()}")
    emit({"phase": "serve", "leg": "metrics",
          "hit_rate": {gid: tm.cache.hit_rate for gid, tm in
                       snaps["sync"].tenants.items()},
          "graph_version": {gid: tm.graph_version for gid, tm in
                            snaps["sync"].tenants.items()},
          "prometheus_lines": {name: len(s.to_prometheus().splitlines())
                               for name, s in snaps.items()},
          "async_stats": {k: v for k, v in vars(snaps["async"].serve).items()
                          if not k.endswith("_ms_total")},
          "seconds": time.perf_counter() - t_phase})
    return kernels.launch_counts()


# ---------------------------------------------------------------------------
# ranked (any-k), constrained and baseline enumeration
# ---------------------------------------------------------------------------

def bucket_counter(en):
    """Count the hop buckets `_drive_ranked_buckets` drains (each drained
    bucket is one ``heappop`` of its key heap); returns the record and a
    function that unwraps it."""
    import heapq
    import types
    seen = {"buckets": 0}

    def heappop(heap):
        seen["buckets"] += 1
        return heapq.heappop(heap)
    orig = en.heapq
    en.heapq = types.SimpleNamespace(heappop=heappop,
                                     heappush=heapq.heappush)

    def restore():
        en.heapq = orig
    return seen, restore


def same_rows(np, a, b) -> bool:
    """Two results hold the same rows in the same order."""
    return (a.count == b.count and a.paths.shape == b.paths.shape
            and bool(np.array_equal(a.paths, b.paths))
            and bool(np.array_equal(a.lengths, b.lengths)))


def edge_ids(np, g):
    """(u, v) arrays -> graph edge ids, from the graph's own sorted edge
    keys (independent of any index)."""
    keys = g.esrc.astype(np.int64) * g.n + g.edst.astype(np.int64)
    check(bool((np.diff(keys) > 0).all()), "graph edge keys are not sorted")

    def look(u, v):
        q = u.astype(np.int64) * g.n + v.astype(np.int64)
        pos = np.searchsorted(keys, q)
        check(bool((keys[np.minimum(pos, keys.size - 1)] == q).all()),
              "a path uses an edge the graph does not have")
        return pos
    return look


def accumulate(np, look, result, values, op, init):
    """Each row's edge values folded left to right with ``op`` (the order
    tests/test_constraints.py's post-filter sums in)."""
    acc = np.full(result.paths.shape[0], init, dtype=values.dtype)
    for j in range(result.paths.shape[1] - 1):
        act = result.lengths > j
        if not act.any():
            break
        eid = look(result.paths[act, j], result.paths[act, j + 1])
        acc[act] = op(acc[act], values[eid])
    return acc


def dfa_accepts(np, look, result, labels, A, accepting, start=0):
    """Whether the DFA ``A`` accepts each row's edge labels."""
    st = np.full(result.paths.shape[0], start, dtype=np.int64)
    for j in range(result.paths.shape[1] - 1):
        act = (result.lengths > j) & (st >= 0)
        if not act.any():
            break
        eid = look(result.paths[act, j], result.paths[act, j + 1])
        st[act] = A[st[act], labels[eid]]
    ok = st >= 0
    out = np.zeros(st.shape[0], dtype=bool)
    out[ok] = accepting[st[ok]]
    return out


def ranked_phase(torch, np, tc, en, kernels, serving, g, g_small, picks,
                 queries, full, lone, dev, seed):
    """Ranked (any-k), constrained and baseline enumeration through the
    entry points on the card: legs ``ranked_hops``, ``ranked_weight``,
    ``ranked_join``, ``constrained``, ``serve_ranked`` and ``baseline``,
    one line each with its launches and the backend each leg resolved
    to.  ``full`` maps each pick's (s, t) to its unranked exhausted
    result (the batch phase's, checked against the host backend);
    ``lone`` is the large phase's full walk of the first pick."""
    import asyncio
    fe = kernels.frontier_expand
    pe = tc.PathEnum(tau=TAU, chunk_size=CHUNK, backend="device",
                     use_device_index=True, device=dev)
    w_large = np.random.default_rng(seed + 1900).random(g.m)
    t_phase = time.perf_counter()
    launches = kernels.launch_counts()
    solo = {}      # (s, t, order, first_n) -> the PathEnum result

    def line(leg, extra):
        nonlocal launches
        now = kernels.launch_counts()
        emit({"phase": "ranked", "leg": leg, **extra,
              "launches": {n: now[n] - launches[n] for n in
                           PATHENUM_KERNELS}})
        launches = now

    # ranked_hops: the bucketed driver on K1's hop entry
    for s, t, _idx in queries:
        for first_n in (None, RANKED_FIRST_N):
            seen, restore = bucket_counter(en)
            hops0 = fe.hop_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = pe.query(g, s, t, K_LARGE, count_only=False,
                               order="hops", first_n=first_n)
            finally:
                restore()
            wall = time.perf_counter() - t0
            r = out.result
            solo[(s, t, "hops", first_n)] = r
            tag = f"ranked_hops {s}->{t} first_n={first_n}"
            if first_n is None:
                heap = tc.enumerate_paths_idx(out.index, order="hops",
                                              backend="host", device=dev)
                check(same_rows(np, r, heap) and r.exhausted,
                      f"{tag}: differs from the host heap")
                check(same_rows(np, r, full[(s, t)]),
                      f"{tag}: differs from the unranked exhausted walk")
                if (s, t) == queries[0][:2]:
                    check(same_rows(np, r, lone),
                          f"{tag}: differs from the large phase's walk")
            else:
                whole = solo[(s, t, "hops", None)]
                n = min(first_n, whole.count)
                check(r.count == n and bool(np.array_equal(
                    r.paths, whole.paths[:n])),
                      f"{tag}: not the first {first_n} rows of the full run")
                check(r.exhausted == (whole.count < max(first_n, 1)),
                      f"{tag}: exhausted {r.exhausted}")
            line("ranked_hops", {
                "s": s, "t": t, "k": K_LARGE, "first_n": first_n,
                "backend": en.resolve_backend(out.index, "device",
                                              order="hops"),
                "count": r.count, "exhausted": r.exhausted,
                "stats": vars(r.stats), "buckets": seen["buckets"],
                "k1_hop_launches": fe.hop_launches - hops0,
                "wall_s": wall, "index_s": out.timing.index_seconds,
                "plan_s": out.timing.optimize_seconds,
                "enum_s": out.timing.enumerate_seconds})

    # ranked_weight: device index, host heap
    for s, t, _idx in queries:
        for first_n in (None, RANKED_FIRST_N):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pe.query(g, s, t, K_LARGE, count_only=False,
                           order="weight", weights=w_large, first_n=first_n)
            wall = time.perf_counter() - t0
            r = out.result
            solo[(s, t, "weight", first_n)] = r
            tag = f"ranked_weight {s}->{t} first_n={first_n}"
            spec = tc.make_rank_spec("weight", w_large)
            costs = tc.rank.path_costs(out.index, r.paths, r.lengths, spec)
            check(costs.dtype == np.float64, f"{tag}: costs {costs.dtype}")
            if first_n is None:
                un = full[(s, t)]
                perm = tc.rank.canonical_perm(un.paths, tc.rank.path_costs(
                    out.index, un.paths, un.lengths, spec))
                check(r.exhausted and r.count == un.count and bool(
                    np.array_equal(r.paths, un.paths[perm])),
                      f"{tag}: differs from the unranked paths re-sorted "
                      f"by cost")
            else:
                whole = solo[(s, t, "weight", None)]
                n = min(first_n, whole.count)
                check(r.count == n and bool(np.array_equal(
                    r.paths, whole.paths[:n])),
                      f"{tag}: not the first {first_n} rows of the full run")
            check(bool((np.diff(costs) >= 0).all()),
                  f"{tag}: costs decrease")
            line("ranked_weight", {
                "s": s, "t": t, "k": K_LARGE, "first_n": first_n,
                "backend": en.resolve_backend(out.index, "device",
                                              order="weight"),
                "count": r.count, "exhausted": r.exhausted,
                "stats": vars(r.stats),
                "cost_min": float(costs[0]) if costs.size else None,
                "cost_max": float(costs[-1]) if costs.size else None,
                "wall_s": wall, "index_s": out.timing.index_seconds,
                "enum_s": out.timing.enumerate_seconds})

    # ranked_join: the small graph, both orders, join and dfs plans
    w_small = np.random.default_rng(seed + 1901).integers(
        0, 4, size=g_small.m).astype(np.float64)
    rng = np.random.default_rng(3)
    small_qs = [(1104, 997, 4)]
    while len(small_qs) < 3:
        s, t = (int(x) for x in rng.choice(g_small.n, 2, replace=False))
        if tc.build_index(g_small, s, t, 5, device=dev).num_index_edges \
                >= 64:
            small_qs.append((s, t, 5))
    spe = tc.PathEnum(tau=TAU, backend="device", device=dev)
    t0 = time.perf_counter()
    rows = []
    for s, t, k in small_qs:
        for order in ("hops", "weight"):
            weights = w_small if order == "weight" else None
            want = tc.oracle.enumerate_paths(g_small, s, t, k, order=order,
                                             weights=weights)
            for mode in ("join", "dfs"):
                out = spe.query(g_small, s, t, k, mode=mode, order=order,
                                weights=weights)
                check(out.result.as_tuples() == want,
                      f"ranked_join {s}->{t} {order} {mode}: differs from "
                      f"the oracle")
                rows.append({"s": s, "t": t, "k": k, "order": order,
                             "mode": mode, "plan": out.plan.method,
                             "cut": out.plan.cut,
                             "backend": "host" if mode == "join" else
                             en.resolve_backend(out.index, "device",
                                                order=order),
                             "count": out.result.count,
                             "enum_s": out.timing.enumerate_seconds})
    line("ranked_join", {"queries": rows,
                         "wall_s": time.perf_counter() - t0})

    # constrained: Appendix E on the large graph's queries, an edge mask
    # on the small graph
    crng = np.random.default_rng(seed + 1902)
    values = crng.uniform(0.0, 10.0, size=g.m)
    labels = crng.integers(0, 2, size=g.m)
    A = np.array([[0, 1], [-1, 1]])                 # label words 0*1*
    accepting = np.array([True, True])
    look = edge_ids(np, g)
    rows = []
    t_leg = time.perf_counter()
    for s, t, _idx in queries:
        un = full[(s, t)]
        beta = accumulate(np, look, un, values, np.add, 0.0)
        thresh = float(np.median(beta)) if beta.size else 0.0
        cases = [
            ("accumulate_at_least", tc.constraints.AccumulativeValue(
                values, accept=lambda b, th=thresh: b >= th),
             beta >= thresh),
            ("accumulate_monotone", tc.constraints.AccumulativeValue(
                values, accept=lambda b, th=thresh: b <= th,
                monotone_upper=thresh), beta <= thresh),
            ("action_sequence", tc.constraints.ActionSequence(
                A, labels, 0, accepting),
             dfa_accepts(np, look, un, labels, A, accepting)),
        ]
        for name, cons, keep in cases:
            t0 = time.perf_counter()
            out = pe.query(g, s, t, K_LARGE, count_only=False,
                           constraint=cons)
            wall = time.perf_counter() - t0
            r = out.result
            want = un.paths[keep]
            check(r.exhausted and r.count == want.shape[0] and bool(
                np.array_equal(r.paths, want)),
                  f"constrained {s}->{t} {name}: {r.count} paths vs the "
                  f"post-filtered {want.shape[0]}")
            rows.append({"s": s, "t": t, "constraint": name,
                         "backend": en.resolve_backend(
                             out.index, "device", cons),
                         "plan": out.plan.method, "count": r.count,
                         "unconstrained": un.count,
                         "edges_accessed": r.stats.edges_accessed,
                         "unconstrained_edges_accessed":
                             un.stats.edges_accessed,
                         "wall_s": wall,
                         "enum_s": out.timing.enumerate_seconds})
    mask = tc.constraints.edge_predicate_mask(
        g_small, lambda u, v: (u + v) % 3 != 0)
    for s, t, k in small_qs:
        want = tc.oracle.enumerate_paths(
            g_small, s, t, k, edge_pred=lambda a, b: (a + b) % 3 != 0)
        # the unranked full walk on the host: K2 stays out of the phase
        out = spe.query(g_small, s, t, k, mode="dfs", count_only=False,
                        edge_mask=mask, backend="host")
        check(sorted(out.result.as_tuples()) == want,
              f"constrained edge_mask {s}->{t}: differs from the oracle")
        rows.append({"s": s, "t": t, "constraint": "edge_mask",
                     "backend": "host", "count": out.result.count,
                     "enum_s": out.timing.enumerate_seconds})
    line("constrained", {"queries": rows,
                         "wall_s": time.perf_counter() - t_leg})

    # serve_ranked: both front-ends, a weighted tenant and a weightless one
    serve_picks = [(s, t) for s, t, _ in picks[:4]]
    for s, t in serve_picks[len(queries):]:
        for order in ("hops", "weight"):
            for first_n in (None, RANKED_FIRST_N):
                solo[(s, t, order, first_n)] = pe.query(
                    g, s, t, K_LARGE, count_only=False, order=order,
                    weights=w_large if order == "weight" else None,
                    first_n=first_n).result
    reg = serving.GraphRegistry()
    reg.register("social", g, edge_weights=w_large)
    reg.register("small", g_small)
    eng = tc.BatchPathEnum(tau=TAU, chunk_size=CHUNK, backend="device",
                           device=dev)
    Q = serving.PathQueryRequest
    reqs = [Q(uid=0, s=s, t=t, k=K_LARGE, graph_id="social",
              count_only=False, order=order, first_n=first_n)
            for s, t in serve_picks for order in ("hops", "weight")
            for first_n in (None, RANKED_FIRST_N)]
    reqs.append(Q(uid=0, s=small_qs[0][0], t=small_qs[0][1], k=4,
                  graph_id="small", order="weight"))
    for uid, q in enumerate(reqs):
        q.uid = uid

    def check_answers(leg, resps):
        for q, r in zip(reqs, resps):
            if q.graph_id == "small":
                check(r.status == serving.STATUS_REJECTED_NO_WEIGHTS
                      and r.count == 0,
                      f"{leg} uid {q.uid}: {r.status}, not "
                      f"rejected_no_weights")
                continue
            want = solo[(q.s, q.t, q.order, q.first_n)]
            check(r.status == serving.STATUS_OK and r.count == want.count
                  and r.exhausted == want.exhausted
                  and bool(np.array_equal(r.paths, want.paths)),
                  f"{leg} uid {q.uid}: differs from the solo PathEnum "
                  f"result")

    sync = serving.HcPEServer(reg, eng)
    asrv = serving.AsyncHcPEServer(reg, eng, batch_window_ms=2.0)
    outputs, restore = record_engine_runs(eng)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resps, rep = sync.serve(reqs)
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        sync_runs = list(outputs)
        outputs.clear()

        async def drive():
            async with asrv:
                return await asrv.serve(reqs)
        t0 = time.perf_counter()
        aresps = asyncio.run(drive())
        async_s = time.perf_counter() - t0
    finally:
        restore()
    check_answers("serve_ranked sync", resps)
    check_answers("serve_ranked async", aresps)
    stats = asrv.stats
    check(stats.failed == 0 and stats.rejected_no_weights == 1,
          f"serve_ranked async: failed {stats.failed}, rejected_no_weights "
          f"{stats.rejected_no_weights}")
    check(asrv.metrics_snapshot().violations() == [],
          "serve_ranked async: a metrics identity broke")
    line("serve_ranked", {
        "requests": len(reqs),
        "backend": {o: en.resolve_backend(
            queries[0][2], eng.engine.backend, order=o)
            for o in ("hops", "weight")},
        "sync_wall_s": sync_s, "async_wall_s": async_s,
        "sync_engine_runs": len(sync_runs),
        "sync_index_s": sum(o.timing.index_seconds for o in sync_runs),
        "sync_enumerate_s": sum(o.timing.enumerate_seconds
                                for o in sync_runs),
        "async_engine_runs": len(outputs),
        "async_enumerate_s": sum(o.timing.enumerate_seconds
                                 for o in outputs),
        "sync_p50_ms": rep.p50_ms, "sync_p99_ms": rep.p99_ms,
        "async_p50_ms": percentiles(np, [r.total_ms for r in aresps
                                         if r.count])["p50_ms"],
        "micro_batches": stats.micro_batches,
        "rejected_no_weights": stats.rejected_no_weights,
        "failed": stats.failed, "cache_hits": eng.cache.stats.hits,
        "cache_misses": eng.cache.stats.misses,
        "statuses": sorted({r.status for r in resps})})

    # baseline: Alg. 1 on the raw graph against the index walk (Fig. 6)
    host_pe = tc.PathEnum(tau=TAU, backend="host", device=dev)
    rows = []
    t_leg = time.perf_counter()
    for s, t, k in small_qs:
        t0 = time.perf_counter()
        base = tc.generic_dfs(g_small, s, t, k)
        base_s = time.perf_counter() - t0
        out = host_pe.query(g_small, s, t, k, mode="dfs")
        check(base.count == out.result.count
              and base.paths == sorted(out.result.as_tuples()),
              f"baseline {s}->{t}: {base.count} paths vs PathEnum's "
              f"{out.result.count}")
        rows.append({"s": s, "t": t, "k": k, "backend": "host",
                     "count": base.count,
                     "baseline_edges_accessed": base.stats.edges_accessed,
                     "index_edges_accessed":
                         out.result.stats.edges_accessed,
                     "baseline_invalid_partials":
                         base.stats.invalid_partials,
                     "index_invalid_partials":
                         out.result.stats.invalid_partials,
                     "baseline_s": base_s,
                     "index_enum_s": out.timing.enumerate_seconds})
    line("baseline", {"queries": rows, "wall_s": time.perf_counter() - t_leg})
    emit({"phase": "ranked", "leg": "done",
          "seconds": time.perf_counter() - t_phase})
    return kernels.launch_counts()


# ---------------------------------------------------------------------------
# the mesh engine (repro_torch.distributed)
# ---------------------------------------------------------------------------

def dp_rel_err(np, got, want) -> float:
    """Largest |got - want| / |want| over entries where either is not 0
    (0 when every entry is equal)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    nz = diff > 0
    return float((diff[nz] / np.abs(want[nz])).max()) if nz.any() else 0.0


def mesh_one(torch, tc, kernels, compat, dist_mod, g, qs, dev):
    """``mesh_1``: a 1 x 1 NCCL mesh in this process; the stats and the
    two ``enumerate_batch`` legs on one default engine.  Returns the
    stats, the two outputs and their walls, and the launches of the whole
    leg (counted from 0 just before it)."""
    import torch.distributed as tdist
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mesh = compat.make_mesh((1, 1), ("data", "model"), device=dev)
    init_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        dpe = dist_mod.DistributedPathEnum(mesh, g, K_LARGE, device=dev)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = dpe.query_batch_stats(qs)
        stats_s = time.perf_counter() - t0
        comm = dpe.comm_counts()
        emit({"phase": "mesh", "leg": "mesh_1_stats", "mesh": [1, 1],
              "backend": dpe.model.backend, "wire": dpe.model.kind,
              "queries": len(qs), "k": K_LARGE, "init_s": init_s,
              "shard_s": shard_s, **dpe.last_timing, "stats_s": stats_s,
              "edge_bytes_per_rank": dpe.edge_bytes(),
              "memory_allocated_before": mem0,
              "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
              **comm})
        engine = tc.BatchPathEnum(device=dev)
        outs, walls = {}, {}
        for leg, kw in MESH_ENUM_LEGS:
            before = kernels.launch_counts()
            comm0 = dpe.comm_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dpe.enumerate_batch(qs, engine=engine, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            now = kernels.launch_counts()
            comm1 = dpe.comm_counts()
            tm = out.timing
            emit({"phase": "mesh", "leg": "mesh_1", "enumerate": leg,
                  "queries": len(qs), "wall_s": wall,
                  **{key: dpe.last_split[key] for key in MESH_SPLIT_KEYS},
                  "gather_calls": comm1["all_gather_calls"]
                  - comm0["all_gather_calls"],
                  "gather_bytes": comm1["all_gather_bytes"]
                  - comm0["all_gather_bytes"],
                  "distance_s": tm.distance_seconds,
                  "index_s": tm.index_seconds,
                  "optimize_s": tm.optimize_seconds,
                  "enumerate_s": tm.enumerate_seconds,
                  "total_s": tm.total_seconds,
                  "queries_per_s": out.throughput_qps,
                  "fused_queries": out.fused_queries,
                  "fused_dispatches": out.fused_dispatches,
                  "cache_hits": out.cache_stats.hits,
                  "cache_misses": out.cache_stats.misses,
                  "results": out.total_results,
                  "max_memory_allocated":
                      torch.cuda.max_memory_allocated(dev),
                  **{f"total_{key}": v for key, v in
                     dpe.comm_counts().items()},
                  "launches": {n: now[n] - before[n] for n in
                               ("frontier_fused_masks",
                                "frontier_deque_round", "frontier_hop")}})
            outs[leg], walls[leg] = out, wall
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        tdist.destroy_process_group()
    return stats, outs, walls, launches, comm


def plain_mesh_dp(torch, np, g, k, ds, dt, dev):
    """``repro``'s mesh walk-count recurrence (every edge, level masks
    from the distances, the (t, t) self-loop) in float64 on the card,
    one sparse product over the graph's CSR per level for all queries:
    a plain version of the same arithmetic, independent of the engine's
    per-edge scatters.  Returns host ``(q_prefix, q_suffix, totals)``."""
    n = g.n

    def csr(indptr, indices):
        return torch.sparse_csr_tensor(
            torch.from_numpy(indptr.astype(np.int64)).to(dev),
            torch.from_numpy(indices.astype(np.int64)).to(dev),
            torch.ones(indices.shape[0], dtype=torch.float64, device=dev),
            size=(n, n), check_invariants=False)
    fwd = csr(g.indptr, g.indices)      # [u, v] = 1 for each edge (u, v)
    rev = csr(g.rindptr, g.rindices)    # [v, u] = 1 for each edge (u, v)
    a = torch.from_numpy(np.ascontiguousarray(ds.T)).to(dev)    # (n, Q)
    b = torch.from_numpy(np.ascontiguousarray(dt.T)).to(dev)
    is_t = (b == 0).double()

    def lvl(i):
        return (a <= i) & (b <= k - i)
    qp = torch.zeros((k + 1, ds.shape[0]), dtype=torch.float64, device=dev)
    qs = torch.zeros_like(qp)
    c = lvl(k).double()
    qs[k] = c.sum(0)
    for i in range(k - 1, -1, -1):
        contrib = fwd @ torch.where(b <= k - i - 1, c, 0.0).contiguous()
        c = torch.where(lvl(i), contrib + is_t * c, 0.0)
        qs[i] = c.sum(0)
    c = lvl(0).double()
    qp[0] = c.sum(0)
    for i in range(1, k + 1):
        contrib = rev @ torch.where(a <= i - 1, c, 0.0).contiguous()
        c = torch.where(lvl(i), contrib + is_t * c, 0.0)
        qp[i] = c.sum(0)
    return (qp.T.cpu().numpy(), qs.T.cpu().numpy(),
            (c * is_t).sum(0).cpu().numpy())


def check_mesh_one(torch, np, tc, est, g, picks, stats, outs, batch_runs,
                   dev):
    """``mesh_1`` against the port's own paths: distances equal to the
    stacked BFS; DP tables within rtol 1e-5 of ``plain_mesh_dp`` (float32
    sums in any order against float64) and, entry by entry, at or above
    each pick's host ``walk_count_dp`` on its index (Alg. 5 on the index
    drops the edges into s and out of t, which ``repro``'s mesh DP keeps,
    so the mesh may count more walks; how many picks differ is
    reported); counts equal to the batch phase's fused leg and the
    ``first_n`` leg's items equal to the batch phase's (all checked there
    against the host backend).  Returns the DP comparisons."""
    qp, qsx, tot, (ds, dt) = stats
    want = tc.batched_index_distances(
        g, [(s, t, K_LARGE) for s, t, _ in picks], device=dev)
    for i, (s, t, idx) in enumerate(picks):
        check(np.array_equal(ds[i], want[i][0])
              and np.array_equal(dt[i], want[i][1]),
              f"mesh_1 {s}->{t}: distances differ from the stacked BFS")
    t0 = time.perf_counter()
    plain = plain_mesh_dp(torch, np, g, K_LARGE, ds, dt, dev)
    plain_s = time.perf_counter() - t0
    errs = {"q_prefix": 0.0, "q_suffix": 0.0, "totals": 0.0}
    for name, got, ref in zip(errs, (qp, qsx, tot), plain):
        e = dp_rel_err(np, got, ref)
        check(e <= 1e-5, f"mesh_1: {name} differs from the plain "
                         f"recurrence by rel {e}")
        errs[name] = e
    differ, excess = 0, 0.0
    for i, (s, t, idx) in enumerate(picks):
        dp = est.walk_count_dp(idx, backend="host", device=dev)
        for name, got, ref in (("q_prefix", qp[i], dp.q_prefix),
                               ("q_suffix", qsx[i], dp.q_suffix),
                               ("totals", tot[i], dp.q_total)):
            check(bool(np.all(np.asarray(got, np.float64)
                              >= np.asarray(ref) * (1 - 1e-5))),
                  f"mesh_1 {s}->{t}: {name} {got} below the index DP's "
                  f"{ref}")
        e = dp_rel_err(np, tot[i], dp.q_total)
        differ += e > 1e-5
        excess = max(excess, e)
    legs = {leg: out for leg, _kw, out, _k5 in batch_runs}
    for got, want in zip(outs["count_only"].items, legs["fused"].items):
        check((got.s, got.t) == (want.s, want.t)
              and got.result.count == want.result.count,
              f"mesh_1 count_only {got.s}->{got.t}: {got.result.count} vs "
              f"the batch phase's {want.result.count}")
    for got, want in zip(outs["first_n"].items, legs["first_n"].items):
        a, b = got.result, want.result
        check((got.s, got.t) == (want.s, want.t) and a.count == b.count
              and a.as_tuples() == b.as_tuples() and a.stats == b.stats
              and a.exhausted == b.exhausted,
              f"mesh_1 first_n {got.s}->{got.t}: differs from the batch "
              f"phase's item")
    check(len(outs["first_n"].items) == len(legs["first_n"].items)
          == len(picks), "mesh_1: item counts differ")
    return {"dp_max_rel_err_vs_plain": errs, "plain_dp_s": plain_s,
            "picks_whose_total_exceeds_the_index_dp": differ,
            "max_rel_excess_over_the_index_dp": excess}


MESH_WORKERS = 2
MESH_WORKER_TIMEOUT = 600.0
# enumerate_batch's legs in mesh_1 and mesh_split2, on one engine a rank
MESH_ENUM_LEGS = (("count_only", dict(count_only=True)),
                  ("first_n", dict(count_only=False, first_n=1000)))
# a rank's share of an enumerate_batch call (DistributedPathEnum.last_split)
MESH_SPLIT_KEYS = ("owned_queries", "owned_keys", "bfs_s", "run_s",
                   "gather_s", "payload_bytes")
PLAN_FIELDS = ("method", "cut", "preliminary", "used_full_estimator",
               "t_dfs", "t_join", "est_results")


def item_summary(item) -> dict:
    """A ``BatchItem`` as plain values: result (count, paths in order,
    lengths, Fig.-6 stats, exhausted), plan fields and the index-cached,
    deduplicated and shared flags (the fused flag is each engine's own)."""
    r = item.result
    return {"key": (item.s, item.t, item.k), "count": int(r.count),
            "exhausted": bool(r.exhausted),
            "stats": dataclasses.asdict(r.stats), "paths": r.as_tuples(),
            "lengths": [int(x) for x in r.lengths],
            "plan": tuple(getattr(item.plan, f) for f in PLAN_FIELDS),
            "flags": (item.index_cached, item.deduplicated, item.shared)}


def output_summary(out) -> dict:
    """A ``BatchOutput``'s items, cache stats and non-fused counters."""
    return {"items": [item_summary(i) for i in out.items],
            "cache_stats": dataclasses.astuple(out.cache_stats),
            "counters": (out.distinct_queries, out.sharing_groups,
                         out.shared_queries)}


def write_mesh_data(np, g, qs, tmp) -> tuple:
    """The graph's arrays, the queries and k in one ``.npz`` the mesh
    workers load; returns the path and the seconds the write took."""
    data = Path(tmp) / "graph.npz"
    t0 = time.perf_counter()
    np.savez(data, n=g.n, indptr=g.indptr, indices=g.indices,
             rindptr=g.rindptr, rindices=g.rindices, esrc=g.esrc,
             edst=g.edst, queries=qs, k=K_LARGE)
    return data, time.perf_counter() - t0


def run_mesh_workers(compat, leg, data, dev, tmp, seed):
    """This script once a rank of a two-process gloo mesh on the one card
    (``--mesh-leg leg``); returns each rank's last JSON line, the path
    pattern of their output files, and the wall of the whole run."""
    init = f"tcp://127.0.0.1:{compat.free_port()}"
    out = str(Path(tmp) / (f"{leg}_rank%d" +
                           (".npz" if leg == "gloo2" else ".pkl")))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r),
         "--mesh-leg", leg, "--mesh-init", init, "--mesh-data", str(data),
         "--mesh-out", out, "--mesh-device", str(dev), "--seed", str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(MESH_WORKERS)]
    try:
        res = [p.communicate(timeout=MESH_WORKER_TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        res = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    check(res is not None, f"{leg}: the ranks ran past "
                           f"{MESH_WORKER_TIMEOUT} s")
    for r, (p, (so, se)) in enumerate(zip(procs, res)):
        check(p.returncode == 0, f"{leg} rank {r} exited "
                                 f"{p.returncode}: {se[-3000:]}")
    return [json.loads(so.strip().splitlines()[-1]) for so, _se in res], \
        out, wall


def mesh_gloo2(np, compat, data, write_s, qs, stats, dev, tmp, seed):
    """``mesh_gloo2``: two processes on the one card, a 1 x 2 gloo mesh,
    each loading the graph's arrays from ``data``; their tables against
    ``mesh_1``'s."""
    lines, out, wall = run_mesh_workers(compat, "gloo2", data, dev, tmp,
                                        seed)
    qp, qsx, tot, (ds, dt) = stats
    errs = {}
    for r in range(MESH_WORKERS):
        with np.load(out % r) as got:
            check(np.array_equal(got["ds"], ds)
                  and np.array_equal(got["dt"], dt),
                  f"mesh_gloo2 rank {r}: distances differ from mesh_1's")
            for name, ref in (("q_prefix", qp), ("q_suffix", qsx),
                              ("totals", tot)):
                e = dp_rel_err(np, got[name], ref)
                check(e <= 1e-5, f"mesh_gloo2 rank {r}: {name} differs "
                                 f"from mesh_1's (rel {e})")
                errs[name] = max(errs.get(name, 0.0), e)
    emit({"phase": "mesh", "leg": "mesh_gloo2", "mesh": [1, MESH_WORKERS],
          "backend": lines[0]["backend"], "wire": lines[0]["wire"],
          "queries": len(qs), "write_s": write_s, "wall_s": wall,
          "ranks": lines, "dp_max_rel_err_vs_mesh_1": errs})


def mesh_split2(compat, data, qs, outs, walls, dev, tmp, seed, smi):
    """``mesh_split2``: two processes on the one card, a 2 x 1 gloo mesh
    (data = 2): each row enumerates the picks whose source it owns and
    both ranks return the gathered output, which must equal ``mesh_1``'s
    items (the fused flag apart), cache stats and non-fused counters;
    then the ranks' ``wire`` leg.  Returns each rank's K5 launches over
    the two legs."""
    import pickle
    lines, out, wall = run_mesh_workers(compat, "split2", data, dev, tmp,
                                        seed)
    for r in range(MESH_WORKERS):
        # this script's own workers wrote these files
        with open(out % r, "rb") as fh:
            got = pickle.load(fh)
        for leg, _kw in MESH_ENUM_LEGS:
            want = output_summary(outs[leg])
            for a, b in zip(got[leg]["items"], want["items"]):
                check(a == b, f"mesh_split2 rank {r} {leg} {b['key']}: "
                              f"differs from mesh_1's item")
            check(len(got[leg]["items"]) == len(want["items"]) == len(qs),
                  f"mesh_split2 rank {r} {leg}: item counts differ")
            check(got[leg]["cache_stats"] == want["cache_stats"]
                  and got[leg]["counters"] == want["counters"],
                  f"mesh_split2 rank {r} {leg}: counters "
                  f"{got[leg]['cache_stats']} {got[leg]['counters']} "
                  f"against mesh_1's {want['cache_stats']} "
                  f"{want['counters']}")
    k5 = [sum(leg["launches"]["frontier_fused_masks"] for leg in ln["legs"])
          for ln in lines]
    for i, (leg, _kw) in enumerate(MESH_ENUM_LEGS):
        ranks = [ln["legs"][i] for ln in lines]
        emit({"phase": "mesh", "leg": "mesh_split2", "enumerate": leg,
              "mesh": [MESH_WORKERS, 1], "backend": lines[0]["backend"],
              "queries": len(qs),
              "owned_queries": [x["owned_queries"] for x in ranks],
              "owned_keys": [x["owned_keys"] for x in ranks],
              "wall_s": max(x["wall_s"] for x in ranks),
              "mesh_1_wall_s": walls[leg],
              "rank_wall_s": [x["wall_s"] for x in ranks],
              "rank_bfs_s": [x["bfs_s"] for x in ranks],
              "rank_run_s": [x["run_s"] for x in ranks],
              "rank_gather_s": [x["gather_s"] for x in ranks],
              "rank_timing": [x["row_timing"] for x in ranks],
              "gather_calls": [x["all_gather_calls"] for x in ranks],
              "gather_bytes": [x["all_gather_bytes"] for x in ranks],
              "all_reduce_calls": [x["all_reduce_calls"] for x in ranks],
              "k5_launches": [x["launches"]["frontier_fused_masks"]
                              for x in ranks],
              "launches": [x["launches"] for x in ranks],
              "max_memory_allocated": [x["max_memory_allocated"]
                                       for x in ranks],
              "processes_wall_s": wall, "card": smi})
    emit({"phase": "mesh", "leg": "wire", "group": "gloo_2x1",
          "card": smi, **{key: lines[0]["wire_leg"][key] for key in
                          ("leaves", "elements", "wire_bytes",
                           "int32_carry_bytes", "float32_bytes")},
          "ranks": [{key: v for key, v in ln["wire_leg"].items()
                     if key not in ("leaves", "elements", "wire_bytes",
                                    "int32_carry_bytes", "float32_bytes")}
                    for ln in lines]})
    return k5


def wire_shapes():
    """lm100m's parameter shapes (``launch.train``'s preset, 107 M
    elements), in the port's tree order."""
    import types
    import torch
    from repro_torch import tree as tree_mod
    from repro_torch.launch import specs
    from repro_torch.launch.train import build_arch
    cfg = build_arch(types.SimpleNamespace(preset="lm100m"))
    return [tuple(x.shape) for x in tree_mod.leaves(
        specs.param_specs(cfg, dtype=torch.float32))]


def wire_tree(torch, shapes, seed, rank, dev):
    """Rank ``rank``'s float32 tree (a list of leaves) from the seed, of a
    magnitude that grows with the rank."""
    gen = torch.Generator(device=dev).manual_seed(1000 * seed + rank)
    return [torch.randn(shape, generator=gen, device=dev) * (1.0 + rank)
            for shape in shapes]


def wire_leg(torch, group, dev, seed, staged: bool) -> dict:
    """``compressed_all_reduce`` of this rank's ``wire_tree`` over
    ``group``; each leaf bit-identical to the int64 sum of every rank's
    quantized values on the shared scale, rebuilt here from the seeds.
    Bytes on the wire beside the int32 carry's and float32's; the
    call's ms, and with ``staged`` each stage's (scales and quantize
    with ``pack_lanes``, the MAX and SUM all-reduces, ``unpack_lanes``
    and dequantize) by CUDA events, median of three, and a float32
    all-reduce of the same tree."""
    from repro_torch.distributed import Wire, compressed_all_reduce
    from repro_torch.distributed.compression import pack_lanes, unpack_lanes
    from repro_torch.distributed.wire import ReduceOp
    shapes = wire_shapes()
    wire = Wire(group)
    tree = wire_tree(torch, shapes, seed, wire.rank, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compressed_all_reduce(tree, group, wire=wire)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = wire.counts()
    trees = [tree if r == wire.rank else
             wire_tree(torch, shapes, seed, r, dev) for r in range(wire.size)]
    for i in range(len(shapes)):
        xs = [t[i] for t in trees]
        scale = torch.stack([x.abs().max() / 127.0 + 1e-12 for x in xs]).max()
        total = sum(torch.clamp(torch.round(x / scale), -127, 127).to(
            torch.int64) for x in xs)
        want = total.to(torch.float32) * scale
        check(torch.equal(got[i].view(torch.int32), want.view(torch.int32)),
              f"wire ({wire.backend}, rank {wire.rank}): leaf {i} "
              f"{shapes[i]} differs from the int64 sum")
    del trees, want, total
    numels = [math.prod(sh) for sh in shapes]
    res = {"leaves": len(shapes), "elements": sum(numels),
           "wire_bytes": counts["all_reduce_bytes"],
           "int32_carry_bytes": sum(4 * n + 4 for n in numels),
           "float32_bytes": sum(4 * n for n in numels),
           "backend": wire.backend, "ranks": wire.size, "rank": wire.rank,
           "first_call_s": first_s, "exact": True}
    check(res["wire_bytes"] == sum(4 * -(-n // 2) + 4 for n in numels),
          f"wire: {res['wire_bytes']} bytes on the wire")

    def timed(fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)
    res["call_ms"] = timed(lambda: compressed_all_reduce(tree, group,
                                                         wire=wire))
    if not staged:
        return res

    def stages():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        local = [(x.abs().max() / 127.0 + 1e-12).reshape(1) for x in tree]
        ev[1].record()
        scales = [wire.all_reduce(sc, ReduceOp.MAX)[0] for sc in local]
        ev[2].record()
        words = [pack_lanes(torch.clamp(torch.round(x / sc), -127, 127))
                 for x, sc in zip(tree, scales)]
        ev[3].record()
        totals = [wire.all_reduce(w, ReduceOp.SUM) for w in words]
        ev[4].record()
        outs = [unpack_lanes(tot, x.numel(), wire.size).reshape(
            x.shape).to(torch.float32) * sc
            for tot, x, sc in zip(totals, tree, scales)]
        ev[5].record()
        torch.cuda.synchronize()
        ms = [ev[j].elapsed_time(ev[j + 1]) for j in range(5)]
        return ms[0] + ms[2], ms[1] + ms[3], ms[4], outs
    runs = []
    for _ in range(3):
        *ms, outs = stages()
        for i, leaf in enumerate(outs):
            check(torch.equal(leaf.view(torch.int32),
                              got[i].view(torch.int32)),
                  f"wire: the staged leaf {i} differs from the call's")
        runs.append(ms)
    del outs
    res.update({"pack_ms": statistics.median(r[0] for r in runs),
                "all_reduce_ms": statistics.median(r[1] for r in runs),
                "unpack_ms": statistics.median(r[2] for r in runs)})
    res["float32_all_reduce_ms"] = timed(
        lambda: [wire.all_reduce(x.clone(), ReduceOp.SUM) for x in tree])
    return res


def wire_one(torch, compat, dev, seed, smi) -> None:
    """``wire`` on a 1 x 1 NCCL group in this process (its own process
    group, destroyed afterwards)."""
    import torch.distributed as tdist
    mesh = compat.make_mesh((1, 1), ("data", "model"), device=dev)
    try:
        res = wire_leg(torch, mesh.get_group("data"), dev, seed, staged=True)
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    emit({"phase": "mesh", "leg": "wire", "group": "nccl_1x1", "card": smi,
          **res})


def mesh_worker(args) -> None:
    """One rank of a two-process gloo mesh (``--mesh-rank``) on
    ``--mesh-device``, the graph, queries and hop bound from
    ``--mesh-data``.  ``--mesh-leg gloo2``: a 1 x 2 mesh, the stats of
    the queries; the tables to ``--mesh-out`` and one JSON line with the
    stage seconds, edge bytes and collectives.  ``--mesh-leg split2``: a
    2 x 1 mesh, ``enumerate_batch`` in ``MESH_ENUM_LEGS`` on one default
    engine, each leg's launches counted from 0 just before it; the
    gathered outputs' summaries to ``--mesh-out`` and one JSON line with
    the row's share and collectives a leg, then the ``wire`` leg over
    the two ranks."""
    import pickle
    import numpy as np
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as tc
    from repro_torch import compat, kernels
    from repro_torch.distributed import DistributedPathEnum

    split = args.mesh_leg == "split2"
    t0 = time.perf_counter()
    dev = torch.device(args.mesh_device)
    shape = (MESH_WORKERS, 1) if split else (1, MESH_WORKERS)
    mesh = compat.make_mesh(shape, ("data", "model"), device=dev,
                            backend="gloo", init_method=args.mesh_init,
                            rank=args.mesh_rank)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with np.load(args.mesh_data) as f:
        g = tc.Graph(int(f["n"]), f["indptr"], f["indices"], f["rindptr"],
                     f["rindices"], f["esrc"], f["edst"])
        qs, k = f["queries"], int(f["k"])
    load_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        dpe = DistributedPathEnum(mesh, g, k, device=dev)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        head = {"rank": args.mesh_rank, "backend": dpe.model.backend,
                "wire": dpe.model.kind, "init_s": init_s, "load_s": load_s,
                "shard_s": shard_s,
                "edge_bytes_per_rank": dpe.edge_bytes()}
        if not split:
            t0 = time.perf_counter()
            qp, qsx, tot, (ds, dt) = dpe.query_batch_stats(qs)
            stats_s = time.perf_counter() - t0
            np.savez(args.mesh_out % args.mesh_rank, q_prefix=qp,
                     q_suffix=qsx, totals=tot, ds=ds, dt=dt)
            emit({**head, **dpe.last_timing, "stats_s": stats_s,
                  "max_memory_allocated":
                      torch.cuda.max_memory_allocated(dev),
                  **dpe.comm_counts()})
            return
        engine = tc.BatchPathEnum(device=dev)
        legs, summaries = [], {}
        for leg, kw in MESH_ENUM_LEGS:
            torch.cuda.reset_peak_memory_stats(dev)
            comm0 = dpe.comm_counts()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dpe.enumerate_batch(qs, engine=engine, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
            comm1 = dpe.comm_counts()
            legs.append({"enumerate": leg, "wall_s": wall,
                         **dpe.last_split,
                         **{key: comm1[key] - comm0[key] for key in comm1},
                         "launches": {n: launches[n] for n in
                                      PATHENUM_KERNELS},
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated(dev)})
            summaries[leg] = output_summary(out)
        with open(args.mesh_out % args.mesh_rank, "wb") as fh:
            pickle.dump(summaries, fh)
        del engine, out
        torch.cuda.empty_cache()
        wire = wire_leg(torch, mesh.get_group("data"), dev, args.seed,
                        staged=False)
        emit({**head, "legs": legs, "wire_leg": wire})
    finally:
        tdist.destroy_process_group()


def mesh_phase(torch, np, tc, est, kernels, g, picks, batch_runs, dev, seed,
               smi):
    """The mesh engine on the large graph: ``mesh_1`` (its launches
    counted from 0 and returned), its checks, ``mesh_gloo2``,
    ``mesh_split2`` (each rank's K5 launches returned) and ``wire``."""
    import tempfile
    from repro_torch import compat
    from repro_torch import distributed as dist_mod
    qs = np.array([(s, t) for s, t, _ in picks], np.int64)
    t_phase = time.perf_counter()
    stats, outs, walls, launches, comm = mesh_one(torch, tc, kernels, compat,
                                                  dist_mod, g, qs, dev)
    cmp = check_mesh_one(torch, np, tc, est, g, picks, stats, outs,
                         batch_runs, dev)
    emit({"phase": "mesh", "leg": "mesh_1_check", "ok": True, **cmp,
          "all_reduce_calls_per_stats": comm["all_reduce_calls"]})
    with tempfile.TemporaryDirectory() as tmp:
        data, write_s = write_mesh_data(np, g, qs, tmp)
        mesh_gloo2(np, compat, data, write_s, qs, stats, dev, tmp, seed)
        split_k5 = mesh_split2(compat, data, qs, outs, walls, dev, tmp, seed,
                               smi)
    wire_one(torch, compat, dev, seed, smi)
    emit({"phase": "mesh", "leg": "done",
          "seconds": time.perf_counter() - t_phase})
    return launches, split_k5


# ---------------------------------------------------------------------------
# the LM attention kernels (K6, K7) and the LM serving path
# ---------------------------------------------------------------------------

def flash_work(np, B, Lq, Lk, H, Hkv, D, esize, window=None):
    """Operations and bytes of one causal K6 call: 4·D·H operations per
    visible (row, col) pair; q, k and v read once, the output written
    once."""
    rows = np.arange(Lq, dtype=np.int64) + (Lk - Lq)   # in key positions
    hi = np.minimum(rows, Lk - 1) + 1
    lo = np.maximum(rows - window + 1, 0) if window else 0
    pairs = int(np.maximum(hi - lo, 0).sum())
    ops = 4 * D * H * pairs * B
    nbytes = esize * B * (2 * Lq * H * D + 2 * Lk * Hkv * D)
    return ops, nbytes


def decode_work(B, H, Hkv, D, esize, total_len):
    """Operations and bytes of one K7 call: each row's first lengths[b]
    cache positions of K and V read once (2·Σlengths·Hkv·D elements), q
    read and the output written once, the lengths read; 4·Σlengths·H·D
    operations."""
    ops = 4 * total_len * H * D
    nbytes = esize * (2 * total_len * Hkv * D + 2 * B * H * D) + 4 * B
    return ops, nbytes


def peak_for(torch, dtype):
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S


def device_ms(torch, fn, reps: int) -> float:
    """Milliseconds of device time per call of ``fn``: the card first
    spins for about 10 ms (``torch.cuda._sleep``) while the host queues
    ``reps`` calls behind it, so CUDA events around the calls time the
    card alone, without the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def attention_row(torch, run, plain, library, ops, nbytes, dtype, reps,
                  shape, exact):
    """One attention kernel against its plain version: the largest
    absolute error (checked against the tolerance of the type; in
    bfloat16 also the error scaled by each element's size, and the
    kernel's and the plain version's scaled errors against ``exact``,
    the plain version in float32 on the same inputs), times of
    the kernel (per call as a caller sees it, and the device's share of
    that), the plain version and the one-call yardstick, and the
    bound."""
    tol = ATTN_TOL[str(dtype)]
    got, want = run(), plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{shape['kernel']}: non-finite "
                                           f"output at {shape}")
    err = max_abs_err(torch, [got], [want])
    check(err <= tol, f"{shape['kernel']} differs from its plain version by "
                      f"{err} > {tol} at {shape}")
    rel = {}
    rel_tol = ATTN_REL_TOL.get(str(dtype))
    if rel_tol is not None:
        e = scaled_err(torch, got, want)
        check(e <= rel_tol, f"{shape['kernel']} differs from its plain "
                            f"version by {e} of |want| + its row's rms > "
                            f"{rel_tol} at {shape}")
        ref = exact()
        e_k = scaled_err(torch, got.float(), ref)
        e_p = scaled_err(torch, want.float(), ref)
        check(e_k <= BF16_ERR_RATIO * e_p,
              f"{shape['kernel']}: its error against float32, {e_k}, is "
              f"over {BF16_ERR_RATIO} x the plain version's {e_p} at "
              f"{shape}")
        rel = dict(scaled_err=e, scaled_tol=rel_tol, scaled_err_vs_f32=e_k,
                   plain_scaled_err_vs_f32=e_p)
        del ref
    del got, want
    if shape["kernel"] == "flash_attention" and dtype == torch.float32:
        # three TF32 products per operation on the tensor cores
        b_ms, b_by = bound(nbytes, 3 * ops, TF32_OPS_PER_S)
        rel["simt_bound_ms"] = bound(nbytes, ops, FP32_OPS_PER_S)[0]
    else:
        b_ms, b_by = bound(nbytes, ops, peak_for(torch, dtype))
    return dict(max_abs_err=err, tol=tol, **rel,
                ms=time_ms(torch, run, reps, warmup=1),
                device_ms=device_ms(torch, run, reps),
                plain_ms=time_ms(torch, plain, max(1, reps // 2), warmup=1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, library, reps, warmup=1),
                shape=shape)


def flash_row(torch, np, kf, q, k, v, window=None, reps=5):
    """K6 on (q, k, v), causal, against its plain version; the yardstick
    is ``scaled_dot_product_attention`` with its own causal mask where
    Lq == Lk and no window, else with the same boolean mask."""
    F = torch.nn.functional
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None and Lq == Lk:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    else:
        rows = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
        cols = torch.arange(Lk, device=q.device)[None, :]
        mask = rows >= cols
        if window:
            mask &= rows - cols < window

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
    ops, nbytes = flash_work(np, B, Lq, Lk, H, Hkv, D, q.element_size(),
                             window)
    return attention_row(
        torch, lambda: kf.flash_attention(q, k, v, window=window),
        lambda: kf.flash_attention_plain(q, k, v, window=window), library,
        ops, nbytes, q.dtype, reps,
        dict(kernel="flash_attention", B=B, Lq=Lq, Lk=Lk, H=H, Hkv=Hkv, D=D,
             window=window, dtype=str(q.dtype), causal=True),
        lambda: kf.flash_attention_plain(q.float(), k.float(), v.float(),
                                         window=window))


def decode_row(torch, kd, q, kc, vc, lengths, reps=10):
    """K7 against its plain version; the yardstick is
    ``scaled_dot_product_attention`` with a boolean length mask."""
    F = torch.nn.functional
    B, H, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    qt = q[:, :, None]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    total = int(lengths.sum())
    ops, nbytes = decode_work(B, H, Hkv, D, q.element_size(), total)
    return attention_row(
        torch, lambda: kd.decode_attention(q, kc, vc, lengths),
        lambda: kd.decode_attention_plain(q, kc, vc, lengths),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True),
        ops, nbytes, q.dtype, reps,
        dict(kernel="decode_attention", B=B, S=S, H=H, Hkv=Hkv, D=D,
             sum_lengths=total, dtype=str(q.dtype)),
        lambda: kd.decode_attention_plain(q.float(), kc.float(), vc.float(),
                                          lengths))


def attention_kernel_phase(torch, np, kf, kd, dev, seed):
    """K6 and K7 at fixed shapes (``kernel`` lines): K6 at L = 4096 in
    float32 and bfloat16, windowed and with Lq < Lk; K7 over a 32768-long
    cache of 16 rows in float32 and bfloat16; then both at head dim 96
    (phi3-vision: 32 query and 32 KV heads), K7 over 4 rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 6)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    B, L, H, Hkv, D = 1, 4096, 16, 8, 128
    q, k, v = normal(B, L, H, D), normal(B, L, Hkv, D), normal(B, L, Hkv, D)
    cases = [("causal_f32", (q, k, v), None),
             ("causal_bf16", tuple(x.to(torch.bfloat16) for x in (q, k, v)),
              None),
             ("window_2048_f32", (q, k, v), 2048),
             ("lq_1024_lk_4096_f32", (q[:, -1024:].contiguous(), k, v), None)]
    q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
    cases += [("window_2048_bf16", (q16, k16, v16), 2048),
              ("lq_1024_lk_4096_bf16", (q16[:, -1024:].contiguous(), k16,
                                        v16), None)]
    for case, (qq, kk, vv), window in cases:
        row = flash_row(torch, np, kf, qq, kk, vv, window=window)
        emit({"phase": "kernel", "name": "flash_attention", "case": case,
              **row})
    del q, k, v, q16, k16, v16, cases, qq, kk, vv
    B, S = 16, 32768
    rng = np.random.default_rng(seed + 7)
    lengths = torch.from_numpy(rng.integers(S // 2, S + 1, B).astype(
        np.int32)).to(dev)
    q, kc, vc = normal(B, H, D), normal(B, S, Hkv, D), normal(B, S, Hkv, D)
    for case, dtype in (("long_cache_f32", torch.float32),
                        ("long_cache_bf16", torch.bfloat16)):
        row = decode_row(torch, kd, q.to(dtype), kc.to(dtype), vc.to(dtype),
                         lengths, reps=5)
        emit({"phase": "kernel", "name": "decode_attention", "case": case,
              **row})
    del q, kc, vc
    torch.cuda.empty_cache()

    # phi3-vision's attention: 32 query and 32 KV heads of 96
    B, L, H, D = 1, 4096, 32, 96
    q, k, v = normal(B, L, H, D), normal(B, L, H, D), normal(B, L, H, D)
    for case, dtype in (("phi3_d96_causal_f32", torch.float32),
                        ("phi3_d96_causal_bf16", torch.bfloat16)):
        row = flash_row(torch, np, kf, q.to(dtype), k.to(dtype),
                        v.to(dtype))
        emit({"phase": "kernel", "name": "flash_attention", "case": case,
              **row})
    del q, k, v
    B, S = 4, 32768
    lengths = torch.from_numpy(rng.integers(S // 2, S + 1, B).astype(
        np.int32)).to(dev)
    q, kc, vc = normal(B, H, D), normal(B, S, H, D), normal(B, S, H, D)
    for case, dtype in (("phi3_d96_long_cache_f32", torch.float32),
                        ("phi3_d96_long_cache_bf16", torch.bfloat16)):
        row = decode_row(torch, kd, q.to(dtype), kc.to(dtype), vc.to(dtype),
                         lengths, reps=5)
        emit({"phase": "kernel", "name": "decode_attention", "case": case,
              **row})
    del q, kc, vc
    torch.cuda.empty_cache()


def record_attention_calls(kf, kd, n_layers):
    """Wrap the K6 and K7 wrappers (looked up at call time by the
    attention layers) so the first K6 call's inputs and window, and (q,
    lengths) of every decode step's first layer (``n_layers`` attention
    layers a step), are kept; returns the record and a function that
    unwraps them."""
    orig_f, orig_d = kf.flash_attention, kd.decode_attention
    seen = {"flash": None, "decode": [], "decode_calls": 0}

    def flash(q, k, v, **kw):
        if seen["flash"] is None:
            seen["flash"] = (q, k, v, kw.get("window"))
        return orig_f(q, k, v, **kw)

    def decode(q, kc, vc, lengths, **kw):
        if seen["decode_calls"] % n_layers == 0:
            seen["decode"].append((q, lengths))
        seen["decode_calls"] += 1
        return orig_d(q, kc, vc, lengths, **kw)

    kf.flash_attention, kd.decode_attention = flash, decode

    def restore():
        kf.flash_attention, kd.decode_attention = orig_f, orig_d
    return seen, restore


def tree_leaves(tree):
    """The tensors of a parameter tree or a cache, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def lm_phase(torch, np, tm, step, serving, cfg, dev, seed, prompt_len=2048,
             n_requests=16, slots=8, max_len=1024, max_tokens=32,
             params=None, batch=2, prompt_lens=(8, 65), prefix_rows=0,
             dtype=None, prefill_ctx=None):
    """The LM serving path: parameters (random from the seed in ``dtype``,
    default float32, unless given), a timed prefill of ``batch`` prompts
    (after one untimed call of the same shape; with a ``prefix_emb`` of
    ``prefix_rows`` rows for vlm and audio; inside ``prefill_ctx`` when
    given, which the MoE legs use to record its routes) and a served
    batch of requests (prompts of ``prompt_lens`` tokens, a half-open
    range); returns what the check and the kernel rows need, and the
    metrics."""
    t0 = time.perf_counter()
    if params is None:
        params = tm.init_params(cfg, seed, device=dev,
                                dtype=dtype or torch.float32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params))

    rng = np.random.default_rng(seed + 11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                              ).to(dev)
    inputs = {"tokens": tokens}
    if prefix_rows:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 12)
        inputs["prefix_emb"] = torch.randn((batch, prefix_rows, cfg.d_model),
                                           generator=gen, device=dev)
    prefill = step.make_prefill(cfg)
    prefill(params, inputs)
    torch.cuda.synchronize()
    with prefill_ctx or contextlib.nullcontext():
        t0 = time.perf_counter()
        logits, cache, lengths = prefill(params, inputs)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    n_attn = sum(k in tm.ATTN_KINDS for k in tm.layer_kinds(cfg))
    kv_shape = (n_attn, batch, prompt_len, cfg.kv_heads, cfg.hd)
    check(logits.shape == (batch, 1, cfg.vocab)
          and (cache["k"].shape == kv_shape if n_attn else cache == {})
          and lengths.tolist() == [prompt_len] * batch,
          f"prefill shapes: {tuple(logits.shape)}, "
          f"{[tuple(x.shape) for x in tree_leaves(cache)]}")
    del cache

    eng = serving.ServeEngine(cfg, params, batch_slots=slots,
                              max_len=max_len, temperature=0.0, seed=seed,
                              device=dev)
    # one batched step at the engine's shape first, so the timed run does
    # not pay cuBLAS's first calls; admission resets every slot it fills
    eng.step_fn(params, eng.cur_tok, eng.cache, eng.lens, eng.generator)
    torch.cuda.synchronize()
    reqs = [serving.Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(*prompt_lens))).astype(np.int32),
        max_tokens=max_tokens) for i in range(n_requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    generated = sum(len(v) for v in results.values())
    replayed = sum(len(r.prompt) - 1 for r in reqs)
    check(len(results) == n_requests and all(
        len(v) == max_tokens for v in results.values()),
        f"served {len(results)} requests, lengths "
        f"{sorted(len(v) for v in results.values())}")
    metrics = {"arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.kv_heads, "head_dim": cfg.hd, "vocab": cfg.vocab,
          "dtype": str(params["embed"].dtype), "param_bytes": param_bytes,
          "param_count": sum(x.numel() for x in tree_leaves(params)),
          "init_s": init_s,
          "prefill_batch": batch, "prefill_len": prompt_len,
          "prefix_rows": prefix_rows,
          "prefill_s": prefill_s,
          "prefill_tokens_per_s": batch * prompt_len / prefill_s,
          "serve_slots": slots, "serve_max_len": max_len,
          "cache_bytes": sum(x.numel() * x.element_size()
                             for x in tree_leaves(eng.cache)),
          "requests": n_requests, "prompt_tokens": replayed + n_requests,
          "replay_steps": replayed, "steps_run": eng.steps_run,
          "generated_tokens": generated, "serve_s": serve_s,
          "decode_tokens_per_s": generated / serve_s,
          "ms_per_engine_step": serve_s / (replayed + eng.steps_run) * 1e3,
          "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    return dict(params=params, tokens=tokens, inputs=inputs,
                prefill_logits=logits, prefill_s=prefill_s, reqs=reqs,
                results=results, engine=eng), metrics


def device_busy(torch, fn, steps):
    """``steps`` calls of ``fn`` timed on the host clock without a
    profiler, then again under ``torch.profiler`` (CPU and CUDA
    activity): the device's busy time in the traced window is the sum of
    the durations of its kernels, memcpys and memsets.  Returns the two
    walls, the busy time, its share of the unprofiled wall (None when the
    trace holds no device activity) and the device operations per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.device_time_total for e in ops) * 1e-6
    return {"steps": steps, "wall_ms_per_step": wall / steps * 1e3,
            "traced_wall_ms_per_step": wall_traced / steps * 1e3,
            "device_busy_ms_per_step": busy_s / steps * 1e3 if ops else None,
            "device_busy_share": busy_s / wall if ops else None,
            "device_ops_per_step": len(ops) / steps}


def lm_kernel_rows(torch, np, kf, kd, seen, eng, case="lm_phase"):
    """K6 at the prefill's shape (its first layer's inputs and window)
    and K7 at the engine's shape: the recorded decode call with the most
    cached positions, over the engine's layer-0 cache."""
    q, k, v, window = seen["flash"]
    rows = {"flash_attention": flash_row(torch, np, kf, q, k, v, window)}
    sums = torch.stack([lens for _, lens in seen["decode"]]).sum(1)
    qd, lengths = seen["decode"][int(sums.argmax())]
    rows["decode_attention"] = decode_row(
        torch, kd, qd, eng.cache["k"][0], eng.cache["v"][0], lengths)
    for name, row in rows.items():
        emit({"phase": "kernel", "name": name, "case": case, **row})
    return rows


def forced_tokens(torch, np, reqs, out, dev):
    """The served requests' prompts followed by their served tokens but
    the last, zero-padded into one (n, T) batch, and the (n, T) mask of
    the positions each request fills."""
    seqs = [list(r.prompt) + out[r.uid][:-1] for r in reqs]
    toks = np.zeros((len(seqs), max(len(s) for s in seqs)), np.int64)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    mask = np.arange(toks.shape[1])[None, :] < np.array(
        [len(s) for s in seqs])[:, None]
    return (torch.from_numpy(toks).to(dev), torch.from_numpy(mask).to(dev))


def decode_chain(torch, tm, params, cfg, toks, max_len, impl, dtype):
    """``toks`` (n, T) teacher-forced through ``decode_step`` on a fresh
    cache of ``max_len`` positions in ``dtype``: the logits of every
    step, (n, T, vocab) float32."""
    n, T = toks.shape
    cache = tm.init_cache(cfg, n, max_len, dtype=dtype, device=toks.device)
    lens = torch.zeros(n, dtype=torch.int32, device=toks.device)
    steps = []
    with torch.no_grad():
        for p in range(T):
            lg, cache = tm.decode_step(params, cfg, toks[:, p], cache, lens,
                                       impl=impl)
            steps.append(lg.float())
            lens = lens + 1
    return torch.stack(steps, 1)


def lm_check(torch, np, tm, cfg, run, dev, n_check=4, phase="lm_check",
             leg=None):
    """The LM path's logits against the port's plain path on the card."""
    params = run["params"]
    plain, _ = tm.forward(params, cfg, run["inputs"], impl="xla")
    got = run["prefill_logits"][:, 0]
    check(bool(torch.isfinite(got).all()), "prefill: non-finite logits")
    err_prefill = (got - plain[:, -1]).abs().max().item()
    check(err_prefill <= LM_TOL, f"prefill logits differ from the plain "
                                 f"forward by {err_prefill} > {LM_TOL}")
    del plain
    reqs = run["reqs"][:n_check]
    out = run["results"]
    toks, mask = forced_tokens(torch, np, reqs, out, dev)
    decoded = decode_chain(torch, tm, params, cfg, toks, toks.shape[1],
                           "flash", torch.float32)
    plain, _ = tm.forward(params, cfg, {"tokens": toks}, impl="xla")
    check(bool(torch.isfinite(decoded[mask]).all()),
          "non-finite decode logits")
    err_decode = (decoded[mask] - plain[mask]).abs().max().item()
    checked, ties = 0, 0
    for i, r in enumerate(reqs):
        n, P = int(mask[i].sum()), len(r.prompt)
        top = plain[i, P - 1:n].topk(2, dim=-1)
        margin = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
        best = top.indices[:, 0].cpu().numpy()
        for j, tok in enumerate(out[r.uid]):
            if margin[j] > LM_TOL:
                check(tok == int(best[j]), f"request {r.uid} token {j}: "
                      f"served {tok}, plain argmax {int(best[j])} with "
                      f"margin {margin[j]}")
                checked += 1
            else:
                ties += 1
    check(err_decode <= LM_TOL, f"decode logits differ from the plain "
                                f"forward by {err_decode} > {LM_TOL}")
    emit({"phase": phase, **({"leg": leg} if leg else {}), "ok": True,
          "tol": LM_TOL,
          "tf32": bool(torch.backends.cuda.matmul.allow_tf32
                       or torch.backends.cudnn.allow_tf32),
          "prefill_max_abs_err": err_prefill,
          "decode_max_abs_err": err_decode,
          "decode_positions": int(mask.sum()),
          "greedy_tokens_checked": checked, "greedy_near_ties": ties})


def cast_params(tree, dtype, keep=(), name=None):
    """The parameter tree with every tensor cast to ``dtype``, but the
    leaves named in ``keep`` (``transformer.FLOAT32_LEAVES``: float32 in
    every dtype, as in ``repro``)."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype, keep, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype, keep) for v in tree]
    return tree if name in keep else tree.to(dtype)


def lm_bf16_check(torch, tm, cfg, run, prefill_k6_ms):
    """The bfloat16 leg's prefill logits, from K6 and from the plain path
    (``forward(impl="xla")``) in bfloat16, each against the float32 plain
    path on the same bfloat16-rounded weights: the kernels' error may be
    at most ``BF16_ERR_RATIO`` times the plain bfloat16 path's."""
    params, tokens = run["params"], run["tokens"]
    got = run["prefill_logits"][:, 0].float()
    check(bool(torch.isfinite(got).all()), "bf16 prefill: non-finite logits")
    plain, _ = tm.forward(params, cfg, {"tokens": tokens}, impl="xla")
    plain = plain[:, -1].float()
    ref_params = cast_params(params, torch.float32, tm.FLOAT32_LEAVES)
    ref, _ = tm.forward(ref_params, cfg, {"tokens": tokens}, impl="xla")
    ref = ref[:, -1]
    del ref_params
    err_kernels = (got - ref).abs().max().item()
    err_plain = (plain - ref).abs().max().item()
    check(err_kernels <= BF16_ERR_RATIO * err_plain,
          f"bf16 prefill logits: the kernels' error {err_kernels} exceeds "
          f"{BF16_ERR_RATIO} x the plain bf16 path's {err_plain}")
    emit({"phase": "lm_bf16_check", "ok": True, "ratio_limit": BF16_ERR_RATIO,
          "kernels_max_abs_err_vs_f32": err_kernels,
          "plain_bf16_max_abs_err_vs_f32": err_plain,
          "kernels_vs_plain_bf16": (got - plain).abs().max().item(),
          "prefill_k6_share": cfg.num_layers * prefill_k6_ms
          / (run["prefill_s"] * 1e3)})


# ---------------------------------------------------------------------------
# the five families past dense (vlm, audio, ssm, hybrid, moe)
# ---------------------------------------------------------------------------

# arch, depth (None: the config's own), dtype, prefill batch and length,
# prefix_emb rows.  Widths are never cut; llama4-maverick's depth is cut to
# one (moe, dense) super-block, since its 48 layers are 789 GB in bfloat16
FAMILY_LEGS = (
    ("phi3_vision_4p2b", None, "float32", 2, 512, 256),
    ("musicgen_large", None, "float32", 2, 512, 64),
    ("mamba2_780m", None, "float32", 2, 512, 0),
    ("recurrentgemma_9b", None, "float32", 1, 4096, 0),
    ("qwen3_moe_30b_a3b", None, "bfloat16", 2, 512, 0),
    ("llama4_maverick_400b_a17b", 2, "bfloat16", 2, 512, 0),
)
# every leg's engine: 8 greedy requests of 8-32 prompt tokens, 16 new each
FAMILY_SERVE = dict(n_requests=8, slots=8, max_len=64, max_tokens=16,
                    prompt_lens=(8, 33))
# qwen3-moe's bfloat16 checks hold the kernels against a float32 plain
# path, each layer cast when read (one layer's copy, 2.4 GB, beside the
# 60 GB of weights; the whole copy is 120 GB); llama4's are against the
# plain bfloat16 path, since one of its moe layers is 64 GB in float32
MOE_F32_REF = ("qwen3_moe_30b_a3b",)
# llama4's limits against plain bfloat16: each logit within 2^-3 of
# |plain| + its row's rms (the paths round attention differently, and
# the one-expert FFN's outputs, about 100 times the residual stream,
# carry the difference to every logit); at most 5% of positions routed
# to another expert when each path routes itself
LLAMA4_SCALED_TOL = 2.0 ** -3
LLAMA4_FLIP_SHARE = 0.05
# the float32 legs with a window also decode two served requests on a
# ring of this many positions, shorter than each request, so the ring
# wraps at full width
RING_CHECK_LEN = 16
# recurrentgemma-9b's attention for the K6/K7 lines: prefill length, query
# heads (over one KV head), head dim, window = the ring buffer's length
RGEMMA_ATTN = (4096, 16, 256, 2048)


def family_kernel_rows(torch, np, kf, kd, dev, seed):
    """K6 and K7 at recurrentgemma-9b's attention (16 query heads over one
    KV head of 256, window 2048), both dtypes: K6 causal over L = 4096,
    so the window bites; K7 over the engine's ring buffer, 8 slots of
    S = 2048 positions, each slot's position drawn from [S/2, 2S) and its
    valid length min(pos + 1, S)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    L, H, D, W = RGEMMA_ATTN
    q, k, v = normal(1, L, H, D), normal(1, L, 1, D), normal(1, L, 1, D)
    rows = {}
    for case, dtype in (("rgemma_d256_window_2048_f32", torch.float32),
                        ("rgemma_d256_window_2048_bf16", torch.bfloat16)):
        rows[case] = flash_row(torch, np, kf, q.to(dtype), k.to(dtype),
                               v.to(dtype), window=W)
        emit({"phase": "kernel", "name": "flash_attention", "case": case,
              **rows[case]})
    del q, k, v
    pos = np.random.default_rng(seed + 14).integers(W // 2, 2 * W, 8)
    lengths = torch.from_numpy(np.minimum(pos + 1, W).astype(np.int32)
                               ).to(dev)
    q, kc, vc = normal(8, H, D), normal(8, W, 1, D), normal(8, W, 1, D)
    for case, dtype in (("rgemma_d256_ring_f32", torch.float32),
                        ("rgemma_d256_ring_bf16", torch.bfloat16)):
        rows[case] = decode_row(torch, kd, q.to(dtype), kc.to(dtype),
                                vc.to(dtype), lengths)
        emit({"phase": "kernel", "name": "decode_attention", "case": case,
              **rows[case]})
    del q, kc, vc
    torch.cuda.empty_cache()


def family_launch_check(tm, cfg, dtype, launches, leg):
    """An attention family launched its dtype's K6 kernel and K7, and not
    the other K6 kernel; mamba2 launched no attention kernel; no leg
    launched a PathEnum kernel."""
    n_attn = sum(k in tm.ATTN_KINDS for k in tm.layer_kinds(cfg))
    bf16 = str(dtype) == "torch.bfloat16"
    k6 = "flash_attention_sm90" if bf16 else "flash_attention"
    other = "flash_attention" if bf16 else "flash_attention_sm90"
    if n_attn:
        for name in (k6, "decode_attention"):
            check(launches[name] > 0, f"{leg}: {name} never launched")
        check(launches[other] == 0, f"{leg}: {other} launched")
    else:
        for name in LM_KERNELS + ("flash_attention_sm90",):
            check(launches[name] == 0, f"{leg}: {name} launched")
    for name in PATHENUM_KERNELS:
        check(launches[name] == 0, f"{leg}: {name} launched")


class RouteTap:
    """Stands in for ``torch`` inside ``models/moe.py`` while entered
    (``moe_ffn`` looks its ``torch`` up at call time).  Each ``topk`` call
    (one a moe layer) either records the expert ids it returns in
    ``routes``, in call order, or, with ``forced``, returns the next
    forced ids and the layer's own probabilities at them, and records
    those; every other name is torch's."""

    def __init__(self, torch, moe_mod, forced=None):
        self._torch, self._mod, self._forced = torch, moe_mod, forced
        self.routes = []

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def __enter__(self):
        self._mod.torch = self
        return self

    def __exit__(self, *exc):
        self._mod.torch = self._torch

    def topk(self, probs, k, dim=-1):
        if self._forced is None:
            vals, ids = self._torch.topk(probs, k, dim=dim)
        else:
            ids = self._forced[len(self.routes)]
            vals = self._torch.gather(probs, -1, ids)
        self.routes.append(ids)
        return vals, ids


class Float32OnUse(dict):
    """A layer's parameters read in float32: each sub-tree is cast (the
    ``keep`` leaves as they are) when the forward or decode step reads it,
    and freed after, so a float32 reference of a model whose float32
    copy does not fit needs one layer's copy at a time."""

    def __init__(self, blk, dtype, keep):
        super().__init__(blk)
        self._dtype, self._keep = dtype, keep

    def __getitem__(self, name):
        return cast_params(super().__getitem__(name), self._dtype,
                           self._keep, name)


def float32_on_use(torch, tm, params):
    """``params`` in float32: the leaves outside the layers cast now,
    each layer as ``Float32OnUse``."""
    out = {k: cast_params(v, torch.float32, tm.FLOAT32_LEAVES, k)
           for k, v in params.items() if k != "layers"}
    out["layers"] = [Float32OnUse(blk, torch.float32, tm.FLOAT32_LEAVES)
                     for blk in params["layers"]]
    return out


def routed_forward(torch, tm, moe_mod, params, cfg, inputs, impl,
                   forced=None):
    """``forward`` under a ``RouteTap``: the logits as (tokens, vocab)
    float32 and the routes it took (or was given)."""
    with RouteTap(torch, moe_mod, forced) as tap, torch.no_grad():
        logits, _ = tm.forward(params, cfg, inputs, impl=impl)
    return logits.reshape(-1, cfg.vocab).float(), tap.routes


def routed_decode(torch, tm, moe_mod, params, cfg, toks, impl, dtype,
                  forced=None):
    """``decode_chain`` under a ``RouteTap``: the logits and the routes."""
    with RouteTap(torch, moe_mod, forced) as tap:
        logits = decode_chain(torch, tm, params, cfg, toks, toks.shape[1],
                              impl, dtype)
    return logits, tap.routes


def route_flips(torch, a, b, layers):
    """Per step and token, (steps, tokens): whether the token's set of
    top-k experts differs between two runs' routes in any of a step's
    ``layers`` MoE layers (a forward is one step)."""
    f = torch.stack([(x.sort(-1).values != y.sort(-1).values).any(-1)
                     for x, y in zip(a, b)])
    return f.view(-1, layers, f.shape[-1]).any(1)


def moe_check(torch, np, tm, moe_mod, cfg, run, served_routes, dev):
    """A bfloat16 MoE leg against the port's plain path on the same
    weights, at every position of the served prefill's prompts and of
    two served requests teacher-forced through ``decode_step`` (K7).

    Top-k routing is discontinuous, and a changed route moves its
    token's residual and, through attention, every later token's: left
    to route themselves, qwen3-moe's paths part at almost every
    position.  So every path runs on the kernel path's routes:
    the prefill's on the routes the served (timed) prefill took, the
    decode's on those of the kernel path's chain, each layer gated by its
    own probabilities at those experts.  The routes each path takes on
    its own are counted (tokens whose top-k set differs in any layer)
    and reported beside the errors.

    With a float32 reference (``MOE_F32_REF``, each layer cast when read)
    the rule is ``lm_bf16_check``'s: the kernels' logit error against the
    float32 plain path, over the forced forward and the served prefill's
    last logits (prefill) and over the chain (decode), may be at most
    ``BF16_ERR_RATIO`` times the plain bfloat16 path's.  Without one
    (llama4), the kernels' logits are held to the plain bfloat16 path's by
    ``scaled_err`` within ``LLAMA4_SCALED_TOL``, and the own routes may
    differ at most at ``LLAMA4_FLIP_SHARE`` of the positions."""
    params, inputs = run["params"], run["inputs"]
    f32 = cfg.name in MOE_F32_REF
    n_moe = tm.layer_kinds(cfg).count("moe")
    ref_params = float32_on_use(torch, tm, params) if f32 else None

    def fwd(p, impl, forced=None):
        return routed_forward(torch, tm, moe_mod, p, cfg, inputs, impl,
                              forced)

    B, L = inputs["tokens"].shape
    last = torch.arange(B, device=dev) * L + L - 1
    served = run["prefill_logits"][:, 0].float()
    check(bool(torch.isfinite(served).all()),
          f"{cfg.name}: non-finite prefill logits")
    kern = fwd(params, "flash", served_routes)[0]
    plain = fwd(params, "xla", served_routes)[0]
    r_plain = fwd(params, "xla")[1]
    check(bool(torch.isfinite(kern).all()), f"{cfg.name}: non-finite logits")
    pre = {"positions": kern.shape[0],
           "own_route_flips_kernel_vs_plain":
               int(route_flips(torch, served_routes, r_plain, n_moe).sum())}

    toks, mask = forced_tokens(torch, np, run["reqs"][:2], run["results"],
                               dev)

    def dec(p, impl, forced=None, dtype=torch.bfloat16):
        return routed_decode(torch, tm, moe_mod, p, cfg, toks, impl, dtype,
                             forced)

    d_kern, r_dk = dec(params, "flash")
    top = d_kern.argmax(-1)
    agree = 0
    for i, r in enumerate(run["reqs"][:2]):
        out = run["results"][r.uid]
        P = len(r.prompt)
        agree += int((top[i, P - 1:P - 1 + len(out)].cpu()
                      == torch.tensor(out)).sum())
    d_kern = d_kern[mask]
    d_plain = dec(params, "xla", r_dk)[0][mask]
    r_dp = dec(params, "xla")[1]
    check(bool(torch.isfinite(d_kern).all()),
          f"{cfg.name}: non-finite decode logits")
    de = {"positions": d_kern.shape[0],
          "own_route_flips_kernel_vs_plain":
              int(route_flips(torch, r_dk, r_dp, n_moe).T[mask].sum()),
          "served_tokens": sum(len(run["results"][r.uid])
                               for r in run["reqs"][:2]),
          "served_equal_kernel_chain_argmax": agree}
    line = {"phase": "families_check", "leg": cfg.name, "ok": False,
            "routes": "the kernel path's, in every path"}
    if f32:
        ref = fwd(ref_params, "xla", served_routes)[0]
        pre["own_route_flips_kernel_vs_f32"] = int(route_flips(
            torch, served_routes, fwd(ref_params, "xla")[1], n_moe).sum())
        pre["kernels_max_abs_err_vs_f32"] = max(
            (kern - ref).abs().max().item(),
            (served - ref[last]).abs().max().item())
        pre["plain_bf16_max_abs_err_vs_f32"] = (plain - ref).abs().max(
            ).item()
        del ref
        d_ref = dec(ref_params, "xla", r_dk, torch.float32)[0][mask]
        de["kernels_max_abs_err_vs_f32"] = (d_kern - d_ref).abs().max(
            ).item()
        de["plain_bf16_max_abs_err_vs_f32"] = (d_plain - d_ref).abs().max(
            ).item()
        line.update(prefill=pre, decode=de, ratio_limit=BF16_ERR_RATIO)
        for what, e in (("prefill", pre), ("decode", de)):
            check(e["kernels_max_abs_err_vs_f32"]
                  <= BF16_ERR_RATIO * e["plain_bf16_max_abs_err_vs_f32"],
                  f"{cfg.name} bf16 {what} logits: the kernels' error "
                  f"exceeds {BF16_ERR_RATIO} x the plain bf16 path's: "
                  f"{line}")
    else:
        pre["scaled_err"] = scaled_err(torch, kern, plain)
        pre["served_scaled_err"] = scaled_err(torch, served, plain[last])
        pre["flip_limit"] = LLAMA4_FLIP_SHARE * pre["positions"]
        de["scaled_err"] = scaled_err(torch, d_kern, d_plain)
        de["flip_limit"] = LLAMA4_FLIP_SHARE * de["positions"]
        line.update(prefill=pre, decode=de, scaled_tol=LLAMA4_SCALED_TOL)
        for e in (pre, de):
            check(e["own_route_flips_kernel_vs_plain"] <= e["flip_limit"],
                  f"{cfg.name} bf16 route flips: {line}")
            check(max(e["scaled_err"], e.get("served_scaled_err", 0.0))
                  <= LLAMA4_SCALED_TOL, f"{cfg.name} bf16 logits: {line}")
    line["ok"] = True
    emit(line)


def ring_check(torch, np, tm, cfg, run, dev):
    """A windowed float32 leg's ring buffer past its wrap, at full width:
    two served requests teacher-forced through ``decode_step`` (K7) on a
    cache of ``RING_CHECK_LEN`` positions, shorter than each request, so
    ``slot = pos % S`` wraps, against ``forward(impl="xla")`` with the
    window set to S (what a ring of S positions keeps), within
    ``LM_TOL``."""
    S = RING_CHECK_LEN
    toks, mask = forced_tokens(torch, np, run["reqs"][:2], run["results"],
                               dev)
    check(int(mask.sum(1).min()) > S, f"{cfg.name}: a request of at most "
                                      f"{S} tokens does not wrap the ring")
    got = decode_chain(torch, tm, run["params"], cfg, toks, S, "flash",
                       torch.float32)[mask]
    plain, _ = tm.forward(run["params"],
                          dataclasses.replace(cfg, attn_window=S),
                          {"tokens": toks}, impl="xla")
    check(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite ring "
                                           f"decode logits")
    err = (got - plain[mask]).abs().max().item()
    line = {"phase": "families_check", "leg": cfg.name, "what": "ring wrap",
            "ok": err <= LM_TOL, "ring_len": S,
            "request_lengths": mask.sum(1).tolist(),
            "positions": got.shape[0], "max_abs_err": err, "tol": LM_TOL}
    check(line["ok"], f"{cfg.name}: ring decode differs from the windowed "
                      f"plain forward: {line}")
    emit(line)


def families_phase(torch, np, tm, step, serving, kernels, kf, kd, moe_mod,
                   get_arch, dev, seed):
    """The ``family_kernel_rows`` lines, then each of ``FAMILY_LEGS`` at
    full width with random weights from the seed: ``lm_phase`` (a timed
    prefill, 8 requests on an 8-slot engine) with its counts set to 0
    just before and read just after, a traced decode step, K6 and K7 at
    the shapes the leg gave them (``lm_kernel_rows``, attention legs),
    and the leg's checks (float32: ``lm_check`` on two requests, and
    ``ring_check`` where the attention is windowed; bfloat16:
    ``moe_check``)."""
    t_phase = time.perf_counter()
    family_kernel_rows(torch, np, kf, kd, dev, seed)
    for arch, depth, dtype_name, batch, length, prefix in FAMILY_LEGS:
        cfg = get_arch(arch)
        if depth:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        dtype = getattr(torch, dtype_name)
        n_attn = sum(k in tm.ATTN_KINDS for k in tm.layer_kinds(cfg))
        tap = RouteTap(torch, moe_mod) if "moe" in tm.layer_kinds(cfg) \
            else None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        seen, restore = record_attention_calls(kf, kd, max(n_attn, 1))
        try:
            run, metrics = lm_phase(torch, np, tm, step, serving, cfg, dev,
                                    seed, prompt_len=length, batch=batch,
                                    prefix_rows=prefix, dtype=dtype,
                                    prefill_ctx=tap, **FAMILY_SERVE)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        finally:
            restore()
        emit({"phase": "families", "leg": arch, "cut_to_layers": depth,
              **metrics, "launches": launches,
              "seconds": time.perf_counter() - t0})
        family_launch_check(tm, cfg, dtype, launches, arch)
        check(bool(torch.isfinite(run["prefill_logits"]).all()),
              f"{arch}: non-finite prefill logits")
        eng = run["engine"]
        emit({"phase": "families_trace", "leg": arch,
              "what": "engine decode step, 8 slots",
              **device_busy(torch, lambda: eng.step_fn(
                  run["params"], eng.cur_tok, eng.cache, eng.lens,
                  eng.generator), 3)})
        if n_attn:
            lm_kernel_rows(torch, np, kf, kd, seen, eng, case=arch)
        del seen, eng
        if dtype == torch.float32:
            lm_check(torch, np, tm, cfg, run, dev, n_check=2,
                     phase="families_check", leg=arch)
            if cfg.attn_window:
                ring_check(torch, np, tm, cfg, run, dev)
        else:
            moe_check(torch, np, tm, moe_mod, cfg, run, tap.routes, dev)
        run = tap = None
        torch.cuda.empty_cache()
    emit({"phase": "families_done", "seconds": time.perf_counter() - t_phase})


# the training phase (16): legs and their sizes
TRAIN_ARCH = "llama3p2_1b"
TRAIN_LEG = dict(seq_len=1024, global_batch=8, steps=6)
TRAIN_SSM_ARCH = "mamba2_780m"
TRAIN_SSM_LEG = dict(seq_len=512, global_batch=2, steps=2)
TRAIN_RESTART_LEG = dict(seq_len=512, global_batch=8, steps=12, ckpt_every=4,
                         stop_at=8)
# twelve steps: on the launcher's graph (power_law(2000, 6.0, seed=1),
# k = 5) only some batches find a path in their 32 draws (steps 5 and 10
# of these), the rest are all EOS, as in repro (ROADMAP.md §3)
TRAIN_CORPUS_ARGS = ["--preset", "lm100m", "--data", "path_corpus",
                     "--steps", "12", "--batch", "8", "--seq", "128"]
# microbatches=2 against 1 on the same first step: float32 sums of two
# half-batch gradients against one (the mean over the same tokens)
TRAIN_MB_LOSS_RTOL = 1e-5
TRAIN_MB_GNORM_RTOL = 1e-4
# a restart against an uninterrupted run: entries with a real gradient
# are held within this fraction of the summed learning rate (the CPU
# tests' rule, tests/test_torch_training.py), unless two fresh runs of
# the card already differ by more (the embedding's backward accumulates
# with atomics, whose order changes from run to run): then within
# TRAIN_RESTART_SPREAD times that measured spread
TRAIN_RESTART_LR_FRACTION = 1e-2
TRAIN_RESTART_SPREAD = 4.0


def tree_max_diff(torch, tree_mod, a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(tree_mod.leaves(a), tree_mod.leaves(b)))


def train_log_summary(np, tr, tokens_per_step):
    """A trainer's losses, grad norms and step seconds from its
    ``metrics_log`` (every step logged); the median over steps 2 on."""
    log = tr.metrics_log
    secs = [r["sec_per_step"] for r in log]
    steady = statistics.median(secs[1:]) if len(secs) > 1 else secs[0]
    for r in log:
        check(bool(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])),
              f"non-finite loss or grad_norm at step {r['step']}")
    return {"loss": [r["loss"] for r in log],
            "grad_norm": [r["grad_norm"] for r in log],
            "lr": [r["lr"] for r in log], "sec_per_step": secs,
            "median_sec_per_step": steady,
            "tokens_per_s": tokens_per_step / steady,
            "stragglers": tr.straggler_steps}


def train_leg(torch, np, tr_mod, adamw, pipe, tm, tree_mod, step_mod,
              get_arch, dev, seed):
    """``train``: TRAIN_ARCH at full width and depth, float32 parameters
    and AdamW state, remat on, through ``Trainer.fit``; then the first
    step again with ``microbatches=2`` against 1, and a traced step.
    Returns the median seconds a step."""
    cfg = get_arch(TRAIN_ARCH)
    leg = TRAIN_LEG
    data = pipe.SyntheticLM(vocab=cfg.vocab, seq_len=leg["seq_len"],
                            global_batch=leg["global_batch"], seed=seed)
    opt_cfg = adamw.OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                                    total_steps=leg["steps"])
    tcfg = tr_mod.TrainerConfig(steps=leg["steps"], log_every=1, seed=seed,
                                device=dev)
    probe = tm.init_params(cfg, seed, device=dev)
    before = {k: probe[k][:8].clone() for k in ("embed",)}
    before["wq0"] = probe["layers"][0]["attn"]["wq"][:8].clone()
    n_params = sum(x.numel() for x in tree_mod.leaves(probe))
    del probe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = tr_mod.Trainer(cfg, opt_cfg, tcfg)
    t0 = time.perf_counter()
    params, opt_state = tr.fit(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    moved = (not torch.equal(before["embed"], params["embed"][:8])
             and not torch.equal(before["wq0"],
                                 params["layers"][0]["attn"]["wq"][:8]))
    check(moved, "train: the parameters did not move")
    tokens = leg["seq_len"] * leg["global_batch"]
    summary = train_log_summary(np, tr, tokens)
    emit({"phase": "train", "leg": "train", "arch": cfg.name,
          "params": n_params, "dtype": "float32", "remat": cfg.remat,
          "tokens_per_step": tokens, **summary, "fit_s": fit_s,
          "peak_memory_allocated": peak, "params_moved": moved})
    train_sec = summary["median_sec_per_step"]
    del params, opt_state, tr
    torch.cuda.empty_cache()

    # the first step with microbatches=2 against 1, then a traced step
    p0 = tm.init_params(cfg, seed, device=dev)
    st = adamw.init(p0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(0).items()}
    got = {}
    for mb in (1, 2):
        fn = step_mod.make_train_step(cfg, opt_cfg, microbatches=mb)
        _, _, m = fn(p0, st, batch)
        got[mb] = {k: float(v) for k, v in m.items()}
    loss_rel = abs(got[2]["loss"] - got[1]["loss"]) / abs(got[1]["loss"])
    gn_rel = abs(got[2]["grad_norm"] - got[1]["grad_norm"]) \
        / got[1]["grad_norm"]
    fn = step_mod.make_train_step(cfg, opt_cfg)
    trace = device_busy(torch, lambda: fn(p0, st, batch), 1)
    emit({"phase": "train", "leg": "train_microbatches",
          "mb1": got[1], "mb2": got[2], "loss_rel": loss_rel,
          "grad_norm_rel": gn_rel, "fit_step0_loss": summary["loss"][0],
          "trace": trace})
    check(loss_rel <= TRAIN_MB_LOSS_RTOL,
          f"train: microbatches=2 loss off by {loss_rel}")
    check(gn_rel <= TRAIN_MB_GNORM_RTOL,
          f"train: microbatches=2 grad_norm off by {gn_rel}")
    del p0, st, batch, fn
    torch.cuda.empty_cache()
    return train_sec


def train_ssm_leg(torch, np, tr_mod, adamw, pipe, get_arch, dev, seed):
    """``train_ssm``: TRAIN_SSM_ARCH at full width (48 SSD layers, chunks
    of 128), float32, through ``Trainer.fit``."""
    cfg = get_arch(TRAIN_SSM_ARCH)
    leg = TRAIN_SSM_LEG
    data = pipe.SyntheticLM(vocab=cfg.vocab, seq_len=leg["seq_len"],
                            global_batch=leg["global_batch"], seed=seed)
    tr = tr_mod.Trainer(cfg, adamw.OptimizerConfig(
        peak_lr=3e-4, warmup_steps=1, total_steps=leg["steps"]),
        tr_mod.TrainerConfig(steps=leg["steps"], log_every=1, seed=seed,
                             device=dev))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr.fit(data)
    torch.cuda.synchronize()
    emit({"phase": "train", "leg": "train_ssm", "arch": cfg.name,
          "ssm_chunk": cfg.ssm_chunk, "layers": cfg.num_layers,
          **train_log_summary(np, tr, leg["seq_len"] * leg["global_batch"]),
          "fit_s": time.perf_counter() - t0,
          "peak_memory_allocated": torch.cuda.max_memory_allocated(dev)})
    torch.cuda.empty_cache()


def train_restart_leg(torch, np, tr_mod, adamw, pipe, ckpt_mod, tree_mod,
                      lm100m, dev, seed):
    """``train_restart``: the lm100m preset, ``ckpt_every`` checkpoints
    into a temporary directory (deleted afterwards), a second Trainer
    that resumes, and two uninterrupted runs (their spread sets the
    tolerance)."""
    import shutil
    import signal
    import tempfile

    leg = TRAIN_RESTART_LEG
    data = pipe.SyntheticLM(vocab=lm100m.vocab, seq_len=leg["seq_len"],
                            global_batch=leg["global_batch"], seed=seed)
    opt_cfg = adamw.OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                    total_steps=leg["steps"])

    def trainer(steps, ckpt_dir=None):
        return tr_mod.Trainer(lm100m, opt_cfg, tr_mod.TrainerConfig(
            steps=steps, ckpt_every=leg["ckpt_every"], ckpt_dir=ckpt_dir,
            log_every=1, seed=seed, device=dev))

    tmp = tempfile.mkdtemp(prefix="train_restart_")
    t0 = time.perf_counter()
    try:
        first = trainer(leg["stop_at"], tmp)
        p_stop, o_stop = first.fit(data)
        mgr = ckpt_mod.CheckpointManager(tmp)
        t1 = time.perf_counter()
        trees, manifest = mgr.restore(leg["stop_at"],
                                      {"params": p_stop, "opt": o_stop})
        restore_s = time.perf_counter() - t1
        saved = tree_mod.leaves({"params": p_stop, "opt": o_stop})
        back = tree_mod.leaves(trees)
        bitwise = all(a.dtype == b.dtype and a.device == b.device
                      and torch.equal(a, b) for a, b in zip(back, saved))
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(mgr.directory)
                         for f in fs if dp.endswith(
                             f"step-{leg['stop_at']:010d}"))
        del trees, back, saved, p_stop, o_stop
        second = trainer(leg["steps"], tmp)
        p_resumed, _ = second.fit(data)
        resumed_at = second.metrics_log[0]["step"]
        latest = mgr.latest_step()
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        shutil.rmtree(tmp, ignore_errors=True)
    ckpt_s = time.perf_counter() - t0
    fresh = [trainer(leg["steps"]) for _ in range(2)]
    p_a, _ = fresh[0].fit(data)
    p_b, _ = fresh[1].fit(data)
    spread = tree_max_diff(torch, tree_mod, p_a, p_b)
    restart_diff = tree_max_diff(torch, tree_mod, p_resumed, p_a)
    lr_total = sum(r["lr"] for r in fresh[0].metrics_log)
    tol = max(TRAIN_RESTART_LR_FRACTION * lr_total,
              TRAIN_RESTART_SPREAD * spread)
    losses_equal = [r["loss"] for r in second.metrics_log] == [
        r["loss"] for r in fresh[0].metrics_log[leg["stop_at"]:]]
    emit({"phase": "train", "leg": "train_restart", "arch": lm100m.name,
          "stop_at": leg["stop_at"], "steps": leg["steps"],
          "resumed_at": resumed_at, "latest_step": latest,
          "checkpoint_bytes": ckpt_bytes, "restore_s": restore_s,
          "restored_bit_identical": bitwise,
          "manifest_extra": manifest["extra"],
          "fresh_spread_max_abs": spread,
          "restart_max_abs_diff": restart_diff, "tolerance": tol,
          "lr_total": lr_total, "resumed_losses_equal_fresh": losses_equal,
          "checkpointed_runs_s": ckpt_s,
          "sec_per_step": statistics.median(
              r["sec_per_step"] for r in fresh[0].metrics_log[1:])})
    check(bitwise, "train_restart: the restored tree differs from the saved")
    check(resumed_at == leg["stop_at"],
          f"train_restart: resumed at {resumed_at}, not {leg['stop_at']}")
    check(latest == leg["steps"], f"train_restart: latest step {latest}")
    check(restart_diff <= tol,
          f"train_restart: restart off by {restart_diff} (tolerance {tol})")
    del p_a, p_b, p_resumed, fresh
    torch.cuda.empty_cache()


def train_corpus_leg(torch, kernels, pipe, train_main, tc, dev):
    """``train_corpus``: ``launch.train.main`` on the lm100m preset with
    ``--data path_corpus`` on the card (its PathCorpus walks on K1's hop
    entry), then the corpus's batches on the card against the CPU's."""
    import io
    import tempfile

    before = kernels.launch_counts()
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "metrics.json")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train_main(TRAIN_CORPUS_ARGS + ["--device", str(dev),
                                            "--metrics-out", metrics])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(metrics) as fh:
            rec = json.load(fh)
    after = kernels.launch_counts()
    launches = {n: after[n] - before[n] for n in PATHENUM_KERNELS}
    steps = int(TRAIN_CORPUS_ARGS[TRAIN_CORPUS_ARGS.index("--steps") + 1])
    seq = int(TRAIN_CORPUS_ARGS[TRAIN_CORPUS_ARGS.index("--seq") + 1])
    batch = int(TRAIN_CORPUS_ARGS[TRAIN_CORPUS_ARGS.index("--batch") + 1])
    g = tc.power_law(2000, 6.0, seed=1)
    corpora = [pipe.PathCorpus(graph=g, k=5, seq_len=seq, global_batch=batch,
                               device=d) for d in (dev, "cpu")]
    same = all(
        a[key].tobytes() == b[key].tobytes()
        for s in range(steps)
        for a, b in [(corpora[0].batch_at(s), corpora[1].batch_at(s))]
        for key in ("tokens", "labels"))
    with_paths = [s for s in range(steps)
                  if (corpora[1].batch_at(s)["tokens"] == pipe.BOS).any()]
    emit({"phase": "train", "leg": "train_corpus", "args": TRAIN_CORPUS_ARGS,
          "params": rec["params"], "log": rec["log"], "wall_s": wall,
          "stdout_lines": len(out.getvalue().splitlines()),
          "launches": launches, "batches_equal_cpu": same,
          "steps_with_paths": with_paths})
    check(all(torch.isfinite(torch.tensor(r["loss"])) for r in rec["log"]),
          "train_corpus: non-finite loss")
    check(same, "train_corpus: PathCorpus on the card differs from the CPU")
    check(launches["frontier_hop"] > 0,
          "train_corpus: K1's hop entry never launched")


def train_phase(torch, np, kernels, kf, kd, tc, get_arch, dev, seed):
    """Phase 16: LM training on the card (``train``, ``train_ssm``,
    ``train_restart``, ``train_corpus``), counts from 0 before it and
    read after it, then ``train_check``.  Returns the ``train`` leg's
    median seconds a step."""
    from repro_torch import tree as tree_mod
    from repro_torch.checkpoint import manager as ckpt_mod
    from repro_torch.data import pipeline as pipe
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as tm
    from repro_torch.optim import adamw
    from repro_torch.training import step as step_mod
    from repro_torch.training import trainer as tr_mod

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    train_sec = train_leg(torch, np, tr_mod, adamw, pipe, tm, tree_mod,
                          step_mod, get_arch, dev, seed)
    train_ssm_leg(torch, np, tr_mod, adamw, pipe, get_arch, dev, seed)
    lm100m = train_launch.build_arch(argparse.Namespace(preset="lm100m",
                                                        arch=None))
    train_restart_leg(torch, np, tr_mod, adamw, pipe, ckpt_mod, tree_mod,
                      lm100m, dev, seed)
    train_corpus_leg(torch, kernels, pipe, train_launch.main, tc, dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()

    refused = {}
    q = torch.randn(1, 64, 2, 64, device=dev, requires_grad=True)
    k = torch.randn(1, 64, 1, 64, device=dev)
    lengths = torch.full((1,), 64, dtype=torch.int32, device=dev)
    for name, call in (
            ("flash_attention", lambda: kf.flash_attention(q, k, k)),
            ("decode_attention", lambda: kd.decode_attention(
                q[:, 0].detach().contiguous().requires_grad_(True), k, k,
                lengths))):
        try:
            call()
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "no backward" in str(e)
    emit({"phase": "train_check", "launches": launches,
          "refused_under_grad": refused,
          "seconds": time.perf_counter() - t_phase})
    for name in LM_KERNELS + LM_BF16_KERNELS:
        check(launches[name] == 0, f"{name} launched in the train phase")
    for name, ok in refused.items():
        check(ok, f"{name} did not refuse CUDA inputs that require grad")
    return train_sec


# phase 17: the LM's mesh layout (DTensor) on the card
SHARD_TRAIN_STEPS = 4
SHARD_TRAIN_RTOL = 1e-6          # one rank: every redistribute is a no-op
SHARD_SERVE = dict(prompt_len=2048, batch=2, slots=8, decode_steps=16,
                   max_len=64)
SHARD_SERVE_TOL = 2e-5           # lm_check's kernels against themselves
DRYRUN_CELLS = (("llama3p2_1b", "train_4k", "single"),
                ("qwen3_moe_30b_a3b", "decode_32k", "single"),
                ("mamba2_780m", "long_500k", "multi"))
DRYRUN_TIMEOUT = 400.0
# dryrun_check: the dry run's peak estimate over the card's measured peak
# of the same step must lie in this range (its live-storage count is the
# same program's; the allocator rounds blocks and caches nothing here)
DRYRUN_PEAK_RATIO = (0.5, 2.0)


def dryrun_worker(args) -> None:
    """One dry-run cell (``--dryrun-cell``, a JSON list of ``run_cell``'s
    arch, shape and mesh, and for the check cell the mesh shape, sequence
    length and batch of ``shard_train``): its record to
    ``--dryrun-out``.  Runs on meta tensors over a fake process group; it
    touches no card."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    spec = json.loads(args.dryrun_cell)
    t0 = time.perf_counter()
    if len(spec) == 3:
        rec = dryrun.run_cell(*spec)
    else:
        arch, shape, mesh, mesh_shape, seq, batch = spec
        rec = dryrun.run_cell(arch, shape, mesh, mesh_shape=mesh_shape,
                              cfg=get_arch(arch),
                              shape=ShapeConfig("shard_train", seq, batch,
                                                "train"),
                              dtype=torch.float32)
    dryrun.release_fake_group()
    rec["wall_s"] = time.perf_counter() - t0
    with open(args.dryrun_out, "w") as fh:
        json.dump(rec, fh, default=float)


def start_dryruns(tmp):
    """The ``dryrun`` cells and ``dryrun_check``'s, each in a process of
    its own, started together; they run on the host while the card
    trains."""
    cells = {f"{a}__{s}__{m}": [a, s, m] for a, s, m in DRYRUN_CELLS}
    cells["check"] = [TRAIN_ARCH, "train_4k", "single", [1, 1],
                      TRAIN_LEG["seq_len"], TRAIN_LEG["global_batch"]]
    procs = {}
    for name, spec in cells.items():
        out = str(Path(tmp) / f"{name}.json")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-cell",
             json.dumps(spec), "--dryrun-out", out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    return procs


def stop(procs) -> None:
    for p, _out in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def collect_dryruns(procs, started):
    """Each cell's record; a cell that fails, or is not done
    DRYRUN_TIMEOUT seconds after ``started``, fails the script."""
    recs = {}
    for name, (p, out) in procs.items():
        try:
            _so, se = p.communicate(timeout=max(
                DRYRUN_TIMEOUT - (time.perf_counter() - started), 1.0))
        except subprocess.TimeoutExpired:
            stop(procs)
            fail(f"dryrun {name}: not done {DRYRUN_TIMEOUT} s after the "
                 f"phase began")
        check(p.returncode == 0,
              f"dryrun {name} exited {p.returncode}: {se[-3000:]}")
        with open(out) as fh:
            recs[name] = json.load(fh)
        check(recs[name]["status"] == "ok", f"dryrun {name}: {recs[name]}")
    return recs


def tree_nbytes(tree_mod, tree) -> int:
    """The bytes a rank holds of a tree's tensors (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor
    return sum((x.to_local() if isinstance(x, DTensor) else x).nbytes
               for x in tree_mod.leaves(tree))


def shard_train_leg(torch, np, mesh, dev, seed, train_sec):
    """``shard_train``: TRAIN_ARCH at full width and depth through
    ``Trainer(mesh=)`` on the 1 x 1 NCCL mesh, against an unsharded
    Trainer from the same seed; a traced step; then the numbers
    ``dryrun_check`` holds the dry run to."""
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree as tree_mod
    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline as pipe
    from repro_torch.distributed import constraints as con
    from repro_torch.optim import adamw
    from repro_torch.training import trainer as tr_mod

    cfg = get_arch(TRAIN_ARCH)
    leg = TRAIN_LEG
    data = pipe.SyntheticLM(vocab=cfg.vocab, seq_len=leg["seq_len"],
                            global_batch=leg["global_batch"], seed=seed)
    opt_cfg = adamw.OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                                    total_steps=SHARD_TRAIN_STEPS)

    def trainer(mesh=None):
        return tr_mod.Trainer(cfg, opt_cfg, tr_mod.TrainerConfig(
            steps=SHARD_TRAIN_STEPS, log_every=1, seed=seed, device=dev),
            mesh=mesh)

    plain = trainer()
    p0, o0 = plain.fit(data)
    del o0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sharded = trainer(mesh)
    t0 = time.perf_counter()
    p1, o1 = sharded.fit(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated(dev)
    all_dtensor = all(isinstance(x, DTensor)
                      for x in tree_mod.leaves((p1, o1)))
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(sharded.metrics_log, plain.metrics_log))
    param_rel = max(float((a.full_tensor() - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(tree_mod.leaves(p1), tree_mod.leaves(p0)))
    del p0
    torch.cuda.empty_cache()

    batch = sharded._batch(data.batch_at(0))

    def step():
        with con.use_mesh(mesh):
            return sharded.step_fn(p1, o1, batch)
    trace = device_busy(torch, step, 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with FlopCounterMode(display=False) as fc:
        out = step()
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated(dev)
    del out
    arg_bytes = tree_nbytes(tree_mod, (p1, o1, batch))
    summary = train_log_summary(
        np, sharded, leg["seq_len"] * leg["global_batch"])
    plain_summary = train_log_summary(
        np, plain, leg["seq_len"] * leg["global_batch"])
    emit({"phase": "shard", "leg": "shard_train", "arch": cfg.name,
          "mesh": [1, 1], "backend": "nccl", "steps": SHARD_TRAIN_STEPS,
          "tokens_per_step": leg["seq_len"] * leg["global_batch"],
          "all_leaves_dtensor": all_dtensor,
          "loss": summary["loss"], "plain_loss": plain_summary["loss"],
          "median_sec_per_step": summary["median_sec_per_step"],
          "plain_median_sec_per_step": plain_summary["median_sec_per_step"],
          "train_leg_median_sec_per_step": train_sec,
          "tokens_per_s": summary["tokens_per_s"], "fit_s": fit_s,
          "peak_memory_allocated": fit_peak,
          "max_loss_rel_diff": loss_rel, "max_param_rel_diff": param_rel,
          "trace": trace})
    check(all_dtensor, "shard_train: a parameter or state leaf is no "
                       "DTensor")
    check(loss_rel <= SHARD_TRAIN_RTOL,
          f"shard_train: loss off the unsharded Trainer's by {loss_rel}")
    check(param_rel <= SHARD_TRAIN_RTOL,
          f"shard_train: parameters off the unsharded Trainer's by "
          f"{param_rel}")
    del p1, o1, batch
    torch.cuda.empty_cache()
    return {"argument_bytes": arg_bytes,
            "flops": float(fc.get_total_flops()),
            "step_peak_bytes": step_peak,
            "step_peak_above_args": step_peak - base}


def shard_serve_leg(torch, np, kernels, mesh, dev, seed):
    """``shard_serve``: LM_ARCH (the ``lm`` phase's config and weights)
    with DTensor parameters, batch and cache on the 1 x 1 mesh: a prefill
    and SHARD_SERVE's decode steps, K6 and K7 on local shards through
    ``local_map``, against the unsharded kernel path."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import constraints as con
    from repro_torch.distributed import sharding as S
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tm
    from repro_torch.training import step as step_mod

    cfg = get_arch(LM_ARCH)
    sv = SHARD_SERVE
    params = tm.init_params(cfg, seed, device=dev)
    rng = np.random.default_rng(seed + 23)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (sv["batch"], sv["prompt_len"])).astype(np.int32)).to(
            dev)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (sv["decode_steps"], sv["slots"])).astype(
            np.int32)).to(dev)
    prefill = step_mod.make_prefill(cfg)
    serve = step_mod.make_serve_step(cfg)

    def run(params, place):
        batch = place({"tokens": prompt}, "batch")
        cache = place(tm.init_cache(cfg, sv["slots"], sv["max_len"],
                                    device=dev), "cache")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _kv, _ = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out = [logits]
        t0 = time.perf_counter()
        for i in range(sv["decode_steps"]):
            tok = place(toks[i], "batch")
            lens = place(torch.full((sv["slots"],), i, dtype=torch.int32,
                                    device=dev), "batch")
            _nxt, cache, lg = serve(params, tok, cache, lens)
            out.append(lg)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        full = [x.full_tensor() if hasattr(x, "full_tensor") else x
                for x in out]
        return full, prefill_s, decode_s

    rules = {"batch": lambda t: S.batch_shardings(mesh, t),
             "cache": lambda t: S.cache_shardings(mesh, cfg, t)}

    def place(tree, kind):
        return S.distribute_tree(tree, mesh, rules[kind](tree))
    dparams = S.distribute_tree(params, mesh,
                                S.param_shardings(mesh, cfg, params))
    kernels.reset_launch_counts()
    routes0 = dict(attn_mod.mesh_routes)
    with con.use_mesh(mesh):
        got, prefill_s, decode_s = run(dparams, place)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    routes = {k: v - routes0[k] for k, v in attn_mod.mesh_routes.items()}
    want, plain_prefill_s, plain_decode_s = run(params, lambda t, _k: t)
    err_prefill = max_abs_err(torch, got[0], want[0])
    err_decode = max(max_abs_err(torch, a, b)
                     for a, b in zip(got[1:], want[1:]))
    tokens = sv["batch"] * sv["prompt_len"]
    emit({"phase": "shard", "leg": "shard_serve", "arch": cfg.name,
          "mesh": [1, 1], "dtype": "float32", "prompt": [sv["batch"],
                                                         sv["prompt_len"]],
          "slots": sv["slots"], "decode_steps": sv["decode_steps"],
          "prefill_s": prefill_s, "plain_prefill_s": plain_prefill_s,
          "prefill_tokens_per_s": tokens / prefill_s,
          "decode_ms_per_step": decode_s / sv["decode_steps"] * 1e3,
          "plain_decode_ms_per_step":
              plain_decode_s / sv["decode_steps"] * 1e3,
          "launches": {n: launches[n] for n in LM_KERNELS},
          "routes": routes, "prefill_max_abs_err": err_prefill,
          "decode_max_abs_err": err_decode, "tolerance": SHARD_SERVE_TOL})
    for name in LM_KERNELS:
        check(launches[name] > 0, f"shard_serve: {name} never launched")
    check(routes["plain"] == 0 and routes["local_kernel"]
          == cfg.num_layers * (1 + sv["decode_steps"]),
          f"shard_serve: attention routes {routes}")
    check(err_prefill <= SHARD_SERVE_TOL and err_decode <= SHARD_SERVE_TOL,
          f"shard_serve: logits off the unsharded kernel path by "
          f"{err_prefill}, {err_decode}")
    del params, dparams
    torch.cuda.empty_cache()
    return launches


def dryrun_lines(recs):
    """The ``dryrun`` lines: each production cell's record."""
    for name, rec in recs.items():
        if name == "check":
            continue
        emit({"phase": "shard", "leg": "dryrun", "cell": name,
              "status": rec["status"], "chips": rec["chips"],
              "flops_per_device": rec["cost"]["flops_per_device"],
              "argument_bytes": rec["memory"]["argument_bytes"],
              "peak_estimate_bytes": rec["memory"]["peak_estimate_bytes"],
              "collectives_per_device_bytes":
                  rec["collectives_per_device_bytes"],
              "cost_source": rec["cost_source"],
              "param_spec_sample": rec["param_spec_sample"],
              "wall_s": rec["wall_s"]})


def dryrun_check(rec, measured):
    """``dryrun_check``: the dry run of ``shard_train``'s config and shape
    on a (1, 1) fake mesh against the step measured on the card."""
    mem = rec["memory"]
    ratio = mem["peak_estimate_bytes"] / measured["step_peak_bytes"]
    emit({"phase": "shard", "leg": "dryrun_check", "mesh": [1, 1],
          "argument_bytes": mem["argument_bytes"],
          "card_argument_bytes": measured["argument_bytes"],
          "flops": rec["cost"]["flops_per_device"],
          "flop_counter_flops": measured["flops"],
          "peak_estimate_bytes": mem["peak_estimate_bytes"],
          "max_memory_allocated": measured["step_peak_bytes"],
          "peak_ratio": ratio, "peak_ratio_bound": DRYRUN_PEAK_RATIO,
          "temp_bytes": mem["temp_bytes"],
          "measured_above_args": measured["step_peak_above_args"]})
    check(mem["argument_bytes"] == measured["argument_bytes"],
          f"dryrun_check: argument bytes {mem['argument_bytes']} against "
          f"{measured['argument_bytes']} on the card")
    check(rec["cost"]["flops_per_device"] == measured["flops"],
          f"dryrun_check: {rec['cost']['flops_per_device']} FLOPs against "
          f"FlopCounterMode's {measured['flops']}")
    check(DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1],
          f"dryrun_check: peak estimate {ratio:.3f} times the measured")


def shard_phase(torch, np, kernels, dev, seed, train_sec):
    """Phase 17: the LM's mesh layout.  The dry-run cells start in
    processes of their own; then ``shard_train`` and ``shard_serve`` on
    a 1 x 1 NCCL mesh (launch counts from 0 before each leg, read after),
    the ``dryrun`` lines and ``dryrun_check``.  A 1 x 2 gloo mesh of two
    processes on the card is left out: DTensor's functional collectives
    crash over gloo on CUDA tensors (PERF.md §7,
    ``tools/gloo_cuda_collectives.py``)."""
    import tempfile

    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_dryruns(tmp)
        try:
            mesh = make_local_mesh(device=dev)
            try:
                kernels.reset_launch_counts()
                measured = shard_train_leg(torch, np, mesh, dev, seed,
                                           train_sec)
                train_launches = kernels.launch_counts()
                serve_launches = shard_serve_leg(torch, np, kernels, mesh,
                                                 dev, seed)
            finally:
                tdist.destroy_process_group()
        except BaseException:
            stop(procs)
            raise
        recs = collect_dryruns(procs, t_phase)
        dryrun_lines(recs)
        dryrun_check(recs["check"], measured)
    emit({"phase": "shard_check", "ok": True,
          "train_launches": {n: train_launches[n] for n in LM_KERNELS},
          "serve_launches": {n: serve_launches[n] for n in LM_KERNELS},
          "seconds": time.perf_counter() - t_phase})
    for name in LM_KERNELS:
        check(train_launches[name] == 0,
              f"{name} launched in shard_train")
    return serve_launches


# the examples phase: the launch counts each example must show on the
# card (each above 0), as the wrappers reached them on the CPU; an empty
# tuple means no kernel may launch.  ``bfs_dense`` and ``frontier_hop``
# are K4's and K1's own entries (``minplus_spmv`` and ``frontier_masks``
# count their launches too)
EXAMPLE_KERNELS = {
    "quickstart": ("bfs_dense", "counting_spmm", "frontier_hop"),
    "fraud_detection": (),
    "batch_serving": ("frontier_fused_masks", "frontier_deque_round"),
    "multi_tenant_serving": ("frontier_fused_masks", "frontier_deque_round",
                             "frontier_hop"),
    "async_serving": ("bfs_dense", "counting_spmm", "frontier_fused_masks"),
    "streaming_serving": ("frontier_fused_masks",),
    "kg_completion": ("frontier_hop",),
    "serve_batch": ("decode_attention",),
    "train_lm": (),
}


def example_launch_check(name, launches) -> None:
    """The kernels ``EXAMPLE_KERNELS`` names for ``name`` launched; none
    at all where it names none; no attention kernel in a PathEnum
    example or in kg_completion (training takes plain attention)."""
    want = EXAMPLE_KERNELS[name]
    for kernel in want:
        check(launches[kernel] > 0,
              f"{kernel} never launched in example {name}")
    if not want:
        check(not any(launches.values()),
              f"example {name} launched {launches}")
    if name != "serve_batch":
        for kernel in LM_KERNELS + LM_BF16_KERNELS:
            check(launches[kernel] == 0,
                  f"{kernel} launched in example {name}")


def example_summary(name, values) -> dict:
    """A few of an LM example's returned values for its line."""
    if name == "kg_completion":
        return {"first": values["first"], "last": values["last"]}
    if name == "serve_batch":
        return {k: values[k] for k in ("requests", "tokens", "engine_steps")}
    if name == "train_lm":
        log = values["log"]
        return {"params": values["params"], "steps": values["steps"],
                "first_loss": log[0]["loss"], "last_loss": log[-1]["loss"]}
    return {}


def examples_phase(torch, kernels, dev, smi) -> dict:
    """Phase 18: the nine examples (``repro_torch.examples``, ``repro``'s
    ``examples/*.py``) through their ``main`` on ``dev``, launch counts
    set to 0 just before each and read just after it; what they print
    goes to stderr.  Each must return (its own asserts hold) and launch
    the kernels ``EXAMPLE_KERNELS`` names; each PathEnum example's
    returned values must equal its ``--device cpu`` run's, which calls
    the plain versions, but for the values ``examples.CLOCK_BOUND``
    names.  Returns the launches of each example."""
    import importlib

    from repro_torch import examples

    seen = {}
    t_phase = time.perf_counter()
    for name in examples.NAMES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        torch.cuda.empty_cache()
        with contextlib.redirect_stdout(sys.stderr):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            values = mod.main(["--device", dev.type])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = kernels.launch_counts()
            line = {"phase": "examples", "example": name,
                    "seconds": seconds,
                    "launches": {k: v for k, v in launches.items() if v}}
            if name in examples.PATHENUM:
                t0 = time.perf_counter()
                plain = mod.main(["--device", "cpu"])
                line["cpu_seconds"] = time.perf_counter() - t0
                excepted = sorted(examples.CLOCK_BOUND.get(name, {}))
                differ = sorted(k for k in values if k not in excepted
                                and values[k] != plain.get(k))
                check(set(values) == set(plain) and not differ,
                      f"example {name} on the card differs from its "
                      f"--device cpu run in {differ}")
                line.update(equal_cpu=True, excepted=excepted,
                            excepted_values={k: (values[k], plain[k])
                                             for k in excepted})
        emit({**line, **example_summary(name, values), "card": smi})
        example_launch_check(name, launches)
        seen[name] = launches
    emit({"phase": "examples_check", "ok": True, "examples": len(seen),
          "seconds": time.perf_counter() - t_phase})
    return seen


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="vertices of the large graph (average degree 16)")
    ap.add_argument("--queries", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16,
                    help="queries of the batch phase's fused leg")
    # one rank of one of the mesh phase's two-process gloo meshes (the
    # script starts these itself)
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-init", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-data", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-device", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-leg", choices=("gloo2", "split2"),
                    default="gloo2", help=argparse.SUPPRESS)
    # one cell of the shard phase's dry run
    ap.add_argument("--dryrun-cell", help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-out", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device; this script runs the port on the "
             "card and has nothing to run without one")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch is missing: run from a checkout of the repo")
    for var in ("REPRO_DEVICE_ENUM", "REPRO_DEVICE_DEQUE", "REPRO_SHARING"):
        if var in os.environ:
            fail(f"{var} is set; it would move work off the path measured "
                 f"here")
    if args.mesh_rank is not None:
        mesh_worker(args)
        return
    if args.dryrun_cell is not None:
        dryrun_worker(args)
        return
    sys.path.insert(0, str(ROOT / "src"))
    lint_phase()
    import numpy as np

    import repro_torch.core as tc
    from repro_torch import kernels
    from repro_torch.core import enumerate as en
    from repro_torch.core import estimator as est
    from repro_torch.kernels import _build
    from repro_torch.kernels import frontier_expand as fe
    from repro_torch.kernels import ops
    from repro_torch.kernels import semiring_spmm as sr
    from repro_torch import serving
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tm
    from repro_torch.training import step

    # yardsticks and the plain versions run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "build_s": build_s,
          "built": {k: v[0] for k, v in built.items()}})

    t0 = time.perf_counter()
    g = tc.erdos_renyi(args.n, 16.0, seed=args.seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dg = g.to(dev)
    torch.cuda.synchronize()
    emit({"phase": "setup", "n": g.n, "m": g.m, "avg_degree": g.m / g.n,
          "generate_s": gen_s, "to_device_s": time.perf_counter() - t0,
          "graph_device_bytes": dg.memory_bytes()})
    t0 = time.perf_counter()
    picks, probes = pick_large_queries(np, tc, ops, en, est, g,
                                       max(args.queries, args.batch),
                                       args.seed, dev)
    check(len(picks) >= max(args.queries, args.batch, 4),
          f"only {len(picks)} queries qualified in {probes} probes")
    queries = picks[:args.queries]
    shared = shared_queries(tc, est, g, picks, dev)
    emit({"phase": "setup", "queries": [(s, t) for s, t, _ in picks],
          "shared_queries": [(s, t) for s, t, _ in shared[0]],
          "probes": probes, "pick_s": time.perf_counter() - t0})
    g_small = tc.power_law(2000, 6.0, seed=3)

    rows = kernel_phase(torch, np, en, ops, fe, sr, queries[0][2], dev)
    rows["bfs_dense"] = bfs_dense_row(torch, np, tc, est, ops, sr, g_small,
                                      dev)

    # the main path: counts from 0, read right after
    kernels.reset_launch_counts()
    large_runs, largest_hop = large_phase(torch, tc, kernels, g, queries,
                                          dev)
    small_runs = small_phase(np, tc, sr, g_small, dev)
    batch_runs, index_of, largest = batch_phase(
        torch, tc, fe, ops, g, picks, shared, dev, args.batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()

    rows["frontier_fused_masks"] = fused_kernel_row(torch, np, fe, ops, largest,
                                                    dev)
    rows["frontier_fused_hop"] = fused_hop_kernel_row(
        torch, np, fe, ops, largest, dev, rows["frontier_fused_masks"])
    rows["frontier_hop"] = hop_kernel_row(torch, np, fe, ops, largest_hop,
                                          dev)
    check_phase(np, tc, large_runs, small_runs, g_small, dev)
    check_batch(tc, batch_runs, index_of, dev)
    for name in PATHENUM_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    emit({"phase": "check", "ok": True,
          "seconds": time.perf_counter() - t_start})

    # the HcPE front-ends: counts from 0, read right after
    full = {(i.s, i.t): i.result for i in batch_runs[0][2].items}
    lone = next(out.result for s, t, leg, _kw, out, _r in large_runs
                if leg == "paths")
    kernels.reset_launch_counts()
    serve_launches = serve_phase(torch, np, tc, kernels, serving, g, g_small,
                                 picks, full, lone, dev, args.seed)
    for name in SERVE_KERNELS:
        check(serve_launches[name] > 0,
              f"{name} never launched in the serve phase")
    for name in LM_KERNELS + LM_BF16_KERNELS:
        check(serve_launches[name] == 0,
              f"{name} launched in the serve phase")
    emit({"phase": "serve_check", "ok": True,
          "launches": {n: serve_launches[n] for n in PATHENUM_KERNELS},
          "seconds": time.perf_counter() - t_start})

    # ranked, constrained and baseline enumeration: counts from 0, read
    # right after
    kernels.reset_launch_counts()
    ranked_launches = ranked_phase(torch, np, tc, en, kernels, serving, g,
                                   g_small, picks, queries, full, lone, dev,
                                   args.seed)
    check(ranked_launches["frontier_hop"] > 0,
          "frontier_hop never launched in the ranked phase")
    for name in ("frontier_fused_masks", "frontier_fused_hop",
                 "frontier_deque_round"):
        check(ranked_launches[name] == 0,
              f"{name} launched in the ranked phase")
    for name in LM_KERNELS + LM_BF16_KERNELS:
        check(ranked_launches[name] == 0,
              f"{name} launched in the ranked phase")
    emit({"phase": "ranked_check", "ok": True,
          "launches": {n: ranked_launches[n] for n in PATHENUM_KERNELS},
          "seconds": time.perf_counter() - t_start})

    # the mesh engine: mesh_1's counts from 0, read right after it
    mesh_launches, split_k5 = mesh_phase(torch, np, tc, est, kernels, g,
                                         picks, batch_runs, dev, args.seed,
                                         smi)
    check(mesh_launches["frontier_fused_masks"] > 0,
          "frontier_fused_masks never launched in the mesh phase")
    for r, n in enumerate(split_k5):
        check(n > 0, f"frontier_fused_masks never launched on rank {r} of "
                     f"mesh_split2")
    for name in MESH_KERNELS_OFF:
        check(mesh_launches[name] == 0, f"{name} launched in the mesh phase")
    emit({"phase": "mesh_check", "ok": True,
          "launches": {n: mesh_launches[n] for n in PATHENUM_KERNELS},
          "mesh_split2_k5_launches": split_k5,
          "seconds": time.perf_counter() - t_start})
    del full, lone
    del large_runs, small_runs, batch_runs, index_of, largest, picks, shared
    del largest_hop
    del queries, dg
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    attention_kernel_phase(torch, np, kf, kd, dev, args.seed)
    attn_s = time.perf_counter() - t0

    # the LM serving path: counts from 0, read right after
    cfg = get_arch(LM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    seen, restore = record_attention_calls(kf, kd, cfg.num_layers)
    try:
        run, metrics = lm_phase(torch, np, tm, step, serving, cfg, dev,
                                args.seed)
        torch.cuda.synchronize()
        lm_launches = kernels.launch_counts()
    finally:
        restore()
    emit({"phase": "lm", **metrics,
          "launches": {n: lm_launches[n] for n in LM_KERNELS},
          "seconds": time.perf_counter() - t0,
          "attention_kernel_s": attn_s})
    for name in LM_KERNELS:
        check(lm_launches[name] > 0, f"{name} never launched in the lm phase")
    for name in PATHENUM_KERNELS + ("flash_attention_sm90",):
        check(lm_launches[name] == 0, f"{name} launched in the lm phase")
    eng = run["engine"]
    emit({"phase": "lm_trace", "what": "engine decode step, 8 slots",
          **device_busy(torch, lambda: eng.step_fn(
              run["params"], eng.cur_tok, eng.cache, eng.lens,
              eng.generator), 5)})
    rows.update(lm_kernel_rows(torch, np, kf, kd, seen, run["engine"]))
    del seen
    lm_check(torch, np, tm, cfg, run, dev)
    launches.update({n: lm_launches[n] for n in LM_KERNELS})

    # the same weights and requests in bfloat16: counts from 0, read right
    # after
    params16 = cast_params(run["params"], torch.bfloat16, tm.FLOAT32_LEAVES)
    del run, eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    seen, restore = record_attention_calls(kf, kd, cfg.num_layers)
    try:
        run, metrics = lm_phase(torch, np, tm, step, serving, cfg, dev,
                                args.seed, params=params16)
        torch.cuda.synchronize()
        bf16_launches = kernels.launch_counts()
    finally:
        restore()
    del params16
    emit({"phase": "lm_bf16", **metrics,
          "launches": {n: bf16_launches[n] for n in
                       ("flash_attention",) + LM_BF16_KERNELS},
          "seconds": time.perf_counter() - t0})
    for name in LM_BF16_KERNELS:
        check(bf16_launches[name] > 0,
              f"{name} never launched in the bf16 lm phase")
    for name in PATHENUM_KERNELS + ("flash_attention",):
        check(bf16_launches[name] == 0,
              f"{name} launched in the bf16 lm phase")
    eng = run["engine"]
    emit({"phase": "lm_bf16_trace", "what": "engine decode step, 8 slots",
          **device_busy(torch, lambda: eng.step_fn(
              run["params"], eng.cur_tok, eng.cache, eng.lens,
              eng.generator), 5)})
    rows16 = lm_kernel_rows(torch, np, kf, kd, seen, eng,
                            case="lm_bf16_phase")
    rows["flash_attention_sm90"] = rows16["flash_attention"]
    del seen, eng
    lm_bf16_check(torch, tm, cfg, run, rows16["flash_attention"]["ms"])
    del run
    torch.cuda.empty_cache()
    launches["flash_attention_sm90"] = bf16_launches["flash_attention_sm90"]

    # the five families past dense: each leg's counts from 0, read right
    # after it
    families_phase(torch, np, tm, step, serving, kernels, kf, kd, moe_mod,
                   get_arch, dev, args.seed)

    # LM training: counts from 0, read right after
    train_sec = train_phase(torch, np, kernels, kf, kd, tc, get_arch, dev,
                            args.seed)

    # the LM's mesh layout: each leg's counts from 0, read right after
    shard_phase(torch, np, kernels, dev, args.seed, train_sec)

    # the nine examples: each one's counts from 0, read right after it
    examples_phase(torch, kernels, dev, smi)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})

    where = {
        "frontier_masks": ("src/repro_torch/kernels/csrc/frontier.cu",
                           "src/repro/kernels/frontier_expand.py:47"),
        "frontier_hop": ("src/repro_torch/kernels/csrc/frontier.cu",
                         "src/repro/kernels/frontier_expand.py:47"),
        "frontier_fused_masks": (
            "src/repro_torch/kernels/csrc/frontier_fused.cu",
            "src/repro/kernels/frontier_expand.py:95"),
        "frontier_fused_hop": (
            "src/repro_torch/kernels/csrc/frontier_fused.cu",
            "src/repro/kernels/frontier_expand.py:95"),
        "frontier_deque_round": (
            "src/repro_torch/kernels/csrc/deque_round.cu",
            "src/repro/kernels/ops.py:382"),
        "counting_spmm": ("src/repro_torch/kernels/csrc/semiring.cu",
                          "src/repro/kernels/semiring_spmm.py:78"),
        "minplus_spmv": ("src/repro_torch/kernels/csrc/semiring.cu",
                         "src/repro/kernels/semiring_spmm.py:36"),
        "bfs_dense": ("src/repro_torch/kernels/csrc/semiring.cu",
                      "src/repro/kernels/semiring_spmm.py:36"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:27"),
        "flash_attention_sm90": (
            "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention.py:27"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:25"),
    }
    line = []
    for name, (source, replaces) in where.items():
        row = rows[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
