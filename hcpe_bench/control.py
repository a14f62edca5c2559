"""The control of the comparison that decides ``correct``.

The configuration guarantees exact answers: counts of simple s-t paths
with at most k edges, and returned rows that are such paths.  The
control breaks the hop guarantee: the reference itself, run with one
hop fewer (at most k - 1 edges), as an enumeration that stops a level
early would, stands in the program's place.  Its answers are judged by
``checks.compare`` exactly as the program's are; the comparison has to
find them wrong.  (Counting walks instead of simple paths, as a count
by matrix powers would, is no fault at k = 3: a walk of at most three
edges repeats a vertex only through an edge from s to t, and no pool
pair of the configuration is adjacent.)

    python -m hcpe_bench.control --workload <cell> --seeds 1,2,3 \
        [--requests 2000]

runs it at the cell's own size on the card (the benchmark's runs never
run it) and prints one JSON line per seed with the numbers compared.
``control_numbers`` is the same on any device, for the tests.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from . import checks, graphgen, loops
from .harness import HERE, find_cell, use_checkout_program
from .reference import paths as ref
from .stats import Record


@dataclasses.dataclass
class Answer:
    """An answer in the shape of the program's response."""
    count: int
    paths: Optional[np.ndarray]
    status: str = "ok"


def fewer_hops(n: int, src: torch.Tensor, dst: torch.Tensor, s: int,
               t: int, k: int, first_n: Optional[int]) -> Answer:
    """The control's answer to q(s, t, k): the paths of at most k - 1
    edges, or the first ``first_n`` of them as rows of width k + 1."""
    rows: Optional[list] = [] if first_n is not None else None
    c = ref.count_paths(n, src, dst, s, t, k - 1, limit=first_n,
                        rows_out=rows)
    if first_n is None:
        return Answer(count=c, paths=None)
    got = torch.cat(rows)[:first_n] if rows else \
        torch.zeros((0, k), dtype=torch.int64)
    got = torch.nn.functional.pad(got, (0, 1), value=ref.PAD)
    return Answer(count=int(got.shape[0]),
                  paths=got.to(torch.int32).cpu().numpy())


def control_numbers(cell_name: str, seed: int, requests: int,
                    device: torch.device, spec: Optional[dict] = None,
                    base: Path = HERE) -> Dict[str, int]:
    """The numbers ``checks.compare`` gives the control's answers to
    ``requests`` requests drawn as the cell's traffic draws them."""
    cell = find_cell(cell_name, spec, base)
    cfg, params = cell.config, cell.traffic
    k, n = int(cfg["query"]["k"]), graphgen.vertex_count(cfg["graph"])
    first_n = params.get("first_n")
    arrays, pool = graphgen.build(cfg, seed, device)
    src, dst = arrays.esrc, arrays.edst
    expected, ref_dists = checks.reference_answers(n, src, dst, pool, k,
                                                   first_n)
    answers = []
    for s, t in pool:
        answers.append(fewer_hops(n, src, dst, s, t, k, first_n))
    rng = np.random.default_rng([int(seed), 1])
    picks = rng.choice(len(pool), size=requests,
                       p=loops.zipf_probs(len(pool), params["zipf_s"]))
    records = [Record(uid=i, pair=int(p), due=0.0, sent=0.0, done=0.0,
                      response=answers[int(p)])
               for i, p in enumerate(picks)]
    keys = None if params["count_only"] else ref.edge_keys(n, src, dst)
    return checks.compare(records, pool, k, first_n, expected, ref_dists,
                          ref_dists, keys, n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=2000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    use_checkout_program()
    dev = torch.device("cuda", torch.cuda.current_device())
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(args.workload, seed, args.requests, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "requests": args.requests, "numbers": numbers,
                          "fails": not checks.verdict(numbers),
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
