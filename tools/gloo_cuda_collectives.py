#!/usr/bin/env python3
"""Which collectives a gloo process group of two ranks runs on CUDA
tensors, one process per rank on the one card: the answer that decides
whether DTensor (which issues functional collectives) can lay a model
out over gloo on the card.

For each device, ``cpu`` and ``cuda:0``, two ranks each try in turn the
c10d calls ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_to_all_single``, then the functional
collectives DTensor issues (``funcol.all_reduce``,
``funcol.all_gather_tensor``, ``funcol.reduce_scatter_tensor``, each
waited on).  Each rank prints a line before every attempt, so a crash
names the call it died in; the script prints one JSON line per device
with each rank's exit code, the calls that completed, the one it was in
when it stopped, and the tail of its fault report.

Run from the repo root on the GPU: ``python3 tools/gloo_cuda_collectives.py``
(seconds).
"""
from __future__ import annotations

import json
import subprocess
import sys

CALLS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
         "all_to_all_single", "funcol.all_reduce", "funcol.all_gather_tensor",
         "funcol.reduce_scatter_tensor")


def rank_main(rank: int, init: str, device: str) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    faulthandler.enable()
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = dist.group.WORLD
    x = torch.full((4, 8), float(rank + 1), device=dev)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8, 8, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, 8, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "funcol.all_reduce": lambda: funcol.wait_tensor(
            funcol.all_reduce(x, "sum", group)),
        "funcol.all_gather_tensor": lambda: funcol.wait_tensor(
            funcol.all_gather_tensor(x, 0, group)),
        "funcol.reduce_scatter_tensor": lambda: funcol.wait_tensor(
            funcol.reduce_scatter_tensor(x, "sum", 0, group)),
    }
    for name in CALLS:
        print(f"try {name}", flush=True)
        try:
            calls[name]()
            print(f"done {name}", flush=True)
        except Exception as e:  # noqa: BLE001 — a refusal is the answer
            print(f"raised {name}: {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
    dist.destroy_process_group()


def main() -> None:
    sys.path.insert(0, "src")
    from repro_torch.compat import free_port

    for device in ("cpu", "cuda:0"):
        init = f"tcp://127.0.0.1:{free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), init, device],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        ranks = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            lines = out.splitlines()
            tried = [ln[4:] for ln in lines if ln.startswith("try ")]
            done = [ln[5:] for ln in lines if ln.startswith("done ")]
            raised = [ln[7:] for ln in lines if ln.startswith("raised ")]
            stopped_in = tried[-1] if tried and tried[-1] not in done \
                and not any(r.startswith(tried[-1] + ":") for r in raised) \
                else None
            fault = [ln for ln in err.splitlines()
                     if "Fatal Python error" in ln or "line" in ln][:6]
            ranks.append({"exit": p.returncode, "done": done,
                          "raised": raised, "stopped_in": stopped_in,
                          "fault": fault})
        import torch
        print(json.dumps({"device": device, "torch": torch.__version__,
                          "ranks": ranks}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
