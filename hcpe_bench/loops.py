"""The general traffic generator: one traffic mix's parameters in, the
window's requests out.

A mix (``traffic/<mix>.json``, overlaid by the cell's
``workloads/<cell>.json``) sets:

* ``loop``: ``"closed"`` — one client sends a batch of ``batch``
  requests to ``HcPEServer.serve`` and the next when it returns, until
  the window's seconds are up; ``"open"`` — requests arrive by a
  Poisson process at ``rate_per_s`` into ``AsyncHcPEServer.submit``,
  whether or not earlier ones are answered;
* ``zipf_s``: each request's pool pair is drawn independently, in
  proportion to 1 / rank ** zipf_s (pool order is rank order);
* ``count_only`` and ``first_n``: what each request asks for.

Requests are drawn from the run's seed.  Each is timed from when it was
due to be sent.  The closed loop's window lasts until its last batch
returns; the open loop's is its arrival window, and its requests are
awaited until a minute past it.
"""
from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Tuple

import numpy as np

from .stats import Record

# how long answers are awaited after the open loop's last arrival
DRAIN_S = 60.0


def zipf_probs(size: int, s: float) -> np.ndarray:
    """Zipf(s) probabilities over ranks 1..size."""
    w = 1.0 / np.arange(1, size + 1, dtype=np.float64) ** float(s)
    return w / w.sum()


def _request(req_cls, uid: int, pair: Tuple[int, int], k: int,
             params: dict):
    return req_cls(uid=uid, s=pair[0], t=pair[1], k=k,
                   count_only=bool(params["count_only"]),
                   first_n=params.get("first_n"))


def closed_loop(server, req_cls, pool: List[Tuple[int, int]], k: int,
                params: dict, rng: np.random.Generator, seconds: float,
                ) -> Tuple[List[Record], float, float]:
    """Back-to-back ``server.serve`` batches, the first at once and each
    next one while ``seconds`` have not passed; returns the records, the
    window's start and its end (the last batch's return)."""
    probs = zipf_probs(len(pool), params["zipf_s"])
    size = int(params["batch"])
    records: List[Record] = []
    uid = 0
    t0 = time.perf_counter()
    while not records or time.perf_counter() - t0 < seconds:
        picks = rng.choice(len(pool), size=size, p=probs)
        reqs = [_request(req_cls, uid + i, pool[p], k, params)
                for i, p in enumerate(picks)]
        sent = time.perf_counter()
        responses, _report = server.serve(reqs)
        done = time.perf_counter()
        for i, p in enumerate(picks):
            records.append(Record(uid=uid + i, pair=int(p), due=sent,
                                  sent=sent, done=done,
                                  response=responses[i]))
        uid += size
    return records, t0, time.perf_counter()


def arrivals(rate_per_s: float, seconds: float, pool_size: int, zipf_s: float,
             rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Poisson due times in [0, seconds) and each one's pool pair."""
    n_max = int(rate_per_s * seconds * 1.5) + 64
    due = np.cumsum(rng.exponential(1.0 / rate_per_s, size=n_max))
    while due[-1] < seconds:
        more = np.cumsum(rng.exponential(1.0 / rate_per_s, size=n_max))
        due = np.concatenate([due, due[-1] + more])
    due = due[due < seconds]
    pairs = rng.choice(pool_size, size=due.shape[0],
                       p=zipf_probs(pool_size, zipf_s))
    return due, pairs


async def open_loop(server, req_cls, pool: List[Tuple[int, int]], k: int,
                    params: dict, rng: np.random.Generator, seconds: float,
                    ) -> Tuple[List[Record], float, float]:
    """Poisson arrivals into ``server.submit`` for ``seconds``; returns
    the records, the window's start and the time the last answer came
    (or the drain gave up)."""
    due, pairs = arrivals(float(params["rate_per_s"]), seconds, len(pool),
                          params["zipf_s"], rng)
    records: List[Record] = []
    tasks = []
    t0 = time.perf_counter()

    def finished(rec: Record):
        def cb(fut: "asyncio.Future") -> None:
            rec.done = time.perf_counter()
            if not fut.cancelled() and fut.exception() is None:
                rec.response = fut.result()
        return cb

    for i, (d, p) in enumerate(zip(due, pairs)):
        delay = t0 + float(d) - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        rec = Record(uid=i, pair=int(p), due=t0 + float(d),
                     sent=time.perf_counter())
        task = asyncio.ensure_future(
            server.submit(_request(req_cls, i, pool[int(p)], k, params)))
        task.add_done_callback(finished(rec))
        records.append(rec)
        tasks.append(task)
    end: Optional[float] = None
    if tasks:
        left = t0 + seconds + DRAIN_S - time.perf_counter()
        _done, pending = await asyncio.wait(tasks, timeout=max(left, 0.0))
        for task in pending:
            task.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
        end = max((r.done for r in records if r.done is not None),
                  default=None)
    return records, t0, end if end is not None else time.perf_counter()
