"""Shared harness of the port's serving parity tests
(``tests/test_torch_{async_server,tenancy,streaming,metrics,
deadline_clock}.py``).

Each test runs one scenario twice: once on ``repro``'s front-ends with
``backend="host"``, once on the port's with ``device="cpu"`` and the
backend under test (``"host"``, or ``"device"``, which runs the plain
versions of K1, K2 and K5), then holds the two outcomes equal.  All
results are integers, so equality is exact.  Times are not compared:
every time field is masked, and the scenarios choose deadlines whose
SLO outcome does not depend on the host's speed (0 ms, which is always
missed, or a minute, which is always met).  Ranked scenarios (DESIGN.md
§10) register a tenant with tie-heavy ``edge_weights`` beside one
without (``ranked_registry``), and compare paths in order.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np

import repro.core as rc
import repro.serving as rs
import repro_torch.core as tc
import repro_torch.serving as ts

BACKENDS = ("host", "device")

# the response fields that do not depend on the host's clock
RESPONSE_FIELDS = ("uid", "status", "count", "plan_method", "index_cached",
                   "deduplicated", "exhausted", "graph_id", "slo_met")
# the report fields that do not depend on the host's clock
REPORT_FIELDS = ("batch_size", "distinct_queries", "total_results",
                 "sharing_groups", "shared_queries")
# AsyncServeStats' latency accumulators and the capture time
TIME_FIELDS = ("captured_at", "queue_ms_total", "service_ms_total",
               "total_ms_total")


def side(pkg: str, backend: str = "host") -> SimpleNamespace:
    """One package's serving surface under one backend: ``core``,
    ``serving``, ``engine(**kw)``, ``server(g, **kw)`` and
    ``async_server(g, **kw)``.  ``repro`` runs its host backend (its
    device backend only through `ranked_sides`); the port runs
    ``backend`` on the CPU."""
    if pkg == "repro":
        core, serving, extra = rc, rs, {"backend": backend}
    else:
        core, serving = tc, ts
        extra = {"backend": backend, "device": "cpu"}

    def engine(**kw):
        return core.BatchPathEnum(**extra, **kw)

    def server(g, **kw):
        return serving.HcPEServer(g, engine(), **kw)

    def async_server(g, **kw):
        return serving.AsyncHcPEServer(g, engine(), **kw)

    return SimpleNamespace(core=core, serving=serving, engine=engine,
                           server=server, async_server=async_server)


def sides(backend: str):
    """``(repro's side, the port's side)`` for one port backend."""
    return side("repro"), side("port", backend)


def ranked_sides(backend: str, monkeypatch):
    """``sides`` for ranked scenarios.  On the device backend an
    ``order="hops"`` query drains hop buckets, whose ``chunks`` differ
    from the host heap's, so ``repro`` runs its device backend too, with
    its device step swapped for its host step (which ``repro`` pins bit
    identical) and its resident deque off: no JAX compile runs."""
    if backend == "host":
        return sides(backend)
    from repro.core import enumerate as jen
    monkeypatch.setattr(jen, "_device_step",
                        lambda idx: jen._host_step(idx, None))
    monkeypatch.setenv("REPRO_DEVICE_DEQUE", "off")
    return side("repro", backend), side("port", backend)


def assert_paths(want, got, tag=""):
    """Both None, or equal int32 arrays (rows in the same order)."""
    if want is None:
        assert got is None, tag
        return
    assert got is not None, tag
    got = np.asarray(got)
    assert got.dtype == want.dtype, tag
    np.testing.assert_array_equal(got, want, err_msg=tag)


def assert_responses(want, got, tag=""):
    """Two response lists equal on every field but the times."""
    assert len(got) == len(want), tag
    for a, b in zip(want, got):
        label = f"{tag} uid={a.uid}"
        for f in RESPONSE_FIELDS:
            assert getattr(b, f) == getattr(a, f), f"{label} {f}"
        assert_paths(a.paths, b.paths, label)


def cache_dict(stats) -> dict:
    """A ``CacheStats`` as a plain dict (the two packages' classes
    differ, their fields do not)."""
    return dataclasses.asdict(stats)


def assert_report(want, got, tag=""):
    """Two ``BatchServeReport``s equal on every field but the times:
    the cache delta, its per-tenant split, the merged Fig.-6 counters
    (``chunks`` included) and the counts."""
    for f in REPORT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f"{tag} {f}"
    assert cache_dict(got.cache) == cache_dict(want.cache), tag
    assert {k: cache_dict(v) for k, v in got.tenant_cache.items()} == \
        {k: cache_dict(v) for k, v in want.tenant_cache.items()}, tag
    assert dataclasses.asdict(got.enum_stats) == \
        dataclasses.asdict(want.enum_stats), tag
    assert got.chunks == want.chunks, tag


def masked(snapshot) -> dict:
    """``MetricsSnapshot.to_dict()`` with its time fields masked."""
    d = snapshot.to_dict()
    d.pop("captured_at")
    if d["serve"] is not None:
        for f in TIME_FIELDS[1:]:
            d["serve"].pop(f)
    return d


def assert_snapshot(want, got, tag=""):
    """Two snapshots equal with their time fields masked."""
    assert masked(got) == masked(want), tag


def random_requests(PathQueryRequest, g, count, rng, k=3, uid0=0, **kw):
    """``count`` requests with distinct s and t drawn from ``rng``."""
    reqs = []
    while len(reqs) < count:
        s, t = rng.integers(0, g.n, 2)
        if s != t:
            reqs.append(PathQueryRequest(uid=uid0 + len(reqs), s=int(s),
                                         t=int(t), k=k, **kw))
    return reqs


def is_path(g, row, s, t, k) -> bool:
    """``row`` (PAD-padded) is a simple s-t path of at most k edges in
    ``g``: one member of the query's full result."""
    verts = [int(v) for v in row if v >= 0]
    if len(verts) < 2 or len(verts) > k + 1 or verts[0] != s \
            or verts[-1] != t or len(set(verts)) != len(verts):
        return False
    return all(v in set(g.neighbors(u).tolist())
               for u, v in zip(verts, verts[1:]))


def ranked_case(S, seed):
    """A random digraph (the same edges in either package), a query on
    it with results, and tie-heavy integer edge weights: ``(g, s, t, k,
    w)``, as tests/test_ranked.py draws them."""
    rng = np.random.default_rng(seed)
    while True:
        n = int(rng.integers(8, 26))
        m = int(n * float(rng.choice([2.0, 3.5])))
        edges = rng.integers(0, n, size=(m, 2))
        g = S.core.from_edges(n, edges)
        s, t = map(int, rng.choice(n, 2, replace=False))
        k = int(rng.integers(3, 7))
        w = rng.integers(0, 4, size=g.m).astype(np.float64)
        if len(rc.oracle.enumerate_paths(rc.from_edges(n, edges), s, t,
                                         k)) >= 3:
            return g, s, t, k, w


def ranked_registry(S, seed):
    """``ranked_case`` behind a registry with two tenants on the same
    graph: ``"weighted"`` (with ``edge_weights``) and ``"plain"``
    (without).  Returns ``(registry, g, s, t, k, w)``."""
    g, s, t, k, w = ranked_case(S, seed)
    reg = S.serving.GraphRegistry()
    reg.register("weighted", g, edge_weights=w)
    reg.register("plain", g)
    return reg, g, s, t, k, w


def resp_paths(resp):
    """A response's paths as vertex tuples, in order."""
    if resp.paths is None:
        return []
    return [tuple(int(x) for x in row if x >= 0) for row in resp.paths]
