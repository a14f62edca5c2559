"""Data pipeline: deterministic sharded token streams and the PathEnum
bridge (the port of ``repro.data.pipeline``).

Two sources, both numpy generators whose batches equal ``repro``'s for
the same arguments, bit for bit:

* ``SyntheticLM``: a seeded zipfian token stream, infinite and
  restartable (the stream position is part of the checkpoint manifest,
  so a restart resumes mid-epoch without data skew).
* ``PathCorpus``: the paper bridge (DESIGN.md §3), hop-constrained paths
  of the port's ``PathEnum`` rendered as ``[BOS, s, v1, ..., t, EOS]``
  token rows, for KG-completion-style training.  Its engine runs on
  ``device`` (``"cuda"`` by default: each query's walk takes K1's hop
  entry there, ``mode="dfs"`` with ``first_n``); the paths and their
  order are the same on every device.

A batch is a dict of host numpy arrays ``{"tokens", "labels"}``; the
trainer copies it to its device.  ``(host_index, num_hosts)`` picks the
host's slice of the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.graph import Graph
from ..core.pathenum import PathEnum


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1
    zipf_a: float = 1.3

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of num_hosts {self.num_hosts}")
        self.local_batch = self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (restart-safe)."""
        rng = np.random.default_rng(
            (self.seed, step, self.host_index))
        toks = rng.zipf(self.zipf_a, size=(self.local_batch, self.seq_len))
        toks = np.minimum(toks, self.vocab - 1).astype(np.int32)
        return {"tokens": toks, "labels": toks.copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


BOS, EOS, SEP = 0, 1, 2
VERTEX_OFFSET = 3


@dataclasses.dataclass
class PathCorpus:
    """Tokenized hop-constrained paths from the PathEnum engine."""
    graph: Graph
    k: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1
    max_paths_per_query: int = 4096
    device: torch.device | str = "cuda"

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of num_hosts {self.num_hosts}")
        self.local_batch = self.global_batch // self.num_hosts
        self.device = resolve_device(self.device)
        self.engine = PathEnum(device=self.device)
        self.vocab = self.graph.n + VERTEX_OFFSET

    def _paths_for(self, rng):
        for _ in range(32):
            s, t = rng.integers(0, self.graph.n, size=2)
            if s == t:
                continue
            out = self.engine.query(self.graph, int(s), int(t), self.k,
                                    mode="dfs",
                                    first_n=self.max_paths_per_query)
            if out.result.count > 0:
                return out.result.paths, out.result.lengths
        return (np.zeros((0, self.k + 1), np.int32),
                np.zeros((0,), np.int32))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (restart-safe):
        labels are -1 past each path's EOS."""
        rng = np.random.default_rng((self.seed, step, self.host_index))
        rows = np.full((self.local_batch, self.seq_len), -1, np.int32)
        filled = 0
        while filled < self.local_batch:
            paths, lens = self._paths_for(rng)
            if paths.shape[0] == 0:
                rows[filled:, :] = EOS
                break
            take = min(self.local_batch - filled, paths.shape[0])
            for i in range(take):
                seq = [BOS] + [int(v) + VERTEX_OFFSET
                               for v in paths[i, : lens[i] + 1]] + [EOS]
                seq = seq[: self.seq_len]
                rows[filled + i, : len(seq)] = seq
            filled += take
        tokens = np.where(rows >= 0, rows, EOS).astype(np.int32)
        labels = np.where(rows >= 0, rows, -1).astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_frontend_stub(rng: np.random.Generator, batch: int, prefix_len: int,
                       d_model: int) -> np.ndarray:
    """Precomputed frame/patch embeddings for [vlm]/[audio] frontends."""
    return (rng.standard_normal((batch, prefix_len, d_model)) * 0.02
            ).astype(np.float32)
