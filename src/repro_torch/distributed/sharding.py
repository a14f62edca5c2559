"""Sharding rules: FSDP(data[,pod]) × TP(model) with divisibility
fallbacks (the port of ``repro.distributed.sharding``), laid out with
``torch.distributed.tensor``.

Strategy (``repro``'s, decision for decision):
  * train — parameters and optimizer state shard over BOTH the fsdp
    group (``("pod","data")`` when multi-pod) and ``model`` (ZeRO-3 ×
    tensor parallel).  Column-parallel in-projections (D→F sharded on
    F), row-parallel out-projections (F→D sharded on F), the expert
    dimension of MoE stacks over ``model``, batch over the fsdp group.
  * serve — the same parameter specs; KV caches shard batch over the
    fsdp group and heads (or head_dim when the GQA head count does not
    divide) over ``model``; a batch of one falls back to
    sequence-sharded caches.

Every rule goes through the pickers ``fsdp``, ``tp`` and ``dp``: the
first candidate axis (group) that divides the dimension wins, else the
dimension is replicated.

The spec type ``P`` holds one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of names.  ``placements(spec, mesh)`` turns it
into one DTensor placement per mesh dim: ``Shard(d)`` where that mesh
dim names tensor dim d, else ``Replicate()``.  Two names on one tensor
dim (``("pod","data")``) are two ``Shard(d)``; DTensor splits them in
mesh-dim order, the first outermost, which is JAX's major-to-minor order
for a tuple given in mesh order (any other order raises).

Layouts differ from ``repro``'s in two ways:
  * parameters are per-layer dicts under ``"layers"`` with no stacked
    lead dim, so ``param_spec`` has no lead;
  * caches are stacked per kind as ``(layers, slot, ...)``
    (``transformer.init_cache``), so ``cache_spec`` always takes the
    first dim as ``repro``'s ``supers`` lead and replicates it.

``ShardingRules`` reads only a mesh's ``mesh_dim_names`` and ``shape``:
a ``DeviceMesh``, or a ``LayoutMesh`` that carries just those two and
needs no process group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple

import torch

from .. import tree as tree_mod


class P:
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name, or a tuple of names.  A leaf of ``repro_torch.tree`` (not
    a tuple, so tree walks stop at it)."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        for e in entries:
            if not (e is None or isinstance(e, str) or (
                    isinstance(e, tuple)
                    and all(isinstance(n, str) for n in e))):
                raise TypeError(f"spec entry {e!r}: None, a name or a "
                                f"tuple of names")
        self.entries = tuple(entries)

    def __iter__(self) -> Iterator:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}" if len(self.entries) != 1 \
            else f"P({self.entries[0]!r},)"


@dataclasses.dataclass(frozen=True)
class LayoutMesh:
    """A mesh's axis names and sizes alone, enough for the rules."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or ``LayoutMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_axis_size(mesh, names) -> int:
    sizes = axis_sizes(mesh)
    size = 1
    for n in ([names] if isinstance(names, str) else names):
        size *= sizes[n]
    return size


def placements(spec: P, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where the spec names
    that mesh dim on tensor dim d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    where = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else entry
        order = [names.index(n) for n in group]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r} names {group} out of the "
                             f"mesh's order {names}")
        for n in group:
            if n in where:
                raise ValueError(f"spec {spec!r} names axis {n!r} twice")
            where[n] = d
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"spec {spec!r} names axes {sorted(unknown)} "
                         f"absent from the mesh {names}")
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart),
    with its DTensor placements."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


class ShardingRules:
    def __init__(self, mesh):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.axis_names = names
        self.fsdp_group: Tuple[str, ...] = tuple(
            n for n in ("pod", "data") if n in names)
        self.model_axis = "model" if "model" in names else None

    # -- candidate pickers ----------------------------------------------
    def _div(self, dim: int, names) -> bool:
        return dim % mesh_axis_size(self.mesh, names) == 0

    def fsdp(self, dim: int):
        for cand in (self.fsdp_group, ("data",), ("pod",)):
            cand = tuple(n for n in cand if n in self.axis_names)
            if cand and self._div(dim, cand):
                return cand if len(cand) > 1 else cand[0]
        return None

    def tp(self, dim: int):
        if self.model_axis and self._div(dim, self.model_axis):
            return self.model_axis
        return None

    def dp(self, dim: int):
        return self.fsdp(dim)

    # -- parameter rules --------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> P:
        """The spec of the parameter at ``path`` (``repro_torch.tree``'s,
        e.g. ``layers/3/attn/wq``) of ``shape``."""
        parts = path.split("/")
        name = parts[-1]
        dims = tuple(shape)

        # --- scalars / norms / per-channel vectors: replicate ---
        if name in ("ln1", "ln2", "norm", "final_norm", "lam", "A_log", "D",
                    "dt_bias", "step") or len(dims) <= 1:
            return P(*(None,) * len(dims))
        in_moe = len(parts) >= 2 and parts[-2] == "moe"
        if in_moe and name in ("w_gate", "w_up") and len(dims) == 3:
            e, d, f = dims
            return P(self.tp(e), self.fsdp(d), None)
        if in_moe and name == "w_down" and len(dims) == 3:
            e, f, d = dims
            return P(self.tp(e), None, self.fsdp(d))
        if name == "router":
            d, e = dims
            return P(self.fsdp(d), self.tp(e))
        if name == "embed":
            # vocab-parallel (tp on V): logits inherit model-sharded vocab
            # so the (B, S, V) loss tensor never replicates.  Odd vocabs
            # (mamba2's 50280 ∤ 16) fall back to fsdp-sharded V, else
            # fully replicated — never model-sharded D (repro's rule: a
            # D-sharded gather output resharded in a loop body faults its
            # partitioner).
            v, d = dims
            tv = self.tp(v)
            if tv:
                return P(tv, self.fsdp(d))
            fv = self.fsdp(v)
            if fv:
                return P(fv, None)
            return P(None, None)
        if name == "head":
            d, v = dims
            return P(self.fsdp(d), self.tp(v))
        if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_x",
                    "w_gate_out", "frontend_proj", "w_in_gate",
                    "w_rec_gate"):
            d, f = dims
            return P(self.fsdp(d), self.tp(f))
        if name in ("wo", "w_down", "out_proj", "w_out"):
            f, d = dims
            return P(self.tp(f), self.fsdp(d))
        if name == "conv_w":
            c, w = dims
            return P(self.tp(c), None)
        return P(*(None,) * len(dims))

    # -- cache rules -------------------------------------------------------
    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> P:
        """The spec of the cache tensor at ``path`` (``k``, ``v``,
        ``rec/0``, ``ssm/1``, ...): the layer dim first, replicated, then
        ``repro``'s rule for the per-layer dims."""
        dims = tuple(shape[1:])

        def spec(*axes):
            return P(None, *axes)

        if "ssm" in path and len(dims) == 4:  # ssd state (B, H, N, P)
            b, nh, ns_, hd = dims
            return spec(self.dp(b), self.tp(nh), None, None)
        if len(dims) == 4:  # kv cache (B, S, Hkv, hd)
            b, s, hkv, hd = dims
            bspec = self.dp(b)
            sspec = None if bspec is not None else self.dp(s)
            hspec = self.tp(hkv)
            dspec = None if hspec is not None else self.tp(hd)
            return spec(bspec, sspec, hspec, dspec)
        if len(dims) == 3:  # conv state (B, W-1, C)
            b, w, c = dims
            return spec(self.dp(b), None, self.tp(c))
        if len(dims) == 2:  # rec h (B, W)
            b, w = dims
            return spec(self.dp(b), self.tp(w))
        return spec(*(None,) * len(dims))

    # -- batch rules ---------------------------------------------------------
    def batch_spec(self, path: str, shape: Tuple[int, ...]) -> P:
        b = shape[0]
        return P(self.dp(b), *(None,) * (len(shape) - 1))


def tree_specs(tree, rule) -> Any:
    """Map a (template) tree to specs via ``rule(path, shape)``."""
    return tree_mod.unflatten(tree, [
        rule(path, tuple(leaf.shape))
        for path, leaf in tree_mod.leaves_with_path(tree)])


def tree_shardings(mesh, specs) -> Any:
    """Each spec of ``specs`` as a ``NamedSharding`` on ``mesh``."""
    return tree_mod.tree_map(lambda s: NamedSharding(mesh, s), specs)


def distribute_tree(tree, mesh, specs) -> Any:
    """Every tensor of ``tree`` as a DTensor on ``mesh`` laid out by its
    spec.  Each rank holds the full tensor and keeps its own shard (no
    communication: the ranks must hold equal tensors, as ones made from
    one seed do)."""
    from torch.distributed.tensor import distribute_tensor

    return tree_mod.tree_map(
        lambda x, s: distribute_tensor(x, mesh, placements(s, mesh),
                                       src_data_rank=None), tree, specs)


def renumbered(pl, dims: dict) -> list:
    """Placements ``pl`` of one tensor renumbered for another (old tensor
    dim -> new); a dim not in ``dims``, or a partial sum, becomes
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
            else Replicate() for p in pl]


def grad_placements(in_pl, out_pl) -> list:
    """An input's gradient placements under ``local_map`` whose output
    is laid out as ``out_pl``: a sum over each mesh dim that splits the
    output but not the input (the input feeds every rank's part)."""
    from torch.distributed.tensor import Partial, Shard

    return [Partial() if isinstance(o, Shard) and not isinstance(i, Shard)
            else i for i, o in zip(in_pl, out_pl)]


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor made whole on every rank of its mesh; a plain tensor as
    it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x.redistribute(placements=[Replicate()] * x.device_mesh.ndim)
    return x


def full_tree(tree) -> Any:
    """Every DTensor leaf of ``tree`` gathered to a full tensor (every
    rank takes part); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return tree_mod.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def param_shardings(mesh, cfg, params_template) -> Any:
    """The rules' parameter specs of a parameter tree."""
    del cfg
    return tree_specs(params_template, ShardingRules(mesh).param_spec)


def opt_shardings(param_specs, opt_template=None) -> Any:
    """Optimizer state reuses the parameter specs for ``mu`` and ``nu``
    and replicates ``step``."""
    from ..optim.adamw import AdamWState
    del opt_template
    return AdamWState(step=P(), mu=param_specs, nu=param_specs)


def cache_shardings(mesh, cfg, cache_template) -> Any:
    del cfg
    return tree_specs(cache_template, ShardingRules(mesh).cache_spec)


def batch_shardings(mesh, batch_template) -> Any:
    return tree_specs(batch_template, ShardingRules(mesh).batch_spec)
