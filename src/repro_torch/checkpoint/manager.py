"""Checkpointing and restart for fault tolerance (the port of
``repro.checkpoint.manager``, with its on-disk layout).

* **Atomic**: each save writes ``<dir>/tmp-<step>`` and renames it to
  ``step-%010d``, so a failure mid-save never corrupts the latest
  checkpoint.
* **Manifest-driven restart**: ``manifest.json`` holds ``step``,
  ``saved_at``, ``trees`` and ``extra`` (the trainer puts the data
  stream's position there); ``latest_step`` and ``restore`` are all a
  restarted job needs.
* **Emergency save**: ``install_signal_handler`` hooks SIGTERM (the
  preemption signal) to flush a checkpoint, then exits with
  ``128 + signum``.
* **Retention**: ``keep_last`` bounds disk usage.

Storage is one ``.npz`` per tree, keyed by each leaf's path
(``repro_torch.tree``: dict keys, list indices, NamedTuple field names
joined by ``/``).  numpy has no bfloat16, so a bfloat16 tensor is saved
as its ``int16`` view and restored by viewing it back to the template's
dtype, bit for bit.  ``restore`` puts every tensor leaf on its
template's device.

Checkpoints are unsharded.  ``save`` gathers every DTensor leaf to its
full value (``full_tensor()``; every rank of the mesh must call it);
then rank 0 of the default process group writes and the others wait at
a barrier.  ``restore`` returns full tensors, which the trainer
distributes on its own mesh, so a checkpoint saved on one mesh restores
on any other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import tree as tree_mod
from ..distributed.sharding import full_tree


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, DTensor):
        raise TypeError("a DTensor leaf: gather it with full_tensor() first")
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        return leaf.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, template: Any) -> Any:
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(arr)
        if template.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        return t.to(device=template.device, dtype=template.dtype)
    return arr.astype(template.dtype) if hasattr(template, "dtype") else arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf)
            for key, leaf in tree_mod.leaves_with_path(tree)}


def _unflatten(template, flat: Dict[str, np.ndarray]):
    return tree_mod.unflatten(template, [
        _from_numpy(flat[key], leaf)
        for key, leaf in tree_mod.leaves_with_path(template)])


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._emergency_cb: Optional[Callable[[], None]] = None

    # ---------------- save ----------------
    def save(self, step: int, trees: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write ``trees`` (name -> tree) as checkpoint ``step`` and
        return its directory.  With DTensor leaves every rank calls it:
        they gather, rank 0 writes, all meet at a barrier after."""
        sharded = any(isinstance(x, DTensor)
                      for x in tree_mod.leaves(trees))
        if sharded:
            trees = {name: full_tree(tree) for name, tree in trees.items()}
        final = os.path.join(self.directory, f"step-{step:010d}")
        if sharded and dist.is_initialized() and dist.get_world_size() > 1:
            if dist.get_rank() == 0:
                self._write(step, trees, extra)
            dist.barrier()
            return final
        return self._write(step, trees, extra)

    def _write(self, step: int, trees: Dict[str, Any],
               extra: Optional[Dict[str, Any]]) -> str:
        tmp = os.path.join(self.directory, f"tmp-{step}")
        final = os.path.join(self.directory, f"step-{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, tree in trees.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **_flatten(tree))
        manifest = {
            "step": step,
            "saved_at": time.time(),
            "trees": sorted(trees.keys()),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:010d}"),
                          ignore_errors=True)

    # ---------------- restore ----------------
    def all_steps(self):
        """The steps of every published checkpoint, ascending."""
        return sorted(int(d.split("-")[1]) for d in os.listdir(self.directory)
                      if d.startswith("step-"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        path = os.path.join(self.directory, f"step-{step:010d}",
                            "manifest.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, step: int, templates: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(name -> tree in its template's structure, dtypes and devices,
        the manifest) of checkpoint ``step``."""
        base = os.path.join(self.directory, f"step-{step:010d}")
        out = {}
        for name, template in templates.items():
            with np.load(os.path.join(base, f"{name}.npz")) as z:
                flat = {k: z[k] for k in z.files}
            out[name] = _unflatten(template, flat)
        return out, self.manifest(step)

    # ---------------- fault tolerance ----------------
    def install_signal_handler(self, save_cb: Callable[[], None]):
        """SIGTERM (preemption) -> emergency checkpoint before eviction."""
        self._emergency_cb = save_cb

        def handler(signum, frame):
            if self._emergency_cb is not None:
                self._emergency_cb()
            raise SystemExit(128 + signum)

        signal.signal(signal.SIGTERM, handler)
