"""Batched LM serving: fixed-slot continuous batching over ``decode_step``
(the port of ``repro.serving.engine``, DESIGN.md §5).

B decode slots, a FIFO request queue, slot re-fill on completion,
per-request ``max_tokens`` and EOS, and a stop at ``max_len - 1`` cached
positions, as in ``repro``.  A request's prompt is replayed through
batched decode steps, one token per step, each step committing only that
slot's advance (``repro``'s ``_admit`` and ``_step_single_slot``).
``repro``'s module docstring says that prefill seeds the cache for
attention families; its code replays the prompt, and the port copies the
code.

The cache is written in place (``repro`` concatenates the committed
slot's slice back into the old cache).  A replay step runs every slot,
so for attention it also writes one stale K/V row at position
``lens[j]`` (``lens[j] % S`` in a ring buffer) of every other slot j;
slot j's next real step overwrites that row before its attention reads
it, so tokens and logits are unchanged, and only cache entries at or
past a slot's length can differ from ``repro``'s.  A recurrent state
(``rec``, ``ssm``) has no such row: the replay step would advance every
slot's conv window and h, so it passes ``decode_step`` a commit mask of
the one slot, and every other slot's state stays bit for bit as it was.

Every cache tensor has the slot axis second (``transformer``'s layout),
so ``_reset_slot`` zeroes a slot by index and nothing here reads a
tensor's shape to find that axis.  ``repro``'s engine does
(``_reset_slot``, ``commit_tree``), and takes a tail layer's (B, W-1, C)
conv window along its second axis when ``batch_slots == conv_width -
1``; the port serves those slot counts as it serves every other
(ROADMAP.md §3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..models import transformer
from ..training import step as step_mod


@dataclasses.dataclass
class Request:
    """One LM decode request: prompt tokens in, generated tokens out."""
    uid: int
    prompt: np.ndarray            # (L,) int32
    max_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot continuous-batching decode engine on one device: B
    decode slots over one decode step, FIFO admission, slot re-fill on
    completion.  ``params`` must live on ``device`` (default the card;
    without one this raises).  ``impl`` goes down to the attention layers
    (None: the kernels K6 and K7 on a CUDA device, the plain path on the
    CPU)."""

    def __init__(self, cfg: ArchConfig, params: Any, batch_slots: int = 4,
                 max_len: int = 512, temperature: float = 0.0,
                 seed: int = 0, device: torch.device | str = "cuda",
                 impl: Optional[str] = None) -> None:
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.step_fn = step_mod.make_serve_step(cfg, temperature, impl=impl)
        self.cache = transformer.init_cache(cfg, batch_slots, max_len,
                                            dtype=params["embed"].dtype,
                                            device=self.device)
        self.lens = torch.zeros(batch_slots, dtype=torch.int32,
                                device=self.device)
        self.cur_tok = torch.zeros(batch_slots, dtype=torch.int32,
                                   device=self.device)
        # row i: the commit mask of a replay step of slot i
        self.one_slot = torch.eye(batch_slots, dtype=torch.bool,
                                  device=self.device)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.steps_run = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue one request; it is admitted to a slot on the next
        ``run`` iteration with a free slot (FIFO).  Its prompt must hold
        1 to ``max_len`` tokens."""
        if not 1 <= len(req.prompt) <= self.max_len:
            raise ValueError(f"request {req.uid}: prompt of "
                             f"{len(req.prompt)} tokens; the engine takes 1 "
                             f"to max_len={self.max_len}")
        self.queue.append(req)

    def _reset_slot(self, slot: int) -> None:
        """Zero a slot's cache and length before re-use (the previous
        occupant's K/V and recurrent state must not leak into the next
        request)."""
        for x in transformer.cache_tensors(self.cache):
            x[:, slot] = 0
        self.lens[slot] = 0

    def _admit(self) -> None:
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                self._reset_slot(i)
                # replay the prompt through decode steps to build the cache
                for tok in req.prompt[:-1]:
                    self._step_single_slot(i, int(tok))
                self.cur_tok[i] = int(req.prompt[-1])

    def _step_single_slot(self, slot: int, token: int) -> None:
        # feed one prompt token for one slot: a full batched step that
        # advances only that slot's length and recurrent state (the
        # others' K/V rows at their lengths are rewritten by their own
        # next step; module docstring)
        toks = self.cur_tok.clone()
        toks[slot] = token
        self.step_fn(self.params, toks, self.cache, self.lens,
                     self.generator, commit=self.one_slot[slot])
        self.lens[slot] += 1

    def run(self, max_steps: int = 256) -> Dict[int, List[int]]:
        """Drive until queue and slots drain (or ``max_steps``)."""
        results: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            self._admit()
            if all(s is None for s in self.slots) and not self.queue:
                break
            nxt, _, _ = self.step_fn(self.params, self.cur_tok, self.cache,
                                     self.lens, self.generator)
            nxt_np = nxt.cpu().numpy()
            self.lens += torch.tensor(
                [1 if s is not None else 0 for s in self.slots],
                dtype=torch.int32, device=self.device)
            lens_np = self.lens.cpu().numpy()
            self.steps_run += 1
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                tok = int(nxt_np[i])
                req.output.append(tok)
                if (req.eos_id is not None and tok == req.eos_id) or \
                        len(req.output) >= req.max_tokens or \
                        int(lens_np[i]) >= self.max_len - 1:
                    req.done = True
                    results[req.uid] = req.output
                    self.slots[i] = None
                else:
                    self.cur_tok[i] = tok
        for req in [s for s in self.slots if s is not None]:
            results[req.uid] = req.output
        return results
