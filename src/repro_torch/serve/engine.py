"""Batched serving engine: prefill + decode with continuous slot reuse.

The counterpart of ``repro.serve.engine``, with the same behaviour.  A
fixed pool of ``batch`` slots holds active requests.  ``submit`` queues
prompts; the engine prefills them into free slots token by token through
``decode_step``, then decodes the whole pool each tick — finished slots
are refilled from the queue between ticks (continuous batching).  Greedy
sampling; per-slot stop conditions (eos or max tokens).

Overload behavior is typed, not silent: ``submit`` raises
:class:`~repro_torch.admission.AdmissionRejected` for a request that can
never fit the KV cache (``capacity``) or when the waiting queue is at its
``max_queue`` bound (``queue_full``); a request carrying a ``deadline``
(engine tick index) is shed from the queue once even an optimistic
decode schedule would miss it (``stats["shed"]``, ``Request.shed``).

``model`` is a :class:`repro_torch.models.transformer.Transformer`; the
engine runs where its parameters live.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.admission import AdmissionRejected


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int = 16
    eos: int = -1
    out: List[int] = field(default_factory=list)
    done: bool = False
    deadline: Optional[int] = None   # engine tick to finish by
    shed: bool = False               # dropped by deadline shedding


class ServeEngine:
    """``pim_pool`` (duck-typed: an object with ``tick(n_active)`` that
    may raise :class:`repro_torch.faults.model.DpuFaultError`) attaches a
    simulated PIM accelerator: each tick is charged to the pool's system,
    and a pool that degrades below its availability floor mid-stream
    triggers host-execution fallback for that tick instead of crashing —
    requests never get lost, only slower.  ``stats`` counts ``pim_ticks``
    vs ``host_ticks``."""

    def __init__(self, cfg, model, *, batch: int = 4, capacity: int = 256,
                 pim_pool=None, max_queue: Optional[int] = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.cfg = cfg
        self.model = model
        self.batch = batch
        self.capacity = capacity
        self.max_queue = max_queue
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * batch
        self.cache = model.init_cache(batch, capacity)
        self.slot_pos = np.zeros(batch, np.int64)
        self.slot_budget = np.zeros(batch, np.int64)
        self._next = 0
        self.pim_pool = pim_pool
        self.stats = {"pim_ticks": 0, "host_ticks": 0, "shed": 0}
        self.requests: Dict[int, Request] = {}
        self.ticks = 0

    def _decode(self, cache, tok_vec: np.ndarray):
        tokens = torch.as_tensor(tok_vec, device=self.model.device)
        return self.model.decode_step(cache, tokens)

    def submit(self, prompt, max_new: int = 16, eos: int = -1,
               deadline: Optional[int] = None) -> int:
        """Queue one prompt; returns its request id.

        Raises :class:`AdmissionRejected` instead of accepting work the
        engine cannot serve: ``capacity`` when ``len(prompt) + max_new``
        exceeds the KV-cache budget (``capacity - 1`` positions), and
        ``queue_full`` when ``max_queue`` waiting requests are already
        queued.  ``deadline`` (an engine tick index) opts the request into
        deadline shedding."""
        prompt = np.asarray(prompt, np.int32)
        need = int(len(prompt)) + int(max_new)
        if need > self.capacity - 1:
            raise AdmissionRejected(
                "request", "capacity",
                detail=f"prompt {len(prompt)} + max_new {max_new} tokens "
                       f"exceed the {self.capacity - 1}-position KV "
                       "cache; lower max_new or raise capacity")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise AdmissionRejected(
                "request", "queue_full",
                detail=f"{len(self.queue)} requests already waiting "
                       f"(max_queue={self.max_queue})")
        rid = self._next
        self._next += 1
        req = Request(rid, prompt, max_new, eos, deadline=deadline)
        self.requests[rid] = req
        self.queue.append(req)
        return rid

    def _shed_expired(self):
        """Drop queued requests whose deadline is provably lost: even if
        decode started this tick and emitted one token per tick, the
        request would finish after its deadline.  Requests already in
        slots are never shed (their prefill is sunk cost)."""
        kept: deque = deque()
        for r in self.queue:
            if (r.deadline is not None
                    and self.ticks + r.max_new > r.deadline):
                r.done = True
                r.shed = True
                self.stats["shed"] += 1
            else:
                kept.append(r)
        self.queue = kept

    # --- internals -----------------------------------------------------------
    def _prefill_into(self, slot: int, req: Request):
        """Sequential per-slot prefill via decode steps into the slot's cache
        region (keeps one cache for the pool)."""
        pos = 0
        for t in req.prompt:
            tok_vec = np.zeros(self.batch, np.int32)
            tok_vec[slot] = t
            cache = dict(self.cache)
            cache["pos"] = pos
            _, new_cache = self._decode(cache, tok_vec)
            self.cache = dict(new_cache)
            pos += 1
        self.slot_pos[slot] = pos
        self.slot_budget[slot] = req.max_new
        self.slots[slot] = req

    def _free_slots(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    def step(self) -> int:
        """One engine tick; returns number of active requests."""
        self.ticks += 1
        self._shed_expired()
        for i in self._free_slots():
            if not self.queue:
                break
            self._prefill_into(i, self.queue.popleft())
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        # charge the tick to the PIM pool when one is attached; a faulted
        # pool degrades to host execution for this tick — the token math
        # below runs either way, so no request is ever lost
        if self.pim_pool is not None:
            from repro_torch.faults.model import DpuFaultError
            try:
                self.pim_pool.tick(len(active))
                self.stats["pim_ticks"] += 1
            except DpuFaultError:
                self.stats["host_ticks"] += 1
        # decode one token for the pool
        tok_vec = np.zeros(self.batch, np.int32)
        for i in active:
            r = self.slots[i]
            tok_vec[i] = (r.out[-1] if r.out else
                          (r.prompt[-1] if len(r.prompt) else 0))
        cache = dict(self.cache)
        pos = int(self.slot_pos[active[0]])  # homogeneous pool position
        cache["pos"] = min(pos, self.capacity - 1)
        logits, self.cache = self._decode(cache, tok_vec)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active:
            r = self.slots[i]
            r.out.append(int(nxt[i]))
            self.slot_pos[i] += 1
            if (len(r.out) >= r.max_new or int(nxt[i]) == r.eos
                    or self.slot_pos[i] >= self.capacity - 1):
                r.done = True
                self.slots[i] = None
        return len(active)

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue and all active slots; returns outputs for
        EVERY submitted request — including ones already prefilled into
        slots by earlier step() calls."""
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        return {rid: r.out for rid, r in self.requests.items()}
