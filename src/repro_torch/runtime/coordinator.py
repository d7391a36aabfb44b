"""Fault tolerance & straggler mitigation for 1000+ node fleets.

The counterpart of ``repro.runtime.coordinator``: a copy but for the
default checkpoint of :func:`run_with_restarts`, which writes a train
state of the port in the JAX package's layout (:func:`_tree`).

Three cooperating pieces, each unit-tested with injected faults:

* :class:`StepMonitor` — deadline-based failure detection + straggler
  flagging from a running latency median (the detector a real multi-host
  launcher hangs off its heartbeat RPCs).
* :func:`run_with_restarts` — the restart driver: executes a step loop,
  checkpoints every ``ckpt_every`` steps, and on a (detected or raised)
  worker failure restores the latest checkpoint and keeps going, replaying
  the data pipeline to the restored step.
* :class:`WorkRebalancer` — over-decomposition + greedy re-balancing for
  the PIM design-sweep fleet: work units are re-assigned away from slow
  workers (longest-processing-time heuristic on observed rates).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import store
from repro_torch.models import convert


def _tree(state):
    """What a checkpoint holds of ``state``: a train state of the port
    (``{"params": Transformer, "opt", "step"}``) in the JAX package's
    layout (``convert.train_state_to_jax``), so either package restores
    the other's checkpoints; any other tree as it is."""
    if isinstance(state, dict) and isinstance(state.get("params"),
                                              torch.nn.Module):
        return convert.train_state_to_jax(state)
    return state


def _untree(tree, state):
    """``state`` holding the restored ``tree`` (:func:`_tree`'s inverse:
    a port train state's weights are loaded into its model in place)."""
    if isinstance(state, dict) and isinstance(state.get("params"),
                                              torch.nn.Module):
        return convert.train_state_from_jax(tree, state)
    return tree


class WorkerFailure(RuntimeError):
    """Raised by a step function when a (simulated) worker dies."""


@dataclass
class StepMonitor:
    deadline_factor: float = 5.0   # step > factor x median => presumed-dead
    straggler_factor: float = 1.5  # step > factor x median => straggler
    history: List[float] = field(default_factory=list)
    stragglers: int = 0

    def observe(self, seconds: float) -> str:
        """Returns 'ok' | 'straggler' | 'failed'."""
        med = float(np.median(self.history)) if self.history else None
        self.history.append(seconds)
        if med is None:
            return "ok"
        if seconds > self.deadline_factor * med:
            return "failed"
        if seconds > self.straggler_factor * med:
            self.stragglers += 1
            return "straggler"
        return "ok"


def run_with_restarts(step_fn: Callable[[int], Dict], *, state_ref: Dict,
                      data, n_steps: int, ckpt_dir: str, ckpt_every: int = 10,
                      max_failures: int = 10,
                      save_fn=None, restore_fn=None) -> Dict:
    """Drive ``n_steps`` of training with checkpoint/restart.

    ``step_fn(step)`` advances ``state_ref`` in place (reads ``data``) and
    may raise :class:`WorkerFailure`.  ``save_fn``/``restore_fn`` default to
    npz checkpointing of ``state_ref['state']`` + the data iterator state.
    Returns stats {completed, failures, restores}.
    """
    failures = restores = 0

    def _save(step):
        tree = {"state": _tree(state_ref["state"]), "data": data.state_dict()}
        store.save(ckpt_dir, step, tree)

    def _restore():
        like = {"state": _tree(state_ref["state"]), "data": data.state_dict()}
        tree, step = store.restore(ckpt_dir, like)
        state_ref["state"] = _untree(tree["state"], state_ref["state"])
        data.load_state_dict(tree["data"])
        return step

    save_fn = save_fn or _save
    restore_fn = restore_fn or _restore
    monitor = StepMonitor()
    save_fn(0)
    step = 0
    while step < n_steps:
        t0 = time.perf_counter()
        try:
            step_fn(step)
        except WorkerFailure:
            failures += 1
            if failures > max_failures:
                raise
            step = restore_fn()
            restores += 1
            continue
        monitor.observe(time.perf_counter() - t0)
        step += 1
        if step % ckpt_every == 0:
            save_fn(step)
    return {"completed": step, "failures": failures, "restores": restores,
            "stragglers": monitor.stragglers}


@dataclass
class WorkRebalancer:
    """Greedy longest-processing-time re-assignment of over-decomposed work
    units given observed per-worker rates (units/sec)."""

    n_workers: int

    def assign(self, unit_costs: np.ndarray,
               rates: Optional[np.ndarray] = None) -> List[List[int]]:
        rates = np.ones(self.n_workers) if rates is None else rates
        order = np.argsort(unit_costs)[::-1]
        loads = np.zeros(self.n_workers)
        out: List[List[int]] = [[] for _ in range(self.n_workers)]
        for u in order:
            # finish-time-greedy: place on the worker that finishes soonest
            t = (loads + unit_costs[u]) / rates
            w = int(np.argmin(t))
            out[w].append(int(u))
            loads[w] += unit_costs[u]
        return out

    def makespan(self, assignment, unit_costs, rates=None) -> float:
        rates = np.ones(self.n_workers) if rates is None else rates
        return max(
            (sum(unit_costs[u] for u in units) / rates[w]) if units else 0.0
            for w, units in enumerate(assignment))
