"""Deterministic synthetic LM data pipeline.

* Reproducible: batch(step) is a pure function of (seed, step) — restart
  from a checkpointed step reproduces the exact stream (tested).
* Shard-aware: each host generates only its slice (``host_index`` /
  ``host_count``), so the pipeline scales to multi-host fleets without a
  central reader.
* Family-aware: produces the right batch dict for lm / vlm / encdec.

The "corpus" is a deterministic mixture of Zipfian tokens with local
n-gram structure, so cross-entropy has signal to minimise (quickstart
shows monotone loss descent)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    def __init__(self, cfg, dc: DataConfig):
        self.cfg = cfg
        self.dc = dc
        assert dc.global_batch % dc.host_count == 0
        self.local_batch = dc.global_batch // dc.host_count
        self.step = 0

    # --- deterministic generation -----------------------------------------
    def _rng(self, step: int):
        return np.random.default_rng(
            (self.dc.seed * 1_000_003 + step) * 131 + self.dc.host_index)

    def _tokens(self, rng, batch, seq):
        V = self.dc.vocab_size
        # Zipfian unigrams with a deterministic bigram successor table:
        # with p=0.5 the next token is succ[prev] -> learnable structure
        base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64) % V
        succ = (np.arange(V) * 7 + 13) % V
        out = base.copy()
        follow = rng.random((batch, seq)) < 0.5
        out[:, 1:] = np.where(follow[:, 1:], succ[out[:, :-1]], base[:, 1:])
        return out.astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S = self.local_batch, self.dc.seq_len
        fam = self.cfg.family
        if fam == "encdec":
            tgt = self._tokens(rng, B, S)
            frames = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
            labels = np.concatenate([tgt[:, 1:], -np.ones((B, 1), np.int32)],
                                    axis=1)
            return {"frames": frames, "tokens": tgt,
                    "labels": labels.astype(np.int32)}
        if fam == "vlm":
            P = self.cfg.n_frontend_tokens
            txt = self._tokens(rng, B, S - P)
            patches = rng.standard_normal(
                (B, P, self.cfg.d_model)).astype(np.float32)
            labels = np.concatenate([txt[:, 1:], -np.ones((B, 1), np.int32)],
                                    axis=1)
            return {"tokens": txt, "labels": labels.astype(np.int32),
                    "patches": patches}
        toks = self._tokens(rng, B, S)
        labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)],
                                axis=1)
        return {"tokens": toks, "labels": labels.astype(np.int32)}

    # --- iterator protocol with restorable state ---------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, s):
        self.step = int(s["step"])
