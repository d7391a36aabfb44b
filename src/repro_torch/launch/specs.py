"""Abstract inputs and cells of every (arch x shape), on the meta device.

The counterpart of ``repro.launch.specs``: :func:`input_specs` returns
meta tensors of the reference's shapes and dtypes (no allocation), and
:func:`make_cell` packages a cell's step function (the train step with the
configuration's optimizer, remat and microbatches; prefill; one decode
step) with its arguments built on meta, for ``launch/dryrun.py`` to
count.  The reference also returns the arguments' shardings, which its
``jit`` reads; the port's one-card count reads none, so it builds none
(``parallel/api.py`` computes them for a mesh).  The port
donates nothing: its train step and decode step update their state in
place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.train import loop as train_loop

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(cfg: ArchConfig) -> T.Transformer:
    return T.Transformer(cfg, device="meta")


def abstract_state(cfg: ArchConfig):
    opt = get_optimizer(cfg.optimizer, warmup_cosine(3e-4))
    return train_loop.init_train_state(cfg, opt, device="meta"), opt


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Training/prefill batch stand-ins (matches repro_torch.data.pipeline)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f32 = torch.float32
    if cfg.family == "encdec":
        return {"frames": _meta((B, S, cfg.d_model), f32),
                "tokens": _meta((B, S), i32),
                "labels": _meta((B, S), i32)}
    if cfg.family == "vlm":
        Pn = cfg.n_frontend_tokens
        return {"tokens": _meta((B, S - Pn), i32),
                "labels": _meta((B, S - Pn), i32),
                "patches": _meta((B, Pn, cfg.d_model), f32)}
    return {"tokens": _meta((B, S), i32),
            "labels": _meta((B, S), i32)}


def prefill_specs(cfg, shape):
    b = batch_specs(cfg, shape)
    b.pop("labels", None)
    return b


def decode_specs(cfg: ArchConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    cache = T.init_cache(cfg, B, S, device="meta", src_len=S)
    tokens = _meta((B,), torch.int32)
    return cache, tokens


def input_specs(cfg: ArchConfig, shape_name: str):
    """Public entry: abstract model inputs for one cell (no allocation)."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    cache, tokens = decode_specs(cfg, shape)
    return {"cache": cache, "tokens": tokens}


# ---------------------------------------------------------------------------
# Cell construction (fn + args)
# ---------------------------------------------------------------------------


def make_cell(cfg: ArchConfig, shape):
    """Returns dict(fn, args, kind) for ``shape`` (a name of ``SHAPES`` or
    a :class:`ShapeSpec`)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if not cfg.supports_shape(shape):
        raise ValueError(f"{cfg.name} does not take {shape.name}")

    if shape.kind == "train":
        state, opt = abstract_state(cfg)
        step = train_loop.make_train_step(
            cfg, opt, microbatches=cfg.train_microbatches)
        return dict(fn=step, args=(state, batch_specs(cfg, shape)),
                    kind="train")

    params = abstract_params(cfg)

    if shape.kind == "prefill":
        def fn(params, batch):
            return params.prefill(batch)

        return dict(fn=fn, args=(params, prefill_specs(cfg, shape)),
                    kind="prefill")

    cache, tokens = decode_specs(cfg, shape)

    def fn(params, cache, tokens):
        return params.decode_step(cache, tokens)

    return dict(fn=fn, args=(params, cache, tokens), kind="decode")
