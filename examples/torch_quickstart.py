"""Quickstart on the PyTorch/CUDA port: train a tiny llama-family LM on
the synthetic corpus, checkpoint, restart mid-run, and greedy-decode from
the served model (examples/quickstart.py on ``repro_torch``, on the CUDA
card unless ``--device cpu`` asks for the CPU).

    python examples/torch_quickstart.py [--device cpu] [--init NPZ]

The weights are random from a seed (the two frameworks draw different
numbers from one seed); ``--init`` starts from the parameters in an npz
of the JAX package's tree, keyed by leaf path (``blocks/attn/wq``), such
as the reference's own initial weights that
``tools/make_workload_goldens.py --only quickstart`` writes to
tests/data/quickstart_init.npz.  The checkpoint is written in the JAX
package's layout, which either package restores.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.ckpt import store
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.carry import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import convert
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import loop as train_loop


def config():
    return get_smoke_config("llama3-8b").replace(
        dtype="float32", n_layers=2, d_model=128, d_ff=256, vocab_size=512)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu asks "
                         "for the CPU)")
    ap.add_argument("--init", default=None,
                    help="npz of initial parameters in the JAX package's "
                         "layout (default: random from seed 0)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config()
    opt = get_optimizer("adamw", warmup_cosine(3e-3, warmup=10, total=200))
    state = train_loop.init_train_state(cfg, opt, device=device)
    if args.init:
        with np.load(args.init) as z:
            tree = convert.nest({k: z[k] for k in z.files})
        state["params"].load_state_dict(convert.state_dict_from_jax(tree),
                                        strict=True)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"model: {n_params/1e6:.2f}M params")

    step = train_loop.make_train_step(cfg, opt, microbatches=2)
    ds = SyntheticLM(cfg, DataConfig(seq_len=64, global_batch=8,
                                     vocab_size=cfg.vocab_size))
    with tempfile.TemporaryDirectory(prefix="quickstart_ckpt_") as ckpt:
        for i in range(120):
            batch = train_loop.to_device(next(ds), device)
            state, m = step(state, batch)
            if i % 20 == 0:
                print(f"step {i:4d} loss {float(m['loss']):.3f} "
                      f"gnorm {float(m['grad_norm']):.2f}")
            if i == 60:
                tree = {"state": convert.train_state_to_jax(state),
                        "data": ds.state_dict()}
                store.save(ckpt, i, tree)
                print("checkpointed at step 60; simulating restart...")
                restored, _ = store.restore(ckpt, tree)
                state = convert.train_state_from_jax(restored["state"],
                                                     state)
                ds.load_state_dict(restored["data"])
    print(f"final loss {float(m['loss']):.3f} (started ~{np.log(512):.2f})")

    eng = ServeEngine(cfg, state["params"], batch=2, capacity=96)
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab_size, 8), max_new=8)
    outs = eng.run()
    print("served completions:", {k: v for k, v in outs.items()})


if __name__ == "__main__":
    main()
