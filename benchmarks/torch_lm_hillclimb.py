"""Re-run the three hillclimbed LM cells with the current model code and
diff against the baseline dry-run rows.

On the PyTorch/CUDA port (benchmarks/lm_hillclimb.py's run on
``repro_torch``): each cell is counted on the meta device and priced on
one H100 (``repro_torch.launch.dryrun.run_cell``), and the baseline is the
port's one-card sweep in ``--dryrun-dir`` (``python -m
repro_torch.launch.dryrun --mesh 1x1`` writes its ``__1x1`` rows).  ``--device`` is the device the run is for (default: the CUDA
card, raising without one; cpu asks for the CPU); the counts do not
depend on it.

    python benchmarks/torch_lm_hillclimb.py [--dryrun-dir reports/torch_dryrun]
        [--out reports/torch_hillclimb] [--device cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.carry import resolve_device  # noqa: E402

CELLS = [
    ("llama3-8b", "train_4k"),
    ("deepseek-v3-671b", "train_4k"),
    ("mamba2-130m", "train_4k"),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="reports/torch_dryrun")
    ap.add_argument("--out", default="reports/torch_hillclimb")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu asks "
                         "for the CPU)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from repro_torch.launch.dryrun import run_cell
    os.makedirs(args.out, exist_ok=True)
    for arch, shape in CELLS:
        row = run_cell(arch, shape)
        with open(os.path.join(args.out, f"{arch}__{shape}.json"), "w") as f:
            json.dump(row, f, indent=1)
        base_p = os.path.join(args.dryrun_dir, f"{arch}__{shape}__1x1.json")
        if os.path.exists(base_p):
            with open(base_p) as f:
                base = json.load(f)
            for k in ("compute_ms", "memory_ms", "collective_ms",
                      "useful_ratio", "roofline_fraction"):
                print(f"  {arch} {k}: {base.get(k)} -> {row.get(k)}")


if __name__ == "__main__":
    main()
