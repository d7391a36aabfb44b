"""benchmarks/torch_pim_figs.py's ILP ablation (Fig. 12: forwarding,
unified register file, 2-way superscalar, 700 MHz, added one at a time)
on TS against benchmarks/pim_figs.py on the CPU: the same rows.  TS
issues ~18,000 instructions a DPU at its smallest size, five designs;
a file of its own, the slowest of the figure studies on the CPU."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import pim_figs, torch_pim_figs  # noqa: E402


def test_fig12_ilp_matches_reference():
    ref = pim_figs.fig12_ilp(0.001, workloads=("TS",))
    got = torch_pim_figs.fig12_ilp(0.001, workloads=("TS",), device="cpu")
    assert got == ref and len(got) == 5
