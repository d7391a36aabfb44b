"""The port's search (BS, TS) and histogram (HST-S, HST-L) workloads
against the JAX package on the CPU: identical KernelReport, Timeline and
final state.  2 DPUs at the smallest size ``n_elems`` allows; the thread
count of each case is the one that takes the port fewest steps (HST-S's
per-tasklet bins make one thread cheapest; the others' work is fixed, so
16 tasklets, which issue nearly every cycle, are)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_workloads import _same_run, _small_cfg  # noqa: E402


@pytest.mark.parametrize("name,threads", [("BS", 16), ("TS", 16),
                                          ("HST-S", 1), ("HST-L", 16)])
def test_report_timeline_state_match_reference(name, threads):
    _same_run(name, _small_cfg(threads), threads, scale=0.001)
