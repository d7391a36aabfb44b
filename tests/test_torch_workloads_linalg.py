"""The port's linear-algebra workloads (SpMV, TRNS, MLP) against the JAX
package on the CPU: identical KernelReport, Timeline and final state,
at 2 DPUs and the smallest size each allows (16 tasklets: their work is
fixed, and 16 tasklets issue nearly every cycle).  GEMV, the slowest
on the CPU, has a file of its own."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.workloads as ref_wl  # noqa: E402
import repro_torch.workloads as pt_wl  # noqa: E402
from repro.core import compile_cache as ref_cc  # noqa: E402
from repro.core.stats import report_from_state as ref_report  # noqa: E402
from repro_torch.core import compile_cache as pt_cc  # noqa: E402
from repro_torch.core.carry import config_from  # noqa: E402
from repro_torch.core.engine import DONE  # noqa: E402
from repro_torch.core.stats import report_from_state as pt_report  # noqa: E402
from test_torch_workloads import (_assert_report, _assert_state,  # noqa: E402
                                  _same_run, _small_cfg)


@pytest.mark.parametrize("name", ["SpMV", "TRNS"])
def test_report_timeline_state_match_reference(name):
    _same_run(name, _small_cfg(16), 16, scale=0.001)


def test_mlp_prefix_matches_reference():
    """MLP's three 128 x 128 layers are ~500,000 instructions a DPU at any
    scale, ~500,000 steps of the port's CPU driver: on the CPU both
    packages' engines run its launch to ``max_cycles`` (the first layer's
    staging, barrier and MAC loop) and every state leaf and the report
    must agree; its whole run is held on the card against goldens.json."""
    cfg = _small_cfg(16, mram_bytes=1 << 18, max_cycles=12_000)
    ref_w, pt_w = ref_wl.get("MLP"), pt_wl.get("MLP")
    hd = ref_w.host_data(cfg, 0.001, 0)
    ref_bin = ref_w.build(16).binary(cfg.iram_instrs)
    pt_bin = pt_w.build(16).binary(cfg.iram_instrs)
    for a, b in zip(ref_bin.arrays, pt_bin.arrays):
        assert np.array_equal(a, b)
    wram = np.zeros((cfg.n_dpus, 16), np.int32)
    wram[:, :hd.args.shape[1]] = hd.args
    ref_st = {k: np.asarray(v) for k, v in ref_cc.run(
        cfg, ref_bin, wram, hd.mram, n_threads=16).items()}
    pt_st = pt_cc.run(config_from(cfg), pt_bin, wram, hd.mram, n_threads=16,
                      device="cpu")
    assert (pt_st["status"] != DONE).any(), "MLP ended inside the prefix"
    assert int(pt_st["cycle"].max()) == cfg.max_cycles
    _assert_state(ref_st, pt_st)
    _assert_report(ref_report("MLP", cfg, ref_st, 16),
                   pt_report("MLP", config_from(cfg), pt_st, 16))
