"""The PIM engine with its DPU axis split over 4 gloo ranks
(``compile_cache.Shard`` / ``run_sharded``, ``PIMSystem(group=...)``; 8
DPUs, 2 a rank, on the CPU) against the JAX engine in one process, bit
for bit: every leaf of the final state (the cycle counts among them),
VA's ``KernelReport`` and ``Timeline`` (the workload's own run at scale
0.02, its oracle passing on every rank).

* ``tail``: ``cases``' ``dma_tail_clip`` on every DPU (DMAs past the last
  WRAM and MRAM word, clipped onto it).
* ``xdpu``: ``cross_dpu``'s program with the DMA size chosen by DPU pair
  (``cases``' ``cross_pair``): ranks 0 and 2 copy 256 bytes onto the
  last 64 WRAM words while ranks 1 and 3 copy 1,500 bytes in the same
  step, so those two ranks' own windows are not the system's: they replay
  with the agreed widths (a rank that kept its own width writes the
  clipped DMA's last word differently), and the DPUs stop at different
  cycles, so ranks wait in the votes with stopped DPUs that still take
  steps.
* ``xdpu_max``: the same program under ``cross_dpu_max_cycles``' knobs: its
  DPUs stop at ``max_cycles`` with tasklets still ready and DMAs in
  flight, so the steps a rank takes after its own DPUs stopped, while
  another rank's run (``Shard.catch_up``), retire DMAs and accumulate the
  time series.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402,F401

import _torch_dist as td  # noqa: E402
import repro.workloads as ref_wl  # noqa: E402
from repro.core import compile_cache as ref_cc  # noqa: E402
from repro.core import isa as ref_isa  # noqa: E402
from repro.core.config import DPUConfig  # noqa: E402
from repro.core.host import PIMSystem  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pim")
    torch.multiprocessing.spawn(
        td.torch_pim_worker, args=(td.WORLD, str(out / "store"), str(out)),
        nprocs=td.WORLD, join=True)
    return [(np.load(out / f"pim_rank{r}.npz"),
             json.loads((out / f"pim_rank{r}.json").read_text()))
            for r in range(td.WORLD)]


def _ref_run(name):
    pcfg, pbin, wram, mram, T = td.pim_launch(name)
    binary = ref_isa.Binary(*[np.array(a) for a in pbin.arrays],
                            pbin.n_instrs, dict(pbin.symbols))
    cfg = DPUConfig(**dataclasses.asdict(pcfg))
    return ref_cc.run(cfg, binary, wram, mram, n_threads=T)


def _same_state(got, prefix, ref):
    keys = sorted(k[len(prefix):] for k in got if k.startswith(prefix))
    assert keys == sorted(ref)
    for k in keys:
        g, r = got[prefix + k], np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        assert g.tobytes() == r.tobytes(), k     # bitwise, floats too


@pytest.mark.parametrize("name", td.PIM_SCENARIOS[1:])
def test_sharded_case_is_the_one_process_run(runs, name):
    ref = _ref_run(name)
    for got, _ in runs:
        _same_state(got, f"{name}/", ref)


def test_windows_set_on_another_rank_are_replayed(runs):
    replays = [meta["replays"]["xdpu"] for _, meta in runs]
    assert replays[0] > 0 and replays[2] > 0, replays


@pytest.mark.parametrize("name", ["xdpu", "xdpu_max"])
def test_ranks_whose_dpus_stopped_catch_up(runs, name):
    catch_ups = [meta["catch_ups"][name] for _, meta in runs]
    assert sum(catch_ups) > 0, catch_ups


def test_sharded_va_state_report_and_timeline(runs):
    cfg = DPUConfig(n_dpus=td.PIM_DPUS, n_tasklets=16, mram_bytes=1 << 14)
    system = PIMSystem(cfg)
    st, rep = ref_wl.get("VA").run(system, n_threads=16, scale=td.VA_SCALE)
    want_rep = json.loads(json.dumps(
        dataclasses.asdict(rep), default=lambda a: np.asarray(a).tolist()))
    want_tl = json.loads(json.dumps([list(e)
                                     for e in system.timeline.events]))
    for got, meta in runs:
        _same_state(got, "va/", st)
        assert meta["report"] == want_rep
        assert meta["timeline"] == want_tl
        assert meta["va_votes"] > 0
