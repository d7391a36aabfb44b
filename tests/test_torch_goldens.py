"""src/repro_torch/workloads/goldens.json, the numbers the port is held
to on the CUDA card (where there is no JAX): the JAX package reproduces
every entry of the 4-DPU configuration and the remap scenario, the
recorded configurations are the module's, and the entry function gives
the same entry for either package's run."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.workloads as ref_wl  # noqa: E402
import repro_torch.workloads as pt_wl  # noqa: E402
from repro.core.config import DPUConfig  # noqa: E402
from repro.core.host import PIMSystem as RefSystem  # noqa: E402
from repro.faults import FaultPlan, kill_dpu  # noqa: E402
from repro_torch.core.carry import config_from  # noqa: E402
from repro_torch.core.host import PIMSystem as PtSystem  # noqa: E402
from repro_torch.workloads import goldens  # noqa: E402

GOLD = goldens.load()


def test_goldens_hold_every_workload_and_the_configurations():
    assert sorted(GOLD["entries"]) == sorted(goldens.CONFIGS)
    for key, (fields, threads, scale, seed) in goldens.CONFIGS.items():
        assert GOLD["configs"][key] == {"dpu_config": fields,
                                        "threads": threads, "scale": scale,
                                        "seed": seed}
        assert sorted(GOLD["entries"][key]) == \
            goldens.workloads_of(key, ref_wl.ALL)
    from repro.workloads import sort as ref_sort
    from repro_torch.workloads import sort as pt_sort
    assert goldens.MAX_DPUS == {"SSORT": ref_sort.MAX_D} \
        == {"SSORT": pt_sort.MAX_D}
    # the VA and BFS pins of tests/test_backend.py, at g4's other MRAM size
    assert (GOLD["entries"]["g4"]["VA"]["cycles"],
            GOLD["entries"]["g4"]["VA"]["issued"]) == (5336, 11488)
    assert (GOLD["entries"]["g4"]["BFS"]["cycles"],
            GOLD["entries"]["g4"]["BFS"]["issued"]) == (68900, 30916)


@pytest.mark.parametrize("name", sorted(ref_wl.ALL))
def test_jax_package_reproduces_g4_golden(name):
    rep, system, st = goldens.run_config(ref_wl, DPUConfig, RefSystem, "g4",
                                         name)
    got = goldens.entry(rep, system, st)
    assert goldens.differences(GOLD["entries"]["g4"][name], got) == []
    assert got == GOLD["entries"]["g4"][name]


def test_jax_package_reproduces_remap_golden():
    rep, system, st = goldens.run_remap(ref_wl, DPUConfig, RefSystem,
                                        FaultPlan, kill_dpu)
    got = goldens.remap_entry(rep, system, st)
    assert got == GOLD["remap"]
    assert ["permanent", [goldens.REMAP[2][0]]] in got["fault_log"]


def test_entry_is_the_same_for_either_package():
    cfg = DPUConfig(n_dpus=2, n_ranks=1, n_channels=1, n_tasklets=8,
                    mram_bytes=1 << 14)
    ref_sys = RefSystem(cfg)
    ref_st, ref_rep = ref_wl.get("RED").run(ref_sys, 8, scale=0.003)
    pt_sys = PtSystem(config_from(cfg), device="cpu")
    pt_st, pt_rep = pt_wl.get("RED").run(pt_sys, 8, scale=0.003)
    assert goldens.entry(ref_rep, ref_sys, ref_st) == \
        goldens.entry(pt_rep, pt_sys, pt_st)


def test_digest_sees_one_bit_of_any_field_or_leaf():
    cfg = DPUConfig(n_dpus=2, n_ranks=1, n_channels=1, n_tasklets=8,
                    mram_bytes=1 << 14)
    st, rep = ref_wl.get("RED").run(RefSystem(cfg), 8, scale=0.003)
    st = {k: np.array(v) for k, v in st.items()}
    base = goldens.digest(rep, st)
    flipped = dict(st, mram=st["mram"].copy())
    flipped["mram"].flat[-1] ^= 1
    assert goldens.digest(rep, flipped) != base
    assert goldens.digest(dataclasses.replace(rep, cycles=rep.cycles + 1),
                          st) != base
    assert goldens.digest(dataclasses.replace(
        rep, dma_rd_bytes=np.nextafter(rep.dma_rd_bytes, np.inf)), st) != base
    retyped = dict(st, cycle=st["cycle"].astype(np.int64))
    assert goldens.digest(rep, retyped) != base
