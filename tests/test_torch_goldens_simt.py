"""The SIMT and HBM-PIM entries of src/repro_torch/workloads/goldens.json
(s4, s4ac, h4, c4, fig11/*; the card holds every one of them): the
configurations are the module's, the capped workloads are recorded by
their error and the digest of their capped state, and the port
reproduces the entries it can run in seconds on the CPU, and a capped
run's error and state at a small cap as the JAX package gives them."""
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.workloads as ref_wl  # noqa: E402
import repro_torch.workloads as pt_wl  # noqa: E402
from repro.core import compile_cache as ref_cc  # noqa: E402
from repro.core.config import DPUConfig as RefConfig  # noqa: E402
from repro.core.host import PIMSystem as RefSystem  # noqa: E402
from repro_torch.core import compile_cache  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.workloads import goldens  # noqa: E402

GOLD = goldens.load()
NEW = list(goldens.SIMT_KEYS)


def test_new_configurations_and_outcomes_are_recorded():
    assert NEW == ["s4", "s4ac", "h4", "c4"] + [f"fig11/{d}"
                                                for d in goldens.FIG11]
    assert goldens.SCALAR_KEYS == ("g4", "g64")
    for key in NEW:
        fields, threads, scale, seed = goldens.CONFIGS[key]
        assert fields["max_cycles"] == goldens.CAP == 400_000
        assert sorted(GOLD["entries"][key]) == \
            goldens.workloads_of(key, pt_wl.ALL)
    assert goldens.workloads_of("c4", pt_wl.ALL) == ["GEMVS"]
    # HST-L and TRNS spin on a held mutex under min-PC reconvergence
    for key in ("s4", "s4ac", "h4"):
        for name in ("HST-L", "TRNS"):
            e = GOLD["entries"][key][name]
            assert sorted(e) == ["raises", "state_digest"]
            assert e["raises"] == (f"RuntimeError: {name}: kernel hit "
                                   "max_cycles=400000 (status=[0])")
            assert re.fullmatch("[0-9a-f]{64}", e["state_digest"])
    # tests/test_backend.py's VA-simt pin, at s4's other MRAM size
    assert (GOLD["entries"]["s4"]["VA"]["cycles"],
            GOLD["entries"]["s4"]["VA"]["issued"]) == (2133, 11488)


@pytest.mark.parametrize("key,name", [
    ("s4", "RED"), ("s4", "SCAN-RSS"), ("s4ac", "RED"), ("s4ac", "SEL"),
    ("h4", "RED"), ("h4", "SCAN-SSA"), ("c4", "GEMVS")])
def test_port_reproduces_entry_on_cpu(key, name):
    got = goldens.run_entry(pt_wl, DPUConfig, PIMSystem, compile_cache, key,
                            name, device="cpu")
    assert goldens.differences(GOLD["entries"][key][name], got) == []
    assert got == GOLD["entries"][key][name]


@pytest.mark.parametrize("key", ["s4", "h4"])
def test_capped_run_raises_what_the_reference_raises(key, monkeypatch):
    """HST-L at a cap of 3,000 cycles (the golden's 400,000 take minutes
    on the CPU): the same error, first line and all, and the same capped
    state from either package."""
    fields, threads, scale, seed = goldens.CONFIGS[key]
    monkeypatch.setitem(goldens.CONFIGS, key,
                        (dict(fields, max_cycles=3000), threads, scale, seed))
    want = goldens.run_entry(ref_wl, RefConfig, RefSystem, ref_cc, key,
                             "HST-L")
    got = goldens.run_entry(pt_wl, DPUConfig, PIMSystem, compile_cache, key,
                            "HST-L", device="cpu")
    assert got == want
    assert got["raises"] == ("RuntimeError: HST-L: kernel hit "
                             "max_cycles=3000 (status=[0])")
    assert re.fullmatch("[0-9a-f]{64}", got["state_digest"])
