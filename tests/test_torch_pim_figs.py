"""benchmarks/torch_pim_figs.py, the paper's figure studies on the port,
against benchmarks/pim_figs.py on the CPU: the characterization sweep
(and the figures projected from it) gives the same rows apart from wall
time; the SIMT study names the module it waits for; the entry point
runs on the card unless told otherwise.  The ILP ablation is in
test_torch_pim_figs_ilp.py."""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import pim_figs, torch_pim_figs  # noqa: E402

SCALE = 0.001


def test_characterize_and_projections_match_reference(tmp_path):
    kw = dict(workloads=["HST-S", "BS"], threads=(4,))
    ref = pim_figs.characterize(SCALE, cache_path=str(tmp_path / "r.json"),
                                **kw)
    got = torch_pim_figs.characterize(SCALE,
                                      cache_path=str(tmp_path / "t.json"),
                                      device="cpu", **kw)
    assert sorted(got) == sorted(ref) == ["BS/4/0.001", "HST-S/4/0.001"]
    for key in ref:
        r, g = dict(ref[key]), dict(got[key])
        r.pop("wall_s")
        g.pop("wall_s")
        assert g == r, key
    for fig in ("fig5_utilization", "fig6_breakdown", "fig7_tlp_hist",
                "fig8_tlp_timeseries", "fig9_instr_mix"):
        assert getattr(torch_pim_figs, fig)(got, SCALE) == \
            getattr(pim_figs, fig)(ref, SCALE)
    # a second call reads its own cache, not the JAX package's
    again = torch_pim_figs.characterize(
        SCALE, cache_path=str(tmp_path / "t.json"), device="cpu", **kw)
    assert again == got
    assert torch_pim_figs.CHAR_CACHE == "reports/torch_pim_char.json"


def test_fig11_simt_names_its_roadmap_item():
    with pytest.raises(NotImplementedError,
                       match="core/simt.py \\+ SimtBackend"):
        torch_pim_figs.fig11_simt(SCALE, device="cpu")


def test_main_runs_on_the_card_unless_told(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_pim_figs.main(["--only", "fig11"])
    assert torch_pim_figs.main(["--only", "fig11", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert rows[0]["study"] == "fig11_simt" and "not_ported" in rows[0]
    assert rows[1]["study"] == "fig11_simt" and "wall_s" in rows[1]
    with pytest.raises(SystemExit):
        torch_pim_figs.main(["--only", "nope", "--device", "cpu"])
