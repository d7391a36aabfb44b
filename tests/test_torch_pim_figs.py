"""benchmarks/torch_pim_figs.py, the paper's figure studies on the port,
against benchmarks/pim_figs.py on the CPU: the characterization sweep
(and the figures projected from it) gives the same rows apart from wall
time; the SIMT study gives the reference's rows; the entry point runs
on the card unless told otherwise.  The ILP ablation is in
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


def _cheap_fig11(monkeypatch):
    """Fig. 11 on VA in place of GEMV in both packages: GEMV's Base design
    alone is ~63,000 CPU steps at any scale (whole on the card)."""
    import repro.workloads as ref_wl
    import repro_torch.workloads as pt_wl
    monkeypatch.setattr(pim_figs.wl, "get", lambda name: ref_wl.ALL["VA"])
    monkeypatch.setattr(torch_pim_figs.wl, "get",
                        lambda name: pt_wl.ALL["VA"])


def test_fig11_simt_names_its_roadmap_item(monkeypatch):
    """The SIMT study runs (all five designs on the SIMT engine but Base)
    and gives pim_figs.fig11_simt's rows exactly."""
    _cheap_fig11(monkeypatch)
    ref = pim_figs.fig11_simt(SCALE)
    got = torch_pim_figs.fig11_simt(SCALE, device="cpu")
    assert [r["design"] for r in got] == ["Base", "SIMT", "SIMT+AC",
                                          "SIMT+AC+4x", "SIMT+AC+16x"]
    assert got == ref


def test_main_runs_on_the_card_unless_told(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _cheap_fig11(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_pim_figs.main(["--only", "fig11"])
    assert torch_pim_figs.main(["--only", "fig11", "--device", "cpu",
                                "--scale", str(SCALE)]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [r.get("design") for r in rows[:5]] == [
        "Base", "SIMT", "SIMT+AC", "SIMT+AC+4x", "SIMT+AC+16x"]
    assert all(r["study"] == "fig11_simt" for r in rows)
    assert len(rows) == 6 and "wall_s" in rows[5]
    with pytest.raises(SystemExit):
        torch_pim_figs.main(["--only", "nope", "--device", "cpu"])
