"""benchmarks/torch_run.py, the suite registry of the twins, against
benchmarks/run.py on the CPU: ``--list`` prints the same bench names,
suites and caps; ``--only`` that matches nothing fails the same way; a
small traced run (``--trace --check`` over repro_torch.obs) writes its
trace and counters, passes its check, and prints the reference's rows
with the wall-clock numbers masked (each row by the keys of the script
its bench calls, read off the registry); the ``lm`` suite reads the
port's dry-run rows (``python -m repro_torch.launch.dryrun``) through
benchmarks/lm_roofline.py, and an empty directory is an error row that
names the command that writes them."""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_scripts import (load, main_lines, script_runs,  # noqa: E402
                            stand_in)

from repro import obs as ref_obs  # noqa: E402
from repro_torch import obs as pt_obs  # noqa: E402

RUN = "benchmarks/run.py"


def test_list_matches_reference():
    ref, got = main_lines(RUN, ["--list"])
    assert got == ref and ref[0] == 0
    lines = ref[1]
    assert [line[:-1] for line in lines if not line.startswith(" ")] == \
        list(load(RUN, twin=True).SUITE_NAMES)
    assert "  fault_smoke  [--smoke --check]" in lines
    assert "  lm_roofline" in lines


def test_only_matching_nothing_fails_alike():
    ref, got = main_lines(RUN, ["--suite", "comm", "--only", "nope"])
    assert got == ref and ref[0] == 1
    assert ref[1][-1].startswith(
        "SystemExit: no benchmark matches --suite 'comm' --only 'nope'; "
        "valid names: cluster_load, cluster_smoke, comm_micro")


def test_traced_suites_check_and_match(tmp_path, monkeypatch):
    """The collective microbenchmark (engine-free systems) and the trace
    replay smoke (RED in BFS's place: kernels, transfers, a recorded and
    replayed run) under --trace --check."""
    stand_in(monkeypatch, mapping={"BFS": "RED", "GEMVS": "RED"})
    # --trace sets each package's process-wide tracer: unset it after
    monkeypatch.setattr(ref_obs, "_DEFAULT", None)
    monkeypatch.setattr(pt_obs, "_DEFAULT", None)
    out = {}
    for twin in (False, True):
        lines = []
        for argv in (["--suite", "comm", "--only", "micro",
                      "--scale", "0.01"],
                     ["--suite", "pathfind", "--only", "trace_replay",
                      "--scale", "0.001"]):
            path = tmp_path / f"{twin}-{argv[1]}.trace.json"
            rc, text = script_runs.run_main(
                load(RUN, twin), argv + ["--trace", str(path), "--check"]
                + (["--device", "cpu"] if twin else []))
            assert rc == 0, text
            assert "# check: OK" in text.splitlines()[-1], text
            assert json.loads(path.read_text())["traceEvents"]
            assert path.with_suffix(".counters.json").exists()
            lines += script_runs.masked_lines(text, f"run {' '.join(argv)}")
        out[twin] = lines
    assert out[True] == out[False]
    assert [line.split(",")[0] for line in out[True]] == [
        "comm_micro", "trace_replay_smoke"]
    assert '"t_live_s": "*"' in out[True][1]


def test_every_bench_names_the_script_behind_it():
    """The masks of run.py's rows come from the registry: each bench maps
    to the twin whose function makes its rows (lm_roofline, which reads
    the dry-run's rows, to none), and every suite's benches together cover
    its scripts."""
    scripts = script_runs.bench_scripts()
    benches = load(RUN, twin=True).registry(0.0, "cpu")
    assert set(scripts) == set(benches)
    assert scripts["lm_roofline"] is None
    for name, script in scripts.items():
        if script is not None:
            assert (script_runs.ROOT / "benchmarks"
                    / f"torch_{script}.py").exists(), name
    assert {scripts[b] for b, (suite, _, _) in benches.items()
            if suite == "pathfind"} == {"pathfind_arch", "trace_replay"}
    assert scripts["simulation_rate"] == "pim_figs"


def test_lm_suite_reads_the_ports_dryrun_rows(tmp_path):
    """One architecture's dry-run rows (full width, on meta) come back as
    the suite's rows, equal to benchmarks/lm_roofline.py's table of them;
    a directory with none gives an error row."""
    from benchmarks import lm_roofline
    from repro_torch.launch import dryrun
    out = tmp_path / "dryrun"
    assert dryrun.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu",
                        "--out", str(out)]) == 0
    run = load(RUN, twin=True)
    rc, text = script_runs.run_main(
        run, ["--suite", "lm", "--device", "cpu", "--dryrun-dir", str(out)])
    assert rc == 0
    name, _, rows = text.splitlines()[0].split(",", 2)
    assert name == "lm_roofline"
    rows = json.loads(rows)
    assert rows == lm_roofline.table(str(out))
    assert {r["status"] for r in rows} == {"OK", "SKIP(policy)"}
    assert len(rows) == 4 and all(r["mesh"] == "1x1" for r in rows)
    rc, text = script_runs.run_main(
        run, ["--suite", "lm", "--device", "cpu",
              "--dryrun-dir", str(tmp_path / "none")])
    (row,) = json.loads(text.splitlines()[0].split(",", 2)[2])
    assert row["error"].startswith("FileNotFoundError: no dry-run rows in ")
    assert "python -m repro_torch.launch.dryrun" in row["error"]
