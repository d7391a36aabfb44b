"""examples/torch_quickstart.py against examples/quickstart.py on the
CPU: given the reference's initial weights (``--init``, an npz of the JAX
package's ``init_params`` at the quickstart's key), the twin trains,
checkpoints at step 60, restores and serves, and prints the reference's
lines: each step's loss and gradient norm within
``script_runs.QUICKSTART_TOL`` (0 departures measured here), every other
line equal (the served completions among them).  goldens.json's
quickstart lines, which ``chip_smoke.py`` [train] holds the twin on the
card to, are the reference's, tests/data/quickstart_init.npz holds its
initial weights and tests/data/quickstart_data.npz the batches it took
(its data pipeline's, on this machine's numpy)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_scripts import ROOT, load, script_runs  # noqa: E402
import make_workload_goldens  # noqa: E402  (tools/, on the path)
from repro_torch.workloads import goldens  # noqa: E402


@pytest.fixture(scope="module")
def reference_lines():
    rc, text = script_runs.run_main(load("examples/quickstart.py"), [])
    assert rc == 0
    return text.splitlines()


def test_twin_prints_the_reference_lines(tmp_path, reference_lines):
    init = tmp_path / "init.npz"
    make_workload_goldens.quickstart_init(init)
    rc, text = script_runs.run_main(
        load("examples/quickstart.py", twin=True),
        ["--device", "cpu", "--init", str(init)])
    assert rc == 0
    lines = text.splitlines()
    assert script_runs.quickstart_departures(lines, reference_lines) == []
    losses = script_runs.quickstart_losses(lines)
    assert len(losses) == 7 and losses[-1] < losses[0] - 2


def test_golden_is_the_reference(tmp_path, reference_lines):
    gold = goldens.load()["quickstart"]
    assert gold["rc"] == 0 and gold["lines"] == reference_lines
    init = tmp_path / "init.npz"
    make_workload_goldens.quickstart_init(init)
    with np.load(init) as want, np.load(ROOT / gold["init"]) as got:
        assert sorted(want.files) == sorted(got.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])
        n = sum(int(np.prod(want[k].shape)) for k in want.files)
    assert reference_lines[0] == f"model: {n / 1e6:.2f}M params"
    twin = load("examples/quickstart.py", twin=True)
    with np.load(ROOT / gold["data"]) as z:
        steps, batch, seq = z["tokens"].shape
        ds = twin.SyntheticLM(twin.config(), twin.DataConfig(
            seq_len=seq, global_batch=batch,
            vocab_size=twin.config().vocab_size))
        for i in range(steps):
            for k, v in ds.batch_at(i).items():
                np.testing.assert_array_equal(z[k][i], v)
