"""The port's measured cluster profiles against the JAX package, on the
CPU: ``measure_profile`` runs the real workload (kernels, collectives,
its numpy oracle) on a fresh 4-DPU reference rank and distils its
``Timeline`` into a ``JobProfile``; both packages' profiles must be
identical (tolerance 0).  HST-S runs one tasklet (its bins grow with
tasklets, so one issues least on the CPU), BFS sixteen."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.cluster import scheduler as j_scheduler  # noqa: E402
from repro_torch.cluster import scheduler  # noqa: E402
from repro_torch.workloads.goldens import profile_steps  # noqa: E402


@pytest.mark.parametrize("kind,n_threads", [("BFS", 16), ("HST-S", 1)])
def test_measure_profile_matches_jax(kind, n_threads):
    kw = dict(n_dpus=4, n_threads=n_threads, scale=0.02, seed=0)
    want = j_scheduler.measure_profile(kind, **kw)
    got = scheduler.measure_profile(kind, device="cpu", **kw)
    assert got.kind == want.kind == kind
    assert profile_steps(got) == profile_steps(want)
    assert any(s.phase == "kernel" and s.seconds > 0 for s in got.steps)
    # cached per parameter set and device: the engine ran once
    assert scheduler.measure_profile(kind, device="cpu", **kw) is got
