"""The step kernels' driver on the CPU (repro_torch.kernels.step_driver
and the routes of cycle_step and simt_step): the pure route pickers at
every boundary on an H100's limits, the pipelined K-block loop against a
stub kernel driver, and the power-of-two forms of floor division and
remainder that the shared-memory routes use (step_common.cuh), mirrored
in torch.  The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import compile_cache  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.kernels.crf_step import ops as crf_ops  # noqa: E402
from repro_torch.kernels.cycle_step import ops as cs_ops  # noqa: E402
from repro_torch.kernels.simt_step import ops as simt_ops  # noqa: E402
from repro_torch.kernels.step_driver import (  # noqa: E402
    H100, StepDriver, drive_blocks, smem_dpus_of, smem_route_bytes)

W64K = 64 * 1024 // 4          # the Table I WRAM, in words
W8M = 8 * 1024 * 1024 // 4     # the cache study's (benchmarks/pim_figs.py)

# ---------------------------------------------------------------------------
# route pickers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 16, 32])
@pytest.mark.parametrize("W", [W64K, W8M], ids=["64KiB", "8MiB"])
@pytest.mark.parametrize("D", [1, 396, 397, 2112, 2113])
def test_cycle_step_route_boundaries(D, W, T):
    """64 KiB of WRAM fits three DPUs' rows an SM (396 DPUs on 132 SMs):
    resident_smem up to there, then the global-WRAM resident route up to
    its 2,112 DPUs, then stepwise.  8 MiB fits in no block."""
    want = ("resident_smem" if W == W64K and D <= 396
            else "resident" if D <= 2112 else "stepwise")
    assert cs_ops.pick_route(D, T, W, H100) == want


@pytest.mark.parametrize("T", [1, 16, 32])
@pytest.mark.parametrize("W", [W64K, W8M], ids=["64KiB", "8MiB"])
@pytest.mark.parametrize("D", [1, 396, 397, 2112, 2113])
def test_simt_step_route_boundaries(D, W, T):
    want = "resident_smem" if W == W64K and D <= 396 else "global"
    assert simt_ops.pick_route(D, T, W, H100) == want


@pytest.mark.parametrize("T", [1, 16, 24, 32])
def test_shared_memory_footprints(T):
    """A block's bytes: the register file (and the cycle step's issue
    plan), WRAM and the atomics, each rounded up to 16 bytes; the SM's
    228 KiB hold three such blocks at 64 KiB of WRAM."""
    regs = T * 24
    assert cs_ops.smem_bytes(T, W64K) == 4 * (
        -(-(regs + 24) // 4) * 4 + W64K + 256)
    assert simt_ops.smem_bytes(T, W64K) == 4 * (-(-regs // 4) * 4 + W64K
                                                 + 256)
    for need in (cs_ops.smem_bytes(T, W64K), simt_ops.smem_bytes(T, W64K)):
        assert H100.smem_sm // (need + H100.smem_extra) == 3
        assert smem_dpus_of(need, H100) == 396
    assert cs_ops.smem_bytes(T, W64K) == smem_route_bytes(T, W64K, 256, 24)
    assert simt_ops.smem_bytes(T, W64K) == smem_route_bytes(T, W64K, 256)
    assert cs_ops.smem_dpus(T, W8M, H100) == 0
    assert cs_ops.smem_dpus(T, 5, H100, atomic_words=3) \
        == H100.sms * H100.smem_blocks      # tiny rows: the register cap


def test_route_of_orders_the_routes():
    assert cs_ops.route_of(10, 10, 20) == "resident_smem"
    assert cs_ops.route_of(11, 10, 20) == "resident"
    assert cs_ops.route_of(21, 10, 20) == "stepwise"
    assert cs_ops.route_of(1, 0, 20) == "resident"


def test_drivers_refuse_an_unknown_route():
    with pytest.raises(ValueError, match="no route"):
        cs_ops.CycleStep(None, {}, None, route="fast")
    with pytest.raises(ValueError, match="no route"):
        simt_ops.SimtStep(None, {}, None, route="resident")
    with pytest.raises(ValueError, match="no route"):
        crf_ops.CrfStep(DPUConfig(), {}, None, route="resident_smem")


def test_only_the_step_kernels_have_a_profiling_build():
    assert cs_ops.CycleStep.SECTIONS and simt_ops.SimtStep.SECTIONS
    with pytest.raises(ValueError, match="no profiling build"):
        crf_ops.CrfStep(DPUConfig(), {}, None,
                        sections=torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("T", [1, 16, 32])
@pytest.mark.parametrize("W", [W64K, W8M], ids=["64KiB", "8MiB"])
@pytest.mark.parametrize("D", [1, 396, 397, 2112, 2113])
def test_launch_route_is_the_pure_picker_on_the_cards_limits(
        monkeypatch, D, W, T):
    """What the drivers run (launch_route) is pick_route over the limits
    the card reports, nothing else: with the card's query answering an
    H100's limits, the two agree at every boundary."""
    from repro_torch.kernels.cycle_step import cycle_step as k_step
    from repro_torch.kernels.simt_step import simt_step as k_simt
    monkeypatch.setattr(k_step, "card_limits", lambda n_threads: H100)
    monkeypatch.setattr(k_simt, "card_limits", lambda: H100)
    assert cs_ops.launch_route(D, T, W) == cs_ops.pick_route(D, T, W, H100)
    assert simt_ops.launch_route(D, T, W) \
        == simt_ops.pick_route(D, T, W, H100)


# ---------------------------------------------------------------------------
# the pipelined K-block loop
# ---------------------------------------------------------------------------


class StubKernel(StepDriver):
    """A kernel driver whose DPUs run for ``blocks`` launches: each launch
    writes its flag (some DPU runs after it) into a log, and a launch
    after the last of them changes nothing.  The loop is
    ``StepDriver``'s own; ``counted``: the launch count, one per launch
    made (:meth:`run`); ``idle``: the count of launches queued past the
    end."""

    def __init__(self, blocks: int):
        self.left, self.flags, self.counted, self.idle = blocks, [], 0, 0

    def run(self, k):
        self.left = max(self.left - 1, 0)
        self.flags.append(self.left > 0)
        self.count()
        return len(self.flags) - 1

    def flag_of(self, token):
        return self.flags[token]

    def count(self):
        self.counted += 1

    def count_idle(self):
        self.idle += 1

    def predicate(self):
        return self.flags[-1]


def _prepared(blocks):
    entry = compile_cache._Entry(make=None, key=("stub", blocks))
    kern = StubKernel(blocks)
    prep = compile_cache.Prepared(entry, None, {}, None, None, kernel=kern,
                                  pred=blocks > 0)
    return prep, kern


@pytest.mark.parametrize("k", [1, 7, 64])
@pytest.mark.parametrize("blocks", [0, 1, 5])
def test_pipelined_loop_counts_as_the_unpipelined_one(blocks, k):
    """The driver's loop (each launch queued before the last one's flag
    is read) takes the steps and driver launches of the loop that reads
    each flag before it launches again, and the same kernel launches but
    one: the launch it queues after the last that ran, which is counted
    where it is made and counted again as idle."""
    prep, kern = _prepared(blocks)
    compile_cache._drive(prep, k)
    plain, pkern = _prepared(blocks)
    while plain.running():
        plain.advance(k)
    plain.entry.steps += plain.steps
    plain.entry.launches += 1
    assert prep.steps == plain.steps == blocks * k
    assert (prep.entry.steps, prep.entry.launches) == (
        plain.entry.steps, plain.entry.launches)
    assert pkern.counted == blocks and pkern.idle == 0
    assert kern.idle == (blocks > 0)
    assert kern.counted == len(kern.flags) == blocks + kern.idle
    assert kern.counted - kern.idle == pkern.counted
    assert not prep.running()


@pytest.mark.parametrize("limit", [1, 2, 3])
def test_pipelined_loop_stops_at_its_limit(limit):
    """With a limit (profiling windows) every launch made is counted and
    none is queued past them."""
    kern = StubKernel(5)
    assert kern.drive(64, limit) == limit
    assert kern.counted == len(kern.flags) == limit
    assert kern.idle == 0


@pytest.mark.parametrize("blocks", [1, 2, 5])
def test_drive_blocks_reports_the_launch_past_the_end(blocks):
    """drive_blocks returns the launches that began with a DPU running and
    the one queued after the last of them; at a limit that ends no run it
    queues none past it."""
    flags = []

    def launch():
        flags.append(len(flags) + 1 < blocks)
        return len(flags) - 1

    assert drive_blocks(launch, flags.__getitem__) == (blocks, 1)
    assert len(flags) == blocks + 1
    flags.clear()
    assert drive_blocks(launch, flags.__getitem__, limit=blocks) \
        == (blocks, 0)
    assert len(flags) == blocks


# ---------------------------------------------------------------------------
# the power-of-two floor division and remainder (step_common.cuh)
# ---------------------------------------------------------------------------


def pow2_shift(d: int) -> int:
    """step_common::pow2_shift: log2(d) for a power of two, else -1."""
    return (d & -d).bit_length() - 1 if d > 0 and d & (d - 1) == 0 else -1


def floordiv_p2(x: torch.Tensor, d: int) -> torch.Tensor:
    """step_common::floordiv_p2 on int32: an arithmetic shift."""
    sh = pow2_shift(d)
    return x >> sh if sh >= 0 else torch.div(x, d, rounding_mode="floor")


def remainder_p2(x: torch.Tensor, n: int) -> torch.Tensor:
    """step_common::remainder_p2 on int32: the low bits."""
    sh = pow2_shift(n)
    return x & (n - 1) if sh >= 0 else torch.remainder(x, n)


def _edges():
    lo, hi = -2**31, 2**31 - 1
    vals = [lo, lo + 1, -2**30 - 1, -2**30, -65, -64, -63, -2, -1, 0, 1, 2,
            63, 64, 65, 2**30, hi - 1, hi]
    rng = np.random.default_rng(18)
    vals += list(rng.integers(lo, hi, 4000, dtype=np.int64))
    return torch.tensor(np.asarray(vals, np.int64).astype(np.int32))


@pytest.mark.parametrize("sh", [0, 1, 4, 5, 6, 10, 11, 12, 30])
def test_power_of_two_fast_paths_are_floor_semantics(sh):
    """Shift and mask give torch's floor division and remainder for every
    int32, negative ones included (T, row_bytes, page_bytes, line_bytes,
    n_sets, timeseries_window are powers of two in every configuration
    the repo runs)."""
    d = 1 << sh
    assert pow2_shift(d) == sh
    x = _edges()
    assert torch.equal(floordiv_p2(x, d), torch.div(x, d,
                                                    rounding_mode="floor"))
    assert torch.equal(remainder_p2(x, d), torch.remainder(x, d))


@pytest.mark.parametrize("d", [3, 6, 24, 100, 1000])
def test_other_divisors_keep_the_general_path(d):
    assert pow2_shift(d) == -1
    x = _edges()
    assert torch.equal(floordiv_p2(x, d), torch.div(x, d,
                                                    rounding_mode="floor"))
    assert torch.equal(remainder_p2(x, d), torch.remainder(x, d))
