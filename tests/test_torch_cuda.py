"""Card-only tests of the port (marker ``cuda``; each skips without a
CUDA card).  This file imports neither jax nor the JAX package, so it
runs on a machine with the card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The CPU-side parity against the JAX package is in the other
tests/test_torch_*.py files."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import compile_cache  # noqa: E402
from repro_torch.core.asm import DPU_ID, Program, TID  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.kernels.alu_exec import ops  # noqa: E402
from repro_torch.kernels.alu_exec.ref import alu_exec_ref  # noqa: E402

INT_MIN, INT_MAX = -2**31, 2**31 - 1
EDGE = [(9, INT_MIN, -1), (9, 5, 0), (5, 1, 33), (7, -8, 1), (8, 2**30, 2),
        (6, -1, 32), (6, -1, -31), (7, -1, 64), (11, -1, 3), (0, INT_MAX, 1),
        (1, INT_MIN, 1), (8, INT_MIN, -1), (-1, 5, 1), (12, 6, 2), (30, 9, 5)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _random(n, seed):
    rng = np.random.default_rng(seed)
    op = rng.integers(-2, 14, n).astype(np.int32)
    a = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64).astype(np.int32)
    b = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64).astype(np.int32)
    b[::7] = rng.integers(-40, 40, b[::7].shape)
    return op, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 64, 127, 1 << 20],
                         ids=["edge", "1", "64", "127", "1M"])
def test_alu_kernel_matches_plain_version(card, n):
    case = tuple(np.asarray(c, np.int32) for c in zip(*EDGE)) if n == 0 \
        else _random(n, n)
    t = [torch.from_numpy(x).to(card) for x in case]
    before = ops.launches
    got = ops.alu_exec(*t)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.equal(got, alu_exec_ref(*t))


@pytest.mark.cuda
def test_alu_wrapper_rejects_what_the_kernel_cannot_take(card):
    x = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        ops.alu_exec(x, x.to(torch.int64), x)
    with pytest.raises(ValueError):
        ops.alu_exec(x, x, torch.zeros(16, dtype=torch.int32,
                                       device=card)[::2])
    with pytest.raises(ValueError):
        ops.alu_exec(x, x.cpu(), x)


def _prog(nt=4):
    p = Program("multi", nt)
    buf = p.walloc("buf", nt * 64)
    w, m, i, v = p.regs("w", "m", "i", "v")
    p.mul(w, TID, 64)
    p.add(w, w, buf)
    p.mul(m, DPU_ID, 1024)
    p.mul(i, TID, 64)
    p.add(m, m, i)
    with p.for_range(i, 0, 3):
        p.ldma(w, m, 64)
        p.lw(v, w, 4)
        p.add(v, v, DPU_ID)
        p.mul(v, v, 3)
        p.sw(w, 0, v)
        p.sdma(w, m, 32)
        p.add(m, m, 256)
    p.stop()
    return p


@pytest.mark.cuda
def test_card_driver_matches_cpu(card):
    """The CUDA-graph driver gives the CPU's state bit for bit, and every
    ALU call on the card is a counted launch."""
    cfg = DPUConfig(n_dpus=3, n_tasklets=16, mram_bytes=1 << 14,
                    superscalar=2, forwarding=True, unified_rf=True)
    binary = _prog().binary(cfg.iram_instrs)
    wram = np.zeros((3, 16), np.int32)
    mram = np.arange(3 * cfg.mram_words, dtype=np.int32).reshape(3, -1)
    want = compile_cache.run(cfg, binary, wram, mram, 4, device="cpu")
    steps0, launches0 = compile_cache.stats()["steps"], ops.launches
    got = compile_cache.run(cfg, binary, wram, mram, 4, device=card)
    for k in want:
        assert want[k].tobytes() == got[k].tobytes(), k
    steps = compile_cache.stats()["steps"] - steps0
    assert ops.launches - launches0 == cfg.superscalar * steps > 0
