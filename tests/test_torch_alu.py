"""The port's ALU (repro_torch.kernels.alu_exec) against the JAX package:
the plain-torch version against the jnp oracle and the Pallas kernel
(interpret mode), bit for bit.  The CUDA kernel is held against the plain
version on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.alu_exec.ops import alu_exec as pallas_alu  # noqa: E402
from repro.kernels.alu_exec.ref import alu_exec_ref as jnp_alu  # noqa: E402
from repro_torch.kernels.alu_exec import ops  # noqa: E402
from repro_torch.kernels.alu_exec.ref import alu_exec_ref  # noqa: E402

INT_MIN, INT_MAX = -2**31, 2**31 - 1

# tests/test_kernels.py edge cases, then the port's traps: INT_MIN/-1,
# x/0, shifts of 32 and more, negative shifts, SRL/SLL/SLTU reference
# values, and opcodes outside [0, 12)
EDGE = [(9, INT_MIN, -1), (9, 5, 0), (5, 1, 33), (7, -8, 1), (8, 2**30, 2),
        (9, INT_MIN, 1), (9, -7, 2), (9, 7, -2), (9, 0, 0), (9, INT_MAX, -1),
        (5, 1, 32), (5, 3, -1), (6, -8, 1), (6, -1, 32), (6, -1, -31),
        (7, INT_MIN, 31), (7, -1, 64), (11, -1, 3), (11, 3, -1), (10, -1, 3),
        (0, INT_MAX, 1), (1, INT_MIN, 1), (8, INT_MIN, -1), (8, 65536, 65536),
        (2, -1, 12345), (3, 0, -7), (4, -1, 5),
        (-1, 5, 1), (12, 6, 2), (16, 7, 3), (28, 8, 4), (30, 9, 5)]

# values of the semantics ROADMAP.md §2 states in its `alu_exec` row
KNOWN = [((6, -8, 1), 0x7FFFFFFC), ((5, 1, 33), 2), ((11, -1, 3), 0),
         ((9, INT_MIN, -1), INT_MIN), ((9, 5, 0), -1), ((30, 9, 5), 0)]


def _random(n, seed):
    rng = np.random.default_rng(seed)
    op = rng.integers(-2, 14, n).astype(np.int32)
    a = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64).astype(np.int32)
    b = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64).astype(np.int32)
    b[::7] = rng.integers(-40, 40, b[::7].shape)  # small shifts, x/0
    return op, a, b


def _edge():
    return tuple(np.asarray(c, np.int32) for c in zip(*EDGE))


def _port(op, a, b, device="cpu"):
    t = [torch.from_numpy(x).to(device) for x in (op, a, b)]
    return alu_exec_ref(*t).cpu().numpy()


def _cases():
    yield "edge", _edge()
    for n in (1, 127, 1024, 4099):
        yield f"random{n}", _random(n, n)


@pytest.mark.parametrize("name,case", list(_cases()), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_plain_matches_jnp_oracle_and_pallas(name, case):
    op, a, b = case
    want = np.asarray(jnp_alu(*map(jnp.asarray, case)))
    got = _port(op, a, b)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(pallas_alu(*map(jnp.asarray, case), interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("case,want", KNOWN)
def test_reference_values(case, want):
    op, a, b = (np.asarray([x], np.int32) for x in case)
    assert int(_port(op, a, b)[0]) == want


def test_cpu_wrapper_uses_plain_version_without_counting():
    op, a, b = _random(64, 3)
    before = ops.launches
    got = ops.alu_exec(*(torch.from_numpy(x) for x in (op, a, b)))
    assert ops.launches == before
    np.testing.assert_array_equal(got.numpy(), _port(op, a, b))


def test_wrapper_rejects_other_devices():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.alu_exec(t, t, t)

