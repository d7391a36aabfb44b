"""The port's flash attention against the JAX package, on the CPU.

* the plain version of the CUDA kernel (``ops.flash_attention`` on a CPU
  tensor) against the Pallas kernel ``flash_attention_op`` (interpret
  mode, as tests/test_kernels.py runs it) and against ``attention_ref``,
  at the cases of tests/test_kernels.py: 2e-5 in float32, 5e-2 in bf16;
* the port's CPU ``blocked_attention`` against the JAX package's, at 2e-5
  in float32 (including its window blocking, which differs from exact
  window attention: ROADMAP §3);
* the wrapper's rule that picks the CUDA kernel of a call from its dtype
  and head widths (``ops.route``; pure Python, so it runs here).

The same inputs, made from a numpy seed, go to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention_op  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models.attention import blocked_attention as jax_blocked  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models.attention import blocked_attention  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 5e-2

#: tests/test_kernels.py::test_flash_kernel_vs_ref
CASES = [
    (128, 4, 4, 32, 32, True, 0),
    (128, 8, 2, 16, 16, True, 0),     # GQA
    (256, 4, 1, 32, 64, True, 0),     # MQA + Dv != Dk
    (128, 4, 4, 32, 32, False, 0),    # bidirectional (encoder)
    (256, 4, 2, 32, 32, True, 64),    # local window
]


def _qkv(seed, b, s, h, kv, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dk), np.float32),
            rng.standard_normal((b, s, kv, dk), np.float32),
            rng.standard_normal((b, s, kv, dv), np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("s,h,kv,dk,dv,causal,window", CASES)
def test_plain_flash_matches_pallas_kernel_and_ref(s, h, kv, dk, dv, causal,
                                                   window):
    q, k, v = _qkv(s + h, 2, s, h, kv, dk, dv)
    before = ops.launches, ops.launches_sm90
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window)
    # the CPU path launches no kernel
    assert (ops.launches, ops.launches_sm90) == before
    assert got.dtype == torch.float32 and got.shape == (2, s, h, dv)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, flash_attention_op(jq, jk, jv, causal=causal, window=window,
                                   bq=64, bk=64), F32_TOL)
    want = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(got, want, F32_TOL)


def test_plain_flash_bf16():
    q, k, v = _qkv(1, 1, 128, 4, 4, 32, 32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    # the same bf16 values in both packages (both round to nearest even)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (tq, tk, tv))
    _close(got.float(), flash_attention_op(jq, jk, jv, bq=64, bk=64)
           .astype(jnp.float32), BF16_TOL)
    _close(got.float(), jax_attention_ref(*(x.astype(jnp.float32)
                                            for x in (jq, jk, jv))),
           BF16_TOL)


@pytest.mark.parametrize("causal,window,q_chunk,kv_chunk", [
    (True, 0, 128, 64),      # tests/test_kernels.py's model-path pairing
    (False, 0, 64, 128),
    (True, 64, 64, 64),
    (True, 100, 128, 64),    # the reference's window blocking (ROADMAP §3)
])
def test_cpu_blocked_attention_matches_jax(causal, window, q_chunk,
                                           kv_chunk):
    q, k, v = _qkv(2, 2, 256, 8, 2, 32, 32)
    got = blocked_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    want = jax_blocked(*map(jnp.asarray, (q, k, v)), causal=causal,
                       window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    _close(got, want, F32_TOL)


def test_cpu_blocked_attention_keeps_bf16_cast_of_p():
    q, k, v = _qkv(3, 1, 128, 4, 2, 32, 32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = blocked_attention(tq, tk, tv, q_chunk=64, kv_chunk=64)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (tq, tk, tv))
    want = jax_blocked(jq, jk, jv, q_chunk=64, kv_chunk=64)
    _close(got.float(), want.astype(jnp.float32), BF16_TOL)


@pytest.mark.parametrize("dtype,dk,dv,kernel", [
    (torch.bfloat16, 128, 128, "sm90"),     # llama3-8b
    (torch.bfloat16, 64, 64, "sm90"),
    (torch.bfloat16, 192, 128, "sm90"),     # deepseek MLA
    (torch.bfloat16, 256, 256, "sm90"),     # recurrentgemma
    (torch.bfloat16, 16, 16, "sm90"),       # tests/test_kernels.py widths
    (torch.bfloat16, 32, 64, "sm90"),
    (torch.bfloat16, 24, 24, "scalar"),     # not a multiple of 16
    (torch.bfloat16, 128, 40, "scalar"),
    (torch.bfloat16, 272, 128, "scalar"),   # Dk above 256
    (torch.float32, 128, 128, "scalar"),    # float32 stays on the scalar
    (torch.float32, 16, 16, "scalar"),
])
def test_route_picks_kernel_by_dtype_and_widths(dtype, dk, dv, kernel):
    assert ops.route(dtype, dk, dv) == kernel


@pytest.mark.parametrize("dtype,dk,dv,exc", [
    (torch.float16, 64, 64, TypeError),
    (torch.int32, 64, 64, TypeError),
    (torch.bfloat16, 64, 272, ValueError),  # Dv above either kernel's 256
    (torch.float32, 64, 0, ValueError),
])
def test_route_refuses_what_no_kernel_takes(dtype, dk, dv, exc):
    with pytest.raises(exc):
        ops.route(dtype, dk, dv)
