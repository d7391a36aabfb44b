"""Which backward kernels take a call, on the CPU: ``route_bwd`` of the
flash-attention and SSD-scan wrappers at every dtype and at each width
and chunk boundary.  bfloat16 at the tensor-core forward's shapes goes to
the tensor-core backward (``"sm90"`` / ``"tc"``), which reads that
forward's saved tensors; float32 and the other bf16 shapes go to the
scalar kernels, at any width (past the whole-row instances, the head-tiled
ones); a dtype neither takes, a width or a chunk below 1 raises."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dk,dv,want", [
    (16, 16, "sm90"), (64, 64, "sm90"), (128, 128, "sm90"),
    (192, 128, "sm90"), (256, 256, "sm90"), (128, 256, "sm90"),
    (256, 16, "sm90"),
    (24, 16, "scalar"), (128, 120, "scalar"), (8, 8, "scalar"),
    (272, 256, "scalar"),        # Dk past 256: the scalar kernels' (tiled)
    (64, 272, "scalar"),         # Dv past 256: the same
])
def test_flash_bf16_routes(dk, dv, want):
    assert fops.route_bwd(BF16, dk, dv) == want


@pytest.mark.parametrize("dk,dv", [(16, 16), (128, 128), (192, 128),
                                   (256, 256), (24, 40)])
def test_flash_float32_goes_to_the_scalar_kernels(dk, dv):
    assert fops.route_bwd(F32, dk, dv) == "scalar"


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_flash_backward_follows_the_forward(dtype):
    """The backward reads what the forward's route saved: every width
    takes the forward's route."""
    for dk in range(16, 337, 8):
        for dv in (16, 24, 64, 128, 192, 256, 272, 288, 320):
            assert fops.route_bwd(dtype, dk, dv) == fops.route(dtype, dk, dv)


@pytest.mark.parametrize("call,err", [
    ((torch.float16, 64, 64), TypeError),
    ((torch.float64, 64, 64), TypeError),
    ((F32, 64, 0), ValueError),
    ((BF16, 0, 64), ValueError),
])
def test_flash_refuses(call, err):
    with pytest.raises(err):
        fops.route_bwd(*call)


@pytest.mark.parametrize("n,p,chunk,want", [
    (128, 64, 256, "tc"),         # mamba2-130m
    (16, 16, 64, "tc"), (128, 128, 256, "tc"), (64, 128, 128, "tc"),
    (16, 128, 2048, "tc"),
    (128, 64, 100, "scalar"),     # a chunk that is not a multiple of 64
    (128, 64, 32, "scalar"), (8, 8, 64, "scalar"), (128, 72, 256, "scalar"),
    (24, 64, 256, "scalar"),
    (144, 64, 256, "scalar"),     # N past the tensor-core route's 128
    (128, 144, 256, "scalar"),    # P past it
])
def test_ssd_bf16_routes(n, p, chunk, want):
    assert sops.route_bwd(BF16, n, p, chunk) == want


@pytest.mark.parametrize("n,p,chunk", [(128, 64, 256), (16, 16, 64),
                                       (128, 128, 256), (8, 8, 16)])
def test_ssd_float32_goes_to_the_scalar_kernels(n, p, chunk):
    assert sops.route_bwd(F32, n, p, chunk) == "scalar"


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_ssd_backward_follows_the_forward(dtype):
    """The tensor-core backward reads the tensor-core forward's bf16 hi +
    lo states, the scalar one either forward's: every shape takes the
    forward's route."""
    for n in (8, 16, 24, 64, 128, 144, 192):
        for p in (8, 16, 64, 120, 128, 144, 160, 200):
            for chunk in (16, 64, 100, 128, 256, 512):
                assert (sops.route_bwd(dtype, n, p, chunk)
                        == sops.route(dtype, n, p, chunk))


@pytest.mark.parametrize("call,err", [
    ((torch.float16, 128, 64, 256), TypeError),
    ((F32, 128, 64, 0), ValueError),
])
def test_ssd_refuses(call, err):
    with pytest.raises(err):
        sops.route_bwd(*call)

