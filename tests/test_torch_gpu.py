"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerances are the reference's kernel tolerances (relative to the
output's scale): 1e-4 for f32, 0.15 for bf16; the window update is
bitwise.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import perturbations as pert
from repro_torch.kernels import ops

TOL = {torch.float32: 1e-4, torch.bfloat16: 0.15}
MM_SHAPES = [(1, 49, 4), (8, 49, 4), (8, 4, 4), (5, 127, 257),
             (130, 384, 96), (64, 128, 256)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max().item()
            / max(1.0, b.float().abs().max().item()))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cuda_perturbed_matmul_matches_plain(cuda_device, m, k, n, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((m, k), generator=g, device=cuda_device).to(dtype)
    xm = torch.randn((m, k), generator=g, device=cuda_device).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda_device) * 0.1).to(dtype)
    ls = pert.leaf_seed(7, 3, 2)
    before = kernels.launch_counts()
    y = ops.perturbed_matmul(x, w, ls, dtheta=0.01, sign=-1.0)
    yp, ym = ops.perturbed_matmul_pair(x, xm, w, ls, dtheta=0.01)
    r = ops.perturbed_matmul(x, w, ls, dtheta=0.01, sign=-1.0, impl="ref")
    rp, rm = ops.perturbed_matmul_pair(x, xm, w, ls, dtheta=0.01, impl="ref")
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["perturbed_matmul"] == before["perturbed_matmul"] + 1
    assert after["perturbed_matmul_pair"] == \
        before["perturbed_matmul_pair"] + 1
    assert y.dtype == dtype and y.shape == (m, n)
    for a, b in ((y, r), (yp, rp), (ym, rm)):
        assert _rel_err(a, b) <= TOL[dtype]


@pytest.mark.gpu
def test_cuda_pair_equals_two_singles(cuda_device):
    """Both route through the same staged W tile arithmetic: bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    xp = torch.randn((16, 48), generator=g, device=cuda_device)
    xm = torch.randn((16, 48), generator=g, device=cuda_device)
    w = torch.randn((48, 80), generator=g, device=cuda_device)
    ls = pert.leaf_seed(7, 3, 2)
    yp, ym = ops.perturbed_matmul_pair(xp, xm, w, ls, dtheta=0.01)
    assert torch.equal(yp, ops.perturbed_matmul(xp, w, ls, dtheta=0.01))
    assert torch.equal(ym, ops.perturbed_matmul(xm, w, ls, dtheta=0.01,
                                                sign=-1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,j", [((49, 4), 1), ((4, 4), 4),
                                     ((3, 40, 17), 4), ((127, 257), 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cuda_mgd_update_window_bitwise(cuda_device, shape, j, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    w = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    seeds = ops.seeds_tensor([pert.leaf_seed(3, t, 1) for t in range(j)],
                             cuda_device)
    coefs = torch.randn((j,), generator=g, device=cuda_device)
    got = ops.mgd_update_window(w, seeds, coefs, alpha=-0.5, dtheta=0.01)
    want = ops.mgd_update_window(w, seeds, coefs, alpha=-0.5, dtheta=0.01,
                                 impl="ref")
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_wrappers_refuse_bad_operands(cuda_device):
    from repro_torch.kernels import perturbed_matmul
    x = torch.zeros((2, 3), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        perturbed_matmul.perturbed_matmul(
            x, torch.zeros((3, 4), device=cuda_device), 0, amp=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        perturbed_matmul.perturbed_matmul(
            torch.zeros((3, 2), device=cuda_device).t(),
            torch.zeros((3, 4), device=cuda_device), 0, amp=0.1)
