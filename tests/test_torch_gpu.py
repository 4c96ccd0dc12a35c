"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerances are relative to the output's scale: the reference's 1e-4 for
f32, and for bf16 two bf16 ulps (2⁻⁶) — kernel and plain version both sum
in f32 and round each output once, so they land at most one ulp apart;
a kernel that dropped θ̃ would miss by ~0.1.  Both updates are bitwise.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import perturbations as pert
from repro_torch.kernels import ops

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,j", [((128, 256), 4), ((96, 80), 7),
                                     ((3, 40, 17), 3), ((127, 257), 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cuda_mgd_update_matches_plain(cuda_device, shape, j, dtype):
    """Sum first in f32, then one multiply and one subtract, as the plain
    version does: bitwise on the card."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    w = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    seeds = [pert.leaf_seed(5, t, 2) for t in range(j)]
    coefs = torch.randn((j,), generator=g, device=cuda_device)
    before = kernels.launch_counts()["mgd_update"]
    got = ops.mgd_update(w, seeds, coefs, eta=0.1, dtheta=0.01)
    want = ops.mgd_update(w, seeds, coefs, eta=0.1, dtheta=0.01, impl="ref")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mgd_update"] == before + 1
    assert got.dtype == dtype and got.shape == w.shape
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_update_kernels_index_wraps_past_2_32(cuda_device):
    """A bf16 leaf of 65540 × 65536 (4.295e9 elements): 64-bit element
    offsets reach every element, and the uint32 sign index r·N + c wraps,
    so rows 65536.. repeat rows 0.. bit for bit (W = 0)."""
    w = torch.zeros((65540, 65536), dtype=torch.bfloat16, device=cuda_device)
    seeds = [pert.leaf_seed(1, t, 0) for t in range(2)]
    coefs = torch.tensor([0.75, -0.5], device=cuda_device)
    for fn in (lambda: ops.mgd_update(w, seeds, coefs, eta=0.1, dtheta=0.01),
               lambda: ops.mgd_update_window(w, seeds, coefs, alpha=-0.1,
                                             dtheta=0.01)):
        out = fn()
        torch.cuda.synchronize()
        assert torch.equal(out[65536:], out[:4])
        assert bool((out[65535] != 0).all())
        del out
        torch.cuda.empty_cache()
    head = w[:4].contiguous()
    assert torch.equal(
        ops.mgd_update(w, seeds, coefs, eta=0.1, dtheta=0.01)[:4],
        ops.mgd_update(head, seeds, coefs, eta=0.1, dtheta=0.01, impl="ref"))


@pytest.mark.gpu
def test_cuda_transformer_step_launches_and_matches_plain(cuda_device):
    """A 2-layer Qwen3-shaped model (narrow widths, bf16) on the card: one
    central fused step launches 7 pair kernels per layer plus the head and
    13 window updates; its C± match the plain route within 2⁻¹¹·|C| (the
    limit ``chip_smoke.py`` holds C̃ to), which the unperturbed cost C₀
    misses, so a kernel that dropped θ̃ would fail."""
    import repro_torch as rt
    cfg = rt.get_smoke_config("qwen3-14b").replace(dtype="bfloat16",
                                                   d_model=256, d_ff=512,
                                                   vocab=1000)
    params = rt.model_init(cfg, 0, device=cuda_device)
    batch = rt.lm_sampler(2, 32, cfg.vocab, seed=0, device=cuda_device)(0)
    probe_fn = rt.make_transformer_probe_fn(cfg)
    probe = pert.Probe(0, 0, pert.ProbeCtx(signs=(1.0, -1.0), dtheta=1e-2))
    ref_probe = pert.Probe(0, 0, pert.ProbeCtx(signs=(1.0, -1.0),
                                               dtheta=1e-2, impl="ref"))
    got = probe_fn(params, batch, probe)
    want = probe_fn(params, batch, ref_probe)
    tol = 2 ** -11 * want.abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol
    c0 = rt.model_loss(params, cfg, batch)
    assert (want - c0).abs().max().item() > tol
    drv = rt.driver("discrete", rt.DriverConfig(
        mode="central", fused=True, dtheta=1e-2, eta=1e-2),
        lambda p, b: rt.model_loss(p, cfg, b), probe_fn=probe_fn,
        device=cuda_device)
    kernels.reset_launch_counts()
    drv.step(params, drv.init(params), batch)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "perturbed_matmul": 0, "perturbed_matmul_pair": 7 * 2 + 1,
        "mgd_update_window": 13, "mgd_update": 0}
