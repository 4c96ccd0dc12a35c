"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerances are relative to the output's scale: the reference's 1e-4 for
f32, and for bf16 two bf16 ulps (2⁻⁶) — kernel and plain version both sum
in f32 and round each output once, so they land at most one ulp apart;
a kernel that dropped θ̃ would miss by ~0.1.  Both updates are bitwise.

The perturbed matmuls have two kernels, and ``perturbed_matmul.route``
picks one from dtypes and shapes: bf16 x and W with K, N multiples of 8
take the tensor-core kernel (``"tc"``), everything else the SIMT kernel.
The tc tests below hold it with bf16 and with f32 outputs (1e-4: its
split form x·W + amp·(x·S) is exact up to the order of f32 sums).
"""
import math

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


# leaves of the grouped update: (shape, elements of storage before the view)
# — heads of 1, 3 and 5 elements before a 16-byte boundary, numels that are
# not multiples of 8, and a tiny leaf beside the LM's [5120, 17408]
GROUP_LEAVES = [((3, 40, 17), 1), ((49, 4), 3), ((1, 7), 5), ((5, 13), 0),
                ((2, 3), 2), ((5120, 17408), 0), ((127, 257), 3)]


def _offset_leaves(device, dtype, leaves, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape, offset in leaves:
        n = math.prod(shape)
        base = torch.randn(n + 8, generator=g, device=device).to(dtype)
        out.append(base[offset:offset + n].view(shape))
    return out


def _group_seeds(device, n_leaves, j):
    return ops.seeds_tensor([[pert.leaf_seed(3, t, lid) for t in range(j)]
                             for lid in range(n_leaves)], device)


@pytest.mark.gpu
@pytest.mark.parametrize("j", [1, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cuda_window_group_bitwise(cuda_device, j, dtype):
    """One launch updates every leaf of the list, whatever its storage
    offset and length, bitwise equal to the plain version's per-leaf loop."""
    leaves = _offset_leaves(cuda_device, dtype, GROUP_LEAVES, j)
    assert [w.storage_offset() for w in leaves] == [o for _, o in
                                                    GROUP_LEAVES]
    seeds = _group_seeds(cuda_device, len(leaves), j)
    coefs = torch.randn((j,), device=cuda_device)
    before = kernels.launch_counts()["mgd_update_window"]
    got = ops.mgd_update_window_group(leaves, seeds, coefs, alpha=-10.0,
                                      dtheta=0.01)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mgd_update_window"] == before + 1
    want = ops.mgd_update_window_group(leaves, seeds, coefs, alpha=-10.0,
                                       dtheta=0.01, impl="ref")
    for w, a, b in zip(leaves, got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, b)
        assert not torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("j", [1, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cuda_mgd_update_unaligned_and_ragged(cuda_device, j, dtype):
    """The sum-then-subtract update through its entry point on the same
    leaves: one launch a leaf, bitwise."""
    leaves = _offset_leaves(cuda_device, dtype, GROUP_LEAVES, 10 + j)
    seeds = _group_seeds(cuda_device, len(leaves), j)
    coefs = torch.randn((j,), device=cuda_device)
    before = kernels.launch_counts()["mgd_update"]
    for i, w in enumerate(leaves):
        got = ops.mgd_update(w, seeds[i], coefs, eta=0.1, dtheta=0.01)
        want = ops.mgd_update(w, seeds[i], coefs, eta=0.1, dtheta=0.01,
                              impl="ref")
        torch.cuda.synchronize()
        assert got.shape == w.shape and torch.equal(got, want)
    assert kernels.launch_counts()["mgd_update"] == before + len(leaves)


@pytest.mark.gpu
def test_cuda_window_group_past_64_leaves_and_mixed_dtypes(cuda_device):
    """70 f32 leaves take two launches (64 + 6) and 3 bf16 leaves a third;
    every leaf bitwise."""
    from repro_torch.kernels import mgd_update
    assert mgd_update.MAX_LEAVES == 64
    shapes = [((2 + i % 5, 3 + i % 13), i % 4) for i in range(70)]
    leaves = (_offset_leaves(cuda_device, torch.float32, shapes, 1)
              + _offset_leaves(cuda_device, torch.bfloat16,
                               [((4, 9), 1), ((8, 8), 0), ((1, 3), 2)], 2))
    seeds = _group_seeds(cuda_device, len(leaves), 2)
    coefs = torch.tensor([0.75, -0.5], device=cuda_device)
    before = kernels.launch_counts()["mgd_update_window"]
    got = ops.mgd_update_window_group(leaves, seeds, coefs, alpha=1.0,
                                      dtheta=0.5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mgd_update_window"] == before + 3
    want = ops.mgd_update_window_group(leaves, seeds, coefs, alpha=1.0,
                                       dtheta=0.5, impl="ref")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
    one window update for all 13 matrix leaves; its C± match the plain
    route within 2⁻¹¹·|C| (the limit ``chip_smoke.py`` holds C̃ to), which
    the unperturbed cost C₀ misses, so a kernel that dropped θ̃ would
    fail."""
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
        "mgd_update_window": 1, "mgd_update": 0}


TC_SHAPES = [(512, 5120, 1024), (5, 5120, 1032), (130, 5128, 256)]


def _bf16_operands(device, m, k, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    xm = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=device) * 0.1).to(
        torch.bfloat16)
    return x, xm, w


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", TC_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_out", "f32_out"])
def test_tc_route_matches_plain(cuda_device, m, k, n, out_dtype):
    """The tensor-core kernel, single and pair, against the plain version
    (M free: 5 and 130 rows leave ragged row blocks, N = 1032 a ragged
    column tile, K = 5128 a ragged K step); each call moves its wrapper's
    "tc" counter by one and leaves "simt" alone."""
    from repro_torch.kernels import perturbed_matmul as pm
    x, xm, w = _bf16_operands(cuda_device, m, k, n, 5)
    ls = pert.leaf_seed(7, 3, 2)
    assert pm.route(x, w) == "tc"
    before = kernels.route_launch_counts()
    y = ops.perturbed_matmul(x, w, ls, dtheta=0.01, sign=-1.0,
                             out_dtype=out_dtype)
    yp, ym = ops.perturbed_matmul_pair(x, xm, w, ls, dtheta=0.01,
                                       out_dtype=out_dtype)
    after = kernels.route_launch_counts()
    r = ops.perturbed_matmul(x, w, ls, dtheta=0.01, sign=-1.0, impl="ref",
                             out_dtype=out_dtype)
    rp, rm = ops.perturbed_matmul_pair(x, xm, w, ls, dtheta=0.01,
                                       impl="ref", out_dtype=out_dtype)
    torch.cuda.synchronize()
    for name in ("perturbed_matmul", "perturbed_matmul_pair"):
        assert after[name] == {"tc": before[name]["tc"] + 1,
                               "simt": before[name]["simt"]}
    assert y.dtype == out_dtype and y.shape == (m, n)
    for a, b in ((y, r), (yp, rp), (ym, rm)):
        assert _rel_err(a, b) <= TOL[out_dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(130, 5128, 256), (5, 64, 1032)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_out", "f32_out"])
def test_tc_pair_equals_singles_bitwise(cuda_device, m, k, n, out_dtype):
    """The pair's x₊ output equals the single with σ = +1 bit for bit, and
    x₋ the single with σ = −1: each output element sees the same x row,
    the same W and sign tiles in the same wgmma order and the same
    epilogue FMA, whichever warpgroup computes it."""
    x, xm, w = _bf16_operands(cuda_device, m, k, n, 6)
    ls = pert.leaf_seed(7, 3, 2)
    yp, ym = ops.perturbed_matmul_pair(x, xm, w, ls, dtheta=0.01,
                                       out_dtype=out_dtype)
    assert torch.equal(yp, ops.perturbed_matmul(x, w, ls, dtheta=0.01,
                                                out_dtype=out_dtype))
    assert torch.equal(ym, ops.perturbed_matmul(xm, w, ls, dtheta=0.01,
                                                sign=-1.0,
                                                out_dtype=out_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,wdt,k,n,want", [
    (torch.bfloat16, torch.bfloat16, 128, 256, "tc"),
    (torch.float32, torch.float32, 128, 256, "simt"),
    (torch.bfloat16, torch.float32, 128, 256, "simt"),
    (torch.bfloat16, torch.bfloat16, 127, 256, "simt"),
    (torch.bfloat16, torch.bfloat16, 128, 252, "simt"),
])
def test_route_counters_follow_route(cuda_device, xdt, wdt, k, n, want):
    """Each launch moves exactly the counter of the kernel ``route`` names,
    and the totals as before; the SIMT kernel can be asked for at a tc
    shape, the tc kernel at no other."""
    from repro_torch.kernels import perturbed_matmul as pm
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((9, k), generator=g, device=cuda_device).to(xdt)
    w = torch.randn((k, n), generator=g, device=cuda_device).to(wdt)
    assert pm.route(x, w) == want
    kernels.reset_launch_counts()
    ops.perturbed_matmul(x, w, 1, dtheta=0.01)
    ops.perturbed_matmul_pair(x, x, w, 1, dtheta=0.01)
    pm.perturbed_matmul(x, w, 1, amp=0.01, kernel="simt")
    torch.cuda.synchronize()
    other = "simt" if want == "tc" else "tc"
    assert kernels.route_launch_counts() == {
        "perturbed_matmul": {want: 1 + (want == "simt"),
                             other: int(want == "tc")},
        "perturbed_matmul_pair": {want: 1, other: 0}}
    assert kernels.launch_counts()["perturbed_matmul"] == 2
    if want != "tc":
        with pytest.raises(ValueError, match="tensor-core kernel takes"):
            pm.perturbed_matmul(x, w, 1, amp=0.01, kernel="tc")


@pytest.mark.gpu
def test_tc_wrapper_refuses_bad_operands(cuda_device):
    """A CPU tensor, a non-contiguous one, a dtype neither kernel takes and
    a base address TMA cannot load from all raise; nothing falls back."""
    from repro_torch.kernels import perturbed_matmul as pm
    bf = torch.bfloat16
    w = torch.zeros((64, 128), device=cuda_device, dtype=bf)
    x = torch.zeros((8, 64), device=cuda_device, dtype=bf)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pm.perturbed_matmul(x.cpu(), w, 0, amp=0.1, kernel="tc")
    with pytest.raises(ValueError, match="contiguous"):
        pm.perturbed_matmul(torch.zeros((64, 8), device=cuda_device,
                                        dtype=bf).t(), w, 0, amp=0.1)
    with pytest.raises(TypeError):
        pm.perturbed_matmul(x.to(torch.float16), w, 0, amp=0.1)
    with pytest.raises(TypeError):
        pm.perturbed_matmul_pair(x, x, w.to(torch.float16), 0, dtheta=0.1)
    shifted = torch.zeros(8 * 64 + 1, device=cuda_device,
                          dtype=bf)[1:].view(8, 64)
    assert shifted.is_contiguous() and pm.route(shifted, w) == "tc"
    with pytest.raises(ValueError, match="16-byte aligned"):
        pm.perturbed_matmul(shifted, w, 0, amp=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(130, 5128, 256), (512, 40, 136),
                                   (5, 64, 1032)])
def test_tc_cluster_sizes_agree_bitwise(cuda_device, m, k, n):
    """A cluster only moves which CTA hashes a sign row and loads a W row:
    clusters of 1, 2 and 4 CTAs (with padding row blocks where M does not
    fill them, and shares wholly past K where K < 64) give the same bits."""
    from repro_torch.kernels import perturbed_matmul as pm
    x, xm, w = _bf16_operands(cuda_device, m, k, n, 7)
    ls = pert.leaf_seed(2, 9, 4)
    for out_dtype in (torch.bfloat16, torch.float32):
        singles = [pm.perturbed_matmul(x, w, ls, amp=0.01,
                                       out_dtype=out_dtype, cluster=c)
                   for c in (1, 2, 4)]
        pairs = [pm.perturbed_matmul_pair(x, xm, w, ls, dtheta=0.01,
                                          out_dtype=out_dtype, cluster=c)
                 for c in (1, 2, 4)]
        for y in singles[1:]:
            assert torch.equal(y, singles[0])
        for yp, ym in pairs[1:]:
            assert torch.equal(yp, pairs[0][0]) and torch.equal(ym,
                                                                pairs[0][1])
        assert torch.equal(pairs[0][0], singles[0])
    with pytest.raises(ValueError, match="cluster"):
        pm.perturbed_matmul(x, w, ls, amp=0.01, cluster=3)


# ---------------------------------------------------------------------------
# Imperfect devices and checkpoints on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 1001, (1 << 24) + 3])
def test_threefry_card_equals_cpu(cuda_device, n):
    """Counter-keyed threefry: bits and uniforms bitwise, normals within
    ``rng.NORMAL_ULPS``, card against CPU (past one 2²⁴-element chunk)."""
    from repro_torch.core import rng
    key = rng.fold_in(rng.fold_in(rng.prng_key(77), 3), 12345)
    lo = max(0, n - 4096)
    assert torch.equal(rng.bits_slice(key, lo, n, cuda_device).cpu(),
                       rng.bits_slice(key, lo, n, "cpu"))
    card = rng.uniform(key, (n,), -2.5, 3.0, device=cuda_device).cpu()
    assert torch.equal(card[lo:], rng.uniform(key, (n,), -2.5, 3.0,
                                              device="cpu")[lo:])
    a = rng.normal_slice(key, lo, n, cuda_device).cpu()
    b = rng.normal_slice(key, lo, n, "cpu")
    ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    assert ulps.max().item() <= rng.NORMAL_ULPS


@pytest.mark.gpu
def test_plant_writes_card_equal_cpu(cuda_device):
    """The DAC of a bf16 tree on the card against the CPU: bitwise.  The
    noisy write and the drift: within one bf16 ulp, on all but a few
    elements' bits (a normal may differ in its last ulps between the two
    devices' ``log1p``, which can flip a rounding)."""
    from repro_torch.hardware import DriftingPlant, NoisyPlant, QuantizedPlant
    g = torch.Generator().manual_seed(0)
    tree = {"w": (torch.randn((300, 70), generator=g) * 0.02
                  ).to(torch.bfloat16),
            "b": torch.randn((70,), generator=g).to(torch.bfloat16)}
    plant = DriftingPlant(NoisyPlant(None, write_noise=0.1, dtheta=1e-2,
                                     seed=4), mode="walk", drift_rate=1e-3)
    dac = QuantizedPlant(None, bits=8)
    on_card = {k: v.to(cuda_device) for k, v in tree.items()}
    want, got = dac.quantize(tree), dac.quantize(on_card)
    for k in tree:
        assert torch.equal(got[k].cpu(), want[k])
    want, got = plant.write_params(tree, step=5), \
        plant.write_params(on_card, step=5)
    for k in tree:
        a, b = got[k].cpu().float(), want[k].float()
        assert ((a - b).abs() <= b.abs() * 2.0 ** -7).all()
        assert (a != b).float().mean().item() < 1e-3


@pytest.mark.gpu
def test_checkpoint_roundtrip_bf16_on_card(cuda_device, tmp_path):
    from repro_torch.training import checkpoint as ckpt
    g = torch.Generator(device=cuda_device).manual_seed(3)
    tree = {"p": [torch.randn((33, 17), generator=g,
                              device=cuda_device).to(torch.bfloat16),
                  torch.randn((5,), generator=g, device=cuda_device)],
            "n": 4}
    ckpt.save(str(tmp_path), 4, tree)
    like = {"p": [torch.zeros_like(x) for x in tree["p"]], "n": 0}
    out, _, step = ckpt.restore(str(tmp_path), like)
    assert step == 4 and out["n"] == 4
    for a, b in zip(tree["p"], out["p"]):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_resume_bit_exact_on_kernel_route(cuda_device, tmp_path):
    """A small bf16 decoder through a drifting noisy device, fused central
    on the card's kernels: 4 steps uninterrupted against 2 + checkpoint +
    a fresh driver resuming to 4, with a recalibration at step 3."""
    import repro_torch as rt
    from repro_torch.hardware import DriftingPlant, NoisyPlant
    from repro_torch.core.utils import tree_leaves

    cfg = rt.get_smoke_config("qwen3-14b").replace(dtype="bfloat16")
    sample = rt.lm_sampler(2, 16, cfg.vocab, seed=0, device=cuda_device)
    p0 = rt.model_init(cfg, 0, device=cuda_device)

    def run(steps, **loop):
        plant = DriftingPlant(NoisyPlant(
            lambda p, b: rt.model_loss(p, cfg, b), cost_noise=1e-4,
            write_noise=0.1, dtheta=1e-2, seed=1), mode="walk",
            drift_rate=1e-3)
        return rt.train_mgd(None, p0, rt.DriverConfig(
            dtheta=1e-2, eta=1e-2, mode="central", fused=True), sample,
            steps, loop=rt.TrainLoopConfig(
                chunk=1, log=None, plant=plant, recal_every=3,
                probe_fn=rt.make_transformer_probe_fn(cfg), **loop),
            device=cuda_device)

    kernels.reset_launch_counts()
    cont = run(4)
    assert kernels.launch_counts()["perturbed_matmul_pair"] > 0
    run(2, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    res = run(4, checkpoint_dir=str(tmp_path))
    for a, b in zip(tree_leaves(cont.params), tree_leaves(res.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(cont.state), tree_leaves(res.state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


# --- the paper's CNNs and samplers (sixth slice) -----------------------------

CNN_ATOL = 1e-5       # card against CPU, f32: cuDNN's and the CPU's sums


def _conv_case(device, seed=5):
    g = torch.Generator().manual_seed(seed)
    p = {"w": torch.randn((3, 3, 16, 32), generator=g) * 0.3,
         "b": torch.randn((32,), generator=g)}
    x = torch.randn((64, 14, 14, 16), generator=g)
    return ({k: v.to(device) for k, v in p.items()}, x.to(device),
            {k: v.double() for k, v in p.items()}, x.double())


@pytest.mark.gpu
def test_conv2d_and_maxpool2_card_equal_cpu(cuda_device):
    from repro_torch.models import layers

    p, x, pc, xc = _conv_case(cuda_device)
    want = layers.conv2d({k: v.float() for k, v in pc.items()}, xc.float())
    got = layers.conv2d(p, x)
    assert got.shape == (64, 14, 14, 32)
    assert (got.cpu() - want).abs().max().item() <= CNN_ATOL
    pooled = layers.maxpool2(got)
    assert pooled.shape == (64, 7, 7, 32)
    assert torch.equal(pooled.cpu(), layers.maxpool2(got.cpu()))


@pytest.mark.gpu
def test_conv2d_on_the_card_runs_without_tf32(cuda_device):
    """With the caller's cuDNN TF32 switched on, ``conv2d`` still computes
    in f32, forward and backward (within 1e-5 of an f64 conv and its
    weight gradient), while a plain TF32 conv on the same operands misses
    that by far (10-bit mantissa); the caller's setting is restored."""
    import torch.nn.functional as F
    from repro_torch.models import layers

    p, x, pc, xc = _conv_case(cuda_device)
    wc = pc["w"].clone().requires_grad_(True)
    exact = F.conv2d(xc.permute(0, 3, 1, 2), wc.permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1) + pc["b"]
    gy = torch.randn(exact.shape, generator=torch.Generator().manual_seed(6),
                     dtype=torch.float64)
    (gw_exact,) = torch.autograd.grad((exact * gy).sum(), wc)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        w = p["w"].clone().requires_grad_(True)
        got = layers.conv2d({"w": w, "b": p["b"]}, x)
        (gw,) = torch.autograd.grad((got * gy.float().to(cuda_device)).sum(),
                                    w)
        assert torch.backends.cudnn.allow_tf32 is True
        tf32 = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1) + p["b"]
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    err = (got.detach().double().cpu() - exact.detach()).abs().max().item()
    err_tf32 = (tf32.double().cpu() - exact.detach()).abs().max().item()
    assert err <= 1e-5 < 1e-3 <= err_tf32, (err, err_tf32)
    # each weight gradient sums 64·14·14 products: f32 lands within 1e-6
    # of the largest (TF32's 10-bit inputs would be ~1e-4 off)
    scale = gw_exact.abs().max().item()
    assert (gw.double().cpu() - gw_exact).abs().max().item() <= 1e-6 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fashion", "cifar"])
def test_cnn_apply_card_equal_cpu(cuda_device, name):
    import repro_torch as rt
    from repro_torch.core import rng
    from repro_torch.data import tasks

    init, apply, batch = {
        "fashion": (rt.fashion_cnn_init, rt.fashion_cnn_apply,
                    tasks.fashion_batch),
        "cifar": (rt.cifar_cnn_init, rt.cifar_cnn_apply,
                  tasks.cifar_batch)}[name]
    p_cpu = init(0, device="cpu")
    p = init(0, device=cuda_device)
    x_cpu, y_cpu = batch(rng.prng_key(11), 64, device="cpu")
    x, y = batch(rng.prng_key(11), 64, device=cuda_device)
    assert torch.equal(y.cpu(), y_cpu)                  # labels bitwise
    assert (x.cpu() - x_cpu).abs().max().item() <= 1e-5
    got = apply(p, x_cpu.to(cuda_device))
    assert got.shape == (64, 10)
    assert (got.cpu() - apply(p_cpu, x_cpu)).abs().max().item() <= CNN_ATOL


@pytest.mark.gpu
def test_train_backprop_chunk_card_equal_cpu(cuda_device):
    """One 8-step chunk of the Fashion CNN's backprop (η = 0.02, batch 64)
    on the card and on the CPU from the same params and batches."""
    import repro_torch as rt
    from repro_torch.core.utils import tree_leaves
    from repro_torch.data import pipeline, tasks

    cpu_sample = pipeline.generator_sampler(tasks.fashion_batch, 64, seed=3,
                                            device="cpu")

    def loss(p, b):
        return rt.mse(rt.fashion_cnn_apply(p, b["x"]), b["y"])

    out = {}
    for where in (cuda_device, torch.device("cpu")):
        res = rt.train_backprop(
            loss, rt.fashion_cnn_init(0, device=where),
            lambda i: {k: v.to(where) for k, v in cpu_sample(i).items()},
            8, eta=0.02, chunk=8, log=None)
        out[where.type] = res
    card, cpu = out["cuda"], out["cpu"]
    assert abs(card.history[0][1]["cost"] - cpu.history[0][1]["cost"]) <= 1e-6
    gap = max((a.cpu() - b).abs().max().item()
              for a, b in zip(tree_leaves(card.params),
                              tree_leaves(cpu.params)))
    assert gap <= 1e-6, gap


# -- probe parallelism and the chip farm on the card ------------------------


def _nist_batches(dev, batch, n, seed=7):
    from repro_torch.data import pipeline, tasks
    sample = pipeline.generator_sampler(tasks.nist7x7_batch, batch,
                                        seed=seed, device=dev)
    return [sample(i) for i in range(n)]


@pytest.mark.gpu
def test_cuda_probe_parallel_mlp_matches_plain(cuda_device):
    """4 pods of the 49-4-4 MLP, fused central on the kernels, each step
    against the plain route from the same state: C̃ within 1e-5 and params
    within 1e-4 (chip_smoke phase 11a's limits), with 8 SIMT pair launches
    and one window-update launch a step."""
    import repro_torch as rt
    from repro_torch.core.utils import tree_leaves

    def loss(p, b):
        return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])

    def make(impl):
        return rt.driver("probe_parallel", rt.DriverConfig(
            dtheta=1e-2, eta=0.1, seed=1, fused=True, mode="central",
            kernel_impl=impl), loss, probe_fn=rt.make_mlp_probe_fn(),
            mesh=rt.LocalMesh(pod=4), device=cuda_device)

    drv, ref = make(None), make("ref")
    params = rt.mlp_init(2, (49, 4, 4), device=cuda_device)
    state = drv.init(params)
    kernels.reset_launch_counts()
    steps = 8
    for batch in _nist_batches(cuda_device, 4, steps):
        p_ref, _, a_ref = ref.step(params, state, batch)
        params, state, aux = drv.step(params, state, batch)
        assert abs(aux["c_tilde"].item() - a_ref["c_tilde"].item()) <= 1e-5
        for a, b in zip(tree_leaves(params), tree_leaves(p_ref)):
            assert (a - b).abs().max().item() <= 1e-4
    counts = kernels.launch_counts()
    assert counts == dict(perturbed_matmul=0,
                          perturbed_matmul_pair=4 * 2 * steps,
                          mgd_update_window=steps, mgd_update=0)
    assert kernels.route_launch_counts()["perturbed_matmul_pair"]["simt"] \
        == 4 * 2 * steps


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cuda_pod_window_update_matches_plain(cuda_device, dtype):
    """The k-pod update's one grouped window launch (J = 4) against its
    plain version on the same leaves: bitwise, f32 and bf16."""
    from repro_torch.core import probe_parallel as pp
    from repro_torch.core.mgd import MGDConfig

    g = torch.Generator(device=cuda_device).manual_seed(3)
    params = [{"w": (torch.randn((49, 4), generator=g, device=cuda_device)
                     * 0.3).to(dtype),
               "b": torch.zeros(4, device=cuda_device, dtype=dtype)},
              {"w": (torch.randn((4, 4), generator=g, device=cuda_device)
                     * 0.3).to(dtype),
               "b": torch.zeros(4, device=cuda_device, dtype=dtype)}]
    coefs = torch.tensor([0.5, -1.25, 2.0, -0.75], device=cuda_device)
    cfg = MGDConfig(dtheta=1e-2, eta=0.1, seed=1, mode="central",
                    fused=True)
    before = kernels.launch_counts()["mgd_update_window"]
    got = pp._fused_pod_update(cfg, params, 5, coefs, 4)
    assert kernels.launch_counts()["mgd_update_window"] == before + 1
    want = pp._fused_pod_update(
        MGDConfig(dtheta=1e-2, eta=0.1, seed=1, mode="central", fused=True,
                  kernel_impl="ref"), params, 5, coefs, 4)
    for a, b in zip(got, want):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
def test_cuda_farm_backends_bitwise(cuda_device):
    """The optimizer on the card over a 4-chip simulated farm: serial,
    thread, process and cluster-loopback backends walk the bitwise
    identical trajectory (the host chips see the same copied params)."""
    import repro_torch as rt
    from repro_torch.core.utils import tree_leaves
    from repro_torch.hardware import (DeviceSpec, SimulatedAnalogChip,
                                      simulated_chip_farm)
    from repro_torch.hardware.backend import (ClusterStubBackend,
                                              loopback_transport)

    batches = _nist_batches(cuda_device, 8, 12, seed=11)

    def run(backend):
        with simulated_chip_farm(4, (49, 4, 4), backend=backend) as farm:
            drv = rt.driver("probe_parallel_external", rt.DriverConfig(
                dtheta=2e-2, eta=0.5, mode="central", seed=1), plant=farm,
                device=cuda_device)
            p = rt.mlp_init(2, (49, 4, 4), device=cuda_device)
            s = drv.init(p)
            cts = []
            for b in batches:
                p, s, aux = drv.step(p, s, b)
                cts.append(aux["c_tilde"])
        return torch.stack(cts).cpu(), [x.cpu() for x in tree_leaves(p)]

    specs = [DeviceSpec(SimulatedAnalogChip, ((49, 4, 4),),
                        dict(seed=i, sigma_a=0.15, sigma_theta=0.01,
                             sigma_c=1e-4, py_busy_ms=0.0))
             for i in range(4)]
    ref_ct, ref_p = run("serial")
    for backend in ("thread", "process",
                    ClusterStubBackend(transport=loopback_transport(specs))):
        ct, p = run(backend)
        assert torch.equal(ct, ref_ct), backend
        assert all(torch.equal(a, b) for a, b in zip(p, ref_p)), backend


@pytest.mark.gpu
def test_cuda_dyadic_pods_equal_farm(cuda_device):
    """The dyadic LinearLaneChip law with the optimizer on the card: 4
    pods on their batch blocks ≡ a 4-chip farm on the same shards."""
    import repro_torch as rt
    from repro_torch.core import mae
    from repro_torch.core.utils import tree_leaves
    from repro_torch.hardware import ChipFarm, LinearLaneChip

    cfg = rt.DriverConfig(dtheta=0.5, eta=0.5, mode="central", seed=5)
    x = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]] * 2,
                     dtype=torch.float32, device=cuda_device)
    y = torch.tensor([[0], [1], [1], [0]] * 2, dtype=torch.float32,
                     device=cuda_device)

    def params():
        return [{"w": torch.tensor([[0.5], [-0.25]], device=cuda_device),
                 "b": torch.tensor([0.25], device=cuda_device)}]

    pods = rt.driver("probe_parallel", cfg,
                     lambda p, b: mae(b["y"], rt.linear_apply(p, b["x"])),
                     mesh=rt.LocalMesh(pod=4), device=cuda_device)
    with ChipFarm([LinearLaneChip() for _ in range(4)],
                  shard_batch=True) as farm:
        ext = rt.driver("probe_parallel_external", cfg, plant=farm,
                        device=cuda_device)
        p_m, p_f = params(), params()
        s_m, s_f = pods.init(p_m), ext.init(p_f)
        for _ in range(5):
            p_m, s_m, a_m = pods.step(p_m, s_m, {"x": x, "y": y})
            p_f, s_f, a_f = ext.step(p_f, s_f, {"x": x, "y": y})
            assert torch.equal(a_m["c_tilde"], a_f["c_tilde"])
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(p_m), tree_leaves(p_f)))
