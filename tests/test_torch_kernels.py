"""The port's kernel routes against the JAX package's.

On the CPU the dispatch takes the plain PyTorch versions, which are held
against ``repro.kernels`` (its ``ref`` oracles and its Pallas kernels in
interpret mode): the perturbed matmul at the reference's tolerances
(1e-4 f32, 0.15 bf16 — torch's and XLA's matmuls sum in different
orders), the window update bitwise.  The CUDA kernels themselves are
held against the plain versions on the card in ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels as tkernels
from repro_torch.core import perturbations as tpert
from repro_torch.core.utils import f32
from repro_torch.kernels import ops as tops

SHAPES_MM = [
    (64, 128, 256), (16, 48, 80), (1, 256, 256), (130, 384, 96),
    (8, 8, 8), (256, 512, 128),
]
PRIME_MM = [(5, 127, 257)]
MLP_MM = [(1, 49, 4), (8, 49, 4), (8, 4, 4)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.15)}


def _operands(m, k, n, jdtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    jx, jw = jnp.asarray(x, jdtype), jnp.asarray(w, jdtype)
    # both packages get the identical (possibly bf16-rounded) values
    return jx, jw, _to_torch(jx), _to_torch(jw)


def _to_torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                                - b.float().numpy())))


@pytest.mark.parametrize("m,k,n", SHAPES_MM + PRIME_MM + MLP_MM)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_perturbed_matmul_matches_reference(m, k, n, dtype):
    jdtype, tdtype, tol = DTYPES[dtype]
    jx, jw, tx, tw = _operands(m, k, n, jdtype)
    lseed = tpert.leaf_seed(7, 3, 2)
    want = jref.perturbed_matmul_ref(jx, jw, jnp.uint32(lseed), dtheta=0.01)
    got = tops.perturbed_matmul(tx, tw, lseed, dtheta=0.01)
    assert got.dtype == tdtype and got.shape == (m, n)
    assert _max_err(want, got) < tol


@pytest.mark.parametrize("m,k,n", [(16, 48, 80), (5, 127, 257), (8, 49, 4)])
def test_perturbed_matmul_matches_interpret_kernel(m, k, n):
    jx, jw, tx, tw = _operands(m, k, n, jnp.float32, seed=1)
    lseed = tpert.leaf_seed(9, 2, 1)
    for sign in (1.0, -1.0):
        want = jops.perturbed_matmul(jx, jw, jnp.uint32(lseed), dtheta=0.05,
                                     sign=sign, impl="interpret")
        got = tops.perturbed_matmul(tx, tw, lseed, dtheta=0.05, sign=sign)
        assert _max_err(want, got) < 1e-4


@pytest.mark.parametrize("m,k,n", [(32, 64, 96), (5, 127, 257), (8, 49, 4),
                                   (8, 4, 4)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_perturbed_matmul_pair_matches_reference(m, k, n, dtype):
    jdtype, _, tol = DTYPES[dtype]
    jxp, jw, txp, tw = _operands(m, k, n, jdtype, seed=2)
    jxm, _, txm, _ = _operands(m, k, n, jdtype, seed=3)
    lseed = tpert.leaf_seed(1, 5, 0)
    wp, wm = jref.perturbed_matmul_pair_ref(jxp, jxm, jw, jnp.uint32(lseed),
                                            dtheta=0.05)
    gp, gm = tops.perturbed_matmul_pair(txp, txm, tw, lseed, dtheta=0.05)
    assert _max_err(wp, gp) < tol and _max_err(wm, gm) < tol


@pytest.mark.parametrize("m,k,n", [(16, 48, 80), (8, 8, 8), (5, 127, 257)])
def test_perturbed_matmul_pair_equals_two_singles(m, k, n):
    """One pair pass == two single calls with σ = ±1, bitwise."""
    _, _, txp, tw = _operands(m, k, n, jnp.float32, seed=4)
    _, _, txm, _ = _operands(m, k, n, jnp.float32, seed=5)
    ls = tpert.leaf_seed(7, 3, 2)
    yp, ym = tops.perturbed_matmul_pair(txp, txm, tw, ls, dtheta=0.01)
    y1 = tops.perturbed_matmul(txp, tw, ls, dtheta=0.01, sign=1.0)
    y2 = tops.perturbed_matmul(txm, tw, ls, dtheta=0.01, sign=-1.0)
    assert torch.equal(yp, y1) and torch.equal(ym, y2)


ROUTE_CASES = [
    # (x dtype, W dtype, M, K, N, route)
    (torch.bfloat16, torch.bfloat16, 512, 5120, 17408, "tc"),
    (torch.bfloat16, torch.bfloat16, 5, 5120, 1032, "tc"),
    (torch.bfloat16, torch.bfloat16, 130, 5128, 256, "tc"),
    (torch.float32, torch.float32, 512, 5120, 17408, "simt"),
    (torch.bfloat16, torch.float32, 16, 64, 128, "simt"),
    (torch.float32, torch.bfloat16, 16, 64, 128, "simt"),
    (torch.bfloat16, torch.bfloat16, 5, 127, 256, "simt"),
    (torch.bfloat16, torch.bfloat16, 5, 128, 257, "simt"),
    (torch.bfloat16, torch.bfloat16, 5, 127, 257, "simt"),
    (torch.bfloat16, torch.bfloat16, 0, 64, 128, "tc"),
    (torch.float32, torch.float32, 0, 64, 128, "simt"),
    (torch.bfloat16, torch.bfloat16, 4, 0, 128, "simt"),
]


@pytest.mark.parametrize("xdt,wdt,m,k,n,want", ROUTE_CASES)
def test_route_picks_kernel_by_dtype_and_shape(xdt, wdt, m, k, n, want):
    """bf16 x and W with K, N multiples of 8 take the tensor-core kernel,
    everything else the SIMT kernel; M (even 0) does not matter, and lead
    dims of x do not either.  Meta tensors: no data is touched."""
    from repro_torch.kernels import perturbed_matmul as tpm
    x = torch.empty((m, k), dtype=xdt, device="meta")
    w = torch.empty((k, n), dtype=wdt, device="meta")
    assert tpm.route(x, w) == want
    assert tpm.route(x.reshape(1, m, k), w) == want
    tkernels.reset_launch_counts()
    assert tkernels.route_launch_counts() == {
        name: {"tc": 0, "simt": 0}
        for name in ("perturbed_matmul", "perturbed_matmul_pair")}


@pytest.mark.parametrize("streams,m,cluster", [
    (1, 512, 4), (2, 512, 4), (1, 1024, 4), (1, 5, 1), (2, 64, 1),
    (1, 130, 2), (2, 130, 2), (1, 384, 2), (2, 320, 2)])
def test_tc_cluster_size(streams, m, cluster):
    """Clusters of 4 row blocks where they fill up (the LM path's 512
    tokens), else 2 with at most one padding block, else 1."""
    from repro_torch.kernels import perturbed_matmul as tpm
    assert tpm.tc_cluster(streams, m) == cluster


@pytest.mark.parametrize("m,k,n", [(16, 48, 80), (5, 127, 256),
                                   (130, 64, 1032)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split_form_matches_reference(m, k, n, sign):
    """The identity the tensor-core kernel relies on: with bf16 x and W,
    x·W + amp·(x·S) in f32 equals x @ (W + amp·S) — the port's plain
    version, the JAX package's oracle and its Pallas kernel in interpret
    mode — within 1e-5 of max|y|; rounding θ̃ to bf16 first does not."""
    jx, jw, tx, tw = _operands(m, k, n, jnp.bfloat16, seed=6)
    lseed = tpert.leaf_seed(3, 4, 1)
    amp = sign * 0.01
    signs = tops._ref.leaf_signs(lseed, (k, n))
    split = tx.float() @ tw.float() + amp * (tx.float() @ signs)
    want_port = tops.perturbed_matmul(tx, tw, lseed, dtheta=0.01, sign=sign,
                                      out_dtype=torch.float32)
    want_ref = jref.perturbed_matmul_ref(jx, jw, jnp.uint32(lseed),
                                         dtheta=0.01, sign=sign,
                                         out_dtype=jnp.float32)
    want_pal = jops.perturbed_matmul(jx, jw, jnp.uint32(lseed), dtheta=0.01,
                                     sign=sign, impl="interpret",
                                     out_dtype=jnp.float32)
    scale = max(1.0, want_port.abs().max().item())
    assert (split - want_port).abs().max().item() <= 1e-5 * scale
    for want in (want_ref, want_pal):
        assert _max_err(want, split) <= 1e-5 * scale
    rounded = tx.float() @ (tw.float() + amp * signs).to(torch.bfloat16).float()
    assert (rounded - want_port).abs().max().item() > 1e-5 * scale


def test_kernel_signs_match_host_generator():
    """Identity x: y = W + Δθ·signs must equal ``generate`` exactly."""
    x = torch.eye(96)
    w = torch.zeros((96, 128))
    th = tpert.generate({"w": w}, ptype="rademacher", step=11, seed=42,
                        dtheta=1.0)["w"]
    y = tops.perturbed_matmul(x, w, tpert.leaf_seed(42, 11, 0), dtheta=1.0)
    assert torch.equal(y, th)


def test_batched_leading_dims():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    y = tops.perturbed_matmul(x, w, 0, dtheta=0.01)
    assert y.shape == (2, 5, 32)
    y2 = tops.perturbed_matmul(x.reshape(10, 64), w, 0, dtheta=0.01)
    torch.testing.assert_close(y.reshape(10, 32), y2, rtol=1e-6, atol=1e-6)


def _window_inputs(shape, steps, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    lseeds = [tpert.leaf_seed(seed, t, 0) for t in steps]
    raw = rng.standard_normal((len(steps),)).astype(np.float32)
    coefs = (np.float32(-0.01 / (0.1 * 0.1)) * raw).astype(np.float32)
    return w, lseeds, coefs


@pytest.mark.parametrize("steps", [[5], [5, 6, 7, 8]])
@pytest.mark.parametrize("alpha", [1.0, -0.5])
def test_mgd_update_window_bitwise(steps, alpha):
    """Bitwise against ``repro.kernels.ref.mgd_update_window_ref`` and the
    interpret-mode Pallas kernel, J ∈ {1, 4}, on a 3-D stacked leaf."""
    w, lseeds, coefs = _window_inputs((3, 40, 17), steps)
    jl = jnp.asarray(np.array(lseeds, np.uint32))
    want_ref = jref.mgd_update_window_ref(
        jnp.asarray(w).reshape(-1, 17), jl, jnp.asarray(coefs), alpha=alpha,
        dtheta=0.1).reshape(w.shape)
    want_pal = jops.mgd_update_window(jnp.asarray(w), jl, jnp.asarray(coefs),
                                      alpha=alpha, dtheta=0.1,
                                      impl="interpret")
    got = tops.mgd_update_window(
        torch.from_numpy(w), tops.seeds_tensor(lseeds, "cpu"),
        torch.from_numpy(coefs), alpha=alpha, dtheta=0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pal))


def test_mgd_update_window_host_int_seeds_equal_tensor_seeds():
    """Seeds ≥ 2³¹ survive the int32 bit-pattern round trip."""
    w, _, coefs = _window_inputs((49, 4), [0, 1])
    lseeds = [2 ** 32 - 3, 2 ** 31 + 17]
    a = tops.mgd_update_window(torch.from_numpy(w), lseeds,
                               torch.from_numpy(coefs), alpha=1.0, dtheta=0.1)
    t = tops.seeds_tensor(lseeds, "cpu")
    assert t.dtype == torch.int32 and int(t[0]) == -3
    b = tops.mgd_update_window(torch.from_numpy(w), t,
                               torch.from_numpy(coefs), alpha=1.0, dtheta=0.1)
    assert torch.equal(a, b)


# --- the grouped window update: one launch for every matrix leaf -------------

GROUP_SHAPES = [(3, 40, 17), (49, 4), (1, 7), (5, 13)]   # 13·5 = 65: odd


def _group_inputs(dtype, steps, seed=0):
    rng = np.random.default_rng(seed)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .to(dtype) for s in GROUP_SHAPES]
    lseeds = [[tpert.leaf_seed(seed, t, lid) for t in steps]
              for lid in range(len(leaves))]
    raw = rng.standard_normal((len(steps),)).astype(np.float32)
    return leaves, lseeds, torch.from_numpy(raw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [[5], [5, 6, 7, 8]])
@pytest.mark.parametrize("alpha", [-0.01, 1.0])      # −η at τ_θ = 1; replay
def test_window_group_plain_equals_per_leaf(dtype, steps, alpha):
    """The grouped entry's plain route equals one ``mgd_update_window`` call
    per leaf bit for bit, over a 3-D stacked leaf, [49,4], [1,7] and an
    odd numel, with the seeds of leaf l in row l."""
    leaves, lseeds, coefs = _group_inputs(dtype, steps)
    seeds = tops.seeds_tensor(lseeds, "cpu")
    assert seeds.shape == (len(leaves), len(steps))
    got = tops.mgd_update_window_group(leaves, seeds, coefs, alpha=alpha,
                                       dtheta=0.1)
    for i, (w, g) in enumerate(zip(leaves, got)):
        want = tops.mgd_update_window(w, seeds[i], coefs, alpha=alpha,
                                      dtheta=0.1)
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, want)
        assert not torch.equal(g, w)


def test_window_group_matches_jax_reference():
    """Each leaf of the group against ``repro.kernels.ref``'s window update
    (f32, J = 4, host-int seeds): bitwise."""
    leaves, lseeds, coefs = _group_inputs(torch.float32, [2, 3, 4, 5], seed=4)
    got = tops.mgd_update_window_group(leaves, lseeds, coefs, alpha=-0.01,
                                       dtheta=0.1)
    for w, row, g in zip(leaves, lseeds, got):
        want = jref.mgd_update_window_ref(
            jnp.asarray(w.reshape(-1, w.shape[-1]).numpy()),
            jnp.asarray(np.array(row, np.uint32)), jnp.asarray(coefs.numpy()),
            alpha=-0.01, dtheta=0.1)
        np.testing.assert_array_equal(g.reshape(-1, w.shape[-1]).numpy(),
                                      np.asarray(want))


def test_window_group_refuses_vectors_and_takes_no_leaves():
    with pytest.raises(ValueError, match="ndim >= 2"):
        tops.mgd_update_window_group([torch.zeros(4)], [[0]], torch.ones(1),
                                     alpha=1.0, dtheta=0.1)
    assert tops.mgd_update_window_group([], [], torch.ones(1), alpha=1.0,
                                        dtheta=0.1) == []


@pytest.mark.parametrize("alpha,dtheta", [(-0.01, 0.1), (1.0, 1e-2),
                                          (-0.1, 3e-3)])
def test_window_terms_in_kernel_association(alpha, dtheta):
    """The kernel forms term_j = f32(α)·(f32(Δθ)·c_j) with two rounded f32
    multiplies (numpy's f32 arithmetic here) and applies the sign by
    flipping the term's sign bit.  That reproduces, bit for bit, the terms
    the wrapper used to compute in torch, and W + S·term equals the plain
    version's W + α·((Δθ·S)·c) for either sign."""
    rng = np.random.default_rng(9)
    coefs = (rng.standard_normal(4096) * 10.0 ** rng.uniform(
        -8, 4, 4096)).astype(np.float32)
    a, d = np.float32(alpha), np.float32(dtheta)
    kernel = a * (d * coefs)
    assert kernel.dtype == np.float32
    torch_terms = (f32(alpha) * (f32(dtheta) * torch.from_numpy(coefs)))
    np.testing.assert_array_equal(kernel, torch_terms.numpy())
    w = rng.standard_normal(4096).astype(np.float32)
    bits = kernel.view(np.uint32)
    for sign in (1.0, -1.0):
        flipped = (bits ^ np.uint32(0x80000000 if sign < 0 else 0)
                   ).view(np.float32)
        plain = w + a * ((d * np.float32(sign)) * coefs)
        np.testing.assert_array_equal(w + flipped, plain)


def test_dispatch_rules_on_cpu():
    x = torch.zeros((2, 3))
    w = torch.zeros((3, 4))
    assert tops.default_impl(x) == "ref"
    with pytest.raises(ValueError, match="CUDA device"):
        tops.perturbed_matmul(x, w, 0, dtheta=0.1, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.perturbed_matmul_pair(x, x, w, 0, dtheta=0.1, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.mgd_update_window(w, [0], torch.ones(1), alpha=1.0, dtheta=0.1,
                               impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.mgd_update(w, [0], torch.ones(1), eta=0.1, dtheta=0.1,
                        impl="cuda")
    for bad in ("pallas", "interpret", "triton"):
        with pytest.raises(ValueError):
            tops.perturbed_matmul(x, w, 0, dtheta=0.1, impl=bad)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The launch wrappers themselves never run on CPU tensors."""
    from repro_torch.kernels import mgd_update, perturbed_matmul
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        perturbed_matmul.perturbed_matmul(x, torch.zeros((3, 4)), 0, amp=0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mgd_update.mgd_update_window_group(
            [x], torch.zeros((1, 1), dtype=torch.int32), torch.zeros(1),
            alpha=1.0, dtheta=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mgd_update.mgd_update(x, torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1), scale=1.0)
    assert set(tkernels.launch_counts()) == {
        "perturbed_matmul", "perturbed_matmul_pair", "mgd_update_window",
        "mgd_update"}


# --- mgd_update: the sum-then-subtract update ----------------------------------


@pytest.mark.parametrize("k,n,j", [(128, 256, 4), (96, 80, 7), (256, 512, 1),
                                   (8, 8, 3)])
def test_mgd_update_matches_reference(k, n, j):
    """The plain version against ``repro.kernels.ref.mgd_update_ref`` and
    the interpret-mode Pallas kernel on the grid of
    ``tests/test_kernels.py::test_mgd_update_matches_ref``, at its
    tolerance (rtol 1e-4, atol 1e-3)."""
    rng = np.random.default_rng(k + n + j)
    w = rng.standard_normal((k, n)).astype(np.float32)
    lseeds = [tpert.leaf_seed(7, t, 0) for t in range(j)]
    coefs = rng.standard_normal((j,)).astype(np.float32)
    jl = jnp.asarray(np.array(lseeds, np.uint32))
    want_ref = jref.mgd_update_ref(jnp.asarray(w), jl, jnp.asarray(coefs),
                                   eta=0.1, dtheta=0.01)
    want_pal = jops.mgd_update(jnp.asarray(w), jl, jnp.asarray(coefs),
                               eta=0.1, dtheta=0.01, impl="interpret")
    got = tops.mgd_update(torch.from_numpy(w), lseeds,
                          torch.from_numpy(coefs), eta=0.1, dtheta=0.01)
    assert got.dtype == torch.float32 and got.shape == (k, n)
    for want in (want_ref, want_pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-3)


def test_mgd_update_bf16_matches_reference():
    rng = np.random.default_rng(11)
    w = jnp.asarray(rng.standard_normal((96, 80)).astype(np.float32),
                    jnp.bfloat16)
    lseeds = [tpert.leaf_seed(3, t, 2) for t in range(4)]
    coefs = rng.standard_normal((4,)).astype(np.float32)
    want = jref.mgd_update_ref(w, jnp.asarray(np.array(lseeds, np.uint32)),
                               jnp.asarray(coefs), eta=0.1, dtheta=0.01)
    got = tops.mgd_update(_to_torch(w), lseeds, torch.from_numpy(coefs),
                          eta=0.1, dtheta=0.01)
    assert got.dtype == torch.bfloat16
    assert _max_err(want, got) <= 0.15 * max(
        1.0, float(np.abs(np.asarray(want, np.float32)).max()))


def test_mgd_update_equals_sequential_sgd_steps():
    """One fused window update == applying each scalar step separately
    (``tests/test_kernels.py::test_mgd_update_equals_sequential_sgd_steps``,
    same tolerance)."""
    w = np.random.default_rng(3).standard_normal((64, 64)).astype(np.float32)
    steps = [5, 6, 7]
    coefs = np.array([0.3, -0.2, 0.05], np.float32)
    fused = tops.mgd_update(
        torch.from_numpy(w), [tpert.leaf_seed(0, t, 0) for t in steps],
        torch.from_numpy(coefs), eta=0.01, dtheta=0.1)
    w_seq = torch.from_numpy(w)
    for t, c in zip(steps, coefs):
        th = tpert.generate({"w": w_seq}, ptype="rademacher", step=t, seed=0,
                            dtheta=0.1)["w"]
        w_seq = w_seq - 0.01 * float(c) * th / (0.1 * 0.1)
    np.testing.assert_allclose(fused.numpy(), w_seq.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_mgd_update_tensor_seeds_and_stacked_leaf():
    """int32 bit-pattern seeds equal host-int seeds, and a 3-D leaf is the
    row-major matrix view of itself."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((3, 40, 17)).astype(np.float32))
    lseeds = [2 ** 32 - 3, 2 ** 31 + 17]
    coefs = torch.tensor([0.5, -1.25])
    a = tops.mgd_update(w, lseeds, coefs, eta=0.1, dtheta=0.01)
    b = tops.mgd_update(w, tops.seeds_tensor(lseeds, "cpu"), coefs, eta=0.1,
                        dtheta=0.01)
    c = tops.mgd_update(w.reshape(-1, 17), lseeds, coefs, eta=0.1,
                        dtheta=0.01)
    assert a.shape == (3, 40, 17)
    assert torch.equal(a, b) and torch.equal(a.reshape(-1, 17), c)


def test_leaf_signs_chunks_change_no_value(monkeypatch):
    from repro_torch.kernels import ref as tref
    whole = tref.leaf_signs(12345, (37, 53))
    monkeypatch.setattr(tref, "SIGN_CHUNK", 100)
    chunked = tref.leaf_signs(12345, (37, 53))
    assert torch.equal(whole, chunked)
    want = jref.leaf_signs(jnp.uint32(12345), (37, 53))
    np.testing.assert_array_equal(chunked.numpy(), np.asarray(want))
