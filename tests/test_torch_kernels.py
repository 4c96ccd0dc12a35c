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
        mgd_update.mgd_update_window(x, torch.zeros(1, dtype=torch.int32),
                                     torch.zeros(1))
    assert set(tkernels.launch_counts()) == {
        "perturbed_matmul", "perturbed_matmul_pair", "mgd_update_window"}
