"""The kernels' sign stride ``n_cols`` on blocks of a leaf.

Every Pallas kernel of the JAX package takes ``n_cols``, the row stride of
its sign index: a block [Kb, Nb] at (r0, c0) of a leaf [K, N] hashes its
element (r, c) at (r0 + r)·N + c0 + c = (r·N + c) + (r0·N + c0), so the
block's kernel takes the leaf's N as ``n_cols`` and the offset folded into
its seed (``perturbations.shifted_leaf_seed``).  The port's plain versions
take the same argument; here they are held, on a column block, a row block
and a block of both, against

* the reference's Pallas kernels in interpret mode with the same
  ``n_cols`` and seed: the perturbed matmuls at the reference's
  tolerances (1e-4 f32, 0.15 bf16), the window update bitwise, the
  sum-first update at ``test_torch_kernels.py``'s tolerance for it (XLA
  fuses its last multiply-subtract) and within bf16's rounding;
* the whole leaf's result: both updates' blocks bitwise, a column
  block's products the same columns of the whole product, a row block's
  partial products summing to it (1e-4 f32 / 0.15 bf16).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import perturbations as tpert
from repro_torch.kernels import ops as tops

# the kernel modules (their package exports functions of the same names)
jpm = importlib.import_module("repro.kernels.perturbed_matmul")
jmu = importlib.import_module("repro.kernels.mgd_update")

K, N, M = 64, 96, 16
BLOCKS = {"column": (0, 48, K, 48), "row": (32, 0, 32, N),
          "both": (32, 48, 32, 48)}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.15)}
LSEED = tpert.leaf_seed(5, 3, 2)
STEPS = [4, 5, 6]


def _pair(a, jdtype):
    """The same values for both packages (rounded to ``jdtype`` once)."""
    j = jnp.asarray(a, jdtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if jdtype == jnp.bfloat16 else
                   torch.float32)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32), np.float32)


def _operands(jdtype):
    rng = np.random.default_rng(0)
    x = _pair(rng.standard_normal((M, K)).astype(np.float32), jdtype)
    w = _pair((rng.standard_normal((K, N)) * 0.1).astype(np.float32), jdtype)
    return x, w


def _block(block):
    r0, c0, kb, nb = BLOCKS[block]
    return (slice(r0, r0 + kb), slice(c0, c0 + nb)), \
        tpert.shifted_leaf_seed(LSEED, r0 * N + c0), (r0, c0, kb, nb)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("block", list(BLOCKS))
def test_perturbed_matmuls_on_a_block_match_the_interpret_kernels(block,
                                                                  dtype):
    jdtype, _, tol = DTYPES[dtype]
    (jx, tx), (jw, tw) = _operands(jdtype)
    (rows, cols), seed, (r0, c0, kb, nb) = _block(block)
    jxb, txb = jx[:, rows], tx[:, rows].contiguous()
    jwb, twb = jw[rows, cols], tw[rows, cols].contiguous()
    tiles = dict(bm=M, bk=kb, bn=nb, interpret=True, n_cols=N)
    for sign in (-1.0, 1.0):
        want = jpm.perturbed_matmul(jxb, jwb, jnp.uint32(seed), dtheta=0.05,
                                    sign=sign, **tiles)
        got = tops.perturbed_matmul(txb, twb, seed, dtheta=0.05, sign=sign,
                                    n_cols=N)
        assert got.dtype == txb.dtype
        assert np.abs(_f32(got) - _f32(want)).max() < tol
    wp, wm = jpm.perturbed_matmul_pair(jxb, 2 * jxb, jwb, jnp.uint32(seed),
                                       dtheta=0.05, **tiles)
    gp, gm = tops.perturbed_matmul_pair(txb, 2 * txb, twb, seed, dtheta=0.05,
                                        n_cols=N)
    assert np.abs(_f32(gp) - _f32(wp)).max() < tol
    assert np.abs(_f32(gm) - _f32(wm)).max() < tol
    # the block against the whole leaf: its columns, or its share of the sum
    whole = tops.perturbed_matmul(tx, tw, LSEED, dtheta=0.05)
    if kb == K:
        assert np.abs(_f32(got) - _f32(whole[:, cols])).max() < tol
    else:
        other = slice(0, r0) if r0 else slice(kb, K)
        rest = tops.perturbed_matmul(
            tx[:, other].contiguous(), tw[other, cols].contiguous(),
            tpert.shifted_leaf_seed(LSEED, other.start * N + c0),
            dtheta=0.05, n_cols=N)
        assert np.abs(_f32(got) + _f32(rest)
                      - _f32(whole[:, cols])).max() < 2 * tol


def _seeds():
    return [tpert.leaf_seed(5, s, 2) for s in STEPS]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("block", list(BLOCKS))
def test_updates_on_a_block_match_the_interpret_kernels(block, dtype):
    jdtype, _, _ = DTYPES[dtype]
    _, (jw, tw) = _operands(jdtype)
    (rows, cols), _, (r0, c0, kb, nb) = _block(block)
    coefs = np.random.default_rng(1).standard_normal(len(STEPS)).astype(
        np.float32)
    seeds = [tpert.shifted_leaf_seed(s, r0 * N + c0) for s in _seeds()]
    jseeds = jnp.asarray(np.array(seeds, np.uint32))
    jwb, twb = jw[rows, cols], tw[rows, cols].contiguous()
    want = jmu.mgd_update_window(jwb, jseeds, jnp.asarray(coefs), alpha=-0.3,
                                 dtheta=0.01, bk=kb, bn=nb, interpret=True,
                                 n_cols=N)
    got = tops.mgd_update_window(twb, seeds, torch.from_numpy(coefs),
                                 alpha=-0.3, dtheta=0.01, n_cols=N)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    whole = tops.mgd_update_window(tw, _seeds(), torch.from_numpy(coefs),
                                   alpha=-0.3, dtheta=0.01)
    assert torch.equal(got, whole[rows, cols])
    # the grouped form, leaf by leaf, with each leaf's own stride
    grouped = tops.mgd_update_window_group(
        [twb, tw], [seeds, _seeds()], torch.from_numpy(coefs), alpha=-0.3,
        dtheta=0.01, n_cols=[N, None])
    assert torch.equal(grouped[0], got) and torch.equal(grouped[1], whole)
    # the sum-first update
    want = jmu.mgd_update(jwb, jseeds, jnp.asarray(coefs), eta=0.1,
                          dtheta=0.01, bk=kb, bn=nb, interpret=True,
                          n_cols=N)
    got = tops.mgd_update(twb, seeds, torch.from_numpy(coefs), eta=0.1,
                          dtheta=0.01, n_cols=N)
    whole = tops.mgd_update(tw, _seeds(), torch.from_numpy(coefs), eta=0.1,
                            dtheta=0.01)
    assert torch.equal(got, whole[rows, cols])
    if dtype == "float32":
        # test_torch_kernels.py::test_mgd_update_matches_reference's
        # tolerance: XLA contracts W − scale·acc into an FMA (1 ulp)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4,
                                   atol=1e-3)
    else:
        assert np.abs(_f32(got) - _f32(want)).max() <= 2 ** -6 * max(
            1.0, float(np.abs(_f32(want)).max()))


def test_n_cols_is_checked_and_defaults_to_n():
    (_, tx), (_, tw) = _operands(jnp.float32)
    coefs = torch.ones(1)
    with pytest.raises(ValueError, match="n_cols"):
        tops.perturbed_matmul(tx, tw, LSEED, dtheta=0.1, n_cols=N - 1)
    with pytest.raises(ValueError, match="n_cols"):
        tops.mgd_update_window(tw, [LSEED], coefs, alpha=1.0, dtheta=0.1,
                               n_cols=N - 8)
    with pytest.raises(ValueError, match="n_cols"):
        tops.mgd_update(tw, [LSEED], coefs, eta=0.1, dtheta=0.1, n_cols=1)
    assert torch.equal(
        tops.perturbed_matmul(tx, tw, LSEED, dtheta=0.1, n_cols=N),
        tops.perturbed_matmul(tx, tw, LSEED, dtheta=0.1))
    assert torch.equal(
        tops.mgd_update_window(tw, [LSEED], coefs, alpha=1.0, dtheta=0.1,
                               n_cols=N),
        tops.mgd_update_window(tw, [LSEED], coefs, alpha=1.0, dtheta=0.1))
