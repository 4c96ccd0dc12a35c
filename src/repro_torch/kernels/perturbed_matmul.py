"""Launch wrappers for the perturbed-matmul kernels (CUDA tensors only).

``perturbed_matmul`` computes y = x @ (W + amp·S) and
``perturbed_matmul_pair`` (xp @ (W + Δθ·S), xm @ (W − Δθ·S)) with one read
of W, S the counter-hashed Rademacher signs of the leaf seed, S[r, c] hashed
at r·n_cols + c (``n_cols`` defaults to N; a column block of a wider leaf
passes the leaf's N, its offset folded into the seed).  They take
2-D contiguous operands; ``kernels.ops`` flattens lead dims and routes CPU
tensors to the plain versions.

Two kernels compute them, and ``route`` picks one from dtypes and shapes
alone, never on a failure: ``"tc"`` (``csrc/perturbed_matmul_tc.cu``, bf16
``wgmma`` on TMA-loaded tiles in the exact split form x·W + amp·(x·S)) for
bf16 x and W with K and N multiples of 8; ``"simt"``
(``csrc/perturbed_matmul.cu``, f32 FFMA) for everything else.  Either
kernel's build or launch failure raises.  Each wrapper counts its launches
in ``.launches`` and, per route, in ``.launches_tc`` / ``.launches_simt``,
and the signs its launches hash in ``.signs_hashed`` (``signs_hashed``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p]


_TC_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p]
ROUTES = ("tc", "simt")
TC_ALIGN = 8     # TMA needs 16-byte row strides: K, N multiples of 8 bf16


def route(x, w) -> str:
    """The kernel that x [..., K] @ W [K, N] takes on the card: ``"tc"``
    for bf16 x and W with K > 0 and K, N multiples of ``TC_ALIGN``, else
    ``"simt"``.  Looks at dtypes and shapes only; M is free."""
    k, n = w.shape[-2], w.shape[-1]
    if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and k > 0 and k % TC_ALIGN == 0 and n % TC_ALIGN == 0):
        return "tc"
    return "simt"


def _fn(lib_name, prefix, argtypes):
    """``<prefix>_launch`` of ``csrc/<lib_name>.cu``, bound on first use."""
    lib = _build.load(lib_name)
    fn = getattr(lib, f"{prefix}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{prefix}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib, fn


def check_operand(name: str, t: torch.Tensor, ndim: int, dtypes=_DTYPE_CODE):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} lies on {t.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{sorted(str(d) for d in dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


TC_CLUSTERS = (1, 2, 4)


def tc_cluster(n_streams: int, m: int) -> int:
    """Cluster size along M of the tensor-core kernel for M rows: its CTAs
    take 128 rows of one stream or 64 of each of the pair's, and a cluster
    hashes each sign tile once.  4 when the row blocks fill clusters of 4
    (the LM path's 512 tokens: 4 single or 8 pair blocks), else 2 with at
    most one padding block, else 1."""
    blocks = -(-m // (64 if n_streams == 2 else 128))
    return 4 if blocks % 4 == 0 else 2 if blocks >= 2 else 1


TC_BK, TC_BN = 64, 128      # the tensor-core kernel's stage depth, CTA width
SIMT_BM = 64                # the SIMT kernel's rows a block


def signs_hashed(which: str, n_streams: int, m: int, k: int, n: int,
                 cluster=None) -> int:
    """Signs one launch of x [M, K] @ W [K, N] hashes on route ``which``.

    ``"tc"``: each cluster of ``cluster`` CTAs along M (None: ``tc_cluster``)
    hashes every stage's whole 64 × 128 sign tile once, past K and N too,
    and the clusters along M each hash the whole of W's tiles:
    ⌈K/64⌉·64 × ⌈N/128⌉·128 × ⌈row blocks / cluster⌉, a row block 128 rows
    of one stream or 64 of each of the pair's.  ``"simt"``: each 64-row
    block of M hashes the sign of every element of W it stages, once for
    both of the pair's streams and none past K or N: K × N × ⌈M/64⌉."""
    if m == 0 or n == 0:
        return 0
    if which == "simt":
        return k * n * -(-m // SIMT_BM)
    cm = cluster or tc_cluster(n_streams, m)
    blocks = -(-m // (64 if n_streams == 2 else 128))
    return (-(-k // TC_BK) * TC_BK) * (-(-n // TC_BN) * TC_BN) * -(-blocks // cm)


def check_n_cols(n_cols, n: int) -> int:
    """The signs' row stride: ``n`` for None, else ``n_cols`` ≥ ``n``
    (a column block of a leaf of ``n_cols`` columns)."""
    if n_cols is None:
        return n
    n_cols = int(n_cols)
    if not n <= n_cols < 2 ** 31:
        raise ValueError(f"n_cols={n_cols} must lie in [N={n}, 2**31): the "
                         f"signs' row stride of a leaf of at least N columns")
    return n_cols


def _launch(xs, w, lseed, amps, out_dtype, kernel, cluster, n_cols=None):
    """Launch ``kernel`` (None: the one ``route`` picks); returns (outputs,
    the route taken, or None when there was nothing to compute, the signs
    the launch hashed)."""
    if kernel not in (None, *ROUTES):
        raise ValueError(f"unknown kernel {kernel!r}; use one of {ROUTES}")
    if cluster is not None and cluster not in TC_CLUSTERS:
        raise ValueError(f"cluster must be one of {TC_CLUSTERS}, got {cluster}")
    m, k = xs[0].shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"x [{m},{k}] does not multiply W [{k2},{n}]")
    n_cols = check_n_cols(n_cols, n)
    for i, x in enumerate(xs):
        check_operand(f"x{i}", x, 2)
        if x.shape != xs[0].shape or x.dtype != xs[0].dtype:
            raise ValueError("the pair's streams need one shape and dtype")
    check_operand("w", w, 2)
    out_dtype = out_dtype or xs[0].dtype
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype {out_dtype} is not float32 or bfloat16")
    ys = [torch.empty((m, n), dtype=out_dtype, device=w.device) for _ in xs]
    if m == 0 or n == 0:
        return ys, None, 0
    pair = len(xs) == 2
    which = route(xs[0], w)
    if kernel == "tc" and which != "tc":
        raise ValueError(f"the tensor-core kernel takes bf16 x and W with K, "
                         f"N multiples of {TC_ALIGN}; got {xs[0].dtype} x "
                         f"{list(xs[0].shape)}, {w.dtype} W {list(w.shape)}")
    which = kernel or which
    stream = torch.cuda.current_stream(w.device).cuda_stream
    x1 = xs[1].data_ptr() if pair else None
    y1 = ys[1].data_ptr() if pair else None
    seed = int(lseed) & 0xFFFFFFFF
    amp1 = amps[1] if pair else 0.0
    if which == "tc":
        for name, t in (("x0", xs[0]), ("w", w)) + ((("x1", xs[1]),)
                                                   if pair else ()):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned, which the "
                                 f"tensor-core kernel's TMA loads need")
        lib, fn = _fn("perturbed_matmul_tc", "pmtc", _TC_ARGTYPES)
        cluster = cluster or tc_cluster(len(xs), m)
        err = fn(len(xs), cluster,
                 xs[0].data_ptr(), x1, w.data_ptr(),
                 ys[0].data_ptr(), y1, m, k, n, n_cols, _DTYPE_CODE[out_dtype],
                 seed,
                 amps[0], amp1, stream)
        error_string = lib.pmtc_error_string
    else:
        lib, fn = _fn("perturbed_matmul", "pm", _ARGTYPES)
        err = fn(len(xs), xs[0].data_ptr(), x1, w.data_ptr(),
                 ys[0].data_ptr(), y1, m, k, n, n_cols, _DTYPE_CODE[xs[0].dtype],
                 _DTYPE_CODE[w.dtype], _DTYPE_CODE[out_dtype], seed,
                 amps[0], amp1, stream)
        error_string = lib.pm_error_string
    if err:
        raise RuntimeError(f"perturbed_matmul ({which}) launch failed: "
                           f"{error_string(err).decode()}")
    return ys, which, signs_hashed(which, len(xs), m, k, n, cluster)


def _count(wrapper, which, hashed):
    if which is not None:
        wrapper.launches += 1
        setattr(wrapper, f"launches_{which}",
                getattr(wrapper, f"launches_{which}") + 1)
        wrapper.signs_hashed += hashed


def perturbed_matmul(x, w, lseed: int, *, amp: float, out_dtype=None,
                     kernel=None, cluster=None, n_cols=None):
    """y = x @ (W + amp·S) for x [M,K], W [K,N] on the card, S indexed
    with row stride ``n_cols`` (None: N).  ``kernel`` (``"tc"``/``"simt"``)
    overrides ``route`` and ``cluster`` (1, 2, 4) the tensor-core kernel's
    cluster size, for comparisons."""
    ys, which, hashed = _launch((x,), w, lseed, (float(amp),), out_dtype,
                                kernel, cluster, n_cols)
    _count(perturbed_matmul, which, hashed)
    return ys[0]


def perturbed_matmul_pair(xp, xm, w, lseed: int, *, dtheta: float,
                          out_dtype=None, kernel=None, cluster=None,
                          n_cols=None):
    """(xp @ (W + Δθ·S), xm @ (W − Δθ·S)) in one pass over W."""
    ys, which, hashed = _launch((xp, xm), w, lseed,
                                (float(dtheta), -float(dtheta)), out_dtype,
                                kernel, cluster, n_cols)
    _count(perturbed_matmul_pair, which, hashed)
    return ys[0], ys[1]


perturbed_matmul.launches = perturbed_matmul.signs_hashed = 0
perturbed_matmul.launches_tc = perturbed_matmul.launches_simt = 0
perturbed_matmul_pair.launches = perturbed_matmul_pair.signs_hashed = 0
perturbed_matmul_pair.launches_tc = perturbed_matmul_pair.launches_simt = 0
