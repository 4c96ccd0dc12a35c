"""Launch wrappers for ``csrc/perturbed_matmul.cu`` (CUDA tensors only).

``perturbed_matmul`` computes y = x @ (W + amp·S) and
``perturbed_matmul_pair`` (xp @ (W + Δθ·S), xm @ (W − Δθ·S)) with one read
of W, S the counter-hashed Rademacher signs of the leaf seed.  They take
2-D contiguous operands; ``kernels.ops`` flattens lead dims and routes CPU
tensors to the plain versions.  Each wrapper counts its launches in
``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_uint32, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _fn():
    lib = _build.load("perturbed_matmul")
    fn = lib.pm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.pm_error_string.argtypes = [ctypes.c_int]
        lib.pm_error_string.restype = ctypes.c_char_p
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


def _launch(xs, w, lseed, amps, out_dtype):
    m, k = xs[0].shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"x [{m},{k}] does not multiply W [{k2},{n}]")
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
        return ys, False
    lib, fn = _fn()
    pair = len(xs) == 2
    err = fn(len(xs), xs[0].data_ptr(), xs[1].data_ptr() if pair else None,
             w.data_ptr(), ys[0].data_ptr(), ys[1].data_ptr() if pair else None,
             m, k, n, _DTYPE_CODE[xs[0].dtype], _DTYPE_CODE[w.dtype],
             _DTYPE_CODE[out_dtype], int(lseed) & 0xFFFFFFFF,
             amps[0], amps[1] if pair else 0.0,
             torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError(f"perturbed_matmul launch failed: "
                           f"{lib.pm_error_string(err).decode()}")
    return ys, True


def perturbed_matmul(x, w, lseed: int, *, amp: float, out_dtype=None):
    """y = x @ (W + amp·S) for x [M,K], W [K,N] on the card."""
    ys, launched = _launch((x,), w, lseed, (float(amp),), out_dtype)
    if launched:
        perturbed_matmul.launches += 1
    return ys[0]


def perturbed_matmul_pair(xp, xm, w, lseed: int, *, dtheta: float,
                          out_dtype=None):
    """(xp @ (W + Δθ·S), xm @ (W − Δθ·S)) in one pass over W."""
    ys, launched = _launch((xp, xm), w, lseed,
                           (float(dtheta), -float(dtheta)), out_dtype)
    if launched:
        perturbed_matmul_pair.launches += 1
    return ys[0], ys[1]


perturbed_matmul.launches = 0
perturbed_matmul_pair.launches = 0
