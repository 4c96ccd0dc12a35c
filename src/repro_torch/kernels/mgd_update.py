"""Launch wrappers for ``csrc/mgd_update.cu`` (CUDA tensors only).

``mgd_update_window`` applies W ← W + S_j·terms[j] for j = 0..J−1 in order,
and ``mgd_update`` W ← W − scale·Σ_j coefs[j]·S_j (sum first), both out of
place on a contiguous matrix view of a leaf; ``kernels.ops`` computes the
scalars in the reference's association and routes CPU tensors to the
plain versions.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .perturbed_matmul import _DTYPE_CODE, check_operand

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]


_SUM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _fn(symbol="mgd_update_window_launch", argtypes=_ARGTYPES):
    lib = _build.load("mgd_update")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.mgd_update_error_string.argtypes = [ctypes.c_int]
        lib.mgd_update_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check_window(w, lseeds, scalars, name):
    check_operand("w", w, 2)
    check_operand("lseeds", lseeds, 1, dtypes={torch.int32: 0})
    check_operand(name, scalars, 1, dtypes={torch.float32: 0})
    if lseeds.shape != scalars.shape:
        raise ValueError(f"lseeds {tuple(lseeds.shape)} and {name} "
                         f"{tuple(scalars.shape)} differ in length")


def mgd_update_window(w, lseeds, terms):
    """Updated copy of ``w`` [R, N]; ``lseeds`` [J] int32 (uint32 bit
    patterns), ``terms`` [J] float32, all on the card."""
    _check_window(w, lseeds, terms, "terms")
    out = torch.empty_like(w)
    if w.numel() == 0:
        return out
    lib, fn = _fn()
    err = fn(w.data_ptr(), out.data_ptr(), lseeds.data_ptr(),
             terms.data_ptr(), lseeds.shape[0], w.numel(),
             _DTYPE_CODE[w.dtype],
             torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError(f"mgd_update_window launch failed: "
                           f"{lib.mgd_update_error_string(err).decode()}")
    mgd_update_window.launches += 1
    return out


mgd_update_window.launches = 0


def mgd_update(w, lseeds, coefs, *, scale: float):
    """W − scale·Σ_j coefs[j]·S_j for ``w`` [R, N]; ``lseeds`` [J] int32
    (uint32 bit patterns), ``coefs`` [J] float32, all on the card."""
    _check_window(w, lseeds, coefs, "coefs")
    out = torch.empty_like(w)
    if w.numel() == 0:
        return out
    lib, fn = _fn("mgd_update_launch", _SUM_ARGTYPES)
    err = fn(w.data_ptr(), out.data_ptr(), lseeds.data_ptr(),
             coefs.data_ptr(), lseeds.shape[0], float(scale), w.numel(),
             _DTYPE_CODE[w.dtype],
             torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError(f"mgd_update launch failed: "
                           f"{lib.mgd_update_error_string(err).decode()}")
    mgd_update.launches += 1
    return out


mgd_update.launches = 0
