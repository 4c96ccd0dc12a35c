"""Launch wrapper for ``csrc/mgd_update.cu`` (CUDA tensors only).

``mgd_update_window`` applies W ← W + S_j·terms[j] for j = 0..J−1 in order,
out of place, on a contiguous matrix view of a leaf; ``kernels.ops``
computes the terms in the reference's association and routes CPU tensors
to the plain version.  Launches are counted in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .perturbed_matmul import _DTYPE_CODE, check_operand

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]


def _fn():
    lib = _build.load("mgd_update")
    fn = lib.mgd_update_window_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.mgd_update_error_string.argtypes = [ctypes.c_int]
        lib.mgd_update_error_string.restype = ctypes.c_char_p
    return lib, fn


def mgd_update_window(w, lseeds, terms):
    """Updated copy of ``w`` [R, N]; ``lseeds`` [J] int32 (uint32 bit
    patterns), ``terms`` [J] float32, all on the card."""
    check_operand("w", w, 2)
    check_operand("lseeds", lseeds, 1, dtypes={torch.int32: 0})
    check_operand("terms", terms, 1, dtypes={torch.float32: 0})
    if lseeds.shape != terms.shape:
        raise ValueError(f"lseeds {tuple(lseeds.shape)} and terms "
                         f"{tuple(terms.shape)} differ in length")
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
