"""Launch wrappers for ``csrc/mgd_update.cu`` (CUDA tensors only).

``mgd_update_window_group`` applies W ← W + S_j·α(Δθ·coefs[j]) for
j = 0..J−1 in order to every leaf of a list, out of place, in one launch
for up to ``MAX_LEAVES`` leaves of one dtype.  ``mgd_update`` computes
W − scale·Σ_j coefs[j]·S_j (sum first) for one leaf.  The kernels take any
contiguous leaf, whatever its storage offset, and index its signs over its
elements in row-major order; ``kernels.ops`` views leaves as matrices and
routes CPU tensors to the plain versions.  The window update's launches
are counted on ``mgd_update_window_group.launches``, the sum's on
``mgd_update.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .perturbed_matmul import _DTYPE_CODE, check_operand

MAX_LEAVES = 64          # the kernel's parameter table (csrc/mgd_update.cu)
_WINDOW, _SUM = 0, 1     # the launch's kind

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _build.load("mgd_update")
    fn = lib.mgd_update_group_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.mgd_update_error_string.argtypes = [ctypes.c_int]
        lib.mgd_update_error_string.restype = ctypes.c_char_p
        lib.mgd_update_vector_elems.argtypes = [ctypes.c_int]
        lib.mgd_update_vector_elems.restype = ctypes.c_int
    return lib


def vector_elems(dtype) -> int:
    """Elements a thread of the kernels updates per window step."""
    return _lib().mgd_update_vector_elems(_DTYPE_CODE[dtype])


def _check(ws, lseeds, coefs):
    for i, w in enumerate(ws):
        check_operand(f"w{i}", w, 2)
        if w.device != ws[0].device:
            raise ValueError(f"w{i} lies on {w.device}, w0 on {ws[0].device}")
    check_operand("lseeds", lseeds, 2, dtypes={torch.int32: 0})
    check_operand("coefs", coefs, 1, dtypes={torch.float32: 0})
    if lseeds.shape != (len(ws), coefs.shape[0]):
        raise ValueError(f"lseeds {tuple(lseeds.shape)} is not [leaves "
                         f"{len(ws)}, J {coefs.shape[0]}]")


def _launch(kind, ws, lseeds, coefs, a, b, wrapper):
    """Updated copies of ``ws``: one launch for each run of up to
    MAX_LEAVES leaves of one dtype, each counted on ``wrapper.launches``."""
    outs = [torch.empty_like(w) for w in ws]
    by_dtype = {}
    for i, w in enumerate(ws):
        if w.numel():
            by_dtype.setdefault(w.dtype, []).append(i)
    if not by_dtype:
        return outs
    lib = _lib()
    stream = torch.cuda.current_stream(ws[0].device).cuda_stream
    for dtype, idx in by_dtype.items():
        for s in range(0, len(idx), MAX_LEAVES):
            part = idx[s:s + MAX_LEAVES]
            n = len(part)
            err = lib.mgd_update_group_launch(
                kind, n,
                (ctypes.c_void_p * n)(*[ws[i].data_ptr() for i in part]),
                (ctypes.c_void_p * n)(*[outs[i].data_ptr() for i in part]),
                (ctypes.c_longlong * n)(*[ws[i].numel() for i in part]),
                (ctypes.c_int * n)(*part), lseeds.data_ptr(),
                coefs.data_ptr(), coefs.shape[0], a, b, _DTYPE_CODE[dtype],
                stream)
            if err:
                msg = lib.mgd_update_error_string(err).decode()
                raise RuntimeError(f"{wrapper.__name__} launch failed: {msg}")
            wrapper.launches += 1
    return outs


def mgd_update_window_group(ws, lseeds, coefs, *, alpha: float,
                            dtheta: float):
    """Updated copies of the contiguous leaves ``ws`` [R_l, N_l] (f32 or
    bf16, one device); ``lseeds`` [L, J] int32 (uint32 bit patterns, row l
    for leaf l), ``coefs`` [J] float32, both on the card.  ``alpha`` and
    ``dtheta`` are rounded to f32 and each term α·(Δθ·coefs[j]) is formed
    in the kernel, in the reference's association."""
    ws = list(ws)
    _check(ws, lseeds, coefs)
    return _launch(_WINDOW, ws, lseeds, coefs, float(alpha), float(dtheta),
                   mgd_update_window_group)


mgd_update_window_group.launches = 0


def mgd_update(w, lseeds, coefs, *, scale: float):
    """W − scale·Σ_j coefs[j]·S_j for ``w`` [R, N]; ``lseeds`` [J] int32
    (uint32 bit patterns), ``coefs`` [J] float32, all on the card."""
    if lseeds.dim() != 1:
        raise ValueError(f"lseeds must be 1-D [J], got shape "
                         f"{tuple(lseeds.shape)}")
    lseeds = lseeds.view(1, -1)
    _check([w], lseeds, coefs)
    return _launch(_SUM, [w], lseeds, coefs, float(scale), 0.0,
                   mgd_update)[0]


mgd_update.launches = 0
