"""Launch wrappers for ``csrc/mgd_update.cu`` (CUDA tensors only).

``mgd_update_window_group`` applies W ← W + S_j·α(Δθ·coefs[j]) for
j = 0..J−1 in order to every leaf of a list, out of place, in one launch
for up to ``MAX_LEAVES`` leaves of one dtype (blocks of wider leaves, with
``n_cols`` > N, take launches of their own).  ``mgd_update`` computes
W − scale·Σ_j coefs[j]·S_j (sum first) for one leaf.  The kernels take any
contiguous leaf, whatever its storage offset, and index the signs of its
element (r, c) at r·n_cols + c (``n_cols`` defaults to the leaf's N); ``kernels.ops`` views leaves as matrices and
routes CPU tensors to the plain versions.  The window update's launches
are counted on ``mgd_update_window_group.launches``, the sum's on
``mgd_update.launches``; the signs they hash, each element's J signs, on
their ``.signs_hashed``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .perturbed_matmul import _DTYPE_CODE, check_n_cols, check_operand

MAX_LEAVES = 64          # the kernel's parameter table (csrc/mgd_update.cu)
MAX_STRIDED = 48         # the same, for blocks of wider leaves
_WINDOW, _SUM = 0, 1     # the launch's kind

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_longlong),
             ctypes.POINTER(ctypes.c_longlong),
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


def _check(ws, lseeds, coefs, n_cols, outs):
    """Operand checks; returns each leaf's signs' row stride."""
    for i, w in enumerate(ws):
        check_operand(f"w{i}", w, 2)
        if w.device != ws[0].device:
            raise ValueError(f"w{i} lies on {w.device}, w0 on {ws[0].device}")
    if outs is not None:
        if len(outs) != len(ws):
            raise ValueError(f"{len(outs)} outputs for {len(ws)} leaves")
        for i, (o, w) in enumerate(zip(outs, ws)):
            check_operand(f"out{i}", o, 2)
            if o.shape != w.shape or o.dtype != w.dtype \
                    or o.device != w.device:
                raise ValueError(f"out{i} is not shaped, typed and placed "
                                 f"as w{i}")
    check_operand("lseeds", lseeds, 2, dtypes={torch.int32: 0})
    check_operand("coefs", coefs, 1, dtypes={torch.float32: 0})
    if lseeds.shape != (len(ws), coefs.shape[0]):
        raise ValueError(f"lseeds {tuple(lseeds.shape)} is not [leaves "
                         f"{len(ws)}, J {coefs.shape[0]}]")
    if n_cols is None:
        n_cols = [None] * len(ws)
    if len(n_cols) != len(ws):
        raise ValueError(f"{len(n_cols)} n_cols for {len(ws)} leaves")
    return [check_n_cols(nc, w.shape[1]) for nc, w in zip(n_cols, ws)]


def _launch(kind, ws, lseeds, coefs, a, b, wrapper, n_cols, outs=None):
    """Updated ``ws`` (written into ``outs``, else into new tensors): one
    launch for each run of up to MAX_LEAVES whole leaves of one dtype, or
    of up to MAX_STRIDED blocks of wider leaves (``n_cols`` > N: the
    strided kernels), each counted on ``wrapper.launches`` and its
    numel × J signs on ``wrapper.signs_hashed``."""
    outs = list(outs) if outs is not None else [torch.empty_like(w)
                                                for w in ws]
    groups = {}
    for i, w in enumerate(ws):
        if w.numel():
            groups.setdefault((w.dtype, n_cols[i] != w.shape[1]),
                              []).append(i)
    if not groups:
        return outs
    lib = _lib()
    stream = torch.cuda.current_stream(ws[0].device).cuda_stream
    for (dtype, strided), idx in groups.items():
        size = MAX_STRIDED if strided else MAX_LEAVES
        for s in range(0, len(idx), size):
            part = idx[s:s + size]
            n = len(part)
            err = lib.mgd_update_group_launch(
                kind, n,
                (ctypes.c_void_p * n)(*[ws[i].data_ptr() for i in part]),
                (ctypes.c_void_p * n)(*[outs[i].data_ptr() for i in part]),
                (ctypes.c_longlong * n)(*[ws[i].numel() for i in part]),
                (ctypes.c_longlong * n)(*[ws[i].shape[1] for i in part]),
                (ctypes.c_longlong * n)(*[n_cols[i] for i in part]),
                (ctypes.c_int * n)(*part), lseeds.data_ptr(),
                coefs.data_ptr(), coefs.shape[0], a, b, _DTYPE_CODE[dtype],
                stream)
            if err:
                msg = lib.mgd_update_error_string(err).decode()
                raise RuntimeError(f"{wrapper.__name__} launch failed: {msg}")
            wrapper.launches += 1
            wrapper.signs_hashed += coefs.shape[0] * sum(ws[i].numel()
                                                         for i in part)
    return outs


def mgd_update_window_group(ws, lseeds, coefs, *, alpha: float,
                            dtheta: float, n_cols=None, out=None):
    """Updated copies of the contiguous leaves ``ws`` [R_l, N_l] (f32 or
    bf16, one device); ``lseeds`` [L, J] int32 (uint32 bit patterns, row l
    for leaf l), ``coefs`` [J] float32, both on the card.  ``alpha`` and
    ``dtheta`` are rounded to f32 and each term α·(Δθ·coefs[j]) is formed
    in the kernel, in the reference's association.  ``n_cols`` holds each
    leaf's signs' row stride (None: N_l); ``out``, contiguous tensors shaped
    as ``ws``, takes the results in place of new ones."""
    ws = list(ws)
    n_cols = _check(ws, lseeds, coefs, n_cols, out)
    return _launch(_WINDOW, ws, lseeds, coefs, float(alpha), float(dtheta),
                   mgd_update_window_group, n_cols, out)


mgd_update_window_group.launches = 0
mgd_update_window_group.signs_hashed = 0


def mgd_update(w, lseeds, coefs, *, scale: float, n_cols=None):
    """W − scale·Σ_j coefs[j]·S_j for ``w`` [R, N], S hashed with row
    stride ``n_cols`` (None: N); ``lseeds`` [J] int32 (uint32 bit
    patterns), ``coefs`` [J] float32, all on the card."""
    if lseeds.dim() != 1:
        raise ValueError(f"lseeds must be 1-D [J], got shape "
                         f"{tuple(lseeds.shape)}")
    lseeds = lseeds.view(1, -1)
    n_cols = _check([w], lseeds, coefs, [n_cols], None)
    return _launch(_SUM, [w], lseeds, coefs, float(scale), 0.0,
                   mgd_update, n_cols)[0]


mgd_update.launches = 0
mgd_update.signs_hashed = 0
