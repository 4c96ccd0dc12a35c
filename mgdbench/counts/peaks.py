"""NVIDIA H100 SXM peaks and the bounds of the port's kernels.

Frozen copies of ``chip_smoke.py``'s yardstick: the data sheet's dense
peaks at the 700 W limit, the INT32 lanes' instruction rate, the update
kernels' INT32-lane instructions an element and window step (read from
the SASS of ``csrc/mgd_update.cu`` by ``chip_smoke.py`` phase 1 on an
H100, 82 instructions for 16 bf16 elements and 42 for 8 f32 ones), the
bound formulas of phase 2, and the substrings of each kernel's demangled
name in a profiler trace (``KERNEL_KEYS``).
"""
from __future__ import annotations

PEAK_BYTES = 3.35e12                                  # HBM3, bytes/s
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}     # per input type
PEAK_INT32 = 132 * 64 * 1.98e9                        # 132 SMs × 64 × 1.98 GHz
WINDOW_INT_OPS = {"bfloat16": 82 / 16, "float32": 42 / 8}
ELEM_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2}

KERNEL_KEYS = {"perturbed_matmul": ("perturbed_matmul_kernel<1",
                                    "perturbed_matmul_tc_kernel<1"),
               "perturbed_matmul_pair": ("perturbed_matmul_kernel<2",
                                         "perturbed_matmul_tc_kernel<2"),
               "mgd_update_window": ("mgd_update_window_kernel",),
               "mgd_update": ("mgd_update_kernel<",)}


def bound_s(flops: float, nbytes: float, dtype: str = "float32",
            int_ops: float = 0.0) -> float:
    """The least time of a kernel: its operations at the type's peak (or
    its INT32-lane instructions at theirs) against its bytes at HBM's."""
    return max(flops / PEAK_OPS[dtype], int_ops / PEAK_INT32,
               nbytes / PEAK_BYTES)


def pair_bound_s(m: int, k: int, n: int, dtype: str = "bfloat16") -> float:
    """B2, the antithetic pair x₊·(W + θ̃), x₋·(W − θ̃): 4·M·K·N operations
    against two [M, K] inputs, W and two [M, N] outputs."""
    esz = ELEM_BYTES[dtype]
    return bound_s(4.0 * m * k * n, (2 * m * k + k * n + 2 * m * n) * esz,
                   dtype)


def window_bound_s(numel: int, dtype: str, j: int = 1) -> float:
    """B3, the window update of ``numel`` elements of one dtype at window
    J: each element read and written once, J f32 adds, and the sign hash's
    INT32-lane instructions J times."""
    return bound_s(1.0 * j * numel, 2 * numel * ELEM_BYTES[dtype] + 8 * j,
                   int_ops=WINDOW_INT_OPS[dtype] * j * numel)

