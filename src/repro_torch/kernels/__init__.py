"""The MGD kernels: CUDA C++ for Hopper (``csrc/``), their ctypes launch
wrappers, plain PyTorch versions (``ref``) and the dispatch (``ops``).

Importing this package builds and loads nothing; the first launch does.
``launch_counts``/``reset_launch_counts`` read and clear the wrappers'
launch counters, which show that a run really went through the kernels.
"""
from __future__ import annotations

from . import mgd_update, ops, perturbed_matmul, ref

KERNEL_WRAPPERS = {
    "perturbed_matmul": perturbed_matmul.perturbed_matmul,
    "perturbed_matmul_pair": perturbed_matmul.perturbed_matmul_pair,
    "mgd_update_window": mgd_update.mgd_update_window,
    "mgd_update": mgd_update.mgd_update,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["ops", "ref", "perturbed_matmul", "mgd_update",
           "KERNEL_WRAPPERS", "launch_counts", "reset_launch_counts"]
