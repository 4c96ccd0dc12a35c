"""The MGD kernels: CUDA C++ for Hopper (``csrc/``), their ctypes launch
wrappers, plain PyTorch versions (``ref``) and the dispatch (``ops``).

Importing this package builds and loads nothing; the first launch does.
``launch_counts``/``reset_launch_counts`` read and clear the wrappers'
launch counters, which show that a run really went through the kernels;
``route_launch_counts`` splits the perturbed matmuls' counts by the kernel
``perturbed_matmul.route`` chose (``"tc"`` or ``"simt"``).  ``hash_counts``
reads the signs each wrapper's launches hashed (``.signs_hashed``) and,
under ``"rademacher_signs"``, those hashed in PyTorch
(``core.perturbations.rademacher_signs``: norm scales, gathered embedding
rows, small leaves' updates, materialized trees, the plain versions).
"""
from __future__ import annotations

from repro_torch.core.perturbations import rademacher_signs
from . import mgd_update, ops, perturbed_matmul, ref

KERNEL_WRAPPERS = {
    "perturbed_matmul": perturbed_matmul.perturbed_matmul,
    "perturbed_matmul_pair": perturbed_matmul.perturbed_matmul_pair,
    "mgd_update_window": mgd_update.mgd_update_window_group,
    "mgd_update": mgd_update.mgd_update,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


MATMUL_WRAPPERS = ("perturbed_matmul", "perturbed_matmul_pair")


def route_launch_counts() -> dict:
    return {name: {r: getattr(KERNEL_WRAPPERS[name], f"launches_{r}")
                   for r in perturbed_matmul.ROUTES}
            for name in MATMUL_WRAPPERS}


def hash_counts() -> dict:
    """Signs hashed so far, keyed as ``launch_counts`` and
    ``"rademacher_signs"``."""
    out = {name: fn.signs_hashed for name, fn in KERNEL_WRAPPERS.items()}
    out["rademacher_signs"] = rademacher_signs.signs_hashed
    return out


def reset_launch_counts() -> None:
    """Clears the launch counters and the hash counters."""
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = fn.signs_hashed = 0
    rademacher_signs.signs_hashed = 0
    for name in MATMUL_WRAPPERS:
        for r in perturbed_matmul.ROUTES:
            setattr(KERNEL_WRAPPERS[name], f"launches_{r}", 0)


__all__ = ["ops", "ref", "perturbed_matmul", "mgd_update",
           "KERNEL_WRAPPERS", "MATMUL_WRAPPERS", "launch_counts",
           "route_launch_counts", "hash_counts", "reset_launch_counts"]
