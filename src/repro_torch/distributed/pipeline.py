"""Pipeline parallelism over the "pod" axis (GPipe-style).

The twin of the reference's ``distributed/pipeline.py``.  MGD's default
use of the pod axis is data/probe parallelism (the scalar feedback makes
that nearly free), but very deep models may still want pipeline stages.
``pipeline_forward`` runs S stages over a mesh axis with M microbatches,
one stage a rank, passing activations between neighbours with
``torch.distributed.batch_isend_irecv`` — forward-only (MGD has no
backward pass, so the classic GPipe bubble halves: fill is S − 1
microbatch-steps, no drain for gradients).

The schedule is the reference's loop of (M + S − 1) ticks: stage s
computes microbatch m = t − s when 0 ≤ t − s < M, then sends its
activation one step along the ring toward stage s + 1; stage 0 injects
the next microbatch.  The last stage's outputs are broadcast over the
axis, so every rank returns the whole [B, ...] result, as the
reference's does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.utils import tree_map


def pipeline_forward(stage_fn, stage_params, x, *, mesh, axis="pod",
                     microbatches=None):
    """Run ``stage_fn(params_s, x)`` as a pipeline over ``axis`` of the
    DeviceMesh ``mesh``.

    stage_params: pytree stacked on a leading stage dim == the axis size
    (every rank holds all of it and takes its own stage's slice).
    x: [B, ...] global batch, the same on every rank, split into
    ``microbatches`` chunks (default = number of stages).  Returns the
    final-stage outputs re-assembled, on every rank.
    """
    names = tuple(mesh.mesh_dim_names)
    n_stages = mesh.shape[names.index(axis)]
    m = microbatches or n_stages
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    mb = b // m
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    s = mesh.get_local_rank(axis)
    params_s = tree_map(lambda a: a[s], stage_params)
    queue = x.reshape(m, mb, *x.shape[1:])
    buf = queue[0] if s == 0 else torch.zeros_like(queue[0])
    outs = None
    for t in range(m + n_stages - 1):
        m_idx = t - s
        active = 0 <= m_idx < m
        y = stage_fn(params_s, buf) if active else buf
        if outs is None:
            outs = torch.zeros((m,) + tuple(y.shape), dtype=y.dtype,
                               device=y.device)
        if active and s == n_stages - 1:
            outs[m_idx] = y
        if n_stages > 1:
            nxt = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y.contiguous(),
                              ranks[(s + 1) % n_stages], group),
                   dist.P2POp(dist.irecv, nxt,
                              ranks[(s - 1) % n_stages], group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        else:
            nxt = y
        buf = queue[min(t + 1, m - 1)] if s == 0 else nxt
    if n_stages > 1:
        dist.broadcast(outs, src=ranks[-1], group=group)
    return outs.reshape(b, *outs.shape[2:])
