"""Pod-local probe parallelism — MGD's own way to use k workers.

Plain data parallelism under MGD would average the per-pod costs into
one C̃ paired with one perturbation.  Instead each pod k draws its OWN
perturbation θ̃_k and evaluates its OWN share of the batch, giving k
independent (C̃_k, θ̃_k) probe pairs per step:

    update = −η · (1/k) Σ_k C̃_k · θ̃_k / Δθ²

Unbiased, with k× less probe variance at no extra forward work against
data parallelism; the pods share nothing but the k scalars C̃_k.  This
axis exists only because MGD is forward-only.

The reference runs the pods under ``shard_map``, one per device of a
mesh axis, and all-gathers the k scalars.  Here the k pods run **one
after another on one card**, pod 0 first; the stacked ``all_c[k]`` is
the all-gather's twin.  The update is then applied once: on the fused
path one ``kernels.ops.mgd_update_window_group`` launch updates every
ndim ≥ 2 leaf with J = k windows (seeds ``pod_seed(seed, k)``), small
leaves take the sequential k-loop; the materializing path is the
sequential ``tree_axpy`` chain, k = 0..k−1.  Both use one coefficient
vector in the reference's pinned association, ``(−η/Δθ²)·all_c / k``,
so they are bitwise equal (f32); in bf16 the kernel rounds once after
the window where the chain rounds after each pod, as in the reference.

``build_probe_parallel_external_step`` fans the same k probes out to k
external chips behind a host boundary (``hardware.farm.ChipFarm``) and
applies the identical update chain, so a farm of ideal chips walks the
k-pod trajectory.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import perturbations as pert
from .perturbations import MASK
from .utils import f32, tree_axpy, tree_map


def pod_seed(seed, k) -> int:
    """Probe seed of pod/chip ``k``: ``seed + k·0x9E3779B9`` mod 2³².  ONE
    definition — the single-program probe seeds (``core.mgd``), the k-pod
    step and the farm step all derive theirs here, and the k-chip farm ≡
    k-pod bit-equality law hangs on it."""
    return (int(seed) + int(k) * 0x9E3779B9) & MASK


class LocalMesh:
    """Axis names and sizes of the probe layout on one card — the port's
    stand-in for a ``jax.sharding.Mesh``, so ``mesh.shape[probe_axis]``
    reads as in the reference::

        LocalMesh(pod=4)
        LocalMesh(axis_names=("pod", "data"), shape={"pod": 4, "data": 2})
    """

    def __init__(self, axis_names=None, shape=None, **sizes):
        if shape is None:
            shape = dict(sizes)
        elif sizes:
            raise ValueError("pass the axis sizes either as shape= or as "
                             "keywords, not both")
        shape = {str(a): int(n) for a, n in shape.items()}
        self.axis_names = tuple(axis_names) if axis_names is not None \
            else tuple(shape)
        if set(self.axis_names) != set(shape):
            raise ValueError(f"axis_names {self.axis_names} do not match "
                             f"the sized axes {tuple(shape)}")
        for a, n in shape.items():
            if n < 1:
                raise ValueError(f"mesh axis {a!r} has size {n}")
        self.shape = shape

    def __repr__(self):
        sizes = ", ".join(f"{a}={self.shape[a]}" for a in self.axis_names)
        return f"LocalMesh({sizes})"


def _split_batch(batch, n_blocks: int, block: int):
    """Block ``block`` of ``n_blocks`` contiguous leading-dim blocks of
    every batch leaf (a ``P(axis)`` placement's share of one device)."""

    def one(x):
        if x.shape[0] % n_blocks:
            raise ValueError(f"batch leaf with shape {tuple(x.shape)} "
                             f"cannot be split into {n_blocks} blocks — its "
                             f"leading dim must be a multiple of that")
        per = x.shape[0] // n_blocks
        return x[block * per:(block + 1) * per]

    return tree_map(one, batch)


def _resolve_batch_specs(batch_specs, probe_axis, data_axis):
    """(pods split the batch?, data sub-blocks per pod) for a spelling of
    the reference's batch ``PartitionSpec``: ``None`` → the default (the
    leading dim over the probe axis, times the data axis), ``()`` →
    replicated (every pod probes the whole batch, the reference's
    ``P()``), ``(probe_axis,)`` or ``(probe_axis, data_axis)`` → the
    explicit default."""
    if batch_specs is None:
        return True, data_axis is not None
    spec = (batch_specs,) if isinstance(batch_specs, str) \
        else tuple(batch_specs)
    if spec == ():
        return False, False
    if spec == (probe_axis,):
        return True, False
    if data_axis is not None and spec == (probe_axis, data_axis):
        return True, True
    raise ValueError(
        f"batch_specs={batch_specs!r}: the port places a batch as () "
        f"(replicated), ({probe_axis!r},) or ({probe_axis!r}, data_axis) "
        f"— other placements wait for the port of the mesh (ROADMAP A15)")


def _pod_coefs(cfg, all_c, n: int):
    """The update's coefficient vector in the reference's pinned
    association ``(−η/Δθ²)·all_c / k`` — built once, fed to both routes."""
    inv_d2 = 1.0 / (cfg.dtheta * cfg.dtheta)
    return (f32(-cfg.eta * inv_d2) * all_c) / f32(float(n))


def _axpy_chain(cfg, params, step, coefs, n: int):
    """The materializing update: θ ← θ + coefs[k]·θ̃_k for k = 0..n−1 in
    order, θ̃_k regenerated from ``pod_seed(k)``."""
    p = params
    for k in range(n):
        theta = pert.generate(p, ptype=cfg.ptype, step=step,
                              seed=pod_seed(cfg.seed, k), dtheta=cfg.dtheta,
                              tau_p=cfg.tau_p)
        p = tree_axpy(coefs[k], theta, p)
    return p


def _fused_pod_update(cfg, params, step, coefs, n: int):
    """All n pod windows through the window-update kernel: ndim ≥ 2 leaves
    in one grouped launch with J = n (read-W + write-W once, whatever n);
    small leaves in the pod loop's own float association."""
    from repro_torch.core.mgd import fused_leaf_updates

    seeds = [pod_seed(cfg.seed, k) for k in range(n)]
    pstep = step // cfg.tau_p

    def small(leaf, lid):
        for k in range(n):
            theta = pert.rademacher_leaf(
                leaf.shape, leaf.dtype, lid, step=step, seed=seeds[k],
                dtheta=cfg.dtheta, tau_p=cfg.tau_p, device=leaf.device)
            leaf = (leaf.float() + coefs[k] * theta.float()).to(leaf.dtype)
        return leaf

    return fused_leaf_updates(
        cfg, params, lambda lid: [pert.leaf_seed(s, pstep, lid)
                                  for s in seeds], coefs, 1.0, small)


def build_probe_parallel_step(
    loss_fn: Callable,
    cfg,
    mesh,
    *,
    probe_axis: str = "pod",
    data_axis=None,
    param_specs=None,
    batch_specs=None,
    plant=None,
    probe_fn=None,
):
    """Build ``step_fn(params, step, batch) → (params, metrics)`` — the
    registry's probe-parallel builder (``repro_torch.driver(
    "probe_parallel", cfg, loss_fn, mesh=LocalMesh(pod=k))`` wraps it).

    Central differences, τ_θ = 1.  Pod k probes with seed
    ``pod_seed(cfg.seed, k)`` and readout tags (2k, 2k+1): through
    ``plant.apply_perturbed`` (``cfg.fused``, the pair kernel) or
    ``pert.generate`` + ``plant.read_cost_pair`` (materializing).  By
    default the batch's leading dim splits into k contiguous blocks, pod
    k taking block k; with ``data_axis=`` into k·d blocks in pod-major
    order, the pod's costs being the mean of its d sub-block costs (the
    reference's ``pmean``); ``batch_specs=()`` hands every pod the whole
    batch.  The post-update write lands through the plant once a step.

    The metrics are ``c_tilde_mean = mean|C̃_k|`` and, as the reference's
    ``out_specs=P()`` hands back, ``cost = ½(C₊ + C₋)`` of POD 0 — not a
    mean over the pods.
    """
    if cfg.mode != "central":
        raise ValueError(
            f"probe-parallel uses central differences (its per-pod probe "
            f"shares no C₀ memory); got mode={cfg.mode!r} — set "
            f'mode="central"')
    if probe_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh axes {tuple(mesh.axis_names)} have no probe axis "
            f"{probe_axis!r} — name one axis of the mesh after the probe "
            f"dimension (or pass probe_axis=)")
    if data_axis is not None:
        if data_axis == probe_axis:
            raise ValueError(
                f"data_axis={data_axis!r} IS the probe axis — each pod "
                f"already gets its own batch shard along it; a data axis "
                f"shards *within* a pod")
        if data_axis not in mesh.axis_names:
            raise ValueError(
                f"mesh axes {tuple(mesh.axis_names)} have no data axis "
                f"{data_axis!r}")
    if param_specs is not None:
        raise NotImplementedError(
            "param_specs= shards parameters over a mesh, which is not "
            "ported to repro_torch yet (ROADMAP A15, distribution); the "
            "k pods here share one card's replicated params")
    from repro_torch.core.mgd import _resolve_plant
    plant = _resolve_plant(loss_fn, cfg, probe_fn=probe_fn, plant=plant)
    if plant.meta.external:
        raise ValueError("probe-parallel drives in-process plants; an "
                         "external plant belongs to "
                         "repro_torch.driver('probe_parallel_external', "
                         "cfg, plant=ChipFarm(...)) for k chips behind a "
                         "host boundary")
    if cfg.fused:
        if not plant.supports_fused:
            raise ValueError("cfg.fused=True needs a probe_fn (the model's "
                             "perturbed-apply interface) on the plant")
        if cfg.tau_theta != 1 or cfg.replay:
            raise ValueError("fused probe-parallel updates every step "
                             "(tau_theta=1, no replay)")
    n_pods = mesh.shape[probe_axis]
    n_data = mesh.shape[data_axis] if data_axis is not None else 1
    split, sub = _resolve_batch_specs(batch_specs, probe_axis, data_axis)
    half = f32(0.5)

    def pod_pair(params, step, batch, k):
        if cfg.fused:
            probe = pert.Probe(step, pod_seed(cfg.seed, k), pert.ProbeCtx(
                signs=(1.0, -1.0), dtheta=cfg.dtheta, tau_p=cfg.tau_p,
                impl=cfg.kernel_impl))
            costs = plant.apply_perturbed(params, batch, probe, step=step,
                                          tags=(2 * k, 2 * k + 1))
            return costs[0], costs[1]
        theta = pert.generate(params, ptype=cfg.ptype, step=step,
                              seed=pod_seed(cfg.seed, k), dtheta=cfg.dtheta,
                              tau_p=cfg.tau_p)
        return plant.read_cost_pair(params, theta, batch, step=step,
                                    tag=2 * k)

    def pod_costs(params, step, batch, k):
        if not split:
            return pod_pair(params, step, batch, k)
        if not sub:
            return pod_pair(params, step, _split_batch(batch, n_pods, k), k)
        # plain data parallelism inside the pod: its C is the mean over
        # its d sub-blocks' costs
        pairs = [pod_pair(params, step,
                          _split_batch(batch, n_pods * n_data,
                                       k * n_data + q), k)
                 for q in range(n_data)]
        d = f32(float(n_data))
        return (torch.stack([c for c, _ in pairs]).sum() / d,
                torch.stack([c for _, c in pairs]).sum() / d)

    def step_fn(params, step, batch):
        step = int(step)
        cs = []
        cost0 = None
        for k in range(n_pods):
            c_plus, c_minus = pod_costs(params, step, batch, k)
            cs.append((half * (c_plus - c_minus)).float())
            if k == 0:
                cost0 = half * (c_plus + c_minus)
        all_c = torch.stack(cs)                        # the all-gather
        coefs = _pod_coefs(cfg, all_c, n_pods)
        if cfg.fused:
            updated = _fused_pod_update(cfg, params, step, coefs, n_pods)
        else:
            updated = _axpy_chain(cfg, params, step, coefs, n_pods)
        new_params = plant.write_params(updated, step=step, prev=params)
        return new_params, {"cost": cost0.float(),
                            "c_tilde_mean": torch.mean(torch.abs(all_c))}

    return step_fn


def _nanmedian(x):
    """numpy's nanmedian (the mean of the two middle values of an even
    count; NaN when every entry is NaN) — ``torch.nanmedian`` would take
    the lower middle value instead."""
    return torch.nanquantile(x, 0.5)


def _mad_chip_mask(costs, valid, threshold):
    """Robust outlier rejection over the 2k gathered cost scalars:
    median-absolute-deviation gate, computed over VALID chips' readouts
    only (invalid entries are NaN-ed out of the medians).  A chip is
    kept when BOTH of its pair scalars sit within ``threshold`` robust
    standard deviations of the median — a spiked-but-finite C₊ raises no
    exception at the host boundary; only the statistics can reject it.
    The MAD floor guards the degenerate all-equal case (MAD = 0)."""
    flat = costs.reshape(-1)
    vmask = valid.repeat_interleave(2)
    x = torch.where(vmask, flat, torch.full_like(flat, float("nan")))
    med = _nanmedian(x)
    mad = _nanmedian(torch.abs(x - med))
    scale = torch.maximum(f32(1.4826).to(flat.device) * mad,
                          1e-6 * torch.clamp(torch.abs(med), min=1.0))
    ok = torch.abs(flat - med) <= threshold * scale
    return valid & ok.reshape(-1, 2).all(dim=1)


def _trimmed_chip_mask(c_tilde, valid, trim_frac):
    """Symmetric trimmed mean as a mask: drop the ⌊trim_frac·k_valid⌋
    largest and smallest C̃ values among the valid chips.  Rank-based
    (stable argsort + inverse permutation); invalid chips sort to the top
    (+inf key) and are excluded by the ``ranks < n_valid − t`` cut as well
    as the final AND."""
    k = c_tilde.shape[0]
    dev = c_tilde.device
    n_valid = valid.to(torch.int32).sum()
    t = torch.floor(f32(trim_frac).to(dev) * n_valid.float()).to(torch.int32)
    key = torch.where(valid, c_tilde, torch.full_like(c_tilde, float("inf")))
    order = torch.argsort(key, stable=True)
    ranks = torch.empty(k, dtype=torch.int32, device=dev)
    ranks[order] = torch.arange(k, dtype=torch.int32, device=dev)
    keep = (ranks >= t) & (ranks < n_valid - t)
    return valid & keep


def build_probe_parallel_external_step(cfg, farm):
    """Build ``step_fn(params, step, batch) → (params, metrics)`` — the
    registry's ``probe_parallel_external`` builder: the SAME averaged
    update as ``build_probe_parallel_step``,

        θ ← θ − η · (1/k) Σ_k C̃_k · θ̃_k / Δθ²,

    but the k central-difference probes fan out to k EXTERNAL chips over
    the host boundary (``hardware.farm.ChipFarm``: one host round trip a
    step gathers all 2k scalars, the chips evaluate concurrently on the
    farm's execution backend) — the paper §6 "farm of imperfect chips".
    Chip k's θ̃_k is generated where the params live, from
    ``pod_seed(k)``, with readout tags (2k, 2k+1); the update is the
    k-pod step's pinned materializing chain, so a farm of k ideal chips
    and k pods walk the same trajectory, and since device noise is
    counter-keyed every backend walks the identical one.

    **Fault masking / η-rescaling** (armed when the farm carries a
    ``FaultPolicy``; the policy is read ONCE, here, so the clean path is
    the minimal one): the farm's ``valid[k]`` mask — further tightened by
    a finiteness check and the policy's robust aggregation mode
    (``"mad"`` / ``"trimmed"``) — zeroes rejected chips' C̃_k while the
    per-chip coefficient ``−η/(k·Δθ²)`` stays UNCHANGED: dropping a
    chip's term at fixed η/k IS the "rescale η by the live chip count"
    rule.  With every chip valid, ``where(True, C̃, 0) ≡ C̃`` bitwise.
    The metrics gain ``n_valid`` (chips that answered with finite costs)
    and ``n_used`` (chips surviving robust aggregation).
    """
    from repro_torch.hardware.farm import ChipFarm
    if not isinstance(farm, ChipFarm):
        raise TypeError(
            f"probe_parallel_external needs a hardware.farm.ChipFarm "
            f"(k external chips behind one host boundary); got "
            f"{type(farm).__name__}")
    if cfg.mode != "central":
        raise ValueError(
            f"probe-parallel uses central differences (its per-chip probe "
            f"shares no C₀ memory); got mode={cfg.mode!r} — set "
            f'mode="central"')
    n_chips = farm.n_chips
    half = f32(0.5)
    zero = f32(0.0)
    # read once: a frozen FaultPolicy (or None) selects the branch
    policy = getattr(farm, "policy", None)

    def step_fn(params, step, batch):
        step = int(step)
        thetas = [pert.generate(
            params, ptype=cfg.ptype, step=step, seed=pod_seed(cfg.seed, k),
            dtheta=cfg.dtheta, tau_p=cfg.tau_p) for k in range(n_chips)]
        costs, valid = farm.read_cost_pairs(params, thetas, batch,
                                            step=step)    # [k, 2], [k]
        c_raw = (half * (costs[:, 0] - costs[:, 1])).float()
        pair_cost = half * (costs[:, 0] + costs[:, 1])
        if policy is None:
            all_c = c_raw
            aux = {"cost": torch.mean(pair_cost).float(),
                   "c_tilde_mean": torch.mean(torch.abs(all_c))}
        else:
            # the host masks non-finite readouts already, but a masked
            # chip's placeholder is NaN by construction — never let it
            # through the arithmetic
            valid = valid & torch.isfinite(costs).all(dim=1)
            if policy.aggregate == "mad":
                used = _mad_chip_mask(costs, valid,
                                      f32(policy.mad_threshold))
            elif policy.aggregate == "trimmed":
                used = _trimmed_chip_mask(c_raw, valid, policy.trim_frac)
            else:
                used = valid
            all_c = torch.where(used, c_raw, zero.to(c_raw.device))
            n_valid = valid.to(torch.int32).sum()
            n_used = used.to(torch.int32).sum()
            denom = torch.clamp(n_used, min=1).float()
            aux_cost = torch.where(used, pair_cost,
                                   zero.to(c_raw.device)).sum() / denom
            aux = {"cost": aux_cost.float(),
                   "c_tilde_mean": torch.abs(all_c).sum() / denom,
                   "n_valid": n_valid, "n_used": n_used}
        coefs = _pod_coefs(cfg, all_c, n_chips)
        new_params = farm.write_params(
            _axpy_chain(cfg, params, step, coefs, n_chips),
            step=step, prev=params)
        return new_params, aux

    return step_fn
