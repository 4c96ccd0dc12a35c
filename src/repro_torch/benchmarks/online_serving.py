"""Online-serving load test on the port: latency/QPS under simulated
traffic, with accuracy-under-drift as the quality axis.

    python -m repro_torch.benchmarks.online_serving [--out DIR] [--smoke]
                                                    [--device cpu]

The twin of the reference's ``benchmarks/online_serving.py``: the same
rows (``bench``, ``name``, ``value``, ``detail``), service configs,
seeds and budgets (2000 reference steps, 1000 trim steps a drift
strategy; ``--smoke`` cuts only the load test, 512 requests for 2048),
through ``repro_torch.serving``'s ``OnlineService``.  The service, its
trimmer and the plant run on the CUDA card unless ``--device cpu``; the
clients submit host numpy rows.  Weights come from the port's own
``mlp_init`` of the reference's seeds and the batches are the
reference's, so the rows are the reference's experiment, not its
trajectory.

* **Load test** (informational) — N requests from 4 client threads
  through the fixed-slot dispatcher: p50/p99 latency, sustained QPS and
  the mean slot fill.  A response's latency includes the card's work:
  copying it to the host waits for its batch.
* **Accuracy under drift** (gated) — a ``DriftingPlant`` aging at
  σ_d = 0.08 serves eval traffic while labeled traffic fills the replay
  buffer: ``no_trim`` (η = 0) must collapse below half the above-chance
  margin; ``online_trim`` (η = 1.6, 4 probes) must hold ≥ ~0.85 of the
  drift-free accuracy.  Measured from the service's responses.
* **Torn swaps** (gated at 0) — a publisher hammers parameter swaps while
  clients decode; every response is checked against its stamped version.
* **Resume bit-exactness** (gated at 1) — serve → trim → checkpoint →
  restore → trim equals the uninterrupted trajectory (f32).

Trim steps for the gated rows run synchronously (``service.trim``), so
the trajectory is counter-keyed deterministic; the load test runs the
service's threads.
"""
from __future__ import annotations

import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.api import DriverConfig
from repro_torch.core import mse
from repro_torch.core.rng import fold_in, prng_key
from repro_torch.core.utils import tree_leaves
from repro_torch.data import tasks
from repro_torch.data.pipeline import generator_sampler
from repro_torch.device import resolve_device
from repro_torch.hardware import DriftingPlant, IdealPlant
from repro_torch.models.simple import mlp_apply, mlp_init
from repro_torch.serving.online import (OnlineService, ServiceConfig,
                                        TrimConfig)
from repro_torch.training import TrainLoopConfig, train_mgd

from .common import bench_cli

SIZES = (49, 4, 4)
CHANCE = 0.25                       # 4-way nist7x7 classification
SIGMA_D = 0.08                      # the drift study's no-mitigation collapse
COLLAPSE_FRAC = 0.5
ETA_RETRIM = 1.6
PROBES_RETRIM = 4
REF_STEPS = 2000
WINDOW = 1000                       # trim steps per drift strategy
SLOTS = 16


def _loss(params, batch):
    return mse(mlp_apply(params, batch["x"]), batch["y"])


def _predict(params, batch):
    return mlp_apply(params, batch["x"])


def _service_cfg(**kw):
    base = dict(slots=SLOTS, batch_window_s=0.002, replay_capacity=2048,
                trim_batch=8, min_fill=64, publish_every=10)
    base.update(kw)
    return ServiceConfig(**base)


def _host_batch(key, n):
    x, y = tasks.nist7x7_batch(key, n, device="cpu")
    return x.numpy(), y.numpy()


def _reference(seed, dev):
    """Drift-free MGD training → (θ*, A₀)."""
    params = mlp_init(seed, SIZES, device=dev)
    cfg = DriverConfig(dtheta=2e-2, eta=0.4, mode="central", seed=seed)
    res = train_mgd(_loss, params, cfg,
                    generator_sampler(tasks.nist7x7_batch, 8, seed=11,
                                      device=dev),
                    REF_STEPS,
                    loop=TrainLoopConfig(chunk=REF_STEPS // 4, log=None),
                    device=dev)
    xe, ye = _host_batch(prng_key(99), 512)
    return res.params, _served_free_accuracy(res.params, xe, ye)


def _served_free_accuracy(params, xe, ye):
    dev = tree_leaves(params)[0].device
    with torch.no_grad():
        out = mlp_apply(params, torch.as_tensor(xe, device=dev))
    pred = np.argmax(out.cpu().numpy(), -1)
    return float(np.mean(pred == np.argmax(ye, -1)))


def _serve_eval_accuracy(svc, xe, ye):
    """Accuracy measured from the service's responses (no feedback —
    eval traffic must not enter the replay buffer)."""
    futs = [svc.submit({"x": xe[i]}) for i in range(len(xe))]
    outs = np.stack([np.asarray(f.result(timeout=60).output) for f in futs])
    return float(np.mean(np.argmax(outs, -1) == np.argmax(ye, -1)))


def _feed_labeled(svc, seed, batches, batch_size=8):
    """Serve labeled traffic (predictions + eventual cost feedback) —
    this is what fills the replay buffer that feeds the trimmer."""
    futs = []
    for b in range(batches):
        x, y = _host_batch(fold_in(prng_key(seed), b), batch_size)
        futs += [svc.submit({"x": x[i]}, feedback={"y": y[i]})
                 for i in range(batch_size)]
    for f in futs:
        f.result(timeout=60)


def _drift_strategy(strategy, theta_star, seed):
    """Serve eval traffic from a drifting device for WINDOW trim steps;
    returns tail served accuracy (mean of last 3 evals)."""
    trim_eta = ETA_RETRIM if strategy == "online_trim" else 0.0
    probes = PROBES_RETRIM if strategy == "online_trim" else 1
    plant = DriftingPlant(IdealPlant(_loss), mode="walk",
                          drift_rate=SIGMA_D, seed=seed + 41)
    trim = TrimConfig(DriverConfig(dtheta=2e-2, eta=trim_eta, probes=probes,
                                   mode="central", seed=seed),
                      _loss, plant=plant)
    xe, ye = _host_batch(prng_key(99), 512)
    svc = OnlineService(_predict, theta_star, _service_cfg(), trim=trim)
    svc.start(background_trim=False)   # synchronous trim → deterministic
    accs = []
    try:
        _feed_labeled(svc, seed, batches=16)     # 128 examples ≥ min_fill
        phases = 8
        for phase in range(phases):
            _feed_labeled(svc, seed + 1000 + phase, batches=4)
            took = svc.trim(WINDOW // phases)
            if took != WINDOW // phases:
                raise RuntimeError(f"{strategy}: phase {phase} ran {took} "
                                   f"trim steps of {WINDOW // phases}")
            svc.publish()              # fresh snapshot for the eval pass
            accs.append(_serve_eval_accuracy(svc, xe, ye))
        svc.fence()
    finally:
        svc.close()
    return float(np.mean(accs[-3:]))


def _load_test(theta_star, requests, clients=4):
    """Fire ``requests`` total requests from ``clients`` threads through
    a trim-free service; report latency percentiles and sustained QPS."""
    svc = OnlineService(_predict, theta_star, _service_cfg())
    svc.start()
    xs = _host_batch(prng_key(7), max(requests // 8, 1))[0]
    lats = []
    lats_lock = threading.Lock()

    def client(n, seed):
        rng = np.random.default_rng(seed)
        futs = [svc.submit({"x": xs[rng.integers(0, len(xs))]})
                for _ in range(n)]
        got = [f.result(timeout=60).latency_s for f in futs]
        with lats_lock:
            lats.extend(got)

    try:
        svc.serve({"x": xs[0]})        # warm up outside the timed window
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client,
                                    args=(requests // clients, c))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        stats = svc.stats()
    finally:
        svc.close()
    lat = np.asarray(lats, np.float64)
    return {
        "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "sustained_qps": len(lats) / wall,
        "mean_batch_fill": stats["served"] / max(stats["batches"], 1),
    }


def torn_swap_hammer(requests, dev, *, slots=8, width=256):
    """Concurrent publish/decode: count responses whose parameter leaves
    disagree or whose decoded value mismatches the stamped version."""

    def paired_predict(p, batch):
        a = torch.sum(batch["x"] * 0) + p["a"][0]
        n = batch["x"].shape[0]
        return torch.stack([(a - p["b"][0]).expand(n), a.expand(n)], -1)

    params = {"a": torch.zeros((width,), device=dev),
              "b": torch.zeros((width,), device=dev)}
    svc = OnlineService(paired_predict, params,
                        _service_cfg(slots=slots, batch_window_s=0.0005))
    svc.start()
    stop = threading.Event()

    def publisher():
        v = 0
        while not stop.is_set():
            v += 1
            fill = torch.full((width,), float(v), device=dev)
            svc.store.publish({"a": fill, "b": fill})

    pub = threading.Thread(target=publisher, daemon=True)
    pub.start()
    torn = 0
    try:
        futs = [svc.submit({"x": np.zeros(3, np.float32)})
                for _ in range(requests)]
        for f in futs:
            r = f.result(timeout=60)
            if float(r.output[0]) != 0.0 or \
                    float(r.output[1]) != float(r.version):
                torn += 1
    finally:
        stop.set()
        pub.join(timeout=30)
        svc.close()
    return torn


def resume_bitexact(seed, tmpdir, dev):
    """serve → trim(10, ckpt@5) → restore → trim(5)  ==  trim(15)."""
    theta0 = mlp_init(seed, SIZES, device=dev)

    def make(d):
        trim = TrimConfig(DriverConfig(dtheta=2e-2, eta=ETA_RETRIM,
                                       mode="central", seed=seed), _loss)
        cfg = _service_cfg(min_fill=8, checkpoint_dir=d, checkpoint_every=5)
        svc = OnlineService(_predict, theta0, cfg, trim=trim)
        return svc.start(background_trim=False)

    d = f"{tmpdir}/serve_ck"
    a = make(d)
    _feed_labeled(a, seed, batches=2)
    a.trim(10)
    a.close()
    b = make(d)
    if b.resumed_step != 10:
        raise RuntimeError(f"resumed at {b.resumed_step}, expected 10")
    b.trim(5)
    w_resumed = tree_leaves(b.trimmer.params)
    b.close()
    c = make(f"{tmpdir}/serve_ck_straight")
    _feed_labeled(c, seed, batches=2)
    c.trim(15)
    w_straight = tree_leaves(c.trimmer.params)
    c.close()
    exact = all(torch.equal(x, y) for x, y in zip(w_resumed, w_straight))
    return 1.0 if exact else 0.0


def run(seed: int = 0, smoke: bool = False, device=None):
    dev = resolve_device(device)
    requests = 512 if smoke else 2048
    rows = []

    theta_star, a0 = _reference(seed, dev)
    collapse_acc = CHANCE + COLLAPSE_FRAC * (a0 - CHANCE)
    rows.append({
        "bench": "online_serving", "name": "driftfree_accuracy",
        "value": a0,
        "detail": f"reference MGD training, {REF_STEPS} steps, nist7x7",
    })

    # -- load test (informational: machine-dependent) -----------------------
    load = _load_test(theta_star, requests)
    for k, v in load.items():
        rows.append({
            "bench": "online_serving", "name": k, "value": v,
            "detail": f"{requests} requests, 4 client threads, "
                      f"{SLOTS} decode slots",
        })

    # -- accuracy under drift (the quality axis; gated) ---------------------
    tail = {}
    for strategy in ("no_trim", "online_trim"):
        tail[strategy] = _drift_strategy(strategy, theta_star, seed)
        rows.append({
            "bench": "online_serving",
            "name": f"served_acc_{strategy}_sigma{SIGMA_D:g}",
            "value": tail[strategy],
            "detail": f"tail served accuracy after {WINDOW} trim steps on "
                      f"a drifting plant (OU walk sigma_d={SIGMA_D:g})",
        })
    rows.append({
        "bench": "online_serving", "name": "no_trim_collapsed",
        "value": 1.0 if tail["no_trim"] < collapse_acc else 0.0,
        "detail": f"1.0 iff no-trim served accuracy fell below half the "
                  f"above-chance margin ({collapse_acc:.3f})",
    })
    rows.append({
        "bench": "online_serving", "name": "serve_trim_hold_frac",
        "value": tail["online_trim"] / a0,
        "detail": f"served-while-trimming accuracy / drift-free A0 at "
                  f"sigma_d={SIGMA_D:g} (acceptance: >= 0.85)",
    })

    # -- consistency invariants (gated at zero tolerance) -------------------
    rows.append({
        "bench": "online_serving", "name": "torn_swaps",
        "value": float(torn_swap_hammer(max(requests // 2, 256), dev)),
        "detail": "responses observing a mixed parameter tree under a "
                  "concurrent publish hammer (must be 0)",
    })
    with tempfile.TemporaryDirectory() as tmp:
        rows.append({
            "bench": "online_serving", "name": "resume_bitexact",
            "value": resume_bitexact(seed, tmp, dev),
            "detail": "serve->trim->checkpoint->restore->trim equals the "
                      "uninterrupted trajectory (f32)",
        })
    return rows


def main(argv=None) -> int:
    return bench_cli("online_serving", run, argv, doc=__doc__,
                     smoke_help="512 load-test requests (the committed "
                                "baseline's gated rows are budget-free) "
                                "instead of 2048")


if __name__ == "__main__":
    raise SystemExit(main())
