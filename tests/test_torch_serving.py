"""The port's online serving tier against the JAX package's.

Twins of the 16 tests of ``tests/test_online_serving.py`` (torn-swap
regression, serve→trim→resume bitwise, replay buffer, lifecycle,
``TrainLoopConfig``'s flat keywords, the lazy front door), run on the
CPU, plus:

* ``ReplayBuffer`` draws the reference's rows bitwise after the same
  adds (both sample with ``np.random.default_rng((seed, step))``), and
  each package reads the other's sidecar.
* ``OnlineTrimmer.step`` on the XOR 2-2-1 and NIST7x7 49-4-4 MLPs (f32,
  the reference's params carried by ``convert``, the same replay rows)
  tracks the reference's trimmer over 40 steps within the MLP trainer's
  stated tolerances: C̃ 1e-6 and params 2e-4 (``tests/test_torch_
  trainer.py``: torch's and XLA's CPU sigmoid/matmul round apart).
* A published tree's bytes stay unchanged while the trimmer steps
  through a noisy drifting plant, publishes, checkpoints and restores:
  every writer of the port is out of place, so the store never clones.
* ``jit_predict`` changes nothing (the port predicts eagerly); errors in
  a predict call reach the requests' futures, errors in the trainer
  thread are raised by ``fence``/``close``.
* ``import repro_torch.serving`` pulls in no ``jax``.
"""
import os
import pathlib
import subprocess
import sys
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.driver import DriverConfig as JDriverConfig
from repro.data import tasks as jtasks
from repro.models.simple import make_mlp_probe_fn as jprobe_fn
from repro.models.simple import mlp_apply as jmlp_apply
from repro.models.simple import mlp_init as jmlp_init
from repro.serving import online as jonline
import repro_torch as rt
from repro_torch import convert
from repro_torch.api.driver import DriverConfig
from repro_torch.core import rng
from repro_torch.core.utils import tree_leaves
from repro_torch.serving.online import (OnlineService, ParamStore,
                                        ReplayBuffer, ServiceConfig,
                                        TrimConfig)

W_TRUE = np.arange(6, dtype=np.float32).reshape(3, 2)
CT_ATOL = 1e-6
PARAM_ATOL = 2e-4


def _predict(p, batch):
    return batch["x"] @ p["w"]


def _loss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def _params():
    return {"w": torch.zeros((3, 2), dtype=torch.float32)}


def _svc(cfg=None, trim=True, **kw):
    if cfg is None:
        base = dict(slots=4, min_fill=4, trim_batch=4, publish_every=5,
                    batch_window_s=0.001)
        base.update(kw)
        cfg = ServiceConfig(**base)
    tc = TrimConfig(DriverConfig(dtheta=5e-2, eta=0.2), _loss) if trim \
        else None
    return rt.serve(cfg, _predict, _params(), trim=tc, start=False)


def _traffic(svc, n=16, seed=0):
    r = np.random.default_rng(seed)
    futs = []
    for _ in range(n):
        x = r.normal(size=(3,)).astype(np.float32)
        futs.append(svc.submit({"x": x}, feedback={"y": x @ W_TRUE}))
    return [f.result(timeout=30) for f in futs]


# ---------------------------------------------------------------------------
# Snapshot consistency — the torn-swap regression test
# ---------------------------------------------------------------------------


def test_param_swap_never_tears_mid_decode():
    """Two leaves are always published with EQUAL fill values; any
    response whose leaves disagree, or whose output doesn't match its
    stamped version, caught a torn swap."""
    from repro_torch.benchmarks.online_serving import torn_swap_hammer

    assert torn_swap_hammer(200, torch.device("cpu"), slots=4,
                            width=64) == 0


def test_store_snapshot_is_atomic_reference():
    store = ParamStore({"w": torch.zeros(3)})
    assert store.version == 0
    v = store.publish({"w": torch.ones(3)})
    snap = store.snapshot()
    assert v == 1 and snap.version == 1
    store.publish({"w": torch.full((3,), 2.0)})
    # a held snapshot is unchanged — later publishes don't touch it
    np.testing.assert_array_equal(snap.params["w"].numpy(), np.ones(3))


# ---------------------------------------------------------------------------
# Serve → trim → resume bit-exactness (f32)
# ---------------------------------------------------------------------------


def test_serve_trim_resume_bit_exact(tmp_path):
    def make(d=None):
        cfg = ServiceConfig(slots=4, min_fill=4, trim_batch=4,
                            publish_every=5, checkpoint_dir=d,
                            checkpoint_every=5, batch_window_s=0.001)
        return rt.serve(cfg, _predict, _params(),
                        trim=TrimConfig(DriverConfig(dtheta=5e-2, eta=0.2),
                                        _loss),
                        start=False)

    d = str(tmp_path / "ck")
    a = make(d).start(background_trim=False)
    _traffic(a)
    assert a.trim(10) == 10
    a.close()

    b = make(d).start(background_trim=False)
    assert b.resumed_step == 10
    assert len(b.replay) == 16          # the ring came back via sidecar
    b.trim(5)
    w_resumed = b.trimmer.params["w"].clone()
    assert b.trimmer.global_step == 15
    b.close()

    c = make(None).start(background_trim=False)
    _traffic(c)
    c.trim(15)
    w_straight = c.trimmer.params["w"]
    c.close()
    assert torch.equal(w_resumed, w_straight)


def test_trim_improves_served_cost():
    svc = _svc().start(background_trim=False)
    try:
        _traffic(svc)
        x = np.ones(3, np.float32)
        before = float(np.abs(svc.serve({"x": x}).output - x @ W_TRUE).sum())
        svc.trim(200)
        after = float(np.abs(svc.serve({"x": x}).output - x @ W_TRUE).sum())
        assert after < before * 0.5, (before, after)
        assert svc.version == 40        # 200 steps / publish_every=5
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Replay buffer
# ---------------------------------------------------------------------------


def test_replay_buffer_bounded_and_counter_keyed():
    buf = ReplayBuffer(capacity=8)
    for i in range(12):
        buf.add({"x": np.full(3, float(i), np.float32)})
    assert len(buf) == 8 and buf.total_added == 12
    # oldest entries evicted: fills 4..11 remain
    s = buf.sample(64, step=3, seed=7)
    assert set(np.unique(s["x"])) <= set(float(i) for i in range(4, 12))
    # counter-keyed: same (seed, step) → same batch; different step differs
    np.testing.assert_array_equal(buf.sample(16, step=3, seed=7)["x"],
                                  buf.sample(16, step=3, seed=7)["x"])
    assert not np.array_equal(buf.sample(16, step=3, seed=7)["x"],
                              buf.sample(16, step=4, seed=7)["x"])


def test_replay_buffer_rejects_bad_shapes():
    buf = ReplayBuffer(capacity=4)
    buf.add({"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="keys"):
        buf.add({"y": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="empty"):
        ReplayBuffer(capacity=4).sample(1, step=0)


def test_feedback_flows_into_replay_only_when_given():
    svc = _svc(trim=False).start()
    try:
        svc.serve({"x": np.zeros(3, np.float32)})
        assert len(svc.replay) == 0     # no feedback, no logging
        svc.serve({"x": np.zeros(3, np.float32)},
                  feedback={"y": np.zeros(2, np.float32)})
        assert len(svc.replay) == 1
        with pytest.raises(RuntimeError, match="no trimmer"):
            svc.trim(1)
    finally:
        svc.close()


def _fill_both(n=37, capacity=16, seed=0):
    r = np.random.default_rng(seed)
    mine, ref = ReplayBuffer(capacity), jonline.ReplayBuffer(capacity)
    for _ in range(n):
        ex = {"x": r.normal(size=(49,)).astype(np.float32),
              "y": np.eye(4, dtype=np.float32)[r.integers(0, 4)],
              "t": r.integers(0, 100, (5,)).astype(np.int32)}
        mine.add(ex)
        ref.add(ex)
    return mine, ref


def test_replay_buffer_samples_bitwise_reference():
    mine, ref = _fill_both()
    for seed, step in ((0, 0), (0, 1), (7, 123), (3, 10 ** 6)):
        a, b = mine.sample(24, step, seed=seed), ref.sample(24, step,
                                                            seed=seed)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_replay_sidecar_reads_both_ways(tmp_path):
    mine, ref = _fill_both(n=21, capacity=16)
    mine.save_sidecar(str(tmp_path / "port.npz"))
    ref.save_sidecar(str(tmp_path / "ref.npz"))
    ref_back = jonline.ReplayBuffer(16)
    ref_back.load_sidecar(str(tmp_path / "port.npz"))
    mine_back = ReplayBuffer(16)
    mine_back.load_sidecar(str(tmp_path / "ref.npz"))
    for a, b in ((mine_back, ref), (mine, ref_back)):
        sa, sb = a.state(), b.state()
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
        for k, v in a.sample(9, 5, seed=2).items():
            np.testing.assert_array_equal(v, b.sample(9, 5, seed=2)[k])
    with pytest.raises(ValueError, match="capacity"):
        ReplayBuffer(8).load_sidecar(str(tmp_path / "ref.npz"))


# ---------------------------------------------------------------------------
# The trimmer against the reference's
# ---------------------------------------------------------------------------


def _jloss(p, b):
    return jnp.mean((jmlp_apply(p, b["x"]) - b["y"]) ** 2)


def _tloss(p, b):
    return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])


def _mlp_rows(task):
    if task == "xor":
        x = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
        y = np.array([[0.], [1.], [1.], [0.]], np.float32)
        return (2, 2, 1), np.tile(x, (4, 1)), np.tile(y, (4, 1))
    x, y = jtasks.nist7x7_batch(jax.random.PRNGKey(5), 48)
    return (49, 4, 4), np.asarray(x), np.asarray(y)


@pytest.mark.parametrize("task,kw", [
    ("xor", dict(mode="central", eta=0.5)),
    ("xor", dict(mode="forward", eta=1.0, replay=True, tau_theta=4)),
    ("nist", dict(mode="central", eta=0.1, fused=True)),
    ("nist", dict(mode="central", eta=0.2, probes=4))],
    ids=["xor-central", "xor-forward-replay4", "nist-fused",
         "nist-probes4"])
def test_trimmer_tracks_reference(task, kw):
    sizes, xs, ys = _mlp_rows(task)
    p0 = jax.tree_util.tree_map(np.asarray,
                                jmlp_init(jax.random.PRNGKey(1), sizes))
    cfg = dict(slots=4, min_fill=8, trim_batch=4, publish_every=7, seed=3)
    fused = kw.get("fused", False)
    jsvc = jonline.OnlineService(
        lambda p, b: jmlp_apply(p, b["x"]), jax.tree_util.tree_map(
            jnp.asarray, p0), jonline.ServiceConfig(**cfg),
        trim=jonline.TrimConfig(JDriverConfig(dtheta=2e-2, seed=0, **kw),
                                _jloss,
                                probe_fn=jprobe_fn() if fused else None))
    tsvc = OnlineService(
        lambda p, b: rt.mlp_apply(p, b["x"]),
        convert.to_torch(p0, device="cpu"), ServiceConfig(**cfg),
        trim=TrimConfig(DriverConfig(dtheta=2e-2, seed=0, **kw), _tloss,
                        probe_fn=rt.make_mlp_probe_fn() if fused else None))
    for svc in (jsvc, tsvc):
        svc.replay.add_batch({"x": xs, "y": ys})
    for _ in range(40):
        assert jsvc.trim(1) == 1 and tsvc.trim(1) == 1
        js, ts = jsvc.trimmer.stats(), tsvc.trimmer.stats()
        assert ts["global_step"] == js["global_step"]
        assert abs(ts["aux_c_tilde"] - js["aux_c_tilde"]) <= CT_ATOL
    assert tsvc.version == jsvc.version == 5
    for a, b in zip(tree_leaves(tsvc.snapshot().params),
                    jax.tree_util.tree_leaves(jsvc.snapshot().params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL)
    jsvc.close()
    tsvc.close()


def test_published_snapshot_unchanged_under_trimming(tmp_path):
    """Snapshot a published tree's bytes; trim through a noisy drifting
    plant on the fused path (noisy writes, drift, the window update),
    publish, checkpoint and restore: the held tree is byte-for-byte the
    same, and so is every later snapshot once taken."""
    sizes, xs, ys = _mlp_rows("nist")
    params = rt.mlp_init(2, sizes, device="cpu")
    plant = rt.hardware.DriftingPlant(
        rt.hardware.NoisyPlant(_tloss, cost_noise=1e-4, write_noise=0.1,
                               seed=5, probe_fn=rt.make_mlp_probe_fn()),
        mode="walk", drift_rate=0.02, seed=9)
    svc = OnlineService(
        lambda p, b: rt.mlp_apply(p, b["x"]), params,
        ServiceConfig(slots=4, min_fill=8, trim_batch=8, publish_every=3,
                      checkpoint_dir=str(tmp_path / "ck"),
                      checkpoint_every=4),
        trim=TrimConfig(DriverConfig(dtheta=2e-2, eta=0.3, mode="central",
                                     fused=True), plant=plant))
    svc.replay.add_batch({"x": xs, "y": ys})
    held = []
    for _ in range(4):
        snap = svc.snapshot()
        held.append((snap, [t.clone() for t in tree_leaves(snap.params)]))
        assert svc.trim(5) == 5
    assert svc.version >= 3
    svc.trimmer.restore()               # a restore rebinds, never writes
    svc.trim(3)
    for snap, saved in held:
        for now, then in zip(tree_leaves(snap.params), saved):
            assert torch.equal(now, then)
    leaves = [t.clone() for t in tree_leaves(svc.trimmer.params)]
    svc.trim(2)
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(svc.trimmer.params), leaves))
    svc.close()


# ---------------------------------------------------------------------------
# Uniform lifecycle contract
# ---------------------------------------------------------------------------


def _lifecycle_objects():
    from repro_torch.hardware import (ChipFarm, ExternalPlant,
                                      SimulatedAnalogChip)
    yield ExternalPlant(SimulatedAnalogChip((2, 2, 1)))
    yield ChipFarm([SimulatedAnalogChip((2, 2, 1), seed=s)
                    for s in range(2)])
    yield _svc(trim=False)


@pytest.mark.parametrize("obj_factory", [_lifecycle_objects],
                         ids=["plants_and_service"])
def test_uniform_lifecycle_contract(obj_factory):
    for obj in obj_factory():
        name = type(obj).__name__
        assert callable(getattr(obj, "fence", None)), name
        assert callable(getattr(obj, "close", None)), name
        with obj as entered:
            assert entered is obj, name
            entered.fence()
        obj.close()                      # second close: idempotent
        obj.close()


def test_service_rejects_use_after_close():
    svc = _svc(trim=False).start()
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit({"x": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="closed"):
        svc.start()


def test_service_requires_start_before_submit():
    svc = _svc(trim=False)
    with pytest.raises(RuntimeError, match="start"):
        svc.submit({"x": np.zeros(3, np.float32)})
    svc.close()


def test_fence_drains_inflight_requests():
    svc = _svc(trim=False).start()
    try:
        futs = [svc.submit({"x": np.zeros(3, np.float32)})
                for _ in range(32)]
        svc.fence()
        assert all(f.done() for f in futs)
    finally:
        svc.close()


def test_ragged_request_shape_is_loud():
    svc = _svc(trim=False, slots=4, batch_window_s=0.05).start()
    try:
        f1 = svc.submit({"x": np.zeros(3, np.float32)})
        f2 = svc.submit({"x": np.zeros(5, np.float32)})
        with pytest.raises(ValueError, match="fixed-shape"):
            f2.result(timeout=30)
        with pytest.raises(ValueError):
            f1.result(timeout=30)       # whole batch fails loudly
    finally:
        svc.close()


def test_jit_predict_is_parity_only():
    """Both values of ``jit_predict`` serve the same outputs, eagerly."""
    x = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    w = {"w": torch.from_numpy(W_TRUE.copy())}
    outs = []
    for jit in (True, False):
        with rt.serve(ServiceConfig(slots=4, jit_predict=jit), _predict,
                      w) as svc:
            outs.append(np.stack([f.result(timeout=30).output for f in
                                  [svc.submit({"x": r}) for r in x]]))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], x @ W_TRUE)


def test_worker_errors_are_surfaced():
    def bad_predict(p, batch):
        raise FloatingPointError("device fault")

    with rt.serve(ServiceConfig(slots=2), bad_predict, _params()) as svc:
        with pytest.raises(FloatingPointError, match="device fault"):
            svc.serve({"x": np.zeros(3, np.float32)})

    calls = []

    def flaky_loss(p, b):
        calls.append(1)
        if len(calls) > 6:
            raise FloatingPointError("trainer fault")
        return _loss(p, b)

    svc = rt.serve(ServiceConfig(slots=4, min_fill=4, trim_batch=4),
                   _predict, _params(),
                   trim=TrimConfig(DriverConfig(dtheta=5e-2, eta=0.2),
                                   flaky_loss))
    _traffic(svc, n=8)
    deadline = time.monotonic() + 30
    while svc._trim_error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="trainer thread failed"):
        svc.fence()
    with pytest.raises(RuntimeError, match="trainer thread failed"):
        svc.close()
    svc.close()                          # idempotent after the raise


def test_background_trainer_thread_serves_and_trims():
    svc = _svc(publish_every=2).start()
    try:
        _traffic(svc, n=32)
        deadline = time.monotonic() + 30
        while svc.stats()["trim_global_step"] < 20 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        svc.fence()
        stats = svc.stats()
        assert stats["trim_global_step"] >= 20 and stats["version"] >= 10
        assert stats["served"] == 32 and stats["latency_p99_ms"] > 0
        r = svc.serve({"x": np.ones(3, np.float32)})
        assert r.version == svc.version or r.version == svc.version - 1
    finally:
        svc.close()
    assert all(not t.is_alive() for t in threading.enumerate()
               if t.name.startswith("online-service"))


# ---------------------------------------------------------------------------
# TrainLoopConfig — consolidated loop front door
# ---------------------------------------------------------------------------


def _train_loss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def _sample_fn(step):
    x = rng.normal(rng.prng_key(0), (4, 3), device="cpu") + step * 0.01
    return {"x": x, "y": x @ torch.from_numpy(W_TRUE)}


def test_trainloopconfig_bit_identical_to_flat_kwargs():
    cfg = DriverConfig(dtheta=1e-2, eta=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PendingDeprecationWarning)
        r_flat = rt.train(_train_loss, _params(), cfg, _sample_fn, 20,
                          chunk=10, log=None, device="cpu")
    r_loop = rt.train(_train_loss, _params(), cfg, _sample_fn, 20,
                      loop=rt.TrainLoopConfig(chunk=10, log=None),
                      device="cpu")
    for a, b in zip(tree_leaves(r_flat.params), tree_leaves(r_loop.params)):
        assert torch.equal(a, b)


def test_flat_kwargs_fire_single_pending_deprecation():
    from repro_torch.api.driver import _WARNED
    _WARNED.discard("train_mgd's flat loop keywords")
    cfg = DriverConfig(dtheta=1e-2, eta=0.5)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        rt.train(_train_loss, _params(), cfg, _sample_fn, 2, chunk=1,
                 log=None, device="cpu")
        rt.train(_train_loss, _params(), cfg, _sample_fn, 2, chunk=1,
                 log=None, device="cpu")
    pend = [w for w in rec
            if issubclass(w.category, PendingDeprecationWarning)
            and "TrainLoopConfig" in str(w.message)]
    assert len(pend) == 1, [str(w.message) for w in rec]


def test_trainloopconfig_rejects_mixes_and_unknowns():
    cfg = DriverConfig(dtheta=1e-2, eta=0.5)
    with pytest.raises(TypeError, match="TrainLoopConfig"):
        rt.train(_train_loss, _params(), cfg, _sample_fn, 1, bogus=1,
                 device="cpu")
    with pytest.raises(ValueError, match="one place"):
        rt.train(_train_loss, _params(), cfg, _sample_fn, 1,
                 loop=rt.TrainLoopConfig(), chunk=5, device="cpu")


def test_lazy_front_door_exports():
    for name in ("train", "serve", "driver", "TrainLoopConfig",
                 "ServiceConfig", "TrimConfig", "OnlineService"):
        assert name in rt.__all__, name
        assert getattr(rt, name) is not None
        assert getattr(rt.api, name) is not None
    assert rt.serve is rt.api.serve is rt.serving.serve
    # a fresh import of repro_torch loads neither the serving tier nor
    # jax, and the serving tier itself pulls in no jax
    code = ("import sys, repro_torch; "
            "assert 'repro_torch.serving' not in sys.modules; "
            "import repro_torch.serving, repro_torch.launch.serve; "
            "assert not [m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'repro.'))]; "
            "assert 'repro' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=str(
        pathlib.Path(__file__).resolve().parent.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
