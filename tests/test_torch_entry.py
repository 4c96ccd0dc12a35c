"""The port's entry points, device rules and import boundary.

* ``driver``/``make_epoch``/``train_mgd`` drive NIST7x7 49-4-4 on the CPU
  when asked for ``device="cpu"``;
* without a card, entry points that are not asked for the CPU raise
  instead of falling back;
* ``repro_torch`` imports neither ``jax`` nor ``repro`` (AST check over
  every module and ``chip_smoke.py``), and imports without ``nvcc``.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch import convert
from repro_torch.core import rng
from repro_torch.data import pipeline, tasks

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _loss(p, b):
    return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])


def _nist_sampler(batch=8):
    return pipeline.generator_sampler(tasks.nist7x7_batch, batch, seed=7,
                                      device="cpu")


def _cfg(**kw):
    base = dict(dtheta=1e-2, eta=0.1, seed=1, mode="central", fused=True)
    base.update(kw)
    return rt.DriverConfig(**base)


@pytest.mark.parametrize("kw", [{}, {"mode": "forward"},
                                {"replay": True, "tau_theta": 4}],
                         ids=["central", "forward", "replay4"])
def test_driver_trains_nist7x7_on_cpu(kw):
    params = rt.mlp_init(1, (49, 4, 4), device="cpu")
    drv = rt.driver("discrete", _cfg(**kw), _loss,
                    probe_fn=rt.make_mlp_probe_fn(), device="cpu")
    state = drv.init(params)
    sample = _nist_sampler()
    for i in range(6):
        params, state, aux = drv.step(params, state, sample(i))
    assert set(aux) >= {"cost", "c_tilde", "grad_norm_proxy", "updated"}
    assert all(torch.isfinite(v).all() for v in aux.values())
    assert state.step == 6
    assert [tuple(p["w"].shape) for p in params] == [(49, 4), (4, 4)]


def test_make_epoch_matches_stepwise():
    sample = _nist_sampler()
    drv = rt.driver("discrete", _cfg(), _loss,
                    probe_fn=rt.make_mlp_probe_fn(), device="cpu")
    p0 = rt.mlp_init(1, (49, 4, 4), device="cpu")
    pa, sa, aux = rt.make_epoch(drv, 10, sample)(p0, drv.init(p0))
    pb, sb = p0, drv.init(p0)
    cts = []
    for i in range(10):
        pb, sb, m = drv.step(pb, sb, sample(i))
        cts.append(m["c_tilde"])
    assert aux["c_tilde"].shape == (10,)
    assert torch.equal(aux["c_tilde"], torch.stack(cts))
    assert sa.step == sb.step == 10
    for a, b in zip(pa, pb):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_train_mgd_on_cpu_records_history():
    x, y = tasks.nist7x7_batch(rng.prng_key(99), 64, device="cpu")
    params = rt.mlp_init(1, (49, 4, 4), device="cpu")
    logs = []

    def acc(p):
        pred = rt.mlp_apply(p, x).argmax(-1)
        return {"acc": (pred == y.argmax(-1)).float().mean()}

    res = rt.train_mgd(_loss, params, _cfg(), _nist_sampler(1), 40,
                       loop=rt.TrainLoopConfig(
                           chunk=16, eval_fn=acc, eval_every=16,
                           probe_fn=rt.make_mlp_probe_fn(),
                           log=logs.append),
                       device="cpu")
    assert res.steps_done == 40 and res.state.step == 40
    assert [s for s, _ in res.history] == [16, 32, 40]
    assert "acc" in res.history[0][1] and len(logs) == 3
    assert all(np.isfinite(v) for _, rec in res.history for v in rec.values())


def test_entry_points_raise_without_a_card(monkeypatch):
    """Nothing falls back to the CPU: with no card and no device='cpu',
    every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.mlp_init(0, (2, 2, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.driver("discrete", _cfg(), _loss, probe_fn=rt.make_mlp_probe_fn())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.train_mgd(_loss, rt.mlp_init(0, (2, 2, 1), device="cpu"), _cfg(),
                     lambda i: None, 1,
                     loop=rt.TrainLoopConfig(probe_fn=rt.make_mlp_probe_fn()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.generator_sampler(tasks.nist7x7_batch, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tasks.xor_dataset()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.to_torch([{"w": np.zeros((2, 2), np.float32)}])


def test_driver_refuses_params_on_another_device():
    from repro_torch.api.driver import check_on_device
    params = rt.mlp_init(0, (2, 2, 1), device="cpu")
    check_on_device(params, torch.device("cpu"))
    with pytest.raises(ValueError, match="driver runs on"):
        check_on_device(params, torch.device("cuda"))


@pytest.mark.parametrize("impl", ["pallas", "interpret"])
def test_pallas_kernel_impl_raises(impl):
    with pytest.raises(ValueError, match="Pallas"):
        rt.MGDConfig(kernel_impl=impl)
    with pytest.raises(ValueError, match="Pallas"):
        rt.driver("discrete", _cfg(kernel_impl=impl), _loss,
                  probe_fn=rt.make_mlp_probe_fn(), device="cpu")


def test_cuda_impl_on_cpu_params_raises():
    drv = rt.driver("discrete", _cfg(kernel_impl="cuda"), _loss,
                    probe_fn=rt.make_mlp_probe_fn(), device="cpu")
    params = rt.mlp_init(0, (49, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        drv.step(params, drv.init(params), _nist_sampler()(0))


@pytest.mark.parametrize("algorithm,item", [
    ("probe_parallel", "A11"), ("probe_parallel_external", "A11")])
def test_unported_algorithms_name_their_roadmap_item(algorithm, item):
    """The probe-parallel algorithms, unported until ROADMAP ``item``
    (A11, with A12's host boundary), are registered and build on the CPU;
    what of them is still unported — parameter sharding over a mesh —
    raises naming its own item (A15)."""
    from repro_torch.hardware import simulated_chip_farm

    assert algorithm in rt.ALGORITHMS
    cfg = rt.DriverConfig(mode="central")
    if algorithm == "probe_parallel":
        drv = rt.driver(algorithm, cfg, _loss, mesh=rt.LocalMesh(pod=2),
                        device="cpu")
        with pytest.raises(NotImplementedError, match="A15"):
            rt.driver(algorithm, cfg, _loss, mesh=rt.LocalMesh(pod=2),
                      param_specs=[("w", ["model"])], device="cpu")
    else:
        with simulated_chip_farm(2, (2, 2, 1), backend="serial") as farm:
            drv = rt.driver(algorithm, cfg, plant=farm, device="cpu")
    assert drv.algorithm == algorithm


def test_unported_knobs_raise(tmp_path):
    from repro_torch.training import checkpoint as ckpt

    params = rt.mlp_init(0, (2, 2, 1), device="cpu")
    ckpt.save(str(tmp_path), 1, params)
    with pytest.raises(NotImplementedError, match="A15"):
        ckpt.restore(str(tmp_path), params, mesh=object())
    with pytest.raises(ValueError, match="unknown algorithm"):
        rt.driver("nope", rt.DriverConfig(), _loss, device="cpu")
    with pytest.raises(ValueError, match="analog-section"):
        rt.driver("discrete", rt.DriverConfig(tau_hp=5.0), _loss,
                  device="cpu")
    with pytest.raises(ValueError, match="discrete-section"):
        rt.driver("analog", rt.DriverConfig(mode="central"), _loss,
                  device="cpu")


def test_samplers_shapes_balance_and_determinism():
    sample = _nist_sampler(512)
    a, b = sample(3), sample(3)
    assert a["x"].shape == (512, 49) and a["y"].shape == (512, 4)
    assert torch.equal(a["x"], b["x"])              # keyed on (seed, index)
    assert not torch.equal(a["x"], sample(4)["x"])
    counts = a["y"].sum(0)
    assert counts.min() > 512 / 4 * 0.7             # all four letters drawn
    x, y = tasks.xor_dataset(device="cpu")
    ds = pipeline.dataset_sampler(x, y, 3)
    assert torch.equal(ds(1)["x"], x[torch.tensor([3, 0, 1])])
    assert pipeline.dataset_sampler(x, y, 4)(7)["x"] is x


def test_convert_roundtrip_is_exact():
    rng = np.random.default_rng(0)
    tree = [{"w": rng.standard_normal((49, 4)).astype(np.float32),
             "b": rng.standard_normal((4,)).astype(np.float32)}]
    back = convert.to_numpy(convert.to_torch(tree, device="cpu"))
    np.testing.assert_array_equal(back[0]["w"], tree[0]["w"])
    np.testing.assert_array_equal(back[0]["b"], tree[0]["b"])
    assert rt.mlp_init(3, (2, 2, 1), device="cpu")[0]["w"].dtype \
        == torch.float32


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_never_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_import_without_nvcc_or_jax():
    """Importing the package builds nothing and pulls in no JAX; run in a
    fresh interpreter whose PATH holds no nvcc."""
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=str(REPO / "src"))
    code = ("import sys, repro_torch, repro_torch.kernels, "
            "repro_torch.convert, repro_torch.data\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._LIBS\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
