"""The paper's CNNs, layers and backprop baseline against the JAX package's.

Both packages get the same numpy parameters (the reference's init,
carried by ``convert``) and the same batches (the samplers are bitwise
in labels and shifts, ``tests/test_torch_data.py``; the MGD tests hand
the port the reference's own arrays, the backprop tests its own sampler).  Tolerances, each measured on an x86-64
CPU (torch 2.13, jax 0.9.0):

* layers and CNN forward: ``FWD_ATOL`` = 1e-5 (measured ≤ 1.7e-6 at
  outputs of |y| ≈ 3; torch's and XLA's convolutions sum in other
  orders);
* 8 unfused MGD steps a CNN (batch 4, Table 2's Δθ and η, forward mode):
  C̃ ``CT_ATOL`` = 5e-6 (measured ≤ 1.4e-6), cost ``COST_ATOL`` = 1e-5
  (≤ 3.3e-6), params ``PARAM_ATOL`` = 2e-6 (≤ 3.0e-7);
* ``train_backprop``: the cost of each chunk's last step
  ``BP_COST_ATOL`` = 1e-6 (measured ≤ 3.0e-8), params 2e-6 (≤ 2.4e-7);
* ``sgd_step``, ``linear_apply`` on dyadic values and the parameter
  counts: bitwise.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro
from repro.core import MGDConfig, mse as jmse
from repro.data import pipeline as jpipeline
from repro.data import tasks as jtasks
from repro.models import layers as jlayers
from repro.models import simple as jsimple
from repro.optim import sgd_step as jsgd_step
from repro.training.train_loop import classification_accuracy as jacc
from repro.training.train_loop import train_backprop as jtrain_backprop
import repro_torch as rt
from repro_torch import convert
from repro_torch.benchmarks import common as tcommon
from repro_torch.core import rng
from repro_torch.core.utils import tree_leaves
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import tasks as ttasks
from repro_torch.models import layers as tlayers
from repro_torch.models import simple as tsimple

FWD_ATOL = 1e-5
CT_ATOL = 5e-6
COST_ATOL = 1e-5
PARAM_ATOL = 2e-6
BP_COST_ATOL = 1e-6

# name: (reference init, apply; port init, apply; reference batch, port
# batch; Table 2's η; sampler seed; parameters per EXPERIMENTS.md §Paper)
CNNS = {
    "fashion": (jsimple.fashion_cnn_init, jsimple.fashion_cnn_apply,
                tsimple.fashion_cnn_init, tsimple.fashion_cnn_apply,
                jtasks.fashion_batch, ttasks.fashion_batch, 1e-4, 3, 20490),
    "cifar": (jsimple.cifar_cnn_init, jsimple.cifar_cnn_apply,
              tsimple.cifar_cnn_init, tsimple.cifar_cnn_apply,
              jtasks.cifar_batch, ttasks.cifar_batch, 5e-5, 4, 26154),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_gap(jtree, ttree):
    return max(np.abs(np.asarray(a) - b.detach().numpy()).max()
               for a, b in zip(jax.tree_util.tree_leaves(jtree),
                               tree_leaves(ttree)))


@pytest.mark.parametrize("name", sorted(CNNS))
def test_cnn_parameter_counts_and_layout(name):
    jinit, _, tinit, *_, count = CNNS[name]
    jp = jinit(jax.random.PRNGKey(0))
    tp = tinit(0, device="cpu")
    assert sum(int(v.size) for v in jax.tree_util.tree_leaves(jp)) == count
    assert sum(v.numel() for v in tree_leaves(tp)) == count
    # HWIO convs and the fc head, leaf for leaf in the reference's order
    assert [tuple(v.shape) for v in tree_leaves(tp)] == \
        [tuple(v.shape) for v in jax.tree_util.tree_leaves(jp)]
    assert all(v.dtype == torch.float32 for v in tree_leaves(tp))
    again = tinit(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp),
                                                 tree_leaves(again)))


@pytest.mark.parametrize("name", sorted(CNNS))
def test_convert_carries_the_cnn_tree(name):
    """Both ways, bitwise, with the reference's tree structure and dict
    key order (jax's: keys sorted, so "b" before "w", "convs" before
    "fc"; a converted tree flattens in the reference's leaf order)."""
    jinit = CNNS[name][0]
    jp = jinit(jax.random.PRNGKey(1))
    tp = convert.to_torch(jp, device="cpu")
    assert list(tp) == ["convs", "fc"]
    assert all(list(c) == ["b", "w"] for c in tp["convs"])
    assert list(tp["fc"]) == ["b", "w"]
    assert list(jax.tree_util.tree_map(lambda x: x, jp)["fc"]) == ["b", "w"]
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    back = convert.to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))
    bf = convert.to_numpy(convert.to_torch(
        jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp),
        device="cpu"))
    assert jax.tree_util.tree_leaves(bf)[0].dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("name", sorted(CNNS))
def test_cnn_forward_matches_reference(name):
    jinit, japply, _, tapply, jbatch, *_ = CNNS[name]
    jp = jinit(jax.random.PRNGKey(0))
    x, _ = jbatch(jax.random.PRNGKey(5), 4)
    want = np.asarray(japply(jp, x))
    got = tapply(convert.to_torch(jp, device="cpu"), _t(x))
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("hw,c_in,c_out,stride,padding", [
    ((7, 9), 2, 3, 1, "SAME"), ((8, 8), 3, 5, 2, "SAME"),
    ((9, 6), 1, 4, 2, "SAME"), ((7, 7), 2, 3, 1, "VALID"),
])
def test_conv2d_matches_reference(hw, c_in, c_out, stride, padding):
    rs = np.random.default_rng(0)
    w = rs.standard_normal((3, 3, c_in, c_out)).astype(np.float32)
    b = rs.standard_normal((c_out,)).astype(np.float32)
    x = rs.standard_normal((2, *hw, c_in)).astype(np.float32)
    want = np.asarray(jlayers.conv2d(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
        stride=stride, padding=padding))
    got = tlayers.conv2d({"w": _t(w), "b": _t(b)}, _t(x), stride=stride,
                         padding=padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


def test_conv2d_runs_cudnn_full_f32_and_deterministic(monkeypatch):
    """Forward and both gradients of ``conv2d`` run with cuDNN's TF32 off
    and its algorithms deterministic, and the caller's flags come back."""
    import torch.nn.functional as F
    cudnn = torch.backends.cudnn
    seen = []

    def record(f):
        def call(*a, **kw):
            seen.append((f.__name__, cudnn.allow_tf32, cudnn.deterministic))
            return f(*a, **kw)
        return call

    monkeypatch.setattr(F, "conv2d", record(F.conv2d))
    for name in ("conv2d_input", "conv2d_weight"):
        monkeypatch.setattr(torch.nn.grad, name,
                            record(getattr(torch.nn.grad, name)))
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    w = torch.ones(3, 3, 2, 4, requires_grad=True)
    x = torch.ones(1, 5, 5, 2, requires_grad=True)
    tlayers.conv2d({"w": w, "b": torch.zeros(4)}, x).sum().backward()
    assert sorted(seen) == [("conv2d", False, True),
                            ("conv2d_input", False, True),
                            ("conv2d_weight", False, True)]
    assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)


@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (5, 9)])
def test_maxpool2_matches_reference(hw):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jlayers.maxpool2(jnp.asarray(x)))
    got = tlayers.maxpool2(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_layernorm_matches_reference():
    rs = np.random.default_rng(2)
    x = rs.standard_normal((3, 5, 16)).astype(np.float32) * 3 + 1
    p = {"scale": rs.standard_normal(16).astype(np.float32),
         "bias": rs.standard_normal(16).astype(np.float32)}
    want = np.asarray(jlayers.layernorm(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x)))
    got = tlayers.layernorm({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)
    init = tlayers.layernorm_init(16, device="cpu")
    assert torch.equal(init["scale"], torch.ones(16))
    assert torch.equal(init["bias"], torch.zeros(16))


def test_linear_apply_bitwise_on_dyadic_params():
    rs = np.random.default_rng(3)
    sizes = (16, 8, 8, 4)
    params = [{"w": (rs.integers(-8, 9, (a, b)) / 8).astype(np.float32),
               "b": (rs.integers(-8, 9, (b,)) / 4).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    x = rs.integers(0, 2, (32, 16)).astype(np.float32)
    want = np.asarray(jsimple.linear_apply(
        jax.tree_util.tree_map(jnp.asarray, params), x))
    got = tsimple.linear_apply(convert.to_torch(params, device="cpu"), _t(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CNNS))
def test_unfused_mgd_tracks_reference(name):
    """8 steps of Table 2's config (forward mode, the reference's default;
    θ̃ materialized), batch 4, the reference's batches."""
    jinit, japply, _, tapply, jbatch, _, eta, sseed, _ = CNNS[name]
    jp = jinit(jax.random.PRNGKey(0))
    tp = convert.to_torch(jp, device="cpu")
    jdrv = repro.driver("discrete", MGDConfig(dtheta=1e-3, eta=eta, seed=1),
                        lambda p, b: jmse(japply(p, b["x"]), b["y"]))
    tdrv = rt.driver("discrete", rt.DriverConfig(dtheta=1e-3, eta=eta,
                                                 seed=1),
                     lambda p, b: rt.mse(tapply(p, b["x"]), b["y"]),
                     device="cpu")
    sample = jpipeline.generator_sampler(jbatch, 4, seed=sseed)
    jstate, tstate = jdrv.init(jp), tdrv.init(tp)
    jstep = jax.jit(jdrv.step)
    for i in range(8):
        batch = sample(i)
        jp, jstate, ja = jstep(jp, jstate, batch)
        tp, tstate, ta = tdrv.step(tp, tstate, {k: _t(v)
                                                for k, v in batch.items()})
        assert abs(float(ja["c_tilde"]) - float(ta["c_tilde"])) <= CT_ATOL
        assert abs(float(ja["cost"]) - float(ta["cost"])) <= COST_ATOL
        assert _max_gap(jp, tp) <= PARAM_ATOL
    assert tstate.step == 8


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_step_bitwise(momentum):
    rs = np.random.default_rng(4)
    params = {"a": rs.standard_normal((5, 3)).astype(np.float32),
              "h": rs.standard_normal((7,)).astype(ml_dtypes.bfloat16)}
    grads = {"a": rs.standard_normal((5, 3)).astype(np.float32),
             "h": rs.standard_normal((7,)).astype(ml_dtypes.bfloat16)}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
    tparams = convert.to_torch(params, device="cpu")
    tgrads = convert.to_torch(grads, device="cpu")
    jstate = {"m": jax.tree_util.tree_map(
        lambda x: jnp.ones(x.shape, jnp.float32) * 0.5, jparams)} \
        if momentum else {}
    tstate = {"m": {k: torch.full(v.shape, 0.5) for k, v in tparams.items()}
              } if momentum else {}
    if momentum:
        assert rt.sgd_init(tparams, momentum)["m"]["h"].dtype == torch.float32
    else:
        assert rt.sgd_init(tparams) == {}
    for _ in range(3):
        jparams, jstate = jsgd_step(jparams, jgrads, jstate, eta=0.37,
                                    momentum=momentum)
        tparams, tstate = rt.sgd_step(tparams, tgrads, tstate, eta=0.37,
                                      momentum=momentum)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(convert.to_numpy(tparams))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      b.view(np.uint8))


@pytest.mark.parametrize("model", ["nist_mlp", "fashion_cnn"])
def test_train_backprop_tracks_reference(model):
    if model == "nist_mlp":
        jp0 = jsimple.mlp_init(jax.random.PRNGKey(2), (49, 4, 4))
        japply, tapply = jsimple.mlp_apply, rt.mlp_apply
        jbatch, tbatch, batch, steps, chunk, eta = (
            jtasks.nist7x7_batch, ttasks.nist7x7_batch, 8, 200, 50, 1.0)
    else:
        jp0 = jsimple.fashion_cnn_init(jax.random.PRNGKey(0))
        japply, tapply = jsimple.fashion_cnn_apply, rt.fashion_cnn_apply
        jbatch, tbatch, batch, steps, chunk, eta = (
            jtasks.fashion_batch, ttasks.fashion_batch, 4, 16, 8, 0.02)
    jres = jtrain_backprop(lambda p, b: jmse(japply(p, b["x"]), b["y"]),
                           jp0, jpipeline.generator_sampler(jbatch, batch,
                                                            seed=7),
                           steps, eta=eta, chunk=chunk, log=None)
    # the port's own sampler: its labels and shifts are the reference's
    tres = rt.train_backprop(
        lambda p, b: rt.mse(tapply(p, b["x"]), b["y"]),
        convert.to_torch(jp0, device="cpu"),
        tpipeline.generator_sampler(tbatch, batch, seed=7, device="cpu"),
        steps, eta=eta, chunk=chunk, log=None)
    assert [s for s, _ in tres.history] == [s for s, _ in jres.history] == \
        list(range(chunk, steps + 1, chunk))
    for (_, a), (_, b) in zip(jres.history, tres.history):
        assert abs(a["cost"] - b["cost"]) <= BP_COST_ATOL
    assert _max_gap(jres.params, tres.params) <= PARAM_ATOL
    assert tres.steps_done == steps and tres.state == {}
    assert all(not v.requires_grad for v in tree_leaves(tres.params))


def test_train_backprop_runs_whole_chunks_and_evaluates():
    x, y = ttasks.xor_dataset(device="cpu")
    params = rt.mlp_init(0, (2, 2, 1), device="cpu")
    logs = []
    res = rt.train_backprop(
        lambda p, b: rt.mse(rt.mlp_apply(p, b["x"]), b["y"]), params,
        tpipeline.dataset_sampler(x, y, 4), 10, eta=2.0, momentum=0.5,
        chunk=4, eval_fn=lambda p: {"acc": rt.classification_accuracy(
            rt.mlp_apply, p, x, torch.cat([1 - y, y], 1))}, eval_every=4,
        log=logs.append)
    assert res.steps_done == 12 and [s for s, _ in res.history] == [4, 8, 12]
    assert "acc" in res.history[0][1] and len(logs) == 3
    assert set(res.state) == {"m"}


def test_classification_accuracy_matches_reference():
    rs = np.random.default_rng(5)
    x = rs.standard_normal((64, 49)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.integers(0, 4, 64)]
    jp = jsimple.mlp_init(jax.random.PRNGKey(2), (49, 4, 4))
    want = float(jacc(jsimple.mlp_apply, jp, jnp.asarray(x), jnp.asarray(y)))
    got = rt.classification_accuracy(rt.mlp_apply,
                                     convert.to_torch(jp, device="cpu"),
                                     _t(x), _t(y))
    assert got.dtype == torch.float32 and float(got) == want


def test_xor_mgd_tracks_backprop():
    """The port's twin of tests/test_paper_experiments.py's: from the
    reference's inits of seeds (1, 2, 5), MGD (Δθ = 1e-2, η = 1, τ_θ = τ_x
    = 1, batch 4) and backprop (η = 2) both solve XOR (median MSE < 0.04).
    Budgets cut to fit the CPU test tier: 1500 MGD and 1000 backprop
    steps, by which the reference under jax 0.9.0 has solved every seed
    (MSE 0.016, 0.004, 0.005 and 0.004, 0.003, 0.003; its own test runs
    20000 and 2000)."""
    x, y = ttasks.xor_dataset(device="cpu")
    sample = tpipeline.dataset_sampler(x, y, 4)
    cfg = rt.DriverConfig(dtheta=1e-2, eta=1.0, tau_theta=1, tau_x=1, seed=0)
    finals_mgd, finals_bp = [], []
    for seed in (1, 2, 5):
        p0 = convert.to_torch(jsimple.mlp_init(jax.random.PRNGKey(seed),
                                               (2, 2, 1)), device="cpu")
        p_mgd, steps, _ = tcommon.train_until(
            tcommon.xor_loss, p0, cfg, sample, max_steps=1500,
            threshold_fn=lambda p: False, chunk=500, device="cpu")
        assert steps == 1500
        res = rt.train_backprop(tcommon.xor_loss, p0, sample, 1000, eta=2.0,
                                log=None)
        finals_mgd.append(tcommon.xor_mse(p_mgd))
        finals_bp.append(tcommon.xor_mse(res.params))
    assert sorted(finals_mgd)[1] < 0.04, finals_mgd
    assert sorted(finals_bp)[1] < 0.04, finals_bp


def test_front_door_names():
    assert rt.train is rt.train_mgd and rt.api.train is rt.train_mgd
    assert rt.register_driver is rt.api.register_driver
    state = rt.replace_step(rt.mgd_init(rt.mlp_init(0, (2, 2, 1),
                                                    device="cpu"),
                                        rt.MGDConfig()), 7)
    assert rt.state_step(state) == 7
    for name in ("fashion_cnn_init", "cifar_cnn_apply", "linear_apply",
                 "train_backprop", "classification_accuracy", "sgd_step",
                 "generator_sampler", "tasks"):
        assert name in rt.__all__ and hasattr(rt, name)


def test_new_entry_points_raise_without_a_card(monkeypatch):
    """Nothing falls back to the CPU: with no card and no device='cpu',
    the CNN inits, the image and LM batches and samplers raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: rt.cnn_init(0, in_hw=8, in_ch=1, channels=(2,),
                                     n_classes=3, head_pool=4),
                 lambda: rt.fashion_cnn_init(0), lambda: rt.cifar_cnn_init(0),
                 lambda: ttasks.fashion_batch(rng.prng_key(0), 2),
                 lambda: ttasks.cifar_batch(rng.prng_key(0), 2),
                 lambda: ttasks.nist7x7_batch(rng.prng_key(0), 2),
                 lambda: ttasks.lm_batch(rng.prng_key(0), 2, 4, 10),
                 lambda: tpipeline.generator_sampler(ttasks.cifar_batch, 2),
                 lambda: rt.lm_sampler(2, 4, 10),
                 lambda: tcommon.xor_setup(0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

