"""The port's distribution on real multi-rank worlds: gloo processes on
the CPU, each rank a process (``tests/torch_dist_worker.py``), meeting in
a ``FileStore`` under ``tmp_path`` (no network port).  Each world runs
once per module; the reference's multi-device runs come from one JAX
subprocess with virtual CPU devices, started beside it.

Tolerances:

* bitwise: signs on shards (every ptype, ``generate``,
  ``generate_signs_only``, ``perturbed_tree`` on the qwen3 smoke tree
  placed by ``param_shardings`` on a (2, 4) mesh); probe pods as ranks
  against ``LocalMesh`` (fused and unfused, pod 4 and pod 2 × data 2);
  elastic restore ((2, 4) → (4, 2) and → no mesh, and the files byte
  for byte an unsharded save's); the sharded update given the same C̃;
* the sharded MGD step (the reference test's smoke model, d_model 64,
  heads 4/4, d_head 16, vocab 128, batch 4 × 32, Δθ = 1e-2, η = 0.1):
  C̃ from the same state within 1e-5 of the cost, and the first 4 steps
  within the transformer tests' 1e-2 (C̃) / 2e-2 (params) of the
  unsharded run; 30 steps finite.  Row-sharded weights' partial sums
  round apart, and this configuration diverges (the cost goes 5.5 → 20
  in one step at homodyne gain η/Δθ = 10), so rounding differences grow
  ~10× a step: later steps are held finite only;
* the dense family's smoke models (every dense arch id, f32) on the
  mesh: loss within 1e-5 relative, prefill logits and two decode steps
  within 1e-5 of the unsharded model;
* MoE (llama4-scout), MLA (deepseek-v3) and the recurrent families
  (rwkv6, zamba2), smoke models in f32 on the mesh (llama4-scout also
  under ``MOE_EP_RULES``): loss, prefill logits and two decode steps
  within 1e-5 relative (of max(|logit|, 1)), one unfused MGD step's C̃
  within 1e-5 of the cost;
* the fused step on (2, 4) and (4, 2) meshes (central, forward, replay;
  weights split by columns and by rows): C̃ within 1e-5 of the cost of
  the unsharded fused step's, bitwise the unfused step on the same mesh
  (params and C̃), and the fused update given the same C̃ bitwise the
  unsharded one; with every weight also split over the batch's axis
  (``fsdp``), the product gathers W's block over that axis and keeps the
  batch split;
* pods as ranks against the reference's 4-device runs: C̃ 1e-6 and
  params 2e-4, the MLP's cross-framework tolerances (as
  ``tests/test_torch_probe_parallel.py``); pod 0's cost 1e-5;
* pipeline: within 1e-5 of the stages run one after another;
* the four-card slice at smoke size on (2, 2) (qwen2-72b with
  ``fsdp=True`` under the default rules, llama4-scout under
  ``MOE_EP_RULES``): the sharded init bitwise ``device_put`` of the whole
  init; the fused central step (Δθ = 1e-3, η = 1e-2) from the
  reference's params against the reference's unsharded fused step, step
  0's C̃ within 1e-6 of the cost, 3 steps within 1e-2 / 2e-2;
* llama4-scout's smoke config in bf16 under ``MOE_EP_RULES`` on (2, 2),
  module by module against the unsharded port: no dense product a
  pending partial sum, every module within one bf16 ulp, the loss and
  steps 0-1's C̃ and cost within 2⁻¹¹ of the cost.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro import core as jcore
from repro.configs import get_smoke_config as jsmoke
from repro.models import transformer as jt
from repro.models.simple import mlp_init as jmlp_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
CT_ATOL, PARAM_ATOL, COST_ATOL = 1e-6, 2e-4, 1e-5
CT_RUN_ATOL, PARAM_RUN_ATOL, GATED_STEPS = 1e-2, 2e-2, 4

REFERENCE = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro
from repro.core import mse
from repro.models.simple import make_mlp_probe_fn, mlp_apply, mlp_init

inp = np.load(sys.argv[1])
p0 = [{"b": jnp.asarray(inp["b0"]), "w": jnp.asarray(inp["w0"])},
      {"b": jnp.asarray(inp["b1"]), "w": jnp.asarray(inp["w1"])}]
batch = {"x": jnp.asarray(inp["x"]), "y": jnp.asarray(inp["y"])}
out = {}


def loss(p, b):
    return mse(mlp_apply(p, b["x"]), b["y"])


for name, shape, axes, data in (("pod4", (4,), ("pod",), None),
                                ("pod2data2", (2, 2), ("pod", "data"),
                                 "data")):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), axes)
    for fused in (False, True):
        cfg = repro.DriverConfig(dtheta=1e-2, eta=0.5, mode="central",
                                 seed=3, fused=fused)
        kw = dict(probe_fn=make_mlp_probe_fn()) if fused else {}
        drv = repro.driver("probe_parallel", cfg, loss, mesh=mesh,
                           data_axis=data, **kw)
        p, s = p0, drv.init(p0)
        cts, costs, ps = [], [], []
        for _ in range(36):
            p, s, aux = drv.step(p, s, batch)
            cts.append(float(aux["c_tilde"]))
            costs.append(float(aux["cost"]))
            ps.append(np.concatenate([np.asarray(x).ravel()
                                      for x in jax.tree_util.tree_leaves(p)]))
        key = f"{name}/{fused}"
        out[key + "/c_tilde"] = np.array(cts, np.float32)
        out[key + "/cost"] = np.array(costs, np.float32)
        out[key + "/params"] = np.stack(ps)
np.savez(sys.argv[2], **out)
'''


# the four-card slice's configs at smoke size (fsdp=True, as the full
# configs have) on the (2, 2) mesh: qwen2-72b under the default rules,
# llama4-scout under MOE_EP_RULES (the worker's SLICE)
SLICE = ("qwen2-72b", "llama4-scout-17b-a16e")
SLICE_STEPS = 3
SLICE_CT_REL = 1e-6          # step 0's C̃, of the cost
SLICE_RUN_ATOL = (1e-2, 2e-2)  # C̃, params over the steps
# the bf16 module-by-module comparison (the worker's ``bf16_modules``)
BF16_ARCH = "llama4-scout-17b-a16e"
BF16_MODULE_ULPS = 1.0       # a module's output: the rounding of one product
BF16_GATE_REL = 2.0 ** -11   # loss, C̃, cost: the cards' gate, of the cost


def _slice_reference_params(arch, dtype="float32"):
    """The reference's smoke params (seed 0), leaves in tree order."""
    jcfg = jsmoke(arch).replace(fsdp=True, dtype=dtype)
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jt.model_init(jcfg, jax.random.PRNGKey(0)))]


def _slice_reference_steps(arch, leaves, tokens):
    """The reference's unsharded fused central steps (the dry run's Δθ =
    1e-3, η = 1e-2; its kernels in interpret mode for the dense model)
    from those params: C̃, cost and flat params of each step."""
    jcfg = jsmoke(arch).replace(fsdp=True)
    treedef = jax.tree_util.tree_structure(
        jt.model_init(jcfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in leaves])
    mc = jcore.MGDConfig(dtheta=1e-3, eta=1e-2, mode="central", fused=True,
                         kernel_impl="interpret")
    step = jax.jit(jcore.build_mgd_step(
        lambda p, b: jt.model_loss(p, jcfg, b), mc,
        probe_fn=jt.make_transformer_probe_fn(jcfg)))
    state = jcore.mgd_init(params, mc)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    rec = {"c_tilde": [], "cost": [], "params": []}
    for _ in range(SLICE_STEPS):
        params, state, m = step(params, state, batch)
        rec["c_tilde"].append(float(m["c_tilde"]))
        rec["cost"].append(float(m["cost"]))
        rec["params"].append(np.concatenate(
            [np.asarray(a, np.float32).ravel()
             for a in jax.tree_util.tree_leaves(params)]))
    return rec


def _start_world(scenario, world, d):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(r), str(world), str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _finish(procs, d, timeout=600):
    errs = []
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=timeout)
        if p.returncode:
            errs.append(f"rank {r} rc {p.returncode}:\n{err[-3000:]}")
    assert not errs, "\n".join(errs)
    return torch.load(os.path.join(d, "out.pt"), weights_only=False)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh8")
    return _finish(_start_world("mesh8", 8, d), d), d


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh4")
    p = jmlp_init(jax.random.PRNGKey(0), (2, 2, 1))
    x = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
    y = np.array([[0.], [1.], [1.], [0.]], np.float32)
    inputs = dict(
        w0=np.asarray(p[0]["w"]), b0=np.asarray(p[0]["b"]),
        w1=np.asarray(p[1]["w"]), b1=np.asarray(p[1]["b"]),
        x=x.reshape(4, 1, 2), y=y.reshape(4, 1, 1),
        # the reference pipeline test's inputs
        ws=np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 8, 8))
                      * 0.3),
        px=np.asarray(jax.random.normal(jax.random.PRNGKey(1), (16, 8))))
    slice_params = {arch: _slice_reference_params(arch) for arch in SLICE}
    for arch, leaves in slice_params.items():
        inputs.update({f"{arch}/leaf{i}": a for i, a in enumerate(leaves)})
        inputs[f"{arch}/tokens"] = np.random.default_rng(2).integers(
            0, jsmoke(arch).vocab, (4, 16)).astype(np.int32)
    # llama4-scout's bf16 init, bf16 leaves as their 16-bit patterns
    inputs.update({f"{BF16_ARCH}/bf16/leaf{i}": a.view(np.uint16)
                   if a.dtype.name == "bfloat16" else a for i, a in
                   enumerate(_slice_reference_params(BF16_ARCH, "bfloat16"))})
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(d / "inputs.npz"), str(d / "ref.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = _start_world("mesh4", 4, d)
    # the reference's unsharded fused steps, while the world runs
    slice_ref = {arch: _slice_reference_steps(arch, slice_params[arch],
                                              inputs[f"{arch}/tokens"])
                 for arch in SLICE}
    out = _finish(procs, d)
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    ref_out = dict(np.load(d / "ref.npz"))
    ref_out["slice"] = slice_ref
    return out, ref_out, inputs


# --- signs on shards ---------------------------------------------------------


@pytest.mark.parametrize("what", [
    "generate/rademacher", "generate/walsh", "generate/sequential",
    "generate/sinusoidal", "signs_only", "perturbed_tree/1.0",
    "perturbed_tree/-1.0"])
def test_signs_on_shards_are_the_unsharded_signs(world8, what):
    out, _ = world8
    assert out["signs_n_sharded"] > 0
    assert out["signs"][what]


# --- the dense family on the mesh --------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-14b", "mistral-nemo-12b",
                                  "granite-34b", "qwen2-72b", "qwen2-vl-2b",
                                  "musicgen-medium"])
def test_dense_family_runs_sharded(world8, arch):
    rec = world8[0]["dense"][arch]
    assert abs(rec["loss"] - rec["loss_ref"]) <= 1e-5 * abs(rec["loss_ref"])
    assert rec["prefill"] <= 1e-5
    if arch != "qwen2-vl-2b":          # embeds-only: no token decode
        assert rec["decode"] <= 1e-5


# --- the sharded MGD step -----------------------------------------------------


def test_sharded_step_c_tilde_from_the_same_state(world8):
    st = world8[0]["step"]
    assert st["n_sharded"] > 0
    ref, got = st["ref"], st["got"]
    assert abs(got["c_tilde"][0] - ref["c_tilde"][0]) \
        <= 1e-5 * abs(ref["cost"][0])
    assert abs(got["cost"][0] - ref["cost"][0]) <= 1e-5 * abs(ref["cost"][0])


def test_sharded_update_given_the_same_c_tilde_is_bitwise(world8):
    assert world8[0]["step"]["update_bitwise"]


def test_sharded_step_tracks_unsharded_run(world8):
    st = world8[0]["step"]
    ref, got = st["ref"], st["got"]
    assert len(got["cost"]) == 30
    assert all(np.isfinite(got["cost"])) and all(np.isfinite(got["c_tilde"]))
    assert all(bool(torch.isfinite(p).all()) for p in got["params"])
    for i in range(GATED_STEPS):
        assert abs(got["c_tilde"][i] - ref["c_tilde"][i]) <= CT_RUN_ATOL, i
        assert float((got["params"][i] - ref["params"][i]).abs().max()) \
            <= PARAM_RUN_ATOL, i


# --- elastic restore ----------------------------------------------------------


def test_elastic_restore_across_meshes(world8):
    el = world8[0]["elastic"]
    assert el["onto_4x2"] and el["onto_none"] and el["plain_leaves"]
    assert el["step"] == 3
    assert el["placements_4x2"][0] == "(Shard(dim=1), Shard(dim=0))"


def test_sharded_save_writes_an_unsharded_saves_bytes(world8):
    d = world8[1]
    a, b = d / "sharded" / f"step_{3:012d}", d / "plain" / f"step_{3:012d}"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


# --- probe pods as ranks --------------------------------------------------------


CASES = ["pod4/False", "pod4/True", "pod2data2/False", "pod2data2/True"]


@pytest.mark.parametrize("case", CASES)
def test_pods_as_ranks_bitwise_local_mesh(world4, case):
    ranks, local = world4[0][case]
    assert ranks["c_tilde"] == local["c_tilde"]
    assert ranks["cost"] == local["cost"]
    assert all(torch.equal(a, b) for a, b in zip(ranks["params"],
                                                 local["params"]))


@pytest.mark.parametrize("case", CASES)
def test_pods_as_ranks_track_the_references_mesh(world4, case):
    ranks = world4[0][case][0]
    ref = world4[1]
    np.testing.assert_allclose(np.array(ranks["c_tilde"], np.float32),
                               ref[case + "/c_tilde"], rtol=0, atol=CT_ATOL)
    np.testing.assert_allclose(np.array(ranks["cost"], np.float32),
                               ref[case + "/cost"], rtol=0, atol=COST_ATOL)
    np.testing.assert_allclose(torch.stack(ranks["params"]).numpy(),
                               ref[case + "/params"], rtol=0,
                               atol=PARAM_ATOL)


def test_pods_as_ranks_take_param_specs_on_the_unfused_path(world4):
    """(pod 2, model 2), XOR, unfused, ``param_specs=[("w$", (None,
    "model"))]``: the first layer's W lives as column shards on the
    "model" ranks and the loss runs on DTensors; C̃ and the params track
    LocalMesh(pod=2)'s within the MLP's 1e-6 / 2e-4."""
    ranks, local = world4[0]["pod2model2_param_specs/False"]
    assert ranks["sharded_leaves"] >= 1 and local["sharded_leaves"] == 0
    np.testing.assert_allclose(ranks["c_tilde"], local["c_tilde"], rtol=0,
                               atol=CT_ATOL)
    np.testing.assert_allclose(torch.stack(ranks["params"]).numpy(),
                               torch.stack(local["params"]).numpy(), rtol=0,
                               atol=PARAM_ATOL)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v3-671b", "rwkv6-7b",
                                  "zamba2-7b",
                                  "llama4-scout-17b-a16e/moe_ep"])
def test_moe_mla_and_recurrent_families_run_sharded(world8, arch):
    rec = world8[0]["families"][arch]
    assert rec["sharded"] > 0
    for key in ("loss", "prefill", "decode", "c_tilde"):
        assert rec[key] <= 1e-5, (key, rec[key])


@pytest.mark.parametrize("case", [f"{m}/{k}" for m in ("2x4", "4x2")
                                  for k in ("central", "forward", "replay")]
                         + ["2x4/central_fsdp"])
def test_fused_step_on_the_mesh(world8, case):
    rec = world8[0]["fused"][case]
    assert rec["cols"] > 0 and rec["rows"] > 0
    assert rec.get("gathers", True)
    assert rec["c_tilde"] <= 1e-5
    assert rec["fused_is_unfused"]
    assert rec.get("update_bitwise", True)


def test_fused_pods_as_ranks_take_param_specs(world4):
    """(pod 2, model 2), XOR, fused: the first layer's W as column shards
    on the "model" ranks, its probes through the pair kernel's plain
    version on the shards and its update through the window update's;
    bitwise LocalMesh(pod=2)'s run, as the unsharded pods are."""
    ranks, local = world4[0]["pod2model2_param_specs/True"]
    assert ranks["sharded_leaves"] >= 1 and local["sharded_leaves"] == 0
    assert ranks["c_tilde"] == local["c_tilde"]
    assert all(torch.equal(a, b) for a, b in zip(ranks["params"],
                                                 local["params"]))


def test_pipeline_forward_exact(world4):
    out, _, inputs = world4
    ref = torch.tensor(inputs["px"])
    for i in range(4):
        ref = torch.tanh(ref @ torch.tensor(inputs["ws"][i]))
    assert tuple(out["pipeline"].shape) == (16, 8)
    assert float((out["pipeline"] - ref).abs().max()) <= 1e-5


# --- the four-card slice at smoke size -----------------------------------------


@pytest.mark.parametrize("arch", SLICE)
def test_sharded_init_is_device_put_of_the_whole_init(world4, arch):
    """``model_init(..., shardings=param_shardings)`` on the (2, 2) gloo
    mesh (qwen2-72b under the default rules, llama4-scout under
    ``MOE_EP_RULES``): placements, local shards and global values bitwise
    ``device_put(model_init(..., device="cpu"))``."""
    rec = world4[0]["sharded_init"][arch]
    assert rec["sharded"] > 0 and rec["bitwise"], rec


@pytest.mark.parametrize("arch", SLICE)
def test_slice_step_on_the_mesh_tracks_the_references(world4, arch):
    """The fused central step on (2, 2) from the reference's params and
    batch, against the reference's unsharded fused step: step 0's C̃
    and cost within 1e-6 of the cost, and every step's C̃ and params
    within the transformer's 1e-2 / 2e-2.  Measured on an 8-core Xeon:
    step 0's C̃ 4.5e-8 (qwen2-72b) and 8.7e-8 (llama4-scout) of the cost;
    over the 3 steps C̃ 1.2e-6 / 2.1e-4 and params 1.7e-5 / 2.2e-3
    (llama4-scout's cost goes 5.45 → 13.75 in one step at η/Δθ = 10, and
    its gap grows with it)."""
    got = world4[0]["slice_steps"][arch]
    ref = world4[1]["slice"][arch]
    assert got["sharded"] > 0
    cost = abs(ref["cost"][0])
    assert abs(got["c_tilde"][0] - ref["c_tilde"][0]) <= SLICE_CT_REL * cost
    assert abs(got["cost"][0] - ref["cost"][0]) <= SLICE_CT_REL * cost
    for i in range(SLICE_STEPS):
        assert abs(got["c_tilde"][i] - ref["c_tilde"][i]) \
            <= SLICE_RUN_ATOL[0], i
        np.testing.assert_allclose(got["params"][i].numpy(),
                                   ref["params"][i], rtol=0,
                                   atol=SLICE_RUN_ATOL[1])


def test_bf16_moe_ep_mesh_module_by_module(world4):
    """llama4-scout's smoke config (``fsdp=True``) in bf16 under
    ``MOE_EP_RULES`` on the (2, 2) gloo mesh against the unsharded port,
    from the reference's bf16 init, 2 × 16 tokens, the unsharded run
    routed as the mesh's (ROADMAP C9).  The rules give "model" to "fsdp"
    for the dense weights and split the expert banks' d / f over "data",
    and the reference's program gathers those weights (its dry run on a
    fake (2, 2) world all-gathers each dense W over all four devices and
    each bank over "data"); a partial product reduced over the split
    would round every product twice in bf16.  So no dense product may be
    a pending ``Partial`` sum, every module's output (each attention
    projection, the router's logits, the shared expert, the MoE output,
    each block, the logits) lies within one bf16 ulp of its largest
    value of the unsharded port's, and the loss at θ₀ and the fused
    central step's C̃ and cost at steps 0 and 1 (step 1 taken by both
    from the mesh's θ₁) within 2⁻¹¹ of the cost.  Measured on this CPU:
    every module bitwise, the loss 4.8e-7 and step 0's C̃ 2.4e-7 apart,
    step 1 bitwise.  Before the repair the dense products under these
    rules were partial sums (DTensor's matmul reduced them over both mesh
    dims) and the banks' contractions were split over "data": modules
    1-4 ulps apart, step 1's C̃ −0.1134 against 0.0071 (8 gates)."""
    rec = world4[0]["bf16_modules"]
    print({k: rec[k] for k in ("modules", "partial", "mesh_loss", "loss",
                               "steps")})
    assert rec["partial"] and not any(rec["partial"].values()), \
        rec["partial"]
    assert len(rec["modules"]) == 22, sorted(rec["modules"])
    assert max(rec["modules"].values()) <= BF16_MODULE_ULPS, rec["modules"]
    assert rec["routing"]["calls"][0] == rec["routing"]["calls"][1] > 0
    assert abs(rec["mesh_loss"] - rec["loss"]) \
        <= BF16_GATE_REL * abs(rec["loss"])
    assert len(rec["steps"]) == 2
    for st in rec["steps"]:
        tol = BF16_GATE_REL * abs(st["cost"])
        assert abs(st["mesh_c_tilde"] - st["c_tilde"]) <= tol, st
        assert abs(st["mesh_cost"] - st["cost"]) <= tol, st
