"""The one-card witness of ``tests/torch_witness.py`` against the
whole-model route, on the CPU at smoke size.

The witness redraws the model a part at a time (``init_part``) and never
holds it whole; the four-card run holds the sharded steps against it
(``tests/torch_dist_worker.py cards_full``).  Here, for the smoke
configs of qwen2-72b (the fused probe: B2 / B1 through their plain
versions) and llama4-scout (MoE: θ ± θ̃ materialized), in f32 and bf16,
every number is bitwise the whole model's: the cost at θ₀ against
``model_loss(model_init(...))``; over two fused MGD steps of the whole
model (central and forward), each step's probe costs and C̃, from the
witness's parts at θ₀ and then after step 0's update given its C̃, and
every part after each update against the step's updated params.
"""
import pytest
import torch

import repro_torch as rt
import torch_witness as tw
from repro_torch.core import perturbations as pert
from repro_torch.core.utils import tree_leaves, tree_map
from repro_torch.models import transformer as tt

ARCHS = ["qwen2-72b", "llama4-scout-17b-a16e"]
SEED = 5


def _batch(cfg, seed=1, b=2, s=16):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g,
                         dtype=torch.int32)
    return {"tokens": toks, "labels": toks}


def _cfg(arch, dtype):
    return rt.get_smoke_config(arch).replace(dtype=dtype, n_layers=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stream_cost_is_the_whole_models(arch, dtype):
    cfg = _cfg(arch, dtype)
    batch = _batch(cfg)
    params = rt.model_init(cfg, SEED, device="cpu")
    want = rt.model_loss(params, cfg, batch)
    got = tw.stream_cost(cfg, SEED, batch, device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["central", "forward"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stream_steps_are_the_whole_models(arch, dtype, mode):
    """Steps 0 and 1 of a fused run from the init: the witness's probe
    costs and C̃ from its parts (at θ₀, then after step 0's update given
    step 0's C̃) are the steps', and every part after each update is the
    step's updated params; the update at another step counter (3), given
    the same C̃, is ``fused_update_tau1``'s there."""
    cfg = _cfg(arch, dtype)
    batch = _batch(cfg)
    params = rt.model_init(cfg, SEED, device="cpu")
    mcfg = rt.MGDConfig(dtheta=1e-2, eta=1e-2, mode=mode, fused=True,
                        seed=7)
    step = rt.build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b), mcfg,
                             probe_fn=rt.make_transformer_probe_fn(cfg))
    signs = (1.0, -1.0) if mode == "central" else (1.0,)
    p, state, updates = params, rt.mgd_init(params, mcfg), []
    for n in range(2):
        new, state, m = step(p, state, batch)
        probe = pert.Probe(n, mcfg.seed, pert.ProbeCtx(
            signs=signs, dtheta=mcfg.dtheta, tau_p=mcfg.tau_p))
        costs = tw.stream_probe(cfg, SEED, batch, probe, device="cpu",
                                updates=updates)
        assert torch.equal(costs, tt.model_probe_costs(p, cfg, batch, probe))
        if mode == "central":
            ct = 0.5 * (costs[0] - costs[1])
            assert torch.equal(0.5 * (costs[0] + costs[1]), m["cost"])
        else:
            ct = costs[0] - tw.stream_cost(cfg, SEED, batch, device="cpu",
                                           updates=updates)
        assert torch.equal(ct, m["c_tilde"]), n
        updates.append((mcfg, n, m["c_tilde"]))
        for part in ["embed"] + list(range(cfg.n_layers)):
            got = tw.redraw(cfg, SEED, part, device="cpu", updates=updates)
            want = (new["embed"] if part == "embed" else
                    tree_map(lambda a: a[part], new["layers"]))
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert torch.equal(a, b), (n, part)
        p = new
    # another step counter, given the same C̃: the seeds move with it
    whole = rt.core.mgd.fused_update_tau1(mcfg, params, 3, m["c_tilde"])
    got = tw.redraw(cfg, SEED, 2, device="cpu",
                    updates=[(mcfg, 3, m["c_tilde"])])
    for a, b in zip(tree_leaves(got), tree_leaves(
            tree_map(lambda a: a[2], whole["layers"]))):
        assert torch.equal(a, b)
