"""The frozen copies in ``mgdbench/counts`` against the port's own: the
sign hash, the model flops and the kernels' bounds and profiler names."""
import importlib.util
import math

import pytest
import torch

from mgdbench.tests.smoke import REPO  # noqa: F401  (puts src on the path)
from mgdbench.counts import flops, peaks, signs
from mgdbench.reference import family
from repro_torch.core import perturbations as pert
from repro_torch.core.utils import leaf_meta, tree_paths


@pytest.mark.parametrize("seed,step,leaf", [(0, 0, 0), (1, 3, 7),
                                            (2 ** 32 - 1, 2 ** 31 + 5, 12),
                                            (123456789, 40, 2)])
def test_sign_hash_matches_the_port(seed, step, leaf):
    lseed = signs.leaf_seed(seed, step, leaf)
    assert lseed == pert.leaf_seed(seed, step, leaf)
    for start in (0, 1000, 2 ** 32 - 7):
        want = pert.theta_range(lseed, start, start + 64, 1.0,
                                torch.float32)
        assert torch.equal(signs.signs(lseed, start, start + 64), want)


def _smoke(name):
    import json
    from mgdbench.tests.smoke import BENCH, SMOKE_SIZES
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    conf.update(SMOKE_SIZES[conf["reference"]])
    return conf


@pytest.mark.parametrize("name", ["qwen3-14b", "rwkv6-port-7b"])
def test_leaf_ids_and_layout_match_the_port(name):
    import repro_torch as rt
    from repro_torch.launch.specs import abstract_params
    conf = _smoke(name)
    fam = family(conf["reference"])
    cfg = rt.get_config(conf["program"]).replace(**fam.program_fields(conf))
    tree = abstract_params(cfg)
    port = {path: (lid, tuple(x.shape))
            for (path, x), (lid, _, _) in zip(tree_paths(tree),
                                              leaf_meta(tree))}
    specs = fam.leaf_specs(conf)
    ids = signs.leaf_ids([s[0] for s in specs])
    assert {s[0]: (ids[s[0]], tuple(s[1])) for s in specs} == port


@pytest.mark.parametrize("name,batch,seq", [("qwen3-14b", 8, 512),
                                            ("qwen3-14b", 4, 64),
                                            ("rwkv6-port-7b", 8, 512)])
def test_model_flops_match_the_port(name, batch, seq):
    import repro_torch as rt
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import model_flops
    conf = _smoke(name)
    fam = family(conf["reference"])
    cfg = rt.get_config(conf["program"]).replace(**fam.program_fields(conf))
    dims = fam.flop_dims(conf)
    n_params = sum(math.prod(s[1]) for s in fam.leaf_specs(conf))
    mine = flops.model_flops(n_params, dims["n_embed"], batch, seq,
                             attn_layers=dims["attn_layers"],
                             d_attn=dims["d_attn"], n_forwards=2)
    theirs = model_flops(cfg, ShapeSpec("t", seq, batch, "train"), "train", 2)
    assert mine == theirs


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_frozen",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_peaks_bounds_and_kernel_names_match_chip_smoke():
    cs = _chip_smoke()
    assert peaks.PEAK_BYTES == cs.PEAK_BYTES
    assert peaks.PEAK_OPS == cs.PEAK_OPS
    assert peaks.PEAK_INT32 == cs.PEAK_INT32
    assert peaks.KERNEL_KEYS == cs.KERNEL_KEYS
    for m, k, n in cs.LM_SHAPES:
        esz = 2
        want = cs.bound(4.0 * m * k * n, (2 * m * k + k * n + 2 * m * n) * esz,
                        "bfloat16")[0] / 1e3
        assert peaks.pair_bound_s(m, k, n) == pytest.approx(want, rel=1e-12)
    for dtype, ints in peaks.WINDOW_INT_OPS.items():
        k, n = 5120, 17408
        esz = peaks.ELEM_BYTES[dtype]
        want = cs.update_bound(1.0 * k * n, 2 * k * n * esz + 8, ints, 1,
                               k * n)[0] / 1e3
        assert peaks.window_bound_s(k * n, dtype) == pytest.approx(
            want, rel=1e-12)
    # PR 26's phase-2 bounds of the LM gate/up shape, as recorded
    assert peaks.pair_bound_s(512, 5120, 17408) * 1e3 == pytest.approx(
        0.18456633981799797, rel=1e-9)
    assert peaks.window_bound_s(5120 * 17408, "bfloat16") * 1e3 == \
        pytest.approx(0.10642264119402986, rel=1e-9)
