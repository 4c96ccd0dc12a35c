"""The port's program spans (``repro_torch.tracing``) and sign-hash
counters (``kernels.hash_counts``), on the CPU.

Spans off record nothing and hand out one shared no-op context; on, they
nest as documented over the smoke Qwen3's fused and unfused steps, each
carrying its MGD step, and change no cost or parameter by a bit.  The
buffer keeps its bound and counts what it let go.  The perturbed-matmul
kernels' hash counts are reckoned from a walk over each kernel's launch
grid, with the tiling read from its CUDA source, and the PyTorch hash
counts the indices it is given."""
import collections
import pathlib
import re

import pytest
import torch

import repro_torch as rt
from repro_torch import kernels, tracing
from repro_torch.core import perturbations as pert
from repro_torch.kernels import perturbed_matmul as pm

CSRC = pathlib.Path(pm.__file__).resolve().parent / "csrc"
STEPS = 2


@pytest.fixture(autouse=True)
def _spans_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _driver(dtype, fused):
    cfg = rt.get_smoke_config("qwen3-14b").replace(dtype=dtype)
    params = rt.model_init(cfg, seed=0, device="cpu")
    drv = rt.driver(
        "discrete", rt.DriverConfig(dtheta=1e-2, eta=1e-3, mode="central",
                                    fused=fused),
        lambda p, b: rt.model_loss(p, cfg, b),
        probe_fn=rt.make_transformer_probe_fn(cfg) if fused else None,
        device="cpu")
    sample = rt.lm_sampler(2, 16, cfg.vocab, seed=0, device="cpu")
    return cfg, params, drv, rt.make_epoch(drv, STEPS, sample)


def test_spans_off_record_nothing_and_share_one_no_op():
    assert not tracing._on
    first = tracing.span("mgd.step", step=0)
    assert first is tracing.span("attn.core") is tracing._NULL
    with first:
        with tracing.span("mgd.probe"):
            pass
    _, params, drv, run = _driver("float32", True)
    run(params, drv.init(params))
    assert tracing.spans() == [] and tracing.dropped() == 0


# (dtype, fused): the fused step; the unfused step's sign-exact f32 path
# and its general one (accumulate, apply_update) in bf16
PATHS = [("float32", True), ("bfloat16", True), ("float32", False),
         ("bfloat16", False)]


@pytest.mark.parametrize("dtype,fused", PATHS)
def test_spans_nest_as_documented_and_carry_the_step(dtype, fused):
    cfg, params, drv, run = _driver(dtype, fused)
    tracing.enable()
    run(params, drv.init(params))
    tracing.disable()
    got = collections.Counter((s.name, s.parent, s.step)
                              for s in tracing.spans())
    want = collections.Counter()
    for n in range(STEPS):
        want.update({("mgd.data", None, None): 1, ("mgd.step", None, n): 1,
                     ("mgd.probe", "mgd.step", n): 1,
                     ("attn.core", "mgd.probe", n): 2 * cfg.n_layers,
                     ("lm.loss", "mgd.probe", n): 2,
                     ("mgd.update", "mgd.step", n): 1})
    assert got == want
    spans = tracing.spans()
    assert all(s.start_ns <= s.end_ns for s in spans)
    steps = [s for s in spans if s.name == "mgd.step"]
    assert [s.attrs for s in steps] == [{"step": n} for n in range(STEPS)]
    for s in spans:             # a child lies inside its parent's interval
        if s.parent == "mgd.step":
            (up,) = [t for t in steps if t.step == s.step]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns


@pytest.mark.parametrize("dtype,fused", PATHS)
def test_spans_on_change_no_cost_or_parameter(dtype, fused):
    out = {}
    for on in (False, True):
        _, params, drv, run = _driver(dtype, fused)
        (tracing.enable if on else tracing.disable)()
        out[on] = run(params, drv.init(params))
        tracing.disable()
    (p0, _, a0), (p1, _, a1) = out[False], out[True]
    assert torch.equal(a0["cost"], a1["cost"])
    assert torch.equal(a0["c_tilde"], a1["c_tilde"])
    for x, y in zip(rt.core.utils.tree_leaves(p0),
                    rt.core.utils.tree_leaves(p1)):
        assert torch.equal(x, y)


def test_the_buffer_keeps_the_newest_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "_buffer", collections.deque(maxlen=3))
    tracing.enable()
    for i in range(5):
        with tracing.span("mgd.data", i=i):
            pass
    assert [s.attrs["i"] for s in tracing.spans()] == [2, 3, 4]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0
    assert tracing.CAPACITY == 1 << 16


def test_a_span_closes_on_an_exception_and_the_stack_unwinds():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("mgd.step", step=7):
            with tracing.span("mgd.probe"):
                raise ValueError("x")
    with tracing.span("mgd.data"):
        pass
    assert [(s.name, s.parent, s.step) for s in tracing.spans()] == [
        ("mgd.probe", "mgd.step", 7), ("mgd.step", None, 7),
        ("mgd.data", None, None)]


def _tc_tiling():
    src = (CSRC / "perturbed_matmul_tc.cu").read_text()
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("WG_ROWS", "BN", "BK", "HASH_THREADS")}
    return const


def _tc_walk(n_streams, m, k, n):
    """Signs the tensor-core kernel's producers hash, CTA by CTA, as its
    launch (grid padded to whole clusters) and its sign loop run."""
    t = _tc_tiling()
    rows = t["WG_ROWS"] if n_streams == 2 else 2 * t["WG_ROWS"]
    cm = pm.tc_cluster(n_streams, m)
    blocks = -(-m // rows)
    grid_x, grid_y = -(-blocks // cm) * cm, -(-n // t["BN"])
    share_rows = t["BK"] // cm
    per_stage = share_rows * 16 // t["HASH_THREADS"] * t["HASH_THREADS"] * 8
    stages = -(-k // t["BK"])
    total = 0
    for _ in range(grid_x):
        for _ in range(grid_y):
            total += stages * per_stage
    return total


@pytest.mark.parametrize("n_streams", [1, 2])
@pytest.mark.parametrize("m", [64, 512, 4096, 192, 100])
@pytest.mark.parametrize("k,n", [(5120, 1024), (64, 128), (200, 136)])
def test_tc_hash_count_follows_the_kernels_grid(n_streams, m, k, n):
    assert pm.signs_hashed("tc", n_streams, m, k, n) == _tc_walk(
        n_streams, m, k, n)


def test_tc_clusters_along_m():
    # pair: 64-row blocks, single: 128; clusters of 4 where they fill
    assert [pm.tc_cluster(2, m) for m in (64, 512, 4096)] == [1, 4, 4]
    assert [pm.tc_cluster(1, m) for m in (64, 512, 4096)] == [1, 4, 4]
    # each sign once per cluster: 16 clusters at M = 4096 for the pair
    assert pm.signs_hashed("tc", 2, 4096, 5120, 17408) == 16 * 5120 * 17408
    assert pm.signs_hashed("tc", 2, 4096, 5120, 17408, cluster=1) \
        == 64 * 5120 * 17408
    assert pm.signs_hashed("tc", 1, 0, 64, 128) == 0


@pytest.mark.parametrize("m,k,n", [(64, 49, 4), (65, 49, 4), (4096, 5120,
                                                                1000)])
def test_simt_hash_count_is_w_once_a_row_block(m, k, n):
    src = (CSRC / "perturbed_matmul.cu").read_text()
    bm = int(re.search(r"constexpr int BM = (\d+);", src).group(1))
    assert bm == pm.SIMT_BM
    for streams in (1, 2):
        assert pm.signs_hashed("simt", streams, m, k, n) == \
            k * n * -(-m // bm)


def test_the_torch_hash_counts_its_indices():
    before = pert.rademacher_signs.signs_hashed
    pert.rademacher_signs(pert.leaf_seed(1, 2, 3),
                          torch.arange(15).reshape(3, 5))
    pert.theta_range(7, 10, 110, 1e-2, torch.float32)
    assert pert.rademacher_signs.signs_hashed - before == 115
    assert kernels.hash_counts()["rademacher_signs"] == \
        pert.rademacher_signs.signs_hashed


def test_reset_launch_counts_clears_the_hash_counters():
    pm._count(pm.perturbed_matmul_pair, "tc", 1234)
    kernels.mgd_update.mgd_update_window_group.signs_hashed += 5
    pert.rademacher_signs(0, torch.arange(4))
    counts = kernels.hash_counts()
    assert set(counts) == set(kernels.launch_counts()) | {"rademacher_signs"}
    assert counts["perturbed_matmul_pair"] >= 1234
    kernels.reset_launch_counts()
    assert set(kernels.hash_counts().values()) == {0}
    assert set(kernels.launch_counts().values()) == {0}
