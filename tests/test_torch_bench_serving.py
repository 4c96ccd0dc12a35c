"""The online-serving bench's twin on the CPU.

``python -m repro_torch.benchmarks.online_serving --smoke`` must write the
reference's rows, name for name (those of the committed baseline),
and its exact invariants must pass the reference's ``check_regression``
against ``artifacts/bench``, unedited: no torn swap, resume bitwise, the
no-trim device collapsed.  Its accuracy rows come from the port's own
``mlp_init`` and are reported, not gated here: the committed baseline's
accuracies do not reproduce under the installed jax 0.9.0 even for the
reference's own run (ROADMAP C).  What ties the twin to the reference is
the parity tests: given the reference's initial weights (carried by
``convert``), the port's drift-free training and drift strategies land
on the reference's served accuracies, at a cut budget (200 reference
steps, 160 trim steps) with the trained weights compared too, and at
the full gated budget (2000 and 1000), the port's whole chain from its
own trained weights, hold fraction included.
"""
import json
import pathlib

import jax
import numpy as np

from benchmarks import check_regression
from benchmarks import online_serving as jbench
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.benchmarks import online_serving as tbench

ROOT = pathlib.Path(__file__).resolve().parent.parent
INVARIANTS = ("torn_swaps", "resume_bitexact", "no_trim_collapsed")
ACC_ATOL = 2 / 512                      # two of the 512 eval samples


def test_online_serving_twin_smoke_on_cpu(tmp_path):
    assert tbench.main(["--smoke", "--device", "cpu", "--out",
                        str(tmp_path)]) == 0
    out = json.loads((tmp_path / "online_serving.json").read_text())
    assert out["smoke"] and out["device"] == "cpu"
    rows = {r["name"]: r["value"] for r in out["rows"]}
    base = json.loads((ROOT / "artifacts" / "bench" /
                       "online_serving.json").read_text())["rows"]
    assert [r["name"] for r in out["rows"]] == [r["name"] for r in base]
    assert all(0.0 <= rows[k] <= 1.0 for k in rows if "acc" in k)
    assert rows["served_acc_online_trim_sigma0.08"] > \
        rows["served_acc_no_trim_sigma0.08"]
    _, checked, findings = check_regression.compare_file(
        "online_serving", out["rows"], base)
    status = {name: s for s, name, _ in findings}
    assert checked == 6
    for name in INVARIANTS:
        assert status[name] == "ok", findings


def _ref_init(seed, sizes, device=None):
    p = jax.tree_util.tree_map(np.asarray,
                               jmlp_init(jax.random.PRNGKey(seed), sizes))
    return convert.to_torch(p, device=device)


def test_twin_reproduces_reference_accuracies_from_its_init(monkeypatch):
    for mod in (jbench, tbench):
        monkeypatch.setattr(mod, "REF_STEPS", 200)
        monkeypatch.setattr(mod, "WINDOW", 160)
    monkeypatch.setattr(tbench, "mlp_init", _ref_init)
    j_theta, j_a0 = jbench._reference(0)
    t_theta, t_a0 = tbench._reference(0, "cpu")
    assert abs(t_a0 - j_a0) <= ACC_ATOL
    for a, b in zip(jax.tree_util.tree_leaves(j_theta),
                    jax.tree_util.tree_leaves(t_theta)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-4)
    # both strategies from the SAME θ* (the reference's, carried over)
    theta = convert.to_torch(jax.tree_util.tree_map(np.asarray, j_theta),
                             device="cpu")
    for strategy in ("no_trim", "online_trim"):
        want = jbench._drift_strategy(strategy, j_theta, 0)
        got = tbench._drift_strategy(strategy, theta, 0)
        assert abs(got - want) <= ACC_ATOL, (strategy, got, want)


def test_twin_full_budget_from_reference_init_lands_on_reference(
        monkeypatch):
    """The gated rows at the bench's own budget, the twin end to end from
    the reference's init (no weights carried over after it): drift-free
    accuracy and both served accuracies within two eval samples of the
    reference's own run, and the hold fraction within what those allow."""
    monkeypatch.setattr(tbench, "mlp_init", _ref_init)
    j_theta, j_a0 = jbench._reference(0)
    t_theta, t_a0 = tbench._reference(0, "cpu")
    want = {s: jbench._drift_strategy(s, j_theta, 0)
            for s in ("no_trim", "online_trim")}
    got = {s: tbench._drift_strategy(s, t_theta, 0)
           for s in ("no_trim", "online_trim")}
    j_hold, t_hold = want["online_trim"] / j_a0, got["online_trim"] / t_a0
    print(f"driftfree {t_a0} (reference {j_a0}), served {got} "
          f"(reference {want}), hold {t_hold} (reference {j_hold})")
    assert abs(t_a0 - j_a0) <= ACC_ATOL
    for s in want:
        assert abs(got[s] - want[s]) <= ACC_ATOL, (s, got[s], want[s])
    assert abs(t_hold - j_hold) <= ACC_ATOL / t_a0 * (1 + j_hold) + 1e-12
