"""Source-hygiene guards for the port's host boundary and serving tier.

Twins of ``tests/test_hygiene.py``, whose guards (and mgdlint's rules)
are scoped to ``src/repro/``: the same failure classes live in
``src/repro_torch/hardware/`` and ``src/repro_torch/serving/`` now.  A gather with no timeout turns a hung
instrument into a training step that never returns; a backend without a
teardown leaks its workers; a chip that touches a tensor breaks in the
process backend's forked workers.
"""
import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
HARDWARE_DIR = REPO / "src" / "repro_torch" / "hardware"
SERVING_DIR = REPO / "src" / "repro_torch" / "serving"

mgdlint = pytest.importorskip(
    "mgdlint", reason="tools/ not on sys.path (see tests/conftest.py)")
from mgdlint.rules import LockDiscipline, TimeoutDiscipline  # noqa: E402
from mgdlint.walker import SourceFile, dotted_name  # noqa: E402


def _sources(subdir=None, root=HARDWARE_DIR):
    root = root / subdir if subdir else root
    return [SourceFile(path, REPO) for path in sorted(root.rglob("*.py"))]


def _untimed_results(sources):
    offenders = []
    for source in sources:
        for node in ast.walk(source.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "result" \
                    and not any(k.arg == "timeout" for k in node.keywords):
                offenders.append(f"{source.rel}:{node.lineno}")
    return offenders


def test_hardware_sources_exist():
    # the guards below must actually be scanning something
    for name in ("farm.py", "external.py", "faults.py", "devices.py",
                 "backend/base.py", "backend/thread.py",
                 "backend/process.py", "backend/cluster_stub.py"):
        assert (HARDWARE_DIR / name).is_file(), name


def test_every_result_call_passes_a_timeout():
    """Every ``.result(`` call in the port's hardware/ passes
    ``timeout=`` — the port's twin of the reference's ``.result(`` guard
    (a hung chip would otherwise block the training step forever)."""
    offenders = _untimed_results(_sources())
    assert not offenders, "`.result(` without timeout=: " + ", ".join(
        offenders)


@pytest.mark.parametrize("rule,subdir", [(TimeoutDiscipline, None),
                                         (LockDiscipline, "backend")],
                         ids=["MGD003-timeouts", "MGD005-locks"])
def test_mgdlint_rule_holds_on_port_hardware(rule, subdir):
    """mgdlint's timeout rule (every Future.result, wait, queue get, join
    and acquire bounded, or waived with a reason) and lock rule (backend
    workers mutate shared state only under the lock), run on the port's
    files — their registered scope is the reference's tree."""
    offenders, checked = [], 0
    for source in _sources(subdir):
        checked += 1
        for f in rule().check(source):
            if not source.waived(f.code, f.line):
                offenders.append(f.format())
        for w in source.waivers:
            assert not w.malformed, f"{source.rel}:{w.line}: {w.malformed}"
    assert checked >= 4
    assert not offenders, "\n".join(offenders)


def test_serving_tier_bounds_every_wait():
    """The serving tier (``serving/``, the twin of the reference's
    ``serving/online.py``): ``online.py`` keeps ``DEFAULT_TIMEOUT_S``,
    every ``.result(`` passes ``timeout=`` and mgdlint's timeout rule
    (every Future.result, wait, queue get, join and acquire bounded)
    holds, so a stuck predict or trainer surfaces as a timeout."""
    sources = _sources(root=SERVING_DIR)
    assert {pathlib.Path(s.rel).name for s in sources} >= {
        "__init__.py", "decode.py", "online.py"}
    online = next(s for s in sources if s.rel.endswith("online.py"))
    assert any(isinstance(n, ast.Assign) and any(
        getattr(t, "id", None) == "DEFAULT_TIMEOUT_S" for t in n.targets)
        for n in online.tree.body)
    assert not _untimed_results(sources)
    offenders = []
    for source in sources:
        for f in TimeoutDiscipline().check(source):
            if not source.waived(f.code, f.line):
                offenders.append(f.format())
    assert not offenders, "\n".join(offenders)


CONCRETE_BACKENDS = {"SerialBackend", "ThreadBackend", "ProcessBackend"}


def test_every_backend_defines_shutdown():
    """Every farm backend module owns its teardown: sweeps build many
    farms per process, and a backend without a shutdown path leaks its
    workers until interpreter exit."""
    for source in _sources("backend"):
        if source.rel.endswith("__init__.py"):
            continue
        ok = False
        for cls in (n for n in source.tree.body
                    if isinstance(n, ast.ClassDef)):
            methods = {n.name for n in cls.body
                       if isinstance(n, ast.FunctionDef)}
            bases = {dotted_name(b) for b in cls.bases}
            if "shutdown" in methods or bases & CONCRETE_BACKENDS:
                ok = True
        assert ok, f"{source.rel}: no backend class with a shutdown()"


def test_process_backend_actually_kills_workers():
    """Hung workers are terminated, joins are bounded, and workers are
    daemonic so an unclean interpreter exit cannot hang on them."""
    source = SourceFile(HARDWARE_DIR / "backend" / "process.py", REPO)
    terminates, daemons, unbounded_joins = 0, 0, []
    for node in ast.walk(source.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            if node.func.attr == "terminate":
                terminates += 1
            elif node.func.attr == "join":
                bounded = bool(node.args) or any(
                    k.arg == "timeout" and not (
                        isinstance(k.value, ast.Constant)
                        and k.value.value is None)
                    for k in node.keywords)
                if not bounded:
                    unbounded_joins.append(node.lineno)
        for k in node.keywords:
            if k.arg == "daemon" and isinstance(k.value, ast.Constant) \
                    and k.value.value is True:
                daemons += 1
    assert terminates, "no process terminate() — hangs survive"
    assert not unbounded_joins, f"unbounded join() at {unbounded_joins}"
    assert daemons, "non-daemon workers outlive the host"


def test_farm_close_tears_down_backend():
    """``ChipFarm.close()`` routes through the backend's shutdown."""
    source = SourceFile(HARDWARE_DIR / "farm.py", REPO)
    calls = [node.lineno for node in ast.walk(source.tree)
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)
             and node.func.attr == "shutdown"
             and "backend" in (dotted_name(node.func.value) or "")]
    assert calls, "farm.py never calls <backend>.shutdown(...)"


HOST_CLASSES = {"devices.py": ("SimulatedAnalogChip", "DriftingAnalogChip",
                               "LinearLaneChip"),
                "faults.py": ("FaultyChip",),
                "backend/base.py": ("ChipOps", "DeviceSpec")}


@pytest.mark.parametrize("module", sorted(HOST_CLASSES))
def test_host_devices_never_touch_torch(module):
    """The numpy chips, the fault wrapper and the worker-side op runner
    use no ``torch`` at all: they run in forked worker processes, where
    a CUDA call fails."""
    source = SourceFile(HARDWARE_DIR / module, REPO)
    classes = {n.name: n for n in source.tree.body
               if isinstance(n, ast.ClassDef)}
    for name in HOST_CLASSES[module]:
        assert name in classes, (module, name)
        used = {n.id for n in ast.walk(classes[name])
                if isinstance(n, ast.Name)}
        assert "torch" not in used, f"{module}::{name} uses torch"
