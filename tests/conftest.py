"""Shared fixtures.  NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see the single real CPU device; only the dry-run
(and subprocess-based distributed tests) use virtual device counts."""
import gc
import multiprocessing
import pathlib
import sys
import threading
import time

import jax
import pytest

# tests import the linter directly (test_mgdlint, test_hygiene);
# tools/ is not a package root on the runtime path otherwise
_TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
if str(_TOOLS) not in sys.path:
    sys.path.insert(0, str(_TOOLS))


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def _live_worker_threads():
    """Non-daemon threads beyond the main thread.  Daemon threads are
    excluded: backend runners/supervisors are daemonic by design (an
    unclean exit must not hang on them), so a leaked daemon shows up
    as a leaked *child process* or a failed MGD005 invariant instead."""
    return {t for t in threading.enumerate()
            if t is not threading.main_thread()
            and t.is_alive() and not t.daemon}


@pytest.fixture(scope="session", autouse=True)
def _leak_sentinel():
    """Fail the suite if backend tests leak workers.

    Complements MGD003/MGD005 dynamically: the static rules prove every
    gather is bounded and teardown paths exist; this fixture proves the
    teardowns actually RAN.  Farms lean on GC finalizers for cleanup,
    so collect first, then give stragglers a short grace window (a
    ThreadBackend join is bounded at ~2s per worker) before failing.
    """
    threads_before = _live_worker_threads()
    procs_before = set(multiprocessing.active_children())

    yield

    gc.collect()          # run farm/backend weakref finalizers
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        leaked_threads = _live_worker_threads() - threads_before
        leaked_procs = {p for p in multiprocessing.active_children()
                        if p not in procs_before and p.is_alive()}
        if not leaked_threads and not leaked_procs:
            return
        time.sleep(0.2)

    lines = [f"  thread {t.name!r} (non-daemon, still alive)"
             for t in sorted(leaked_threads, key=lambda t: t.name)]
    lines += [f"  process {p.name!r} pid={p.pid}"
              for p in sorted(leaked_procs, key=lambda p: p.name)]
    pytest.fail(
        "leaked workers after the test session — some backend was not "
        "shut down (ChipFarm.close() / backend.shutdown() missing or "
        "unreachable):\n" + "\n".join(lines), pytrace=False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one "
        "(run `python -m pytest -m gpu tests/test_torch_*.py` on the H100)")
