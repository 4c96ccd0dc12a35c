"""Every XOR row of the ``hardware_plants`` twin against the reference's,
on the CPU, at the cut of ``tests/test_torch_bench_plants.py`` (one seed,
200 steps in chunks of 100, the reference's init): the same row, value
and ``detail`` included, for each device of ``XOR_PLANTS``, ``XOR_DACS``
and ``XOR_ADCS`` built as each package's ``run()`` builds it, and its run
held against the reference's (``hold_runs``: config, budget, plant meta,
final params).  At 200 steps no row solves: outcomes are held where the
cut reaches a solve, for the ideal, DAC and ADC rows in ``run()``'s test
and ``tests/test_torch_bench_windows.py``, for fig10's σ_a device in
``tests/test_torch_bench_fig8.py``."""
import pytest
import torch

from benchmarks import hardware_plants as jhp
from repro.hardware import (noisy_mlp_plant as jnoisy,
                            quantized_mlp_plant as jquant)
from repro_torch.benchmarks import hardware_plants as thp
from repro_torch.hardware import (noisy_mlp_plant as tnoisy,
                                  quantized_mlp_plant as tquant)
from test_torch_bench_plants import cut
from test_torch_bench_windows import hold_runs

ROWS = [(table, name) for table in ("XOR_PLANTS", "XOR_DACS", "XOR_ADCS")
        for name, _ in getattr(thp, table)]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("table,name", ROWS, ids=[n for _, n in ROWS])
def test_xor_row_matches_reference_at_a_cut(monkeypatch, table, name):
    want_runs, got_runs = cut(monkeypatch)
    kw = dict(getattr(thp, table))[name]
    mode = "central" if table == "XOR_ADCS" else "forward"
    if table == "XOR_PLANTS":
        detail = f"NoisyPlant {kw or 'σ=0'}"
        want = jhp._xor_row(name, lambda s: jnoisy(
            (2, 2, 1), dtheta=1e-2, device_seed=s, **kw), detail, mode=mode)
        got = thp._xor_row(name, lambda s: tnoisy(
            (2, 2, 1), dtheta=1e-2, device_seed=s, device="cpu", **kw),
            detail, mode=mode, device="cpu")
    else:
        detail = f"QuantizedPlant {kw}"
        want = jhp._xor_row(name, lambda s: jquant(
            (2, 2, 1), device_seed=s, **kw), detail, mode=mode)
        got = thp._xor_row(name, lambda s: tquant(
            (2, 2, 1), device_seed=s, device="cpu", **kw), detail,
            mode=mode, device="cpu")
    assert got == want
    hold_runs(want_runs, got_runs)
