"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA H100s.

``python mgdbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything here is driven by the names in
``BENCHMARK.json``: a configuration is ``configs/<config>.json`` with its
plain reference ``reference/<family>.py``, a traffic mix is
``traffic/<traffic>.json``, a cell's limits are ``limits/<workload>.json``
and a per-layer metric is ``metrics/<metric>.py``.  ``counts/`` holds the
frozen yardstick: peaks, kernel bounds, model flops, kernel names and the
sign hash.
"""
