"""signs_hashed_per_param: the Rademacher signs the program hashed a
traced step, per parameter: the kernels' hash counters (B2 and B3, each
launch's count reckoned from its shapes in its wrapper) and the PyTorch
hash's (``core/perturbations.py::rademacher_signs``), from
``kernels.hash_counts()`` before and after ``program_spans.traced``'s
steps."""
from mgdbench import program_spans


def read(ctx):
    t = program_spans.traced(ctx)
    if t is None or not t.hashed or not sum(t.hashed.values()):
        return None
    return sum(t.hashed.values()) / t.steps / t.n_params
