"""B1-B4 of two trees of the port on one card, in turns.

    python src/repro_torch/benchmarks/kernel_ab.py PARENT_SRC

Times the four kernels as ``chip_smoke.py`` phase 2 does at its main
shapes (the LM's gate/up leaf [5120, 17408] in bf16, 512 tokens; B3 at
J = 1, B4 at J = 4), through the dispatch API that every tree of the
port has, under another tree's ``src`` (``PARENT_SRC``, e.g. the parent
commit's ``git archive``) and under this one, in turns (parent, change,
change, parent), each round a process of its own that builds its tree's
kernels.  Prints each round and the means, with the card's name and
power limit.  It is run by path, not as a module: each round imports
``repro_torch`` from its own tree.
"""
import json
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[2]
ROUNDS = ("parent", "change", "change", "parent")
SHAPE = (512, 5120, 17408)           # M tokens, K, N
ROUND_TIMEOUT_S = 600


def time_ms(fn, budget_ms: float = 60.0) -> float:
    """Mean device time of ``fn`` over a run of launches, CUDA events
    (``chip_smoke.py``'s phase-2 timer)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(200, max(3, budget_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(src) -> dict:
    """One round: the four kernels of the port under ``src`` (its own
    build), ms a launch."""
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.core import perturbations as pert
    from repro_torch.kernels import _build, ops
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA card")
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    m, k, n = SHAPE
    bf16 = torch.bfloat16
    x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
    xm = torch.randn((m, k), generator=gen, device=dev).to(bf16)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.1).to(bf16)
    lseed = pert.leaf_seed(1, 0, 3)
    s1 = ops.seeds_tensor([pert.leaf_seed(1, 0, 3)], dev)
    s4 = ops.seeds_tensor([pert.leaf_seed(7, t, 0) for t in range(4)], dev)
    c1 = torch.randn((1,), generator=gen, device=dev)
    c4 = torch.randn((4,), generator=gen, device=dev)
    return {
        "perturbed_matmul": time_ms(lambda: ops.perturbed_matmul(
            x, w, lseed, dtheta=1e-2, sign=-1.0)),
        "perturbed_matmul_pair": time_ms(lambda: ops.perturbed_matmul_pair(
            x, xm, w, lseed, dtheta=1e-2)),
        "mgd_update_window": time_ms(lambda: ops.mgd_update_window(
            w, s1, c1, alpha=-0.1, dtheta=1e-2)),
        "mgd_update": time_ms(lambda: ops.mgd_update(
            w, s4, c4, eta=0.1, dtheta=0.01))}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--round":
        print(json.dumps(kernel_times(argv[1])), flush=True)
        return 0
    if len(argv) != 1:
        raise SystemExit(__doc__)
    parent = pathlib.Path(argv[0]).resolve()
    rounds = []
    for label in ROUNDS:
        out = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--round", str(parent if label == "parent" else SRC)],
            capture_output=True, text=True, timeout=ROUND_TIMEOUT_S)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"the {label} round exited {out.returncode}")
        rounds.append((label, json.loads(out.stdout.splitlines()[-1])))
        print(json.dumps({"round": label, "ms": rounds[-1][1]}), flush=True)
    mean = {label: {name: sum(r[name] for lb, r in rounds if lb == label)
                    / 2 for name in rounds[0][1]}
            for label in ("parent", "change")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    print(json.dumps({"kernel_ab": dict(card=card, mean_ms=mean,
                                        rounds=rounds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
