"""The one traffic generator: a training job's token batches.

A traffic file (``traffic/<mix>.json``) gives the batch, the sequence
length and the law's parameters.  The law is the port's Zipf-Markov text
(``repro_torch.data.tasks.lm_batch``), rewritten: a Zipfian marginal by
inverse CDF, z = ⌊exp(u·ln V)⌋ − 1 for u uniform in [u_min, 1), and at
each position after the first, with probability ``continue_p``, the
deterministic chain t → (mul·t + add) mod V instead.  The chain is formed
in closed form (the k-th iterate of an affine map is affine), so a batch
is a few device ops.  Batch n is drawn from a generator on the card
seeded from (seed, n): every step gets its own rows, and the same seed
gives the same batches.
"""
from __future__ import annotations

import torch

from mgdbench.weights import mix64


def _chain_tables(length: int, vocab: int, mul: int, add: int, device):
    """a[k], b[k] with f^k(t) = (a[k]·t + b[k]) mod V."""
    a, b, av, bv = [], [], 1, 0
    for _ in range(length):
        a.append(av)
        b.append(bv)
        av, bv = (av * mul) % vocab, (bv * mul + add) % vocab
    return (torch.tensor(a, dtype=torch.int64, device=device),
            torch.tensor(b, dtype=torch.int64, device=device))


def sampler(traffic, vocab: int, seed: int, device):
    """``sample(n)`` → {"tokens", "labels"} [B, S] int64 of step n."""
    bsz, seq = int(traffic["batch"]), int(traffic["seq"])
    law = traffic["law"]
    if law["name"] != "zipf_markov":
        raise ValueError(f"unknown traffic law {law['name']!r}")
    width = seq + 1
    a, b = _chain_tables(width, vocab, int(law["chain_mul"]),
                         int(law["chain_add"]), device)
    pos = torch.arange(width, device=device)
    log_v = torch.tensor(float(vocab), dtype=torch.float64).log().float()

    def sample(n: int):
        gen = torch.Generator(device=device)
        gen.manual_seed(mix64(seed, 0xBA7C, n))
        u = torch.rand((bsz, width), generator=gen, device=device)
        u = law["u_min"] + (1.0 - law["u_min"]) * u
        z = (torch.exp(u * log_v.to(device)).long() - 1).clamp(0, vocab - 1)
        cont = torch.rand((bsz, width), generator=gen, device=device) \
            < law["continue_p"]
        cont[:, 0] = False
        start = torch.cummax(torch.where(cont, 0, pos), dim=1).values
        k = pos - start
        toks = (a[k] * torch.gather(z, 1, start) + b[k]) % vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return sample
