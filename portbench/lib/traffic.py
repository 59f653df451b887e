"""The one traffic generator: per-domain token streams drawn from the seed,
laid out for a closed loop of forget requests.

A frozen, vectorised copy of the port's ``data/synthetic.py::
make_lm_domains``: each domain is a first-order Markov chain over its own
range of ``span = vocab * domain_vocab_frac`` tokens (start ``(d * span //
2) % (vocab - span)``), with Dirichlet(0.05) transition rows. The original
draws one token at a time; this draws every domain's sequences one step
at a time, so one seed gives other arrays than the original's, from the
same distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np


def make_lm_domains(*, vocab: int, n_domains: int, seq_len: int,
                    n_per_domain: int, domain_vocab_frac: float,
                    seed: int) -> np.ndarray:
    """Tokens [n_domains, n_per_domain, seq_len] (int64), domain d's
    sequences in row d."""
    rng = np.random.default_rng(seed)
    span = max(8, int(vocab * domain_vocab_frac))
    lo = (np.arange(n_domains) * span // 2) % max(1, vocab - span)
    cum = np.cumsum(rng.dirichlet(np.full(span, 0.05),
                                  size=(n_domains, span)), axis=-1)
    cum[..., -1] = 1.0
    state = rng.integers(span, size=(n_domains, n_per_domain))
    draws = rng.random((seq_len - 1, n_domains, n_per_domain))
    out = np.empty((seq_len, n_domains, n_per_domain), np.int64)
    out[0] = state
    dom = np.arange(n_domains)[:, None]
    for t in range(1, seq_len):
        rows = cum[dom, state]                       # [D, n, span]
        state = np.minimum((rows < draws[t - 1][..., None]).sum(-1),
                           span - 1)
        out[t] = state
    return np.ascontiguousarray(out.transpose(1, 2, 0)) + lo[:, None, None]


@dataclasses.dataclass(frozen=True)
class RunData:
    """One run's token ids: the retain sequences behind the global Fisher
    (one from each retain domain), the warm-up request, and the pool of
    forget requests, one domain each, in the order they are sent."""
    retain: np.ndarray      # [n_retain, seq_len]
    warmup: np.ndarray      # [seqs_per_request, seq_len]
    pool: np.ndarray        # [forget_pool, seqs_per_request, seq_len]


def run_data(cell: Dict[str, Any], seed: int) -> RunData:
    """The cell's tokens from ``seed``: every seed gets the same sizes."""
    d = cell["data"]
    B, S = int(cell["seqs_per_request"]), int(cell["seq_len"])
    n_ret, n_pool = int(d["retain_seqs"]), int(d["forget_pool"])
    toks = make_lm_domains(vocab=int(d["vocab"]),
                           n_domains=n_ret + 1 + n_pool, seq_len=S,
                           n_per_domain=B,
                           domain_vocab_frac=float(d["domain_vocab_frac"]),
                           seed=seed)
    return RunData(retain=toks[:n_ret, 0], warmup=toks[n_ret],
                   pool=toks[n_ret + 1:])
