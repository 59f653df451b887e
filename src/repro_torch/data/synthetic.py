"""Synthetic data with forget/retain splits (numpy only).

Port of ``repro.data.synthetic``: the same generators, so one seed gives
the same arrays as the reference. Two generators:

  * classification: class-conditional image manifolds for ResNet/ViT;
  * LM token streams: per-"domain" Markov chains over overlapping token
    ranges — forgetting a domain mirrors forgetting a class.

Class-separable synthetic images whose *unlearning geometry* matches the
paper's setting: a pre-trained model reaches high accuracy on every class,
then one class is designated the forget set D_f and the rest the retain set
D_r (Eq. 1). Deterministic in (seed, split); ``Batches`` yields host-local
slices given (host_id, n_hosts).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClsDataConfig:
    n_classes: int = 20
    img_size: int = 32
    n_per_class: int = 64
    noise: float = 0.35
    seed: int = 0


def _smooth_template(rng: np.random.Generator, size: int) -> np.ndarray:
    """A smooth random image: low-frequency Fourier components only."""
    freq = rng.normal(size=(6, 6, 3)) + 1j * rng.normal(size=(6, 6, 3))
    full = np.zeros((size, size, 3), complex)
    full[:6, :6] = freq
    img = np.real(np.fft.ifft2(full, axes=(0, 1)))
    img = img / (np.abs(img).max() + 1e-9)
    return img.astype(np.float32)


def make_classification(cfg: ClsDataConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images [N,H,W,3], labels [N]) with N = n_classes*n_per_class."""
    rng = np.random.default_rng(cfg.seed)
    templates = [_smooth_template(rng, cfg.img_size)
                 for _ in range(cfg.n_classes)]
    xs, ys = [], []
    for c in range(cfg.n_classes):
        base = templates[c]
        for _ in range(cfg.n_per_class):
            shift = rng.integers(-3, 4, size=2)
            img = np.roll(base, shift, axis=(0, 1))
            img = img * rng.uniform(0.8, 1.2) + rng.normal(
                scale=cfg.noise, size=img.shape).astype(np.float32)
            xs.append(img)
            ys.append(c)
    x = np.stack(xs).astype(np.float32)
    y = np.array(ys, np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def split_forget_retain(x: np.ndarray, y: np.ndarray, forget_class: int,
                        holdout_frac: float = 0.25):
    """Returns dict with train/eval splits for D_f, D_r and a held-out set
    (non-members, used by the MIA metric)."""
    f_idx = np.where(y == forget_class)[0]
    r_idx = np.where(y != forget_class)[0]
    n_hold = max(1, int(len(r_idx) * holdout_frac))
    hold, r_train = r_idx[:n_hold], r_idx[n_hold:]
    return {
        "forget": (x[f_idx], y[f_idx]),
        "retain": (x[r_train], y[r_train]),
        "heldout": (x[hold], y[hold]),
    }


# ---------------------------------------------------------------------------
# LM token streams (per-domain Markov chains)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int = 512
    n_domains: int = 8
    seq_len: int = 64
    n_per_domain: int = 32
    domain_vocab_frac: float = 0.25   # overlap between domain vocabularies
    seed: int = 0


def make_lm_domains(cfg: LMDataConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tokens [N, seq_len+1] int32, domain_ids [N]). Each domain is
    a first-order Markov chain concentrated on its own token sub-range."""
    rng = np.random.default_rng(cfg.seed)
    span = max(8, int(cfg.vocab * cfg.domain_vocab_frac))
    seqs, doms = [], []
    for d in range(cfg.n_domains):
        lo = (d * span // 2) % max(1, cfg.vocab - span)
        # sparse transition matrix within [lo, lo+span)
        trans = rng.dirichlet(np.ones(span) * 0.05, size=span)
        for _ in range(cfg.n_per_domain):
            t = np.empty(cfg.seq_len + 1, np.int32)
            t[0] = lo + rng.integers(span)
            for i in range(1, cfg.seq_len + 1):
                t[i] = lo + rng.choice(span, p=trans[t[i - 1] - lo])
            seqs.append(t)
            doms.append(d)
    x = np.stack(seqs)
    y = np.array(doms, np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def lm_split_forget_retain(tokens: np.ndarray, domains: np.ndarray,
                           forget_domain: int, holdout_frac: float = 0.25):
    f_idx = np.where(domains == forget_domain)[0]
    r_idx = np.where(domains != forget_domain)[0]
    n_hold = max(1, int(len(r_idx) * holdout_frac))
    return {
        "forget": tokens[f_idx],
        "retain": tokens[r_idx[n_hold:]],
        "heldout": tokens[r_idx[:n_hold]],
    }


class Batches:
    """Deterministic, restartable, host-shardable batch iterator.

    ``state()`` makes the pipeline checkpointable: training resumes
    mid-epoch after a failure with no sample skew.
    """

    def __init__(self, arrays: Tuple[np.ndarray, ...], batch: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1,
                 step: int = 0):
        n = arrays[0].shape[0]
        if not all(a.shape[0] == n for a in arrays):
            raise ValueError(
                f"Batches arrays disagree on leading (sample) dimension: "
                f"{[a.shape[0] for a in arrays]}")
        if batch % n_hosts != 0:
            raise ValueError(
                f"global batch ({batch}) must divide evenly across "
                f"{n_hosts} host(s)")
        self.arrays = arrays
        self.batch = batch
        self.local = batch // n_hosts
        self.seed, self.host_id, self.n_hosts = seed, host_id, n_hosts
        self.n = n
        self.step = step

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        return self

    def __next__(self):
        epoch = (self.step * self.batch) // self.n
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(self.n)
        start = (self.step * self.batch) % self.n
        idx = perm[np.arange(start, start + self.batch) % self.n]
        lo = self.host_id * self.local
        idx = idx[lo:lo + self.local]
        self.step += 1
        return tuple(a[idx] for a in self.arrays)
