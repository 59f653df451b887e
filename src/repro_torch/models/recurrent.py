"""Recurrent blocks of the port: xLSTM's mLSTM and sLSTM and Griffin's
RG-LRU, ``repro.models.recurrent``'s parallel (training / forget-request)
forms and its O(1)-state decode forms (``init_*_state``, ``*_decode``: one
token per row against a state carried in f32, the conv history of the
RG-LRU in the model's dtype).

- mLSTM: matrix-memory LSTM, i.e. gated linear attention, in the chunkwise
  form: a Python loop over ``ceil(S / chunk)`` chunks carrying the state
  ``(C, n)`` in f32, the quadratic intra-chunk product with its decay
  matrix inside each chunk.
- sLSTM: scalar-memory LSTM with a hidden-to-gate recurrence through
  block-diagonal ``[H, dh, dh]`` weights; inherently sequential, a Python
  loop over the S time steps.
- RG-LRU: a gated diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t``
  behind a depthwise causal conv, run as a log-depth (Hillis-Steele) scan
  in tensor ops.

Parameters are the reference's dicts and keys, dense weights in its
[d_in, d_out] layout. Every product and gate runs in f32; a bf16 input is
upcast for the products, where the reference asks XLA for an f32 result
(``preferred_element_type``), and the block's output is rounded once to
the input's dtype. The gate forms are the reference's: log-sigmoid as
``-softplus(-x)``, the sLSTM's stabiliser ``m`` as ``max(log_f + m, i)``,
the mLSTM's masked exponential as ``where(tri, exp(rel), 0)`` (``exp`` is
evaluated above the diagonal too, so that gradients agree wherever the
reference's are finite), GELU in its tanh form (``jax.nn.gelu``'s
default).

Two orders of operations differ from the reference's and are declared
where the tests compare them: the RG-LRU scan (``jax.lax.associative_scan``
combines elements in another tree), and the sLSTM's gate pre-activations:
the input projections with their biases for all steps in one product
before the loop, the recurrent term added to them by one ``addmm`` per
step (the reference forms each gate's three terms step by step inside its
``lax.scan``, the bias last). ``slstm_decode`` takes one step of the same
loop, so that a prompt stepped token by token and the forward agree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .module import dense_init, ones, rand, randn, zeros

F32 = torch.float32


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in f32 (the reference's ``preferred_element_type=F32``)."""
    return x.to(F32) @ w.to(F32)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory): chunked gated linear attention
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int
    head_dim: int
    chunk: int = 128


def init_mlstm(gen: torch.Generator, cfg: MLSTMConfig, *, device,
               dtype=F32) -> Dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    kw = dict(device=device, dtype=dtype)
    return {
        "wq": dense_init(gen, d, h * dh, **kw),
        "wk": dense_init(gen, d, h * dh, **kw),
        "wv": dense_init(gen, d, h * dh, **kw),
        "wi": dense_init(gen, d, h, **kw),     # input gate (per head)
        "wf": dense_init(gen, d, h, **kw),     # forget gate (per head)
        "wo": dense_init(gen, h * dh, d, **kw),
        "bi": zeros((h,), **kw),
        "bf": ones((h,), **kw),                # bias toward remembering
    }


def _mlstm_gates(p: Dict, x: torch.Tensor):
    i = _mm(x, p["wi"]) + p["bi"].to(F32)
    f = _mm(x, p["wf"]) + p["bf"].to(F32)
    return _log_sigmoid(i), _log_sigmoid(f)


def mlstm_forward(p: Dict, cfg: MLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """Chunkwise-parallel mLSTM, x [B, S, D] -> [B, S, D]: a loop over the
    chunks, each the intra-chunk attention ([B, Ck, Ck, H]) plus an
    O(H * Dh^2) state update. S need not be a multiple of the chunk: the
    input is zero-padded, as the reference pads it."""
    B, S, D = x.shape
    H, Dh, Ck = cfg.n_heads, cfg.head_dim, cfg.chunk
    nC = -(-S // Ck)
    pad = nC * Ck - S
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x

    q = (_mm(xp, p["wq"]).reshape(B, nC, Ck, H, Dh) / math.sqrt(Dh))
    k = _mm(xp, p["wk"]).reshape(B, nC, Ck, H, Dh)
    v = _mm(xp, p["wv"]).reshape(B, nC, Ck, H, Dh)
    log_i, log_f = _mlstm_gates(p, xp)                      # [B, S', H]
    log_i = log_i.reshape(B, nC, Ck, H)
    log_f = log_f.reshape(B, nC, Ck, H)
    tri = torch.tril(torch.ones(Ck, Ck, dtype=torch.bool,
                                device=x.device))[None, :, :, None]

    Cst = torch.zeros(B, H, Dh, Dh, dtype=F32, device=x.device)
    nst = torch.zeros(B, H, Dh, dtype=F32, device=x.device)
    hs = []
    # q_c, k_c, v_c [B, Ck, H, Dh]; li, lf [B, Ck, H]
    for q_c, k_c, v_c, li, lf in zip(*(t.unbind(1) for t in
                                       (q, k, v, log_i, log_f))):
        csum = torch.cumsum(lf, dim=1)
        total = csum[:, -1]                                 # [B, H]
        dec_q = torch.exp(csum)
        dec_k = torch.exp(total[:, None] - csum + li)
        # intra-chunk decay matrix and scores
        rel = csum[:, :, None, :] - csum[:, None, :, :] + li[:, None, :, :]
        Dmat = torch.where(tri, torch.exp(rel), 0.0)        # [B, Ck, Ck, H]
        scores = torch.einsum("bthd,bshd->btsh", q_c, k_c) * Dmat
        intra = torch.einsum("btsh,bshd->bthd", scores, v_c)
        norm_intra = scores.sum(dim=2)                      # [B, Ck, H]
        # inter-chunk, from the carried state
        qd = q_c * dec_q[..., None]
        inter = torch.einsum("bthd,bhde->bthe", qd, Cst)
        norm_inter = torch.einsum("bthd,bhd->bth", qd, nst)
        denom = torch.clamp_min(torch.abs(norm_inter + norm_intra),
                                1.0)[..., None]
        hs.append((intra + inter) / denom)                  # [B, Ck, H, Dh]
        # state update
        kd = k_c * dec_k[..., None]
        Cst = Cst * torch.exp(total)[:, :, None, None] + \
            torch.einsum("bshd,bshe->bhde", kd, v_c)
        nst = nst * torch.exp(total)[:, :, None] + kd.sum(dim=1)
    h = torch.stack(hs, dim=1).reshape(B, nC * Ck, H * Dh)[:, :S]
    return _mm(h.to(x.dtype), p["wo"]).to(x.dtype)


def init_mlstm_state(cfg: MLSTMConfig, batch: int, *, device) -> Dict:
    """The matrix memory C [B, H, Dh, Dh] and normaliser n [B, H, Dh], f32."""
    H, Dh = cfg.n_heads, cfg.head_dim
    return {"C": torch.zeros(batch, H, Dh, Dh, dtype=F32, device=device),
            "n": torch.zeros(batch, H, Dh, dtype=F32, device=device)}


def mlstm_decode(p: Dict, cfg: MLSTMConfig, x: torch.Tensor,
                 state: Dict) -> Tuple[torch.Tensor, Dict]:
    """x [B, 1, D]: one step of the gated state update."""
    B = x.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    q = _mm(x, p["wq"]).reshape(B, H, Dh) / math.sqrt(Dh)
    k = _mm(x, p["wk"]).reshape(B, H, Dh)
    v = _mm(x, p["wv"]).reshape(B, H, Dh)
    log_i, log_f = _mlstm_gates(p, x)                       # [B, 1, H]
    fi = torch.exp(log_f[:, 0])[..., None]                  # [B, H, 1]
    ii = torch.exp(log_i[:, 0])[..., None]
    C = state["C"] * fi[..., None] + \
        ii[..., None] * k[..., :, None] * v[..., None, :]
    n = state["n"] * fi + ii * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.clamp_min(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                          1.0)[..., None]
    h = (num / den).reshape(B, 1, H * Dh).to(x.dtype)
    return _mm(h, p["wo"]).to(x.dtype), {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, hidden-to-gate recurrence; block-diagonal heads)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int


# the four gates (input weight, recurrent weight, bias), in the order their
# pre-activations are laid side by side
_SLSTM_GATES = (("wz", "rz", "bz"), ("wi", "ri", "bi"), ("wf", "rf", "bf"),
                ("wo_gate", "ro", "bo"))


def init_slstm(gen: torch.Generator, cfg: SLSTMConfig, *, device,
               dtype=F32) -> Dict:
    d = cfg.d_model
    dh = d // cfg.n_heads
    kw = dict(device=device, dtype=dtype)

    def rinit():  # block-diagonal recurrent weights, per head [H, dh, dh]
        return (randn(gen, cfg.n_heads, dh, dh) / math.sqrt(dh)).to(**kw)

    return {
        "wz": dense_init(gen, d, d, **kw), "rz": rinit(),
        "wi": dense_init(gen, d, d, **kw), "ri": rinit(),
        "wf": dense_init(gen, d, d, **kw), "rf": rinit(),
        "wo_gate": dense_init(gen, d, d, **kw), "ro": rinit(),
        "bz": zeros((d,), **kw), "bi": zeros((d,), **kw),
        "bf": ones((d,), **kw), "bo": zeros((d,), **kw),
        "w_out": dense_init(gen, d, d, **kw),
    }


def _slstm_mats(p: Dict):
    """The four gates' input projections [D, 4D], biases [4D] and
    block-diagonal recurrent weights [D, 4D], side by side in f32."""
    W = torch.cat([p[w].to(F32) for w, _, _ in _SLSTM_GATES], dim=1)
    bias = torch.cat([p[b].to(F32) for _, _, b in _SLSTM_GATES])
    R = torch.cat([torch.block_diag(*p[r].to(F32))
                   for _, r, _ in _SLSTM_GATES], dim=1)
    return W, bias, R


def _slstm_step(g_t: torch.Tensor, R: torch.Tensor, carry: Tuple):
    """One step of the stabilised exponential-gated cell: g_t [B, 4D] the
    gates' input terms with their biases, carry (c, n, m, h) [B, D]."""
    c, n, m, h = carry
    B, D = h.shape
    pre = torch.addmm(g_t, h, R)                             # [B, 4D]
    pre_z, i_t, f_t, pre_o = pre.view(B, 4, D).unbind(1)
    z = torch.tanh(pre_z)
    o = torch.sigmoid(pre_o)
    log_f = _log_sigmoid(f_t)
    lf_m = log_f + m
    m_new = torch.maximum(lf_m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(lf_m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h = o * (c / torch.clamp_min(torch.abs(n), 1.0))
    return c, n, m_new, h


def slstm_forward(p: Dict, cfg: SLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]: the stabilised exponential-gated cell over
    the S steps, carrying (c, n, m, h) [B, D] in f32 from zeros.

    The loop is host-bound on a card (a kernel launch per op per step), so
    each step makes few launches: the four gates' input projections, with
    their biases, come from one product over all steps before the loop,
    taken apart by ``unbind`` (one gradient stack after the loop, not one
    per step), and their recurrent terms from one ``addmm`` with the
    block-diagonal weights laid out as one [D, 4D] matrix (the zeros off the
    blocks add nothing to a sum), taken apart by ``unbind`` too."""
    B, S, D = x.shape
    W, bias, R = _slstm_mats(p)
    gx = x.to(F32) @ W + bias                                # [B, S, 4D]
    carry = init_slstm_state(cfg, B, device=x.device)
    hs = []
    for g_t in gx.unbind(1):
        carry = _slstm_step(g_t, R, carry)
        hs.append(carry[3])
    hseq = torch.stack(hs, dim=1).to(x.dtype)
    return _mm(hseq, p["w_out"]).to(x.dtype)


def init_slstm_state(cfg: SLSTMConfig, batch: int, *, device) -> Tuple:
    """(c, n, m, h), each [B, D] f32 zeros."""
    return tuple(torch.zeros(batch, cfg.d_model, dtype=F32, device=device)
                 for _ in range(4))


def slstm_decode(p: Dict, cfg: SLSTMConfig, x: torch.Tensor,
                 state: Tuple) -> Tuple[torch.Tensor, Tuple]:
    """x [B, 1, D]: one step of ``slstm_forward``'s loop."""
    W, bias, R = _slstm_mats(p)
    carry = _slstm_step(x[:, 0].to(F32) @ W + bias, R, state)
    h = carry[3][:, None].to(x.dtype)
    return _mm(h, p["w_out"]).to(x.dtype), carry


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int          # recurrence width (Griffin uses ~4/3 * d_model)
    conv_width: int = 4
    c: float = 8.0      # recurrence sharpness constant


def init_rglru(gen: torch.Generator, cfg: RGLRUConfig, *, device,
               dtype=F32) -> Dict:
    d, dr = cfg.d_model, cfg.d_rnn
    kw = dict(device=device, dtype=dtype)
    # lambda so that a = exp(-c * softplus(L) * r) starts near 0.9..0.999;
    # log_lambda = softplus^-1(lam) stays f32 whatever the model's dtype
    lam = rand(gen, dr) * 0.5 + 0.3
    conv = randn(gen, cfg.conv_width, dr) * 0.1
    return {
        "w_x": dense_init(gen, d, dr, **kw),          # input branch
        "w_gate_branch": dense_init(gen, d, dr, **kw),
        "conv_w": conv.to(**kw),
        "conv_b": zeros((dr,), **kw),
        "w_rg": dense_init(gen, dr, dr, **kw),        # recurrence gate r_t
        "w_ig": dense_init(gen, dr, dr, **kw),        # input gate i_t
        "log_lambda": torch.log(torch.expm1(lam)).to(device),
        "w_out": dense_init(gen, dr, d, **kw),
    }


def _causal_conv1d(w: torch.Tensor, b: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in x's dtype, the taps summed in order from 0
    as the reference's Python ``sum``. x [B, S, Dr], w [W, Dr]."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along axis 1, as a
    log-depth (Hillis-Steele) scan: after the pass at offset d each element
    holds the composition of the 2d elements ending at it."""
    S = a.shape[1]
    d = 1
    while d < S:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return b


def _rglru_core(p: Dict, cfg: RGLRUConfig, u: torch.Tensor) -> torch.Tensor:
    """The gated diagonal recurrence; u [B, S, Dr] after the conv."""
    uf = u.to(F32)
    r = torch.sigmoid(uf @ p["w_rg"].to(F32))
    i = torch.sigmoid(uf @ p["w_ig"].to(F32))
    log_a = -cfg.c * F.softplus(p["log_lambda"].to(F32)) * r     # [B, S, Dr]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-6)) * (i * uf)
    return linear_scan(a, gated)


def rglru_forward(p: Dict, cfg: RGLRUConfig, x: torch.Tensor) -> torch.Tensor:
    xb = _mm(x, p["w_x"]).to(x.dtype)
    gb = F.gelu(_mm(x, p["w_gate_branch"]), approximate="tanh").to(x.dtype)
    u = _causal_conv1d(p["conv_w"], p["conv_b"], xb)
    h = _rglru_core(p, cfg, u)
    y = h.to(x.dtype) * gb
    return _mm(y, p["w_out"]).to(x.dtype)


def init_rglru_state(cfg: RGLRUConfig, batch: int, dtype=F32, *,
                     device) -> Dict:
    """The recurrence h [B, Dr] in f32 and the conv's last W - 1 inputs
    [B, W - 1, Dr] in ``dtype``."""
    return {"h": torch.zeros(batch, cfg.d_rnn, dtype=F32, device=device),
            "conv": torch.zeros(batch, cfg.conv_width - 1, cfg.d_rnn,
                                dtype=dtype, device=device)}


def rglru_decode(p: Dict, cfg: RGLRUConfig, x: torch.Tensor,
                 state: Dict) -> Tuple[torch.Tensor, Dict]:
    """x [B, 1, D]: the conv over the kept history and the new input (one
    f32 product, as the reference's decode takes it), then one step of
    the recurrence."""
    xb = _mm(x, p["w_x"]).to(x.dtype)
    gb = F.gelu(_mm(x, p["w_gate_branch"]), approximate="tanh").to(x.dtype)
    hist = torch.cat([state["conv"], xb], dim=1)             # [B, W, Dr]
    u = (torch.einsum("bwd,wd->bd", hist.to(F32), p["conv_w"].to(F32))
         + p["conv_b"].to(F32))[:, None].to(x.dtype)
    uf = u.to(F32)
    r = torch.sigmoid(uf @ p["w_rg"].to(F32))
    i = torch.sigmoid(uf @ p["w_ig"].to(F32))
    log_a = -cfg.c * F.softplus(p["log_lambda"].to(F32)) * r
    a = torch.exp(log_a)[:, 0]
    gated = (torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
             * (i * uf))[:, 0]
    h = a * state["h"] + gated
    y = h[:, None].to(x.dtype) * gb
    return _mm(y, p["w_out"]).to(x.dtype), {"h": h, "conv": hist[:, 1:]}
