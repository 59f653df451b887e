"""The query-chunked attention (``models/layers.py::_sdpa``) against the
reference's (``repro.models.layers._sdpa``), on the CPU.

Past 2 * Q_CHUNK = 1024 queries, a multiple of Q_CHUNK = 512, both
packages attend one block of 512 queries at a time against the whole of
k/v (``_sdpa_block`` with ``q_offset``), each block rematerialised in the
backward (``jax.checkpoint`` there, a non-reentrant
``torch.utils.checkpoint`` here). What must hold:

  * the forward and the vjp with respect to q, k and v at S = 1536 and
    2048: causal, causal with a window of 600 (its mask crosses the block
    boundaries), bidirectional, and grouped (G = H / KV = 2 and 4) — the
    output within rtol 1e-5 / atol 1e-5, each cotangent within atol 1e-5
    times its largest entry (both sides sum the softmax and the products
    in f32, in another order);
  * S = 1024 and 1100 take the unchunked block on both sides (no scan in
    the reference's program, no checkpoint in the port's);
  * the chunked backward keeps no tensor of B * H * Sq * Sk elements: a
    ``saved_tensors_hooks`` pack hook sees every tensor autograd saves
    outside the checkpoints, and none is that large (the unchunked block
    at the same S saves its probabilities, which the same hook catches);
  * one forget request of 1536-token sequences through ``Unlearner``, on a
    tiny qkv-bias LM (a "local" block of window 600 and an "attn" block,
    d_model 32, 4 heads over 2 KV heads; random weights with numpy, the
    biases too), against the reference's: ssd and a ficabu that halts
    partway, fp32, halting, checkpoints, the accuracy trace and the MACs
    EQUAL, the global Fisher and the edits within the declared tolerances
    of ``test_torch_lm_unlearn.py`` (the Fisher on all entries at atol
    1e-9, as in ``test_torch_dense_unlearn.py``); the scanned program equal
    to the layerwise loop bit for bit. Those two requests run under
    ``torch.use_deterministic_algorithms(True)``: past a few thousand
    tokens the CPU accumulates the embedding's gradient (the backward of
    the row gather) in an order that changes from run to run, so two
    layerwise requests of 4 x 1024 tokens already differ in the last bits
    of ``embed/w`` (measured; the card's accumulation is sorted).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_recurrent_unlearn import (  # noqa: E402
    BIT_KEYS, _assert_bulk_close, _assert_params_close, _jax_tree, _np_tree,
    _same_bits)

from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.core import fisher as tfisher  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
# (S, causal, window, H, KV)
FUNC_CASES = {
    "causal-1536": (1536, True, 0, 4, 2),
    "causal-2048": (2048, True, 0, 4, 2),
    "window600-1536": (1536, True, 600, 4, 2),
    "window600-2048": (2048, True, 600, 4, 1),
    "bidirectional-1536": (1536, False, 0, 2, 2),
    "bidirectional-2048-gqa": (2048, False, 0, 4, 1),
}


def _qkv(S, H, KV, B=1, Dh=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, n, Dh)).astype(np.float32)
            for n in (H, KV, KV, H)]


@pytest.mark.parametrize("case", FUNC_CASES)
def test_sdpa_forward_and_vjp_match_jax(case):
    S, causal, window, H, KV = FUNC_CASES[case]
    q, k, v, ct = _qkv(S, H, KV)
    out, vjp = jax.vjp(lambda a, b, c: JL._sdpa(a, b, c, jnp.float32, causal,
                                                window),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = TL._sdpa(tq, tk, tv, torch.float32, causal, window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    grads = torch.autograd.grad(got, (tq, tk, tv),
                                grad_outputs=torch.from_numpy(ct))
    for name, g, w in zip("qkv", grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("S", [1024, 1100, 1536])
def test_chunked_branch_taken_as_in_the_reference(S, monkeypatch):
    """The reference's chunk test, unchanged: only S = 1536 (> 2 * 512, a
    multiple of 512) scans blocks in the reference and checkpoints blocks
    in the port, one per 512 queries."""
    q, k, v, _ = _qkv(S, 4, 2)
    jaxpr = str(jax.make_jaxpr(lambda a, b, c: JL._sdpa(
        a, b, c, jnp.float32, True, 0))(q, k, v))
    chunked = S == 1536
    assert ("scan" in jaxpr) is chunked
    calls = []
    real = TL.checkpoint

    def counting(fn, *args, **kw):
        calls.append(args[-1])          # the block's q_offset
        return real(fn, *args, **kw)

    monkeypatch.setattr(TL, "checkpoint", counting)
    out = TL._sdpa(*(torch.from_numpy(a) for a in (q, k, v)), torch.float32,
                   True, 0)
    assert out.shape == (1, S, 4, 8)
    assert calls == ([0, 512, 1024] if chunked else [])


@pytest.mark.parametrize("chunked", [True, False])
def test_chunked_backward_saves_no_score_matrix(chunked):
    """What autograd keeps for the backward of attention over 2048
    queries: no tensor of B * H * Sq * Sk elements on the chunked path;
    the unchunked block keeps its probabilities (the hook's control)."""
    B, S, H, KV = 1, 2048, 4, 2
    q, k, v, ct = (torch.from_numpy(a) for a in _qkv(S, H, KV, B=B))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if chunked:
            out = TL._sdpa(q, k, v, torch.float32, True, 0)
        else:
            out = TL._sdpa_block(q, k, v, torch.float32, True, 0)
    torch.autograd.grad(out, (q, k, v), grad_outputs=ct)
    big = [n for n in saved if n >= B * H * S * S]
    assert bool(big) is not chunked, (chunked, max(saved))


# -- one forget request at S = 1536 ------------------------------------------
SEQ = 1536
TINY = dict(name="t-lm-chunked", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=64, block_pattern=("local", "attn"),
            window=600, qkv_bias=True)


@contextlib.contextmanager
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _spec(cls, mode, **kw):
    kw = {"tau": 0.0, **kw}
    return cls.for_mode(mode, alpha=6.0, lam=0.5, checkpoint_every=2,
                        chunk_size=2, use_kernel=cls is UnlearnSpec, **kw)


@pytest.fixture(scope="module")
def long_request():
    """The tiny qkv-bias LM (random weights with numpy: norm scales about
    1, the biases ~ N(0, 0.01), every other leaf ~ N(0, 1 / fan)) on both
    sides, its global Fisher on each, and a forget set of 4 sequences of
    1536 tokens labelled with the model's own argmax."""
    jcfg, tcfg = JLM.LMConfig(**TINY), TLM.LMConfig(**TINY)
    rng = np.random.default_rng(7)

    def draw(path, s):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name in ("bq", "bk", "bv"):
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(
            np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, jax.eval_shape(
        lambda: JLM.init_lm(jax.random.PRNGKey(0), jcfg)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = bridge.params_to_torch(tree, device="cpu")
    toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=64, n_domains=4, seq_len=SEQ, n_per_domain=8, seed=1))
    split = jsyn.lm_split_forget_retain(toks, doms, 1)
    jad = jadapters.lm_adapter(jcfg, SEQ)

    def labelled(seqs):
        x = seqs[:, :-1]
        return x, np.array(jnp.argmax(jad.forward_collect(
            params, jnp.asarray(x))[0], -1), np.int32)

    retain = labelled(split["retain"][:4])
    return {
        "jcfg": jcfg, "tcfg": tcfg, "params": params, "tparams": tparams,
        "jI": jfisher.diag_fisher(
            lambda p, b: JLM.lm_loss(p, jcfg, b[0], b[1]), params, retain,
            chunk_size=2),
        "tI": tfisher.diag_fisher(
            lambda p, b: TLM.lm_loss(p, tcfg, b[0], b[1]), tparams, retain,
            chunk_size=2, device="cpu"),
        "jadapter": jad,
        "tadapter": tadapters.lm_adapter(tcfg, SEQ, device="cpu"),
        "set": labelled(split["forget"][:4]),
    }


def test_long_request_fisher_matches_jax(long_request):
    s = long_request
    want, got = _jax_tree(s["jI"]), _np_tree(s["tI"])
    assert sorted(got) == sorted(want)
    assert "period_stack/0/mixer/bk" in want
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-12, bulk=0.999,
                       rtol_all=2e-3, atol_all=1e-9)


def test_long_request_matches_jax(long_request):
    """ssd, then a ficabu whose tau is the reference's forget accuracy at
    the middle checkpoint of a ficabu at tau = 0 (it halts partway), on
    both sides; the port's requests again as scanned programs."""
    s = long_request
    fx, fy = s["set"]
    L = s["tadapter"].n_layers
    junl = JUnlearner(s["jadapter"], s["jI"], _spec(JSpec, "ficabu"))
    _, jfull = junl.forget(JRequest(fx, fy), params=s["params"])
    trace = jfull["forget_acc_trace"]
    cases = {"ssd": ("ssd", {}),
             "ficabu-halt": ("ficabu", {"tau": trace[len(trace) // 2][1]})}
    tunl = Unlearner(s["tadapter"], s["tI"], _spec(UnlearnSpec, "ssd"),
                     device="cpu")
    for case, (mode, kw) in cases.items():
        jp, jst = junl.with_spec(_spec(JSpec, mode, **kw)).forget(
            JRequest(fx, fy), params=s["params"])
        tp, tst = tunl.with_spec(_spec(UnlearnSpec, mode, **kw)).forget(
            ForgetRequest(fx, fy), params=s["tparams"])
        for k in ("stopped_at_l", "checkpoints_hit", "forget_acc_trace",
                  "profile_S", "macs", "macs_ssd", "macs_vs_ssd_pct"):
            assert tst[k] == jst[k], (case, k, tst[k], jst[k])
        if case == "ssd":
            assert tst["stopped_at_l"] == L
        else:
            assert 1 <= tst["stopped_at_l"] < L, tst["forget_acc_trace"]
        _assert_params_close(s["params"], jp, tp)
        with _deterministic():
            lp, _ = tunl.with_spec(_spec(UnlearnSpec, mode, **kw)).forget(
                ForgetRequest(fx, fy), params=s["tparams"])
            sp, sst = tunl.with_spec(_spec(UnlearnSpec, mode,
                                           sweep_mode="scanned", **kw)
                                     ).forget(ForgetRequest(fx, fy),
                                              params=s["tparams"])
        assert sst["engine"]["sweep_mode"] == "scanned"
        _same_bits(sp, lp)
        for k in BIT_KEYS:
            assert sst[k] == tst[k], (case, k)
