"""The port's decode, prefill and cache forms against the reference's own
functions (``repro.models.layers`` / ``lm``), on the same weights and
inputs, on the CPU: the attention's decode step (one position for every
row or a position per row, a full cache or a sliding window's ring
buffer) and chunked prefill, and ``init_cache`` / ``decode_step`` /
``prefill`` / ``scatter_cache_rows`` of each LM family. This file holds
the attention families (dense local + global attention with tied
embeddings: gemma3-1b-smoke; GQA with q/k/v biases: qwen1.5-32b-smoke;
MoE: llama4-scout-17b-a16e-smoke); ``test_torch_decode_recurrent.py`` runs
the per-arch tests (``__all__``) again on the recurrent ones.

Each model is the reference's own initialisation (``init_lm`` from
PRNGKey(0)), bridged into the port; tokens, caches and activations come
from a numpy seed. Tolerances, per tensor (both sides f32, the products
and sums in another order in each framework):

  * the attention forms: outputs and caches at rtol 1e-5 / atol 1e-5;
  * ``decode_step`` token by token against the reference's, 12 steps:
    the logits at rtol 1e-4 / atol 5e-5 and every cache leaf at rtol 1e-4
    / atol 1e-5 after each step (a recurrent state carries the steps'
    rounding forward), and one step at a position per row the same;
  * ``prefill`` against the reference's prefill: the same bounds;
  * the port's prefill against its own token-by-token decode: rtol 1e-4 /
    atol 5e-5, NOT bit for bit (the reference pins that bit-exact, and on
    gemma3-1b-smoke it is not: ROADMAP Queue 3); ``last_only`` equals the
    last position of the full logits within atol 1e-6;
  * ``decode_step`` against the port's ``forward``: rtol 2e-2 / atol 2e-2,
    the reference's own test's bound (the MoE with a capacity that drops
    nothing, as there).

Exact: the cache trees' paths, shapes and dtypes against the reference's,
the wide / stepwise choice of the prefill, and ``scatter_cache_rows``
(a row past the pool's batch dropped, a negative one counted from the
end).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

torch.set_num_threads(2)
B, S = 2, 12
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_STEP = dict(rtol=1e-4, atol=5e-5)
TOL_CACHE = dict(rtol=1e-4, atol=1e-5)
# (arch, prompt length, prefill block): wide, ring-wrap (stepwise) and the
# families' own forms
ARCHS = ("gemma3-1b", "qwen1.5-32b", "llama4-scout-17b-a16e")
PREFILLS = {"gemma3-1b": [(12, 5), (20, 7)], "qwen1.5-32b": [(12, 5)],
            "llama4-scout-17b-a16e": [(10, 4)],
            "recurrentgemma-9b": [(12, 4)], "xlstm-125m": [(12, 6)]}
# the per-arch tests, which the recurrent file runs again on its archs
__all__ = ["test_cache_trees_equal_the_references",
           "test_decode_step_matches_jax",
           "test_decode_step_matches_forward",
           "test_prefill_matches_jax_and_tokenwise_decode"]


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(tree):
    """A cache tree of either package by path, as numpy."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return bridge.paths(jax.tree_util.tree_map(
            lambda t: t.numpy(), tree))
    return bridge.paths(jax.tree_util.tree_map(np.asarray, tree))


def _close_trees(got, want, **tol):
    got, want = _np(got), _np(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _model(arch):
    """(arch, reference config, port config, JAX params, port params)."""
    jcfg = jbase.get(arch).smoke
    tcfg = tconfigs.get(arch).smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return arch, jcfg, tcfg, params, tparams


def _tokens(cfg, n=S, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, n)).astype(np.int32)


# -- the attention's serving forms ----------------------------------------------
def _attn(window, kv=2, bias=False):
    kw = dict(qkv_bias=bias, window=window)
    jac = JL.AttnConfig(32, 4, kv, 8, **kw)
    tac = TL.AttnConfig(32, 4, kv, 8, use_rope=True, causal=True, **kw)
    rng = np.random.default_rng(11)
    p = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(
            np.float32),
        jax.eval_shape(lambda: JL.init_attention(jax.random.PRNGKey(0), jac)))
    return jac, tac, jax.tree_util.tree_map(jnp.asarray, p), \
        bridge.params_to_torch(p, device="cpu")


@pytest.mark.parametrize("window", [0, 4], ids=["full", "ring"])
def test_attention_decode_matches_jax(window):
    """Ten steps at one position for every row (the ring buffer of 4
    slots wraps twice), then one step at a position per row on a cache of
    random contents: the outputs and the caches after each step."""
    jac, tac, jp, tp = _attn(window)
    jc = JL.init_kv_cache(jac, B, 10, jnp.float32)
    tc = TL.init_kv_cache(tac, B, 10, torch.float32, device="cpu")
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape) == \
        (B, 4 if window else 10, 2, 8)
    xs = np.random.default_rng(12).normal(size=(10, B, 1, 32)).astype(
        np.float32)
    for i, x in enumerate(xs):
        jo, jc = JL.attention_decode(jp, jac, _j(x), jc, jnp.int32(i))
        to, tc = TL.attention_decode(tp, tac, _t(x), tc, i)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        _close_trees(tc, jc, **TOL)
    rng = np.random.default_rng(13)
    cache = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in _np(jc).items()}
    pos = np.array([7, 2], np.int32)
    jo, jn = JL.attention_decode(jp, jac, _j(xs[0]),
                                 jax.tree_util.tree_map(jnp.asarray, cache),
                                 _j(pos))
    tcache = {k: _t(v) for k, v in cache.items()}
    to, tn = TL.attention_decode(tp, tac, _t(xs[0]), tcache, _t(pos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _close_trees(tn, jn, **TOL)
    for k, v in cache.items():   # the caller's cache is left as it was
        np.testing.assert_array_equal(tcache[k].numpy(), v)


@pytest.mark.parametrize("bias", [False, True], ids=["plain", "qkv-bias"])
def test_attention_prefill_matches_jax(bias):
    """A chunk of 4 tokens at positions 3..6 against a cache of 10 slots of
    random contents: the outputs and the written cache."""
    jac, tac, jp, tp = _attn(0, bias=bias)
    rng = np.random.default_rng(14)
    cache = {k: rng.normal(size=(B, 10, 2, 8)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.normal(size=(B, 4, 32)).astype(np.float32)
    jo, jn = JL.attention_prefill(jp, jac, _j(x), jax.tree_util.tree_map(
        jnp.asarray, cache), jnp.int32(3))
    to, tn = TL.attention_prefill(tp, tac, _t(x),
                                  {k: _t(v) for k, v in cache.items()}, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _close_trees(tn, jn, **TOL)


# -- the LM families ---------------------------------------------------------------
def test_cache_trees_equal_the_references(model):
    arch, jcfg, tcfg, _, _ = model
    for bt in dict.fromkeys(tcfg.layer_types):
        want = JLM.init_block_cache(jcfg, bt, B, S)
        got = TLM.init_block_cache(tcfg, bt, B, S, device="cpu")
        _close_trees(got, want, rtol=0, atol=0)
    _close_trees(TLM.init_cache(tcfg, B, S, device="cpu"),
                 JLM.init_cache(jcfg, B, S), rtol=0, atol=0)


def test_decode_step_matches_jax(model):
    """Token by token from an empty cache (one position for every row),
    then one step with a position per row."""
    arch, jcfg, tcfg, jp, tp = model
    tok = _tokens(tcfg)
    jdec = jax.jit(lambda p, c, t, pos: JLM.decode_step(p, jcfg, t, c, pos))
    jc = JLM.init_cache(jcfg, B, S + 1)
    tc = TLM.init_cache(tcfg, B, S + 1, device="cpu")
    for i in range(S):
        jl, jc = jdec(jp, jc, _j(tok[:, i:i + 1]), jnp.int32(i))
        tl, tc = TLM.decode_step(tp, tcfg, _t(tok[:, i:i + 1]).long(), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **TOL_STEP)
        _close_trees(tc, jc, **TOL_CACHE)
    pos = np.array([S, S - 3], np.int32)
    jl, jc = jdec(jp, jc, _j(tok[:, :1]), _j(pos))
    tl, tc = TLM.decode_step(tp, tcfg, _t(tok[:, :1]).long(), tc, _t(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_STEP)
    _close_trees(tc, jc, **TOL_CACHE)


def test_decode_step_matches_forward(model):
    """The reference's own check on the port: tokenwise decode == forward
    within 2e-2 (an MoE at a capacity that drops nothing)."""
    arch, _, tcfg, _, tp = model
    if tcfg.moe is not None:
        tcfg = tcfg.with_(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=float(tcfg.moe.num_experts)))
    tok = _t(_tokens(tcfg)).long()
    full, _ = TLM.forward(tp, tcfg, tok)
    cache = TLM.init_cache(tcfg, B, S, device="cpu")
    outs = []
    for i in range(S):
        lg, cache = TLM.decode_step(tp, tcfg, tok[:, i:i + 1], cache, i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_prefill_matches_jax_and_tokenwise_decode(model):
    arch, jcfg, tcfg, jp, tp = model
    for P, blk in PREFILLS[arch]:
        tok = _tokens(tcfg, P, seed=P)
        S_max = P + 4
        tc0 = TLM.init_cache(tcfg, B, S_max, device="cpu")
        wide = P <= TLM._min_attn_cache(tcfg, tc0)
        assert wide == (P <= JLM._min_attn_cache(jcfg, JLM.init_cache(
            jcfg, B, S_max)))
        if arch == "gemma3-1b":
            assert wide == (P == 12)
        jl, jc = JLM.prefill(jp, jcfg, _j(tok), JLM.init_cache(jcfg, B, S_max),
                             block=blk, last_only=False)
        tl, tc = TLM.prefill(tp, tcfg, _t(tok).long(), tc0, block=blk,
                             last_only=False)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_STEP)
        _close_trees(tc, jc, **TOL_CACHE)
        # against the port's own token-by-token decode
        dc = TLM.init_cache(tcfg, B, S_max, device="cpu")
        outs = []
        for i in range(P):
            lg, dc = TLM.decode_step(tp, tcfg, _t(tok[:, i:i + 1]).long(),
                                     dc, i)
            outs.append(lg)
        np.testing.assert_allclose(tl.numpy(), torch.cat(outs, 1).numpy(),
                                   **TOL_STEP)
        _close_trees(tc, dc, **TOL_CACHE)
        last, _ = TLM.prefill(tp, tcfg, _t(tok).long(),
                              TLM.init_cache(tcfg, B, S_max, device="cpu"),
                              block=blk)
        assert last.shape == (B, 1, tcfg.vocab)
        np.testing.assert_allclose(last.numpy(), tl[:, -1:].numpy(),
                                   rtol=0, atol=1e-6)
        # the caller's cache is left as it was
        assert all(not t.any() for t in jax.tree_util.tree_leaves(tc0))


def test_scatter_cache_rows_matches_jax():
    """A pool of 4 rows and a sub-batch of 3 (rows 2, -1 and 9: the last
    past the pool, dropped) on gemma3-1b-smoke's period_stack and tail."""
    arch, jcfg, tcfg, _, _ = _model("gemma3-1b")
    rng = np.random.default_rng(21)
    rand = lambda t: rng.normal(size=t.shape).astype(np.float32)  # noqa
    pool = jax.tree_util.tree_map(rand, JLM.init_cache(jcfg, 4, 6))
    sub = jax.tree_util.tree_map(rand, JLM.init_cache(jcfg, 3, 6))
    rows = np.array([2, -1, 9], np.int32)
    want = JLM.scatter_cache_rows(jax.tree_util.tree_map(jnp.asarray, pool),
                                  jax.tree_util.tree_map(jnp.asarray, sub),
                                  _j(rows))
    tpool = jax.tree_util.tree_map(_t, pool)
    got = TLM.scatter_cache_rows(tpool, jax.tree_util.tree_map(_t, sub),
                                 _t(rows))
    _close_trees(got, want, rtol=0, atol=0)
    assert sorted(got) == ["period_stack", "tail"]
    for k, v in bridge.paths(pool).items():   # the pool is left as it was
        np.testing.assert_array_equal(bridge.paths(tpool)[k].numpy(), v)
