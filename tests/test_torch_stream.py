"""The continuous-batching ``StreamEngine`` of the port
(``repro_torch.launch.serve``) against the JAX package's:

  * the cases of ``tests/test_stream.py`` on the port: ``generate``'s one
    transfer == a replica that reads every step; a shadow drain == the
    in-place drain bit for bit, with the atomic swap; the poisoned shadow
    (every token before the publication step equals the drain-free run,
    the poison shows after, one decode signature); a drain due at every
    step chaining bit for bit to the same drains in place; the stream ==
    batch ``generate``; a staggered stream deterministic;
  * the port's engine against the reference's on the same bridged weights,
    prompts and bursts: every sequence's tokens equal, and
    ``engine_fingerprint`` equal across the two packages;
  * a ``donate=True`` stream tenant: the live tree bit for bit as it was
    until its publication;
  * the per-row decode write past the cache (an idle slot keeps advancing
    its position): dropped as the reference's scatter drops it, in
    ``attention_decode`` (held against the reference's) and in an engine
    whose slots stay idle for more than ``S_max`` steps;
  * ``main([..., "--serve-mode", "stream", "--check"])`` in both
    packages: the sequences, tokens, steps, publications, aborts, dead
    letters, version, the one decode signature and the group log equal;
  * the decode-signature count sees a publication that changes a leaf's
    dtype, and each stream gate fires on a run that breaks it.

Runs under deterministic algorithms: each service computes its own
Fisher, and two runs are held bit for bit.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ServeSpec as JServeSpec  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import ServeSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import (ForgetService, StreamEngine,  # noqa: E402
                                      _trees_bitwise_equal,
                                      engine_fingerprint, generate)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.module import tree_map  # noqa: E402
from repro_torch.obs import telemetry as _t  # noqa: E402

torch.set_num_threads(2)
P, G = 8, 6
SEQ = P + G
TINY = dict(name="stream-t", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=64)


@pytest.fixture(scope="module", autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture(scope="module")
def cfg():
    return LM.LMConfig(**TINY)


@pytest.fixture(scope="module")
def data(cfg):
    """The reference's tokens and weights, bridged: (tokens, domains, the
    port's params, the reference's params)."""
    toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=cfg.vocab, n_domains=4, seq_len=SEQ, n_per_domain=8, seed=0))
    jp = JLM.init_lm(jax.random.PRNGKey(0), JLM.LMConfig(**TINY))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return toks, doms, tp, jp


def _strip(x):
    """Drop the wall-clock fields (``latency_s``) at any depth."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k != "latency_s"}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _decode(cfg):
    return lambda p, c, t, pos: LM.decode_step(p, cfg, t, c, pos)


def _svc(cfg, data, programs=None, **serve_kw):
    toks, doms = data[:2]
    return ForgetService(cfg, toks, doms, SEQ, programs=programs,
                         serve=ServeSpec(chunk_size=4, **serve_kw),
                         device="cpu")


def _run_stream(params, cfg, data, n_seq, svc=None, publish_lag=3):
    eng = StreamEngine(params, cfg, gen_len=G, prompt_len=P,
                       max_batch=4, admit_chunk=2,
                       publish_lag=publish_lag, service=svc, device="cpu")
    prompts = np.asarray(data[0][:, :P])
    for i in range(n_seq):
        eng.enqueue(i, prompts[i % len(prompts)])
    with _t.capture() as cap:
        out = eng.run()
    return eng, out, cap.events


# -- single-transfer generate -------------------------------------------------
def _generate_per_step_sync(params, cfg, prompts, gen_len, decode,
                            prefill_block=8):
    """A replica that reads the token on the host every step."""
    B, Plen = prompts.shape
    with torch.no_grad():
        cache = LM.init_cache(cfg, B, Plen + gen_len, device="cpu")
        logits, cache = LM.prefill(params, cfg, prompts, cache,
                                   block=prefill_block)
        out = []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for j in range(gen_len):
            out.append(tok.numpy()[:, 0])
            logits, cache = decode(params, cache, tok, Plen + j)
            tok = torch.argmax(logits[:, -1:], dim=-1)
    return np.stack(out, axis=1)


def test_generate_single_transfer_bit_exact(cfg, data):
    toks, _, params, _ = data
    prompts = torch.as_tensor(toks[:4, :P]).long()
    got = generate(params, cfg, prompts, G, _decode(cfg))
    want = _generate_per_step_sync(params, cfg, prompts, G, _decode(cfg))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- shadow sweep bit-exactness + atomic swap ---------------------------------
def test_shadow_sweep_bit_exact_and_atomic_swap(cfg, data):
    params = data[2]
    svc_a = _svc(cfg, data)
    svc_b = _svc(cfg, data, programs=svc_a._fleet.programs)

    svc_a.submit(1, due_batch=0)
    legacy, ran_a = svc_a.drain(params, 0)
    assert ran_a

    # shadow drain: the live pointer must not move until publication
    svc_b.install_params(params)
    shadow, ran_b = svc_b.run_shadow([1], 0)
    assert ran_b
    assert svc_b.params is params
    assert svc_b.params_version == 0
    assert _trees_bitwise_equal(shadow, legacy)

    svc_b.stage(shadow)
    assert svc_b.publish_staged(step=7)
    assert svc_b.params is shadow
    assert svc_b.params_version == 1
    assert not svc_b.publish_staged(step=8)

    svc_b.submit(3, due_batch=9)
    assert list(svc_b.queue) == [{"domain": 3, "due_batch": 9}]


# -- publication atomicity: the poisoned-shadow probe -------------------------
def test_publication_atomicity_poisoned_shadow(cfg, data):
    params = data[2]
    n_seq = 10
    _, ref, _ = _run_stream(params, cfg, data, n_seq)

    poisoned = tree_map(lambda a: torch.full_like(a, float("nan"))
                        if a.is_floating_point() else a, params)
    svc = _svc(cfg, data)
    svc.run_shadow = lambda payloads, step: (poisoned, True)
    svc.submit(1, due_batch=2)
    eng, got, events = _run_stream(params, cfg, data, n_seq, svc=svc)

    pubs = [e for e in events if e["kind"] == "params.publish"]
    assert len(pubs) == 1 and eng.publications == 1
    s_pub = pubs[0]["step"]
    assert s_pub == 2 + 3                  # fire step + publish_lag
    assert svc.params is poisoned and eng.params is poisoned

    admit_step = {}
    for e in events:
        if e["kind"] == "batch.admit":
            for sid in e["seqs"]:
                admit_step[sid] = e["step"]
    assert set(admit_step) == set(range(n_seq))
    poisoned_suffix_seen = False
    for sid in range(n_seq):
        pre = max(0, min(G, s_pub - admit_step[sid]))
        np.testing.assert_array_equal(got[sid][:pre], ref[sid][:pre])
        if pre < G and not np.array_equal(got[sid][pre:], ref[sid][pre:]):
            poisoned_suffix_seen = True
    assert poisoned_suffix_seen
    assert eng.decode_cache_size() == 1


# -- a drain between every decode step ----------------------------------------
def test_drain_every_step_chains_bit_exact(cfg, data):
    params = data[2]
    svc = _svc(cfg, data)
    for k in range(4):
        svc.submit(1 + (k % 2), due_batch=k)
    eng, got, events = _run_stream(params, cfg, data, 8, svc=svc,
                                   publish_lag=1)
    assert len(got) == 8
    assert svc.groups == 4
    assert eng.publications == 4 and svc.params_version == 4
    assert eng.decode_cache_size() == 1
    pubs = [e for e in events if e["kind"] == "params.publish"]
    assert [p["version"] for p in pubs] == [1, 2, 3, 4]

    svc2 = _svc(cfg, data, programs=svc._fleet.programs)
    rt2 = svc2._rt
    replay = params
    for g in svc.group_log:
        replay, ran = rt2.run_due(replay, g["domains"], g["batch"])
        assert ran
    assert _trees_bitwise_equal(svc.params, replay)


# -- stream vs batch generate + staggered determinism -------------------------
def test_stream_matches_batch_generate(cfg, data):
    toks, _, params, _ = data
    B = 4
    prompts = np.asarray(toks[:B, :P])
    ref = generate(params, cfg, torch.as_tensor(prompts).long(), G,
                   _decode(cfg))
    eng = StreamEngine(params, cfg, gen_len=G, prompt_len=P,
                       max_batch=B, admit_chunk=B, device="cpu")
    for i in range(B):
        eng.enqueue(i, prompts[i])
    got = eng.run()
    assert sorted(got) == list(range(B))
    for i in range(B):
        np.testing.assert_array_equal(got[i], ref[i])


def test_staggered_stream_deterministic(cfg, data):
    params = data[2]
    n_seq = 10
    runs = [_run_stream(params, cfg, data, n_seq) for _ in range(2)]
    (_, out_a, ev_a), (_, out_b, ev_b) = runs
    assert sorted(out_a) == list(range(n_seq))
    for sid in range(n_seq):
        np.testing.assert_array_equal(out_a[sid], out_b[sid])
    fp = [engine_fingerprint(ev) for ev in (ev_a, ev_b)]
    assert fp[0] == fp[1]


# -- against the reference's engine -------------------------------------------
def _jrun(jp, data, n_seq, bursts, lag):
    toks, doms = data[:2]
    jcfg = JLM.LMConfig(**TINY)
    svc = jserve.ForgetService(jcfg, toks, doms, SEQ,
                               serve=JServeSpec(chunk_size=4))
    for due, burst in bursts:
        for d in burst:
            svc.submit(d, due_batch=due)
    eng = jserve.StreamEngine(jp, jcfg, gen_len=G, prompt_len=P,
                              max_batch=4, admit_chunk=2, publish_lag=lag,
                              service=svc)
    prompts = np.asarray(toks[:, :P])
    for i in range(n_seq):
        eng.enqueue(i, prompts[i % len(prompts)])
    with jtel.capture() as cap:
        out = eng.run()
    return eng, svc, out, cap.events


def test_stream_engine_matches_reference(cfg, data):
    """Two bursts fired mid-stream, published at their deadlines, on the
    same bridged weights: every sequence's tokens and the engine-side event
    stream (its fingerprint) equal the reference's."""
    bursts, lag, n_seq = ((2, (1, 2)), (4, (3, 2))), 3, 12
    svc = _svc(cfg, data)
    for due, burst in bursts:
        for d in burst:
            svc.submit(d, due_batch=due)
    eng, got, events = _run_stream(data[2], cfg, data, n_seq, svc=svc,
                                   publish_lag=lag)
    jeng, jsvc, want, jevents = _jrun(data[3], data, n_seq, bursts, lag)
    assert sorted(got) == sorted(want) == list(range(n_seq))
    for sid in range(n_seq):
        np.testing.assert_array_equal(got[sid], np.asarray(want[sid]))
    assert (eng.step, eng.publications, eng.aborts) == \
        (jeng.step, jeng.publications, jeng.aborts) == (eng.step, 2, 0)
    assert engine_fingerprint(events) == jserve.engine_fingerprint(jevents)
    assert _strip(svc.group_log) == _strip(jsvc.group_log)
    assert svc.params_version == jsvc.params_version == 2


def test_donate_stream_tenant_leaves_live_tree_until_publication(cfg, data):
    """A tenant whose spec donates: until its drain publishes, the live
    tree the decode reads is bit for bit the tree it was installed with."""
    params = data[2]
    before = tree_map(lambda t: t.clone(), params)
    low = ServeSpec(chunk_size=4, publish="step").to_unlearn_spec()
    svc = _svc(cfg, data)
    svc._rt.spec = dataclasses.replace(
        low, exec=dataclasses.replace(low.exec, donate=True))
    svc.submit(1, due_batch=1)
    eng = StreamEngine(params, cfg, gen_len=G, prompt_len=P, max_batch=4,
                       admit_chunk=2, publish_lag=4, service=svc,
                       device="cpu")
    prompts = np.asarray(data[0][:, :P])
    for i in range(8):
        eng.enqueue(i, prompts[i])
    while eng.step < 5:
        eng.step_once()
        if eng.step <= 5:
            assert eng.publications == 0
            assert eng.params is params
            assert _trees_bitwise_equal(params, before)
    eng._pending_pubs[0][1].result()       # the sweep has run
    assert _trees_bitwise_equal(params, before)
    eng.step_once()                        # step 5: the deadline
    assert eng.publications == 1 and eng.params is not params
    assert _trees_bitwise_equal(params, before)
    assert not _trees_bitwise_equal(eng.params, before)
    eng.run()


# -- the per-row decode write past the cache ----------------------------------
@pytest.mark.parametrize("window", [0, 3], ids=["attn", "ring"])
def test_per_row_write_past_cache_dropped(window):
    """pos >= S_max in a row: the reference's scatter drops its k/v write
    (a ring wraps it); the port's ``attention_decode`` writes the same
    cache and the same outputs, and reads no index on the host."""
    rng = np.random.default_rng(0)
    B, S, D, H, KV, Dh = 5, 4, 16, 2, 1, 8
    kw = dict(d_model=D, n_heads=H, n_kv_heads=KV, head_dim=Dh,
              use_rope=True, causal=True, window=window)
    jcfg, tcfg = JL.AttnConfig(**kw), TL.AttnConfig(**kw)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.3 for k, s in (
        ("wq", (D, H * Dh)), ("wk", (D, KV * Dh)), ("wv", (D, KV * Dh)),
        ("wo", (H * Dh, D)))}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    size = min(S, window) if window else S
    cache = {k: rng.standard_normal((B, size, KV, Dh)).astype(np.float32)
             for k in ("k", "v")}
    pos = np.array([0, 3, 4, 7, 100], dtype=np.int32)
    jout, jc = JL.attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(pos))
    tcache = {k: torch.as_tensor(v) for k, v in cache.items()}
    tout, tc = TL.attention_decode(
        {k: torch.as_tensor(v) for k, v in p.items()}, tcfg,
        torch.as_tensor(x), tcache, torch.as_tensor(pos).long())
    for k in ("k", "v"):
        # the same slots written, with the same values (k/v within f32
        # rounding of the two packages' projections and RoPE)
        np.testing.assert_array_equal(tc[k].numpy() != cache[k],
                                      np.asarray(jc[k]) != cache[k])
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tcache[k].numpy(), cache[k])
    if not window:
        # rows past the cache left it as it was
        for r in (2, 3, 4):
            np.testing.assert_array_equal(tc["k"][r].numpy(), cache["k"][r])
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)


def test_slot_idle_longer_than_cache(cfg, data):
    """A pool whose second slot idles for more than S_max steps (its
    position runs past the cache of every "attn" layer while the first
    slot serves one sequence after another) serves every sequence exactly
    as ``generate`` does, the late ones in the long-idle slot too."""
    toks, _, params, _ = data
    prompts = np.asarray(toks[:6, :P])
    eng = StreamEngine(params, cfg, gen_len=G, prompt_len=P, max_batch=2,
                       admit_chunk=1, device="cpu")
    for i in range(4):
        eng.enqueue(i, prompts[i])
        while eng.pending or any(s is not None for s in eng.slot_seq):
            eng.step_once()
    assert int(eng.pos[1]) > 3 * G > SEQ        # idle past its cache
    eng.enqueue(4, prompts[4])
    eng.enqueue(5, prompts[5])
    got = eng.run()
    ref = generate(params, cfg, torch.as_tensor(prompts).long(), G,
                   _decode(cfg))
    for i in range(6):
        np.testing.assert_array_equal(got[i], ref[i])


# -- the command line and the stream gates ------------------------------------
CLI = ["--requests", "4", "--prompt-len", "8", "--gen-len", "4",
       "--forget-domains", "1,2;3,2"]


def test_stream_main_matches_reference():
    flags = CLI + ["--serve-mode", "stream", "--check"]
    got = serve.main(["--device", "cpu"] + flags)
    want = jserve.main(flags)
    for k in ("serve_mode", "sequences", "tokens", "steps", "publications",
              "drain_aborts", "dead_letters", "params_version",
              "decode_compile_signatures", "coalesced_groups", "sweeps",
              "unlearn_spec", "serve_spec"):
        assert got[k] == want[k], k
    assert (got["sequences"], got["publications"],
            got["decode_compile_signatures"]) == (12, 2, 1)
    assert _strip(got["group_log"]) == _strip(want["group_log"])



# -- the decode signature and the stream gates --------------------------------
def test_decode_signature_counts_a_dtype_change(cfg, data):
    params = data[2]
    eng = StreamEngine(params, cfg, gen_len=G, prompt_len=P, max_batch=2,
                       admit_chunk=2, device="cpu")
    prompts = np.asarray(data[0][:, :P])
    eng.enqueue(0, prompts[0])
    eng.step_once()
    eng.step_once()
    assert eng.decode_cache_size() == 1
    eng.params = tree_map(lambda t: t.to(torch.float64)
                          if t.dim() == 1 else t, params)
    eng.step_once()
    assert eng.decode_cache_size() == 2


def test_stream_check_gates_fire():
    def eng(sigs=1, pubs=2, aborts=0):
        return types.SimpleNamespace(decode_cache_size=lambda: sigs,
                                     publications=pubs, aborts=aborts)

    def svc(pending=0, dead=0):
        return types.SimpleNamespace(groups=2, scheduler=types.SimpleNamespace(
            pending=lambda: pending, dead=lambda: dead))

    results = {i: None for i in range(6)}
    assert serve.stream_check_problems(eng(), svc(), 6, results) == []
    for e, s, n in ((eng(), svc(), 7), (eng(sigs=2), svc(), 6),
                    (eng(pubs=1), svc(), 6), (eng(), svc(pending=1), 6),
                    (eng(aborts=1), svc(), 6), (eng(), svc(dead=2), 6)):
        assert len(serve.stream_check_problems(e, s, n, results)) == 1
    # without bursts, groups != publications is no fault
    assert serve.stream_check_problems(eng(pubs=0), svc(), 6, results,
                                       unlearn=False) == []
