"""The serving loop in the port (``repro_torch.launch.serve``) against the
JAX package's (``repro.launch.serve``):

  * ``generate`` on gemma3-1b-smoke (the reference's ``init_lm`` weights,
    bridged): 4 prompts of 8 tokens, 8 greedy tokens each. Held by logits,
    teacher-forced on the reference's tokens (the chunked prefill, then
    every ``decode_step``) at the decode files' rtol 1e-4 / atol 5e-5, and
    by tokens: equal, except at a position where the reference's top-2
    logit margin is below MARGIN (a near-tie that either side may break
    its own way; the rest of that row is then conditioned on another token
    and excused with it). The test states how many were excused (0 here);
  * ``ForgetService`` on the reference's tiny fleet LM ("fleet-t", weights
    carried by ``bridge``), bursts "1,2;3,2" due after batches 1 and 2, a
    streamed refresh after every drain: scanned and layerwise, fp32 here
    and int8 in ``tests/test_torch_serve_int8.py``. The group log
    (requests, sweeps, ``sweep_sig``, the engine's build / hit / launch
    counts and tags), every request's
    ``stopped_at_l`` and ``macs_vs_ssd_pct``, the refresh log and the
    staleness verdict EQUAL the reference's; the served tree within the LM
    files' tolerances (fp32: rtol 1e-4 / atol 1e-6 on >= 99.5% of each
    leaf, rtol 1e-2 on >= 99.9%; int8: bit-equal on >= 99.9% of each
    leaf), the Fisher within the Fisher tolerance;
  * ``main(["--device", "cpu", ..., "--check"])`` passes every gate, and
    each gate fires on a run that breaks it; ``--cache-dir`` raises "not
    ported yet" (``--serve-mode stream`` and ``--fleet`` are held in
    ``tests/test_torch_stream.py`` and ``tests/test_torch_fleet_main.py``);
  * the deprecation shim, ``default_serve_spec`` and ``_parse_bursts``
    equal the reference's.
"""
import argparse
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.api import ServeSpec as JServeSpec  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.api import ServeSpec, UnlearnSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402

torch.set_num_threads(2)
TINY = dict(name="fleet-t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64)
SEQ = 16
BURSTS = ((1, 2), (3, 2))
LOGITS = dict(rtol=1e-4, atol=5e-5)
MARGIN = 1e-3    # a top-2 logit margin below this is a near-tie


@pytest.fixture(scope="module")
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------
def test_generate_matches_reference():
    jcfg = jconfigs.get("gemma3-1b").smoke
    tcfg = configs.get("gemma3-1b").smoke
    jp = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    toks, _ = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=jcfg.vocab, n_domains=4, seq_len=16, n_per_domain=16, seed=0))
    prompts = toks[:4, :8]
    B, P, G = prompts.shape + (8,)
    jdec = jax.jit(lambda p, c, t, pos: JLM.decode_step(p, jcfg, t, c, pos))

    def tdec(p, c, t, pos):
        return LM.decode_step(p, tcfg, t, c, pos)

    want = jserve.generate(jp, jcfg, jnp.asarray(prompts), G, jdec,
                           prefill_block=8)
    tprompts = torch.as_tensor(prompts).long()
    got = serve.generate(tp, tcfg, tprompts, G, tdec, prefill_block=8)
    assert got.shape == want.shape == (B, G)
    # teacher-forced on the reference's tokens: the logits that chose each
    jl, jc = JLM.prefill(jp, jcfg, jnp.asarray(prompts),
                         JLM.init_cache(jcfg, B, P + G), block=8)
    with torch.no_grad():
        tl, tc = LM.prefill(tp, tcfg, tprompts,
                            LM.init_cache(tcfg, B, P + G, device="cpu"),
                            block=8)
    jlog, tlog = [np.asarray(jl[:, -1])], [tl[:, -1].numpy()]
    for j in range(G - 1):
        tok = want[:, j:j + 1]
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(P + j))
        with torch.no_grad():
            tl, tc = tdec(tp, tc, torch.as_tensor(tok).long(), P + j)
        jlog.append(np.asarray(jl[:, -1]))
        tlog.append(tl[:, -1].numpy())
    jlog, tlog = np.stack(jlog, 1), np.stack(tlog, 1)
    np.testing.assert_allclose(tlog, jlog, **LOGITS)
    assert (np.argmax(jlog, -1) == want).all()
    top2 = np.sort(jlog, -1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    excused = 0
    for b in range(B):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):
            assert margin[b, diff[0]] < MARGIN, (b, diff[0])
            excused += G - diff[0]
    assert excused == 0, f"{excused} positions excused as near-ties"


# ---------------------------------------------------------------------------
# ForgetService against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JLM.LMConfig(**TINY), LM.LMConfig(**TINY)
    toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=64, n_domains=4, seq_len=SEQ, n_per_domain=16, seed=0))
    jp = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return jcfg, tcfg, toks, doms, jp, tp


def _served(svc, params):
    for i, burst in enumerate(BURSTS):
        for d in burst:
            svc.submit(d, due_batch=1 + i)
    for idx in (1, 2, 3, float("inf")):
        params, _ = svc.drain(params, idx)
    return params


def _strip(entries):
    return [{k: v for k, v in e.items() if k != "latency_s"}
            for e in entries]


def _close(got, want, int8):
    a = bridge.paths(bridge.params_to_numpy(got))
    b = bridge.paths(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        assert np.isfinite(x).all(), k
        d = np.abs(x - y)
        if int8:
            assert (d == 0).mean() >= 0.999, (k, (d == 0).mean())
        else:
            assert (d <= 1e-6 + 1e-4 * np.abs(y)).mean() >= 0.995, k
            assert (d <= 1e-6 + 1e-2 * np.abs(y)).mean() >= 0.999, k


def _fisher_close(got, want):
    a = bridge.paths(bridge.params_to_numpy(got))
    b = bridge.paths(jax.tree_util.tree_map(np.asarray, want))
    for k in a:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        d = np.abs(x - y)
        assert (d <= 1e-9 + 1e-4 * np.abs(y)).mean() >= 0.999, k
        np.testing.assert_allclose(x, y, rtol=2e-3, atol=1e-9, err_msg=k)


def service_parity(tiny, mode, precision):
    """One ForgetService run on each side, held together (module
    docstring); ``tests/test_torch_serve_int8.py`` runs it in int8."""
    jcfg, tcfg, toks, doms, jp, tp = tiny
    kw = dict(chunk_size=4, refresh_every=1, sweep_mode=mode,
              precision=precision)
    svc = serve.ForgetService(tcfg, toks, doms, SEQ, serve=ServeSpec(**kw),
                              device="cpu")
    jsvc = jserve.ForgetService(jcfg, toks, doms, SEQ,
                                serve=JServeSpec(**kw))
    got, want = _served(svc, tp), _served(jsvc, jp)
    assert svc.spec.to_json() == jsvc.spec.to_json()
    assert _strip(svc.group_log) == _strip(jsvc.group_log)
    assert len(svc.group_log) == 2 and svc.sweeps == jsvc.sweeps == 2
    assert _strip(svc.log) == _strip(jsvc.log)
    assert _strip(svc.refresh_log) == _strip(jsvc.refresh_log)
    assert len(svc.refresh_log) == 2
    _close(got, want, precision == "int8")
    _fisher_close(svc.unlearner.fisher_global, jsvc.unlearner.fisher_global)
    st, jst = svc.staleness_report(got), jsvc.staleness_report(want)
    assert st["improved"] is jst["improved"] is True
    problems = serve.check_problems(svc, {"refreshes": 2, "staleness": st})
    assert problems == []
    for k in ("requests", "group_sweeps", "sweep_launches",
              "int8_sweep_launches", "refresh_compiles", "refresh_hits"):
        assert svc.unlearner.stats[k] == jsvc.unlearner.stats[k], k
    assert list(svc.queue) == list(jsvc.queue) == []


@pytest.mark.parametrize("mode", ["scanned", "layerwise"])
def test_forget_service_matches_reference(tiny, deterministic, mode):
    service_parity(tiny, mode, "fp32")


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
ARGS = ["--device", "cpu", "--requests", "4", "--prompt-len", "8",
        "--gen-len", "4", "--forget-domains", "1,2;3,2"]


@pytest.mark.parametrize("extra", [["--fisher-refresh", "1"],
                                   ["--precision", "int8"]],
                         ids=["refresh", "int8"])
def test_main_check_passes(deterministic, extra):
    r = serve.main(ARGS + extra + ["--check"])
    assert r["coalesced_groups"] == r["sweeps"] == 2
    assert [g["sweep_sig"] for g in r["group_log"]] == [[2, 8], [2, 8]]
    assert [g["engine"]["compiles"] for g in r["group_log"]][1] == 0
    assert len(r["served"]) == 3 and r["unlearned"]
    assert r["serve_spec"]["precision"] == r["unlearn_spec"]["exec"][
        "precision"]
    if "--fisher-refresh" in extra:
        assert r["fisher_refresh"]["refreshes"] == 2
        assert r["fisher_refresh"]["staleness"]["improved"]


def test_check_gates_fire():
    ok = {"group": 0, "batch": 1, "requests": 2, "sweep_sig": [2, 8],
          "sweeps": 1, "engine": {"compiles": 3, "sweep_mode": "scanned",
                                  "precision": "fp32", "sweep_launches": 1}}

    def view(groups, prec="fp32", refresh_log=(), launches8=1):
        return types.SimpleNamespace(
            group_log=groups, refresh_log=list(refresh_log),
            spec=UnlearnSpec.for_mode("ficabu", sweep_mode="scanned",
                                      precision=prec),
            unlearner=types.SimpleNamespace(
                stats={"int8_sweep_launches": launches8}),
            serve_spec=ServeSpec(refresh_every=1))

    assert serve.check_problems(view([ok]), None) == []
    bad = [
        [ok, dict(ok, group=1, engine=dict(ok["engine"], compiles=0))],
        [ok, dict(ok, group=1, batch=2)],                 # a seen sig built
        [dict(ok, engine=dict(ok["engine"], sweep_mode="layerwise"))],
        [dict(ok, engine=dict(ok["engine"], sweep_launches=2))],
        [dict(ok, engine=dict(ok["engine"], precision="int8"))],
    ]
    for groups in bad:
        assert len(serve.check_problems(view(groups), None)) == 1, groups
    assert len(serve.check_problems(
        view([dict(ok, engine=dict(ok["engine"], precision="int8"))],
             prec="int8", launches8=0), None)) == 1
    refresh = [{"engine": {"refresh_compiles": 1}},
               {"engine": {"refresh_compiles": 1}}]
    stale = {"stale_rel_err": 0.1, "refreshed_rel_err": 0.2,
             "improved": False}
    msgs = serve.check_problems(view([ok], refresh_log=refresh),
                                {"refreshes": 2, "staleness": stale})
    assert len(msgs) == 2
    assert len(serve.check_problems(view([ok]), {"refreshes": 0,
                                                 "staleness": None})) == 1


@pytest.mark.parametrize("flags,item", [
    (["--cache-dir"], "compilation_cache")], ids=["cache"])
def test_main_not_ported_yet(flags, item, tmp_path, monkeypatch):
    """``--cache-dir``, once refused here, is ported: the run reports the
    cache block (no library is built on the host; a warm start with a
    finished library in the dir passes the cold-start gate)."""
    from repro_torch.kernels import build as kbuild
    monkeypatch.setattr(kbuild, "_CACHE_DIR", None)
    monkeypatch.setattr(kbuild, "BUILD_DIR", kbuild.DEFAULT_BUILD_DIR)
    (tmp_path / "libficabu_dampen-0.so").write_bytes(b"")
    res = serve.main(ARGS + flags + [str(tmp_path), "--check"])
    assert res[item] == {"dir": str(tmp_path), "entries_before": 1,
                         "entries_new": 0}


def test_shim_default_spec_and_bursts_equal(tiny):
    jcfg, tcfg, toks, doms, _, _ = tiny
    assert serve.default_serve_spec(refresh_every=2).to_json() == \
        jserve.default_serve_spec(refresh_every=2).to_json()
    legacy = UnlearnSpec.for_mode("ficabu", chunk_size=2,
                                  sweep_mode="layerwise")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        svc = serve.ForgetService(tcfg, toks, doms, SEQ, legacy,
                                  device="cpu")
        jsvc = jserve.ForgetService(
            jcfg, toks, doms, SEQ,
            JSpec.for_mode("ficabu", chunk_size=2, sweep_mode="layerwise"))
    assert [x.category for x in w] == [DeprecationWarning] * 2
    assert svc.spec == legacy
    assert svc.serve_spec.to_json() == jsvc.serve_spec.to_json()
    assert serve.ForgetService.CHUNK == jserve.ForgetService.CHUNK
    with pytest.raises(ValueError, match="serve= must be"):
        serve.ForgetService(tcfg, toks, doms, SEQ, serve=3, device="cpu")
    for fd, co in (("1,2", False), ("1,2", True), ("1,2;3", False),
                   (None, False), ("4;;2,1", True)):
        a = argparse.Namespace(forget_domains=fd, coalesce=co,
                               forget_domain=3)
        assert serve._parse_bursts(a) == jserve._parse_bursts(a)
