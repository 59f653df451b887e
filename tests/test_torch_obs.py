"""The port's observability package (``repro_torch.obs``) against the JAX
package's ``repro.obs`` on the same seeded inputs, and the engine's
telemetry stream against the reference engine's.

  * the virtual clock's refusals (same ValueError texts), the JSONL sink's
    round trip (the same file, byte for byte), ``canonical_events`` and
    ``fingerprint``, ``log``'s stdout (bit-identical with and without an
    emitter), ``capture`` restoring the previous emitter;
  * ``P2Quantile`` / ``Summary`` values on seeded streams, and the
    ``summarize`` / ``render`` rollup of one event list (equal dicts,
    equal markdown);
  * the engine's stream: the same request sequence on the tiny ViT of
    ``tests/test_torch_sweep.py`` (JAX-initialised weights and the
    reference's global Fisher, bridged) through both packages' facades,
    each inside a capture — a cold layerwise forget, a warm one, a scanned
    forget, a K = 2 scanned ``forget_group`` and a K = 2 layerwise one. The
    two ``canonical_events`` lists must be EQUAL, field for field:
    ``program.compile``, ``program.hit`` (namespace, family, running
    counts) and ``engine.sweep`` (halt depths, mode, precision, build/hit
    deltas).
"""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import vision as JV  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.models import vision as TV  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402
from repro_torch.obs import telemetry as ttel  # noqa: E402

torch.set_num_threads(2)
TINY = dict(n_layers=4, d_model=32, n_heads=2, d_ff=64, n_classes=6,
            img_size=16, patch=4)


def _events(seed=0, n=60):
    """A seeded stream touching every kind the rollup reads."""
    rng = np.random.default_rng(seed)
    kinds = ("queue.enqueue", "queue.merge", "queue.reject", "queue.defer",
             "queue.depth", "drain.group", "drain.abort", "queue.requeue",
             "queue.dead_letter", "fault.inject", "program.compile",
             "program.hit", "engine.sweep", "fisher.refresh",
             "request.generate")
    out = []
    for i in range(n):
        kind = kinds[int(rng.integers(len(kinds)))]
        ev = {"seq": i, "t": i // 3, "kind": kind,
              "tenant": ["acme", "beta", None][int(rng.integers(3))],
              "depth": int(rng.integers(0, 9)),
              "n_requests": int(rng.integers(1, 4)),
              "ages": [int(a) for a in rng.integers(0, 7, 3)],
              "latency_s": float(rng.uniform(0, 2)),
              "n": int(rng.integers(1, 3)),
              "namespace": ["vit/6/False", "resnet/10/False"][i % 2],
              "stopped_at_l": [int(rng.integers(1, 7))],
              "tokens": int(rng.integers(0, 9)),
              "nested": {"wall_s": float(rng.uniform()), "k": i}}
        out.append(ev)
    return out


def _raises_same(fn_t, fn_j):
    with pytest.raises(ValueError) as got:
        fn_t()
    with pytest.raises(ValueError) as want:
        fn_j()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def test_virtual_clock_and_refusals_match_reference():
    for mod in (ttel, jtel):
        c = mod.VirtualClock()
        assert (c.now(), c.advance(), c.advance(2), c.advance_to(7)) == \
            (0, 1, 3, 7)
    for args in ((1.5,), (True,), ("3",)):
        _raises_same(lambda: ttel.VirtualClock(*args),
                     lambda: jtel.VirtualClock(*args))
    for meth, arg in (("advance_to", 3), ("advance_to", 2.0),
                      ("advance", -1), ("advance", 1.0)):
        tc, jc = ttel.VirtualClock(5), jtel.VirtualClock(5)
        _raises_same(lambda: getattr(tc, meth)(arg),
                     lambda: getattr(jc, meth)(arg))
    _raises_same(lambda: ttel.Telemetry(path=""),
                 lambda: jtel.Telemetry(path=""))
    _raises_same(lambda: ttel.Telemetry().emit(""),
                 lambda: jtel.Telemetry().emit(""))
    _raises_same(lambda: ttel.install(object()),
                 lambda: jtel.install(object()))
    assert ttel.NONDETERMINISTIC_KEYS == jtel.NONDETERMINISTIC_KEYS


def test_jsonl_round_trip_matches_reference(tmp_path):
    evs = _events()
    texts = {}
    for name, mod in (("t", ttel), ("j", jtel)):
        p = str(tmp_path / f"{name}.jsonl")
        clock = mod.VirtualClock()
        with mod.Telemetry(path=p, clock=clock) as tel:
            for ev in evs:
                clock.advance_to(ev["t"])
                tel.emit(ev["kind"], **{k: v for k, v in ev.items()
                                        if k not in ("seq", "t", "kind")},
                         arr=np.arange(3), scalar=np.float32(0.5))
        back = mod.read_jsonl(p)
        assert back == tel.events
        texts[name] = open(p).read()
    assert texts["t"] == texts["j"]
    (tmp_path / "bad.jsonl").write_text('{"a": 1}\nnot json\n')
    _raises_same(lambda: ttel.read_jsonl(str(tmp_path / "bad.jsonl")),
                 lambda: jtel.read_jsonl(str(tmp_path / "bad.jsonl")))


def test_canonical_events_and_fingerprint_match_reference():
    a, b = _events(0), _events(0)
    for ev in b:  # wall-clock fields differ, nothing else
        ev["latency_s"] += 1.0
        ev["nested"]["wall_s"] += 1.0
    assert ttel.canonical_events(a) == jtel.canonical_events(a)
    assert ttel.fingerprint(a) == jtel.fingerprint(a)
    assert ttel.fingerprint(a) == ttel.fingerprint(b)
    assert ttel.fingerprint(a) != ttel.fingerprint(_events(1))


def test_log_stdout_bit_identical_and_capture_restores():
    outs = []
    for mod in (ttel, jtel):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.log("serve", "batch 3: done")
            with mod.capture() as tel:
                mod.log("serve", "batch 3: done", batch=3)
        outs.append(buf.getvalue())
        assert tel.events[0]["kind"] == "log"
        assert tel.events[0]["batch"] == 3
    assert outs[0] == outs[1] == "[serve] batch 3: done\n" * 2
    assert ttel.emitter() is None
    with ttel.capture() as outer:
        assert ttel.emitter() is outer
        with ttel.capture() as inner:
            assert ttel.emitter() is inner
            ttel.emit("x")
        assert ttel.emitter() is outer
    assert ttel.emitter() is None
    assert ttel.emit("y") is None
    assert outer.events == [] and inner.counts == {"x": 1}


# ---------------------------------------------------------------------------
# metrics and the report
# ---------------------------------------------------------------------------
def test_p2_quantile_and_summary_match_reference():
    rng = np.random.default_rng(3)
    for n in (1, 3, 5, 6, 50, 1000):
        xs = rng.lognormal(size=n)
        for q in (0.1, 0.5, 0.9, 0.99):
            tq, jq = tobs.P2Quantile(q), jobs.P2Quantile(q)
            for x in xs:
                tq.update(x)
                jq.update(x)
            assert tq.value == jq.value, (n, q)
        for qs in (tobs.Summary.DEFAULT_QS, (0.25, 0.5, 0.99)):
            ts, js = tobs.Summary(qs), jobs.Summary(qs)
            for x in xs:
                ts.observe(x)
                js.observe(x)
            assert ts.to_dict() == js.to_dict()
            assert ts.quantile(0.5) == js.quantile(0.5)
    _raises_same(lambda: tobs.P2Quantile(1.0), lambda: jobs.P2Quantile(1.0))
    _raises_same(lambda: tobs.Summary().quantile(0.3),
                 lambda: jobs.Summary().quantile(0.3))
    _raises_same(lambda: tobs.Counter().inc(-1),
                 lambda: jobs.Counter().inc(-1))
    regs = []
    for mod in (tobs, jobs):
        r = mod.MetricsRegistry()
        r.counter("a").inc(3)
        r.gauge("g").set(2.5)
        r.gauge("g").set(-1)
        r.summary("s").observe(4.0)
        regs.append(r.to_dict())
    assert regs[0] == regs[1]


def test_summarize_and_render_match_reference(tmp_path):
    evs = _events(5, 200)
    for warm in (0, 20):
        got = treport.summarize(evs, warmup_t=warm)
        want = jobs.summarize(evs, warmup_t=warm)
        assert got == want
        assert treport.render(got) == jobs.render(want)
    ev = {"objectives": [{"objective": "p99", "target": 1.0, "actual": 0.5,
                          "ok": True}], "attained": 1.0, "ok": True}
    assert treport.render(got, ev, title="x") == jobs.render(want, ev,
                                                              title="x")
    with pytest.raises(ValueError):
        treport.summarize([{"kind": 3}])
    p = tmp_path / "ev.jsonl"
    p.write_text("".join(json.dumps(e) + "\n" for e in evs))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert treport.main([str(p), "--warmup-t", "20"]) == 0
    assert buf.getvalue() == jobs.render(jobs.summarize(evs, 20)) + "\n"


# ---------------------------------------------------------------------------
# the engine's stream
# ---------------------------------------------------------------------------
def test_engine_stream_equals_reference():
    jcfg = JV.ViTConfig(name="vit-t", **TINY)
    params = JV.init_vit(jax.random.PRNGKey(0), jcfg)
    x, y = jsyn.make_classification(jsyn.ClsDataConfig(
        n_classes=6, n_per_class=8, img_size=16, seed=0))
    i_d = jfisher.diag_fisher(
        lambda p, b: JV.cls_loss(JV.vit_forward(p, jcfg, b[0]), b[1]),
        params, (x, y), chunk_size=8)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tparams = bridge.params_to_torch(np_tree(params), device="cpu")
    sides = {
        "j": (JUnlearner(jadapters.vit_adapter(jcfg), i_d,
                         _spec(JSpec)), JRequest, params, jtel),
        "t": (Unlearner(tadapters.vit_adapter(TV.ViTConfig(name="vit-t",
                                                           **TINY),
                                              device="cpu"),
                        bridge.params_to_torch(np_tree(i_d), device="cpu"),
                        _spec(UnlearnSpec), device="cpu"),
              ForgetRequest, tparams, ttel),
    }
    group = [(x[:16], y[:16]), (x[16:32], y[16:32])]
    streams = {}
    for side, (unl, Req, prm, tel) in sides.items():
        scanned = unl.with_spec(_spec(type(unl.spec), sweep_mode="scanned"))
        with tel.capture() as t:
            unl.forget(Req(x[:16], y[:16]), params=prm)
            unl.forget(Req(x[:16], y[:16]), params=prm)
            scanned.forget(Req(x[:16], y[:16]), params=prm)
            scanned.forget_group([Req(*s) for s in group], params=prm)
            unl.forget_group([Req(*s) for s in group], params=prm)
        streams[side] = tel.canonical_events(t.events)
    got, want = streams["t"], streams["j"]
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    assert got == want
    kinds = [e["kind"] for e in got]
    assert kinds.count("engine.sweep") == 5
    sweeps = [e for e in got if e["kind"] == "engine.sweep"]
    assert [e["sweep_mode"] for e in sweeps] == \
        ["layerwise"] * 2 + ["scanned"] * 2 + ["layerwise"]
    assert sweeps[1]["compiles"] == 0 and sweeps[1]["cache_hits"] > 0
    assert {e["family"] for e in got if e["kind"] == "program.compile"} \
        == {"fused", "suffix", "partial", "sweep", "gfused"}


def _spec(cls, **kw):
    return cls.for_mode("ficabu", alpha=2.0, lam=1.0, tau=0.2,
                        checkpoint_every=2, chunk_size=8, **kw)
