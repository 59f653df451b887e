"""The engine's spans (``repro_torch.obs.telemetry.span``) on the CPU: the
same results and the same event stream with spans on and off, the no-op
without a capture, each sweep mode's span tree, the host-read counter,
and no device field off the card."""
from __future__ import annotations

import json

import pytest
import torch

from repro_torch.api import ForgetRequest, UnlearnSpec, Unlearner
from repro_torch.core import adapters
from repro_torch.models import lm as LM
from repro_torch.models.module import tree_leaves
from repro_torch.obs import telemetry as T

CFG = LM.LMConfig(name="spans", n_layers=4, d_model=32, n_heads=4,
                  n_kv_heads=2, d_ff=64, vocab=64)
L = CFG.n_layers + 2          # the embedding, the blocks, the head
CPU = torch.device("cpu")
# tau 1.0 halts at the first checkpoint (l = 1); -1 never halts
HALT, NEVER = 1.0, -1.0


@pytest.fixture(scope="module")
def lm():
    params = LM.init_lm(torch.Generator().manual_seed(0), CFG, device=CPU)
    toks = torch.randint(0, CFG.vocab, (8, 17),
                         generator=torch.Generator().manual_seed(1))
    x, y = toks[:, :-1], toks[:, 1:]
    ad = adapters.lm_adapter(CFG, 16, device=CPU)
    unl = Unlearner(ad, spec=UnlearnSpec.for_mode("ficabu"), device=CPU)
    fisher = unl.ensure_fisher(lambda p, b: LM.lm_loss(p, CFG, b[0], b[1]),
                               params, (x, y), chunk_size=4)
    return {"params": params, "x": x, "y": y, "adapter": ad,
            "fisher": fisher}


def _unlearner(lm, mode, tau, *, fisher=True):
    spec = UnlearnSpec.for_mode("ficabu", alpha=5.0, lam=1.0, tau=tau,
                                checkpoint_every=2, chunk_size=4,
                                sweep_mode=mode)
    unl = Unlearner(lm["adapter"], spec=spec, device=CPU)
    return unl.set_fisher(lm["fisher"]) if fisher else unl


def _forget(lm, mode, tau, *, spans, path=None):
    """One request on a fresh facade inside a capture; (params', stats,
    telemetry)."""
    unl = _unlearner(lm, mode, tau)
    with T.capture(path=path, spans=spans, device=CPU) as t:
        new, st = unl.forget(ForgetRequest(lm["x"], lm["y"]),
                             params=lm["params"])
    return new, st, t


def _children(spans, parent, name=None):
    return [s for s in spans if s["parent"] == parent["id"]
            and (name is None or s["name"] == name)]


def _one(spans, name):
    found = [s for s in spans if s["name"] == name]
    assert len(found) == 1, (name, found)
    return found[0]


@pytest.mark.parametrize("mode", ["layerwise", "scanned"])
@pytest.mark.parametrize("tau", [HALT, NEVER])
def test_results_and_stream_equal_with_spans_on_and_off(lm, mode, tau):
    off = _forget(lm, mode, tau, spans=False)
    on = _forget(lm, mode, tau, spans=True)
    assert off[1]["engine"]["sweep_mode"] == mode
    for a, b in zip(tree_leaves(off[0]), tree_leaves(on[0])):
        assert torch.equal(a, b)
    assert off[1] == on[1]
    assert off[2].spans == [] and on[2].spans
    assert T.fingerprint(off[2].events) == T.fingerprint(on[2].events)
    assert off[2].events and len(off[2].events) == len(on[2].events)


def test_span_is_the_shared_noop_without_a_span_capture(lm):
    assert T.emitter() is None
    a, b = T.span("forget"), T.span("read", l=1, what="acc")
    assert a is b and a is T._NO_SPAN
    with a:
        pass
    with T.capture() as t:
        assert T.span("collect") is a
        _unlearner(lm, "layerwise", HALT).forget(
            ForgetRequest(lm["x"], lm["y"]), params=lm["params"])
    assert t.spans == [] and t.span_log is None
    assert T.span("layer", l=1) is a


def _check_enclosed(spans):
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["host_start"] <= s["host_end"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["host_start"] <= s["host_start"] <= s["host_end"] \
                <= p["host_end"]
            assert s["req"] == p["req"]


@pytest.mark.parametrize("tau", [HALT, NEVER])
def test_layerwise_span_tree(lm, tau):
    _, st, t = _forget(lm, "layerwise", tau, spans=True)
    spans = t.spans
    fg = _one(spans, "forget")
    assert fg["parent"] is None
    assert [s["name"] for s in _children(spans, fg, "collect")] == ["collect"]
    stop = st["stopped_at_l"]
    assert stop == (1 if tau == HALT else L)
    layers = _children(spans, fg, "layer")
    assert [s["attrs"]["l"] for s in layers] == list(range(1, stop + 1))
    assert [s["attrs"]["j"] for s in layers] == [L - l
                                                 for l in range(1, stop + 1)]
    for s in layers:
        assert len(_children(spans, s, "vjp")) == 1
        assert len(_children(spans, s, "dampen")) == 1
        (r,) = _children(spans, s, "read")
        assert r["attrs"] == {"l": s["attrs"]["l"], "what": "n_sel"}
    ckpts = _children(spans, fg, "ckpt")
    assert [s["attrs"]["l"] for s in ckpts] == st["checkpoints_hit"]
    for s in ckpts:
        (r,) = _children(spans, s)
        assert r["name"] == "read" and r["attrs"]["what"] == "acc"
    reads = [s for s in spans if s["name"] == "read"]
    assert len(reads) == st["host_reads"] \
        == stop + len(st["checkpoints_hit"])
    assert {s["req"] for s in spans} == {fg["req"]}
    _check_enclosed(spans)


def test_scanned_span_tree_walks_past_the_halt(lm):
    _, st, t = _forget(lm, "scanned", HALT, spans=True)
    spans = t.spans
    assert st["stopped_at_l"] == 1 and st["host_reads"] == 1
    fg = _one(spans, "forget")
    layers = [s for s in spans if s["name"] == "layer"]
    assert [s["attrs"]["l"] for s in layers] == list(range(1, L + 1))
    for s in layers:
        assert len(_children(spans, s, "vjp")) == 1
        assert len(_children(spans, s, "dampen")) == 1
    # every checkpoint runs, the halted request's included
    assert [s["attrs"]["l"] for s in spans if s["name"] == "ckpt"] \
        == [1, 2, 4, L]
    (r,) = [s for s in spans if s["name"] == "read"]
    assert r["parent"] == fg["id"] and r["attrs"] == {"what": "table"}
    _check_enclosed(spans)


@pytest.mark.parametrize("mode", ["layerwise", "scanned"])
def test_no_device_field_on_the_cpu(lm, mode, tmp_path):
    path = str(tmp_path / "events.jsonl")
    _, _, t = _forget(lm, mode, NEVER, spans=True, path=path)
    keys = {k for s in t.spans for k in s}
    assert keys == {"name", "id", "parent", "req", "host_start", "host_end",
                    "attrs"}
    with open(path + ".spans.jsonl") as f:
        written = [json.loads(line) for line in f]
    assert written == t.spans
    assert len(T.read_jsonl(path)) == len(t.events)


def test_group_spans_and_reads(lm):
    unl = _unlearner(lm, "layerwise", NEVER)
    reqs = [ForgetRequest(lm["x"][:4], lm["y"][:4]),
            ForgetRequest(lm["x"][4:], lm["y"][4:])]
    with T.capture(spans=True, device=CPU) as t:
        _, stats_k, g = unl.forget_group(reqs, params=lm["params"])
    spans = t.spans
    fg = _one(spans, "forget")
    assert len(_children(spans, fg, "collect")) == 1
    reads = [s for s in spans if s["name"] == "read"]
    # per set: a selection count a layer and an accuracy a checkpoint
    assert len(reads) == g["host_reads"] \
        == sum(L + len(st["checkpoints_hit"]) for st in stats_k)
    ckpts = [s for s in spans if s["name"] == "ckpt"]
    assert sorted((s["attrs"]["k"], s["attrs"]["l"]) for s in ckpts) \
        == sorted((k, l) for k, st in enumerate(stats_k)
                  for l in st["checkpoints_hit"])
    _check_enclosed(spans)


def test_fisher_and_each_request_root_their_own_request(lm):
    unl = _unlearner(lm, "layerwise", HALT, fisher=False)
    with T.capture(spans=True) as t:
        unl.ensure_fisher(lambda p, b: LM.lm_loss(p, CFG, b[0], b[1]),
                          lm["params"], (lm["x"], lm["y"]), chunk_size=4)
        for _ in range(2):
            unl.forget(ForgetRequest(lm["x"], lm["y"]), params=lm["params"])
    roots = [s for s in t.spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["fisher_global", "forget", "forget"]
    assert [s["req"] for s in roots] == [0, 1, 2]
