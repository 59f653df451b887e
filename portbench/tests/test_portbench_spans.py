"""``lib/spans.py`` against counts made by hand: the busy time inside a
span (the union of operations, clipped at its edges), nested spans, the
work past a request's halt, and idle gaps named by the innermost span;
and ``tools/span_phase.py`` on the host over the SMOKE cells."""
from __future__ import annotations

import importlib.util
import json

import pytest

from support_portbench import ROOT
from portbench.lib import spans as SP
from portbench.lib import trace

# device operations: (name, start, end) on the host's clock
OPS = [("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 4.0, 5.0), ("d", 6.0, 6.5),
       ("e", 6.2, 6.4), ("f", 8.0, 9.0)]


def _span(i, name, t0, t1, *, parent=None, req=0, dev=None, **attrs):
    d0, d1 = dev if dev is not None else (t0, t1)
    return {"name": name, "id": i, "parent": parent, "req": req,
            "host_start": t0, "host_end": t1, "attrs": attrs,
            "dev_start": d0, "dev_end": d1, "dev_ms": 1e3 * (d1 - d0)}


def test_busy_is_the_union_clipped_at_the_edges():
    busy = SP.Busy(OPS)
    # merged: [1, 3], [4, 5], [6, 6.5], [8, 9]
    assert busy.starts == [1.0, 4.0, 6.0, 8.0]
    assert busy.ends == [3.0, 5.0, 6.5, 9.0]
    assert busy.between(0.0, 10.0) == pytest.approx(4.5)
    assert busy.between(2.5, 4.5) == pytest.approx(1.0)
    assert busy.between(3.0, 4.0) == 0.0            # a gap alone
    assert busy.between(6.1, 6.3) == pytest.approx(0.2)   # inside overlaps
    assert busy.between(5.0, 5.0) == 0.0
    assert busy.between(9.5, 9.0) == 0.0
    # the same union as the window's reduction
    red = trace.reduce_ops(OPS, 0.0, 10.0, [], trace.load_classes())
    assert red["busy_s"] == pytest.approx(busy.between(0.0, 10.0))


def test_busy_by_name_nested_and_clipped_to_the_window():
    spans = [
        _span(0, "forget", 0.5, 7.0),
        _span(1, "collect", 0.9, 2.5, parent=0),
        _span(2, "layer", 2.5, 6.8, parent=0, l=1, j=3),
        _span(3, "vjp", 2.5, 4.5, parent=2),
        _span(4, "dampen", 4.5, 6.3, parent=2),
        _span(5, "read", 6.3, 6.8, parent=2, l=1, what="n_sel"),
        _span(6, "forget", 7.5, 9.5, req=1),
        _span(7, "labels", 7.6, 8.5, req=1),
    ]
    got = SP.busy_by_name(OPS, spans, 0.0, 10.0)
    assert got["forget"] == pytest.approx(2.0 + 1.0 + 0.5 + 1.0)
    assert got["collect"] == pytest.approx(1.5)
    assert got["layer"] == pytest.approx(0.5 + 1.0 + 0.5)
    # a parent's busy time is its children's where they tile it
    assert got["layer"] == pytest.approx(
        got["vjp"] + got["dampen"] + got["read"])
    assert got["labels"] == pytest.approx(0.5)
    # the window clips a span: the second request's forget ends at 8.5
    clipped = SP.busy_by_name(OPS, spans, 7.2, 8.5)
    assert clipped["forget"] == pytest.approx(0.5)
    assert clipped["collect"] == 0.0


def test_a_span_without_device_times_counts_nothing():
    s = _span(0, "vjp", 0.0, 10.0)
    for k in ("dev_start", "dev_end", "dev_ms"):
        del s[k]
    assert SP.busy_by_name(OPS, [s], 0.0, 10.0) == {"vjp": 0.0}


def test_past_halt_takes_layers_and_checkpoints_beyond_the_stop():
    spans = [
        _span(0, "forget", 0.0, 10.0),
        _span(1, "layer", 0.9, 3.5, parent=0, l=1),
        _span(2, "ckpt", 3.5, 3.9, parent=0, l=1),
        _span(3, "layer", 3.9, 5.5, parent=0, l=2),
        _span(4, "ckpt", 5.5, 7.0, parent=0, l=2),
        _span(5, "read", 7.0, 7.5, parent=0, what="table"),
        _span(6, "forget", 7.5, 10.0, req=1),
        _span(7, "layer", 7.5, 10.0, parent=6, req=1, l=2),
    ]
    # request 0 halted at l = 1: its l = 2 layer and checkpoint are waste
    assert SP.past_halt(OPS, spans, 0.0, 10.0, {0: 1}) \
        == pytest.approx(1.0 + 0.5)
    assert SP.past_halt(OPS, spans, 0.0, 10.0, {0: 2}) == 0.0
    # request 1 halted at l = 1 too; one not in the map counts nothing
    assert SP.past_halt(OPS, spans, 0.0, 10.0, {0: 1, 1: 1}) \
        == pytest.approx(1.5 + 1.0)


def test_gap_names_from_the_innermost_span():
    spans = [
        _span(0, "forget", 1.0, 9.0),
        _span(1, "layer", 1.0, 3.2, parent=0, l=3, j=1),
        _span(2, "read", 3.0, 3.2, parent=1, l=3, what="n_sel"),
        _span(3, "ckpt", 3.4, 5.8, parent=0, l=2),
        _span(4, "a_span_with_a_long_name", 5.8, 6.0, parent=0, l=12),
    ]
    harness = [(0.5, "labels"), (1.0, "forget"), (9.0, "sync"),
               (9.1, "between requests")]
    ph = SP.phases(harness, spans)
    assert [n for _, n in ph] == [
        "labels", "forget", "forget", "layer@l3", "read@l3", "layer@l3",
        "forget", "ckpt@l2", "forget", "a_span_with_a_lo", "forget",
        "sync", "sync", "between requests"]
    assert all(len(n) <= SP.LABEL_CHARS for _, n in ph
               if n not in ("between requests",))
    ops = [("gemm", 1.0, 3.1), ("acc", 3.6, 5.0), ("gemm", 9.2, 9.5)]
    red = trace.reduce_ops(ops, 0.5, 9.5, ph, trace.load_classes())
    gaps = dict(red["idle_gaps"])
    assert gaps["host labels, after window start"] == pytest.approx(0.5)
    assert gaps["host read@l3, after gemm"] == pytest.approx(0.5)
    assert gaps["host ckpt@l2, after acc"] == pytest.approx(4.2)
    # every gap by its phase alone
    assert SP.idle_by_phase(ops, 0.5, 9.5, ph) == pytest.approx(
        {"labels": 0.5, "read@l3": 0.5, "ckpt@l2": 4.2})
    assert sum(SP.idle_by_phase(ops, 0.5, 9.5, ph).values()) \
        == pytest.approx(9.0 - red["busy_s"])
    # a top-level span's end hands back to the harness's phase
    ph2 = SP.phases([(0.0, "forget")], [_span(0, "forget", 1.0, 2.0)])
    assert ph2 == [(0.0, "forget"), (1.0, "forget"), (2.0, "forget")]


@pytest.mark.parametrize("cell, reads", [("cell_yi_smoke", 1),
                                         ("cell_qwen_smoke", 7)])
def test_span_phase_on_the_host(smoke_root, cell, reads, capsys):
    spec = importlib.util.spec_from_file_location(
        "span_phase", ROOT / "tools" / "span_phase.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rc = tool.main(["--workload", cell, "--seed", "2147483999", "--seconds",
                    "0.4", "--device", "cpu", "--root", str(smoke_root)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] and res["requests"] >= 1
    # the scanned program reads once; the layerwise loop a selection count
    # a layer (4) and an accuracy a checkpoint (l = 1, 2, 4)
    assert set(res["host_reads_per_req"]) == {reads}
    assert 0 < res["setup_fisher_s"] < res["setup_s"]
    assert 0 < res["setup_warmup_s"] < res["setup_s"]
    assert 0 < res["setup_before_program_s"] < res["setup_s"]
    # no device number off the card
    assert "dev_ms_per_req" not in res and "busy_ms_per_req" not in res
