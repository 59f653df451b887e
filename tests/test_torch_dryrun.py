"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``launch.roofline``): the reference's collective byte rules and terms at
equal peaks, the card's peaks, ``run_cell``'s records on FULL cells in fake
mode, the skipped cell and ``main``'s refusal (the counts themselves are
held in ``test_torch_dryrun_count.py``). The reference's ``dryrun`` module sets
XLA_FLAGS at import, so only its jax-free pieces are imported here
(``roofline``, ``configs``)."""
import math

import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as JRL
from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as TS

torch.set_num_threads(2)
CARD = "NVIDIA H100 80GB HBM3"

# the reference's record of a counted cell (dryrun.py run_cell) and its
# parts (roofline_terms, the collectives record)
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "status", "compile_full_s",
               "compile_probes_s", "n_params", "n_active_params", "memory",
               "cost", "collectives", "roofline"}
COLL_KEYS = {"bytes_per_device", "by_op_bytes", "by_op_counts_probe2",
             "extrapolated_periods"}
HLO = """
  %ag = bf16[4,1024]{1,0} all-gather(bf16[4,64]{1,0} %x), replica_groups={}
  %ar = f32[256]{0} all-reduce(f32[256]{0} %y), to_apply=%add
  %rs = f32[16,8]{1,0} reduce-scatter(f32[16,128]{1,0} %z), dimensions={1}
  %aa = (f32[2,4]{1,0}, f32[2,4]{1,0}) all-to-all(f32[2,4]{1,0} %a, f32[2,4]{1,0} %b)
"""
RECORDS = [("all-gather", ("bf16", (4, 1024))),
           ("all-reduce", (torch.float32, (256,))),
           ("reduce-scatter", ("f32", (16, 8))),
           ("all-to-all", [("f32", (2, 4)), (torch.float32, (2, 4))])]


def test_collective_stats_matches_the_reference():
    st = RL.collective_stats(RECORDS)
    assert st["by_op_bytes"]["all-gather"] == 4 * 1024 * 2
    assert st["by_op_bytes"]["all-reduce"] == 256 * 4 * 2   # 2x for AR
    assert st["by_op_counts"]["reduce-scatter"] == 1
    assert st["by_op_bytes"]["all-to-all"] == 2 * 2 * 4 * 4
    assert st == JRL.collective_stats(HLO)


def test_roofline_terms_match_the_reference_at_equal_peaks(monkeypatch):
    rates = RL.peaks(CARD)
    monkeypatch.setattr(JRL, "PEAK_FLOPS", rates["bf16"])
    monkeypatch.setattr(JRL, "HBM_BW", rates["hbm"])
    monkeypatch.setattr(JRL, "LINK_BW", rates["nvlink"])
    for cost, coll in (({"flops": 3.0e15, "bytes accessed": 1.0e12}, 4e9),
                       ({"flops": 1.0e12, "bytes accessed": 7.0e12}, 1e9),
                       ({"flops": 1.0e10, "bytes accessed": 1.0e9}, 9e11),
                       ({}, 0)):
        want = JRL.roofline_terms(cost, coll, 256, 1.5e17)
        got = RL.roofline_terms(cost, coll, 256, 1.5e17, card=CARD)
        assert {k: got[k] for k in want} == want
        assert got["card"] == CARD


def test_peaks_are_the_cards():
    """The H100 SXM's data-sheet rates (dense), the card named by the
    device name; no TPU v5e figure, and no default card."""
    r = RL.peaks(CARD)
    assert (r["bf16"], r["hbm"], r["nvlink"]) == (989e12, 3.35e12, 450e9)
    assert (r["f32"], r["tf32"], r["int8"]) == (67e12, 495e12, 1979e12)
    assert RL.peaks("NVIDIA H100 PCIe")["hbm"] == 2.0e12
    tpu = {JRL.PEAK_FLOPS, JRL.HBM_BW, JRL.LINK_BW}
    assert not tpu & {v for rates in RL.PEAKS.values()
                      for v in rates.values()}
    with pytest.raises(ValueError, match="no peak rates"):
        RL.peaks("TPU v5 lite")
    with pytest.raises(ValueError, match="card="):
        DR.card_of(None, "cpu")


def test_memory_summary_keeps_the_reference_keys():
    got = RL.memory_summary({"temp_size_in_bytes": 5, "output_size_in_bytes":
                             3.0, "argument_size_in_bytes": True,
                             "other": 1})
    assert got == {"temp_size_in_bytes": 5, "output_size_in_bytes": 3}


@pytest.fixture
def spy(monkeypatch):
    """The counts ``run_cell`` reads, as ``count_cell`` returned them."""
    seen = []
    real = DR.count_cell

    def wrapped(*a, **kw):
        cell, c = real(*a, **kw)
        seen.append((cell, c))
        return cell, c

    monkeypatch.setattr(DR, "count_cell", wrapped)
    return seen


@pytest.mark.parametrize("arch,shape", [("gemma3-1b", "decode_32k"),
                                        ("xlstm-125m", "prefill_32k")])
def test_run_cell_records_full_cells(spy, arch, shape):
    rec = DR.run_cell(arch, shape, False, card=CARD, device="cpu")
    assert RECORD_KEYS <= set(rec) and rec["status"] == "ok"
    assert (rec["mesh"], rec["chips"]) == ("16x16", 256)
    assert set(rec["collectives"]) == COLL_KEYS
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    want = JRL.roofline_terms({"flops": 1.0}, 1, 1, 1.0)
    assert set(want) <= set(rec["roofline"])
    t = rec["roofline"]
    assert all(math.isfinite(t[k]) and t[k] > 0 for k in
               ("compute_s", "memory_s", "collective_s",
                "step_time_bound_s"))
    assert t["card"] == CARD and t["dominant"] in ("compute", "memory",
                                                   "collective")
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    cell, c = spy[0]
    # the count holds every step: the scan correction is recorded, never
    # added
    assert rec["cost"]["flops"] == c["flops"] > 0
    assert (rec["count"]["scan_correction_flops_not_added"]
            == cell.scan_correction_flops)
    assert (rec["n_params"], cell.n_params) == (
        TS._param_counts(tconfigs.get(arch).full)[0],) * 2
    assert rec["count"]["rows_per_rank"] == (
        SHAPES[shape].global_batch // 16)
    if shape == "prefill_32k":
        assert cell.scan_correction_flops > 0
        assert "token positions" in rec["count"]["method"]


def test_multi_pod_record_is_a_shard_proof():
    rec = DR.run_cell("whisper-tiny", "decode_32k", True)
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
    assert rec["status"] == "ok" and "roofline" not in rec
    assert rec["count"]["rows_per_rank"] == 128 // 32


def test_skipped_cell():
    rec = DR.run_cell("yi-6b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == jconfigs.get("yi-6b").skip_shapes["long_500k"]


def test_main_requires_arch_and_shape(tmp_path):
    with pytest.raises(ValueError, match="--arch"):
        DR.main(["--out", str(tmp_path), "--device", "cpu"])
