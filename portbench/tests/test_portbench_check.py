"""The plain reference against ``Unlearner.forget`` at the SMOKE sizes of
yi-6b and qwen1.5-32b on the CPU, through the harness: halt depth,
checkpoints and edits within the cells' limits, and the result line's
keys."""
from __future__ import annotations

import pytest

from support_portbench import run_smoke

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["cell_yi_smoke", "cell_qwen_smoke"])
def test_reference_agrees_with_the_port(smoke_root, cell):
    line, checks = run_smoke(smoke_root, cell, 2 ** 31 + 977, seconds=1.5)
    assert list(line) == KEYS
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert set(line["checks"]) == {"label_gap", "flip_rate",
                                   "flip_rate_median", "edit_gap",
                                   "edit_gap_median", "mismatches"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    assert checks[-1].startswith("check mismatches 0.0 limit 0.0")
    assert set(line["metrics"]) == {"forget_tokens_per_s", "forget_p95_s",
                                    "setup_s"}
    assert line["metrics"]["forget_tokens_per_s"]["unit"] == "tokens/s"
    assert line["device"]["count"] == 1


def test_same_seed_same_requests(smoke_root):
    """One seed's weights, data and first request are the same in every
    run, bit for bit (a window's request count follows the host's speed,
    so whole runs are not compared)."""
    import torch

    from portbench.lib import bench, traffic, weights
    from portbench.loops.forget import Program

    cell = bench.load_cell(smoke_root, "cell_yi_smoke")
    outs = []
    for _ in range(2):
        p0 = weights.make_params(cell.dims, 5, "cpu")
        data = traffic.run_data(cell.spec, 5)
        prog = Program(cell, torch.device("cpu"))
        retain = torch.as_tensor(data.retain)
        prog.global_fisher(p0, retain, prog.labels(p0, retain))
        x = torch.as_tensor(data.pool[0])
        new, st = prog.forget(p0, x, prog.labels(p0, x))
        outs.append((dict(weights.leaf_items(new)), st))
    (a, sa), (b, sb) = outs
    for key in ("stopped_at_l", "selected_per_layer", "forget_acc_trace"):
        assert sa[key] == sb[key]
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_halt_gap_by_hand():
    from portbench.calibrate import halt_gap, halting

    ref = {1: 0.004, 2: 0.002, 4: 0.0005}
    # halted at l = 4 where the reference reads under tau as well, past
    # l = 1 and 2 where it reads above: no gap
    assert halt_gap(0.001, [(1, 0.0041), (2, 0.0019), (4, 0.0)], ref) == 0
    # halted at l = 1 on an accuracy reported as 0: the reference's lies
    # 0.003 above tau there
    assert halt_gap(0.001, [(1, 0.0)], ref) == pytest.approx(0.003)
    # went past l = 4 where the reference reads 0.0005 under tau
    assert halt_gap(0.001, [(1, 0.01), (2, 0.01), (4, 0.01)], ref) \
        == pytest.approx(0.0005)
    # a checkpoint the reference did not reach is not compared
    assert halt_gap(0.001, [(6, 0.0)], ref) == 0
    got = halting(0.001, [{"program": [(1, 0.0)],
                           "reference": sorted(ref.items())}])
    assert got == pytest.approx({"acc_gap": 0.004, "halt_gap": 0.003})


def test_leaf_numbers_by_hand():
    from portbench.lib.check import request_numbers

    def leaf(ref, flips, both, gap):
        return {"ref": ref, "flips": flips, "both": both, "gap": gap}

    M = 64
    leaves = [leaf(100 * M, 10 * M, 90, 0.1),
              leaf(10 * M, 3 * M, 64, 4.0),
              leaf(20 * M, 2 * M, 70, 0.2),
              # a leaf the reference barely selects in: its flips count
              # against min_selected, and its gap over 3 elements is not
              # taken
              leaf(5, 3, 3, 9.0),
              leaf(0, 0, 0, 0.0)]
    got = request_numbers(leaves, M)
    assert got["flip_rate"] == pytest.approx(0.3)
    assert got["flip_rate_median"] == pytest.approx(0.1)
    # the worst leaf's beta gap shows beside a steady median
    assert got["edit_gap"] == 4.0 and got["edit_gap_median"] == 0.2
    assert request_numbers(leaves, 1)["edit_gap"] == 9.0
    assert request_numbers([], M) == {"flip_rate": 0.0, "edit_gap": 0.0,
                                      "flip_rate_median": 0.0,
                                      "edit_gap_median": 0.0}
