"""The check fails what it must: the control (the port's own int8 path in
the program's place, one step below the configuration's bf16) and the
faults planted underneath the timed path (``lib/faults.py``), each at the
SMOKE sizes on the CPU with the harness's look for a card left out. One
fault is confined to one small leaf (``leaf_beta``): the worst leaf
reports it where a layer's median would not."""
from __future__ import annotations

import pytest

from support_portbench import run_smoke
from portbench.lib.faults import FAULTS


@pytest.mark.parametrize("cell", ["cell_yi_smoke", "cell_qwen_smoke"])
def test_int8_control_is_not_correct(smoke_root, cell):
    line, _ = run_smoke(smoke_root, cell, 31, precision="int8")
    assert not line["correct"]
    over = [n for n, c in line["checks"].items() if c["value"] > c["limit"]]
    assert "mismatches" in over and "flip_rate" in over


@pytest.mark.parametrize("fault,fails", [
    ("unchanged", "mismatches"),
    ("half_batch", "flip_rate_median"),
    ("label_altered", "label_gap"),
    ("leaf_beta", "edit_gap"),
])
def test_fault_is_not_correct(smoke_root, fault, fails):
    line, _ = run_smoke(smoke_root, "cell_yi_smoke", 41,
                        program=FAULTS[fault])
    assert not line["correct"]
    c = line["checks"][fails]
    assert c["value"] > c["limit"]
