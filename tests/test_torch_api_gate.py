"""The port's API gate (``tools/api_gate_torch.py``): it passes on this
tree, and on a copy of the tree seeded with one violation of a rule it
fails, naming the file and the rule; what the rules allow (the facade's
own files, the harnesses' asserts) it lets through."""
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
GATE = ROOT / "tools" / "api_gate_torch.py"
_spec = importlib.util.spec_from_file_location("api_gate_torch", GATE)
gate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gate)


def test_gate_passes_on_the_tree():
    res = subprocess.run([sys.executable, str(GATE)], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    problems, n = gate.problems_in(ROOT)
    assert problems == []
    # the whole port and its six examples
    assert n >= len(list((ROOT / "src/repro_torch").rglob("*.py"))) + 6


@pytest.fixture(scope="module")
def clean_copy(tmp_path_factory):
    """The port and its examples, copied."""
    root = tmp_path_factory.mktemp("gate") / "clean"
    shutil.copytree(ROOT / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    (root / "examples").mkdir()
    for p in (ROOT / "examples").glob("torch_*.py"):
        shutil.copy(p, root / "examples" / p.name)
    return root


def _seeded(clean_copy, tmp_path, rel, text):
    root = tmp_path / "tree"
    shutil.copytree(clean_copy, root)
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write("\n" + text + "\n")
    return root


# (file the violation goes into, the code, a phrase of the gate's message)
VIOLATIONS = {
    "mode_config": ("src/repro_torch/core/ssd.py",
                    "cfg = ficabu._mode_config('ssd')", "_mode_config"),
    "session": ("src/repro_torch/launch/train.py",
                "sess = UnlearnSession(adapter, fisher)",
                "constructs UnlearnSession"),
    "forget_service": ("examples/torch_fleet_two_tenants.py",
                       "svc = ForgetService(cfg, toks, doms, 8)",
                       "constructs ForgetService"),
    "queues": ("src/repro_torch/load/harness.py",
               "depth = len(fleet.scheduler._queues)", "_queues"),
    "assert": ("src/repro_torch/models/lm.py", "assert True",
               "bare assert"),
    "import_time": ("src/repro_torch/fleet/specs.py", "import time",
                    "imports 'time'"),
    "from_datetime": ("src/repro_torch/load/slo.py",
                      "from datetime import datetime",
                      "imports from 'datetime'"),
    "clock_read": ("src/repro_torch/fleet/scheduler.py",
                   "def _now():\n    return time.monotonic()",
                   "reads time.monotonic"),
    "bare_except": ("src/repro_torch/launch/dryrun.py",
                    "try:\n    pass\nexcept:\n    raise",
                    "bare 'except:'"),
    "swallowed": ("src/repro_torch/fleet/fleet.py",
                  "try:\n    pass\nexcept ValueError:\n    pass",
                  "swallows the failure"),
    "does_not_parse": ("src/repro_torch/obs/report.py", "def (",
                       "does not parse"),
}


@pytest.mark.parametrize("rule", sorted(VIOLATIONS))
def test_gate_fails_on_a_seeded_violation(clean_copy, tmp_path, rule):
    rel, code, phrase = VIOLATIONS[rule]
    root = _seeded(clean_copy, tmp_path, rel, code)
    problems, _ = gate.problems_in(root)
    assert len(problems) == 1, problems
    assert problems[0].startswith(rel + ":") and phrase in problems[0], \
        problems


def test_gate_exits_1_on_a_violation(clean_copy, tmp_path):
    rel, code, phrase = VIOLATIONS["swallowed"]
    root = _seeded(clean_copy, tmp_path, rel, code)
    res = subprocess.run([sys.executable, str(GATE), "--root", str(root)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "FAILED: 1 " in res.stdout \
        and phrase in res.stdout, res.stdout


# what a rule allows: the shim's own files, a harness's assert, the clock
# outside the virtual-clock packages, a handler that re-raises
ALLOWED = {
    "service_in_serve": ("src/repro_torch/launch/serve.py",
                         "svc2 = ForgetService(cfg, toks, doms, 8)"),
    "service_in_fleet": ("src/repro_torch/fleet/fleet.py",
                         "svc2 = ForgetService(cfg, toks, doms, 8)"),
    "session_in_facade": ("src/repro_torch/api/facade.py",
                          "sess = UnlearnSession(adapter, fisher)"),
    "queues_in_scheduler": ("src/repro_torch/fleet/scheduler.py",
                            "depth = len(self._queues)"),
    "assert_in_example": ("examples/torch_quickstart.py", "assert True"),
    "time_in_launch": ("src/repro_torch/launch/train.py", "import time"),
    "comment": ("src/repro_torch/core/ssd.py",
                "# never ForgetService( or _mode_config here"),
    "handled": ("src/repro_torch/fleet/fleet.py",
                "try:\n    pass\nexcept ValueError as e:\n    raise "
                "RuntimeError('drain') from e"),
}


@pytest.mark.parametrize("case", sorted(ALLOWED))
def test_gate_allows(clean_copy, tmp_path, case):
    rel, code = ALLOWED[case]
    root = _seeded(clean_copy, tmp_path, rel, code)
    problems, _ = gate.problems_in(root)
    assert problems == [], problems


def test_gate_fails_on_an_empty_tree(tmp_path):
    res = subprocess.run([sys.executable, str(GATE), "--root",
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1 and "no file to scan" in res.stdout
