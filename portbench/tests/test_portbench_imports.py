"""Nothing under portbench/ imports JAX, jaxlib, flax or the JAX package
(top-level names compared whole: ``repro_torch`` is the port, ``repro`` the
JAX package), nothing reads the old benchmarks, and the reference imports
nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from support_portbench import ROOT
from portbench.lib import bench

FILES = sorted((ROOT / "portbench").rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_no_old_benchmarks():
    for path in FILES:
        names = set(imported(path))
        assert not names & set(bench.FORBIDDEN), path
        text = path.read_text()
        old = ("BENCH" + "_", "bench" + "marks/")
        assert not any(o in text for o in old), path


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert "repro_torch" not in set(imported(path)), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in bench.forbidden_modules()


def test_a_run_loads_no_jax(smoke_root):
    """A smoke run in a process where importing JAX or the JAX package
    fails, which then holds none of them."""
    code = textwrap.dedent(f"""
        import sys
        for m in ("jax", "jaxlib", "flax", "repro"):
            sys.modules[m] = None
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r},
                        {str(ROOT / 'portbench' / 'tests')!r}]
        from pathlib import Path
        from support_portbench import run_smoke
        line, _ = run_smoke(Path({str(smoke_root)!r}), "cell_qwen_smoke", 3,
                            seconds=0.2)
        for m in ("jax", "jaxlib", "flax", "repro"):
            del sys.modules[m]
        from portbench.lib import bench
        assert line["correct"] and not bench.forbidden_modules()
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_no_result_without_a_card():
    """On a host without the card the run exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "yi6b_ficabu_scanned", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
