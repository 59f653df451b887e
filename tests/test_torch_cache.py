"""The persistent compilation cache of the port: the kernel build directory
(``repro_torch.kernels.build``), pointed by
``repro_torch.api.enable_compilation_cache``, counted by
``compilation_cache_entries`` (finished libraries only), and reported and
gated by ``serve --cache-dir`` — against the JAX package's cache API:

  * the twin of the reference's process-global refusal and idempotence;
  * a build publishes its library by an atomic rename of a dot-named temp
    file, so a count taken mid-build sees none (a fake nvcc, run by the
    real ``build_all``, counts the directory while it compiles);
  * the spec round trip of the reference's test, read from the
    reference's own JSON;
  * the ``FleetSpec`` cache-dir conflict;
  * ``serve --cache-dir`` on the host: the result JSON's
    ``compilation_cache`` block has the reference's keys (batch mode and
    ``--fleet`` with kernel tenants), a warm start that builds nothing
    passes ``--check``, and a warm start that adds a library fails it.
    There is no nvcc here: the warm cache holds a fake finished library.
"""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro_torch.api import (ServeSpec, UnlearnSpec,  # noqa: E402
                             compilation_cache_entries,
                             enable_compilation_cache)
from repro_torch.fleet import FleetSpec, TenantSpec  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

torch.set_num_threads(2)
# the reference's compilation_cache block (repro/launch/serve.py)
CACHE_KEYS = {"dir", "entries_before", "entries_new"}
ARGS = ["--device", "cpu", "--requests", "4", "--prompt-len", "8",
        "--gen-len", "4", "--forget-domains", "1,2;3,2"]


@pytest.fixture
def fresh_cache(monkeypatch):
    """The process's cache state as a fresh process has it (restored
    after the test)."""
    monkeypatch.setattr(kbuild, "_CACHE_DIR", None)
    monkeypatch.setattr(kbuild, "BUILD_DIR", kbuild.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(kbuild, "_LIBS", {})


def _warm(path):
    """A cache dir holding one finished library (and a build's temp)."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "libficabu_dampen-0123456789abcdef.so").write_bytes(b"\0")
    (path / ".libficabu_fimd-0123456789abcdef.77.tmp.so").write_bytes(b"\0")
    return str(path)


def test_enable_compilation_cache_conflicting_dir_rejected(tmp_path,
                                                           fresh_cache):
    """The cache is process-global: repointing it at a second dir raises,
    the same dir stays idempotent (twin of tests/test_api.py)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert enable_compilation_cache(a) == 0 and os.path.isdir(a)
    assert kbuild.cache_dir() is not None
    with pytest.raises(ValueError, match="process-global"):
        enable_compilation_cache(b)
    assert enable_compilation_cache(a) == 0   # idempotent
    assert kbuild.library_path("dampen").parent == kbuild.cache_dir()


def test_cache_set_after_a_library_loaded_rejected(tmp_path, fresh_cache,
                                                   monkeypatch):
    monkeypatch.setattr(kbuild, "_LIBS", {"dampen": object()})
    with pytest.raises(ValueError, match="before the first library loads"):
        enable_compilation_cache(str(tmp_path))


def test_entries_count_finished_libraries_only(tmp_path, fresh_cache):
    d = _warm(tmp_path / "c")
    (tmp_path / "c" / "notes.txt").write_text("x")
    (tmp_path / "c" / "variants").mkdir()
    assert compilation_cache_entries(d) == 1
    assert compilation_cache_entries(str(tmp_path / "missing")) == 0


def test_build_publishes_atomically(tmp_path, fresh_cache, monkeypatch):
    """``build_all`` with a fake nvcc: the compiler writes a dot-named temp
    file, and the count it takes of the directory while it runs holds only
    the libraries finished before (0, then 1); a finished library counts
    once its build returns."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        "o = sys.argv[sys.argv.index('-o') + 1]\n"
        "assert os.path.basename(o).startswith('.'), o\n"
        "open(o, 'wb').write(b'lib')\n"
        "d = os.path.dirname(o)\n"
        "print('DURING', sum(1 for n in os.listdir(d)\n"
        "      if not n.startswith('.') and n.endswith('.so')))\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kbuild, "_nvcc", lambda: str(nvcc))
    d = str(tmp_path / "cache")
    assert enable_compilation_cache(d) == 0
    for n, (name, before) in enumerate((("dampen", 0), ("fimd", 1))):
        path = kbuild.build(name)
        assert path.exists() and path.parent == kbuild.cache_dir()
        assert f"DURING {before}" in kbuild.BUILD_LOG[name]
        assert compilation_cache_entries(d) == n + 1
    paths = {n: kbuild.library_path(n) for n in ("dampen", "fimd")}
    assert kbuild.build_all(["dampen", "fimd"]) == paths  # nothing rebuilt


def test_spec_json_round_trip():
    """The reference's own JSON of a spec with mesh axes, fsdp and a cache
    dir reads here into the spec built here (lists read back as tuples),
    and the port writes the same JSON."""
    kw = dict(alpha=3.5, lam=0.7, tau=0.2, checkpoint_every=3, b_r=4.0,
              c_m=2.5, max_layers=7, chunk_size=2, use_kernel=True,
              donate=True, mesh_axes=("data", "model"), sharding="fsdp",
              cache_dir="/tmp/c")
    spec = UnlearnSpec.for_mode("ficabu", **kw)
    text = JSpec.for_mode("ficabu", **kw).to_json()
    again = UnlearnSpec.from_json(text)
    assert again == spec
    assert again.exec.mesh_axes == ("data", "model")  # list -> tuple
    assert spec.to_json() == text
    assert UnlearnSpec.from_dict(spec.to_dict()) == spec


def test_fleet_spec_cache_dir_conflict():
    """A tenant pinning its own cache dir against the fleet's is a config
    contradiction, caught up front (twin of tests/test_fleet.py)."""
    def spec(d):
        return UnlearnSpec.for_mode("ficabu", cache_dir=d)
    t = TenantSpec("a", spec=spec("/tmp/mine"))
    with pytest.raises(ValueError, match="process-global"):
        FleetSpec(tenants=(t,), serve=ServeSpec(cache_dir="/tmp/fleet"))
    FleetSpec(tenants=(TenantSpec("b", spec=spec("/tmp/same")),),
              serve=ServeSpec(cache_dir="/tmp/same"))


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_serve_cache_dir_block_and_gate(tmp_path, fresh_cache, monkeypatch,
                                        deterministic):
    d = _warm(tmp_path / "cache")
    res = serve.main(ARGS + ["--cache-dir", d, "--check"])
    assert set(res["compilation_cache"]) == CACHE_KEYS
    assert res["compilation_cache"] == {"dir": d, "entries_before": 1,
                                        "entries_new": 0}
    # a warm start that still builds a library: the gate fails the run
    drain = serve.ForgetService.drain

    def drain_and_build(self, *a, **kw):
        (tmp_path / "cache" / "libficabu_new-fedcba9876543210.so"
         ).write_bytes(b"\0")
        return drain(self, *a, **kw)

    monkeypatch.setattr(serve.ForgetService, "drain", drain_and_build)
    with pytest.raises(SystemExit):
        serve.main(ARGS + ["--cache-dir", d, "--check"])
    info = serve.cache_info_since(d, 1)
    assert info["entries_new"] == 1
    assert serve.cache_problems(info) == [
        "cold start with a warm compilation cache (1 entries) still "
        "compiled 1 new program(s)"]
    assert serve.cache_problems({**info, "entries_before": 0}) == []


def test_fleet_cache_dir_with_kernel_tenants(tmp_path, fresh_cache,
                                             deterministic):
    """``--fleet`` with two kernel tenants (``exec.use_kernel``) and the
    cache on the fleet's ServeSpec: the block is reported, the warm start
    passes every fleet gate and the cold-start gate."""
    d = _warm(tmp_path / "cache")
    tspec = UnlearnSpec.for_mode("ficabu", chunk_size=4, use_kernel=True,
                                 sweep_mode="scanned").to_dict()
    fleet = {"tenants": [{"name": n, "arch": "gemma3-1b", "seed": s,
                          "spec": tspec} for n, s in (("a", 0), ("b", 1))],
             "serve": {"chunk_size": 4, "cache_dir": d}}
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(fleet))
    res = serve.main(ARGS + ["--fleet", str(path), "--check"])
    assert res["compilation_cache"] == {"dir": d, "entries_before": 1,
                                        "entries_new": 0}
    assert all(t["group_log"] for t in res["tenants"].values())
