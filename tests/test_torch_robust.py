"""The fleet's failure model in the port (``repro_torch.robust``) against the
JAX package's (``repro.robust``):

  * ``GuardSpec``: the same validation messages, a JSON round trip read by
    either package, and ``check`` giving EQUAL violation dicts (kind, leaf,
    counts, the f32 relative edit, the retain floor) on the same trees —
    the port's leaves are tensors (bf16 and f32), the reference's arrays;
  * ``FaultSpec`` / ``FaultInjector``: the same validation, and the same
    sequence of fire decisions and ``fired`` records over one scripted
    sequence of sites and tenants; the process-wide ``install`` /
    ``injector`` / ``fire`` hook, restored in a ``finally``;
    ``kill_mid_drain`` SIGKILLs the process (a subprocess here);
  * ``ForgetWAL``: the same operations give byte-identical files, and each
    package reads the other's files to the same records, replay list and
    accounting.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.robust import faults as jfaults  # noqa: E402
from repro.robust import guards as jguards  # noqa: E402
from repro.robust import wal as jwal  # noqa: E402
from repro_torch.robust import faults, guards, wal  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent

BAD_GUARDS = [
    {"finite": 1},
    {"max_layer_rel_edit": -0.5},
    {"max_layer_rel_edit": float("nan")},
    {"retain_floor": True},
    {"max_retries": -1},
    {"backoff_batches": 0},
    {"finite": False},
    {"bogus": 1},
]


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", BAD_GUARDS, ids=[str(k) for k in BAD_GUARDS])
def test_guard_spec_validation_equal(kw):
    assert _error(lambda: guards.GuardSpec.from_dict(kw)) == \
        _error(lambda: jguards.GuardSpec.from_dict(kw))


def test_guard_spec_json_crosses_packages():
    g = guards.GuardSpec(max_layer_rel_edit=0.5, retain_floor=0.25,
                         max_retries=2, backoff_batches=3)
    text = json.dumps(g.to_dict())
    jg = jguards.GuardSpec.from_dict(json.loads(text))
    assert json.dumps(jg.to_dict()) == text
    assert guards.GuardSpec.from_dict(jg.to_dict()) == g


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    ref = {"a": {"w": rng.normal(size=(8, 5)).astype(np.float32),
                 "b": rng.normal(size=(5,)).astype(np.float32)},
           "z": rng.normal(size=(3, 4)).astype(np.float32)}
    edit = {"a": {"w": ref["a"]["w"] * 0.9, "b": ref["a"]["b"].copy()},
            "z": ref["z"] * 0.5}
    return ref, edit


def _torch_tree(t, dtype=torch.float32):
    if isinstance(t, dict):
        return {k: _torch_tree(v, dtype) for k, v in t.items()}
    return torch.as_tensor(t).to(dtype)


def _jax_tree(t):
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    return jnp.asarray(t)


GUARD_CASES = {
    "pass": ({}, None, None),
    "finite": ({}, ("a", "w", (2, 3), np.nan), None),
    "finite-inf": ({}, ("z", None, (0, 0), np.inf), None),
    "edit-magnitude": ({"max_layer_rel_edit": 0.2}, None, None),
    "edit-ok": ({"max_layer_rel_edit": 0.6}, None, None),
    "retain-floor": ({"finite": False, "retain_floor": 0.7}, None, 0.5),
    "retain-ok": ({"retain_floor": 0.4}, None, 0.5),
    "retain-nan": ({"retain_floor": 0.4}, None, float("nan")),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guard_check_equal_verdicts(case, dtype):
    """The same violation dict (or None) from both packages on the same
    trees; bf16 trees reach the reference as the same bf16 values."""
    kw, poison, acc = GUARD_CASES[case]
    ref, edit = _trees()
    if poison is not None:
        a, b, idx, val = poison
        leaf = edit[a] if b is None else edit[a][b]
        leaf[idx] = val
    g, jg = guards.GuardSpec(**kw), jguards.GuardSpec(**kw)
    t_ref, t_edit = _torch_tree(ref, dtype), _torch_tree(edit, dtype)
    # the reference sees exactly the values the port's tensors hold
    n_ref = _jax_tree({"a": {"w": t_ref["a"]["w"].float().numpy(),
                             "b": t_ref["a"]["b"].float().numpy()},
                       "z": t_ref["z"].float().numpy()})
    n_edit = _jax_tree({"a": {"w": t_edit["a"]["w"].float().numpy(),
                              "b": t_edit["a"]["b"].float().numpy()},
                        "z": t_edit["z"].float().numpy()})
    probe = None if acc is None else (lambda tree: acc)
    got = g.check(t_ref, t_edit, probe=probe)
    want = jg.check(n_ref, n_edit, probe=probe)
    if case.endswith("nan"):
        assert got["guard"] == want["guard"] == "retain_floor"
        assert np.isnan(got["retain_acc"]) and np.isnan(want["retain_acc"])
        return
    assert got == want
    if case in ("pass", "edit-ok", "retain-ok"):
        assert got is None


def test_guard_missing_probe_and_leaf_refusals_equal():
    ref, edit = _trees()
    g, jg = (m.GuardSpec(retain_floor=0.5) for m in (guards, jguards))
    assert _error(lambda: g.check(_torch_tree(ref), _torch_tree(edit))) == \
        _error(lambda: jg.check(_jax_tree(ref), _jax_tree(edit)))
    edit2 = dict(edit, extra=np.ones(3, np.float32))
    g, jg = (m.GuardSpec(max_layer_rel_edit=0.5) for m in (guards, jguards))
    assert _error(lambda: g.check(_torch_tree(ref), _torch_tree(edit2))) == \
        _error(lambda: jg.check(_jax_tree(ref), _jax_tree(edit2)))


BAD_FAULTS = [
    {"site": "bogus"},
    {"site": "nan_batch", "tenant": 3},
    {"site": "nan_batch", "at": -1},
    {"site": "nan_batch", "count": 0},
    {"site": "nan_batch", "count": True},
    {"site": "nan_batch", "when": 1},
]


@pytest.mark.parametrize("kw", BAD_FAULTS, ids=[str(k) for k in BAD_FAULTS])
def test_fault_spec_validation_equal(kw):
    assert _error(lambda: faults.FaultSpec.from_dict(kw)) == \
        _error(lambda: jfaults.FaultSpec.from_dict(kw))


def test_injector_fires_in_the_same_sequence():
    specs = [{"site": "nan_batch", "tenant": "a", "at": 1, "count": 2},
             {"site": "nan_batch", "at": 3},
             {"site": "fisher_corrupt", "tenant": "b"},
             {"site": "deadline_miss", "at": 0, "count": 3}]
    inj = faults.FaultInjector(specs)
    jinj = jfaults.FaultInjector([jfaults.FaultSpec(**s) for s in specs])
    script = [("nan_batch", "a"), ("nan_batch", "b"), ("nan_batch", "a"),
              ("fisher_corrupt", "a"), ("fisher_corrupt", "b"),
              ("nan_batch", "a"), ("deadline_miss", None),
              ("nan_batch", None), ("deadline_miss", "x"),
              ("fisher_corrupt", "b"), ("deadline_miss", "a"),
              ("deadline_miss", "a"), ("worker_exc", "a")]
    got = [inj.fire(s, t) for s, t in script]
    want = [jinj.fire(s, t) for s, t in script]
    assert got == want and any(got) and not all(got)
    assert inj.fired == jinj.fired
    assert _error(lambda: inj.fire("bogus")) == \
        _error(lambda: jinj.fire("bogus"))


def test_module_hook_install_and_restore():
    inj = faults.FaultInjector([faults.FaultSpec("worker_exc", "t")])
    prev = faults.install(inj)
    try:
        assert faults.injector() is inj
        assert faults.fire("worker_exc", "u") is False
        assert faults.fire("worker_exc", "t") is True
        assert faults.fire("worker_exc", "t") is False
    finally:
        faults.install(prev)
    assert faults.injector() is prev
    if prev is None:
        assert faults.fire("worker_exc", "t") is False
    assert _error(lambda: faults.install(object())) == \
        _error(lambda: jfaults.install(object()))


def test_kill_mid_drain_sigkills_the_process():
    code = ("import sys; sys.path.insert(0, 'src');"
            "from repro_torch.robust import faults as f;"
            "f.install(f.FaultInjector([f.FaultSpec('kill_mid_drain')]));"
            "f.fire('kill_mid_drain', 't'); print('survived')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == -9 and "survived" not in r.stdout


def _wal_script(w):
    """One scripted life of a tenant's WAL: accepts, a drain applied, a
    dead-letter, a second drain."""
    ids = [w.append_accept(p, due_batch=d, submitted=s)
           for p, d, s in ((1, 1, 0), (2, 1, 0), (3, 2, None), (2, 2, 1),
                           (4, 5, 3))]
    w.mark_applied(w.match_unapplied([1, 2]), params_version=1, batch=1)
    w.mark_dead(w.match_unapplied([3]), reason="retries_exhausted:finite",
                batch=3)
    w.mark_applied(w.match_unapplied([2]), params_version=2, batch=4)
    w.mark_applied([], params_version=3)
    return ids


def _reads(w):
    return (w.records(), w.unapplied(), w.unapplied(up_to_version=1),
            w.accounting(), w.match_unapplied([4]))


def test_wal_bytes_equal_and_each_reads_the_other(tmp_path):
    w = wal.ForgetWAL(str(tmp_path / "port"), "acme")
    jw = jwal.ForgetWAL(str(tmp_path / "ref"), "acme")
    assert _wal_script(w) == _wal_script(jw) == [0, 1, 2, 3, 4]
    got = Path(w.path).read_bytes()
    assert got == Path(jw.path).read_bytes() and got.count(b"\n") == 9
    assert wal.WAL_NAME == jwal.WAL_NAME
    # each package reopens the other's file (the crash read path)
    cross_port = wal.ForgetWAL(str(tmp_path / "ref"), "acme")
    cross_ref = jwal.ForgetWAL(str(tmp_path / "port"), "acme")
    assert _reads(cross_port) == _reads(jw) == _reads(cross_ref) == _reads(w)
    # and appends continue the same ids, the same bytes
    assert cross_port.append_accept(7, due_batch=9) == \
        cross_ref.append_accept(7, due_batch=9) == 5
    assert Path(cross_port.path).read_bytes() == \
        Path(cross_ref.path).read_bytes()


def test_wal_refusals_equal(tmp_path):
    w = wal.ForgetWAL(str(tmp_path / "p"), "t")
    jw = jwal.ForgetWAL(str(tmp_path / "r"), "t")
    for fn in (lambda m: m.match_unapplied([9]),
               lambda m: m.mark_applied([4], params_version=1)):
        assert _error(lambda: fn(w)) == _error(lambda: fn(jw))
    assert _error(lambda: wal.ForgetWAL("", "t")) == \
        _error(lambda: jwal.ForgetWAL("", "t"))
    bad = tmp_path / "bad" / "t"
    bad.mkdir(parents=True)
    (bad / wal.WAL_NAME).write_text('{"id": 0, "op": "oops"}\n')
    msg = _error(lambda: wal.ForgetWAL(str(tmp_path / "bad"), "t"))
    assert msg == _error(lambda: jwal.ForgetWAL(str(tmp_path / "bad"), "t"))
    assert "unknown WAL op" in msg
