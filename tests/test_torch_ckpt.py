"""Checkpoints in the port (``repro_torch.ckpt``) against the JAX package's
(``repro.ckpt``):

  * a round trip in the port, bf16 leaves included (stored as their f32
    upcast, restored bit for bit), on an LM tree and a ResNet tree (the
    conv weights restored to OIHW);
  * ``latest_step`` skips a step directory without META.json and the one
    an injected ``ckpt_crash`` left (shard written, META withheld);
  * a checkpoint ``repro.ckpt`` writes restores in the port bit for bit,
    and the reverse, on gemma3-1b-smoke in bf16 and on ResNet-18-small
    (the conv layout through ``bridge``); the two packages' checkpoints of
    one tree hold the same contents: npz entry names, dtypes and values,
    and META's manifest and extra fields (npz members carry timestamps and
    META carries ``time``, so the files are not compared as bytes);
  * ``gc_old``, the unlearn journal, the shape error and the refusal of
    ``sharding_fn`` (ROADMAP Queue 1, "Distribution").
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs.ficabu_vision import RESNET18_SMALL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import vision as JV  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.robust import FaultInjector, FaultSpec, faults  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    faults.install(None)
    yield
    faults.install(None)


def _jtree(kind):
    """A reference tree of numpy arrays (bf16 leaves as ml_dtypes)."""
    if kind == "lm":
        cfg = dataclasses.replace(jconfigs.get("gemma3-1b").smoke,
                                  param_dtype="bfloat16")
        p = JLM.init_lm(jax.random.PRNGKey(0), cfg)
    else:
        p = JV.init_resnet(jax.random.PRNGKey(0), RESNET18_SMALL)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module", params=["lm", "resnet"])
def trees(request):
    j = _jtree(request.param)
    return request.param, j, bridge.params_to_torch(j, device="cpu")


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def _same(a, b):
    pa, pb = bridge.paths(a), bridge.paths(b)
    assert list(pa) == list(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and pa[k].shape == pb[k].shape, k
        assert torch.equal(_bits(pa[k]), _bits(pb[k])), k


def test_round_trip(trees, tmp_path):
    kind, _, t = trees
    tree = {"params": t, "step": torch.tensor(3, dtype=torch.int32)}
    d = ckpt.save(str(tmp_path), 7, tree, extra_meta={"note": kind})
    assert d.endswith("step_00000007")
    assert ckpt.latest_step(str(tmp_path)) == 7
    got, meta = ckpt.restore(str(tmp_path), 7, tree, device="cpu")
    _same(got, tree)
    assert meta["step"] == 7 and meta["note"] == kind
    dtypes = {m["dtype"] for m in meta["manifest"]}
    assert ("bfloat16" in dtypes) == (kind == "lm")


def test_latest_step_skips_incomplete_and_crashed(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    ckpt.save(str(tmp_path), 1, tree)
    assert ckpt.latest_step(str(tmp_path)) == 1
    os.makedirs(tmp_path / "step_00000009")          # a bare step dir
    faults.install(FaultInjector([FaultSpec("ckpt_crash")]))
    with pytest.raises(RuntimeError, match="ckpt_crash"):
        ckpt.save(str(tmp_path), 2, {"w": tree["w"] * 2})
    faults.install(None)
    step2 = tmp_path / "step_00000002"
    assert (step2 / "host_0.npz").exists()
    assert not (step2 / "META.json").exists()
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert jckpt.latest_step(str(tmp_path)) == 1
    got, meta = ckpt.restore(str(tmp_path), 1, tree, device="cpu")
    assert torch.equal(got["w"], tree["w"]) and meta["step"] == 1
    assert ckpt.latest_step(str(tmp_path / "nowhere")) is None


def test_reference_checkpoint_restores_in_port(trees, tmp_path):
    _, j, t = trees
    jckpt.save(str(tmp_path), 3, {"params": j}, extra_meta={"v": 1})
    got, meta = ckpt.restore(str(tmp_path), 3, {"params": t}, device="cpu")
    _same(got, {"params": t})
    assert meta["v"] == 1


def test_port_checkpoint_restores_in_reference(trees, tmp_path):
    _, j, t = trees
    ckpt.save(str(tmp_path), 4, {"params": t})
    got, _ = jckpt.restore(str(tmp_path), 4, {"params": j})
    a = bridge.paths({"params": j})
    b = bridge.paths(jax.tree_util.tree_map(np.asarray, got))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8)), k


def test_same_contents_as_reference(trees, tmp_path):
    _, j, t = trees
    pd = ckpt.save(str(tmp_path / "port"), 5, {"params": t},
                   extra_meta={"params_version": 5, "has_fisher": False})
    jd = jckpt.save(str(tmp_path / "ref"), 5, {"params": j},
                    extra_meta={"params_version": 5, "has_fisher": False})
    metas = []
    for d in (pd, jd):
        with open(os.path.join(d, "META.json")) as f:
            m = json.load(f)
        assert isinstance(m.pop("time"), float)
        metas.append(m)
    assert metas[0] == metas[1]
    with np.load(os.path.join(pd, "host_0.npz")) as a, \
            np.load(os.path.join(jd, "host_0.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == [
        "META.json", "host_0.npz"]


def test_gc_old_and_journal(tmp_path):
    tree = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, tree)
    ckpt.gc_old(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    ckpt.gc_old(str(tmp_path / "nowhere"))
    recs = [{"step": 8, "domain": 1}, {"step": 9, "domain": 2}]
    for r in recs:
        ckpt.journal_append(str(tmp_path / "j"), r)
    assert ckpt.journal_read(str(tmp_path / "j")) == recs \
        == jckpt.journal_read(str(tmp_path / "j"))
    assert ckpt.journal_read(str(tmp_path / "none")) == []


def test_shape_error_and_sharding_refused(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="different architecture") as e:
        ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(3, 2)},
                     device="cpu")
    with pytest.raises(ValueError) as je:
        jckpt.restore(str(tmp_path), 1, {"w": np.zeros((3, 2), np.float32)})
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="not ported yet") as e:
        ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(2, 3)},
                     sharding_fn=lambda p: None, device="cpu")
    assert "item 'Distribution'" in str(e.value)
