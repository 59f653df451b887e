"""Sharded execution in the port (``Unlearner.shard``,
``repro_torch.dist.execute``) against unsharded requests and against the
JAX package:

  * on a one-rank gloo 1x1 mesh (``launch.mesh.make_host_mesh``):
    ``forget``, ``forget_group`` and ``refresh_now`` through a sharded
    facade equal the unsharded facade's BIT FOR BIT, fp32 (layerwise and
    scanned) and int8, on ViT-small and the gemma3-1b SMOKE LM, every
    returned leaf a DTensor with ``placements(param_pspecs(...))``, the
    dampen launches and leaves equal;
  * a ``mesh_axes`` the mesh lacks raises the reference's message;
  * the twin of the reference's elastic restore, and a save on one layout
    restored on another;
  * the reference's ``_sdpa_cp`` (``cp_attention=2``) and
    ``moe_shard_constraints=True`` against the port's, forward and Fisher,
    on the gemma3-1b and llama4-scout SMOKE LMs, at the LM files'
    tolerances (the reference's bare-P constraints under ``jax.set_mesh``
    of a 1x1 mesh with Auto axes);
  * two gloo ranks (``torch.multiprocessing``, rendezvous through a file,
    a time limit per test), a (2, 1) data mesh and a (1, 2) model mesh, an
    fp32 ssd and a ficabu request and a Fisher refresh on the gemma3-1b
    SMOKE LM: halting, checkpoints and MACs EQUAL the reference's
    unsharded requests; on the model mesh every local shard is bit for
    bit the matching slice of the unsharded port result (the batch is
    whole on every rank); on the data mesh each rank runs half the rows
    and the Fisher's partial sums are all-reduced, so the refreshed Fisher
    holds at the summation-order tolerance (rtol 1e-4 on >= 99.9% of the
    entries, 2e-3 on all) and the edited weights equal the unsharded ones
    wherever the two selections agree to within an ulp of beta.
"""
import os
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.configs.ficabu_vision import VIT_SMALL as JVIT_SMALL  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.api import (ForgetRequest, RefreshSpec,  # noqa: E402
                             Unlearner, UnlearnSpec)
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.core import adapters  # noqa: E402
from repro_torch.core import fisher as tfisher  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.dist import execute as dx  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.kernels import dampen as kd  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402

torch.set_num_threads(2)
SEQ = 16
TWO_RANK_TIMEOUT = 240


@pytest.fixture(scope="module")
def mesh():
    m = make_host_mesh(device="cpu")
    yield m
    m.close()


@pytest.fixture(scope="module")
def lm():
    cfg = tconfigs.get("gemma3-1b").smoke
    params = TLM.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks, doms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=cfg.vocab, n_domains=4, seq_len=SEQ + 1, n_per_domain=16,
        seed=0))
    ad = adapters.lm_adapter(cfg, SEQ, device="cpu")

    def loss(p, b):
        return TLM.lm_loss(p, cfg, b[0], b[1])

    def request(seqs):
        x = torch.as_tensor(seqs[:, :-1]).long()
        with torch.no_grad():
            return x, TLM.forward(params, cfg, x)[0].argmax(-1)

    split = syn.lm_split_forget_retain(toks, doms, 1)
    retain = request(split["retain"][:8])
    fisher = tfisher.diag_fisher(loss, params, retain, chunk_size=4,
                                 device="cpu")
    return {"cfg": cfg, "params": params, "adapter": ad, "loss": loss,
            "fisher": fisher, "retain": retain,
            "forget": request(split["forget"][:8]),
            "forget2": request(syn.lm_split_forget_retain(
                toks, doms, 2)["forget"][:8])}


@pytest.fixture(scope="module")
def vit():
    cfg = tconfigs.VIT_SMALL
    params = V.init_vit(torch.Generator().manual_seed(0), cfg, device="cpu")
    x, y = syn.make_classification(syn.ClsDataConfig(
        n_classes=cfg.n_classes, n_per_class=8, img_size=cfg.img_size))
    x, y = torch.as_tensor(x), torch.as_tensor(y).long()
    ad = adapters.vit_adapter(cfg, device="cpu")

    def loss(p, b):
        return V.cls_loss(V.vit_forward(p, cfg, b[0]), b[1])

    fisher = tfisher.diag_fisher(loss, params, (x[y != 1], y[y != 1]),
                                 chunk_size=4, device="cpu")
    return {"params": params, "adapter": ad, "loss": loss, "fisher": fisher,
            "retain": (x[y != 1][:8], y[y != 1][:8]),
            "forget": (x[y == 1], y[y == 1]),
            "forget2": (x[y == 2], y[y == 2])}


@pytest.fixture
def tables(monkeypatch):
    """Counts of the group dampen calls and the leaves they took, per
    precision (on the host the plain versions stand for the kernels, one
    call per table as one launch per table on the card)."""
    count = {"fp32": [0, 0], "int8": [0, 0]}
    for name, path in (("dampen_group_ref", "fp32"),
                       ("dampen_int8_group_ref", "int8")):
        fn = getattr(kd, name)

        def counted(thetas, *a, _fn=fn, _c=count[path], **kw):
            _c[0] += 1
            _c[1] += len(thetas)
            return _fn(thetas, *a, **kw)

        monkeypatch.setattr(kd, name, counted)
    return lambda: tuple(count["fp32"] + count["int8"])


def _equal_sharded(new_u, new_s, mesh, spec):
    """The sharded tree equals the unsharded one bit for bit, each leaf a
    DTensor with the spec's placements."""
    specs = shd.spec_paths(spec.exec.param_pspecs(new_u, mesh))
    a, b = bridge.paths(new_u), bridge.paths(new_s)
    assert sorted(a) == sorted(b)
    for k in a:
        assert dx.is_dtensor(b[k]), k
        assert tuple(b[k].placements) == shd.placements(specs[k], mesh), k
        assert torch.equal(a[k], b[k].full_tensor()), k


STATS = ("stopped_at_l", "checkpoints_hit", "selected_per_layer",
         "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")
CASES = [("ssd", "fp32", "layerwise"), ("ficabu", "fp32", "layerwise"),
         ("ficabu", "fp32", "scanned"), ("ssd", "int8", "layerwise"),
         ("ficabu", "int8", "scanned")]


@pytest.mark.parametrize("model", ["lm", "vit"])
@pytest.mark.parametrize("mode,precision,sweep", CASES,
                         ids=["-".join(c) for c in CASES])
def test_one_rank_sharded_equals_unsharded(request, mesh, tables, model,
                                           mode, precision, sweep):
    m = request.getfixturevalue(model)
    spec = UnlearnSpec.for_mode(
        mode, alpha=2.0, tau=0.5, checkpoint_every=2, chunk_size=4,
        use_kernel=True, precision=precision, sweep_mode=sweep,
        mesh_axes=("data", "model"))
    plain = Unlearner(m["adapter"], m["fisher"], spec, device="cpu")
    sharded = Unlearner(m["adapter"], m["fisher"], spec,
                        device="cpu").shard(mesh)
    assert all(dx.is_dtensor(t) for t in bridge.paths(
        sharded.fisher_global).values())
    req = ForgetRequest(*m["forget"])
    got = []
    for unl in (plain, sharded):
        c0 = tables()
        new, st = unl.forget(req, params=m["params"])
        newg, stg, g = unl.forget_group(
            [req, ForgetRequest(*m["forget2"])], params=m["params"])
        got.append((new, st, newg, stg, g,
                    tuple(b - a for a, b in zip(c0, tables()))))
    (new_u, st_u, ng_u, sg_u, g_u, c_u), (new_s, st_s, ng_s, sg_s, g_s,
                                          c_s) = got
    _equal_sharded(new_u, new_s, mesh, spec)
    _equal_sharded(ng_u, ng_s, mesh, spec)
    assert {k: st_u[k] for k in STATS} == {k: st_s[k] for k in STATS}
    assert [{k: s[k] for k in STATS} for s in sg_u] == \
        [{k: s[k] for k in STATS} for s in sg_s]
    assert st_u["engine"]["sweep_mode"] == st_s["engine"]["sweep_mode"]
    assert g_u["engine"] == g_s["engine"]
    assert c_u == c_s and sum(c_u) > 0


@pytest.mark.parametrize("model", ["lm", "vit"])
def test_one_rank_refresh_equals_unsharded(request, mesh, model):
    m = request.getfixturevalue(model)
    spec = UnlearnSpec.for_mode("ssd", chunk_size=4)
    out = []
    for shard in (False, True):
        unl = Unlearner(m["adapter"], m["fisher"], spec, device="cpu")
        if shard:
            unl.shard(mesh)
        unl.enable_fisher_refresh(RefreshSpec(decay=0.5, max_batches=2),
                                  [m["retain"], m["forget"]], m["loss"])
        entry = unl.refresh_now(m["params"])
        out.append((unl.fisher_global, entry))
    (fu, eu), (fs, es) = out
    assert eu == es
    _equal_sharded(fu, fs, mesh, spec)


def test_ops_take_dtensors(mesh):
    """``kernels.ops``' dampen wrappers on DTensor leaves: the local shard
    through the same path, the result rewrapped with theta's placements,
    equal to the whole-tensor call; rowscale's scale table cut with the
    rows; a Fisher laid out otherwise is refused."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.optim.compression import q8_quantize
    g = torch.Generator().manual_seed(3)
    th = torch.randn(8, 6, generator=g)
    i_f, i_g = (torch.rand(8, 6, generator=g) for _ in range(2))
    q = q8_quantize(th)[0]
    dm = mesh.device_mesh
    pl = shd.placements(shd.P("data", "model"), mesh)
    d_th, d_q, d_g = (dx.place(t, dm, pl) for t in (th, q, i_g))
    for fn, t, dt in ((ops.dampen, th, d_th), (ops.dampen_int8, q, d_q)):
        want = fn(t, i_f, i_g, 2.0, 0.5)
        got = fn(dt, i_f, d_g, 2.0, 0.5)
        for a, b in zip(want, got):
            assert tuple(b.placements) == pl
            assert torch.equal(a, b.full_tensor())
    for fn, ts, dts in ((ops.dampen_group, [th, th[:3]],
                         [d_th, dx.place(th[:3], dm, pl)]),
                        (ops.dampen_int8_group, [q], [d_q])):
        want = fn(ts, [i_f[:len(t)] for t in ts], [i_g[:len(t)] for t in ts],
                  2.0, 0.5)
        got = fn(dts, [i_f[:len(t)] for t in ts],
                 [i_g[:len(t)] for t in ts], 2.0, 0.5)
        assert int(got[2]) == int(want[2])
        assert all(torch.equal(a, b.full_tensor())
                   for a, b in zip(want[0] + want[1], got[0] + got[1]))
    fs = torch.rand(8, generator=g)
    want = ops.dampen_int8_rowscale(q, q, fs, i_g, 2.0, 0.5)
    got = ops.dampen_int8_rowscale(d_q, q, fs, i_g, 2.0, 0.5)
    assert torch.equal(want, got.full_tensor())
    with pytest.raises(ValueError, match="same spec"):
        ops.dampen(d_th, dx.place(i_f, dm, (Replicate(), Shard(0))), i_g,
                   2.0, 0.5)


def test_local_slice_follows_dtensor_order():
    """A dim split over two mesh dims: the first mesh dim major, as
    DTensor (and JAX's tuple entry) orders it."""
    from torch.distributed.tensor import Replicate, Shard

    class Stub:
        ndim = 2

        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return self.coord

        def size(self, k):
            return (2, 3)[k]

    t = torch.arange(12 * 5).reshape(12, 5)
    for c0 in range(2):
        for c1 in range(3):
            got = dx.local_slice(t, Stub([c0, c1]), (Shard(0), Shard(0)))
            assert torch.equal(got, t.chunk(6)[c0 * 3 + c1])
            got = dx.local_slice(t, Stub([c0, c1]), (Replicate(), Shard(0)))
            assert torch.equal(got, t.chunk(3)[c1])
    with pytest.raises(ValueError, match="does not split evenly"):
        dx.local_slice(t, Stub([0, 0]), (Replicate(), Shard(1)))


def test_mesh_axes_missing_raises_the_reference_message(mesh, vit):
    spec = UnlearnSpec.for_mode("ssd", mesh_axes=("data", "expert"))
    unl = Unlearner(vit["adapter"], vit["fisher"], spec, device="cpu")
    with pytest.raises(ValueError) as te:
        unl.shard(mesh)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    junl = JUnlearner(jadapters.vit_adapter(JVIT_SMALL),
                      spec=JSpec.for_mode("ssd",
                                          mesh_axes=("data", "expert")))
    with pytest.raises(ValueError) as je:
        junl.shard(jmesh)
    assert str(te.value) == str(je.value)
    assert unl.mesh is None


def test_ckpt_elastic_resharding(tmp_path, mesh):
    """Restore onto a (new) mesh via sharding_fn — the elastic scaling path
    (twin of tests/test_substrate.py); and a tree saved from one layout
    restores on another, whole values bit for bit."""
    from torch.distributed.tensor import Replicate, Shard
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    ckpt.save(str(tmp_path), 1, tree)
    restored, _ = ckpt.restore(str(tmp_path), 1, tree, device="cpu",
                               sharding_fn=lambda path: (mesh, shd.P()))
    assert tuple(restored["w"].placements) == (Replicate(), Replicate())
    assert torch.equal(restored["w"].full_tensor(), tree["w"])
    # saved sharded ("data", "model") on a [8, 4] leaf, restored as
    # ("model", None), then as whole tensors
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    placed = {"w": dx.place(w, mesh.device_mesh,
                            shd.placements(shd.P("data", "model"), mesh))}
    ckpt.save(str(tmp_path), 2, placed)
    again, _ = ckpt.restore(str(tmp_path), 2, {"w": w}, device="cpu",
                            sharding_fn=lambda p: (mesh,
                                                   shd.P("model", None)))
    assert tuple(again["w"].placements) == (Replicate(), Shard(0))
    assert torch.equal(again["w"].full_tensor(), w)
    whole, _ = ckpt.restore(str(tmp_path), 2, {"w": w}, device="cpu")
    assert torch.equal(whole["w"], w)


# -- cp attention and the MoE constraints against the reference ------------
def _auto_mesh():
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                      axis_types=auto))


def _fisher_close(got, want):
    """The LM files' Fisher tolerance, over the tree: rtol 1e-4 / atol
    1e-12 on >= 99.9% of the entries, rtol 2e-3 on all."""
    ok = total = 0
    for k in want:
        g, w = got[k], want[k]
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-12, err_msg=k)
        ok += int(np.isclose(g, w, rtol=1e-4, atol=1e-12).sum())
        total += w.size
    assert ok >= 0.999 * total, (ok, total)


@pytest.mark.parametrize("arch,kw", [
    ("gemma3-1b", {"cp_attention": 2}),
    ("llama4-scout-17b-a16e", {"cp_attention": 2,
                               "moe_shard_constraints": True})],
    ids=["gemma3-cp", "llama4-cp-moe"])
def test_cp_and_moe_constraints_match_the_reference(arch, kw):
    tcfg = tconfigs.get(arch).smoke.with_(**kw)
    jcfg = jconfigs.get(arch).smoke
    jcfg = type(jcfg)(**{**{f: getattr(jcfg, f) for f in
                            jcfg.__dataclass_fields__}, **kw})
    tp = TLM.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.params_to_numpy(tp))
    toks, _ = syn.make_lm_domains(syn.LMDataConfig(
        vocab=tcfg.vocab, n_domains=2, seq_len=SEQ + 1, n_per_domain=4))
    x, y = toks[:, :-1], toks[:, 1:]
    with _auto_mesh():
        jlogits = np.asarray(JLM.forward(jp, jcfg, jnp.asarray(x))[0])
        jI = jfisher.diag_fisher(
            lambda p, b: JLM.lm_loss(p, jcfg, b[0], b[1]), jp,
            (jnp.asarray(x), jnp.asarray(y)), chunk_size=4)
    tx, ty = torch.as_tensor(x).long(), torch.as_tensor(y).long()
    tlogits = TLM.forward(tp, tcfg, tx)[0]
    np.testing.assert_allclose(tlogits.float().numpy(), jlogits,
                               rtol=1e-4, atol=1e-5)
    tI = tfisher.diag_fisher(lambda p, b: TLM.lm_loss(p, tcfg, b[0], b[1]),
                             tp, (tx, ty), chunk_size=4, device="cpu")
    _fisher_close(bridge.paths(bridge.params_to_numpy(tI)),
                  bridge.paths(jax.tree_util.tree_map(np.asarray, jI)))


# -- two gloo ranks -----------------------------------------------------------
def _tau(trace):
    """A tau strictly between the forget accuracy at the first checkpoint
    that drops below every earlier one and the lowest earlier one, so one
    token's difference in a trace cannot move the halting."""
    for i in range(1, len(trace)):
        prev = min(a for _, a in trace[:i])
        if trace[i][1] < prev:
            return (trace[i][1] + prev) / 2
    raise AssertionError(f"the trace never drops: {trace}")


def _rank(rank, world, rdv, shapes, inp, out):
    """One rank: the sharded requests and refresh on each mesh of
    ``shapes``, compared in the rank against the unsharded results ``inp``
    holds (the rank runs the module's two threads, as the process that
    computed them)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        d = torch.load(inp, weights_only=False)
        cfg = tconfigs.get("gemma3-1b").smoke
        ad = adapters.lm_adapter(cfg, SEQ, device="cpu")
        res = {}
        for shape in shapes:
            res[shape] = _rank_on(make_mesh(shape, ("data", "model"),
                                            device="cpu"), d, cfg, ad)
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _rank_on(mesh, d, cfg, ad):
    res = {}
    for mode, kw in (("ssd", {}), ("ficabu", {"tau": d["tau"]})):
        spec = UnlearnSpec.for_mode(mode, **d["spec_kw"], **kw)
        unl = Unlearner(ad, d["fisher"], spec, device="cpu").shard(mesh)
        new, st = unl.forget(ForgetRequest(*d["forget"]), params=d["params"])
        want = bridge.paths(d["unsharded"][mode])
        got = bridge.paths(new)
        exact = all(torch.equal(
            dx.local_slice(want[k], mesh.device_mesh, got[k].placements),
            got[k].to_local()) for k in want)
        whole = {k: got[k].full_tensor() for k in got}
        res[mode] = {k: st[k] for k in STATS}
        res[mode]["exact_local"] = exact
        res[mode]["equal_fraction"] = float(np.mean(
            [(whole[k] == want[k]).double().mean().item() for k in want]))
    unl = Unlearner(ad, d["fisher"], UnlearnSpec.for_mode(
        "ssd", chunk_size=4), device="cpu").shard(mesh)
    unl.enable_fisher_refresh(RefreshSpec(decay=0.5), [d["retain"]],
                              lambda p, b: TLM.lm_loss(p, cfg, b[0], b[1]))
    unl.refresh_now(d["params"])
    res["refreshed"] = {k: v.full_tensor() for k, v in
                        bridge.paths(unl.fisher_global).items()}
    return res


def _spawn(shapes, inp, out):
    import torch.multiprocessing as mp
    rdv = os.path.join(tempfile.mkdtemp(prefix="ficabu-pg-"), "rdv")
    ctx = mp.start_processes(_rank, args=(2, rdv, shapes, inp, out),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TWO_RANK_TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two ranks on {shapes} meshes took more than "
                        f"{TWO_RANK_TIMEOUT} s")
    return [torch.load(f"{out}.{r}", weights_only=False) for r in (0, 1)]


@pytest.fixture(scope="module")
def two_rank_setup(lm, tmp_path_factory):
    """The unsharded port results and the reference's, and the rank input
    file."""
    jcfg = jconfigs.get("gemma3-1b").smoke
    jp = jax.tree_util.tree_map(jnp.asarray,
                                bridge.params_to_numpy(lm["params"]))
    jad = jadapters.lm_adapter(jcfg, SEQ)
    jI = jfisher.diag_fisher(lambda p, b: JLM.lm_loss(p, jcfg, b[0], b[1]),
                             jp, tuple(jnp.asarray(t.numpy())
                                       for t in lm["retain"]), chunk_size=4)
    kw = dict(alpha=2.0, checkpoint_every=2, chunk_size=4)
    jreq = JRequest(*(jnp.asarray(t.numpy()) for t in lm["forget"]))
    # one warm reference session for every request (with_spec)
    jbase = JUnlearner(jad, jI, JSpec.for_mode("ficabu", tau=-1.0, **kw))
    _, jnh = jbase.forget(jreq, params=jp)
    tau = _tau(jnh["forget_acc_trace"])
    ref, unsharded = {}, {}
    for mode, mkw in (("ssd", {}), ("ficabu", {"tau": tau})):
        _, ref[mode] = jbase.with_spec(JSpec.for_mode(mode, **kw, **mkw)
                                       ).forget(jreq, params=jp)
        unsharded[mode], _ = Unlearner(
            lm["adapter"], lm["fisher"], UnlearnSpec.for_mode(
                mode, **kw, **mkw), device="cpu").forget(
            ForgetRequest(*lm["forget"]), params=lm["params"])
    plain = Unlearner(lm["adapter"], lm["fisher"],
                      UnlearnSpec.for_mode("ssd", chunk_size=4), device="cpu")
    plain.enable_fisher_refresh(RefreshSpec(decay=0.5), [lm["retain"]],
                                lm["loss"])
    plain.refresh_now(lm["params"])
    d = tmp_path_factory.mktemp("ranks")
    inp = str(d / "inputs.pt")
    torch.save({"params": lm["params"], "fisher": lm["fisher"],
                "forget": lm["forget"], "retain": lm["retain"], "tau": tau,
                "spec_kw": kw, "unsharded": unsharded}, inp)
    # ONE spawn of two ranks runs both meshes, one after the other
    ranks = _spawn(SHAPES, inp, str(d / "out"))
    return {"ref": ref, "ranks": ranks,
            "refreshed": bridge.paths(plain.fisher_global)}


SHAPES = ((2, 1), (1, 2))


@pytest.mark.parametrize("shape", SHAPES, ids=["data", "model"])
def test_two_ranks_match_the_reference(two_rank_setup, shape):
    s = two_rank_setup
    ranks = [r[shape] for r in s["ranks"]]
    for r, res in enumerate(ranks):
        for mode in ("ssd", "ficabu"):
            got, want = res[mode], s["ref"][mode]
            for k in ("stopped_at_l", "checkpoints_hit", "macs",
                      "macs_ssd"):
                assert got[k] == want[k], (r, mode, k, got[k], want[k])
            if shape == (1, 2):
                assert got["exact_local"], (r, mode)
                assert got["equal_fraction"] == 1.0, (r, mode)
            else:
                # beta moves by an ulp where the Fisher's summation order
                # does: the selected entries, not the others
                assert got["equal_fraction"] >= 0.5, (r, mode)
        refreshed = {k: v.numpy() for k, v in res["refreshed"].items()}
        want = {k: v.numpy() for k, v in s["refreshed"].items()}
        if shape == (1, 2):
            assert all(np.array_equal(refreshed[k], want[k]) for k in want)
        else:
            _fisher_close(refreshed, want)
    assert ranks[0]["ssd"] == ranks[1]["ssd"]
