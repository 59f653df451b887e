"""The port stands alone: no module of ``repro_torch`` (``obs``,
``engine.sweep``, ``dist`` and ``launch.mesh`` included) and not the chip
smoke script imports ``jax`` or the JAX package ``repro``, the port serves
a forget request, a scanned coalesced group under a telemetry capture and
a sharded request on a one-rank gloo mesh and counts a dry-run cell, with
both blocked,
its entry points refuse to run on an absent card instead of quietly
falling back to the host, and nothing of it uses ``torch.optim``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Unlearner  # noqa: E402
from repro_torch.core import adapters, fisher  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
BLOCKED = ("jax", "jaxlib", "repro")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_no_module_imports_jax_or_repro():
    """Every import statement, at any depth (inside functions too), of every
    module of the port and of chip_smoke.py."""
    offenders = []
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    # the serving slice's packages among them
    for pkg in ("robust", "fleet", "launch", "ckpt", "load", "dist"):
        assert any(p.parent.name == pkg for p in files), pkg
    assert PORT / "launch" / "mesh.py" in files
    for path in files + [SMOKE]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names
                          if _blocked(n)]
    assert not offenders, offenders


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "repro")


class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name!r}")
        return None


for name in list(sys.modules):
    if any(name == b or name.startswith(b + ".") for b in BLOCKED):
        del sys.modules[name]
sys.meta_path.insert(0, Block())

import numpy as np
import torch
import repro_torch

torch.set_num_threads(2)
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)

from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec
from repro_torch.core import adapters
from repro_torch.data import synthetic as syn
from repro_torch.models import vision as V

cfg = V.ResNetConfig(width=8, n_classes=4, img_size=8)
params = V.init_resnet(torch.Generator().manual_seed(0), cfg, device="cpu")
x, y = syn.make_classification(syn.ClsDataConfig(n_classes=4, n_per_class=8,
                                                 img_size=8))
loss = lambda p, b: V.cls_loss(V.resnet_forward(p, cfg, b[0]), b[1])
unl = Unlearner(adapters.resnet_adapter(cfg, device="cpu"),
                spec=UnlearnSpec.for_mode("ficabu", checkpoint_every=2,
                                          chunk_size=4, use_kernel=True),
                device="cpu")
unl.ensure_fisher(loss, params, (x[:16], y[:16]))
new, st = unl.forget(ForgetRequest(x[y == 1][:8], y[y == 1][:8]),
                     params=params)
assert all(torch.isfinite(t).all() for t in
           [v for blk in new["blocks"].values() for v in blk.values()
            if isinstance(v, torch.Tensor)])
unl8 = unl.with_spec(UnlearnSpec.for_mode("ssd", chunk_size=4,
                                          use_kernel=True, precision="int8"))
new8, st8 = unl8.forget(ForgetRequest(x[y == 1][:8], y[y == 1][:8]),
                        params=params)
assert st8["engine"]["precision"] == "int8" and st8["stopped_at_l"] == 10
# the scanned whole-sweep program and its telemetry, on a tiny ViT
from repro_torch.obs import telemetry
vcfg = V.ViTConfig(n_layers=2, d_model=16, n_heads=2, d_ff=32, n_classes=4,
                   img_size=8, patch=4)
vparams = V.init_vit(torch.Generator().manual_seed(0), vcfg, device="cpu")
vloss = lambda p, b: V.cls_loss(V.vit_forward(p, vcfg, b[0]), b[1])
vunl = Unlearner(adapters.vit_adapter(vcfg, device="cpu"),
                 spec=UnlearnSpec.for_mode("ficabu", checkpoint_every=1,
                                           chunk_size=4, use_kernel=True,
                                           sweep_mode="scanned"),
                 device="cpu")
vunl.ensure_fisher(vloss, vparams, (x[:16], y[:16]))
with telemetry.capture() as tel:
    _, _, g = vunl.forget_group([(x[:8], y[:8]), (x[8:16], y[8:16])],
                                params=vparams)
assert g["engine"]["sweep_mode"] == "scanned", g
assert tel.counts["engine.sweep"] == 1 and tel.counts["program.compile"] == 1
# a sharded request (the ResNet: conv leaves under the rules) on a one-rank
# gloo mesh equals the unsharded one
from repro_torch.launch.mesh import make_host_mesh
mesh = make_host_mesh(device="cpu")
shard = unl.with_spec(unl.spec).shard(mesh)
snew, sst = shard.forget(ForgetRequest(x[y == 1][:8], y[y == 1][:8]),
                         params=params)
assert sst["stopped_at_l"] == st["stopped_at_l"]
from repro_torch.models.module import flatten_with_paths
a, b = dict(flatten_with_paths(new)), dict(flatten_with_paths(snew))
assert all(torch.equal(a[k], b[k].full_tensor()) for k in a)
mesh.close()
leaked = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
print("MODULES", len(mods), "LEAKED", leaked, "STOP", st["stopped_at_l"])
"""


def test_port_serves_a_forget_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LEAKED []" in proc.stdout, proc.stdout
    assert int(proc.stdout.split("MODULES ")[1].split()[0]) >= 15


def test_entry_points_raise_without_a_card():
    """device="cuda" (the default) on a host with no card raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the host without one")
    cfg = V.ResNetConfig(width=8, n_classes=4, img_size=8)
    params = V.init_resnet(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    adapter = adapters.resnet_adapter(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        Unlearner(adapter)
    with pytest.raises(RuntimeError, match="is_available"):
        Unlearner(adapter, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        V.init_resnet(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        adapters.resnet_adapter(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        fisher.diag_fisher(lambda p, b: 0.0, params,
                           (torch.zeros(8, 8, 8, 3), torch.zeros(8)))


_BLOCKED_LM_RUN = _BLOCKED_RUN.split("import numpy as np")[0] + r"""
import torch

from repro_torch import configs
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec
from repro_torch.core import adapters
from repro_torch.data import synthetic as syn
from repro_torch.models import lm as LM

torch.set_num_threads(2)
cfg = configs.get("gemma3-1b").smoke.with_(n_layers=7, vocab=64, window=4)
params = LM.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
toks, doms = syn.make_lm_domains(syn.LMDataConfig(
    vocab=64, n_domains=2, seq_len=8, n_per_domain=8))
tok = torch.as_tensor(toks).long()
loss = lambda p, b: LM.lm_loss(p, cfg, b[0], b[1])
unl = Unlearner(adapters.lm_adapter(cfg, 8, device="cpu"),
                spec=UnlearnSpec.for_mode("ficabu", tau=-1.0, chunk_size=4,
                                          use_kernel=True,
                                          sweep_mode="scanned"),
                device="cpu")
unl.ensure_fisher(loss, params, (tok[:8, :-1], tok[:8, 1:]))
out = []
for precision in ("fp32", "int8"):
    new, st = unl.with_spec(UnlearnSpec.for_mode(
        "ficabu", tau=-1.0, chunk_size=4, use_kernel=True,
        sweep_mode="scanned", precision=precision)).forget(
            ForgetRequest(tok[8:16, :-1], tok[8:16, 1:]), params=params)
    assert st["engine"]["sweep_mode"] == "scanned", st["engine"]
    out.append(st["stopped_at_l"])
# an MoE request (llama4-scout-smoke: top-1 experts beside a shared one),
# its router left as it was
mcfg = configs.get("llama4-scout-17b-a16e").smoke
mparams = LM.init_lm(torch.Generator().manual_seed(0), mcfg, device="cpu")
mtok = tok.clamp(max=mcfg.vocab - 1)
munl = Unlearner(adapters.lm_adapter(mcfg, 8, device="cpu"),
                 spec=UnlearnSpec.for_mode("ssd", chunk_size=4,
                                           use_kernel=True), device="cpu")
munl.ensure_fisher(lambda p, b: LM.lm_loss(p, mcfg, b[0], b[1]), mparams,
                   (mtok[:8, :-1], mtok[:8, 1:]))
new, st = munl.forget(ForgetRequest(mtok[8:16, :-1], mtok[8:16, 1:]),
                      params=mparams)
assert torch.equal(new["period_stack"]["0"]["ffn"]["router"],
                   mparams["period_stack"]["0"]["ffn"]["router"])
out.append(st["stopped_at_l"])
# a whisper request (the encoder-decoder's decoder chain), then decode
from repro_torch.models import encdec as ED
wcfg = configs.get("whisper-tiny").smoke
wparams = ED.init_encdec(torch.Generator().manual_seed(0), wcfg, device="cpu")
frames = torch.randn(8, wcfg.n_frames, wcfg.d_model,
                     generator=torch.Generator().manual_seed(1))
wunl = Unlearner(adapters.encdec_adapter(wcfg, 8, frames, device="cpu"),
                 spec=UnlearnSpec.for_mode("ssd", chunk_size=8,
                                           use_kernel=True), device="cpu")
wunl.ensure_fisher(lambda p, b: ED.lm_loss(p, wcfg, b[0], b[1], frames),
                   wparams, (tok[:8, :-1], tok[:8, 1:]), chunk_size=8)
new, st = wunl.forget(ForgetRequest(tok[8:16, :-1], tok[8:16, 1:]),
                      params=wparams)
assert torch.equal(new["encoder"]["attn"]["wq"], wparams["encoder"]["attn"]["wq"])
out.append(st["stopped_at_l"])
memory = ED.encode(wparams, wcfg, frames[:2])
cache = ED.init_cache(wcfg, 2, 4, device="cpu")
for i in range(4):
    lg, cache = ED.decode_step(wparams, wcfg, tok[:2, i:i + 1], cache, i,
                               memory)
assert torch.isfinite(lg).all() and lg.shape == (2, 1, wcfg.vocab)
# one ForgetService drain of two domains, then its streamed Fisher refresh
from repro_torch.api import ServeSpec
from repro_torch.launch.serve import ForgetService
stoks, sdoms = syn.make_lm_domains(syn.LMDataConfig(
    vocab=64, n_domains=4, seq_len=8, n_per_domain=16))
svc = ForgetService(cfg, stoks, sdoms, 8, serve=ServeSpec(refresh_every=1),
                    device="cpu")
svc.submit(1, due_batch=1)
svc.submit(2, due_batch=1)
served, ran = svc.drain(params, 1)
assert ran and svc.group_log[0]["engine"]["sweep_mode"] == "scanned"
assert len(svc.refresh_log) == 1, svc.refresh_log
assert svc.staleness_report(served)["improved"]
out.append(svc.group_log[0]["requests"])
# a few StreamEngine steps with one shadow drain published at its deadline,
# then a checkpoint round trip of the published tree
import tempfile
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch.serve import StreamEngine
from repro_torch.models.module import tree_leaves
ssvc = ForgetService(cfg, stoks, sdoms, 8, serve=ServeSpec(publish="step"),
                     device="cpu")
ssvc.submit(1, due_batch=1)
eng = StreamEngine(params, cfg, gen_len=4, prompt_len=4, max_batch=2,
                   admit_chunk=2, publish_lag=2, service=ssvc, device="cpu")
for i in range(3):
    eng.enqueue(i, stoks[i, :4])
res = eng.run()
assert len(res) == 3 and eng.decode_cache_size() == 1
assert eng.params is ssvc.params and ssvc.params_version == 1
ckdir = tempfile.mkdtemp()
ckpt.save(ckdir, 1, {"params": eng.params})
back, _ = ckpt.restore(ckdir, 1, {"params": params}, device="cpu")
assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back["params"]),
                                             tree_leaves(eng.params)))
out.append(eng.publications)
# two train steps through the launcher's loop (the int8 codec on), then one
# request through the legacy CAU oracle
from repro_torch.core import cau
from repro_torch.launch import train as T
tr = T.train(cfg, "cpu", T.parse_args(
    ["--steps", "2", "--batch", "4", "--seq", "8", "--ckpt-every", "0",
     "--compress", "int8", "--ckpt-dir", tempfile.mkdtemp(),
     "--device", "cpu"]), params=params, data=(stoks, sdoms))
assert tr.result["steps_run"] == 2 and int(tr.opt.step) == 2
assert all(torch.isfinite(t).all() for t in tree_leaves(tr.params))
_, lst = cau.context_adaptive_unlearn_legacy(
    adapters.lm_adapter(cfg, 8, device="cpu"), params, unl.fisher_global,
    tok[8:16, :-1], tok[8:16, 1:],
    cau.UnlearnConfig(tau=-1.0, chunk_size=4, checkpoint_every=2))
out += [tr.result["steps_run"], lst["stopped_at_l"]]
# a dry-run cell counted on the host (fake tensors, one rank's rows) at an
# H100's peaks
from repro_torch.launch import dryrun as DR
rec = DR.run_cell("whisper-tiny", "decode_32k", False,
                  card="NVIDIA H100 80GB HBM3", device="cpu")
assert rec["status"] == "ok" and rec["roofline"]["step_time_bound_s"] > 0
out.append(rec["count"]["rows_per_rank"])
leaked = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
print("LEAKED", leaked, "STOP", out)
"""


def test_lm_serves_with_jax_and_repro_blocked():
    """The LM slice's modules (models.lm, the registry, the LM adapter and
    data) serve a scanned fp32 and int8 request, an MoE request and a
    whisper request (the encoder left as it was), whisper decodes, a
    ForgetService drains two domains and refreshes its Fisher, and a
    StreamEngine serves three sequences with one shadow drain published
    at its deadline, whose tree a checkpoint round trip restores, the train
    launcher's loop takes two steps with the int8 codec, the legacy CAU
    oracle serves a request and the dry run counts a cell, with JAX and the
    JAX package blocked."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_LM_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LEAKED [] STOP [9, 9, 4, 4, 2, 1, 2, 9, 8]" in proc.stdout, \
        proc.stdout


def test_lm_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the host without one")
    from repro_torch.configs import get
    from repro_torch.models import lm as LM
    cfg = get("gemma3-1b").smoke
    with pytest.raises(RuntimeError, match="is_available"):
        LM.init_lm(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        adapters.lm_adapter(cfg, 8)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--steps", "1"])
    # the dry run reads the card's peaks: without card= it asks for one
    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun.run_cell("yi-6b", "decode_32k", False)


def test_nothing_uses_torch_optim():
    """The port trains with its own AdamW (``repro_torch.optim``): no module
    of the port and not the chip smoke script imports or reaches
    ``torch.optim``."""
    offenders = []
    for path in sorted(PORT.rglob("*.py")) + [SMOKE]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                bad = any(a.name.startswith("torch.optim")
                          for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                bad = node.level == 0 and (node.module or "").startswith(
                    "torch.optim") or (node.module == "torch" and any(
                        a.name == "optim" for a in node.names))
            else:
                bad = (isinstance(node, ast.Attribute) and node.attr == "optim"
                       and isinstance(node.value, ast.Name)
                       and node.value.id == "torch")
            if bad:
                offenders.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not offenders, offenders
