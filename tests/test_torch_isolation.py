"""The port stands alone: no module of ``repro_torch`` (``obs`` and
``engine.sweep`` included) and not the chip smoke script imports ``jax``
or the JAX package ``repro``, the port serves a forget request, and a
scanned coalesced group under a telemetry capture, with both blocked,
and its entry points refuse to run on an absent card instead of quietly
falling back to the host."""
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
