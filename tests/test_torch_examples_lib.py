"""The port's two library examples (``examples/torch_quickstart.py`` and
``examples/torch_unlearn_lm_domain.py``) against the reference's
(``examples/quickstart.py`` and ``examples/unlearn_lm_domain.py``):

the reference example's pre-trained state is built with ``repro`` at the
example's sizes and seeds (its accuracies read through a jitted forward),
carried across with ``repro_torch.bridge``, and
the twin's ``run(device="cpu", params=...)`` serves the example's forget
request on it. The halt depth, the checkpoints hit and MACs vs SSD EQUAL
the reference's request on the same weights; every accuracy the example
prints agrees within ACC_ATOL (one sample or token of the evaluated set
may flip where the two Fishers differ in their last bits)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.optim import AdamWConfig, init_adamw, make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
STAT_KEYS = ("stopped_at_l", "checkpoints_hit", "macs_vs_ssd_pct")
ACC_ATOL = 1.0 / 64


def example(name):
    """An example script imported as a module (its ``__main__`` block does
    not run)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to_torch(params):
    return bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")


@pytest.fixture(scope="module")
def quickstart():
    """``examples/quickstart.py``'s steps 1-4 in the JAX package, then the
    twin's ``run`` on its pre-trained weights."""
    from repro.models import vision as JV
    dcfg = jsyn.ClsDataConfig(n_classes=6, n_per_class=32, img_size=16,
                              seed=0)
    x, y = jsyn.make_classification(dcfg)
    splits = jsyn.split_forget_retain(x, y, forget_class=3)
    cfg = JV.ResNetConfig(width=8, n_classes=6, img_size=16)
    params = JV.init_resnet(jax.random.PRNGKey(0), cfg)

    def loss_fn(p, b):
        return JV.cls_loss(JV.resnet_forward(p, cfg, b[0]), b[1])

    ocfg = AdamWConfig(lr=2e-3, total_steps=150, warmup_steps=10)
    step = jax.jit(make_train_step(loss_fn, ocfg))
    opt = init_adamw(ocfg, params)
    bt = jsyn.Batches((x, y), batch=48, seed=1)
    for _ in range(150):
        params, opt, _ = step(params, opt, next(bt))
    adapter = jadapters.resnet_adapter(cfg)
    unl = JUnlearner(adapter, spec=JSpec.for_mode(
        "ficabu", alpha=10.0, lam=1.0, tau=1 / 6 + 0.03, checkpoint_every=2))
    unl.ensure_fisher(loss_fn, params, (x[:128], y[:128]), chunk_size=8)
    fx, fy = splits["forget"]
    rx, ry = splits["retain"]

    fwd = jax.jit(lambda p, x: JV.resnet_forward(p, cfg, x))

    def accs(p):
        return tuple(float(jmetrics.accuracy(fwd(p, a), jnp.asarray(b)))
                     for a, b in ((fx, fy), (rx, ry)))

    before = accs(params)
    new, stats = unl.forget(JRequest(fx[:32], fy[:32], tag="class-3"),
                            params=params)
    want = {"before": before, "after": accs(new), "n_layers":
            adapter.n_layers, **{k: stats[k] for k in STAT_KEYS}}
    got = example("torch_quickstart").run("cpu", params=_to_torch(params))
    return got, want


def test_quickstart_halts_as_the_reference(quickstart):
    got, want = quickstart
    assert {k: got[k] for k in STAT_KEYS + ("n_layers",)} == \
        {k: want[k] for k in STAT_KEYS + ("n_layers",)}
    # the request halts partway: the checkpoints decide, not the depth
    assert got["stopped_at_l"] < got["n_layers"]


def test_quickstart_accuracies_agree(quickstart):
    got, want = quickstart
    for tag in ("before", "after"):
        np.testing.assert_allclose(got[tag], want[tag], rtol=0,
                                   atol=ACC_ATOL, err_msg=tag)
    # the forget class falls, the retained classes stay
    assert got["after"][0] < got["before"][0]
    assert got["after"][1] >= got["before"][1] - ACC_ATOL
    # the refresh folded the two retain microbatches into the EMA
    assert got["refresh"] == {"batches": 2, "ema_count": 2}
    assert "final_loss" not in got     # the pre-training was skipped


@pytest.fixture(scope="module")
def lm_domain():
    """``examples/unlearn_lm_domain.py`` in the JAX package, then the
    twin's ``run`` on its trained weights."""
    from repro.models import lm as JLM
    twin = example("torch_unlearn_lm_domain")
    cfg = JLM.LMConfig(name="demo", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=128, vocab=128)
    tokens, domains = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=128, n_domains=4, seq_len=24, n_per_domain=24, seed=1))
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg)

    def loss_fn(p, b):
        return JLM.lm_loss(p, cfg, b[0], b[1], aux_weight=0.0)

    ocfg = AdamWConfig(lr=3e-3, total_steps=120, warmup_steps=10)
    step = jax.jit(make_train_step(loss_fn, ocfg))
    opt = init_adamw(ocfg, params)
    bt = jsyn.Batches((tokens[:, :-1], tokens[:, 1:]), batch=32, seed=2)
    for _ in range(120):
        params, opt, _ = step(params, opt, next(bt))

    fwd = jax.jit(lambda p, t: JLM.forward(p, cfg, t)[0])

    def domain_accs(p):
        out = []
        for d in range(4):
            t = tokens[domains == d]
            out.append(float(jmetrics.token_accuracy(fwd(p, t[:, :-1]),
                                                     t[:, 1:])))
        return out

    pre = domain_accs(params)
    fb = jsyn.lm_split_forget_retain(tokens, domains, forget_domain=1)[
        "forget"][:24]
    unl = JUnlearner(jadapters.lm_adapter(cfg, 24), spec=JSpec.for_mode(
        "ficabu", alpha=6.0, lam=0.5, tau=pre[1] * 0.5, checkpoint_every=1))
    unl.ensure_fisher(loss_fn, params, (tokens[:64, :-1], tokens[:64, 1:]),
                      chunk_size=8)
    new, stats = unl.forget(JRequest(fb[:, :-1], fb[:, 1:], tag="domain-1"),
                            params=params)
    want = {"pre": pre, "post": domain_accs(new),
            **{k: stats[k] for k in STAT_KEYS}}
    # the twin's config and data are the reference's
    assert twin.CFG.__dict__ == cfg.__dict__
    return twin.run("cpu", params=_to_torch(params)), want


def test_lm_domain_halts_as_the_reference(lm_domain):
    got, want = lm_domain
    assert {k: got[k] for k in STAT_KEYS} == {k: want[k] for k in STAT_KEYS}


def test_lm_domain_accuracies_agree(lm_domain):
    got, want = lm_domain
    for tag in ("pre", "post"):
        np.testing.assert_allclose(got[tag], want[tag], rtol=0,
                                   atol=ACC_ATOL, err_msg=tag)
    # domain 1 falls; the forget request's tau is half its accuracy
    assert got["post"][1] < got["pre"][1]
