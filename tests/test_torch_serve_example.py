"""The serving example's configuration (``examples/serve_with_unlearning.py``
and its twin ``examples/torch_serve_with_unlearning.py``) in both packages,
on the SAME weights: gemma3-1b SMOKE drawn by the reference's
``init_lm(PRNGKey(0))`` (as its ``serve.main`` draws them) and carried
across with ``repro_torch.bridge``; the data ``serve.main`` makes (4
domains x 16 sequences of prompt + generated tokens, seed 0); forget
domain 1 due after batch 1, the three batch drains and the final flush;
``ServeSpec(refresh_every=1)`` (the example's spec without its cache
directory: a compilation cache is process-wide).

The port's ``ForgetService`` EQUALS the reference's: the request's halt
depth and MACs vs SSD, the refreshes run, the number of parameter entries
the drains change and the staleness figures within STALE_ATOL, with the
same ``improved`` verdict. On these weights the drain halts at l = 1 and
changes no entry, so the refreshed Fisher is no closer than the stale one
to a recompute: the reference example's ``assert
refresh["staleness"]["improved"]`` fails on its own weights (ROADMAP.md,
Queue 3), and the port agrees."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.api import ServeSpec as JServeSpec  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.api import ServeSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
STALE_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def reference_archs():
    """Every reference architecture registered: ``repro.configs`` fills its
    registry only where it is empty, and a test run earlier in this process
    may have imported a few of its config modules one by one."""
    jconfigs._load_all()


@pytest.fixture(scope="module")
def args():
    """The twin's serve arguments (its ``ARGS``), as a dict."""
    spec = importlib.util.spec_from_file_location(
        "torch_serve_with_unlearning",
        ROOT / "examples" / "torch_serve_with_unlearning.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ns = {}
    for flag, value in zip(mod.ARGS[::2], mod.ARGS[1::2]):
        ns[flag.lstrip("-").replace("-", "_")] = value
    assert ns == {"arch": "gemma3-1b", "requests": "4", "prompt_len": "12",
                  "gen_len": "6", "unlearn_after": "1", "forget_domain": "1",
                  "fisher_refresh": "1"}
    return ns


def _changed(before, after):
    """Parameter entries that differ between two trees of numpy arrays."""
    a, b = bridge.paths(before), bridge.paths(after)
    return sum(int((a[k] != b[k]).sum()) for k in a)


@pytest.fixture(scope="module")
def both(args):
    """The example's service in the port and in the reference, on the
    reference's weights: (port, reference) summaries."""
    jcfg = jconfigs.get(args["arch"]).smoke
    tcfg = configs.get(args["arch"]).smoke
    seq_len = int(args["prompt_len"]) + int(args["gen_len"])
    toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=jcfg.vocab, n_domains=4, seq_len=seq_len, n_per_domain=16,
        seed=0))
    jp = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    jtree = jax.tree_util.tree_map(np.asarray, jp)
    tp = bridge.params_to_torch(jtree, device="cpu")
    # serve.main's batches: up to three of --requests prompts, a drain
    # after each, then the flush
    n_batches = len(range(0, len(toks) - int(args["requests"]),
                          int(args["requests"]))[:3])
    kw = dict(refresh_every=int(args["fisher_refresh"]))
    svc = serve.ForgetService(tcfg, toks, doms, seq_len,
                              serve=ServeSpec(**kw), device="cpu")
    jsvc = jserve.ForgetService(jcfg, toks, doms, seq_len,
                                serve=JServeSpec(**kw))
    out = []
    for s, p, to_numpy in (
            (svc, tp, bridge.params_to_numpy),
            (jsvc, jp, lambda t: jax.tree_util.tree_map(np.asarray, t))):
        s.submit(int(args["forget_domain"]),
                 due_batch=int(args["unlearn_after"]))
        for idx in list(range(1, n_batches + 1)) + [float("inf")]:
            p, _ = s.drain(p, idx)
        done = [r for r in s.log if "engine" in r]
        out.append({"requests": len(done),
                    "stopped_at_l": done[-1]["stopped_at_l"],
                    "macs_vs_ssd_pct": done[-1]["macs_vs_ssd_pct"],
                    "refreshes": len(s.refresh_log),
                    "staleness": s.staleness_report(p),
                    "changed": _changed(jtree, to_numpy(p)),
                    "spec": s.spec.to_json()})
    return out


def test_drain_halts_as_the_reference(both):
    got, want = both
    for k in ("requests", "stopped_at_l", "macs_vs_ssd_pct", "refreshes",
              "spec"):
        assert got[k] == want[k], k
    assert got["requests"] == 1 and got["refreshes"] >= 1


def test_drain_changes_the_entries_the_reference_changes(both):
    got, want = both
    assert got["changed"] == want["changed"]
    # on the reference's weights the halting drain selects nothing
    assert want["changed"] == 0


def test_staleness_equals_the_reference(both):
    got, want = both
    a, b = got["staleness"], want["staleness"]
    assert a["improved"] is b["improved"]
    for k in ("stale_rel_err", "refreshed_rel_err"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=STALE_ATOL,
                                   err_msg=k)
    # the reference example's check fails on its own weights (Queue 3)
    assert b["improved"] is False
