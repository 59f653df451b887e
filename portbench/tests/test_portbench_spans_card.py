"""On the card: the program's spans on the device trace's clock, and its
host-read counter against the synchronising calls PyTorch reports
(skipped without a card)."""
from __future__ import annotations

import warnings

import pytest

from support_portbench import ROOT  # noqa: F401  (puts the repo on the path)

# a SMOKE-size LM like the smoke cells' (support_portbench.SMOKE)
SEQS, SEQ = 4, 32


def _lm(mode: str):
    import torch

    from repro_torch.api import UnlearnSpec, Unlearner
    from repro_torch.core import adapters
    from repro_torch.models import lm as LM

    dev = torch.device("cuda")
    cfg = LM.LMConfig(name="smoke", n_layers=3, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=160, vocab=256, head_dim=16,
                      param_dtype="bfloat16")
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (3, SEQS, SEQ), generator=gen,
                         device=dev)
    spec = UnlearnSpec.for_mode("ficabu", alpha=25.0, lam=1.0, tau=-1.0,
                                checkpoint_every=2, chunk_size=2,
                                use_kernel=True, sweep_mode=mode)
    unl = Unlearner(adapters.lm_adapter(cfg, SEQ, device=dev), spec=spec,
                    device=dev)
    with torch.no_grad():
        labels = [LM.forward(params, cfg, t)[0].argmax(-1) for t in toks]
    unl.ensure_fisher(lambda p, b: LM.lm_loss(p, cfg, b[0], b[1]), params,
                      (toks[0], labels[0]), chunk_size=2)
    return unl, params, list(zip(toks[1:], labels[1:]))


def _synced(unl, params, req):
    """One request under ``set_sync_debug_mode("warn")``: (its stats, the
    synchronising calls reported)."""
    import torch

    from repro_torch.api import ForgetRequest

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, st = unl.forget(ForgetRequest(*req), params=params)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return st, sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.card
def test_span_edges_meet_the_profiled_kernel(card):
    import torch

    from portbench.lib.spans import Tracer
    from repro_torch.obs import telemetry as T

    with T.capture(spans=True, device=torch.device("cuda")) as t:
        tracer = Tracer().__enter__()
        try:
            torch.cuda._sleep(1000)
            with T.span("sleep"):
                torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
        finally:
            tracer.__exit__(None, None, None)
    (s,) = t.spans
    # the spin kernels left after the tracer's own: the warm one, the span's
    spins = [o for o in tracer.device_ops() if "spin_kernel" in o[0]]
    assert len(spins) == 2
    name, k0, k1 = spins[-1]
    assert abs(s["dev_start"] - k0) < 50e-6, (s, k0, k1)
    assert abs(s["dev_end"] - k1) < 50e-6, (s, k0, k1)
    # the span's events bracket the kernel on the device's own timer
    assert s["dev_ms"] >= 1e3 * (k1 - k0) * 0.999
    # and the device starts no earlier than the host asked it to
    assert s["dev_start"] >= s["host_start"] - 50e-6


@pytest.mark.card
@pytest.mark.parametrize("mode", ["layerwise", "scanned"])
def test_host_reads_are_the_synchronising_calls(card, mode):
    unl, params, reqs = _lm(mode)
    _synced(unl, params, reqs[0])          # builds and warms every step
    st, syncs = _synced(unl, params, reqs[1])
    assert st["engine"]["sweep_mode"] == mode
    want = 1 if mode == "scanned" else 5 + len(st["checkpoints_hit"])
    assert st["host_reads"] == want
    assert syncs == st["host_reads"]


@pytest.mark.card
@pytest.mark.parametrize("mode", ["layerwise", "scanned"])
def test_spans_add_no_synchronising_call(card, mode):
    import torch

    from repro_torch.obs import telemetry as T

    unl, params, reqs = _lm(mode)
    _synced(unl, params, reqs[0])
    _, off = _synced(unl, params, reqs[1])
    with T.capture(spans=True, device=torch.device("cuda")) as t:
        st, on = _synced(unl, params, reqs[1])
    assert on == off == st["host_reads"]
    assert all("dev_ms" in s for s in t.spans)
    reads = [s for s in t.spans if s["name"] == "read"]
    assert len(reads) == st["host_reads"]
