"""The stub modality prefix at the model level: the port's ``lm`` forward,
``lm_loss`` and ``lm_adapter`` against the JAX package's, on
internvl2-1b-smoke (two qkv-bias "attn" blocks, d_model 64, vocab 256,
``prefix_len`` 8: eight precomputed patch embeddings ahead of the tokens).

The model is the reference's own initialisation (PRNGKey(0)), bridged; the
tokens, labels and prefix come from numpy seeds. Declared tolerances: the
logits at rtol 1e-5 / atol 2e-5 (the LM tests' forward tolerance); the
loss at rtol 1e-6; its gradient at rtol 1e-4 / atol 1e-6 on every leaf;
the adapter's token accuracy and the ValueError texts EQUAL.

What the reference cannot do, the port does not do either: its layer
sweep cannot serve a forget request on a prefix model (the head layer's
output keeps the prefix positions, while the loss cotangent comes from
the token-only logits of ``forward_collect``), and the port's engine
refuses such an adapter with a ValueError that says why.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import internvl2_1b as jivl  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.core import fisher as tfisher  # noqa: E402
from repro_torch.engine import UnlearnSession  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

torch.set_num_threads(2)
SEQ = 16
N = 4


@pytest.fixture(scope="module")
def model():
    jcfg = jivl.SMOKE
    tcfg = tconfigs.get("internvl2-1b").smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(11)
    tok = rng.integers(0, jcfg.vocab, (N, SEQ)).astype(np.int32)
    lab = rng.integers(0, jcfg.vocab, (N, SEQ)).astype(np.int32)
    prefix = rng.standard_normal((N, jcfg.prefix_len, jcfg.d_model)).astype(
        np.float32)
    return jcfg, tcfg, params, tparams, tok, lab, prefix


def test_config_registered_as_the_reference():
    spec = tconfigs.get("internvl2-1b")
    for name in ("full", "smoke"):
        jc, tc = getattr(jivl, name.upper()), getattr(spec, name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
    assert (spec.kind, spec.source, spec.shapes(), spec.skip_shapes) == \
        (jivl.SPEC.kind, jivl.SPEC.source, jivl.SPEC.shapes(),
         jivl.SPEC.skip_shapes)
    assert tbase.PREFIX_CHUNKED_SKIP == jbase.PREFIX_CHUNKED_SKIP
    assert spec.full.prefix_len == 256 and spec.smoke.prefix_len == 8


def test_forward_and_loss_match_jax(model):
    """The logits over prefix + tokens, the loss over the token positions
    only, and the prefix=None ValueError, on both sides."""
    jcfg, tcfg, params, tparams, tok, lab, prefix = model
    jlog, jaux = JLM.forward(params, jcfg, jnp.asarray(tok),
                             jnp.asarray(prefix))
    tlog, taux = TLM.forward(tparams, tcfg, torch.from_numpy(tok),
                             torch.from_numpy(prefix))
    assert tuple(tlog.shape) == (N, jcfg.prefix_len + SEQ, jcfg.vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=2e-5)
    assert float(taux) == float(jaux) == 0.0
    jl = JLM.lm_loss(params, jcfg, jnp.asarray(tok), jnp.asarray(lab),
                     jnp.asarray(prefix))
    tl = TLM.lm_loss(tparams, tcfg, torch.from_numpy(tok),
                     torch.from_numpy(lab), torch.from_numpy(prefix))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    with pytest.raises(ValueError) as je:
        JLM.forward(params, jcfg, jnp.asarray(tok))
    with pytest.raises(ValueError) as te:
        TLM.forward(tparams, tcfg, torch.from_numpy(tok))
    assert str(te.value) == str(je.value)
    assert "requires a stub modality prefix" in str(te.value)


def test_loss_gradient_matches_jax(model):
    """The global Fisher of ``lm_loss`` with the prefix (the gradient
    squared, chunk by chunk) on every leaf, the prefix-position logits
    included in the forward and excluded from the loss."""
    jcfg, tcfg, params, tparams, tok, lab, prefix = model
    jp, tp = jnp.asarray(prefix), torch.from_numpy(prefix)
    jI = jfisher.diag_fisher(
        lambda p, b: JLM.lm_loss(p, jcfg, b[0], b[1], b[2]), params,
        (jnp.asarray(tok), jnp.asarray(lab), jp), chunk_size=2)
    tI = tfisher.diag_fisher(
        lambda p, b: TLM.lm_loss(p, tcfg, b[0], b[1], b[2]), tparams,
        (torch.from_numpy(tok), torch.from_numpy(lab), tp), chunk_size=2,
        device="cpu")
    want = bridge.paths(jax.tree_util.tree_map(np.asarray, jI))
    got = {k: v.numpy() for k, v in bridge.paths(tI).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert max(float(v.max()) for v in got.values()) > 1e-4


def test_adapter_views_match_jax(model):
    """``lm_adapter(cfg, S, prefix)``: the layer-0 output holds the prefix
    ahead of the embedded tokens, ``forward_collect`` returns token-only
    logits, ``loss`` / ``acc`` slice full-length logits to the token
    positions, and the MACs, layer keys and contexts equal the
    reference's."""
    jcfg, tcfg, params, tparams, tok, lab, prefix = model
    ja = jadapters.lm_adapter(jcfg, SEQ, prefix=jnp.asarray(prefix))
    ta = tadapters.lm_adapter(tcfg, SEQ, prefix=torch.from_numpy(prefix),
                              device="cpu")
    assert list(ta.layer_fwd_macs) == list(ja.layer_fwd_macs)
    assert [ta.layer_key(j) for j in range(ta.n_layers)] == \
        [ja.layer_key(j) for j in range(ja.n_layers)]
    assert ta.exclude is None and ja.exclude is None
    jx, jacts = ja.forward_collect(params, jnp.asarray(tok))
    tx, tacts = ta.forward_collect(tparams, torch.from_numpy(tok))
    assert tuple(tx.shape) == (N, SEQ, jcfg.vocab)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=2e-5)
    assert tuple(tacts[1].shape) == (N, jcfg.prefix_len + SEQ, jcfg.d_model)
    np.testing.assert_array_equal(tacts[1][:, :jcfg.prefix_len].numpy(),
                                  prefix)
    for j in range(1, ta.n_layers):
        np.testing.assert_allclose(tacts[j].numpy(), np.asarray(jacts[j]),
                                   rtol=1e-5, atol=2e-5, err_msg=j)
    full_t = ta.apply_layer(tparams, ta.n_layers - 1,
                            ta.get_layer(tparams, ta.n_layers - 1),
                            tacts[-1])
    full_j = ja.apply_layer(params, ja.n_layers - 1,
                            ja.get_layer(params, ja.n_layers - 1),
                            jacts[-1])
    assert tuple(full_t.shape) == (N, jcfg.prefix_len + SEQ, jcfg.vocab)
    tl = torch.from_numpy(lab)
    np.testing.assert_allclose(float(ta.loss(full_t, tl)),
                               float(ja.loss(full_j, jnp.asarray(lab))),
                               rtol=1e-6)
    assert float(ta.acc(full_t, tl)) == float(ja.acc(full_j,
                                                     jnp.asarray(lab)))
    assert float(ta.acc(tx, tl)) == float(ja.acc(jx, jnp.asarray(lab)))


def test_both_sides_sweeps_refuse_a_prefix_model(model):
    """The reference's forget request on the prefix adapter fails in its
    layer sweep (the head's vjp meets a cotangent without the prefix
    positions); the port's session, request and group raise a ValueError
    that says so before any sweep, and a model without a prefix is
    served."""
    jcfg, tcfg, params, tparams, tok, lab, prefix = model
    ja = jadapters.lm_adapter(jcfg, SEQ, prefix=jnp.asarray(prefix))
    ta = tadapters.lm_adapter(tcfg, SEQ, prefix=torch.from_numpy(prefix),
                              device="cpu")
    jI = jfisher.diag_fisher(
        lambda p, b: JLM.lm_loss(p, jcfg, b[0], b[1], b[2]), params,
        (jnp.asarray(tok), jnp.asarray(lab), jnp.asarray(prefix)),
        chunk_size=2)
    tI = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jI),
                                device="cpu")
    spec = dict(alpha=6.0, lam=0.5, tau=-1.0, chunk_size=2)
    with pytest.raises((ValueError, TypeError)):
        JUnlearner(ja, jI, JSpec.for_mode("ssd", **spec)).forget(
            JRequest(tok, lab), params=params)
    unl = Unlearner(ta, tI, UnlearnSpec.for_mode("ssd", use_kernel=True,
                                                 **spec), device="cpu")
    why = "reference's layer sweep cannot run such a model"
    with pytest.raises(ValueError, match=why):
        unl.forget(ForgetRequest(tok, lab), params=tparams)
    with pytest.raises(ValueError, match=why):
        unl.forget_group([ForgetRequest(tok, lab)] * 2, params=tparams)
    with pytest.raises(ValueError, match=why):
        UnlearnSession(ta, tI)
    assert "prefix_len=8" in ta.sweep_refusal
    plain = tadapters.lm_adapter(tcfg.with_(prefix_len=0), SEQ, device="cpu")
    assert plain.sweep_refusal is None
    _, st = Unlearner(plain, tI, UnlearnSpec.for_mode(
        "ssd", use_kernel=True, **spec), device="cpu").forget(
            ForgetRequest(tok, lab), params=tparams)
    assert st["stopped_at_l"] == plain.n_layers
