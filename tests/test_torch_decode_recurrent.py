"""The decode, prefill and cache forms of the recurrent LM families
against the reference's own functions: every per-arch test of
``test_torch_decode.py`` (``__all__``) on xlstm-125m-smoke (mLSTM and
sLSTM states) and recurrentgemma-9b-smoke (RG-LRU states and conv
history beside a local attention's ring buffer), with its tolerances; and
each recurrent block's decode step against the reference's over a few
steps from a state of random contents.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_decode import *  # noqa: E402,F401,F403
from test_torch_decode import TOL_CACHE, TOL_STEP, _close_trees, _model  # noqa: E402

from repro.models import recurrent as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["xlstm-125m", "recurrentgemma-9b"])
def model(request):
    return _model(request.param)


def _weights(init, cfg, seed):
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(
            np.float32),
        jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg)))
    return jax.tree_util.tree_map(jnp.asarray, p), \
        bridge.params_to_torch(p, device="cpu")


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "rglru"])
def test_block_decode_steps_match_jax(kind):
    """Five steps of the block's decode from a state of random contents
    (the state init's shapes and dtypes equal the reference's): outputs
    and states after each step."""
    jcfg, tcfg, init, jinit, tinit, jdec, tdec = {
        "mlstm": (JR.MLSTMConfig(32, 4, 8, 4), TR.MLSTMConfig(32, 4, 8, 4),
                  JR.init_mlstm, JR.init_mlstm_state, TR.init_mlstm_state,
                  JR.mlstm_decode, TR.mlstm_decode),
        "slstm": (JR.SLSTMConfig(32, 4), TR.SLSTMConfig(32, 4),
                  JR.init_slstm, JR.init_slstm_state, TR.init_slstm_state,
                  JR.slstm_decode, TR.slstm_decode),
        "rglru": (JR.RGLRUConfig(32, 48), TR.RGLRUConfig(32, 48),
                  JR.init_rglru, JR.init_rglru_state, TR.init_rglru_state,
                  JR.rglru_decode, TR.rglru_decode)}[kind]
    jp, tp = _weights(init, jcfg, 31)
    _close_trees(tinit(tcfg, 3, device="cpu"), jinit(jcfg, 3), rtol=0,
                 atol=0)
    rng = np.random.default_rng(32)
    state = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.5,
        jinit(jcfg, 3))
    js = jax.tree_util.tree_map(jnp.asarray, state)
    ts = jax.tree_util.tree_map(torch.from_numpy, state)
    for i in range(5):
        x = rng.normal(size=(3, 1, 32)).astype(np.float32)
        jo, js = jdec(jp, jcfg, jnp.asarray(x), js)
        to, ts = tdec(tp, tcfg, torch.from_numpy(x), ts)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                   err_msg=f"step {i}", **TOL_STEP)
        _close_trees(ts, js, **TOL_CACHE)
