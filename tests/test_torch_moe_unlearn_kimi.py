"""The MoE slice on kimi-k2-smoke (two "attn" blocks in ``period_stack``,
each FFN a mixture of 8 experts, top-2, with a shared expert; d_model 64,
d_ff 32: 4 unlearn layers).

Every per-model test of ``test_torch_moe_unlearn.py`` (its ``__all__``,
which holds the dense slice's per-model tests too) runs here again, on this
model (the ``served`` fixture below takes the place of that file's), with
the same settings and declared tolerances; see that file's docstring. With
top-2 the renormalised gates carry the routers' gradient through the
loss, so their Fisher is no rounding noise here even without the aux
loss. The two files split the two models' reference runs between two test
workers.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_moe_unlearn import *  # noqa: F401,F403,E402
from test_torch_moe_unlearn import _serve, _setting  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def served():
    s = _setting("kimi-k2-1t-a32b")
    return s, _serve(s)
