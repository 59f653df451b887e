"""The dense GQA archs' slice on qwen1.5-32b-smoke (two "attn" blocks in
``period_stack``, 4 heads over 4 KV heads, q/k/v biases added
before RoPE: 4 unlearn layers).

Every per-model test of ``test_torch_dense_unlearn.py`` (its ``__all__``)
runs here again, on this model (the ``served`` fixture below takes the
place of that file's), with the same settings and declared tolerances; see
that file's docstring. The per-arch files split the three models'
reference runs between three test workers.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dense_unlearn import *  # noqa: F401,F403,E402
from test_torch_dense_unlearn import _serve, _setting  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def served():
    s = _setting("qwen1.5-32b")
    return s, _serve(s)
