"""The recurrent-LM slice on recurrentgemma-9b-smoke (two (rglru, rglru,
local) periods and a two-layer rglru tail: 10 unlearn layers).

Every test of ``test_torch_recurrent_unlearn.py`` runs here again, on this
model (the ``served`` fixture below takes the place of that file's), with
the same settings and declared tolerances; see that file's docstring. The
two files split the two models' reference runs between two test workers,
and ``test_torch_recurrent_unlearn_bf16.py`` holds the bf16 model.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_recurrent_unlearn import *  # noqa: F401,F403,E402
from test_torch_recurrent_unlearn import _serve, _setting  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def served():
    s = _setting("recurrentgemma-9b")
    return s, _serve(s)
