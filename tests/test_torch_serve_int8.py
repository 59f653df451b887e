"""``tests/test_torch_serve.py``'s ``ForgetService`` parity in int8
(``ServeSpec(precision="int8")``): the same bursts and refreshes, scanned
and layerwise; the group / request / refresh logs EQUAL the reference's,
the served tree bit-equal on >= 99.9% of each leaf, the Fisher within the
Fisher tolerance, and the int8 family's launches counted as the
reference counts them."""
import pytest

torch = pytest.importorskip("torch")
from test_torch_serve import (deterministic,  # noqa: E402,F401
                              service_parity, tiny)

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["scanned", "layerwise"])
def test_forget_service_int8_matches_reference(  # noqa: F811
        tiny, deterministic, mode):
    service_parity(tiny, mode, "int8")
