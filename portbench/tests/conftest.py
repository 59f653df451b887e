"""Fixtures of the benchmark's tests. Tests that need a CUDA card carry
the ``card`` marker and take the ``card`` fixture, which skips them where
there is none; nothing here looks for a card while a module is imported.

``smoke_root`` is a copy of ``BENCHMARK.json`` with two cells added as
files alone (a configuration and a workload file each, at the port's
SMOKE sizes of yi-6b and qwen1.5-32b), which the harness finds by name
like any other: the benchmark's own code is not edited to add them."""
from __future__ import annotations

import pytest

from support_portbench import make_smoke_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory):
    return make_smoke_root(tmp_path_factory.mktemp("smoke_root"))
