"""The dry run's session cell on a real mesh: ``run_unlearn_session`` on
two spawned gloo ranks against the reference's run of the same cell on two
host devices (``run_fisher_refresh`` is held the same way in
``test_torch_dryrun_refresh.py``). The reference's ``dryrun`` module sets
XLA_FLAGS at import, so its cell runs in a subprocess, started first so
that the two runs overlap.

The reference builds its meshes with ``jax.make_mesh``, written for the
Auto axes that were its default; JAX's Explicit default makes its
embedding gather refuse the layout (a ShardingTypeError), so the
subprocess passes Auto axis types, changing nothing in the package.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import dryrun as DR

torch.set_num_threads(2)
MESH = (2, 1)
REF = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import AxisType
    _make = jax.make_mesh
    jax.make_mesh = lambda shape, axes, **kw: _make(
        shape, axes, axis_types=(AxisType.Auto,) * len(axes), **kw)
    from repro.launch import dryrun
    cell, shape = sys.argv[1], tuple(json.loads(sys.argv[2]))
    run = (dryrun.run_unlearn_session if cell == "session"
           else dryrun.run_fisher_refresh)
    print("RESULT " + json.dumps(run("gemma3-1b", shape), default=str))
""")


def cell_runs(cell: str):
    """(the port's record, the reference's) of ``cell`` ("session" or
    "refresh") on the 2 x 1 mesh; the reference's in a subprocess that
    runs beside the port's spawned ranks."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF, cell, json.dumps(MESH)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        run = (DR.run_unlearn_session if cell == "session"
               else DR.run_fisher_refresh)
        port = run("gemma3-1b", MESH, device="cpu", timeout_s=600)
        out, err = proc.communicate(timeout=900)
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert proc.returncode == 0 and lines, err[-3000:]
        return port, json.loads(lines[-1][len("RESULT "):])
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope="module")
def runs():
    return cell_runs("session")


def test_unlearn_session_matches_the_reference(runs):
    port, ref = runs
    assert port["status"] == ref["status"] == "ok", (port, ref)
    assert port["ranks"] == 2 and port["mesh"] == ref["mesh"] == "2x1"
    for k in ("stopped_at_l", "sweeps", "fisher_leaves_sharded",
              "donating_single_request", "domains"):
        assert port[k] == ref[k], k
    for k in ("mode", "stopped_at_l", "matches_layerwise", "warm_compiles",
              "warm_retraces"):
        assert port["scanned_sweep"][k] == ref["scanned_sweep"][k], k
    assert port["engine_warm"]["compiles"] == ref["engine_warm"][
        "compiles"] == 0
    # the edited tree's leaves: the port stores each by its spec (the
    # Fisher's layout); XLA may lay a replicated leaf's output out sharded
    n_port, n_ref = port["params_leaves_sharded"], ref[
        "params_leaves_sharded"]
    assert n_port[1] == n_ref[1]
    assert n_port == port["fisher_leaves_sharded"]
    assert 0 < n_port[0] <= n_ref[0]
    assert port["spec"] == ref["spec"]
