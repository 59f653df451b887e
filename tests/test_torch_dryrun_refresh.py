"""The dry run's refresh cell on a real mesh: ``run_fisher_refresh`` on two
spawned gloo ranks against the reference's run of the same cell on two
host devices, in a subprocess (``test_torch_dryrun_session.cell_runs``);
and the sharding gate on a one-rank mesh."""
import pytest
import torch

from repro_torch.launch import dryrun as DR
from test_torch_dryrun_session import cell_runs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs():
    return cell_runs("refresh")


def test_fisher_refresh_matches_the_reference(runs):
    port, ref = runs
    assert port["status"] == ref["status"] == "ok", (port, ref)
    for k in ("warm_retraces", "drain_warm_compiles",
              "fisher_leaves_sharded", "spec"):
        assert port[k] == ref[k], k
    for r in ("refresh_cold", "refresh_warm"):
        assert port[r]["engine"]["refresh_compiles"] == ref[r]["engine"][
            "refresh_compiles"]
        assert port[r]["batches"] == ref[r]["batches"]
    for rec in (port, ref):
        assert rec["refreshed_rel_err"] < rec["stale_rel_err"]


def test_one_rank_fires_the_sharding_gate():
    """On a 1 x 1 mesh nothing is sharded: the reference's gate fires, so
    these cells need two ranks or more."""
    rec = DR.run_unlearn_session("gemma3-1b", (1, 1), device="cpu",
                                 timeout_s=300)
    assert rec["status"] == "error"
    assert "no edited parameter leaf ended up sharded" in rec["error"]
