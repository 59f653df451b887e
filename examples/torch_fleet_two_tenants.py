"""Fleet example on the PyTorch/CUDA port: TWO same-family tenants (plus one
from a different family) served by one process — each with its own
weights, forget queue and tenant-scoped Fisher, all drained by ONE
scheduler and built into ONE shared program cache
(``repro_torch.fleet``).

The walkthrough below builds the ``FleetSpec`` in code, writes it to a
JSON file, and runs it through ``serve.py --fleet --check``. The check
asserts the two headline contracts of multi-tenant serving:

  * SHARING — the same-family tenants ('acme', 'globex') build each
    engine program family exactly once between them: globex's first drain
    replays acme's programs with zero builds, and the shared cache holds
    no more programs than a single-tenant run would build;
  * ISOLATION — replaying one tenant ALONE on a fresh cache reproduces its
    in-fleet weights and Fisher bit-for-bit: shared programs never share
    tenant state.

The same fleet and traffic as ``examples/fleet_two_tenants.py``, with
``--device`` passed through.

    PYTHONPATH=src python examples/torch_fleet_two_tenants.py               # card
    PYTHONPATH=src python examples/torch_fleet_two_tenants.py --device cpu  # host
"""
import argparse
import os
import tempfile

from repro_torch.fleet import FleetSpec, TenantSpec
from repro_torch.launch import serve

FLEET = FleetSpec(
    tenants=(
        TenantSpec("acme", arch="gemma3-1b", seed=0),
        TenantSpec("globex", arch="gemma3-1b", seed=1),   # same family
        TenantSpec("initech", arch="qwen1.5-32b", seed=2, weight=2.0),
    ),
    scheduling="fair",
)


# serve.py's arguments, the reference example's
ARGS = ["--requests", "4", "--prompt-len", "8", "--gen-len", "4",
        "--unlearn-after", "1", "--forget-domains", "1,2", "--check"]


def summary(res) -> dict:
    """What the script prints of a ``serve --fleet`` result: the shared
    program cache's counts and, per tenant, its drain groups and sweeps,
    its first drain's builds and hits and every drain's builds."""
    return {"cache": res["fleet_stats"]["program_cache"],
            "tenants": {name: {
                "groups": t["coalesced_groups"], "sweeps": t["sweeps"],
                "first_drain": {k: t["group_log"][0]["engine"][k]
                                for k in ("compiles", "cache_hits")},
                "drain_compiles": [g["engine"]["compiles"]
                                   for g in t["group_log"]]}
                for name, t in sorted(res["tenants"].items())}}


def run(device="cuda") -> dict:
    """``serve --fleet --check`` over FLEET on ``device`` (the check's solo
    replay holds the tenant bit for bit, under deterministic algorithms on
    the card; a failed gate raises SystemExit). Returns ``summary`` of its
    result."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet.json")
        with open(path, "w") as f:
            f.write(FLEET.to_json(indent=1))
        res = serve.main(["--fleet", path] + ARGS
                         + ["--device", str(device)])
    return summary(res)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    res = run(ap.parse_args().device)
    tenants = res["tenants"]
    assert set(tenants) == {"acme", "globex", "initech"}
    # sharing: globex rode acme's programs — zero builds, all hits
    acme0 = tenants["acme"]["first_drain"]
    globex0 = tenants["globex"]["first_drain"]
    assert acme0["compiles"] > 0
    assert globex0["compiles"] == 0 and globex0["cache_hits"] > 0
    # the different family paid its own builds, in its own namespace
    assert tenants["initech"]["first_drain"]["compiles"] > 0

    cache = res["cache"]
    print(f"tenants: {sorted(tenants)}")
    print(f"shared program cache: {cache['programs']} programs, "
          f"{cache['compiles']} compiles, {cache['hits']} cross-tenant hits "
          f"across {cache['sessions']} engine sessions")
    for name, t in tenants.items():
        print(f"  {name}: {t['groups']} drain group(s), {t['sweeps']} "
              f"sweep(s), first-drain compiles={t['first_drain']['compiles']}")
    print("fleet check passed: same-family compile-once + bit-exact tenant "
          "isolation (asserted by --check)")
