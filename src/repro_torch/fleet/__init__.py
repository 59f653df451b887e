"""Multi-tenant serving fleet (port of ``repro.fleet``): spec-driven tenant
registry, one drain scheduler, cross-tenant step sharing (DESIGN.md §13).

    from repro_torch.fleet import Fleet, FleetSpec, TenantSpec

    fleet = Fleet()
    fleet.add_tenant(TenantSpec("a"), cfg, tokens, domains, seq_len,
                     params=params, spec=spec, device="cuda")
    fleet.submit("a", domain=1, due_batch=1)
    fleet.drain(1)
"""
from .fleet import Fleet, TenantRuntime  # noqa: F401
from .scheduler import (POLICIES, DrainGroup,  # noqa: F401
                        DrainScheduler)
from .specs import (SCHEDULING_POLICIES, FleetSpec,  # noqa: F401
                    TenantSpec)
