"""repro_torch.robust — port of ``repro.robust``, the fleet's failure model.

Guarded drains (``GuardSpec``), deterministic seeded fault injection
(``FaultSpec``/``FaultInjector``), and the durable per-tenant
forget-request WAL (``ForgetWAL``), whose files either package reads.
See DESIGN.md §16 for the failure-model table.
"""
from .faults import SITES, FaultInjector, FaultSpec
from .guards import GUARD_KINDS, GuardSpec
from .wal import WAL_NAME, ForgetWAL

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "ForgetWAL",
    "GUARD_KINDS",
    "GuardSpec",
    "SITES",
    "WAL_NAME",
]
