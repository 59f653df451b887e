"""Distributed substrate: the sharding rules for the production mesh
(``sharding``) and the sharded execution of a request on DTensor storage
(``execute``)."""
from . import execute, sharding  # noqa: F401
