"""Fault-tolerant checkpoints (port of ``repro.ckpt``)."""
from .checkpoint import (gc_old, journal_append, journal_read,  # noqa: F401
                         latest_step, restore, save)
