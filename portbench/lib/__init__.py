"""The benchmark's own arithmetic and harness (see ``portbench``)."""
