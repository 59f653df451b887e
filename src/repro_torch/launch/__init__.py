"""Launchers of the port (``serve``: batch-mode serving with in-place
unlearning between batches)."""
