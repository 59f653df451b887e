"""The dampening kernels' share of their memory roofline: the bytes the
rule needs for the layers each request swept (``lib/counts.dampen_bytes``)
at the card's HBM rate, over the device time of the ``ficabu_dampen_*``
kernels in the traced window (a scanned program also dampens the layers
past the halt, which the count leaves out)."""
from portbench.lib.counts import dampen_bytes


def read(r):
    if r.trace is None or not r.requests:
        return None
    t = r.trace["by_class"].get("dampen", 0.0)
    if t <= 0:
        return None
    need = sum(dampen_bytes(r.cell.dims, q["stats"]["stopped_at_l"])
               for q in r.requests)
    return 100.0 * need / r.peaks["hbm_bytes"] / t
