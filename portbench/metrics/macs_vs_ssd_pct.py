"""The mean over the window's requests of the port's exact MAC count of
the request against plain SSD's (``stats["macs_vs_ssd_pct"]``): what
halting saves by the paper's measure."""


def read(r):
    if not r.requests:
        return None
    v = [q["stats"]["macs_vs_ssd_pct"] for q in r.requests]
    return sum(v) / len(v)
