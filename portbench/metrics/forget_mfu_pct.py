"""The whole request's share of the card's dense bf16 peak: the FLOPs the
algorithm needs for the window's requests at their halt depths
(``lib/counts.request_flops``) over the traced window."""
from portbench.lib.counts import request_flops


def read(r):
    if r.trace is None or not r.requests or r.window_s <= 0:
        return None
    s = r.cell.spec
    flops = sum(request_flops(r.cell.dims, int(s["seqs_per_request"]),
                              int(s["seq_len"]), int(s["chunk_size"]),
                              q["stats"]["stopped_at_l"],
                              q["stats"]["checkpoints_hit"])
                for q in r.requests)
    return 100.0 * flops / (r.window_s * r.peaks["bf16_flops"])
