"""Forget-set tokens of the requests completed in the window, over the
window (first submission to last completion): the backlog rate."""


def read(r):
    if not r.requests or r.window_s <= 0:
        return None
    return sum(q["tokens"] for q in r.requests) / r.window_s
