"""Step builds of the port's engine over the window's requests (its
``stats["engine"]["compiles"]``): 0 when set-up warmed every step."""


def read(r):
    if not r.requests:
        return None
    return float(sum(q["stats"]["engine"]["compiles"] for q in r.requests))
