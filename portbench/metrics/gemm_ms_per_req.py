"""Device time of the matrix products (``lib/kernel_classes.json``'s
``gemm`` class) in the traced window, per request, in ms."""


def read(r):
    if r.trace is None or not r.requests:
        return None
    return 1e3 * r.trace["by_class"].get("gemm", 0.0) / len(r.requests)
