"""Device time of every operation that is neither a matrix product nor a
kernel of the port's own (the Fisher's square-accumulate, upcasts, norms,
softmax, copies), in the traced window, per request, in ms."""


def read(r):
    if r.trace is None or not r.requests:
        return None
    return 1e3 * r.trace["by_class"].get("elementwise", 0.0) / len(r.requests)
