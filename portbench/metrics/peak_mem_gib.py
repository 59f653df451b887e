"""``torch.cuda.max_memory_allocated()`` over the window, in GiB."""


def read(r):
    if not r.peak_window_bytes:
        return None
    return r.peak_window_bytes / 2.0 ** 30
