"""torch.cuda.max_memory_allocated over the window (reset before it), in
GiB."""


def read(rec):
    if not rec.peak_window_bytes:
        return None
    return rec.peak_window_bytes / 2 ** 30
