"""The card's peak allocated memory over the window, in GiB
(torch.cuda.max_memory_allocated, reset when the window starts)."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
