"""GiB of device memory at the window's peak (the caching allocator's
``max_memory_allocated`` since the window opened): the resident pool and
whatever a call allocates on top of it."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
