"""mem_peak_gib (GiB): the device memory that the window's work held at its
peak (``torch.cuda.max_memory_allocated``, reset when set-up ends, read by
the harness once the window has closed); nothing where no GPU was used."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
