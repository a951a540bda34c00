"""peak_mem_mb: torch.cuda.max_memory_allocated() over set-up and window,
after reset_peak_memory_stats() at process start; 1 MB = 10^6 bytes."""


def read(run):
    return run.peak_bytes / 1e6 if run.peak_bytes else None
