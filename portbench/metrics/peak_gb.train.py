"""peak_gb.train: torch.cuda.max_memory_allocated over the window (reset at its start), in GB."""


def read(cell, counters):
    peak = counters.get("peak_window_bytes")
    return peak / 1e9 if peak else None
