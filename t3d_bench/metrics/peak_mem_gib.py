"""peak_mem_gib (`.train`): `torch.cuda.max_memory_allocated()` over
the window, after `reset_peak_memory_stats()` at its start; the fullest
rank."""


def read(rd):
    if not rd.peak_window_bytes:
        return None
    return max(rd.peak_window_bytes) / 2 ** 30
