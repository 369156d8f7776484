"""Peak device memory over the window in GB (``max_memory_allocated``
after ``reset_peak_memory_stats`` at the window's start)."""


def read(rec):
    b = rec.get("peak_window_bytes")
    return b / 1e9 if b else None
