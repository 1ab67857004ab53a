"""prove_peak_gib: torch.cuda.max_memory_allocated() over the window, its
peak reset when the window opens."""


def read(record):
    if record["kind"] != "prove" or record.get("peak_window_bytes") is None:
        return None
    return record["peak_window_bytes"] / 2**30
