"""The caching allocator's peak of allocated device memory over the window
(`torch.cuda.max_memory_allocated`), in GiB."""


def read(record):
    peak = record.get("peak_mem_bytes")
    return peak / 2**30 if peak else None
