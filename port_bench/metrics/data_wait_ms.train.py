"""Host milliseconds a step waits for its batch from the program's data
layer (`data.pipeline.prefetch_to_device`), the mean over the traced
window's steps (the harness's span `data_wait`)."""


def read(record):
    d = record["spans"].get("data_wait")
    return 1e3 * sum(d) / len(d) if d else None
