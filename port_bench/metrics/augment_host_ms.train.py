"""Host milliseconds of the device augment's call (its host draws, their
copy and the enqueue of its device work), the mean over the traced
window's steps (the harness's span `augment`)."""


def read(record):
    d = record["spans"].get("augment")
    return 1e3 * sum(d) / len(d) if d else None
