"""Host milliseconds from the call of the serving module to its return (the
enqueue of the forward and the decode), the mean over the traced window's
batches (the harness's span `serve_call`)."""


def read(record):
    d = record["spans"].get("serve_call")
    return 1e3 * sum(d) / len(d) if d else None
