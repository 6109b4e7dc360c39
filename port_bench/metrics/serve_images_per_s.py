"""Images whose outputs reached the host in the window over the window's
seconds on the host clock (the window closes with a device synchronize)."""


def read(record):
    return record["images"] / record["window_s"] if record.get("window_s") else None
