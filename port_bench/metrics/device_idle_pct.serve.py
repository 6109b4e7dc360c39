"""Share of the traced window in which no operation ran on the card, in %."""


def read(record):
    if not record["window_s"] or not record["busy_s"]:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
