"""Seconds on the host clock from the process's start to the first timed
step: imports, weights and pools made on the card, the program built, the
compared steps or batches and the warm-up."""


def read(record):
    return record.get("setup_s")
