"""Host milliseconds from the call of `Trainer.train_step` to its return,
the mean over the traced window's steps (the harness's span `train_step`)."""


def read(record):
    d = record["spans"].get("train_step")
    return 1e3 * sum(d) / len(d) if d else None
