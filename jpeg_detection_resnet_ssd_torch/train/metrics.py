"""Metric sinks: CSV, and TensorBoard where it is installed.

Counterpart of the JAX package's `train/metrics.py`: one `MetricWriter` fans
scalar rows out to `{run_dir}/results/results.csv` and, when asked and when
`torch.utils.tensorboard` imports, to `{run_dir}/tensorboard`.
"""

from __future__ import annotations

import os

from jpeg_detection_resnet_ssd_torch.train.checkpoints import CSVLogger


class TensorBoardSink:
    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(logdir)

    def log(self, row: dict, step: int):
        for k, v in row.items():
            try:
                self._writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                continue
        self._writer.flush()

    def close(self):
        self._writer.close()


class MetricWriter:
    """Fan scalar metrics out to CSV and (optionally) TensorBoard."""

    def __init__(self, run_dir: str | None = None, csv_name: str = "results.csv",
                 tensorboard: bool = False):
        self._sinks = []
        self._csv = None
        if run_dir is not None:
            os.makedirs(os.path.join(run_dir, "results"), exist_ok=True)
            self._csv = CSVLogger(os.path.join(run_dir, "results", csv_name))
            if tensorboard:
                try:
                    self._sinks.append(TensorBoardSink(os.path.join(run_dir, "tensorboard")))
                except ImportError:
                    pass

    def log(self, row: dict, step: int | None = None):
        if self._csv is not None:
            self._csv.log(row)
        s = int(step if step is not None else row.get("step", 0))
        for sink in self._sinks:
            sink.log(row, s)

    def close(self):
        for sink in self._sinks:
            sink.close()
