"""Experiment logging: a log file and stdout for messages, a JSONL file (and
TensorBoard, where tensorboardX is installed) for scalars.

Counterpart of dycon_paper_replication_tpu/utils/logging.py, with the same
scalar tags (info/loss, info/f_loss, train/Dice, ...).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any

try:
    from tensorboardX import SummaryWriter  # type: ignore
except ImportError:
    SummaryWriter = None


class ExperimentLogger:
    def __init__(self, snapshot_path: str, also_stdout: bool = True):
        os.makedirs(snapshot_path, exist_ok=True)
        self.snapshot_path = snapshot_path
        self.writer = (SummaryWriter(os.path.join(snapshot_path, "log"))
                       if SummaryWriter is not None else None)
        self.jsonl = open(os.path.join(snapshot_path, "metrics.jsonl"), "a")
        self.logger = logging.getLogger(f"dycon_torch.{os.path.basename(snapshot_path)}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.handlers.clear()
        fmt = logging.Formatter("[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S")
        handlers = [logging.FileHandler(os.path.join(snapshot_path, "log.txt"))]
        if also_stdout:
            handlers.append(logging.StreamHandler(sys.stdout))
        for h in handlers:
            h.setFormatter(fmt)
            self.logger.addHandler(h)

    def info(self, msg: str, *args: Any) -> None:
        self.logger.info(msg, *args)

    def scalar(self, tag: str, value: float, step: int) -> None:
        value = float(value)
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        self.jsonl.write(json.dumps({"t": time.time(), "tag": tag, "value": value,
                                     "step": step}) + "\n")

    def scalars(self, values: dict[str, float], step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)
        self.jsonl.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self.jsonl.close()
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
