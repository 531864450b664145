"""Metrics logging: metrics.jsonl always, tensorboard scalars when available
(port of mapdn_tpu/utils/logging.py).

Mirrors the reference's logging surface (reference trainer.py:115-117 logs
every stat under 'data/<name>'; train.py:92,107-111 dumps the config to
log.txt).  Tensorboard scalars are written only where
``torch.utils.tensorboard`` imports (it needs the ``tensorboard`` package);
that is a choice of output, not of device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def log(self, stats: dict, step: int):
        rec = {"step": step, "time": time.time(), **stats}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in stats.items():
                # reference tag scheme 'data/<stat>' (trainer.py:115-117)
                self._tb.add_scalar("data/" + k, v, step)

    def drop_after(self, step: int):
        """Keep only the records up to ``step``: a run resumed from the
        checkpoint of episode ``step`` logs the episodes after it again, and
        the killed run's records of those episodes must not stay beside
        them.  A line cut short by the kill goes too."""
        path = self._jsonl.name
        self._jsonl.close()
        kept = []
        with open(path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec["step"] <= step:
                    kept.append(line if line.endswith("\n") else line + "\n")
        with open(path, "w") as fh:
            fh.writelines(kept)
        self._jsonl = open(path, "a")

    def log_config(self, alg_config, env_config, initial_weights=None):
        """Config dump (reference train.py:107-111 log.txt), and the file
        the run's initial weights came from where given."""
        with open(os.path.join(self.log_dir, "log.txt"), "w") as f:
            f.write("alg_params:\n")
            for k, v in sorted(dataclasses.asdict(alg_config).items()):
                f.write(f"\t{k}: {v}\n")
            f.write("env_params:\n")
            for k, v in sorted(env_config.items()):
                f.write(f"\t{k}: {v}\n")
            if initial_weights:
                f.write(f"initial_weights: {initial_weights}\n")

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
