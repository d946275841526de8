"""Append-only text logging.

The port's copy of ``iou3dmatch_tpu/utils/logger.py`` (the reference's
``log_string``, ``log_train.txt`` and ``best.txt``, train.py:91-100,
609-611): every line goes to stdout and is appended to a file in the log
directory.
"""
import os
import sys


class Logger:
    def __init__(self, log_dir: str, filename: str = "log_train.txt"):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a")

    def log(self, msg: str) -> None:
        self._fh.write(msg + "\n")
        self._fh.flush()
        print(msg)
        sys.stdout.flush()

    __call__ = log

    def log_best(self, msg: str, filename: str = "best.txt") -> None:
        """Overwrites the best-metric file (train.py:609-611)."""
        with open(os.path.join(self.log_dir, filename), "w") as f:
            f.write(msg + "\n")

    def close(self) -> None:
        self._fh.close()
