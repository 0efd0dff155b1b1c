"""Console logging with per-subsystem colors + progress (counterpart of
splatslam_tpu/utils/printer.py)."""

from __future__ import annotations

import sys
import time


class FontColor:
    ERROR = "\033[91m"
    INFO = "\033[94m"
    TRACKER = "\033[92m"
    MAPPER = "\033[95m"
    EVAL = "\033[93m"
    PCL = "\033[96m"
    NONE = ""
    _RESET = "\033[0m"


class Printer:
    def __init__(self, total_frames: int = 0, verbose: bool = True):
        self.total = total_frames
        self.done = 0
        self.verbose = verbose
        self.t0 = time.time()

    def print(self, msg, color=FontColor.INFO):
        if self.verbose:
            sys.stdout.write(f"{color}{msg}{FontColor._RESET}\n")
            sys.stdout.flush()

    def update_pbar(self, n: int = 1):
        self.done += n
        if self.verbose and self.total and (
                self.done % max(self.total // 20, 1) == 0
                or self.done == self.total):
            dt = time.time() - self.t0
            fps = self.done / max(dt, 1e-6)
            sys.stdout.write(
                f"\r[{self.done}/{self.total}] {fps:.2f} fps ")
            sys.stdout.flush()

    def terminate(self):
        if self.verbose:
            sys.stdout.write("\n")
