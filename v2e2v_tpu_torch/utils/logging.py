"""Scalar training logger (port of ``v2e2v_tpu/utils/logging.py``).

The reference logs through an optional tensorboardX ``SummaryWriter``
(``train_e2v.py:73-76``). Here: tensorboardX when it imports, else a TSV file
``scalars.tsv`` of ``step, tag, value`` rows in ``logdir``.
"""

from __future__ import annotations

import os


class ScalarLogger:
    def __init__(self, logdir: str, enabled: bool = True):
        self.enabled = enabled
        self._tb = None
        self._tsv = None
        if not enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter  # type: ignore
        except ImportError:
            self._tsv = open(os.path.join(logdir, "scalars.tsv"), "a")
        else:
            self._tb = SummaryWriter(logdir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.enabled:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        elif self._tsv is not None:
            self._tsv.write(f"{step}\t{tag}\t{value}\n")
            self._tsv.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._tsv is not None:
            self._tsv.close()
