"""A hard deadline for unattended entry points.

Counterpart of ``distributedconvrl_pde_control_tpu/utils/resilience.py``,
reduced to ``arm_hard_deadline``. The JAX module also retries a failed
attempt after a backend reset, for a transient fault of the TPU's remote
link; no such fault has been seen on the card, and a sticky CUDA error (an
illegal address, a device-side assert) poisons the process's context, so a
retry in the same process would fail the same way. The port makes one
attempt.

One difference from the JAX module: the hard deadline exits the process
with a non-zero status (``DEADLINE_EXIT``) after its callback, where the JAX
one exits 0. A run that failed on the card never ends in exit 0.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Callable

DEADLINE_EXIT = 3


def arm_hard_deadline(total_s: float, on_timeout: Callable[[], None]) -> threading.Timer:
    """After `total_s` seconds a daemon timer thread runs `on_timeout()`
    (say, print the one-line JSON of the failure) and ends the process with
    `DEADLINE_EXIT`. A thread blocked in a C call (a CUDA synchronize that
    never returns) releases the GIL, so the timer thread still runs. Returns
    the timer; call ``.cancel()`` on success."""

    def fire():  # pragma: no cover - exercised via subprocess tests
        try:
            on_timeout()
            sys.stdout.flush()
        finally:
            os._exit(DEADLINE_EXIT)

    timer = threading.Timer(total_s, fire)
    timer.daemon = True
    timer.start()
    return timer
