"""Device-init watchdog: a deadline on the first touch of the GPU.

Counterpart of ``recnext_tpu/utils/watchdog.py``. An entry point that must end
(a benchmark, a server, an export) wraps its first CUDA call in
``require_devices``: if ``torch.cuda.init()`` and ``device_count()`` have not
returned by the deadline, it prints one JSON error line and leaves with
``os._exit(17)`` (a thread blocked in the driver cannot be interrupted any other
way). With no GPU present it raises, as ``device.py:resolve_device`` does.
"""

from __future__ import annotations

import json
import os
import sys
import threading

import torch

EXIT_DEVICE_INIT_TIMEOUT = 17


def _touch() -> int:
    """The first CUDA calls: the driver's init and the device count."""
    torch.cuda.init()
    return torch.cuda.device_count()


def require_devices(timeout_s: float | None = None, *, metric: str = "device_init") -> int:
    """Block until the GPU is initialised and return the device count, or hard-exit
    with a JSON error line after ``timeout_s`` seconds (default: the environment's
    ``RECNEXT_DEVICE_INIT_TIMEOUT``, else 600; 0 disables the deadline). Raises
    (RuntimeError) where no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the port runs on the GPU by "
                           "default; pass device='cpu' to run the plain PyTorch path on "
                           "the CPU")
    if timeout_s is None:
        timeout_s = float(os.environ.get("RECNEXT_DEVICE_INIT_TIMEOUT", "600"))
    if timeout_s <= 0:
        return _touch()
    done = threading.Event()

    def watch():
        if not done.wait(timeout_s):
            rec = {"metric": metric, "value": None, "unit": "error", "vs_baseline": None,
                   "error": f"CUDA device init did not complete within {timeout_s:.0f}s"}
            print(json.dumps(rec), flush=True)
            sys.stderr.write(rec["error"] + "\n")
            os._exit(EXIT_DEVICE_INIT_TIMEOUT)

    threading.Thread(target=watch, daemon=True).start()
    n = _touch()
    done.set()
    return n
