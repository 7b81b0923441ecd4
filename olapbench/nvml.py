"""The card's own kernel-busy utilisation, read from NVML while a window
runs at full load, with nothing of the profiler switched on.

NVML (`libnvidia-ml.so.1`, which comes with the driver) reports, for the
driver's last sample period, what share of it one kernel or more ran on
the card (`nvmlDeviceGetUtilizationRates`, what `nvidia-smi` shows as
GPU-Util).  `Sampler` reads it ten times a second from a thread of its own
(each read is one ctypes call, made with the interpreter's lock released)
and averages the readings taken inside the window.  It needs no package
beyond the driver; where the library or the call is missing it reads
nothing, and the metric that uses it is left out."""

from __future__ import annotations

import ctypes
import threading
import time
from typing import List, Optional, Tuple

POLL_S = 0.1
SETTLE_S = 1.0  # a reading this early may cover time before the window


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


def _handle(lib, pci_bus_id: Optional[str], index: int):
    handle = ctypes.c_void_p()
    if pci_bus_id is not None:
        rc = lib.nvmlDeviceGetHandleByPciBusId_v2(pci_bus_id.encode(), ctypes.byref(handle))
        if rc == 0:
            return handle
    rc = lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(index), ctypes.byref(handle))
    return handle if rc == 0 else None


def pci_bus_id(device) -> Optional[str]:
    """The PCI address NVML knows the torch device by, where torch says it."""
    import torch

    p = torch.cuda.get_device_properties(device)
    if not hasattr(p, "pci_bus_id"):
        return None
    return f"{getattr(p, 'pci_domain_id', 0):08x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"


class Sampler:
    """Utilisation readings of one card over [start(), stop()]."""

    def __init__(self, pci_bus_id: Optional[str] = None, index: int = 0):
        self.readings: List[Tuple[float, float]] = []  # (perf_counter, percent)
        self.error = ""
        self.t0 = self.t1 = 0.0
        self._stop = threading.Event()
        self._thread = None
        try:
            self.lib = ctypes.CDLL("libnvidia-ml.so.1")
            rc = self.lib.nvmlInit_v2()
            if rc != 0:
                raise OSError(f"nvmlInit_v2 returned {rc}")
            self.handle = _handle(self.lib, pci_bus_id, index)
            if self.handle is None:
                raise OSError("no NVML handle for the card")
        except (OSError, AttributeError) as e:
            self.lib = self.handle = None
            self.error = str(e)

    def _loop(self) -> None:
        u = _Utilization()
        while not self._stop.wait(POLL_S):
            rc = self.lib.nvmlDeviceGetUtilizationRates(self.handle, ctypes.byref(u))
            if rc != 0:
                self.error = f"nvmlDeviceGetUtilizationRates returned {rc}"
                return
            self.readings.append((time.perf_counter(), float(u.gpu)))

    def start(self) -> None:
        self.t0 = time.perf_counter()
        if self.lib is not None:
            self._thread = threading.Thread(target=self._loop, name="nvml-sampler", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        if self.lib is not None:
            self.lib.nvmlShutdown()

    def in_window(self) -> List[float]:
        """The readings taken inside the window, from its first second on."""
        return [v for t, v in self.readings if self.t0 + SETTLE_S < t <= self.t1]

    def busy_pct(self) -> Optional[float]:
        """Mean utilisation over the window; None with fewer than 3 readings."""
        vals = self.in_window()
        return sum(vals) / len(vals) if len(vals) >= 3 else None
