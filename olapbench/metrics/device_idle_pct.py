"""device_idle_pct: share of the window in which no kernel ran on the
card, by NVML's utilisation samples (olapbench/nvml.py), read at full load
with no profiler on.  Nothing where NVML gave fewer than 3 samples."""


def read(run):
    if run.busy_pct is None:
        return None
    return 100.0 - run.busy_pct
