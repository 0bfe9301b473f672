"""train.idle_share: the share of a step's time in which no device
operation ran, in %: the device's busy time a step in the light traced
window (the device's activity alone, portbench/harness/trace.py) over
the host-clock time a step of the untraced steps just before it (the
profiler's own cost on the host would otherwise read as idle)."""


def read(trace, counts, spec):
    busy_s = trace.light.busy_us() / 1e6 / counts["steps"]
    return 100.0 * (1.0 - busy_s / counts["host_s"])
