"""forecast.idle_share: the share of a forecast's time in which no device
operation ran, in %: the device's busy time a forecast in the light traced
window (the device's activity alone, portbench/harness/trace.py) over
the host-clock time a forecast of the untraced frames just before it (the
profiler's own cost on the host would otherwise read as idle)."""


def read(trace, counts, spec):
    busy_s = trace.light.busy_us() / 1e6 / counts["frames"]
    return 100.0 * (1.0 - busy_s / counts["host_s"])
