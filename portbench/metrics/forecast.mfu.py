"""forecast.mfu: the model's operations per forecast (FCHarDNet-70 on the
dense one-hot + depth stack and the fg model, counted from the shapes by
portbench/harness/flops.py) over the host-clock time a forecast of the
untraced frames of a traced run and the H100's float32 peak, in %."""

from portbench.harness.peaks import F32_FLOP_PER_S


def read(trace, counts, spec):
    return 100.0 * counts["flops"] / (counts["host_s"] * F32_FLOP_PER_S)
