"""train.mfu: the operations of one bg training step (FCHarDNet-70 forward,
and input and weight gradients backward, counted from the shapes by
portbench/harness/flops.py) over the host-clock time a step of the
untraced steps of a traced run and the H100's float32 peak, in %."""

from portbench.harness.peaks import F32_FLOP_PER_S


def read(trace, counts, spec):
    return 100.0 * counts["flops"] / (counts["host_s"] * F32_FLOP_PER_S)
