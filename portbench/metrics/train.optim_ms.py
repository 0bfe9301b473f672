"""train.optim_ms: device ms per optimizer step of the kernels and memsets
launched in the program's ``pf.train.optim`` span (the gradients'
all-reduce, clip, update and zero_grad, train/optim.py), in the full
traced window (portbench/harness/spans.py)."""

from portbench.harness.spans import device_ms, is_kernel


def read(trace, counts, spec):
    return device_ms(trace.full, "pf.train.optim", is_kernel)
