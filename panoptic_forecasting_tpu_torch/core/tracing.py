"""Program spans on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function("pf." + name)`` while
some ``torch.profiler`` records, and a shared null context otherwise: a
span costs one check when nothing traces. Its start and end are the
profiler's own timestamps, on the clock of the device records, so every
device operation can be tied to the span it was launched in.

A span entered while no profiler ran records nothing; one left after its
profiler stopped records nothing and raises nothing. A profiler that
records host events must not be stopped and another started while a
span is open: torch would end the span in the first one's freed records.
"""

from contextlib import nullcontext

import torch

_OFF = nullcontext()


def span(name: str):
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("pf." + name)
    return _OFF


def spanned(iterable, name: str):
    """``iterable``'s items, each ``next()`` inside ``span(name)``, the
    span closed before the item is yielded."""
    it = iter(iterable)
    while True:
        with span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item
