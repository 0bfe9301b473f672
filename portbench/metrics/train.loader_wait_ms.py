"""train.loader_wait_ms: host ms per batch that ``train()`` spent inside
the loader's ``__next__`` in the untraced steps of a traced run (the
harness's clock)."""


def read(trace, counts, spec):
    return counts["loader_wait_ms"]
