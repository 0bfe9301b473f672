"""Batch loader: map-style datasets -> stacked numpy batches.

Counterpart of the evaluation side of
``panoptic_forecasting_tpu/data/loader.py`` (reference torch DataLoader +
collate_fns, training/train.py:101-122). Yields numpy dict batches in
dataset order; the caller moves them to its device. A thread pool per
batch and a background prefetch thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


def _background_prefetch(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` in a daemon thread, buffering up to ``depth`` items.

    Replaces the reference's forked DataLoader workers
    (training/train.py:101-109): decode/collate of batch k+1..k+depth
    overlaps the device step on batch k. Single producer thread → batch
    order is identical to the synchronous path.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    err: List[BaseException] = []

    def producer():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced to the consumer
            err.append(e)
        finally:
            # The sentinel MUST be delivered on normal completion or the
            # consumer blocks forever on q.get() once it drains the queue
            # (a single 0.1 s best-effort put dropped it whenever the
            # consumer was still busy with an earlier batch — deadlocked
            # the trainer the moment prefetch became the default). Retry
            # until delivered; bail only if the consumer abandoned us.
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack 'inputs'/'labels' leaf-wise; 'meta' values become lists.

    Mirrors the reference's per-dataset collate_fns (odom_dataset.py:152-165).
    """

    def stack_tree(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack_tree([it[k] for it in items]) for k in first}
        if isinstance(first, np.ndarray) or np.isscalar(first):
            return np.stack([np.asarray(it) for it in items])
        return list(items)

    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key == "meta":
            out[key] = {k: [v[k] for v in vals] for k in vals[0]}
        else:
            out[key] = stack_tree(vals)
    return out


class Loader:
    """Iterate a dataset in order, in batches of ``batch_size`` (the last
    may be short); one ``__iter__`` = one pass.

    ``num_threads`` > 0 fetches each batch's samples on a thread pool
    (order kept); ``prefetch`` > 0 prepares that many batches ahead on a
    background thread. The shuffled, weighted and ``steps_per_epoch``
    training modes of the JAX package's loader are not ported yet.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Optional[Callable] = None,
        prefetch: int = 0,
        num_threads: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate_fn or default_collate
        self.prefetch = int(prefetch)
        self.num_threads = int(num_threads)
        self._pool = None
        if self.num_threads > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.num_threads,
                thread_name_prefix="pf-loader",
            )

    def _fetch(self, idx) -> List[Dict[str, Any]]:
        """Fetch one batch worth of samples (thread-parallel if configured;
        order always matches ``idx``)."""
        if self._pool is not None and len(idx) > 1:
            return list(self._pool.map(self.dataset.__getitem__, idx))
        return [self.dataset[i] for i in idx]

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        it = self._epoch_iter()
        if self.prefetch > 0:
            return _background_prefetch(it, self.prefetch)
        return it

    def _epoch_iter(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        for s in range(0, n, self.batch_size):
            yield self.collate(self._fetch(range(s, min(s + self.batch_size, n))))
