"""Batch loader: map-style datasets -> stacked numpy batches.

Counterpart of ``panoptic_forecasting_tpu/data/loader.py`` (reference
torch DataLoader + InfiniteDataloader + collate_fns,
training/train.py:25-64, 101-122). Yields numpy dict batches; the caller
moves them to its device. Shuffled, ``drop_last``, weighted sampling
(train.py:39-44) and ``steps_per_epoch`` epochs that reshuffle when the
order runs out, drawing its numbers as JAX's loader does, so that one
seed gives the same sample sequence in both packages. A thread pool per
batch and a background prefetch thread. A ``shard`` loader in a
distributed run fetches only its rank's rows of each global batch
(``parallel/mesh.py::shard_rows``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ..parallel.mesh import shard_rows


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
    """Iterate a dataset in batches; one ``__iter__`` = one epoch.

    ``num_threads`` > 0 fetches each batch's samples on a thread pool
    (order kept); ``prefetch`` > 0 prepares that many batches ahead on a
    background thread. Each epoch's order comes from
    ``RandomState(rng.randint(2**31) + epoch)`` of the loader's own
    ``RandomState(seed)`` (``rng_state`` carries it across a resume).

    With ``shard`` every rank draws the same global batches and fetches
    only its rows of each (``shard_rows``), so the ranks' batches,
    concatenated, are the one-process batch; a batch split so carries
    ``"sharded": True``, one replicated (its size not divisible by the
    world) does not."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        steps_per_epoch: Optional[int] = None,
        weights: Optional[np.ndarray] = None,
        seed: int = 0,
        prefetch: int = 0,
        num_threads: int = 0,
        shard: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate = collate_fn or default_collate
        self.steps_per_epoch = steps_per_epoch
        self.weights = weights
        self._rng = np.random.RandomState(seed)
        self._epoch = 0
        self.prefetch = int(prefetch)
        self.num_threads = int(num_threads)
        self.shard = shard
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
        ints = [int(i) for i in idx]
        if self._pool is not None and len(ints) > 1:
            return list(self._pool.map(self.dataset.__getitem__, ints))
        return [self.dataset[i] for i in ints]

    def set_epoch(self, epoch: int) -> None:
        """The epoch added to each order's seed (reference
        train.py:172-173, 300-305), forwarded to a dataset that has a
        ``set_epoch`` (the bg augmentation reseeds with it)."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    @property
    def rng_state(self):
        """The state of the loader's RandomState (between epochs)."""
        return self._rng.get_state()

    @rng_state.setter
    def rng_state(self, state) -> None:
        self._rng.set_state(state)

    def __len__(self) -> int:
        if self.steps_per_epoch is not None:
            return self.steps_per_epoch
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.RandomState(self._rng.randint(2**31) + self._epoch)
        if self.weights is not None:
            p = np.asarray(self.weights, np.float64)
            return rng.choice(n, size=n, replace=True, p=p / p.sum())
        if self.shuffle:
            return rng.permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        it = self._epoch_iter()
        if self.prefetch > 0:
            return _background_prefetch(it, self.prefetch)
        return it

    def _epoch_iter(self) -> Iterator[Dict[str, Any]]:
        for idx in self.batch_indices():
            rows = shard_rows(idx) if self.shard else idx
            batch = self.collate(self._fetch(rows))
            if len(rows) < len(idx):
                batch["sharded"] = True
            yield batch

    def batch_indices(self) -> Iterator[np.ndarray]:
        """The sample indices of each batch of one epoch."""
        order = self._order()
        if self.steps_per_epoch is None:
            stop = (len(order) - len(order) % self.batch_size
                    if self.drop_last else len(order))
            for s in range(0, stop, self.batch_size):
                yield order[s: s + self.batch_size]
            return
        # steps_per_epoch: draw fresh orders until the steps are served
        pos = 0
        for _ in range(self.steps_per_epoch):
            if pos + self.batch_size > len(order):
                order, pos = self._order(), 0
            yield order[pos: pos + self.batch_size]
            pos += self.batch_size
