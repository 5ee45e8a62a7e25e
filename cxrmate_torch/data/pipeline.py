"""Host-side batching and prefetch.

The port's copy of ``cxrmate_tpu/data/pipeline.py``: the reference's collate
(stack for single, zero-pad variable image counts for multi —
`modules/lightning_modules/multi.py:155-164`: padding images are all-zero,
which is exactly what the encoder's mask convention detects), batches in
every ordering mode of the JAX loader, and a background-thread prefetch that
overlaps JPEG decode with the card's work."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def collate(examples: List[Dict], max_images: Optional[int] = None) -> Dict:
    """Batch example dicts; image stacks are zero-padded to the max (or given)
    image count so a batch's shape stays fixed."""
    batch = {k: [e[k] for e in examples] for k in examples[0]}
    images = batch["images"]
    n_max = max_images or max(im.shape[0] for im in images)
    shape = (len(images), n_max) + images[0].shape[1:]
    out = np.zeros(shape, dtype=images[0].dtype)
    for i, im in enumerate(images):
        out[i, : im.shape[0]] = im
    batch["images"] = out
    return batch


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    max_images: Optional[int] = None,
    drop_last: bool = False,
    rank: int = 0,
    world_size: int = 1,
    num_workers: int = 0,
    skip_batches: int = 0,
    sort_key: Optional[Sequence] = None,
    row_shard: Optional[Tuple[int, int]] = None,
    order: Optional[Sequence[int]] = None,
) -> Iterator[Dict]:
    """Sequential (or shuffled) batches; with world_size > 1, rank r takes strided
    samples like a DistributedSampler(shuffle=False). ``num_workers`` > 0 decodes a
    batch's JPEGs on a thread pool (the codec's ctypes calls release the GIL). ``skip_batches`` fast-
    forwards past the first N per-rank batches without touching the dataset
    (mid-epoch resume: same seed → same order → the untrained remainder).
    ``sort_key`` (eval only; ignored under ``shuffle``) iterates in stable-sorted
    key order — used with per-study image counts so batches are image-slot
    homogeneous under the per-batch collate pad (cli/stages.py:evaluate).

    ``row_shard`` ((start, stop) rows within each batch): mesh-aligned loading
    for multi-process data parallelism — every process iterates the SAME global
    batch order (same seed/skip; ``batch_size`` is the GLOBAL batch), but
    materialises only its row stripe (``parallel.mesh.local_row_range``);
    the gradients and statistics of the global batch come from the ranks'
    all-reduces (``train.tf_trainer``). Mutually exclusive with rank/world
    striding; ragged
    final batches are always dropped (a partial batch has no well-defined
    stripe).

    ``order`` (explicit index sequence): the caller dictates exactly which
    items in which order — lane-strided multi-process eval of generated-prompt
    datasets builds a per-rank order over its own lanes, and the other
    datasets' multi-process eval the one-process order, whose batches each
    rank cuts to its ``row_shard`` (cli/stages.py: evaluate). Excludes every
    other ordering mechanism."""
    assert row_shard is None or world_size == 1, "row_shard excludes rank striding"
    if order is not None:
        # explicit index order (lane-strided multi-process eval of
        # generated-prompt datasets, cli/stages.py:evaluate) — the caller owns
        # the ordering, so every other ordering mechanism must be off
        assert not shuffle and sort_key is None and world_size == 1 and not skip_batches
        order = np.asarray(order, dtype=np.int64)
    else:
        order = np.arange(len(dataset))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        elif sort_key is not None:
            assert len(sort_key) == len(dataset), (len(sort_key), len(dataset))
            order = order[np.argsort(np.asarray(sort_key), kind="stable")]
        order = order[rank::world_size]
    if skip_batches:
        order = order[skip_batches * batch_size :]
    pool = None
    if num_workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=num_workers)
    try:
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size and (drop_last or row_shard is not None):
                return
            if row_shard is not None:
                idx = idx[row_shard[0] : row_shard[1]]
            if pool is not None:
                items = list(pool.map(lambda i: dataset[int(i)], idx))
            else:
                items = [dataset[int(i)] for i in idx]
            yield collate(items, max_images)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


class Prefetcher:
    """Background-thread prefetch of an iterator (the reference uses DataLoader
    workers with prefetch_factor=5, single.py:376-387). Worker exceptions are
    re-raised in the consumer — a dying loader must fail the epoch, not silently
    truncate it.

    Do NOT prefetch datasets whose ``__getitem__`` depends on state written back
    during consumption (generated-prompt history): the reference runs those with
    ``num_workers=0`` single-process loaders for the same reason
    (gen_prompt.py:66-82)."""

    def __init__(self, iterator: Iterator, depth: int = 5):
        self.queue: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._iterator = iterator
        self.thread = threading.Thread(target=self._run, args=(iterator,), daemon=True)
        self.thread.start()

    def _run(self, iterator):
        try:
            for item in iterator:
                # bounded put so an abandoned consumer (early break) cannot leave
                # this thread (and the inner loader pool) blocked forever
                while not self._stop.is_set():
                    try:
                        self.queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # propagate to the consumer
            self._error = e
        finally:
            # bounded put, same as real items — NEVER displace a queued batch
            # to make room for the sentinel (that silently dropped one batch
            # per epoch whenever the consumer was slower than the loader). If
            # the consumer abandoned us (_stop set), nobody reads the sentinel
            # and close() drains the queue.
            while not self._stop.is_set():
                try:
                    self.queue.put(self._done, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self):
        """Stop the producer and release its resources (inner generator + its
        loader thread pool). Safe to call multiple times / after exhaustion;
        called automatically when the consumer abandons iteration."""
        self._stop.set()
        while True:  # unblock a producer stuck in put
            try:
                self.queue.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout=10)
        close_inner = getattr(self._iterator, "close", None)
        if close_inner is not None and not self.thread.is_alive():
            try:
                close_inner()  # runs the generator's finally (pool shutdown)
            except (ValueError, RuntimeError):
                pass

    def __iter__(self):
        try:
            while True:
                item = self.queue.get()
                if item is self._done:
                    if self._error is not None:
                        raise self._error
                    return
                yield item
        finally:
            self.close()
