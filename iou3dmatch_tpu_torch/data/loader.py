"""Host-side data loading: shuffled batching, SSL batch mixing, prefetch.

The port's copy of ``iou3dmatch_tpu/data/loader.py`` (the reference's torch
DataLoader usage, train.py:103-162, pretrain.py:124-162). Its batches are
the JAX loader's bit for bit: the same epoch shuffle from
``RandomState(seed)`` and, with process workers, every sample drawn under
the seed ``SeedSequence((seed, epoch, index))``, whichever worker loads it.

Process workers are forked, as the JAX loader's and the reference's torch
DataLoader's are, and at construction: the drivers build their loaders
before their model, while the process has few threads. A loader built
later, as in ``chip_smoke.py``, forks a process that holds a CUDA context
and torch's threads; the workers then touch neither: they run the
datasets, which import NumPy and the native loader library only. On the
H100's host (8 cores) a ``forkserver`` pool, whose children hold none of
the parent's state, gave 26-47 ScanNet scenes/s at 1 to 8 workers, where
forked workers gave 58-228 (PERF.md, Findings). Since every sample is
reseeded, the start method does not change a batch.

Unlike the JAX loader, a process pool that cannot start, or that breaks,
raises: it never turns into threads.
"""
import multiprocessing
import os
import queue as queue_mod
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

_WORKER_DS = None


def collate(samples):
    """Stack a list of sample dicts into a batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def sample_seed(seed: int, epoch: int, index: int) -> int:
    """The ``np.random`` seed of sample ``index`` in ``epoch`` of a process
    loader seeded ``seed`` (JAX ``loader.py:129-135``)."""
    return int(np.random.SeedSequence((seed, epoch, index)).generate_state(1)[0])


def _init_worker(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _worker_ready():
    return _WORKER_DS is not None


def _worker_get(task):
    idx, seed = task
    np.random.seed(seed)
    return _WORKER_DS[idx]


class DataLoader:
    """Epoch-shuffled batch iterator over a process pool (the default on a
    host with more than one core) or a thread pool for ``__getitem__``.
    ``num_workers=0`` loads in one thread, as the JAX loader does."""

    def __init__(self, dataset, batch_size, shuffle=True, drop_last=True,
                 num_workers=4, seed=0, worker_type=None):
        self._pool = None
        if worker_type is None:
            worker_type = "process" if (os.cpu_count() or 1) > 1 else "thread"
        if worker_type not in ("process", "thread"):
            raise ValueError(f"worker_type is 'process' or 'thread', not {worker_type!r}")
        if num_workers == 0:
            worker_type = "thread"
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.worker_type = worker_type
        self._epoch = 0
        if worker_type == "thread":
            self._pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
            return
        self._pool = ProcessPoolExecutor(
            max_workers=num_workers, mp_context=multiprocessing.get_context("fork"),
            initializer=_init_worker, initargs=(dataset,))
        try:
            # fork the workers now, so that a worker that cannot start fails
            # here and not at the first batch
            if not self._pool.submit(_worker_ready).result():
                raise RuntimeError("a loader worker started without its dataset")
        except BaseException:
            self.close()
            raise

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):
        self.close()

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        epoch = self._epoch
        self._epoch += 1
        for b in range(len(self)):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.worker_type == "process":
                tasks = [(int(i), sample_seed(self.seed, epoch, int(i))) for i in idxs]
                samples = list(self._pool.map(_worker_get, tasks))
            else:
                samples = list(self._pool.map(self.dataset.__getitem__, idxs))
            yield collate(samples)


class SSLBatcher:
    """Zips a labeled loader with a cycling unlabeled loader and merges the
    two batch dicts as the reference does (train.py:312-328): keys present
    in both are concatenated [labeled | unlabeled]; label-only keys keep
    their labeled-row count."""

    def __init__(self, labeled_loader, unlabeled_loader):
        self.labeled_loader = labeled_loader
        self.unlabeled_loader = unlabeled_loader
        self._unlabeled_iter = None

    def __len__(self):
        return len(self.labeled_loader)

    def _next_unlabeled(self):
        if self._unlabeled_iter is None:
            self._unlabeled_iter = iter(self.unlabeled_loader)
        try:
            return next(self._unlabeled_iter)
        except StopIteration:
            self._unlabeled_iter = iter(self.unlabeled_loader)
            try:
                return next(self._unlabeled_iter)
            except StopIteration:
                # e.g. batch_size > len(dataset) with drop_last: the loader
                # yields no batch an epoch and cycling never makes progress
                raise RuntimeError(
                    "SSLBatcher: the unlabeled loader yields no batches "
                    f"({len(self.unlabeled_loader.dataset)} scenes, batch "
                    f"size {self.unlabeled_loader.batch_size}, drop_last="
                    f"{self.unlabeled_loader.drop_last})") from None

    def __iter__(self):
        for labeled in self.labeled_loader:
            unlabeled = self._next_unlabeled()
            batch = dict(labeled)
            for k in unlabeled:
                if k in labeled:
                    batch[k] = np.concatenate([labeled[k], unlabeled[k]], axis=0)
                else:
                    batch[k] = unlabeled[k]
            yield batch


def prefetch(iterator, size=2):
    """Runs ``iterator`` in a background thread, ``size`` items ahead.

    A producer's exception is forwarded and raised in the consumer: a dying
    producer thread must not leave the consumer blocked on the queue."""
    q = queue_mod.Queue(maxsize=size)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:  # noqa: BLE001 - forwarded, not dropped
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
