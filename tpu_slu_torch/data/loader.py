"""Threaded prefetching batch loader with length-bucketed, fixed-size batches.

The port's own copy of ``tpu_slu/data/loader.py``. Waveforms are padded to a
bucket boundary (a multiple of ``quant`` samples), and a trailing partial
batch is padded to ``batch_size`` with zero rows whose weight ``w`` is 0, so
a step sees few distinct shapes. Batches are collated on a thread pool and
prefetched.

The shard of a process (one of several training the same model) is its
data index and the data size of the ``torch.distributed`` grid once one is
up (``tpu_slu_torch.parallel``: the rank and the world at
``model_parallel`` 1, so the mp ranks of a data index read the same
batches), else 0/1, as JAX's loader takes its process index and count from
the runtime; explicit ``process_index``/``process_count`` win.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading

import numpy as np

from tpu_slu_torch.parallel.mesh import current

WAVE_BUCKET_QUANT = 8000  # 0.5 s at 16 kHz: the wave bucket of batches, bucket=True decodes and the server


def pad_to_bucket(t: int, quant: int) -> int:
    """Smallest multiple of ``quant`` >= t (at least ``quant``)."""
    return max(quant, ((t + quant - 1) // quant) * quant)


def pad_wave_batch(waves, batch_size: int, quant: int):
    """Zero-pad variable-length waveforms into a (batch_size, T_bucket) array.

    Returns (x, weights, lengths): weights are 1.0 for real rows, 0.0 for
    batch padding; lengths are true sample counts (0 for padding rows).
    """
    t_pad = pad_to_bucket(max(len(w) for w in waves), quant)
    x = np.zeros((batch_size, t_pad), np.float32)
    w = np.zeros((batch_size,), np.float32)
    lengths = np.zeros((batch_size,), np.int32)
    for i, wav in enumerate(waves):
        x[i, : len(wav)] = wav
        w[i] = 1.0
        lengths[i] = len(wav)
    return x, w, lengths


class BatchLoader:
    """Iterable over collated batches of a map-style dataset.

    ``dataset`` has ``__len__`` and ``__getitem__``; ``collate`` turns a list
    of items into a batch dict. Each pass (epoch ``e``, counted from 0 by
    this loader) shuffles with ``np.random.default_rng(seed + e)`` when
    ``shuffle``; with ``process_count`` > 1 every process takes the same
    permutation, wrapped so that each gets ``ceil(n / process_count)``
    examples, and the strided shard ``process_index::process_count``; a
    wrapped duplicate gets weight 0. Both default to the process grid's
    data index and data size, read at each pass (the rank and the world at
    ``model_parallel`` 1; 0 and 1 without a group); give both or neither.
    Batches are made on ``num_threads`` threads, ``prefetch`` in flight: a
    dataset whose items draw from one generator (the augment, the ASR crop)
    draws in the order the threads reach them, as JAX's does;
    ``num_threads = 1`` makes the draws reproducible.
    """

    def __init__(self, dataset, batch_size: int, collate, shuffle: bool = True, seed: int = 0,
                 num_threads: int = 8, prefetch: int = 2, process_index: int | None = None,
                 process_count: int | None = None):
        if (process_index is None) != (process_count is None):
            raise ValueError("give both process_index and process_count, or neither")
        if process_count is not None and not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside 0..{process_count - 1}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self._shard_of = None if process_count is None else (process_index, process_count)
        self._epoch = 0
        self._lock = threading.Lock()

    @property
    def process_index(self) -> int:
        return current().data_index if self._shard_of is None else self._shard_of[0]

    @property
    def process_count(self) -> int:
        return current().data_size if self._shard_of is None else self._shard_of[1]

    def __len__(self):
        n = -(-len(self.dataset) // self.process_count)
        return -(-n // self.batch_size)

    def _shard(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """(example indices, wrapped-duplicate flags) of this process's epoch."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        dup = np.zeros(len(order), bool)
        pindex, pcount = self.process_index, self.process_count
        if pcount > 1:
            extra = -(-len(order) // pcount) * pcount - len(order)
            order = np.concatenate([order, order[:extra]])
            dup = np.concatenate([dup, np.ones(extra, bool)])
            order, dup = order[pindex::pcount], dup[pindex::pcount]
        return order, dup

    def _make_batch(self, idx_list, dup_flags):
        batch = self.collate([self.dataset[i] for i in idx_list])
        if dup_flags.any() and isinstance(batch, dict) and "w" in batch:
            w = np.array(batch["w"], np.float32, copy=True)
            w[: len(dup_flags)] *= 1.0 - dup_flags.astype(np.float32)
            batch = {**batch, "w": w}
        return batch

    def __iter__(self):
        with self._lock:
            epoch = self._epoch
            self._epoch += 1
        order, dup = self._shard(epoch)
        specs = [(order[i: i + self.batch_size].tolist(), dup[i: i + self.batch_size])
                 for i in range(0, len(order), self.batch_size)]
        with cf.ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            it = iter(specs)
            pending = [pool.submit(self._make_batch, *s) for s in (next(it, None) for _ in range(self.prefetch))
                       if s is not None]
            while pending:
                fut = pending.pop(0)
                s = next(it, None)
                if s is not None:
                    pending.append(pool.submit(self._make_batch, *s))
                yield fut.result()
