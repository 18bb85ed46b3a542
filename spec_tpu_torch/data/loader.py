"""Host data pipeline: threaded fetch, batch collate, device prefetch
(port of ``spec_tpu/data/loader.py``).

Decode and crop are cv2 calls that release the GIL, so a thread pool
fetches in parallel without worker processes. Batches have a static
size: the last partial one is padded by repeating its last sample, and
``batch['_valid_count']`` says how many rows are real. The batches,
their order and their padding are the reference's. Under several
processes each loads its contiguous slice of every global batch
(:func:`shard_index_chunk`).
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Iterator

import numpy as np

_NON_TENSOR_KEYS = ('imgname', 'dataset_name', 'maskname', 'partname')


def collate(items) -> dict:
    """Stack a list of item dicts into a batch dict (numpy), keeping
    string fields as lists."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if k in _NON_TENSOR_KEYS or isinstance(vals[0], str):
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


def check_process_divisibility(batch_size: int, process_count: int) -> int:
    """-> the rows of each process's slice; raises unless ``batch_size``
    divides over the processes."""
    process_count = max(int(process_count), 1)
    if batch_size % process_count:
        raise ValueError(
            f'batch_size {batch_size} must divide evenly over '
            f'{process_count} processes')
    return batch_size // process_count


def shard_index_chunk(chunk, batch_size: int, process_id: int = 0,
                      process_count: int = 1):
    """The multi-process chunk contract (``DataLoader`` and CamCalib's
    bucketed batches): a global chunk of indices padded to
    ``batch_size`` by repeating its last index, then this process's
    contiguous slice of it and how many of the slice's entries are real
    samples."""
    per = check_process_divisibility(batch_size, process_count)
    lo = int(process_id) * per
    valid = len(chunk)
    chunk = np.asarray(chunk)
    if valid < batch_size:
        chunk = np.concatenate(
            [chunk, np.full(batch_size - valid, chunk[-1], chunk.dtype)])
    return chunk[lo:lo + per], int(np.clip(valid - lo, 0, per))


class DataLoader:
    """Iterable over collated batches with threaded fetch and prefetch.

    Args:
      dataset: map-style dataset (``__len__`` + ``__getitem__``).
      batch_size: static batch size; the final partial batch is padded
        by repeating the last sample (``batch['_valid_count']`` holds the
        real count) unless ``drop_last``.
      shuffle: reshuffle each epoch with ``RandomState(seed + epoch)``.
      num_workers: fetch threads. prefetch: batches queued ahead.
      skip_batches: skip the first k index chunks of the FIRST iteration
        without fetching them (a mid-epoch resume); later epochs are
        whole.
      group_keys: optional per-sample keys (e.g. ``ds.imgname``): the
        epoch permutes groups of samples that share a key instead of
        samples, so the samples of one frame share a batch and one
        decode (``decode_cache``); sequential epochs also iterate group
        by group.
      process_id / process_count: multi-process data parallelism. The
        global epoch order (shuffle, chunking, skip) depends on the seed
        only, so it is the same in every process, and each process
        fetches only its contiguous slice of every global chunk
        (``batch_size / process_count`` rows; ``_valid_count`` is the
        slice's real rows).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, prefetch: int = 2,
                 drop_last: bool = False, seed: int = 0,
                 skip_batches: int = 0,
                 process_id: int = 0, process_count: int = 1,
                 group_keys=None):
        check_process_divisibility(batch_size, process_count)
        self.process_id = int(process_id)
        self.process_count = max(int(process_count), 1)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.skip_batches = int(skip_batches)
        self._epoch = 0
        self._seed = seed
        self._groups = None
        if group_keys is not None:
            keys = np.asarray(group_keys)
            if len(keys) != len(dataset):
                raise ValueError(
                    f'group_keys length {len(keys)} != dataset '
                    f'{len(dataset)}')
            _, inv = np.unique(keys, return_inverse=True)
            order = np.argsort(inv, kind='stable')
            counts = np.bincount(inv)
            self._groups = np.split(order, np.cumsum(counts)[:-1])

    def __len__(self):
        n = len(self.dataset)
        total = (n // self.batch_size if self.drop_last
                 else (n + self.batch_size - 1) // self.batch_size)
        skip = self.skip_batches if self._epoch == 0 else 0
        return max(total - skip, 0)

    def _index_batches(self):
        """Yield (index chunk padded to batch_size, real count)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            if self._groups is not None:
                perm = rng.permutation(len(self._groups))
                idx = np.concatenate([self._groups[g] for g in perm])
            else:
                rng.shuffle(idx)
        elif self._groups is not None:
            idx = np.concatenate(self._groups)
        skip = self.skip_batches if self._epoch == 1 else 0
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            if skip > 0:
                skip -= 1
                continue
            yield shard_index_chunk(chunk, self.batch_size,
                                    self.process_id, self.process_count)

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list = []

        def _put(item) -> bool:
            # re-check ``stop`` while the queue is full: a consumer that
            # stops early must not leave the producer blocked for good
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk, valid in self._index_batches():
                        if stop.is_set():
                            return
                        # fetch the real entries only (one when the slice
                        # has none); padding rows repeat the last item
                        real = chunk[:valid] if valid else chunk[:1]
                        items = list(pool.map(self.dataset.__getitem__,
                                              real))
                        while len(items) < len(chunk):
                            items.append(items[-1])
                        batch = collate(items)
                        batch['_valid_count'] = valid
                        if not _put(batch):
                            return
            except BaseException as e:  # re-raised in the consumer
                error.append(e)
            finally:
                # the sentinel always goes in, or the consumer would
                # wait for ever after a failed fetch
                if not _put(None) and stop.is_set():
                    try:
                        q.put_nowait(None)
                    except queue.Full:
                        pass

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if error:
                        raise error[0]
                    return
                yield batch
        finally:
            stop.set()


def device_prefetch(iterator, device, tensor_keys=None):
    """Move batches to ``device`` one step ahead of their use: each numpy
    array (of ``tensor_keys``, default all) becomes a tensor there. Other
    values pass through.

    On a CUDA device the arrays go through pinned host memory and
    ``non_blocking`` copies on a side stream, queued before batch i is
    handed out; the current stream waits for a batch's copies only when
    the batch is handed out, so the device may run the copy of batch
    i + 1 while it works on batch i (not measured yet)."""
    import torch

    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == 'cuda' else None

    def put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and (
                    tensor_keys is None or k in tensor_keys):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if side is None:
                    out[k] = t.to(device)
                    continue
                t = t.pin_memory()
                with torch.cuda.stream(side):
                    out[k] = t.to(device, non_blocking=True)
            else:
                out[k] = v
        return out

    def hand_out(batch):
        if side is not None:
            current = torch.cuda.current_stream(device)
            current.wait_stream(side)
            for v in batch.values():
                if isinstance(v, torch.Tensor) and v.device == device:
                    # allocated on the side stream, used on this one
                    v.record_stream(current)
        return batch

    it = iter(iterator)
    try:
        ahead = put(next(it))
    except StopIteration:
        return
    for batch in it:
        nxt = put(batch)
        yield hand_out(ahead)
        ahead = nxt
    yield hand_out(ahead)
