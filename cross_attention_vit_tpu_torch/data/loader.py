"""Device-feeding data loader: threaded host decode and a prefetched
host→device copy.

Port of ``cross_attention_vit_tpu/data/loader.py`` (which replaces the
reference's ``DataLoader(num_workers=5, sampler=...)`` process pool,
main_mist.py:206-207).  Worker threads decode (gunzip and numpy slicing
release the GIL), batches are assembled on the host, cast to the transfer
dtype, put in pinned host memory and copied with ``non_blocking=True`` on a
side CUDA stream one batch ahead; the consumer's stream waits on an event
recorded after the copy, so the copy of the next batch overlaps this step's
compute.  A bounded queue carries the batches; an iteration the consumer
abandons stops the producer instead of blocking it forever.  On a CPU
device the batches are plain tensors.

With ``sharding`` (``parallel.batch_sharding``) the loader feeds one rank of
a data-parallel mesh: the caller gives it this rank's indices (its
``host_shard``), the batches go to this rank's device, and a short batch is
padded by wrap-around to a multiple of the data shards the process feeds —
1 with one device a process, so the padding never fires here; it keeps the
JAX loader's rule.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

_TRANSFER_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                    "float32": torch.float32}


class PrefetchLoader:
    """Iterates (img, label) device batches for one epoch's index order."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, prefetch: int = 2,
                 sharding=None, drop_last: bool = False,
                 transfer_dtype: str | torch.dtype | None = None,
                 device: str | torch.device = "cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.sharding = sharding
        self.drop_last = drop_last
        # a bf16 transfer halves the host→device bytes; the model's first
        # GEMM rounds its input to bf16 anyway when it computes in bf16, and
        # models promote to f32 at entry (ops.layers.promote_input)
        self.transfer_dtype = _resolve_dtype(transfer_dtype)
        self.device = resolve_device(device)

    def _batches(self, indices: Sequence[int]) -> list[np.ndarray]:
        idx = np.asarray(indices)
        n_full = len(idx) // self.batch_size
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(n_full)]
        rem = idx[n_full * self.batch_size:]
        if len(rem) and not self.drop_last:
            batches.append(rem)
        div = self.sharding.batch_divisor() if self.sharding is not None else 1
        if div > 1:
            batches = [np.resize(b, -(-len(b) // div) * div) if len(b) % div else b
                       for b in batches]
        return batches

    def _host_batch(self, pool: ThreadPoolExecutor, b: np.ndarray):
        if getattr(self.dataset, "fast_batch", False) or \
                not hasattr(self.dataset, "__getitem__"):
            imgs, labels = self.dataset.batch(b)
        else:
            items = list(pool.map(self.dataset.__getitem__, b))
            imgs = np.stack([it[0] for it in items])
            labels = np.asarray([it[1] for it in items], dtype=np.int32)
        imgs = torch.from_numpy(np.ascontiguousarray(imgs))
        if self.transfer_dtype is not None and imgs.dtype != self.transfer_dtype:
            imgs = imgs.to(self.transfer_dtype)
        return imgs, torch.from_numpy(np.asarray(labels))

    def _to_device(self, imgs: torch.Tensor, labels: torch.Tensor, stream):
        """(imgs, labels, event): on CUDA, copies from pinned memory on the
        side stream, the event recorded after them."""
        if stream is None:
            return imgs.to(self.device), labels.to(self.device), None
        imgs, labels = imgs.pin_memory(), labels.pin_memory()
        with torch.cuda.stream(stream):
            d_imgs = imgs.to(self.device, non_blocking=True)
            d_labels = labels.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return d_imgs, d_labels, event

    def __call__(self, indices: Sequence[int]) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        batches = self._batches(indices)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def safe_put(item) -> bool:
            """put() that gives up when the consumer abandoned the iteration."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    if not safe_put(self._to_device(*self._host_batch(pool, b), stream)):
                        return
            except BaseException as e:  # surface worker errors to the consumer
                safe_put(e)
            finally:
                safe_put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                imgs, labels, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    # memory allocated on the side stream is now used here
                    imgs.record_stream(current)
                    labels.record_stream(current)
                yield imgs, labels
        finally:
            stop.set()
            pool.shutdown(wait=False)


def transfer_dtype_for(config) -> str | None:
    """Loader transfer dtype implied by the model's compute dtype: bf16
    compute rounds the input at the first matmul regardless, so shipping the
    batch as bf16 halves host→device bytes with identical logits."""
    return "bfloat16" if config.get("compute_dtype", "float32") == "bfloat16" else None


def _resolve_dtype(td) -> torch.dtype | None:
    if td is None or isinstance(td, torch.dtype):
        return td
    if str(td) not in _TRANSFER_DTYPES:
        raise ValueError(f"transfer dtype must be one of {sorted(_TRANSFER_DTYPES)}, got {td!r}")
    return _TRANSFER_DTYPES[str(td)]
