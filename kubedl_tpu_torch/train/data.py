"""Data pipelines: synthetic LM batches, packed documents, SFT rows and
token files, plus the copy to the device.

A numpy copy of ``kubedl_tpu/train/data.py`` (the port imports nothing
from the JAX package): every host-side stream yields the same batches,
bit for bit, as the JAX package's for the same arguments. Batches are
dicts of numpy arrays; :func:`prefetch_to_device` turns them into device
tensors, integer ids as int64 (PyTorch's index type).
"""

from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch

from .._device import resolve_device


def synthetic_lm_batches(batch_size: int, seq_len: int, vocab_size: int,
                         seed: int = 0, skip: int = 0) -> Iterator[dict]:
    """Deterministic stream of {tokens, targets} next-token batches.
    ``skip`` fast-forwards the stream by that many batches (resume): the
    rng advances through identical draws, so batch ``skip`` here is
    bit-identical to batch ``skip`` of an unskipped stream."""
    rng = np.random.default_rng(seed)
    for _ in range(skip):
        rng.integers(0, vocab_size, (batch_size, seq_len + 1),
                     dtype=np.int32)
    while True:
        toks = rng.integers(0, vocab_size, (batch_size, seq_len + 1),
                            dtype=np.int32)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class CountingIterator:
    """Wraps a batch iterator and counts consumed batches: the host-side
    data cursor a checkpoint persists. ``consumed`` starts at the skip
    offset the underlying stream was fast-forwarded by, so it is always
    the absolute position in the logical stream."""

    def __init__(self, it: Iterator[dict], consumed: int = 0):
        self._it = iter(it)
        self.consumed = consumed

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = next(self._it)
        self.consumed += 1
        return batch


def skip_batches(stream: Iterator[dict], n: int) -> Iterator[dict]:
    """Generic fast-forward: draw and discard ``n`` batches (for streams
    with no cheaper skip path, such as packed text)."""
    for _ in range(n):
        next(stream)
    return stream


def skip_epochs(skip: int, per_epoch: int, draw_epoch) -> int:
    """Resume fast path shared by the epoch-shuffled datasets: burn every
    whole skipped epoch by replaying the same rng draw an unskipped
    stream made (``draw_epoch``), returning the remaining within-epoch
    offset in batches."""
    while skip >= per_epoch:
        draw_epoch()
        skip -= per_epoch
    return skip


def pack_documents(docs, seq_len: int, batch_size: int,
                   pad_id: int = 0) -> Iterator[dict]:
    """Greedy first-fit packing of variable-length token documents into
    fixed [batch, seq_len] training batches: the data shape of the flash
    kernels' segment-ids path.

    Yields {tokens, targets, segment_ids, positions, mask}:

    * documents are packed back to back per row; a doc longer than
      ``seq_len + 1`` is split into chunks (each chunk its own segment);
    * ``segment_ids`` are unique per document within a row (pads get -1),
      so attention never crosses documents;
    * ``positions`` restart at 0 per document;
    * ``mask`` zeroes loss terms whose (input, target) pair crosses a
      document boundary or touches padding.

    Leftover documents that don't fill a final batch are dropped (every
    yielded batch is full). The JAX package routes finite lists through
    a C++ packer pinned bit-identical to this loop."""
    seq1 = seq_len + 1     # pack seq_len+1 then shift for (tokens, targets)
    rows, row, seg_row, pos_row, seg_id = [], [], [], [], 0

    def flush_row():
        nonlocal row, seg_row, pos_row, seg_id
        pad = seq1 - len(row)
        rows.append((row + [pad_id] * pad,
                     seg_row + [-1] * pad,
                     pos_row + [0] * pad))
        row, seg_row, pos_row, seg_id = [], [], [], 0

    for doc in docs:
        doc = list(doc)
        for start in range(0, len(doc), seq1):
            chunk = doc[start:start + seq1]
            if len(chunk) < 2:
                continue           # a 1-token chunk has no (input, target)
            if len(row) + len(chunk) > seq1:
                flush_row()
            row.extend(chunk)
            seg_row.extend([seg_id] * len(chunk))
            pos_row.extend(range(len(chunk)))
            seg_id += 1
            if len(row) == seq1:
                flush_row()
            while len(rows) >= batch_size:
                batch, rows = rows[:batch_size], rows[batch_size:]
                yield _packed_batch(batch)
    if row:
        flush_row()
    while len(rows) >= batch_size:
        batch, rows = rows[:batch_size], rows[batch_size:]
        yield _packed_batch(batch)


def _packed_batch(rows) -> dict:
    toks = np.asarray([r[0] for r in rows], np.int32)
    seg = np.asarray([r[1] for r in rows], np.int32)
    pos = np.asarray([r[2] for r in rows], np.int32)
    mask = (seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] >= 0)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "segment_ids": seg[:, :-1], "positions": pos[:, :-1],
            "mask": mask}


def sft_batches(examples, seq_len: int, batch_size: int,
                pad_id: int = 0, seed: int = 0,
                skip: int = 0) -> Iterator[dict]:
    """Infinite supervised fine-tuning stream from ``(ids, prompt_len)``
    examples: each row is one example padded to ``seq_len``, loss masked
    to the RESPONSE tokens only.

    The loss element at column ``j`` scores predicting token ``j+1``:
    kept iff ``j + 1 >= prompt_len`` and ``j + 1 < len(ids)``. Examples
    longer than ``seq_len + 1`` are truncated from the right; an example
    whose prompt alone fills the window is rejected up front."""
    exs = []
    for ids, plen in examples:
        ids = list(ids)[:seq_len + 1]
        if plen >= len(ids):
            raise ValueError(
                f"example with prompt_len {plen} leaves no response "
                f"tokens inside seq_len {seq_len}: raise seq or trim "
                "the prompt")
        exs.append((ids, plen))
    if len(exs) < batch_size:
        raise ValueError(f"{len(exs)} examples < batch {batch_size}")
    rng = np.random.default_rng(seed)
    seq1 = seq_len + 1
    skip = skip_epochs(skip, len(exs) // batch_size,
                       lambda: rng.permutation(len(exs)))
    while True:
        order = rng.permutation(len(exs))
        start0 = skip * batch_size
        skip = 0
        for start in range(start0, len(order) - batch_size + 1, batch_size):
            toks = np.full((batch_size, seq1), pad_id, np.int32)
            mask = np.zeros((batch_size, seq_len), bool)
            for r, idx in enumerate(order[start:start + batch_size]):
                ids, plen = exs[idx]
                toks[r, :len(ids)] = ids
                mask[r, max(plen - 1, 0):len(ids) - 1] = True
            yield {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                   "mask": mask}


def to_device(batch: dict, device) -> dict:
    """One host batch on ``device``: integer arrays as int64, the rest
    as they are. Card copies go through pinned host memory with
    ``non_blocking``, so they overlap the step already queued."""
    out = {}
    for name, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[name] = t
    return out


def prefetch_to_device(batches: Iterator[dict], device=None,
                       size: int = 2) -> Iterator[dict]:
    """Keep ``size`` device batches in flight ahead of the consumer: the
    copy of batch N+1 is issued while the step for batch N runs. Host
    memory holds at most ``size`` extra batches."""
    dev = resolve_device(device)
    size = max(size, 1)  # size<=0 would silently drop the whole stream
    queue = collections.deque()
    try:
        for _ in range(size):
            queue.append(to_device(next(batches), dev))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(to_device(next(batches), dev))
        except StopIteration:
            pass
        yield out


class TokenFileDataset:
    """Pre-tokenized corpus on disk: a flat int32 (or int16/uint16) token
    array, memory-mapped. Each host reads only its own contiguous shard
    of the file (``process_index``/``process_count``)."""

    def __init__(self, path: str, seq_len: int, batch_size: int,
                 dtype=np.int32, process_index: int = 0,
                 process_count: int = 1, seed: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.batch_size = batch_size
        n = len(self.tokens) // (seq_len + 1)
        lo = n * process_index // process_count
        hi = n * (process_index + 1) // process_count
        if hi - lo < batch_size:
            # an undersized shard would make batches() spin forever
            # yielding nothing: fail loudly at construction instead
            raise ValueError(
                f"token file too small: {n} sequences across "
                f"{process_count} hosts leaves host {process_index} with "
                f"{hi - lo} (< batch_size {batch_size})")
        self._indices = np.arange(lo, hi)
        self._rng = np.random.default_rng(seed + process_index)

    def __len__(self) -> int:
        return len(self._indices)

    def batches(self, skip: int = 0) -> Iterator[dict]:
        """Infinite shuffled stream of {tokens, targets} (epoch reshuffle).
        ``skip`` fast-forwards by that many batches without touching the
        memmap: batch N is bit-identical to batch N of an unskipped
        stream."""
        sl = self.seq_len
        skip = skip_epochs(skip, len(self._indices) // self.batch_size,
                           lambda: self._rng.permutation(self._indices))
        while True:
            order = self._rng.permutation(self._indices)
            start0 = skip * self.batch_size
            skip = 0
            for start in range(start0, len(order) - self.batch_size + 1,
                               self.batch_size):
                rows = [self.tokens[i * (sl + 1):(i + 1) * (sl + 1)]
                        for i in order[start:start + self.batch_size]]
                block = np.asarray(rows, dtype=np.int32)  # one host copy
                yield {"tokens": block[:, :-1], "targets": block[:, 1:]}
