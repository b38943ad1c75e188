"""Offline in-memory dataset loading + fixed-shape batch iteration.

The reference's offline Reader splits the file into byte ranges aligned to
line boundaries and parses them on N async tasks
(reference: src/data/reader.cpp:22-91).  Here the file is split the same way
and parsed by a thread pool of vectorized-numpy (or C++) chunk parsers, then
concatenated into flat arrays ready for device feeding.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator, NamedTuple, Optional

import numpy as np

from ftrl_ffm_tpu_torch.data.parser import (
    ParsedChunk,
    parse_text,
    sniff_max_nnz,
    warn_truncation,
)


class ArrayDataset(NamedTuple):
    fields: np.ndarray  # [N, F] int32
    feats: np.ndarray   # [N, F] int32
    vals: np.ndarray    # [N, F] float32
    y: np.ndarray       # [N] float32

    @property
    def n(self) -> int:
        return self.y.shape[0]


def _align_cut(f, pos: int) -> int:
    """Smallest line-start >= pos.

    A bare seek+readline would consume a WHOLE line when pos already sits
    on a line start, shifting that line to the previous shard — for
    equal-width inputs that makes the multi-host split uneven (e.g. 129/127
    of 256), so processes disagree on batch boundaries and the run stops
    being step-for-step identical to the single-process one.  Checking the
    byte before pos keeps exact-boundary cuts exact."""
    if pos <= 0:
        return 0
    f.seek(pos - 1)
    if f.read(1) == b"\n":
        return pos
    f.readline()
    return f.tell()


def _partition_offsets(
    path: str, n_parts: int, byte_range: Optional[tuple[int, int]] = None
) -> list[tuple[int, int]]:
    """Byte ranges aligned to line boundaries
    (reference: src/data/reader.cpp:22-48, get_data_partition)."""
    lo, hi = byte_range if byte_range else (0, os.path.getsize(path))
    n_parts = max(1, n_parts)
    approx = [lo + (hi - lo) * i // n_parts for i in range(n_parts + 1)]
    cuts = [lo]
    with open(path, "rb") as f:
        for i in range(1, n_parts):
            cuts.append(min(_align_cut(f, approx[i]), hi))
    cuts.append(hi)
    cuts = sorted(set(cuts))
    return [(a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]


def process_byte_range(path: str, shard_index: int, shard_count: int) -> tuple[int, int]:
    """This process's byte slice of the input file, aligned to line
    boundaries — the multi-host generalization of the reference's byte-range
    partition (src/data/reader.cpp:22-48): shard i owns the lines beginning
    in [size*i/P, size*(i+1)/P) after '\\n' alignment.  Processes whose range
    collapses to empty get (x, x) and stream zero lines."""
    if shard_count <= 1:
        return (0, os.path.getsize(path))
    size = os.path.getsize(path)
    approx = [size * i // shard_count for i in range(shard_count + 1)]
    cuts = [0]
    with open(path, "rb") as f:
        for i in range(1, shard_count):
            cuts.append(min(_align_cut(f, approx[i]), size))
    cuts.append(size)
    # monotone, possibly-colliding cuts: collapsed shards read nothing
    for i in range(1, len(cuts)):
        cuts[i] = max(cuts[i], cuts[i - 1])
    return (cuts[shard_index], cuts[shard_index + 1])


def count_lines(
    path: str,
    byte_range: Optional[tuple[int, int]] = None,
    nonblank: bool = False,
) -> int:
    """Line count in the (line-aligned) byte range — used to agree on a
    global per-epoch step count across hosts before streaming.

    nonblank=True counts only lines with a non-whitespace character — the
    exact number of EXAMPLES the parsers will yield (they skip blank
    lines); required wherever the count maps to output rows, e.g. the
    ordered multi-host predict_file."""
    lo, hi = byte_range if byte_range else (0, os.path.getsize(path))
    n = 0
    last = b"\n"
    carry = False  # current line has seen a non-whitespace byte
    with open(path, "rb") as f:
        f.seek(lo)
        remaining = hi - lo
        while remaining > 0:
            block = f.read(min(8 << 20, remaining))
            if not block:
                break
            remaining -= len(block)
            if nonblank:
                arr = np.frombuffer(block, np.uint8)
                nonws = (arr != 32) & (arr != 9) & (arr != 13) & (arr != 10)
                nl = np.flatnonzero(arr == 10)
                if nl.size:
                    cs = np.cumsum(nonws)
                    at = cs[nl]
                    within = np.diff(np.concatenate([[0], at])) > 0
                    within[0] |= carry
                    n += int(within.sum())
                    carry = int(cs[-1] - at[-1]) > 0
                else:
                    carry = carry or bool(nonws.any())
            else:
                n += block.count(b"\n")
            last = block[-1:]
    if nonblank:
        return n + (1 if carry else 0)  # final unterminated non-blank line
    if last != b"\n" and hi - lo > 0:
        n += 1  # final unterminated line
    return n


def load_file(
    path: str,
    file_type: str,
    max_nnz: int = 0,
    n_feats: int = (1 << 31) - 1,
    n_fields: int = (1 << 31) - 1,
    n_workers: int = 1,
    byte_range: Optional[tuple[int, int]] = None,
) -> ArrayDataset:
    """Parse a libsvm/libffm file (or one process's byte_range of it) into
    padded arrays, in parallel."""
    if max_nnz <= 0:
        max_nnz = sniff_max_nnz(path, file_type)
    parts = _partition_offsets(path, n_workers, byte_range)
    if (
        byte_range is not None and byte_range[1] <= byte_range[0]
    ) or not parts:
        # empty byte range or zero-byte file: a legal empty dataset
        return ArrayDataset(
            fields=np.zeros((0, max_nnz), np.int32),
            feats=np.zeros((0, max_nnz), np.int32),
            vals=np.zeros((0, max_nnz), np.float32),
            y=np.zeros((0,), np.float32),
        )

    def parse_range(rng: tuple[int, int]) -> ParsedChunk:
        with open(path, "rb") as f:
            f.seek(rng[0])
            raw = f.read(rng[1] - rng[0])
        # raw bytes go straight to the C++ chunk parser (no decode copy)
        return parse_text(raw, file_type, max_nnz, n_feats, n_fields)

    if len(parts) == 1:
        chunks = [parse_range(parts[0])]
    else:
        with cf.ThreadPoolExecutor(max_workers=n_workers) as pool:
            chunks = list(pool.map(parse_range, parts))

    worst = max(int(c.nnz.max(initial=0)) for c in chunks)
    if worst > max_nnz:
        warn_truncation(path, worst, max_nnz)
    return ArrayDataset(
        fields=np.concatenate([c.fields for c in chunks]),
        feats=np.concatenate([c.feats for c in chunks]),
        vals=np.concatenate([c.vals for c in chunks]),
        y=np.concatenate([c.y for c in chunks]),
    )


def batch_iterator(
    ds: ArrayDataset,
    batch_size: int,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    *,
    sentinel: int,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (fields, feats, vals, y, sample_w) numpy batches of fixed size.

    The batch remainder is padded with inert samples (sample_w = 0, value 0,
    feat id = sentinel).  `sentinel` is required and must be the dataset's
    padding feature id (n_feats — the Batch drop-sentinel convention,
    models/base.py::Batch); a wrong default here would count padding as
    real id-0 occurrences in any id-sensitive path.  Fixed shapes mean
    every step jit-compiles once.  Shuffling reproduces the reference's offline per-epoch index
    shuffle (reference: src/task/ftrl_offline.cpp:69-71).
    """
    n = ds.n
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    f = ds.feats.shape[1]
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        b = idx.shape[0]
        fields = ds.fields[idx]
        feats = ds.feats[idx]
        vals = ds.vals[idx]
        y = ds.y[idx]
        sample_w = np.ones(b, dtype=np.float32)
        if b < batch_size:
            pad = batch_size - b
            fields = np.concatenate([fields, np.zeros((pad, f), np.int32)])
            feats = np.concatenate([feats, np.full((pad, f), sentinel, np.int32)])
            vals = np.concatenate([vals, np.zeros((pad, f), np.float32)])
            y = np.concatenate([y, np.zeros(pad, np.float32)])
            sample_w = np.concatenate([sample_w, np.zeros(pad, np.float32)])
        yield fields, feats, vals, y, sample_w
