"""Online streaming input pipeline.

The reference's online mode is a producer thread pushing <=20000-line string
batches into a mutex/condvar queue drained by consumer threads
(reference: src/concurrent/pc_task.cpp:22-80, buf_size at
src/include/concurrent/pc_task.h:34-35).  The TPU-native equivalent: a host
producer thread reads + parses line chunks into padded numpy batches ahead of
the device, bounded by a queue (back-pressure), so parsing overlaps device
compute.  Each example is seen exactly once per epoch, in file order — same
guarantee as the reference's single-pass streaming.

`--cmd` stdin streaming (reference: src/concurrent/pc_task.cpp:41; the
training branch there is a TODO stub, src/task/ftrl_online.cpp:55-57) is
supported by passing a file object.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import sys
import threading
import time
from typing import IO, Iterator, Optional

import numpy as np

from ftrl_ffm_tpu_torch import tracing
from ftrl_ffm_tpu_torch.data.parser import parse_lines, parse_text

CHUNK_LINES = 20000  # reference: src/include/concurrent/pc_task.h:34
BLOCK_BYTES = 4 << 20  # file-path fast path: newline-aligned binary blocks


class StreamReader:
    """Iterate fixed-shape batches over a text stream, producer-threaded."""

    def __init__(
        self,
        path_or_file: str | IO[str],
        file_type: str,
        batch_size: int,
        max_nnz: int,
        n_feats: int,
        n_fields: int,
        chunk_lines: int = CHUNK_LINES,
        prefetch: int = 4,
        log_every: int = 1_000_000,  # reference: pc_task.h:35 (log_num)
        n_parse_threads: int = 3,
        byte_range: Optional[tuple[int, int]] = None,
    ):
        self.path_or_file = path_or_file
        self.file_type = file_type
        self.batch_size = batch_size
        self.max_nnz = max_nnz
        self.n_feats = n_feats
        self.n_fields = n_fields
        self.chunk_lines = chunk_lines
        self.prefetch = prefetch
        self.log_every = log_every
        # multi-host: stream only this byte slice (line-aligned; see
        # data/loader.py::process_byte_range)
        if byte_range is not None and not isinstance(path_or_file, str):
            raise ValueError("byte_range requires a file path, not a stream")
        self.byte_range = byte_range
        # The C++ chunk parser releases the GIL, so a small thread pool gives
        # real parse parallelism — the reference's N consumer threads
        # (src/concurrent/pc_task.cpp:57-80) reborn as a parse pool feeding
        # one device stream.  When the native library is available, the
        # parallelism moves INSIDE the library (ftrl_parse_chunk_mt: one
        # call, n threads over newline-aligned sub-ranges) and the Python
        # pool shrinks to one submit worker — one future + one set of numpy
        # allocations per 4 MB block instead of per pool task, and no GIL
        # churn between pool workers.
        self.n_parse_threads = max(1, n_parse_threads)
        from ftrl_ffm_tpu_torch import native

        self._native_mt = native.lib() is not None

    def _open(self) -> IO[str]:
        if isinstance(self.path_or_file, str):
            return open(self.path_or_file, "r")
        return self.path_or_file  # e.g. sys.stdin for --cmd mode

    def _byte_blocks(self):
        """Newline-aligned binary blocks of the file (or byte_range slice).

        The fast path for file inputs: no Python per-line loop, no
        str join/encode — raw bytes go straight to the C++ chunk parser.
        byte_range must be line-aligned (data/loader.py::process_byte_range);
        a line *starting* before the range end belongs to this shard and is
        completed past the boundary."""
        lo, hi = self.byte_range or (0, os.path.getsize(self.path_or_file))
        if hi <= lo:
            return
        # Ramp-up: small first blocks fill the parse->upload->device pipeline
        # fast (a full 4 MB first block costs ~100 ms of device idle at every
        # epoch start — measured ~6% of a bench epoch), then steady-state
        # blocks amortize per-block overhead.
        size = BLOCK_BYTES >> 4
        with open(self.path_or_file, "rb") as f:
            f.seek(lo)
            remaining = hi - lo
            while remaining > 0:
                blk = f.read(min(size, remaining))
                size = min(size * 2, BLOCK_BYTES)
                if not blk:
                    break
                remaining -= len(blk)
                if not blk.endswith(b"\n"):
                    extra = f.readline()  # complete the split line
                    blk += extra
                    remaining -= len(extra)
                yield blk

    def batches(self) -> Iterator[tuple]:
        """One epoch of (fields, feats, vals, y, sample_w) batches.  Counts
        stream.batches and stream.parse_s, the seconds of its chunk parses
        on the parse pool (tracing)."""
        # Producer thread reads chunks and submits them to a parse pool;
        # chunk futures are queued in order so batch order == file order (the
        # reference's "each example seen once per epoch, in stream order").
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        err: list[BaseException] = []
        pool = cf.ThreadPoolExecutor(
            max_workers=1 if self._native_mt else self.n_parse_threads
        )

        def parse(lines):
            t0 = time.perf_counter()
            out = parse_lines(
                lines, self.file_type, self.max_nnz, self.n_feats,
                self.n_fields,
                # the line path (stdin/--cmd) shares the 1-worker pool when
                # native is available — parallelism must come from the
                # in-library threads, like the block path
                n_threads=self.n_parse_threads if self._native_mt else 1,
            )
            tracing.count("stream.parse_s", time.perf_counter() - t0)
            return out

        def parse_block(blk: bytes):
            t0 = time.perf_counter()
            out = parse_text(
                blk, self.file_type, self.max_nnz, self.n_feats, self.n_fields,
                n_threads=self.n_parse_threads if self._native_mt else 1,
            )
            tracing.count("stream.parse_s", time.perf_counter() - t0)
            return out

        def log_progress(seen, prev):
            # threshold-crossing check: fires for any chunk size, not only
            # when it divides log_every
            if self.log_every and seen // self.log_every > prev // self.log_every:
                print(f"processing {seen} examples")

        def produce_blocks():
            # file fast path: newline-aligned byte blocks straight to the
            # C++ chunk parser — no Python line loop, no join/encode
            seen = 0
            for blk in self._byte_blocks():
                if stopped.is_set():
                    return
                q.put(pool.submit(parse_block, blk))
                prev, seen = seen, seen + blk.count(b"\n")
                log_progress(seen, prev)

        def produce_lines():
            fh = self._open()
            lines: list[str] = []
            seen = 0
            for ln in fh:
                if not ln.strip():
                    continue
                lines.append(ln)
                if len(lines) >= self.chunk_lines:
                    if stopped.is_set():
                        return
                    q.put(pool.submit(parse, lines))
                    prev, seen = seen, seen + len(lines)
                    log_progress(seen, prev)
                    lines = []
            if lines:
                q.put(pool.submit(parse, lines))

        stopped = threading.Event()
        # locals: module globals (queue, sys) are cleared when this
        # generator is GC'd during interpreter shutdown; stdlib queue can't
        # even raise Empty then, so the unwind is skipped entirely there
        # (daemon threads die with the process — the leak concern is live
        # processes only)
        empty_exc = queue.Empty
        finalizing = sys.is_finalizing

        def produce():
            try:
                if isinstance(self.path_or_file, str):
                    produce_blocks()
                else:
                    produce_lines()
            except BaseException as e:  # surfaced to the consumer
                err.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()

        carry: Optional[tuple] = None  # leftover rows from previous chunk
        try:
            while True:
                fut = q.get()
                if fut is None:
                    break
                chunk = fut.result()
                worst = int(chunk.nnz.max(initial=0))
                if worst > self.max_nnz:
                    from ftrl_ffm_tpu_torch.data.parser import warn_truncation

                    warn_truncation(str(self.path_or_file), worst, self.max_nnz)
                arrays = (chunk.fields, chunk.feats, chunk.vals, chunk.y)
                if carry is not None:
                    arrays = tuple(
                        np.concatenate([c, a]) for c, a in zip(carry, arrays)
                    )
                n = arrays[3].shape[0]
                full = (n // self.batch_size) * self.batch_size
                for s in range(0, full, self.batch_size):
                    fields, feats, vals, y = (
                        a[s : s + self.batch_size] for a in arrays
                    )
                    tracing.count("stream.batches")
                    yield fields, feats, vals, y, np.ones(
                        self.batch_size, np.float32
                    )
                carry = tuple(a[full:] for a in arrays) if full < n else None
        finally:
            # Always unwind the producer: if the consumer abandons this
            # generator early or a parse future raised above, the producer
            # may be blocked on q.put (queue full) — signal stop, drain the
            # queue to unblock it, and join, so no thread/pool/file-handle
            # leaks accumulate in long-lived processes.
            stopped.set()
            if not finalizing():
                while True:
                    try:
                        q.get_nowait()
                    except empty_exc:
                        break
                t.join(timeout=30)
                pool.shutdown(wait=False)
        if err:
            raise err[0]
        if carry is not None and carry[3].shape[0]:
            fields, feats, vals, y = carry
            b = y.shape[0]
            pad = self.batch_size - b
            fmax = fields.shape[1]
            tracing.count("stream.batches")
            yield (
                np.concatenate([fields, np.zeros((pad, fmax), np.int32)]),
                np.concatenate(
                    [feats, np.full((pad, fmax), self.n_feats, np.int32)]
                ),
                np.concatenate([vals, np.zeros((pad, fmax), np.float32)]),
                np.concatenate([y, np.zeros(pad, np.float32)]),
                np.concatenate(
                    [np.ones(b, np.float32), np.zeros(pad, np.float32)]
                ),
            )
