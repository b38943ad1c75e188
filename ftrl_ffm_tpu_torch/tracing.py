"""Spans and counters of the port, at its layer boundaries.

Spans name what the thread that drives the device is doing: the epoch, its
start (the shuffle, the index table, the upload), each step or group and
its gather, the eval pass, its steps and its close, the feeder wait, the
resident build's parse and upload, a kernel build.

    with tracing.span("train.step"):
        ...

Where no torch.profiler is recording on this thread, `span` returns one
shared no-op context (a single check, ~0.1 us): nothing is recorded and
no RecordFunction is made.  Under a profiler it is
torch.profiler.record_function("ftrl." + name), so the spans land in the
profiler's Chrome trace beside the device operations, on its clock, each
nested in its parent.  `--profile_dir` traces carry them, as does any
profiler a caller opens around train_epoch() or evaluate().

The profiler records no span opened on a Python thread of the program's
own (the feeder, load_file's parse pool, the stream reader), so their work
is counted instead: `count(name, n)` adds to one flat registry under a lock,
always on (one add a chunk, a batch or a build, none a row).  `read()`
returns the registry, with every kind of collectives.<kind> (0 where none
ran), and, under their own names, the kernel wrappers' launch counters
(`launches.<wrapper>[.<by_instance|by_dtype>.<key>]`, from
ops.launch_counts), which stay stored where they are.  `reset()` clears
the registry only.  A captured CUDA graph takes back what its capture
counted under CAPTURED and adds it again at each replay (train.py::_Graph).

Counters (seconds are the host's perf_counter):
  parse.rows.native, parse.rows.numpy   rows parsed by each parser
  parse.s.native, parse.s.numpy         seconds in each (data/parser.py)
  native.builds                         builds of the native parser
  kernels.builds, kernels.build_s       builds of the CUDA kernel library
  upload.bytes.<role>                   host bytes uploaded, by role
  feed.batches, feed.place_s            batches placed by the feeder
  feed.compact_s                        seconds in the transfer tiers
  stream.batches, stream.parse_s        batches of the stream reader, and
                                        seconds of its chunk parses
  order.prefetch.hit, .miss             shuffled resident passes that took
                                        the permutation drawn ahead, and
                                        those that drew it (train.py)
  collectives.<kind>                    collectives issued, by kind, and the
  collectives.bytes.<kind>              bytes this rank handed them
                                        (parallel/dist.py::_count)
  mesh.<role>.steps, mesh.<role>.bytes  sharded train or eval steps, and
                                        the bytes of their collectives
                                        (parallel/dist.py::step_role)
  init.rows                             rows of a rank's fresh init
                                        (parallel/mesh.py::init_shard)
  route.update.touched, .pass           routed updates that took the
                                        touched-rows launch on the received
                                        slots, and those that took a pass
                                        over the shard (parallel/sharded.py::
                                        _update_routed)

Spans of the mesh (parallel/sharded.py, parallel/mesh.py): route.ids,
route.rows, route.update (the route's exchange), mesh.sums (a step's
all_reduce of its sums), init.shard (a rank's fresh init).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

PREFIX = "ftrl."

_NOOP = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_counts: dict = {}
# counters a captured CUDA graph replays: those counted on the capturing
# thread while a step runs
CAPTURED = ("collectives.", "mesh.", "route.update.")


def span(name: str):
    """A span of this thread's work named "ftrl." + name where a profiler
    records, else the shared no-op context."""
    if not _recording():
        return _NOOP
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """A decorator: each call of the function runs inside span(name)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n=1) -> None:
    """Add n to the counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def snapshot(prefixes: tuple = CAPTURED) -> dict:
    """The registry's counters whose names start with one of `prefixes`."""
    with _lock:
        return {k: n for k, n in _counts.items() if k.startswith(prefixes)}


def reset() -> None:
    """Clear the registry (the launch counters stay)."""
    with _lock:
        _counts.clear()


def read() -> dict:
    """Every counter, flat: the registry's, then the launch and collective
    counters under their own names."""
    from ftrl_ffm_tpu_torch.ops import launch_counts
    from ftrl_ffm_tpu_torch.parallel import dist

    with _lock:
        out = dict(_counts)
    for key, n in launch_counts().items():
        name = "launches." + key[0].__name__
        if key[1] is not None:
            name += f".{key[1][len('launches_'):]}.{key[2]}"
        out[name] = n
    for kind in dist.counts:
        out.setdefault("collectives." + kind, 0)
    return out
