"""The port's spans and counters (ftrl_ffm_tpu_torch/tracing.py), on the CPU.

Without a profiler a span is the shared no-op and makes no RecordFunction;
under torch.profiler the resident and streamed epochs and eval passes carry
their spans, nested in the epoch's or the pass's, one a step or a group;
profiling changes no bits; the parse counters split a file's rows between
the native and the numpy parser; --profile_dir's trace holds the spans."""

import json
import os
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from ftrl_ffm_tpu_torch import native, tracing
from ftrl_ffm_tpu_torch.cli import main as torch_main
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.data.loader import load_file
from ftrl_ffm_tpu_torch.train import Trainer
from tests.common import FIXTURE_FEATS, FIXTURE_FIELDS, N_FIXTURE_LINES, write_fixture

B = 24
STEPS = -(-N_FIXTURE_LINES // B)  # 3 padded steps a pass


def _trainer(tmp_path, **kw) -> Trainer:
    train = write_fixture(tmp_path / "train.ffm")
    evalp = write_fixture(tmp_path / "eval.ffm", seed=1)
    cfg = dict(train_data=train, eval_data=evalp, model_type="FFM", n_feats=FIXTURE_FEATS,
               n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=2, online=False, batch_size=B,
               w_alpha=0.05, w_l1=0.15, w_l2=1.0, init_stddev=0.1, device="cpu",
               device_cache="on", seed=5)
    cfg.update(kw)
    return Trainer(Config(**cfg))


def _profiled(fn):
    """(fn's result, the spans of its trace: (name, start, end))."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith(tracing.PREFIX)]
    return out, spans


def _run(t: Trainer):
    """Two epochs, each followed by an eval pass."""
    return [(t.train_epoch(), t.evaluate()) for _ in range(2)]


def _inside(spans, outer: str, inner: str) -> bool:
    outers = [(a, b) for n, a, b in spans if n == tracing.PREFIX + outer]
    inners = [(a, b) for n, a, b in spans if n == tracing.PREFIX + inner]
    return bool(inners) and all(any(a0 <= a and b <= b0 for a0, b0 in outers)
                                for a, b in inners)


def test_span_without_profiler_is_the_shared_noop(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a RecordFunction was made with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("train.step") is tracing.span("eval.pass")
    with tracing.span("train.step"):
        pass
    # every span site of a resident run, S = 1 and S = 2, and a streamed one
    for kw in ({}, {"steps_per_call": 2}, {"device_cache": "off"}):
        _run(_trainer(tmp_path, **kw))


@pytest.mark.parametrize("s", [1, 2])
def test_resident_spans_nest_and_count(tmp_path, s):
    t = _trainer(tmp_path, steps_per_call=s)
    t._fresh_cache("train"), t._fresh_cache("eval")
    _, spans = _profiled(lambda: _run(t))
    names = Counter(n[len(tracing.PREFIX):] for n, _, _ in spans)
    groups = -(-STEPS // s)
    assert names["train.epoch"] == 2 and names["eval.pass"] == 2
    if s == 1:
        assert names["train.step"] == names["train.gather"] == 2 * STEPS
        assert names["eval.step"] == names["eval.gather"] == 2 * STEPS
        train, evals = ("train.step", "train.gather"), ("eval.step", "eval.gather")
    else:
        assert names["train.group"] == names["eval.group"] == 2 * groups
        # the arange of each eval pass (a shuffled train pass makes its
        # table in train.order, or takes the one made ahead)
        assert names["index"] == 2
        train, evals = ("train.group",), ("eval.group",)
    for inner in ("train.order", "upload", "train.loss_close", *train):
        assert _inside(spans, "train.epoch", inner), inner
    for inner in ("eval.close", *evals):
        assert _inside(spans, "eval.pass", inner), inner
    assert names["train.order"] == 2 and names["eval.close"] == 2
    outer = [(a, b) for n, a, b in spans if n in ("ftrl.train.epoch", "ftrl.eval.pass")]
    assert all(any(a0 <= a and b <= b0 for a0, b0 in outer) for _, a, b in spans)


def test_resident_build_spans(tmp_path):
    t = _trainer(tmp_path)
    _, spans = _profiled(lambda: t._fresh_cache("train"))
    names = [n for n, _, _ in spans]
    assert names.count("ftrl.data.parse") == names.count("ftrl.data.upload") == 1


@pytest.mark.parametrize("kw", [{}, {"steps_per_call": 2}, {"device_cache": "off"}],
                         ids=["resident", "resident-s2", "streamed"])
def test_profiling_changes_no_bits(tmp_path, kw):
    plain, traced = _trainer(tmp_path, **kw), _trainer(tmp_path, **kw)
    want = _run(plain)
    got, _ = _profiled(lambda: _run(traced))
    assert got == want
    assert all(np.isfinite(x) for ep in want for x in (ep[0], *ep[1]))
    for a, b in zip(plain.state, traced.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("workers", [1, 2])
def test_streamed_epoch_waits_on_the_feeder(tmp_path, workers):
    t = _trainer(tmp_path, device_cache="off", feed_workers=workers)
    tracing.reset()
    _, spans = _profiled(t.train_epoch)
    names = Counter(n for n, _, _ in spans)
    assert names["ftrl.feed.wait"] >= STEPS and names["ftrl.train.step"] == STEPS
    assert _inside(spans, "train.epoch", "feed.wait")
    counts = tracing.read()
    assert counts["feed.batches"] == STEPS
    assert counts["upload.bytes.train"] > 0 and counts["feed.place_s"] >= counts["feed.compact_s"]


def test_online_stream_counts_batches(tmp_path):
    t = _trainer(tmp_path, online=True, device_cache="off")
    tracing.reset()
    t.train_epoch()
    counts = tracing.read()
    assert counts["stream.batches"] == counts["feed.batches"] == STEPS
    assert counts["stream.parse_s"] > 0


def _write_rows(path, n: int) -> str:
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{i % 2} " + " ".join(f"{c}:{int(rng.integers(50))}:1" for c in range(3))
                    + "\n")
    return str(path)


@pytest.mark.parametrize("without_native", [False, True])
def test_load_file_counts_rows_by_parser(tmp_path, monkeypatch, without_native):
    path = _write_rows(tmp_path / "rows.ffm", 3001)
    if without_native:
        monkeypatch.setattr(native, "lib", lambda: None)
    tracing.reset()
    ds = load_file(path, "libffm", 3, 50, 3, n_workers=3)
    counts = tracing.read()
    native_rows, numpy_rows = counts.get("parse.rows.native", 0), counts.get("parse.rows.numpy", 0)
    assert ds.n == native_rows + numpy_rows == 3001
    if without_native:
        assert native_rows == 0 and counts["parse.s.numpy"] > 0


def test_read_holds_the_launch_and_collective_counters():
    tracing.reset()
    tracing.count("x.y", 2)
    tracing.count("x.y")
    counts = tracing.read()
    assert counts["x.y"] == 3
    assert "launches.ftrl_update" in counts and "collectives.all_reduce" in counts
    assert "launches.ftrl_update.by_instance.rows" in counts
    tracing.reset()
    assert "x.y" not in tracing.read()


def test_counts_from_many_threads_add_up():
    tracing.reset()
    workers, adds = 4 * (os.cpu_count() or 1), 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tracing.count("t.n") for _ in range(adds)])
                   for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert tracing.read()["t.n"] == workers * adds


def test_profile_dir_trace_holds_the_spans(tmp_path, capsys):
    train = write_fixture(tmp_path / "train.ffm")
    prof = tmp_path / "prof"
    argv = ["--train_data", train, "--model_type", "FFM", "--n_fields", str(FIXTURE_FIELDS),
            "--n_feats", str(FIXTURE_FEATS), "--n_factors", "4", "--batch_size", str(B),
            "--file_type", "libffm", "--n_epochs", "1", "--device", "cpu",
            "--profile_dir", str(prof)]
    assert torch_main(argv) == 0
    assert "epoch 1 train time: " in capsys.readouterr().out
    (trace,) = prof.glob("*.pt.trace.json")
    with open(trace) as f:
        names = Counter(e.get("name") for e in json.load(f)["traceEvents"]
                        if e.get("cat") == "user_annotation")
    assert names["ftrl.train.epoch"] == 1 and names["ftrl.train.step"] >= 1
    assert os.path.getsize(trace) > 0
