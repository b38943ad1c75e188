"""The port's background feeder (train.py::_feed, _feed_interleaved,
_device_feed; ROADMAP.md Queue 1 item 5), on the CPU: twins of the
interleaved-feeder tests of tests/test_train.py and of
test_feed_workers_pinned_for_cmd_stdin, and the port's own checks of the
feeder's threads.

feed_workers > 1 places whole batches on several threads and hands them
over in stream order, so a run at 2 workers gives the 1-worker run's bits
(histories equal, tables torch.equal); it is also held against the JAX
Trainer at the same settings from the same init, to the chained-step
bound of tests/test_torch_train.py (rtol 2e-3, atol 5e-5)."""

import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
from ftrl_ffm_tpu_torch.models.base import Batch, ModelState
from ftrl_ffm_tpu_torch.train import Trainer
from tests.common import FIXTURE_FEATS, FIXTURE_FIELDS, write_fixture
from tests.test_torch_train import _assert_states_close

CHAIN_RTOL, CHAIN_ATOL = 2e-3, 5e-5


def _kw(train, evalp="", **kw):
    """tests/test_train.py::_cfg's settings (libffm fixture, B=16)."""
    return {
        **dict(train_data=train, eval_data=evalp, model_type="FFM", n_feats=FIXTURE_FEATS,
               n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=1, online=True,
               batch_size=16, w_alpha=0.05),
        **kw,
    }


def _init(jtr) -> ModelState:
    return ModelState(*(None if t is None else t.clone()
                        for t in state_from_jax_arrays(jtr.state, "cpu")))


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_feed_interleaved_preserves_order_and_results(tmp_path, steps_per_call):
    """feed_workers=2 gives the bit-identical run (streamed, two epochs
    with eval; also with grouped steps, whose groups the workers place):
    the reorder buffer keeps the stream order, so FTRL's update order is
    unchanged; the JAX Trainer's feed_workers=2 run agrees within the
    chained bound."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "eval.ffm", "libffm", seed=1)
    kw = _kw(train, evalp, n_epochs=2, device_cache="off", steps_per_call=steps_per_call)
    jtr = JTrainer(JConfig(**kw, feed_workers=2))
    inits = [_init(jtr) for _ in range(2)]
    j_hist = jtr.train()
    runs = []
    for workers, init in zip((1, 2), inits):
        tr = Trainer(TConfig(device="cpu", **kw, feed_workers=workers), state=init)
        runs.append((tr.train(), tr))
    (h1, t1), (h2, t2) = runs
    assert h1 == h2
    for name, a, b in zip(ModelState._fields, t1.state, t2.state):
        assert (a is None and b is None) or torch.equal(a, b), name
    for key in ("train_loss", "eval_loss", "eval_auc"):
        np.testing.assert_allclose(h2[key], j_hist[key], rtol=CHAIN_RTOL, atol=CHAIN_ATOL,
                                   err_msg=key)
    _assert_states_close(t2.logical_state, jtr.logical_state)


class _Dummy:
    """Just what _feed_interleaved reads of a Trainer: nothing."""


@pytest.mark.parametrize("workers,switch", [(3, None), (8, 1e-6)],
                         ids=["3-workers", "8-workers-fast-switch"])
def test_feed_interleaved_ordering_stress(workers, switch):
    """_feed_interleaved with a jittery place() over many items: exactly
    the input order, each item placed once; also with more workers than
    this host's cores and the interpreter switching threads every
    microsecond."""
    rng = random.Random(0)
    placed = []
    lock = threading.Lock()

    def place(i):
        time.sleep(rng.random() * 0.002)
        with lock:
            placed.append(i)
        return i * 10

    old = sys.getswitchinterval()
    try:
        if switch is not None:
            sys.setswitchinterval(switch)
        out = list(Trainer._feed_interleaved(_Dummy(), iter(range(200)), place, workers))
    finally:
        sys.setswitchinterval(old)
    assert out == [i * 10 for i in range(200)]
    assert sorted(placed) == list(range(200))


@pytest.mark.parametrize("workers", [1, 2])
def test_feed_propagates_errors(workers):
    """A place() that raises reaches the consumer, from the one-thread
    feeder and from the interleaved one."""
    class Dummy:
        _feed_interleaved = Trainer._feed_interleaved

        def _feed_worker_count(self):
            return workers

    def place(i):
        if i == 5:
            raise RuntimeError("boom in place")
        return i

    with pytest.raises(RuntimeError, match="boom in place"):
        list(Trainer._feed(Dummy(), iter(range(50)), place))


def test_feed_workers_pinned_for_cmd_stdin(tmp_path):
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(TConfig(device="cpu", **_kw(train, feed_workers=4)))
    assert tr._feed_worker_count() == 4  # honored, no hidden clamp
    tr.cfg.cmd = True
    assert tr._feed_worker_count() == 1  # stdin pins 1


def _wait_for_threads(baseline, timeout=10.0):
    """The live threads beyond `baseline`, after waiting up to `timeout`
    seconds for them to end."""
    deadline = time.monotonic() + timeout
    while True:
        extra = [t for t in threading.enumerate() if t not in baseline and t.is_alive()]
        if not extra or time.monotonic() > deadline:
            return extra
        time.sleep(0.01)


@pytest.mark.parametrize("workers", [1, 2])
def test_abandoned_feed_leaves_no_thread(tmp_path, workers):
    """A consumer that stops after one batch (a streamed epoch, grouped
    too): the feeder's threads are joined and its source closed, with the
    stream reader's threads, so no thread outlives the generator."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(TConfig(device="cpu", **_kw(train, feed_workers=workers,
                                             device_cache="off")))
    baseline = set(threading.enumerate())
    feed = tr._device_feed(tr._train_batches(np.random.default_rng(0)))
    batch = next(feed)
    assert isinstance(batch, Batch) and batch.feats.shape == (16, FIXTURE_FIELDS)
    feed.close()
    assert _wait_for_threads(baseline) == []
    groups = tr._device_feed_multi(tr._grouped(tr._train_batches(np.random.default_rng(0)), 2))
    group, real = next(groups)
    assert group.feats.shape == (2, 16, FIXTURE_FIELDS) and real == 2
    groups.close()
    assert _wait_for_threads(baseline) == []


def test_grouped_pads_with_inert_batches(tmp_path):
    """_grouped: [S, ...] stacks of the stream's batches, the remainder
    padded with _inert_batch (sample_w 0, the sentinel id), and the real
    step count beside each group."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(TConfig(device="cpu", **_kw(train, batch_size=24, device_cache="off")))
    batches = list(tr._train_batches(np.random.default_rng(0)))
    groups = list(tr._grouped(iter(batches), 2))
    assert [real for _, real in groups] == [2, 1]  # 64 rows: 3 batches
    last = groups[1][0]
    for i, leaf in enumerate(last):
        np.testing.assert_array_equal(leaf[0], batches[2][i])
        np.testing.assert_array_equal(leaf[1], tr._inert_batch()[i])
    assert (last[1][1] == FIXTURE_FEATS).all() and not last[4][1].any()
