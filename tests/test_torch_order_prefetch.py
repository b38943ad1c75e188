"""The resident pass's permutation drawn ahead (ftrl_ffm_tpu_torch/train.py::
Trainer._cached_order), on the CPU.

While a shuffled resident epoch runs, the next epoch's permutation is drawn
on the trainer's order thread from a copy of the epoch rng.  The next epoch
takes it where the rng object, its state and the dataset are unchanged (a
hit), else draws it itself (a miss).  Either way each epoch sees the
permutation that back-to-back `shuffle(arange(n))` draws give, and the rng
ends where they leave it: the same losses and state bit for bit as epochs
that always draw themselves."""

import copy
import threading

import numpy as np
import pytest
import torch

from ftrl_ffm_tpu_torch import tracing
from ftrl_ffm_tpu_torch import train as train_mod
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.train import Trainer
from tests.common import FIXTURE_FEATS, FIXTURE_FIELDS, N_FIXTURE_LINES, write_fixture

SEED = 5
B = 24


def _trainer(tmp_path, **kw) -> Trainer:
    train = write_fixture(tmp_path / "train.ffm")
    evalp = write_fixture(tmp_path / "eval.ffm", seed=1)
    cfg = dict(train_data=train, eval_data=evalp, model_type="FFM", n_feats=FIXTURE_FEATS,
               n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=4, online=False, batch_size=B,
               w_alpha=0.05, w_l1=0.15, w_l2=1.0, init_stddev=0.1, device="cpu",
               device_cache="on", seed=SEED)
    cfg.update(kw)
    return Trainer(Config(**cfg))


def _record_orders(t: Trainer) -> list:
    """The permutation of every shuffled resident pass of `t`, in turn."""
    orders, inner = [], t._cached_order

    def spy(cache, epoch_rng, n_steps, pad):
        idx = inner(cache, epoch_rng, n_steps, pad)
        if idx is not None:
            flat = idx.cpu().numpy().ravel()
            assert idx.shape == (n_steps, B) and idx.dtype == torch.int32
            assert (flat[cache.n:] == pad).all()
            orders.append(flat[:cache.n].astype(np.int64))
        return idx

    t._cached_order = spy
    return orders


def _synchronous(t: Trainer) -> Trainer:
    """`t` with the prefetch never taken: every pass draws its own."""
    t._take_order = lambda key, rng: None
    return t


def _draws(rng: np.random.Generator, n: int, k: int) -> list:
    out = []
    for _ in range(k):
        order = np.arange(n)
        rng.shuffle(order)
        out.append(order)
    return out


class _Counts:
    """order.prefetch.hit / .miss counted since construction."""

    def __init__(self):
        self.base = self._now()

    @staticmethod
    def _now() -> tuple:
        c = tracing.read()
        return c.get("order.prefetch.hit", 0), c.get("order.prefetch.miss", 0)

    def __call__(self) -> tuple:
        now = self._now()
        return now[0] - self.base[0], now[1] - self.base[1]


def _same_states(a: Trainer, b: Trainer) -> bool:
    return all(x is None and y is None or torch.equal(x, y) for x, y in zip(a.state, b.state))


def _same_rng_state(a, b) -> bool:
    return train_mod._same_state(a.bit_generator.state, b.bit_generator.state)


@pytest.mark.parametrize("s", [1, 2])
def test_epochs_match_back_to_back_draws(tmp_path, s):
    t = _trainer(tmp_path, steps_per_call=s)
    ref = _synchronous(_trainer(tmp_path, steps_per_call=s))
    orders = _record_orders(t)
    counts = _Counts()
    losses = [t.train_epoch() for _ in range(4)]
    assert counts() == (3, 1)
    ref_losses = [ref.train_epoch() for _ in range(4)]
    assert losses == ref_losses
    assert _same_states(t, ref)
    rng = np.random.default_rng(SEED)
    for got, want in zip(orders, _draws(rng, N_FIXTURE_LINES, 4), strict=True):
        np.testing.assert_array_equal(got, want)
    assert _same_rng_state(t._epoch_rng, rng)
    assert _same_rng_state(t._epoch_rng, ref._epoch_rng)


def test_train_with_its_own_rng(tmp_path):
    t = _trainer(tmp_path)
    ref = _synchronous(_trainer(tmp_path))
    orders = _record_orders(t)
    counts = _Counts()
    hist = t.train()
    assert counts() == (3, 1)
    assert hist == ref.train()
    assert _same_states(t, ref)
    for got, want in zip(orders, _draws(np.random.default_rng(SEED), N_FIXTURE_LINES, 4),
                         strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("change", ["advanced", "other_generator"])
def test_changed_rng_misses_and_draws_itself(tmp_path, change):
    t = _trainer(tmp_path)
    orders = _record_orders(t)
    rng = np.random.default_rng(SEED)
    t.train_epoch(rng)
    if change == "advanced":
        rng.random()
    else:
        # another object in the very state the job was drawn from
        rng = copy.deepcopy(rng)
    expect = copy.deepcopy(rng)
    counts = _Counts()
    t.train_epoch(rng)
    assert counts() == (0, 1)
    np.testing.assert_array_equal(orders[-1], _draws(expect, N_FIXTURE_LINES, 1)[0])
    assert _same_rng_state(rng, expect)
    # the next epoch takes the permutation drawn ahead again
    t.train_epoch(rng)
    assert counts() == (1, 1)
    np.testing.assert_array_equal(orders[-1], _draws(expect, N_FIXTURE_LINES, 1)[0])
    assert _same_rng_state(rng, expect)


@pytest.mark.parametrize("rebuilt_n", [N_FIXTURE_LINES - 5, N_FIXTURE_LINES])
def test_rebuilt_cache_misses(tmp_path, rebuilt_n):
    t = _trainer(tmp_path)
    orders = _record_orders(t)
    rng = np.random.default_rng(SEED)
    t.train_epoch(rng)
    # a rebuilt dataset: another object, here with another row count too
    t._dev_cache["train"] = t._dev_cache["train"]._replace(n=rebuilt_n)
    want = _draws(copy.deepcopy(rng), rebuilt_n, 1)[0]
    counts = _Counts()
    t.train_epoch(rng)
    assert counts() == (0, 1)
    np.testing.assert_array_equal(orders[-1], want)


@pytest.mark.parametrize("epochs", [1, 2, 6])
def test_counts_one_miss_then_hits(tmp_path, epochs):
    t = _trainer(tmp_path)
    counts = _Counts()
    for _ in range(epochs):
        t.train_epoch()
        t.evaluate()
    assert counts() == (epochs - 1, 1)


def test_unshuffled_passes_count_nothing(tmp_path):
    t = _trainer(tmp_path, online=True)
    counts = _Counts()
    for _ in range(3):
        t.train_epoch()
        t.evaluate()
    assert counts() == (0, 0)
    assert t._order_job is None


def test_array_state_generator_hits_with_its_bits(tmp_path):
    """A bit generator whose state holds arrays (Philox) compares by value."""
    t = _trainer(tmp_path)
    ref = _synchronous(_trainer(tmp_path))
    orders = _record_orders(t)
    rng, ref_rng = (np.random.Generator(np.random.Philox(11)) for _ in range(2))
    counts = _Counts()
    losses = [t.train_epoch(rng) for _ in range(3)]
    assert counts() == (2, 1)
    assert losses == [ref.train_epoch(ref_rng) for _ in range(3)]
    want = _draws(np.random.Generator(np.random.Philox(11)), N_FIXTURE_LINES, 3)
    for got, w in zip(orders, want, strict=True):
        np.testing.assert_array_equal(got, w)
    assert _same_rng_state(rng, ref_rng)


def test_failed_job_misses_and_draws_itself(tmp_path, monkeypatch):
    draw = train_mod._draw_rows
    main = threading.main_thread()

    def fail_off_main(gen, *shape):
        if threading.current_thread() is not main:
            raise MemoryError("order thread")
        return draw(gen, *shape)

    monkeypatch.setattr(train_mod, "_draw_rows", fail_off_main)
    t = _trainer(tmp_path)
    ref = _synchronous(_trainer(tmp_path))
    orders = _record_orders(t)
    counts = _Counts()
    losses = [t.train_epoch() for _ in range(3)]
    assert counts() == (0, 3)
    assert losses == [ref.train_epoch() for _ in range(3)]
    for got, want in zip(orders, _draws(np.random.default_rng(SEED), N_FIXTURE_LINES, 3),
                         strict=True):
        np.testing.assert_array_equal(got, want)
    assert _same_rng_state(t._epoch_rng, ref._epoch_rng)
