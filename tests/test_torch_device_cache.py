"""The port's device-resident datasets (Config.device_cache, one device):
twins of the single-device tests of tests/test_device_cache.py, on the CPU.

The port runs eagerly, so a resident run and a streamed (device_cache=off)
run from one state give the same bits: histories equal and tables
torch.equal.  Each run is also held against the JAX Trainer with
device_cache="on" from the same init (carried across by
state_from_jax_arrays), to the chained-step bound of
tests/test_torch_train.py (rtol 2e-3, atol 5e-5).  The compact encodings
are round-tripped directly at n_feats >= 2^24 (no Trainer: its tables
would take GBs), and the DEC6 decode is checked over all 2^24 keys.

Not here: the mesh and shard-layout tests, in
tests/test_torch_mesh_cache.py and tests/test_torch_mesh_groups.py, and
the unrolled replay (FTRL_IOTA_UNROLL), which is not ported.  steps_per_call grouping over
the resident data is tests/test_torch_steps_per_call.py; save_every from
a resident epoch is
tests/test_torch_checkpoint_write.py::test_cached_save_every_fires."""

import sys

import numpy as np
import pytest
import torch

from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
from ftrl_ffm_tpu_torch.models.base import ModelState, dec6_decode, take_cached
from ftrl_ffm_tpu_torch.train import (
    Trainer,
    _compact_cache_arrays,
    _compact_cache_row_bytes,
    _decode_cached_batch,
)
from tests.common import FIXTURE_FEATS, FIXTURE_FIELDS, write_fixture
from tests.test_device_cache import _reverse_fields
from tests.test_torch_train import _assert_states_close

CHAIN_RTOL, CHAIN_ATOL = 2e-3, 5e-5


def _kw(train, evalp="", **kw):
    """tests/test_device_cache.py::_cfg's settings: 64 fixture lines at
    B=24 give 3 padded steps an epoch."""
    return {
        **dict(train_data=train, eval_data=evalp, model_type="FFM", n_feats=FIXTURE_FEATS,
               n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=3, online=False,
               batch_size=24, w_alpha=0.05, w_l1=0.15, w_l2=1.0),
        **kw,
    }


def _init(jtr) -> ModelState:
    """A fresh CPU copy of the JAX Trainer's init (each port Trainer
    trains its own copy in place)."""
    return ModelState(*(None if t is None else t.clone()
                        for t in state_from_jax_arrays(jtr.state, "cpu")))


def _twins(kw, on=None):
    """(JAX Trainer with device_cache=on, port Trainer with `on` settings,
    port Trainer with device_cache=off), all from the JAX init."""
    on = {"device_cache": "on"} if on is None else on
    jtr = JTrainer(JConfig(**kw, **on))
    t_on = Trainer(TConfig(device="cpu", **kw, **on), state=_init(jtr))
    t_off = Trainer(TConfig(device="cpu", **kw, device_cache="off"), state=_init(jtr))
    return jtr, t_on, t_off


def _same_bits(h_on, h_off, t_on, t_off):
    assert h_on == h_off
    for name, a, b in zip(ModelState._fields, t_on.logical_state, t_off.logical_state):
        assert torch.equal(a, b), name


def _close_to_jax(h, j_hist, t, jtr):
    for key in h:
        np.testing.assert_allclose(h[key], j_hist[key], rtol=CHAIN_RTOL, atol=CHAIN_ATOL,
                                   err_msg=key)
    _assert_states_close(t.logical_state, jtr.logical_state)


def _train_all(jtr, t_on, t_off):
    """Train the three; the histories (JAX, port resident, port streamed)."""
    return jtr.train(), t_on.train(), t_off.train()


def test_cached_matches_streamed_exactly(tmp_path):
    """Offline, shuffled, with eval, on fields that are not 0..F-1 (no
    fields marker): the resident run gives the streamed run's bits."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "e.ffm", "libffm", seed=1)
    _reverse_fields(train)
    _reverse_fields(evalp)
    jtr, t_on, t_off = _twins(_kw(train, evalp))
    j_hist, h_on, h_off = _train_all(jtr, t_on, t_off)
    assert t_on._dev_cache["train"] is not None and t_on._dev_cache["eval"] is not None
    assert t_on._dev_cache["train"].ds[0].shape[0] == 65  # no iota marker
    assert "train" not in t_off._dev_cache and "eval" not in t_off._dev_cache
    assert jtr._dev_cache["train"] is not None
    _same_bits(h_on, h_off, t_on, t_off)
    _close_to_jax(h_on, j_hist, t_on, jtr)


def test_cached_engages_automatically_offline(tmp_path):
    """auto engages on the CPU (device memory is the host's RAM, which
    already holds the parsed rows), as in the JAX package."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    jtr, t_on, t_off = _twins(_kw(train), on={})
    losses = [t.train_epoch() for t in (jtr, t_on, t_off)]
    assert jtr._dev_cache.get("train") is not None
    assert t_on._dev_cache.get("train") is not None
    assert not hasattr(t_on, "_train_ds")  # the host copy is freed
    assert losses[1] == losses[2]
    np.testing.assert_allclose(losses[1], losses[0], rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_online_train_cached_matches_streamed(tmp_path):
    """Online training replays the resident dataset in file order: the
    streamed online run's batches, losses and tables; eval rides along."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "e.ffm", "libffm", seed=1)
    jtr, t_on, t_off = _twins(_kw(train, evalp, online=True))
    j_hist, h_on, h_off = _train_all(jtr, t_on, t_off)
    assert t_on._dev_cache["train"] is not None
    assert t_on._dev_cache["train"].src_stat is not None
    _same_bits(h_on, h_off, t_on, t_off)
    _close_to_jax(h_on, j_hist, t_on, jtr)


def test_online_train_cache_engages_automatically(tmp_path):
    """auto engages for a file-backed online run of more than one epoch."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    jtr, t_on, _ = _twins(_kw(train, online=True), on={})
    jl, tl = jtr.train_epoch(), t_on.train_epoch()
    assert jtr._dev_cache.get("train") is not None
    assert t_on._dev_cache.get("train") is not None
    np.testing.assert_allclose(tl, jl, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_online_cmd_stdin_never_caches_train(tmp_path, monkeypatch):
    """--cmd streams stdin, which cannot be re-read: the train role
    declines before touching any file, even under device_cache=on, and
    the epoch streams from stdin."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    kw = _kw(train, online=True, cmd=True, max_nnz=FIXTURE_FIELDS)
    jtr, t_on, t_off = _twins(kw)
    for tr in (jtr, t_on):
        assert tr._ensure_device_cache("train") is None
        assert tr._dev_cache.get("train", None) is None
    losses = []
    for tr in (jtr, t_on, t_off):
        with open(train) as f:
            monkeypatch.setattr(sys, "stdin", f)
            losses.append(tr.train_epoch())
    assert losses[1] == losses[2]
    np.testing.assert_allclose(losses[1], losses[0], rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_cached_canonical_markers_match_streamed(tmp_path):
    """Canonical CTR content (fields 0..F-1 in order, every value 1) stores
    the zero-size markers; the remainder batch's pad rows see the expanded
    iota and ones (inert through sample_w 0 and the sentinel id), and the
    run still gives the streamed run's bits."""
    path = str(tmp_path / "canon.ffm")
    rng = np.random.default_rng(5)
    with open(path, "w") as f:
        for _ in range(58):  # not a multiple of 24: a remainder batch
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(c * 10, (c + 1) * 10))}:1"
                for c in range(FIXTURE_FIELDS)
            ]
            f.write(" ".join(toks) + "\n")
    jtr, t_on, t_off = _twins(_kw(path))
    j_hist, h_on, h_off = _train_all(jtr, t_on, t_off)
    entry = t_on._dev_cache["train"]
    assert entry.n == 58
    assert entry.ds[0].shape == (0, FIXTURE_FIELDS)  # iota fields marker
    assert entry.ds[2].shape == (0, FIXTURE_FIELDS)  # all-ones vals marker
    assert entry.ds[1].shape == (59, FIXTURE_FIELDS)  # + the pad row
    assert int(entry.ds[1][58].min()) == FIXTURE_FEATS
    _same_bits(h_on, h_off, t_on, t_off)
    _close_to_jax(h_on, j_hist, t_on, jtr)


def test_cached_step_count_and_remainder(tmp_path):
    """64 samples at B=24: 3 steps an epoch with a padded remainder, whose
    pad rows count neither in the loss nor as steps."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    jtr, t_on, t_off = _twins(_kw(train, n_epochs=1))
    losses = [t.train_epoch() for t in (jtr, t_on, t_off)]
    assert np.isfinite(losses[1]) and losses[1] == losses[2]
    np.testing.assert_allclose(losses[1], losses[0], rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    assert int(t_on.state.step) == int(jtr.state.step) == 3
    assert t_on._steps_done == 3


def test_online_auto_single_epoch_stays_streamed(tmp_path):
    """auto does not engage for a single online epoch (nothing amortizes
    the blocking build); n_epochs > 1 engages; "on" engages for one epoch
    too.  The JAX package decides the same in each case."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    for n_epochs, mode, engaged in ((1, "auto", False), (2, "auto", True), (1, "on", True)):
        kw = _kw(train, online=True, n_epochs=n_epochs)
        jtr, t_on, _ = _twins(kw, on={"device_cache": mode})
        j_hist, h = jtr.train(), t_on.train()
        for tr in (jtr, t_on):
            assert (tr._dev_cache.get("train", None) is not None) == engaged
        np.testing.assert_allclose(h["train_loss"], j_hist["train_loss"],
                                   rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_online_cache_rebuilds_when_file_changes(tmp_path, capsys):
    """The resident online replay is a snapshot: a file rewritten between
    epochs is re-read (the streamed rewind re-reads every epoch): the same
    bits as a streamed twin across the rewrite, and a rebuilt entry."""
    path = str(tmp_path / "t.ffm")
    write_fixture(path, "libffm", seed=0)
    jtr, t_on, t_off = _twins(_kw(path, online=True, n_epochs=2))
    trainers = (jtr, t_on, t_off)
    first = [tr.train_epoch(np.random.default_rng(0)) for tr in trainers]
    entry = t_on._dev_cache["train"]
    write_fixture(path, "libffm", seed=5)  # new content, same path
    second = [tr.train_epoch(np.random.default_rng(0)) for tr in trainers]
    assert t_on._dev_cache["train"] is not entry
    assert "WARNING: train file changed" in capsys.readouterr().out
    assert first[1] == first[2] and second[1] == second[2]
    np.testing.assert_allclose(first[1:2] + second[1:2], first[:1] + second[:1],
                               rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    _same_bits({}, {}, t_on, t_off)
    _assert_states_close(t_on.logical_state, jtr.logical_state)


def test_online_eval_cache_rebuilds_when_file_changes(tmp_path):
    """Online eval re-reads its file every pass too: a rewritten eval file
    is re-read by the resident eval, to the streamed twin's metrics."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    evalp = str(tmp_path / "e.ffm")
    write_fixture(evalp, "libffm", seed=1)
    jtr, t_on, t_off = _twins(_kw(train, evalp, online=True))
    trainers = (jtr, t_on, t_off)
    for tr in trainers:
        tr.train_epoch(np.random.default_rng(0))
    m1 = [tr.evaluate() for tr in trainers]
    entry = t_on._dev_cache["eval"]
    write_fixture(evalp, "libffm", seed=9)
    m2 = [tr.evaluate() for tr in trainers]
    assert t_on._dev_cache["eval"] is not entry
    assert m1[1] == m1[2] and m2[1] == m2[2]
    np.testing.assert_allclose(m1[1] + m2[1], m1[0] + m2[0], rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    assert abs(m1[1][0] - m2[1][0]) > 0  # the new file differs


def _six_decimal_file(path, n, seed):
    """libffm lines over the fixture's fields in a shuffled order, with
    six-decimal values: every resident leaf takes its compact form."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, FIXTURE_FEATS))}"
                f":{int(rng.integers(1, 10**6)) / 10**6:.6f}"
                for c in rng.permutation(FIXTURE_FIELDS)
            ]
            f.write(" ".join(toks) + "\n")
    return str(path)


@pytest.mark.parametrize("online", [False, True])
def test_compact_cache_matches_raw(tmp_path, online):
    """device_cache_compact=on stores split ids, DEC6 values and packed
    fields and decodes after each gather: the raw resident run's bits, the
    streamed run's, and the JAX package's compact run within the bound."""
    path = _six_decimal_file(tmp_path / "t.ffm", 64, seed=21)
    kw = _kw(path, path, online=online, n_epochs=2)
    compact = {"device_cache": "on", "device_cache_compact": "on"}
    jtr, t_c, t_off = _twins(kw, on=compact)
    t_raw = Trainer(TConfig(device="cpu", **kw, device_cache="on", device_cache_compact="off"),
                    state=_init(jtr))
    cache = t_c._ensure_device_cache("train")
    assert cache is not None and cache.compact
    assert [a.dtype for a in cache.ds] == [torch.uint8, torch.uint8, torch.uint8, torch.float32]
    j_hist, h_c, h_off = _train_all(jtr, t_c, t_off)
    h_raw = t_raw.train()
    assert not t_raw._dev_cache["train"].compact
    _same_bits(h_c, h_raw, t_c, t_raw)
    _same_bits(h_c, h_off, t_c, t_off)
    _close_to_jax(h_c, j_hist, t_c, jtr)


def test_compact_cache_row_bytes_and_auto_gate(tmp_path):
    """The compact row estimate is conservative (at least what the build
    stores a row) and below the raw form's; auto stores the raw form where
    it fits (always on the CPU), as the JAX package does."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    jtr, tr, _ = _twins(_kw(train))
    est = _compact_cache_row_bytes(tr.cfg)
    raw = 12 * tr.cfg.max_nnz + 4
    assert est == jtr._compact_cache_row_bytes() and est < raw
    cache = tr._ensure_device_cache("train")
    assert cache is not None and not cache.compact
    assert not jtr._ensure_device_cache("train").compact
    rows = cache.ds[1].shape[0]
    assert sum(t.numel() * t.element_size() // rows for t in cache.ds if t.shape[0]) <= raw
    t_c = Trainer(TConfig(device="cpu", **_kw(train), device_cache="on",
                          device_cache_compact="on"), state=_init(jtr))
    c = t_c._ensure_device_cache("train")
    assert c.compact
    assert sum(t.numel() * t.element_size() // rows for t in c.ds if t.shape[0]) <= est


def _round_trip(n_feats, seed):
    """Encode random resident arrays (non-iota fields, ids up to n_feats,
    six-decimal values) with _compact_cache_arrays, gather a shuffled,
    padded index row from both forms and decode: the encodings and the
    decoded batch, which must equal the raw gather bit for bit."""
    rng = np.random.default_rng(seed)
    n, f = 48, 4
    cfg = TConfig(n_feats=n_feats, n_fields=f, max_nnz=f, device="cpu")
    fields = np.stack([rng.permutation(f) for _ in range(n)]).astype(np.int32)
    feats = rng.integers(0, n_feats, (n, f)).astype(np.int32)
    vals = (rng.integers(0, 1 << 24, (n, f)) / np.float32(1e6)).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    ds_host = (
        np.concatenate([fields, np.zeros((1, f), np.int32)]),
        np.concatenate([feats, np.full((1, f), n_feats, np.int32)]),
        np.concatenate([vals, np.zeros((1, f), np.float32)]),
        np.concatenate([y, np.zeros(1, np.float32)]),
    )
    enc = _compact_cache_arrays(ds_host, cfg)
    ix = torch.from_numpy(np.concatenate([rng.permutation(n), [n] * 16]).astype(np.int32))
    want = take_cached(tuple(torch.from_numpy(a) for a in ds_host), ix, n)
    got = _decode_cached_batch(take_cached(tuple(torch.from_numpy(a) for a in enc), ix, n), cfg)
    for name, a, b in zip(want._fields, got, want):
        # feats_base: None in both (a resident batch carries no id tier)
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b)), name
    return enc


def test_compact_cache_huge_ids_keep_wide_feats():
    """n_feats >= 2^24: the ids stay int32 in the compact form (values and
    fields still compact), and the round trip is exact."""
    enc = _round_trip(17_000_000, seed=23)
    assert [a.dtype for a in enc] == [np.uint8, np.int32, np.uint8, np.float32]


def test_compact_cache_high_id_bitplanes_round_trip():
    """2^22 <= n_feats < 2^24: the ids split into low bytes and 7 high
    bitplanes (the pad sentinel n_feats too), exactly."""
    enc = _round_trip(5_000_000, seed=24)
    assert enc[1].dtype == np.uint8 and enc[1].shape == (49, 2 * 4 + 7)


@pytest.mark.parametrize("online", [False, True])
def test_cached_eval_exact_auc_matches_streamed(tmp_path, online):
    """auc_mode=exact from the resident eval dataset collects the same
    (logits, y, sample_w) rows as the streamed eval: the same loss and AUC
    bits, and the JAX package's within the bound."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "e.ffm", "libffm", seed=1)
    jtr, t_on, t_off = _twins(_kw(train, evalp, online=online, n_epochs=1, auc_mode="exact"))
    for tr in (jtr, t_on, t_off):
        tr.train_epoch(np.random.default_rng(3))
    m = [tr.evaluate() for tr in (jtr, t_on, t_off)]
    assert t_on._dev_cache["eval"] is not None and jtr._dev_cache["eval"] is not None
    assert m[1] == m[2] and np.isfinite(m[1]).all()
    np.testing.assert_allclose(m[1], m[0], rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_dec6_decode_is_correctly_rounded_for_every_key():
    """The port's DEC6 decode equals k / 1e6 computed in float64 and
    rounded to f32 (which is the correctly rounded f32 quotient) for all
    2^24 keys, bit for bit."""
    got = dec6_decode(torch.arange(1 << 24, dtype=torch.int32)).numpy()
    want = (np.arange(1 << 24, dtype=np.float64) / 1e6).astype(np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
