"""steps_per_call > 1 in the port (Config.steps_per_call; ROADMAP.md Queue 1
item 5), on the CPU: twins of tests/test_train.py::
test_steps_per_call_matches_single_step, tests/test_device_cache.py::
test_cached_steps_per_call_grouping and the `--steps_per_call 2` CLI run,
and the port's own checks of the grouping.

On the CPU each group's S steps run eagerly (the card replays a CUDA graph
of them: tests/test_torch_cuda.py), so a grouped run and the S = 1 run
from one state give the same bits: histories equal and tables
torch.equal.  Each grouped run is also held against the JAX Trainer with
the same settings from the same init (carried across by
state_from_jax_arrays), to the chained-step bound of
tests/test_torch_train.py (rtol 2e-3, atol 5e-5)."""

import numpy as np
import pytest
import torch

from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.io.checkpoint import load_checkpoint as j_load_checkpoint
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch.cli import main as torch_main
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint, state_from_jax_arrays
from ftrl_ffm_tpu_torch.models.base import ModelState
from ftrl_ffm_tpu_torch.train import Trainer
from tests.common import FIXTURE_FEATS, FIXTURE_FIELDS, write_fixture
from tests.test_torch_train import _assert_states_close

CHAIN_RTOL, CHAIN_ATOL = 2e-3, 5e-5


def _write_lines(path, n, n_fields=4, n_feats=50, seed=2, frac=False):
    """n libffm lines, one feature a field (tests/test_train.py's
    generator), values 1 or fractional."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))]
            for c in range(n_fields):
                val = round(float(rng.random()) * 2 + 0.05, 3) if frac else 1
                toks.append(f"{c}:{int(rng.integers(0, n_feats))}:{val}")
            f.write(" ".join(toks) + "\n")
    return str(path)


def _init(jtr) -> ModelState:
    return ModelState(*(None if t is None else t.clone()
                        for t in state_from_jax_arrays(jtr.state, "cpu")))


def _same_bits(h1, h2, t1, t2):
    assert h1 == h2
    for name, a, b in zip(ModelState._fields, t1.logical_state, t2.logical_state):
        assert (a is None and b is None) or torch.equal(a, b), name


def _close_to_jax(h, j_hist, t, jtr):
    for key in ("train_loss", "eval_loss", "eval_auc"):
        np.testing.assert_allclose(h[key], j_hist[key], rtol=CHAIN_RTOL, atol=CHAIN_ATOL,
                                   err_msg=key)
    _assert_states_close(t.logical_state, jtr.logical_state)


def _three(kw, s):
    """(JAX Trainer at steps_per_call=s, port Trainers at 1 and s), from
    the JAX init."""
    jtr = JTrainer(JConfig(**kw, steps_per_call=s))
    t1 = Trainer(TConfig(device="cpu", **kw), state=_init(jtr))
    ts = Trainer(TConfig(device="cpu", **kw, steps_per_call=s), state=_init(jtr))
    return jtr, t1, ts


@pytest.mark.parametrize("online", [True, False])
def test_steps_per_call_matches_single_step(tmp_path, online):
    """Groups of 4 over 6 batches (the remainder padded with 2 inert ones),
    streamed online and resident offline: the S = 1 run's bits, and the
    JAX Trainer's S = 4 run within the chained bound."""
    path = _write_lines(tmp_path / "t.ffm", 88)
    kw = dict(train_data=path, eval_data=path, model_type="FFM", n_fields=4, n_feats=50,
              n_factors=2, batch_size=16, n_epochs=1, online=online, shuffle=False)
    jtr, t1, t4 = _three(kw, 4)
    j_hist, h1, h4 = jtr.train(), t1.train(), t4.train()
    # online n_epochs=1 streams (auto); offline takes the resident dataset
    assert (t4._dev_cache.get("train") is None) == online
    _same_bits(h1, h4, t1, t4)
    assert int(t4.state.step) == 6  # inert steps do not count
    _close_to_jax(h4, j_hist, t4, jtr)


@pytest.mark.parametrize("s", [2, 3, 8])
@pytest.mark.parametrize("kw", [
    {"online": False},
    {"online": True},
    {"online": True, "device_cache": "off"},
    {"online": False, "device_cache": "off"},
], ids=["offline-resident", "online-resident", "online-streamed", "offline-streamed"])
def test_grouped_runs_equal_single_step(tmp_path, kw, s):
    """Every path at several S (a group larger than the epoch too):
    shuffled and file-order resident replays, streamed online and
    offline; eval rides along."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "e.ffm", "libffm", seed=1)
    base = dict(train_data=train, eval_data=evalp, model_type="FFM", n_feats=FIXTURE_FEATS,
                n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=2, batch_size=12,
                w_alpha=0.05, device="cpu", **kw)
    t1 = Trainer(TConfig(**base))
    ts = Trainer(TConfig(**base, steps_per_call=s), state=ModelState(
        *(t.clone() for t in t1.state)))
    _same_bits(t1.train(), ts.train(), t1, ts)
    assert int(ts.state.step) == 2 * 6  # 64 rows at B=12


def test_cached_steps_per_call_grouping(tmp_path):
    """spc > 1 drives the resident chunking (tests/test_device_cache.py::
    test_cached_steps_per_call_grouping): the spc=1 resident run's bits,
    and the JAX Trainer's spc=2 run within the chained bound."""
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    kw = dict(train_data=train, model_type="FFM", n_feats=FIXTURE_FEATS,
              n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=3, online=False,
              batch_size=24, w_alpha=0.05, w_l1=0.15, w_l2=1.0, device_cache="on")
    jtr, t1, t2 = _three(kw, 2)
    j_hist, h1, h2 = jtr.train(), t1.train(), t2.train()
    assert t2._dev_cache["train"] is not None
    _same_bits(h1, h2, t1, t2)
    assert int(t1.state.step) == int(t2.state.step) == 9
    np.testing.assert_allclose(h2["train_loss"], j_hist["train_loss"], rtol=CHAIN_RTOL,
                               atol=CHAIN_ATOL)
    _assert_states_close(t2.logical_state, jtr.logical_state)


@pytest.mark.parametrize("model_type,kw", [
    ("LR", {}),
    ("FM", {}),
    ("FM", {"update_mode": "inplace"}),
    ("FFM", {"update_mode": "inplace"}),
], ids=["lr", "fm", "fm-inplace", "ffm-inplace"])
def test_grouped_lr_fm_inplace_match_jax(tmp_path, model_type, kw):
    """LR, FM and the in-place form (FFM's with the stale linear tables)
    at S = 4: the S = 1 run's bits and the JAX Trainer's S = 4 run within
    the chained bound."""
    ftype = "libffm" if model_type == "FFM" else "libsvm"
    train = write_fixture(tmp_path / "t.txt", ftype, seed=0)
    evalp = write_fixture(tmp_path / "e.txt", ftype, seed=1)
    base = dict(train_data=train, eval_data=evalp, model_type=model_type,
                n_feats=FIXTURE_FEATS, n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=2,
                online=True, batch_size=12, w_alpha=0.05, **kw)
    jtr, t1, t4 = _three(base, 4)
    j_hist, h1, h4 = jtr.train(), t1.train(), t4.train()
    _same_bits(h1, h4, t1, t4)
    for key in ("train_loss", "eval_loss", "eval_auc"):
        np.testing.assert_allclose(h4[key], j_hist[key], rtol=CHAIN_RTOL, atol=CHAIN_ATOL,
                                   err_msg=key)
    names = [n for n, t in zip(ModelState._fields, t4.logical_state)
             if t is not None and n not in ("bias_n", "step")]
    for name in names:
        np.testing.assert_allclose(getattr(t4.logical_state, name).numpy(),
                                   np.asarray(getattr(jtr.logical_state, name)),
                                   rtol=CHAIN_RTOL, atol=CHAIN_ATOL, err_msg=name)


def _seven_field_kw(tmp_path, model_type, update_mode):
    """A 7-field file (FFM: field_pad 8 at K=16, so the linear tables ride
    in dead lane 7, stale under "inplace")."""
    path = _write_lines(tmp_path / "t.ffm", 60, n_fields=7, n_feats=60, seed=5, frac=True)
    return dict(train_data=path, model_type=model_type, n_fields=7, n_feats=60, n_factors=16,
                batch_size=16, n_epochs=1, online=True, device="cpu", update_mode=update_mode,
                w_alpha=0.05, device_cache="on")


@pytest.mark.parametrize("update_mode", ["auto", "inplace"], ids=["dense2", "inplace"])
@pytest.mark.parametrize("model_type", ["LR", "FM", "FFM"])
def test_inert_group_changes_no_state_bit(tmp_path, model_type, update_mode):
    """A group of inert steps (streamed: _inert_batch stacked; resident:
    index rows at the pad row) after an epoch of training: every state
    tensor bit-identical (the stale linear tables too), the step count
    unchanged, zero loss and count."""
    tr = Trainer(TConfig(**_seven_field_kw(tmp_path, model_type, update_mode),
                         steps_per_call=3))
    if model_type == "FFM":
        assert tr.model._lin_lane() == 7
    tr.train_epoch()
    before = ModelState(*(None if t is None else t.clone() for t in tr.state))
    stacked = tuple(torch.from_numpy(np.stack([a] * 3)) for a in tr._inert_batch())
    (sums,) = tr._multi_train_impl(*stacked)
    cache = tr._dev_cache["train"]
    pad_rows = torch.full((3, tr.cfg.batch_size), cache.n, dtype=torch.int32)
    (gsums,) = tr._gather_train_impl(cache, pad_rows)
    assert torch.equal(sums, torch.zeros(3, 2)) and torch.equal(gsums, torch.zeros(3, 2))
    for name, a, b in zip(ModelState._fields, tr.state, before):
        assert (a is None and b is None) or torch.equal(a, b), name
    assert int(tr.state.step) == 4  # 60 rows at B=16


def test_save_every_fires_at_the_group_end(tmp_path):
    """save_every=3 with S=2 over 4 steps: no multiple of 3 ends a group,
    so the save comes at the end of the group that crossed it, step 4, as
    JAX's maybe_save(step_now, step_prev) gives (S = 1 saves at 3)."""
    path = _write_lines(tmp_path / "t.ffm", 64, n_fields=4, n_feats=50, seed=1)
    kw = dict(train_data=path, model_type="FFM", n_fields=4, n_feats=50, n_factors=2,
              batch_size=16, n_epochs=1, save_every=3, async_checkpoint=False)
    steps = {}
    for name, pkg_cfg, pkg_trainer, load in (
        ("jax", JConfig, JTrainer, j_load_checkpoint),
        ("port", lambda **k: TConfig(device="cpu", **k), Trainer, load_checkpoint),
    ):
        for s, dc in ((2, "off"), (2, "on"), (1, "off")):
            ckpt = str(tmp_path / f"{name}-{s}-{dc}.ckpt")
            pkg_trainer(pkg_cfg(**kw, steps_per_call=s, device_cache=dc,
                                model_path=ckpt)).train_epoch()
            steps[name, s, dc] = load(ckpt)[1]["mid_training_step"]
    assert steps["jax", 2, "off"] == steps["port", 2, "off"] == 4
    assert steps["jax", 2, "on"] == steps["port", 2, "on"] == 4
    assert steps["jax", 1, "off"] == steps["port", 1, "off"] == 3


def test_group_key_follows_the_state_tensors(tmp_path):
    """The graph-cache key (Trainer._group_key) names the state's tensors:
    training in place keeps it, a swapped tensor changes it: a reference
    import (init_from_weights), the in-place form's linear-table reconcile
    (logical_state), an assigned state."""
    tr = Trainer(TConfig(**_seven_field_kw(tmp_path, "FFM", "inplace"), steps_per_call=2))
    inputs = (torch.zeros((2, 16), dtype=torch.int32),)
    key0 = tr._group_key(("gather",), inputs)
    tr.train_epoch()
    assert tr._group_key(("gather",), inputs) == key0
    assert tr._group_key(("multi",), inputs) != key0
    assert tr._group_key(("gather",), (torch.zeros((2, 8), dtype=torch.int32),)) != key0
    _ = tr.logical_state  # the stale linear tables replaced by new tensors
    key1 = tr._group_key(("gather",), inputs)
    assert key1 != key0
    tr.state = tr.model.init_from_weights(*tr.model.materialize_weights(tr.logical_state),
                                          device="cpu")
    assert tr._group_key(("gather",), inputs) not in (key0, key1)


def test_cli_steps_per_call(tmp_path, capsys):
    """`--steps_per_call 2` trains and evaluates through the port's CLI
    (tests/test_train.py's CLI run, without --use_pallas off, which the
    port refuses) and prints the S = 1 run's epoch lines."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "eval.ffm", "libffm", seed=1)
    argv = ["--train_data", str(train), "--eval_data", str(evalp), "--model_type", "FFM",
            "--n_fields", str(FIXTURE_FIELDS), "--n_feats", str(FIXTURE_FEATS),
            "--n_factors", "4", "--batch_size", "16", "--update_mode", "sparse",
            "--table_dtype", "float32", "--compact_transfer", "false", "--device", "cpu"]
    lines = []
    for extra in ([], ["--steps_per_call", "2"]):
        assert torch_main(argv + extra) == 0
        out = capsys.readouterr().out
        assert "epoch 1 train time" in out
        lines.append([ln.split("s, ", 1)[1] for ln in out.splitlines() if ln.startswith("epoch")])
    assert lines[0] == lines[1] and len(lines[0]) == 2
