"""The port's LR and FM models (models/lr.py, models/fm.py) against the JAX
package's on the CPU, from one carried initial state.

Tolerances: the FM interaction rtol=1e-5, atol=1e-6 (f32 sums in another
order); chained train steps and Trainer states rtol=2e-3, atol=5e-5 on the
tables (the suite's chained-step bound, tests/test_torch_train.py: ulp
noise passes through the closed form's |z| <= l1 threshold), a bf16 w
within rtol 2^-7 (one bf16 ulp); step losses and logits rtol=1e-5;
Trainer histories within 1e-4 (f32 sums in another order, closed in
float64), and a resident run bit for bit its streamed twin; CLI epoch
numbers within 1.01e-4 (a flip of the last printed digit) and predictions
within 2e-5; the B=1 oracle trajectory at tests/test_models.py's bounds."""

import io
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ftrl_ffm_tpu import ftrl as jftrl
from ftrl_ffm_tpu.cli import main as jax_main
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.io.checkpoint import model_signature as j_signature
from ftrl_ffm_tpu.io.checkpoint import save_checkpoint as j_save
from ftrl_ffm_tpu.models import Batch as JBatch
from ftrl_ffm_tpu.models import make_model as j_make_model
from ftrl_ffm_tpu.ops.interactions import fm_logits_and_grads as j_fm
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch import ftrl as tftrl
from ftrl_ffm_tpu_torch.cli import main as torch_main
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import (
    IncompatibleStateError,
    load_checkpoint,
    state_from_jax_arrays,
    validate_header_compat,
)
from ftrl_ffm_tpu_torch.models import FM, LR, ModelState
from ftrl_ffm_tpu_torch.models import make_model as t_make_model
from ftrl_ffm_tpu_torch.models.base import Batch as TBatch
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update_linear, ftrl_update_plain
from ftrl_ffm_tpu_torch.ops.interactions import fm_logits_and_grads
from ftrl_ffm_tpu_torch.train import Trainer, estimate_hbm_bytes
from tests.common import FIXTURE_FEATS, FIXTURE_FIELDS, write_fixture
from tests.reference_oracle import Oracle

CHAIN_RTOL, CHAIN_ATOL = 2e-3, 5e-5
BF16_RTOL = 2.0 ** -7
HP = dict(w_alpha=0.05, w_l1=0.15, w_l2=1.0)
# 60 ids, 7 fields, K=16 (FM's row: 16 slots, no dead lane), B=16, F=6
SHAPE = dict(n_feats=60, n_fields=7, n_factors=16, batch_size=16, **HP)
TABLES = ("bias_z", "lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w")


def _batch(rng, b=16, f=6, c=7, r=60):
    """Random occurrences with a padding column and a padded last sample."""
    fields = rng.integers(0, c, (b, f)).astype(np.int32)
    feats = rng.integers(0, r, (b, f)).astype(np.int32)
    vals = (rng.random((b, f)) + 0.05).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    fields[:, -1], feats[:, -1], vals[:, -1] = 0, r, 0.0
    fields[-1], feats[-1], vals[-1], y[-1], sw[-1] = 0, r, 0.0, 0.0, 0.0
    return fields, feats, vals, y, sw


def _assert_states_close(t_state, j_state, rtol=CHAIN_RTOL, atol=CHAIN_ATOL):
    """Every table within the chained bound (a bf16 w within one bf16 ulp);
    LR's absent factor tables absent on both sides."""
    for name in TABLES:
        got, want = getattr(t_state, name), getattr(j_state, name)
        if want is None:
            assert got is None, name
            continue
        bf16 = got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want).astype(np.float32),
            rtol=BF16_RTOL if bf16 else rtol, atol=atol, err_msg=name,
        )
    assert int(t_state.step) == int(j_state.step)


def _clone(state):
    return ModelState(*(None if t is None else t.clone() for t in state))


# ---- the FM interaction ----


@pytest.mark.parametrize("b,f,k", [(16, 6, 16), (5, 39, 4), (1, 1, 3)])
def test_fm_logits_and_grads_matches_jax(b, f, k):
    rng = np.random.default_rng(b + f + k)
    v = (rng.normal(size=(b, f, k)) * 0.1).astype(np.float32)
    vals = rng.random((b, f)).astype(np.float32)
    vals[:, -1:] = 0.0  # a padding occurrence: inert
    lin = (rng.normal(size=b) * 0.1).astype(np.float32)
    ref_logits, ref_dv = j_fm(jnp.asarray(v), jnp.asarray(vals), jnp.asarray(lin))
    args = [torch.from_numpy(a) for a in (v, vals, lin)]
    logits, dv = fm_logits_and_grads(*args)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dv.numpy(), np.asarray(ref_dv), rtol=1e-5, atol=1e-6)
    assert (dv[:, -1] == 0).all()
    alone, none = fm_logits_and_grads(*args, compute_grads=False)
    assert none is None and torch.equal(alone, logits)


# ---- the train step ----


@pytest.mark.parametrize(
    "model_type,kw",
    [
        ("LR", {"update_mode": "dense"}),
        ("LR", {"update_mode": "sparse"}),
        # LR's tables reach no in-place form: "inplace" gives "dense2"
        ("LR", {"update_mode": "inplace"}),
        ("FM", {"update_mode": "dense"}),
        ("FM", {"update_mode": "sparse"}),
        ("FM", {"update_mode": "inplace"}),
        # n_feats=100k at B=16: the in-place form at JAX auto's shape (the
        # port's auto takes "dense2" there: ftrl.py::update_form)
        ("FM", {"n_feats": 100_000, "update_mode": "inplace"}),
        ("FM", {"update_mode": "dense", "table_dtype": "bfloat16"}),
        ("FM", {"update_mode": "sparse", "table_dtype": "bfloat16"}),
        ("FM", {"update_mode": "inplace", "table_dtype": "bfloat16"}),
        # JAX's FM payload stays f32 under acc_dtype=bfloat16 (its XLA
        # producer emits no combined layout); so does the port's
        ("FM", {"update_mode": "dense", "acc_dtype": "bfloat16"}),
        ("FM", {"update_mode": "dense", "acc_dtype": "bfloat16", "table_dtype": "bfloat16"}),
    ],
)
def test_train_step_matches_jax(model_type, kw):
    """3 chained steps from one JAX-made init, against the JAX model's
    train step under the same update kind."""
    cfg = dict(SHAPE, model_type=model_type, max_nnz=6, **kw)
    jm = j_make_model(JConfig(**cfg))
    tm = t_make_model(TConfig(device="cpu", **cfg))
    assert isinstance(tm, LR if model_type == "LR" else FM)
    j_state = jm.init()
    t_state = state_from_jax_arrays(j_state, "cpu")
    if model_type == "LR":
        assert t_state.vec_n is None and t_state.vec_w is None
    rng = np.random.default_rng(7)
    for _ in range(3):
        arrays = _batch(rng)
        j_out = jm.train_step(j_state, JBatch(*(jnp.asarray(a) for a in arrays)))
        t_out = tm.train_step(t_state, TBatch(*(torch.from_numpy(a) for a in arrays)))
        assert t_out.state is t_state  # updated in place
        j_state = j_out.state
        np.testing.assert_allclose(t_out.logits.numpy(), np.asarray(j_out.logits),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(t_out.loss_sum), float(j_out.loss_sum), rtol=1e-5)
        assert float(t_out.count) == float(j_out.count) == 15
    _assert_states_close(t_state, j_state)


@pytest.mark.parametrize("kw", [{}, {"table_dtype": "bfloat16"}])
def test_inplace_step_on_hot_ids_matches_jax(kw):
    """FM's in-place step (the scatter, the pass, then the linear tables'
    own update, from one sort of the ids on the card) on batches where one
    id takes most occurrences: a segment of more than 64 payload rows, the
    column-split kernels' case on the card.  3 chained steps from one
    JAX-made init against JAX's train step, at the chained bound (a bf16 w
    within one bf16 ulp)."""
    b = 32
    cfg = dict(SHAPE, model_type="FM", max_nnz=6, batch_size=b, update_mode="inplace", **kw)
    jm = j_make_model(JConfig(**cfg))
    tm = t_make_model(TConfig(device="cpu", **cfg))
    j_state = jm.init()
    t_state = state_from_jax_arrays(j_state, "cpu")
    rng = np.random.default_rng(21)
    for _ in range(3):
        arrays = _batch(rng, b=b)
        feats = arrays[1]
        feats[:-1, :-1] = np.where(rng.random((b - 1, 5)) < 0.6, 11, feats[:-1, :-1])
        assert int((feats == 11).sum()) > 64
        j_out = jm.train_step(j_state, JBatch(*(jnp.asarray(a) for a in arrays)))
        t_out = tm.train_step(t_state, TBatch(*(torch.from_numpy(a) for a in arrays)))
        j_state = j_out.state
        np.testing.assert_allclose(t_out.logits.numpy(), np.asarray(j_out.logits),
                                   rtol=1e-5, atol=1e-6)
    _assert_states_close(t_state, j_state)


@pytest.mark.parametrize("model_type,want", [("FM", torch.float32), ("FFM", torch.bfloat16)])
def test_fm_payload_stays_f32_under_bf16_acc(monkeypatch, model_type, want):
    """acc_dtype=bfloat16 narrows the "dense2" payload only where the
    gradient producer emits the combined layout itself (FFM's kernel #2):
    FM's payload reaches the update in f32, as the JAX package's does."""
    import ftrl_ffm_tpu_torch.models.base as mbase

    seen = []
    real = mbase.ftrl_update

    def spy(*args, **kw):
        seen.append(args[7].dtype)  # the combined payload gg2
        return real(*args, **kw)

    monkeypatch.setattr(mbase, "ftrl_update", spy)
    cfg = TConfig(device="cpu", model_type=model_type, max_nnz=6, update_mode="dense",
                  acc_dtype="bfloat16", **SHAPE)
    model = t_make_model(cfg)
    arrays = _batch(np.random.default_rng(0))
    model.train_step(model.init(), TBatch(*(torch.from_numpy(a) for a in arrays)))
    assert seen == [want]


@pytest.mark.parametrize("model_type", ["LR", "FM"])
@pytest.mark.parametrize("semantics", ["keep_init", "reference"])
def test_b1_trajectory_matches_oracle(model_type, semantics):
    """Twin of tests/test_models.py::test_b1_trajectory_matches_oracle for
    LR and FM: 4 fields, K=3, batch size 1, from the port's own init
    (FM's table in the in-place form, which JAX's auto takes at B=1;
    LR's tables have none, so "inplace" gives them "dense2")."""
    n_feats, n_fields, k = 50, 4, 3
    cfg = TConfig(model_type=model_type, n_feats=n_feats, n_fields=n_fields, n_factors=k,
                  factor_semantics=semantics, batch_size=1, update_mode="inplace",
                  device="cpu")
    model = t_make_model(cfg)
    state = model.init()
    vec_init = None
    if model_type == "FM" and semantics == "keep_init":
        vec_init = state.vec_w.numpy().copy()
    oracle = Oracle(model_type, n_feats, n_fields, k if model_type == "FM" else 0,
                    vec_init=vec_init)
    rng = np.random.default_rng(7)
    for t in range(30):
        ids = rng.choice(n_feats, size=4, replace=False)
        fl = rng.integers(0, n_fields, size=4)
        vl = rng.random(4).astype(np.float32) + 0.1
        y = int(rng.random() < 0.5)
        fields = np.zeros((1, 6), np.int32)
        feats = np.full((1, 6), n_feats, np.int32)
        vals = np.zeros((1, 6), np.float32)
        fields[0, :4], feats[0, :4], vals[0, :4] = fl, ids, vl
        batch = TBatch(*(torch.from_numpy(a) for a in (
            fields, feats, vals, np.array([y], np.float32), np.ones(1, np.float32))))
        out = model.train_step(state, batch)
        ref_logit = oracle.train(fl, ids, vl, y)
        assert float(out.logits[0]) == pytest.approx(ref_logit, rel=2e-3, abs=2e-4), t
    np.testing.assert_allclose(state.lin_z.numpy(), oracle.lin_z, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(state.lin_n.numpy(), oracle.lin_n, rtol=2e-3, atol=2e-5)
    if model_type == "FM":
        np.testing.assert_allclose(state.vec_z.numpy(), oracle.vec_z, rtol=2e-2, atol=2e-4)
    else:
        assert state.vec_z is None


def test_model_init_lr_has_no_factor_tables():
    lr = t_make_model(TConfig(device="cpu", model_type="LR", **SHAPE)).init()
    assert lr.vec_n is None and lr.vec_z is None and lr.vec_w is None
    assert lr.lin_w.shape == (60,) and (lr.lin_w == 0).all()
    fm = t_make_model(TConfig(device="cpu", model_type="FM", table_dtype="bfloat16",
                              **SHAPE)).init()
    assert fm.vec_w.shape == (60, 16) and fm.vec_w.dtype == torch.bfloat16
    assert fm.vec_n.dtype == torch.float32 and (fm.vec_w != 0).all()


def test_training_sparsifies_lr_weights():
    """Twin of tests/test_models.py::test_training_sparsifies_weights: L1
    leaves exact zeros among the touched linear weights of an LR state, and
    has_zero_weights says so, as JAX's does on the same state; an LR state
    has no factor tables, so none of them is zero."""
    cfg = dict(model_type="LR", n_feats=50, n_fields=4, n_factors=3, batch_size=8, max_nnz=6)
    jm = j_make_model(JConfig(**cfg))
    tm = t_make_model(TConfig(device="cpu", **cfg))
    j_state = jm.init()
    t_state = state_from_jax_arrays(j_state, "cpu")
    rng = np.random.default_rng(13)
    for _ in range(10):
        arrays = _batch(rng, b=8, f=6, c=4, r=50)
        j_state = jm.train_step(j_state, JBatch(*(jnp.asarray(a) for a in arrays))).state
        tm.train_step(t_state, TBatch(*(torch.from_numpy(a) for a in arrays)))
    assert bool(((t_state.lin_n > tftrl.UNTOUCHED_N) & (t_state.lin_w == 0)).any())
    for table, want in (("linear", True), ("any", True), ("factor", False)):
        assert tm.has_zero_weights(t_state, table) is want
        assert jm.has_zero_weights(j_state, table) is want


# ---- the linear update's kinds ----


def test_linear_update_sparse_matches_jax():
    """ftrl_update_linear's one step is JAX's sparse_ftrl_update2 on the
    1-D linear tables (its lin_kind "sparse2") as well as its dense step:
    on a 1-D table JAX's dense and sparse steps give the same bits, and the
    port's step is within rtol=1e-6, atol=1e-7 of them (duplicate ids summed
    in another order; the CPU's torch.sqrt is not correctly rounded).
    ftrl_update_plain's "sparse2" kind gives the linear tables the sparse
    step, within the same bound of ftrl_update_linear's."""
    rng = np.random.default_rng(3)
    r, n = 4000, 3000
    p = tftrl.FtrlParams(alpha=0.05, l1=0.15, l2=1.0)
    n_tab = np.where(rng.random(r) < 0.6, rng.random(r) * 3, 0.0).astype(np.float32)
    z_tab = rng.normal(size=r).astype(np.float32)
    w_tab = np.asarray(jftrl.ftrl_weights(jnp.asarray(n_tab), jnp.asarray(z_tab),
                                          jftrl.FtrlParams(*p)))
    ids = rng.integers(0, r, n).astype(np.int32)
    ids[::50] = r  # the padding sentinel drops
    g = (rng.normal(size=n) * 0.2).astype(np.float32)
    gg2 = np.stack([g, g * g], -1)
    ref = jftrl.sparse_ftrl_update2(*(jnp.asarray(a) for a in (n_tab, z_tab, w_tab, ids, gg2)),
                                    jftrl.FtrlParams(*p))
    ref_dense = jftrl.dense_ftrl_update2(
        *(jnp.asarray(a) for a in (n_tab, z_tab, w_tab, ids, gg2)), jftrl.FtrlParams(*p))
    for a, b in zip(ref, ref_dense):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tables = [t(n_tab), t(z_tab), t(w_tab)]
    ftrl_update_linear(*tables, t(ids), t(gg2), p)
    for got, want in zip(tables, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # ftrl_update_plain's sparse kind: the sparse step from gg2_lin
    vec = [torch.zeros((r, 2)) for _ in range(3)]
    gg2_vec = torch.zeros((n, 4))
    _, lin = ftrl_update_plain(*vec, t(n_tab), t(z_tab), t(w_tab), t(ids), gg2_vec, -1, p,
                               t(gg2), sparse=True)
    for a, b in zip(lin, tables):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_estimate_hbm_bytes_lr_holds_linear_tables_only():
    """LR's state is its three linear tables (the JAX estimate counts a
    one-wide factor table too); FM's is the [R, K] factor tables beside
    them, as the JAX package's."""
    from ftrl_ffm_tpu.train import estimate_hbm_bytes as j_estimate

    kw = dict(n_fields=39, n_factors=16, max_nnz=39, batch_size=8192, n_feats=100_000)
    nnz = 8192 * 39
    lr = estimate_hbm_bytes(TConfig(model_type="LR", **kw))
    assert lr["state"] == 3 * 100_000 * 4
    assert lr["work"] == 3 * nnz * 4
    assert lr["state"] < j_estimate(JConfig(model_type="LR", **kw))["state"]
    fm = estimate_hbm_bytes(TConfig(model_type="FM", **kw))
    assert fm["state"] == j_estimate(JConfig(model_type="FM", **kw))["state"]
    assert fm["state"] == 100_000 * 16 * 12 + 3 * 100_000 * 4


# ---- the Trainer, the CLI and checkpoints ----


@pytest.mark.parametrize("online", [True, False], ids=["online", "offline"])
@pytest.mark.parametrize("ftype", ["libsvm", "libffm"])
@pytest.mark.parametrize("model_type", ["LR", "FM"])
def test_trainer_train_matches_jax(tmp_path, model_type, ftype, online):
    """Twin of tests/test_device_cache.py::test_cached_matches_streamed_
    exactly for LR and FM: the JAX Trainer with device_cache=on, and the
    port's with device_cache on and off, from the JAX init, 3 epochs with
    eval.  The port's resident and streamed runs give the same bits; both
    follow the JAX Trainer."""
    train = write_fixture(tmp_path / f"t.{ftype}", ftype, seed=0)
    evalp = write_fixture(tmp_path / f"e.{ftype}", ftype, seed=1)
    kw = dict(train_data=train, eval_data=evalp, model_type=model_type,
              n_feats=FIXTURE_FEATS, n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=3,
              online=online, batch_size=24, **HP)
    jtr = JTrainer(JConfig(**kw, device_cache="on"))
    init = state_from_jax_arrays(jtr.state, "cpu")
    t_on = Trainer(TConfig(device="cpu", **kw, device_cache="on"), state=_clone(init))
    t_off = Trainer(TConfig(device="cpu", **kw, device_cache="off"), state=_clone(init))
    h_on, h_off, j_hist = t_on.train(), t_off.train(), jtr.train()
    assert t_on._dev_cache["train"] is not None and t_on._dev_cache["eval"] is not None
    assert "train" not in t_off._dev_cache
    # the iota fields marker stands for a libffm file's fields (0..F-1) for
    # any model; a libsvm file's (all 0) are stored
    assert t_on._dev_cache["train"].ds[0].shape[0] == (0 if ftype == "libffm" else 64 + 1)
    assert h_on == h_off
    for name, a, b in zip(ModelState._fields, t_on.state, t_off.state):
        assert (a is None and b is None) or torch.equal(a, b), name
    for key in ("train_loss", "eval_loss", "eval_auc"):
        np.testing.assert_allclose(h_on[key], j_hist[key], rtol=0, atol=1e-4, err_msg=key)
    _assert_states_close(t_on.state, jtr.state)


def _epoch_numbers(out: str):
    """The loss and AUC numbers of the epoch lines (times dropped), and the
    lines' count."""
    lines = [l for l in out.splitlines() if l.startswith("epoch")]
    return [float(x) for x in re.findall(r"(?:loss|auc): ([0-9.]+)", "\n".join(lines))], len(lines)


@pytest.mark.parametrize("model_type", ["LR", "FM"])
def test_cli_trains_and_predicts_like_jax(tmp_path, model_type):
    """The JAX CLI trains one epoch on a libsvm file and saves; both CLIs
    resume from that checkpoint, train 2 epochs with eval and score the
    eval file: the same epoch lines, predictions within 2e-5."""
    train = write_fixture(tmp_path / "t.svm", "libsvm", seed=0)
    evald = write_fixture(tmp_path / "e.svm", "libsvm", seed=1)
    flags = ["--model_type", model_type, "--n_feats", str(FIXTURE_FEATS), "--n_fields",
             str(FIXTURE_FIELDS), "--n_factors", "4", "--batch_size", "16",
             "--w_alpha", "0.05", "--w_l1", "0.15", "--w_l2", "1.0"]
    ckpt = str(tmp_path / "m.ckpt")
    assert jax_main(["--train_data", train, "--model_path", ckpt, *flags]) == 0
    outs = {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        buf = io.StringIO()
        old, sys.stdout = sys.stdout, buf
        try:
            rc = main([
                "--load_model", ckpt, "--train_data", train, "--eval_data", evald,
                "--n_epochs", "2", "--predict_data", evald,
                "--predict_output", str(tmp_path / f"{name}.txt"), *flags, *extra,
            ])
        finally:
            sys.stdout = old
        assert rc == 0
        outs[name] = buf.getvalue()
    (got, n_got), (ref, n_ref) = _epoch_numbers(outs["torch"]), _epoch_numbers(outs["jax"])
    assert n_got == n_ref == 4 and len(got) == len(ref) == 6
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.01e-4)
    p_got, p_ref = np.loadtxt(tmp_path / "torch.txt"), np.loadtxt(tmp_path / "jax.txt")
    assert p_got.shape == p_ref.shape == (64,)
    np.testing.assert_allclose(p_got, p_ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("model_type", ["LR", "FM"])
def test_jax_checkpoint_loads(tmp_path, model_type):
    """A JAX LR checkpoint (no factor tables) and an FM one load on the CPU:
    every table as saved, LR's factor tables None; the header check covers
    model_type; the Trainer serves the loaded state."""
    cfg = dict(model_type=model_type, n_feats=50, n_fields=4, n_factors=8)
    jcfg = JConfig(**cfg)
    state = j_make_model(jcfg).init()
    rng = np.random.default_rng(0)
    state = state._replace(
        **{name: jnp.asarray(rng.random(np.shape(a)).astype(np.float32))
           for name, a in state._asdict().items() if name != "step" and a is not None},
        step=jnp.asarray(5, jnp.int32),
    )
    path = str(tmp_path / "m.ckpt")
    j_save(path, state, extra={"model_config": j_signature(jcfg)})
    loaded, extra = load_checkpoint(path)
    for name, a in state._asdict().items():
        if a is None:
            assert getattr(loaded, name) is None
        else:
            np.testing.assert_array_equal(getattr(loaded, name), np.asarray(a))
    validate_header_compat(TConfig(device="cpu", **cfg), extra, path)
    other = "FM" if model_type == "LR" else "LR"
    with pytest.raises(IncompatibleStateError, match="model_type"):
        validate_header_compat(TConfig(device="cpu", **{**cfg, "model_type": other}),
                               extra, path)
    placed = state_from_jax_arrays(loaded, "cpu")
    assert (placed.vec_w is None) == (model_type == "LR")
    evald = write_fixture(tmp_path / "e.svm", "libsvm", seed=1)
    tr = Trainer(TConfig(device="cpu", eval_data=evald, **cfg), state=placed)
    loss, auc = tr.evaluate()
    assert np.isfinite(loss) and 0.0 <= auc <= 1.0
    with pytest.raises(IncompatibleStateError, match="factor tables"):
        Trainer(TConfig(device="cpu", eval_data=evald, **{**cfg, "model_type": other}),
                state=placed)
