"""bfloat16 tables and payloads: the port (ftrl_ffm_tpu_torch, the plain
PyTorch versions on the CPU) against the JAX package on the same numpy
inputs, from one JAX-made state carried across with state_from_jax_arrays.
JAX runs its Pallas kernels in interpret mode; its bf16 payload is emitted
only by the fused kernel (use_pallas="on"), its XLA path splits.

Tolerances:
- the bf16 accumulator (ftrl.py::_row_sums on a bf16 payload) equals JAX's
  bf16 scatter-add bit for bit: both round after every add, in ascending
  payload order;
- bf16 values (payload, w) within one bf16 ulp of the larger of the two
  (an f32 value one ulp off rounds to the neighbouring bf16 near a
  rounding boundary), plus the f32 bound's atol near 0;
- logits rtol=1e-5, atol=1e-6; single updates and the pass rtol=1e-6,
  atol=1e-7 (tests/test_torch_ftrl.py); chained train steps rtol=2e-3,
  atol=5e-5 (tests/test_torch_train.py) on n, z, lin and bias, and vec_w
  rtol=2^-7 (one bf16 ulp), atol=5e-5."""

import functools
import io
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ftrl_ffm_tpu.ops.ffm_pallas as fp
from ftrl_ffm_tpu import ftrl as jftrl
from ftrl_ffm_tpu.cli import main as jax_main
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.io.checkpoint import load_checkpoint as j_load
from ftrl_ffm_tpu.models import Batch as JBatch
from ftrl_ffm_tpu.models import make_model as j_make_model
from ftrl_ffm_tpu.ops.ftrl_pallas import closed_form_pass_pallas
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch import ftrl as tftrl
from ftrl_ffm_tpu_torch.cli import main as torch_main
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint, state_from_jax_arrays
from ftrl_ffm_tpu_torch.models import make_model as t_make_model
from ftrl_ffm_tpu_torch.models.base import Batch as TBatch
from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits_grads
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import closed_form_pass, ftrl_update
from ftrl_ffm_tpu_torch.train import Trainer
from tests.test_torch_ftrl import P, _ids, _tables
from tests.test_torch_models import write_7field
from tests.test_torch_serve import MODEL_FLAGS, SHAPE
from tests.test_torch_train import EIGHT, SEVEN, _batch

RTOL, ATOL = 1e-6, 1e-7
L_RTOL, L_ATOL = 1e-5, 1e-6
G_ATOL = 1e-6  # the f32 payload's atol (tests/test_torch_fused_kernel.py)
CHAIN_RTOL, CHAIN_ATOL = 2e-3, 5e-5
BF16_RTOL = 2.0 ** -7  # one bf16 ulp, relative


def _bf16(a) -> np.ndarray:
    """A JAX or numpy bf16 array, or a torch bf16 tensor, as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _bits(a) -> np.ndarray:
    """The raw 16 bits of a bf16 array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _assert_within_bf16_ulp(got, want, atol=0.0, err_msg=""):
    """|got - want| at most one bf16 ulp of the larger magnitude, plus atol."""
    a, b = _bf16(got), _bf16(want)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.where(mag > 0, np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7), 0.0)
    bad = np.abs(a - b) > ulp + atol
    assert not bad.any(), f"{err_msg}: {int(bad.sum())} of {bad.size} off by more than one ulp"


def _to_bf16_torch(a: np.ndarray) -> torch.Tensor:
    """A bf16 tensor with the bits of JAX's rounding of f32 `a`."""
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(np.int16).copy()).view(
        torch.bfloat16
    )


@pytest.fixture
def interpret(monkeypatch):
    """JAX's fused Pallas kernels in interpret mode (its CPU tests' way)."""
    for fn_name in ("ffm_fused_logits_grads", "ffm_fused_logits"):
        monkeypatch.setattr(fp, fn_name, functools.partial(getattr(fp, fn_name), interpret=True))


# ---- 1. the state crosses bit for bit ----


def test_state_from_jax_arrays_carries_bf16_bit_for_bit(tmp_path):
    """A table_dtype=bfloat16 state, from a JAX init and from a checkpoint
    the JAX CLI wrote, arrives as a bf16 vec_w with the same bits; the
    other tables stay f32."""
    path = write_7field(tmp_path / "t.ffm", n=40, seed=3)
    ckpt = str(tmp_path / "m.ckpt")
    assert jax_main(["--train_data", path, "--n_epochs", "1", "--model_path", ckpt,
                     "--table_dtype", "bfloat16", *MODEL_FLAGS]) == 0
    jinit = j_make_model(JConfig(table_dtype="bfloat16", **SHAPE)).init()
    host, _ = load_checkpoint(ckpt)
    for src in (jinit, host):
        got = state_from_jax_arrays(src, "cpu")
        assert got.vec_w.dtype == torch.bfloat16 and got.vec_w.is_contiguous()
        np.testing.assert_array_equal(_bits(got.vec_w), _bits(src.vec_w))
        for name in ("vec_n", "vec_z", "lin_w", "bias_z"):
            assert getattr(got, name).dtype == torch.float32
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(src, name)))


# ---- 2. the bf16 accumulator ----


@pytest.mark.parametrize("r,n,d,seed", [(50, 4000, 64, 0), (7, 300, 3, 1), (1000, 60, 16, 2),
                                        (1, 500, 2, 3)])
def test_row_sums_bf16_matches_jax_scatter_bit_for_bit(r, n, d, seed):
    """ftrl.py::_row_sums on a bf16 payload equals JAX's
    zeros(bf16).at[ids].add(gg2, mode="drop") bit for bit, with duplicate
    and sentinel ids: both round after every add, in payload order (the
    f32 sum rounded once, index_add_'s result, differs on most rows)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, r, n).astype(np.int32)
    ids[rng.random(n) < 0.05] = r
    g = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    want = jnp.zeros((r, d), jnp.bfloat16).at[jnp.asarray(ids)].add(gb, mode="drop")
    got = tftrl._row_sums(r, torch.from_numpy(ids), _to_bf16_torch(g))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    once = torch.zeros((r + 1, d)).index_add_(0, torch.from_numpy(ids).long(),
                                              _to_bf16_torch(g).float())[:r].to(torch.bfloat16)
    if n > 4 * r:  # many duplicates: rounding once gives other bits
        assert not torch.equal(once.view(torch.int16), got.view(torch.int16))


# ---- 3. kernel #2's bf16 store ----


@pytest.mark.parametrize("b,f,c,k,aug", [(24, 3, 7, 16, 6), (16, 10, 40, 16, 39),
                                         (16, 7, 8, 16, 7), (8, 8, 8, 4, -1)])
def test_fused_bf16_payload_matches_pallas_interpret(b, f, c, k, aug):
    """The plain version with out_dtype=bfloat16 against
    ffm_fused_logits_grads(..., out_dtype=bfloat16, interpret=True)."""
    rng = np.random.default_rng(b + f + c)
    arrays = (
        (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32),
        rng.integers(0, max(1, c - 1), (b, f)).astype(np.int32),
        rng.random((b, f)).astype(np.float32),
        (rng.normal(size=(b,)) * 0.1).astype(np.float32),
        (rng.random(b) > 0.5).astype(np.float32),
        np.concatenate([np.ones(b - 1), [0.0]]).astype(np.float32),
    )
    logits, gg2 = ffm_fused_logits_grads(*(torch.from_numpy(a) for a in arrays), c, k,
                                         aug_lane=aug, out_dtype=torch.bfloat16)
    ref_logits, ref_gg2 = fp.ffm_fused_logits_grads(
        *(jnp.asarray(a) for a in arrays), c, k, compute_grads=True, block_b=8,
        interpret=True, aug_lane=aug, out_dtype=jnp.bfloat16,
    )
    assert gg2.dtype == torch.bfloat16 and gg2.shape == (b * f, 2 * c * k)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=L_RTOL, atol=L_ATOL)
    _assert_within_bf16_ulp(gg2, ref_gg2, G_ATOL, "payload")
    # g^2 is the rounded square of the f32 g, not the square of the rounded g
    e = c * k
    f32 = ffm_fused_logits_grads(*(torch.from_numpy(a) for a in arrays), c, k, aug_lane=aug)[1]
    assert torch.equal(gg2[:, e:], (f32[:, :e] * f32[:, :e]).to(torch.bfloat16))
    with pytest.raises(ValueError, match="combined"):
        ffm_fused_logits_grads(*(torch.ones(1) for _ in range(6)), c, k,
                               combined_out=False, out_dtype=torch.bfloat16)


# ---- 4. the dense update with a bf16 payload ----


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["aug", "plain"])
def test_dense_update_bf16_payload_matches_jax(form, w_dtype):
    """dense_ftrl_update2_aug (the linear stats in lane 3) and
    dense_ftrl_update2 on a bf16 payload, with an f32 and a bf16 w table,
    through the port's ftrl_update on CPU tensors: n, z and the linear
    tables at the single-update bound, w within one bf16 ulp."""
    rng = np.random.default_rng(11)
    r, d, n = 40, 24, 900
    vec = _tables(rng, r, d)
    lin = _tables(rng, r)
    ids = _ids(rng, r, n)
    g = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    gg2 = np.concatenate([g, g * g], -1)
    gl = g[:, 3]
    gg2_lin = np.stack([gl, gl * gl], -1)
    wdt = getattr(jnp, w_dtype)
    jvec = [jnp.asarray(vec[0]), jnp.asarray(vec[1]), jnp.asarray(vec[2]).astype(wdt)]
    jgg2 = jnp.asarray(gg2).astype(jnp.bfloat16)
    p_j = jftrl.FtrlParams(*P)
    if form == "aug":
        jv, jl = jftrl.dense_ftrl_update2_aug(*jvec, *map(jnp.asarray, lin), jnp.asarray(ids),
                                               jgg2, 3, p_j)
        lane, t_lin_payload = 3, None
    else:
        jv = jftrl.dense_ftrl_update2(*jvec, jnp.asarray(ids), jgg2, p_j)
        jl = jftrl.dense_ftrl_update2(*map(jnp.asarray, lin), jnp.asarray(ids),
                                      jnp.asarray(gg2_lin), p_j)
        lane, t_lin_payload = -1, torch.from_numpy(gg2_lin)
    tvec = [torch.from_numpy(vec[0]), torch.from_numpy(vec[1]),
            torch.from_numpy(np.asarray(jvec[2]).view(np.int16 if w_dtype == "bfloat16"
                                                      else np.float32).copy())]
    if w_dtype == "bfloat16":
        tvec[2] = tvec[2].view(torch.bfloat16)
    tlin = [torch.from_numpy(a.copy()) for a in lin]
    ftrl_update(*tvec, *tlin, torch.from_numpy(ids), _to_bf16_torch(gg2), lane,
                tftrl.FtrlParams(*P), t_lin_payload)
    for got, want in zip((tvec[0], tvec[1], *tlin), (jv[0], jv[1], *jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert tvec[2].dtype == getattr(torch, w_dtype)
    _assert_within_bf16_ulp(tvec[2].float(), np.asarray(jv[2]).astype(np.float32), 0.0, "w")


# ---- 5. the pass with a bf16 w ----


def test_closed_form_pass_bf16_w_matches_pallas_interpret():
    """closed_form_pass on CPU tensors (its plain version) with a bf16 w
    against closed_form_pass_pallas(..., interpret=True): n and z at the
    pass bound, w within one bf16 ulp; A = 0 keeps n, z and the w bits."""
    rng = np.random.default_rng(5)
    r, e = 64, 128
    n_tab, z_tab, w_tab = _tables(rng, r, e)
    a = (rng.random((r, e)) * 0.5).astype(np.float32)
    a[rng.random((r, e)) < 0.4] = 0.0
    w_bf = jnp.asarray(w_tab).astype(jnp.bfloat16)
    want = closed_form_pass_pallas(jnp.asarray(n_tab), jnp.asarray(z_tab), w_bf, jnp.asarray(a),
                                   jftrl.FtrlParams(*P), interpret=True)
    assert want is not None and want[2].dtype == jnp.bfloat16
    got = [torch.from_numpy(n_tab.copy()), torch.from_numpy(z_tab.copy()),
           torch.from_numpy(np.asarray(w_bf).view(np.int16).copy()).view(torch.bfloat16)]
    w_before = got[2].clone()
    closed_form_pass(*got, torch.from_numpy(a), tftrl.FtrlParams(*P))
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL, atol=ATOL)
    _assert_within_bf16_ulp(got[2], want[2], 0.0, "w")
    idle = torch.from_numpy(a == 0)
    assert torch.equal(got[0][idle], torch.from_numpy(n_tab)[idle])
    assert torch.equal(got[1][idle], torch.from_numpy(z_tab)[idle])
    # an idle, touched coordinate recomputes the w it holds
    kept = idle & torch.from_numpy(n_tab > 0)
    assert torch.equal(got[2][kept].view(torch.int16), w_before[kept].view(torch.int16))


# ---- 6. chained train steps ----


@pytest.mark.parametrize("shape", [SEVEN, EIGHT], ids=["aug", "no_dead_lane"])
@pytest.mark.parametrize("kind", ["dense2", "inplace", "sparse2"])
@pytest.mark.parametrize(
    "table_dtype,acc_dtype",
    [("float32", "bfloat16"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")],
)
def test_chained_train_steps_match_jax(interpret, shape, kind, table_dtype, acc_dtype):
    """3 chained train_steps from one JAX-made init against the JAX step
    through its fused Pallas kernel: the payload is bf16 only on "dense2"
    (acc_dtype=bfloat16); "inplace" and "sparse2" keep an f32 payload."""
    mode = {"dense2": "dense", "inplace": "inplace", "sparse2": "sparse"}[kind]
    b, f, r, c = shape["batch_size"], 6, shape["n_feats"], shape["n_fields"]
    kw = dict(max_nnz=f, update_mode=mode, table_dtype=table_dtype, acc_dtype=acc_dtype, **shape)
    jm = j_make_model(JConfig(use_pallas="on", **kw))
    tm = t_make_model(TConfig(device="cpu", **kw))
    assert tm.form == kind
    j_state = jm.init()
    t_state = state_from_jax_arrays(j_state, "cpu")
    assert t_state.vec_w.dtype == getattr(torch, table_dtype)
    rng = np.random.default_rng(7)
    for _ in range(3):
        arrays = _batch(rng, b, f, c, r)
        j_out = jm.train_step(j_state, JBatch(*(jnp.asarray(a) for a in arrays)))
        t_out = tm.train_step(t_state, TBatch(*(torch.from_numpy(a) for a in arrays)))
        j_state = j_out.state
        np.testing.assert_allclose(t_out.logits.numpy(), np.asarray(j_out.logits),
                                   rtol=L_RTOL, atol=L_ATOL)
    assert t_state.vec_w.dtype == getattr(torch, table_dtype)
    for name in ("bias_z", "lin_n", "lin_z", "lin_w", "vec_n", "vec_z"):
        np.testing.assert_allclose(getattr(t_state, name).numpy(),
                                   np.asarray(getattr(j_state, name)),
                                   rtol=CHAIN_RTOL, atol=CHAIN_ATOL, err_msg=name)
    np.testing.assert_allclose(_bf16(t_state.vec_w), _bf16(j_state.vec_w),
                               rtol=BF16_RTOL, atol=CHAIN_ATOL, err_msg="vec_w")
    assert int(t_state.step) == int(j_state.step) == 3


@pytest.mark.parametrize("shape", [SEVEN, EIGHT], ids=["aug", "no_dead_lane"])
def test_eval_hands_bf16_rows_to_the_logits_kernel(interpret, monkeypatch, shape):
    """The eval path gathers a bf16 table's rows and hands them to the
    logits kernel as they are (the kernel widens them itself, so no
    widening pass runs before it); its logits match the JAX package's,
    which widens the rows first (ftrl_ffm_tpu/models/base.py), through its
    Pallas kernel in interpret mode: rtol=L_RTOL, atol=L_ATOL."""
    import ftrl_ffm_tpu_torch.models.ffm as tffm

    seen = []
    real = tffm.ffm_fused_logits

    def spy(v, *args):
        seen.append(v.dtype)
        return real(v, *args)

    monkeypatch.setattr(tffm, "ffm_fused_logits", spy)
    b, f, r, c = shape["batch_size"], 6, shape["n_feats"], shape["n_fields"]
    kw = dict(max_nnz=f, table_dtype="bfloat16", **shape)
    jm = j_make_model(JConfig(use_pallas="on", **kw))
    tm = t_make_model(TConfig(device="cpu", **kw))
    j_state = jm.init()
    t_state = state_from_jax_arrays(j_state, "cpu")
    arrays = _batch(np.random.default_rng(3), b, f, c, r)
    got = tm.predict_logits(t_state, TBatch(*(torch.from_numpy(a) for a in arrays)))
    ref = jm.predict_logits(j_state, JBatch(*(jnp.asarray(a) for a in arrays)))
    assert seen == [torch.bfloat16]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=L_RTOL, atol=L_ATOL)


def test_init_stores_table_dtype():
    """Model.init draws vec_w in f32 and stores it in table_dtype: the bf16
    table is the f32 init rounded, dead lanes zero, n and z f32."""
    f32 = t_make_model(TConfig(device="cpu", **SEVEN)).init()
    bf = t_make_model(TConfig(device="cpu", table_dtype="bfloat16", **SEVEN)).init()
    assert bf.vec_w.dtype == torch.bfloat16 and bf.vec_n.dtype == torch.float32
    assert torch.equal(bf.vec_w, f32.vec_w.to(torch.bfloat16))
    assert (bf.vec_w[:, torch.arange(128) % 8 == 7] == 0).all()


# ---- 7. Trainer.train, evaluate, predict_file ----


@pytest.fixture(scope="module")
def bf16_served(tmp_path_factory):
    """The JAX CLI trains 2 epochs with a bf16 table and saves the
    checkpoint; both CLIs serve it: (dir, checkpoint, eval file, eval
    lines by package)."""
    d = tmp_path_factory.mktemp("bf16")
    train = write_7field(d / "train.ffm", n=80, seed=0)
    evald = write_7field(d / "eval.ffm", n=50, seed=1)
    ckpt = str(d / "model.ckpt")
    flags = [*MODEL_FLAGS, "--table_dtype", "bfloat16"]
    assert jax_main(["--train_data", train, "--n_epochs", "2", "--model_path", ckpt, *flags]) == 0
    lines = {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        out = io.StringIO()
        old, sys.stdout = sys.stdout, out
        try:
            assert main(["--load_model", ckpt, "--eval_data", evald, "--predict_data", evald,
                         "--predict_output", str(d / f"{name}.txt"), *flags, *extra]) == 0
        finally:
            sys.stdout = old
        lines[name] = [l for l in out.getvalue().splitlines() if l.startswith("eval")]
    return d, ckpt, evald, lines


def test_bf16_checkpoint_serves_like_jax(bf16_served, tmp_path):
    """Serving a JAX bf16 checkpoint: the CLI's eval line and predictions,
    and Trainer.evaluate() and predict_file(), against the JAX package's
    (eval within 1e-5, predictions within 2e-6: tests/test_torch_serve.py)."""
    d, ckpt, evald, lines = bf16_served
    assert len(lines["jax"]) == 1 and lines["torch"] == lines["jax"]
    ref = np.loadtxt(d / "jax.txt")
    np.testing.assert_allclose(np.loadtxt(d / "torch.txt"), ref, rtol=0, atol=2e-6)
    cfg = dict(SHAPE, eval_data=evald, table_dtype="bfloat16")
    jstate, _ = j_load(ckpt)
    jtr = JTrainer(JConfig(**cfg), state=jstate)
    host, _ = load_checkpoint(ckpt)
    ttr = Trainer(TConfig(device="cpu", **cfg), state=state_from_jax_arrays(host, "cpu"))
    assert ttr.state.vec_w.dtype == torch.bfloat16
    (jl, ja), (tl, ta) = jtr.evaluate(), ttr.evaluate()
    assert abs(tl - jl) <= 1e-5 and abs(ta - ja) <= 1e-5
    out = tmp_path / "p.txt"
    assert ttr.predict_file(evald, str(out)) == 50
    np.testing.assert_allclose(np.loadtxt(out), ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize(
    "kw",
    [{"table_dtype": "bfloat16"}, {"table_dtype": "bfloat16", "acc_dtype": "bfloat16"},
     {"table_dtype": "bfloat16", "update_mode": "inplace"},
     # auto at 100k rows: JAX's takes "inplace", the port's "dense2"
     # (ftrl.py::update_form): the two runs' histories agree
     {"table_dtype": "bfloat16", "n_feats": 100_000}],
    ids=["dense2", "dense2_bf16_payload", "inplace", "auto_inplace_100k"],
)
def test_trainer_train_bf16_matches_jax(bf16_served, interpret, kw):
    """Trainer.train() with a bf16 table, 2 epochs with eval after each,
    from the JAX Trainer's init (its Pallas path, so that acc_dtype gives a
    bf16 payload there too): the histories within 1e-4
    (tests/test_torch_trainer.py)."""
    d, _, evald, _ = bf16_served
    cfg = dict(SHAPE, train_data=str(d / "train.ffm"), eval_data=evald, n_epochs=2,
               file_type="libffm", max_nnz=7, **kw)
    jtr = JTrainer(JConfig(use_pallas="on", **cfg))
    ttr = Trainer(TConfig(device="cpu", **cfg), state=state_from_jax_arrays(jtr.state, "cpu"))
    hist, ref = ttr.train(), jtr.train()
    for key in ("train_loss", "eval_loss", "eval_auc"):
        np.testing.assert_allclose(hist[key], ref[key], rtol=0, atol=1e-4, err_msg=key)
    assert ttr.state.vec_w.dtype == torch.bfloat16
    np.testing.assert_allclose(_bf16(ttr.logical_state.vec_w), _bf16(jtr.logical_state.vec_w),
                               rtol=BF16_RTOL, atol=CHAIN_ATOL)


# ---- 8. the CLI ----


def test_cli_trains_bf16_tables_and_payload(bf16_served, interpret, capsys):
    """python -m ftrl_ffm_tpu_torch ... --table_dtype bfloat16 --acc_dtype
    bfloat16 trains, resuming the JAX bf16 checkpoint: its epoch lines
    against the JAX CLI's on the Pallas path, the loss digits equal up to a
    flip of the last one (tests/test_torch_trainer.py)."""
    d, ckpt, evald, _ = bf16_served
    argv = ["--load_model", ckpt, "--train_data", str(d / "train.ffm"), "--eval_data", evald,
            "--n_epochs", "2", *MODEL_FLAGS, "--table_dtype", "bfloat16",
            "--acc_dtype", "bfloat16"]
    losses = {}
    for name, main, extra in (("jax", jax_main, ["--use_pallas", "on"]),
                              ("torch", torch_main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(argv + extra) == 0
        out = capsys.readouterr().out
        losses[name] = [float(x) for x in re.findall(r"(?:train|eval) loss: ([0-9.]+)", out)]
    assert len(losses["torch"]) == len(losses["jax"]) == 4
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=0, atol=1.01e-4)
