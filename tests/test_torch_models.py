"""The port's models, FTRL closed form and metrics against the JAX package
on the same numpy inputs and the same trained state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ftrl_ffm_tpu import ftrl as jftrl
from ftrl_ffm_tpu import metrics as jmetrics
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.models.base import Batch as JBatch
from ftrl_ffm_tpu.models.base import binary_logloss as j_logloss
from ftrl_ffm_tpu.models.base import widen_batch as j_widen
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch import ftrl as tftrl
from ftrl_ffm_tpu_torch import metrics as tmetrics
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
from ftrl_ffm_tpu_torch.models import make_model as t_make_model
from ftrl_ffm_tpu_torch.models.base import Batch as TBatch
from ftrl_ffm_tpu_torch.models.base import binary_logloss as t_logloss
from ftrl_ffm_tpu_torch.models.base import widen_batch as t_widen

RTOL, ATOL = 1e-5, 1e-6

# the 7-field FFM of tests/test_train.py::_mirror_cfg: K=16 pads C=7 to
# C'=8, so dead lane 7 mirrors the linear table and serving reads it
MIRROR = dict(
    model_type="FFM", n_feats=60, n_fields=7, n_factors=16, batch_size=16,
    w_alpha=0.05, w_l1=0.15, w_l2=1.0, file_type="libffm", max_nnz=7,
)


def write_7field(path, n=60, seed=0):
    """libffm lines over 7 fields with fractional values; some samples miss
    a field, so batches carry padding occurrences."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))]
            for c in range(7):
                if rng.random() < 0.85:
                    val = round(float(rng.random()) * 2 + 0.05, 3)
                    toks.append(f"{c}:{int(rng.integers(0, 60))}:{val}")
            f.write(" ".join(toks) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX FFM state after two online epochs, and the train file."""
    path = write_7field(tmp_path_factory.mktemp("m") / "train.ffm")
    tr = JTrainer(JConfig(train_data=path, n_epochs=2, **MIRROR))
    assert tr.model._lin_read_lane() == 7
    tr.train()
    return tr, path


def _batches(path, batch_size=16):
    from ftrl_ffm_tpu_torch.data.stream import StreamReader

    return list(
        StreamReader(path, "libffm", batch_size, 7, 60, 7, log_every=0).batches()
    )


def test_ftrl_weights_matches_jax():
    rng = np.random.default_rng(0)
    n = rng.random(256).astype(np.float32) * 3
    z = (rng.normal(size=256) * 0.5).astype(np.float32)
    z[:8] = [0.0, 0.1, -0.1, 0.1000001, -0.0999, 1e-8, -5.0, 5.0]
    p = (1e-4, 1.0, 0.1, 5.0)
    ref = jftrl.ftrl_weights(jnp.asarray(n), jnp.asarray(z), jftrl.FtrlParams(*p))
    got = tftrl.ftrl_weights(torch.from_numpy(n), torch.from_numpy(z), tftrl.FtrlParams(*p))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-9)
    assert tftrl.UNTOUCHED_N == jftrl.UNTOUCHED_N


@pytest.mark.parametrize("marker", ["iota_fields", "ones_vals", "narrow", "plain"])
def test_widen_batch_matches_jax(marker):
    rng = np.random.default_rng(1)
    b, f = 6, 5
    fields = rng.integers(0, 5, (b, f)).astype(np.int32)
    feats = rng.integers(0, 100, (b, f)).astype(np.int32)
    vals = rng.random((b, f)).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    if marker == "iota_fields":
        fields = np.zeros((0, f), np.int32)
    elif marker == "ones_vals":
        vals = np.zeros((b, 0), np.float32)
    elif marker == "narrow":
        fields, y, sw = fields.astype(np.int8), y.astype(np.int8), sw.astype(np.int8)
        vals = np.round(vals * 10).astype(np.int8)
    arrays = (fields, feats, vals, y, sw)
    ref = j_widen(JBatch(*(jnp.asarray(a) for a in arrays)))
    got = t_widen(TBatch(*(torch.from_numpy(a) for a in arrays)))
    for r, g in zip(ref[:5], got):
        assert g.dtype in (torch.int32, torch.float32)
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_widen_batch_refuses_transfer_tiers():
    """No tier dtype is refused any more (the transfer tiers are ported:
    tests/test_torch_transfer.py holds each against the JAX package): a
    uint16 feats tensor without feats_base widens as the JAX package's
    does, by a cast, and a uint16 delta batch decodes against its base."""
    b, f = 4, 3
    feats = np.arange(b * f, dtype=np.uint16).reshape(b, f)
    feats[0, 0] = 65535
    base = np.array([100, 200, 300, 7], np.int32)
    arrays = (np.zeros((b, f), np.int32), feats, np.ones((b, f), np.float32),
              np.zeros(b, np.float32), np.ones(b, np.float32))
    for fb in (None, base):
        ref = j_widen(JBatch(*(jnp.asarray(a) for a in arrays),
                             feats_base=None if fb is None else jnp.asarray(fb)))
        got = t_widen(TBatch(*(torch.from_numpy(a) for a in arrays),
                             feats_base=None if fb is None else torch.from_numpy(fb)))
        for r, g in zip(ref[:5], got[:5]):
            assert g.dtype in (torch.int32, torch.float32)
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got.feats[0, 0] == 7 and got.feats[1, 0] == 100 + 3


def test_logloss_matches_jax():
    x = np.linspace(-40, 40, 101).astype(np.float32)
    y = (np.arange(101) % 2).astype(np.float32)
    ref = j_logloss(jnp.asarray(x), jnp.asarray(y))
    got = t_logloss(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_state_from_jax_arrays_carries_every_table(trained):
    jtr, _ = trained
    st = state_from_jax_arrays(jtr.state, "cpu")
    for name, a in jtr.state._asdict().items():
        t = getattr(st, name)
        assert (a is None) == (t is None)
        if a is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    st.vec_w[0, 0] += 1.0  # the tensors own writable memory


def test_ffm_predict_logits_and_eval_step_match_jax(trained, tmp_path):
    jtr, path = trained
    tcfg = TConfig(device="cpu", **MIRROR)
    tmodel = t_make_model(tcfg)
    assert tmodel._lin_read_lane() == 7
    tstate = state_from_jax_arrays(jtr.state, "cpu")
    np.testing.assert_allclose(
        tmodel.bias_weight(tstate).numpy(),
        np.asarray(jtr.model.bias_weight(jtr.state)), rtol=RTOL, atol=1e-9,
    )
    batches = _batches(write_7field(tmp_path / "eval.ffm", n=40, seed=3))
    assert batches[-1][4].min() == 0  # a padded tail batch
    for arrays in batches:
        jb = JBatch(*(jnp.asarray(a) for a in arrays))
        tb = TBatch(*(torch.from_numpy(a) for a in arrays))
        ref = jtr.model.predict_logits(jtr.state, jb)
        got = tmodel.predict_logits(tstate, tb)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
        jls, jct, _ = jtr.model.eval_step(jtr.state, jb)
        tls, tct, *_ = tmodel.eval_step(tstate, tb)
        np.testing.assert_allclose(float(tls), float(jls), rtol=RTOL, atol=ATOL)
        assert float(tct) == float(jct)


def test_sentinel_ids_gather_clipped(trained):
    """Padding carries id n_feats; the gather clips it to the last row (no
    index error), and its zero value keeps it inert."""
    jtr, _ = trained
    tcfg = TConfig(device="cpu", **MIRROR)
    tmodel = t_make_model(tcfg)
    tstate = state_from_jax_arrays(jtr.state, "cpu")
    rng = np.random.default_rng(4)
    fields = np.tile(np.arange(7, dtype=np.int32), (8, 1))
    feats = rng.integers(0, 60, (8, 7)).astype(np.int32)
    vals = rng.random((8, 7)).astype(np.float32)
    feats[:, 5:] = 60
    vals[:, 5:] = 0.0
    fields[:, 5:] = 0
    arrays = (fields, feats, vals, np.ones(8, np.float32), np.ones(8, np.float32))
    got = tmodel.predict_logits(tstate, TBatch(*(torch.from_numpy(a) for a in arrays)))
    ref = jtr.model.predict_logits(jtr.state, JBatch(*(jnp.asarray(a) for a in arrays)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_make_model_refuses_lr_fm():
    """Once refused (ROADMAP.md Queue 1 item 4): make_model now builds LR
    and FM, and a model type the package does not know still raises."""
    from ftrl_ffm_tpu_torch.models import FM, LR

    for mt, cls in (("LR", LR), ("FM", FM)):
        model = t_make_model(TConfig(model_type=mt, device="cpu"))
        assert type(model) is cls and model.cfg.model_type == mt
    cfg = TConfig(device="cpu")
    cfg.model_type = "GBDT"
    with pytest.raises(ValueError, match="Invalid model_type"):
        t_make_model(cfg)


def test_bucket_counts_match_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=512) * 3).astype(np.float32)
    y = (rng.random(512) > 0.5).astype(np.float32)
    w = (rng.random(512) > 0.1).astype(np.float32)
    for n_bins in (16, jmetrics.AUC_BINS):
        rp, rn = jmetrics.StreamingAUC.bucket_counts(
            jnp.asarray(logits), jnp.asarray(y), jnp.asarray(w), n_bins
        )
        tp, tn = tmetrics.StreamingAUC.bucket_counts(
            torch.from_numpy(logits), torch.from_numpy(y), torch.from_numpy(w), n_bins
        )
        np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
    assert tmetrics.AUC_BINS == jmetrics.AUC_BINS


def test_kahan_add_matches_jax():
    """The compensated chain, step for step, bit for bit, over values where
    a naive f32 chain loses digits."""
    rng = np.random.default_rng(6)
    parts = [
        (np.float32(rng.random() * 1e4), rng.random(8).astype(np.float32) * 1e-3)
        for _ in range(50)
    ]
    jt = ((jnp.asarray(parts[0][0]), jnp.asarray(parts[0][1])),
          (jnp.zeros(()), jnp.zeros(8)))
    tt = ((torch.tensor(parts[0][0]), torch.from_numpy(parts[0][1])),
          (torch.zeros(()), torch.zeros(8)))
    for s, v in parts[1:]:
        jt = jmetrics.kahan_add(jt[0], jt[1], (jnp.asarray(s), jnp.asarray(v)))
        tt = tmetrics.kahan_add(tt[0], tt[1], (torch.tensor(s), torch.from_numpy(v)))
    for j, t in zip(jt[0] + jt[1], tt[0] + tt[1]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_auc_closes_match_jax():
    rng = np.random.default_rng(7)
    pos = rng.integers(0, 5, 64).astype(np.float64)
    neg = rng.integers(0, 5, 64).astype(np.float64)
    ja, ta = jmetrics.StreamingAUC(64), tmetrics.StreamingAUC(64)
    ja.update(pos, neg)
    ta.update(pos, neg)
    assert ta.result() == ja.result()
    scores = rng.random(200)
    scores[:20] = 0.5  # ties
    labels = rng.random(200) > 0.5
    assert tmetrics.exact_auc(scores, labels) == jmetrics.exact_auc(scores, labels)
