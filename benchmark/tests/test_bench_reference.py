"""The plain reference against steps worked out by hand, its gradients
against autograd, and the comparison's arithmetic."""

import math

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import model

P = {"alpha": 0.1, "beta": 1.0, "l1": 0.01, "l2": 0.5}


def _state(vec_w):
    r = vec_w.shape[0]
    z = lambda *s: torch.zeros(s)  # noqa: E731
    return model.RefState(z(), z(), z(r), z(r), z(r), torch.zeros_like(vec_w),
                          torch.zeros_like(vec_w), vec_w.clone())


def _closed(n, z):
    if abs(z) <= P["l1"]:
        return 0.0
    return -(z - math.copysign(P["l1"], z)) / (P["l2"] + (P["beta"] + math.sqrt(n)) / P["alpha"])


def test_fm_step_by_hand():
    cfg = {"model_type": "FM", "ftrl": P, "untouched_n": 1e-16}
    st = _state(torch.tensor([[0.5], [-0.2], [0.3]]))
    ids = torch.tensor([[0, 1]])
    loss = model.train_step(cfg, st, ids, torch.tensor([1.0]), block=1)
    logit = 0.5 * -0.2                                   # <v0, v1> x0 x1
    assert loss == pytest.approx(math.log1p(math.exp(logit)) - logit, rel=1e-6)
    gl = 1 / (1 + math.exp(-logit)) - 1                  # sigmoid - y
    for row, (g, w0) in enumerate(((gl * -0.2, 0.5), (gl * 0.5, -0.2))):
        n = g * g
        z = g - math.sqrt(n) / P["alpha"] * w0
        assert float(st.vec_n[row, 0]) == pytest.approx(n, rel=1e-5)
        assert float(st.vec_z[row, 0]) == pytest.approx(z, rel=1e-5)
        assert float(st.vec_w[row, 0]) == pytest.approx(_closed(n, z), rel=1e-5)
        # the linear slot: g = gl * x, w0 = 0
        assert float(st.lin_z[row]) == pytest.approx(gl, rel=1e-5)
        assert float(st.lin_w[row]) == pytest.approx(_closed(gl * gl, gl), rel=1e-5)
    # row 2 was not touched: keep_init
    assert float(st.vec_w[2, 0]) == pytest.approx(0.3) and float(st.vec_n[2, 0]) == 0.0
    assert float(st.bias_z) == pytest.approx(gl, rel=1e-5)


def test_ffm_logit_is_the_pair_sum():
    torch.manual_seed(0)
    f, k = 3, 2
    vec_w = torch.randn(6, f, k)
    st = _state(vec_w)
    st.lin_w[:] = torch.randn(6)
    ids = torch.tensor([[0, 2, 5], [1, 3, 4]])
    x = torch.tensor([[1.0, 0.5, 2.0], [1.0, 1.0, 1.0]])
    cfg = {"model_type": "FFM", "ftrl": P}
    logit, _ = model.forward(cfg, st, ids, x, need_grad=False)
    for b in range(2):
        want = sum(float(st.lin_w[ids[b, i]]) * float(x[b, i]) for i in range(f))
        for i in range(f):
            for j in range(i + 1, f):
                want += float(vec_w[ids[b, i], j] @ vec_w[ids[b, j], i]) * float(x[b, i] * x[b, j])
        assert float(logit[b]) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("kind", ["FFM", "FM"])
def test_gradient_is_autograd(kind):
    torch.manual_seed(1)
    f, k = 4, 3
    shape = (8, f, k) if kind == "FFM" else (8, k)
    ids = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7], [0, 5, 2, 7]])
    x = torch.rand(3, f) + 0.5
    cfg = {"model_type": kind, "ftrl": P}
    st = _state(torch.randn(shape))
    _, dv = model.forward(cfg, st, ids, x, need_grad=True)
    for b in range(3):
        v = st.vec_w[ids[b]].clone().requires_grad_(True)

        def logit(v):
            st2 = _state(st.vec_w.clone())
            st2.vec_w = st2.vec_w.index_put((ids[b],), v)
            return model.forward(cfg, st2, ids[b:b + 1], x[b:b + 1], need_grad=False)[0][0]

        (g,) = torch.autograd.grad(logit(v), v)
        torch.testing.assert_close(dv[b], g, rtol=1e-5, atol=1e-6)


def test_binned_auc():
    logits = np.array([-3.0, -1.0, 0.5, 2.0])
    y = np.array([0, 1, 0, 1])
    # distinct buckets: the exact AUC, 3 of the 4 (pos, neg) pairs ordered
    assert model.binned_auc(logits, y, 8192) == pytest.approx(0.75)
    # one bucket: every pair ties
    assert model.binned_auc(logits, y, 1) == pytest.approx(0.5)


def test_leaf_gap_and_nought_rule():
    ref = {"vec": 4.0, "lin": 2.0, "bias": 1e-9}
    prog = {"vec": 4.4, "lin": 2.0, "bias": 2e-9}
    # vec: 0.4 / 4; bias: 1e-9 against the median leaf's 2.0
    assert compare.leaf_gap(prog, ref, compare.GRAD_LEAVES) == pytest.approx(0.1)
    assert compare.counted_change_leaves(ref) == [
        "vec_n", "vec_z", "vec_w", "lin_n", "lin_z", "lin_w"]


def test_judge():
    limits = dict.fromkeys(compare.NAMES, 1e-3)
    ok, checks = compare.judge(dict.fromkeys(compare.NAMES, 1e-4), limits)
    assert ok and checks["auc"] == {"value": 1e-4, "limit": 1e-3}
    assert not compare.judge(dict(dict.fromkeys(compare.NAMES, 0.0), logit=math.nan), limits)[0]
    assert not compare.judge(dict(dict.fromkeys(compare.NAMES, 0.0), grad=2e-3), limits)[0]
