"""The seam between the Trainer, the step and the model: the one decision
of the table-update form (ftrl.py::update_form) on every placement, and
each model's interaction (Model.forward) on rows its caller gathers,
which is what the one-device step runs (models/base.py::local_rows) and
what the mesh step runs on its lookups (parallel/sharded.py)."""

import pytest
import torch

from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.ftrl import update_form
from ftrl_ffm_tpu_torch.models import Batch, ModelState, make_model
from ftrl_ffm_tpu_torch.models.base import local_rows, widen_batch

# placement -> (data ranks, routed lookups)
PLACEMENTS = {"one": (1, False), "1xN-route": (1, True),
              "DxM-replicate": (2, False), "DxM-route": (2, True)}
# (rows of the table or shard, batch size, model): FFM at Criteo's 39
# fields, k=16 (640-lane rows), B*39 occurrences a step.  Each pair of
# columns straddles a threshold: 4x the global nnz (159,744 rows at
# B=1024), the 2 GB [rows, 2E] accumulator (419,430 rows), the 4 GB table
# (1,677,721 rows); then LR's one linear table.
COLUMNS = [(150_000, 1024, "FFM"), (170_000, 1024, "FFM"), (400_000, 16384, "FFM"),
           (500_000, 16384, "FFM"), (1_000_000, 16384, "FFM"), (2_000_000, 16384, "FFM"),
           (1000, 1024, "LR")]
_ONE = {"auto": "dense2 dense2 dense2 dense2 dense2 sparse2 dense2",
        "dense": "dense2 dense2 dense2 dense2 dense2 dense2 dense2",
        "sparse": "sparse2 sparse2 sparse2 sparse2 sparse2 sparse2 sparse2",
        "inplace": "inplace inplace inplace inplace inplace inplace dense2"}
_ACC = "accumulator accumulator accumulator accumulator accumulator accumulator accumulator"
# each placement's form under each update_mode, column by column: the
# port's auto on one device and a (1, N) route's owner, JAX's thresholds
# where data replicas share a shard
EXPECTED = {
    **{("one", m): f for m, f in _ONE.items()},
    **{("1xN-route", m): f for m, f in _ONE.items()},
    ("DxM-replicate", "auto"):
        "accumulator allgather accumulator allgather allgather allgather accumulator",
    ("DxM-replicate", "dense"): _ACC,
    ("DxM-replicate", "sparse"): "allgather allgather allgather allgather allgather allgather "
                                 "allgather",
    ("DxM-replicate", "inplace"): _ACC,
    **{("DxM-route", m): _ACC for m in _ONE},
}


@pytest.mark.parametrize("placement,mode", list(EXPECTED), ids=[f"{p}-{m}" for p, m in EXPECTED])
def test_update_form_table(placement, mode):
    """update_form gives each placement's form under every update_mode, on
    both sides of each threshold; a one-device model holds its own."""
    mesh_data, route = PLACEMENTS[placement]
    got = []
    for rows, batch, model_type in COLUMNS:
        cfg = Config(model_type=model_type, n_fields=39, n_factors=16, n_feats=rows,
                     batch_size=batch, max_nnz=39, update_mode=mode, device="cpu")
        assert cfg.row_width == (640 if model_type == "FFM" else 0)
        got.append(update_form(cfg, rows, mesh_data, route))
        if placement == "one":
            assert make_model(cfg).form == got[-1]
    assert got == EXPECTED[placement, mode].split()


def _batch(cfg, b: int = 16, seed: int = 0) -> Batch:
    """Random occurrences, the padding sentinel in a few slots and a
    padded last sample."""
    g = torch.Generator().manual_seed(seed)
    f = cfg.n_fields
    feats = torch.randint(0, cfg.n_feats, (b, f), generator=g, dtype=torch.int32)
    vals = torch.rand((b, f), generator=g)
    pad = torch.rand((b, f), generator=g) < 0.1
    feats[pad], vals[pad] = cfg.n_feats, 0.0
    sample_w = torch.ones(b)
    sample_w[-1] = 0.0
    return Batch(fields=torch.arange(f, dtype=torch.int32).expand(b, f).contiguous(),
                 feats=feats, vals=vals, y=(torch.rand(b, generator=g) > 0.5).float(),
                 sample_w=sample_w)


@pytest.mark.parametrize("mode", ["auto", "inplace"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_type", ["LR", "FM", "FFM"])
def test_forward_on_local_rows_is_the_step(model_type, dtype, mode):
    """The model's interaction on locally gathered rows gives train_step's
    logits and its update's payload and lane bit for bit (the combined
    payload under auto, in acc_dtype; g and g^2 apart under inplace), and
    eval_step's logits."""
    cfg = Config(model_type=model_type, n_fields=7, n_factors=16, n_feats=60, batch_size=16,
                 max_nnz=7, table_dtype=dtype, acc_dtype=dtype, update_mode=mode,
                 w_alpha=0.05, w_l1=0.15, w_l2=1.0, device="cpu")
    model = make_model(cfg)
    state = model.init()
    before = ModelState(*(None if t is None else t.clone() for t in state))
    batch = _batch(cfg)
    seen = {}
    apply_update = model.apply_update

    def capture(st, ids, payload, lane, gg2_lin, kind):
        seen.update(payload=payload, lane=lane)
        return apply_update(st, ids, payload, lane, gg2_lin, kind)

    model.apply_update = capture
    out = model.train_step(state, batch)
    wb = widen_batch(batch)
    logits, gs, payload, lane = model.forward(
        before, wb, local_rows(wb.feats), model.bias_weight(before), True,
        model.form == "inplace", model.payload_dtype)
    assert torch.equal(logits, out.logits) and out.route_overflow is None
    assert lane == seen["lane"] and (payload is None) == (model_type == "LR")
    assert len(payload or ()) == len(seen["payload"] or ()) == (0 if payload is None else
                                                                2 if mode == "inplace" else 1)
    for mine, its in zip(payload or (), seen["payload"] or ()):
        assert mine.dtype == its.dtype and torch.equal(mine, its)
    eval_logits = model.forward(before, wb, local_rows(wb.feats), model.bias_weight(before),
                                False)[0]
    ls, ct, step_logits, drops, pos, neg = model.eval_step(before, batch)
    assert torch.equal(eval_logits, step_logits) and drops is None and pos is None
