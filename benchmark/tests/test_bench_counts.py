"""The floors against counts made by hand on small shapes."""

import pytest

from benchmark import floors

FFM = {"model_type": "FFM", "n_fields": 3, "n_factors": 2}
FM = {"model_type": "FM", "n_fields": 3, "n_factors": 2}
BW, FL = floors.PEAK_BYTES_PER_S, floors.PEAK_F32_FLOPS


def test_slots():
    # FFM: a row meets the 2 other fields, 2 factors each, + its linear slot
    assert floors.slots_per_row(FFM) == 5
    assert floors.slots_per_row(FM) == 3
    assert floors.slots_per_row({"model_type": "FFM", "n_fields": 39, "n_factors": 16}) == 609


def test_forward_flops():
    # FFM: 3 pairs, a 2-wide dot product each (2 mul + 2 add) = 12 a row
    assert floors.forward_flops(FFM, 4) == 48
    # FM: 4 * F * k = 24 a row
    assert floors.forward_flops(FM, 4) == 96


def test_train_step_floor():
    # 10 rows x 5 slots x 4 B x 6 (n, z, w read and written) = 1200 B,
    # batch 4 rows x (3 ids + 1 label) x 4 B = 64 B
    assert floors.train_step_floor(FFM, 4, 10) == pytest.approx(max(1264 / BW, 144 / FL))


def test_update_floor():
    # n, z read and n, z, w written: 10 x 5 x 4 B x 5
    assert floors.update_floor(FFM, 10) == pytest.approx(1000 / BW)


def test_interaction_floor():
    # w of 10 rows (200 B) + the batch (64 B); 3 x forward flops
    assert floors.interaction_floor(FFM, 4, 10) == pytest.approx(max(264 / BW, 144 / FL))


def test_eval_floor():
    # w of 10 rows + batch + 4 logits written (16 B); forward flops
    assert floors.eval_step_floor(FM, 4, 10) == pytest.approx(max((120 + 64 + 16) / BW, 96 / FL))


def test_compute_bound_shape():
    # a wide FFM row on few distinct ids is bound by its operations
    cfg = {"model_type": "FFM", "n_fields": 39, "n_factors": 16}
    assert floors.train_step_floor(cfg, 16384, 1) == pytest.approx(
        3 * 16384 * 741 * 32 / FL)
