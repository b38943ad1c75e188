"""The traffic generator: seeded bytes, each field's values hashed into
one shared space, the libffm text, and the distinct-row count."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark import floors, generator, spec

CFG = {"n_fields": 5, "n_feats": 1000, "train_rows": 3000, "eval_rows": 500}
MIX = {"values": [3, 10, 100, 5000, 10**7], "labels": {"w_std": 0.3, "noise_std": 1.0}}


def _digest(tmp_path, seed, name):
    d = generator.generate(CFG, MIX, seed)
    path = tmp_path / name
    generator.write_libffm(str(path), d.train_ids, d.train_y, CFG, block=700)
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_same_seed_same_bytes(tmp_path):
    seed = 2**31 + 12345
    assert _digest(tmp_path, seed, "a") == _digest(tmp_path, seed, "b")
    assert _digest(tmp_path, seed, "a") != _digest(tmp_path, seed + 1, "c")


def test_each_field_takes_its_values_alike():
    cfg = dict(CFG, n_feats=10**6, train_rows=60_000)
    d = generator.generate(cfg, MIX, 5)
    for c, v in enumerate(MIX["values"][:3]):
        rows = generator.hashed_rows(np.int64(c), np.arange(v), cfg["n_feats"])
        got = d.train_ids[:, c]
        assert np.all(np.isin(got, rows))
        counts = np.array([(got == r).sum() for r in np.unique(rows)])
        expect = cfg["train_rows"] / v
        assert np.all(np.abs(counts - expect) < 6 * np.sqrt(expect))
    # the field of 10^7 values: nearly every row distinct
    assert np.unique(d.train_ids[:, 4]).size > 0.95 * cfg["train_rows"]


def test_zipf_law_in_range_without_pile_up():
    vals, n = np.array([200, 3]), 400_000
    got = generator.draw_values(np.random.default_rng(3), {"zipf": 1.1}, vals, n)
    assert got.min() >= 0 and np.all(got.max(axis=0) < vals)
    counts = np.bincount(got[:, 0], minlength=200)
    p = np.arange(1, 201, dtype=np.float64) ** -1.1
    expect = p / p.sum() * n
    # the last value holds its own mass (a clamp into it would hold the
    # whole tail past the vocabulary), and every value is near its law
    assert abs(counts[-1] - expect[-1]) < 5 * np.sqrt(expect[-1])
    assert np.all(np.abs(counts - expect) < 6 * np.sqrt(expect) + 5)


def test_hash_is_fixed_in_range_and_shared():
    rows = generator.hashed_rows(np.arange(39)[:, None], np.arange(20_000)[None, :], 1000)
    assert rows.min() >= 0 and rows.max() < 1000
    assert np.array_equal(rows, generator.hashed_rows(np.arange(39)[:, None],
                                                      np.arange(20_000)[None, :], 1000))
    # one space for all fields: no field holds a range of its own, and two
    # fields' values share rows
    assert np.all(rows.min(axis=1) < 10) and np.all(rows.max(axis=1) > 990)
    assert np.intersect1d(rows[0], rows[1]).size > 0


def test_values_must_match_the_fields():
    with pytest.raises(ValueError):
        generator.generate(dict(CFG, n_fields=4), MIX, 1)


def test_criteo_mix_lists_every_field():
    t = spec.traffic("criteo-kaggle")
    with open(os.path.join(spec.ROOT, "benchmark", "configs", "ffm-criteo-1m.json")) as f:
        cfg = json.load(f)
    assert len(t["values"]) == len(t["fields"]) == cfg["n_fields"]
    assert generator.field_values(cfg, t).min() >= 3


def test_text_parses_back(tmp_path):
    from ftrl_ffm_tpu_torch.data.parser import parse_text_numpy

    d = generator.generate(CFG, MIX, 21)
    path = tmp_path / "t.ffm"
    generator.write_libffm(str(path), d.train_ids[:300], d.train_y[:300], CFG, block=64)
    out = parse_text_numpy(path.read_text(), "libffm", 5, CFG["n_feats"], 5)
    assert np.array_equal(out.feats, d.train_ids[:300])
    assert np.array_equal(out.fields, np.broadcast_to(np.arange(5), (300, 5)))
    assert np.all(out.vals == 1.0)
    assert np.array_equal(out.y, d.train_y[:300].astype(np.float32))


@pytest.mark.parametrize("shuffled", [False, True])
def test_unique_rows_matches_a_direct_count(shuffled):
    d = generator.generate(CFG, MIX, 8)
    order = np.random.default_rng(1).permutation(CFG["train_rows"]) if shuffled else None
    n = CFG["train_rows"]
    steps = np.full(-(-n // 256) * 256, -1)
    steps[:n] = np.arange(n) if order is None else order
    got = floors.unique_rows(torch.as_tensor(d.train_ids), steps.reshape(-1, 256))
    rows = d.train_ids if order is None else d.train_ids[order]
    want = [np.unique(rows[lo:lo + 256]).size for lo in range(0, rows.shape[0], 256)]
    assert list(got) == want
