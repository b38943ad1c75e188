"""The metric files that read the program's spans and counters
(benchmark/spans.py), on a synthetic record: the traced sub-window's host
events hold "ftrl.*" spans inside the harness's "bench.*" spans, and the
record the resident build's counters."""

import pytest

from benchmark import run

STEPS = 4


def _rec(grouped: bool = False) -> dict:
    """Two traced train epochs (bench.train 0-1000 and 2000-3000 us) and one
    eval pass (1000-1500); an untraced epoch's spans lie outside them."""
    host = [("aten::mul", 5.0, 6.0)]
    for t0, start in ((0.0, 60.0), (2000.0, 40.0)):
        host.append(("ftrl.train.epoch", t0 + 10, t0 + 900))
        host.append(("ftrl.train.order", t0 + 12, t0 + start - 5))
        for k in range(STEPS if not grouped else 1):
            a = t0 + 10 + start + 100 * k
            if grouped:
                host.append(("ftrl.train.group", a, a + 80))
            else:
                host.append(("ftrl.train.gather", a, a + 20))
                host.append(("ftrl.train.step", a + 20, a + 70))
    host.append(("ftrl.eval.pass", 1010.0, 1490.0))
    for k in range(STEPS):
        a = 1020.0 + 100 * k
        host.append(("ftrl.eval.gather", a, a + 10))
        host.append(("ftrl.eval.step", a + 10, a + 40))
    host.append(("ftrl.train.step", 5000.0, 9000.0))  # outside the traced spans
    calls = [{"role": "train", "seconds": 0.001, "examples": 64, "steps": STEPS, "epoch": e,
              "traced": True} for e in (2, 3)]
    calls += [{"role": "eval", "seconds": 0.0005, "examples": 64, "steps": STEPS,
               "traced": True},
              {"role": "train", "seconds": 0.001, "examples": 64, "steps": STEPS, "epoch": 1,
               "traced": False}]
    return {
        "calls": calls,
        "trace": {"ops": [], "host": host,
                  "spans": {"train": [(0.0, 1000.0), (2000.0, 3000.0)],
                            "eval": [(1000.0, 1500.0)]}},
        "counters_build": {"parse.rows.native": 300, "parse.rows.numpy": 700},
    }


def _read(name: str, rec: dict):
    return run.load_metric(name)(rec)


def test_epoch_start_is_the_mean_gap_to_the_first_step():
    assert _read("epoch_start_ms.train", _rec()) == pytest.approx((60 + 40) / 2 * 1e-3)
    assert _read("epoch_start_ms.train", _rec(grouped=True)) == pytest.approx(50e-3)


@pytest.mark.parametrize("grouped", [False, True])
def test_host_ms_per_train_step(grouped):
    # S = 1: 20 us of gather and 50 of step a step; S > 1: one 80-us group
    # for the epoch's four steps
    want = 70e-3 if not grouped else 80e-3 / STEPS
    assert _read("host_ms_per_step.train", _rec(grouped)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["host_ms_per_step.eval", "host_ms_per_step.eval.ffm1m"])
def test_host_ms_per_eval_step(name):
    assert _read(name, _rec()) == pytest.approx(40e-3)


def test_parse_numpy_share_reads_the_build_counters():
    assert _read("parse_numpy_share", _rec()) == pytest.approx(70.0)
    rec = dict(_rec(), counters_build={"parse.rows.native": 5})
    assert _read("parse_numpy_share", rec) == 0.0


@pytest.mark.parametrize("name", ["epoch_start_ms.train", "host_ms_per_step.train",
                                  "host_ms_per_step.eval", "host_ms_per_step.eval.ffm1m"])
def test_span_readers_find_nothing_without_the_spans(name):
    untraced = dict(_rec(), trace=None)
    assert _read(name, untraced) is None
    rec = _rec()
    rec["trace"]["host"] = [h for h in rec["trace"]["host"] if not h[0].startswith("ftrl.")]
    assert _read(name, rec) is None


def test_parse_share_finds_nothing_without_counted_rows(monkeypatch):
    assert _read("parse_numpy_share", dict(_rec(), counters_build={})) is None
    # no record of the build: the program's own counters, none counted here
    from ftrl_ffm_tpu_torch import tracing

    monkeypatch.setattr(tracing, "_counts", {})
    rec = _rec()
    del rec["counters_build"]
    assert _read("parse_numpy_share", rec) is None
