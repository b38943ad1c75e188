"""Cells on more than one card, run here as gloo ranks on the CPU at the
tiny sizes of test_bench_harness.py: the launcher's result line, each
rank's S0 against the placement of the whole S0, the check's sums over
the ranks, the logits gathered to rank 0, a failing rank, and the
reference that holds only the rows the check reads."""

import dataclasses
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import compare, port, ranks, run, spec
from benchmark import state as s0
from benchmark.reference.follow import follow
from benchmark.tests.test_bench_harness import CELLS, tiny

SEED = 2**31 + 13
# S0 in blocks of 32 FFM rows: a rank's build holds no more than a block
BLOCK_ELEMENTS = 1 << 14


def mesh_cell(name: str, n: int) -> spec.Cell:
    """The tiny cell on n ranks: a (1, n) mesh, routed lookups, the shard
    layout of the resident datasets."""
    c = tiny(name)
    cfg = dict(c.config, mesh_data=1, mesh_model=n, lookup_mode="route",
               train_rows=256 if c.config["steps_per_call"] == 1 else 512, eval_rows=128)
    protocol = dict(c.traffic["protocol"], device_cache_layout="shard")
    return dataclasses.replace(c, config=cfg, traffic=dict(c.traffic, protocol=protocol),
                               chips=n)


def _launch(tmp_path_factory, name: str, n: int) -> tuple:
    probe = tmp_path_factory.mktemp(f"probe{n}")
    code, line = ranks.launch(mesh_cell(name, n), SEED, 0.2, False, device="cpu",
                              limit_s=180, probe_dir=str(probe), block_elements=BLOCK_ELEMENTS)
    probes = [torch.load(probe / f"rank{r}.pt", weights_only=False) for r in range(n)]
    return code, line, probes


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _launch(tmp_path_factory, CELLS[0], 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _launch(tmp_path_factory, CELLS[1], 4)


def _program_cfg(cell: spec.Cell):
    return port.program_config(cell.config, cell.traffic["protocol"], "", "", SEED,
                               torch.device("cpu"))


def _mesh(n: int, rank: int, data: int = 1):
    from ftrl_ffm_tpu_torch.parallel.mesh import Mesh

    return Mesh(data, n // data, rank, torch.device("cpu"), None, None)


@pytest.mark.parametrize("n", [2, 4])
def test_launched_run_prints_a_correct_line(n, two, four):
    code, line, _ = two if n == 2 else four
    assert code == 0 and line["correct"] is True, line
    assert line["device"]["count"] == n
    assert len(line["device"]["memory_peak_bytes_by_rank"]) == n
    assert line["checks"]["route_drops"] == {"value": 0.0, "limit": 0}
    assert set(line["metrics"]) == {m["name"] for m in mesh_cell(CELLS[n == 4], n).end_to_end}


@pytest.mark.parametrize("n", [2, 4])
def test_rank_s0_is_the_placement_of_the_whole_s0(n, two, four, monkeypatch):
    from ftrl_ffm_tpu_torch.parallel.mesh import shard_state

    monkeypatch.setattr(s0, "BLOCK_ELEMENTS", BLOCK_ELEMENTS)
    _, _, probes = two if n == 2 else four
    cell = mesh_cell(CELLS[n == 4], n)
    cfg = _program_cfg(cell)
    whole = port.program_state(cell.config, cfg, SEED, torch.device("cpu"))
    full_bytes = whole.vec_w.numel() * whole.vec_w.element_size()
    for r, probe in enumerate(probes):
        want = shard_state(whole, _mesh(n, r)).vec_w
        assert torch.equal(probe["s0_vec_w"], want), r
        # no rank's build made a tensor as large as the whole factor table
        assert probe["build_largest_bytes"] < full_bytes, r


@pytest.mark.parametrize("n", [2, 3, 4])
def test_fill_s0_gives_shard_state_rows_past_n_feats_zero(n, monkeypatch):
    from ftrl_ffm_tpu_torch.parallel.mesh import shard_state

    monkeypatch.setattr(s0, "BLOCK_ELEMENTS", BLOCK_ELEMENTS)
    cell = tiny(CELLS[0])
    config = dict(cell.config, n_feats=3901)
    cfg = port.program_config(config, cell.traffic["protocol"], "", "", SEED,
                              torch.device("cpu"))
    whole = port.program_state(config, cfg, SEED, torch.device("cpu"))
    for r in range(n):
        want = shard_state(whole, _mesh(n, r)).vec_w
        got = torch.zeros_like(want)
        port.fill_s0(got, config, cfg, SEED, n, r)
        assert torch.equal(got, want), r


@pytest.mark.parametrize("data", [1, 2])
def test_sums_over_ranks_give_the_one_process_norms(data):
    from ftrl_ffm_tpu_torch.parallel.mesh import shard_state

    cell = tiny(CELLS[0])
    config = dict(cell.config, n_feats=3900)
    cfg = port.program_config(config, cell.traffic["protocol"], "", "", SEED,
                              torch.device("cpu"))
    st = port.program_state(config, cfg, SEED, torch.device("cpu"))
    # a state one step could leave: n, z and w moved on some rows
    gen = torch.Generator().manual_seed(3)
    rows = torch.randint(0, config["n_feats"], (500,), generator=gen)
    for t in (st.vec_n, st.vec_z, st.lin_n, st.lin_z, st.lin_w):
        t[rows] = torch.rand(t[rows].shape, generator=gen)
    st.vec_w[rows] += 0.01
    st.bias_n.fill_(0.5)
    st.bias_z.fill_(-0.25)

    def squares(state, mesh):
        tables = port.ProgramTables(SimpleNamespace(state=state, cfg=cfg, _mesh=mesh), config,
                                    SEED)
        return {**compare.grad_squares(tables, config), **compare.change_squares(tables)}

    want = compare.norms(squares(st, None))
    n = 4
    summed: dict = {}
    for r in range(n):
        mesh = _mesh(n, r, data)
        own = port.own_squares(squares(shard_state(st, mesh), mesh), r, mesh.data_index)
        summed = {k: summed.get(k, 0.0) + v for k, v in own.items()}
    got = compare.norms(summed)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


def test_gathered_logits_are_the_one_process_logits(two, monkeypatch):
    monkeypatch.setattr(s0, "BLOCK_ELEMENTS", BLOCK_ELEMENTS)
    cell = mesh_cell(CELLS[0], 2)
    one = dataclasses.replace(cell, chips=1, config={
        k: v for k, v in cell.config.items() if k not in port.MESH_KEYS})
    probe: dict = {}
    line = run.run_cell(one, SEED, 0.0, False, torch.device("cpu"), probe=probe)
    assert line["correct"] is True
    got = two[2][0]["prog"]
    assert sorted(got["logit_rows"].tolist()) == list(range(cell.config["eval_rows"]))
    np.testing.assert_array_equal(got["logits"], probe["prog"]["logits"][got["logit_rows"]])


def test_a_failing_rank_gives_no_line():
    t0 = time.monotonic()
    code, line = ranks.launch(mesh_cell(CELLS[0], 2), SEED, 0.2, False, device="cpu",
                              limit_s=120, fail_rank=1)
    assert code != 0 and line is None
    # rank 0, waiting in a collective for rank 1, was killed, not waited out
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("cell", CELLS)
def test_touched_rows_reference_reads_as_the_whole_table(cell):
    from benchmark import generator

    c = tiny(cell)
    data = generator.generate(c.config, c.traffic, SEED)
    args = (c.config, c.traffic["protocol"], SEED, data, torch.device("cpu"))
    part, whole = follow(*args), follow(*args, every_row=True)
    assert part["losses"] == whole["losses"]
    assert (part["eval_loss"], part["auc"]) == (whole["eval_loss"], whole["auc"])
    np.testing.assert_array_equal(part["logits"], whole["logits"])
    for key in ("grad", "change"):
        for leaf, v in whole[key].items():
            assert part[key][leaf] == pytest.approx(v, rel=1e-12, abs=0), (key, leaf)
    assert math.isfinite(compare.readings(part, whole)["grad"])


@pytest.mark.parametrize("variant", ["half", "unexchanged"])
def test_a_fault_planted_in_every_rank_is_not_correct(variant):
    from benchmark import calibrate

    got = calibrate.reading(mesh_cell(CELLS[0], 2), variant, SEED, 0.0, torch.device("cpu"))
    assert got["correct"] is False, got
