"""Device-step microbenchmark: difference-method timing of one train or eval
step of the PyTorch port (the twin of tools/profile_step.py).

Times Model.train_step on a synthetic Criteo-shaped batch (39 fields,
k=16) with the difference method: two chained runs of 4 and 16 steps,
one read-back each (the loss to the host, then torch.cuda.synchronize),
step = (t2 - t1) / 12, which cancels dispatch and read-back overhead.
Each step updates the tables the next one reads, so steps cannot overlap
or be elided.  Beside each train phase it prints the floor of
ftrl_ffm_tpu_torch/tools/roofline.py for the same shape and update kind
and the share of it the step reached.

Usage:
    python -m ftrl_ffm_tpu_torch.tools.profile_step [phase ...] [--device cpu]
phases (default: cuda infer):
    cuda     the full train step on the card's kernels (kernel #2, the
             update kernel or the in-place scatter and kernel #3); the JAX
             tool's "pallas" is an alias
    infer    the eval step (kernel #1 for FFM)
    huge     the train step at N_FEATS=1M unless N_FEATS says otherwise,
             UPDATE_MODE honoured
    trace    torch.profiler over 5 chained train steps after a warm-up;
             prints the top device ops by ms/step (CPU ops on the CPU)
    tiny     a trivial op on the device (liveness probe)
    xla      raises: the port has no switch to its plain versions on the
             card (config.py::check_ported's use_pallas=off error)
    sharded  the train step through ShardedStep on a 1x1 mesh over a
             process group of one (NCCL on the card, gloo on the CPU): the
             mesh path's own cost beside the cuda phase's
Env: BATCH (8192), N_FEATS (100000), UPDATE_MODE (auto), ACC_DTYPE
(float32), TABLE_DTYPE (float32), and the port's own MODEL (FFM; FM or LR
time those models' steps on the same batch).  The JAX tool's BLOCK_B pins
a Pallas tile size and has no counterpart.  `--device cpu` runs the plain
versions on the CPU: a check that the phases run, not a device time.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ftrl_ffm_tpu_torch.tools import split_device, synchronize
from ftrl_ffm_tpu_torch.tools import roofline
from ftrl_ffm_tpu_torch.train import resolve_device

PHASES = ("cuda", "pallas", "infer", "huge", "trace", "tiny", "xla", "sharded")


def build(use_pallas: str = "auto", update_mode: str = "auto", device: str = "cuda",
          n_feats: int = 100_000):
    """(cfg, model, state, batch) on `device`: tools/profile_step.py::build's
    model and batch.  The batch: default_rng(0), field c's ids uniform in
    [c * per, (c + 1) * per) with per = N_FEATS // 39, canonical fields,
    values 1, labels rng.random(B) > 0.5, weights 1.  The state: a fresh
    init from cfg.seed on the device.  use_pallas="off" raises, as the
    port's Trainer does."""
    from ftrl_ffm_tpu_torch.config import Config, check_ported
    from ftrl_ffm_tpu_torch.models import Batch, make_model

    b = int(os.environ.get("BATCH", 8192))
    r = int(os.environ.get("N_FEATS", n_feats))
    c, k = 39, 16
    cfg = Config(
        model_type=os.environ.get("MODEL", "FFM"), n_fields=c, n_feats=r, n_factors=k,
        batch_size=b, max_nnz=c, use_pallas=use_pallas,
        update_mode=os.environ.get("UPDATE_MODE", update_mode),
        acc_dtype=os.environ.get("ACC_DTYPE", "float32"),
        table_dtype=os.environ.get("TABLE_DTYPE", "float32"),
        device=device,
    )
    check_ported(cfg)
    dev = resolve_device(device)
    model = make_model(cfg)
    state = model.init(torch.Generator(device=dev).manual_seed(cfg.seed))
    rng = np.random.default_rng(0)
    per = r // c
    ids = rng.integers(0, per, (b, c)) + np.arange(c) * per
    batch = Batch(
        fields=torch.from_numpy(np.tile(np.arange(c, dtype=np.int32), (b, 1))).to(dev),
        feats=torch.from_numpy(ids.astype(np.int32)).to(dev),
        vals=torch.ones((b, c), dtype=torch.float32, device=dev),
        y=torch.from_numpy((rng.random(b) > 0.5).astype(np.float32)).to(dev),
        sample_w=torch.ones((b,), dtype=torch.float32, device=dev),
    )
    return cfg, model, state, batch


def update_kind(cfg) -> str:
    """The factor tables' update form of cfg's one-device step
    (ftrl.py::update_form; "dense2" for LR, which has none: its linear
    update is the touched-rows kernel at E = 0)."""
    from ftrl_ffm_tpu_torch.ftrl import update_form

    return update_form(cfg, cfg.n_feats) if cfg.row_width else "dense2"


def roofline_ms(cfg) -> float:
    """roofline.py's floor for cfg's train step at the H100's 3,350 GB/s."""
    passes = roofline.step_bytes(cfg.batch_size, cfg.max_nnz, cfg.n_fields, cfg.n_factors,
                                 cfg.n_feats, cfg.model_type, update_kind(cfg))
    return roofline.floor_ms(passes)


def _chained_ms(run) -> float:
    """(t(16) - t(4)) / 12 in ms, after two warm-up runs of one step."""
    run(1)
    run(1)
    t1, t2 = run(4), run(16)
    return (t2 - t1) / 12 * 1e3


def _train_steps_ms(step, device) -> float:
    """ms per chained call of step() -> a train step's output (the
    state's tables change in place)."""

    def run(n: int) -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = step()
        out.loss_sum.item()  # one chained read-back
        synchronize(device)
        return time.perf_counter() - t0

    return _chained_ms(run)


def time_train(cfg, model, state, batch) -> float:
    """ms per chained train step."""
    return _train_steps_ms(lambda: model.train_step(state, batch), state.lin_z.device)


def time_infer(cfg, model, state, batch) -> float:
    """ms per chained eval step: each step's input is perturbed by ~0 from
    the previous loss, so the steps depend on each other."""
    device = state.lin_z.device

    def run(n: int) -> float:
        t0 = time.perf_counter()
        ls = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n):
            loss = model.eval_step(state, batch._replace(vals=batch.vals + ls))[0]
            ls = loss * 1e-30
        ls.item()
        synchronize(device)
        return time.perf_counter() - t0

    return _chained_ms(run)


def time_sharded(cfg, model, state, batch) -> float:
    """ms per chained train step of parallel/sharded.py::ShardedStep on a
    1x1 mesh (tools/profile_step.py::time_sharded), over the run's
    process group or a group of one (parallel/dist.py::ensure_group)."""
    from ftrl_ffm_tpu_torch.parallel import ShardedStep, make_mesh, shard_state

    mesh = make_mesh(1, 1, cfg.device)
    sstate = shard_state(state, mesh)
    step = ShardedStep(cfg, mesh, model, sstate)
    return _train_steps_ms(lambda: step.train_step(sstate, batch), sstate.lin_z.device)


def trace_step(cfg, model, state, batch, steps: int = 5) -> list[tuple[str, float]]:
    """torch.profiler over `steps` chained train steps after a warm-up
    step; prints and returns the top ops by ms per step: device time of
    CUDA kernels, copies and fills on the card, CPU time on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    device = state.lin_z.device
    on_card = device.type == "cuda"
    out = model.train_step(state, batch)
    out.loss_sum.item()  # warm-up outside the trace
    synchronize(device)
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        for _ in range(steps):
            out = model.train_step(state, batch)
        out.loss_sum.item()
        synchronize(device)
    rows = []
    for e in prof.key_averages():
        us = e.device_time_total if on_card else e.self_cpu_time_total
        if us > 0:
            rows.append((e.key, us / 1e3 / steps))
    rows.sort(key=lambda r: -r[1])
    what = "device" if on_card else "CPU"
    print(f"trace: top {what} ops (ms/step over {steps} steps)")
    for name, ms in rows[:24]:
        print(f"  {ms:9.3f} ms  {name[:100]}", flush=True)
    return rows


def main(argv: Optional[list[str]] = None, device: str = "cuda") -> dict:
    """Run the phases; returns {phase: result}: for a timed phase its ms,
    and for a train phase (sharded too) also the update kind, the roofline
    floor and the share; for trace its rows."""
    phases = list(argv or ["cuda", "infer"])
    for phase in phases:
        if phase not in PHASES:
            raise SystemExit(f"unknown phase {phase!r}; phases: {' '.join(PHASES)}")
    dev = resolve_device(device)
    results: dict = {}
    for phase in phases:
        if phase == "tiny":
            t0 = time.time()
            print(float((torch.arange(2048.0, device=dev) * 1.7).sum()))
            print(f"tiny: ok in {time.time() - t0:.1f}s", flush=True)
            results[phase] = time.time() - t0
            continue
        n_feats = 1_000_000 if phase == "huge" else 100_000
        use_pallas = "off" if phase == "xla" else "auto"
        cfg, model, state, batch = build(use_pallas, device=device, n_feats=n_feats)
        if phase == "trace":
            results[phase] = trace_step(cfg, model, state, batch)
            continue
        if phase == "infer":
            ms = time_infer(cfg, model, state, batch)
            results[phase] = {"ms": ms}
            print(f"{phase}: {ms:.2f} ms/step -> {cfg.batch_size / ms * 1e3:,.0f} ex/s",
                  flush=True)
            continue
        ms = (time_sharded if phase == "sharded" else time_train)(cfg, model, state, batch)
        kind, floor = update_kind(cfg), roofline_ms(cfg)
        results[phase] = {"ms": ms, "update_kind": kind, "floor_ms": floor,
                          "share": floor / ms if dev.type == "cuda" else None}
        share = (f"{floor / ms * 100:.0f}% of it" if dev.type == "cuda"
                 else "no share: a CPU run")
        print(f"{phase}: {ms:.2f} ms/step -> {cfg.batch_size / ms * 1e3:,.0f} ex/s "
              f"({cfg.model_type} B={cfg.batch_size} R={cfg.n_feats} {kind}); roofline "
              f"floor {floor:.3f} ms at 3350 GB/s, {share}", flush=True)
        del state, model
    return results


if __name__ == "__main__":
    from ftrl_ffm_tpu_torch.parallel import dist as _dist

    _device, _argv = split_device(sys.argv[1:])
    try:
        main(_argv, _device)
    finally:
        _dist.destroy()
