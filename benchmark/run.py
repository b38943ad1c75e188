"""One run of one benchmark cell of ftrl_ffm_tpu_torch on the card(s) of
this machine:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A cell (an entry of BENCHMARK.json's
"workloads") names a configuration (benchmark/configs/<name>.json) and a
traffic mix (benchmark/traffic/<name>.json); its limits are
benchmark/limits/<cell>.json and each metric is read by
benchmark/metrics/<metric>.py, all found by name.

A cell on N > 1 cards runs as N processes, one a card (benchmark/ranks.py:
the program's process group, a mesh from the configuration's mesh_data,
mesh_model, lookup_mode and route_capacity); this process starts them and
prints rank 0's line.  A cell on one card runs here, in one process with
no process group.

Set-up (timed from the top of this module, `setup_s`): the rows from the
seed (benchmark/generator.py), written as libffm text to a temporary
directory (on a mesh by rank 0, for every rank); a Trainer from S0
(benchmark/state.py; on a mesh each rank's own rows of it); both datasets
parsed and made resident (`resident_build_s`; the text is removed then); one
evaluate() on S0 and one warm-up train_epoch(), whose first steps the
check watches (port.FirstSteps), with one evaluate() after them.  The window then
alternates train_epoch() and evaluate(), each closed by a synchronize,
until --seconds have passed; the call running at the deadline finishes.
On a mesh each call ends with a barrier of every rank, so that its time is
the slowest rank's, and rank 0's clock decides when the window ends.
With --trace 1 the window's last two train epochs and eval passes run
under torch.profiler (on a mesh on every rank; the metrics read rank 0's
trace and counters).  After the window: the peak memory (on a mesh the
fullest rank's, and each rank's), the state freed, the plain reference's
steps (benchmark/reference/; on a mesh on rank 0, once the other ranks
have ended), the comparison (benchmark/compare.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 breakdown, then card (the card's
name and power limit) and checks (each compared number and its limit),
which also close standard error.  No card, too few cards, a rank that
fails or outlasts its limit, or a module of JAX loaded (in any rank):
no line, and a non-zero exit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's build and kernel caches: fixed directories of the checkout,
# so that only a checkout's first run builds
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("FTRL_FFM_TPU_TORCH_NATIVE_CACHE", "native"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_IMPORTED = time.perf_counter()

from benchmark import compare, generator, port, ranks, spec  # noqa: E402
from benchmark import trace as tracing  # noqa: E402
from benchmark.floors import unique_rows  # noqa: E402
from benchmark.reference.follow import epoch_steps, follow, slice_counts  # noqa: E402

# modules the process that prints the result may not hold (top-level
# names compared whole: ftrl_ffm_tpu_torch is not ftrl_ffm_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "ftrl_ffm_tpu")
# the traced sub-window: this many train epochs and eval passes
TRACED_PAIRS = 2


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
        return out[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _timed(role: str, fn, device, rec: dict, examples: int, steps: int, group, **extra):
    t0 = time.perf_counter()
    with tracing.span(role):
        fn()
        port.synchronize(device)
        if group is not None:
            group.barrier()
    rec["calls"].append({"role": role, "seconds": time.perf_counter() - t0,
                         "examples": examples, "steps": steps, **extra})


def window(trainer, cfg: dict, seconds: float, trace: bool, device, rec: dict,
           group=None) -> None:
    """Alternate train_epoch() and evaluate() for `seconds`.  With trace,
    the last TRACED_PAIRS pairs run under the profiler, started once the
    time left would hold them at the pace of the pairs so far, and the
    window ends with them; the launch counts of their train epochs are
    read.  On a mesh rank 0 decides both, and every rank follows."""
    agree = (lambda flag: flag) if group is None else group.agree
    n_tr, n_ev, b = cfg["train_rows"], cfg["eval_rows"], cfg["batch_size"]
    steps_tr, steps_ev = -(-n_tr // b), -(-n_ev // b)
    reset, read = port.launch_counter()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    epoch, pairs, prof, traced = 1, 0, None, 0
    launches = 0
    while True:
        if trace and prof is None and pairs and agree(
                time.perf_counter() + (TRACED_PAIRS + 0.5) * (time.perf_counter() - t0) / pairs
                >= deadline):
            prof = tracing.start()
        epoch += 1
        if prof is not None:
            reset()
        _timed("train", trainer.train_epoch, device, rec, n_tr, steps_tr, group, epoch=epoch,
               traced=prof is not None)
        if prof is not None:
            launches += read()
        _timed("eval", trainer.evaluate, device, rec, n_ev, steps_ev, group,
               traced=prof is not None)
        pairs += 1
        if prof is not None:
            traced += 1
            if traced == TRACED_PAIRS:
                rec["trace"] = tracing.stop(prof, read=group is None or group.rank == 0)
                prof = None
                rec["launches_train"] = {"launches": launches, "steps": TRACED_PAIRS * steps_tr}
        if ("trace" in rec) if trace else agree(time.perf_counter() >= deadline):
            break
    rec["window_s"] = time.perf_counter() - t0


def load_metric(name: str):
    """benchmark/metrics/<name>.py's read(rec)."""
    import importlib.util

    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             variant: dict | None = None, plant=None, t_start: float | None = None,
             group=None, probe: dict | None = None) -> dict | None:
    """One run of `cell`: the result line's object.  `variant` overrides
    fields of the program's Config and `plant` is called with the Trainer
    before its first step (the control and the planted faults of
    benchmark/calibrate.py and the tests); a run of the benchmark passes
    neither.  On a mesh (`group`: benchmark/ranks.py) every rank calls
    this on its own card, and rank 0 alone gets the line (the others
    None).  `probe`, where given, receives what the tests read: the S0
    that the build left in the program's factor weight table, the largest
    tensor the build made (ranks.LargestTensor) and the program's
    readings."""
    t_start = T_START if t_start is None else t_start
    cfg = cell.config
    lead = group is None or group.rank == 0
    rec: dict = {"config": cfg, "calls": [], "cards": cell.chips}
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    phases = rec["setup_phases"] = {"imports": T_IMPORTED - T_START}
    data = tmp = None
    if lead:
        t = time.perf_counter()
        data = generator.generate(cfg, cell.traffic, seed)
        phases["generate"] = time.perf_counter() - t
        tmp = tempfile.mkdtemp(prefix="bench-data-")
    try:
        paths = None
        if lead:
            t = time.perf_counter()
            paths = [os.path.join(tmp, f"{role}.ffm") for role in ("train", "eval")]
            generator.write_libffm(paths[0], data.train_ids, data.train_y, cfg)
            generator.write_libffm(paths[1], data.eval_ids, data.eval_y, cfg)
            phases["write"] = time.perf_counter() - t
        if group is not None:
            paths = group.share(paths)
        t = time.perf_counter()
        reset_counters, read_counters = port.counters()
        reset_counters()
        with contextlib.nullcontext() if probe is None else ranks.LargestTensor() as watch:
            trainer, rec["resident_build_s"] = port.build(cfg, cell.traffic, *paths, seed,
                                                          device, variant, mesh=group is not None)
        rec["counters_build"] = read_counters()
        phases["trainer_and_resident"] = time.perf_counter() - t
        if group is not None:
            group.barrier()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if probe is not None:
        probe["s0_vec_w"] = trainer.state.vec_w.detach().cpu().clone()
        probe["build_largest_bytes"] = watch.largest
    if plant is not None:
        plant(trainer)
    first = port.FirstSteps(trainer, cfg, seed, group)
    t = time.perf_counter()
    first.start_eval()
    trainer.train_epoch()
    port.synchronize(device)
    if group is not None:
        group.barrier()
    phases["warmup_epoch_and_eval"] = time.perf_counter() - t - first.check_s
    if not first.done:
        raise RuntimeError("the first epoch ended before the checked steps")
    rec["setup_s"] = time.perf_counter() - t_start - first.check_s
    window(trainer, cfg, seconds, trace, device, rec, group)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec["counters"] = read_counters()
    offsets = _eval_offsets(cfg, data, cell.chips) if lead else None
    prog = first.readings(offsets)
    peaks = [memory_peak] if group is None else group.gather(memory_peak)
    del trainer, first
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if group is not None:
        port.leave()
    if probe is not None:
        probe["prog"] = prog
    if not lead:
        return None
    if trace:
        rec["unique_rows"] = _unique_rows(rec, data, cfg, cell.traffic["protocol"], seed,
                                          device, cell.chips)
    ref = follow(cfg, cell.traffic["protocol"], seed, data, device, cell.chips)
    ok, checks = compare.judge(compare.readings(prog, ref), cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {
        "correct": ok,
        "attempted": sum(c["steps"] for c in rec["calls"]),
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": max(peaks),
        },
    }
    if group is not None:
        line["device"]["memory_peak_bytes_by_rank"] = peaks
    if trace:
        busy, wall = tracing.busy_us(rec["trace"])
        line["device"].update(busy_s=busy * 1e-6, window_s=wall * 1e-6)
        line["breakdown"] = tracing.breakdown(rec["trace"])
    line["card"] = card_line() if device.type == "cuda" else "cpu"
    line["setup_phases"] = rec["setup_phases"]
    line["window_calls"] = {
        role: [round(q, 6) for q in statistics.quantiles(
            [c["seconds"] for c in rec["calls"] if c["role"] == role], n=4)]
        + [sum(c["role"] == role for c in rec["calls"])]
        for role in ("train", "eval")
        if sum(c["role"] == role for c in rec["calls"]) > 1}
    line["checks"] = checks
    return line


def _eval_offsets(cfg: dict, data, chips: int) -> list:
    """The first eval row of each slice of the eval file (benchmark/
    reference/follow.py's partition)."""
    counts = slice_counts(cfg, data.eval_ids, chips)
    return [int(x) for x in np.concatenate([[0], np.cumsum(counts)[:-1]])]


def _unique_rows(rec: dict, data, cfg: dict, protocol: dict, seed: int, device,
                 chips: int) -> dict:
    """(rows, distinct rows) of every global step of the window's passes,
    keyed ("train", epoch) or ("eval", 0) (the eval pass runs in file
    order)."""
    b = cfg["batch_size"]

    def steps_of(ids, steps) -> list:
        return list(zip((steps >= 0).sum(1).tolist(), unique_rows(ids, steps).tolist()))

    out = {}
    wanted = {c["epoch"] for c in rec["calls"] if c["role"] == "train"}
    ids = torch.as_tensor(data.train_ids, device=device)
    passes = epoch_steps(protocol, seed, slice_counts(cfg, data.train_ids, chips), b,
                         max(wanted))
    for epoch, steps in enumerate(passes, 1):
        if epoch in wanted:
            out[("train", epoch)] = steps_of(ids, steps)
    del ids
    ev = torch.as_tensor(data.eval_ids, device=device)
    (steps,) = epoch_steps({}, seed, slice_counts(cfg, data.eval_ids, chips), b, 1)
    out[("eval", 0)] = steps_of(ev, steps)
    return out


def emit(line: dict) -> int:
    """Print a result: the set-up's phases, the window's calls and each
    compared number beside its limit on standard error, then the line;
    a non-zero exit, and no line, where a module of JAX is loaded."""
    found = forbidden_modules()
    if found:
        print(f"error: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 4
    print(f"setup phases (s): {json.dumps(line['setup_phases'])}", file=sys.stderr)
    print(f"window calls (s): {json.dumps(line['window_calls'])}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, default=_plain), flush=True)
    return 0


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    if cell.chips == 1:
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    else:
        code, line = ranks.launch(cell, args.seed, args.seconds, bool(args.trace))
        if line is None:
            return code
    return emit(line)


def _plain(x):
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"not JSON: {type(x)}")


if __name__ == "__main__":
    sys.exit(main())
