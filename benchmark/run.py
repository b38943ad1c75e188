"""One run of one benchmark cell of ftrl_ffm_tpu_torch on the card(s) of
this machine:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A cell (an entry of BENCHMARK.json's
"workloads") names a configuration (benchmark/configs/<name>.json) and a
traffic mix (benchmark/traffic/<name>.json); its limits are
benchmark/limits/<cell>.json and each metric is read by
benchmark/metrics/<metric>.py, all found by name.

Set-up (timed from the top of this module, `setup_s`): the rows from the
seed (benchmark/generator.py), written as libffm text to a temporary
directory; a Trainer from S0 (benchmark/state.py); both datasets parsed
and made resident (`resident_build_s`; the text is removed then); one
evaluate() on S0 and one warm-up train_epoch(), whose first steps the
check watches (port.FirstSteps), with one evaluate() after them.  The window then
alternates train_epoch() and evaluate(), each closed by a synchronize,
until --seconds have passed; the call running at the deadline finishes.
With --trace 1 the window's last two train epochs and eval passes run
under torch.profiler.  After the window: the peak memory, the state
freed, the plain reference's steps (benchmark/reference/), the
comparison (benchmark/compare.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 breakdown, then card (the card's
name and power limit) and checks (each compared number and its limit),
which also close standard error.  No card, too few cards, a cell on more
than one card, or a module of JAX loaded: no line, and a non-zero exit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
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

from benchmark import compare, generator, port, spec  # noqa: E402
from benchmark import trace as tracing  # noqa: E402
from benchmark.floors import unique_rows  # noqa: E402
from benchmark.reference.follow import epoch_orders, follow  # noqa: E402

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


def _timed(role: str, fn, device, rec: dict, examples: int, steps: int, **extra):
    t0 = time.perf_counter()
    with tracing.span(role):
        fn()
        port.synchronize(device)
    rec["calls"].append({"role": role, "seconds": time.perf_counter() - t0,
                         "examples": examples, "steps": steps, **extra})


def window(trainer, cfg: dict, seconds: float, trace: bool, device, rec: dict) -> None:
    """Alternate train_epoch() and evaluate() for `seconds`.  With trace,
    the last TRACED_PAIRS pairs run under the profiler, started once the
    time left would hold them at the pace of the pairs so far, and the
    window ends with them; the launch counts of their train epochs are
    read."""
    n_tr, n_ev, b = cfg["train_rows"], cfg["eval_rows"], cfg["batch_size"]
    steps_tr, steps_ev = -(-n_tr // b), -(-n_ev // b)
    reset, read = port.launch_counter()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    epoch, pairs, prof, traced = 1, 0, None, 0
    launches = 0
    while True:
        if trace and prof is None and pairs and (
                time.perf_counter() + (TRACED_PAIRS + 0.5) * (time.perf_counter() - t0) / pairs
                >= deadline):
            prof = tracing.start()
        epoch += 1
        if prof is not None:
            reset()
        _timed("train", trainer.train_epoch, device, rec, n_tr, steps_tr, epoch=epoch,
               traced=prof is not None)
        if prof is not None:
            launches += read()
        _timed("eval", trainer.evaluate, device, rec, n_ev, steps_ev, traced=prof is not None)
        pairs += 1
        if prof is not None:
            traced += 1
            if traced == TRACED_PAIRS:
                rec["trace"] = tracing.stop(prof)
                prof = None
                rec["launches_train"] = {"launches": launches, "steps": TRACED_PAIRS * steps_tr}
        if ("trace" in rec) if trace else time.perf_counter() >= deadline:
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
             variant: dict | None = None, plant=None, t_start: float | None = None) -> dict:
    """One run of `cell`: the result line's object.  `variant` overrides
    fields of the program's Config and `plant` is called with the Trainer
    before its first step (the control and the planted faults of
    benchmark/calibrate.py and the tests); a run of the benchmark passes
    neither."""
    t_start = T_START if t_start is None else t_start
    cfg = cell.config
    rec: dict = {"config": cfg, "calls": []}
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    phases = rec["setup_phases"] = {"imports": T_IMPORTED - T_START}
    t = time.perf_counter()
    data = generator.generate(cfg, cell.traffic, seed)
    phases["generate"] = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="bench-data-")
    try:
        t = time.perf_counter()
        paths = [os.path.join(tmp, f"{role}.ffm") for role in ("train", "eval")]
        generator.write_libffm(paths[0], data.train_ids, data.train_y, cfg)
        generator.write_libffm(paths[1], data.eval_ids, data.eval_y, cfg)
        phases["write"] = time.perf_counter() - t
        t = time.perf_counter()
        trainer, rec["resident_build_s"] = port.build(cfg, cell.traffic, *paths, seed, device,
                                                      variant)
        phases["trainer_and_resident"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if plant is not None:
        plant(trainer)
    first = port.FirstSteps(trainer, cfg, seed)
    t = time.perf_counter()
    first.start_eval()
    trainer.train_epoch()
    port.synchronize(device)
    phases["warmup_epoch_and_eval"] = time.perf_counter() - t - first.check_s
    if not first.done:
        raise RuntimeError("the first epoch ended before the checked steps")
    rec["setup_s"] = time.perf_counter() - t_start - first.check_s
    window(trainer, cfg, seconds, trace, device, rec)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog = first.readings()
    del trainer, first
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        rec["unique_rows"] = _unique_rows(rec, data, cfg, cell.traffic["protocol"], seed,
                                          device)
    ref = follow(cfg, cell.traffic["protocol"], seed, data, device)
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
            "count": 1,
            "memory_peak_bytes": memory_peak,
        },
    }
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


def _unique_rows(rec: dict, data, cfg: dict, protocol: dict, seed: int, device) -> dict:
    """U of every step of the window's passes: {("train", epoch): [steps],
    ("eval", 0): [steps]} (the eval pass runs in file order)."""
    b = cfg["batch_size"]
    out = {}
    wanted = {c["epoch"] for c in rec["calls"] if c["role"] == "train"}
    ids = torch.as_tensor(data.train_ids, device=device)
    orders = epoch_orders(protocol, seed, cfg["train_rows"], max(wanted))
    for epoch, order in enumerate(orders, 1):
        if epoch in wanted:
            out[("train", epoch)] = unique_rows(ids, order, b)
    del ids
    ev = torch.as_tensor(data.eval_ids, device=device)
    out[("eval", 0)] = unique_rows(ev, None, b)
    return out


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
    if cell.chips != 1:
        print(f"error: the harness runs one process on one card; {cell.name} asks for "
              f"{cell.chips}", file=sys.stderr)
        return 3
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
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


def _plain(x):
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"not JSON: {type(x)}")


if __name__ == "__main__":
    sys.exit(main())
