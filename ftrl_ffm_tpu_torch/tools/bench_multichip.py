"""Runnable multi-card throughput harness for the port's sharded FTRL step
(the twin of tools/bench_multichip.py).

Per mesh shape DxM (data x model), one process a rank (parallel/dist.py:
NCCL on the cards, gloo on the CPU under --virtual):
  * builds the tool's FFM config with the per-rank batch --b_dev held
    constant (weak scaling over ranks) and --rows table rows (sharded
    over "model"),
  * times --steps train steps through ShardedStep.train_step (batches
    placed on the device beforehand, cycling --distinct prepared batches
    so routing sees fresh ids each step), one read-back and a
    synchronize at the end; the slowest rank's time,
  * times a collective-only probe: the route path's all_to_all legs ([M,
    K] ids there, [M, K, E] rows back, [M, K, 2E] payloads there;
    parallel/sharded.py::_route, _routed_rows, _update_routed), the
    D > 1 accumulator all_reduce over "data" ([rows_local, 2E],
    _accumulate_pass) and replicate mode's row all_reduce over "model",
  * prints measured beside the analytic model
    (ftrl_ffm_tpu_torch/tools/scaling_model.py::model_step).

Usage:
  python -m ftrl_ffm_tpu_torch.tools.bench_multichip --virtual 8   # CPU ranks
  python -m ftrl_ffm_tpu_torch.tools.bench_multichip --meshes 1x1,4x1,1x4,2x2 \\
      --b_dev 2048 --rows 100000 --steps 30                          # cards

--virtual N runs N gloo ranks on the CPU (numbers that time the CPU, not
a card); without it the ranks are the visible cards.  A shape that needs
more ranks than that prints a "# skip" line.  The last line is one JSON
object with the JAX tool's keys; on the card each row carries "device",
the card's name and power limit as nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--meshes", default="1x1,1x2,1x4,1x8,2x4",
                   help="comma list of DxM (data x model) mesh shapes")
    p.add_argument("--b_dev", type=int, default=0,
                   help="per-rank batch rows (weak scaling); default 2048 on "
                        "the card, 64 on the CPU")
    p.add_argument("--rows", type=int, default=0,
                   help="total table rows (n_feats); default 100000 on the "
                        "card, 4096 on the CPU")
    p.add_argument("--fields", type=int, default=8)
    p.add_argument("--factors", type=int, default=4)
    p.add_argument("--max_nnz", type=int, default=8)
    p.add_argument("--model", default="FFM", choices=["LR", "FM", "FFM"])
    p.add_argument("--lookup_mode", default="auto", choices=["auto", "replicate", "route"])
    p.add_argument("--steps", type=int, default=0,
                   help="timed steps; default 30 on the card, 6 on the CPU")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--distinct", type=int, default=4,
                   help="prepared batches to cycle through")
    p.add_argument("--virtual", type=int, default=0,
                   help="run N gloo ranks on the CPU")
    p.add_argument("--ar", type=float, default=370.0,
                   help="NVLink all_reduce GB/s a card for the model column (assumed)")
    p.add_argument("--a2a", type=float, default=300.0,
                   help="NVLink all_to_all GB/s a card for the model column (assumed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--_worker", default="", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _make_batches(rng, cfg, n_batches):
    """tools/bench_multichip.py::_make_batches: canonical-shaped batches,
    uniform ids, random values (the global batch; each rank takes its
    slice)."""
    import numpy as np

    b, f = cfg.batch_size, cfg.max_nnz
    out = []
    for _ in range(n_batches):
        fields = np.tile(np.arange(f, dtype=np.int32) % cfg.n_fields, (b, 1))
        feats = rng.integers(0, cfg.n_feats, (b, f)).astype(np.int32)
        vals = rng.random((b, f), dtype=np.float32)
        y = (rng.random(b) > 0.5).astype(np.float32)
        out.append((fields, feats, vals, y, np.ones(b, np.float32)))
    return out


def _probe_legs(step, cfg, mesh) -> list:
    """(name, shape, dtype, kind, group) of the step's collective legs at
    its shapes (tools/bench_multichip.py::_collective_probe's)."""
    import torch

    d, m = mesh.data, mesh.model
    e = max(1, cfg.row_width)
    legs = []
    if step.mode == "route" and m > 1:
        mk = m * step.route_k
        legs += [("a2a_ids", (mk,), torch.int32, "a2a", mesh.model_group),
                 ("a2a_rows", (mk, e), torch.float32, "a2a", mesh.model_group),
                 ("a2a_pay", (mk, 2 * e), torch.float32, "a2a", mesh.model_group)]
    if d > 1:
        legs.append(("psum_acc", (2, step.rows_local, e), torch.float32, "ar", mesh.data_group))
    if step.mode == "replicate" and m > 1:
        legs.append(("psum_lookup", (step.local_batch * cfg.max_nnz, e), torch.float32, "ar",
                     mesh.model_group))
    return legs


def _worker(spec: dict) -> None:
    """One rank of one mesh shape: joins the group, times the steps and
    the probe, and (rank 0) writes its row to spec["out"]."""
    import numpy as np
    import torch

    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.models import Batch, make_model
    from ftrl_ffm_tpu_torch.parallel import ShardedStep, dist, make_mesh, shard_state
    from ftrl_ffm_tpu_torch.tools import card_name, synchronize

    a = spec["args"]
    d, m = spec["mesh"]
    dist.initialize(spec["coord"], d * m, spec["rank"], spec["device"])
    try:
        mesh = make_mesh(d, m, spec["device"])
        cfg = Config(model_type=a["model"], n_feats=spec["rows"], n_fields=a["fields"],
                     n_factors=a["factors"], max_nnz=a["max_nnz"],
                     batch_size=spec["b_dev"] * d * m, mesh_data=d, mesh_model=m,
                     lookup_mode=a["lookup_mode"], device=spec["device"])
        model = make_model(cfg)
        state = shard_state(model.init(torch.Generator().manual_seed(cfg.seed)), mesh)
        step = ShardedStep(cfg, mesh, model, state)
        lo = step.shard_index * step.local_batch
        batches = [Batch(*(torch.from_numpy(np.ascontiguousarray(x[lo:lo + step.local_batch]))
                           .to(mesh.device) for x in arrays))
                   for arrays in _make_batches(np.random.default_rng(a["seed"]), cfg,
                                               a["distinct"])]
        dev = mesh.device

        def run(n: int, offset: int = 0) -> float:
            t0 = time.perf_counter()
            out = None
            for i in range(n):
                out = step.train_step(state, batches[(offset + i) % len(batches)])
            out.loss_sum.item()
            synchronize(dev)
            return time.perf_counter() - t0

        run(a["warmup"])
        step_s = run(spec["steps"], a["warmup"]) / spec["steps"]
        legs = _probe_legs(step, cfg, mesh)
        coll_s = 0.0
        if legs:
            bufs = [(torch.ones(shape, dtype=dt, device=dev), kind, group)
                    for _, shape, dt, kind, group in legs]

            def probe(n: int) -> float:
                t0 = time.perf_counter()
                for _ in range(n):
                    for buf, kind, group in bufs:
                        (dist.all_to_all if kind == "a2a" else dist.all_reduce)(buf, group)
                synchronize(dev)
                return time.perf_counter() - t0

            probe(1)
            n_probe = max(spec["steps"], 10)
            coll_s = probe(n_probe) / n_probe
        # the slowest rank's times
        times = dist.process_allgather(np.array([step_s, coll_s]), dev)
        step_s, coll_s = (float(x) for x in times.max(axis=0))
        if spec["rank"] == 0:
            row = {"mode": step.mode, "form": step.form, "global_batch": cfg.batch_size,
                   "step_s": step_s, "coll_s": coll_s,
                   "probe_legs": [name for name, *_ in legs]}
            if dev.type == "cuda":
                row["device"] = card_name(dev)
            with open(spec["out"], "w") as f:
                json.dump(row, f)
    finally:
        dist.destroy()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_shape(dm, args, device, b_dev, rows, steps, out_dir) -> dict:
    """Start the D*M ranks of one shape and wait for them; rank 0's row."""
    d, m = dm
    out = os.path.join(out_dir, f"mesh_{d}x{m}.json")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for r in range(d * m):
        spec = {"mesh": [d, m], "rank": r, "coord": coord, "device": device, "b_dev": b_dev,
                "rows": rows, "steps": steps, "out": out, "args": vars(args)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ftrl_ffm_tpu_torch.tools.bench_multichip",
             "--_worker", json.dumps(spec)], env=env))
    try:
        codes = [p.wait(timeout=1800) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise RuntimeError(f"mesh {d}x{m}: rank exit codes {codes}")
    with open(out) as f:
        return json.load(f)


def main(argv=None) -> dict:
    import tempfile

    import torch

    from ftrl_ffm_tpu_torch.tools.scaling_model import model_step

    args = _parse_args(argv)
    if args._worker:
        _worker(json.loads(args._worker))
        return {}
    if args.virtual:
        device, ranks = "cpu", args.virtual
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --virtual N to run N gloo ranks on the CPU")
        device, ranks = "cuda", torch.cuda.device_count()
    on_card = device == "cuda"
    b_dev = args.b_dev or (2048 if on_card else 64)
    rows = args.rows or (100_000 if on_card else 4096)
    steps = args.steps or (30 if on_card else 6)
    backend = "nccl" if on_card else "gloo"
    print(f"# backend={backend} ranks={ranks} b_dev={b_dev} rows={rows} steps={steps} "
          f"model={args.model}"
          + ("" if on_card else " [VIRTUAL: gloo ranks on the CPU, not card numbers]"),
          flush=True)
    results = []
    first_per_dev = None
    with tempfile.TemporaryDirectory() as out_dir:
        for tok in args.meshes.split(","):
            dd, mm = tok.strip().lower().split("x")
            d, m = int(dd), int(mm)
            if d * m > ranks:
                print(f"# skip {d}x{m}: needs {d * m} devices", flush=True)
                continue
            rec = _run_shape((d, m), args, device, b_dev, rows, steps, out_dir)
            step_s, coll_s = rec["step_s"], rec["coll_s"]
            ex_s = rec["global_batch"] / step_s
            per_dev = ex_s / (d * m)
            analytic = model_step(d, m, b_dev, args.max_nnz, args.factors, rows,
                                  args.ar, args.a2a)
            row = {
                "mesh": f"{d}x{m}",
                "n_dev": d * m,
                "mode": rec["mode"],
                "form": rec["form"],
                "global_batch": rec["global_batch"],
                "step_ms": round(step_s * 1e3, 3),
                "ex_s": round(ex_s),
                "ex_s_per_dev": round(per_dev),
                "coll_probe_ms": round(coll_s * 1e3, 3),
                "coll_share": round(coll_s / step_s, 4) if step_s else 0.0,
                "model_ms": round(analytic["total_ms"], 6),
            }
            if "device" in rec:
                row["device"] = rec["device"]
            if first_per_dev is None:
                first_per_dev = per_dev
            row["eff_vs_first"] = round(per_dev / first_per_dev, 4)
            results.append(row)
            print(f"{row['mesh']:>5} mode={row['mode']:<9} step={row['step_ms']:>9.3f}ms  "
                  f"ex/s={row['ex_s']:>10,}  per-dev={row['ex_s_per_dev']:>9,}  "
                  f"eff={row['eff_vs_first']:>6.2%}  coll={row['coll_probe_ms']:>7.3f}ms "
                  f"({row['coll_share']:.1%})  model={row['model_ms']:>8.3f}ms", flush=True)
    rep = {"harness": "bench_multichip", "backend": backend, "b_dev": b_dev, "rows": rows,
           "steps": steps, "virtual": not on_card, "meshes": results}
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
