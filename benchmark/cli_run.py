"""A cell's configuration run through the program's own CLI (python -m
ftrl_ffm_tpu_torch), not through the harness: one process a card, on the
rows the harness writes for the seed, one offline epoch and an eval pass
from the program's own init.

    python3 -m benchmark.cli_run --workload <cell> --seed <n> [--root DIR] [--cpu]

--root is the checkout whose package runs (default this one); --cpu runs a
tiny sibling of the configuration (4,096 rows, B=256) over gloo ranks.
Prints the command, then each rank's output and a line "RANK {json}": its
exit (a code, or the exception that ended it), its peak device memory and
its seconds; exits non-zero where a rank did.  Nothing here is timed for
the benchmark."""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

from benchmark import generator, spec

ROOT = spec.ROOT
TINY = dict(n_feats=4096, batch_size=256, train_rows=1024, eval_rows=512)
# each rank: the CLI's main in this process, then its peak memory
RANK = r"""
import json, sys, time, traceback
rank, argv = int(sys.argv[1]), json.loads(sys.argv[2])
import torch
from ftrl_ffm_tpu_torch.cli import main
t0 = time.time()
try:
    code = main(argv)
except BaseException as e:
    traceback.print_exc()
    code = repr(e)[:400]
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
print("RANK " + json.dumps({"rank": rank, "exit": code, "peak_bytes": peak,
                            "seconds": time.time() - t0}), flush=True)
sys.exit(0 if code == 0 else 1)
"""


def cli_args(config: dict, train: str, eval_: str, seed: int, port: int) -> list:
    """The CLI's flags for the configuration (without --process_id)."""
    p = config["ftrl"]
    flags = dict(train_data=train, eval_data=eval_, model_type=config["model_type"],
                 n_fields=config["n_fields"], n_feats=config["n_feats"],
                 n_factors=config["n_factors"], batch_size=config["batch_size"],
                 max_nnz=config["n_fields"], online="false", n_epochs=1,
                 n_threads=config["n_threads"], seed=seed, init_mean=config["init_mean"],
                 init_stddev=config["init_stddev"], w_alpha=p["alpha"], w_beta=p["beta"],
                 w_l1=p["l1"], w_l2=p["l2"], table_dtype=config["table_dtype"],
                 mesh_data=config["mesh_data"], mesh_model=config["mesh_model"],
                 lookup_mode=config["lookup_mode"],
                 coordinator_address=f"localhost:{port}",
                 num_processes=config["mesh_data"] * config["mesh_model"])
    return [x for k, v in flags.items() for x in (f"--{k}", str(v))]


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--limit_s", type=float, default=420.0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    config = dict(cell.config, **(TINY if args.cpu else {}))
    tmp = tempfile.mkdtemp(prefix="cli-run-")
    paths = [os.path.join(tmp, f"{role}.ffm") for role in ("train", "eval")]
    data = generator.generate(config, cell.traffic, args.seed)
    generator.write_libffm(paths[0], data.train_ids, data.train_y, config)
    generator.write_libffm(paths[1], data.eval_ids, data.eval_y, config)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    flags = cli_args(config, *paths, args.seed, port) + (["--device", "cpu"] if args.cpu else [])
    print("command: python -m ftrl_ffm_tpu_torch " + " ".join(flags) + " --process_id <i>",
          flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(args.root))
    n = config["mesh_data"] * config["mesh_model"]
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               json.dumps(flags + ["--process_id", str(r)])],
                              env=env, cwd=os.path.abspath(args.root), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    deadline = time.monotonic() + args.limit_s
    code = 0
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0] + "\n(killed at the time limit)"
        code = code or p.returncode
        print(f"--- rank {r} (exit {p.returncode}) ---\n{out[-6000:]}", flush=True)
    for path in paths:
        os.remove(path)
    os.rmdir(tmp)
    return code


if __name__ == "__main__":
    sys.exit(main())
