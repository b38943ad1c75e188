"""A cell on more than one card: one process a rank, each on its own card.

`launch` starts the cell's N ranks as `python -m benchmark.ranks <spec>
<rank>` on a free local port, waits for them and returns rank 0's result
line.  Each rank joins the program's process group (NCCL on the card, gloo
on the CPU) and a gloo group of the harness's own (`Group`), then runs
benchmark/run.py's run_cell on card `rank`; rank 0 alone runs the plain
reference and writes the line.  If a rank exits with another code than
0, or the ranks outlast the time limit, every rank is killed and there is
no line.

What the ranks share goes through `Group`, on the host: the window's
decisions (rank 0's clock decides when to trace and when to stop, and
every rank follows), a barrier after each timed call (so that its time is
the slowest rank's), the check's sums of squares and logits, and each
rank's peak memory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the ranks of one run are killed after this many seconds: under the
# first run's allowance of 1200 s, which builds the kernels
LIMIT_S = 1100.0
# the tail of a failed rank's standard error that is passed on
TAIL = 4000


class Group:
    """The harness's view of the ranks: this rank, their number, and a gloo
    group over the host for the harness's exchanges, apart from the
    program's group (whose collectives it does not disturb)."""

    def __init__(self, rank: int, size: int):
        self.rank, self.size = rank, size
        self.pg = dist.new_group(backend="gloo")

    def agree(self, flag: bool) -> bool:
        """Rank 0's flag, on every rank."""
        t = torch.tensor([int(flag)])
        dist.broadcast(t, 0, group=self.pg)
        return bool(t.item())

    def share(self, obj):
        """Rank 0's object, on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, 0, group=self.pg)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.pg)

    def sum(self, values: dict) -> dict:
        """Every rank's numbers summed by key, in float64, on every rank."""
        keys = sorted(values)
        t = torch.tensor([values[k] for k in keys], dtype=torch.float64)
        dist.all_reduce(t, group=self.pg)
        return dict(zip(keys, t.tolist()))

    def gather(self, obj) -> list | None:
        """Every rank's object in rank order on rank 0; None elsewhere."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.pg)
        return out


class LargestTensor(TorchDispatchMode):
    """While on, the bytes of the largest storage of any tensor that an
    operation of this thread made (what the tests read of a build)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.untyped_storage().nbytes())
        return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def _read(path: str, tail: bool) -> str:
    with open(path, errors="replace") as f:
        text = f.read()
    return text[-TAIL:] if tail else text


def launch(cell, seed: int, seconds: float, trace: bool, variant: str | None = None,
           device: str = "cuda", limit_s: float = LIMIT_S, probe_dir: str | None = None,
           fail_rank: int | None = None,
           block_elements: int | None = None) -> tuple[int, dict | None]:
    """(exit code, rank 0's result line or None): one run of `cell` (a
    spec.Cell) on cell.chips ranks.  `variant` names a variant of
    benchmark/calibrate.py; `device` "cpu" runs the ranks over gloo on the
    CPU.  For the tests: `probe_dir` has each rank write what they read
    (rank<r>.pt), `fail_rank` makes that rank raise once it has joined
    the group, and `block_elements` sets S0's block size
    (benchmark/state.py) in every rank.  The ranks' standard error is
    passed on, rank 0's last."""
    t_wall = time.time()
    n = cell.chips
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump({"cell": dataclasses.asdict(cell), "seed": int(seed), "seconds": seconds,
                       "trace": bool(trace), "variant": variant, "device": device,
                       "world": n, "coordinator": f"127.0.0.1:{_free_port()}",
                       "t_start_wall": t_wall, "probe_dir": probe_dir,
                       "fail_rank": fail_rank, "block_elements": block_elements,
                       "out": os.path.join(tmp, "line.json")}, f)
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
        procs, errs = [], []
        try:
            for r in range(n):
                errs.append(os.path.join(tmp, f"rank{r}.err"))
                with open(errs[-1], "w") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "benchmark.ranks", spec_path, str(r)],
                        cwd=ROOT, env=env, stdin=subprocess.DEVNULL, stdout=err, stderr=err,
                        start_new_session=True))
            deadline = time.monotonic() + limit_s
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            _kill(procs)
        codes = [p.returncode for p in procs]
        for r in [*range(1, n), 0]:
            sys.stderr.write(f"--- rank {r} (exit {codes[r]}) ---\n{_read(errs[r], codes[r])}")
        sys.stderr.flush()
        if any(codes):
            print(f"error: rank exit codes {codes} (killed where the others failed or the "
                  f"{limit_s:.0f} s limit passed)", file=sys.stderr)
            return next((c for c in codes if c and c > 0), 5), None
        with open(os.path.join(tmp, "line.json")) as f:
            return 0, json.load(f)


def rank_main(spec_path: str, rank: int) -> int:
    """One rank of a launched run."""
    from benchmark import calibrate, port, run, spec
    from benchmark import state as s0

    with open(spec_path) as f:
        sp = json.load(f)
    if sp["block_elements"]:
        s0.BLOCK_ELEMENTS = sp["block_elements"]
    device = torch.device("cuda", rank) if sp["device"] == "cuda" else torch.device("cpu")
    # the launcher's start, on this process's clock
    t_start = time.perf_counter() - (time.time() - sp["t_start_wall"])
    port.join(sp["coordinator"], sp["world"], rank, device)
    group = Group(rank, sp["world"])
    if sp["fail_rank"] == rank:
        raise RuntimeError(f"rank {rank} fails as the launch asked")
    over, plant = calibrate.VARIANTS[sp["variant"] or "sound"]
    probe = {} if sp["probe_dir"] else None
    line = run.run_cell(spec.Cell(**sp["cell"]), sp["seed"], sp["seconds"], sp["trace"], device,
                        variant=over, plant=plant, t_start=t_start, group=group, probe=probe)
    found = run.forbidden_modules()
    if found:
        print(f"error: modules of JAX or the JAX package loaded in rank {rank}: {found}",
              file=sys.stderr)
        return 4
    if probe is not None:
        torch.save(probe, os.path.join(sp["probe_dir"], f"rank{rank}.pt"))
    if rank == 0:
        with open(sp["out"], "w") as f:
            json.dump(line, f, default=run._plain)
    return 0


if __name__ == "__main__":
    from benchmark import ranks

    sys.exit(ranks.rank_main(sys.argv[1], int(sys.argv[2])))
