"""The readings that a cell's limits (benchmark/limits/<cell>.json) are set
from: the compared numbers of sound runs over many seeds, of the
lower-precision control, and of planted faults, all in one process.

    python3 -m benchmark.calibrate --workload <cell> --variant <v>[,<v>...] --seeds <a>,<b>,...

Variants:
  sound      the program as the configuration states it;
  control    the program's own lower-precision path: bfloat16 weight
             table and bfloat16 gradient payload (Config.table_dtype,
             acc_dtype) where the configuration states float32;
  half       a planted fault: every train step leaves out the second
             half of its batch (sample weight 0), its mean loss taken over
             the rest;
  altered    a planted fault: every eval step's first logit is raised by
             1 where the model produces it;
  unchanged  a planted fault: every train step computes on a copy of the
             state and returns the state as it was (it reads 1 by the
             change's measure; kept for the tests at small sizes);
  unexchanged  a planted fault on a mesh: the exchange between the cards
             is left out, every all_to_all of the program (the route's
             requests, rows and payloads) returning what the rank sent.

Each run is a whole run of the cell (benchmark/run.py's run_cell) with a
window of --seconds (default 0: one train epoch and eval pass); a cell
on more than one card runs through benchmark/ranks.py's launcher, one
process a rank, as the benchmark's own runs do, its faults planted in
every rank's sharded step.  One JSON line a run: the variant, the seed
and each compared number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import ranks, run, spec

CONTROL = {"table_dtype": "bfloat16", "acc_dtype": "bfloat16"}


def _stepper(trainer):
    """What runs the Trainer's steps: its model, or on a mesh its sharded
    step (the same train_step and eval_step calls)."""
    return trainer.model if trainer._sharded is None else trainer._sharded


def plant_half(trainer) -> None:
    owner = _stepper(trainer)
    step = owner.train_step

    def half(state, batch):
        sw = batch.sample_w.clone()
        sw[..., sw.shape[-1] // 2:] = 0
        return step(state, batch._replace(sample_w=sw))

    owner.train_step = half


def plant_altered(trainer) -> None:
    owner = _stepper(trainer)
    step = owner.eval_step

    def altered(state, batch, *rest):
        ls, ct, logits, *more = step(state, batch, *rest)
        logits = logits.clone()
        logits[0] += 1.0
        return (ls, ct, logits, *more)

    owner.eval_step = altered


def plant_unchanged(trainer) -> None:
    owner = _stepper(trainer)
    step = owner.train_step

    def unchanged(state, batch):
        copy = type(state)(*(None if t is None else t.clone() for t in state))
        return step(copy, batch)._replace(state=state)

    owner.train_step = unchanged


def plant_unexchanged(trainer) -> None:
    # the module of the program's counted collectives, as the sharded step
    # reads it at each call
    comm = sys.modules[type(trainer._sharded).__module__].dist
    comm.all_to_all = lambda t, group=None: t.clone()


VARIANTS = {
    "sound": (None, None),
    "control": (CONTROL, None),
    "half": (None, plant_half),
    "altered": (None, plant_altered),
    "unchanged": (None, plant_unchanged),
    "unexchanged": (None, plant_unexchanged),
}


def reading(cell: spec.Cell, variant: str, seed: int, seconds: float, device) -> dict:
    """One run's compared numbers, `correct`, its end-to-end metrics and
    its set-up's phases."""
    if cell.chips > 1:
        code, line = ranks.launch(cell, seed, seconds, False, variant=variant,
                                  device=device.type)
        if line is None:
            raise RuntimeError(f"{variant} run on seed {seed} failed (exit {code})")
    else:
        over, plant = VARIANTS[variant]
        line = run.run_cell(cell, seed, seconds, False, device, variant=over, plant=plant,
                            t_start=time.perf_counter())
    return {"variant": variant, "seed": seed, "correct": line["correct"],
            **{k: c["value"] for k, c in line["checks"].items()},
            **{k: m["value"] for k, m in line["metrics"].items()},
            "setup_phases": line["setup_phases"]}


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="sound")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for variant in args.variant.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(reading(cell, variant, seed, args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
