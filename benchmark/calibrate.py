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
             change's measure; kept for the tests at small sizes).

Each run is a whole run of the cell (benchmark/run.py's run_cell) with a
window of --seconds (default 0: one train epoch and eval pass).  One
JSON line a run: the variant, the seed and each compared number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import compare, run, spec

CONTROL = {"table_dtype": "bfloat16", "acc_dtype": "bfloat16"}


def plant_half(trainer) -> None:
    step = trainer.model.train_step

    def half(state, batch):
        sw = batch.sample_w.clone()
        sw[..., sw.shape[-1] // 2:] = 0
        return step(state, batch._replace(sample_w=sw))

    trainer.model.train_step = half


def plant_altered(trainer) -> None:
    step = trainer.model.eval_step

    def altered(state, batch):
        ls, ct, logits = step(state, batch)
        logits = logits.clone()
        logits[0] += 1.0
        return ls, ct, logits

    trainer.model.eval_step = altered


def plant_unchanged(trainer) -> None:
    step = trainer.model.train_step

    def unchanged(state, batch):
        copy = type(state)(*(None if t is None else t.clone() for t in state))
        return step(copy, batch)._replace(state=state)

    trainer.model.train_step = unchanged


VARIANTS = {
    "sound": (None, None),
    "control": (CONTROL, None),
    "half": (None, plant_half),
    "altered": (None, plant_altered),
    "unchanged": (None, plant_unchanged),
}


def reading(cell: spec.Cell, variant: str, seed: int, seconds: float, device) -> dict:
    """One run's compared numbers, `correct`, its end-to-end metrics and
    its set-up's phases."""
    over, plant = VARIANTS[variant]
    line = run.run_cell(cell, seed, seconds, False, device, variant=over, plant=plant,
                        t_start=time.perf_counter())
    return {"variant": variant, "seed": seed, "correct": line["correct"],
            **{k: line["checks"][k]["value"] for k in compare.NAMES},
            **{k: m["value"] for k, m in line["metrics"].items()},
            "setup_phases": line["setup_phases"]}


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="sound")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    for variant in args.variant.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(reading(cell, variant, seed, args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
