#!/usr/bin/env python
"""csv -> libsvm / libffm converter with negative sampling, without pandas:
the twin of tools/generate_data.py (whose docstring lists what it does,
after the reference's python/generate_data.py:160-333), with the same
flags, the same np.random.default_rng(seed) draws in the same order, and
the same output bytes for the same csv and seed.

The csv is read with the csv module, and each column takes the dtype
that pandas.read_csv's default inference gives it: int64 where every
value is an integer, float64 where every value is a number or one of
pandas' missing-value words (NaN), bool for True/False columns, and
strings otherwise (missing values NaN).  Numbers are read by Python's
correctly rounded float(); blank lines are skipped and short rows padded
with missing values, as pandas does.  Categorical vocabularies sort as
numpy sorts those dtypes (integers by value, strings by code point).

MinMax-normalized numeric columns print with 4 decimals, so their values
reach the trainer as 6-decimal fixed point: the DEC6 transfer tier's
data (ftrl_ffm_tpu_torch/transfer.py).

    python -m ftrl_ffm_tpu_torch.tools.generate_data --data_path ratings.csv \\
        --train_output_path train.ffm --eval_output_path eval.ffm \\
        --cat_cols 0,1 --num_cols 2 --neg_sampling true --num_neg 2 --ffm true
"""

from __future__ import annotations

import argparse
import csv
import re
import sys
import time

import numpy as np

# pandas.read_csv's default missing-value words (its na_values)
NA_WORDS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\s*|\s*[+-]?(inf|Inf|INF|infinity|Infinity)\s*")
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
         "false": False}


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("true", "1", "yes"):
        return True
    if str(v).lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="generate libsvm or libffm data")
    p.add_argument("--data_path", default="", help="single csv, split by train_frac")
    p.add_argument("--train_path", default="")
    p.add_argument("--eval_path", default="")
    p.add_argument("--train_output_path", required=True)
    p.add_argument("--eval_output_path", required=True)
    p.add_argument("--train_frac", type=float, default=0.8)
    p.add_argument("--threshold", type=int, default=0,
                   help="label > threshold -> 1 else 0")
    p.add_argument("--neg_sampling", type=str2bool, default=False)
    p.add_argument("--num_neg", type=int, default=1)
    p.add_argument("--sep", default=",")
    p.add_argument("--label_col", type=int, default=0)
    p.add_argument("--cat_cols", default="", help="e.g. 1,2,3")
    p.add_argument("--num_cols", default="", help="e.g. 4,5")
    p.add_argument("--normalize", type=str2bool, default=False)
    p.add_argument("--ffm", type=str2bool, default=False,
                   help="true: libffm output, false: libsvm")
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def _cols(spec: str) -> list[int]:
    return [int(c) for c in spec.split(",") if c.strip() != ""]


def _column(values: list) -> np.ndarray:
    """One column's strings as the array pandas infers for it."""
    present = [v for v in values if v not in NA_WORDS]
    if len(present) == len(values) and present and all(v in _BOOL for v in present):
        return np.array([_BOOL[v] for v in values], dtype=bool)
    if all(_INT.fullmatch(v) for v in present):
        ints = [int(v) for v in present]
        if all(-(1 << 63) <= i < (1 << 63) for i in ints):
            if len(present) == len(values):
                return np.array(ints, dtype=np.int64)
            return np.array([np.nan if v in NA_WORDS else float(int(v)) for v in values])
    if all(_FLOAT.fullmatch(v) for v in present):
        return np.array([np.nan if v in NA_WORDS else float(v) for v in values])
    return np.array([np.nan if v in NA_WORDS else v for v in values], dtype=object)


class Frame:
    """The columns of a csv (its first line the header), by position: what
    the tool reads of a pandas DataFrame (len, iloc[:, col], row take)."""

    def __init__(self, columns: list):
        self.columns = columns

    def __len__(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def col(self, i: int) -> np.ndarray:
        return self.columns[i]

    def take(self, rows: np.ndarray) -> "Frame":
        return Frame([c[rows] for c in self.columns])


def read_csv(path: str, sep: str) -> Frame:
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    header, body = rows[0], rows[1:]
    width = len(header)
    for r in body:
        if len(r) > width:
            raise ValueError(f"{path}: a row of {len(r)} fields under a header of {width}")
        r.extend([""] * (width - len(r)))
    return Frame([_column([r[i] for r in body]) for i in range(width)])


def load_split(args):
    if args.data_path:
        data = read_csv(args.data_path, args.sep)
        rng = np.random.default_rng(args.seed)
        perm = rng.permutation(len(data))
        cut = int(len(data) * args.train_frac)
        train = data.take(perm[:cut])
        evald = data.take(perm[cut:])
    elif args.train_path and args.eval_path:
        train = read_csv(args.train_path, args.sep)
        evald = read_csv(args.eval_path, args.sep)
    else:
        raise SystemExit("Must provide --data_path or --train_path + --eval_path")
    return train, evald


def transform(args):
    rng = np.random.default_rng(args.seed)
    cat_cols, num_cols = _cols(args.cat_cols), _cols(args.num_cols)
    train, evald = load_split(args)

    def labels_of(df):
        y = df.col(args.label_col)
        if args.neg_sampling:
            return np.ones(len(df), dtype=np.int64)  # implicit data: all 1
        return (y > args.threshold).astype(np.int64)

    out = {}
    for split, df in (("train", train), ("eval", evald)):
        n = len(df)
        n_neg = n * args.num_neg if args.neg_sampling and args.num_neg > 0 else 0
        y = np.concatenate([labels_of(df), np.zeros(n_neg, dtype=np.int64)])
        out[split] = {"y": y, "tokens": []}

    offset = 1  # 0 reserved for OOV
    # fields are numbered by position in cat_cols + num_cols, like the
    # reference's enumerate(total_cols)
    for field, col in enumerate(cat_cols + num_cols):
        if col in cat_cols:
            vocab_vals, train_idx = np.unique(train.col(col), return_inverse=True)
            train_idx = train_idx + offset
            # unknown eval values -> 0 (pandas' reindex + fillna(0))
            lookup = {v: i + offset for i, v in enumerate(vocab_vals.tolist())}
            eval_idx = np.array([lookup.get(v, 0) for v in evald.col(col).tolist()],
                                dtype=np.int64)
            for split, idx in (("train", train_idx), ("eval", eval_idx)):
                n_neg = len(idx) * args.num_neg if args.neg_sampling and args.num_neg > 0 else 0
                if n_neg:
                    neg = rng.integers(0, len(vocab_vals), size=n_neg) + offset
                    idx = np.concatenate([idx, neg])
                tok = np.char.add(idx.astype(str), ":1")
                if args.ffm:
                    tok = np.char.add(f"{field}:", tok)
                out[split]["tokens"].append(tok)
            offset += len(vocab_vals)
        else:
            tv = train.col(col).astype(np.float64)
            ev = evald.col(col).astype(np.float64)
            if args.normalize:
                lo, hi = tv.min(), tv.max()
                scale = (hi - lo) or 1.0
                tv = (tv - lo) / scale
                ev = (ev - lo) / scale  # train-fit transform, like the ref
            # negatives drawn from the TRAIN range (train-fit semantics)
            t_lo, t_hi = tv.min(), tv.max()
            for split, v in (("train", tv), ("eval", ev)):
                n_neg = len(v) * args.num_neg if args.neg_sampling and args.num_neg > 0 else 0
                if n_neg:
                    neg = rng.random(n_neg) * (t_hi - t_lo) + t_lo
                    v = np.concatenate([v, neg])
                tok = np.char.add(f"{offset}:", np.round(v, 4).astype(str))
                if args.ffm:
                    tok = np.char.add(f"{field}:", tok)
                out[split]["tokens"].append(tok)
            offset += 1

    lines = {}
    for split in ("train", "eval"):
        y = out[split]["y"]
        cols = [y.astype(str)] + out[split]["tokens"]
        stacked = np.stack(cols, axis=1)
        lines[split] = np.array([" ".join(row) for row in stacked])
    # shuffle train output (positives + negatives interleaved), like the ref
    lines["train"] = lines["train"][rng.permutation(len(lines["train"]))]
    return lines["train"], lines["eval"]


def main(argv=None) -> int:
    args = parse_args(argv)
    t0 = time.perf_counter()
    train_lines, eval_lines = transform(args)
    with open(args.train_output_path, "w") as f:
        f.write("\n".join(train_lines) + "\n")
    with open(args.eval_output_path, "w") as f:
        f.write("\n".join(eval_lines) + "\n")
    print(f"Output train size: {len(train_lines)}")
    print(f"Output eval size: {len(eval_lines)}")
    print(f"Total running time: {time.perf_counter() - t0:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
