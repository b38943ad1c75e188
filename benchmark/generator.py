"""The traffic generator: a cell's training and eval rows, made from its
configuration (benchmark/configs/<name>.json), its traffic mix
(benchmark/traffic/<name>.json) and the seed alone.

Rows are libffm samples of n_fields fields: one feature a field, in field
order, value 1 (binned integer and categorical features are one-hot).
The mix lists, under "values", how many distinct values each field has.
A row takes in field c a value drawn from [0, values[c]) under the mix's
"law": "uniform" (the default), every value alike; or {"zipf": s}, the
value of rank r with probability proportional to (r + 1)^-s, truncated
to the field's values and renormalised (no mass piles up on the last
value), drawn by inverse CDF.  The value becomes a row of the model's
tables by a hash of (c, value) into [0, n_feats): one space that all
fields share, as libffm-style preprocessing hashes "field + value" into
its bins.  Two
values, of one field or of two, may share a row, as hashed features do.
The hash is fixed (splitmix64), not drawn from the seed: the same value
of a field lands on the same row in every run.

Labels come from a planted model, as the repo's bench.py makes them: a
weight N(0, w_std) for every row of the table, and y = 1 where the row's
weights plus N(0, noise_std) noise exceed 0.

Everything is vectorised and made a block of rows at a time on a few
threads: the text is assembled from token tables, so set-up is not a
Python loop over rows.  The same seed gives the same arrays and the same
bytes.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
from typing import NamedTuple

import numpy as np

# the independent random streams of one seed
_TRAIN, _EVAL, _PLANT = range(3)
# rows drawn from one generator
_BLOCK = 1 << 16
_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


class Data(NamedTuple):
    train_ids: np.ndarray  # [N, F] int32 rows of the table, field c in column c
    train_y: np.ndarray    # [N] uint8 in {0, 1}
    eval_ids: np.ndarray   # [M, F] int32
    eval_y: np.ndarray     # [M] uint8


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *stream])


def field_values(config: dict, traffic: dict) -> np.ndarray:
    """[n_fields] int64: the distinct values of each field."""
    v = np.asarray(traffic["values"], np.int64)
    if v.shape != (config["n_fields"],) or v.min() < 1:
        raise ValueError(f"the traffic lists {v.shape[0]} fields' values; "
                         f"the configuration has {config['n_fields']} fields")
    return v


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finaliser of uint64 x (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return x ^ (x >> np.uint64(31))


def hashed_rows(fields: np.ndarray, values: np.ndarray, n_feats: int) -> np.ndarray:
    """The table row of value `values` of field `fields` (broadcast):
    splitmix64(field * 2^40 + value) mod n_feats, int32."""
    key = (fields.astype(np.uint64) << np.uint64(40)) | values.astype(np.uint64)
    return (splitmix64(key) % np.uint64(n_feats)).astype(np.int32)


@functools.lru_cache(maxsize=64)
def zipf_cdf(values: int, s: float) -> np.ndarray:
    """[values] float64 CDF of the truncated, renormalised Zipf law
    P(r) ~ (r + 1)^-s, r in [0, values); its last entry is 1."""
    c = np.cumsum(np.arange(1, values + 1, dtype=np.float64) ** -float(s))
    return c / c[-1]


def draw_values(rng: np.random.Generator, law, vals: np.ndarray, n_rows: int) -> np.ndarray:
    """[n_rows, F] int64 values, field c's in [0, vals[c]), under the law."""
    if law == "uniform":
        return rng.integers(0, vals, (n_rows, vals.shape[0]))
    if isinstance(law, dict) and set(law) == {"zipf"}:
        u = rng.random((n_rows, vals.shape[0]))
        return np.stack([np.minimum(np.searchsorted(zipf_cdf(int(v), law["zipf"]), u[:, c],
                                                    side="right"), v - 1)
                         for c, v in enumerate(vals)], axis=1)
    raise ValueError(f"unknown law {law!r}")


def draw_ids(seed: int, stream: int, config: dict, traffic: dict, n_rows: int,
             threads: int = 4) -> np.ndarray:
    """[n_rows, F] int32 table rows of one stream (train or eval): blocks
    of _BLOCK rows, each from a generator of its own (so the threads that
    draw them give the same ids in any order)."""
    f = config["n_fields"]
    vals = field_values(config, traffic)
    law = traffic.get("law", "uniform")
    cols = np.arange(f, dtype=np.int64)
    out = np.empty((n_rows, f), np.int32)

    def block(lo: int) -> None:
        hi = min(n_rows, lo + _BLOCK)
        v = draw_values(_rng(seed, stream, lo // _BLOCK), law, vals, hi - lo)
        out[lo:hi] = hashed_rows(cols, v, config["n_feats"])

    with cf.ThreadPoolExecutor(threads) as pool:
        list(pool.map(block, range(0, n_rows, _BLOCK)))
    return out


def planted_labels(seed: int, config: dict, traffic: dict, ids_list) -> list:
    """[N] uint8 labels of each ids array from one planted model."""
    lab = traffic["labels"]
    rng = _rng(seed, _PLANT)
    w = rng.normal(0.0, lab["w_std"], config["n_feats"])
    out = []
    for ids in ids_list:
        logit = w[ids].sum(axis=1) + rng.normal(0.0, lab["noise_std"], ids.shape[0])
        out.append((logit > 0).astype(np.uint8))
    return out


def generate(config: dict, traffic: dict, seed: int) -> Data:
    """The cell's rows: config["train_rows"] training rows and
    config["eval_rows"] eval rows, from the seed."""
    tr = draw_ids(seed, _TRAIN, config, traffic, config["train_rows"])
    ev = draw_ids(seed, _EVAL, config, traffic, config["eval_rows"])
    ytr, yev = planted_labels(seed, config, traffic, (tr, ev))
    return Data(tr, ytr, ev, yev)


# ---- libffm text ----
def _digits(a: np.ndarray, width: int) -> np.ndarray:
    """[len(a), width] uint8 ASCII digits of a >= 0, right-aligned, with
    the leading zeros as 0 bytes (dropped when the text is packed)."""
    a = a.astype(np.int64)
    pows = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    d = (a[:, None] // pows) % 10
    out = (d + ord("0")).astype(np.uint8)
    lead = (a[:, None] < pows) & (pows > 1)
    out[lead] = 0
    return out


def field_tokens(n_fields: int) -> np.ndarray:
    """[F, W] uint8: field c's " c:", 0 bytes where c has fewer digits."""
    c = np.arange(n_fields, dtype=np.int64)
    wc = len(str(max(0, n_fields - 1)))
    return np.concatenate([np.full((n_fields, 1), ord(" "), np.uint8), _digits(c, wc),
                           np.full((n_fields, 1), ord(":"), np.uint8)], axis=1)


def id_tokens(n_feats: int) -> np.ndarray:
    """[n_feats, W] uint8: row i's "i:1", 0 bytes where i has fewer
    digits."""
    ids = np.arange(n_feats, dtype=np.int64)
    wi = len(str(max(0, n_feats - 1)))
    return np.concatenate([_digits(ids, wi),
                           np.frombuffer(b":1", np.uint8)[None, :].repeat(n_feats, 0)], axis=1)


def libffm_bytes(ids: np.ndarray, y: np.ndarray, ftok: np.ndarray, itok: np.ndarray) -> bytes:
    """The libffm lines of rows ids [n, F] with labels y [n]:
    "y c:id:1 c:id:1 ...\\n"."""
    n, f = ids.shape
    body = np.concatenate([np.broadcast_to(ftok, (n, f, ftok.shape[1])), itok[ids]],
                          axis=2).reshape(n, -1)
    label = (y.astype(np.uint8) + ord("0"))[:, None]
    nl = np.full((n, 1), ord("\n"), np.uint8)
    buf = np.concatenate([label, body, nl], axis=1)
    return buf[buf != 0].tobytes()


def _ndigits(a: np.ndarray) -> np.ndarray:
    """Decimal digits of each a >= 0 (0 has one)."""
    a = np.asarray(a, np.int64)
    n = np.ones(a.shape, np.int64)
    for p in range(1, 19):
        n += a >= 10 ** p
    return n


def line_bytes(ids: np.ndarray, config: dict) -> np.ndarray:
    """[n] int64: the length in bytes of each row's libffm line as
    write_libffm writes it: the label, " c:i:1" a field, the newline."""
    fields = int((_ndigits(np.arange(config["n_fields"])) + 2).sum())
    return 2 + fields + (_ndigits(ids) + 2).sum(axis=1)


def write_libffm(path: str, ids: np.ndarray, y: np.ndarray, config: dict,
                 block: int = 1 << 14, threads: int = 4) -> int:
    """Write rows as libffm text to `path`, blocks of rows assembled on
    `threads` threads and written in order; returns the bytes written."""
    ftok, itok = field_tokens(config["n_fields"]), id_tokens(config["n_feats"])
    total = 0
    starts = range(0, ids.shape[0], block)
    with open(path, "wb") as f, cf.ThreadPoolExecutor(threads) as pool:
        chunks = pool.map(lambda lo: libffm_bytes(ids[lo:lo + block], y[lo:lo + block], ftok,
                                                  itok), starts)
        for chunk in chunks:
            f.write(chunk)
            total += len(chunk)
    return total
