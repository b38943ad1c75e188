"""The initial state S0 that both sides start from, made from the seed on
the device, a block of rows a generator call.

In the logical layout (the one the plain reference keeps): n and z are 0
everywhere; the factor weights are N(init_mean, init_stddev), FFM's
[R, n_fields, k] (row, the field it meets, factor), FM's [R, k]; the
linear weights and the bias are 0.  That is a fresh FTRL model under
keep_init semantics: a coordinate keeps its random weight until a
gradient first reaches it.  Block b of rows comes from a generator
seeded by (seed, b) alone, so any block can be made again after the
window, where the change of the state is judged.
"""

from __future__ import annotations

import torch

from benchmark import models

# float32 numbers a generator call makes (about 256 MB)
BLOCK_ELEMENTS = 1 << 26


def factor_shape(config: dict) -> tuple:
    """The logical shape of one row's factor weights (the model's own)."""
    return models.of(config).factor_shape(config)


def block_rows(config: dict) -> int:
    """Rows of one block: a power of two near BLOCK_ELEMENTS numbers."""
    per_row = 1
    for d in factor_shape(config):
        per_row *= d
    rows = 1
    while rows * 2 * per_row <= BLOCK_ELEMENTS:
        rows *= 2
    return rows


def blocks(config: dict):
    """(block index, first row, end row) of the factor table's blocks."""
    step = block_rows(config)
    n = config["n_feats"]
    for b, lo in enumerate(range(0, n, step)):
        yield b, lo, min(n, lo + step)


def _block_seed(seed: int, b: int) -> int:
    # an odd 64-bit multiplier spreads the seed; the block index is added
    return (int(seed) * 0x9E3779B97F4A7C15 + b) % (1 << 63)


def w0_block(config: dict, seed: int, b: int, lo: int, hi: int,
             device: torch.device) -> torch.Tensor:
    """The factor weights of rows [lo, hi) (block b) of S0, float32, in
    the logical layout, on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_block_seed(seed, b))
    w = torch.randn((hi - lo, *factor_shape(config)), generator=gen, device=device)
    return w.mul_(config["init_stddev"]).add_(config["init_mean"])


def w0_rows(config: dict, seed: int, rows: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The factor weights of S0's rows `rows` (sorted, distinct, int64),
    float32, logical layout: each block made again and the rows taken
    from it, so that no more than one block and the rows are held."""
    out = torch.empty((rows.shape[0], *factor_shape(config)), dtype=torch.float32,
                      device=device)
    for b, lo, hi, i0, i1 in blocks_of(config, rows):
        out[i0:i1] = w0_block(config, seed, b, lo, hi, device)[rows[i0:i1] - lo]
    return out


def blocks_of(config: dict, rows: torch.Tensor):
    """(block, first row, end row, i0, i1) of each block that holds some
    of `rows` (sorted): rows[i0:i1] lie in [lo, hi)."""
    bounds = torch.tensor([lo for _, lo, _ in blocks(config)] + [config["n_feats"]],
                          dtype=torch.int64, device=rows.device)
    cut = torch.searchsorted(rows, bounds).tolist()
    for b, lo, hi in blocks(config):
        if cut[b + 1] > cut[b]:
            yield b, lo, hi, cut[b], cut[b + 1]


def rank_blocks(config: dict, shards: int, index: int):
    """(block, first row, end row, first id, l0, l1) of each block, for the
    rank that holds the ids i with i % shards == index at local row
    i // shards (the program's interleaved placement): the block's ids of
    that rank are first, first + shards, ... below the end row, and they
    sit at the rank's local rows [l0, l1).  One rank (shards 1) holds
    every row: first = lo, [l0, l1) = [lo, hi)."""
    for b, lo, hi in blocks(config):
        first = lo + (index - lo) % shards
        if first < hi:
            yield b, lo, hi, first, first // shards, (hi - 1 - index) // shards + 1
