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
