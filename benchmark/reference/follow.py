"""The reference's side of a cell's check: the eval pass on S0, the
checked steps on the first batches of epoch 1, then the eval pass again,
all at the cell's sizes, on the card after the program's state is
freed.

The reference holds only the rows that the check reads: the distinct ids
of the checked steps and of the eval rows, each with its S0 made again
from its block (benchmark/state.py).  Every other row keeps S0 on both
sides and adds nothing to a norm of the gradient or of the change, so
its memory is bounded by those rows and not by the table.

Which rows a step trains on is worked out here from the protocol, the
seed and the text the harness wrote, as the program's contract states
it: a global batch is cut into slices (one card: one slice), slice r
holds the lines that begin in the r-th equal byte range of the file, and
each slice feeds batch / slices rows a step, in file order or in its own
shuffle.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import compare, generator
from benchmark import state as s0
from benchmark.reference import model

# rows a block of the reference's forward and backward
BLOCK = 1024


class RefTables:
    """compare.Tables over a RefState whose rows are S0's rows `ids`
    (sorted): each block of S0 that holds some of them, made again."""

    def __init__(self, st: model.RefState, ids: torch.Tensor, config: dict, seed: int):
        self.st, self.ids, self.config, self.seed = st, ids, config, seed

    def vec_blocks(self):
        st = self.st
        for b, lo, hi, i0, i1 in s0.blocks_of(self.config, self.ids):
            w0 = s0.w0_block(self.config, self.seed, b, lo, hi, self.ids.device)
            yield (st.vec_n[i0:i1], st.vec_z[i0:i1], st.vec_w[i0:i1],
                   w0[self.ids[i0:i1] - lo])

    def lin(self):
        return self.st.lin_n, self.st.lin_z, self.st.lin_w

    def bias(self):
        return self.st.bias_n, self.st.bias_z


def batch_shards(config: dict, chips: int) -> int:
    """The slices a global batch is cut into on `chips` cards, one process
    a card (the program's Config): the mesh's data axis (mesh_data; 0, or
    1 beside mesh_model 1, takes every card left over), times its model
    axis where the lookups are routed (lookup_mode "route", or "auto"
    where the batch divides over every card)."""
    if chips == 1:
        return 1
    m, d = config.get("mesh_model", 1), config.get("mesh_data", 1)
    if d == 0 or (d == 1 and m == 1):
        d = chips // m
    mode = config.get("lookup_mode", "auto")
    routed = m > 1 and mode != "replicate" and (
        mode == "route" or config["batch_size"] % (d * m) == 0)
    return d * m if routed else d


def shard_counts(line_bytes: np.ndarray, shards: int) -> np.ndarray:
    """[shards] rows of each slice of a text file whose lines have these
    lengths: slice r holds the lines that begin in [size r / P,
    size (r + 1) / P) (the C++ reference's byte-range partition)."""
    starts = np.concatenate([[0], np.cumsum(line_bytes)[:-1]])
    size = int(line_bytes.sum())
    cuts = np.array([size * r // shards for r in range(1, shards)], np.int64)
    return np.bincount(np.searchsorted(cuts, starts, side="right"), minlength=shards)


def epoch_steps(protocol: dict, seed: int, counts, batch: int, epochs: int):
    """Each of epochs 1..epochs as [steps, batch] global row indices, -1
    where a slice has run out: slice r (rows offset_r .. offset_r +
    counts[r]) gives batch / P rows a step, the next of its order, which
    in offline shuffled epochs (the protocol's online false, shuffle
    true) is a shuffle of its rows by one numpy default generator a
    slice, seeded with the run's seed, else file order."""
    p = len(counts)
    lb = batch // p
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    steps = -(-int(max(counts)) // lb)
    rngs = [np.random.default_rng(seed) for _ in range(p)]
    shuffled = not protocol.get("online", True) and protocol.get("shuffle", False)
    for _ in range(epochs):
        out = np.full((steps, p, lb), -1, np.int64)
        for r, (n, off) in enumerate(zip(counts, offsets)):
            order = np.arange(n)
            if shuffled:
                rngs[r].shuffle(order)
            col = np.full(steps * lb, -1, np.int64)
            col[:n] = order + off
            out[:, r, :] = col.reshape(steps, lb)
        yield out.reshape(steps, p * lb)


def slice_counts(config: dict, ids: np.ndarray, chips: int) -> np.ndarray:
    """The rows of each slice of the file written from rows `ids`."""
    shards = batch_shards(config, chips)
    if shards == 1:
        return np.array([ids.shape[0]])
    return shard_counts(generator.line_bytes(ids, config), shards)


def follow(config: dict, protocol: dict, seed: int, data, device: torch.device,
           chips: int = 1, every_row: bool = False) -> dict:
    """The reference's numbers for compare.readings: the eval logits on
    S0, each checked step's mean loss, the first step's gradient norms,
    the change norms after the checked steps, and the following eval
    pass's loss and AUC.  It holds the rows the check reads, or with
    every_row the whole table."""
    batch = config["batch_size"]
    counts = slice_counts(config, data.train_ids, chips)
    (steps,) = epoch_steps(protocol, seed, counts, batch, 1)
    checked = [s[s >= 0] for s in steps[:compare.check_steps(config)]]
    tr = torch.as_tensor(data.train_ids[np.concatenate(checked)], device=device)
    y = torch.as_tensor(data.train_y[np.concatenate(checked)], device=device)
    ev = torch.as_tensor(data.eval_ids, device=device)
    ids = (torch.arange(config["n_feats"], device=device) if every_row
           else torch.unique(torch.cat([tr.reshape(-1), ev.reshape(-1)]).to(torch.int64)))
    st = model.initial_state(config, seed, device, ids)
    tables = RefTables(st, ids, config, seed)
    tr = torch.searchsorted(ids, tr.to(torch.int64))
    ev = torch.searchsorted(ids, ev.to(torch.int64))
    logits0 = model.eval_logits(config, st, ev, BLOCK).cpu().numpy()
    losses, grad, lo = [], None, 0
    for k, rows in enumerate(checked):
        sl = slice(lo, lo + rows.shape[0])
        lo = sl.stop
        loss = model.train_step(config, st, tr[sl], y[sl], BLOCK)
        losses.append(loss / rows.shape[0])
        if k == 0:
            grad = compare.norms(compare.grad_squares(tables, config))
    change = compare.norms(compare.change_squares(tables))
    del tr, y
    logits = model.eval_logits(config, st, ev, BLOCK)
    ey = torch.as_tensor(data.eval_y, dtype=torch.float32, device=device)
    eval_loss = float(model.row_loss(logits, ey).double().mean())
    return {
        "losses": losses, "grad": grad, "change": change, "eval_loss": eval_loss,
        "auc": model.binned_auc(logits.cpu().numpy(), data.eval_y, config["auc_bins"]),
        "logits": logits0,
    }
