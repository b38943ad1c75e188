"""The reference's side of a cell's check: the eval pass on S0, the
checked steps on the first batches of epoch 1, then the eval pass again,
all at the cell's sizes, on the card after the program's state is
freed."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import compare
from benchmark import state as s0
from benchmark.reference import model

# rows a block of the reference's forward and backward
BLOCK = 1024


class RefTables:
    """compare.Tables over a RefState (logical already)."""

    def __init__(self, st: model.RefState, config: dict):
        self.st, self.config = st, config

    def vec_blocks(self):
        st = self.st
        for b, lo, hi in s0.blocks(self.config):
            yield b, lo, hi, st.vec_n[lo:hi], st.vec_z[lo:hi], st.vec_w[lo:hi]

    def lin(self):
        return self.st.lin_n, self.st.lin_z, self.st.lin_w

    def bias(self):
        return self.st.bias_n, self.st.bias_z


def epoch_orders(protocol: dict, seed: int, n_rows: int, epochs: int):
    """The row orders of epochs 1..epochs: offline shuffled epochs (the
    protocol's online false, shuffle true) each a shuffle of 0..n-1 by one
    numpy default generator seeded with the run's seed; otherwise file
    order."""
    rng = np.random.default_rng(seed)
    shuffled = not protocol.get("online", True) and protocol.get("shuffle", False)
    for _ in range(epochs):
        order = np.arange(n_rows)
        if shuffled:
            rng.shuffle(order)
        yield order


def follow(config: dict, protocol: dict, seed: int, data, device: torch.device) -> dict:
    """The reference's numbers for compare.readings: the eval logits on
    S0, each checked step's mean loss, the first step's gradient norms,
    the change norms after the checked steps, and the following eval
    pass's loss and AUC."""
    st = model.initial_state(config, seed, device)
    ev = torch.as_tensor(data.eval_ids, device=device)
    logits0 = model.eval_logits(config, st, ev, BLOCK).cpu().numpy()
    batch = config["batch_size"]
    (order,) = epoch_orders(protocol, seed, data.train_ids.shape[0], 1)
    ids = torch.as_tensor(data.train_ids, device=device)
    y = torch.as_tensor(data.train_y, device=device)
    losses, grad = [], None
    for k in range(compare.check_steps(config)):
        rows = torch.as_tensor(order[k * batch:(k + 1) * batch], device=device)
        loss = model.train_step(config, st, ids[rows], y[rows], BLOCK)
        losses.append(loss / batch)
        if k == 0:
            grad = compare.grad_norms(RefTables(st, config), config, seed)
    change = compare.change_norms(RefTables(st, config), config, seed)
    del ids, y
    logits = model.eval_logits(config, st, ev, BLOCK)
    ey = torch.as_tensor(data.eval_y, dtype=torch.float32, device=device)
    eval_loss = float(model.row_loss(logits, ey).double().mean())
    return {
        "losses": losses, "grad": grad, "change": change, "eval_loss": eval_loss,
        "auc": model.binned_auc(logits.cpu().numpy(), data.eval_y, config["auc_bins"]),
        "logits": logits0,
    }
