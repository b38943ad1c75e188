"""The least time the card could take for a step or a stage: the floors
that the shares of a peak (`*_mfu`) and of a roofline (`*_roofline`)
divide by the time measured.

Each floor is the larger of the compulsory bytes over the memory
bandwidth and the compulsory operations over the arithmetic peak, both
counted from the algorithm: the shapes, and U, the distinct rows a batch
touches (counted from the batch's ids, `unique_rows`).  Nothing here reads
the program: a kernel that stores wider rows, writes an intermediate
payload or reads a row twice does more than the floor, never less, so no
share can pass 100%.

A row's compulsory slots (float32) and the forward pass's operations are
the model's own (benchmark/models/<model_type>.py: slots_per_row,
forward_flops).  FTRL keeps three numbers a slot: n, z and the weight w.

Peaks: one NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit, from NVIDIA's
data sheet: 3.35 TB/s of memory bandwidth and 67 TFLOP/s of float32
outside the tensor cores (TF32 stays off: the configurations state
float32).  A card set below 700 W runs slower: the run prints the card's
power limit beside every share.
"""

from __future__ import annotations

import numpy as np

from benchmark import models

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4
# the batch's ids are int32, its labels one float32 a row (the values and
# fields of these one-hot rows carry no information and need no bytes)
ID_BYTES = 4
LABEL_BYTES = 4


def slots_per_row(config: dict) -> int:
    """Compulsory slots of one touched row: the factor slots an occurrence
    of it can read or write, and its linear slot."""
    return models.of(config).slots_per_row(config)


def forward_flops(config: dict, batch: int) -> float:
    """Operations of the forward pass of `batch` rows."""
    return models.of(config).forward_flops(config, batch)


def _batch_bytes(config: dict, batch: int) -> float:
    return float(batch) * (config["n_fields"] * ID_BYTES + LABEL_BYTES)


def _time(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def train_step_floor(config: dict, batch: int, u_rows: int) -> float:
    """Seconds: one training step of `batch` rows touching u_rows rows.

    Bytes: w, n and z of the U rows read once and written once (six
    float32 numbers a slot), the batch's ids and labels read once.
    FLOPs: the forward pass, and twice that for the gradient (3x)."""
    nbytes = u_rows * slots_per_row(config) * F32 * 6 + _batch_bytes(config, batch)
    return _time(nbytes, 3 * forward_flops(config, batch))


def update_floor(config: dict, u_rows: int) -> float:
    """Seconds: the update stage of one step: n and z of the U rows read,
    n, z and w written (five float32 numbers a slot).  The gradient is
    not counted, so that a program that fuses the stages and never
    stores it still reads at most 100%."""
    return u_rows * slots_per_row(config) * F32 * 5 / PEAK_BYTES_PER_S


def interaction_floor(config: dict, batch: int, u_rows: int) -> float:
    """Seconds: the interaction stage of one step: w of the U rows and the
    batch read once; the forward and backward operations (3x forward)."""
    nbytes = u_rows * slots_per_row(config) * F32 + _batch_bytes(config, batch)
    return _time(nbytes, 3 * forward_flops(config, batch))


def eval_step_floor(config: dict, batch: int, u_rows: int) -> float:
    """Seconds: one eval step: w of the U rows and the batch read once, B
    logits written; the forward operations."""
    nbytes = (u_rows * slots_per_row(config) * F32 + _batch_bytes(config, batch)
              + batch * F32)
    return _time(nbytes, forward_flops(config, batch))


def unique_rows(ids, steps: np.ndarray) -> np.ndarray:
    """[S] the distinct ids of each step of a pass over the rows ids
    [N, F] (a torch tensor, on the card or the CPU), steps [S, W] the rows
    of each step (-1 for none): one sort of (step, id) keys for the whole
    pass."""
    import torch

    dev = ids.device
    st = torch.as_tensor(np.asarray(steps), dtype=torch.int64, device=dev)
    real = st >= 0
    rows = st[real]
    step = torch.arange(st.shape[0], device=dev)[:, None].expand_as(st)[real]
    width = int(ids.max()) + 1
    keys = (step.repeat_interleave(ids.shape[1]) * width
            + ids.index_select(0, rows).reshape(-1).to(torch.int64))
    uniq = torch.unique(keys)
    return torch.bincount(uniq // width, minlength=st.shape[0]).cpu().numpy()
