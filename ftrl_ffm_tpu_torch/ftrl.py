"""FTRL-Proximal closed form: the serving subset of ftrl_ffm_tpu/ftrl.py.

Serving reads weights only, so this module holds the hyper-parameters, the
"untouched" threshold and the closed-form weight.  The accumulator updates
(ftrl_ffm_tpu/ftrl.py::ftrl_accumulate and the table updates) arrive with
training (ROADMAP.md Queue 1 item 2).

Closed form (reference: src/include/model/ftrl_model.h:28-33):

    w = 0                                             if |z| <= l1
    w = -(z - sgn(z) * l1) / (l2 + (beta + sqrt(n)) / alpha)   otherwise
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FtrlParams(NamedTuple):
    """Static FTRL hyper-parameters."""

    alpha: float = 1e-4
    beta: float = 1.0
    l1: float = 0.1
    l2: float = 5.0


# "Has this coordinate ever been touched by a real gradient?" — the same
# threshold as ftrl_ffm_tpu/ftrl.py::UNTOUCHED_N, whose comment gives the
# reason (cancellation dust on untouched slots stays far below it).
UNTOUCHED_N = 1e-16


def ftrl_weights(n: torch.Tensor, z: torch.Tensor, p: FtrlParams) -> torch.Tensor:
    """Closed-form FTRL-Proximal weight from accumulators, elementwise
    (ftrl_ffm_tpu/ftrl.py::ftrl_weights).  sgn(z) is only read where
    |z| > l1 >= 0, so its value at 0 never matters."""
    sgn_z = torch.where(z > 0, 1.0, -1.0).to(z.dtype)
    w = -(z - sgn_z * p.l1) / (p.l2 + (p.beta + torch.sqrt(n)) / p.alpha)
    return torch.where(torch.abs(z) <= p.l1, torch.zeros_like(w), w)
