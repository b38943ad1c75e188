"""FFM factor-table layout helpers.

The reference stores each feature's factor row field-major: slot
(field c, factor k) = c * n_factors + k (reference: src/model/ffm.cpp:63-65).
This framework stores rows **factor-major** internally: slot (k, c) =
k * field_pad + c.  Reason: the Pallas interaction kernel processes one
factor k at a time, and in k-major layout the per-k slice is a contiguous
lane range [k*C', (k+1)*C') — Mosaic supports contiguous lane slices but not
the minor-dim-splitting reshape the field-major layout would require.

field_pad >= n_fields pads each per-factor block with dead lanes (fields
that never occur) so the physical row width is a 128-lane multiple — see
Config.field_pad.  Dead lanes are dropped on export and zero-filled on
import.

Row width and all per-coordinate FTRL math are layout-agnostic; only
import/export and comparisons against reference-layout weights convert.
"""

from __future__ import annotations

import torch


def kmajor_to_reference(x: torch.Tensor, n_fields: int, n_factors: int, field_pad: int = 0):
    """[R, K*C'] factor-major (padded) -> [R, C*K] reference field-major,
    on x's device."""
    cp = field_pad or n_fields
    r = x.shape[0]
    return (
        x.reshape(r, n_factors, cp)[:, :, :n_fields]
        .transpose(1, 2)
        .reshape(r, n_fields * n_factors)
    )


def reference_to_kmajor(x: torch.Tensor, n_fields: int, n_factors: int, field_pad: int = 0):
    """[R, C*K] reference field-major -> [R, K*C'] factor-major (padded,
    dead lanes zero), on x's device."""
    cp = field_pad or n_fields
    r = x.shape[0]
    out = x.new_zeros((r, n_factors, cp))
    out[:, :, :n_fields] = x.reshape(r, n_fields, n_factors).transpose(1, 2)
    return out.reshape(r, n_factors * cp)
