"""Bytes-moved roofline model for one train step of the PyTorch port on
the card (the twin of tools/roofline.py).

Prints the per-pass memory traffic of the port's step design and the
implied step-time floor at a given memory rate, so a measured step can be
judged against physics.  Pure Python: no card needed.

Usage:
    python -m ftrl_ffm_tpu_torch.tools.roofline [--batch 8192] [--nnz 39]
        [--n_fields 39] [--n_factors 16] [--n_feats 100000] [--model FFM]
        [--update dense2|inplace|sparse2] [--hbm_gbs 3350]
        [--measured_ms 0]

The model (f32 tables; nnz = occurrences a step = batch * nnz_per_sample;
E the factor row width: C'*K for FFM, C' = field_pad (40 at 39 fields and
K=16, so E = 640 as the port stores its rows), K for FM, none for LR):
  v-row gather      read E-wide rows per occurrence + write [nnz, E]
  fused kernel      read [nnz, E] + write [nnz, 2E] (g || g^2, or g and g^2)
  id sort           the stable sort of the ids: read them, write the
                    sorted ids and their order (every kind sorts once)
  dense2, sparse2   the touched-rows update kernel: read the payload, read
                    and write n, z, w of the rows the batch touches, in
                    place.  No [R, 2E] accumulator and no pass over the
                    table (train.py::estimate_hbm_bytes); "sparse2" runs the
                    same kernel on the card (ops/ftrl_cuda.py), so it costs
                    the same bytes
  inplace           zeroing A ([R, E] written); the z/A scatter (payload
                    read, z of the touched rows read and written, A of
                    them written); the closed-form pass (kernel #3: n, z,
                    A, w in; n, z, w out over the whole table)
  linear path       FFM with a dead lane (C' > C): its gather and payload ride in
                    lane n_fields of the factor rows, so only the touched
                    linear rows' n, z, w are read and written (by the
                    update kernel), and nothing under "inplace", where the
                    linear tables ride stale in the mirror lane; LR and FM:
                    the w gather ([nnz] in and out), the [nnz, 2] payload
                    and the touched rows' n, z, w
Touched rows are costed with E[unique] = R * (1 - exp(-nnz / R)) for
uniformly drawn ids (an upper bound for skewed CTR ids, which collide
more).

Where it differs from the JAX model, and why: the JAX model's FFM row is
C*K wide (624 at 39 fields), the rows as the reference stores them; both
packages store C'*K (640), so the port's model counts that.  The JAX design scatters the
payload into a zeroed [R, 2E] accumulator and runs the closed form over
every row ("dense2"), which the port's update kernel does not need; the
difference is exactly that accumulator's traffic at each width (its
zero-init, its read-modify-write of the touched rows, its read by the
closed form, and the closed form over the untouched rows it forces:
(10R - 2U) * width * 4 bytes), minus the port's id sort.  The JAX
"sparse2" is a sort-and-segment design the port does not run.  The JAX
"inplace" read-modify-writes A where the port, having zeroed it, writes
it.  The JAX model costs the linear tables as their own dense chain even
where the dead lane carries them.  The passes both designs share (the
gather, the fused kernel, the in-place closed form) carry the same names
and bytes.  Like the JAX model it leaves out the per-sample inputs
(fields, values, labels, logits: under 0.5% of a step) and the ids that
the update and the scatter read beside their payload (0.05%), which the
kernel bounds of PERF.md count.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Optional


def unique_rows(n_rows: int, nnz: int) -> float:
    """Expected distinct rows touched by nnz uniform draws from n_rows."""
    if n_rows <= 0:
        return 0.0
    return n_rows * (1.0 - math.exp(-nnz / n_rows))


def field_pad(n_fields: int, n_factors: int) -> int:
    """The padded field count of an FFM row (config.py::Config.field_pad):
    the next multiple of 128 / gcd(K, 128) fields where that adds at most
    15%, else n_fields."""
    step = 128 // math.gcd(n_factors, 128)
    cp = -(-n_fields // step) * step
    return cp if (cp - n_fields) * 20 <= 3 * n_fields else n_fields


def step_bytes(
    batch: int,
    nnz_per_sample: int,
    n_fields: int,
    n_factors: int,
    n_feats: int,
    model: str = "FFM",
    update: str = "dense2",
    dtype_bytes: int = 4,
) -> dict[str, float]:
    """Per-pass bytes for one train step of the port's design."""
    nnz = batch * nnz_per_sample
    cp = field_pad(n_fields, n_factors) if model == "FFM" else n_fields
    if model == "LR":
        e = 0
    elif model == "FM":
        e = n_factors
    else:
        e = cp * n_factors
    # FFM's first dead lane carries the linear tables (config.py::field_pad)
    dead_lane = cp > n_fields
    r = n_feats
    u = unique_rows(r, nnz)
    b = dtype_bytes
    inplace = update == "inplace" and e > 0
    passes: dict[str, float] = {}
    if e:
        passes["v-row gather (rows in, [nnz,E] out)"] = 2 * nnz * e * b
        passes["fused kernel ([nnz,E] in, [nnz,2E] out)"] = nnz * e * b + nnz * 2 * e * b
    passes["id sort (ids in; sorted ids + order out)"] = 3 * nnz * 4
    if inplace:
        passes["factor zeroing A ([R,E] out)"] = r * e * b
        passes["factor z/A scatter (payload in; touched z in/out, A out)"] = (
            nnz * 2 * e * b + 3 * u * e * b
        )
        passes["factor closed-form (n,z,acc,w in; n,z,w out)"] = 7 * r * e * b
    elif e:
        passes["factor update kernel (payload in; touched n,z,w in/out)"] = (
            nnz * 2 * e * b + 6 * u * e * b
        )
    if dead_lane:
        # the linear gradient and weight ride in the dead lane; "inplace"
        # leaves the linear tables stale
        passes["linear path (touched n,z,w in/out; rides the dead lane)"] = (
            0.0 if inplace else 6 * u * b
        )
    else:
        passes["linear path (w gather + payload + touched n,z,w)"] = (
            2 * nnz * b + 2 * nnz * b + 6 * u * b
        )
    return passes


def floor_ms(passes: dict[str, float], hbm_gbs: float = 3350.0) -> float:
    """The step's least time in ms: its bytes over the memory rate."""
    return sum(passes.values()) / (hbm_gbs * 1e9) * 1e3


def main(argv: Optional[list[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--nnz", type=int, default=0, help="nnz per sample (default n_fields)")
    ap.add_argument("--n_fields", type=int, default=39)
    ap.add_argument("--n_factors", type=int, default=16)
    ap.add_argument("--n_feats", type=int, default=100_000)
    ap.add_argument("--model", default="FFM", choices=["LR", "FM", "FFM"])
    ap.add_argument("--update", default="dense2", choices=["dense2", "inplace", "sparse2"])
    ap.add_argument("--hbm_gbs", type=float, default=3350.0,
                    help="memory GB/s (H100 SXM HBM3: 3350)")
    ap.add_argument("--measured_ms", type=float, default=0.0)
    args = ap.parse_args(argv)

    nnz_ps = args.nnz or args.n_fields
    passes = step_bytes(
        args.batch, nnz_ps, args.n_fields, args.n_factors, args.n_feats,
        args.model, args.update,
    )
    total = sum(passes.values())
    print(
        f"{args.model} B={args.batch} nnz/sample={nnz_ps} C={args.n_fields} "
        f"K={args.n_factors} R={args.n_feats} update={args.update}"
    )
    for name, byts in passes.items():
        print(f"  {name:58s} {byts / 1e9:7.3f} GB")
    ms = floor_ms(passes, args.hbm_gbs)
    print(f"  {'TOTAL':58s} {total / 1e9:7.3f} GB")
    print(
        f"floor @ {args.hbm_gbs:.0f} GB/s: {ms:.2f} ms/step "
        f"= {args.batch / ms * 1e3:,.0f} ex/s"
    )
    if args.measured_ms:
        print(
            f"measured {args.measured_ms:.2f} ms -> "
            f"{ms / args.measured_ms * 100:.0f}% of roofline"
        )
    return ms


if __name__ == "__main__":
    main(sys.argv[1:])
