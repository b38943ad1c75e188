"""Analytic multi-card scaling model of the port's sharded FTRL step (the
twin of tools/scaling_model.py, with the H100's rates and the port's
update forms).

Per mesh shape (D, M) it prints the modeled step time and weak-scaling
efficiency: the per-card batch b_dev is held constant, the table of R
rows is sharded over "model".  The legs are the JAX tool's, a card each:

  gather    occ rows x E f32 from the local shard           (occ = b_dev * C)
  a2a       route (M > 1): ids there, [occ, E] rows back and [occ, 2E]
            payloads there over "model", (M - 1) / M of it off the card
  kernel    kernel #2 over [occ, E] (~3 passes)
  scatter   the [occ, 2E] payload into the table: at D = 1 without
            routing the touched-rows update kernel (no table-wide leg);
            on D > 1 za_scatter into zeroed [R/M, 2E] sums; routed in
            place (D = 1) into z and a zeroed [R/M, E] A
  psum_acc  (D > 1) the all_reduce of the [R/M, 2E] f32 sums over "data"
            (parallel/sharded.py::_accumulate_pass): R/M * 2E * 4 bytes
  pass      kernel #3 over the [R/M] shard (7 table-width passes) where
            the sums were made (D > 1 or route)

Rates, an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5, the
FFM-100k step of PR 11 run F, B = 16,384, 638,976 occurrences, E = 640):
gather 1.085 ms, kernel #2 2.061 ms and the update kernel 2.179 ms for
that step, each turned into bytes a second of its leg's volume; HBM
3.35 TB/s for the table-wide legs.  The NVLink rates are ASSUMED, not
measured: all_reduce 370 GB/s of bus bandwidth a card, all_to_all 300
GB/s a card (--ar, --a2a).  No TPU or ICI figure is used.

Usage: python -m ftrl_ffm_tpu_torch.tools.scaling_model [--b_dev 2048]
         [--c 39] [--k 16] [--r 100000000] [--ar 370] [--a2a 300]
"""

from __future__ import annotations

import argparse
import math

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# PERF.md section 5, PR 11 run F: the FFM-100k train step's legs
_OCC, _E = 16_384 * 39, 640
GATHER_RATE = _OCC * _E * 4 / 1.085e-3         # bytes/s of gathered rows
KERNEL_RATE = _OCC * 3 * _E * 4 / 2.061e-3     # kernel #2's three passes
UPDATE_RATE = _OCC * 2 * _E * 4 / 2.179e-3     # the (g, g^2) payload consumed
HBM_RATE = 3.35e12


def model_step(d: int, m: int, b_dev: int, c: int, k: int, r: int,
               ar_gbps: float = 370.0, a2a_gbps: float = 300.0) -> dict:
    """Modeled legs of one step on a (d, m) mesh at b_dev rows a card:
    times in ms, the step's examples/s, and the bytes of the collective
    legs (a2a_bytes: sent by a card; psum_acc_bytes: the all_reduced
    tensor's)."""
    step = 128 // math.gcd(k, 128)
    cp = -(-c // step) * step
    e = cp * k                      # padded row width (floats)
    occ = b_dev * c                 # occurrences a card
    f4 = 4
    r_loc = r / m                   # rows a model shard
    route = m > 1
    sums = d > 1 or route           # the forms with table-wide legs

    t_gather = occ * e * f4 / GATHER_RATE
    t_kernel = occ * 3 * e * f4 / KERNEL_RATE
    a2a_bytes = occ * 3 * e * f4 if route else 0
    t_a2a = (m - 1) / m * a2a_bytes / (a2a_gbps * 1e9) if route else 0.0
    # zeroing the sums: [r_loc, 2E] on D > 1, the in-place form's A alone
    t_zero = r_loc * (2 * e if d > 1 else e) * f4 / HBM_RATE if sums else 0.0
    t_scatter = occ * 2 * e * f4 / UPDATE_RATE + t_zero
    psum_acc_bytes = r_loc * 2 * e * f4 if d > 1 else 0
    t_psum_acc = 2 * (d - 1) / d * psum_acc_bytes / (ar_gbps * 1e9) if d > 1 else 0.0
    t_pass = r_loc * 7 * e * f4 / HBM_RATE if sums else 0.0
    total = t_gather + t_kernel + t_a2a + t_scatter + t_psum_acc + t_pass
    return {
        "total_ms": total * 1e3,
        "gather_ms": t_gather * 1e3,
        "kernel_ms": t_kernel * 1e3,
        "a2a_ms": t_a2a * 1e3,
        "scatter_ms": t_scatter * 1e3,
        "psum_acc_ms": t_psum_acc * 1e3,
        "pass_ms": t_pass * 1e3,
        "r_legs_ms": (t_pass + t_zero) * 1e3,
        "a2a_bytes": a2a_bytes,
        "psum_acc_bytes": psum_acc_bytes,
        "throughput": b_dev * d * m / total,
    }


SHAPES = [(1, 1), (1, 2), (1, 4), (1, 8), (1, 16), (1, 64), (1, 256),
          (2, 2), (4, 1), (4, 4), (8, 8)]


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--b_dev", type=int, default=2048,
                   help="per-card batch (weak scaling constant)")
    p.add_argument("--c", type=int, default=39)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--r", type=int, default=100_000_000)
    p.add_argument("--ar", type=float, default=370.0,
                   help="NVLink all_reduce GB/s of bus bandwidth a card (assumed)")
    p.add_argument("--a2a", type=float, default=300.0,
                   help="NVLink all_to_all GB/s a card (assumed)")
    a = p.parse_args(argv)
    print(f"weak scaling @ b_dev={a.b_dev}, C={a.c}, K={a.k}, R={a.r:,}; rates of an "
          f"{CARD} (PERF.md section 5); NVLink all_reduce {a.ar} GB/s, all_to_all "
          f"{a.a2a} GB/s a card: assumed")
    print(f"{'mesh':>10} {'cards':>6} {'step ms':>9} {'Mex/s':>7} "
          f"{'a2a ms':>7} {'psum ms':>8} {'eff':>7}")
    base = None
    rows = []
    for d, m in SHAPES:
        r_ = model_step(d, m, a.b_dev, a.c, a.k, a.r, a.ar, a.a2a)
        n = d * m
        per_card = r_["throughput"] / n
        if base is None:
            base = per_card
        rows.append({"mesh": f"{d}x{m}", **r_, "eff": per_card / base})
        print(f"{f'({d},{m})':>10} {n:>6} {r_['total_ms']:9.2f} "
              f"{r_['throughput'] / 1e6:7.2f} {r_['a2a_ms']:7.2f} "
              f"{r_['psum_acc_ms']:8.2f} {per_card / base:7.1%}")
    return rows


if __name__ == "__main__":
    main()
