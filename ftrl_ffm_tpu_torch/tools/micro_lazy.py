"""Micro-benchmarks for the huge-table lazy-w FTRL redesign on the card:
the port of tools/micro_lazy.py.

The question: store only (n, z), compute w where it is gathered, and drop
the w table's write-back and/or the O(R*E) closed-form pass
(reference: src/model/ftrl_model.cpp:52-59).  These probes price the
pieces and two composed candidates:

  gather1       index_select [nnz] rows of ONE [R, E] table   (the fwd: w)
  gather2       two index_selects from two [R, E] tables      (lazy fwd: n, z)
  gather_wide   one index_select from a [R, 2E] table         (n || z)
  scat_z        z.index_add_(0, ids, g)                       (in place)
  scat_acc      zeros(R, E).index_add_(0, ids, g)             (accumulator)
  za_scatter    zeros(R, E) and ops/ftrl_cuda.py::za_scatter: both scatters
                in one deterministic kernel, what the port runs today
  pass4         kernel #3, ops/ftrl_cuda.py::closed_form_pass (n, z, w, A)
  pass3         the no-w pass (n, z, A) -> (n, z): csrc/micro_pass3.cu
  sortagg       stable sort of ids + permuted [nnz, 2E] payload + segment
                sums (index_add_ over segment ids) + unique ids
  scatback_set  two index_copy_ write-backs of the touched rows
  cand_now      composed: lazy fwd + za_scatter + pass3 (no w table)
  cand_sorted   composed: lazy fwd + sorted segment-sum update, no O(R) pass

The tables are updated in place, as the port's training step does.  Env:
BATCH (8192), N_FEATS (1000000), C (39), E (640); arguments: the probes
to run (all by default), `--device cpu` for the CPU.

    python -m ftrl_ffm_tpu_torch.tools.micro_lazy [pass3 pass4 ...]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ftrl_ffm_tpu_torch.ftrl import FtrlParams, _div, ftrl_weights
from ftrl_ffm_tpu_torch.ops.ffm_cuda import _check_inputs, _device_kind
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import _stream, closed_form_pass, za_scatter
from ftrl_ffm_tpu_torch.tools import split_device, time_ms
from ftrl_ffm_tpu_torch.train import resolve_device

ALPHA, BETA, L1, L2 = 1e-4, 1.0, 0.1, 5.0
P = FtrlParams(ALPHA, BETA, L1, L2)
PROBES = (
    "gather1", "gather2", "gather_wide", "scat_z", "scat_acc", "za_scatter",
    "pass4", "pass3", "sortagg", "scatback_set", "cand_now", "cand_sorted",
)


def pass3_plain(n, z, a, p: FtrlParams = P):
    """Plain PyTorch version of the no-w pass (the body of
    tools/micro_lazy.py::_pass3_kernel): w = closed form of the PRE-update
    n and the z given (the probe's stated approximation), then
    z - sigma * w and n + A.  Returns the new (n, z)."""
    sigma = _div(torch.sqrt(n + a) - torch.sqrt(n), p.alpha)
    w = ftrl_weights(n, z, p)
    return n + a, z - sigma * w


def pass3(
    n: torch.Tensor,  # [R, E] f32 (any shape, all three alike), in place
    z: torch.Tensor,  # in place
    a: torch.Tensor,  # sum g^2, read only
    p: FtrlParams = P,
) -> None:
    """The no-w closed-form pass over whole tables, in place: the port of
    tools/micro_lazy.py::_pass3_kernel (csrc/micro_pass3.cu), any shape."""
    if _device_kind("pass3", n) == "cpu":
        new_n, new_z = pass3_plain(n, z, a, p)
        n.copy_(new_n)
        z.copy_(new_z)
        return
    shape = tuple(n.shape)
    _check_inputs("pass3", n, [
        (name, t, shape, torch.float32) for name, t in (("n", n), ("z", z), ("a", a))
    ])
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    if n.numel() == 0:
        return
    with torch.cuda.device(n.device):
        code = lib.micro_pass3_launch(
            n.data_ptr(), z.data_ptr(), a.data_ptr(), n.numel(),
            p.alpha, p.beta, p.l1, p.l2, _stream(n),
        )
    _build.check(code, "micro_pass3_launch")
    pass3.launches += 1


# Kernel launches since the count was last set to 0.
pass3.launches = 0


def _segments(ids: torch.Tensor, pay: torch.Tensor, n_rows: int):
    """sortagg's core: the ids sorted stably, the payload rows summed per
    distinct id (index_add_ over segment ids, so a segment sums in payload
    order), the distinct ids (n_rows past the last segment) and the
    permutation."""
    sids, order = torch.sort(ids, stable=True)
    spay = pay.index_select(0, order)
    is_start = torch.ones_like(sids, dtype=torch.bool)
    is_start[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(is_start, 0) - 1
    sums = torch.zeros_like(spay).index_add_(0, seg, spay)
    uniq = torch.full_like(sids, n_rows).scatter_(0, seg, sids)
    return sums, uniq, seg, order


def main(argv: list[str] | None = None, device: str = "cuda") -> dict[str, float]:
    """Run the probes named in argv (all by default) and print one line
    each; returns {probe: ms}."""
    dev = resolve_device(device)
    b = int(os.environ.get("BATCH", 8192))
    c = int(os.environ.get("C", 39))
    r = int(os.environ.get("N_FEATS", 1_000_000))
    e = int(os.environ.get("E", 640))
    nnz = b * c
    iters = 6
    rng = np.random.default_rng(0)
    per = r // c
    ids2d = (rng.integers(0, per, (b, c)) + np.arange(c) * per).astype(np.int32)
    ids = torch.from_numpy(ids2d.reshape(-1)).to(dev)
    uniq_np = np.unique(ids2d)
    uniq_ct = uniq_np.size
    print(f"B={b} C={c} R={r} E={e} nnz={nnz} uniq={uniq_ct} device={dev}", flush=True)

    which = list(argv) if argv else list(PROBES)
    unknown = sorted(set(which) - set(PROBES))
    if unknown:
        raise SystemExit(f"unknown probes {unknown}; choose from {list(PROBES)}")
    need = set(which)
    results: dict[str, float] = {}

    def report(name, fn):
        if name not in need:
            return
        ms = time_ms(fn, dev, iters)
        results[name] = ms
        print(f"  {name:13s} {ms:8.2f} ms", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    tab = torch.randn((r, e), generator=gen, device=dev) * 0.1
    tab2 = tab * 1.5
    g = torch.randn((nnz, e), generator=gen, device=dev) * 1e-3
    g2 = g * g if need & {"za_scatter", "cand_now", "cand_sorted"} else None
    gg2 = torch.cat([g, g2], dim=-1) if need & {"sortagg"} else None

    report("gather1", lambda: tab.index_select(0, ids))
    report("gather2", lambda: (tab.index_select(0, ids), tab2.index_select(0, ids)))
    if "gather_wide" in need:
        wide = torch.cat([tab, tab2], dim=-1)
        report("gather_wide", lambda: wide.index_select(0, ids))
        del wide
    report("scat_z", lambda: tab.index_add_(0, ids, g))
    report("scat_acc", lambda: torch.zeros((r, e), device=dev).index_add_(0, ids, g))
    report("za_scatter", lambda: za_scatter(tab, torch.zeros_like(tab), ids, g, g2))

    # the passes step their own tables in place, call after call
    for name in ("pass4", "pass3"):
        if name not in need:
            continue
        a = tab2.abs() * 1e-6
        n_tab, z_tab = tab.abs(), tab2.clone()
        if name == "pass4":
            w_tab = tab * 0.1
            report(name, lambda: closed_form_pass(n_tab, z_tab, w_tab, a, P))
            del w_tab
        else:
            report(name, lambda: pass3(n_tab, z_tab, a, P))
        del a, n_tab, z_tab

    report("sortagg", lambda: _segments(ids, gg2, r)[:2])

    suniq = torch.from_numpy(uniq_np.astype(np.int64)).to(dev)
    report("scatback_set", lambda: (tab.index_copy_(0, suniq, g[:uniq_ct]),
                                    tab2.index_copy_(0, suniq, g[:uniq_ct] * 2)))

    # ---- composed candidates (fwd gather + the whole update) ----
    def cand_now(n, z):
        # lazy fwd: gather n and z, w where gathered
        gn, gz = n.index_select(0, ids), z.index_select(0, ids)
        ftrl_weights(gn, gz, P)
        a = torch.zeros_like(n)
        za_scatter(z, a, ids, g, g2)
        pass3(n, z, a, P)

    def cand_sorted(n, z):
        gn, gz = n.index_select(0, ids), z.index_select(0, ids)
        ftrl_weights(gn, gz, P)
        sums, uniq, seg, order = _segments(ids, torch.cat([g, g2], dim=-1), r)
        # a row of each segment to read (n, z) from
        occ = torch.zeros_like(order).scatter_reduce_(0, seg, order, "amin", include_self=False)
        n_rows, z_rows = gn.index_select(0, occ), gz.index_select(0, occ)
        sum_g, sum_g2 = sums[:, :e], sums[:, e:]
        sigma = _div(torch.sqrt(n_rows + sum_g2) - torch.sqrt(n_rows), ALPHA)
        w_rows = ftrl_weights(n_rows, z_rows, P)
        new_z = z_rows + sum_g - sigma * w_rows
        new_n = n_rows + sum_g2
        rows = uniq[:uniq_ct].long()  # the segments past uniq_ct are empty
        n.index_copy_(0, rows, new_n[:uniq_ct])
        z.index_copy_(0, rows, new_z[:uniq_ct])

    for name, cand in (("cand_now", cand_now), ("cand_sorted", cand_sorted)):
        if name in need:
            n_tab, z_tab = tab.abs(), tab2.clone()
            report(name, lambda: cand(n_tab, z_tab))
            del n_tab, z_tab
    return results


if __name__ == "__main__":
    _device, _argv = split_device(sys.argv[1:])
    main(_argv, _device)
