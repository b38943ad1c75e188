"""Time kernel #1 (csrc/ffm_logits.cu), the update kernel and the z/A
scatter (csrc/ftrl_update.cu), the training kernel #2 (csrc/ffm_fused.cu)
and the RMW probe kernel (csrc/micro_rmw.cu) of one copy of the package on
the card, for A/B runs of two commits on one card, in one run:

    PYTHONPATH=<root> python3 <this file>

imports ftrl_ffm_tpu_torch from <root> (a checkout, or a commit unpacked
with `git archive`), so the same file times either commit; it calls only
entry points both have (ffm_fused_logits, ftrl_update, ftrl_update_linear,
za_scatter, ffm_fused_logits_grads, micro_vmem_rmw2.run_kernel,
micro_vmem_rmw.rmw).
Run it once per root in turns (parent, change, change, parent).  Inputs
come from torch.Generators on the card, seeded, so every run times the same
tensors:

  - kernel #1 at chip_smoke.py's serving shape: B=16,384, F=39, C'=40,
    K=16, canonical fields, f32 rows; CUDA events around 20 calls and its
    device time (20 calls replayed from a CUDA graph);
  - the update kernel at the bench shape (R=100,000, E=640, N=638,976, the
    linear lane 39) on chip_smoke.py's uniform and skewed batches
    (update_inputs, skewed_ids: loaded from the chip_smoke.py two
    directories above this file), f32 payload and w, and bf16 payload and
    w: the SHA-256 of the
    six tables' bytes after one call on fresh copies (equal hashes: the
    same bits), CUDA events around 10 calls (the stable sort included),
    and each kernel's device time per call from torch.profiler (5 calls);
  - the update kernel's narrow forms: E=16 (FM's row, R=100,000, the
    linear stats in gg2_lin, uniform ids) and E=0 (ftrl_update_linear at
    R=100,000 on uniform ids and at 2^22 on Zipf ids), and the z/A scatter
    at FM's [2^22, 16] on uniform and Zipf ids (chip_smoke.py::zipf_ids)
    and FFM's [1M, 640] on uniform and skewed ids: the SHA-256 of the updated tables
    after one call on fresh copies, CUDA events around 10 calls (the
    stable sort included), the stable sort alone on the same ids, and each
    kernel's device time per call from torch.profiler (5 calls);
  - kernel #2 at chip_smoke.py's training shape: B=16,384, F=39, C'=40,
    K=16, canonical fields, the linear gradient in lane 39, combined and
    split output; CUDA events around 10 calls;
  - the RMW variants at the probe's default shape (N=8,192, PER=2,564,
    E=640, f32; base also bf16) and one `index_add` (the one PyTorch call
    that computes base's sum): per call as the probes time it (CUDA events
    around 50 back-to-back wrapper calls, dispatch included), device
    time (50 calls captured in a CUDA graph, replayed between events) and
    each kernel's device time per call from torch.profiler (20 calls), so
    a wrapper that launches two kernels shows both.

Prints one JSON line: the root, the card, and the times in ms.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess

import torch

B, F, CP, K, AUG = 16384, 39, 40, 16, 39
R = 100_000  # the update kernel's table: bench.py's n_feats
N, PER, E = 8192, 2564, 640


def _timers():
    """time_ms, graph_ms and profile_ms of this file's own
    tools/__init__.py, whatever copy of the package the imports below
    resolve to."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "__init__.py")
    spec = importlib.util.spec_from_file_location("_kernel_ab_timers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.time_ms, mod.graph_ms, mod.profile_ms


def _smoke():
    """The chip_smoke.py two directories above this file, as a module (its
    input generators), whatever copy of the package is imported."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_kernel_ab_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha256(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()


def main() -> dict:
    import ftrl_ffm_tpu_torch
    from ftrl_ffm_tpu_torch.ftrl import FtrlParams
    from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits, ffm_fused_logits_grads
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update
    from ftrl_ffm_tpu_torch.tools import micro_vmem_rmw as mrmw
    from ftrl_ffm_tpu_torch.tools import micro_vmem_rmw2 as mrmw2

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    time_ms, graph_ms, profile_ms = _timers()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": os.path.dirname(os.path.dirname(os.path.abspath(ftrl_ffm_tpu_torch.__file__))),
           "card": card}

    v = torch.randn((B * F, CP * K), generator=gen, device=dev) * 0.1
    fields = torch.arange(F, dtype=torch.int32, device=dev).repeat(B, 1)
    vals = torch.rand((B, F), generator=gen, device=dev)
    lin = torch.randn((B,), generator=gen, device=dev) * 0.1
    logits = lambda: ffm_fused_logits(v, fields, vals, lin, CP, K)  # noqa: E731
    out["logits_ms"] = time_ms(logits, dev, 20)
    out["logits_device_ms"] = graph_ms(logits, 20)
    out["logits_sha256"] = _sha256([logits()])
    y = torch.randint(0, 2, (B,), generator=gen, device=dev).to(torch.float32)
    sw = torch.ones((B,), device=dev)
    args = (v, fields, vals, lin, y, sw, CP, K)
    for name, combined in (("fused_ms", True), ("fused_split_ms", False)):
        out[name] = time_ms(
            lambda: ffm_fused_logits_grads(*args, aug_lane=AUG, combined_out=combined), dev, 10)
    del v, fields, vals, args
    torch.cuda.empty_cache()
    # the RMW probe's per-call times before any profiler run (which may
    # leave the host's launch path slower for the rest of the process)
    _time_rmw(out, dev, gen, time_ms, graph_ms, profile_ms, mrmw, mrmw2)
    _time_updates(out, dev, time_ms, profile_ms, ftrl_update, FtrlParams())
    _time_narrow(out, dev, time_ms, profile_ms, FtrlParams())
    return out


def _time_updates(out, dev, time_ms, profile_ms, ftrl_update, p) -> None:
    """The update kernel on chip_smoke.py's uniform and skewed batches, f32
    and bf16: output hashes, per-call and per-kernel times into out."""
    smoke = _smoke()
    updates = {}
    for skewed in (False, True):
        for pay, wdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)):
            ugen = torch.Generator(device=dev).manual_seed(1 + skewed)
            tables, ids, gg2, _ = smoke.update_inputs(R, CP * K, B * F, R, ugen, dev, p, AUG,
                                                      skewed=skewed)
            tables[2] = tables[2].to(wdt)
            gg2 = gg2.to(pay)
            name = f"update_{'skewed' if skewed else 'uniform'}_{str(pay)[6:]}"
            once = [t.clone() for t in tables]
            ftrl_update(*once, ids, gg2, AUG, p)
            call = lambda t=tables, i=ids, g=gg2: ftrl_update(*t, i, g, AUG, p)  # noqa: E731
            out[name] = {"sha256": _sha256(once), "ms": time_ms(call, dev, 10)}
            updates[name] = call
            del once
    for name, call in updates.items():
        out[name]["kernels"] = {k[:80]: ms for k, ms in profile_ms(call, 5)}
    del updates
    torch.cuda.empty_cache()


def _time_narrow(out, dev, time_ms, profile_ms, p) -> None:
    """The update kernel at E=16 and E=0 and the z/A scatter at [2^22, 16]
    and [1M, 640]: output hashes, per-call times beside the stable sort's
    alone, and per-kernel times into out."""
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update, ftrl_update_linear, za_scatter

    smoke = _smoke()
    n, hash_rows = B * F, 1 << 22
    calls = {}

    def add(name, ids, tables, call):
        once = [t.clone() for t in tables]
        call(once)
        out[name] = {"sha256": _sha256(once), "ms": time_ms(lambda: call(tables), dev, 10),
                     "sort_ms": time_ms(lambda: torch.sort(ids, stable=True), dev, 10)}
        calls[name] = lambda: call(tables)

    ugen = torch.Generator(device=dev).manual_seed(3)
    tables, ids, gg2, gg2_lin = smoke.update_inputs(R, K, n, R, ugen, dev, p, -1)
    add("update_k16", ids, tables,
        lambda t, i=ids, g=gg2, gl=gg2_lin: ftrl_update(*t, i, g, -1, p, gl))
    for name, r, zipf in (("update_linear", R, False), ("update_linear_4m_zipf", hash_rows, True)):
        lin = smoke.ftrl_tables(ugen, dev, p, r)
        ids = smoke.zipf_ids(n, r, dev) if zipf else smoke.random_ids(n, r, r, ugen, dev)
        gl = torch.randn((n,), generator=ugen, device=dev) * 0.1
        pairs = torch.stack([gl, gl * gl], dim=-1)
        add(name, ids, lin, lambda t, i=ids, g=pairs: ftrl_update_linear(*t, i, g, p))
    for name, r, e, skew in (("scatter_k16", hash_rows, K, None),
                             ("scatter_k16_zipf", hash_rows, K, "zipf"),
                             ("scatter_1m", 1_000_000, CP * K, None),
                             ("scatter_1m_skewed", 1_000_000, CP * K, "skewed")):
        z, ids, g, g2 = smoke.scatter_inputs(r, e, n, r, ugen, dev)
        if skew == "zipf":
            ids = smoke.zipf_ids(n, r, dev)
        elif skew:
            ids = smoke.skewed_ids(n, r, r, ugen, dev)
        add(name, ids, [z, torch.zeros_like(z)],
            lambda t, i=ids, a=g, b=g2: za_scatter(t[0], t[1], i, a, b))
        del z, g, g2
    del tables, gg2, gg2_lin
    for name, call in calls.items():
        out[name]["kernels"] = {k[:80]: ms for k, ms in profile_ms(call, 5)}
    del calls
    torch.cuda.empty_cache()


def _time_rmw(out, dev, gen, time_ms, graph_ms, profile_ms, mrmw, mrmw2) -> None:
    """The RMW variants, bf16 base and index_add: per call, device time from
    a CUDA graph and per kernel from the profiler, into out."""
    idx = torch.randint(0, PER, (N,), generator=gen, device=dev, dtype=torch.int32)
    pay = torch.randn((N, E), generator=gen, device=dev)
    rows = mrmw2.per_pad(PER)
    acc0 = torch.zeros((rows, E), device=dev)
    calls = {f"rmw2_{v}": (lambda v=v: mrmw2.run_kernel(idx, pay, v, rows))
             for v in mrmw2.VARIANTS}
    pay_bf = pay.to(torch.bfloat16)
    calls["rmw_bf16"] = lambda: mrmw.rmw(idx, pay_bf, -(-PER // 8) * 8)
    calls["index_add"] = lambda: acc0.index_add(0, idx, pay)
    calls["rmw2_rd_no_ids"] = lambda: mrmw2.run_kernel(idx[:0], pay[:0], "rd", rows)
    # per-call times first: a profiler run may leave the host's launch
    # path slower for the rest of the process
    for name, fn in calls.items():
        out[name] = {"ms": time_ms(fn, dev, 50)}
    for name, fn in calls.items():
        out[name]["device_ms"] = graph_ms(fn, 50)
    for name, fn in calls.items():
        out[name]["kernels"] = {k[:80]: ms for k, ms in profile_ms(fn, 20)}


if __name__ == "__main__":
    print(json.dumps(main()))
