"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve, time.

    python3 chip_smoke.py

Drives the port's serving path (ftrl_ffm_tpu_torch) at full width: FFM with
39 fields (field_pad 40), 16 factors, 640-float factor-major rows, a
1,000,000-row table and batches of 16,384, on a seeded random state and a
Criteo-shaped libffm file.  Phases, each printing its own lines:

  1. no card      -> exit 1 at once, no result printed
  2. build        -> nvcc builds every kernel from csrc/ (build seconds)
  3. kernels      -> each CUDA kernel against its plain PyTorch version on
                     the same device tensors, at the main path's shape and in
                     a sweep of edge shapes (f32 sums in another order:
                     rtol=1e-4, atol=1e-5)
  4. serving      -> Trainer.evaluate() and Trainer.predict_file() with the
                     launch counts set to 0 just before and read just after;
                     outputs held against the plain version and a CPU run
  5. timings      -> kernel and plain milliseconds per batch, eval
                     examples/s, the card's name and power limit beside them

Any failure raises and ends the run with a non-zero code.  The next-to-last
line is the kernels' JSON record, the last line the device record.  It
imports nothing of JAX: the port is the program under test.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FIELDS = 39
N_FACTORS = 16
N_FEATS = 1_000_000
BATCH = 16384
N_ROWS = 8 * BATCH  # 131,072 eval rows: 8 batches per pass
RTOL, ATOL = 1e-4, 1e-5  # kernel against plain: f32 sums in another order
SEED = 0


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def write_criteo_like(path: str, n_rows: int, n_feats: int, seed: int = 7) -> None:
    """Criteo-shaped libffm data: one feature per field, ids spread over the
    table, labels from a random linear model (bench.py::ensure_data's
    generator, at this run's row and id counts)."""
    rng = np.random.default_rng(seed)
    per = n_feats // N_FIELDS
    ids = rng.integers(0, per, (n_rows, N_FIELDS)) + np.arange(N_FIELDS) * per
    w = rng.normal(0, 0.3, n_feats)
    y = (w[ids].sum(axis=1) + rng.normal(0, 1, n_rows) > 0).astype(int)
    with open(path, "w") as f:
        for i in range(n_rows):
            toks = [str(y[i])] + [f"{c}:{ids[i, c]}:1" for c in range(N_FIELDS)]
            f.write(" ".join(toks) + "\n")


def seeded_state(cfg, device, seed: int):
    """A serving state built on the device from one torch.Generator:
    factor weights N(0, 0.02) on the live lanes, linear weights N(0, 0.1)
    in lin_w and in the mirror lane (k=0, c=n_fields), a nonzero bias."""
    from ftrl_ffm_tpu_torch.models import ModelState

    g = torch.Generator(device=device).manual_seed(seed)
    r, cp, e = cfg.n_feats, cfg.field_pad, cfg.row_width
    vec_w = torch.randn((r, e), generator=g, device=device) * 0.02
    live = torch.arange(e, device=device) % cp < cfg.n_fields
    vec_w *= live
    lin_w = torch.randn((r,), generator=g, device=device) * 0.1
    vec_w[:, cfg.n_fields] = lin_w
    zeros = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return ModelState(
        bias_n=zeros(),
        # bias weight = closed form at n=0: -(z + l1) / (l2 + beta/alpha)
        bias_z=torch.tensor(-500.0, device=device),
        lin_n=zeros(r), lin_z=zeros(r), lin_w=lin_w,
        vec_n=zeros(r, e), vec_z=zeros(r, e), vec_w=vec_w,
        step=torch.tensor(1, dtype=torch.int32, device=device),
    )


def kernel_inputs(b, f, cp, k, gen, device, fields="iota", n_real=None, pad=True):
    """Device inputs of ffm_fused_logits: rows N(0, 0.1) with the mirror
    lane filled, fields iota (canonical CTR) or random with repeats, and,
    with pad, padding occurrences and a padded sample."""
    e = cp * k
    v = torch.randn((b * f, e), generator=gen, device=device) * 0.1
    if n_real is not None and n_real < cp:
        v[:, n_real] = torch.randn((b * f,), generator=gen, device=device) * 0.3
    if fields == "iota":
        fld = torch.arange(f, dtype=torch.int32, device=device).remainder(cp).expand(b, f)
    else:
        hi = n_real or cp
        fld = torch.randint(0, hi, (b, f), generator=gen, device=device, dtype=torch.int32)
        if fields == "out_of_range":
            fld[:, ::3] = cp + 1
            fld[:, 1::5] = -1
    fld = fld.contiguous()
    vals = torch.rand((b, f), generator=gen, device=device)
    if pad:
        vals[:, -2:] = 0.0
        fld[:, -2:] = 0
        vals[-1] = 0.0
    lin = torch.randn((b,), generator=gen, device=device) * 0.1
    return v, fld, vals, lin


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    # ---- 1. no card ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.data.stream import StreamReader
    from ftrl_ffm_tpu_torch.models.base import widen_batch
    from ftrl_ffm_tpu_torch.ops import _build
    from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits, ffm_fused_logits_plain
    from ftrl_ffm_tpu_torch.ops.interactions import linear_logits
    from ftrl_ffm_tpu_torch.train import Trainer

    device = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(device)
    where = card()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {where}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Compiling")):
            print(f"build: {line.strip()}")

    # ---- 3. kernels against their plain versions ----
    gen = torch.Generator(device=device).manual_seed(SEED)
    cp = Config(model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS).field_pad
    require(cp == 40, f"field_pad {cp} != 40")
    # (label, B, F, C', K, fields, real fields)
    cases = [
        ("criteo", BATCH, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS),
        ("odd_b", 333, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS),
        ("b1", 1, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS),
        ("repeated", 257, N_FIELDS, cp, N_FACTORS, "random", N_FIELDS),
        ("f64", 129, 64, cp, N_FACTORS, "random", N_FIELDS),
        ("f100_unstaged", 65, 100, cp, N_FACTORS, "random", N_FIELDS),
        ("c8_k16", 511, 7, 8, 16, "random", 7),
        ("out_of_range", 97, 12, 8, 16, "out_of_range", 8),
        ("e15_scalar", 31, 6, 5, 3, "random", 5),
    ]
    criteo_err = None
    for label, b, f, c, k, kind, real in cases:
        v, fld, vals, lin = kernel_inputs(b, f, c, k, gen, device, kind, real)
        got = ffm_fused_logits(v, fld, vals, lin, c, k)
        torch.cuda.synchronize()
        ref = ffm_fused_logits_plain(v, fld, vals, lin, c, k)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = torch.allclose(got, ref, rtol=RTOL, atol=ATOL)
        path = "staged" if lib.ffm_logits_stages(f, c * k) == 1 else "device-memory"
        print(f"kernel ffm_logits {label}: B={b} F={f} C'={c} K={k} {path} "
              f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
        require(ok and bool(torch.isfinite(got).all()), f"ffm_logits {label} disagrees")
        if label == "criteo":
            criteo_err = err

    # ---- 4. serving through the entry points ----
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "eval.ffm")
        t0 = time.perf_counter()
        write_criteo_like(data, N_ROWS, N_FEATS)
        print(f"serve: wrote {N_ROWS} Criteo-shaped rows in {time.perf_counter() - t0:.1f} s")
        cfg = Config(
            model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS, n_feats=N_FEATS,
            batch_size=BATCH, eval_data=data, device="cuda", n_threads=4,
        )
        state = seeded_state(cfg, device, SEED)
        trainer = Trainer(cfg, state=state)
        require(trainer.cfg.max_nnz == N_FIELDS, f"sniffed max_nnz {trainer.cfg.max_nnz}")
        model = trainer.model
        preds = os.path.join(tmp, "preds.txt")
        n_batches = math.ceil(N_ROWS / BATCH)

        ffm_fused_logits.launches = 0
        t0 = time.perf_counter()
        loss, auc = trainer.evaluate()
        t_eval = time.perf_counter() - t0
        n_pred = trainer.predict_file(data, preds)
        launches = ffm_fused_logits.launches
        print(f"serve: evaluate loss={loss:.6f} auc={auc:.6f} ({t_eval:.2f} s, first pass); "
              f"predict_file wrote {n_pred}; ffm_logits launches={launches}")
        require(launches == 2 * n_batches,
                f"ffm_logits launched {launches} times, expect {2 * n_batches}")
        require(math.isfinite(loss) and math.isfinite(auc), "non-finite eval metrics")
        require(n_pred == N_ROWS, f"predict_file scored {n_pred} of {N_ROWS}")
        probs = np.loadtxt(preds)
        require(probs.shape == (N_ROWS,) and ((probs > 0) & (probs < 1)).all(),
                "predictions are not one probability per row")

        # reference: the plain version on the same device tensors, batch by
        # batch, closed on the host in float64
        reader = StreamReader(data, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS,
                              log_every=0)
        loss_sum, count, plain_probs, max_err = 0.0, 0.0, [], 0.0
        for arrays in reader.batches():
            batch = widen_batch(trainer._place_batch(arrays))
            got = model.predict_logits(trainer.state, batch)
            vrows = model._gather_vec(trainer.state, batch.feats.reshape(-1))
            w = model._w_lin_from_rows(trainer.state, vrows, batch, model._lin_read_lane())
            lin = linear_logits(w, batch.vals, model.bias_weight(trainer.state))
            ref = ffm_fused_logits_plain(vrows, batch.fields, batch.vals, lin,
                                         model.field_pad, model.n_factors)
            require(torch.allclose(got, ref, rtol=RTOL, atol=ATOL),
                    "serving logits disagree with the plain version")
            max_err = max(max_err, (got - ref).abs().max().item())
            r = ref.double().cpu().numpy()
            y = arrays[3].astype(np.float64)
            m = arrays[4] > 0
            loss_sum += float(np.sum((np.logaddexp(r, 0) - y * r)[m]))
            count += float(m.sum())
            plain_probs.append(1 / (1 + np.exp(-r[m])))
        ref_loss = loss_sum / count
        pdiff = float(np.abs(probs - np.concatenate(plain_probs)).max())
        print(f"serve: plain-version reference loss={ref_loss:.6f} "
              f"(|diff| {abs(ref_loss - loss):.2e}), logits max_abs_err={max_err:.2e}, "
              f"probability max |diff| {pdiff:.2e}")
        require(abs(ref_loss - loss) <= 1e-5 * max(1.0, ref_loss), "eval loss off the reference")
        require(pdiff <= 2e-6, "predictions off the reference")

        # small input: the same serving path on the CPU (plain versions)
        # and on the card agree
        small = dict(model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS,
                     n_feats=5000, batch_size=1024)
        sdata = os.path.join(tmp, "small.ffm")
        write_criteo_like(sdata, 3000, small["n_feats"], seed=11)
        res = {}
        for dev in ("cpu", "cuda"):
            scfg = Config(eval_data=sdata, device=dev, **small)
            sstate = seeded_state(scfg, torch.device("cpu"), SEED + 1)
            res[dev] = Trainer(scfg, state=sstate).evaluate()
        print(f"serve: small input cpu loss/auc={res['cpu']} cuda={res['cuda']}")
        require(abs(res["cpu"][0] - res["cuda"][0]) <= 1e-5, "cpu and cuda eval loss differ")
        require(abs(res["cpu"][1] - res["cuda"][1]) <= 1e-4, "cpu and cuda eval auc differ")

        # ---- 5. timings (the card's name and power limit beside each) ----
        v, fld, vals, lin = kernel_inputs(BATCH, N_FIELDS, cp, N_FACTORS, gen, device,
                                          "iota", N_FIELDS, pad=False)
        kern = lambda: ffm_fused_logits(v, fld, vals, lin, cp, N_FACTORS)  # noqa: E731
        plain = lambda: ffm_fused_logits_plain(v, fld, vals, lin, cp, N_FACTORS)  # noqa: E731
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            runs[which].append(cuda_ms(kern if which == "kernel" else plain,
                                       20 if which == "kernel" else 5))
        k_ms, p_ms = float(np.median(runs["kernel"])), float(np.median(runs["plain"]))
        gbps = v.numel() * 4 / (k_ms * 1e-3) / 1e9
        print(f"timing: ffm_logits B={BATCH} F={N_FIELDS} E={cp * N_FACTORS}: kernel "
              f"{runs['kernel']} ms, plain {runs['plain']} ms; kernel reads v at "
              f"{gbps:.0f} GB/s [{where}]")

        # where the time of one eval pass goes: device compute per batch on
        # pre-placed batches, host parse per batch, and the whole pass
        placed = [trainer._place_batch(a) for a in StreamReader(
            data, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS,
            n_parse_threads=4, log_every=0).batches()]
        cycle = itertools.cycle(placed)
        dev_ms = cuda_ms(lambda: model.eval_step(trainer.state, next(cycle)), 2 * len(placed))
        t0 = time.perf_counter()
        for _ in StreamReader(data, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS,
                              n_parse_threads=4, log_every=0).batches():
            pass
        parse_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            trainer.evaluate()
            passes.append(time.perf_counter() - t0)
        eps = [N_ROWS / t for t in passes]
        print(f"timing: eval_step on the device {dev_ms:.3f} ms/batch; host parse "
              f"{parse_ms:.3f} ms/batch; evaluate() {eps} examples/s "
              f"(n_feats={N_FEATS}, B={BATCH}, {N_ROWS} rows) [{where}]")

    record = {
        "name": "ffm_logits",
        "route": "cuda",
        "source": "ftrl_ffm_tpu_torch/csrc/ffm_logits.cu",
        "replaces": "ftrl_ffm_tpu/ops/ffm_pallas.py:235",
        "launches": launches,
        "max_abs_err": criteo_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
