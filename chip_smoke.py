"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve,
train, time.

    python3 chip_smoke.py

Drives the port's serving and training paths (ftrl_ffm_tpu_torch) at full
width: FFM with 39 fields (field_pad 40), 16 factors, 640-float
factor-major rows and batches of 16,384 — serving a seeded random state of a
1,000,000-row table, training a fresh 100,000-row one (bench.py's model) —
on Criteo-shaped libffm files.  Phases, each printing its own lines:

  1. no card      -> exit 1 at once, no result printed
  2. build        -> nvcc builds every kernel from csrc/ (build seconds)
  3. kernels      -> the logits kernel against its plain PyTorch version on
                     the same device tensors, at the main path's shape and in
                     a sweep of edge shapes (f32 sums in another order:
                     rtol=1e-4, atol=1e-5)
  3b. fused       -> the training kernel (logits + payload) against its plain
                     version, the same way (logits rtol=1e-4, atol=1e-5;
                     payload rtol=1e-4, atol=1e-6)
  3c. update      -> the FTRL update kernel against its plain version on
                     random tables with duplicate and sentinel ids: touched
                     rows rtol=1e-5, atol=1e-6, untouched rows bit-identical,
                     the same call twice bit-identical
  4. serving      -> Trainer.evaluate() and Trainer.predict_file() with the
                     launch counts set to 0 just before and read just after;
                     outputs held against the plain version and a CPU run
  4b. training    -> Trainer(cfg).train() for 2 epochs with eval, the launch
                     counts set to 0 just before and read just after; chained
                     train_steps against the same steps on the plain versions,
                     two runs bit-identical, a small run on the CPU and the card
  5. timings      -> kernel and plain milliseconds per batch, eval
                     examples/s, the card's name and power limit beside them
  5b. train time  -> the training kernels and their plain versions, the
                     device train step, host parse, train_epoch() examples/s

Any failure raises and ends the run with a non-zero code.  The next-to-last
line is the kernels' JSON record, the last line the device record.  It
imports nothing of JAX: the port is the program under test.
"""

from __future__ import annotations

import contextlib
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
N_ROWS = 8 * BATCH  # 131,072 eval or train rows: 8 batches per pass
TRAIN_FEATS = 100_000  # bench.py's table
RTOL, ATOL = 1e-4, 1e-5  # kernel against plain: f32 sums in another order
GRAD_ATOL = 1e-6  # payload: the JAX suite's kernel-vs-XLA bound
UPD_RTOL, UPD_ATOL = 1e-5, 1e-6  # update kernel against plain, touched rows
# chained train steps, kernels against plain versions: ulp noise compounds
# through the closed form's |z| <= l1 threshold (the JAX suite's bound)
CHAIN_RTOL, CHAIN_ATOL = 2e-3, 5e-5
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
    write_criteo_split([(path, n_rows)], n_feats, seed)


def write_criteo_split(parts, n_feats: int, seed: int = 7) -> None:
    """write_criteo_like's rows, one generator, cut into consecutive files:
    parts = [(path, rows), ...] (train and eval rows of one model)."""
    n_rows = sum(rows for _, rows in parts)
    rng = np.random.default_rng(seed)
    per = n_feats // N_FIELDS
    ids = rng.integers(0, per, (n_rows, N_FIELDS)) + np.arange(N_FIELDS) * per
    w = rng.normal(0, 0.3, n_feats)
    y = (w[ids].sum(axis=1) + rng.normal(0, 1, n_rows) > 0).astype(int)
    start = 0
    for path, rows in parts:
        with open(path, "w") as f:
            for i in range(start, start + rows):
                toks = [str(y[i])] + [f"{c}:{ids[i, c]}:1" for c in range(N_FIELDS)]
                f.write(" ".join(toks) + "\n")
        start += rows


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


def fused_inputs(b, f, cp, k, gen, device, fields, n_real):
    """kernel_inputs plus labels and sample weights; with B > 1 the last
    sample is padding (values 0, weight 0)."""
    v, fld, vals, lin = kernel_inputs(b, f, cp, k, gen, device, fields, n_real, pad=b > 1)
    y = torch.randint(0, 2, (b,), generator=gen, device=device).to(torch.float32)
    sw = torch.ones((b,), device=device)
    if b > 1:
        sw[-1] = 0.0
    return v, fld, vals, lin, y, sw


def update_inputs(r, e, n, hi, gen, device, p, lane):
    """Tables, ids and payloads for ftrl_update.  The tables are what
    training leaves: a touched coordinate (n > 0) holds w = closed form of
    (n, z), an untouched one its init.  Ids repeat, are drawn from [0, hi)
    so rows hi..r-1 stay untouched, and 2% are the padding sentinel r."""
    from ftrl_ffm_tpu_torch.ftrl import UNTOUCHED_N, ftrl_weights

    def table(*shape):
        n_tab = torch.rand(shape, generator=gen, device=device) * 3 + 1e-3
        n_tab = torch.where(torch.rand(shape, generator=gen, device=device) < 0.7, n_tab, 0.0)
        z_tab = torch.randn(shape, generator=gen, device=device)
        init = torch.randn(shape, generator=gen, device=device) * 0.02
        w_tab = torch.where(n_tab > UNTOUCHED_N, ftrl_weights(n_tab, z_tab, p), init)
        return [n_tab, z_tab, w_tab]

    tables = table(r, e) + table(r)
    ids = torch.randint(0, hi, (n,), generator=gen, device=device, dtype=torch.int32)
    ids[torch.randperm(n, generator=gen, device=device)[: n // 50]] = r
    g = torch.randn((n, e), generator=gen, device=device) * 0.1
    gl = torch.randn((n,), generator=gen, device=device) * 0.1
    gg2_lin = None if lane >= 0 else torch.stack([gl, gl * gl], dim=-1)
    return tables, ids, torch.cat([g, g * g], dim=-1), gg2_lin


def clone_state(state):
    return type(state)(*(None if t is None else t.clone() for t in state))


@contextlib.contextmanager
def plain_kernels():
    """Within: Model.train_step runs the plain PyTorch versions of the
    training kernels (the in-place update copies the plain result in)."""
    import ftrl_ffm_tpu_torch.models.base as mbase
    import ftrl_ffm_tpu_torch.models.ffm as mffm
    from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits_grads_plain
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update_plain

    def update(*args):
        vec, lin = ftrl_update_plain(*args)
        for dst, src in zip(args[:6], (*vec, *lin)):
            dst.copy_(src)

    saved = mffm.ffm_fused_logits_grads, mbase.ftrl_update
    mffm.ffm_fused_logits_grads, mbase.ftrl_update = ffm_fused_logits_grads_plain, update
    try:
        yield
    finally:
        mffm.ffm_fused_logits_grads, mbase.ftrl_update = saved


def interleaved_ms(kern, plain, kern_iters: int, plain_iters: int):
    """Kernel and plain ms per call, runs in the order plain, kernel,
    kernel, plain; returns (runs, kernel median, plain median)."""
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn, iters = (kern, kern_iters) if which == "kernel" else (plain, plain_iters)
        runs[which].append(cuda_ms(fn, iters))
    return runs, float(np.median(runs["kernel"])), float(np.median(runs["plain"]))


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
    from ftrl_ffm_tpu_torch.ftrl import FtrlParams
    from ftrl_ffm_tpu_torch.models import make_model
    from ftrl_ffm_tpu_torch.models.base import widen_batch
    from ftrl_ffm_tpu_torch.ops import _build
    from ftrl_ffm_tpu_torch.ops.ffm_cuda import (
        ffm_fused_logits,
        ffm_fused_logits_grads,
        ffm_fused_logits_grads_plain,
        ffm_fused_logits_plain,
    )
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update, ftrl_update_plain
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

    # ---- 3b. the training kernel against its plain version ----
    # (label, B, F, C', K, fields, real fields, aug lane)
    fused_cases = [
        ("criteo", BATCH, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS, N_FIELDS),
        ("odd_b", 333, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS, N_FIELDS),
        ("b1", 1, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS, N_FIELDS),
        ("repeated", 257, N_FIELDS, cp, N_FACTORS, "random", N_FIELDS, N_FIELDS),
        ("f64", 129, 64, cp, N_FACTORS, "random", N_FIELDS, N_FIELDS),
        ("f100_unstaged", 65, 100, cp, N_FACTORS, "random", N_FIELDS, N_FIELDS),
        ("c8_k16_aug7", 511, 7, 8, 16, "random", 7, 7),
        ("out_of_range", 97, 12, 8, 16, "out_of_range", 8, -1),
        ("no_aug", 200, 8, 8, 16, "random", 8, -1),
        ("e15_scalar", 31, 6, 5, 3, "random", 4, 4),
    ]
    fused_err = None
    for label, b, f, c, k, kind, real, aug in fused_cases:
        args = fused_inputs(b, f, c, k, gen, device, kind, real)
        logits, gg2 = ffm_fused_logits_grads(*args, c, k, aug_lane=aug)
        torch.cuda.synchronize()
        ref_logits, ref_gg2 = ffm_fused_logits_grads_plain(*args, c, k, aug_lane=aug)
        torch.cuda.synchronize()
        err = max((logits - ref_logits).abs().max().item(), (gg2 - ref_gg2).abs().max().item())
        ok = (torch.allclose(logits, ref_logits, rtol=RTOL, atol=ATOL)
              and torch.allclose(gg2, ref_gg2, rtol=RTOL, atol=GRAD_ATOL)
              and bool(torch.isfinite(gg2).all()))
        path = "staged" if lib.ffm_fused_stages(f, c, k) == 1 else "device-memory"
        print(f"kernel ffm_fused {label}: B={b} F={f} C'={c} K={k} aug={aug} {path} "
              f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
        require(ok, f"ffm_fused {label} disagrees")
        if label == "criteo":
            fused_err = err
        del args, logits, gg2, ref_logits, ref_gg2

    # ---- 3c. the update kernel against its plain version ----
    p = FtrlParams()
    # (label, R, E, N, ids drawn from [0, hi), linear lane)
    update_cases = [
        ("bench_aug", TRAIN_FEATS, cp * N_FACTORS, BATCH * N_FIELDS, TRAIN_FEATS, N_FIELDS),
        ("no_aug", 5000, 128, 8000, 4000, -1),
        ("e15_dups", 50, 15, 1000, 40, 4),
    ]
    update_err = None
    for label, r, e, n, hi, lane in update_cases:
        tables, ids, gg2, gg2_lin = update_inputs(r, e, n, hi, gen, device, p, lane)
        runs = []
        for _ in range(2):
            got = [t.clone() for t in tables]
            ftrl_update(*got, ids, gg2, lane, p, gg2_lin)
            torch.cuda.synchronize()
            runs.append(got)
        vec, lin = ftrl_update_plain(*tables, ids, gg2, lane, p, gg2_lin)
        torch.cuda.synchronize()
        touched = torch.zeros(r, dtype=torch.bool, device=device)
        touched[ids[ids < r].long()] = True
        err, ok = 0.0, True
        for got, want, before in zip(runs[0], (*vec, *lin), tables):
            err = max(err, (got[touched] - want[touched]).abs().max().item())
            ok &= torch.allclose(got[touched], want[touched], rtol=UPD_RTOL, atol=UPD_ATOL)
            ok &= torch.equal(got[~touched], want[~touched])
            ok &= torch.equal(got[~touched], before[~touched])
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"kernel ftrl_update {label}: R={r} E={e} N={n} lane={lane} touched rows "
              f"{int(touched.sum())} max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}; "
              f"repeat bit-identical={same}")
        require(ok, f"ftrl_update {label} disagrees")
        require(same, f"ftrl_update {label} is not deterministic")
        if label == "bench_aug":
            update_err = err
        del tables, ids, gg2, gg2_lin, runs, vec, lin

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

        # ---- 4b. training through the entry points ----
        train_p, eval_p = os.path.join(tmp, "train.ffm"), os.path.join(tmp, "teval.ffm")
        t0 = time.perf_counter()
        write_criteo_split([(train_p, N_ROWS), (eval_p, BATCH)], TRAIN_FEATS)
        print(f"train: wrote {N_ROWS} + {BATCH} Criteo-shaped rows in "
              f"{time.perf_counter() - t0:.1f} s")
        tcfg = Config(
            model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS, n_feats=TRAIN_FEATS,
            batch_size=BATCH, train_data=train_p, eval_data=eval_p, n_epochs=2,
            device="cuda", n_threads=4,
        )
        ttrainer = Trainer(tcfg)
        tmodel = ttrainer.model
        ffm_fused_logits_grads.launches = ftrl_update.launches = 0
        ffm_fused_logits.launches = 0
        t0 = time.perf_counter()
        hist = ttrainer.train()
        t_train = time.perf_counter() - t0
        fused_launches, update_launches = ffm_fused_logits_grads.launches, ftrl_update.launches
        eval_launches = ffm_fused_logits.launches
        steps = ttrainer._steps_done
        print(f"train: Trainer.train() 2 epochs in {t_train:.2f} s (first, with build "
              f"and warm-up): {steps} steps; ffm_fused launches={fused_launches}, "
              f"ftrl_update launches={update_launches}, ffm_logits launches (eval) "
              f"={eval_launches}; history {hist}")
        require(steps == 2 * n_batches, f"{steps} train steps, expect {2 * n_batches}")
        require(fused_launches == steps, f"ffm_fused launched {fused_launches} times in {steps} steps")
        require(update_launches == steps, f"ftrl_update launched {update_launches} times in {steps} steps")
        require(all(math.isfinite(x) for k in ("train_loss", "eval_loss", "eval_auc")
                    for x in hist[k]), "non-finite training history")
        require(hist["train_loss"][1] < hist["train_loss"][0], "epoch 2 train loss is not below epoch 1's")
        require(hist["eval_auc"][-1] > 0.5, "eval AUC not above 0.5")

        # 3 chained train_steps, kernels against plain versions from one state
        batches = [ttrainer._place_batch(a) for a in itertools.islice(StreamReader(
            train_p, "libffm", BATCH, N_FIELDS, TRAIN_FEATS, N_FIELDS, log_every=0
        ).batches(), 3)]
        base = clone_state(ttrainer.state)
        s_kern, s_plain, s_again = (clone_state(base) for _ in range(3))
        loss_diff = 0.0
        for batch in batches:
            out_k = tmodel.train_step(s_kern, batch)
            with plain_kernels():
                out_p = tmodel.train_step(s_plain, batch)
            tmodel.train_step(s_again, batch)
            loss_diff = max(loss_diff, abs(out_k.loss_sum.item() - out_p.loss_sum.item())
                            / abs(out_p.loss_sum.item()))
        zerr = {name: (getattr(s_kern, name) - getattr(s_plain, name)).abs().max().item()
                for name in ("lin_z", "vec_z", "vec_w")}
        chain_ok = all(torch.allclose(getattr(s_kern, name), getattr(s_plain, name),
                                      rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
                       for name in ("lin_z", "vec_z"))
        same = all(torch.equal(a, b) for a, b in zip(s_kern, s_again))
        print(f"train: 3 chained steps, kernels vs plain: loss rel diff {loss_diff:.2e}, "
              f"max |diff| {zerr}; two kernel runs bit-identical={same}")
        require(chain_ok, "chained train steps disagree with the plain versions")
        require(same, "two runs of the same train steps differ")
        del base, s_kern, s_plain, s_again

        # small training on the CPU (plain versions) and on the card, one init
        small_t = dict(model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS,
                       n_feats=5000, batch_size=1024, n_epochs=2)
        st_p, se_p = os.path.join(tmp, "strain.ffm"), os.path.join(tmp, "seval.ffm")
        write_criteo_split([(st_p, 3000), (se_p, 1000)], small_t["n_feats"], seed=11)
        init = make_model(Config(device="cpu", **small_t)).init(
            torch.Generator().manual_seed(SEED + 2))
        tres = {}
        for dev in ("cpu", "cuda"):
            scfg = Config(train_data=st_p, eval_data=se_p, device=dev, **small_t)
            tres[dev] = Trainer(scfg, state=clone_state(init)).train()
        print(f"train: small run eval loss cpu={tres['cpu']['eval_loss']} "
              f"cuda={tres['cuda']['eval_loss']}")
        require(abs(tres["cpu"]["eval_loss"][-1] - tres["cuda"]["eval_loss"][-1]) <= 1e-4,
                "cpu and cuda training reach different eval losses")

        # ---- 5. timings (the card's name and power limit beside each) ----
        v, fld, vals, lin = kernel_inputs(BATCH, N_FIELDS, cp, N_FACTORS, gen, device,
                                          "iota", N_FIELDS, pad=False)
        runs, k_ms, p_ms = interleaved_ms(
            lambda: ffm_fused_logits(v, fld, vals, lin, cp, N_FACTORS),
            lambda: ffm_fused_logits_plain(v, fld, vals, lin, cp, N_FACTORS), 20, 5)
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

        # ---- 5b. training timings ----
        args = fused_inputs(BATCH, N_FIELDS, cp, N_FACTORS, gen, device, "iota", N_FIELDS)
        fruns, f_ms, fp_ms = interleaved_ms(
            lambda: ffm_fused_logits_grads(*args, cp, N_FACTORS, aug_lane=N_FIELDS),
            lambda: ffm_fused_logits_grads_plain(*args, cp, N_FACTORS, aug_lane=N_FIELDS),
            10, 3)
        e = cp * N_FACTORS
        gbps = BATCH * N_FIELDS * e * 4 * 3 / (f_ms * 1e-3) / 1e9
        print(f"timing: ffm_fused B={BATCH} F={N_FIELDS} E={e}: kernel {fruns['kernel']} "
              f"ms, plain {fruns['plain']} ms; kernel moves v + payload at {gbps:.0f} GB/s "
              f"[{where}]")
        del args
        tables, ids, gg2, _ = update_inputs(TRAIN_FEATS, e, BATCH * N_FIELDS, TRAIN_FEATS,
                                            gen, device, p, N_FIELDS)
        uruns, u_ms, up_ms = interleaved_ms(
            lambda: ftrl_update(*tables, ids, gg2, N_FIELDS, p),
            lambda: ftrl_update_plain(*tables, ids, gg2, N_FIELDS, p), 10, 3)
        print(f"timing: ftrl_update R={TRAIN_FEATS} E={e} N={BATCH * N_FIELDS}: kernel "
              f"{uruns['kernel']} ms, plain {uruns['plain']} ms [{where}]")
        del tables, ids, gg2
        tplaced = [ttrainer._place_batch(a) for a in StreamReader(
            train_p, "libffm", BATCH, N_FIELDS, TRAIN_FEATS, N_FIELDS,
            n_parse_threads=4, log_every=0).batches()]
        tcycle = itertools.cycle(tplaced)
        step_ms = cuda_ms(lambda: tmodel.train_step(ttrainer.state, next(tcycle)),
                          2 * len(tplaced))
        t0 = time.perf_counter()
        for _ in StreamReader(train_p, "libffm", BATCH, N_FIELDS, TRAIN_FEATS, N_FIELDS,
                              n_parse_threads=4, log_every=0).batches():
            pass
        tparse_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        epochs = []
        for _ in range(3):
            t0 = time.perf_counter()
            ttrainer.train_epoch()
            torch.cuda.synchronize()
            epochs.append(time.perf_counter() - t0)
        teps = [N_ROWS / t for t in epochs]
        print(f"timing: train_step on the device {step_ms:.3f} ms/batch; host parse "
              f"{tparse_ms:.3f} ms/batch; train_epoch() {teps} examples/s "
              f"(n_feats={TRAIN_FEATS}, B={BATCH}, {N_ROWS} rows) [{where}]")

    records = [
        {
            "name": "ffm_logits",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ffm_logits.cu",
            "replaces": "ftrl_ffm_tpu/ops/ffm_pallas.py:235",
            "launches": launches,
            "max_abs_err": criteo_err,
            "ms": k_ms,
            "plain_ms": p_ms,
        },
        {
            "name": "ffm_fused",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ffm_fused.cu",
            "replaces": "ftrl_ffm_tpu/ops/ffm_pallas.py:38",
            "launches": fused_launches,
            "max_abs_err": fused_err,
            "ms": f_ms,
            "plain_ms": fp_ms,
        },
        {
            # no Pallas kernel: XLA's scatter-add and closed-form pass of
            # ftrl_ffm_tpu/ftrl.py::dense_ftrl_update2_aug
            "name": "ftrl_update",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ftrl_update.cu",
            "replaces": "ftrl_ffm_tpu/ftrl.py:249",
            "launches": update_launches,
            "max_abs_err": update_err,
            "ms": u_ms,
            "plain_ms": up_ms,
        },
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
