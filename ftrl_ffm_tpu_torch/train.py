"""Training and serving orchestration on one device (the single-process
subset of ftrl_ffm_tpu/train.py).

`Trainer.train`, `train_epoch`, `evaluate` and `predict_file` behave as the
JAX package's: the same streamed (online, or --cmd stdin) or shuffled
(offline, numpy default_rng(seed)) fixed-shape batches, the same per-epoch
lines and history, per-step loss sums kept on the device and read back
once per epoch, the same masked eval log-loss with a compensated (Kahan)
f32 chain on the device, the same binned or exact AUC, the same
one-probability-per-line output.  Batches cross to the card through pinned
host memory with non-blocking copies.  The background feeder and the
device-resident dataset arrive with later slices (ROADMAP.md Queue 1); with
device_cache=auto the port streams, which gives the batches the JAX
package's cached replay gives.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Optional

import numpy as np
import torch

from ftrl_ffm_tpu_torch.config import (
    Config,
    check_ported,
    detect_file_type,
    not_ported,
)
from ftrl_ffm_tpu_torch.data.loader import batch_iterator, load_file
from ftrl_ffm_tpu_torch.data.parser import sniff_max_nnz
from ftrl_ffm_tpu_torch.data.stream import StreamReader
from ftrl_ffm_tpu_torch.ftrl import select_update_kind
from ftrl_ffm_tpu_torch.io.checkpoint import IncompatibleStateError
from ftrl_ffm_tpu_torch.metrics import (
    AUC_BINS,
    LossAccumulator,
    StreamingAUC,
    exact_auc,
    kahan_add,
)
from ftrl_ffm_tpu_torch.models import Batch, ModelState, make_model


def resolve_device(name: str) -> torch.device:
    """The torch device for Config.device.  "cuda" without a card raises:
    the port never moves a run to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r}: no CUDA device is available (pass "
                f"--device cpu to run the plain PyTorch versions on the CPU)"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _validate_state_shapes(cfg: Config, state: ModelState) -> None:
    """Table shapes and dtypes must be what this config's model reads
    (ftrl_ffm_tpu/train.py::_validate_state_shapes), with a named error
    instead of a shape failure deep inside the first batch."""
    for name, t in state._asdict().items():
        if t is not None and not isinstance(t, torch.Tensor):
            raise TypeError(
                f"state field {name} is {type(t).__name__}, expect a tensor "
                f"(io/checkpoint.py::state_from_jax_arrays converts arrays)"
            )
    r, w = cfg.n_feats, cfg.row_width
    issues = []
    if tuple(state.lin_n.shape) != (r,):
        issues.append(
            f"linear tables have {tuple(state.lin_n.shape)} rows, config "
            f"n_feats={r} expects ({r},)"
        )
    if w:
        if state.vec_n is None:
            issues.append(
                f"state has no factor tables, but model_type="
                f"{cfg.model_type} expects [{r}, {w}]"
            )
        else:
            if tuple(state.vec_n.shape) != (r, w):
                issues.append(
                    f"factor tables are {tuple(state.vec_n.shape)}, config "
                    f"(model_type={cfg.model_type}, n_feats={r}, "
                    f"n_fields={cfg.n_fields}, field_pad={cfg.field_pad}, "
                    f"n_factors={cfg.n_factors}) expects ({r}, {w})"
                )
            if state.vec_w.dtype != getattr(torch, cfg.table_dtype):
                issues.append(
                    f"factor weight table is {state.vec_w.dtype}, config "
                    f"table_dtype={cfg.table_dtype}"
                )
    elif state.vec_n is not None:
        issues.append(
            f"state has factor tables {tuple(state.vec_n.shape)}, but "
            f"model_type={cfg.model_type} has none"
        )
    if issues:
        raise IncompatibleStateError(
            "loaded state is incompatible with this config: "
            + "; ".join(issues)
            + ". Resume with the original flags, or retrain."
        )


def estimate_hbm_bytes(cfg: Config) -> dict:
    """Device-memory estimate for the train step on one device: resident
    state and update working set (ftrl_ffm_tpu/train.py::estimate_hbm_bytes,
    its single-device terms; "route" stays 0 until meshes arrive, ROADMAP.md
    Queue 1 item 8).  The port's own allocations: the in-place kind's one
    [R, D] accumulator, and no table-shaped accumulator for "dense2" and
    "sparse2", whose kernel updates the touched rows in place.  Approximate
    by design: the big allocations only."""
    w = max(1, cfg.row_width)
    r = cfg.n_feats
    nnz = cfg.batch_size * max(1, cfg.max_nnz)
    w_bytes = 2 if cfg.table_dtype == "bfloat16" else 4
    # resident: factor n/z (f32) + w (table_dtype) + three linear tables
    state_b = r * w * (4 + 4 + w_bytes) + 3 * r * 4
    kind = select_update_kind(r, w, nnz, cfg.update_mode)
    work_b = r * w * 4 if kind == "inplace" else 0
    # gathered rows + the (g, g^2) payload of the batch
    work_b += 3 * nnz * w * 4
    return {"state": state_b, "work": work_b, "route": 0, "total": state_b + work_b}


def device_memory_bytes(device: torch.device) -> Optional[int]:
    """The card's total memory, or None for the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


class Trainer:
    def __init__(self, cfg: Config, state: Optional[ModelState] = None):
        """A trainer on cfg.device: a fresh seeded init, or `state` moved to
        the device.  Training updates the state's tensors in place, so a
        state already on the device is trained as it is (clone it to keep
        it)."""
        # eval-/predict-only Trainers sniff format and nnz from eval_data
        sniff_src = cfg.train_data or cfg.eval_data
        if not cfg.file_type and sniff_src:
            cfg.file_type = detect_file_type(sniff_src)
        if cfg.cmd and not cfg.file_type:
            raise ValueError(
                "--cmd (stdin) streaming cannot auto-detect the format; "
                "pass --file_type libsvm|libffm"
            )
        if cfg.cmd and cfg.max_nnz <= 0:
            raise ValueError("--cmd (stdin) streaming cannot sniff nnz; pass --max_nnz")
        cfg.validate_file_type()
        if cfg.max_nnz <= 0 and sniff_src:
            cfg.max_nnz = sniff_max_nnz(sniff_src, cfg.file_type)
        if cfg.max_nnz <= 0:
            raise ValueError(
                "max_nnz unknown: pass --max_nnz or provide train/eval data to "
                "sniff it from"
            )
        check_ported(cfg)
        self.device = resolve_device(cfg.device)
        self.cfg = cfg
        self.model = make_model(cfg)
        self._warn_if_oversized()
        if state is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed)
            self.state = self.model.init(gen)
        else:
            _validate_state_shapes(cfg, state)
            self.state = ModelState(
                *(None if t is None else t.to(self.device) for t in state)
            )
        self._steps_done = 0

    def _warn_if_oversized(self) -> None:
        """Warn before the first step when the estimated state and update
        working set (estimate_hbm_bytes) come near the card's memory
        (ftrl_ffm_tpu/train.py::_warn_if_oversized, which reads the TPU's
        limit).  A warning only: the estimate is approximate."""
        limit = device_memory_bytes(self.device)
        if limit is None:
            return
        est = estimate_hbm_bytes(self.cfg)
        if est["total"] > 0.9 * limit:
            import warnings

            warnings.warn(
                f"estimated device memory need ~{est['total'] / 1e9:.1f} GB "
                f"(state {est['state'] / 1e9:.1f} + update working set "
                f"{est['work'] / 1e9:.1f}) vs ~{limit / 1e9:.0f} GB on "
                f"{self.device}: running out of device memory is likely (the "
                f"estimate ignores temporaries).  Reduce --batch_size or "
                f"--n_feats."
            )

    # ---- the linear tables of the in-place form ----
    @property
    def logical_state(self) -> ModelState:
        """The state with the linear tables reconciled from the mirror lane
        where the in-place form lets them ride stale
        (ftrl_ffm_tpu/train.py::Trainer.logical_state): every read of the
        state outside training goes through this."""
        self._maybe_sync_lin()
        return self.state

    def _lin_rides_stale(self) -> bool:
        """True when train steps skip the linear tables and leave them
        stale: the in-place kind with the dead-lane mirror
        (Model._lin_mirror_maintained)."""
        st = self.state
        if st.vec_n is None:
            return False
        nnz = self.cfg.batch_size * max(1, self.cfg.max_nnz)
        kind = select_update_kind(
            st.vec_n.shape[0], st.vec_n.shape[-1], nnz, self.cfg.update_mode
        )
        return kind == "inplace" and self.model._lin_mirror_maintained()

    def _maybe_sync_lin(self) -> None:
        """Reconcile stale linear tables from the mirror lane; idempotent,
        at boundaries only."""
        if self._lin_rides_stale():
            self.state = self.model.sync_lin_from_mirror(self.state)

    # ---- batch plumbing ----
    def _place_batch(self, arrays) -> Batch:
        """Upload one host batch (fields, feats, vals, y, sample_w).  On the
        card through pinned host memory with non-blocking copies, so the
        upload overlaps the kernels still queued from the previous batch."""
        ts = [torch.from_numpy(a) for a in arrays]
        if self.device.type == "cuda":
            ts = [t.pin_memory().to(self.device, non_blocking=True) for t in ts]
        return Batch(*ts)

    def _dataset(self, role: str):
        """The offline in-memory dataset of `role` ("train" or "eval"),
        loaded once (reference: src/task/ftrl_offline.cpp:21-42)."""
        attr = f"_{role}_ds"
        if not hasattr(self, attr):
            cfg = self.cfg
            setattr(self, attr, load_file(
                cfg.train_data if role == "train" else cfg.eval_data,
                cfg.file_type, cfg.max_nnz, cfg.n_feats, cfg.n_fields,
                n_workers=cfg.n_threads,
            ))
        return getattr(self, attr)

    def _train_batches(self, epoch_rng: np.random.Generator):
        cfg = self.cfg
        if cfg.online:
            reader = StreamReader(
                sys.stdin if cfg.cmd else cfg.train_data,
                cfg.file_type,
                cfg.batch_size,
                cfg.max_nnz,
                cfg.n_feats,
                cfg.n_fields,
                n_parse_threads=cfg.n_threads,
            )
            return reader.batches()
        return batch_iterator(
            self._dataset("train"), cfg.batch_size, shuffle=cfg.shuffle,
            rng=epoch_rng, sentinel=cfg.n_feats,
        )

    def _eval_batches(self):
        cfg = self.cfg
        if cfg.online:
            reader = StreamReader(
                cfg.eval_data,
                cfg.file_type,
                cfg.batch_size,
                cfg.max_nnz,
                cfg.n_feats,
                cfg.n_fields,
                n_parse_threads=cfg.n_threads,
            )
            return reader.batches()
        return batch_iterator(
            self._dataset("eval"), cfg.batch_size, shuffle=False, sentinel=cfg.n_feats
        )

    # ---- training ----
    def train_epoch(self, epoch_rng: Optional[np.random.Generator] = None) -> float:
        """One pass over the training data; returns its mean log-loss
        (ftrl_ffm_tpu/train.py::Trainer.train_epoch).  The per-step loss
        sums stay on the device: one readback per epoch, closed on the host
        in float64 (the reference accumulates double over whole passes,
        src/task/ftrl_online.cpp:82-94)."""
        if epoch_rng is None:
            # persistent, so repeated calls do not repeat one permutation
            if not hasattr(self, "_epoch_rng"):
                self._epoch_rng = np.random.default_rng(self.cfg.seed)
            epoch_rng = self._epoch_rng
        sums = []
        for arrays in self._train_batches(epoch_rng):
            out = self.model.train_step(self.state, self._place_batch(arrays))
            sums.append(torch.stack([out.loss_sum, out.count]))
        self._steps_done += len(sums)
        if not sums:
            return float("nan")
        ls_ct = torch.stack(sums).cpu().numpy()
        acc = LossAccumulator()
        acc.update(
            np.sum(ls_ct[:, 0], dtype=np.float64), np.sum(ls_ct[:, 1], dtype=np.float64)
        )
        return acc.mean

    def train(self, profile_dir: Optional[str] = None) -> dict:
        """The multi-epoch run: train, then evaluate after each epoch when
        eval_data is set, printing the reference's per-epoch lines
        (ftrl_ffm_tpu/train.py::Trainer.train; reference:
        src/task/ftrl_online.cpp:45-67).  Returns the history dict."""
        if profile_dir:
            raise not_ported("--profile_dir", 9)
        cfg = self.cfg
        history = {"train_loss": [], "eval_loss": [], "eval_auc": [], "route_overflow": []}
        rng = np.random.default_rng(cfg.seed)
        for epoch in range(1, cfg.n_epochs + 1):
            t0 = time.perf_counter()
            # the epoch's one loss readback waits for its last step
            train_loss = self.train_epoch(rng)
            dt = time.perf_counter() - t0
            print(f"epoch {epoch} train time: {dt:.4f}s, train loss: {train_loss:.4f}")
            history["train_loss"].append(train_loss)
            # routed lookups drop nothing on one device
            history["route_overflow"].append(0)
            if cfg.eval_data:
                t0 = time.perf_counter()
                eval_loss, eval_auc = self.evaluate()
                dt = time.perf_counter() - t0
                if cfg.eval_auc:
                    print(
                        f"epoch {epoch} eval time: {dt:.4f}s, "
                        f"eval loss: {eval_loss:.4f}, eval auc: {eval_auc:.4f}"
                    )
                else:
                    print(f"epoch {epoch} eval time: {dt:.4f}s, eval loss: {eval_loss:.4f}")
                history["eval_loss"].append(eval_loss)
                history["eval_auc"].append(eval_auc)
        return history

    # ---- serving ----
    def evaluate(self) -> tuple[float, float]:
        """(mean log-loss, AUC) over eval_data (ftrl_ffm_tpu/train.py::
        evaluate, streamed form).  Per-batch sums chain on the device with
        Kahan compensation; one readback at the end."""
        exact = self.cfg.eval_auc and self.cfg.auc_mode == "exact"
        acc = LossAccumulator()
        auc = StreamingAUC(AUC_BINS)
        score_rows: list = []
        tot = None
        for arrays in self._eval_batches():
            batch = self._place_batch(arrays)
            ls, ct, logits = self.model.eval_step(self.state, batch)
            if exact:
                # logits rank like sigmoid scores: the host ranks them
                score_rows.append((logits, batch.y, batch.sample_w))
                part = (ls, ct)
            else:
                pos, neg = StreamingAUC.bucket_counts(
                    logits, batch.y, batch.sample_w, AUC_BINS
                )
                part = (ls, ct, pos, neg)
            if tot is None:
                tot = (part, tuple(torch.zeros_like(p) for p in part))
            else:
                tot = kahan_add(tot[0], tot[1], part)
        if tot is None:
            return float("nan"), float("nan")
        sums = [t.cpu().numpy() for t in tot[0]]
        acc.update(sums[0], sums[1])
        if exact:
            lg, yy, ww = (
                torch.cat([r[i] for r in score_rows]).cpu().numpy() for i in range(3)
            )
            m = ww > 0  # drop padding rows
            return acc.mean, exact_auc(lg[m], yy[m] > 0)
        auc.update(sums[2], sums[3])
        return acc.mean, auc.result()

    def predict_file(self, data_path: str, out_path: str) -> int:
        """Score a libsvm/libffm file: one sigmoid probability per line,
        "%.6f" (ftrl_ffm_tpu/train.py::predict_file).  data_path "-" scores
        stdin and out_path "-" writes to stdout.  Returns the number of
        samples scored."""
        cfg = self.cfg
        if data_path == "-" and not cfg.file_type:
            raise ValueError(
                "--predict_data -: stdin cannot be sniffed; set --file_type"
            )
        reader = StreamReader(
            sys.stdin if data_path == "-" else data_path,
            cfg.file_type or detect_file_type(data_path),
            cfg.batch_size,
            cfg.max_nnz,
            cfg.n_feats,
            cfg.n_fields,
            n_parse_threads=cfg.n_threads,
            # no progress prints: they would interleave with the probability
            # stream when out_path is stdout
            log_every=0,
        )
        total = 0
        out_cm = (
            contextlib.nullcontext(sys.stdout)
            if out_path == "-"
            else open(out_path, "w")
        )
        with out_cm as f:
            for arrays in reader.batches():
                batch = self._place_batch(arrays)
                _, _, logits = self.model.eval_step(self.state, batch)
                probs = torch.sigmoid(logits).cpu().numpy().astype(np.float64)
                mask = arrays[4] > 0  # drop padded tail samples
                f.write("".join(f"{p:.6f}\n" for p in probs[mask]))
                total += int(mask.sum())
        return total
