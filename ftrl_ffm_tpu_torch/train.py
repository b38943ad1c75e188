"""Serving orchestration on one device: streamed eval and batch scoring
(the serving subset of ftrl_ffm_tpu/train.py).

`Trainer.evaluate` and `Trainer.predict_file` behave as the JAX package's:
the same stream of fixed-shape batches, the same masked log-loss with a
compensated (Kahan) f32 chain on the device, the same binned or exact AUC,
the same one-probability-per-line output.  Batches cross to the card through
pinned host memory with non-blocking copies.  Training, the background
feeder and the device-resident dataset arrive with later slices
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import contextlib
import sys
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
            if state.vec_w.dtype != torch.float32:
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


class Trainer:
    def __init__(self, cfg: Config, state: Optional[ModelState] = None):
        check_ported(cfg)
        self.device = resolve_device(cfg.device)
        # eval-/predict-only Trainers sniff format and nnz from eval_data
        sniff_src = cfg.train_data or cfg.eval_data
        if not cfg.file_type and sniff_src:
            cfg.file_type = detect_file_type(sniff_src)
        cfg.validate_file_type()
        if cfg.max_nnz <= 0 and sniff_src:
            cfg.max_nnz = sniff_max_nnz(sniff_src, cfg.file_type)
        if cfg.max_nnz <= 0:
            raise ValueError(
                "max_nnz unknown: pass --max_nnz or provide eval data to "
                "sniff it from"
            )
        self.cfg = cfg
        self.model = make_model(cfg)
        if state is None:
            raise ValueError(
                "the PyTorch port serves a trained state: pass one (load it "
                "with io/checkpoint.py::load_checkpoint); fresh model init "
                "arrives with training, ROADMAP.md Queue 1 item 2"
            )
        _validate_state_shapes(cfg, state)
        self.state = ModelState(
            *(None if t is None else t.to(self.device) for t in state)
        )

    # ---- batch plumbing ----
    def _place_batch(self, arrays) -> Batch:
        """Upload one host batch (fields, feats, vals, y, sample_w).  On the
        card through pinned host memory with non-blocking copies, so the
        upload overlaps the kernels still queued from the previous batch."""
        ts = [torch.from_numpy(a) for a in arrays]
        if self.device.type == "cuda":
            ts = [t.pin_memory().to(self.device, non_blocking=True) for t in ts]
        return Batch(*ts)

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
        if not hasattr(self, "_eval_ds"):
            self._eval_ds = load_file(
                cfg.eval_data,
                cfg.file_type,
                cfg.max_nnz,
                cfg.n_feats,
                cfg.n_fields,
                n_workers=cfg.n_threads,
            )
        return batch_iterator(
            self._eval_ds, cfg.batch_size, shuffle=False, sentinel=cfg.n_feats
        )

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

    def train(self, profile_dir: Optional[str] = None) -> dict:
        raise not_ported("Trainer.train", 2)
