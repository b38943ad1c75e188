"""Command-line interface: the port of ftrl_ffm_tpu/cli.py.

The same flags as the JAX CLI (reference: src/main.cpp:13-34,
src/include/utils/cmd_option.h:7-27) plus `--device`.  The port trains and
serves LR, FM and FFM (`--model_type`): `--train_data` (or `--cmd true`
for stdin) trains, evaluating after each epoch when `--eval_data` is set,
from a fresh init or from `--load_model`; `--predict_data` scores a file
after training; without training data, `--load_model` (or a reference
import) with `--eval_data` and/or `--predict_data` serves.  `--model_path`
saves a full checkpoint at the end (and every `--save_every` steps),
`--auto_resume` resumes from it, `--import_reference_model` /
`--import_reference_text_model` warm-start from reference weights and the
two export flags write them.  The per-epoch lines, the eval line, the
prediction file and the files written are the JAX CLI's.  Flags of
capabilities a later slice brings raise NotImplementedError naming it.

On a mesh (`--mesh_data`/`--mesh_model`) one process drives one device:
start one process a device, each with `--coordinator_address host:port
--num_processes N --process_id i` (the JAX CLI's three flags; NCCL on the
card, gloo with `--device cpu`).  Every process trains; the coordinator
(process 0) alone prints the epoch lines and writes the checkpoint, the
predictions and the exports.

Usage:
    python -m ftrl_ffm_tpu_torch --train_data train.ffm --eval_data eval.ffm \
        --model_type FFM --n_fields 39 --n_feats 100000 --n_epochs 2 ...
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import time

from ftrl_ffm_tpu_torch.config import Config


def _str2bool(v: str) -> bool:
    # the reference accepts "true"/"false" words (README.md:63-66)
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "on"):
        return True
    if v.lower() in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ftrl_ffm_tpu_torch",
        description=(
            "FTRL-Proximal LR / FM / FFM on libsvm / libffm data: the "
            "PyTorch/CUDA port of ftrl_ffm_tpu (trains and serves all three "
            "models on one device or a mesh of them)."
        ),
    )
    # ---- reference flags (src/include/utils/cmd_option.h:49-63 defaults) ----
    p.add_argument("--model_path", default="", help="checkpoint / model output path")
    p.add_argument("--train_data", default="", help="training data path")
    p.add_argument("--eval_data", default="", help="evaluation data path")
    p.add_argument("--model_type", default="FFM", help="LR | FM | FFM")
    p.add_argument("--init_mean", type=float, default=0.0, help="factor init mean")
    p.add_argument("--init_stddev", type=float, default=0.02, help="factor init stddev")
    p.add_argument("--w_alpha", type=float, default=1e-4, help="FTRL alpha")
    p.add_argument("--w_beta", type=float, default=1.0, help="FTRL beta")
    p.add_argument("--w_l1", type=float, default=0.1, help="L1 regularization")
    p.add_argument("--w_l2", type=float, default=5.0, help="L2 regularization")
    p.add_argument("--n_threads", type=int, default=1, help="host parse workers")
    p.add_argument("--n_epochs", type=int, default=1, help="number of epochs")
    p.add_argument("--n_fields", type=int, default=8, help="number of fields")
    p.add_argument("--n_feats", type=int, default=10000, help="feature table rows")
    p.add_argument("--n_factors", type=int, default=16, help="latent factors")
    p.add_argument("--online", type=_str2bool, default=True,
                   help="true: streaming single-pass; false: in-memory shuffled")
    p.add_argument("--cmd", type=_str2bool, default=False,
                   help="read training stream from stdin")
    p.add_argument("--file_type", default="", help="libsvm | libffm (auto-detect)")
    # ---- TPU-native extras ----
    p.add_argument("--batch_size", type=int, default=4096, help="global batch size")
    p.add_argument("--max_nnz", type=int, default=0,
                   help="pad/truncate nnz per sample (0 = sniff from data)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--factor_semantics", default="keep_init",
                   help="keep_init | reference (see Config)")
    p.add_argument("--update_mode", default="auto",
                   choices=("auto", "dense", "sparse", "inplace"),
                   help="FTRL table update strategy (see Config.update_mode)")
    p.add_argument("--table_dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="storage dtype for the factor weight table vec_w")
    p.add_argument("--acc_dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="gradient payload/accumulator dtype on the fused "
                        "path (bfloat16 halves the dominant scatter bytes)")
    p.add_argument("--use_pallas", default="auto",
                   choices=("auto", "on", "off"),
                   help="fused TPU kernel for the FFM step (auto = TPU only)")
    p.add_argument("--compact_transfer", type=_str2bool, default=True,
                   help="narrow host->device upload dtypes (lossless only)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="train/eval steps per dispatch (>1: one CUDA-graph "
                        "replay per S steps on the card; the same result)")
    p.add_argument("--lookup_mode", default="auto",
                   choices=("auto", "replicate", "route"),
                   help="sharded-table lookup strategy (see Config.lookup_mode)")
    p.add_argument("--route_capacity", type=float, default=2.0,
                   help="route-mode per-peer capacity multiple of the "
                        "balanced share (unique-id routed: skew-immune)")
    p.add_argument("--route_overflow_policy", default="warn",
                   choices=("warn", "error"),
                   help="on routed-bucket overflow: warn + count, or raise "
                        "at epoch end (exactness guarantee)")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel mesh axis size (0 = all remaining devices)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="table-sharding mesh axis size")
    p.add_argument("--eval_auc", type=_str2bool, default=True)
    p.add_argument("--auc_mode", default="binned", choices=("binned", "exact"),
                   help="AUC estimator: streaming histogram (O(1) memory, "
                        "error O(1/8192) for spread scores) or exact rank "
                        "statistic (all eval scores must fit host memory)")
    p.add_argument("--shuffle", type=_str2bool, default=True)
    p.add_argument("--device_cache", default="auto",
                   choices=("auto", "on", "off"),
                   help="keep the train and eval datasets resident in device "
                        "memory (one parse, one upload) and run their passes "
                        "from there: offline epochs shuffle, online training "
                        "replays the file order, eval reads the file order; "
                        "auto = where a dataset fits next to the model state "
                        "and, for online training, with n_epochs > 1; --cmd "
                        "stdin training always streams")
    p.add_argument("--device_cache_layout", default="auto",
                   choices=("auto", "replicate", "shard"),
                   help="cached-dataset layout on a device mesh: shard = each "
                        "process its byte-range slice; replicate = the whole "
                        "dataset, on one process only (more stream); auto = "
                        "shard on more than one process; on one process "
                        "every value holds the whole dataset")
    p.add_argument("--device_cache_compact", default="auto",
                   choices=("auto", "on", "off"),
                   help="store the cached dataset compactly in device memory "
                        "(split ids + DEC6 vals + packed fields, decoded "
                        "after each gather; ~2x capacity; auto = only when "
                        "the raw form would not fit)")
    p.add_argument("--feed_workers", type=int, default=1,
                   help="device-feed threads; >1 interleaves whole batches "
                        "(pinned copy + upload) across threads with a reorder "
                        "buffer — update order unchanged (--cmd pins 1)")
    p.add_argument("--compress_level", type=int, default=3, help="zstd level")
    p.add_argument("--save_every", type=int, default=0,
                   help="mid-training checkpoint every N steps (0 = end only)")
    p.add_argument("--async_checkpoint", type=_str2bool, default=True,
                   help="overlap --save_every checkpoint compression/write "
                        "with training on a background thread (snapshot is "
                        "taken inline; writes are crash-atomic either way)")
    p.add_argument("--load_model", default="",
                   help="resume from a full checkpoint (model_path saves one)")
    p.add_argument("--auto_resume", type=_str2bool, default=False,
                   help="if --model_path already holds a checkpoint, resume "
                        "from it (crash -> relaunch the same command picks "
                        "up at the last --save_every checkpoint)")
    p.add_argument("--import_reference_model", default="",
                   help="warm-start from a reference-format zstd weight blob "
                        "(e.g. a model trained by the C++ binary)")
    p.add_argument("--export_reference_model", default="",
                   help="also export weights as a reference-compatible zstd blob")
    p.add_argument("--import_reference_text_model", default="",
                   help="warm-start from the reference's plain-text model "
                        "format (FM/FFM factor rows; src/model/ffm.cpp:179)")
    p.add_argument("--export_reference_text_model", default="",
                   help="also export weights in the reference's plain-text "
                        "model format (src/model/ffm.cpp:161)")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of epoch 1 here "
                        "(TensorBoard format: *.pt.trace.json)")
    p.add_argument("--predict_data", default="",
                   help="after training, score this file ('-': stdin stream; "
                        "requires --file_type and --max_nnz)")
    p.add_argument("--predict_output", default="predictions.txt",
                   help="output path for --predict_data probabilities "
                        "('-': stdout)")
    # ---- multi-host (SPMD over DCN; one process per host) ----
    p.add_argument("--coordinator_address", default="",
                   help="torch.distributed rendezvous host:port (one process "
                        "a device; process 0's address)")
    p.add_argument("--num_processes", type=int, default=0,
                   help="total process count of the run")
    p.add_argument("--process_id", type=int, default=-1,
                   help="this process's rank, 0 .. num_processes - 1")
    # ---- the port's own ----
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (CUDA kernels) or cpu (their "
                        "plain PyTorch versions)")
    return p


# flags that are not Config fields
_NON_CONFIG_FLAGS = (
    "load_model",
    "auto_resume",
    "import_reference_model",
    "export_reference_model",
    "import_reference_text_model",
    "export_reference_text_model",
    "profile_dir",
    "predict_data",
    "predict_output",
    "coordinator_address",
    "num_processes",
    "process_id",
)


def _refuse_unported(args) -> None:
    """Raise for flags the port cannot serve as given.  The multi-process
    flags come as a set of three: torch.distributed has no cluster to ask
    for a missing count or rank (the JAX CLI lets jax.distributed find
    them).  What the port does not serve raises in config.py::
    check_ported."""
    given = (bool(args.coordinator_address), args.num_processes > 0, args.process_id >= 0)
    if any(given) and not all(given):
        raise ValueError(
            "multi-process runs need all of --coordinator_address, "
            "--num_processes and --process_id"
        )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    from ftrl_ffm_tpu_torch.parallel import dist

    if args.coordinator_address:
        # one process a device, over the rendezvous at the coordinator
        dist.initialize(args.coordinator_address, args.num_processes, args.process_id,
                        args.device)
    try:
        return _main(args)
    finally:
        # the run's group (the one joined here, or a mesh's group of one)
        dist.destroy()


def _main(args) -> int:
    cfg = Config(
        **{k: v for k, v in vars(args).items() if k not in _NON_CONFIG_FLAGS}
    )
    if args.import_reference_model and args.import_reference_text_model:
        print(
            "error: --import_reference_model and "
            "--import_reference_text_model are mutually exclusive",
            file=sys.stderr,
        )
        return 2
    any_import = args.import_reference_model or args.import_reference_text_model
    training = bool(cfg.train_data or cfg.cmd)
    serve_only = (
        bool(args.load_model or any_import)
        and bool(args.predict_data or cfg.eval_data)
        and not training
    )
    if not training and not serve_only:
        print(
            "error: --train_data is required (or --cmd true for stdin, or "
            "--load_model with --predict_data/--eval_data for serving/eval)",
            file=sys.stderr,
        )
        return 2
    if args.predict_data == "-" and (not cfg.file_type or not cfg.max_nnz):
        # stdin cannot be sniffed or re-read: both must be explicit
        print(
            "error: --predict_data - (stdin) requires --file_type and "
            "--max_nnz",
            file=sys.stderr,
        )
        return 2
    if args.predict_data == "-" and cfg.cmd:
        # --cmd training already consumes stdin to EOF
        print(
            "error: --predict_data - cannot be combined with --cmd "
            "(both read stdin)",
            file=sys.stderr,
        )
        return 2
    # the text format has factor rows: refuse before training, not after
    # hours of it (and before skipping the sibling binary export)
    if args.export_reference_text_model and cfg.ref_row_width == 0:
        print(
            "error: --export_reference_text_model needs a factor model "
            "(FM/FFM) — the text format has factor rows",
            file=sys.stderr,
        )
        return 2
    if args.import_reference_text_model and cfg.ref_row_width == 0:
        print(
            "error: --import_reference_text_model needs a factor model "
            "(FM/FFM) — the text format has factor rows "
            "(reference src/model/ffm.cpp:179-200)",
            file=sys.stderr,
        )
        return 2
    # With predictions streaming to stdout, every informational line must
    # go to stderr or it corrupts the one-probability-per-line contract.
    preds_on_stdout = bool(args.predict_data) and args.predict_output == "-"
    info = functools.partial(print, file=sys.stderr) if preds_on_stdout else print
    if args.process_id > 0:
        info = lambda *a, **k: None  # noqa: E731  (the coordinator reports)
    trainer_out = (
        contextlib.redirect_stdout(sys.stderr)
        if preds_on_stdout
        else contextlib.nullcontext()
    )

    from ftrl_ffm_tpu_torch.io import checkpoint as ckpt
    from ftrl_ffm_tpu_torch.train import Trainer

    state = None
    load_from = args.load_model
    if not load_from and args.auto_resume and cfg.model_path and os.path.exists(cfg.model_path):
        load_from = cfg.model_path
    if load_from:
        host_state, extra = ckpt.load_checkpoint(load_from)
        # fail loud on a config mismatch (n_feats/n_fields/n_factors/
        # table_dtype/field_pad...) before shapes can silently reinterpret
        ckpt.validate_header_compat(cfg, extra, load_from)
        info(f"resumed from {load_from} (step {int(host_state.step)})")
        # on the host: the Trainer moves it to the device, or shards it
        state = ckpt.state_from_jax_arrays(host_state, "cpu")

    t0 = time.perf_counter()
    if not cfg.max_nnz and serve_only and args.predict_data and not cfg.eval_data:
        from ftrl_ffm_tpu_torch.config import detect_file_type
        from ftrl_ffm_tpu_torch.data.parser import sniff_max_nnz

        cfg.file_type = cfg.file_type or detect_file_type(args.predict_data)
        cfg.max_nnz = sniff_max_nnz(args.predict_data, cfg.file_type)
    trainer = Trainer(cfg, state=state)
    # reference weights replace the state: w as given, n 0, z inverted
    # (Model.init_from_weights); blobs hold the logical row width (C*K)
    if any_import:
        src = args.import_reference_model or args.import_reference_text_model
        read = (ckpt.import_reference_model if args.import_reference_model
                else ckpt.import_reference_text_model)
        weights = read(src, cfg.n_feats, cfg.ref_row_width)
        trainer.load_state(trainer.model.init_from_weights(*weights, device=trainer.device))
        info(f"imported reference model from {src}")
    with trainer_out:
        if training:
            trainer.train(profile_dir=args.profile_dir or None)
        elif cfg.eval_data:
            eval_loss, eval_auc = trainer.evaluate()
            if args.process_id > 0:
                pass
            elif cfg.eval_auc:
                print(f"eval loss: {eval_loss:.4f}, eval auc: {eval_auc:.4f}")
            else:
                print(f"eval loss: {eval_loss:.4f}")
    info(f"total time: {time.perf_counter() - t0:.4f}s")
    # checkpoint BEFORE prediction and export: a failure in those optional
    # steps must never discard the trained state
    if cfg.model_path:
        trainer.save_checkpoint(cfg.model_path, extra={"config": dict(vars(args))})
        info(f"checkpoint saved to {cfg.model_path}")
    if args.predict_data:
        n = trainer.predict_file(args.predict_data, args.predict_output)
        info(f"wrote {n} predictions to {args.predict_output}")
    if args.export_reference_model or args.export_reference_text_model:
        # logical_state gathers on every process; the coordinator writes
        state = trainer.logical_state
        if args.process_id > 0:
            return 0
        bias, lin_w, vec_w = trainer.model.materialize_weights(state)
        if args.export_reference_model:
            ckpt.export_reference_model(
                args.export_reference_model, float(bias), lin_w, vec_w,
                level=cfg.compress_level,
            )
            info(f"reference-format model saved to {args.export_reference_model}")
        if args.export_reference_text_model:
            ckpt.export_reference_text_model(
                args.export_reference_text_model, float(bias), lin_w, vec_w
            )
            info(
                f"reference text-format model saved to "
                f"{args.export_reference_text_model}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
