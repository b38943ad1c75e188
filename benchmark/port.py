"""The system under test: ftrl_ffm_tpu_torch's Trainer, as a cell runs it.

The only module of the benchmark that imports the program.  It builds the
Config a cell states (its configuration and its traffic's protocol),
hands the Trainer the benchmark's S0 in the program's table layout,
builds the resident datasets where the traffic asks for them, and
watches the first steps of the first train_epoch() for the check
(`FirstSteps`) without changing what they compute.
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, models
from benchmark import state as s0


def program_config(config: dict, protocol: dict, train_path: str, eval_path: str, seed: int,
                   device: torch.device, variant: dict | None = None):
    """The port's Config of a cell: the configuration's model, sizes and
    FTRL settings, then the traffic's protocol (online or offline, the
    resident dataset, the eval metric, feeder workers, saves: Config
    fields as they stand), then `variant` (the lower-precision control)."""
    from ftrl_ffm_tpu_torch.config import Config

    p = config["ftrl"]
    kw = dict(
        train_data=train_path, eval_data=eval_path, file_type="libffm",
        model_type=config["model_type"], n_fields=config["n_fields"],
        n_feats=config["n_feats"], n_factors=config["n_factors"],
        batch_size=config["batch_size"], max_nnz=config["n_fields"],
        steps_per_call=config["steps_per_call"], n_threads=config["n_threads"],
        update_mode=config["update_mode"], table_dtype=config["table_dtype"],
        acc_dtype=config["acc_dtype"], init_mean=config["init_mean"],
        init_stddev=config["init_stddev"], w_alpha=p["alpha"], w_beta=p["beta"],
        w_l1=p["l1"], w_l2=p["l2"], factor_semantics="keep_init",
        n_epochs=config["n_epochs"], seed=int(seed), device=str(device),
    )
    kw.update(protocol)
    kw.update(variant or {})
    return Config(**kw)


def program_state(config: dict, cfg, seed: int, device: torch.device):
    """S0 in the program's layout (a ModelState): FFM rows factor-major
    over cfg.field_pad fields, slot (k, c) = k * field_pad + c, the
    fields past n_fields zero (lane (0, n_fields) mirrors the linear
    table, which starts at 0); FM rows [k]; w in cfg.table_dtype."""
    from ftrl_ffm_tpu_torch.models.base import ModelState

    r, e = config["n_feats"], cfg.row_width
    w_dtype = getattr(torch, cfg.table_dtype)
    vec_w = torch.zeros((r, e), dtype=w_dtype, device=device)
    for b, lo, hi in s0.blocks(config):
        w0 = s0.w0_block(config, seed, b, lo, hi, device)
        _logical(vec_w[lo:hi], config, cfg).copy_(w0)
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=device)  # noqa: E731
    return ModelState(
        bias_n=zeros(), bias_z=zeros(), lin_n=zeros(r), lin_z=zeros(r), lin_w=zeros(r),
        vec_n=zeros(r, e), vec_z=zeros(r, e), vec_w=vec_w,
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _logical(rows: torch.Tensor, config: dict, cfg) -> torch.Tensor:
    """A view of the program's factor rows in the logical layout
    (benchmark/models/<model_type>.py)."""
    return models.of(config).logical_view(rows, config, cfg.field_pad)


class ProgramTables:
    """compare.Tables over the program's live state."""

    def __init__(self, trainer, config: dict):
        self.t, self.config = trainer, config

    def vec_blocks(self):
        st, cfg = self.t.state, self.t.cfg
        for b, lo, hi in s0.blocks(self.config):
            yield (b, lo, hi, *(_logical(t[lo:hi], self.config, cfg)
                                for t in (st.vec_n, st.vec_z, st.vec_w)))

    def lin(self):
        # the program's own linear tables ("dense2" updates them with the
        # factor rows; a stale in-place form would show here)
        st = self.t.state
        return st.lin_n, st.lin_z, st.lin_w

    def bias(self):
        return self.t.state.bias_n, self.t.state.bias_z


def build(config: dict, traffic: dict, train_path: str, eval_path: str, seed: int,
          device: torch.device, variant: dict | None = None):
    """(trainer, seconds of the resident datasets' build, or None): the
    Trainer from S0.  Where the traffic says "resident", both datasets
    are parsed and uploaded here, and the run raises if one does not
    become resident."""
    from ftrl_ffm_tpu_torch.train import Trainer

    cfg = program_config(config, traffic["protocol"], train_path, eval_path, seed, device,
                         variant)
    trainer = Trainer(cfg, state=program_state(config, cfg, seed, device))
    synchronize(device)
    if not traffic.get("resident"):
        return trainer, None
    t0 = time.perf_counter()
    for role in ("train", "eval"):
        if trainer._fresh_cache(role) is None:
            raise RuntimeError(f"the {role} dataset did not become resident")
    synchronize(device)
    return trainer, time.perf_counter() - t0


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def launch_counter():
    """(reset, read): the program's launch counters of its hand-written
    kernels (a graph replay adds its capture's), reset and the total
    read."""
    from ftrl_ffm_tpu_torch.tools import read_launch_counts, reset_launch_counts

    def read() -> int:
        return sum(v for v in read_launch_counts().values() if isinstance(v, int))

    return reset_launch_counts, read


class FirstSteps:
    """Watches the first evaluate() and train_epoch() of a Trainer for the
    check, then takes itself off.

    start_eval() runs evaluate() on S0, keeping the logits that the eager
    eval steps return.  After the first step it reads the gradient norms
    from the state (compare.grad_norms); after compare.check_steps(config)
    steps it reads the change norms and runs one more evaluate() (its loss
    and AUC are compared).  At one step a call it counts
    Trainer._train_one's calls; at S > 1 the train groups of
    Trainer._run_group (the first runs eagerly, its steps through
    _train_one, the next replays a graph).  Calls made while a graph is
    being captured are passed through untouched.  The per-step (loss sum,
    count) pairs are the program's own outputs.  `check_s` is the time the
    norms took: work of the check, not of set-up."""

    def __init__(self, trainer, config: dict, seed: int):
        self.t, self.config, self.seed = trainer, config, seed
        self.k = compare.check_steps(config)
        self.s = config["steps_per_call"]
        self.steps = self.eager = 0
        self.sums: list = []
        self.logits: list = []
        self.grad = self.change = self.eval = self.eval0 = None
        self.check_s = 0.0
        self.recording = False
        self._train_one = trainer._train_one
        self._run_group = trainer._run_group
        self._eval_step = trainer.model.eval_step
        trainer._train_one = self.train_one
        trainer.model.eval_step = self.eval_step
        if self.s > 1:
            trainer._run_group = self.run_group

    @property
    def done(self) -> bool:
        return self.eval is not None

    def train_one(self, batch):
        out = self._train_one(batch)
        if _capturing() or self.done:
            return out
        self.eager += 1
        if self.eager == 1:
            t0 = time.perf_counter()
            self.grad = compare.grad_norms(ProgramTables(self.t, self.config), self.config,
                                           self.seed)
            self.check_s += time.perf_counter() - t0
        if self.s == 1:
            self.sums.append(out.detach().clone())
            self.steps += 1
            if self.steps == self.k:
                self._checkpoint()
        return out

    def run_group(self, role, fn, inputs, key=()):
        out = self._run_group(role, fn, inputs, key)
        if role == "train" and not self.done:
            self.sums.extend(out[0].detach().clone())
            self.steps += out[0].shape[0]
            if self.steps >= self.k:
                self._checkpoint()
        return out

    def eval_step(self, state, batch):
        out = self._eval_step(state, batch)
        if self.recording and not _capturing():
            self.logits.append(out[2].detach().float().cpu())
        return out

    def start_eval(self) -> None:
        """evaluate() on S0, its eager steps' logits kept."""
        self.recording = True
        self.eval0 = self.t.evaluate()
        self.recording = False

    def _checkpoint(self) -> None:
        t0 = time.perf_counter()
        self.change = compare.change_norms(ProgramTables(self.t, self.config), self.config,
                                           self.seed)
        self.check_s += time.perf_counter() - t0
        self.eval = self.t.evaluate()
        del self.t._train_one
        del self.t.model.eval_step
        if self.s > 1:
            del self.t._run_group

    def readings(self) -> dict:
        """The program's side for compare.readings."""
        sums = torch.stack([s.double() for s in self.sums[:self.k]]).cpu().numpy()
        n_eval = self.config["eval_rows"]
        logits = torch.cat(self.logits).numpy()[:n_eval] if self.logits else []
        return {"losses": list(sums[:, 0] / sums[:, 1]), "grad": self.grad,
                "change": self.change, "eval_loss": self.eval[0], "auc": self.eval[1],
                "logits": logits}
