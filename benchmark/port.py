"""The system under test: ftrl_ffm_tpu_torch's Trainer, as a cell runs it.

The only module of the benchmark that imports the program.  It builds the
Config a cell states (its configuration and its traffic's protocol),
hands the Trainer the benchmark's S0 in the program's table layout,
builds the resident datasets where the traffic asks for them, and
watches the first steps of the first train_epoch() for the check
(`FirstSteps`) without changing what they compute.

On a mesh (a cell on more than one card, one process a rank: benchmark/
ranks.py) each rank joins the program's process group (`join`) and
builds only its own rows of S0: the Trainer is handed a state whose
tables are one row seen n_feats times (`_unfilled_state`), of which its
placement (parallel/mesh.py::shard_state) copies the rank's rows alone,
and the rank then writes S0 into them a block at a time (`fill_s0`): no
process holds the whole table.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, models
from benchmark import state as s0

# the configuration's mesh, passed to the Config where the file states it
MESH_KEYS = ("mesh_data", "mesh_model", "lookup_mode", "route_capacity")


def program_config(config: dict, protocol: dict, train_path: str, eval_path: str, seed: int,
                   device: torch.device, variant: dict | None = None):
    """The port's Config of a cell: the configuration's model, sizes, FTRL
    settings and, where it states them, its mesh (MESH_KEYS), then the
    traffic's protocol (online or offline, the resident dataset and its
    layout, the eval metric, feeder workers, saves: Config fields as they
    stand), then `variant` (the lower-precision control)."""
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
    kw.update({k: config[k] for k in MESH_KEYS if k in config})
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
    fill_s0(vec_w, config, cfg, seed)
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=device)  # noqa: E731
    return ModelState(
        bias_n=zeros(), bias_z=zeros(), lin_n=zeros(r), lin_z=zeros(r), lin_w=zeros(r),
        vec_n=zeros(r, e), vec_z=zeros(r, e), vec_w=vec_w,
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def fill_s0(vec_w: torch.Tensor, config: dict, cfg, seed: int, shards: int = 1,
            index: int = 0) -> None:
    """Write S0's factor weights into a rank's factor weight table
    (program_state's layout): the ids i with i % shards == index, at
    local row i // shards (the program's interleaved placement; one rank
    holds every row), one block of S0 at a time."""
    for b, lo, hi, first, l0, l1 in s0.rank_blocks(config, shards, index):
        w0 = s0.w0_block(config, seed, b, lo, hi, vec_w.device)
        _logical(vec_w[l0:l1], config, cfg).copy_(w0[first - lo::shards])


def _unfilled_state(cfg, device: torch.device):
    """A state of the Config's shapes whose tables are one zero row seen
    n_feats times (expand): a placement copies only the rows it takes."""
    from ftrl_ffm_tpu_torch.models.base import ModelState

    r, e = cfg.n_feats, cfg.row_width

    def rows(*shape, dtype=torch.float32):
        return torch.zeros((1, *shape[1:]), dtype=dtype, device=device).expand(shape)

    zero = lambda dtype=torch.float32: torch.zeros((), dtype=dtype, device=device)  # noqa: E731
    return ModelState(
        bias_n=zero(), bias_z=zero(), lin_n=rows(r), lin_z=rows(r), lin_w=rows(r),
        vec_n=rows(r, e), vec_z=rows(r, e), vec_w=rows(r, e, dtype=getattr(torch, cfg.table_dtype)),
        step=zero(torch.int32),
    )


def _logical(rows: torch.Tensor, config: dict, cfg) -> torch.Tensor:
    """A view of the program's factor rows in the logical layout
    (benchmark/models/<model_type>.py)."""
    return models.of(config).logical_view(rows, config, cfg.field_pad)


class ProgramTables:
    """compare.Tables over the program's live state: on a mesh the rank's
    share of the tables, with S0's weights of the same ids."""

    def __init__(self, trainer, config: dict, seed: int):
        self.t, self.config, self.seed = trainer, config, seed
        mesh = trainer._mesh
        self.shards, self.index = (mesh.model, mesh.model_index) if mesh is not None else (1, 0)

    def vec_blocks(self):
        st, cfg, m = self.t.state, self.t.cfg, self.shards
        for b, lo, hi, first, l0, l1 in s0.rank_blocks(self.config, m, self.index):
            w0 = s0.w0_block(self.config, self.seed, b, lo, hi, st.vec_w.device)
            yield (*(_logical(t[l0:l1], self.config, cfg) for t in (st.vec_n, st.vec_z, st.vec_w)),
                   w0[first - lo::m])

    def lin(self):
        # the program's own linear tables ("dense2" updates them with the
        # factor rows; a stale in-place form would show here); a rank's
        # rows past n_feats are zero
        st = self.t.state
        return st.lin_n, st.lin_z, st.lin_w

    def bias(self):
        return self.t.state.bias_n, self.t.state.bias_z


def build(config: dict, traffic: dict, train_path: str, eval_path: str, seed: int,
          device: torch.device, variant: dict | None = None, mesh: bool = False):
    """(trainer, seconds of the resident datasets' build, or None): the
    Trainer from S0, on a mesh (a process group joined) from this rank's
    rows of it.  Where the traffic says "resident", both datasets are
    parsed and uploaded here, and the run raises if one does not become
    resident."""
    from ftrl_ffm_tpu_torch.train import Trainer

    cfg = program_config(config, traffic["protocol"], train_path, eval_path, seed, device,
                         variant)
    if not mesh:
        trainer = Trainer(cfg, state=program_state(config, cfg, seed, device))
    else:
        m = max(1, cfg.mesh_model)
        if cfg.n_feats % m:
            # the Trainer pads such a table whole before it places it
            raise ValueError(f"a mesh cell needs n_feats divisible by mesh_model {m}, "
                             f"got {cfg.n_feats}")
        trainer = Trainer(cfg, state=_unfilled_state(cfg, device))
        fill_s0(trainer.state.vec_w, config, cfg, seed, trainer._mesh.model,
                trainer._mesh.model_index)
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


def join(coordinator: str, world: int, rank: int, device: torch.device) -> None:
    """Join the program's process group as `rank` of `world` (NCCL on the
    card, gloo on the CPU; parallel/dist.py::initialize)."""
    from ftrl_ffm_tpu_torch.parallel import dist

    dist.initialize(coordinator, world, rank, device.type)


def leave() -> None:
    """Leave the program's process group once every rank is there."""
    from ftrl_ffm_tpu_torch.parallel import dist

    dist.destroy()


def counters():
    """(reset, read): the program's counters (its tracing registry)."""
    from ftrl_ffm_tpu_torch import tracing

    return tracing.reset, tracing.read


def launch_counter():
    """(reset, read): the program's launch counters of its hand-written
    kernels (a graph replay adds its capture's), reset and the total
    read."""
    from ftrl_ffm_tpu_torch.tools import read_launch_counts, reset_launch_counts

    def read() -> int:
        return sum(v for v in read_launch_counts().values() if isinstance(v, int))

    return reset_launch_counts, read


def own_squares(squares: dict, rank: int, data_index: int) -> dict:
    """A rank's part of a mesh's sums of squares by leaf: its tables' where
    it sits on data index 0 (the ranks on the others hold replicas of
    them), the bias's on rank 0 alone (every rank holds it)."""
    return {k: v if (rank == 0 if k.startswith("bias") else data_index == 0) else 0.0
            for k, v in squares.items()}


class FirstSteps:
    """Watches the first evaluate() and train_epoch() of a Trainer for the
    check, then takes itself off.

    start_eval() runs evaluate() on S0, keeping the logits that the eager
    eval steps return (the model's eval_step, on a mesh the sharded
    step's: a rank's slice of each batch).  After the first step it reads
    the gradient norms from the state (compare.grad_squares); after
    compare.check_steps(config) steps it reads the change norms and runs
    one more evaluate() (its loss and AUC are compared).  At one step a
    call it counts Trainer._train_one's calls; at S > 1 the train groups
    of Trainer._run_group (the first runs eagerly, its steps through
    _train_one, the next replays a graph).  Calls made while a graph is
    being captured are passed through untouched.  The per-step (loss sum,
    count[, route drops]) rows are the program's own outputs, global on a
    mesh.  On a mesh (`group`, benchmark/ranks.py) each rank's sums of
    squares are summed over the ranks before the square root: the tables
    of the ranks on data index 0 (the others hold replicas of them) and
    rank 0's bias.  `check_s` is the time the norms took: work of the
    check, not of set-up."""

    def __init__(self, trainer, config: dict, seed: int, group=None):
        self.t, self.config, self.seed, self.group = trainer, config, seed, group
        self.k = compare.check_steps(config)
        self.s = config["steps_per_call"]
        self.steps = self.eager = 0
        self.sums: list = []
        self.logits: list = []
        self.real: list = []
        self.grad = self.change = self.eval = self.eval0 = None
        self.check_s = 0.0
        self.recording = False
        self._train_one = trainer._train_one
        self._run_group = trainer._run_group
        self._evaluator = trainer.model if trainer._sharded is None else trainer._sharded
        self._eval_step = self._evaluator.eval_step
        trainer._train_one = self.train_one
        self._evaluator.eval_step = self.eval_step
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
            self.grad = self._norms(compare.grad_squares(self._tables(), self.config))
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

    def eval_step(self, state, batch, *rest):
        out = self._eval_step(state, batch, *rest)
        if self.recording and not _capturing():
            self.logits.append(out[2].detach().float().cpu())
            self.real.append(batch.sample_w.detach().cpu() > 0)
        return out

    def start_eval(self) -> None:
        """evaluate() on S0, its eager steps' logits kept."""
        self.recording = True
        self.eval0 = self.t.evaluate()
        self.recording = False

    def _tables(self) -> ProgramTables:
        return ProgramTables(self.t, self.config, self.seed)

    def _norms(self, squares: dict) -> dict:
        if self.group is not None:
            squares = self.group.sum(own_squares(squares, self.group.rank,
                                                 self.t._mesh.data_index))
        return compare.norms(squares)

    def _checkpoint(self) -> None:
        t0 = time.perf_counter()
        self.change = self._norms(compare.change_squares(self._tables()))
        self.check_s += time.perf_counter() - t0
        self.eval = self.t.evaluate()
        del self.t._train_one
        del self._evaluator.eval_step
        if self.s > 1:
            del self.t._run_group

    def readings(self, eval_offsets=None) -> dict | None:
        """The program's side for compare.readings.  On a mesh every rank
        calls it: the ranks' logits on S0 (their slices' real rows) are
        gathered to rank 0 and placed at their eval rows, slice r's
        starting at eval_offsets[r] (given on rank 0); the others get
        None."""
        sums = torch.stack([s.double() for s in self.sums[:self.k]]).cpu().numpy()
        out = {"losses": list(sums[:, 0] / sums[:, 1]), "grad": self.grad,
               "change": self.change, "eval_loss": self.eval[0], "auc": self.eval[1]}
        if self.group is None:
            n_eval = self.config["eval_rows"]
            out["logits"] = torch.cat(self.logits).numpy()[:n_eval] if self.logits else []
            return out
        real = torch.cat(self.logits)[torch.cat(self.real)].numpy() if self.logits else []
        slices = self.group.gather((self.t._sharded.shard_index, real))
        if slices is None:
            return None
        by_slice = dict(slices)
        out["logits"] = np.concatenate([by_slice[r] for r in sorted(by_slice)])
        out["logit_rows"] = np.concatenate([eval_offsets[r] + np.arange(len(by_slice[r]))
                                            for r in sorted(by_slice)])
        out["route_drops"] = float(sums[:, 2].sum())
        return out
