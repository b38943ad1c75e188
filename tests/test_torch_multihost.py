"""Multi-process runs of the port over gloo on the CPU, through its CLI (the
twin of tests/test_multihost.py:136-499): one process a device, each
started with --coordinator_address/--num_processes/--process_id.

Every run's files hold one global batch a step (256 equal-width lines,
B=256), so the byte-range composition of the ranks' slices is the
one-process batch, and the runs must agree with a one-process run: losses
rtol 2e-5, AUC 1e-4 (f32 sums over the mesh in another order); trained
tables within tests/test_multihost.py's rtol 1e-3 / atol 1e-5 (its
reason: z accumulates in another order, ~3e-4 relative on near-cancelling
entries); predictions of one state byte for byte; and a mesh save of a
given state decompresses to the bytes a one-process save of it writes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("lin_z", "lin_n", "vec_z", "vec_n", "vec_w")
MODEL = ["--model_type", "FFM", "--n_fields", "4", "--n_feats", "50", "--n_factors", "4",
         "--batch_size", "256"]

# Runs in each process (python -c, the repo on sys.path).  "cli": the
# port's CLI with the given flags, recording Trainer.train's history (and
# which roles ran resident) as JSON; "save": a Trainer on the mesh takes
# a checkpoint's state and saves it again.
_WORKER = r"""
import json, sys
mode, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
if mode == "cli":
    import ftrl_ffm_tpu_torch.train as T
    from ftrl_ffm_tpu_torch.cli import main

    train = T.Trainer.train

    def recorded(self, *a, **k):
        h = train(self, *a, **k)
        h["device_cache"] = {r: (e.layout if e is not None else "streamed")
                             for r, e in self._dev_cache.items()}
        h["world"] = self._proc_n
        h["mesh"] = [self._mesh.data, self._mesh.model] if self._mesh else None
        json.dump(h, open(out, "w"))
        return h

    T.Trainer.train = recorded
    sys.exit(main(argv))
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint, state_from_jax_arrays
from ftrl_ffm_tpu_torch.parallel import dist
from ftrl_ffm_tpu_torch.train import Trainer

import ftrl_ffm_tpu_torch.io.checkpoint as ck

coord, world, rank, src, kw = argv[0], int(argv[1]), int(argv[2]), argv[3], json.loads(argv[4])
ck.CHUNK_BYTES = kw.pop("chunk_bytes", ck.CHUNK_BYTES)
dist.initialize(coord, world, rank, "cpu")
state, _ = load_checkpoint(src)
tr = Trainer(Config(**kw, device="cpu"), state=state_from_jax_arrays(state, "cpu"))
tr.save_checkpoint(out)
dist.destroy()
"""


def _write_fixed_width_ffm(path, n=256, n_fields=4, n_feats=50, seed=0):
    """tests/test_multihost.py::_write_fixed_width_ffm: equal-length lines,
    so that N byte ranges hold n / N lines each."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(10, n_feats)):02d}:1" for c in range(n_fields)
            ]
            f.write(" ".join(toks) + "\n")
    return str(path)


def _run(tmp_path, nprocs, mode, argv_of, timeout=300):
    """Start nprocs worker processes; argv_of(p, coord) gives process p's
    arguments.  Returns their outputs' paths."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"{mode}{p}.out") for p in range(nprocs)]
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, mode, outs[p], *argv_of(p, coord)],
                         env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
        for p in range(nprocs)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"process failed:\n{log}"
    return outs, logs


def _cli(tmp_path, nprocs, flags):
    """The port's CLI on nprocs processes: (histories, logs)."""
    def argv_of(p, coord):
        return ["--coordinator_address", coord, "--num_processes", str(nprocs),
                "--process_id", str(p), "--device", "cpu", *flags]

    outs, logs = _run(tmp_path, nprocs, "cli", argv_of)
    return [json.load(open(o)) for o in outs if os.path.exists(o)], logs


def _one_process(data, model_type="FFM", **kw):
    """(JAX history, port history, port trainer, init flags) of the
    one-process run, the port's from the JAX package's init (a factor
    model's init is random): init flags --load_model its checkpoint."""
    from ftrl_ffm_tpu.config import Config as JConfig
    from ftrl_ffm_tpu.train import Trainer as JTrainer
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint, state_from_jax_arrays
    from ftrl_ffm_tpu_torch.train import Trainer

    base = dict(train_data=data, eval_data=data, model_type=model_type, n_fields=4,
                n_feats=50, n_factors=4, batch_size=256, n_epochs=2, online=True)
    base.update(kw)
    jt = JTrainer(JConfig(**base))
    init = os.path.join(os.path.dirname(data), "init.ckpt")
    jt.save_checkpoint(init)
    jh = jt.train()
    tr = Trainer(Config(**base, device="cpu"),
                 state=state_from_jax_arrays(load_checkpoint(init)[0], "cpu"))
    return jh, tr.train(), tr, ["--load_model", init]


def _assert_matches(hist, ref):
    np.testing.assert_allclose(hist["train_loss"], ref["train_loss"], rtol=2e-5)
    np.testing.assert_allclose(hist["eval_loss"], ref["eval_loss"], rtol=2e-5)
    np.testing.assert_allclose(hist["eval_auc"], ref["eval_auc"], rtol=1e-4)


def test_two_process_matches_single(tmp_path):
    """Two processes on the default mesh (data parallel over both) equal
    one: the JAX package's and the port's one-process runs."""
    data = _write_fixed_width_ffm(tmp_path / "train.ffm")
    jh, th, _, init = _one_process(data)
    hists, _ = _cli(tmp_path, 2, ["--train_data", data, "--eval_data", data, *MODEL,
                                  "--n_epochs", "2", *init])
    assert len(hists) == 2
    for h in hists:
        assert h["world"] == 2 and h["mesh"] == [2, 1]
        _assert_matches(h, jh)
        _assert_matches(h, th)


def test_two_process_lr_zero_width_fields(tmp_path):
    """LR on two processes: no factor tables and fields unread, the
    losses a one-process LR run's."""
    data = _write_fixed_width_ffm(tmp_path / "train.ffm")
    jh, th, _, init = _one_process(data, "LR")
    flags = ["--train_data", data, "--eval_data", data, *MODEL, "--n_epochs", "2", *init]
    flags[flags.index("FFM")] = "LR"
    hists, _ = _cli(tmp_path, 2, flags)
    for h in hists:
        _assert_matches(h, jh)
        _assert_matches(h, th)


def test_two_process_route_sharded_checkpoint(tmp_path):
    """A (1, 2) route mesh over two processes trains as one process does,
    rank 0 alone writes --model_path, and the file's tables (loaded by
    either package) match the one-process run's."""
    from ftrl_ffm_tpu.io.checkpoint import load_checkpoint as j_load
    from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint

    data = _write_fixed_width_ffm(tmp_path / "train.ffm")
    jh, th, tr, init = _one_process(data)
    ckpt = str(tmp_path / "mh.ckpt")
    hists, logs = _cli(tmp_path, 2, ["--train_data", data, "--eval_data", data, *MODEL, *init,
                                     "--n_epochs", "2", "--mesh_model", "2",
                                     "--lookup_mode", "route", "--model_path", ckpt])
    assert "checkpoint saved to" in logs[0] and "checkpoint saved to" not in logs[1]
    for h in hists:
        assert h["mesh"] == [1, 2]
        _assert_matches(h, jh)
    ref = tr.logical_state
    for state in (load_checkpoint(ckpt)[0], j_load(ckpt)[0]):
        assert np.asarray(state.lin_z).shape == (50,)
        for name in TABLES:
            np.testing.assert_allclose(np.asarray(getattr(state, name), np.float32),
                                       getattr(ref, name).numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=name)
        assert int(state.step) == int(ref.step)


@pytest.mark.parametrize("mesh,chunk_bytes", [((1, 2), 256), ((1, 2), None), ((2, 1), None)],
                         ids=["1x2-256-byte-chunks", "1x2", "2x1"])
def test_mesh_save_of_a_state_is_the_one_process_bytes(tmp_path, mesh, chunk_bytes):
    """A state saved from a mesh (its tables gathered to rank 0 a chunk at
    a time: 256-byte chunks force many, of rows of 64 bytes and 4) of 51
    rows, one a padding row on the (1, 2) mesh, decompresses to the bytes
    a one-process save of that state writes (the twin of
    tests/test_checkpoint.py::test_sharded_checkpoint_streams_logical_rows)."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.io import zstd
    from ftrl_ffm_tpu_torch.train import Trainer

    data = _write_fixed_width_ffm(tmp_path / "train.ffm")
    kw = dict(model_type="FFM", n_fields=4, n_feats=51, n_factors=4, batch_size=256,
              max_nnz=4, file_type="libffm")
    tr = Trainer(Config(train_data=data, **kw, device="cpu"))
    tr.train()
    one = str(tmp_path / "one.ckpt")
    tr.save_checkpoint(one)
    mkw = dict(kw, mesh_data=mesh[0], mesh_model=mesh[1])
    if chunk_bytes:
        mkw["chunk_bytes"] = chunk_bytes
    outs, _ = _run(tmp_path, 2, "save",
                   lambda p, coord: [coord, "2", str(p), one, json.dumps(mkw)])
    assert not os.path.exists(outs[1])
    raw = [zstd.decompress(open(p, "rb").read()) for p in (one, outs[0])]
    assert raw[0] == raw[1]


def test_two_process_ordered_predict_file_byte_identical(tmp_path):
    """Two processes score their byte ranges in lockstep and the
    coordinator writes each range's lines at their offsets: the file is a
    one-process run's, byte for byte.  300 lines (an uneven last batch)
    with blank lines, which the parsers skip; an untrained state, whose
    bits do not depend on the process count."""
    from ftrl_ffm_tpu_torch.cli import main

    data = _write_fixed_width_ffm(tmp_path / "score.ffm", n=300)
    content = open(data).readlines()
    content.insert(10, "\n")
    content.insert(200, "   \n")
    with open(data, "w") as f:
        f.writelines(content)
    ref = str(tmp_path / "ref.txt")
    flags = ["--train_data", data, *MODEL, "--n_epochs", "0", "--predict_data", data]
    assert main([*flags, "--predict_output", ref, "--device", "cpu"]) == 0
    got = str(tmp_path / "mh.txt")
    _cli(tmp_path, 2, [*flags, "--mesh_model", "2", "--predict_output", got])
    assert len(open(got, "rb").read()) == 9 * 300
    assert open(got, "rb").read() == open(ref, "rb").read()


def test_four_process_route_inplace_matches_single(tmp_path):
    """A (1, 4) mesh over four processes, routed lookups and the in-place
    update: the losses and the saved state a one-process run's."""
    from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint

    data = _write_fixed_width_ffm(tmp_path / "train.ffm")
    jh, th, tr, init = _one_process(data)
    ckpt = str(tmp_path / "mh4.ckpt")
    hists, _ = _cli(tmp_path, 4, ["--train_data", data, "--eval_data", data, *MODEL, *init,
                                  "--n_epochs", "2", "--mesh_model", "4",
                                  "--lookup_mode", "route", "--update_mode", "inplace",
                                  "--model_path", ckpt])
    assert len(hists) == 4
    for h in hists:
        assert h["mesh"] == [1, 4]
        _assert_matches(h, jh)
        _assert_matches(h, th)
    state, _ = load_checkpoint(ckpt)
    ref = tr.logical_state
    for name in TABLES:
        np.testing.assert_allclose(np.asarray(getattr(state, name)), getattr(ref, name).numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    assert int(state.step) == int(ref.step)


def test_two_process_replicate_cache_matches_streamed(tmp_path):
    """The resident dataset on two processes through the CLI: under auto,
    as in the JAX package, each rank holds its byte-range slice (the shard
    layout), which equals the streamed two-process run bit for bit and the
    one-process runs (tests/test_multihost.py:396); under replicate, which
    would need the whole dataset on every rank, the run streams as the JAX
    package's does and rank 0 says so (its bits: the streamed run's)."""
    data = _write_fixed_width_ffm(tmp_path / "train.ffm")
    jh, th, _, init = _one_process(data, online=False, shuffle=False, device_cache="off")
    base = ["--train_data", data, "--eval_data", data, *MODEL, "--n_epochs", "2", *init,
            "--online", "false", "--shuffle", "false"]
    cached, _ = _cli(tmp_path, 2, [*base, "--device_cache", "on"])
    streamed, _ = _cli(tmp_path, 2, [*base, "--device_cache", "off"])
    replicate, logs = _cli(tmp_path, 2, [*base, "--device_cache", "on",
                                         "--device_cache_layout", "replicate"])
    assert "replicate layout needs the whole dataset" in logs[0]
    assert "not in the PyTorch port yet" not in logs[0]
    for c, s, r in zip(cached, streamed, replicate):
        assert c["device_cache"] == {"train": "shard", "eval": "shard"}
        assert r["device_cache"] == {"train": "streamed", "eval": "streamed"}
        for key in ("train_loss", "eval_loss", "eval_auc"):
            assert c[key] == s[key] == r[key]
        _assert_matches(c, jh)
        _assert_matches(c, th)


def test_multiprocess_flags_come_as_three():
    from ftrl_ffm_tpu_torch.cli import main

    with pytest.raises(ValueError, match="need all of --coordinator_address"):
        main(["--coordinator_address", "localhost:1", "--train_data", "x", "--device", "cpu"])


def test_mesh_on_the_card_needs_nccl():
    """No fallback: a process group on gloo never takes the card's tensors
    (a mesh on the card without NCCL raises)."""
    from ftrl_ffm_tpu_torch.parallel import dist

    dist.ensure_group("cpu")
    with pytest.raises(RuntimeError, match="gloo never carries card tensors"):
        dist.ensure_group("cuda")
