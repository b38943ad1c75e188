"""The transfer tiers (ftrl_ffm_tpu_torch/transfer.py, models/base.py::
widen_batch) against the JAX package's (ftrl_ffm_tpu/train.py::_compact
and its helpers, models/base.py::widen_batch), on the CPU.

- The upload form of every batch equals Trainer._compact's, array for
  array and byte for byte (a bf16 leaf by its bits), on sequences that
  carry the delta and DEC6 hysteresis, for FFM, FM and LR, single batches
  and [S, B, F] groups, on the native path and the numpy one; and on more
  than one process (the static first pass, the agreed contract).
- widen_batch decodes every tier to JAX's bits, and to the raw arrays.
- A run with the tiers on gives compact_transfer=false's bits: histories,
  tables, predict_file bytes, and S = 4 against S = 1; each tier engages.
- With the tiers on, the port uploads what the JAX Trainer uploads and
  trains to its tables at tests/test_torch_trainer.py's tolerances.
- Two gloo ranks agree the contract JAX's two processes agree
  (tests/test_multihost.py:195-225) and match one process's losses at
  rtol 2e-5; a broken contract raises JAX's error text.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ftrl_ffm_tpu.native as jnative
import ftrl_ffm_tpu_torch.native as tnative
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.models.base import Batch as JBatch
from ftrl_ffm_tpu.models.base import widen_batch as j_widen
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
from ftrl_ffm_tpu_torch.models.base import Batch as TBatch
from ftrl_ffm_tpu_torch.models.base import widen_batch as t_widen
from ftrl_ffm_tpu_torch.train import Trainer
from ftrl_ffm_tpu_torch.transfer import describe_upload
from tests.test_parser import _compact_scenarios
from tests.test_torch_train import _assert_states_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 5  # the scenarios' max_nnz


# ---- the upload form, byte for byte ----
def _leaf(a):
    """(dtype name, shape, bytes) of one upload leaf: a numpy array, an
    ml_dtypes bfloat16 array (JAX) or a torch.bfloat16 tensor (the port)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return ("bfloat16", tuple(a.shape), a.view(torch.int16).numpy().tobytes())
    a = np.ascontiguousarray(a)
    return (str(a.dtype), tuple(a.shape), a.tobytes())


def _assert_same_upload(got, want, ctx):
    assert len(got) == len(want), ctx
    for i, (g, w) in enumerate(zip(got, want)):
        assert _leaf(g) == _leaf(w), f"{ctx}[{i}]: {_leaf(g) and _leaf(g)[:2]} against " \
                                     f"{_leaf(w) and _leaf(w)[:2]}"


def _tier_scenarios(n_feats, rng):
    """Sequences that reach the tiers _compact_scenarios does not: the
    split tier (ids spread over the whole table), DEC6 values, a value
    that breaks DEC6 (the tier stays off after it), both in groups."""
    def mk(b=8, spread=False, vals="ones", pad_rows=0, group=0):
        fields = rng.integers(0, 4, (b, F)).astype(np.int32)
        if spread:
            ids = rng.integers(0, n_feats, (b, F)).astype(np.int32)
            ids[0, 0], ids[1, 0] = 0, n_feats - 1
        else:
            ids = (rng.integers(0, max(1, n_feats - 300), F)[None, :]
                   + rng.integers(0, 200, (b, F))).astype(np.int32)
            ids = np.minimum(ids, n_feats - 1)
        if vals == "dec6":
            v = (rng.integers(0, 1 << 24, (b, F)).astype(np.float32) / np.float32(1e6))
        elif vals == "break":
            v = rng.random((b, F)).astype(np.float32)
        else:
            v = np.ones((b, F), np.float32)
        y = (rng.random(b) > 0.5).astype(np.float32)
        sw = np.ones(b, np.float32)
        if pad_rows:
            ids[-pad_rows:], v[-pad_rows:], sw[-pad_rows:] = n_feats, 0.0, 0.0
        arrs = (fields, ids, v.astype(np.float32), y, sw)
        if group:
            arrs = tuple(np.stack([a] * group) for a in arrs)
        return arrs

    return [
        [mk(spread=True), mk(), mk(spread=True, pad_rows=3)],  # split, and it stays
        [mk(spread=True, group=3)],                           # split in a group
        [mk(vals="dec6"), mk(vals="dec6", pad_rows=2, spread=True)],
        [mk(vals="dec6", group=2)],                           # DEC6 in a group
        [mk(vals="dec6"), mk(vals="break"), mk(vals="dec6")],  # DEC6 off for good
    ]


_CONFIGS = [("FFM", 1000, 4), ("FFM", 100000, 39), ("FFM", 1000, 300), ("FM", 1000, 4),
            ("LR", 100000, 4), ("LR", 1 << 20, 4)]


def _pair(tmp_path, tag, model_type, n_feats, n_fields):
    """A JAX Trainer and a port Trainer of one config (the file only names
    the format: _compact is fed arrays)."""
    p = tmp_path / f"d{tag}.ffm"
    p.write_text("1 0:1:1 1:2:1 2:3:1 3:4:1\n")
    kw = dict(train_data=str(p), model_type=model_type, n_feats=n_feats, n_fields=n_fields,
              n_factors=2, batch_size=8, max_nnz=F)
    return JTrainer(JConfig(**kw)), Trainer(Config(**kw, device="cpu"))


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("model_type,n_feats,n_fields", _CONFIGS)
def test_compact_matches_jax(tmp_path, monkeypatch, model_type, n_feats, n_fields, path):
    """Every scenario's upload forms equal the JAX Trainer's byte for byte,
    and the hysteresis ends in the same state."""
    if path == "native":
        if jnative.lib() is None or tnative.lib() is None:
            pytest.skip("no native toolchain")
    else:
        monkeypatch.setattr(jnative, "compact_batch", lambda *a, **k: None)
        monkeypatch.setattr(tnative, "compact_batch", lambda *a, **k: None)
    rng = np.random.default_rng(17)
    seqs = _compact_scenarios(n_feats, n_fields, rng) + _tier_scenarios(n_feats, rng)
    jt, tt = _pair(tmp_path, "c", model_type, n_feats, n_fields)
    for s_idx, seq in enumerate(seqs):
        for t in (jt, tt):  # each sequence starts the hysteresis afresh
            t._delta_ok = t._dec6_ok = True
        for b_idx, arrs in enumerate(seq):
            _assert_same_upload(tt._compact(arrs), jt._compact(arrs), f"s{s_idx}b{b_idx}")
        assert (tt._delta_ok, tt._dec6_ok) == (jt._delta_ok, jt._dec6_ok), f"scenario {s_idx}"


def test_compact_off_uploads_the_arrays_as_they_are(tmp_path):
    _, tt = _pair(tmp_path, 0, "FFM", 1000, 4)
    tt.cfg.compact_transfer = False
    arrs = _compact_scenarios(1000, 4, np.random.default_rng(0))[0][0]
    assert tt._compact(arrs) is arrs


@pytest.mark.parametrize("model_type", ["FFM", "LR"])
def test_compact_multiprocess_matches_jax(tmp_path, model_type):
    """On more than one process: the first pass uploads the static
    narrowings and observes (the observations JAX's), predict observes
    nothing, and under an agreed contract the uploads are JAX's."""
    rng = np.random.default_rng(5)
    seqs = _compact_scenarios(1000, 4, rng)
    jt, tt = _pair(tmp_path, "mp", model_type, 1000, 4)
    for t in (jt, tt):
        t._proc_n = 2
    for seq in seqs:
        for arrs in seq:
            for role in ("train", "predict"):
                _assert_same_upload(tt._compact(arrs, role), jt._compact(arrs, role), role)
    assert tt._dyn_obs.keys() == jt._dyn_obs.keys() == {"train"}
    for k, v in jt._dyn_obs["train"].items():
        assert np.array_equal(tt._dyn_obs["train"][k], v), k
    for agreed in ({"int8": True, "bf16": True, "sw": True, "delta": True},
                   {"int8": False, "bf16": True, "sw": False, "delta": False}):
        obs = jt._dyn_obs["train"]
        agreed = dict(agreed, base=np.where(obs["hi"] >= 0, obs["lo"], 0).astype(np.int32))
        for t in (jt, tt):
            t._dyn_agreed["train"] = agreed
        for arrs in (seqs[0][0], seqs[2][0], seqs[7][0]):  # ones, int8 vals, a group
            _assert_same_upload(tt._compact(arrs), jt._compact(arrs), str(agreed))


@pytest.mark.parametrize("violation", ["ids", "vals", "sample_w"])
def test_broken_contract_raises_jax_error(tmp_path, violation):
    """A batch that breaks the agreed contract (the data changed between
    passes) raises the JAX package's RuntimeError, word for word."""
    jt, tt = _pair(tmp_path, "bc", "FFM", 1000, 4)
    arrs = list(_compact_scenarios(1000, 4, np.random.default_rng(2))[0][0])
    agreed = {"int8": True, "bf16": False, "sw": True, "delta": True,
              "base": arrs[1].min(axis=0).astype(np.int32)}
    if violation == "ids":
        arrs[1] = arrs[1].copy()
        arrs[1][0, 0] = agreed["base"][0] + 70000
    elif violation == "vals":
        arrs[2] = np.full_like(arrs[2], 0.5)
    else:
        arrs[4] = np.full_like(arrs[4], 0.5)
    errors = []
    for t in (jt, tt):
        t._proc_n = 2
        t._dyn_agreed["train"] = agreed
        with pytest.raises(RuntimeError, match="compact-transfer contract violated") as e:
            t._compact(tuple(arrs))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---- the device-side decode ----
def _to_jax(a):
    return None if a is None else jnp.asarray(a)


def _to_torch(a):
    """A JAX upload leaf as the port's: an ml_dtypes bfloat16 array by its
    bits."""
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _steps(up):
    """The per-step batches of an upload form ([B, ...] or [S, B, ...])."""
    if up[1].ndim == 2:
        return [up]
    return [tuple(None if a is None else a[k] for a in up) for k in range(up[1].shape[0])]


@pytest.mark.parametrize("model_type,n_feats,n_fields", _CONFIGS)
def test_widen_batch_matches_jax_on_every_tier(tmp_path, model_type, n_feats, n_fields):
    """widen_batch of each upload form (JAX's _compact's, which the port's
    equals) gives JAX's widen_batch bits, and the raw arrays back: feats,
    vals, y and sample_w always, fields where the model reads them."""
    rng = np.random.default_rng(29)
    jt, _ = _pair(tmp_path, "w", model_type, n_feats, n_fields)
    seen = set()
    for seq in _compact_scenarios(n_feats, n_fields, rng) + _tier_scenarios(n_feats, rng):
        jt._delta_ok = jt._dec6_ok = True
        for arrs in seq:
            up = jt._compact(arrs)
            raw = _steps(arrs)
            for k, step in enumerate(_steps(up)):
                ref = j_widen(JBatch(*(_to_jax(a) for a in step)))
                got = t_widen(TBatch(*(_to_torch(a) for a in step)))
                assert got.feats_base is None
                for name, r, g in zip(TBatch._fields, ref[:5], got[:5]):
                    assert g.is_contiguous() and g.dtype in (torch.int32, torch.float32), name
                    np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
                # fields come back where the model reads them and every id
                # is below n_fields (the packed planes hold those bits)
                whole = model_type == "FFM" and raw[k][0].max() < n_fields
                for i in (0, 1, 2, 3, 4) if whole else (1, 2, 3, 4):
                    np.testing.assert_array_equal(got[i].numpy(), raw[k][i])
                seen.add((step[1].dtype.name, None if step[5] is None else step[5].dtype.name,
                          str(step[2].dtype), step[0].ndim, step[0].shape[-2]))
    assert any(s[1] == "int32" for s in seen) and any(s[2] == "uint8" for s in seen)
    if 65535 < n_feats < (1 << 24):  # ids past uint16 deltas: the split tier
        assert any(s[1] == "uint8" for s in seen)


# ---- Trainer runs: the tiers on and off ----
def _write(path, n, n_feats, n_fields, seed, ids="clustered", fields="canonical",
           vals="ones", libsvm=False, break_at=None):
    """n lines over n_fields fields: ids per-field clustered or spread over
    the table; fields in slot order on every row (canonical), shuffled, or
    sparse (some missing: padding); values ones, small ints, quarters
    (exact in bf16), 6-decimal, or random floats; break_at: a line whose
    value has 7 decimals (DEC6 turns off there)."""
    rng = np.random.default_rng(seed)
    block = max(1, n_feats // n_fields)
    with open(path, "w") as f:
        for i in range(n):
            order = list(range(n_fields))
            if fields == "shuffled":
                order = list(rng.permutation(n_fields))
            elif fields == "sparse":
                order = [c for c in order if rng.random() < 0.8]
            toks = [str(int(rng.random() > 0.5))]
            for c in order:
                if ids == "spread":
                    feat = int(rng.integers(0, n_feats))
                else:
                    feat = min(n_feats - 1, c * block + int(rng.integers(0, min(block, 50))))
                # no zero values: on a zero value JAX's XLA FFM gradient
                # leaves ~1e-8 of rounding where the port's is exactly 0,
                # which moves n past UNTOUCHED_N in JAX alone
                v = {"ones": "1", "int": str(int(rng.choice([-3, -2, -1, 1, 2, 3, 4, 5]))),
                     "quarter": f"{int(rng.integers(1, 9)) * 0.25}",
                     "dec6": f"{int(rng.integers(0, 10**6)) / 1e6:.6f}",
                     "f32": f"{rng.random() * 3:.9f}"}[vals]
                if i == break_at:
                    v = "0.1234567"
                toks.append(f"{feat}:{v}" if libsvm else f"{c}:{feat}:{v}")
            f.write(" ".join(toks) + "\n")
    return str(path)


CASES = {
    # name: (model, n_feats, n_fields, file kwargs, tiers that must engage)
    "delta-ones-iota": ("FFM", 60, 7, {}, {"delta", "ones", "iota", "int8"}),
    "split-100k": ("FFM", 100_000, 7, {"ids": "spread", "fields": "sparse"}, {"split"}),
    "split-2^20": ("LR", 1 << 20, 6, {"ids": "spread", "libsvm": True}, {"split", "no-fields"}),
    "dec6": ("FFM", 60, 7, {"vals": "dec6", "fields": "sparse"}, {"dec6", "packed", "delta"}),
    "dec6-break": ("FFM", 60, 7, {"vals": "dec6", "break_at": 40}, {"dec6", "f32"}),
    "packed-int8": ("FFM", 60, 7, {"vals": "int", "fields": "shuffled"}, {"packed", "int8"}),
    "bf16": ("FFM", 60, 7, {"vals": "quarter"}, {"bf16"}),
    "fm": ("FM", 60, 6, {"vals": "int", "libsvm": True}, {"no-fields", "int8", "delta"}),
    "f32": ("FFM", 60, 7, {"vals": "f32"}, {"f32"}),
}


def _files(tmp_path, case):
    model, n_feats, n_fields, kw, _ = CASES[case]
    ext = "svm" if kw.get("libsvm") else "ffm"
    train = _write(tmp_path / f"train.{ext}", 96, n_feats, n_fields, 0, **kw)
    evald = _write(tmp_path / f"eval.{ext}", 40, n_feats, n_fields, 1,
                   **{k: v for k, v in kw.items() if k != "break_at"})
    return dict(train_data=train, eval_data=evald, model_type=model, n_feats=n_feats,
                n_fields=n_fields, n_factors=4, batch_size=16, n_epochs=2, w_alpha=0.05,
                w_l1=0.15, w_l2=1.0, device_cache="off")


def _recording(trainer, sink):
    """Record every upload form the trainer's feeder and predict take."""
    compact = trainer._compact

    def rec(arrays, role="train"):
        up = compact(arrays, role)
        sink.append((role, up))
        return up

    trainer._compact = rec
    return trainer


def _port_run(tmp_path, kw, tag, **over):
    """(history, state, predictions' bytes, uploads) of a port run."""
    ups = []
    tr = _recording(Trainer(Config(**kw, **over, device="cpu")), ups)
    hist = tr.train()
    out = tmp_path / f"pred_{tag}.txt"
    tr.predict_file(kw["eval_data"], str(out))
    return hist, tr.state, out.read_bytes(), ups


def _same_state(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def test_describe_upload_names_tiers_and_counts_bytes(tmp_path):
    """describe_upload names the tiers of one _compact output and counts
    its bytes (a bf16 leaf by its tensor's), and names a parsed batch
    "off"."""
    kw = _files(tmp_path, "delta-ones-iota")
    tr = Trainer(Config(**kw, device="cpu"))
    arrays = next(iter(tr._train_batches(np.random.default_rng(0))))
    up = tr._compact(arrays, "train")
    assert describe_upload(up) == ({"delta", "ones", "iota"},
                                   sum(a.nbytes for a in up if a is not None))
    assert describe_upload(arrays) == ({"off"}, sum(a.nbytes for a in arrays))
    bf16 = (*up[:2], torch.ones(3, dtype=torch.bfloat16), *up[3:])
    tiers, size = describe_upload(bf16)
    assert "bf16" in tiers and size == sum(a.nbytes for a in up if a is not None) - up[2].nbytes + 6


@pytest.mark.parametrize("case", list(CASES))
def test_tiers_on_and_off_give_the_same_bits(tmp_path, case):
    """Streamed training (2 epochs with eval) and predict_file with the
    tiers on equal the run with them off, bit for bit; so does S = 4
    against S = 1 with them on.  The case's tiers engage."""
    kw = _files(tmp_path, case)
    on = _port_run(tmp_path, kw, "on")
    off = _port_run(tmp_path, kw, "off", compact_transfer=False)
    s4 = _port_run(tmp_path, kw, "s4", steps_per_call=4)
    assert on[0] == off[0] == s4[0]
    assert _same_state(on[1], off[1]) and _same_state(on[1], s4[1])
    assert on[2] == off[2] == s4[2] and on[2]
    assert all(describe_upload(up)[0] == {"off"} for _, up in off[3])
    taken = set().union(*(describe_upload(up)[0] for _, up in on[3]))
    assert CASES[case][4] <= taken, taken
    assert {r for r, _ in on[3]} == {"train", "eval", "predict"}
    assert any(up[1].ndim == 3 for _, up in s4[3])  # S = 4 groups went up compact


def test_fractional_sample_weights_stay_f32(tmp_path):
    """Fractional sample weights (never from a file: a caller's batches)
    keep their f32 upload, and the steps give the untiered bits."""
    kw = _files(tmp_path, "dec6")
    rng = np.random.default_rng(4)
    tr_on, tr_off = Trainer(Config(**kw, device="cpu")), Trainer(
        Config(**kw, device="cpu", compact_transfer=False))
    for arrays in tr_on._train_batches(rng):
        arrays = (*arrays[:4], (arrays[4] * 0.5).astype(np.float32))
        up = tr_on._compact(arrays)
        assert up[4].dtype == np.float32 and "dec6" in describe_upload(up)[0]
        for t in (tr_on, tr_off):
            (batch, _), = [t._place_async(arrays, "train")]
            t.model.train_step(t.state, batch)
    assert _same_state(tr_on.state, tr_off.state)


@pytest.mark.parametrize("case", ["delta-ones-iota", "split-100k", "dec6", "bf16"])
def test_tiered_training_matches_jax(tmp_path, case):
    """With the tiers on in both packages, from one carried init: every
    batch the port uploads (train, eval) is the JAX Trainer's, byte for
    byte, and the histories and tables agree at test_torch_trainer.py's
    tolerances.  (Not on packed-int8's data, tiers or none: where a factor
    weight is exactly 0, JAX's XLA FFM gradient leaves ~1e-8 of rounding
    where the port's is exactly 0, and the larger integer values push its
    n past UNTOUCHED_N in JAX alone, which then sets w by the closed form.)"""
    kw = _files(tmp_path, case)
    jtr = JTrainer(JConfig(**kw))
    ttr = Trainer(Config(**kw, device="cpu"), state=state_from_jax_arrays(jtr.state, "cpu"))
    uploads = {}
    for name, t in (("jax", jtr), ("port", ttr)):
        _recording(t, uploads.setdefault(name, []))
    hj, ht = jtr.train(), ttr.train()
    assert len(uploads["jax"]) == len(uploads["port"]) > 0
    for i, ((rj, uj), (rt, ut)) in enumerate(zip(uploads["jax"], uploads["port"])):
        assert rj == rt
        _assert_same_upload(ut, uj, f"batch {i} ({rt})")
    for key in hj:
        np.testing.assert_allclose(np.array(ht[key], np.float64), np.array(hj[key], np.float64),
                                   rtol=0, atol=1e-4, err_msg=key)
    _assert_states_close(ttr.state, jtr.state)


# ---- two processes ----
_WORKER = r"""
import json, sys
import ftrl_ffm_tpu_torch.train as T
from ftrl_ffm_tpu_torch.cli import main

out, argv = sys.argv[1], sys.argv[2:]
train = T.Trainer.train


def recorded(self, *a, **k):
    h = train(self, *a, **k)
    h["compact_agreed"] = {role: {k: (v.tolist() if hasattr(v, "tolist") else v)
                                  for k, v in d.items()}
                           for role, d in self._dyn_agreed.items()}
    h["world"] = self._proc_n
    json.dump(h, open(out, "w"))
    return h


T.Trainer.train = recorded
sys.exit(main(argv))
"""


def _fixed_width_ffm(path, n=256, n_fields=4, n_feats=50, seed=0):
    """tests/test_multihost.py::_write_fixed_width_ffm."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(10, n_feats)):02d}:1" for c in range(n_fields)
            ]
            f.write(" ".join(toks) + "\n")
    return str(path)


def _spawn(args_of, n, timeout=540, env_extra=None):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    procs = [subprocess.Popen(args_of(p, coord), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for p in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"process failed:\n{log}"


def test_two_rank_agreement_matches_jax_two_process(tmp_path):
    """2 gloo ranks of the port's CLI (3 streamed epochs, default mesh)
    agree the contract the JAX package's 2-process run agrees (delta, int8, integral
    weights for train; the same bases), and their losses match the
    one-process runs of both packages at rtol 2e-5."""
    data = _fixed_width_ffm(tmp_path / "train.ffm")
    base = dict(train_data=data, eval_data=data, model_type="FFM", n_fields=4, n_feats=50,
                n_factors=4, batch_size=256, n_epochs=3, online=True)
    jt = JTrainer(JConfig(**base))
    init = str(tmp_path / "init.ckpt")
    jt.save_checkpoint(init)
    ref_j = jt.train()
    from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint

    ref_t = Trainer(Config(**base, device="cpu"),
                    state=state_from_jax_arrays(load_checkpoint(init)[0], "cpu")).train()
    outs = [str(tmp_path / f"port{p}.json") for p in range(2)]
    flags = ["--train_data", data, "--eval_data", data, "--model_type", "FFM", "--n_fields",
             "4", "--n_feats", "50", "--n_factors", "4", "--batch_size", "256", "--n_epochs",
             "3", "--load_model", init, "--device_cache", "off", "--device", "cpu"]
    _spawn(lambda p, coord: [sys.executable, "-c", _WORKER, outs[p], *flags,
                             "--coordinator_address", coord, "--num_processes", "2",
                             "--process_id", str(p)], 2)
    # the JAX package's 2-process run (tests/multihost_worker.py), one CPU
    # device a process
    jouts = [str(tmp_path / f"jax{p}.json") for p in range(2)]
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    _spawn(lambda p, coord: [sys.executable, worker, coord, "2", str(p), data, jouts[p], "1",
                             "auto", "", "", "3"], 2,
           env_extra={"XLA_FLAGS": "--xla_force_host_platform_device_count=1",
                      "JAX_PLATFORMS": "cpu"})
    jagreed = [json.load(open(o))["compact_agreed"] for o in jouts]
    assert jagreed[0] == jagreed[1]
    assert jagreed[0]["train"]["delta"] and jagreed[0]["train"]["int8"]
    for out in outs:
        h = json.load(open(out))
        assert h["world"] == 2
        assert h["compact_agreed"] == jagreed[0]
        for ref in (ref_j, ref_t):
            np.testing.assert_allclose(h["train_loss"], ref["train_loss"], rtol=2e-5)
            np.testing.assert_allclose(h["eval_loss"], ref["eval_loss"], rtol=2e-5)
