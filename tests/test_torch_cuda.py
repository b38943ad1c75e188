"""Card-only checks of the port's CUDA kernels: each kernel against its
plain PyTorch version on the same device tensors.  Marked `cuda`; they skip
where there is no card.  This file imports nothing of JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX for the rest of the suite).
f32 sums in another order: logits rtol=1e-4, atol=1e-5; training payload
rtol=1e-4, atol=1e-6; updated table rows rtol=1e-5, atol=1e-6, rows no id
touches bit-identical, and the update kernel bit-identical run to run.  The
updates are held against their plain versions on CPU copies of the inputs:
the CPU's index_add_ sums duplicate ids in payload order, the kernels'
order, where the card's sums them in no fixed order.  The
closed-form pass runs the plain version's operations one by one: rtol=1e-6,
atol=1e-7 (the JAX suite's Pallas-vs-XLA bound for it), coordinates with
A = 0 keep their n and z bits.  The probe kernels (ftrl_ffm_tpu_torch/tools):
the no-w pass the same way, the canonical-fields kernel as the training
kernel, the read-modify-write variants bit for bit the plain version on CPU
copies, the gathered sum within 1e-5 of its largest |sum|."""

import contextlib

import numpy as np
import pytest
import torch

from ftrl_ffm_tpu_torch.ftrl import (
    UNTOUCHED_N,
    FtrlParams,
    closed_form_pass_plain,
    ftrl_weights,
)
from ftrl_ffm_tpu_torch.ops.ffm_cuda import (
    ffm_fused_logits,
    ffm_fused_logits_grads,
    ffm_fused_logits_grads_plain,
    ffm_fused_logits_plain,
)
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import (
    closed_form_pass,
    ftrl_update,
    ftrl_update_inplace,
    ftrl_update_plain,
    za_scatter,
    za_scatter_plain,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


# (B, F, C', K, real fields): the Criteo shape with the linear mirror in
# dead lane 39, odd B, F above 39 (staged, then too big to stage), the
# 7-field field_pad-8 shape, and a row width not a multiple of 4
SHAPES = [
    (16, 5, 4, 8, 4),
    (256, 39, 40, 16, 39),
    (33, 39, 40, 16, 39),
    (17, 64, 40, 16, 39),
    (9, 100, 40, 16, 39),
    (16, 7, 8, 16, 7),
    (5, 6, 5, 3, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,c,k,real", SHAPES)
def test_ffm_logits_kernel_matches_plain(b, f, c, k, real):
    dev = _card()
    rng = np.random.default_rng(b * f + c)
    v = (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32)
    if real < c:
        v[:, real] = rng.normal(size=b * f).astype(np.float32) * 0.3
    fields = rng.integers(0, real, (b, f)).astype(np.int32)
    fields[:, 0] = c + 3  # out of range: selects nothing
    vals = rng.random((b, f)).astype(np.float32)
    vals[:, -1] = 0.0  # padding occurrences
    vals[-1] = 0.0  # a padded sample
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (v, fields, vals, lin)]
    before = ffm_fused_logits.launches
    got = ffm_fused_logits(*args, c, k)
    torch.cuda.synchronize()
    assert ffm_fused_logits.launches == before + 1
    ref = ffm_fused_logits_plain(*args, c, k)
    np.testing.assert_allclose(
        got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5
    )


@pytest.mark.cuda
def test_ffm_logits_kernel_checks_its_inputs():
    dev = _card()
    b, f, c, k = 4, 3, 4, 2
    v = torch.zeros((b * f, c * k), device=dev)
    fields = torch.zeros((b, f), dtype=torch.int32, device=dev)
    vals = torch.zeros((b, f), device=dev)
    lin = torch.zeros((b,), device=dev)
    with pytest.raises(ValueError, match="dtype|is torch"):
        ffm_fused_logits(v, fields.long(), vals, lin, c, k)
    with pytest.raises(ValueError, match="shape"):
        ffm_fused_logits(v[:-1], fields, vals, lin, c, k)
    with pytest.raises(ValueError, match="contiguous"):
        ffm_fused_logits(v, fields.t().contiguous().t(), vals, lin, c, k)


# (B, F, C', K, real fields, aug lane): the shapes above with the linear
# gradient in the dead lane where one exists
FUSED = [
    (16, 5, 4, 8, 4, -1),
    (256, 39, 40, 16, 39, 39),
    (33, 39, 40, 16, 39, 39),
    (17, 64, 40, 16, 39, 39),
    (9, 100, 40, 16, 39, 39),
    (16, 7, 8, 16, 7, 7),
    (16, 8, 8, 16, 8, -1),
    (5, 6, 5, 3, 4, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,c,k,real,aug", FUSED)
def test_ffm_fused_kernel_matches_plain(b, f, c, k, real, aug):
    dev = _card()
    rng = np.random.default_rng(b * f + c + 1)
    v = (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32)
    fields = rng.integers(0, real, (b, f)).astype(np.int32)
    fields[:, 0] = c + 3  # out of range: no factor gradient
    vals = rng.random((b, f)).astype(np.float32)
    vals[:, -1] = 0.0  # padding occurrences
    vals[-1] = 0.0  # a padded sample
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    sw[-1] = 0.0
    args = [torch.from_numpy(a).to(dev) for a in (v, fields, vals, lin, y, sw)]
    before = ffm_fused_logits_grads.launches
    logits, gg2 = ffm_fused_logits_grads(*args, c, k, aug_lane=aug)
    torch.cuda.synchronize()
    assert ffm_fused_logits_grads.launches == before + 1
    ref_logits, ref_gg2 = ffm_fused_logits_grads_plain(*args, c, k, aug_lane=aug)
    np.testing.assert_allclose(
        logits.cpu().numpy(), ref_logits.cpu().numpy(), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(gg2.cpu().numpy(), ref_gg2.cpu().numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,c,k,real,aug", FUSED)
def test_ffm_fused_kernel_split_matches_plain(b, f, c, k, real, aug):
    """The split output (g, g^2 in two [B*F, E] tensors): against the plain
    version, and bit for bit the two halves of the combined output."""
    dev = _card()
    rng = np.random.default_rng(b * f + c + 2)
    v = (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32)
    fields = rng.integers(0, real, (b, f)).astype(np.int32)
    fields[:, 0] = c + 3
    vals = rng.random((b, f)).astype(np.float32)
    vals[:, -1] = 0.0
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    sw[-1] = 0.0
    args = [torch.from_numpy(a).to(dev) for a in (v, fields, vals, lin, y, sw)]
    before = ffm_fused_logits_grads.launches
    logits, g, g2 = ffm_fused_logits_grads(*args, c, k, aug_lane=aug, combined_out=False)
    torch.cuda.synchronize()
    assert ffm_fused_logits_grads.launches == before + 1
    e = c * k
    assert g.shape == g2.shape == (b * f, e)
    ref_logits, ref_g, ref_g2 = ffm_fused_logits_grads_plain(
        *args, c, k, aug_lane=aug, combined_out=False
    )
    np.testing.assert_allclose(
        logits.cpu().numpy(), ref_logits.cpu().numpy(), rtol=1e-4, atol=1e-5
    )
    for got, ref in ((g, ref_g), (g2, ref_g2)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-6)
    c_logits, gg2 = ffm_fused_logits_grads(*args, c, k, aug_lane=aug)
    assert torch.equal(logits, c_logits)
    assert torch.equal(g, gg2[:, :e]) and torch.equal(g2, gg2[:, e:])


def spec_fused_inputs(b, f, seed):
    """numpy inputs of kernel #2 at C'=40, K=16 (csrc/ffm_fused.cu's
    specialised instance): each sample's fields a shuffle of 40 fields cut
    to F, then (F >= 6) occurrence 1 repeating occurrence 0's field,
    occurrences 2 and 3 out of range (40 and -1) and the last two padding
    (value 0, field 0); with B > 1 the last sample is padding (values and
    weight 0).  tests/test_torch_fused_kernel.py holds the same inputs
    against the JAX package."""
    rng = np.random.default_rng(seed)
    c, k = 40, 16
    v = (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32)
    fields = np.stack([rng.permutation(c)[:f] for _ in range(b)]).astype(np.int32)
    vals = rng.random((b, f)).astype(np.float32)
    if f >= 6:
        fields[:, 1] = fields[:, 0]
        fields[:, 2] = c
        fields[:, 3] = -1
        vals[:, -2:] = 0.0
        fields[:, -2:] = 0
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    if b > 1:
        vals[-1] = 0.0
        sw[-1] = 0.0
    return v, fields, vals, lin, y, sw


@pytest.mark.cuda
@pytest.mark.parametrize("combined", [True, False])
@pytest.mark.parametrize("aug", [-1, 39])
@pytest.mark.parametrize("f", [39, 40, 13])
@pytest.mark.parametrize("b", [1, 33, 256])
def test_ffm_fused_c40_instance_matches_plain(b, f, aug, combined):
    """The C'=40, K=16 instance on shuffled, repeated, out-of-range and
    padding fields: against the plain version (logits rtol=1e-4,
    atol=1e-5; payload rtol=1e-4, atol=1e-6), launched as that instance,
    and the same call twice gives the same bits."""
    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in spec_fused_inputs(b, f, b + f + aug)]
    counts = ffm_fused_logits_grads.launches_by_instance
    before = dict(counts)
    got = [ffm_fused_logits_grads(*args, 40, 16, aug_lane=aug, combined_out=combined)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert counts["c40_k16"] == before["c40_k16"] + 2
    assert counts["general"] == before["general"]
    want = ffm_fused_logits_grads_plain(*args, 40, 16, aug_lane=aug, combined_out=combined)
    np.testing.assert_allclose(got[0][0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    for g, w in zip(got[0][1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4, atol=1e-6)
    assert all(torch.equal(x, y) for x, y in zip(*got))


@pytest.mark.cuda
def test_ffm_fused_instance_follows_the_shape():
    """The bench's shape (C'=40, K=16, F <= 40) runs the specialised
    instance; F=64, C'=8 and K=8 run the general one, F=100 (too big to
    stage) the general one on rows in device memory; each launch counts
    once, under its instance."""
    dev = _card()
    counts = ffm_fused_logits_grads.launches_by_instance
    # (B, F, C', K, instance)
    for b, f, c, k, name in ((64, 39, 40, 16, "c40_k16"), (17, 64, 40, 16, "general"),
                             (16, 7, 8, 16, "general"), (16, 10, 40, 8, "general"),
                             (9, 100, 40, 16, "general_device_memory")):
        rng = np.random.default_rng(f)
        arrays = (
            (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32),
            rng.integers(0, c, (b, f)).astype(np.int32),
            rng.random((b, f)).astype(np.float32),
            np.zeros(b, np.float32), np.ones(b, np.float32), np.ones(b, np.float32),
        )
        before, total = dict(counts), ffm_fused_logits_grads.launches
        ffm_fused_logits_grads(*(torch.from_numpy(a).to(dev) for a in arrays), c, k)
        torch.cuda.synchronize()
        assert ffm_fused_logits_grads.launches == total + 1
        assert {n: counts[n] - before[n] for n in counts} == {
            n: int(n == name) for n in counts
        }, (b, f, c, k)


def _update_inputs(dev, r, e, n, lane, seed):
    """Tables as training leaves them (w = closed form where n > 0, the
    init elsewhere), ids with duplicates and the sentinel r, rows r-3..r-1
    untouched, payloads with g^2 = g * g."""
    rng = np.random.default_rng(seed)
    p = FtrlParams(alpha=0.05, l1=0.15, l2=1.0)

    def table(*shape):
        n_tab = torch.from_numpy((rng.random(shape) * 2).astype(np.float32))
        n_tab[torch.from_numpy(rng.random(shape) < 0.3)] = 0.0
        z = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        init = torch.from_numpy((rng.normal(size=shape) * 0.02).astype(np.float32))
        w = torch.where(n_tab > UNTOUCHED_N, ftrl_weights(n_tab, z, p), init)
        return [t.to(dev) for t in (n_tab, z, w)]

    tables = table(r, e) + table(r)
    ids = rng.integers(0, r - 3, n).astype(np.int32)
    ids[rng.random(n) < 0.05] = r
    g = (rng.normal(size=(n, e)) * 0.2).astype(np.float32)
    gl = g[:, max(lane, 0)]
    gg2_lin = None if lane >= 0 else torch.from_numpy(np.stack([gl, gl * gl], -1)).to(dev)
    gg2 = torch.from_numpy(np.concatenate([g, g * g], -1)).to(dev)
    return tables, torch.from_numpy(ids).to(dev), gg2, gg2_lin, p


@pytest.mark.cuda
@pytest.mark.parametrize(
    "r,e,n,lane", [(64, 640, 4000, 39), (64, 128, 4000, -1), (20, 15, 300, 4), (300, 80, 10, 7),
                   # FM's K=16 row: no dead lane, the linear stats in gg2_lin
                   (64, 16, 4000, -1), (300, 16, 10, -1)]
)
def test_ftrl_update_kernel_matches_plain_and_repeats(r, e, n, lane):
    dev = _card()
    tables, ids, gg2, gg2_lin, p = _update_inputs(dev, r, e, n, lane, r + e + n)
    runs = []
    for _ in range(2):
        got = [t.clone() for t in tables]
        before = ftrl_update.launches
        ftrl_update(*got, ids, gg2, lane, p, gg2_lin)
        torch.cuda.synchronize()
        assert ftrl_update.launches == before + 1
        runs.append(got)
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    vec, lin = ftrl_update_plain(*map(cpu, tables), ids.cpu(), gg2.cpu(), lane, p, cpu(gg2_lin))
    touched = torch.zeros(r, dtype=torch.bool, device=dev)
    touched[ids[ids < r].long()] = True
    assert not touched[r - 3:].any()
    for got, want, before, again in zip(runs[0], (*vec, *lin), tables, runs[1]):
        np.testing.assert_allclose(
            got[touched].cpu().numpy(), want[touched.cpu()].numpy(), rtol=1e-5, atol=1e-6
        )
        assert torch.equal(got[~touched], before[~touched])
        assert torch.equal(got, again)  # the same bits on every run


@pytest.mark.cuda
def test_training_kernels_check_their_inputs():
    dev = _card()
    b, f, c, k = 4, 3, 4, 2
    v = torch.zeros((b * f, c * k), device=dev)
    fields = torch.zeros((b, f), dtype=torch.int32, device=dev)
    x = torch.zeros((b, f), device=dev)
    per = [torch.zeros((b,), device=dev) for _ in range(3)]
    with pytest.raises(ValueError, match="dtype|is torch"):
        ffm_fused_logits_grads(v, fields.long(), x, *per, c, k)
    with pytest.raises(ValueError, match="aug_lane"):
        ffm_fused_logits_grads(v, fields, x, *per, c, k, aug_lane=c * k)
    tables, ids, gg2, _, p = _update_inputs(dev, 10, 8, 12, 3, 0)
    with pytest.raises(ValueError, match="shape"):
        ftrl_update(*tables, ids, gg2[:, :-1].contiguous(), 3, p)
    with pytest.raises(ValueError, match="dtype|is torch"):
        ftrl_update(*tables, ids.long(), gg2, 3, p)


@contextlib.contextmanager
def _ordered_sums():
    """Within: the plain versions' f32 row sums (ftrl.py::_segment_sums)
    add each row's payload rows one at a time in ascending payload order,
    the kernels' order (the card's index_add_ sums in no fixed order):
    step r adds every slot's r-th row, over the stably sorted slots, as
    ftrl.py already sums a bf16 payload."""
    import ftrl_ffm_tpu_torch.ftrl as tftrl

    saved = tftrl._segment_sums

    def ordered(n_out, slot, rows):
        if rows.dtype != torch.float32 or slot.numel() == 0:
            return saved(n_out, slot, rows)
        acc = torch.zeros((n_out, rows.shape[-1]), dtype=rows.dtype, device=rows.device)
        sslot, perm = torch.sort(slot, stable=True)
        pos = torch.arange(sslot.numel(), device=slot.device)
        starts = torch.ones_like(sslot, dtype=torch.bool)
        starts[1:] = sslot[1:] != sslot[:-1]
        rank = pos - torch.cummax(torch.where(starts, pos, 0), dim=0).values
        for r in range(int(rank.max()) + 1):
            at = rank == r
            dst = sslot[at]
            acc[dst] = acc[dst] + rows[perm[at]]
        return acc

    tftrl._segment_sums = ordered
    try:
        yield
    finally:
        tftrl._segment_sums = saved


def _offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """t's values `off` floats into a fresh buffer (off = 1: 4 bytes off
    16-byte alignment)."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    buf[off:] = t.reshape(-1)
    return buf[off:].view(t.shape)


def _hot_ids(ids: torch.Tensor, hot, seed: int) -> None:
    """With hot an id: that id in 60% of the payload rows (in place), a
    segment longer than the main kernels take (the column-split kernel's)."""
    from ftrl_ffm_tpu_torch.ops import _build

    if hot is None:
        return
    n = ids.shape[0]
    ids[torch.from_numpy(np.random.default_rng(seed).random(n) < 0.6).to(ids.device)] = hot
    assert int((ids == hot).sum()) > _build.lib().ftrl_update_hot_rows()


def _ran(counts: dict, before: dict) -> dict:
    return {k: v - before[k] for k, v in counts.items() if v != before[k]}


# (R, E, N, offset, hot id): za_scatter_rows (E > 32), za_scatter_narrow
# (E = 4, 8, 16, 32), the scalar form (E = 15; a table 4 bytes off 16-byte
# alignment), and one id in 60% of the payload rows (za_scatter_hot)
SCATTER = [
    (64, 640, 4000, 0, None), (20, 15, 300, 0, None), (300, 80, 10, 0, None),
    (7, 4, 1, 0, None), (64, 16, 4000, 0, None), (64, 4, 4000, 0, None), (64, 8, 4000, 0, None),
    (64, 32, 4000, 0, None), (97, 16, 3000, 1, None), (97, 640, 3000, 1, None),
    (64, 16, 3000, 0, 5), (64, 640, 2000, 0, 5), (64, 4, 3000, 0, 5), (64, 80, 3000, 0, 5),
    (64, 15, 3000, 0, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("r,e,n,offset,hot", SCATTER)
def test_za_scatter_kernel_matches_plain_and_repeats(r, e, n, offset, hot):
    """z += per-row sum of g, A = per-row sum of g^2: bit for bit the plain
    version on the same card tensors under ordered sums (each row's payload
    rows added in ascending payload order, one f32 add at a time, as every
    scatter kernel adds them), through the instance E and alignment pick;
    untouched z bit-identical, untouched A exactly 0, repeats
    bit-identical."""
    dev = _card()
    tables, ids, gg2, _, _ = _update_inputs(dev, r, e, n, 0, r * e + n)
    _hot_ids(ids, hot, n)
    z = tables[1]
    g, g2 = gg2[:, :e].contiguous(), gg2[:, e:].contiguous()
    instance = "scalar" if offset or e % 4 else "narrow" if e <= 32 else "rows"
    runs = []
    for _ in range(2):
        got_z, got_a = _offset(z, offset), _offset(torch.zeros_like(z), offset)
        before = za_scatter.launches
        by_instance = dict(za_scatter.launches_by_instance)
        za_scatter(got_z, got_a, ids, g, g2)
        torch.cuda.synchronize()
        assert za_scatter.launches == before + 1
        assert _ran(za_scatter.launches_by_instance, by_instance) == {instance: 1}
        runs.append((got_z, got_a))
    with _ordered_sums():
        want_z, want_a = za_scatter_plain(z, ids, g, g2)
    touched = torch.zeros(r, dtype=torch.bool, device=dev)
    touched[ids[ids < r].long()] = True
    assert torch.equal(runs[0][0][touched], want_z[touched])
    assert torch.equal(runs[0][1][touched], want_a[touched])
    assert torch.equal(runs[0][0][~touched], z[~touched])
    assert (runs[0][1][~touched] == 0).all()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# (E, linear lane, payload dtype, w dtype, hot id): FM's K=16 row and the
# other narrow widths, every dtype pair, with the linear stats in gg2_lin
# (lane -1) or in a dead lane, with and without a segment over 64 rows
NARROW = [
    (e, -1, pay, wdt, hot)
    for e in (4, 8, 16, 32)
    for pay in (torch.float32, torch.bfloat16)
    for wdt in (torch.float32, torch.bfloat16)
    for hot in (None, 5)
] + [(32, 7, torch.float32, torch.float32, None), (8, 3, torch.bfloat16, torch.float32, 5),
     (12, 2, torch.float32, torch.bfloat16, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,lane,pay,wdt,hot", NARROW)
def test_ftrl_update_kernel_narrow_matches_plain_and_repeats(e, lane, pay, wdt, hot):
    """Rows of at most 32 columns take ftrl_update_narrow (a group of lanes
    a segment, one quad a lane), its long segments ftrl_update_hot: bit for
    bit ftrl_update_plain on the same card tensors under ordered sums (f32
    sums and the bf16 accumulator in ascending payload order, the same
    correctly rounded closed form), all six tables; untouched rows and
    repeats bit-identical."""
    dev = _card()
    r, n = 300, 4000
    tables, ids, gg2, gg2_lin, p = _update_inputs(dev, r, e, n, lane, e + n + (hot or 0))
    _hot_ids(ids, hot, n + e)
    tables[2] = tables[2].to(wdt)
    gg2 = gg2.to(pay)
    runs = []
    for _ in range(2):
        got = [t.clone() for t in tables]
        by_instance = dict(ftrl_update.launches_by_instance)
        ftrl_update(*got, ids, gg2, lane, p, gg2_lin)
        torch.cuda.synchronize()
        assert _ran(ftrl_update.launches_by_instance, by_instance) == {"narrow": 1}
        runs.append(got)
    with _ordered_sums():
        vec, lin = ftrl_update_plain(*tables, ids, gg2, lane, p, gg2_lin)
    touched = torch.zeros(r, dtype=torch.bool, device=dev)
    touched[ids[ids < r].long()] = True
    for i, (got, want, before, again) in enumerate(zip(runs[0], (*vec, *lin), tables, runs[1])):
        assert got.dtype == want.dtype
        assert torch.equal(got[touched], want[touched]), i
        assert torch.equal(got[~touched], before[~touched]), i
        assert torch.equal(got, again), i


@pytest.mark.cuda
@pytest.mark.parametrize("r,hot", [(5000, None), (5000, 9), (50, 9), (1 << 16, None)])
def test_ftrl_update_linear_kernel_matches_plain_bit_for_bit(r, hot):
    """The update at E = 0 (LR's, and FM's in-place linear step): the
    "linear" instance, one lane a segment, and the column-split kernel for
    a segment over 64 rows: bit for bit the plain dense step on the same
    card tensors under ordered sums; untouched rows and repeats
    bit-identical."""
    from ftrl_ffm_tpu_torch.ftrl import dense_ftrl_update2
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update_linear

    dev = _card()
    n = 4000
    tables, ids, _, gg2_lin, p = _update_inputs(dev, r, 1, n, -1, r + n)
    _hot_ids(ids, hot, r)
    lin = tables[3:]
    runs = []
    for _ in range(2):
        got = [t.clone() for t in lin]
        by_instance = dict(ftrl_update.launches_by_instance)
        ftrl_update_linear(*got, ids, gg2_lin, p)
        torch.cuda.synchronize()
        assert _ran(ftrl_update.launches_by_instance, by_instance) == {"linear": 1}
        runs.append(got)
    with _ordered_sums():
        want = dense_ftrl_update2(*lin, ids, gg2_lin, p)
    touched = torch.zeros(r, dtype=torch.bool, device=dev)
    touched[ids[ids < r].long()] = True
    for got, ref, before, again in zip(runs[0], want, lin, runs[1]):
        assert torch.equal(got[touched], ref[touched])
        assert torch.equal(got[~touched], before[~touched])
        assert torch.equal(got, again)


# ---- the split payload (g and g^2 from two tensors: a (1, N) route
# mesh's received slots, parallel/sharded.py::_update_routed) ----


def _linear_only(tables):
    """The six tables with [R, 0] factor tables: the update at E = 0, the
    "linear" instance."""
    r = tables[3].shape[0]
    return [torch.empty((r, 0), device=tables[3].device) for _ in range(3)] + list(tables[3:])


# (instance, R, E, N, linear lane, w dtype, hot id): ftrl_update_kernel
# (E = 640, the dead lane or gg2_lin, a bf16 w, a segment over 64 rows),
# ftrl_update_narrow (FM's 16, 8 with a hot id), the "linear" instance
# (E = 0) and the scalar form (E = 15)
SPLIT = [
    ("rows", 64, 640, 4000, -1, torch.float32, None),
    ("rows", 64, 640, 4000, 39, torch.float32, None),
    ("rows", 300, 640, 3000, -1, torch.bfloat16, 5),
    ("narrow", 300, 16, 4000, -1, torch.float32, None),
    ("narrow", 300, 8, 4000, -1, torch.bfloat16, 5),
    ("linear", 5000, 0, 4000, -1, torch.float32, 9),
    ("scalar", 20, 15, 300, 4, torch.float32, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("instance,r,e,n,lane,wdt,hot", SPLIT,
                         ids=[f"{c[0]}-e{c[2]}-lane{c[4]}-{str(c[5])[6:]}-hot{c[6]}"
                              for c in SPLIT])
def test_ftrl_update_split_payload_matches_combined(instance, r, e, n, lane, wdt, hot):
    """The split payload (g and g^2 from two [N, E] tensors) through the
    kernels' split instances gives the same bits, on all six tables, as the
    combined launch of torch.cat([g, g2], -1), in the instance E and
    alignment pick; repeats bit-identical."""
    dev = _card()
    tables, ids, gg2, gg2_lin, p = _update_inputs(dev, r, max(e, 1), n, lane, r + e + n)
    _hot_ids(ids, hot, n + e)
    if e == 0:
        tables, gg2 = _linear_only(tables), gg2[:, :0].contiguous()
    tables[2] = tables[2].to(wdt)
    g, g2 = gg2[:, :e].contiguous(), gg2[:, e:].contiguous()
    outs = []
    for payload in (torch.cat([g, g2], dim=-1), (g, g2), (g, g2)):
        got = [t.clone() for t in tables]
        by_instance = dict(ftrl_update.launches_by_instance)
        ftrl_update(*got, ids, payload, lane, p, gg2_lin)
        torch.cuda.synchronize()
        assert _ran(ftrl_update.launches_by_instance, by_instance) == {instance: 1}
        outs.append(got)
    for i, (combined, split, again) in enumerate(zip(*outs)):
        assert torch.equal(split, combined), i
        assert torch.equal(split, again), i


@pytest.mark.cuda
@pytest.mark.parametrize("e", [640, 16, 0])
@pytest.mark.parametrize("empty", [1.0, 0.8])
def test_ftrl_update_empty_slots_leave_rows_unread(e, empty):
    """A route's empty slots (id == R, the received slots no peer filled)
    drop: with every slot empty the six tables keep every bit; with 80%
    empty the update equals the one of the filled slots alone, bit for
    bit, though the empty slots' payload holds NaN."""
    dev = _card()
    r, n = 300, 4000
    tables, ids, gg2, gg2_lin, p = _update_inputs(dev, r, max(e, 1), n, -1, e + n)
    if e == 0:
        tables, gg2 = _linear_only(tables), gg2[:, :0].contiguous()
    rng = np.random.default_rng(e)
    drop = torch.from_numpy(rng.random(n) < empty).to(dev)
    ids = torch.where(drop, r, ids).to(torch.int32)
    g, g2 = (torch.where(drop[:, None], float("nan"), x) for x in (gg2[:, :e], gg2[:, e:]))
    lin_pay = torch.where(drop[:, None], float("nan"), gg2_lin)
    got = [t.clone() for t in tables]
    ftrl_update(*got, ids, (g.contiguous(), g2.contiguous()), -1, p, lin_pay)
    keep = ~drop
    want = [t.clone() for t in tables]
    if keep.any():
        ftrl_update(*want, ids[keep].contiguous(), (g[keep].contiguous(), g2[keep].contiguous()),
                    -1, p, lin_pay[keep].contiguous())
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    if not keep.any():
        assert all(torch.equal(a, t) for a, t in zip(got, tables))


def _recv_slots(rng, r: int, m: int, k: int, fill: float) -> np.ndarray:
    """A route's received slots [M*K]: from each of M peers a block of K
    slots, its first ~fill*K holding distinct local rows (a peer sends each
    id once), the rest empty (r).  A row arrives from up to M peers."""
    slots = np.full(m * k, r, np.int32)
    for peer in range(m):
        u = int(rng.binomial(k, fill))
        slots[peer * k: peer * k + u] = rng.choice(r, u, replace=False)
    return slots


@pytest.mark.cuda
@pytest.mark.parametrize("e,lane,wdt", [(640, 39, torch.float32), (640, 39, torch.bfloat16),
                                        (16, -1, torch.float32)])
def test_routed_touched_update_matches_inplace_form(e, lane, wdt):
    """The routed update on a (1, N) mesh, the touched-rows launch on the
    received slots (M = 4 peers, ~80% of the slots empty, a row from up to
    4 peers), against the in-place form it replaces under auto (za_scatter
    into z and a zeroed A, kernel #3 over the table; the linear tables the
    same on [R, 1] views): touched rows within the in-place tests' bound,
    every other row bit for bit."""
    dev = _card()
    r, m, k = 2000, 4, 1000
    rng = np.random.default_rng(e)
    tables, _, _, _, p = _update_inputs(dev, r, e, 8, -1, e)
    tables[2] = tables[2].to(wdt)
    # w as the card's closed form leaves it (the CPU's sqrt is off by an
    # ulp on some inputs): kernel #3 with A = 0 then keeps every bit
    for tabs in (tables[:3], [t.view(-1, 1) for t in tables[3:]]):
        closed_form_pass(*tabs, torch.zeros_like(tabs[0]), p)
    ids = torch.from_numpy(_recv_slots(rng, r, m, k, 0.2)).to(dev)
    g = torch.from_numpy((rng.normal(size=(m * k, e)) * 0.2).astype(np.float32)).to(dev)
    g2 = g * g * torch.from_numpy(rng.integers(1, 3, (m * k, 1)).astype(np.float32)).to(dev)
    g_lin = g[:, max(lane, 0): max(lane, 0) + 1].contiguous()
    g2_lin = g2[:, max(lane, 0): max(lane, 0) + 1].contiguous()
    touched_form = [t.clone() for t in tables]
    ftrl_update(*touched_form, ids, (g, g2), -1, p, torch.cat([g_lin, g2_lin], dim=-1))
    inplace_form = [t.clone() for t in tables]
    ftrl_update_inplace(*inplace_form[:3], ids, g, g2, p)
    ftrl_update_inplace(*(t.view(-1, 1) for t in inplace_form[3:]), ids, g_lin, g2_lin, p)
    torch.cuda.synchronize()
    touched = torch.zeros(r, dtype=torch.bool, device=dev)
    touched[ids[ids < r].long()] = True
    assert 0 < int(touched.sum()) < r
    for i, (got, want, before) in enumerate(zip(touched_form, inplace_form, tables)):
        np.testing.assert_allclose(got[touched].float().cpu().numpy(),
                                   want[touched].float().cpu().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=str(i))
        assert torch.equal(got[~touched], want[~touched]), i
        assert torch.equal(got[~touched], before[~touched]), i


@pytest.mark.cuda
def test_ftrl_update_split_payload_checks_its_inputs():
    dev = _card()
    tables, ids, gg2, _, p = _update_inputs(dev, 10, 8, 12, 3, 0)
    g, g2 = gg2[:, :8].contiguous(), gg2[:, 8:].contiguous()
    with pytest.raises(ValueError, match="shape"):
        ftrl_update(*tables, ids, (g, g2[:, :-1].contiguous()), 3, p)
    with pytest.raises(ValueError, match="dtype|is torch"):
        ftrl_update(*tables, ids, (g, g2.to(torch.bfloat16)), 3, p)
    with pytest.raises(ValueError, match="contiguous"):
        ftrl_update(*tables, ids, (g, gg2[:, 8:]), 3, p)


# (R, E): odd sizes, a row width not a multiple of 4, and one float4 tail
@pytest.mark.cuda
@pytest.mark.parametrize("r,e,offset", [(41, 6, 0), (333, 15, 0), (64, 640, 0), (97, 128, 1),
                                        (4099, 16, 0)])
def test_closed_form_pass_kernel_matches_plain(r, e, offset):
    """The pass against its plain version at odd R and E (offset 1: tables
    not 16-byte aligned, the scalar loop); coordinates with A = 0 keep their
    n and z bits and get the closed form of them."""
    dev = _card()
    rng = np.random.default_rng(r + e)
    p = FtrlParams(alpha=0.05, l1=0.15, l2=1.0)
    n_tab, z_tab, w_tab = (
        t.to(dev) for t in _update_inputs(torch.device("cpu"), r, e, 1, 0, r)[0][:3]
    )
    a = torch.from_numpy((rng.random((r, e)) * 0.5).astype(np.float32)).to(dev)
    a[torch.from_numpy(rng.random((r, e)) < 0.4).to(dev)] = 0.0

    def padded(t):  # the same values `offset` floats into a fresh buffer
        buf = torch.empty(t.numel() + offset, device=dev)
        buf[offset:] = t.reshape(-1)
        return buf[offset:].view(r, e)

    runs = []
    for _ in range(2):
        got = [padded(t) for t in (n_tab, z_tab, w_tab)]
        before = closed_form_pass.launches
        closed_form_pass(*got, padded(a), p)
        torch.cuda.synchronize()
        assert closed_form_pass.launches == before + 1
        runs.append(got)
    want = closed_form_pass_plain(n_tab, z_tab, w_tab, a, p)
    for got, ref in zip(runs[0], want):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-6, atol=1e-7)
    zero = a == 0
    assert torch.equal(runs[0][0][zero], n_tab[zero])
    assert torch.equal(runs[0][1][zero], z_tab[zero])
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.cuda
def test_inplace_train_step_is_bit_deterministic():
    """update_mode=inplace on the card: the split kernel #2, the scatter and
    the pass each launch once a step; two runs from one state give the same
    bits, and they stay within the chained bound of the CPU's plain run."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.models import make_model
    from ftrl_ffm_tpu_torch.models.base import Batch

    dev = _card()
    kw = dict(model_type="FFM", n_fields=7, n_factors=16, n_feats=60, batch_size=16,
              max_nnz=6, w_alpha=0.05, w_l1=0.15, w_l2=1.0, update_mode="inplace")
    model = make_model(Config(device="cuda", **kw))
    cpu_model = make_model(Config(device="cpu", **kw))
    init = cpu_model.init()
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        feats = rng.integers(0, 60, (16, 6)).astype(np.int32)
        feats[:, -1] = 60
        vals = (rng.random((16, 6)) + 0.05).astype(np.float32)
        vals[:, -1] = 0.0
        batches.append(Batch(
            torch.from_numpy(rng.integers(0, 7, (16, 6)).astype(np.int32)),
            torch.from_numpy(feats), torch.from_numpy(vals),
            torch.from_numpy((rng.random(16) > 0.5).astype(np.float32)),
            torch.ones(16),
        ))
    states = []
    for _ in range(2):
        st = type(init)(*(t.to(dev) for t in init))
        counts = [f.launches for f in (ffm_fused_logits_grads, za_scatter, closed_form_pass)]
        for b in batches:
            model.train_step(st, Batch(*(None if t is None else t.to(dev) for t in b)))
        torch.cuda.synchronize()
        after = [f.launches for f in (ffm_fused_logits_grads, za_scatter, closed_form_pass)]
        assert [y - x for x, y in zip(counts, after)] == [3, 3, 3]
        states.append(st)
    for a, b in zip(*states):
        assert torch.equal(a, b)
    plain = type(init)(*(t.clone() for t in init))
    for b in batches:
        cpu_model.train_step(plain, b)
    for name in ("vec_n", "vec_z", "vec_w", "bias_z"):
        np.testing.assert_allclose(
            getattr(states[0], name).cpu().numpy(), getattr(plain, name).numpy(),
            rtol=2e-3, atol=5e-5, err_msg=name,
        )
    assert (states[0].lin_z == 0).all()  # rides stale: the mirror lane holds it


@pytest.mark.cuda
def test_inplace_wrappers_check_their_inputs():
    dev = _card()
    r, e, n = 10, 8, 12
    p = FtrlParams()
    tabs = [torch.zeros((r, e), device=dev) for _ in range(4)]
    ids = torch.zeros((n,), dtype=torch.int32, device=dev)
    g = torch.zeros((n, e), device=dev)
    with pytest.raises(ValueError, match="dtype|is torch"):
        za_scatter(tabs[1], tabs[3], ids.long(), g, g)
    with pytest.raises(ValueError, match="shape"):
        za_scatter(tabs[1], tabs[3], ids, g[:, :-1].contiguous(), g)
    with pytest.raises(ValueError, match="on cpu|on cuda"):
        za_scatter(tabs[1], tabs[3], ids.cpu(), g, g)
    with pytest.raises(ValueError, match="dtype|is torch"):
        closed_form_pass(tabs[0], tabs[1], tabs[2], tabs[3].double(), p)
    with pytest.raises(ValueError, match="shape"):
        closed_form_pass(tabs[0], tabs[1], tabs[2], tabs[3][:-1], p)
    with pytest.raises(ValueError, match="on cpu|on cuda"):
        closed_form_pass(tabs[0], tabs[1].cpu(), tabs[2], tabs[3], p)
    with pytest.raises(ValueError, match="contiguous"):
        closed_form_pass(*(t.t().contiguous().t() for t in tabs), p)
    with pytest.raises(ValueError, match="shape"):
        ftrl_update_inplace(*tabs[:3], ids, g, g[:-1], p)


# ---- the bf16 forms: kernel #2's bf16 store, the update kernel's bf16
# payload and w, kernel #3's bf16 w ----


def within_bf16_ulp(got: torch.Tensor, want: torch.Tensor, atol: float = 0.0) -> bool:
    """Each element within one bf16 ulp of the larger magnitude of the
    two, plus atol (values near 0 whose f32 forms differ by up to atol)."""
    a, b = got.float(), want.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), 0.0)
    return bool(((a - b).abs() <= ulp + atol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,c,k,real,aug", FUSED)
def test_ffm_fused_kernel_bf16_matches_plain(b, f, c, k, real, aug):
    """The bf16 store of the general instance (and, for the Criteo rows, of
    the C'=40 one) against the plain version: logits rtol=1e-4, atol=1e-5,
    payload within one bf16 ulp; counted under its instance's "_bf16" name;
    two launches give the same bits."""
    dev = _card()
    rng = np.random.default_rng(b * f + c + 3)
    v = (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32)
    fields = rng.integers(0, real, (b, f)).astype(np.int32)
    fields[:, 0] = c + 3
    vals = rng.random((b, f)).astype(np.float32)
    vals[:, -1] = 0.0
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    sw[-1] = 0.0
    args = [torch.from_numpy(a).to(dev) for a in (v, fields, vals, lin, y, sw)]
    counts = ffm_fused_logits_grads.launches_by_instance
    before = dict(counts)
    got = [ffm_fused_logits_grads(*args, c, k, aug_lane=aug, out_dtype=torch.bfloat16)
           for _ in range(2)]
    torch.cuda.synchronize()
    grew = {n for n in counts if counts[n] != before[n]}
    assert len(grew) == 1 and grew.pop().endswith("_bf16")
    logits, gg2 = got[0]
    assert gg2.dtype == torch.bfloat16 and gg2.shape == (b * f, 2 * c * k)
    ref_logits, ref_gg2 = ffm_fused_logits_grads_plain(*args, c, k, aug_lane=aug,
                                                       out_dtype=torch.bfloat16)
    np.testing.assert_allclose(logits.cpu().numpy(), ref_logits.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    assert within_bf16_ulp(gg2, ref_gg2, 1e-6)
    assert all(torch.equal(x, y) for x, y in zip(*got))
    with pytest.raises(ValueError, match="combined"):
        ffm_fused_logits_grads(*args, c, k, aug_lane=aug, combined_out=False,
                               out_dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("aug", [-1, 39])
@pytest.mark.parametrize("f", [39, 40, 13])
@pytest.mark.parametrize("b", [1, 33, 256])
def test_ffm_fused_c40_instance_bf16_matches_plain(b, f, aug):
    """The C'=40, K=16 instance's bf16 store (8-byte streaming stores) on
    spec_fused_inputs: launched as c40_k16_bf16, payload within one bf16
    ulp of the plain version, and each value the f32 instance's value
    rounded to bf16 (g^2 from the f32 g)."""
    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in spec_fused_inputs(b, f, b + f + aug + 1)]
    counts = ffm_fused_logits_grads.launches_by_instance
    before = dict(counts)
    logits, gg2 = ffm_fused_logits_grads(*args, 40, 16, aug_lane=aug, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert counts["c40_k16_bf16"] == before["c40_k16_bf16"] + 1
    assert counts["c40_k16"] == before["c40_k16"]
    want = ffm_fused_logits_grads_plain(*args, 40, 16, aug_lane=aug, out_dtype=torch.bfloat16)
    np.testing.assert_allclose(logits.cpu().numpy(), want[0].cpu().numpy(), rtol=1e-4, atol=1e-5)
    assert within_bf16_ulp(gg2, want[1], 1e-6)
    f32_logits, f32_gg2 = ffm_fused_logits_grads(*args, 40, 16, aug_lane=aug)
    assert torch.equal(f32_logits, logits)
    assert torch.equal(f32_gg2.to(torch.bfloat16), gg2)


# (R, E, N, lane, payload dtype, w dtype): every pair of dtypes, the bench's
# aug lane, no lane, E not a multiple of 32
UPDATE_BF16 = [
    (64, 640, 4000, 39, torch.bfloat16, torch.bfloat16),
    (64, 640, 4000, 39, torch.bfloat16, torch.float32),
    (64, 640, 4000, 39, torch.float32, torch.bfloat16),
    (64, 128, 4000, -1, torch.bfloat16, torch.bfloat16),
    (20, 15, 300, 4, torch.bfloat16, torch.float32),
    (300, 80, 10, 7, torch.float32, torch.bfloat16),
    # FM's K=16 row with a bf16 table (its payload stays f32)
    (64, 16, 4000, -1, torch.float32, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("r,e,n,lane,pay,wdt", UPDATE_BF16)
def test_ftrl_update_kernel_bf16_matches_plain_and_repeats(r, e, n, lane, pay, wdt):
    """The update kernel on a bf16 payload and/or a bf16 w against its
    plain version.  A bf16 payload: bit for bit on the touched rows, against
    the plain version on the same card tensors (the same bf16 accumulator,
    rounded after every add in payload order, whose rank loop is
    deterministic on the card too, and the closed form's operations each
    rounded on their own; the CPU's torch.sqrt is not correctly rounded, the
    card's is), the linear tables too where the payload's lane carries them.
    An f32 payload: against CPU copies, whose index_add_ sums in the
    kernel's order: n, z and the linear tables rtol=1e-5, atol=1e-6, a bf16
    w within one bf16 ulp; so are the linear tables of a bf16 payload with
    lane = -1, summed from the f32 gg2_lin (the card's index_add_ sums in
    no fixed order).  Untouched rows and repeats bit-identical."""
    dev = _card()
    tables, ids, gg2, gg2_lin, p = _update_inputs(dev, r, e, n, lane, r + e + n + 1)
    tables[2] = tables[2].to(wdt)
    gg2 = gg2.to(pay)
    runs = []
    for _ in range(2):
        got = [t.clone() for t in tables]
        before = ftrl_update.launches
        ftrl_update(*got, ids, gg2, lane, p, gg2_lin)
        torch.cuda.synchronize()
        assert ftrl_update.launches == before + 1
        runs.append(got)
    on = (lambda t: t) if pay == torch.bfloat16 else (lambda t: None if t is None else t.cpu())
    vec, lin = ftrl_update_plain(*map(on, tables), on(ids), on(gg2), lane, p, on(gg2_lin))
    touched = torch.zeros(r, dtype=torch.bool, device=dev)
    touched[ids[ids < r].long()] = True
    for i, (got, want, before, again) in enumerate(zip(runs[0], (*vec, *lin), tables, runs[1])):
        assert got.dtype == want.dtype == before.dtype
        g_t, w_t = got[touched].cpu(), want[touched.to(want.device)].cpu()
        if pay == torch.bfloat16 and (i < 3 or lane >= 0):
            assert torch.equal(g_t, w_t), i
        elif i == 2 and wdt == torch.bfloat16:
            assert within_bf16_ulp(g_t, w_t, 1e-6), i
        else:
            np.testing.assert_allclose(g_t.float().numpy(), w_t.float().numpy(),
                                       rtol=1e-5, atol=1e-6)
        assert torch.equal(got[~touched], before[~touched])
        assert torch.equal(got, again)


# (R, E, N, lane, payload dtype, w dtype): rows with one hot id (60% of the
# payload rows, ~1,200-1,800: far above the 64 rows one warp sums), the
# rest spread; E a whole number of 32-column slices and not (80), the
# bench's row, with and without a dead lane
UPDATE_HOT = [
    (64, 640, 2000, 39, torch.float32, torch.float32),
    (64, 640, 2000, 39, torch.bfloat16, torch.bfloat16),
    (64, 80, 3000, 7, torch.bfloat16, torch.float32),
    (64, 80, 3000, 7, torch.float32, torch.bfloat16),
    (64, 128, 3000, -1, torch.float32, torch.float32),
    (64, 128, 3000, -1, torch.bfloat16, torch.bfloat16),
    # FM's K=16 row, f32 and bf16 w: half of one 32-column slice
    (64, 16, 3000, -1, torch.float32, torch.float32),
    (64, 16, 3000, -1, torch.float32, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("r,e,n,lane,pay,wdt", UPDATE_HOT)
def test_ftrl_update_kernel_column_split_matches_plain_and_repeats(r, e, n, lane, pay, wdt):
    """An id in most payload rows takes the column-split kernel: against the
    plain version as test_ftrl_update_kernel_bf16_matches_plain_and_repeats
    holds it (a bf16 payload bit for bit on the same card tensors; an f32
    payload rtol=1e-5, atol=1e-6 against CPU copies, a bf16 w within one
    bf16 ulp); untouched rows and repeats bit-identical."""
    dev = _card()
    from ftrl_ffm_tpu_torch.ops import _build

    tables, ids, gg2, gg2_lin, p = _update_inputs(dev, r, e, n, lane, r + e + n + 2)
    hot = np.random.default_rng(n).random(n) < 0.6
    ids[torch.from_numpy(hot).to(dev)] = 5
    assert int((ids == 5).sum()) > _build.lib().ftrl_update_hot_rows()
    tables[2] = tables[2].to(wdt)
    gg2 = gg2.to(pay)
    runs = []
    for _ in range(2):
        got = [t.clone() for t in tables]
        ftrl_update(*got, ids, gg2, lane, p, gg2_lin)
        torch.cuda.synchronize()
        runs.append(got)
    on = (lambda t: t) if pay == torch.bfloat16 else (lambda t: None if t is None else t.cpu())
    vec, lin = ftrl_update_plain(*map(on, tables), on(ids), on(gg2), lane, p, on(gg2_lin))
    touched = torch.zeros(r, dtype=torch.bool, device=dev)
    touched[ids[ids < r].long()] = True
    for i, (got, want, before, again) in enumerate(zip(runs[0], (*vec, *lin), tables, runs[1])):
        g_t, w_t = got[touched].cpu(), want[touched.to(want.device)].cpu()
        if pay == torch.bfloat16 and (i < 3 or lane >= 0):
            assert torch.equal(g_t, w_t), i
        elif i == 2 and wdt == torch.bfloat16:
            assert within_bf16_ulp(g_t, w_t, 1e-6), i
        else:
            np.testing.assert_allclose(g_t.float().numpy(), w_t.float().numpy(),
                                       rtol=1e-5, atol=1e-6)
        assert torch.equal(got[~touched], before[~touched])
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_ftrl_update_linear_column_split_matches_plain():
    """The linear-only update (E = 0) with an id in most payload rows: its
    gg2_lin pairs summed in the column-split kernel, against the plain
    dense step on CPU copies (index_add_ in payload order): rtol=1e-5,
    atol=1e-6; repeats bit-identical."""
    from ftrl_ffm_tpu_torch.ftrl import dense_ftrl_update2
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update_linear

    dev = _card()
    rng = np.random.default_rng(11)
    r, n = 50, 4000
    p = FtrlParams(alpha=0.05, l1=0.15, l2=1.0)
    lin = _update_inputs(torch.device("cpu"), r, 1, 1, 0, 5)[0][3:]
    ids = rng.integers(0, r - 3, n).astype(np.int32)
    ids[rng.random(n) < 0.7] = 9
    ids[rng.random(n) < 0.05] = r
    gl = (rng.normal(size=n) * 0.2).astype(np.float32)
    gg2_lin = torch.from_numpy(np.stack([gl, gl * gl], -1))
    runs = []
    for _ in range(2):
        got = [t.clone().to(dev) for t in lin]
        ftrl_update_linear(*got, torch.from_numpy(ids).to(dev), gg2_lin.to(dev), p)
        torch.cuda.synchronize()
        runs.append(got)
    want = dense_ftrl_update2(*lin, torch.from_numpy(ids), gg2_lin, p)
    for got, ref, again in zip(runs[0], want, runs[1]):
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_ftrl_update_linear_matches_plain():
    """LR's whole update (E = 0: the update kernel on the linear tables
    alone) on uniform ids with duplicates and the sentinel, against the
    plain step on CPU copies: rtol=1e-5, atol=1e-6; rows no id touches
    bit-identical; repeats bit-identical."""
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update_linear

    dev = _card()
    r, n = 5000, 4000
    tables, ids, _, gg2_lin, p = _update_inputs(dev, r, 1, n, -1, 17)
    lin = tables[3:]
    runs = []
    for _ in range(2):
        got = [t.clone() for t in lin]
        before = ftrl_update.launches
        ftrl_update_linear(*got, ids, gg2_lin, p)
        torch.cuda.synchronize()
        assert ftrl_update.launches == before + 1
        runs.append(got)
    want = [t.clone().cpu() for t in lin]
    ftrl_update_linear(*want, ids.cpu(), gg2_lin.cpu(), p)
    touched = torch.zeros(r, dtype=torch.bool, device=dev)
    touched[ids[ids < r].long()] = True
    for got, ref, before, again in zip(runs[0], want, lin, runs[1]):
        np.testing.assert_allclose(got[touched].cpu().numpy(), ref[touched.cpu()].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(got[~touched], before[~touched])
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,kw,kind", [
    ("LR", {"update_mode": "dense"}, "dense2"),
    ("LR", {"update_mode": "sparse"}, "sparse2"),
    ("FM", {"update_mode": "dense"}, "dense2"),
    ("FM", {"update_mode": "sparse"}, "sparse2"),
    ("FM", {"update_mode": "inplace"}, "inplace"),
    ("FM", {"update_mode": "dense", "table_dtype": "bfloat16", "acc_dtype": "bfloat16"},
     "dense2"),
    ("FM", {"update_mode": "inplace", "table_dtype": "bfloat16"}, "inplace"),
])
def test_lr_fm_train_steps_launch_and_repeat(model_type, kw, kind):
    """LR and FM train_step on the card: LR launches the update kernel on
    its linear tables alone each step; FM the update kernel with the
    linear stats in gg2_lin ("dense2", "sparse2"; an f32 payload, also
    under acc_dtype=bfloat16) or the scatter, the pass and the linear
    update ("inplace"); neither launches kernel #1 or #2.  Two runs from
    one state give the same bits, within the chained bound of the CPU's
    plain run (a bf16 w within one bf16 ulp, rtol 2^-7)."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.models import make_model
    from ftrl_ffm_tpu_torch.models.base import Batch

    dev = _card()
    cfg = dict(model_type=model_type, n_fields=7, n_factors=16, n_feats=60, batch_size=16,
               max_nnz=6, w_alpha=0.05, w_l1=0.15, w_l2=1.0, **kw)
    model = make_model(Config(device="cuda", **cfg))
    cpu_model = make_model(Config(device="cpu", **cfg))
    init = cpu_model.init()
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(3):
        feats = rng.integers(0, 60, (16, 6)).astype(np.int32)
        feats[:, -1] = 60
        vals = (rng.random((16, 6)) + 0.05).astype(np.float32)
        vals[:, -1] = 0.0
        batches.append(Batch(
            torch.from_numpy(rng.integers(0, 7, (16, 6)).astype(np.int32)),
            torch.from_numpy(feats), torch.from_numpy(vals),
            torch.from_numpy((rng.random(16) > 0.5).astype(np.float32)),
            torch.ones(16),
        ))
    fns = (ftrl_update, za_scatter, closed_form_pass, ffm_fused_logits_grads, ffm_fused_logits)
    expect = [3, 3, 3, 0, 0] if kind == "inplace" else [3, 0, 0, 0, 0]
    w_dt = "bf16" if "table_dtype" in kw else "f32"
    states = []
    for _ in range(2):
        st = type(init)(*(None if t is None else t.to(dev) for t in init))
        counts = [f.launches for f in fns]
        by_dtype = dict(ftrl_update.launches_by_dtype)
        for b in batches:
            model.train_step(st, Batch(*(None if t is None else t.to(dev) for t in b)))
        torch.cuda.synchronize()
        assert [f.launches - c for f, c in zip(fns, counts)] == expect
        # the payload is f32 in every kind; the linear-only update's
        # instance is the f32 one
        upd = "f32/f32" if model_type == "LR" or kind == "inplace" else f"f32/{w_dt}"
        assert ftrl_update.launches_by_dtype[upd] == by_dtype[upd] + 3
        states.append(st)
    for a, b in zip(*states):
        assert (a is None and b is None) or torch.equal(a, b)
    plain = type(init)(*(None if t is None else t.clone() for t in init))
    for b in batches:
        cpu_model.train_step(plain, b)
    for name in ("lin_n", "lin_z", "lin_w", "bias_z", "vec_n", "vec_z", "vec_w"):
        got, want = getattr(states[0], name), getattr(plain, name)
        if want is None:
            assert got is None and model_type == "LR"
            continue
        bf16 = want.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                                   rtol=2.0 ** -7 if bf16 else 2e-3, atol=5e-5, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,c,k,real", SHAPES)
def test_ffm_logits_kernel_bf16_rows_match_plain(b, f, c, k, real):
    """bf16 rows on the shapes of test_ffm_logits_kernel_matches_plain:
    against the plain version (rtol=1e-4, atol=1e-5), counted under the
    same instance as the f32 rows' launch with "_bf16" added, and bit for
    bit the f32 launch on the rows they widen to."""
    dev = _card()
    rng = np.random.default_rng(b * f + c + 5)
    v = (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32)
    fields = rng.integers(0, real, (b, f)).astype(np.int32)
    fields[:, 0] = c + 3
    vals = rng.random((b, f)).astype(np.float32)
    vals[:, -1] = 0.0
    vals[-1] = 0.0
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    vh, *rest = [torch.from_numpy(a).to(dev) for a in (v, fields, vals, lin)]
    vh = vh.to(torch.bfloat16)
    counts = ffm_fused_logits.launches_by_instance
    before = dict(counts)
    wide = ffm_fused_logits(vh.float(), *rest, c, k)
    mid = dict(counts)
    got = ffm_fused_logits(vh, *rest, c, k)
    torch.cuda.synchronize()
    (name,) = [n for n in counts if mid[n] > before[n]]
    assert {n: counts[n] - mid[n] for n in counts} == {n: int(n == name + "_bf16") for n in counts}
    assert torch.equal(got, wide)
    want = ffm_fused_logits_plain(vh, *rest, c, k)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [39, 40, 13])
@pytest.mark.parametrize("b", [1, 33, 256, 1000])
def test_ffm_logits_c40_instance_matches_plain(b, f, dtype):
    """Kernel #1's C'=40, K=16 instance (a persistent grid: B=1000 walks
    several samples a block) on spec_fused_inputs' shuffled, repeated,
    out-of-range and padding fields: against the plain version (rtol=1e-4,
    atol=1e-5), launched as c40_k16 (bf16 rows: c40_k16_bf16, bit for bit
    the f32 rows they widen to), and the same call twice gives the same
    bits."""
    dev = _card()
    v, fields, vals, lin = [torch.from_numpy(a).to(dev)
                            for a in spec_fused_inputs(b, f, 3 * b + f)[:4]]
    v = v.to(dtype)
    counts = ffm_fused_logits.launches_by_instance
    name = "c40_k16" if dtype == torch.float32 else "c40_k16_bf16"
    before = dict(counts)
    got = [ffm_fused_logits(v, fields, vals, lin, 40, 16) for _ in range(2)]
    torch.cuda.synchronize()
    assert {n: counts[n] - before[n] for n in counts} == {n: 2 * (n == name) for n in counts}
    assert torch.equal(got[0], got[1])
    want = ffm_fused_logits_plain(v, fields, vals, lin, 40, 16)
    np.testing.assert_allclose(got[0].cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)
    if dtype == torch.bfloat16:
        assert torch.equal(got[0], ffm_fused_logits(v.float(), fields, vals, lin, 40, 16))


@pytest.mark.cuda
def test_ffm_logits_instance_follows_the_shape():
    """C'=40, K=16, F <= 40 with 16-byte aligned rows runs the C'=40
    instance; F=64, C'=8, K=8 or rows 4 bytes off alignment the general
    one, F=100 the general one on rows in device memory; each launch counts
    once, under its instance."""
    dev = _card()
    counts = ffm_fused_logits.launches_by_instance
    # (B, F, C', K, offset, instance)
    for b, f, c, k, off, name in ((64, 39, 40, 16, 0, "c40_k16"), (17, 64, 40, 16, 0, "general"),
                                  (16, 7, 8, 16, 0, "general"), (16, 10, 40, 8, 0, "general"),
                                  (64, 39, 40, 16, 1, "general"),
                                  (9, 100, 40, 16, 0, "general_device_memory")):
        rng = np.random.default_rng(f + off)
        buf = torch.from_numpy(
            (rng.normal(size=b * f * c * k + off) * 0.1).astype(np.float32)).to(dev)
        v = buf[off:].view(b * f, c * k)
        fields = torch.from_numpy(rng.integers(0, c, (b, f)).astype(np.int32)).to(dev)
        vals = torch.from_numpy(rng.random((b, f)).astype(np.float32)).to(dev)
        lin = torch.zeros(b, device=dev)
        before, total = dict(counts), ffm_fused_logits.launches
        got = ffm_fused_logits(v, fields, vals, lin, c, k)
        torch.cuda.synchronize()
        assert ffm_fused_logits.launches == total + 1
        assert {n: counts[n] - before[n] for n in counts} == {
            n: int(n == name) for n in counts
        }, (b, f, c, k, off)
        want = ffm_fused_logits_plain(v, fields, vals, lin, c, k)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("r,e,offset", [(41, 6, 0), (333, 15, 0), (64, 640, 0), (97, 128, 1),
                                        (1001, 1, 0), (4099, 16, 0)])
def test_closed_form_pass_kernel_bf16_w_matches_plain(r, e, offset):
    """Kernel #3 with a bf16 w against its plain version on the same card
    tensors, bit for bit (offset 1: n, z and A off 16-byte alignment, the
    scalar loop); coordinates with A = 0 keep their n and z bits, and a
    touched one its w bits; repeats bit-identical."""
    dev = _card()
    rng = np.random.default_rng(r + e + 1)
    p = FtrlParams(alpha=0.05, l1=0.15, l2=1.0)
    n_tab, z_tab, w_tab = (
        t.to(dev) for t in _update_inputs(torch.device("cpu"), r, e, 1, 0, r + 1)[0][:3]
    )
    w_tab = w_tab.to(torch.bfloat16)
    a = torch.from_numpy((rng.random((r, e)) * 0.5).astype(np.float32)).to(dev)
    a[torch.from_numpy(rng.random((r, e)) < 0.4).to(dev)] = 0.0

    def padded(t):  # the same values `offset` elements into a fresh buffer
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
        buf[offset:] = t.reshape(-1)
        return buf[offset:].view(r, e)

    runs = []
    for _ in range(2):
        got = [padded(t) for t in (n_tab, z_tab, w_tab)]
        before = closed_form_pass.launches
        closed_form_pass(*got, padded(a), p)
        torch.cuda.synchronize()
        assert closed_form_pass.launches == before + 1
        runs.append(got)
    want = closed_form_pass_plain(n_tab, z_tab, w_tab, a, p)
    assert runs[0][2].dtype == want[2].dtype == torch.bfloat16
    for got, ref in zip(runs[0], want):
        assert torch.equal(got, ref)
    zero = a == 0
    assert torch.equal(runs[0][0][zero], n_tab[zero])
    assert torch.equal(runs[0][1][zero], z_tab[zero])
    kept = zero & (n_tab > UNTOUCHED_N)
    assert torch.equal(runs[0][2][kept], w_tab[kept])
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kind", [
    ({"n_feats": 60, "update_mode": "dense", "acc_dtype": "bfloat16"}, "dense2"),
    ({"n_feats": 60, "update_mode": "inplace"}, "inplace"),
    ({"n_feats": 60, "update_mode": "sparse", "acc_dtype": "bfloat16"}, "sparse2"),
])
def test_bf16_train_steps_launch_and_repeat(kw, kind):
    """train_step with a bf16 table on the card: each kind launches its
    kernels (kernel #2's bf16 store on "dense2" with acc_dtype=bfloat16,
    its f32 split store and kernel #3 on "inplace" plus the separate
    linear update, which a bf16 table needs); two runs from one state give
    the same bits, within the chained bound of the CPU's plain run (vec_w
    within one bf16 ulp, rtol 2^-7)."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.models import make_model
    from ftrl_ffm_tpu_torch.models.base import Batch

    dev = _card()
    cfg = dict(model_type="FFM", n_fields=7, n_factors=16, batch_size=16, max_nnz=6,
               w_alpha=0.05, w_l1=0.15, w_l2=1.0, table_dtype="bfloat16", **kw)
    model = make_model(Config(device="cuda", **cfg))
    cpu_model = make_model(Config(device="cpu", **cfg))
    init = cpu_model.init()
    assert init.vec_w.dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        feats = rng.integers(0, 60, (16, 6)).astype(np.int32)
        feats[:, -1] = 60
        vals = (rng.random((16, 6)) + 0.05).astype(np.float32)
        vals[:, -1] = 0.0
        batches.append(Batch(
            torch.from_numpy(rng.integers(0, 7, (16, 6)).astype(np.int32)),
            torch.from_numpy(feats), torch.from_numpy(vals),
            torch.from_numpy((rng.random(16) > 0.5).astype(np.float32)),
            torch.ones(16),
        ))
    fns = (ffm_fused_logits_grads, ftrl_update, za_scatter, closed_form_pass)
    expect = {"dense2": [3, 3, 0, 0], "sparse2": [3, 3, 0, 0], "inplace": [3, 3, 3, 3]}[kind]
    # 7 fields pad to C'=8: the general instance; a bf16 payload on "dense2"
    instance = "general_bf16" if kind == "dense2" else "general"
    states = []
    for _ in range(2):
        st = type(init)(*(t.to(dev) for t in init))
        counts = [f.launches for f in fns]
        by_inst = dict(ffm_fused_logits_grads.launches_by_instance)
        for b in batches:
            model.train_step(st, Batch(*(None if t is None else t.to(dev) for t in b)))
        torch.cuda.synchronize()
        assert [f.launches - c for f, c in zip(fns, counts)] == expect
        assert ffm_fused_logits_grads.launches_by_instance[instance] == by_inst[instance] + 3
        states.append(st)
    for a, b in zip(*states):
        assert torch.equal(a, b)
    plain = type(init)(*(t.clone() for t in init))
    for b in batches:
        cpu_model.train_step(plain, b)
    for name in ("vec_n", "vec_z", "lin_n", "lin_z", "bias_z"):
        np.testing.assert_allclose(
            getattr(states[0], name).cpu().numpy(), getattr(plain, name).numpy(),
            rtol=2e-3, atol=5e-5, err_msg=name,
        )
    assert states[0].vec_w.dtype == torch.bfloat16
    np.testing.assert_allclose(states[0].vec_w.float().cpu().numpy(), plain.vec_w.float().numpy(),
                               rtol=2.0 ** -7, atol=5e-5)



# ---- the probe kernels of ftrl_ffm_tpu_torch/tools (csrc/micro_*.cu) ----


@pytest.mark.cuda
@pytest.mark.parametrize("r,e,offset", [(41, 15, 0), (333, 640, 0), (1001, 1, 0), (97, 128, 1)])
def test_micro_pass3_kernel_matches_plain(r, e, offset):
    """The no-w pass against its plain version at odd R and E (offset 1:
    tables not 16-byte aligned, the scalar loop): rtol=1e-6, atol=1e-7, and
    the same call twice gives the same bits."""
    from ftrl_ffm_tpu_torch.tools.micro_lazy import pass3, pass3_plain

    dev = _card()
    rng = np.random.default_rng(r * e + offset)
    n_tab = torch.from_numpy((rng.random((r, e)) * 3).astype(np.float32))
    n_tab[torch.from_numpy(rng.random((r, e)) < 0.3)] = 0.0
    z_tab = torch.from_numpy(rng.normal(size=(r, e)).astype(np.float32))
    a = torch.from_numpy((rng.random((r, e)) * 0.5).astype(np.float32))
    a[torch.from_numpy(rng.random((r, e)) < 0.4)] = 0.0

    def padded(t):  # the same values `offset` floats into a fresh buffer
        buf = torch.empty(t.numel() + offset, device=dev)
        buf[offset:] = t.reshape(-1).to(dev)
        return buf[offset:].view(r, e)

    runs = []
    for _ in range(2):
        got = [padded(n_tab), padded(z_tab)]
        before = pass3.launches
        pass3(*got, padded(a))
        torch.cuda.synchronize()
        assert pass3.launches == before + 1
        runs.append(got)
    want = pass3_plain(n_tab.to(dev), z_tab.to(dev), a.to(dev))
    for got, ref in zip(runs[0], want):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-6, atol=1e-7)
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("b,notr,pad", [(1, False, True), (33, False, True), (256, False, False),
                                        (33, True, True)])
def test_micro_canon_kernel_matches_plain_and_kernel2(b, notr, pad):
    """The canonical-fields kernel against its plain version and (with the
    field crossing) against kernel #2 on iota fields: logits rtol=1e-4,
    atol=1e-5, payload rtol=1e-4, atol=1e-6."""
    from ftrl_ffm_tpu_torch.tools.micro_canon_kernel import AUG_LANE, CP, K, canon, canon_plain

    dev = _card()
    rng = np.random.default_rng(b)
    v = torch.from_numpy((rng.normal(size=(b * CP, CP * K)) * 0.1).astype(np.float32)).to(dev)
    vals = torch.from_numpy(rng.random((b, CP)).astype(np.float32)).to(dev)
    if pad:
        vals[:, AUG_LANE:] = 0.0
    lin = torch.from_numpy((rng.normal(size=b) * 0.1).astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.random(b) > 0.5).astype(np.float32)).to(dev)
    sw = torch.ones(b, device=dev)
    sw[-1] = 0.0 if b > 1 else 1.0
    before = canon.launches
    logits, gg2 = canon(v, vals, lin, y, sw, notr=notr)
    torch.cuda.synchronize()
    assert canon.launches == before + 1
    refs = [canon_plain(v, vals, lin, y, sw, notr=notr)]
    if not notr:
        fields = torch.arange(CP, dtype=torch.int32, device=dev).repeat(b, 1)
        refs.append(ffm_fused_logits_grads(v, fields, vals, lin, y, sw, CP, K, aug_lane=AUG_LANE))
    for ref_logits, ref_gg2 in refs:
        np.testing.assert_allclose(logits.cpu().numpy(), ref_logits.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gg2.cpu().numpy(), ref_gg2.cpu().numpy(),
                                   rtol=1e-4, atol=1e-6)


# (N, PER, E): the probe's field shape cut down, every id one row (PER=1)
# at E=1, and odd sizes
RMW_SHAPES = [(512, 20, 640), (1000, 1, 1), (130, 333, 37)]


def _rmw_inputs(n, per, e, dtype, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, per, n).astype(np.int32)
    idx[1::2][::3] = idx[0::2][::3]  # duplicate pairs for dual
    pay = torch.from_numpy(rng.normal(size=(n, e)).astype(np.float32)).to(dtype)
    return torch.from_numpy(idx), pay


@pytest.mark.cuda
@pytest.mark.parametrize("n,per,e", RMW_SHAPES)
@pytest.mark.parametrize("variant", ["base", "unroll8", "dual", "wo", "rd"])
def test_micro_rmw_kernel_matches_plain(variant, n, per, e):
    """Every variant, f32 payload: bit for bit the plain version on CPU
    copies (which adds in payload order, as the kernel does), and the same
    call twice gives the same bits."""
    from ftrl_ffm_tpu_torch.tools.micro_vmem_rmw2 import per_pad, rmw_plain, run_kernel

    dev = _card()
    idx, pay = _rmw_inputs(n, per, e, torch.float32, n + per + e)
    rows = per_pad(per)
    before = run_kernel.launches
    got = [run_kernel(idx.to(dev), pay.to(dev), variant, rows) for _ in range(2)]
    torch.cuda.synchronize()
    assert run_kernel.launches == before + 2
    want = rmw_plain(idx, pay, variant, rows)
    assert torch.equal(got[0].cpu(), want)
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,per,e", RMW_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_micro_rmw_entry_matches_plain(dtype, n, per, e):
    """micro_vmem_rmw.py's entry (the base variant, no dump row), f32 and
    bf16 payloads: bit for bit the plain version on CPU copies."""
    from ftrl_ffm_tpu_torch.tools.micro_vmem_rmw import rmw
    from ftrl_ffm_tpu_torch.tools.micro_vmem_rmw2 import rmw_plain

    dev = _card()
    idx, pay = _rmw_inputs(n, per, e, dtype, n * per + e)
    rows = -(-per // 8) * 8
    before = rmw.launches
    got = rmw(idx.to(dev), pay.to(dev), rows)
    torch.cuda.synchronize()
    assert rmw.launches == before + 1
    assert torch.equal(got.cpu(), rmw_plain(idx, pay, "base", rows))


# (label, N, PER, E): ids that bin unevenly across csrc/micro_rmw.cu's row
# classes, ids outside [0, rows), no ids, N off the kernel's chunk and warp
# sizes, an odd width and the probe's default shape
RMW_EDGES = [
    ("one_class", 2048, 2564, 640),
    ("one_row", 1000, 2564, 640),
    ("outside", 1030, 333, 640),
    ("no_ids", 0, 333, 640),
    ("ragged_n", 4102, 2564, 128),
    ("e37", 512, 100, 37),
    ("probe_default", 8192, 2564, 640),
]


def _rmw_edge_inputs(label, n, per, e, dtype):
    rows = -(-per // 8) * 8 + 8  # micro_vmem_rmw2.per_pad
    rng = np.random.default_rng(n + per + e)
    if label == "one_class":  # every id a multiple of 256: one class for any RB
        idx = rng.integers(0, per // 256, n) * 256
    elif label == "one_row":
        idx = np.full(n, 5)
    elif label == "outside":
        idx = rng.integers(-5, rows + 10, n)
    else:
        idx = rng.integers(0, per, n)
    idx = idx.astype(np.int32)
    idx[1::2][::3] = idx[0::2][::3]  # duplicate pairs for dual
    pay = torch.from_numpy(rng.normal(size=(n, e)).astype(np.float32)).to(dtype)
    return torch.from_numpy(idx), pay, rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["base", "unroll8", "dual", "wo", "rd"])
@pytest.mark.parametrize("label,n,per,e", RMW_EDGES)
def test_micro_rmw_kernel_edge_ids_match_plain(label, n, per, e, variant, dtype):
    """Every variant and payload dtype on ids that bin unevenly: bit for
    bit the plain version on CPU copies, the same call twice the same
    bits."""
    from ftrl_ffm_tpu_torch.tools.micro_vmem_rmw2 import rmw_plain, run_kernel

    dev = _card()
    idx, pay, rows = _rmw_edge_inputs(label, n, per, e, dtype)
    before = run_kernel.launches
    got = [run_kernel(idx.to(dev), pay.to(dev), variant, rows) for _ in range(2)]
    torch.cuda.synchronize()
    assert run_kernel.launches == before + 2
    assert torch.equal(got[0].cpu(), rmw_plain(idx, pay, variant, rows))
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,e2,dtype", [(4096, 5000, 1280, torch.float32),
                                          (512, 777, 1, torch.float32),
                                          (777, 1000, 37, torch.bfloat16),
                                          (0, 10, 8, torch.float32)])
def test_micro_gather_kernel_matches_plain(n, m, e2, dtype):
    """The gathered sum against its plain version: max |diff| within 1e-5
    of the largest |sum| (f32 sums in another order), rows 1-7 zero, the
    same call twice the same bits."""
    from ftrl_ffm_tpu_torch.tools.micro_dma_gather import dma_gather_sum, dma_gather_sum_plain

    dev = _card()
    rng = np.random.default_rng(n + e2)
    perm = torch.from_numpy(rng.integers(0, m, n).astype(np.int32)).to(dev)
    pay = torch.from_numpy(rng.normal(size=(m, e2)).astype(np.float32)).to(dtype).to(dev)
    before = dma_gather_sum.launches
    got = [dma_gather_sum(perm, pay) for _ in range(2)]
    torch.cuda.synchronize()
    assert dma_gather_sum.launches == before + 2
    want = dma_gather_sum_plain(perm, pay)
    scale = max(float(want[0].abs().max()) if n else 0.0, 1e-30)
    assert float((got[0] - want).abs().max()) <= 1e-5 * scale
    assert (got[0][1:] == 0).all()
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
def test_probe_wrappers_check_their_inputs(monkeypatch):
    """A CUDA tensor with a wrong shape or dtype raises, and the plain
    version never runs in its place."""
    from ftrl_ffm_tpu_torch.tools import micro_canon_kernel as mc
    from ftrl_ffm_tpu_torch.tools import micro_dma_gather as mg
    from ftrl_ffm_tpu_torch.tools import micro_lazy as ml
    from ftrl_ffm_tpu_torch.tools import micro_vmem_rmw as mr
    from ftrl_ffm_tpu_torch.tools import micro_vmem_rmw2 as mr2

    def never(*args, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    for mod, name in ((ml, "pass3_plain"), (mc, "canon_plain"), (mr, "rmw_plain"),
                      (mr2, "rmw_plain"), (mg, "dma_gather_sum_plain")):
        monkeypatch.setattr(mod, name, never)
    dev = _card()
    t = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device=dev)  # noqa: E731
    with pytest.raises(ValueError, match="shape"):
        ml.pass3(t(4, 8), t(4, 8), t(4, 7))
    with pytest.raises(ValueError, match="dtype|is torch"):
        ml.pass3(t(4, 8), t(4, 8, dtype=torch.float64), t(4, 8))
    cp, e = mc.CP, mc.E
    with pytest.raises(ValueError, match="shape"):
        mc.canon(t(3 * cp, e), t(2, cp), t(2), t(2), t(2))
    with pytest.raises(ValueError, match="dtype|is torch"):
        mc.canon(t(2 * cp, e), t(2, cp, dtype=torch.float64), t(2), t(2), t(2))
    with pytest.raises(ValueError, match="shape"):
        mc.canon(t(2 * cp, e - 1), t(2, cp), t(2), t(2), t(2))
    with pytest.raises(ValueError, match="shape"):
        mc.canon(t(2 * 4, 8), t(2, 4), t(2), t(2), t(2))
    idx = t(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        mr2.run_kernel(idx, t(5, 8), "base", 8)
    with pytest.raises(ValueError, match="dtype|is torch"):
        mr2.run_kernel(idx.long(), t(6, 8), "base", 8)
    with pytest.raises(ValueError, match="f32 or bf16"):
        mr.rmw(idx, t(6, 8, dtype=torch.float16), 8)
    with pytest.raises(ValueError, match="dual"):
        mr2.run_kernel(idx[:5], t(5, 8), "dual", 16)
    with pytest.raises(ValueError, match="variant"):
        mr2.run_kernel(idx, t(6, 8), "triple", 8)
    with pytest.raises(ValueError, match="dtype|is torch"):
        mg.dma_gather_sum(idx.long(), t(6, 8))
    with pytest.raises(ValueError, match="f32 or bf16"):
        mg.dma_gather_sum(idx, t(6, 8, dtype=torch.float64))


# ---- the device-resident dataset (Config.device_cache) ----


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"online": True},
    {"online": False},
    {"online": True, "device_cache_compact": "on"},
    {"online": True, "update_mode": "inplace"},
    {"online": True, "table_dtype": "bfloat16", "acc_dtype": "bfloat16"},
    {"online": False, "auc_mode": "exact"},
])
def test_device_cache_matches_streamed_bit_for_bit(tmp_path, kw):
    """A resident run on the card (device_cache=on: file-order replay
    online, the shuffled replay offline, compact storage, the in-place
    update, bf16 tables) and a streamed twin (device_cache=off) from one
    init: the same histories and the same table bits, through the kernels."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import Trainer

    dev = _card()
    rng = np.random.default_rng(8)
    paths = []
    for name, n in (("train", 100), ("eval", 37)):
        path = tmp_path / f"{name}.ffm"
        with open(path, "w") as f:
            for _ in range(n):
                toks = [str(int(rng.random() > 0.5))] + [
                    f"{c}:{int(rng.integers(0, 60))}:{rng.integers(1, 10**6) / 10**6:.6f}"
                    for c in rng.permutation(7) if rng.random() < 0.9]
                f.write(" ".join(toks) + "\n")
        paths.append(str(path))
    base = dict(train_data=paths[0], eval_data=paths[1], model_type="FFM", n_fields=7,
                n_factors=16, n_feats=60, batch_size=16, n_epochs=2, w_alpha=0.05, w_l1=0.15,
                w_l2=1.0, device="cuda", **kw)
    on = Trainer(Config(**base, device_cache="on"))
    off = Trainer(Config(**base, device_cache="off"),
                  state=type(on.state)(*(t.clone() for t in on.state)))
    launches = ffm_fused_logits_grads.launches
    h_on = on.train()
    assert ffm_fused_logits_grads.launches - launches == 2 * 7  # 100 rows at B=16
    h_off = off.train()
    assert on._dev_cache["train"] is not None and on._dev_cache["eval"] is not None
    assert on._dev_cache["train"].compact == (kw.get("device_cache_compact") == "on")
    assert "train" not in off._dev_cache
    assert h_on == h_off
    for a, b in zip(on.logical_state, off.logical_state):
        assert a.device.type == dev.type and torch.equal(a, b)


# ---- checkpoints (io/checkpoint.py, Trainer._save_mid_checkpoint) ----


def _ffm_file(path, n, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 60))}:1" for c in range(7)]
            f.write(" ".join(toks) + "\n")
    return str(path)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["LR", "FM", "FFM"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_card_checkpoint_roundtrip_bit_for_bit(tmp_path, monkeypatch, model_type, table_dtype):
    """A state on the card, written slab by slab through the pinned staging
    buffer (CHUNK_BYTES cut so that every table takes several slabs), loads
    back bit for bit."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.io import checkpoint as ck
    from ftrl_ffm_tpu_torch.models import make_model

    dev = _card()
    cfg = Config(model_type=model_type, n_fields=7, n_factors=16, n_feats=1000,
                 table_dtype=table_dtype, device="cuda")
    state = make_model(cfg).init()
    gen = torch.Generator(device=dev).manual_seed(3)
    for t in state:
        if t is not None and t.dim():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev).to(t.dtype))
    state.step.fill_(9)
    monkeypatch.setattr(ck, "CHUNK_BYTES", 4096)
    path = str(tmp_path / "c.ckpt")
    stats = ck.save_checkpoint(path, state, extra={"model_config": ck.model_signature(cfg)})
    assert stats["pull_s"] > 0 and stats["file_bytes"] == (tmp_path / "c.ckpt").stat().st_size
    back = ck.state_from_jax_arrays(ck.load_checkpoint(path)[0], dev)
    for a, b in zip(state, back):
        assert (a is None and b is None) or (b.device == a.device and torch.equal(a, b))


@pytest.mark.cuda
def test_card_snapshot_paths_write_the_same_file(tmp_path, monkeypatch):
    """save_every through the device copy (async), the host copy
    (async, the copy made not to fit) and the synchronous save: the same
    arrays at the same mid_training_step."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint
    from ftrl_ffm_tpu_torch.train import Trainer

    _card()
    data = _ffm_file(tmp_path / "t.ffm", 100, 1)
    base = dict(train_data=data, model_type="FFM", n_fields=7, n_factors=16, n_feats=60,
                batch_size=16, n_epochs=1, save_every=3, w_alpha=0.05, device="cuda")
    runs = {}
    for how, asyn in (("device_copy", True), ("inline", True), ("sync", False)):
        tr = Trainer(Config(**base, model_path=str(tmp_path / f"{how}.ckpt"),
                            async_checkpoint=asyn))
        if how == "inline":
            monkeypatch.setattr(tr, "_snapshot_copy_fits", lambda state: False)
        tr.train_epoch()
        assert [r["snapshot"] for r in tr.checkpoint_log] == [how] * 2
        runs[how] = load_checkpoint(str(tmp_path / f"{how}.ckpt"))
    ref_state, ref_extra = runs["sync"]
    assert ref_extra["mid_training_step"] == 6
    for how in ("device_copy", "inline"):
        state, extra = runs[how]
        assert extra["mid_training_step"] == 6
        for a, b in zip(state, ref_state):
            if a is None:
                assert b is None
            else:
                a, b = (x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) else x
                        for x in (a, b))
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("fits", [True, False])
def test_card_step_after_async_save_keeps_the_snapshot(tmp_path, monkeypatch, fits):
    """Steps taken right after an async save, while the writer may still be
    pulling, update the tables in place: the file holds the state as it was
    at the save."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint
    from ftrl_ffm_tpu_torch.train import Trainer

    _card()
    data = _ffm_file(tmp_path / "t.ffm", 64, 2)
    path = str(tmp_path / "a.ckpt")
    tr = Trainer(Config(train_data=data, model_type="FFM", n_fields=7, n_factors=16,
                        n_feats=200_000, batch_size=16, model_path=path, w_alpha=0.05,
                        device="cuda", device_cache="off"))
    monkeypatch.setattr(tr, "_snapshot_copy_fits", lambda state: fits)
    tr.train_epoch()
    before = [None if t is None else t.clone() for t in tr.logical_state]
    tr._save_mid_checkpoint(tr._steps_done)
    batches = [tr._place_batch(a) for a in tr._train_batches(np.random.default_rng(0))]
    for b in batches:
        tr.model.train_step(tr.state, b)
    tr._join_pending_checkpoint()
    assert not torch.equal(tr.state.vec_z, before[6])
    state, _ = load_checkpoint(path)
    for a, b in zip(state, before):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


@pytest.mark.cuda
def test_card_write_failure_raises_at_join(tmp_path):
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import Trainer

    _card()
    data = _ffm_file(tmp_path / "t.ffm", 64, 3)
    tr = Trainer(Config(train_data=data, model_type="FFM", n_fields=7, n_factors=16,
                        n_feats=60, batch_size=16, save_every=2, model_path=str(tmp_path),
                        device="cuda"))
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        tr.train_epoch()


# ---- steps_per_call > 1: CUDA-graph groups (train.py::_run_group) ----


def _graph_files(tmp_path):
    """100 train and 37 eval rows over 7 fields (field_pad 8 at K=16): at
    B=16, 7 train steps (3 groups of 3, the last with 2 inert steps) and 3
    eval batches (1 group) a pass."""
    rng = np.random.default_rng(9)
    paths = []
    for name, n in (("train", 100), ("eval", 37)):
        path = tmp_path / f"{name}.ffm"
        with open(path, "w") as f:
            for _ in range(n):
                toks = [str(int(rng.random() > 0.5))] + [
                    f"{c}:{int(rng.integers(0, 60))}:{rng.integers(1, 10**6) / 10**6:.6f}"
                    for c in range(7) if rng.random() < 0.9]
                f.write(" ".join(toks) + "\n")
        paths.append(str(path))
    return dict(train_data=paths[0], eval_data=paths[1], model_type="FFM", n_fields=7,
                n_factors=16, n_feats=60, batch_size=16, n_epochs=2, w_alpha=0.05, w_l1=0.15,
                w_l2=1.0, device="cuda")


def _counted():
    return {fn.__name__: fn.launches for fn in (
        ffm_fused_logits, ffm_fused_logits_grads, ftrl_update, za_scatter, closed_form_pass)}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"device_cache": "on"},
    {"device_cache": "on", "online": False},
    {"device_cache": "off"},
    {"device_cache": "off", "feed_workers": 2},
    {"device_cache": "on", "update_mode": "inplace"},
    {"device_cache": "on", "table_dtype": "bfloat16", "acc_dtype": "bfloat16"},
    {"device_cache": "on", "model_type": "LR"},
    {"device_cache": "on", "model_type": "FM"},
    {"device_cache": "off", "model_type": "FM", "update_mode": "inplace"},
], ids=["resident", "shuffled", "streamed", "streamed-2-workers", "inplace", "bf16", "lr",
        "fm", "fm-inplace-streamed"])
def test_graph_groups_match_eager_bit_for_bit(tmp_path, kw):
    """steps_per_call=3 on the card (the first group of each kind eager,
    then one capture, then replays) against the eager S=1 run from one
    init: histories and tables bit for bit, and the launches counted
    across the replays: ceil(7/3)*3 = 9 train steps an epoch, 3 eval
    batches a pass."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import Trainer

    _card()
    base = {**_graph_files(tmp_path), **kw}
    one = Trainer(Config(**base))
    grouped = Trainer(Config(**base, steps_per_call=3),
                      state=type(one.state)(*(None if t is None else t.clone()
                                              for t in one.state)))
    h1 = one.train()
    before = _counted()
    h3 = grouped.train()
    after = _counted()
    launched = {k: after[k] - before[k] for k in after}
    assert h1 == h3
    for a, b in zip(one.logical_state, grouped.logical_state):
        assert (a is None and b is None) or torch.equal(a, b)
    assert grouped.group_dispatch == {"eager": 2, "captures": 2, "replays": 5 + 1}
    model, inplace = base["model_type"], kw.get("update_mode") == "inplace"
    if model == "FFM":
        assert launched["ffm_fused_logits_grads"] == 18 and launched["ffm_fused_logits"] == 6
    if inplace:
        assert launched["za_scatter"] == launched["closed_form_pass"] == 18
    assert launched["ftrl_update"] == (0 if inplace and model == "FFM" else 18)


@pytest.mark.cuda
def test_graph_recaptures_after_a_state_swap(tmp_path):
    """A captured group keys on the state's tensors: a swapped state
    (init_from_weights) runs its next group eagerly and captures again
    (the old state's graph dropped), and the epoch equals an eager S=1
    epoch from the same weights; the update kernel's launches count 9 an
    epoch through eager, captured and replayed groups alike."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import Trainer

    dev = _card()
    base = {**_graph_files(tmp_path), "eval_data": "", "device_cache": "on"}
    tr = Trainer(Config(**base, steps_per_call=3))
    for want in ({"eager": 1, "captures": 1, "replays": 2},
                 {"eager": 1, "captures": 1, "replays": 5}):
        n0 = ftrl_update.launches
        tr.train_epoch()
        assert ftrl_update.launches - n0 == 9 and tr.group_dispatch == want
    (key,) = tr._graphs["train"]
    tr.state = tr.model.init_from_weights(*tr.model.materialize_weights(tr.logical_state),
                                          device=dev)
    twin = Trainer(Config(**base), state=type(tr.state)(*(t.clone() for t in tr.state)))
    n0 = ftrl_update.launches
    loss = tr.train_epoch()
    assert ftrl_update.launches - n0 == 9
    assert tr.group_dispatch == {"eager": 2, "captures": 2, "replays": 7}
    assert list(tr._graphs["train"]) != [key] and len(tr._graphs["train"]) == 1
    assert loss == twin.train_epoch()
    for a, b in zip(tr.state, twin.state):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_failed_capture_raises(tmp_path):
    """A group whose capture fails (here a host sync inside it) raises
    where its key's first group, run eagerly, is captured: no group falls
    back to eager steps."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import Trainer

    dev = _card()
    tr = Trainer(Config(**{**_graph_files(tmp_path), "steps_per_call": 2}))

    def syncs(x):
        y = x * 2
        float(y.sum())  # a readback: not allowed while capturing
        return (y,)

    x = torch.ones(4, device=dev)
    with pytest.raises(RuntimeError):
        tr._run_group("probe", syncs, (x,))
    assert tr.group_dispatch == {"eager": 1, "captures": 0, "replays": 0}
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cli_steps_per_call_on_the_card(tmp_path, capsys):
    """`python -m ftrl_ffm_tpu_torch --steps_per_call 4` trains and
    evaluates on the card (streamed through the feeder, then resident)
    and prints the S=1 run's epoch lines."""
    from ftrl_ffm_tpu_torch.cli import main

    _card()
    cfg = _graph_files(tmp_path)
    argv = ["--train_data", cfg["train_data"], "--eval_data", cfg["eval_data"],
            "--model_type", "FFM", "--n_fields", "7", "--n_feats", "60", "--n_factors", "16",
            "--batch_size", "16", "--n_epochs", "2", "--feed_workers", "2"]
    lines = []
    for extra in ([], ["--steps_per_call", "4"], ["--device_cache", "off"],
                  ["--device_cache", "off", "--steps_per_call", "4"]):
        assert main(argv + extra) == 0
        out = capsys.readouterr().out
        lines.append([ln.split("s, ", 1)[1] for ln in out.splitlines() if ln.startswith("epoch")])
    assert len(lines[0]) == 4 and all(ln == lines[0] for ln in lines)


# ---- meshes (parallel/): one process a card, NCCL ----


def _launches_by_instance():
    from ftrl_ffm_tpu_torch.tools import read_launch_counts

    c = read_launch_counts()
    return {k: c[k] for k in ("fused_by_instance", "logits_by_instance", "update_by_instance",
                              "scatter_by_instance", "pass_by_dtype")}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"device_cache": "on"},
    {"device_cache": "off"},
    {"device_cache": "on", "update_mode": "inplace"},
    {"device_cache": "on", "table_dtype": "bfloat16"},
    {"device_cache": "on", "model_type": "FM"},
    {"device_cache": "on", "model_type": "LR"},
], ids=["resident", "streamed", "inplace", "bf16", "fm", "lr"])
def test_world_size_one_nccl_mesh_matches_one_card(tmp_path, kw):
    """--mesh_data 0 in one process: the sharded step over a world-size-1
    NCCL group, against the one-card Trainer from the same init: the
    histories and the logical tables bit for bit, and the kernels launched
    by the same instances the same number of times (the in-place form's
    linear tables ride stale on the mirror lane in both)."""
    import torch.distributed as tdist

    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.parallel import dist
    from ftrl_ffm_tpu_torch.tools import reset_launch_counts
    from ftrl_ffm_tpu_torch.train import Trainer

    _card()
    base = {**_graph_files(tmp_path), **kw}
    one = Trainer(Config(**base))
    mesh = Trainer(Config(**base, mesh_data=0),
                   state=type(one.state)(*(None if t is None else t.clone() for t in one.state)))
    assert tdist.get_backend() == "nccl" and dist.world() == (0, 1)
    assert mesh._mesh.shape == {"data": 1, "model": 1}
    reset_launch_counts()
    h1 = one.train()
    want = _launches_by_instance()
    reset_launch_counts()
    dist.counts.update(dict.fromkeys(dist.counts, 0))
    h2 = mesh.train()
    assert _launches_by_instance() == want
    assert dist.counts["all_reduce"] > 0 and dist.counts["all_to_all"] == 0
    assert h1 == h2
    for a, b in zip(one.logical_state, mesh.logical_state):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"device_cache": "on"},
    {"device_cache": "on", "online": False},
    {"device_cache": "off"},
], ids=["resident", "shuffled", "streamed"])
def test_world_size_one_nccl_mesh_groups_capture_the_collectives(tmp_path, kw):
    """steps_per_call=3 on a world-size-1 NCCL mesh: after the first group
    of each kind, the groups are CUDA graphs that hold the steps' NCCL
    all_reduce; against S=1 on the same mesh from the same init, the
    histories and tables bit for bit, and the collectives and launches
    counted per replay: 9 train steps an epoch (7 and 2 inert) and 3 eval
    batches a pass, one all_reduce each."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.parallel import dist
    from ftrl_ffm_tpu_torch.tools import reset_launch_counts
    from ftrl_ffm_tpu_torch.train import Trainer

    _card()
    base = {**_graph_files(tmp_path), **kw, "mesh_data": 0}
    one = Trainer(Config(**base))
    grouped = Trainer(Config(**base, steps_per_call=3), state=one.logical_state)
    runs = []
    for tr in (one, grouped):
        reset_launch_counts()
        dist.counts.update(dict.fromkeys(dist.counts, 0))
        runs.append((tr.train(), _launches_by_instance(), dict(dist.counts)))
    (h1, l1, c1), (h3, l3, c3) = runs
    assert h1 == h3
    for a, b in zip(one.logical_state, grouped.logical_state):
        assert (a is None and b is None) or torch.equal(a, b)
    assert grouped.group_dispatch == {"eager": 2, "captures": 2, "replays": 5 + 1}
    # (a streamed pass all-gathers its step count once a role)
    assert c1["all_reduce"] == 2 * 7 + 2 * 3 and c3["all_reduce"] == 2 * 9 + 2 * 3
    assert c1["all_gather"] == c3["all_gather"] and c1["all_to_all"] == c3["all_to_all"] == 0
    assert sum(l1["fused_by_instance"].values()) == 14
    assert sum(l3["fused_by_instance"].values()) == 18
    assert sum(l3["logits_by_instance"].values()) == sum(l1["logits_by_instance"].values()) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_flags", [["--mesh_data", "0"],
                                        ["--mesh_model", "2", "--lookup_mode", "route"]],
                         ids=["replicate", "route"])
def test_n_rank_nccl_mesh_matches_one_card(tmp_path, mesh_flags):
    """Two NCCL ranks, one card each, through the CLI's three flags, on a
    file of one global batch a step: the epoch lines the one-card run's
    (a flip of the last printed digit at most) and the saved tables within
    the suite's chained-step bound."""
    import os
    import socket
    import subprocess
    import sys

    from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint

    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("the N-rank NCCL mesh needs more than one card")
    rng = np.random.default_rng(3)
    data = tmp_path / "d.ffm"
    with open(data, "w") as f:
        for _ in range(256):
            f.write(" ".join([str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(10, 60)):02d}:1" for c in range(7)]) + "\n")
    flags = ["--train_data", str(data), "--eval_data", str(data), "--model_type", "FFM",
             "--n_fields", "7", "--n_feats", "60", "--n_factors", "16", "--batch_size", "256",
             "--n_epochs", "2", "--device_cache", "on", "--device_cache_layout", "replicate"]
    one = str(tmp_path / "one.ckpt")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "ftrl_ffm_tpu_torch", *flags, "--model_path", one],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    mesh = str(tmp_path / "mesh.ckpt")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ftrl_ffm_tpu_torch", *flags, *mesh_flags, "--model_path", mesh,
         "--coordinator_address", coord, "--num_processes", "2", "--process_id", str(p)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for p in range(2)]
    logs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    lines = [[ln.split("s, ", 1)[1] for ln in text.splitlines() if ln.startswith("epoch")]
             for text in (out.stdout, logs[0][0])]
    assert len(lines[1]) == 4
    for a, b in zip(*lines):
        for x, y in zip(a.split(", "), b.split(", ")):
            assert abs(float(x.split(": ")[1]) - float(y.split(": ")[1])) <= 1.01e-4
    a, b = load_checkpoint(one)[0], load_checkpoint(mesh)[0]
    for name in ("lin_z", "lin_n", "vec_z", "vec_n"):
        np.testing.assert_allclose(getattr(b, name), getattr(a, name), rtol=2e-3, atol=5e-5)


# ---- the transfer tiers (transfer.py, models/base.py::widen_batch) ----


def _tier_files(tmp_path, n_feats, ids, fields, vals):
    """96 train and 40 eval rows over 7 fields: ids per-field clustered or
    spread over the table, fields in slot order or shuffled, values ones,
    6-decimal or random; the eval file's last batch padded."""
    rng = np.random.default_rng(3)
    paths = []
    for name, n in (("train", 96), ("eval", 40)):
        path = tmp_path / f"{name}.ffm"
        with open(path, "w") as f:
            for _ in range(n):
                order = rng.permutation(7) if fields == "shuffled" else range(7)
                toks = [str(int(rng.random() > 0.5))]
                for c in order:
                    block = n_feats // 7
                    feat = (int(rng.integers(0, n_feats)) if ids == "spread"
                            else c * block + int(rng.integers(0, min(block, 50))))
                    v = {"ones": "1", "dec6": f"{int(rng.integers(0, 10**6)) / 1e6:.6f}",
                         "f32": f"{rng.random() * 3:.9f}"}[vals]
                    toks.append(f"{c}:{feat}:{v}")
                f.write(" ".join(toks) + "\n")
        paths.append(str(path))
    return dict(train_data=paths[0], eval_data=paths[1], model_type="FFM", n_fields=7,
                n_factors=16, n_feats=n_feats, batch_size=16, n_epochs=2, w_alpha=0.05,
                w_l1=0.15, w_l2=1.0, device_cache="off", device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (60, "clustered", "canonical", "ones"),
    (100_000, "spread", "canonical", "f32"),
    (1 << 20, "spread", "shuffled", "dec6"),
    (60, "clustered", "shuffled", "dec6"),
], ids=["delta-markers", "split-100k", "split-2^20-packed-dec6", "packed-dec6"])
def test_tiers_on_the_card_give_the_untiered_bits(tmp_path, shape):
    """Streamed training with eval and predict_file on the card, the tiers
    on against off, and S=4 against S=1 (tiers on): histories, tables and
    prediction bytes bit for bit; each upload decodes on the card to the
    CPU decode's bits; the DEC6 probe passes on the card."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.models.base import Batch, widen_batch
    from ftrl_ffm_tpu_torch.train import Trainer

    _card()
    kw = _tier_files(tmp_path, *shape)
    runs = []
    for over in ({}, {"compact_transfer": False}, {"steps_per_call": 4}):
        tr = Trainer(Config(**kw, **over))
        ups = []
        compact = tr._compact
        tr._compact = lambda a, role="train", c=compact, u=ups: u.append(c(a, role)) or u[-1]
        hist = tr.train()
        out = tmp_path / f"p{len(runs)}.txt"
        tr.predict_file(kw["eval_data"], str(out))
        runs.append((hist, tr.logical_state, out.read_bytes(), ups, tr))
    (h, st, p, ups, tr), *others = runs
    for h2, st2, p2, _, _ in others:
        assert h2 == h and p2 == p
        for a, b in zip(st, st2):
            assert (a is None and b is None) or torch.equal(a, b)
    assert tr._dec6_device_ok()
    for up in ups:
        host = [None if a is None else (a if isinstance(a, torch.Tensor) else torch.from_numpy(a))
                for a in up]
        on_card = widen_batch(Batch(*(None if t is None else t.cuda() for t in host)))
        on_cpu = widen_batch(Batch(*host))
        for g, w in zip(on_card[:5], on_cpu[:5]):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_streamed_groups_capture_nothing_after_the_first_epoch(tmp_path):
    """S=4 streamed with the tiers on: the full groups (all-ones marker,
    iota fields) and the padded last one (int8 values) are two keys, both
    captured in epoch 1 into the role's one memory pool; epoch 2 replays
    them all."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import Trainer

    def pools():
        return {tuple(seg["segment_pool_id"]) for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)}

    _card()
    kw = _tier_files(tmp_path, 60, "clustered", "canonical", "ones")
    tr = Trainer(Config(**{**kw, "eval_data": ""}, steps_per_call=4))
    before = pools()
    tr.train_epoch()
    # 96 rows at B=16: 6 steps, groups of 4 and of 2 (+2 inert)
    assert tr.group_dispatch == {"eager": 2, "captures": 2, "replays": 0}
    assert len(tr._graphs["train"]) == 2
    assert pools() - before == {tuple(tr._graph_pools["train"])}
    tr.train_epoch()
    assert tr.group_dispatch == {"eager": 2, "captures": 2, "replays": 2}
