"""The port's copied host data path (data/ and native/) against the JAX
package's, on the shared fixture: identical arrays, batch for batch."""

import numpy as np
import pytest

from ftrl_ffm_tpu.data import loader as jloader
from ftrl_ffm_tpu.data import parser as jparser
from ftrl_ffm_tpu.data.stream import StreamReader as JStream
from ftrl_ffm_tpu_torch.data import loader as tloader
from ftrl_ffm_tpu_torch.data import parser as tparser
from ftrl_ffm_tpu_torch.data.stream import StreamReader as TStream
from tests.common import FIXTURE_FEATS, FIXTURE_FIELDS, write_fixture


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("file_type", ["libffm", "libsvm"])
@pytest.mark.parametrize("use_native", [True, False])
def test_parse_text_matches_jax(tmp_path, file_type, use_native):
    path = write_fixture(tmp_path / "d.txt", file_type, seed=3)
    with open(path, "rb") as f:
        raw = f.read()
    args = (file_type, 6, FIXTURE_FEATS, FIXTURE_FIELDS)
    ref = jparser.parse_text(raw, *args, use_native=use_native)
    got = tparser.parse_text(raw, *args, use_native=use_native)
    _equal(got, ref)
    assert tparser.sniff_max_nnz(path, file_type) == jparser.sniff_max_nnz(
        path, file_type
    )


def test_native_parser_builds_like_jax():
    """Both packages build the same parser source (into their own cache
    directories); both load, or both fall back to numpy."""
    from ftrl_ffm_tpu import native as jnative
    from ftrl_ffm_tpu_torch import native as tnative

    assert (tnative.lib() is None) == (jnative.lib() is None)


@pytest.mark.parametrize("batch_size", [16, 24, 100])
def test_stream_batches_match_jax(tmp_path, batch_size):
    path = write_fixture(tmp_path / "d.ffm", "libffm", seed=4)
    args = (path, "libffm", batch_size, FIXTURE_FIELDS, FIXTURE_FEATS, FIXTURE_FIELDS)
    ref = list(JStream(*args, log_every=0).batches())
    got = list(TStream(*args, log_every=0).batches())
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _equal(g, r)


def test_offline_batches_match_jax(tmp_path):
    path = write_fixture(tmp_path / "d.ffm", "libffm", seed=5)
    args = (path, "libffm", FIXTURE_FIELDS, FIXTURE_FEATS, FIXTURE_FIELDS)
    jds, tds = jloader.load_file(*args, n_workers=2), tloader.load_file(*args, n_workers=2)
    _equal(tds, jds)
    ref = list(jloader.batch_iterator(jds, 24, sentinel=FIXTURE_FEATS))
    got = list(tloader.batch_iterator(tds, 24, sentinel=FIXTURE_FEATS))
    for g, r in zip(got, ref):
        _equal(g, r)
