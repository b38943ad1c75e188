"""The port's pandas-free data generator (ftrl_ffm_tpu_torch/tools/
generate_data.py) writes the bytes tools/generate_data.py writes for the
same csv, flags and seed: on the csv of tests/test_generate_data.py under
each of its flag sets, and on csvs with a header and mixed columns
(integer, string and float categoricals, integer and float numerics,
missing values, quoted fields, a float label), split from one file or
read from two.  Its normalized output trains through the port's DEC6
transfer tier."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from generate_data import main as jax_tool_main  # noqa: E402

from ftrl_ffm_tpu_torch.tools.generate_data import main as twin_main  # noqa: E402


def _test_generate_data_csv(path):
    """tests/test_generate_data.py's csv_file fixture."""
    rows = ["label,user,item,score"]
    rng = np.random.default_rng(0)
    for _ in range(50):
        rows.append(
            f"{rng.integers(0, 5)},u{rng.integers(0, 8)},i{rng.integers(0, 10)},"
            f"{rng.random() * 10:.3f}"
        )
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _mixed_csv(path, n=120, seed=3):
    """A header and mixed columns: label (float), an integer categorical
    whose values sort differently as numbers and as strings, a string
    categorical with a quoted comma, a float categorical, an integer
    numeric, a float numeric with missing values and exponents."""
    rng = np.random.default_rng(seed)
    rows = ["rating,uid,city,bucket,count,price"]
    cities = ["Paris", '"Rome, IT"', "Oslo", "Lima", "10", "9"]
    for i in range(n):
        price = "" if i % 17 == 0 else f"{rng.random() * 1e3:.2f}"
        if i % 29 == 3:
            price = f"{rng.random():.3e}"
        rows.append(",".join([
            f"{rng.integers(0, 10) / 2:.1f}",
            str(int(rng.integers(1, 25))),
            cities[int(rng.integers(0, len(cities)))],
            f"{rng.integers(0, 4) * 0.5}",
            str(int(rng.integers(-5, 300))),
            price,
        ]))
        if i % 40 == 7:
            rows.append("")  # a blank line: skipped
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _both(tmp_path, inputs, flags):
    """Run the JAX tool and the twin on the same inputs: their
    (train, eval) outputs' bytes."""
    outs = {}
    for name, main in (("jax", jax_tool_main), ("twin", twin_main)):
        tr, ev = tmp_path / f"{name}.tr", tmp_path / f"{name}.ev"
        assert main([*inputs, "--train_output_path", str(tr), "--eval_output_path", str(ev),
                     *flags]) is not False
        outs[name] = (tr.read_bytes(), ev.read_bytes())
    return outs


@pytest.mark.parametrize("flags", [
    ["--cat_cols", "1,2", "--num_cols", "3", "--normalize", "true", "--ffm", "true",
     "--threshold", "2"],
    ["--cat_cols", "1,2", "--num_cols", "", "--ffm", "false"],
    ["--cat_cols", "1,2", "--num_cols", "", "--neg_sampling", "true", "--num_neg", "2",
     "--ffm", "true"],
    ["--cat_cols", "2", "--num_cols", "3", "--neg_sampling", "true", "--num_neg", "3",
     "--normalize", "true", "--seed", "7", "--train_frac", "0.6"],
], ids=["ffm-normalized", "libsvm", "neg-sampling", "neg-numeric"])
def test_twin_writes_the_tools_bytes(tmp_path, flags):
    csv_path = _test_generate_data_csv(tmp_path / "data.csv")
    outs = _both(tmp_path, ["--data_path", csv_path], flags)
    assert outs["twin"] == outs["jax"]
    assert outs["twin"][0].strip()


@pytest.mark.parametrize("flags", [
    ["--cat_cols", "1,2,3", "--num_cols", "4,5", "--normalize", "true", "--ffm", "true",
     "--threshold", "2"],
    ["--cat_cols", "1,2,3", "--num_cols", "4", "--neg_sampling", "true", "--num_neg", "1",
     "--ffm", "true", "--seed", "11"],
    ["--cat_cols", "2,1", "--num_cols", "4", "--normalize", "false", "--ffm", "false",
     "--label_col", "0", "--threshold", "3"],
], ids=["ffm", "neg-sampling", "libsvm"])
@pytest.mark.parametrize("split", ["one-file", "two-files"])
def test_twin_on_mixed_columns(tmp_path, flags, split):
    if split == "one-file":
        inputs = ["--data_path", _mixed_csv(tmp_path / "mixed.csv")]
    else:
        inputs = ["--train_path", _mixed_csv(tmp_path / "tr.csv", n=90, seed=4),
                  "--eval_path", _mixed_csv(tmp_path / "ev.csv", n=40, seed=5)]
    outs = _both(tmp_path, inputs, flags)
    assert outs["twin"] == outs["jax"]
    assert len(outs["twin"][1].splitlines()) > 0


def test_twin_imports_no_pandas(tmp_path):
    """The twin runs where pandas is absent (the card's machine)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csv_path = _test_generate_data_csv(tmp_path / "data.csv")
    code = ("import sys; sys.modules['pandas'] = None\n"
            "from ftrl_ffm_tpu_torch.tools.generate_data import main\n"
            f"sys.exit(main(['--data_path', {csv_path!r}, '--train_output_path', "
            f"{str(tmp_path / 'a')!r}, '--eval_output_path', {str(tmp_path / 'b')!r}, "
            "'--cat_cols', '1,2', '--num_cols', '3', '--normalize', 'true', '--ffm', 'true']))")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=repo), timeout=120)
    assert r.returncode == 0, r.stderr
    assert "Output train size: 40" in r.stdout


def test_normalized_output_trains_through_the_dec6_tier(tmp_path):
    """The twin's normalized libffm output (4-decimal values) streams
    through the DEC6 tier, and training gives compact_transfer=false's
    bits."""
    import torch

    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import Trainer

    csv_path = _mixed_csv(tmp_path / "mixed.csv", n=200)
    tr, ev = str(tmp_path / "tr.ffm"), str(tmp_path / "ev.ffm")
    assert twin_main(["--data_path", csv_path, "--train_output_path", tr,
                      "--eval_output_path", ev, "--cat_cols", "1,2,3", "--num_cols", "4",
                      "--normalize", "true", "--ffm", "true", "--threshold", "2"]) == 0
    runs = []
    for compact in (True, False):
        t = Trainer(Config(train_data=tr, eval_data=ev, model_type="FFM", n_fields=4,
                           n_feats=200, n_factors=4, batch_size=32, n_epochs=2,
                           device_cache="off", compact_transfer=compact, device="cpu"))
        seen = []
        compact_fn = t._compact
        t._compact = lambda arrays, role="train": seen.append(compact_fn(arrays, role)) or seen[-1]
        runs.append((t.train(), t.state, seen))
    (h_on, s_on, seen), (h_off, s_off, _) = runs
    assert h_on == h_off
    assert all(torch.equal(a, b) for a, b in zip(s_on, s_off) if a is not None)
    assert any(a[2].dtype == np.uint8 for a in seen), "no batch took the DEC6 tier"
