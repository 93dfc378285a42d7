"""Staging on the CPU: ``pipeline.Stager`` (the pinned, overlapped form of
``to_device``) against ``to_device``, the prefetch depth, the host-fed
group cap, ``Predictor.predict_bags`` through the stager, and ``cli bench``.

The stager on the CPU makes the same tensors as ``to_device`` (exactly: the
same arrays); its pinned buffers, copy stream and events run on the card
only (``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phase 23).
``cli bench`` prints one JSON line holding every key of the JAX package's
``benchmark_training`` line (read from that module's source: no JAX run).
"""

import ast
import json
import os
import time

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from multimodal_path_omic_tpu_torch import cli  # noqa: E402
from multimodal_path_omic_tpu_torch.data import pipeline  # noqa: E402
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.train import loop  # noqa: E402
from multimodal_path_omic_tpu_torch.train import trainer as ttrainer  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SIZES = (5, 7)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module's tests: under the tier-1
    run's six workers on fewer cores, torch's thread teams spin against
    each other (this module took 10x its one-process time there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host_batch(rng, b=4, m=32, d=16, ge=False):
    batch = {"wsi": rng.normal(size=(b, m, d)).astype(np.float32),
             "mask": rng.random((b, m)) < 0.7, "weight": np.array([1, 1, 1, 0], np.float32),
             "label": rng.integers(0, 3, b).astype(np.int32), "bucket": m, "n_real": 3,
             "index": np.arange(b, dtype=np.int32)}
    if not ge:
        batch["omics"] = [rng.normal(size=(b, s)).astype(np.float32) for s in SIZES]
        batch["censorship"] = rng.integers(0, 2, b).astype(np.float32)
        batch["survival_months"] = rng.uniform(1, 50, b).astype(np.float32)
    return batch


@pytest.mark.parametrize("ge", [False, True], ids=["survival", "ge"])
def test_staged_batches_equal_to_device(ge):
    """``stage_batch`` equals ``to_device`` and ``stage_group`` equals
    ``to_device(stack_batches(...))``: the same keys, types and values."""
    rng = np.random.default_rng(0)
    batches = [_host_batch(rng, ge=ge) for _ in range(3)]
    stager = pipeline.Stager("cpu")
    for got, ref in ((stager.stage_batch(batches[0], ge).take(),
                      pipeline.to_device(batches[0], "cpu", ge)),
                     (stager.stage_group(batches, ge).take(),
                      pipeline.to_device(loop.stack_batches(batches), "cpu", ge))):
        assert set(got) == set(ref) == ({"wsi", "mask", "weight", "label"} | (
            set() if ge else {"omics_packed", "censorship", "survival_months"}))
        for key, value in ref.items():
            assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    with pytest.raises(ValueError, match="stacked"):
        stager.stage([pipeline.device_arrays(b, ge) for b in batches])


def test_prefetch_keeps_its_depth():
    """``prefetch(depth=d)``: with the first item taken and the consumer
    waiting, the source has made exactly d + 2 items (d queued, one held
    by the blocked put); the rest arrive in order."""
    for depth in (1, 2, 4):
        made = []

        def source():
            for i in range(12):
                made.append(i)
                yield i

        stream = pipeline.prefetch(source(), depth=depth)
        assert next(stream) == 0
        deadline = time.monotonic() + 5.0
        while len(made) < depth + 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)  # a source that ignored the depth would run on here
        assert len(made) == depth + 2
        assert list(stream) == list(range(1, 12))


def test_host_group_cap_is_one_gib_of_stacked_bags():
    """Auto ``steps_per_dispatch`` caps a host-fed group at 1 GiB of float32
    bags (a 32 x 8192 x 1024 batch is already 1 GiB: K = 1); an explicit
    value is honoured."""
    t = ttrainer.Trainer.__new__(ttrainer.Trainer)
    t.batch_size, t.wsi_dim = 32, 1024
    t._spd_auto = True
    cap = t._host_k_cap(64)
    assert cap(8192) == 1 and cap(4096) == 2 and cap(512) == 16 and cap(64) == 64
    t.batch_size = 64
    assert cap(8192) == 1  # rounds down, never below 1
    t._spd_auto = False
    assert t._host_k_cap(5)(8192) == 5


def test_predict_bags_through_the_stager_equals_direct_batches():
    """``predict_bags`` (padded on the host, staged, one batch ahead in the
    prefetch thread) against eval steps on the same batches built directly
    with ``_batch``: every row bit for bit, in input order."""
    rng = np.random.default_rng(3)
    pred = Predictor("NaCAGaT", omic_sizes=SIZES, model_size="small", wsi_dim=16,
                     buckets=(32, 64), batch_size=2, loss="cesar", device="cpu")
    lengths = (10, 50, 30, 64, 5)
    bags = [rng.normal(size=(m, 16)).astype(np.float32) for m in lengths]
    omics = [[rng.normal(size=(s,)).astype(np.float32) for s in SIZES] for _ in bags]
    got = pred.predict_bags(bags, omics)
    # the chunks predict_bags makes: by bucket, in input order, two at a time
    for bucket, chunk in ((32, [0, 2]), (32, [4]), (64, [1, 3])):
        wsi = torch.zeros((2, bucket, 16))
        mask = torch.zeros((2, bucket), dtype=torch.bool)
        for row, i in enumerate(chunk):
            wsi[row, :len(bags[i])] = torch.from_numpy(bags[i])
            mask[row, :len(bags[i])] = True
        ref = pred.eval_step(pred._batch(wsi, mask, [omics[i] for i in chunk], len(chunk)))
        for key in ("risk", "hazards", "survs", "y"):
            for row, i in enumerate(chunk):
                assert np.array_equal(got[key][i], ref[key][row].numpy()), (key, i)


def _jax_bench_keys():
    """The keys of the JAX package's ``benchmark_training`` result."""
    path = os.path.join(HERE, "..", "multimodal_path_omic_tpu", "train", "benchmark.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", "") == "result":
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in the JAX benchmark module")


@pytest.mark.parametrize("validate", [False, True], ids=["train", "validated"])
def test_cli_bench_prints_one_json_line(tmp_path, capsys, validate):
    csv, sig, patches = make_synthetic_cohort(str(tmp_path), n_patients=12, bag_lengths=(20, 40),
                                              n_genes=12, n_signatures=2, seed=2)
    raw = synthetic_config_dict(csv, sig, patches)
    raw["device"] = "cpu"
    raw["model"].update(name="MCAT", model_size="small")
    raw["training"].update(test_output_dir=str(tmp_path / "out"))
    raw["model"]["checkpoint_dir"] = str(tmp_path / "ck")
    raw["tpu"] = {"bag_buckets": [64], "batch_size": 4, "steps_per_dispatch": 2}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    argv = ["bench", "--config", str(path), "--epochs", "2", "--warmup", "1"]
    assert cli.main(argv + (["--validate"] if validate else [])) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert _jax_bench_keys() <= set(row)
    assert row["metric"] == "train_bags_per_sec_e2e" and row["value"] > 0
    assert row["backend"] == "cpu" and row["device"] == "cpu" and not row["cuda_graphs"]
    assert row["steps_per_dispatch"] == 2 and row["timed_epochs"] == 2
    assert row["validated_cadence"] is validate and row["steps_per_epoch"] >= 1


@pytest.mark.parametrize("ge", [False, True], ids=["survival", "ge"])
def test_staged_rows_pad_to_the_padded_batch(ge):
    """A ``_make_rows`` batch (the bags' own patches and their positions)
    staged and taken, alone and as a group of two, equals the padded
    ``_make_batch`` batch through ``to_device`` (and ``stack_batches``):
    padding on the device changes no bit."""
    from types import SimpleNamespace

    rng = np.random.default_rng(4)
    lengths = (5, 32, 17, 1, 30, 9)

    class Bags:
        bags = [rng.normal(size=(m, 16)).astype(np.float32) for m in lengths]
        table = SimpleNamespace(
            survival_months=rng.uniform(1, 9, 6).astype(np.float32),
            survival_class=rng.integers(0, 4, 6), censorship=np.ones(6),
            signature_names=["a", "b"], gene_expr_class=rng.integers(0, 3, 6),
            signature_data={"a": rng.normal(size=(6, 5)), "b": rng.normal(size=(6, 7))})

        def __len__(self):
            return len(self.bags)

        def bag(self, i):
            return self.bags[i]

    ds = Bags()
    extras = pipeline.gene_expr_extras if ge else pipeline.survival_extras
    batcher = pipeline.BucketBatcher(ds, extras, 4, (32,))
    groups = ([0, 1, 2], [3, 4, 5, 0])
    stager = pipeline.Stager("cpu")
    padded = [batcher._make_batch(g, 32) for g in groups]
    rows = [batcher._make_rows(g, 32) for g in groups]
    for got, ref in ((stager.stage_batch(rows[0], ge).take(),
                      pipeline.to_device(padded[0], "cpu", ge)),
                     (stager.stage_group(rows, ge).take(),
                      pipeline.to_device(loop.stack_batches(padded), "cpu", ge))):
        assert set(got) == set(ref)
        for key, value in ref.items():
            assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
