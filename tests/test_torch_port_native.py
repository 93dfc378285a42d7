"""The port's C++ bag loader (``data/native.py`` over its own
``csrc_host/bagloader.cc``) on the CPU, against numpy and the JAX package's
loader on the same files: every comparison is bitwise (the loaders copy
bytes). A host-fed Trainer gives bitwise equal losses and parameters with
``tpu.use_native_pipeline`` on and off (JAX ``test_train.py:709``); a header
the loader cannot parse takes the Python reader, as JAX's does; a loader
that does not build raises and names its log.

Sizes: 12 synthetic patients (bags of 48 to 512 patches, 1024 wide) for the
stores, 14 for the Trainer (``small`` NaCAGaT, buckets 64/128, batch 4).
"""

import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from multimodal_path_omic_tpu.data import native as jnative  # noqa: E402
from multimodal_path_omic_tpu_torch.config import load_config  # noqa: E402
from multimodal_path_omic_tpu_torch.data import native  # noqa: E402
from multimodal_path_omic_tpu_torch.data.dataset import MultimodalDataset  # noqa: E402
from multimodal_path_omic_tpu_torch.data.pipeline import (  # noqa: E402
    BucketBatcher,
    survival_extras,
)
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.train.trainer import Trainer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's six workers on
    eight cores, each with a thread a core, oversubscribe them (the host-fed
    Trainers here then run several times slower than alone)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    out = tmp_path_factory.mktemp("native_cohort")
    return make_synthetic_cohort(str(out), n_patients=12, seed=7)


def _names(patches):
    return sorted(f[:-4] for f in os.listdir(patches) if f.endswith(".npy"))


def test_port_builds_its_own_copy_into_build():
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.SOURCE.endswith(os.path.join("multimodal_path_omic_tpu_torch", "csrc_host",
                                               "bagloader.cc"))
    # never beside the JAX package's loader (native/libbagloader.so)
    assert os.path.dirname(path) != os.path.dirname(os.path.abspath(jnative._SRC))


def test_store_matches_numpy_and_jax(cohort):
    _, _, patches = cohort
    store, jstore = native.NativeBagStore(patches), jnative.NativeBagStore(patches)
    names = _names(patches)
    for name in names:
        ref = np.load(os.path.join(patches, name + ".npy"))
        assert store.length(name) == jstore.length(name) == ref.shape[0]
        assert store.dim(name) == ref.shape[1]
        np.testing.assert_array_equal(store.get(name), ref)
    wsi, mask = store.load_batch(names[:5], 512, 1024)
    jwsi, jmask = jstore.load_batch(names[:5], 512, 1024)
    np.testing.assert_array_equal(wsi, jwsi)
    np.testing.assert_array_equal(mask, jmask)
    with pytest.raises(FileNotFoundError):
        store.load_batch(["no_such_slide"], 64, 1024)


def test_pipeline_rows_match_numpy_and_jax(cohort):
    """Packed slot rows, in plan order, over more batches than slots (the
    ring recycles), a task that starts past row 0 (a seq-mesh window) and a
    batch of no rows: each batch's rows are numpy's rows of its bags,
    concatenated, and the JAX pipeline's padded batches without their
    padding."""
    _, _, patches = cohort
    store, jstore = native.NativeBagStore(patches), jnative.NativeBagStore(patches)
    names = _names(patches)
    bags = {n: np.load(os.path.join(patches, n + ".npy")) for n in names}
    jplan = [(names[i:i + 2], 512) for i in range(0, 12, 2)] * 2
    plan = [[(n, 0, len(bags[n])) for n in ids] for ids, _ in jplan]
    plan[3] = [(names[6], 10, 20), (names[7], 0, 0)]
    plan[5] = []
    pipe = native.NativePipeline(store, plan, 1024, n_slots=3, threads=3)
    jpipe = jnative.NativePipeline(jstore, jplan, batch_size=2, dim=1024, n_slots=3)
    for b, (jb, jwsi, jmask) in zip(range(len(plan)), jpipe.batches()):
        got_b, rows = pipe.next()
        assert got_b == b == jb
        ref = (np.concatenate([bags[n][s:s + r] for n, s, r in plan[b]]) if plan[b]
               else np.zeros((0, 1024), np.float32))
        np.testing.assert_array_equal(rows.numpy(), ref)
        if b not in (3, 5):
            np.testing.assert_array_equal(rows.numpy(), jwsi[jmask])
        pipe.release(b)
    with pytest.raises(StopIteration):
        pipe.next()
    pipe.close()


def test_pipeline_dim_mismatch_raises(tmp_path):
    rng = np.random.default_rng(1)
    np.save(tmp_path / "a.npy", rng.normal(size=(8, 64)).astype(np.float32))
    np.save(tmp_path / "b.npy", rng.normal(size=(8, 32)).astype(np.float32))
    store = native.NativeBagStore(str(tmp_path))
    with pytest.raises(IOError):
        store.load_batch(["a", "b"], bucket=16, dim=64)
    pipe = native.NativePipeline(store, [[("a", 0, 8), ("b", 0, 8)]], 64, n_slots=2)
    with pytest.raises(IOError, match="code 3"):
        pipe.next()
    pipe.close()


def test_truncated_npy_is_not_indexed(tmp_path):
    good = np.random.default_rng(0).normal(size=(16, 32)).astype(np.float32)
    np.save(tmp_path / "good.npy", good)
    np.save(tmp_path / "bad.npy", good)
    os.truncate(tmp_path / "bad.npy", os.path.getsize(tmp_path / "bad.npy") - 512)
    store = native.NativeBagStore(str(tmp_path))
    assert store.exists("good") and not store.exists("bad")
    assert store.length("bad") == -1


def test_batcher_native_rows_equal_python_rows(cohort):
    """The batcher's native plan gives ``_make_rows``' batch: the same rows,
    positions, mask and columns."""
    csv, sig, patches = cohort
    ds = MultimodalDataset(csv, synthetic_config_dict(csv, sig, patches), use_signatures=True,
                           verbose=False)
    py = BucketBatcher(ds, survival_extras, 4, (256, 512), shuffle=False)
    nb = BucketBatcher(ds, survival_extras, 4, (256, 512), shuffle=False)
    nb.use_native_pipeline = True
    assert nb.reader == "native" and py.reader == "python"
    plan = nb._epoch_plan()
    pipe = nb.native_pipeline(plan)
    for indices, bucket in plan:
        ref = py._make_rows(indices, bucket)
        b, rows = pipe.next()
        got = nb.native_rows(indices, bucket, rows)
        pipe.release(b)
        np.testing.assert_array_equal(rows.numpy(), np.concatenate(ref["rows"]))
        np.testing.assert_array_equal(np.concatenate(got["pos"]), np.concatenate(ref["pos"]))
        for key in ("mask", "weight", "index", "label", "censorship"):
            np.testing.assert_array_equal(got[key], ref[key])
    pipe.close()


@pytest.fixture(scope="module")
def trainer_config(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native_trainer")
    raw = synthetic_config_dict(*make_synthetic_cohort(
        str(tmp / "c"), n_patients=14, bag_lengths=(48, 80, 120), n_genes=36, n_signatures=4,
        seed=0))
    raw["device"] = "cpu"
    raw["model"].update(name="NaCAGaT", model_size="small")
    raw["training"].update(loss="cesar", epochs=1, lr=1e-3)
    raw["tpu"] = {"bag_buckets": [64, 128], "batch_size": 4, "device_cache": "off",
                  "steps_per_dispatch": 2}
    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_host_fed_trainer_native_on_off_bitwise(trainer_config, capsys):
    runs = {}
    for on in (False, True):
        t = Trainer(load_config(trainer_config, {"tpu.use_native_pipeline": on}))
        assert t.bag_reader == ("native" if on else "python")
        out = {**t.train_epoch(0), **t.validate(0)}
        runs[on] = (out, [p.detach().clone() for p in t.model.parameters()])
    log = capsys.readouterr().out
    assert "Bag reader: native" in log
    assert "Bag reader: python (tpu.use_native_pipeline is off)" in log
    assert runs[True][0]["train_loss"] == runs[False][0]["train_loss"]
    assert runs[True][0]["val_loss"] == runs[False][0]["val_loss"]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)


def test_python_reader_only_where_jax_takes_it(trainer_config, tmp_path, monkeypatch):
    """A header the loader cannot parse (a float64 bag) takes the Python
    reader for the whole cohort and says so; so do fewer than 2 CPUs."""
    cfg = load_config(trainer_config)
    patches = cfg.dataset.patches_dir
    names = _names(patches)
    copy_dir = tmp_path / "bags"
    copy_dir.mkdir()
    for i, n in enumerate(names):
        a = np.load(os.path.join(patches, n + ".npy"))
        np.save(copy_dir / (n + ".npy"), a.astype(np.float64) if i == 0 else a)
    ds = MultimodalDataset(cfg.dataset.file, cfg, use_signatures=True, verbose=False)
    ds.store.patches_dir = str(copy_dir)
    b = BucketBatcher(ds, survival_extras, 4, (64, 128), shuffle=False)
    b.use_native_pipeline = True
    assert b.reader == "python"
    assert "cannot parse" in b.reader_note
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    assert Trainer(cfg, verbose=False).bag_reader == "python"


def test_failed_build_raises_naming_its_log(tmp_path, monkeypatch):
    bad = tmp_path / "bagloader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_STORES", {})
    with pytest.raises(RuntimeError, match=r"did not build.*\.log"):
        native.library()
    np.save(tmp_path / "x.npy", np.zeros((4, 8), np.float32))

    class _Ds:  # an npy store: the native reader is asked for and cannot build
        from multimodal_path_omic_tpu_torch.data.bags import NpyBagStore

        store = NpyBagStore(str(tmp_path))

        def __len__(self):
            return 1

        def slide_id(self, i):
            return "x"

    b = BucketBatcher(_Ds(), survival_extras, 1, (64,), shuffle=False)
    b.use_native_pipeline = True
    with pytest.raises(RuntimeError, match="did not build"):
        b.native_store()
