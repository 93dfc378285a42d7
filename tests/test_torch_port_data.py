"""The port's data layer against the JAX package's, on the same synthetic
cohorts: ``make_synthetic_cohort`` (the CSVs byte for byte, the bags in npy,
pt and h5), the bag stores, the tables (signature sizes, standardised
omics, quantile classes, the patient split, k-fold), the datasets and the
bucket batcher (the same batches in the same order for two epochs).

Everything here is host-side numpy / pandas on both sides: every comparison
is exact.
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from multimodal_path_omic_tpu.config import config_from_dict as jconfig_from_dict  # noqa: E402
from multimodal_path_omic_tpu.data import bags as jbags  # noqa: E402
from multimodal_path_omic_tpu.data import dataset as jdataset  # noqa: E402
from multimodal_path_omic_tpu.data import pipeline as jpipeline  # noqa: E402
from multimodal_path_omic_tpu.data import synthetic as jsynthetic  # noqa: E402
from multimodal_path_omic_tpu.data import tables as jtables  # noqa: E402
from multimodal_path_omic_tpu_torch.config import config_from_dict  # noqa: E402
from multimodal_path_omic_tpu_torch.data import bags as tbags  # noqa: E402
from multimodal_path_omic_tpu_torch.data import dataset as tdataset  # noqa: E402
from multimodal_path_omic_tpu_torch.data import pipeline as tpipeline  # noqa: E402
from multimodal_path_omic_tpu_torch.data import synthetic as tsynthetic  # noqa: E402
from multimodal_path_omic_tpu_torch.data import tables as ttables  # noqa: E402

COHORT = dict(n_patients=14, bag_lengths=(20, 70, 150, 300), n_genes=24, n_signatures=3,
              embedding_dim=16, seed=3, signal_strength=2.0)
BUCKETS = (64, 128, 256)


def _cohort(root, make, fmt, **kw):
    return make(os.path.join(root, fmt), bag_format=fmt, **{**COHORT, **kw})


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """The same cohort written by each package, in each bag format."""
    root = tmp_path_factory.mktemp("cohorts")
    return {
        (pkg, fmt): _cohort(str(root / pkg), make, fmt)
        for pkg, make in (("jax", jsynthetic.make_synthetic_cohort),
                          ("port", tsynthetic.make_synthetic_cohort))
        for fmt in ("npy", "pt", "h5")
    }


def _read_bags(patches, fmt):
    if fmt == "h5":
        with h5py.File(patches, "r") as f:
            return {k: np.asarray(f[k]) for k in sorted(f.keys())}
    out = {}
    for name in sorted(os.listdir(patches)):
        path = os.path.join(patches, name)
        if fmt == "npy" and name.endswith(".npy"):
            out[name] = np.load(path)
        elif fmt == "pt" and name.endswith(".pt"):
            out[name] = torch.load(path, weights_only=True).numpy()
    return out


@pytest.mark.parametrize("fmt", ["npy", "pt", "h5"])
def test_synthetic_cohort_equals_jax(cohorts, fmt):
    (jcsv, jsig, jpatches), (tcsv, tsig, tpatches) = cohorts["jax", fmt], cohorts["port", fmt]
    for a, b in ((jcsv, tcsv), (jsig, tsig)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    ref, got = _read_bags(jpatches, fmt), _read_bags(tpatches, fmt)
    assert len(ref) == 14 and list(ref) == list(got)
    for key in ref:
        assert ref[key].dtype == got[key].dtype and np.array_equal(ref[key], got[key])


def test_synthetic_config_dict_equals_jax(cohorts):
    for h5 in (False, True):
        args = cohorts["port", "h5" if h5 else "npy"]
        assert tsynthetic.synthetic_config_dict(*args, h5=h5) == \
            jsynthetic.synthetic_config_dict(*args, h5=h5)


@pytest.mark.parametrize("fmt", ["npy", "pt", "h5"])
def test_bag_stores_read_the_same_bags(cohorts, fmt):
    csv, _, patches = cohorts["port", fmt]
    kw = dict(h5_dataset=patches) if fmt == "h5" else dict(patches_dir=patches)
    tstore, jstore = tbags.open_bag_store(**kw), jbags.open_bag_store(**kw)
    assert type(tstore).__name__ == type(jstore).__name__
    slides = list(pd.read_csv(csv)["slide_id"]) + ["P999_S0.svs"]
    assert [tstore.exists(s) for s in slides] == [jstore.exists(s) for s in slides]
    assert not tstore.exists("P999_S0.svs")
    for s in slides[:-1]:
        a, b = tstore.get(s), jstore.get(s)
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(tbags.filter_existing(slides, tstore, verbose=False),
                          jbags.filter_existing(slides, jstore, verbose=False))
    assert tbags.slide_basename("P000_S0.svs") == jbags.slide_basename("P000_S0.svs") == "P000_S0"


_RAN = []


def _mark():
    _RAN.append(True)


class _Payload:
    """A pickle that calls ``_mark`` when it is loaded without restriction."""

    def __reduce__(self):
        return (_mark, ())


@pytest.mark.parametrize("payload", ["code", "dict"])
def test_pt_bag_holding_a_non_tensor_is_refused(tmp_path, payload):
    obj = _Payload() if payload == "code" else {"bag": torch.zeros(3, 4)}
    torch.save(obj, str(tmp_path / "P000_S0.pt"))
    store = tbags.open_bag_store(patches_dir=str(tmp_path))
    assert isinstance(store, tbags.PtBagStore)
    error = pickle.UnpicklingError if payload == "code" else TypeError
    with pytest.raises(error):
        store.get("P000_S0.svs")
    with pytest.raises(error):
        tbags.convert_bags(str(tmp_path), str(tmp_path / "npy"), verbose=False)
    assert not _RAN  # nothing in the file ran


@pytest.mark.parametrize("src_fmt", ["pt", "h5"])
def test_convert_bags_equals_jax(cohorts, tmp_path, src_fmt):
    _, _, src = cohorts["port", src_fmt]
    n_t = tbags.convert_bags(src, str(tmp_path / "t"), verbose=False)
    n_j = jbags.convert_bags(src, str(tmp_path / "j"), verbose=False)
    assert n_t == n_j == 14
    ref, got = _read_bags(str(tmp_path / "j"), "npy"), _read_bags(str(tmp_path / "t"), "npy")
    assert list(ref) == list(got) and all(np.array_equal(ref[k], got[k]) for k in ref)
    with pytest.raises(ValueError, match="dtype"):
        tbags.convert_bags(src, str(tmp_path / "x"), dtype="int8")


def _tables_equal(a, b):
    for name in ("slide_ids", "patients", "survival_months", "survival_class", "censorship",
                 "rnaseq", "cnv", "mut", "gene_expr_class"):
        if hasattr(b, name):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    if hasattr(b, "signature_names"):
        assert a.signature_names == b.signature_names
        assert a.signature_sizes == b.signature_sizes
        for k in b.signature_data:
            assert np.array_equal(a.signature_data[k], b.signature_data[k]), k
        assert np.array_equal(a.survival_bin_edges, b.survival_bin_edges)
    pd.testing.assert_frame_equal(a.df, b.df)


@pytest.mark.parametrize("standardize,normalize", [(True, False), (False, True)])
def test_multimodal_table_equals_jax(cohorts, standardize, normalize):
    csv, sig, _ = cohorts["port", "npy"]
    kw = dict(signatures=sig, standardize=standardize, normalize=normalize, verbose=False)
    got, ref = ttables.MultimodalTable.from_csv(csv, **kw), jtables.MultimodalTable.from_csv(
        csv, **kw)
    _tables_equal(got, ref)
    assert got.signature_sizes == [8, 8, 8]
    for bug_compat in (False, True):
        kw = dict(seed=None if bug_compat else 5, test=True, patient="P003")
        if bug_compat:  # the unseeded shuffle: compare the misaligned subsets on fixed rows
            rows = np.array([5, 1, 9])
            _tables_equal(got.subset(rows, misalign_signatures=True),
                          ref.subset(rows, misalign_signatures=True))
            continue
        for a, b in zip(got.split(0.7, **kw), ref.split(0.7, **kw)):
            _tables_equal(a, b)
    filtered = dict(decider_only=True, diagnostic_only=True, verbose=False)
    _tables_equal(ttables.MultimodalTable.from_csv(csv, **filtered),
                  jtables.MultimodalTable.from_csv(csv, **filtered))


def test_gene_expr_table_equals_jax(cohorts):
    csv = cohorts["port", "npy"][0]
    got = ttables.GeneExprTable.from_csv(csv, "G001", verbose=False)
    ref = jtables.GeneExprTable.from_csv(csv, "G001", verbose=False)
    _tables_equal(got, ref)
    for a, b in zip(got.split(0.8, seed=2), ref.split(0.8, seed=2)):
        if b is not None:
            _tables_equal(a, b)
    rows = np.array([4, 0, 2])
    _tables_equal(got.subset(rows, misalign_labels=True), ref.subset(rows, misalign_labels=True))


def test_splits_and_classes_equal_jax():
    rng = np.random.default_rng(0)
    patients = np.array([f"P{i:02d}" for i in rng.integers(0, 30, 80)])
    for seed in (0, 7):
        for test in (False, True):
            got = ttables.patient_level_split(patients, 0.75, seed=seed, test=test,
                                              patient=patients[3])
            ref = jtables.patient_level_split(patients, 0.75, seed=seed, test=test,
                                              patient=patients[3])
            for a, b in zip(got, ref):
                assert (a is None and b is None) or np.array_equal(a, b)
        for (ta, va), (tb, vb) in zip(ttables.patient_kfold(patients, 5, seed=seed),
                                      jtables.patient_kfold(patients, 5, seed=seed)):
            assert np.array_equal(ta, tb) and np.array_equal(va, vb)
    values = pd.Series(rng.exponential(20, 50))
    got = ttables.qcut_classes(values, 4, verbose=False, return_bins=True)
    ref = jtables.qcut_classes(values, 4, verbose=False, return_bins=True)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    for bad in (dict(train_size=1.0), dict(train_size=0.0)):
        with pytest.raises(ValueError, match="train_size"):
            ttables.patient_level_split(patients, **bad)
    with pytest.raises(ValueError, match="k-fold"):
        ttables.patient_kfold(patients, 1)


def _config(cohort, ge=False):
    raw = jsynthetic.synthetic_config_dict(*cohort)
    if ge:
        raw["model"]["name"], raw["model"]["gene"] = "GE-NaCAGaT", "G002"
    return config_from_dict(raw), jconfig_from_dict(raw)


def test_datasets_equal_jax(cohorts):
    tcfg, jcfg = _config(cohorts["port", "npy"])
    got = tdataset.MultimodalDataset(tcfg.dataset.file, tcfg, use_signatures=True, verbose=False)
    ref = jdataset.MultimodalDataset(jcfg.dataset.file, jcfg, use_signatures=True, verbose=False)
    _tables_equal(got.table, ref.table)
    assert got.signature_sizes == ref.signature_sizes and got.rnaseq_size == ref.rnaseq_size
    for i in (0, 5):
        for a, b in zip(got[i], ref[i]):
            if isinstance(b, list):
                assert all(np.array_equal(x, y) for x, y in zip(a, b))
            else:
                assert np.array_equal(a, b)
    for a, b in zip(got.split(0.8, seed=1), ref.split(0.8, seed=1)):
        if b is not None:
            _tables_equal(a.table, b.table)
            assert np.array_equal(a.bag(0), b.bag(0))
    gcfg, jgcfg = _config(cohorts["port", "npy"], ge=True)
    got = tdataset.GeneExprDataset(gcfg.dataset.file, gcfg, gene="G002", verbose=False)
    ref = jdataset.GeneExprDataset(jgcfg.dataset.file, jgcfg, gene="G002", verbose=False)
    _tables_equal(got.table, ref.table)
    assert got[2][0] == ref[2][0] and np.array_equal(got[2][1], ref[2][1])
    tr, va, _ = got.split(0.8, seed=1)
    jtr, jva, _ = ref.split(0.8, seed=1)
    _tables_equal(tr.table, jtr.table)
    _tables_equal(va.table, jva.table)


def _batches_equal(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert set(a) == set(b) - {"aliased"}
        for key in b:
            if key == "omics":
                assert all(np.array_equal(x, y) for x, y in zip(a[key], b[key]))
            elif key != "aliased":
                assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key


@pytest.mark.parametrize("ge", [False, True], ids=["survival", "ge"])
def test_bucket_batcher_equals_jax_for_two_epochs(cohorts, ge):
    tcfg, jcfg = _config(cohorts["port", "npy"], ge=ge)
    if ge:
        tds = tdataset.GeneExprDataset(tcfg.dataset.file, tcfg, gene="G002", verbose=False)
        jds = jdataset.GeneExprDataset(jcfg.dataset.file, jcfg, gene="G002", verbose=False)
        extras = (tpipeline.gene_expr_extras, jpipeline.gene_expr_extras)
    else:
        tds = tdataset.MultimodalDataset(tcfg.dataset.file, tcfg, use_signatures=True,
                                         verbose=False)
        jds = jdataset.MultimodalDataset(jcfg.dataset.file, jcfg, use_signatures=True,
                                         verbose=False)
        extras = (tpipeline.survival_extras, jpipeline.survival_extras)
    for shuffle in (True, False):
        got = tpipeline.BucketBatcher(tds, extras[0], 3, BUCKETS, shuffle=shuffle, seed=4)
        ref = jpipeline.BucketBatcher(jds, extras[1], 3, BUCKETS, shuffle=shuffle, seed=4)
        assert len(got) == len(ref)
        for _ in range(2):
            _batches_equal(list(got.batches()), list(ref.batches()))
        assert got._epoch == ref._epoch == 2


def test_pad_plan_indices_and_prefetch():
    for idx, b in (([4, 1], 4), ([7], 1), ([2, 3, 5], 3)):
        got, ref = tpipeline.pad_plan_indices(idx, b), jpipeline.pad_plan_indices(idx, b)
        assert got[0] == ref[0] and np.array_equal(got[1], ref[1])
    assert list(tpipeline.prefetch(iter(range(50)), depth=3)) == list(range(50))

    def failing():
        yield 1
        raise KeyError("bag")

    with pytest.raises(KeyError, match="bag"):
        list(tpipeline.prefetch(failing(), depth=2))
    stream = tpipeline.prefetch(iter(range(1000)), depth=2)
    assert next(stream) == 0
    stream.close()  # an abandoned consumer releases the thread
