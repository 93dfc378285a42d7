"""The port's HTTP server over the ranks of a mesh (``server.py``:
``MeshFront`` on rank 0, ``follow`` on the others) against a one-rank
server on the same config, on two gloo CPU ranks at data 2.

One spawn (``torch_mesh_workers.run_world``, ``torch_mesh_jobs.
mesh_server``): every rank runs ``server.main --config`` on a config with
``tpu.data_axis: 2``; rank 0's client thread sends every request, then SIGTERM
to both ranks, as torchrun signals them. The one-rank server is
``make_server(Predictor.from_config(...))`` in this process, on the same
seeded weights. A 24-patient synthetic cohort of 64-wide patches, NaCAGaT
``small``, buckets 64 and 128, batch 4. The one-rank server pads a single
bag to two rows as the mesh pads it to the data axis' rows (``min_rows``),
so that the MC-dropout draws, the padded batch's, are the same.

Tolerance: every answered number 1e-5 of the largest magnitude of its
field in the one-rank answer (the data-parallel eval step runs each row on
one rank; the MC draws are the global batch's, sliced).
"""

import io
import os
import threading

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import torch_mesh_jobs as jobs  # noqa: E402
from torch_mesh_workers import _free_port, rng_array, run_world  # noqa: E402

WSI = 64


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _requests(sizes):
    """(path, body, expected status) of every request, bodies made from
    numpy seeds."""
    bags = [rng_array(70 + i, (n, WSI)) for i, n in enumerate((50, 100, 30))]
    omics = [[rng_array(80 + 10 * i + j, (s,)) for j, s in enumerate(sizes)]
             for i in range(len(bags))]
    import json

    one = json.dumps({"wsi": bags[0].tolist(), "omics": [o.tolist() for o in omics[0]]})
    single = _npz(wsi=bags[1], **{f"omic_{j}": o for j, o in enumerate(omics[1])})
    batch = {f"wsi_{i}": b for i, b in enumerate(bags)}
    batch.update({f"omic_{i}_{j}": o for i, sig in enumerate(omics) for j, o in enumerate(sig)})
    wrong_width = json.dumps({"wsi": rng_array(90, (20, WSI + 1)).tolist(),
                              "omics": [o.tolist() for o in omics[0]]})
    return [
        ("/healthz", None, 200),
        ("/predict", one.encode(), 200),
        ("/predict_npz", single, 200),
        ("/predict_batch_npz", _npz(**batch), 200),
        ("/predict_npz?mc=4&mc_seed=3", single, 200),
        ("/predict", wrong_width.encode(), 400),  # a bag of the wrong width
        ("/predict", b"{not json", 400),  # a malformed body
        ("/predict_npz", _npz(wsi=bags[2]), 400),  # a survival model's bag without omics
        ("/predict", one.encode(), 200),  # still serving
        ("/metrics", None, 200),
    ]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_server"))
    raw = jobs.cohort_config(root, n_patients=24)
    paths = {}
    for tag, data in (("one", 1), ("mesh", 2)):
        raw["tpu"]["data_axis"] = data
        paths[tag] = os.path.join(root, f"{tag}.yaml")
        with open(paths[tag], "w") as f:
            yaml.safe_dump(raw, f)
    from multimodal_path_omic_tpu_torch.config import load_config

    return paths, _requests(_sizes(load_config(paths["one"])))


def _sizes(cfg):
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    return tuple(Trainer(cfg, verbose=False, device="cpu").omic_sizes)


@pytest.fixture(scope="module")
def mesh_answers(setup):
    paths, requests = setup
    return run_world("mesh_server", 2, paths["mesh"], _free_port(), [r[:2] for r in requests])


@pytest.fixture(scope="module")
def one_rank_answers(setup):
    """The same requests to a one-rank server on the same config."""
    from multimodal_path_omic_tpu_torch.config import load_config
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.server import make_server

    paths, requests = setup
    pred = Predictor.from_config(load_config(paths["one"]))
    # a single bag padded to the data axis' two rows, as on the mesh: the
    # MC draws are the padded batch's
    pred.min_rows = 2
    srv = make_server(pred, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]
        return [jobs.http(f"http://127.0.0.1:{port}{p}", body) for p, body, _ in requests]
    finally:
        srv.shutdown()
        srv.server_close()


def test_every_rank_exits_0_after_sigterm(mesh_answers):
    """SIGTERM to both ranks: rank 0 drains and broadcasts the stop, the
    other rank ignores the signal until the stop arrives; both return 0."""
    assert [r["rc"] for r in mesh_answers] == [0, 0]
    assert mesh_answers[1]["answers"] == []  # rank 0 alone answers


@pytest.mark.parametrize("i", range(10))
def test_mesh_server_answers_as_one_rank(setup, mesh_answers, one_rank_answers, i):
    """Each request's status and body against the one-rank server's: the
    health line, /predict (JSON), /predict_npz, /predict_batch_npz, ?mc=4,
    three malformed requests (each a 400, checked on rank 0 before any
    collective, and the server keeps serving), /predict again and the
    metrics' request counts."""
    path, _, want_code = setup[1][i]
    code, body = mesh_answers[0]["answers"][i]
    ref_code, ref = one_rank_answers[i]
    assert code == ref_code == want_code, (path, body, ref)
    if path == "/metrics":
        for line in ref.splitlines():
            if line.startswith("mpot_requests_total"):
                assert line in body.splitlines(), line
        return
    if code != 200:
        assert code == 400 and "error" in body
        return
    if path == "/healthz":
        assert body == ref
        return
    assert set(body) == set(ref)
    for key, value in ref.items():
        got, want = np.asarray(body[key], np.float64), np.asarray(value, np.float64)
        assert got.shape == want.shape, key
        bound = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= bound, (path, key)
