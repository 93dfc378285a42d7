"""The port's HTTP scoring server (``server.py``) on the CPU: each case of
``tests/test_server.py`` that needs no deployment bundle, run against the
port's server over the port's ``Predictor``; then the same ``/predict_npz``
and ``/predict_batch_npz`` bodies posted to a JAX server and a port server
holding the same weights (within 5e-5: float32 on both sides in other
summation orders), and ``server.main`` in a subprocess stopped by SIGTERM.

Sizes as in the JAX file: ``small`` models, 1024-wide patch features, three
signature groups, bucket 128, batch 4."""

import copy
import io
import json
import threading
import urllib.request

import numpy as np
import pytest

from multimodal_path_omic_tpu_torch.config import config_from_dict
from multimodal_path_omic_tpu_torch.data.synthetic import (
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.serve import Predictor as _Predictor
from multimodal_path_omic_tpu_torch.server import make_server
from multimodal_path_omic_tpu_torch.train.trainer import Trainer as _Trainer


def Trainer(cfg, verbose=False):
    """The port's Trainer on the CPU."""
    cfg.device = "cpu"
    return _Trainer(cfg, verbose=verbose)


def Predictor(trainer, param_sets=None):
    """The port's Predictor over a Trainer (the JAX constructor's form)."""
    return _Predictor.from_trainer(trainer, param_sets=param_sets)


def _snapshot(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server")
    csv, sig, patches = make_synthetic_cohort(
        str(tmp), n_patients=8, bag_lengths=(48, 80), n_genes=24,
        n_signatures=3, seed=0,
    )
    raw = synthetic_config_dict(csv, sig, patches)
    raw["model"]["model_size"] = "small"
    raw["tpu"] = {"bag_buckets": [128], "batch_size": 4, "use_pallas": False}
    cfg = config_from_dict(raw)
    trainer = Trainer(cfg, verbose=False)
    predictor = Predictor(trainer)
    server = make_server(predictor, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", trainer
    server.shutdown()


def _post(url, data, content_type="application/json"):
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": content_type}, method="POST"
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_healthz(served):
    base, trainer = served
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        body = json.loads(resp.read())
    assert body["status"] == "ok"
    assert body["n_params"] == trainer.n_params
    assert body["omic_sizes"] == list(trainer.omic_sizes)


def test_predict_json_matches_predictor(served):
    base, trainer = served
    rng = np.random.default_rng(0)
    wsi = rng.normal(size=(60, 1024)).astype(np.float32)
    omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
    status, body = _post(
        base + "/predict",
        json.dumps({"wsi": wsi.tolist(), "omics": [o.tolist() for o in omics]}).encode(),
    )
    assert status == 200
    direct = Predictor(trainer).predict_bag(wsi, omics=omics)
    np.testing.assert_allclose(
        np.asarray(body["risk"]), np.asarray(direct["risk"]), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(body["hazards"]), np.asarray(direct["hazards"]), atol=1e-5
    )


def test_predict_npz_binary_path(served):
    base, trainer = served
    rng = np.random.default_rng(1)
    wsi = rng.normal(size=(48, 1024)).astype(np.float32)
    omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
    buf = io.BytesIO()
    np.savez(buf, wsi=wsi, **{f"omic_{i}": o for i, o in enumerate(omics)})
    status, body = _post(base + "/predict_npz", buf.getvalue(), "application/octet-stream")
    assert status == 200
    assert np.isfinite(np.asarray(body["y"])).all()
    assert abs(sum(body["y"][0]) - 1.0) < 1e-4  # class probabilities


def test_bad_request_is_400(served):
    base, _ = served
    try:
        status, body = _post(base + "/predict", b"{not json")
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    assert status == 400 and "error" in body

def test_predict_npz_f16_payload_halves_wire_bytes(served):
    """float16 npz payloads are accepted (server casts to f32) and match the
    f32-payload predictions to f16 input precision — the documented
    half-size wire format for large bags (embeddings carry ~1e-3 features;
    f16's 10-bit mantissa loses less than bf16 compute already does)."""
    base, trainer = served
    rng = np.random.default_rng(2)
    wsi = rng.normal(size=(48, 1024)).astype(np.float32)
    omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]

    def post(wsi_arr):
        buf = io.BytesIO()
        np.savez(buf, wsi=wsi_arr, **{f"omic_{i}": o for i, o in enumerate(omics)})
        return _post(base + "/predict_npz", buf.getvalue(), "application/octet-stream")

    s32, b32 = post(wsi)
    s16, b16 = post(wsi.astype(np.float16))
    assert s32 == 200 and s16 == 200
    np.testing.assert_allclose(
        np.asarray(b16["risk"]), np.asarray(b32["risk"]), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(b16["hazards"]), np.asarray(b32["hazards"]), atol=2e-3
    )


def test_predict_batch_npz_matches_per_bag(served):
    """/predict_batch_npz scores N bags in fixed-shape bucketed batches
    (Predictor.predict_bags) and its rows match per-bag /predict_npz calls —
    the padded zero-weight rows in a partial batch must not leak into real
    rows, and output order must follow request order even though bags are
    regrouped by bucket internally."""
    base, trainer = served
    rng = np.random.default_rng(7)
    sizes = [48, 100, 30, 80, 60]  # spans both buckets, non-monotone order
    bags = [rng.normal(size=(m, 1024)).astype(np.float32) for m in sizes]
    omics = [
        [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
        for _ in sizes
    ]

    buf = io.BytesIO()
    np.savez(
        buf,
        **{f"wsi_{i}": b for i, b in enumerate(bags)},
        **{
            f"omic_{i}_{j}": o
            for i, os_ in enumerate(omics)
            for j, o in enumerate(os_)
        },
    )
    status, batch_out = _post(
        base + "/predict_batch_npz", buf.getvalue(), "application/octet-stream"
    )
    assert status == 200
    assert len(batch_out["risk"]) == len(sizes)

    for i in range(len(sizes)):
        buf = io.BytesIO()
        np.savez(
            buf, wsi=bags[i], **{f"omic_{j}": o for j, o in enumerate(omics[i])}
        )
        s, single = _post(
            base + "/predict_npz", buf.getvalue(), "application/octet-stream"
        )
        assert s == 200
        np.testing.assert_allclose(
            np.asarray(batch_out["risk"][i]),
            np.asarray(single["risk"][0]),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(batch_out["hazards"][i]),
            np.asarray(single["hazards"][0]),
            atol=1e-5,
        )


def test_predict_batch_npz_empty_is_400(served):
    base, _ = served
    buf = io.BytesIO()
    np.savez(buf, nothing=np.zeros(1))
    try:
        status, body = _post(
            base + "/predict_batch_npz", buf.getvalue(), "application/octet-stream"
        )
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    assert status == 400 and "error" in body


@pytest.fixture(scope="module")
def ge_served(tmp_path_factory):
    """A served Gene-Expression model (no omics in requests; class probs out)."""
    tmp = tmp_path_factory.mktemp("ge_server")
    csv, sig, patches = make_synthetic_cohort(
        str(tmp), n_patients=8, bag_lengths=(48, 80), n_genes=24,
        n_signatures=3, seed=1,
    )
    raw = synthetic_config_dict(csv, sig, patches)
    raw["model"].update(model_size="small", name="GeneExpr-NaCAGaT", gene="G000")
    raw["training"]["loss"] = "ce"
    raw["tpu"] = {"bag_buckets": [128], "batch_size": 4, "use_pallas": False}
    cfg = config_from_dict(raw)
    trainer = Trainer(cfg, verbose=False)
    server = make_server(Predictor(trainer), port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", trainer
    server.shutdown()


def test_ge_predict_npz_and_batch(ge_served):
    """GE models serve without omics: /predict_npz returns class probabilities
    (no survival keys), and /predict_batch_npz rows match per-bag calls."""
    base, trainer = ge_served
    assert trainer.ge_mode
    rng = np.random.default_rng(4)
    bags = [rng.normal(size=(m, 1024)).astype(np.float32) for m in (48, 100, 30)]

    buf = io.BytesIO()
    np.savez(buf, **{f"wsi_{i}": b for i, b in enumerate(bags)})
    status, batch_out = _post(
        base + "/predict_batch_npz", buf.getvalue(), "application/octet-stream"
    )
    assert status == 200
    assert "y" in batch_out and "risk" not in batch_out
    assert len(batch_out["y"]) == len(bags)

    for i, bag in enumerate(bags):
        buf = io.BytesIO()
        np.savez(buf, wsi=bag)
        s, single = _post(
            base + "/predict_npz", buf.getvalue(), "application/octet-stream"
        )
        assert s == 200 and "risk" not in single
        np.testing.assert_allclose(
            np.asarray(batch_out["y"][i]), np.asarray(single["y"][0]), atol=1e-5
        )
        np.testing.assert_allclose(np.sum(single["y"][0]), 1.0, rtol=1e-5)


def test_predict_npz_sorts_omics_numerically(tmp_path):
    """With 10+ signatures, lexicographic key order would feed omic_10 before
    omic_2 (no shape error — the fused omic stack pads to max width), making
    every prediction silently wrong. The handler must order numerically and
    match a direct predict_bag call."""
    csv, sig, patches = make_synthetic_cohort(
        str(tmp_path), n_patients=6, bag_lengths=(48,), n_genes=44,
        n_signatures=11, seed=9,
    )
    raw = synthetic_config_dict(csv, sig, patches)
    raw["model"]["model_size"] = "small"
    raw["tpu"] = {"bag_buckets": [64], "batch_size": 2, "use_pallas": False}
    trainer = Trainer(config_from_dict(raw), verbose=False)
    predictor = Predictor(trainer)
    assert len(trainer.omic_sizes) == 11
    server = make_server(predictor, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        rng = np.random.default_rng(10)
        wsi = rng.normal(size=(48, 1024)).astype(np.float32)
        omics = [
            rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes
        ]
        buf = io.BytesIO()
        np.savez(buf, wsi=wsi, **{f"omic_{i}": o for i, o in enumerate(omics)})
        status, body = _post(
            base + "/predict_npz", buf.getvalue(), "application/octet-stream"
        )
        assert status == 200
        direct = predictor.predict_bag(wsi, omics=omics)
        np.testing.assert_allclose(
            np.asarray(body["risk"]), np.asarray(direct["risk"]), atol=1e-5
        )
    finally:
        server.shutdown()


def test_concurrent_requests_all_correct(served):
    """ThreadingHTTPServer: concurrent clients parse in parallel, inference
    serializes on infer_lock — every response must match the serial answer."""
    import concurrent.futures

    base, trainer = served
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(8):
        wsi = rng.normal(size=(40 + i, 1024)).astype(np.float32)
        omics = [
            rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes
        ]
        buf = io.BytesIO()
        np.savez(buf, wsi=wsi, **{f"omic_{j}": o for j, o in enumerate(omics)})
        reqs.append((buf.getvalue(), wsi, omics))

    predictor = Predictor(trainer)
    want = [predictor.predict_bag(w, omics=o)["risk"] for _, w, o in reqs]

    def call(payload):
        return _post(base + "/predict_npz", payload, "application/octet-stream")

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(call, [p for p, _, _ in reqs]))
    for (status, body), w in zip(got, want):
        assert status == 200, body
        np.testing.assert_allclose(
            np.asarray(body["risk"]), np.asarray(w), atol=1e-5
        )


def test_http11_keepalive_reuses_connection(served):
    """protocol_version HTTP/1.1: two requests ride one persistent
    connection (every reply carries Content-Length)."""
    import http.client

    base, trainer = served
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        for _ in range(2):
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            assert resp.version == 11
            body = json.loads(resp.read())  # must drain to reuse the socket
            assert body["status"] == "ok"
        # a POST over the same connection still works
        rng = np.random.default_rng(12)
        wsi = rng.normal(size=(30, 1024)).astype(np.float32)
        omics = [
            rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes
        ]
        buf = io.BytesIO()
        np.savez(buf, wsi=wsi, **{f"omic_{j}": o for j, o in enumerate(omics)})
        conn.request(
            "POST", "/predict_npz", body=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"},
        )
        resp = conn.getresponse()
        assert resp.status == 200
        assert "risk" in json.loads(resp.read())
    finally:
        conn.close()


def test_chunked_transfer_encoding_rejected_and_closed(served):
    """HTTP/1.1 servers must not ignore chunked bodies: the handler rejects
    with 411 and CLOSES the connection (unread chunked bytes would otherwise
    be parsed as the next request on the keep-alive socket)."""
    import http.client

    base, _ = served
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.putrequest("POST", "/predict_npz")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        # one chunk the server never reads
        conn.send(b"5\r\nhello\r\n0\r\n\r\n")
        resp = conn.getresponse()
        assert resp.status == 411
        assert json.loads(resp.read())["error"].startswith("chunked")
        assert resp.will_close  # Connection: close — socket not reusable
    finally:
        conn.close()


def test_predictor_warmup_compiles_both_batch_shapes(served):
    """warmup() runs every (bucket, {1, batch_size}) eval program once; a
    subsequent predict_bag matches the normal path (dummy batches must not
    poison any state)."""
    base, trainer = served
    predictor = Predictor(trainer)
    warmed = predictor.warmup()
    assert (128, 1) in warmed and (128, trainer.batch_size) in warmed
    rng = np.random.default_rng(13)
    wsi = rng.normal(size=(50, 1024)).astype(np.float32)
    omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
    out = predictor.predict_bag(wsi, omics=omics)
    assert np.isfinite(np.asarray(out["risk"])).all()


def test_metrics_endpoint_counts_requests(served):
    """GET /metrics (Prometheus text): request counters by endpoint/status,
    inference seconds, and payload bytes all advance."""
    base, trainer = served
    rng = np.random.default_rng(14)
    wsi = rng.normal(size=(20, 1024)).astype(np.float32)
    omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
    buf = io.BytesIO()
    np.savez(buf, wsi=wsi, **{f"omic_{i}": o for i, o in enumerate(omics)})
    payload = buf.getvalue()
    status, _ = _post(base + "/predict_npz", payload, "application/octet-stream")
    assert status == 200
    # a client mistake lands in the 4xx bucket
    try:
        _post(base + "/predict", json.dumps({"wsi": [[1.0]]}).encode())
    except Exception:
        pass  # urllib raises on 4xx; the server still counted it

    with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    assert '# TYPE mpot_requests_total counter' in text

    def value(line_prefix):
        for line in text.splitlines():
            if line.startswith(line_prefix):
                return float(line.rsplit(" ", 1)[1])
        return 0.0

    assert value('mpot_requests_total{endpoint="/predict_npz",status="2xx"}') >= 1
    assert value('mpot_inference_seconds_total{endpoint="/predict_npz"}') > 0
    assert value('mpot_inference_count_total{endpoint="/predict_npz"}') >= 1
    assert value("mpot_request_bytes_total") >= len(payload)


# ------------------------------------------------------------ dynamic batching


@pytest.fixture(scope="module")
def batch_served(served):
    """A second server over the SAME trainer (shares its model) with
    server-side dynamic batching on: groups of up to 4 concurrent single-bag
    requests share one predict_bags dispatch."""
    _, trainer = served
    server = make_server(
        Predictor(trainer), port=0, dynamic_batch=4, batch_wait_ms=150.0
    )
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", trainer
    server.shutdown()
    server.server_close()  # also joins/closes the DynamicBatcher


def _npz_payload(wsi, omics):
    buf = io.BytesIO()
    np.savez(buf, wsi=wsi, **{f"omic_{i}": o for i, o in enumerate(omics)})
    return buf.getvalue()


def test_dynamic_batching_matches_per_bag_and_engages(batch_served):
    """8 concurrent single-bag requests on a dynamic_batch=4 server: every
    response matches the direct per-bag prediction, and the metrics prove
    requests were co-batched (fewer dispatches than bags)."""
    import concurrent.futures
    import urllib.request as _rq

    base, trainer = batch_served
    rng = np.random.default_rng(7)
    direct = Predictor(trainer)
    reqs = []
    for _ in range(8):
        wsi = rng.normal(size=(60, 1024)).astype(np.float32)
        omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
        reqs.append((wsi, omics))

    def call(i):
        return _post(
            base + "/predict_npz", _npz_payload(*reqs[i]), "application/octet-stream"
        )

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(call, range(8)))
    for (status, body), (wsi, omics) in zip(results, reqs):
        assert status == 200
        want = direct.predict_bag(wsi, omics=omics)
        np.testing.assert_allclose(
            np.asarray(body["risk"]), np.asarray(want["risk"]), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(body["hazards"]), np.asarray(want["hazards"]), atol=1e-5
        )
    with _rq.urlopen(base + "/metrics", timeout=30) as resp:
        metrics = resp.read().decode()
    bags = groups = None
    for line in metrics.splitlines():
        if line.startswith("mpot_dynamic_batch_bags_total"):
            bags = int(line.rsplit(" ", 1)[1])
        if line.startswith("mpot_dynamic_batch_groups_total"):
            groups = int(line.rsplit(" ", 1)[1])
    assert bags is not None and bags >= 8
    assert groups is not None and groups < bags, (groups, bags)


def test_dynamic_batching_isolates_bad_request(batch_served):
    """One request missing its omics inside a co-batched group gets its own
    400; co-riders still succeed with correct predictions."""
    import concurrent.futures

    base, trainer = batch_served
    rng = np.random.default_rng(8)
    good = []
    for _ in range(3):
        wsi = rng.normal(size=(48, 1024)).astype(np.float32)
        omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
        good.append(_npz_payload(wsi, omics))
    bad_buf = io.BytesIO()
    np.savez(bad_buf, wsi=rng.normal(size=(48, 1024)).astype(np.float32))
    payloads = good + [bad_buf.getvalue()]

    def call(p):
        try:
            return _post(base + "/predict_npz", p, "application/octet-stream")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        results = list(pool.map(call, payloads))
    statuses = [s for s, _ in results]
    assert statuses[:3] == [200, 200, 200], statuses
    assert statuses[3] == 400
    assert "error" in results[3][1]


def test_concurrent_stress_counts_every_request(batch_served):
    """24 clients at once (more than the cores), a tiny interpreter switch
    interval: single-bag and MC requests interleave on the dynamic-batch
    server; every answer is right and ServerMetrics loses no update."""
    import concurrent.futures
    import sys

    base, trainer = batch_served
    direct = Predictor(trainer)
    rng = np.random.default_rng(21)
    reqs = []
    for i in range(24):
        wsi = rng.normal(size=(30 + i, 1024)).astype(np.float32)
        omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
        reqs.append((wsi, omics, i % 3 == 0))

    def metrics():
        with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
        return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
                for line in text.splitlines() if not line.startswith("#")}

    def call(i):
        wsi, omics, mc = reqs[i]
        path = "/predict_npz?mc=3&mc_seed=1" if mc else "/predict_npz"
        return _post(base + path, _npz_payload(wsi, omics), "application/octet-stream")

    before = metrics()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=24) as pool:
            results = list(pool.map(call, range(24)))
    finally:
        sys.setswitchinterval(interval)
    for (status, body), (wsi, omics, mc) in zip(results, reqs):
        assert status == 200
        want = direct.predict_bag(wsi, omics=omics, mc_samples=3 if mc else 0, mc_seed=1)
        for k in ("risk", "risk_std") if mc else ("risk",):
            np.testing.assert_allclose(np.asarray(body[k]), np.asarray(want[k]), atol=1e-5)
    after = metrics()
    key = 'mpot_requests_total{endpoint="/predict_npz",status="2xx"}'
    assert after[key] - before.get(key, 0.0) == 24
    n_mc = sum(mc for _, _, mc in reqs)
    assert (after["mpot_dynamic_batch_bags_total"]
            - before.get("mpot_dynamic_batch_bags_total", 0.0)) == 24 - n_mc


def test_dynamic_batcher_close_drains_and_rejects():
    from multimodal_path_omic_tpu_torch.server import DynamicBatcher

    class _FakePred:
        def predict_bags(self, bags, omics=None):
            n = len(bags)
            return {"y": np.arange(n, dtype=np.float32)[:, None]}

    b = DynamicBatcher(_FakePred(), threading.Lock(), max_batch=4, max_wait_s=0.01)
    out = b.predict_bag(np.zeros((4, 8), np.float32))
    assert out["y"].shape == (1, 1)
    b.close()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        b.predict_bag(np.zeros((4, 8), np.float32))


def test_predict_mc_query(served):
    """?mc=N on the single-bag endpoints returns MC-dropout uncertainty
    fields matching Predictor.predict_bag(mc_samples=N) exactly (same seed),
    and bad mc values get a 400."""
    base, trainer = served
    rng = np.random.default_rng(9)
    wsi = rng.normal(size=(60, 1024)).astype(np.float32)
    omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
    status, body = _post(
        base + "/predict?mc=6&mc_seed=2",
        json.dumps({"wsi": wsi.tolist(), "omics": [o.tolist() for o in omics]}).encode(),
    )
    assert status == 200
    assert float(np.asarray(body["risk_std"])[0]) > 0.0
    direct = Predictor(trainer).predict_bag(wsi, omics=omics, mc_samples=6, mc_seed=2)
    np.testing.assert_allclose(
        np.asarray(body["risk_mean"]), np.asarray(direct["risk_mean"]), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(body["risk_std"]), np.asarray(direct["risk_std"]), atol=1e-5
    )
    # deterministic fields still present and unchanged
    plain = Predictor(trainer).predict_bag(wsi, omics=omics)
    np.testing.assert_allclose(
        np.asarray(body["risk"]), np.asarray(plain["risk"]), atol=1e-5
    )

    payload = json.dumps(
        {"wsi": wsi.tolist(), "omics": [o.tolist() for o in omics]}
    ).encode()
    for bad in ("mc=-1", "mc=bogus", "mc=9999"):
        try:
            status, body = _post(base + "/predict?" + bad, payload)
        except urllib.error.HTTPError as e:
            status, body = e.code, json.loads(e.read())
        assert status == 400 and "bad query" in body["error"]

    # the batch endpoint does not support MC: explicit 400, never a silent
    # deterministic response that reads as "mc honored"
    buf = io.BytesIO()
    np.savez(buf, wsi_0=wsi, **{f"omic_0_{j}": o for j, o in enumerate(omics)})
    try:
        status, body = _post(
            base + "/predict_batch_npz?mc=4", buf.getvalue(),
            content_type="application/octet-stream",
        )
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    assert status == 400 and "batch endpoint" in body["error"]


def test_server_serves_checkpoint_ensemble(tmp_path):
    """An ensemble Predictor behind the HTTP server: /predict returns the
    member-averaged outputs, and ?mc= on an ensemble is a clear 400 (the
    ensemble spread is the uncertainty)."""
    csv, sig, patches = make_synthetic_cohort(
        str(tmp_path), n_patients=8, bag_lengths=(48, 80), n_genes=24,
        n_signatures=3, seed=3,
    )
    raw = synthetic_config_dict(csv, sig, patches)
    raw["model"]["model_size"] = "small"
    raw["tpu"] = {"bag_buckets": [128], "batch_size": 4, "use_pallas": False}
    cfg = config_from_dict(raw)
    # two members with genuinely different params (different init seeds)
    t1 = Trainer(cfg, verbose=False)
    import copy

    cfg2 = copy.deepcopy(cfg)
    cfg2.training.seed = 9
    t2 = Trainer(cfg2, verbose=False)
    ens = Predictor(t1, param_sets=[_snapshot(t1), _snapshot(t2)])
    server = make_server(ens, port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        rng = np.random.default_rng(1)
        wsi = rng.normal(size=(60, 1024)).astype(np.float32)
        omics = [rng.normal(size=(s,)).astype(np.float32)
                 for s in t1.omic_sizes]
        payload = json.dumps(
            {"wsi": wsi.tolist(), "omics": [o.tolist() for o in omics]}
        ).encode()
        status, body = _post(base + "/predict", payload)
        assert status == 200
        direct = ens.predict_bag(wsi, omics=omics)
        np.testing.assert_allclose(
            np.asarray(body["risk"]), np.asarray(direct["risk"]), atol=1e-5
        )
        # and it really is the two-member average, not member 1 alone
        t1.model.load_state_dict(ens._param_sets[0])
        solo = Predictor(t1).predict_bag(wsi, omics=omics)
        assert abs(float(direct["risk"][0]) - float(solo["risk"][0])) > 1e-6
        # mc + ensemble -> 400
        try:
            _post(base + "/predict?mc=2", payload)
            assert False, "expected HTTP 400"
        except urllib.request.HTTPError as exc:
            assert exc.code == 400
    finally:
        server.shutdown()


# ------------------------------------------------------- against a JAX server


def test_port_server_matches_jax_server(tmp_path):
    """The same /predict_npz and /predict_batch_npz bodies to a JAX server
    and a port server holding the same weights (the JAX Trainer's, bridged)."""
    import jax

    from multimodal_path_omic_tpu.config import config_from_dict as jconfig_from_dict
    from multimodal_path_omic_tpu.serve import Predictor as JPredictor
    from multimodal_path_omic_tpu.server import make_server as jmake_server
    from multimodal_path_omic_tpu.train.trainer import Trainer as JTrainer
    from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params

    csv, sig, patches = make_synthetic_cohort(
        str(tmp_path), n_patients=8, bag_lengths=(48, 80), n_genes=24,
        n_signatures=3, seed=5,
    )
    raw = synthetic_config_dict(csv, sig, patches)
    raw["model"].update(model_size="small", name="NaCAGaT")
    raw["training"]["loss"] = "cesar"
    raw["tpu"] = {"bag_buckets": [64, 128], "batch_size": 4, "use_pallas": False}
    jt = JTrainer(jconfig_from_dict(raw), verbose=False)
    trainer = Trainer(config_from_dict(raw))
    load_jax_params(trainer.model, jax.tree_util.tree_map(np.asarray, jt.state.params))
    servers = [jmake_server(JPredictor(jt), port=0), make_server(Predictor(trainer), port=0)]
    for server in servers:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        bases = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
        rng = np.random.default_rng(6)
        sizes = [30, 100, 48, 120, 60]
        bags = [rng.normal(size=(m, 1024)).astype(np.float32) for m in sizes]
        omics = [[rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
                 for _ in sizes]
        single = _npz_payload(bags[1], omics[1])
        buf = io.BytesIO()
        np.savez(buf, **{f"wsi_{i}": b for i, b in enumerate(bags)},
                 **{f"omic_{i}_{j}": o for i, os_ in enumerate(omics) for j, o in enumerate(os_)})
        for path, body in (("/predict_npz", single), ("/predict_batch_npz", buf.getvalue())):
            (sj, ref), (sp, got) = (_post(b + path, body, "application/octet-stream")
                                    for b in bases)
            assert sj == sp == 200
            assert set(got) == set(ref)
            for k in ("risk", "hazards", "survs", "y"):
                np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), atol=5e-5,
                                           rtol=0)
            assert len(got["risk"]) == (1 if path == "/predict_npz" else len(sizes))
    finally:
        for server in servers:
            server.shutdown()


def test_server_main_serves_and_stops_on_sigterm(served, tmp_path):
    """``python -m multimodal_path_omic_tpu_torch.server`` (a config with
    ``device: cpu``, a checkpoint, ``--port 0 --warmup``) prints its address,
    answers, and on SIGTERM stops cleanly: ``server stopped``, exit 0."""
    import os
    import signal
    import subprocess
    import sys

    import yaml

    from multimodal_path_omic_tpu_torch.config import config_to_dict

    _, trainer = served
    cfg = copy.deepcopy(trainer.config)
    cfg.model.checkpoint_dir = str(tmp_path / "ck")
    path = str(tmp_path / "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f)
    trainer.config.model.checkpoint_dir = cfg.model.checkpoint_dir
    ckpt = trainer.save(0, 0.0, tag="served")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodal_path_omic_tpu_torch.server", "--config", path,
         "--checkpoint", ckpt, "--port", "0", "--warmup"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on "):
                break
        base = lines[-1].split()[-1]
        assert "warmed bucket 128" in "".join(lines)
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            assert json.loads(resp.read())["n_params"] == trainer.n_params
        rng = np.random.default_rng(15)
        wsi = rng.normal(size=(40, 1024)).astype(np.float32)
        omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
        status, body = _post(base + "/predict_npz", _npz_payload(wsi, omics),
                             "application/octet-stream")
        assert status == 200
        np.testing.assert_allclose(np.asarray(body["risk"]),
                                   Predictor(trainer).predict_bag(wsi, omics)["risk"], atol=1e-6)
        proc.send_signal(signal.SIGTERM)
        rest = proc.stdout.read()
        assert proc.wait(timeout=60) == 0
        assert rest.strip().splitlines()[-1] == "server stopped"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_server_main_refuses_bundles(served, tmp_path):
    """(Its name kept from when ``--bundle`` was refused.) ``server.main
    --bundle`` serves a deployment bundle (``deploy.export_model``) on the
    CPU: its ``/predict_npz`` answer equals the in-process Predictor's within
    1e-6, and ``--bundle`` with a checkpoint is a usage error."""
    from multimodal_path_omic_tpu_torch import server
    from multimodal_path_omic_tpu_torch.deploy import export_model

    _, trainer = served
    bundle = str(tmp_path / "bundle")
    export_model(trainer, bundle, batch_sizes=(1,), platforms=("cpu",))
    with pytest.raises(SystemExit):
        server.main(["--bundle", bundle, "--checkpoint", "ck.pt"])
    srv = server.make_bundle_server(bundle, port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["bundle"] == bundle and health["n_params"] == trainer.n_params
        rng = np.random.default_rng(16)
        wsi = rng.normal(size=(40, 1024)).astype(np.float32)
        omics = [rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
        status, body = _post(base + "/predict_npz", _npz_payload(wsi, omics),
                             "application/octet-stream")
        assert status == 200
        np.testing.assert_allclose(np.asarray(body["risk"]),
                                   Predictor(trainer).predict_bag(wsi, omics)["risk"], atol=1e-6)
    finally:
        srv.shutdown()
        srv.server_close()
