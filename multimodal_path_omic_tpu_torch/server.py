"""Minimal production scoring server, stdlib HTTP
(``multimodal_path_omic_tpu/server.py``, the same endpoints and wire
contract, on the port's ``serve.Predictor``).

The reference's only inference surface is an offline loop that prints to
stdout (reference: mcat/main.py:158-183). For deployment this module serves
the trained model over HTTP on top of ``serve.Predictor`` (bucketed, padded,
fixed-shape batches on the GPU, or the CPU when the config says
``device: cpu``):

    python -m multimodal_path_omic_tpu_torch.server --config cfg.yaml \
        --checkpoint <ckpt> --port 8008
    python -m multimodal_path_omic_tpu_torch.server --bundle <dir> --port 8008

``--bundle`` serves a deployment bundle (``deploy.py``, ``cli
export-model``) behind the same endpoints, without a config, a checkpoint
or the model's code (``make_bundle_server``).

Endpoints:

* ``GET /healthz`` — ``{"status": "ok", "model": ..., "n_params": ...}``
* ``GET /metrics`` — Prometheus text format: request counts by endpoint and
  status class, inference-latency sum/count (per endpoint), payload bytes.
* ``POST /predict`` — body: JSON ``{"wsi": [[...]], "omics": [[...], ...]}``
  (wsi [M, D] patch embeddings; omics = per-signature vectors for survival
  models, omitted for GE). Response: hazards/survs/risk/y (survival) or
  class probabilities (GE).
* ``POST /predict_npz`` — body: an ``.npz`` payload with ``wsi`` and
  ``omic_0..omic_{k-1}`` arrays (binary path for real embedding sizes —
  a 20k x 1024 f32 bag is ~80 MB as JSON but 80 MB raw). float16 ``wsi``
  payloads are accepted (cast to f32 on receipt) — half the wire bytes.
* ``POST /predict_batch_npz`` — body: an ``.npz`` with ``wsi_0..wsi_{n-1}``
  (and, for survival models, ``omic_{i}_{j}`` per bag i / signature j).
  Scores all n bags through fixed-shape bucketed batches
  (``Predictor.predict_bags``) — one HTTP round-trip and one device dispatch
  per batch_size bags instead of one per bag; response arrays are
  row-aligned with the request order.

The single-bag endpoints accept ``?mc=N&mc_seed=S`` for MC-dropout
predictive uncertainty: N stochastic forwards, one after another, add
risk_mean/risk_std/... fields to the response (serve.Predictor
``mc_samples``). MC requests bypass the dynamic batcher.

Connections are handled on threads (payload read + npz parse + JSON
serialization overlap device compute); INFERENCE itself is serialized by a
lock: one device, one stream, and the kernels' launch counters and the MC
generators are touched by one thread at a time. ``--warmup`` builds the
kernels and runs every bucket before the first request. Under concurrent single-bag load,
``--dynamic-batch N`` co-batches up to N in-flight requests into one
``predict_bags`` dispatch (DynamicBatcher) so the device scores a batch per
round-trip instead of a bag — the server-side counterpart of the client-side
``/predict_batch_npz`` endpoint.

On a mesh (``tpu.data_axis`` x ``tpu.seq_axis`` > 1, under torchrun: one
process a GPU) every rank builds ``Predictor.from_config`` on the mesh and
the server is the counterpart of the JAX package's one controller over
every device. Rank 0 binds the HTTP server, answers ``/healthz`` and
``/metrics`` alone and keeps the inference lock and the dynamic batcher;
its predictor is a :class:`MeshFront`, which checks each request's arrays
before anything crosses to the other ranks (a malformed body is a 400 with
no collective entered), then broadcasts an op header and the arrays
(``parallel/comm.py::broadcast_request``) and makes the same
``predict_bag`` / ``predict_bags`` call as every other rank, each on its
rows and patches. The other ranks run :func:`follow`: they wait for the
next op, run it and wait again, until rank 0 broadcasts a stop. On SIGTERM
(torchrun signals every rank) rank 0 drains the HTTP loop and broadcasts
the stop; the others ignore the signal until the stop arrives, and every
rank exits 0:

    torchrun --nproc-per-node 2 -m multimodal_path_omic_tpu_torch.cli serve \\
        --config mesh.yaml --checkpoint <ckpt> --port 8008   # tpu.data_axis: 2

``--bundle`` serves on one device, as the JAX bundle does.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np


class ServerMetrics:
    """Thread-safe counters exposed at GET /metrics (Prometheus text format).

    One instance per bound server (like infer_lock): request counts by
    (endpoint, status class), inference seconds sum/count per endpoint, and
    received payload bytes.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = defaultdict(int)  # (endpoint, "2xx"/"4xx"/"5xx")
        self.infer_seconds = defaultdict(float)  # endpoint -> total secs
        self.infer_count = defaultdict(int)
        self.bytes_in = 0
        self.batch_groups = 0  # dynamic-batch dispatches
        self.batch_bags = 0  # requests scored through those dispatches

    def observe(self, endpoint: str, code: int, infer_s: float, n_bytes: int):
        with self._lock:
            self.requests[(endpoint, f"{code // 100}xx")] += 1
            self.bytes_in += n_bytes
            if infer_s > 0:
                self.infer_seconds[endpoint] += infer_s
                self.infer_count[endpoint] += 1

    def observe_batch(self, n_bags: int):
        """One dynamic-batch dispatch of ``n_bags`` co-batched requests."""
        with self._lock:
            self.batch_groups += 1
            self.batch_bags += n_bags

    def render(self) -> str:
        with self._lock:
            lines = [
                "# TYPE mpot_requests_total counter",
            ]
            for (ep, cls), n in sorted(self.requests.items()):
                lines.append(
                    f'mpot_requests_total{{endpoint="{ep}",status="{cls}"}} {n}'
                )
            lines.append("# TYPE mpot_inference_seconds_total counter")
            for ep, s in sorted(self.infer_seconds.items()):
                lines.append(
                    f'mpot_inference_seconds_total{{endpoint="{ep}"}} {s:.6f}'
                )
            lines.append("# TYPE mpot_inference_count_total counter")
            for ep, n in sorted(self.infer_count.items()):
                lines.append(f'mpot_inference_count_total{{endpoint="{ep}"}} {n}')
            lines.append("# TYPE mpot_request_bytes_total counter")
            lines.append(f"mpot_request_bytes_total {self.bytes_in}")
            lines.append("# TYPE mpot_dynamic_batch_groups_total counter")
            lines.append(f"mpot_dynamic_batch_groups_total {self.batch_groups}")
            lines.append("# TYPE mpot_dynamic_batch_bags_total counter")
            lines.append(f"mpot_dynamic_batch_bags_total {self.batch_bags}")
        return "\n".join(lines) + "\n"


class DynamicBatcher:
    """Server-side dynamic batching for the single-bag endpoints.

    Concurrent ``/predict`` / ``/predict_npz`` requests enqueue their bag and
    block; one dispatcher thread drains up to ``max_batch`` pending requests
    into a single ``predict_bags`` call — the same fixed-shape bucketed
    batches the dataset path scores, so co-batched requests share one
    device dispatch instead of serializing behind the inference lock one bag
    at a time. Batching is adaptive: an idle server adds at most
    ``max_wait_s`` of latency waiting for co-riders, and while the device
    scores one group the next group accumulates for free.

    Per-request error isolation: a failing group (e.g. one request missing
    its omics) is retried bag-by-bag so co-riders still succeed and only the
    bad request gets its error.
    """

    def __init__(
        self,
        predictor,
        infer_lock: threading.Lock,
        max_batch: int = 8,
        max_wait_s: float = 0.005,
        metrics: Optional[ServerMetrics] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._pred = predictor
        self._infer_lock = infer_lock
        self._max_batch = int(max_batch)
        self._max_wait = float(max_wait_s)
        self._metrics = metrics
        self._cv = threading.Condition()
        self._pending: list = []
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="dynamic-batcher", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        """Stop the dispatcher; pending requests are still drained first."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def predict_bag(self, bag, omics=None) -> Dict[str, Any]:
        """Enqueue one bag and block for its result (same contract as
        ``Predictor.predict_bag``: leading batch-1 dim on every output)."""
        item = {
            "bag": bag,
            "omics": omics,
            "event": threading.Event(),
            "result": None,
            "error": None,
        }
        with self._cv:
            if not self._running:
                raise RuntimeError("DynamicBatcher is closed")
            self._pending.append(item)
            self._cv.notify_all()
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._pending:
                    self._cv.wait()
                if not self._pending:
                    return  # closed and drained
                if self._max_wait > 0 and len(self._pending) < self._max_batch:
                    # brief accumulation window for co-riders (bounded; a
                    # full group dispatches immediately)
                    self._cv.wait(self._max_wait)
                group = self._pending[: self._max_batch]
                del self._pending[: len(group)]
            self._dispatch(group)

    def _score(self, items):
        bags = [g["bag"] for g in items]
        omics = [g["omics"] for g in items]
        with self._infer_lock:
            return self._pred.predict_bags(
                bags, omics=omics if any(o is not None for o in omics) else None
            )

    def _dispatch(self, group) -> None:
        try:
            out = self._score(group)
            for i, g in enumerate(group):
                g["result"] = {k: np.asarray(v)[i : i + 1] for k, v in out.items()}
        except Exception as exc:
            if len(group) == 1:
                group[0]["error"] = exc
            else:
                # isolate the failing request: score each alone so co-riders
                # aren't failed by one bad payload
                for g in group:
                    try:
                        out = self._score([g])
                        g["result"] = {
                            k: np.asarray(v)[0:1] for k, v in out.items()
                        }
                    except Exception as solo_exc:
                        g["error"] = solo_exc
        finally:
            if self._metrics is not None:
                self._metrics.observe_batch(len(group))
            for g in group:
                g["event"].set()


class PredictHandler(BaseHTTPRequestHandler):
    # HTTP/1.1: persistent connections (every _reply sends Content-Length,
    # which keep-alive requires) — clients reusing a connection skip the
    # per-request TCP handshake
    protocol_version = "HTTP/1.1"
    # reap idle persistent connections: thread-per-connection + keep-alive
    # would otherwise let every idle client pin a thread forever (a socket
    # timeout mid-request closes the connection via handle_one_request)
    timeout = 120
    predictor = None  # injected by make_server
    info: Dict[str, Any] = {}
    # one device, one program stream: requests parse concurrently but score
    # one at a time (class attribute — shared by every handler instance of a
    # bound subclass; each make_server call binds a fresh lock)
    infer_lock = threading.Lock()
    metrics = ServerMetrics()
    # optional cross-request DynamicBatcher (make_server --dynamic-batch):
    # single-bag endpoints route through it instead of the lock directly
    batcher: Optional[DynamicBatcher] = None

    # quieter logs
    def log_message(self, fmt, *args):  # pragma: no cover
        pass

    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        if self.command == "POST":
            # counted before the body goes out: a client that has read its
            # reply and then asks /metrics finds this request counted
            from urllib.parse import urlsplit

            self.metrics.observe(
                urlsplit(self.path).path, code, self._infer_seconds,
                int(self.headers.get("Content-Length") or 0),
            )
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            # tell the client too (set BEFORE _reply, e.g. chunked rejection)
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"status": "ok", **self.info})
        elif self.path == "/metrics":
            body = self.metrics.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": "unknown path"})

    def do_POST(self):
        self._infer_seconds = 0.0
        self._handle_post()  # every path replies through _reply, which counts

    def _handle_post(self):
        from urllib.parse import parse_qs, urlsplit

        parts = urlsplit(self.path)
        path = parts.path
        if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
            # not decoded here; without closing, the unread chunked body
            # would be parsed as the NEXT request on the keep-alive socket
            self.close_connection = True
            self._reply(411, {"error": "chunked bodies unsupported; send Content-Length"})
            return
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n)
        # query validation AFTER draining the body: replying while the client
        # is still streaming a multi-MB payload breaks its send (EPIPE)
        try:
            q = parse_qs(parts.query)
            mc = int(q.get("mc", ["0"])[0])
            mc_seed = int(q.get("mc_seed", ["0"])[0])
            if not 0 <= mc <= 256:
                raise ValueError("mc must be in [0, 256]")
        except ValueError as exc:
            self._reply(400, {"error": f"bad query: {exc}"})
            return
        try:
            if path == "/predict":
                req = json.loads(raw)
                wsi = np.asarray(req["wsi"], np.float32)
                omics = (
                    [np.asarray(o, np.float32) for o in req["omics"]]
                    if "omics" in req
                    else None
                )
            elif path == "/predict_npz":
                with np.load(io.BytesIO(raw)) as z:
                    wsi = np.asarray(z["wsi"], np.float32)
                    # numeric sort: lexicographic would put omic_10 before
                    # omic_2 and silently feed signatures to wrong encoders
                    # (the fused omic stack pads to max width, no shape error)
                    keys = sorted(
                        (k for k in z.files if k.startswith("omic_")),
                        key=lambda k: int(k.split("_")[1]),
                    )
                    omics = [np.asarray(z[k], np.float32) for k in keys] or None
            elif path == "/predict_batch_npz":
                if mc > 0:
                    # silently ignoring a validated parameter would read as
                    # "honored"; MC is single-bag only (predict_bags has no
                    # uncertainty path)
                    self._reply(400, {"error": "mc unsupported on the batch endpoint"})
                    return
                with np.load(io.BytesIO(raw)) as z:
                    n_bags = sum(1 for k in z.files if k.startswith("wsi_"))
                    if n_bags == 0:
                        raise ValueError("no wsi_<i> arrays in payload")
                    bags = [np.asarray(z[f"wsi_{i}"], np.float32) for i in range(n_bags)]
                    omics_b = None
                    if any(k.startswith("omic_") for k in z.files):
                        n_sig = sum(
                            1 for k in z.files if k.startswith("omic_0_")
                        )
                        omics_b = [
                            [np.asarray(z[f"omic_{i}_{j}"], np.float32) for j in range(n_sig)]
                            for i in range(n_bags)
                        ]
                try:
                    with self.infer_lock:
                        t0 = time.perf_counter()
                        out = self.predictor.predict_bags(bags, omics=omics_b)
                        self._infer_seconds = time.perf_counter() - t0
                except ValueError as exc:
                    self._reply(400, {"error": f"bad request: {exc}"})
                    return
                except Exception as exc:
                    self._reply(500, {"error": f"inference failed: {exc}"})
                    return
                self._reply(200, {k: np.asarray(v).tolist() for k, v in out.items()})
                return
            else:
                self._reply(404, {"error": "unknown path"})
                return
        except Exception as exc:
            self._reply(400, {"error": f"bad request: {exc}"})
            return
        try:
            t0 = time.perf_counter()
            if mc > 0:
                # MC-dropout uncertainty (?mc=N&mc_seed=S): N stochastic
                # forwards (serve.Predictor). Bypasses the
                # dynamic batcher — MC requests don't co-batch.
                with self.infer_lock:
                    out = self.predictor.predict_bag(
                        wsi, omics=omics, mc_samples=mc, mc_seed=mc_seed
                    )
            elif self.batcher is not None:
                # the batcher serializes device work on infer_lock itself;
                # co-arriving requests share one predict_bags dispatch
                out = self.batcher.predict_bag(wsi, omics=omics)
            else:
                with self.infer_lock:
                    out = self.predictor.predict_bag(wsi, omics=omics)
            self._infer_seconds = time.perf_counter() - t0
        except ValueError as exc:
            # client mistake (e.g. survival model without omics) — same
            # 400 contract as the batch endpoint
            self._reply(400, {"error": f"bad request: {exc}"})
            return
        except Exception as exc:
            self._reply(500, {"error": f"inference failed: {exc}"})
            return
        self._reply(200, {k: np.asarray(v).tolist() for k, v in out.items()})


class _PredictServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that also stops its DynamicBatcher on close."""

    def server_close(self):
        super().server_close()
        batcher = getattr(self.RequestHandlerClass, "batcher", None)
        if batcher is not None:
            batcher.close()


def make_server(
    predictor,
    port: int = 0,
    host: str = "127.0.0.1",
    dynamic_batch: int = 0,
    batch_wait_ms: float = 5.0,
) -> ThreadingHTTPServer:
    """Build (not start) a threaded HTTP server bound to ``host:port``
    (0 = ephemeral); connections parse on threads, inference serializes on
    the handler's infer_lock. ``dynamic_batch`` > 1 co-batches concurrent
    single-bag requests into one device dispatch (DynamicBatcher), waiting at
    most ``batch_wait_ms`` for co-riders."""
    info = {"model": predictor.model_name, "n_params": predictor.n_params,
            "omic_sizes": list(predictor.omic_sizes)}
    return _bind_server(predictor, info, port, host, dynamic_batch, batch_wait_ms)


def _bind_server(predictor, info, port, host, dynamic_batch, batch_wait_ms):
    lock = threading.Lock()
    metrics = ServerMetrics()
    batcher = (
        DynamicBatcher(predictor, lock, max_batch=dynamic_batch,
                       max_wait_s=batch_wait_ms / 1000.0, metrics=metrics)
        if dynamic_batch and dynamic_batch > 1
        else None
    )
    handler = type(
        "BoundPredictHandler",
        (PredictHandler,),
        {"predictor": predictor, "infer_lock": lock, "metrics": metrics,
         "batcher": batcher, "info": info},
    )
    return _PredictServer((host, port), handler)


class _BundlePredictor:
    """``deploy.ExportedModel`` behind the handler's Predictor contract
    (``predict_bag`` keeps a leading batch-1 axis, as ``serve.Predictor``)."""

    def __init__(self, exported):
        self._m = exported

    def predict_bag(self, bag, omics=None):
        out = self._m.predict_bag(bag, omics)
        return {k: np.asarray(v)[None] for k, v in out.items()}

    def predict_bags(self, bags, omics=None):
        return self._m.predict_bags(bags, omics)


def make_bundle_server(bundle_dir: str, port: int = 0, host: str = "127.0.0.1",
                       dynamic_batch: int = 0, batch_wait_ms: float = 5.0,
                       device=None) -> ThreadingHTTPServer:
    """Serve a deployment bundle (``deploy.export_model``) with
    :func:`make_server`'s endpoints and wire contract (dynamic batching
    included), without a config, a checkpoint or the model's code; on
    ``device`` (None: the GPU)."""
    from multimodal_path_omic_tpu_torch.deploy import load_exported

    exported = load_exported(bundle_dir, device=device)
    man = exported.manifest
    info = {"model": man["model"], "n_params": man.get("n_params"),
            "omic_sizes": list(man["omic_sizes"]), "bundle": bundle_dir,
            "buckets": list(man["buckets"]), "batch_sizes": list(man["batch_sizes"])}
    return _bind_server(_BundlePredictor(exported), info, port, host, dynamic_batch,
                        batch_wait_ms)


_STOP = "stop"


def _check_request(predictor, bags, omics) -> None:
    """Raise ``ValueError`` for a request ``predictor`` cannot score: a bag
    that is not [patches, wsi_dim], a survival model's bag without omics, or
    omics that do not match the signature widths. A mesh server checks this
    on rank 0 before any rank enters a collective."""
    for i, bag in enumerate(bags):
        if np.ndim(bag) != 2 or np.shape(bag)[1] != predictor.wsi_dim:
            raise ValueError(f"bag {i} must be [patches, {predictor.wsi_dim}], got "
                             f"{np.shape(bag)}")
    if predictor.ge_mode:
        return
    if omics is None or len(omics) != len(bags) or any(o is None for o in omics):
        raise ValueError("survival models need one omics signature list per bag")
    sizes = tuple(predictor.omic_sizes)
    for i, sig in enumerate(omics):
        got = tuple(int(np.size(v)) for v in sig)
        if got != sizes:
            raise ValueError(f"bag {i}: omics widths {got} != the model's {sizes}")


def _run(predictor, header, arrays):
    """One broadcast op on ``predictor``: the same call on every rank."""
    n, n_sig = header["n_bags"], header["n_sig"]
    bags = arrays[:n]
    sig = arrays[n:]
    omics = None if n_sig == 0 else [sig[i * n_sig:(i + 1) * n_sig] for i in range(n)]
    if header["op"] == "bag":
        return predictor.predict_bag(bags[0], None if omics is None else omics[0],
                                     mc_samples=header["mc"], mc_seed=header["mc_seed"])
    return predictor.predict_bags(bags, omics)


class MeshFront:
    """Rank 0's predictor on a mesh: checks a request, hands it to every
    rank (an op header and the arrays, ``comm.broadcast_request``), then
    makes its own call, as :func:`follow` makes it on the other ranks.
    Everything else (``model_name``, ``n_params``, ``omic_sizes``, ...) is
    the wrapped :class:`~multimodal_path_omic_tpu_torch.serve.Predictor`'s.
    Calls are serialized by the server's inference lock, so one op is in
    flight at a time."""

    def __init__(self, predictor):
        self._p = predictor
        self._group = predictor.mesh.world
        self.stopped = False

    def __getattr__(self, name):
        return getattr(self._p, name)

    def _op(self, op, bags, omics, mc=0, mc_seed=0):
        from multimodal_path_omic_tpu_torch.parallel import comm

        if self.stopped:
            raise RuntimeError("the mesh server has stopped")
        bags = [np.asarray(b, np.float32) for b in bags]
        omics = None if self._p.ge_mode else omics
        _check_request(self._p, bags, omics)
        sig = [] if omics is None else [np.asarray(v, np.float32).reshape(-1)
                                        for o in omics for v in o]
        header = {"op": op, "n_bags": len(bags), "n_sig": 0 if omics is None else len(omics[0]),
                  "mc": int(mc), "mc_seed": int(mc_seed)}
        header, arrays = comm.broadcast_request(header, bags + sig, self._group)
        return _run(self._p, header, arrays)

    def predict_bag(self, bag, omics=None, mc_samples: int = 0, mc_seed: int = 0):
        return self._op("bag", [bag], None if omics is None else [omics], mc_samples, mc_seed)

    def predict_bags(self, bags, omics=None):
        if not len(bags):
            return {}
        return self._op("bags", bags, omics)

    def stop(self) -> None:
        """Send every other rank out of :func:`follow` (once)."""
        from multimodal_path_omic_tpu_torch.parallel import comm

        if not self.stopped:
            self.stopped = True
            comm.broadcast_request({"op": _STOP}, [], self._group)


def follow(predictor) -> int:
    """A mesh rank other than 0: run each op rank 0 broadcasts on
    ``predictor`` until the stop. SIGTERM and SIGINT are ignored meanwhile
    (torchrun signals every rank; rank 0 drains and sends the stop). A
    failed op is rank 0's to answer; this rank waits for the next. Returns
    0."""
    import signal

    from multimodal_path_omic_tpu_torch.parallel import comm

    group = predictor.mesh.world
    saved = {sig: signal.signal(sig, signal.SIG_IGN) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        while True:
            header, arrays = comm.broadcast_request(None, [], group)
            if header["op"] == _STOP:
                return 0
            try:
                _run(predictor, header, arrays)
            except Exception:  # the same failure answers the client on rank 0
                pass
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="multimodal_path_omic_tpu_torch.server")
    ap.add_argument("--config", help="YAML config (with --checkpoint)")
    ap.add_argument("--checkpoint", action="append",
                    help="the port's checkpoint; repeat to serve a "
                    "checkpoint ENSEMBLE (member-averaged outputs)")
    ap.add_argument("--torch-checkpoint", help="reference .pt checkpoint to load")
    ap.add_argument("--bundle", help="deployment bundle directory (cli export-model); serves "
                    "without a config, a checkpoint or the model's code")
    ap.add_argument("--device", help="with --bundle: where it runs (default the GPU; cpu)")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument(
        "--warmup", action="store_true",
        help="build the kernels and run every bucket before accepting traffic",
    )
    ap.add_argument(
        "--dynamic-batch", type=int, default=0,
        help="co-batch up to N concurrent single-bag requests into one "
        "device dispatch (0/1 disables); raises aggregate throughput under "
        "concurrent load at the cost of up to --batch-wait-ms added latency",
    )
    ap.add_argument(
        "--batch-wait-ms", type=float, default=5.0,
        help="max time a lone request waits for co-riders (--dynamic-batch)",
    )
    args = ap.parse_args(argv)
    if bool(args.bundle) == bool(args.config):
        ap.error("exactly one of --config or --bundle is required")
    if args.bundle and (args.checkpoint or args.torch_checkpoint):
        # serving the bundle's weights while the operator believes the
        # checkpoint loaded would be a wrong-model deployment
        ap.error("--bundle carries its own weights; drop --checkpoint/--torch-checkpoint "
                 "(or serve via --config)")
    t0 = time.perf_counter()
    front = None
    if args.bundle:
        server = make_bundle_server(args.bundle, port=args.port, host=args.host,
                                    dynamic_batch=args.dynamic_batch,
                                    batch_wait_ms=args.batch_wait_ms, device=args.device)
        if args.warmup:
            server.RequestHandlerClass.predictor._m.warmup(verbose=True)
            print(f"warmup: {time.perf_counter() - t0:.2f} s", flush=True)
    else:
        from multimodal_path_omic_tpu_torch.config import load_config
        from multimodal_path_omic_tpu_torch.serve import Predictor

        predictor = Predictor.from_config(
            load_config(args.config),
            checkpoint=args.checkpoint,
            torch_checkpoint=args.torch_checkpoint,
        )
        mesh = predictor.mesh
        lead = mesh is None or mesh.rank == 0
        if args.warmup:  # every rank: the warm-up's steps are collective on a mesh
            predictor.warmup(verbose=lead)
            if lead:
                print(f"warmup: {time.perf_counter() - t0:.2f} s", flush=True)
        if not lead:
            return follow(predictor)
        if mesh is not None:
            front = predictor = MeshFront(predictor)
        server = make_server(
            predictor, port=args.port, host=args.host,
            dynamic_batch=args.dynamic_batch, batch_wait_ms=args.batch_wait_ms,
        )
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    # graceful shutdown: SIGTERM (the normal orchestrator stop signal) drains
    # the accept loop instead of killing mid-response. shutdown() must run on
    # ANOTHER thread — the handler runs on the serve_forever thread, and
    # shutdown() blocks until serve_forever exits (deadlock otherwise).
    import signal

    def _stop(*_):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # serve_forever returning only stops ACCEPTING; daemon handler
        # threads still in flight would be killed at interpreter exit.
        # server_close() joins them (block_on_close) and closes the socket —
        # without it, "graceful" still reset mid-response clients.
        server.server_close()
        if front is not None:  # after the op in flight, send the other ranks out
            with server.RequestHandlerClass.infer_lock:
                front.stop()
    print("server stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
