"""Model serving on the GPU: a published archive behind a micro-batching HTTP server.

Counterpart of ``recnext_tpu/serve.py`` with the same HTTP surface
(torchserve-compatible paths):

    GET  /ping                 -> {"status": "Healthy"}
    GET  /models/<name>        -> model meta + serving stats
    POST /predictions/<name>   -> body = JPEG/PNG bytes -> top-k JSON

Requests are queued, and one worker thread coalesces them into batches padded to
``max_batch``, so every forward has the same shape. The model is BN-fused, in
bf16, of the M family (each RecConv2d mixer one launch of the RecConv2d kernel),
the A family (each RecAttn2d mixer one launch of the linear-attention kernel) or
the L family (each block's attention, a RecAttn2d or a variant-3 LinearAttention,
one launch of the linear-attention kernel; its RepVGGDW one fused depthwise conv);
the kernel library its family launches is built before the first request. The M and
A families run through the packed executor (``models/packed_infer.py``) at
``default_groups(cfg, max_batch)``, as the JAX server does, unless ``packed=False``;
``GET /models/<name>`` reports it and the groups.

CLI:
    python -m recnext_tpu_torch.serve --archive published/ --model recnext_m1 --port 8080
    python -m recnext_tpu_torch.serve --check http://127.0.0.1:8080 --model recnext_m1 \
        --image cat.jpg --archive published/   # server-vs-direct parity check
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from recnext_tpu_torch.data.transforms import EvalTransform
from recnext_tpu_torch.device import resolve_device
from recnext_tpu_torch.export import load_published
from recnext_tpu_torch.models.packed_infer import PackedRecNext, default_groups
from recnext_tpu_torch.models.registry import create_model, get_config


class ServingModel:
    """A published archive loaded as a fused model on one device.

    ``predict(batch)`` pads (n, 3, S, S) to ``max_batch`` rows, runs one forward,
    and returns fp32 softmax probabilities for the real rows only. ``packed``: None
    packs the M and A families (``models/packed_infer.py:PackedRecNext`` at
    ``default_groups(cfg, max_batch)``, built once); False runs the fused model as it
    is. ``self.groups`` holds the per-stage factors, or None unpacked.
    """

    def __init__(self, archive: str, model_name: str, *,
                 max_batch: int = 8, input_size: int = 224,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None, packed: Optional[bool] = None,
                 cfg_overrides: Optional[Dict[str, Any]] = None):
        self.device = resolve_device(device)
        self.model_name = model_name
        self.max_batch = int(max_batch)
        self.input_size = int(input_size)
        self.dtype = dtype
        self.cfg = get_config(model_name, **(cfg_overrides or {}))
        self.transform = EvalTransform(size=self.input_size)
        self.model = create_model(model_name, fused=True, device=self.device, dtype=dtype,
                                  **(cfg_overrides or {}))
        self.model.load_state_dict(load_published(model_name, archive), strict=True)
        if packed is None:
            packed = self.cfg.family in ("m", "a")
        self.packed = bool(packed and self.cfg.family in ("m", "a"))
        self.groups = default_groups(self.cfg, self.max_batch) if self.packed else None
        self.forward = (PackedRecNext(self.model, self.groups) if self.packed
                        else self.model)
        if self.device.type == "cuda":
            # build the family's kernel now, not inside the first request
            if self.cfg.family == "m":
                from recnext_tpu_torch.ops.cuda.recconv import load_library
            else:  # the A and the L family: both run their attention through K2
                from recnext_tpu_torch.ops.cuda.linear_attention import load_library
            load_library()
        self._lock = threading.Lock()
        self.requests_served = 0
        self.batches_run = 0

    def warmup(self) -> None:
        self.predict(np.zeros((self.max_batch, 3, self.input_size, self.input_size),
                              np.float32))

    def preprocess(self, data: bytes) -> np.ndarray:
        from PIL import Image

        return self.transform(Image.open(io.BytesIO(data)))

    def predict(self, batch: np.ndarray) -> np.ndarray:
        n = batch.shape[0]
        want = (3, self.input_size, self.input_size)
        if not 0 < n <= self.max_batch or tuple(batch.shape[1:]) != want:
            raise ValueError(f"batch of shape {batch.shape}: expected (n, {want[0]}, "
                             f"{want[1]}, {want[2]}) with 0 < n <= {self.max_batch}")
        # inference_mode is thread-local: enter it here, in the calling thread
        with torch.inference_mode():
            x = torch.zeros((self.max_batch,) + want, dtype=self.dtype, device=self.device)
            x[:n] = torch.from_numpy(np.asarray(batch, np.float32)).to(x.device, x.dtype)
            probs = torch.softmax(self.forward(x).float(), dim=-1)[:n].cpu().numpy()
        with self._lock:
            self.batches_run += 1
            self.requests_served += n
        return probs


class MicroBatcher:
    """Queue requests; ONE worker thread coalesces them into ``max_batch`` batches.
    ``window_ms`` is how long the worker waits to fill a batch after the first
    request arrives (latency/throughput knob)."""

    def __init__(self, model: ServingModel, window_ms: float = 5.0):
        self.model = model
        self.window_s = window_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, arr: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        done = threading.Event()
        slot: Dict[str, Any] = {}
        self._q.put((arr, slot, done))
        if not done.wait(timeout):
            raise TimeoutError("inference timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.monotonic() + self.window_s
            while len(items) < self.model.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                batch = np.stack([arr for arr, _, _ in items])
                probs = self.model.predict(batch)
                for (_, slot, done), row in zip(items, probs):
                    slot["result"] = row
                    done.set()
            except Exception as e:  # the worker keeps serving; every waiter hears why
                for _, slot, done in items:
                    slot["error"] = repr(e)
                    done.set()


def topk_json(probs: np.ndarray, k: int = 5) -> Dict[str, Any]:
    idx = np.argsort(probs)[::-1][:k]
    return {"topk": [{"class_id": int(i), "score": float(probs[i])} for i in idx]}


def make_server(model: ServingModel, host: str = "127.0.0.1", port: int = 8080,
                *, window_ms: float = 5.0, topk: int = 5) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``.serve_forever()`` to run.
    The batcher is attached as ``server.batcher`` (close it on shutdown)."""
    batcher = MicroBatcher(model, window_ms=window_ms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats live in /models/<name>
            pass

        def _json(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/ping":
                self._json(200, {"status": "Healthy"})
            elif self.path == f"/models/{model.model_name}":
                self._json(200, {
                    "model": model.model_name, "family": model.cfg.family,
                    "input_size": model.input_size, "max_batch": model.max_batch,
                    "packed": model.packed,
                    "groups": model.groups,
                    "device": str(model.device),
                    "num_classes": model.cfg.num_classes,
                    "requests_served": model.requests_served,
                    "batches_run": model.batches_run,
                })
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != f"/predictions/{model.model_name}":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            try:
                arr = model.preprocess(data)
            except Exception as e:
                self._json(400, {"error": f"bad image: {e!r}"})
                return
            try:
                probs = batcher.submit(arr)
            except Exception as e:
                self._json(500, {"error": repr(e)})
                return
            self._json(200, topk_json(probs, k=topk))

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.batcher = batcher  # type: ignore[attr-defined]
    return srv


def check_server(addr: str, model: ServingModel, image_path: str,
                 atol: float = 1e-3) -> bool:
    """Server-vs-direct parity: POST the image, compare the returned top-k against
    a direct predict() on the same bytes."""
    import urllib.request

    data = Path(image_path).read_bytes()
    req = urllib.request.Request(
        f"{addr}/predictions/{model.model_name}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        got = json.loads(r.read())
    direct = topk_json(model.predict(model.preprocess(data)[None])[0])
    ok = (got["topk"][0]["class_id"] == direct["topk"][0]["class_id"] and
          abs(got["topk"][0]["score"] - direct["topk"][0]["score"]) < atol)
    print(f"server  {got['topk'][:2]}")
    print(f"direct  {direct['topk'][:2]}")
    print("PARITY OK" if ok else "PARITY MISMATCH")
    return ok


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("recnext_tpu_torch model server")
    p.add_argument("--archive", required=True,
                   help="published archive dir (export.publish_fused output)")
    p.add_argument("--model", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--window-ms", type=float, default=5.0)
    p.add_argument("--no-packed", action="store_true",
                   help="run the fused model as it is, not through the packed executor")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain path in f32)")
    p.add_argument("--check", default="",
                   help="http://host:port: run the server-vs-direct parity check "
                        "against a running server instead of serving")
    p.add_argument("--image", default="", help="image for --check")
    args = p.parse_args(argv)

    if torch.device(args.device or "cuda").type == "cuda":
        from recnext_tpu_torch.utils.watchdog import require_devices

        require_devices(metric="serve")  # a deadline on the first touch of the GPU
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = ServingModel(args.archive, args.model, max_batch=args.max_batch,
                         input_size=args.input_size, dtype=dtype, device=device,
                         packed=False if args.no_packed else None)
    if args.check:
        raise SystemExit(0 if check_server(args.check, model, args.image) else 1)

    model.warmup()
    srv = make_server(model, args.host, args.port,
                      window_ms=args.window_ms, topk=args.topk)
    print(f"serving {args.model} on http://{args.host}:{srv.server_address[1]} "
          f"({device}, {dtype}, packed {model.groups})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.batcher.close()


if __name__ == "__main__":
    main()
