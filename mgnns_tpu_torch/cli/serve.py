"""HTTP serving of the port: a stdlib server around
:class:`mgnns_tpu_torch.serving.BatchingFrontend` (``mgnns_tpu/cli/serve.py``).

Endpoints:

- ``GET  /healthz`` -> ``{"status": "ok", "model": ..., "text_only": ...,
  "requests": N, "queue_depth": N, "inflight_chunks": N,
  "latency_ms": {"p50", "p99", "max"}}``
- ``POST /predict`` -> body ``{"records": [{"id": ..., "text": ..., "image":
  ...}, ...]}`` or a bare list; returns ``{"predictions": [...]}`` in input
  order, each with ``label``, ``label_id`` and per-class ``probs``.

Errors: 400 for a body that is not JSON or holds no records, 404 for an
unknown path, 503 when the request queue is full, 504 when a request waits
longer than ``--request_timeout``, 500 for anything else.

A threaded HTTP front accepts requests concurrently; one device thread of the
frontend runs every forward.  Every batch bucket runs once (``warm``) before
the server listens.  ``--platform`` is ``cuda`` (the default, which raises
without a card) or ``cpu``.

``--from_exported <dir>`` serves an artifact of ``cli.predict
--export_model`` (:mod:`mgnns_tpu_torch.export`) in place of a checkpoint.

Usage::

    python -m mgnns_tpu_torch.cli.serve --data_root_path data \\
        --checkpoint checkpoint/mgnns_tpu --text_only --port 8080
    python -m mgnns_tpu_torch.cli.serve --from_exported artifact --port 8080
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mgnns_tpu_torch.cli.predict import unported_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MGNNS HTTP serving (PyTorch port)")
    p.add_argument("--data_root_path", type=str, default="data")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint directory of the training CLI (with its preproc files)")
    p.add_argument("--from_exported", type=str, default=None,
                   help="serve a torch.export artifact directory (cli.predict --export_model) "
                        "instead of a checkpoint: no model code or tracing at start-up")
    p.add_argument("--text_only", action="store_true")
    p.add_argument("--pmi_phase", type=str, default="train")
    p.add_argument("--image_backend", type=str, default="pil", choices=["pil", "synthetic"])
    p.add_argument("--image_root", type=str, default=".")
    p.add_argument("--init_from_reference", type=str, default=None,
                   help="serve weights imported from a reference .pth[.tar] instead of the "
                        "port's checkpoint in --checkpoint (fusion model only)")
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_queue", type=int, default=256,
                   help="request-queue bound; a full queue answers 503")
    p.add_argument("--request_timeout", type=float, default=60.0,
                   help="seconds a request may wait for its batch")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--platform", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; 'cuda' raises when no card is present")
    p.add_argument("--mesh_data", type=int, default=1, help="rejected above 1: item 6b")
    p.add_argument("--mesh_model", type=int, default=1, help="rejected above 1: item 6b")
    return p


def make_handler(frontend, model_name: str, text_only: bool, request_timeout: float):
    from mgnns_tpu_torch.serving import BatchingFrontend

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": model_name, "text_only": text_only,
                                 **frontend.stats()})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                records = payload if isinstance(payload, list) else payload.get("records", [])
                if not isinstance(records, list) or not records:
                    self._send(400, {"error": "body must be {'records': [...]} or a list"})
                    return
                out = frontend.submit(records, timeout=request_timeout)
                self._send(200, {"predictions": out})
            except json.JSONDecodeError as e:
                self._send(400, {"error": f"bad json: {e}"})
            except BatchingFrontend.Busy as e:
                self._send(503, {"error": str(e)})
            except TimeoutError as e:
                self._send(504, {"error": str(e)})
            except Exception as e:  # answer and keep serving
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):  # no per-request log lines
            pass

    return Handler


def make_server(args) -> ThreadingHTTPServer:
    """The HTTP server for ``args`` (apart from :func:`main` so tests can
    drive it); the predictor is warm and the frontend running when it
    returns.  ``server.frontend`` is the :class:`BatchingFrontend`."""
    rejected = unported_flags(args)
    if rejected:
        raise SystemExit("not supported by the PyTorch port:\n  " + "\n  ".join(rejected))
    from mgnns_tpu_torch.serving import BatchingFrontend, Predictor

    if args.from_exported:
        from mgnns_tpu_torch.export import load_exported

        predictor = load_exported(args.from_exported, image_root=args.image_root,
                                  image_backend=args.image_backend, strict_images=False,
                                  device=args.platform)
        model_name = args.from_exported
    else:
        if not args.checkpoint:
            raise SystemExit("--checkpoint is required (or pass --from_exported)")
        predictor = Predictor.from_engine_artifacts(
            args.data_root_path, args.checkpoint, text_only=args.text_only,
            pmi_phase=args.pmi_phase, image_backend=args.image_backend,
            image_root=args.image_root, max_batch=args.max_batch, strict_images=False,
            reference_ckpt=args.init_from_reference, device=args.platform)
        model_name = args.checkpoint
    predictor.warm()  # every batch bucket once, before the first request
    frontend = BatchingFrontend(predictor, max_queue=args.max_queue)
    handler = make_handler(frontend, model_name, predictor.text_only, args.request_timeout)
    server = ThreadingHTTPServer((args.host, args.port), handler)
    server.daemon_threads = True
    server.frontend = frontend
    return server


def main(argv=None) -> None:
    server = make_server(build_parser().parse_args(argv))
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  (POST /predict, GET /healthz)")
    server.serve_forever()


if __name__ == "__main__":
    main()
