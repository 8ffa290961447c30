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

``--mesh_data D --mesh_model M`` serves on the ``D * M`` ranks that
``torchrun`` starts (``Predictor(mesh=...)``, as ``cli.predict`` does; a mesh
needs the live model, so ``--from_exported`` is refused).  Every rank loads
the checkpoint and warms every bucket; rank 0 alone binds ``--host/--port``
and runs the frontend, which hands each encoded chunk to the other ranks
(:class:`mgnns_tpu_torch.serving.MeshLink`); they bind nothing and run each
chunk with it.  ``server.shutdown()`` on rank 0, which SIGTERM or SIGINT
calls (what ``torchrun`` sends its ranks when it stops), tells them to stop,
and every rank returns 0.

Usage::

    python -m mgnns_tpu_torch.cli.serve --data_root_path data \\
        --checkpoint checkpoint/mgnns_tpu --text_only --port 8080
    python -m mgnns_tpu_torch.cli.serve --from_exported artifact --port 8080
    python -m torch.distributed.run --nproc_per_node 2 -m mgnns_tpu_torch.cli.serve \\
        --mesh_model 2 --data_root_path data --checkpoint checkpoint/mgnns_tpu --port 8080
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


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
    p.add_argument("--mesh_data", type=int, default=1,
                   help="split each batch over this many data positions (under torchrun; rank "
                        "0 answers HTTP and hands each chunk to the other ranks)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="split the gather tables and wide projections over this many ranks "
                        "(training's model-parallel rules; under torchrun)")
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


class Server(ThreadingHTTPServer):
    """The HTTP server; ``frontend`` is its :class:`BatchingFrontend`."""

    daemon_threads = True

    def shutdown(self) -> None:
        """Stop serving, then close the frontend: what is queued is
        answered, and on a mesh the other ranks are told to stop."""
        super().shutdown()
        self.frontend.close()


def load_predictor(args, mesh=None):
    """The warm Predictor of ``args`` (every batch bucket run once, before
    the first request); on ``mesh`` every rank calls it."""
    from mgnns_tpu_torch.serving import Predictor

    if args.from_exported:
        from mgnns_tpu_torch.export import load_exported

        predictor = load_exported(args.from_exported, image_root=args.image_root,
                                  image_backend=args.image_backend, strict_images=False,
                                  device=args.platform)
    else:
        if not args.checkpoint:
            raise SystemExit("--checkpoint is required (or pass --from_exported)")
        predictor = Predictor.from_engine_artifacts(
            args.data_root_path, args.checkpoint, text_only=args.text_only,
            pmi_phase=args.pmi_phase, image_backend=args.image_backend,
            image_root=args.image_root, max_batch=args.max_batch, strict_images=False,
            reference_ckpt=args.init_from_reference, device=args.platform, mesh=mesh)
    predictor.warm()
    return predictor


def make_server(args, predictor=None, link=None) -> Server:
    """The HTTP server for ``args`` (apart from :func:`main` so tests can
    drive it) around ``predictor`` (default: :func:`load_predictor` of
    ``args``); the frontend is running when it returns.  ``link``: rank 0's
    :class:`mgnns_tpu_torch.serving.MeshLink` on a mesh."""
    from mgnns_tpu_torch.serving import BatchingFrontend

    if predictor is None:
        predictor = load_predictor(args)
    frontend = BatchingFrontend(predictor, max_queue=args.max_queue, link=link)
    handler = make_handler(frontend, args.from_exported or args.checkpoint,
                           predictor.text_only, args.request_timeout)
    server = Server((args.host, args.port), handler)
    server.frontend = frontend
    return server


def _on_stop_signals(handler) -> None:
    """``handler`` for SIGTERM and SIGINT (signals reach the main thread only)."""
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)


def serve(server: Server) -> None:
    """Serve until ``server.shutdown()``, which SIGTERM and SIGINT call, and
    the frontend has closed."""
    # shutdown() waits for serve_forever to return: another thread calls it
    _on_stop_signals(lambda signum, frame: threading.Thread(target=server.shutdown).start())
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  (POST /predict, GET /healthz)", flush=True)
    server.serve_forever()
    server.frontend.close()  # returns once shutdown()'s close has finished
    server.server_close()


def main(argv=None) -> int:
    from mgnns_tpu_torch.cli.predict import make_mesh

    args = build_parser().parse_args(argv)
    mesh, owned = make_mesh(args, "mgnns_tpu_torch.cli.serve")
    if mesh is None:
        server = make_server(args)
        serve(server)
        server.frontend.predictor.close()
        return 0
    import torch.distributed as dist

    from mgnns_tpu_torch.serving import MeshLink

    try:
        predictor = load_predictor(args, mesh)
        try:
            link = MeshLink(predictor)
            if link.leader:
                server = make_server(args, predictor, link)
                serve(server)
                print(f"rank 0: stopped after {link.chunks} chunks", flush=True)
            else:
                # torchrun signals every rank when it stops: a follower waits
                # for rank 0's stop instead (if rank 0 is gone, the wait fails)
                _on_stop_signals(signal.SIG_IGN)
                chunks = link.follow()
                print(f"rank {dist.get_rank()}: stopped after {chunks} chunks", flush=True)
        finally:
            predictor.close()
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
