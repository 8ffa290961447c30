"""Prediction CLI of the port: classify raw (text, image) posts with a model
the training CLI saved (``mgnns_tpu/cli/predict.py``).

Input: a JSONL of records with at least a ``text`` field (``image`` and
``id`` optional); output: one JSON line per record, ``{"id", "label",
"label_id", "probs"}``, in input order.  ``--platform`` is ``cuda`` (the
default, which raises without a card) or ``cpu``.

Example::

    python -m mgnns_tpu_torch.cli.predict --data_root_path data \\
        --checkpoint checkpoint/mgnns_tpu --text_only \\
        --input posts.jsonl --output preds.jsonl

Not taken yet, each rejected by name: ``--export_model`` and
``--from_exported`` (serving artifacts through ``torch.export``,
``ROADMAP.md`` queue 1 item 4) and ``--mesh_data`` / ``--mesh_model`` above
1 (multi-device, item 6).
"""

from __future__ import annotations

import argparse
import json
import sys

EXPORT = "serving artifacts through torch.export wait for ROADMAP.md queue 1 item 4"
MULTI_DEVICE = "multi-device serving waits for ROADMAP.md queue 1 item 6"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MGNNS prediction (PyTorch port)")
    p.add_argument("--data_root_path", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory of the training CLI (with its preproc files)")
    p.add_argument("--from_exported", default=None, help="rejected: item 4")
    p.add_argument("--export_model", default=None, help="rejected: item 4")
    p.add_argument("--input", default=None, help="JSONL of {'text', 'image'?, 'id'?}")
    p.add_argument("--output", default=None, help="output JSONL (default stdout)")
    p.add_argument("--text_only", action="store_true")
    p.add_argument("--pmi_phase", default="train")
    p.add_argument("--image_backend", default="pil", choices=["pil", "synthetic"])
    p.add_argument("--image_root", default=".")
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--step", type=int, default=None, help="checkpoint step (default latest)")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; 'cuda' raises when no card is present")
    p.add_argument("--mesh_data", type=int, default=1, help="rejected above 1: item 6")
    p.add_argument("--mesh_model", type=int, default=1, help="rejected above 1: item 6")
    return p


def unported_flags(args: argparse.Namespace) -> list[str]:
    """One message for each flag set in ``args`` that the port rejects,
    naming the ``ROADMAP.md`` item that brings it."""
    checks = (
        ("--export_model", getattr(args, "export_model", None) is not None, EXPORT),
        ("--from_exported", args.from_exported is not None, EXPORT),
        ("--mesh_data", args.mesh_data != 1, MULTI_DEVICE),
        ("--mesh_model", args.mesh_model != 1, MULTI_DEVICE),
    )
    return [f"{flag}: {why}" for flag, on, why in checks if on]


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    rejected = unported_flags(args)
    if rejected:
        raise SystemExit("not supported by the PyTorch port:\n  " + "\n  ".join(rejected))
    if not (args.data_root_path and args.checkpoint):
        raise SystemExit("--data_root_path and --checkpoint are required")
    if not args.input:
        raise SystemExit("--input is required")
    from mgnns_tpu_torch.serving import Predictor

    predictor = Predictor.from_engine_artifacts(
        args.data_root_path, args.checkpoint, text_only=args.text_only,
        pmi_phase=args.pmi_phase, image_backend=args.image_backend,
        image_root=args.image_root, max_batch=args.max_batch, step=args.step,
        device=args.platform)
    with open(args.input) as f:
        records = [json.loads(line) for line in f if line.strip()]
    try:
        results = predictor.predict(records)
    finally:
        predictor.close()
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for rec, res in zip(records, results):
            out.write(json.dumps({"id": rec.get("id"), **res}) + "\n")
    finally:
        if args.output:
            out.close()
            print(f"wrote {args.output} ({len(results)} predictions)")


if __name__ == "__main__":
    main()
