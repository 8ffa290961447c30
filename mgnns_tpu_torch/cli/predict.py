"""Prediction CLI of the port: classify raw (text, image) posts with a model
the training CLI saved (``mgnns_tpu/cli/predict.py``).

Input: a JSONL of records with at least a ``text`` field (``image`` and
``id`` optional); output: one JSON line per record, ``{"id", "label",
"label_id", "probs"}``, in input order.  ``--platform`` is ``cuda`` (the
default, which raises without a card) or ``cpu``.

``--export_model <dir>`` writes the loaded model as a serving artifact
(:mod:`mgnns_tpu_torch.export`) and, without ``--input``, stops there;
``--from_exported <dir>`` serves such an artifact in place of a checkpoint,
with no ``--data_root_path`` or ``--checkpoint``.

Examples::

    python -m mgnns_tpu_torch.cli.predict --data_root_path data \\
        --checkpoint checkpoint/mgnns_tpu --text_only \\
        --input posts.jsonl --output preds.jsonl
    python -m mgnns_tpu_torch.cli.predict --data_root_path data \\
        --checkpoint checkpoint/mgnns_tpu --text_only --export_model artifact
    python -m mgnns_tpu_torch.cli.predict --from_exported artifact \\
        --input posts.jsonl

Not taken yet, rejected by name: ``--mesh_data`` / ``--mesh_model`` above 1
(multi-device, ``ROADMAP.md`` queue 1 item 6).
"""

from __future__ import annotations

import argparse
import json
import sys

MULTI_DEVICE = "multi-device serving waits for ROADMAP.md queue 1 item 6"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MGNNS prediction (PyTorch port)")
    p.add_argument("--data_root_path", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory of the training CLI (with its preproc files)")
    p.add_argument("--from_exported", default=None,
                   help="serve a torch.export artifact directory (see --export_model); "
                        "--data_root_path/--checkpoint are then not needed")
    p.add_argument("--export_model", default=None,
                   help="write a serving artifact (exported program + weights + preproc) "
                        "to this directory and exit; --input is then not needed")
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
        ("--mesh_data", args.mesh_data != 1, MULTI_DEVICE),
        ("--mesh_model", args.mesh_model != 1, MULTI_DEVICE),
    )
    return [f"{flag}: {why}" for flag, on, why in checks if on]


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    rejected = unported_flags(args)
    if rejected:
        raise SystemExit("not supported by the PyTorch port:\n  " + "\n  ".join(rejected))
    if not (args.input or args.export_model):
        raise SystemExit("--input is required (or pass --export_model)")
    if args.from_exported:
        from mgnns_tpu_torch.export import load_exported

        predictor = load_exported(args.from_exported, image_root=args.image_root,
                                  image_backend=args.image_backend, device=args.platform)
    else:
        if not (args.data_root_path and args.checkpoint):
            raise SystemExit("--data_root_path and --checkpoint are required "
                             "(or pass --from_exported)")
        from mgnns_tpu_torch.serving import Predictor

        predictor = Predictor.from_engine_artifacts(
            args.data_root_path, args.checkpoint, text_only=args.text_only,
            pmi_phase=args.pmi_phase, image_backend=args.image_backend,
            image_root=args.image_root, max_batch=args.max_batch, step=args.step,
            device=args.platform)
    try:
        if args.export_model:
            from mgnns_tpu_torch.export import export_predictor

            export_predictor(predictor, args.export_model)
            print(f"exported serving artifact to {args.export_model}")
            if not args.input:
                return
        with open(args.input) as f:
            records = [json.loads(line) for line in f if line.strip()]
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
