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

``--mesh_data D --mesh_model M`` serves on ``D * M`` ranks started by
``torchrun`` (``Predictor(mesh=...)``): every rank reads the input and runs
each chunk, the bucket splits over the data positions, the parameters over
the model ranks, and rank 0 writes the output.  A mesh needs the live model,
so it is refused with ``--from_exported`` and ``--export_model``::

    python -m torch.distributed.run --nproc_per_node 2 -m mgnns_tpu_torch.cli.predict \\
        --mesh_model 2 --data_root_path data --checkpoint checkpoint/mgnns_tpu \\
        --input posts.jsonl --output preds.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

# the JAX CLI's reason (mgnns_tpu/cli/predict.py:51-59), in this package's terms
LIVE_MODEL = ("--mesh_data/--mesh_model need the live model; the exported torch.export "
              "artifact is a single-device program")


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
    p.add_argument("--mesh_data", type=int, default=1,
                   help="split each batch over this many data positions (under torchrun)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="split the gather tables and wide projections over this many ranks "
                        "(training's model-parallel rules; under torchrun)")
    return p


def make_mesh(args: argparse.Namespace, module: str = "mgnns_tpu_torch.cli.predict"):
    """The ``(mesh_data, mesh_model)`` mesh over the ranks torchrun started,
    or None on one device; whether this process joined the group.
    ``module``: the CLI to name in the message that says how to start the
    ranks (``cli.serve`` calls this too)."""
    if args.mesh_data * args.mesh_model <= 1:
        return None, False
    if args.from_exported or getattr(args, "export_model", None):
        raise SystemExit(LIVE_MODEL)
    import torch.distributed as dist

    from mgnns_tpu_torch.parallel import multihost
    from mgnns_tpu_torch.parallel.mesh import create_mesh

    owned = not dist.is_initialized()
    ranks = args.mesh_data * args.mesh_model
    if not multihost.initialize(device=args.platform) or dist.get_world_size() != ranks:
        raise SystemExit(f"--mesh_data {args.mesh_data} x --mesh_model {args.mesh_model} needs "
                         f"a world of {ranks} ranks: start it with python -m "
                         f"torch.distributed.run --nproc_per_node {ranks} -m {module} ...")
    return create_mesh(args.mesh_data, args.mesh_model, device=args.platform), owned


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not (args.input or args.export_model):
        raise SystemExit("--input is required (or pass --export_model)")
    mesh, owned = make_mesh(args)
    try:
        _predict(args, mesh)
    finally:
        if owned:
            import torch.distributed as dist

            dist.destroy_process_group()


def _predict(args: argparse.Namespace, mesh) -> None:
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
            device=args.platform, mesh=mesh)
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
    if mesh is not None:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            return  # every rank holds the whole answer; rank 0 writes it
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
