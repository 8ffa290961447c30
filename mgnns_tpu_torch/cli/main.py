"""Training/eval CLI of the port, with the JAX package's flags
(``mgnns_tpu/cli/main.py``; reference ``Tumblr_Multi_GCN_Multihead_Att.py``).

Every flag of the JAX CLI parses here, with its name and default, and does
one of three things:

- acts as in the JAX package: the model, data, optimizer, precision
  (``--compute_dtype``, ``--fp16``), checkpoint, result and resume flags,
  reference checkpoints included (``--init_from_reference``,
  ``--resume <x.pth[.tar]>``, ``--include_dead_modules``), the device
  tables (``--device_text``, ``--device_images`` under the greedy
  ``--device_images_budget_gb``, ``--cache_eval_batches``; a split held
  wholly in tables trains and evaluates as captured steps on the card) and
  ``--profile_dir`` (a ``torch.profiler`` trace of the first epoch);
- is parsed and ignored, as the JAX package ignores it or because it only
  changes how XLA lowers the maths: ``--unroll_trunks``, ``--stem_s2d``,
  ``--device_ids``, ``--momentum``, ``--accumulation_steps``,
  ``--fp16_opt_level``, ``--start-epoch``;
- is rejected with a message that names its counterpart in the port or the
  ``ROADMAP.md`` item that brings it (:func:`unported_flags`).

``--platform`` picks the device: ``cuda`` (the default, which raises without
a card) or ``cpu``.

``--mesh_data N`` trains on N ranks, one process per card started by
``torchrun``, as the JAX CLI trains on a data axis of N devices: the global
batch ``-b`` splits over the ranks (each runs ``b / N`` rows of it), each
split gets an input plan per rank (:mod:`mgnns_tpu_torch.parallel.input`),
and rank 0 writes the checkpoints, the preprocessing and the result files.
``--mesh_model M`` also splits the parameters over M ranks by
:mod:`mgnns_tpu_torch.parallel.sharding`'s rules (the text-only model's for
``--text_only``), as the JAX CLI's ``--mesh_model`` does; the world must
then be ``N * M`` ranks, the ranks of one data position consecutive.  The
backend follows ``--platform`` (NCCL on ``cuda``, gloo on ``cpu``).
``--multihost`` also joins the process group, and on several ``torchrun``
nodes each node reads only its contiguous slice of every split.

Examples (text-only slice on the CPU; two ranks on two cards; two data
positions of two model ranks on four cards)::

    python -m mgnns_tpu_torch.cli.main --platform cpu --data_root_path data \\
        --pmi_phase val --train_phase val --text_only --epochs 2 -b 64
    python -m torch.distributed.run --nproc_per_node 2 -m mgnns_tpu_torch.cli.main \\
        --mesh_data 2 --data_root_path data --epochs 2 -b 32
    python -m torch.distributed.run --nproc_per_node 4 -m mgnns_tpu_torch.cli.main \\
        --mesh_data 2 --mesh_model 2 --data_root_path data --epochs 2 -b 32
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch

_FUSED_SEGMENTS = ("splits the JAX package's whole-epoch XLA program when it does not compile; "
                   "its counterpart in the port is one captured train step replayed once per "
                   "batch (mgnns_tpu_torch/engine/graphs.py), which has no epoch program to split")
_TPU_COMPILER = ("a TPU compiler flag; its counterpart in the port is the nvcc build of the "
                 "kernels (mgnns_tpu_torch/kernels/build.py), which takes no flags")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MGNNS training (PyTorch port)")
    # reference flags (Tumblr_...py:12-81)
    p.add_argument("--dataset", type=str, default="tumblr")
    p.add_argument("--data_root_path", type=str, default="data")
    p.add_argument("--bidirectional", type=bool, default=True)
    p.add_argument("--hidden_size", type=int, default=150)
    p.add_argument("--emb_size", type=int, default=300)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("-dropout", "--dropout", type=float, default=0.5)
    p.add_argument("-emb_type", "--emb_type", type=str, default="glove",
                   choices=["random", "glove", "glove200d", "glove300d", "fasttext300d"],
                   help="anything but 'random' reads glove_embedding/glove_embedding_{k}.pkl "
                        "when present")
    p.add_argument("--stack_num", type=int, default=2)
    p.add_argument("--n_head", type=int, default=4)
    p.add_argument("--d_kv", type=int, default=128)
    p.add_argument("--is_regu", type=bool, default=False)
    p.add_argument("--text_min_count", type=int, default=5)
    p.add_argument("--window_size", type=int, default=6)
    p.add_argument("--ngram", type=int, default=4)
    p.add_argument("--min_cooccurence", type=int, default=2)
    p.add_argument("--image-size", "-i", dest="image_size", type=int, default=448)
    p.add_argument("-j", "--workers", type=int, default=4,
                   help="image-decode threads of each loader")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--epoch_step", type=int, nargs="+", default=[10])
    p.add_argument("--device_ids", type=int, nargs="+", default=[0], help="ignored")
    p.add_argument("--start-epoch", dest="start_epoch", type=int, default=0, help="ignored")
    p.add_argument("-b", "--batch-size", dest="batch_size", type=int, default=16)
    p.add_argument("--eval_batch_size", type=int, default=0,
                   help="batch size for val/test epochs (0 = same as train)")
    p.add_argument("--cache_eval_batches", action="store_true",
                   help="keep val/test batches on the device after their first epoch, within "
                        "what --device_images_budget_gb leaves")
    p.add_argument("--no_augmentation", action="store_true",
                   help="use eval transforms (Warp) for the train split too")
    p.add_argument("--device_images", action="store_true",
                   help="keep each split's pixels in a device table, train first, while they "
                        "fit --device_images_budget_gb")
    p.add_argument("--device_text", action="store_true",
                   help="keep each split's text tensors and labels in device tables")
    p.add_argument("--device_images_budget_gb", type=float, default=7.0,
                   help="device memory for pixel tables and cached eval batches")
    p.add_argument("--fused_segments", type=int, default=1,
                   help="rejected unless left at its default: see its message")
    p.add_argument("--val_limit", type=int, default=0,
                   help="evaluate only the first N val samples per epoch")
    p.add_argument("--lr", "--learning-rate", dest="lr", type=float, default=5e-5)
    p.add_argument("--lrp", "--learning-rate-pretrained", dest="lrp", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9, help="ignored")
    p.add_argument("--weight-decay", "--weight_decay", "--wd",
                   dest="weight_decay", type=float, default=1e-5)
    p.add_argument("--print-freq", "-p", dest="print_freq", type=int, default=10)
    p.add_argument("--resume", type=str, nargs="?", const="latest", default=None,
                   help="bare --resume: resume from this run's latest checkpoint; "
                        "--resume <dir>: resume the full train state from a directory of the "
                        "port's checkpoints; --resume <x.pth[.tar]>: import a reference "
                        "checkpoint's weights with a fresh optimizer (fusion model only)")
    p.add_argument("--object_trunk_ckpt", type=str, default=None,
                   help="torchvision-format ResNet-101 .pth[.tar] for the object trunk")
    p.add_argument("--place_trunk_ckpt", type=str, default=None,
                   help="Places365 ResNet-50 .pth[.tar] for the scene trunk; a 'module.' "
                        "prefix is stripped")
    p.add_argument("--init_from_reference", type=str, default=None,
                   help="initialize all weights from a reference-format .pth[.tar] (fusion "
                        "model only); the trunk checkpoints then override the trunks")
    p.add_argument("--include_dead_modules", action="store_true",
                   help="also build the reference modules its forward never runs, so "
                        "checkpoints round-trip to a strict reference load_state_dict")
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("--save_experiment_result_path", type=str, default="result/experiment_result")
    p.add_argument("--save_pred_result_path", type=str, default="result/pred_result")
    p.add_argument("--model_name", type=str, default="mgnns_tpu")
    p.add_argument("--save_model_path", type=str, default="checkpoint")
    p.add_argument("--object_t_value", type=float, default=0.4)
    p.add_argument("--place_t_value", type=float, default=0.3)
    p.add_argument("--num_labels", type=int, default=7)
    p.add_argument("--object_num_classes", type=int, default=80)
    p.add_argument("--place_num_classes", type=int, default=365)
    p.add_argument("--accumulation_steps", type=int, default=8,
                   help="ignored, as by the reference; see --grad_accumulation_steps")
    p.add_argument("--fp16", action="store_true", help="alias for --compute_dtype bfloat16")
    p.add_argument("--fp16_opt_level", type=str, default="O1", help="ignored")
    p.add_argument("--text_only", action="store_true", help="train the text-only slice")
    p.add_argument("--pmi_phase", type=str, default="train",
                   help="split whose texts build the PMI graph")
    p.add_argument("--train_phase", type=str, default="train")
    p.add_argument("--val_phase", type=str, default="val")
    p.add_argument("--test_phase", type=str, default="test")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="dtype of the ResNet trunks' convolutions; everything else and the "
                        "parameters stay float32")
    p.add_argument("--image_backend", type=str, default="synthetic", choices=["pil", "synthetic"])
    p.add_argument("--image_root", type=str, default=".")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel ranks: run under torchrun with this many processes")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel ranks per data position (the sharding rules of "
                        "mgnns_tpu_torch/parallel/sharding.py); run under torchrun with "
                        "--mesh_data x --mesh_model processes")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's process group; on several nodes each node loads "
                        "its own record slice (see mgnns_tpu_torch/parallel/multihost.py)")
    pg = p.add_mutually_exclusive_group()
    pg.add_argument("--use_pallas", dest="use_pallas", action="store_true", default=None,
                    help="rejected: the CUDA kernels always run on the card")
    pg.add_argument("--no_use_pallas", dest="use_pallas", action="store_false",
                    help="rejected: the CUDA kernels always run on the card")
    p.add_argument("--faithful_param_groups", action="store_true")
    p.add_argument("--limit_samples", type=int, default=0,
                   help="truncate each split (debug/smoke)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_to_keep", type=int, default=3)
    p.add_argument("--platform", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; 'cuda' raises when no card is present")
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--regu_weight", type=float, default=0.0,
                   help="weight of the head-diversity penalty when --is_regu")
    p.add_argument("--edges_init", type=str, default="ones", choices=["ones", "pmi"],
                   help="text-GCN edge-weight init: ones (Text_GCN.py:68) or PMI values (:72)")
    p.add_argument("--bn_mode", type=str, default="batch", choices=["batch", "frozen"],
                   help="'batch'=torch-faithful train-mode BatchNorm; 'frozen'=running stats")
    p.add_argument("--remat_trunks", action="store_true",
                   help="checkpoint the ResNet trunks; alias for --remat_policy trunk")
    p.add_argument("--remat_policy", type=str, default="none", choices=["none", "trunk", "block"])
    p.add_argument("--unroll_trunks", action="store_true", help="ignored (an XLA lowering choice)")
    p.add_argument("--freeze_trunks", action="store_true",
                   help="no trunk gradients, trunk parameters frozen")
    p.add_argument("--stem_s2d", action="store_true", help="ignored (an XLA lowering choice)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the first epoch's training here")
    p.add_argument("--metrics_path", type=str, default=None,
                   help="append one JSON line of train/val metrics per epoch")
    p.add_argument("--libtpu_init_args", type=str, default=None, help="rejected: TPU-only")
    p.add_argument("--perf_preset", action="store_true", help="rejected: TPU-only")
    return p


def unported_flags(args: argparse.Namespace) -> list[str]:
    """One message for each flag set in ``args`` that the port rejects, naming
    its counterpart or the ``ROADMAP.md`` item that brings it."""
    checks = (
        ("--fused_segments", args.fused_segments != 1, _FUSED_SEGMENTS),
        ("--use_pallas/--no_use_pallas", args.use_pallas is not None,
         "the edge-max kernels (K1, K2) always run on the card; their counterpart is "
         "mgnns_tpu_torch/kernels/edge_max.py, whose plain versions run only on CPU tensors"),
        ("--libtpu_init_args", args.libtpu_init_args is not None, _TPU_COMPILER),
        ("--perf_preset", args.perf_preset, _TPU_COMPILER),
    )
    return [f"{flag}: {why}" for flag, on, why in checks if on]


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    rejected = unported_flags(args)
    if rejected:
        raise SystemExit("not supported by the PyTorch port:\n  " + "\n  ".join(rejected))
    if args.text_only and (args.object_trunk_ckpt or args.place_trunk_ckpt
                           or args.init_from_reference):
        raise SystemExit("--object_trunk_ckpt/--place_trunk_ckpt/--init_from_reference need "
                         "the fusion model; drop --text_only")
    # args-only checks first, before the vocabulary, the graph and the datasets
    for name, b in (("-b/--batch_size", args.batch_size),
                    ("--eval_batch_size", args.eval_batch_size)):
        if b and b % args.mesh_data:
            raise SystemExit(f"{name}={b} must divide by --mesh_data={args.mesh_data} "
                             "(each rank runs its share of every batch)")
    import torch.distributed as dist

    from mgnns_tpu_torch.parallel import multihost

    owned = not dist.is_initialized()
    distributed = False
    ranks = args.mesh_data * args.mesh_model
    if args.multihost or ranks > 1:
        distributed = multihost.initialize(device=args.platform)
    world = dist.get_world_size() if distributed else 1
    if ranks != world:
        raise SystemExit(
            f"--mesh_data {args.mesh_data} x --mesh_model {args.mesh_model} needs a world of "
            f"{ranks} ranks, one per card, and this one has {world}: start it with python -m "
            f"torch.distributed.run --nproc_per_node {ranks} -m mgnns_tpu_torch.cli.main ...")
    try:
        return _main(args, distributed)
    finally:
        if distributed and owned:
            dist.destroy_process_group()


def _main(args: argparse.Namespace, distributed: bool) -> dict:
    from mgnns_tpu_torch.config import DataConfig, ModelConfig, TextGraphConfig
    from mgnns_tpu_torch.data.dataset import TumblrDataset, load_constants
    from mgnns_tpu_torch.data.loader import DeviceLoader
    from mgnns_tpu_torch.data.text import build_text_side, read_anno
    from mgnns_tpu_torch.engine.train import Engine
    from mgnns_tpu_torch.models.import_reference import (
        import_reference_state_dict, load_torch_state_dict,
    )
    from mgnns_tpu_torch.parallel import multihost
    from mgnns_tpu_torch.parallel.sharding import mgnns_param_rules, text_model_param_rules
    from mgnns_tpu_torch.serving import save_preproc
    from mgnns_tpu_torch.utils import resolve_device

    device = resolve_device(args.platform)
    mesh = None
    if distributed:
        from mgnns_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(data=args.mesh_data, model=args.mesh_model, device=device)
    rank0 = not distributed or torch.distributed.get_rank() == 0
    # several hosts: each reads its contiguous slice of every split
    hosts = multihost.process_count() if args.multihost else 1
    graph_cfg = TextGraphConfig(
        text_min_count=args.text_min_count, window_size=args.window_size,
        ngram=args.ngram, min_cooccurrence=args.min_cooccurence,
    )
    root = args.data_root_path
    data_cfg = DataConfig(
        data_root_path=root, dataset=args.dataset,
        object_inp_name=os.path.join(root, "glove/object_glove_word2vec.pkl"),
        place_inp_name=os.path.join(root, "glove/place_glove_word2vec.pkl"),
        label_glove_name=os.path.join(root, "tumblr_label_glove.pkl"),
        object_adj_file=os.path.join(root, "adj/tumblr_objects_adj.pkl"),
        place_adj_file=os.path.join(root, "adj/tumblr_resnet50_places_adj.pkl"),
        image_root=args.image_root, image_backend=args.image_backend,
    )

    vocab, graph, _ = build_text_side(root, graph_cfg, [], pmi_phase=args.pmi_phase)
    print(f"vocab={len(vocab)} pmi_edges={graph.num_edges - 1}")

    # pretrained vocab GloVe for the sequence embedding and the text-GCN
    # nodes (build it with `prepare pack-glove --kind vocab`)
    vocab_embedding = None
    if args.emb_type != "random":
        emb_path = os.path.join(root, "glove_embedding", f"glove_embedding_{args.text_min_count}.pkl")
        if os.path.exists(emb_path):
            with open(emb_path, "rb") as f:
                vocab_embedding = np.asarray(pickle.load(f), np.float32)
            print(f"loaded vocab embedding {vocab_embedding.shape} from {emb_path}")
        else:
            print(f"note: no pretrained embedding at {emb_path}; using random init")
    edge_weights = graph.initial_edge_weights(trainable_init_one=(args.edges_init == "ones"))

    # the preprocessing beside the checkpoints, so serving is self-contained
    with open(os.path.join(root, "label.json")) as f:
        label_map = json.load(f)
    ckpt_dir = os.path.join(args.save_model_path, args.model_name)
    if rank0:
        save_preproc(ckpt_dir, vocab, graph, label_map, graph_cfg)

    records: dict = {}
    datasets: dict = {}

    def make_ds(phase, train, limit=0):
        # identical (phase, transforms, limit) triples share one dataset
        if phase not in records:
            recs = read_anno(root, phase)
            records[phase] = recs[: args.limit_samples] if args.limit_samples else recs
        if limit >= len(records[phase]):
            limit = 0
        key = (phase, train, limit)
        if key not in datasets:
            recs = records[phase][:limit] if limit else records[phase]
            start, stop = 0, len(recs)
            if hosts > 1:
                start, stop, _ = multihost.process_batch_slice(len(recs), args.batch_size)
            datasets[key] = TumblrDataset(
                data_cfg, graph_cfg, phase, vocab, graph, image_size=args.image_size,
                train_transforms=train, records=recs[start:stop], global_len=len(recs),
                record_offset=start)
        return datasets[key]

    train_ds = make_ds(args.train_phase, not args.no_augmentation)
    val_ds = make_ds(args.val_phase, False, args.val_limit)
    test_ds = make_ds(args.test_phase, False)

    model_cfg = ModelConfig(
        num_labels=args.num_labels, vocab_size=len(vocab), emb_size=args.emb_size,
        hidden_size=args.hidden_size, num_layers=args.num_layers,
        bidirectional=args.bidirectional, dropout=args.dropout,
        stack_num=args.stack_num, n_head=args.n_head, d_kv=args.d_kv,
        is_regu=args.is_regu, object_num_classes=args.object_num_classes,
        place_num_classes=args.place_num_classes, object_t=args.object_t_value,
        place_t=args.place_t_value, image_size=args.image_size,
        edges_num=graph.num_edges,
        compute_dtype="bfloat16" if args.fp16 else args.compute_dtype,
        remat_trunks=args.remat_trunks, remat_policy=args.remat_policy, bn_mode=args.bn_mode,
        unroll_trunks=args.unroll_trunks, freeze_trunks=args.freeze_trunks,
        stem_s2d=args.stem_s2d,
    )

    if args.text_only:
        from mgnns_tpu_torch.models.text_only import text_model_apply, text_model_init

        params = text_model_init(len(vocab), args.num_labels, graph.num_edges, seed=args.seed,
                                 node_embedding=vocab_embedding, edge_weights=edge_weights,
                                 device=device)
        batch_stats: dict = {}

        def apply_fn(p, bs, batch, *, train, generator, axis=None, model=None):
            # no BatchNorm: the data axis reaches dropout through the generator
            return text_model_apply(p, batch, ngram=graph_cfg.ngram, dropout_rate=args.dropout,
                                    train=train, generator=generator, model=model), bs
    else:
        from mgnns_tpu_torch.models.mgnns import mgnns_apply, mgnns_init
        from mgnns_tpu_torch.nn.resnet import import_torch_state_dict

        consts_np = load_constants(data_cfg, object_t=args.object_t_value,
                                   place_t=args.place_t_value)
        params, batch_stats, consts = mgnns_init(
            model_cfg, num_edges=graph.num_edges,
            label_embedding=consts_np["label_embedding"],
            object_A=consts_np["object_A"], place_A=consts_np["place_A"],
            object_inp=consts_np["object_inp"], place_inp=consts_np["place_inp"],
            vocab_embedding=vocab_embedding, node_embedding=vocab_embedding,
            edge_weights=edge_weights, include_dead_modules=args.include_dead_modules,
            seed=args.seed, device=device)
        # --emb_type seeds the embedding tables at init, --init_from_reference
        # then replaces every weight, and the trunk checkpoints override the
        # trunks last (the JAX CLI's precedence)
        if args.init_from_reference:
            sd, _ = load_torch_state_dict(args.init_from_reference)
            params, batch_stats = import_reference_state_dict(
                sd, num_layers=args.num_layers, bidirectional=args.bidirectional,
                stack_num=args.stack_num, device=device)
            got_v = params["embedding"]["table"].shape[0]
            if got_v != len(vocab):
                raise SystemExit(
                    f"--init_from_reference vocab mismatch: checkpoint has {got_v} rows, this "
                    f"corpus/config has {len(vocab)} (check --text_min_count/--pmi_phase)")
            print(f"initialized all weights from {args.init_from_reference}")
        for side, ckpt_path, depth in (("object", args.object_trunk_ckpt, 101),
                                       ("place", args.place_trunk_ckpt, 50)):
            if ckpt_path:
                sd, _ = load_torch_state_dict(ckpt_path)
                params[f"{side}_trunk"], batch_stats[f"{side}_trunk"] = \
                    import_torch_state_dict(sd, depth)
                print(f"loaded {side} trunk (resnet{depth}) from {ckpt_path}")

        def apply_fn(p, bs, batch, *, train, generator, axis=None, model=None):
            logits, new_bs, aux = mgnns_apply(p, bs, consts, batch, cfg=model_cfg, train=train,
                                              generator=generator, axis=axis, model=model)
            return logits, new_bs, aux.get("head_diversity", 0.0)

    # on several ranks every split gets this rank's input plan per batch size;
    # one rank's batches are the global batches (the JAX CLI builds no mesh
    # at --mesh_data 1 either)
    plans: dict = {}

    def plan_for(ds, batch):
        if args.mesh_data == 1:
            return None
        from mgnns_tpu_torch.parallel.input import make_input_plan

        key = (id(ds), batch)
        if key not in plans:
            plans[key] = make_input_plan(
                args.mesh_data, len(ds), batch // hosts, n_global=ds.global_len,
                process_index=multihost.process_index() if hosts > 1 else 0,
                process_count=hosts)
        return plans[key]

    eval_batch = args.eval_batch_size or args.batch_size
    # the LR schedule's epoch counts applied optimizer steps
    train_plan = plan_for(train_ds, args.batch_size)
    train_batches = (train_plan.num_batches if train_plan is not None
                     else (len(train_ds) + args.batch_size - 1) // args.batch_size)
    engine = Engine(
        apply_fn, params, batch_stats,
        num_classes=args.num_labels, lr=args.lr, lrp=args.lrp,
        weight_decay=args.weight_decay,
        steps_per_epoch=max(1, train_batches // args.grad_accumulation_steps),
        epoch_step=args.epoch_step, faithful_param_groups=args.faithful_param_groups,
        accumulation_steps=args.grad_accumulation_steps,
        freeze_trunks=args.freeze_trunks and not args.text_only,
        aux_loss_weight=args.regu_weight, seed=args.seed, checkpoint_dir=ckpt_dir,
        max_to_keep=args.max_to_keep, device=device, mesh=mesh,
        param_sharding_rules=(text_model_param_rules() if args.text_only
                              else mgnns_param_rules()),
        heads=args.n_head,
    )

    # the greedy device-memory budget of the JAX CLI: pixel tables go to the
    # splits in order, train first (it is read every epoch), while they fit;
    # the splits past the budget stream their pixels, and cached eval batches
    # share what is left.  The budget is per card: under a mesh a table
    # holds this rank's rows
    input_budget = args.device_images_budget_gb * 1e9
    device_images_for: dict = {}
    if args.device_images:
        for ds, batch in ((train_ds, args.batch_size), (val_ds, eval_batch),
                          (test_ds, eval_batch)):
            if id(ds) in device_images_for:
                continue
            plan = plan_for(ds, batch)
            rows = plan.S if plan is not None else len(ds)
            size = rows * args.image_size * args.image_size * 3
            grant = size <= input_budget and ds.cacheable_images()
            device_images_for[id(ds)] = grant
            if grant:
                input_budget -= size
        print(f"device_images: {sum(device_images_for.values())}/{len(device_images_for)} split "
              f"tables within {args.device_images_budget_gb} GB budget")

    loaders: dict = {}

    def loader(ds, shuffle, reused=True):
        # one loader per (split, shuffle): its epoch counter advances every
        # iteration, so shuffling and augmentation differ per epoch
        key = (id(ds), shuffle)
        if key not in loaders:
            dev_imgs = device_images_for.get(id(ds), False)
            plan = plan_for(ds, args.batch_size if shuffle else eval_batch)
            loaders[key] = DeviceLoader(
                ds, plan.Bd if plan is not None else args.batch_size if shuffle else eval_batch,
                shuffle=shuffle, seed=args.seed, num_threads=args.workers, plan=plan,
                with_images=not args.text_only,
                # a cache pays only for a loader read more than once (or whose
                # pixels are in a table, which makes its batches small)
                cache_device_batches=(args.cache_eval_batches and not shuffle
                                      and (reused or dev_imgs)),
                cache_budget_bytes=int(input_budget / max(1, len({id(val_ds), id(test_ds)}))),
                device_images=dev_imgs, device_text=args.device_text, device=device)
        ld = loaders[key]
        return lambda: ld

    # bare --resume: this run's latest checkpoint; a directory: that one's
    # full train state; a .pth[.tar] file: a reference checkpoint's weights
    if args.resume and args.resume != "latest":
        if os.path.isdir(args.resume):
            engine.restore_from_dir(args.resume)
            print(f"resumed train state from {args.resume} (epoch {engine.epoch})")
        elif os.path.isfile(args.resume):
            if args.text_only:
                raise SystemExit("--resume <torch ckpt> needs the fusion model; drop --text_only")
            sd, meta = load_torch_state_dict(args.resume)
            engine.load_model_state(*import_reference_state_dict(
                sd, num_layers=args.num_layers, bidirectional=args.bidirectional,
                stack_num=args.stack_num, device=device))
            if "epoch" in meta:
                engine.epoch = int(meta["epoch"])  # the reference stores the next epoch
            if "best_score" in meta:
                engine.best_score = float(meta["best_score"])
            print(f"resumed weights from torch checkpoint {args.resume} "
                  f"(epoch {engine.epoch}, fresh optimizer)")
        else:
            raise SystemExit(f"--resume: {args.resume!r} is neither a checkpoint directory "
                             f"nor a .pth[.tar] file")

    run_config = {
        "text_min_count": args.text_min_count, "ngram": args.ngram,
        "window_size": args.window_size, "object_t": args.object_t_value,
        "place_t": args.place_t_value, "batch_size": args.batch_size, "lr": args.lr,
    }
    tag = (f"text_min_count_{args.text_min_count}_ngram_{args.ngram}"
           f"_window_{args.window_size}_bts_{args.batch_size}.txt")
    result_paths = {
        "experiment": os.path.join(args.save_experiment_result_path, args.model_name, tag),
        "pred": os.path.join(args.save_pred_result_path, args.model_name, tag),
        "label_names": list(label_map),
    }
    try:
        return engine.learning(
            loader(train_ds, True), loader(val_ds, False),
            loader(test_ds, False, reused=test_ds is val_ds) if args.evaluate else None,
            max_epochs=args.epochs, resume=args.resume == "latest", log_every=args.print_freq,
            result_paths=result_paths if args.evaluate else None, run_config=run_config,
            profile_dir=args.profile_dir, metrics_path=args.metrics_path,
        )
    except torch.OutOfMemoryError as e:
        if not (args.device_images or args.device_text):
            raise
        raise SystemExit(
            "out of device memory: the input tables plus the train step's memory exceed the "
            "card at this config. Options: drop --device_images (pixels uploaded per batch), "
            "lower --device_images_budget_gb, or shrink the step (--freeze_trunks, "
            "--remat_policy block, a smaller -b or --image-size).") from e


def cli(argv=None) -> int:
    """Console-script entry point (``mgnns-torch-train``): the result dict
    of :func:`main` would read as a failure exit code, so it is dropped."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()
