"""One rank of the port's model-axis tests (tests/test_torch_model_axis.py).

Started once per rank with torchrun's environment, as
tests/torch_parallel_worker.py is, and run as::

    python tests/torch_model_axis_worker.py <scenario> <directory>

The ranks join a gloo group on the CPU and write their results to
``<directory>/<scenario>_rank<r>.pt``.  Scenarios:

- ``model2``: 2 ranks on a ``(data 1, model 2)`` mesh.  The toy fusion
  model's eval forward against the port's 1-rank forward (rank 0 writes its
  logits for the JAX comparison); 2 Adam steps at dropout 0.5 with the
  head-diversity term and the clip active, through device tables, and an
  eval epoch, against the 1-rank run of the same batches (rank 0 runs it);
  the checkpoint of the model-2 run, its leaves whole, restored at model 1
  and at model 2, and the reference ``state_dict`` export;
- ``data2model2``: 4 ranks on a ``(2, 2)`` mesh, with ``gcn_hidden`` odd so
  that ``gc1``/``gc2`` fall back to replication: 2 streamed steps and an
  eval epoch against the 1-rank run of the global batches (rank 0; its
  BatchNorm takes the data axis's arithmetic, as in the data-parallel
  tests); its checkpoint restored on a ``(1, 4)`` mesh of the same ranks;
  ``Predictor(mesh=...)`` against a 1-device Predictor;
- ``cli``: ``cli.main`` with ``<directory>/cli_args.json``, then
  ``cli.predict`` with ``<directory>/predict_args.json`` on a second port.

Every rank reports digests of its replicated leaves, for the parent to hold
bit-equal across ranks, and whether its padding rows of the gather tables
(parameters and Adam moments) are zero.  No JAX here.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tests import torch_parallel_worker as W  # noqa: E402

GLOBAL_BATCH = 8
N_RECORDS = 16       # 2 steps of the global batch
GRAD_CLIP = 0.5      # below the toy's gradient norm: the clip scales every step
TABLES = ("text_gcn/node_embedding", "text_gcn/edge_weight", "embedding/table")
LABELS = {f"l{i}": i for i in range(7)}


def toy_apply(cfg, consts):
    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    def apply_fn(p, bs, batch, *, train, generator, axis=None, model=None):
        logits, new_bs, aux = mgnns_apply(p, bs, consts, batch, cfg=cfg, train=train,
                                          generator=generator, axis=axis, model=model)
        return logits, new_bs, aux["head_diversity"]

    return apply_fn


def engine(toy, cfg_over: dict, steps: int, **kw):
    """(engine, cfg) of the toy at dropout 0.5 with the clip active."""
    from mgnns_tpu_torch.engine.train import Engine
    from mgnns_tpu_torch.parallel.sharding import mgnns_param_rules

    cfg, params, stats, consts = W.toy_model(toy, dropout=0.5, text_dropout=0.5, **cfg_over)
    if kw.get("mesh") is not None:
        kw.update(param_sharding_rules=mgnns_param_rules(), heads=cfg.n_head)
    eng = Engine(toy_apply(cfg, consts), params, stats, grad_clip=GRAD_CLIP,
                 **W.engine_kwargs(steps), **kw)
    return eng, cfg


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def opt_leaves(eng) -> dict:
    """The Adam moments, whole on a model axis (a collective)."""
    state = eng.opt_state
    if eng.model_axis is not None:
        from mgnns_tpu_torch.parallel.sharding import unshard_leaves

        state = eng._map_opt_state(state, unshard_leaves)
    return {k: W._leaves(state[k]) for k in ("mu", "nu")}


def rank_report(eng) -> dict:
    """Digests of the leaves replicated on the model axis (parameters, BN
    statistics, moments) and whether the padding rows of this rank's table
    shards are zero in the parameters and the moments."""
    from mgnns_tpu_torch.utils import tree_leaves, tree_paths

    paths = eng._paths()
    placements = [eng.placements[p] for p in paths]
    leaves = tree_leaves(eng.params)
    trained = eng.opt.trained
    mu = dict(zip(trained, eng.opt_state["mu"]))
    nu = dict(zip(trained, eng.opt_state["nu"]))
    rep = {p: digest(t) for p, t, pl in zip(paths, leaves, placements) if pl.dim is None}
    rep.update({f"mu/{paths[i]}": digest(mu[i]) for i in trained if placements[i].dim is None})
    rep.update({f"nu/{paths[i]}": digest(nu[i]) for i in trained if placements[i].dim is None})
    rep.update({f"stats{p}": digest(t) for p, t in zip(tree_paths(eng.batch_stats),
                                                       tree_leaves(eng.batch_stats))})
    pads = {}
    axis = eng.model_axis
    for i, (p, pl) in enumerate(zip(paths, placements)):
        if p not in TABLES:
            continue
        n = leaves[i].shape[0]
        rows = torch.arange(axis.rank * n, (axis.rank + 1) * n) >= pl.shape[0]
        pads[p] = {"rows": int(rows.sum()),
                   "zero": all(bool((t[rows] == 0).all()) for t in (leaves[i], mu[i], nu[i]))}
    return {"replicated": rep, "pads": pads,
            "sharded": sorted(p for p, pl in zip(paths, placements) if pl.dim is not None)}


def errors(got_eng, want_eng) -> dict:
    """tests/torch_parallel_worker.tree_errors of the whole parameters,
    statistics and moments (a collective on ``got_eng``'s model axis)."""
    from mgnns_tpu_torch.utils import tree_paths

    got = {"params": W._leaves(got_eng.full_params()), "stats": W._leaves(got_eng.batch_stats),
           **opt_leaves(got_eng)}
    if want_eng is None:
        return {}
    want = {"params": W._leaves(want_eng.params), "stats": W._leaves(want_eng.batch_stats),
            **opt_leaves(want_eng)}
    paths = {"params": tree_paths(want_eng.params), "stats": tree_paths(want_eng.batch_stats)}
    paths["mu"] = paths["nu"] = [paths["params"][i] for i in want_eng.opt.trained]
    return {k: W.tree_errors(got[k], want[k], paths[k]) for k in got}


def epoch_result(tr: dict, ev: dict) -> dict:
    return {"losses": tr["step_losses"], "fused": bool(tr.get("fused")),
            "eval_loss": ev["loss"], "confusion": ev["confusion"],
            "preds": dict(zip(ev["sample_index"].tolist(), ev["preds"].tolist()))}


def split(toy, cfg) -> W.ArrayDataset:
    return W.ArrayDataset({k: v[:N_RECORDS] for k, v in toy["records"].items()}, cfg.image_size)


def clip_norm(eng, loader) -> float:
    """The global gradient norm of the first batch of ``loader`` (a 1-rank
    engine; a loader of its own, whose epoch count this advances)."""
    batch = eng._to_device(next(iter(loader)))
    eng._gens.reseed(0)
    _, grads, _, _ = eng._loss_and_grads(batch)
    return float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in grads if g is not None])))


def _model2(out_dir: str, toy: dict) -> dict:
    import torch.distributed as dist

    from mgnns_tpu_torch.models.import_reference import export_reference_state_dict
    from mgnns_tpu_torch.parallel.input import make_input_plan
    from mgnns_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(1, 2, device="cpu")
    rank = dist.get_rank()
    res: dict = {"rank": rank}
    ckpt = os.path.join(out_dir, "ckpt")
    eng, cfg = engine(toy, {}, 2, mesh=mesh, checkpoint_dir=ckpt)
    res["placements"] = {p: pl.spec for p, pl in eng.placements.items()}

    # the eval forward of the toy batch, before training
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in toy["batch"].items()}
    with torch.no_grad():
        logits = eng._apply(eng.params, eng.batch_stats, batch, train=False,
                            generator=None)[0]
    if rank == 0:
        one, _ = engine(toy, {}, 2, eval_only=True)
        with torch.no_grad():
            want = one._apply(one.params, one.batch_stats, batch, train=False,
                              generator=None)[0]
        del one
        res["logits"] = logits
        res["forward_err"] = float((logits - want).abs().max() / want.abs().max())

    ds = split(toy, cfg)
    plan = make_input_plan(1, N_RECORDS, GLOBAL_BATCH)
    train_ld, eval_ld = W.loaders(ds, plan, tables=True)
    res["run"] = epoch_result(eng.train_epoch(train_ld), eng.eval_epoch(eval_ld, True))
    res["report"] = rank_report(eng)
    ref = None
    if rank == 0:
        ref, _ = engine(toy, {}, 2)
        ref_train, ref_eval = W.loaders(ds, plan, tables=True)
        res["clip_norm"] = clip_norm(ref, W.loaders(ds, plan, tables=False)[0])
        res["reference"] = epoch_result(ref.train_epoch(ref_train),
                                        ref.eval_epoch(ref_eval, True))
    res["errors"] = errors(eng, ref)

    # the checkpoint holds whole leaves; it restores at model 1 and at model 2
    full = W._leaves(eng.full_params())
    moments = opt_leaves(eng)
    local = W._leaves(eng._state_tensors())
    eng.save()
    if rank == 0:
        raw = torch.load(os.path.join(ckpt, f"step_{eng.step}.pt"), weights_only=False)
        res["ckpt_shapes"] = [tuple(t.shape) for t in W._leaves(raw["params"])]
        res["ref_shapes"] = [tuple(t.shape) for t in W._leaves(ref.params)]
        one, _ = engine(toy, {}, 2)
        one.restore_from_dir(ckpt)
        res["model1_restore"] = (
            all(torch.equal(a, b) for a, b in zip(W._leaves(one.params), full))
            and all(torch.equal(a, b) for k in ("mu", "nu")
                    for a, b in zip(W._leaves(one.opt_state[k]), moments[k])))
    eng.restore()
    res["model2_restore"] = all(torch.equal(a, b)
                                for a, b in zip(W._leaves(eng._state_tensors()), local))
    sd = export_reference_state_dict(eng.params, eng.batch_stats, model=eng.shards)
    whole = eng.full_params()
    if rank == 0:
        res["export"] = {k: tuple(sd[k].shape) for k in (
            "embedding.weight", "text_features.node_hidden.weight",
            "text_features.seq_edge_w.weight", "gc1.weight", "multi_linear_1.weight")}
        res["export_equal"] = (torch.equal(sd["embedding.weight"], whole["embedding"]["table"])
                               and torch.equal(sd["text_features.seq_edge_w.weight"],
                                               whole["text_gcn"]["edge_weight"]))
    remove_checkpoints(ckpt)
    return res


def remove_checkpoints(ckpt: str) -> None:
    """Rank 0 deletes the run's checkpoints (~0.8 GB of the full-depth toy's
    parameters and moments) once every rank is done with them."""
    import shutil

    import torch.distributed as dist

    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt)


def _data2model2(out_dir: str, toy: dict) -> dict:
    import torch.distributed as dist

    from mgnns_tpu_torch.config import TextGraphConfig
    from mgnns_tpu_torch.graphs.pmi import PmiGraph
    from mgnns_tpu_torch.parallel.collectives import DataAxis
    from mgnns_tpu_torch.parallel.input import make_input_plan
    from mgnns_tpu_torch.parallel.mesh import create_mesh
    from mgnns_tpu_torch.serving import Predictor

    mesh = create_mesh(2, 2, device="cpu")
    rank = dist.get_rank()
    selves = [dist.new_group([r]) for r in range(dist.get_world_size())]
    self_axis = DataAxis(group=selves[rank], rank=0, size=1, device=torch.device("cpu"),
                         backend="gloo")
    over = {"gcn_hidden": 1023}  # odd: gc1/gc2 fall back to replication at model 2
    res: dict = {"rank": rank}
    ckpt = os.path.join(out_dir, "ckpt")
    eng, cfg = engine(toy, over, 2, mesh=mesh, checkpoint_dir=ckpt)
    res["placements"] = {p: pl.spec for p, pl in eng.placements.items()}
    ds = split(toy, cfg)
    train_ld, eval_ld = W.loaders(ds, make_input_plan(2, N_RECORDS, GLOBAL_BATCH), tables=False)
    res["run"] = epoch_result(eng.train_epoch(train_ld), eng.eval_epoch(eval_ld, True))
    res["report"] = rank_report(eng)
    ref = None
    if rank == 0:
        ref, res["reference"] = one_rank_global(toy, over, ds, self_axis)
    res["errors"] = errors(eng, ref)

    # the model-2 checkpoint restored on a (1, 4) mesh of the same ranks
    eng.save()
    full = W._leaves(eng.full_params())
    eng4, _ = engine(toy, over, 2, mesh=create_mesh(1, 4, device="cpu"))
    eng4.restore_from_dir(ckpt)
    res["model4_restore"] = all(torch.equal(a, b)
                                for a, b in zip(W._leaves(eng4.full_params()), full))
    res["model4_shards"] = {p: tuple(t.shape) for p, t in zip(
        eng4._paths(), W._leaves(eng4.params)) if p in TABLES}
    del eng4
    remove_checkpoints(ckpt)

    # serving: the whole toy weights, every rank the same records
    cfg0, params, stats, consts = W.toy_model(toy)
    graph_cfg = TextGraphConfig(text_min_count=1, window_size=3, ngram=2, min_cooccurrence=1,
                                max_len=10)
    g = toy["graph"]
    kw = dict(vocab=toy["vocab"], graph=PmiGraph(int(g["vocab_size"]), g["keys"], g["pmi"]),
              graph_cfg=graph_cfg, label_map=LABELS,
              params=params, batch_stats=stats, consts=consts, cfg=cfg0,
              image_backend="synthetic", max_batch=GLOBAL_BATCH, decode_threads=1,
              device="cpu")
    records = [{"id": i, "text": t, "image": f"{i}.jpg"}
               for i, t in enumerate((toy["texts"] * 3)[:11])]
    pred = Predictor(mesh=mesh, **kw)
    res["buckets"] = pred.batch_buckets
    res["served"] = [pred.predict(records), pred.predict(records[:1])]
    if rank == 0:
        one = Predictor(batch_buckets=pred.batch_buckets, **kw)
        res["served_one"] = [one.predict(records), one.predict(records[:1])]
    return res


def one_rank_global(toy, over, ds, self_axis):
    """(engine, results) of the port's 1-rank engine, no mesh, on the global
    batches of a data axis of 2 (both positions' loader rows in position
    order), its BatchNorm the data axis's arithmetic over ``self_axis``
    (``torch_parallel_worker._SameArithmetic``)."""
    from mgnns_tpu_torch.engine import metrics as M
    from mgnns_tpu_torch.nn import resnet
    from mgnns_tpu_torch.parallel.input import make_input_plan

    functional = resnet.F
    resnet.F = W._SameArithmetic(functional, self_axis)
    try:
        eng, _ = engine(toy, over, 2)
        plans = [make_input_plan(2, N_RECORDS, GLOBAL_BATCH, position=p, process_index=0,
                                 process_count=1) for p in (0, 1)]
        lds = [W.loaders(ds, p, tables=False) for p in plans]
        losses = []
        for b0, b1 in zip(lds[0][0], lds[1][0]):
            batch = {k: W._cat(b0[k], b1[k]) for k in b0 if k != "weight_total"}
            losses.append(float(eng.train_step(batch, M.confusion_init(7, "cpu"))))
        preds, ecm, lsum, wsum = {}, M.confusion_init(7, "cpu"), 0.0, 0.0
        for b0, b1 in zip(lds[0][1], lds[1][1]):
            batch = {k: W._cat(b0[k], b1[k]) for k in b0 if k != "weight_total"}
            loss, p = eng.eval_step(batch, ecm)
            w = batch["weight"].astype(bool)
            preds.update(zip(batch["sample_index"][w].tolist(), p.numpy()[w].tolist()))
            lsum += float(loss) * w.sum()
            wsum += w.sum()
    finally:
        resnet.F = functional
    return eng, {"losses": losses, "fused": False, "eval_loss": lsum / wsum,
                 "confusion": ecm.numpy(), "preds": preds}


def _cli(out_dir: str) -> dict:
    from mgnns_tpu_torch.cli import main as pmain
    from mgnns_tpu_torch.cli import predict as ppredict

    with open(os.path.join(out_dir, "cli_args.json")) as f:
        res = pmain.main(json.load(f))
    # a second group for the prediction CLI, on its own port
    with open(os.path.join(out_dir, "predict_args.json")) as f:
        spec = json.load(f)
    os.environ["MASTER_PORT"] = str(spec["port"])
    ppredict.main(spec["argv"])
    test = res["test"]
    return {"history": [{k: {m: float(h[k][m]) for m in ("loss", "accuracy")}
                         for k in ("train", "val")} for h in res["history"]],
            "test_accuracy": float(test["accuracy"]), "test_loss": float(test["loss"]),
            "preds": dict(zip(np.asarray(test["sample_index"]).tolist(),
                              np.asarray(test["preds"]).tolist()))}


def main() -> None:
    scenario, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    from mgnns_tpu_torch.parallel import multihost

    if scenario == "cli":
        res = _cli(out_dir)
    else:
        import torch.distributed as dist

        multihost.initialize(device="cpu")
        toy = torch.load(os.path.join(out_dir, "toy.pt"), weights_only=False)
        res = {"model2": _model2, "data2model2": _data2model2}[scenario](out_dir, toy)
        dist.destroy_process_group()
    rank = int(os.environ["RANK"])
    torch.save(res, os.path.join(out_dir, f"{scenario}_rank{rank}.pt"))
    print(f"[{scenario} rank {rank}] ok", flush=True)


if __name__ == "__main__":
    main()
