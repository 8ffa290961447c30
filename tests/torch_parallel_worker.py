"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py).

Started once per rank with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set, as ``torchrun``
sets them, and run as::

    python tests/torch_parallel_worker.py <scenario> <directory>

The ranks join a gloo group on the CPU and write their results to
``<directory>/<scenario>_rank<r>.pt`` for the parent test.  Scenarios:

- ``core``: the data-axis BatchNorm (float32 and bf16; at world 1 too), the
  global gradient of the toy fusion model at dropout 0 (rank 0 writes it to
  ``grad.pt`` for the JAX comparison), the engine on an even and an uneven
  split at dropout 0.5 (3 and 2 steps, then an eval epoch), each held here
  to the port's 1-rank run of the same global batches (rank 0 runs the
  even split's, rank 1 the uneven one's), the prediction gather over
  uneven blocks and the checkpoint-directory probe;
- ``cli``: ``mgnns_tpu_torch.cli.main`` with the arguments in
  ``<directory>/cli_args.json``.

The toy model is drawn here from the seeded inputs in ``<directory>/toy.pt``
(:func:`toy_model`), as the parent draws it.  No JAX here.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

AUX_W = 0.3       # tests/torch_train_common.AUX_W
GLOBAL_BATCH = 8
SPLITS = {"even": (24, True), "uneven": (13, False)}  # records, through device tables


class ArrayDataset:
    """A split held in arrays, with what ``DeviceLoader`` reads of a
    ``TumblrDataset``: ``text``, ``labels``, ``load_image`` and friends."""

    def __init__(self, arrays: dict, image_size: int):
        self.text = types.SimpleNamespace(**{k: arrays[k] for k in ("ids", "lens", "mask",
                                                                     "eids")})
        self.labels = arrays["label"]
        self.images = arrays["image"]
        self.image_size = image_size
        self.global_len = len(self.labels)
        self.record_offset = 0

    def __len__(self) -> int:
        return len(self.labels)

    def cacheable_images(self) -> bool:
        return True

    def load_image(self, i, rng=None) -> np.ndarray:
        return self.images[int(i)]


RESIDUAL_SCALE = 0.1  # the trunk blocks' last BatchNorm scale


def toy_model(toy: dict, **overrides):
    """(config, params, stats, consts) of the toy fusion model on the CPU,
    drawn by ``mgnns_init`` from ``toy``'s seeded inputs, with each trunk
    block's last BatchNorm scale at RESIDUAL_SCALE (a damped residual
    branch, as zero-init-residual ResNets start).  At the random init's
    scale of 1, train-mode BatchNorm through 150 layers amplifies a float32
    rounding difference (1 against 4 CPU threads) in the logits by orders
    of magnitude more than at 0.1, and past what 1e-5 could hold."""
    from mgnns_tpu_torch.config import ModelConfig
    from mgnns_tpu_torch.models.mgnns import mgnns_init

    cfg = ModelConfig(**dict(toy["kw"], **overrides))
    params, stats, consts = mgnns_init(cfg, num_edges=toy["kw"]["edges_num"], seed=0,
                                       device="cpu", **toy["inputs"])
    for side in ("object_trunk", "place_trunk"):
        for li in range(1, 5):
            for block in params[side][f"layer{li}"]:
                block["bn3"]["scale"].mul_(RESIDUAL_SCALE)
    return cfg, params, stats, consts


def toy_apply(cfg, consts):
    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    def apply_fn(p, bs, batch, *, train, generator, axis=None):
        logits, new_bs, aux = mgnns_apply(p, bs, consts, batch, cfg=cfg, train=train,
                                          generator=generator, axis=axis)
        return logits, new_bs, aux["head_diversity"]

    return apply_fn


def engine_kwargs(steps_per_epoch: int) -> dict:
    """Adam at the engine's default rates."""
    return dict(num_classes=7, steps_per_epoch=steps_per_epoch, aux_loss_weight=AUX_W, seed=5,
                device="cpu")


def loaders(ds, plan, tables: bool):
    from mgnns_tpu_torch.data.loader import DeviceLoader

    kw = dict(num_threads=1, device="cpu", plan=plan, device_text=tables, device_images=tables)
    return (DeviceLoader(ds, plan.Bd, shuffle=True, seed=3, **kw),
            DeviceLoader(ds, plan.Bd, shuffle=False, **kw))


def _leaves(tree) -> list:
    from mgnns_tpu_torch.utils import tree_leaves

    return [t.detach().clone() for t in tree_leaves(tree)]


def tree_errors(got: list, want: list, paths: list[str]) -> dict:
    """The largest error of the trunk leaves and of the other leaves: max
    |got - want| / the leaf's scale (``max_rel``), and ||got - want|| /
    ||want|| (``frobenius``)."""
    assert len(got) == len(want) == len(paths)
    out = {f"{part}_{kind}": 0.0 for part in ("trunk", "other") for kind in ("max_rel", "frobenius")}
    for path, a, b in zip(paths, got, want):
        a, b = a.double(), b.double()
        part = "trunk" if "_trunk/" in path else "other"
        out[f"{part}_max_rel"] = max(out[f"{part}_max_rel"], float((a - b).abs().max())
                                     / max(float(b.abs().max()), 1e-30))
        out[f"{part}_frobenius"] = max(out[f"{part}_frobenius"], float((a - b).norm())
                                       / max(float(b.norm()), 1e-30))
    return out


def _checksum(leaves: list) -> float:
    return float(sum(t.double().sum() for t in leaves))


def _cat(a, b):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, b])
    return np.concatenate([np.atleast_1d(a), np.atleast_1d(b)])


class _SameArithmetic:
    """``mgnns_tpu_torch.nn.resnet``'s ``F`` with train-mode batch_norm
    through the data-axis function over a group of one rank (which
    tests/test_torch_parallel.py holds to ``F.batch_norm`` within 1e-6 per
    layer).  The toy's trunk gradients move by a large share of a leaf's
    scale at a few layers between two float32 BatchNorm arithmetics, so the
    1-rank reference takes the 2-rank run's; what the comparison sees is
    then the data axis."""

    def __init__(self, functional, axis):
        self._f, self._axis = functional, axis

    def __getattr__(self, name):
        return getattr(self._f, name)

    def batch_norm(self, x, mean, var, weight, bias, training=False, eps=1e-5, **kw):
        if not training:
            return self._f.batch_norm(x, mean, var, weight, bias, training=False, eps=eps)
        from mgnns_tpu_torch.parallel.collectives import sync_batch_norm

        return sync_batch_norm(x, weight, bias, eps, self._axis)[0]


def one_rank_run(toy: dict, name: str, self_axis) -> dict:
    """The port's 1-rank engine, no mesh, on the global batches of the
    2-rank run: both ranks' loader rows, concatenated in rank order; its
    BatchNorm runs the data-axis arithmetic over ``self_axis``, a group of
    this rank alone (:class:`_SameArithmetic`)."""
    from mgnns_tpu_torch.nn import resnet

    functional = resnet.F
    resnet.F = _SameArithmetic(functional, self_axis)
    try:
        return _one_rank_run(toy, name)
    finally:
        resnet.F = functional


def _one_rank_run(toy: dict, name: str) -> dict:
    from mgnns_tpu_torch.engine import metrics as M
    from mgnns_tpu_torch.engine.train import Engine
    from mgnns_tpu_torch.parallel.input import make_input_plan

    n, _ = SPLITS[name]
    cfg, params, stats, consts = toy_model(toy, dropout=0.5, text_dropout=0.5)
    ds = ArrayDataset({k: v[:n] for k, v in toy["records"].items()}, cfg.image_size)
    plans = [make_input_plan(2, n, GLOBAL_BATCH, position=p, process_index=0, process_count=1)
             for p in (0, 1)]
    lds = [loaders(ds, p, tables=False) for p in plans]
    eng = Engine(toy_apply(cfg, consts), params, stats, **engine_kwargs(plans[0].num_batches))
    cm = M.confusion_init(7, "cpu")
    losses = []
    for b0, b1 in zip(lds[0][0], lds[1][0]):
        batch = {k: _cat(b0[k], b1[k]) for k in b0 if k != "weight_total"}
        losses.append(float(eng.train_step(batch, cm)))
    preds, ecm, lsum, wsum = {}, M.confusion_init(7, "cpu"), 0.0, 0.0
    for b0, b1 in zip(lds[0][1], lds[1][1]):
        batch = {k: _cat(b0[k], b1[k]) for k in b0 if k != "weight_total"}
        loss, p = eng.eval_step(batch, ecm)
        w = batch["weight"].astype(bool)
        preds.update(zip(batch["sample_index"][w].tolist(), p.numpy()[w].tolist()))
        lsum += float(loss) * w.sum()
        wsum += w.sum()
    return {"losses": losses, "params": _leaves(eng.params), "stats": _leaves(eng.batch_stats),
            "mu": _leaves(eng.opt_state["mu"]), "nu": _leaves(eng.opt_state["nu"]),
            "preds": preds, "confusion": ecm.numpy(), "eval_loss": lsum / wsum}


def _bn_case(axis, self_axis, dtype) -> dict:
    """This rank's rows of y and dx of the data-axis BatchNorm, the summed
    dscale and dbias, the new running statistics, and at world 1 the
    largest difference from F.batch_norm."""
    from mgnns_tpu_torch.nn.resnet import bn
    from mgnns_tpu_torch.parallel.collectives import all_reduce_sum, sync_batch_norm

    r = np.random.default_rng(7)
    x = torch.from_numpy(r.standard_normal((GLOBAL_BATCH, 6, 5, 5)).astype(np.float32) * 3 + 1)
    g = torch.from_numpy(r.standard_normal((GLOBAL_BATCH, 6, 5, 5)).astype(np.float32))
    p = {"scale": torch.from_numpy(r.uniform(0.5, 1.5, 6).astype(np.float32)),
         "bias": torch.from_numpy(r.standard_normal(6).astype(np.float32))}
    s = {"mean": torch.zeros(6), "var": torch.ones(6)}
    rows = slice(axis.rank * GLOBAL_BATCH // 2, (axis.rank + 1) * GLOBAL_BATCH // 2)
    xr = x[rows].to(dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
    pr = {k: v.clone().requires_grad_() for k, v in p.items()}
    y, new = bn(pr, s, xr, train=True, axis=axis)
    (y.float() * g[rows]).sum().backward()
    dscale, dbias = all_reduce_sum([pr["scale"].grad, pr["bias"].grad], axis)
    out = {"y": y.detach().float(), "dx": xr.grad.float(), "dscale": dscale, "dbias": dbias,
           "mean": new["mean"], "var": new["var"]}
    # the data-axis function on a group of one rank against F.batch_norm
    x1 = x[rows].to(dtype)
    y1 = sync_batch_norm(x1, p["scale"], p["bias"], 1e-5, self_axis)[0]
    y0 = torch.nn.functional.batch_norm(x1, None, None, p["scale"], p["bias"], training=True,
                                        eps=1e-5)
    out["world1_err"] = float((y1.float() - y0.float()).abs().max()
                              / y0.float().abs().max())
    return out


def _core(out_dir: str) -> dict:
    import torch.distributed as dist

    from mgnns_tpu_torch.engine.checkpoint import Checkpointer
    from mgnns_tpu_torch.engine.train import Engine
    from mgnns_tpu_torch.parallel import multihost
    from mgnns_tpu_torch.parallel.collectives import DataAxis, gather_blocks
    from mgnns_tpu_torch.parallel.input import make_input_plan
    from mgnns_tpu_torch.parallel.mesh import batch_device_put, create_mesh
    from mgnns_tpu_torch.utils import tree_paths

    mesh = create_mesh(2, device="cpu")
    axis = DataAxis.of(mesh, "cpu")
    rank = axis.rank
    # a group of one rank each, for the data-axis functions at world 1
    selves = [dist.new_group([r]) for r in range(2)]
    self_axis = DataAxis(group=selves[rank], rank=0, size=1, device=torch.device("cpu"),
                         backend="gloo")
    res: dict = {"rank": rank, "hosts": multihost.process_count(),
                 "host": multihost.process_index()}
    res["bn"] = {str(dt): _bn_case(axis, self_axis, dt) for dt in (torch.float32, torch.bfloat16)}

    toy = torch.load(os.path.join(out_dir, "toy.pt"), weights_only=False)
    # the global gradient at dropout 0 (the JAX comparison)
    cfg0, params, stats, consts = toy_model(toy)
    eng = Engine(toy_apply(cfg0, consts), params, stats, mesh=mesh, **engine_kwargs(1))
    eng._gens.reseed(0)
    loss, grads, _, new_bs = eng._loss_and_grads(batch_device_put(toy["batch"], axis, "cpu"))
    present = [g for g in grads if g is not None]
    res["grad"] = {"loss": float(loss), "stats": _leaves(new_bs), "checksum": _checksum(present)}
    if rank == 0:
        torch.save([None if g is None else g.clone() for g in grads],
                   os.path.join(out_dir, "grad.pt"))

    # the engine at dropout 0.5, Adam: an even split through device tables
    # (the plan path) and an uneven one streamed
    runs = {}
    for name, (n, tables) in SPLITS.items():
        cfg, params, stats, consts = toy_model(toy, dropout=0.5, text_dropout=0.5)
        ds = ArrayDataset({k: v[:n] for k, v in toy["records"].items()}, cfg.image_size)
        plan = make_input_plan(2, n, GLOBAL_BATCH)
        train_ld, eval_ld = loaders(ds, plan, tables)
        eng = Engine(toy_apply(cfg, consts), params, stats, mesh=mesh,
                     **engine_kwargs(plan.num_batches))
        tr = eng.train_epoch(train_ld)
        ev = eng.eval_epoch(eval_ld, collect_preds=True)
        runs[name] = eng
        res[name] = {"num_batches": plan.num_batches, "losses": tr["step_losses"],
                     "fused": bool(tr.get("fused")), "eval_loss": ev["loss"],
                     "confusion": ev["confusion"],
                     "preds": dict(zip(ev["sample_index"].tolist(), ev["preds"].tolist())),
                     "checksum": _checksum(_leaves(eng._state_tensors()))}
    # this rank's split against the 1-rank run of its global batches
    name = list(SPLITS)[rank]
    want = one_rank_run(toy, name, self_axis)
    eng = runs[name]
    got = {"params": _leaves(eng.params), "stats": _leaves(eng.batch_stats),
           "mu": _leaves(eng.opt_state["mu"]), "nu": _leaves(eng.opt_state["nu"])}
    paths = {"params": tree_paths(eng.params), "stats": tree_paths(eng.batch_stats)}
    paths["mu"] = paths["nu"] = [paths["params"][i] for i in eng.opt.trained]
    res["reference"] = {"name": name,
                        "errors": {k: tree_errors(got[k], want[k], paths[k]) for k in got},
                        **{k: want[k] for k in ("losses", "preds", "confusion", "eval_loss")}}

    # the prediction gather over blocks of 3 and 2 records
    block = torch.arange(3 * (3 - rank), dtype=torch.int64).view(3, -1) + 100 * rank
    res["gather"] = [b.tolist() for b in gather_blocks(block, axis)]

    # the checkpoint-directory probe: per-rank directories raise on every rank,
    # a shared one passes, rank 0 writes and every rank restores
    try:
        Checkpointer(os.path.join(out_dir, f"ckpt_rank{rank}"), axis=axis)
        res["unshared"] = None
    except RuntimeError as e:
        res["unshared"] = str(e)
    ck = Checkpointer(os.path.join(out_dir, "ckpt_shared"), axis=axis)
    ck.save(7, {"rank_written": torch.tensor(rank)}, {"val_accuracy": 0.5})
    res["restored"] = int(ck.restore(device="cpu")["rank_written"])
    res["best"] = ck.best_step()
    return res


def _cli(out_dir: str) -> dict:
    from mgnns_tpu_torch.cli.main import main

    with open(os.path.join(out_dir, "cli_args.json")) as f:
        argv = json.load(f)
    res = main(argv)
    test = res["test"]
    return {"nodes": int(os.environ["WORLD_SIZE"]) // int(os.environ["LOCAL_WORLD_SIZE"]),
            "history": [{k: {m: float(h[k][m]) for m in ("loss", "accuracy")}
                         | {"fused": bool(h[k].get("fused"))} for k in ("train", "val")}
                        for h in res["history"]],
            "test_accuracy": float(test["accuracy"]), "test_loss": float(test["loss"]),
            "preds": dict(zip(np.asarray(test["sample_index"]).tolist(),
                              np.asarray(test["preds"]).tolist()))}


def main() -> None:
    scenario, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(2)
    from mgnns_tpu_torch.parallel import multihost

    if scenario == "core":
        import torch.distributed as dist

        multihost.initialize(device="cpu")
        res = _core(out_dir)
        dist.destroy_process_group()
    elif scenario == "cli":
        res = _cli(out_dir)
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    rank = int(os.environ["RANK"])
    torch.save(res, os.path.join(out_dir, f"{scenario}_rank{rank}.pt"))
    print(f"[{scenario} rank {rank}] ok", flush=True)


if __name__ == "__main__":
    main()
