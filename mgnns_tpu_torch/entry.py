"""Entry points of the port: a flagship forward and a multi-rank dry run.

The counterpart of the JAX package's ``__graft_entry__.py``, with its own
copies of that file's helpers (nothing is imported from it):

- :func:`entry` returns ``(fn, example_args)``: the fusion model's eval
  forward at production shapes (448 px, L=100, W=9, bf16 trunks, a
  4,096-word vocabulary and 8,192 edges, B=2), with K1 inside;
- :func:`dryrun_multichip` starts ``n_devices`` ranks over gloo, builds the
  JAX dry run's mesh geometries over their world and runs its four legs:
  three SGD steps at every geometry against the one-device trajectory, an
  eval epoch from device tables on the primary mesh, a save and restore of
  the sharded state, and a bf16 forward and train step against one device.

``__graft_entry__._force_virtual_cpu_devices`` has no counterpart: there the
n devices of a mesh are virtual CPU devices of one process, here a rank is a
process, so the dry run starts its ranks (``python -m mgnns_tpu_torch.entry
--dryrun-rank <dir>``, with torchrun's environment).  On the card every rank
uses ``cuda:0`` over gloo (NCCL refuses two ranks on one device); with
``device="cpu"`` the ranks run on the host.

Run from the repository root::

    python -m mgnns_tpu_torch.entry               # the flagship forward
    python -m mgnns_tpu_torch.entry multichip 8   # the dry run on 8 ranks
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from mgnns_tpu_torch.config import ModelConfig
from mgnns_tpu_torch.utils import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN_TIMEOUT_S = 900.0


def _tiny_inputs(cfg, num_edges, B, L, W, image_size, rng):
    """A batch of ``B`` random documents of up to ``L`` tokens, their
    ``W``-wide window edge ids, float32 pixels ``[B, H, W, 3]`` and the
    object and place GloVe stand-ins, drawn from ``rng`` in the JAX
    package's order (``__graft_entry__.py:20-32``)."""
    lens = rng.integers(1, L + 1, (B,)).astype(np.int32)
    ids = (rng.integers(1, cfg.vocab_size, (B, L)) *
           (np.arange(L)[None, :] < lens[:, None])).astype(np.int32)
    return {
        "ids": ids,
        "lens": lens,
        "mask": (np.arange(L)[None, :] < lens[:, None]).astype(np.float32),
        "eids": rng.integers(0, num_edges, (B, L, W)).astype(np.int32),
        "image": rng.standard_normal((B, image_size, image_size, 3)).astype(np.float32),
        "object_inp": rng.standard_normal((cfg.object_num_classes, 300)).astype(np.float32),
        "place_inp": rng.standard_normal((cfg.place_num_classes, 300)).astype(np.float32),
    }


def _build(cfg, num_edges, seed=0, device="cuda", *, object_inp=None, place_inp=None):
    """(params, batch_stats, consts) of the fusion model: the label
    embedding and the label graphs from ``np.random.default_rng(0)`` in the
    JAX package's order (``__graft_entry__.py:35-48``), the weights from
    ``mgnns_init(seed=seed)``.  The JAX package passes the object and place
    GloVe inputs in the batch; here they sit in ``consts`` (zeros unless
    given), and :func:`_apply_fn` takes a batch's own in their place."""
    from mgnns_tpu_torch.models.mgnns import mgnns_init

    rng = np.random.default_rng(0)
    label_emb = rng.standard_normal((cfg.num_labels, 300)).astype(np.float32)

    def rand_A(C):
        a = rng.uniform(0, 1, (C, C))
        return (a > 0.7).astype(np.float64) * 0.2 / 3.0 + 0.8 * np.eye(C)

    object_A, place_A = rand_A(cfg.object_num_classes), rand_A(cfg.place_num_classes)
    if object_inp is None:
        object_inp = np.zeros((cfg.object_num_classes, 300), np.float32)
    if place_inp is None:
        place_inp = np.zeros((cfg.place_num_classes, 300), np.float32)
    return mgnns_init(cfg, num_edges=num_edges, label_embedding=label_emb, object_A=object_A,
                      place_A=place_A, object_inp=object_inp, place_inp=place_inp, seed=seed,
                      device=device)


def _apply_fn(cfg, consts):
    """The engine's ``apply_fn`` of the fusion model: a batch that carries
    ``object_inp`` / ``place_inp`` uses them, as the JAX dry run's closure
    does (``batch.setdefault``); a table-gathered batch uses ``consts``'."""
    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    def apply_fn(p, bs, batch, *, train, generator, axis=None, model=None):
        c = dict(consts, **{k: batch[k] for k in ("object_inp", "place_inp") if k in batch})
        logits, new_bs, aux = mgnns_apply(p, bs, c, batch, cfg=cfg, train=train,
                                          generator=generator, axis=axis, model=model)
        return logits, new_bs, aux.get("head_diversity", 0.0)

    return apply_fn


def _forward_fn(cfg, consts):
    """``fn(params, batch_stats, batch) -> logits``: the eval forward."""
    apply_fn = _apply_fn(cfg, consts)

    def fn(params, bstats, batch):
        with torch.no_grad():
            return apply_fn(params, bstats, batch, train=False, generator=None)[0]

    return fn


def entry(device="cuda"):
    """(fn, example_args): the flagship eval forward at production shapes
    and a batch for it on ``device``, which raises without a card unless
    it is the CPU.  ``fn(params, batch_stats, batch)`` returns the logits
    ``[2, 7]`` and launches K1 once."""
    dev = resolve_device(device)
    cfg = ModelConfig(vocab_size=4096, edges_num=8192, compute_dtype="bfloat16")
    num_edges = cfg.edges_num
    params, bstats, consts = _build(cfg, num_edges, 0, dev)
    batch = _tiny_inputs(cfg, num_edges, B=2, L=100, W=9, image_size=cfg.image_size,
                         rng=np.random.default_rng(1))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return _forward_fn(cfg, consts), (params, bstats, batch)


def _unpad_like(got, want):
    """Slice a (possibly mesh-padded) array back to the reference shape."""
    return np.asarray(got)[tuple(slice(0, s) for s in np.shape(want))]


class _FakeFusionDS:
    """Tiny TumblrDataset stand-in (text + deterministic synthetic float32
    pixels) for the dry run's eval epoch from device tables."""

    def __init__(self, cfg, num_edges, n, L, W, seed=5):
        r = np.random.default_rng(seed)
        lens = r.integers(1, L + 1, (n,)).astype(np.int32)
        ids = (r.integers(1, cfg.vocab_size, (n, L)) *
               (np.arange(L)[None] < lens[:, None])).astype(np.int32)
        self.text = SimpleNamespace(
            ids=ids, lens=lens,
            mask=(np.arange(L)[None] < lens[:, None]).astype(np.float32),
            eids=r.integers(0, num_edges, (n, L, W)).astype(np.int32))
        self.labels = r.integers(0, cfg.num_labels, (n,)).astype(np.int32)
        self.image_size = cfg.image_size
        self.pixel_format = "float32"

    def __len__(self):
        return len(self.labels)

    def cacheable_images(self):
        return True

    def load_image(self, i, rng=None):
        r = np.random.default_rng(1000 + int(i))
        return r.standard_normal(
            (self.image_size, self.image_size, 3)).astype(np.float32)


# ------------------------------------------------------------- the dry run


def _geometries(n: int) -> tuple[list[tuple[int, int]], tuple[int, int]]:
    """(data, model) geometries of ``n`` ranks and the primary one
    (``__graft_entry__.py:201-207``): pure data, mixed, pure model."""
    geometries = [(n, 1)]
    if n % 2 == 0 and n > 2:
        geometries.append((n // 2, 2))
    if n > 1:
        geometries.append((1, n))
    return geometries, (geometries[1] if len(geometries) > 2 else geometries[0])


def dryrun_multichip(n_devices: int, device="cuda", *,
                     timeout: float = DRYRUN_TIMEOUT_S) -> dict:
    """The JAX dry run on ``n_devices`` gloo ranks (see the module's
    docstring): rank 0 prints the JAX summary line, and the call returns
    its numbers.  ``device``: ``cuda`` runs every rank on ``cuda:0`` (raises
    without a card), ``cpu`` on the host.  A rank that fails, or
    ranks that outlast ``timeout`` seconds, fail the call, and every rank is
    killed."""
    dev = resolve_device(device)
    rank_device = "cuda:0" if dev.type == "cuda" else "cpu"
    workdir = tempfile.mkdtemp(prefix="mgnns_dryrun_")
    try:
        with open(os.path.join(workdir, "spec.json"), "w") as f:
            json.dump({"n_devices": n_devices, "device": rank_device}, f)
        t0 = time.perf_counter()
        _run_ranks(workdir, n_devices, rank_device, timeout)
        with open(os.path.join(workdir, "rank0.log")) as f:
            sys.stdout.write(f.read())
        with open(os.path.join(workdir, "result.json")) as f:
            out = json.load(f)
        out["launches"] = []
        for r in range(n_devices):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                out["launches"].append(json.load(f))
        out["seconds"] = time.perf_counter() - t0
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(workdir: str, n: int, device: str, timeout: float) -> None:
    """Start ``n`` ranks as torchrun would, each logging to
    ``<workdir>/rank<r>.log``, and wait for them (:func:`_wait_ranks`)."""
    port = _free_port()
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(n), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       PYTHONPATH=os.pathsep.join(
                           [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            if device == "cpu":
                env["OMP_NUM_THREADS"] = "1"
            with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mgnns_tpu_torch.entry", "--dryrun-rank", workdir],
                    env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        _wait_ranks(procs, timeout, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _wait_ranks(procs: list, timeout: float, workdir: str | None = None) -> None:
    """Wait until every process has exited 0; raise as soon as one exits
    otherwise, or when ``timeout`` seconds pass (the caller kills the
    rest).  The failing rank's log tail is in the message."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad or time.monotonic() > deadline:
            what = (f"rank {bad[0]} exited with {codes[bad[0]]}" if bad
                    else f"ranks {[r for r, c in enumerate(codes) if c is None]} still running "
                         f"after {timeout} s")
            tail = ""
            if workdir is not None:
                path = os.path.join(workdir, f"rank{bad[0] if bad else 0}.log")
                if os.path.exists(path):
                    with open(path) as f:
                        tail = f.read()[-6000:]
            raise RuntimeError(f"dryrun_multichip: {what}\n{tail}")
        if all(c == 0 for c in codes):
            return
        time.sleep(0.1)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _worst(got: list[np.ndarray], want: list[np.ndarray], paths: list[str], rtol: float,
           atol: float, where: str) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` over the leaves
    (at most 1 within ``assert_allclose(rtol, atol)``), which it raises
    beyond."""
    worst = 0.0
    for path, g, w in zip(paths, got, want):
        g = _unpad_like(g, w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"param parity @ {where}: {path}")
        if w.size:
            worst = max(worst, float((np.abs(g - w) / (atol + rtol * np.abs(w))).max()))
    return worst


def _host_leaves(tree) -> list[np.ndarray]:
    from mgnns_tpu_torch.utils import tree_leaves

    return [t.detach().float().cpu().numpy() for t in tree_leaves(tree)]


def _table_report(eng, vocab_size: int) -> dict:
    """The model axis's split of ``text_gcn/node_embedding``: whether it is
    split on rows, this rank's row count, and whether its padding rows
    (past the vocabulary) are zero."""
    pl = eng.placements["text_gcn/node_embedding"]
    local = eng.params["text_gcn"]["node_embedding"]
    n = local.shape[0]
    rows = torch.arange(eng.model_axis.rank * n, (eng.model_axis.rank + 1) * n) >= vocab_size
    return {"sharded": pl.dim == 0, "rows": n,
            "padding_zero": bool((local.detach().cpu()[rows] == 0).all())}


def _dryrun_rank(workdir: str) -> None:
    """One rank of :func:`dryrun_multichip` (started with torchrun's
    environment): the four legs, every check on every rank; rank 0 prints
    the summary and writes ``result.json``, every rank its K1/K2 launches."""
    import torch.distributed as dist

    from mgnns_tpu_torch.data.loader import DeviceLoader
    from mgnns_tpu_torch.engine.metrics import confusion_init
    from mgnns_tpu_torch.engine.train import Engine
    from mgnns_tpu_torch.kernels import edge_max
    from mgnns_tpu_torch.parallel import multihost
    from mgnns_tpu_torch.parallel.input import make_input_plan
    from mgnns_tpu_torch.parallel.mesh import batch_device_put, create_mesh
    from mgnns_tpu_torch.parallel.sharding import mgnns_param_rules
    from mgnns_tpu_torch.utils import tree_leaves, tree_paths, tree_to

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    n_devices, dev = spec["n_devices"], torch.device(spec["device"])
    if dev.type == "cpu":
        torch.set_num_threads(1)
    multihost.initialize(backend="gloo", device=spec["device"])
    rank = dist.get_rank()

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    edge_max.launches = edge_max.bwd_launches = 0
    geometries, primary = _geometries(n_devices)
    cfg = ModelConfig(vocab_size=257, edges_num=515, image_size=32, compute_dtype="float32",
                      bn_mode="frozen")
    num_edges = cfg.edges_num
    # table-gathered batches carry text and pixels only; the GloVe inputs
    # ride the model's constants
    const_rng = np.random.default_rng(4)
    object_inp = const_rng.standard_normal((cfg.object_num_classes, 300)).astype(np.float32)
    place_inp = const_rng.standard_normal((cfg.place_num_classes, 300)).astype(np.float32)
    B = max(n_devices, 2)  # divides every geometry's data axis

    def make_engine(c, use_mesh, ckpt_dir=None):
        # fresh weights from the seed for each engine (an engine updates its
        # tensors in place).  SGD: Adam's first step is sign(g) * lr, which
        # turns float32 noise between the sharded and the one-device
        # gradients into +-lr steps
        params, bstats, consts = _build(c, num_edges, 0, dev, object_inp=object_inp,
                                        place_inp=place_inp)
        return Engine(_apply_fn(c, consts), params, bstats,
                      num_classes=c.num_labels, lr=5e-3, optimizer_algo="sgd",
                      steps_per_epoch=1, checkpoint_dir=ckpt_dir, device=dev, mesh=use_mesh,
                      param_sharding_rules=mgnns_param_rules() if use_mesh is not None else None,
                      heads=c.n_head)

    ckpt_root = os.path.join(workdir, "ckpt")
    ref = make_engine(cfg, None)

    # ---- 1. sharded-vs-single 3-step parity at every geometry
    rng = np.random.default_rng(2)
    batch = _tiny_inputs(cfg, num_edges, B=B, L=16, W=9, image_size=cfg.image_size, rng=rng)
    batch["label"] = rng.integers(0, cfg.num_labels, (B,)).astype(np.int32)
    batch["weight"] = np.ones((B,), np.float32)

    def eval_loss(e) -> float:
        b = e._to_device(batch)
        return float(e.eval_step(b, confusion_init(cfg.num_labels, dev))[0])

    # the steps must train: the batch's eval loss falls (the JAX dry run
    # compares the first and last train-mode losses, which at dropout 0.5
    # move with the masks as much as with the weights)
    loss_before = eval_loss(ref)
    cm_r = confusion_init(cfg.num_labels, dev)
    ref_losses = [float(ref.train_step(batch, cm_r)) for _ in range(3)]
    cm_r = cm_r.cpu().numpy()
    loss_after = eval_loss(ref)
    _check(loss_after < loss_before,
           f"loss did not decrease: eval loss {loss_before} -> {loss_after} ({ref_losses})")
    # leg 2's records, and their eval loss on the reference trajectory's
    # weights, read now: each step of the loop below reloads ``ref``
    N = B * 2 + 1  # odd: padded tail positions exercised
    ds = _FakeFusionDS(cfg, num_edges, n=N, L=16, W=9)
    tables = dict(device_text=True, device_images=True, device=dev, num_threads=2)
    ev_traj = ref.eval_epoch(DeviceLoader(ds, B, **tables))
    paths = [p.lstrip("/") for p in tree_paths(ref.params)]
    want = _host_leaves(ref.params)

    result: dict = {"n_devices": n_devices, "device": spec["device"], "batch": B,
                    "geometries": [list(g) for g in geometries], "primary": list(primary),
                    "losses": ref_losses, "eval_loss_before": loss_before,
                    "eval_loss_after": loss_after, "parity": {}}
    eng = mesh = None  # the primary geometry's, reused by legs 2-4
    for d_ax, m_ax in geometries:
        name = f"{d_ax}x{m_ax}"
        say(f"[dryrun] 1/4 sharded-vs-single 3-step parity @ mesh ({name}) ...")
        g_mesh = create_mesh(d_ax, m_ax, device=dev.type)
        is_primary = (d_ax, m_ax) == primary
        g_eng = make_engine(cfg, g_mesh, ckpt_root if is_primary else None)
        rep: dict = {}
        if m_ax > 1:
            # the odd-sized gather tables must really split (zero-padded to
            # a multiple of the model axis), not replicate
            rep["table"] = _table_report(g_eng, cfg.vocab_size)
            _check(rep["table"]["sharded"] and rep["table"]["padding_zero"]
                   and rep["table"]["rows"] == -(-cfg.vocab_size // m_ax),
                   f"({name}): node_embedding not split over the model axis: {rep['table']}")
        local = batch_device_put(batch, g_eng.axis, dev)
        cm_s = confusion_init(cfg.num_labels, dev)
        losses, step_losses, step_worst = [], [], 0.0
        for step in range(3):
            # the one-device step from the mesh engine's own state: the
            # trajectories part by more than 1e-4 in the loss by step 2 (one
            # device alone moves it by 3e-5 between 1 and 3 CPU threads), so
            # the loss bound holds each step from one state and the
            # parameter bound holds both each step and the whole trajectory
            ref.load_model_state(tree_to(g_eng.full_params(), dev, copy=True),
                                 g_eng.batch_stats)
            ref.step = g_eng.step  # the same dropout masks
            cm_one = confusion_init(cfg.num_labels, dev)
            l_one = float(ref.train_step(batch, cm_one))
            cm_step = confusion_init(cfg.num_labels, dev)
            ls = float(g_eng.train_step(local, cm_step))
            cm_s += cm_step
            losses.append(ls)
            step_losses.append(l_one)
            _check(bool(np.isfinite(ls)), "non-finite sharded loss")
            _check(abs(ls - l_one) <= 1e-4 * max(1.0, abs(l_one)),
                   f"mesh ({name}) step {step}: sharded loss {ls} != single-device {l_one}")
            np.testing.assert_array_equal(g_eng._sum_over_ranks(cm_step.cpu().numpy())[0],
                                          cm_one.cpu().numpy())
            step_worst = max(step_worst, _worst(_host_leaves(g_eng.full_params()),
                                                _host_leaves(ref.params), paths, 5e-4, 5e-5,
                                                f"{name} step {step}"))
        cm_s = g_eng._sum_over_ranks(cm_s.cpu().numpy())[0]
        np.testing.assert_array_equal(cm_s, cm_r)
        rep.update(losses=losses, single_device_losses=step_losses,
                   max_loss_rel=max(abs(a - b) / max(1.0, abs(b))
                                    for a, b in zip(losses, step_losses)),
                   trajectory_loss_rel=[abs(a - b) / max(1.0, abs(b))
                                        for a, b in zip(losses, ref_losses)],
                   confusion_equal=bool(np.array_equal(cm_s, cm_r)),
                   step_param_worst=step_worst,
                   param_worst=_worst(_host_leaves(g_eng.full_params()), want, paths, 5e-4,
                                      5e-5, name))
        if m_ax > 1:
            rep["table_after"] = _table_report(g_eng, cfg.vocab_size)
            _check(rep["table_after"]["padding_zero"], f"({name}): padding rows moved")
        result["parity"][name] = rep
        if is_primary:
            eng, mesh = g_eng, g_mesh
        else:
            del g_eng
            gc.collect()
    data_axis, model_axis = primary

    # ---- 2. eval epoch from device tables on the primary mesh
    say("[dryrun] 2/4 fused SPMD table-gather eval epoch ...")
    plan = make_input_plan(data_axis, N, B)
    ev_s = eng.eval_epoch(DeviceLoader(ds, plan.Bd, plan=plan, **tables))
    # held to one device on the mesh engine's own weights: three float32
    # steps of these 100+-layer trunks part the two trajectories by more
    # than 1e-4 in this loss (the one-device run alone moves its eval loss
    # by 4e-3 between 1 and 3 CPU threads), and leg 1 already holds the
    # weights; this leg holds the sharded eval path
    ref.load_model_state(tree_to(eng.full_params(), dev, copy=True), eng.batch_stats)
    ev_r = ref.eval_epoch(DeviceLoader(ds, B, **tables))
    _check(ev_s.get("fused") is True, "the mesh epoch did not run the plan path")
    _check(int(np.asarray(ev_s["confusion"]).sum()) == N, "the mesh epoch lost records")
    np.testing.assert_array_equal(ev_s["confusion"], ev_r["confusion"])
    _check(abs(ev_s["loss"] - ev_r["loss"]) <= 1e-4 * max(1.0, abs(ev_r["loss"])),
           f"eval loss: sharded {ev_s['loss']} vs single {ev_r['loss']}")
    result["eval"] = {"n": N, "fused": bool(ev_s.get("fused")),
                      "confusion_sum": int(np.asarray(ev_s["confusion"]).sum()),
                      "confusion_equal": bool(np.array_equal(ev_s["confusion"],
                                                             ev_r["confusion"])),
                      "loss": ev_s["loss"], "loss_ref": ev_r["loss"],
                      "loss_ref_trajectory": ev_traj["loss"]}

    # ---- 3. checkpoint save/restore of the sharded train state
    say("[dryrun] 3/4 sharded checkpoint save/restore ...")
    before = [t.detach().clone() for t in tree_leaves(eng.params)]
    step_before = eng.step
    eng.save(metrics={"val_accuracy": float(ev_s["accuracy"])})
    eng.restore()
    after = tree_leaves(eng.params)
    ck = {"bit_equal": len(after) == len(before)
          and all(torch.equal(a, b) for a, b in zip(before, after)),
          "step": eng.step, "step_before": step_before}
    if model_axis > 1:
        ck["table"] = _table_report(eng, cfg.vocab_size)
        _check(ck["table"]["sharded"], "restore lost the split of node_embedding")
    _check(ck["bit_equal"] and eng.step == step_before,
           f"checkpoint round trip: {ck}")
    result["checkpoint"] = ck
    del eng, ref, before, after
    gc.collect()

    # ---- 4. bf16: the dtype the flagship runs.  bf16's unit roundoff is
    # 2^-8 and the split changes the order of every sum over the model
    # axis, so logits drift by a few bf16 ulps; 4e-2 of scale (~10 ulps)
    # flags a wrong split, which is O(1) wrong (__graft_entry__.py:353-366)
    say(f"[dryrun] 4/4 bf16 sharded-vs-single parity @ mesh ({data_axis}x{model_axis}) ...")
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    eng16, ref16 = make_engine(cfg16, mesh), make_engine(cfg16, None)
    local = batch_device_put(batch, eng16.axis, dev)
    whole = ref16._to_device(batch)
    with torch.no_grad():
        logits_s = eng16._apply(eng16.params, eng16.batch_stats, local, train=False,
                                generator=None)[0].float()
        logits_r = ref16._apply(ref16.params, ref16.batch_stats, whole, train=False,
                                generator=None)[0].float()
    rows = logits_s.shape[0]
    mine = logits_r[eng16.axis.rank * rows:(eng16.axis.rank + 1) * rows]
    scale = max(1.0, float(logits_r.abs().max()))
    drift = torch.tensor([float((logits_s - mine).abs().max()) / scale], dtype=torch.float64)
    dist.all_reduce(drift, op=dist.ReduceOp.MAX)
    bf16_fwd_delta = float(drift[0])
    _check(bf16_fwd_delta <= 4e-2, f"bf16 sharded forward drift {bf16_fwd_delta:.2e} > 4e-2")
    l16s = float(eng16.train_step(local, confusion_init(cfg16.num_labels, dev)))
    l16r = float(ref16.train_step(batch, confusion_init(cfg16.num_labels, dev)))
    _check(bool(np.isfinite(l16s)), "non-finite bf16 sharded loss")
    _check(abs(l16s - l16r) <= 4e-2 * max(1.0, abs(l16r)),
           f"bf16 train-step loss: sharded {l16s} vs single {l16r}")
    result["bf16"] = {"fwd_drift": bf16_fwd_delta, "loss": l16s, "loss_ref": l16r}

    say(f"dryrun_multichip({n_devices}): 3-step parity ok @ meshes "
        f"{['%dx%d' % g for g in geometries]}, "
        f"losses={['%.4f' % l for l in ref_losses]}, "
        f"fused SPMD eval epoch ok (N={N}) @ ({data_axis}x{model_axis}), "
        f"checkpoint roundtrip ok, bf16 leg ok (fwd drift "
        f"{bf16_fwd_delta:.1e}, loss {l16s:.4f} vs {l16r:.4f})")
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "k1": edge_max.launches, "k2": edge_max.bwd_launches}, f)
    if rank == 0:
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dryrun-rank"]:
        _dryrun_rank(argv[1])
    elif argv[:1] == ["multichip"]:
        # the summary line, then the numbers behind it and the wall seconds
        print(json.dumps(dryrun_multichip(int(argv[1]) if len(argv) > 1 else 8)))
    else:
        fn, args = entry()
        out = fn(*args)
        print("entry forward:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
