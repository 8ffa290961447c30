"""Input plans: which records each data-axis position owns, and the epochs
over them.

Port of the JAX package's ``mgnns_tpu/parallel/input.py:46-253``, the same
numpy arithmetic, so that global batch ``b`` holds the same records in both
packages:

- every **data-axis position** ``d`` (a rank here: one card each) owns a
  fixed subset of records, assigned round-robin within its host's
  contiguous record slice (record ``j`` of a host with positions
  ``[p0..p0+k)`` goes to position ``p0 + j % k``, local row ``j // k``);
- a position's rows are padded to the uniform size ``S``, and an epoch is a
  ``[num_batches, B]`` matrix whose column block for position ``d`` holds
  **position-local** row ids; shuffling permutes within each position with
  a stream seeded by ``(seed + epoch, position)``;
- global batch ``b`` is the concatenation of the positions' blocks in
  position order, so rank ``r`` runs rows ``[r * Bd, (r + 1) * Bd)`` of it.

In the JAX package the device tables are one global array sharded over
``'data'`` and the gather runs shard-locally under ``shard_map``.  Here a
rank's :class:`~mgnns_tpu_torch.data.loader.DeviceLoader` holds only its
position's ``S`` rows and gathers them with its ordinary table gather: the
gather needs no collective in either package.

The layout of positions over hosts is ``torchrun``'s: host ``q`` runs
positions ``[q * k, (q + 1) * k)``, ``k`` ranks per host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mgnns_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True, eq=False)
class InputPlan:
    """Static record-to-position assignment of one split on one data axis,
    as this host sees it, and the position of this rank."""

    D: int                        # global data-axis size
    S: int                        # uniform padded rows per data position
    Bd: int                       # batch slots per data position
    num_batches: int              # epoch length in global batches
    n_global: int                 # real records across all hosts
    position_valid: np.ndarray    # [D] real row count of every position
    local_positions: np.ndarray   # sorted data-axis positions of this host
    local_rows: np.ndarray        # [D_local, S] dataset-LOCAL row ids, -1 pad
    position: int                 # this rank's position, one of local_positions

    @property
    def batch_size(self) -> int:
        return self.D * self.Bd

    @property
    def table_rows(self) -> int:
        return self.D * self.S

    @property
    def slot(self) -> int:
        """This rank's index among its host's positions."""
        return int(self.position - self.local_positions[0])

    def local_table_rows(self) -> np.ndarray:
        """[D_local*S] dataset-local row id per host table row (pads clamped
        to row 0 — never addressed with nonzero weight)."""
        flat = self.local_rows.reshape(-1)
        return np.where(flat < 0, 0, flat)

    def rank_table_rows(self) -> np.ndarray:
        """[S] dataset-local row id of each row of this rank's tables."""
        rows = self.local_rows[self.slot]
        return np.where(rows < 0, 0, rows)

    def rank_columns(self, mat: np.ndarray) -> np.ndarray:
        """This rank's ``[..., Bd]`` block of a host matrix ``[..., D_local*Bd]``."""
        return mat[..., self.slot * self.Bd:(self.slot + 1) * self.Bd]

    def batch_weight_sums(self) -> np.ndarray:
        """[num_batches] GLOBAL valid-record count of every batch, the same
        on every rank (from position_valid, not from local data), so the
        loss's normaliser needs no collective."""
        b = np.arange(self.num_batches)[:, None]
        return np.clip(self.position_valid[None, :] - b * self.Bd,
                       0, self.Bd).sum(axis=1).astype(np.float64)


def _round_robin_counts(n: int, k: int) -> np.ndarray:
    """Real row count per position when ``n`` records round-robin over ``k``
    positions (position i gets ceil((n - i) / k))."""
    i = np.arange(k)
    return np.maximum(0, -(-(n - i) // k))


def make_input_plan(D: int, n_local: int, per_host_batch: int, *, n_global: int | None = None,
                    position: int | None = None, process_index: int | None = None,
                    process_count: int | None = None) -> InputPlan:
    """The record-to-position assignment of a split on a data axis of ``D``
    positions.

    ``n_local`` is this host's record count (its contiguous slice under
    multihost, the whole split on one host); ``per_host_batch`` this host's
    share of the global batch.  ``n_global`` must be the global split size
    under multihost (``dataset.global_len``), so that padded sizes and epoch
    lengths agree across hosts.  ``position`` is this rank's data-axis
    position (the rank of the process group by default, else the host's
    first); ``process_index`` / ``process_count`` default to
    :mod:`~mgnns_tpu_torch.parallel.multihost`'s.
    """
    me = multihost.process_index() if process_index is None else process_index
    nproc = multihost.process_count() if process_count is None else process_count
    if D % nproc:
        raise ValueError(f"{nproc} hosts do not split a data axis of {D} positions evenly")
    dpp = D // nproc
    local_positions = np.arange(me * dpp, (me + 1) * dpp)
    if per_host_batch % dpp:
        raise ValueError(
            f"per-host batch {per_host_batch} must divide by this process's "
            f"{dpp} data-axis positions")
    Bd = per_host_batch // dpp

    n_global = n_local if n_global is None else n_global
    # every host's position_valid from global facts alone (global N, the
    # balanced contiguous record split, the layout), the same on every rank
    position_valid = np.zeros(D, np.int64)
    base, extra = divmod(n_global, nproc)
    for q in range(nproc):
        n_q = base + (1 if q < extra else 0)
        position_valid[q * dpp:(q + 1) * dpp] = _round_robin_counts(n_q, dpp)
    if nproc == 1 and n_local != n_global:
        # single-host caller with a pre-sliced dataset: trust n_local
        position_valid = _round_robin_counts(n_local, D)

    S = max(int(position_valid.max()), 1)
    num_batches = max(1, -(-S // Bd))

    local_rows = np.full((dpp, S), -1, np.int64)
    for k in range(dpp):
        rows = np.arange(k, n_local, dpp)
        local_rows[k, : len(rows)] = rows
    expect = position_valid[local_positions]
    got = (local_rows >= 0).sum(axis=1)
    if not np.array_equal(got, expect):
        raise ValueError(
            f"local sample count {n_local} disagrees with the global split: "
            f"per-position counts {got.tolist()} != expected {expect.tolist()} "
            "(pass the dataset's global_len as n_global)")

    if position is None:
        import torch.distributed as dist

        position = dist.get_rank() if dist.is_initialized() else int(local_positions[0])
    if position not in local_positions:
        raise ValueError(f"position {position} is not one of this host's positions "
                         f"{local_positions.tolist()}")
    return InputPlan(D=D, S=S, Bd=Bd, num_batches=num_batches, n_global=n_global,
                     position_valid=position_valid, local_positions=local_positions,
                     local_rows=local_rows, position=int(position))


def epoch_index_plan(plan: InputPlan, epoch: int, seed: int, shuffle: bool):
    """(idx, weight, rows): this host's epoch column blocks, all
    ``[num_batches, D_local*Bd]`` (:meth:`InputPlan.rank_columns` takes a
    rank's).

    ``idx`` holds POSITION-LOCAL row ids (into the position's S rows);
    ``weight`` marks real records; ``rows`` maps back to dataset-local row
    ids (pads -> the position's first row, masked by weight) for labels and
    prediction dumps.  Shuffling permutes WITHIN each position with a
    per-(epoch, position) stream, so the order is the same on every host.
    """
    dpp = len(plan.local_positions)
    nb, Bd = plan.num_batches, plan.Bd
    idx = np.zeros((nb, dpp * Bd), np.int32)
    wt = np.zeros((nb, dpp * Bd), np.float32)
    rows = np.zeros((nb, dpp * Bd), np.int64)
    for k, d in enumerate(plan.local_positions):
        n_d = int(plan.position_valid[d])
        order = np.arange(n_d)
        if shuffle and n_d > 1:
            np.random.default_rng((seed + epoch, int(d))).shuffle(order)
        padded = np.zeros(nb * Bd, np.int64)
        padded[:n_d] = order
        block = slice(k * Bd, (k + 1) * Bd)
        idx[:, block] = padded.reshape(nb, Bd)
        w = (np.arange(nb * Bd) < n_d).astype(np.float32)
        wt[:, block] = w.reshape(nb, Bd)
        rows[:, block] = plan.local_rows[k][padded].clip(min=0).reshape(nb, Bd)
    return idx, wt, rows
