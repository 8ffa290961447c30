"""Typed configuration, copied from the JAX package's ``mgnns_tpu/config.py``.

Field names and defaults are the JAX package's, so one configuration drives
both.  The port computes in float32 only: ``compute_dtype="bfloat16"`` raises
until the bf16 slice lands (``ROADMAP.md``, queue 1).  ``bn_mode``,
``remat_trunks``, ``remat_policy`` and ``freeze_trunks`` act in training as
in the JAX package.  ``unroll_trunks`` and ``stem_s2d`` only change how XLA
lowers the trunks there, not the maths, and are accepted and ignored.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TextGraphConfig:
    """Parameters of the global PMI word graph and per-doc windowed subgraphs."""

    text_min_count: int = 5      # vocab frequency threshold
    window_size: int = 6         # PMI co-occurrence window
    ngram: int = 4               # per-doc sliding-window edge radius
    min_cooccurrence: int = 2    # pair-count threshold
    max_len: int = 100           # hard cap on tokens per document

    @property
    def window_width(self) -> int:
        """Window slots per position: +/-ngram plus the center (self loop)."""
        return 2 * self.ngram + 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of the MGNNS fusion model."""

    num_labels: int = 7             # 7 TumEmo emotions / 3 for MVSA
    vocab_size: int = 20153         # len(vocab-5.txt); set from data in practice
    emb_size: int = 300             # GloVe dim
    hidden_size: int = 150          # LSTM hidden per direction
    num_layers: int = 2             # LSTM layers
    bidirectional: bool = True
    dropout: float = 0.5
    stack_num: int = 2              # cross-modal MHA stack depth
    n_head: int = 4                 # cross-modal MHA heads
    d_kv: int = 128                 # per-head dim in cross-modal MHA
    is_regu: bool = False           # head-diversity regularizer
    n_label_heads: int = 5          # heads in label-query image attention
    object_num_classes: int = 80    # COCO objects
    place_num_classes: int = 365    # Places365 scenes
    object_t: float = 0.4           # co-occurrence binarization threshold
    place_t: float = 0.3
    gama: float = 0.2               # gen_A reweight p
    in_channel: int = 300           # image-GCN input dim (label GloVe)
    gcn_hidden: int = 1024          # gc1 out
    gcn_out: int = 2048             # gc2 out
    image_size: int = 448
    text_dropout: float = 0.5
    edges_num: int = 1              # PMI edge-table size incl. reserved id 0
    trainable_edges_init_one: bool = True
    compute_dtype: str = "float32"
    bn_mode: str = "batch"          # 'batch': train-mode BN; 'frozen': running stats
    # 'none', 'trunk' (checkpoint each trunk) or 'block' (each bottleneck
    # block, which wins over remat_trunks); remat_trunks aliases 'trunk'
    remat_trunks: bool = False
    remat_policy: str = "none"
    freeze_trunks: bool = False     # no trunk gradients; the optimizer freezes them
    # XLA lowering choices of the JAX package; no effect on the maths
    unroll_trunks: bool = False
    stem_s2d: bool = False

    def __post_init__(self):
        if self.compute_dtype == "bfloat16":
            raise NotImplementedError(
                "compute_dtype='bfloat16' is not ported yet: the bf16 autocast "
                "slice is queued in ROADMAP.md (queue 1, item 3)")
        if self.compute_dtype != "float32":
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    @property
    def bi_hidden_size(self) -> int:
        return (2 if self.bidirectional else 1) * self.hidden_size

    @property
    def cdtype(self) -> torch.dtype:
        return torch.float32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Filesystem layout of the dataset artifacts (reference ``data/``)."""

    data_root_path: str = "data"
    dataset: str = "tumblr"
    object_inp_name: str = "data/glove/object_glove_word2vec.pkl"
    place_inp_name: str = "data/glove/place_glove_word2vec.pkl"
    label_glove_name: str = "data/tumblr_label_glove.pkl"
    object_adj_file: str = "data/adj/tumblr_objects_adj.pkl"
    place_adj_file: str = "data/adj/tumblr_resnet50_places_adj.pkl"
    image_root: str = "."
    image_backend: str = "synthetic"  # 'pil' | 'synthetic'
