"""Typed configuration, copied from the JAX package's ``mgnns_tpu/config.py``.

Field names and defaults are the JAX package's, so one configuration drives
both.  ``compute_dtype`` is ``"float32"`` or ``"bfloat16"``; as in the JAX
package, bf16 reaches the ResNet trunks and the image normalization only
(:mod:`mgnns_tpu_torch.nn.resnet`), and parameters stay float32.  ``bn_mode``,
``remat_trunks``, ``remat_policy`` and ``freeze_trunks`` act in training as
in the JAX package.  ``unroll_trunks`` and ``stem_s2d`` only change how XLA
lowers the trunks there, not the maths, and are accepted and ignored.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
class MoeEncoderConfig:
    """A ``deepseek_v3`` text encoder (:mod:`mgnns_tpu_torch.nn.moe`); the
    defaults are Moonlight-16B-A3B's published sizes, with this chip's
    share of an expert-parallel deployment over 8 chips: experts 0-7 of
    64 held, and 20,480 of the 163,840 embedding rows."""

    hidden_size: int = 2048
    num_layers: int = 27
    first_dense: int = 1            # first_k_dense_replace
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264  # the dense layers' MLP
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    experts_held: tuple = tuple(range(8))
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    vocab_rows: int = 20480         # the embedding rows held

    def __post_init__(self):
        held = tuple(int(e) for e in self.experts_held)
        if not held or len(set(held)) != len(held) or not all(
                0 <= e < self.n_routed_experts for e in held):
            raise ValueError(f"experts_held {self.experts_held!r} must be distinct experts of "
                             f"0..{self.n_routed_experts - 1}")
        object.__setattr__(self, "experts_held", held)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


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
    # a deepseek_v3 stack in place of the embedding and the BiLSTM memory
    # bank (nn/moe.py); None: the BiLSTM, today's model
    text_encoder: MoeEncoderConfig | None = None

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    @property
    def bi_hidden_size(self) -> int:
        return (2 if self.bidirectional else 1) * self.hidden_size

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


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
