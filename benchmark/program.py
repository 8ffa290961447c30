"""The system under test, built from a cell's inputs through the port's
public entries (``mgnns_tpu_torch``: ``ModelConfig``, ``mgnns_apply``,
``TumblrDataset``, ``DeviceLoader``, ``Engine``, ``Predictor``,
``BatchingFrontend``).  The benchmark hands it the artifacts a user would:
the vocabulary, the PMI graph, the records or posts, the weights."""

from __future__ import annotations

import os


def graph_config(cfg: dict):
    from mgnns_tpu_torch.config import TextGraphConfig

    return TextGraphConfig(window_size=cfg["window_size"], ngram=cfg["ngram"],
                           min_cooccurrence=cfg["min_cooccurrence"], max_len=cfg["max_len"])


def pmi_graph(vocab: list[str], keys, pmi):
    from mgnns_tpu_torch.graphs.pmi import PmiGraph

    return PmiGraph(len(vocab), keys, pmi)


def model_config(cfg: dict, params: dict, num_edges: int):
    from mgnns_tpu_torch.config import ModelConfig

    keys = ("num_labels", "vocab_size", "emb_size", "hidden_size", "num_layers", "stack_num",
            "n_head", "d_kv", "n_label_heads", "object_num_classes", "place_num_classes",
            "object_t", "place_t", "gama", "in_channel", "gcn_hidden", "gcn_out", "image_size",
            "dropout", "text_dropout")
    return ModelConfig(edges_num=num_edges, compute_dtype=params["compute_dtype"],
                       bn_mode=params.get("bn_mode", "batch"), **{k: cfg[k] for k in keys})


def fusion_apply(mcfg, consts):
    """``Engine``'s ``apply_fn`` of the fusion model over ``consts``."""
    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    def apply_fn(p, bs, batch, *, train, generator, axis=None, model=None):
        logits, new_bs, _ = mgnns_apply(p, bs, consts, batch, cfg=mcfg, train=train,
                                        generator=generator, axis=axis, model=model)
        return logits, new_bs

    return apply_fn


def dataset(cfg: dict, records: list[dict], vocab, graph, root: str):
    """A split of ``records`` whose pixels are the synthetic images keyed by
    record id (``root`` holds its label map)."""
    from mgnns_tpu_torch.config import DataConfig
    from mgnns_tpu_torch.data.dataset import TumblrDataset

    return TumblrDataset(DataConfig(data_root_path=root, image_backend="synthetic"),
                         graph_config(cfg), "val", vocab, graph, image_size=cfg["image_size"],
                         records=records)


def loader(ds, batch: int, device):
    """The split in device tables, in order, as an epoch plan's feed."""
    from mgnns_tpu_torch.data.loader import DeviceLoader

    return DeviceLoader(ds, batch, shuffle=False, num_threads=min(8, os.cpu_count() or 1),
                        device_images=True, device_text=True, device=device)
