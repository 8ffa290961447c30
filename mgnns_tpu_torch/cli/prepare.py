"""Offline dataset-preparation CLI, a copy of the JAX package's
``mgnns_tpu/cli/prepare.py`` on the port's own modules: the same
subcommands, flags and output files.

Covers the reference's one-time host tooling:

- ``vocab``      — build ``vocab-{k}.txt`` + ``freq.csv`` from the train
                   split (reference ``utils/vocab_new.py:35-70``);
- ``adj``        — build the ``{'nums','adj'}`` co-occurrence pickle from
                   per-sample object/place label lists (reference
                   ``utils/util.py:325-380`` ``get_Adj``);
- ``pmi``        — build and cache the PMI graph as an ``.npz`` (the
                   reference recomputed ``cal_PMI`` on every model build,
                   ``models/Multi_GCN_Multihead_att.py:603``);
- ``pack-glove`` — pack GloVe text embeddings into the pickles the model
                   consumes: per-vocab matrix, object/place class matrices,
                   label matrix (reference
                   ``utils/Multi_GCN_Co_att_dataset.py:143-173``,
                   ``models/Text_GCN.py:105-121``).

Usage: ``python -m mgnns_tpu_torch.cli.prepare <subcommand> --help``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


def _read_anno(data_root: str, phase: str) -> list[dict]:
    from mgnns_tpu_torch.data.text import read_anno

    return read_anno(data_root, phase)


def cmd_vocab(args) -> None:
    from mgnns_tpu_torch.graphs.vocab import build_vocab, save_vocab
    from collections import Counter

    records = _read_anno(args.data_root_path, "train")
    texts = [r["text"] for r in records]
    vocab = build_vocab(texts, args.text_min_count)
    freq = Counter(w for t in texts for w in t.split(" "))
    path = os.path.join(args.data_root_path, "vocab", f"vocab-{args.text_min_count}.txt")
    save_vocab(vocab, path, dict(freq))
    print(f"wrote {path} ({len(vocab)} entries)")


def cmd_adj(args) -> None:
    from mgnns_tpu_torch.graphs.cooccur import build_cooccurrence

    label_sets = []
    for phase in args.splits:
        for rec in _read_anno(args.data_root_path, phase):
            label_sets.append(rec.get(args.key, []))
    result = build_cooccurrence(label_sets, args.num_classes)
    out = args.output or os.path.join(
        args.data_root_path, "adj", f"{args.dataset}_{args.key}_adj.pkl"
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(result, f)
    print(f"wrote {out} (num_classes={args.num_classes}, samples={len(label_sets)})")


def cmd_pmi(args) -> None:
    from mgnns_tpu_torch.graphs.pmi import cal_pmi
    from mgnns_tpu_torch.graphs.vocab import get_vocab_list

    vocab = get_vocab_list(args.data_root_path, args.data_root_path, args.text_min_count)
    records = _read_anno(args.data_root_path, args.phase)
    graph = cal_pmi([r["text"] for r in records], vocab,
                    window_size=args.window_size,
                    min_cooccurrence=args.min_cooccurence)
    out = args.output or os.path.join(
        args.data_root_path,
        f"pmi_w{args.window_size}_mc{args.min_cooccurence}_tc{args.text_min_count}.npz",
    )
    np.savez_compressed(out, vocab_size=graph.vocab_size, keys=graph.keys, pmi=graph.pmi)
    print(f"wrote {out} (V={graph.vocab_size}, E={graph.num_edges - 1})")


def load_pmi_npz(path: str):
    from mgnns_tpu_torch.graphs.pmi import PmiGraph

    z = np.load(path)
    return PmiGraph(int(z["vocab_size"]), z["keys"], z["pmi"])


def _load_glove_txt(path: str) -> dict[str, np.ndarray]:
    table = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < 10:
                continue  # word2vec-style header line
            table[parts[0]] = np.asarray(parts[1:], np.float32)
    return table


def cmd_pack_glove(args) -> None:
    table = _load_glove_txt(args.glove_txt)
    fallback = table.get("the")

    def pack(words):
        return np.stack([table.get(w, fallback) for w in words]).astype(np.float32)

    if args.kind == "vocab":
        from mgnns_tpu_torch.graphs.vocab import get_vocab_list

        words = get_vocab_list(args.data_root_path, args.data_root_path, args.text_min_count)
        out = args.output or os.path.join(
            args.data_root_path, "glove_embedding",
            f"glove_embedding_{args.text_min_count}.pkl",
        )
    elif args.kind == "labels":
        with open(os.path.join(args.data_root_path, "label.json")) as f:
            words = list(json.load(f))
        out = args.output or os.path.join(args.data_root_path, "tumblr_label_glove.pkl")
    else:  # classes: one name per line (COCO objects / Places365 categories)
        with open(args.class_names) as f:
            words = [l.strip() for l in f if l.strip()]
        out = args.output
        if out is None:
            raise SystemExit("--output required for --kind classes")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(pack(words), f)
    print(f"wrote {out} ({len(words)} x {len(fallback)})")


def cmd_join(args) -> None:
    """Join per-split text/object/place annotation files on 'id' into the
    ``*_all_anno.json`` format (reference ``utils/util.py:190-261``
    ``contac_jsons``/``contac_object_and_place_jsons`` — their O(N^2) nested
    file scans replaced by dict joins)."""
    def read_jsonl(path):
        with open(path) as f:
            return [json.loads(l) for l in f if l.strip()]

    base = {r["id"]: dict(r) for r in read_jsonl(args.base)}
    for extra in args.extra or []:
        for r in read_jsonl(extra):
            if r["id"] in base:
                for k, v in r.items():
                    base[r["id"]].setdefault(k, v)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        for r in base.values():
            f.write(json.dumps(r) + "\n")
    print(f"wrote {args.output} ({len(base)} records)")


def cmd_filter_short(args) -> None:
    """Drop records with fewer than ``min_words`` tokens (reference
    ``remove_short``, ``utils/util.py:263-291``)."""
    kept = []
    with open(args.input) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if len(rec["text"].split(" ")) >= args.min_words:
                kept.append(rec)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        for r in kept:
            f.write(json.dumps(r) + "\n")
    print(f"wrote {args.output} ({len(kept)} records kept)")


def cmd_upsample(args) -> None:
    """Append duplicates of one label's records to balance classes
    (reference ``up_sampling``, ``utils/util.py:294-306`` — generalized to
    any label and an explicit output rather than in-place append)."""
    with open(args.input) as f:
        rows = [json.loads(l) for l in f if l.strip()]
    dup = [r for r in rows if r["label"] == args.label] * args.times
    out = args.output or args.input
    with open(out, "w") as f:
        for r in rows + dup:
            f.write(json.dumps(r) + "\n")
    print(f"wrote {out} (+{len(dup)} upsampled '{args.label}' records)")


def cmd_label_stats(args) -> None:
    """Per-label record counts (reference ``calculate_label_num``,
    ``utils/util.py:308-321`` — which, note, miscounts 'neutral' via a
    copy-paste bug; this counts correctly)."""
    from collections import Counter

    counts: Counter = Counter()
    with open(args.input) as f:
        for line in f:
            if line.strip():
                counts[json.loads(line)["label"]] += 1
    for label, n in sorted(counts.items()):
        print(f"{label}\t{n}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MGNNS data preparation (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("vocab", help="build vocab-{k}.txt from the train split")
    v.add_argument("--data_root_path", default="data")
    v.add_argument("--text_min_count", type=int, default=5)
    v.set_defaults(fn=cmd_vocab)

    a = sub.add_parser("adj", help="build co-occurrence adjacency pickle")
    a.add_argument("--data_root_path", default="data")
    a.add_argument("--dataset", default="tumblr")
    a.add_argument("--key", default="objects", choices=["objects", "places"])
    a.add_argument("--num_classes", type=int, default=80)
    a.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    a.add_argument("--output", default=None)
    a.set_defaults(fn=cmd_adj)

    m = sub.add_parser("pmi", help="build + cache the PMI graph")
    m.add_argument("--data_root_path", default="data")
    m.add_argument("--phase", default="train")
    m.add_argument("--text_min_count", type=int, default=5)
    m.add_argument("--window_size", type=int, default=6)
    m.add_argument("--min_cooccurence", type=int, default=2)
    m.add_argument("--output", default=None)
    m.set_defaults(fn=cmd_pmi)

    g = sub.add_parser("pack-glove", help="pack GloVe txt into model pickles")
    g.add_argument("--glove_txt", required=True)
    g.add_argument("--kind", choices=["vocab", "labels", "classes"], required=True)
    g.add_argument("--data_root_path", default="data")
    g.add_argument("--text_min_count", type=int, default=5)
    g.add_argument("--class_names", default=None)
    g.add_argument("--output", default=None)
    g.set_defaults(fn=cmd_pack_glove)

    j = sub.add_parser("join", help="join annotation JSONL files on id")
    j.add_argument("--base", required=True)
    j.add_argument("--extra", nargs="*", default=[])
    j.add_argument("--output", required=True)
    j.set_defaults(fn=cmd_join)

    fs = sub.add_parser("filter-short", help="drop records with few tokens")
    fs.add_argument("--input", required=True)
    fs.add_argument("--output", required=True)
    fs.add_argument("--min_words", type=int, default=5)
    fs.set_defaults(fn=cmd_filter_short)

    u = sub.add_parser("upsample", help="duplicate one label's records")
    u.add_argument("--input", required=True)
    u.add_argument("--label", required=True)
    u.add_argument("--times", type=int, default=1)
    u.add_argument("--output", default=None)
    u.set_defaults(fn=cmd_upsample)

    ls = sub.add_parser("label-stats", help="per-label record counts")
    ls.add_argument("--input", required=True)
    ls.set_defaults(fn=cmd_label_stats)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
