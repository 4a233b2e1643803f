"""OGBL-DDI-style link-prediction data (``msha_gnn_tpu/data/ogb.py``).

* :func:`load_ogbl_ddi` reads a local OGB-format copy of ogbl-ddi
  (``<root>/ogbl_ddi/raw/edge.csv[.gz]`` and, when present, the official
  ``split/target/{train,valid,test}.pt``).  It never downloads.
* :func:`synthetic_ddi` is the documented stand-in with ogbl-ddi's node
  count and a heavy-tailed degree law.
* :func:`split_edges` makes the train / valid / test edge split, the
  message graph of the train edges (both directions) and a fixed set of
  uniform negative pairs.

The numpy draws are the JAX package's, so one seed gives both packages
the same arrays.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..graph import BipartiteGraph


def _sym_graph(src, dst, n, pad_to_multiple=128) -> BipartiteGraph:
    """Undirected homogeneous graph: both directions of every edge."""
    s = np.concatenate([src, dst])
    r = np.concatenate([dst, src])
    return BipartiteGraph.from_coo(
        s, r, np.ones(len(s), np.float32), n_src=n, n_dst=n,
        pad_to_multiple=pad_to_multiple, combine_duplicates=True,
    )


def _load_split_pt(path: str) -> Dict[str, np.ndarray]:
    """One OGB split file (a torch-pickled dict of edge arrays).

    ``weights_only=True`` never unpickles arbitrary objects; split files
    that hold numpy arrays need numpy's reconstruct globals, which are
    allowed and nothing else.
    """
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        safe = [np.ndarray, np.dtype]
        try:
            from numpy.core.multiarray import _reconstruct

            safe.append(_reconstruct)
        except Exception:
            pass
        try:  # numpy >= 1.25 pickles dtype instances via these classes
            from numpy import dtypes as _np_dtypes

            safe.extend(getattr(_np_dtypes, n) for n in dir(_np_dtypes)
                        if n.endswith("DType"))
        except Exception:
            pass
        with torch.serialization.safe_globals(safe):
            blob = torch.load(path, map_location="cpu", weights_only=True)
    return {k: np.asarray(v) for k, v in blob.items()}


def load_ogbl_ddi(root: str) -> Dict:
    """A local OGB-format ogbl-ddi copy; FileNotFoundError if absent.

    Layout (the official ``ogb.linkproppred`` download tree)::

        <root>/ogbl_ddi/raw/edge.csv[.gz]          # [E, 2] int edge list
        <root>/ogbl_ddi/split/target/train.pt      # {'edge': [E, 2]}
        <root>/ogbl_ddi/split/target/valid.pt      # + {'edge_neg': [K, 2]}
        <root>/ogbl_ddi/split/target/test.pt

    With the split files present, the official splits come back under
    ``"split"`` and :func:`split_edges` uses them as they are.
    """
    raw = os.path.join(root, "ogbl_ddi", "raw")
    for name in ("edge.csv.gz", "edge.csv"):
        path = os.path.join(raw, name)
        if not os.path.exists(path):
            continue
        opener = gzip.open if name.endswith(".gz") else open
        with opener(path, "rt") as f:
            edges = np.loadtxt(f, delimiter=",", dtype=np.int64)
        src, dst = edges[:, 0], edges[:, 1]
        n = int(edges.max()) + 1
        out = {"src": src, "dst": dst, "n": n, "name": "ogbl-ddi"}
        split_dir = os.path.join(root, "ogbl_ddi", "split", "target")
        if os.path.exists(os.path.join(split_dir, "train.pt")):
            split = {}
            for part in ("train", "valid", "test"):
                blob = _load_split_pt(os.path.join(split_dir, f"{part}.pt"))
                split[part] = blob["edge"]
                if "edge_neg" in blob:
                    split[f"{part}_neg"] = blob["edge_neg"]
            out["split"] = split
            n_all = max(int(v.max()) for v in split.values() if v.size)
            out["n"] = max(n, n_all + 1)
        return out
    raise FileNotFoundError(f"no OGB edge file under {raw}")


def synthetic_ddi(n: int = 4267, n_edges: int = 1_334_889, seed: int = 0,
                  alpha: float = 1.2) -> Dict:
    """Power-law stand-in with ogbl-ddi's node count: ``n_edges`` draws of
    both endpoints from ``p(i) ~ 1 / i**alpha``, self-loops dropped and
    undirected pairs deduplicated."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n + 1) ** alpha
    p /= p.sum()
    src = rng.choice(n, n_edges, p=p).astype(np.int64)
    dst = rng.choice(n, n_edges, p=p).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    uniq = np.unique(lo * n + hi)
    return {
        "src": (uniq // n).astype(np.int64),
        "dst": (uniq % n).astype(np.int64),
        "n": n,
        "name": f"synthetic-ddi(seed={seed})",
    }


def load_ddi(root: Optional[str] = None, **synth_kwargs) -> Dict:
    """The local OGB copy when present, :func:`synthetic_ddi` otherwise."""
    if root is not None:
        try:
            return load_ogbl_ddi(root)
        except FileNotFoundError:
            pass
    return synthetic_ddi(**synth_kwargs)


def split_edges(data: Dict, valid_frac: float = 0.05, test_frac: float = 0.05,
                num_neg: int = 100_000, seed: int = 0,
                pad_to_multiple: int = 128) -> Dict:
    """OGB-style splits.  The message graph holds only the train edges;
    valid and test positives are held out; ``neg`` is a fixed set of
    uniform pairs.  An official split in ``data`` is used as it is."""
    n = data["n"]
    if "split" in data:
        sp = data["split"]
        tr, va, te = sp["train"], sp["valid"], sp["test"]
        neg = sp.get("test_neg", sp.get("valid_neg"))
        out = {
            "n": n,
            "name": data["name"],
            "graph": _sym_graph(tr[:, 0], tr[:, 1], n, pad_to_multiple),
            "train_pos": (tr[:, 0], tr[:, 1]),
            "valid_pos": (va[:, 0], va[:, 1]),
            "test_pos": (te[:, 0], te[:, 1]),
            "neg": (neg[:, 0], neg[:, 1]),
        }
        if "valid_neg" in sp:
            out["valid_neg"] = (sp["valid_neg"][:, 0], sp["valid_neg"][:, 1])
        return out
    rng = np.random.default_rng(seed)
    src, dst = data["src"], data["dst"]
    e = len(src)
    perm = rng.permutation(e)
    n_valid = int(e * valid_frac)
    n_test = int(e * test_frac)
    test_ids = perm[:n_test]
    valid_ids = perm[n_test: n_test + n_valid]
    train_ids = perm[n_test + n_valid:]
    neg = rng.integers(0, n, (num_neg, 2)).astype(np.int64)
    return {
        "n": n,
        "name": data["name"],
        "graph": _sym_graph(src[train_ids], dst[train_ids], n,
                            pad_to_multiple),
        "train_pos": (src[train_ids], dst[train_ids]),
        "valid_pos": (src[valid_ids], dst[valid_ids]),
        "test_pos": (src[test_ids], dst[test_ids]),
        "neg": (neg[:, 0], neg[:, 1]),
    }
