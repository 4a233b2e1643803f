"""Edge bucketing for the ring-scheduled distributed SpMM
(``msha_gnn_tpu/data/_native.py::ring_buckets`` and its numpy fallback,
``msha_gnn_tpu/parallel/dist_spmm.py:294-317``).

Each edge goes to the bucket ``(dev, shard)`` of its sender's row block
and its receiver's column block.  Within a bucket the edges keep their
input (CSR) order: the order of the JAX package's native counting fill
and of its runtime-weight layout.  Its numpy fallback sorts a bucket by
receiver instead; either order gives the same sums up to float32
rounding.
"""

from __future__ import annotations

import numpy as np


def ring_buckets(senders, receivers, weights, k: int, row_blk: int,
                 dst_blk: int, min_bucket: int = 8, *,
                 with_inv: bool = False):
    """``(s_b, rl_b, w_b)`` of shape ``[k, k, e_b]``, ``e_b`` the largest
    bucket (at least ``min_bucket``): senders localised to the device's row
    range (pad ``row_blk``), receivers localised to the shard's range (pad
    0), weights (pad 0; None gives ones).  ``with_inv`` adds ``inv``
    [k, k, e_b] int64, each slot's input edge index (pad ``E``)."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    e = s.shape[0]
    w = (np.ones(e, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    dev = np.minimum(s // row_blk, k - 1)
    shard = np.minimum(r // dst_blk, k - 1)
    flat = dev * k + shard
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=k * k)
    e_b = max(int(counts.max()) if e else 0, min_bucket)
    start = np.zeros(k * k, np.int64)
    start[1:] = np.cumsum(counts)[:-1]
    f_o = flat[order]
    pos = np.arange(e, dtype=np.int64) - start[f_o]
    de, sh = dev[order], shard[order]
    s_b = np.full((k, k, e_b), row_blk, np.int32)
    rl_b = np.zeros((k, k, e_b), np.int32)
    w_b = np.zeros((k, k, e_b), np.float32)
    s_b[de, sh, pos] = s[order] - de * row_blk
    rl_b[de, sh, pos] = r[order] - sh * dst_blk
    w_b[de, sh, pos] = w[order]
    if not with_inv:
        return s_b, rl_b, w_b
    inv = np.full((k, k, e_b), e, np.int64)
    inv[de, sh, pos] = order
    return s_b, rl_b, w_b, inv
