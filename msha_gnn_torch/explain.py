"""Attention explanation (``msha_gnn_tpu/explain.py``): the reference's
Record() / Explainer pipeline from MSHA's factored attention.

The reference re-runs all N sources with a record flag that fills dense
[N, M] and [N, N] coefficient buffers (about 6 GB at N = 39 K), dumps an
npz, then takes per-row argmax sets and maps indices to names.  Here the
same artefacts come from the factored form:

* the inter channel's [N, M] attention does not depend on the batch, so
  one recorded forward gives it; the top K per row (source -> recipients)
  and per column (recipient -> sources) come from a stable descending
  sort, so tied values keep the lower index first, as ``jax.lax.top_k``
  does (masked recipients have attention exactly 0, so ties are common);
* a city / province row of the reference's buffer is the node's recorded
  weight over the members of its clique, so its argmax set is the clique's
  member list, taken from the grouping without an [N, N] buffer.

Plain PyTorch and numpy: no kernel of the port runs here.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .data.flow import DEFAULT_DATA_DIR, load_flow_graph, load_index_match
from .graph import Grouping


def top_k_per_row(matrix, k: int):
    """[N, M] (tensor or array) -> ([N, k] indices, [N, k] values) as
    numpy, each row descending, ties in index order."""
    m = torch.as_tensor(matrix)
    vals, idx = torch.sort(m, dim=1, descending=True, stable=True)
    return idx[:, :k].cpu().numpy(), vals[:, :k].cpu().numpy()


def clique_members(grouping: Grouping, cap: Optional[int] = None):
    """Per node, the member list of its clique (the reference's city /
    province argmax set), capped at ``cap`` members."""
    gid = grouping.group_id.cpu().numpy()
    order = np.argsort(gid, kind="stable")
    sorted_gid = gid[order]
    boundaries = np.searchsorted(sorted_gid,
                                 np.arange(grouping.num_groups + 1))
    members = {}
    for g in range(grouping.num_groups):
        mem = order[boundaries[g]: boundaries[g + 1]]
        members[g] = mem[:cap].tolist() if cap else mem.tolist()
    return [members[g] for g in gid]


def extract_attention(att_inter, city: Grouping, province: Grouping, *,
                      top_k: int = 1, member_cap: int = 100):
    """The ``Explainer.py:25-34`` artefacts from a recorded [N, M] inter
    attention and the groupings."""
    att = torch.as_tensor(att_inter)
    k = min(top_k, att.shape[1])
    src_idx, src_val = top_k_per_row(att, k)
    kk = min(max(top_k, 1), att.shape[0])
    rec_idx, rec_val = top_k_per_row(att.T, kk)
    return {
        "inter_src_top": src_idx,       # per source: top recipients
        "inter_src_val": src_val,
        "inter_rec_top": rec_idx,       # per recipient: top sources
        "inter_rec_val": rec_val,
        "city_members": clique_members(city, member_cap),
        "province_members": clique_members(province, member_cap),
    }


def save_attcoeff_npz(path: str, att_inter, city: Grouping,
                      province: Grouping, city_w=None, prov_w=None):
    """The reference-parity npz (``train.py:317-321`` writes
    ``{year}AttCoeff.npz`` with dense Coeff12 / Coeff3 / Coeff4).

    ``att_inter`` may be per head, ``[H, N, M]`` (``city_w`` / ``prov_w``
    then ``[H, N]``): every head is stored under the ``*_heads`` keys, and
    the single-head keys hold the *last* head, which the reference's
    sequential per-head writes leave in its buffers.  ``Coeff12`` is the
    dense [N, M]; the [N, N] clique coefficients are stored factored, a
    weight and a group id a node (:func:`reconstruct_intra_row` rebuilds
    any dense row)."""
    att_inter = np.asarray(att_inter)
    heads = att_inter[None] if att_inter.ndim == 2 else att_inter
    n = heads.shape[1]

    def per_head(w):
        if w is None:
            return np.ones((heads.shape[0], n), np.float32)
        w = np.asarray(w)
        return w[None] if w.ndim == 1 else w

    cw, pw = per_head(city_w), per_head(prov_w)
    np.savez(
        path,
        Coeff12=heads[-1],
        Coeff12_heads=heads,
        city_w=cw[-1],
        city_w_heads=cw,
        city_gid=city.group_id.cpu().numpy(),
        province_w=pw[-1],
        province_w_heads=pw,
        province_gid=province.group_id.cpu().numpy(),
    )
    return path


def reconstruct_intra_row(npz, channel: str, i: int, head: int = -1):
    """Dense row ``i`` of the [N, N] city / province coefficient buffer
    from the factored npz (the reference's ``Coeff3[i]`` / ``Coeff4[i]``,
    ``train.py:109-110``): the node's weight over the members of its
    clique, 0 elsewhere."""
    gid = npz[f"{channel}_gid"]
    w = npz[f"{channel}_w_heads"][head]
    row = np.zeros(gid.shape[0], np.float32)
    row[gid == gid[i]] = w[i]
    return row


def record_attention(model, fg):
    """One full-graph eval forward of an MSHA ``model`` (on its device) with
    ``record=True`` and ``batch = arange(N)`` (the factored intra weights
    then cover every node; the O(N) form of the reference's all-N Record()
    loop, ``train.py:284-291``).  Returns numpy ``(att_heads [H, N, M],
    city_w [H, N] or None, prov_w [H, N] or None)``."""
    from .training.tasks import flow_inputs

    dev = next(model.parameters()).device
    _, inter_mask = flow_inputs(fg, dev)
    with torch.inference_mode():
        _, auxes = model(inter_mask, fg.city.to(dev), fg.province.to(dev),
                         torch.arange(fg.n_src, device=dev), train=False,
                         record=True)
        att = torch.stack([a["att_inter"] for a in auxes]).cpu().numpy()
        cw = pw = None
        if "intra_city_weight" in auxes[0]:
            cw = torch.stack([a["intra_city_weight"]
                              for a in auxes]).cpu().numpy()
            pw = torch.stack([a["intra_province_weight"]
                              for a in auxes]).cpu().numpy()
    return att, cw, pw


def run_explain(year="2015", data_dir=DEFAULT_DATA_DIR, model="msha",
                epochs: int = 1, top_k: int = 1,
                output: str = "explain.json", batch_size: int = 1024,
                seed: int = 42, npz_path=None, device="cuda"):
    """Train MSHA (``in_features`` 32, ``out_features`` 16; ``ablation3``
    without the intra channels) for ``epochs`` epochs on ``device``,
    record its attention (:func:`record_attention`), optionally write the
    npz, map the indices to recipient names and write the JSON to
    ``output``; returns ``output``."""
    from .training import Trainer, TrainState, msha_task
    from .data import train_test_split_records

    fg = load_flow_graph(year, data_dir)
    flags = dict(use_intra=model != "ablation3", joint_softmax=True,
                 use_out_att=True)
    task, net = msha_task(fg, in_features=32, out_features=16, seed=seed,
                          device=device, **flags)
    state = TrainState.create(net, task.optimizer)
    trainer = Trainer(task=task, src=fg.edge_src.numpy(),
                      labels=fg.edge_dst.numpy(), batch_size=batch_size,
                      seed=seed)
    ids, _ = train_test_split_records(fg.num_records, 0.9, seed)
    generator = torch.Generator(device=state.device).manual_seed(seed)
    for ep in range(epochs):
        state, _ = trainer.train_epoch(state, ids, generator, ep)

    # every head is recorded ([H, N, M]); the reference's buffers keep the
    # last head's write, so the single-head artefacts use head -1 and the
    # npz keeps every head
    att_heads, cw, pw = record_attention(state.model, fg)
    att_inter = att_heads[-1]
    if npz_path:
        save_attcoeff_npz(npz_path, att_heads, fg.city, fg.province,
                          city_w=cw, prov_w=pw)
    art = extract_attention(att_inter, fg.city, fg.province, top_k=top_k)
    per_head_top = [top_k_per_row(att_heads[h],
                                  min(top_k, att_heads.shape[2]))[0]
                    for h in range(att_heads.shape[0])]

    _, _, recipient_index = load_index_match(
        os.path.join(data_dir, f"Adjacent{year}.json"))
    idx_to_name = {v: k for k, v in recipient_index.items()}
    data = {
        "InterAttS": {
            str(i): [idx_to_name[int(j)] for j in art["inter_src_top"][i]]
            for i in range(att_inter.shape[0])
        },
        "InterAttR": {
            idx_to_name[j]: [int(s) for s in art["inter_rec_top"][j]]
            for j in range(att_inter.shape[1])
        },
        "CityAtt": {str(i): m for i, m in enumerate(art["city_members"])},
        "ProvinceAtt": {str(i): m
                        for i, m in enumerate(art["province_members"])},
        # per-head top recipients (the reference exposes its last head
        # only)
        "InterAttS_heads": [
            {str(i): [idx_to_name[int(j)] for j in head_top[i]]
             for i in range(att_inter.shape[0])}
            for head_top in per_head_top
        ],
    }
    with open(output, "w") as f:
        json.dump(data, f)
    return output
