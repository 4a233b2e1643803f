"""The raw-data anonymisation pipeline (``msha_gnn_tpu/data/raw.py``,
the reference's ``HigherDataset_temp``, ``dataset.py:28-205``), a copy:
the JAX module is numpy and the standard library only, and the port keeps
its own copy of what it needs from there.

Raw student records are classified by major into first-level disciplines
(a 2-character prefix table, then the reference's override dict, shipped
as ``assets/more_major.json``), given string node identities, their
county GDP min-max normalised, and written as the ``Adjacent{year}.json``
(gbk) / ``GDP{year}.json`` (gbk) / ``Flow{year}.csv`` files that
:func:`~msha_gnn_torch.data.flow.load_flow_graph` reads.

Raw record schema (one row per student flow record):
``province, city, county, gender, major, family_status, school_province``
plus a county->GDP table ``{county: gdp}`` and an optional major->discipline
table ``{major_prefix: discipline}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class RawRecord:
    province: str
    city: str
    county: str
    gender: str
    major: str
    family_status: str
    school_province: str


def load_major_table() -> Dict[str, str]:
    """The reference's hard-coded 721-entry major -> first-level-discipline
    overrides dict (``more_major``, ``dataset.py:365-378``; the reference
    file is GBK-encoded — this is its decoded content, shipped as a package
    asset).  The reference's *primary* table is loaded from a ``major.csv``
    at a private absolute path (``dataset.py:360-364``) that is not shipped;
    :func:`derive_prefix_table` recovers the unambiguous part of it."""
    path = os.path.join(os.path.dirname(__file__), "assets",
                        "more_major.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def derive_prefix_table(
    overrides: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """Best-effort reconstruction of the reference's 2-char-prefix table
    (``major`` from the unshipped ``major.csv``, ``dataset.py:359-364``):
    every prefix whose override entries agree on a single discipline."""
    overrides = load_major_table() if overrides is None else overrides
    by_prefix: Dict[str, set] = {}
    for name, disc in overrides.items():
        by_prefix.setdefault(name[:2], set()).add(disc)
    return {p: next(iter(d)) for p, d in by_prefix.items() if len(d) == 1}


def classify_major(major: str, table: Dict[str, str],
                   overrides: Optional[Dict[str, str]] = None):
    """Reference ``majorClassify`` (``dataset.py:380-390``): strip a
    parenthesised suffix and '★' markers, look up by 2-char prefix in the
    table, fall back to the overrides dict; None for unclassifiable
    entries."""
    m = major.split("(")[0].strip().strip("★")
    if not m or m.startswith("??"):
        return None
    prefix = m[:2]
    if prefix in table:
        return table[prefix]
    if overrides and m in overrides:
        return overrides[m]
    return None


def anonymize(
    records: Sequence[RawRecord],
    county_gdp: Dict[str, float],
    major_table: Optional[Dict[str, str]] = None,
    major_overrides: Optional[Dict[str, str]] = None,
    *,
    default_gdp: float = 1_000_000.0,
):
    """Build the anonymised dataset from raw records.

    Returns a dict with ``source_index`` (node id -> [city_id,
    province_id]), ``recipient_index`` (school province -> id),
    ``gdp_embedding`` (node id -> min-max-normalised GDP), and ``flows``
    ([num_records, 4] source, recipient, city, province int array).

    Node identity follows the reference: the concatenation
    province+city+county+gender+major+family_status (``dataset.py:75-78``);
    GDP is looked up by county with a constant fallback
    (``dataset.py:81-84``) then min-max normalised (``dataset.py:188-205``).
    """
    kept: List[RawRecord] = []
    majors: List[str] = []
    for r in records:
        if major_table is not None:
            m = classify_major(r.major, major_table, major_overrides)
            if m is None:
                continue
        else:
            m = r.major
        kept.append(r)
        majors.append(m)

    def index_of(values):
        mapping = {}
        for v in values:
            if v not in mapping:
                mapping[v] = len(mapping)
        return mapping

    node_names = [
        r.province + r.city + r.county + r.gender + m + r.family_status
        for r, m in zip(kept, majors)
    ]
    node_index = index_of(node_names)
    city_index = index_of([r.city for r in kept])
    province_index = index_of([r.province for r in kept])
    recipient_index = index_of([r.school_province for r in kept])

    gdp_raw = {}
    for r, name in zip(kept, node_names):
        gdp_raw[node_index[name]] = float(
            county_gdp.get(r.county, default_gdp)
        )
    lo, hi = min(gdp_raw.values()), max(gdp_raw.values())
    span = (hi - lo) or 1.0
    gdp_embedding = {k: (v - lo) / span for k, v in sorted(gdp_raw.items())}

    source_index = {}
    for r, name in zip(kept, node_names):
        source_index[node_index[name]] = [
            city_index[r.city], province_index[r.province]
        ]

    flows = np.asarray(
        [
            [
                node_index[name],
                recipient_index[r.school_province],
                city_index[r.city],
                province_index[r.province],
            ]
            for r, name in zip(kept, node_names)
        ],
        np.int64,
    )
    return {
        "source_index": dict(sorted(source_index.items())),
        "recipient_index": recipient_index,
        "gdp_embedding": gdp_embedding,
        "flows": flows,
    }


def write_anonymous_dataset(out_dir: str, year: str, anonymized: Dict):
    """Emit ``Adjacent{year}.json`` / ``GDP{year}.json`` / ``Flow{year}.csv``
    in exactly the shipped schema so
    :func:`~msha_gnn_torch.data.flow.load_flow_graph` consumes the output
    directly."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"Adjacent{year}.json"), "w",
              encoding="gbk") as f:
        json.dump(
            {
                "source_index": {
                    str(k): v for k, v in anonymized["source_index"].items()
                },
                "recipient_index": anonymized["recipient_index"],
            },
            f, ensure_ascii=True,
        )
    with open(os.path.join(out_dir, f"GDP{year}.json"), "w",
              encoding="gbk") as f:
        json.dump(
            {"GDP_embedding": {
                str(k): v for k, v in anonymized["gdp_embedding"].items()
            }},
            f,
        )
    with open(os.path.join(out_dir, f"Flow{year}.csv"), "w") as f:
        f.write("source,recipient\n")
        for row in anonymized["flows"]:
            f.write(",".join(str(int(v)) for v in row) + "\n")
    return out_dir
