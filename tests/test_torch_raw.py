"""The port's raw-data pipeline (``data/raw.py``) against the JAX
package's, on the CPU: the same raw records go through both, and the
outputs, the written files and the loaded graphs must be equal (no
tolerance: the pipeline is integer bookkeeping and one min-max scaling in
the same float64 order).  As ``tests/test_raw_pipeline.py``, on
synthetic records.
"""

import pathlib

import numpy as np
import pytest

import msha_gnn_tpu.data as jax_data
import msha_gnn_tpu.data.raw as jax_raw
import msha_gnn_torch.data as port_data
from msha_gnn_torch.data.raw import (RawRecord, anonymize, classify_major,
                                     derive_prefix_table, load_major_table,
                                     write_anonymous_dataset)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAJOR_TABLE = {"ma": "science", "bi": "science", "hi": "humanities"}


def rows(seed, n, majors):
    """``n`` raw rows (province, city, county, gender, major, family,
    school province), a few unclassifiable."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = int(rng.integers(3))
        c = int(rng.integers(2))
        out.append((f"P{p}", f"C{p}{c}", f"K{p}{c}{rng.integers(2)}",
                    "FM"[rng.integers(2)], majors[rng.integers(len(majors))],
                    "xyz"[rng.integers(3)], f"S{rng.integers(4)}"))
    return out


def both(rows_):
    return ([RawRecord(*r) for r in rows_],
            [jax_raw.RawRecord(*r) for r in rows_])


def assert_same(got, want):
    assert list(got) == list(want)
    for key in ("source_index", "recipient_index", "gdp_embedding"):
        assert got[key] == want[key], key
        assert list(got[key]) == list(want[key]), key   # and their order
    np.testing.assert_array_equal(got["flows"], want["flows"])
    assert got["flows"].dtype == want["flows"].dtype


def test_the_asset_is_the_jax_packages_byte_for_byte():
    port = ROOT / "msha_gnn_torch/data/assets/more_major.json"
    jax = ROOT / "msha_gnn_tpu/data/assets/more_major.json"
    assert port.read_bytes() == jax.read_bytes()
    assert load_major_table() == jax_raw.load_major_table()
    assert len(load_major_table()) == 721
    assert derive_prefix_table() == jax_raw.derive_prefix_table()


def test_package_exports_the_jax_names():
    for name in ("classify_major", "derive_prefix_table",
                 "load_major_table"):
        assert name in port_data.__all__
        assert getattr(port_data, name) is globals()[name]
    assert set(jax_data.__all__) - set(port_data.__all__) == set()


def test_classify_major_matches_jax():
    overrides = load_major_table()
    table = derive_prefix_table(overrides)
    amb = [n for n in overrides if n[:2] not in table]
    cases = ["math(applied)", "history", "??x", "zz", "", "★" + amb[0],
             amb[0] + "(test)", *list(overrides)[:50], *amb[:20]]
    for m in cases:
        for t, o in ((MAJOR_TABLE, None), (MAJOR_TABLE, {"zz": "arts"}),
                     (table, overrides)):
            assert classify_major(m, t, o) == \
                jax_raw.classify_major(m, t, o), m


@pytest.mark.parametrize("table", ["toy", "asset", "none"])
def test_anonymize_matches_jax(table):
    overrides = load_major_table()
    majors = ["math(applied)", "biology", "weird??", "history", "zz",
              *list(overrides)[:6]]
    port, jax = both(rows(0, 400, majors))
    gdp = {"K000": 10.0, "K011": 30.0, "K101": 7.5, "K210": 99.0}
    kw = {"toy": dict(major_table=MAJOR_TABLE),
          "asset": dict(major_table=derive_prefix_table(overrides),
                        major_overrides=overrides),
          "none": {}}[table]
    got, want = anonymize(port, gdp, **kw), jax_raw.anonymize(jax, gdp, **kw)
    assert_same(got, want)
    if table == "toy":
        assert got["flows"].shape[0] < 400    # the unclassifiable dropped
    vals = list(got["gdp_embedding"].values())
    assert min(vals) == 0.0 and max(vals) == 1.0


def test_written_files_and_loaded_graphs_match_jax(tmp_path):
    """The three files byte for byte, and both packages' ``load_flow_graph``
    of the port's files give the same arrays."""
    port, jax = both(rows(1, 300, ["math", "bio", "hist"]))
    gdp = {"K000": 1.0, "K111": 2.0}
    got = write_anonymous_dataset(str(tmp_path / "port"), "2099",
                                  anonymize(port, gdp))
    want = jax_raw.write_anonymous_dataset(str(tmp_path / "jax"), "2099",
                                           jax_raw.anonymize(jax, gdp))
    for name in ("Adjacent2099.json", "GDP2099.json", "Flow2099.csv"):
        assert (pathlib.Path(got) / name).read_bytes() == \
            (pathlib.Path(want) / name).read_bytes(), name
    fg = port_data.load_flow_graph("2099", got, pad_to_multiple=8)
    fg_j = jax_data.load_flow_graph("2099", got, pad_to_multiple=8)
    assert (fg.n_src, fg.n_dst, fg.num_records) == \
        (fg_j.n_src, fg_j.n_dst, fg_j.num_records)
    for key in ("edge_src", "edge_dst", "gdp"):
        np.testing.assert_array_equal(getattr(fg, key).numpy(),
                                      np.asarray(getattr(fg_j, key)), key)
    for key in ("city", "province"):
        np.testing.assert_array_equal(
            getattr(fg, key).group_id.numpy(),
            np.asarray(getattr(fg_j, key).group_id), key)
    np.testing.assert_array_equal(fg.inter.to_dense().numpy(),
                                  np.asarray(fg_j.inter.to_dense()))


def test_the_shipped_table_resolves_as_the_reference():
    """As ``tests/test_raw_pipeline.py::test_shipped_major_table``."""
    overrides = load_major_table()
    table = derive_prefix_table(overrides)
    assert len(set(overrides.values())) == 12
    amb = [n for n in overrides if n[:2] not in table]
    assert amb
    assert classify_major(amb[0], table, overrides) == overrides[amb[0]]
    assert classify_major("★" + amb[0] + "(test)", table, overrides) == \
        overrides[amb[0]]
    assert classify_major("??unknown", table, overrides) is None
