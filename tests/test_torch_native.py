"""The port's native CSV decoder (`spark_druid_olap_tpu_torch/native/`)
against the JAX package's, on the CPU.

The cases of the JAX package's `tests/test_native.py`, as parametrised
cases:

* decode: `read_csv` and `read_csv_encoded` of both packages over the same
  CSV files (seeded numpy columns of ints, floats and strings with empty
  fields, at a size the port builds on several threads, with columns whose
  type is decided late; quoted commas, escaped quotes, multi-line fields;
  CRLF; pandas' NA sentinels; ints with nulls; a header only): bit-equal
  columns, the same dtypes and dictionaries; `encode_strings` likewise;
* registration: `register_table` from a CSV path (dimensions and metrics
  named, inferred, a caller's dictionary, a string time column, a ragged
  file) answering as the reference's context does; a time column of words
  or with nulls raises in both;
* sharded CSVs: `build_datasource_from_csv` of both packages over the same
  SSB shards gives the same segments, and SSB q1.1, q2.1 and q4.1 answer
  alike (keys and counts exact, sums within rtol 1e-6);
* declines and failures: no `g++` on PATH, a ragged file and a path that is
  not a local file are recorded declines read by pandas; a missing handle,
  an I/O error, an unknown column type, a library of another ABI and a
  failed compile raise through every caller.
"""

import ctypes

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.catalog.segment import DimensionDict as JDict
from spark_druid_olap_tpu.ingest import shard as jshard
from spark_druid_olap_tpu.native import csv_decode as jcsv
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu_torch import native
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.catalog import ingest as tingest
from spark_druid_olap_tpu_torch.ingest import shard as tshard
from spark_druid_olap_tpu_torch.native import csv_decode as tcsv
from spark_druid_olap_tpu_torch.workloads import ssb as tssb

from test_torch_segment import assert_same_datasource
from test_torch_sql import assert_frames_match, port_config, reference_config

RTOL = 1e-6


def _seeded(rng, n=500):
    words = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zeta"], dtype=object)
    s = rng.choice(words, n)
    s[rng.random(n) < 0.1] = None
    return pd.DataFrame({
        "k": rng.integers(-1000, 1000, n),
        "x": rng.normal(0, 1e3, n),
        "s": s,
        "f": np.where(rng.random(n) < 0.2, np.nan, rng.integers(0, 9, n).astype(float)),
    })


def _large(rng, n=20000):
    """Enough rows for the multi-threaded column build, with columns whose
    type is decided late: integers then a double, numbers then a word,
    integers with gaps."""
    late_double = rng.integers(0, 100, n).astype(str).astype(object)
    late_double[n // 2] = "2.5"
    late_string = rng.normal(size=n).astype(str).astype(object)
    late_string[-1] = "word"
    gaps = rng.integers(0, 9, n).astype(str).astype(object)
    gaps[rng.random(n) < 0.05] = ""
    return pd.concat([_seeded(rng, n), pd.DataFrame({
        "late_double": late_double, "late_string": late_string, "gaps": gaps})], axis=1)


def _frame(rows):
    return lambda rng: rows


CSV_CASES = {
    # the JAX package's fixture: quoted commas and quotes, empty strings,
    # integers stored as strings with gaps
    "mixed": lambda rng: pd.DataFrame({
        "region": ["EU", "US", "ASIA", "EU", "US", "EU"],
        "city": ['a "quoted" one', "b,with,commas", "", "plain", "", "z"],
        "qty": [1, 2, 3, 4, 5, 6],
        "price": [1.5, 2.25, 0.0, -3.5, 1e6, 0.125],
        "maybe_int": ["1", "", "3", "4", "", "6"],
    }),
    "seeded": _seeded,
    "large": _large,
    "crlf": lambda rng: _seeded(rng, 64).to_csv(index=False, lineterminator="\r\n"),
    "header_only": _frame("a,b,c\n"),
    "multiline_quoted": _frame('a,b\n"line1\nline2",3\nplain,4\n'),
    "escaped_quotes": _frame("a\n" + "\n".join(f'"v""{i:02d}"' for i in range(64)) + "\n"),
    "na_sentinels": _frame("x,v,s\na,1.5,foo\nb,NA,NaN\nc,3.0,null\nd,N/A,#N/A\n"),
    "no_final_newline": _frame("a,b\nx,1\ny,2"),
    "trailing_blank_line": _frame("a,b\nx,1\ny,2\n\n"),
    "trailing_comma": _frame("a,b\nx,1\ny,"),
}


def _write(tmp_path, case):
    body = CSV_CASES[case](np.random.default_rng(sorted(CSV_CASES).index(case)))
    p = tmp_path / f"{case}.csv"
    if isinstance(body, pd.DataFrame):
        body.to_csv(p, index=False)
    else:
        p.write_bytes(body.encode())
    return str(p)


def _assert_columns_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype, k
        if w.dtype == object:
            assert list(g) == list(w), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", sorted(CSV_CASES))
@pytest.mark.parametrize("fn", ["read_csv", "read_csv_encoded"])
def test_decode_matches_reference(tmp_path, case, fn):
    path = _write(tmp_path, case)
    got, want = getattr(tcsv, fn)(path), getattr(jcsv, fn)(path)
    if fn == "read_csv":
        _assert_columns_equal(got, want)
        frame = pd.read_csv(path)
        assert list(got) == list(frame.columns)
        for k in frame.columns:  # the pandas fallback's nulls and dtypes
            if frame[k].dtype.kind in "iuf":
                assert got[k].dtype == frame[k].dtype, k
            else:
                assert got[k].dtype == object, k
            np.testing.assert_array_equal(pd.isna(got[k]), frame[k].isna().values, err_msg=k)
        return
    _assert_columns_equal(got[0], want[0])
    assert list(got[1]) == list(want[1])
    for k, d in want[1].items():
        assert got[1][k].values == d.values, k
        # the dictionary contract of `DimensionDict.build` over the decoded values
        raw = tcsv.read_csv(path)[k]
        assert d.values == JDict.build(list(raw)).values
        np.testing.assert_array_equal(got[0][k], JDict.build(list(raw)).encode(list(raw)))


ENCODE_CASES = {
    "strings_and_nulls": ["pear", "apple", None, "apple", "banana", None, "pear"],
    "nan_is_null": ["b", float("nan"), "a", "b"],
    "non_strings": [3, 1, "x", 3, 2.5],
    "unicode": ["é", "e", "ë", "ü", "e"],
    "empty": [],
    "all_null": [None, None],
    "seeded": list(np.random.default_rng(3).choice(["x", "yy", "zzz", "", "w"], 1000)),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_strings_matches_reference(case):
    vals = ENCODE_CASES[case]
    codes, uniq = tcsv.encode_strings(vals)
    want_codes, want_uniq = jcsv.encode_strings(vals)
    assert codes.dtype == want_codes.dtype == np.int32
    np.testing.assert_array_equal(codes, want_codes)
    assert uniq == want_uniq


def _reg_csv(tmp_path, name, frame):
    p = tmp_path / f"{name}.csv"
    if isinstance(frame, str):
        p.write_text(frame)
    else:
        frame.to_csv(p, index=False)
    return str(p)


# name -> (csv body, register_table kwargs, SQL); the JAX package's
# registration cases
REGISTER_CASES = {
    "named_schema": (
        pd.DataFrame({"flag": ["A", "B", "A", "C", "B", "A"], "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]}),
        {"dimensions": ["flag"], "metrics": ["v"]},
        "SELECT flag, sum(v) AS s, count(*) AS n FROM t GROUP BY flag ORDER BY flag"),
    "inferred_schema": (
        pd.DataFrame({"d": ["x", "y", "x"], "m": [1.5, 2.5, 3.5]}), {},
        "SELECT d, sum(m) AS s FROM t GROUP BY d ORDER BY d"),
    "caller_dict_wins": (
        pd.DataFrame({"region": ["EU", "US", "EU"], "v": [1.0, 2.0, 4.0]}),
        {"dimensions": ["region"], "metrics": ["v"], "dicts": "shared"},
        "SELECT region, sum(v) AS s FROM t GROUP BY region ORDER BY region"),
    "string_time_column": (
        pd.DataFrame({"d": ["1992-01-01", "1992-01-02", "1992-01-01", "1992-01-03"],
                      "v": [1.0, 2.0, 4.0, 8.0]}),
        {"metrics": ["v"], "time_column": "d"},
        "SELECT sum(v) AS s FROM t WHERE d >= '1992-01-02'"),
    "ragged_declines": (
        "a,b\nx,1\ny\nx,3\n", {"dimensions": ["a"], "metrics": ["b"]},
        "SELECT a, sum(b) AS s, count(*) AS n FROM t GROUP BY a ORDER BY a"),
}


@pytest.mark.parametrize("case", sorted(REGISTER_CASES))
def test_register_table_from_csv_matches_reference(tmp_path, case):
    body, kw, sql = REGISTER_CASES[case]
    path = _reg_csv(tmp_path, case, body)
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("dicts") == "shared":  # a wider domain than the file's
        from spark_druid_olap_tpu_torch.catalog.segment import DimensionDict as TDict

        tkw["dicts"] = {"region": TDict(values=("ASIA", "EU", "US"))}
        jkw["dicts"] = {"region": JDict(values=("ASIA", "EU", "US"))}
    ref = sd.TPUOlapContext(reference_config())
    port = TPUOlapContext(port_config(), device="cpu")
    jds = ref.register_table("t", path, **jkw)
    tds = port.register_table("t", path, **tkw)
    assert [(c.name, c.kind) for c in tds.columns] == [(c.name, c.kind) for c in jds.columns]
    assert {k: d.values for k, d in tds.dicts.items()} == {k: d.values for k, d in jds.dicts.items()}
    assert tds.num_rows == jds.num_rows and tds.interval() == jds.interval()
    assert_frames_match(port.sql(sql), ref.sql(sql), RTOL)
    if case == "ragged_declines":
        assert port.last_ingest.decoders == ["pandas"]
        assert port.last_ingest.declines[0].startswith("native csv: shape: ")
    else:
        assert port.last_ingest == tingest.IngestReport(decoders=["native"])


@pytest.mark.parametrize("values", [["x", "y", "x"], ["1992-01-01", "", "1992-01-02"]],
                         ids=["words", "nulls"])
def test_time_column_of_no_times_raises_in_both(tmp_path, values):
    path = _reg_csv(tmp_path, "t", pd.DataFrame({"d": values, "v": [1.0, 2.0, 3.0]}))
    for ctx in (sd.TPUOlapContext(reference_config()), TPUOlapContext(device="cpu")):
        with pytest.raises(ValueError):
            ctx.register_table("t", path, metrics=["v"], time_column="d")


@pytest.fixture(scope="module")
def ssb_csv(tmp_path_factory):
    """SSB at SF 0.01 as three flat lineorder shards, its dimension tables."""
    tables = jssb.gen_tables(scale=0.01, seed=11)
    flat = tssb.flat_frame(tables)
    d = tmp_path_factory.mktemp("ssb_csv")
    paths = []
    for i, part in enumerate(np.array_split(np.arange(len(flat)), 3)):
        p = d / f"lineorder_{i}.csv"
        flat.iloc[part].to_csv(p, index=False)
        paths.append(str(p))
    return tables, paths


def _csv_contexts(tables, paths):
    args = ("lineorder", paths, tssb.FLAT_DIMS, tssb.FLAT_METRICS, "lo_orderdate", 16384)
    ref = sd.TPUOlapContext(reference_config())
    ref.register_datasource(jshard.build_datasource_from_csv(*args, workers=2),
                            star_schema=jssb.STAR_SCHEMA)
    port = TPUOlapContext(port_config(), device="cpu")
    report = tingest.IngestReport()
    port.register_datasource(tshard.build_datasource_from_csv(*args, workers=2, report=report),
                             star_schema=tssb.STAR_SCHEMA)
    for c in (ref, port):
        c.register_table("dwdate", tables["dwdate"], time_column="d_datekey")
        for t in ("customer", "supplier", "part"):
            c.register_table(t, tables[t])
    return ref, port, report


@pytest.mark.parametrize("name", ["q1_1", "q2_1", "q4_1"])
def test_sharded_csv_ssb_matches_reference(ssb_csv, name):
    tables, paths = ssb_csv
    ref, port, report = _csv_contexts(tables, paths)
    assert report == tingest.IngestReport(decoders=["native"] * 3)
    assert_same_datasource(ref.catalog.get("lineorder"), port.catalog.get("lineorder"))
    assert_frames_match(port.sql(tssb.QUERIES[name]), ref.sql(jssb.QUERIES[name]), RTOL)


def _no_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "native_build")
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))


@pytest.mark.parametrize("route", ["register_table", "sharded", "read_csv_columns"])
def test_missing_compiler_is_a_recorded_decline(monkeypatch, tmp_path, ssb_csv, route):
    tables, paths = ssb_csv
    if route == "sharded":
        _, want, _ = _csv_contexts(tables, paths)
    _no_compiler(monkeypatch, tmp_path)
    assert not native.available()
    if route == "register_table":
        path = _reg_csv(tmp_path, "t", REGISTER_CASES["named_schema"][0])
        port = TPUOlapContext(port_config(), device="cpu")
        ds = port.register_table("t", path, dimensions=["flag"], metrics=["v"])
        assert ds.num_rows == 6
        report = port.last_ingest
        want_declines = 1
    elif route == "sharded":
        report = tingest.IngestReport()
        got = tshard.build_datasource_from_csv(
            "lineorder", paths, tssb.FLAT_DIMS, tssb.FLAT_METRICS, "lo_orderdate", 16384,
            workers=2, report=report)
        # the pandas shards build the same segments as the native ones
        assert_same_datasource(want.catalog.get("lineorder"), got)
        want_declines = 3
    else:
        report = tingest.IngestReport()
        cols = tingest.read_csv_columns(paths[0], report)
        assert len(cols["lo_orderdate"]) > 0
        want_declines = 1
    assert report.decoders == ["pandas"] * want_declines
    assert all(d.startswith("native csv: no_compiler: no g++") for d in report.declines)
    assert len(report.declines) == want_declines


def test_not_a_file_is_a_recorded_decline(tmp_path):
    report = tingest.IngestReport()
    with pytest.raises(FileNotFoundError):  # pandas then reads it, and fails alike
        tingest.to_columns_encoded(str(tmp_path / "missing.csv"), report)
    assert report.decoders == ["pandas"]
    assert report.declines == [f"native csv: not_a_file: {str(tmp_path / 'missing.csv')!r} "
                               "is not a local file"]


class _FakeLib:
    """A library whose handle, error kind or column type is wrong."""

    def __init__(self, handle=1, error=None, kind=0, col_type=0, abi=native.ABI_VERSION):
        self.handle, self.error, self.kind, self.col_type, self.abi = (
            handle, error, kind, col_type, abi)

    def olap_abi_version(self):
        return self.abi

    def olap_csv_read(self, path):
        return self.handle

    def olap_csv_error(self, h):
        return self.error

    def olap_csv_error_kind(self, h):
        return self.kind

    def olap_csv_num_rows(self, h):
        return 2

    def olap_csv_num_cols(self, h):
        return 1

    def olap_csv_col_name(self, h, c):
        return b"a"

    def olap_csv_col_type(self, h, c):
        return self.col_type

    def olap_csv_col_int64(self, h, c, out):
        ctypes.memmove(out, np.array([1, 2], dtype=np.int64).ctypes.data, 16)

    def olap_csv_free(self, h):
        pass


FAILURES = {
    "no_handle": {"handle": 0},
    "io_error": {"error": b"short read", "kind": 2},
    "unknown_column_type": {"col_type": 7},
    "other_abi": {"abi": 1},
}


@pytest.mark.parametrize("route", ["register_table", "sharded", "read_csv_columns"])
@pytest.mark.parametrize("failure", sorted(FAILURES))
def test_native_failure_raises(monkeypatch, tmp_path, failure, route):
    path = _reg_csv(tmp_path, "t", "a\n1\n2\n")
    fake = _FakeLib(**FAILURES[failure])
    if failure == "other_abi":  # the check `load` makes on a fresh library
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native.ctypes, "CDLL", lambda p: fake)
        monkeypatch.setattr(native, "_declare", lambda lib: None)
    else:
        monkeypatch.setattr(tcsv, "load", lambda: fake)
    report = tingest.IngestReport()
    with pytest.raises(native.NativeError):
        if route == "register_table":
            TPUOlapContext(port_config(), device="cpu").register_table("t", path)
        elif route == "sharded":
            tshard.build_datasource_from_csv("t", [path], [], ["a"], workers=1, report=report)
        else:
            tingest.read_csv_columns(path, report)
    assert report == tingest.IngestReport()  # no decline, no pandas read


def test_failed_compile_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "native_build")
    with pytest.raises(native.NativeError, match="g\\+\\+ failed"):
        tingest.to_columns_encoded(_reg_csv(tmp_path, "t", "a\n1\n"))
    assert not list((tmp_path / "native_build").glob("*"))


def test_builds_its_own_copy_into_an_ignored_directory():
    path = native.build()
    root = native._BUILD_DIR.parents[1]
    assert path.parent == root / "build" / "native"
    assert native._SRC.parent == root / "spark_druid_olap_tpu_torch" / "native"
    assert "spark_druid_olap_tpu/" not in str(native.load()._name)
    assert "build/" in (root / ".gitignore").read_text().split()
