"""Port parity: native/ (the C++ host sort and CSV loader), utils/io.py,
strings.encode / unify over the native loader, and Table.from_csv.

The host sort is held to numpy's stable sort and to the JAX package's
``host_sort`` across the type matrix; the CSV loader to the JAX package's
``parse_csv`` on the same files (arrays, vocabularies, masks) and
``Table.from_csv(..., device="cpu")`` to the JAX ``Table.from_csv`` by
``to_numpy()``. Raw dataset files cross between the two packages. The
build-at-first-use loader is checked for concurrent loads, stale
libraries, libraries of another CPU and a missing compiler.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import radix_sort_tpu_torch as rst  # noqa: E402
from radix_sort_tpu.native import csvio as jcsv  # noqa: E402
from radix_sort_tpu.native import host as jhost  # noqa: E402
from radix_sort_tpu.table import Table as JTable  # noqa: E402
from radix_sort_tpu.utils import io as jio  # noqa: E402
from radix_sort_tpu_torch import strings as TS  # noqa: E402
from radix_sort_tpu_torch.native import _gxx, csvio, host  # noqa: E402
from radix_sort_tpu_torch.native import host_sort, host_sort_pairs, native_available  # noqa: E402
from radix_sort_tpu_torch.table import Table as TTable  # noqa: E402
from radix_sort_tpu_torch.utils import io as tio  # noqa: E402
from test_torch_table import jitted, same  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_compiles():
    assert native_available() and csvio.csv_native_available()
    assert host.num_threads() >= 1


# ---------------------------------------------------------------- host sort

INTS = [np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.int16, np.int32, np.int64]


@pytest.mark.parametrize("dtype", INTS)
def test_int_type_matrix(rng, dtype):
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, 50_000, dtype=dtype, endpoint=True)
    got = host_sort(x)
    np.testing.assert_array_equal(got, np.sort(x, kind="stable"))
    np.testing.assert_array_equal(got, jhost.host_sort(x))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_total_order(rng, dtype):
    x = rng.standard_normal(50_000).astype(dtype)
    specials = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf], dtype=dtype)
    x[rng.integers(0, len(x), len(specials))] = specials
    got = host_sort(x)
    # total_cmp oracle: the order-preserving transform, compared UNSIGNED
    isz = np.dtype(dtype).itemsize
    b = x.view(np.dtype(f"i{isz}"))
    mask = (b >> (isz * 8 - 1)) | np.iinfo(b.dtype).min
    ref = x[np.argsort((b ^ mask).view(f"u{isz}"), kind="stable")]
    np.testing.assert_array_equal(got.view(b.dtype), ref.view(b.dtype))
    np.testing.assert_array_equal(got.view(b.dtype), jhost.host_sort(x).view(b.dtype))


def test_pairs_stability(rng):
    keys = rng.integers(0, 100, 50_000).astype(np.uint32)
    vals = np.arange(50_000, dtype=np.uint32)
    sk, sv = host_sort_pairs(keys, vals)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sk, keys[perm])
    np.testing.assert_array_equal(sv, vals[perm])


@pytest.mark.parametrize("kdt,vdt", [(np.uint64, np.uint64), (np.int64, np.float64),
                                     (np.float32, np.int32), (np.int16, np.uint32),
                                     (np.uint32, np.uint64)])
def test_pairs_match_the_reference(rng, kdt, vdt):
    n = 30_000
    keys = rng.integers(0, 2**16, n).astype(kdt) if kdt != np.float32 else \
        rng.standard_normal(n).astype(kdt)
    vals = rng.integers(0, 2**31, n).astype(vdt)
    sk, sv = host_sort_pairs(keys, vals)
    jk, jv = jhost.host_sort_pairs(keys, vals)
    perm = np.argsort(keys, kind="stable")
    for got, want in ((sk, keys[perm]), (sv, vals[perm]), (sk, jk), (sv, jv)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_pairs_u64(rng):
    keys = rng.integers(0, 2**64, 30_000, dtype=np.uint64)
    vals = rng.integers(0, 2**64, 30_000, dtype=np.uint64)
    sk, sv = host_sort_pairs(keys, vals, threads=3)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sk, keys[perm])
    np.testing.assert_array_equal(sv, vals[perm])


def test_duplicate_heavy(rng):
    x = rng.integers(0, 4, 200_000).astype(np.uint64)
    np.testing.assert_array_equal(host_sort(x), np.sort(x, kind="stable"))


def test_pairs_length_mismatch_raises():
    with pytest.raises(ValueError, match="same length"):
        host_sort_pairs(np.zeros(3, np.uint32), np.zeros(4, np.uint32))


# ---------------------------------------------------------------- raw files

class TestIO:
    def test_roundtrip(self, rng, tmp_path):
        arr = rng.integers(0, 2**64, 10_000, dtype=np.uint64)
        p = str(tmp_path / "data.bin")
        tio.write_raw(p, arr)
        got = tio.read_raw(p)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_files_cross_between_the_packages(self, rng, tmp_path, writer):
        arr = rng.integers(0, 2**32, (64, 5), dtype=np.uint64).astype(np.uint32)
        p = str(tmp_path / "x.raw")
        (jio if writer == "jax" else tio).write_raw(p, arr)
        reader = tio if writer == "jax" else jio
        got = reader.read_raw(p)
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(reader.read_raw(p, dtype=np.int32), arr.view(np.int32))

    @pytest.mark.parametrize("dist,kw", [("uniform", {}), ("zipf", {"s": 1.1}),
                                         ("geometric", {}), ("step_uniform", {"num_steps": 9})])
    @pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
    def test_gen_data_deterministic(self, tmp_path, dist, kw, dtype):
        p1, p2 = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
        a = tio.gen_data(p1, 4096, dtype, dist, seed=7, device="cpu", **kw)
        b = tio.gen_data(p2, 4096, dtype, dist, seed=7, device="cpu", **kw)
        assert a.dtype == dtype and a.shape == (4096,)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jio.read_raw(p1), a)
        if dist == "step_uniform":
            want = np.unique(np.asarray(jio.gen_data(str(tmp_path / "j.bin"), 4096, dtype, dist,
                                                     seed=7, **kw)))
            np.testing.assert_array_equal(np.unique(a), want)

    def test_bad_dist_raises(self, tmp_path):
        with pytest.raises(ValueError, match="dist must be one of"):
            tio.gen_data(str(tmp_path / "x.bin"), 16, dist="normal", device="cpu")

    def test_bad_header_and_no_header(self, tmp_path):
        p = str(tmp_path / "x.bin")
        np.arange(4, dtype=np.uint32).tofile(p)
        with pytest.raises(ValueError, match="pass dtype"):
            tio.read_raw(p)
        np.testing.assert_array_equal(tio.read_raw(p, dtype=np.uint32), np.arange(4))
        with open(p + ".json", "w") as f:
            f.write('{"magic": "other"}')
        with pytest.raises(ValueError, match="is not a"):
            tio.read_raw(p)


# ---------------------------------------------------------------- CSV

def _write(tmp_path, text, name="t.csv"):
    p = os.path.join(tmp_path, name)
    with open(p, "w") as f:
        f.write(text)
    return p


def _same_parse(p, delimiter=","):
    """The port's parse_csv against the JAX package's on one file."""
    got, want = csvio.parse_csv(p, delimiter), jcsv.parse_csv(p, delimiter)
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    return got


def _same_table(p, **kw):
    """Table.from_csv in both packages by to_numpy()."""
    t = TTable.from_csv(p, device="cpu", **kw)
    same(JTable.from_csv(p, **kw), t)
    return t


MIXED = ('city,v,w,note\n'
         'osaka,3,1.5,"hi, there"\n'
         'lima,,2.5,"say ""ok"""\n'
         'osaka,9,.5e1,\n'
         ' lima ,1,-2,plain\n')


def test_types_quoting_nulls(tmp_path):
    p = _write(tmp_path, MIXED)
    cols, dicts, masks = _same_parse(p)
    assert cols["v"].dtype == np.int64
    assert masks["v"].tolist() == [False, True, False, False]
    assert cols["w"].dtype == np.float64 and cols["w"].tolist() == [1.5, 2.5, 5.0, -2.0]
    # sorted order-preserving vocabulary, "" at index 0
    assert dicts["city"].tolist() == ["", "lima", "osaka"]
    assert cols["city"].tolist() == [2, 1, 2, 1]  # autostripped
    assert dicts["note"][cols["note"][0]] == "hi, there"
    assert dicts["note"][cols["note"][1]] == 'say "ok"'
    assert masks["note"].tolist() == [False, False, True, False]
    t = _same_table(p)
    assert t["v"].device.type == "cpu"


def test_other_delimiter_crlf_and_embedded_newline(tmp_path):
    p = _write(tmp_path, 'a|b|c\r\n1|"x|y"|2024-01-02\r\n2|"two\nlines"|\r\n')
    cols, dicts, masks = _same_parse(p, "|")
    assert dicts["b"][cols["b"]].tolist() == ["x|y", "two\nlines"]
    assert masks["c"].tolist() == [False, True]
    t = TTable.from_csv(p, delimiter="|", device="cpu")
    same(JTable.from_csv(p, delimiter="|"), t)


DATES = ("d,ts,promo,bad_day,mixed,quoted\n"
         "2024-01-05,2024-01-05 10:30:00,2024-01-01,2023-02-29,"
         "2024-01-01,\"2024-01-01\"\n"
         "2023-12-31,2023-12-31T23:59:59.123456,"
         "2024-06-01T01:02:03,2024-13-01,7,\"2024-01-02\"\n"
         ",2024-02-29 00:00:00.1234567,2020-02-29,2024-01-32,x,"
         "\"2024-01-03\"\n")


def test_date_timestamp_inference(tmp_path):
    p = _write(tmp_path, DATES)
    cols, dicts, masks = _same_parse(p)
    assert cols["d"].dtype == np.dtype("datetime64[D]")
    assert cols["d"][0] == np.datetime64("2024-01-05")
    assert masks["d"].tolist() == [False, False, True]
    assert cols["ts"].dtype == np.dtype("datetime64[us]")
    assert cols["ts"][1] == np.datetime64("2023-12-31T23:59:59.123456")
    assert cols["ts"][2] == np.datetime64("2024-02-29T00:00:00.123456")
    assert cols["promo"].dtype == np.dtype("datetime64[us]")
    assert cols["promo"][0] == np.datetime64("2024-01-01T00:00:00")
    assert "bad_day" in dicts and "mixed" in dicts and "quoted" in dicts
    t = _same_table(p)
    assert t["d"].dtype == torch.int32 and t["ts"].dtype == torch.int64


def test_sql_date_query_on_csv_no_casts(tmp_path):
    p = _write(tmp_path, "id,d,amt\n1,2024-01-05,10\n2,2024-02-10,20\n3,2023-11-30,30\n"
                         "4,2024-02-29,40\n")
    q = ("SELECT DATE_TRUNC('month', d) AS m, SUM(amt) AS s FROM t "
         "WHERE d >= DATE '2024-01-01' GROUP BY m ORDER BY m")
    from radix_sort_tpu.sql import sql as jsql

    got = rst.sql(q, {"t": TTable.from_csv(p, device="cpu")}).collect()
    assert got.to_numpy()["s"].tolist() == [10, 60]
    same(jitted(lambda t: jsql(q, {"t": t}).collect(), JTable.from_csv(p)), got)


def test_overlong_numeric_field_degrades_to_string(tmp_path):
    tiny = "0." + "0" * 70 + "1"  # 73 chars: past the parser's 63-char numeric cap
    p = _write(tmp_path, f"f\n{tiny}\n2.5\n")
    cols, dicts, _ = _same_parse(p)
    assert "f" in dicts and dicts["f"][cols["f"][0]] == tiny


def test_int_promotes_to_float_then_string(tmp_path):
    p = _write(tmp_path, "a,b\n1,1\n2.5,x\n3,4\n")
    cols, dicts, _ = _same_parse(p)
    assert cols["a"].dtype == np.float64 and cols["a"].tolist() == [1.0, 2.5, 3.0]
    assert dicts["b"][cols["b"]].tolist() == ["1", "x", "4"]
    _same_table(p)


@pytest.mark.parametrize("text,match", [("a,b\n1,2\n3\n", "fields"),
                                        ('a\n"unterminated\n', "unterminated")])
def test_malformed_raises(tmp_path, text, match):
    p = _write(tmp_path, text)
    with pytest.raises(RuntimeError, match=match):
        csvio.parse_csv(p)
    with pytest.raises(RuntimeError, match=match):
        jcsv.parse_csv(p)


def test_table_from_csv_nulls_and_quotes(tmp_path):
    p = _write(tmp_path, 'city,v,q\nosaka,3,"a,b"\nlima,,"say ""x"""\nosaka,9,\n')
    t = _same_table(p)
    out = t.aggregate("city", {"n": ("count", "v"), "s": ("sum", "v")}).to_numpy()
    assert out["city"].tolist() == ["lima", "osaka"]
    assert out["n"].tolist() == [0, 2]  # NULL v does not count
    assert np.ma.getdata(out["s"]).tolist()[1] == 12
    assert t.to_numpy()["q"].tolist()[:2] == ["a,b", 'say "x"']


def test_table_from_csv_dtypes_takes_read_csv(tmp_path):
    p = _write(tmp_path, MIXED)
    t = _same_table(p, dtypes={"w": np.float32})
    assert t["w"].dtype == torch.float32
    cols = tio.read_csv(p, dtypes={"w": np.float32})
    jcols = jio.read_csv(p, dtypes={"w": np.float32})
    assert list(cols) == list(jcols)
    for name in cols:
        assert type(cols[name]) is type(jcols[name]) and cols[name].dtype == jcols[name].dtype
        np.testing.assert_array_equal(np.ma.getdata(cols[name]), np.ma.getdata(jcols[name]))
        np.testing.assert_array_equal(np.ma.getmaskarray(cols[name]),
                                      np.ma.getmaskarray(jcols[name]))


def test_table_from_csv_defaults_to_the_gpu(tmp_path):
    p = _write(tmp_path, "a\n1\n")
    if torch.cuda.is_available():
        assert TTable.from_csv(p)["a"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTable.from_csv(p)


# ---------------------------------------------------------------- strings

def test_native_intern_encode_matches_np_unique(rng):
    raw = np.char.add("w", rng.integers(0, 500, 20000).astype(np.str_))
    raw[3] = ""
    codes0, firsts = csvio.intern_rows(raw)  # the native intern
    v2, inv = np.unique(raw, return_inverse=True)
    assert sorted(raw[firsts].tolist()) == v2.tolist()  # each distinct value once
    np.testing.assert_array_equal(raw[firsts][codes0], raw)  # first-seen codes
    np.testing.assert_array_equal(np.unique(codes0, return_index=True)[1], firsts)
    codes, vocab = TS.encode(raw)
    assert vocab.tolist() == v2.tolist() and vocab[0] == ""
    np.testing.assert_array_equal(codes, inv)
    np.testing.assert_array_equal(vocab[codes], raw)
    jc, jv = __import__("radix_sort_tpu.strings", fromlist=["encode"]).encode(raw)
    np.testing.assert_array_equal(codes, jc)
    assert vocab.tolist() == jv.tolist()


def test_native_encode_without_empty_string(rng):
    raw = rng.choice(np.array(["kiwi", "fig", "date", "apple"]), 1000)
    codes, vocab = TS.encode(raw)
    assert vocab.tolist() == ["", "apple", "date", "fig", "kiwi"]
    np.testing.assert_array_equal(vocab[codes], raw)


def test_native_unify_matches_union1d(rng):
    a = np.unique(np.concatenate([[""], np.char.add("a", rng.integers(0, 300, 400).astype(np.str_))]))
    b = np.unique(np.concatenate([[""], np.char.add("a", rng.integers(100, 900, 700).astype(np.str_)),
                                  ["zz-longer-value"]]))
    assert csvio.merge_sorted(a, b) is not None  # the native path runs
    union, ra, rb = TS.unify(a, b)
    want = np.union1d(a, b)
    assert union.tolist() == want.tolist()
    np.testing.assert_array_equal(ra, np.searchsorted(want, a).astype(np.uint32))
    np.testing.assert_array_equal(rb, np.searchsorted(want, b).astype(np.uint32))
    assert ra.dtype == rb.dtype == np.uint32


# ---------------------------------------------------------------- the loader

_LOAD = """
import sys
import numpy as np
from radix_sort_tpu_torch.native import _gxx, host
host.LIBRARY = _gxx.HostLibrary("rst_host", "host_radix.cpp", host._bind, build_dir=sys.argv[1])
assert host.LIBRARY.load() is not None
x = np.random.default_rng(0).integers(0, 2**32, 100_000, dtype=np.uint64)
assert (host.host_sort(x) == np.sort(x)).all()
print("loaded", host.LIBRARY.path())
"""


def test_two_processes_load_at_once(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    # one library, no temporary file left behind
    assert [f.name for f in tmp_path.iterdir()] == [f"librst_host-{_gxx.cpu_tag()}-"
                                                     f"{outs[0][0].split('-')[-1].strip()}"]


def _built(tmp_path, name):
    lib = _gxx.HostLibrary("rst_host", "host_radix.cpp", host._bind, build_dir=tmp_path)
    assert lib.load() is not None
    built = lib.path()
    return built, built.with_name(name)


def test_stale_library_beats_none_on_the_same_host(tmp_path):
    built, stale = _built(tmp_path, f"librst_host-{_gxx.cpu_tag()}-{'0' * 16}.so")
    os.replace(built, stale)
    lib = _gxx.HostLibrary("rst_host", "host_radix.cpp", host._bind, build_dir=tmp_path,
                           cxx=str(tmp_path / "no-such-compiler"))
    assert lib.load() is not None and not lib.path().exists()


def test_library_of_another_cpu_is_never_loaded(tmp_path):
    built, other = _built(tmp_path, f"librst_host-{'f' * 12}-{'0' * 16}.so")
    os.replace(built, other)
    lib = _gxx.HostLibrary("rst_host", "host_radix.cpp", host._bind, build_dir=tmp_path,
                           cxx=str(tmp_path / "no-such-compiler"))
    assert lib.load() is None


def test_stale_library_without_the_symbols_is_refused(tmp_path):
    built, _ = _built(tmp_path, "unused")
    os.replace(built, tmp_path / f"librst_csv-{_gxx.cpu_tag()}-{'0' * 16}.so")
    lib = _gxx.HostLibrary("rst_csv", "csv_loader.cpp", csvio._bind, build_dir=tmp_path,
                           cxx=str(tmp_path / "no-such-compiler"))
    assert lib.load() is None


def test_no_compiler_falls_back_with_the_same_results(rng, tmp_path, monkeypatch):
    x = rng.integers(-2**40, 2**40, 20_000).astype(np.int64)
    v = np.arange(20_000, dtype=np.uint64)
    want = (host_sort(x), *host_sort_pairs(x, v))
    codes, vocab = TS.encode(np.array(["b", "a", "", "b"]))
    none = dict(build_dir=tmp_path, cxx=str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(host, "LIBRARY", _gxx.HostLibrary("rst_host", "host_radix.cpp",
                                                          host._bind, **none))
    monkeypatch.setattr(csvio, "LIBRARY", _gxx.HostLibrary("rst_csv", "csv_loader.cpp",
                                                           csvio._bind, **none))
    assert not native_available() and not csvio.csv_native_available()
    got = (host_sort(x), *host_sort_pairs(x, v))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    c2, v2 = TS.encode(np.array(["b", "a", "", "b"]))
    np.testing.assert_array_equal(c2, codes)
    assert v2.tolist() == vocab.tolist()
    p = _write(tmp_path, "city,v\nosaka,3\nlima,4\n")
    with pytest.raises(RuntimeError, match="unavailable"):
        csvio.parse_csv(p)
    t = TTable.from_csv(p, device="cpu")  # the numpy path
    assert t.to_numpy()["city"].tolist() == ["osaka", "lima"]
    assert t.to_numpy()["v"].tolist() == [3, 4]
