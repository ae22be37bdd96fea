"""Port: the demo CLI (demo.py) on the CPU.

``demo.main([..., "--device", "cpu"])`` runs every suite, distribution and
engine at tiny sizes, and the persisted-dataset round trip. Each SQL text of
the queries suite runs through the JAX package's ``sql`` (under
``jax.jit``, as its demo runs it) and the port's on the same numpy rows,
drawn as both demos draw them; each operator of the ops suite runs through
the JAX function and the port's. Integers, keys, counts, ranks and masks
agree bit for bit; float sums and means within the recursive-summation
bound (n - 1) * u * sum|x| of float32 (u = 2**-24), which for these
all-positive sums is (n - 1) * u relative.
"""

import re

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
from radix_sort_tpu.sql import sql as jsql  # noqa: E402
from radix_sort_tpu.table import Table as JTable  # noqa: E402
from radix_sort_tpu_torch import demo  # noqa: E402
from radix_sort_tpu_torch import keys as K  # noqa: E402
from radix_sort_tpu_torch.ops import sample_sort  # noqa: E402
from radix_sort_tpu_torch.utils import io as tio  # noqa: E402
from test_torch_query import assert_same  # noqa: E402
from test_torch_table import jitted, same  # noqa: E402

N = 4096
U32 = 2.0**-24

LINE = re.compile(r"Sorted [\d.]+GB of \((u32|u64),\1\) data in: [\d.]+s  \([\d.]+M keys/s, "
                  r"[\d.]+ GB/s, dist=(\w+)\)( \[(\w+)\])?$")


def _lines(capsys):
    return [s for s in capsys.readouterr().out.splitlines() if s]


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("dist", ["uniform", "zipf", "geometric", "step_uniform"])
def test_sort_sweep_every_distribution_and_engine(capsys, dist):
    before = sample_sort.FALLBACKS
    demo.main(["--sizes", "0.0002", "0.0005", "--dtypes", "u32", "u64", "--runs", "1",
               "--dist", dist, "--engines", "comparator", "pallas", "auto", "--device", "cpu"])
    out = _lines(capsys)
    assert out[0].startswith("device=cpu") and "engines=['comparator', 'pallas', 'auto']" in out[0]
    rows = [LINE.match(s) for s in out[1:]]
    assert all(rows) and len(rows) == 2 * 2 * 3
    assert [(m[1], m[4]) for m in rows][:3] == [("u32", e) for e in ("comparator", "pallas", "auto")]
    assert {m[2] for m in rows} == {dist}
    assert sample_sort.FALLBACKS == before


@pytest.mark.parametrize("engine", ["comparator", "pallas", "xla_argsort", "xla_rank", "oracle"])
def test_u32_engines_and_the_single_engine_line(capsys, engine):
    demo.main(["--sizes", "0.0001", "--dtypes", "u32", "--runs", "2",
               "--implementation", engine, "--device", "cpu"])
    out = _lines(capsys)
    assert len(out) == 2 and LINE.match(out[1]) and LINE.match(out[1])[3] is None


def test_u64_rows_refuse_other_engines():
    with pytest.raises(SystemExit, match="comparator/pallas, not 'xla_rank'"):
        demo.main(["--sizes", "0.0001", "--dtypes", "u64", "--engines", "xla_rank",
                   "--device", "cpu"])


def test_the_gpu_is_the_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    for suite in ("sort", "ops", "queries"):
        with pytest.raises(SystemExit, match="--device cpu"):
            demo.main(["--suite", suite, "--sizes", "0.0001", "--ops-n", "64"])


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
@pytest.mark.parametrize("dtype", ["u32", "u64"])
def test_gen_data_then_data(capsys, tmp_path, dist, dtype):
    p = str(tmp_path / "d.raw")
    demo.main(["--gen-data", p, "--n", "5000", "--dist", dist, "--dtypes", dtype,
               "--device", "cpu"])
    out = _lines(capsys)
    want_dt = "uint64" if dtype == "u64" else "uint32"
    assert out == [f"wrote 5000 {want_dt} keys ({5000 * (8 if dtype == 'u64' else 4) / 1e9:.2f} GB)"
                   f" to {p} (dist={dist})"]
    arr = tio.read_raw(p)
    assert arr.dtype == want_dt and arr.shape == (5000,)
    np.testing.assert_array_equal(arr, tio.gen_data(str(tmp_path / "e.raw"), 5000, arr.dtype,
                                                    dist, device="cpu", seed=0))
    demo.main(["--data", p, "--engines", "comparator", "pallas", "--runs", "2",
               "--device", "cpu"])
    out = _lines(capsys)
    assert len(out) == 3
    for line, eng in zip(out[1:], ("comparator", "pallas")):
        assert line.startswith(f"Sorted {p} [5000 ({dtype},{dtype}) rows] with {eng}: ")
    # the uploaded rows are the file's keys, and every engine sorts them
    rows = demo._upload(arr, torch.device("cpu"))
    for fn in demo._engine_fns(dtype, ["comparator", "pallas"]).values():
        out = fn(rows)
        keys = (K.decode(K.merge64(out[0], out[1]), torch.uint64) if dtype == "u64" else out[0])
        got = keys.view(torch.int64 if dtype == "u64" else torch.int32).numpy().view(arr.dtype)
        np.testing.assert_array_equal(got, np.sort(arr))


def test_gen_data_needs_n():
    with pytest.raises(SystemExit, match="needs --n"):
        demo.main(["--gen-data", "x.raw", "--device", "cpu"])


@pytest.mark.parametrize("dist", ["uniform", "zipf", "geometric", "step_uniform"])
@pytest.mark.parametrize("dtype", ["u32", "u64"])
def test_engines_agree_with_a_stable_sort(dist, dtype):
    args = demo._parse_args(["--dist", dist, "--steps", "50", "--device", "cpu"])
    gen = torch.Generator().manual_seed(3)
    rows = demo._make_rows(gen, 20_000, dtype, args)
    if dtype == "u64":
        hi, lo, _, _ = rows
        word = K.merge64(hi, lo)
        # the row index as payload, so stability shows
        idx = K.split64(torch.arange(word.shape[0], dtype=torch.int64) ^ (-(1 << 63)))
        rows = (hi, lo, *idx)
        srt = torch.sort(word, stable=True)
        want = (*K.split64(srt.values), *(i[srt.indices] for i in idx))
    else:
        keys = rows[0]
        rows = (keys, torch.arange(keys.shape[0], dtype=torch.int32).view(torch.uint32))
        srt = torch.sort(K.encode(keys), stable=True)
        want = (keys[srt.indices], rows[1][srt.indices])
    for eng, fn in demo._engine_fns(dtype, ["comparator", "pallas"]).items():
        got = fn(rows)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), eng


def test_ops_and_queries_suites_print_every_entry(capsys):
    demo.main(["--suite", "ops", "--ops-n", "2048", "--groups", "64", "--runs", "1",
               "--device", "cpu"])
    out = _lines(capsys)
    assert out[0] == "device=cpu n=2,048 groups=64 runs=1"
    assert len(out) == 1 + len(demo.OPS)
    assert out[-1].startswith("hash_join inner 0.5Kx0.5K (cap 4K)")
    demo.main(["--suite", "queries", "--ops-n", "2048", "--runs", "1", "--device", "cpu"])
    out = _lines(capsys)
    assert out[0] == "device=cpu lineitem=2,048 customers=128 runs=1"
    assert [s[:45].rstrip() for s in out[1:]] == [q[0] for q in demo.QUERIES.values()]
    assert all(s.endswith("M rows/s") for s in out[1:])


# ---------------------------------------------------------------- queries parity

FLOATS = {"q1": ("rev", "aq"), "q3": ("rev",), "qwin": ("tot",), "qdate": ("rev",),
          "qfan": ("rev",)}


@pytest.mark.parametrize("name", list(demo.QUERIES))
def test_query_matches_the_reference(name):
    cols, dicts, kw = demo.query_tables(name, N, 0)
    text = demo.QUERIES[name][2]
    jt = [JTable(cols[a], dictionaries=dicts[a]) for a in cols]
    want = jitted(lambda *ts: jsql(text, dict(zip(cols, ts)), **kw).collect(), *jt)
    fn, args = demo.build_query(name, N, 0, "cpu")
    got = fn(*args)
    assert got.to_numpy()[list(got.to_numpy())[0]].shape[0] > 0
    # an all-positive float sum over at most N rows: within (N - 1) * u relative
    same(want, got, float_cols=FLOATS.get(name, ()), rtol=(N - 1) * U32)


def test_queries_data_is_the_reference_demos_rows():
    """The rows are drawn in the JAX demo's order (the columns of its packed
    LINEITEM buffer first), with the port's column dtypes."""
    d = demo.queries_data(N, 5)
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(d["line"]["status"], rng.integers(0, 8, N).astype(np.uint32))
    np.testing.assert_array_equal(d["line"]["qty"], rng.integers(1, 51, N).astype(np.int32))
    np.testing.assert_array_equal(d["line"]["price"], (rng.random(N) * 1000).astype(np.float32))
    assert d["line"]["custkey"].dtype == d["cust"]["custkey"].dtype == np.uint32
    assert d["line"]["d"].dtype == np.int32 and d["cust"]["custkey"].shape == (N // 16,)
    assert d["wvocab"].tolist() == sorted(f"w{i:04d}" for i in range(demo.N_WORDS))


# ---------------------------------------------------------------- ops parity

def _jax_op(name, d):
    return jax.jit(lambda as_j: _jax_op_body(name, d, as_j))(
        {k: jnp.asarray(v) for k, v in d.items()})


def _jax_op_body(name, d, as_j):
    if name == "window":
        return jrst.window(["rank", ("cumsum", as_j["v"]), ("sum", as_j["v"])],
                           partition_by=as_j["k"], order_by=as_j["o"])
    if name == "rolling":
        return jrst.window(("rolling_sum", as_j["v"], 64, 32),
                           partition_by=as_j["k"], order_by=as_j["o"])
    if name.startswith("hash_aggregate_"):
        return jrst.hash_aggregate(as_j["k"], as_j["v"], name[len("hash_aggregate_"):])
    if name == "join_asof":
        return jrst.join_asof(as_j["lk"], as_j["rk"], as_j["rv"], direction="backward")
    return jrst.hash_join(as_j["jk"], as_j["rv"], as_j["jk2"], as_j["rv"],
                          capacity=8 * d["jk"].shape[0], how="inner")


def _var_oracle(d):
    """The population variance of ``v`` by ``k`` as the port computes it:
    float32 values, two passes, each group's sum in float64 rounded once to
    float32, divided in float32; groups by key, the tail 0. Also each
    group's float32 summation bound against the reference's float32 sums:
    (n_g + 2) * u * sum of squares / n_g (the recursive-summation bound of
    the second pass, the squares' and the division's roundings), 0 on the
    tail."""
    order = np.argsort(d["k"], kind="stable")
    x = d["v"][order].astype(np.float32)
    _, gid, cnt = np.unique(d["k"][order], return_inverse=True, return_counts=True)
    c = np.ones(x.shape[0], np.float32)
    c[:cnt.shape[0]] = cnt

    def segsum(a):
        s = np.zeros(a.shape[0])
        np.add.at(s, gid, a.astype(np.float64))
        return s.astype(np.float32)

    dev = x - (segsum(x) / c)[gid]
    x64 = x.astype(np.float64)
    mean = np.bincount(gid, weights=x64) / cnt
    bound = np.zeros(x.shape[0])
    bound[:cnt.shape[0]] = (cnt + 2) * U32 * np.bincount(gid, weights=(x64 - mean[gid])**2) / cnt
    return segsum(dev * dev) / c, bound


@pytest.mark.parametrize("name", list(demo.OPS))
def test_op_matches_the_reference(name):
    groups = 64
    fn, args = demo.build_op(name, N, 0, "cpu", groups=groups)
    got = fn(*args)
    want = _jax_op(name, demo.ops_data(N, groups, 0))
    if name == "hash_aggregate_var":
        # var of int32 values per group, float32. The JAX package's float32
        # segment_sum drifts a few ULP over a group's ~64 squares (ROADMAP
        # reference faults); the port sums each group in float64 and rounds
        # once, so the variances are held to a numpy oracle of that, and to
        # the reference's within its float32 summation bound
        assert_same(want[0], got[0], name)
        assert_same(want[2], got[2], name)
        var, bound = _var_oracle(demo.ops_data(N, groups, 0))
        np.testing.assert_allclose(got[1].numpy(), var, rtol=1e-12, atol=1e-9)
        err = np.abs(got[1].numpy().astype(np.float64) - np.asarray(want[1], np.float64))
        assert (err <= bound).all()
        return
    assert_same(want, got, name)
