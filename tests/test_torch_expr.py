"""Port parity: expr.py, on the CPU.

The same expression, built with each package's ``col`` / ``lit`` / ...,
evaluates against the same seeded numpy columns held by each package's
``Table`` (the port's on the CPU). Both results must have the same dtype,
the same NULL mask and the same values, bit for bit (floats by their bits,
every NaN alike), at the rows the mask leaves valid: under a NULL mask the
value is not part of the contract (consumers zero it). ``exp``, the
logarithms and float ``pow`` may differ by 2 ULP. Integer ``//`` and ``%``
never see a zero divisor at a valid row (the reference leaves it undefined),
nor does a float-to-integer cast see an out-of-range value.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import radix_sort_tpu.expr as JE  # noqa: E402
import radix_sort_tpu_torch.expr as TE  # noqa: E402
from radix_sort_tpu.table import Table as JTable  # noqa: E402
from radix_sort_tpu_torch.table import Table as TTable  # noqa: E402

N = 32
DTYPES = ["int32", "int64", "uint32", "uint64", "float32", "float64", "bool"]
INTS = ["int32", "int64", "uint32", "uint64"]
NULLABLE = ["int32", "uint32", "float64", "bool"]
F32_SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -2.5, 3.0], np.float32)


def _values(rng, dt, n=N):
    dt = np.dtype(dt)
    if dt == bool:
        return rng.random(n) < 0.5
    if dt.kind == "f":
        v = (rng.standard_normal(n) * 8).astype(dt)
        v[: F32_SPECIALS.size] = F32_SPECIALS
        v[F32_SPECIALS.size:F32_SPECIALS.size + 4] = [2.5, 0.5, -0.5, 7.0]  # ties, exact
        return v
    info = np.iinfo(dt)
    v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    v[:6] = np.array([0, 1, 2, 7, info.max, info.min], dtype=dt)
    return v


def _columns(seed=1):
    rng = np.random.default_rng(seed)
    cols = {}
    for dt in DTYPES:
        cols[f"a_{dt}"] = _values(rng, dt)
        cols[f"b_{dt}"] = _values(rng, dt)[rng.permutation(N)]
        if dt != "bool":
            small = rng.integers(1, 9, N)
            if dt[0] == "i" or dt[0] == "f":
                small = small * rng.choice([-1, 1], N)
            cols[f"d_{dt}"] = small.astype(dt)  # nonzero divisors
            bits = 8 * np.dtype(dt).itemsize
            cols[f"s_{dt}"] = rng.integers(0, bits, N).astype(dt) if dt[0] != "f" else small.astype(dt)
            cols[f"e_{dt}"] = rng.integers(0, 4, N).astype(dt)  # small exponents
    for dt in NULLABLE:
        cols[f"m_{dt}"] = np.ma.MaskedArray(_values(rng, dt), rng.random(N) < 0.3)
        cols[f"n_{dt}"] = np.ma.MaskedArray(_values(rng, dt), rng.random(N) < 0.3)
        if dt != "bool":
            cols[f"nd_{dt}"] = np.ma.MaskedArray(cols[f"d_{dt}"], rng.random(N) < 0.3)
    cols["s"] = rng.choice(["apple", "Banana", "cherry", "date", " fig "], N)
    cols["ms"] = [None if r < 0.3 else w for r, w in
                  zip(rng.random(N), rng.choice(["kiwi", "lime", "apple"], N))]
    cols["day"] = np.datetime64("1999-12-20") + rng.integers(0, 800, N).astype("timedelta64[D]")
    cols["ts"] = (np.datetime64("2024-01-01T00:00:00", "us")
                  + rng.integers(0, 10**11, N).astype("timedelta64[us]"))
    cols["num_s"] = rng.choice(["12", "-7", "x", "3.5", " 40 "], N)
    return cols


COLS = _columns()
JT = JTable(COLS)
TT = TTable(COLS, device="cpu")


def _host(v):
    if torch.is_tensor(v):
        sdt = {torch.uint16: torch.int16, torch.uint32: torch.int32,
               torch.uint64: torch.int64}.get(v.dtype)
        a = (v if sdt is None else v.view(sdt)).numpy()
        return a if sdt is None else a.view(str(v.dtype).replace("torch.", ""))
    return v


def _bits_equal(x, y):
    if x.dtype.kind == "f":
        nan = np.isnan(x)
        np.testing.assert_array_equal(nan, np.isnan(y))
        x, y = np.where(nan, 0, x).astype(x.dtype), np.where(nan, 0, y).astype(y.dtype)
        x, y = x.view(f"u{x.itemsize}"), y.view(f"u{y.itemsize}")
    np.testing.assert_array_equal(y, x)


def _ulps(x, y):
    """Distance in units in the last place (same-sign finite floats)."""
    ix = x.view(f"i{x.itemsize}").astype(np.int64)
    iy = y.view(f"i{y.itemsize}").astype(np.int64)
    return np.abs(ix - iy)


def check(build, ulp=0, table=(JT, TT)):
    """``build(module)`` makes the expression from either package's expr
    module; both evaluations must agree (see the module docstring)."""
    jt, tt = table
    jv, jm = build(JE).evaluate_masked(jt)
    tv, tm = build(TE).evaluate_masked(tt)
    if not isinstance(jv, jnp.ndarray) and not torch.is_tensor(tv):
        assert type(jv) is type(tv) and jv == tv, (jv, tv)  # two Python scalars
        return
    jv, tv = np.asarray(jv), _host(tv)
    assert tv.dtype == jv.dtype, (tv.dtype, jv.dtype)
    assert (jm is None) == (tm is None)
    valid = np.ones(np.broadcast_shapes(jv.shape, tv.shape), bool)
    if jm is not None:
        jm, tm = np.asarray(jm), _host(tm)
        assert tm.dtype == jm.dtype  # an integer AND/OR with NULLs: an integer mask
        np.testing.assert_array_equal(*np.broadcast_arrays(tm, jm))
        valid = ~np.broadcast_to(jm.astype(bool), valid.shape)
    jv, tv = np.broadcast_to(jv, valid.shape)[valid], np.broadcast_to(tv, valid.shape)[valid]
    if ulp:
        fin = np.isfinite(jv) & np.isfinite(tv)
        _bits_equal(jv[~fin], tv[~fin])
        assert _ulps(jv[fin], tv[fin]).max(initial=0) <= ulp
    else:
        _bits_equal(jv, tv)


# ---- binary operators over every dtype

_ARITH = ["add", "sub", "mul", "truediv", "floordiv", "mod", "min", "max", "pow"]
_CMP = ["eq", "ne", "lt", "le", "gt", "ge"]
_BITS = ["and", "or", "xor"]
_SHIFTS = ["lshift", "rshift"]
_PY = {"add": "__add__", "sub": "__sub__", "mul": "__mul__", "truediv": "__truediv__",
       "floordiv": "__floordiv__", "mod": "__mod__", "eq": "__eq__", "ne": "__ne__",
       "lt": "__lt__", "le": "__le__", "gt": "__gt__", "ge": "__ge__", "and": "__and__",
       "or": "__or__", "xor": "__xor__", "lshift": "__lshift__", "rshift": "__rshift__",
       "min": "minimum", "max": "maximum", "pow": "pow"}


def _binop_cases():
    for dt in DTYPES:
        ops = _CMP + (["add", "mul", "min", "max"] + _BITS if dt == "bool"
                      else _ARITH + (_BITS + _SHIFTS if dt in INTS else []))
        for op in ops:
            yield dt, op


def _rhs(dt, op):
    if op in ("floordiv", "mod") and dt in INTS:
        return f"d_{dt}"
    if op in _SHIFTS:
        return f"s_{dt}"
    if op == "pow":
        return f"e_{dt}" if dt in INTS else f"b_{dt}"
    return f"b_{dt}"


@pytest.mark.parametrize("dt,op", list(_binop_cases()))
def test_binop_matches_reference(dt, op):
    rhs = _rhs(dt, op)
    ulp = 2 if op == "pow" and dt.startswith("float") else 0
    check(lambda m: getattr(m.col(f"a_{dt}"), _PY[op])(m.col(rhs)), ulp=ulp)


@pytest.mark.parametrize("dt,op", [(dt, op) for dt, op in _binop_cases() if dt in NULLABLE])
def test_binop_over_nullable_columns(dt, op):
    """Both operands nullable (the right one a nonzero divisor or a shift
    count where the op needs one): the mask is the OR of the operands'."""
    rhs = _rhs(dt, op)
    rhs = {"b": f"n_{dt}", "d": f"nd_{dt}"}.get(rhs[0], rhs)
    ulp = 2 if op == "pow" and dt.startswith("float") else 0
    check(lambda m: getattr(m.col(f"m_{dt}"), _PY[op])(m.col(rhs)), ulp=ulp)


@pytest.mark.parametrize("a", DTYPES)
def test_mixed_dtypes_promote_as_reference(a):
    for b in DTYPES:
        check(lambda m: m.col(f"a_{a}") < m.col(f"b_{b}"))
        if "bool" not in (a, b):
            check(lambda m: m.col(f"a_{a}") - m.col(f"b_{b}"))
            check(lambda m: m.col(f"a_{a}") / m.col(f"d_{b}"))
            check(lambda m: m.col(f"a_{a}").maximum(m.col(f"b_{b}")))


LITERALS = [3, -2, 2.5, True, np.float64(1.25), np.float32(-0.5), np.int32(5),
            np.uint8(7), np.int64(-9), np.uint32(4000000000)]


@pytest.mark.parametrize("dt", DTYPES)
def test_literals_weak_and_strong(dt):
    for v in LITERALS:
        if dt == "bool" and not isinstance(v, (bool, np.bool_)):
            check(lambda m: m.col(f"a_{dt}") + 1)
            continue
        check(lambda m: m.col(f"a_{dt}") + v)
        check(lambda m: v * m.col(f"a_{dt}"))
        check(lambda m: m.col(f"a_{dt}") >= v)
        if dt != "bool" and not isinstance(v, bool):
            check(lambda m: m.col(f"a_{dt}") / v if v != 0 else m.col(f"a_{dt}"))
            check(lambda m: m.lit(v) - m.col(f"a_{dt}"))


def test_two_literals_stay_python_scalars():
    check(lambda m: m.lit(7) // m.lit(2))
    check(lambda m: m.lit(7) / m.lit(2))
    check(lambda m: m.lit(1.5) < m.lit(2))
    check(lambda m: m.lit(3).maximum(m.lit(9)))
    check(lambda m: m.lit(2) + m.null())
    check(lambda m: -m.lit(4))


# ---- unary operators and casts

_UN = ["neg", "invert", "abs", "floor", "ceil", "round", "sign", "sqrt", "exp", "log",
       "log10", "log2"]


def _unop_cases():
    for dt in DTYPES:
        for op in _UN:
            if dt == "bool" and op != "invert":
                continue
            if dt.startswith("float") and op == "invert":
                continue
            yield dt, op


@pytest.mark.parametrize("dt,op", list(_unop_cases()))
def test_unop_matches_reference(dt, op):
    ulp = 2 if op in ("exp", "log", "log10", "log2") else 0

    def build(m):
        c = m.col(f"a_{dt}")
        if op == "neg":
            return -c
        if op == "invert":
            return ~c
        return getattr(c, op)()

    check(build, ulp=ulp)


def test_float_specials_bit_for_bit():
    for dt in ("float32", "float64"):
        a = f"a_{dt}"
        for other in (f"b_{dt}", f"d_{dt}", "a_float32"):
            check(lambda m: m.col(a) // m.col(other))
            check(lambda m: m.col(a) % m.col(other))
            check(lambda m: m.col(a).minimum(m.col(other)))
            check(lambda m: m.col(a).maximum(m.col(other)))
        check(lambda m: m.col(a).sign())
        check(lambda m: m.col(a).round())
        check(lambda m: m.col(a) // 0.0)
        check(lambda m: m.col(a) / 0.0)
        check(lambda m: m.col(a) % -0.0)


@pytest.mark.parametrize("src", DTYPES)
def test_cast_matches_reference(src):
    for dst in DTYPES:
        if src.startswith("float") and dst != "bool" and not dst.startswith("float"):
            # only in-range, finite values (out of range is undefined)
            check(lambda m: m.col(f"d_{src}").abs().cast(dst))
            continue
        check(lambda m: m.col(f"a_{src}").cast(dst))


def test_uint_arithmetic_wraps():
    check(lambda m: m.col("a_uint32") + np.uint32(1))
    check(lambda m: m.col("a_uint32") * m.col("a_uint32"))
    check(lambda m: -m.col("a_uint32"))
    check(lambda m: m.col("a_uint64") - m.col("b_uint64"))
    check(lambda m: m.col("a_uint64") // m.col("b_uint64").maximum(1))
    check(lambda m: m.col("a_uint64") % m.col("b_uint64").maximum(1))
    check(lambda m: m.col("a_uint64") >> 63)
    v, _ = (TE.lit(np.uint32(2**32 - 1)) + TE.col("a_uint32")).evaluate_masked(
        TTable({"a_uint32": np.array([1, 2], np.uint32)}, device="cpu"))
    assert v.dtype == torch.uint32 and v.view(torch.int32).tolist() == [0, 1]


# ---- NULLs: masks, Kleene logic, where / coalesce / nullif / null


def test_null_propagation_and_kleene():
    check(lambda m: m.col("m_int32") + m.col("a_int32"))
    check(lambda m: m.col("m_int32") * 2 > m.col("d_int32"))
    check(lambda m: m.col("m_bool") & m.col("a_bool"))
    check(lambda m: m.col("m_bool") | m.col("a_bool"))
    check(lambda m: (m.col("m_bool") | m.col("m_int32").is_null()) & ~m.col("m_bool"))
    check(lambda m: (m.col("m_float64") > 0) & (m.col("m_int32") < 3))
    check(lambda m: m.col("m_int32") & m.col("a_int32"))
    check(lambda m: m.null() & m.col("a_bool"))
    check(lambda m: m.null() | m.col("a_bool"))
    check(lambda m: ~m.col("m_bool"))
    check(lambda m: m.col("m_float64").sqrt())
    check(lambda m: m.col("m_uint32") + 1)


def test_where_coalesce_nullif_null():
    check(lambda m: m.where(m.col("a_bool"), m.col("a_int32"), m.col("b_float32")))
    check(lambda m: m.where(m.col("a_bool"), 1, 2))
    check(lambda m: m.where(m.col("a_bool"), 1, 2.5) + m.col("a_int32"))
    check(lambda m: m.where(m.col("a_bool"), 1, 0) + m.col("a_int32"))
    check(lambda m: m.where(m.col("m_bool"), m.col("m_int32"), m.null()))
    check(lambda m: m.where(m.col("m_int32") > 0, m.col("a_uint32"), m.col("b_uint32")))
    check(lambda m: m.where(m.col("a_bool"), m.null(), 5) * m.col("a_int32"))
    check(lambda m: m.coalesce(m.col("m_int32"), 0))
    check(lambda m: m.coalesce(m.col("m_int32"), m.col("m_float64"), 7))
    check(lambda m: m.coalesce(m.null(), 5))
    check(lambda m: m.col("m_uint32").fill_null(np.uint32(9)))
    check(lambda m: m.nullif(m.col("a_int32"), 7))
    check(lambda m: m.nullif(m.col("m_int32"), m.col("b_int32")))
    check(lambda m: m.nullif(m.col("a_float64"), m.col("b_float64")))
    check(lambda m: m.col("m_int32").is_null())
    check(lambda m: m.col("a_int32").is_not_null())
    check(lambda m: m.null().is_null())
    check(lambda m: m.col("a_int32").isin([0, 1, 7]))


def test_udf_propagates_null():
    jv, jm = JE.udf(lambda a, b: a * 2 + b, ["m_int32", "a_int32"]).evaluate_masked(JT)
    tv, tm = TE.udf(lambda a, b: a * 2 + b, ["m_int32", "a_int32"]).evaluate_masked(TT)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tv.numpy()[~tm.numpy()], np.asarray(jv)[~np.asarray(jm)])
    assert repr(TE.udf(abs, ["a", "b"], "f")) == repr(JE.udf(abs, ["a", "b"], "f"))


# ---- strings and dates


def test_string_comparisons_and_like():
    check(lambda m: m.col("s") == "cherry")
    check(lambda m: m.col("s") != "nope")
    check(lambda m: m.col("s") < "cherry")
    check(lambda m: "cherry" <= m.col("s"))
    check(lambda m: m.col("s") > "b")
    check(lambda m: m.col("ms") >= "kiwi")
    check(lambda m: m.col("s") == m.col("ms"))
    check(lambda m: m.col("s").upper() < m.col("ms"))
    check(lambda m: m.col("s").like("%an%"))
    check(lambda m: m.col("ms").like("_i%"))
    check(lambda m: m.col("s").lower().like("b%"))
    check(lambda m: m.lit("a") < m.lit("b"))


@pytest.mark.parametrize("fn", ["upper", "lower", "trim", "ltrim", "rtrim", "reverse",
                                "length", "substr", "replace", "left", "right", "lpad",
                                "rpad", "strpos", "starts_with", "ends_with", "contains",
                                "concat", "cast"])
def test_string_functions(fn):
    args = {"substr": (2, 3), "replace": ("a", "oo"), "left": (3,), "right": (2,),
            "lpad": (7, "*"), "rpad": (6,), "strpos": ("a",), "starts_with": ("b",),
            "ends_with": ("e",), "contains": ("an",), "trim": (), "concat": ("-x", )}
    for name in ("s", "ms"):
        if fn == "cast":
            for dt in ("int32", "float64", "bool"):
                check(lambda m: m.col("num_s").cast(dt))
            return
        check(lambda m: getattr(m.col(name), fn)(*args.get(fn, ())))
    if fn == "concat":
        check(lambda m: m.concat(m.col("s"), "/", m.col("ms").upper()))
        check(lambda m: m.col("s").concat("-", m.col("s").upper()))


def test_string_where_and_coalesce():
    check(lambda m: m.where(m.col("a_bool"), m.col("s"), m.col("ms")) == "apple")
    check(lambda m: m.coalesce(m.col("ms"), m.col("s")) < "c")
    check(lambda m: m.where(m.col("a_bool"), m.col("s"), m.null()) == "date")
    for build in (lambda m: m.where(m.col("a_bool"), m.col("s"), m.lit("zz")),
                  lambda m: m.coalesce(m.col("ms"), "none")):
        jc, jv, jm = build(JE).string_result(JT)
        tc, tv, tm = build(TE).string_result(TT)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(_host(tc), np.asarray(jc))
        assert (jm is None) == (tm is None)


def test_string_arithmetic_rejected():
    for m, t in ((JE, JT), (TE, TT)):
        with pytest.raises(TypeError, match="not defined for string column"):
            (m.col("s") + 1).evaluate(t)
        with pytest.raises(TypeError, match="non-string operand"):
            (m.col("s") == 3).evaluate(t)


@pytest.mark.parametrize("fn", ["year", "month", "day", "day_of_week", "day_of_year",
                                "week", "quarter", "date_trunc", "add_months"])
def test_date_functions(fn):
    args = {"date_trunc": ("month",), "add_months": (1,)}
    for name in ("day", "ts"):
        check(lambda m: getattr(m.col(name), fn)(*args.get(fn, ())))


def test_timestamp_fields_and_intervals():
    for f in ("hour", "minute", "second", "ms", "us", "epoch"):
        check(lambda m: m.Expr("datefn", (f, m.col("ts"), ())))
    check(lambda m: m.Expr("datefn", ("add_time", m.col("day"), (3, 0))))
    check(lambda m: m.Expr("datefn", ("add_time", m.col("ts"), (1, 5000))))
    check(lambda m: m.col("ts").date_trunc("hour"))


# ---- the tree itself


def test_columns_rename_and_repr():
    def build(m):
        return m.where((m.col("a") + 2.5 > m.col("b")) & m.col("c").like("x%"),
                       m.coalesce(m.col("d"), m.null()), m.col("e").cast("int64").abs())

    je, te = build(JE), build(TE)
    assert te.columns == je.columns == frozenset("abcde")
    assert repr(te) == repr(je)
    assert repr(te.rename({"a": "z"})) == repr(je.rename({"a": "z"}))
    assert repr(TE.lit(torch.tensor(3, dtype=torch.uint32))) == repr(JE.lit(jnp.uint32(3)))
    assert repr(TE.lit(torch.tensor([1.5, 2.0]))) == repr(JE.lit(jnp.asarray([1.5, 2.0],
                                                                             jnp.float32)))
    with pytest.raises(TypeError, match="no truth value"):
        bool(TE.col("a") > 1)


def test_promote_types_matches_jax():
    names = ["bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32",
             "int64", "float16", "bfloat16", "float32", "float64"]
    tdt = {n: getattr(torch, n) for n in names}
    for a in names:
        for b in names:
            want = str(jnp.promote_types(a, b))
            assert str(TE.promote_types(tdt[a], tdt[b])).replace("torch.", "") == want
        for w in (True, 1, 2.5):
            x = jnp.zeros(2, a) + w
            got, weak = TE.result_type((tdt[a], False), TE._jtype(w))
            assert str(got).replace("torch.", "") == str(x.dtype), (a, w)
            assert weak == x.weak_type, (a, w)
