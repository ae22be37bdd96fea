"""Port parity: nulls.py, strings.py and dates.py.

The port keeps its own copies of these modules (it imports nothing of the
JAX package). The same seeded inputs go through both packages: string
vocabularies, codes and LIKE masks must be equal; the civil-calendar
arithmetic on int32 days and int64 microseconds must agree bit for bit with
the JAX package and with numpy ``datetime64``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from radix_sort_tpu import dates as JD  # noqa: E402
from radix_sort_tpu import nulls as JN  # noqa: E402
from radix_sort_tpu import strings as JS  # noqa: E402
from radix_sort_tpu_torch import dates as TD  # noqa: E402
from radix_sort_tpu_torch import nulls as TN  # noqa: E402
from radix_sort_tpu_torch import strings as TS  # noqa: E402

WORDS = np.array(["", "a", "ab", "abc", "b", "banana", "Zeta", "zeta", "é", "a%b", "a_b",
                  "x" * 40])

# ---------------------------------------------------------------- strings


def test_encode_decode_unify_lookup(rng):
    x = rng.choice(WORDS[1:], 200)
    y = rng.choice(WORDS[3:], 150)
    jc, jv = JS.encode(x)
    tc, tv = TS.encode(x)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    assert tc.dtype == np.uint32 and tv[0] == ""
    np.testing.assert_array_equal(TS.decode(tc, tv), x)
    _, jv2 = JS.encode(y)
    _, tv2 = TS.encode(y)
    for a, b in zip(JS.unify(jv, jv2), TS.unify(tv, tv2)):
        np.testing.assert_array_equal(b, a)
    q = ["banana", "nope", "", "zeta"]
    np.testing.assert_array_equal(TS.lookup(tv, q), JS.lookup(jv, q))
    assert TS.lookup(tv, "nope") == JS.lookup(jv, "nope") == TS.NOT_FOUND
    np.testing.assert_array_equal(TS.decode(np.array([0, 2, 0xFFFFFFFF], np.uint32), tv),
                                  JS.decode(np.array([0, 2, 0xFFFFFFFF], np.uint32), jv))
    # bytes and object input, and an empty column
    ascii_x = x[np.char.str_len(np.char.encode(x, "utf-8")) == np.char.str_len(x)]
    for data in (ascii_x.astype(np.bytes_), x.astype(object), np.array([], np.str_)):
        for a, b in zip(JS.encode(data), TS.encode(data)):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("pattern", ["a%", "%a", "%an%", "a%b", "b_n%", "", "%", "a\\%b",
                                     "a\\_b", "_", "%e%a%"])
def test_like_mask(pattern):
    np.testing.assert_array_equal(TS.like_mask(WORDS, pattern), JS.like_mask(WORDS, pattern))


@pytest.mark.parametrize("fn,args", [("upper", ()), ("lower", ()), ("trim", ()),
                                     ("substr", (2, 2)), ("left", (-1,)), ("right", (2,)),
                                     ("reverse", ()), ("lpad", (5, "*")), ("rpad", (3,)),
                                     ("replace", ("a", "AA")), ("length", ()),
                                     ("strpos", ("an",)), ("starts_with", ("a",)),
                                     ("contains", ("b",))])
def test_string_functions_and_revocab(fn, args):
    table = {**TS.STR_FNS, **TS.STR_NUM_FNS, **TS.STR_BOOL_FNS}
    jtable = {**JS.STR_FNS, **JS.STR_NUM_FNS, **JS.STR_BOOL_FNS}
    got, want = table[fn](WORDS, *args), jtable[fn](WORDS, *args)
    np.testing.assert_array_equal(got, want)
    if fn in TS.STR_FNS:
        for a, b in zip(JS.revocab(want), TS.revocab(got)):
            np.testing.assert_array_equal(b, a)
    assert TS.is_string_data(list(WORDS)) and not TS.is_string_data(np.arange(3))


# ---------------------------------------------------------------- nulls

@pytest.mark.parametrize("kind", ["masked_array", "masked_strings", "none_list", "none_strings",
                                  "masked_column", "plain"])
def test_detect(rng, kind):
    v = rng.integers(0, 9, 12)
    m = rng.random(12) < 0.4
    x = {"masked_array": np.ma.MaskedArray(v, m),
         "masked_strings": np.ma.MaskedArray(WORDS, m),
         "none_list": [None if mi else int(vi) for vi, mi in zip(v, m)],
         "none_strings": [None if mi else str(w) for w, mi in zip(WORDS, m)],
         "masked_column": None, "plain": v}[kind]
    if kind == "masked_column":
        want = JN.detect(JN.MaskedColumn(v, m))
        got = TN.detect(TN.MaskedColumn(torch.from_numpy(v), m))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    else:
        want, got = JN.detect(x), TN.detect(x)
        if want is None:
            assert got is None
            return
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.bool


@pytest.mark.parametrize("dt", ["int8", "uint8", "int16", "uint16", "int32", "uint32", "int64",
                                "uint64", "float32", "float64", "bool"])
def test_dtype_extremes_and_names(dt):
    tdt = getattr(torch, dt)
    for jf, tf in ((JN.dtype_max, TN.dtype_max), (JN.dtype_min, TN.dtype_min)):
        want, got = np.asarray(jf(np.dtype(dt))), tf(tdt)
        assert got.dtype == tdt and got.shape == ()
        np.testing.assert_array_equal(
            np.frombuffer(TN_bytes(got), dtype=dt), np.frombuffer(want.tobytes(), dtype=dt))
    assert TN.mask_name("x") == JN.mask_name("x") and TN.is_mask_name(TN.mask_name("x"))
    assert TN.base_name(TN.mask_name("col")) == "col"
    a, b = torch.tensor([True, False]), torch.tensor([False, False])
    assert TN.merge_masks(None, b) is b and TN.merge_masks(a, None) is a
    assert TN.merge_masks(a, b).tolist() == [True, False]


def TN_bytes(t):
    """The raw bytes of a 0-dim tensor (unsigned dtypes by their signed view)."""
    signed = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}
    return (t.view(signed[t.dtype]) if t.dtype in signed else t).reshape(1).numpy().tobytes()


# ---------------------------------------------------------------- dates

def _days(rng, n=400):
    d = rng.integers(-800_000, 800_000, n).astype(np.int32)  # ~ -2200 .. 4160 AD
    d[:8] = [0, -1, 59, 60, 365, -719468, 11016, 19_000]  # leap days, epochs, 0000-03-01
    return d


@pytest.mark.parametrize("fn", list(TD.DATE_NUM_FNS))
def test_date_fields_match_reference(rng, fn):
    d = _days(rng)
    want = np.asarray(JD.DATE_NUM_FNS[fn](jnp.asarray(d)))
    got = TD.DATE_NUM_FNS[fn](torch.from_numpy(d)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_civil_round_trip_and_numpy(rng):
    d = _days(rng)
    y, m, dd = TD.civil_from_days(torch.from_numpy(d))
    np.testing.assert_array_equal(TD.days_from_civil(y, m, dd).numpy(), d)
    # against numpy's calendar: datetime64 -> Y / M / D
    dt = d.astype("datetime64[D]")
    np.testing.assert_array_equal(y.numpy(), dt.astype("datetime64[Y]").astype(np.int64) + 1970)
    np.testing.assert_array_equal(m.numpy(), dt.astype("datetime64[M]").astype(np.int64) % 12 + 1)
    np.testing.assert_array_equal(
        dd.numpy(), (dt - dt.astype("datetime64[M]")).astype(np.int64) + 1)
    np.testing.assert_array_equal(TD.day_of_week(torch.from_numpy(d)).numpy(),
                                  (d.astype(np.int64) + 3) % 7 + 1)


@pytest.mark.parametrize("unit", ["year", "quarter", "month", "week", "day"])
def test_trunc_and_add_months(rng, unit):
    d = _days(rng)
    np.testing.assert_array_equal(TD.trunc_days(unit, torch.from_numpy(d)).numpy(),
                                  np.asarray(JD.trunc_days(unit, jnp.asarray(d))))
    for n in (1, -13, 25):
        np.testing.assert_array_equal(TD.add_months(torch.from_numpy(d), n).numpy(),
                                      np.asarray(JD.add_months(jnp.asarray(d), n)))
    with pytest.raises(ValueError, match="unit"):
        TD.trunc_days("decade", torch.from_numpy(d))


@pytest.mark.parametrize("fn", list(TD.TS_NUM_FNS) + ["days", "trunc"])
def test_timestamps_match_reference(rng, fn):
    ts = rng.integers(-(2**60), 2**60, 300).astype(np.int64)
    ts[:4] = [0, -1, TD.US_PER_DAY, -TD.US_PER_DAY - 1]
    if fn == "days":
        want, got = JD.ts_days(jnp.asarray(ts)), TD.ts_days(torch.from_numpy(ts))
    elif fn == "trunc":
        want = JD.trunc_us("hour", jnp.asarray(ts))
        got = TD.trunc_us("hour", torch.from_numpy(ts))
        np.testing.assert_array_equal(TD.trunc_us("month", torch.from_numpy(ts)).numpy(),
                                      np.asarray(JD.trunc_us("month", jnp.asarray(ts))))
    else:
        want, got = JD.TS_NUM_FNS[fn](jnp.asarray(ts)), TD.TS_NUM_FNS[fn](torch.from_numpy(ts))
    assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_date_codecs():
    d = np.array(["1969-12-31", "2024-02-29", "1900-03-01"], "datetime64[D]")
    for x in (d, d.astype("datetime64[M]"), d.astype("datetime64[s]") + np.timedelta64(5, "s")):
        jv, ju = JD.encode_datetime64(x)
        tv, tu = TD.encode_datetime64(x)
        assert ju == tu and tv.dtype == jv.dtype
        np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(TD.decode_days(torch.tensor([0, -1], dtype=torch.int32)),
                                  np.array(["1970-01-01", "1969-12-31"], "datetime64[D]"))
    assert TD.parse_date("2026-08-20") == JD.parse_date("2026-08-20")
    assert TD.parse_timestamp("2026-08-20 12:34:56.5") == JD.parse_timestamp(
        "2026-08-20 12:34:56.5")
    assert TD.is_datetime_data(d) and not TD.is_datetime_data(np.arange(3))
