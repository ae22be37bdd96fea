"""Port parity: ops/window.py (window, WINDOW_OPS).

The same seeded numpy inputs go through the JAX package and the port on the
CPU. Ranks, counts, lags, integer sums, min / max and every other integer
or selected value agree bit for bit, dtype included. Float sums and means
(partition-wide, running, ROWS and RANGE frames) may differ in summation
order only: each stated bound is 8 ULP of the column's sum of |x|.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
from test_torch_query import F32_SPECIALS, assert_same, both, col  # noqa: E402

from radix_sort_tpu.ops import window as jw  # noqa: E402
from radix_sort_tpu_torch.ops import window as tw  # noqa: E402

N = 64
DT = {"i32": np.int32, "f32": np.float32, "u32": np.uint32, "i8": np.int8, "u64": np.uint64,
      "f64": np.float64, "u8": np.uint8, "i64": np.int64}
SUMMED = ("sum", "mean", "cumsum", "rolling_sum", "rolling_mean", "range_sum", "range_mean")


def _specs(v, ranged=True):
    specs = ["row_number", "rank", "dense_rank", "count", "percent_rank", "cume_dist",
             ("ntile", 5), ("rolling_count", 2, 1),
             ("sum", v), ("min", v), ("max", v), ("mean", v), ("cumsum", v), ("cummin", v),
             ("cummax", v), ("first_value", v), ("last_value", v), ("nth_value", v, 3),
             ("nth_value", v, 2, 7), ("lag", v), ("lag", v, 2, 5), ("lead", v, 3),
             ("rolling_sum", v, 2, 1), ("rolling_min", v, 3), ("rolling_max", v, 1, 2),
             ("rolling_mean", v, 2, 2)]
    if ranged:
        specs += [("range_sum", v, 7, 3), ("range_min", v, 7, 3), ("range_max", v, None, 0),
                  ("range_mean", v, 0, None), ("range_count", 5, 5), ("range_count", None, 2)]
    return specs


def _values(rng, kind):
    dt = np.dtype(DT[kind])
    if dt.kind == "f":
        v = (rng.standard_normal(N) * 100).astype(dt)
        v[:2] = [-0.0, 0.0]
        return v
    return col(rng, dt, N)


def _order(rng, kind):
    """Few distinct values (ties), specials for floats."""
    dt = np.dtype(DT[kind])
    if dt.kind == "f":
        o = rng.integers(-8, 8, N).astype(dt) * 4
        o[:6] = F32_SPECIALS[:6].astype(dt)  # +-0.0, +-inf, NaNs of both signs
        return o
    if dt.kind == "u":
        return rng.integers(0, 40, N).astype(dt)
    return rng.integers(-20, 20, N).astype(dt)


def check_outputs(specs, want, got, values=None):
    assert len(want) == len(got)
    tol = None
    if values is not None and np.dtype(values.dtype).kind == "f":
        tol = 8 * np.finfo(values.dtype).eps * float(np.abs(values.astype(np.float64)).sum())
    for spec, j, t in zip(specs, want, got):
        name = spec if isinstance(spec, str) else spec[0]
        if tol is not None and name in SUMMED:
            ja, ta = np.asarray(j), t.numpy()
            assert ja.dtype == ta.dtype, spec
            np.testing.assert_allclose(ta, ja, rtol=0, atol=tol, err_msg=str(spec))
        else:
            assert_same(j, t, str(spec))


def _both_windows(specs_of, v, **kw):
    jv, tv = both(v)
    jkw, tkw = {}, {}
    for k, c in kw.items():
        if isinstance(c, list) and c and isinstance(c[0], np.ndarray):
            jkw[k], tkw[k] = both(c)
        elif isinstance(c, np.ndarray):
            jkw[k], tkw[k] = both(c)
        else:
            jkw[k] = tkw[k] = c
    specs_j, specs_t = specs_of(jv), specs_of(tv)
    # the reference runs eagerly, as its own tests run it: under jax.jit XLA
    # folds the RANGE bound ``x + 0.0`` to ``x``, which moves the frame of a
    # -0.0 order value (IEEE gives -0.0 + 0.0 = +0.0, its total-order peer)
    return specs_t, jw.window(specs_j, **jkw), tw.window(specs_t, **tkw)


@pytest.mark.parametrize("layout", ["partitions", "one", "desc", "multi"])
@pytest.mark.parametrize("kind", ["i32", "f32", "u32", "i8", "u64", "f64"])
def test_every_op_matches_reference(rng, kind, layout):
    v = _values(rng, kind)
    o = _order(rng, kind)
    p = rng.integers(0, 5, N).astype(np.int32)
    if layout == "partitions":
        kw = dict(partition_by=p, order_by=o)
    elif layout == "one":
        kw = dict(order_by=o)
    elif layout == "desc":
        kw = dict(partition_by=p, order_by=o, descending=True)
    else:
        kw = dict(partition_by=[p, rng.integers(0, 2, N).astype(np.uint8)],
                  order_by=[o, rng.integers(0, 3, N).astype(np.int16)],
                  descending=[False, True])
    ranged = layout in ("partitions", "one")
    specs, want, got = _both_windows(lambda x: _specs(x, ranged), v, **kw)
    check_outputs(specs, want, got, v)


def test_no_order_by_and_single_spec(rng):
    """No order_by: every row ranks 1, ties keep input order; a single spec
    returns one tensor."""
    v = _values(rng, "i32")
    p = rng.integers(0, 4, N).astype(np.int32)
    specs, want, got = _both_windows(lambda x: ["rank", ("cumsum", x), ("lead", x)], v,
                                     partition_by=p)
    check_outputs(specs, want, got, v)
    jv, tv = both(v)
    assert_same(jw.window(("lag", jv, 1), partition_by=both(p)[0]),
                tw.window(("lag", tv, 1), partition_by=both(p)[1]))


@pytest.mark.parametrize("case", ["unbounded_peers", "u8_saturating", "dates", "timestamps"])
def test_range_frames_match_reference(rng, case):
    """The RANGE cases of tests/test_window.py against the reference: the
    peers of the current row fall in its frame, UNBOUNDED sides, unsigned
    bounds saturating at 0 and at the dtype's max, INTERVAL deltas on date
    (int32 days) and timestamp (int64 microseconds) order columns."""
    p = rng.integers(0, 6, N).astype(np.int32)
    v = rng.integers(-50, 50, N).astype(np.int32)
    if case == "unbounded_peers":
        o = rng.integers(0, 90, N).astype(np.int32)
        frames = [(None, 0), (0, None), (None, None), (7, 3)]
    elif case == "u8_saturating":
        o = rng.choice(np.array([0, 1, 5, 128, 250, 254, 255], np.uint8), N)
        frames = [(10, 10), (255, 0), (0, 255), (3, None)]
    elif case == "dates":
        o = rng.integers(19_000, 19_060, N).astype(np.int32)
        frames = [(("interval", 7, 0), 0), (("interval", 1, 0), ("interval", 30, 0))]
    else:
        o = (rng.integers(0, 40, N) * 1_500_000).astype(np.int64) + 1_700_000_000_000_000
        frames = [(("interval", 0, 5_000_000), 0), (("interval", 1, 0), None)]

    def specs_of(x):
        out = []
        for a, b in frames:
            out += [("range_sum", x, a, b), ("range_min", x, a, b), ("range_max", x, a, b),
                    ("range_mean", x, a, b), ("range_count", a, b)]
        return out

    specs, want, got = _both_windows(specs_of, v, partition_by=p, order_by=o)
    check_outputs(specs, want, got, v)


def test_empty_input_and_errors():
    e = torch.zeros((0,), dtype=torch.int32)
    outs = tw.window(["row_number", ("sum", e.to(torch.float32)), ("mean", e)], partition_by=e)
    assert [o.dtype for o in outs] == [torch.int32, torch.float32, torch.float32]
    x = torch.arange(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one order_by"):
        tw.window(("range_sum", x, 1, 0), order_by=[x, x])
    with pytest.raises(ValueError, match="ascending"):
        tw.window(("range_sum", x, 1, 0), order_by=x, descending=True)
    with pytest.raises(ValueError, match="numeric value deltas"):
        tw.window(("range_sum", x, -1, 0), order_by=x)
    with pytest.raises(ValueError, match="fractional"):
        tw.window(("range_sum", x, 1.5, 0), order_by=x)
    with pytest.raises(ValueError, match="op must be"):
        tw.window("median", order_by=x)
    with pytest.raises(ValueError, match="equal length"):
        tw.window(("sum", x), partition_by=x[:3])


def test_floor_log2_is_exact():
    x = torch.tensor([1, 2, 3, 4, 7, 8, 1023, 1024, 2**30, 2**31 - 1], dtype=torch.int32)
    want = [0, 1, 1, 2, 2, 3, 9, 10, 30, 30]
    assert tw._floor_log2(x).tolist() == want
