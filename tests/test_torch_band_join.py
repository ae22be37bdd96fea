"""Port parity: band_join (ops/query.py), the non-equi join.

The same seeded numpy inputs go through the JAX package and the port on the
CPU; every output -- values, padded tails, counts and overflow flags --
must agree bit for bit (floats by their bits). BETWEEN has two regimes (at
most one candidate per left row: a direct gather; otherwise the join's
expansion, filtered unless every candidate matches); each case states the
regime it must take and the test checks the port took it. The regression
cases of ``tests/test_band_join.py`` (inverted BETWEEN intervals, padding
flags in the equality conjunct) come back here against the reference.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402
from test_torch_query import F32_SPECIALS, assert_same, both, col  # noqa: E402

from radix_sort_tpu.ops import query as jq  # noqa: E402
from radix_sort_tpu_torch.ops import query as tq  # noqa: E402

N_L, N_R = 48, 36


def _band(rng, dtype, n):
    if dtype == "f32":
        x = (rng.integers(-20, 20, n) / 2).astype(np.float32)
        x[:len(F32_SPECIALS)] = F32_SPECIALS  # NaNs, +-0.0, +-inf by total order
        return x
    if dtype in ("u64", "i64"):
        return col(rng, np.uint64 if dtype == "u64" else np.int64, n)
    return rng.integers(-40, 40, n).astype({"i32": np.int32, "i8": np.int8}[dtype])


def _payloads(rng, n):
    """An int32 row index, an f64 column and a u32 column."""
    return [np.arange(n, dtype=np.int32), col(rng, np.float64, n), col(rng, np.uint32, n)]


def _run(lx, lv, rb, rv, *, expect_expansions=None, monkeypatch=None, **kw):
    """Both packages on the same inputs; optionally check how many times the
    port ran the join's expansion."""
    jl, tl = both(lx)
    jlv, tlv = both(lv)
    jrv, trv = both(rv)
    if isinstance(rb, tuple):
        jrb = tuple(both(c)[0] for c in rb)
        trb = tuple(both(c)[1] for c in rb)
    else:
        jrb, trb = both(rb)
    jkw, tkw = dict(kw), dict(kw)
    for side in ("left_equi", "right_equi"):
        if kw.get(side) is not None:
            jkw[side], tkw[side] = both(kw[side])
    calls = []
    if expect_expansions is not None:
        real = tq.join_expand
        monkeypatch.setattr(tq, "join_expand", lambda *a, **k: calls.append(1) or real(*a, **k))
    # the reference as one jitted program (one compile; the regimes are its
    # lax.cond branches)
    want = jax.jit(lambda: jq.band_join(jl, jlv, jrb, jrv, **jkw))()
    got = tq.band_join(tl, tlv, trb, trv, **tkw)
    assert_same(want, got, str(kw))
    if expect_expansions is not None:
        assert len(calls) == expect_expansions, calls
    return got


@pytest.mark.parametrize("equi", [False, True])
@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge"])
def test_inequality_matches_reference(rng, op, how, equi):
    lx, ry = _band(rng, "i32", N_L), _band(rng, "i32", N_R)
    extra = {}
    if equi:
        extra = dict(left_equi=[rng.integers(0, 4, N_L).astype(np.int32)],
                     right_equi=[rng.integers(0, 4, N_R).astype(np.int32)])
    _run(lx, _payloads(rng, N_L), ry, _payloads(rng, N_R), op=op, how=how,
         capacity=2048, **extra)


@pytest.mark.parametrize("dtype", ["f32", "u64", "i64", "i8"])
@pytest.mark.parametrize("op", ["le", "gt"])
def test_band_dtypes_match_reference(rng, dtype, op):
    """Rank-space comparisons: float total order (NaNs, -0.0), 64-bit keys
    as two limbs, narrow ints widened."""
    lx, ry = _band(rng, dtype, N_L), _band(rng, dtype, N_R)
    ry[:6] = lx[:6]  # ties on the band
    _run(lx, np.arange(N_L, dtype=np.int32), ry, col(rng, np.int16, N_R), op=op,
         capacity=2048, left_equi=[rng.integers(0, 3, N_L).astype(np.uint8)],
         right_equi=[rng.integers(0, 3, N_R).astype(np.uint8)])


def _intervals(rng, case, n_r):
    if case == "tiers":  # disjoint: at most one candidate per row
        lo = (np.arange(n_r) * 10).astype(np.int32)
        return rng.permutation(lo), None
    lo = rng.integers(0, 300, n_r).astype(np.int32)
    if case == "monotone":  # overlapping, hi increasing with lo: no filter
        return lo, (lo + 25).astype(np.int32)
    return lo, (lo + rng.integers(-10, 60, n_r)).astype(np.int32)  # some inverted


@pytest.mark.parametrize("equi", [False, True])
@pytest.mark.parametrize("case,expansions", [("tiers", 0), ("monotone", 1), ("random", 1)])
def test_between_regimes_match_reference(rng, monkeypatch, case, expansions, equi):
    lo, hi = _intervals(rng, case, N_R)
    if hi is None:
        hi = (lo + 9).astype(np.int32)
    lx = rng.integers(-5, 330, N_L).astype(np.int32)
    extra = {}
    if equi:
        e = rng.integers(0, 3, N_R).astype(np.int32)
        extra = dict(left_equi=[rng.integers(0, 3, N_L).astype(np.int32)], right_equi=[e])
    _run(lx, _payloads(rng, N_L), (lo, hi), _payloads(rng, N_R), op="between",
         capacity=2048, expect_expansions=expansions, monkeypatch=monkeypatch, **extra)


@pytest.mark.parametrize("trial", range(4))
def test_between_inverted_intervals(trial):
    """The reference's regression: inverted intervals push the running-max
    lower bound past the upper bound; crossed ranges clamp to empty."""
    r2 = np.random.default_rng(1000 + trial)
    lx = r2.integers(0, 60, 40).astype(np.int32)
    rlo = r2.integers(0, 60, 25).astype(np.int32)
    rhi = r2.integers(0, 60, 25).astype(np.int32)  # about half inverted
    got = _run(lx, np.arange(40, dtype=np.int32), (rlo, rhi), np.arange(25, dtype=np.int32),
               op="between", capacity=600)
    n = int(got[2])
    pairs = sorted(zip(got[0][:n].tolist(), got[1][:n].tolist()))
    assert not bool(got[3])
    assert pairs == sorted((i, j) for i in range(40) for j in range(25)
                           if rlo[j] <= lx[i] <= rhi[j])


def test_padding_flags_in_equi_conjunct(rng):
    """The reference's padding-flag collision: flag words (left padding 1,
    right padding 2, left NULL 3, right NULL 4) ride the equality conjunct
    and never match one another."""
    lf = rng.choice(np.array([0, 1, 3], np.uint32), N_L)
    rf = rng.choice(np.array([0, 2, 4], np.uint32), N_R)
    lx, ry = _band(rng, "i32", N_L), _band(rng, "i32", N_R)
    for how in ("inner", "left", "anti"):
        _run(lx, np.arange(N_L, dtype=np.int32), ry, np.arange(N_R, dtype=np.int32), op="ge",
             how=how, capacity=700, left_equi=[lf], right_equi=[rf])


@pytest.mark.parametrize("op,how", [("lt", "inner"), ("ge", "left"), ("le", "anti"),
                                    ("between", "inner")])
@pytest.mark.parametrize("side", ["left", "right"])
def test_empty_sides(rng, op, how, side):
    n_l, n_r = (0, N_R) if side == "left" else (N_L, 0)
    lx = rng.integers(0, 50, n_l).astype(np.int32)
    ry = rng.integers(0, 50, n_r).astype(np.int32)
    rb = (ry, ry + 5) if op == "between" else ry
    _run(lx, np.arange(n_l, dtype=np.int32), rb, np.arange(n_r, dtype=np.float32), op=op,
         how=how, capacity=64)


@pytest.mark.parametrize("op", ["lt", "between"])
def test_overflow(rng, op):
    lx = rng.integers(0, 40, N_L).astype(np.int32)
    ry = rng.integers(0, 40, N_R).astype(np.int32)
    rb = (ry, (ry + 30).astype(np.int32)) if op == "between" else ry
    got = _run(lx, np.arange(N_L, dtype=np.int32), rb, np.arange(N_R, dtype=np.int32), op=op,
               capacity=100)
    assert bool(got[3])


def test_rejects_bad_input():
    x = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="op must be"):
        tq.band_join(x, x, x, x, op="eq", capacity=8)
    with pytest.raises(ValueError, match="inner"):
        tq.band_join(x, x, (x, x), x, op="between", capacity=8, how="left")
    with pytest.raises(TypeError, match="dtype"):
        tq.band_join(x, x, x.to(torch.int64), x, op="lt", capacity=8)
    with pytest.raises(ValueError, match="single right band"):
        tq.band_join(x, x, (x, x), x, op="lt", capacity=8)
