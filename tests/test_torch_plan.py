"""Port parity: plan.py (LazyTable and its optimizer), on the CPU.

Each pipeline is built twice from the same seeded numpy tables, once over
the JAX package's ``Table`` and once over the port's ``Table(...,
device="cpu")``, through the same LazyTable calls. The optimized and the
unoptimized plans must print the same ``explain()`` text in both packages,
``collect()`` must give the same table as the JAX package's (column names,
dtypes, values bit for bit, NULL masks, row count) with and without
``optimize_plan``, and ``return_overflow`` must report the same flag. Float
sums and means may differ by summation order only (all summed values are
positive here): within (n - 1) * u of their value, n <= N rows a group.
The structural checks of ``tests/test_plan.py`` (which pass fired) hold
on the port's plans.
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import radix_sort_tpu.expr as JE  # noqa: E402
import radix_sort_tpu_torch.expr as TE  # noqa: E402
import radix_sort_tpu_torch.plan as TP  # noqa: E402
from radix_sort_tpu.table import Table as JTable  # noqa: E402
from radix_sort_tpu_torch.table import Table as TTable  # noqa: E402
from test_torch_table import same  # noqa: E402

N = 96
F32_SUM = (N - 1) * 2.0 ** -24


def _data(seed=2):
    rng = np.random.default_rng(seed)
    t = {
        "k": rng.integers(0, 16, N).astype(np.uint32),
        "v": rng.integers(0, 1000, N).astype(np.int32),
        "w": (rng.random(N) * 10).astype(np.float32),
        "g": rng.integers(0, 4, N).astype(np.uint32),
        "s": rng.choice(["ant", "bee", "cat", "dog"], N),
        "n": np.ma.MaskedArray(rng.integers(-5, 5, N).astype(np.int32), rng.random(N) < 0.3),
    }
    dim = {"k": np.arange(13, dtype=np.uint32), "w2": np.arange(13, dtype=np.int32) * 10,
           "v": np.arange(13, dtype=np.int32) * 100,
           "extra": rng.integers(0, 99, 13).astype(np.uint32)}
    small = {"k": np.arange(5, dtype=np.uint32), "z": np.arange(5, dtype=np.int32) - 2}
    quotes = {"v": np.sort(rng.integers(0, 1000, 24).astype(np.int32)),
              "px": rng.integers(1, 500, 24).astype(np.uint32)}
    line = {"k": rng.integers(0, 20, 120).astype(np.int32),
            "p": rng.random(120).astype(np.float32),
            "q": rng.integers(1, 9, 120).astype(np.int32)}
    right = {"k": np.repeat(np.arange(20, dtype=np.int32), 3),
             "seg": np.tile(rng.integers(0, 4, 20).astype(np.int32), 3)}
    bands = {"lo": np.array([0, 300, 600], np.int32), "hi": np.array([299, 599, 999], np.int32),
             "band": np.array([1, 2, 3], np.int32)}
    return {"t": t, "dim": dim, "small": small, "quotes": quotes, "line": line,
            "right": right, "bands": bands, "head": {c: v[:32] for c, v in t.items()}}


DATA = _data()


J = types.SimpleNamespace(col=JE.col, lit=JE.lit, where=JE.where, T=JTable)
T = types.SimpleNamespace(col=TE.col, lit=TE.lit, where=TE.where,
                          T=lambda c: TTable(c, device="cpu"))


def _lazy(m):
    return {name: m.T(cols).lazy() for name, cols in DATA.items()}


def _nodes(plan, kind):
    out, stack = [], [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, kind):
            out.append(n)
        stack.extend(c for _, c in n.children())
    return out


PIPES = {
    "filter_sort_select": lambda m, L: L["t"].filter(m.col("v") > 200).sort_by("k")
    .select("k", "v"),
    "filter_fusion": lambda m, L: L["t"].filter(m.col("v") > 100).filter(m.col("k") < 9)
    .filter(m.col("v") < 900),
    "filter_through_sort": lambda m, L: L["t"].filter(m.col("v") > 100).sort_by("k")
    .filter(m.col("v") < 900),
    "filter_below_join": lambda m, L: L["t"].join(L["dim"], ["k"], how="inner", capacity=256)
    .filter(m.col("v") > 100).filter(m.col("w2") > 20).filter(m.col("k") < 9),
    "filter_above_left_join": lambda m, L: L["t"].join(L["small"], ["k"], how="left",
                                                       capacity=256).filter(m.col("z") > 0),
    "join_suffix_pushdown": lambda m, L: L["t"].join(L["dim"], ["k"], capacity=256)
    .filter(m.col("v_r") > 500),
    "window_partition_pushdown": lambda m, L: L["t"].window(
        {"rn": "row_number", "cs": ("cumsum", "v")}, partition_by="k", order_by="v")
    .filter(m.col("k") < 7),
    "window_filter_stays": lambda m, L: L["t"].window({"rn": "row_number"}, partition_by="k",
                                                      order_by="v").filter(m.col("v") > 100),
    "filter_below_concat": lambda m, L: L["t"].concat(L["head"]).filter(m.col("v") > 100),
    "sort_fusion": lambda m, L: L["t"].sort_by("v", descending=True).sort_by("k"),
    "sort_fusion_dedup": lambda m, L: L["t"].sort_by(["k", "v"]).sort_by("k", descending=True),
    "window_fusion": lambda m, L: L["t"].window({"rn": "row_number"}, partition_by="g",
                                                order_by="v")
    .window({"s": ("sum", "v")}, partition_by="g", order_by="v"),
    "window_fusion_blocked": lambda m, L: L["t"].window({"rn": "row_number"}, partition_by="g",
                                                        order_by="v")
    .window({"s": ("sum", "rn")}, partition_by="g", order_by="v"),
    "sort_limit_topk_desc": lambda m, L: L["t"].sort_by("v", descending=True).limit(17),
    "sort_limit_topk_asc": lambda m, L: L["t"].sort_by("v").limit(17, offset=3),
    "projection_pruning": lambda m, L: L["t"].filter(m.col("v") > 100).sort_by("k")
    .select("k", "v"),
    "dead_specs_dropped": lambda m, L: L["t"].with_columns(dead=m.col("w") * 3,
                                                           live=m.col("v") + 1)
    .window({"rn": "row_number", "unused": ("sum", "v")}, partition_by="g")
    .select("k", "live", "rn"),
    "window_dropped": lambda m, L: L["t"].window({"rn": "row_number"}, partition_by="g")
    .select("k", "v"),
    "join_side_pruning": lambda m, L: L["t"].join(L["dim"], "k", capacity=256)
    .select("k", "v", "v_r"),
    "aggregate_prunes": lambda m, L: L["t"].aggregate("g", {"a": ("sum", "v"),
                                                            "b": ("max", "w"), "c": "count"})
    .select("g", "a"),
    "rename_pushdown": lambda m, L: L["t"].rename({"v": "value"}).filter(m.col("value") > 500)
    .select("k", "value"),
    "with_columns_window_aggregate": lambda m, L: L["t"].with_columns(v2=m.col("v") * 2)
    .window({"rn": "row_number", "s": ("sum", "v2")}, partition_by="g", order_by="v")
    .aggregate("g", {"tot": ("sum", "v2"), "peak": ("max", "s"), "n": "count"}),
    "set_ops": lambda m, L: L["t"].filter(m.col("v") > 600)
    .intersect(L["t"].filter(m.col("v") < 400), subset=["k"]).sort_by("k"),
    "union_difference": lambda m, L: L["t"].select("k", "g").union(L["head"].select("k", "g"))
    .difference(L["t"].filter(m.col("v") < 300).select("k", "g")).sort_by(["k", "g"]),
    "unnest": lambda m, L: L["t"].with_columns(c=m.col("k") % 3).unnest("c", total_size=2 * N),
    "distinct_topk": lambda m, L: L["t"].distinct(["k", "s"]).top_k(7, "k"),
    "join_asof": lambda m, L: L["t"].join_asof(L["quotes"], "v", direction="backward",
                                               matched_col="mt"),
    "callable_predicates": lambda m, L: L["t"].filter(lambda tb: tb["v"] > 300)
    .filter(lambda tb: tb["v"] < 800),
    "eager_join_aggregate": lambda m, L: L["line"].join(L["right"], "k", how="inner",
                                                         capacity=512)
    .aggregate(["k"], {"s": ("sum", "p"), "n": "count", "a": ("mean", "q"),
                       "mx": ("max", "p")}).sort_by("k"),
    "no_rewrite_right_agg": lambda m, L: L["line"].join(L["right"], "k", how="inner",
                                                         capacity=512)
    .aggregate(["k"], {"s": ("sum", "seg")}),
    "no_rewrite_argmax": lambda m, L: L["line"].join(L["right"], "k", how="inner",
                                                      capacity=512)
    .aggregate(["k"], {"s": ("argmax", "p")}),
    "where_groupby_fusion": lambda m, L: L["t"].filter(m.col("v") < 700)
    .aggregate(["s"], {"n": "count", "sv": ("sum", "v"), "mw": ("median", "w")}).sort_by("s"),
    "fusion_above_with_columns": lambda m, L: L["t"].with_columns(d=m.col("v") * 2)
    .filter(m.col("d") > 400).aggregate(["g"], {"n": "count"}),
    "no_fusion_when_shadowed": lambda m, L: L["t"].filter(m.col("v") > 400)
    .with_columns(v=m.col("v") * 0).aggregate(["g"], {"n": "count"}),
    "grouping_sets_where": lambda m, L: L["t"].filter(m.col("v") > 200)
    .aggregate_sets([["g", "s"], ["g"], []], {"sv": ("sum", "v"), "n": "count"}),
    "band_join": lambda m, L: L["t"].join_band(L["bands"], "v", "between", ("lo", "hi"),
                                               capacity=256).sort_by("v"),
    "cross_join": lambda m, L: L["small"].cross_join(L["bands"], capacity=64),
    "string_and_null_expressions": lambda m, L: L["t"].with_columns(
        up=m.col("s").upper(), nn=m.col("n") * 2 + 1, cs=m.where(m.col("n") > 0, m.col("s"),
                                                                  m.lit("neg")))
    .filter(m.col("up") != "BEE").sort_by("nn"),
}

FLOATS = {"eager_join_aggregate": ("s",)}


@pytest.mark.parametrize("name", list(PIPES))
def test_pipeline_matches_reference(name):
    build = PIPES[name]
    jl, tl = build(J, _lazy(J)), build(T, _lazy(T))
    assert tl.explain() == jl.explain()
    assert tl.explain(optimize_plan=False) == jl.explain(optimize_plan=False)
    kw = dict(float_cols=FLOATS.get(name, ()), rtol=F32_SUM)
    (jo, jovf), (to, tovf) = (jl.collect(return_overflow=True),
                              tl.collect(return_overflow=True))
    same(jo, to, **kw)
    assert bool(tovf) == bool(jovf)
    assert torch.is_tensor(tovf) and tovf.dtype == torch.bool
    same(jl.collect(optimize_plan=False), tl.collect(optimize_plan=False), **kw)


def _opt(name):
    return PIPES[name](T, _lazy(T)).optimized().plan


def test_optimizer_passes_fire():
    P = TP
    assert len(_nodes(_opt("filter_fusion"), P.Filter)) == 1
    (s,) = _nodes(_opt("filter_through_sort"), P.SortBy)
    assert _nodes(s, P.Filter)
    opt = _opt("filter_below_join")
    (j,) = _nodes(opt, P.Join)
    assert not isinstance(opt, P.Filter) and _nodes(j.left, P.Filter) and _nodes(j.right, P.Filter)
    assert isinstance(_opt("filter_above_left_join"), P.Filter)
    assert not isinstance(_opt("window_partition_pushdown"), P.Filter)
    assert isinstance(_opt("window_filter_stays"), P.Filter)
    assert isinstance(_opt("filter_below_concat"), P.Concat)
    (s,) = _nodes(_opt("sort_fusion"), P.SortBy)
    assert s.by == ("k", "v") and s.descending == (False, True)
    ws = _nodes(_opt("window_fusion"), P.Window)
    assert len(ws) == 1 and len(ws[0].ops) == 2
    assert len(_nodes(_opt("window_fusion_blocked"), P.Window)) == 2
    opt = _opt("sort_limit_topk_desc")
    assert len(_nodes(opt, P.TopK)) == 1 and not _nodes(opt, P.SortBy)
    src_sel = [s for s in _nodes(_opt("projection_pruning"), P.Select)
               if isinstance(s.child, P.Source)]
    assert src_sel and set(src_sel[0].names) == {"k", "v"}
    opt = _opt("dead_specs_dropped")
    (wc,) = _nodes(opt, P.WithColumns)
    assert [n for n, _ in wc.exprs] == ["live"]
    assert not _nodes(_opt("window_dropped"), P.Window)
    (j,) = _nodes(_opt("join_side_pruning"), P.Join)
    assert "extra" not in P._schema(j.right)
    (ag,) = _nodes(_opt("aggregate_prunes"), P.Aggregate)
    assert [n for n, _ in ag.aggs] == ["a"]
    (f,) = _nodes(_opt("rename_pushdown"), P.Filter)
    assert f.pred.columns == {"v"}
    joins = _nodes(_opt("eager_join_aggregate"), P.Join)
    assert [j.how for j in joins] == ["lookup"] and isinstance(joins[0].right, P.Aggregate)
    for name in ("no_rewrite_right_agg", "no_rewrite_argmax"):
        assert [j.how for j in _nodes(_opt(name), P.Join)] == ["inner"]
    for name in ("where_groupby_fusion", "fusion_above_with_columns", "grouping_sets_where"):
        ex = PIPES[name](T, _lazy(T)).explain()
        assert "; where]" in ex and "filter[" not in ex
    ex = PIPES["no_fusion_when_shadowed"](T, _lazy(T)).explain()
    assert "filter[" in ex and "; where]" not in ex


def test_lazy_matches_eager_port_table():
    L = _lazy(T)
    t = TTable(DATA["t"], device="cpu")
    lazy = L["t"].filter(TE.col("v") > 200).sort_by("k").select("k", "v").collect()
    same(lazy, t.filter(lambda tb: tb["v"] > 200).sort_by("k").select("k", "v"))
    mask = torch.from_numpy(DATA["t"]["v"] % 2 == 0)
    same(L["t"].filter(mask).collect(), t.filter(mask))


def test_overflow_flag_reported():
    for m in (J, T):
        out, ovf = _lazy(m)["t"].join(_lazy(m)["dim"], "k", capacity=8).collect(
            return_overflow=True)
        assert bool(ovf)
    out, ovf = _lazy(T)["t"].filter(TE.col("v") > 3).collect(return_overflow=True)
    assert not bool(ovf) and ovf.device == out.device


def test_expr_arguments_to_table_methods():
    """with_columns / filter / aggregate(where=) / aggregate_sets(where=)
    take an Expr in the port's Table, as in the JAX package's."""
    jt, tt = JTable(DATA["t"]), TTable(DATA["t"], device="cpu")
    for f in (
        lambda m, t: t.with_columns(x=m.col("v") * 2.5, y=m.col("s").upper(),
                                    z=m.col("n") + 1),
        lambda m, t: t.filter((m.col("v") > 300) & (m.col("n") < 2)),
        lambda m, t: t.aggregate("g", {"c": "count", "sv": ("sum", "v")},
                                 where=m.col("n") > 0),
        lambda m, t: t.aggregate_sets([["g"], []], {"c": "count"}, where=m.col("v") < 500),
    ):
        same(f(J, jt), f(T, tt))
