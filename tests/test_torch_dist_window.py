"""Port parity: the distributed window functions (parallel/dist_window.py).

The port's mesh is 4 CPU slots in one process (``runtime.data_mesh(4,
device="cpu")``). Each case feeds the same seeded numpy columns to the JAX
package's single-device ``window`` and to the port's
``distributed_window``, and compares the gathered row-aligned results:
integers, ranks, counts and lags bit for bit; float sums and means (sum,
mean, cumsum, rolling and range sums and means) within 2e-5 relative and
absolute (the summation order differs: the parity rule allows ULP(sum)
per frame, and these sums of at most a few thousand N(0, 1) or small
integer values stay far inside it). The partition shapes exercise the
carry chains: many small partitions, a few giant ones spanning slots,
one global partition, tie runs spanning slots. ``_last_fallback`` says
which path ran. The ``*_matches_jax_mesh`` case holds the port against
the JAX distributed function on a 4-device mesh under ``jax.jit``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
from radix_sort_tpu.parallel import dist_window as JDW  # noqa: E402
from radix_sort_tpu_torch.parallel import dist_sort, runtime  # noqa: E402
from radix_sort_tpu_torch.parallel import dist_window as DW  # noqa: E402

P = 4
N = P * 256
ALL_OPS = ["row_number", "rank", "dense_rank", "count", "percent_rank", "cume_dist"]
VALUE_OPS = ["sum", "min", "max", "mean", "cumsum", "cummin", "cummax", "first_value",
             "last_value"]
FLOAT_SUMS = ("sum", "mean", "cumsum", "rolling_mean", "rolling_sum", "range_sum",
              "range_mean")


@pytest.fixture
def mesh():
    return runtime.data_mesh(P, device="cpu")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def specs_for(v):
    """Every op family, as the reference's test builds them over ``v``."""
    return (ALL_OPS + [("ntile", 5), ("rolling_count", 3, 2)]
            + [(nm, v) for nm in VALUE_OPS]
            + [("rolling_sum", v, 4, 2), ("rolling_min", v, 3), ("rolling_max", v, 0, 3),
               ("rolling_mean", v, 5), ("lag", v, 2, 7), ("lead", v, 3), ("lag", v, 1),
               ("nth_value", v, 4, 9), ("nth_value", v, 1)])


def cols(x, conv):
    if x is None:
        return None
    return [conv(c) for c in x] if isinstance(x, list) else conv(x)


def compare(specs, got, want):
    for spec, g, w in zip(specs, got, want):
        nm = spec if isinstance(spec, str) else spec[0]
        g = runtime.gather_rows(g).numpy() if isinstance(g, runtime.Sharded) else g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype, (nm, g.dtype, w.dtype)
        if nm in FLOAT_SUMS and w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=nm)
        else:
            np.testing.assert_array_equal(g, w, err_msg=nm)


def run(mesh, specs_of, part, order, vals, descending=None, **kw):
    """The port on the mesh and the JAX single-device op on the same data;
    returns whether the port took its replicated path."""
    got = DW.distributed_window(specs_of(t(vals)), partition_by=cols(part, t),
                                order_by=cols(order, t), descending=descending, mesh=mesh, **kw)
    jspecs = specs_of(jnp.asarray(vals))
    want = jrst.window(jspecs, partition_by=cols(part, jnp.asarray),
                       order_by=cols(order, jnp.asarray), descending=descending)
    single = isinstance(jspecs, (str, tuple))
    compare([jspecs] if single else jspecs, [got] if single else got,
            [want] if single else want)
    return DW._last_fallback


def case(name, rng):
    r = rng.integers
    n = N
    if name == "many_small_partitions":
        return (r(0, 97, n).astype(np.int32), r(0, 11, n).astype(np.uint32),
                r(-50, 50, n).astype(np.int32))
    if name == "giant_partitions_span_shards":
        return (r(0, 3, n).astype(np.uint8), r(0, 5, n).astype(np.int16),
                r(0, 1000, n).astype(np.uint32))
    if name == "single_global_partition":
        return np.zeros(n, np.int32), r(0, 7, n).astype(np.uint32), r(-9, 9, n).astype(np.int64)
    if name == "all_rows_tie_everywhere":
        return np.zeros(n, np.int32), np.full(n, 42, np.uint32), r(0, 100, n).astype(np.int32)
    if name == "float_values":
        return (r(0, 13, n).astype(np.int32), r(0, 23, n).astype(np.uint32),
                rng.standard_normal(n).astype(np.float32))
    if name == "no_order_by":
        return r(0, 29, n).astype(np.int32), None, r(-100, 100, n).astype(np.int32)
    if name == "no_partition_by":
        return None, r(0, 17, n).astype(np.uint32), r(0, 50, n).astype(np.int32)
    assert name == "multicol_partition_and_order"
    return ([r(0, 4, n).astype(np.int32), r(0, 3, n).astype(np.uint64)],
            [r(0, 4, n).astype(np.int16), rng.standard_normal(n).astype(np.float32)],
            r(0, 100, n).astype(np.int32))


CASES = ["many_small_partitions", "giant_partitions_span_shards", "single_global_partition",
         "all_rows_tie_everywhere", "float_values", "no_order_by", "no_partition_by",
         "multicol_partition_and_order"]


@pytest.mark.parametrize("name", CASES)
def test_matches_jax_window(rng, mesh, name):
    """Every op family on the sharded path, exact (floats: 2e-5)."""
    part, order, vals = case(name, rng)
    assert run(mesh, specs_for, part, order, vals) is False


def test_descending_orders(rng, mesh):
    """Per-column directions ride the exchange's complemented limbs."""
    part, order, vals = case("multicol_partition_and_order", rng)
    assert run(mesh, specs_for, part, order, vals, descending=[True, False]) is False


def test_overflow_fallback_is_exact(rng, mesh):
    """A capacity override of n_local forces the exchange to overflow; the
    replicated path returns the exact answer and says so."""
    part = rng.integers(0, 5, N).astype(np.int32)
    order = rng.integers(0, 7, N).astype(np.uint32)
    vals = rng.integers(0, 100, N).astype(np.int32)
    assert run(mesh, lambda v: ["row_number", ("cumsum", v)], part, order, vals,
               capacity=N // P) is True


def test_single_spec_returns_one_column(rng, mesh):
    part = rng.integers(0, 11, N).astype(np.int32)
    vals = rng.integers(0, 100, N).astype(np.int32)
    got = DW.distributed_window(("cummax", t(vals)), partition_by=t(part), mesh=mesh)
    assert isinstance(got, runtime.Sharded)
    assert run(mesh, lambda v: ("cummax", v), part, None, vals) is False


def test_global_inputs_and_sharded_inputs_agree(rng, mesh):
    part = rng.integers(0, 7, N).astype(np.int32)
    vals = rng.integers(0, 100, N).astype(np.int32)
    a = DW.distributed_window(["rank", ("sum", t(vals))], partition_by=t(part), mesh=mesh)
    sp, sv = runtime.shard_rows(mesh, t(part), t(vals))
    b = DW.distributed_window(["rank", ("sum", sv)], partition_by=sp, mesh=mesh)
    for x, y in zip(a, b):
        assert torch.equal(runtime.gather_rows(x), runtime.gather_rows(y))


def test_validation(mesh):
    z = torch.zeros(N, dtype=torch.int32)
    with pytest.raises(ValueError):
        DW.distributed_window("row_number", partition_by=torch.zeros(N + 1, dtype=torch.int32),
                              mesh=mesh)
    with pytest.raises(ValueError):
        DW.distributed_window("bogus", partition_by=z, mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        DW.distributed_window("row_number", partition_by=torch.zeros(N + 2, dtype=torch.int32),
                              mesh=mesh)
    with pytest.raises(ValueError, match="ascending"):
        DW.distributed_window(("range_count", 1, 1), partition_by=z, order_by=z,
                              descending=True, mesh=mesh)


@pytest.mark.parametrize("spec", ["rolling", "lag"])
def test_frame_beyond_a_slot_falls_back_exact(rng, mesh, spec):
    """A preceding bound or lag offset beyond every slot's rows: the halo
    cannot cover it, and the exact replicated path runs."""
    part = (rng.integers(0, 3, N) if spec == "rolling" else np.zeros(N)).astype(np.int32)
    order = rng.integers(0, 1000, N).astype(np.uint32)
    vals = rng.integers(-50, 50, N).astype(np.int32)
    mk = ((lambda v: ("rolling_sum", v, N // P + 50)) if spec == "rolling"
          else (lambda v: ("lag", v, N // P + 10, -1)))
    assert run(mesh, mk, part, order, vals) is True


def test_nth_value_spans_shards(rng, mesh):
    """Giant partitions: the k-th row usually lives slots away from the rows
    it broadcasts to (the marked-word carry chains)."""
    part = rng.integers(0, 2, N).astype(np.int32)
    order = rng.integers(0, 1 << 30, N).astype(np.uint32)
    vals = rng.integers(-100, 100, N).astype(np.int32)
    assert run(mesh, lambda v: [("nth_value", v, k) for k in (1, 2, 500, N)],
               part, order, vals) is False


def test_signed_rank_words_at_the_top_bit(rng, mesh):
    """uint32 and int64 values with words at and above 2**31: the carry
    chains' min / max words and the nth_value broadcast must compare as the
    port's signed rank words order them."""
    part = rng.integers(0, 2, N).astype(np.int32)
    order = rng.integers(0, 50, N).astype(np.int32)
    u = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    u[::7] = np.uint32(2**31)
    assert run(mesh, lambda v: [(nm, v) for nm in ("min", "max", "cummin", "cummax",
                                                    "first_value", "last_value", "sum")]
               + [("nth_value", v, 300)], part, order, u) is False
    i64 = rng.integers(-2**62, 2**62, N).astype(np.int64)
    assert run(mesh, lambda v: [("min", v), ("max", v), ("cummax", v), ("nth_value", v, 7)],
               part, order, i64) is False


class TestShardedRangeFrames:
    """Bounded RANGE frames take the sharded halo path: a fixed range_halo
    of sorted neighbour rows each way and merge-rank bounds on the extended
    view; the halo-edge check sends a frame it cannot prove complete to the
    exact replicated path."""

    def test_sharded_path_many_partitions(self, rng, mesh):
        part = rng.integers(0, 64, N).astype(np.uint32)
        order = rng.integers(0, 500, N).astype(np.int32)
        vals = rng.integers(-40, 40, N).astype(np.int32)
        assert run(mesh, lambda v: [("range_sum", v, 10, 10), ("range_count", 5, 0),
                                    ("range_min", v, 25, 0), ("range_max", v, 0, 25),
                                    ("range_mean", v, 8, 8)], part, order, vals) is False

    def test_float_values_and_orders(self, rng, mesh):
        part = rng.integers(0, 16, N).astype(np.int32)
        order = (rng.random(N) * 100).astype(np.float32)
        vals = rng.standard_normal(N).astype(np.float32)
        assert run(mesh, lambda v: [("range_sum", v, 1.5, 0.5), ("range_mean", v, 2.0, 2.0),
                                    ("range_max", v, 3.0, 0.0)], part, order, vals) is False

    def test_partition_spanning_shards_exact(self, rng, mesh):
        # giant partitions crossing every slot boundary and a halo too small
        # for the frames: exact whichever path runs
        part = rng.integers(0, 3, N).astype(np.uint32)
        order = rng.integers(0, 10_000, N).astype(np.int32)
        vals = rng.integers(0, 100, N).astype(np.uint32)
        run(mesh, lambda v: [("range_sum", v, 300, 300)], part, order, vals, range_halo=8)

    def test_wide_frame_falls_back(self, rng, mesh):
        part = np.zeros(N, np.uint32)
        order = np.arange(N, dtype=np.int32)
        vals = rng.integers(0, 9, N).astype(np.int32)
        assert run(mesh, lambda v: [("range_sum", v, N, N)], part, order, vals,
                   range_halo=16) is True

    def test_partial_left_halo_exact(self, rng, monkeypatch):
        """The reference's junk-splice regression: on 2 slots the exchange
        leaves counts 15 / 17, so slot 0 holds fewer valid rows than the
        16-row halo it ships; frames crossing the boundary must still see
        every row of the neighbour's valid tail, and nothing else."""
        m2 = runtime.data_mesh(2, device="cpu")
        seen = []
        real = dist_sort._local_exchange

        def spy(*a, **kw):
            out = real(*a, **kw)
            seen.append(list(out[2]))
            return out

        monkeypatch.setattr(dist_sort, "_local_exchange", spy)
        n = 32
        order = rng.integers(0, 12, n).astype(np.int32)  # heavy duplicates
        part = np.zeros(n, np.uint32)
        vals = rng.integers(0, 20, n).astype(np.int32)
        assert run(m2, lambda v: [("range_sum", v, 2, 0), ("range_count", 3, 0)],
                   part, order, vals, range_halo=16) is False
        assert seen[0] == [15, 17]

    def test_last_fallback_not_stale(self, rng, mesh):
        part = rng.integers(0, 64, N).astype(np.uint32)
        order = rng.integers(0, 500, N).astype(np.int32)
        vals = rng.integers(0, 9, N).astype(np.int32)
        assert run(mesh, lambda v: [("range_sum", v, 5, 5)], part, order, vals) is False
        # an unbounded RANGE side replicates and must say so
        assert run(mesh, lambda v: [("range_sum", v, None, 5)], part, order, vals) is True
        # and the next sharded call reports False again
        assert run(mesh, lambda v: [("range_sum", v, 5, 5)], part, order, vals) is False

    def test_mixed_with_rolling_and_ranks(self, rng, mesh):
        part = rng.integers(0, 40, N).astype(np.uint32)
        order = rng.integers(0, 300, N).astype(np.int32)
        vals = rng.integers(-20, 20, N).astype(np.int32)
        assert run(mesh, lambda v: ["row_number", ("rolling_sum", v, 4, 2),
                                    ("range_sum", v, 12, 0), ("lag", v, 1)],
                   part, order, vals) is False


def test_matches_jax_mesh(rng, mesh):
    """The port against the JAX distributed function on a 4-device mesh
    under ``jax.jit``: the same row-aligned results (both sharded paths)."""
    part, order, vals = case("giant_partitions_span_shards", rng)
    jmesh = JMesh(np.array(jax.devices()[:P]), ("x",))

    def specs(v):
        return ["rank", "dense_rank", "count", ("cumsum", v), ("max", v), ("lag", v, 2),
                ("rolling_sum", v, 3, 1), ("nth_value", v, 3)]

    fn = jax.jit(lambda p, o, v: JDW.distributed_window(specs(v), partition_by=p, order_by=o,
                                                        mesh=jmesh))
    want = fn(jnp.asarray(part), jnp.asarray(order), jnp.asarray(vals))
    got = DW.distributed_window(specs(t(vals)), partition_by=t(part), order_by=t(order),
                                mesh=mesh)
    assert DW._last_fallback is False
    compare(specs(None), got, want)
