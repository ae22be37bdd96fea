"""Port parity: the distributed ASOF join (parallel/dist_asof.py).

The port runs on a 4-slot CPU mesh in one process; each case feeds the
same seeded numpy arrays to the JAX package's single-device ``join_asof``
and to the port's ``distributed_join_asof`` and compares the gathered
row-aligned ``(values, matched, right_pos)`` bit for bit (integer,
float-key and tie cases alike: there is no arithmetic on values). The
``*_matches_jax_mesh`` case holds it against the JAX distributed function
on a 4-device mesh under ``jax.jit``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
from radix_sort_tpu.parallel import dist_asof as JDA  # noqa: E402
from radix_sort_tpu_torch.parallel import dist_asof as DA  # noqa: E402
from radix_sort_tpu_torch.parallel import runtime  # noqa: E402

P = 4


@pytest.fixture
def mesh():
    return runtime.data_mesh(P, device="cpu")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def check(mesh, lk, rk, rv, want=None, **kw):
    """Bit for bit against the JAX single-device join (or ``want``)."""
    if want is None:
        want = jrst.join_asof(jnp.asarray(lk), jnp.asarray(rk), jnp.asarray(rv), **kw)
    got = DA.distributed_join_asof(t(lk), t(rk), t(rv), mesh, **kw)
    assert DA._last_fallback is (kw.get("capacity") is not None)
    for g, w, name in zip(got, want, ("values", "matched", "right_pos")):
        assert isinstance(g, runtime.Sharded)
        g, w = runtime.gather_rows(g).numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_matches_single_device(rng, mesh, direction, dtype):
    lk = rng.integers(0, 10_000, P * 256).astype(dtype)
    rk = rng.integers(0, 10_000, P * 128).astype(dtype)
    rv = rng.integers(0, 1 << 30, P * 128).astype(np.uint32)
    check(mesh, lk, rk, rv, direction=direction, fill=7)


@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
def test_float_keys(rng, mesh, direction):
    lk = (rng.random(P * 128) * 100 - 50).astype(np.float32)
    rk = (rng.random(P * 64) * 100 - 50).astype(np.float32)
    check(mesh, lk, rk, np.arange(P * 64, dtype=np.int32), direction=direction)


@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
def test_duplicate_heavy_ties(rng, mesh, direction):
    """Few distinct keys: equal-key runs span slots; backward must pick the
    latest right row globally, forward the earliest."""
    lk = rng.integers(0, 4, P * 128).astype(np.uint32) * 10
    rk = rng.integers(0, 4, P * 128).astype(np.uint32) * 10
    check(mesh, lk, rk, np.arange(P * 128, dtype=np.uint32), direction=direction)


@pytest.mark.parametrize("direction", ["backward", "forward"])
def test_sparse_data_carry(rng, mesh, direction):
    """Three right rows for 1024 queries: most slots hold no data after the
    exchange and the matches resolve through the carry."""
    lk = rng.integers(0, 1 << 20, P * 256).astype(np.uint32)
    rk = np.zeros(P * 2, np.uint32)
    rk[:3] = [1 << 10, 1 << 15, 1 << 19]
    check(mesh, lk, rk, np.arange(P * 2, dtype=np.uint32), direction=direction)


@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
def test_tolerance(rng, mesh, direction):
    lk = rng.integers(0, 5_000, P * 128).astype(np.uint32)
    rk = rng.integers(0, 5_000, P * 64).astype(np.uint32)
    check(mesh, lk, rk, np.arange(P * 64, dtype=np.uint32), direction=direction, tolerance=5)


def test_float_tolerance_and_nearest(rng, mesh):
    lk = (rng.random(P * 64) * 10).astype(np.float32)
    rk = (rng.random(P * 32) * 10).astype(np.float32)
    check(mesh, lk, rk, np.arange(P * 32, dtype=np.int64), direction="nearest",
          tolerance=0.05)


@pytest.mark.parametrize("direction", ["backward", "forward"])
def test_u64_keys(rng, mesh, direction):
    lk = rng.integers(0, 1 << 62, P * 64).astype(np.uint64)
    rk = rng.integers(0, 1 << 62, P * 32).astype(np.uint64)
    check(mesh, lk, rk, np.arange(P * 32, dtype=np.uint32), direction=direction)


def test_int32_keys_across_the_sign(rng, mesh):
    """Signed keys on both sides of zero: the tags and the carried key words
    compare as the port's signed rank words."""
    lk = rng.integers(-2**31, 2**31 - 1, P * 64).astype(np.int32)
    rk = rng.integers(-2**31, 2**31 - 1, P * 64).astype(np.int32)
    for d in ("backward", "forward", "nearest"):
        check(mesh, lk, rk, np.arange(P * 64, dtype=np.int32), direction=d)


def test_forced_overflow_falls_back_exactly(rng, mesh):
    lk = rng.integers(0, 100, P * 64).astype(np.uint32)
    rk = rng.integers(0, 100, P * 64).astype(np.uint32)
    rv = np.arange(P * 64, dtype=np.uint32)
    want = jrst.join_asof(jnp.asarray(lk), jnp.asarray(rk), jnp.asarray(rv))
    check(mesh, lk, rk, rv, want=want, capacity=8)  # the union exchange overflows


def test_errors(mesh):
    u = torch.zeros(8, dtype=torch.uint32)
    with pytest.raises(ValueError, match="direction"):
        DA.distributed_join_asof(u, u, u, mesh, direction="x")
    with pytest.raises(ValueError, match="dtype"):
        DA.distributed_join_asof(u, u.view(torch.int32), u, mesh)
    with pytest.raises(ValueError, match="32-bit"):
        u64 = torch.zeros(8, dtype=torch.uint64)
        DA.distributed_join_asof(u64, u64, u, mesh, direction="nearest")
    with pytest.raises(ValueError, match="divide"):
        DA.distributed_join_asof(torch.zeros(6, dtype=torch.int32),
                                 torch.zeros(8, dtype=torch.int32), u, mesh)


def test_matches_jax_mesh(rng, mesh):
    """The port against the JAX distributed ASOF join on a 4-device mesh
    under ``jax.jit``, on the duplicate-heavy shape."""
    lk = rng.integers(0, 4, P * 128).astype(np.uint32) * 10
    rk = rng.integers(0, 4, P * 128).astype(np.uint32) * 10
    rv = np.arange(P * 128, dtype=np.uint32)
    jmesh = JMesh(np.array(jax.devices()[:P]), ("x",))
    fn = jax.jit(lambda a, b, c: JDA.distributed_join_asof(a, b, c, jmesh,
                                                           direction="nearest"))
    want = fn(jnp.asarray(lk), jnp.asarray(rk), jnp.asarray(rv))
    check(mesh, lk, rk, rv, want=want, direction="nearest")
