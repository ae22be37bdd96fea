"""Port: the examples (radix_sort_tpu_torch/examples), on the CPU.

Each example's builder runs on the same seeded numpy inputs as the JAX
example's builder (under ``jax.jit``, as the JAX examples run), and both are
held to the numpy oracles of ``tests/test_examples.py``: counts, keys and
integer sums bit for bit. The DistTable pipeline runs on 4 CPU slots
(``runtime.data_mesh(4, device="cpu")``) against the JAX one on
``Mesh(jax.devices()[:4])``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from radix_sort_tpu_torch.examples import dist_table_demo, query_demo, table_demo  # noqa: E402
from radix_sort_tpu_torch.parallel import runtime  # noqa: E402


def _t(a):
    """A uint32 numpy array as a uint32 tensor on the CPU."""
    return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)


def _np(x, num=None):
    """A tensor (or JAX array) as int64 numpy, cut to ``num`` rows."""
    if torch.is_tensor(x):
        x = (x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) if x.dtype == torch.uint32 \
            else x.to(torch.int64)
        x = x.numpy()
    x = np.asarray(x).astype(np.int64)
    return x if num is None else x[:num]


def test_query_demo_matches_reference_and_oracle(rng):
    from examples.query_demo import build_query as jbuild

    n, n_accounts = 20_000, 256
    t_keys = rng.integers(0, n_accounts, n).astype(np.uint32)
    t_amounts = rng.integers(0, 1 << 16, n).astype(np.uint32)
    a_keys = np.arange(n_accounts, dtype=np.uint32)
    a_tier = rng.integers(0, 3, n_accounts).astype(np.uint32)
    thr = 1 << 14

    uk, sums, n_groups, ovf = query_demo.build_query(n_accounts, join_capacity=n + 128)(
        _t(t_keys), _t(t_amounts), _t(a_keys), _t(a_tier), thr)
    assert not bool(ovf)
    n_groups = int(n_groups)
    juk, jsums, jn, jovf = jbuild(n_accounts, join_capacity=n + 128)(
        jnp.asarray(t_keys), jnp.asarray(t_amounts), jnp.asarray(a_keys),
        jnp.asarray(a_tier), jnp.asarray(np.uint32(thr)))
    assert n_groups == int(jn) and not bool(jovf)
    np.testing.assert_array_equal(_np(uk, n_groups), _np(juk, n_groups))
    np.testing.assert_array_equal(_np(sums, n_groups) & 0xFFFFFFFF,
                                  _np(jsums, n_groups) & 0xFFFFFFFF)

    # the oracle of tests/test_examples.py
    keep = t_amounts > thr
    tk, ta = t_keys[keep], t_amounts[keep]
    good = set(a_keys[a_tier == 1].tolist())
    mask = np.isin(tk, list(good))
    tk, ta = tk[mask], ta[mask]
    ref_keys = np.unique(tk)
    ref_sums = np.array([ta[tk == k].sum(dtype=np.uint32) for k in ref_keys])
    assert n_groups == len(ref_keys)
    np.testing.assert_array_equal(_np(uk, n_groups), ref_keys)
    np.testing.assert_array_equal(_np(sums, n_groups) & 0xFFFFFFFF, ref_sums)


def test_table_demo_matches_reference_and_oracle(rng):
    from examples.table_demo import build_pipeline as jbuild

    n, n_q, n_sym = 10_000, 640, 32
    sym = rng.integers(0, n_sym, n).astype(np.uint32)
    qty = rng.integers(1, 500, n).astype(np.uint32)
    ts = np.sort(rng.integers(0, 1 << 30, n).astype(np.uint32))
    q_ts = rng.integers(0, 1 << 30, n_q).astype(np.uint32)
    q_px = rng.integers(90, 110, n_q).astype(np.uint32)
    cols = (sym, qty, ts, q_ts, q_px)

    s, cnt, notional, num = table_demo.build_pipeline(min_qty=250)(*map(_t, cols))
    num = int(num)
    js, jcnt, jnot, jnum = jbuild(min_qty=250)(*map(jnp.asarray, cols))
    assert num == int(jnum)
    got = sorted(zip(_np(s, num).tolist(), _np(cnt, num).tolist(), _np(notional, num).tolist()))
    want = sorted(zip(_np(js, num).tolist(), _np(jcnt, num).tolist(), _np(jnot, num).tolist()))
    assert got == want
    np.testing.assert_array_equal(_np(notional, num), _np(jnot, num))

    # the oracle of tests/test_examples.py (backward asof; unmatched trades
    # contribute notional 0; modular uint32 sums)
    keep = qty > 250
    ks, kq, kt = sym[keep], qty[keep], ts[keep]
    order = np.argsort(q_ts, kind="stable")
    sq_ts, sq_px = q_ts[order], q_px[order]
    hi = np.searchsorted(sq_ts, kt, side="right")
    px = np.where(hi > 0, sq_px[np.clip(hi - 1, 0, None)], 0).astype(np.uint32)
    notl = (kq * px).astype(np.uint32)
    ref = [(int(u), int((ks == u).sum()), int(np.sum(notl[ks == u], dtype=np.uint32)))
           for u in np.unique(ks)]
    assert num == len(ref)
    np.testing.assert_array_equal(_np(notional, num) & 0xFFFFFFFF,
                                  sorted((r[2] for r in ref), reverse=True))
    assert got == sorted(ref)


def test_dist_table_demo_matches_reference_and_oracle(rng):
    from jax.sharding import Mesh

    from examples.dist_table_demo import build_pipeline as jbuild

    n, n_sym, min_qty = 4 * 512, 16, 100
    sym = rng.integers(0, n_sym, n).astype(np.uint32)
    qty = rng.integers(1, 1000, n).astype(np.uint32)
    ts = rng.integers(0, 1 << 30, n).astype(np.uint32)

    mesh = runtime.data_mesh(4, device="cpu")
    s, cnt, vol, peak, num = dist_table_demo.build_pipeline(mesh, min_qty, n_sym * 2)(
        _t(sym), _t(qty), _t(ts))
    num = int(num) if num is not None else s.shape[0]
    got = sorted(zip(_np(s, num).tolist(), _np(cnt, num).tolist(), _np(vol, num).tolist(),
                     _np(peak, num).tolist()))

    jmesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    js, jcnt, jvol, jpeak, jnum = jbuild(jmesh, min_qty=min_qty, max_groups=n_sym * 2)(
        jnp.asarray(sym), jnp.asarray(qty), jnp.asarray(ts))
    assert num == int(jnum)
    np.testing.assert_array_equal(_np(vol, num), _np(jvol, num))
    assert got == sorted(zip(_np(js, num).tolist(), _np(jcnt, num).tolist(),
                             _np(jvol, num).tolist(), _np(jpeak, num).tolist()))

    # the oracle of tests/test_examples.py
    keep = qty > min_qty
    ks, kq, kt = sym[keep], qty[keep], ts[keep]
    refs = []
    for u in np.unique(ks):
        g = kq[ks == u]
        order = np.argsort(kt[ks == u], kind="stable")
        refs.append((int(u), len(g), int(g.sum()), int(np.max(np.cumsum(g[order])))))
    refs.sort(key=lambda r: (-r[2],))
    assert num == len(refs)
    np.testing.assert_array_equal(_np(vol, num), [r[2] for r in refs])
    assert got == sorted(refs)


@pytest.mark.parametrize("example", [query_demo, table_demo, dist_table_demo])
def test_examples_run_on_the_cpu_and_default_to_the_gpu(capsys, example):
    example.main(["--n", "4096", "--device", "cpu"])
    out = capsys.readouterr().out
    assert " ms" in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            example.main(["--n", "4096"])
