"""Distributed ASOF join over the slots of a mesh.

Counterpart of ``radix_sort_tpu/parallel/dist_asof.py``: the MPP form of
:func:`radix_sort_tpu_torch.join_asof` (nearest-key join), built from the
exchange machinery of the other distributed operators:

  1. **Union sort**: each slot's left (query) and right (data) rows form
     one tagged union relation, sorted globally and stably by (key limbs,
     origin tag) with the composite position-tiebroken splitters of
     :mod:`.dist_sort` (balanced for any key distribution). The tag puts
     data before equal queries for backward matches and after them for
     forward ones, the single-device merge-rank layout. Query and data
     positions and the data values ride the exchange.
  2. **Local fill and carry**: within a slot a query's backward candidate
     is the last data row at or before it and its forward candidate the
     first one at or after it; a query whose candidate lies on another
     slot takes the carry. Each slot publishes its last and first data row
     (an all-gather of a few scalars) and the nearest non-empty
     predecessor / successor slot resolves on the host.
  3. **Route home**: per-query results go back to the query's home slot
     by global position (``dist_sort._route_home``), row-aligned with
     ``left_keys``.

The provisioned exchange capacity makes overflow impossible; when the
``capacity=`` override forces one, the replicated single-device join runs
instead (a host branch on the exchange's flag, ``lax.cond`` in the
reference), so the result is always exact.
"""

from __future__ import annotations

import torch

from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops import query as Q
from radix_sort_tpu_torch.ops import relational as R
from radix_sort_tpu_torch.parallel import collectives as C
from radix_sort_tpu_torch.parallel import dist_sort
from radix_sort_tpu_torch.parallel.runtime import Sharded, gather_rows, local_blocks, shard_rows

__all__ = ["distributed_join_asof"]

_U32 = 0xFFFFFFFF

# whether the last distributed_join_asof call took the replicated path (a
# Python bool; test and debug introspection, as dist_window's)
_last_fallback = None


def _global(mesh, x):
    return gather_rows(x) if isinstance(x, Sharded) else x.to(mesh.home)


def distributed_join_asof(left_keys, right_keys, right_values, mesh, *,
                          direction: str = "backward", tolerance=None, fill=0,
                          capacity: int | None = None):
    """Nearest-key join over sharded sides (:class:`~.runtime.Sharded`
    columns on ``mesh``, or global tensors, sharded first); the semantics
    of :func:`radix_sort_tpu_torch.join_asof` (backward / forward /
    nearest, optional ``tolerance``, the latest tie backward).

    Returns ``(values, matched, right_pos)`` sharded like ``left_keys`` and
    row-aligned with it: ``values[i]`` the matched row's ``right_values``
    entry (``fill`` where unmatched), ``right_pos`` the matched row's
    global index into ``right_keys`` (int32, -1 where unmatched).
    ``capacity`` overrides the provisioned union-exchange bound (a test
    knob: an overflow takes the exact replicated join)."""
    global _last_fallback
    if direction not in R.ASOF_DIRECTIONS:
        raise ValueError(f"direction must be one of {R.ASOF_DIRECTIONS}, got {direction!r}")
    if left_keys.dtype != right_keys.dtype:
        raise ValueError("left and right keys must share a dtype")
    if right_values.shape[0] != right_keys.shape[0]:
        raise ValueError("right keys/values length mismatch")
    if isinstance(tolerance, (int, float)) and tolerance < 0:
        raise ValueError(f"tolerance must be >= 0, got {tolerance}")
    kdt = left_keys.dtype
    if (direction == "nearest" or tolerance is not None) and K.num_limbs(kdt) != 1:
        raise ValueError("nearest/tolerance need arithmetic key distances — supported "
                         f"for <=32-bit keys, got {kdt}")
    P = mesh.size
    n_l, n_r = left_keys.shape[0], right_keys.shape[0]
    vdt = right_values.dtype
    kw = dict(direction=direction, tolerance=tolerance, fill=fill)

    def replicated():
        global _last_fallback
        _last_fallback = True
        out = R.join_asof(_global(mesh, left_keys), _global(mesh, right_keys),
                          _global(mesh, right_values), **kw)
        return tuple(shard_rows(mesh, x) for x in out)

    if P == 1 or n_l == 0 or n_r == 0:
        return replicated()
    if n_l % P or n_r % P:
        raise ValueError(f"row counts ({n_l}, {n_r}) must divide the mesh size ({P})")
    if max(n_l, n_r) >= 2**31:
        raise ValueError("distributed_join_asof supports < 2**31 rows")
    nl_local, nr_local = n_l // P, n_r // P
    cap1 = capacity if capacity is not None else dist_sort.exchange_capacity(
        nl_local + nr_local, P)
    # backward / nearest: data sorts before equal queries (tag 0 < 1);
    # forward: queries first
    data_tag = 0 if direction != "forward" else 1
    query_tag = 1 - data_tag
    lb, rb, vb = (local_blocks(mesh, x) for x in (left_keys, right_keys, right_values))
    key_ops, val_ops = [], []
    for j, r in enumerate(mesh.local):
        dev = mesh.devices[j]
        lw, rw = K.encode_limbs(lb[j]), K.encode_limbs(rb[j].to(dev))
        tag = torch.cat([torch.full((nl_local,), query_tag, dtype=torch.int32, device=dev),
                         torch.full((nr_local,), data_tag, dtype=torch.int32, device=dev)])
        qpos = torch.cat([r * nl_local + torch.arange(nl_local, dtype=torch.int32, device=dev),
                          torch.zeros((nr_local,), dtype=torch.int32, device=dev)])
        rpos = torch.cat([torch.zeros((nl_local,), dtype=torch.int32, device=dev),
                          r * nr_local + torch.arange(nr_local, dtype=torch.int32, device=dev)])
        v = Q._signed(vb[j].to(dev))
        vals = torch.cat([v.new_zeros((nl_local,)), v])
        key_ops.append([torch.cat([a, b]) for a, b in zip(lw, rw)] + [tag])
        val_ops.append([qpos, rpos, vals])
    nk = len(key_ops[0]) - 1
    ow, ov, counts, overflow = dist_sort._local_exchange(
        mesh, key_ops, val_ops, cap1, torch.iinfo(torch.int32).max)
    if overflow:
        return replicated()

    # ---- per slot: candidates within the slot, and its boundary data rows ----
    loc, summ, skw = [], [], []
    home = mesh.home
    for j, r in enumerate(mesh.local):
        cnt = counts[r]
        sk = [w[:cnt] for w in ow[j][:nk]]
        stag = ow[j][nk][:cnt]
        qpos_s, rpos_s, val_s = (x[:cnt] for x in ov[j])
        is_d = stag == data_tag
        is_q = ~is_d
        nd = torch.cumsum(is_d, 0, dtype=torch.int64)  # data rows in [0, i]
        dpos = torch.nonzero(is_d).squeeze(1)
        n_data = dpos.shape[0]
        has_b = nd > 0
        bi = dpos[(nd - 1).clamp(min=0, max=max(n_data - 1, 0))] if n_data else nd
        before = nd - is_d.to(torch.int64)  # data rows in [0, i)
        has_f = before < n_data
        fi = dpos[before.clamp(max=max(n_data - 1, 0))] if n_data else nd
        loc.append((sk, is_q, qpos_s, rpos_s, val_s, has_b, bi, has_f, fi))
        if n_data:
            li, f0 = dpos[-1], dpos[0]
            summ.append(torch.stack([torch.ones((), dtype=torch.int64, device=sk[0].device),
                                     rpos_s[li].to(torch.int64), rpos_s[f0].to(torch.int64),
                                     sk[0][li].to(torch.int64), sk[0][f0].to(torch.int64)]))
            skw.append(torch.stack([val_s[li], val_s[f0]]))
        else:
            summ.append(torch.zeros((5,), dtype=torch.int64, device=home))
            skw.append(torch.zeros((2,), dtype=val_s.dtype, device=home))
    g = C.all_gather(mesh, summ).reshape(P, 5).cpu().tolist()
    gval = C.all_gather(mesh, skw).reshape(P, 2).cpu()
    g_has = [row[0] > 0 for row in g]
    is_float = kdt.is_floating_point
    fill_v = Q._signed(R._full(1, fill, vdt, home))

    results, qpos_home = [], []
    for j, r in enumerate(mesh.local):
        sk, is_q, qpos_s, rpos_s, val_s, has_b, bi, has_f, fi = loc[j]
        dev = is_q.device
        # the nearest non-empty predecessor / successor slot carries
        prev = max([s for s in range(r) if g_has[s]], default=None)
        nxt = min([s for s in range(r + 1, P) if g_has[s]], default=None)

        def carried(s, col, kcol, vcol):
            if s is None:
                return False, 0, 0, torch.zeros((), dtype=val_s.dtype)
            return True, g[s][col], g[s][kcol], gval[s, vcol]

        cb_ok, cb_pos, cb_kw, cb_val = carried(prev, 1, 3, 0)
        cf_ok, cf_pos, cf_kw, cf_val = carried(nxt, 2, 4, 1)
        qw = sk[0]
        m_b = has_b | cb_ok
        m_f = has_f | cf_ok
        val_b = torch.where(has_b, val_s[bi], cb_val.to(dev))
        val_f = torch.where(has_f, val_s[fi], cf_val.to(dev))
        rp_b = torch.where(has_b, rpos_s[bi], cb_pos)
        rp_f = torch.where(has_f, rpos_s[fi], cf_pos)
        kw_b = torch.where(has_b, qw[bi], torch.tensor(cb_kw, dtype=qw.dtype, device=dev))
        kw_f = torch.where(has_f, qw[fi], torch.tensor(cf_kw, dtype=qw.dtype, device=dev))

        def dist(kwd, back):
            if is_float:
                q, k = K.decode_limbs([qw], kdt), K.decode_limbs([kwd], kdt)
                return (q - k if back else k - q).abs()
            q, k = qw.to(torch.int64), kwd.to(torch.int64)
            return (q - k if back else k - q) & _U32

        if direction == "backward":
            m, val, rp, picked_back = m_b, val_b, rp_b, torch.ones_like(is_q)
            kwd = kw_b
        elif direction == "forward":
            m, val, rp, picked_back = m_f, val_f, rp_f, torch.zeros_like(is_q)
            kwd = kw_f
        else:  # nearest: the closer matched candidate; ties go backward
            use_f = m_f & (~m_b | (dist(kw_f, False) < dist(kw_b, True)))
            m = m_b | m_f
            val = torch.where(use_f, val_f, val_b)
            rp = torch.where(use_f, rp_f, rp_b)
            kwd = torch.where(use_f, kw_f, kw_b)
            picked_back = ~use_f
        if tolerance is not None:
            d = torch.where(picked_back, dist(kwd, True), dist(kwd, False))
            if is_float:
                tol = torch.tensor(tolerance, dtype=kdt, device=dev)
            else:  # the reference's cast to uint32
                tol = (min(int(tolerance), _U32) if isinstance(tolerance, float)
                       else int(tolerance) & _U32)
            m = m & (d <= tol)
        # only query rows go home: every home slot receives its nl_local rows
        hit = m[is_q]
        results.append([torch.where(hit, val[is_q], fill_v.to(dev)).view(vdt), hit,
                        torch.where(hit, rp[is_q], -1).to(torch.int32)])
        qpos_home.append(qpos_s[is_q])
    home_cols = dist_sort._route_home(mesh, qpos_home, results, nl_local)
    _last_fallback = False
    return tuple(Sharded(mesh, [hc[k] for hc in home_cols]) for k in range(3))
