"""Port parity: the rest of the sort API (lexsort, sort_segments, top_k and
the 128-bit trio with keys.encode128 / decode128).

The same seeded numpy inputs go through the JAX package and the port on the
CPU; outputs must agree bit for bit. Permutations are int64 in the port
(int32 in the JAX package) and compare by value. In the port,
``implementation="pallas"`` runs under a shrunken pipeline config, so small
inputs take the sample sort and its kernel (its plain version on the CPU);
it is held to the JAX package's comparator engine, which gives the same
output as its Pallas engine (the JAX package's own tests hold them equal).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_query import F32_SPECIALS, assert_same, both, col  # noqa: E402
from test_torch_sort import extract_calls  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
import radix_sort_tpu_torch as trst  # noqa: E402
from radix_sort_tpu import keys as jk  # noqa: E402
from radix_sort_tpu_torch import config as tcfg  # noqa: E402
from radix_sort_tpu_torch import keys as tk  # noqa: E402

N = 1000
SMALL = dict(chunk_elems=128, min_pipeline_n=512)  # one 1024-word pass of 8 chunks


def dup(rng, dtype, n=N, pool=9):
    """``n`` values of ``dtype`` from a small pool (ties across columns)."""
    p = col(rng, dtype, pool)
    if np.dtype(dtype) == np.float32:
        p[:6] = F32_SPECIALS[:6]
    return p[rng.integers(0, pool, n)]


def assert_perm(j, t, what=""):
    assert t.dtype == torch.int64, what
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64), err_msg=what)


# ---------------------------------------------------------------- lexsort


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("cols", [("f32", "u16", "i64"), ("u64",), ("i8", "u8", "f64", "i32")])
def test_lexsort_matches_reference(rng, cols, descending):
    dt = {"f32": np.float32, "u16": np.uint16, "i64": np.int64, "u64": np.uint64,
          "i8": np.int8, "u8": np.uint8, "f64": np.float64, "i32": np.int32}
    columns = [dup(rng, dt[c]) for c in cols]
    jc, tc = both(columns)
    assert_perm(jrst.lexsort(jc, descending=descending),
                trst.lexsort(tc, descending=descending), f"{cols}")


def test_lexsort_three_keys_on_the_kernel_path(rng):
    """Three int32-limb keys plus the index payload through the sample sort
    (the shape chip_smoke.py's ORDER BY gives it at full size)."""
    columns = [dup(rng, np.int32, pool=40), dup(rng, np.uint32, pool=50),
               rng.integers(1, 8, N).astype(np.int32)]
    jc, tc = both(columns)
    with tcfg.override(**SMALL), extract_calls() as seen:
        t = trst.lexsort(tc, implementation="pallas")
    assert seen == [2, 1]  # one planned round and the compaction
    assert_perm(jrst.lexsort(jc), t, "pallas")
    want = np.lexsort(columns[::-1])  # numpy takes the primary key last
    np.testing.assert_array_equal(t.numpy(), want)


def test_lexsort_rejects_bad_input():
    with pytest.raises(ValueError, match="at least one"):
        trst.lexsort([])
    with pytest.raises(ValueError, match="equal length"):
        trst.lexsort([torch.arange(3), torch.arange(4)])


# ---------------------------------------------------------------- sort_segments


@pytest.mark.parametrize("case", ["mixed", "empty_segments", "one_segment", "f32_desc"])
def test_sort_segments_matches_reference(rng, case):
    n = 300
    dtype = np.float32 if case == "f32_desc" else np.int16
    keys = dup(rng, dtype, n, pool=30)
    if case == "one_segment":
        offsets = np.array([0, n], np.int32)
    else:
        cuts = np.sort(rng.integers(0, n + 1, 12))
        if case == "empty_segments":
            cuts[3:6] = cuts[3]  # three empty segments in a row
        offsets = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    values = [col(rng, np.uint32, n), col(rng, np.float64, n)]
    (jkey, tkey), (jo, to), (jv, tv) = both(keys), both(offsets), both(values)
    desc = case == "f32_desc"
    j = jrst.sort_segments(jkey, jo, jv, descending=desc)
    t = trst.sort_segments(tkey, to, tv, descending=desc)
    assert_same(j, t, case)


def test_sort_segments_u64_keys_and_empty_input(rng):
    keys = dup(rng, np.uint64, 200, pool=20)
    offsets = np.array([0, 0, 50, 120, 120, 200], np.int32)
    (jkey, tkey), (jo, to) = both(keys), both(offsets)
    assert_same(jrst.sort_segments(jkey, jo, descending=True),
                trst.sort_segments(tkey, to, descending=True), "u64")
    k, v = trst.sort_segments(torch.zeros(0, dtype=torch.int32),
                              torch.tensor([0, 0], dtype=torch.int32))
    assert k.shape == (0,) and v == []
    with pytest.raises(ValueError, match="keys length"):
        trst.sort_segments(torch.arange(4), torch.tensor([0, 4]), [torch.arange(3)])


# ---------------------------------------------------------------- top_k


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("kind", ["f32_ties", "u64", "i8", "composite"])
def test_top_k_matches_reference(rng, kind, largest):
    n = 400
    if kind == "composite":
        keys = [dup(rng, np.float64, n, pool=5), dup(rng, np.int32, n, pool=4)]
    else:
        dtype = {"f32_ties": np.float32, "u64": np.uint64, "i8": np.int8}[kind]
        keys = dup(rng, dtype, n, pool=12)  # many ties: input order decides
    payload = [np.arange(n, dtype=np.int32), col(rng, np.uint16, n)]
    (jkey, tkey), (jp, tp) = both(keys), both(payload)
    for k in (0, 1, 37, n):
        j = jrst.top_k(jkey, k, *jp, largest=largest)
        t = trst.top_k(tkey, k, *tp, largest=largest)
        assert_same(j, t, f"{kind} k={k}")


def test_top_k_tie_order_is_input_order():
    keys = torch.tensor([5, 1, 5, 9, 5, 1], dtype=torch.int32)
    top, pos = trst.top_k(keys, 4, torch.arange(6))
    assert top.tolist() == [9, 5, 5, 5] and pos.tolist() == [3, 0, 2, 4]
    low, pos = trst.top_k(keys, 3, torch.arange(6), largest=False)
    assert low.tolist() == [1, 1, 5] and pos.tolist() == [1, 5, 0]
    with pytest.raises(ValueError, match="k must be"):
        trst.top_k(keys, 7)
    with pytest.raises(ValueError, match="keys length"):
        trst.top_k(keys, 2, torch.arange(5))


# ---------------------------------------------------------------- 128-bit keys


@pytest.mark.parametrize("signed", [False, True])
def test_encode128_matches_reference(rng, signed):
    hi = col(rng, np.int64 if signed else np.uint64, 500)
    hi[:4] = np.array([0, -1, np.iinfo(hi.dtype).min, np.iinfo(hi.dtype).max], hi.dtype) \
        if signed else np.array([0, 1, 2**63, 2**64 - 1], np.uint64)
    lo = col(rng, np.uint64, 500)
    (jh, th), (jl, tl) = both(hi), both(lo)
    jw = jk.encode128(jh, jl, signed=signed)
    tw = tk.encode128(th, tl, signed=signed)
    for j, t in zip(jw, tw):  # the port's limb = the reference's with the sign bit flipped
        np.testing.assert_array_equal((t.numpy().view(np.uint32) ^ np.uint32(1 << 31)),
                                      np.asarray(j))
    assert_same(jk.decode128(jw, signed=signed), tk.decode128(tw, signed=signed), "decode")
    assert_same((jh, jl), tk.decode128(tw, signed=signed), "round trip")


def _keys128(rng, signed, n=N):
    hi = dup(rng, np.int64 if signed else np.uint64, n, pool=6)  # ties in the high word
    lo = dup(rng, np.uint64, n, pool=40)
    return hi, lo


@pytest.mark.parametrize("signed", [False, True])
def test_sort128_family_matches_reference(rng, signed):
    hi, lo = _keys128(rng, signed)
    vals = col(rng, np.uint32, N)
    (jh, th), (jl, tl), (jv, tv) = both(hi), both(lo), both(vals)
    assert_same(jrst.sort128(jh, jl, signed=signed), trst.sort128(th, tl, signed=signed),
                "sort128")
    assert_perm(jrst.argsort128(jh, jl, signed=signed), trst.argsort128(th, tl, signed=signed),
                "argsort128")
    assert_same(jrst.sort_pairs128(jh, jl, jv, signed=signed),
                trst.sort_pairs128(th, tl, tv, signed=signed), "sort_pairs128")


def test_sort_pairs128_on_the_kernel_path(rng):
    """Four key limbs and a uint32 payload through the sample sort (chip_smoke.py's O2)."""
    hi, lo = _keys128(rng, False)
    vals = np.arange(N, dtype=np.uint32)
    (jh, th), (jl, tl), (jv, tv) = both(hi), both(lo), both(vals)
    with tcfg.override(**SMALL), extract_calls() as seen:
        t = trst.sort_pairs128(th, tl, tv, implementation="pallas")
        ta = trst.argsort128(th, tl, implementation="pallas")
    assert seen == [2, 1, 2, 1]
    assert_same(jrst.sort_pairs128(jh, jl, jv), t, "pallas")
    np.testing.assert_array_equal(ta.numpy(), t[1].numpy().astype(np.int64))


def test_128bit_typed_errors():
    u = torch.zeros(3, dtype=torch.uint64)
    i = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError, match="int64 hi"):
        tk.encode128(u, u, signed=True)
    with pytest.raises(TypeError, match="uint64 hi"):
        tk.encode128(i, u)
    with pytest.raises(TypeError, match="lo must be uint64"):
        tk.encode128(u, i)
    with pytest.raises(TypeError, match="uint32 words"):
        trst.sort_pairs128(u, u, torch.zeros(3, dtype=torch.int32))
