"""Port parity: the sort slice as a whole (ops/sort.py and ops/pallas_sort.py).

The public API runs with ``implementation="pallas"`` in both packages under a
shrunken pipeline config (so small inputs take the kernel pipeline, the JAX
package's Pallas kernel in interpret mode), on the same seeded numpy
inputs; outputs must agree bit for bit.
"""

import contextlib

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
import radix_sort_tpu_torch as trst  # noqa: E402
from radix_sort_tpu import config as jcfg  # noqa: E402
from radix_sort_tpu_torch import config as tcfg  # noqa: E402
from radix_sort_tpu_torch import keys as tk  # noqa: E402
from radix_sort_tpu_torch.ops import extract, pallas_sort  # noqa: E402
from radix_sort_tpu_torch.ops._cosort import cosort  # noqa: E402

N = 1000  # one 1024-word pipeline pass of 8 chunks at chunk_elems=128
SMALL = dict(chunk_elems=128, min_pipeline_n=512)


@contextlib.contextmanager
def small_pipeline():
    with jcfg.override(**SMALL), tcfg.override(**SMALL):
        yield


def bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _keys(rng, dtype, n=N):
    dtype = np.dtype(dtype)
    raw = rng.integers(0, 256, n * dtype.itemsize, dtype=np.uint8).view(dtype).copy()
    u = raw.view(f"u{dtype.itemsize}")
    u[n // 2:] = u[: n - n // 2][rng.integers(0, 7, n - n // 2)]  # duplicates
    if dtype == np.float32:
        u[:6] = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000]
    return raw


@contextlib.contextmanager
def extract_calls():
    """Record the bucket count K of every call of the extract wrapper."""
    seen = []
    real = extract.bucket_extract

    def spy(ops, bounds, **kw):
        seen.append(kw["K"])
        return real(ops, bounds, **kw)

    extract.bucket_extract = spy
    try:
        yield seen
    finally:
        extract.bucket_extract = real


def test_sort_pairs_matches_reference(rng):
    k = _keys(rng, np.uint64)
    v = rng.random(N).astype(np.float32)
    with small_pipeline():
        jk_, jv = jrst.sort_pairs(jnp.asarray(k), jnp.asarray(v), descending=True,
                                  implementation="pallas")
        tk_, tv = trst.sort_pairs(torch.from_numpy(k), torch.from_numpy(v),
                                  descending=True, implementation="pallas")
    np.testing.assert_array_equal(bits(tk_.numpy()), bits(jk_))
    np.testing.assert_array_equal(bits(tv.numpy()), bits(jv))


def test_sort_f32_specials_matches_reference(rng):
    x = _keys(rng, np.float32)
    with small_pipeline():
        want = jrst.sort(jnp.asarray(x), implementation="pallas")
        got = trst.sort(torch.from_numpy(x), implementation="pallas")
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_argsort_matches_reference(rng):
    x = _keys(rng, np.int16)
    with small_pipeline():
        want = jrst.argsort(jnp.asarray(x), implementation="pallas")
        got = trst.argsort(torch.from_numpy(x), implementation="pallas")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sort_limbs_matches_reference(rng):
    # three key limbs (wider than 64 bits) and one payload limb
    limbs = [_keys(rng, np.uint32) for _ in range(4)]
    with small_pipeline():
        jkw, jvw = jrst.sort_limbs([jnp.asarray(w) for w in limbs[:3]],
                                   [jnp.asarray(limbs[3])], implementation="pallas")
        tkw, tvw = trst.sort_limbs([tk.encode(torch.from_numpy(w)) for w in limbs[:3]],
                                   [tk.encode(torch.from_numpy(limbs[3]))],
                                   implementation="pallas")
    for t, j in zip(tkw + tvw, list(jkw) + list(jvw)):
        np.testing.assert_array_equal(tk.decode(t, torch.uint32).numpy(), np.asarray(j))


def test_counting_sort_matches_reference(rng):
    x = _keys(rng, np.uint8)
    np.testing.assert_array_equal(trst.counting_sort(torch.from_numpy(x)).numpy(),
                                  np.asarray(jrst.counting_sort(jnp.asarray(x))))
    y = _keys(rng, np.int8)
    for desc in (False, True):
        np.testing.assert_array_equal(
            trst.sort(torch.from_numpy(y), descending=desc).numpy(),
            np.asarray(jrst.sort(jnp.asarray(y), descending=desc)))


def test_pallas_path_reaches_the_extract_wrapper(rng):
    # rounds + 1 calls per sort: one per planned round, one compaction
    x = torch.from_numpy(_keys(rng, np.uint32))
    with tcfg.override(**SMALL), extract_calls() as seen:
        trst.sort(x, implementation="pallas")
    assert seen == [2, 1]


# ---- port only


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64, np.int8,
                                   np.int16, np.int32, np.int64, np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_engines_agree(rng, dtype):
    x = torch.from_numpy(_keys(rng, dtype, 700))
    v = torch.arange(700, dtype=torch.int64)
    sdt = tk.encoded_dtype(x.dtype)
    with tcfg.override(**SMALL):
        for desc in (False, True):
            ref_k, ref_v = trst.sort_pairs(x, v, descending=desc, implementation="oracle")
            for impl in ("comparator", "pallas", "auto", "xla_argsort", "xla_rank"):
                s = trst.sort(x, descending=desc, implementation=impl)
                assert torch.equal(s.view(sdt), ref_k.view(sdt)), impl
                assert torch.equal(trst.argsort(x, descending=desc, implementation=impl),
                                   ref_v), impl
                sk, sv = trst.sort_pairs(x, v, descending=desc, implementation=impl)
                assert torch.equal(sk.view(sdt), ref_k.view(sdt)), impl
                assert torch.equal(sv, ref_v), impl


@pytest.mark.parametrize("vdtype", [torch.uint8, torch.int16, torch.float16, torch.uint32,
                                    torch.float64, torch.bool], ids=str)
def test_sort_pairs_carries_payload_bits(rng, vdtype):
    x = torch.from_numpy(_keys(rng, np.int32, 700))
    raw = torch.from_numpy(rng.integers(0, 256, 700 * 8, dtype=np.uint8))
    size = torch.empty((), dtype=vdtype).element_size()
    v = raw[: 700 * size].view(vdtype) if vdtype != torch.bool else raw[:700] > 127
    perm = torch.sort(x, stable=True).indices
    with tcfg.override(**SMALL):
        sk, sv = trst.sort_pairs(x, v, implementation="pallas")
    assert sv.dtype == vdtype
    assert torch.equal(sk, x[perm])
    assert torch.equal(sv.view(torch.uint8), v[perm].view(torch.uint8))


def test_sort_pairs_limbs_engines_agree(rng):
    n = 3000
    limbs = [torch.from_numpy(_keys(rng, np.int32, n)) for _ in range(4)]
    want = cosort(limbs, 2)
    with tcfg.override(chunk_elems=128):
        for engine in ("sample", "comparator", "auto"):
            got = pallas_sort.sort_pairs_limbs(*limbs, engine=engine)
            for g, w in zip(got, want):
                assert torch.equal(g, w), engine


def test_small_inputs_take_the_comparator(rng):
    x = torch.from_numpy(_keys(rng, np.float64, 300))
    with extract_calls() as seen:
        trst.sort(x, implementation="pallas")
    assert seen == []
    assert torch.equal(trst.sort(x, implementation="pallas").view(torch.int64),
                       trst.sort(x, implementation="oracle").view(torch.int64))


def test_cosort_wide_keys_and_rows(rng):
    words = [rng.integers(0, 3, (5, 64)).astype(np.int32) for _ in range(3)]
    words[1] = words[1].astype(np.int64) * (1 << 40)  # a 64-bit word in the middle
    pay = np.arange(5 * 64).reshape(5, 64)
    out = cosort([torch.from_numpy(w) for w in words] + [torch.from_numpy(pay)], 3, dim=1)
    for i in range(5):
        perm = np.lexsort((words[2][i], words[1][i], words[0][i]))
        np.testing.assert_array_equal(out[3][i].numpy(), pay[i][perm])


def test_implementations_and_errors():
    assert trst.IMPLEMENTATIONS == jrst.IMPLEMENTATIONS
    x = torch.zeros(4, dtype=torch.int32)
    for bad in ("xla", "bogus"):
        with pytest.raises(ValueError, match="implementation must be one of"):
            trst.sort(x, implementation=bad)
    with pytest.raises(ValueError, match="leading axis"):
        trst.sort_pairs(x, torch.zeros(3))
    with pytest.raises(ValueError, match="at least one key word"):
        trst.sort_limbs([])
    with pytest.raises(ValueError, match="int32"):
        trst.sort_limbs([x.to(torch.int64)])
    with pytest.raises(TypeError, match="uint8"):
        trst.counting_sort(x)
    with pytest.raises(TypeError, match="unsupported key dtype"):
        trst.sort(torch.zeros(4, dtype=torch.bool))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64, np.int8,
                                   np.int16, np.int32, np.int64, np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("impl", ["xla_argsort", "xla_rank"])
def test_xla_engines_match_reference(rng, impl, dtype):
    """The LSD ladder (ops/xla_radix.py) against the JAX engine of the same
    name: sort bit for bit, argsort and sort_pairs as the same stable
    permutation, in both directions (duplicates and float specials
    included)."""
    x = _keys(rng, dtype, 300)
    v = np.arange(300, dtype=np.int32)
    for desc in (False, True):
        jk = jrst.sort(jnp.asarray(x), descending=desc, implementation=impl)
        tk_ = trst.sort(torch.from_numpy(x), descending=desc, implementation=impl)
        np.testing.assert_array_equal(bits(_np(tk_)), bits(jk))
        ja = jrst.argsort(jnp.asarray(x), descending=desc, implementation=impl)
        ta = trst.argsort(torch.from_numpy(x), descending=desc, implementation=impl)
        assert ta.dtype == torch.int64
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        sk, sv = trst.sort_pairs(torch.from_numpy(x), torch.from_numpy(v), descending=desc,
                                 implementation=impl)
        np.testing.assert_array_equal(bits(_np(sk)), bits(jk))
        np.testing.assert_array_equal(sv.numpy(), np.asarray(ja))  # stable: payload = perm


def _np(t):
    sdt = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}.get(t.dtype)
    a = (t if sdt is None else t.view(sdt)).numpy()
    return a if sdt is None else a.view(str(t.dtype).replace("torch.", ""))
