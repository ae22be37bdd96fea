"""Port: input distributions and timing helpers (utils/)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from radix_sort_tpu.utils import distributions as jd  # noqa: E402
from radix_sort_tpu_torch.utils import distributions as td  # noqa: E402
from radix_sort_tpu_torch.utils import timing  # noqa: E402

UINTS = [torch.uint8, torch.uint16, torch.uint32, torch.uint64]


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("dtype", UINTS, ids=str)
def test_key_uniform_covers_the_range(dtype):
    g = torch.Generator().manual_seed(1)
    x = _np(td.key_uniform(g, 20000, dtype))
    assert x.dtype == np.dtype(str(dtype).split(".")[1])
    top = np.iinfo(x.dtype).max
    # every bit is uniform: the top and bottom quarters of the range are hit
    assert (x < top // 4).mean() > 0.2 and (x > top // 4 * 3).mean() > 0.2
    assert abs(float((x & 1).mean()) - 0.5) < 0.02


@pytest.mark.parametrize("dtype", UINTS + [torch.int32], ids=str)
def test_step_uniform_takes_the_reference_values(dtype):
    npd = np.dtype(str(dtype).split(".")[1])
    g = torch.Generator().manual_seed(2)
    got = np.unique(_np(td.step_uniform(g, 5000, 5, dtype)))
    want = np.unique(np.asarray(jd.step_uniform(jax.random.PRNGKey(0), 5000, 5, npd)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64], ids=str)
def test_zipf_is_skewed_over_the_range(dtype):
    g = torch.Generator().manual_seed(3)
    x = _np(td.zipf(g, 20000, dtype, s=1.1))
    assert x.min() >= 1
    # heavy mass on small keys, with a tail reaching the top of the range
    assert np.median(x.astype(np.float64)) < 2.0**20
    assert x.astype(np.float64).max() > 2.0 ** (np.iinfo(x.dtype).bits - 8)


def test_key_uniform_limbs_are_int32_pairs():
    g = torch.Generator().manual_seed(4)
    hi, lo = td.key_uniform_limbs(g, 1000)
    assert hi.dtype == lo.dtype == torch.int32 and hi.shape == lo.shape == (1000,)
    assert not torch.equal(hi, lo)


def test_sync_returns_its_argument_on_cpu():
    tree = {"a": [torch.zeros(2), (torch.ones(1),)], "b": 3}
    assert timing.sync(tree) is tree


# ---- the rest of utils/distributions: geometric, the limb samplers, make_pairs

def _merge_rank(hi, lo):
    """int32 rank limbs -> the uint64 values they encode (numpy)."""
    u = lambda t: (t.numpy().view(np.uint32) ^ np.uint32(1 << 31)).astype(np.uint64)
    return (u(hi) << np.uint64(32)) | u(lo)


def _merge_jax(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def test_geometric_mean():
    x = _np(td.geometric(torch.Generator().manual_seed(5), 50_000, lam=0.25))
    # mean of Geometric(p) (failures before success) = (1-p)/p = 3
    assert 2.9 < x.mean() < 3.1 and x.min() == 0 and x.dtype == np.uint32


def test_geometric_clamps_to_the_dtype():
    g = torch.Generator().manual_seed(6)
    x = _np(td.geometric(g, 20_000, lam=1e-4, dtype=torch.uint8))
    assert x.max() == 255 and (x == 255).mean() > 0.9
    y = _np(td.geometric(g, 20_000, lam=1e-4, dtype=torch.uint64))
    assert y.dtype == np.uint64 and 0.95e4 < y.mean() < 1.05e4


@pytest.mark.parametrize("s", [1.0, 1.1, 1.5])
def test_zipf_limbs_match_the_reference_distribution(s):
    got = _merge_rank(*td.zipf_limbs(torch.Generator().manual_seed(7), 50_000, s=s))
    want = _merge_jax(*jd.zipf_limbs(jax.random.PRNGKey(7), 50_000, s=s))
    lg, lw = np.log2(got.astype(np.float64) + 1), np.log2(want.astype(np.float64) + 1)
    # the same law: log2 quantiles within a tenth of the 64-bit range
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        assert abs(np.quantile(lg, q) - np.quantile(lw, q)) < 1.0, q
    assert got.min() >= 1


def test_zipf_limbs_skew_and_duplicates():
    v = _merge_rank(*td.zipf_limbs(torch.Generator().manual_seed(8), 50_000, s=1.5))
    assert np.median(v) < 2**20
    small = v[v < 64]
    assert len(small) > 100 and len(np.unique(small)) < len(small) // 10


@pytest.mark.parametrize("lam", [1e-3, 1e-9, 1e-12])
def test_geometric_limbs_mean_matches_the_reference(lam):
    got = _merge_rank(*td.geometric_limbs(torch.Generator().manual_seed(9), 50_000, lam=lam))
    want = _merge_jax(*jd.geometric_limbs(jax.random.PRNGKey(9), 50_000, lam=lam))
    mg, mw = got.astype(np.float64).mean(), want.astype(np.float64).mean()
    assert abs(mg / mw - 1) < 0.05 and 0.9 < mg * lam < 1.1


@pytest.mark.parametrize("steps", [1, 17, 1000])
def test_step_uniform_limbs_take_the_reference_values(steps):
    got = np.unique(_merge_rank(*td.step_uniform_limbs(torch.Generator().manual_seed(10),
                                                       20_000, steps)))
    want = np.unique(_merge_jax(*jd.step_uniform_limbs(jax.random.PRNGKey(10), 20_000, steps)))
    np.testing.assert_array_equal(got, want)
    assert len(got) == steps


def test_key_uniform_limbs_cover_the_range():
    v = _merge_rank(*td.key_uniform_limbs(torch.Generator().manual_seed(11), 50_000))
    assert 0.45 < np.mean(v > np.uint64(2**63)) < 0.55


def test_mul32x32_is_the_reference_bit_for_bit(rng):
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 1, 0xFFFF, 0xFFFFFFFF]
    for b in (0, 1, 0xFFFFFFFF, 2**32, (2**64 - 1) // 1001, 2**64 - 1, 0x9E3779B97F4A7C15):
        hj, lj = jd._mul32x32(jax.numpy.asarray(a), b)
        ht, lt = td._mul32x32(torch.from_numpy(a.astype(np.int64)), b)
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj).astype(np.int64))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj).astype(np.int64))
        exact = (a.astype(object) * b) % 2**64
        assert [(int(h) << 32) | int(lo) for h, lo in zip(ht, lt)] == list(exact)


def test_pow2_to_limbs_places_the_mantissa_as_the_reference(rng):
    """The bits above the jitter are the reference's bit for bit wherever
    float32 ``exp2`` of the fraction agrees between the two libraries; where
    the two transcendental implementations round differently (1 ULP), the
    24-bit mantissa differs by exactly one and is placed identically."""
    y = np.concatenate([rng.random(20_000) * 64, np.arange(64), [0.0, 22.5, 23.0, 31.9, 32.0,
                                                                   32.5, 55.0, 63.999]])
    y = np.clip(y.astype(np.float32), 0, np.float32(63.999))
    hj, lj = jd._pow2_to_limbs(jax.numpy.asarray(y), jax.random.PRNGKey(0))
    ht, lt = td._pow2_to_limbs(torch.from_numpy(y), torch.Generator().manual_seed(0))
    vj = _merge_jax(hj, lj)
    vt = (ht.numpy().astype(np.uint64) << np.uint64(32)) | lt.numpy().astype(np.uint64)
    sh = np.floor(y).astype(np.int64) - 23
    jitter = np.where(sh > 0, (np.uint64(1) << np.clip(sh, 0, 63).astype(np.uint64)) - np.uint64(1),
                      np.uint64(0))
    keep = ~jitter
    f = y - np.floor(y)
    same = np.asarray(jax.numpy.exp2(jax.numpy.asarray(f))) == torch.exp2(torch.from_numpy(f)).numpy()
    assert same.mean() > 0.5
    np.testing.assert_array_equal(vt[same] & keep[same], vj[same] & keep[same])
    # elsewhere: the same placement, the mantissa one apart
    unit = np.where(sh > 0, np.uint64(1) << np.clip(sh, 0, 63).astype(np.uint64), np.uint64(1))
    d = (vt[~same] & keep[~same]).astype(object) - (vj[~same] & keep[~same]).astype(object)
    u = unit[~same].astype(object)
    assert all(abs(di) in (0, ui) or (s < 0 and abs(di) <= 1) for di, ui, s in zip(d, u, sh[~same]))
    # the jittered bits are below the mantissa only
    assert np.all((vt ^ vj) & keep == (vt ^ vj) & keep & ~jitter)


def test_make_pairs_gives_a_zero_payload():
    k = td.key_uniform(torch.Generator().manual_seed(12), 100, torch.uint32)
    keys, payload = td.make_pairs(k)
    assert keys is k and payload.dtype == k.dtype and not payload.view(torch.int32).any()


# ---- utils/profiling

def test_phase_timer_report():
    from radix_sort_tpu_torch.utils.profiling import PhaseTimer

    t = PhaseTimer()
    x = torch.arange(1024, dtype=torch.int32)
    out = t.time_fn("add", lambda a: a + 1, x, bytes_moved=x.numel() * 8)
    assert torch.equal(out, x + 1)
    with t.phase("noop"):
        pass
    rep = t.report()
    assert "add" in rep and "noop" in rep and "total" in rep and "GB/s" in rep
    assert [p[0] for p in t.phases] == ["add", "noop"]


def test_speed_of_light_is_the_cards_memory_rate():
    from radix_sort_tpu_torch.utils.profiling import HBM_GBPS, speed_of_light_s

    assert HBM_GBPS == 3350.0
    assert speed_of_light_s(2_000_000) == 2 * speed_of_light_s(1_000_000)
    assert speed_of_light_s(3_350_000_000) == pytest.approx(1e-3)


def test_trace_writes_a_chrome_trace(tmp_path):
    from radix_sort_tpu_torch.utils.profiling import PhaseTimer

    p = tmp_path / "trace.json"
    with PhaseTimer().trace(str(p)):
        torch.arange(100).sum()
    assert p.exists() and "traceEvents" in p.read_text()
