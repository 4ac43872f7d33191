"""Kernels K2 / K4 / K11 (retrieval sweeps) and the top-k epilogue against the
JAX package, on the same seeded numpy inputs.

The JAX side runs `bucket_max_scores`, `bucket_max_scores_i8` (with per-row
scales, K4, and with per-bucket scales, K11) and `pallas_topk` in interpret
mode, also at the wgmma sweep's tile edges (Q around 128, valid_n cutting
the first, a middle and the last chunk).  `sweep_route`'s table and the
kernels each route launches are checked here.  On a card the CUDA kernels
are held against their twins: the wgmma K2 / K4 / K11 at Q = 1 ... 1024 x
D = 64 ... 768 with three valid_n cuts and on a 300-chunk pool, K11 also at
D = 1152 with four cuts, the general kernels at the widths only they take,
and the search over 2500 queries through each pool; JAX is imported inside the parity tests only, so
`python -m pytest tests/test_torch_topk.py -m gpu --noconftest` runs on a
host without it.
"""

import numpy as np
import pytest
import torch

from uniir_tpu_torch.ops import topk as T
from uniir_tpu_torch.retrieval.index import DenseIndex
from uniir_tpu_torch.retrieval.search import search_dense_index

N, D, Q = 8192, 32, 16
VALID_N = 4000  # not a multiple of CHUNK; leaves two chunks fully padded
# bf16 products are exact in fp32; the two frameworks sum them in different
# orders, so maxima agree to fp32 rounding of |score| <= ~30.
BF16_ATOL = 1e-4


def _data(seed=0, n=N, d=D, q=Q):
    rng = np.random.default_rng(seed)
    # bf16-representable fp16 values: the sweep reads the pool as bf16
    pool = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).bfloat16().half().numpy()
    queries = rng.standard_normal((q, d)).astype(np.float32)
    return queries, pool


def test_bf16_twin_matches_pallas_sweep():
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import bucket_max_scores as jax_bucket_max

    queries, pool = _data()
    ref = jax_bucket_max(jnp.asarray(queries), jnp.asarray(pool), valid_n=VALID_N, interpret=True)
    out = T.bucket_max_scores(torch.from_numpy(queries), torch.from_numpy(pool).bfloat16(), VALID_N)
    assert out.shape == (Q, N // T.GROUP) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=BF16_ATOL)
    # fully-padded buckets score exactly the padding value in both
    assert (out.numpy() == np.float32(T.NEG)).sum() == (np.asarray(ref) == np.float32(T.NEG)).sum() > 0


def test_quantize_pool_matches_jax():
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    _, pool = _data(seed=1)
    ref_q, ref_s = jax_quantize_pool(jnp.asarray(pool))
    pool_q, scale = T.quantize_pool(torch.from_numpy(pool))
    np.testing.assert_array_equal(pool_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_s))


def test_int8_twin_matches_pallas_sweep():
    """int8 dot products are exact in both; the dequantisation is the same
    two fp32 multiplies in the same order, so the maxima are bit-equal."""
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import bucket_max_scores_i8 as jax_bucket_max_i8
    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    queries, pool = _data(seed=2)
    ref_q, ref_s = jax_quantize_pool(jnp.asarray(pool))
    ref = jax_bucket_max_i8(jnp.asarray(queries), ref_q, ref_s, valid_n=VALID_N, interpret=True)
    pool_q, scale = T.quantize_pool(torch.from_numpy(pool))
    out = T.bucket_max_scores_i8(torch.from_numpy(queries), pool_q, scale, VALID_N)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_int8_sweep_quantises_queries_as_the_jax_sweep():
    """The JAX sweep quantises its queries outside any jit, with a true
    division by 127 (the pool's jitted quantisation multiplies by the
    reciprocal): at 300 queries some scales differ between the two roundings,
    and the port's K4 output is still bit-equal to the JAX sweep's."""
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import bucket_max_scores_i8 as jax_bucket_max_i8
    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    queries, pool = _data(seed=22, n=2048, d=64, q=300)
    q = torch.from_numpy(queries)
    assert not torch.equal(T.quantize_queries(q)[1], T.quantize_rows(q)[1])
    ref_q, ref_s = jax_quantize_pool(jnp.asarray(pool))
    ref = jax_bucket_max_i8(jnp.asarray(queries), ref_q, ref_s, valid_n=2000, interpret=True)
    pool_q, scale = T.quantize_pool(torch.from_numpy(pool))
    np.testing.assert_array_equal(T.bucket_max_scores_i8(q, pool_q, scale, 2000).numpy(), np.asarray(ref))


def test_prepare_pool_pads_to_chunks_and_quantizes_host_values():
    _, pool = _data(seed=3, n=3000)
    dev_pool, (pool_q, scale) = T.prepare_pool(pool, "cpu", int8=True)
    assert dev_pool.shape == (4096, D) and dev_pool.dtype == torch.bfloat16
    assert torch.equal(dev_pool[:3000], torch.from_numpy(pool).bfloat16())
    assert not dev_pool[3000:].any() and not pool_q[3000:].any()
    ref_q, ref_s = T.quantize_pool(torch.from_numpy(pool))
    assert torch.equal(pool_q[:3000], ref_q) and torch.equal(scale[:3000], ref_s)


@pytest.mark.parametrize("int8", [False, True])
def test_topk_matches_brute_force(int8):
    """Indices equal the fp32 brute force on continuous data (bf16-exact inputs)."""
    from uniir_tpu.ops.topk import topk_numpy_reference as jax_numpy_reference

    queries, pool = _data(seed=4, q=9)
    queries = torch.from_numpy(queries).bfloat16().float().numpy()
    k = 10
    dev_pool, quant = T.prepare_pool(pool, "cpu", int8=int8)
    vals, idx, ok = T.topk(torch.from_numpy(queries), dev_pool, k, valid_n=VALID_N, pool_quant=quant, with_guard=True)
    ref_vals, ref_idx = T.topk_numpy_reference(queries, pool[:VALID_N], k)
    for a, b in zip((ref_vals, ref_idx), jax_numpy_reference(queries, pool[:VALID_N], k)):
        np.testing.assert_array_equal(a, b)
    assert bool(ok.all())
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(vals.numpy(), ref_vals, rtol=0, atol=BF16_ATOL)


def _flat_margin_pool(seed=5, n=4096, d=D, q=12):
    """Rows that are near-copies of a few directions: int8 rounding error
    exceeds the score margins, so the guard fails for some queries."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((4, d))
    pool = (base[rng.integers(0, 4, n)] + 1e-3 * rng.standard_normal((n, d))).astype(np.float16)
    queries = (base[rng.integers(0, 4, q)] + 0.1 * rng.standard_normal((q, d))).astype(np.float32)
    return queries, pool


@pytest.mark.parametrize("flat", [False, True])
def test_guard_matches_pallas_topk(flat):
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import pallas_topk
    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    queries, pool = _flat_margin_pool() if flat else _data(seed=6, n=4096, q=12)
    k, valid_n = 5, 4000
    ref_q, ref_s = jax_quantize_pool(jnp.asarray(pool))
    ref_vals, ref_idx, ref_ok = pallas_topk(
        jnp.asarray(queries), jnp.asarray(pool), k, valid_n=valid_n, interpret=True,
        pool_quant=(ref_q, ref_s), with_guard=True,
    )
    dev_pool, quant = T.prepare_pool(pool, "cpu", int8=True)
    vals, idx, ok = T.topk(torch.from_numpy(queries), dev_pool, k, valid_n=valid_n, pool_quant=quant, with_guard=True)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    if flat:
        assert not ok.all(), "the flat-margin pool must exercise guard failures"
    # ties among int8 maxima go to the lower index in both (lax.top_k's
    # rule), so even the uncertain rows pick the same buckets
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("per_bucket", [False, True])
def test_topk_quantises_queries_as_the_jitted_pallas_topk(monkeypatch, per_bucket):
    """`pallas_topk` is jitted, so XLA quantises its queries with a multiply
    by the reciprocal of 127 (`quantize_rows`), not the stand-alone sweep's
    true division: at 300 queries the two roundings differ on some rows, and
    `topk`'s maxima are still bit-equal to the jitted JAX sweep's, its guard,
    ids and scores equal to `pallas_topk`'s."""
    import functools

    import jax
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import bucket_max_scores_i8 as jax_bucket_max_i8
    from uniir_tpu.ops.topk_pallas import pallas_topk
    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    queries, pool = _flat_margin_pool(seed=23, q=300)
    q = torch.from_numpy(queries)
    assert not torch.equal(T.quantize_queries(q)[1], T.quantize_rows(q)[1])
    k, valid_n = 5, 4000
    ref_q, ref_s = jax_quantize_pool(jnp.asarray(pool), per_bucket=per_bucket)
    ref_vals, ref_idx, ref_ok = pallas_topk(
        jnp.asarray(queries), jnp.asarray(pool), k, valid_n=valid_n, interpret=True,
        pool_quant=(ref_q, ref_s), with_guard=True,
    )
    jitted_sweep = jax.jit(functools.partial(jax_bucket_max_i8, valid_n=valid_n, interpret=True))
    ref_maxima = np.asarray(jitted_sweep(jnp.asarray(queries), ref_q, ref_s))

    seen = []
    sweep = T.bucket_max_scores_i8
    monkeypatch.setattr(T, "bucket_max_scores_i8", lambda *a, **kw: seen.append(sweep(*a, **kw)) or seen[-1])
    dev_pool, quant = T.prepare_pool(pool, "cpu", int8=True, per_bucket=per_bucket)
    vals, idx, ok = T.topk(q, dev_pool, k, valid_n=valid_n, pool_quant=quant, with_guard=True)
    np.testing.assert_array_equal(seen[0].numpy(), ref_maxima)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    assert not ok.all(), "the flat-margin pool must exercise guard failures"
    # the pool's near-copies leave a few exact scores closer than the rescore's fp32 summation order, so
    # the two frameworks may pick either of such rows: ids differ only where their exact scores tie
    q64 = q.bfloat16().double().numpy()
    pool64 = dev_pool.double().numpy()
    ref_idx = np.asarray(ref_idx)
    apart = idx.numpy() != ref_idx
    np.testing.assert_allclose(np.einsum("qkd,qd->qk", pool64[idx.numpy()], q64)[apart],
                               np.einsum("qkd,qd->qk", pool64[ref_idx], q64)[apart], rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), rtol=0, atol=BF16_ATOL)


def test_search_reruns_failed_batches_on_the_exact_sweep():
    queries, pool = _flat_margin_pool()
    index = DenseIndex.build(pool, np.arange(len(pool)) + 10_000_000)
    stats8, stats16 = {}, {}
    s8, ids8 = search_dense_index(queries, index, 5, batch_size=4, pool_dtype="int8", stats=stats8, device="cpu")
    s16, ids16 = search_dense_index(queries, index, 5, batch_size=4, pool_dtype="bf16", stats=stats16, device="cpu")
    assert stats8["pool_dtype"] == "int8" and stats8["exact_reruns"] >= 1 and stats8["guard_pass_rate"] < 1.0
    assert stats16 == {"pool_dtype": "bf16", "guard_pass_rate": None, "exact_reruns": 0}
    np.testing.assert_array_equal(ids8, ids16)
    np.testing.assert_array_equal(s8, s16)


def test_cpu_sweeps_count_no_launch():
    queries, pool = _data(seed=7, n=2048)
    before = (T.bucket_max_scores.launches, T.bucket_max_scores_i8.launches)
    dev_pool, quant = T.prepare_pool(pool, "cpu", int8=True)
    T.topk(torch.from_numpy(queries), dev_pool, 3)
    T.topk(torch.from_numpy(queries), dev_pool, 3, pool_quant=quant)
    assert (T.bucket_max_scores.launches, T.bucket_max_scores_i8.launches) == before


# ------------------------------------------------------------------- K11


def test_quantize_pool_per_bucket_matches_jax():
    """Bucket amax, scale and int8 values bit-equal to the JAX package's."""
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    _, pool = _data(seed=8)
    ref_q, ref_s = jax_quantize_pool(jnp.asarray(pool), per_bucket=True)
    pool_q, scale = T.quantize_pool(torch.from_numpy(pool), per_bucket=True)
    assert scale.shape == (N // T.GROUP,) and pool_q.dtype == torch.int8
    np.testing.assert_array_equal(pool_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_s))
    with pytest.raises(ValueError, match="multiple of 2048"):
        T.quantize_pool(torch.from_numpy(pool[:3000]), per_bucket=True)


def test_quantize_pool_per_bucket_in_steps_equals_one_pass(monkeypatch):
    _, pool = _data(seed=9)
    whole = T.quantize_pool(torch.from_numpy(pool), per_bucket=True)
    monkeypatch.setattr(T, "ROWS_PER_STEP", T.CHUNK)  # four steps of one chunk
    stepped = T.quantize_pool(torch.from_numpy(pool), per_bucket=True)
    assert torch.equal(whole[0], stepped[0]) and torch.equal(whole[1], stepped[1])


@pytest.mark.parametrize("valid_n", [None, VALID_N, 2048 + 100, 2048])
def test_int8_per_bucket_twin_matches_pallas_sweep(valid_n):
    """int8 dot products and the int32 bucket maxima are exact in both; the
    dequantisation is the same two fp32 multiplies in the same order, so the
    maxima are bit-equal: a full pool, a boundary chunk whose first bucket
    members are partly padding, and whole padding chunks."""
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import bucket_max_scores_i8 as jax_bucket_max_i8
    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    queries, pool = _data(seed=10)
    ref_q, ref_s = jax_quantize_pool(jnp.asarray(pool), per_bucket=True)
    ref = jax_bucket_max_i8(jnp.asarray(queries), ref_q, ref_s, valid_n=valid_n, interpret=True)
    pool_q, scale = T.quantize_pool(torch.from_numpy(pool), per_bucket=True)
    before = (T.bucket_max_scores_i8.launches, T.bucket_max_scores_i8b.launches)
    out = T.bucket_max_scores_i8(torch.from_numpy(queries), pool_q, scale, valid_n)  # dispatch by the scales' shape
    assert (T.bucket_max_scores_i8.launches, T.bucket_max_scores_i8b.launches) == before
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # padding buckets carry the port's NEG, the constant K2 / K4 write
    n_neg = 0 if valid_n is None else (out.numpy() == np.float32(T.NEG)).sum()
    n_pad_buckets = 0 if valid_n is None else Q * sum(
        1 for b in range(N // T.GROUP) if (b // T.LANES) * T.CHUNK + b % T.LANES >= valid_n)
    assert n_neg == n_pad_buckets


def test_int8_per_bucket_twin_is_exact_past_what_fp32_holds():
    """At D = 1152 (the widest the wgmma K11 takes) int8 dot products reach
    past 2^24: the twin sums them in fp64 and stays bit-equal to the JAX
    sweep, whose int32 sums are exact."""
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import bucket_max_scores_i8 as jax_bucket_max_i8
    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    queries, pool = _data(seed=23, n=2048, d=1152, q=4)
    queries[0] = np.sign(queries[0])
    # every row near query 0's signs at full scale: its int8 sums reach about 1152 * 127 * 126
    pool = (queries[0] * (1 - 0.01 * np.abs(pool.astype(np.float32)))).astype(np.float16)
    ref_q, ref_s = jax_quantize_pool(jnp.asarray(pool), per_bucket=True)
    ref = jax_bucket_max_i8(jnp.asarray(queries), ref_q, ref_s, valid_n=2000, interpret=True)
    pool_q, scale = T.quantize_pool(torch.from_numpy(pool), per_bucket=True)
    q_q, q_scale = T.quantize_queries(torch.from_numpy(queries))
    assert (q_q[0].int() @ pool_q.int().T).max() >= 2**24
    out = T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_q, scale, 2000)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_negative_maxima_outrank_padding_in_the_boundary_chunk():
    """A dequantised int32 sentinel would be a small negative number: the
    twin writes NEG for an all-padding bucket, so a true negative score wins."""
    rng = np.random.default_rng(11)
    pool = torch.from_numpy(-np.abs(rng.standard_normal((2048, D))).astype(np.float32))
    queries = torch.from_numpy(np.abs(rng.standard_normal((3, D))).astype(np.float32))
    pool_q, scale = T.quantize_pool(pool, per_bucket=True)
    out = T.bucket_max_scores_i8b(queries, pool_q, scale, valid_n=100)
    assert (out[:, :100] < 0).all() and (out[:, :100] > -1e3).all()
    assert (out[:, 100:] == T.NEG).all()


def test_prepare_pool_per_bucket_pads_the_last_chunk():
    _, pool = _data(seed=12, n=3000)
    dev_pool, (pool_q, scale) = T.prepare_pool(pool, "cpu", int8=True, per_bucket=True)
    assert dev_pool.shape == (4096, D) and pool_q.shape == (4096, D) and scale.shape == (4096 // T.GROUP,)
    padded = torch.cat([torch.from_numpy(pool), torch.zeros(4096 - 3000, D, dtype=torch.float16)])
    ref_q, ref_s = T.quantize_pool(padded, per_bucket=True)
    assert torch.equal(pool_q, ref_q) and torch.equal(scale, ref_s)


def test_topk_through_per_bucket_pool_returns_brute_force_ids():
    queries, pool = _data(seed=13, q=9)
    queries = torch.from_numpy(queries).bfloat16().float().numpy()
    k = 10
    dev_pool, quant = T.prepare_pool(pool, "cpu", int8=True, per_bucket=True)
    assert quant[1].shape == (N // T.GROUP,)
    vals, idx, ok = T.topk(torch.from_numpy(queries), dev_pool, k, valid_n=VALID_N, pool_quant=quant, with_guard=True)
    ref_vals, ref_idx = T.topk_numpy_reference(queries, pool[:VALID_N], k)
    assert bool(ok.all())
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(vals.numpy(), ref_vals, rtol=0, atol=BF16_ATOL)


def test_guard_through_per_bucket_pool_matches_pallas_topk():
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import pallas_topk
    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    queries, pool = _flat_margin_pool()
    k, valid_n = 5, 4000
    ref_vals, ref_idx, ref_ok = pallas_topk(
        jnp.asarray(queries), jnp.asarray(pool), k, valid_n=valid_n, interpret=True,
        pool_quant=jax_quantize_pool(jnp.asarray(pool), per_bucket=True), with_guard=True,
    )
    dev_pool, quant = T.prepare_pool(pool, "cpu", int8=True, per_bucket=True)
    vals, idx, ok = T.topk(torch.from_numpy(queries), dev_pool, k, valid_n=valid_n, pool_quant=quant, with_guard=True)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), rtol=0, atol=BF16_ATOL)


# ------------------------------------------------- the search's pool type


@pytest.mark.parametrize("env,want", [(None, "bf16"), ("int8", "int8"), ("int8_bucket", "int8_bucket")])
def test_search_reads_its_pool_type_from_the_environment(monkeypatch, env, want):
    """`UNIIR_TOPK_POOL` decides when the caller names no pool type, as in
    the JAX search: another `stats["pool_dtype"]`, the same ids; an argument
    wins over the variable."""
    queries, pool = _data(seed=14, n=4096, q=6)
    index = DenseIndex.build(pool, np.arange(len(pool)) + 10_000_000)
    monkeypatch.delenv("UNIIR_TOPK_POOL", raising=False)
    _, ref_ids = search_dense_index(queries, index, 5, pool_dtype="bf16", device="cpu")
    if env is not None:
        monkeypatch.setenv("UNIIR_TOPK_POOL", env)
    stats = {}
    _, ids = search_dense_index(queries, index, 5, stats=stats, device="cpu")
    assert stats["pool_dtype"] == want
    assert (stats["guard_pass_rate"] is None) == (want == "bf16")
    np.testing.assert_array_equal(ids, ref_ids)
    stats = {}
    search_dense_index(queries, index, 5, pool_dtype="bf16", stats=stats, device="cpu")
    assert stats["pool_dtype"] == "bf16"


def test_search_rejects_an_unknown_pool_type(monkeypatch):
    queries, pool = _data(seed=15, n=2048, q=2)
    index = DenseIndex.build(pool, np.arange(len(pool)))
    monkeypatch.setenv("UNIIR_TOPK_POOL", "fp8")
    with pytest.raises(ValueError, match="pool_dtype"):
        search_dense_index(queries, index, 5, device="cpu")


# ------------------------------------------- the sweep route and the tile's edges


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 512, "wgmma"),
    (torch.bfloat16, 768, "wgmma"), (torch.bfloat16, 800, "general"), (torch.bfloat16, 1024, "general"),
    (torch.bfloat16, 48, None), (torch.bfloat16, 0, None),
    (torch.int8, 64, "wgmma"), (torch.int8, 512, "wgmma"), (torch.int8, 768, "wgmma"),
    (torch.int8, 1152, "wgmma"), (torch.int8, 1216, "general"), (torch.int8, 96, None),
    (torch.float32, 768, None),
])
def test_sweep_route_table(dtype, D, want):
    """bf16 to D = 768 and int8 (K4 and K11) to D = 1152 on the wgmma kernel
    (its query tile, 64 rows bf16 / 128 int8, stays in shared memory beside
    a ring of 4 stages), wider multiples of 32 / 64 on the general kernels,
    none for another width or type."""
    assert T.sweep_route(dtype, D) == want


@pytest.mark.parametrize("pool,D,entry,wrapper", [
    ("bf16", 768, "uniir_bucket_max_bf16", "bucket_max_scores"),
    ("bf16", 800, "uniir_bucket_max_bf16_general", "bucket_max_scores_general"),
    ("int8", 768, "uniir_bucket_max_i8", "bucket_max_scores_i8"),
    ("int8", 1216, "uniir_bucket_max_i8_general", "bucket_max_scores_i8_general"),
    ("int8_bucket", 768, "uniir_bucket_max_i8b", "bucket_max_scores_i8b"),
    ("int8_bucket", 1152, "uniir_bucket_max_i8b", "bucket_max_scores_i8b"),
    ("int8_bucket", 1216, "uniir_bucket_max_i8b_general", "bucket_max_scores_i8b_general"),
])
def test_sweep_kernels_table(pool, D, entry, wrapper):
    """The C entry of csrc/topk.cu each pool's sweep launches at a width, and
    the wrapper whose count it moves; with `general` the general-width entry."""
    assert T._sweep_kernel(pool, D, general=False) == (entry, getattr(T, wrapper))
    general_entry = T._SWEEP_KERNELS[pool, "general"]
    assert T._sweep_kernel(pool, D, general=True) == general_entry and general_entry[0].endswith("_general")


def _launch_counts():
    return (T.bucket_max_scores.launches, T.bucket_max_scores_general.launches, T.bucket_max_scores_i8.launches,
            T.bucket_max_scores_i8_general.launches, T.bucket_max_scores_i8b.launches,
            T.bucket_max_scores_i8b_general.launches)


@pytest.mark.parametrize("d", [64, 800])
def test_cpu_sweeps_take_the_twins_through_both_routes(d):
    """On CPU tensors every K2 / K4 / K11 entry, the wgmma route's (D = 64)
    and the general one's (bf16 D = 800), runs its twin and counts no launch."""
    queries, pool = _data(seed=16, n=2048, d=d, q=5)
    q, bf_pool = torch.from_numpy(queries), torch.from_numpy(pool).bfloat16()
    before = _launch_counts()
    want = T.bucket_max_scores_reference(q, bf_pool, 1500)
    assert torch.equal(T.bucket_max_scores(q, bf_pool, 1500), want)
    assert torch.equal(T.bucket_max_scores_general(q, bf_pool, 1500), want)
    if T.sweep_route(torch.int8, d) is not None:
        pool_q, scale = T.quantize_pool(bf_pool)
        q_q, q_scale = T.quantize_queries(q)
        want8 = T.bucket_max_scores_i8_reference(q_q, q_scale, pool_q, scale, 1500)
        assert torch.equal(T.bucket_max_scores_i8(q, pool_q, scale, 1500), want8)
        assert torch.equal(T.bucket_max_scores_i8_general(q, pool_q, scale, 1500), want8)
        pool_qb, bucket_scale = T.quantize_pool(bf_pool, per_bucket=True)
        want8b = T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_qb, bucket_scale, 1500)
        assert torch.equal(T.bucket_max_scores_i8(q, pool_qb, bucket_scale, 1500), want8b)
        assert torch.equal(T.bucket_max_scores_i8b(q, pool_qb, bucket_scale, 1500), want8b)
        assert torch.equal(T.bucket_max_scores_i8b_general(q, pool_qb, bucket_scale, 1500), want8b)
    assert _launch_counts() == before


EDGE_N, EDGE_D = 3 * 2048, 64


@pytest.mark.parametrize("q", [1, 127, 128, 129])
@pytest.mark.parametrize("valid_n", [700, 2048 + 1000, 2 * 2048 + 1500])
@pytest.mark.parametrize("int8", [False, True])
def test_twins_match_pallas_sweeps_at_the_tile_edges(q, valid_n, int8):
    """The wgmma kernel's tile is 128 queries x one 2048-row chunk: query
    counts on either side of it, and valid_n cutting the first, a middle and
    the last of three chunks, against the JAX sweeps in interpret mode."""
    import jax.numpy as jnp

    from uniir_tpu.ops.topk_pallas import bucket_max_scores as jax_bucket_max
    from uniir_tpu.ops.topk_pallas import bucket_max_scores_i8 as jax_bucket_max_i8
    from uniir_tpu.ops.topk_pallas import quantize_pool as jax_quantize_pool

    queries, pool = _data(seed=17 + q, n=EDGE_N, d=EDGE_D, q=q)
    if int8:
        ref_q, ref_s = jax_quantize_pool(jnp.asarray(pool))
        ref = jax_bucket_max_i8(jnp.asarray(queries), ref_q, ref_s, valid_n=valid_n, interpret=True)
        pool_q, scale = T.quantize_pool(torch.from_numpy(pool))
        out = T.bucket_max_scores_i8(torch.from_numpy(queries), pool_q, scale, valid_n)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    else:
        ref = jax_bucket_max(jnp.asarray(queries), jnp.asarray(pool), valid_n=valid_n, interpret=True)
        out = T.bucket_max_scores(torch.from_numpy(queries), torch.from_numpy(pool).bfloat16(), valid_n)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=BF16_ATOL)
    n_pad = sum(1 for b in range(EDGE_N // T.GROUP) if (b // T.LANES) * T.CHUNK + b % T.LANES >= valid_n)
    assert out.shape == (q, EDGE_N // T.GROUP) and (out.numpy() == np.float32(T.NEG)).sum() == q * n_pad


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_sweeps_match_twins(cuda):
    """At the main path's width (768) and query batch (256), on a ragged pool."""
    g = torch.Generator(device=cuda).manual_seed(0)
    queries = torch.randn(256, 768, generator=g, device=cuda)
    pool = torch.randn(64 * T.CHUNK, 768, generator=g, device=cuda).bfloat16()
    valid_n = pool.shape[0] - 777
    out = T.bucket_max_scores(queries, pool, valid_n)
    torch.cuda.synchronize()
    ref = T.bucket_max_scores_reference(queries, pool, valid_n)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)  # fp32 sums of 768 terms, other order
    pool_q, scale = T.quantize_pool(pool)
    out8 = T.bucket_max_scores_i8(queries, pool_q, scale, valid_n)
    torch.cuda.synchronize()
    q_q, q_scale = T.quantize_queries(queries)
    ref8 = T.bucket_max_scores_i8_reference(q_q, q_scale, pool_q, scale, valid_n)
    assert torch.equal(out8, ref8)


@pytest.mark.gpu
@pytest.mark.parametrize("cut", [0, 777, 2048 + 5])
def test_cuda_per_bucket_sweep_matches_twin(cuda, cut):
    """K11 at the main path's width and query batch: the integers are exact
    and the dequantisation is two rounded multiplies, so bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(1)
    queries = torch.randn(256, 768, generator=g, device=cuda)
    pool = torch.randn(64 * T.CHUNK, 768, generator=g, device=cuda).bfloat16()
    valid_n = pool.shape[0] - cut
    pool_q, scale = T.quantize_pool(pool, per_bucket=True)
    before = (T.bucket_max_scores_i8.launches, T.bucket_max_scores_i8b.launches)
    out = T.bucket_max_scores_i8(queries, pool_q, scale, valid_n)
    torch.cuda.synchronize()
    assert (T.bucket_max_scores_i8.launches, T.bucket_max_scores_i8b.launches) == (before[0], before[1] + 1)
    q_q, q_scale = T.quantize_queries(queries)
    assert torch.equal(out, T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_q, scale, valid_n))


# ------------------------------------------------ the wgmma sweeps on the card

GRID_CHUNKS = 40  # 2 or 3 chunks a block at Q > 896 (16 walkers a query tile), one at smaller Q


def _sweep_inputs(device, seed, q, d, n_chunks):
    g = torch.Generator(device=device).manual_seed(seed)
    queries = torch.randn(q, d, generator=g, device=device)
    pool = torch.randn(n_chunks * T.CHUNK, d, generator=g, device=device).bfloat16()
    return queries, pool


def _check_new_sweeps(queries, pool, cuts):
    """New K2 within rtol 1e-5 / atol 1e-3 of its twin (fp32 sums of bf16
    products in another order), new K4 and K11 bit-equal (exact integers, the
    same two rounded multiplies); each launch counted on the new kernel's
    counter."""
    pool_q, scale = T.quantize_pool(pool)
    pool_qb, bucket_scale = T.quantize_pool(pool, per_bucket=True)
    q_q, q_scale = T.quantize_queries(queries)
    for cut in cuts:
        valid_n = pool.shape[0] - cut
        before = _launch_counts()
        out = T.bucket_max_scores(queries, pool, valid_n)
        out8 = T.bucket_max_scores_i8(queries, pool_q, scale, valid_n)
        out8b = T.bucket_max_scores_i8(queries, pool_qb, bucket_scale, valid_n)
        torch.cuda.synchronize()
        b = before
        assert _launch_counts() == (b[0] + 1, b[1], b[2] + 1, b[3], b[4] + 1, b[5]), f"cut {cut}: launched another kernel"
        ref = T.bucket_max_scores_reference(queries, pool, valid_n)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
        assert torch.equal(out8, T.bucket_max_scores_i8_reference(q_q, q_scale, pool_q, scale, valid_n)), f"cut {cut}"
        want8b = T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_qb, bucket_scale, valid_n)
        assert torch.equal(out8b, want8b), f"cut {cut}"


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 63, 64, 65, 127, 128, 129, 256, 1000, 1024])
@pytest.mark.parametrize("d", [64, 256, 512, 768])
def test_cuda_wgmma_sweeps_match_twins(cuda, q, d):
    """Query counts around the 64-query warpgroup and 128-query block tiles,
    the widths of the tiny, `base` and `large` configs, and valid_n cutting
    nothing, the last chunk, and the second-to-last (the last all padding)."""
    queries, pool = _sweep_inputs(cuda, 100 + q + d, q, d, GRID_CHUNKS)
    _check_new_sweeps(queries, pool, (0, 777, 2048 + 5))


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 129, 1024])
@pytest.mark.parametrize("d", [512, 768])
def test_cuda_wgmma_sweeps_walk_many_chunks(cuda, q, d):
    """300 chunks: every block of the persistent grid walks several, so the
    ring and K4's two chunk-scale slots wrap many times."""
    queries, pool = _sweep_inputs(cuda, 200 + q + d, q, d, 300)
    _check_new_sweeps(queries, pool, (777,))


def _i8_sweep_exact(q_q, q_scale, pool_q, pool_scale, valid_n):
    """K4's function where fp32 cannot hold the integer sums (D > 1040): the
    sums exact in fp64, rounded to fp32 as the kernel's convert does, then
    the two rounded fp32 multiplies."""
    acc = (q_q.double() @ pool_q.double().T).float()
    scores = acc * q_scale[:, None] * pool_scale[None, :]
    return T._bucket_max(T._masked(scores, 0, valid_n))


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 129, 1024])
@pytest.mark.parametrize("d", [1024, 1152])
def test_cuda_wgmma_int8_sweep_at_its_widest(cuda, q, d):
    """int8 widths past 768 on the wgmma kernel, up to the widest it takes
    (its query tile in 8 and 9 boxes of 128 bytes, a ring of 5 and 4
    stages), bit-equal to K4's function with the sums exact in fp64."""
    queries, pool = _sweep_inputs(cuda, 600 + q + d, q, d, GRID_CHUNKS)
    assert T.sweep_route(torch.int8, d) == "wgmma"
    pool_q, scale = T.quantize_pool(pool)
    q_q, q_scale = T.quantize_queries(queries)
    for cut in (0, 777, 2048 + 5):
        valid_n = pool.shape[0] - cut
        before = _launch_counts()
        out8 = T.bucket_max_scores_i8(queries, pool_q, scale, valid_n)
        torch.cuda.synchronize()
        assert _launch_counts() == before[:2] + (before[2] + 1,) + before[3:], f"cut {cut}: launched another kernel"
        assert torch.equal(out8, _i8_sweep_exact(q_q, q_scale, pool_q, scale, valid_n)), f"cut {cut}"


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 127, 128, 129, 1000, 1024])
@pytest.mark.parametrize("d", [64, 768, 1152])
def test_cuda_wgmma_per_bucket_sweep_matches_twin(cuda, q, d):
    """The wgmma K11 bit-equal to its twin around the 128-query block tile,
    at the narrowest, the main path's and the widest width it takes, with
    valid_n cutting nothing, the last chunk mid-bucket, the first chunk at
    its edge (every later chunk padding), and at 0 rows of the last chunk."""
    queries, pool = _sweep_inputs(cuda, 700 + q + d, q, d, GRID_CHUNKS)
    assert T.sweep_route(torch.int8, d) == "wgmma"
    n = pool.shape[0]
    pool_qb, bucket_scale = T.quantize_pool(pool, per_bucket=True)
    q_q, q_scale = T.quantize_queries(queries)
    for valid_n in (n, n - 1000, T.CHUNK, n - T.CHUNK):
        before = _launch_counts()
        out = T.bucket_max_scores_i8b(queries, pool_qb, bucket_scale, valid_n)
        torch.cuda.synchronize()
        assert _launch_counts() == before[:4] + (before[4] + 1, before[5]), f"valid_n {valid_n}: launched another kernel"
        want = T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_qb, bucket_scale, valid_n)
        assert torch.equal(out, want), f"valid_n {valid_n}"


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 129, 256])
def test_cuda_general_sweeps_at_widths_only_they_take(cuda, q):
    """bf16 D = 1024 and int8 D = 1216 route to the general kernels (K11's
    too), counted on their own counters, and agree with the twin / the exact
    function."""
    queries, pool = _sweep_inputs(cuda, 300 + q, q, 1024, 8)
    valid_n = pool.shape[0] - 777
    before = _launch_counts()
    out = T.bucket_max_scores(queries, pool, valid_n)
    torch.cuda.synchronize()
    assert _launch_counts() == (before[0], before[1] + 1) + before[2:]
    torch.testing.assert_close(out, T.bucket_max_scores_reference(queries, pool, valid_n), rtol=1e-5, atol=1e-3)

    queries, pool = _sweep_inputs(cuda, 400 + q, q, 1216, 8)
    pool_q, scale = T.quantize_pool(pool)
    q_q, q_scale = T.quantize_queries(queries)
    before = _launch_counts()
    out8 = T.bucket_max_scores_i8(queries, pool_q, scale, valid_n)
    torch.cuda.synchronize()
    assert _launch_counts() == before[:3] + (before[3] + 1,) + before[4:]
    assert torch.equal(out8, _i8_sweep_exact(q_q, q_scale, pool_q, scale, valid_n))

    pool_qb, bucket_scale = T.quantize_pool(pool, per_bucket=True)
    before = _launch_counts()
    out8b = T.bucket_max_scores_i8(queries, pool_qb, bucket_scale, valid_n)
    torch.cuda.synchronize()
    assert _launch_counts() == before[:5] + (before[5] + 1,)
    assert torch.equal(out8b, T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_qb, bucket_scale, valid_n))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [512, 768])
def test_cuda_general_sweeps_match_twins_at_wgmma_widths(cuda, d):
    """The general kernels, called directly, at the widths the rule gives to
    the wgmma kernel (how chip_smoke.py times the two side by side)."""
    queries, pool = _sweep_inputs(cuda, 500 + d, 129, d, 8)
    valid_n = pool.shape[0] - 777
    pool_q, scale = T.quantize_pool(pool)
    pool_qb, bucket_scale = T.quantize_pool(pool, per_bucket=True)
    q_q, q_scale = T.quantize_queries(queries)
    before = _launch_counts()
    out = T.bucket_max_scores_general(queries, pool, valid_n)
    out8 = T.bucket_max_scores_i8_general(queries, pool_q, scale, valid_n)
    out8b = T.bucket_max_scores_i8b_general(queries, pool_qb, bucket_scale, valid_n)
    torch.cuda.synchronize()
    assert _launch_counts() == (before[0], before[1] + 1, before[2], before[3] + 1, before[4], before[5] + 1)
    torch.testing.assert_close(out, T.bucket_max_scores_reference(queries, pool, valid_n), rtol=1e-5, atol=1e-3)
    assert torch.equal(out8, T.bucket_max_scores_i8_reference(q_q, q_scale, pool_q, scale, valid_n))
    assert torch.equal(out8b, T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_qb, bucket_scale, valid_n))


def _same_ids_up_to_ties(ids, ref_ids, ref_scores, tie=1e-5):
    """Equal ids, except where the reference's neighbouring scores tie within
    `tie` (the card and the host sum the rescoring products in other orders)."""
    diff = ids != ref_ids
    near_tie = np.zeros_like(diff)
    near_tie[:, 1:] |= np.abs(np.diff(ref_scores, axis=1)) < tie
    near_tie[:, :-1] |= np.abs(np.diff(ref_scores, axis=1)) < tie
    return bool((~diff | near_tie).all())


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int8_bucket"])
def test_cuda_search_returns_the_twins_ids(cuda, pool_dtype):
    """`search_dense_index` on the card at 2500 queries -- two full batches
    of 1024 and a remainder of 452 -- returns the ids of the same search on
    the host through the twins."""
    rng = np.random.default_rng(21)
    pool = rng.standard_normal((20000, 768)).astype(np.float16)
    queries = rng.standard_normal((2500, 768)).astype(np.float32)
    index = DenseIndex.build(pool, np.arange(len(pool)) + 10_000_000)
    before = _launch_counts()
    stats = {}
    scores, ids = search_dense_index(queries, index, 10, pool_dtype=pool_dtype, stats=stats, device=cuda)
    launched = np.subtract(_launch_counts(), before)
    ref_scores, ref_ids = search_dense_index(queries, index, 10, pool_dtype=pool_dtype, device="cpu")
    reruns = stats["exact_reruns"]
    want = {"bf16": (3, 0, 0, 0, 0, 0), "int8": (reruns, 0, 3, 0, 0, 0), "int8_bucket": (reruns, 0, 0, 0, 3, 0)}[pool_dtype]
    assert tuple(launched) == want
    assert _same_ids_up_to_ties(ids, ref_ids, ref_scores)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-4)
