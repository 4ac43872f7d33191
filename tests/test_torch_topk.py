"""Kernels K2 / K4 / K11 (retrieval sweeps) and the top-k epilogue against the
JAX package, on the same seeded numpy inputs.

The JAX side runs `bucket_max_scores`, `bucket_max_scores_i8` (with per-row
scales, K4, and with per-bucket scales, K11) and `pallas_topk` in interpret
mode.  On a card the CUDA kernels are held
against their twins; JAX is imported inside the parity tests only, so
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
    q_q, q_scale = T.quantize_rows(queries)
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
    q_q, q_scale = T.quantize_rows(queries)
    assert torch.equal(out, T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_q, scale, valid_n))
