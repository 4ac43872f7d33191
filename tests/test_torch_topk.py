"""Kernels K2 / K4 (retrieval sweeps) and the top-k epilogue against the JAX
package, on the same seeded numpy inputs.

The JAX side runs `bucket_max_scores`, `bucket_max_scores_i8` and
`pallas_topk` in interpret mode.  On a card the CUDA kernels are held
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
