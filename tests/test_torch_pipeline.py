"""The slice as a whole: embed -> create_index -> run_retrieval in the JAX
package and in the port, on the same miniature M-BEIR tree and weights.

The JAX bundle is `tiny_clip_bundle` (fp32 test-tiny), or a tiny CLIP-FF,
BLIP-SF or BLIP-FF built the same way; the port gets the same weights through
`state_dict_from_jax`, and the same tokenizer and image transform.  Query
instructions are off so both runs embed the same text.  The tokenizers'
word ids are the same in every process (`tests/torch_helpers.py`): with
`hash()`'s, each process embedded other tokens, and a seeded model's near
ties came and went from run to run.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tests.helpers import (
    build_pipeline_tree,
    identity_image_transform,
    make_eval_config,
    tiny_clip_bundle,
)
from uniir_tpu.data.registry import MBEIR_TASK as JAX_MBEIR_TASK
from uniir_tpu.models.clip import CLIP_CONFIGS as JAX_CLIP_CONFIGS
from uniir_tpu.data.registry import hash_did as jax_hash_did
from uniir_tpu.data.registry import hash_qid as jax_hash_qid
from uniir_tpu.retrieval.embedder import generate_embeds_for_config as jax_embed
from uniir_tpu.retrieval.eval import run_retrieval as jax_run_retrieval
from uniir_tpu.retrieval.index import create_index as jax_create_index
from uniir_tpu_torch.core.config import Config
from uniir_tpu_torch.data import registry as port_registry
from uniir_tpu_torch.models.blip_ff import BLIPFeatureFusion
from uniir_tpu_torch.models.blip_sf import BLIPScoreFusion
from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS
from uniir_tpu_torch.models.clip import CLIP_CONFIGS
from uniir_tpu_torch.models.clip_ff import CLIPFeatureFusion
from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.models.med import MED_CONFIGS
from uniir_tpu_torch.models.registry import ModelBundle, build_model_from_config
from uniir_tpu_torch.retrieval.embedder import generate_embeds_and_ids_for_dataset, generate_embeds_for_config
from uniir_tpu_torch.retrieval.eval import run_retrieval
from uniir_tpu_torch.retrieval.index import DenseIndex, create_index
from uniir_tpu_torch.retrieval.search import search_dense_index
from uniir_tpu_torch.train.steps import make_embed_step
from tests.torch_helpers import on_array, stable_bert_tokenizer, stable_tokenizer

JAX_EXPT = "CLIP_SF/TinyJax/NoInstruct/InBatch/"
# fp16 artifacts of fp32 towers that differ only in summation order
EMBED_ATOL = 2e-3


def _config(root, expt, pool_dtype=None, embed_dim=16):
    config = make_eval_config(root, embed_dim=embed_dim)
    config.data_config.enable_query_instruct = False
    config.experiment.path_suffix = expt
    if pool_dtype is not None:
        config.retrieval_config.pool_dtype = pool_dtype
    return config


def _port_bundle(jax_bundle):
    model = CLIPScoreFusion(CLIP_CONFIGS["test-tiny"])
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_bundle.params)))
    return ModelBundle(
        "CLIPScoreFusion", model.eval(), jax_bundle.tokenizer, on_array(jax_bundle.img_preprocess_fn),
        on_array(jax_bundle.img_preprocess_fn_eval), jax_bundle.image_size, jax_bundle.embed_dim,
    )


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_pipeline"))
    build_pipeline_tree(root)
    jax_bundle = tiny_clip_bundle()
    cfg = JAX_CLIP_CONFIGS["test-tiny"]
    jax_bundle = dataclasses.replace(jax_bundle, tokenizer=stable_tokenizer(cfg.context_length, cfg.vocab_size))
    config = _config(root, JAX_EXPT)
    jax_embed(jax_bundle, config)
    jax_create_index(config)
    jax_run_retrieval(config)
    return root, jax_bundle


def _run_rows(root, expt):
    run_dir = os.path.join(root, "retrieval_results", expt, "run_files")
    out = {}
    for name in sorted(os.listdir(run_dir)):
        with open(os.path.join(run_dir, name)) as f:
            out[name] = [(r[0], r[2], r[3], r[5], r[6]) for r in (line.split() for line in f)]
    return out


def _tsv(root, expt):
    tsv_dir = os.path.join(root, "retrieval_results", expt, "final_tsv")
    (name,) = os.listdir(tsv_dir)
    with open(os.path.join(tsv_dir, name)) as f:
        return f.read()


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_port_pipeline_matches_jax(trees, pool_dtype):
    root, jax_bundle = trees
    expt = f"CLIP_SF/TinyTorch-{pool_dtype}/NoInstruct/InBatch/"
    config = _config(root, expt, pool_dtype)
    written = generate_embeds_for_config(_port_bundle(jax_bundle), config)
    assert len(written) == 8  # train + test queries, pool, union: embed + ids each
    assert len(create_index(config)) == 2
    results = run_retrieval(config, device="cpu")
    assert results

    for split, name in [("test", "mscoco_task0_test"), ("train", "mscoco_task0_train"),
                        ("cand_pool", "mscoco_task0_cand_pool"), ("cand_pool", "union_cand_pool")]:
        base = os.path.join(root, "embed", "{}", split, f"mbeir_{name}")
        ours = np.load(base.format(expt) + "_embed.npy")
        ref = np.load(base.format(JAX_EXPT) + "_embed.npy")
        assert ours.dtype == np.float16 and ours.shape == ref.shape
        np.testing.assert_allclose(ours.astype(np.float32), ref.astype(np.float32), atol=EMBED_ATOL)
        np.testing.assert_array_equal(np.load(base.format(expt) + "_ids.npy"), np.load(base.format(JAX_EXPT) + "_ids.npy"))

    # same ids in the same order in every run file; same Recall values in the TSV
    assert _run_rows(root, expt) == _run_rows(root, JAX_EXPT)
    assert _tsv(root, expt) == _tsv(root, JAX_EXPT)


BLIP_JAX_EXPT = "BLIP_SF/TinyJax/NoInstruct/InBatch/"


def tiny_blip_bundle():
    """fp32 test-tiny BLIP-SF in the JAX package, with a BERT-style tokenizer of stable word ids."""
    from uniir_tpu.models.blip_sf import BLIPScoreFusion as JaxBLIPSF
    from uniir_tpu.models.blip_vit import BLIP_VIT_CONFIGS as JAX_VIT
    from uniir_tpu.models.med import MED_CONFIGS as JAX_MED
    from uniir_tpu.models.registry import ModelBundle as JaxModelBundle

    vit, med = JAX_VIT["test-tiny"], JAX_MED["test-tiny"]
    model = JaxBLIPSF(vit_cfg=vit, med_cfg=med, embed_dim=16)
    tok = stable_bert_tokenizer(max_len=16, vocab_size=97)
    img_fn = identity_image_transform(vit.image_size)
    ones = np.ones(2, np.int32)
    params = model.init(jax.random.PRNGKey(0), tok(["x", "y"]), np.zeros((2, vit.image_size, vit.image_size, 3), np.float32),
                        ones, ones)["params"]
    # flax zero-initialises cls_token / pos_embed: give them values so positions matter
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, params)
    for name in ("cls_token", "pos_embed"):
        params["visual_encoder"][name] = (0.02 * rng.standard_normal(params["visual_encoder"][name].shape)).astype(np.float32)
    return JaxModelBundle("BLIPScoreFusion", model, params, tok, img_fn, img_fn, (vit.image_size, vit.image_size), 16)


@pytest.fixture(scope="module")
def blip_trees(trees):
    root, _ = trees
    jax_bundle = tiny_blip_bundle()
    config = _config(root, BLIP_JAX_EXPT)
    jax_embed(jax_bundle, config)
    jax_create_index(config)
    jax_run_retrieval(config)
    return root, jax_bundle


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_port_blip_sf_pipeline_matches_jax(blip_trees, pool_dtype):
    """BLIP-SF through the same entry points: its text input is a dict
    {"input_ids", "attention_mask"} from the collator to the model."""
    root, jax_bundle = blip_trees
    model = BLIPScoreFusion(BLIP_VIT_CONFIGS["test-tiny"], MED_CONFIGS["test-tiny"], 16)
    model.load_state_dict(state_dict_from_jax(jax_bundle.params))
    bundle = ModelBundle("BLIPScoreFusion", model.eval(), jax_bundle.tokenizer, on_array(jax_bundle.img_preprocess_fn),
                         on_array(jax_bundle.img_preprocess_fn_eval), jax_bundle.image_size, jax_bundle.embed_dim)
    expt = f"BLIP_SF/TinyTorch-{pool_dtype}/NoInstruct/InBatch/"
    config = _config(root, expt, pool_dtype)
    assert len(generate_embeds_for_config(bundle, config)) == 8
    assert len(create_index(config)) == 2
    assert run_retrieval(config, device="cpu")
    for split, name in [("test", "mscoco_task0_test"), ("train", "mscoco_task0_train"),
                        ("cand_pool", "mscoco_task0_cand_pool"), ("cand_pool", "union_cand_pool")]:
        base = os.path.join(root, "embed", "{}", split, f"mbeir_{name}")
        ours, ref = np.load(base.format(expt) + "_embed.npy"), np.load(base.format(BLIP_JAX_EXPT) + "_embed.npy")
        assert ours.dtype == np.float16 and ours.shape == ref.shape
        np.testing.assert_allclose(ours.astype(np.float32), ref.astype(np.float32), atol=EMBED_ATOL)
        np.testing.assert_array_equal(np.load(base.format(expt) + "_ids.npy"), np.load(base.format(BLIP_JAX_EXPT) + "_ids.npy"))
    assert _run_rows(root, expt) == _run_rows(root, BLIP_JAX_EXPT)
    assert _tsv(root, expt) == _tsv(root, BLIP_JAX_EXPT)


def _assert_same_embeddings(root, expt, jax_expt):
    """fp16 embeddings within EMBED_ATOL and equal ids in every embedding file."""
    for split, name in [("test", "mscoco_task0_test"), ("train", "mscoco_task0_train"),
                        ("cand_pool", "mscoco_task0_cand_pool"), ("cand_pool", "union_cand_pool")]:
        base = os.path.join(root, "embed", "{}", split, f"mbeir_{name}")
        ours, ref = np.load(base.format(expt) + "_embed.npy"), np.load(base.format(jax_expt) + "_embed.npy")
        assert ours.dtype == np.float16 and ours.shape == ref.shape
        np.testing.assert_allclose(ours.astype(np.float32), ref.astype(np.float32), atol=EMBED_ATOL)
        np.testing.assert_array_equal(np.load(base.format(expt) + "_ids.npy"), np.load(base.format(jax_expt) + "_ids.npy"))


def _assert_same_artifacts(root, expt, jax_expt):
    """fp16 embeddings within EMBED_ATOL, equal ids, and the same ids in the
    same order in every run file with the same Recall values in the TSV."""
    _assert_same_embeddings(root, expt, jax_expt)
    assert _run_rows(root, expt) == _run_rows(root, jax_expt)
    assert _tsv(root, expt) == _tsv(root, jax_expt)


# The search scores an L2-normalised query against the L2-normalised fp16 index in bf16 with fp32 sums.  Two
# runs whose fp16 embeddings differ by one fp16 step (2**-10 relative) in an element can differ there after
# normalisation and bf16 rounding by one bf16 step (2**-8 relative) in each factor: for unit vectors the
# score moves by at most 2 * (2**-8 + 2**-10) * sum|q_i c_i| <= 2 * (2**-8 + 2**-10).
SCORE_BOUND = 2 * (2**-8 + 2**-10)


def _run_scores(root, expt):
    run_dir = os.path.join(root, "retrieval_results", expt, "run_files")
    out = {}
    for name in sorted(os.listdir(run_dir)):
        with open(os.path.join(run_dir, name)) as f:
            rows = [line.split() for line in f]
        per_query = {}
        for r in rows:
            per_query.setdefault(r[0], []).append((r[2], float(r[4])))
        out[name] = per_query
    return out


def _assert_same_ids_past_near_ties(root, expt, jax_expt):
    """Every run file of `expt` against `jax_expt`'s, query by query: delta is the largest score difference
    of an id both return, and is held to SCORE_BOUND.  Where two of the JAX run's neighbouring scores are
    more than 2 * delta apart, no difference of delta can reorder them, so the ids above that cut are the
    same set in both; an id only one run returns scores within 2 * delta of the other run's last."""
    ours, ref = _run_scores(root, expt), _run_scores(root, jax_expt)
    assert ours.keys() == ref.keys()
    for name in ref:
        assert ours[name].keys() == ref[name].keys()
        for qid, want in ref[name].items():
            got = ours[name][qid]
            assert len(got) == len(want)
            got_score, want_score = dict(got), dict(want)
            common = got_score.keys() & want_score.keys()
            delta = max(abs(got_score[d] - want_score[d]) for d in common)
            assert delta <= SCORE_BOUND, (name, qid, delta)
            for i in range(1, len(want)):
                if want[i - 1][1] - want[i][1] > 2 * delta:
                    assert {d for d, _ in got[:i]} == {d for d, _ in want[:i]}, (name, qid, i)
            assert all(s <= want[-1][1] + 2 * delta for d, s in got if d not in want_score), (name, qid)
            assert all(s <= got[-1][1] + 2 * delta for d, s in want if d not in got_score), (name, qid)


def _jax_pipeline(root, jax_bundle, expt):
    config = _config(root, expt, embed_dim=jax_bundle.embed_dim)
    jax_embed(jax_bundle, config)
    jax_create_index(config)
    jax_run_retrieval(config)


def _port_pipeline(root, bundle, expt, pool_dtype):
    config = _config(root, expt, pool_dtype, embed_dim=bundle.embed_dim)
    assert len(generate_embeds_for_config(bundle, config)) == 8
    assert len(create_index(config)) == 2
    stats = []
    assert run_retrieval(config, device="cpu", stats_out=stats)
    assert stats and all(s["pool_dtype"] == pool_dtype for s in stats)


CLIP_FF_JAX_EXPT = "CLIP_FF/TinyJax/NoInstruct/InBatch/"


def tiny_clip_ff_bundle():
    """fp32 test-tiny-ff CLIP-FF in the JAX package, with a tokenizer of stable word ids."""
    from uniir_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
    from uniir_tpu.models.clip_ff import CLIPFeatureFusion as JaxCLIPFF
    from uniir_tpu.models.registry import ModelBundle as JaxModelBundle

    cfg = JAX_CONFIGS["test-tiny-ff"]
    model = JaxCLIPFF(cfg)
    tok = stable_tokenizer(max_len=cfg.context_length, vocab_size=cfg.vocab_size)
    img_fn = identity_image_transform(cfg.image_size)
    ones = np.ones(2, np.int32)
    params = model.init(jax.random.PRNGKey(0), tok(["x", "y"]), np.zeros((2, cfg.image_size, cfg.image_size, 3), np.float32),
                        ones, ones)["params"]
    return JaxModelBundle("CLIPFeatureFusion", model, jax.tree_util.tree_map(np.asarray, params), tok, img_fn, img_fn,
                          (cfg.image_size, cfg.image_size), cfg.embed_dim)


@pytest.fixture(scope="module")
def clip_ff_trees(trees):
    root, _ = trees
    jax_bundle = tiny_clip_ff_bundle()
    _jax_pipeline(root, jax_bundle, CLIP_FF_JAX_EXPT)
    return root, jax_bundle


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int8_bucket"])
def test_port_clip_ff_pipeline_matches_jax(clip_ff_trees, pool_dtype):
    """CLIP-FF through the same entry points; the per-bucket int8 pool (the
    sweep K11 serves on a card) retrieves the same ids as the JAX run.  The
    seeded fusion nearly collapses the rows: scores sit near 0.99 and two
    neighbours of one query can be 3.8e-5 apart, less than one fp16 step of
    one embedding value moves a score, so the end-to-end order is not a
    property of either package.  The index and the search are held exactly
    on the JAX run's own embedding files, and the end-to-end run files past
    the near ties (`_assert_same_ids_past_near_ties`)."""
    root, jax_bundle = clip_ff_trees
    model = CLIPFeatureFusion(CLIP_CONFIGS["test-tiny-ff"])
    model.load_state_dict(state_dict_from_jax(jax_bundle.params))
    bundle = ModelBundle("CLIPFeatureFusion", model.eval(), jax_bundle.tokenizer, on_array(jax_bundle.img_preprocess_fn),
                         on_array(jax_bundle.img_preprocess_fn_eval), jax_bundle.image_size, jax_bundle.embed_dim)
    expt = f"CLIP_FF/TinyTorch-{pool_dtype}/NoInstruct/InBatch/"
    _port_pipeline(root, bundle, expt, pool_dtype)
    _assert_same_embeddings(root, expt, CLIP_FF_JAX_EXPT)
    # the index and the search on shared inputs, held exactly: the JAX run's own embedding files
    shared = f"CLIP_FF/TorchOnJaxEmbeds-{pool_dtype}/NoInstruct/InBatch/"
    shutil.copytree(os.path.join(root, "embed", CLIP_FF_JAX_EXPT), os.path.join(root, "embed", shared))
    config = _config(root, shared, pool_dtype, embed_dim=bundle.embed_dim)
    assert len(create_index(config)) == 2
    assert run_retrieval(config, device="cpu")
    assert _run_rows(root, shared) == _run_rows(root, CLIP_FF_JAX_EXPT)
    assert _tsv(root, shared) == _tsv(root, CLIP_FF_JAX_EXPT)
    # end to end, the order is held wherever the scores decide it past the two runs' own differences
    _assert_same_ids_past_near_ties(root, expt, CLIP_FF_JAX_EXPT)


BLIP_FF_JAX_EXPT = "BLIP_FF/TinyJax/NoInstruct/InBatch/"


def tiny_blip_ff_bundle():
    """fp32 test-tiny BLIP-FF in the JAX package, with a BERT-style tokenizer of stable word ids."""
    from uniir_tpu.models.blip_ff import BLIPFeatureFusion as JaxBLIPFF
    from uniir_tpu.models.blip_vit import BLIP_VIT_CONFIGS as JAX_VIT
    from uniir_tpu.models.med import MED_CONFIGS as JAX_MED
    from uniir_tpu.models.registry import ModelBundle as JaxModelBundle

    vit, med = JAX_VIT["test-tiny"], JAX_MED["test-tiny"]
    model = JaxBLIPFF(vit_cfg=vit, med_cfg=med)
    tok = stable_bert_tokenizer(max_len=16, vocab_size=97)
    img_fn = identity_image_transform(vit.image_size)
    ones = np.ones(2, np.int32)
    params = model.init(jax.random.PRNGKey(0), tok(["x", "y"]), np.zeros((2, vit.image_size, vit.image_size, 3), np.float32),
                        ones, ones)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, params)
    for name in ("cls_token", "pos_embed"):  # zero-initialised in flax: give them values so positions matter
        params["visual_encoder"][name] = (0.02 * rng.standard_normal(params["visual_encoder"][name].shape)).astype(np.float32)
    return JaxModelBundle("BLIPFeatureFusion", model, params, tok, img_fn, img_fn, (vit.image_size, vit.image_size),
                          med.hidden_size)


@pytest.fixture(scope="module")
def blip_ff_trees(trees):
    root, _ = trees
    jax_bundle = tiny_blip_ff_bundle()
    _jax_pipeline(root, jax_bundle, BLIP_FF_JAX_EXPT)
    return root, jax_bundle


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8_bucket"])
def test_port_blip_ff_pipeline_matches_jax(blip_ff_trees, pool_dtype):
    root, jax_bundle = blip_ff_trees
    model = BLIPFeatureFusion(BLIP_VIT_CONFIGS["test-tiny"], MED_CONFIGS["test-tiny"])
    model.load_state_dict(state_dict_from_jax(jax_bundle.params))
    bundle = ModelBundle("BLIPFeatureFusion", model.eval(), jax_bundle.tokenizer, on_array(jax_bundle.img_preprocess_fn),
                         on_array(jax_bundle.img_preprocess_fn_eval), jax_bundle.image_size, jax_bundle.embed_dim)
    expt = f"BLIP_FF/TinyTorch-{pool_dtype}/NoInstruct/InBatch/"
    _port_pipeline(root, bundle, expt, pool_dtype)
    _assert_same_artifacts(root, expt, BLIP_FF_JAX_EXPT)


def test_no_device_named_and_no_card_raises(monkeypatch):
    """The card is the default device: without one, an entry point that was
    given no device raises and says how to ask for the CPU; it never carries
    on there unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = Config.from_dict({"model": {"name": "CLIPScoreFusion", "clip_vision_model_name": "test-tiny"}})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model_from_config(config)
    index = DenseIndex(np.eye(4, 16, dtype=np.float16), np.arange(4, dtype=np.int64))
    with pytest.raises(RuntimeError, match="--device cpu"):
        search_dense_index(np.ones((2, 16), np.float32), index, 2)
    scores, ids = search_dense_index(np.ones((2, 16), np.float32), index, 2, device="cpu")  # asked for: runs
    assert scores.shape == ids.shape == (2, 2)


def test_index_files_interoperate(trees):
    """The port reads the JAX package's .index files (same npz format)."""
    root, _ = trees
    path = os.path.join(root, "index", JAX_EXPT, "cand_pool", "mbeir_mscoco_task0_cand_pool.index")
    index = DenseIndex.load(path)
    assert index.embeds.dtype == np.float16 and index.ntotal == 24
    norms = np.linalg.norm(index.embeds.astype(np.float32), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_embed_loop_over_collated_batches():
    """generate_embeds_and_ids_for_dataset takes any iterable of collated
    batches and trims the padded tail by n_valid."""
    cfg = CLIP_CONFIGS["test-tiny"]
    model = CLIPScoreFusion(cfg).eval()
    rng = np.random.default_rng(0)

    def batch(ids, n_valid):
        n = 4
        txt = rng.integers(1, cfg.vocab_size - 1, (n, cfg.context_length)).astype(np.int32)
        txt[:, -1] = cfg.vocab_size - 1
        return {
            "txt_batched": txt,
            "image_batched": rng.random((n, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
            "txt_mask_batched": np.ones(n, np.int32),
            "image_mask_batched": np.ones(n, np.int32),
            "did_list": np.asarray(ids, np.int64),
            "n_valid": np.int32(n_valid),
        }

    emb, ids = generate_embeds_and_ids_for_dataset(make_embed_step(model), [batch([1, 2, 3, 4], 4), batch([5, 6, 6, 6], 2)])
    assert emb.shape == (6, cfg.embed_dim) and emb.dtype == np.float16
    np.testing.assert_array_equal(ids, [1, 2, 3, 4, 5, 6])


def test_registry_tables_match_jax():
    assert port_registry.MBEIR_TASK == JAX_MBEIR_TASK
    for qid in ["9:0", "0:499999", "7:123"]:
        assert port_registry.hash_qid(qid) == jax_hash_qid(qid)
        assert port_registry.unhash_qid(port_registry.hash_qid(qid)) == qid
        assert port_registry.hash_did(qid) == jax_hash_did(qid)
        assert port_registry.unhash_did(port_registry.hash_did(qid)) == qid


def test_config_interpolation_matches_jax():
    from uniir_tpu.core.config import Config as JaxConfig

    d = {"model": {"short_name": "CLIP_SF", "size": "Large"}, "experiment": {"path_suffix": "${model.short_name}/${model.size}/"},
         "n": "${k}", "k": 7}
    ours, ref = Config.from_dict(d), JaxConfig.from_dict(d)
    assert ours.to_dict() == ref.to_dict()
    assert ours.experiment.path_suffix == "CLIP_SF/Large/" and ours.n == 7


def test_pipeline_cli_index_and_retrieval(trees, tmp_path):
    """tools/pipeline.py runs index + retrieval from a YAML config over the JAX
    embeddings, then hard-negative mining and the error analyst over them."""
    import shutil

    from uniir_tpu_torch.core.config import save_config
    from uniir_tpu_torch.tools.pipeline import main

    root, _ = trees
    expt = "CLIP_SF/TinyCli/NoInstruct/InBatch/"
    shutil.copytree(os.path.join(root, "embed", JAX_EXPT), os.path.join(root, "embed", expt))
    config = _config(root, expt, "int8")
    path = str(tmp_path / "retrieval.yaml")
    save_config(Config.from_dict(config.to_dict(resolve=False)), path)
    main(["--config_path", path, "--uniir_dir", root, "--mbeir_data_dir", os.path.join(root, "mbeir_data"),
          "--enable_create_index", "--enable_retrieval", "--device", "cpu"])
    assert _tsv(root, expt) == _tsv(root, JAX_EXPT)
    main(["--config_path", path, "--uniir_dir", root, "--mbeir_data_dir", os.path.join(root, "mbeir_data"),
          "--enable_hard_negative_mining", "--run_automatic_error_analysis", "--device", "cpu"])
    mined = os.path.join(root, "mbeir_data", "train", "hard_negs", "mbeir_mscoco_task0_hard_negs_train.jsonl")
    with open(mined) as f:
        assert len(f.readlines()) == 12
    assert len(os.listdir(os.path.join(root, "retrieval_results", expt, "error_tsv"))) == 1
