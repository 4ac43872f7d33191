"""The retrieval tools in the JAX package and in the port, on one miniature
M-BEIR tree: the interactive retriever, raw retrieval with complement pairs
(UniRAG), hard-negative mining, the error analyst, `search_index`, the
config updater, the pipeline CLI's stages and the profiling helpers.

The JAX bundle is `tiny_clip_bundle` (fp32 test-tiny); the port gets the same
weights through `state_dict_from_jax`, the same tokenizer and image
transform, and the tree's own JPEGs.  Query instructions are off so both
embed the same text.  The JAX package and the tree's helpers are imported in
the fixtures, so the `-m gpu` cases at the end collect on a machine without
JAX (`--noconftest`).
"""

import json
import os
import shutil
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uniir_tpu_torch.core.config import Config, save_config
from uniir_tpu_torch.data import registry as port_registry
from uniir_tpu_torch.data.dataset import load_jsonl, save_jsonl
from uniir_tpu_torch.models.clip import CLIP_CONFIGS
from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion
from uniir_tpu_torch.models.registry import ModelBundle, seeded_clip_sf
from uniir_tpu_torch.ops import topk as T
from uniir_tpu_torch.ops.attention import attention
from uniir_tpu_torch.retrieval.analyst import run_automatic_error_analysis
from uniir_tpu_torch.retrieval.embedder import generate_embeds_for_config
from uniir_tpu_torch.retrieval.eval import run_retrieval
from uniir_tpu_torch.retrieval.hard_negs import run_hard_negative_mining
from uniir_tpu_torch.retrieval.index import DenseIndex, create_index
from uniir_tpu_torch.retrieval.interactive import InteractiveRetriever
from uniir_tpu_torch.retrieval.search import search_index
from uniir_tpu_torch.tools import config_updater
from uniir_tpu_torch.train.steps import make_embed_step
from uniir_tpu_torch.utils.profiling import StepTimer, annotate, device_memory_stats, trace

JAX_EXPT = "CLIP_SF/ToolsJax/NoInstruct/InBatch/"
PORT_EXPT = "CLIP_SF/ToolsTorch/NoInstruct/InBatch/"
# fp32 towers that differ only in summation order
EMBED_ATOL = 1e-4
# bf16 products with fp32 sums in both packages, in another order
SCORE_ATOL = 1e-6
QUERIES = {
    "text": [("text", "red dress photo", None, "image"), ("text", "cat on a street", None, "text")],
    "image": [("image", None, "images/cand_1.jpg", "text"), ("image", None, "images/query_0.jpg", "image")],
    "image,text": [("image,text", "blue shirt", "images/cand_3.jpg", "image"),
                   ("image,text", "city news", "images/query_3.jpg", "text")],
}


def _config(root, expt):
    from tests.helpers import make_eval_config

    config = make_eval_config(root)
    config.data_config.enable_query_instruct = False
    config.experiment.path_suffix = expt
    return config


def _raw_config(root, expt, pairs: bool):
    """retrieval.yaml of a UniRAG run: raw retrieval of the test split over the
    local pool (whose jsonl has no split name) and the union pool (whose has)."""
    config = _config(root, expt)
    rc = config.retrieval_config
    rc.raw_retrieval = True
    rc.retrieve_image_text_pairs = pairs
    rc.results_dir_name = f"raw_results_{'pairs' if pairs else 'plain'}"
    rc.train_datasets_config.enable_retrieve = False
    return config


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The tree, the JAX pipeline's artifacts under JAX_EXPT and the port's
    under PORT_EXPT, and both bundles."""
    import jax

    from tests.helpers import build_pipeline_tree, tiny_clip_bundle
    from uniir_tpu.retrieval.embedder import generate_embeds_for_config as jax_embed
    from uniir_tpu.retrieval.eval import run_retrieval as jax_run_retrieval
    from uniir_tpu.retrieval.index import create_index as jax_create_index
    from uniir_tpu_torch.models.convert import state_dict_from_jax

    root = str(tmp_path_factory.mktemp("torch_tools"))
    mbeir = build_pipeline_tree(root)
    # prompts for the image+text queries, and the union pool's jsonl under its split name
    with open(os.path.join(mbeir, "instructions", "query_instructions.tsv"), "a") as f:
        for cmod in ("image", "text"):
            f.write(f"image,text\t{cmod}\ttest\t9\tfind the {cmod} for this image and text\tretrieve {cmod}\n")
    shutil.copy(os.path.join(mbeir, "cand_pool", "union_pool", "mbeir_union_test_cand_pool.jsonl"),
                os.path.join(mbeir, "cand_pool", "local", "mbeir_union_test_cand_pool.jsonl"))

    jax_bundle = tiny_clip_bundle()
    model = CLIPScoreFusion(CLIP_CONFIGS["test-tiny"])
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_bundle.params)))
    bundle = ModelBundle("CLIPScoreFusion", model.eval(), jax_bundle.tokenizer, jax_bundle.img_preprocess_fn,
                         jax_bundle.img_preprocess_fn_eval, jax_bundle.image_size, jax_bundle.embed_dim)

    jax_config, port_config = _config(root, JAX_EXPT), _config(root, PORT_EXPT)
    jax_embed(jax_bundle, jax_config)
    jax_create_index(jax_config)
    jax_run_retrieval(jax_config)
    generate_embeds_for_config(bundle, port_config)
    create_index(port_config)
    run_retrieval(port_config, device="cpu")
    return SimpleNamespace(root=root, mbeir=mbeir, jax_bundle=jax_bundle, bundle=bundle,
                           jax_config=jax_config, port_config=port_config)


def _index_path(root, expt, pool="mscoco_task0"):
    return os.path.join(root, "index", expt, "cand_pool", f"mbeir_{pool}_cand_pool.index")


def _retrievers(trees):
    from uniir_tpu.retrieval.interactive import InteractiveRetriever as JaxInteractiveRetriever

    cands = os.path.join(trees.mbeir, "cand_pool", "local", "mbeir_mscoco_task0_cand_pool.jsonl")
    ours = InteractiveRetriever(_index_path(trees.root, PORT_EXPT), cands, "MSCOCO", trees.port_config,
                                bundle=trees.bundle, device="cpu")
    ref = JaxInteractiveRetriever(_index_path(trees.root, JAX_EXPT), cands, "MSCOCO", trees.jax_config,
                                  bundle=trees.jax_bundle)
    return ours, ref


@pytest.mark.parametrize("modality", list(QUERIES))
def test_interactive_retriever_matches_jax(trees, modality):
    """The same candidate dicts for text, image and image+text queries, and
    the same query embeddings within EMBED_ATOL in fp32."""
    import jax.numpy as jnp

    from uniir_tpu.train.steps import make_embed_step as jax_make_embed_step

    ours, ref = _retrievers(trees)
    for retriever in (ours, ref):
        retriever.add_queries(QUERIES[modality])
    assert [q["qid"] for q in ours.queries] == [q["qid"] for q in ref.queries] == ["9:1", "9:2"]
    assert ours.queries == ref.queries
    got, want = ours.retrieve(k=5), ref.retrieve(k=5)
    assert len(got) == 2 and all(len(r) == 5 for r in got)
    assert got == want

    ours.embed_step = make_embed_step(trees.bundle.model, torch.float32)
    ref.embed_step = jax_make_embed_step(trees.jax_bundle.model, out_dtype=jnp.float32)
    emb, ref_emb = ours._embed_queries(), ref._embed_queries()
    assert emb.dtype == np.float32 and emb.shape == (2, 16)
    np.testing.assert_allclose(emb, np.asarray(ref_emb), atol=EMBED_ATOL)


BAD_QUERIES = [
    ("text", None, None, "image"),
    ("text", "a dress", "images/cand_1.jpg", "image"),
    ("image", "a dress", "images/cand_1.jpg", "text"),
    ("image", None, None, "text"),
    ("image,text", None, "images/cand_1.jpg", "text"),
    ("image,text", "a dress", None, "text"),
    ("audio", "a dress", None, "image"),
]


@pytest.mark.parametrize("query", BAD_QUERIES, ids=lambda q: f"{q[0]}-txt{q[1] is not None}-img{q[2] is not None}")
def test_interactive_retriever_refuses_bad_queries(trees, query):
    """The JAX retriever asserts (or raises ValueError); the port raises ValueError."""
    ours, ref = _retrievers(trees)
    with pytest.raises((AssertionError, ValueError)):
        ref.add_queries([query])
    with pytest.raises(ValueError):
        ours.add_queries([query])
    assert ours.queries == ref.queries == []


def test_interactive_retriever_refuses_repeated_dids(trees, tmp_path):
    from uniir_tpu.retrieval.interactive import InteractiveRetriever as JaxInteractiveRetriever

    entries = load_jsonl(os.path.join(trees.mbeir, "cand_pool", "local", "mbeir_mscoco_task0_cand_pool.jsonl"))
    path = str(tmp_path / "cands.jsonl")
    with open(path, "w") as f:
        for e in entries + entries[:1]:
            f.write(json.dumps(e) + "\n")
    with pytest.raises(AssertionError, match="unique"):
        JaxInteractiveRetriever(_index_path(trees.root, JAX_EXPT), path, "MSCOCO", trees.jax_config, bundle=trees.jax_bundle)
    with pytest.raises(ValueError, match="unique"):
        InteractiveRetriever(_index_path(trees.root, PORT_EXPT), path, "MSCOCO", trees.port_config,
                             bundle=trees.bundle, device="cpu")


def _retrieved(root, config):
    """run id -> the rows of its retrieved jsonl."""
    rc = config.retrieval_config
    out_dir = os.path.join(root, rc.results_dir_name, config.experiment.path_suffix, "retrieved_candidates")
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            out[name] = [json.loads(line) for line in f]
    return out


def _run_jax_raw(trees, pairs):
    from uniir_tpu.retrieval.eval import run_retrieval as jax_run_retrieval

    config = _raw_config(trees.root, JAX_EXPT, pairs)
    jax_run_retrieval(config, query_embedder_config=trees.jax_config if pairs else None,
                      bundle=trees.jax_bundle if pairs else None)
    return _retrieved(trees.root, config)


@pytest.mark.parametrize("pairs", [False, True], ids=["candidates", "complement_pairs"])
def test_raw_retrieval_matches_jax(trees, pairs):
    """The retrieved jsonl of both pools equals JAX's row for row, with and
    without `complement_candidates`."""
    ref = _run_jax_raw(trees, pairs)
    config = _raw_config(trees.root, PORT_EXPT, pairs)
    run_retrieval(config, device="cpu", query_embedder_config=trees.port_config if pairs else None,
                  bundle=trees.bundle if pairs else None)
    got = _retrieved(trees.root, config)
    assert sorted(got) == ["mbeir_mscoco_task0_single_pool_test_k10_retrieved.jsonl",
                           "mbeir_mscoco_task0_union_pool_test_k10_retrieved.jsonl"]
    assert got == ref
    for rows in got.values():
        assert len(rows) == 12 and all(len(r["candidates"]) == 10 for r in rows)
        assert all(("complement_candidates" in r) == pairs for r in rows)
    if pairs:
        flips = {"text": "image", "image": "text"}
        comps = [(c, comp) for rows in got.values() for r in rows for c, comp in zip(r["candidates"], r["complement_candidates"])]
        assert comps and all(comp is None or comp["modality"] == flips[c["modality"]] for c, comp in comps)


class FixedRetriever:
    """A complement retriever that answers with fixed candidate lists and
    records what it was asked."""

    def __init__(self, answers):
        self.answers, self.queries, self.k = answers, [], None

    def add_queries(self, queries):
        self.queries.extend(queries)

    def retrieve(self, k=1, batch_size=100):
        self.k = k
        return self.answers[: len(self.queries)]


def test_complement_selection_matches_jax(tmp_path):
    """The complement rules on fixed answers: only text / image candidates are
    sent, at k = 10; the first hit of the other modality is taken unless it is
    the query's own image or text; None where there is none."""
    from uniir_tpu.retrieval.eval import get_raw_retrieved_candidates as jax_raw
    from uniir_tpu_torch.retrieval.eval import get_raw_retrieved_candidates

    cands = [{"did": "9:0", "modality": "text", "txt": "a cat"},
             {"did": "9:1", "modality": "image", "img_path": "images/1.jpg"},
             {"did": "9:2", "modality": "image,text", "txt": "a dog", "img_path": "images/2.jpg"},
             {"did": "9:3", "modality": "image", "img_path": "images/q.jpg"},
             {"did": "9:4", "modality": "text", "txt": "my own words"},
             {"did": "9:5", "modality": "text", "txt": "a bird"}]
    queries = [{"qid": "9:1", "query_modality": "image,text", "query_txt": "my own words", "query_img_path": "images/q.jpg"},
               {"qid": "9:2", "query_modality": "text", "query_txt": "a cat"}]
    save_jsonl(cands, str(tmp_path / "cands.jsonl"))
    save_jsonl(queries, str(tmp_path / "queries.jsonl"))
    h = port_registry.hash_did
    retrieved = [[h("9:0"), h("9:1"), h("9:2")], [h("9:1"), h("9:5")]]
    qids = [port_registry.hash_qid(q["qid"]) for q in queries]
    by = {c["did"]: c for c in cands}
    answers = [
        [by["9:0"], by["9:3"], by["9:1"]],  # for "a cat" (text): the query's own image skipped
        [by["9:1"], by["9:4"], by["9:5"]],  # for images/1.jpg: the query's own text skipped
        [by["9:2"], by["9:0"]],  # for images/1.jpg again: only the query's own text -> None
        [by["9:2"], by["9:1"]],  # for "a bird": the first image hit
    ]
    results = []
    for fn in (jax_raw, get_raw_retrieved_candidates):
        fixed = FixedRetriever(answers)
        results.append(fn(str(tmp_path / "queries.jsonl"), str(tmp_path / "cands.jsonl"), retrieved, qids, fixed))
        assert fixed.k == 10
        assert fixed.queries == [("text", "a cat", None, "image"), ("image", None, "images/1.jpg", "text"),
                                 ("image", None, "images/1.jpg", "text"), ("text", "a bird", None, "image")]
    assert results[1] == results[0]
    assert results[1]["9:1"]["complement_candidates"] == [by["9:1"], by["9:5"]]
    assert results[1]["9:2"]["complement_candidates"] == [None, by["9:1"]]


def _hard_negs(trees):
    with open(os.path.join(trees.mbeir, "train", "hard_negs", "mbeir_mscoco_task0_hard_negs_train.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_hard_negative_mining_matches_jax(trees):
    """The written jsonl equals JAX's entry for entry; no mined negative is a
    positive and every list grew by num_hard_negs."""
    from uniir_tpu.retrieval.hard_negs import run_hard_negative_mining as jax_mine

    jax_mine(trees.jax_config)
    ref = _hard_negs(trees)
    path = run_hard_negative_mining(trees.port_config, device="cpu")
    assert path.endswith("train/hard_negs/mbeir_mscoco_task0_hard_negs_train.jsonl")
    got = _hard_negs(trees)
    assert got == ref
    orig = load_jsonl(os.path.join(trees.mbeir, "train", "mbeir_mscoco_task0_train.jsonl"))
    assert len(got) == len(orig) == 12
    for m, o in zip(got, orig):
        assert len(m["neg_cand_list"]) == len(o["neg_cand_list"]) + 3
        assert not set(m["neg_cand_list"][len(o["neg_cand_list"]):]) & set(m["pos_cand_list"])


def _error_tsv(root, expt):
    tsv_dir = os.path.join(root, "retrieval_results", expt, "error_tsv")
    (name,) = os.listdir(tsv_dir)
    with open(os.path.join(tsv_dir, name)) as f:
        return f.read()


def test_error_analyst_matches_jax(trees):
    from uniir_tpu.retrieval.analyst import run_automatic_error_analysis as jax_analyst

    ref = jax_analyst(trees.jax_config)
    got = run_automatic_error_analysis(trees.port_config)
    assert got == ref and got
    assert all(0.0 <= r[t] <= 1.0 for r in got for t in ("Type1", "Type2", "Type3"))
    assert _error_tsv(trees.root, PORT_EXPT) == _error_tsv(trees.root, JAX_EXPT)


def test_error_analyst_reads_a_flat_qrel_directory(trees, tmp_path):
    """Where `qrels/<split>/` lacks the file, the analyst reads `qrels/` itself,
    in both packages, and refuses a query whose modality disagrees with its task."""
    from uniir_tpu.retrieval.analyst import run_automatic_error_analysis as jax_analyst

    flat = os.path.join(trees.mbeir, "qrels_flat")
    os.makedirs(flat, exist_ok=True)
    shutil.copy(os.path.join(trees.mbeir, "qrels", "test", "mbeir_mscoco_task0_test_qrels.txt"), flat)
    jax_config, port_config = _config(trees.root, JAX_EXPT), _config(trees.root, PORT_EXPT)
    for config in (jax_config, port_config):
        config.analysis_config.qrel_dir_name = "qrels_flat"
        config.analysis_config.write_to_tsv = False
    assert run_automatic_error_analysis(port_config) == jax_analyst(jax_config)

    from uniir_tpu_torch.retrieval.analyst import analyze_run

    query = {"qid": "9:0", "query_modality": "image", "pos_cand_list": ["9:0"]}
    with pytest.raises(ValueError, match="modality"):
        analyze_run([query], {"9:0": [{"rank": 1, "did": "9:1"}]}, {"9:1": {"modality": "image"}}, {"9:0": "0"})


def test_load_run_file_matches_jax(trees):
    from uniir_tpu.retrieval.eval import load_run_file as jax_load_run_file
    from uniir_tpu_torch.retrieval.eval import load_run_file

    run_dir = os.path.join(trees.root, "retrieval_results", PORT_EXPT, "run_files")
    for name in sorted(os.listdir(run_dir)):
        run = load_run_file(os.path.join(run_dir, name))
        assert run == jax_load_run_file(os.path.join(run_dir, name))
        assert len(run) == 12 and all(len(dids) in (5, 10) for dids in run.values())


def test_search_index_matches_jax(trees):
    from uniir_tpu.retrieval.search import search_index as jax_search_index

    queries = os.path.join(trees.root, "embed", JAX_EXPT, "test", "mbeir_mscoco_task0_test_embed.npy")
    index = _index_path(trees.root, JAX_EXPT)
    scores, ids = search_index(queries, index, batch_size=5, num_cand_to_retrieve=7, device="cpu")
    ref_scores, ref_ids = jax_search_index(queries, index, batch_size=5, num_cand_to_retrieve=7)
    assert scores.shape == ids.shape == (12, 7)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))
    np.testing.assert_allclose(scores, np.asarray(ref_scores), atol=SCORE_ATOL)


YAML_DOCS = {
    "with_data_config": {"experiment": {"instruct_status": "NoInstruct", "exp_name": "InBatch"},
                         "data_config": {"enable_query_instruct": False, "image_size": "224, 224"},
                         "model": {"name": "CLIPScoreFusion"}},
    "without_data_config": {"experiment": {"instruct_status": "Instruct"}, "index_config": {"embed_dir_name": "embed"}},
}


@pytest.mark.parametrize("enable", [True, False])
@pytest.mark.parametrize("doc", list(YAML_DOCS))
def test_config_updater_matches_jax(tmp_path, doc, enable):
    """The same yaml text as JAX's updater, through the function and the CLI."""
    import yaml

    from uniir_tpu.tools.config_updater import update_mbeir_yaml_instruct_status as jax_update

    paths = [tmp_path / name for name in ("jax.yaml", "port.yaml", "cli.yaml")]
    for p in paths:
        p.write_text(yaml.safe_dump(YAML_DOCS[doc]))
    jax_update(str(paths[0]), enable)
    config_updater.update_mbeir_yaml_instruct_status(str(paths[1]), enable)
    config_updater.main(["--update_mbeir_yaml_instruct_status", "--mbeir_yaml_file_path", str(paths[2]),
                         "--enable_instruct", str(enable)])
    assert paths[1].read_text() == paths[0].read_text() == paths[2].read_text()
    data = yaml.safe_load(paths[1].read_text())
    assert data["experiment"]["instruct_status"] == ("Instruct" if enable else "NoInstruct")
    assert data.get("data_config", {}).get("enable_query_instruct", enable) is enable


def _save(config, path):
    save_config(Config.from_dict(config.to_dict(resolve=False)), str(path))
    return str(path)


def _cli(trees, config_path, *flags):
    from uniir_tpu_torch.tools.pipeline import main

    main(["--config_path", config_path, "--uniir_dir", trees.root, "--mbeir_data_dir", trees.mbeir,
          *flags, "--device", "cpu"])


def test_pipeline_cli_hard_negative_mining_matches_jax_stage(trees, tmp_path):
    from uniir_tpu.retrieval.hard_negs import run_hard_negative_mining as jax_mine

    jax_mine(trees.jax_config)
    ref = _hard_negs(trees)
    _cli(trees, _save(trees.port_config, tmp_path / "retrieval.yaml"), "--enable_hard_negative_mining")
    assert _hard_negs(trees) == ref


def test_pipeline_cli_error_analysis_matches_jax_stage(trees, tmp_path):
    from uniir_tpu.retrieval.analyst import run_automatic_error_analysis as jax_analyst

    jax_analyst(trees.jax_config)
    shutil.rmtree(os.path.join(trees.root, "retrieval_results", PORT_EXPT, "error_tsv"), ignore_errors=True)
    _cli(trees, _save(trees.port_config, tmp_path / "retrieval.yaml"), "--run_automatic_error_analysis")
    assert _error_tsv(trees.root, PORT_EXPT) == _error_tsv(trees.root, JAX_EXPT)


def test_pipeline_cli_query_embedder_config_matches_jax_stage(trees, tmp_path, monkeypatch):
    """`--query_embedder_config_path` names the complement retriever's model:
    the CLI builds it from that file on `--device` (here the registry hands
    back the tiny bundle, which has no published checkpoint) and writes JAX's
    retrieved jsonl."""
    from uniir_tpu_torch.models import registry

    built = []

    def build(config, device=None, train=False):
        built.append((config.experiment.path_suffix, str(device), train))
        return trees.bundle

    monkeypatch.setattr(registry, "build_model_from_config", build)
    ref = _run_jax_raw(trees, pairs=True)
    config = _raw_config(trees.root, PORT_EXPT, pairs=True)
    config.retrieval_config.results_dir_name = "raw_results_cli"
    embedder = _config(trees.root, PORT_EXPT)
    embedder.experiment.path_suffix = "CLIP_SF/QueryEmbedder/"
    _cli(trees, _save(config, tmp_path / "retrieval.yaml"), "--enable_retrieval",
         "--query_embedder_config_path", _save(embedder, tmp_path / "embed.yaml"))
    assert built == [("CLIP_SF/QueryEmbedder/", "cpu", False)] * 2  # one complement retriever a pool
    assert _retrieved(trees.root, config) == ref


def test_profiling_trace_annotate_and_timer(tmp_path):
    """`trace` writes a Chrome trace holding the annotated region; `StepTimer`
    times a block; no card, no memory stats."""
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        with annotate("tools-matmul"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    (name,) = os.listdir(log_dir)
    assert name.endswith(".json") and "tools-matmul" in (log_dir / name).read_text()
    timer = StepTimer()
    with timer:
        sum(range(100_000))
    assert timer.elapsed > 0
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


def test_registry_lookup_tables():
    assert port_registry.get_dataset_id("MSCOCO") == 9 and port_registry.get_dataset_id("nope") is None
    assert port_registry.get_dataset_name("9:17") == "MSCOCO" and port_registry.get_dataset_name("42:1") is None
    assert port_registry.get_mbeir_query_modality_cand_modality_from_task_id(7) == ["image,text", "image"]
    assert port_registry.get_mbeir_query_modality_cand_modality_from_task_id(11) is None


# ------------------------------------------------------------------ on the card


@pytest.fixture(scope="module")
def card_tree(tmp_path_factory):
    """Seeded CLIP-SF ViT-L/14 at full width and depth 2 + 2 in bf16 on the
    card, hash tokens, and an M-BEIR tree of 96 candidates (text, image,
    image+text) written without image files: the candidates are embedded
    from seeded arrays and no query reaches an image."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from chip_smoke import collate_rows, hash_tokenize, make_items

    cfg = replace(CLIP_CONFIGS["ViT-L/14"], vision_layers=2, text_layers=2)
    model = seeded_clip_sf(cfg, "cuda", seed=0)
    bundle = ModelBundle("CLIPScoreFusion", model, lambda t: hash_tokenize(t, cfg.context_length, cfg.vocab_size),
                         None, None, (cfg.image_size,) * 2, cfg.embed_dim)
    root = str(tmp_path_factory.mktemp("torch_tools_card"))
    mbeir = os.path.join(root, "mbeir_data")
    items = make_items(np.random.default_rng(0), 96, cfg.image_size)
    modality = {(1, 0): "text", (0, 1): "image", (1, 1): "image,text"}
    cands = []
    for i, (txt, _, tm, im) in enumerate(items):
        entry = {"did": f"9:{i}", "modality": modality[(tm, im)]}
        entry.update({"txt": txt} if tm else {})
        entry.update({"img_path": f"images/cand_{i}.jpg"} if im else {})
        cands.append(entry)
    save_jsonl(cands, os.path.join(mbeir, "cand_pool", "mbeir_mscoco_task0_cand_pool.jsonl"))
    os.makedirs(os.path.join(mbeir, "instructions"))
    with open(os.path.join(mbeir, "instructions", "query_instructions.tsv"), "w") as f:
        f.write("query_modality\tcand_modality\tdataset\tdataset_id\tprompt1\n")
        for qm in ("text", "image", "image,text"):
            for cm in ("text", "image", "image,text"):
                f.write(f"{qm}\t{cm}\tMSCOCO\t9\tfind the {cm} for this {qm}\n")

    step = make_embed_step(model)
    emb = torch.cat([step(collate_rows(items[i:i + 32], cfg)) for i in range(0, 96, 32)]).cpu().numpy()
    embed_dir = os.path.join(root, "embed", "Card", "cand_pool")
    os.makedirs(embed_dir)
    np.save(os.path.join(embed_dir, "mbeir_mscoco_task0_cand_pool_embed.npy"), emb)
    np.save(os.path.join(embed_dir, "mbeir_mscoco_task0_cand_pool_ids.npy"),
            np.asarray([port_registry.hash_did(c["did"]) for c in cands], np.int64))
    config = Config.from_dict({
        "uniir_dir": root, "mbeir_data_dir": mbeir, "experiment": {"path_suffix": "Card"},
        "data_config": {"image_size": "224, 224", "enable_query_instruct": False,
                        "query_instruct_path": "instructions/query_instructions.tsv"},
        "dataloader_config": {"batch_size": 32, "num_workers": 2},
        "index_config": {"embed_dir_name": "embed", "index_dir_name": "index",
                         "cand_pools_config": {"enable_idx": True, "cand_pools_name_to_idx": ["mscoco_task0"]}},
    })
    create_index(config)
    return SimpleNamespace(root=root, mbeir=mbeir, cfg=cfg, bundle=bundle, config=config, cands=cands, emb=emb)


def _card_retrieval_config(tree, **retrieval):
    d = tree.config.to_dict(resolve=False)
    d["retrieval_config"] = {
        "qrel_dir_name": "qrels", "embed_dir_name": "embed", "index_dir_name": "index", "query_dir_name": "query",
        "candidate_dir_name": "cand_pool", "results_dir_name": "results", "hard_negs_dir_name": "hard_negs",
        "write_to_tsv": True, **retrieval,
    }
    return Config.from_dict(d)


def _k1_per_batch(cfg) -> int:
    """K1 launches of one CLIP-SF embed batch: both towers run (the vision
    tower on the zero image of a text-only row), each without its last block's
    attention over every token."""
    return (cfg.vision_layers - 1) + (cfg.text_layers - 1)


@pytest.mark.gpu
def test_interactive_retriever_on_card(card_tree):
    """(a) Text queries towards both modalities: the retriever's candidates are
    those of an fp32 search over the bf16 pool of the queries embedded
    through the plain twins, ties within the two embeddings' score difference
    aside; K1 and K2 ran for it, and K2 agrees with its twin at this query
    count within 1e-5."""
    from chip_smoke import bf16_scores, brute_force_topk, path_sweeps, same_ranking, twin_embeds
    from uniir_tpu_torch.retrieval.index import normalize_l2

    tree = card_tree
    index_path = _index_path(tree.root, "Card")
    cands_path = os.path.join(tree.mbeir, "cand_pool", "mbeir_mscoco_task0_cand_pool.jsonl")
    retriever = InteractiveRetriever(index_path, cands_path, "MSCOCO", tree.config, bundle=tree.bundle, device="cuda")
    texts = [c["txt"] for c in tree.cands if c["modality"] == "text"][:6]
    retriever.add_queries([("text", t, None, "image" if i % 2 else "text") for i, t in enumerate(texts)])
    attention.launches = T.bucket_max_scores.launches = 0
    got = retriever.retrieve(k=10)
    assert attention.launches == _k1_per_batch(tree.cfg) and T.bucket_max_scores.launches == 1

    emb = retriever._embed_queries()
    plain = twin_embeds(retriever)
    cos = torch.nn.functional.cosine_similarity(torch.from_numpy(emb).float(), torch.from_numpy(plain).float(), dim=1)
    assert cos.min() >= 0.999
    index = DenseIndex.load(index_path)
    ref_scores, ref_rows = brute_force_topk(torch.from_numpy(normalize_l2(plain)).cuda(),
                                            torch.from_numpy(index.embeds).cuda().bfloat16(), index.ntotal, 10)
    tie = 2 * (bf16_scores(emb, index.embeds) - bf16_scores(plain, index.embeds)).abs().max().item() + 1e-5
    got_ids = torch.tensor([[port_registry.hash_did(c["did"]) for c in row] for row in got])
    assert same_ranking(got_ids, torch.from_numpy(index.ids[ref_rows.cpu().numpy()]), ref_scores.cpu(), tie)
    by_did = {c["did"]: c for c in tree.cands}
    assert all(c == by_did[c["did"]] for row in got for c in row)
    ((n, err, _),) = path_sweeps([emb], index.embeds, index.ntotal)
    assert n == 6 and err <= 1e-5


@pytest.mark.gpu
def test_raw_retrieval_with_complements_on_card(card_tree):
    """(b) Queries that copy the text candidates' embeddings retrieve them at
    Recall@1 through the int8 pool (K4); each complement is a text query
    (K1, then K2 over the bf16 pool).  The split-named candidate jsonl labels
    every third text row an image, so complements are found, and each is the
    rule's choice over the twins' fp32 search, ties aside; K4 is bit-equal to
    its twin and K2 within 1e-5 at the run's query counts."""
    from chip_smoke import check_complements, complement_query, path_sweeps, rag_candidates, twin_embeds

    tree = card_tree
    rag = rag_candidates(tree.cands)
    rag_path = os.path.join(tree.mbeir, "cand_pool", "mbeir_mscoco_task0_test_cand_pool.jsonl")
    save_jsonl(rag, rag_path)
    text_rows = [i for i, c in enumerate(rag) if c["modality"] == "text"]
    queries = [{"qid": f"9:{j}", "query_modality": "text", "query_txt": rag[i]["txt"],
                "pos_cand_list": [rag[i]["did"]], "neg_cand_list": []} for j, i in enumerate(text_rows)]
    save_jsonl(queries, os.path.join(tree.mbeir, "query", "test", "mbeir_mscoco_rag_test.jsonl"))
    os.makedirs(os.path.join(tree.mbeir, "qrels", "test"), exist_ok=True)
    with open(os.path.join(tree.mbeir, "qrels", "test", "mbeir_mscoco_rag_test_qrels.txt"), "w") as f:
        f.writelines(f"{q['qid']} 0 {q['pos_cand_list'][0]} 1 1\n" for q in queries)
    embed_dir = os.path.join(tree.root, "embed", "Card", "test")
    os.makedirs(embed_dir, exist_ok=True)
    np.save(os.path.join(embed_dir, "mbeir_mscoco_rag_test_embed.npy"), tree.emb[text_rows])
    np.save(os.path.join(embed_dir, "mbeir_mscoco_rag_test_ids.npy"),
            np.asarray([port_registry.hash_qid(q["qid"]) for q in queries], np.int64))
    config = _card_retrieval_config(tree, raw_retrieval=True, retrieve_image_text_pairs=True, pool_dtype="int8",
                                    test_datasets_config={
                                        "enable_retrieve": True, "datasets_name": ["mscoco_rag"],
                                        "correspond_cand_pools_name": ["mscoco_task0"],
                                        "correspond_qrels_name": ["mscoco_rag"], "correspond_metrics_name": ["Recall@1"]})
    for fn in (attention, T.bucket_max_scores, T.bucket_max_scores_i8):
        fn.launches = 0
    stats = []
    (result,) = run_retrieval(config, device="cuda", stats_out=stats, query_embedder_config=config, bundle=tree.bundle)
    n = len(queries)
    assert result["Recall@1"] == 1.0
    assert T.bucket_max_scores_i8.launches == 1
    assert T.bucket_max_scores.launches == -(-n // 100) + stats[0]["exact_reruns"]
    assert attention.launches == -(-n // 32) * _k1_per_batch(tree.cfg)
    with open(os.path.join(tree.root, "results", "Card", "retrieved_candidates",
                           "mbeir_mscoco_rag_single_pool_test_k1_retrieved.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == n
    for row, q in zip(rows, queries):
        assert [c["did"] for c in row["candidates"]] == q["pos_cand_list"]
        (comp,) = row["complement_candidates"]
        assert comp is None or comp["modality"] == "image"

    retriever = InteractiveRetriever(_index_path(tree.root, "Card"), rag_path, "MSCOCO", config, bundle=tree.bundle,
                                     device="cuda")
    retriever.add_queries([complement_query(c) for r in rows for c in r["candidates"]])
    kernel, plain = retriever._embed_queries(), twin_embeds(retriever)
    index = DenseIndex.load(_index_path(tree.root, "Card"))
    held, found, _, _ = check_complements(rows, kernel, plain, index, rag)
    assert held and found > 0
    ((_, _, equal),) = path_sweeps([tree.emb[text_rows]], index.embeds, index.ntotal, int8=True)
    ((_, err, _),) = path_sweeps([kernel], index.embeds, index.ntotal)
    assert equal and err <= 1e-5


@pytest.mark.gpu
def test_hard_negative_mining_on_card(card_tree):
    """(c) The mined negatives are those of an fp32 search of the same bf16
    values, differing only where the search's neighbouring scores tie; none
    is a positive; every list grew by num_hard_negs; K2 agrees with its twin
    at the split's query count within 1e-5."""
    from chip_smoke import brute_force_topk, mined_negatives_held, path_sweeps
    from uniir_tpu_torch.retrieval.index import normalize_l2

    tree = card_tree
    rows = list(range(0, 96, 2))
    queries = [{"qid": f"9:{j}", "query_modality": tree.cands[i]["modality"], "pos_cand_list": [tree.cands[i]["did"]],
                "neg_cand_list": [tree.cands[(i + 1) % 96]["did"]]} for j, i in enumerate(rows)]
    save_jsonl(queries, os.path.join(tree.mbeir, "train", "mbeir_mscoco_mine_train.jsonl"))
    embed_dir = os.path.join(tree.root, "embed", "Card", "train")
    os.makedirs(embed_dir, exist_ok=True)
    q_emb = tree.emb[rows]
    np.save(os.path.join(embed_dir, "mbeir_mscoco_mine_train_embed.npy"), q_emb)
    np.save(os.path.join(embed_dir, "mbeir_mscoco_mine_train_ids.npy"),
            np.asarray([port_registry.hash_qid(q["qid"]) for q in queries], np.int64))
    config = _card_retrieval_config(tree, num_hard_negs=10, k=50, train_datasets_config={
        "enable_retrieve": True, "datasets_name": ["mscoco_mine"], "correspond_cand_pools_name": ["mscoco_task0"]})
    T.bucket_max_scores.launches = 0
    with open(run_hard_negative_mining(config, device="cuda")) as f:
        mined = [json.loads(line) for line in f]
    assert T.bucket_max_scores.launches == 1

    index = DenseIndex.load(_index_path(tree.root, "Card"))
    pool = torch.from_numpy(index.embeds).cuda().bfloat16()
    scores, idx = brute_force_topk(torch.from_numpy(normalize_l2(q_emb)).cuda(), pool, index.ntotal, 50)
    dids = [port_registry.unhash_did(h) for h in index.ids.tolist()]
    held, _ = mined_negatives_held(mined, queries, scores.cpu(), idx.cpu(), dids, 10)
    assert held
    ((_, err, _),) = path_sweeps([q_emb], index.embeds, index.ntotal)
    assert err <= 1e-5
