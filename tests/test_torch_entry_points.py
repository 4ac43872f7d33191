"""The port's entry points as a user runs them, without PyYAML, Pillow or
`regex`: the pipeline CLI from a YAML config over a tree of JPEG files, with
CLIP's BPE tokenizer, on the CPU, against the JAX pipeline on the same tree,
weights, merges and transform.

The JAX side runs first (it needs all three); the port's run follows with
`yaml`, `PIL` and `regex` blocked in `sys.modules`, so any import of them on
its path fails."""

import dataclasses
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.helpers import build_pipeline_tree, make_eval_config, tiny_clip_merges
from uniir_tpu.data.preprocess import clip_transform as jax_clip_transform
from uniir_tpu.data.tokenizers.clip_bpe import CLIPTokenizer as JaxCLIPTokenizer
from uniir_tpu.models import clip as jax_clip
from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxCLIPScoreFusion
from uniir_tpu.models.registry import ModelBundle as JaxModelBundle
from uniir_tpu.retrieval.embedder import generate_embeds_for_config as jax_embed
from uniir_tpu.retrieval.eval import run_retrieval as jax_run_retrieval
from uniir_tpu.retrieval.index import create_index as jax_create_index
from uniir_tpu_torch.core import yaml_subset
from uniir_tpu_torch.models import clip as port_clip
from uniir_tpu_torch.models.convert import state_dict_from_jax
from uniir_tpu_torch.tools import config_updater
from uniir_tpu_torch.tools import pipeline

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("yaml", "PIL", "regex")
MODEL = "test-tiny-bpe"  # test-tiny with the vocabulary of the tiny merges
JAX_EXPT, PORT_EXPT = "CLIP_SF/TinyBpeJax/NoInstruct/InBatch/", "CLIP_SF/TinyBpeCli/NoInstruct/InBatch/"
EMBED_ATOL = 2e-3  # fp16 artifacts of fp32 towers that differ only in summation order


def _block(monkeypatch):
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX pipeline in code, then the port's CLI from a YAML file with the three modules blocked."""
    root = str(tmp_path_factory.mktemp("entry_points"))
    build_pipeline_tree(root)
    merges_path = os.path.join(root, "merges.txt")
    with open(merges_path, "w") as f:
        f.write("#version: tiny\n" + "".join(f"{a} {b}\n" for a, b in tiny_clip_merges()))
    vocab = 2 * 256 + len(tiny_clip_merges()) + 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_clip.CLIP_CONFIGS, MODEL, dataclasses.replace(jax_clip.CLIP_CONFIGS["test-tiny"], vocab_size=vocab))
        mp.setitem(port_clip.CLIP_CONFIGS, MODEL, dataclasses.replace(port_clip.CLIP_CONFIGS["test-tiny"], vocab_size=vocab))
        cfg = jax_clip.CLIP_CONFIGS[MODEL]
        model = JaxCLIPScoreFusion(cfg)
        tok = JaxCLIPTokenizer(bpe_path=merges_path)

        def tokenize(texts):
            return tok(texts, context_length=cfg.context_length, truncate=True)

        params = model.init(jax.random.PRNGKey(0), tokenize(["x", "y"]),
                            np.zeros((2, cfg.image_size, cfg.image_size, 3), np.float32),
                            np.ones(2, np.int32), np.ones(2, np.int32))["params"]
        transform = jax_clip_transform(cfg.image_size)
        bundle = JaxModelBundle("CLIPScoreFusion", model, params, tokenize, transform, transform,
                                (cfg.image_size, cfg.image_size), cfg.embed_dim)
        config = make_eval_config(root)
        config.data_config.enable_query_instruct = False  # the prompt is drawn at random
        config.experiment.path_suffix = JAX_EXPT
        jax_embed(bundle, config)
        jax_create_index(config)
        jax_run_retrieval(config)

        os.makedirs(os.path.join(root, "ckpt"))
        torch.save(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)), os.path.join(root, "ckpt", "tiny.pth"))
        doc = config.to_dict(resolve=False)
        doc["experiment"]["path_suffix"] = PORT_EXPT
        doc["model"] = {"name": "CLIPScoreFusion", "short_name": "CLIP_SF", "size": "Tiny", "bf16": False,
                        "clip_vision_model_name": MODEL, "clip_bpe_path": merges_path,
                        "ckpt_config": {"ckpt_dir": "ckpt", "ckpt_name": "tiny.pth"}}
        config_path = os.path.join(root, "pipeline.yaml")
        yaml_subset.dump(doc, config_path)
        mp.setattr(sys, "argv", ["pipeline"])
        _block(mp)
        pipeline.main(["--config_path", config_path, "--uniir_dir", root, "--mbeir_data_dir",
                       os.path.join(root, "mbeir_data"), "--enable_embed", "--enable_create_index",
                       "--enable_retrieval", "--device", "cpu"])
    return root


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


def test_cli_run_files_and_tsv_equal_the_jax_pipelines(run):
    rows = _run_rows(run, PORT_EXPT)
    assert len(rows) == 3 and all(rows.values())  # train, test and the test union run
    assert rows == _run_rows(run, JAX_EXPT)
    assert _tsv(run, PORT_EXPT) == _tsv(run, JAX_EXPT)


@pytest.mark.parametrize("split,name", [("test", "mscoco_task0_test"), ("train", "mscoco_task0_train"),
                                        ("cand_pool", "mscoco_task0_cand_pool"), ("cand_pool", "union_cand_pool")])
def test_cli_embeddings_equal_the_jax_pipelines(run, split, name):
    base = os.path.join(run, "embed", "{}", split, f"mbeir_{name}")
    ours, ref = np.load(base.format(PORT_EXPT) + "_embed.npy"), np.load(base.format(JAX_EXPT) + "_embed.npy")
    assert ours.dtype == np.float16 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.astype(np.float32), ref.astype(np.float32), atol=EMBED_ATOL)
    np.testing.assert_array_equal(np.load(base.format(PORT_EXPT) + "_ids.npy"), np.load(base.format(JAX_EXPT) + "_ids.npy"))


def test_cli_read_image_files_and_bpe(run):
    """The tree's candidates and queries carry JPEG files, and the BPE
    tokenizer gives ids past the byte alphabet: both paths were exercised."""
    import json

    with open(os.path.join(run, "mbeir_data", "cand_pool", "local", "mbeir_mscoco_task0_cand_pool.jsonl")) as f:
        assert any(json.loads(line).get("img_path", "").endswith(".jpg") for line in f)
    from uniir_tpu_torch.data.tokenizers.clip_bpe import CLIPTokenizer

    ids = CLIPTokenizer(bpe_path=os.path.join(run, "merges.txt"))(["red dress"])
    assert (ids[0][1:3] >= 512).any()


def test_config_updater_cli_without_yaml(tmp_path, monkeypatch):
    """The run scripts' instruct switch, through its CLI, with the three modules blocked."""
    path = tmp_path / "embed.yaml"
    path.write_text((REPO / "configs/clip_sf/large/eval/inbatch/embed.yaml").read_text())
    _block(monkeypatch)
    config_updater.main(["--update_mbeir_yaml_instruct_status", "--mbeir_yaml_file_path", str(path),
                         "--enable_instruct", "True"])
    data = yaml_subset.load(path)
    assert data["experiment"]["instruct_status"] == "Instruct" and data["data_config"]["enable_query_instruct"] is True
