"""The port's YAML reader and writer (`uniir_tpu_torch.core.yaml_subset`)
against PyYAML's `safe_load`, on every shipped config, on scalars of each
resolver family, and on the constructs the subset refuses."""

import math
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from uniir_tpu.core.config import load_config as jax_load_config
from uniir_tpu_torch.core import yaml_subset
from uniir_tpu_torch.core.config import Config, load_config, save_config
from uniir_tpu_torch.tools import config_updater

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(REPO.glob("configs/**/*.yaml"))
IDS = [str(p.relative_to(REPO)) for p in CONFIGS]


def same(a, b) -> bool:
    """Equal values of equal types, nan equal to nan."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_every_shipped_config_is_found():
    assert len(CONFIGS) == 38


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_reader_equals_safe_load_on_shipped_config(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert same(yaml_subset.load(path), ref)


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_load_config_equals_jax_load_config(path):
    assert load_config(str(path)).to_dict(resolve=True) == jax_load_config(str(path)).to_dict(resolve=True)


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_writer_round_trips_shipped_config_through_both_readers(path, tmp_path):
    data = yaml_subset.load(path)
    text = yaml_subset.dumps(data)
    assert same(yaml.safe_load(text), data) and same(yaml_subset.loads(text), data)
    out = tmp_path / "saved.yaml"
    save_config(load_config(str(path)), str(out))  # what Config.to_yaml writes
    assert same(yaml.safe_load(out.read_text()), data) and same(yaml_subset.load(out), data)


def test_alias_is_the_anchored_value():
    """`&id001` / `*id001`: the alias gives the anchored list itself, as safe_load does."""
    path = REPO / "configs/clip_sf/large/eval/inbatch/embed.yaml"
    data = yaml_subset.load(path)
    anchored = data["embed_config"]["test_datasets_config"]["correspond_cand_pools_name"]
    assert data["embed_config"]["cand_pools_config"]["cand_pools_name_to_embed"] is anchored
    assert len(anchored) == 16 and anchored[1] == "mscoco_task0_test"
    text = "a: &x\n  k: 1\nb: *x\nc:\n- &s one\n- *s\n"
    assert same(yaml_subset.loads(text), yaml.safe_load(text))
    loaded = yaml_subset.loads(text)
    assert loaded["a"] is loaded["b"]


def test_structures_equal_safe_load():
    text = """
# comment
top:   # trailing comment
  seq_same_indent:
  - a
  - 'b # not a comment'
  - "c\\td\\u00e9"
  seq_deeper:
    - 1
    - - 2
      - 3
    - k: v
      k2: ~
    -
      k3: x
  empty_list: []
  empty_map: {}
  quoted: 'it''s'
  empty: ''
  plain: a#b c
  url: http://x.y/z
  neg: -3
  nul:
other: 224, 224
"""
    assert same(yaml_subset.loads(text), yaml.safe_load(text))


def test_config_updater_and_checkpoint_round_trip(tmp_path):
    """What the updater writes and the config a train checkpoint stores read
    back the same through both readers."""
    src = REPO / "configs/clip_sf/large/eval/inbatch/embed.yaml"
    path = tmp_path / "embed.yaml"
    path.write_text(src.read_text())
    config_updater.update_mbeir_yaml_instruct_status(str(path), True)
    data = yaml.safe_load(path.read_text())
    assert data["experiment"]["instruct_status"] == "Instruct" and data["data_config"]["enable_query_instruct"] is True
    assert same(yaml_subset.load(path), data)
    stored = load_config(str(REPO / "configs/clip_sf/large/train/inbatch/inbatch.yaml")).to_dict(resolve=False)
    stored["trainer_config"]["learning_rate"] = 1e-05  # what a checkpoint keeps: the unresolved dict
    text = Config.from_dict(stored).to_yaml()
    assert same(yaml.safe_load(text), stored) and same(yaml_subset.loads(text), stored)


# --- scalars --------------------------------------------------------------------

FAMILIES = {
    "bool": st.sampled_from([w for base in ("yes", "no", "true", "false", "on", "off")
                             for w in (base, base.capitalize(), base.upper())] + ["yEs", "TRUE ", "y", "n"]),
    "null": st.sampled_from(["~", "null", "Null", "NULL", "nULL", "none"]),
    "int": st.builds(lambda sign, digits, under: sign + (digits[:1] + "_" + digits[1:] if under and len(digits) > 1
                                                        else digits),
                     st.sampled_from(["", "-", "+"]), st.from_regex(r"[1-9][0-9]{0,12}", fullmatch=True), st.booleans()),
    "int_base": st.builds(lambda sign, body: sign + body, st.sampled_from(["", "-", "+"]),
                          st.one_of(st.from_regex(r"0x[0-9a-fA-F_]{1,8}", fullmatch=True).filter(lambda s: s[2:].strip("_")),
                                    st.from_regex(r"0o[0-7]{1,6}", fullmatch=True),
                                    st.from_regex(r"0[0-7_]{1,6}", fullmatch=True),
                                    st.from_regex(r"0b[01_]{1,10}", fullmatch=True).filter(lambda s: s[2:].strip("_")),
                                    st.from_regex(r"[1-9][0-9]?(:[0-5][0-9]){1,2}", fullmatch=True))),
    "float": st.one_of(
        st.floats(allow_nan=False, allow_infinity=False).map(repr),
        st.from_regex(r"[-+]?[0-9]{1,4}\.[0-9]{0,4}([eE][-+]?[0-9]{1,2})?", fullmatch=True),
        st.from_regex(r"[-+]?\.[0-9]{1,3}", fullmatch=True),
        st.from_regex(r"[0-9]{1,3}[eE][-+]?[0-9]{1,2}", fullmatch=True),
        st.sampled_from([".inf", "-.inf", "+.Inf", ".INF", ".nan", ".NaN", ".NAN", "1.0e-05", "1e-5", "1_000.5",
                         "190:20:30.15"])),
    "string": st.sampled_from(["224, 224", "${model.short_name}/${model.size}/", "ViT-L/14", "checkpoint/CLIP/",
                               "a b", "-x", "1.2.3", "0x", "=x", "<<x", "Recall@1, Recall@5"]),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_scalars_resolve_as_safe_load(family):
    @settings(max_examples=60, deadline=None)
    @given(FAMILIES[family])
    def check(text):
        doc = f"k: {text}\n"
        try:
            ref = yaml.safe_load(doc)
        except (yaml.YAMLError, ValueError):  # PyYAML cannot construct it either (e.g. "0b_")
            with pytest.raises(ValueError):
                yaml_subset.loads(doc)
            return
        assert same(yaml_subset.loads(doc), ref), (text, ref)

    check()


@settings(max_examples=150, deadline=None)
@given(st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(), st.floats(), st.text(max_size=20)),
    lambda children: st.one_of(st.lists(children, max_size=4),
                               st.dictionaries(st.one_of(st.text(max_size=8), st.integers()), children, max_size=4)),
    max_leaves=12))
def test_writer_round_trips_any_value_through_both_readers(value):
    text = yaml_subset.dumps({"root": value})
    assert same(yaml.safe_load(text), {"root": value}), text
    assert same(yaml_subset.loads(text), {"root": value}), text


# --- what the subset refuses ----------------------------------------------------

REJECTED = {
    "tag": ("a: 1\nb: !!str 2\n", 2),
    "block_literal": ("a: 1\nb: |\n  text\n", 2),
    "block_folded": ("a: >\n  text\n", 1),
    "flow_sequence": ("a:\n  b: [1, 2]\n", 2),
    "flow_mapping": ("a: {b: 1}\n", 1),
    "merge_key": ("base: &b\n  x: 1\nderived:\n  <<: *b\n", 4),
    "two_documents": ("a: 1\n---\nb: 2\n", 2),
    "tab_indentation": ("a:\n\tb: 1\n", 2),
    "complex_key": ("? a\n: 1\n", 1),
    "timestamp": ("a: 1\nday: 2023-01-02\n", 2),
    "directive": ("%YAML 1.1\n---\na: 1\n", 1),
    "multi_line_plain": ("a: one\n  two\n", 2),
    "unknown_alias": ("a: *nope\n", 1),
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_rejected_construct_raises_with_its_line(name, tmp_path):
    text, line = REJECTED[name]
    path = tmp_path / f"{name}.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=rf"{name}\.yaml:{line}:"):
        yaml_subset.load(path)
