"""WebQA -> M-BEIR converter (reference webqa_data_preprocessor.py).

Text questions over mixed text / (image, caption) wiki facts: positives and
negatives from img_posFacts/img_negFacts/txt_posFacts/txt_negFacts; base64
image decoding handled during image processing.
"""

from __future__ import annotations

import argparse
import base64
import json
import os

from uniir_tpu_torch.data.jpeg import UnsupportedImageFormat, decode_image, image_comment
from uniir_tpu_torch.data.jpeg_encode import encoder_for
from uniir_tpu_torch.data.preprocessing.base import CandPoolBuilder, build_training_cand_pool, finalize_queries, new_query_entry
from uniir_tpu_torch.data.preprocessing.io_utils import (
    add_device_argument,
    image_pass_device,
    load_jsonl_as_list,
    load_mbeir_format_pool_file_as_dict,
    parallel_process_image_directory,
    prepare_native,
    save_list_as_jsonl,
)
from uniir_tpu_torch.data.registry import format_string

DATASET = "WebQA"


def webqa_image_rel_path(image_id) -> str:
    return os.path.join("mbeir_images", "webqa_images", f"{image_id}.jpg")


def decode_webqa_images(webqa_tsv_path: str, lineidx_path: str, images_dir: str, device=None) -> int:
    """Decode base64 images from the WebQA imgs.tsv (reference image step): each written as Pillow's
    `convert("RGB").save(out, "JPEG")` writes it.  An image in a format the port does not decode yet is
    written as it is, so the image pass leaves it in place and names it.  `device` as `image_pass_device`
    takes it."""
    device = image_pass_device(device)
    encode = encoder_for(device)
    n = 0
    with open(lineidx_path) as f:
        line_offsets = [int(l.strip()) for l in f]
    with open(webqa_tsv_path) as tsv:
        for offset in line_offsets:
            tsv.seek(offset)
            image_id, b64 = tsv.readline().strip().split("\t")
            data = base64.b64decode(b64)
            out = os.path.join(images_dir, f"{image_id}.jpg")
            try:
                jpg = encode(decode_image(data, out, device), image_comment(data, out))
            except UnsupportedImageFormat as e:
                print(f"Unsupported image format, written as it is: {out}. Message: {e}")
                jpg = data
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "wb") as f:
                f.write(jpg)
            n += 1
    return n


def _fact_to_candidate_args(fact: dict, modality: str):
    if modality == "image,text":
        return format_string(fact["caption"]), webqa_image_rel_path(fact["image_id"])
    if modality == "text":
        return format_string(fact["fact"]), None
    raise ValueError(f"Unknown modality type: {modality}")


def generate_webqa_candidate_pool(webqa_data: dict, cand_pool_path: str) -> CandPoolBuilder:
    pool = CandPoolBuilder(DATASET)
    for entry in webqa_data.values():
        for field, modality in (
            ("img_posFacts", "image,text"),
            ("img_negFacts", "image,text"),
            ("txt_posFacts", "text"),
            ("txt_negFacts", "text"),
        ):
            for fact in entry.get(field, []):
                txt, img_path = _fact_to_candidate_args(fact, modality)
                if txt or img_path:
                    pool.add(txt, img_path, modality)
    pool.save(cand_pool_path)
    return pool


def webqa_to_mbeir_entry(entry: dict, pool: dict, include_src_content: bool = True):
    query_txt = format_string(entry["Q"])
    if not query_txt:
        return None
    src = json.dumps({"Guid": str(entry.get("Guid", "")), "Qcate": str(entry.get("Qcate", ""))}) if include_src_content else None
    mbeir_entry = new_query_entry(query_txt=query_txt, query_modality="text", query_src_content=src)

    def lookup(fact, modality):
        txt, img_path = _fact_to_candidate_args(fact, modality)
        key = "-".join(p for p in (txt, img_path, modality) if p)
        did = pool.get(key)
        if did is None:
            print(f"Warning: Candidate not found in the candidate pool. doc_key: {key}")
        return did

    for field, modality, dest in (
        ("img_posFacts", "image,text", "pos_cand_list"),
        ("img_negFacts", "image,text", "neg_cand_list"),
        ("txt_posFacts", "text", "pos_cand_list"),
        ("txt_negFacts", "text", "neg_cand_list"),
    ):
        for fact in entry.get(field, []):
            did = lookup(fact, modality)
            if did is not None:
                mbeir_entry[dest].append(did)
    return mbeir_entry


def webqa_to_mbeir(webqa_data: dict, candidate_pool_file_path: str) -> list:
    pool = load_mbeir_format_pool_file_as_dict(candidate_pool_file_path, doc_key_to_content=False)
    out = []
    for entry in webqa_data.values():
        e = webqa_to_mbeir_entry(entry, pool)
        if e is not None and e["pos_cand_list"]:
            out.append(e)
    return out


def split_train_val(webqa_data: dict):
    """WebQA's released splits: 'train' and 'val' inside train_val json."""
    train = {k: v for k, v in webqa_data.items() if v.get("split") == "train"}
    val = {k: v for k, v in webqa_data.items() if v.get("split") == "val"}
    return train, val


def main():
    parser = argparse.ArgumentParser(description="Decode WebQA images and refactor dataset to MBEIR format.")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data/")
    parser.add_argument("--webqa_images_dir", type=str, default="mbeir_images/webqa_images/")
    parser.add_argument("--webqa_dir", type=str, default="src_data/webqa/")
    parser.add_argument("--enable_image_processing", action="store_true")
    parser.add_argument("--enable_candidate_pool", action="store_true")
    parser.add_argument("--enable_mbeir_conversion", action="store_true")
    parser.add_argument("--enable_data_split", action="store_true")
    parser.add_argument("--enable_training_candidate_pool", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args()

    webqa_dir = os.path.join(args.mbeir_data_dir, args.webqa_dir)
    pool_path = os.path.join(webqa_dir, "mbeir_webqa_cand_pool.jsonl")
    data_path = os.path.join(webqa_dir, "WebQA_train_val.json")

    if args.enable_image_processing:
        images_dir = os.path.join(args.mbeir_data_dir, args.webqa_images_dir)
        tsv = os.path.join(webqa_dir, "imgs.tsv")
        lineidx = os.path.join(webqa_dir, "imgs.lineidx")
        device = image_pass_device(args.device)
        prepare_native(device)
        if os.path.exists(tsv) and os.path.exists(lineidx):
            decode_webqa_images(tsv, lineidx, images_dir, device)
        parallel_process_image_directory(images_dir, device=device)
    if args.enable_candidate_pool or args.enable_mbeir_conversion:
        with open(data_path) as f:
            webqa_data = json.load(f)
    if args.enable_candidate_pool:
        generate_webqa_candidate_pool(webqa_data, pool_path)
    if args.enable_mbeir_conversion:
        train, val = split_train_val(webqa_data)
        for split, data in (("train", train), ("val", val)):
            entries = webqa_to_mbeir(data, pool_path)
            finalize_queries(entries, DATASET, os.path.join(webqa_dir, f"mbeir_webqa_{split}.jsonl"), pool_path)
    if args.enable_training_candidate_pool:
        full_pool = load_mbeir_format_pool_file_as_dict(pool_path, doc_key_to_content=True, key_type="did")
        train = load_jsonl_as_list(os.path.join(webqa_dir, "mbeir_webqa_train.jsonl"))
        save_list_as_jsonl(
            build_training_cand_pool(train, full_pool), os.path.join(webqa_dir, "mbeir_webqa_train_cand_pool.jsonl")
        )


if __name__ == "__main__":
    main()
