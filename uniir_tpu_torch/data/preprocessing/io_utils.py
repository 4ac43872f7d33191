"""M-BEIR dataset-construction utilities (reference src/data/preprocessing/utils.py:119-585).

File IO, candidate-pool/query loaders keyed by content or id, duplicate
detection, dataset statistics, and the parallel image-corpus preparation
(resize shortest side to 256, convert to JPEG, drop corrupt files).

The counterpart of `uniir_tpu/data/preprocessing/io_utils.py`, without
Pillow: an image is read by `data.jpeg.decode_image` (Pillow's
`convert("RGB")` pixels), resized by `data.preprocess.resize_uint8`
(Pillow's BILINEAR `resize`) and written by `data.jpeg_encode` (Pillow's
default `save(path, "JPEG")`, the source's comment carried over), so the
files written are the JAX package's, byte for byte.  A file is deleted
only where the JAX pass deletes it: data the decoders find corrupt or cut
short, more pixels than Image.open's decompression-bomb limit.  A file in a
format the port does not decode yet (`UnsupportedImageFormat`) is left in
place, named and counted on its own line.  On a CUDA run the native decoders
and encoder are built and loaded before the first file, outside any `try`:
a failed build raises and deletes nothing.
"""

from __future__ import annotations

import json
import os
import time
from collections import Counter
import multiprocessing
from multiprocessing import cpu_count
from typing import Optional, Tuple

from uniir_tpu_torch.data.jpeg import UnsupportedImageFormat, decode_image, image_comment, is_jpeg
from uniir_tpu_torch.data.jpeg_encode import encoder_for
from uniir_tpu_torch.data.preprocess import BILINEAR, resize_uint8
from uniir_tpu_torch.data.registry import IMAGE_SHORT_SIDE

MODALITY_COMBINATIONS = [
    "text-image",
    "text-text",
    "text-image,text",
    "image-text",
    "image-image",
    "image,text-text",
    "image,text-image",
    "image,text-image,text",
]


def save_list_as_jsonl(data: list, filename: str, mode: str = "w") -> None:
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, mode) as f:
        for entry in data:
            f.write(json.dumps(entry) + "\n")


def load_jsonl_as_list(filename: str) -> list:
    with open(filename, "r") as f:
        return [json.loads(line.strip()) for line in f if line.strip()]


def count_entries_in_file(filename: str) -> Tuple[int, list]:
    if filename.endswith(".jsonl"):
        data = load_jsonl_as_list(filename)
    elif filename.endswith(".json"):
        with open(filename, "r") as f:
            data = json.load(f)
    else:
        raise ValueError("Unsupported file format. Only .json and .jsonl are supported.")
    return len(data), data


def generate_mbeir_format_doc_key(entry: dict) -> str:
    """Content key `txt-img_path-modality` for dedup (reference :329-338)."""
    txt = entry.get("txt", "") or ""
    img_path = entry.get("img_path", "") or ""
    modality = entry.get("modality", "") or ""
    assert txt or img_path, f"Either txt or img_path must be present. {entry}"
    return "-".join(p for p in (txt, img_path, modality) if p)


def load_mbeir_format_pool_file_as_dict(pool_file_path: str, doc_key_to_content: bool = False, key_type: str = "mbeir_converted_key") -> dict:
    assert pool_file_path.endswith(".jsonl"), "Only JSONL files are supported."
    pool_dict: dict = {}
    for entry in load_jsonl_as_list(pool_file_path):
        if key_type == "mbeir_converted_key":
            key = generate_mbeir_format_doc_key(entry)
        elif key_type == "did":
            key = entry["did"]
        else:
            raise ValueError(f"Invalid key_type: {key_type}")
        assert key not in pool_dict, f"Duplicate doc_key found: {key}"
        pool_dict[key] = entry if doc_key_to_content else entry["did"]
    return pool_dict


def load_mbeir_format_query_file_as_dict(query_file_path: str, doc_key_to_content: bool = False, key_type: str = "mbeir_converted_key") -> dict:
    assert query_file_path.endswith(".jsonl"), "Only JSONL files are supported."
    query_dict: dict = {}
    for entry in load_jsonl_as_list(query_file_path):
        key = generate_mbeir_format_doc_key(entry) if key_type == "mbeir_converted_key" else entry["qid"]
        assert key not in query_dict, f"Duplicate doc_key found: {key}"
        query_dict[key] = entry if doc_key_to_content else entry["qid"]
    return query_dict


def check_duplicates_in_mbeir_format_cand_pool(data: list, print_duplicate: bool = True) -> list:
    """Unique-did assert + content-level duplicate listing (reference :290-311)."""
    did_set = set()
    seen: dict = {}
    duplicates = []
    for entry in data:
        did = entry.get("did")
        assert did not in did_set, f"Duplicate id found: {did}"
        did_set.add(did)
        key = generate_mbeir_format_doc_key(entry)
        if key in seen:
            if print_duplicate:
                print(f"Duplicate candidate found: {entry} and {seen[key]}")
            duplicates.append(entry)
        seen[key] = entry
    return duplicates


def aggregate_candidates_for_mbeir_format_dataset(data: list, print_duplicate: bool = True) -> list:
    """Merge query entries with identical (txt, img, modality), unioning their
    candidate lists (reference :253-287)."""
    mapping: dict = {}
    for entry in data:
        key = f"{entry['query_txt']}-{entry['query_img_path']}-{entry['query_modality']}"
        if key not in mapping:
            mapping[key] = {
                "qid": entry["qid"],
                "query_txt": entry["query_txt"],
                "query_img_path": entry["query_img_path"],
                "query_modality": entry["query_modality"],
                "query_src_content": entry.get("query_src_content"),
                "pos_cand_list": [],
                "neg_cand_list": [],
            }
        elif print_duplicate:
            print(f"Duplicate entry found for key: {key}")
        for field in ("pos_cand_list", "neg_cand_list"):
            for did in entry.get(field, []):
                if did not in mapping[key][field]:
                    mapping[key][field].append(did)
                elif print_duplicate:
                    print(f"Duplicate candidate found: {did}")
    return list(mapping.values())


# ---------------------------------------------------------------------------
# Statistics (reference get_modality_stats :397-530)
# ---------------------------------------------------------------------------


def get_modality_stats(data: list, cand_pool_dict: dict) -> dict:
    counts = {
        kind: {
            comb: {"count": 0, "queries": [], "unique_queries": set(), "unique_dids": set()}
            for comb in MODALITY_COMBINATIONS
        }
        for kind in ("pos", "neg")
    }
    totals = Counter()
    question_types = Counter()

    for entry in data:
        qid = entry["qid"]
        query_modality = entry["query_modality"]
        totals["entries"] += 1
        totals["query_words"] += len((entry.get("query_txt") or "").split())
        totals["pos_cands"] += len(entry.get("pos_cand_list", []))
        totals["neg_cands"] += len(entry.get("neg_cand_list", []))

        src = entry.get("query_src_content")
        if src:
            qtype = json.loads(src).get("question_type")
            if qtype:
                question_types[qtype] += 1

        for kind, field in (("pos", "pos_cand_list"), ("neg", "neg_cand_list")):
            golden = None
            for idx, did in enumerate(entry.get(field, [])):
                cand = cand_pool_dict[did]
                comb = f"{query_modality}-{cand['modality']}"
                if kind == "pos":
                    if idx == 0:
                        golden = comb
                    else:
                        assert golden == comb, "Golden task modality does not match with the combined modality"
                totals[f"{kind}_words"] += len((cand.get("txt") or "").split())
                if comb in counts[kind]:
                    c = counts[kind][comb]
                    c["count"] += 1
                    c["unique_queries"].add(qid)
                    c["unique_dids"].add(cand["did"])
                    if idx == 0:
                        c["queries"].append(qid)

    def section(kind: str) -> dict:
        src = counts[kind]
        n_cands = totals[f"{kind}_cands"]
        return {
            "examples": {m: v["count"] for m, v in src.items() if v["count"]},
            "queries": {m: len(v["queries"]) for m, v in src.items() if v["queries"]},
            "unique_queries": {m: len(v["unique_queries"]) for m, v in src.items() if v["unique_queries"]},
            "unique_docs": {m: len(v["unique_dids"]) for m, v in src.items() if v["unique_dids"]},
            f"avg_{kind}_cand_count": totals[f"{kind}_cands"] / max(1, totals["entries"]),
            "avg_txt_words": totals[f"{kind}_words"] / n_cands if n_cands else 0,
        }

    stats = {
        "pos": section("pos"),
        "neg": section("neg"),
        "avg_query_txt_words": totals["query_words"] / max(1, totals["entries"]),
    }
    if question_types:
        stats["total_query_question_type_count"] = dict(question_types)
    return stats


def print_mbeir_format_dataset_stats(data: list, cand_pool_dict: dict) -> None:
    stats = get_modality_stats(data, cand_pool_dict)
    for category, payload in stats.items():
        print(f"--- {category.upper()} ---")
        if not isinstance(payload, dict):
            print(f"\t{payload:.1f}")
            continue
        for section, values in payload.items():
            print(f"{section}:")
            if isinstance(values, dict):
                for modality, count in values.items():
                    print(f"\t{modality}: {count}")
            else:
                print(f"\t{values:.1f}")


def print_mbeir_format_cand_pool_stats(candidate_pool_path: str, print_duplicate: bool = True) -> None:
    data = load_jsonl_as_list(candidate_pool_path)
    modality_counts = Counter(e.get("modality") for e in data if e.get("modality"))
    print(f"Total number of entries in {candidate_pool_path}: {len(data)}")
    print(f"Modality counts: {dict(modality_counts)}")
    duplicates = check_duplicates_in_mbeir_format_cand_pool(data, print_duplicate=print_duplicate)
    print(f"Number of duplicates: {len(duplicates)}")


def save_and_print_mbeir_format_dataset_stats(data: list, data_file_path: str, cand_pool_file_path: str) -> None:
    save_list_as_jsonl(data, data_file_path)
    total_entries, _data = count_entries_in_file(data_file_path)
    print(f"Saved dataset to {data_file_path} ({total_entries} entries)")
    assert os.path.exists(cand_pool_file_path), f"File {cand_pool_file_path} does not exist"
    cand_pool_dict = load_mbeir_format_pool_file_as_dict(cand_pool_file_path, doc_key_to_content=True, key_type="did")
    print_mbeir_format_dataset_stats(_data, cand_pool_dict)


# ---------------------------------------------------------------------------
# Image corpus preparation (reference :119-195)
# ---------------------------------------------------------------------------


# the host libraries a CUDA run's image pass calls: the decoders of `decode_image` and the encoder
NATIVE_LIBRARIES = ("jpeg", "png", "gif", "webp", "tiff", "raster", "bcn", "jpeg2000", "jpeg_encode")


def image_pass_device(device=None) -> str:
    """The image pass's device, as the string its spawn workers take: None is the card
    (`core.device.resolve_device`, which raises without one), so the native decoders and encoder run;
    "cpu" runs their twins.  The one place the pass's default is decided."""
    if device is not None:
        return str(device)
    from uniir_tpu_torch.core.device import resolve_device

    return str(resolve_device(None))


def add_device_argument(parser) -> None:
    """The converters' `--device` flag, the one flag they add to the reference's."""
    parser.add_argument("--device", default=None, help="the image pass's device (default: the card; cpu: the twins)")


def prepare_native(device) -> None:
    """Build (one nvcc each, at once) and load the native decoders and encoder of a CUDA run; raises on
    a failed build or load.  A CPU run uses the twins and needs nothing."""
    from uniir_tpu_torch import _build

    if not _build.is_cuda(device):
        return

    missing = [name for name in NATIVE_LIBRARIES if name not in _build._loaded]
    if missing:
        _build.build_all(missing)
        for name in missing:
            _build.load(name)


class _StageClock:
    """Adds the seconds since its last call to `timings[stage]`; does nothing when `timings` is None."""

    def __init__(self, timings: Optional[dict]):
        self.timings, self.t = timings, time.perf_counter()

    def __call__(self, stage: str) -> None:
        if self.timings is not None:
            now = time.perf_counter()
            self.timings[stage] = self.timings.get(stage, 0.0) + now - self.t
            self.t = now


def resize_and_convert_image_to_jpg(image_path: str, short_side: int = IMAGE_SHORT_SIDE, device=None,
                                    timings: Optional[dict] = None):
    """Resize shortest side, convert to JPEG, delete original; drop corrupt files.  `device` as
    `image_pass_device` takes it; `timings`, when given, gathers the seconds of each stage (read, decode,
    comment, resize, encode, write).

    True when written, False when deleted as corrupt, None when left in place (a format not decoded yet)."""
    if device is None:
        device = image_pass_device()
    prepare_native(device)  # outside the try: a library that does not build or load raises, deleting nothing
    encode = encoder_for(device)
    clock = _StageClock(timings)
    try:
        with open(image_path, "rb") as f:
            data = f.read()
        clock("read")
        rgb = decode_image(data, image_path, device)
        clock("decode")
        comment = image_comment(data, image_path)
        clock("comment")
        h, w = rgb.shape[:2]
        if w <= h:
            new_w, new_h = short_side, max(1, round(h * short_side / w))
        else:
            new_w, new_h = max(1, round(w * short_side / h)), short_side
        small = resize_uint8(rgb, (new_w, new_h), BILINEAR)
        clock("resize")
        jpg = encode(small, comment)
        clock("encode")
        save_path = os.path.splitext(image_path)[0] + ".jpg"
        with open(save_path, "wb") as f:
            f.write(jpg)
        if save_path != image_path:
            os.remove(image_path)
        clock("write")
        return True
    except UnsupportedImageFormat as e:
        print(f"Unsupported image format, left in place: {image_path}. Message: {e}")
        return None
    except Exception as e:
        print(f"Error processing {image_path}. Invalid or corrupted image. Message: {e}")
        if os.path.exists(image_path):
            os.remove(image_path)
        return False


def is_valid_image(img_path: str) -> bool:
    """True exactly where `PIL.Image.open(img_path).format == "JPEG"`: a parse of the markers up to the
    first scan (`data.jpeg.is_jpeg`), so a JPEG whose scan data is cut short is still valid."""
    try:
        with open(img_path, "rb") as f:
            return is_jpeg(f.read())
    except OSError:
        return False


# the native decodes and encodes the last `parallel_process_image_directory` made in its workers (their
# libraries' call counters, summed), read by chip_smoke.py
NATIVE_CALLS = {"decode": 0, "encode": 0}


def _native_calls() -> tuple:
    from uniir_tpu_torch.data import gif, jpeg, jpeg2000, jpeg_encode, png, tiff, webp

    decodes = sum(m.decode_native.calls for m in (jpeg, png, gif, webp, tiff, jpeg2000))
    return decodes, jpeg_encode.encode_native.calls


def _process_one(args) -> tuple:
    """(0 written, 1 deleted as corrupt, 2 left in place; the native decodes and encodes it made)."""
    image_path, device = args
    before = _native_calls()
    status = {True: 0, False: 1, None: 2}[resize_and_convert_image_to_jpg(image_path, device=device)]
    after = _native_calls()
    return status, after[0] - before[0], after[1] - before[1]


def parallel_process_image_directory(images_dir: str, num_processes: Optional[int] = None, device=None) -> int:
    """Recursively resize/convert every image under `images_dir` in parallel; returns the corrupt files'
    count.  `device` as `image_pass_device` takes it."""
    device = image_pass_device(device)
    prepare_native(device)
    all_image_paths = []
    for root, _, files in os.walk(images_dir):
        for file in files:
            if file.lower().endswith((".png", ".jpg", ".jpeg")):
                all_image_paths.append(os.path.join(root, file))
    print(f"Number of images found: {len(all_image_paths)}")
    # spawn, as the JAX package does: a fork of a process with a live accelerator runtime can wedge
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(num_processes or cpu_count()) as p:
        done = p.map(_process_one, [(path, device) for path in all_image_paths])
    status = [d[0] for d in done]
    NATIVE_CALLS.update(decode=sum(d[1] for d in done), encode=sum(d[2] for d in done))
    corrupted = status.count(1)
    print(f"Number of corrupted files: {corrupted}")
    unsupported = status.count(2)
    if unsupported:
        print(f"Number of files left in place (format not decoded yet): {unsupported}")
    return corrupted
