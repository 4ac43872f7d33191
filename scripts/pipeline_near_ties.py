"""Where the tiny FF pipelines' run files part: the JAX package's and the port's.

Runs `tests/test_torch_pipeline.py`'s CLIP-FF or BLIP-FF pipeline once in each
package (embed -> index -> retrieval, the port on the CPU, pool bf16) over a
fresh miniature M-BEIR tree, with the tests' stable tokenizer or with
`tests.helpers`' `hash()` one, whose token ids change with the process's
PYTHONHASHSEED.  Prints each run-file row whose id differs between the two
runs, with both scores, the smallest gap between neighbouring JAX scores of a
query, and the count of differing rows.

Usage (from the repo root, on a machine with JAX on the CPU, Pillow and torch):
    PYTHONHASHSEED=3 python scripts/pipeline_near_ties.py blip_ff --tokenizer hash
"""

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", choices=["clip_ff", "blip_ff"])
    parser.add_argument("--tokenizer", choices=["stable", "hash"], default="stable")
    args = parser.parse_args()

    import tests.conftest  # noqa: F401  (JAX on the CPU)
    import tests.test_torch_pipeline as T
    from tests.helpers import build_pipeline_tree, simple_bert_tokenizer, simple_tokenizer
    from tests.torch_helpers import on_array
    from uniir_tpu_torch.models.convert import state_dict_from_jax
    from uniir_tpu_torch.models.registry import ModelBundle

    root = tempfile.mkdtemp(prefix="near_ties_")
    build_pipeline_tree(root)
    if args.model == "clip_ff":
        jb, jax_expt, name = T.tiny_clip_ff_bundle(), T.CLIP_FF_JAX_EXPT, "CLIPFeatureFusion"
        model = T.CLIPFeatureFusion(T.CLIP_CONFIGS["test-tiny-ff"])
        hashed = simple_tokenizer(max_len=T.CLIP_CONFIGS["test-tiny-ff"].context_length,
                                  vocab_size=T.CLIP_CONFIGS["test-tiny-ff"].vocab_size)
    else:
        jb, jax_expt, name = T.tiny_blip_ff_bundle(), T.BLIP_FF_JAX_EXPT, "BLIPFeatureFusion"
        model = T.BLIPFeatureFusion(T.BLIP_VIT_CONFIGS["test-tiny"], T.MED_CONFIGS["test-tiny"])
        hashed = simple_bert_tokenizer(max_len=16, vocab_size=97)
    if args.tokenizer == "hash":
        jb = dataclasses.replace(jb, tokenizer=hashed)
    T._jax_pipeline(root, jb, jax_expt)
    model.load_state_dict(state_dict_from_jax(jb.params))
    bundle = ModelBundle(name, model.eval(), jb.tokenizer, on_array(jb.img_preprocess_fn),
                         on_array(jb.img_preprocess_fn_eval), jb.image_size, jb.embed_dim)
    port_expt = jax_expt.replace("TinyJax", "TinyTorch-bf16")
    T._port_pipeline(root, bundle, port_expt, "bf16")

    ours, ref = T._run_scores(root, port_expt), T._run_scores(root, jax_expt)
    differ, gaps = 0, []
    for run in ref:
        for qid, want in ref[run].items():
            got = ours[run][qid]
            gaps += [a[1] - b[1] for a, b in zip(want, want[1:])]
            for rank, ((d_ref, s_ref), (d_got, s_got)) in enumerate(zip(want, got), start=1):
                if d_ref != d_got:
                    differ += 1
                    print(f"{run} query {qid} rank {rank}: JAX {d_ref} {s_ref!r} | port {d_got} {s_got!r} "
                          f"(JAX scores {d_got} {dict(want).get(d_got)!r})")
    print(f"{args.model}, tokenizer {args.tokenizer}, PYTHONHASHSEED={os.environ.get('PYTHONHASHSEED')}: "
          f"smallest gap between neighbouring JAX scores {min(gaps)!r}; differing rows {differ}")
    shutil.rmtree(root)


if __name__ == "__main__":
    main()
