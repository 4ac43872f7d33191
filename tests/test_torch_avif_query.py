"""An AVIF image query through the port's interactive retriever against the JAX package's (as
tests/test_torch_tools.py holds the GIF / TIFF / WebP queries): the default save, a premultiplied-alpha file and
a sequence's first frame give the JAX retriever's candidates and its query embeddings within EMBED_ATOL in fp32
(the `trees` fixture: the seeded test-tiny model, its index and MBEIR tree, built once here)."""

import os

import numpy as np
import pytest
import torch

import avif_files as files
from tests.test_torch_tools import EMBED_ATOL, _retrievers, trees  # noqa: F401 - the module-scoped fixture
from uniir_tpu_torch.train.steps import make_embed_step


@pytest.mark.parametrize("form", ["default", "premultiplied", "sequence"])
def test_interactive_retriever_reads_avif_like_jax(trees, form):  # noqa: F811
    import jax.numpy as jnp
    from PIL import Image

    from uniir_tpu.train.steps import make_embed_step as jax_make_embed_step

    arr = np.asarray(Image.open(os.path.join(trees.mbeir, "images", "cand_1.jpg")).convert("RGB"))
    img = Image.fromarray(arr)
    if form == "premultiplied":
        img = Image.fromarray(np.dstack([arr, 255 - arr[..., 1]]))
    options = {"default": {}, "premultiplied": {"alpha_premultiplied": True},
               "sequence": {"save_all": True, "append_images": [img.transpose(Image.FLIP_LEFT_RIGHT)]}}[form]
    import io

    buf = io.BytesIO()
    img.save(buf, "AVIF", **options)
    rel = f"images/query_avif_{form}.avif"
    with open(os.path.join(trees.mbeir, rel), "wb") as f:
        f.write(buf.getvalue())
    np.testing.assert_array_equal(files.pillow_rgb(buf.getvalue()).shape, arr.shape)
    ours, ref = _retrievers(trees)
    for retriever in (ours, ref):
        retriever.add_queries([("image", None, rel, "text"), ("image,text", "a red dress", rel, "image")])
    got, want = ours.retrieve(k=5), ref.retrieve(k=5)
    assert len(got) == 2 and all(len(r) == 5 for r in got)
    assert got == want
    ours.embed_step = make_embed_step(trees.bundle.model, torch.float32)
    ref.embed_step = jax_make_embed_step(trees.jax_bundle.model, out_dtype=jnp.float32)
    emb, ref_emb = ours._embed_queries(), ref._embed_queries()
    assert emb.dtype == np.float32 and emb.shape == (2, 16)
    np.testing.assert_allclose(emb, np.asarray(ref_emb), atol=EMBED_ATOL)
