"""Eval pipeline CLI (counterpart of uniir_tpu/tools/pipeline.py): embed /
hard-negative mining / index / retrieve / error analysis, in that order.

Same flags as the JAX CLI, and `--device`.  Over several processes
(`UNIIR_TPU_MULTIHOST=1` under torchrun, one process a card) every stage
runs on every rank: the embedder writes part files that rank 0 joins, the
search shards the pool over the ranks, and rank 0 writes the index, run
files and reports (`core.mesh`).

    UNIIR_TPU_MULTIHOST=1 torchrun --nproc_per_node 8 -m uniir_tpu_torch.tools.pipeline --config_path embed.yaml ...

    python -m uniir_tpu_torch.tools.pipeline --config_path embed.yaml \
        --uniir_dir /data/UniIR --mbeir_data_dir /data/UniIR/mbeir_data --enable_embed

UniRAG's raw retrieval with complement pairs takes the embedder's config for
the complement queries:

    python -m uniir_tpu_torch.tools.pipeline --config_path retrieval.yaml \
        --query_embedder_config_path embed.yaml --enable_retrieval ...
"""

from __future__ import annotations

import argparse

from uniir_tpu_torch.core import mesh
from uniir_tpu_torch.core.config import load_config
from uniir_tpu_torch.core.device import resolve_device


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="uniir_tpu_torch eval pipeline")
    parser.add_argument("--uniir_dir", type=str, default="/data/UniIR")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data")
    parser.add_argument("--config_path", default="config.yaml", help="Path to the config file.")
    parser.add_argument(
        "--query_embedder_config_path",
        default="",
        help="Embedder config for complement retrieval in raw_retrieval mode.",
    )
    parser.add_argument("--enable_embed", action="store_true", help="Run the embedder sweep")
    parser.add_argument("--enable_create_index", action="store_true", help="Enable create index")
    parser.add_argument("--enable_hard_negative_mining", action="store_true", help="Enable hard negative mining")
    parser.add_argument("--enable_retrieval", action="store_true", help="Enable retrieval")
    parser.add_argument("--run_automatic_error_analysis", action="store_true", help="Run error analysis")
    parser.add_argument("--device", default=None,
                        help="cuda (the default: cuda:LOCAL_RANK under torchrun; without a card it is an error) or cpu")
    return parser.parse_args(argv)


def _load(path: str, args):
    config = load_config(path)
    config.uniir_dir = args.uniir_dir
    config.mbeir_data_dir = args.mbeir_data_dir
    return config


def main(argv=None):
    args = parse_arguments(argv)
    args.device = resolve_device(args.device)
    mesh.maybe_initialize_distributed(args.device)
    config = _load(args.config_path, args)
    print(config.to_yaml())
    query_embedder_config = _load(args.query_embedder_config_path, args) if args.query_embedder_config_path else None

    if args.enable_embed:
        from uniir_tpu_torch.models.registry import build_model_from_config
        from uniir_tpu_torch.retrieval.embedder import generate_embeds_for_config

        generate_embeds_for_config(build_model_from_config(config, device=args.device), config)

    if args.enable_hard_negative_mining:
        from uniir_tpu_torch.retrieval.hard_negs import run_hard_negative_mining

        run_hard_negative_mining(config, device=args.device)

    if args.enable_create_index:
        from uniir_tpu_torch.retrieval.index import create_index

        create_index(config)

    if args.enable_retrieval:
        from uniir_tpu_torch.retrieval.eval import run_retrieval

        run_retrieval(config, device=args.device, query_embedder_config=query_embedder_config)

    if args.run_automatic_error_analysis:
        from uniir_tpu_torch.retrieval.analyst import run_automatic_error_analysis

        run_automatic_error_analysis(config)


if __name__ == "__main__":
    main()
