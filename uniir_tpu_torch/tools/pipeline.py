"""Eval pipeline CLI (counterpart of uniir_tpu/tools/pipeline.py): embed / index / retrieve.

Same flags as the JAX CLI.  Hard-negative mining and the error analyst are
not ported yet and raise.

    python -m uniir_tpu_torch.tools.pipeline --config_path embed.yaml \
        --uniir_dir /data/UniIR --mbeir_data_dir /data/UniIR/mbeir_data --enable_embed
"""

from __future__ import annotations

import argparse

from uniir_tpu_torch.core.config import load_config


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="uniir_tpu_torch eval pipeline")
    parser.add_argument("--uniir_dir", type=str, default="/data/UniIR")
    parser.add_argument("--mbeir_data_dir", type=str, default="/data/UniIR/mbeir_data")
    parser.add_argument("--config_path", default="config.yaml", help="Path to the config file.")
    parser.add_argument("--enable_embed", action="store_true", help="Run the embedder sweep")
    parser.add_argument("--enable_create_index", action="store_true", help="Enable create index")
    parser.add_argument("--enable_hard_negative_mining", action="store_true", help="Enable hard negative mining")
    parser.add_argument("--enable_retrieval", action="store_true", help="Enable retrieval")
    parser.add_argument("--run_automatic_error_analysis", action="store_true", help="Run error analysis")
    parser.add_argument("--device", default=None, help="cuda (the default; without a card it is an error) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    if args.enable_hard_negative_mining or args.run_automatic_error_analysis:
        raise NotImplementedError(
            "hard-negative mining and the error analyst are not ported to uniir_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 7)"
        )
    config = load_config(args.config_path)
    config.uniir_dir = args.uniir_dir
    config.mbeir_data_dir = args.mbeir_data_dir
    print(config.to_yaml())

    if args.enable_embed:
        from uniir_tpu_torch.models.registry import build_model_from_config
        from uniir_tpu_torch.retrieval.embedder import generate_embeds_for_config

        generate_embeds_for_config(build_model_from_config(config, device=args.device), config)

    if args.enable_create_index:
        from uniir_tpu_torch.retrieval.index import create_index

        create_index(config)

    if args.enable_retrieval:
        from uniir_tpu_torch.retrieval.eval import run_retrieval

        run_retrieval(config, device=args.device)


if __name__ == "__main__":
    main()
