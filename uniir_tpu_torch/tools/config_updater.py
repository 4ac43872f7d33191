"""YAML config updater (counterpart of uniir_tpu/tools/config_updater.py).

Rewrites the instruct status (`experiment.instruct_status` and
`data_config.enable_query_instruct`) of the embed / index / retrieval yamls,
as every run script does before it launches.  Files are read and written by
`core.yaml_subset` (no PyYAML).

    python -m uniir_tpu_torch.tools.config_updater --update_mbeir_yaml_instruct_status \
        --mbeir_yaml_file_path embed.yaml --enable_instruct True
"""

from __future__ import annotations

import argparse

from uniir_tpu_torch.core import yaml_subset


def load_yaml(file_path: str) -> dict:
    return yaml_subset.load(file_path)


def save_yaml(data: dict, file_path: str) -> None:
    yaml_subset.dump(data, file_path, sort_keys=True)  # keys sorted, as the reference's yaml.safe_dump writes them


def update_mbeir_yaml_instruct_status(yaml_file_path: str, enable_instruct: bool) -> None:
    print(f"Updating YAML {yaml_file_path} for instruct status: {enable_instruct}")
    yaml_data = load_yaml(yaml_file_path)
    yaml_data["experiment"]["instruct_status"] = "Instruct" if enable_instruct else "NoInstruct"
    if "data_config" in yaml_data:
        yaml_data["data_config"]["enable_query_instruct"] = bool(enable_instruct)
    else:
        print(f"YAML {yaml_file_path} does not have data_config.")
    save_yaml(yaml_data, yaml_file_path)


def update_mbeir_config_dir_instruct_status(config_dir: str, enable_instruct: bool) -> None:
    for name in ("embed.yaml", "index.yaml", "retrieval.yaml"):
        update_mbeir_yaml_instruct_status(f"{config_dir}/{name}", enable_instruct)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Updating experiment configurations.")
    parser.add_argument("--update_mbeir_yaml_instruct_status", action="store_true")
    parser.add_argument("--mbeir_yaml_file_path", type=str, default="ReplaceMe")
    parser.add_argument("--enable_instruct", required=True, choices=["True", "False"])
    args = parser.parse_args(argv)
    if args.update_mbeir_yaml_instruct_status:
        if args.mbeir_yaml_file_path == "ReplaceMe":
            print("The default YAML file path has not been replaced with an actual file path.")
        update_mbeir_yaml_instruct_status(args.mbeir_yaml_file_path, args.enable_instruct == "True")


if __name__ == "__main__":
    main()
