"""``python -m spoofsv_torch.cli.metagen``: VCTK preprocessing and split lists.

Port of :mod:`spoofsv_tpu.cli.metagen`, the reference ``metagen.py:7-9``
surface: ``-c/--config_path`` (and ``--no-resample``).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ps = argparse.ArgumentParser(description="Generate meta-data")
    ps.add_argument("-c", "--config_path", type=str, required=True)
    ps.add_argument("--no-resample", action="store_true",
                    help="only write path lists (wav22/ already populated)")
    args = ps.parse_args(argv)

    from spoofsv_torch.config import load_config
    from spoofsv_torch.data.vctk import prepare_vctk

    cfg = load_config(args.config_path)
    print(f"Your data root directory is {cfg.data_root_dir}")
    prepare_vctk(cfg, resample=not args.no_resample)


if __name__ == "__main__":
    main()
