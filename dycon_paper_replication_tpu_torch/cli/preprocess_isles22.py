"""ISLES-2022 BIDS NIfTI -> case files (the reference's
ISLES22_DataPreprocessing.py): DWI preferred (ADC, FLAIR as fallbacks), the
mask from derivatives/, resampled to (112, 112, 64), and a reproducible
80/20 train/val split (seed 42) into train.list / val.list.

Counterpart of dycon_paper_replication_tpu/cli/preprocess_isles22.py, with
the same flags plus `--format h5|npz` (default h5, the JAX package's; npz
needs no h5py and is read by the port's datasets). Run as
    python -m dycon_paper_replication_tpu_torch.cli.preprocess_isles22 \
        --input_dir ISLES-2022 --output_dir DATA/ISLES22 [--format npz]
"""

from __future__ import annotations

import argparse

from ..data.preprocess import FORMATS, preprocess_isles22


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ISLES-2022 BIDS NIfTI -> case files")
    p.add_argument("--input_dir", type=str, required=True,
                   help="ISLES-2022 BIDS root (sub-strokecase*/ + derivatives/)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--modality", type=str, default="dwi", choices=["dwi", "adc", "flair"])
    p.add_argument("--cases", type=str, nargs="*", default=None)
    p.add_argument("--format", type=str, default="h5", choices=FORMATS,
                   help="h5 (needs h5py) or npz (numpy only)")
    args = p.parse_args(argv)
    return preprocess_isles22(args.input_dir, args.output_dir, args.modality, args.cases,
                              fmt=args.format)


if __name__ == "__main__":
    main()
