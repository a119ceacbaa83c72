"""BraTS-2019 NIfTI -> case files (the reference's
BraTS19_DataPreprocessing.py): per case one modality (T2 > FLAIR > T1ce >
T1) z-scored and min-max normalised, the whole-tumour binary label, both
resampled to (192, 192, 64).

Counterpart of dycon_paper_replication_tpu/cli/preprocess_brats19.py, with
the same flags plus `--format h5|npz` (default h5, the JAX package's; npz
needs no h5py and is read by the port's datasets). Run as
    python -m dycon_paper_replication_tpu_torch.cli.preprocess_brats19 \
        --input_dir MICCAI_BraTS_2019_Data_Training --output_dir DATA/data [--format npz]
"""

from __future__ import annotations

import argparse

from ..data.preprocess import FORMATS, preprocess_brats2019


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="BraTS-2019 NIfTI -> case files")
    p.add_argument("--input_dir", type=str, required=True,
                   help="MICCAI_BraTS_2019_Data_Training dir (HGG/ + LGG/)")
    p.add_argument("--output_dir", type=str, required=True,
                   help="destination for <case>.h5 / <case>.npz files")
    p.add_argument("--cases", type=str, nargs="*", default=None,
                   help="specific case names (default: all found)")
    p.add_argument("--format", type=str, default="h5", choices=FORMATS,
                   help="h5 (needs h5py) or npz (numpy only)")
    args = p.parse_args(argv)
    return preprocess_brats2019(args.input_dir, args.output_dir, args.cases, fmt=args.format)


if __name__ == "__main__":
    main()
