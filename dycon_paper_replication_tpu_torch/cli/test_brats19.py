"""Offline BraTS-2019 evaluation: the best checkpoint of the flag-derived
snapshot path, the dense sliding window (stride 16/4) over the val.txt
cases <root>/data/<name>.h5 (or .npz), largest-component post-processing and
the Dice/Jaccard/HD95/ASD table, through test_pancreas.run_test.

Counterpart of dycon_paper_replication_tpu/cli/test_brats19.py. As the
reference's offline test, it reads the volumes in their stored view
(`--axial 0`, the default); `--axial 1` evaluates in the axial view that
training and validation use. `--group` and `--data_parallel` are
test_pancreas's (the auto group of the sliding-window test CLIs). Run as
    python -m dycon_paper_replication_tpu_torch.cli.test_brats19 --root_path DATA ...
"""

from __future__ import annotations

import os

from ..data.datasets import brats_case_paths
from ..eval import iter_volumes
from .test_pancreas import build_parser, run_test


def main(argv=None):
    p = build_parser()
    p.set_defaults(root_path="../data/BraTS2019", exp="BraTS2019", labelnum=25,
                   list_name="val.txt")
    p.add_argument("--axial", type=int, default=0, choices=[0, 1],
                   help="1 = evaluate in the axial view (the reference's offline test: stored)")
    args = p.parse_args(argv)
    with open(os.path.join(args.root_path, args.list_name)) as f:
        names = [line.strip() for line in f if line.strip()]
    paths = brats_case_paths(args.root_path, names)
    return run_test(args, "brats19", iter_volumes(paths, axial_transpose=bool(args.axial)))


if __name__ == "__main__":
    main()
