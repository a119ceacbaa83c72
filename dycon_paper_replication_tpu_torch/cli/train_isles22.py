"""DyCON training on ISLES-2022, the port's entry point.

Counterpart of dycon_paper_replication_tpu/cli/train_isles22.py: the
isles22 config defaults (teacher in eval mode, poly LR, n-class Dice, the
derived mask kernel, FeCL over row tiles of 512 through the fused
closed-form backward, whole-volume validation), the same flags (those the
port implements) plus --device (default cuda):

    python -m dycon_paper_replication_tpu_torch.cli.train_isles22 \
        --root_dir ../data/ISLES22 --labelnum 10 --batch_size 8
"""

from __future__ import annotations

from ..config import config_from_args
from ..train.trainer import train


def main(argv=None) -> float:
    return train(config_from_args("isles22", argv))


if __name__ == "__main__":
    main()
