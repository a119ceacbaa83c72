"""DyCON training on BraTS-2019, the port's entry point.

Counterpart of dycon_paper_replication_tpu/cli/train_brats19.py: the brats19
config defaults (patch 96^3, batch 8 of which 4 labeled, labelnum 25, the
teacher in train mode, binary Dice, the fixed mask kernel, dense FeCL,
sliding-window validation over val.txt in axial view), the same flags
(those the port implements) plus --device (default cuda):

    python -m dycon_paper_replication_tpu_torch.cli.train_brats19 \
        --root_dir ../data/BraTS2019 --labelnum 25 --batch_size 8
"""

from __future__ import annotations

from ..config import config_from_args
from ..train.trainer import Trainer


def main(argv=None) -> float:
    return Trainer(config_from_args("brats19", argv)).run()


if __name__ == "__main__":
    main()
