"""DyCON training on Pancreas-CT, the port's entry point.

Counterpart of dycon_paper_replication_tpu/cli/train_pancreas.py, with the
same flags (those the port implements) plus --device (default cuda):

    python -m dycon_paper_replication_tpu_torch.cli.train_pancreas \
        --root_dir ../data/Pancreas --labelnum 12 --batch_size 8
"""

from __future__ import annotations

from ..config import config_from_args
from ..train.trainer import train


def main(argv=None) -> float:
    return train(config_from_args("pancreas", argv))


if __name__ == "__main__":
    main()
