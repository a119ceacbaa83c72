#!/bin/bash
# DyCON training on ISLES-2022 with the PyTorch/CUDA port, at the canonical
# flags of scripts/run_ISLES22.sh (reference run_ISLES22.sh), on the card
python -m dycon_paper_replication_tpu_torch.cli.train_isles22 \
  --root_dir "../data/ISLES22" \
  --exp "ISLES22" \
  --model "unet_3D" \
  --max_iterations 20000 \
  --temp 0.6 \
  --batch_size 2 \
  --labeled_bs 1 \
  --labelnum 10 \
  --patch_size 96 96 64 \
  --device cuda
