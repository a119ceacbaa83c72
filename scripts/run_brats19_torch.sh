#!/bin/bash
# DyCON training on BraTS-2019 with the PyTorch/CUDA port, at the canonical
# flags of scripts/run_brats19.sh (reference run_brats19.sh), on the card
python -m dycon_paper_replication_tpu_torch.cli.train_brats19 \
  --root_dir "../data/BraTS2019" \
  --exp "BraTS2019" \
  --model "unet_3D" \
  --max_iterations 20000 \
  --temp 0.6 \
  --batch_size 8 \
  --labelnum 25 \
  --device cuda
