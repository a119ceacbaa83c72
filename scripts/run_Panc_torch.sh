#!/bin/bash
# DyCON training on Pancreas-CT with the PyTorch/CUDA port, at the canonical
# flags of scripts/run_Panc.sh (reference run_Panc.sh), on the card
python -m dycon_paper_replication_tpu_torch.cli.train_pancreas \
  --root_dir "../data/Pancreas" \
  --exp "PancreasCT" \
  --model "unet_3D" \
  --max_iterations 20000 \
  --temp 0.6 \
  --batch_size 8 \
  --labelnum 12 \
  --device cuda
