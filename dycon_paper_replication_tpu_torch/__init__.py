"""PyTorch/CUDA port of the DyCON framework, for one NVIDIA H100.

Beside the JAX package `dycon_paper_replication_tpu`, which is the
reference it is held against. Public functions keep the JAX layout,
channels-last (B, D1, D2, D3, C). Entry points run on `cuda` unless the
caller passes `device="cpu"`; the fold-2 conv runs through the hand-written
Hopper kernel in `ops/csrc/`.
"""
