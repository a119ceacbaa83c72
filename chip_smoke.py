#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout and drives the port's
paths, Pancreas sliding-window evaluation, Pancreas DyCON training,
ISLES-2022 training with whole-volume evaluation, BraTS-2019 training
with sliding-window evaluation, and the VNet's (`--model vnet`) Pancreas
training and evaluation and ASPP's (`--use_aspp 1`) training, bf16
compute (`--compute_dtype bfloat16`) of both families, each through its
CLI, and then volume groups with pipelined evaluation, data-parallel
training, the preprocess CLIs, the JAX package's trained Pancreas
checkpoint's test and the SSL ablation, every training path twice, whose
reruns must be bit-identical, and last the host loop's settings (the
pipelined loop against the synchronous one, gradient rematerialisation,
the narrow wire dtypes).
Phases, each timed on its own line:

  1. the card's name and power limit (nvidia-smi);
  2. build K1 (ops/csrc/folded_conv3.cu), K1-dW (ops/csrc/folded_conv3_dw.cu)
     and K2 (ops/csrc/fecl_fused.cu), one nvcc each, in parallel, printing
     ptxas's registers, shared memory, spills and any wgmma or setmaxnreg
     warning per kernel instance; the SASS (cuobjdump) of K1, K1-dW and K2
     must hold tensor-core MMA (HMMA) instructions in every instance of
     their kernels, and so must the bf16 kernels' mma.sync instances (L_in
     8); their wgmma instances (K1-bf16 and K1-dW-bf16 at L_in % 64 == 0,
     the same two libraries) must hold HGMMA;
  3. K1 against its plain F.conv3d version at the 8 full-width shapes one
     eval patch forward gives it (patch 96^3, B = PATCH_BATCH), float32 with
     TF32 off, tolerance 1e-4 * max|plain|; its time beside the plain
     version's, one cuDNN conv call's (library_ms) and two bounds: the
     float32 one (CUDA cores) and that of its three TF32 passes on the
     tensor cores, which is its `bound_ms` in the kernels line;
  4. K1 forward the same way at the 8 shapes one training step gives it
     (patch 112x112x96, B = TRAIN_BATCH); then NaN through FoldedConv3Fn at
     one of them: a few NaN voxels in x must make y NaN at exactly the
     outputs they reach, and a few in the cotangent dx at exactly the
     voxels they reach (the train step's NaN/Inf skip depends on it);
  5. K1-dW at the 8 shapes one training step gives it (patch 112x112x96,
     B = TRAIN_BATCH): the kernel and the float32 plain version (eight slab
     einsums) against a float64 plain version on the card; pass if the
     kernel's max error is at most max(1e-4 * max|ref|, 4 x the float32
     plain version's error), and a rerun is bit-identical; its time beside
     the plain version's, one cuDNN weight-grad call's and two bounds: the
     float32 one (CUDA cores) and that of its three TF32 passes on the
     tensor cores, which is its `bound_ms` in the kernels line;
  6. dx through K1 at the 7 training shapes whose input needs a gradient,
     against the plain version with K1's tolerance: time beside one cuDNN
     data-grad call's and the two bounds;
  7. one full-width folded UnetConv3 block (up_concat1, B = TRAIN_BATCH)
     through FoldedConv3Fn against autograd of the plain folded path (with
     K1's forward values, so both sides share their ReLU masks): the
     gradients of x and of every conv weight within 1e-4 * max|plain|, of
     each bias (in front of an InstanceNorm, so truly 0) within 1e-4 *
     max|plain| of its conv's weight gradient;
  8. one train step on the card against the same step on the CPU from
     equal states (train/device_check.py: a full-width folded UNet3D,
     patch (32, 32, 16), batch 4 of which 2 labeled, dropout 0; the losses,
     parameters, momentum, EMA teacher and BatchNorm stats within
     tests/test_torch_train_step.py's path-scaled tolerances, the CPU step
     taking the card's side at the kinks within the margin), with 16 + 7
     K1 and 8 K1-dW launches;
  9. fecl: K2 forward and backward at the ISLES defaults (B 8, N 9216,
     D 256, teacher on) against its plain twin in float32 and in float64
     (phase_fecl: the gates), a rerun bit-identical, a NaN row NaN in the
     loss, the rows whose cross-pair count K2 and the float32 einsum
     disagree on; times and TFLOP/s on K2's own products (8, as the JAX
     algorithm's, 4 each way) beside the 3xTF32 bound of the JAX
     algorithm's (its `bound_ms`, as for K1 and K1-dW) and the float32 one
     (no single PyTorch call computes it: library_ms null);
 10. k1_isles: K1 forward, dx and K1-dW at the 8 ISLES training shapes
     (patch 96x96x64, B = TRAIN_BATCH: non-cubic fold grids), the gates of
     4, 6 and 5; K1 at the 8 shapes of one ISLES whole-volume forward
     (batch 1, the (112, 112, 73) volume padded to (112, 112, 80)), the
     gate of 3;
 11. step_vs_cpu_isles: phase 8's check in its ISLES case (fused FeCL: one
     K2 call each way on the card, the twin on the CPU);
 12. the folded UNet3D (through K1) against the plain UNet3D on one eval
     patch batch with the same weights, tolerance 1e-4 * max|plain|;
 13. evaluation end to end: seeded weights in the JAX layout through the
     weight mapper into a checkpoint, one synthetic (144, 144, 112) volume
     written with numpy (80 patches at stride 16/4, all origins even so the
     folded path runs), the port's test_pancreas CLI on it with the K1
     launch count set to 0 before and read after (it must be 8 per forward
     chunk), and its label map against the plain engine's (>= 99.99 % of
     voxels agree);
 14. training end to end: a synthetic Pancreas tree of 16 training and 2
     validation cases of (120, 120, 100) as .npz, the train CLI's Trainer
     at the Pancreas defaults for 2 steps (val and save every 2), with the
     K1, K1 dx and K1-dW counts set to 0 before each step and read after it
     (16 + 7 = 23 K1 and 8 K1-dW per step), finite losses, step 2 and the
     checkpoint; then `--max_iterations 3 --resume <the step-2
     checkpoint>` (the run directory encodes max_iterations, so `auto`
     would look in a new one), which must start from exactly the saved
     state at step 2 and end at 3; ms per step, peak memory, validation
     vols/s;
 15. isles_train: the same for ISLES-2022 through the ISLES train CLI's
     Trainer at its defaults (50 + 2 synthetic (112, 112, 73) .npz cases,
     whole-volume validation), with one K2 forward and one K2 backward
     call per step besides the K1 and K1-dW launches;
 16. isles_eval: the ISLES test CLI on the first run's best checkpoint
     with --group 1 (8 K1 launches per volume, at batch 1), its label maps
     against the plain (NDHWC) model's whole-volume prediction with the
     same weights (>= 99.99 % of voxels agree); vols/s;
 17. k1_brats: K1 forward, dx and K1-dW at the 8 BraTS training shapes
     (patch 96^3, B = TRAIN_BATCH: the eval fold grids at twice the eval
     batch), the gates of 4, 6 and 5;
 18. brats_train: the same as 14 for BraTS-2019 through the BraTS train
     CLI's Trainer at its defaults (30 + 2 synthetic .npz cases stored as
     (128, 112, 100), read in the axial view (100, 112, 128); sliding-window
     validation at stride 64/64), 16 + 7 K1 and 8 K1-dW launches and no K2
     call per step; train/HD95 logged at every step (hd95_every is 1 at
     val_every 2), perf/step_ms_p50 and perf/host_rss_gb at every
     validation, and a code snapshot that holds the port's package and no
     built library;
 19. monitor: the similarity monitor's histograms of one BraTS step's
     embeddings and FeCL mask on the card against the same call on the
     CPU: equal totals, edges within 1e-5 relative, each bin within the
     count of pair similarities within 1e-5 x (hi - lo) of a bin edge;
 20. brats_eval: the BraTS test CLI on the first run's best checkpoint with
     --axial 0 and --axial 1 (8 K1 launches per forward chunk), its label
     maps against the plain (NDHWC) engine's with the same weights (>=
     99.99 % of voxels agree); vols/s;
 21. k1_vnet: K1 forward, dx and K1-dW at the 6 VNet training shapes
     (`--model vnet`, Pancreas defaults: patch 112x112x96, B = TRAIN_BATCH;
     enc0 is K1's L_in = 8 instance in the VALID direction, to_phase 0), the
     gates of 4, 6 and 5; NaN through FoldedConv3Fn at enc0 (forward: its
     input is the image, so no dx) and at enc1.conv1 (forward and dx);
 22. vnet_model: the folded VNet (through K1, 6 launches a forward) against
     the plain (NDHWC) VNet on one eval patch batch with the same weights,
     eval mode, within tests/test_vnet_folded.py's tolerances: seg and sdf
     atol 5e-4 + rtol 5e-4, features atol 1e-3 + rtol 1e-3;
 23. vnet_train: the Pancreas train CLI's Trainer with `--model vnet` at the
     Pancreas defaults on phase 14's tree, 2 steps and a resume to 3 as in
     14, with 12 + 5 K1 and 6 K1-dW launches a step; the run directory
     VNET_..., the best checkpoint vnet_best_model.pt;
 24. vnet_eval: the Pancreas test CLI with `--model vnet` on that best
     checkpoint (2 volumes, 18 patches each at stride 16/4: 6 K1 launches per
     forward chunk), its label maps (before the largest-component step)
     against the plain (NDHWC) VNet's sliding window with the same weights
     (>= 99.99 % of voxels agree); vols/s;
 25. aspp_train: the Pancreas train CLI's Trainer with `--use_aspp 1`, 2
     steps and a resume to 3 (16 + 7 K1 and 8 K1-dW a step), finite
     losses; the checkpoint holds ASPP's parameters and running stats, and
     the resume restores them exactly;
 26. step_vs_cpu_vnet: phase 8's check in its "vnet" case (the VNet,
     folded, BatchNorm in train mode: 12 + 5 K1 and 6 K1-dW on the card)
     and its "aspp" case (the UNet3D with ASPP, patch (32, 32, 32));
 27. k1_bf16: K1-bf16 at the 8 eval shapes (B = PATCH_BATCH) and the 8
     Pancreas training shapes, its dx at the 7 and K1-dW-bf16 at the 8
     (B = TRAIN_BATCH), on bf16 operands, each against a float64 conv of
     the same bf16 values: max |kernel - ref| <= max(2^-8 max|ref|, 2 x the
     bf16 plain version's max error against ref), a rerun bit-identical;
     times beside the plain version's, cuDNN's bf16 fprop, dgrad or wgrad
     (library_ms) and the bf16 bound (FLOPs / 989 TFLOP/s or bf16 bytes /
     3.35 TB/s); NaN through FoldedConv3Fn in bf16 (forward and dx). The
     shapes at L_in % 64 == 0 run the wgmma instances, conv1.conv1 (L_in 8)
     the mma.sync ones;
 28. k1_vnet_bf16: the same at the VNet's 6 convs (enc0 at L_in 8, VALID),
     NaN at enc0 and enc1.conv1;
 29. bf16_model: the folded bf16 UNet3D and VNet against the plain bf16
     (NDHWC) model on one eval patch batch, each output within 2 x
     max|plain bf16 - plain float32| (the float32 model the yardstick; the
     rule of tests/test_torch_bf16.py), K1-bf16 launches only;
 30. bf16_train: the Pancreas train CLI's Trainer with --compute_dtype
     bfloat16 at the Pancreas defaults, 2 steps and a resume to 3 (16 + 7
     K1-bf16 and 8 K1-dW-bf16 a step, 0 float32 launches), then with
     --model vnet 2 steps and a resume to 3 (12 + 5 and 6); ms per step and
     peak memory beside phases 14's and 23's float32 figures;
 31. bf16_eval: test_pancreas --compute_dtype bfloat16 on that checkpoint
     (8 K1-bf16 launches per forward chunk, none in float32), its labels
     against the plain bf16 engine's (the image rounded through float16 in
     both): the share of labels that differ at most 2 x the share that
     differs between the plain bf16 and the plain float32 engines; and
     against the float32 folded engine's (recorded); vols/s;
 32. step_vs_cpu_bf16: phase 8's check in its "pancreas_bf16" and
     "vnet_bf16" cases (train/device_check.py: the bf16 tolerances, a
     float64 CPU step the yardstick);
 33. group_eval: volume groups and pipelining at the JAX headline protocol
     (8 seeded volumes of (192, 192, 64), patch 96^3, stride 16/4: 49
     patches a volume), the folded UNet3D in float32 and then bf16, patch
     batch 4: group 1 depth 1, group 8 depth 1 and group 8 depth 2, each's
     vols/s on its own line beside the device-resident ceiling of its group
     size (`device_resident_runner`) and its K1 launches (8 a forward chunk:
     104 chunks at group 1, 98 at group 8); the grouped scores within 1e-6 of
     group 1's and the labels equal wherever |score - 0.5| > 1e-6, and
     whether they were bit-identical; two replicas (`devices=[cuda:0,
     cuda:0]`) held the same way; the ISLES whole-volume engine at groups 2
     and 4 against group 1 (8 volumes of (112, 112, 73), vols/s each): its
     forward's batch changes with the group, so the batched logits are held
     within 1e-4 x max|logit| of the single ones and the largest probability
     difference d is printed, and the labels must equal group 1's wherever
     the single probability is more than max(d, 1e-6) from 0.5;
 34. dp_train: the Pancreas train CLI's entry (train/trainer.py:train) at the
     Pancreas defaults with --data_parallel 1 (one spawned rank, NCCL) for 2
     steps against the plain trainer at the same seed (logged scalars within
     rtol 2e-5, the step-2 checkpoint within atol 1e-5 + rtol 1e-4); then one
     train step on the global batch of 8 (patch 112x112x96, 4 labeled) in two
     spawned ranks on the one card, joined by gloo over CUDA tensors (NCCL
     cannot put two ranks on one GPU), against the same step in one process:
     the UNet3D and the VNet, loss rtol 2e-5, the student's and teacher's
     parameters atol 1e-5 + rtol 1e-4 (tests/test_train.py's DP test), their
     BatchNorm running stats within 1e-5 + 1e-3 x the tensor's largest
     magnitude (STATS_REL), rank 0's K1 / dx / K1-dW launches; ms per step
     for one and two ranks;
 35. preprocess: fabricated NIfTI trees written with the port's nifti.save (2
     BraTS cases of 240 x 240 x 155, four modalities and seg; 5 ISLES cases of
     (112, 112, 73), DWI and mask), both preprocess CLIs with --format npz,
     the cases read back through BraTS2019 and ISLESDataset: the target
     shapes (192, 192, 64) and (112, 112, 64), binary labels, the 4 / 1 split;
 36. trained_eval: the JAX package's trained Pancreas checkpoint
     (trained/pancreas_unet3d_r05_best.pt, converted by
     scripts/convert_jax_checkpoint.py) through test_pancreas
     --max_iterations 20000 on the first 4 of the 20 canonical test
     volumes (make_pancreas(n_train=62, n_test=20, shape=(128, 128, 112),
     seed=1)), in float32 and bf16: 8 K1 (or K1-bf16) launches per forward
     chunk and none of the other instance, each volume's Dice within 0.002
     of its row of the TPU's log and the mean within 0.001 of the log's
     mean over the same volumes, the float32 labels equal to the plain
     engine's on >= 99.99 % of voxels (phase_trained_eval says each);
 37. k1_ablation: K1 forward, dx and K1-dW at the 8 shapes of the SSL
     ablation's training step (patch 64x64x48, B = ABLATION_BATCH = 4), the
     gates of 4, 6 and 5;
 38. ssl_ablation: scripts/ssl_ablation_torch.py through its main on a cut
     of its protocol (8 + 2 hard volumes, both arms 200 iterations, the
     dense test on the 2): 16 + 7 K1 and 8 K1-dW float32 launches a step
     and no bf16 one, finite losses, the sup arm's loss equal to its
     supervised terms, the best checkpoints written and read back by the
     test CLI, finite metrics (phase_ssl_ablation says each);
 39. determinism: `--deterministic 1` (the trainer's default:
     torch.use_deterministic_algorithms(True), CUBLAS_WORKSPACE_CONFIG
     :4096:8) gives bit-identical reruns: each training path (the Pancreas
     defaults, ISLES with K2, BraTS, the VNet, ASPP, the bf16 UNet3D) run
     twice through its train CLI's Trainer, 3 steps each from one seed, the
     student, teacher, momentum, every running stat and every logged info/
     and train/ scalar equal (torch.equal); so the Pancreas Trainer in two
     gloo ranks on the card (--data_parallel 2), and the SSL ablation's
     DyCON arm rerun at phase 38's cut (its validation curve, every logged
     scalar and its best checkpoint against phase 38's). Printed, not
     gated: one full-width step run twice with the mode off and twice with
     it on (the UNet3D and with ASPP), the arm's cut rerun with the mode off
     against the mode-on run, the arm's UnCL beta at --iters 100 and 200,
     and each path's ms per step with the mode on, on without its NaN fill
     of uninitialised memory, and off (phase_determinism says each);
 40. host_loop: the BraTS trainer at its defaults (patch 96^3, batch 8 of
     which 4 labeled), HOST_LOOP_ITERS iterations from one seed at
     --fetch_ahead 0, 1, 1 and 0 (1 is the default), must end torch.equal in
     the student, the teacher, the momentum, every running stat and the
     step, with every step dispatched under
     torch.cuda.set_sync_debug_mode("error") (a host read inside the step
     raises, as far as the mode detects one); printed, not gated: ms per
     iteration of the loop, a dispatch's host time, the median device span
     of a step and the device's idle share between steps (CUDA events),
     for BraTS, the bf16 VNet (Pancreas defaults) and the SSL ablation's
     DyCON arm at its cut (phase_host_loop says each);
 41. remat: one full-width Pancreas float32 step (_seeded_case) with
     --remat full against none from one state: the loss within rtol 1e-6,
     every parameter within 1e-6, every running stat torch.equal, the
     dropout generator left in the same state, and a lower peak of
     torch.cuda.max_memory_allocated; the same for one VNet step (31
     BatchNorms), and for one bf16 UNet3D step at the bf16 gate (each leaf
     within 2 x the leaf's |bf16 - float32| of the step without remat);
     both ms per step and both peaks printed;
 42. wire: one trainer step at --wire_dtype float16: the batch on the card
     is float16 and uint8, and bit-equal to the float32 batch of the same
     loader settings rounded to float16 (labels equal);
 43. a `{"kernels": [...]}` line, one entry per kernel and path (K1 in
     eval, K1 forward, K1 dx and K1-dW in Pancreas training, K1 forward,
     dx and K1-dW and K2 forward and backward in ISLES training, K1 in
     ISLES whole-volume evaluation, K1 forward, dx and K1-dW in BraTS
     training, K1 forward, dx and K1-dW in VNet training; the bf16
     instances in bf16 eval, Pancreas and VNet bf16 training, with
     bound_kind "bf16"; K1 and K1-bf16 in trained_eval; K1 forward, dx and
     K1-dW in the SSL ablation), each with that
     path's launch count and the sums
     over its shapes; then `{"ok": true, "device": {...}}` last.

Any failed check raises and the process exits non-zero. It exits non-zero
without a result when CUDA is unavailable, and when run outside the
repository (the port's package cannot be imported). It writes only under a
temporary directory, apart from the kernel build directory of the package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

PATCH = (96, 96, 96)
STRIDE_XY, STRIDE_Z = 16, 4
PATCH_BATCH = 4
VOLUME = (144, 144, 112)
TRAIN_BATCH = 8
TRAIN_VOLUME = (120, 120, 100)
TRAIN_STEPS, RESUME_STEPS = 2, 3  # 4, 6 before phases 33-35 were added
SEED = 0
REPS = 3  # timed repetitions per kernel call (5 before the ISLES phases were added)
# published dense peaks: (float32 FLOP/s on the CUDA cores, TF32 FLOP/s on
# the tensor cores, HBM bytes/s, bf16 FLOP/s on the tensor cores)
PEAKS = {"H100 PCIe": (51.2e12, 378e12, 2.0e12, 756e12),
         "H100 NVL": (60e12, 417.5e12, 3.9e12, 835e12),
         "H200": (67e12, 495e12, 4.8e12, 989e12), "H100": (67e12, 495e12, 3.35e12, 989e12)}
# the bf16 kernels' gate (k1_bf16): max |kernel - float64 conv of the same
# bf16 values| <= max(BF16_REL x max|ref|, BF16_PLAIN x the bf16 plain
# version's max error against the same ref)
BF16_REL, BF16_PLAIN = 2.0 ** -8, 2.0
# the folded bf16 model against the plain bf16 one (bf16_model): max|diff|
# <= BF16_MODEL_K x max|plain bf16 - plain float32| (tests/test_torch_bf16.py)
BF16_MODEL_K = 2.0
# bf16 evaluation (bf16_eval): the share of voxels whose label differs
# between the CLI (folded bf16) and the plain bf16 engine <= BF16_MODEL_K x
# the share that differs between the plain bf16 and the plain float32
# engines. A fixed gate of 99.9 % equal labels, stated before the first run,
# failed there at 99.802 % (the phase's docstring says why it was replaced)
BF16_VNET_STEPS, BF16_VNET_RESUME_STEPS = 2, 3
# (layer, fold grid G of the input, L_in, L_out, to_phase) for one eval patch forward
K1_SHAPES = [
    ("conv1.conv1", (48,) * 3, 8, 128, 1), ("conv1.conv2", (49,) * 3, 128, 128, 0),
    ("conv2.conv1", (24,) * 3, 128, 256, 1), ("conv2.conv2", (25,) * 3, 256, 256, 0),
    ("up_concat2.conv1", (24,) * 3, 768, 256, 1), ("up_concat2.conv2", (25,) * 3, 256, 256, 0),
    ("up_concat1.conv1", (48,) * 3, 384, 128, 1), ("up_concat1.conv2", (49,) * 3, 128, 128, 0),
]
# the same 8 convs at the training patch 112x112x96: fold grid (G1, G2, G3)
TRAIN_SHAPES = [
    ("conv1.conv1", (56, 56, 48), 8, 128, 1), ("conv1.conv2", (57, 57, 49), 128, 128, 0),
    ("conv2.conv1", (28, 28, 24), 128, 256, 1), ("conv2.conv2", (29, 29, 25), 256, 256, 0),
    ("up_concat2.conv1", (28, 28, 24), 768, 256, 1), ("up_concat2.conv2", (29, 29, 25), 256, 256, 0),
    ("up_concat1.conv1", (56, 56, 48), 384, 128, 1), ("up_concat1.conv2", (57, 57, 49), 128, 128, 0),
]
K1_REPLACES = "dycon_paper_replication_tpu/ops/folded_conv_pallas.py:107 (folded_conv3_pallas)"
# ISLES-2022 training: patch 96x96x64, projection scale 4, so the FeCL runs
# over N = 24 * 24 * 16 = 9216 rows of D = 256 (K2), and the 8 K1 convs see
# non-cubic fold grids
ISLES_PATCH = (96, 96, 64)
ISLES_SHAPES = [
    ("conv1.conv1", (48, 48, 32), 8, 128, 1), ("conv1.conv2", (49, 49, 33), 128, 128, 0),
    ("conv2.conv1", (24, 24, 16), 128, 256, 1), ("conv2.conv2", (25, 25, 17), 256, 256, 0),
    ("up_concat2.conv1", (24, 24, 16), 768, 256, 1), ("up_concat2.conv2", (25, 25, 17), 256, 256, 0),
    ("up_concat1.conv1", (48, 48, 32), 384, 128, 1), ("up_concat1.conv2", (49, 49, 33), 128, 128, 0),
]
ISLES_VOLUME = (112, 112, 73)  # not a multiple of 16: the whole-volume pad runs
# the 8 K1 convs of one whole-volume forward (batch 1): the volume padded to
# (112, 112, 80), so fold grid (56, 56, 40) at the first level
ISLES_EVAL_SHAPES = [
    ("conv1.conv1", (56, 56, 40), 8, 128, 1), ("conv1.conv2", (57, 57, 41), 128, 128, 0),
    ("conv2.conv1", (28, 28, 20), 128, 256, 1), ("conv2.conv2", (29, 29, 21), 256, 256, 0),
    ("up_concat2.conv1", (28, 28, 20), 768, 256, 1), ("up_concat2.conv2", (29, 29, 21), 256, 256, 0),
    ("up_concat1.conv1", (56, 56, 40), 384, 128, 1), ("up_concat1.conv2", (57, 57, 41), 128, 128, 0),
]
ISLES_TRAIN_CASES, ISLES_VAL_CASES = 50, 2  # labelnum 10 = 45 labeled volumes, 5 not
# BraTS-2019 training: patch 96^3 at batch TRAIN_BATCH, so K1's fold grids
# are the eval shapes' (K1_SHAPES) at twice the eval batch. The synthetic
# cases are stored sagittal (128, 112, 100), (100, 112, 128) in the axial
# view the trainer reads: no cube (a missing or doubled transpose changes
# shapes), even on every axis (every sliding-window origin is even, so the
# folded path runs) and above 96 on every axis (the windowed read runs)
BRATS_STORED = (128, 112, 100)
BRATS_TRAIN_CASES, BRATS_VAL_CASES = 30, 2  # labelnum 25: 25 labeled, 5 not
# the VNet (--model vnet) at the Pancreas training defaults (patch 112x112x96,
# B = TRAIN_BATCH): its six folded convs. The input is folded at phase 1, so
# enc0 runs K1's L_in = 8 instance in the VALID direction (to_phase 0); enc0
# has no dx (its input is the image)
VNET_TRAIN_SHAPES = [
    ("enc0.conv0", (57, 57, 49), 8, 128, 0), ("enc1.conv0", (28, 28, 24), 256, 256, 1),
    ("enc1.conv1", (29, 29, 25), 256, 256, 0), ("dec2.conv0", (28, 28, 24), 256, 256, 1),
    ("dec2.conv1", (29, 29, 25), 256, 256, 0), ("dec3.conv0", (56, 56, 48), 128, 128, 1),
]
# K1 forward (student + teacher), K1 dx and K1-dW launches of one train step
UNET_STEP_LAUNCHES = dict(k1=16, k1_dx=7, k1_dw=8)
VNET_STEP_LAUNCHES = dict(k1=12, k1_dx=5, k1_dw=6)
ASPP_STEPS, ASPP_RESUME_STEPS = 2, 3
FECL_D = 256
K2_SOURCE = "dycon_paper_replication_tpu_torch/ops/csrc/fecl_fused.cu"
K2_REPLACES = "dycon_paper_replication_tpu/ops/fecl_fused.py:66 (_build: core / core_bwd)"


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def _wrap_steps(trainer, wrap):
    """Replace a Trainer's full step and its light one (step_diagnostics
    "cadence"; the same function under "always") by wrap(step)."""
    full, light = trainer.train_step, trainer.train_step_light
    trainer.train_step = wrap(full)
    trainer.train_step_light = trainer.train_step if light is full else wrap(light)


def _time_ms(torch, fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops, nbytes, peaks):
    """The least time for `flops` and `nbytes` (each input read once, each
    output written once) two ways: in float32 on the CUDA cores (bound_ms,
    ops_ms, bound_by), and as three TF32 passes on the tensor cores
    (tf32x3_*); bytes_ms is common to both."""
    t_bytes = nbytes / peaks[2] * 1e3
    t_ops, t_tc = flops / peaks[0] * 1e3, 3 * flops / peaks[1] * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), ops_ms=t_ops, bytes_ms=t_bytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                tf32x3_bound_ms=max(t_tc, t_bytes), tf32x3_ops_ms=t_tc,
                tf32x3_bound_by="operations" if t_tc >= t_bytes else "bytes")


def _bound_bf16(flops, nbytes, peaks):
    """The least time for `flops` on the bf16 tensor cores and `nbytes` of
    bf16 operands (each input read once, each output written once)."""
    t_bytes, t_ops = nbytes / peaks[2] * 1e3, flops / peaks[3] * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), ops_ms=t_ops, bytes_ms=t_bytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _kernel_entry(name, path, source, replaces, launches, rows, bound="float32"):
    """One `{"kernels": [...]}` entry of one path: its launches in that
    path's run and the sums over the shapes that path gives the kernel once
    each (one eval patch-batch forward, or one train step). `bound` names
    the arithmetic of the kernel's bound_ms: "float32" (CUDA cores),
    "tf32x3" (three TF32 passes on the tensor cores) or "bf16" (one bf16
    pass on the tensor cores, bf16 operand bytes; its rows hold no float32
    bound)."""
    pre = "tf32x3_" if bound == "tf32x3" else ""
    ops = sum(r[pre + "ops_ms"] for r in rows)
    err = max(r["max_abs_err"] for r in rows)
    return dict(name=name, path=path, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, max_err=err,
                ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r[pre + "bound_ms"] for r in rows),
                bound_by="operations" if ops >= sum(r["bytes_ms"] for r in rows) else "bytes",
                bound_kind=bound,
                float32_bound_ms=None if bound == "bf16" else sum(r["bound_ms"] for r in rows),
                library_ms=sum(r["library_ms"] for r in rows), shapes=rows)


def check_sass(path, nvcc, kernel, label, op="HMMA"):
    """cuobjdump -sass of a kernel library: every instance of the kernel
    named `kernel` must hold tensor-core instructions `op`: HMMA (mma.sync)
    or HGMMA (wgmma). Returns {function: count}."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        if kernel in name:
            counts[name] = sum(1 for line in block.splitlines() if op in line)
    _check(counts and all(counts.values()),
           f"{label}'s SASS: {op} instructions per kernel instance {counts}")
    return counts


def phase_k1(torch, device, gen, peaks, shapes, batch, tag):
    """K1 against its plain version at one path's shapes and batch."""
    import torch.nn.functional as F

    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_plain)

    rows = []
    for layer, g, lin, lout, to_phase in shapes:
        x = torch.randn(batch, *g, lin, device=device, generator=gen)
        wf = torch.randn(2, 2, 2, lin, lout, device=device, generator=gen) / math.sqrt(8 * lin)
        y = folded_conv3.launch(x, wf, to_phase=to_phase)
        want = folded_conv3_plain(x, wf, to_phase=to_phase)
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        scale = want.abs().max().item()
        _check(bool(torch.isfinite(y).all()) and err <= 1e-4 * scale,
               f"K1 {layer}: max abs err {err} > 1e-4 * {scale}")
        xn, wn = x.permute(0, 4, 1, 2, 3), wf.permute(4, 3, 0, 1, 2).contiguous()
        pad = 1 if to_phase == 1 else 0
        ms = _time_ms(torch, lambda: folded_conv3.launch(x, wf, to_phase=to_phase))
        plain_ms = _time_ms(torch, lambda: folded_conv3_plain(x, wf, to_phase=to_phase))
        library_ms = _time_ms(torch, lambda: F.conv3d(xn, wn, padding=pad))
        flops = 2 * batch * math.prod(y.shape[1:4]) * lin * lout * 8
        bound = _bound(flops, 4 * (x.numel() + wf.numel() + y.numel()), peaks)
        row = dict(layer=layer, x=list(x.shape), wf=list(wf.shape), to_phase=to_phase,
                   max_abs_err=err, max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, tflops=flops / ms / 1e9,
                   tf32x3_share=bound["tf32x3_bound_ms"] / ms,
                   float32_share=bound["bound_ms"] / ms, **bound)
        rows.append(row)
        print(tag, json.dumps(row), flush=True)
        del x, wf, y, want, xn, wn
    return rows


def phase_nan(torch, device, gen, shape, dtype=None):
    """NaN through FoldedConv3Fn at one training shape: y is NaN at exactly
    the outputs that a NaN voxel of x reaches, and dx at exactly the voxels
    that a NaN voxel of the cotangent reaches (each reach counted by a conv
    of the NaN indicator with a 2^3 box of ones; every lane of wf is
    nonzero). At L_in = 8 (a first conv, whose input is the image) only the
    forward: the model never asks for that dx. `dtype` bfloat16 runs the
    bf16 instances."""
    import torch.nn.functional as F

    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import FoldedConv3Fn

    layer, g, lin, lout, to_phase = shape
    q = tuple(n + (1 if to_phase == 1 else -1) for n in g)

    def with_nans(t):
        idx = [torch.randint(0, n, (4,), device=device, generator=gen) for n in t.shape[:4]]
        t[idx[0], idx[1], idx[2], idx[3], 0] = float("nan")
        return t

    def reach(t, phase):
        hit = torch.isnan(t).any(-1).float()[:, None]
        box = torch.ones(1, 1, 2, 2, 2, device=device)
        return (F.conv3d(hit, box, padding=1 if phase == 1 else 0)[:, 0] > 0)[..., None]

    dtype = dtype or torch.float32
    x = with_nans(torch.randn(TRAIN_BATCH, *g, lin, device=device, generator=gen).to(dtype))
    wf = (torch.randn(2, 2, 2, lin, lout, device=device, generator=gen)
          / math.sqrt(8 * lin)).to(dtype)
    cot = with_nans(torch.randn(TRAIN_BATCH, *q, lout, device=device, generator=gen).to(dtype))
    with_dx = lin != 8
    xr = x.clone().requires_grad_(with_dx)
    y = FoldedConv3Fn.apply(xr, wf, to_phase)
    if with_dx:
        y.backward(cot)
    torch.cuda.synchronize()
    checks = [("y", y, x, to_phase)] + ([("dx", xr.grad, cot, 1 - to_phase)] if with_dx else [])
    for name, got, src, phase in checks:
        want = reach(src, phase).expand_as(got)
        n_nan = int(want.sum().item()) // got.shape[-1]
        print(f"nan {layer} {name} ({got.dtype}): {n_nan} voxels reached by "
              f"{int(torch.isnan(src).sum())} NaN inputs")
        _check(n_nan > 0 and torch.equal(torch.isnan(got), want) and
               bool(torch.isfinite(got[~want]).all()),
               f"NaN through FoldedConv3Fn ({layer}, {name}): not NaN at exactly the "
               f"{n_nan} voxels reached")
    del x, wf, cot, xr, y


def _conv_backward(torch, dy, x, wf, to_phase, mask):
    """One cuDNN convolution_backward call on the NCDHW-permuted tensors."""
    pad = [1, 1, 1] if to_phase == 1 else [0, 0, 0]
    return torch.ops.aten.convolution_backward(
        dy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), wf.permute(4, 3, 0, 1, 2), None,
        [1, 1, 1], pad, [1, 1, 1], False, [0, 0, 0], 1, mask)


def phase_dw(torch, device, gen, peaks, shapes=TRAIN_SHAPES, tag="k1_dw", batch=TRAIN_BATCH):
    """K1-dW against float32 and float64 plain versions at one path's
    training shapes."""
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3_dw, folded_conv3_dw_plain)

    rows = []
    for layer, g, lin, lout, to_phase in shapes:
        q = tuple(n + (1 if to_phase == 1 else -1) for n in g)
        x = torch.randn(batch, *g, lin, device=device, generator=gen)
        dy = torch.randn(batch, *q, lout, device=device, generator=gen)
        dwf = folded_conv3_dw.launch(x, dy, to_phase=to_phase)
        again = folded_conv3_dw.launch(x, dy, to_phase=to_phase)
        plain = folded_conv3_dw_plain(x, dy, to_phase=to_phase)
        ref = folded_conv3_dw_plain(x.double(), dy.double(), to_phase=to_phase)
        torch.cuda.synchronize()
        err = (dwf.double() - ref).abs().max().item()
        err_plain = (plain.double() - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = max(1e-4 * scale, 4 * err_plain)
        del ref
        _check(bool(torch.isfinite(dwf).all()) and err <= tol,
               f"K1-dW {layer}: max abs err {err} > {tol} (plain float32 err {err_plain})")
        _check(torch.equal(dwf, again), f"K1-dW {layer}: a rerun is not bit-identical")
        wf = torch.empty(2, 2, 2, lin, lout, device=device)
        lib = _conv_backward(torch, dy, x, wf, to_phase, [False, True, False])[1]
        lib_err = (lib.permute(2, 3, 4, 1, 0) - plain).abs().max().item()
        ms = _time_ms(torch, lambda: folded_conv3_dw.launch(x, dy, to_phase=to_phase))
        plain_ms = _time_ms(torch, lambda: folded_conv3_dw_plain(x, dy, to_phase=to_phase))
        library_ms = _time_ms(
            torch, lambda: _conv_backward(torch, dy, x, wf, to_phase, [False, True, False]))
        flops = 2 * batch * math.prod(q) * lin * lout * 8
        bound = _bound(flops, 4 * (x.numel() + dy.numel() + dwf.numel()), peaks)
        row = dict(layer=layer, x=list(x.shape), dy=list(dy.shape), to_phase=to_phase,
                   max_abs_err=err, plain_f32_err=err_plain, tol=tol, max_abs_ref=scale,
                   library_vs_plain=lib_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   tflops=flops / ms / 1e9, tf32x3_share=bound["tf32x3_bound_ms"] / ms,
                   float32_share=bound["bound_ms"] / ms, **bound)
        rows.append(row)
        print(tag, json.dumps(row), flush=True)
        del x, dy, dwf, again, plain, lib
    return rows


def phase_dx(torch, device, gen, peaks, shapes=TRAIN_SHAPES, tag="k1_dx", batch=TRAIN_BATCH):
    """dx through K1 (taps flipped and transposed, opposite phase) at one
    path's training shapes whose input needs a gradient."""
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3_dx, folded_conv3_plain)

    rows = []
    for layer, g, lin, lout, to_phase in shapes[1:]:
        q = tuple(n + (1 if to_phase == 1 else -1) for n in g)
        x = torch.empty(batch, *g, lin, device=device)
        dy = torch.randn(batch, *q, lout, device=device, generator=gen)
        wf = torch.randn(2, 2, 2, lin, lout, device=device, generator=gen) / math.sqrt(8 * lout)
        wf_t = wf.flip(0, 1, 2).transpose(3, 4).contiguous()
        dx = folded_conv3_dx.launch(dy, wf_t, to_phase=1 - to_phase)
        want = folded_conv3_plain(dy, wf_t, to_phase=1 - to_phase)
        lib = _conv_backward(torch, dy, x, wf, to_phase, [True, False, False])[0]
        torch.cuda.synchronize()
        err = (dx - want).abs().max().item()
        scale = want.abs().max().item()
        lib_err = (lib.permute(0, 2, 3, 4, 1) - want).abs().max().item()
        _check(bool(torch.isfinite(dx).all()) and err <= 1e-4 * scale,
               f"dx {layer}: max abs err {err} > 1e-4 * {scale}")
        _check(lib_err <= 1e-4 * scale, f"dx {layer}: library differs by {lib_err}")
        ms = _time_ms(torch, lambda: folded_conv3_dx.launch(dy, wf_t, to_phase=1 - to_phase))
        plain_ms = _time_ms(torch, lambda: folded_conv3_plain(dy, wf_t, to_phase=1 - to_phase))
        library_ms = _time_ms(
            torch, lambda: _conv_backward(torch, dy, x, wf, to_phase, [True, False, False]))
        flops = 2 * batch * math.prod(g) * lin * lout * 8
        bound = _bound(flops, 4 * (dy.numel() + wf.numel() + dx.numel()), peaks)
        row = dict(layer=layer, dy=list(dy.shape), dx=list(dx.shape), to_phase=1 - to_phase,
                   max_abs_err=err, max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, tflops=flops / ms / 1e9,
                   tf32x3_share=bound["tf32x3_bound_ms"] / ms,
                   float32_share=bound["bound_ms"] / ms, **bound)
        rows.append(row)
        print(tag, json.dumps(row), flush=True)
        del x, dy, wf, wf_t, dx, want, lib
    return rows


def phase_grad(torch, device, gen):
    """A full-width folded up_concat1 block: FoldedConv3Fn (K1, K1 dx, K1-dW)
    against autograd of the plain folded path (module doc: tolerances)."""
    from dycon_paper_replication_tpu_torch.models.unet3d import UnetConv3
    from dycon_paper_replication_tpu_torch.models.unet3d_folded import _folded_block
    from dycon_paper_replication_tpu_torch.ops import folding
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        K1ValuedPlainConvFn, folded_conv3, folded_conv3_dw, folded_conv3_dx)

    block = UnetConv3(48, 16).to(device)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, device=device, generator=gen) * 0.1)
    grid = TRAIN_SHAPES[6][1]
    n_valid = 8 * math.prod(grid)
    x = torch.randn(TRAIN_BATCH, *grid, 384, device=device, generator=gen)
    cot = torch.randn(TRAIN_BATCH, *grid, 128, device=device, generator=gen)
    grads = {}
    for name, ctx in (("kernels", contextlib.nullcontext()),
                      ("plain", mock.patch.object(folding, "FoldedConv3Fn", K1ValuedPlainConvFn))):
        block.zero_grad(set_to_none=True)
        xr = x.clone().requires_grad_()
        counts = (folded_conv3.launches, folded_conv3_dx.launches, folded_conv3_dw.launches)
        with ctx:
            y = _folded_block(block, xr, grid=grid, n_valid=n_valid)
            (y * cot).sum().backward()
        torch.cuda.synchronize()
        grads[name] = {"x": xr.grad, **{k: p.grad for k, p in block.named_parameters()}}
        ran = [c.launches - c0 for c, c0 in
               zip((folded_conv3, folded_conv3_dx, folded_conv3_dw), counts)]
        print(f"grad {name}: launches K1 {ran[0]}, K1 dx {ran[1]}, K1-dW {ran[2]}")
        _check(ran == ([2, 2, 2] if name == "kernels" else [0, 0, 0]),
               f"{name}: launches {ran}")
    for k, want in grads["plain"].items():
        got = grads["kernels"][k]
        _check(got is not None, f"grad {k}: no gradient through FoldedConv3Fn")
        diff = (got - want).abs().max().item()
        # A conv bias in front of an InstanceNorm has a true gradient of 0:
        # on each side it is the rounding residue of a sum of ~10^7 terms
        # that cancel. Its scale is that of such a sum, its weight gradient's.
        ref = grads["plain"][k[:-1] + "w"] if k.endswith(".b") else want
        scale = ref.abs().max().item()
        print(f"grad {k}: max abs diff {diff} (max |plain| {want.abs().max().item()}, "
              f"scale {scale})")
        _check(bool(torch.isfinite(got).all()) and diff <= 1e-4 * scale,
               f"grad {k}: FoldedConv3Fn differs from plain autograd by {diff}")


def phase_step_vs_cpu(torch, device, config="pancreas"):
    """One train step on the card against the same step on the CPU from
    equal states, the CPU step taking the card's side at kinks within the
    margin (train/device_check.py: the cases, the margin and the
    tolerances). The ISLES case runs the fused FeCL: one K2 call each way;
    the VNet case 12 + 5 K1 and 6 K1-dW launches; the bf16 cases
    ("pancreas_bf16", "vnet_bf16") launch the bf16 instances only."""
    from dycon_paper_replication_tpu_torch.ops.fecl_fused import fecl_bwd, fecl_fwd
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dx)
    from dycon_paper_replication_tpu_torch.train.device_check import check_step
    from dycon_paper_replication_tpu_torch.train.step import SCALAR_METRICS

    counters = (folded_conv3, folded_conv3_dx, folded_conv3_dw, fecl_fwd, fecl_bwd)
    per_step = VNET_STEP_LAUNCHES if config.startswith("vnet") else UNET_STEP_LAUNCHES
    want = list(per_step.values()) + ([1, 1] if config == "isles22" else [0, 0])
    before = [c.launches for c in counters]
    other = torch.float32 if config.endswith("_bf16") else torch.bfloat16
    other_before = [c.by_dtype[other] for c in counters[:3]]
    diffs, scalars, worst, sides = check_step(device, config=config)
    ran = [c.launches - n for c, n in zip(counters, before)]
    other_ran = [c.by_dtype[other] - n for c, n in zip(counters[:3], other_before)]
    tag = f"step vs cpu ({config}):"
    print(tag, json.dumps(dict(zip(SCALAR_METRICS, scalars.tolist()))),
          f"launches K1 {ran[0]}, K1 dx {ran[1]}, K1-dW {ran[2]}, K2 {ran[3]} + {ran[4]}")
    print(tag, "nearest its tolerance per group (difference / tolerance):", json.dumps(worst))
    print(tag, "kink sides (values within the margin; of them, on the card's side and not "
          "their own):", json.dumps(sides))
    for line in diffs:
        print(tag, line)
    _check(not diffs, f"the card's train step ({config}) differs from the CPU's at "
                      f"{len(diffs)} leaves")
    _check(ran == want and other_ran == [0, 0, 0],
           f"step vs cpu ({config}): launches {ran}, want {want}; {other} {other_ran}")


def _isles_fecl_inputs(torch, device, gen):
    """The fused FeCL's inputs at the ISLES defaults: the (B, N) binary mask
    pooled from ellipsoid labels at the ISLES patch as train/step.py pools it
    (the derived kernel, 4 per axis), and L2-normalised student and teacher
    rows from a seed: a shared direction, one per class and noise, so that
    pairs of different class have cs spread around 0.3, the cross term's
    threshold."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.data.synthetic import _ellipsoid_volume
    from dycon_paper_replication_tpu_torch.ops.resize import avg_pool_nonoverlap

    rng = np.random.default_rng(SEED)
    labels = np.stack([_ellipsoid_volume(rng, ISLES_PATCH)[1] for _ in range(TRAIN_BATCH)])
    mask = avg_pool_nonoverlap(torch.from_numpy(labels).to(device).float(), (4, 4, 4))
    mask = (mask > 0.5).float().reshape(TRAIN_BATCH, -1).contiguous()

    def unit(t):
        return t / t.norm(dim=-1, keepdim=True)

    def noise(*shape):
        return torch.randn(*shape, FECL_D, device=device, generator=gen) / math.sqrt(FECL_D)

    shared, classes = unit(noise(1)[0]), unit(noise(2))
    feat = unit(shared + classes[mask.long()] + 1.2 * noise(*mask.shape)).contiguous()
    tfeat = unit(feat + 0.3 * noise(*mask.shape)).contiguous()
    return feat, mask, tfeat


def phase_fecl(torch, device, gen, peaks):
    """K2 (the fused FeCL, forward and backward) at the ISLES defaults (B 8,
    N 9216, D 256, teacher on, thresholds 1.3 / 0.3) against its plain twin
    on the card in float32 and a float64 twin: the loss within 1e-5 relative
    of float64, dF within 1e-4 x max|dF of the float32 twin|; the float64
    twin takes K2's side (cs > neg_thresh, from float32 cs of the same
    inputs) at pairs within 1e-5 of the threshold, as the step check does
    with its margin; a rerun bit-identical; a NaN row makes the loss NaN.
    K2's own cs is not an output: the rows whose hard-pair count (c_cnt)
    differs from the float32 twin's, whose cs is an einsum, and the sum of
    those differences (a lower bound on the pairs whose side differs) are
    printed. Times beside two bounds from the JAX algorithm's count of
    B x N x N x D products (3 forward, 5 backward): three TF32 passes on the
    tensor cores (the float32-accurate rate K1, K1-dW and K2 run at, the
    kernels line's bound_ms) and float32 on the CUDA cores; TFLOP/s on the
    JAX algorithm's products and on K2's own (4 forward, 4 backward)."""
    from dycon_paper_replication_tpu_torch.ops import fecl_fused as ff

    feat, mask, tfeat = _isles_fecl_inputs(torch, device, gen)
    b, n, d = feat.shape
    kw = dict(temperature=0.6, gamma=2.0, use_focal=True, pos_thresh=1.3, neg_thresh=0.3,
              row_chunk=512)
    o = ff.FeclOptions(0.6, 2.0, True, 1.3, 0.3, 1.0, 512)

    def loss_and_grad(f, m, t):
        f = f.clone().requires_grad_()
        loss = ff.fecl_loss_fused(f, m, t, **kw)
        loss.backward()
        return loss.detach(), f.grad

    def twin():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(ff, "fecl_fwd", ff._twin_forward))
        stack.enter_context(mock.patch.object(ff, "fecl_bwd", ff._twin_backward))
        return stack

    res = ff.fecl_fwd.launch(feat, mask, tfeat, o)
    loss, grad = loss_and_grad(feat, mask, tfeat)
    res2 = ff.fecl_fwd.launch(feat, mask, tfeat, o)
    loss2, grad2 = loss_and_grad(feat, mask, tfeat)
    torch.cuda.synchronize()
    _check(all(torch.equal(x, y) for x, y in zip(res, res2)) and torch.equal(loss, loss2)
           and torch.equal(grad, grad2), "K2: a rerun is not bit-identical")
    with twin():
        res_p = ff._twin_forward(feat, mask, tfeat, o)
        loss_p, grad_p = loss_and_grad(feat, mask, tfeat)
    near = {}

    def k2_side(rows, cs, neg_t, own):
        f, t = (torch.nn.functional.pad(x, (0, 0, 0, cs.shape[2] - n)) for x in (feat, tfeat))
        card = torch.einsum("btd,bnd->btn", f[:, rows], t) > float(neg_t)
        close = (cs - neg_t).abs() <= 1e-5
        side = torch.where(close, card, own)
        near[rows.start] = (int(close.sum()), int((side != own).sum()))
        return side

    f64, m64, t64 = feat.double(), mask.double(), tfeat.double()
    with twin(), mock.patch.object(ff, "cross_side", k2_side):
        res_64 = ff._twin_forward(f64, m64, t64, o)
        loss_64, grad_64 = loss_and_grad(f64, m64, t64)
    torch.cuda.synchronize()
    cnt = float(res[6].sum())
    cnt_diff = (res[6] - res_p[6]).abs()
    err_loss = abs(float(loss) - float(loss_64))
    err_loss_plain = abs(float(loss_p) - float(loss_64))
    err_grad = (grad - grad_p).abs().max().item()
    scale_grad = grad_p.abs().max().item()
    names = ("col_max", "S", "row_sum", "row_sum_unf", "rho", "c_sum", "c_cnt")
    resid = {k: dict(vs_plain=(x - y).abs().max().item() / max(y.abs().max().item(), 1e-30),
                     vs_f64=(x.double() - z).abs().max().item() / max(z.abs().max().item(), 1e-30))
             for k, x, y, z in zip(names, res, res_p, res_64)}
    print("fecl: loss K2", float(loss), "plain", float(loss_p), "float64", float(loss_64),
          f"(|K2 - f64| {err_loss}, |plain - f64| {err_loss_plain}); hard pairs {cnt:.0f}, "
          f"within 1e-5 of the threshold {sum(v[0] for v in near.values())}, on K2's side "
          f"and not their own {sum(v[1] for v in near.values())}")
    print(f"fecl: rows whose hard-pair count differs from the float32 einsum's "
          f"{int((cnt_diff > 0).sum())}, pairs at least {int(cnt_diff.sum())}")
    print("fecl: dF max |K2 - plain|", err_grad, "max |dF plain|", scale_grad,
          "max |K2 - f64|", (grad.double() - grad_64).abs().max().item(),
          "max |plain - f64|", (grad_p.double() - grad_64).abs().max().item())
    print("fecl: residuals, max difference / max |reference|:", json.dumps(resid))
    _check(math.isfinite(float(loss)) and err_loss <= 1e-5 * abs(float(loss_64)),
           f"K2 loss {float(loss)} vs float64 {float(loss_64)}")
    _check(bool(torch.isfinite(grad).all()) and err_grad <= 1e-4 * scale_grad,
           f"K2 dF differs from the plain twin's by {err_grad} (max |dF| {scale_grad})")
    bad = feat.clone()
    bad[b - 1, n // 3, 7] = float("nan")
    with torch.no_grad():
        _check(bool(torch.isnan(ff.fecl_loss_fused(bad, mask, tfeat, **kw))),
               "K2: a NaN row does not make the loss NaN")
    del grad2, res2, res_p, res_64, grad_64, f64, m64, t64, bad

    col_max, s_all, rho = res[0], res[1], res[4]
    a_all = (ff._row_weights(mask) / (b * n)).contiguous()
    g_cross = 1.0 / (cnt + ff.EPS)
    ms_fwd = _time_ms(torch, lambda: ff.fecl_fwd.launch(feat, mask, tfeat, o))
    ms_bwd = _time_ms(torch, lambda: ff.fecl_bwd.launch(feat, mask, tfeat, col_max, s_all, rho,
                                                        a_all, g_cross, o))
    plain_fwd = _time_ms(torch, lambda: ff._twin_forward(feat, mask, tfeat, o), reps=2)
    plain_bwd = _time_ms(torch, lambda: ff._twin_backward(feat, mask, tfeat, col_max, s_all, rho,
                                                           a_all, g_cross, o), reps=2)
    product = 2 * b * n * n * d
    rows = {}
    for name, ms, plain_ms, products, own, nbytes, err in (
            ("fwd", ms_fwd, plain_fwd, 3, 4, 4 * (2 * b * n * d + 8 * b * n), err_loss),
            ("bwd", ms_bwd, plain_bwd, 5, 4, 4 * (3 * b * n * d + 5 * b * n), err_grad)):
        bound = _bound(products * product, nbytes, peaks)
        rows[name] = dict(shape=[b, n, d], products=products, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=None,
                          tflops=products * product / ms / 1e9, own_products=own,
                          own_tflops=own * product / ms / 1e9,
                          float32_share=bound["bound_ms"] / ms,
                          tf32x3_share=bound["tf32x3_bound_ms"] / ms, **bound)
        print("fecl", name, json.dumps(rows[name]), flush=True)
    return rows


def phase_model(torch, device, gen, nets):
    """Full-width model: folded (through K1) against plain, eval mode."""
    x = torch.rand(PATCH_BATCH, *PATCH, 1, device=device, generator=gen)
    with torch.inference_mode():
        _, seg_f, feat_f = nets["folded"](x)
        _, seg_p, feat_p = nets["NDHWC"](x)
    torch.cuda.synchronize()
    for name, a, b in (("seg", seg_f, seg_p), ("features", feat_f, feat_p)):
        diff = (a - b).abs().max().item()
        scale = b.abs().max().item()
        print(f"model {name}: max abs diff folded vs plain {diff} (max |plain| {scale})")
        _check(bool(torch.isfinite(a).all()) and diff <= 1e-4 * scale,
               f"folded model {name} differs from plain by {diff}")
    _check(tuple(seg_f.shape) == (PATCH_BATCH, *PATCH, 2), f"seg shape {tuple(seg_f.shape)}")


def phase_eval(torch, nets, tmp):
    """Evaluation end to end through the test CLI. Returns
    the K1 launch count of the CLI run."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.cli import test_pancreas
    from dycon_paper_replication_tpu_torch.config import make_config
    from dycon_paper_replication_tpu_torch.data.synthetic import _ellipsoid_volume, write_case
    from dycon_paper_replication_tpu_torch.eval import SlidingWindowInference, compute_origins
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    root = os.path.join(tmp, "Pancreas")
    os.makedirs(os.path.join(root, "Pancreas_data"))
    image, label = _ellipsoid_volume(np.random.default_rng(SEED), VOLUME)
    write_case(os.path.join(root, "Pancreas_data", "PANCREAS_t0000.npz"), image, label)
    with open(os.path.join(root, "test1.list"), "w") as f:
        f.write("PANCREAS_t0000.npz\n")
    runs = os.path.join(tmp, "runs")
    snapshot = make_config("pancreas", snapshot_root=runs).snapshot_path()
    checkpoint.save_checkpoint(checkpoint.best_checkpoint_path(snapshot, "unet_3D"),
                               nets["folded"])
    origins = compute_origins(VOLUME, PATCH, STRIDE_XY, STRIDE_Z)
    n_chunks = math.ceil(len(origins) / PATCH_BATCH)
    _check(len(origins) == 80 and not (origins % 2).any(), f"{len(origins)} origins")

    argv = ["--root_path", root, "--snapshot_root", runs, "--device", "cuda",
            "--patch_batch", str(PATCH_BATCH), "--compute_dtype", "float32"]
    folded_conv3.launches = 0
    t_cli = time.perf_counter()
    avg = test_pancreas.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t_cli
    launches = folded_conv3.launches
    print(f"e2e: {len(origins)} patches, {n_chunks} chunks, K1 launches {launches}, "
          f"cli wall {cli_s:.3f} s, {1.0 / cli_s:.4f} vols/s")
    _check(launches == 8 * n_chunks, f"K1 launches {launches} != 8 * {n_chunks}")
    _check(len(avg) == 4 and all(math.isfinite(v) for v in avg), f"metrics {avg}")

    # the folded engine's label map against the plain engine's
    sw_f = SlidingWindowInference(nets["folded"], PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH)
    sw_p = SlidingWindowInference(nets["NDHWC"], PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH)
    t_sw = time.perf_counter()
    label_f, score_f = sw_f(image)
    torch.cuda.synchronize()
    sw_s = time.perf_counter() - t_sw
    t_sw = time.perf_counter()
    label_p, score_p = sw_p(image)
    torch.cuda.synchronize()
    sw_plain_s = time.perf_counter() - t_sw
    agree = float((label_f == label_p).mean())
    print(f"sliding window: folded {sw_s:.3f} s ({1.0 / sw_s:.4f} vols/s), plain "
          f"{sw_plain_s:.3f} s; label agreement {agree:.7f}; max |score diff| "
          f"{float(np.abs(score_f - score_p).max())}; foreground {int(label_f.sum())} voxels")
    _check(label_f.shape == VOLUME and np.isfinite(score_f).all(), "folded engine output")
    _check(agree >= 0.9999, f"label agreement {agree} < 0.9999")
    return launches


def _drive_trainer(torch, dataset, argv, counters, want, tag, n_steps=TRAIN_STEPS,
                   n_resume=RESUME_STEPS):
    """The train CLI's Trainer for `dataset`: `argv` + --max_iterations
    n_steps, then a resume from the step-n_steps checkpoint to n_resume,
    which must start from exactly the saved state. Every step runs with
    each counter of `counters` ({name: wrapper}) set to 0 before it and read
    after it, and must launch `want` ({name: count}), with finite scalars
    and no skip. Returns the launch sums, ms per step (the median of steps
    2..n_steps), peak memory, the validation times, the first run's
    snapshot path, the names of the saved state's tensors, and the
    diagnostic outputs of the last step."""
    from dycon_paper_replication_tpu_torch.config import config_from_args
    from dycon_paper_replication_tpu_torch.train.step import SCALAR_METRICS
    from dycon_paper_replication_tpu_torch.train.trainer import Trainer
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    steps, val_s, diags = [], [], []

    def trainer_for(extra):
        trainer = Trainer(config_from_args(dataset, argv + extra))
        validate = trainer.validate

        def counted(step):
            def counted_step(*args, **kwargs):
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*args, **kwargs)
                vec = out[0]
                if out[1]:  # a full step's diagnostic outputs
                    diags[:] = [out[1]]
                vals = vec.tolist()
                ms = (time.perf_counter() - t0) * 1e3
                row = dict(**{k: c.launches for k, c in counters.items()}, ms=ms,
                           **dict(zip(SCALAR_METRICS, vals)))
                steps.append(row)
                print(tag, "step", json.dumps(row), flush=True)
                return out
            return counted_step

        def timed_validate():
            t0 = time.perf_counter()
            dice = validate()
            torch.cuda.synchronize()
            val_s.append(time.perf_counter() - t0)
            print(f"{tag} validation: dice {dice}, {val_s[-1]:.3f} s", flush=True)
            return dice

        _wrap_steps(trainer, counted)
        trainer.validate = timed_validate
        return trainer

    torch.cuda.reset_peak_memory_stats()
    first = trainer_for(["--max_iterations", str(n_steps)])
    first.run()
    _check(first.state.step == n_steps, f"{tag}: step {first.state.step} after the first run")
    saved = checkpoint.iter_checkpoint_path(first.snapshot_path, n_steps)
    for n in range(2, n_steps + 1, 2):
        path = checkpoint.iter_checkpoint_path(first.snapshot_path, n)
        _check(os.path.isfile(path), f"no checkpoint {path}")
    print(f"{tag} checkpoints:", sorted(os.listdir(first.snapshot_path)))
    want_state = {**{f"student.{k}": v.cpu() for k, v in first.state.student.state_dict().items()},
                  **{f"teacher.{k}": v.cpu() for k, v in first.state.teacher.state_dict().items()},
                  **{f"momentum.{k}": v.cpu() for k, v in first.state.momentum.items()}}
    snapshot = first.snapshot_path
    del first

    second = trainer_for(["--max_iterations", str(n_resume), "--resume", saved])
    got = {**{f"student.{k}": v for k, v in second.state.student.state_dict().items()},
           **{f"teacher.{k}": v for k, v in second.state.teacher.state_dict().items()},
           **{f"momentum.{k}": v for k, v in second.state.momentum.items()}}
    _check(second.state.step == n_steps, f"{tag}: resumed at step {second.state.step}")
    _check(got.keys() == want_state.keys()
           and all(torch.equal(got[k].cpu(), want_state[k]) for k in want_state),
           f"{tag}: the resumed state differs from the saved one")
    second.run()
    _check(second.state.step == n_resume, f"{tag}: step {second.state.step} after the resume")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    del second

    _check(len(steps) == n_resume, f"{tag}: {len(steps)} steps ran")
    for i, row in enumerate(steps):
        ran = {k: row[k] for k in counters}
        _check(ran == want, f"{tag} step {i + 1}: launches {ran}, want {want}")
        _check(all(math.isfinite(row[k]) for k in SCALAR_METRICS) and not row["skipped"],
               f"{tag} step {i + 1}: {row}")
    ms_step = statistics.median(r["ms"] for r in steps[1:n_steps])
    return dict(launches={k: sum(r[k] for r in steps) for k in counters}, ms_per_step=ms_step,
                all_ms=[round(r["ms"], 3) for r in steps], peak_gib=peak_gb, val_s=val_s,
                snapshot=snapshot, state_keys=sorted(want_state),
                diag=diags[0] if diags else None)


def phase_train(torch, tmp):
    """Training end to end through the train CLI's Trainer at the Pancreas
    defaults: 2 steps, then a resume from step 2 to 3; 16 + 7 K1 and 8
    K1-dW launches a step."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.data.synthetic import make_pancreas
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dx)

    root = os.path.join(tmp, "PancreasTrain")
    make_pancreas(root, n_train=16, n_test=2, shape=TRAIN_VOLUME, seed=SEED, suffix=".npz")
    argv = ["--root_dir", root, "--snapshot_root", os.path.join(tmp, "train_runs"),
            "--device", "cuda", "--val_every", "2", "--save_every", "2"]
    counters = dict(k1=folded_conv3, k1_dx=folded_conv3_dx, k1_dw=folded_conv3_dw)
    out = _drive_trainer(torch, "pancreas", argv, counters, UNET_STEP_LAUNCHES, "train")
    n_val = 2
    print(f"train: {RESUME_STEPS} steps, {out['ms_per_step']:.3f} ms per step (median of steps "
          f"2-{TRAIN_STEPS}; all: {out['all_ms']}), peak memory {out['peak_gib']:.3f} GiB, "
          f"validation {[round(v, 3) for v in out['val_s']]} s for {n_val} volumes = "
          f"{n_val / float(np.median(out['val_s'])):.4f} vols/s (median)")
    return dict(out, root=root)


def phase_isles_train(torch, tmp):
    """ISLES-2022 training end to end through the train CLI's Trainer at the
    ISLES defaults (batch 8 of which 4 labeled, labelnum 10 = 45 labeled
    volumes, patch 96x96x64, fecl_chunk 512 through the fused FeCL): a
    synthetic tree of ISLES_TRAIN_CASES + ISLES_VAL_CASES volumes of
    ISLES_VOLUME as .npz, 2 steps with whole-volume validation and a save
    every 2, then a resume from step 2 to 3; 16 + 7 K1, 8 K1-dW and one K2
    call each way a step."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.data.synthetic import make_isles22
    from dycon_paper_replication_tpu_torch.ops.fecl_fused import fecl_bwd, fecl_fwd
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dx)

    root = os.path.join(tmp, "ISLES22")
    t0 = time.perf_counter()
    make_isles22(root, n_train=ISLES_TRAIN_CASES, n_val=ISLES_VAL_CASES, shape=ISLES_VOLUME,
                 seed=SEED, suffix=".npz")
    print(f"isles_train: wrote {ISLES_TRAIN_CASES} + {ISLES_VAL_CASES} cases of "
          f"{ISLES_VOLUME} in {time.perf_counter() - t0:.3f} s")
    runs = os.path.join(tmp, "isles_runs")
    argv = ["--root_dir", root, "--snapshot_root", runs, "--device", "cuda", "--val_every", "2",
            "--save_every", "2"]
    counters = dict(k1=folded_conv3, k1_dx=folded_conv3_dx, k1_dw=folded_conv3_dw,
                    k2_fwd=fecl_fwd, k2_bwd=fecl_bwd)
    out = _drive_trainer(torch, "isles22", argv, counters,
                         dict(k1=16, k1_dx=7, k1_dw=8, k2_fwd=1, k2_bwd=1), "isles_train")
    print(f"isles_train: {RESUME_STEPS} steps, {out['ms_per_step']:.3f} ms per step (median of "
          f"steps 2-{TRAIN_STEPS}; all: {out['all_ms']}), peak memory {out['peak_gib']:.3f} GiB, "
          f"whole-volume validation {[round(v, 3) for v in out['val_s']]} s for "
          f"{ISLES_VAL_CASES} volumes = {ISLES_VAL_CASES / float(np.median(out['val_s'])):.4f} "
          f"vols/s (median)")
    return dict(out, root=root, runs=runs)


def phase_isles_eval(torch, device, isles):
    """The ISLES test CLI on the checkpoint of the first training run
    (best model, seg head, one whole-volume forward per val case, 8 K1
    launches each); its label maps against the plain (NDHWC) model's
    whole-volume prediction with the same weights: >= 99.99 % of voxels
    agree."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.cli import test_isles22
    from dycon_paper_replication_tpu_torch.data import ISLESDataset
    from dycon_paper_replication_tpu_torch.eval import evaluator, iter_volumes
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    preds = []
    real_map = evaluator.WholeVolumeInference.map

    def tee(self, volumes, group=1):
        for pred, label in real_map(self, volumes, group):
            preds.append(pred)
            yield pred, label

    # --group 1: one volume a forward, the batch-1 shapes the kernels line
    # times here (the CLI's auto group, 2 on cuda, runs in phase group_eval)
    argv = ["--root_dir", isles["root"], "--snapshot_root", isles["runs"], "--device", "cuda",
            "--max_iterations", str(TRAIN_STEPS), "--group", "1", "--compute_dtype", "float32"]
    folded_conv3.launches = 0
    with mock.patch.object(evaluator.WholeVolumeInference, "map", tee):
        t0 = time.perf_counter()
        summary = test_isles22.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    launches = folded_conv3.launches
    print(f"isles_eval: {len(preds)} volumes, K1 launches {launches}, cli wall {cli_s:.3f} s, "
          f"{len(preds) / cli_s:.4f} vols/s; dice {summary['dice']}")
    _check(len(preds) == ISLES_VAL_CASES and launches == 8 * ISLES_VAL_CASES,
           f"isles_eval: {len(preds)} volumes, K1 launches {launches}")
    _check(all(math.isfinite(summary[k]) for k in ("dice", "hd95", "asd", "sensitivity",
                                                    "specificity")), f"metrics {summary}")
    plain = UNet3D(UNet3DConfig(layout="NDHWC", scale_factor=4)).to(device).eval()
    checkpoint.restore_checkpoint(checkpoint.best_checkpoint_path(isles["snapshot"], "unet_3D"),
                                  plain)
    wv = evaluator.WholeVolumeInference(plain, ISLES_PATCH)
    paths = ISLESDataset(isles["root"], split="val").paths
    for pred, (image, _) in zip(preds, iter_volumes(paths, label_key="mask")):
        want = wv.predict(image)
        agree = float((pred == want).mean())
        print(f"isles_eval: label agreement folded (CLI) vs plain {agree:.7f}, shape "
              f"{pred.shape}, foreground {int(pred.sum())} vs {int(want.sum())} voxels")
        _check(pred.shape == ISLES_VOLUME and agree >= 0.9999,
               f"isles_eval: label agreement {agree} < 0.9999")
    return dict(vols_per_s=len(preds) / cli_s, k1_launches=launches)


def phase_brats_train(torch, tmp):
    """BraTS-2019 training end to end through the BraTS train CLI's Trainer
    at the brats19 defaults (patch 96^3, batch 8 of which 4 labeled,
    labelnum 25, dense FeCL over N = 1728): a synthetic tree of
    BRATS_TRAIN_CASES + BRATS_VAL_CASES .npz cases stored as BRATS_STORED, 2
    steps with sliding-window validation and a save every 2 (so hd95_every
    is 1), then a resume from step 2 to 3; 16 + 7 K1 and 8 K1-dW launches a
    step and no K2 call. train/HD95 must be logged at every step, the perf/
    scalars at every validation, and <snapshot>/code must hold the port's
    package and no built library."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.data import make_brats19
    from dycon_paper_replication_tpu_torch.ops.fecl_fused import fecl_bwd, fecl_fwd
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dx)

    root = os.path.join(tmp, "BraTS2019")
    t0 = time.perf_counter()
    make_brats19(root, n_train=BRATS_TRAIN_CASES, n_test=BRATS_VAL_CASES, shape=BRATS_STORED,
                 seed=SEED, suffix=".npz")
    print(f"brats_train: wrote {BRATS_TRAIN_CASES} + {BRATS_VAL_CASES} cases stored as "
          f"{BRATS_STORED} in {time.perf_counter() - t0:.3f} s")
    runs = os.path.join(tmp, "brats_runs")
    argv = ["--root_dir", root, "--snapshot_root", runs, "--device", "cuda", "--val_every", "2",
            "--save_every", "2"]
    counters = dict(k1=folded_conv3, k1_dx=folded_conv3_dx, k1_dw=folded_conv3_dw,
                    k2_fwd=fecl_fwd, k2_bwd=fecl_bwd)
    out = _drive_trainer(torch, "brats19", argv, counters,
                         dict(k1=16, k1_dx=7, k1_dw=8, k2_fwd=0, k2_bwd=0), "brats_train")
    tags = {}
    with open(os.path.join(out["snapshot"], "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append(rec["step"])
    hd95 = sorted(tags.get("train/HD95", []))
    print(f"brats_train: train/HD95 at steps {hd95}; perf/step_ms_p50 at "
          f"{tags.get('perf/step_ms_p50')}, perf/host_rss_gb at {tags.get('perf/host_rss_gb')}")
    _check(hd95 == list(range(1, TRAIN_STEPS + 1)), f"brats_train: train/HD95 at {hd95}")
    val_steps = sorted(tags.get("info/Dice", []))
    _check(val_steps == list(range(2, TRAIN_STEPS + 1, 2)) and all(sorted(tags.get(t, [])) == val_steps for t in
                                       ("perf/step_ms_p50", "perf/host_rss_gb")),
           f"brats_train: validation at {val_steps}, perf/ scalars {tags}")
    code = os.path.join(out["snapshot"], "code")
    files = [os.path.relpath(os.path.join(d, f), code) for d, _, fs in os.walk(code) for f in fs]
    print(f"brats_train: {len(files)} files in the code snapshot")
    _check(os.path.join("train", "trainer.py") in files
           and os.path.join("ops", "csrc", "folded_conv3.cu") in files
           and not any(f.endswith(".so") or f.startswith(os.path.join("ops", "_build", ""))
                       for f in files), "brats_train: the code snapshot")
    _check(out["diag"] is not None and tuple(out["diag"]["embedding"].shape)
           == (TRAIN_BATCH, 1728, FECL_D), "brats_train: the step's diagnostic outputs")
    print(f"brats_train: {RESUME_STEPS} steps, {out['ms_per_step']:.3f} ms per step (median of "
          f"steps 2-{TRAIN_STEPS}; all: {out['all_ms']}), peak memory {out['peak_gib']:.3f} GiB, "
          f"sliding-window validation {[round(v, 3) for v in out['val_s']]} s for "
          f"{BRATS_VAL_CASES} volumes = {BRATS_VAL_CASES / float(np.median(out['val_s'])):.4f} "
          f"vols/s (median)")
    return dict(out, root=root, runs=runs)


def phase_monitor(torch, diag):
    """similarity_histograms on one BraTS step's embedding and FeCL mask on
    the card against the same call on their CPU copy: equal totals (B N^2
    pairs), edges within 1e-5 relative, and each bin within the number of
    pair similarities that lie within 1e-5 x (hi - lo) of a bin edge
    (counted in float64 on the CPU)."""
    from dycon_paper_replication_tpu_torch.utils.monitor import BINS, similarity_histograms

    emb, mask = diag["embedding"], diag["mask_con"]
    b, n, _ = emb.shape
    t0 = time.perf_counter()
    card = [t.cpu() for t in similarity_histograms(emb, mask)]
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = similarity_histograms(emb.cpu(), mask.cpu())
    cpu_s = time.perf_counter() - t0
    lo, hi = float(cpu[2][0]), float(cpu[2][-1])
    f64 = emb.cpu().double()
    pos = torch.einsum("bcd,bnd->bcn", f64, f64) / 0.6
    frac = (pos - lo) / (hi - lo) * BINS
    near = int(((frac - frac.round()).abs() * (hi - lo) / BINS <= 1e-5 * (hi - lo)).sum())
    del f64, pos, frac
    edge_err = float((card[2] - cpu[2]).abs().max() / cpu[2].abs().max())
    bin_diff = max(int((card[0] - cpu[0]).abs().max()), int((card[1] - cpu[1]).abs().max()))
    totals = [int(card[0].sum() + card[1].sum()), int(cpu[0].sum() + cpu[1].sum())]
    print(f"monitor: B {b}, N {n}: totals {totals} (B N^2 {b * n * n}), positive pairs "
          f"{int(card[0].sum())}, edges [{lo:.6f}, {hi:.6f}], edge err {edge_err:.3e} relative, "
          f"largest bin difference {bin_diff}, pairs within 1e-5 (hi - lo) of an edge {near}; "
          f"card {card_s:.3f} s, CPU {cpu_s:.3f} s")
    _check(totals == [b * n * n] * 2, f"monitor: totals {totals}")
    _check(edge_err <= 1e-5, f"monitor: edges differ by {edge_err} relative")
    _check(bin_diff <= near, f"monitor: a bin differs by {bin_diff} > {near} near-edge pairs")


def phase_brats_eval(torch, device, brats):
    """The BraTS test CLI on the best checkpoint of the first training run,
    with --axial 0 (the stored view) and --axial 1, 8 K1 launches per
    forward chunk; its label maps (before the largest-component step)
    against the plain (NDHWC) engine's with the same weights: >= 99.99 % of
    voxels agree."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.cli import test_brats19
    from dycon_paper_replication_tpu_torch.data.datasets import brats_case_paths
    from dycon_paper_replication_tpu_torch.eval import (
        SlidingWindowInference, compute_origins, iter_volumes)
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    plain = UNet3D(UNet3DConfig(layout="NDHWC")).to(device).eval()
    checkpoint.restore_checkpoint(checkpoint.best_checkpoint_path(brats["snapshot"], "unet_3D"),
                                  plain)
    sw_plain = SlidingWindowInference(plain, PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH)
    with open(os.path.join(brats["root"], "val.txt")) as f:
        names = [line.strip() for line in f if line.strip()]
    out = {}
    for axial in (0, 1):
        preds = []
        real_map = SlidingWindowInference.map

        def tee(self, volumes, **kwargs):
            for item in real_map(self, volumes, **kwargs):
                preds.append(item[0])
                yield item

        argv = ["--root_path", brats["root"], "--snapshot_root", brats["runs"], "--device",
                "cuda", "--max_iterations", str(TRAIN_STEPS), "--axial", str(axial),
                "--compute_dtype", "float32"]
        folded_conv3.launches = 0
        with mock.patch.object(SlidingWindowInference, "map", tee):
            t0 = time.perf_counter()
            avg = test_brats19.main(argv)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        launches = folded_conv3.launches
        shape = BRATS_STORED[::-1] if axial else BRATS_STORED
        chunks = math.ceil(len(compute_origins(shape, PATCH, STRIDE_XY, STRIDE_Z)) / PATCH_BATCH)
        print(f"brats_eval --axial {axial}: {len(preds)} volumes of {shape}, {chunks} chunks "
              f"each, K1 launches {launches}, cli wall {cli_s:.3f} s, "
              f"{len(preds) / cli_s:.4f} vols/s; metrics {[float(v) for v in avg]}")
        _check(len(preds) == BRATS_VAL_CASES and launches == 8 * chunks * BRATS_VAL_CASES,
               f"brats_eval --axial {axial}: {len(preds)} volumes, K1 launches {launches}")
        _check(len(avg) == 4 and all(math.isfinite(v) for v in avg), f"metrics {avg}")
        volumes = iter_volumes(brats_case_paths(brats["root"], names), axial_transpose=bool(axial))
        for pred, (image, _) in zip(preds, volumes):
            want, _ = sw_plain(image)
            agree = float((pred == want).mean())
            print(f"brats_eval --axial {axial}: label agreement folded (CLI) vs plain "
                  f"{agree:.7f}, shape {pred.shape}, foreground {int(pred.sum())} vs "
                  f"{int(want.sum())} voxels")
            _check(pred.shape == shape and agree >= 0.9999,
                   f"brats_eval --axial {axial}: label agreement {agree} < 0.9999")
        out[axial] = dict(vols_per_s=len(preds) / cli_s, k1_launches=launches)
    return out


def phase_vnet_model(torch, device, gen):
    """The folded VNet (through K1: 6 launches a forward) against the plain
    (NDHWC) VNet with the same seed-0 weights on one eval patch batch, eval
    mode, within tests/test_vnet_folded.py's tolerances."""
    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.models import VNet, VNetConfig
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3

    sd = weights.jax_tree_to_state_dict(*weights.init_jax_tree(VNetConfig(), seed=SEED))
    nets = {}
    for layout in ("folded", "NDHWC"):
        nets[layout] = VNet(VNetConfig(layout=layout)).to(device).eval()
        nets[layout].load_state_dict(sd)
    x = torch.rand(PATCH_BATCH, *PATCH, 1, device=device, generator=gen)
    folded_conv3.launches = 0
    with torch.inference_mode():
        out_f = nets["folded"](x)
        launches = folded_conv3.launches
        out_p = nets["NDHWC"](x)
    torch.cuda.synchronize()
    _check(launches == 6 and folded_conv3.launches == 6, f"vnet_model: K1 launches {launches}, "
           f"then {folded_conv3.launches - launches} in the plain forward")
    for name, a, b, tol in zip(("sdf", "seg", "features"), out_f, out_p, (5e-4, 5e-4, 1e-3)):
        excess = ((a - b).abs() - tol * b.abs()).max().item()
        print(f"vnet_model {name}: max abs diff folded vs plain {(a - b).abs().max().item()} "
              f"(max |plain| {b.abs().max().item()}), max(|diff| - {tol} |plain|) {excess}")
        _check(bool(torch.isfinite(a).all()) and excess <= tol,
               f"vnet_model {name}: folded differs from plain beyond atol {tol} + rtol {tol}")
    _check(tuple(out_f[1].shape) == (PATCH_BATCH, *PATCH, 2), f"seg shape {tuple(out_f[1].shape)}")


def phase_vnet_train(torch, tmp, root):
    """The Pancreas train CLI's Trainer with --model vnet at the Pancreas
    defaults on the tree `root` of phase_train: 2 steps and a resume to 3,
    12 + 5 K1 and 6 K1-dW launches a step; the run directory is VNET_...
    and holds vnet_best_model.pt."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dx)
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    runs = os.path.join(tmp, "vnet_runs")
    argv = ["--root_dir", root, "--snapshot_root", runs, "--device", "cuda", "--val_every", "2",
            "--save_every", "2", "--model", "vnet"]
    counters = dict(k1=folded_conv3, k1_dx=folded_conv3_dx, k1_dw=folded_conv3_dw)
    out = _drive_trainer(torch, "pancreas", argv, counters, VNET_STEP_LAUNCHES, "vnet_train")
    best = checkpoint.best_checkpoint_path(out["snapshot"], "vnet")
    _check(os.path.basename(out["snapshot"]).startswith("VNET_") and os.path.isfile(best),
           f"vnet_train: run directory {out['snapshot']}, best checkpoint {best}")
    n_val = 2
    print(f"vnet_train: {RESUME_STEPS} steps, {out['ms_per_step']:.3f} ms per step (median of "
          f"steps 2-{TRAIN_STEPS}; all: {out['all_ms']}), peak memory {out['peak_gib']:.3f} GiB, "
          f"validation {[round(v, 3) for v in out['val_s']]} s for {n_val} volumes = "
          f"{n_val / float(np.median(out['val_s'])):.4f} vols/s (median)")
    return dict(out, root=root, runs=runs)


def phase_vnet_eval(torch, device, vnet):
    """The Pancreas test CLI with --model vnet on the best checkpoint of the
    first VNet training run: 6 K1 launches per forward chunk, its label maps
    (before the largest-component step) against the plain (NDHWC) VNet's
    sliding window with the same weights: >= 99.99 % of voxels agree."""
    from dycon_paper_replication_tpu_torch.cli import test_pancreas
    from dycon_paper_replication_tpu_torch.eval import (
        SlidingWindowInference, compute_origins, iter_volumes)
    from dycon_paper_replication_tpu_torch.models import VNet, VNetConfig
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    preds = []
    real_map = SlidingWindowInference.map

    def tee(self, volumes, **kwargs):
        for item in real_map(self, volumes, **kwargs):
            preds.append(item[0])
            yield item

    argv = ["--root_path", vnet["root"], "--snapshot_root", vnet["runs"], "--device", "cuda",
            "--max_iterations", str(TRAIN_STEPS), "--model", "vnet", "--compute_dtype", "float32"]
    folded_conv3.launches = 0
    with mock.patch.object(SlidingWindowInference, "map", tee):
        t0 = time.perf_counter()
        avg = test_pancreas.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    launches = folded_conv3.launches
    chunks = math.ceil(len(compute_origins(TRAIN_VOLUME, PATCH, STRIDE_XY, STRIDE_Z)) / PATCH_BATCH)
    print(f"vnet_eval: {len(preds)} volumes of {TRAIN_VOLUME}, {chunks} chunks each, K1 launches "
          f"{launches}, cli wall {cli_s:.3f} s, {len(preds) / cli_s:.4f} vols/s; metrics "
          f"{[float(v) for v in avg]}")
    _check(len(preds) == 2 and launches == 6 * chunks * 2,
           f"vnet_eval: {len(preds)} volumes, K1 launches {launches}")
    _check(len(avg) == 4 and all(math.isfinite(v) for v in avg), f"metrics {avg}")
    plain = VNet(VNetConfig(layout="NDHWC")).to(device).eval()
    checkpoint.restore_checkpoint(checkpoint.best_checkpoint_path(vnet["snapshot"], "vnet"), plain)
    sw_plain = SlidingWindowInference(plain, PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH)
    with open(os.path.join(vnet["root"], "test1.list")) as f:
        names = [line.strip() for line in f if line.strip()]
    volumes = iter_volumes([os.path.join(vnet["root"], "Pancreas_data", n) for n in names])
    for pred, (image, _) in zip(preds, volumes):
        want, _ = sw_plain(image)
        agree = float((pred == want).mean())
        print(f"vnet_eval: label agreement folded (CLI) vs plain {agree:.7f}, shape {pred.shape}, "
              f"foreground {int(pred.sum())} vs {int(want.sum())} voxels")
        _check(pred.shape == TRAIN_VOLUME and agree >= 0.9999,
               f"vnet_eval: label agreement {agree} < 0.9999")
    return dict(vols_per_s=len(preds) / cli_s, k1_launches=launches)


def phase_aspp_train(torch, tmp, root):
    """The Pancreas train CLI's Trainer with --use_aspp 1 on the tree `root`:
    ASPP_STEPS steps and a resume to ASPP_RESUME_STEPS (16 + 7 K1 and 8 K1-dW
    a step, finite losses); the checkpoint holds ASPP's parameters and
    running stats, and the resume restored them exactly (_drive_trainer
    compares every tensor of the state)."""
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dx)
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    argv = ["--root_dir", root, "--snapshot_root", os.path.join(tmp, "aspp_runs"), "--device",
            "cuda", "--val_every", "2", "--save_every", "2", "--use_aspp", "1"]
    counters = dict(k1=folded_conv3, k1_dx=folded_conv3_dx, k1_dw=folded_conv3_dw)
    out = _drive_trainer(torch, "pancreas", argv, counters, UNET_STEP_LAUNCHES, "aspp_train",
                         n_steps=ASPP_STEPS, n_resume=ASPP_RESUME_STEPS)
    saved = torch.load(checkpoint.iter_checkpoint_path(out["snapshot"], ASPP_STEPS),
                       map_location="cpu", weights_only=True)
    aspp = sorted(k for k in saved["model"] if k.startswith("aspp."))
    restored = [k for k in out["state_keys"] if ".aspp." in f".{k}"]
    stats = sum(k.endswith((".mean", ".var")) for k in aspp)
    print(f"aspp_train: {len(aspp)} ASPP tensors of the student in the checkpoint ({stats} running "
          f"stats), {len(restored)} ASPP tensors of the state (student, teacher, momentum) "
          f"restored; ms per step {out['all_ms']}, peak memory {out['peak_gib']:.3f} GiB")
    _check(any(k.endswith(".mean") for k in aspp) and any(k.endswith(".w") for k in aspp)
           and any(k.startswith("teacher.aspp.") for k in restored),
           f"aspp_train: ASPP tensors {aspp}")
    return out


def phase_bf16_kernel(torch, device, gen, peaks, shapes, batch, kind, tag):
    """K1-bf16 (`kind` "fwd"), its dx ("dx", at the shapes whose input needs
    a gradient) or K1-dW-bf16 ("dw") at one path's shapes and batch, each
    against a float64 conv of the same bf16 values: max |kernel - ref| <=
    max(BF16_REL x max|ref|, BF16_PLAIN x the bf16 plain version's max
    error against ref), a rerun bit-identical. Times beside the plain
    version's (F.conv3d in bf16; K1-dW's slab einsums in float32 over the
    bf16 values), one cuDNN bf16 call's (fprop, dgrad or wgrad) and the bf16
    bound."""
    import torch.nn.functional as F

    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dw_plain, folded_conv3_dx,
        folded_conv3_plain)

    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=device, generator=gen) * scale).to(bf)

    rows = []
    for layer, g, lin, lout, to_phase in (shapes[1:] if kind == "dx" else shapes):
        q = tuple(n + (1 if to_phase == 1 else -1) for n in g)
        pad = 1 if to_phase == 1 else 0
        if kind == "fwd":
            x, wf = randn(batch, *g, lin), randn(2, 2, 2, lin, lout, scale=1 / math.sqrt(8 * lin))
            args, phase = (x, wf), to_phase
            xn, wn = x.permute(0, 4, 1, 2, 3), wf.permute(4, 3, 0, 1, 2).contiguous()
            run = lambda: folded_conv3.launch(x, wf, to_phase=phase)  # noqa: E731
            library = lambda: F.conv3d(xn, wn, padding=pad)  # noqa: E731
            flops = 2 * batch * math.prod(q) * lin * lout * 8
            nbytes = 2 * (x.numel() + wf.numel() + batch * math.prod(q) * lout)
        elif kind == "dx":
            dy = randn(batch, *q, lout)
            wf = randn(2, 2, 2, lin, lout, scale=1 / math.sqrt(8 * lout))
            wf_t = wf.flip(0, 1, 2).transpose(3, 4).contiguous()
            x = torch.empty(batch, *g, lin, device=device, dtype=bf)
            args, phase = (dy, wf_t), 1 - to_phase
            run = lambda: folded_conv3_dx.launch(dy, wf_t, to_phase=phase)  # noqa: E731
            library = lambda: _conv_backward(  # noqa: E731
                torch, dy, x, wf, to_phase, [True, False, False])
            flops = 2 * batch * math.prod(g) * lin * lout * 8
            nbytes = 2 * (dy.numel() + wf.numel() + x.numel())
        else:
            x, dy = randn(batch, *g, lin), randn(batch, *q, lout)
            wf = torch.empty(2, 2, 2, lin, lout, device=device, dtype=bf)
            args, phase = (x, dy), to_phase
            run = lambda: folded_conv3_dw.launch(x, dy, to_phase=phase)  # noqa: E731
            library = lambda: _conv_backward(  # noqa: E731
                torch, dy, x, wf, to_phase, [False, True, False])
            flops = 2 * batch * math.prod(q) * lin * lout * 8
            nbytes = 2 * (x.numel() + dy.numel() + wf.numel())
        plain_fn = folded_conv3_dw_plain if kind == "dw" else folded_conv3_plain
        got, again = run(), run()
        plain = plain_fn(*args, to_phase=phase)
        ref = plain_fn(*(a.double() for a in args), to_phase=phase)
        torch.cuda.synchronize()
        err = (got.double() - ref).abs().max().item()
        err_plain = (plain.double() - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = max(BF16_REL * scale, BF16_PLAIN * err_plain)
        del ref
        _check(got.dtype == bf and bool(torch.isfinite(got).all()) and err <= tol,
               f"{tag} {layer}: {got.dtype}, max abs err {err} > {tol} (plain bf16 err "
               f"{err_plain})")
        _check(torch.equal(got, again), f"{tag} {layer}: a rerun is not bit-identical")
        ms = _time_ms(torch, run)
        plain_ms = _time_ms(torch, lambda: plain_fn(*args, to_phase=phase))
        library_ms = _time_ms(torch, library)
        bound = _bound_bf16(flops, nbytes, peaks)
        row = dict(layer=layer, shapes=[list(a.shape) for a in args], to_phase=phase,
                   max_abs_err=err, plain_bf16_err=err_plain, tol=tol, max_abs_ref=scale,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms, tflops=flops / ms / 1e9,
                   bf16_share=bound["bound_ms"] / ms, **bound)
        rows.append(row)
        print(tag, json.dumps(row), flush=True)
        del got, again, plain, args
    return rows


class _DtypeCount:
    """One dtype instance's launch count of a kernel wrapper, read as
    `launches` (as _drive_trainer reads a wrapper); setting it to 0 clears
    all of the wrapper's counts."""

    def __init__(self, wrapper, dtype):
        self.wrapper, self.dtype = wrapper, dtype

    @property
    def launches(self):
        return self.wrapper.by_dtype[self.dtype]

    @launches.setter
    def launches(self, n):
        self.wrapper.launches = n


def _dtype_counters(torch):
    """{k1_bf16, k1_dx_bf16, k1_dw_bf16, k1_f32, k1_dx_f32, k1_dw_f32}."""
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dx)

    return {f"{k}_{d}": _DtypeCount(w, dt)
            for d, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))
            for k, w in (("k1", folded_conv3), ("k1_dx", folded_conv3_dx),
                         ("k1_dw", folded_conv3_dw))}


def _bf16_launches(per_step):
    """The launches a bf16 step must make: `per_step` of the bf16 instances,
    none of the float32 ones."""
    return {**{f"{k}_bf16": n for k, n in per_step.items()},
            **{f"{k}_f32": 0 for k in per_step}}


def phase_bf16_model(torch, device, gen):
    """The folded bf16 UNet3D and VNet against the plain bf16 (NDHWC) model
    with the same seed-0 weights on one eval patch batch, eval mode: each
    output within BF16_MODEL_K x max|plain bf16 - plain float32| of the plain
    bf16 model's; the folded forward launches K1-bf16 only (8 and 6)."""
    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.models import (
        UNet3DConfig, VNetConfig, build_model)
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3

    x = torch.rand(PATCH_BATCH, *PATCH, 1, device=device, generator=gen)
    for family, cfg, n_convs in (("unet_3D", UNet3DConfig, 8), ("vnet", VNetConfig, 6)):
        sd = weights.jax_tree_to_state_dict(*weights.init_jax_tree(cfg(), seed=SEED))
        outs = {}
        for layout, dtype in (("folded", torch.bfloat16), ("NDHWC", torch.bfloat16),
                              ("NDHWC", torch.float32)):
            net = build_model(cfg(layout=layout, compute_dtype=dtype)).to(device).eval()
            net.load_state_dict(sd)
            folded_conv3.launches = 0
            with torch.inference_mode():
                outs[layout, dtype] = net(x)
            torch.cuda.synchronize()
            if layout == "folded":
                launches = dict(folded_conv3.by_dtype)
            del net
        _check(launches == {torch.float32: 0, torch.bfloat16: n_convs},
               f"bf16_model {family}: K1 launches {launches}")
        for i, name in enumerate(("sdf", "seg", "features")):
            a, b, c = (outs[k][i] for k in (("folded", torch.bfloat16), ("NDHWC", torch.bfloat16),
                                            ("NDHWC", torch.float32)))
            diff = (a - b).abs().max().item()
            yard = (b - c).abs().max().item()
            print(f"bf16_model {family} {name}: max |folded bf16 - plain bf16| {diff}, max |plain "
                  f"bf16 - plain float32| {yard}, max |plain float32| {c.abs().max().item()}")
            _check(a.dtype == torch.float32 and bool(torch.isfinite(a).all())
                   and diff <= BF16_MODEL_K * yard,
                   f"bf16_model {family} {name}: {diff} > {BF16_MODEL_K} x {yard}")
        del outs


def phase_bf16_train(torch, tmp, root, model="unet_3D"):
    """The Pancreas train CLI's Trainer with --compute_dtype bfloat16 at the
    Pancreas defaults on phase 14's tree: the UNet3D 2 steps and a resume to
    3 (16 + 7 K1-bf16 and 8 K1-dW-bf16 a step), the VNet 2 and a resume to 3
    (12 + 5 and 6); no float32 K1 or K1-dW launch; finite losses."""
    import numpy as np

    vnet = model == "vnet"
    runs = os.path.join(tmp, "bf16_vnet_runs" if vnet else "bf16_runs")
    argv = ["--root_dir", root, "--snapshot_root", runs, "--device", "cuda", "--val_every", "2",
            "--save_every", "2", "--compute_dtype", "bfloat16", "--model", model]
    tag = "bf16_train_vnet" if vnet else "bf16_train"
    steps = (BF16_VNET_STEPS, BF16_VNET_RESUME_STEPS) if vnet else (TRAIN_STEPS, RESUME_STEPS)
    out = _drive_trainer(torch, "pancreas", argv, _dtype_counters(torch),
                         _bf16_launches(VNET_STEP_LAUNCHES if vnet else UNET_STEP_LAUNCHES),
                         tag, *steps)
    print(f"{tag}: {steps[1]} steps, {out['ms_per_step']:.3f} ms per step (median of steps "
          f"2-{steps[0]}; all: {out['all_ms']}), peak memory {out['peak_gib']:.3f} GiB, "
          f"validation {[round(v, 3) for v in out['val_s']]} s for 2 volumes = "
          f"{2 / float(np.median(out['val_s'])):.4f} vols/s (median)")
    return dict(out, root=root, runs=runs,
                launches={k.removesuffix("_bf16"): v for k, v in out["launches"].items()
                          if k.endswith("_bf16")})


def phase_bf16_eval(torch, device, bf16):
    """test_pancreas --compute_dtype bfloat16 on the bf16 run's best
    checkpoint (2 volumes of phase 14's tree, 5 chunks each, the folded
    path): 8 K1-bf16 launches per forward chunk and no float32 one; its
    label maps (before the largest-component step) against the plain (NDHWC)
    bf16 engine's with the same weights and the same float16-rounded image:
    the share of voxels whose label differs at most BF16_MODEL_K x the share
    that differs between the plain bf16 and the plain float32 engines, the
    float32 model the yardstick as in bf16_model; and against the float32
    folded engine's (recorded); vols/s. Why not a fixed share: after a few steps
    the model's scores crowd 0.5, and bf16's logit error (bf16_model: 0.3
    of max ~7 at seed-0 weights) flips labels within it; the first run's
    fixed gate of 99.9 % equal labels failed at 99.802 % while the CLI's
    labels differed from the float32 engine's at 0.86 % of voxels."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.cli import test_pancreas
    from dycon_paper_replication_tpu_torch.eval import (
        SlidingWindowInference, compute_origins, iter_volumes)
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    preds = []
    real_map = SlidingWindowInference.map

    def tee(self, volumes, **kwargs):
        for item in real_map(self, volumes, **kwargs):
            preds.append(item[0])
            yield item

    argv = ["--root_path", bf16["root"], "--snapshot_root", bf16["runs"], "--device", "cuda",
            "--max_iterations", str(TRAIN_STEPS), "--compute_dtype", "bfloat16"]
    folded_conv3.launches = 0
    with mock.patch.object(SlidingWindowInference, "map", tee):
        t0 = time.perf_counter()
        avg = test_pancreas.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    launches = dict(folded_conv3.by_dtype)
    chunks = math.ceil(len(compute_origins(TRAIN_VOLUME, PATCH, STRIDE_XY, STRIDE_Z)) / PATCH_BATCH)
    print(f"bf16_eval: {len(preds)} volumes of {TRAIN_VOLUME}, {chunks} chunks each, K1 launches "
          f"{launches}, cli wall {cli_s:.3f} s, {len(preds) / cli_s:.4f} vols/s; metrics "
          f"{[float(v) for v in avg]}")
    _check(len(preds) == 2 and launches == {torch.float32: 0, torch.bfloat16: 8 * chunks * 2},
           f"bf16_eval: {len(preds)} volumes, K1 launches {launches}")
    _check(len(avg) == 4 and all(math.isfinite(v) for v in avg), f"metrics {avg}")
    best = checkpoint.best_checkpoint_path(bf16["snapshot"], "unet_3D")
    engines = {}
    for name, layout, dtype, wire in (("plain bf16", "NDHWC", torch.bfloat16, np.float16),
                                      ("plain float32", "NDHWC", torch.float32, np.float32),
                                      ("folded float32", "folded", torch.float32, np.float32)):
        net = UNet3D(UNet3DConfig(layout=layout, compute_dtype=dtype)).to(device).eval()
        checkpoint.restore_checkpoint(best, net)
        engines[name] = SlidingWindowInference(net, PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH,
                                               transfer_dtype=wire)
    with open(os.path.join(bf16["root"], "test1.list")) as f:
        names = [line.strip() for line in f if line.strip()]
    volumes = iter_volumes([os.path.join(bf16["root"], "Pancreas_data", n) for n in names])
    agreement = []
    for pred, (image, _) in zip(preds, volumes):
        labels = {name: sw(image)[0] for name, sw in engines.items()}
        row = {name: float((pred == want).mean()) for name, want in labels.items()}
        row["plain bf16 vs plain float32"] = float(
            (labels["plain bf16"] == labels["plain float32"]).mean())
        agreement.append(row)
        print(f"bf16_eval: label agreement of the bf16 CLI with {json.dumps(row)}, shape "
              f"{pred.shape}, foreground {int(pred.sum())} voxels")
        differ, yard = 1 - row["plain bf16"], 1 - row["plain bf16 vs plain float32"]
        _check(pred.shape == TRAIN_VOLUME and differ <= BF16_MODEL_K * yard,
               f"bf16_eval: labels differ from the plain bf16 engine's at {differ} of voxels > "
               f"{BF16_MODEL_K} x {yard}")
    return dict(vols_per_s=len(preds) / cli_s, k1_launches=launches[torch.bfloat16],
                agreement=agreement)


TRAIN_PATCH = (112, 112, 96)  # the Pancreas training patch
GROUP_VOLUME = (192, 192, 64)  # the JAX headline protocol: 49 patches a volume at 96^3, 16/4
GROUP_VOLUMES, GROUP = 8, 8
GROUP_SCORE_ATOL = 1e-6
WV_LOGIT_REL = 1e-4  # the whole volume's batched forward against batch 1, x max|logit|
ISLES_GROUP = 4
DP_STEPS = 2
# dp_train: the BatchNorm running stats of the 2-rank step against the
# 1-process one, x the tensor's largest magnitude. A channel's batch mean is
# a float32 sum of ~2352-9216 cancelling values of ~1e2 whose order the
# split changes (the card's first run: 4.3e-5 at max 0.22 in the projection
# head's running mean after one step, 2e-4 of the tensor); the parameters
# keep tests/test_train.py's atol 1e-5 + rtol 1e-4
STATS_REL = 1e-3
BRATS_RAW = (240, 240, 155)  # a BraTS-2019 scan, four modalities and seg
ISLES_RAW, ISLES_RAW_CASES = (112, 112, 73), 5


def _hold_scores(tag, got, want):
    """Grouped (label, score) pairs against single-volume ones: scores
    within GROUP_SCORE_ATOL, labels equal wherever |score - 0.5| >
    GROUP_SCORE_ATOL. Returns whether every score was bit-identical."""
    import numpy as np

    identical = True
    for i, ((label_g, score_g), (label_s, score_s)) in enumerate(zip(got, want)):
        diff = float(np.abs(score_g - score_s).max())
        sure = np.abs(score_s.astype(np.float64) - 0.5) > GROUP_SCORE_ATOL
        _check(label_g.shape == label_s.shape and np.isfinite(score_g).all(),
               f"{tag} volume {i}: output")
        _check(diff <= GROUP_SCORE_ATOL, f"{tag} volume {i}: max |score diff| {diff}")
        _check(np.array_equal(label_g[sure], label_s[sure]), f"{tag} volume {i}: labels differ")
        identical &= bool(np.array_equal(score_g, score_s))
    return identical


def phase_group_eval(torch, device):
    """Volume groups and pipelining at the headline protocol (module doc,
    phase 33): the folded UNet3D in float32 and then bf16 over
    GROUP_VOLUMES seeded volumes, group 1 depth 1 (the single-volume
    reference), group 8 depth 1 and group 8 depth 2, each with its
    vols/s beside the device-resident ceiling of its group size and its K1
    launches (8 a forward chunk); the grouped scores held to the
    single-volume ones; two replicas on the one card; the ISLES whole-volume
    engine at group ISLES_GROUP against group 1."""
    import numpy as np

    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.data.synthetic import _ellipsoid_volume
    from dycon_paper_replication_tpu_torch.eval import (
        SlidingWindowInference, WholeVolumeInference, compute_origins)
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig

    rng = np.random.default_rng(SEED)
    vols = [_ellipsoid_volume(rng, GROUP_VOLUME) for _ in range(GROUP_VOLUMES)]
    k = len(compute_origins(GROUP_VOLUME, PATCH, STRIDE_XY, STRIDE_Z))
    chunks = {1: GROUP_VOLUMES * math.ceil(k / PATCH_BATCH),
              GROUP: math.ceil(GROUP * k / PATCH_BATCH) * (GROUP_VOLUMES // GROUP)}
    params, state = weights.init_jax_tree(UNet3DConfig(), seed=SEED)
    sd = weights.jax_tree_to_state_dict(params, state)
    counters = _dtype_counters(torch)
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        net = UNet3D(UNet3DConfig(layout="folded", compute_dtype=dtype)).to(device).eval()
        net.load_state_dict(sd)
        transfer = np.float16 if dtype == torch.bfloat16 else np.float32
        sw = SlidingWindowInference(net, PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH,
                                    transfer_dtype=transfer)
        ceilings = {}
        for group in (1, GROUP):
            runner = sw.device_resident_runner([np.asarray(v[0], transfer)
                                                for v in vols[:group]])
            runner()
            ceilings[group] = group / (_time_ms(torch, runner, reps=1) / 1e3)
        runs = {}
        for group, depth in ((1, 1), (GROUP, 1), (GROUP, 2)):
            counters[f"k1_{tag}"].launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [(lab, sc) for lab, sc, _ in sw.map(vols, return_score=True, group=group,
                                                       depth=depth)]
            torch.cuda.synchronize()
            vps = GROUP_VOLUMES / (time.perf_counter() - t0)
            launches = counters[f"k1_{tag}"].launches
            print(f"group_eval {tag}: group {group} depth {depth}: {vps:.4f} vols/s, "
                  f"device-resident ceiling {ceilings[group]:.4f} vols/s, "
                  f"K1 launches {launches}", flush=True)
            _check(launches == 8 * chunks[group],
                   f"group_eval {tag} group {group}: K1 launches {launches} != 8 * {chunks[group]}")
            runs[(group, depth)] = (res, vps)
        single = runs[(1, 1)][0]
        for key in ((GROUP, 1), (GROUP, 2)):
            same = _hold_scores(f"group_eval {tag} group {key[0]} depth {key[1]}",
                                runs[key][0], single)
            print(f"group_eval {tag}: group {key[0]} depth {key[1]} scores bit-identical to "
                  f"group 1: {same}")
        out[tag] = {f"g{g}_d{d}": vps for (g, d), (_, vps) in runs.items()}
        out[tag].update({f"ceiling_g{g}": c for g, c in ceilings.items()})
        if dtype == torch.float32:
            two = SlidingWindowInference(net, PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH,
                                         devices=[device, device])
            counters["k1_f32"].launches = 0
            t0 = time.perf_counter()
            res = [(lab, sc) for lab, sc, _ in two.map(vols, return_score=True, group=GROUP)]
            vps = GROUP_VOLUMES / (time.perf_counter() - t0)
            same = _hold_scores("group_eval replicas", res, single)
            print(f"group_eval f32: 2 replicas on {device}, group {GROUP}: {vps:.4f} vols/s, "
                  f"K1 launches {counters['k1_f32'].launches}, scores bit-identical: {same}")
            _check(counters["k1_f32"].launches >= 8 * chunks[GROUP], "replicas: K1 launches")
        del sw, net

    # the ISLES whole-volume engine: group ISLES_GROUP against group 1
    params, state = weights.init_jax_tree(UNet3DConfig(scale_factor=4), seed=SEED)
    net = UNet3D(UNet3DConfig(layout="folded", scale_factor=4)).to(device).eval()
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    isles = [_ellipsoid_volume(rng, ISLES_VOLUME) for _ in range(2 * ISLES_GROUP)]
    wv = WholeVolumeInference(net, ISLES_PATCH)
    wv_runs = {}
    for group in (1, 2, ISLES_GROUP):
        counters["k1_f32"].launches = 0
        t0 = time.perf_counter()
        wv_runs[group] = [p for p, _ in wv.map(isles, group=group)]
        vps = len(isles) / (time.perf_counter() - t0)
        print(f"group_eval isles: group {group}: {vps:.4f} vols/s, K1 launches "
              f"{counters['k1_f32'].launches}")
        _check(counters["k1_f32"].launches == 8 * len(isles) // group,
               f"isles group {group}: K1 launches {counters['k1_f32'].launches}")
        out[f"isles_g{group}"] = vps
    # The sliding window's chunks keep their batch, the whole volume's forward
    # does not: a batch of g may round differently. So the grouped forward's
    # foreground probabilities are held to the single forward's within
    # WV_LOGIT_REL x max|logit| on the logits (the folded-vs-plain model gate)
    # and their difference is reported; the engine's labels must equal the
    # single forward's wherever its probability is further from 0.5 than
    # that difference and GROUP_SCORE_ATOL.
    worst = {}
    with torch.inference_mode():
        padded = [wv._pad(np.asarray(image, np.float32)) for image, _ in isles]
        xs = torch.stack([torch.from_numpy(p) for p, _ in padded])[..., None].to(device)
        single = torch.cat([net(xs[i:i + 1], with_projection=False)[1] for i in range(len(xs))])
        for group in (2, ISLES_GROUP):
            batched = torch.cat([net(xs[i:i + group], with_projection=False)[1]
                                 for i in range(0, len(xs), group)])
            d_logit = float((batched - single).abs().max())
            p_s, p_b = torch.softmax(single, -1)[..., 1], torch.softmax(batched, -1)[..., 1]
            d_p = float((p_b - p_s).abs().max())
            scale = float(single.abs().max())
            worst[group] = (d_logit, d_p)
            _check(d_logit <= WV_LOGIT_REL * scale,
                   f"isles group {group}: logits differ by {d_logit} (max |logit| {scale})")
            for i, (_, sl) in enumerate(padded):
                sure = ((p_s[i] - 0.5).abs() > max(d_p, GROUP_SCORE_ATOL)).cpu().numpy()[sl]
                _check(np.array_equal(wv_runs[1][i][sure], wv_runs[group][i][sure])
                       and np.array_equal(wv_runs[1][i][sure],
                                          (p_s[i] > 0.5).cpu().numpy()[sl][sure]),
                       f"isles group {group} volume {i}: labels differ from group 1")
            flips = sum(int((a != b).sum()) for a, b in zip(wv_runs[1], wv_runs[group]))
            print(f"group_eval isles: group {group} against group 1: max |logit diff| "
                  f"{d_logit} (max |logit| {scale}), max |probability diff| {d_p}; "
                  f"{flips} of {sum(a.size for a in wv_runs[1])} labels differ")
    out["isles_worst"] = worst
    return out


def _dp_step_rank(rank, world, device, cases):
    """One rank of phase dp_train's step check: each case's step twice from
    its initial state (the first warms up), the second timed, with this
    rank's K1 launches. Defined here so that spawned ranks import only this
    script and the port."""
    import torch

    return _dp_steps(torch, device, cases, rank, world)


def _dp_steps(torch, device, cases, rank=0, world=1):
    from dycon_paper_replication_tpu_torch import parallel
    from dycon_paper_replication_tpu_torch.config import make_config
    from dycon_paper_replication_tpu_torch.models import build_model
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dx)
    from dycon_paper_replication_tpu_torch.train.state import create_train_state
    from dycon_paper_replication_tpu_torch.train.step import StepScalars, build_train_step

    out = {}
    for name, case in cases.items():
        b = len(case["batch"]["label"])
        cfg = make_config("pancreas", model=case["model"], batch_size=b, labeled_bs=b // 2,
                          patch_size=case["batch"]["label"].shape[1:], device=str(device))
        shard = parallel.Shard(rank, world, b, b // 2) if world > 1 else None
        batch = parallel.shard_batch(shard, case["batch"])
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        step = build_train_step(cfg, lambda s: cfg.base_lr, shard)
        for rep in range(2):
            student = build_model(case["net_cfg"])
            student.load_state_dict(case["state"])
            state = create_train_state(student.to(device))
            gen = torch.Generator(device=device).manual_seed(SEED)
            for w in (folded_conv3, folded_conv3_dx, folded_conv3_dw):
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vec, _ = step(state, batch, gen, StepScalars(5.0, 0.1 * math.exp(-5.0), 1.3, 0.3))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        models = (("student", state.student), ("teacher", state.teacher))
        out[name] = dict(vec=vec.cpu(), ms=ms,
                         params={f"{m}.{k}": v.detach().cpu() for m, mod in models
                                 for k, v in mod.named_parameters()},
                         stats={f"{m}.{k}": v.cpu() for m, mod in models
                                for k, v in mod.named_buffers()},
                         launches=dict(k1=folded_conv3.launches, k1_dx=folded_conv3_dx.launches,
                                       k1_dw=folded_conv3_dw.launches))
    return out


def _seeded_case(model, use_aspp=False):
    """A full-width train step's inputs: the folded `model` (unet_3D, with
    ASPP under `use_aspp`, or vnet) at seeded weights in the JAX layout, and
    a batch of TRAIN_BATCH ellipsoids at TRAIN_PATCH (half labeled)."""
    import numpy as np

    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.models import model_config

    rng = np.random.default_rng(SEED)
    label = np.zeros((TRAIN_BATCH,) + TRAIN_PATCH, np.int32)
    for b in range(TRAIN_BATCH):
        c = rng.uniform(0.3, 0.7, 3) * TRAIN_PATCH
        r = rng.uniform(0.2, 0.4, 3) * TRAIN_PATCH
        grid = np.ogrid[tuple(slice(0, s) for s in TRAIN_PATCH)]
        label[b] = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grid, c, r)) <= 1.0
    image = (0.4 * label + 0.1 * rng.standard_normal(label.shape)).astype(np.float32)[..., None]
    net_cfg = model_config(model, layout="folded", scaler=2, use_aspp=use_aspp)
    p, s = weights.init_jax_tree(net_cfg, seed=SEED)
    return dict(model=model, net_cfg=net_cfg, batch={"image": image, "label": label},
                state=weights.jax_tree_to_state_dict(p, s))


def phase_dp_train(torch, device, tmp, root):
    """Data parallelism on the one card (module doc, phase 34): the Pancreas
    train CLI's entry at its defaults with --data_parallel 1 (one spawned
    rank, NCCL) for DP_STEPS steps against the plain trainer in this
    process at the same seed; then one step on the global batch of
    TRAIN_BATCH in two spawned gloo ranks on the card (NCCL cannot put two
    ranks on one GPU; gloo all-reduces the CUDA tensors) against the same
    step in one process, for the UNet3D and the VNet: loss rtol 2e-5,
    parameters atol 1e-5 + rtol 1e-4 (tests/test_train.py's DP test), the
    BatchNorm running stats within 1e-5 + STATS_REL x max|tensor|."""
    from dycon_paper_replication_tpu_torch import parallel
    from dycon_paper_replication_tpu_torch.config import config_from_args
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        folded_conv3, folded_conv3_dw, folded_conv3_dx)
    from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    def close(tag, got, want, atol=1e-5, rtol=1e-4, per_tensor=False):
        """Every tensor of `got` within atol + rtol |want| elementwise, or
        with `per_tensor` within atol + rtol max|want| (a running mean of a
        channel can cancel to ~0 against activations of ~100); the largest
        absolute difference."""
        _check(got.keys() == want.keys(), f"{tag}: tensor names differ")
        worst = 0.0
        for k in want:
            g, w = got[k].double(), want[k].double()
            bound = atol + rtol * (w.abs().max() if per_tensor else w.abs())
            diff = (g - w).abs()
            _check(bool((diff <= bound).all()), f"{tag} {k}: max |diff| {float(diff.max())} "
                   f"beyond atol {atol} + rtol {rtol} (max |want| {float(w.abs().max())})")
            worst = max(worst, float(diff.max()))
        return worst

    def losses(snapshot):
        rows = [json.loads(line) for line in open(os.path.join(snapshot, "metrics.jsonl"))]
        return {(r["step"], r["tag"]): r["value"] for r in rows if r["tag"].startswith("info/")}

    runs = {}
    for mode in ("plain", "dp1"):
        argv = ["--root_dir", root, "--snapshot_root", os.path.join(tmp, f"dp_{mode}"),
                "--device", "cuda", "--max_iterations", str(DP_STEPS),
                "--save_every", str(DP_STEPS)]
        cfg = config_from_args("pancreas", argv + (["--data_parallel", "1"] if mode == "dp1"
                                                   else []))
        for w in (folded_conv3, folded_conv3_dx, folded_conv3_dw):
            w.launches = 0
        t0 = time.perf_counter()
        ttrainer.train(cfg)
        wall = time.perf_counter() - t0
        ckpt = torch.load(checkpoint.iter_checkpoint_path(cfg.snapshot_path(), DP_STEPS),
                          map_location="cpu", weights_only=False)
        runs[mode] = (losses(cfg.snapshot_path()), ckpt, wall)
        ran = dict(k1=folded_conv3.launches, k1_dx=folded_conv3_dx.launches,
                   k1_dw=folded_conv3_dw.launches)
        print(f"dp_train: {mode} trainer, {DP_STEPS} steps, wall {wall:.3f} s (K1 launches in "
              f"this process {ran})", flush=True)
        # the plain trainer runs here, the --data_parallel 1 rank in its own process
        want = {k: DP_STEPS * n for k, n in UNET_STEP_LAUNCHES.items()} if mode == "plain" \
            else {k: 0 for k in UNET_STEP_LAUNCHES}
        _check(ran == want, f"dp_train {mode}: launches in this process {ran}, want {want}")
    (l_plain, c_plain, _), (l_dp, c_dp, _) = runs["plain"], runs["dp1"]
    _check(l_plain.keys() == l_dp.keys() and len(l_plain) >= DP_STEPS, "dp_train: logged tags")
    for k in l_plain:
        _check(math.isclose(l_dp[k], l_plain[k], rel_tol=2e-5, abs_tol=1e-7),
               f"dp_train --data_parallel 1 {k}: {l_dp[k]} vs {l_plain[k]}")
    worst = close("dp_train --data_parallel 1", _flatten_ckpt(c_dp), _flatten_ckpt(c_plain))
    print(f"dp_train: --data_parallel 1 (NCCL, world 1) against the plain trainer: "
          f"{len(l_plain)} logged scalars within rtol 2e-5, the step-{DP_STEPS} checkpoint "
          f"within atol 1e-5 + rtol 1e-4 (max |diff| {worst:.3g})")

    cases = {model: _seeded_case(model) for model in ("unet_3D", "vnet")}
    one = _dp_steps(torch, device, cases)
    two = parallel.launch(_dp_step_rank, 2, device="cuda", devices=[str(device)] * 2,
                          backend="gloo", args=(cases,), timeout=600)
    out = {}
    for model in cases:
        g, w = two[model], one[model]
        loss_g, loss_w = float(g["vec"][0]), float(w["vec"][0])
        _check(math.isclose(loss_g, loss_w, rel_tol=2e-5), f"dp_train {model}: 2-rank loss "
               f"{loss_g} vs {loss_w}")
        worst = close(f"dp_train {model}", g["params"], w["params"])
        worst_stats = close(f"dp_train {model} BatchNorm stats", g["stats"], w["stats"],
                            rtol=STATS_REL, per_tensor=True) if w["stats"] else 0.0
        want = UNET_STEP_LAUNCHES if model == "unet_3D" else VNET_STEP_LAUNCHES
        _check(all(g["launches"][k] == want[k] for k in want),
               f"dp_train {model}: rank 0 launches {g['launches']}, want {want}")
        print(f"dp_train {model}: 2 gloo ranks on one card, global batch {TRAIN_BATCH}: "
              f"{g['ms']:.3f} ms/step (rank 0; one rank in one process {w['ms']:.3f}); loss "
              f"{loss_g} vs {loss_w}; student and teacher parameters within atol 1e-5 + rtol "
              f"1e-4 (max |diff| {worst:.3g}), BatchNorm running stats within 1e-5 + "
              f"{STATS_REL} x max|tensor| (max |diff| {worst_stats:.3g}); rank 0 launches "
              f"{g['launches']}",
              flush=True)
        out[model] = dict(ms_one=w["ms"], ms_two=g["ms"])
    return out


def _flatten_ckpt(ckpt):
    """{name: tensor} of a saved train state's student, teacher and momentum."""
    out = {}
    for key in ("model", "teacher", "momentum"):
        for k, v in ckpt[key].items():
            out[f"{key}.{k}"] = v
    return out


def phase_preprocess(torch, tmp):
    """The preprocess CLIs on fabricated NIfTI trees (module doc, phase 35):
    2 BraTS cases of BRATS_RAW (four modalities and seg, int16 .nii), 5
    ISLES cases of ISLES_RAW (.nii.gz, DWI and mask), written with the
    port's nifti.save; both CLIs with --format npz (this machine has no
    h5py); the cases read back through the port's datasets: the target
    shapes, binary labels with foreground, the ISLES 80/20 split."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.cli import preprocess_brats19, preprocess_isles22
    from dycon_paper_replication_tpu_torch.data import (
        BRATS_TARGET_SHAPE, ISLES_TARGET_SHAPE, BraTS2019, ISLESDataset, nifti)

    rng = np.random.default_rng(SEED)
    src, out = os.path.join(tmp, "brats_nifti"), os.path.join(tmp, "brats_pre")
    cases = [f"BraTS19_TCIA_{i:03d}_1" for i in range(2)]
    grid = np.ogrid[tuple(slice(0, s) for s in BRATS_RAW)]
    for i, case in enumerate(cases):
        d = os.path.join(src, "HGG" if i == 0 else "LGG", case)
        os.makedirs(d)
        tumour = sum(((g - c) / r) ** 2 for g, c, r in
                     zip(grid, (120 + 10 * i, 110, 70), (30, 25, 20))) <= 1.0
        for mod in ("t1", "t1ce", "t2", "flair"):
            vol = rng.integers(0, 600, BRATS_RAW).astype(np.int16) + 400 * tumour
            nifti.save(os.path.join(d, f"{case}_{mod}.nii"), vol.astype(np.int16))
        nifti.save(os.path.join(d, f"{case}_seg.nii"), (tumour * 2).astype(np.uint8))
    t0 = time.perf_counter()
    n = preprocess_brats19.main(["--input_dir", src, "--output_dir", os.path.join(out, "data"),
                                 "--format", "npz"])
    _check(n == len(cases), f"preprocess BraTS: {n} cases")
    with open(os.path.join(out, "train.txt"), "w") as f:
        f.write("\n".join(cases) + "\n")
    ds = BraTS2019(out, split="train")
    for i in range(len(cases)):
        s = ds.get(i, np.random.default_rng(0))
        _check(s["image"].shape == BRATS_TARGET_SHAPE[::-1] and 0 <= s["image"].min()
               and s["image"].max() <= 1 and set(np.unique(s["label"])) == {0, 1},
               f"preprocess BraTS case {i}: {s['image'].shape}")
    brats_s = time.perf_counter() - t0

    src, out = os.path.join(tmp, "isles_nifti"), os.path.join(tmp, "isles_pre")
    names = [f"sub-strokecase{i:04d}" for i in range(1, ISLES_RAW_CASES + 1)]
    grid = np.ogrid[tuple(slice(0, s) for s in ISLES_RAW)]
    for i, case in enumerate(names):
        dwi = os.path.join(src, case, "ses-0001", "dwi")
        msk = os.path.join(src, "derivatives", case, "ses-0001")
        os.makedirs(dwi)
        os.makedirs(msk)
        lesion = sum(((g - c) / r) ** 2 for g, c, r in
                     zip(grid, (50 + 3 * i, 60, 36), (12, 10, 8))) <= 1.0
        nifti.save(os.path.join(dwi, f"{case}_ses-0001_dwi.nii.gz"),
                   (rng.uniform(0, 300, ISLES_RAW) + 500 * lesion).astype(np.float32))
        nifti.save(os.path.join(msk, f"{case}_ses-0001_msk.nii.gz"), lesion.astype(np.uint8))
    t0 = time.perf_counter()
    n = preprocess_isles22.main(["--input_dir", src, "--output_dir", out, "--format", "npz"])
    _check(n == ISLES_RAW_CASES, f"preprocess ISLES: {n} cases")
    train = open(os.path.join(out, "train.list")).read().split()
    val = open(os.path.join(out, "val.list")).read().split()
    _check(sorted(train + val) == names and len(train) == int(0.8 * ISLES_RAW_CASES),
           f"preprocess ISLES split {train} / {val}")
    for split, want in (("train", train), ("val", val)):
        ds = ISLESDataset(out, split=split)
        _check(len(ds) == len(want) and not ds.missing, f"ISLES {split}: {ds.paths}")
        for i in range(len(ds)):
            s = ds.get(i, np.random.default_rng(0))
            _check(s["image"].shape == ISLES_TARGET_SHAPE and s["label"].sum() > 0,
                   f"preprocess ISLES {split} case {i}")
    isles_s = time.perf_counter() - t0
    print(f"preprocess: BraTS {len(cases)} cases of {BRATS_RAW} -> {BRATS_TARGET_SHAPE} in "
          f"{brats_s:.3f} s; ISLES {ISLES_RAW_CASES} cases of {ISLES_RAW} -> "
          f"{ISLES_TARGET_SHAPE} in {isles_s:.3f} s, split {len(train)} / {len(val)}; "
          f"read back as .npz by BraTS2019 and ISLESDataset")


# phase trained_eval (module doc, phase 36): the JAX package's trained
# Pancreas checkpoint, converted by scripts/convert_jax_checkpoint.py, and
# the canonical test tree of the run that trained it
TRAINED_CKPT = os.path.join("trained", "pancreas_unet3d_r05_best.pt")
CANONICAL_TREE = dict(n_train=62, n_test=20, shape=(128, 128, 112), seed=1)
TRAINED_MAX_ITERATIONS = 20000
TRAINED_VOLUMES = 4  # the first 4 of the 20 of test1.list (scripts/eval_trained.py runs 20)
# the TPU's scores of the same checkpoint on the same 20 volumes (Dice, Jaccard,
# HD95, ASD per row of test1.list): bench_results/r05_canonical20k_test_eval.log,
# the JAX test CLI at its defaults (bf16 on the TPU, patch 96^3, stride 16/4)
TPU_LOG = [
    (0.99933, 0.99867, 0.0, 0.01098), (0.99948, 0.99897, 0.0, 0.00683),
    (0.99957, 0.99915, 0.0, 0.00678), (0.99938, 0.99877, 0.0, 0.00774),
    (0.99886, 0.99772, 0.0, 0.08383), (0.99927, 0.99855, 0.0, 0.00859),
    (0.99955, 0.99909, 0.0, 0.00865), (0.99918, 0.99835, 0.0, 0.01177),
    (0.99961, 0.99922, 0.0, 0.00727), (0.99954, 0.99909, 0.0, 0.00846),
    (0.99935, 0.99871, 0.0, 0.01012), (0.99966, 0.99932, 0.0, 0.00528),
    (0.99941, 0.99883, 0.0, 0.00877), (0.99959, 0.99918, 0.0, 0.00719),
    (0.99940, 0.99880, 0.0, 0.01031), (0.99968, 0.99935, 0.0, 0.00622),
    (0.99954, 0.99909, 0.0, 0.00763), (0.99957, 0.99914, 0.0, 0.00645),
    (0.99963, 0.99925, 0.0, 0.00661), (0.99896, 0.99792, 0.0, 0.02906),
]
DICE_VOLUME_TOL, DICE_MEAN_TOL = 0.002, 0.001
TRAINED_PLAIN_AGREE = 0.9999


def phase_trained_eval(torch, device, tmp, n_volumes=TRAINED_VOLUMES, check=True):
    """The trained checkpoint's 20-volume test (module doc, phase 36), cut to
    the first `n_volumes`: `TRAINED_CKPT` copied to the best-model path
    that `cli.test_pancreas --max_iterations 20000` reads (a missing file
    fails the phase), the canonical test tree regenerated on the host by the
    port's make_pancreas (62 + 20 volumes of (128, 128, 112) at seed 1, as
    the run that trained it), and the test CLI on the first `n_volumes` of
    test1.list with --compute_dtype float32 and then bfloat16 (folded,
    patch 96^3, stride 16/4, patch batch 4: 45 patches, 12 chunks a volume).

    Gates, stated before the phase first ran on the card:
      * launches: each dtype's run launches its K1 instance 8 times per
        forward chunk and the other instance never (so the float32 run no
        bf16 kernel);
      * Dice against the TPU log (TPU_LOG): in each dtype, each volume's
        Dice within DICE_VOLUME_TOL = 0.002 of its row, and the mean over
        the volumes run within DICE_MEAN_TOL = 0.001 of the log's mean over
        the same volumes;
      * folded against plain: the float32 CLI's labels (before the
        largest-component step) equal the plain engine's (NDHWC, cuDNN,
        TF32 off, the same weights) on at least 99.99 % of each volume's
        voxels.
    Printed, not gated: Jaccard, HD95 and ASD beside the log's; the share
    of voxels whose label (after the largest-component step, as scored)
    differs between bf16 and float32, and before it; the host seconds a
    volume of the CLI's scoring (largest component and metrics); vols/s of
    each CLI run. Returns those numbers and each dtype's K1 launches, and
    with `check` False, before the gates (which `check_trained_eval` holds)."""
    import shutil

    import numpy as np

    from dycon_paper_replication_tpu_torch.cli import test_pancreas
    from dycon_paper_replication_tpu_torch.config import make_config
    from dycon_paper_replication_tpu_torch.data.synthetic import make_pancreas
    from dycon_paper_replication_tpu_torch.eval import (
        SlidingWindowInference, compute_origins, evaluator, iter_volumes)
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAINED_CKPT)
    _check(os.path.isfile(ckpt), f"trained_eval: {ckpt} is missing")
    runs = os.path.join(tmp, "trained_runs")
    snapshot = make_config("pancreas", snapshot_root=runs,
                           max_iterations=TRAINED_MAX_ITERATIONS).snapshot_path()
    best = checkpoint.best_checkpoint_path(snapshot, "unet_3D")
    os.makedirs(snapshot)
    shutil.copyfile(ckpt, best)
    root = os.path.join(tmp, "Pancreas_canonical")
    t0 = time.perf_counter()
    make_pancreas(root, **CANONICAL_TREE, suffix=".npz")
    gen_s = time.perf_counter() - t0
    with open(os.path.join(root, "test1.list")) as f:
        names = [line.strip() for line in f if line.strip()][:n_volumes]
    with open(os.path.join(root, "trained_eval.list"), "w") as f:
        f.write("\n".join(names) + "\n")
    shape = CANONICAL_TREE["shape"]
    chunks = math.ceil(len(compute_origins(shape, PATCH, STRIDE_XY, STRIDE_Z)) / PATCH_BATCH)
    meta = torch.load(best, map_location="cpu", weights_only=True)["meta"]
    print(f"trained_eval: {TRAINED_CKPT} (meta {meta}), {len(names)} of "
          f"{CANONICAL_TREE['n_test']} test volumes of {shape}, {chunks} chunks each; tree "
          f"made in {gen_s:.3f} s")

    real_map = SlidingWindowInference.map
    real_lcc = evaluator.metrics.largest_connected_component
    real_case = evaluator.metrics.calculate_metric_percase
    runs_out = {}
    for dtype in ("float32", "bfloat16"):
        raw, scored, cases, host_s = [], [], [], []

        def tee(self, volumes, **kwargs):
            for item in real_map(self, volumes, **kwargs):
                raw.append(item[0])
                yield item

        def lcc(pred):
            t = time.perf_counter()
            out = real_lcc(pred)
            host_s.append(time.perf_counter() - t)
            scored.append(out)
            return out

        def case(pred, gt):
            t = time.perf_counter()
            out = real_case(pred, gt)
            host_s[-1] += time.perf_counter() - t
            cases.append(tuple(float(v) for v in out))
            return out

        argv = ["--root_path", root, "--snapshot_root", runs, "--device", "cuda",
                "--max_iterations", str(TRAINED_MAX_ITERATIONS), "--list_name",
                "trained_eval.list", "--compute_dtype", dtype]
        folded_conv3.launches = 0
        with mock.patch.object(SlidingWindowInference, "map", tee), \
                mock.patch.object(evaluator.metrics, "largest_connected_component", lcc), \
                mock.patch.object(evaluator.metrics, "calculate_metric_percase", case):
            t0 = time.perf_counter()
            avg = test_pancreas.main(argv)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        launches = {str(k).removeprefix("torch."): v for k, v in folded_conv3.by_dtype.items()}
        runs_out[dtype] = dict(raw=raw, scored=scored, cases=cases, host_s=host_s, cli_s=cli_s,
                               avg=[float(v) for v in avg], launches=launches)
        print(f"trained_eval {dtype}: K1 launches {launches}, cli wall {cli_s:.3f} s, "
              f"{len(names) / cli_s:.4f} vols/s, host scoring {statistics.mean(host_s):.3f} s "
              f"a volume; mean Dice, Jaccard, HD95, ASD {runs_out[dtype]['avg']}")

    # the plain engine (NDHWC: cuDNN, TF32 off) on the same volumes and weights
    net = UNet3D(UNet3DConfig(layout="NDHWC")).to(device).eval()
    checkpoint.restore_checkpoint(best, net)
    plain = SlidingWindowInference(net, PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH)
    volumes = iter_volumes([os.path.join(root, "Pancreas_data", n) for n in names])
    f32, bf16 = runs_out["float32"], runs_out["bfloat16"]
    rows, agree_plain = [], []
    for i, (image, _) in enumerate(volumes):
        agree_plain.append(float((plain(image)[0] == f32["raw"][i]).mean()))
        row = dict(volume=names[i], log=list(TPU_LOG[i]), float32=list(f32["cases"][i]),
                   bfloat16=list(bf16["cases"][i]), folded_vs_plain=agree_plain[-1],
                   bf16_vs_f32_scored=float((bf16["scored"][i] != f32["scored"][i]).mean()),
                   bf16_vs_f32_raw=float((bf16["raw"][i] != f32["raw"][i]).mean()),
                   host_s={d: runs_out[d]["host_s"][i] for d in runs_out})
        rows.append(row)
        print(f"trained_eval {json.dumps(row)}")
    want_mean = [float(np.mean([TPU_LOG[i][m] for i in range(len(names))])) for m in range(4)]
    summary = dict(volumes=len(names), log_mean=want_mean,
                   mean={d: runs_out[d]["avg"] for d in runs_out},
                   vols_per_s={d: len(names) / runs_out[d]["cli_s"] for d in runs_out},
                   host_s_per_volume={d: statistics.mean(runs_out[d]["host_s"])
                                      for d in runs_out},
                   bf16_vs_f32_scored=float(np.mean([r["bf16_vs_f32_scored"] for r in rows])),
                   bf16_vs_f32_raw=float(np.mean([r["bf16_vs_f32_raw"] for r in rows])),
                   folded_vs_plain_min=min(agree_plain),
                   launches={d: runs_out[d]["launches"] for d in runs_out})
    print(f"trained_eval summary {json.dumps(summary)}")
    out = dict(summary, rows=rows, want_launches=8 * chunks * len(names),
               cases={d: runs_out[d]["cases"] for d in runs_out},
               k1_launches={d: runs_out[d]["launches"][d] for d in runs_out})
    if check:
        check_trained_eval(out)
    return out


def check_trained_eval(out):
    """phase_trained_eval's gates (its docstring) on what it returned."""
    n, want = out["volumes"], out["want_launches"]
    for dtype, other in (("float32", "bfloat16"), ("bfloat16", "float32")):
        cases = out["cases"][dtype]
        _check(len(cases) == n, f"trained_eval {dtype}: {len(cases)} of {n} volumes scored")
        _check(out["launches"][dtype] == {dtype: want, other: 0},
               f"trained_eval {dtype}: K1 launches {out['launches'][dtype]}, want {want} {dtype}")
        for i, case in enumerate(cases):
            _check(abs(case[0] - TPU_LOG[i][0]) <= DICE_VOLUME_TOL,
                   f"trained_eval {dtype} volume {i}: Dice {case[0]} against the log's "
                   f"{TPU_LOG[i][0]}")
        _check(abs(out["mean"][dtype][0] - out["log_mean"][0]) <= DICE_MEAN_TOL,
               f"trained_eval {dtype}: mean Dice {out['mean'][dtype][0]} against the log's "
               f"{out['log_mean'][0]}")
    for row in out["rows"]:
        _check(row["folded_vs_plain"] >= TRAINED_PLAIN_AGREE,
               f"trained_eval {row['volume']}: folded float32 labels equal the plain engine's "
               f"on {row['folded_vs_plain']} < {TRAINED_PLAIN_AGREE} of voxels")


# The SSL ablation (scripts/ssl_ablation_torch.py) at its defaults: patch
# 64x64x48, batch 4 of which 2 labeled, so K1's fold grids are (32, 32, 24)
# at the first level. The smoke runs a cut of the protocol (phase_ssl_ablation)
def _load_ablation():
    """scripts/ssl_ablation_torch.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ssl_ablation_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                           "ssl_ablation_torch.py"))
    abl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(abl)
    return abl


ABLATION_PATCH, ABLATION_BATCH = (64, 64, 48), 4
ABLATION_SHAPES = [
    ("conv1.conv1", (32, 32, 24), 8, 128, 1), ("conv1.conv2", (33, 33, 25), 128, 128, 0),
    ("conv2.conv1", (16, 16, 12), 128, 256, 1), ("conv2.conv2", (17, 17, 13), 256, 256, 0),
    ("up_concat2.conv1", (16, 16, 12), 768, 256, 1), ("up_concat2.conv2", (17, 17, 13), 256, 256, 0),
    ("up_concat1.conv1", (32, 32, 24), 384, 128, 1), ("up_concat1.conv2", (33, 33, 25), 128, 128, 0),
]
ABLATION_TREE = dict(n_train=8, n_test=2, shape=(96, 96, 64))  # the default is 40 + 8
# 200 iterations of the default 2500: at 100, the first planned cut, the
# dycon arm's validation Dice was 0.0 at both validations on the card, so it
# saved no best model (as the JAX trainer saves only a Dice above 0)
ABLATION_ITERS, ABLATION_VAL_EVERY, ABLATION_SEED = 200, 50, 1337


def phase_ssl_ablation(torch, tmp):
    """The SSL ablation's driver (scripts/ssl_ablation_torch.py, through its
    main) on a cut of its protocol: a hard tree (make_hard_pancreas) of 8
    training and 2 test volumes of (96, 96, 64), both arms (sup, dycon) at
    seed 1337 for 200 iterations with --val_every 50, then the dense test
    (test_pancreas, stride 32/24, float32) on the 2 volumes. Gates, each a
    failure of the phase:
      * every step of both arms launches 16 K1, 7 K1 dx and 8 K1-dW in
        float32 and no bf16 instance, counted with the counts set to 0 before
        the step and read after it;
      * every loss of every step is finite and no step is skipped, and so is
        every info/* scalar in each arm's metrics.jsonl;
      * the sup arm's total loss equals its supervised terms, loss_ce +
        loss_dice in float32, exactly (u_weight and consistency are 0), while
        its UnCL term is still computed (finite);
      * both arms reach iteration 200; each best checkpoint is written at
        the arm's run directory and is the file the test CLI restores, whose
        forward launches float32 K1 only;
      * the best validation Dice and the test Dice, Jaccard, HD95 and ASD of
        each arm are finite.
    Returns the launch sums over both arms' steps, the driver's results and
    its argv."""
    import numpy as np

    from dycon_paper_replication_tpu_torch.train.step import SCALAR_METRICS
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    abl = _load_ablation()
    counters = _dtype_counters(torch)
    want = {**{f"{k}_f32": n for k, n in UNET_STEP_LAUNCHES.items()},
            **{f"{k}_bf16": 0 for k in UNET_STEP_LAUNCHES}}
    steps = {"sup": [], "dycon": []}
    restored, test_launches = [], {}

    class CountedTrainer(abl.Trainer):
        def __init__(self, cfg, *args, **kwargs):
            super().__init__(cfg, *args, **kwargs)
            rows = steps[cfg.exp.removeprefix("hard_")]

            def counted(step):
                def counted_step(*a, **k):
                    for c in counters.values():
                        c.launches = 0
                    t0 = time.perf_counter()
                    out = step(*a, **k)
                    vals = out[0].tolist()
                    rows.append(dict(**{n: c.launches for n, c in counters.items()},
                                     ms=(time.perf_counter() - t0) * 1e3,
                                     **dict(zip(SCALAR_METRICS, vals))))
                    return out
                return counted_step

            _wrap_steps(self, counted)

    real_test, real_restore = abl.test_pancreas.main, checkpoint.restore_checkpoint

    def counted_test(argv):
        for c in counters.values():
            c.launches = 0
        out = real_test(argv)
        test_launches[argv[argv.index("--exp") + 1]] = {n: c.launches
                                                        for n, c in counters.items()}
        return out

    def recorded_restore(path, *args, **kwargs):
        restored.append(path)
        return real_restore(path, *args, **kwargs)

    root, work = os.path.join(tmp, "hard_pancreas"), os.path.join(tmp, "ablation_runs")
    argv = ["--iters", str(ABLATION_ITERS), "--val_every", str(ABLATION_VAL_EVERY),
            "--seed", str(ABLATION_SEED), "--n_train", str(ABLATION_TREE["n_train"]),
            "--n_test", str(ABLATION_TREE["n_test"]),
            "--shape", *[str(n) for n in ABLATION_TREE["shape"]], "--root", root, "--work", work,
            "--device", "cuda"]
    with mock.patch.object(abl, "Trainer", CountedTrainer), \
            mock.patch.object(abl.test_pancreas, "main", counted_test), \
            mock.patch.object(checkpoint, "restore_checkpoint", recorded_restore):
        results = abl.main(argv)
    args = abl.build_parser().parse_args(argv)

    ce, dice, total = (SCALAR_METRICS.index(k) for k in ("loss_ce", "loss_dice", "loss"))
    for arm, rows in steps.items():
        _check(len(rows) == ABLATION_ITERS, f"ssl_ablation {arm}: {len(rows)} steps ran")
        for i, row in enumerate(rows):
            ran = {k: row[k] for k in counters}
            _check(ran == want, f"ssl_ablation {arm} step {i + 1}: launches {ran}, want {want}")
            _check(all(math.isfinite(row[k]) for k in SCALAR_METRICS) and not row["skipped"],
                   f"ssl_ablation {arm} step {i + 1}: {row}")
            if arm == "sup":
                supervised = float(np.float32(row["loss_ce"]) + np.float32(row["loss_dice"]))
                _check(row["loss"] == supervised,
                       f"ssl_ablation sup step {i + 1}: loss {row['loss']} != loss_ce + "
                       f"loss_dice {supervised}")
        snapshot = abl.arm_config(args, arm).snapshot_path()
        with open(os.path.join(snapshot, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        bad = [r for r in logged if r["tag"].startswith("info/") and not math.isfinite(r["value"])]
        _check(not bad and logged, f"ssl_ablation {arm}: non-finite logged scalars {bad[:4]}")
        best = checkpoint.best_checkpoint_path(snapshot, "unet_3D")
        _check(os.path.isfile(best) and best in restored,
               f"ssl_ablation {arm}: best checkpoint {best} not written or not read by the "
               f"test CLI (restored {restored})")
        res = results[arm]
        _check(res["final_iter"] == ABLATION_ITERS, f"ssl_ablation {arm}: {res}")
        _check(all(math.isfinite(res[k]) for k in ("best_val_dice", "test_dice", "test_jaccard",
                                                    "test_hd95", "test_asd")),
               f"ssl_ablation {arm}: non-finite metrics {res}")
        tl = test_launches[f"hard_{arm}"]
        _check(tl["k1_f32"] > 0 and tl["k1_bf16"] == 0 and tl["k1_dx_f32"] == tl["k1_dw_f32"] == 0,
               f"ssl_ablation {arm}: test CLI launches {tl}")
        ms = [r["ms"] for r in rows[1:]]
        print(f"ssl_ablation {arm}: " + json.dumps(dict(
            res, step_ms_median=statistics.median(ms), u_loss_last=rows[-1]["u_loss"],
            f_loss_last=rows[-1]["f_loss"], test_launches=tl)), flush=True)
    sup_u = [r["u_loss"] for r in steps["sup"]]
    print(f"ssl_ablation sup: UnCL computed with weight 0, first/last {sup_u[0]} / {sup_u[-1]}")
    return dict(results=results, argv=argv,
                launches={k: sum(r[f"{k}_f32"] for rows in steps.values() for r in rows)
                          for k in UNET_STEP_LAUNCHES})


DET_STEPS = 3  # each run of phase determinism: 3 steps of a train CLI's Trainer
DET_WARM, DET_TIMED = 2, 3  # the mode's cost: steps per setting, warm-up and timed


def _leaves(state):
    """{name: CPU copy} of a train state's student and teacher (parameters
    and BatchNorm running stats) and its momentum buffers."""
    out = {}
    for part, tensors in (("student", state.student.state_dict()),
                          ("teacher", state.teacher.state_dict()), ("momentum", state.momentum)):
        out.update({f"{part}.{k}": v.detach().cpu().clone() for k, v in tensors.items()})
    return out


def _logged(snapshot):
    """{(step, tag): value} of the info/ and train/ scalars a run logged
    (every one but the perf/ wall-clock times and host RSS)."""
    with open(os.path.join(snapshot, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {(r["step"], r["tag"]): r["value"] for r in rows
            if r["tag"].startswith(("info/", "train/"))}


def _first_difference(torch, a, b):
    """(the first name in `a`'s order whose tensor is not bit-equal in `b`,
    its max |diff|, the number of such names); (None, 0.0, 0) when every
    tensor is equal."""
    _check(a.keys() == b.keys(), "the two runs' tensor names differ")
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    if not diff:
        return None, 0.0, 0
    return diff[0], float((a[diff[0]].double() - b[diff[0]].double()).abs().max()), len(diff)


def _hold_identical(torch, tag, first, second, n_steps=DET_STEPS):
    """The gate of phase determinism: two runs' ({name: tensor}, {(step,
    tag): value}) bit-identical, with a scalar logged at each of n_steps."""
    (state_a, logged_a), (state_b, logged_b) = first, second
    name, diff, n = _first_difference(torch, state_a, state_b)
    _check(name is None, f"determinism {tag}: {n} of {len(state_a)} state tensors differ between "
           f"the runs, the first {name} (max |diff| {diff})")
    steps = sorted({step for step, _ in logged_a})
    _check(logged_a == logged_b and steps == list(range(1, n_steps + 1)),
           f"determinism {tag}: logged scalars differ or are missing: "
           f"{sorted(set(logged_a.items()) ^ set(logged_b.items()))[:4]}, steps {steps}")
    print(f"determinism {tag}: 2 runs of {n_steps} steps bit-identical: {len(state_a)} state "
          f"tensors (student, teacher, momentum, running stats), {len(logged_a)} logged "
          f"scalars", flush=True)


# the settings _mode_ms times: (name, torch.use_deterministic_algorithms,
# torch.utils.deterministic.fill_uninitialized_memory, which the mode
# turns on by default: torch.empty's outputs filled with NaN)
DET_MODES = (("on", True, True), ("on_nofill", True, False), ("off", False, True))


def _mode_ms(torch, trainer):
    """ms per step of `trainer`'s step on one batch of its loader under each
    of DET_MODES, toggling those two settings alone: DET_WARM + DET_TIMED
    steps each, the timed ones returned. Leaves the mode on, and the fill."""
    import torch.utils.deterministic

    from dycon_paper_replication_tpu_torch.train.step import StepScalars

    epochs = trainer.loader.epochs(1)
    _, batch = next(epochs)  # this rank's rows, on the card (data/pipeline.py)
    epochs.close()
    beta, pos, neg = trainer._epoch_scalars(0)
    scalars = StepScalars(beta, trainer._consistency_weight(0), pos, neg)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED)
    out = {}
    for name, mode, fill in DET_MODES:
        torch.use_deterministic_algorithms(mode)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        times = []
        for _ in range(DET_WARM + DET_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, batch, gen, scalars)[0].tolist()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times[DET_WARM:]
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    return out


def _det_dp_rank(rank, world, device, argvs):
    """One rank of phase determinism's data-parallel runs: for each argv
    of `argvs`, the Pancreas train CLI's Trainer in this rank (as
    cli.train_pancreas --data_parallel 2 runs it) for DET_STEPS steps; then
    the mode's cost on the last. Rank 0's states, logged scalars, steps and
    ms per step."""
    import dataclasses

    import torch

    from dycon_paper_replication_tpu_torch.config import config_from_args
    from dycon_paper_replication_tpu_torch.train.trainer import Trainer

    runs = []
    for argv in argvs:
        cfg = dataclasses.replace(config_from_args("pancreas", argv), device=str(device))
        trainer = Trainer(cfg, rank, world)
        trainer.run()
        runs.append((_leaves(trainer.state), _logged(trainer.snapshot_path) if rank == 0 else None,
                     int(trainer.state.step)))
    return dict(runs=runs, ms=_mode_ms(torch, trainer))


def _control(torch, device):
    """The control that names the culprit (printed, not a gate): one
    full-width Pancreas DyCON step (_seeded_case: batch 8 at 112x112x96,
    dense FeCL), the UNet3D and the UNet3D with ASPP, run twice from the same
    state with the mode off and then twice with it on; for each pair, the
    first state tensor that differs and how many do."""
    from dycon_paper_replication_tpu_torch.config import make_config
    from dycon_paper_replication_tpu_torch.models import build_model
    from dycon_paper_replication_tpu_torch.train.state import create_train_state
    from dycon_paper_replication_tpu_torch.train.step import StepScalars, build_train_step

    for tag, case in (("unet_3D", _seeded_case("unet_3D")),
                      ("aspp", _seeded_case("unet_3D", use_aspp=True))):
        cfg = make_config("pancreas", batch_size=TRAIN_BATCH, labeled_bs=TRAIN_BATCH // 2,
                          patch_size=TRAIN_PATCH, device=str(device))
        step = build_train_step(cfg, lambda s: cfg.base_lr)
        batch = {k: torch.from_numpy(v).to(device) for k, v in case["batch"].items()}
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)
            runs = []
            for _ in range(2):
                student = build_model(case["net_cfg"])
                student.load_state_dict(case["state"])
                state = create_train_state(student.to(device))
                gen = torch.Generator(device=device).manual_seed(SEED)
                step(state, batch, gen, StepScalars(5.0, 0.1 * math.exp(-5.0), 1.3, 0.3))
                runs.append(_leaves(state))
            name, diff, n = _first_difference(torch, *runs)
            print(f"determinism control {tag}: mode {'on' if mode else 'off'}: "
                  + ("the two steps are bit-identical" if name is None
                     else f"{n} of {len(runs[0])} state tensors differ, the first {name} "
                          f"(max |diff| {diff})"), flush=True)
    torch.use_deterministic_algorithms(True)


def phase_determinism(torch, device, tmp, roots, ablation):
    """`--deterministic 1` (the default) on the card: every training path
    run twice through its train CLI's Trainer, DET_STEPS steps each from the
    same seed into two snapshot directories, must be bit-identical (torch.equal)
    in the student, the teacher, the momentum buffers and every BatchNorm
    running stat, and in every logged info/ and train/ scalar of every step:
    the Pancreas defaults (dense FeCL), ISLES (fused FeCL through K2), BraTS,
    the VNet, the UNet3D with ASPP and the bf16 UNet3D, each at full width
    on the trees of the earlier phases; the Pancreas Trainer in two gloo
    ranks on the one card (--data_parallel 2, the global batch of 8); and
    the SSL ablation's DyCON arm rerun at phase ssl_ablation's cut, its
    validation curve, logged scalars and best checkpoint against that
    phase's run. Then the controls, printed and not gated: _control, the
    arm's cut rerun with the mode off against the mode-on run, and the
    arm's UnCL beta schedule at --iters 100 and 200; and the ms per step of
    each path under each of DET_MODES (_mode_ms)."""
    from dycon_paper_replication_tpu_torch import parallel
    from dycon_paper_replication_tpu_torch.config import config_from_args
    from dycon_paper_replication_tpu_torch.ops.ramps import adaptive_beta
    from dycon_paper_replication_tpu_torch.train.trainer import Trainer
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    paths = (("pancreas", "pancreas", roots["pancreas"], []),
             ("isles", "isles22", roots["isles"], []),
             ("brats", "brats19", roots["brats"], []),
             ("vnet", "pancreas", roots["pancreas"], ["--model", "vnet"]),
             ("aspp", "pancreas", roots["pancreas"], ["--use_aspp", "1"]),
             ("bf16", "pancreas", roots["pancreas"], ["--compute_dtype", "bfloat16"]))
    # no validation or save within the 3 steps, and train/HD95 (seconds of host
    # work a batch) at the first alone
    common = ["--device", "cuda", "--max_iterations", str(DET_STEPS), "--val_every", "1000",
              "--save_every", "1000"]
    cost = {}
    for tag, dataset, root, extra in paths:
        t0, runs = time.perf_counter(), []
        for run in range(2):
            argv = ["--root_dir", root, "--snapshot_root", os.path.join(tmp, f"det_{tag}_{run}"),
                    *common, *extra]
            trainer = Trainer(config_from_args(dataset, argv))
            _check(torch.are_deterministic_algorithms_enabled(),
                   f"determinism {tag}: the Trainer did not turn the mode on")
            trainer.run()
            _check(trainer.state.step == DET_STEPS,
                   f"determinism {tag}: step {trainer.state.step}")
            runs.append((_leaves(trainer.state), _logged(trainer.snapshot_path)))
        _hold_identical(torch, tag, *runs)
        cost[tag] = _mode_ms(torch, trainer)
        print(f"determinism {tag}: {time.perf_counter() - t0:.3f} s (two runs, the cost)")
        del trainer, runs

    t0 = time.perf_counter()
    argvs = [["--root_dir", roots["pancreas"], "--data_parallel", "2", *common,
              "--snapshot_root", os.path.join(tmp, f"det_dp_{run}")] for run in range(2)]
    out = parallel.launch(_det_dp_rank, 2, device="cuda", devices=[str(device)] * 2,
                          backend="gloo", args=(argvs,), timeout=600)
    _check([step for _, _, step in out["runs"]] == [DET_STEPS] * 2,
           f"determinism dp2: steps {[step for _, _, step in out['runs']]}")
    _hold_identical(torch, "dp2 (2 gloo ranks, global batch 8)",
                    *[run[:2] for run in out["runs"]])
    cost["dp2"] = out["ms"]
    print(f"determinism dp2: {time.perf_counter() - t0:.3f} s (two runs, the cost)")
    t0 = time.perf_counter()

    abl = _load_ablation()
    argv = list(ablation["argv"])
    argv[argv.index("--work") + 1] = os.path.join(tmp, "det_ablation")
    argv += ["--arms", "dycon", "--train_only"]
    abl.main(argv)
    args = [abl.build_parser().parse_args(a) for a in (ablation["argv"], argv)]
    snapshots = [abl.arm_config(a, "dycon").snapshot_path() for a in args]
    logged = [_logged(snap) for snap in snapshots]
    curves = [{k: v for k, v in log.items() if k[1] in ("info/Dice", "info/Best_dice")}
              for log in logged]
    best = [torch.load(checkpoint.best_checkpoint_path(snap, "unet_3D"), map_location="cpu",
                       weights_only=False) for snap in snapshots]
    print(f"determinism ablation dycon: validation curve {sorted(curves[0].items())}, best "
          f"checkpoint {best[0]['meta']}", flush=True)
    _check(curves[0] == curves[1] and len(curves[0]) == 2 * ABLATION_ITERS // ABLATION_VAL_EVERY,
           f"determinism ablation dycon: validation curves differ: {sorted(curves[1].items())}")
    meta = [(b["meta"], b["step"]) for b in best]
    _check(meta[0] == meta[1], f"determinism ablation dycon: best checkpoints' meta {meta}")
    _hold_identical(torch, f"ablation dycon ({ABLATION_ITERS} iterations, best checkpoint)",
                    (_flatten_ckpt(best[0]), logged[0]), (_flatten_ckpt(best[1]), logged[1]),
                    n_steps=ABLATION_ITERS)
    trainer = Trainer(abl.arm_config(args[1], "dycon"))
    cost["ablation_dycon"] = _mode_ms(torch, trainer)
    trainer.log.close()
    # the arm's UnCL beta decays over the run's epochs (trainer._epoch_scalars:
    # max_epoch from max_iterations), so a 100- and a 200-iteration run of the
    # arm differ from its second epoch on; the sup arm gives UnCL weight 0
    ipe = trainer.iters_per_epoch
    last = (100 - 1) // ipe
    betas = {iters: [adaptive_beta(e, iters // ipe + 1, trainer.cfg.beta_max,
                                   trainer.cfg.beta_min) for e in (0, 1, last)]
             for iters in (100, ABLATION_ITERS)}
    print(f"determinism ablation dycon: UnCL beta at epochs 0, 1 and {last} ({ipe} iterations "
          f"an epoch) with --iters 100: {betas[100]}, with --iters {ABLATION_ITERS}: "
          f"{betas[ABLATION_ITERS]}", flush=True)
    del trainer
    print(f"determinism ablation dycon: {time.perf_counter() - t0:.3f} s (the rerun, the cost)")

    t0 = time.perf_counter()
    _control(torch, device)
    # the longer control: the arm's cut once more with the mode off (the
    # Trainer's call to turn it on is stubbed), against the mode-on run
    argv[argv.index("--work") + 1] = os.path.join(tmp, "det_ablation_off")
    torch.use_deterministic_algorithms(False)
    with mock.patch.object(torch, "use_deterministic_algorithms", lambda *a, **k: None):
        abl.main(argv)
    torch.use_deterministic_algorithms(True)
    snap = abl.arm_config(abl.build_parser().parse_args(argv), "dycon").snapshot_path()
    path = checkpoint.best_checkpoint_path(snap, "unet_3D")
    name, diff, n = ("(none saved)", float("nan"), 0) if not os.path.isfile(path) else \
        _first_difference(torch, _flatten_ckpt(best[0]), _flatten_ckpt(
            torch.load(path, map_location="cpu", weights_only=False)))
    steps = sorted({s for (s, tag), v in _logged(snap).items() if logged[0].get((s, tag)) != v})
    print(f"determinism control ablation dycon, {ABLATION_ITERS} iterations with the mode off "
          f"against the mode-on run: logged scalars differ at {len(steps)} steps (first "
          f"{steps[:1]}); best checkpoint: " + ("bit-identical" if name is None else
                                                f"{n} tensors differ, the first {name} (max "
                                                f"|diff| {diff})"), flush=True)
    print(f"determinism controls: {time.perf_counter() - t0:.3f} s")
    for tag, ms in cost.items():
        mean = {k: statistics.mean(v) for k, v in ms.items()}
        print(f"determinism cost {tag}: ms/step with the mode on {mean['on']:.3f}, on without "
              f"the NaN fill {mean['on_nofill']:.3f}, off {mean['off']:.3f} "
              f"({100 * (mean['on'] / mean['off'] - 1):+.2f} %, "
              f"{100 * (mean['on_nofill'] / mean['off'] - 1):+.2f} % without the fill; "
              + ", ".join(f"{k} {[round(t, 3) for t in v]}" for k, v in ms.items()) + ")",
              flush=True)
    return cost


HOST_LOOP_ITERS = dict(brats=32, vnet_bf16=24, ablation_dycon=24)  # a run of phase host_loop
HOST_LOOP_ORDER = (0, 1, 1, 0)  # the fetch_ahead settings' runs, in turn, in one process
HOST_LOOP_WARM = 4  # left out of its timings: the first (synchronous, train-HD95) and warm-up


def _host_loop_run(torch, cfg, sync_debug):
    """One Trainer run of `cfg`, each step (full or light) dispatched between
    two CUDA events, under torch.cuda.set_sync_debug_mode("error") with
    `sync_debug`. Returns its state's leaves, its step, and timings over the
    iterations after HOST_LOOP_WARM: ms per iteration of the loop (the
    median interval between dispatches on the host's clock), the median
    host time of a dispatch (the step call), the median device span of a
    step (from the event before its first kernel to the one after its
    last), the StepTimer's p50 (dispatch to the read of the scalars), and
    the device's idle share between steps (the sum of the gaps from one
    step's end event to the next one's start event, over the span from the
    first start to the last end)."""
    from dycon_paper_replication_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    marks = []

    def timed(step):
        def timed_step(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            if sync_debug:
                torch.cuda.set_sync_debug_mode("error")
            try:
                start.record()
                out = step(*args, **kwargs)
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            marks.append((t, start, end, time.perf_counter() - t))
            return out
        return timed_step

    _wrap_steps(trainer, timed)
    trainer.run()
    torch.cuda.synchronize()
    steady = marks[HOST_LOOP_WARM:]
    span = steady[0][1].elapsed_time(steady[-1][2])
    gaps = [a[2].elapsed_time(b[1]) for a, b in zip(steady, steady[1:])]
    return dict(state=_leaves(trainer.state), step=int(trainer.state.step), dispatched=len(marks),
                ms_iter=statistics.median((b[0] - a[0]) * 1e3 for a, b in zip(steady, steady[1:])),
                dispatch_ms=statistics.median(m[3] * 1e3 for m in steady),
                step_ms=statistics.median(m[1].elapsed_time(m[2]) for m in steady),
                timer_p50=trainer.timer.stats().get("step_ms_p50", float("nan")),
                idle=sum(gaps) / span)


def phase_host_loop(torch, tmp, roots, ablation):
    """The pipelined host loop on the card (module doc, phase 40): each path
    run HOST_LOOP_ITERS iterations from one seed at the fetch_ahead settings
    of HOST_LOOP_ORDER in turn (0, 1, 1, 0: a drift over the phase shows as
    a difference between the two runs of one setting), without validation
    or saves inside a run (train-HD95 at the first iteration alone:
    hd95_every is 250), each step dispatched under the sync debug mode.
    Gate: BraTS's runs all torch.equal (state and step). Printed: each
    run's timings (_host_loop_run), each setting's mean over its two runs,
    and whether the bf16 VNet's and the ablation arm's runs are all equal
    too."""
    import dataclasses

    from dycon_paper_replication_tpu_torch.config import config_from_args

    abl = _load_ablation()
    arm = abl.arm_config(abl.build_parser().parse_args(ablation["argv"]), "dycon")
    common = ["--device", "cuda", "--val_every", "1000", "--save_every", "1000"]
    paths = (("brats", lambda n, fa, snap: config_from_args("brats19", [
                 "--root_dir", roots["brats"], "--snapshot_root", snap, *common,
                 "--max_iterations", str(n), "--fetch_ahead", str(fa)])),
             ("vnet_bf16", lambda n, fa, snap: config_from_args("pancreas", [
                 "--root_dir", roots["pancreas"], "--snapshot_root", snap, *common,
                 "--max_iterations", str(n), "--model", "vnet", "--compute_dtype", "bfloat16",
                 "--fetch_ahead", str(fa)])),
             ("ablation_dycon", lambda n, fa, snap: dataclasses.replace(
                 arm, snapshot_root=snap, max_iterations=n, val_every=1000, save_every=1000,
                 fetch_ahead=fa)))
    out = {}
    for tag, make in paths:
        n = HOST_LOOP_ITERS[tag]
        runs = []
        for i, fa in enumerate(HOST_LOOP_ORDER):
            r = _host_loop_run(torch, make(n, fa, os.path.join(tmp, f"host_loop_{tag}_{i}")),
                               sync_debug=True)
            print(f"host_loop {tag} run {i}, fetch_ahead {fa}: {r['ms_iter']:.3f} ms per "
                  f"iteration of the loop, dispatch {r['dispatch_ms']:.3f} ms on the host, step "
                  f"device span {r['step_ms']:.3f} ms (medians), StepTimer p50 "
                  f"{r['timer_p50']:.3f} ms, device idle between steps {r['idle']:.4f}; "
                  f"{r['dispatched']} steps dispatched under the sync debug mode, step "
                  f"{r['step']}", flush=True)
            runs.append((fa, r))
        first = runs[0][1]
        differ = [(i, *_first_difference(torch, first["state"], r["state"]))
                  for i, (_, r) in enumerate(runs) if i]
        differ = [d for d in differ if d[1] is not None]
        steps = [r["step"] for _, r in runs]
        equal = not differ and steps == [n] * len(runs)
        if tag == "brats":
            _check(equal, f"host_loop {tag}: the runs differ: steps {steps}, "
                   f"(run, first tensor, max |diff|, tensors) {differ[:2]}")
        mean = {fa: {k: statistics.mean(r[k] for f, r in runs if f == fa)
                     for k in ("ms_iter", "dispatch_ms", "step_ms", "idle")}
                for fa in dict.fromkeys(HOST_LOOP_ORDER)}
        print(f"host_loop {tag}: the {len(runs)} runs (fetch_ahead {list(HOST_LOOP_ORDER)}) "
              + ("torch.equal" if equal else f"differ: steps {steps}, {differ[:2]}")
              + "; means per setting: " + json.dumps(mean)
              + f"; ms per iteration {mean[1]['ms_iter'] / mean[0]['ms_iter'] - 1:+.2%} at 1",
              flush=True)
        out[tag] = dict(mean=mean, runs=[(fa, {k: v for k, v in r.items() if k != "state"})
                                         for fa, r in runs])
    return out


def phase_remat(torch, device):
    """--remat full against none on one full-width step (module doc, phase
    41). The yardstick of the bf16 gate is the float32 step's: for each
    parameter leaf, max |bf16 full - bf16 none| <= 2 x max |bf16 none -
    float32 none| (PERF.md section 2's bf16 model gate)."""
    import dataclasses

    from dycon_paper_replication_tpu_torch.config import make_config
    from dycon_paper_replication_tpu_torch.models import build_model
    from dycon_paper_replication_tpu_torch.train.state import create_train_state
    from dycon_paper_replication_tpu_torch.train.step import StepScalars, build_train_step

    scalars = StepScalars(5.0, 0.1 * math.exp(-5.0), 1.3, 0.3)
    unet = _seeded_case("unet_3D")
    cases = (("pancreas", unet, "float32"), ("vnet", _seeded_case("vnet"), "float32"),
             ("pancreas_bf16", dict(unet, net_cfg=dataclasses.replace(
                 unet["net_cfg"], compute_dtype=torch.bfloat16)), "bfloat16"))
    results = {}
    for tag, case, dtype in cases:
        batch = {k: torch.from_numpy(v).to(device) for k, v in case["batch"].items()}
        for remat in ("none", "full"):
            cfg = make_config("pancreas", model=case["model"], batch_size=TRAIN_BATCH,
                              labeled_bs=TRAIN_BATCH // 2, patch_size=TRAIN_PATCH,
                              device=str(device), remat=remat, compute_dtype=dtype)
            step = build_train_step(cfg, lambda s: cfg.base_lr)
            for rep in range(2):  # the first warms up
                student = build_model(case["net_cfg"])
                student.load_state_dict(case["state"])
                state = create_train_state(student.to(device))
                gen = torch.Generator(device=device).manual_seed(SEED)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                vec, _ = step(state, batch, gen, scalars)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            results[tag, remat] = dict(loss=float(vec[0]), skipped=float(vec[-1]), ms=ms,
                                       peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                                       leaves=_leaves(state), gen=gen.get_state())
            del state, student
        none, full = results[tag, "none"], results[tag, "full"]
        params = [k for k in none["leaves"] if not k.startswith("momentum.")
                  and not k.endswith((".mean", ".var"))]
        stats = [k for k in none["leaves"] if k.endswith((".mean", ".var"))]
        diff = {k: float((full["leaves"][k].double() - none["leaves"][k].double()).abs().max())
                for k in params}
        worst = max(diff, key=diff.get)
        print(f"remat {tag}: loss {none['loss']!r} (none) / {full['loss']!r} (full), "
              f"{none['ms']:.3f} / {full['ms']:.3f} ms per step, peak "
              f"{none['peak']:.3f} / {full['peak']:.3f} GiB, largest parameter difference "
              f"{diff[worst]} ({worst}), {len(stats)} running stats", flush=True)
        _check(not none["skipped"] and not full["skipped"], f"remat {tag}: a step was skipped")
        _check(all(torch.equal(full["leaves"][k], none["leaves"][k]) for k in stats),
               f"remat {tag}: the running stats differ")
        _check(torch.equal(full["gen"], none["gen"]),
               f"remat {tag}: the generator's state after the step differs")
        _check(full["peak"] < none["peak"], f"remat {tag}: peak {full['peak']} GiB with remat "
               f"is not below {none['peak']} GiB")
        if dtype == "float32":
            _check(abs(full["loss"] - none["loss"]) <= 1e-6 * abs(none["loss"]),
                   f"remat {tag}: loss {full['loss']} vs {none['loss']}")
            _check(diff[worst] <= 1e-6, f"remat {tag}: {worst} differs by {diff[worst]}")
        else:
            f32 = results["pancreas", "none"]["leaves"]
            over = [k for k in params if diff[k] > 2 * float(
                (none["leaves"][k].double() - f32[k].double()).abs().max())]
            loss_yard = abs(none["loss"] - results["pancreas", "none"]["loss"])
            _check(not over and abs(full["loss"] - none["loss"]) <= 2 * loss_yard,
                   f"remat {tag}: over the bf16 gate: {over[:4]}, loss {full['loss']} vs "
                   f"{none['loss']} (yardstick {loss_yard})")
    return {k: {n: v for n, v in r.items() if n not in ("leaves", "gen")}
            for k, r in results.items()}


def phase_wire(torch, tmp, root):
    """One Pancreas trainer step at --wire_dtype float16 (module doc, phase
    42): the batch the step gets is float16 and uint8 on the card, bit-equal
    to the float32 / int32 batch of a loader with the trainer's settings at
    --wire_dtype float32, rounded to float16."""
    from dycon_paper_replication_tpu_torch.config import config_from_args
    from dycon_paper_replication_tpu_torch.data import BatchLoader, TwoStreamBatchSampler
    from dycon_paper_replication_tpu_torch.train.trainer import Trainer

    cfg = config_from_args("pancreas", [
        "--root_dir", root, "--snapshot_root", os.path.join(tmp, "wire"), "--device", "cuda",
        "--max_iterations", "1", "--val_every", "1000", "--save_every", "1000",
        "--wire_dtype", "float16"])
    trainer = Trainer(cfg)
    seen = []

    def recorded(step):
        def recorded_step(state, batch, *args, **kwargs):
            seen.append({k: v.clone() for k, v in batch.items()})
            out = step(state, batch, *args, **kwargs)
            seen[-1]["vec"] = out[0].clone()
            return out
        return recorded_step

    _wrap_steps(trainer, recorded)
    trainer.run()
    got = seen[0]
    ds = trainer.loader.dataset
    sampler = TwoStreamBatchSampler(range(cfg.labelnum), range(cfg.labelnum, len(ds)),
                                    cfg.batch_size, cfg.batch_size - cfg.labeled_bs, seed=cfg.seed)
    wide_loader = BatchLoader(ds, sampler, seed=cfg.seed, prefetch=cfg.num_prefetch,
                              device=trainer.device)
    epochs = wide_loader.epochs(1)
    _, wide = next(epochs)
    epochs.close()
    torch.cuda.synchronize()
    print(f"wire: the step's batch {got['image'].dtype} {tuple(got['image'].shape)} and "
          f"{got['label'].dtype} on {got['image'].device}; the float32 loader's "
          f"{wide['image'].dtype} and {wide['label'].dtype}; loss {float(got['vec'][0])}",
          flush=True)
    _check(got["image"].dtype == torch.float16 and got["label"].dtype == torch.uint8
           and got["image"].is_cuda and wide["image"].dtype == torch.float32
           and wide["label"].dtype == torch.int32, "wire: the batches' dtypes")
    _check(torch.equal(got["image"].view(torch.int16), wide["image"].half().view(torch.int16))
           and torch.equal(got["label"].long(), wide["label"].long()),
           "wire: the float16 batch is not the float32 batch rounded to float16")
    _check(math.isfinite(float(got["vec"][0])) and not float(got["vec"][-1]),
           "wire: the step's loss")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.config import resolve_device
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.ops import _build
    from dycon_paper_replication_tpu_torch.ops import fecl_fused
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import DW_SOURCE, SOURCE

    t_all = time.perf_counter()
    device = resolve_device("cuda")  # also turns TF32 off
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    peaks = next(v for k, v in PEAKS.items() if k in kind) \
        if any(k in kind for k in PEAKS) else PEAKS["H100"]
    print(f"bound peaks: {peaks[0] / 1e12} TFLOP/s float32, {peaks[1] / 1e12} TFLOP/s TF32 "
          f"tensor cores, {peaks[2] / 1e12} TB/s")
    _phase("card", t0)

    t0 = time.perf_counter()
    logs = _build.build(SOURCE, DW_SOURCE, fecl_fused.SOURCE)
    for src, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "wgmma", "setmaxnreg")):
                print(f"ptxas {src.name}:", line.strip())
    print(f"build_s {time.perf_counter() - t0:.3f}")
    # the bf16 instances at L_in % 64 == 0 run wgmma (HGMMA), those at L_in 8
    # (conv1.conv1, the VNet's enc0) mma.sync (HMMA)
    for src, kernel, label, op in (
            (SOURCE, "folded_conv3_kernel", "K1", "HMMA"),
            (DW_SOURCE, "folded_conv3_dw_kernel", "K1-dW", "HMMA"),
            (fecl_fused.SOURCE, "fecl_kernel", "K2", "HMMA"),
            (SOURCE, "folded_conv3_bf16_kernel", "K1-bf16 (L_in 8)", "HMMA"),
            (DW_SOURCE, "folded_conv3_dw_bf16_kernel", "K1-dW-bf16 (L_in 8)", "HMMA"),
            (SOURCE, "folded_conv3_bf16_wgmma_kernel", "K1-bf16", "HGMMA"),
            (DW_SOURCE, "folded_conv3_dw_bf16_wgmma_kernel", "K1-dW-bf16", "HGMMA")):
        for fn, count in check_sass(_build.library_path(src), _build.nvcc(), kernel,
                                    label, op).items():
            print(f"sass {label} {fn}: {count} {op}")
    _phase("build", t0)

    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    k1_rows = phase_k1(torch, device, gen, peaks, K1_SHAPES, PATCH_BATCH, "k1")
    _phase("kernels", t0)
    t0 = time.perf_counter()
    k1_train_rows = phase_k1(torch, device, gen, peaks, TRAIN_SHAPES, TRAIN_BATCH, "k1_train")
    phase_nan(torch, device, gen, TRAIN_SHAPES[2])
    _phase("k1_train", t0)
    t0 = time.perf_counter()
    dw_rows = phase_dw(torch, device, gen, peaks)
    _phase("k1_dw", t0)
    t0 = time.perf_counter()
    dx_rows = phase_dx(torch, device, gen, peaks)
    _phase("k1_dx", t0)
    t0 = time.perf_counter()
    phase_grad(torch, device, gen)
    _phase("grad", t0)
    t0 = time.perf_counter()
    phase_step_vs_cpu(torch, device)
    _phase("step_vs_cpu", t0)
    t0 = time.perf_counter()
    fecl_rows = phase_fecl(torch, device, gen, peaks)
    _phase("fecl", t0)
    t0 = time.perf_counter()
    k1_isles_rows = phase_k1(torch, device, gen, peaks, ISLES_SHAPES, TRAIN_BATCH, "k1_isles")
    dx_isles_rows = phase_dx(torch, device, gen, peaks, ISLES_SHAPES, "k1_dx_isles")
    dw_isles_rows = phase_dw(torch, device, gen, peaks, ISLES_SHAPES, "k1_dw_isles")
    k1_isles_eval_rows = phase_k1(torch, device, gen, peaks, ISLES_EVAL_SHAPES, 1,
                                  "k1_isles_eval")
    _phase("k1_isles", t0)
    t0 = time.perf_counter()
    phase_step_vs_cpu(torch, device, "isles22")
    _phase("step_vs_cpu_isles", t0)
    t0 = time.perf_counter()
    k1_brats_rows = phase_k1(torch, device, gen, peaks, K1_SHAPES, TRAIN_BATCH, "k1_brats")
    dx_brats_rows = phase_dx(torch, device, gen, peaks, K1_SHAPES, "k1_dx_brats")
    dw_brats_rows = phase_dw(torch, device, gen, peaks, K1_SHAPES, "k1_dw_brats")
    _phase("k1_brats", t0)

    t0 = time.perf_counter()
    params, state = weights.init_jax_tree(UNet3DConfig(), seed=SEED)
    sd = weights.jax_tree_to_state_dict(params, state)
    nets = {}
    for layout in ("folded", "NDHWC"):
        nets[layout] = UNet3D(UNet3DConfig(layout=layout)).to(device).eval()
        nets[layout].load_state_dict(sd)
    phase_model(torch, device, gen, nets)
    _phase("model", t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        eval_launches = phase_eval(torch, nets, tmp)
        del nets
        _phase("e2e", t0)
        t0 = time.perf_counter()
        train = phase_train(torch, tmp)
        _phase("train", t0)
        t0 = time.perf_counter()
        isles = phase_isles_train(torch, tmp)
        _phase("isles_train", t0)
        t0 = time.perf_counter()
        isles_eval = phase_isles_eval(torch, device, isles)
        _phase("isles_eval", t0)
        t0 = time.perf_counter()
        brats = phase_brats_train(torch, tmp)
        _phase("brats_train", t0)
        t0 = time.perf_counter()
        phase_monitor(torch, brats.pop("diag"))
        _phase("monitor", t0)
        t0 = time.perf_counter()
        phase_brats_eval(torch, device, brats)
        _phase("brats_eval", t0)
        t0 = time.perf_counter()
        k1_vnet_rows = phase_k1(torch, device, gen, peaks, VNET_TRAIN_SHAPES, TRAIN_BATCH,
                                "k1_vnet")
        dx_vnet_rows = phase_dx(torch, device, gen, peaks, VNET_TRAIN_SHAPES, "k1_dx_vnet")
        dw_vnet_rows = phase_dw(torch, device, gen, peaks, VNET_TRAIN_SHAPES, "k1_dw_vnet")
        phase_nan(torch, device, gen, VNET_TRAIN_SHAPES[0])
        phase_nan(torch, device, gen, VNET_TRAIN_SHAPES[2])
        _phase("k1_vnet", t0)
        t0 = time.perf_counter()
        phase_vnet_model(torch, device, gen)
        _phase("vnet_model", t0)
        t0 = time.perf_counter()
        vnet = phase_vnet_train(torch, tmp, train["root"])
        _phase("vnet_train", t0)
        t0 = time.perf_counter()
        phase_vnet_eval(torch, device, vnet)
        _phase("vnet_eval", t0)
        t0 = time.perf_counter()
        phase_aspp_train(torch, tmp, train["root"])
        _phase("aspp_train", t0)
        t0 = time.perf_counter()
        phase_step_vs_cpu(torch, device, "vnet")
        phase_step_vs_cpu(torch, device, "aspp")
        _phase("step_vs_cpu_vnet", t0)
        t0 = time.perf_counter()
        bf16_rows = {
            "eval": phase_bf16_kernel(torch, device, gen, peaks, K1_SHAPES, PATCH_BATCH, "fwd",
                                      "k1_bf16"),
            "train": phase_bf16_kernel(torch, device, gen, peaks, TRAIN_SHAPES, TRAIN_BATCH,
                                       "fwd", "k1_bf16_train"),
            "dx": phase_bf16_kernel(torch, device, gen, peaks, TRAIN_SHAPES, TRAIN_BATCH, "dx",
                                    "k1_dx_bf16"),
            "dw": phase_bf16_kernel(torch, device, gen, peaks, TRAIN_SHAPES, TRAIN_BATCH, "dw",
                                    "k1_dw_bf16")}
        phase_nan(torch, device, gen, TRAIN_SHAPES[2], torch.bfloat16)
        _phase("k1_bf16", t0)
        t0 = time.perf_counter()
        for part in ("fwd", "dx", "dw"):
            bf16_rows["vnet_" + part] = phase_bf16_kernel(
                torch, device, gen, peaks, VNET_TRAIN_SHAPES, TRAIN_BATCH, part,
                f"k1_vnet_bf16_{part}")
        phase_nan(torch, device, gen, VNET_TRAIN_SHAPES[0], torch.bfloat16)
        phase_nan(torch, device, gen, VNET_TRAIN_SHAPES[2], torch.bfloat16)
        _phase("k1_vnet_bf16", t0)
        t0 = time.perf_counter()
        phase_bf16_model(torch, device, gen)
        _phase("bf16_model", t0)
        t0 = time.perf_counter()
        bf16 = phase_bf16_train(torch, tmp, train["root"])
        bf16_vnet = phase_bf16_train(torch, tmp, train["root"], model="vnet")
        print(f"bf16_train against float32 (phase train, vnet_train): UNet3D "
              f"{bf16['ms_per_step']:.3f} against {train['ms_per_step']:.3f} ms per step, peak "
              f"{bf16['peak_gib']:.3f} against {train['peak_gib']:.3f} GiB; VNet "
              f"{bf16_vnet['ms_per_step']:.3f} against {vnet['ms_per_step']:.3f} ms, peak "
              f"{bf16_vnet['peak_gib']:.3f} against {vnet['peak_gib']:.3f} GiB")
        _phase("bf16_train", t0)
        t0 = time.perf_counter()
        bf16_eval = phase_bf16_eval(torch, device, bf16)
        _phase("bf16_eval", t0)
        t0 = time.perf_counter()
        phase_step_vs_cpu(torch, device, "pancreas_bf16")
        phase_step_vs_cpu(torch, device, "vnet_bf16")
        _phase("step_vs_cpu_bf16", t0)
        t0 = time.perf_counter()
        phase_group_eval(torch, device)
        _phase("group_eval", t0)
        t0 = time.perf_counter()
        phase_dp_train(torch, device, tmp, train["root"])
        _phase("dp_train", t0)
        t0 = time.perf_counter()
        phase_preprocess(torch, tmp)
        _phase("preprocess", t0)
        t0 = time.perf_counter()
        trained = phase_trained_eval(torch, device, tmp)
        _phase("trained_eval", t0)
        t0 = time.perf_counter()
        k1_abl_rows = phase_k1(torch, device, gen, peaks, ABLATION_SHAPES, ABLATION_BATCH,
                               "k1_ablation")
        dx_abl_rows = phase_dx(torch, device, gen, peaks, ABLATION_SHAPES, "k1_dx_ablation",
                               ABLATION_BATCH)
        dw_abl_rows = phase_dw(torch, device, gen, peaks, ABLATION_SHAPES, "k1_dw_ablation",
                               ABLATION_BATCH)
        _phase("k1_ablation", t0)
        t0 = time.perf_counter()
        ablation = phase_ssl_ablation(torch, tmp)
        _phase("ssl_ablation", t0)
        t0 = time.perf_counter()
        phase_determinism(torch, device, tmp, dict(pancreas=train["root"], isles=isles["root"],
                                                   brats=brats["root"]), ablation)
        _phase("determinism", t0)
        t0 = time.perf_counter()
        phase_host_loop(torch, tmp, dict(pancreas=train["root"], brats=brats["root"]), ablation)
        _phase("host_loop", t0)
        t0 = time.perf_counter()
        phase_remat(torch, device)
        _phase("remat", t0)
        t0 = time.perf_counter()
        phase_wire(torch, tmp, train["root"])
        _phase("wire", t0)

    k1_src = "dycon_paper_replication_tpu_torch/ops/csrc/folded_conv3.cu"
    dx_replaces = "dycon_paper_replication_tpu/ops/folded_conv_pallas.py:215 (_conv_wf_bwd, dx)"
    dw_src = "dycon_paper_replication_tpu_torch/ops/csrc/folded_conv3_dw.cu"
    dw_replaces = "dycon_paper_replication_tpu/ops/folded_conv_pallas.py:179 (_dwf)"
    kernels = [
        _kernel_entry("folded_conv3", "eval", k1_src, K1_REPLACES, eval_launches, k1_rows,
                      bound="tf32x3"),
        _kernel_entry("folded_conv3_train", "train", k1_src, K1_REPLACES,
                      train["launches"]["k1"], k1_train_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_dx", "train", k1_src, dx_replaces,
                      train["launches"]["k1_dx"], dx_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_dw", "train", dw_src, dw_replaces,
                      train["launches"]["k1_dw"], dw_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_isles", "isles_train", k1_src, K1_REPLACES,
                      isles["launches"]["k1"], k1_isles_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_dx_isles", "isles_train", k1_src, dx_replaces,
                      isles["launches"]["k1_dx"], dx_isles_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_dw_isles", "isles_train", dw_src, dw_replaces,
                      isles["launches"]["k1_dw"], dw_isles_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_isles_eval", "isles_eval", k1_src, K1_REPLACES,
                      isles_eval["k1_launches"], k1_isles_eval_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_brats", "brats_train", k1_src, K1_REPLACES,
                      brats["launches"]["k1"], k1_brats_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_dx_brats", "brats_train", k1_src, dx_replaces,
                      brats["launches"]["k1_dx"], dx_brats_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_dw_brats", "brats_train", dw_src, dw_replaces,
                      brats["launches"]["k1_dw"], dw_brats_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_vnet", "vnet_train", k1_src, K1_REPLACES,
                      vnet["launches"]["k1"], k1_vnet_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_dx_vnet", "vnet_train", k1_src, dx_replaces,
                      vnet["launches"]["k1_dx"], dx_vnet_rows, bound="tf32x3"),
        _kernel_entry("folded_conv3_dw_vnet", "vnet_train", dw_src, dw_replaces,
                      vnet["launches"]["k1_dw"], dw_vnet_rows, bound="tf32x3"),
    ]
    for name, path, launches, rows, src, replaces in (
            ("folded_conv3_bf16", "bf16_eval", bf16_eval["k1_launches"], bf16_rows["eval"],
             k1_src, K1_REPLACES),
            ("folded_conv3_train_bf16", "bf16_train", bf16["launches"]["k1"], bf16_rows["train"],
             k1_src, K1_REPLACES),
            ("folded_conv3_dx_bf16", "bf16_train", bf16["launches"]["k1_dx"], bf16_rows["dx"],
             k1_src, dx_replaces),
            ("folded_conv3_dw_bf16", "bf16_train", bf16["launches"]["k1_dw"], bf16_rows["dw"],
             dw_src, dw_replaces),
            ("folded_conv3_vnet_bf16", "bf16_train_vnet", bf16_vnet["launches"]["k1"],
             bf16_rows["vnet_fwd"], k1_src, K1_REPLACES),
            ("folded_conv3_dx_vnet_bf16", "bf16_train_vnet", bf16_vnet["launches"]["k1_dx"],
             bf16_rows["vnet_dx"], k1_src, dx_replaces),
            ("folded_conv3_dw_vnet_bf16", "bf16_train_vnet", bf16_vnet["launches"]["k1_dw"],
             bf16_rows["vnet_dw"], dw_src, dw_replaces)):
        kernels.append(_kernel_entry(name, path, src, replaces, launches, rows, bound="bf16"))
    # the trained checkpoint's evaluation runs K1 and K1-bf16 at the eval
    # shapes (patch 96^3, batch PATCH_BATCH) that phases kernels and k1_bf16 time
    kernels.append(_kernel_entry("folded_conv3_trained", "trained_eval", k1_src, K1_REPLACES,
                                 trained["k1_launches"]["float32"], k1_rows, bound="tf32x3"))
    kernels.append(_kernel_entry("folded_conv3_bf16_trained", "trained_eval_bf16", k1_src,
                                 K1_REPLACES, trained["k1_launches"]["bfloat16"],
                                 bf16_rows["eval"], bound="bf16"))
    for name, launches_key, rows, src, replaces in (
            ("folded_conv3_ablation", "k1", k1_abl_rows, k1_src, K1_REPLACES),
            ("folded_conv3_dx_ablation", "k1_dx", dx_abl_rows, k1_src, dx_replaces),
            ("folded_conv3_dw_ablation", "k1_dw", dw_abl_rows, dw_src, dw_replaces)):
        kernels.append(_kernel_entry(name, "ssl_ablation", src, replaces,
                                     ablation["launches"][launches_key], rows, bound="tf32x3"))
    for name, key, row in (("K2 forward (ISLES train)", "k2_fwd", fecl_rows["fwd"]),
                           ("K2 backward (ISLES train)", "k2_bwd", fecl_rows["bwd"])):
        kernels.append(dict(name=name, path="isles_train", route="cuda", source=K2_SOURCE,
                            replaces=K2_REPLACES, launches=isles["launches"][key],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["tf32x3_bound_ms"],
                            bound_by=row["tf32x3_bound_by"], bound_kind="tf32x3",
                            float32_bound_ms=row["bound_ms"], library_ms=None,
                            shapes=[row]))
    print(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
