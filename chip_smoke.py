"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

  python3 chip_smoke.py

Builds the port's CUDA kernels from pcc_tpu_torch/csrc/ (one nvcc per
source, all started together), drives the IPDAE compress -> decompress path
at the default CodecConfig (N=8192, K=256, S=64, d=16, L=7) on 64 synthetic
clouds from a numpy seed with random weights from a torch seed, then the
IPDAE train step at the same config on 8 such clouds, then the PPPF-AE
compress -> decompress path (CodecConfig(model="PPPF-AE"), same widths) on
16 of the clouds, then the PPPF-AE train step (warm-up steps on 4 clouds,
fused steps on 8), then both families' train steps on 512-point clouds
(cli/train.py --N 512; every train step runs the chamfer kernels), then the
SetAbstraction kernel behind SetAbstraction(fused=True), then evaluation
(metrics.eval_batch) on the card, then the PPPE whole-cloud codec at its
CLIs' defaults (32 clouds of 8192 points, latent 256, L = 7) through its
compress, decompress and eval CLIs, holds every kernel against its plain
PyTorch version at the shapes those paths give it, and checks the streams,
the train steps, the metrics and the PPPE latents against the port on the
CPU; then runs the train steps and the codec through the data-parallel
launcher (pcc_tpu_torch/parallel/mesh.py): one rank on NCCL, and two
ranks sharing the card over gloo; then both families' serving paths in
bf16 mixed precision (CodecConfig(compute_dtype="bfloat16"), the CLIs'
--bf16) on the bf16 instances of the encoder, decoder and stage kernels;
then the repo's large-scene rooms (65,536 and 100,000 points) through the
codec, and IPDAE training in bf16 (train --bf16) on the bf16 instances of
the encoder and its backward; then the PN++ families' bf16 training on
the stage's bf16 store mode and backward; then SetAbstraction and PPPE's
eval mode in bf16 on the bf16 instances of sa_fused.cu and of the stage's
"pppe" layout.

Phases (any failed check raises, and the script exits non-zero):
  1. card, power limit, torch and CUDA versions;
  2. kernel builds;
  3. the main path: Codec.compress_many -> Codec.decompress_many on the card
     with every launch counter set to 0 just before and read just after;
     decoded symbols must equal encoded ones, every kernel must have run;
     then one more encode and decode under torch.profiler (where the time
     goes: device kernel time, busy share, the ops with most device time);
  4. each kernel vs its plain version on that path's inputs (FPS indices
     bit-equal, at the skeleton's [64, 8192 -> 64], with the kernel's device
     time from a CUDA graph's replays beside the CUDA-event time of the
     wrapper's calls; encoder latents
     and decoder points within 1e-4, the decoder on the weights the decode
     path prepared and on seeded latents over every bin at the decode
     batch's shape (the path's own symbols all sit at the middle bin at
     random weights; distinct_rows), two of its launches bitwise equal; the
     encoder also
     against sa_cuda.py::_kernel_choices, its arithmetic replayed, on
     REPLAY_PATCHES patches: the count of entries that differ, each within
     one ulp; with its winners output, the latents bit-equal and the
     winners the plain version's on those patches), with CUDA event times
     (the encoder's also with the winners output), the plain version's time
     and the card's lower bound (the decoder's with its products as 3xTF32
     on the tensor cores, and in float32 beside it; its yardstick the
     expansion product alone, torch.matmul(h2, w3r) in float32 with TF32
     off, and the time the decode path would spend preparing its weights
     if it held none);
  5. two of the clouds on the CPU port: .s.bin/.c.bin byte-equal to the
     card's, the card's .p.bin decoded to the card encoder's symbols, and
     decoded clouds within one int8 step;
  6. the training path: the step cli/train.py builds (build_train_step,
     rate_mode "reference", lam 1e-6) on 8 clouds of 8192 points, one
     warm-up step, then TRAIN_STEPS counted steps with every launch counter
     set to 0 just before and read just after (fps, patch_encoder,
     patch_encoder_bwd, chamfer_fwd and chamfer_bwd once per step,
     patch_decoder never); finite losses,
     parameters moved; median step time, points/s and peak memory; one
     step under torch.profiler;
  7. the backward kernel vs its plain version on the step's own patches
     [512, 256, 3], the winners its forward handed over and its real
     cotangent (with the step's weights): the winners equal to the forward
     kernel's again and to the plain version's, the backward on them bit
     for bit the backward that gets them itself (winners=None), every
     output within TOL_BWD * max|plain|, two launches bitwise equal,
     CUDA-event times; the forward's time with and without the winners
     output;
  8. one train step at the CPU tests' TINY config on the card and on the
     CPU port, same weights and FPS starts (the card's step launches the
     chamfer kernels once each): loss to 1e-5 relative, every parameter's
     gradient within 1e-5 of its largest entry, updated parameters to 1e-5.
  9. the PPPF-AE path: Codec(CodecConfig(model="PPPF-AE"), batch_size=16) on
     16 clouds with seeded random weights and non-trivial BatchNorm
     statistics (seeded running means and variances, some negative
     scales); warm-up, then compress_many -> decompress_many with every
     launch counter set to 0 just before and read just after
     (pppf_sa_stage 3, fps 3, fps_int 6: the integer CPM's three stages in
     the encode and again in the decode, the IPDAE kernels 0); decoded
     symbols equal encoded ones; decoded clouds [S*d*d, 3] and finite;
     clouds/s, bits per point, the steps of one batch, one encode and one
     decode under torch.profiler;
 10. the stage kernel vs its plain version on that path's own stage inputs
     (sa1, sa2, sa3 at P = 1024) and, with the "pppe" layout, on sa2's
     inputs: max abs error <= TOL of the output's largest entry; the
     "pppf" kernel also against the per-point replay of its arithmetic
     (pppf_sa_points(replay=True)) on REPLAY_PATCHES patches at each stage:
     the count of entries that differ, each within one ulp; CUDA-event
     times, the plain version's time and the card's lower bound (the work
     the function needs: the stack per point); every FPS call of one encode
     batch (recording_fps: the skeleton, the encoder's sa2 and sa3, the
     integer CPM's three stages) held bit for bit to its plain version on
     its own inputs and timed (fps_check: CUDA events, device time, the
     plain version's time, the bound, ns per step);
 11. one of the clouds on the CPU port with the same weights: .s.bin and
     .c.bin byte-equal, the card's .p.bin decoded on the CPU to the card's
     symbols, the integer coding weights [1, 64, 16, 7] bit-equal;
 12. the PPPF-AE train path, built as cli/train.py --model PPPF-AE builds it
     (seeded weights and BatchNorm statistics): one uncounted and
     PPPF_WARMUP_STEPS counted warm-up steps (batch statistics, plain
     stages) on PPPF_WARMUP_CLOUDS clouds, then one uncounted and
     PPPF_FUSED_STEPS counted fused steps on PPPF_TRAIN_CLOUDS, every launch
     counter set to 0 just before each kind's counted steps and read just
     after (fps 6, chamfer_fwd and chamfer_bwd 1 per step; fused:
     pppf_sa_stage 3 and pppf_sa_stage_bwd 3 per step; nothing else);
     finite losses, parameters moved, the encoder's
     running statistics moved by warm-up steps only, the CPM's by both;
     median step times, points/s, peak memory; one fused step under
     torch.profiler;
 13. the stage backward kernel vs its plain version on one more fused
     step's own stage inputs and cotangents (sa1, sa2, sa3 at P = 512):
     every output within TOL_BWD of the plain version's largest entry, two
     launches bitwise equal, CUDA-event times, the plain version's time and
     the card's lower bound (with the dx and dW products as 3xTF32 on the
     tensor cores, and all in float32 beside it); each stage's launches'
     device times under torch.profiler; the same step's six FPS calls (the
     skeleton, the encoder's sa2 and sa3, the CPM's three stages on batch
     statistics) held bit for bit to the plain version and timed
     (fps_check);
 14. a warm-up step and a fused step at TINY_PPPF on the card and on the
     CPU port, each from the same fresh weights and FPS starts
     (compare_train_states; each card step launches the chamfer kernels
     once): loss to 1e-5 relative, every gradient within TOL_PPPF_STEP of
     its largest entry (TOL_BATCH_STATS where it runs through batch
     statistics), parameters to a quarter of the learning rate, running
     statistics to TOL_BATCH_STATS;
 15. the small-cloud train path, built as cli/train.py --N 512 builds it
     (CodecConfig(N=512), seeded weights, synthetic 512-point clouds): the
     IPDAE step on SMALL_CLOUDS clouds (512 patches, phase 6's count), the
     PPPF-AE warm-up step on SMALL_WARMUP_CLOUDS and its fused step on
     SMALL_CLOUDS; per kind one uncounted and SMALL_STEPS counted steps,
     every launch counter set to 0 just before and read just after
     (chamfer_fwd and chamfer_bwd once per step; fps 1 (IPDAE) or 6; the
     encoder and stage kernels as in phases 6 and 12); finite losses,
     parameters moved; median step times, points/s, peak memory; one IPDAE
     and one fused PPPF-AE step under torch.profiler;
 16. the chamfer kernels vs their plain versions on the train steps' own
     clouds at every path shape: N = 512 IPDAE and fused PPPF-AE (one more
     step each of phase 15), N = 8192 IPDAE (phase 6's step that records
     the encoder), the N = 8192 fused PPPF-AE step (phase 12's that records
     the stages) and its warm-up step (phase 12's uncounted one), with the
     loss's real cotangents and a random pair: indices bit-equal, distances
     within TOL and gradients within TOL_BWD of the plain version's largest
     entry, two backward launches bitwise equal; CUDA-event times, device
     times from CUDA-graph replays, the plain versions' times, the bounds
     and the forward's instruction floor; the N = 512 fused PPPF-AE step's
     six FPS calls (the CPM's on skeletons of 4 points) held and timed as
     in phase 13;
 17. the SetAbstraction kernel (layers 2 and 3 on the tensor cores) vs its
     plain version on the IPDAE serving path's own patches (phase 4,
     [4096, 256, 3]) with the serving model's weights: within TOL of the
     largest entry, two launches bitwise equal; CUDA-event and device
     times (the log line also quotes the float32 design it replaced, an
     earlier run's figure in FP32_DESIGN_MS, not measured here), the
     plain version's time, both bounds (layers 2-3 in 3xTF32, and all in
     float32); then
     SetAbstraction(fused=True) on the card with every launch counter set
     to 0 just before and read just after (sa_fused 1), its output equal to
     the kernel's;
 18. evaluation on the card: metrics.eval_batch on phase 3's 64 decoded
     IPDAE clouds against their originals, finite; EVAL_CPU_PAIRS pairs
     again on the CPU port, within TOL_EVAL; CUDA-event time per
     EVAL_PAIRS pairs, the normals' share and one query chunk's stable sort;
 19. the PPPE serving path (models/pppe.py, seeded weights, randomize_
     batchnorm, the latent head spread over the bins; pcc_tpu's
     ae_latest.pkl in a model folder): cli/pppe_pcd_compress.py raw and
     with --entropy_coding on 32 PLY files, every launch counter set to 0
     just before each run and read just after (fps 3, pppf_sa_stage 2,
     nothing else), cli/pppe_pcd_decompress.py in its three transforms (no
     kernel), cli/eval_pppe.py; walls, stream sizes, the encode's and
     decode's walls and peak memory, each under torch.profiler; the .bin
     latents equal to the encoder's; PPPE_CPU_CLOUDS clouds on the CPU
     port: latents within TOL of the largest, decoded clouds within TOL;
 20. the stage kernel in the "pppe" layout (the first layer's feature
     block per point, later layers on the tensor cores) vs pppf_sa_plain on
     phase 19's own sa2 and sa3 inputs (recorded): within TOL of the
     largest entry, two launches bitwise equal, the selection bit-equal
     (read through the kernel with one-hot features and an identity
     layer), CUDA-event and device times (the log line also quotes the
     float32 per-slot design's, an earlier run's figure in FP32_DESIGN_MS,
     not measured here), the plain version's time, both bounds (the
     products in 3xTF32, and all in float32; the work per point where the
     first layer allows); the layout's per-slot route once, at widths past
     the slot kernel's tiles (a PER_SLOT_MIDDLE-wide middle layer, seeded
     layers) on sa2's inputs, held the same way (pppe_per_slot_check);
     phase 19's three FPS calls held bit for bit and timed (fps_check),
     sa1's top-32 selection timed;
 21. PPPE training at the train CLI's defaults (pppe_train_phase): launches
     per step fps 3, chamfer_fwd 1, chamfer_bwd 1; a NaN batch skipped with
     the whole state bit for bit; the step's FPS and chamfer held to their
     plain versions on its own inputs;
 22. one PPPE step at TINY_PPPE on the card and on the CPU port
     (compare_train_states, the encoder's gradients and the running
     statistics to TOL_PPPE_STEP), then the PPPE train CLI into the PPPE
     compress and decompress CLIs;
 23. the attribute codec on ATTR_CLOUDS coloured clouds (attr_codec_phase):
     launches per batch, symbols, the CPU port's streams, colour PSNR, the
     encoder and decoder held to their plain versions on the batch;
 24. the attribute train step (attr_train_phase): launches per step, the
     patch encoder with its winners and its backward held to their plain
     versions on the step's own [256, 256, 3] patches (kernel_check: each
     output within its tolerance of the plain one's own largest entry),
     FPS and the chamfer as in phase 21;
 25. the launcher (parallel/mesh.py::launch) at world size 1 on NCCL: the
     IPDAE step (8 clouds of 8192 points), the PPPE step (4 clouds) and the
     64-cloud IPDAE compress -> decompress in one worker on cuda:0, each
     bit for bit the same run without a process group in this process
     (losses, every parameter after one step, streams, decoded clouds),
     with the same launches per step or batch; the step walls beside the
     unlaunched ones and phases 6 and 21's;
 26. two ranks sharing the card over gloo (launch(2, ...,
     device="cuda:0", backend="gloo")), each on its half of every batch:
     the IPDAE step (4 + 4 clouds), the PPPE step (2 + 2), the fused
     PPPF-AE step at N = 512 (64 + 64) and the 64-cloud compress ->
     decompress; against the one-device runs: losses to 1e-6 relative,
     gradients summed over the ranks within 1e-5 of each tensor's largest
     entry (through batch statistics: PPPF-AE's probability model to
     TOL_BATCH_STATS, PPPE's every gradient to TOL_PPPE_STEP), streams and
     clouds bit for bit, both ranks' parameters bit-equal after the step,
     each rank's launches per step or batch the one device's (the
     counters are per process); each worker's counters printed;
 27. the IPDAE path in bf16 (CodecConfig(compute_dtype="bfloat16"), 64
     clouds, phase 3's weights with the PointNet's last layer calibrated
     on the clouds so that the symbols spread over every bin,
     spread_symbols): the float32 path on the same weights (one uncounted,
     one counted compress_many -> decompress_many, profiled), then the
     same in bf16 (fps 1, patch_encoder_bf16 1, patch_decoder_bf16 1, the
     float32 instances and every other kernel 0); decoded symbols equal
     encoded ones, spread over the bins in both runs (symbol_spread);
     .s.bin and .c.bin byte-equal to the float32 run's, the share of
     symbols and the .p.bin that bf16 changes; the card's .p.bin decoded
     on the CPU port to the card's symbols; walls and device time
     (torch.profiler) beside the float32 run's;
 28. the bf16 encoder and decoder against their plain versions on phase
     27's inputs, each on distinct rows (distinct_rows: the latents, and
     the h2 of the path's spread symbols) (bf16_hold: every entry bf16, at
     least BF16_SHARE of them bit-equal, every one within BF16_TOL of the
     largest, two launches bitwise equal), the encoder also against the
     replay of its arithmetic on REPLAY_PATCHES patches, bit for bit (its
     products on the tensor cores, certified: csrc/certified.cuh);
     CUDA-event and device times, the plain
     versions' times, both bounds (the products on the bf16 tensor cores
     at 989 TFLOP/s, and all in float32 on the CUDA cores), the decoder's
     bf16 expansion product alone in cuBLAS (its library_ms) and its bytes
     from L2 by its tile plan (logged);
 29. the PPPF-AE path in bf16 on phase 9's clouds and weights, enc_proj
     calibrated as in 27 (launches pppf_sa_stage_bf16 3, fps 3, fps_int 6
     per compress -> decompress), checked as in 27 against the float32
     path on the same weights; the bf16 stage against its plain version at
     the path's three stage shapes, as in 28, and bit for bit against the
     bf16 replay of its arithmetic (pppf_sa_points(replay=True, bf16=True))
     on REPLAY_PATCHES patches at each; then compress --bf16 ->
     decompress --bf16 through the CLIs on BF16_CLI_CLOUDS clouds of each
     family, on phases 27 and 29's weights written as pcc_tpu's pickles
     (the IPDAE streams phase 27's bytes);
 30. eval/gen_rooms.py's large-scene rooms (ROOM_SIZES: four of 65,536
     points and one of 100,000, seeded; S = 512 and 781) through
     Codec.compress_many -> decompress_many at batch ROOM_BATCH on phase 3's
     weights (large_scene_phase): launches (fps and patch_encoder once per
     batch, patch_decoder once per decode batch), each batch's FPS
     bit-equal to fps_plain and timed with its bound (fps_check), .s.bin
     and .c.bin byte-equal to the CPU port's, the card's .p.bin decoded on
     the card and on the CPU port to the encoder's symbols, decoded clouds
     [S * k, 3] finite;
 31. the bf16 IPDAE train step (CodecConfig(compute_dtype="bfloat16"),
     train --bf16) on 8 clouds of 8192 points, TRAIN_STEPS counted steps:
     launches per step fps 1, patch_encoder_bf16 1 (its latent and, in the
     second half of its grid, the winners of the backward's replay),
     patch_encoder_bwd_bf16 1, chamfer_fwd and chamfer_bwd 1, bf16_reduce
     the same count each step (the bias gradients' bf16 reductions), every
     other kernel 0; finite losses, parameters moved, step time, peak
     memory, a profile;
 32. the bf16 encoder backward against its plain version on phase 31's
     recorded step (every output within TOL_BWD of the plain version's
     largest entry, two launches bitwise equal, the winners the step's and
     the plain version's, the latent the serving instance's; times, the
     bound on the bf16 tensor cores and in float32), and every bf16_reduce
     call of the step bit-equal to its plain version, one launch a call;
     then csrc/certified.cuh's model of the bf16 tensor cores checked on
     the card (csrc/cert_model.cu): on ops/certified.py's stress rows
     (cancelling sums, wide exponent spreads inside a k16 block, products
     into the subnormal range; K = 16, 131, 256, 1024) every tensor-core
     sum within the certificate's bound E of the k-order sum, the largest
     |s_tc - s_k| / E printed (at most 1);
 33. one bf16 train step at TINY on the card and on the CPU port (loss,
     gradients and parameters within tests/test_torch_port_train_bf16.py's
     bounds);
 34. cli/train.py --bf16 --max_steps 3 into compress --bf16 and decompress
     --bf16 on the checkpoint it wrote, with launches per run; the train
     CLI's refusal of --model AE --bf16 with --devices 2;
 35. PPPF_AE(compute_dtype="bfloat16") in train mode, its encoder frozen,
     at the default config on the patches of phase 12's 8 clouds (512 of
     K = 256), forward and backward: launches fps 3,
     pppf_sa_stage_bf16_save 3, pppf_sa_stage_bwd_bf16 3; each stage's
     bf16 backward held to its plain version on the same stored forward
     (TOL_BWD of the largest entry for the weight gradients; the row
     gradients row by row by tools/holds.py::row_hold, which the control
     regrouped per point, regrouped_rows, must fail), two launches bitwise
     equal, the store mode's output to the plain bf16 forward by the bf16
     serving phases' limits; times and bounds (the products at the bf16
     tensor cores' rate, and in float32);
 36. PPPE training in bf16 (PPPEConfig(compute_dtype="bfloat16")) as
     phase 21 (launches per step fps 3, chamfer 1 + 1 and the bf16
     reductions, peak memory, the NaN skip), a TINY bf16 step card vs CPU
     port (its gradients by the CPU port's own spread over reorderings of
     the clouds, the update as optax's Adam on the card's gradient),
     cli/train_pppe_pcd_ae.py --bf16 --max_steps 3 into the PPPE compress
     and decompress CLIs;
 37. cli/train.py --model PPPF-AE --N 512 --max_steps 2 with and without
     --bf16, under torch's deterministic algorithms: the --bf16 run's
     parameters as close to the float32 run's as a float32 repeat's (0:
     within 1e-6) (pcc_tpu's PPPF-AE trainer is float32 under --bf16; the
     card's float32 step repeats bit for bit only with those algorithms),
     the same launches and no bf16 one;
 38. SetAbstraction(knn=16, compute_dtype="bfloat16", fused=True) on
     phase 17's patches ([4096, 256, 3], the IPDAE serving batch's) with
     the serving model's weights: one call with every launch counter set
     to 0 just before and read just after (sa_fused_bf16 1, nothing
     else), its output the kernel's; the bf16 instance held to
     sa_fused_plain(bf16=True) (at least BF16_SHARE of the entries
     bit-equal, every entry within BF16_TOL of the largest, bf16 values,
     two launches bitwise equal), the float32 instance's output failing
     that hold (the control); CUDA-event and device times, the plain
     version's time, the bounds;
 39. PPPE in bf16 eval mode (make_pppe_model(PPPEConfig(compute_dtype=
     "bfloat16")), the CLIs' defaults: N 8192, latent 256, L 7) on 32
     clouds, the latent head scaled as phase 19's: encode_clouds ->
     symbols -> decode_latents with the launch counters set to 0 just
     before and read just after (fps 3, pppe_sa_stage_bf16 2, nothing
     else; nothing in the decode), walls and the busy share; 4 of the
     clouds against the CPU port: the global feature under the bf16 hold
     and the float32 model's (the control) failing it, the latents within
     BF16_TOL of their largest entry (their bit-equal share and the
     float32 model's printed beside them), the symbols equal but near a
     bin's edge, the decoded clouds within BF16_TOL of the CPU's;
 40. the bf16 "pppe" instance against its plain version on phase 39's own
     sa2 and sa3 inputs and on the per-slot route (phase 20's
     PER_SLOT_MIDDLE-wide middle layer on sa2's inputs, seeded layers
     rounded): the bf16 hold, the float32 instance failing it, CUDA-event
     and device times, the plain version's time, the bounds.
The line before the last is the kernels' JSON record (the IPDAE serving
path's launch counts for fps, patch_encoder and patch_decoder, the counted
train steps' for patch_encoder_bwd, the PPPF-AE path's for pppf_sa_stage
and fps_int (the int32 instance of the FPS kernel: the integer CPM's three
stages per evaluation, its times summed over them, each under `stages`),
the counted fused PPPF-AE steps' for pppf_sa_stage_bwd, all counted train
steps' (phases 6, 12 and 15) for chamfer_fwd and chamfer_bwd (the N = 512
IPDAE step's shape on top, every path shape under `paths` with its own
steps' count), phase 17's module call's for sa_fused, phase 19's raw PPPE
compress batch's for "pppf_sa_stage (pppe layout)" (sa2 and sa3 summed,
each under `stages`); fps also carries the PPPF-AE and PPPE paths' counts
as launches_pppf and launches_pppe and every float shape it was held and
timed at (phases 4, 10, 13, 16, 20) under `shapes`, pppf_sa_stage its
launches per fused step; phase 20's per-slot "pppe" route, with no launch
on a path; phases 27-29's patch_encoder_bf16, patch_decoder_bf16 and
pppf_sa_stage_bf16 with their launches on the bf16 paths; phase 30's FPS
shapes under fps's `shapes`, its launches as launches_rooms; phases 31-32's
patch_encoder_bwd_bf16 and bf16_reduce with their launches over the counted
bf16 train steps, patch_encoder_bf16's per bf16 step; phase 35's
pppf_sa_stage_bf16_save and pppf_sa_stage_bwd_bf16; phase 38's
sa_fused_bf16; phase 39's counted encode's pppe_sa_stage_bf16, its sa2
and sa3 summed and each under `stages`, the per-slot route under
`per_slot_route`); the last line is
{"ok": true, "device": {...}}.
Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from pcc_tpu_torch.codec import (Codec, decode_clouds_packed, encode_geometry, init_params,
                                 make_models)
from pcc_tpu_torch.codec import integer_pmf_weights, pack_encode_upload, unpack_encode_upload
from pcc_tpu_torch.coding.octree_host import codes_to_points, parse_octree_bits, unpack_bits
from pcc_tpu_torch.config import CodecConfig, PPPEConfig
from pcc_tpu_torch.metrics import eval_batch, eval_batch_device
from pcc_tpu_torch.models.layers import SetAbstraction
from pcc_tpu_torch.models.pppe import make_pppe_model
from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.chamfer_cuda import (ChamferFn, bwd_work, chamfer_bwd, chamfer_bwd_plain,
                                            chamfer_fwd, chamfer_fwd_plain, fwd_work)
from pcc_tpu_torch.ops.decoder_cuda import (bf16_tma_bytes, expansion_kmajor, pack_decoder,
                                            patch_decoder, patch_decoder_plain,
                                            permute_expansion)
from pcc_tpu_torch.ops import fps as fps_ops
from pcc_tpu_torch.ops.fps import fps_batch, fps_int_batch, fps_int_plain, fps_plain
from pcc_tpu_torch.ops.knn import select_nearest, sq_dists
from pcc_tpu_torch.ops.normals import estimate_normals
from pcc_tpu_torch.ops.pppf_sa_cuda import (PPPFStageFn, bf16_layers, pppe_kernel, pppf_sa_bwd,
                                            pppf_sa_bwd_plain, pppf_sa_bwd_plain_bf16,
                                            pppe_work, pppf_sa_fused, pppf_sa_plain,
                                            pppf_sa_points, stage_bwd_bf16_work,
                                            stage_bwd_flops, stage_bwd_work, stage_flops)
from pcc_tpu_torch.ops.sa_cuda import (PatchEncoderFn, _kernel_choices, _unflatten, bf16_wb,
                                       fma_matmul, patch_encoder, patch_encoder_bwd,
                                       patch_encoder_bwd_plain,
                                       patch_encoder_plain, pointwise_plain, sa_fused,
                                       sa_fused_plain, winners_plain)
from pcc_tpu_torch.parallel.mesh import (build_sharded_pppe_train_step,
                                         build_sharded_pppf_train_step, build_sharded_train_step,
                                         global_sum, launch, rank)
from pcc_tpu_torch.tools.holds import (ROW_F32, ROW_SHARE, ROW_TOL, regrouped_rows, row_hold,
                                      shaped_clouds, spread_hold, steady_symbols)
from pcc_tpu_torch.train import build_pppf_train_step, build_train_step, create_train_state
from pcc_tpu_torch.train.state import make_optimizer
from pcc_tpu_torch.train.steps_pppe import (build_pppe_train_step, create_pppe_state,
                                            make_pppe_optimizer)

SEED = 11
N_CLOUDS = 64
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12  # CUDA cores' int32 rate: half the float32 rate
TF32_FLOP_PER_S = 495e12   # dense, on the tensor cores
TOL = 1e-4   # float32 sums in another order than cuBLAS / the CPU
# patches on which a kernel is held bit for bit to its replay in the kernels'
# own arithmetic (fma_matmul's float64 emulation of each fused multiply-add
# double-rounds about 2^-29 of the time, so an entry may differ by one ulp)
REPLAY_PATCHES = 64
# the backward kernel: max |kernel - plain| <= TOL_BWD * max |plain| for each
# of its 15 outputs (sums over 512 patches in another order)
TOL_BWD = 1e-4
SERVING_KERNELS = ("fps", "patch_encoder", "patch_decoder")
TRAIN_CLOUDS = 8     # clouds per train step (bench.py:317's batch)
TRAIN_STEPS = 10
TRAIN_LAM = 1e-6     # the reference's lambda, so the rate path runs
PPPF_CLOUDS = 16     # clouds per PPPF-AE device batch (the CLIs' default for this model)
# PPPF-AE training: the fused step at the IPDAE train batch; the warm-up
# step's plain stages keep every grouped activation for the backward (about
# 12.6 GB per cloud at full width), so it runs at the largest batch that
# leaves room on an 80 GB card
PPPF_TRAIN_CLOUDS = 8
PPPF_WARMUP_CLOUDS = 4
PPPF_WARMUP_STEPS = 2
PPPF_FUSED_STEPS = 5
TINY_PPPF = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, model="PPPF-AE")
# a PPPF-AE train step on the card vs the CPU port: each gradient within
# TOL_PPPF_STEP of its tensor's largest entry on the CPU (float32 products,
# the chamfer and the max routing's inputs in another order: up to 9.6e-4
# measured, in the fused step), TOL_BATCH_STATS where it runs through batch
# statistics: their fast variance mean(h^2) - mean^2 cancels over batches
# that are mostly copies of one row (masked slots, the CPM's FPS queries),
# and at TINY_PPPF the card and the CPU port differ by up to 0.15 there
# (the CPM in the fused step; the CPU port on 1 and on 8 threads by 1.8e-5;
# the stages' semantics are held to pcc_tpu in float64 by the CPU tests).
# Both bounds are about 3x the spread measured on an H100; ZERO_GRAD: see
# compare_train_states
TOL_PPPF_STEP = 3e-3
TOL_BATCH_STATS = 0.5
ZERO_GRAD = 1e-3
TINY = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
# the small-cloud train path (cli/train.py --N 512)
SMALL_N = 512
SMALL_CLOUDS = 128         # IPDAE and fused PPPF-AE steps: 512 patches, phase 6's count
SMALL_WARMUP_CLOUDS = 32   # PPPF-AE warm-up steps (plain stages keep every grouped row)
SMALL_STEPS = 5
# evaluation (phase 18): metrics.eval_batch's chunk of pairs, the pairs run
# again on the CPU port, and the card-vs-CPU bounds: PSNRs in dB, the others
# relative. D2 rests on PCA normals, whose eigenvectors cuSOLVER and LAPACK
# may turn differently where the two smallest eigenvalues nearly coincide;
# on these pairs D1 and D2 differed by 2.8e-7 dB, uc by 6.6e-8 and the
# chamfer by 0 (an H100, CUDA 12.8)
EVAL_PAIRS = 16
EVAL_CPU_PAIRS = 2
TOL_EVAL = {"p2point_psnr": 1e-3, "p2plane_psnr": 1e-3, "uc": 1e-4, "chamfer": 1e-5}
# PPPE serving (phases 19-20): the CLIs' default batch, and the clouds run
# again on the CPU port
PPPE_CLOUDS = 32
PPPE_CPU_CLOUDS = 2
# PPPE training (phases 21-22): the train CLI's default batch; a small
# config for the card-vs-CPU step (npoint 512 == N: sa1's centroids are the
# points themselves, no copies in the batch statistics)
PPPE_TRAIN_CLOUDS = 4
PPPE_TRAIN_STEPS = 10
TINY_PPPE = dict(N=512, latent_dim=32, L=7)
# phase 36's bf16 TINY step, card vs CPU: the CPU port's own spread over the
# same step with the clouds in these orders (tools/holds.py::spread_hold)
PPPE_REORDERS = (np.array([3, 2, 1, 0]), np.array([1, 3, 0, 2]))
# its card-vs-CPU bound for the encoder's gradients (through batch
# statistics) and the running statistics, relative to each tensor's largest
# entry: 2.7e-3 and 1.6e-3 measured on an H100 (PERF.md), about 7x below
TOL_PPPE_STEP = 2e-2
# the attribute extension (phases 23-24): AttrCodec's batch of 16 clouds,
# train_attributes' default batch of 4
ATTR_CLOUDS = 16
ATTR_CPU_CLOUDS = 2
ATTR_DA = 16
ATTR_TRAIN_CLOUDS = 4
ATTR_TRAIN_STEPS = 10
# the CUDA-core float32 designs of the "pppe" stage (per slot) and of
# SetAbstraction alone, which their tensor-core kernels replaced, as an
# earlier run of this script timed them at the same shapes on an NVIDIA H100
# 80GB HBM3 at 700 W (CUDA events, ms; PERF.md's kernel table). Quoted in
# the log lines of phases 17 and 20 for comparison; no record carries them,
# since nothing in a run measures them.
FP32_DESIGN_MS = {"pppe sa2": 0.807, "pppe sa3": 0.880, "sa_fused": 10.77}
# phase 20's per-slot "pppe" route: a middle layer this wide, past the slot
# kernel's widest pass (1024)
PER_SLOT_MIDDLE = 1536
# bf16 serving (phases 27-29): the bf16 kernels against their plain
# versions, at least BF16_SHARE of the entries bit-equal (float32 sums in
# another order move a bf16 rounding now and then) and every entry within
# BF16_TOL of the output's largest |entry|; the bf16 tensor cores' dense
# rate for the bounds beside the float32 CUDA cores' FP32_FLOP_PER_S
BF16_SHARE = 0.95
BF16_TOL = 2.0 ** -7
BF16_FLOP_PER_S = 989e12
BF16_CLI_CLOUDS = 4
PPPE_BF16_CPU_CLOUDS = 4   # phase 39: the PPPE bf16 clouds run again on the CPU port
# phases 27-29 serve on weights whose last encoder layer is calibrated on
# the phase's clouds (spread_symbols), the latent's standard deviation this
# many quantizer steps: at random weights the latent varies between patches
# far less than between channels (spread_symbols logs both) and every
# symbol sits at the middle bin
SPREAD_STD = 1.5
# and PPPF-AE's encoder BatchNorm scales multiplied by this gain: at the
# seeded ones its feature varies between patches by less than a bf16 step
PPPF_BN_GAIN = 2.0
# phase 30: eval/gen_rooms.py's large-scene rooms at the recipe's
# --batch_size 4 (eval/GOLDEN.md), one batch of four 65,536-point rooms and
# the 100,000-point room (S = 512 and 781)
ROOM_SIZES = (65536,) * 4 + (100000,)
ROOM_BATCH = 4
# phases 31-33: bf16 IPDAE training. The TINY step card vs the CPU port, and
# the bf16 backward kernel vs its plain version, with the bounds of
# tests/test_torch_port_train_bf16.py (each of a tensor's largest |entry|):
# the encoder's gradients, flax's Dense weights' (one bf16 rounding of a
# float32 sum each), flax's biases' (a bf16 reduction)
TOL_BF16_ENC = 2.0 ** -10
TOL_BF16_GRAD = 2.0 ** -7
TOL_BF16_BIAS = 2.0 ** -4
REPEAT_FACTOR = 4.0              # phase 37: the --bf16 run vs a float32 repeat
BF16_PARAM_SHARE = 0.99
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def synthetic_clouds(n: int, N: int, seed: int) -> list:
    """Gaussian-blob clouds (16 blobs each) from a numpy seed."""
    rng = np.random.default_rng(seed)
    centres = rng.random((n, 16, 3)) * 4 - 1
    which = rng.integers(0, 16, (n, N))
    pts = np.take_along_axis(centres, which[..., None], 1) \
        + rng.standard_normal((n, N, 3)) * 0.15
    return [c.astype(np.float32) for c in pts]


def room_cloud(rng, n: int) -> np.ndarray:
    """One synthetic room of n points, eval/gen_rooms.py's generator (the
    large-scene recipe's, eval/GOLDEN.md): floor, ceiling and walls plus 4-8
    furniture boxes, surface-sampled by area, with 5 mm of noise."""
    w, d, h = rng.uniform(4, 10), rng.uniform(4, 10), rng.uniform(2.5, 4)
    quads = [(np.zeros(3), np.array([w, 0, 0]), np.array([0, d, 0]), w * d),
             (np.array([0, 0, h]), np.array([w, 0, 0]), np.array([0, d, 0]), w * d)]
    for o, e1 in [((0, 0, 0), (w, 0, 0)), ((0, d, 0), (w, 0, 0)), ((0, 0, 0), (0, d, 0)),
                  ((w, 0, 0), (0, d, 0))]:
        quads.append((np.array(o, float), np.array(e1, float), np.array([0, 0, h]),
                      np.linalg.norm(e1) * h))
    for _ in range(rng.integers(4, 9)):
        bw, bd, bh = rng.uniform(0.4, 2.0, 3)
        bo = np.array([rng.uniform(0, w - bw), rng.uniform(0, d - bd), 0.0])
        for o, e1, e2 in [(bo + [0, 0, bh], [bw, 0, 0], [0, bd, 0]),
                          (bo, [bw, 0, 0], [0, 0, bh]), (bo + [0, bd, 0], [bw, 0, 0], [0, 0, bh]),
                          (bo, [0, bd, 0], [0, 0, bh]), (bo + [bw, 0, 0], [0, bd, 0], [0, 0, bh])]:
            e1, e2 = np.array(e1, float), np.array(e2, float)
            quads.append((o, e1, e2, np.linalg.norm(e1) * np.linalg.norm(e2)))
    areas = np.array([q[3] for q in quads])
    counts = rng.multinomial(n, areas / areas.sum())
    pts = []
    for (o, e1, e2, _), c in zip(quads, counts):
        u, v = rng.random((2, c))
        pts.append(o + u[:, None] * e1 + v[:, None] * e2)
    pc = np.concatenate(pts).astype(np.float32)
    return pc + rng.standard_normal(pc.shape).astype(np.float32) * 0.005


def rooms(sizes, seed: int) -> list:
    """Synthetic rooms of the given point counts from a numpy seed
    (room_cloud)."""
    rng = np.random.default_rng(seed)
    return [room_cloud(rng, n) for n in sizes]


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of `fn` over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


@contextlib.contextmanager
def recording_fps():
    """Record the inputs of every FPS call the paths make while active:
    fps_batch as codec.py, models/pppf.py and models/pppe.py call it, fps_int_batch as
    coding/iprob_pppf.py calls it (their names swapped for wrappers that
    record and go on to the kernels). Yields the list of calls, each
    (kind "f32" or "i32", points, npoint, starts or inf)."""
    import pcc_tpu_torch.codec as codec_mod
    import pcc_tpu_torch.coding.iprob_pppf as ipppf_mod
    import pcc_tpu_torch.models.pppe as pppe_mod
    import pcc_tpu_torch.models.pppf as pppf_mod

    calls = []

    def float_fps(xyz, npoint, starts):
        calls.append(("f32", xyz.detach().clone(), npoint, starts.detach().clone()))
        return fps_batch(xyz, npoint, starts)

    def int_fps(xs, npoint, inf):
        calls.append(("i32", xs.clone(), npoint, inf))
        return fps_int_batch(xs, npoint, inf)

    saved = codec_mod.fps_batch, pppf_mod.fps_batch, pppe_mod.fps_batch, ipppf_mod.fps_int_batch
    codec_mod.fps_batch = pppf_mod.fps_batch = pppe_mod.fps_batch = float_fps
    ipppf_mod.fps_int_batch = int_fps
    try:
        yield calls
    finally:
        (codec_mod.fps_batch, pppf_mod.fps_batch, pppe_mod.fps_batch,
         ipppf_mod.fps_int_batch) = saved


@contextlib.contextmanager
def recording_chamfer(records: dict, key: str):
    """Record, under records[key], the chamfer's clouds and real cotangents
    of the train steps run while active (ChamferFn.backward swapped for a
    wrapper that records and goes on to the kernel)."""
    backward = ChamferFn.backward

    def recording(ctx, gx, gy):
        x, y, _, _ = ctx.saved_tensors
        records[key] = (x.detach(), y.detach(), gx.contiguous(), gy.contiguous())
        return backward(ctx, gx, gy)

    ChamferFn.backward = staticmethod(recording)
    try:
        yield
    finally:
        ChamferFn.backward = staticmethod(backward)


STAGE_OF_NPOINT = {512: "sa1", 128: "sa2", 32: "sa3"}   # the PN++ stages' FPS counts


def fps_label(call, clouds: int, cfg: CodecConfig) -> str:
    """Which FPS of a path a recorded call is: the skeleton, or a PN++
    stage of the encoder (per patch) or of the probability model (per
    cloud)."""
    kind, x, npoint, _ = call
    B, N, _ = x.shape
    if N == cfg.N and npoint == cfg.S:
        return "skeleton"
    who = "integer CPM" if kind == "i32" else "CPM" if B == clouds else "encoder"
    return f"{who} " + STAGE_OF_NPOINT.get(npoint, f"npoint {npoint}")


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms per call of fn, from CUDA events around replays of a CUDA
    graph of reps calls: the kernels alone, where CUDA events around
    back-to-back calls of a short kernel also count the wrapper's host
    time."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return cuda_ms(g.replay, 5) / reps


def fps_check(path: str, call) -> dict:
    """FPS kernel (fps for float32, fps_int for int32 points) vs its plain
    version on one recorded call's own inputs, bit for bit; CUDA-event ms
    of the wrapper, the kernel's device ms (graph_ms) and ns per step by
    it, the plain version's ms and the bound (9 operations per point and step:
    3 sub, 3 mul, 2 add, 1 min; float32 at 67 TFLOP/s, int32 at 33.5
    TOP/s)."""
    kind, x, npoint, arg = call
    x = x.contiguous()
    if kind == "f32":
        name, rate = "fps", FP32_FLOP_PER_S
        kern = lambda: fps_batch(x, npoint, arg)  # noqa: E731
        plain = lambda: fps_plain(x, npoint, arg)  # noqa: E731
    else:
        name, rate = "fps_int", INT32_OPS_PER_S
        kern = lambda: fps_int_batch(x, npoint, arg)  # noqa: E731
        plain = lambda: fps_int_plain(x, npoint, arg)  # noqa: E731
    a = kern()
    if not torch.equal(a, plain()):
        raise RuntimeError(f"{name} differs from its plain version at {path} "
                           f"{tuple(x.shape)} -> {npoint}")
    B, N, _ = x.shape
    bms, by = bound(9.0 * B * N * npoint, nbytes(x, a) + (4 * B if kind == "f32" else 0), rate)
    ms, device_ms = cuda_ms(kern, 20), graph_ms(kern)
    rec = dict(path=path, shape=[B, N, npoint], type=kind, plan=list(fps_ops.plan(B, N)),
               ms=ms, device_ms=device_ms, ns_per_step=device_ms * 1e6 / npoint,
               plain_ms=cuda_ms(plain, 1), bound_ms=bms, bound_by=by, max_abs_err=0.0)
    log(f"{name} at {path} [{B}, {N} -> {npoint}] (plan {rec['plan']}): {ms:.4f} ms, "
        f"device {rec['device_ms']:.4f} ms, {rec['ns_per_step']:.1f} ns per step (plain "
        f"{rec['plain_ms']:.3f} ms, bound {bms:.5f} ms by {by}), indices bit-equal to the "
        "plain version's")
    return rec


def fps_checks(path: str, calls, clouds: int, cfg: CodecConfig) -> list:
    return [fps_check(f"{path} {fps_label(c, clouds, cfg)}", c) for c in calls]


def replay_check(name: str, got: torch.Tensor, replay: torch.Tensor) -> int:
    """Hold a kernel's output to its replay in the kernels' arithmetic: raise
    where an entry differs by more than one ulp; return how many differ."""
    diff = (got - replay).abs()
    ulp = torch.nextafter(replay.abs(), torch.tensor(float("inf"), device=replay.device)) \
        - replay.abs()
    beyond = int((diff > ulp).sum())
    if beyond:
        raise RuntimeError(f"{name} differs from its replay in the kernels' arithmetic by more "
                           f"than one ulp in {beyond} entries (largest {float(diff.max())})")
    return int((diff > 0).sum())


def bound(flops: float, nbytes: float, rate: float = FP32_FLOP_PER_S):
    """(least ms, 'operations' or 'bytes') on this card for the work, its
    operations at `rate` a second."""
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def tc_bound(fp32: float, products: float, nbytes: float):
    """(least ms, 'operations' or 'bytes') for work that runs `fp32`
    operations on the CUDA cores and `products` as 3xTF32 products on the
    tensor cores (three TF32 products each)."""
    t_ops = fp32 / FP32_FLOP_PER_S + 3.0 * products / TF32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profile(label: str, fn, top: int = 8) -> dict:
    """Where the time of one call of `fn` goes: host wall time, the device
    time of all kernels (their sum over the wall time is the device's busy
    share) and the ops with the most device time, from torch.profiler.
    Returns dict(wall_ms, device_ms), device_ms None where not measured."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
    if busy_ms == 0.0:
        log(f"profile {label}: wall {wall_ms:.1f} ms, device time not measured "
            "(the profiler saw no kernel)")
        return dict(wall_ms=wall_ms, device_ms=None)
    log(f"profile {label}: wall {wall_ms:.1f} ms (profiler on), device kernels "
        f"{busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f}")
    rows = sorted(rows, key=lambda r: r.self_device_time_total, reverse=True)[:top]
    for r in rows:
        log(f"  {r.self_device_time_total / 1e3:9.3f} ms  x{r.count:<5d} {r.key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=busy_ms)


def step_times(card: Codec, clouds, streams) -> None:
    """Host wall time of each step of one encode and one decode batch, each
    ending in a device sync (profiler off)."""
    starts = np.zeros(len(clouds), np.int32)
    steps = []

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps.append((name, (time.perf_counter() - t0) * 1e3))
        return out

    res = step("encode: pack + upload + device encode", lambda: card.encode_batch(
        np.stack(clouds), starts))
    step("encode: fetch + host CDF rows, range coding, octree bits", lambda: card.serialize(res))
    parsed = step("decode: parse skeletons (host)", lambda: [
        (codes_to_points(*parse_octree_bits(unpack_bits(s))), np.frombuffer(c, np.float32))
        for _, s, c in streams])
    recs = np.stack([r for r, _ in parsed])
    headers = np.stack([h for _, h in parsed])
    syms = step("decode: device CPM weights + host range decoding", lambda: card.decode_symbols(
        recs, [p for p, _, _ in streams]))
    step("decode: device decoder + fetch + host reconstruction",
         lambda: card.decode_batch(syms, recs, headers))
    log("steps of one batch: " + "; ".join(f"{n} {ms:.1f} ms" for n, ms in steps))


def flat_grads(out) -> list:
    """(dpatches, dsa_wb, dpn_wb) -> [dpatches, dw1, db1, ..., dpb4]."""
    dp, dsa, dpn = out
    return [dp] + [t for wb in list(dsa) + list(dpn) for t in wb]


def winner_rows(patches, sa_wb, pn_wb, knn: int, chunk: int = 64) -> int:
    """Sum over patches of the distinct points that win a channel of the
    encoder's global max: the rows the backward has to propagate."""
    total = 0
    for s in range(0, patches.shape[0], chunk):
        p = patches[s:s + chunk]
        win = pointwise_plain(p, select_nearest(sq_dists(p, p), knn), sa_wb,
                              pn_wb).argmax(dim=1)              # [c, D]
        total += sum(len(torch.unique(r)) for r in win)
    return total


def encoder_flops(P: int, K: int, knn: int, d: int):
    """(forward FLOPs, multiply-adds per point of SetAbstraction and of
    PointNet) of the encoder on P patches of K points."""
    sa_mac = knn * (3 * 32 + 32 * 64 + 64 * 128)
    pn_mac = 131 * 128 + 128 * 256 + 256 * 512 + 512 * d
    # per patch: 9 operations per distance pair, 2 per multiply-add
    return P * (9.0 * K * K + 2.0 * K * (sa_mac + pn_mac)), sa_mac, pn_mac


def train_phase(dev, smi: str, chamfer_records: dict):
    """Phase 6: the train step at full width; returns the state, the step's
    patches and encoder cotangent (recorded from one more step) for phase 7,
    the counted steps' launches and their median wall in ms; the same
    step's chamfer clouds and cotangents go into chamfer_records for phase
    16."""
    cfg = CodecConfig()
    B = TRAIN_CLOUDS
    batch = torch.from_numpy(np.stack(synthetic_clouds(B, cfg.N, SEED))).to(dev)
    tx = make_optimizer(5e-4, 0.1, 60000, 80000)
    state = create_train_state(SEED, cfg, tx, device="cuda")
    step = build_train_step(cfg, tx, rate_mode="reference")
    gen = torch.Generator().manual_seed(SEED + 1)

    def starts():
        return torch.randint(0, cfg.N, (B,), generator=gen, dtype=torch.int32).to(dev)

    before = [p.detach().clone() for _, p in state.named_parameters()]
    step(state, batch, starts(), TRAIN_LAM)                    # warm-up, uncounted
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, aux = step(state, batch, starts(), TRAIN_LAM)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(aux["loss"])
    launches = dict(cuda_lib.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"train launches over {TRAIN_STEPS} steps: {launches}")
    want = {name: 0 for name in cuda_lib.KERNELS}
    want.update(fps=TRAIN_STEPS, patch_encoder=TRAIN_STEPS, patch_encoder_bwd=TRAIN_STEPS,
                chamfer_fwd=TRAIN_STEPS, chamfer_bwd=TRAIN_STEPS)
    if launches != want:
        raise RuntimeError(f"train launches {launches} != {want}")
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite train loss: {losses}")
    moved = sum(not torch.equal(a, p.detach()) for a, (_, p) in
                zip(before, state.named_parameters()))
    if moved == 0:
        raise RuntimeError("no parameter moved in training")
    ms = float(np.median(times)) * 1e3
    log(f"train: {B} clouds x {cfg.N} points per step; median step {ms:.2f} ms "
        f"(steps {min(times) * 1e3:.2f} to {max(times) * 1e3:.2f} ms), "
        f"{B * cfg.N / (ms / 1e3):.0f} points/s on {smi}; peak memory "
        f"{peak / 2**30:.2f} GiB; losses {losses[0]:.6f} -> {losses[-1]:.6f}; {moved} of "
        f"{len(before)} parameter tensors moved")
    profile("train step", lambda: step(state, batch, starts(), TRAIN_LAM), top=14)

    # one more step, recording the encoder's patches and real cotangent
    rec = {}
    backward = PatchEncoderFn.backward

    def recording(ctx, g):
        # the weights as this step's forward saw them (the optimizer then
        # updates them in place)
        patches, winners, *wb = ctx.saved_tensors
        rec.update(patches=patches, winners=winners, g=g.contiguous(),
                   wb=[t.detach().clone() for t in wb])
        return backward(ctx, g)

    PatchEncoderFn.backward = staticmethod(recording)
    with recording_chamfer(chamfer_records, f"N={cfg.N} IPDAE"):
        step(state, batch, starts(), TRAIN_LAM)
    PatchEncoderFn.backward = staticmethod(backward)
    return state, rec, launches, ms


def backward_kernel_check(rec: dict, launches: int) -> dict:
    """Phase 7: the backward kernel vs its plain version on the train
    step's own inputs (patches, the winners its forward handed over,
    cotangent); its record for the kernels line."""
    cfg = CodecConfig()
    knn = cfg.sa_knn
    patches, win, g = rec["patches"], rec["winners"], rec["g"]
    sa_wb, pn_wb = _unflatten(rec["wb"])
    with torch.no_grad():
        # the hand-over: the step's winners are the forward kernel's and the
        # plain version's, and the backward on them is the backward that
        # gets them itself, bit for bit
        lat, again_win = patch_encoder(patches, sa_wb, pn_wb, knn, return_winners=True)
        if not (torch.equal(again_win, win)
                and torch.equal(lat, patch_encoder(patches, sa_wb, pn_wb, knn))):
            raise RuntimeError("patch_encoder's winners output differs from the step's, or "
                               "changes its latents")
        plain_win = torch.cat([winners_plain(p, i, pointwise_plain(p, i, sa_wb, pn_wb), sa_wb,
                                             pn_wb)
                               for p in torch.split(patches, 64)
                               for i in [select_nearest(sq_dists(p, p), knn)]])
        n_win = int((plain_win != win.long()).sum())
        if n_win:
            raise RuntimeError(f"{n_win} of the forward kernel's winners differ from the "
                               "plain version's")
    a = flat_grads(patch_encoder_bwd(patches, g, sa_wb, pn_wb, knn, winners=win))
    if not all(torch.equal(x, y) for x, y in
               zip(a, flat_grads(patch_encoder_bwd(patches, g, sa_wb, pn_wb, knn)))):
        raise RuntimeError("patch_encoder_bwd on the forward's winners differs from "
                           "patch_encoder_bwd with winners=None")
    log(f"patch_encoder winners on {tuple(patches.shape)}: equal to the plain version's "
        f"({win.numel()} of {win.numel()}); the backward on them equals the backward with "
        "winners=None bit for bit")
    b = flat_grads(patch_encoder_bwd_plain(patches, g, sa_wb, pn_wb, knn))
    rel = []
    for x, y in zip(a, b):
        err, big = float((x - y).abs().max()), float(y.abs().max())
        if not err <= TOL_BWD * big:
            raise RuntimeError(f"patch_encoder_bwd differs from the plain version on "
                               f"{tuple(y.shape)}: {err} > {TOL_BWD} * {big}")
        rel.append(err / big if big else 0.0)
    again = flat_grads(patch_encoder_bwd(patches, g, sa_wb, pn_wb, knn, winners=win))
    if not all(torch.equal(x, y) for x, y in zip(a, again)):
        raise RuntimeError("two launches of patch_encoder_bwd differ")
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    log(f"patch_encoder_bwd on {tuple(patches.shape)}: max |kernel - plain| / "
        f"max |plain| per output {max(rel):.3g} (limit {TOL_BWD}); two launches "
        "bitwise equal")
    P, K = patches.shape[:2]
    fwd, sa_mac, pn_mac = encoder_flops(P, K, knn, cfg.d)
    with torch.no_grad():
        rows = winner_rows(patches, sa_wb, pn_wb, knn)
    # the winning points' rows (the forward hands the winners over): their
    # forward, then two products (weight and input gradients) per layer:
    # over all knn slots in SetAbstraction layers 1-2, over each (point,
    # channel)'s one winning slot in layer 3
    flops = 2.0 * rows * (pn_mac + sa_mac) + 4.0 * rows * (pn_mac + sa_mac - (knn - 1) * 64 * 128)
    w_bytes = nbytes(*[t for wb in sa_wb + pn_wb for t in wb])
    bms, by = bound(flops, 2 * nbytes(patches) + nbytes(g, win) + 2 * w_bytes)
    log(f"patch_encoder_bwd work: {rows} winning rows ({rows / P:.2f} per patch) -> "
        f"{flops / 1e9:.2f} GFLOP (the forward over all points, {fwd / 1e9:.1f} GFLOP, is "
        "the forward kernel's)")
    fwd_ms = cuda_ms(lambda: patch_encoder(patches, sa_wb, pn_wb, knn), 5)
    fwd_win_ms = cuda_ms(lambda: patch_encoder(patches, sa_wb, pn_wb, knn, return_winners=True), 5)
    log(f"patch_encoder on {tuple(patches.shape)}: {fwd_ms:.4f} ms, with the winners output "
        f"{fwd_win_ms:.4f} ms")
    return dict(
        name="patch_encoder_bwd", route="cuda", source="pcc_tpu_torch/csrc/patch_encoder_bwd.cu",
        replaces="pcc_tpu/ops/sa_pallas.py:288", launches=launches, max_abs_err=err,
        ms=cuda_ms(lambda: patch_encoder_bwd(patches, g, sa_wb, pn_wb, knn, winners=win), 5),
        plain_ms=cuda_ms(lambda: patch_encoder_bwd_plain(patches, g, sa_wb, pn_wb, knn,
                                                         winners=win), 2),
        bound_ms=bms, bound_by=by, library_ms=None, forward_ms=fwd_ms,
        forward_winners_ms=fwd_win_ms)


def train_card_vs_cpu(dev) -> None:
    """Phase 8: one train step at TINY on the card and on the CPU port."""
    cfg = CodecConfig(**TINY)
    tx = make_optimizer(1e-3, 0.1, 10, 10)
    card = create_train_state(SEED, cfg, tx, device="cuda")
    cpu = create_train_state(SEED, cfg, tx, device="cpu")
    batch = torch.from_numpy(np.stack(synthetic_clouds(2, cfg.N, SEED)))
    starts = torch.tensor([0, 77], dtype=torch.int32)
    step = build_train_step(cfg, tx, rate_mode="reference")
    before = dict(cuda_lib.launches)
    _, a = step(card, batch.to(dev), starts.to(dev), 1e-2)
    torch.cuda.synchronize()
    chamfer_launched(before, "TINY train step")
    _, b = step(cpu, batch, starts, 1e-2)
    la, lb = float(a["loss"]), float(b["loss"])
    if not abs(la - lb) <= 1e-5 * abs(lb):
        raise RuntimeError(f"TINY train step loss: card {la} vs CPU {lb}")
    # the step leaves its gradients in .grad: each within 1e-5 of the CPU
    # port's largest entry, so a scaled gradient fails here and not only
    # in the kernel-vs-plain phase (Adam's first update is about +-lr)
    rel = 0.0
    for (name, p), (_, q) in zip(card.named_parameters(), cpu.named_parameters()):
        err, big = float((p.grad.cpu() - q.grad).abs().max()), float(q.grad.abs().max())
        if not err <= 1e-5 * big:
            raise RuntimeError(f"TINY train step gradient of {name}: card and CPU differ "
                               f"by {err} > 1e-5 * {big}")
        rel = max(rel, err / big if big else 0.0)
    worst = max(float((p.detach().cpu() - q.detach()).abs().max()) for (_, p), (_, q)
                in zip(card.named_parameters(), cpu.named_parameters()))
    if not worst <= 1e-5:
        raise RuntimeError(f"TINY train step parameters differ by {worst}")
    log(f"train step at TINY, card vs CPU port: loss {la:.8f} vs {lb:.8f}, "
        f"gradients within {rel:.3g} of each tensor's largest entry, parameters "
        f"within {worst:.3g}")


def chamfer_launched(before: dict, label: str) -> None:
    """Raise unless the chamfer forward and backward kernels each ran once
    since the launch counts `before`."""
    for name in ("chamfer_fwd", "chamfer_bwd"):
        if cuda_lib.launches[name] != before[name] + 1:
            raise RuntimeError(f"{label}: {name} launched "
                               f"{cuda_lib.launches[name] - before[name]} times, not once")


def skeletons(streams) -> np.ndarray:
    """The decoded skeletons [B, S, 3] of a list of (p, s, c) streams."""
    return np.stack([codes_to_points(*parse_octree_bits(unpack_bits(s)))
                     for _, s, _ in streams])


def randomize_batchnorm(state: dict, seed: int) -> dict:
    """A copy of a state_dict with non-trivial BatchNorm entries from a torch
    seed: running means around 0, variances in [0.5, 1.5], scales in
    [0.5, 1.5] with about a quarter negative, small biases."""
    g = torch.Generator().manual_seed(seed)
    out = dict(state)
    for key in state:
        if not key.endswith(".running_mean"):
            continue
        stem = key[:-len("running_mean")]
        n = state[key].shape[0]
        out[key] = torch.randn(n, generator=g) * 0.1
        out[stem + "running_var"] = torch.rand(n, generator=g) + 0.5
        sign = torch.where(torch.rand(n, generator=g) < 0.25, -1.0, 1.0)
        out[stem + "weight"] = (torch.rand(n, generator=g) + 0.5) * sign
        out[stem + "bias"] = (torch.rand(n, generator=g) - 0.3) * 0.2
    return out


def pppf_test_weights(state: dict, seed: int) -> dict:
    """randomize_batchnorm, and the FoldingNet's last layer scaled up 30
    times: at random weights a patch's decoded points crowd together, and
    the chamfer's nearest neighbours then near-tie among them, so that two
    float32 orders of summation route its gradients differently."""
    out = randomize_batchnorm(state, seed)
    for key in ("decoder.mlp2.4.weight", "decoder.mlp2.4.bias"):
        out[key] = state[key] * 30.0
    return out


def pppf_phase(dev, smi: str, clouds, fps_record: dict, keep: dict):
    """Phases 9-11: the PPPF-AE path, its stage kernel and the FPS kernels
    vs their plain versions, and the card vs the CPU port. Returns the
    records of the stage kernel and of fps_int for the kernels line; the
    float FPS shapes go into fps_record; the clouds, weights, streams and
    walls go into `keep` (phase 29's float32 run)."""
    cfg = CodecConfig(model="PPPF-AE")
    B = PPPF_CLOUDS
    clouds = clouds[:B]
    ae_state, prob_state = init_params(SEED, cfg)
    ae_state = randomize_batchnorm(ae_state, SEED + 2)
    prob_state = randomize_batchnorm(prob_state, SEED + 3)
    t0 = time.perf_counter()
    card = Codec(cfg, ae_state, prob_state, batch_size=B, device="cuda")
    log(f"PPPF-AE codec built in {time.perf_counter() - t0:.1f} s (the integer "
        "probability model's conversion runs on the host)")

    # 9. the path, through the entry points a user calls
    card.decompress_many(card.compress_many(clouds))          # warm-up, uncounted
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    streams = card.compress_many(clouds)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = card.decompress_many(streams)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    log(f"PPPF-AE path: {B} clouds x {cfg.N} points; encode {B / t_enc:.2f} clouds/s "
        f"({t_enc * 1e3:.1f} ms), decode {B / t_dec:.2f} clouds/s ({t_dec * 1e3:.1f} ms) "
        f"on {smi}")
    keep.update(clouds=clouds, ae_state=ae_state, prob_state=prob_state)
    log(f"launches on the PPPF-AE path: {launches}")
    want = {name: 0 for name in cuda_lib.KERNELS}
    # FPS: the skeleton, sa2, sa3; fps_int: the integer CPM's three stages,
    # once in the encode and once in the decode
    want.update(pppf_sa_stage=3, fps=3, fps_int=6)
    if launches != want:
        raise RuntimeError(f"PPPF-AE path launches {launches} != {want}")
    bpp = [8 * (len(p) + len(s) + len(c)) / cfg.N for p, s, c in streams]
    log(f"PPPF-AE mean bits per input point {np.mean(bpp):.4f}")
    for pc in decoded:
        if pc.shape != (cfg.S * cfg.d * cfg.d, 3) or not np.isfinite(pc).all():
            raise RuntimeError(f"bad decoded PPPF-AE cloud: shape {pc.shape}")
    starts = np.zeros(B, np.int32)
    recs = skeletons(streams)
    with torch.inference_mode():
        step_times(card, clouds, streams)
        profile("PPPF-AE encode", lambda: card.compress_many(clouds), top=12)
        profile("PPPF-AE decode", lambda: card.decompress_many(streams), top=12)
        with recording_fps() as fps_calls:
            enc = card.encode_batch(np.stack(clouds), starts)
        sym = enc.sym.cpu().numpy()
        if not np.array_equal(card.decode_symbols(recs, [p for p, _, _ in streams]), sym):
            raise RuntimeError("PPPF-AE: decoded symbols differ from the encoded symbols")
        log("PPPF-AE: decoded symbols equal encoded symbols for all clouds")

        # 10. the stage kernel vs its plain version, on the path's inputs
        packed = pack_encode_upload(np.stack(clouds), starts)
        pcs, st = unpack_encode_upload(torch.from_numpy(packed.view(np.int32)).to(dev), cfg.N)
        xyz, feat = encode_geometry(pcs, st, cfg).patches, None
        fps_recs = fps_checks("PPPF-AE serving", fps_calls, B, cfg)
        stages, cases = [], []
        for name in ("sa1", "sa2", "sa3"):
            sa = getattr(card.ae.encoder, name)
            new_xyz = sa.queries(xyz).contiguous()
            cases.append((name, "pppf", new_xyz, xyz, feat, sa))
            if name == "sa2":
                cases.append((name, "pppe", new_xyz, xyz, feat, sa))
            feat = pppf_sa_fused(new_xyz, xyz, feat, sa.layers(), nsample=sa.nsample,
                                 radius=sa.radius)
            xyz = new_xyz
        for name, layout, new_xyz, xyz, feat, sa in cases:
            layers = sa.layers()
            kw = dict(nsample=sa.nsample, radius=sa.radius, layout=layout)
            a = pppf_sa_fused(new_xyz, xyz, feat, layers, **kw)
            b = pppf_sa_plain(new_xyz, xyz, feat, layers, **kw)
            err, big = float((a - b).abs().max()), float(b.abs().max())
            if not err <= TOL * big:
                raise RuntimeError(f"pppf_sa_stage {name} ({layout}) differs from the plain "
                                   f"version: {err} > {TOL} * {big}")
            differ = None
            if layout == "pppf":
                # the per-point kernel bit for bit against the stack replayed
                # on the points and each query's max over its ball_query set
                sl = slice(0, REPLAY_PATCHES)
                rep = pppf_sa_points(new_xyz[sl], xyz[sl], None if feat is None else feat[sl],
                                     layers, nsample=sa.nsample, radius=sa.radius, replay=True)
                differ = replay_check(f"pppf_sa_stage {name}", a[sl], rep)
                del rep
            P, S, _ = new_xyz.shape
            widths = [layers[0][0].shape[0]] + [lay[0].shape[1] for lay in layers]
            flops = stage_flops(P, S, xyz.shape[1], sa.nsample, widths, layout)
            ins = [new_xyz] + ([xyz] if new_xyz is not xyz else []) \
                + ([] if feat is None else [feat]) + [t for lay in layers for t in lay]
            bms, by = bound(flops, nbytes(*ins, a))
            rec = dict(stage=name, layout=layout, shape=[P, S, xyz.shape[1], widths],
                       nsample=sa.nsample, max_abs_err=err, max_abs=big, replay_differ=differ,
                       ms=cuda_ms(lambda: pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), 10),
                       plain_ms=cuda_ms(lambda: pppf_sa_plain(new_xyz, xyz, feat, layers, **kw), 1),
                       bound_ms=bms, bound_by=by, gflop=flops / 1e9)
            log(f"pppf_sa_stage {name} ({layout}) new_xyz {tuple(new_xyz.shape)} xyz "
                f"{tuple(xyz.shape)} widths {widths} nsample {sa.nsample}: {rec['ms']:.3f} ms "
                f"(plain {rec['plain_ms']:.1f} ms, bound {bms:.3f} ms by {by}, "
                f"{flops / 1e9:.1f} GFLOP, {flops / rec['ms'] / 1e9:.2f} TFLOP/s), "
                f"max_abs_err {err:.3g} of {big:.3g}"
                + ("" if differ is None else f"; vs its replay on {REPLAY_PATCHES} patches "
                   f"{differ} entries differ (within one ulp)"))
            stages.append(rec)

        # 11. the same weights and one of the clouds on the CPU port
        t0 = time.perf_counter()
        cpu = Codec(cfg, ae_state, prob_state, batch_size=1, device="cpu")
        (_, s_cpu, c_cpu), = cpu.compress_many(clouds[:1])
        if streams[0][1] != s_cpu or streams[0][2] != c_cpu:
            raise RuntimeError("PPPF-AE: card .s.bin/.c.bin differ from the CPU port's")
        if not np.array_equal(cpu.decode_symbols(recs[:1], [streams[0][0]]), sym[:1]):
            raise RuntimeError("PPPF-AE: the CPU port decodes the card's .p.bin to other "
                               "symbols")
        rec1 = torch.from_numpy(recs[:1])
        w_card = integer_pmf_weights(card.bundle, rec1.to(dev), cfg).cpu()
        w_cpu = integer_pmf_weights(cpu.bundle, rec1, cfg)
        if tuple(w_cpu.shape) != (1, cfg.S, cfg.d, cfg.L) or not torch.equal(w_card, w_cpu):
            raise RuntimeError("PPPF-AE: integer coding weights differ between card and CPU")
        log(f"PPPF-AE cross-device ({time.perf_counter() - t0:.1f} s): .s.bin and .c.bin "
            "byte-equal, the card's .p.bin decodes on the CPU to the same symbols, integer "
            f"weights {tuple(w_cpu.shape)} bit-equal")

    fps_record["launches_pppf"] = launches["fps"]
    fps_record["shapes"] += [r for r in fps_recs if r["type"] == "f32"]
    ints = [r for r in fps_recs if r["type"] == "i32"]
    if len(ints) != 3:
        raise RuntimeError(f"the integer CPM ran {len(ints)} FPS calls per evaluation, not 3")
    path = [r for r in stages if r["layout"] == "pppf"]
    return dict(
        name="pppf_sa_stage", route="cuda", source="pcc_tpu_torch/csrc/pppf_sa_stage.cu",
        replaces="pcc_tpu/ops/pppf_sa_pallas.py:45", launches=launches["pppf_sa_stage"],
        max_abs_err=max(r["max_abs_err"] for r in stages),
        ms=sum(r["ms"] for r in path), plain_ms=sum(r["plain_ms"] for r in path),
        bound_ms=sum(r["bound_ms"] for r in path), bound_by=path[-1]["bound_by"],
        library_ms=None, stages=stages), dict(
        name="fps_int", route="cuda", source="pcc_tpu_torch/csrc/fps.cu",
        replaces="pcc_tpu/coding/iprob_pppf.py:103", launches=launches["fps_int"],
        max_abs_err=0.0, ms=sum(r["ms"] for r in ints),
        plain_ms=sum(r["plain_ms"] for r in ints), bound_ms=sum(r["bound_ms"] for r in ints),
        bound_by=max(ints, key=lambda r: r["bound_ms"])["bound_by"], library_ms=None,
        launches_per_evaluation=3, stages=ints)

def bn_stats(model) -> list:
    """Copies of a model's BatchNorm running statistics."""
    return [b.detach().clone() for n, b in model.named_buffers() if ".running_" in n]


def pppf_train_phase(dev, smi: str, chamfer_records: dict):
    """Phase 12: the PPPF-AE train path at full width, built as
    cli/train.py --model PPPF-AE builds it: the warm-up step (batch
    statistics, plain stages) and the fused step (the encoder's BatchNorm
    frozen: the stage kernel and its backward). Returns the state, both
    kinds' launch counts and, from one more fused step, each stage's
    inputs and real cotangent (sa1, sa2, sa3) and the step's FPS calls for
    phase 13; the chamfer clouds and cotangents of the uncounted warm-up
    step and of that fused step go into chamfer_records for phase 16."""
    cfg = CodecConfig(model="PPPF-AE")
    tx = make_optimizer(5e-4, 0.1, 60000, 80000)
    state = create_train_state(SEED, cfg, tx, device="cuda")
    state.ae.load_state_dict(randomize_batchnorm(state.ae.state_dict(), SEED + 2))
    state.prob.load_state_dict(randomize_batchnorm(state.prob.state_dict(), SEED + 3))
    clouds = np.stack(synthetic_clouds(PPPF_TRAIN_CLOUDS, cfg.N, SEED + 4))
    gen = torch.Generator().manual_seed(SEED + 5)

    def starts(B):
        return torch.randint(0, cfg.N, (B,), generator=gen, dtype=torch.int32).to(dev)

    kind_launches = {}
    for kind, fused, B, steps in (("warm-up", False, PPPF_WARMUP_CLOUDS, PPPF_WARMUP_STEPS),
                                  ("fused", True, PPPF_TRAIN_CLOUDS, PPPF_FUSED_STEPS)):
        step = build_pppf_train_step(cfg, tx, rate_mode="reference", fused=fused)
        batch = torch.from_numpy(clouds[:B]).to(dev)
        if fused:
            step(state, batch, starts(B), TRAIN_LAM)             # warm-up, uncounted
        else:
            with recording_chamfer(chamfer_records, f"N={cfg.N} PPPF-AE warm-up"):
                step(state, batch, starts(B), TRAIN_LAM)         # warm-up, uncounted
        torch.cuda.synchronize()
        before = [p.detach().clone() for _, p in state.named_parameters()]
        enc_stats, prob_stats = bn_stats(state.ae.encoder), bn_stats(state.prob)
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        times, losses = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, aux = step(state, batch, starts(B), TRAIN_LAM)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(aux["loss"])
        launches = dict(cuda_lib.launches)
        peak = torch.cuda.max_memory_allocated()
        log(f"PPPF-AE {kind} launches over {steps} steps: {launches}")
        # FPS: the skeleton, the encoder's sa2 and sa3, the CPM's three stages
        want = {name: 0 for name in cuda_lib.KERNELS}
        want.update(fps=6 * steps, chamfer_fwd=steps, chamfer_bwd=steps)
        if fused:
            want.update(pppf_sa_stage=3 * steps, pppf_sa_stage_bwd=3 * steps)
        kind_launches[kind] = launches
        if launches != want:
            raise RuntimeError(f"PPPF-AE {kind} launches {launches} != {want}")
        losses = torch.stack(losses).cpu().numpy()
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite PPPF-AE {kind} loss: {losses}")
        moved = sum(not torch.equal(a, p.detach()) for a, (_, p) in
                    zip(before, state.named_parameters()))
        if moved == 0:
            raise RuntimeError(f"no parameter moved in the PPPF-AE {kind} steps")
        enc_same = all(torch.equal(a, b) for a, b in zip(enc_stats, bn_stats(state.ae.encoder)))
        if enc_same != fused:
            raise RuntimeError(f"PPPF-AE {kind} steps: the encoder's running statistics "
                               f"{'stayed' if enc_same else 'moved'}")
        if any(torch.equal(a, b) for a, b in zip(prob_stats, bn_stats(state.prob))):
            raise RuntimeError(f"PPPF-AE {kind} steps left a running statistic of the "
                               "probability model unchanged")
        ms = float(np.median(times)) * 1e3
        log(f"PPPF-AE {kind} step: {B} clouds x {cfg.N} points per step; median step "
            f"{ms:.2f} ms (steps {min(times) * 1e3:.2f} to {max(times) * 1e3:.2f} ms), "
            f"{B * cfg.N / (ms / 1e3):.0f} points/s on {smi}; peak memory "
            f"{peak / 2**30:.2f} GiB (batch {B}); losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
            f"{moved} of {len(before)} parameter tensors moved; encoder statistics "
            f"{'unchanged' if enc_same else 'updated'}, the CPM's updated")
    profile("PPPF-AE fused train step", lambda: step(state, batch, starts(B), TRAIN_LAM),
            top=16)

    # one more fused step, recording each stage's inputs and cotangent
    rec = []
    backward = PPPFStageFn.backward

    def recording(ctx, gout):
        new_xyz, xyz, feat, *rest = ctx.saved_tensors
        flat = rest[:ctx.n_flat]
        layers = [tuple(t.detach() for t in flat[i:i + 5]) for i in range(0, len(flat), 5)]
        rec.append((new_xyz, xyz, feat, layers, gout.contiguous(), ctx.nsample, ctx.radius))
        return backward(ctx, gout)

    PPPFStageFn.backward = staticmethod(recording)
    with recording_fps() as fps_calls, recording_chamfer(chamfer_records,
                                                         f"N={cfg.N} PPPF-AE fused"):
        step(state, batch, starts(B), TRAIN_LAM)
    PPPFStageFn.backward = staticmethod(backward)
    return state, kind_launches, rec[::-1], fps_calls


def pppf_bwd_kernel_check(records, launches: dict) -> dict:
    """Phase 13: the stage backward kernel vs its plain version on the fused
    step's own stage inputs and cotangents; its record for the kernels
    line."""
    stages = []
    for name, (new_xyz, xyz, feat, layers, gout, nsample, radius) in zip(
            ("sa1", "sa2", "sa3"), records):
        kw = dict(nsample=nsample, radius=radius)

        def flat(out):
            dxyz, dfeat, dl = out
            return [dxyz] + ([] if dfeat is None else [dfeat]) + [t for lay in dl for t in lay]

        a = flat(pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, **kw))
        b = flat(pppf_sa_bwd_plain(new_xyz, xyz, feat, gout, layers, **kw))
        rel = []
        for x, y in zip(a, b):
            err, big = float((x - y).abs().max()), float(y.abs().max())
            log(f"  pppf_sa_stage_bwd {name} output {tuple(y.shape)}: max |kernel - plain| "
                f"{err:.3g}, max |plain| {big:.3g}")
            if not err <= TOL_BWD * big:
                raise RuntimeError(f"pppf_sa_stage_bwd {name} differs from the plain version "
                                   f"on {tuple(y.shape)}: {err} > {TOL_BWD} * {big}")
            rel.append(err / big if big else 0.0)
        again = flat(pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, **kw))
        if not all(torch.equal(x, y) for x, y in zip(a, again)):
            raise RuntimeError(f"two launches of pppf_sa_stage_bwd differ at {name}")
        # the store mode: the forward's output bit for bit, and the backward
        # on what it stored bit for bit the backward that replays
        out, saved = pppf_sa_fused(new_xyz, xyz, feat, layers, save=True, **kw)
        if saved is None or not torch.equal(out, pppf_sa_fused(new_xyz, xyz, feat, layers,
                                                               **kw)):
            raise RuntimeError(f"pppf_sa_stage's store mode at {name}: nothing stored, or "
                               "another output")
        if not all(torch.equal(x, y) for x, y in
                   zip(a, flat(pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, saved=saved,
                                           **kw)))):
            raise RuntimeError(f"pppf_sa_stage_bwd on the stored activations differs from "
                               f"the replaying one at {name}")
        P, S, _ = new_xyz.shape
        N = xyz.shape[1]
        widths = [layers[0][0].shape[0]] + [lay[0].shape[1] for lay in layers]
        flops = stage_bwd_flops(P, S, N, nsample, widths)
        fp32, products = stage_bwd_work(P, S, N, nsample, widths, replay=False)
        ins = [new_xyz] + ([xyz] if xyz.data_ptr() != new_xyz.data_ptr() else []) \
            + ([] if feat is None else [feat]) + [gout] \
            + [t for lay in layers for t in (lay[0], lay[1], lay[3], lay[4])]
        # the bound as the train step's backward computes, on what the
        # forward stored: the routing and elementwise work in float32 on CUDA
        # cores, the dx and dW products as three TF32 products each on the
        # tensor cores; and the float32 bound (the selection and the replay
        # too, everything on CUDA cores) beside it
        bms, by = tc_bound(fp32, products, nbytes(*ins, *a))
        bms32, _ = bound(flops, nbytes(*ins, *a))
        r = dict(stage=name, shape=[P, S, N, widths], nsample=nsample,
                 max_abs_err=max(float((x - y).abs().max()) for x, y in zip(a, b)),
                 max_rel_err=max(rel),
                 ms=cuda_ms(lambda: pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, saved=saved,
                                                **kw), 3),
                 replay_ms=cuda_ms(lambda: pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, **kw),
                                   3),
                 fwd_ms=cuda_ms(lambda: pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), 3),
                 fwd_save_ms=cuda_ms(lambda: pppf_sa_fused(new_xyz, xyz, feat, layers, save=True,
                                                           **kw), 3),
                 plain_ms=cuda_ms(lambda: pppf_sa_bwd_plain(new_xyz, xyz, feat, gout, layers,
                                                            **kw), 1),
                 bound_ms=bms, bound_by=by, bound_fp32_ms=bms32, gflop=flops / 1e9)
        log(f"pppf_sa_stage_bwd {name} new_xyz {tuple(new_xyz.shape)} xyz {tuple(xyz.shape)} "
            f"widths {widths} nsample {nsample}: {r['ms']:.3f} ms on the stored activations, "
            f"{r['replay_ms']:.3f} ms replaying them (plain {r['plain_ms']:.1f} ms; bound "
            f"{bms:.3f} ms by {by} with the products on the tensor cores, {bms32:.3f} ms with "
            f"the replay, all in float32); max |kernel - plain| / max |plain| per output "
            f"{max(rel):.3g} (limit {TOL_BWD}); two launches bitwise equal, and equal to the "
            f"backward on the stored activations; the stage forward {r['fwd_ms']:.3f} ms, "
            f"{r['fwd_save_ms']:.3f} ms in store mode")
        profile(f"pppf_sa_stage_bwd {name} (one call on the stored activations: each "
                "launch's device time)",
                lambda: pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, saved=saved, **kw),
                top=12)
        profile(f"pppf_sa_stage_bwd {name} (one call replaying the stack)",
                lambda: pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, **kw), top=12)
        del saved
        stages.append(r)
    return dict(
        name="pppf_sa_stage_bwd", route="cuda",
        source="pcc_tpu_torch/csrc/pppf_sa_stage_bwd.cu",
        replaces="pcc_tpu/ops/pppf_sa_pallas.py:258", launches=launches["pppf_sa_stage_bwd"],
        max_abs_err=max(r["max_abs_err"] for r in stages), ms=sum(r["ms"] for r in stages),
        plain_ms=sum(r["plain_ms"] for r in stages),
        bound_ms=sum(r["bound_ms"] for r in stages), bound_by=stages[-1]["bound_by"],
        bound_fp32_ms=sum(r["bound_fp32_ms"] for r in stages),
        replay_ms=sum(r["replay_ms"] for r in stages),
        fwd_ms=sum(r["fwd_ms"] for r in stages), fwd_save_ms=sum(r["fwd_save_ms"] for r in stages),
        library_ms=None, launches_per_fused_step=3, stages=stages)


def compare_train_states(label: str, la: float, lb: float, models, stats, batch_stats,
                         lr: float, stats_tol: float = TOL_BATCH_STATS) -> str:
    """Hold the models of a train state after a step on the card against
    the same step's on the CPU port. `models`: (name prefix, card model, CPU
    model) triples; `stats`: (the card's running statistics, the CPU's), two
    lists of tensors. Loss to 1e-5 relative; each gradient within
    TOL_PPPF_STEP of its tensor's largest entry on the CPU, or within
    stats_tol for the parameters named by the prefixes `batch_stats`
    (those whose gradient runs through batch statistics in this step); the
    updated parameters to lr / 4 where their gradient is above ZERO_GRAD of
    its tensor's largest entry and twice the two gradients' difference
    (Adam's first update is lr * g / (|g| + eps): an entry whose sign the
    rounding decides steps either way, and one near eps by up to lr / 8);
    the running statistics to stats_tol relative. A
    tensor whose largest gradient entry is below ZERO_GRAD of its model's
    largest is a zero gradient in exact arithmetic (the biases of
    convolutions that feed batch statistics), left as rounding noise: it is
    held within ZERO_GRAD of the model's largest entry instead, its
    parameters not at all. A parameter with no gradient on the CPU (a
    submodule outside the loss) must have none on the card. Returns a
    summary; raises on a failed check."""
    if not abs(la - lb) <= 1e-5 * abs(lb):
        raise RuntimeError(f"{label} loss: card {la} vs CPU {lb}")
    rel, rel_bs, worst, noise = 0.0, 0.0, 0.0, 0
    for prefix, model_a, model_b in models:
        top = max(float(q.grad.abs().max()) for q in model_b.parameters() if q.grad is not None)
        for (name, p), q in zip(model_a.named_parameters(), model_b.parameters()):
            name = prefix + name
            if q.grad is None:
                if p.grad is not None:
                    raise RuntimeError(f"{label}: {name} has a gradient on the card only")
                continue
            err, big = float((p.grad.cpu() - q.grad).abs().max()), float(q.grad.abs().max())
            if big < ZERO_GRAD * top:
                noise += 1
                if not err <= ZERO_GRAD * top:
                    raise RuntimeError(f"{label} gradient of {name} (zero in exact arithmetic): "
                                       f"card and CPU differ by {err} > {ZERO_GRAD} * {top}")
                continue
            through_stats = name.startswith(batch_stats)
            tol = stats_tol if through_stats else TOL_PPPF_STEP
            if not err <= tol * big:
                raise RuntimeError(f"{label} gradient of {name}: card and CPU differ by {err} > "
                                   f"{tol} * {big}")
            if through_stats:
                rel_bs = max(rel_bs, err / big)
            else:
                rel = max(rel, err / big)
            diff = (p.grad.cpu() - q.grad).abs()
            sure = (q.grad.abs() > ZERO_GRAD * big) & (q.grad.abs() > 2 * diff)
            moved = float((p.detach().cpu() - q.detach())[sure].abs().max())
            # Adam's first update lr * g / (|g| + eps) changes by at most
            # lr / 8 where |g| > 2 |dg|, all of it where |g| is near eps
            if not moved <= lr / 4:
                raise RuntimeError(f"{label} parameters of {name} differ by {moved}")
            worst = max(worst, moved)
    run = max(float(((x.cpu() - y).abs() / y.abs().clamp_min(1e-6)).max())
              for x, y in zip(*stats))
    if not run <= stats_tol:
        raise RuntimeError(f"{label} running statistics differ by {run} (relative)")
    return (f"loss {la:.8f} vs {lb:.8f}; gradients within {rel:.3g} of each tensor's largest "
            f"entry, {rel_bs:.3g} through batch statistics ({', '.join(batch_stats)}), "
            f"{noise} zero gradients within {ZERO_GRAD} of their model's largest; parameters "
            f"within {worst:.3g}; running statistics within {run:.3g} (relative)")


def pppf_train_card_vs_cpu(dev) -> None:
    """Phase 14: a warm-up step and a fused step at TINY_PPPF, each from the
    same fresh weights and FPS starts on the card and on the CPU port, held
    by compare_train_states."""
    cfg = CodecConfig(**TINY_PPPF)
    tx = make_optimizer(1e-3, 0.1, 10, 10)
    batch = torch.from_numpy(np.stack(synthetic_clouds(2, cfg.N, SEED)))
    starts = torch.tensor([0, 37], dtype=torch.int32)
    for kind, fused in (("warm-up", False), ("fused", True)):
        states = [create_train_state(SEED, cfg, tx, device=d) for d in ("cuda", "cpu")]
        for st in states:
            st.ae.load_state_dict(pppf_test_weights(st.ae.state_dict(), SEED + 6))
            st.prob.load_state_dict(randomize_batchnorm(st.prob.state_dict(), SEED + 7))
        step = build_pppf_train_step(cfg, tx, rate_mode="fixed", fused=fused)
        before = dict(cuda_lib.launches)
        _, a = step(states[0], batch.to(dev), starts.to(dev), 1e-2)
        torch.cuda.synchronize()
        chamfer_launched(before, f"TINY PPPF-AE {kind} step")
        _, b = step(states[1], batch, starts, 1e-2)
        # the parameters whose gradient runs through batch statistics
        batch_stats = ("prob.",) if fused else ("prob.", "ae.encoder.", "ae.enc_proj.")
        sa, sb = states
        summary = compare_train_states(
            f"TINY PPPF-AE {kind} step", float(a["loss"]), float(b["loss"]),
            (("ae.", sa.ae, sb.ae), ("prob.", sa.prob, sb.prob)),
            (bn_stats(sa.ae) + bn_stats(sa.prob), bn_stats(sb.ae) + bn_stats(sb.prob)),
            batch_stats, sb.optimizer.param_groups[0]["lr"])
        log(f"PPPF-AE {kind} step at TINY, card vs CPU port: {summary}")


def small_train_phase(dev, smi, chamfer_records: dict):
    """Phase 15: the small-cloud train path at full width, built as
    cli/train.py --N 512 builds it (and --model PPPF-AE --bn_warmup_steps W):
    seeded weights (PPPF-AE: and BatchNorm statistics), synthetic 512-point
    clouds. Per step kind one uncounted step, then SMALL_STEPS counted steps
    with every launch counter set to 0 just before and read just after.
    Returns each step kind's launches and the fused PPPF-AE step's FPS
    calls; the chamfer's inputs and real cotangents, from one more step of
    the IPDAE and of the fused PPPF-AE kind, go into chamfer_records for
    phase 16."""
    tx = make_optimizer(5e-4, 0.1, 60000, 80000)
    gen = torch.Generator().manual_seed(SEED + 8)
    kind_launches = {}
    state = None
    for family, kind, B in (("IPDAE", None, SMALL_CLOUDS),
                            ("PPPF-AE", "warm-up", SMALL_WARMUP_CLOUDS),
                            ("PPPF-AE", "fused", SMALL_CLOUDS)):
        cfg = CodecConfig(N=SMALL_N, model="AE" if family == "IPDAE" else "PPPF-AE")
        label = family if kind is None else f"{family} {kind}"
        if kind != "fused":
            state = create_train_state(SEED, cfg, tx, device="cuda")
            if family == "PPPF-AE":
                state.ae.load_state_dict(randomize_batchnorm(state.ae.state_dict(), SEED + 2))
                state.prob.load_state_dict(randomize_batchnorm(state.prob.state_dict(),
                                                               SEED + 3))
        if family == "IPDAE":
            step = build_train_step(cfg, tx, rate_mode="reference")
        else:
            step = build_pppf_train_step(cfg, tx, rate_mode="reference", fused=kind == "fused")
        batch = torch.from_numpy(np.stack(synthetic_clouds(B, cfg.N, SEED + 9))).to(dev)

        def starts():
            return torch.randint(0, cfg.N, (B,), generator=gen, dtype=torch.int32).to(dev)

        step(state, batch, starts(), TRAIN_LAM)                    # warm-up, uncounted
        torch.cuda.synchronize()
        before = [p.detach().clone() for _, p in state.named_parameters()]
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        times, losses = [], []
        for _ in range(SMALL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, aux = step(state, batch, starts(), TRAIN_LAM)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(aux["loss"])
        launches = dict(cuda_lib.launches)
        peak = torch.cuda.max_memory_allocated()
        log(f"N={cfg.N} {label} launches over {SMALL_STEPS} steps: {launches}")
        n = SMALL_STEPS
        want = {name: 0 for name in cuda_lib.KERNELS}
        want.update(chamfer_fwd=n, chamfer_bwd=n)
        if family == "IPDAE":
            want.update(fps=n, patch_encoder=n, patch_encoder_bwd=n)
        else:
            want["fps"] = 6 * n
            if kind == "fused":
                want.update(pppf_sa_stage=3 * n, pppf_sa_stage_bwd=3 * n)
        if launches != want:
            raise RuntimeError(f"N={cfg.N} {label} launches {launches} != {want}")
        kind_launches[f"N={cfg.N} {label}"] = launches
        losses = torch.stack(losses).cpu().numpy()
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite N={cfg.N} {label} loss: {losses}")
        moved = sum(not torch.equal(a, p.detach()) for a, (_, p) in
                    zip(before, state.named_parameters()))
        if moved == 0:
            raise RuntimeError(f"no parameter moved in the N={cfg.N} {label} steps")
        ms = float(np.median(times)) * 1e3
        log(f"N={cfg.N} {label} step: {B} clouds x {cfg.N} points ({B * cfg.S} patches); "
            f"median step {ms:.2f} ms (steps {min(times) * 1e3:.2f} to "
            f"{max(times) * 1e3:.2f} ms), {B * cfg.N / (ms / 1e3):.0f} points/s on {smi}; "
            f"peak memory {peak / 2**30:.2f} GiB; losses {losses[0]:.6f} -> "
            f"{losses[-1]:.6f}; {moved} of {len(before)} parameter tensors moved")
        if kind != "warm-up":
            profile(f"N={cfg.N} {label} train step",
                    lambda: step(state, batch, starts(), TRAIN_LAM), top=14)
        if kind == "warm-up":
            continue
        # one more step, recording the chamfer's clouds and real cotangents
        with recording_fps() as calls, recording_chamfer(chamfer_records, f"N={cfg.N} {label}"):
            step(state, batch, starts(), TRAIN_LAM)
        if family == "PPPF-AE":
            fps_calls = calls
    return kind_launches, fps_calls


CHAMFER_PATHS = ("N=512 IPDAE", "N=512 PPPF-AE fused", "N=8192 IPDAE", "N=8192 PPPF-AE fused",
                 "N=8192 PPPF-AE warm-up")


def chamfer_path_check(dev, label: str, record, counted: dict, gen) -> dict:
    """Phase 16's check of one path shape (also phases 21 and 24's): the
    chamfer kernels vs their plain versions on a step's recorded clouds
    with the loss's real cotangents and a random pair, indices bit-equal,
    distances within TOL and gradients within TOL_BWD of the plain
    version's largest entry, two backward launches bitwise equal; times
    and bounds. `counted` holds the path's counted launches."""
    x, y, gx_loss, gy_loss = record
    P, k, K = x.shape[0], x.shape[1], y.shape[1]
    a, b = chamfer_fwd(x, y), chamfer_fwd_plain(x, y)
    if not (torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])):
        raise RuntimeError(f"chamfer_fwd indices differ from the plain version ({label})")
    fwd_err = 0.0
    for u, v in zip(a[:2], b[:2]):
        err, big = float((u - v).abs().max()), float(v.abs().max())
        if not err <= TOL * big:
            raise RuntimeError(f"chamfer_fwd distances differ from the plain version "
                               f"({label}): {err} > {TOL} * {big}")
        fwd_err = max(fwd_err, err)
    ixy, iyx = a[2], a[3]
    cotangents = (("loss", gx_loss, gy_loss),
                  ("random", torch.randn((P, k), generator=gen).to(dev),
                   torch.randn((P, K), generator=gen).to(dev)))
    bwd_err, rel = 0.0, 0.0
    for name, gx, gy in cotangents:
        u2 = chamfer_bwd(x, y, ixy, iyx, gx, gy)
        v2 = chamfer_bwd_plain(x, y, ixy, iyx, gx, gy)
        for u, v in zip(u2, v2):
            err, big = float((u - v).abs().max()), float(v.abs().max())
            if not err <= TOL_BWD * big:
                raise RuntimeError(f"chamfer_bwd differs from the plain version ({label}, "
                                   f"{name} cotangent): {err} > {TOL_BWD} * {big}")
            bwd_err, rel = max(bwd_err, err), max(rel, err / big if big else 0.0)
        again = chamfer_bwd(x, y, ixy, iyx, gx, gy)
        if not all(torch.equal(u, v) for u, v in zip(u2, again)):
            raise RuntimeError(f"two launches of chamfer_bwd differ ({label}, {name})")
    f_flops, f_bytes = fwd_work(P, k, K)
    b_flops, b_bytes = bwd_work(P, k, K)
    f_bms, f_by = bound(f_flops, f_bytes)
    b_bms, b_by = bound(b_flops, b_bytes)
    fwd = lambda: chamfer_fwd(x, y)  # noqa: E731
    bwd = lambda: chamfer_bwd(x, y, ixy, iyx, gx_loss, gy_loss)  # noqa: E731
    rec = dict(
        path=label, shape=[P, k, K], fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err,
        launches=counted["chamfer_fwd"], bwd_launches=counted["chamfer_bwd"],
        fwd_ms=cuda_ms(fwd, 20), fwd_device_ms=graph_ms(fwd),
        fwd_plain_ms=cuda_ms(lambda: chamfer_fwd_plain(x, y), 3),
        fwd_bound_ms=f_bms, fwd_bound_by=f_by, fwd_gflop=f_flops / 1e9,
        # 9 instructions a pair and direction, none contracted, at one
        # per lane and cycle: half the float32 peak, which counts FMAs
        fwd_instr_floor_ms=2 * f_flops / FP32_FLOP_PER_S * 1e3,
        bwd_ms=cuda_ms(bwd, 20), bwd_device_ms=graph_ms(bwd),
        bwd_plain_ms=cuda_ms(lambda: chamfer_bwd_plain(x, y, ixy, iyx, gx_loss, gy_loss), 3),
        bwd_bound_ms=b_bms, bwd_bound_by=b_by)
    log(f"chamfer {label} x {tuple(x.shape)} y {tuple(y.shape)}: forward "
        f"{rec['fwd_ms']:.4f} ms, device {rec['fwd_device_ms']:.4f} ms (plain "
        f"{rec['fwd_plain_ms']:.3f} ms, bound {f_bms:.4f} ms by {f_by}, instruction floor "
        f"{rec['fwd_instr_floor_ms']:.4f} ms, {f_flops / 1e9:.2f} GFLOP), indices "
        f"bit-equal, max_abs_err {fwd_err:.3g}; backward {rec['bwd_ms']:.4f} ms, device "
        f"{rec['bwd_device_ms']:.4f} ms (plain {rec['bwd_plain_ms']:.3f} ms, bound "
        f"{b_bms:.5f} ms by {b_by}), max |kernel - plain| / max |plain| {rel:.3g} (limit "
        f"{TOL_BWD}) on the loss's and a random cotangent, two launches bitwise equal; "
        f"{rec['launches']} launches each over the path's counted steps")
    return rec


def chamfer_kernel_check(dev, records: dict, launches: dict) -> list:
    """Phase 16: the chamfer kernels vs their plain versions on the train
    steps' own clouds (phases 6, 12 and 15), for every path shape, with
    the loss's real cotangents and a random pair; the kernels' records for
    the kernels line (the N = 512 IPDAE step's shape on top, every shape
    under `paths` with its launches over its phase's counted steps).
    `launches` holds each counted step kind's launch counts."""
    gen = torch.Generator().manual_seed(SEED + 10)
    paths = [chamfer_path_check(dev, label, records[label], launches[label], gen)
             for label in CHAMFER_PATHS]
    top = paths[0]
    common = dict(route="cuda", library_ms=None, paths=paths, launches_per_step=1)
    return [
        dict(name=name, source=f"pcc_tpu_torch/csrc/{name}.cu",
             replaces=f"pcc_tpu/ops/chamfer_pallas.py:{line}",
             launches=sum(v[name] for v in launches.values()),
             max_abs_err=max(r[f"{kind}_max_abs_err"] for r in paths), ms=top[f"{kind}_ms"],
             device_ms=top[f"{kind}_device_ms"], plain_ms=top[f"{kind}_plain_ms"],
             bound_ms=top[f"{kind}_bound_ms"], bound_by=top[f"{kind}_bound_by"], **common)
        for name, kind, line in (("chamfer_fwd", "fwd", 47), ("chamfer_bwd", "bwd", 72))]


def sa_fused_phase(dev, patches, sa: SetAbstraction) -> dict:
    """Phase 17: the SetAbstraction kernel vs its plain version on the IPDAE
    serving path's own patches (phase 4) with the serving model's weights,
    then SetAbstraction(fused=True) on the card with every launch counter
    set to 0 just before and read just after; the kernel's record."""
    knn, sa_wb = sa.knn, sa.layers()
    a, b = sa_fused(patches, sa_wb, knn), sa_fused_plain(patches, sa_wb, knn)
    err, big = float((a - b).abs().max()), float(b.abs().max())
    if not err <= TOL * big:
        raise RuntimeError(f"sa_fused differs from the plain version: {err} > {TOL} * {big}")
    if not torch.equal(sa_fused(patches, sa_wb, knn), a):
        raise RuntimeError("two launches of sa_fused differ")
    P, N = patches.shape[:2]
    sa_mac = 3 * 32 + 32 * 64 + 64 * 128
    # 9 operations per distance pair, 2 per multiply-add of the MLP per slot;
    # layers 2 and 3 run as 3xTF32 products on the tensor cores, the rest in
    # float32 on the CUDA cores (and all of it in float32 beside it)
    flops = P * (9.0 * N * N + 2.0 * N * knn * sa_mac)
    products = 2.0 * P * N * knn * (32 * 64 + 64 * 128)
    io = nbytes(patches, a, *[t for wb in sa_wb for t in wb])
    bms, by = tc_bound(flops - products, products, io)
    bms32, _ = bound(flops, io)
    rec = dict(name="sa_fused", route="cuda", source="pcc_tpu_torch/csrc/sa_fused.cu",
               replaces="pcc_tpu/ops/sa_pallas.py:43", max_abs_err=err,
               ms=cuda_ms(lambda: sa_fused(patches, sa_wb, knn), 5),
               plain_ms=cuda_ms(lambda: sa_fused_plain(patches, sa_wb, knn), 2),
               bound_ms=bms, bound_by=by, bound_fp32_ms=bms32, library_ms=None,
               device_ms=graph_ms(lambda: sa_fused(patches, sa_wb, knn), 5))
    module = SetAbstraction(knn=knn, fused=True).to(dev)
    module.load_state_dict(sa.state_dict())
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    out = module(patches)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    want = {name: 0 for name in cuda_lib.KERNELS}
    want["sa_fused"] = 1
    if launches != want:
        raise RuntimeError(f"SetAbstraction(fused=True) launches {launches} != {want}")
    if not torch.equal(out, a):
        raise RuntimeError("SetAbstraction(fused=True) differs from sa_fused")
    rec["launches"] = launches["sa_fused"]
    log(f"sa_fused on {tuple(patches.shape)}, knn {knn}: {rec['ms']:.3f} ms, device "
        f"{rec['device_ms']:.3f} ms (the float32 design's {FP32_DESIGN_MS['sa_fused']} ms "
        f"in an earlier run, not measured here; plain {rec['plain_ms']:.1f} ms; bound "
        f"{bms:.3f} ms by {by} with layers 2-3 in 3xTF32, {bms32:.3f} ms in float32; "
        f"{flops / 1e9:.1f} GFLOP, {flops / rec['ms'] / 1e9:.2f} TFLOP/s), max_abs_err "
        f"{err:.3g} of {big:.3g}, two launches bitwise equal; SetAbstraction(fused=True) "
        f"launches {launches['sa_fused']}, output equal")
    return rec


def decoder_kernel_check(ae, h2, lat, w3r, b3r, mlp_wb, packed, launches: int) -> dict:
    """Phase 4's decoder: the kernel on the serving batch's own inputs and
    the weights the decode path prepared vs its plain version (TOL), two
    launches bitwise equal, its record for the kernels line."""
    k = ae.k
    n_rows = distinct_rows("patch_decoder's h2", h2)
    a = patch_decoder(h2, lat, w3r, b3r, mlp_wb, k, packed=packed)
    b = patch_decoder_plain(h2, lat, w3r, b3r, mlp_wb, k)
    err = float((a - b).abs().max())
    if not err <= TOL:
        raise RuntimeError(f"patch decoder differs from the plain version: {err}")
    if not torch.equal(a, patch_decoder(h2, lat, w3r, b3r, mlp_wb, k, packed=packed)):
        raise RuntimeError("two launches of patch_decoder differ")
    (P, C), d = h2.shape, lat.shape[1]
    mlp_mac = (128 + d) * 128 + 128 * 64 + 64 * 32 + 32 * 3
    flops = 2.0 * P * k * (C * 128 + mlp_mac)
    # what the function reads and writes: h2, lat, one copy of each weight
    # (the kernel reads the expansion's hi and lo, the split is its own)
    io = nbytes(h2, lat, a, w3r, b3r, *[t for wb in mlp_wb for t in wb])
    # the bound as the kernel computes: every product as three TF32 products
    # on the tensor cores (the 32 -> 3 layer, 0.2% of the operations, too);
    # the float32 bound on the CUDA cores beside it
    t_ops, t_bytes = 3.0 * flops / TF32_FLOP_PER_S, io / HBM_BYTES_PER_S
    bms, by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
    bms32, _ = bound(flops, io)
    l3 = ae.inv_pool[4]
    rec = dict(
        name="patch_decoder", route="cuda", source="pcc_tpu_torch/csrc/patch_decoder.cu",
        replaces="pcc_tpu/ops/decoder_pallas.py:30", launches=launches, max_abs_err=err,
        distinct_rows=n_rows,
        ms=cuda_ms(lambda: patch_decoder(h2, lat, w3r, b3r, mlp_wb, k, packed=packed), 10),
        plain_ms=cuda_ms(lambda: patch_decoder_plain(h2, lat, w3r, b3r, mlp_wb, k), 5),
        bound_ms=bms, bound_by=by, bound_fp32_ms=bms32, gflop=flops / 1e9,
        # no PyTorch call computes the decoder; the yardstick is its
        # expansion product alone (82% of the operations) in float32, TF32
        # off, as device.py sets it
        library_ms=cuda_ms(lambda: torch.matmul(h2, w3r), 10),
        library_call="torch.matmul(h2, w3r), float32, TF32 off: the expansion product alone",
        # what the decode path would pay per batch if it held no prepared
        # weights: the permutation and the kernel's layout of them
        prep_ms=cuda_ms(lambda: (permute_expansion(l3.weight.t(), l3.bias, k),
                                 pack_decoder(expansion_kmajor(l3.weight, k), b3r, mlp_wb)), 10))
    log(f"patch_decoder h2 {tuple(h2.shape)} k {k} d {d}: {rec['ms']:.4f} ms (plain "
        f"{rec['plain_ms']:.4f} ms; bound {bms:.4f} ms by {by} with its products as 3xTF32 "
        f"on the tensor cores, {bms32:.4f} ms in float32; {flops / 1e9:.1f} GFLOP, "
        f"{flops / rec['ms'] / 1e9:.2f} TFLOP/s); {rec['library_call']} "
        f"{rec['library_ms']:.4f} ms; weight preparation {rec['prep_ms']:.4f} ms; max_abs_err "
        f"{err:.3g} of {float(b.abs().max()):.3g} on seeded latents ({n_rows} distinct h2 rows "
        f"of {P}); two launches bitwise equal")
    return rec


@contextlib.contextmanager
def recording_pppe_stages():
    """Record the inputs of every fused stage call of the PPPE encoder
    while active (models/pppe.py's pppf_sa_fused swapped for a wrapper that
    records and goes on to the kernel). Yields the list of calls, each
    (new_xyz, xyz, feat, layers, nsample); the bf16 model's calls (its
    layers' W rounded) too."""
    import pcc_tpu_torch.models.pppe as pppe_mod

    calls = []

    def recording(new_xyz, xyz, feat, layers, *, nsample, radius, layout, bf16=False):
        calls.append((new_xyz.clone(), xyz.clone(), None if feat is None else feat.clone(),
                      [tuple(t.detach().clone() for t in lay) for lay in layers], nsample))
        return pppf_sa_fused(new_xyz, xyz, feat, layers, nsample=nsample, radius=radius,
                             layout=layout, bf16=bf16)

    saved = pppe_mod.pppf_sa_fused
    pppe_mod.pppf_sa_fused = recording
    try:
        yield calls
    finally:
        pppe_mod.pppf_sa_fused = saved


def eval_phase(dev, clouds, decoded) -> dict:
    """Phase 18: metrics.eval_batch on the IPDAE path's 64 decoded clouds
    against their originals on the card, EVAL_CPU_PAIRS of the pairs again
    on the CPU port (within TOL_EVAL); time per EVAL_PAIRS pairs (CUDA
    events of eval_batch_device on one chunk), with the normals' share and
    that of one query chunk's stable sort (select_nearest over [EVAL_PAIRS,
    2048, N])."""
    origs, recons = np.stack(clouds), np.stack(decoded)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = eval_batch(origs, recons, device=dev.type)
    wall = time.perf_counter() - t0
    for m in card:
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"eval_batch on the card gave a non-finite metric: {m}")
    cpu = eval_batch(origs[:EVAL_CPU_PAIRS], recons[:EVAL_CPU_PAIRS], chunk=EVAL_CPU_PAIRS,
                     device="cpu")
    diffs = {k: max(abs(a[k] - b[k]) / (1.0 if k in ("p2point_psnr", "p2plane_psnr")
                                        else abs(b[k])) for a, b in zip(card, cpu))
             for k in TOL_EVAL}
    for k, tol in TOL_EVAL.items():
        if not diffs[k] <= tol:
            raise RuntimeError(f"eval_batch {k}: card vs CPU port differ by {diffs[k]} > {tol}")
    o = torch.from_numpy(origs[:EVAL_PAIRS]).to(dev)
    r = torch.from_numpy(recons[:EVAL_PAIRS]).to(dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: eval_batch_device(o, r), 3)
        normals_ms = cuda_ms(lambda: estimate_normals(o), 3)
        sort_ms = cuda_ms(lambda: select_nearest(sq_dists(o[:, :2048], o), 30), 3)
    rec = dict(pairs=len(card), points=[origs.shape[1], recons.shape[1]], wall_ms=wall * 1e3,
               ms_per_16_pairs=ms, normals_ms=normals_ms, normals_share=normals_ms / ms,
               sort_chunk_ms=sort_ms, card_vs_cpu=diffs, tolerances=TOL_EVAL,
               mean_d1=float(np.mean([m["p2point_psnr"] for m in card])),
               mean_d2=float(np.mean([m["p2plane_psnr"] for m in card])))
    log(f"eval_batch on the card: {len(card)} pairs of {origs.shape[1]} / {recons.shape[1]} "
        f"points in {wall * 1e3:.1f} ms (wall); {ms:.2f} ms per {EVAL_PAIRS} pairs (CUDA "
        f"events), normals {normals_ms:.2f} ms ({normals_ms / ms:.3f}), one query chunk's "
        f"stable sort [{EVAL_PAIRS}, 2048, {origs.shape[1]}] {sort_ms:.2f} ms; mean D1 "
        f"{rec['mean_d1']:.3f} dB, D2 {rec['mean_d2']:.3f} dB; card vs CPU port on "
        f"{EVAL_CPU_PAIRS} pairs: " + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))
    log("eval: " + json.dumps(rec))
    return rec


def pppe_test_state(model, seed: int) -> dict:
    """randomize_batchnorm, and the latent head scaled so that the latents
    spread over the L bins (at random weights they all round to bin 0, and
    the entropy stream would code one symbol)."""
    sd = randomize_batchnorm(model.state_dict(), seed)
    sd["encoder.global_conv.3.weight"] = sd["encoder.global_conv.3.weight"] * 60.0
    sd["encoder.global_conv.3.bias"] = torch.full_like(sd["encoder.global_conv.3.bias"], 3.0)
    return sd


def run_cli(label: str, main_fn, argv) -> tuple:
    """One in-process CLI run with every launch counter set to 0 just before
    and read just after: (wall ms, launches)."""
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    main_fn(argv)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(cuda_lib.launches)
    log(f"{label}: {wall:.1f} ms, launches {launches}")
    return wall, launches


def pppe_phase(dev, smi: str):
    """Phases 19-20: the PPPE serving path at the CLIs' defaults through the
    CLIs (compress raw and entropy-coded, decompress in its three
    transforms, eval_pppe), then the stage kernel in the "pppe" layout and
    FPS vs their plain versions on the path's own inputs. Returns the
    stage's kernels-line record, the FPS shape records and the FPS launches
    of one compress batch."""
    import pickle
    import shutil
    import tempfile

    from pcc_tpu_torch.cli import eval_pppe, pppe_pcd_compress, pppe_pcd_decompress
    from pcc_tpu_torch.cli.pppe_pcd_compress import encode_clouds
    from pcc_tpu_torch.cli.pppe_pcd_decompress import decode_latents
    from pcc_tpu_torch.io import read_point_cloud, save_point_cloud
    from pcc_tpu_torch.weights import to_jax_params

    cfg = PPPEConfig()
    B = PPPE_CLOUDS
    clouds = synthetic_clouds(B, cfg.N, SEED + 5)
    model = make_pppe_model(cfg, seed=SEED)
    sd = pppe_test_state(model, SEED + 6)
    model.load_state_dict(sd)
    model = model.to(dev)
    os.makedirs(os.path.join(ROOT, "_chip"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="pppe_", dir=os.path.join(ROOT, "_chip"))
    try:
        for i, pc in enumerate(clouds):
            save_point_cloud(pc, f"c{i:02d}.ply", path=os.path.join(work, "in"))
        os.makedirs(os.path.join(work, "model"))
        with open(os.path.join(work, "model", "ae_latest.pkl"), "wb") as f:
            pickle.dump(to_jax_params(sd)[0], f)
        d = lambda *p: os.path.join(work, *p)  # noqa: E731
        common = ["--N", str(cfg.N), "--K", str(cfg.latent_dim), "--L", str(cfg.L),
                  "--batch_size", str(B), "--device", dev.type]

        # 19. the path, through the CLIs
        with torch.no_grad():
            encode_clouds(model, np.stack(clouds), cfg)          # warm-up, uncounted
        walls = {}
        want = {name: 0 for name in cuda_lib.KERNELS}
        want.update(fps=3, pppf_sa_stage=2)
        counted = {}
        for kind, extra in (("raw", []), ("entropy", ["--entropy_coding"])):
            walls[f"compress {kind}"], launches = run_cli(
                f"PPPE compress ({kind}, {B} clouds x {cfg.N} points)", pppe_pcd_compress.main,
                [d("in", "*.ply"), d(f"comp_{kind}"), d("model"), *extra, *common])
            if launches != want:
                raise RuntimeError(f"PPPE compress ({kind}) launches {launches} != {want}")
            counted[kind] = launches
        for mode, src, extra in (("sigmoid", "raw", []), ("round", "raw", ["--use_quantized"]),
                                 ("quantized", "entropy", [])):
            walls[f"decompress {mode}"], launches = run_cli(
                f"PPPE decompress ({mode})", pppe_pcd_decompress.main,
                [d(f"comp_{src}", "*.bin"), d(f"dec_{mode}"), d("model"), *extra, *common])
            if any(launches.values()):
                raise RuntimeError(f"PPPE decompress launched a kernel: {launches}")
            for i in range(B):
                pc = read_point_cloud(d(f"dec_{mode}", f"c{i:02d}.bin.ply"))
                if pc.shape != (cfg.N, 3) or not np.isfinite(pc).all():
                    raise RuntimeError(f"bad decoded PPPE cloud ({mode}): shape {pc.shape}")
        walls["eval_pppe"], _ = run_cli(
            "PPPE eval_pppe (round)", eval_pppe.main,
            ["--input_glob", d("in", "*.ply"), "--compressed_path", d("comp_raw"),
             "--decompressed_path", d("dec_round"), "--output_file", d("eval.csv"),
             "--device", dev.type])
        with open(d("eval.csv")) as f:
            rows = f.read().splitlines()
        if len(rows) != B + 1:
            raise RuntimeError(f"eval_pppe wrote {len(rows) - 1} rows for {B} clouds")
        raw_bytes = os.path.getsize(d("comp_raw", "c00.bin"))
        ent_bytes = [os.path.getsize(d("comp_entropy", f"c{i:02d}.bin")) for i in range(B)]
        log(f"PPPE streams: raw {raw_bytes} bytes ({8 * raw_bytes / cfg.N:.4f} bpp), entropy "
            f"{np.mean(ent_bytes):.1f} bytes on average ({8 * np.mean(ent_bytes) / cfg.N:.4f} "
            f"bpp) per cloud")

        batch = np.stack(clouds)
        with torch.no_grad():
            lat = encode_clouds(model, batch, cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lat = encode_clouds(model, batch, cfg)
            torch.cuda.synchronize()
            enc_ms = (time.perf_counter() - t0) * 1e3
            enc_peak = torch.cuda.max_memory_allocated() / 2**30
            lat_np = lat.cpu().numpy()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fine = decode_latents(model, lat_np, "round", cfg.L)
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t0) * 1e3
            dec_peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"PPPE encode of {B} clouds {enc_ms:.1f} ms (wall, {B / enc_ms * 1e3:.1f} "
                f"clouds/s), peak {enc_peak:.2f} GiB; decode {dec_ms:.1f} ms, peak "
                f"{dec_peak:.2f} GiB on {smi}")
            profile("PPPE encode", lambda: encode_clouds(model, batch, cfg), top=12)
            profile("PPPE decode", lambda: decode_latents(model, lat_np, "round", cfg.L))
            stored = np.stack([np.fromfile(d("comp_raw", f"c{i:02d}.bin"), "<f4")[1:]
                               for i in range(B)])
            if not np.array_equal(stored, lat_np):
                raise RuntimeError("the CLI's .bin latents differ from the encoder's")

            # the same weights and clouds on the CPU port
            cpu_model = make_pppe_model(cfg)
            cpu_model.load_state_dict(sd)
            n = PPPE_CPU_CLOUDS
            lat_cpu = encode_clouds(cpu_model, batch[:n], cfg).numpy()
            lat_err = float(np.abs(lat_np[:n] - lat_cpu).max())
            big = float(np.abs(lat_cpu).max())
            if not lat_err <= TOL * big:
                raise RuntimeError(f"PPPE latents: card vs CPU port {lat_err} > {TOL} * {big}")
            dec_err = 0.0
            for mode in ("sigmoid", "round"):
                a = decode_latents(cpu_model, lat_np[:n], mode, cfg.L).numpy()
                b = decode_latents(model, lat_np[:n], mode, cfg.L).cpu().numpy()
                dec_err = max(dec_err, float(np.abs(a - b).max()) / float(np.abs(a).max()))
            if not dec_err <= TOL:
                raise RuntimeError(f"PPPE decoded clouds: card vs CPU port {dec_err} > {TOL}")
            flips = int((np.clip(np.round(lat_np[:n]), 0, cfg.L - 1)
                         != np.clip(np.round(lat_cpu), 0, cfg.L - 1)).sum())
            log(f"PPPE card vs CPU port on {n} clouds: latents within {lat_err:.3g} of "
                f"{big:.3g}, decoded clouds within {dec_err:.3g} of their largest entry; "
                f"{flips} quantized symbols differ")

            # 20. the stage kernel in the "pppe" layout and FPS on the path's inputs
            with recording_fps() as fps_calls, recording_pppe_stages() as stage_calls:
                encode_clouds(model, batch, cfg)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if len(stage_calls) != 2 or len(fps_calls) != 3:
        raise RuntimeError(f"the PPPE encoder made {len(stage_calls)} stage and "
                           f"{len(fps_calls)} FPS calls, not 2 and 3")
    fps_recs = [fps_check(f"PPPE serving {name}", c)
                for name, c in zip(("sa1", "sa2", "sa3"), fps_calls)]
    sa1_q = torch.gather(fps_calls[0][1], 1, fps_plain(*fps_calls[0][1:]).long()[..., None]
                         .expand(-1, -1, 3))
    x1 = fps_calls[0][1]
    with torch.no_grad():
        sort_ms = cuda_ms(lambda: select_nearest(sq_dists(sa1_q, x1), 32), 3)
        dist_ms = cuda_ms(lambda: sq_dists(sa1_q, x1), 3)
    log(f"PPPE sa1 top-32 selection [{B}, 512, {cfg.N}]: {sort_ms:.2f} ms, of which the "
        f"distances {dist_ms:.2f} ms and the stable sort the rest")
    stages = [pppe_stage_check(name, *call)
              for name, call in zip(("sa2", "sa3"), stage_calls)]
    new_xyz, xyz, feat, _, nsample = stage_calls[0]
    per_slot = pppe_per_slot_check(new_xyz, xyz, feat, nsample)
    return per_slot, dict(
        name="pppf_sa_stage (pppe layout)", route="cuda",
        source="pcc_tpu_torch/csrc/pppf_sa_stage.cu", replaces="pcc_tpu/ops/pppf_sa_pallas.py:45",
        launches=counted["raw"]["pppf_sa_stage"],
        max_abs_err=max(r["max_abs_err"] for r in stages),
        ms=sum(r["ms"] for r in stages), plain_ms=sum(r["plain_ms"] for r in stages),
        bound_ms=sum(r["bound_ms"] for r in stages), bound_by=stages[-1]["bound_by"],
        bound_fp32_ms=sum(r["bound_fp32_ms"] for r in stages),
        device_ms=sum(r["device_ms"] for r in stages),
        library_ms=None, path="PPPE serving", stages=stages,
        walls_ms=walls, encode_ms=enc_ms, decode_ms=dec_ms, encode_peak_gib=enc_peak,
        sa1_selection_ms=sort_ms), fps_recs, counted["raw"]["fps"]


def pppe_per_slot_check(new_xyz, xyz, feat, nsample) -> dict:
    """Phase 20's per-slot route: the "pppe" layout at a shape past the slot
    kernel's tiles (a PER_SLOT_MIDDLE-wide middle layer, seeded layers) on
    phase 19's recorded sa2 inputs, which the per-slot kernel runs (one
    launch, no feature-block scratch): within TOL of the plain version's
    largest entry, two launches bitwise equal, CUDA-event and device times,
    the plain version's time and the float32 bound (the least work, the
    first layer per point). No path of the port takes this route (PPPE's
    widths fit the slot kernel): its record's launches are 0."""
    P, S, _ = new_xyz.shape
    N, dev = xyz.shape[1], xyz.device
    widths = [3 + feat.shape[-1], 128, PER_SLOT_MIDDLE, 256]
    if pppe_kernel(widths, N, S, nsample) != "per_slot":
        raise RuntimeError(f"widths {widths} do not take the per-slot \"pppe\" route")
    g = torch.Generator().manual_seed(SEED + 40)
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        sign = torch.where(torch.rand(b, generator=g) < 0.25, -1.0, 1.0)
        layers.append(tuple(t.to(dev) for t in (
            (torch.rand((a, b), generator=g) * 2 - 1) * a ** -0.5,
            (torch.rand(b, generator=g) * 2 - 1) * a ** -0.5,
            (torch.rand(b, generator=g) - 0.5) * 0.2, (torch.rand(b, generator=g) + 0.5) * sign,
            (torch.rand(b, generator=g) - 0.3) * 0.5)))
    kw = dict(nsample=nsample, radius=0.0, layout="pppe")
    before = cuda_lib.launches["pppf_sa_stage"]
    a = pppf_sa_fused(new_xyz, xyz, feat, layers, **kw)
    if cuda_lib.launches["pppf_sa_stage"] != before + 1:
        raise RuntimeError("the per-slot \"pppe\" route made more than one launch")
    b = pppf_sa_plain(new_xyz, xyz, feat, layers, **kw)
    err, big = float((a - b).abs().max()), float(b.abs().max())
    if not err <= TOL * big:
        raise RuntimeError(f"pppf_sa_stage (pppe, per slot) differs from the plain version: "
                           f"{err} > {TOL} * {big}")
    if not torch.equal(pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), a):
        raise RuntimeError("two launches of pppf_sa_stage (pppe, per slot) differ")
    flops = stage_flops(P, S, N, nsample, widths, layout="pppe")
    bms, by = bound(flops, nbytes(new_xyz, xyz, feat, a, *[t for lay in layers for t in lay]))
    rec = dict(
        name="pppf_sa_stage (pppe layout, per-slot route)", route="cuda",
        source="pcc_tpu_torch/csrc/pppf_sa_stage.cu", replaces="pcc_tpu/ops/pppf_sa_pallas.py:45",
        launches=0, path="none: held on phase 19's sa2 inputs at widths past pppe_plan",
        shape=[P, S, N, widths], nsample=nsample, max_abs_err=err, max_abs=big,
        repeatable=True, ms=cuda_ms(lambda: pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), 5),
        plain_ms=cuda_ms(lambda: pppf_sa_plain(new_xyz, xyz, feat, layers, **kw), 2),
        bound_ms=bms, bound_by=by, library_ms=None, gflop=flops / 1e9)
    rec["device_ms"] = graph_ms(lambda: pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), 5)
    log(f"pppf_sa_stage (pppe, per-slot route) new_xyz {tuple(new_xyz.shape)} xyz "
        f"{tuple(xyz.shape)} widths {widths} nsample {nsample}: {rec['ms']:.3f} ms, device "
        f"{rec['device_ms']:.3f} ms (plain {rec['plain_ms']:.2f} ms, bound {bms:.4f} ms by {by} "
        f"in float32, {flops / 1e9:.2f} GFLOP), max_abs_err {err:.3g} of {big:.3g}; two "
        "launches bitwise equal")
    return rec


def pppe_stage_check(name: str, new_xyz, xyz, feat, layers, nsample) -> dict:
    """Phase 20 for one stage: the kernel in the "pppe" layout vs
    pppf_sa_plain on the recorded inputs, within TOL of the largest entry;
    its selection bit-equal to the plain version's, read through the kernel
    itself: with one-hot features of the N points and one identity layer,
    each query's output is the indicator of the set of points its slots
    read (the max over slots of 0/1 rows, exact). CUDA-event times, the
    plain version's time and the bound by operations (per slot)."""
    kw = dict(nsample=nsample, radius=0.0, layout="pppe")
    a = pppf_sa_fused(new_xyz, xyz, feat, layers, **kw)
    b = pppf_sa_plain(new_xyz, xyz, feat, layers, **kw)
    err, big = float((a - b).abs().max()), float(b.abs().max())
    if not err <= TOL * big:
        raise RuntimeError(f"pppf_sa_stage {name} (pppe) differs from the plain version: "
                           f"{err} > {TOL} * {big}")
    P, S, _ = new_xyz.shape
    N = xyz.shape[1]
    dev = xyz.device
    onehot = torch.eye(N, device=dev).expand(P, N, N).contiguous()
    W = 3 + N
    ident = [(torch.eye(W, device=dev), torch.zeros(W, device=dev), torch.zeros(W, device=dev),
              torch.ones(W, device=dev), torch.zeros(W, device=dev))]
    picked = pppf_sa_fused(new_xyz, xyz, onehot, ident, **kw)[..., 3:]
    idx = select_nearest(sq_dists(new_xyz, xyz), nsample)
    want = torch.zeros((P, S, N), device=dev).scatter_(2, idx, 1.0)
    if not torch.equal(picked, want):
        raise RuntimeError(f"pppf_sa_stage {name} (pppe): the kernel's selection differs from "
                           f"the plain version's for {int((picked != want).any(-1).sum())} "
                           "queries")
    if not torch.equal(pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), a):
        raise RuntimeError(f"two launches of pppf_sa_stage {name} (pppe) differ")
    widths = [layers[0][0].shape[0]] + [lay[0].shape[1] for lay in layers]
    flops = stage_flops(P, S, N, nsample, widths, layout="pppe")
    # the first layer's product per point and layers 2.. per slot as 3xTF32
    # products on the tensor cores, the rest in float32 (and all of it in
    # float32 beside it)
    fp32, products = pppe_work(P, S, N, nsample, widths)
    io = nbytes(new_xyz, xyz, feat, a, *[t for lay in layers for t in lay])
    bms, by = tc_bound(fp32, products, io)
    bms32, _ = bound(flops, io)
    rec = dict(stage=name, layout="pppe", shape=[P, S, N, widths], nsample=nsample,
               max_abs_err=err, max_abs=big, selection="bit-equal", repeatable=True,
               ms=cuda_ms(lambda: pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), 10),
               plain_ms=cuda_ms(lambda: pppf_sa_plain(new_xyz, xyz, feat, layers, **kw), 2),
               bound_ms=bms, bound_by=by, bound_fp32_ms=bms32, gflop=flops / 1e9)
    rec["device_ms"] = graph_ms(lambda: pppf_sa_fused(new_xyz, xyz, feat, layers, **kw))
    log(f"pppf_sa_stage {name} (pppe) new_xyz {tuple(new_xyz.shape)} xyz {tuple(xyz.shape)} "
        f"widths {widths} nsample {nsample}: {rec['ms']:.3f} ms, device {rec['device_ms']:.3f} "
        f"ms (the float32 per-slot design's {FP32_DESIGN_MS[f'pppe {name}']} ms in an earlier "
        f"run, not measured here; plain "
        f"{rec['plain_ms']:.2f} ms; bound {bms:.4f} ms by {by} with the products in 3xTF32, "
        f"{bms32:.4f} ms in float32; {flops / 1e9:.2f} GFLOP, "
        f"{flops / rec['device_ms'] / 1e9:.2f} TFLOP/s), max_abs_err {err:.3g} of {big:.3g}; "
        "selection bit-equal to the plain version's, two launches bitwise equal")
    return rec


def unit_cube(clouds) -> np.ndarray:
    """Clouds scaled into [0, 1]^3 each: PPPE trains on raw clouds, and its
    CLI expects training data already in about that range."""
    pcs = np.stack(clouds)
    lo, hi = pcs.min(axis=1, keepdims=True), pcs.max(axis=1, keepdims=True)
    return ((pcs - lo) / (hi - lo).max(axis=2, keepdims=True)).astype(np.float32)


def timed_steps(run_step, steps: int):
    """`steps` calls of run_step() with every launch counter set to 0 just
    before and read just after: (per-step wall seconds, the auxes, the
    launches, the peak memory in GiB)."""
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, auxes = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        auxes.append(run_step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, auxes, dict(cuda_lib.launches), torch.cuda.max_memory_allocated() / 2**30


def want_launches(steps: int, **per_step) -> dict:
    want = {name: 0 for name in cuda_lib.KERNELS}
    want.update({k: v * steps for k, v in per_step.items()})
    return want


def kernel_check(name: str, path: str, kern, plain, tol: float) -> dict:
    """A kernel's outputs (a tensor or a list of them) vs its plain
    version's on a new path's own inputs: each within tol of the plain
    output's own largest entry (an integer output, such as the encoder's
    winners, so equal); CUDA-event times of both."""
    a, b = kern(), plain()
    a, b = (a, b) if isinstance(a, (list, tuple)) else ([a], [b])
    errs, bigs = [], []
    for u, v in zip(a, b):
        e, big = float((u - v).abs().max()), float(v.abs().max())
        if not e <= tol * big:
            raise RuntimeError(f"{name} differs from its plain version at {path} on "
                               f"{tuple(v.shape)}: {e} > {tol} * {big}")
        errs.append(e)
        bigs.append(big)
    rel = [e / big if big else 0.0 for e, big in zip(errs, bigs)]
    rec = dict(path=path, shape=list(b[0].shape), max_abs_err=max(errs), rel_err=rel,
               max_abs_plain=bigs, ms=cuda_ms(kern, 5), plain_ms=cuda_ms(plain, 1))
    log(f"{name} at {path}, output {tuple(b[0].shape)}: {rec['ms']:.4f} ms (plain "
        f"{rec['plain_ms']:.3f} ms); per output max |kernel - plain| / max |plain| "
        f"{', '.join(f'{r:.3g}' for r in rel)} (limit {tol}), max |plain| "
        f"{', '.join(f'{x:.3g}' for x in bigs)}")
    return rec


@contextlib.contextmanager
def recording_encoder_bwd(rec: dict):
    """Record the patch encoder's backward inputs (patches, winners,
    cotangent, weights as the forward saw them) of the steps run while
    active, as phase 6 does."""
    backward = PatchEncoderFn.backward

    def recording(ctx, g):
        patches, winners, *wb = ctx.saved_tensors
        rec.update(patches=patches, winners=winners, g=g.contiguous(),
                   wb=[t.detach().clone() for t in wb])
        return backward(ctx, g)

    PatchEncoderFn.backward = staticmethod(recording)
    try:
        yield
    finally:
        PatchEncoderFn.backward = staticmethod(backward)


def encoder_train_checks(path: str, rec: dict, knn: int) -> dict:
    """The patch encoder and its backward vs their plain versions on a
    recorded step's own inputs: the forward with its winners output (the
    latents within TOL of the plain ones' largest entry, the winners equal,
    and equal to those the step handed over), the backward on those winners
    (every output within TOL_BWD of the plain one's largest entry)."""
    patches, win, g = rec["patches"], rec["winners"], rec["g"]
    sa_wb, pn_wb = _unflatten(rec["wb"])
    with torch.no_grad():
        if not torch.equal(patch_encoder(patches, sa_wb, pn_wb, knn, return_winners=True)[1], win):
            raise RuntimeError(f"patch_encoder's winners at {path} differ from the step's")
        fwd = kernel_check(
            "patch_encoder", path,
            lambda: patch_encoder(patches, sa_wb, pn_wb, knn, return_winners=True),
            lambda: patch_encoder_plain(patches, sa_wb, pn_wb, knn, return_winners=True), TOL)
    bwd = kernel_check(
        "patch_encoder_bwd", path,
        lambda: flat_grads(patch_encoder_bwd(patches, g, sa_wb, pn_wb, knn, winners=win)),
        lambda: flat_grads(patch_encoder_bwd_plain(patches, g, sa_wb, pn_wb, knn, winners=win)),
        TOL_BWD)
    return dict(patch_encoder=fwd, patch_encoder_bwd=bwd)


def pppe_train_phase(dev, smi: str) -> dict:
    """Phase 21: PPPE training as cli/train_pppe_pcd_ae.py builds it, at its
    defaults (N 8192, latent 256, L 7, batch 4, lr 5e-4), seeded weights, on
    a fixed batch of synthetic clouds in the unit cube: one uncounted and
    PPPE_TRAIN_STEPS counted steps (fps 3, chamfer_fwd and chamfer_bwd 1 per
    step, nothing else), finite losses and dist and rate, loss and dist
    lower after the steps than before; then a step on the batch with one
    NaN coordinate, which must leave parameters, Adam moments and count,
    running statistics and step bit for bit. Median step time, points/s,
    peak memory; one step under torch.profiler. Returns the launches per
    step."""
    cfg = PPPEConfig()
    B = PPPE_TRAIN_CLOUDS
    tx = make_pppe_optimizer(5e-4)
    state = create_pppe_state(SEED, cfg, tx, device="cuda")
    step = build_pppe_train_step(tx)
    batch = torch.from_numpy(unit_cube(synthetic_clouds(B, cfg.N, SEED + 8))).to(dev)
    lam = 1.0 / 5000          # the CLI's lambda warm-up at its first step
    step(state, batch, lam)                                   # uncounted
    times, auxes, launches, peak = timed_steps(lambda: step(state, batch, lam)[1],
                                               PPPE_TRAIN_STEPS)
    log(f"PPPE train launches over {PPPE_TRAIN_STEPS} steps: {launches}")
    want = want_launches(PPPE_TRAIN_STEPS, fps=3, chamfer_fwd=1, chamfer_bwd=1)
    if launches != want:
        raise RuntimeError(f"PPPE train launches {launches} != {want}")
    vals = {k: torch.stack([a[k] for a in auxes]).cpu().numpy()
            for k in ("loss", "dist", "rate", "skipped")}
    if not all(np.isfinite(vals[k]).all() for k in ("loss", "dist", "rate")) \
            or vals["skipped"].any():
        raise RuntimeError(f"PPPE train: non-finite or skipped steps: {vals}")
    if not (vals["loss"][-1] < vals["loss"][0] and vals["dist"][-1] < vals["dist"][0]):
        raise RuntimeError(f"PPPE train: loss / dist did not fall on a fixed batch: {vals}")
    ms = float(np.median(times)) * 1e3
    log(f"PPPE train: {B} clouds x {cfg.N} points per step; median step {ms:.2f} ms (steps "
        f"{min(times) * 1e3:.2f} to {max(times) * 1e3:.2f} ms), {B * cfg.N / (ms / 1e3):.0f} "
        f"points/s on {smi}; peak memory {peak:.2f} GiB; loss {vals['loss'][0]:.6f} -> "
        f"{vals['loss'][-1]:.6f}, dist {vals['dist'][0]:.6f} -> {vals['dist'][-1]:.6f}, rate "
        f"{vals['rate'][-1]:.4f}")
    profile("PPPE train step", lambda: step(state, batch, lam), top=14)
    # one more step, recording its FPS calls and its chamfer's clouds and
    # cotangents: the kernels vs their plain versions on the path's inputs
    chamfer_rec = {}
    with recording_fps() as fps_calls, recording_chamfer(chamfer_rec, "PPPE"):
        step(state, batch, lam)

    fields = ("params", "stats", "mu", "nu", "count", "step")
    before = [getattr(state, f).clone() for f in fields]
    bad = batch.clone()
    bad[1, 100, 0] = float("nan")
    _, aux = step(state, bad, lam)
    same = [f for f, b in zip(fields, before) if torch.equal(b, getattr(state, f))]
    if not bool(aux["skipped"]) or len(same) != len(fields):
        raise RuntimeError(f"PPPE train: a NaN batch was not skipped whole (skipped "
                           f"{bool(aux['skipped'])}, unchanged {same})")
    log(f"PPPE train: a batch with a NaN coordinate skipped on the device; "
        f"{', '.join(fields)} bit for bit unchanged")
    per_step = {k: v // PPPE_TRAIN_STEPS for k, v in launches.items() if v}
    checks = dict(
        fps=[fps_check(f"PPPE train step {STAGE_OF_NPOINT[c[2]]}", c) for c in fps_calls],
        chamfer=chamfer_path_check(dev, "N=8192 PPPE train step", chamfer_rec["PPPE"],
                                   launches, torch.Generator().manual_seed(SEED + 13)))
    return dict(launches_per_step=per_step, step_ms=ms, points_per_s=B * cfg.N / (ms / 1e3),
                peak_gib=peak), checks


def pppe_train_card_vs_cpu(dev) -> None:
    """Phase 22: one PPPE step at TINY_PPPE on the card and on the CPU port
    from the same seeded weights and clouds, held by compare_train_states:
    loss to 1e-5 relative; each gradient within TOL_PPPF_STEP of its
    tensor's largest entry (the decoder's) or TOL_PPPE_STEP (the encoder's,
    through batch statistics), a zero gradient in exact arithmetic (the
    stages' conv biases before batch statistics) within ZERO_GRAD of the
    largest; parameters to lr / 4 where compare_train_states holds them,
    and running statistics to TOL_PPPE_STEP relative. Then
    cli/train_pppe_pcd_ae.py for 3 steps at
    its defaults (--step_window 1), whose ae_latest.pkl the PPPE compress
    CLI loads and whose .bin files decompress."""
    import shutil
    import tempfile

    from pcc_tpu_torch.cli import pppe_pcd_compress, pppe_pcd_decompress, train_pppe_pcd_ae
    from pcc_tpu_torch.io import read_point_cloud, save_point_cloud

    cfg = PPPEConfig(**TINY_PPPE)
    lr = 1e-3
    tx = make_pppe_optimizer(lr)
    batch = torch.from_numpy(unit_cube(synthetic_clouds(2, cfg.N, SEED + 9)))
    card, cpu = (create_pppe_state(SEED, cfg, tx, device=d) for d in ("cuda", "cpu"))
    step = build_pppe_train_step(tx)
    before = dict(cuda_lib.launches)
    _, a = step(card, batch.to(dev), 1e-2)
    torch.cuda.synchronize()
    chamfer_launched(before, "TINY PPPE step")
    _, b = step(cpu, batch, 1e-2)
    # the prob model takes no part in the loss: no gradient on either side
    summary = compare_train_states("TINY PPPE step", float(a["loss"]), float(b["loss"]),
                                   (("", card.model, cpu.model),), ([card.stats], [cpu.stats]),
                                   ("encoder.",), lr, stats_tol=TOL_PPPE_STEP)
    log(f"PPPE step at TINY_PPPE, card vs CPU port: {summary}")

    full = PPPEConfig()
    os.makedirs(os.path.join(ROOT, "_chip"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="pppe_train_", dir=os.path.join(ROOT, "_chip"))
    try:
        d = lambda *p: os.path.join(work, *p)  # noqa: E731
        for i, pc in enumerate(unit_cube(synthetic_clouds(4, full.N, SEED + 10))):
            save_point_cloud(pc, f"c{i}.ply", path=d("in"))
        flags = ["--N", str(full.N), "--K", str(full.latent_dim), "--L", str(full.L)]
        wall, launches = run_cli("PPPE train CLI (3 steps of 4 clouds)", train_pppe_pcd_ae.main,
                                 ["--train_glob", d("in", "*.ply"), "--model_save_folder",
                                  d("model"), "--max_steps", "3", "--step_window", "1", *flags])
        if launches != want_launches(3, fps=3, chamfer_fwd=1, chamfer_bwd=1):
            raise RuntimeError(f"PPPE train CLI launches {launches}")
        pppe_pcd_compress.main([d("in", "*.ply"), d("comp"), d("model"), *flags])
        pppe_pcd_decompress.main([d("comp", "*.bin"), d("dec"), d("model"), *flags])
        for i in range(4):
            pc = read_point_cloud(d("dec", f"c{i}.bin.ply"))
            if pc.shape != (full.N, 3) or not np.isfinite(pc).all():
                raise RuntimeError(f"bad PPPE decode after the train CLI: {pc.shape}")
        log(f"PPPE train CLI: 3 steps in {wall:.0f} ms; its ae_latest.pkl compressed and "
            "decompressed 4 clouds through the PPPE CLIs")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def coloured_clouds(n: int, N: int, seed: int):
    """synthetic_clouds with u8 colours: a smooth function of position plus
    noise, from a numpy seed."""
    pcs = synthetic_clouds(n, N, seed)
    rng = np.random.default_rng(seed + 1)
    rgbs = [np.clip((0.5 + 0.4 * np.sin(1.5 * pc + np.array([0.0, 1.0, 2.0]))
                     + rng.normal(0, 0.03, pc.shape)) * 255, 0, 255).astype(np.uint8)
            for pc in pcs]
    return pcs, rgbs


def attr_codec_phase(dev, smi: str) -> dict:
    """Phase 23: the attribute codec (AttrCodec, default CodecConfig, d_a
    16, batches of 16, seeded weights) on ATTR_CLOUDS coloured clouds:
    warm-up, then compress_many -> decompress_many with every launch counter
    set to 0 just before each and read just after (compress fps 1,
    patch_encoder 1; decompress patch_decoder 1; per batch, nothing else);
    decoded symbols of both streams equal the encoded ones; colour PSNR
    (metrics.compute_color_psnr); walls per batch; ATTR_CPU_CLOUDS clouds on
    the CPU port: .s.bin and .c.bin byte-equal, the card's .p.bin and .a.bin
    decoded on the CPU to the card encoder's symbols. Returns the launches
    per batch."""
    from pcc_tpu_torch.attrib import AttrCodec, init_attr_params
    from pcc_tpu_torch.metrics import compute_color_psnr

    cfg = CodecConfig()
    n = ATTR_CLOUDS
    clouds, rgbs = coloured_clouds(n, cfg.N, SEED + 11)
    ae_sd, prob_sd = init_params(SEED, cfg)
    attr_sd, attr_prob_sd = init_attr_params(SEED + 1, cfg, ATTR_DA)
    params = {"ae": ae_sd, "prob": prob_sd, "attr": attr_sd, "attr_prob": attr_prob_sd}
    card = AttrCodec(cfg, params, batch_size=16, d_a=ATTR_DA, device="cuda")
    card.decompress_many(card.compress_many(clouds, rgbs))        # warm-up, uncounted
    torch.cuda.synchronize()
    walls, launches = {}, {}
    for kind, fn in (("compress", lambda: card.compress_many(clouds, rgbs)),
                     ("decompress", lambda: card.decompress_many(streams))):
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[kind] = (time.perf_counter() - t0) * 1e3
        launches[kind] = dict(cuda_lib.launches)
        if kind == "compress":
            streams = out
        else:
            decoded = out
    batches = -(-n // 16)
    for kind, per in (("compress", dict(fps=1, patch_encoder=1)),
                      ("decompress", dict(patch_decoder=1))):
        if launches[kind] != want_launches(batches, **per):
            raise RuntimeError(f"attribute {kind} launches {launches[kind]}")
    starts = np.zeros(n, np.int32)
    recs = skeletons([(p, s, c) for p, s, c, _ in streams])
    with torch.inference_mode():
        res = card.encode_batch(np.stack(clouds), np.stack(rgbs), starts)
        sym, asym = res.sym.cpu().numpy(), res.asym.cpu().numpy()
        got = card.decode_symbols(recs, [s[0] for s in streams], [s[3] for s in streams])
    if not (np.array_equal(got[0], sym) and np.array_equal(got[1], asym)):
        raise RuntimeError("attribute codec: decoded symbols differ from the encoded ones")
    for pc, rgb in decoded:
        if pc.shape != (cfg.S * cfg.k, 3) or rgb.shape != pc.shape or not np.isfinite(pc).all():
            raise RuntimeError(f"bad attribute decode: {pc.shape}, {rgb.shape}")
    psnr = [compute_color_psnr(c, r, pc, rgb, device="cuda")
            for c, r, (pc, rgb) in zip(clouds, rgbs, decoded)]
    bits = [8 * sum(len(b) for b in s) / cfg.N for s in streams]
    abits = [8 * len(s[3]) / cfg.N for s in streams]

    # the kernels vs their plain versions on the batch's own inputs
    path = "attribute codec batch"
    with torch.inference_mode(), recording_fps() as fps_calls:
        pcs_t, st = unpack_encode_upload(torch.from_numpy(
            pack_encode_upload(np.stack(clouds), starts).view(np.int32)).to(dev), cfg.N)
        geo = encode_geometry(pcs_t, st, cfg)
    with torch.inference_mode():
        ae = card.ae
        sa_wb, pn_wb = ae.sa.layers(), ae.pn.layers()
        latent_q = (res.sym.to(torch.float32) - cfg.L // 2).reshape(-1, cfg.d).contiguous()
        h2, w3r, b3r, mlp_wb, packed_w = ae.decoder_inputs(latent_q)
        checks = dict(
            fps=[fps_check(f"{path} skeleton", c) for c in fps_calls],
            patch_encoder=kernel_check(
                "patch_encoder", path,
                lambda: patch_encoder(geo.patches, sa_wb, pn_wb, cfg.sa_knn),
                lambda: patch_encoder_plain(geo.patches, sa_wb, pn_wb, cfg.sa_knn), TOL),
            patch_decoder=kernel_check(
                "patch_decoder", path,
                lambda: patch_decoder(h2, latent_q, w3r, b3r, mlp_wb, cfg.k, packed=packed_w),
                lambda: patch_decoder_plain(h2, latent_q, w3r, b3r, mlp_wb, cfg.k), TOL))

    m = ATTR_CPU_CLOUDS
    cpu = AttrCodec(cfg, params, batch_size=16, d_a=ATTR_DA, device="cpu")
    for j, (ours, theirs) in enumerate(zip(cpu.compress_many(clouds[:m], rgbs[:m]), streams)):
        if ours[1] != theirs[1] or ours[2] != theirs[2]:
            raise RuntimeError(f"cloud {j}: card .s.bin/.c.bin differ from the CPU port's")
    got = cpu.decode_symbols(recs[:m], [s[0] for s in streams[:m]], [s[3] for s in streams[:m]])
    if not (np.array_equal(got[0], sym[:m]) and np.array_equal(got[1], asym[:m])):
        raise RuntimeError("the CPU port decodes the card's .p.bin / .a.bin to other symbols")
    log(f"attribute codec: {n} coloured clouds x {cfg.N} points, d_a {ATTR_DA}; compress "
        f"{walls['compress']:.1f} ms, decompress {walls['decompress']:.1f} ms for {batches} "
        f"batch(es) of 16 on {smi}; launches {launches}; decoded symbols equal the encoded "
        f"ones; {np.mean(bits):.4f} bits per point ({np.mean(abits):.4f} of them .a.bin); "
        f"colour PSNR {np.mean(psnr):.3f} dB (random weights); CPU port on {m} clouds: .s/.c "
        "byte-equal, the card's .p/.a decode to the card's symbols")
    return dict(launches_per_batch={k: {n_: v // batches for n_, v in d.items() if v}
                                    for k, d in launches.items()},
                compress_ms_per_batch=walls["compress"] / batches,
                decompress_ms_per_batch=walls["decompress"] / batches,
                color_psnr=float(np.mean(psnr))), checks


def attr_train_phase(dev, smi: str) -> dict:
    """Phase 24: the attribute train step as cli/train_attributes.py builds
    it (default CodecConfig, d_a 16, lam 1e-4, colour weight 1) on
    ATTR_TRAIN_CLOUDS coloured clouds: one uncounted and ATTR_TRAIN_STEPS
    counted steps (fps, patch_encoder, patch_encoder_bwd, chamfer_fwd and
    chamfer_bwd once per step, nothing else), finite losses, parameters
    moved; median step time, peak memory; one step under torch.profiler.
    Returns the launches per step."""
    from pcc_tpu_torch.attrib import build_attr_train_step, create_attr_train_state

    cfg = CodecConfig()
    B = ATTR_TRAIN_CLOUDS
    tx = make_optimizer(5e-4, 0.1, 8000, 10000)
    state = create_attr_train_state(SEED, cfg, tx, ATTR_DA, device="cuda")
    step = build_attr_train_step(cfg, tx)
    clouds, rgbs = coloured_clouds(B, cfg.N, SEED + 12)
    batch = torch.from_numpy(np.stack(clouds)).to(dev)
    colors = torch.from_numpy(np.stack(rgbs).astype(np.float32) / 255.0).to(dev)
    gen = torch.Generator().manual_seed(SEED + 2)

    def run():
        starts = torch.randint(0, cfg.N, (B,), generator=gen, dtype=torch.int32).to(dev)
        return step(state, batch, colors, starts, 1e-4)[1]

    before = [p.detach().clone() for _, p in state.named_parameters()]
    run()                                                     # uncounted
    times, auxes, launches, peak = timed_steps(run, ATTR_TRAIN_STEPS)
    log(f"attribute train launches over {ATTR_TRAIN_STEPS} steps: {launches}")
    want = want_launches(ATTR_TRAIN_STEPS, fps=1, patch_encoder=1, patch_encoder_bwd=1,
                         chamfer_fwd=1, chamfer_bwd=1)
    if launches != want:
        raise RuntimeError(f"attribute train launches {launches} != {want}")
    losses = torch.stack([a["loss"] for a in auxes]).cpu().numpy()
    color = torch.stack([a["color_mse"] for a in auxes]).cpu().numpy()
    if not (np.isfinite(losses).all() and np.isfinite(color).all()):
        raise RuntimeError(f"non-finite attribute train loss: {losses}, {color}")
    moved = sum(not torch.equal(a, p.detach()) for a, (_, p) in
                zip(before, state.named_parameters()))
    if moved == 0:
        raise RuntimeError("no parameter moved in attribute training")
    ms = float(np.median(times)) * 1e3
    log(f"attribute train: {B} clouds x {cfg.N} points per step; median step {ms:.2f} ms "
        f"(steps {min(times) * 1e3:.2f} to {max(times) * 1e3:.2f} ms), "
        f"{B * cfg.N / (ms / 1e3):.0f} points/s on {smi}; peak memory {peak:.2f} GiB; loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}, colour MSE {color[0]:.6f} -> {color[-1]:.6f}; "
        f"{moved} of {len(before)} parameter tensors moved")
    profile("attribute train step", run, top=14)
    # one more step, recording the kernels' inputs on this path
    chamfer_rec, enc_rec = {}, {}
    with recording_fps() as fps_calls, recording_chamfer(chamfer_rec, "attr"), \
            recording_encoder_bwd(enc_rec):
        run()
    path = "attribute train step"
    checks = dict(
        fps=[fps_check(f"{path} skeleton", c) for c in fps_calls],
        **encoder_train_checks(path, enc_rec, cfg.sa_knn),
        chamfer=chamfer_path_check(dev, f"N=8192 {path}", chamfer_rec["attr"], launches,
                                   torch.Generator().manual_seed(SEED + 14)))
    return dict(launches_per_step={k: v // ATTR_TRAIN_STEPS for k, v in launches.items() if v},
                step_ms=ms, points_per_s=B * cfg.N / (ms / 1e3), peak_gib=peak), checks


# ------------------------------------------------ 25-26: data parallelism --

PAR_STEPS = 3          # timed steps per case after the compared one (phases 25-26)
PAR_SMALL_CLOUDS = 128  # phase 26's fused PPPF-AE step at N = 512: 64 + 64 clouds
# the cases' configurations: phase 6's IPDAE step and phase 3's codec, phase
# 21's PPPE step, phase 15's fused PPPF-AE step; and their device
PAR_CFG = dict(ae=CodecConfig(), pppe=PPPEConfig(), pppf=CodecConfig(N=SMALL_N, model="PPPF-AE"))
PAR_DEVICE = "cuda"


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal digests, bit-equal
    tensors."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(torch.as_tensor(t).detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def stream_digest(streams) -> str:
    h = hashlib.sha256()
    for blobs in streams:
        for b in blobs:
            h.update(len(b).to_bytes(8, "little") + b)
    return h.hexdigest()


def par_inputs() -> dict:
    """The global batches of phases 25-26, CPU tensors: the IPDAE step's 8
    clouds of 8192 points and FPS starts (phase 6's), the PPPE step's 4
    (phase 21's), the fused PPPF-AE step's 128 clouds of 512 points (phase
    15's) and the 64 clouds of the IPDAE compress (phase 3's)."""
    gen = torch.Generator().manual_seed(SEED + 21)
    clouds = lambda n, N, seed: torch.from_numpy(np.stack(synthetic_clouds(n, N, seed)))
    N, N_pf = PAR_CFG["ae"].N, PAR_CFG["pppf"].N
    return dict(
        ae_batch=clouds(TRAIN_CLOUDS, N, SEED),
        ae_starts=torch.randint(0, N, (TRAIN_CLOUDS,), generator=gen, dtype=torch.int32),
        pppe_batch=torch.from_numpy(unit_cube(synthetic_clouds(
            PPPE_TRAIN_CLOUDS, PAR_CFG["pppe"].N, SEED + 8))),
        pf_batch=clouds(PAR_SMALL_CLOUDS, N_pf, SEED + 9),
        pf_starts=torch.randint(0, N_pf, (PAR_SMALL_CLOUDS,), generator=gen, dtype=torch.int32),
        clouds=clouds(N_CLOUDS, N, SEED))


def par_case(name: str, inp: dict, ref: dict | None):
    """One case of phases 25-26 on this process's card, through the sharded
    builders and the codec (in a process group on this rank's shard; without
    one, the single-device code on the global batch): the first step from
    seeded weights (its loss, the digest of the parameters after it, and
    its gradients, summed over the ranks: as they are, or, given the
    one-device `ref`, each one's largest difference from it and its largest
    entry), then PAR_STEPS timed steps with the launch counters set to 0
    just before and read just after. "codec": compress -> decompress of the
    64 clouds at batch 64 (the stream and cloud digests, the launches)."""
    dev = torch.device(PAR_DEVICE)        # in a worker, its rank's card
    if name == "codec":
        cfg = PAR_CFG["ae"]
        codec = Codec(cfg, *init_params(SEED, cfg), batch_size=N_CLOUDS, device=PAR_DEVICE)
        clouds = list(inp["clouds"].numpy())
        codec.decompress_many(codec.compress_many(clouds))            # warm-up, uncounted
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        streams = codec.compress_many(clouds)
        decoded = codec.decompress_many(streams)
        torch.cuda.synchronize()
        return dict(streams=stream_digest(streams), decoded=digest(decoded),
                    launches={k: v for k, v in cuda_lib.launches.items() if v},
                    ms=(time.perf_counter() - t0) * 1e3)
    if name == "pppe":
        tx = make_pppe_optimizer(5e-4)
        state = create_pppe_state(SEED, PAR_CFG["pppe"], tx, device=PAR_DEVICE)
        step = build_sharded_pppe_train_step(tx)
        batch = inp["pppe_batch"].to(dev)
        lam = 1.0 / 5000
        run = lambda: step(state, batch, lam)[1]
        params = lambda: [state.params]

        def grads():      # the step's flat gradient (the prob model's are zeros)
            g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for _, p in state.named_parameters()])
            return state.views(global_sum(g))
    else:
        tx = make_optimizer(5e-4, 0.1, 60000, 80000)
        cfg = PAR_CFG[name]
        state = create_train_state(SEED, cfg, tx, device=PAR_DEVICE)
        if name == "ae":
            step = build_sharded_train_step(cfg, tx, rate_mode="reference")
            batch, starts = inp["ae_batch"].to(dev), inp["ae_starts"].to(dev)
        else:        # "pppf": the fused step at N = 512 (phase 15's), seeded statistics
            state.ae.load_state_dict(randomize_batchnorm(state.ae.state_dict(), SEED + 2))
            state.prob.load_state_dict(randomize_batchnorm(state.prob.state_dict(), SEED + 3))
            step = build_sharded_pppf_train_step(cfg, tx, rate_mode="reference", fused=True)
            batch, starts = inp["pf_batch"].to(dev), inp["pf_starts"].to(dev)
        run = lambda: step(state, batch, starts, TRAIN_LAM)[1]
        params = lambda: [p for _, p in state.named_parameters()]
        grads = lambda: {n: p.grad for n, p in state.named_parameters()}
    aux = run()
    out = dict(loss=float(aux["loss"]), digest=digest(params()))
    g = grads()
    if ref is None:
        out["grads"] = {n: t.detach().clone() for n, t in g.items()}
    else:
        r = ref[name]
        out["errs"] = {n: (float((t - r[n].to(dev)).abs().max()), float(r[n].abs().max()))
                       for n, t in g.items()}
    times, _, launches, _ = timed_steps(run, PAR_STEPS)
    out.update(ms=float(np.median(times)) * 1e3,
               launches={k: v // PAR_STEPS for k, v in launches.items() if v})
    return out


def par_worker(path: str, names: tuple) -> dict:
    """One rank of phases 25-26: par_case for each of `names` on this
    rank's shards, held against the one-device gradients in `path` where
    they are there."""
    inp = torch.load(path)
    out = {name: par_case(name, inp, inp.get("ref")) for name in names}
    out["rank"] = rank()
    return out


def par_grads_check(label: str, errs: dict, tol: float, loose: tuple = (),
                    loose_tol: float = TOL_BATCH_STATS) -> str:
    """Every gradient within tol of its tensor's largest one-device entry
    (loose_tol for the names starting with `loose`: through batch
    statistics); a tensor whose largest entry is below ZERO_GRAD of the
    largest of all (a zero gradient in exact arithmetic, such as a conv bias
    before a BatchNorm) within ZERO_GRAD of that instead. Returns a
    summary; raises on a failed check."""
    top = max(big for _, big in errs.values())
    worst, worst_loose, noise = 0.0, 0.0, 0
    for n, (err, big) in errs.items():
        if big < ZERO_GRAD * top:
            noise += 1
            if not err <= ZERO_GRAD * top:
                raise RuntimeError(f"{label} gradient of {n} (zero in exact arithmetic) "
                                   f"differs by {err} > {ZERO_GRAD} * {top}")
            continue
        t = loose_tol if n.startswith(loose) else tol
        if not err <= t * big:
            raise RuntimeError(f"{label} gradient of {n} differs by {err} > {t} * {big}")
        if n.startswith(loose):
            worst_loose = max(worst_loose, err / big)
        else:
            worst = max(worst, err / big)
    parts = [f"{worst:.3g}"] if loose != ("",) else []
    parts += [f"{worst_loose:.3g} through batch statistics ("
              + (", ".join(loose) if loose != ("",) else "all") + ")"] if loose else []
    return (f"gradients within {' and '.join(parts)} of each tensor's largest entry, "
            f"{noise} zero gradients within {ZERO_GRAD}")


def parallel_phases(smi: str, train_ms: float, pppe_ms: float) -> dict:
    """Phases 25-26: parallel/mesh.py's launcher on the one card. The
    one-device runs of the cases come first, in this process without a
    process group (par_case). 25: one rank on NCCL (launch(1, ...)); its
    IPDAE and PPPE steps' losses and parameters after one step, and the
    64-cloud compress -> decompress's streams and clouds, bit for bit the
    one device's; the step walls beside the one device's and phases 6 and
    21's. 26: two ranks sharing the card over gloo, each on its half of
    every batch: the IPDAE step (4 + 4 clouds), the PPPE step (2 + 2), the
    fused PPPF-AE step at N = 512 (64 + 64) and the 64-cloud compress ->
    decompress; losses to 1e-6 relative, gradients (summed over the ranks)
    within 1e-5 of each tensor's largest one-device entry (PPPF-AE's
    probability model, on batch statistics, to TOL_BATCH_STATS, phase 14's;
    PPPE's every gradient runs through batch statistics: TOL_PPPE_STEP,
    phase 22's), streams and clouds bit for bit, both ranks' parameters
    bit-equal, and each rank's launches per step or batch the one
    device's. Returns the phases' summary."""
    inp = par_inputs()
    names = ("ae", "pppe", "pppf", "codec")
    one = {name: par_case(name, inp, None) for name in names}
    log("phases 25-26, one device (no process group): " + ", ".join(
        f"{n} {one[n]['ms']:.2f} ms, launches {one[n]['launches']}" for n in names))
    # is the one-device step bitwise repeatable? (the plain stages' gather
    # backward adds with atomics on the card, in no fixed order)
    repeatable = {n: par_case(n, inp, None)["digest"] == one[n]["digest"] for n in ("ae", "pppe")}
    log(f"one-device steps bitwise repeatable (parameters after one step, run twice): "
        f"{repeatable}")
    path = os.path.join(ROOT, "_chip", "parallel_inputs.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({**inp, "ref": {n: {k: t.cpu() for k, t in one[n].pop("grads").items()}
                               for n in ("ae", "pppe", "pppf")}}, path)
    # the workers share the card with this process: hand back its cached
    # blocks (phase 12's warm-up alone peaks at 57 GiB)
    torch.cuda.empty_cache()
    summary = {"repeatable": repeatable}
    try:
        # 25. one rank on NCCL: the one-device program, bit for bit
        t0 = time.perf_counter()
        (r25,) = launch(1, par_worker, path, ("ae", "pppe", "codec"), device="cuda",
                        timeout=300)
        wall25 = time.perf_counter() - t0
        checks = {}
        for n in ("ae", "pppe"):
            if r25[n]["loss"] != one[n]["loss"]:
                raise RuntimeError(f"phase 25 {n} step: loss {r25[n]['loss']!r} vs "
                                   f"{one[n]['loss']!r}")
            # bit for bit where the one-device step repeats itself bit for bit
            if repeatable[n] and r25[n]["digest"] != one[n]["digest"]:
                raise RuntimeError(f"phase 25 {n} step: parameters differ from one device's")
            checks[n] = par_grads_check(f"phase 25 {n}", r25[n]["errs"], 1e-5)
        for k in ("streams", "decoded"):
            if r25["codec"][k] != one["codec"][k]:
                raise RuntimeError(f"phase 25: the {k} differ from one device's")
        for n in ("ae", "pppe", "codec"):
            if r25[n]["launches"] != one[n]["launches"]:
                raise RuntimeError(f"phase 25 {n}: launches {r25[n]['launches']} != "
                                   f"{one[n]['launches']}")
        log(f"phase 25, launch(1) on NCCL ({wall25:.1f} s with the spawn): losses, streams and "
            "decoded clouds bit for bit one device's; parameters after one step bit for bit "
            "where the one-device step repeats bit for bit ("
            + ", ".join(n for n in ("ae", "pppe") if repeatable[n]) + "); "
            + "; ".join(f"{n} {checks[n]}" for n in ("ae", "pppe")) + "; launches "
            f"{r25['ae']['launches']} per IPDAE step, {r25['pppe']['launches']} per PPPE step, "
            f"{r25['codec']['launches']} per compress -> decompress; IPDAE step "
            f"{r25['ae']['ms']:.2f} ms (one device {one['ae']['ms']:.2f}, phase 6 {train_ms:.2f}), "
            f"PPPE step {r25['pppe']['ms']:.2f} ms (one device {one['pppe']['ms']:.2f}, phase 21 "
            f"{pppe_ms:.2f}) on {smi}")
        summary["25"] = {n: {"ms": r25[n]["ms"], "launches": r25[n]["launches"]}
                         for n in ("ae", "pppe", "codec")}

        # 26. two ranks on one card over gloo
        t0 = time.perf_counter()
        r26 = launch(2, par_worker, path, names, device="cuda:0", backend="gloo",
                     timeout=300)
        wall26 = time.perf_counter() - t0
        checks = {}
        for r in r26:
            for n in ("ae", "pppe", "pppf"):
                la, lb = r[n]["loss"], one[n]["loss"]
                if not abs(la - lb) <= 1e-6 * abs(lb):
                    raise RuntimeError(f"phase 26 rank {r['rank']} {n} loss {la} vs {lb}")
                checks[n] = par_grads_check(
                    f"phase 26 rank {r['rank']} {n}", r[n]["errs"], 1e-5,
                    loose={"pppf": ("prob.",), "pppe": ("",)}.get(n, ()),
                    loose_tol=TOL_PPPE_STEP if n == "pppe" else TOL_BATCH_STATS)
            for k in ("streams", "decoded"):
                if r["codec"][k] != one["codec"][k]:
                    raise RuntimeError(f"phase 26 rank {r['rank']}: the {k} differ")
            for n in names:
                if r[n]["launches"] != one[n]["launches"]:
                    raise RuntimeError(f"phase 26 rank {r['rank']} {n}: launches "
                                       f"{r[n]['launches']} != {one[n]['launches']}")
        for n in ("ae", "pppe", "pppf"):
            if r26[0][n]["digest"] != r26[1][n]["digest"]:
                raise RuntimeError(f"phase 26 {n}: the ranks' parameters differ after a step")
        log(f"phase 26, launch(2) on one card over gloo ({wall26:.1f} s with the spawn): "
            + "; ".join(f"{n}: loss {r26[0][n]['loss']:.8f} vs {one[n]['loss']:.8f}, "
                        f"{checks[n]}" for n in ("ae", "pppe", "pppf"))
            + "; streams and clouds bit for bit; both ranks' parameters bit-equal")
        for r in r26:
            log(f"phase 26 rank {r['rank']}: launches "
                + ", ".join(f"{n} {r[n]['launches']}" for n in names)
                + "; walls (ms; two ranks share the card, not a speed figure) "
                + ", ".join(f"{n} {r[n]['ms']:.2f}" for n in names))
        summary["26"] = [{n: {"ms": r[n]["ms"], "launches": r[n]["launches"]} for n in names}
                         for r in r26]
    finally:
        os.remove(path)
    return summary


# --------------------------------------------------- 27-29: bf16 serving --


def bf16_bounds(fp32: float, products: float, io: float):
    """(ms with the products on the bf16 tensor cores at BF16_FLOP_PER_S and
    the rest on the CUDA cores, its 'operations' or 'bytes', ms with all of
    it in float32 on the CUDA cores)."""
    t_ops = fp32 / FP32_FLOP_PER_S + products / BF16_FLOP_PER_S
    t_bytes = io / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            bound(fp32 + products, io)[0])


def held_share(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(share of a's entries bit-equal to b's, max |a - b|, max |b|, whether
    a passes bf16_hold's figures against b)."""
    share = float((a == b).double().mean())
    err, big = float((a - b).abs().max()), float(b.abs().max())
    return share, err, big, share >= BF16_SHARE and err <= BF16_TOL * big


def bf16_hold(label: str, kern, plain) -> dict:
    """A bf16 kernel against its plain version on the same inputs: every
    output entry bf16-exact, at least BF16_SHARE of them bit-equal, every
    one within BF16_TOL of the largest |entry|, two launches bitwise equal;
    raises otherwise. Returns the output and the figures."""
    a, b = kern(), plain()
    if not torch.equal(a.to(torch.bfloat16).float(), a):
        raise RuntimeError(f"{label}: output entries that are not bf16 values")
    share, err, big, held = held_share(a, b)
    if not held:
        raise RuntimeError(f"{label} vs its plain version: {share:.4f} of the entries "
                           f"bit-equal (at least {BF16_SHARE}), max |diff| {err} "
                           f"(at most {BF16_TOL} * {big})")
    if not torch.equal(kern(), a):
        raise RuntimeError(f"two launches of {label} differ")
    return a, dict(max_abs_err=err, max_abs=big, bit_equal_share=share, repeatable=True)


def bf16_timing(held: dict, kern, plain, fp32: float, products: float, io: float,
                **extra) -> dict:
    """A bf16 instance's figures beside bf16_hold's: CUDA-event and device
    (CUDA-graph) times, the plain version's time and both bounds."""
    bms, by, bms32 = bf16_bounds(fp32, products, io)
    return dict(ms=cuda_ms(kern, 10), device_ms=graph_ms(kern, 10), plain_ms=cuda_ms(plain, 2),
                bound_ms=bms, bound_by=by, bound_fp32_ms=bms32, gflop=(fp32 + products) / 1e9,
                **held, **extra)


def bf16_log(label: str, rec: dict) -> None:
    log(f"{label}: {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms (plain "
        f"{rec['plain_ms']:.3f} ms; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} with "
        f"the products on the bf16 tensor cores, {rec['bound_fp32_ms']:.4f} ms in float32; "
        f"{rec['gflop']:.1f} GFLOP, {rec['gflop'] / rec['device_ms']:.2f} TFLOP/s); "
        f"{rec['bit_equal_share']:.5f} of the entries bit-equal to the plain version, max "
        f"|diff| {rec['max_abs_err']:.3g} of {rec['max_abs']:.3g}; two launches bitwise equal")


def seeded_latents(P: int, cfg: CodecConfig, seed: int, dev) -> torch.Tensor:
    """[P, d] quantized latents drawn from a seed over every bin, -(L // 2)
    to L // 2: the decoder's inputs where the path's symbols do not vary."""
    g = torch.Generator().manual_seed(seed)
    half = cfg.L // 2
    return torch.randint(-half, half + 1, (P, cfg.d), generator=g).to(torch.float32).to(dev)


def distinct_rows(label: str, t: torch.Tensor) -> int:
    """How many distinct rows t [P, ...] has; raises unless more than half
    of them are: a kernel held on rows that are all alike would pass while
    ignoring its input or reading the wrong row."""
    n = int(torch.unique(t.reshape(t.shape[0], -1), dim=0).shape[0])
    if 2 * n <= t.shape[0]:
        raise RuntimeError(f"{label}: only {n} distinct rows of {t.shape[0]}")
    return n


def spread_symbols(cfg: CodecConfig, ae_state: dict, clouds, dev) -> dict:
    """A copy of ae_state whose last encoder layer (IPDAE: the PointNet's
    last conv, before the max over points; PPPF-AE: enc_proj) is scaled and
    shifted per channel so that the float32 latent over these clouds'
    patches has mean 0 and standard deviation SPREAD_STD: symbols over
    every bin (the max over points commutes with the positive scale and the
    shift). PPPF-AE's encoder BatchNorm scales are first multiplied by
    PPPF_BN_GAIN, so that its feature varies between patches by more than
    a bf16 step."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    ae_state = dict(ae_state)
    if cfg.model == "PPPF-AE":
        for key, t in ae_state.items():
            if key.startswith("encoder.") and key.endswith(".weight") and t.dim() == 1:
                ae_state[key] = t * PPPF_BN_GAIN
    ae, _ = make_models(cfg32)
    ae.load_state_dict(ae_state)
    ae.to(dev).eval()
    with torch.inference_mode():
        packed = pack_encode_upload(np.stack(clouds), np.zeros(len(clouds), np.int32))
        pcs, st = unpack_encode_upload(torch.from_numpy(packed.view(np.int32)).to(dev), cfg.N)
        patches = encode_geometry(pcs, st, cfg32).patches
        if cfg.model == "AE":
            key = "pn.mlp_Modules.3.0"
            z = patch_encoder(patches, ae.sa.layers(), ae.pn.layers(), cfg.sa_knn)
        else:
            key = "enc_proj"
            z = ae.encode(patches)
    mean, std = z.mean(dim=0).cpu(), z.std(dim=0).cpu()
    scale = SPREAD_STD / std
    log(f"spread_symbols {cfg.model}: the float32 latent over {z.shape[0]} patches varies "
        f"between them by {float(std.median()):.3g} (median over channels), its channel "
        f"means by {float(mean.std()):.3g}; {key} scaled by {float(scale.median()):.4g} "
        "(median) and shifted")
    out = dict(ae_state)
    w = ae_state[key + ".weight"]
    out[key + ".weight"] = w * scale.view(-1, *[1] * (w.dim() - 1))
    out[key + ".bias"] = (ae_state[key + ".bias"] - mean) * scale
    return out


def symbol_spread(label: str, sym: np.ndarray, L: int) -> list:
    """The symbols' histogram over the L bins; raises unless at least
    L - 2 bins are used and the middle one holds at most half of them."""
    hist = np.bincount(sym.ravel().astype(np.int64), minlength=L)
    if (hist > 0).sum() < L - 2 or 2 * hist[L // 2] > hist.sum():
        raise RuntimeError(f"{label}: symbols do not spread over the bins: {hist.tolist()}")
    return hist.tolist()


def counted_path(card: Codec, clouds):
    """One uncounted, then one counted compress_many -> decompress_many,
    every launch counter set to 0 just before and read just after: (streams,
    decoded, encode ms, decode ms, launches)."""
    card.decompress_many(card.compress_many(clouds))          # warm-up, uncounted
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    streams = card.compress_many(clouds)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = card.decompress_many(streams)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    return streams, decoded, t_enc * 1e3, t_dec * 1e3, dict(cuda_lib.launches)


def path_profiles(run: dict, card: Codec, clouds, streams, label: str) -> None:
    with torch.inference_mode():
        run["encode_profile"] = profile(f"{label} encode", lambda: card.compress_many(clouds))
        run["decode_profile"] = profile(f"{label} decode", lambda: card.decompress_many(streams))


def float32_reference(cfg: CodecConfig, ae_state, prob_state, clouds, label: str) -> dict:
    """The float32 path on the bf16 phase's weights and clouds, as the bf16
    run is timed: streams, symbols (spread over the bins, symbol_spread),
    walls and profiles."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    card = Codec(cfg32, ae_state, prob_state, batch_size=len(clouds), device="cuda")
    streams, _, enc_ms, dec_ms, _ = counted_path(card, clouds)
    with torch.inference_mode():
        sym = card.encode_batch(np.stack(clouds), np.zeros(len(clouds), np.int32)).sym
    ref = dict(streams=streams, sym=sym.cpu().numpy(), encode_ms=enc_ms, decode_ms=dec_ms)
    ref["histogram"] = symbol_spread(f"{label} float32", ref["sym"], cfg.L)
    path_profiles(ref, card, clouds, streams, f"{label} float32")
    return ref


def bf16_path(card: Codec, clouds, label: str, want: dict, ref: dict):
    """One counted compress_many -> decompress_many of a bf16 codec after
    an uncounted one (counted_path): the launches must be `want` (every
    other counter 0), the skeleton and header streams the float32 run's
    bytes (`ref`, float32_reference, the same weights), the decoded symbols
    the encoded ones, spread over the bins. Returns (streams, decoded, walls,
    profiles and how far the symbols and .p.bin differ from the float32
    run's, the encoded symbols)."""
    streams, decoded, enc_ms, dec_ms, launches = counted_path(card, clouds)
    full = {name: 0 for name in cuda_lib.KERNELS}
    full.update(want)
    if launches != full:
        raise RuntimeError(f"{label} launches {launches} != {full}")
    for (p, s, c), (p32, s32, c32) in zip(streams, ref["streams"]):
        if s != s32 or c != c32:
            raise RuntimeError(f"{label}: .s.bin / .c.bin differ from the float32 run's")
    n_p = sum(p != p32 for (p, _, _), (p32, _, _) in zip(streams, ref["streams"]))
    with torch.inference_mode():
        sym = card.encode_batch(np.stack(clouds), np.zeros(len(clouds), np.int32)).sym
        sym = sym.cpu().numpy()
        if not np.array_equal(card.decode_symbols(skeletons(streams),
                                                  [p for p, _, _ in streams]), sym):
            raise RuntimeError(f"{label}: decoded symbols differ from the encoded symbols")
    run = dict(encode_ms=enc_ms, decode_ms=dec_ms, launches=want, p_bin_differ_from_f32=int(n_p),
               histogram=symbol_spread(label, sym, card.cfg.L),
               histogram_f32=ref["histogram"],
               symbols_differ_from_f32=float((sym != ref["sym"]).mean()))
    path_profiles(run, card, clouds, streams, label)
    log(f"{label}: {len(clouds)} clouds; encode {enc_ms:.1f} ms, decode {dec_ms:.1f} ms; "
        f"launches {want}, every other kernel 0; .s.bin and .c.bin the float32 run's bytes; "
        f"symbols over the bins {run['histogram']} (float32 {ref['histogram']}), "
        f"{run['symbols_differ_from_f32']:.4f} of them and {n_p} of {len(clouds)} .p.bin "
        "differ from the float32 run's; decoded symbols equal the encoded ones")
    log(f"{label} beside the float32 path on the same clouds and weights: encode "
        f"{enc_ms:.1f} vs {ref['encode_ms']:.1f} ms, decode {dec_ms:.1f} vs "
        f"{ref['decode_ms']:.1f} ms; device time (profiler) encode "
        f"{run['encode_profile']['device_ms']} vs {ref['encode_profile']['device_ms']} ms, "
        f"decode {run['decode_profile']['device_ms']} vs {ref['decode_profile']['device_ms']} ms")
    return streams, decoded, run, sym


def bf16_cpu_check(label: str, cfg: CodecConfig, ae_state, prob_state, clouds, streams,
                   sym) -> int:
    """The card's bf16 .p.bin of the first cloud(s) decoded on the CPU port
    to the card's symbols; returns how many symbols the CPU port's own bf16
    encode of them gives otherwise (reported, not held: float32 sums in
    another order move a bf16 rounding now and then)."""
    n = 2 if cfg.model == "AE" else 1
    cpu = Codec(cfg, ae_state, prob_state, batch_size=n, device="cpu")
    recs = skeletons(streams[:n])
    if not np.array_equal(cpu.decode_symbols(recs, [p for p, _, _ in streams[:n]]), sym[:n]):
        raise RuntimeError(f"{label}: the CPU port decodes the card's .p.bin to other symbols")
    cpu_sym = cpu.encode_batch(np.stack(clouds[:n]), np.zeros(n, np.int32)).sym.numpy()
    flips = int((cpu_sym != sym[:n]).sum())
    log(f"{label}: the card's .p.bin decodes on the CPU port to the card's symbols; the CPU "
        f"port's own bf16 encode gives {flips} of {cpu_sym.size} symbols otherwise")
    return flips


def bf16_ipdae_phase(dev, smi: str, clouds, ae_state, prob_state) -> tuple:
    """Phases 27-28: the IPDAE path in bf16 (CodecConfig(compute_dtype=
    "bfloat16"), 64 clouds, phase 3's weights with the last encoder layer
    calibrated by spread_symbols) with its launches (fps 1,
    patch_encoder_bf16 1, patch_decoder_bf16 1 per batch, the float32
    instances 0), streams and symbols against the float32 path on the same
    weights (bf16_path), the CPU port's decode; then the bf16 encoder and
    decoder against their plain versions on the path's own inputs
    (bf16_hold, on distinct rows), the encoder also against the replay of
    its arithmetic on REPLAY_PATCHES patches. Returns the two kernels-line
    records, the path's figures, the weights and the streams."""
    cfg = CodecConfig(compute_dtype="bfloat16")
    ae_state = spread_symbols(cfg, ae_state, clouds, dev)
    ref = float32_reference(cfg, ae_state, prob_state, clouds, "phase 27")
    card = Codec(cfg, ae_state, prob_state, batch_size=N_CLOUDS, device="cuda")
    streams, decoded, run, sym = bf16_path(
        card, clouds, "phase 27, IPDAE bf16 path",
        dict(fps=1, patch_encoder_bf16=1, patch_decoder_bf16=1), ref)
    for pc in decoded:
        if pc.shape != (cfg.S * cfg.k, 3) or not np.isfinite(pc).all():
            raise RuntimeError(f"bad decoded bf16 cloud: shape {pc.shape}")
    run["cpu_symbol_flips"] = bf16_cpu_check("phase 27", cfg, ae_state, prob_state, clouds,
                                             streams, sym)
    with torch.inference_mode():
        # 28. the bf16 encoder and decoder on the path's own inputs
        starts = np.zeros(len(clouds), np.int32)
        packed = pack_encode_upload(np.stack(clouds), starts)
        pcs, st = unpack_encode_upload(torch.from_numpy(packed.view(np.int32)).to(dev), cfg.N)
        patches = encode_geometry(pcs, st, cfg).patches
        ae = card.ae
        (sa_wb, pn_wb), knn = ae.encoder_weights(), cfg.sa_knn

        def kern_e():
            return patch_encoder(patches, sa_wb, pn_wb, knn, bf16=True)

        def plain_e():
            return patch_encoder_plain(patches, sa_wb, pn_wb, knn, bf16=True)

        a, held = bf16_hold("patch_encoder_bf16", kern_e, plain_e)
        held["distinct_rows"] = distinct_rows("patch_encoder_bf16's latents", a)
        p = patches[:REPLAY_PATCHES]
        rows = torch.arange(p.shape[1], device=dev).expand(p.shape[:2]).contiguous()
        z4 = _kernel_choices(p, select_nearest(sq_dists(p, p), knn), rows, sa_wb, pn_wb,
                             bf16=True)[-1].amax(dim=1)
        held["replay_differ"] = int((z4 != a[:REPLAY_PATCHES]).sum())
        if held["replay_differ"]:
            raise RuntimeError(f"patch_encoder_bf16: {held['replay_differ']} entries of "
                               f"{tuple(z4.shape)} differ from the replay of its arithmetic")
        P = patches.shape[0]
        flops, sa_mac, pn_mac = encoder_flops(P, cfg.K, knn, cfg.d)
        products = P * 2.0 * cfg.K * (sa_mac + pn_mac)
        io = nbytes(patches, a, *[t for wb in sa_wb + pn_wb for t in wb])
        enc_rec = dict(
            name="patch_encoder_bf16", route="cuda", source="pcc_tpu_torch/csrc/patch_encoder.cu",
            replaces="pcc_tpu/ops/sa_pallas.py:142", launches=run["launches"]["patch_encoder_bf16"],
            library_ms=None, **bf16_timing(held, kern_e, plain_e, flops - products, products, io,
                                           shape=list(patches.shape)))
        bf16_log(f"patch_encoder_bf16 {tuple(patches.shape)}", enc_rec)
        log(f"patch_encoder_bf16 vs the replay of its arithmetic on {tuple(p.shape)}: "
            f"{held['replay_differ']} entries differ; {held['distinct_rows']} distinct latent "
            f"rows of {P}")

        latent_q = (torch.from_numpy(sym).to(dev, torch.float32) - cfg.L // 2).reshape(
            -1, cfg.d).contiguous()
        h2, w3r, b3r, mlp_wb, dpacked = ae.decoder_inputs(latent_q)
        n_rows = distinct_rows("patch_decoder_bf16's h2", h2)
        k = ae.k

        def kern_d():
            return patch_decoder(h2, latent_q, w3r, b3r, mlp_wb, k, packed=dpacked, bf16=True)

        def plain_d():
            return patch_decoder_plain(h2, latent_q, w3r, b3r, mlp_wb, k, bf16=True)

        a, held = bf16_hold("patch_decoder_bf16", kern_d, plain_d)
        held["distinct_rows"] = n_rows
        (P, C), d = h2.shape, latent_q.shape[1]
        products = 2.0 * P * k * (C * 128 + (128 + d) * 128 + 128 * 64 + 64 * 32 + 32 * 3)
        io = nbytes(h2, latent_q, a, w3r, b3r, *[t for wb in mlp_wb for t in wb])
        h2b, w3b = h2.to(torch.bfloat16), w3r.to(torch.bfloat16)
        dec_rec = dict(
            name="patch_decoder_bf16", route="cuda", source="pcc_tpu_torch/csrc/patch_decoder.cu",
            replaces="pcc_tpu/ops/decoder_pallas.py:30",
            launches=run["launches"]["patch_decoder_bf16"],
            # no PyTorch call computes the decoder; the yardstick is its
            # expansion product alone (82% of the operations) in bf16, as
            # the float32 decoder's record takes it in float32
            library_ms=cuda_ms(lambda: torch.matmul(h2b, w3b), 10),
            library_call="torch.matmul(h2, w3r) in bf16: the expansion product alone",
            **bf16_timing(held, kern_d, plain_d, 0.0, products, io, shape=[P, C, d, k]))
        bf16_log(f"patch_decoder_bf16 h2 {tuple(h2.shape)} k {k} d {d}", dec_rec)
        # the tile plan's bytes from L2, a count and no measurement: logged,
        # not in the kernels line
        l2 = bf16_tma_bytes(P, C, k, torch.cuda.get_device_properties(0).multi_processor_count)
        log(f"patch_decoder_bf16: {n_rows} distinct h2 rows of {P}; {dec_rec['library_call']} "
            f"{dec_rec['library_ms']:.4f} ms; {l2 / 1e9:.3f} GB from L2 by the tile plan")
    return enc_rec, dec_rec, run, ae_state, streams


def bf16_pppf_phase(dev, smi: str, pppf32: dict) -> tuple:
    """Phase 29: the PPPF-AE path in bf16 on phase 9's clouds and weights,
    enc_proj calibrated by spread_symbols: launches (pppf_sa_stage_bf16 3,
    fps 3, fps_int 6, the float32 stage 0), streams and symbols against the
    float32 path on the same weights (bf16_path), the CPU port's decode;
    the bf16 stage against its plain version at the path's three stage
    shapes (bf16_hold). Returns the stage's kernels-line record, the path's
    figures and the weights."""
    cfg = CodecConfig(model="PPPF-AE", compute_dtype="bfloat16")
    clouds, prob_state = pppf32["clouds"], pppf32["prob_state"]
    ae_state = spread_symbols(cfg, pppf32["ae_state"], clouds, dev)
    ref = float32_reference(cfg, ae_state, prob_state, clouds, "phase 29")
    card = Codec(cfg, ae_state, prob_state, batch_size=len(clouds), device="cuda")
    streams, decoded, run, sym = bf16_path(
        card, clouds, "phase 29, PPPF-AE bf16 path",
        dict(pppf_sa_stage_bf16=3, fps=3, fps_int=6), ref)
    for pc in decoded:
        if pc.shape != (cfg.S * cfg.d * cfg.d, 3) or not np.isfinite(pc).all():
            raise RuntimeError(f"bad decoded bf16 PPPF-AE cloud: shape {pc.shape}")
    run["cpu_symbol_flips"] = bf16_cpu_check("phase 29", cfg, ae_state, prob_state, clouds,
                                             streams, sym)
    stages = []
    with torch.inference_mode():
        starts = np.zeros(len(clouds), np.int32)
        packed = pack_encode_upload(np.stack(clouds), starts)
        pcs, st = unpack_encode_upload(torch.from_numpy(packed.view(np.int32)).to(dev), cfg.N)
        xyz, feat = encode_geometry(pcs, st, cfg).patches, None
        for name in ("sa1", "sa2", "sa3"):
            sa = getattr(card.ae.encoder, name)
            new_xyz = sa.queries(xyz).contiguous()
            layers = sa.bf16_layers()
            kw = dict(nsample=sa.nsample, radius=sa.radius, bf16=True)

            def kern(new_xyz=new_xyz, xyz=xyz, feat=feat, layers=layers, kw=kw):
                return pppf_sa_fused(new_xyz, xyz, feat, layers, **kw)

            def plain(new_xyz=new_xyz, xyz=xyz, feat=feat, layers=layers, kw=kw):
                return pppf_sa_plain(new_xyz, xyz, feat, layers, **kw)

            a, held = bf16_hold(f"pppf_sa_stage_bf16 {name}", kern, plain)
            # the kernel bit for bit against the bf16 replay of its
            # arithmetic on REPLAY_PATCHES patches
            sl = slice(0, REPLAY_PATCHES)
            rep = pppf_sa_points(new_xyz[sl], xyz[sl], None if feat is None else feat[sl],
                                 layers, nsample=sa.nsample, radius=sa.radius, replay=True,
                                 bf16=True)
            held["replay_differ"] = int((rep != a[sl]).sum())
            if held["replay_differ"]:
                raise RuntimeError(f"pppf_sa_stage_bf16 {name}: {held['replay_differ']} entries "
                                   f"of {tuple(rep.shape)} differ from the bf16 replay of its "
                                   "arithmetic")
            del rep
            P, S, _ = new_xyz.shape
            N = xyz.shape[1]
            widths = [layers[0][0].shape[0]] + [lay[0].shape[1] for lay in layers]
            flops = stage_flops(P, S, N, sa.nsample, widths)
            products = P * N * 2.0 * sum(a_ * b_ for a_, b_ in zip(widths[:-1], widths[1:]))
            ins = [new_xyz] + ([xyz] if new_xyz is not xyz else []) \
                + ([] if feat is None else [feat]) + [t for lay in layers for t in lay]
            rec = bf16_timing(held, kern, plain, flops - products, products, nbytes(*ins, a),
                              shape=[P, S, N, widths], nsample=sa.nsample)
            bf16_log(f"pppf_sa_stage_bf16 {name} new_xyz {tuple(new_xyz.shape)} xyz "
                     f"{tuple(xyz.shape)} widths {widths} nsample {sa.nsample}", rec)
            log(f"pppf_sa_stage_bf16 {name} vs the bf16 replay of its arithmetic on "
                f"{REPLAY_PATCHES} patches: {held['replay_differ']} entries differ")
            stages.append(dict(stage=name, **rec))
            feat, xyz = a, new_xyz
    stage_rec = dict(
        name="pppf_sa_stage_bf16", route="cuda", source="pcc_tpu_torch/csrc/pppf_sa_stage.cu",
        replaces="pcc_tpu/ops/pppf_sa_pallas.py:45", launches=run["launches"]["pppf_sa_stage_bf16"],
        max_abs_err=max(r["max_abs_err"] for r in stages),
        bit_equal_share=min(r["bit_equal_share"] for r in stages),
        ms=sum(r["ms"] for r in stages), plain_ms=sum(r["plain_ms"] for r in stages),
        bound_ms=sum(r["bound_ms"] for r in stages), bound_by=stages[-1]["bound_by"],
        bound_fp32_ms=sum(r["bound_fp32_ms"] for r in stages),
        device_ms=sum(r["device_ms"] for r in stages), library_ms=None, stages=stages)
    return stage_rec, run, dict(ae_state=ae_state, prob_state=prob_state)


def bf16_cli_phase(clouds, states: dict, streams27) -> dict:
    """Phase 29's CLIs: compress --bf16 -> decompress --bf16 on
    BF16_CLI_CLOUDS PLY files of phase 3's clouds for each family, on
    phases 27 and 29's weights (`states`: model -> (ae_state, prob_state)),
    written as pcc_tpu's ae.pkl / prob.pkl into each family's model folder:
    launches per run, decoded clouds finite, and the IPDAE .p.bin, .s.bin
    and .c.bin the bytes phase 27 wrote for the same clouds (each cloud's
    symbols do not depend on its batch). Files under _chip/, removed
    after."""
    import pickle
    import shutil
    import tempfile

    from pcc_tpu_torch.cli import compress, decompress
    from pcc_tpu_torch.io import read_point_cloud, save_point_cloud
    from pcc_tpu_torch.weights import to_jax_params

    n = BF16_CLI_CLOUDS
    os.makedirs(os.path.join(ROOT, "_chip"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="bf16_", dir=os.path.join(ROOT, "_chip"))
    out = {}
    try:
        for i, pc in enumerate(clouds[:n]):
            save_point_cloud(pc, f"c{i}.ply", path=os.path.join(work, "in"))
        want = {"AE": (dict(fps=1, patch_encoder_bf16=1), dict(patch_decoder_bf16=1)),
                "PPPF-AE": (dict(fps=3, fps_int=3, pppf_sa_stage_bf16=3), dict(fps_int=3))}
        for model, (w_comp, w_dec) in want.items():
            comp, dec = os.path.join(work, model + "_c"), os.path.join(work, model + "_d")
            folder = os.path.join(work, model + "_m")
            os.makedirs(folder)
            for fname, tree in zip(("ae.pkl", "prob.pkl"), to_jax_params(*states[model])):
                with open(os.path.join(folder, fname), "wb") as f:
                    pickle.dump(tree, f)
            flags = ["--model", model, "--bf16"]
            wall_c, l_c = run_cli(f"phase 29 compress --bf16 --model {model}", compress.main,
                                  [os.path.join(work, "in", "*.ply"), comp, folder, *flags])
            wall_d, l_d = run_cli(f"phase 29 decompress --bf16 --model {model}",
                                  decompress.main, [comp, dec, folder, *flags])
            for got, w, what in ((l_c, w_comp, "compress"), (l_d, w_dec, "decompress")):
                full = {name: 0 for name in cuda_lib.KERNELS}
                full.update(w)
                if got != full:
                    raise RuntimeError(f"{model} {what} --bf16 launches {got} != {full}")
            outs = sorted(os.listdir(dec))
            if len(outs) != n or not all(np.isfinite(read_point_cloud(os.path.join(dec, f))).all()
                                         for f in outs):
                raise RuntimeError(f"{model} decompress --bf16 wrote {outs}")
            if model == "AE":
                for i in range(n):
                    for ext, blob in zip((".p.bin", ".s.bin", ".c.bin"), streams27[i]):
                        with open(os.path.join(comp, f"c{i}.ply{ext}"), "rb") as f:
                            if f.read() != blob:
                                raise RuntimeError(f"compress --bf16: c{i}.ply{ext} differs "
                                                   "from phase 27's stream")
            out[model] = dict(compress_ms=wall_c, decompress_ms=wall_d)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 29 CLIs: {n} clouds per family, compress --bf16 -> decompress --bf16, "
        "launches as the paths', decoded clouds finite, the IPDAE streams phase 27's bytes; "
        + json.dumps(out))
    return out


def cpu_skeleton_streams(card: Codec, clouds, starts) -> list:
    """The CPU port's .s.bin and .c.bin of clouds (the same upload, normalize,
    FPS, octree analysis and serializer as Codec.compress_many, run on the
    CPU, batched by size as it batches; the latents' stream is not made):
    [(s, c)] in input order."""
    import pcc_tpu_torch.codec as codec_mod
    from pcc_tpu_torch.coding.octree import octree_analyze
    from pcc_tpu_torch.ops.normalize import normalize

    cfg = card.cfg
    out = [None] * len(clouds)
    by_n: dict = {}
    for i, pc in enumerate(clouds):
        by_n.setdefault(pc.shape[0], []).append(i)
    for N, idxs in by_n.items():
        c = cfg.with_n(N)
        for lo in range(0, len(idxs), card.batch_size):
            batch = idxs[lo:lo + card.batch_size]
            packed = pack_encode_upload(np.stack([clouds[i] for i in batch]),
                                        np.asarray([starts[i] for i in batch], np.int32))
            t = torch.from_numpy(packed.view(np.int32))
            pcs, st = unpack_encode_upload(t, N)
            pc01, center, longest = normalize(pcs, c.margin, codec_mod.upload_values(t, N))
            idx = fps_plain(pc01.contiguous(), c.S, st)
            sampled = torch.gather(pc01, 1, idx.long()[..., None].expand(-1, -1, 3))
            octree = octree_analyze(sampled, c.N, c.min_bpp, c.max_depth)
            B = len(batch)
            res = codec_mod.EncodeResult(
                sym=torch.zeros((B, c.S, c.d), dtype=torch.int8),
                weights=torch.full((B, c.S, c.d, c.L), (1 << 16) // c.L, dtype=torch.int32),
                sorted_codes=octree.sorted_codes, depth=octree.depth, center=center,
                longest=longest)
            for i, (_, s_bytes, c_bytes) in zip(batch, card.serialize(res)):
                out[i] = (s_bytes, c_bytes)
    return out


def large_scene_phase(dev, ae_state, prob_state, cpu: Codec) -> tuple:
    """Phase 30: eval/gen_rooms.py's rooms (ROOM_SIZES, seeded) through
    Codec.compress_many -> decompress_many at --batch_size ROOM_BATCH on
    phase 3's random weights, S = 512 and 781: launches (fps and
    patch_encoder once per batch, patch_decoder once per decode batch),
    every FPS call bit-equal to fps_plain and timed (fps_check: ms, device
    ms, bound), .s.bin / .c.bin byte-equal to the CPU port's
    (cpu_skeleton_streams), the card's .p.bin decoded on the CPU port to the
    card's symbols, which equal the encoder's, decoded clouds [S * k, 3]
    finite. Returns (the FPS records, a summary)."""
    cfg = CodecConfig()
    clouds = rooms(ROOM_SIZES, SEED)
    card = Codec(cfg, ae_state, prob_state, batch_size=ROOM_BATCH, device="cuda")
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    with recording_fps() as calls:
        t0 = time.perf_counter()
        streams = card.compress_many(clouds)
        t_enc = time.perf_counter() - t0
    enc_launches = dict(cuda_lib.launches)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    decoded = card.decompress_many(streams)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    dec_launches = dict(cuda_lib.launches)
    batches = len(calls)
    for got, want, what in ((enc_launches, want_launches(batches, fps=1, patch_encoder=1),
                             "compress"),
                            (dec_launches, want_launches(batches, patch_decoder=1), "decompress")):
        if got != want:
            raise RuntimeError(f"large-scene {what} launches {got} != {want}")
    for pc, room in zip(decoded, clouds):
        S = cfg.with_n(room.shape[0]).S
        if pc.shape != (S * cfg.k, 3) or not np.isfinite(pc).all():
            raise RuntimeError(f"large-scene decode of {room.shape[0]} points: {pc.shape}")
    cpu_sc = cpu_skeleton_streams(card, clouds, [0] * len(clouds))
    for j, ((_, s, c), (s_cpu, c_cpu)) in enumerate(zip(streams, cpu_sc)):
        if s != s_cpu or c != c_cpu:
            raise RuntimeError(f"room {j}: the card's .s.bin/.c.bin differ from the CPU port's")
    fps_recs = []
    with torch.inference_mode():
        for call in calls:
            B, N = call[1].shape[:2]
            fps_recs.append(fps_check(f"large-scene rooms, {B} of {N} points", call))
        lo = 0
        for call in calls:
            B, N = call[1].shape[:2]
            idxs = list(range(lo, lo + B))
            lo += B
            group = [streams[i] for i in idxs]
            recs = skeletons(group)
            sym = card.encode_batch(np.stack([clouds[i] for i in idxs]),
                                    np.zeros(B, np.int32)).sym.cpu().numpy()
            for who, codec in (("card", card), ("CPU port", cpu)):
                got = codec.decode_symbols(recs, [p for p, _, _ in group])
                if not np.array_equal(got, sym):
                    raise RuntimeError(f"rooms of {N} points: the {who} decodes the card's "
                                       ".p.bin to other symbols than the encoder's")
    bpp = [8 * (len(p) + len(s) + len(c)) / room.shape[0]
           for (p, s, c), room in zip(streams, clouds)]
    summary = dict(rooms=list(ROOM_SIZES), batch_size=ROOM_BATCH, encode_ms=t_enc * 1e3,
                   decode_ms=t_dec * 1e3, launches_compress=enc_launches,
                   launches_decompress=dec_launches, mean_bpp=float(np.mean(bpp)))
    log(f"phase 30, large-scene rooms {list(ROOM_SIZES)} at batch {ROOM_BATCH}: encode "
        f"{t_enc * 1e3:.1f} ms, decode {t_dec * 1e3:.1f} ms, {np.mean(bpp):.4f} bits per "
        "point; FPS bit-equal to fps_plain, .s.bin/.c.bin byte-equal to the CPU port's, "
        "the card's .p.bin decoded on the card and on the CPU to the encoder's symbols")
    return fps_recs, summary


@contextlib.contextmanager
def recording_bf16_reduce(grids: list):
    """Record the inputs of every bf16_reduce call (the bf16 step's bias and
    tiled-feature gradients) while active."""
    import pcc_tpu_torch.ops.bf16 as bf16_mod

    reduce = bf16_mod.bf16_reduce

    def recording(g, cols=1):
        # clone keeps a permuted view's strides, as the kernel reads them
        grids.append((g.detach().clone(), cols))
        return reduce(g, cols)

    bf16_mod.bf16_reduce = recording
    try:
        yield
    finally:
        bf16_mod.bf16_reduce = reduce


def bf16_train_phase(dev, smi: str) -> tuple:
    """Phase 31: the bf16 IPDAE train step (CodecConfig(compute_dtype=
    "bfloat16"), build_train_step as cli/train.py --bf16 builds it) on
    TRAIN_CLOUDS clouds of 8192 points: one uncounted and TRAIN_STEPS counted
    steps, launches per step fps 1, patch_encoder_bf16 1, patch_encoder_bwd_bf16
    1, chamfer_fwd 1, chamfer_bwd 1 and bf16_reduce as many times each step
    (the levels of the decoder's and probability model's bias gradients),
    every other kernel 0; finite losses, parameters moved; median step
    time, points/s, peak memory, one step under torch.profiler; then one
    more step recording the encoder backward's and bf16_reduce's inputs.
    Returns (the recordings, the summary)."""
    cfg = CodecConfig(compute_dtype="bfloat16")
    B = TRAIN_CLOUDS
    batch = torch.from_numpy(np.stack(synthetic_clouds(B, cfg.N, SEED))).to(dev)
    tx = make_optimizer(5e-4, 0.1, 60000, 80000)
    state = create_train_state(SEED, cfg, tx, device="cuda")
    step = build_train_step(cfg, tx, rate_mode="reference")
    gen = torch.Generator().manual_seed(SEED + 1)

    def starts():
        return torch.randint(0, cfg.N, (B,), generator=gen, dtype=torch.int32).to(dev)

    before = [p.detach().clone() for _, p in state.named_parameters()]
    step(state, batch, starts(), TRAIN_LAM)                    # warm-up, uncounted
    times, auxes, launches, peak = timed_steps(
        lambda: step(state, batch, starts(), TRAIN_LAM)[1], TRAIN_STEPS)
    per = launches["bf16_reduce"] // TRAIN_STEPS
    want = want_launches(TRAIN_STEPS, fps=1, patch_encoder_bf16=1, patch_encoder_bwd_bf16=1,
                         chamfer_fwd=1, chamfer_bwd=1, bf16_reduce=per)
    if per <= 0 or launches != want:
        raise RuntimeError(f"bf16 train launches {launches} != {want}")
    losses = torch.stack([a["loss"] for a in auxes]).cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite bf16 train loss: {losses}")
    moved = sum(not torch.equal(a, p.detach()) for a, (_, p) in
                zip(before, state.named_parameters()))
    if moved == 0:
        raise RuntimeError("no parameter moved in bf16 training")
    ms = float(np.median(times)) * 1e3
    log(f"phase 31, bf16 train: {B} clouds x {cfg.N} points per step; launches over "
        f"{TRAIN_STEPS} steps {launches}; median step {ms:.2f} ms (steps {min(times) * 1e3:.2f} "
        f"to {max(times) * 1e3:.2f} ms), {B * cfg.N / (ms / 1e3):.0f} points/s on {smi}; "
        f"peak memory {peak:.2f} GiB; losses {losses[0]:.6f} -> {losses[-1]:.6f}; {moved} of "
        f"{len(before)} parameter tensors moved")
    prof = profile("bf16 train step", lambda: step(state, batch, starts(), TRAIN_LAM), top=14)
    rec, grids = {}, []
    with recording_encoder_bwd(rec), recording_bf16_reduce(grids):
        step(state, batch, starts(), TRAIN_LAM)
    summary = dict(step_ms=ms, points_per_s=B * cfg.N / (ms / 1e3), peak_gib=peak,
                   launches_per_step={k: v // TRAIN_STEPS for k, v in launches.items() if v},
                   profile=prof)
    return rec, grids, launches, summary


def bf16_backward_check(rec: dict, launches: dict) -> dict:
    """Phase 32: the bf16 encoder backward kernel vs its plain version on
    phase 31's recorded step (patches [512, 256, 3], the winners its forward
    handed over, its cotangent, the float32 weights): the forward's winners
    again the step's, the plain version's on REPLAY_PATCHES patches, its
    latent bit for bit the serving instance's; every backward output within
    TOL_BWD of the plain version's largest entry, two launches bitwise
    equal; CUDA-event and device times, the plain version's, the bound
    (the winners' rows' work with the products on the bf16 tensor cores, and
    in float32), the forward's time with its winners half and without, and
    its plain version's with the winners."""
    cfg = CodecConfig()
    knn = cfg.sa_knn
    patches, win, g = rec["patches"], rec["winners"], rec["g"]
    sa_wb, pn_wb = _unflatten(rec["wb"])
    sa16, pn16 = bf16_wb(sa_wb), bf16_wb(pn_wb)
    with torch.no_grad():
        lat, again = patch_encoder(patches, sa_wb, pn_wb, knn, return_winners=True, bf16=True)
        if not torch.equal(again, win):
            raise RuntimeError("patch_encoder_bf16's winners differ from the step's")
        if not torch.equal(lat, patch_encoder(patches, sa16, pn16, knn, bf16=True)):
            raise RuntimeError("patch_encoder_bf16's latent with winners differs from serving's")
        p = patches[:REPLAY_PATCHES]
        plain_win = patch_encoder_plain(p, sa_wb, pn_wb, knn, return_winners=True, bf16=True)[1]
        if not torch.equal(plain_win, win[:REPLAY_PATCHES]):
            n = int((plain_win != win[:REPLAY_PATCHES]).sum())
            raise RuntimeError(f"{n} of patch_encoder_bf16's winners differ from the plain "
                               "version's")
    kern = lambda: flat_grads(patch_encoder_bwd(patches, g, sa_wb, pn_wb, knn,  # noqa: E731
                                                winners=win, bf16=True))
    plain = lambda: flat_grads(patch_encoder_bwd_plain(patches, g, sa_wb, pn_wb,  # noqa: E731
                                                       knn, winners=win, bf16=True))
    a, b = kern(), plain()
    rel = []
    for x, y in zip(a, b):
        err, big = float((x - y).abs().max()), float(y.abs().max())
        if not err <= TOL_BWD * big:
            raise RuntimeError(f"patch_encoder_bwd_bf16 differs from the plain version on "
                               f"{tuple(y.shape)}: {err} > {TOL_BWD} * {big}")
        rel.append(err / big if big else 0.0)
    if not all(torch.equal(x, y) for x, y in zip(a, kern())):
        raise RuntimeError("two launches of patch_encoder_bwd_bf16 differ")
    P, K = patches.shape[:2]
    _, sa_mac, pn_mac = encoder_flops(P, K, knn, cfg.d)
    rows = sum(len(torch.unique(r)) for r in win)
    flops = 2.0 * rows * (pn_mac + sa_mac) + 4.0 * rows * (pn_mac + sa_mac - (knn - 1) * 64 * 128)
    w_bytes = nbytes(*[t for wb in sa_wb + pn_wb for t in wb])
    bms, by, bms32 = bf16_bounds(0.0, flops, 2 * nbytes(patches) + nbytes(g, win) + 2 * w_bytes)
    fwd_ms = cuda_ms(lambda: patch_encoder(patches, sa16, pn16, knn, bf16=True), 5)
    fwd_win_ms = cuda_ms(lambda: patch_encoder(patches, sa_wb, pn_wb, knn, return_winners=True,
                                               bf16=True), 5)
    fwd_win_plain_ms = cuda_ms(lambda: patch_encoder_plain(patches, sa_wb, pn_wb, knn,
                                                           return_winners=True, bf16=True), 1)
    out = dict(
        name="patch_encoder_bwd_bf16", route="cuda",
        source="pcc_tpu_torch/csrc/patch_encoder_bwd.cu",
        replaces="pcc_tpu/ops/sa_pallas.py:504", launches=launches["patch_encoder_bwd_bf16"],
        max_abs_err=max(float((x - y).abs().max()) for x, y in zip(a, b)), rel_err=rel,
        ms=cuda_ms(kern, 5), device_ms=graph_ms(kern, 5), plain_ms=cuda_ms(plain, 1),
        bound_ms=bms, bound_by=by, bound_fp32_ms=bms32, library_ms=None, winning_rows=rows,
        gflop=flops / 1e9, forward_ms=fwd_ms, forward_winners_ms=fwd_win_ms,
        forward_winners_plain_ms=fwd_win_plain_ms)
    log(f"phase 32, patch_encoder_bwd_bf16 on {tuple(patches.shape)}: {out['ms']:.4f} ms, "
        f"device {out['device_ms']:.4f} ms (plain {out['plain_ms']:.3f} ms; bound "
        f"{bms:.4f} ms by {by} on the bf16 tensor cores, {bms32:.4f} ms in float32; {rows} "
        f"winning rows, {flops / 1e9:.2f} GFLOP); per output max |kernel - plain| / max "
        f"|plain| {max(rel):.3g} (limit {TOL_BWD}); two launches bitwise equal; winners the "
        f"step's and the plain version's; the forward {fwd_ms:.4f} ms, with its winners half "
        f"{fwd_win_ms:.4f} ms (its plain version {fwd_win_plain_ms:.3f} ms)")
    return out


def bf16_reduce_check(grids: list, launches: dict) -> dict:
    """Phase 32, bf16_reduce: one launch a call of phase 31's step, and
    every recorded call (the bias and tiled-feature gradients, their
    cotangents unrounded and as the step hands them, permuted views
    included) bit-equal to its plain version, twice; CUDA-event and device
    times summed over the step's calls, the plain version's, and the bound
    (each cotangent read once, its rows' adds)."""
    from pcc_tpu_torch.ops.bf16 import bf16_reduce, bf16_reduce_plain

    per = launches["bf16_reduce"] // TRAIN_STEPS
    if per != len(grids):
        raise RuntimeError(f"bf16_reduce: {per} launches a step for {len(grids)} calls")
    for x, cols in grids:
        out = bf16_reduce(x, cols)
        if not torch.equal(out, bf16_reduce_plain(x, cols)):
            raise RuntimeError(f"bf16_reduce differs from its plain version on {tuple(x.shape)}")
        if not torch.equal(out, bf16_reduce(x, cols)):
            raise RuntimeError(f"two launches of bf16_reduce differ on {tuple(x.shape)}")
    ms = sum(cuda_ms(lambda x=x, c=c: bf16_reduce(x, c), 10) for x, c in grids)
    device_ms = sum(graph_ms(lambda x=x, c=c: bf16_reduce(x, c), 10) for x, c in grids)
    plain_ms = sum(cuda_ms(lambda x=x, c=c: bf16_reduce_plain(x, c), 1) for x, c in grids)
    bms, by = bound(sum(x.numel() for x, _ in grids), sum(nbytes(x) for x, _ in grids))
    out = dict(name="bf16_reduce", route="cuda", source="pcc_tpu_torch/csrc/bf16_reduce.cu",
               replaces="none: XLA's bf16 reduce_sum of a flax Dense bias gradient in "
                        "pcc_tpu's bf16 step (pcc_tpu/models/layers.py:48; no pallas_call)",
               launches=launches["bf16_reduce"], max_abs_err=0.0, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
               calls_per_step=len(grids),
               shapes=[[list(x.shape), list(x.stride()), c] for x, c in grids])
    log(f"phase 32, bf16_reduce: {len(grids)} calls a step in {per} launches, bit-equal to "
        f"the plain version; {ms:.4f} ms for the step's calls, device {device_ms:.4f} ms "
        f"(plain {plain_ms:.2f} ms, bound {bms:.5f} ms by {by})")
    return out


def cert_model_check() -> dict:
    """Phase 32, certified.cuh's model of the bf16 tensor cores
    (ops/certified.py::model_sums on csrc/cert_model.cu): on the stress
    rows of every kind and depth, the k-order sum within an ulp of the
    plain fused multiply-add chain and every tensor-core sum within the
    certificate's bound E of it; the largest |s_tc - s_k| / E by kind and
    depth. Raises where a ratio exceeds 1: the bf16 encoder and "pppf"
    stage would then not be certified on this card."""
    from pcc_tpu_torch.ops.certified import (STRESS_DEPTHS, STRESS_KINDS, model_ratio,
                                             model_sums, stress_rows)

    dev = torch.device("cuda", 0)
    ratios = {}
    for kind in STRESS_KINDS:
        for k in STRESS_DEPTHS:
            x, w = stress_rows(kind, k, seed=k)
            s_tc, s_k, err = model_sums(x.to(dev), w.to(dev))
            ref = fma_matmul(x, w)
            if not bool(((s_k.cpu() - ref).abs() <= ref.abs() * 2.0 ** -23 + 2.0 ** -149).all()):
                raise RuntimeError(f"cert_model: s_k is not the k-order sum ({kind}, K = {k})")
            ratios[f"{kind} K={k}"] = model_ratio(s_tc, s_k, err)
    worst = max(ratios.values())
    log(f"phase 32, certified.cuh's model on the card: largest |s_tc - s_k| / E {worst:.6g} "
        f"over {len(ratios)} stress cases of 64 x 16 entries (limit 1); " + json.dumps(ratios))
    if not worst <= 1.0:
        raise RuntimeError(f"certified.cuh's model fails on this card: |s_tc - s_k| / E = {worst}")
    return dict(largest_ratio=worst, ratios=ratios)


def bf16_step_card_vs_cpu(dev) -> dict:
    """Phase 33: one bf16 train step at TINY on the card and on the CPU port
    from the same weights and FPS starts (the card's step launches
    patch_encoder_bf16, patch_encoder_bwd_bf16 and the chamfer kernels once
    each): loss to 1e-5 relative, each gradient within its bound of the CPU
    port's largest entry (the encoder's TOL_BF16_ENC, flax's weights'
    TOL_BF16_GRAD, flax's biases' TOL_BF16_BIAS), the parameters after Adam
    within 2 lr of the CPU port's, BF16_PARAM_SHARE of them within 1e-6."""
    cfg = CodecConfig(**TINY, compute_dtype="bfloat16")
    lr = 1e-3
    tx = make_optimizer(lr, 0.1, 10, 10)
    card = create_train_state(SEED, cfg, tx, device="cuda")
    cpu = create_train_state(SEED, cfg, tx, device="cpu")
    batch = torch.from_numpy(np.stack(synthetic_clouds(2, cfg.N, SEED)))
    starts = torch.tensor([0, 77], dtype=torch.int32)
    step = build_train_step(cfg, tx, rate_mode="fixed")
    before = dict(cuda_lib.launches)
    _, a = step(card, batch.to(dev), starts.to(dev), 1e-2)
    torch.cuda.synchronize()
    for name in ("patch_encoder_bf16", "patch_encoder_bwd_bf16", "chamfer_fwd", "chamfer_bwd"):
        if cuda_lib.launches[name] != before[name] + 1:
            raise RuntimeError(f"TINY bf16 step: {name} launched "
                               f"{cuda_lib.launches[name] - before[name]} times, not once")
    _, b = step(cpu, batch, starts, 1e-2)
    la, lb = float(a["loss"]), float(b["loss"])
    if not abs(la - lb) <= 1e-5 * abs(lb):
        raise RuntimeError(f"TINY bf16 train step loss: card {la} vs CPU {lb}")
    worst = {}
    diffs = []
    for (name, p), (_, q) in zip(card.named_parameters(), cpu.named_parameters()):
        encoder = name.startswith(("ae.sa.", "ae.pn."))
        tol = TOL_BF16_ENC if encoder else TOL_BF16_BIAS if name.endswith("bias") \
            else TOL_BF16_GRAD
        err, big = float((p.grad.cpu() - q.grad).abs().max()), float(q.grad.abs().max())
        if not err <= tol * big:
            raise RuntimeError(f"TINY bf16 step gradient of {name}: card and CPU differ by "
                               f"{err} > {tol} * {big}")
        worst[name] = err / big if big else 0.0
        diffs.append((p.detach().cpu() - q.detach()).abs().reshape(-1))
    diffs = torch.cat(diffs)
    share = float((diffs <= 1e-6).double().mean())
    if not (float(diffs.max()) <= 2 * lr + 1e-6 and share >= BF16_PARAM_SHARE):
        raise RuntimeError(f"TINY bf16 step parameters: max diff {float(diffs.max())}, "
                           f"{share:.4f} within 1e-6")
    out = dict(loss_card=la, loss_cpu=lb, worst_rel_grad=max(worst.values()),
               params_within_1e6=share, params_max_diff=float(diffs.max()))
    log(f"phase 33, bf16 train step at TINY, card vs CPU port: loss {la:.8f} vs {lb:.8f}, "
        f"worst gradient {out['worst_rel_grad']:.3g} of its largest entry, parameters "
        f"{share:.5f} within 1e-6, at most {out['params_max_diff']:.3g} apart")
    return out


def bf16_train_cli_phase(clouds) -> dict:
    """Phase 34: cli/train.py --bf16 --max_steps 3 (batch TRAIN_CLOUDS, one
    device) on PLY files of phase 3's clouds into compress --bf16 and
    decompress --bf16 on the checkpoint it writes (ae.pkl / prob.pkl, float32
    pickles of pcc_tpu's layout); launches per run (the train run's encoder
    and its backward in bf16 once per step), decoded clouds finite; files
    under _chip/, removed after. The same CLIs refuse --model PPPF-AE --bf16
    and --devices 2 --bf16."""
    import shutil
    import tempfile

    from pcc_tpu_torch.cli import compress, decompress, train
    from pcc_tpu_torch.io import read_point_cloud, save_point_cloud

    os.makedirs(os.path.join(ROOT, "_chip"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="bf16_train_", dir=os.path.join(ROOT, "_chip"))
    steps = 3
    try:
        for i, pc in enumerate(clouds[:TRAIN_CLOUDS]):
            save_point_cloud(pc, f"c{i}.ply", path=os.path.join(work, "in"))
        model = os.path.join(work, "model")
        flags = ["--train_glob", os.path.join(work, "in", "*.ply"), "--model_save_folder", model,
                 "--batch_size", str(TRAIN_CLOUDS), "--step_window", str(steps), "--bf16"]
        wall_t, l_t = run_cli("phase 34 train --bf16", train.main,
                              flags + ["--max_steps", str(steps)])
        want = want_launches(steps, fps=1, patch_encoder_bf16=1, patch_encoder_bwd_bf16=1,
                             chamfer_fwd=1, chamfer_bwd=1,
                             bf16_reduce=l_t["bf16_reduce"] // steps)
        if l_t != want or l_t["bf16_reduce"] <= 0:
            raise RuntimeError(f"train --bf16 launches {l_t} != {want}")
        for name in ("ae.pkl", "prob.pkl"):
            if not os.path.exists(os.path.join(model, name)):
                raise RuntimeError(f"train --bf16 wrote no {name}")
        comp, dec = os.path.join(work, "comp"), os.path.join(work, "dec")
        wall_c, l_c = run_cli("phase 34 compress --bf16", compress.main,
                              [os.path.join(work, "in", "*.ply"), comp, model, "--bf16"])
        wall_d, l_d = run_cli("phase 34 decompress --bf16", decompress.main,
                              [comp, dec, model, "--bf16"])
        for got, w, what in ((l_c, dict(fps=1, patch_encoder_bf16=1), "compress"),
                             (l_d, dict(patch_decoder_bf16=1), "decompress")):
            if got != want_launches(1, **w):
                raise RuntimeError(f"{what} --bf16 on the bf16 checkpoint: launches {got}")
        outs = sorted(os.listdir(dec))
        if len(outs) != TRAIN_CLOUDS or not all(
                np.isfinite(read_point_cloud(os.path.join(dec, f))).all() for f in outs):
            raise RuntimeError(f"decompress --bf16 wrote {outs}")
        try:
            train.main(flags + ["--devices", "2", "--max_steps", "1"])
        except SystemExit as e:
            log(f"train --bf16 --devices 2 refused: {e}")
        else:
            raise RuntimeError("train --bf16 --devices 2 was not refused")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = dict(train_ms=wall_t, compress_ms=wall_c, decompress_ms=wall_d, steps=steps)
    log("phase 34, train --bf16 -> compress --bf16 -> decompress --bf16: " + json.dumps(out))
    return out


def pppf_bf16_train_phase(dev, smi: str) -> list:
    """Phase 35: PPPF_AE(compute_dtype="bfloat16") in train mode with its
    encoder frozen (pcc_tpu's fused_train=True form), default config, seeded
    weights with live BatchNorm statistics, on the patches of phase 12's 8
    clouds: the step's patching and one forward and backward of a seeded
    loss, counted (fps 3: the skeleton, sa2 and sa3; pppf_sa_stage_bf16_save
    3, pppf_sa_stage_bwd_bf16 3, nothing else of the stage), finite
    gradients; then, per stage, on its recorded inputs,
    stored forward and cotangent: the backward kernel vs
    pppf_sa_bwd_plain_bf16 on that stored forward, two launches bitwise
    equal, the store mode's output vs pppf_sa_plain(bf16=True) (bf16_hold),
    times and bounds. Returns the two kernels' records."""
    cfg = CodecConfig(model="PPPF-AE", compute_dtype="bfloat16")
    ae, _ = make_models(cfg)
    ae.load_state_dict(randomize_batchnorm(init_params(SEED, cfg)[0], SEED + 2))
    ae = ae.to(dev).train()
    ae.encoder.train(False)
    clouds = torch.from_numpy(np.stack(synthetic_clouds(PPPF_TRAIN_CLOUDS, cfg.N,
                                                        SEED + 4))).to(dev)
    starts = torch.zeros(PPPF_TRAIN_CLOUDS, dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(SEED + 40)
    rec = []
    backward = PPPFStageFn.backward

    def recording(ctx, gout):
        new_xyz, xyz, feat, *rest = ctx.saved_tensors
        flat, saved = rest[:ctx.n_flat], rest[ctx.n_flat:]
        layers = [tuple(t.detach() for t in flat[i:i + 5]) for i in range(0, len(flat), 5)]
        rec.append((new_xyz, xyz, feat, layers, gout.contiguous(), tuple(saved),
                    ctx.nsample, ctx.radius))
        return backward(ctx, gout)

    def run():
        # the train step's patches (its skeleton FPS), then the module
        with torch.no_grad():
            patches = encode_geometry(clouds, starts, cfg).patches
        out, z, _ = ae(patches)
        gz = torch.randn(z.shape, generator=g).to(dev)
        go = torch.randn(out.shape, generator=g).to(dev)
        ((out * go).sum() + (z * gz).sum()).backward()

    run()                                                     # uncounted
    ae.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    PPPFStageFn.backward = staticmethod(recording)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        PPPFStageFn.backward = staticmethod(backward)
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in cuda_lib.launches.items() if v}
    want = dict(fps=3, pppf_sa_stage_bf16_save=3, pppf_sa_stage_bwd_bf16=3)
    log(f"phase 35, PPPF_AE bf16 in train mode (encoder frozen), {tuple(rec[-1][1].shape)} "
        f"patches: patching, forward + backward {wall:.1f} ms, launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    if any(launches.get(k, 0) != v for k, v in want.items()) or any(
            launches.get(k, 0) for k in ("pppf_sa_stage", "pppf_sa_stage_bf16",
                                         "pppf_sa_stage_bwd")):
        raise RuntimeError(f"PPPF_AE bf16 train launches {launches}, want {want}")
    if not all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in ae.parameters()):
        raise RuntimeError("PPPF_AE bf16 train: a missing or non-finite gradient")
    save_recs, bwd_recs = [], []
    for name, (new_xyz, xyz, feat, layers, gout, saved, nsample, radius) in zip(
            ("sa1", "sa2", "sa3"), rec[::-1]):
        if not saved:
            raise RuntimeError(f"phase 35 {name}: the bf16 store mode stored nothing")
        kw = dict(nsample=nsample, radius=radius)
        lay16 = bf16_layers(layers)
        P, S, _ = new_xyz.shape
        N = xyz.shape[1]
        widths = [layers[0][0].shape[0]] + [lay[0].shape[1] for lay in layers]
        # the store mode's output vs the plain bf16 forward
        out, held = bf16_hold(f"pppf_sa_stage_bf16_save {name}",
                              lambda: pppf_sa_fused(new_xyz, xyz, feat, lay16, save=True,
                                                    bf16=True, **kw)[0],
                              lambda: pppf_sa_plain(new_xyz, xyz, feat, lay16, bf16=True, **kw))
        # as phase 28: the products are bf16 x bf16, at the tensor cores' bf16 rate
        fl = stage_flops(P, S, N, nsample, widths)
        products = P * N * 2.0 * sum(a_ * b_ for a_, b_ in zip(widths[:-1], widths[1:]))
        io = nbytes(new_xyz, xyz, out, *([] if feat is None else [feat])) + \
            sum(s_.numel() * s_.element_size() for s_ in saved)
        r = bf16_timing(held, lambda: pppf_sa_fused(new_xyz, xyz, feat, lay16, save=True,
                                                    bf16=True, **kw),
                        lambda: pppf_sa_plain(new_xyz, xyz, feat, lay16, bf16=True, **kw),
                        fl - products, products, io, stage=name, shape=[P, S, N, widths],
                        nsample=nsample)
        bf16_log(f"pppf_sa_stage_bf16_save {name} (store mode)", r)
        save_recs.append(r)

        def flat(res):
            dxyz, dfeat, dl = res
            return [dxyz] + ([] if dfeat is None else [dfeat]) + [t for lay in dl for t in lay]

        kern = lambda: pppf_sa_bwd(new_xyz, xyz, feat, gout, lay16, saved=saved,  # noqa: E731
                                   bf16=True, **kw)
        plain = lambda: pppf_sa_bwd_plain_bf16(new_xyz, xyz, feat, gout, lay16,  # noqa: E731
                                               saved=saved, **kw)
        a, b = flat(kern()), flat(plain())
        rows = 1 + (feat is not None)
        control = regrouped_rows(new_xyz, xyz, feat, gout, lay16, saved=saved, **kw)
        rel, row_figs = [], []
        for i, (x, y) in enumerate(zip(a, b)):
            err, big = float((x - y).abs().max()), float(y.abs().max())
            rel.append(err / big if big else 0.0)
            if i < rows:
                # the row gradients, row by row; the per-point regrouping,
                # not pcc_tpu's function in bf16, must fail the same hold
                fails, fig = row_hold(x, y)
                c_fails, c_fig = row_hold(control[i], y)
                log(f"  pppf_sa_stage_bwd_bf16 {name} rows {tuple(y.shape)}: {fig['rows']} "
                    f"rows ({fig['zero_rows']} zero), {fig['share_f32']:.4f} within "
                    f"{ROW_F32} of their largest entry, the worst {fig['worst']:.3g} apart "
                    f"(limits {ROW_SHARE}, {ROW_TOL}); max |kernel - plain| {err:.3g} of "
                    f"{big:.3g}. Regrouped per point (control): {c_fig['share_f32']:.4f} "
                    f"within, the worst {c_fig['worst']:.3g}")
                if fails or not c_fails:
                    raise RuntimeError(f"pppf_sa_stage_bwd_bf16 {name} rows {tuple(y.shape)}: "
                                       f"{fails}; the regrouped control fails {c_fails}")
                row_figs.append(dict(shape=list(y.shape), **fig,
                                     control_share_f32=c_fig["share_f32"],
                                     control_worst=c_fig["worst"]))
                continue
            log(f"  pppf_sa_stage_bwd_bf16 {name} output {tuple(y.shape)}: max |kernel - "
                f"plain| {err:.3g}, max |plain| {big:.3g} (limit {TOL_BWD} of it)")
            if not err <= TOL_BWD * big:
                raise RuntimeError(f"pppf_sa_stage_bwd_bf16 {name} differs from the plain "
                                   f"version on {tuple(y.shape)}: {err} > {TOL_BWD} * {big}")
        del control
        if not all(torch.equal(x, y) for x, y in zip(a, flat(kern()))):
            raise RuntimeError(f"two launches of pppf_sa_stage_bwd_bf16 differ at {name}")
        fp32, products = stage_bwd_bf16_work(P, S, N, nsample, widths)
        ins = [new_xyz, xyz, gout, *saved] + ([] if feat is None else [feat]) \
            + [t for lay in layers for t in (lay[0], lay[1], lay[3], lay[4])]
        bms, by, bms32 = bf16_bounds(fp32, products, nbytes(*ins, *a))
        br = dict(stage=name, shape=[P, S, N, widths], nsample=nsample,
                  max_abs_err=max(float((x - y).abs().max()) for x, y in zip(a, b)),
                  max_rel_err=max(rel), ms=cuda_ms(kern, 3), plain_ms=cuda_ms(plain, 1),
                  bound_ms=bms, bound_by=by, bound_fp32_ms=bms32,
                  gflop=(fp32 + products) / 1e9, slot_rows=P * S * nsample, rows=row_figs)
        log(f"pppf_sa_stage_bwd_bf16 {name} new_xyz {tuple(new_xyz.shape)} xyz "
            f"{tuple(xyz.shape)} widths {widths} nsample {nsample}: {br['ms']:.3f} ms on the "
            f"stored forward (plain {br['plain_ms']:.1f} ms; bound {bms:.3f} ms by {by} with "
            f"the per-slot products on the bf16 tensor cores, {bms32:.3f} ms in float32; "
            f"{br['gflop']:.1f} GFLOP, {P * S * nsample} slot rows); max |kernel - plain| / max "
            f"|plain| over the weight gradients {max(rel[rows:]):.3g}; two launches bitwise "
            f"equal")
        profile(f"pppf_sa_stage_bwd_bf16 {name} (one call on the stored forward)", kern, top=10)
        bwd_recs.append(br)
    del rec
    common = dict(route="cuda", library_ms=None)
    return [
        dict(name="pppf_sa_stage_bf16_save", source="pcc_tpu_torch/csrc/pppf_sa_stage.cu",
             replaces="pcc_tpu/ops/pppf_sa_pallas.py:45",
             launches=launches["pppf_sa_stage_bf16_save"],
             max_abs_err=max(r["max_abs_err"] for r in save_recs),
             ms=sum(r["ms"] for r in save_recs), plain_ms=sum(r["plain_ms"] for r in save_recs),
             bound_ms=sum(r["bound_ms"] for r in save_recs), bound_by=save_recs[-1]["bound_by"],
             bound_fp32_ms=sum(r["bound_fp32_ms"] for r in save_recs), stages=save_recs,
             **common),
        dict(name="pppf_sa_stage_bwd_bf16", source="pcc_tpu_torch/csrc/pppf_sa_stage_bwd.cu",
             replaces="pcc_tpu/ops/pppf_sa_pallas.py:258",
             launches=launches["pppf_sa_stage_bwd_bf16"],
             max_abs_err=max(r["max_abs_err"] for r in bwd_recs),
             ms=sum(r["ms"] for r in bwd_recs), plain_ms=sum(r["plain_ms"] for r in bwd_recs),
             bound_ms=sum(r["bound_ms"] for r in bwd_recs), bound_by=bwd_recs[-1]["bound_by"],
             bound_fp32_ms=sum(r["bound_fp32_ms"] for r in bwd_recs), stages=bwd_recs,
             **common)]


def pppe_bf16_train_phase(dev, smi: str) -> dict:
    """Phase 36: PPPE training in bf16 as cli/train_pppe_pcd_ae.py --bf16
    builds it (PPPEConfig(compute_dtype="bfloat16") at the CLI defaults):
    PPPE_TRAIN_STEPS counted steps on phase 21's clouds (fps 3, chamfer_fwd
    and chamfer_bwd 1 a step, the bf16 reductions of the bias gradients,
    nothing else), finite, loss lower at the end; the NaN skip; peak
    memory. Then a TINY bf16 step on the card and on the CPU port, on
    shaped_clouds with steady_symbols: the loss and every gradient before
    the clip held by tools/holds.py::spread_hold to the CPU port's own
    spread over the same step with the clouds in PPPE_REORDERS' orders (as
    tests/test_torch_port_pn_bf16.py holds the port to pcc_tpu), and the
    update equal to optax's clip and Adam on the card's own gradient; and
    the CLI with --bf16 for 3 steps into the float32 PPPE compress and
    decompress CLIs."""
    import shutil
    import tempfile

    from pcc_tpu_torch.cli import pppe_pcd_compress, pppe_pcd_decompress, train_pppe_pcd_ae
    from pcc_tpu_torch.io import read_point_cloud, save_point_cloud

    cfg = PPPEConfig(compute_dtype="bfloat16")
    B = PPPE_TRAIN_CLOUDS
    tx = make_pppe_optimizer(5e-4)
    state = create_pppe_state(SEED, cfg, tx, device="cuda")
    step = build_pppe_train_step(tx)
    batch = torch.from_numpy(unit_cube(synthetic_clouds(B, cfg.N, SEED + 8))).to(dev)
    lam = 1.0 / 5000
    step(state, batch, lam)                                   # uncounted
    times, auxes, launches, peak = timed_steps(lambda: step(state, batch, lam)[1],
                                               PPPE_TRAIN_STEPS)
    want = want_launches(PPPE_TRAIN_STEPS, fps=3, chamfer_fwd=1, chamfer_bwd=1,
                         bf16_reduce=launches.get("bf16_reduce", 0) // PPPE_TRAIN_STEPS)
    log(f"phase 36, PPPE bf16 train launches over {PPPE_TRAIN_STEPS} steps: {launches}")
    if launches != want or not launches.get("bf16_reduce"):
        raise RuntimeError(f"PPPE bf16 train launches {launches} != {want}")
    vals = {k: torch.stack([a[k] for a in auxes]).cpu().numpy()
            for k in ("loss", "dist", "rate", "skipped")}
    if not all(np.isfinite(vals[k]).all() for k in ("loss", "dist", "rate")) \
            or vals["skipped"].any() or not vals["loss"][-1] < vals["loss"][0]:
        raise RuntimeError(f"PPPE bf16 train: non-finite, skipped or not falling: {vals}")
    ms = float(np.median(times)) * 1e3
    log(f"phase 36, PPPE bf16 train: {B} clouds x {cfg.N} points per step; median step "
        f"{ms:.2f} ms (steps {min(times) * 1e3:.2f} to {max(times) * 1e3:.2f} ms), "
        f"{B * cfg.N / (ms / 1e3):.0f} points/s on {smi}; peak memory {peak:.2f} GiB; loss "
        f"{vals['loss'][0]:.6f} -> {vals['loss'][-1]:.6f}")
    profile("PPPE bf16 train step", lambda: step(state, batch, lam), top=14)
    fields = ("params", "stats", "mu", "nu", "count", "step")
    before = [getattr(state, f).clone() for f in fields]
    bad = batch.clone()
    bad[1, 100, 0] = float("nan")
    _, aux = step(state, bad, lam)
    if not bool(aux["skipped"]) or not all(torch.equal(b_, getattr(state, f))
                                           for f, b_ in zip(fields, before)):
        raise RuntimeError("PPPE bf16 train: a NaN batch was not skipped whole")
    log("phase 36, PPPE bf16 train: a batch with a NaN coordinate skipped, the state bit for "
        "bit unchanged")
    del state

    tiny = PPPEConfig(**TINY_PPPE, compute_dtype="bfloat16")
    lr = 1e-3
    ttx = make_pppe_optimizer(lr)
    tb = torch.from_numpy(shaped_clouds(PPPE_TRAIN_CLOUDS, tiny.N, SEED + 9))
    tstep = build_pppe_train_step(ttx)

    def tiny_step(device, order):
        """A fresh TINY state, one step on the clouds in `order`: (state,
        parameters before, aux, gradients by name before the clip)."""
        st = create_pppe_state(SEED, tiny, ttx, device=device)
        steady_symbols(st.model, SEED + 9)
        p0 = st.params.detach().double().cpu().numpy().copy()
        _, aux = tstep(st, tb[order].to(device), 1e-2)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for n, p in st.named_parameters()}
        return st, p0, aux, grads

    card, p0, a, g_card = tiny_step("cuda", np.arange(len(tb)))
    _, _, b, g_cpu = tiny_step("cpu", np.arange(len(tb)))
    others = [tiny_step("cpu", o) for o in PPPE_REORDERS]
    la, lb = float(a["loss"]), float(b["loss"])
    fails, fig = spread_hold(g_card, g_cpu, [o[3] for o in others],
                             {n for n in g_cpu if re.search(r"\.mlp_stack\.\d+\.0\.bias$", n)})
    fails += spread_hold({"loss": la}, {"loss": lb}, [{"loss": float(o[2]["loss"])}
                                                      for o in others])[0]
    # optax's clip_by_global_norm(1.0) and Adam's first step on the card's
    # own gradient, in float64
    g = torch.cat([x.reshape(-1) for x in g_card.values()]).double().numpy()
    n = float(np.sqrt(np.sum(g * g)))
    g = g / n if n >= 1.0 else g
    adam = float(np.abs(card.params.detach().double().cpu().numpy()
                        - (p0 - lr * g / (np.abs(g) + 1e-8))).max())
    med = fig["median"]
    log(f"phase 36, PPPE bf16 step at TINY_PPPE, card vs CPU port (tools/holds.py::spread_hold, "
        f"the CPU port's own spread over {len(others)} reorderings of the clouds): loss "
        f"{la:.8f} vs {lb:.8f}; gradients median distance {med['e']:.3g} (CPU reorderings "
        f"{med['s']:.3g}), median norm ratio {med['rho']:.4f}, mean cosine "
        f"{fig['mean_cos']:.4f} (CPU reorderings {fig['mean_cos_self']:.4f}); the update at "
        f"most {adam:.3g} from optax's Adam on the card's gradient (limit 1e-6)")
    if fails or not adam <= 1e-6:
        raise RuntimeError(f"PPPE bf16 TINY step card vs CPU: {fails[:6]}, Adam {adam}")

    full = PPPEConfig()
    os.makedirs(os.path.join(ROOT, "_chip"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="pppe_bf16_", dir=os.path.join(ROOT, "_chip"))
    try:
        d = lambda *p: os.path.join(work, *p)  # noqa: E731
        for i, pc in enumerate(unit_cube(synthetic_clouds(4, full.N, SEED + 10))):
            save_point_cloud(pc, f"c{i}.ply", path=d("in"))
        flags = ["--N", str(full.N), "--K", str(full.latent_dim), "--L", str(full.L)]
        wall, l_t = run_cli("phase 36 PPPE train CLI --bf16 (3 steps of 4 clouds)",
                            train_pppe_pcd_ae.main,
                            ["--train_glob", d("in", "*.ply"), "--model_save_folder", d("model"),
                             "--max_steps", "3", "--step_window", "1", "--bf16", *flags])
        if l_t != want_launches(3, fps=3, chamfer_fwd=1, chamfer_bwd=1,
                                bf16_reduce=l_t.get("bf16_reduce", 0) // 3):
            raise RuntimeError(f"PPPE train CLI --bf16 launches {l_t}")
        pppe_pcd_compress.main([d("in", "*.ply"), d("comp"), d("model"), *flags])
        pppe_pcd_decompress.main([d("comp", "*.bin"), d("dec"), d("model"), *flags])
        for i in range(4):
            pc = read_point_cloud(d("dec", f"c{i}.bin.ply"))
            if pc.shape != (full.N, 3) or not np.isfinite(pc).all():
                raise RuntimeError(f"bad PPPE decode after the bf16 train CLI: {pc.shape}")
        log(f"phase 36, PPPE train CLI --bf16: 3 steps in {wall:.0f} ms; its float32 "
            "ae_latest.pkl compressed and decompressed 4 clouds through the PPPE CLIs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(launches_per_step={k: v // PPPE_TRAIN_STEPS for k, v in launches.items()},
                step_ms=ms, points_per_s=B * cfg.N / (ms / 1e3), peak_gib=peak,
                tiny_loss=[la, lb], tiny_grad_median=med, tiny_mean_cos=fig["mean_cos"],
                tiny_mean_cos_cpu=fig["mean_cos_self"], tiny_adam_diff=adam)


def pppf_bf16_cli_phase() -> dict:
    """Phase 37: cli/train.py --model PPPF-AE --N 512 --max_steps 2 with and
    without --bf16 on the same clouds and seed: the --bf16 run is the
    float32 step (pcc_tpu's PPPF-AE trainer computes in float32 under
    --bf16). The card's float32 PPPF-AE step is not bitwise repeatable by
    default (the batch-statistics stages' gather backward adds with
    atomics; ROADMAP.md §3 open 1), and the gap between two runs spreads
    several times over between calls; so the three runs take torch's
    deterministic algorithms (main() sets CUBLAS_WORKSPACE_CONFIG, as they
    ask), under which the step repeats bit for bit on an H100. The run
    without --bf16 runs twice, and the --bf16 run must lie as close to the
    first as REPEAT_FACTOR times the second does, or within 1e-6 (each
    tensor's max |difference| over its largest entry; with the algorithms
    deterministic the repeat's is 0, so the --bf16 run must equal the first
    to 1e-6; bit for bit on the CPU, tests/test_torch_port_pn_bf16.py).
    What fixes the step: the
    --bf16 run launches the same kernels as many times as the float32 run,
    and no bf16 kernel or reduction."""
    import pickle
    import shutil
    import tempfile

    from pcc_tpu_torch.cli import train
    from pcc_tpu_torch.io import save_point_cloud

    os.makedirs(os.path.join(ROOT, "_chip"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="pppf_bf16_cli_", dir=os.path.join(ROOT, "_chip"))
    try:
        for i, pc in enumerate(synthetic_clouds(4, 512, SEED + 41)):
            save_point_cloud(pc, f"c{i}.ply", path=os.path.join(work, "in"))
        trees, launched = [], []
        deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for k, bf16 in enumerate((False, True, False)):
                model = os.path.join(work, f"m{k}")
                _, l_k = run_cli(
                    f"phase 37 train --model PPPF-AE --N 512{' --bf16' if bf16 else ''}",
                    train.main, ["--train_glob", os.path.join(work, "in", "*.ply"),
                                 "--model_save_folder", model, "--model", "PPPF-AE", "--N",
                                 "512", "--batch_size", "4", "--bn_warmup_steps", "1",
                                 "--max_steps", "2", "--step_window", "1"]
                    + (["--bf16"] if bf16 else []))
                loaded = []
                for name in ("ae.pkl", "prob.pkl"):
                    with open(os.path.join(model, name), "rb") as f:
                        loaded.append(pickle.load(f))
                trees.append([np.asarray(x, np.float64) for x in _leaves(loaded)])
                launched.append({k_: v for k_, v in l_k.items() if v})
        finally:
            torch.use_deterministic_algorithms(deterministic)

        def apart(a, b):
            return max(float(np.abs(x - y).max()) / (float(np.abs(x).max()) or 1.0)
                       for x, y in zip(a, b))

        bf16_gap, repeat_gap = apart(trees[0], trees[1]), apart(trees[0], trees[2])
        # the float32 step launches the float32 kernels only, as many times
        log(f"phase 37, launches without --bf16 {launched[0]}, with it {launched[1]}")
        if launched[1] != launched[0] or any("bf16" in k_ for k_ in launched[1]):
            raise RuntimeError(f"train --model PPPF-AE --bf16 launched {launched[1]}, the "
                               f"float32 run {launched[0]}")
        log(f"phase 37, train --model PPPF-AE: the --bf16 run's parameters at most "
            f"{bf16_gap:.3g} from the float32 run's, a second float32 run's at most "
            f"{repeat_gap:.3g} (limit {REPEAT_FACTOR} times that, or 1e-6)")
        if len(trees[1]) != len(trees[0]) or bf16_gap > max(REPEAT_FACTOR * repeat_gap, 1e-6):
            raise RuntimeError(f"train --model PPPF-AE --bf16 is not the float32 step: "
                               f"{bf16_gap} vs a repeat's {repeat_gap}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(bf16_gap=bf16_gap, repeat_gap=repeat_gap, launches=launched[1])


def sa_bf16_phase(dev, patches, sa_state: dict) -> dict:
    """Phase 38: SetAbstraction(knn=16, compute_dtype="bfloat16",
    fused=True) at the IPDAE serving batch's patches (phase 17's [4096, 256,
    3]) and the serving model's SetAbstraction weights: one call with every
    launch counter set to 0 just before and read just after (sa_fused_bf16
    1, nothing else), its output the kernel's; the bf16 instance held to
    sa_fused_plain(bf16=True) (bf16_hold), the float32 instance's output as
    the control failing that hold; times and bounds (layers 2-3 on the bf16
    tensor cores, layer 1, the selection and the max in float32)."""
    knn = 16
    module = SetAbstraction(knn=knn, fused=True, compute_dtype="bfloat16").to(dev).eval()
    module.load_state_dict(sa_state)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    out = module(patches)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    want = {name: 0 for name in cuda_lib.KERNELS}
    want["sa_fused_bf16"] = 1
    if launches != want:
        raise RuntimeError(f"SetAbstraction(bf16, fused=True) launches {launches} != {want}")
    layers, sa16 = module.layers(), module.fused_weights()
    kern = lambda: sa_fused(patches, sa16, knn, bf16=True)          # noqa: E731
    plain = lambda: sa_fused_plain(patches, layers, knn, bf16=True)  # noqa: E731
    a, held = bf16_hold("sa_fused_bf16", kern, plain)
    if not torch.equal(out, a):
        raise RuntimeError("SetAbstraction(bf16, fused=True) differs from sa_fused_bf16")
    ref = plain()
    c_share, c_err, c_big, c_held = held_share(sa_fused(patches, layers, knn), ref)
    if c_held:
        raise RuntimeError(f"control: the float32 instance passes the bf16 hold ({c_share:.4f} "
                           f"bit-equal, max |diff| {c_err})")
    P, N = patches.shape[:2]
    sa_mac = 3 * 32 + 32 * 64 + 64 * 128
    flops = P * (9.0 * N * N + 2.0 * N * knn * sa_mac)
    products = 2.0 * P * N * knn * (32 * 64 + 64 * 128)
    io = nbytes(patches, a, *[t for wb in sa16 for t in wb])
    rec = dict(name="sa_fused_bf16", route="cuda", source="pcc_tpu_torch/csrc/sa_fused.cu",
               replaces="pcc_tpu/ops/sa_pallas.py:43", launches=launches["sa_fused_bf16"],
               library_ms=None, path="SetAbstraction(compute_dtype=bfloat16, fused=True)",
               shape=[P, N, knn], control_f32=dict(bit_equal_share=c_share, max_abs_err=c_err),
               **bf16_timing(held, kern, plain, flops - products, products, io))
    bf16_log(f"phase 38, sa_fused_bf16 on {tuple(patches.shape)}, knn {knn}", rec)
    log(f"phase 38: SetAbstraction(bf16, fused=True) launches sa_fused_bf16 "
        f"{rec['launches']}, nothing else, output equal; control, the float32 instance: "
        f"{c_share:.4f} of the entries bit-equal, max |diff| {c_err:.3g} of {c_big:.3g} "
        "(fails the hold)")
    return rec


def pppe_encode(model, batch: np.ndarray, cfg: PPPEConfig):
    """cli/pppe_pcd_compress.py::encode_clouds with the global feature too:
    [B, N, 3] clouds -> (latents, global features) on the model's device."""
    from pcc_tpu_torch.ops.normalize import normalize

    dev = next(model.parameters()).device
    with torch.no_grad():
        pc01 = normalize(torch.from_numpy(np.asarray(batch, np.float32)).to(dev),
                         margin=cfg.margin)[0]
        return model.encoder(pc01)


def pppe_bf16_phase(dev, smi: str) -> tuple:
    """Phase 39: PPPE in bf16 eval mode at the CLIs' defaults
    (make_pppe_model(PPPEConfig(compute_dtype="bfloat16")), N 8192, latent
    256, L 7) on PPPE_CLOUDS clouds, the latent head scaled as phase 19's
    (pppe_test_state): the CLIs' encode_clouds -> symbols ->
    decode_latents with every launch counter set to 0 just before and read
    just after (fps 3 and pppe_sa_stage_bf16 2 in the encode, nothing else
    and nothing in the decode), the walls and the busy share; then on
    PPPE_BF16_CPU_CLOUDS of the clouds against the CPU port: the global
    feature under the bf16 hold and the float32 model's (on the card) as the
    control failing it; the latents within BF16_TOL of their largest entry
    (their bit-equal share and the float32 model's beside them: a bf16
    rounding flipped by another order of a stage's float32 sums moves gc0's
    unrounded product, and most latents of its cloud by an ulp); the
    symbols equal but where the CPU's latent lies within that bound of a
    bin's edge; the card's decoded clouds within BF16_TOL of the CPU's
    decode of the same latents (their bit-equal share printed: a bf16
    rounding that cuBLAS's order of a float32 sum flips moves the layers
    after it, as in the latents). Returns the figures and the recorded sa2
    / sa3 stage calls."""
    from pcc_tpu_torch.cli.pppe_pcd_compress import encode_clouds
    from pcc_tpu_torch.cli.pppe_pcd_decompress import decode_latents

    cfg = PPPEConfig(compute_dtype="bfloat16")
    B = PPPE_CLOUDS
    batch = np.stack(synthetic_clouds(B, cfg.N, SEED + 5))
    model = make_pppe_model(cfg, seed=SEED)
    sd = pppe_test_state(model, SEED + 6)
    model.load_state_dict(sd)
    model = model.to(dev)
    with torch.no_grad():
        decode_latents(model, encode_clouds(model, batch, cfg).cpu().numpy(), "round", cfg.L)
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        lat = encode_clouds(model, batch, cfg)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        enc_launches = dict(cuda_lib.launches)
        lat_np = lat.cpu().numpy()
        sym = np.clip(np.round(lat_np), 0, cfg.L - 1)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        fine = decode_latents(model, lat_np, "round", cfg.L)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3
        dec_launches = dict(cuda_lib.launches)
    want = {name: 0 for name in cuda_lib.KERNELS}
    want.update(fps=3, pppe_sa_stage_bf16=2)
    if enc_launches != want or any(dec_launches.values()):
        raise RuntimeError(f"PPPE bf16 launches: encode {enc_launches} (want {want}), decode "
                           f"{dec_launches} (want none)")
    if fine.shape != (B, cfg.N, 3) or not torch.isfinite(fine).all() \
            or not np.isfinite(lat_np).all():
        raise RuntimeError(f"PPPE bf16: bad latents or decoded clouds {tuple(fine.shape)}")
    counts = np.bincount(sym.astype(np.int64).ravel(), minlength=cfg.L).tolist()
    log(f"phase 39, PPPE bf16 eval: encode of {B} clouds {enc_ms:.1f} ms (wall, "
        f"{B / enc_ms * 1e3:.1f} clouds/s), decode {dec_ms:.1f} ms on {smi}; launches "
        f"{ {k: v for k, v in enc_launches.items() if v} } and none in the decode; symbols "
        f"per bin {counts}")
    with torch.no_grad():
        enc_prof = profile("PPPE bf16 encode", lambda: encode_clouds(model, batch, cfg), top=10)
        dec_prof = profile("PPPE bf16 decode",
                           lambda: decode_latents(model, lat_np, "round", cfg.L))
        with recording_pppe_stages() as stage_calls:
            encode_clouds(model, batch, cfg)
        n = PPPE_BF16_CPU_CLOUDS
        lat_card, cond_card = (t.cpu() for t in pppe_encode(model, batch[:n], cfg))
        cpu_model = make_pppe_model(cfg)
        cpu_model.load_state_dict(sd)
        lat_cpu, cond_cpu = pppe_encode(cpu_model, batch[:n], cfg)
        f32_model = make_pppe_model(PPPEConfig())
        f32_model.load_state_dict(sd)
        lat_f32, cond_f32 = (t.cpu() for t in pppe_encode(f32_model.to(dev), batch[:n], cfg))
        fine_cpu = decode_latents(cpu_model, lat_np[:n], "round", cfg.L)
    if not torch.equal(lat_card, lat[:n].cpu()):
        raise RuntimeError("PPPE bf16: encode_clouds and the encoder differ on the card")
    cond_fig = held_share(cond_card, cond_cpu)
    ctl_fig = held_share(cond_f32, cond_cpu)
    lat_fig = held_share(lat_card, lat_cpu)
    lat32_fig = held_share(lat_f32, lat_cpu)
    if not cond_fig[3] or ctl_fig[3]:
        raise RuntimeError(f"PPPE bf16 global feature, card vs CPU port: {cond_fig[:3]} "
                           f"(must pass the bf16 hold); the float32 model's {ctl_fig[:3]} "
                           "(must fail it)")
    if not lat_fig[1] <= BF16_TOL * lat_fig[2]:
        raise RuntimeError(f"PPPE bf16 latents, card vs CPU port: max |diff| {lat_fig[1]} > "
                           f"{BF16_TOL} * {lat_fig[2]}")
    lc = lat_cpu.numpy()
    sym_cpu = np.clip(np.round(lc), 0, cfg.L - 1)
    edge = np.abs(np.abs(lc - np.floor(lc)) - 0.5) <= BF16_TOL * lat_fig[2]
    edge &= (lc > -0.5) & (lc < cfg.L - 0.5)
    moved = sym[:n] != sym_cpu
    if (moved & ~edge).any():
        raise RuntimeError(f"PPPE bf16: {int((moved & ~edge).sum())} symbols differ from the "
                           "CPU port's away from a bin's edge")
    dec_fig = held_share(fine[:n].cpu(), fine_cpu)
    if not dec_fig[1] <= BF16_TOL * dec_fig[2]:
        raise RuntimeError(f"PPPE bf16 decoded clouds, card vs CPU port: max |diff| "
                           f"{dec_fig[1]} > {BF16_TOL} * {dec_fig[2]}")
    log(f"phase 39, PPPE bf16 card vs CPU port on {n} clouds: global feature "
        f"{cond_fig[0]:.4f} of the entries bit-equal, max |diff| {cond_fig[1]:.3g} of "
        f"{cond_fig[2]:.3g} (the float32 model's, the control: {ctl_fig[0]:.4f}, "
        f"{ctl_fig[1]:.3g}); latents {lat_fig[0]:.4f} bit-equal, max |diff| {lat_fig[1]:.3g} "
        f"of {lat_fig[2]:.3g} (limit {BF16_TOL * lat_fig[2]:.3g}; the float32 model's "
        f"{lat32_fig[0]:.4f}, {lat32_fig[1]:.3g}); symbols differing {int(moved.sum())} of "
        f"{moved.size}, {int(edge.sum())} CPU latents within the limit of a bin's edge; "
        f"decoded clouds {dec_fig[0]:.4f} bit-equal, max |diff| {dec_fig[1]:.3g} of "
        f"{dec_fig[2]:.3g}")
    fig = dict(encode_ms=enc_ms, decode_ms=dec_ms, launches=enc_launches["pppe_sa_stage_bf16"],
               fps_launches=enc_launches["fps"], encode_profile=enc_prof,
               decode_profile=dec_prof, symbols_per_bin=counts,
               global_feature=dict(zip(("bit_equal_share", "max_abs_err", "max_abs"),
                                       cond_fig[:3])),
               global_feature_f32_control=dict(zip(("bit_equal_share", "max_abs_err"),
                                                   ctl_fig[:2])),
               latents=dict(zip(("bit_equal_share", "max_abs_err", "max_abs"), lat_fig[:3])),
               latents_f32=dict(zip(("bit_equal_share", "max_abs_err"), lat32_fig[:2])),
               symbols_differ=int(moved.sum()),
               decoded=dict(zip(("bit_equal_share", "max_abs_err", "max_abs"), dec_fig[:3])))
    return fig, stage_calls


def pppe_bf16_stage_check(stage_calls, launches: int) -> dict:
    """Phase 40: the bf16 "pppe" instance against its plain version on the
    path's own sa2 and sa3 inputs (recorded in phase 39, the model's rounded
    layers) and on the per-slot route (phase 20's: a PER_SLOT_MIDDLE-wide
    middle layer, seeded layers rounded, on sa2's inputs): bf16_hold, the
    float32 instance on the same layers as the control failing it, times
    and bounds (the first layer's product per point and the later layers'
    per slot on the bf16 tensor cores, the rest in float32)."""
    if len(stage_calls) != 2:
        raise RuntimeError(f"the PPPE bf16 encoder made {len(stage_calls)} stage calls, not 2")
    recs = []
    new_xyz, xyz, feat, _, nsample = stage_calls[0]
    g = torch.Generator().manual_seed(SEED + 41)
    widths = [3 + feat.shape[-1], 128, PER_SLOT_MIDDLE, 256]
    per_slot = []
    for a, b in zip(widths[:-1], widths[1:]):
        sign = torch.where(torch.rand(b, generator=g) < 0.25, -1.0, 1.0)
        per_slot.append(tuple(t.to(xyz.device) for t in (
            (torch.rand((a, b), generator=g) * 2 - 1) * a ** -0.5,
            (torch.rand(b, generator=g) * 2 - 1) * a ** -0.5,
            (torch.rand(b, generator=g) - 0.5) * 0.2, (torch.rand(b, generator=g) + 0.5) * sign,
            (torch.rand(b, generator=g) - 0.3) * 0.5)))
    cases = [(name, *call[:4], "slots") for name, call in zip(("sa2", "sa3"), stage_calls)]
    cases.append(("sa2 per slot", new_xyz, xyz, feat, bf16_layers(per_slot), "per_slot"))
    for name, new_xyz, xyz, feat, layers, route in cases:
        P, S, _ = new_xyz.shape
        N = xyz.shape[1]
        widths = [layers[0][0].shape[0]] + [lay[0].shape[1] for lay in layers]
        if pppe_kernel(widths, N, S, nsample) != route:
            raise RuntimeError(f"{name}: widths {widths} do not take the {route} route")
        kw = dict(nsample=nsample, radius=0.0, layout="pppe")
        kern = lambda: pppf_sa_fused(new_xyz, xyz, feat, layers, bf16=True, **kw)  # noqa: E731
        plain = lambda: pppf_sa_plain(new_xyz, xyz, feat, layers, bf16=True, **kw)  # noqa: E731
        before = cuda_lib.launches["pppe_sa_stage_bf16"]
        a, held = bf16_hold(f"pppe_sa_stage_bf16 {name}", kern, plain)
        if cuda_lib.launches["pppe_sa_stage_bf16"] != before + 2:
            raise RuntimeError(f"pppe_sa_stage_bf16 {name}: not one launch a call")
        c_share, c_err, _, c_held = held_share(pppf_sa_fused(new_xyz, xyz, feat, layers, **kw),
                                               plain())
        if c_held:
            raise RuntimeError(f"control: the float32 \"pppe\" stage passes the bf16 hold on "
                               f"{name} ({c_share:.4f} bit-equal, max |diff| {c_err})")
        fp32, products = pppe_work(P, S, N, nsample, widths)
        io = nbytes(new_xyz, xyz, feat, a, *[t for lay in layers for t in lay])
        rec = dict(stage=name, route=route, shape=[P, S, N, widths], nsample=nsample,
                   control_f32=dict(bit_equal_share=c_share, max_abs_err=c_err),
                   **bf16_timing(held, kern, plain, fp32, products, io))
        bf16_log(f"phase 40, pppe_sa_stage_bf16 {name} ({route}) widths {widths}", rec)
        log(f"phase 40, {name}: control, the float32 instance: {c_share:.4f} of the entries "
            f"bit-equal, max |diff| {c_err:.3g} (fails the hold)")
        recs.append(rec)
    path = recs[:2]
    return dict(name="pppe_sa_stage_bf16", route="cuda",
                source="pcc_tpu_torch/csrc/pppf_sa_stage.cu",
                replaces="pcc_tpu/ops/pppf_sa_pallas.py:45", launches=launches,
                path="PPPE bf16 eval encode (sa2 + sa3)",
                max_abs_err=max(r["max_abs_err"] for r in path),
                bit_equal_share=min(r["bit_equal_share"] for r in path),
                ms=sum(r["ms"] for r in path), device_ms=sum(r["device_ms"] for r in path),
                plain_ms=sum(r["plain_ms"] for r in path),
                bound_ms=sum(r["bound_ms"] for r in path), bound_by=path[-1]["bound_by"],
                bound_fp32_ms=sum(r["bound_fp32_ms"] for r in path), library_ms=None,
                stages=path, per_slot_route=recs[2])


def _leaves(tree) -> list:
    """The arrays of a nested dict / list / tuple of arrays, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def main() -> int:
    t_start = time.perf_counter()
    # cuBLAS's fixed workspace, which torch's deterministic algorithms (phase
    # 37) ask for; read when the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # 2. kernel builds
    t0 = time.perf_counter()
    seconds = cuda_lib.build()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for k, out in cuda_lib.build_log.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        log(f"  {k}: {'; '.join(regs)}")

    # 3. the main path, through the entry points a user calls
    cfg = CodecConfig()
    clouds = synthetic_clouds(N_CLOUDS, cfg.N, SEED)
    ae_state, prob_state = init_params(SEED, cfg)
    card = Codec(cfg, ae_state, prob_state, batch_size=N_CLOUDS, device="cuda")
    card.decompress_many(card.compress_many(clouds))          # warm-up, uncounted
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    streams = card.compress_many(clouds)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = card.decompress_many(streams)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    log(f"main path: {N_CLOUDS} clouds x {cfg.N} points; encode "
        f"{N_CLOUDS / t_enc:.2f} clouds/s ({t_enc * 1e3:.1f} ms), decode "
        f"{N_CLOUDS / t_dec:.2f} clouds/s ({t_dec * 1e3:.1f} ms) on {smi}")
    log(f"launches on the main path: {launches}")
    for k in SERVING_KERNELS:
        if launches[k] <= 0:
            raise RuntimeError(f"kernel {k} was not launched on the main path")
    bpp = [8 * (len(p) + len(s) + len(c)) / cfg.N for p, s, c in streams]
    log(f"mean bits per input point {np.mean(bpp):.4f}")
    for pc in decoded:
        if pc.shape != (cfg.S * cfg.k, 3) or not np.isfinite(pc).all():
            raise RuntimeError(f"bad decoded cloud: shape {pc.shape}")
    with torch.inference_mode():
        step_times(card, clouds, streams)
    profile("encode", lambda: card.compress_many(clouds))
    profile("decode", lambda: card.decompress_many(streams))

    starts = np.zeros(N_CLOUDS, np.int32)
    with torch.inference_mode():
        enc = card.encode_batch(np.stack(clouds), starts)
        sym = enc.sym.cpu().numpy()
        recs = skeletons(streams)
        got = card.decode_symbols(recs, [p for p, _, _ in streams])
        if not np.array_equal(got, sym):
            raise RuntimeError("decoded symbols differ from the encoded symbols")
        log("decoded symbols equal encoded symbols for all clouds")

        # 4. each kernel vs its plain version, on the main path's inputs
        packed = pack_encode_upload(np.stack(clouds), starts)
        pcs, st = unpack_encode_upload(
            torch.from_numpy(packed.view(np.int32)).to(dev), cfg.N)
        geo = encode_geometry(pcs, st, cfg)
        sa_patches = geo.patches            # phase 17's inputs
        ae = card.ae
        sa_wb, pn_wb = ae.sa.layers(), ae.pn.layers()
        # the decoder is held on seeded latents over every bin at the decode
        # batch's shape: at these random weights every symbol of the path
        # sits at the middle bin, and the path's h2 rows are all alike
        latent_q = seeded_latents(sym.size // cfg.d, cfg, SEED + 50, dev)
        h2, w3r, b3r, mlp_wb, packed = ae.decoder_inputs(latent_q)
        S, P = cfg.S, latent_q.shape[0]
        kernels = []

        sk = fps_check("IPDAE serving skeleton", ("f32", geo.pc01, S, st))
        kernels.append(dict(
            name="fps", route="cuda", source="pcc_tpu_torch/csrc/fps.cu",
            replaces="pcc_tpu/ops/fps_pallas.py:31", launches=launches["fps"],
            max_abs_err=0.0, ms=sk["ms"], plain_ms=sk["plain_ms"], bound_ms=sk["bound_ms"],
            bound_by=sk["bound_by"], library_ms=None, device_ms=sk["device_ms"],
            ns_per_step=sk["ns_per_step"], shapes=[sk]))

        a = patch_encoder(geo.patches, sa_wb, pn_wb, cfg.sa_knn)
        b = patch_encoder_plain(geo.patches, sa_wb, pn_wb, cfg.sa_knn)
        err = float((a - b).abs().max())
        if not err <= TOL:
            raise RuntimeError(f"patch encoder differs from the plain version: {err}")
        knn = cfg.sa_knn
        # bit for bit against the replay of its arithmetic on a slice of patches
        p = geo.patches[:REPLAY_PATCHES]
        rows = torch.arange(p.shape[1], device=dev).expand(p.shape[:2]).contiguous()
        z4 = _kernel_choices(p, select_nearest(sq_dists(p, p), knn), rows, sa_wb, pn_wb)[-1]
        enc_differ = replay_check("patch encoder", a[:REPLAY_PATCHES], z4.amax(dim=1))
        del z4
        log(f"patch_encoder vs its replay on {tuple(p.shape)}: {enc_differ} entries differ "
            "(within one ulp)")
        # the winners output (the train step's forward asks for it): the
        # latents bit for bit unchanged, the winners the plain version's
        a_win, win = patch_encoder(geo.patches, sa_wb, pn_wb, knn, return_winners=True)
        if not torch.equal(a_win, a):
            raise RuntimeError("patch_encoder's latents change with the winners output")
        idx = select_nearest(sq_dists(p, p), knn)
        n_win = int((winners_plain(p, idx, pointwise_plain(p, idx, sa_wb, pn_wb), sa_wb, pn_wb)
                     != win[:REPLAY_PATCHES].long()).sum())
        if n_win:
            raise RuntimeError(f"{n_win} of patch_encoder's winners differ from the plain "
                               "version's")
        log(f"patch_encoder with the winners output: latents bit-equal; winners on "
            f"{tuple(p.shape)} equal to the plain version's")
        flops, _, _ = encoder_flops(P, cfg.K, knn, cfg.d)
        w_bytes = nbytes(*[t for wb in sa_wb + pn_wb for t in wb])
        bms, by = bound(flops, nbytes(geo.patches, a) + w_bytes)
        kernels.append(dict(
            name="patch_encoder", route="cuda", source="pcc_tpu_torch/csrc/patch_encoder.cu",
            replaces="pcc_tpu/ops/sa_pallas.py:142", launches=launches["patch_encoder"],
            max_abs_err=err, replay_differ=enc_differ,
            ms=cuda_ms(lambda: patch_encoder(geo.patches, sa_wb, pn_wb, knn), 10),
            plain_ms=cuda_ms(lambda: patch_encoder_plain(geo.patches, sa_wb, pn_wb, knn), 2),
            bound_ms=bms, bound_by=by, library_ms=None,
            winners_ms=cuda_ms(lambda: patch_encoder(geo.patches, sa_wb, pn_wb, knn,
                                                     return_winners=True), 10)))

        kernels.append(decoder_kernel_check(ae, h2, latent_q, w3r, b3r, mlp_wb, packed,
                                            launches["patch_decoder"]))
        for kr in kernels:
            log(f"{kr['name']}: {kr['ms']:.4f} ms (plain {kr['plain_ms']:.4f} ms, "
                f"bound {kr['bound_ms']:.4f} ms by {kr['bound_by']}), "
                f"max_abs_err {kr['max_abs_err']:.3g}, launches {kr['launches']}")

        # 5. the same weights and clouds on the CPU port
        cpu = Codec(cfg, ae_state, prob_state, batch_size=2, device="cpu")
        cpu_streams = cpu.compress_many(clouds[:2])
        for j, ((_, s_card, c_card), (_, s_cpu, c_cpu)) in enumerate(
                zip(streams[:2], cpu_streams)):
            if s_card != s_cpu or c_card != c_cpu:
                raise RuntimeError(f"cloud {j}: card .s.bin/.c.bin differ from the CPU port's")
        got = cpu.decode_symbols(recs[:2], [p for p, _, _ in streams[:2]])
        if not np.array_equal(got, sym[:2]):
            raise RuntimeError("the CPU port decodes the card's .p.bin to other symbols")
        cpu_decoded = cpu.decompress_many(streams[:2])
        _, scale = decode_clouds_packed(cpu.ae, torch.from_numpy(got), cfg)
        for j in range(2):
            longest = np.frombuffer(streams[j][2], np.float32)[3]
            step = scale[j].numpy() / 127.0 * longest / (1.0 - cfg.margin)
            tol = np.repeat(step, cfg.k, axis=0) + 1e-6
            if not np.all(np.abs(cpu_decoded[j] - decoded[j]) <= tol):
                raise RuntimeError(f"cloud {j}: CPU and card decodes differ by more "
                                   "than one int8 step")
        log("cross-device: .s.bin and .c.bin byte-equal, the card's .p.bin decodes "
            "on the CPU to the same symbols, decoded clouds within one int8 step")

    # 6-8. the training path
    chamfer_records, train_launches = {}, {}
    _, rec, launches, train_ms = train_phase(dev, smi, chamfer_records)
    train_launches["N=8192 IPDAE"] = launches
    kernels.append(backward_kernel_check(rec, launches["patch_encoder_bwd"]))
    del rec
    kr = kernels[-1]
    log(f"{kr['name']}: {kr['ms']:.4f} ms (plain {kr['plain_ms']:.4f} ms, bound "
        f"{kr['bound_ms']:.4f} ms by {kr['bound_by']}), launches {kr['launches']}")
    train_card_vs_cpu(dev)

    # 9-11. the PPPF-AE path
    pppf32 = {}
    stage_rec, fps_int_rec = pppf_phase(dev, smi, clouds, kernels[0], pppf32)
    kernels += [stage_rec, fps_int_rec]
    kr = fps_int_rec
    log(f"{kr['name']}: {kr['ms']:.4f} ms for the integer CPM's three stages (plain "
        f"{kr['plain_ms']:.4f} ms, bound {kr['bound_ms']:.5f} ms by {kr['bound_by']}), "
        f"launches {kr['launches']} in one compress -> decompress")
    kr = stage_rec
    log(f"{kr['name']}: {kr['ms']:.4f} ms for the three stages (plain {kr['plain_ms']:.4f} ms, "
        f"bound {kr['bound_ms']:.4f} ms by {kr['bound_by']}), launches {kr['launches']}")

    # 12-14. the PPPF-AE train path
    _, kind_launches, records, fps_calls = pppf_train_phase(dev, smi, chamfer_records)
    train_launches.update({f"N=8192 PPPF-AE {kind}": v for kind, v in kind_launches.items()})
    launches_fused = kind_launches["fused"]
    stage_rec["launches_per_fused_step"] = launches_fused["pppf_sa_stage"] // PPPF_FUSED_STEPS
    kernels.append(pppf_bwd_kernel_check(records, launches_fused))
    kr = kernels[-1]
    log(f"{kr['name']}: {kr['ms']:.4f} ms for the three stages (plain {kr['plain_ms']:.4f} ms, "
        f"bound {kr['bound_ms']:.4f} ms by {kr['bound_by']}), launches {kr['launches']} over "
        f"{PPPF_FUSED_STEPS} fused steps")
    kernels[0]["shapes"] += fps_checks("N=8192 fused PPPF-AE step", fps_calls,
                                       PPPF_TRAIN_CLOUDS, CodecConfig(model="PPPF-AE"))
    del fps_calls
    pppf_train_card_vs_cpu(dev)

    # 15-16. the small-cloud train path; the chamfer kernels on every train path
    kind_launches, fps_calls = small_train_phase(dev, smi, chamfer_records)
    train_launches.update(kind_launches)
    kernels += chamfer_kernel_check(dev, chamfer_records, train_launches)
    kernels[0]["shapes"] += fps_checks("N=512 fused PPPF-AE step", fps_calls, SMALL_CLOUDS,
                                       CodecConfig(N=SMALL_N, model="PPPF-AE"))
    del chamfer_records, fps_calls

    # 17. the SetAbstraction kernel
    with torch.no_grad():
        kernels.append(sa_fused_phase(dev, sa_patches, card.ae.sa))
    sa_state = card.ae.sa.state_dict()                   # phase 38's weights

    # 18. evaluation on the card, on the IPDAE path's decoded clouds
    eval_phase(dev, clouds, decoded)
    del decoded

    # 19-20. the PPPE serving path; the stage kernel's "pppe" layout and FPS there
    per_slot_rec, pppe_rec, fps_recs, kernels[0]["launches_pppe"] = pppe_phase(dev, smi)
    kernels += [pppe_rec, per_slot_rec]
    kernels[0]["shapes"] += fps_recs
    kr = pppe_rec
    log(f"{kr['name']}: {kr['ms']:.4f} ms for sa2 and sa3 (plain {kr['plain_ms']:.4f} ms, "
        f"bound {kr['bound_ms']:.4f} ms by {kr['bound_by']}), launches {kr['launches']} per "
        "PPPE compress batch")

    # 21-22. PPPE training; 23-24. the attribute codec and its training; each
    # kernel of those paths held against its plain version on their inputs
    pppe_train, pppe_checks = pppe_train_phase(dev, smi)
    pppe_train_card_vs_cpu(dev)
    attr, attr_checks = attr_codec_phase(dev, smi)
    attr_train, attr_train_checks = attr_train_phase(dev, smi)
    new_paths = {"PPPE train step": pppe_train["launches_per_step"],
                 "attribute compress batch": attr["launches_per_batch"]["compress"],
                 "attribute decompress batch": attr["launches_per_batch"]["decompress"],
                 "attribute train step": attr_train["launches_per_step"]}
    by_name = {kr["name"]: kr for kr in kernels}
    for kr in kernels:
        if kr["name"] in cuda_lib.KERNELS:
            kr["launches_new_paths"] = {path: counts.get(kr["name"], 0)
                                        for path, counts in new_paths.items()}
    for checks in (pppe_checks, attr_checks, attr_train_checks):
        by_name["fps"]["shapes"] += checks.pop("fps")
        if "chamfer" in checks:      # both chamfer records share one `paths` list
            by_name["chamfer_fwd"]["paths"].append(checks.pop("chamfer"))
        for kernel, rec in checks.items():
            by_name[kernel].setdefault("new_paths", []).append(rec)
    log("phases 21-24: " + json.dumps({"PPPE train": pppe_train, "attribute codec": attr,
                                       "attribute train": attr_train}))

    # 25-26. the launcher on the one card: one rank on NCCL, two over gloo
    log("phases 25-26: " + json.dumps(parallel_phases(smi, train_ms, pppe_train["step_ms"])))

    # 27-29. bf16 serving: both families' paths with their launches, the bf16
    # kernels against their plain versions on the paths' inputs, the CLIs
    enc16, dec16, run27, ae27, streams27 = bf16_ipdae_phase(dev, smi, clouds, ae_state,
                                                            prob_state)
    stage16, run29, states29 = bf16_pppf_phase(dev, smi, pppf32)
    kernels += [enc16, dec16, stage16]
    cli29 = bf16_cli_phase(clouds, {"AE": (ae27, prob_state),
                                    "PPPF-AE": (states29["ae_state"], states29["prob_state"])},
                           streams27)
    log("phases 27-29: " + json.dumps({"IPDAE bf16": run27, "PPPF-AE bf16": run29,
                                       "CLIs": cli29}))

    # 30. the large-scene rooms through the codec: FPS past 16384 points
    room_fps, rooms30 = large_scene_phase(dev, ae_state, prob_state, cpu)
    kernels[0]["shapes"] += room_fps
    kernels[0]["launches_rooms"] = rooms30["launches_compress"]["fps"]

    # 31-34. bf16 IPDAE training: the step with its launches, the bf16 encoder
    # backward and bf16_reduce against their plain versions on its inputs,
    # a TINY step card vs CPU, the train CLI into the bf16 codec
    rec31, grids31, launches31, train31 = bf16_train_phase(dev, smi)
    by_name = {kr["name"]: kr for kr in kernels}
    by_name["patch_encoder_bf16"]["launches_bf16_train_step"] = \
        launches31["patch_encoder_bf16"] // TRAIN_STEPS
    kernels.append(bf16_backward_check(rec31, launches31))
    kernels.append(bf16_reduce_check(grids31, launches31))
    del rec31, grids31
    cert32 = cert_model_check()
    card33 = bf16_step_card_vs_cpu(dev)
    cli34 = bf16_train_cli_phase(clouds)
    log("phases 30-34: " + json.dumps({"large-scene rooms": rooms30, "bf16 train": train31,
                                       "certified.cuh's model": cert32,
                                       "bf16 TINY card vs CPU": card33, "train CLI": cli34}))

    # 35-37. the PN++ families' bf16 training: PPPF_AE in bf16 with its
    # encoder frozen (the bf16 store mode and stage backward), PPPE's bf16
    # step and CLI, and PPPF-AE's float32 step under --bf16
    kernels += pppf_bf16_train_phase(dev, smi)
    pppe36 = pppe_bf16_train_phase(dev, smi)
    cli37 = pppf_bf16_cli_phase()
    log("phases 35-37: " + json.dumps({"PPPE bf16 train": pppe36, "PPPF-AE --bf16": cli37}))

    # 38. SetAbstraction in bf16 on sa_fused.cu's bf16 instance; 39. PPPE's
    # bf16 eval mode; 40. the bf16 "pppe" stage on its inputs and the per-slot route
    with torch.no_grad():
        kernels.append(sa_bf16_phase(dev, sa_patches, sa_state))
    del sa_patches
    pppe39, stage_calls = pppe_bf16_phase(dev, smi)
    with torch.no_grad():
        kernels.append(pppe_bf16_stage_check(stage_calls, pppe39["launches"]))
    del stage_calls
    log("phases 38-40: " + json.dumps({"PPPE bf16 eval": pppe39}))
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
