#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths once each: the chain export_odom ->
forecast_fused -> evaluate_panoptic (``python -m
panoptic_forecasting_tpu_torch.cli.{export_odom,forecast_fused,
evaluate_panoptic}``, phases 12-13), the paper's staged chain
prepare_gt_nofg -> prepare_bg_data -> export_segmentation ->
export_panoptic / export_instances -> evaluate_panoptic /
evaluate_instances -> viz_panoptic (phase 14), training of the odometry
and fg models (``cli.train``, phase 15) and of the bg model, whose
trained weights then serve through K2 (phase 16), the same training
data-parallel (``cli.train --distributed``, phase 17), the same paths
with ``model.compute_dtype: bfloat16`` and under each model option
(phase 18), the pc, odometry and fg data options and the PNG kinds the
decoder expands (phase 19), the host IO layer ``native`` under the
serving CLI on adaptively filtered PNGs (phase 20), and the single-call panoptic
forecast (``panoptic_forecasting_tpu_torch.eval.build_forecast_step``) at
full width: FCHarDNet-70 (configs/bg/bg_val_short.yaml: 3 reprojected
frames, one-hot + depth, 11 stuff classes, folded BN, 1024x2048) and the
foreground model of configs/fg/fg_val_short.yaml (rnn_hidden 128, 2
ConvLSTM layers, 2 trajectory-output layers, 256x14x14 ROI features,
mask head conv_dim 256), 8 instance slots, out_t = 3. Weights are random
from a fixed seed; inputs are synthetic, made as bench.py's fused
benchmark makes them. The profiling entry points of the kernels off the
forecast path, K3 (``scripts/prof_minwin.py``, 3 frames of 1024x2048 =
6.29 M entries) and K4 (``scripts/prof_strided_load.py``, 8x2048), at
their scripts' sizes, and the exact z-buffer (``PCTransformModel``).

Phases (any failure exits non-zero):
  1. build the four CUDA sources from csrc/ with nvcc and the host IO
     library (csrc/native_io.cpp) with the host compiler, all in parallel;
  2. K1 on a full-size stream from a real reprojection: the forecast
     path's fused placement + corner fold (place_min_fold) and the
     generic place_min, each bit-equal to its plain version; place_min
     also on K3's coherent stream, whole warps on one group, a uniform
     stream over the forecast's canvas and all of it in one tile (timed:
     one bucket holds the stream), with each stream's largest buckets;
     edge cases (B = 2, ceil corners in the last column and row, ignored
     groups, key 0, N = 0, every entry on one pixel; for place_min a
     one-group canvas, one below a tile, one group past whole tiles,
     every entry on one group or in one tile, keys 0 and 2^31 - 2, a
     stream at a 4-byte offset, more tiles than a shared histogram);
  3. K2 (onehot_stem_conv) against its plain version at (1,3,1024,2048)
     and at edge shapes (ragged tiles, H = 2, W not a multiple of 4, a
     misaligned input, batched, no depth, other C, ids outside [0, C)):
     max abs diff <= 1e-5 (f32 sums taken in another order);
  4. the full-width step with every launch counter set to 0 just before
     and read just after: place_min_fold and onehot_stem_conv must have
     launched, the generic place_min not;
  5. the same step on the GPU and on the CPU at 256x512: ids equal,
     panoptic maps differing on < 1e-3 of pixels;
  6. timings with CUDA events and profiler device time after warm-up
     (kernels, their plain versions, one PyTorch library call each, the
     z-buffer placement layer before and after the fused fold, one whole
     step);
  7. K3 (place_minwin) on the 6.29 M-entry stream of its entry point:
     canvas bit-equal to its plain version and to K1, overflow equal to
     the plain version's, and no plain overflow count called on the card
     (patched to raise); then canvas and overflow bit-equal on the
     forecast stream (no block's span fits a window) and on edge cases
     (key 0, sentinels, negative groups with and without the pile split,
     runs of equal groups, N not a multiple of 32, N = 0, overflow > 0,
     coherent streams at blocks of 512, 2048, 8192 and 32768 (four tiles
     a CTA), a block of 518 and a misaligned copy (scalar loads));
  8. the three K4 probes (strided_load) bit-equal to their plain versions
     on arange(8·2048), a seeded random (64, 4096), C % 4 == 2, C % 8 ==
     4, inputs at storage offsets 1 and 4 and (8192, 8192), both lane
     offsets;
  9. the exact z-buffer through PCTransformModel at 1024x2048, with
     panoptic ids (>= 11000) and with an RGB payload, timed, sort equal
     to scatter; GPU against CPU at 256x512, bit-equal;
 10. the entry points of K3 and K4 (scripts/prof_minwin.py,
     scripts/prof_strided_load.py) with their launch counters set to 0
     just before each and read just after: each kernel (and the generic
     place_min, which prof_minwin compares against) must have launched;
 11. timings of K3 (its whole call: canvas and overflow from one launch)
     and K4 (kernels, plain versions, library calls; K4 also at (8192,
     8192), beside the launch floor of a one-element zero_), K3 beside K1
     on four streams with place_min's passes one by one, and the device
     time from torch.profiler
     (``device_ms``: CUDA events around back-to-back calls of a small
     kernel time the host) of each kernel and of each K4 library call;
 12. the serving CLI (``cli/forecast_fused.py::run``) on a 1024x2048
     fixture from the port's data/synthetic.py (7 Cityscapes snippets, 6
     fg scenes of 8 instance slots with 256x14x14 features, predicted
     odometry, bg canvases) with seeded weights of the two configs above,
     bg in the port's checkpoint, fg with box statistics of the frame as
     a reference-format ``.pt`` (``--load_torch_model``), launch counters
     set to 0 just before and read just after: place_min_fold and
     onehot_stem_conv once per frame, the generic place_min never; each
     PNG equal to the step's map on the same frame's inputs, the json
     listing every frame and the backfilled gt frame, instances painted;
     per-frame host times of the pc fetch, the fg batch, the step and the
     PNG write, and frames per second; then a 256x512 run of the CLI on
     the card against the same on the CPU (segment ids equal, < 1e-3 of
     pixels differing, instances painted) and the PNG decode time at
     1024x2048. A reader format whose package (pandas, h5py) is missing
     here is served from the fixture's in-memory store, which also takes
     the h5 writes (``data/synthetic.py::readers_from_store``); the
     script prints which of PyYAML, Pillow, pandas and h5py import;
 13. serve and score on the phase 12 fixture: ``export_odom`` on the
     card with configs/odom/odom_val.yaml's model (seeded, in the port's
     checkpoint) over the Cityscapes table (``odometry_val.h5``) and the
     fg table (``predicted_odometry_val.h5``), read back through
     ``io.open_h5``: one forecast for every window of the odometry
     dataset, the readers' start 16 among them, equal to the CPU export
     to 1e-5; the CLI on those files, launches counted as in phase 12,
     every forecast its pc and fg readers look up read from the exports
     (recorded at ``io.open_h5``) and equal to the exported array, none
     from the fixture's own odometry files, its PNGs equal to the step's
     maps on the same inputs and unlike phase 12's; the fixture's gtFine
     converted (``convert_gt_split``) and scored with
     ``evaluate_panoptic`` against itself (PQ 1 on every valid class)
     and against the CLI's maps; the 256x512 GPU and CPU exports of
     phase 12 scored (equal PQ where the maps are equal, else < 1e-3
     apart); export ms per batch over a val-sized table (500 snippets:
     median and range of 3 passes), GT conversion s, PQ s per frame and
     PQ All/Things/Stuff printed with the card's name and power limit;
 14. the staged chain on the phase 12 fixture, the launch counts set to
     0 just before each CLI and read just after: prepare_gt_nofg;
     prepare_bg_data with configs/pc_transform/pc_export.yaml (gap 3),
     its depth h5 into the store (``io.append_h5``), 3 place_min_fold a
     pc batch; the bg canvases (export_segmentation with
     configs/bg/bg_val_short.yaml, ``gap_len [3]``, ``no_convert``), 1
     onehot_stem_conv a bg batch; export_panoptic over them; the generic
     place_min never. The canvases equal, off the bg's near-ties, the
     step's bg fed the staged chain's inputs (labelIds converted after
     the splat, depth through its uint16 encoding), the panoptic maps
     there within 1e-3; the staged maps against phase 12's fused PNGs:
     < 2.5 % of pixels, each segment in one map only under 256 pixels,
     and the share of differing pixels where the z-buffer holds label 0
     (road in the fused step, void in the staged chain), reported;
     evaluate_panoptic; export_instances and evaluate_instances (allAp
     0, NaN per class: the fixture has no GT instance) and a 1024x2048
     instance map with two thing instances scored against its own masks
     (AP 1); viz_panoptic on one frame; the chain at 256x512 on the card
     against the CPU (canvases and panoptic maps: ids equal, < 1e-3).
     Prints ms per frame of each stage and PQ and AP s per frame;
 15. training (``python -m panoptic_forecasting_tpu_torch.cli.train``,
     its ``main``) on the card with the launch counts set to 0 just
     before each run and read just after (the training path reaches no
     kernel of the port; printed): configs/odom/odom_train.yaml at full
     width (batch 32, GRU 128) on phase 13's 500-snippet table, 2 epochs
     of 25 steps; configs/fg/fg_train.yaml at full width (batch 32, GRU
     128, 2 ConvLSTM layers over 256x14x14 features) on a 10-scene fg
     fixture with a train split (>= 32 tracks), 2 epochs of 10 steps,
     then resumed for a third: it continues at step 20 with the saved
     Adam state (30 Adam steps after it), and its epoch agrees with a
     straight 3-epoch run within 1e-3 of each loss (the fg runs take
     cuDNN's deterministic algorithms); the losses finite. Then 20 steps of each model
     on one fixed batch (the fg loss must fall): ms per step by CUDA
     events (median and range after 3 of warm-up), samples/s, peak
     memory above the earlier phases' tensors, device-busy ms per step
     from torch.profiler over 5 steps and kernel launches per step, with
     the card's name and power limit; and one fg step at narrow widths
     on the card against the CPU: losses within 1e-4 relative, each
     parameter within lr·|Δg|/eps + 4 ulp (Adam's first step);
 16. bg training (``cli.train``) with configs/bg/bg_train.yaml at full
     width (FCHarDNet-70, 36 inputs, 11 classes, batch 8 of 800x800
     scale-jittered crops, SGD; val batch 4 at 1024x2048) on a
     1024x2048 ``write_bg_fixture`` tree (both gap groups, 8 train
     samples, depth through the in-memory store), the launch counts set
     to 0 just before each run and read just after (0 of every kernel):
     2 epochs of 3 steps, resumed for a third, which agrees with a
     straight 3-epoch run within 1e-3 of each loss (cuDNN deterministic
     for these runs) and continues from the saved BN statistics and SGD
     momentum; 20 steps on one fixed batch (the loss must fall): ms per
     step by CUDA events, images/s, peak memory of the step's own,
     device-busy ms and share, launches per step, the step's operations
     (``torch.utils.flop_counter``) and TFLOP/s against the f32 bound;
     the loader's ms per batch apart from the step; one step at crop
     128, batch 2 on the card against the CPU and the CPU in float64
     (loss within 1e-4 relative; the card's running statistics and
     gradient no farther from the float64 step than twice the CPU's f32
     step is, + 1e-5 of each statistic tensor's largest entry, + 1e-3
     relative L2 over all gradients: HarDNet's f32 step at batch 2 is
     itself ~1e-1 of a tensor's largest entry from float64, as ReLU
     inputs sit within rounding of their kinks; each tensor's largest
     gaps printed); the trained ``best_model``
     served by ``export_segmentation`` (folded: one onehot_stem_conv per
     bg batch and no other kernel), its class maps equal to the same
     weights' unfolded eval graph but at top-2 logit gaps < 1e-3 (fewer
     than 1e-3 of pixels);
 17. data parallelism (``cli.train --distributed``; the launch counts set
     to 0 just before each run and read just after: 0 of every kernel),
     each rank a process of this script (``--dp-rank``) with a timeout,
     cuDNN deterministic: (a) NCCL at world size 1 through torchrun's
     environment on bg_train.yaml as phase 16 ran it (2 epochs of 3
     steps): the backend NCCL, the epoch losses and ``best_model``
     bit-equal to phase 16's; (b) two gloo ranks on the one card (NCCL
     refuses two ranks on one device) for odom_train.yaml (batch 32, 16
     a rank, 2 x 25 steps on phase 15's table), fg_train.yaml (2 x 10 on
     phase 15's fixture) and bg_train.yaml (8, 4 a rank; 2 x 3 on phase
     16's), each against its one-process run of phases 15-16: both ranks
     equal, losses finite; odom's every epoch's train and val loss within
     1e-4 relative and every parameter within 1e-4 of its tensor's
     largest entry; fg's and bg's f32 runs drift apart beyond that while
     their steps agree (PERF.md §6), so they are held to a
     float64 step as phase 16 holds the card to the CPU: the first step
     in float64 on two ranks within 1e-6 of the one-process step (each
     gradient, bg's BN statistics, over the tensor's largest entry), and
     the two-rank f32 step no farther from it than twice the one-process
     f32 step + 1e-3 (relative L2 of the gradients) or + 1e-5 (BN
     statistics); fg's epoch losses within 1e-4 still; every first step
     in f32 printed against the one-process one (gradients, and the
     parameters against the step's rounding bound); bg resumed for a
     third epoch against a straight two-rank run (within 1e-3), rank 1
     writing nothing under the working dirs (an audit hook) and rank 0
     writing every file; (c) rank 0's bg ``best_model`` served by
     ``export_segmentation`` (K2 once per bg batch, no other kernel), its
     class maps equal to its own unfolded eval graph's but at top-2 logit
     gaps < 1e-3 (fewer than 1e-3 of pixels), and the pixels apart from
     the one-process checkpoint's export printed; (d) a two-rank bg step
     on rank 0: its ms, and every
     all-reduce of a step counted, sized and timed (BN forward and
     backward, the valid count, the gradient), with the card's name and
     power limit (both ranks share the card: no scaling figure).
 18. bf16 and the model options: (a) the forecast step of
     bg_val_short.yaml + fg_val_short.yaml with model.compute_dtype
     bfloat16 at 1024x2048, counted (K1 once, K2 once, through its bf16
     entry, whose output equals the f32 entry's rounded to bf16 bit for
     bit, on the step's stem inputs and 6 edge shapes), its class map
     against the same weights' f32 step (>= 0.98 of bg pixels equal), both
     steps' ms and busy share; (b) the bf16 models on the card against the
     CPU's at 256x512: bg logits, the fg forecast's trajectories, masks and
     mask features no farther from the CPU's bf16 than the CPU's bf16 from
     its f32 (relative L2), class maps equal off top-2 gaps < 0.05, the
     step's ids equal and its panoptic maps no farther apart than the
     CPU's bf16 and f32 maps; (c) fg_train.yaml and bg_train.yaml in bf16: 7
     fixed-batch steps each (losses finite and falling), ms, samples/s,
     peak memory and busy beside phases 15-16's f32 steps, and one narrow
     fg step on the card against the CPU's bf16 step (the same yardstick,
     loss and weight gradients); (d) cli.forecast_fused on phase 12's
     256x512 fixture under rnn_type lstm, each ablation flag,
     use_bbox_ulbr and convert2onehot false (seeded weights of each
     option's model), counted (K1 per frame, K2 per frame, none for raw
     ids), against the same on the CPU (ids equal, < 1e-3 of pixels); a
     4-step cli.train of fg_train.yaml with the LSTM (bias_ih_l0 still 0,
     no kernel launched) and its narrow step against the CPU (phase 15's
     bounds).
 19. the data options, each CLI counted: (a) prepare_bg_data and the pc
     export (configs/pc_transform/pc_export.yaml) at 1024x2048 on one
     snippet under use_cascade_disps with disparity_dir, use_mono
     (192x640 .npy disparities), expand_test (15 targets) and cities:
     place_min_fold 3x per pc batch (prepare) and 1x (export), place_min
     never; a second run of each with check_output_dir on the first's
     outputs launches nothing and writes nothing; (b) the use_imgs export
     (is_img): one RGB frame through the exact z-buffer, no K1; (c)
     cli.forecast_fused on phase 12's fixture with a cascade pc config: K1
     and K2 once a frame; (d) the card against the CPU: every output file
     of (a)-(b) equal at 256x512 (mono at 1024x2048, the only size its
     depth takes), the cascade CLI's ids equal and < 1e-3 of pixels
     apart (phase 12's budget); (e) cli.train of odom_train.yaml with
     load_imgs (1024x2048 frames, short side 256; batch 8, 2 steps) and of
     fg_train.yaml with use_condensed_feats (2 steps), each with the same
     losses as the run without the option, no kernel launched, and the
     image loader's ms a batch; (f) the decode ms of a 1024x2048 Adam7 and
     a palette label map beside phase 12's plain one.
 20. native IO (``native``: the compiled PNG row codec under every PNG
     read and write of the port): the host compiler's version, its build
     seconds and the CPU count; phase 12's 1024x2048 label and disparity
     files and an RGB frame, each as the fixture writes it (unfiltered)
     and rewritten with libpng's per-row filters (``FILTER_ADAPTIVE``),
     decoded by ``native`` and by the plain codec (``data/png.py``):
     arrays equal, ms of each, the rows of each filter; six adaptively
     filtered disparity files through ``load_png_batch`` on 1 and 6
     threads; ``save_png`` at ``PNG_IDS`` and ``PNG_SMOOTH16`` against
     ``png.encode_png``: bytes equal, ms of each; then every PNG of phase
     12's fixture rewritten adaptively and the serving CLI run on it with
     the launch counts set to 0 just before and read just after: K1's fold
     and K2 once a frame, the generic place_min never, every panoptic file
     byte-equal to phase 12's, its pc_fetch, png_write and frames/s;
     phase 16's bg loader ms per batch (its PNGs through the native batch
     decode); and in turns (plain, native, native, plain) the bg loader
     and the pc fetch on the adaptive fixture with the PNG reads as the
     port made them before ``native`` (the plain codec, file by file)
     and through ``native``.
 21. the step's inputs (``eval/inputs.py``: each host input copied once
     into its own pinned tensor and moved by its own DMA, the fg and
     fusion inputs after bg is launched) at 1024x2048 with 8 and 32 slots:
     over 24 frames of 4 scenes, once with a synchronize after each call
     and once with none, every output bit-equal to the same step fed the
     inputs already on the device (which stages nothing); the counters,
     the copies a frame; the CUDA calls that block the host in a
     profiled step, by ``pf.*`` span; the host pass alone, the DMA alone
     (GB/s), the pc staging's host ms and the fg staging's; 8 calls of
     the inputs issued behind a sleep of the copy stream, each bit-equal
     to its inputs (the pinned memory's reuse guard; ``[inputs]`` lines;
     readings under the JSON's ``inputs``).
     ``python3 chip_smoke.py --inputs`` builds K1 and K2 and runs this
     phase alone.
 22. bg training's step replayed from CUDA graphs (``train/graph.py``)
     at the benchmark's pool8 shape (FCHarDNet-70, batch 8 of 800x800,
     SGD, clip-norm 5, f32) on 12 seeded batches: one ``train()`` run
     graphed against three eager ones from the same weights (the eager
     runs with the graphs' seam set aside), cuDNN's default algorithms:
     the counters 1 capture, 11 replays, the first step eager, every
     replayed batch staged through the pinned buffers; the final
     state (relative L2) and the step losses (mean relative gap) no
     farther from each eager run than twice the eager runs' own spread
     (cuDNN's weight gradient is not bit-deterministic), the first losses
     equal; host ms a step untraced, peak memory; kernels a step in a
     device-only trace equal graphed and eager (memsets, copies and the
     kinds whose counts differ printed), and in a trace with host events
     the kernels and memsets launched in each ``pf.train.*`` span a step,
     those of ``pf.train.optim`` equal and not 0; the HtoD copies' device
     ms a step in each run's host-event trace, and the ms of them that a
     kernel ran beside. Then 2 epochs of 3
     steps under ``lr_decay_type: step`` (the rate a tenth in epoch 2)
     with cuDNN's deterministic algorithms: graphed bit-equal to eager,
     the update graph captured again once; held at epoch 1's rate, not
     equal. Then 8 steps graphed with a ``torch.cuda._sleep`` on the
     compute stream before each DtoD into the captured inputs (each next
     DMA waits for it, and the host for that DMA), bit-equal to eager
     under deterministic cuDNN, the host's waits counted. Then
     ``portbench/control.py`` on ``bg_train.pool8``: the program's run
     correct and each of the cell's training faults caught by its check
     (``[graph]`` lines; readings under the JSON's ``graph``). Phases
     15-17 print each run's step-graph counters: odom and fg (Adam) every
     step eager under ``optimizer``, bg replayed after its first step,
     every data-parallel run eager under ``ranks``. ``python3
     chip_smoke.py --graphs`` runs this phase alone, ``--training``
     phases 15-17 and 22.

Prints the card's name and power limit, one JSON line describing every
kernel (both K1 entry points, K2 and its bf16 entry, K3 and each K4
probe) and the CLI's, the scoring's, the staged chain's, the training's
(bg's under ``train.bg``, data parallelism's under ``train.dp``),
phase 18's readings (``bf16``), phase 19's (``data_options``), phase
20's (``native_io``), phase 21's (``inputs``) and phase 22's
(``graph``), and last
a JSON line
{"ok": true, "device": {...}}. Exits non-zero without a result when
CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from panoptic_forecasting_tpu_torch import native
from panoptic_forecasting_tpu_torch.cli import (
    evaluate_instances, evaluate_panoptic, export_instances, export_odom,
    export_panoptic, export_segmentation, forecast_fused, prepare_bg_data,
    prepare_gt_nofg, viz_panoptic,
)
from panoptic_forecasting_tpu_torch.cli import train as train_cli
from panoptic_forecasting_tpu_torch.cli.common import restore_params, setup
from panoptic_forecasting_tpu_torch.core import build_dataset, build_model
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.core.config import Config, load_config
from panoptic_forecasting_tpu_torch.data import io as data_io, pc_data, png, synthetic
from panoptic_forecasting_tpu_torch.data.cityscapes import id_to_train_id_lut
from panoptic_forecasting_tpu_torch.data.io import load_png, save_png
from panoptic_forecasting_tpu_torch.eval import build_forecast_step, inputs as step_inputs
from panoptic_forecasting_tpu_torch.eval.panoptic_protocol import (
    convert_gt_split, relabel_panoptic_trainid_to_labelid,
)
from panoptic_forecasting_tpu_torch.eval.pq import decode_panoptic_png
from panoptic_forecasting_tpu_torch.geometry import rdf_T_flu, unicycle_now_T_prev
from panoptic_forecasting_tpu_torch.kernels import build, strided_load
from panoptic_forecasting_tpu_torch.kernels.experimental import minwin
from panoptic_forecasting_tpu_torch.kernels.experimental.minwin import (
    place_minwin, place_minwin_plain,
)
from panoptic_forecasting_tpu_torch.kernels.placement import (
    EMPTY, fold_corners, fold_targets, place_min, place_min_fold,
    place_min_fold_plain, place_min_plain, place_min_plan,
)
from panoptic_forecasting_tpu_torch.kernels.stem import (
    assemble_onehot, onehot_stem_conv, onehot_stem_conv_plain,
)
from panoptic_forecasting_tpu_torch.kernels.zbuffer import (
    decode_canvas, splat_stream, zbuffer_splat,
)
from panoptic_forecasting_tpu_torch.models import BGModel, FGModel, OdomModel, seeded_init_
from panoptic_forecasting_tpu_torch.models.base import init_weights
from panoptic_forecasting_tpu_torch.models.pc_transform import (
    PCTransformModel, _camera_maps, pc_transform_predict, reproject,
)
from panoptic_forecasting_tpu_torch.parallel import mesh
from panoptic_forecasting_tpu_torch.scripts import prof_minwin, prof_strided_load
from panoptic_forecasting_tpu_torch.train import graph as step_graph, loop as train_loop
from panoptic_forecasting_tpu_torch.train.loop import to_device
from panoptic_forecasting_tpu_torch.train.optim import build_optimizer
from panoptic_forecasting_tpu_torch.scripts._timing import (
    device_ms, kernel_profile, time_ms,
)

SEED = 0
H, W, T_IN = 1024, 2048, 3
H_SMALL, W_SMALL = 256, 512
N_INST, OUT_T = 8, 3
INTR = (2262.52, 2265.30, 1096.98, 513.137)  # bench.py's Cityscapes camera
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOP_PER_S = 67e12  # H100 SXM, non-tensor f32

BG_CFG = {
    "model": {"num_inputs": T_IN, "use_depth_inps": True,
              "convert2onehot": True},
    "data": {"num_classes": 11, "min_depth": 0.1, "max_depth": 200},
}
FG_CFG = {
    "model": {
        "instance_feat_channels": 8, "instance_feat_hidden": 64,
        "num_convlstm_layers": 2, "num_traj_out_layers": 2,
        "rnn_hidden": 128, "rnn_type": "gru", "traj_feat_channels": 16,
        "use_depth_inp": True, "use_odometry": True,
        "use_depth_sorting": True, "mask_head": {},
    },
}
DEPTH_STATS = (20.0, 12.0)


def fg_stats(width: int):
    """Normalisation statistics of the synthetic traffic (data-card
    stand-ins); box statistics in pixels of a ``width``-wide image."""
    s = width / 2048.0
    return {
        "traj": (np.array([1024, 512, 150, 150, 0, 0, 0, 0]) * s,
                 np.array([300, 80, 40, 40, 10, 5, 2, 2]) * s),
        "depth": ([20.0, 0.0], [10.0, 1.0]),
        "odom": ([8.2, 0.0, 0.5, 0.0, 0.0], [0.3, 0.01, 0.02, 1.0, 1.0]),
    }


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_models(device, height: int = H, width: int = W):
    """Full-width bg (folded, output at height x width) and fg models,
    weights from SEED."""
    cfg = copy.deepcopy(BG_CFG)
    cfg["model"].update(final_h=height, final_w=width)
    bg = seeded_init_(BGModel(cfg, depth_stats=DEPTH_STATS, device="cpu"), SEED)
    bg = bg.maybe_fold().to(device)
    fg = seeded_init_(FGModel(FG_CFG, stats=fg_stats(width), device="cpu"),
                      SEED + 1)
    return bg, fg.to(device)


def make_inputs(height: int, width: int, n: int = N_INST, seed: int = SEED):
    """Synthetic pc + fg inputs (numpy), as bench.py::measure_fused makes
    them: random stuff labels, depths 2-52 m, a car driving ~8 m/s, ``n``
    instance slots."""
    rng = np.random.RandomState(seed)
    s = width / 2048.0
    seg = rng.randint(0, 11, size=(1, T_IN, height, width)).astype(np.int32)
    depth = (rng.rand(1, T_IN, height, width) * 50 + 2).astype(np.float32)
    K = np.array([[INTR[0] * s, 0, INTR[2] * s], [0, INTR[1] * s, INTR[3] * s],
                  [0, 0, 1]], np.float32)
    E = (np.array([[1, 0, 0, 0.3], [0, 1, 0, 0.0], [0, 0, 1, 1.2],
                   [0, 0, 0, 1]], np.float32) @ rdf_T_flu()).astype(np.float32)
    Ts = unicycle_now_T_prev(np.array([8.0, 8.2, 8.4], np.float32),
                             np.array([0.01, 0.0, -0.01], np.float32), 0.18).numpy()
    pc_in = {
        "seg": seg, "depth": depth,
        "depth_mask": np.ones_like(depth, bool),
        "intrinsics": K[None], "extrinsics": E[None], "target_T": Ts[None],
    }
    t_all = T_IN + OUT_T
    box0 = np.stack([rng.uniform(300, 1750, n), rng.uniform(350, 650, n),
                     rng.uniform(60, 250, n), rng.uniform(60, 250, n)], -1) * s
    vel = rng.uniform(-8, 8, (n, 4)) * s
    vel[:, 2:] *= 0.2
    traj = np.zeros((n, T_IN, 8), np.float32)
    for t in range(T_IN):
        traj[:, t, :4] = box0 + t * vel
        traj[:, t, 4:] = vel if t else 0.0
    d0 = rng.uniform(6, 40, n)
    depths = np.stack([d0[:, None] + np.arange(T_IN) * 0.1,
                       np.full((n, T_IN), 0.1)], -1).astype(np.float32)
    vel_mask = np.ones((n, t_all), bool)
    vel_mask[:, 0] = False
    odom = np.zeros((n, t_all, 5), np.float32)
    odom[..., 0] = 8.2 + rng.randn(n, t_all) * 0.1
    odom[..., 1] = rng.randn(n, t_all) * 0.01
    odom[..., 2] = 0.5
    fg_in = {
        "trajectories": traj,
        "bbox_masks": np.ones((n, t_all), bool),
        "bbox_vel_masks": vel_mask,
        "depths": depths,
        "depth_masks": np.ones((n, T_IN, 1), bool),
        "feats": np.maximum(rng.randn(n, T_IN, 256, 14, 14), 0).astype(np.float32),
        "odometry": odom,
        "classes": rng.randint(0, 8, n),
        "output_inds": np.full(n, OUT_T - 1),
        "valid": np.ones(n, bool),
    }
    return pc_in, {k: v[None] for k, v in fg_in.items()}


def pc_args(pc_in, device):
    """Step 1's arguments to the reprojection: each past frame its own
    batch entry (B·T, 1, H, W), camera matrices left on the host."""
    def flat(x):
        x = torch.as_tensor(x)
        return x.reshape((T_IN, 1) + tuple(x.shape[2:]))

    return (
        flat(pc_in["seg"]).to(device), flat(pc_in["depth"]).to(device),
        flat(pc_in["depth_mask"]).to(device),
        torch.as_tensor(pc_in["intrinsics"]).repeat_interleave(T_IN, 0),
        torch.as_tensor(pc_in["extrinsics"]).repeat_interleave(T_IN, 0),
        flat(pc_in["target_T"]).reshape(T_IN, 1, 4, 4),
    )


def k1_inputs(pc_in, device):
    """The (group, key) stream K1 gets in the step (one canvas per frame)."""
    uv, z, label, valid = reproject(*pc_args(pc_in, device), height=H, width=W)
    return splat_stream(uv, z, label, valid, height=H, width=W)


def k2_inputs(bg, pc_in, device):
    """The fused stem's inputs in the step: the per-frame reprojected seg
    canvases and their normalised, masked depth channels."""
    rep = pc_transform_predict(*pc_args(pc_in, device), height=H, width=W)
    rep_depth = rep["depth"].reshape(1, T_IN, H, W)
    seg, dep = bg.stem_inputs({"seg": rep["seg"].reshape(1, T_IN, H, W),
                               "depth": rep_depth.clamp(min=0.0),
                               "depth_mask": rep_depth > 0})
    conv = bg.model.base[0].conv
    kern = conv.weight.detach().permute(2, 3, 1, 0).contiguous()
    return seg, dep, kern, conv.bias.detach()


def fold_edge_cases(dev):
    """place_min_fold against its plain version off the
    main path's stream: B = 2 with every plane and ignored groups, ceil
    corners in the last column and row, one pixel for every entry, N = 0,
    a width that is no power of two."""
    g = torch.Generator().manual_seed(SEED + 7)

    def keys(n):
        k = torch.randint(0, 2**31 - 2, (n,), generator=g, dtype=torch.int32)
        k[::9] = 0
        return k

    cases = {}
    b, h, w = 2, 6, 10
    cases["b2_all_planes_ignored"] = (
        torch.randint(-50, b * 4 * h * w + 50, (5000,), generator=g,
                      dtype=torch.int32), b, h, w)
    b, h, w = 2, 33, 70
    p = h * w
    last_col = torch.arange(h) * w + w - 1
    last_row = (h - 1) * w + torch.arange(w)
    edge = [bb * 4 * p + plane * p + pix for bb in range(b)
            for plane, pix in ((1, last_col), (3, last_col), (2, last_row),
                               (3, last_row), (0, last_row), (1, last_row))]
    cases["last_col_row"] = (torch.cat(edge).int().repeat(3), b, h, w)
    b, h, w = 1, 16, 24
    cases["one_pixel"] = (torch.full((70_001,), 3 * h * w + 5 * w + 7,
                                     dtype=torch.int32), b, h, w)
    cases["empty"] = (torch.zeros(0, dtype=torch.int32), 1, 4, 6)
    b, h, w = 3, 37, 54
    cases["odd_width"] = (torch.randint(-9, b * 4 * h * w, (200_000,),
                                        generator=g, dtype=torch.int32), b, h, w)
    for name, (grp, b, h, w) in cases.items():
        grp, k = grp.to(dev), keys(grp.numel()).to(dev)
        want = place_min_fold_plain(grp, k, batch=b, height=h, width=w)
        folded = fold_corners(place_min_plain(grp, k, b * 4 * h * w), b, h, w)
        if not torch.equal(folded, want):
            raise SystemExit(f"K1 fold edge case {name}: the plain version "
                             "differs from the 4-plane canvas folded")
        if not torch.equal(place_min_fold(grp, k, batch=b, height=h, width=w),
                           want):
            raise SystemExit(f"K1 fold edge case {name} differs from its "
                             "plain version")
    print(f"[edge] K1 place_min_fold bit-equal on "
          f"{', '.join(cases)}")


def offset_copy(x, by):
    """The same values ``by`` elements past an aligned start."""
    flat = torch.empty(x.numel() + by, dtype=x.dtype, device=x.device)
    flat[by:] = x.reshape(-1)
    return flat[by:].view(x.shape)


def k1_edge_cases(dev):
    """place_min against its plain version on the tile-owned passes' edge
    shapes: a one-group canvas, a canvas below one tile, one group past
    whole tiles, N = 0, every entry on one group, every entry in one
    tile, negative groups and groups >= num_groups (2^31 - 1 and -2^31
    among them), keys 0 and 2^31 - 2, a stream at a 4-byte storage offset
    (scalar loads), and more tiles than a shared histogram holds (the
    counts through the global counters)."""
    g = torch.Generator().manual_seed(SEED + 8)
    tile = place_min_plan(1, 2**30)["tile"]

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int32)

    def keys(n):
        k = randint(0, 2**31 - 1, n)
        k[::9] = 0
        k[1::9] = 2**31 - 2
        return k

    ignored = randint(-5 * tile, 5 * tile, 300_000)
    ignored[::7] = 2**31 - 1
    ignored[3::7] = -2**31
    cases = {
        "one_group_canvas": (randint(-3, 4, 5000), 1),
        "below_one_tile": (randint(-50, 5050, 20_000), 5000),
        "one_past_tiles": (randint(-50, 3 * tile + 51, 200_000), 3 * tile + 1),
        "empty": (torch.zeros(0, dtype=torch.int32), 3 * tile + 1),
        "one_group": (torch.full((70_001,), 3 * tile, dtype=torch.int32),
                      3 * tile + 1),
        "one_tile": (tile + randint(0, tile, 100_000), 4 * tile),
        "ignored_groups": (ignored, 4 * tile - 3),
        "global_counts": (randint(0, 2**28, 1_000_003), 2**28),
    }
    plans = {}
    for name, (grp, n_groups) in cases.items():
        grp, k = grp.to(dev), keys(grp.numel()).to(dev)
        want = place_min_plain(grp, k, n_groups)
        runs = [(grp, k)]
        if name == "one_past_tiles":  # and at a 4-byte storage offset
            runs.append((offset_copy(grp, 1), offset_copy(k, 1)))
        for gg, kk in runs:
            if not torch.equal(place_min(gg, kk, n_groups), want):
                raise SystemExit(f"K1 place_min edge case {name} differs "
                                 "from its plain version")
        plan = place_min_plan(grp.numel(), n_groups)
        plans[name] = (plan["tiles"], plan["tile"], plan["shared_histogram"])
    if plans["global_counts"][2] or not plans["one_tile"][2]:
        raise SystemExit(f"K1 edge cases miss a counting path: {plans}")
    print(f"[edge] K1 place_min bit-equal on {', '.join(cases)} and "
          f"one_past_tiles at a 4-byte offset; (tiles, tile, shared "
          f"histogram) {plans}")


def k1_streams(dev, forecast, k3):
    """place_min's full-size streams: the forecast's z-buffer stream, K3's
    coherent one, whole warps on one group over K3's canvas (warp_runs), a
    uniform stream of as many entries over the forecast's canvas, and all
    of them in one tile of it (one bucket holds the stream)."""
    f_group, f_key, f_groups = forecast
    k3_group, k3_key, k3_groups = k3
    gen = torch.Generator().manual_seed(SEED + 6)
    runs = torch.randint(0, k3_groups, (k3_group.numel() // 32,),
                         generator=gen, dtype=torch.int32).repeat_interleave(32)
    n = f_group.numel()
    uniform = torch.randint(0, f_groups, (n,), generator=gen, dtype=torch.int32)
    tile = place_min_plan(n, f_groups)["tile"]
    one_tile = 5 * tile + torch.randint(0, tile, (n,), generator=gen,
                                        dtype=torch.int32)
    return {"forecast_stream": forecast, "k3_stream": k3,
            "warp_runs": (runs.to(dev), k3_key, k3_groups),
            "uniform": (uniform.to(dev), f_key, f_groups),
            "one_tile": (one_tile.to(dev), f_key, f_groups)}


def edge_cases(dev):
    """Both kernels against their plain versions off the main path's
    shapes: K1 with ignored groups (negative, >= num_groups) and key 0;
    K2 with ragged tiles (H/2 not a multiple of 8 rows, W/2 not of 32
    columns), H = 2, W not a multiple of 4 and a misaligned input (the
    scalar staging path), batched, without depth, with other class/frame
    counts (C·T large enough for > 48 KB of weights) and ids outside
    [0, C)."""
    g = torch.Generator().manual_seed(SEED)
    group = torch.randint(-50, 5000, (20000,), generator=g, dtype=torch.int32)
    key = torch.randint(0, 2**31 - 2, (20000,), generator=g, dtype=torch.int32)
    key[::9] = 0
    group, key = group.to(dev), key.to(dev)
    for n_groups in (4000, 5000, 1):
        if not torch.equal(place_min(group, key, n_groups),
                           place_min_plain(group, key, n_groups)):
            raise SystemExit(f"K1 edge case num_groups={n_groups} differs")
    k1_edge_cases(dev)
    fold_edge_cases(dev)
    worst = 0.0
    shapes = ((2, 3, 34, 66, 11, True, False), (1, 2, 16, 48, 5, True, False),
              (1, 3, 20, 30, 11, False, False), (1, 3, 50, 138, 11, True, False),
              (1, 3, 46, 72, 11, True, False), (1, 3, 2, 64, 11, True, False),
              (2, 2, 16, 48, 5, False, False), (1, 3, 20, 64, 40, True, False),
              (1, 3, 18, 136, 11, True, True))
    for b, t, h, w, c, depth, misalign in shapes:
        seg = torch.randint(-2, c + 3, (b, t, h, w), generator=g, dtype=torch.int32)
        dep = torch.randn(b, t, h, w, generator=g) if depth else None
        c_in = t * c + (t if depth else 0)
        kern = torch.randn(3, 3, c_in, 16, generator=g) * 0.2
        bias = torch.randn(16, generator=g)
        args = [x.to(dev) if x is not None else None for x in (seg, dep, kern, bias)]
        if misalign:  # the same values 4 bytes past a 16-byte boundary
            for i in (0, 1):
                flat = torch.empty(args[i].numel() + 1, dtype=args[i].dtype,
                                   device=dev)
                flat[1:] = args[i].reshape(-1)
                args[i] = flat[1:].view(args[i].shape)
        err = float((onehot_stem_conv(*args, num_classes=c)
                     - onehot_stem_conv_plain(*args, num_classes=c)).abs().max())
        worst = max(worst, err)
    print(f"[edge] K1 ignored groups + key 0 bit-equal; K2 on {len(shapes)} edge "
          f"shapes: max abs diff {worst:.3e}")
    if not worst <= 1e-5:
        raise SystemExit(f"K2 edge cases differ by {worst}")
    return worst


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k2_flops(seg, num_classes: int) -> float:
    """Operations K2 does on this data: 16 adds per tap whose class is in
    range, an FMA (2) per channel per in-bounds depth tap, bias + ReLU."""
    ones = torch.ones(1, 1, 3, 3, device=seg.device)
    b, t, h, w = seg.shape
    in_range = ((seg >= 0) & (seg < num_classes)).float().reshape(b * t, 1, h, w)
    taps = F.conv2d(in_range, ones, stride=2, padding=1).sum().item()
    inb = F.conv2d(torch.ones_like(in_range), ones, stride=2, padding=1).sum().item()
    pixels = b * (h // 2) * (w // 2)
    return 16 * taps + 32 * inb + 32 * pixels


def host_ms(fn, n=50, warmup=5):
    """Median host-clock ms of ``fn()`` over ``n`` calls."""
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(n):
        ts = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - ts) * 1e3)
    return sorted(ms)[n // 2]


def stage_breakdown(step, bg, fg, pc_in, fg_in, dev):
    """Where the step's time goes: each stage alone on device-resident
    inputs (CUDA events), then one step under torch.profiler for the
    device-busy share and the costliest kernels."""
    pc_dev = {k: torch.as_tensor(v).to(dev) if k in ("seg", "depth", "depth_mask")
              else torch.as_tensor(v) for k, v in pc_in.items()}
    fg_dev = {k: torch.as_tensor(v).to(dev) for k, v in fg_in.items()}
    fg_flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in fg_dev.items()
               if k != "valid"}
    args = pc_args(pc_dev, dev)

    def pc_stage():
        return pc_transform_predict(*args, height=H, width=W)

    rep = pc_stage()
    rep_depth = rep["depth"].reshape(1, T_IN, H, W)
    bg_in = {"seg": rep["seg"].reshape(1, T_IN, H, W),
             "depth": rep_depth.clamp(min=0.0), "depth_mask": rep_depth > 0}
    ms = {
        "step_device_inputs": time_ms(lambda: step(pc_dev, fg_dev), 10, 2),
        "pc": time_ms(pc_stage, 10, 2),
        "bg": time_ms(lambda: bg(bg_in, return_argmax=True), 10, 2),
        "fg": time_ms(lambda: fg(fg_flat, OUT_T), 10, 2),
    }
    ms["fusion_and_rest"] = ms["step_device_inputs"] - ms["pc"] - ms["bg"] - ms["fg"]
    # the host 4x4 chain inside `pc` (with JAX's rounding), beside a plain
    # f32 chain of torch.linalg.inv and einsum on the same matrices
    K, E, T = args[3:]
    ms["camera_chain_host"] = host_ms(lambda: _camera_maps(K, E, T))
    ms["camera_chain_plain_host"] = host_ms(lambda: torch.einsum(
        "btij,bjk->btik", torch.einsum("bij,btjk,bkl->btil", torch.linalg.inv(E), T, E)
        [..., :3, :3], torch.linalg.inv(K)))
    print("[stages] " + json.dumps({k: round(v, 4) for k, v in ms.items()}))

    torch.cuda.reset_peak_memory_stats()
    # busy time from the profiler, step time from CUDA events (unprofiled)
    busy = device_ms(lambda: step(pc_dev, fg_dev), 5)
    per_step = ms["step_device_inputs"]
    print(f"[profile] one step: device busy {busy:.4f} ms (profiler) of "
          f"{per_step:.2f} ms per step (CUDA events): idle share "
          f"{1 - busy / per_step:.3f}")
    kernels = kernel_profile(lambda: step(pc_dev, fg_dev), 1)
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   {us / 1e3:8.3f} ms x{n:<4d} {name[:90]}")
    print(f"[memory] peak allocated during a step: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def check_output(out, height: int, width: int):
    pan = out["panoptic"]
    assert pan.shape == (1, height, width) and pan.dtype == torch.int32, pan.shape
    ids = out["ids"][0]
    bg = out["bg_seg"]
    assert bg.shape == (1, height, width)
    assert int(bg.min()) >= 0 and int(bg.max()) < 11
    assert torch.isfinite(out["bg_depth"]).all() and torch.isfinite(out["bbox"]).all()
    allowed = set(range(11)) | {255} | set(ids[ids > 0].tolist())
    assert set(torch.unique(pan).tolist()) <= allowed
    nz = ids[ids > 0].tolist()
    assert len(nz) == len(set(nz)) and all(11 <= v // 1000 <= 18 for v in nz)
    return float((pan >= 11000).float().mean())


COUNTED = (place_min_fold, place_min, onehot_stem_conv, place_minwin,
           *(getattr(strided_load, p) for p in strided_load.PROBES))


def reset_counts():
    for fn in COUNTED:
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in COUNTED}


def k3_stream(dev):
    """K3's entry-point stream (scripts/prof_minwin.py) on the card."""
    group, key = prof_minwin.make_stream(H, W)
    return (torch.from_numpy(group).to(dev), torch.from_numpy(key).to(dev),
            prof_minwin.FRAMES * H * W, prof_minwin.pile_kwargs(H, W))


def k3_edge_streams(gen):
    """(group, num_groups, place_minwin kwargs) of K3's edge cases, as CPU
    tensors: the windows of three other block sizes, blocks whose span
    does not fit, negative groups with and without the pile split, a
    stream with overflow > 0, blocks of four tiles and a block that is no
    multiple of 4 (the scalar loads)."""
    def coherent(n, g, jitter, seed):
        rng = np.random.RandomState(seed)
        base = np.linspace(0, g - jitter, n).astype(np.int64)
        return np.clip(base + rng.randint(-jitter, jitter, n), 0, g - 1)

    mixed = torch.randint(-3000, 70000, (100_003,), generator=gen,
                          dtype=torch.int32)
    mixed[::13] = 2**30
    mixed[5::17] = 2**31 - 1
    runs = torch.randint(0, 5000, (4096,), generator=gen, dtype=torch.int32)
    # like tests/test_torch_port_minwin.py's negative_groups stream
    rng = np.random.RandomState(8)
    neg = coherent(6144, 8192, 30, 9)
    neg = np.where(rng.rand(6144) < 0.03, -rng.randint(1, 3000, 6144), neg)
    piles = coherent(300_001, 6 * 65536, 100, 10)
    dense = coherent(300_001, 2 * 65536, 100, 12)
    rng = np.random.RandomState(11)
    piles = np.where(rng.rand(piles.size) < 0.015,
                     (piles // 65536) * 65536 + rng.randint(0, 512, piles.size),
                     piles)
    # tests/test_torch_port_minwin.py's overflow_detection stream
    over = np.random.RandomState(3).randint(0, 1024 * 30, 512 * 40)
    small = dict(block=512, sw=1024)
    pile_split = dict(plane_size=65536, pile_width=1024)
    as_t = lambda a: torch.from_numpy(a.astype(np.int32))
    return {
        # key 0, sentinels past the canvas, negative groups, N % 32 != 0
        "mixed": (mixed, 65536, small),
        "mixed_piles": (mixed, 65536, dict(small, plane_size=4096,
                                           pile_width=128)),
        # whole warps on one group, and runs of 16 that straddle warps
        "warp_runs": (runs.repeat_interleave(32), 5000, small),
        "half_warp_runs": (runs.repeat_interleave(16)[8:], 5000, small),
        "one_group": (torch.full((70_001,), 7, dtype=torch.int32), 16, small),
        "tiny": (torch.randint(0, 40, (37,), generator=gen, dtype=torch.int32),
                 40, small),
        "empty": (torch.zeros(0, dtype=torch.int32), 300, small),
        "negative_piles": (as_t(neg), 8192, dict(small, plane_size=2048,
                                                 pile_width=64)),
        "negative": (as_t(neg), 8192, small),
        "overflow": (as_t(over), 1024 * 30, small),
        "coherent_512": (as_t(piles), 6 * 65536, dict(small, **pile_split)),
        "coherent_2048": (as_t(piles), 6 * 65536, dict(block=2048, **pile_split)),
        "coherent_8192": (as_t(piles), 6 * 65536, dict(block=8192, **pile_split)),
        "four_tiles": (as_t(dense), 2 * 65536, dict(block=32768, **pile_split)),
        "block_518": (as_t(piles), 6 * 65536, dict(block=518, sub=259,
                                                   **pile_split)),
    }


def k3_checks(group, key, num_groups, pk, forecast):
    """Phase 7: K3 against its plain version and K1 on the entry point's
    stream, then on the forecast stream (no window fits), edge cases and
    a misaligned copy (scalar loads); place_minwin on the card must not
    call the plain overflow count. Returns the max abs canvas difference."""
    canvas, ov = place_minwin(group, key, num_groups=num_groups, **pk)
    ref, ov_ref = place_minwin_plain(group, key, num_groups=num_groups, **pk)
    k1 = place_min(group, key, num_groups)
    torch.cuda.synchronize()
    err = int((canvas.long() - ref.long()).abs().max())
    if not (torch.equal(canvas, ref) and torch.equal(canvas, k1)
            and int(ov) == int(ov_ref)):
        raise SystemExit(f"K3 differs: canvas max abs diff {err}, vs K1 "
                         f"{int((canvas != k1).sum())} groups, overflow "
                         f"{int(ov)} vs {int(ov_ref)}")
    print(f"[K3] place_minwin {group.numel()} entries -> {num_groups} groups: "
          f"bit-equal to its plain version and to K1, overflow {int(ov)}")

    dev = group.device
    saved = (minwin.minwin_overflow, minwin.minwin_block_chunks)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain overflow count ran on the card")

    minwin.minwin_overflow = minwin.minwin_block_chunks = refuse
    try:
        place_minwin(group, key, num_groups=num_groups, **pk)
    finally:
        minwin.minwin_overflow, minwin.minwin_block_chunks = saved
    print("[K3] place_minwin on the card calls no plain overflow count")

    g = torch.Generator().manual_seed(SEED + 2)

    def keys(n):
        k = torch.randint(0, 2**31 - 1, (n,), generator=g, dtype=torch.int32)
        k[::9] = 0
        return k

    cases = k3_edge_streams(g)
    f_group, f_key, f_groups = forecast
    cases["forecast"] = (f_group, f_groups, {})
    overflows = {}
    for name, (grp, n_groups, kw) in cases.items():
        grp = grp.to(dev)
        k = f_key if name == "forecast" else keys(grp.numel()).to(dev)
        got = place_minwin(grp, k, num_groups=n_groups, **kw)
        want = place_minwin_plain(grp, k, num_groups=n_groups, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit(f"K3 edge case {name} differs from its plain "
                             f"version: overflow {int(got[1])} vs "
                             f"{int(want[1])}, {int((got[0] != want[0]).sum())}"
                             f" groups")
        overflows[name] = int(got[1])
        if name == "coherent_512":  # the same values at storage offset 1
            flat = torch.empty(2 * grp.numel() + 2, dtype=torch.int32, device=dev)
            flat[1:grp.numel() + 1] = grp
            flat[grp.numel() + 2:] = k
            mis = place_minwin(flat[1:grp.numel() + 1], flat[grp.numel() + 2:],
                               num_groups=n_groups, **kw)
            if not (torch.equal(mis[0], want[0]) and torch.equal(mis[1], want[1])):
                raise SystemExit("K3 on a misaligned stream differs")
    if overflows["overflow"] <= 0:
        raise SystemExit("K3's overflow stream reported no overflow")
    print(f"[edge] K3 bit-equal (canvas and overflow) on "
          f"{', '.join(cases)} and a misaligned copy; overflows {overflows}")
    return err


def k4_checks(dev):
    """Phase 8: every K4 probe bit-equal to its plain version, on the
    16-byte path and on the scalar one (C % 4 == 2, C % 8 == 4 for
    strided_ref, an input at storage offset 1), and at (8192, 8192).
    Returns the max abs difference."""
    g = torch.Generator().manual_seed(SEED + 4)

    def offset(x, by):
        return offset_copy(x.to(dev), by)

    xs = {"(8, 2048)": torch.arange(8 * 2048, dtype=torch.float32).reshape(8, 2048),
          "(64, 4096)": torch.randn(64, 4096, generator=g),
          "(3, 3002)": torch.randn(3, 3002, generator=g),  # C % 4 == 2
          "(8, 2048) at offset 1": offset(torch.randn(8, 2048, generator=g), 1),
          "(5, 1026) at offset 4": offset(torch.randn(5, 1026, generator=g), 4),
          "(64, 4096) at offset 4": offset(torch.randn(64, 4096, generator=g), 4),
          "(6, 1020)": torch.randn(6, 1020, generator=g),  # C % 8 == 4
          str(prof_strided_load.LARGE): torch.randn(
              prof_strided_load.LARGE, device=dev,
              generator=torch.Generator(device=dev).manual_seed(SEED + 4))}
    err = 0.0
    for name in strided_load.PROBES:
        probe = getattr(strided_load, name)
        for shape, x in xs.items():
            x = x.to(dev)
            for start in (0, 1):
                got = probe(x, start)
                want = strided_load.strided_plain(x, start)
                err = max(err, float((got - want).abs().max()))
                if not torch.equal(got, want):
                    raise SystemExit(f"K4 {name} differs at {shape}, "
                                     f"start {start}")
    torch.cuda.synchronize()
    print(f"[K4] {', '.join(strided_load.PROBES)} bit-equal on "
          f"{', '.join(xs)}, start 0 and 1")
    return err


def payload_batches(pc_in, seed):
    """PCTransformModel batches of the pc inputs with panoptic ids
    (trainId·1000 + 11000 + instance) and with an RGB payload."""
    rng = np.random.RandomState(seed)
    seg = pc_in["seg"]
    pan = (seg * 1000 + 11000 + rng.randint(0, 50, seg.shape)).astype(np.int32)
    rgb = rng.randint(0, 256, seg.shape + (3,)).astype(np.uint8)
    return {"panoptic": ({"inputs": dict(pc_in, seg=pan)}, "sort"),
            "rgb": ({"inputs": dict(pc_in, seg=rgb)}, "auto")}


def exact_zbuffer(pc_in, dev):
    """Phase 9: the exact z-buffer through PCTransformModel at full width
    (sort equal to scatter, labels whole), timed; then GPU against CPU at
    256x512, bit-equal. Returns its timings in ms."""
    ms = {}
    for name, (batch, method) in payload_batches(pc_in, SEED + 3).items():
        model = PCTransformModel({"model": {"zbuffer_method": method}}, device=dev)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = model.predict(batch)
        torch.cuda.synchronize()
        ms[f"{name}_first_call_host"] = (time.perf_counter() - ts) * 1e3
        other = PCTransformModel({"model": {"zbuffer_method": "scatter"}},
                                 device=dev).predict(batch)
        seg, dep = out["seg"], out["depth"]
        want = (1, H, W, 3) if name == "rgb" else (1, H, W)
        if tuple(seg.shape) != want or not torch.isfinite(dep).all():
            raise SystemExit(f"exact z-buffer {name}: bad output {tuple(seg.shape)}")
        if not (torch.equal(seg, other["seg"]) and torch.equal(dep, other["depth"])):
            raise SystemExit(f"exact z-buffer {name}: sort and scatter differ")
        if name == "panoptic":
            ids = torch.unique(seg)
            if not (ids[ids > 0].min() >= 11000 and int(ids.max()) > 255):
                raise SystemExit("exact z-buffer lost the panoptic ids")
        dev_batch = {"inputs": {k: torch.as_tensor(v).to(dev)
                                if k in ("seg", "depth", "depth_mask") else v
                                for k, v in batch["inputs"].items()}}
        ms[f"{name}_predict"] = time_ms(lambda: model.predict(dev_batch), 5, 1)
        inp = dev_batch["inputs"]
        uv, z, label, valid = reproject(
            inp["seg"], inp["depth"], inp["depth_mask"],
            torch.as_tensor(inp["intrinsics"]), torch.as_tensor(inp["extrinsics"]),
            torch.as_tensor(inp["target_T"]), height=H, width=W)
        for m in ("sort", "scatter"):
            ms[f"{name}_splat_{m}"] = time_ms(lambda: zbuffer_splat(
                uv, z, label, valid, height=H, width=W, method=m), 5, 1)
        print(f"[exact] {name} {H}x{W} ({method}): {float((dep > 0).float().mean()):.3f}"
              f" of pixels painted, sort == scatter")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30

    pc_s, _ = make_inputs(H_SMALL, W_SMALL)
    for name, (batch, method) in payload_batches(pc_s, SEED + 5).items():
        outs = [PCTransformModel({"model": {"zbuffer_method": method}},
                                 device=d).predict(batch)
                for d in (dev, torch.device("cpu"))]
        for key in ("seg", "depth"):
            if not torch.equal(outs[0][key].cpu(), outs[1][key]):
                raise SystemExit(f"exact z-buffer {name}: GPU and CPU {key} differ")
    print(f"[exact] GPU against CPU at {H_SMALL}x{W_SMALL}: panoptic and rgb "
          f"bit-equal; peak memory so far {peak:.2f} GiB")
    print("[time] exact z-buffer " + json.dumps({k: round(v, 4) for k, v in ms.items()}))
    return ms


def entry_points():
    """Phase 10: the K3 and K4 entry points, each with every launch count
    set to 0 just before and read just after."""
    reset_counts()
    rc = prof_minwin.main([])
    k3 = read_counts()
    print(f"[entry] prof_minwin rc {rc}, launches {k3}")
    if rc != 0 or min(k3["place_minwin"], k3["place_min"]) < 1:
        raise SystemExit("the K3 entry point failed or did not launch K3 "
                         "and the generic K1")
    reset_counts()
    rc = prof_strided_load.main([])
    k4 = read_counts()
    print(f"[entry] prof_strided_load rc {rc}, launches {k4}")
    if rc != 0 or min(k4[p] for p in strided_load.PROBES) < 1:
        raise SystemExit("the K4 entry point failed or a probe did not launch")
    return k3, k4



# ---- 12. the serving CLI ------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
CLI_SCENES = 6  # fg scenes = forecast frames; one more gt frame is backfilled
OPTIONAL = ("yaml", "PIL", "pandas", "h5py")


def optional_packages():
    """Which of the readers' optional packages import here."""
    return {m: importlib.util.find_spec(m) is not None for m in OPTIONAL}


def store_readers(store):
    """The fixture's in-memory readers for the formats whose package is
    missing here (h5 writes go there too)."""
    have = optional_packages()
    return synthetic.readers_from_store(store, tables=not have["pandas"],
                                        arrays=not have["h5py"])


def read_yaml(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def conf(*parts):
    """A config of the repo's configs/."""
    return read_yaml(os.path.join(REPO, "configs", *parts))


def dump(path, cfg):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def cli_fixture(root, height, width, n_scenes):
    """The serving fixture under ``root`` (port's data/synthetic.py,
    short-term: pc gap 3, fg output_ind 0, predicted odometry, bg
    canvases), seeded weights of configs/bg/bg_val_short.yaml in the
    port's checkpoint format and of configs/fg/fg_val_short.yaml as a
    reference-format ``.pt`` (the port's FGModel keeps the reference
    names) with box statistics of a ``width``-wide frame, which the CLI
    loads with ``--load_torch_model``, and the CLI config. Returns (cfg,
    store)."""

    cs, fg, odom, canvases = (os.path.join(root, d)
                              for d in ("cs", "fg", "odom", "bg_export"))
    store = synthetic.write_cityscapes_fixture(
        cs, "val", n_snippets=n_scenes + 1, height=height, width=width,
        seed=SEED, gap_len=3)
    synthetic.write_fg_fixture(fg, splits=("val",), n_scenes=n_scenes,
                               max_instances=N_INST, seed=SEED, store=store)
    for reader, rows in (("odometry", os.path.join(cs, "val_3d_info.pkl")),
                         ("predicted_odometry", os.path.join(fg, "val_3d_info.pkl"))):
        synthetic.write_odom_predictions(
            os.path.join(odom, f"{reader}_val.h5"), store["tables"][rows],
            starts=(16,), seed=SEED, store=store)
    for s in range(n_scenes + 1):  # bg canvases: the gt frame's stuff
        seg = synthetic.make_scene_sequence(20, height, width, SEED + s)[0][19]
        save_png(os.path.join(canvases, "val", synthetic.CITY,
                              f"{synthetic.CITY}_{s:06d}_000019_gtFine_labelIds.png"),
                 np.where(seg >= 11, 255, seg).astype(np.uint8))

    pc = conf("pc_transform", "pc_export.yaml")
    pc["data"].update(cityscapes_dir=cs, data_dir=cs, seg_dir=os.path.join(cs, "seg"),
                      gap_len=3, odom_pred_dir=odom, data_splits=["val"])
    bg = conf("bg", "bg_val_short.yaml")
    bg["model"].update(final_h=height, final_w=width)
    fg_cfg = conf("fg", "fg_val_short.yaml")
    fg_cfg["data"].update(data_dir=fg, depth_dir=fg, feats_dir=fg, info_3d_dir=fg,
                          cityscapes_dir=cs, odom_pred_dir=odom,
                          background_dir=canvases)
    bg_dir, wd = os.path.join(root, "bg_run"), os.path.join(root, "fg_run")
    card = build_dataset(bg, test=True).card
    ckpt.save_model(bg_dir, seeded_init_(build_model(bg, card, "cpu"), SEED),
                    best=True)
    fg_pt = os.path.join(root, "fg_reference.pt")
    torch.save(seeded_init_(FGModel(fg_cfg, stats=fg_stats(width), device="cpu"),
                            SEED + 1).state_dict(), fg_pt)
    cfg = dict(fg_cfg, working_dir=wd, seed=SEED, load_torch_model=fg_pt, fused={
        "bg_config": dump(os.path.join(root, "bg.yaml"), bg), "bg_dir": bg_dir,
        "pc_config": dump(os.path.join(root, "pc.yaml"), pc),
        "height": height, "width": width})
    return cfg, store


def run_cli(cfg, store, platform=None, export_name=None, reads=None):
    """forecast_fused.run on ``cfg`` (on ``platform``, cuda by default);
    a format whose package is missing here is read from the fixture's
    store. ``reads`` ({path: {}}) takes each key the readers look up in
    the h5 file at one of its paths (``h5_reads``)."""
    cfg = dict(cfg, platform=platform, export_name=export_name)
    with store_readers(store), h5_reads(reads or {}):
        return forecast_fused.run(Config(cfg))["val"]


def panoptic_maps(result_dir):
    """({frame name: panoptic map}, annotations) of a COCO-panoptic export."""
    export = os.path.basename(result_dir)
    with open(os.path.join(result_dir, f"{export}.json")) as f:
        anns = json.load(f)["annotations"]
    return {a["image_id"]: decode_panoptic_png(load_png(os.path.join(
        result_dir, export, a["file_name"]))) for a in anns}, anns


def cli_outputs(report):
    return panoptic_maps(report["result_dir"])


def panoptic_files(result_dir):
    """{file name: bytes} of the PNGs of a COCO-panoptic export."""
    folder = os.path.join(result_dir, os.path.basename(result_dir))
    files = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            files[name] = f.read()
    return files


def step_panoptics(cfg, store, dev):
    """{frame name: labelId panoptic map} of every forecast frame, from
    ``step(...)`` on the frame's inputs, outside the CLI's loop."""
    with store_readers(store):
        cfg, task_data, fg_model = setup(Config(cfg), test=True)
        fg_model = restore_params(cfg, fg_model)
        bg_model = forecast_fused._build_bg(cfg["fused"], dev)
        pc_ds, pc_idx = forecast_fused._pc_index(cfg["fused"], "val")
        loader = task_data.loader("val", cfg, test=True)
    step = build_forecast_step(bg_model, fg_model, height=cfg["fused"]["height"],
                               width=cfg["fused"]["width"], out_t=OUT_T, device=dev)
    lut = id_to_train_id_lut()
    out = {}
    for batch in loader:
        meta = batch["meta"]
        for i in range(len(meta["city"])):
            name = (f"{meta['city'][i]}_{meta['seq'][i]}_"
                    f"{int(meta['target_frame'][i]):06d}")
            pc_in = forecast_fused._pc_inputs(pc_ds, pc_idx[name], lut)
            pan = step(pc_in, forecast_fused._fg_inputs(batch, i))["panoptic"][0]
            out[name] = relabel_panoptic_trainid_to_labelid(
                pan.cpu().numpy().astype(np.int64))
    return out


def png_decode_ms(height, width):
    """Host ms of one decode_png at height x width: a label map and a
    16-bit disparity map, each with no row filter and with Paeth."""
    rng = np.random.RandomState(SEED)
    seg = synthetic.make_scene_sequence(1, height, width)[0][0].astype(np.uint8)
    disp = (rng.rand(height, width) * 30000 + 1).astype(np.uint16)
    ms = {}
    for name, arr in (("labels8", seg), ("disparity16", disp)):
        for filt, fname in ((png.FILTER_NONE, "none"), (png.FILTER_PAETH, "paeth")):
            data = png.encode_png(arr, 1, filt)
            times = []
            for _ in range(3):
                ts = time.perf_counter()
                got = png.decode_png(data)
                times.append((time.perf_counter() - ts) * 1e3)
            if not np.array_equal(got, arr):
                raise SystemExit(f"PNG codec: {name} {fname} does not round-trip")
            ms[f"{name}_{fname}"] = sorted(times)[1]
    return ms


def thing_pixels(maps):
    return sum(int((m >= 1000).sum()) for m in maps.values())


def cli_phase(dev, root):
    """Phase 12: the serving CLI at full width on the card, with the
    launch counts set to 0 just before it and read just after; its PNGs
    against the step on the same inputs, its json, instances painted, and
    a 256x512 run on the card against the same on the CPU. Returns the
    launches, the readings and {size: (cfg, store, {platform: report})}
    of the fixtures under ``root``."""
    have = optional_packages()
    from_memory = [fmt for fmt, pkg in (("tables", "pandas"), ("h5", "h5py"))
                   if not have[pkg]]
    print(f"[cli] readers: {', '.join(from_memory) or 'nothing'} from the "
          f"fixture's memory (package missing), the rest from files")
    ts = time.perf_counter()
    cfg, store = cli_fixture(os.path.join(root, "full"), H, W, CLI_SCENES)
    fixture_s = time.perf_counter() - ts
    reset_counts()
    report = run_cli(cfg, store)
    torch.cuda.synchronize()
    launches = read_counts()
    frames = report["frames"]
    print(f"[cli] {H}x{W}: {frames} frames, launches {launches}")
    if frames != CLI_SCENES or report["skipped"]:
        raise SystemExit(f"the CLI forecast {frames} frames, skipped "
                         f"{report['skipped']}")
    if (launches["place_min_fold"] != frames
            or launches["onehot_stem_conv"] != frames
            or launches["place_min"] != 0):
        raise SystemExit(f"the CLI's launches are not one K1 fold and one "
                         f"K2 per frame: {launches}")
    maps, anns = cli_outputs(report)
    names = [f"{synthetic.CITY}_{s:06d}_000019" for s in range(CLI_SCENES + 1)]
    if [a["image_id"] for a in anns] != names:
        raise SystemExit(f"the CLI's json lists {[a['image_id'] for a in anns]}")
    backfill = maps[names[-1]]
    if backfill.shape != (H, W) or (backfill >= 1000).any():
        raise SystemExit("the backfilled frame is not its stuff canvas")
    want = step_panoptics(cfg, store, dev)
    for name, pan in want.items():
        if not np.array_equal(maps[name], pan):
            raise SystemExit(f"the CLI's PNG of {name} differs from the step's "
                             f"map on {int((maps[name] != pan).sum())} pixels")
    things = thing_pixels(maps)
    print(f"[cli] {frames} PNGs equal the step's maps on the card; json lists "
          f"{len(anns)} frames ({len(anns) - frames} backfilled); "
          f"{things} pixels in instances")
    if things <= 0:
        raise SystemExit("the CLI painted no instance at full width")

    ms = report["ms"]
    med = {k: float(np.median(v)) for k, v in ms.items()}
    readings = {"frames": frames, "seconds": report["seconds"],
                "frames_per_s": frames / report["seconds"],
                "median_ms": med, "ms": ms, "fixture_s": fixture_s,
                "thing_pixels": things}
    print("[cli] readings " + json.dumps(readings))

    small, small_store = cli_fixture(os.path.join(root, "small"), H_SMALL,
                                     W_SMALL, 2)
    reports, outs = {}, {}
    for platform in ("cuda", "cpu"):
        reports[platform] = run_cli(small, small_store, platform, f"fused_{platform}")
        outs[platform] = cli_outputs(reports[platform])
    worst = 0.0
    for name, pan in outs["cuda"][0].items():
        ref = outs["cpu"][0][name]
        if set(np.unique(pan)) != set(np.unique(ref)):
            raise SystemExit(f"CLI GPU and CPU ids differ on {name}")
        worst = max(worst, float((pan != ref).mean()))
    small_things = thing_pixels(outs["cuda"][0])
    print(f"[cli] {H_SMALL}x{W_SMALL} GPU against CPU: ids equal on "
          f"{len(outs['cuda'][0])} frames, worst panoptic mismatch {worst:.3e}, "
          f"{small_things} pixels in instances")
    if not worst < 1e-3:
        raise SystemExit("the CLI's GPU and CPU maps differ beyond 1e-3")
    if small_things <= 0:
        raise SystemExit(f"the CLI painted no instance at {H_SMALL}x{W_SMALL}")
    readings["png_decode_ms"] = png_decode_ms(H, W)
    print("[png] decode ms at 1024x2048: " + json.dumps(readings["png_decode_ms"]))
    fixtures = {"full": (cfg, store, {"cuda": report}),
                "small": (small, small_store, reports)}
    return launches, readings, fixtures


# ---- 13. serve and score ------------------------------------------------------

TIMED_SNIPPETS = 500  # the Cityscapes val split's snippets


def odom_argv(wd, data_dir, name, platform):
    """export_odom's arguments: configs/odom/odom_val.yaml on ``data_dir``."""
    return ["--working_dir", wd, "--config_file",
            os.path.join(REPO, "configs", "odom", "odom_val.yaml"),
            "--set", "data.data_dir", data_dir, "--set", "export_name", name,
            "--set", "platform", platform]


def window_key(meta):
    return (f"{meta['city']}/{meta['seq']}/{int(meta['frame'])}/"
            f"{int(meta['start_frame'])}")


def odom_exports(cfg, store, platform):
    """``export_odom`` (its ``main``) with configs/odom/odom_val.yaml and
    seeded weights in the port's checkpoint, over the fixture's
    Cityscapes table (``odometry_val.h5``, the pc reader's) and fg table
    (``predicted_odometry_val.h5``, the fg reader's), on ``platform``;
    each file read back through ``io.open_h5``, one array for every
    window of the odometry dataset. Returns (working dir, {name: {key:
    array}}, seconds per main)."""
    root = os.path.dirname(cfg["working_dir"])
    wd = os.path.join(root, f"odom_{platform}")
    ckpt.save_model(wd, seeded_init_(OdomModel(conf("odom", "odom_val.yaml"),
                                               device="cpu"), SEED + 2), best=True)
    out, secs = {}, {}
    for name, table in (("odometry", "cs"), ("predicted_odometry", "fg")):
        argv = odom_argv(wd, os.path.join(root, table), name, platform)
        with store_readers(store):
            ts = time.perf_counter()
            export_odom.main(argv)
            secs[name] = time.perf_counter() - ts
            windows = build_dataset(load_config(argv), test=True).datasets["val"]
            keys = {window_key(windows[i]["meta"]) for i in range(len(windows))}
            h5 = data_io.open_h5(os.path.join(wd, f"{name}_val.h5"))
            arrays, missing = {}, []
            for k in sorted(keys):
                try:
                    arrays[k] = np.asarray(h5[k][:])
                except KeyError:
                    missing.append(k)
            h5.close()
        if missing or len(keys) != len(windows):
            raise SystemExit(f"export_odom {name} on {platform}: {len(windows)} "
                             f"windows, {len(keys)} keys, missing {missing[:3]}")
        for r in windows.rows:  # the key the pc and fg readers look up: start 16
            if f"{r['city']}/{r['seq']}/{int(r['frame'])}/16" not in arrays:
                raise SystemExit(f"export_odom {name} lacks start 16 of {r['seq']}")
        if not all(a.shape == (9, 2) and np.isfinite(a).all()
                   for a in arrays.values()):
            raise SystemExit(f"export_odom {name}: bad forecasts")
        out[name] = arrays
    return wd, out, secs


def export_ms_per_batch(root, wd):
    """Host ms per batch of ``export_split`` on the card over a val-sized
    odometry table (``TIMED_SNIPPETS`` snippets of the port's
    ``write_odom_fixture``), the model and data set up, the h5 going where
    ``odom_exports`` puts it: (median, least, most of 3 passes, batches)."""
    data_dir = os.path.join(root, "odom_timed")
    store = synthetic.write_odom_fixture(data_dir, n_snippets=TIMED_SNIPPETS)
    with store_readers(store):
        ocfg, task_data, model = setup(load_config(odom_argv(
            wd, data_dir, "timed", "cuda")), test=True)
        model = restore_params(ocfg, model)
        times = []
        for _ in range(3):
            ts = time.perf_counter()
            export_odom.export_split(model, task_data, "val", ocfg)
            times.append(time.perf_counter() - ts)
    batches = len(task_data.loader("val", ocfg, test=True))
    lo, med, hi = (t * 1e3 / batches for t in sorted(times))
    return med, lo, hi, batches


@contextlib.contextmanager
def h5_reads(reads):
    """Within the block, each key read through ``io.open_h5`` from a file
    at a path of ``reads`` is kept in ``reads[path]`` with the array
    handed out."""
    opened = data_io.open_h5

    class Logged:
        def __init__(self, h5, log):
            self.h5, self.log = h5, log

        def __getitem__(self, key):
            self.log[key] = np.array(self.h5[key][:])
            return self.h5[key]

        def __getattr__(self, name):
            return getattr(self.h5, name)

    data_io.open_h5 = lambda path: (Logged(opened(path), reads[path])
                                    if path in reads else opened(path))
    try:
        yield reads
    finally:
        data_io.open_h5 = opened


def with_odometry(cfg, odom_dir):
    """``cfg`` with the pc and fg readers' predicted odometry taken from
    ``odom_dir``, and its own export name."""
    pc = read_yaml(cfg["fused"]["pc_config"])
    pc["data"]["odom_pred_dir"] = odom_dir
    return dict(cfg, data=dict(cfg["data"], odom_pred_dir=odom_dir), fused=dict(
        cfg["fused"], pc_config=dump(os.path.join(odom_dir, "pc.yaml"), pc)))


def evaluate(pred_json, pred_dir, gt_json, gt_dir):
    """evaluate_panoptic's ``main`` (its table of every class not
    printed); (results, seconds)."""
    ts = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = evaluate_panoptic.main(["--pred_json", pred_json, "--pred_dir", pred_dir,
                                      "--gt_json", gt_json, "--gt_dir", gt_dir])
    return res, time.perf_counter() - ts


def score(report, gt_json, gt_dir):
    """evaluate_panoptic on a CLI export; (results, seconds)."""
    export = os.path.basename(report["result_dir"])
    return evaluate(os.path.join(report["result_dir"], f"{export}.json"),
                    os.path.join(report["result_dir"], export), gt_json, gt_dir)


def gt_split(cfg, out):
    """The fixture's gtFine converted under ``out``: (json, png dir, s)."""
    cs = os.path.join(os.path.dirname(cfg["working_dir"]), "cs")
    ts = time.perf_counter()
    gt_json = convert_gt_split(cs, "val", out)
    return gt_json, os.path.join(out, "cityscapes_panoptic_val"), time.perf_counter() - ts


def score_phase(dev, fixtures, card):
    """Phase 13: export_odom on the card (each table, equal to the CPU
    export), the serving CLI reading those forecasts with the launch
    counts set to 0 just before and read just after (every forecast the
    readers look up taken from the exports, none from the fixture's own
    odometry; its PNGs equal to the step's maps on the same inputs and
    unlike phase 12's), the fixture's GT converted and scored against
    itself (PQ 1) and against the CLI's maps; at 256x512 the GPU and CPU
    CLI exports of phase 12 scored."""
    ts0 = time.perf_counter()
    cfg, store, phase12 = fixtures["full"]
    wd, exported, export_s = odom_exports(cfg, store, "cuda")
    _, on_cpu, _ = odom_exports(cfg, store, "cpu")
    if any(exported[n].keys() != on_cpu[n].keys() for n in exported):
        raise SystemExit("export_odom on the card and on the CPU differ in keys")
    worst = max(float(np.abs(exported[n][k] - on_cpu[n][k]).max())
                for n in exported for k in exported[n])
    if not worst <= 1e-5:
        raise SystemExit(f"export_odom on the card differs from the CPU: {worst}")
    root = os.path.dirname(cfg["working_dir"])
    ms_med, ms_lo, ms_hi, batches = export_ms_per_batch(root, wd)
    print(f"[odom] export_odom on the card: {len(exported['odometry'])} + "
          f"{len(exported['predicted_odometry'])} windows, equal to the CPU "
          f"export (max abs diff {worst:.3e}); main {json.dumps(export_s)} s; "
          f"{ms_med:.3f} ms per batch (passes {ms_lo:.3f}-{ms_hi:.3f}) over "
          f"{batches} batches of a {TIMED_SNIPPETS}-snippet table | {card}")

    served = with_odometry(cfg, wd)
    reads = {os.path.join(d, f"{n}_val.h5"): {}
             for d in (wd, os.path.join(root, "odom")) for n in exported}
    reset_counts()
    report = run_cli(served, store, export_name="fused_odom", reads=reads)
    torch.cuda.synchronize()
    launches = read_counts()
    frames = report["frames"]
    print(f"[serve] {H}x{W} on the exported odometry: {frames} frames, "
          f"launches {launches}")
    if (frames != CLI_SCENES or launches["place_min_fold"] != frames
            or launches["onehot_stem_conv"] != frames or launches["place_min"]):
        raise SystemExit(f"the CLI on the exported odometry: {frames} frames, "
                         f"launches {launches}")
    for name, arrays in exported.items():
        got = reads[os.path.join(wd, f"{name}_val.h5")]
        start16 = {k for k in arrays if k.endswith("/16")}
        if got.keys() != start16 or any(not np.array_equal(v, arrays[k])
                                        for k, v in got.items()):
            raise SystemExit(f"the CLI read {sorted(got)} of {name}, not the "
                             f"exported start-16 forecasts {sorted(start16)}")
        if reads[os.path.join(root, "odom", f"{name}_val.h5")]:
            raise SystemExit(f"the CLI read the fixture's own {name}")
    maps = cli_outputs(report)[0]
    for name, pan in step_panoptics(served, store, dev).items():
        if not np.array_equal(maps[name], pan):
            raise SystemExit(f"the CLI's PNG of {name} on the exported odometry "
                             f"differs from the step's map on "
                             f"{int((maps[name] != pan).sum())} pixels")
    before = cli_outputs(phase12["cuda"])[0]
    moved = sum(int((maps[k] != before[k]).sum()) for k in maps)
    print(f"[serve] the readers took "
          f"{' + '.join(str(len(reads[os.path.join(wd, f'{n}_val.h5')])) for n in exported)}"
          f" forecasts (start 16) from the exports, each equal to the exported "
          f"array, none from the fixture's own; {frames} PNGs equal the step's "
          f"maps; {moved} pixels unlike phase 12's (the fixture's odometry)")
    if moved <= 0:
        raise SystemExit("the maps on the exported odometry equal phase 12's")

    gt_json, gt_dir, gt_s = gt_split(cfg, os.path.join(wd, "gt"))
    self_res, self_s = evaluate(gt_json, gt_dir, gt_json, gt_dir)
    valid = {k: v["pq"] for k, v in self_res["per_class"].items() if v["valid"]}
    if not valid or any(v != 1.0 for v in valid.values()):
        raise SystemExit(f"the GT scored against itself: {valid}")
    res, pq_s = score(report, gt_json, gt_dir)
    n_gt = len(cli_outputs(report)[1])
    pq = {k: res[k]["pq"] for k in ("All", "Things", "Stuff")}
    print(f"[score] GT of {n_gt} frames converted in {gt_s:.3f} s; scored "
          f"against itself: PQ 1.0 on {sorted(valid)} ({self_s:.3f} s) | {card}")
    print(f"[score] {H}x{W} forecast: PQ {json.dumps(pq)} (Things has no GT "
          f"instance: false positives only), {pq_s / n_gt:.4f} s per frame | {card}")

    small, small_store, reports = fixtures["small"]
    gt_json, gt_dir, _ = gt_split(small, os.path.join(os.path.dirname(
        small["working_dir"]), "gt"))
    small_res = {p: score(r, gt_json, gt_dir)[0] for p, r in reports.items()}
    maps = {p: cli_outputs(r)[0] for p, r in reports.items()}
    same = all(np.array_equal(maps["cuda"][k], maps["cpu"][k]) for k in maps["cpu"])
    gap = max(abs(small_res["cuda"][k]["pq"] - small_res["cpu"][k]["pq"])
              for k in ("All", "Things", "Stuff"))
    print(f"[score] {H_SMALL}x{W_SMALL} GPU against CPU: maps "
          f"{'equal' if same else 'differ'}, PQ dicts "
          f"{'equal' if small_res['cuda'] == small_res['cpu'] else 'differ'}, "
          f"largest PQ gap {gap:.3e}")
    if (same and small_res["cuda"] != small_res["cpu"]) or not gap < 1e-3:
        raise SystemExit("the GPU and CPU exports score differently")
    phase_s = time.perf_counter() - ts0
    print(f"[score] phase 13 took {phase_s:.1f} s")
    return {"export_odom_ms_per_batch": ms_med,
            "export_odom_ms_per_batch_passes": [ms_lo, ms_hi],
            "export_odom_batches": batches, "export_odom_main_s": export_s,
            "gt_convert_s": gt_s, "pq_s_per_frame": pq_s / n_gt, "pq": pq,
            "launches": launches, "moved_pixels": moved, "small_pq_gap": gap,
            "phase_s": phase_s}


# ---- 14. the staged chain -----------------------------------------------------

def counted(fn, *args):
    """``fn(*args)`` with the launch counts set to 0 just before and read
    just after; (result, launches, seconds)."""
    reset_counts()
    ts = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, read_counts(), time.perf_counter() - ts


def staged_configs(cfg, root, tag):
    """The staged chain's configs on the fixture of ``cfg`` (phase 12's):
    configs/pc_transform/pc_export.yaml as phase 12 sets it (gap 3),
    configs/bg/bg_val_short.yaml on the prepared bg data with
    ``gap_len [3]`` (the fixture is short-term), and the fg config with
    ``background_dir`` on the canvases ``bg_staged{tag}``. -> (pc, bg,
    fg) paths."""
    cs = os.path.join(os.path.dirname(cfg["working_dir"]), "cs")
    bg_data = os.path.join(root, "bg_data")
    os.makedirs(root, exist_ok=True)
    bg = read_yaml(cfg["fused"]["bg_config"])
    bg["data"].update(
        data_dir=[os.path.join(bg_data, f"point_cloud_static_ind{i}_all",
                               "exported_predictions") for i in range(3)],
        gt_dir=os.path.join(root, "nofg"), cityscapes_dir=cs, gap_len=[3],
        depth_h5_path=os.path.join(bg_data, "depths_decompressed_%s.h5"))
    fg = dict(cfg, data=dict(cfg["data"], background_dir=os.path.join(
        cfg["fused"]["bg_dir"], f"bg_staged{tag}")))
    fg.pop("fused")
    return (cfg["fused"]["pc_config"], dump(os.path.join(root, "bg.yaml"), bg),
            dump(os.path.join(root, "fg.yaml"), fg))


def staged_chain(cfg, store, root, platform, tag=""):
    """prepare_gt_nofg, prepare_bg_data, the bg canvas export
    (``bg_staged{tag}``) and export_panoptic (``staged{tag}``) on
    ``platform``, each CLI counted. Returns ({stage: (result, launches,
    seconds)}, export_panoptic's arguments, the bg config)."""
    pc_cfg, bg_cfg, fg_cfg = staged_configs(cfg, root, tag)
    cs = os.path.join(os.path.dirname(cfg["working_dir"]), "cs")
    plat = ["--set", "platform", platform]
    out = {}
    with store_readers(store):
        out["nofg"] = counted(prepare_gt_nofg.main, ["--cityscapes_dir", cs, "--splits",
                                                     "val", "--out_dir",
                                                     os.path.join(root, "nofg")])
        out["bg_data"] = counted(prepare_bg_data.main, [
            "--working_dir", os.path.join(root, "pc_run"), "--config_file", pc_cfg,
            "--set", "bg_out", os.path.join(root, "bg_data")] + plat)
        bg_argv = ["--working_dir", cfg["fused"]["bg_dir"], "--config_file", bg_cfg,
                   "--set", "no_convert", "true", "--set", "export_name", f"bg_staged{tag}"]
        out["bg_export"] = counted(export_segmentation.main, bg_argv + plat)
        fg_argv = ["--working_dir", cfg["working_dir"], "--config_file", fg_cfg,
                   "--load_torch_model", cfg["load_torch_model"],
                   "--set", "export_name", f"staged{tag}"] + plat
        out["panoptic"] = counted(export_panoptic.main, fg_argv)
    return out, fg_argv, read_yaml(bg_cfg)


def canvases(root_dir):
    """{frame name: class map} of a bg canvas export."""
    return {os.path.basename(p)[: -len("_gtFine_labelIds.png")]: load_png(p)
            for p in sorted(glob.glob(os.path.join(root_dir, "val", "*", "*.png")))}


def compare_maps(got, want, limit, what):
    """Equal names and segment id sets, pixel mismatch < ``limit`` on each
    map; returns the worst mismatch."""
    if sorted(got) != sorted(want):
        raise SystemExit(f"{what}: frames {sorted(got)} against {sorted(want)}")
    worst = 0.0
    for name, m in got.items():
        if set(np.unique(m)) != set(np.unique(want[name])):
            raise SystemExit(f"{what}: segment ids differ on {name}")
        worst = max(worst, float((m != want[name]).mean()))
    if not worst < limit:
        raise SystemExit(f"{what}: {worst:.4%} of pixels differ (limit {limit:.2%})")
    return worst


def self_scored_ap(root):
    """A 1024x2048 gtFine instance map with two thing instances (a car
    and a person) scored against an export of its own masks: AP 1."""
    g = np.full((H, W), 7, np.uint16)  # road
    g[H * 2 // 5 : H * 3 // 5, W // 7 : W // 3] = 26 * 1000
    g[H // 2 : H * 4 // 5, W * 3 // 5 : W * 2 // 3] = 24 * 1000 + 3
    name = f"{synthetic.CITY}_000000_000019"
    gt_dir, pred_dir = os.path.join(root, "ap_gt"), os.path.join(root, "ap_pred")
    save_png(os.path.join(gt_dir, synthetic.CITY, f"{name}_gtFine_instanceIds.png"), g)
    lines = []
    for lid, inst in ((26, 26000), (24, 24003)):
        save_png(os.path.join(pred_dir, f"{name}_{lid}_0.png"),
                 (g == inst).astype(np.uint8) * 255)
        lines.append(f"{name}_{lid}_0.png {lid} 0.900000\n")
    with open(os.path.join(pred_dir, f"{name}.txt"), "w") as f:
        f.writelines(lines)
    with contextlib.redirect_stdout(io.StringIO()):
        return evaluate_instances.main(["--pred_dir", pred_dir, "--gt_dir", gt_dir])


class StagedInputs(torch.nn.Module):
    """The bg model fed the step's reprojection of labelIds as the staged
    chain hands it over: ``prepare_bg_data.staged_maps`` converts the
    labels to trainIds after the splat (the step converts before it, so
    where the z-buffer holds label 0 -- no point, or a point the
    reference marks invalid -- the step reads road and the staged chain
    labelId 0, void) and encodes the depth into the h5's uint16 code,
    which ``BGModel._prep_inputs`` decodes on the card. Keeps each call's
    logits and its label-0 pixels (in any input frame)."""

    def __init__(self, bg):
        super().__init__()
        self.bg, self.logits, self.label0 = bg, [], []

    def forward(self, inputs, return_argmax=False):
        seg = inputs["seg"].cpu().numpy()
        seg_train, code = prepare_bg_data.staged_maps(seg, inputs["depth"].cpu().numpy())
        logits = self.bg({"seg": seg_train, "depth": code})
        self.logits.append(logits)
        self.label0.append((seg == 0).any(1))
        return torch.argmax(logits, 1).to(torch.int32) if return_argmax else logits


def staged_input_maps(cfg, store, dev):
    """{frame: (labelId panoptic map, bg class map, top-2 logit gap, top
    logit, label-0 pixels)} of the serving step (``eval/forecast.py``) on
    each forecast frame's inputs with the segmentations in labelIds, its
    bg model fed the staged chain's inputs (``StagedInputs``): what the
    staged chain computes, through the step's own reprojection."""
    with store_readers(store):
        cfg, task_data, fg_model = setup(Config(cfg), test=True)
        fg_model = restore_params(cfg, fg_model)
        bg_model = StagedInputs(forecast_fused._build_bg(cfg["fused"], dev))
        pc_ds, pc_idx = forecast_fused._pc_index(cfg["fused"], "val")
        loader = task_data.loader("val", cfg, test=True)
    step = build_forecast_step(bg_model.to(dev), fg_model, height=cfg["fused"]["height"],
                               width=cfg["fused"]["width"], out_t=OUT_T, device=dev)
    lut = np.arange(256)  # labelIds kept: StagedInputs converts after the splat
    out = {}
    for batch in loader:
        meta = batch["meta"]
        for i in range(len(meta["city"])):
            name = (f"{meta['city'][i]}_{meta['seq'][i]}_"
                    f"{int(meta['target_frame'][i]):06d}")
            pc_in = forecast_fused._pc_inputs(pc_ds, pc_idx[name], lut)
            res = step(pc_in, forecast_fused._fg_inputs(batch, i))
            top2 = torch.topk(bg_model.logits.pop()[0], 2, dim=0).values
            out[name] = (relabel_panoptic_trainid_to_labelid(
                res["panoptic"][0].cpu().numpy().astype(np.int64)),
                res["bg_seg"][0].cpu().numpy(), (top2[0] - top2[1]).cpu().numpy(),
                top2[0].cpu().numpy(), bg_model.label0.pop()[0])
    return out


def staged_phase(dev, fixtures, card):
    """Phase 14: the paper's per-stage chain on phase 12's fixture, each
    CLI with the launch counts set to 0 just before it and read just
    after: prepare_gt_nofg, prepare_bg_data (3 place_min_fold a pc
    batch), the bg canvases (1 onehot_stem_conv a bg batch),
    export_panoptic against the step fed the staged inputs and against
    phase 12's fused PNGs (< 2.5 %, segments in one map only < 256 px),
    evaluate_panoptic, export_instances + evaluate_instances (allAp 0,
    NaN per class: the fixture has no GT instance; a self-scored map AP
    1), viz_panoptic on one frame; then the chain at 256x512 on the card
    against the CPU (canvases and panoptic maps: equal ids, < 1e-3)."""
    ts0 = time.perf_counter()
    cfg, store, phase12 = fixtures["full"]
    root = os.path.join(os.path.dirname(cfg["working_dir"]), "staged")
    out, fg_argv, bg_cfg = staged_chain(cfg, store, root, "cuda")
    report, prep_launches, _ = out["bg_data"]
    frames = report["val"]["frames"]
    pc_cfg = Config(read_yaml(cfg["fused"]["pc_config"]))
    pc_batches = -(-frames // int(pc_cfg["training"]["batch_size"]))
    bg_report, bg_launches, _ = out["bg_export"]
    bg_frames, bg_s = bg_report["val"]["frames"], bg_report["val"]["seconds"]
    bg_batches = -(-bg_frames // int(bg_cfg["training"]["batch_size"]))
    pan_report, pan_launches, _ = out["panoptic"]
    result_dir, pan_frames, pan_s = (pan_report["val"][k] for k in ("dir", "frames", "seconds"))
    print(f"[staged] prepare_bg_data: {frames} frames in {pc_batches} pc batches, "
          f"launches {prep_launches}; bg export: {bg_frames} frames in {bg_batches} "
          f"batches, launches {bg_launches}; export_panoptic launches {pan_launches}")
    if (prep_launches["place_min_fold"] != 3 * pc_batches or prep_launches["place_min"]
            or prep_launches["onehot_stem_conv"]):
        raise SystemExit(f"prepare_bg_data launched {prep_launches}, not 3 "
                         f"place_min_fold a pc batch ({pc_batches} batches)")
    if (bg_launches["onehot_stem_conv"] != bg_batches or bg_launches["place_min"]
            or bg_launches["place_min_fold"]):
        raise SystemExit(f"the bg export launched {bg_launches}, not 1 "
                         f"onehot_stem_conv a bg batch ({bg_batches} batches)")
    if any(pan_launches.values()):
        raise SystemExit(f"export_panoptic launched {pan_launches}")
    blocks = store["arrays"].get(os.path.join(root, "bg_data", "depths_decompressed_val.h5"))
    if blocks is not None and (len(blocks) != frames or any(
            b.shape != (H, W, 3) or b.dtype != np.uint16 for b in blocks.values())):
        raise SystemExit("prepare_bg_data's depth blocks are not (H, W, 3) uint16")

    staged, anns = panoptic_maps(result_dir)
    # the forecast frames (the json lists them before the backfilled one,
    # whose canvas differs: phase 12's is the GT's stuff)
    forecast = {a["image_id"]: staged[a["image_id"]] for a in anns[:pan_frames]}
    # the staged chain against the serving step on the staged chain's bg
    # inputs: canvases equal off the bg's near-ties, panoptic maps there
    # within < 1e-3 (mask threshold flips: fg forwards of 2 scenes
    # against 1) and the same instance ids. A near-tie: a top-2 logit gap
    # within 1e-4 of the top logit (the seeded bg's logits reach ~100;
    # cuDNN sums them in another order at batch 2 than at batch 1)
    stage_canvases = canvases(os.path.join(cfg["fused"]["bg_dir"], "bg_staged"))
    sure_share, unsure, inputs_pan_gap, tie_gap, label0 = 1.0, 0, 0.0, 0.0, {}
    for name, (pan, bg_seg, gap, top, l0) in staged_input_maps(cfg, store, dev).items():
        mine, differ = forecast[name], stage_canvases[name] != bg_seg
        sure = gap > 1e-4 * np.maximum(np.abs(top), 1.0)
        if (differ & sure).any():
            raise SystemExit(
                f"the staged canvas of {name} differs from the step's bg on the "
                f"staged inputs off near-ties: {int((differ & sure).sum())} pixels, "
                f"top-2 gaps there up to {float(gap[differ].max()):.4g} at top "
                f"logits up to {float(np.abs(top[differ]).max()):.4g}")
        if {k for k in np.unique(mine) if k >= 1000} != {k for k in np.unique(pan) if k >= 1000}:
            raise SystemExit(f"the staged instances of {name} differ from the step's")
        sure_share = min(sure_share, float(sure.mean()))
        unsure += int(differ.sum())
        tie_gap = max(tie_gap, float(gap[differ].max()) if differ.any() else 0.0)
        inputs_pan_gap = max(inputs_pan_gap, float((mine != pan)[sure].mean()))
        label0[name] = l0
    if not (sure_share > 0.99 and inputs_pan_gap < 1e-3):
        raise SystemExit(f"staged against the step on the staged inputs: "
                         f"{sure_share:.4f} of pixels off near-ties, panoptic "
                         f"mismatch there {inputs_pan_gap:.3e}")
    # ... and against phase 12's fused CLI, whose bg reads road where the
    # z-buffer holds label 0 and takes the float depth. The JAX package's
    # budget for the two (equal id sets, < 2 % of pixels) is not met by
    # the JAX package's own chains at 256x512 (tests/
    # staged_vs_fused_witness.py); here the guards are set from this
    # fixture's runs: < 2.5 % of pixels (2.1687 % read), and every segment
    # found in one map only under 256 pixels (103 at most read)
    fused = cli_outputs(phase12["cuda"])[0]
    worst, id_diff, on0 = 0.0, {}, [0, 0]
    for name, m in forecast.items():
        f = fused[name]
        worst = max(worst, float((m != f).mean()))
        on0 = [on0[0] + int(((m != f) & label0[name]).sum()), on0[1] + int((m != f).sum())]
        for k in set(np.unique(m)) ^ set(np.unique(f)):
            id_diff[f"{name}:{int(k)}"] = [int((m == k).sum()), int((f == k).sum())]
    label0_share = float(np.mean([l0.mean() for l0 in label0.values()]))
    things = thing_pixels(forecast)
    print(f"[staged] {H}x{W}: the staged chain against the step on the staged "
          f"chain's bg inputs: canvases equal off near-ties ({len(forecast)} frames, >= "
          f"{sure_share:.4f} of pixels; {unsure} canvas pixels at near-ties differ, "
          f"top-2 gap <= {tie_gap:.3g}), "
          f"panoptic mismatch there {inputs_pan_gap:.3e}; against the fused "
          f"CLI: worst mismatch {worst:.4%}, {on0[0]} of the {on0[1]} differing pixels "
          f"on label-0 pixels ({label0_share:.4f} of pixels), segment ids in one map "
          f"only (staged, fused pixels) {json.dumps(id_diff)}; {things} instance pixels")
    if not worst < 0.025 or any(max(n) >= 256 for n in id_diff.values()):
        raise SystemExit(f"staged against fused: {worst:.4%} of pixels differ, "
                         f"segments in one map only {id_diff}")

    gt_json, gt_dir, _ = gt_split(cfg, os.path.join(root, "gt"))
    pq_res, pq_s = evaluate(os.path.join(result_dir, f"{os.path.basename(result_dir)}.json"),
                            os.path.join(result_dir, os.path.basename(result_dir)),
                            gt_json, gt_dir)
    pq = {k: pq_res[k]["pq"] for k in ("All", "Things", "Stuff")}

    cs = os.path.join(os.path.dirname(cfg["working_dir"]), "cs")
    inst_argv = [a if a != "staged" else "staged_instances" for a in fg_argv]
    with store_readers(store):
        _, inst_launches, inst_s = counted(export_instances.main, inst_argv)
    inst_dir = os.path.join(cfg["working_dir"], "staged_instances_val")
    ts = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ap = evaluate_instances.main(["--pred_dir", inst_dir, "--cityscapes_dir", cs,
                                      "--split", "val"])
    ap_s = time.perf_counter() - ts
    n_gt = len(glob.glob(os.path.join(cs, "gtFine", "val", "*", "*_instanceIds.png")))
    if ap["allAp"] != 0.0 or not all(np.isnan(v["ap"]) for v in ap["per_class"].values()):
        raise SystemExit(f"instance AP on a GT with no instance: {ap}")
    masks = len(glob.glob(os.path.join(inst_dir, "*.png")))
    self_ap = self_scored_ap(root)
    if self_ap["allAp"] != 1.0 or self_ap["per_class"]["car"]["ap"] != 1.0:
        raise SystemExit(f"a self-scored instance map: {self_ap}")
    print(f"[staged] PQ {json.dumps(pq)} ({pq_s / len(anns):.4f} s per frame); "
          f"{masks} instance masks, AP allAp 0.0 (no GT instance), "
          f"{ap_s / n_gt:.4f} s per frame; self-scored map allAp 1.0 | {card}")

    viz_dir = os.path.join(root, "viz")
    one = os.path.join(root, "one.json")
    with open(one, "w") as f:
        json.dump({"annotations": anns[:1]}, f)
    with contextlib.redirect_stdout(io.StringIO()):
        viz_panoptic.main(["--annotations", one, "--label_dir",
                           os.path.join(result_dir, os.path.basename(result_dir)),
                           "--output_dir", viz_dir])
    overlay = load_png(os.path.join(viz_dir, anns[0]["image_id"] + "_viz.png"))
    if overlay.shape != (H, W, 3) or not overlay.any():
        raise SystemExit(f"viz_panoptic wrote {overlay.shape}")

    small, small_store, _ = fixtures["small"]
    sroot = os.path.dirname(small["working_dir"])
    got = {}
    for platform in ("cuda", "cpu"):
        run, _, _ = staged_chain(small, small_store, os.path.join(
            sroot, f"staged_{platform}"), platform, tag=f"_{platform}")
        got[platform] = (canvases(os.path.join(small["fused"]["bg_dir"],
                                               f"bg_staged_{platform}")),
                         panoptic_maps(run["panoptic"][0]["val"]["dir"])[0])
    canvas_gap = compare_maps(got["cuda"][0], got["cpu"][0], 1e-3, "canvases GPU against CPU")
    small_pan_gap = compare_maps(got["cuda"][1], got["cpu"][1], 1e-3, "staged GPU against CPU")
    print(f"[staged] {H_SMALL}x{W_SMALL} GPU against CPU: canvases worst {canvas_gap:.3e}, "
          f"panoptic worst {small_pan_gap:.3e}")
    phase_s = time.perf_counter() - ts0
    readings = {
        "prepare_bg_data_ms_per_frame": [ms / frames for ms in report["val"]["predict_ms"]],
        "prepare_bg_data_s": report["val"]["seconds"],
        "bg_export_ms_per_frame": bg_s * 1e3 / bg_frames,
        "export_panoptic_ms_per_frame": pan_s * 1e3 / pan_frames,
        "export_instances_s": inst_s, "pq": pq, "pq_s_per_frame": pq_s / len(anns),
        "ap_s_per_frame": ap_s / n_gt, "staged_vs_fused_mismatch": worst,
        "staged_vs_fused_ids_in_one_map": id_diff,
        "staged_vs_fused_differing_on_label0": on0, "label0_share": label0_share,
        "staged_inputs_sure_share": sure_share, "staged_inputs_near_tie_pixels": unsure,
        "staged_inputs_tie_gap": tie_gap, "staged_inputs_panoptic_mismatch": inputs_pan_gap,
        "small_canvas_mismatch": canvas_gap, "small_panoptic_mismatch": small_pan_gap,
        "launches": {"prepare_bg_data": prep_launches, "bg_export": bg_launches,
                     "export_panoptic": pan_launches, "export_instances": inst_launches},
        "pc_batches": pc_batches, "bg_batches": bg_batches, "phase_s": phase_s}
    print(f"[staged] readings {json.dumps(readings)} | {card}")
    print(f"[staged] phase 14 took {phase_s:.1f} s")
    return readings


# ---- 15. training ---------------------------------------------------------------

TRAIN_FG_SCENES = 10  # phase 12's fg fixture with a train split: >= 32 tracks
ODOM_STEPS = 25  # steps per epoch of the odom cli.train runs (phases 15, 17)
NARROW_FG = (("model.mask_feat_channels", 32), ("model.mask_feat_hw", 7),
             ("model.mask_head.conv_dim", 32), ("model.rnn_hidden", 32),
             ("model.instance_feat_hidden", 32), ("training.batch_size", 8))


def train_argv(kind, wd, data_dir, *sets):
    """cli.train's arguments: configs/{kind}/{kind}_train.yaml at full
    width on ``data_dir``, with dotted ``sets`` (path, value pairs)."""
    argv = ["--working_dir", wd, "--config_file",
            os.path.join(REPO, "configs", kind, f"{kind}_train.yaml")]
    keys = (("data_dir",) if kind == "odom" else
            ("data_dir", "depth_dir", "feats_dir", "info_3d_dir"))
    for k in keys:
        argv += ["--set", f"data.{k}", data_dir]
    for path, value in sets:
        argv += ["--set", path, str(value)]
    return argv


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms within the block, for training
    runs whose results are compared with each other."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def train_cli_run(argv, store):
    """cli.train.main on the card with the launch counts set to 0 just
    before and read just after: (result, launches, host seconds)."""
    reset_counts()
    ts = time.perf_counter()
    with store_readers(store):
        result = train_cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - ts
    launches = read_counts()
    losses = [v["loss"] for h in result["history"] for v in (h["train"], h["val"])
              if v is not None]
    if not result["history"] or not np.all(np.isfinite(losses)):
        raise SystemExit(f"training gave no or non-finite losses: {result['history']}")
    return result, launches, secs


def fg_step_flops(model, batch) -> float:
    """Convolution operations of one fg training step on ``batch``: each
    conv's 2·weight·B·hw² per call (ConvLSTM cells at every input and
    output step, the 1x1 heads and the instance compressor; the mask head
    is not in the loss), times 3 for the forward and the two backward
    products (input and weight gradients)."""
    b, t_in = batch["inputs"]["trajectories"].shape[:2]
    out_t = batch["labels"]["trajectories"].shape[1]
    calls = [(cell.conv, t_in) for cell in model.mask_encoder.cell_list]
    calls += [(cell.conv, out_t) for cell in model.mask_decoder.cell_list]
    calls += [(model.mask_encoder_out, 1), (model.mask_decoder_out, out_t),
              (model.instance_compressor, t_in + out_t)]
    hw2 = model.mask_feat_hw ** 2
    return 3 * sum(2 * conv.weight.numel() * b * hw2 * n for conv, n in calls)


CONV_KERNELS = ("conv", "gemm", "xmma", "cudnn", "wgrad", "dgrad", "fprop")


def kernel_kinds(prof):
    """Device ms of one profiled call by kind of kernel: convolutions and
    matrix products (cuDNN's and cuBLAS's kernels, by name), reductions,
    and the rest (elementwise passes and copies)."""
    out = {"conv_gemm": 0.0, "reduce": 0.0, "other": 0.0}
    for name, (_, us) in prof.items():
        low = name.lower()
        kind = ("conv_gemm" if any(k in low for k in CONV_KERNELS) else
                "reduce" if "reduce" in low else "other")
        out[kind] += us / 1e3
    return out


def train_steps(argv, store, dev, steps=20, warmup=3, flops=None):
    """Steps of the config's model (seeded) on one fixed training batch on
    the card: each step's ms by CUDA events after ``warmup``, the losses,
    the peak memory, and the device-busy ms per step from torch.profiler
    over 5 more steps; ``flops(model, batch)`` counts a step's operations
    (default: ``fg_step_flops`` for fg, none otherwise)."""
    with store_readers(store):
        cfg, data, model = setup(load_config(argv))
        batch = next(iter(data.loader("train", cfg, seed=SEED)))
    batch = to_device(batch, dev)
    init_weights(model, SEED)
    model.train()
    opt = build_optimizer(model, cfg)

    def step():
        loss, _ = model.loss(batch)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # earlier phases' tensors
    losses, events = [], []
    for i in range(steps):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        losses.append(step())
        ev[1].record()
        if i >= warmup:
            events.append(ev)
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in events)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    busy = device_ms(step, 5)
    prof = kernel_profile(step, 1)
    launches = sum(n for n, _ in prof.values())
    losses = torch.stack(losses).cpu().numpy()
    bs = int(cfg["training"]["batch_size"])
    med = ms[len(ms) // 2]
    if flops is None and cfg["task"] == "fg":
        flops = fg_step_flops
    flops = flops(model, batch) if flops is not None else None
    return {"batch": bs, "ms_median": med, "ms_min": ms[0], "ms_max": ms[-1],
            "conv_tflop": flops and flops / 1e12,
            "conv_tflop_per_s": flops and flops / med / 1e9,
            "conv_f32_bound_ms": flops and flops / F32_FLOP_PER_S * 1e3,
            "samples_per_s": bs / med * 1e3, "peak_gib": peak,
            "busy_ms": busy, "busy_share": busy / med, "kernels_per_step": launches,
            "device_ms_by_kind": kernel_kinds(prof),
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "losses_finite": bool(np.isfinite(losses).all())}


def one_step_gpu_cpu(root, dev, *sets, tag="narrow"):
    """One fg step from the same seeded weights and batch on the card and
    on the CPU at narrow widths (a 32-channel 7x7 fixture), with dotted
    ``sets``: ({platform: loss}, loss relative difference, largest
    gradient difference over its tensor's largest entry, largest
    parameter excess over the Adam bound)."""
    fg = os.path.join(root, f"fg_{tag}")
    store = synthetic.write_fg_fixture(fg, n_scenes=3, max_instances=3, seed=SEED,
                                       feat_channels=32, feat_hw=7)
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        argv = train_argv("fg", os.path.join(root, f"{tag}_{name}"), fg,
                          ("platform", name), *NARROW_FG, *sets)
        with store_readers(store):
            cfg, data, model = setup(load_config(argv))
            batch = next(iter(data.loader("train", cfg, seed=SEED)))
        init_weights(model, SEED)
        model.train()
        before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        loss, _ = model.loss(to_device(batch, d))
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        build_optimizer(model, cfg).step()
        after = {n: p.detach().cpu() for n, p in model.named_parameters()}
        out[name] = (float(loss.detach()), before, grads, after, float(cfg["training"]["lr"]))
    (lg, before, gg, ag, lr), (lc, _, gc, ac, _) = out["cuda"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    grad_rel = max(float((gg[n] - gc[n]).abs().max() / gc[n].abs().max().clamp(min=1e-30))
                   for n in gc)
    # Adam's first step is lr·g/(|g| + eps): its slope in g is at most 1/eps
    excess = -float("inf")
    for n in ag:
        dg = (gg[n] - gc[n]).abs() if n in gg else torch.zeros_like(ag[n])
        ulp = 4 * torch.maximum(before[n].abs(), torch.tensor(lr)) * 2.0 ** -23
        excess = max(excess, float(((ag[n] - ac[n]).abs() - lr * dg / 1e-8 - ulp).max()))
    return {"cuda": lg, "cpu": lc}, rel, grad_rel, excess


def cpu_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def adam_moments(model, wd):
    """{parameter name: (m, √v)} of the Adam state in ``wd``'s trainer
    state."""
    state = ckpt.load_trainer_state(wd)["opt_state"]["state"]
    return {n: (state[i]["exp_avg"], state[i]["exp_avg_sq"].sqrt())
            for i, (n, _) in enumerate(model.named_parameters())
            if i in state and "exp_avg_sq" in state[i]}


def train_phase(dev, root, card, refs):
    """Phase 15: cli.train on the card with both training configs at full
    width; the fg run resumed; fixed-batch step timings; one narrow fg
    step on the card against the CPU. Puts its fixtures and one-process
    runs in ``refs`` (phase 17 holds the data-parallel runs to them)."""
    ts0 = time.perf_counter()
    odom_dir = os.path.join(root, "odom_train")
    odom_store = synthetic.write_odom_fixture(odom_dir, n_snippets=TIMED_SNIPPETS)
    fg_dir = os.path.join(root, "fg_train")
    fg_store = synthetic.write_fg_fixture(fg_dir, n_scenes=TRAIN_FG_SCENES,
                                          max_instances=N_INST, seed=SEED)
    tracks = len(fg_store["tables"][os.path.join(fg_dir, "train_instance_meta.pkl")])
    if tracks < 32:
        raise SystemExit(f"the fg train split holds {tracks} tracks, fewer than a batch")

    odom_argv = train_argv("odom", os.path.join(root, "odom_run"), odom_dir,
                           ("training.steps_per_epoch", ODOM_STEPS), ("training.num_epochs", 2))
    odom, odom_launches, odom_s = train_cli_run(odom_argv, odom_store)
    wd = os.path.join(root, "fg_run")
    fg_argv = train_argv("fg", wd, fg_dir, ("training.steps_per_epoch", 10),
                         ("training.num_epochs", 2))
    # the fg runs are compared (resumed against a straight 3-epoch run):
    # cuDNN's default backward convolutions are not deterministic (the gap
    # reached 1.079e-3 in one run of this script), so these take its
    # deterministic ones; the resumed epoch must agree within 1e-3
    with cudnn_deterministic():
        fg, fg_launches, fg_s = train_cli_run(fg_argv, fg_store)
        refs.update(odom_dir=odom_dir, odom_store=odom_store, fg_dir=fg_dir,
                    fg_store=fg_store, odom=(odom["history"], cpu_state(odom["model"])),
                    fg=(fg["history"], cpu_state(fg["model"])),
                    adam={"odom": adam_moments(odom["model"], odom_argv[1]),
                          "fg": adam_moments(fg["model"], wd)})
        saved = ckpt.load_trainer_state(wd)
        resumed, resume_launches, resume_s = train_cli_run(
            fg_argv + ["--continue_training", "--set", "training.num_epochs", "3"],
            fg_store)
        straight, _, _ = train_cli_run(train_argv(
            "fg", os.path.join(root, "fg_straight"), fg_dir,
            ("training.steps_per_epoch", 10), ("training.num_epochs", 3)), fg_store)
    after = ckpt.load_trainer_state(wd)
    adam_steps = int(after["opt_state"]["state"][0]["step"])
    resume_gap = max(abs(resumed["history"][0][split]["loss"]
                         - straight["history"][2][split]["loss"])
                     / abs(straight["history"][2][split]["loss"])
                     for split in ("train", "val"))
    a, b = resumed["model"].state_dict(), straight["model"].state_dict()
    resume_param_gap = max(float((a[k] - b[k]).abs().max()) for k in a)
    print(f"[train] odom {odom['step']} steps in {odom_s:.1f} s, fg {fg['step']} "
          f"steps in {fg_s:.1f} s, resumed at epoch {saved['epoch']} step "
          f"{saved['step']}: {resumed['step']} steps, Adam step count {adam_steps}")
    if (odom["step"], fg["step"], saved["step"], saved["epoch"]) != (2 * ODOM_STEPS, 20, 20, 3):
        raise SystemExit(f"the training runs took other steps than 2 epochs of "
                         f"{ODOM_STEPS} / 10")
    if ([h["epoch"] for h in resumed["history"]] != [3] or resumed["step"] != 30
            or after["step"] != 30 or adam_steps != 30):
        raise SystemExit("the resumed fg run did not continue from the saved step "
                         "and optimizer state")
    print(f"[train] fg epoch 3 resumed against straight (cuDNN deterministic): losses "
          f"{resume_gap:.3e} "
          f"apart relative (limit 1e-3), parameters at most {resume_param_gap:.3e}")
    if not resume_gap < 1e-3:
        raise SystemExit("the resumed fg epoch differs from the straight run's")
    graphs = {"odom": odom["graph"], "fg": fg["graph"], "fg_resumed": resumed["graph"]}
    print(f"[train] step graphs (Adam keeps its step count on the host: every step "
          f"eager): {json.dumps(graphs)}")
    if any(c["eager"]["optimizer"] != c["steps"] or not c["steps"] for c in graphs.values()):
        raise SystemExit(f"an Adam run did not keep every step eager: {graphs}")
    launched = {k: v for k, v in {**odom_launches, **fg_launches,
                                  **resume_launches}.items() if v}
    print(f"[train] kernel launches while training: "
          f"{json.dumps({'odom': odom_launches, 'fg': fg_launches, 'fg_resumed': resume_launches})}"
          f" (the training path reaches no kernel of the port: "
          f"{'none launched' if not launched else launched})")

    steps = {"odom": train_steps(odom_argv, odom_store, dev),
             "fg": train_steps(fg_argv, fg_store, dev)}
    for kind, r in steps.items():
        print(f"[train] {kind} step, batch {r['batch']} on the card: median "
              f"{r['ms_median']:.2f} ms ({r['ms_min']:.2f}-{r['ms_max']:.2f}, CUDA "
              f"events), {r['samples_per_s']:.1f} samples/s, peak "
              f"{r['peak_gib']:.2f} GiB above earlier phases' tensors, device busy "
              f"{r['busy_ms']:.2f} ms ({r['busy_share']:.3f} of a step) over "
              f"{r['kernels_per_step']} kernel launches, loss {r['loss_first']:.5f} -> "
              f"{r['loss_last']:.5f} over 20 steps on one batch | {card}")
        if not r["losses_finite"]:
            raise SystemExit(f"{kind}: non-finite training losses")
    f = steps["fg"]
    print(f"[train] fg step: {f['conv_tflop']:.3f} TFLOP of convolutions, "
          f"{f['conv_tflop_per_s']:.1f} TFLOP/s; f32 bound (67 TFLOP/s) "
          f"{f['conv_f32_bound_ms']:.2f} ms | {card}")
    if not steps["fg"]["loss_last"] < steps["fg"]["loss_first"]:
        raise SystemExit("20 fg steps on one batch did not lower its loss")
    step_losses, rel, grad_rel, excess = one_step_gpu_cpu(root, dev)
    print(f"[train] one narrow fg step, card against CPU: losses "
          f"{step_losses['cuda']!r} / {step_losses['cpu']!r}, relative difference "
          f"{rel:.3e} (limit 1e-4); gradients at most {grad_rel:.3e} of their "
          f"tensor's largest entry apart; parameters {excess:.3e} over "
          f"lr·|Δg|/eps + 4 ulp at most (limit 0)")
    if not rel < 1e-4 or excess > 0:
        raise SystemExit("the fg step on the card and on the CPU disagree")
    phase_s = time.perf_counter() - ts0
    readings = {"steps": steps, "odom_cli_s": odom_s, "fg_cli_s": fg_s,
                "fg_resume_s": resume_s, "fg_tracks": tracks,
                "resume_loss_gap": resume_gap, "resume_param_gap": resume_param_gap,
                "gpu_cpu_losses": step_losses, "gpu_cpu_loss_rel": rel,
                "gpu_cpu_grad_rel": grad_rel, "gpu_cpu_param_excess": excess,
                "launches": {"odom": odom_launches, "fg": fg_launches,
                             "fg_resumed": resume_launches}, "graph": graphs,
                "phase_s": phase_s}
    print(f"[train] phase 15 took {phase_s:.1f} s")
    return readings


# ---- 16. bg training ------------------------------------------------------------

BG_SNIPPETS = 4  # per split; two gap groups -> 8 train samples, one full batch
BG_STEPS = 3  # steps per epoch of the cli.train runs
BG_NARROW = 128  # crop of the card-against-CPU step (deepest BNs: 2x2 at batch 2)


def bg_train_argv(wd, data, *sets):
    """cli.train's arguments: configs/bg/bg_train.yaml at full width (batch
    8, crop 800, scale 0.5-2.0, val batch 4 at the fixture's 1024x2048) on
    a ``write_bg_fixture`` tree, the depth statistics file in ``wd``, with
    dotted ``sets`` (path, value pairs)."""
    argv = ["--working_dir", wd, "--config_file",
            os.path.join(REPO, "configs", "bg", "bg_train.yaml"),
            "--set", "data.data_dir", "[" + ",".join(data["data_dir"]) + "]",
            "--set", "data.depth_norm_params_file",
            os.path.join(wd, "depth_norm_params.npz")]
    for key in ("gt_dir", "depth_h5_path", "cityscapes_dir"):
        argv += ["--set", f"data.{key}", data[key]]
    for path, value in sets:
        argv += ["--set", path, str(value)]
    return argv


def step_flops(model, batch) -> float:
    """Operations of one training step's forward and backward on
    ``batch`` as ``torch.utils.flop_counter`` counts them (convolutions,
    their input and weight gradients, and the resize matmuls)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        model.loss(batch)[0].backward()
    for p in model.parameters():
        p.grad = None
    return float(fc.get_total_flops())


def loader_ms(argv, store, batches=6):
    """Host ms per batch of the training loader (its threads and
    prefetch as the config sets them) over ``batches`` batches after the
    first, apart from any step: (median, min, max)."""
    with store_readers(store):
        cfg, data, _ = setup(load_config(argv + [
            "--set", "training.steps_per_epoch", str(batches + 1)]))
        loader = data.loader("train", cfg, seed=SEED)
        loader.set_epoch(1)
        stamps = []
        for _ in loader:
            stamps.append(time.perf_counter())
    gaps = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
    return gaps[len(gaps) // 2], gaps[0], gaps[-1]


def bg_narrow_step(argv, store, dev):
    """One bg step from the seeded weights on one narrow batch (crop
    ``BG_NARROW``, batch 2) on the card, on the CPU and on the CPU in
    float64: (losses, loss relative difference card/CPU, the card's and
    the CPU's largest running-statistic distance from float64 over its
    tensor's largest entry, per tensor the card's and the CPU's f32
    gradient distance from float64 over the tensor's largest entry, and
    the same over all parameters as relative L2 distances: card and CPU
    from float64, card from CPU)."""
    sets = ["--set", "data.crop_size", str(BG_NARROW), "--set", "training.batch_size", "2"]
    with store_readers(store):
        cfg, data, _ = setup(load_config(argv + sets + ["--set", "platform", "cpu"]))
        batch = next(iter(data.loader("train", cfg, seed=SEED)))
    out = {}
    for name, d, dtype in (("cuda", dev, torch.float32),
                           ("cpu", torch.device("cpu"), torch.float32),
                           ("cpu64", torch.device("cpu"), torch.float64)):
        model = build_model(cfg, data.card, d)
        init_weights(model, SEED)
        model.to(dtype).train()
        loss, _ = model.loss(to_device(batch, d))
        loss.backward()
        out[name] = (float(loss.detach()),
                     {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()},
                     {n: b.detach().double().cpu() for n, b in model.named_buffers()
                      if "running" in n})
    (lg, gg, sg), (lc, gc, sc), (_, g64, s64) = out["cuda"], out["cpu"], out["cpu64"]
    gaps = {n: (float((gg[n] - g64[n]).abs().max() / g64[n].abs().max()),
                float((gc[n] - g64[n]).abs().max() / g64[n].abs().max())) for n in g64}
    stat_gap = tuple(max(float((s[n] - s64[n]).abs().max() / s64[n].abs().max())
                         for n in s64) for s in (sg, sc))

    def l2(a, b):
        return (sum(float((a[n] - b[n]).square().sum()) for n in b)
                / sum(float(b[n].square().sum()) for n in b)) ** 0.5

    return ({"cuda": lg, "cpu": lc}, abs(lg - lc) / abs(lc), stat_gap, gaps,
            {"cuda_f64": l2(gg, g64), "cpu_f64": l2(gc, g64), "cuda_cpu": l2(gg, gc)})


def serve_trained(wd, data, store, dev, other=None):
    """The trained ``wd/best_model`` through the bg canvas export
    (``export_segmentation`` with configs/bg/bg_val_short.yaml on the
    fixture's gap-3 group, folded: K2), counted; its class maps against
    the same weights' unfolded eval-mode graph on the same inputs, and
    ``other`` ({frame: class map} of another export, if given) against
    this export. -> (launches, batches, frames, ms per frame, pixels that
    differ, of them where the unfolded top-2 logits are within 1e-3,
    pixels, and the same two counts for ``other``)."""
    bg = conf("bg", "bg_val_short.yaml")
    short = [d for d in data["data_dir"] if "_gap3_" in d]
    bg["data"].update(data_dir=short, gap_len=[3], gt_dir=data["gt_dir"],
                      depth_h5_path=data["depth_h5_path"],
                      cityscapes_dir=data["cityscapes_dir"])
    cfg_path = dump(os.path.join(wd, "bg_serve.yaml"), bg)
    argv = ["--working_dir", wd, "--config_file", cfg_path, "--set", "no_convert",
            "true", "--set", "export_name", "bg_trained"]
    with store_readers(store):
        report, launches, secs = counted(export_segmentation.main, argv)
        cfg, task_data, model = setup(load_config(argv), test=True)
        model = restore_params(cfg, model).eval()
        loader = task_data.loader("val", cfg, test=True)
        maps = canvases(os.path.join(wd, "bg_trained"))
        differ = near_tie = frames = batches = other_differ = other_tie = 0
        for batch in loader:
            batches += 1
            logits = model(batch["inputs"])
            top2 = torch.topk(logits, 2, dim=1).values
            ref = logits.argmax(1).cpu().numpy()
            tie = ((top2[:, 0] - top2[:, 1]) < 1e-3).cpu().numpy()
            meta = batch["meta"]
            for i in range(len(ref)):
                frames += 1
                got = maps[f"{meta['city'][i]}_{meta['seq'][i]}_"
                           f"{int(meta['target_frame'][i]):06d}"]
                mis = got != ref[i]
                differ += int(mis.sum())
                near_tie += int((mis & tie[i]).sum())
                if other is not None:
                    mis = got != other[f"{meta['city'][i]}_{meta['seq'][i]}_"
                                       f"{int(meta['target_frame'][i]):06d}"]
                    other_differ += int(mis.sum())
                    other_tie += int((mis & tie[i]).sum())
    return (launches, batches, frames, 1e3 * secs / max(frames, 1), differ, near_tie,
            frames * ref.shape[-2] * ref.shape[-1], other_differ, other_tie)


def bg_train_phase(dev, root, card, refs):
    """Phase 16: cli.train on configs/bg/bg_train.yaml at full width on the
    card, resumed; fixed-batch steps; the loader apart; one narrow step on
    the card against the CPU; the trained weights served through K2. Puts
    its fixture, its first run (history and ``best_model``) and working
    dir in ``refs``."""
    ts0 = time.perf_counter()
    bg_dir = os.path.join(root, "bg_train")
    data, store = synthetic.write_bg_fixture(bg_dir, n_snippets=BG_SNIPPETS, height=H,
                                             width=W, seed=SEED, gap_lens=(9, 3))
    fixture_s = time.perf_counter() - ts0
    steps = ("training.steps_per_epoch", BG_STEPS)
    wd = os.path.join(root, "bg_run")
    # the resumed epoch is compared with the straight run's
    with cudnn_deterministic():
        first, first_launches, first_s = train_cli_run(
            bg_train_argv(wd, data, steps, ("training.num_epochs", 2)), store)
        refs.update(bg_data=data, bg_store=store, bg_wd=wd, bg=(
            first["history"], cpu_state(first["model"]),
            torch.load(os.path.join(wd, ckpt.BEST), map_location="cpu", weights_only=True)))
        saved = ckpt.load_trainer_state(wd)
        resumed, resume_launches, resume_s = train_cli_run(bg_train_argv(
            wd, data, steps, ("training.num_epochs", 3)) + ["--continue_training"], store)
        straight, straight_launches, _ = train_cli_run(bg_train_argv(
            os.path.join(root, "bg_straight"), data, steps, ("training.num_epochs", 3)), store)
    samples = (len(glob.glob(os.path.join(data["gt_dir"], "train", "*", "*.png")))
               * len(data["gap_len"]))
    after = ckpt.load_trainer_state(wd)
    state = torch.load(os.path.join(wd, ckpt.LATEST), map_location="cpu", weights_only=True)
    tracked = int(state["model.base.0.norm.num_batches_tracked"])
    momentum = all("momentum_buffer" in v for v in after["opt_state"]["state"].values())
    print(f"[train] bg: {samples} train samples; {first['step']} steps in {first_s:.1f} s, "
          f"resumed at epoch {saved['epoch']} step {saved['step']}: {resumed['step']} "
          f"steps, BN batches tracked {tracked}, SGD momentum kept {momentum}")
    if (samples < 8 or first["step"] != 2 * BG_STEPS
            or (saved["epoch"], saved["step"]) != (3, 2 * BG_STEPS)):
        raise SystemExit("the bg run took other steps than 2 epochs of "
                         f"{BG_STEPS} on a full batch")
    if ([h["epoch"] for h in resumed["history"]] != [3] or resumed["step"] != 3 * BG_STEPS
            or tracked != 3 * BG_STEPS or not momentum):
        raise SystemExit("the resumed bg run did not continue from the saved step, "
                         "BN statistics and SGD momentum")
    graphs = {"first": first["graph"], "resumed": resumed["graph"],
              "straight": straight["graph"]}
    print(f"[train] bg step graphs (the first step of each run eager, the rest "
          f"replayed): {json.dumps(graphs)}")
    if any((c["captures"], c["replays"], c["eager"]["first_step"]) != (1, c["steps"] - 1, 1)
           for c in graphs.values()):
        raise SystemExit(f"the bg runs were not replayed after their first step: {graphs}")
    gap = max(abs(resumed["history"][0][split]["loss"]
                  - straight["history"][2][split]["loss"])
              / abs(straight["history"][2][split]["loss"]) for split in ("train", "val"))
    a, b = resumed["model"].state_dict(), straight["model"].state_dict()
    param_gap = max(float((a[k].double() - b[k].double()).abs().max()) for k in a)
    print(f"[train] bg epoch 3 resumed against straight (cuDNN deterministic): losses "
          f"{gap:.3e} apart relative (limit 1e-3), state at most {param_gap:.3e}")
    if not gap < 1e-3:
        raise SystemExit("the resumed bg epoch differs from the straight run's")
    launches = {"first": first_launches, "resumed": resume_launches,
                "straight": straight_launches}
    launched = {k: v for run in launches.values() for k, v in run.items() if v}
    print(f"[train] bg kernel launches while training and validating: "
          f"{json.dumps(launches)}")
    if launched:
        raise SystemExit(f"bg training launched a kernel of the port: {launched}")

    argv = bg_train_argv(wd, data, steps)
    step = train_steps(argv, store, dev, flops=step_flops)
    print(f"[train] bg step, batch {step['batch']} at 800x800 on the card: median "
          f"{step['ms_median']:.2f} ms ({step['ms_min']:.2f}-{step['ms_max']:.2f}, CUDA "
          f"events), {step['samples_per_s']:.1f} images/s, peak {step['peak_gib']:.2f} "
          f"GiB of the step's own, device busy {step['busy_ms']:.2f} ms "
          f"({step['busy_share']:.3f} of a step) over {step['kernels_per_step']} kernel "
          f"launches, loss {step['loss_first']:.5f} -> {step['loss_last']:.5f} over 20 "
          f"steps on one batch | {card}")
    kinds = step["device_ms_by_kind"]
    print(f"[train] bg step: {step['conv_tflop']:.4f} TFLOP (flop_counter), "
          f"{step['conv_tflop_per_s']:.1f} TFLOP/s; f32 bound (67 TFLOP/s) "
          f"{step['conv_f32_bound_ms']:.2f} ms; device ms of one profiled step: "
          f"convolutions and matmuls {kinds['conv_gemm']:.2f}, reductions "
          f"{kinds['reduce']:.2f}, other (elementwise, copies) {kinds['other']:.2f} "
          f"| {card}")
    if not step["losses_finite"] or not step["loss_last"] < step["loss_first"]:
        raise SystemExit("20 bg steps on one batch did not lower a finite loss")
    load = loader_ms(argv, store)
    print(f"[train] bg loader: {load[0]:.1f} ms per batch of 8 (median; {load[1]:.1f}-"
          f"{load[2]:.1f}), against the step's {step['ms_median']:.1f} ms | {card}")

    # HarDNet's f32 step at batch 2 is itself far from float64 on the CPU
    # (gradients 1.3e-1 of a tensor's largest entry, 5.6e-2 over all
    # parameters, statistics 1.4e-4, as this phase prints): ReLU inputs sit
    # within rounding of their kinks and the deepest BNs see 8 values.
    # So the card is held to the CPU's float64 step as closely as the
    # CPU's f32 step is (twice its distance, plus a floor), not entry by
    # entry; an unbiased running variance would be 1/7 off there.
    losses, rel, stat_gap, gaps, l2 = bg_narrow_step(argv, store, dev)
    card_gap = max(g for g, _ in gaps.values())
    cpu_gap = max(c for _, c in gaps.values())
    excess = max(l2["cuda_f64"] - (2 * l2["cpu_f64"] + 1e-3),
                 stat_gap[0] - (2 * stat_gap[1] + 1e-5))
    print(f"[train] one bg step at crop {BG_NARROW}, batch 2, card against CPU: losses "
          f"{losses['cuda']!r} / {losses['cpu']!r}, relative difference {rel:.3e} "
          f"(limit 1e-4); from the CPU's float64 step: running statistics at most "
          f"{stat_gap[0]:.3e} (card) and {stat_gap[1]:.3e} (CPU) of their tensor's "
          f"largest entry, gradients at most {card_gap:.3e} (card) and {cpu_gap:.3e} "
          f"(CPU) of a tensor's largest entry and {l2['cuda_f64']:.3e} (card) and "
          f"{l2['cpu_f64']:.3e} (CPU) relative L2 over all parameters (card to CPU "
          f"{l2['cuda_cpu']:.3e}); the card {excess:.3e} over twice the CPU's + 1e-3 "
          f"(gradients) or + 1e-5 (statistics) (limit 0)")
    if not rel < 1e-4 or excess > 0:
        raise SystemExit("the bg step on the card and on the CPU disagree")

    serve = serve_trained(wd, data, store, dev)
    k2, batches, frames, ms, differ, near_tie, pixels, _, _ = serve
    print(f"[train] bg trained weights served (export_segmentation, folded): launches "
          f"{json.dumps(k2)} for {batches} bg batches ({frames} frames, {ms:.1f} ms a "
          f"frame); class maps against the unfolded eval graph: {differ} of {pixels} "
          f"pixels differ, {near_tie} of them at top-2 logit gaps < 1e-3")
    if k2["onehot_stem_conv"] != batches or sum(k2.values()) != batches:
        raise SystemExit(f"serving the trained bg weights launched {k2}, not one "
                         "onehot_stem_conv per batch")
    if not differ < 1e-3 * pixels or differ > near_tie:
        raise SystemExit("the served class maps differ from the unfolded graph's")
    phase_s = time.perf_counter() - ts0
    readings = {"step": step, "loader_ms": load, "fixture_s": fixture_s,
                "cli_s": first_s, "resume_s": resume_s, "train_samples": samples,
                "resume_loss_gap": gap, "resume_state_gap": param_gap,
                "launches": launches, "graph": graphs, "gpu_cpu_losses": losses,
                "gpu_cpu_loss_rel": rel,
                "gpu_cpu_stat_gap": stat_gap, "gpu_f64_grad_gap": card_gap,
                "cpu_f64_grad_gap": cpu_gap, "grad_l2": l2, "grad_excess": excess,
                "serve": {"launches": k2, "batches": batches, "frames": frames,
                          "ms_per_frame": ms, "pixels_differ": differ,
                          "near_tie": near_tie, "pixels": pixels},
                "phase_s": phase_s}
    print(f"[train] phase 16 took {phase_s:.1f} s")
    return readings


# ---- 17. data parallelism ---------------------------------------------------------

DP_PLAIN_STEPS, DP_TIMED_STEPS = 6, 6  # measured bg steps on two ranks, each way
# Configs whose two-rank f32 runs drift from the one-process ones beyond
# 1e-4 while their steps agree (PERF.md, §6): held to a float64 step.
FLOAT64_HELD = ("fg", "bg")
DP_FILES = (ckpt.BEST, ckpt.LATEST, ckpt.TRAINER, "config.yaml", "data_card.json",
            os.path.join("logs", "metrics.jsonl"))


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def dp_bg_steps(argv, store):
    """Steps of the bg model (seeded) on this rank's rows of one fixed
    batch, as the trainer takes them (BN and the valid count global, the
    gradient all-reduced): rank's ms per step by the host clock between
    barriers (``DP_PLAIN_STEPS`` after 2 of warm-up); then as many with
    every all-reduce counted and timed (synchronised before and after),
    classified by its place in the step."""
    import torch.distributed as dist

    with store_readers(store):
        cfg, data, model = setup(load_config(argv + ["--distributed"]))
        batch = next(iter(data.loader("train", cfg, seed=SEED, shard=True)))
    sharded = batch.pop("sharded", False)
    batch = to_device(batch, next(model.parameters()).device)
    init_weights(model, SEED)
    model.train()
    opt = build_optimizer(model, cfg)
    n_params = sum(p.numel() for p in opt.params)

    def step():
        with mesh.sharded_batch(sharded):
            loss, _ = model.loss(batch)
        loss.backward()
        mesh.all_reduce_grads(opt.params, average=not model.loss_adds_over_shards)
        opt.step()
        opt.zero_grad()

    def timed_step():
        mesh.barrier()
        sync()
        ts = time.perf_counter()
        step()
        sync()
        return 1e3 * (time.perf_counter() - ts)

    plain = [timed_step() for _ in range(2 + DP_PLAIN_STEPS)][2:]
    calls, orig = [], dist.all_reduce

    def counted_all_reduce(t, *args, **kwargs):
        sync()
        ts = time.perf_counter()
        out = orig(t, *args, **kwargs)
        sync()
        calls.append((t.numel(), t.numel() * t.element_size(),
                      1e3 * (time.perf_counter() - ts)))
        return out

    per_step = []
    dist.all_reduce = counted_all_reduce
    try:
        for _ in range(DP_TIMED_STEPS):
            calls.clear()
            ms = timed_step()
            first = next(i for i, c in enumerate(calls) if c[0] == 1)  # the valid count
            kinds = {"bn_forward": calls[:first], "valid_count": calls[first: first + 1],
                     "bn_backward": [c for c in calls[first + 1:] if c[0] != n_params],
                     "gradient": [c for c in calls[first + 1:] if c[0] == n_params]}
            per_step.append((ms, {k: (len(v), sum(c[1] for c in v), sum(c[2] for c in v))
                                  for k, v in kinds.items()}))
    finally:
        dist.all_reduce = orig
    plain.sort()
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    kinds = per_step[0][1]
    return {"rows": int(batch["labels"]["seg"].shape[0]), "sharded": sharded,
            "step_ms_median": med(plain), "step_ms_min": plain[0], "step_ms_max": plain[-1],
            "counted_step_ms_median": med([ms for ms, _ in per_step]),
            "collectives": {k: {"calls": kinds[k][0], "bytes": kinds[k][1],
                                "ms_median": med([s[k][2] for _, s in per_step])}
                            for k in kinds},
            "calls_same_every_step": all(
                {k: v[:2] for k, v in s.items()} == {k: v[:2] for k, v in kinds.items()}
                for _, s in per_step),
            "collective_ms_median": med([sum(v[2] for v in s.values()) for _, s in per_step]),
            "gradient_floats": n_params}


def first_step(argv, store, shard=False, dtype=torch.float32):
    """One training step of the config's model (seeded, then cast to
    ``dtype``) on the first training batch, this rank's rows of it with
    ``shard``, as the trainer takes it. -> ({name: gradient after the
    all-reduce}, {name: parameter or BN statistic after the step}, the
    learning rate), on the CPU."""
    with store_readers(store):
        cfg, data, model = setup(load_config(argv + (["--distributed"] if shard else [])))
        batch = next(iter(data.loader("train", cfg, seed=SEED, shard=shard)))
    sharded = batch.pop("sharded", False)
    init_weights(model, SEED)
    model.to(dtype).train()
    opt = build_optimizer(model, cfg)
    with mesh.sharded_batch(sharded):
        loss, _ = model.loss(to_device(batch, next(model.parameters()).device))
    loss.backward()
    mesh.all_reduce_grads(opt.params, average=not model.loss_adds_over_shards)
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().clone()
             for n, p in model.named_parameters()}
    opt.step()
    return grads, cpu_state(model), float(cfg["training"]["lr"])


def dp_worker(spec_path: str, rank: int) -> int:
    """One rank of phase 17 (``chip_smoke.py --dp-rank SPEC RANK``). It
    joins gloo at the spec's address, or leaves NCCL to cli.train through
    torchrun's environment; runs each job's ``cli.train.main`` with
    ``--distributed`` and the launch counts set to 0 just before and read
    just after (rank 1 records what it writes under the jobs' working
    dirs); then each of the spec's first steps (``first_step``) and, if
    asked, the measured bg steps; and saves its results to
    ``SPEC.rank{rank}``."""
    import datetime
    import pickle

    import torch.distributed as dist

    spec = torch.load(spec_path, weights_only=False)
    with open(spec["stores"], "rb") as f:
        stores = pickle.load(f)
    if spec.get("addr"):
        dist.init_process_group("gloo", init_method=f"tcp://{spec['addr']}",
                                world_size=spec["world"], rank=rank,
                                timeout=datetime.timedelta(seconds=spec["timeout"]))
    torch.backends.cudnn.deterministic = True  # the runs are compared
    wds = [os.path.abspath(job["wd"]) for job in spec["jobs"]]
    writes = []

    def audit(event, args):
        if event == "open" and args[1] is not None and any(c in str(args[1]) for c in "wax+"):
            path = args[0]
        elif event in ("os.mkdir", "os.rename", "os.remove", "shutil.rmtree"):
            path = args[0]
        else:
            return
        if isinstance(path, (str, bytes, os.PathLike)):
            path = os.path.abspath(os.fsdecode(path))
            if any(path == wd or path.startswith(wd + os.sep) for wd in wds):
                writes.append((event, path))

    if rank:
        sys.addaudithook(audit)
    out = {}
    for job in spec["jobs"]:
        n_writes = len(writes)
        reset_counts()
        ts = time.perf_counter()
        with store_readers(stores[job["store"]]):
            result = train_cli.main(job["argv"] + ["--distributed"])
        sync()
        out[job["name"]] = {
            "secs": time.perf_counter() - ts, "launches": read_counts(),
            "history": result["history"], "step": result["step"],
            "state": cpu_state(result["model"]), "writes": writes[n_writes:],
            "graph": result["graph"], "backend": dist.get_backend(),
            "world": dist.get_world_size()}
        mesh.barrier()
    for name, argv in spec.get("first_steps", {}).items():
        for dtype in (torch.float32,) + ((torch.float64,) if name in FLOAT64_HELD else ()):
            out[f"first_step_{name}_{dtype}"] = first_step(argv, stores[name], True, dtype)
    if spec.get("measure"):
        out["measure"] = dp_bg_steps(spec["measure"], stores["bg"])
    torch.save(out, f"{spec_path}.rank{rank}")
    mesh.barrier()
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_launch(spec, root, tag, world, env, timeout):
    """Start ``world`` ranks of ``dp_worker`` on ``spec`` (each a process
    of this script, its output in ``root/dp_{tag}.rank{r}.log``); kill
    them all when one fails or the timeout passes. -> each rank's
    results."""
    path = os.path.join(root, f"dp_{tag}.spec")
    torch.save(dict(spec, world=world, timeout=timeout), path)
    logs = [open(os.path.join(root, f"dp_{tag}.rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", path,
                               str(r)], cwd=REPO, env=dict(os.environ, **env), stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    ts, failed = time.perf_counter(), None
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                failed = "a rank failed"
                break
            if time.perf_counter() - ts > timeout:
                failed = f"the ranks took longer than {timeout} s"
                break
            time.sleep(0.2)
        if failed is None and any(p.returncode for p in procs):
            failed = "a rank failed"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if failed:
        for r in range(world):
            with open(os.path.join(root, f"dp_{tag}.rank{r}.log")) as f:
                print(f"[dp] rank {r} of {tag} (exit {procs[r].returncode}):\n"
                      + f.read()[-3000:])
        raise SystemExit(f"phase 17 ({tag}): {failed}")
    return [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(world)]


def loss_gaps(got, want):
    """Largest relative gap of any epoch's train or val loss."""
    if [h["epoch"] for h in got] != [h["epoch"] for h in want]:
        raise SystemExit(f"epochs differ: {[h['epoch'] for h in got]}")
    return max(abs(a[s]["loss"] - b[s]["loss"]) / abs(b[s]["loss"])
               for a, b in zip(got, want) for s in ("train", "val"))


def state_gap(got, want, moments=None, keys=None):
    """The float tensor (parameter, BN statistic; of ``keys`` if given)
    farthest from ``want``: (its largest |Δ| over its largest |entry|,
    its name, its entries over 1e-4 of that, and, given ``moments``
    ({name: the one-process run's Adam (m, √v)}), at those entries the
    largest √v over the tensor's largest and the largest |m|/√v over the
    tensor's median |m|/√v). Integer buffers must be equal."""
    worst = (0.0, None, 0, None)
    for k, v in want.items():
        if keys is not None and k not in keys:
            continue
        if not v.is_floating_point():
            if not torch.equal(got[k], v):
                raise SystemExit(f"{k} differs")
            continue
        d = (got[k].double() - v.double()).abs()
        top = v.double().abs().max().clamp(min=1e-30)
        gap = float(d.max() / top)
        if gap > worst[0]:
            over = d > 1e-4 * top
            adam = None
            if moments is not None and k in moments and over.any():
                m, sv = moments[k]
                ratio = m.abs() / sv.clamp(min=1e-30)
                adam = {"sqrt_v": float(sv[over].max() / sv.max().clamp(min=1e-30)),
                        "m_over_sqrt_v": float(ratio[over].max()
                                               / ratio.median().clamp(min=1e-30))}
            worst = (gap, k, int(over.sum()), adam)
    return worst


def rel_l2(a, b):
    """‖a − b‖ / ‖b‖ over every tensor of ``b``."""
    return (sum(float((a[n].double() - b[n].double()).square().sum()) for n in b)
            / sum(float(b[n].double().square().sum()) for n in b)) ** 0.5


def step_gaps(got, want, lr, adam):
    """One first step on two ranks against one process: the largest
    gradient gap over its tensor's largest entry, and the largest excess
    of a parameter's gap over the step's rounding bound (Adam's first
    step lr·g/(|g| + eps) moves at most lr·|Δg|/eps; SGD's lr·|Δg|),
    + 4 ulp of max(|p|, lr)."""
    (ga, pa, _), (gb, pb, _) = got, want
    grad = max(float((ga[n] - gb[n]).abs().max() / gb[n].abs().max().clamp(min=1e-30))
               for n in gb)
    excess = -float("inf")
    for n in gb:
        slope = lr / 1e-8 if adam else lr
        ulp = 4 * torch.maximum(pb[n].abs(), torch.tensor(lr)) * 2.0 ** -23
        bound = slope * (ga[n] - gb[n]).abs() + ulp
        excess = max(excess, float(((pa[n] - pb[n]).abs() - bound).max()))
    return grad, excess


def dp_phase(dev, root, card, refs):
    """Phase 17: cli.train --distributed. (a) NCCL at world size 1 on
    bg_train.yaml against phase 16's run; (b) two gloo ranks on the one
    card for each shipped training config against the one-process runs
    of phases 15 and 16, bg resumed; (c) rank 0's bg best_model served
    through K2; (d) the collectives and ms of a two-rank bg step."""
    import pickle

    ts0 = time.perf_counter()
    stores = os.path.join(root, "dp_stores.pkl")
    with open(stores, "wb") as f:
        pickle.dump({"odom": refs["odom_store"], "fg": refs["fg_store"],
                     "bg": refs["bg_store"]}, f)
    data, steps = refs["bg_data"], ("training.steps_per_epoch", BG_STEPS)

    def wd(name):
        return os.path.join(root, f"dp_{name}")

    def bg_job(name, epochs, *extra):
        return {"name": name, "wd": wd(name), "store": "bg", "argv": bg_train_argv(
            wd(name), data, steps, ("training.num_epochs", epochs)) + list(extra)}

    # (a) NCCL, world size 1, torchrun's environment
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()),
           "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME", "lo")}
    (nccl,) = dp_launch({"stores": stores, "jobs": [bg_job("nccl", 2)]}, root, "nccl", 1,
                        env, 240)
    nccl = nccl["nccl"]
    history, _, best = refs["bg"]
    got_best = torch.load(os.path.join(wd("nccl"), ckpt.BEST), map_location="cpu",
                          weights_only=True)
    nccl_equal = (nccl["history"] == history and sorted(got_best) == sorted(best)
                  and all(torch.equal(got_best[k], best[k]) for k in best))
    print(f"[dp] (a) cli.train --distributed, backend {nccl['backend']}, world "
          f"{nccl['world']}: bg 2 epochs of {BG_STEPS} steps in {nccl['secs']:.1f} s, losses "
          f"and best_model bit-equal to phase 16's run (its steps replayed from graphs "
          f"after the first, these eager): {nccl_equal}; step graphs "
          f"{json.dumps(nccl['graph'])}; launches "
          f"{json.dumps(nccl['launches'])}")
    failures = []  # every reading is printed before the phase fails
    if nccl["graph"]["eager"]["ranks"] != nccl["graph"]["steps"]:
        failures.append(f"the NCCL run replayed steps: {nccl['graph']}")
    if nccl["backend"] != "nccl" or nccl["world"] != 1 or not nccl_equal:
        failures.append("the NCCL run at world size 1 is not phase 16's run")
    if any(nccl["launches"].values()):
        failures.append(f"bg training under NCCL launched a kernel: {nccl['launches']}")

    # (b) two gloo ranks on the one card
    odom_steps = (("training.steps_per_epoch", ODOM_STEPS), ("training.num_epochs", 2))
    fg_steps = (("training.steps_per_epoch", 10), ("training.num_epochs", 2))
    jobs = [{"name": "odom", "wd": wd("odom"), "store": "odom",
             "argv": train_argv("odom", wd("odom"), refs["odom_dir"], *odom_steps)},
            {"name": "fg", "wd": wd("fg"), "store": "fg",
             "argv": train_argv("fg", wd("fg"), refs["fg_dir"], *fg_steps)},
            bg_job("bg", 2), dict(bg_job("bg", 3, "--continue_training"), name="bg_resumed"),
            bg_job("bg_straight", 3)]
    env = {"GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
    first_steps = {"odom": jobs[0]["argv"], "fg": jobs[1]["argv"], "bg": jobs[2]["argv"]}
    spec = {"stores": stores, "jobs": jobs, "addr": f"127.0.0.1:{free_port()}",
            "first_steps": first_steps, "measure": bg_train_argv(wd("measure"), data, steps)}
    r0, r1 = dp_launch(spec, root, "gloo", 2, env, 480)
    gaps, one_store = {}, {"odom": refs["odom_store"], "fg": refs["fg_store"],
                           "bg": refs["bg_store"]}
    for name, want in (("odom", refs["odom"]), ("fg", refs["fg"]), ("bg", refs["bg"])):
        a, b = r0[name], r1[name]
        same = a["history"] == b["history"] and all(
            torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
        finite = all(np.isfinite(h[s]["loss"]) for h in a["history"] for s in ("train", "val"))
        state, worst, over, adam = state_gap(a["state"], want[1], refs["adam"].get(name))
        two32 = r0[f"first_step_{name}_{torch.float32}"]
        one32 = first_step(first_steps[name], one_store[name])
        step_grad, step_excess = step_gaps(two32, one32, two32[2], adam=name != "bg")
        g = gaps[name] = {
            "loss": loss_gaps(a["history"], want[0]), "state": state, "worst": worst,
            "entries_over": over, "adam": adam, "ranks_equal": same, "steps": a["step"],
            "secs": a["secs"], "first_step_grad": step_grad,
            "first_step_excess": step_excess}
        print(f"[dp] (b) {name} over two gloo ranks ({a['step']} steps in {a['secs']:.1f} "
              f"s): epoch losses {g['loss']:.3e} apart relative from one process, "
              f"parameters and statistics {state:.3e} of their tensor's largest entry "
              f"(worst {worst}: {over} entries over 1e-4, there Adam's {adam}); ranks "
              f"equal {same}; one first step on the card: gradients {step_grad:.3e} of "
              f"their tensor's largest entry apart, parameters {step_excess:.3e} over "
              f"the step's rounding bound")
        if not (same and finite):
            failures.append(f"{name}: the ranks disagree or a loss is not finite")
        if name not in FLOAT64_HELD:
            if not (g["loss"] < 1e-4 and state < 1e-4):
                failures.append(f"{name}: two ranks are not the one-process run")
            continue
        # Held to a float64 step (PERF.md, §6): the same first step in
        # float64 on two ranks and in one process must agree to float64
        # rounding, and the two-rank f32 step must be no farther from the
        # float64 step than the one-process f32 step is (twice, + a floor),
        # as phase 16 holds the card to the CPU
        two64 = r0[f"first_step_{name}_{torch.float64}"]
        one64 = first_step(first_steps[name], one_store[name], dtype=torch.float64)
        stats = [k for k in one64[1] if "running" in k]
        exact = max(step_gaps(two64, one64, one64[2], adam=name != "bg")[0],
                    state_gap(two64[1], one64[1], keys=stats)[0])
        l2 = {"two_f32": rel_l2(two32[0], one64[0]), "one_f32": rel_l2(one32[0], one64[0])}
        st = {"two_f32": state_gap(two32[1], one64[1], keys=stats)[0],
              "one_f32": state_gap(one32[1], one64[1], keys=stats)[0]}
        excess = max(l2["two_f32"] - (2 * l2["one_f32"] + 1e-3),
                     st["two_f32"] - (2 * st["one_f32"] + 1e-5))
        g.update(float64_two_vs_one=exact, grad_l2_from_f64=l2, stats_from_f64=st,
                 float64_excess=excess)
        print(f"[dp] (b) {name} first step in float64: two ranks against one process "
              f"{exact:.3e} of a tensor's largest entry (gradients"
              f"{', BN statistics' if stats else ''}; limit 1e-6); in f32, gradients "
              f"{l2['two_f32']:.3e} (two ranks) and {l2['one_f32']:.3e} (one process) "
              f"relative L2 from the float64 step, statistics {st['two_f32']:.3e} and "
              f"{st['one_f32']:.3e}; two ranks {excess:.3e} over twice one process's "
              f"+ 1e-3 / 1e-5 (limit 0)")
        if not (exact < 1e-6 and excess <= 0):
            failures.append(f"{name}: the two-rank step is not the one-process step")
        if name == "fg" and not g["loss"] < 1e-4:
            failures.append("fg: the two-rank epoch losses are not the one-process ones")
    resume_gap = loss_gaps(r0["bg_resumed"]["history"], r0["bg_straight"]["history"][2:])
    print(f"[dp] (b) bg epoch 3 resumed on two ranks against a straight two-rank run: "
          f"losses {resume_gap:.3e} apart relative (limit 1e-3)")
    if [h["epoch"] for h in r0["bg_resumed"]["history"]] != [3] or not resume_gap < 1e-3:
        failures.append("the resumed two-rank bg epoch differs from the straight run's")
    writes = {name: r1[name]["writes"] for name in r1
              if name != "measure" and not name.startswith("first_step")}
    missing = {j["name"]: [f for f in DP_FILES if not os.path.isfile(os.path.join(j["wd"], f))]
               for j in jobs}
    launches = {name: {r: res[name]["launches"] for r, res in enumerate((r0, r1))}
                for name in writes}
    print(f"[dp] (b) rank 1 wrote under the working dirs: {json.dumps(writes)}; rank 0's "
          f"files missing: {json.dumps(missing)}; kernel launches of both ranks: "
          f"{json.dumps({k: sum(sum(r.values()) for r in v.values()) for k, v in launches.items()})}")
    if any(writes.values()) or any(missing.values()):
        failures.append("rank 1 wrote a file, or rank 0 did not write its files")
    graphs = {name: {r: res[name]["graph"] for r, res in enumerate((r0, r1))}
              for name in writes}
    print(f"[dp] (b) step graphs (a process group: every step eager): "
          f"{json.dumps(graphs)}")
    if any(c["eager"]["ranks"] != c["steps"] or not c["steps"]
           for run in graphs.values() for c in run.values()):
        failures.append("a two-rank run replayed steps")
    if any(v for run in launches.values() for r in run.values() for v in r.values()):
        failures.append("two-rank training launched a kernel of the port")

    # (c) rank 0's trained bg weights served through K2, against phase 16's
    k2, batches, frames, ms, differ, near_tie, pixels, apart, apart_tie = serve_trained(
        wd("bg"), data, refs["bg_store"], dev,
        other=canvases(os.path.join(refs["bg_wd"], "bg_trained")))
    print(f"[dp] (c) two-rank bg best_model served: launches {json.dumps(k2)} for "
          f"{batches} bg batches; class maps against its unfolded eval graph: {differ} of "
          f"{pixels} pixels differ, {near_tie} of them at top-2 logit gaps < 1e-3; "
          f"{apart} pixels unlike the one-process checkpoint's export ({apart_tie} at "
          f"such gaps: bg is held to a float64 step, its f32 runs drift apart)")
    if k2["onehot_stem_conv"] != batches or sum(k2.values()) != batches:
        failures.append(f"serving the two-rank bg weights launched {k2}")
    if not differ < 1e-3 * pixels or differ > near_tie:
        failures.append("the served two-rank maps differ from its unfolded graph's")

    # (d) readings
    m = r0["measure"]
    c = m["collectives"]
    print(f"[dp] (d) bg step on rank 0 of two gloo ranks sharing one card (no scaling "
          f"figure: both ranks compute on the same card), {m['rows']} rows a rank: "
          f"{m['step_ms_median']:.2f} ms median ({m['step_ms_min']:.2f}-"
          f"{m['step_ms_max']:.2f}); all-reduces a step: BN forward "
          f"{c['bn_forward']['calls']} ({c['bn_forward']['bytes']} B), valid count "
          f"{c['valid_count']['calls']}, BN backward {c['bn_backward']['calls']} "
          f"({c['bn_backward']['bytes']} B), gradient {c['gradient']['calls']} "
          f"({m['gradient_floats']} f32, {c['gradient']['bytes']} B); with each "
          f"synchronised and timed the step takes {m['counted_step_ms_median']:.2f} ms, "
          f"{m['collective_ms_median']:.2f} of them inside the all-reduces "
          f"(BN forward {c['bn_forward']['ms_median']:.2f}, backward "
          f"{c['bn_backward']['ms_median']:.2f}, gradient {c['gradient']['ms_median']:.2f})"
          f" | {card}")
    if not m["sharded"] or not m["calls_same_every_step"]:
        failures.append("the measured bg steps were not sharded alike")
    phase_s = time.perf_counter() - ts0
    readings = {"nccl": {"backend": nccl["backend"], "bit_equal": nccl_equal,
                         "secs": nccl["secs"], "graph": nccl["graph"]}, "graph": graphs,
                "gaps": gaps, "resume_loss_gap": resume_gap,
                "serve": {"launches": k2, "batches": batches, "pixels": pixels,
                          "pixels_apart": apart, "near_tie": apart_tie},
                "bg_step": {"rank0": m, "rank1": r1["measure"]}, "card": card,
                "phase_s": phase_s}
    print(f"[dp] phase 17 took {phase_s:.1f} s")
    if failures:
        raise SystemExit("phase 17: " + "; ".join(failures))
    return readings


# ---- 18. bf16 and the model options ---------------------------------------------

BF16 = {"compute_dtype": "bfloat16"}
BF16_SET = ("model.compute_dtype", "bfloat16")
# The bf16 step's bg class map may differ from the f32 step's (same
# weights) on at most this share of pixels: bf16 flips near-ties.
BF16_MAP_SHARE = 0.98
BF16_MARGIN = 0.05  # top-2 logit gap under which bf16 maps may differ
BF16_STEPS = 7  # fixed-batch bf16 training steps, the first 3 untimed
# {option: (fg model keys, top-level keys, bg model keys)}
OPTIONS = {
    "lstm": ({"rnn_type": "lstm"}, {}, {}),
    "only_loc_feats": ({"only_loc_feats": True}, {}, {}),
    "no_traj_inst_feats": ({"no_traj_inst_feats": True}, {}, {}),
    "no_mask_traj_feats": ({"no_mask_traj_feats": True}, {}, {}),
    "only_input_odometry": ({"only_input_odometry": True}, {}, {}),
    "use_bbox_ulbr": ({}, {"use_bbox_ulbr": True}, {}),
    "convert2onehot_false": ({}, {}, {"convert2onehot": False}),
}


def ulbr_stats(width: int):
    """``fg_stats`` with the box means as corners (x0, y0, x1, y1)."""
    stats = fg_stats(width)
    mean, std = stats["traj"]
    c, s = mean[:4], std[:4]
    corners = np.array([c[0] - c[2] / 2, c[1] - c[3] / 2, c[0] + c[2] / 2,
                        c[1] + c[3] / 2])
    return dict(stats, traj=(np.concatenate([corners, mean[4:]]),
                             np.concatenate([s[:2] + s[2:] / 2, s[:2] + s[2:] / 2, std[4:]])))


def config_models(device, height, width, bg_keys=None, fg_keys=None, top=None):
    """The serving bg (folded) and fg models of configs/bg/bg_val_short.yaml
    and configs/fg/fg_val_short.yaml with ``model.*`` keys set (as ``--set``
    sets them), the bg output at height x width, weights from SEED as
    ``make_models`` seeds them."""
    bg_cfg = conf("bg", "bg_val_short.yaml")
    bg_cfg["model"].update(final_h=height, final_w=width, **(bg_keys or {}))
    bg_cfg["data"]["num_classes"] = 11  # the bg data card's
    fg_cfg = conf("fg", "fg_val_short.yaml")
    fg_cfg["model"].update(fg_keys or {})
    fg_cfg.update(top or {})
    bg = seeded_init_(BGModel(bg_cfg, depth_stats=DEPTH_STATS, device="cpu"), SEED)
    stats = ulbr_stats(width) if fg_cfg.get("use_bbox_ulbr") else fg_stats(width)
    fg = seeded_init_(FGModel(fg_cfg, stats=stats, device="cpu"), SEED + 1)
    return bg.maybe_fold().to(device), fg.to(device)


def device_inputs(pc_in, fg_in, dev):
    pc_dev = {k: torch.as_tensor(v).to(dev) if k in ("seg", "depth", "depth_mask")
              else torch.as_tensor(v) for k, v in pc_in.items()}
    return pc_dev, {k: torch.as_tensor(v).to(dev) for k, v in fg_in.items()}


def k2_bf16_edge_cases(dev):
    """K2's bf16 entry equal, bit for bit, to its f32 entry's output
    rounded to bf16 on the edge shapes of ``edge_cases``."""
    g = torch.Generator().manual_seed(SEED + 18)
    for b, t, h, w, c, depth in ((2, 3, 34, 66, 11, True), (1, 3, 20, 30, 11, False),
                                 (1, 3, 46, 72, 11, True), (1, 3, 2, 64, 11, True),
                                 (1, 3, 20, 64, 40, True), (1, 3, 18, 134, 11, True)):
        seg = torch.randint(-2, c + 3, (b, t, h, w), generator=g, dtype=torch.int32)
        dep = torch.randn(b, t, h, w, generator=g) if depth else None
        kern = torch.randn(3, 3, t * c + (t if depth else 0), 16, generator=g) * 0.2
        bias = torch.randn(16, generator=g)
        args = [x.to(dev) if x is not None else None for x in (seg, dep, kern, bias)]
        k16 = onehot_stem_conv(*args, num_classes=c, out_dtype=torch.bfloat16)
        k32 = onehot_stem_conv(*args, num_classes=c).to(torch.bfloat16)
        if not torch.equal(k16.view(torch.int16), k32.view(torch.int16)):
            raise SystemExit(f"K2 bf16 differs from the f32 kernel rounded at "
                             f"{(b, t, h, w, c, depth)}")


def bf16_step_phase(dev, card):
    """(a) the bf16 forecast step at full width, counted, against the same
    weights' f32 step; K2's bf16 entry against its f32 entry; (b) the bf16
    step's models on the card against the CPU's bf16 port at 256x512."""
    pc_in, fg_in = make_inputs(H, W)
    models = {"f32": config_models(dev, H, W),
              "bf16": config_models(dev, H, W, BF16, BF16)}
    bg16, fg16 = models["bf16"]
    if (bg16.model.dtype != torch.bfloat16
            or {p.dtype for m in models["bf16"] for p in m.parameters()} != {torch.float32}):
        raise SystemExit("the bf16 config did not build bf16 compute over f32 parameters")
    seg, dep, kern, bias = k2_inputs(bg16, pc_in, dev)
    k16 = onehot_stem_conv(seg, dep, kern, bias, num_classes=11, out_dtype=torch.bfloat16)
    k32 = onehot_stem_conv(seg, dep, kern, bias, num_classes=11)
    plain16 = onehot_stem_conv_plain(seg, dep, kern, bias, num_classes=11).to(torch.bfloat16)
    torch.cuda.synchronize()
    bit_equal = torch.equal(k16.view(torch.int16), k32.to(torch.bfloat16).view(torch.int16))
    err = float((k16.float() - plain16.float()).abs().max())
    k2_bf16_edge_cases(dev)
    print(f"[bf16] K2 bf16 entry {tuple(k16.shape)}: bit-equal to the f32 kernel's "
          f"output rounded to bf16: {bit_equal} (and on 6 edge shapes); against the "
          f"plain version rounded: max abs diff {err:.3e}")
    if not bit_equal:
        raise SystemExit("K2's bf16 entry is not the f32 kernel rounded to bf16")

    steps = {k: build_forecast_step(bg, fg, height=H, width=W, out_t=OUT_T)
             for k, (bg, fg) in models.items()}
    out32 = steps["f32"](pc_in, fg_in)
    reset_counts()
    onehot_stem_conv.bf16_launches = 0
    out16 = steps["bf16"](pc_in, fg_in)
    torch.cuda.synchronize()
    launches = dict(read_counts(), onehot_stem_conv_bf16=onehot_stem_conv.bf16_launches)
    print(f"[bf16] step {H}x{W}: launches {launches}")
    if (launches["place_min_fold"], launches["onehot_stem_conv"],
            launches["onehot_stem_conv_bf16"], launches["place_min"]) != (1, 1, 1, 0):
        raise SystemExit(f"the bf16 step did not launch K1 once and K2's bf16 entry "
                         f"once: {launches}")
    painted = check_output(out16, H, W)
    bg_share = float((out16["bg_seg"] == out32["bg_seg"]).float().mean())
    pan_share = float((out16["panoptic"] == out32["panoptic"]).float().mean())
    pc_dev, fg_dev = device_inputs(pc_in, fg_in, dev)
    timing = {}
    for k, step in steps.items():
        ms = time_ms(lambda: step(pc_dev, fg_dev), 10, 2)
        busy = device_ms(lambda: step(pc_dev, fg_dev), 5)
        timing[k] = {"ms": ms, "busy_ms": busy, "busy_share": busy / ms}
    print(f"[bf16] class maps of the bf16 step against the f32 step (same weights): "
          f"bg {bg_share:.5f}, panoptic {pan_share:.5f} of pixels equal (limit bg >= "
          f"{BF16_MAP_SHARE}); {painted:.3f} of pixels in instances")
    for k, t in timing.items():
        print(f"[bf16] {k} step {H}x{W} (device-resident inputs): {t['ms']:.2f} ms "
              f"(CUDA events), device busy {t['busy_ms']:.2f} ms, busy share "
              f"{t['busy_share']:.3f} | {card}")
    if not bg_share >= BF16_MAP_SHARE:
        raise SystemExit("the bf16 step's class map is too far from the f32 step's")

    # (b) the card's bf16 port against the CPU's at 256x512
    pc_s, fg_s = make_inputs(H_SMALL, W_SMALL)
    res = {}
    for name, d, keys in (("cuda16", dev, BF16), ("cpu16", torch.device("cpu"), BF16),
                          ("cpu32", torch.device("cpu"), None)):
        bg, fg = config_models(d, H_SMALL, W_SMALL, keys, keys)
        pc_d, fg_d = device_inputs(pc_s, fg_s, d)
        rep = pc_transform_predict(*pc_args(pc_d, d), height=H_SMALL, width=W_SMALL)
        rd = rep["depth"].reshape(1, T_IN, H_SMALL, W_SMALL)
        bg_in = {"seg": rep["seg"].reshape(1, T_IN, H_SMALL, W_SMALL),
                 "depth": rd.clamp(min=0.0), "depth_mask": rd > 0}
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in fg_d.items()
                if k != "valid"}
        out = build_forecast_step(bg, fg, height=H_SMALL, width=W_SMALL, out_t=OUT_T,
                                  device=d)(pc_s, fg_s)
        res[name] = (bg(bg_in), fg(flat, OUT_T), out)
    gaps = {}
    (lg, fgg, og), (lc, fgc, oc), (l32, fg32, _) = res["cuda16"], res["cpu16"], res["cpu32"]
    for key, (a, b, c) in {"bg_logits": (lg, lc, l32), **{
            k: (fgg[k], fgc[k], fg32[k])
            for k in ("unnormalized_trajectory", "masks", "mask_feats")}}.items():
        gaps[key] = (rel_l2({0: a.cpu()}, {0: b}), rel_l2({0: b}, {0: c}))
    top2 = lc.topk(2, 1).values
    clear = (top2[:, 0] - top2[:, 1]) >= BF16_MARGIN
    map_differ = int(((lg.argmax(1).cpu() != lc.argmax(1)) & clear).sum())
    ids_equal = torch.equal(og["ids"].cpu(), oc["ids"])
    # the maps by the same yardstick: the card's bf16 no farther from the
    # CPU's bf16 than that is from the CPU's f32 (bf16 moves mask
    # thresholds and box edges)
    pan_mis = (float((og["panoptic"].cpu() != oc["panoptic"]).float().mean()),
               float((oc["panoptic"] != res["cpu32"][2]["panoptic"]).float().mean()))
    print(f"[bf16] {H_SMALL}x{W_SMALL} card bf16 against CPU bf16 (relative L2), beside "
          f"CPU bf16 against CPU f32: " + ", ".join(
              f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in gaps.items())
          + f"; bg class maps differ off top-2 gaps < {BF16_MARGIN} on {map_differ} "
          f"pixels; step ids equal {ids_equal}, panoptic maps differ on "
          f"{pan_mis[0]:.3e} / {pan_mis[1]:.3e} of pixels")
    if (any(a > b for a, b in gaps.values()) or map_differ or not ids_equal
            or pan_mis[0] > pan_mis[1]):
        raise SystemExit("the bf16 port on the card and on the CPU disagree")
    times = {"k2_bf16": time_ms(lambda: onehot_stem_conv(
        seg, dep, kern, bias, num_classes=11, out_dtype=torch.bfloat16)),
        "k2_bf16_plain": time_ms(lambda: onehot_stem_conv_plain(
            seg, dep, kern, bias, num_classes=11).to(torch.bfloat16))}
    x_onehot = torch.cat([assemble_onehot(seg, 11), dep], 1)
    w_oihw = kern.permute(3, 2, 0, 1).contiguous()
    times["k2_bf16_lib"] = time_ms(lambda: F.conv2d(
        x_onehot, w_oihw, bias, stride=2, padding=1).to(torch.bfloat16))
    times["k2_bf16_device"] = device_ms(lambda: onehot_stem_conv(
        seg, dep, kern, bias, num_classes=11, out_dtype=torch.bfloat16), per_call=1)
    times["k2_f32_device"] = device_ms(lambda: onehot_stem_conv(
        seg, dep, kern, bias, num_classes=11), per_call=1)
    print("[bf16] K2 ms " + json.dumps({k: round(v, 4) for k, v in times.items()})
          + f" | {card}")
    nbytes = (seg.numel() * 4 + dep.numel() * 4 + kern.numel() * 4 + bias.numel() * 4
              + k16.numel() * 2)
    bound, by = bound_ms(nbytes, k2_flops(seg, 11))
    entry = {"name": "onehot_stem_conv_bf16", "route": "cuda",
             "source": "panoptic_forecasting_tpu_torch/csrc/stem.cu",
             "replaces": "panoptic_forecasting_tpu/kernels/stem.py:180",
             "launches": launches["onehot_stem_conv_bf16"], "max_abs_err": err,
             "ms": times["k2_bf16"], "plain_ms": times["k2_bf16_plain"],
             "bound_ms": bound, "bound_by": by, "library_ms": times["k2_bf16_lib"],
             "device_ms": times["k2_bf16_device"],
             "f32_entry_device_ms": times["k2_f32_device"],
             "note": "K2's bf16 epilogue (the network runs in bf16): equal, bit for "
                     "bit, to the f32 entry's output rounded to bf16; max_abs_err "
                     "against the plain version rounded to bf16 (f32 sums in another "
                     "order, then a rounding); launches in phase 18's bf16 step"}
    readings = {"launches": launches, "bg_share": bg_share, "panoptic_share": pan_share,
                "timing": timing, "small_gaps": gaps, "small_map_differ": map_differ,
                "small_panoptic_mismatch": pan_mis}
    return entry, readings


def narrow_fg_grads(root, dev, tag, runs):
    """One fg loss and backward from the same seeded weights and batch at
    narrow widths for each of ``runs`` ({name: (device, sets)}): {name:
    (loss, {parameter: gradient})} on the CPU."""
    fg = os.path.join(root, f"fg_{tag}")
    store = synthetic.write_fg_fixture(fg, n_scenes=3, max_instances=3, seed=SEED,
                                       feat_channels=32, feat_hw=7)
    out = {}
    for name, (d, sets) in runs.items():
        argv = train_argv("fg", os.path.join(root, f"{tag}_{name}"), fg,
                          ("platform", d.type), *NARROW_FG, *sets)
        with store_readers(store):
            cfg, data, model = setup(load_config(argv))
            batch = next(iter(data.loader("train", cfg, seed=SEED)))
        init_weights(model, SEED)
        model.train()
        loss, _ = model.loss(to_device(batch, d))
        loss.backward()
        out[name] = (float(loss.detach()), {n: p.grad.detach().cpu() for n, p in
                                            model.named_parameters() if p.grad is not None})
    return out


def bf16_train_phase(dev, root, card, refs, f32_steps):
    """(c) fg_train.yaml and bg_train.yaml with model.compute_dtype
    bfloat16: fixed-batch steps on the card beside phases 15-16's f32
    steps; one narrow fg step on the card against the CPU's bf16 step."""
    fg_argv = train_argv("fg", os.path.join(root, "fg_bf16"), refs["fg_dir"],
                         ("training.steps_per_epoch", 10), BF16_SET)
    bg_argv = bg_train_argv(os.path.join(root, "bg_bf16"), refs["bg_data"],
                            ("training.steps_per_epoch", BG_STEPS), BF16_SET)
    # bg's operations are phase 16's (the same graph): not counted again
    steps = {"fg": train_steps(fg_argv, refs["fg_store"], dev, steps=BF16_STEPS),
             "bg": train_steps(bg_argv, refs["bg_store"], dev, steps=BF16_STEPS)}
    for kind, r in steps.items():
        f = f32_steps[kind]
        print(f"[bf16] {kind} train step, batch {r['batch']}, bf16: median "
              f"{r['ms_median']:.2f} ms (f32 {f['ms_median']:.2f}), {r['samples_per_s']:.1f} "
              f"samples/s (f32 {f['samples_per_s']:.1f}), peak {r['peak_gib']:.2f} GiB "
              f"(f32 {f['peak_gib']:.2f}), device busy {r['busy_ms']:.2f} ms (f32 "
              f"{f['busy_ms']:.2f}), loss {r['loss_first']:.5f} -> {r['loss_last']:.5f} "
              f"over {BF16_STEPS} steps on one batch | {card}")
        if not r["losses_finite"] or not r["loss_last"] < r["loss_first"]:
            raise SystemExit(f"bf16 {kind} training: losses not finite and falling")
    cpu = torch.device("cpu")
    g = narrow_fg_grads(root, dev, "narrow_bf16", {
        "cuda16": (dev, (BF16_SET,)), "cpu16": (cpu, (BF16_SET,)), "cpu32": (cpu, ())})
    (lg, gg), (lc, gc), (l32, g32) = g["cuda16"], g["cpu16"], g["cpu32"]
    weights = [n for n in gc if not n.endswith("bias")]
    gg, gc, g32 = ({n: g[n] for n in weights} for g in (gg, gc, g32))
    loss_gap = (abs(lg - lc), abs(lc - l32))
    grad_gap = (rel_l2(gg, gc), rel_l2(gc, g32))
    print(f"[bf16] one narrow fg step, card bf16 against CPU bf16 beside CPU bf16 "
          f"against CPU f32: loss {loss_gap[0]:.3e} / {loss_gap[1]:.3e}, weight "
          f"gradients (relative L2) {grad_gap[0]:.3e} / {grad_gap[1]:.3e}")
    if loss_gap[0] > loss_gap[1] or grad_gap[0] > grad_gap[1]:
        raise SystemExit("the bf16 fg step on the card and on the CPU disagree")
    return {"steps": steps, "narrow_loss_gap": loss_gap, "narrow_grad_gap": grad_gap}


def option_cli_cfg(cfg, root, name, width):
    """phase 12's CLI config under option ``name``: the option's keys in
    the fg config, seeded fg weights of that model in a reference-format
    ``.pt`` (ulbr box statistics under ``use_bbox_ulbr``), and for a bg
    option a seeded bg checkpoint of that bg config."""
    fg_keys, top, bg_keys = OPTIONS[name]
    out = copy.deepcopy(dict(cfg))
    out["model"] = dict(out["model"], **fg_keys)
    out.update(top)
    stats = ulbr_stats(width) if top.get("use_bbox_ulbr") else fg_stats(width)
    os.makedirs(root, exist_ok=True)
    pt = os.path.join(root, f"fg_{name}.pt")
    torch.save(seeded_init_(FGModel(out, stats=stats, device="cpu"),
                            SEED + 1).state_dict(), pt)
    out["load_torch_model"] = pt
    if bg_keys:
        bg = read_yaml(out["fused"]["bg_config"])
        bg["model"].update(bg_keys)
        bg_dir = os.path.join(root, f"bg_{name}")
        ckpt.save_model(bg_dir, seeded_init_(build_model(
            bg, build_dataset(bg, test=True).card, "cpu"), SEED), best=True)
        out["fused"] = dict(out["fused"], bg_config=dump(
            os.path.join(root, f"bg_{name}.yaml"), bg), bg_dir=bg_dir)
    return out


def options_phase(dev, root, fixtures, refs):
    """(d) each model option through cli.forecast_fused on phase 12's
    256x512 fixture on the card, counted (K1 and K2 once per frame; no K2
    for raw ids), against the same on the CPU; one short cli.train of
    fg_train.yaml with the LSTM and its narrow step against the CPU."""
    small, store, _ = fixtures["small"]
    readings = {}
    for name in OPTIONS:
        cfg = option_cli_cfg(small, os.path.join(root, "options"), name, W_SMALL)
        reset_counts()
        report = run_cli(cfg, store, "cuda", f"opt_{name}_cuda")
        torch.cuda.synchronize()
        launches = read_counts()
        cpu_report = run_cli(cfg, store, "cpu", f"opt_{name}_cpu")
        got, want = cli_outputs(report)[0], cli_outputs(cpu_report)[0]
        frames = report["frames"]
        k2_want = 0 if name == "convert2onehot_false" else frames
        worst = max(float((got[k] != want[k]).mean()) for k in want)
        ids = all(set(np.unique(got[k])) == set(np.unique(want[k])) for k in want)
        readings[name] = {"frames": frames, "launches": launches, "worst": worst,
                          "ids_equal": ids, "thing_pixels": thing_pixels(got)}
        print(f"[options] {name}: {frames} frames at {H_SMALL}x{W_SMALL}, launches "
              f"{launches}; card against CPU: ids equal {ids}, worst panoptic "
              f"mismatch {worst:.3e}, {thing_pixels(got)} pixels in instances")
        if (launches["place_min_fold"] != frames or launches["place_min"]
                or launches["onehot_stem_conv"] != k2_want):
            raise SystemExit(f"option {name}: launches {launches}, not K1 per frame "
                             f"and K2 {k2_want} times")
        if not frames or not ids or not worst < 1e-3:
            raise SystemExit(f"option {name}: the card and the CPU disagree")

    argv = train_argv("fg", os.path.join(root, "fg_lstm"), refs["fg_dir"],
                      ("training.steps_per_epoch", 4), ("training.num_epochs", 1),
                      ("model.rnn_type", "lstm"))
    result, launches, secs = train_cli_run(argv, refs["fg_store"])
    model = result["model"]
    frozen = all(not c.bias_ih_l0.any() for c in (model.traj_encoder, model.traj_decoder))
    step_losses, rel, grad_rel, excess = one_step_gpu_cpu(
        root, dev, ("model.rnn_type", "lstm"), tag="narrow_lstm")
    print(f"[options] cli.train fg_train.yaml with the LSTM: {result['step']} steps in "
          f"{secs:.1f} s, launches {launches}, bias_ih_l0 still 0: {frozen}; one narrow "
          f"LSTM step, card against CPU: losses {step_losses['cuda']!r} / "
          f"{step_losses['cpu']!r} ({rel:.3e}, limit 1e-4), gradients at most "
          f"{grad_rel:.3e} of their tensor's largest entry apart, parameters "
          f"{excess:.3e} over lr·|Δg|/eps + 4 ulp (limit 0)")
    if result["step"] != 4 or not frozen or any(launches.values()):
        raise SystemExit("the LSTM fg training run failed its checks")
    if not rel < 1e-4 or excess > 0:
        raise SystemExit("the LSTM fg step on the card and on the CPU disagree")
    readings["lstm_train"] = {"steps": result["step"], "s": secs, "gpu_cpu_loss_rel": rel,
                              "gpu_cpu_grad_rel": grad_rel, "gpu_cpu_param_excess": excess}
    return readings


def bf16_phase(dev, root, card, fixtures, refs, train_readings):
    """Phase 18: bf16 and the model options (see the module doc)."""
    ts0 = time.perf_counter()
    entry, readings = bf16_step_phase(dev, card)
    ts1 = time.perf_counter()
    f32_steps = {"fg": train_readings["steps"]["fg"], "bg": train_readings["bg"]["step"]}
    readings["train"] = bf16_train_phase(dev, root, card, refs, f32_steps)
    ts2 = time.perf_counter()
    readings["options"] = options_phase(dev, root, fixtures, refs)
    ts3 = time.perf_counter()
    readings["part_s"] = {"ab": ts1 - ts0, "c": ts2 - ts1, "d": ts3 - ts2}
    readings["phase_s"] = ts3 - ts0
    print(f"[bf16] phase 18 took {readings['phase_s']:.1f} s (a-b {ts1 - ts0:.1f}, "
          f"c {ts2 - ts1:.1f}, d {ts3 - ts2:.1f})")
    return entry, readings


# ---- 19. the data options -------------------------------------------------------

MONO_SIZE = (192, 640)  # monodepth .npy disparities, below 1024x2048
OPTION_GAP = 9
PC_OPTIONS = {  # name: the pc config's data options ("{disp}": the fixture's dir)
    "cascade": {"use_cascade_disps": True, "disparity_dir": "{disp}"},
    "mono": {"use_mono": True, "disparity_dir": "{disp}"},
    "expand_test": {"expand_test": True},
    "cities": {"cities": [synthetic.CITY]},
}
ODOM_IMG_SNIPPETS = 3
ODOM_IMG_SETS = (("training.batch_size", 8), ("training.steps_per_epoch", 2),
                 ("training.num_epochs", 1))


def option_fixture(root, height, width, mono=True):
    """Phase 19's pc fixture: one snippet at gap 9 with the PNGs of every
    target (``expand_test``: 15), its RGB frames, flat cascade
    disparities and (``mono``) sub-resolution monodepth .npy files under
    ``disp``, predicted odometry for every start. -> (store, {dir: path})."""
    dirs = {d: os.path.join(root, d) for d in ("cs", "disp", "odom")}
    store = synthetic.write_cityscapes_fixture(
        dirs["cs"], "val", n_snippets=1, height=height, width=width, seed=SEED,
        gap_len=OPTION_GAP, all_targets=True, images=True, cascade=True,
        mono_size=MONO_SIZE if mono else None, disparity_dir=dirs["disp"])
    synthetic.write_odom_predictions(
        os.path.join(dirs["odom"], "odometry_val.h5"),
        store["tables"][os.path.join(dirs["cs"], "val_3d_info.pkl")],
        starts=range(6, 30 - OPTION_GAP), seed=SEED, store=store)
    return store, dirs


def option_pc_cfg(dirs, **data):
    """configs/pc_transform/pc_export.yaml on the option fixture, with
    ``data`` options."""
    cfg = conf("pc_transform", "pc_export.yaml")
    cfg["data"].update(cityscapes_dir=dirs["cs"], data_dir=dirs["cs"],
                       seg_dir=os.path.join(dirs["cs"], "seg"), gap_len=OPTION_GAP,
                       odom_pred_dir=dirs["odom"], data_splits=["val"])
    cfg["data"].update({k: (v.format(**dirs) if isinstance(v, str) else v)
                        for k, v in data.items()})
    return cfg


def pc_option_run(cfg, store, root, tag, platform, prepare=True, outputs=None):
    """prepare_bg_data (``prepare``) and the pc export of ``cfg`` on
    ``platform``, each counted, writing under ``root`` (or into the
    ``outputs`` of an earlier run): {cli: (report, launches, seconds)}
    and the output dirs ``wd`` and ``bg_out``."""
    path = dump(os.path.join(root, f"pc_{tag}.yaml"), cfg)
    out = dict(outputs or {"wd": os.path.join(root, f"pc_{tag}"),
                           "bg_out": os.path.join(root, f"bg_{tag}")})
    wd, bg_out = out["wd"], out["bg_out"]
    plat = ["--set", "platform", platform]
    with store_readers(store):
        if prepare:
            out["prepare"] = counted(prepare_bg_data.main, [
                "--working_dir", wd, "--config_file", path, "--set", "bg_out",
                bg_out] + plat)
        out["export"] = counted(export_segmentation.main,
                                ["--working_dir", wd, "--config_file", path] + plat)
    return out


def output_tree(root, store):
    """{path under ``root``: bytes} of every file a run wrote there, an
    h5 file's datasets as ``path:key`` (from the store where h5py is
    missing here)."""
    out = {}
    for p in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
        rel = os.path.relpath(p, root)
        if os.path.isdir(p):
            continue
        if p.endswith(".h5"):
            import h5py

            with h5py.File(p, "r") as h5:
                h5.visititems(lambda k, v: out.__setitem__(
                    f"{rel}:{k}", v[()].tobytes()) if isinstance(v, h5py.Dataset) else None)
            continue
        with open(p, "rb") as f:
            out[rel] = f.read()
    for path, arrays in store["arrays"].items():
        if path.startswith(root + os.sep) and not os.path.exists(path):
            rel = os.path.relpath(path, root)
            out.update({f"{rel}:{k}": np.asarray(v).tobytes() for k, v in arrays.items()})
    return out


def listing(root):
    """(path, size, mtime) of every file under ``root``."""
    return sorted((p, os.path.getsize(p), os.stat(p).st_mtime_ns) for p in glob.glob(
        os.path.join(root, "**", "*"), recursive=True) if not os.path.isdir(p))


def same_outputs(a, b, what):
    if sorted(a) != sorted(b):
        raise SystemExit(f"{what}: the card wrote {sorted(set(a) ^ set(b))[:6]} where "
                         f"the CPU did not, or the reverse")
    differ = [k for k in a if a[k] != b[k]]
    if differ:
        raise SystemExit(f"{what}: card and CPU differ in {len(differ)} of {len(a)} "
                         f"outputs, e.g. {differ[:4]}")
    return len(a)


def launched(counts):
    """The kernels of ``counts`` launched at least once."""
    return {k: v for k, v in counts.items() if v}


def check_option_launches(name, run, items):
    """K1's fold 3x per pc batch in prepare_bg_data, 1x in the export
    (batch 1: per item); the generic place_min never."""
    got = {cli: run[cli][1] for cli in ("prepare", "export") if cli in run}
    want = {"prepare": 3 * items, "export": items}
    for cli, launches in got.items():
        if launches["place_min_fold"] != want[cli] or launches["place_min"]:
            raise SystemExit(f"{name}: {cli} launched {launches}, not place_min_fold "
                             f"{want[cli]} times and place_min never")
    return got


def raw_png(samples, ctype, depth=8, interlace=False, plte=None):
    """(H, W, C) samples -> PNG bytes of colour type ``ctype``, every row
    unfiltered (each Adam7 pass on its own), zlib level 1: the cases the
    port's encoder does not write (palette, interlaced)."""
    import zlib

    def chunk(kind, body):
        return (len(body).to_bytes(4, "big") + kind + body
                + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    h, w, _ = samples.shape
    rows = []
    for y0, x0, dy, dx in (png.ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx].astype(np.uint8)
        if sub.size:
            rows.append(np.concatenate([np.zeros((sub.shape[0], 1), np.uint8),
                                        sub.reshape(sub.shape[0], -1)], 1).tobytes())
    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([depth, ctype, 0, 0, int(interlace)]))
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + (chunk(b"PLTE", plte) if plte is not None else b"")
            + chunk(b"IDAT", zlib.compress(b"".join(rows), 1)) + chunk(b"IEND", b""))


def expand_decode_ms(height, width):
    """Host ms of one decode_png at height x width of an Adam7 label map
    and of a palette label map (Cityscapes' colours), each checked."""
    from panoptic_forecasting_tpu_torch.data.cityscapes import train_id_color_palette

    labels = synthetic.make_scene_sequence(1, height, width)[0][0].astype(np.uint8)
    colours = np.zeros((256, 3), np.uint8)
    pal = train_id_color_palette()
    colours[: len(pal)] = pal[:256]
    cases = {"adam7_labels8": (raw_png(labels[..., None], 0, interlace=True), labels),
             "palette_labels8": (raw_png(labels[..., None], 3, plte=colours.tobytes()),
                                 colours[labels])}
    ms = {}
    for name, (data, want) in cases.items():
        times = []
        for _ in range(3):
            ts = time.perf_counter()
            got = png.decode_png(data)
            times.append((time.perf_counter() - ts) * 1e3)
        if not np.array_equal(got, want):
            raise SystemExit(f"PNG decode of {name} is wrong")
        ms[name] = sorted(times)[1]
    return ms


def cascade_from_stereo(cs, out_dir):
    """Flat cascade disparity PNGs (``disp·256``) of every stereo
    ``disparity_sequence`` PNG (``disp·256 + 1``) of the fixture at ``cs``."""
    paths = glob.glob(os.path.join(cs, "disparity_sequence", "val", "*", "*_disparity.png"))
    for p in paths:
        code = load_png(p)
        name = os.path.basename(p)[: -len("_disparity.png")]
        save_png(os.path.join(out_dir, f"{name}_leftImg8bit.png"),
                 np.where(code > 0, code - 1, 0).astype(np.uint16), **data_io.PNG_IDS)
    return len(paths)


def cascade_cli_cfg(cfg, root, tag):
    """phase 12's CLI config ``cfg`` with a cascade pc config (flat
    disparities made from its stereo ones under ``root``)."""
    cs = os.path.join(os.path.dirname(cfg["working_dir"]), "cs")
    flat = os.path.join(root, f"cascade_{tag}")
    cascade_from_stereo(cs, flat)
    pc = read_yaml(cfg["fused"]["pc_config"])
    pc["data"].update(use_cascade_disps=True, disparity_dir=flat)
    return dict(cfg, fused=dict(cfg["fused"], pc_config=dump(
        os.path.join(root, f"pc_cascade_{tag}.yaml"), pc)))


def pc_options_phase(dev, root, fixtures):
    """(a)-(d): each pc option through prepare_bg_data and the pc export
    at 1024x2048 on the card, counted; check_output_dir on a finished
    export; use_imgs's export; the fused CLI on a cascade pc config;
    card against CPU."""
    readings = {}
    full = os.path.join(root, "full")
    ts = time.perf_counter()
    store, dirs = option_fixture(full, H, W)
    readings["fixture_s"] = time.perf_counter() - ts
    for name, opts in PC_OPTIONS.items():
        items = 30 - (6 + OPTION_GAP) if name == "expand_test" else 1
        run = pc_option_run(option_pc_cfg(dirs, **opts), store, full, name, "cuda")
        launches = check_option_launches(name, run, items)
        readings[name] = {"items": items, "launches": launches,
                          "s": {c: run[c][2] for c in ("prepare", "export")}}
        print(f"[data] pc {name} at {H}x{W}: {items} items, launches "
              f"{ {c: launched(v) for c, v in launches.items()} }, "
              f"prepare {run['prepare'][2]:.2f} s, export {run['export'][2]:.2f} s")
        if name == "expand_test":
            done = run
        if name == "mono":  # the mono depth is 1024x2048: card against CPU here
            cpu = pc_option_run(option_pc_cfg(dirs, **opts), store, full, "mono_cpu", "cpu")
            n = same_outputs(output_tree(cpu["bg_out"], store),
                             output_tree(run["bg_out"], store), "mono prepare_bg_data")
            n += same_outputs(output_tree(cpu["wd"], store), output_tree(run["wd"], store),
                              "mono export")
            readings[name]["card_equals_cpu_files"] = n
            print(f"[data] pc mono: the card's {n} files equal the CPU's at {H}x{W}")

    # check_output_dir on the finished expand_test outputs: nothing to do
    before = listing(done["wd"]) + listing(done["bg_out"])
    again = option_pc_cfg(dirs, expand_test=True, check_output_dir=os.path.join(
        done["wd"], "exported_predictions"))
    export_again = pc_option_run(again, store, full, "resume_export", "cuda",
                                 prepare=False, outputs=done)
    again["data"]["check_output_dir"] = os.path.join(
        done["bg_out"], "point_cloud_static_ind0_all", "exported_predictions")
    prepare_again = pc_option_run(again, store, full, "resume_prepare", "cuda",
                                  outputs=done)["prepare"]
    resumed = {"export": export_again["export"][1], "prepare": prepare_again[1]}
    unchanged = listing(done["wd"]) + listing(done["bg_out"]) == before
    readings["check_output_dir"] = {"launches": resumed, "unchanged": unchanged}
    print(f"[data] check_output_dir on the expand_test outputs: launches "
          f"{ {c: launched(v) for c, v in resumed.items()} }, "
          f"files unchanged {unchanged}")
    if any(sum(v.values()) for v in resumed.values()) or not unchanged:
        raise SystemExit("check_output_dir: a finished export ran again")

    # (b) use_imgs: the RGB payload through the exact z-buffer, no K1
    imgs_cfg = option_pc_cfg(dirs, use_imgs=True)
    imgs_cfg.update(is_img=True, model={"is_img": True})
    imgs = pc_option_run(imgs_cfg, store, full, "use_imgs", "cuda", prepare=False)
    launches = imgs["export"][1]
    written = glob.glob(os.path.join(imgs["wd"], "**", "*_leftImg8bit.png"), recursive=True)
    rgb = load_png(written[0]) if written else None
    readings["use_imgs"] = {"launches": launches, "frames": len(written),
                            "s": imgs["export"][2]}
    print(f"[data] pc use_imgs at {H}x{W}: launches {launched(launches)}, {len(written)} RGB "
          f"frames, {imgs['export'][2]:.2f} s")
    if sum(launches.values()) or len(written) != 1 or rgb.shape != (H, W, 3) or not rgb.any():
        raise SystemExit("use_imgs: not one RGB frame through the exact z-buffer")

    # (c) the fused CLI on a cascade pc config: K1 and K2 once a frame
    cfg, cli_store, _ = fixtures["full"]
    cfg_c = cascade_cli_cfg(cfg, os.path.join(root, "fused"), "full")
    reset_counts()
    report = run_cli(cfg_c, cli_store, "cuda", "fused_cascade")
    torch.cuda.synchronize()
    launches, frames = read_counts(), report["frames"]
    readings["fused_cascade"] = {"frames": frames, "launches": launches,
                                 "seconds": report["seconds"]}
    print(f"[data] forecast_fused with cascade disparities at {H}x{W}: {frames} frames, "
          f"launches {launched(launches)}, {report['seconds']:.2f} s")
    if (frames != CLI_SCENES or launches["place_min_fold"] != frames
            or launches["onehot_stem_conv"] != frames or launches["place_min"]):
        raise SystemExit(f"fused cascade: {frames} frames, launches {launches}")

    # (d) card against CPU at 256x512 (mono above, at full width)
    small_root = os.path.join(root, "small")
    small_store, small_dirs = option_fixture(small_root, H_SMALL, W_SMALL, mono=False)
    compared = 0
    for name, opts in dict(PC_OPTIONS, use_imgs={"use_imgs": True}).items():
        if name == "mono":
            continue
        cfg_s = option_pc_cfg(small_dirs, **opts)
        if name == "use_imgs":
            cfg_s.update(is_img=True, model={"is_img": True})
        runs = {p: pc_option_run(cfg_s, small_store, small_root, f"{name}_{p}", p,
                                 prepare=name != "use_imgs") for p in ("cuda", "cpu")}
        for key in ("wd", "bg_out") if name != "use_imgs" else ("wd",):
            compared += same_outputs(output_tree(runs["cpu"][key], small_store),
                                     output_tree(runs["cuda"][key], small_store),
                                     f"{name} at {H_SMALL}x{W_SMALL}")
    small, small_cli_store, _ = fixtures["small"]
    small_c = cascade_cli_cfg(small, os.path.join(root, "fused"), "small")
    outs = {p: cli_outputs(run_cli(small_c, small_cli_store, p, f"cascade_{p}"))[0]
            for p in ("cuda", "cpu")}
    worst = max(float((outs["cuda"][k] != outs["cpu"][k]).mean()) for k in outs["cpu"])
    ids = all(set(np.unique(outs["cuda"][k])) == set(np.unique(outs["cpu"][k]))
              for k in outs["cpu"])
    readings["small"] = {"files_equal": compared, "fused_ids_equal": ids,
                         "fused_worst": worst}
    print(f"[data] card against CPU at {H_SMALL}x{W_SMALL}: {compared} pc output files "
          f"equal (cascade, expand_test, cities, use_imgs); fused cascade CLI ids "
          f"equal {ids}, worst panoptic mismatch {worst:.3e} (phase 12's budget 1e-3: "
          f"HarDNet and the fg model in cuDNN)")
    if not ids or not worst < 1e-3:
        raise SystemExit("the fused cascade CLI on the card and the CPU disagree")
    return readings


def option_train_phase(dev, root, refs, train_readings):
    """(e) odom_train.yaml with load_imgs (1024x2048 frames, short side
    256) against the same run without images; fg_train.yaml with
    use_condensed_feats against the plain run; each cli.train counted."""
    readings = {}
    odom_dir, cs = os.path.join(root, "odom_imgs"), os.path.join(root, "odom_cs")
    store = synthetic.write_odom_fixture(odom_dir, n_snippets=ODOM_IMG_SNIPPETS)
    for split in ("train", "val"):
        synthetic.write_odom_images(cs, store["tables"][os.path.join(
            odom_dir, f"{split}_3d_info.pkl")], split, H, W, seed=SEED)
    imgs = (("data.load_imgs", "true"), ("data.min_img_len", 256),
            ("data.cityscapes_dir", cs))
    runs, argvs = {}, {}
    for name, sets in (("plain", ()), ("load_imgs", imgs)):
        argvs[name] = train_argv("odom", os.path.join(root, f"odom_{name}"), odom_dir,
                                 *ODOM_IMG_SETS, *sets)
        with cudnn_deterministic():
            result, launches, secs = train_cli_run(argvs[name], store)
        runs[name] = ([(h["train"], h["val"]) for h in result["history"]],
                      result["step"], secs, launches)
    loader = loader_ms(argvs["load_imgs"], store, batches=3)
    plain_loader = loader_ms(argvs["plain"], store, batches=3)
    hist, steps, secs, launches = runs["load_imgs"]
    equal = hist == runs["plain"][0]
    phase15 = train_readings["steps"]["odom"]["ms_median"]
    readings["odom_load_imgs"] = {
        "steps": steps, "s": secs, "plain_s": runs["plain"][2], "launches": launches,
        "losses_equal": equal, "loader_ms_per_batch": loader,
        "plain_loader_ms_per_batch": plain_loader,
        "phase15_step_ms": phase15}
    print(f"[data] cli.train odom_train.yaml with load_imgs (batch 8 of 9 {H}x{W} "
          f"frames, short side 256): {steps} steps in {secs:.2f} s against "
          f"{runs['plain'][2]:.2f} s without images (run first); loader {loader[0]:.1f} "
          f"ms a batch (min {loader[1]:.1f}, max {loader[2]:.1f}), "
          f"{plain_loader[0]:.2f} without images; phase 15's fixed-batch odom "
          f"step {phase15:.2f} ms (batch 32); losses equal the run without images: "
          f"{equal}; launches {launched(launches)}")
    if not equal or steps != 2 or any(launches.values()):
        raise SystemExit("odom load_imgs: the run differs from the run without images")

    fg_dir, fg_store = refs["fg_dir"], refs["fg_store"]
    synthetic.write_condensed_feats(fg_dir, fg_store)
    runs = {}
    for name, sets in (("plain", ()), ("condensed", (("data.use_condensed_feats", "true"),))):
        argv = train_argv("fg", os.path.join(root, f"fg_{name}"), fg_dir,
                          ("training.steps_per_epoch", 2), ("training.num_epochs", 1),
                          *sets)
        with cudnn_deterministic():
            result, launches, secs = train_cli_run(argv, fg_store)
        runs[name] = ([(h["train"], h["val"]) for h in result["history"]],
                      result["step"], secs, launches)
    equal = runs["condensed"][0] == runs["plain"][0]
    readings["fg_condensed"] = {"steps": runs["condensed"][1], "s": runs["condensed"][2],
                                "losses_equal": equal, "launches": runs["condensed"][3]}
    print(f"[data] cli.train fg_train.yaml with use_condensed_feats: "
          f"{runs['condensed'][1]} steps in {runs['condensed'][2]:.2f} s, losses equal "
          f"the plain run's: {equal}, launches {launched(runs['condensed'][3])}")
    if not equal or any(runs["condensed"][3].values()):
        raise SystemExit("fg use_condensed_feats: the run differs from the plain run")
    return readings


def data_options_phase(dev, root, fixtures, refs, train_readings, cli_readings):
    """Phase 19: the data options (see the module doc)."""
    ts0 = time.perf_counter()
    root = os.path.join(root, "data_options")  # beside the earlier phases' files
    readings = pc_options_phase(dev, root, fixtures)
    ts1 = time.perf_counter()
    readings["train"] = option_train_phase(dev, root, refs, train_readings)
    ts2 = time.perf_counter()
    readings["png_decode_ms"] = expand_decode_ms(H, W)
    plain = cli_readings["png_decode_ms"]["labels8_none"]
    print(f"[data] decode ms at {H}x{W}: " + json.dumps(readings["png_decode_ms"])
          + f"; phase 12's unfiltered label map {plain:.2f}")
    readings["part_s"] = {"a-d": ts1 - ts0, "e": ts2 - ts1,
                          "f": time.perf_counter() - ts2}
    readings["phase_s"] = time.perf_counter() - ts0
    print(f"[data] phase 19 took {readings['phase_s']:.1f} s (a-d {ts1 - ts0:.1f}, "
          f"e {ts2 - ts1:.1f})")
    return readings


# ---- 20. native IO -----------------------------------------------------------


def median_ms(fn, n=3):
    """(median host ms of ``fn()`` over ``n`` calls, its last result)."""
    ms = []
    for _ in range(n):
        ts = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - ts) * 1e3)
    return sorted(ms)[n // 2], out


def row_filters(data: bytes):
    """How many rows of a non-interlaced 8- or 16-bit PNG use each of the
    five filters (None, Sub, Up, Average, Paeth)."""
    hdr = png._header(data)
    stride = hdr["width"] * png.CHANNELS[hdr["ctype"]] * hdr["depth"] // 8 + 1
    kinds = np.frombuffer(zlib.decompress(hdr["idat"]), np.uint8)[::stride]
    return np.bincount(kinds, minlength=5).tolist()


def rewrite_adaptive(paths):
    """Rewrite each PNG in place with libpng's per-row filter choice at
    level 1 (``PNG_SMOOTH16``'s settings), on a thread per CPU; each file
    read back must give the pixels it had."""
    def one(path):
        arr = native.load_png(path)
        save_png(path, arr, **data_io.PNG_SMOOTH16)
        if not np.array_equal(native.load_png(path), arr):
            raise SystemExit(f"the adaptive rewrite of {path} changed its pixels")

    with ThreadPoolExecutor(max_workers=os.cpu_count()) as ex:
        list(ex.map(one, paths))


@contextlib.contextmanager
def plain_png_reads():
    """Within the block the data layer reads PNG as the port did before
    ``native``: the plain codec (``data/png.py``), one file after another."""
    def load(path):
        with open(path, "rb") as f:
            return png.decode_png(f.read())

    def batch(paths):
        return np.stack([load(p) for p in paths])

    saved = data_io.load_png, data_io.load_png_batch, pc_data.load_png_batch
    data_io.load_png, data_io.load_png_batch, pc_data.load_png_batch = load, batch, batch
    try:
        yield
    finally:
        data_io.load_png, data_io.load_png_batch, pc_data.load_png_batch = saved


def pc_fetch_ms(cfg, store, frames=2):
    """Host ms of the serving CLI's pc fetch (``forecast_fused._pc_inputs``:
    the frame's 6 PNG decodes and its pc host work) for each of the first
    ``frames`` frames."""
    with store_readers(store):
        pc_ds, pc_idx = forecast_fused._pc_index(cfg["fused"], "val")
        lut = id_to_train_id_lut()
        ms = []
        for name in sorted(pc_idx)[:frames]:
            ts = time.perf_counter()
            forecast_fused._pc_inputs(pc_ds, pc_idx[name], lut)
            ms.append((time.perf_counter() - ts) * 1e3)
    return ms


def native_io_phase(root, fixtures, cli_files, build_s, train_readings, refs):
    """Phase 20: the host IO layer (see the module doc)."""
    ts0 = time.perf_counter()
    cfg, store, _ = fixtures["full"]
    full = os.path.dirname(cfg["fused"]["pc_config"])
    out = os.path.join(root, "native_io")
    os.makedirs(out, exist_ok=True)
    version = subprocess.run([*build.cxx(), "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    readings = {"compiler": version, "build_s": build_s, "cpu_count": os.cpu_count()}
    print(f"[native] {version}; csrc/native_io.cpp built in {build_s:.2f} s "
          f"(phase 1, beside nvcc); {os.cpu_count()} CPUs")

    # (a) one file of each kind, as the fixture writes it and adaptively
    cs = os.path.join(full, "cs")
    labels = sorted(glob.glob(os.path.join(cs, "seg", "**", "pred_mask_*.png"),
                              recursive=True))
    disps = sorted(glob.glob(os.path.join(cs, "disparity_sequence", "**",
                                          "*_disparity.png"), recursive=True))
    rgb = os.path.join(out, "rgb_leftImg8bit.png")
    save_png(rgb, synthetic.rgb_frame(native.load_png(labels[0])), **data_io.PNG_IDS)
    decode = {}
    for kind, path in (("labels8", labels[0]), ("disparity16", disps[0]), ("rgb8", rgb)):
        with open(path, "rb") as f:
            unfiltered = f.read()
        arr = native.decode_png(unfiltered)
        adaptive = native.encode_png(arr, **data_io.PNG_SMOOTH16)
        for profile, data in (("unfiltered", unfiltered), ("adaptive", adaptive)):
            ms, got = median_ms(lambda: native.decode_png(data))
            plain_ms, want = median_ms(lambda: png.decode_png(data),
                                       3 if profile == "unfiltered" else 1)
            if not (np.array_equal(got, want) and np.array_equal(got, arr)
                    and got.dtype == want.dtype):
                raise SystemExit(f"native and plain decodes of {kind} ({profile}) differ")
            decode[f"{kind}_{profile}"] = {"ms": ms, "plain_ms": plain_ms,
                                           "row_filters": row_filters(data),
                                           "bytes": len(data), "shape": list(arr.shape)}
    readings["decode"] = decode
    for k, v in decode.items():
        print(f"[native] decode {k} {v['shape']}: native {v['ms']:.2f} ms, plain "
              f"{v['plain_ms']:.2f} ms, equal; rows None/Sub/Up/Avg/Paeth "
              f"{v['row_filters']}, {v['bytes']} B")

    # (b) six adaptively filtered disparity files, one batch
    six, want = [], []
    for i, path in enumerate((disps * 6)[:6]):
        six.append(os.path.join(out, f"disp{i}.png"))
        want.append(native.load_png(path))  # the unfiltered file's pixels
        save_png(six[-1], want[-1], **data_io.PNG_SMOOTH16)
    batch = {}
    for threads in (1, 6):
        batch[f"threads_{threads}_ms"], got = median_ms(
            lambda: native.load_png_batch(six, threads))
        if not np.array_equal(got, np.stack(want)):
            raise SystemExit(f"the batch decode on {threads} threads differs from "
                             "the unfiltered files")
    readings["batch6_disparity16"] = batch
    print(f"[native] load_png_batch of 6 adaptive 16-bit disparities: "
          f"1 thread {batch['threads_1_ms']:.2f} ms, 6 threads "
          f"{batch['threads_6_ms']:.2f} ms")

    # (c) the writer against the plain encoder
    write = {}
    for profile, kind, plain_filter in (("PNG_IDS", "labels8", png.FILTER_NONE),
                                        ("PNG_SMOOTH16", "disparity16", None)):
        arr = native.load_png(labels[0] if kind == "labels8" else disps[0])
        kw = getattr(data_io, profile)
        ms, got = median_ms(lambda: native.encode_png(arr, **kw))
        plain_ms, want = median_ms(lambda: png.encode_png(arr, 1, plain_filter),
                                   3 if plain_filter is not None else 1)
        if got != want:
            raise SystemExit(f"save_png's bytes at {profile} differ from png.encode_png")
        write[profile] = {"ms": ms, "plain_ms": plain_ms, "bytes": len(got)}
        print(f"[native] encode {kind} at {profile}: native {ms:.2f} ms, plain "
              f"{plain_ms:.2f} ms, bytes equal ({len(got)} B)")
    readings["encode"] = write

    # (d) the serving CLI on the fixture rewritten adaptively
    ts = time.perf_counter()
    inputs = [p for d in ("cs", "fg", "bg_export")
              for p in glob.glob(os.path.join(full, d, "**", "*.png"), recursive=True)]
    rewrite_adaptive(inputs)
    readings["rewrite"] = {"files": len(inputs), "s": time.perf_counter() - ts}
    reset_counts()
    report = run_cli(cfg, store, export_name="fused_adaptive")
    torch.cuda.synchronize()
    launches = read_counts()
    frames = report["frames"]
    if (frames != CLI_SCENES or launches["place_min_fold"] != frames
            or launches["onehot_stem_conv"] != frames or launches["place_min"] != 0):
        raise SystemExit(f"the CLI on the adaptive fixture: {frames} frames, "
                         f"launches {launches}")
    files = panoptic_files(report["result_dir"])
    if files != cli_files:
        raise SystemExit("the CLI's panoptic files on the adaptive fixture differ "
                         "from phase 12's: " + ", ".join(
                             n for n in sorted(set(files) | set(cli_files))
                             if files.get(n) != cli_files.get(n)))
    med = {k: float(np.median(v)) for k, v in report["ms"].items()}
    readings["cli"] = {"frames": frames, "launches": launches,
                       "frames_per_s": frames / report["seconds"], "median_ms": med}
    print(f"[native] CLI on {len(inputs)} adaptively filtered PNGs "
          f"(rewritten in {readings['rewrite']['s']:.1f} s): {frames} frames, "
          f"launches {launches}, {len(files)} panoptic files byte-equal to phase "
          f"12's; pc_fetch {med['pc_fetch']:.1f} ms, png_write "
          f"{med['png_write']:.1f} ms, {readings['cli']['frames_per_s']:.3f} frames/s")
    readings["bg_loader_ms"] = train_readings["bg"]["loader_ms"]
    print(f"[native] phase 16's bg loader through the native batch decode: "
          f"{readings['bg_loader_ms'][0]:.1f} ms per batch (min "
          f"{readings['bg_loader_ms'][1]:.1f}, max {readings['bg_loader_ms'][2]:.1f})")

    # (e) the reads as the port made them before native (plain codec, one
    # file after another) beside native, in turns: phase 16's bg loader
    # (median ms a batch over 3) and the pc fetch on the adaptive fixture
    bg_argv = bg_train_argv(refs["bg_wd"], refs["bg_data"],
                            ("training.steps_per_epoch", BG_STEPS))
    turns = {"bg_loader_ms": {"plain": [], "native": []},
             "pc_fetch_ms": {"plain": [], "native": []}}
    for reads in ("plain", "native", "native", "plain"):
        with plain_png_reads() if reads == "plain" else contextlib.nullcontext():
            turns["bg_loader_ms"][reads].append(
                loader_ms(bg_argv, refs["bg_store"], batches=3)[0])
            turns["pc_fetch_ms"][reads] += pc_fetch_ms(cfg, store)
    readings["turns"] = turns
    for k, v in turns.items():
        print(f"[native] {k} in turns (plain, native, native, plain): plain "
              + ", ".join(f"{x:.1f}" for x in v["plain"]) + "; native "
              + ", ".join(f"{x:.1f}" for x in v["native"]))
    readings["phase_s"] = time.perf_counter() - ts0
    print(f"[native] phase 20 took {readings['phase_s']:.1f} s")
    return readings

STAGE_FRAMES = 24  # phase 21: frames of each mode, over 4 scenes
GUARD_CALLS = 8  # phase 21: calls issued behind one long sleep of the copy stream
GUARD_SLEEP = 3_000_000_000  # its clock cycles: 1.5-2 s on an H100


def on_device(pc_in, fg_in, dev):
    """The step's inputs with every map the device reads already there
    (the camera matrices stay on the host, where the step reads them)."""
    return ({k: torch.as_tensor(v).to(dev) if k in step_inputs.PC_KEYS else v
             for k, v in pc_in.items()},
            {k: torch.as_tensor(v).to(dev) for k, v in fg_in.items()})


def stage_rates(dev, pc_in, fg_in):
    """GB/s of the host pass alone (the pc maps into pinned tensors, as
    the step stages them: torch's copy on the intra-op threads, and on
    one), of one DMA of the pc bytes from pinned and from pageable memory;
    host ms of the pc staging (host pass + DMAs + wait) and of the fg
    staging."""
    host = {k: torch.as_tensor(pc_in[k]) for k in step_inputs.PC_KEYS}
    pinned = {k: torch.empty(a.shape, dtype=torch.float32 if k == "depth" else a.dtype,
                             pin_memory=True) for k, a in host.items()}
    nbytes = sum(t.numel() * t.element_size() for t in pinned.values())

    def fill_all():
        for k, t in pinned.items():
            t.copy_(host[k])

    threads = torch.get_num_threads()
    out = {"pc_bytes": nbytes, "intra_op_threads": threads,
           "fill_gbs": nbytes / host_ms(fill_all, 10, 2) / 1e6}
    torch.set_num_threads(1)
    out["fill_gbs_1_thread"] = nbytes / host_ms(fill_all, 10, 2) / 1e6
    torch.set_num_threads(threads)
    flat = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out["dma_gbs"] = nbytes / time_ms(
        lambda: dst.copy_(flat, non_blocking=True), 10, 2) / 1e6
    pageable = torch.ones(nbytes, dtype=torch.uint8)
    out["pageable_gbs"] = nbytes / time_ms(lambda: dst.copy_(pageable), 10, 2) / 1e6
    probe = step_inputs.Inputs(dev)

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    out["pc_stage_ms"] = host_ms(synced(lambda: probe.pc(pc_in)), 10, 2)
    out["fg_stage_ms"] = host_ms(synced(lambda: probe.fg(fg_in)), 10, 2)
    return out


def reuse_guard(dev, scenes):
    """Calls of the step's inputs issued while the copy stream still runs
    the earlier calls' copies (a sleep put before them): each call's host
    pass must not overwrite the pinned memory that a pending copy reads.
    -> the counters and whether the copies were still pending after the
    last call; raises unless every call's device tensors equal its inputs."""
    inp = step_inputs.Inputs(dev)
    with torch.cuda.stream(inp.stream):
        torch.cuda._sleep(GUARD_SLEEP)
    outs = []
    for i in range(GUARD_CALLS):
        pc_in, fg_in = scenes[i % len(scenes)]
        outs.append((inp.pc(pc_in), inp.fg(fg_in)))
    pending = not inp.stream.query()
    torch.cuda.synchronize()
    for i, ((seg, depth, mask), fg_out) in enumerate(outs):
        pc_in, fg_in = scenes[i % len(scenes)]
        want = [torch.as_tensor(pc_in["seg"]), torch.as_tensor(pc_in["depth"]).float(),
                torch.as_tensor(pc_in["depth_mask"])]
        want += [torch.as_tensor(fg_in[k]) for k in fg_in]
        got = [seg, depth, mask] + [fg_out[k] for k in fg_in]
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise SystemExit(f"[inputs] call {i} behind pending copies: its device "
                             "inputs differ from its host inputs")
    if not pending or inp.counters["reuse_waits"] != GUARD_CALLS:
        raise SystemExit(f"[inputs] the copies did not outlast the calls (pending {pending}, "
                         f"counters {inp.counters}): lengthen GUARD_SLEEP")
    return {"counters": dict(inp.counters), "pending_after_last_call": pending}


def host_syncs(step, scene):
    """The CUDA runtime calls that block the host in one profiled step
    (synchronizes and blocking copies), by the innermost ``pf.*`` span
    that holds each ("outside" for none)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    step(*scene)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        step(*scene)
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name.startswith("pf.")]
    out = {}
    for e in events:
        if "Synchronize" not in e.name and e.name != "cudaMemcpy":
            continue
        t = e.time_range.start
        held = [sp for sp in spans if sp[0] <= t <= sp[1]]
        where = min(held, key=lambda sp: sp[1] - sp[0])[2] if held else "outside"
        out.setdefault(where, {}).setdefault(e.name, 0)
        out[where][e.name] += 1
    return out


def equal_steps(got, want) -> bool:
    return sorted(got) == sorted(want) and all(
        torch.equal(got[k].cpu(), want[k].cpu()) for k in want)


def inputs_phase(dev, card):
    """Phase 21: the forecast step's inputs through pinned memory."""
    bg, fg = make_models(dev)
    readings = {"card": card}
    for n in (8, 32):
        scenes = [make_inputs(H, W, n=n, seed=SEED + 100 * n + i) for i in range(4)]
        fed = [on_device(pc, f, dev) for pc, f in scenes]
        ref_step = build_forecast_step(bg, fg, height=H, width=W, out_t=OUT_T)
        want = [{k: v.cpu() for k, v in ref_step(*s).items()} for s in fed]
        again = [{k: v.cpu() for k, v in ref_step(*s).items()} for s in fed]
        if not all(equal_steps(a, w) for a, w in zip(again, want)):
            raise SystemExit(f"[inputs] {n} slots: the device-fed step is not repeatable")
        fed_counts = dict(ref_step.counters)
        if fed_counts["bytes_staged"] or fed_counts["htod_copies"]:
            raise SystemExit(f"[inputs] device-resident inputs were staged: {fed_counts}")
        step = build_forecast_step(bg, fg, height=H, width=W, out_t=OUT_T)
        step(*scenes[0])
        torch.cuda.synchronize()
        modes = {}
        for mode in ("synced", "unsynced"):
            before = dict(step.counters)
            outs = []
            for i in range(STAGE_FRAMES):
                outs.append(step(*scenes[i % 4]))
                if mode == "synced":
                    torch.cuda.synchronize()
                    outs[-1] = {k: v.cpu() for k, v in outs[-1].items()}
            torch.cuda.synchronize()
            bad = [i for i, o in enumerate(outs) if not equal_steps(o, want[i % 4])]
            if bad:
                raise SystemExit(f"[inputs] {n} slots, {mode}: frames {bad} differ from "
                                 "the device-fed step")
            counts = {k: step.counters[k] - before[k] for k in step.counters}
            modes[mode] = counts
            print(f"[inputs] {n} slots, {mode}: {STAGE_FRAMES} frames bit-equal to the "
                  f"device-fed step; counters {json.dumps(counts)}; HtoD copies a frame "
                  f"{counts['htod_copies'] / STAGE_FRAMES:.2f}, bytes staged a frame "
                  f"{counts['bytes_staged'] / STAGE_FRAMES:.0f}")
            del outs
        frame_ms = {}
        for name, call in (("host", lambda: step(*scenes[0])),
                           ("device", lambda: ref_step(*fed[0]))):
            frame_ms[name] = host_ms(lambda: call()["panoptic"].cpu(), 20, 3)
        syncs = host_syncs(step, scenes[0])
        print(f"[inputs] {n} slots: host-blocking CUDA calls in a step, by span "
              + json.dumps(syncs))
        rates = stage_rates(dev, *scenes[0])
        guard = reuse_guard(dev, scenes)
        print(f"[inputs] {n} slots: frame ms (panoptic on the host) from host inputs "
              f"{frame_ms['host']:.3f}, from device inputs {frame_ms['device']:.3f}; "
              f"pc bytes {rates['pc_bytes']}, host pass {rates['fill_gbs']:.2f} GB/s on "
              f"{rates['intra_op_threads']} intra-op threads, "
              f"{rates['fill_gbs_1_thread']:.2f} on one; pinned DMA "
              f"{rates['dma_gbs']:.2f} GB/s, pageable copy {rates['pageable_gbs']:.2f} GB/s")
        print(f"[inputs] {n} slots: staging host ms, pc {rates['pc_stage_ms']:.3f}, fg "
              f"{rates['fg_stage_ms']:.3f}")
        print(f"[inputs] {n} slots: {GUARD_CALLS} calls behind pending copies bit-equal to "
              f"their inputs; counters {json.dumps(guard['counters'])}")
        readings[f"slots{n}"] = {"modes": modes, "fed_counters": fed_counts,
                                 "frame_ms": frame_ms, "host_syncs": syncs,
                                 "reuse_guard": guard, **rates}
        del scenes, fed, want, again, step, ref_step
    print(card)
    return readings


# ---- 22. the bg step replayed from CUDA graphs -----------------------------------

GRAPH_STEPS = 12  # batches of each pool8-shaped run
# steps [first, end) timed on the host clock untraced, traced on the device
# alone, and traced with the host's events; a step apart, so that no
# profiler starts inside a span opened under another (core/tracing.py)
GRAPH_TIMED, GRAPH_LIGHT, GRAPH_FULL = (2, 6), (6, 8), (9, 11)
GRAPH_LR_STEPS = 3  # steps of each epoch of the learning-rate runs
GRAPH_EAGER_RUNS = 3  # eager runs whose spread the graphed one is held to
GRAPH_FAULT_SEED = 2**31 + 24  # seed of the pool8 check's program and fault runs
GRAPH_SLEEP_STEPS = 8  # steps of the runs with a sleep before each DtoD
GRAPH_SLEEP_CYCLES = 40_000_000  # ~20 ms of the compute stream at the H100's clocks


def graph_cfg(wd, **training):
    """bg_train.yaml's step at pool8's shape: FCHarDNet-70 on 3 one-hot +
    depth frames, batch 8 of 800x800, SGD (momentum 0.9, decay 1e-4),
    clip-norm 5, f32; one epoch and no validation unless ``training``
    says otherwise."""
    return {"task": "bg", "seed": SEED, "working_dir": wd,
            "data": dict(BG_CFG["data"], crop_size=800),
            "model": dict(BG_CFG["model"]),
            "training": dict({"batch_size": 8, "num_epochs": 1, "lr": 2e-3, "mom": 0.9,
                              "wd": 1e-4, "clip_grad_norm": 5.0, "val_interval": 100},
                             **training)}


def graph_batches(n, seed, size=800, batch=8):
    """``n`` batches in the bg train loader's format: trainId segs (uint8,
    3 frames), raw uint16 depth, GT with 255 where things are."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = rng.integers(0, 11, (batch, size, size), dtype=np.uint8)
        gt[:, : size // 4, : size // 3] = 255
        out.append({"inputs": {
            "seg": rng.integers(0, 11, (batch, T_IN, size, size), dtype=np.uint8),
            "depth": rng.integers(300, 50000, (batch, T_IN, size, size), dtype=np.uint16)},
            "labels": {"seg": gt}})
    return out


class GraphData:
    """Task data over epochs of fixed batches (each batch a fresh dict).
    The loader stamps the host clock as it hands out each batch and, from
    batch ``light[0]`` to ``light[1]`` and from ``full[0]`` to
    ``full[1]`` (counted over the run), records the steps between with
    ``torch.profiler``: the device alone, then with the host's events."""

    def __init__(self, epochs, light=None, full=None):
        self.epochs, self.datasets = epochs, {"train": None}
        self.light, self.full = light, full
        self.stamps, self.traces, self.i, self.prof = [], {}, 0, None

    def loader(self, split, cfg, seed=0, shard=True):
        return self

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _edge(self):
        torch.cuda.synchronize()
        time.sleep(0.002)  # CUPTI keeps whole records away from the edges

    def __iter__(self):
        acts = torch.profiler.ProfilerActivity
        for b in self.epochs[self.epoch - 1]:
            for name, win, kinds in (("light", self.light, [acts.CUDA]),
                                     ("full", self.full, [acts.CPU, acts.CUDA])):
                if win and self.i == win[1]:
                    self._edge()
                    self.prof.stop()
                    with tempfile.TemporaryDirectory() as tmp:
                        path = os.path.join(tmp, "trace.json")
                        self.prof.export_chrome_trace(path)
                        with open(path) as f:
                            self.traces[name] = json.load(f)["traceEvents"]
                if win and self.i == win[0]:
                    self._edge()
                    self.prof = torch.profiler.profile(activities=kinds)
                    self.prof.start()
                    time.sleep(0.002)
            self.stamps.append(time.perf_counter())
            self.i += 1
            yield dict(b)


def trace_counts(events, steps):
    """Kernels, memsets, copies, and each kind of kernel and memset a
    step of a trace; with host events, the kernels and memsets launched
    in each ``pf.train.*`` span a step (by the runtime call that launched
    them, ``cudaGraphLaunch`` for a graph's)."""
    x = [e for e in events if e.get("ph") == "X"]
    ops = [e for e in x if e.get("cat") in ("kernel", "gpu_memset")]
    out = {"kernels": sum(e["cat"] == "kernel" for e in ops) / steps,
           "memsets": sum(e["cat"] == "gpu_memset" for e in ops) / steps,
           "copies": sum(e.get("cat") == "gpu_memcpy" for e in x) / steps,
           "names": {n: c / steps for n, c in Counter(e["name"] for e in ops).items()}}
    launch = {e["args"]["correlation"]: e["ts"] for e in x
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    if not launch:
        return out
    for name in ("pf.train.to_device", "pf.train.forward", "pf.train.backward",
                 "pf.train.optim"):
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in x
                 if e["name"] == name and e.get("cat") == "user_annotation"]
        at = [launch.get(e.get("args", {}).get("correlation")) for e in ops]
        n = sum(1 for t in at if t is not None and any(a <= t <= b for a, b in spans))
        out[name] = n / max(len(spans), 1)
        out[name + ".spans"] = len(spans)
    return out


def htod_overlap(events, steps):
    """The HtoD copies of a trace: a step, their count and device ms, and
    the ms of them in which some kernel ran; their names."""
    x = [e for e in events if e.get("ph") == "X"]
    copies = [e for e in x if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    busy = []  # the kernels' merged intervals
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in x if e.get("cat") == "kernel"):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    beside = sum(max(0.0, min(c["ts"] + c["dur"], b) - max(c["ts"], a))
                 for c in copies for a, b in busy)
    return {"copies": len(copies) / steps, "ms": sum(c["dur"] for c in copies) / 1e3 / steps,
            "beside_kernels_ms": beside / 1e3 / steps,
            "names": sorted({c["name"] for c in copies})}


@contextlib.contextmanager
def slept_moves(cycles):
    """Within the block the compute stream sleeps ``cycles`` before each
    DtoD of a staged batch into the captured inputs."""
    move = step_graph.StepGraphs._move

    def slept(self):
        torch.cuda._sleep(cycles)
        move(self)

    step_graph.StepGraphs._move = slept
    try:
        yield
    finally:
        step_graph.StepGraphs._move = move


@contextlib.contextmanager
def eager_steps():
    """Within the block ``train()`` keeps every step eager: the step
    graphs' seam names a device type no device has (the reason counted
    is ``cpu``, the one for a device the graphs do not capture on)."""
    kept = step_graph.DEVICE_TYPE
    step_graph.DEVICE_TYPE = "none"
    try:
        yield
    finally:
        step_graph.DEVICE_TYPE = kept


@contextlib.contextmanager
def recorded_losses(out):
    """Each step's loss, as the trainer adds it to its sums, into ``out``."""
    add = train_loop._Sums.add

    def recording(self, metrics, sharded=False):
        out.append(metrics["loss"].detach().clone())
        return add(self, metrics, sharded)

    train_loop._Sums.add = recording
    try:
        yield
    finally:
        train_loop._Sums.add = add


def graph_run(dev, root, name, epochs, graphed, **training):
    """``train()`` of a pool8-shaped bg model over ``epochs`` -> (result,
    final state on the host, each step's loss, the task data, peak GiB)."""
    wd = os.path.join(root, name)
    cfg = graph_cfg(wd, **training)
    model = BGModel(cfg, depth_stats=DEPTH_STATS, device=dev)
    data = epochs if isinstance(epochs, GraphData) else GraphData(epochs)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with recorded_losses(losses), (contextlib.nullcontext() if graphed else eager_steps()):
        out = train_loop.train(model, data, cfg)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    state = cpu_state(model)
    losses = torch.stack(losses).double().cpu()
    del model, out["model"]
    torch.cuda.empty_cache()
    return out, state, losses, data, peak


def state_rel(a, b):
    """Relative L2 distance of two states over their float tensors."""
    keys = [k for k in b if b[k].is_floating_point()]
    num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in keys)
    return (num / sum(float(b[k].double().square().sum()) for k in keys)) ** 0.5


def loss_rel(a, b):
    """Mean relative gap of two runs' step losses."""
    return float(((a - b).abs() / b.abs()).mean())


def pool8_check(seed):
    """portbench/control.py on bg_train.pool8: the program's run and each
    fault of ``portbench/harness/faults.py`` through the cell's check ->
    {what: (correct, numbers)}."""
    from portbench.harness.faults import FAULTS

    faults = ",".join(FAULTS["bg_train"])
    cmd = [sys.executable, os.path.join(REPO, "portbench", "control.py"), "--workload",
           "bg_train.pool8", "--seeds", str(seed), "--faults", faults,
           "--fault-seeds", str(seed), "--seconds", "2"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    if run.returncode:
        raise SystemExit(f"[graph] portbench/control.py failed:\n{run.stderr[-4000:]}")
    lines = [json.loads(l) for l in run.stdout.splitlines() if l.startswith("{")]
    return {l["what"]: (l["correct"], l["numbers"]) for l in lines}


def graph_phase(dev, root, card):
    """Phase 22: bg training's step replayed from CUDA graphs at pool8's
    shape, against eager runs of the same weights and batches."""
    ts0 = time.perf_counter()
    batches = graph_batches(GRAPH_STEPS, SEED + 22)
    failures = []  # every reading is printed before the phase fails

    # (a) 12 steps graphed against eager runs (cuDNN's default algorithms,
    # as the benchmark runs: its weight gradients are not bit-deterministic)
    runs = {}
    for i in range(GRAPH_EAGER_RUNS):
        traced = i == 0
        data = GraphData([batches], GRAPH_LIGHT if traced else None,
                         GRAPH_FULL if traced else None)
        runs[f"eager{i}"] = graph_run(dev, root, f"graph_eager{i}", data, False)
    data = GraphData([batches], GRAPH_LIGHT, GRAPH_FULL)
    runs["graphed"] = graph_run(dev, root, "graph_graphed", data, True)
    eager = [k for k in runs if k.startswith("eager")]
    pairs = [(a, b) for j, a in enumerate(eager) for b in eager[j + 1:]]
    spread = {"state": max(state_rel(runs[a][1], runs[b][1]) for a, b in pairs),
              "loss": max(loss_rel(runs[a][2], runs[b][2]) for a, b in pairs)}
    apart = {"state": max(state_rel(runs["graphed"][1], runs[a][1]) for a in eager),
             "loss": max(loss_rel(runs["graphed"][2], runs[a][2]) for a in eager)}
    first_equal = all(float(runs[k][2][0]) == float(runs["eager0"][2][0]) for k in runs)
    counters = runs["graphed"][0]["graph"]
    eager_counters = runs["eager0"][0]["graph"]
    print(f"[graph] {GRAPH_STEPS} steps at batch 8 of 800x800 (SGD, clip-norm 5): graphed "
          f"counters {json.dumps(counters)}; eager {json.dumps(eager_counters)}")
    print(f"[graph] graphed against {len(eager)} eager runs: state {apart['state']:.3e} "
          f"relative L2 at most, step losses {apart['loss']:.3e} apart relative (mean over "
          f"the steps) at most; the eager "
          f"runs' spread {spread['state']:.3e} / {spread['loss']:.3e} (limit twice "
          f"it); first losses equal {first_equal}; losses graphed "
          f"{[round(float(x), 6) for x in runs['graphed'][2]]}")
    if (counters["captures"], counters["replays"], counters["staged"],
            counters["eager"]["first_step"], counters["steps"]) != (
            1, GRAPH_STEPS - 1, GRAPH_STEPS - 1, 1, GRAPH_STEPS):
        failures.append(f"graphed counters {counters}")
    if eager_counters["eager"]["cpu"] != GRAPH_STEPS:
        failures.append(f"eager counters {eager_counters}")
    if not (apart["state"] <= 2 * spread["state"] and apart["loss"] <= 2 * spread["loss"]
            and first_equal):
        failures.append("the graphed run is outside the eager runs' spread")

    ms = {}
    for k in ("eager0", "graphed"):
        st = runs[k][3].stamps
        ms[k] = 1e3 * (st[GRAPH_TIMED[1]] - st[GRAPH_TIMED[0]]) / (GRAPH_TIMED[1]
                                                                  - GRAPH_TIMED[0])
    counts = {k: {w: trace_counts(runs[k][3].traces[w], GRAPH_LIGHT[1] - GRAPH_LIGHT[0]
                                  if w == "light" else GRAPH_FULL[1] - GRAPH_FULL[0])
                  for w in ("light", "full")} for k in ("eager0", "graphed")}
    peaks = {k: runs[k][4] for k in ("eager0", "graphed")}
    htod = {k: htod_overlap(runs[k][3].traces["full"], GRAPH_FULL[1] - GRAPH_FULL[0])
            for k in ("eager0", "graphed")}
    print(f"[graph] host ms a step (steps {GRAPH_TIMED[0] + 1}-{GRAPH_TIMED[1]}, untraced; "
          f"eager: the batch's pageable copy; graphed: staged through pinned memory): "
          f"eager {ms['eager0']:.2f}, "
          f"graphed {ms['graphed']:.2f}; peak GiB above earlier tensors: eager "
          f"{peaks['eager0']:.2f}, graphed {peaks['graphed']:.2f} | {card}")
    names = {k: {w: counts[k][w].pop("names") for w in ("light", "full")} for k in counts}
    differ = {n[:90]: (names["eager0"]["light"].get(n, 0), names["graphed"]["light"].get(n, 0))
              for n in set(names["eager0"]["light"]) | set(names["graphed"]["light"])
              if names["eager0"]["light"].get(n) != names["graphed"]["light"].get(n)}
    print(f"[graph] kernels / memsets a step, light trace: eager "
          f"{counts['eager0']['light']['kernels']} / {counts['eager0']['light']['memsets']}, "
          f"graphed {counts['graphed']['light']['kernels']} / "
          f"{counts['graphed']['light']['memsets']}; kinds whose count a step differs "
          f"(eager, graphed): {json.dumps(differ)}; full trace, by launching span: eager "
          f"{json.dumps(counts['eager0']['full'])}, graphed "
          f"{json.dumps(counts['graphed']['full'])}")
    print(f"[graph] HtoD copies, full trace (steps {GRAPH_FULL[0] + 1}-{GRAPH_FULL[1]}, "
          f"the device synchronised before the first): eager {json.dumps(htod['eager0'])}; "
          f"graphed {json.dumps(htod['graphed'])}; staged {counters['staged']}, "
          f"stage_waits {counters['stage_waits']}")
    if counts["eager0"]["light"]["kernels"] != counts["graphed"]["light"]["kernels"]:
        failures.append("the light trace's kernels a step differ graphed and eager")
    g, e = counts["graphed"]["full"], counts["eager0"]["full"]
    if not (g.get("pf.train.optim", 0) > 0 and g.get("pf.train.optim") == e.get(
            "pf.train.optim") and g.get("pf.train.optim.spans") == GRAPH_FULL[1]
            - GRAPH_FULL[0]):
        failures.append("the optimizer's kernels do not fall under pf.train.optim")
    del runs

    # (b) the rate: 2 epochs under lr_decay_type step (a tenth in epoch 2),
    # cuDNN deterministic: graphed bit-equal to eager; with the update graph
    # held at its first rate, not
    lr_batches = graph_batches(2 * GRAPH_LR_STEPS, SEED + 122)
    epochs = [lr_batches[:GRAPH_LR_STEPS], lr_batches[GRAPH_LR_STEPS:]]
    sched = dict(num_epochs=2, lr_decay_type="step", lr_decay_steps=1, lr_decay_factor=0.1)
    lr_runs = {}
    with cudnn_deterministic():
        for name, graphed in (("eager", False), ("graphed", True)):
            lr_runs[name] = graph_run(dev, root, f"graph_lr_{name}", epochs, graphed, **sched)
        held = step_graph.StepGraphs._lrs
        step_graph.StepGraphs._lrs = lambda self: (2e-3,)
        try:
            lr_runs["held"] = graph_run(dev, root, "graph_lr_held", epochs, True, **sched)
        finally:
            step_graph.StepGraphs._lrs = held
    (_, se, le, _, _), (gg, sg, lg, _, _) = lr_runs["eager"], lr_runs["graphed"]
    sh = lr_runs["held"][1]
    lr_equal = all(torch.equal(sg[k], se[k]) for k in se) and torch.equal(lg, le)
    held_apart = state_rel(sh, se)
    print(f"[graph] 2 epochs x {GRAPH_LR_STEPS} steps, the rate a tenth in epoch 2 (cuDNN "
          f"deterministic): graphed counters {json.dumps(gg['graph'])}; state and losses "
          f"bit-equal to eager: {lr_equal}; with the update graph held at epoch 1's rate "
          f"the state is {held_apart:.3e} relative L2 from eager")
    if not lr_equal or gg["graph"]["optim_captures"] != 1 or not held_apart > 0:
        failures.append("the epoch's rate did not reach the replayed step")
    del lr_runs

    # (c) a sleep of the compute stream before each DtoD into the captured
    # inputs: each next DMA waits on the device for the DtoD, the host for
    # that DMA before it fills the pinned buffers again; bit-equal to eager
    sleep_batches = [graph_batches(GRAPH_SLEEP_STEPS, SEED + 222)]
    with cudnn_deterministic():
        _, se, le, _, _ = graph_run(dev, root, "graph_sleep_eager", sleep_batches, False)
        with slept_moves(GRAPH_SLEEP_CYCLES):
            gs, sg, lg, _, _ = graph_run(dev, root, "graph_sleep", sleep_batches, True)
    sleep_equal = all(torch.equal(sg[k], se[k]) for k in se) and torch.equal(lg, le)
    sleep_counters = gs["graph"]
    print(f"[graph] {GRAPH_SLEEP_STEPS} steps, the compute stream asleep "
          f"{GRAPH_SLEEP_CYCLES} cycles before each DtoD (cuDNN deterministic): graphed "
          f"counters {json.dumps(sleep_counters)}; state and losses bit-equal to eager: "
          f"{sleep_equal}")
    if not sleep_equal or sleep_counters["staged"] != GRAPH_SLEEP_STEPS - 1 or not (
            sleep_counters["stage_waits"] > 0):
        failures.append("a staged batch behind a sleeping compute stream")

    # (d) the pool8 check, graphed: the program correct, each fault caught
    checks = pool8_check(GRAPH_FAULT_SEED)
    for what, (correct, numbers) in checks.items():
        print(f"[graph] pool8 check, {what}: correct {correct}, "
              + ", ".join(f"{k} {v:.4g}" for k, v in numbers.items()))
    if (not checks.get("program", (False,))[0] or len(checks) != 4
            or any(c for w, (c, _) in checks.items() if w != "program")):
        failures.append(f"the pool8 check: {checks}")
    phase_s = time.perf_counter() - ts0
    print(f"[graph] phase 22 took {phase_s:.1f} s")
    if failures:
        raise SystemExit("[graph] " + "; ".join(failures))
    return {"counters": counters, "eager_counters": eager_counters, "apart": apart,
            "spread": spread, "host_ms": ms, "trace_counts": counts,
            "kinds_differ": differ, "peak_gib": peaks, "htod": htod,
            "sleep": {"counters": sleep_counters, "bit_equal": sleep_equal},
            "lr": {"counters": gg["graph"], "bit_equal": lr_equal,
                   "held_apart": held_apart},
            "pool8_check": {w: {"correct": c, "numbers": n} for w, (c, n) in checks.items()},
            "phase_s": phase_s, "card": card}


def training_main() -> int:
    """``chip_smoke.py --training``: phases 15-17 and 22 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["placement", "stem", "native_io"], verbose=True)
    dev, card = torch.device("cuda"), card_line()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        refs = {}
        readings = train_phase(dev, root, card, refs)
        readings["bg"] = bg_train_phase(dev, root, card, refs)
        readings["dp"] = dp_phase(dev, root, card, refs)
        readings["graph"] = graph_phase(dev, root, card)
    print(json.dumps({"train": readings}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def graphs_main() -> int:
    """``chip_smoke.py --graphs``: phase 22 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as root:
        readings = graph_phase(torch.device("cuda"), root, card_line())
    print(json.dumps({"graph": readings}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def inputs_main() -> int:
    """``chip_smoke.py --inputs``: phase 21 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["placement", "stem"], verbose=True)
    readings = inputs_phase(torch.device("cuda"), card_line())
    print(json.dumps({"inputs": readings}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    # The JAX reference computes in full f32; cuDNN would default to TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    t0 = time.perf_counter()
    print("[packages] importable here: " + json.dumps(optional_packages()))

    # ---- 1. build -----------------------------------------------------------
    secs = build.build(["placement", "stem", "minwin", "strided_load", "native_io"],
                       verbose=True)
    print("[build] " + ", ".join(f"{build.source(k).name} {v:.1f}s"
                                 for k, v in secs.items()))

    bg, fg = make_models(dev)
    pc_in, fg_in = make_inputs(H, W)

    # ---- 2. K1 against its plain version ------------------------------------
    group, key, num_groups = k1_inputs(pc_in, dev)
    k1_fold_ref = place_min_fold_plain(group, key, batch=T_IN, height=H, width=W)
    k1_fold = place_min_fold(group, key, batch=T_IN, height=H, width=W)
    torch.cuda.synchronize()
    k1_fold_err = int((k1_fold.long() - k1_fold_ref.long()).abs().max())
    if not torch.equal(k1_fold, k1_fold_ref):
        raise SystemExit(f"K1 place_min_fold differs from its plain version: "
                         f"{k1_fold_err}")
    fold_tgt, fold_keys = fold_targets(group, key, batch=T_IN, height=H, width=W)
    print(f"[K1] place_min_fold {group.numel()} entries ({fold_tgt.numel()} "
          f"targets) -> {T_IN}x{H}x{W}: bit-equal, "
          f"{int((k1_fold != EMPTY).sum())} pixels touched")
    k1_in = k1_streams(dev, (group, key, num_groups), k3_stream(dev)[:3])
    k1_err = 0
    for name, (g_s, k_s, n_s) in k1_in.items():
        k1 = place_min(g_s, k_s, n_s)
        k1_ref = place_min_plain(g_s, k_s, n_s)
        torch.cuda.synchronize()
        k1_err = max(k1_err, int((k1.long() - k1_ref.long()).abs().max()))
        if not torch.equal(k1, k1_ref):
            raise SystemExit(f"K1 place_min on {name} differs from its plain "
                             f"version: {k1_err}")
        plan = place_min_plan(g_s.numel(), n_s)
        kept = g_s[(g_s >= 0) & (g_s < n_s)]
        buckets = torch.bincount(kept >> plan["tile_shift"], minlength=plan["tiles"])
        print(f"[K1] place_min {name}: {g_s.numel()} entries -> {n_s} groups "
              f"({plan['tiles']} tiles of {plan['tile']}): bit-equal, "
              f"{int((k1 != EMPTY).sum())} groups touched; largest buckets "
              f"{buckets.topk(4).values.tolist()}, "
              f"{int((buckets > 0).sum())} tiles touched")
    one_tile_ms = time_ms(lambda: place_min(*k1_in["one_tile"]))
    print(f"[time] place_min, every entry of {group.numel()} in one tile: "
          f"{one_tile_ms:.4f} ms (CUDA events)")
    del k1, k1_ref, k1_in  # phase 11 makes the streams again

    k2_edge_err = edge_cases(dev)

    # ---- 3. K2 against its plain version ------------------------------------
    seg, dep, kern, bias = k2_inputs(bg, pc_in, dev)
    k2 = onehot_stem_conv(seg, dep, kern, bias, num_classes=11)
    k2_ref = onehot_stem_conv_plain(seg, dep, kern, bias, num_classes=11)
    torch.cuda.synchronize()
    k2_err = float((k2 - k2_ref).abs().max())
    print(f"[K2] onehot_stem_conv {tuple(seg.shape)} -> {tuple(k2.shape)}: "
          f"max abs diff {k2_err:.3e} (limit 1e-5: f32 sums in another order)")
    if not k2_err <= 1e-5:
        raise SystemExit(f"K2 differs from its plain version by {k2_err}")

    # ---- 4. the main path, counted ------------------------------------------
    step = build_forecast_step(bg, fg, height=H, width=W, out_t=OUT_T)
    reset_counts()
    out = step(pc_in, fg_in)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"[step] {H}x{W}: launches {launches}")
    if min(launches["place_min_fold"], launches["onehot_stem_conv"]) < 1:
        raise SystemExit(f"a kernel of the main path did not launch: {launches}")
    if launches["place_min"] != 0:
        raise SystemExit(f"the step launched the generic place_min: {launches}")
    painted = check_output(out, H, W)
    print(f"[step] panoptic {tuple(out['panoptic'].shape)}, ids "
          f"{out['ids'][0].tolist()}, {painted:.3f} of pixels in instances")

    # ---- 5. GPU against CPU at 256x512 ---------------------------------------
    pc_s, fg_s = make_inputs(H_SMALL, W_SMALL)
    outs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        bg_d, fg_d = make_models(d, H_SMALL, W_SMALL)
        outs[name] = build_forecast_step(
            bg_d, fg_d, height=H_SMALL, width=W_SMALL, out_t=OUT_T, device=d,
        )(pc_s, fg_s)
    ids_g, ids_c = outs["cuda"]["ids"].cpu(), outs["cpu"]["ids"]
    pan_mis = float((outs["cuda"]["panoptic"].cpu() != outs["cpu"]["panoptic"])
                    .float().mean())
    bg_mis = float((outs["cuda"]["bg_seg"].cpu() != outs["cpu"]["bg_seg"])
                   .float().mean())
    print(f"[gpu-vs-cpu] {H_SMALL}x{W_SMALL}: ids {ids_g.tolist()} vs "
          f"{ids_c.tolist()}, panoptic mismatch {pan_mis:.3e}, bg mismatch "
          f"{bg_mis:.3e}")
    if not torch.equal(ids_g, ids_c) or not pan_mis < 1e-3:
        raise SystemExit("GPU and CPU steps disagree")
    check_output(outs["cuda"], H_SMALL, W_SMALL)

    # ---- 6. timings ----------------------------------------------------------
    g64 = group.long()
    filled = torch.full((num_groups,), EMPTY, dtype=torch.int32, device=dev)
    filled1 = torch.full((T_IN * H * W,), EMPTY, dtype=torch.int32, device=dev)
    x_onehot = torch.cat([assemble_onehot(seg, 11), dep], 1)
    w_oihw = kern.permute(3, 2, 0, 1).contiguous()

    def fold():
        return place_min_fold(group, key, batch=T_IN, height=H, width=W)

    def fold_earlier():  # the forecast path's placement before the fusion
        return fold_corners(place_min(group, key, num_groups), T_IN, H, W)

    times = {
        "k1fold": time_ms(fold),
        "k1fold_plain": time_ms(lambda: place_min_fold_plain(
            group, key, batch=T_IN, height=H, width=W)),
        "k1fold_lib": time_ms(lambda: torch.scatter_reduce(
            filled1, 0, fold_tgt, fold_keys, "amin")),
        "k1fold_earlier": time_ms(fold_earlier),
        "layer": time_ms(lambda: decode_canvas(fold(), torch.int32)),
        "layer_earlier": time_ms(lambda: decode_canvas(fold_earlier(), torch.int32)),
        "k1fold_device": device_ms(fold),
        "k1fold_earlier_device": device_ms(fold_earlier),
        "layer_device": device_ms(lambda: decode_canvas(fold(), torch.int32)),
        "layer_earlier_device": device_ms(
            lambda: decode_canvas(fold_earlier(), torch.int32)),
        "k1": time_ms(lambda: place_min(group, key, num_groups)),
        "k1_plain": time_ms(lambda: place_min_plain(group, key, num_groups)),
        "k1_lib": time_ms(lambda: torch.scatter_reduce(filled, 0, g64, key, "amin")),
        "k2": time_ms(lambda: onehot_stem_conv(seg, dep, kern, bias, num_classes=11)),
        "k2_plain": time_ms(lambda: onehot_stem_conv_plain(seg, dep, kern, bias,
                                                           num_classes=11)),
        "k2_lib": time_ms(lambda: F.conv2d(x_onehot, w_oihw, bias, stride=2, padding=1)),
    }
    n_targets = fold_tgt.numel()
    del fold_tgt, fold_keys, filled1  # keep the step's peak memory its own
    step_ms = []
    for i in range(7):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        step(pc_in, fg_in)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    step_ms = sorted(step_ms[2:])
    print(f"[time] step {H}x{W} host clock (inputs from host numpy): median "
          f"{step_ms[len(step_ms) // 2]:.2f} ms, min {step_ms[0]:.2f} ms")
    stage_breakdown(step, bg, fg, pc_in, fg_in, dev)
    for k, v in times.items():
        print(f"[time] {k} {v:.4f} ms")

    # ---- 7. K3 against its plain version and K1 -----------------------------
    k3_group, k3_key, k3_groups, pk = k3_stream(dev)
    k3_err = k3_checks(k3_group, k3_key, k3_groups, pk,
                       (group, key, num_groups))

    # ---- 8. K4 against its plain versions -------------------------------------
    k4_err = k4_checks(dev)

    # ---- 9. the exact z-buffer -------------------------------------------------
    exact_zbuffer(pc_in, dev)

    # ---- 10. the K3 and K4 entry points, counted --------------------------------
    k3_launches, k4_launches = entry_points()

    # ---- 11. K3 and K4 timings ---------------------------------------------------
    # K3 against K1 on four streams: K3's own
    # (coherent: nearly every entry lands in its block's window), the
    # forecast's z-buffer stream (no window fits), whole warps on one group
    # (no window fits; runs of equal groups) and a uniform stream over the
    # forecast's canvas. Every CUDA-event time before any profiled one.
    k1_in = k1_streams(dev, (group, key, num_groups),
                       (k3_group, k3_key, k3_groups))
    calls = {}
    for name in ("k3_stream", "forecast_stream", "warp_runs", "uniform"):
        g_s, k_s, n_s = k1_in[name]
        kw = pk if name == "k3_stream" else {}
        calls[name] = (
            lambda g_s=g_s, k_s=k_s, n_s=n_s, kw=kw: place_minwin(
                g_s, k_s, num_groups=n_s, **kw),
            lambda g_s=g_s, k_s=k_s, n_s=n_s: place_min(g_s, k_s, n_s))
    k3_streams = {name: {"k3_ms": time_ms(k3_call), "k1_ms": time_ms(k1_call)}
                  for name, (k3_call, k1_call) in calls.items()}
    k3_g64 = k3_group.long()
    k3_filled = torch.full((k3_groups,), EMPTY, dtype=torch.int32, device=dev)
    times.update({
        "k3": time_ms(calls["k3_stream"][0]),
        "k3_plain": time_ms(lambda: place_minwin_plain(
            k3_group, k3_key, num_groups=k3_groups, **pk)),
        "k3_lib": time_ms(lambda: torch.scatter_reduce(
            k3_filled, 0, k3_g64, k3_key, "amin")),
        "k1_device": device_ms(lambda: place_min(group, key, num_groups)),
        "k2_device": device_ms(lambda: onehot_stem_conv(
            seg, dep, kern, bias, num_classes=11)),
        "k3_device": device_ms(calls["k3_stream"][0]),
    })
    for name, (k3_call, k1_call) in calls.items():
        k3_streams[name].update(k3_device_ms=device_ms(k3_call),
                                k1_device_ms=device_ms(k1_call))
        print(f"[time] {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in k3_streams[name].items()))
        # place_min's passes one by one: device us a call
        passes = {kernel.partition("::")[2].split("<")[0].split("(")[0]
                  or kernel: us / 10
                  for kernel, (_, us) in kernel_profile(k1_call, 10).items()}
        k3_streams[name]["k1_passes_us"] = passes
        print(f"[time] {name}: place_min passes (device us a call) "
              + json.dumps({k: round(v, 2) for k, v in passes.items()}))
    x4 = torch.arange(prof_strided_load.ROWS * prof_strided_load.COLS,
                      dtype=torch.float32, device=dev).reshape(
                          prof_strided_load.ROWS, prof_strided_load.COLS)
    k4_start = {name: start for name, _, start in prof_strided_load.CASES}
    for name, probe, start in prof_strided_load.CASES:
        times[f"k4_{name}"] = time_ms(lambda: probe(x4, start), 200, 10)
        times[f"k4_{name}_device"] = device_ms(lambda: probe(x4, start))
        times[f"k4_{name}_plain"] = time_ms(
            lambda: strided_load.strided_plain(x4, start), 200, 10)
        times[f"k4_{name}_lib"] = time_ms(
            lambda: x4[:, start::2].contiguous(), 200, 10)
        times[f"k4_{name}_lib_device"] = device_ms(
            lambda: x4[:, start::2].contiguous())
    # K4 where the bytes bound it, beside the launch floor (a one-element
    # zero_, the least a launch takes on the device)
    xl = torch.randn(prof_strided_load.LARGE, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED + 9))
    one = torch.zeros(1, device=dev)
    times["launch_floor"] = time_ms(one.zero_, 200, 10)
    times["launch_floor_device"] = device_ms(one.zero_)
    for name, probe, start in prof_strided_load.CASES:
        times[f"k4_{name}_large"] = time_ms(lambda: probe(xl, start), 50, 5)
        times[f"k4_{name}_large_device"] = device_ms(lambda: probe(xl, start), 20)
        times[f"k4_{name}_large_lib"] = time_ms(
            lambda: xl[:, start::2].contiguous(), 50, 5)
        times[f"k4_{name}_large_lib_device"] = device_ms(
            lambda: xl[:, start::2].contiguous(), 20)
    del xl
    for k, v in times.items():
        if k.startswith(("k3", "k4", "launch_floor")) or k in (
                "k1_device", "k2_device"):
            print(f"[time] {k} {v:.4f} ms")

    # ---- 12. the serving CLI, counted; 13. serve and score --------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        cli_launches, cli_readings, fixtures = cli_phase(dev, root)
        cli_files = panoptic_files(fixtures["full"][2]["cuda"]["result_dir"])
        score_readings = score_phase(dev, fixtures, card)
        staged_readings = staged_phase(dev, fixtures, card)
        refs = {}
        train_readings = train_phase(dev, root, card, refs)
        train_readings["bg"] = bg_train_phase(dev, root, card, refs)
        train_readings["dp"] = dp_phase(dev, root, card, refs)
        k2_bf16_entry, bf16_readings = bf16_phase(dev, root, card, fixtures, refs,
                                                  train_readings)
        data_readings = data_options_phase(dev, root, fixtures, refs, train_readings,
                                           cli_readings)
        native_readings = native_io_phase(root, fixtures, cli_files,
                                          secs["native_io"], train_readings, refs)
    inputs_readings = inputs_phase(dev, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as root:
        graph_readings = graph_phase(dev, root, card)

    n, g = group.numel(), num_groups
    k1_bound, k1_by = bound_ms(4 * n * 2 + 4 * g, n)
    fold_bound, fold_by = bound_ms(4 * n * 2 + 4 * T_IN * H * W, n_targets)
    k2_bytes = (seg.numel() * 4 + dep.numel() * 4 + kern.numel() * 4
                + bias.numel() * 4 + k2.numel() * 4)
    k2_bound, k2_by = bound_ms(k2_bytes, k2_flops(seg, 11))
    kernels = [
        {"name": "place_min_fold", "route": "cuda",
         "source": "panoptic_forecasting_tpu_torch/csrc/placement.cu",
         "replaces": "panoptic_forecasting_tpu/kernels/placement.py:197",
         "launches": launches["place_min_fold"], "max_abs_err": k1_fold_err,
         "ms": times["k1fold"], "plain_ms": times["k1fold_plain"],
         "bound_ms": fold_bound, "bound_by": fold_by,
         "library_ms": times["k1fold_lib"], "device_ms": times["k1fold_device"],
         "earlier_ms": times["k1fold_earlier"],
         "earlier_device_ms": times["k1fold_earlier_device"],
         "layer_ms": times["layer"], "layer_device_ms": times["layer_device"],
         "layer_earlier_ms": times["layer_earlier"],
         "layer_earlier_device_ms": times["layer_earlier_device"],
         "cli_launches": cli_launches["place_min_fold"],
         "staged_launches": staged_readings["launches"]["prepare_bg_data"]["place_min_fold"],
         "note": "ms: the kernel (an entry's two targets of a row on two "
                 "lanes of one atomic instruction); earlier_ms: place_min + "
                 "fold_corners, the forecast path before; layer adds the "
                 "label/depth decode"},
        {"name": "place_min", "route": "cuda",
         "source": "panoptic_forecasting_tpu_torch/csrc/placement.cu",
         "replaces": "panoptic_forecasting_tpu/kernels/placement.py:197",
         "launches": k3_launches["place_min"], "max_abs_err": k1_err,
         "ms": times["k1"], "plain_ms": times["k1_plain"],
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": times["k1_lib"],
         "device_ms": times["k1_device"],
         "earlier_ms": None, "earlier_device_ms": None,
         "streams": k3_streams, "one_tile_ms": one_tile_ms,
         "note": "generic canvas, tile-owned (count, partition, place), "
                 "timed on the forecast stream; earlier_ms: the earlier kernel "
                 "is no longer in the tree; its time is in PERF.md; "
                 "launches: calls of the entry point, counted on "
                 "scripts/prof_minwin.py (off the forecast path)"},
        {"name": "onehot_stem_conv", "route": "cuda",
         "source": "panoptic_forecasting_tpu_torch/csrc/stem.cu",
         "replaces": "panoptic_forecasting_tpu/kernels/stem.py:180",
         "launches": launches["onehot_stem_conv"],
         "max_abs_err": max(k2_err, k2_edge_err),
         "ms": times["k2"], "plain_ms": times["k2_plain"],
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": times["k2_lib"],
         "device_ms": times["k2_device"], "earlier_ms": None,
         "cli_launches": cli_launches["onehot_stem_conv"],
         "staged_launches": staged_readings["launches"]["bg_export"]["onehot_stem_conv"],
         "note": "earlier_ms: the previous kernel is no longer in the tree; "
                 "its time is in PERF.md"},
        k2_bf16_entry,
    ]
    n3 = k3_group.numel()
    k3_bound, k3_by = bound_ms(4 * n3 * 2 + 4 * k3_groups, n3)
    kernels.append(
        {"name": "place_minwin", "route": "cuda",
         "source": "panoptic_forecasting_tpu_torch/csrc/minwin.cu",
         "replaces": "panoptic_forecasting_tpu/kernels/experimental/minwin.py:201",
         "launches": k3_launches["place_minwin"], "max_abs_err": k3_err,
         "ms": times["k3"], "plain_ms": times["k3_plain"],
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": times["k3_lib"],
         "device_ms": times["k3_device"], "earlier_ms": None,
         "earlier_device_ms": None, "streams": k3_streams,
         "note": "ms: the whole place_minwin call, canvas and overflow from "
                 "one launch of the kernel (the overflow is counted inside "
                 "it); earlier_ms: the previous kernel is no longer in the "
                 "tree; its time is in PERF.md"})
    k4_bound, k4_by = bound_ms(x4.numel() * 4 + x4.numel() // 2 * 4, 0)
    large_elems = prof_strided_load.LARGE[0] * prof_strided_load.LARGE[1]
    k4_large_bound, _ = bound_ms(large_elems * 4 + large_elems // 2 * 4, 0)
    for name in strided_load.PROBES:
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "panoptic_forecasting_tpu_torch/csrc/strided_load.cu",
             "replaces": "scripts/prof_strided_load.py:48",
             "launches": k4_launches[name], "max_abs_err": k4_err,
             "ms": times[f"k4_{name}"], "plain_ms": times[f"k4_{name}_plain"],
             "bound_ms": k4_bound, "bound_by": k4_by,
             "library_ms": times[f"k4_{name}_lib"],
             "device_ms": times[f"k4_{name}_device"],
             "library_device_ms": times[f"k4_{name}_lib_device"],
             "large": {"shape": list(prof_strided_load.LARGE),
                       "ms": times[f"k4_{name}_large"],
                       "device_ms": times[f"k4_{name}_large_device"],
                       "library_ms": times[f"k4_{name}_large_lib"],
                       "library_device_ms": times[f"k4_{name}_large_lib_device"],
                       "bound_ms": k4_large_bound},
             "launch_floor_ms": times["launch_floor"],
             "launch_floor_device_ms": times["launch_floor_device"],
             "earlier_ms": None, "earlier_device_ms": None,
             "note": f"library call x[:, {k4_start[name]}::2].contiguous(), "
                     "the plain version's own call; at 98,304 bytes a "
                     "launch dominates, at (8192, 8192) the bytes (large); "
                     "earlier_ms: the previous kernel is no longer in the "
                     "tree; its time is in PERF.md"})
    print(f"[total] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels, "cli": {
        k: cli_readings[k] for k in ("frames", "frames_per_s", "median_ms",
                                     "png_decode_ms", "thing_pixels")},
        "score": score_readings, "staged": staged_readings, "train": train_readings,
        "bf16": bf16_readings, "data_options": data_readings,
        "native_io": native_readings, "inputs": inputs_readings,
        "graph": graph_readings}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_worker(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--inputs"]:
        sys.exit(inputs_main())
    if sys.argv[1:2] == ["--graphs"]:
        sys.exit(graphs_main())
    if sys.argv[1:2] == ["--training"]:
        sys.exit(training_main())
    sys.exit(main())
