#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (umeregrobust_tpu_torch) on one
NVIDIA GPU: `python3 chip_smoke.py` from the repository root.

Phases (any failure ends the run with a non-zero exit):
  1. device: requires CUDA, turns TF32 off, prints the card's name and
     power limit;
  2. build: compiles the port's CUDA kernels (csrc/*.cu) with nvcc;
  3. kernels: on a real suite pair's clouds, at the main path's shapes,
     each kernel against its plain PyTorch version (nn1_argmin: identical
     indices, also at ops/cuda_nn.forced_cases (ties on both sides of this
     card's segment and tile boundaries, masks, ragged sizes), with the
     device's time alone (kernel_ms, library_kernel_ms: CUDA graphs), the
     host's time to issue a call (host_ms) and the issue floor (9 fp32
     instructions a pair at the top SM clock); nn1_copy_rows (the feature
     transfer: the search, the rows copied by its merge): bit for bit its
     plain version and the three-step form it replaces (nn1_argmin, the
     mask's where, gather_padded), two launches identical, also with more
     queries and targets masked, a strided table, C = 5 and M = 1, the
     device's time alone of both forms and their kernels a call;
     ume_moments_fused: max abs error <= 1e-5 x max |out|;
     corr_scores_fused: max abs error <= 1e-4 x max |score| and the same
     argmax at every stage's shape and at forced ragged shapes (H of 1, 7,
     9; both grids; nothing in radius: exact zeros; rows without features
     parked far away), in the caller's order and cell-ordered, two
     launches bit-identical; its times with and without the ordering, the
     ordering's own time and the share of steps that need the feature
     product (g_need_share) both ways; for ume_moments_fused also forced
     cases (M of 1 and 13, N of 1 and 4500, caps of 1 / 31 / 32 / 33 / the
     hit queue's size / one more / above N, the cap over masked runs
     counted exactly, all masked and nothing in radius: exact zeros, M = 0
     without a launch; two launches bit-identical), the share of
     keypoints whose ball reaches the cap, the device's time alone
     (kernel_ms, from a CUDA graph of 20 calls), the sweep alone (kernel_ms_no_hits), the capped row
     reads alone (kernel_ms_all_capped), the rate of row reads (l2_tbps)
     and what a barrier per point tile would cost a block of 8 warps
     (tile_wait_factor); gather_rows: identical rows, at the
     main path's two shapes and the kNN scorer's step (8 x 1024 x 20 rows
     of a 10000 x 32 table; with kernel_ms, library_kernel_ms, host_ms)
     and at N = 32768, C = 32 / 128 / 512, fp32 and bf16, random and
     monotone indices, and at ragged row counts with indices -1 and N; sparse_conv_rowtile and
     sparse_conv_tapsplit, each forced: max abs error <= 2e-5 x max |out|
     with fp32 operands (sums of up to 64,000 fp32 products in another
     order) and <= 1e-4 x max |out| with bf16-rounded operands, at N =
     32768, C = 32, K = 27 (int32 map), at a ragged small shape and at
     three layers of the ResUNet pyramid of the nominal pair (int64
     maps)), with CUDA-event times (median of 20 after warm-up)
     of kernel, plain version and, where one PyTorch call computes the
     same function, that call; and each kernel's bound; then every conv
     launch of the ResUNet forward (11) and of the ResUNetSmall2
     conv_impl="scan" forward (18) on the nominal pair with its own map
     and features (conv_layer_row: both kernels, the old FMA tile, bound,
     library route), and nine forced conv maps (conv_forced_cases: an
     empty tap, a tile with one valid row, an all-valid map, input rows
     hit many times a tap (entries past the tap kernel's scratch),
     indices >= N_in with N_out > N_in, Cin 1 / 3 / 320 / 384 / 768, Cout
     32 / 48 / 128 / 1024, int32 and int64), fp32 and bf16, both kernels, two
     launches bit-identical, the entry lists equal to their plain twin;
     then the grouped k3 conv kernel sparse_conv_grouped
     (phase_grouped_layers): every grouped layer of a ResUNetSmall2
     one-pair forward (18; grouped_layer lines: against
     sparse_conv_grouped_plain on the card within 1e-4 (bf16) / 1e-5
     (fp32) x max |out|, two launches bit-identical, the same bits in
     four row orders (the map's, code order, reversed, random), the
     output and bf16 copies between guards, the plan (cluster, channel
     tile) and the map's tiles against the windows they stage, device
     time alone at bf16 and fp32 beside the parent tree's kernel
     (csrc/bench/sparse_conv_grouped_parent.cu, built here) on the same
     inputs, one call an event pair, the plain version's time, the bound,
     the library route (a gather of the 27 tap rows + one torch.mm) and
     the per-tap kernel on the same map), the row-order kernel
     grouped_row_order on the one-pair and the B = 4 pyramid's 13 maps in
     one launch each (grouped_order_row: order and tiles equal to the
     plain version's, two launches identical, times beside the parent
     tree's three launches a map, csrc/bench/grouped_row_order_parent.cu,
     built here; host time; bound) and at forced maps
     (row_order_forced_cases: 1, 64, 65, 1024, 1025 rows, all masks
     zero, all 512 keys, masks at an odd address, more rows than shared
     memory keeps keys for, a map twice in a list, the cap of maps a
     launch), the same layers of the
     four regime pairs as one B = 4 forward (each pair's rows the bits of
     its one-pair call; the parent's kernel timed beside), and forced
     cases (grouped_forced: Cin 1 / 3 / 16 / 20 / 24 / 32 / 64 / 96 / 256
     / 768, Cout 5 / 7 / 32 / 48 / 64 / 256, clusters of 1 to 4 CTAs,
     N_out < N_in and > N_in, tiles whose rows use different groups, a
     group whose one user the order puts in the last tile, an unused tile
     and group, patho rows, the transposed slot order, int32 and int64
     centres, bias); then the ball query ball_query (phase_ball_query:
     against ball_query_plain on the card index for index at
     ops/cuda_ball.forced_cases, points within a few fp32 steps of the
     radius and a pair axis of three; then the training keypoint
     selection's three calls a pair on four HDL-64 pairs at
     train_kitti_config's 100000-row clouds, ball_query_call lines with
     the mismatches, device time alone, one call an event pair, the plain
     version's ms and the bound from the radius tests and bytes the inputs
     need, and the four intersection calls as one launch); then the SO(3)
     solver kabsch_rotation (phase_kabsch: against kabsch_rotation_plain
     on the card bit for bit at ops/cuda_so3.forced_cases and random H at
     n = 8, 20000 and 262144, 3 and 6 sweeps each, one launch a call;
     kabsch_call lines with the mismatches, device time alone, one call an
     event pair, the plain version's ms and the bound); then the pair
     axis at B = 4 (the four regime pairs, phase_pair_axis):
     nn1_argmin, nn1_copy_rows (against the three-step form too),
     ume_moments_fused and corr_scores_fused (four stage
     shapes) with a leading pair axis, and gather_rows over the flattened
     table, each pair bit-identical to its B = 1 call, the batch against
     the plain version, kernel_ms (CUDA graph) at B = 1 and B = 4 and the
     bound at B = 4; then both kernels at feature widths C = 8, 16, 64
     (width_cases: ume_moments_fused at 2048 keypoints of the nominal
     pair's SEM grid, r 5, cap 750, within 1e-5 x max |out|;
     corr_scores_fused at the arbiter's 17 x 2048 x 2048, within 1e-4 x
     max |score|; two launches bit-identical);
  4. reference: the small pair through the whole path on the card and on
     the CPU (plain versions) with the same injected draws: the same
     transforms;
  5. end to end: one pair per regime of the reduced operating point
     (bench.py's suite, tuning seeds 100 + 37 r), through
     register_pair_e2e with the in-repo weights after the ICP occupancy
     pre-check and a warm-up pair: RRE/RTE and kernel launches per pair,
     pairs/s, peak device memory; the nominal pair must pass NP
     (RRE <= 1.5 deg, RTE <= 0.6 m);
  5b. family: ResUNet (k7 stem, stride 4, k5 layers, 'BN' blocks; seeded
     random parameters) at full width through register_pair_e2e on the
     nominal pair with its default level capacities: finite transforms,
     unit-norm features, launches of gather_rows and of both conv kernels,
     which layer took which conv kernel, valid rows per level; the same
     model's features on a small cloud, card vs CPU plain versions at fp32
     (max abs <= 1e-4); one ResUNet5 feature stage (grouped and per-tap
     layers in one model);
  5c. scan: ResUNetSmall2 with the in-repo weights and conv_impl="scan"
     (every conv through the per-tap kernels) over phase 5's pairs and
     seeds: the same NP/SP verdict per pair as the grouped run;
  5d. batched: register_pairs_batched (ResUNetSmall2, reduced point)
     on the four regime pairs (B = 4) and on the eight pairs
     tuning_seed(regime, i), i in {0, 1} (B = 8), each after a warm-up
     batch and alternated with register_pair_e2e in one process (pair i
     seeded i both ways; ICP's budget escalated over all eight): per
     pair RRE / RTE, verdicts and |T_batched - T_seq|, per batch pairs/s
     of both paths, kernel launches per pair, peak device memory; fails
     on a verdict that differs, |dT_init| > 1e-4, or a main-path kernel
     launched other than once a call site for the batch; both batches
     once more through BlockMatmulProbe (the forward's per-pair dense
     products against one torch.bmm, bit for bit); the grouped k3 conv
     against its plain version's form, as the tree before the grouped
     kernel ran it ("parent" in the lines; phase_grouped_ab: parent,
     change, change, parent; pairs/s one at a time and as one batch, feature
     stage ms, every pair's NP / SP verdict the same in every round, the
     features at fp32 operands within 1e-3 x max of the parent's; at bf16
     their difference and bit-equality reported beside the per-tap
     kernels' difference from the parent's form);
     ResUNet (seeded random
     parameters, full widths) on the nominal and rotheavy pairs through
     pair_features_batched: each pair's features within 1e-4 of its own
     call (level 1 fills), the run's launches counted as their own path
     ("batched_resunet"), each of its 11 per-tap conv launches against
     sparse_conv_plain and timed beside the pairs' own launches;
  5e. hungarian: the nominal pair through register_pair_hungarian
     (features from pair_features_e2e): RRE / RTE, the host assignment's
     and the pair's seconds; held to a finite rigid transform;
  5f. config_paths: the remaining RegistrationConfig paths on the four
     regime pairs at the reduced point (CONFIG_PATHS: corr_mode="knn",
     feat_copy_radius=0.6, icp_inner=1, filter_by_ume_dist=False,
     sr_kpts=1024 with sr_gate_inliers=2.0, and the CLI's PARITY_PROFILE
     whole), each pair alone through register_pair_e2e after a warm-up
     pair, then the four as one batch through register_pairs_batched:
     per pair and knob RRE / RTE, verdict, seconds and kernel launches;
     fails on a non-finite or non-rigid transform, a batched verdict that
     differs from the one-pair one or |dT_init| > 1e-4, or a kernel of
     the knob's path that never launched;
  5g. cli: umeregrobust_tpu_torch.cli.evaluate.main in this process at
     the full kitti_test configuration (SEM cap 50000, correlator cap
     10000, 10000 keypoints, 2500 hypotheses, raw ICP stage at 131072) on
     3 synthetic pairs with the in-repo weights, then CLI_PARITY_PAIRS
     pairs with --set parity=true: NP / SP, pairs/s (pair 0 excluded),
     per pair the host prep's and the pipeline's seconds, peak device
     memory, the escalations and the kernels launched; fails on a
     non-finite transform or a kernel of the path that never launched;
  5h. datasets: in a temporary directory, KITTI-layout scans of the
     first 3 pairs of kitti/test and one nuScenes-layout pair of
     nuscenes/test (write_dataset_tree: make_pair lidar scenes at HDL-64
     density, the target moved by the registry's ground truth, nuScenes
     with ego-vehicle returns and string log names); the SEM preprocessing
     CLI over --range_idxs 0 3 at 125,000 SEM points a scan, run twice
     (the second must write nothing); the evaluate CLI's dataset mode at
     the full kitti_test configuration on the cache (raw scans for the
     correlator, corr_no_nksr) with the in-repo weights as .pkl and as a
     MinkowskiEngine .pth (every pair's transform bit-identical); one
     nuScenes pair preprocessed at test_nuscenes (the ego box dropped);
     NP / SP, pairs/s, host prep and pipeline seconds, peak memory and
     kernel launches a pair; then rtume_estimate on pair 0's features
     (phase_rtume: 512 sample_smart_keypoints keypoints, r 5, cap 750;
     diagonal, 4096 random triplets, the 512 x 512 grid) on the card
     against its CPU run, ms a call and ume_moments_fused launches;
  5i. widths: register_pair_e2e and rtume_estimate with a seeded random
     ResUNetSmall2 at out_channels 16 and 64 on the nominal pair: finite
     transforms, the moments and scorer kernels launched;
  5j. train (phase_train): (a) gather_rows_backward (forced cases:
     indices -1 and >= N, rows hit thousands of times, N = 1 and 3, int32
     indices, nothing valid; and the training UMEs' gathers of a B = 8
     batch; bit for bit against the plain version on the CPU, two
     launches identical, its row segments equal to row_segments_plain's),
     gather_rows and its backward at the grouped convs' window gathers of
     a B = 8 training forward and backward as the parent tree trained
     (window_gathers: its backward's recompute gathered them; this tree's
     training gathers no window); the conv with the most
     table rows and the widest, bit for bit; the forward beside
     index_select and its bound), and at the UME shape and both window
     shapes the backward's time device alone, each of its launches',
     index_add_'s and the plain version's, the bound, the longest row
     segment and the count and placement in three forms, atomic rank /
     warp-aggregated / plain atomics (gather_backward_shape,
     row_count_forms); the backward kernels and ResUNetSmall2's grouped
     convs at B = 8 (18 forwards, 17 dX, 18 weight gradients) launched
     back to back with no synchronize, round after round with the ResUNet
     pyramid rebuilt behind them, their outputs and scratch between
     guards that must stay unwritten, every round's bits the first's,
     then the grouped conv's weight-tile cache across an in-place update
     of a layer's weights (backward_stress);
     sparse_conv_wgrad (forced maps at fp32 / bf16, among them channel
     counts that are no multiple of 8 and an odd Cout; each of ResUNet's
     11 conv layers on its real map at bf16, with dX through the inverted map against the plain
     version's), per layer the plan, device times of the function, of
     each launch and of the first port's CUDA-core kernel in the same
     call, beside per-tap index_select + torch.mm and the bound; the
     grouped k3 conv's backward at ResUNetSmall2's 18 layers of a B = 8
     training forward (grouped_bwd_layer lines: dW by
     sparse_conv_grouped_wgrad and, but for the stem, dX by
     sparse_conv_grouped over the adjoint map, each against its plain
     version on the card at fp32 (1e-5 x max) and bf16 (one bf16 ulp of
     the entry or 1e-4 x max), two launches bit-identical, guards intact;
     device times alone beside the parent tree's recompute, the per-tap
     route on the same maps, the library route and the bound; dW's time
     beside the parent tree's weight-gradient kernel
     (csrc/bench/sparse_conv_grouped_wgrad_parent.cu, built by this
     script; it rounds dY, so only its time is compared), the per-tap
     route's dW alone, the windows dW stages against those used and its
     plan; the layer's
     B = 8 training forward against its plain version, its device time
     and bound; the parent tree's grouped kernel's forward and dX on the
     same inputs in the same call) and forced
     cases (grouped_wgrad_forced: Cin 1 / 2 / 3 / 20 / 768 (the packed
     stem, with and without its one bulk copy of dY; many column
     blocks), Cout 5 / 7 / 48 / 200 / 256, N_out above and below N_in,
     unused groups and rows, a group whose one user is in the order's
     last tile, tiles of mixed masks, patho rows, both slot orders,
     int32 / int64, an all-masked level, a map with and without its row
     order: the same bits), and the row order of the B = 8 training
     pyramid in one launch (grouped_order_row); (b)
     ResUNetSmall2 (in-repo weights) at train_kitti_config's widths (B =
     8, 16384 voxels a cloud, 512 matches, 256 UME keypoints, max_nn 750,
     min_nn 300, r 5, bf16) on HDL-64 density pairs: step ms, peak
     memory, losses, nonfinite_grad and launches a step, then one step
     under torch.profiler (device busy ms, idle share, the top ops), then
     against the parent tree's grouped conv backward (its recompute;
     train_grouped_ab: parent, change, change, parent: ms a step, peak
     memory, launches and window gathers a step, losses, and one
     profiled step each: kernels, aten::mm calls, device busy); the
     counted steps must gather no window; one
     pair card vs CPU at fp32 (losses 1e-3 relative, every gradient leaf
     elementwise within 1e-4 of its max |grad|); (c) ResUNet (seeded
     random parameters, k7 stem, k5 layers) at B = 2, the three conv
     kernels forward and backward, step ms and one profiled step; (d)
     the train CLI on a KITTI-layout tree (2 train, 2 val pairs, batch 2,
     1 epoch) and its last_epoch_checkpoint.pkl in the evaluate CLI;
  5k. parallel (phase_parallel, one line a part): on a one-rank NCCL
     mesh (a file store in a temporary directory), (a) the points-sharded
     UME at 2048 keypoints x 16384 points of the nominal pair (C 32, r 5,
     cap 750) bit for bit against ume_from_ball_query; (b) 4 and 8 'sp'
     blocks emulated in one process through local_moments with the
     per-keypoint caps, within 1e-5 x max |F| of the one-device kernel,
     and the global-order case (every point in radius, max_nn 100 over 8
     blocks: m0 = 100); (c) the kernel's caps: full(max_nn) bit for bit
     as caps=None, random caps against the plain version, cap-0 rows
     zero, device ms with and without caps; (d) ResUNetSmall2 at
     train_kitti_config, B = 8: two data-parallel steps on the mesh bit
     for bit against two without it (and a repeat without it), ms a
     step; (e) the hash-grid NN at the CLI's raw ICP size (131072 target
     and query points of an HDL-64 pair, r 0.4 m, budget 32): the card
     against its CPU run bit for bit and against dense_nn_query where the
     budget is exact, a voxel-key table with every key found, build and
     lookup ms and probe rounds; (f) the native host ops against numpy /
     scipy (quantize and nn_radius on the scan, a 2500 x 2500
     Hungarian);
  5l. train_synthetic (phase_train_synthetic, one line a part): (a) the
     synthetic pretraining CLI (cli/train_synthetic.main) in-process from
     scratch at the tool's full width (B = 4, 8192 voxels a cloud, bf16,
     128 UME keypoints of 512 neighbours at most), 8 scenes, 10 steps,
     launch counts set to 0 just before it: every loss finite,
     non-finite steps, ms a step after the first, launches and kernels a
     step, peak memory; (b) --resume weights/synthetic_pretrain.pkl for 2
     steps; (c) the new pickle through load_model, the nominal pair
     registered (the verdict printed, not judged); (d) at the tool's
     shapes: every grouped k3 layer's forward, dX and dW against its plain
     version (one train_synthetic_grouped_layer line each), the row order
     on the step's pyramid, gather_rows and gather_rows_backward at the
     training UMEs' gather shape bit for bit;
  6. profile (only with --profile): the same pairs, seeds and config
     again under torch.profiler, with the grouped model (and with the
     plain version's grouped conv, "grouped_parent"), the
     conv_impl="scan" model and ResUNet (seeded random parameters), the
     last two also with the old conv kernels (OldConvKernels): per
     pipeline stage (register_pair_e2e's
     record_function ranges) host ms and the device ms of the kernels
     inside it, device busy ms, the idle share of the profiled wall and,
     as an estimate combining two runs, of phase 5's unprofiled wall;
     kernel launches and the top ops by device time; then phase 5d's
     two batches through register_pairs_batched (models "batched", B = 4,
     and "batched_x2", B = 8; per pair), again with the plain version's
     grouped conv ("batched_parent", "batched_x2_parent").
The kernels' JSON line comes second to last; the last line is
{"ok": true, "device": {...}}.

Usage (repo root): python3 chip_smoke.py [--profile]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_PEAK = 67e12  # H100 SXM fp32 (non-tensor) FLOP/s, NVIDIA data sheet
BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor FLOP/s, NVIDIA data sheet
HBM_BW = 3.35e12  # H100 SXM HBM3 bytes/s
KERNELS = {  # name -> (source, replaced TPU kernel)
    "nn1_argmin": ("umeregrobust_tpu_torch/csrc/nn1_argmin.cu",
                   "umeregrobust_tpu/ops/pallas_nn.py:63"),
    # the feature transfer: the same search, the rows copied by its merge
    # (it takes the gather_rows launch of tools/exp_gather2.py:107 `pg`
    # at feat_to_raw into the nn1 kernel's merge)
    "nn1_copy_rows": ("umeregrobust_tpu_torch/csrc/nn1_argmin.cu",
                      "umeregrobust_tpu/ops/pallas_nn.py:63"),
    "ume_moments_fused": ("umeregrobust_tpu_torch/csrc/ume_moments.cu",
                          "umeregrobust_tpu/ops/pallas_ume.py:101"),
    "corr_scores_fused": ("umeregrobust_tpu_torch/csrc/corr_scores.cu",
                          "umeregrobust_tpu/ops/pallas_corr.py:91"),
    "gather_rows": ("umeregrobust_tpu_torch/csrc/gather_rows.cu",
                    "tools/exp_gather2.py:107"),
    "sparse_conv_tapsplit": ("umeregrobust_tpu_torch/csrc/sparse_conv_taps.cu",
                             "tools/exp_pallas_gather.py:74"),
    "sparse_conv_rowtile": ("umeregrobust_tpu_torch/csrc/sparse_conv_taps.cu",
                            "tools/exp_pallas_gather.py:107"),
    # the backward kernels (training): the TPU kernels they stand beside
    # had theirs from JAX's autodiff of the gather (a scatter-add)
    "gather_rows_backward": ("umeregrobust_tpu_torch/csrc/gather_rows.cu",
                             "tools/exp_gather2.py:107"),
    "sparse_conv_wgrad": ("umeregrobust_tpu_torch/csrc/sparse_conv_taps.cu",
                          "tools/exp_pallas_gather.py:74"),
    # a hand kernel for a plain-XLA part (the JAX default's grouped k3 conv,
    # a lax.scan): it takes the gather kernel's window gathers into its
    # products
    "sparse_conv_grouped": ("umeregrobust_tpu_torch/csrc/"
                            "sparse_conv_grouped.cu",
                            "tools/exp_gather2.py:107"),
    # its weight gradient (training; dX runs sparse_conv_grouped over the
    # adjoint map): it takes the backward of the window gathers (the
    # gather_rows_backward kernel after the plain version's recompute)
    # into its products
    "sparse_conv_grouped_wgrad": ("umeregrobust_tpu_torch/csrc/"
                                  "sparse_conv_grouped_wgrad.cu",
                                  "tools/exp_gather2.py:107"),
    # the grouped conv's row order (its tile plan, once a map): part of the
    # grouped conv's design, so it stands beside the same TPU-side source
    "grouped_row_order": ("umeregrobust_tpu_torch/csrc/grouped_row_order.cu",
                          "tools/exp_gather2.py:107"),
    # a hand kernel for a plain-XLA part (the JAX ball query, a lax.scan of
    # distance tiles and top-k selections): the training keypoint selection
    "ball_query": ("umeregrobust_tpu_torch/csrc/ball_query.cu",
                   "umeregrobust_tpu/ops/neighbors.py:68"),
    # a hand kernel for a plain-XLA part (the JAX SO(3) solver, Horn's 4x4
    # and fixed Jacobi sweeps): ICP's umeyama, the consensus refit and
    # polish and the UME estimator
    "kabsch_rotation": ("umeregrobust_tpu_torch/csrc/kabsch.cu",
                        "umeregrobust_tpu/core/so3.py:95"),
}
FORWARD_KERNELS = ("nn1_argmin", "ume_moments_fused", "corr_scores_fused",
                   "gather_rows", "sparse_conv_tapsplit", "sparse_conv_rowtile")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=20, warmup=3, inner=1):
    """Median CUDA-event time of fn() in ms. With inner > 1 an event pair
    spans that many calls back to back and the time is per call: the
    queue stays full, so the host's time to launch is left out."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def capture(fn, inner=20):
    """`inner` calls of fn() captured in one CUDA graph, after a warm-up
    call on a side stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return graph


def graph_ms(fn, reps=7, inner=20):
    """Median CUDA-event time in ms of one fn() among `inner` captured in
    one CUDA graph and replayed: the device's time alone, however long the
    host takes to launch (time_ms with inner > 1 reads the host's time
    where that is the longer)."""
    return time_ms(capture(fn, inner).replay, reps=reps) / inner


def kernel_split_ms(fn, calls=20):
    """Mean device ms a call of each CUDA kernel (and memset) that fn()
    launches, over `calls` calls (torch.profiler's device events, as
    profile_step reads them), by kernel name (the launches of one name,
    template instances included, added). A session that reports no device
    event is made once more ({} if that one reports none either)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            m = re.search(r"\w+_kernel|Memset", e.name)
            if m and e.device_type == torch.autograd.DeviceType.CUDA:
                out[m.group()] = (out.get(m.group(), 0.0)
                                  + e.time_range.elapsed_us() / calls / 1e3)
        if out:
            break
        log("kernel_split_ms: no device event in a profiler session")
    return out


def sm_clock_under_load(fn, seconds=1.0):
    """nvidia-smi's SM clock (MHz) read halfway through `seconds` of fn()
    run back to back from a CUDA graph."""
    import threading

    import torch

    graph, got = capture(fn), []
    reader = threading.Thread(target=lambda: (time.sleep(seconds / 2),
                                              got.append(smi("clocks.sm"))))
    reader.start()
    t0 = time.time()
    while time.time() - t0 < seconds:
        graph.replay()
    torch.cuda.synchronize()
    reader.join()
    return float(got[0].split()[0])


def host_ms(fn, calls=200):
    """The host's time in ms to issue one fn(): `calls` calls back to back
    with no synchronisation between them, over the count (the wrapper's
    Python work and the launch; the device runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def smi(query):
    """One nvidia-smi reading, e.g. "name,power.limit", of the card that
    CUDA calls device 0 (picked by its UUID, whatever
    CUDA_VISIBLE_DEVICES selects)."""
    import torch

    uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
    return subprocess.run(
        ["nvidia-smi", "-i", uuid, f"--query-gpu={query}",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


_KEY_TABLES = {}  # device -> (cell index -> its share of the key, offsets)


def cell_order(pts4, cell):
    """Permutation (N,) int64 that lists the rows of `pts4` (N, >= 3) cell
    by cell (edge `cell`, 2^10 cells an axis around the origin, clamped)
    along a Morton curve over x and y, a column's cells by z: neighbouring
    rows end up in one warp of corr_scores_fused. The key comes from one
    table lookup (made once per device), then one stable sort. A
    measurement aid: the port's main path orders nothing."""
    import torch

    if pts4.device not in _KEY_TABLES:
        v = torch.arange(1024)
        spread = torch.zeros(1024, dtype=torch.int64)
        for b in range(10):
            spread |= ((v >> b) & 1) << (2 * b)
        _KEY_TABLES[pts4.device] = (
            torch.cat([spread << 10, spread << 11, v]).to(pts4.device),
            (torch.arange(3) * 1024).to(pts4.device))
    table, offs = _KEY_TABLES[pts4.device]
    q = (pts4[:, :3].float() / float(cell) + 512.0).clamp_(0.0, 1023.0).long()
    return torch.sort(table[q + offs].sum(dim=1), stable=True).indices


def bound_ms(n_bytes, n_ops, peak=F32_PEAK):
    t_b, t_o = n_bytes / HBM_BW * 1e3, n_ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def ptxas_report(source="sparse_conv_taps.cu"):
    """ptxas's registers, spills and shared memory per kernel of one
    source, from the build's build.log (kernel name from the mangled
    symbol, template arguments dropped)."""
    import re

    from umeregrobust_tpu_torch.ops import _build

    def demangle(sym):  # "..14entries_kernelILb1EiEEv.." -> entries_kernel<true,int32>
        # (float and float4 arguments too: seg_sum_kernel<32,float4>)
        pos = 0
        while pos < len(sym):  # length-prefixed names, read in order
            m = re.match(r"\d+", sym[pos:])
            if m is None:
                pos += 1
                continue
            start = pos + m.end()
            ident = sym[start:start + int(m.group())]
            pos = start + len(ident)
            if ident.endswith("_kernel"):
                rest = sym[pos:]
                if not rest.startswith("I"):
                    return ident
                args = re.findall(
                    r"Lb([01])E|Li(\d+)E|6(float4)|([ilf])(?=[EL6])",
                    rest[1:rest.index("EE") + 1])
                types = {"i": "int32", "l": "int64", "f": "float"}
                return ident + "<" + ",".join(
                    ("true" if b == "1" else "false") if b else n or v
                    or types[t] for b, n, v, t in args) + ">"
        return sym

    log = (_build.BUILD_DIR / "build.log").read_text()
    part = log.split(f"== {source}")[1].split("\n== ")[0]
    out, name = {}, None
    for line in part.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.setdefault(name, {}).update(
                registers=int(m.group(1)),
                static_smem_bytes=int(m.group(2) or 0))
    return out


def launch_counts():
    """Every kernel wrapper's launch count."""
    from umeregrobust_tpu_torch.ops import (
        cuda_ball, cuda_conv, cuda_corr, cuda_gather, cuda_grouped, cuda_nn,
        cuda_so3, cuda_ume)

    return {"nn1_argmin": cuda_nn.LAUNCHES,
            "ball_query": cuda_ball.LAUNCHES,
            "kabsch_rotation": cuda_so3.LAUNCHES,
            "nn1_copy_rows": cuda_nn.LAUNCHES_COPY,
            "ume_moments_fused": cuda_ume.LAUNCHES,
            "corr_scores_fused": cuda_corr.LAUNCHES,
            "gather_rows": cuda_gather.LAUNCHES,
            "gather_rows_backward": cuda_gather.LAUNCHES_BACKWARD,
            **cuda_conv.LAUNCHES, **cuda_grouped.LAUNCHES}


def reset_launch_counts():
    from umeregrobust_tpu_torch.ops import (
        cuda_ball, cuda_conv, cuda_corr, cuda_gather, cuda_grouped, cuda_nn,
        cuda_so3, cuda_ume)

    for m in (cuda_nn, cuda_ume, cuda_corr, cuda_gather, cuda_ball,
              cuda_so3):
        m.LAUNCHES = 0
    cuda_gather.LAUNCHES_BACKWARD = 0
    cuda_nn.LAUNCHES_COPY = 0
    for d in (cuda_conv.LAUNCHES, cuda_grouped.LAUNCHES):
        for k in d:
            d[k] = 0


UME_QUEUE = 128  # ume_moments.cu's per-warp hit queue (kQueue)


def ume_forced_cases(dev):
    """ume_moments_fused against ume_moments_plain at forced shapes and
    caps: max abs error <= 1e-5 x max |out| (the plain version sums the
    rows in another order), two launches bit-identical, exact equality
    where the data are integers or nothing is selected. Returns the
    per-case results and whether all passed."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_ume

    gen = torch.Generator(device=dev).manual_seed(5)

    def random_case(M, N, max_nn, radius=3.0, shift=0.0, mask_p=0.85):
        pts = (torch.rand(N, 3, generator=gen, device=dev) * 2 - 1) * 6
        kp = pts[torch.randint(N, (M,), generator=gen, device=dev)] + 0.1
        Z = torch.randn(N, 128, generator=gen, device=dev)
        pm = torch.rand(N, generator=gen, device=dev) < mask_p
        return kp + shift, pts, Z, pm, radius, max_nn

    def counting_case(M, N, max_nn, masked_runs):
        # every point in radius; Z[:, 0] = n and Z[:, 1] = 1 say which rows
        # were summed: exactly the first max_nn valid indices
        pm = torch.ones(N, dtype=torch.bool, device=dev)
        for a, b in masked_runs:
            pm[a:b] = False
        Z = torch.zeros(N, 128, device=dev)
        Z[:, 0] = torch.arange(N, device=dev)
        Z[:, 1] = 1.0
        first = torch.nonzero(pm)[:max_nn, 0]
        want = torch.zeros(M, 128, device=dev)
        want[:, 0], want[:, 1] = float(first.sum()), float(first.numel())
        return (torch.zeros(M, 3, device=dev), torch.zeros(N, 3, device=dev),
                Z, pm, 1.0, max_nn), want

    Q = UME_QUEUE
    cases = {  # name -> (inputs, exact expected output or None)
        "M1_N3000": (random_case(1, 3000, 50), None),
        "M13_N3000": (random_case(13, 3000, 50), None),
        "M40_N1": (random_case(40, 1, 5, mask_p=2.0), None),
        "M40_N4500_ragged": (random_case(40, 4500, 200, radius=5.0), None),
        **{f"cap{c}": (random_case(64, 2500, c, radius=5.0), None)
           for c in (1, 31, 32, 33, Q, Q + 1)},
        "cap_above_N": (random_case(64, 2500, 4000, radius=5.0), None),
        "none_in_radius": (random_case(64, 2500, 50, shift=1e3),
                           torch.zeros(64, 128, device=dev)),
        "all_masked": (random_case(64, 2500, 50, mask_p=-1.0),
                       torch.zeros(64, 128, device=dev)),
        **{f"count_first_{c}_masked_runs": counting_case(
            8, 4500, c, [(10, 20), (25, 40), (60, 70), (2040, 2060)])
           for c in (1, 33, Q + 1, 2100, 5000)},
    }
    res, ok_all = {}, True
    for name, (args, exact) in cases.items():
        a = cuda_ume.ume_moments_fused(*args)
        a2 = cuda_ume.ume_moments_fused(*args)
        b = cuda_ume.ume_moments_plain(*args)
        torch.cuda.synchronize()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        ok = err <= 1e-5 * scale and torch.equal(a, a2)
        if exact is not None:
            ok = ok and torch.equal(a, exact) and torch.equal(b, exact)
        res[name] = dict(max_abs_err=err, scale=scale, exact=exact is not None,
                         ok=bool(ok))
        ok_all &= bool(ok)
    before = cuda_ume.LAUNCHES
    kp, pts, Z, pm, r, c = random_case(4, 100, 5)
    empty = cuda_ume.ume_moments_fused(kp[:0], pts, Z, pm, r, c)
    ok = tuple(empty.shape) == (0, 128) and cuda_ume.LAUNCHES == before
    res["M0_no_launch"] = dict(ok=ok)
    return res, ok_all and ok


def three_step_copy(q, qm, p, pm, table):
    """The feature transfer as the parent tree made it: nn1_argmin, the
    mask's where, then gather_padded (at a pair axis: the pairs' index
    offsets into the flattened table, then one gather_rows)."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_nn
    from umeregrobust_tpu_torch.ops.neighbors import gather_padded

    idx = cuda_nn.nn1_argmin(q, p, pm)
    return gather_padded(table, torch.where(qm, idx, torch.full_like(idx,
                                                                     -1)))


def bit_mismatches(a, b):
    """Entries of two fp32 tensors whose bits differ."""
    import torch

    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def copy_rows_case(q, qm, p, pm, table, timed=True):
    """nn1_copy_rows on one input ([B,] M queries, [B,] N points, a ([B,]
    N, C) table) against its plain version and against the three-step
    form it replaces, bit for bit, two launches identical; with `timed`
    the device's time alone of both forms (CUDA graphs), one call an
    event pair, the plain version's time, CUDA kernels a call
    (torch.profiler) and the bound (the search's operations; the rows'
    bytes are ~0.5 MB a pair)."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_nn

    def fused():
        return cuda_nn.nn1_copy_rows(q, qm, p, pm, table)

    a, b = fused(), fused()
    plain = cuda_nn.nn1_copy_rows_plain(q, qm, p, pm, table)
    three = three_step_copy(q, qm, p, pm, table)
    torch.cuda.synchronize()
    B = q.shape[0] if q.dim() == 3 else 1
    M, N, C = q.shape[-2], p.shape[-2], table.shape[-1]
    res = dict(shape=f"{B}x{M} queries, {B}x{N}x{C} table",
               table_strides=list(table.stride()),
               masked_queries=int((~qm).sum()),
               masked_targets=int((~pm).sum()),
               mismatches_vs_plain=bit_mismatches(a, plain),
               mismatches_vs_three_step=bit_mismatches(a, three),
               two_launches_identical=bit_mismatches(a, b) == 0)
    res["ok"] = (res["mismatches_vs_plain"] == 0
                 and res["mismatches_vs_three_step"] == 0
                 and res["two_launches_identical"])
    if timed:
        bb, by = bound_ms(B * (M * 13 + N * 13 + 2 * M * C * 4), B * M * N * 9)
        res.update(
            kernel_ms=graph_ms(fused),
            three_step_kernel_ms=graph_ms(
                lambda: three_step_copy(q, qm, p, pm, table)),
            ms=time_ms(fused),
            three_step_ms=time_ms(lambda: three_step_copy(q, qm, p, pm,
                                                          table)),
            plain_ms=time_ms(lambda: cuda_nn.nn1_copy_rows_plain(
                q, qm, p, pm, table), reps=5, warmup=1),
            kernels=count_kernels(fused)[0],
            three_step_kernels=count_kernels(
                lambda: three_step_copy(q, qm, p, pm, table))[0],
            bound_ms=bb, bound_by=by)
    return res


def phase_kernels(dev, model, pair, cfg):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch

    from umeregrobust_tpu_torch.models.resunet import build_unet_geometry
    from umeregrobust_tpu_torch.ops import cuda_corr, cuda_nn, cuda_ume
    from umeregrobust_tpu_torch.ops.neighbors import sqdist3
    from umeregrobust_tpu_torch.pipeline.consensus import compact_structure
    from umeregrobust_tpu_torch.pipeline.correlator import (
        _radius_inputs, prepare_weighted_features)
    from umeregrobust_tpu_torch.pipeline.registration import (
        copy_features_to_raw)
    from umeregrobust_tpu_torch.pipeline.sampling import weighted_sample

    s = {k: torch.as_tensor(v).to(dev) for k, v in pair["src"].items()}
    tg = {k: torch.as_tensor(v).to(dev) for k, v in pair["tgt"].items()}
    with torch.no_grad():
        geom = build_unet_geometry(s["coords"], s["mask"], model.arch,
                                   (16384, 10240, 4096, 1280, 256))
        feat = model(geom, s["mask"][:, None].float(), torch.bfloat16)
        geom = build_unet_geometry(tg["coords"], tg["mask"], model.arch,
                                   (16384, 10240, 4096, 1280, 256))
        tfeat = model(geom, tg["mask"][:, None].float(), torch.bfloat16)
    out = {}

    # --- nn1_argmin: corr points (4096) vs SEM grid (16384)
    q, p, pm = s["corr_pts"], s["grid"], s["mask"]
    a = cuda_nn.nn1_argmin(q, p, pm)
    b = cuda_nn.nn1_argmin_plain(q, p, pm)
    torch.cuda.synchronize()
    mism = int((a != b).sum())
    parked = torch.where(pm[:, None], p, torch.full_like(p, 1e9))
    M, N = q.shape[0], p.shape[0]
    bb, by = bound_ms(M * 12 + N * 13 + M * 8, M * N * 9)
    # the issue floor: the kernel must not fuse a multiply into an add (the
    # bits of the plain version), so a pair is 8 fp32 instructions and a
    # compare, one instruction a lane and clock on every SM at its top clock
    # (the published 67 TFLOP/s counts a fused multiply-add as two)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out["nn1_argmin"] = dict(
        shape=f"{M}x{N}", max_abs_err=float(mism), mismatches=mism,
        ok=mism == 0,
        ms=time_ms(lambda: cuda_nn.nn1_argmin(q, p, pm)),
        plain_ms=time_ms(lambda: cuda_nn.nn1_argmin_plain(q, p, pm)),
        library_ms=time_ms(lambda: torch.cdist(q, parked).argmin(1)),
        bound_ms=bb, bound_by=by,
        # the device alone (20 calls in one CUDA graph), the library call
        # the same way, and the host's time to issue one call
        kernel_ms=graph_ms(lambda: cuda_nn.nn1_argmin(q, p, pm)),
        library_kernel_ms=graph_ms(lambda: torch.cdist(q, parked).argmin(1)),
        host_ms=host_ms(lambda: cuda_nn.nn1_argmin(q, p, pm)),
        issue_floor_ms=M * N * 9 / (sms * 128 * sm_mhz * 1e6) * 1e3,
        sm_clock_max_mhz=sm_mhz)

    # where the device time goes: each of the two kernels (the sweep and
    # the merge); the SM clock while the kernel runs back to back (the
    # issue floor's clock)
    out["nn1_argmin"].update(
        split_ms=kernel_split_ms(lambda: cuda_nn.nn1_argmin(q, p, pm)),
        sm_clock_under_load_mhz=sm_clock_under_load(
            lambda: cuda_nn.nn1_argmin(q, p, pm)))
    # forced cases (ops/cuda_nn.forced_cases, the same as the CPU tests'):
    # ties on this card's segment and tile boundaries, masks, ragged sizes
    forced = {}
    for name, arrs in cuda_nn.forced_cases(sms).items():
        fq, fp, fm = (torch.as_tensor(x, device=dev) for x in arrs)
        a = cuda_nn.nn1_argmin(fq, fp, fm)
        b = cuda_nn.nn1_argmin_plain(fq, fp, fm)
        _, S, seg = cuda_nn.launch_plan(fq.shape[0], fp.shape[0], sms)
        bad = int((a != b).sum())
        forced[name] = dict(shape=f"{fq.shape[0]}x{fp.shape[0]}", segments=S,
                            segment_length=seg, mismatches=bad, ok=bad == 0)
    out["nn1_argmin"].update(
        forced=forced, ok=out["nn1_argmin"]["ok"] and all(
            v["ok"] for v in forced.values()),
        max_abs_err=float(mism + sum(v["mismatches"]
                                     for v in forced.values())))

    # --- nn1_copy_rows: the feature transfer (the correlator points, the
    # SEM grid's features), against its plain version and the three-step
    # form; forced: more queries and targets masked, a table whose rows
    # are strided, C = 5 (the copy's 4-byte path), one query
    qm = s["corr_mask"]
    cr = copy_rows_case(q, qm, p, pm, feat)
    gm = torch.Generator(device=dev).manual_seed(3)
    wide = torch.cat([feat, -feat], 1)
    forced = {
        "masked": copy_rows_case(
            q, qm & (torch.rand(qm.shape, generator=gm, device=dev) > 0.3), p,
            pm & (torch.rand(pm.shape, generator=gm, device=dev) > 0.2), feat,
            timed=False),
        "strided_rows": copy_rows_case(q, qm, p, pm, wide[:, 32:],
                                       timed=False),
        "C5": copy_rows_case(q, qm, p, pm, feat[:, :5].contiguous(),
                             timed=False),
        "M1": copy_rows_case(q[:1], qm[:1], p, pm, feat, timed=False)}
    out["nn1_copy_rows"] = dict(
        cr, forced=forced, library_ms=None,
        ok=cr["ok"] and all(v["ok"] for v in forced.values()),
        max_abs_err=float(cr["mismatches_vs_plain"] + sum(
            v["mismatches_vs_plain"] for v in forced.values())))

    # --- ume_moments_fused: 2048 keypoints x 16384 points, r 5, cap 750
    g = torch.Generator(device=dev).manual_seed(1)
    kidx = weighted_sample(pm.float() / pm.float().sum(), 2048, g)
    kp = p[kidx].contiguous()
    f = feat * pm[:, None]
    Z = torch.cat([f, f * p[:, 0:1], f * p[:, 1:2], f * p[:, 2:3]], 1)
    r, cap = cfg.ume_r_nn, cfg.ume_max_nn
    a = cuda_ume.ume_moments_fused(kp, p, Z, pm, r, cap)
    b = cuda_ume.ume_moments_plain(kp, p, Z, pm, r, cap)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    # data-dependent work: radius tests up to the max_nn-th hit, row sums
    tested = selected = at_cap = in_ball = 0
    waited = 0  # rows a block of 8 warps bound by a barrier per tile pays for
    for c0 in range(0, kp.shape[0], 256):
        ok = (sqdist3(kp[c0:c0 + 256], p) <= r * r) & pm[None]
        cum = torch.cumsum(ok.int(), 1)
        full = cum[:, -1] >= cap
        at_cap += int(full.sum())
        in_ball += int(cum[:, -1].sum())
        first = torch.argmax((cum >= cap).int(), 1) + 1
        tested += int(torch.where(full, first, torch.full_like(first, N)).sum())
        selected += int(torch.clamp(cum[:, -1], max=cap).sum())
        # selected rows per (keypoint, tile of 2048 points); per block of 8
        # consecutive keypoints the largest count of each tile
        w = torch.nn.functional.pad((ok & (cum <= cap)).float(),
                                    (0, -N % 2048, 0, -ok.shape[0] % 8))
        per_tile = w.view(w.shape[0] // 8, 8, -1, 2048).sum(-1)
        waited += int(per_tile.max(dim=1).values.sum())
    Mk = kp.shape[0]
    kernel_ms = graph_ms(lambda: cuda_ume.ume_moments_fused(kp, p, Z, pm, r,
                                                            cap))
    kp_far = kp + 1e6
    bb, by = bound_ms(N * 512 + N * 13 + Mk * 12 + Mk * 512,
                      tested * 9 + selected * 128)
    out["ume_moments_fused"] = dict(
        shape=f"{Mk}x{N}", max_abs_err=err, scale=scale,
        ok=err <= 1e-5 * scale,
        ms=time_ms(lambda: cuda_ume.ume_moments_fused(kp, p, Z, pm, r, cap)),
        plain_ms=time_ms(lambda: cuda_ume.ume_moments_plain(kp, p, Z, pm, r,
                                                            cap)),
        library_ms=None, bound_ms=bb, bound_by=by,
        # facts about the inputs: how many balls the cap cuts short
        cap=cap, keypoints_at_cap_share=at_cap / Mk,
        mean_in_radius=in_ball / Mk, rows_selected=selected,
        # the device's time alone (20 calls in one CUDA graph); the same with
        # 20 eager calls back to back, which reads the host where its time to
        # launch is the longer; the sweep alone (keypoints moved 1e6 m away:
        # no row read); the row reads almost alone (every point in radius:
        # each warp stops at its cap-th valid point); the rate of 512-byte
        # row reads that kernel_ms amounts to
        kernel_ms=kernel_ms,
        kernel_ms_eager=time_ms(lambda: cuda_ume.ume_moments_fused(
            kp, p, Z, pm, r, cap), reps=7, inner=20),
        kernel_ms_no_hits=graph_ms(lambda: cuda_ume.ume_moments_fused(
            kp_far, p, Z, pm, r, cap)),
        kernel_ms_all_capped=graph_ms(lambda: cuda_ume.ume_moments_fused(
            kp, p, Z, pm, 1e6, cap)),
        l2_tbps=selected * 512 / (kernel_ms * 1e-3) / 1e12,
        # what a kernel pays whose 8 warps a block wait for each other round
        # every 2048-point tile: sum over tiles of the block's largest row
        # count, over the block's mean rows per warp (1 = no waiting)
        tile_wait_factor=waited / (selected / 8))
    forced, forced_ok = ume_forced_cases(dev)
    out["ume_moments_fused"].update(forced=forced)
    out["ume_moments_fused"]["ok"] &= forced_ok

    # --- corr_scores_fused at every stage's shape
    cs_f = copy_features_to_raw(s["corr_pts"], s["corr_mask"], p, feat, pm)
    ct_f = copy_features_to_raw(tg["corr_pts"], tg["corr_mask"], tg["grid"],
                                tfeat, tg["mask"])
    fs, ft = prepare_weighted_features(
        s["corr_pts"], cs_f, s["corr_mask"], tg["corr_pts"], ct_f,
        tg["corr_mask"], var_knn=cfg.corr_var_knn,
        var_anchors=cfg.corr_var_anchors)
    gt = torch.as_tensor(pair["gt"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)

    def hyps(H):  # the ground truth plus random planar rigid motions
        ang = (torch.rand(H, generator=gen, device=dev) * 2 - 1) * np.pi
        T = torch.eye(4, device=dev).repeat(H, 1, 1)
        T[:, 0, 0], T[:, 0, 1] = torch.cos(ang), -torch.sin(ang)
        T[:, 1, 0], T[:, 1, 1] = torch.sin(ang), torch.cos(ang)
        T[:, :2, 3] = (torch.rand(H, 2, generator=gen, device=dev) * 2 - 1) * 10
        T[H // 3] = gt
        return T

    def sub(x, k):
        return torch.randperm(x, generator=gen, device=dev)[:k]

    S, T = s["corr_pts"].shape[0], tg["corr_pts"].shape[0]
    sp_c, sf_c, sm_c = compact_structure(s["corr_pts"], fs, s["corr_mask"],
                                         2048)
    tp_c, tf_c, tm_c = compact_structure(tg["corr_pts"], ft, tg["corr_mask"],
                                         2048)
    stages = {"triage": (2048, sub(S, 256), sub(T, 512)),
              "coarse": (512, sub(S, 512), sub(T, 1024)),
              "exact": (4, torch.arange(S, device=dev),
                        torch.arange(T, device=dev))}
    inputs = {name: _radius_inputs(
        s["corr_pts"][si], fs[si], s["corr_mask"][si], tg["corr_pts"][ti],
        ft[ti], tg["corr_mask"][ti], hyps(H))
        for name, (H, si, ti) in stages.items()}
    inputs["arbiter"] = _radius_inputs(sp_c, sf_c, sm_c, tp_c, tf_c, tm_c,
                                       hyps(17))
    per_stage, ok_all, err_all = {}, True, 0.0
    sigma = cfg.corr_kernel_sigma
    r2 = (2.0 * sigma) ** 2

    def fused(args):
        return cuda_corr.corr_scores_fused(*args, sigma=sigma)

    def reorder(args, perm):  # the source rows in another order
        pts_t, sf, tp4, tf = args
        return pts_t[:, perm].contiguous(), sf[perm], tp4, tf

    def ordered(args):  # a caller that orders its source rows by cell:
        # one hypothesis' cells serve all (a rigid motion keeps neighbours)
        return fused(reorder(args, cell_order(args[0][0], 2.0 * sigma)))

    def agrees(a, b):
        """(max abs error, within 1e-4 x max |score| with the same argmax;
        where the plain scores are all 0, exactly 0)."""
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        if scale == 0.0:
            return err, int(torch.count_nonzero(a)) == 0
        return err, err <= 1e-4 * scale and int(a.argmax()) == int(b.argmax())

    def need_share(pts_t, tp4, perm):
        """Share of the kernel's (hypothesis block, warp of 32 source rows,
        target) steps with a triple in radius, i.e. that need <f_i, g_j>."""
        src = pts_t[..., :3] if perm is None else pts_t[:, perm, :3]
        Hn, Sn = src.shape[:2]
        pad = (-Sn) % 32
        need = torch.zeros((), dtype=torch.int64, device=dev)
        for h0 in range(0, Hn, 8):
            hit = (sqdist3(src[h0:h0 + 8], tp4[:, :3]) <= r2).any(0)
            hit = torch.nn.functional.pad(hit, (0, 0, 0, pad))
            need += hit.view(-1, 32, tp4.shape[0]).any(1).sum()
        steps = -(-Hn // 8) * ((Sn + pad) // 32) * tp4.shape[0]
        return int(need) / steps

    for name, args in inputs.items():
        pts_t, sf, tp4, tf = args
        H, Sn, _ = pts_t.shape
        Tn = tp4.shape[0]
        b = cuda_corr.corr_scores_plain(*args, sigma=sigma)
        perm = cell_order(pts_t[0], 2.0 * sigma)
        args_perm = reorder(args, perm)
        runs = {"unordered": fused(args), "ordered": ordered(args)}
        again = {"unordered": fused(args), "ordered": ordered(args)}
        torch.cuda.synchronize()
        checks = {k: agrees(a, b) for k, a in runs.items()}
        err = max(e for e, _ in checks.values())
        same_bits = all(torch.equal(runs[k], again[k]) for k in again)
        ok = all(o for _, o in checks.values()) and same_bits
        n_in = sum(int((sqdist3(pts_t[h0:h0 + 16, :, :3], tp4[:, :3]) <= r2
                        ).sum()) for h0 in range(0, H, 16))
        bb, by = bound_ms(H * Sn * 16 + Sn * 128 + Tn * 16 + Tn * 128 + H * 4,
                          H * Sn * Tn * 9 + Sn * Tn * 64 + n_in * 5)
        per_stage[name] = dict(
            shape=f"{H}x{Sn}x{Tn}", max_abs_err=err, ok=ok,
            argmax=int(runs["unordered"].argmax()), bit_identical=same_bits,
            grid=cuda_corr.launch_plan(H, Sn, Tn),
            # one call an event pair, as every kernel here is timed: the
            # main path's call (no ordering), and with the ordering made
            # in the call (key, sort, two row gathers and kernel)
            ms=time_ms(lambda: fused(args)),
            ms_ordered=time_ms(lambda: ordered(args)),
            order_ms=time_ms(lambda: reorder(
                args, cell_order(pts_t[0], 2.0 * sigma))),
            # 20 launches back to back: the kernel without the host's
            # share, in the caller's order and on rows ordered
            # beforehand; with radius 0 nothing is in radius and only the
            # distance tests and votes remain
            kernel_ms_unordered=time_ms(lambda: fused(args), reps=7,
                                        inner=20),
            kernel_ms_ordered=time_ms(lambda: fused(args_perm), reps=7,
                                      inner=20),
            kernel_ms_empty_radius=time_ms(
                lambda: cuda_corr.corr_scores_fused(
                    *args, sigma=sigma, radius_factor=0.0), reps=7, inner=20),
            g_need_share_ordered=need_share(pts_t, tp4, perm),
            g_need_share_unordered=need_share(pts_t, tp4, None),
            plain_ms=time_ms(lambda: cuda_corr.corr_scores_plain(
                *args, sigma=sigma), reps=10),
            bound_ms=bb, bound_by=by, in_radius=n_in)
        ok_all &= ok
        err_all = max(err_all, err)

    # forced cases: ragged shapes, both grids, empty radius, masked rows
    def forced(Hn, Sn, Tn, shift=0.0, masked=False):
        pts = (torch.rand(Hn, Sn, 4, generator=gen, device=dev) * 2 - 1) * 6
        tp4 = (torch.rand(Tn, 4, generator=gen, device=dev) * 2 - 1) * 6
        tp4[:, :3] += shift
        pts[..., 3], tp4[:, 3] = 0, 0
        f = torch.randn(Sn, 32, generator=gen, device=dev)
        g = torch.randn(Tn, 32, generator=gen, device=dev)
        if masked:  # rows without features, parked far away
            g[::3], tp4[::3, :3] = 0, 1e6
            f[::5], pts[:, ::5, :3] = 0, -1e6
        return pts, f, tp4, g

    forced_cases = {  # name -> (inputs, whether the target sweep is split)
        "H1_S33_T1000": (forced(1, 33, 1000), True),
        "H7_S50_T300": (forced(7, 50, 300), True),
        "H9_S300_T777": (forced(9, 300, 777), True),
        "H2100_S257_T700_whole_sweep": (forced(2100, 257, 700), False),
        "H9_S40_T500_none_in_radius": (forced(9, 40, 500, shift=1e3), True),
        "H7_S70_T900_masked_rows_far": (forced(7, 70, 900, masked=True), True),
    }
    forced_res = {}
    for name, (args, want_split) in forced_cases.items():
        b = cuda_corr.corr_scores_plain(*args, sigma=sigma)
        res = {}
        for k, fn in (("ordered", ordered), ("unordered", fused)):
            a, a2 = fn(args), fn(args)
            torch.cuda.synchronize()
            e, good = agrees(a, b)
            res[k] = dict(max_abs_err=e, ok=good and torch.equal(a, a2))
        Hn, Sn, Tn = args[0].shape[0], args[0].shape[1], args[2].shape[0]
        n_src, n_seg = cuda_corr.launch_plan(Hn, Sn, Tn)
        forced_res[name] = dict(
            grid=(n_src, n_seg), split=n_seg > 1,
            max_abs_score=float(b.abs().max()), **res,
            ok=res["ordered"]["ok"] and res["unordered"]["ok"]
            and (n_seg > 1) == want_split)
        ok_all &= forced_res[name]["ok"]
        err_all = max(err_all, *(res[k]["max_abs_err"] for k in res))

    # what compiling the hypothesis loop for each count 1..8 buys: the
    # exact stage's 4 hypotheses against the same launch with 4 more that
    # are in no radius (the tests a loop of fixed length 8 would make)
    pts_t, sf, tp4, tf = inputs["exact"]
    padded = (torch.cat([pts_t, torch.full_like(pts_t, 1e18)]), sf, tp4, tf)
    a, b = fused(padded)[:pts_t.shape[0]], fused(inputs["exact"])
    ok_all &= agrees(a, b)[1]
    per_stage["exact"].update(
        padded_to_8_same_bits=torch.equal(a, b),
        kernel_ms_padded_to_8=time_ms(lambda: fused(padded), reps=7, inner=20))

    tot = {k: sum(v[k] for v in per_stage.values())
           for k in ("ms", "ms_ordered", "order_ms", "kernel_ms_unordered",
                     "kernel_ms_ordered", "kernel_ms_empty_radius",
                     "plain_ms", "bound_ms")}
    for v in (*per_stage.values(), tot):
        v["ms_unordered"] = v["ms"]  # the main path orders nothing
    by = max(per_stage.values(), key=lambda v: v["bound_ms"])["bound_by"]
    out["corr_scores_fused"] = dict(
        shape="per pair: " + ", ".join(f"{k} {v['shape']}"
                                       for k, v in per_stage.items()),
        max_abs_err=err_all, ok=ok_all, library_ms=None, bound_by=by,
        stages=per_stage, forced=forced_res, **tot)
    return out


BALL_QUERY_CALLS = ("intersection", "source_ball", "target_ball")


def near_radius_case(rng, M, N, radius):
    """Queries, and points at the radius from them within a few fp32 steps
    either side: decisions that turn on the last bit of the squared
    distance's rounding."""
    q = rng.uniform(-40, 40, (M, 3)).astype(np.float32)
    u = rng.normal(size=(N, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    scale = radius * (1 + rng.integers(-4, 5, (N, 1)) * 2.0 ** -23)
    p = (q[rng.integers(0, M, N)] + u * scale).astype(np.float32)
    return q, p


def ball_query_work(q_mask, p_mask, idx, K):
    """(radius tests, bytes) the inputs need: each valid query tests the
    valid points up to its K-th hit, all of them where it has fewer; the
    valid queries (coordinates, |q|^2) and points (coordinates, |p|^2,
    mask) read once, the (M, K) int64 rows written."""
    cum = np.cumsum(p_mask)
    last = idx[:, K - 1]
    tests = np.where(last >= 0, cum[np.maximum(last, 0)], cum[-1])
    tests = int(tests[q_mask].sum())
    n_bytes = (int(q_mask.sum()) * 16 + q_mask.size
               + int(p_mask.sum()) * 17 + idx.size * 8)
    return tests, n_bytes


def phase_ball_query(dev):
    """The ball_query kernel (ops/cuda_ball.py) against its plain version
    (neighbors.ball_query_plain) on the card, index for index: the forced
    cases (cuda_ball.forced_cases) and points within a few fp32 steps of
    the radius, each case alone and, where shapes agree, as one pair-axis
    launch; then a batch of four HDL-64 pairs at train_kitti_config's
    widths (100000-row clouds, 256 keypoints, 750 in 5 m) through the
    training keypoint selection, every ball_query call it makes held to
    the plain version, the three calls' device time alone (kernel_ms, a
    CUDA graph), one call an event pair (ms), the plain version's ms, the
    bound from the tests and bytes the inputs need (ball_query_work), and
    the four pairs' intersection calls as one pair-axis launch. No library
    call computes the same function: library_ms is none."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_ball
    from umeregrobust_tpu_torch.ops.neighbors import (
        ball_query, ball_query_plain)
    from umeregrobust_tpu_torch.pipeline import train_keypoints as tk
    from umeregrobust_tpu_torch.train.trainer import batch_to_device

    def on(x):
        return None if x is None else torch.as_tensor(x).to(dev)

    def mism(a, b):
        return int((a != b).sum()) if a.shape == b.shape else a.numel()

    forced = {}
    cases = dict(cuda_ball.forced_cases())
    rng = np.random.default_rng(29)
    q, p = near_radius_case(rng, 200, 20000, 2.5)
    cases["near_radius"] = (q, p, 2.5, 64, None, rng.random(20000) < 0.9)
    for name, (q, p, r, K, qm, pm) in cases.items():
        args = (on(q), on(p), r, K, on(qm), on(pm))
        before = cuda_ball.LAUNCHES
        got = ball_query(*args)
        forced[name] = dict(
            mismatches=mism(got, ball_query_plain(*args)),
            hits=int((got >= 0).sum()),
            launches=cuda_ball.LAUNCHES - before)
    # a pair axis over three near-radius problems of one shape
    probs = [near_radius_case(rng, 300, 5000, 1.0) for _ in range(3)]
    masks = [rng.random(5000) < 0.8 for _ in probs]
    got = ball_query(on(np.stack([a for a, _ in probs])),
                     on(np.stack([b for _, b in probs])), 1.0, 40,
                     p_mask=on(np.stack(masks)))
    forced["pair_axis_B3"] = dict(mismatches=sum(
        mism(got[i], ball_query_plain(on(a), on(b), 1.0, 40,
                                      p_mask=on(m)))
        for i, ((a, b), m) in enumerate(zip(probs, masks))),
        hits=int((got >= 0).sum()), launches=1)
    forced_ok = all(v["mismatches"] == 0 and v["launches"] == 1
                    for v in forced.values())

    # the training keypoint selection's calls, pair by pair
    bt = batch_to_device(train_batch(4, 900, max_pc_size=100000), dev)
    calls = []

    def record(*a, **kw):
        calls.append((a, kw, ball_query(*a, **kw)))
        return calls[-1][2]

    tk.ball_query = record
    try:
        with torch.no_grad():
            for b in range(bt["src_pts"].shape[0]):
                tk._select(bt["src_pts"][b], bt["src_seg"][b],
                           bt["src_mask"][b], bt["tgt_pts"][b],
                           bt["tgt_mask"][b], bt["gt_tform"][b], 256, 750,
                           300, 5.0, 0.6, (9,))
    finally:
        tk.ball_query = ball_query
    assert len(calls) == 3 * bt["src_pts"].shape[0]
    rows = {}
    for i, name in enumerate(BALL_QUERY_CALLS):
        mine = calls[i::3]
        a, kw, _ = mine[0]
        K = kw["K"]
        m = sum(mism(out, ball_query_plain(*a_, **kw_))
                for a_, kw_, out in mine)
        plain = ball_query_plain(*a, **kw)
        tests, n_bytes = ball_query_work(
            kw["q_mask"].cpu().numpy(), kw["p_mask"].cpu().numpy(),
            plain.cpu().numpy(), K)
        bb, by = bound_ms(n_bytes, 9 * tests)
        rows[name] = dict(
            shape=f"{a[0].shape[0]} queries ({int(kw['q_mask'].sum())} "
                  f"valid) x {a[1].shape[0]} points "
                  f"({int(kw['p_mask'].sum())} valid), K {K}, r "
                  f"{kw['radius']}", mismatches=m, pairs=len(mine),
            hits=int((plain >= 0).sum()), tests=tests,
            kernel_ms=graph_ms(lambda: ball_query(*a, **kw)),
            ms=time_ms(lambda: ball_query(*a, **kw)),
            plain_ms=time_ms(lambda: ball_query_plain(*a, **kw), reps=3,
                             warmup=1),
            bound_ms=bb, bound_by=by)
        emit({"phase": "ball_query_call", "call": name, **rows[name]})
    # the four intersection calls as one pair-axis launch
    inter = calls[0::3]
    stack = {k: torch.stack([kw[k] for _, kw, _ in inter])
             for k in ("q_mask", "p_mask")}
    qs = torch.stack([a[0] for a, _, _ in inter])
    ps = torch.stack([a[1] for a, _, _ in inter])
    kw0 = dict(radius=inter[0][1]["radius"], K=inter[0][1]["K"], **stack)
    got = ball_query(qs, ps, **kw0)
    batched = dict(
        B=len(inter), mismatches=sum(mism(got[i], out) for i, (_, _, out)
                                     in enumerate(inter)),
        kernel_ms_batched=graph_ms(lambda: ball_query(qs, ps, **kw0)))
    emit({"phase": "ball_query_pair_axis", "call": "intersection",
          **batched})
    ok = (forced_ok and batched["mismatches"] == 0
          and all(r["mismatches"] == 0 for r in rows.values()))
    tot = {k: sum(r[k] for r in rows.values())
           for k in ("kernel_ms", "ms", "plain_ms", "bound_ms")}
    return dict(
        shape="the training keypoint selection's three calls a pair at "
              "train_kitti_config: " + "; ".join(
                  f"{k} {r['shape']}" for k, r in rows.items()),
        max_abs_err=float(sum(r["mismatches"] for r in rows.values())
                          + sum(v["mismatches"] for v in forced.values())),
        ok=ok, library_ms=None, calls=rows, forced=forced,
        bound_by=max(rows.values(), key=lambda r: r["bound_ms"])["bound_by"],
        B=batched["B"], kernel_ms_b1=rows["intersection"]["kernel_ms"],
        kernel_ms_batched=batched["kernel_ms_batched"], **tot)


KABSCH_COUNTS = (8, 20000, 262144)  # matrices a call on the main path


def kabsch_work(n, sweeps):
    """(bytes, fp32 operations) of n solves as csrc/kabsch.cu makes them: H
    read and R written once, 72 bytes a matrix; 94 operations around the
    sweeps (|H|^2, the scale, Horn's matrix, the argmax, the norm, the
    rotation) and 78 a Jacobi rotation, six a sweep, each library call
    (atan2f, cosf, sinf, sqrtf) counted as one operation: a floor."""
    return 72 * n, n * (94 + 6 * 78 * sweeps)


def phase_kabsch(dev):
    """The SO(3) solver's kernel (ops/cuda_so3.py, csrc/kabsch.cu) against
    its plain version (core/so3.kabsch_rotation_plain) on the card, bit for
    bit (a NaN equal to a NaN): the forced cases (cuda_so3.forced_cases)
    and random cross-covariances over six decades of scale at the main
    path's counts (KABSCH_COUNTS: ICP's umeyama at B = 8; the consensus
    refit and polish and the estimator, up to 8 x 2,500; rtume_estimate),
    each at 3 and 6 sweeps, one launch a call; at each count the device
    time alone (kernel_ms, a CUDA graph), one call an event pair (ms), the
    plain version's ms and the bound from the bytes and operations
    (kabsch_work). No library call computes the same function
    (torch.linalg.svd gives the exact optimum, not the sweeps' result):
    library_ms is none."""
    import torch

    from umeregrobust_tpu_torch.core.so3 import (
        kabsch_rotation, kabsch_rotation_plain)
    from umeregrobust_tpu_torch.ops import cuda_so3

    def mism(a, b):
        same = (a.view(torch.int32) == b.view(torch.int32)) | (
            torch.isnan(a) & torch.isnan(b))
        return int((~same).sum())

    def check(H, sweeps):
        before = cuda_so3.LAUNCHES
        got = kabsch_rotation(H, sweeps)
        return dict(mismatches=mism(got, kabsch_rotation_plain(H, sweeps)),
                    launches=cuda_so3.LAUNCHES - before)

    forced, rows = {}, {}
    g = torch.Generator(device=dev).manual_seed(25)
    with torch.no_grad():
        for name, H in cuda_so3.forced_cases().items():
            for sweeps in (3, 6):
                forced[f"{name}.sweeps{sweeps}"] = check(
                    torch.as_tensor(H, device=dev), sweeps)
        for n in KABSCH_COUNTS:
            H = torch.randn(n, 3, 3, device=dev, generator=g) * torch.exp(
                2.0 * torch.randn(n, 1, 1, device=dev, generator=g))
            for sweeps in (3, 6):
                bb, by = bound_ms(*kabsch_work(n, sweeps))
                key = f"n{n}.sweeps{sweeps}"
                rows[key] = dict(
                    n=n, sweeps=sweeps, **check(H, sweeps),
                    kernel_ms=graph_ms(lambda: kabsch_rotation(H, sweeps)),
                    ms=time_ms(lambda: kabsch_rotation(H, sweeps)),
                    plain_ms=time_ms(
                        lambda: kabsch_rotation_plain(H, sweeps), reps=5,
                        warmup=1),
                    bound_ms=bb, bound_by=by)
                emit({"phase": "kabsch_call", "call": key, **rows[key]})
    forced_ok = all(v["mismatches"] == 0 and v["launches"] == 1
                    for v in forced.values())
    emit({"phase": "kabsch_forced", "ok": forced_ok, **forced})
    ok = forced_ok and all(r["mismatches"] == 0 and r["launches"] == 1
                           for r in rows.values())
    tot = {k: sum(r[k] for r in rows.values())
           for k in ("kernel_ms", "ms", "plain_ms", "bound_ms")}
    return dict(
        shape="sum over random H at n = " + ", ".join(
            map(str, KABSCH_COUNTS)) + ", each at 3 and 6 sweeps",
        max_abs_err=float(sum(r["mismatches"] for r in rows.values())
                          + sum(v["mismatches"] for v in forced.values())),
        ok=ok, library_ms=None, calls=rows, forced=forced,
        bound_by=max(rows.values(), key=lambda r: r["bound_ms"])["bound_by"],
        **tot)


def stacked_args(ps):
    """pair_args of several pairs, each array stacked on a leading pair
    axis (register_pairs_batched's inputs)."""
    return tuple(np.stack(a) for a in zip(*(pair_args(p) for p in ps)))


def ume_work(kp, p, pm, r, cap):
    """Data-dependent work of one pair's ume_moments_fused call: (radius
    tests up to each keypoint's cap-th hit, rows selected)."""
    import torch

    from umeregrobust_tpu_torch.ops.neighbors import sqdist3

    N, tested, selected = p.shape[0], 0, 0
    for c0 in range(0, kp.shape[0], 256):
        ok = (sqdist3(kp[c0:c0 + 256], p) <= r * r) & pm[None]
        cum = torch.cumsum(ok.int(), 1)
        full = cum[:, -1] >= cap
        first = torch.argmax((cum >= cap).int(), 1) + 1
        tested += int(torch.where(full, first, torch.full_like(first, N)).sum())
        selected += int(torch.clamp(cum[:, -1], max=cap).sum())
    return tested, selected


def phase_pair_axis(dev, model, pairs, cfg):
    """The kernels with a pair axis (nn1_argmin, ume_moments_fused,
    corr_scores_fused) and the flattened gather_rows at the main path's
    shapes for B = len(pairs) pairs: each pair's output bit-identical to
    its B = 1 call, the batched call against the plain version (the
    kernels' phase-3 tolerances), and the device's time alone (CUDA
    graph) at B = 1 (the first pair) and B, beside the bound at B (the sum
    of the pairs' bounds: B x the B = 1 bound where it depends on the
    shapes alone)."""
    import torch

    from umeregrobust_tpu_torch.data.suite import REDUCED
    from umeregrobust_tpu_torch.ops import (
        cuda_corr, cuda_gather, cuda_nn, cuda_ume)
    from umeregrobust_tpu_torch.ops.neighbors import (
        gather_padded, sqdist3, take_rows)
    from umeregrobust_tpu_torch.pipeline.consensus import compact_structure
    from umeregrobust_tpu_torch.pipeline.correlator import (
        _radius_inputs, prepare_weighted_features)
    from umeregrobust_tpu_torch.pipeline.e2e import pair_features_batched
    from umeregrobust_tpu_torch.pipeline.sampling import (
        weighted_sample_batched)

    B = len(pairs)
    args = [torch.as_tensor(a).to(dev) for a in stacked_args(pairs)]
    (_, grid, mask, _, tgrid, tmask, cpts, cmask, tcpts, tcmask) = args
    cpts, tcpts = cpts.float(), tcpts.float()
    feat, tfeat, cs_f, ct_f = pair_features_batched(model, REDUCED["caps"],
                                                    *args, device=dev)
    out = {}

    def one(fn, xs, b):  # fn on pair b alone (B = 1 views)
        return fn(*(x[b] if torch.is_tensor(x) else x for x in xs))

    def timing(fn, xs):
        return dict(kernel_ms_b1=graph_ms(lambda: one(fn, xs, 0)),
                    kernel_ms_batched=graph_ms(lambda: fn(*xs)))

    # --- nn1_argmin: corr points (4096) vs SEM grid (16384), B pairs
    xs = (cpts, grid, mask)
    a = cuda_nn.nn1_argmin(*xs)
    singles = [one(cuda_nn.nn1_argmin, xs, b) for b in range(B)]
    plain = cuda_nn.nn1_argmin_plain(*xs)
    torch.cuda.synchronize()
    M, N = cpts.shape[1], grid.shape[1]
    b1, by = bound_ms(M * 12 + N * 13 + M * 8, M * N * 9)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out["nn1_argmin"] = dict(
        shape=f"{B}x{M}x{N}", plan_b1=cuda_nn.launch_plan(M, N, sms),
        plan_batched=cuda_nn.launch_plan(M, N, sms, B),
        bit_identical_to_b1=all(torch.equal(a[b], singles[b])
                                for b in range(B)),
        mismatches_vs_plain=int((a != plain).sum()), bound_ms_b1=b1,
        bound_ms_batched=B * b1, bound_by=by, **timing(cuda_nn.nn1_argmin,
                                                       xs))
    out["nn1_argmin"]["max_abs_err"] = float(
        out["nn1_argmin"]["mismatches_vs_plain"])
    out["nn1_argmin"]["ok"] = (out["nn1_argmin"]["bit_identical_to_b1"]
                               and out["nn1_argmin"]["mismatches_vs_plain"]
                               == 0)

    # --- gather_rows over the flattened (B N, 32) table: the transfer
    # (gather_padded offsets pair b's indices by b N; timed is the kernel's
    # call on the flattened table, as gather_padded makes it)
    idx = torch.where(cmask, a, torch.full_like(a, -1))
    g = gather_padded(feat, idx)
    same = all(torch.equal(g[b], gather_padded(feat[b], idx[b]))
               for b in range(B))
    table, table0 = feat.reshape(B * N, -1).contiguous(), feat[0].contiguous()
    flat = torch.where(idx >= 0, idx + N * torch.arange(
        B, device=dev)[:, None], idx).reshape(-1)
    bb = sum(bound_ms((torch.unique(idx[b][idx[b] >= 0]).numel() + M) * 128
                      + M * 8, 0)[0] for b in range(B))
    out["gather_rows"] = dict(
        shape=f"{B}x{M} rows of {B}x{N}x32", bit_identical_to_b1=same,
        ok=same, max_abs_err=0.0, bound_ms_batched=bb, bound_by="bytes",
        kernel_ms_b1=graph_ms(lambda: cuda_gather.gather_rows(table0,
                                                              idx[0])),
        kernel_ms_batched=graph_ms(lambda: cuda_gather.gather_rows(table,
                                                                   flat)))

    # --- nn1_copy_rows: the transfer as the batched feature stage makes
    # it (feat: one side of the (B, 2, N, C) forward output, strided)
    xs = (cpts, cmask, grid, mask, feat)
    cr = copy_rows_case(*xs, timed=False)
    kernels = [count_kernels(lambda: cuda_nn.nn1_copy_rows(*xs))[0],
               count_kernels(lambda: three_step_copy(*xs))[0]]
    a = cuda_nn.nn1_copy_rows(*xs)
    same = all(bit_mismatches(a[b], one(cuda_nn.nn1_copy_rows, xs, b)) == 0
               for b in range(B))
    b1 = bound_ms(M * 13 + N * 13 + 2 * M * a.shape[-1] * 4, M * N * 9)[0]
    out["nn1_copy_rows"] = dict(
        cr, bit_identical_to_b1=same, ok=cr["ok"] and same,
        max_abs_err=float(cr["mismatches_vs_plain"]), bound_ms_b1=b1,
        bound_ms_batched=B * b1, bound_by="operations",
        three_step_kernel_ms_batched=graph_ms(lambda: three_step_copy(*xs)),
        kernels_batched=kernels[0], three_step_kernels_batched=kernels[1],
        **timing(cuda_nn.nn1_copy_rows, xs))

    # --- ume_moments_fused: 2048 keypoints x 16384 points a pair
    gens = [torch.Generator(device=dev).manual_seed(1) for _ in range(B)]
    kidx = weighted_sample_batched(mask.float() / mask.float().sum(
        1, keepdim=True), 2048, gens)
    kp = take_rows(grid, kidx).contiguous()
    f = feat * mask[..., None]
    Z = torch.cat([f, f * grid[..., 0:1], f * grid[..., 1:2],
                   f * grid[..., 2:3]], -1).contiguous()
    r, cap = cfg.ume_r_nn, cfg.ume_max_nn
    xs = (kp, grid, Z, mask, r, cap)
    a = cuda_ume.ume_moments_fused(*xs)
    singles = [one(cuda_ume.ume_moments_fused, xs, b) for b in range(B)]
    plain = cuda_ume.ume_moments_plain(*xs)
    torch.cuda.synchronize()
    err, scale = float((a - plain).abs().max()), float(plain.abs().max())
    Mk = kp.shape[1]
    bounds = []
    for b in range(B):
        tested, selected = ume_work(kp[b], grid[b], mask[b], r, cap)
        bounds.append(bound_ms(N * 512 + N * 13 + Mk * 12 + Mk * 512,
                               tested * 9 + selected * 128))
    out["ume_moments_fused"] = dict(
        shape=f"{B}x{Mk}x{N}", max_abs_err=err, scale=scale,
        bit_identical_to_b1=all(torch.equal(a[b], singles[b])
                                for b in range(B)),
        bound_ms_b1=bounds[0][0], bound_ms_batched=sum(x[0] for x in bounds),
        bound_by=bounds[0][1], **timing(cuda_ume.ume_moments_fused, xs))
    out["ume_moments_fused"]["ok"] = (
        out["ume_moments_fused"]["bit_identical_to_b1"]
        and err <= 1e-5 * scale)

    # --- corr_scores_fused at the four stage shapes, B pairs
    fs, ft = prepare_weighted_features(
        cpts, cs_f, cmask, tcpts, ct_f, tcmask, var_knn=cfg.corr_var_knn,
        var_anchors=cfg.corr_var_anchors)
    gen = torch.Generator(device=dev).manual_seed(2)
    gts = torch.as_tensor(np.stack([p["gt"] for p in pairs]),
                          dtype=torch.float32, device=dev)

    def hyps(H):  # each pair's ground truth plus random planar motions
        ang = (torch.rand(B, H, generator=gen, device=dev) * 2 - 1) * np.pi
        T = torch.eye(4, device=dev).repeat(B, H, 1, 1)
        T[..., 0, 0], T[..., 0, 1] = torch.cos(ang), -torch.sin(ang)
        T[..., 1, 0], T[..., 1, 1] = torch.sin(ang), torch.cos(ang)
        T[..., :2, 3] = (torch.rand(B, H, 2, generator=gen, device=dev)
                         * 2 - 1) * 10
        T[:, H // 3] = gts
        return T

    def sub(n, k):
        return torch.stack([torch.randperm(n, generator=gen, device=dev)[:k]
                            for _ in range(B)])

    S, T = cpts.shape[1], tcpts.shape[1]
    stages = {"triage": (2048, sub(S, 256), sub(T, 512)),
              "coarse": (512, sub(S, 512), sub(T, 1024)),
              "exact": (4, None, None)}
    inputs = {}
    for name, (H, si, ti) in stages.items():
        src = [cpts, fs, cmask] if si is None else [take_rows(x, si) for x in
                                                    (cpts, fs, cmask)]
        tgt = [tcpts, ft, tcmask] if ti is None else [take_rows(x, ti) for x
                                                      in (tcpts, ft, tcmask)]
        inputs[name] = _radius_inputs(*src, *tgt, hyps(H))
    inputs["arbiter"] = _radius_inputs(
        *compact_structure(cpts, fs, cmask, 2048),
        *compact_structure(tcpts, ft, tcmask, 2048), hyps(17))
    sigma = cfg.corr_kernel_sigma
    r2 = (2.0 * sigma) ** 2

    def fused(*xs):
        return cuda_corr.corr_scores_fused(*xs, sigma=sigma)

    per_stage = {}
    for name, xs in inputs.items():
        pts_t, _, tp4, _ = xs
        H, Sn, Tn = pts_t.shape[1], pts_t.shape[2], tp4.shape[1]
        a = fused(*xs)
        singles = [one(fused, xs, b) for b in range(B)]
        plain = cuda_corr.corr_scores_plain(*xs, sigma=sigma)
        torch.cuda.synchronize()
        err = float((a - plain).abs().max())
        agree = all(
            float((a[b] - plain[b]).abs().max())
            <= 1e-4 * float(plain[b].abs().max())
            and int(a[b].argmax()) == int(plain[b].argmax())
            for b in range(B))
        bounds = []
        for b in range(B):
            n_in = sum(int((sqdist3(pts_t[b, h0:h0 + 16, :, :3],
                                    tp4[b, :, :3]) <= r2).sum())
                       for h0 in range(0, H, 16))
            bounds.append(bound_ms(
                H * Sn * 16 + Sn * 128 + Tn * 16 + Tn * 128 + H * 4,
                H * Sn * Tn * 9 + Sn * Tn * 64 + n_in * 5))
        per_stage[name] = dict(
            shape=f"{B}x{H}x{Sn}x{Tn}", max_abs_err=err,
            bit_identical_to_b1=all(torch.equal(a[b], singles[b])
                                    for b in range(B)),
            agrees_with_plain=agree, bound_ms_b1=bounds[0][0],
            bound_ms_batched=sum(x[0] for x in bounds),
            bound_by=bounds[0][1], **timing(fused, xs))
        per_stage[name]["ok"] = (per_stage[name]["bit_identical_to_b1"]
                                 and agree)
    out["corr_scores_fused"] = dict(
        shape="per batch: " + ", ".join(f"{k} {v['shape']}"
                                        for k, v in per_stage.items()),
        stages=per_stage, ok=all(v["ok"] for v in per_stage.values()),
        max_abs_err=max(v["max_abs_err"] for v in per_stage.values()),
        bit_identical_to_b1=all(v["bit_identical_to_b1"]
                                for v in per_stage.values()),
        bound_by=max(per_stage.values(),
                     key=lambda v: v["bound_ms_batched"])["bound_by"],
        **{k: sum(v[k] for v in per_stage.values())
           for k in ("kernel_ms_b1", "kernel_ms_batched", "bound_ms_b1",
                     "bound_ms_batched")})
    for v in out.values():
        v["B"] = B
    return out


def fused_pair(pair, dev):
    """Both clouds of a pair in one coordinate set (batch id 1 on the
    target), as register_pair_e2e feeds the backbone."""
    import torch

    s, tg = pair["src"], pair["tgt"]
    tgt = tg["coords"].copy()
    tgt[:, 0] += tg["mask"]
    return (torch.as_tensor(np.concatenate([s["coords"], tgt])).to(dev),
            torch.as_tensor(np.concatenate([s["mask"], tg["mask"]])).to(dev))


def phase_kernels_family(dev, pair, cfg):
    """gather_rows and the two conv kernels vs their plain versions."""
    import torch

    from umeregrobust_tpu_torch.models.resunet import (
        ARCHS, build_unet_geometry, default_level_capacities)
    from umeregrobust_tpu_torch.ops import cuda_conv, cuda_gather

    rng = np.random.default_rng(0)
    out = {}

    # --- gather_rows
    def gather_case(tab, idx, timed=True):
        a = cuda_gather.gather_rows(tab, idx)
        b = cuda_gather.gather_rows_plain(tab, idx)
        torch.cuda.synchronize()
        mism = int((a != b).any(dim=1).sum())
        M, C, esz = idx.shape[0], tab.shape[1], tab.element_size()
        # each table row the indices name is read once (repeats come from
        # the cache), each output row written once, each index read once
        n_tab = tab.shape[0]
        rows_read = torch.unique(idx[(idx >= 0) & (idx < n_tab)]).numel()
        bb, by = bound_ms((rows_read + M) * C * esz + M * idx.element_size(),
                          0)
        res = dict(table=f"{n_tab}x{C}", rows=M, rows_read=rows_read,
                   dtype=str(tab.dtype)[6:], mismatched_rows=mism,
                   ok=mism == 0, bound_ms=bb, bound_by=by)
        if timed:
            safe = idx.clamp(min=0)
            res.update(
                ms=time_ms(lambda: cuda_gather.gather_rows(tab, idx)),
                plain_ms=time_ms(lambda: cuda_gather.gather_rows_plain(tab,
                                                                       idx)),
                library_ms=time_ms(lambda: torch.index_select(tab, 0, safe)))
        return res

    def device_times(res, tab, idx):  # the device alone (CUDA graph)
        safe = idx.clamp(min=0)
        res.update(
            kernel_ms=graph_ms(lambda: cuda_gather.gather_rows(tab, idx)),
            library_kernel_ms=graph_ms(
                lambda: torch.index_select(tab, 0, safe)),
            host_ms=host_ms(lambda: cuda_gather.gather_rows(tab, idx)))
        return res

    # main-path shapes: the feature transfer (4096 rows of the 16384 x 32
    # feature table) and feature_spatial_var (49 neighbours of each of
    # the 1024 anchor points)
    k = cfg.corr_var_knn - 1
    S = pair["src"]["corr_pts"].shape[0]
    G = pair["src"]["grid"].shape[0]
    main = {}
    anchors = min(cfg.corr_var_anchors or S, S)
    for name, n_tab, m in (("feat_to_raw", G, S),
                           ("spatial_var", S, anchors * k)):
        tab = torch.as_tensor(rng.standard_normal((n_tab, 32)),
                              dtype=torch.float32, device=dev)
        idx = torch.as_tensor(rng.integers(-1, n_tab, m), device=dev)
        main[name] = device_times(gather_case(tab, idx), tab, idx)
    # the probe script's grid: N = 32768 rows, C = 32 / 128 / 512
    N = 32768
    idx_rand = rng.integers(0, N, N)
    grid = {}
    for C in (32, 128, 512):
        for dt in (torch.float32, torch.bfloat16):
            tab = torch.as_tensor(rng.standard_normal((N, C)),
                                  dtype=torch.float32, device=dev).to(dt)
            for kind, ix in (("rand", idx_rand), ("mono", np.sort(idx_rand))):
                grid[f"C{C}_{str(dt)[6:]}_{kind}"] = gather_case(
                    tab, torch.as_tensor(ix, device=dev))
    # odd widths and int32 indices with absent rows: scalar path
    odd = {f"C{C}_{str(dt)[6:]}_int32": gather_case(
        torch.as_tensor(rng.standard_normal((1000, C)), dtype=torch.float32,
                        device=dev).to(dt),
        torch.as_tensor(rng.integers(-1, 1000, 777), device=dev,
                        dtype=torch.int32), timed=False)
        for C in (1, 7) for dt in (torch.float32, torch.bfloat16)}
    # row counts that are no multiple of the rows a block covers (256
    # threads, a 16-byte piece each), indices -1 and N (zero rows), both
    # index types
    edge = {}
    for C, dt in ((32, torch.float32), (32, torch.bfloat16),
                  (128, torch.float32)):
        per = 256 * 16 // (C * (2 if dt == torch.bfloat16 else 4))
        tab = torch.as_tensor(rng.standard_normal((1000, C)),
                              dtype=torch.float32, device=dev).to(dt)
        for it in (torch.int32, torch.int64):
            ix = rng.integers(-1, 1001, 3 * per + 5)
            ix[:2] = (-1, 1000)
            edge[f"C{C}_{str(dt)[6:]}_{str(it)[6:]}_ragged_idx_N"] = \
                gather_case(tab, torch.as_tensor(ix, device=dev, dtype=it),
                            timed=False)
    # the kNN scorer's step at the CLI's parity profile (kitti_test): the
    # 20 nearest of 8 hypotheses x 1024 source rows in a 10000 x 32 table
    tab = torch.as_tensor(rng.standard_normal((10000, 32)),
                          dtype=torch.float32, device=dev)
    idx = torch.as_tensor(rng.integers(0, 10000, 8 * 1024 * 20), device=dev)
    knn = {"knn_step": device_times(gather_case(tab, idx), tab, idx)}
    cases = {**main, **grid, **odd, **edge, **knn}
    out["gather_rows"] = dict(
        shape="per pair: " + ", ".join(
            f"{v['rows']} rows of {v['table']}" for v in main.values()),
        max_abs_err=float(sum(v["mismatched_rows"] for v in cases.values())),
        ok=all(v["ok"] for v in cases.values()), bound_by="bytes",
        cases=cases, **{key: sum(v[key] for v in main.values())
                        for key in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "kernel_ms",
                                    "library_kernel_ms")})

    # --- the conv kernels
    def make_maps(K, n):  # the experiment script's self-map model, int32
        maps = np.full((K, n), -1, np.int32)
        for t in range(K):
            hit = rng.random(n) < 0.45
            maps[t, np.nonzero(hit)[0]] = np.sort(
                rng.choice(n, size=hit.sum(), replace=False))
        maps[K // 2] = np.arange(n)
        return torch.as_tensor(maps, device=dev)

    arch = ARCHS["ResUNet"]
    coords2, mask2 = fused_pair(pair, dev)
    caps = tuple(2 * c for c in default_level_capacities(
        pair["src"]["coords"].shape[0], arch))
    geom = build_unet_geometry(coords2, mask2, arch, caps)
    masks = [lv.mask for lv in geom["levels"]]

    def layer(lv, cin, cout):  # encoder conv into level lv, random values
        in_mask = masks[max(lv - 1, 0)]
        f = torch.as_tensor(rng.standard_normal((in_mask.shape[0], cin)),
                            dtype=torch.float32, device=dev) * in_mask[:, None]
        K = geom["enc_maps"][lv].shape[0]
        w = torch.as_tensor(rng.standard_normal((K, cin, cout)),
                            dtype=torch.float32, device=dev) * float(
                                np.sqrt(2.0 / (K * cin)))
        return f, w, geom["enc_maps"][lv]

    C = 32
    layers = {
        "script_27x32x32": (torch.as_tensor(
            rng.standard_normal((N, C)), dtype=torch.float32, device=dev),
            torch.as_tensor(rng.standard_normal((27, C, C)) * 0.1,
                            dtype=torch.float32, device=dev),
            make_maps(27, N)),
        # widths that fill no tile: 77 rows, 3 -> 48 channels, int32 map
        "ragged_27x3x48": (torch.as_tensor(
            rng.standard_normal((77, 3)), dtype=torch.float32, device=dev),
            torch.as_tensor(rng.standard_normal((27, 3, 48)),
                            dtype=torch.float32, device=dev),
            make_maps(27, 77)),
        "resunet_stem_343x1x32": layer(0, 1, 32),
        "resunet_conv2_125x32x64": layer(1, 32, 64),
        "resunet_conv6_125x512x1024": layer(5, 512, 1024),
    }
    kernels = {"sparse_conv_rowtile": cuda_conv.sparse_conv_rowtile,
               "sparse_conv_tapsplit": cuda_conv.sparse_conv_tapsplit}
    per = {name: {} for name in kernels}
    for lname, (f, w, nbr) in layers.items():
        K, Cin, Cout = w.shape
        valid = int((nbr >= 0).sum())
        n_bytes = (f.numel() + w.numel() + nbr.shape[1] * Cout) * 4 \
            + nbr.numel() * nbr.element_size()
        routed = "sparse_conv_" + cuda_conv.choose_kernel(nbr.shape[1], Cout,
                                                          K)[0]
        for dt, lim, peak in ((torch.float32, 2e-5, F32_PEAK),
                              (torch.bfloat16, 1e-4, BF16_PEAK)):
            ref = cuda_conv.sparse_conv_plain(f, w, nbr, dt)
            plain = time_ms(lambda: cuda_conv.sparse_conv_plain(f, w, nbr, dt),
                            reps=5, warmup=1)
            bb, by = bound_ms(n_bytes, 2 * valid * Cin * Cout, peak)
            for name, fn in kernels.items():
                got = fn(f, w, nbr, dt)
                torch.cuda.synchronize()
                err, scale = float((got - ref).abs().max()), float(
                    ref.abs().max())
                per[name][f"{lname}_{str(dt)[6:]}"] = dict(
                    layer=lname, operands=str(dt)[6:],
                    shape=f"K{K} {Cin}->{Cout}, {f.shape[0]}->{nbr.shape[1]} "
                          f"rows, {valid} valid entries",
                    max_abs_err=err, scale=scale, limit=lim * scale,
                    ok=err <= lim * scale and scale > 0,
                    main_path_kernel=routed == name,
                    ms=time_ms(lambda: fn(f, w, nbr, dt)), plain_ms=plain,
                    bound_ms=bb, bound_by=by,
                    peak="fp32 67 TFLOP/s" if dt == torch.float32
                    else "bf16 989 TFLOP/s")
    for name, cases in per.items():
        # the row: the ResUNet layers that sparse_conv routes to this
        # kernel, with the main path's bf16-rounded operands
        real = [v for v in cases.values() if v["operands"] == "bfloat16"
                and v["layer"].startswith("resunet")]
        routed_here = [v for v in real if v["main_path_kernel"]]
        mine = routed_here or real
        out[name] = dict(
            shape="ResUNet layers routed here: " + "; ".join(
                v["shape"] for v in mine),
            max_abs_err=max(v["max_abs_err"] for v in cases.values()),
            ok=all(v["ok"] for v in cases.values()) and bool(routed_here),
            library_ms=None, cases=cases,
            bound_by=max(mine, key=lambda v: v["bound_ms"])["bound_by"],
            **{key: sum(v[key] for v in mine)
               for key in ("ms", "plain_ms", "bound_ms")})
    return out


def entries_match(nbr, n_in):
    """The entry-list kernel equals its plain twin exactly (64- and
    32-row tiles)."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_conv

    for tile_rows in (64, 32):
        got = cuda_conv.conv_entries(nbr, n_in, tile_rows)
        want = cuda_conv.conv_entries_plain(nbr, n_in, tile_rows)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            return False
    return True


def conv_forced_cases(dev):
    """Both conv wrappers at forced maps and widths, fp32 and bf16
    operands, against sparse_conv_plain (max abs error <= 2e-5 / 1e-4 x
    max |out|), two launches bit-identical. Returns (cases, all passed)."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_conv

    rng = np.random.default_rng(11)

    def case(n_in, n_out, K, cin, cout, idx, p=0.3, hi=None, edit=None):
        """Per tap a monotone subsequence of [0, hi) (hi > n_in: some
        indices absent) at about a share p of the rows."""
        hi = n_in if hi is None else hi
        maps = np.full((K, n_out), -1, np.int64)
        for t in range(K):
            rows = np.nonzero(rng.random(n_out) < p)[0][:hi]
            maps[t, rows] = np.sort(rng.choice(hi, rows.size, replace=False))
        if edit is not None:
            edit(maps)
        f = rng.standard_normal((n_in, cin))
        w = rng.standard_normal((K, cin, cout)) * np.sqrt(2.0 / (K * cin))
        return (torch.as_tensor(f, dtype=torch.float32, device=dev),
                torch.as_tensor(w, dtype=torch.float32, device=dev),
                torch.as_tensor(maps, device=dev).to(idx))

    def lone_row(maps):  # tap 5 empty; rows 128..255 (a 128-row tile of
        maps[5] = -1     # the row-tile kernel, two 64-row tiles of the
        maps[:, 128:256] = -1  # entry lists) hold only row 200
        maps[13, 200] = 7

    def all_valid(maps):
        maps[:] = rng.integers(0, maps.shape[1], maps.shape)

    def repeated_rows(maps):  # every entry valid, input rows hit many
        maps[:] = rng.integers(0, 50, maps.shape)  # times a tap: more
        # entries than tapsplit's scratch rows (K min(N_in, N_out))

    i32, i64 = torch.int32, torch.int64
    cases = {
        "empty_tap_lone_row_tile": case(300, 300, 27, 32, 64, i64,
                                        edit=lone_row),
        "all_valid": case(256, 256, 27, 16, 32, i32, edit=all_valid),
        "repeated_rows_past_scratch": case(50, 300, 27, 16, 32, i32,
                                           edit=repeated_rows),
        "absent_ge_N_in_N_out_gt_N_in": case(100, 260, 27, 8, 48, i64,
                                             p=0.4, hi=130),
        "cin1_k343_cout32": case(2000, 2000, 343, 1, 32, i32, p=0.07),
        "cin3_cout48": case(777, 777, 125, 3, 48, i64, p=0.1),
        "cin320_cout128": case(600, 600, 125, 320, 128, i32, p=0.05),
        "cin384_cout1024": case(300, 300, 27, 384, 1024, i64, p=0.2),
        "cin768_cout48": case(400, 400, 125, 768, 48, i32, p=0.02),
    }
    res, ok_all = {}, True
    for name, (f, w, nbr) in cases.items():
        r = {}
        for dt, lim in ((torch.float32, 2e-5), (torch.bfloat16, 1e-4)):
            ref = cuda_conv.sparse_conv_plain(f, w, nbr, dt)
            scale = float(ref.abs().max())
            for kind in ("rowtile", "tapsplit"):
                fn = getattr(cuda_conv, "sparse_conv_" + kind)
                a, a2 = fn(f, w, nbr, dt), fn(f, w, nbr, dt)
                torch.cuda.synchronize()
                err = float((a - ref).abs().max())
                ok = err <= lim * scale and scale > 0 and torch.equal(a, a2)
                r[f"{kind}_{str(dt)[6:]}"] = dict(max_abs_err=err,
                                                  limit=lim * scale, ok=ok)
                ok_all &= ok
        same = entries_match(nbr, f.shape[0])
        ok_all &= same
        res[name] = dict(shape=f"K{w.shape[0]} {w.shape[1]}->{w.shape[2]}, "
                               f"{f.shape[0]}->{nbr.shape[1]} rows, "
                               f"{str(nbr.dtype)[6:]}",
                         entries_match_plain=same, **r)
    return res, ok_all


def capture_conv_layers(model, run):
    """Every per-tap conv launch of one feature stage of `model`, run by
    `run()` (bf16 operands, as register_pair_e2e runs it): (parameter
    name, features, weights, map, pairs) in launch order."""
    import torch

    import umeregrobust_tpu_torch.models.resunet as resunet

    names = {p.data_ptr(): n[:-2] for n, p in model.named_parameters()}
    got, conv = [], resunet.sparse_conv

    def record(feats, w, nbr, bias=None, compute_dtype=torch.float32,
               pairs=1):
        got.append((names.get(w.data_ptr(), "?"),
                    feats.to(torch.float32).contiguous(),
                    w.detach().contiguous(), nbr.contiguous(), pairs))
        return conv(feats, w, nbr, bias=bias, compute_dtype=compute_dtype,
                    pairs=pairs)

    resunet.sparse_conv = record
    try:
        with torch.no_grad():
            run()
    finally:
        resunet.sparse_conv = conv
    torch.cuda.synchronize()
    return got


def conv_bound(f, w, nbr):
    """(bound ms, bound_by, bound ms with bf16 weights, valid entries, taps
    with an entry) of one conv launch at bf16 operands. Bytes: the map, the
    feature rows it reads, the weights of the taps that have an entry, the
    output; operations: the valid entries' products."""
    import torch

    K, Cin, Cout = w.shape
    N_in, N_out = f.shape[0], nbr.shape[1]
    hit = (nbr >= 0) & (nbr < N_in)
    valid = int(hit.sum())
    taps_used = int(hit.any(1).sum())
    rows_read = int(torch.unique(nbr[hit]).numel())
    n_bytes = (nbr.numel() * nbr.element_size() + rows_read * Cin * 4
               + taps_used * Cin * Cout * 4 + N_out * Cout * 4)
    bb, by = bound_ms(n_bytes, 2 * valid * Cin * Cout, BF16_PEAK)
    bb16, _ = bound_ms(n_bytes - taps_used * Cin * Cout * 2,
                       2 * valid * Cin * Cout, BF16_PEAK)
    return bb, by, bb16, valid, taps_used


IM2COL_LIMIT = 8e9  # bytes of the library route's im2col tensor


def old_route(n_out, cout, k_vol):
    """The FMA tile that the port's first conv kernels routed a layer to
    (choose_kernel before the tensor-core redesign): rowtile when its
    64 x (64 or 32) output tiles alone reach 132, else tapsplit."""
    tiles = -(-n_out // 64) * -(-cout // (64 if cout >= 64 else 32))
    return "rowtile" if tiles >= 132 or k_vol == 1 else "tapsplit"


def conv_layer_row(name, f, w, nbr):
    """One real conv launch at bf16 operands: both wrappers against the
    plain version (two launches bit-identical) and their device times
    (CUDA graph), the routed one's time one call an event pair, the entry
    lists against their plain twin, the FMA tile that the first port's
    rule routed the layer to (the old kernel), the bound, and the library
    route (gather into a zero-padded (N_out, K Cin) bf16 im2col tensor,
    then one torch.mm), timed apart."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_conv

    bf = torch.bfloat16
    K, Cin, Cout = w.shape
    N_in, N_out = f.shape[0], nbr.shape[1]
    bb, by, bb16, valid, taps_used = conv_bound(f, w, nbr)
    kind = cuda_conv.choose_kernel(N_out, Cout, K)[0]
    fn = getattr(cuda_conv, "sparse_conv_" + kind)
    ref = cuda_conv.sparse_conv_plain(f, w, nbr, bf)
    scale = float(ref.abs().max())
    both = {}  # each wrapper on this layer: error, bits, device time
    for other in ("rowtile", "tapsplit"):
        g = getattr(cuda_conv, "sparse_conv_" + other)
        b1, b2 = g(f, w, nbr, bf), g(f, w, nbr, bf)
        torch.cuda.synchronize()
        e = float((b1 - ref).abs().max())
        both[other] = dict(max_abs_err=e, ok=e <= 1e-4 * scale
                           and torch.equal(b1, b2),
                           kernel_ms=graph_ms(lambda: g(f, w, nbr, bf),
                                              reps=5, inner=10))
    entries_same = entries_match(nbr, N_in)
    old_kind = old_route(N_out, Cout, K)
    old = cuda_conv.sparse_conv_fma(f, w, nbr, old_kind, bf)
    torch.cuda.synchronize()
    err = both[kind]["max_abs_err"]
    row = dict(
        layer=name, kernel=kind, K=K, cin=Cin, cout=Cout, rows_in=N_in,
        rows_out=N_out, valid=valid, density=valid / (K * N_out),
        taps_used=taps_used, max_abs_err=err, scale=scale,
        ok=all(v["ok"] for v in both.values()) and scale > 0
        and entries_same, entries_match_plain=entries_same,
        old_max_abs_err=float((old - ref).abs().max()),
        ms=time_ms(lambda: fn(f, w, nbr, bf), reps=10),
        kernel_ms=both[kind]["kernel_ms"],
        kernel_ms_rowtile=both["rowtile"]["kernel_ms"],
        kernel_ms_tapsplit=both["tapsplit"]["kernel_ms"],
        max_abs_err_other=both["tapsplit" if kind == "rowtile"
                               else "rowtile"]["max_abs_err"],
        plain_ms=time_ms(lambda: cuda_conv.sparse_conv_plain(f, w, nbr, bf),
                         reps=3, warmup=1),
        old_kernel=old_kind,
        old_ms=time_ms(lambda: cuda_conv.sparse_conv_fma(
            f, w, nbr, old_kind, bf), reps=10),
        old_kernel_ms=graph_ms(lambda: cuda_conv.sparse_conv_fma(
            f, w, nbr, old_kind, bf), reps=5, inner=10),
        bound_ms=bb, bound_by=by, bound_ms_bf16_weights=bb16)
    im2col = N_out * K * Cin * 2
    if im2col > IM2COL_LIMIT:
        row.update(library_ms=None, library_note=f"im2col {im2col / 1e9:.1f}"
                   f" GB > {IM2COL_LIMIT / 1e9:.0f} GB")
        return row
    hit = (nbr >= 0) & (nbr < N_in)
    idx = torch.where(hit, nbr, N_in).T.contiguous()  # (N_out, K)
    wb = w.reshape(K * Cin, Cout).to(bf)

    def gather():
        fp = torch.nn.functional.pad(f.to(bf), (0, 0, 0, 1))
        return fp[idx].reshape(N_out, K * Cin)

    A = gather()
    lib_err = float((torch.mm(A, wb).float() - ref).abs().max())
    g_ms = time_ms(gather, reps=10)
    m_ms = time_ms(lambda: torch.mm(A, wb), reps=10)
    del A
    row.update(library_gather_ms=g_ms, library_gemm_ms=m_ms,
               library_ms=g_ms + m_ms, library_max_abs_err=lib_err)
    return row


def phase_conv_layers(dev, pair, weights):
    """Every conv launch of the ResUNet forward (11) and of the
    ResUNetSmall2 conv_impl="scan" forward (18) on the nominal pair, one
    row each (conv_layer_row), with their sums."""
    import torch

    from umeregrobust_tpu_torch.data.suite import REDUCED
    from umeregrobust_tpu_torch.models.resunet import (
        ARCHS, default_level_capacities, init_resunet)
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.pipeline.e2e import pair_features_e2e

    n0 = pair["src"]["coords"].shape[0]
    models = {
        "ResUNet": (lambda: init_resunet(
            ARCHS["ResUNet"], 1, 32, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0)),
            default_level_capacities(n0, ARCHS["ResUNet"])),
        "ResUNetSmall2_scan": (lambda: load_model(
            weights, ARCHS["ResUNetSmall2"], device=dev, conv_impl="scan"),
            REDUCED["caps"])}
    out = {}
    for mname, (make, caps) in models.items():
        model = make()
        layers = capture_conv_layers(model, lambda: pair_features_e2e(
            model, caps, *pair_args(pair), device=dev))
        del model
        rows = []
        for name, f, w, nbr, _ in layers:
            rows.append(conv_layer_row(name, f, w, nbr))
            emit({"phase": "conv_layer", "model": mname, **rows[-1]})
        del layers
        keys = ("ms", "kernel_ms", "old_ms", "old_kernel_ms", "bound_ms",
                "bound_ms_bf16_weights", "kernel_ms_rowtile",
                "kernel_ms_tapsplit")
        summary = {k: sum(r[k] for r in rows) for k in keys}
        lib = [r["library_ms"] for r in rows if r["library_ms"] is not None]
        summary.update(
            launches=len(rows), library_ms=sum(lib),
            library_layers=len(lib), ok=all(r["ok"] for r in rows),
            by_kernel={k: {key: sum(r[key] for r in rows if r["kernel"] == k)
                           for key in keys}
                       for k in ("rowtile", "tapsplit")},
            layers_slower_than_old=[r["layer"] for r in rows
                                    if r["kernel_ms"] > r["old_kernel_ms"]])
        emit({"phase": "conv_layers_summary", "model": mname, **summary})
        out[mname] = dict(rows=rows, **summary)
    return out


def capture_grouped_layers(model, run):
    """Every grouped k3 conv of one feature stage of `model`, run by
    `run()`: (parameter name, features, weights, GroupedMap, pairs, the
    output level's mask, the adjoint (map, reverse_taps) the model hands
    the conv's backward) in launch order (the conv itself runs as it
    would; a layer named conv{k}, block{k}.*, conv{k}_tr or block{k}_tr.*
    writes level k - 1)."""
    import re

    import torch

    import umeregrobust_tpu_torch.models.resunet as resunet

    names = {p.data_ptr(): n[:-2] for n, p in model.named_parameters()}
    got, levels = [], []
    conv, fwd = resunet.sparse_conv_grouped, resunet.ResUNet.forward

    def forward(self, geom, *a, **kw):
        levels[:] = [lv.mask for lv in geom["levels"]]
        return fwd(self, geom, *a, **kw)

    def record(feats, w, gmap, bias=None, compute_dtype=torch.float32,
               pairs=1, adjoint=None):
        name = names.get(w.data_ptr(), "?")
        got.append((name, feats.to(torch.float32).contiguous(),
                    w.detach().contiguous(), gmap, pairs,
                    levels[int(re.search(r"\d+", name).group()) - 1],
                    adjoint))
        return conv(feats, w, gmap, bias=bias, compute_dtype=compute_dtype,
                    pairs=pairs, adjoint=adjoint)

    resunet.sparse_conv_grouped, resunet.ResUNet.forward = record, forward
    try:
        with torch.no_grad():
            run()
    finally:
        resunet.sparse_conv_grouped, resunet.ResUNet.forward = conv, fwd
    torch.cuda.synchronize()
    return got


_PARENT_GROUPED = None


def parent_grouped_library():
    """csrc/bench/sparse_conv_grouped_parent.cu (the grouped conv's bf16
    kernel before its Hopper redesign, the same-call yardstick), built
    with the kernels' nvcc flags into the build directory and loaded;
    once a process."""
    global _PARENT_GROUPED
    if _PARENT_GROUPED is None:
        import ctypes

        from umeregrobust_tpu_torch.ops import _build

        src = _build.CSRC / "bench" / "sparse_conv_grouped_parent.cu"
        lib = (_build.BUILD_DIR / "bench"
               / f"libgrouped_parent.{os.getpid()}.so")
        lib.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build._find_nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-shared", str(src), "-o",
                            str(lib), "-lcudart"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError("sparse_conv_grouped_parent.cu did not build:"
                               f"\n{r.stdout}")
        cdll = ctypes.CDLL(str(lib))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        cdll.umr_bench_grouped_parent.argtypes = (
            [vp] * 10 + [ll, ll] + [i] * 6 + [vp])
        cdll.umr_bench_grouped_parent.restype = i
        _PARENT_GROUPED = cdll
    return _PARENT_GROUPED


def parent_grouped(f, w, gmap, dx_taps=0):
    """The parent tree's bf16 grouped conv kernel on the same inputs (its
    bf16 copies made in the call, its tile rule: 128-row tiles, or 64 /
    32 where 128 would give fewer blocks than 132); dx_taps 1 / 2: its dX
    route (w the forward's weights). Not counted in any launch count."""
    import torch

    from umeregrobust_tpu_torch.ops import _build

    lib = parent_grouped_library()
    _, Cin, Cout = w.shape
    if dx_taps:
        Cin, Cout = Cout, Cin
    N_in, N_out = f.shape[0], gmap.center.shape[1]
    cin8, cout8 = -(-Cin // 8) * 8, -(-Cout // 8) * 8
    cols = -(-Cout // 64)
    rows = next((r for r in (128, 64, 32) if -(-N_out // r) * cols >= 132),
                32)
    dev = f.device
    out = torch.empty((N_out, Cout), dtype=torch.float32, device=dev)
    xb = torch.empty(max(N_in, 1) * cin8, dtype=torch.bfloat16, device=dev)
    wb = torch.empty(27 * cin8 * cout8, dtype=torch.bfloat16, device=dev)
    code = lib.umr_bench_grouped_parent(
        f.data_ptr(), w.data_ptr(), gmap.center.data_ptr(),
        gmap.masks.data_ptr(), gmap.patho.data_ptr(), gmap.worder.data_ptr(),
        0, xb.data_ptr(), wb.data_ptr(), out.data_ptr(), N_in, N_out, Cin,
        Cout, int(gmap.center.dtype == torch.int64), 1, rows, dx_taps,
        _build.stream_of(dev))
    if code != 0:
        raise RuntimeError(f"umr_bench_grouped_parent: CUDA error {code}")
    return out


_PARENT_WGRAD = None


def parent_wgrad_library():
    """csrc/bench/sparse_conv_grouped_wgrad_parent.cu (the grouped conv's
    weight-gradient kernel before its Hopper redesign, the same-call
    yardstick), built as parent_grouped_library builds the forward's;
    once a process."""
    global _PARENT_WGRAD
    if _PARENT_WGRAD is None:
        import ctypes

        from umeregrobust_tpu_torch.ops import _build

        src = _build.CSRC / "bench" / "sparse_conv_grouped_wgrad_parent.cu"
        lib = (_build.BUILD_DIR / "bench"
               / f"libwgrad_parent.{os.getpid()}.so")
        lib.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build._find_nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-shared", str(src), "-o",
                            str(lib), "-lcudart"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError("sparse_conv_grouped_wgrad_parent.cu did not "
                               f"build:\n{r.stdout}")
        cdll = ctypes.CDLL(str(lib))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        cdll.umr_bench_grouped_wgrad_parent.argtypes = (
            [vp] * 10 + [ll, ll] + [i] * 5 + [vp])
        cdll.umr_bench_grouped_wgrad_parent.restype = i
        _PARENT_WGRAD = cdll
    return _PARENT_WGRAD


def parent_wgrad(f, dy, gmap):
    """The parent tree's bf16 grouped weight-gradient kernel on the same
    inputs (dY rounded to bf16, as it did; its split rule: the fewest
    splits of at most 256 steps of 32 rows that give about two blocks an
    SM, its bf16 copies and partials made in the call). Not counted in
    any launch count."""
    import torch

    from umeregrobust_tpu_torch.ops import _build

    lib = parent_wgrad_library()
    (N_in, Cin), (N_out, Cout) = f.shape, dy.shape
    cin8, cout8 = -(-Cin // 8) * 8, -(-Cout // 8) * 8
    tiles = -(-3 * cin8 // 64) * -(-cout8 // 64)
    steps = max(1, -(-N_out // 32))
    splits = max(-(-steps // 256), min(steps, -(-2 * 132 // (9 * tiles))))
    per = -(-steps // splits)
    splits = -(-steps // per)
    dev = f.device
    dw = torch.empty((27, Cin, Cout), dtype=torch.float32, device=dev)
    part = torch.empty(splits * 9 * 3 * cin8 * cout8, dtype=torch.float32,
                       device=dev)
    xb = torch.empty(max(N_in, 1) * cin8, dtype=torch.bfloat16, device=dev)
    yb = torch.empty(N_out * cout8, dtype=torch.bfloat16, device=dev)
    code = lib.umr_bench_grouped_wgrad_parent(
        f.data_ptr(), dy.data_ptr(), gmap.center.data_ptr(),
        gmap.masks.data_ptr(), gmap.patho.data_ptr(), gmap.worder.data_ptr(),
        xb.data_ptr(), yb.data_ptr(), part.data_ptr(), dw.data_ptr(), N_in,
        N_out, Cin, Cout, int(gmap.center.dtype == torch.int64), 1,
        per * 32, _build.stream_of(dev))
    if code != 0:
        raise RuntimeError(f"umr_bench_grouped_wgrad_parent: CUDA error "
                           f"{code}")
    return dw


def wgrad_staging(gmap, cin):
    """(windows the bf16 weight-gradient kernel stages, windows some row
    uses): the map's tiles' groups x 64 rows, the stem (Cin <= 2) every
    group of every 64-row tile in code order."""
    from umeregrobust_tpu_torch.ops import cuda_grouped

    used = int((gmap.masks.any(1) | gmap.patho).sum())
    n_out = gmap.masks.shape[-1]
    if cin <= 2:
        return 9 * -(-n_out // 64) * 64, used
    lists = cuda_grouped.wgrad_units_plain(gmap)
    return sum(int(x.numel()) for x in lists) * 64, used


def grouped_map_stats(gmap):
    """The kernel's view of a map: its order's tiles, the windows they
    stage (each tile's groups x 64 rows) against the windows some row
    uses (and in code order), and whether the map's order and tiles are
    grouped_row_order_plain's."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_grouped

    gm = cuda_grouped.with_row_order(gmap)
    o, t = cuda_grouped.grouped_row_order_plain(gm)
    used = int((gm.masks.any(1) | gm.patho).sum())
    staged = int(sum(bin(int(x)).count("1") for x in gm.tiles.cpu()) * 64)
    code_tiles = cuda_grouped.tiles_of_order(gm, torch.arange(
        gm.masks.shape[-1], device=gm.masks.device))
    staged_code = int(sum(bin(int(x)).count("1") for x in code_tiles.cpu())
                      * 64)
    return dict(tiles=int(gm.tiles.numel()), windows_staged=staged,
                windows_staged_code_order=staged_code,
                staged_over_used=staged / max(used, 1),
                order_is_plain=bool(torch.equal(gm.order, o)
                                    and torch.equal(gm.tiles, t)))


def grouped_bound(f, w, gmap):
    """(bound ms, bound_by, windows used, input rows read) of one grouped
    conv at bf16 operands. Operations: 2 x 3 Cin x Cout a window that some
    slot uses; bytes: the bf16 input rows some slot reads, the map
    (centres, masks, patho), the bf16 weights and the fp32 output, each
    once."""
    import torch

    from umeregrobust_tpu_torch.ops.sparse import ungroup_kernel_map

    _, Cin, Cout = w.shape
    N_in, N_out = f.shape[0], gmap.center.shape[1]
    used = int((gmap.masks.any(1) | gmap.patho).sum())
    nbr = ungroup_kernel_map(gmap)
    rows_read = int(torch.unique(nbr[(nbr >= 0) & (nbr < N_in)]).numel())
    map_bytes = sum(x.numel() * x.element_size()
                    for x in (gmap.center, gmap.masks, gmap.patho))
    n_bytes = (rows_read * Cin * 2 + map_bytes + 27 * Cin * Cout * 2
               + N_out * Cout * 4)
    bb, by = bound_ms(n_bytes, 2 * used * 3 * Cin * Cout, BF16_PEAK)
    return bb, by, used, rows_read


GROUPED_LIMITS = {"float32": 1e-5, "bfloat16": 1e-4}  # x max |plain|


def order_forms(gmap):
    """The map in four row orders, each with its tiles' groups
    (cuda_grouped.tiles_of_order): its own order (the pyramid's, or
    grouped_row_order's), code order, that order reversed, and a seeded
    random permutation."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_grouped

    gmap = cuda_grouped.with_row_order(gmap)
    n, dev = gmap.masks.shape[-1], gmap.masks.device
    g = torch.Generator(device="cpu").manual_seed(n)
    orders = {"map": gmap.order,
              "code": torch.arange(n, dtype=torch.int32, device=dev),
              "reversed": gmap.order.flip(0).contiguous(),
              "random": torch.randperm(n, generator=g).to(
                  device=dev, dtype=torch.int32)}
    return {k: gmap._replace(order=o, tiles=cuda_grouped.tiles_of_order(
        gmap, o)) for k, o in orders.items()}


def grouped_orders(f, w, gmap, bias=None):
    """Whether the bf16 kernel gives the same bits in every row order of
    order_forms (its tiles' groups, and so which rows share a tile,
    change with the order; a row's sums must not)."""
    import torch

    from umeregrobust_tpu_torch.ops.cuda_grouped import (
        sparse_conv_grouped_kernel)

    outs = [sparse_conv_grouped_kernel(f, w, m, bias, torch.bfloat16)
            for m in order_forms(gmap).values()]
    return all(torch.equal(outs[0], o) for o in outs[1:])


def grouped_check(f, w, gmap, bias=None):
    """The grouped kernel against sparse_conv_grouped_plain on the card at
    fp32 and bf16 operands (max abs error within GROUPED_LIMITS x max
    |plain|; only the fp32 summation order differs), two launches
    bit-identical, the first launch's output and bf16 copies between
    guards that must stay unwritten (guarded_empty); with bf16 operands
    also the same bits in every row order (grouped_orders)."""
    import torch

    from umeregrobust_tpu_torch.ops.cuda_grouped import (
        sparse_conv_grouped_kernel)
    from umeregrobust_tpu_torch.ops.sparse import sparse_conv_grouped_plain

    res = {}
    for name, lim in GROUPED_LIMITS.items():
        dt = getattr(torch, name)
        ref = sparse_conv_grouped_plain(f, w, gmap, bias, dt)
        scale = float(ref.abs().max())
        with guarded_empty() as made:
            a = sparse_conv_grouped_kernel(f, w, gmap, bias, dt)
        b = sparse_conv_grouped_kernel(f, w, gmap, bias, dt)
        torch.cuda.synchronize()
        err = float((a - ref).abs().max())
        twice, guards = bool(torch.equal(a, b)), guards_intact(made)
        orders = dt == torch.float32 or grouped_orders(f, w, gmap, bias)
        res[name] = dict(max_abs_err=err, limit=lim * scale, scale=scale,
                         two_launches_identical=twice, guards_intact=guards,
                         orders_identical=orders,
                         ok=err <= lim * scale and twice and guards and orders
                         and bool(torch.isfinite(a).all()))
        del made, a, b, ref
    return res


def forced_grouped_map(rng, dev, n_in, n_out, idx, p=0.5, patho=0.05,
                       transposed=False, edit=None):
    """A random GroupedMap with the map's invariant (masks[2] off where
    patho is set): centres in [0, n_in + 4), each slot on with
    probability p, patho rows with probability `patho`, the transposed
    slot order if asked, centres of type idx; `edit(center, masks, pat)`
    changes the numpy arrays first."""
    import torch

    from umeregrobust_tpu_torch.ops.sparse import GroupedMap

    center = rng.integers(0, n_in + 4, (9, n_out))
    masks = rng.random((9, 3, n_out)) < p
    pat = (rng.random((9, n_out)) < patho) & ~masks[:, 2]
    if edit is not None:
        edit(center, masks, pat)
    return GroupedMap(
        center=torch.as_tensor(center, device=dev).to(idx),
        masks=torch.as_tensor(masks, device=dev),
        patho=torch.as_tensor(pat, device=dev),
        worder=torch.tensor([2, 1, 0] if transposed else [0, 1, 2],
                            device=dev))


def grouped_forced_cases(dev):
    """The grouped kernel on forced maps (random centres, masks and patho
    rows with the map's invariant: masks[2] off where patho is set):
    Cin 1 / 3 / 16 / 20 / 24 / 32 / 64 / 96 / 256 / 768, Cout 5 / 7 / 32
    / 48 / 64 / 256 (clusters of 1 to 4 CTAs), N_out < N_in and N_out >
    N_in with centres past the table, tiles whose rows use different
    groups, a group whose one user the order puts in the last tile, a
    stretch of rows and a group that no window uses, many patho rows, the
    transposed slot order, int32 and int64 centres, with and without
    bias; each at fp32 and bf16 (grouped_check: also every row order).
    Returns (cases, all passed)."""
    import torch

    rng = np.random.default_rng(17)

    def case(n_in, n_out, cin, cout, idx, p=0.5, patho=0.05,
             transposed=False, bias=False, edit=None):
        gmap = forced_grouped_map(rng, dev, n_in, n_out, idx, p, patho,
                                  transposed, edit)
        f = torch.as_tensor(rng.standard_normal((n_in, cin)),
                            dtype=torch.float32, device=dev)
        w = torch.as_tensor(rng.standard_normal((27, cin, cout))
                            / np.sqrt(27 * cin), dtype=torch.float32,
                            device=dev)
        b = (torch.as_tensor(rng.standard_normal(cout), dtype=torch.float32,
                             device=dev) if bias else None)
        return f, w, gmap, b

    def unused(center, masks, pat):  # rows 128..255 use no window, and
        masks[:, :, 128:256] = False  # group 4 none anywhere
        pat[:, 128:256] = False
        masks[4], pat[4] = False, False

    def past_table(center, masks, pat):  # "no candidate" centres past a
        center[:, ::3] = center.shape[1] + 2  # small table (N_out > N_in)

    def mixed_masks(center, masks, pat):  # each row uses 1-3 groups of
        n = center.shape[1]  # its own: a tile's rows differ in mask
        keep = np.zeros((9, n), dtype=bool)
        for k in range(3):
            keep[rng.integers(0, 9, n), np.arange(n)] = True
        masks &= keep[:, None, :]
        pat &= keep
        masks[:, 1] |= keep & ~masks.any(1) & ~pat  # every kept group used

    def last_tile_only(center, masks, pat):  # group 8's one user is row 0,
        masks[8], pat[8] = False, False  # which the order puts last (the
        masks[8, 1, 0] = True  # highest mask), in the last tile
        masks[:8, 1, :] = True

    i32, i64 = torch.int32, torch.int64
    cases = {
        "mixed_masks_in_a_tile": case(900, 1000, 32, 64, i64,
                                      edit=mixed_masks),
        "group8_only_in_last_tile": case(600, 700, 24, 48, i32,
                                         edit=last_tile_only),
        # the cluster split (1, 1, 2, 3 and 4 CTAs a tile)
        "cluster_cin1_cout5": case(2000, 2100, 1, 5, i32),
        "cluster_cin3_cout7": case(1500, 1400, 3, 7, i64, bias=True),
        "cluster_cin20_cout48": case(1200, 1300, 20, 48, i32),
        "cluster_cin64_cout256": case(700, 600, 64, 256, i64),
        "cluster_cin768_cout256": case(300, 350, 768, 256, i64, p=0.2),
        "cin1_cout32": case(3000, 3000, 1, 32, i64),
        "cin20_cout7_nout_lt_nin": case(1000, 700, 20, 7, i32, bias=True),
        "cin96_cout48_nout_gt_nin": case(500, 1300, 96, 48, i64,
                                         edit=past_table),
        "cin16_cout5_transposed": case(600, 900, 16, 5, i32,
                                       transposed=True, bias=True),
        "unused_tile_and_group": case(700, 700, 32, 64, i64, edit=unused),
        "patho_rows": case(800, 800, 24, 32, i64, p=0.3, patho=0.6),
        "cin768_cout48": case(400, 400, 768, 48, i32, p=0.2),
        "cin256_cout256": case(512, 512, 256, 256, i64, bias=True),
    }
    res, ok_all = {}, True
    for name, (f, w, gmap, b) in cases.items():
        r = grouped_check(f, w, gmap, b)
        ok_all &= all(v["ok"] for v in r.values())
        res[name] = dict(shape=f"{w.shape[1]}->{w.shape[2]}, {f.shape[0]}->"
                               f"{gmap.center.shape[1]} rows, "
                               f"{str(gmap.center.dtype)[6:]} centres",
                         **r)
    return res, ok_all


def pair_rows_identical(out_b, mask_b, outs1, masks1):
    """Whether each pair's output rows of a B-pair call (output level mask
    mask_b: the pairs' valid rows one prefix, in pair order) are the bits
    of its one-pair call (mask masks1[i], a valid prefix)."""
    import torch

    start = 0
    for o, m in zip(outs1, masks1):
        n = int(m.sum())
        if not (bool(m[:n].all()) and torch.equal(out_b[start:start + n],
                                                  o[:n])):
            return False
        start += n
    return int(mask_b.sum()) == start and bool(mask_b[:start].all())


def grouped_layer_row(name, f, w, gmap):
    """One grouped k3 conv of the one-pair forward at its real shape:
    grouped_check, the kernel's plan and map (grouped_map_stats), the
    kernel's device time alone (CUDA graph) and one call an event pair,
    the parent tree's kernel's device time alone in the same call
    (parent_kernel_ms, parent_grouped) and its error, the fp32 path's
    device time, the plain version's time, the bound, the library route
    (one gather of the 27 tap rows into a zero-padded (N_out, 27 Cin)
    bf16 tensor, then one torch.mm; timed only) and the per-tap kernel
    that choose_kernel routes the same map to (ungroup_kernel_map), as a
    second yardstick."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_conv, cuda_grouped
    from umeregrobust_tpu_torch.ops.cuda_grouped import (
        sparse_conv_grouped_kernel as kern)
    from umeregrobust_tpu_torch.ops.sparse import (
        sparse_conv_grouped_plain, ungroup_kernel_map)

    bf, f32 = torch.bfloat16, torch.float32
    _, Cin, Cout = w.shape
    N_in, N_out = f.shape[0], gmap.center.shape[1]
    chk = grouped_check(f, w, gmap)
    bb, by, used, rows_read = grouped_bound(f, w, gmap)
    nbr = ungroup_kernel_map(gmap)
    tap_kind = cuda_conv.choose_kernel(N_out, Cout, 27)[0]
    tap = getattr(cuda_conv, "sparse_conv_" + tap_kind)
    plan = cuda_grouped.grouped_plan(N_in, N_out, Cin, Cout, bf)
    parent = parent_grouped(f, w, gmap)
    ref = sparse_conv_grouped_plain(f, w, gmap, None, bf)
    row = dict(
        layer=name, cin=Cin, cout=Cout, rows_in=N_in, rows_out=N_out,
        windows_used=used, window_share=used / (9 * N_out),
        rows_read=rows_read, max_abs_err=chk["bfloat16"]["max_abs_err"],
        limit=chk["bfloat16"]["limit"],
        max_abs_err_fp32=chk["float32"]["max_abs_err"],
        limit_fp32=chk["float32"]["limit"],
        parent_max_abs_err=float((parent - ref).abs().max()),
        two_launches_identical=all(v["two_launches_identical"]
                                   for v in chk.values()),
        cluster=plan.cluster, tile_cols=plan.tile_cols,
        k_steps=plan.k_steps, grid=plan.grid, **grouped_map_stats(gmap),
        orders_identical=chk["bfloat16"]["orders_identical"],
        guards_intact=all(v["guards_intact"] for v in chk.values()),
        ok=all(v["ok"] for v in chk.values()),
        ms=time_ms(lambda: kern(f, w, gmap, None, bf), reps=10),
        kernel_ms=graph_ms(lambda: kern(f, w, gmap, None, bf), reps=5,
                           inner=10),
        parent_kernel_ms=graph_ms(lambda: parent_grouped(f, w, gmap),
                                  reps=5, inner=10),
        kernel_ms_fp32=graph_ms(lambda: kern(f, w, gmap, None, f32), reps=3,
                                inner=5),
        plain_ms=time_ms(lambda: sparse_conv_grouped_plain(
            f, w, gmap, None, bf), reps=3, warmup=1),
        bound_ms=bb, bound_by=by, per_tap_kernel=tap_kind,
        per_tap_kernel_ms=graph_ms(lambda: tap(f, w, nbr, bf), reps=5,
                                   inner=10))
    hit = (nbr >= 0) & (nbr < N_in)
    idx = torch.where(hit, nbr, N_in).T.contiguous()  # (N_out, 27)
    wb = w.reshape(27 * Cin, Cout).to(bf)

    def library():
        fp = torch.nn.functional.pad(f.to(bf), (0, 0, 0, 1))
        return torch.mm(fp[idx].reshape(N_out, 27 * Cin), wb)

    if N_out * 27 * Cin * 2 > IM2COL_LIMIT:
        row.update(library_ms=None, library_kernel_ms=None)
    else:
        row.update(library_ms=time_ms(library, reps=10),
                   library_kernel_ms=graph_ms(library, reps=5, inner=10))
    return row


def phase_grouped_layers(dev, pairs, weights):
    """Every grouped k3 conv of a ResUNetSmall2 one-pair forward (the
    in-repo weights, the reduced point) on the nominal pair, one row each
    (grouped_layer_row), with their sums; the same layers of the four
    regime pairs as one B = 4 forward, each pair's rows against its own
    one-pair call (pair_rows_identical) and the kernel's device time at
    B = 4 beside the B = 1 calls' and its bound; the forced cases."""
    import torch

    from umeregrobust_tpu_torch.data.suite import REDUCED
    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.ops.cuda_grouped import (
        sparse_conv_grouped_kernel as kern)
    from umeregrobust_tpu_torch.pipeline.e2e import (
        pair_features_batched, pair_features_e2e)

    bf = torch.bfloat16
    caps = REDUCED["caps"]
    model = load_model(weights, ARCHS["ResUNetSmall2"], device=dev)
    with PyramidMaps() as pyr:
        layers = capture_grouped_layers(model, lambda: pair_features_e2e(
            model, caps, *pair_args(pairs[0]), device=dev))
    rows = []
    for name, f, w, gmap, _, _, _ in layers:
        rows.append(grouped_layer_row(name, f, w, gmap))
        emit({"phase": "grouped_layer", "model": "ResUNetSmall2", **rows[-1]})
    # the 18 launches' device time by kernel: the feature rounding (one
    # launch a call; folding it into the A load would save at most its
    # share) and the conv
    split = kernel_split_ms(lambda: [kern(f, w, gmap, None, bf) for
                                     _, f, w, gmap, _, _, _ in layers],
                            calls=5)
    del layers
    with PyramidMaps() as pyr4:
        batch = capture_grouped_layers(model, lambda: pair_features_batched(
            model, caps, *stacked_args(pairs), device=dev))
    order = {}
    for label, maps in (("one_pair", pyr.lists[0]),
                        (f"B{len(pairs)}", pyr4.lists[0])):
        order[label] = grouped_order_row(label, maps)
        emit({"phase": "grouped_row_order", "model": "ResUNetSmall2",
              **order[label]})
    order["forced"], order["forced_ok"] = row_order_forced_cases(dev)
    emit({"phase": "grouped_row_order_forced", "ok": order["forced_ok"],
          **order["forced"]})
    ones = [capture_grouped_layers(model, lambda p=p: pair_features_e2e(
        model, caps, *pair_args(p), device=dev)) for p in pairs]
    per_layer = []
    for j, (name, f4, w, g4, B, m4, _) in enumerate(batch):
        out4 = kern(f4, w, g4, None, bf)
        outs1 = [kern(o[j][1], w, o[j][3], None, bf) for o in ones]
        per_layer.append(dict(
            layer=name, B=B, bit_identical_to_b1=pair_rows_identical(
                out4, m4, outs1, [o[j][5] for o in ones]),
            kernel_ms_batched=graph_ms(lambda: kern(f4, w, g4, None, bf),
                                       reps=5, inner=10),
            parent_kernel_ms_batched=graph_ms(
                lambda: parent_grouped(f4, w, g4), reps=5, inner=10),
            kernel_ms_b1=sum(graph_ms(lambda o=o: kern(
                o[j][1], w, o[j][3], None, bf), reps=3, inner=10)
                for o in ones),
            bound_ms_batched=grouped_bound(f4, w, g4)[0]))
    del batch, ones, model
    forced, forced_ok = grouped_forced_cases(dev)
    emit({"phase": "grouped_forced", "ok": forced_ok, **forced})
    keys = ("ms", "kernel_ms", "parent_kernel_ms", "kernel_ms_fp32",
            "plain_ms", "bound_ms", "per_tap_kernel_ms")
    lib = [r["library_ms"] for r in rows]
    summary = dict(
        layers=len(rows), **{k: sum(r[k] for r in rows) for k in keys},
        library_ms=None if None in lib else sum(lib),
        library_kernel_ms=(None if None in lib else
                           sum(r["library_kernel_ms"] for r in rows)),
        bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_err_over_limit=max(r["max_abs_err"] / r["limit"] for r in rows),
        layers_slower_than_per_tap=[r["layer"] for r in rows if
                                    r["kernel_ms"] > r["per_tap_kernel_ms"]],
        layers_slower_than_parent=[r["layer"] for r in rows if
                                   r["kernel_ms"] > r["parent_kernel_ms"]],
        kernel_split_ms=split,
        B=len(pairs),
        bit_identical_to_b1=all(p["bit_identical_to_b1"] for p in per_layer),
        kernel_ms_batched=sum(p["kernel_ms_batched"] for p in per_layer),
        parent_kernel_ms_batched=sum(p["parent_kernel_ms_batched"]
                                     for p in per_layer),
        kernel_ms_b1_pairs=sum(p["kernel_ms_b1"] for p in per_layer),
        bound_ms_batched=sum(p["bound_ms_batched"] for p in per_layer),
        batched_layers=per_layer, forced_ok=forced_ok,
        ok=all(r["ok"] for r in rows) and forced_ok and len(rows) == 18
        and all(p["bit_identical_to_b1"] for p in per_layer))
    emit({"phase": "grouped_layers_summary", "model": "ResUNetSmall2",
          **summary})
    return dict(rows=rows, order=order, **summary)


_PARENT_ORDER = None


def parent_order_library():
    """csrc/bench/grouped_row_order_parent.cu (the row order before its
    one-launch redesign: three launches a map), built with the kernels'
    nvcc flags into the build directory and loaded; once a process."""
    global _PARENT_ORDER
    if _PARENT_ORDER is None:
        import ctypes

        from umeregrobust_tpu_torch.ops import _build

        src = _build.CSRC / "bench" / "grouped_row_order_parent.cu"
        lib = (_build.BUILD_DIR / "bench"
               / f"libgrouped_order_parent.{os.getpid()}.so")
        lib.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build._find_nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-shared", str(src), "-o",
                            str(lib), "-lcudart"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError("grouped_row_order_parent.cu did not build:"
                               f"\n{r.stdout}")
        cdll = ctypes.CDLL(str(lib))
        vp = ctypes.c_void_p
        cdll.umr_bench_grouped_row_order_parent.argtypes = (
            [vp] * 6 + [ctypes.c_longlong, vp])
        cdll.umr_bench_grouped_row_order_parent.restype = ctypes.c_int
        _PARENT_ORDER = cdll
    return _PARENT_ORDER


def parent_row_order(gmap):
    """The parent tree's row order of one map as its wrapper made it (four
    allocations, three launches); not counted in any launch count."""
    import torch

    from umeregrobust_tpu_torch.ops import _build

    lib = parent_order_library()
    n, dev = gmap.masks.shape[-1], gmap.masks.device
    order = torch.empty(n, dtype=torch.int32, device=dev)
    tiles = torch.empty(-(-n // 64), dtype=torch.int32, device=dev)
    keys = torch.empty(n, dtype=torch.int16, device=dev)
    hist = torch.empty(512 * -(-n // 1024), dtype=torch.int32, device=dev)
    code = lib.umr_bench_grouped_row_order_parent(
        gmap.masks.data_ptr(), gmap.patho.data_ptr(), keys.data_ptr(),
        hist.data_ptr(), order.data_ptr(), tiles.data_ptr(), n,
        _build.stream_of(dev))
    if code != 0:
        raise RuntimeError(f"umr_bench_grouped_row_order_parent: CUDA error "
                           f"{code}")
    return order, tiles


class PyramidMaps:
    """While active, the grouped maps each pyramid build hands to the row
    order (models.resunet.with_row_orders), bare and in its order, are
    kept in `lists`, one list a build; the build runs as it would."""

    def __enter__(self):
        from umeregrobust_tpu_torch.models import resunet

        self.mod, self.real, self.lists = resunet, resunet.with_row_orders, []

        def spy(maps):
            self.lists.append(list(maps))
            return self.real(self.lists[-1])

        resunet.with_row_orders = spy
        return self

    def __exit__(self, *exc):
        self.mod.with_row_orders = self.real


def grouped_order_row(label, maps):
    """The row-order kernel over a pyramid's grouped maps in ONE launch
    (grouped_row_orders): each map's order and tiles against
    grouped_row_orders_plain's (mismatches counted), two launches
    identical; the launches a call (LAUNCHES) beside the parent's (three a
    map); one call an event pair (ms), the device's time alone
    (kernel_ms), the parent tree's per-map calls the same two ways
    (csrc/bench/grouped_row_order_parent.cu), the host's time to issue a
    call (host_ms, the geometry stage's share) beside the parent's, the
    plain version's time, and the bound (each map's masks and patho
    bytes read once, order and tiles written once). The sort alone by
    PyTorch calls (a stable argsort of each map's precomputed keys) is
    argsort_ms; no single call computes the whole function."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_grouped

    def run():
        return cuda_grouped.grouped_row_orders(maps)

    def parent():
        return [parent_row_order(m) for m in maps]

    before = cuda_grouped.LAUNCHES["grouped_row_order"]
    first = run()
    launches = cuda_grouped.LAUNCHES["grouped_row_order"] - before
    second = run()
    plain = cuda_grouped.grouped_row_orders_plain(maps)
    old = parent()
    torch.cuda.synchronize()
    rows, bad, bad_parent, err, same = [], 0, 0, 0.0, True
    for m, (o1, t1), (o2, t2), (op, tp), (oo, to) in zip(
            maps, first, second, plain, old):
        mis = int((o1 != op).sum()) + int((t1 != tp).sum())
        bad += mis
        bad_parent += int((oo != op).sum()) + int((to != tp).sum())
        err = max(err, float((o1.long() - op.long()).abs().max()))
        same &= bool(torch.equal(o1, o2) and torch.equal(t1, t2))
        rows.append(m.masks.shape[-1])
    keys = [cuda_grouped.row_keys_plain(m) for m in maps]
    n = sum(rows)
    n_tiles = sum(-(-r // 64) for r in rows)
    res = dict(
        pyramid=label, maps=len(maps), rows=rows, mismatches=bad,
        parent_mismatches=bad_parent, max_abs_err=err,
        two_launches_identical=same, launches=launches,
        parent_launches=3 * len(maps),
        ms=time_ms(run, reps=10), kernel_ms=graph_ms(run, reps=5, inner=10),
        parent_ms=time_ms(parent, reps=10),
        parent_kernel_ms=graph_ms(parent, reps=5, inner=10),
        host_ms=host_ms(run, calls=50), parent_host_ms=host_ms(parent,
                                                               calls=50),
        plain_ms=time_ms(lambda: cuda_grouped.grouped_row_orders_plain(maps),
                         reps=3, warmup=1),
        argsort_ms=graph_ms(lambda: [torch.argsort(k, stable=True)
                                     for k in keys], reps=5, inner=10),
        bound_ms=bound_ms(n * (27 + 9) + 4 * n + 4 * n_tiles, 0)[0],
        cluster=cuda_grouped._ORDER_CLUSTER)
    res["ok"] = (bad == 0 and bad_parent == 0 and same and launches == 1)
    return res


def row_order_forced_cases(dev):
    """grouped_row_orders at forced maps, each alone and all in one
    launch, against the plain version: 1 row; 64 and 1024 rows and one
    past each (row counts that are no multiple of 4: the byte-load path);
    all masks zero; every one of the 512 keys present; masks at an odd
    address (the byte-load path); more rows than a CTA keeps keys for in
    shared memory (keys read again from the map); a map given twice in one
    list; the cap: _ORDER_MAX_MAPS maps in one launch, one more raises."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_grouped
    from umeregrobust_tpu_torch.ops.sparse import GroupedMap

    rng = np.random.default_rng(31)

    def make(n, p=0.3, masks=None, odd=False):
        if masks is None:
            masks = rng.random((9, 3, n)) < p
        pat = (rng.random((9, n)) < 0.05) & ~masks[:, 2]
        m = torch.as_tensor(masks, device=dev)
        if odd:  # a contiguous view one byte into its storage
            buf = torch.zeros(m.numel() + 1, dtype=torch.bool, device=dev)
            buf[1:] = m.reshape(-1)
            m = buf[1:].view(9, 3, n)
        return GroupedMap(center=torch.zeros((9, n), dtype=torch.int32,
                                             device=dev),
                          masks=m, patho=torch.as_tensor(pat, device=dev),
                          worder=torch.arange(3, device=dev))

    every_key = np.zeros((9, 3, 2048), bool)
    key = rng.permutation(np.arange(2048) % 512)
    for g in range(9):
        every_key[g, rng.integers(0, 3, 2048), np.arange(2048)] = (
            key >> g & 1).astype(bool)
    cap_rows = 65536 * cuda_grouped._ORDER_CLUSTER + 1000
    cases = {"rows_1": make(1), "rows_64": make(64), "rows_65": make(65),
             "rows_1024": make(1024), "rows_1025": make(1025, p=0.05),
             "masks_all_zero": make(3000, p=0.0),
             "all_512_keys": make(2048, masks=every_key),
             "masks_at_odd_address": make(4096, odd=True),
             "keys_past_shared_memory": make(cap_rows, p=0.1)}
    for name in ("masks_all_zero", "all_512_keys"):  # no patho bits
        cases[name] = cases[name]._replace(
            patho=torch.zeros_like(cases[name].patho))
    out, ok = {}, True

    def check(maps):
        got = cuda_grouped.grouped_row_orders(maps)
        want = cuda_grouped.grouped_row_orders_plain(maps)
        torch.cuda.synchronize()
        return sum(int((o != op).sum()) + int((t != tp).sum())
                   for (o, t), (op, tp) in zip(got, want))

    for name, m in cases.items():
        bad = check([m])
        out[name] = dict(rows=m.masks.shape[-1], mismatches=bad, ok=bad == 0)
        ok &= bad == 0
    listed = list(cases.values())
    listed += [cases["rows_1025"]] * (cuda_grouped._ORDER_MAX_MAPS
                                      - len(listed))  # given more than once
    bad = check(listed)
    out["one_launch_of_the_cap"] = dict(maps=len(listed), mismatches=bad,
                                        ok=bad == 0)
    try:
        cuda_grouped.grouped_row_orders(listed + [cases["rows_1"]])
        refused = False
    except ValueError:
        refused = True
    out["past_the_cap_raises"] = dict(maps=len(listed) + 1, ok=refused)
    ok &= bad == 0 and refused
    keys = cuda_grouped.row_keys_plain(cases["all_512_keys"])
    out["all_512_keys"]["distinct_keys"] = int(torch.unique(keys).numel())
    ok &= out["all_512_keys"]["distinct_keys"] == 512
    return out, ok


def pair_args(p):
    s, tg = p["src"], p["tgt"]
    return (s["coords"], s["grid"], s["mask"], tg["coords"], tg["grid"],
            tg["mask"], s["corr_pts"], s["corr_mask"], tg["corr_pts"],
            tg["corr_mask"])


def phase_family(dev, pair, cfg):
    """ResUNet at full width through register_pair_e2e on the nominal
    pair; card vs CPU on a small cloud; one ResUNet5 feature stage."""
    import copy

    import torch

    from umeregrobust_tpu_torch.data.suite import small_pair
    from umeregrobust_tpu_torch.models.resunet import (
        ARCHS, build_unet_geometry, default_level_capacities, init_resunet)
    from umeregrobust_tpu_torch.ops import cuda_conv
    from umeregrobust_tpu_torch.pipeline.e2e import (
        pair_features_e2e, register_pair_e2e)

    def fresh(name):
        return init_resunet(ARCHS[name], 1, 32, device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(0))

    def unit_norm(feat, mask):
        nrm = torch.linalg.vector_norm(feat, dim=1)
        m = torch.as_tensor(mask, device=dev)
        return bool(torch.isfinite(feat).all()) and float(
            (nrm[m] - 1).abs().max()) <= 1e-4 and float(nrm[~m].sum()) == 0.0

    def conv_trace(model, caps):
        """One feature stage with the conv wrappers' trace on: features
        and (kernel, layer shape) per launch."""
        cuda_conv.TRACE = []
        try:
            feats = pair_features_e2e(model, caps, *pair_args(pair),
                                      device=dev)
            torch.cuda.synchronize()
            return feats, [dict(kernel=k, rows_in=ni, rows_out=no, cin=ci,
                                cout=co, taps=kv, segments=sg)
                           for k, ni, no, ci, co, kv, sg in cuda_conv.TRACE]
        finally:
            cuda_conv.TRACE = None

    n0 = pair["src"]["coords"].shape[0]
    arch = ARCHS["ResUNet"]
    caps = default_level_capacities(n0, arch)
    model = fresh("ResUNet")
    geom = build_unet_geometry(*fused_pair(pair, dev), arch,
                               tuple(2 * c for c in caps))
    valid_rows = [int(lv.mask.sum()) for lv in geom["levels"]]
    del geom
    feats, trace = conv_trace(model, caps)  # also the warm-up
    res = dict(arch="ResUNet", caps=caps, valid_rows_per_level=valid_rows,
               level_full=[v >= 2 * c for v, c in zip(valid_rows, caps)],
               parameters=sum(p.numel() for p in model.parameters()),
               conv_layers=trace,
               unit_norm=unit_norm(feats[0], pair["src"]["mask"])
               and unit_norm(feats[2], pair["src"]["corr_mask"]))
    # the counted run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    Ti, Tr = register_pair_e2e(
        model, caps, cfg, *pair_args(pair), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    res.update(seconds=time.time() - t0, launches=launch_counts(),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               finite=bool(torch.isfinite(Ti).all()
                           and torch.isfinite(Tr).all()))
    # the same model on a small cloud: card vs CPU plain versions, fp32
    small = small_pair(42)
    caps_s = default_level_capacities(small["src"]["coords"].shape[0], arch)
    on_card = pair_features_e2e(model, caps_s, *pair_args(small),
                                compute_dtype=torch.float32, device=dev)
    cpu_model = copy.deepcopy(model).cpu()
    del model
    on_cpu = pair_features_e2e(cpu_model, caps_s, *pair_args(small),
                               compute_dtype=torch.float32, device="cpu")
    del cpu_model
    res["small_cloud_card_vs_cpu_max_abs"] = max(
        float((a.cpu() - b).abs().max()) for a, b in zip(on_card, on_cpu))
    res["small_cloud_limit"] = 1e-4
    res["small_cloud_unit_norm"] = unit_norm(on_card[0], small["src"]["mask"])
    # ResUNet5: grouped k=3 layers and per-tap k5 layers in one model
    arch5 = ARCHS["ResUNet5"]
    feats5, trace5 = conv_trace(fresh("ResUNet5"),
                                default_level_capacities(n0, arch5))
    res["resunet5"] = dict(
        unit_norm=unit_norm(feats5[0], pair["src"]["mask"]),
        per_tap_launches=len(trace5), conv_layers=trace5)
    lc = res["launches"]
    res["ok"] = bool(
        res["finite"] and res["unit_norm"] and res["small_cloud_unit_norm"]
        and res["small_cloud_card_vs_cpu_max_abs"] <= res["small_cloud_limit"]
        and res["resunet5"]["unit_norm"] and len(trace5) > 0
        and all(lc[k] > 0 for k in FORWARD_KERNELS))
    return res


def verdict(T, gt):
    """RRE (deg), RTE (m), NP and SP of one transform."""
    import torch

    from umeregrobust_tpu_torch.core.transforms import relative_rotation_error

    T = torch.as_tensor(T).double().cpu()
    gt = torch.as_tensor(gt, dtype=torch.float64)
    rre = float(relative_rotation_error(gt[:3, :3], T[:3, :3]))
    rte = float(torch.linalg.vector_norm(T[:3, 3] - gt[:3, 3]))
    return dict(rre_deg=rre, rte_m=rte, np_pass=rre <= 1.5 and rte <= 0.6,
                sp_pass=rre <= 1.0 and rte <= 0.1,
                finite=bool(torch.isfinite(T).all()))


MAIN_KERNELS = ("nn1_argmin", "nn1_copy_rows", "ume_moments_fused",
                "corr_scores_fused", "gather_rows", "sparse_conv_grouped",
                "grouped_row_order")


def phase_batched(dev, model, caps, cfg, batch, seeds, label):
    """`batch` (pairs) through register_pairs_batched as one batch, after a
    warm-up batch, alternated with the same pairs one at a time through
    register_pair_e2e (pair i seeded seeds[i] both ways) in the order
    sequential, batched, batched, sequential: per pair the two paths'
    verdicts and |T_batched - T_seq|; per path pairs/s (each pass), kernel
    launches per pair, peak device memory. Returns (summary, the first
    batched pass's launch counts)."""
    import torch

    from umeregrobust_tpu_torch.pipeline.e2e import (
        register_pair_e2e, register_pairs_batched)

    B = len(batch)
    bargs = stacked_args(batch)

    def gens():
        return [torch.Generator(device=dev).manual_seed(s) for s in seeds]

    def batched():
        return register_pairs_batched(model, caps, cfg, *bargs,
                                      generators=gens(), device=dev)

    per_pair = []  # the first sequential pass's launch counts, a pair

    def sequential():
        out = []
        for p, g in zip(batch, gens()):
            before = launch_counts()
            out.append(register_pair_e2e(model, caps, cfg, *pair_args(p),
                                         generator=g, device=dev))
            if len(per_pair) < B:
                per_pair.append({k: v - before[k]
                                 for k, v in launch_counts().items()})
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]))

    batched()  # warm-up
    passes = {"sequential": [], "batched": []}
    results, launches, peak = {}, {}, {}
    for kind in ("sequential", "batched", "batched", "sequential"):
        fn = batched if kind == "batched" else sequential
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        Ti, Tr = fn()
        torch.cuda.synchronize()
        passes[kind].append(time.time() - t0)
        if kind not in results:
            results[kind] = (Ti.cpu(), Tr.cpu())
            launches[kind] = launch_counts()
            peak[kind] = torch.cuda.max_memory_allocated()
    rows = []
    for i, p in enumerate(batch):
        vb = verdict(results["batched"][1][i], p["gt"])
        vs = verdict(results["sequential"][1][i], p["gt"])
        rows.append(dict(
            pair=i, regime=p.get("regime"), seed=p.get("seed"),
            batched=vb, sequential=vs,
            same_verdict=(vb["np_pass"], vb["sp_pass"])
            == (vs["np_pass"], vs["sp_pass"]),
            max_abs_dT_init=float((results["batched"][0][i]
                                   - results["sequential"][0][i]).abs().max()),
            max_abs_dT_refined=float((results["batched"][1][i]
                                      - results["sequential"][1][i]
                                      ).abs().max())))
        emit({"phase": "batched_pair", "batch": label, **rows[-1]})
    res = dict(
        batch=label, B=B, icp_budget=cfg.icp_budget,
        pairs_per_s_batched=[B / t for t in passes["batched"]],
        pairs_per_s_sequential=[B / t for t in passes["sequential"]],
        wall_s_batched=passes["batched"], wall_s_sequential=passes["sequential"],
        launches_per_pair_batched={k: v / B for k, v in
                                   launches["batched"].items()},
        launches_per_pair_sequential={k: v / B for k, v in
                                      launches["sequential"].items()},
        launches_batched=launches["batched"],
        max_memory_allocated_bytes_batched=peak["batched"],
        max_memory_allocated_bytes_sequential=peak["sequential"],
        np_recall_batched=float(np.mean([r["batched"]["np_pass"]
                                         for r in rows])),
        sp_recall_batched=float(np.mean([r["batched"]["sp_pass"]
                                         for r in rows])),
        max_abs_dT_init=max(r["max_abs_dT_init"] for r in rows),
        max_abs_dT_refined=max(r["max_abs_dT_refined"] for r in rows),
        same_verdicts=all(r["same_verdict"] for r in rows),
        finite=all(r["batched"]["finite"] for r in rows))
    # one launch a call site for the batch: each main-path kernel as often
    # as in the pair whose run launched it most (the arbiter's scores run
    # once when any pair's gate fires)
    res["launches_sequential_per_pair"] = per_pair
    res["one_launch_per_call_site"] = all(
        launches["batched"][k] == max(c[k] for c in per_pair) > 0
        for k in MAIN_KERNELS)
    res["ok"] = (res["same_verdicts"] and res["max_abs_dT_init"] <= 1e-4
                 and res["finite"] and res["one_launch_per_call_site"])
    return res, launches["batched"]


class BlockMatmulProbe:
    """While active, each dense product that a batched forward makes per
    pair-sized row block (ops.sparse.matmul_by_pair with pairs > 1) is
    also made as a per-block torch.mm loop and as one strided-batched
    torch.bmm over the same blocks (the weights broadcast), and the three
    are compared bit for bit, per shape. The forward keeps its own result."""

    def __enter__(self):
        import torch

        import umeregrobust_tpu_torch.models.resunet as resunet
        from umeregrobust_tpu_torch.ops import sparse

        self.mods, self.orig, self.seen = (sparse, resunet), \
            sparse.matmul_by_pair, {}

        def probe(x, w, pairs=1):
            out = self.orig(x, w, pairs)
            if pairs > 1:
                n = x.shape[0] // pairs
                loop = torch.cat([torch.mm(xb, w) for xb in x.split(n)])
                bmm = torch.bmm(x.reshape(pairs, n, x.shape[1]),
                                w.expand(pairs, *w.shape)).reshape(out.shape)
                r = self.seen.setdefault(
                    f"{pairs} x {n} x {x.shape[1]} -> {w.shape[1]}, "
                    f"{str(x.dtype)[6:]}", dict(calls=0, bmm_equal=0,
                                                path_equal_loop=0,
                                                max_abs_diff=0.0))
                r["calls"] += 1
                r["bmm_equal"] += bool(torch.equal(bmm, loop))
                r["path_equal_loop"] += bool(torch.equal(out, loop))
                r["max_abs_diff"] = max(r["max_abs_diff"],
                                        float((bmm - loop).abs().max()))
            return out

        for m in self.mods:
            m.matmul_by_pair = probe
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.matmul_by_pair = self.orig

    def summary(self):
        v = self.seen.values()
        return dict(shapes=self.seen, calls=sum(r["calls"] for r in v),
                    bmm_equal_all=all(r["bmm_equal"] == r["calls"] for r in v),
                    path_equal_loop_all=all(r["path_equal_loop"] == r["calls"]
                                            for r in v))


def batched_conv_row(name, f, w, nbr, pairs, b1):
    """One conv launch of a batched forward (bf16 operands): the kernel
    that sparse_conv routes it to (choose_kernel on a pair's rows) against
    sparse_conv_plain (max abs error <= 1e-4 x max |out|, two launches
    bit-identical), its device time (CUDA graph) beside the same layer's
    launches of the pairs' own calls (`b1`: (f, w, nbr) a pair), and the
    bound."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_conv

    bf = torch.bfloat16
    K, Cin, Cout = w.shape
    kind = cuda_conv.choose_kernel(nbr.shape[1] // pairs, Cout, K)[0]
    fn = getattr(cuda_conv, "sparse_conv_" + kind)
    ref = cuda_conv.sparse_conv_plain(f, w, nbr, bf)
    scale = float(ref.abs().max())
    o1, o2 = fn(f, w, nbr, bf), fn(f, w, nbr, bf)
    torch.cuda.synchronize()
    err = float((o1 - ref).abs().max())
    bb, by, _, valid, _ = conv_bound(f, w, nbr)
    kinds_b1 = [cuda_conv.choose_kernel(n_.shape[1], Cout, K)[0]
                for _, _, n_ in b1]
    return dict(
        layer=name, kernel=kind, pairs=pairs, K=K, cin=Cin, cout=Cout,
        rows_in=f.shape[0], rows_out=nbr.shape[1], valid=valid,
        max_abs_err=err, scale=scale,
        ok=err <= 1e-4 * scale and scale > 0 and torch.equal(o1, o2)
        and all(k == kind for k in kinds_b1),
        kernel_b1=kinds_b1,
        kernel_ms=graph_ms(lambda: fn(f, w, nbr, bf), reps=5, inner=10),
        kernel_ms_b1=[graph_ms(lambda f_=f_, w_=w_, n_=n_: fn(f_, w_, n_, bf),
                               reps=5, inner=10) for f_, w_, n_ in b1],
        plain_ms=time_ms(lambda: cuda_conv.sparse_conv_plain(f, w, nbr, bf),
                         reps=3, warmup=1),
        bound_ms=bb, bound_by=by)


def phase_resunet_batched(dev, pairs):
    """ResUNet (seeded random parameters, full published widths) on the
    pairs as one batch through pair_features_batched against each pair's
    pair_features_e2e: features within 1e-4 (the card-vs-CPU bound of
    phase 5b); valid rows per level and pair against the capacities (level
    1 fills: the batch must keep each pair's own rows). The batched run is
    counted on its own (launch counts set to 0 just before it) and its
    per-tap conv launches are held against the plain version and timed
    beside the pairs' own launches of the same layers (batched_conv_row);
    one more batched run goes through BlockMatmulProbe."""
    import torch

    from umeregrobust_tpu_torch.models.resunet import (
        ARCHS, build_unet_geometry, default_level_capacities, init_resunet)
    from umeregrobust_tpu_torch.pipeline.e2e import (
        pair_features_batched, pair_features_e2e)

    arch = ARCHS["ResUNet"]
    caps = default_level_capacities(pairs[0]["src"]["coords"].shape[0], arch)
    model = init_resunet(arch, 1, 32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    bargs = stacked_args(pairs)
    fb = []
    reset_launch_counts()
    layers = capture_conv_layers(model, lambda: fb.extend(
        pair_features_batched(model, caps, *bargs, device=dev)))
    launches = launch_counts()
    diffs, layers_b1 = [], []
    for i, p in enumerate(pairs):
        fs = []
        layers_b1.append(capture_conv_layers(model, lambda p=p: fs.extend(
            pair_features_e2e(model, caps, *pair_args(p), device=dev))))
        diffs.append(max(float((a[i] - b).abs().max())
                         for a, b in zip(fb, fs)))
    conv_rows = []
    for j, (name, f, w, nbr, B_) in enumerate(layers):
        conv_rows.append(batched_conv_row(
            name, f, w, nbr, B_, [lb[j][1:4] for lb in layers_b1]))
        conv_rows[-1]["ok"] &= all(lb[j][0] == name for lb in layers_b1)
        emit({"phase": "batched_conv_layer", "model": "ResUNet",
              **conv_rows[-1]})
    del layers, layers_b1
    with BlockMatmulProbe() as bmp:
        pair_features_batched(model, caps, *bargs, device=dev)
    # the batch's pyramid: rows of each pair at each level
    B, N = bargs[0].shape[:2]
    coords = torch.as_tensor(np.stack([bargs[0], bargs[3]], 1)).to(dev)
    mask = torch.as_tensor(np.stack([bargs[2], bargs[5]], 1)).to(dev)
    coords[..., 0] += (torch.arange(2 * B, device=dev, dtype=torch.int32)
                       .reshape(B, 2, 1) * mask)
    geom = build_unet_geometry(coords.reshape(-1, 4), mask.reshape(-1), arch,
                               tuple(2 * c for c in caps), pairs=B)
    rows = [[int((lv.mask & (lv.coords[:, 0] // 2 == b)).sum())
             for lv in geom["levels"]] for b in range(B)]
    del model, geom
    by_kernel = {k: dict(
        launches=sum(r["kernel"] == k for r in conv_rows),
        **{key: sum(r[key] for r in conv_rows if r["kernel"] == k)
           for key in ("kernel_ms", "plain_ms", "bound_ms")},
        kernel_ms_b1=sum(sum(r["kernel_ms_b1"]) for r in conv_rows
                         if r["kernel"] == k),
        max_abs_err=max([r["max_abs_err"] for r in conv_rows
                         if r["kernel"] == k], default=0.0))
        for k in ("rowtile", "tapsplit")}
    return dict(arch="ResUNet", caps=caps, B=B,
                max_abs_feature_diff=diffs, limit=1e-4,
                valid_rows_per_level=rows,
                level_full=[[v >= 2 * c for v, c in zip(r, caps)]
                            for r in rows],
                launches=launches, conv_launches=len(conv_rows),
                conv_by_kernel=by_kernel,
                conv_ok=all(r["ok"] for r in conv_rows),
                block_matmul=bmp.summary(),
                ok=all(d <= 1e-4 for d in diffs)
                and all(r["ok"] for r in conv_rows) and len(conv_rows) > 0)


def phase_hungarian(dev, model, caps, cfg, pair):
    """The nominal pair through register_pair_hungarian on the card:
    features from pair_features_e2e, the host assignment's seconds and the
    whole pair's, RRE / RTE and the verdict; held to a finite rigid T."""
    import torch

    from umeregrobust_tpu_torch.pipeline import registration
    from umeregrobust_tpu_torch.pipeline.e2e import pair_features_e2e

    s, tg = pair["src"], pair["tgt"]
    assign, seconds = registration.hungarian_match, []

    def timed(D):  # the host assignment, timed where the path calls it
        t = time.perf_counter()
        out = assign(D)
        seconds.append(time.perf_counter() - t)
        return out

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    registration.hungarian_match = timed
    try:
        f = pair_features_e2e(model, caps, *pair_args(pair), device=dev)
        res = registration.register_pair_hungarian(
            cfg, s["grid"], f[0], s["mask"], tg["grid"], f[1], tg["mask"],
            s["corr_pts"], f[2], s["corr_mask"], tg["corr_pts"], f[3],
            tg["corr_mask"],
            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
    finally:
        registration.hungarian_match = assign
    dt = time.time() - t0
    T = res.T_refined.double().cpu()
    R = T[:3, :3]
    rigid = bool(torch.allclose(R @ R.T, torch.eye(3, dtype=torch.float64),
                                atol=1e-4)
                 and abs(float(torch.linalg.det(R)) - 1.0) <= 1e-4)
    out = dict(seconds=dt, assignment_s=seconds[0],
               keypoints=cfg.num_init_keypoints, launches=launch_counts(),
               **verdict(T, pair["gt"]), rigid=rigid)
    out["ok"] = out["finite"] and rigid
    return out


def rigid(T):
    """T (4, 4) a proper rigid transform to 1e-4 (float64)."""
    import torch

    T = torch.as_tensor(T).double().cpu()
    R = T[:3, :3]
    return bool(torch.allclose(R @ R.T, torch.eye(3, dtype=torch.float64),
                               atol=1e-4)
                and abs(float(torch.linalg.det(R)) - 1.0) <= 1e-4
                and torch.allclose(T[3], torch.tensor(
                    [0.0, 0.0, 0.0, 1.0], dtype=torch.float64)))


class TimeIn:
    """While active, the seconds spent inside each named module function
    (the device synchronised before and after every call), by name: e.g.
    the kNN scorer's share of a pair. A measurement aid."""

    def __init__(self, **targets):  # name -> (module, function name)
        self.targets, self.seconds = targets, {k: 0.0 for k in targets}

    def __enter__(self):
        import torch

        self.saved = {}
        for name, (mod, fn) in self.targets.items():
            orig = self.saved[name] = getattr(mod, fn)

            def timed(*a, _orig=orig, _name=name, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*a, **k)
                torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                return out

            setattr(mod, fn, timed)
        return self

    def __exit__(self, *exc):
        for name, (mod, fn) in self.targets.items():
            setattr(mod, fn, self.saved[name])


def scorer_timer():
    from umeregrobust_tpu_torch.pipeline import correlator

    return TimeIn(knn_scores=(correlator, "correlator_scores"),
                  radius_scores=(correlator,
                                 "correlator_scores_radius_fused"),
                  spatial_var=(correlator, "feature_spatial_var"))


def count_kernels(fn):
    """(CUDA kernels launched, their device ms) of one fn() call, by
    torch.profiler. A session that reports no device event is made again,
    up to three in all (sessions right after CUDA graph replays have
    reported none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ks:
            break
    return len(ks), sum(k.time_range.elapsed_us() for k in ks) / 1e3


# phase 5f: each RegistrationConfig path (on the reduced point) and the
# kernels it must launch
CONFIG_PATHS = {
    "knn": (dict(corr_mode="knn"),
            ("nn1_argmin", "ume_moments_fused", "gather_rows",
             "sparse_conv_grouped")),
    "grid_copy": (dict(feat_copy_radius=0.6),
                  ("ume_moments_fused", "corr_scores_fused", "gather_rows",
                   "sparse_conv_grouped")),
    "icp_inner1": (dict(icp_inner=1), MAIN_KERNELS),
    "no_ume_filter": (dict(filter_by_ume_dist=False), MAIN_KERNELS),
    "second_round": (dict(sr_kpts=1024, sr_gate_inliers=2.0), MAIN_KERNELS),
    "parity": (None, ("nn1_argmin", "ume_moments_fused", "gather_rows",
                      "sparse_conv_grouped")),
}


def phase_config_paths(dev, model, caps, cfg, pairs):
    """Each knob of CONFIG_PATHS on the four regime pairs: each pair alone
    through register_pair_e2e (after a warm-up pair; seeded i), then the
    four as one batch through register_pairs_batched (the same seeds):
    per pair RRE / RTE, verdict, seconds and kernel launches, per knob the
    batch's seconds and launches; fails a knob on a non-finite or
    non-rigid transform, a batched verdict that differs from the one-pair
    one or |dT_init| > 1e-4, or a kernel of its path that never
    launched. Returns ({knob: summary}, {knob: launch counts of both
    runs})."""
    from dataclasses import replace

    import torch

    from umeregrobust_tpu_torch.cli.evaluate import PARITY_PROFILE
    from umeregrobust_tpu_torch.pipeline.e2e import (
        register_pair_e2e, register_pairs_batched)

    out, launches = {}, {}
    for knob, (kw, expect) in CONFIG_PATHS.items():
        cfg_k = replace(cfg, **(PARITY_PROFILE if kw is None else kw))

        def one(p, i):
            return register_pair_e2e(
                model, caps, cfg_k, *pair_args(p), device=dev,
                generator=torch.Generator(device=dev).manual_seed(i))

        one(pairs[0], 0)  # warm-up
        kernels0, busy0 = count_kernels(lambda: one(pairs[0], 0))
        reset_launch_counts()
        rows, Ti1 = [], []
        for i, p in enumerate(pairs):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            with scorer_timer() as tm:
                Ti, Tr = one(p, i)
            torch.cuda.synchronize()
            Ti1.append(Ti.cpu())
            rows.append(dict(pair=i, regime=p.get("regime"),
                             seconds=time.time() - t0,
                             seconds_in=tm.seconds,
                             launches={k: v - before[k] for k, v in
                                       launch_counts().items()},
                             rigid=rigid(Tr), **verdict(Tr, p["gt"])))
        lc_one = launch_counts()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        Tib, Trb = register_pairs_batched(
            model, caps, cfg_k, *stacked_args(pairs), device=dev,
            generators=[torch.Generator(device=dev).manual_seed(i)
                        for i in range(len(pairs))])
        torch.cuda.synchronize()
        wall_b = time.time() - t0
        lc_b = launch_counts()
        for i, (r, p) in enumerate(zip(rows, pairs)):
            vb = verdict(Trb[i], p["gt"])
            r.update(batched=dict(vb, rigid=rigid(Trb[i])),
                     same_verdict=(vb["np_pass"], vb["sp_pass"])
                     == (r["np_pass"], r["sp_pass"]),
                     max_abs_dT_init=float((Tib[i].cpu() - Ti1[i]).abs().max()))
            emit({"phase": "config_path_pair", "knob": knob, **r})
        missing = [k for k in expect if lc_one[k] <= 0 or lc_b[k] <= 0]
        res = dict(
            knob=knob, overrides=PARITY_PROFILE if kw is None else kw,
            pairs=len(pairs),
            seconds_one_at_a_time=[r["seconds"] for r in rows],
            seconds_batched=wall_b, cuda_kernels_pair0=kernels0,
            device_busy_ms_pair0=busy0, launches_one_at_a_time=lc_one,
            launches_batched=lc_b, expected_kernels=list(expect),
            missing_kernels=missing,
            np_recall=float(np.mean([r["np_pass"] for r in rows])),
            sp_recall=float(np.mean([r["sp_pass"] for r in rows])),
            max_abs_dT_init=max(r["max_abs_dT_init"] for r in rows))
        res["ok"] = (not missing
                     and all(r["finite"] and r["rigid"]
                             and r["batched"]["finite"]
                             and r["batched"]["rigid"] and r["same_verdict"]
                             for r in rows)
                     and res["max_abs_dT_init"] <= 1e-4)
        out[knob] = res
        launches[knob] = {k: lc_one[k] + lc_b[k] for k in lc_one}
    return out, launches


CLI_WEIGHTS = os.path.join(ROOT, "weights", "synthetic_pretrain.pkl")
CLI_PARITY_PAIRS = 2


def phase_cli(label, argv, expect):
    """umeregrobust_tpu_torch.cli.evaluate.main(argv) in this process (its
    own prints go to stderr): NP / SP, pairs/s (pair 0 excluded, as the
    CLI counts), per pair the host prep's and the pipeline's seconds,
    peak device memory, the escalations and the kernels launched; fails
    on a non-finite transform or an `expect`ed kernel that never
    launched (an exception ends the run)."""
    import contextlib

    from umeregrobust_tpu_torch.cli import evaluate

    reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr), scorer_timer() as tm:
        r = evaluate.main(argv)
    lc = launch_counts()
    res = dict(
        run=label, argv=argv, seconds=time.time() - t0,
        seconds_in=tm.seconds,
        n_pairs=r["n_pairs"], np_recall=r["np_recall"],
        sp_recall=r["sp_recall"], mean_rre_deg=r["mean_rre"],
        mean_rte_m=r["mean_rte"], pairs_per_s=r["pairs_per_sec"],
        per_pair=r["per_pair"],
        max_memory_allocated_bytes=r.get("max_memory_allocated_bytes"),
        escalations=r["icp_exactness"]["escalations"],
        icp_budget=r["registration_config"].icp_budget,
        icp_raw_budget=r["registration_config"].icp_raw_budget,
        launches=lc, expected_kernels=list(expect),
        missing_kernels=[k for k in expect if lc[k] <= 0])
    res["ok"] = (not res["missing_kernels"]
                 and all(p["finite"] for p in r["per_pair"]))
    return res


# phase 5h: the evaluate CLI's dataset mode on KITTI- and nuScenes-layout
# trees at HDL-64 density (64 beams x 1800 azimuth bins over HDL-64E's
# +2 .. -24.8 deg field of view, dense enough scene surfaces that most
# beams return), the SEM preprocessing CLI, a MinkowskiEngine .pth of the
# in-repo weights, and RT-UME on a dataset pair's features
DATASET_PAIRS = 3
HDL64 = dict(observe_mode="lidar", ground_points=2_000_000,
             structure_points=1_500_000, elevation_range=(-24.8, 2.0))
EGO_POINTS = 400  # returns off the ego vehicle, which the nuScenes reader drops


def write_dataset_tree(root, dataset, n_pairs):
    """Scans of the first n_pairs of {dataset}/test in the reader's layout
    (KITTI: sequences/{seq:02d}/velodyne/*.bin, labels/*.label; nuScenes:
    test/sequences/{log}/velodyne/*.bin, no labels, as the exporter writes
    the test split): each pair one make_pair scene, its target scan moved
    by the registry's ground truth. Returns the points a scan."""
    from umeregrobust_tpu_torch.data.registry import load_registry
    from umeregrobust_tpu_torch.data.synthetic import SceneConfig, make_pair

    reg = load_registry(dataset, "test", skip_invalid_entries=False)
    rng = np.random.default_rng(7)
    sizes = []
    for i in range(n_pairs):
        seq, f0, f1 = reg.pairs[i]
        gt = reg.gt_tforms[i]
        kw = dict(HDL64) if dataset == "kitti" else dict(HDL64,
                                                         elevation_bins=32)
        pair = make_pair(SceneConfig(seed=500 + i, **kw), seed=500 + i)
        R, t = pair["gt_tform"][:3, :3], pair["gt_tform"][:3, 3]
        tgt = ((pair["tgt_pts"] - t) @ R) @ gt[:3, :3].T + gt[:3, 3]
        if dataset == "kitti":
            d = os.path.join(root, "sequences", f"{int(seq):02d}")
        else:
            d = os.path.join(root, "test", "sequences", str(seq))
        os.makedirs(os.path.join(d, "velodyne"), exist_ok=True)
        for fid, pts, seg in [(int(f0), pair["src_pts"], pair["src_seg"]),
                              (int(f1), tgt, pair["tgt_seg"])]:
            pts = np.asarray(pts, np.float32)
            if dataset != "kitti":
                ego = rng.uniform([-2.4, -0.9, -1.5], [2.4, 0.9, 0.2],
                                  (EGO_POINTS, 3)).astype(np.float32)
                pts = np.concatenate([pts, ego])
            np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1
                           ).tofile(os.path.join(d, "velodyne",
                                                 f"{fid:06d}.bin"))
            sizes.append(len(pts))
            if dataset == "kitti":
                os.makedirs(os.path.join(d, "labels"), exist_ok=True)
                # raw ids: 9 -> 40 (road), other labels -> 10 (car)
                np.where(seg == 9, 40, np.where(seg == 0, 0, 10)).astype(
                    np.uint32).tofile(os.path.join(d, "labels",
                                                   f"{fid:06d}.label"))
    return sizes


def dataset_eval(label, argv, n_pairs):
    """The evaluate CLI's dataset mode (parse_args, _datasets,
    _dataset_pair_iter, evaluate_pairs) over the split's first n_pairs
    (its own prints go to stderr): NP / SP, pairs/s, per pair host prep and
    pipeline seconds and the transform, peak device memory and the
    kernels launched in all and a pair."""
    import contextlib

    from umeregrobust_tpu_torch.cli import evaluate as ev

    args = ev.parse_args(argv)
    reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        r = ev.evaluate_pairs(args, *ev._dataset_pair_iter(
            *ev._datasets(args, dataset_size=n_pairs)))
    lc = launch_counts()
    res = dict(
        run=label, argv=argv, seconds=time.time() - t0, n_pairs=r["n_pairs"],
        np_recall=r["np_recall"], sp_recall=r["sp_recall"],
        mean_rre_deg=r["mean_rre"], mean_rte_m=r["mean_rte"],
        pairs_per_s=r["pairs_per_sec"], per_pair=r["per_pair"],
        max_memory_allocated_bytes=r.get("max_memory_allocated_bytes"),
        escalations=r["icp_exactness"]["escalations"], launches=lc,
        launches_per_pair={k: v / max(r["n_pairs"], 1)
                           for k, v in lc.items()},
        missing_kernels=[k for k in MAIN_KERNELS if lc[k] <= 0])
    res["ok"] = (r["n_pairs"] == n_pairs and not res["missing_kernels"]
                 and all(p["finite"] for p in r["per_pair"]))
    return res


def horn_gaps(G, H):
    """Per estimate, the gap between the two largest eigenvalues of Horn's
    4x4 matrix of the cross-covariance that estimate_rigid_from_ume forms
    from (G, H) (float64), over the largest |eigenvalue|: the closed-form
    rotation moves by about (input change) / gap, so a small gap marks an
    ill-conditioned estimate that two fp32 solvers may resolve apart."""
    G = np.asarray(G, np.float64)
    H = np.asarray(H, np.float64)
    mg, mh, g, h = G[..., 0:1], H[..., 0:1], G[..., 1:], H[..., 1:]
    mg_sq = (mg * mg).sum(-2, keepdims=True) + 1e-16
    wlc = (g * mg).sum(-2, keepdims=True) / (mg_sq + 1e-16)
    wrc = (h * mg).sum(-2, keepdims=True) / (
        (mg * mh).sum(-2, keepdims=True) + 1e-16)
    S = np.swapaxes(g - wlc * mg, -1, -2) @ (h - wrc * mh)
    xx, xy, xz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    yx, yy, yz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    zx, zy, zz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = np.stack([
        np.stack([xx + yy + zz, yz - zy, zx - xz, xy - yx], -1),
        np.stack([yz - zy, xx - yy - zz, xy + yx, zx + xz], -1),
        np.stack([zx - xz, xy + yx, -xx + yy - zz, yz + zy], -1),
        np.stack([xy - yx, zx + xz, yz + zy, -xx - yy + zz], -1)], -2)
    w = np.linalg.eigvalsh(N)
    return (w[..., 3] - w[..., 2]) / np.maximum(np.abs(w).max(-1), 1e-30)


def ume_f64(kp, pts, feats, mask, radius, cap):
    """The normalised UME matrices of ume_from_ball_query in float64: the
    same balls (the plain version's fp32 distance test and cap) with the
    rows summed in float64, to say how far each fp32 version is from
    exact sums."""
    import torch

    from umeregrobust_tpu_torch.ops.neighbors import sqdist3

    pts = pts.cpu().to(torch.float32)
    f = feats.cpu().double() * mask.cpu()[:, None]
    p64 = pts.double()
    Z = torch.cat([f, f * p64[:, 0:1], f * p64[:, 1:2], f * p64[:, 2:3]], 1)
    r2 = torch.tensor(float(radius), dtype=torch.float32) ** 2
    out = []
    for s in range(0, kp.shape[0], 128):
        ok = (sqdist3(kp[s:s + 128].cpu().to(torch.float32), pts) <= r2
              ) & mask.cpu()[None, :]
        w = ok & (torch.cumsum(ok.to(torch.int32), -1) <= cap)
        out.append(w.double() @ Z)
    C = feats.shape[1]
    F = torch.cat(out).reshape(-1, 4, C).transpose(-1, -2)
    return F / (F[..., 0].sum(-1)[:, None, None] + 1e-6)


RTUME_N_RAND = 4096
RTUME_GAP_MIN = 1e-3  # estimates with a smaller relative gap: reported only


def phase_rtume(dev, args, dset, raw):
    """RT-UME on pair 0 of the cached dataset: ResUNetSmall2 features
    (the in-repo weights) of the padded SEM clouds, num_samples keypoints
    from sample_smart_keypoints, the target's the same keypoints moved by
    the ground truth; rtume_estimate at r = rtume_r_nn, cap rtume_nn_max
    in its diagonal, n_rand and full-grid modes on the card (ms of a call
    after a warm-up, ume_moments_fused launches a call) and on the CPU
    (plain versions) with the same inputs and triplets: G,
    |G|, H and D within 1e-4 x max |value| (the tier-1 tolerance of
    tests/test_torch_rtume.py), with both G's distance from float64 sums
    of the same balls (ume_f64); T within 1e-4 x max |T| for every
    estimate whose Horn gap is at least RTUME_GAP_MIN, the rest counted
    with their largest error. Also the diagonal estimates' median RRE /
    RTE against the truth."""
    import torch

    from umeregrobust_tpu_torch.cli import evaluate as ev
    from umeregrobust_tpu_torch.core.transforms import relative_rotation_error
    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.ops.voxel import quantize_np
    from umeregrobust_tpu_torch.pipeline.e2e import pair_features_e2e
    from umeregrobust_tpu_torch.pipeline.keypoint_samplers import (
        sample_smart_keypoints)
    from umeregrobust_tpu_torch.pipeline.rtume import rtume_estimate

    item = next(ev._dataset_pair_iter(dset, raw)[0])
    cap, corr_cap = int(args.max_pc_size), int(args.pc_corr_max_size)
    caps = tuple(int(-(-int(cap * r) // 128) * 128)
                 for r in (1.0, 0.75, 0.4, 0.2, 0.08))
    rng = np.random.default_rng(0)
    sp, ss, sc, sm = ev._pad_cloud(*item["sem_src"], cap, rng)
    tp, _, tc, tm = ev._pad_cloud(*item["sem_tgt"], cap, rng)
    corr = []
    for pts in (item["raw_src"], item["raw_tgt"]):
        _, sel = quantize_np(pts, 0.3)
        p = pts[sel][rng.permutation(len(sel))[:corr_cap]]
        buf = np.zeros((corr_cap, 3), np.float32)
        buf[:len(p)] = p
        corr += [buf, np.arange(corr_cap) < len(p)]
    model = load_model(CLI_WEIGHTS, ARCHS["ResUNetSmall2"], device=dev)
    with torch.no_grad():
        sf, tf, _, _ = pair_features_e2e(model, caps, sc, sp, sm, tc, tp, tm,
                                         *corr, device=dev)
    n_kp = int(args.num_samples)
    kp, km = sample_smart_keypoints(sp, ss, sm, num_samples=n_kp, device=dev)
    gt = torch.as_tensor(item["gt_tform"], device=dev)
    tkp = (kp @ gt[:3, :3].T + gt[:3, 3]) * km[:, None]
    up = {k: torch.as_tensor(v, device=dev)
          for k, v in dict(sp=sp, tp=tp, sm=sm, tm=tm).items()}
    inputs = dict(src_pts=up["sp"], src_feat=sf, src_kp=kp, tgt_pts=up["tp"],
                  tgt_feat=tf, tgt_kp=tkp, src_mask=up["sm"],
                  tgt_mask=up["tm"],
                  ume_knn=int(args.rtume_nn_max),
                  ume_desc_rad=float(args.rtume_r_nn))
    cpu_inputs = {k: (v.cpu() if torch.is_tensor(v) else v)
                  for k, v in inputs.items()}
    modes = {"diag": dict(), "n_rand": dict(n_rand=RTUME_N_RAND),
             "grid": dict(diag_only=False)}
    G64 = ume_f64(kp, up["sp"], sf, up["sm"], inputs["ume_desc_rad"],
                  inputs["ume_knn"])
    out, launches = {"keypoints": int(km.sum()), "n_kp": n_kp}, 0
    for mode, kw in modes.items():
        def card(kw=kw):
            g = torch.Generator(device=dev).manual_seed(3)
            return rtume_estimate(**inputs, **kw, generator=g, device=dev)

        card()  # warm-up
        torch.cuda.synchronize()
        before = launch_counts()["ume_moments_fused"]
        t0 = time.perf_counter()
        T, D, G, H = card()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_launch = launch_counts()["ume_moments_fused"] - before
        launches += n_launch
        ckw = dict(kw)
        if "n_rand" in kw:  # the card generator's draws, replayed
            ckw["draws"] = torch.randint(
                0, n_kp, (RTUME_N_RAND, 3), device=dev,
                generator=torch.Generator(device=dev).manual_seed(3)).cpu()
        t0 = time.perf_counter()
        Tc, Dc, Gc, Hc = rtume_estimate(**cpu_inputs, **ckw, device="cpu")
        cpu_s = time.perf_counter() - t0
        if mode == "diag":
            gaps = horn_gaps(Gc.numpy(), Hc.numpy())
        elif mode == "n_rand":
            tr = ckw["draws"].numpy()
            gaps = horn_gaps(Gc.numpy()[tr].sum(1), Hc.numpy()[tr].sum(1))
        else:
            gaps = horn_gaps(Gc.numpy()[:, None], Hc.numpy()[None, :])
        err = (T.cpu() - Tc).abs().amax((-2, -1)).numpy()
        tol_T = 1e-4 * float(Tc.abs().max())
        well = gaps >= RTUME_GAP_MIN
        errs = {n_: float((a.cpu() - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
            for n_, a, b in (("G", G, Gc), ("H", H, Hc), ("D", D, Dc))}
        g_scale = float(G64.abs().max())
        row = dict(
            mode=mode, estimates=int(err.size), ms=ms, cpu_s=cpu_s,
            rel_err_G_card_vs_f64=float((G.cpu().double() - G64).abs().max())
            / g_scale,
            rel_err_G_cpu_vs_f64=float((Gc.double() - G64).abs().max())
            / g_scale,
            ume_moments_fused_launches=n_launch,
            max_abs_err_T=float(err.max()), tol_T=tol_T,
            max_abs_err_T_well=float(err[well].max()) if well.any() else 0.0,
            ill_conditioned=int((~well).sum()),
            max_abs_err_T_ill=float(err[~well].max()) if (~well).any()
            else 0.0,
            over_1e4_abs=int((err > 1e-4).sum()),
            rel_err_G=errs["G"], rel_err_H=errs["H"], rel_err_D=errs["D"],
            finite=bool(torch.isfinite(T).all()))
        if mode == "diag":
            ok = km.cpu().numpy()
            Tn = T.cpu().double()[ok]
            gt64 = torch.as_tensor(item["gt_tform"], dtype=torch.float64)
            rre = relative_rotation_error(
                gt64[:3, :3].expand(len(Tn), 3, 3), Tn[:, :3, :3])
            row.update(median_rre_deg=float(rre.median()),
                       median_rte_m=float(torch.linalg.vector_norm(
                           Tn[:, :3, 3] - gt64[:3, 3], dim=-1).median()))
        row["ok"] = (row["finite"] and n_launch == 2
                     and row["max_abs_err_T_well"] <= tol_T
                     and max(errs.values()) <= 1e-4)
        out[mode] = row
        emit({"phase": "rtume", **row})
    out["ok"] = all(out[m]["ok"] for m in modes)
    out["launches"] = launches
    return out


def phase_datasets(dev, t_start):
    """Phase 5h (a)-(e) in a temporary directory; returns (summary, launch
    counts by path)."""
    import tempfile

    import torch

    from umeregrobust_tpu_torch.cli import evaluate as ev
    from umeregrobust_tpu_torch.cli import sem_preprocessing
    from umeregrobust_tpu_torch.models.convert import to_me_state_dict
    from umeregrobust_tpu_torch.models.weights import load_checkpoint

    out, paths = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as work:
        kitti, nusc = os.path.join(work, "kitti"), os.path.join(work, "nusc")
        cache = os.path.join(work, "kitti_sem_cache")
        # (a) the trees
        t0 = time.time()
        sizes = write_dataset_tree(kitti, "kitti", DATASET_PAIRS)
        nu_sizes = write_dataset_tree(nusc, "nuscenes", 1)
        out["trees"] = dict(seconds=time.time() - t0, kitti_scan_points=sizes,
                            nuscenes_scan_points=nu_sizes)
        emit({"phase": "dataset_trees", **out["trees"]})
        # (b) SEM preprocessing (125,000 SEM points a scan), then again
        sem_argv = ["--dataset_mode", "kitti", "--split", "test",
                    "--data_path", os.path.join(kitti, "sequences"),
                    "--output_path", cache, "--range_idxs", "0",
                    str(DATASET_PAIRS)]
        t0 = time.time()
        written = sem_preprocessing.main(sem_argv)
        sem_s = time.time() - t0
        t0 = time.time()
        again = sem_preprocessing.main(sem_argv)
        out["sem"] = dict(written=written, written_again=again,
                          seconds=sem_s, host_s_per_pair=sem_s / DATASET_PAIRS,
                          seconds_again=time.time() - t0)
        out["sem"]["ok"] = written == DATASET_PAIRS and again == 0
        emit({"phase": "sem_preprocessing", **out["sem"]})
        # (c) dataset mode at kitti_test: the .pkl, then a .pth of the same
        # weights (MinkowskiEngine naming, x-fastest taps)
        blob = load_checkpoint(CLI_WEIGHTS)
        pth = os.path.join(work, "kitti_coloring_best_checkpoint.pth")
        torch.save({"model_state_dict": {
            k: torch.from_numpy(v) for k, v in to_me_state_dict(
                blob["params"], blob["bn_state"]).items()}}, pth)
        base = ["--set", f"data_path={os.path.join(kitti, 'sequences')}",
                "--set", f"cache_data_path={cache}",
                "--set", "corr_no_nksr=true"]
        runs = [dataset_eval(
            label, base + ["--set", f"model_checkpoint_path={ckpt}"],
            DATASET_PAIRS) for label, ckpt in (("kitti_test_pkl", CLI_WEIGHTS),
                                               ("kitti_test_pth", pth))]
        same = [a["T"] == b["T"] for a, b in zip(runs[0]["per_pair"],
                                                 runs[1]["per_pair"])]
        for r in runs:
            r["T_bit_identical_pkl_pth"] = same
            emit({"phase": "dataset_cli", **r,
                  "seconds_total": time.time() - t_start})
            paths[f"dataset_{r['run']}"] = r["launches"]
        out["kitti"] = runs
        # (d) one nuScenes pair in preprocess mode
        from umeregrobust_tpu_torch.data.datasets import NuscenesDataset

        nu_args = ["--benchmark", "nuscenes_test",
                   "--set", f"data_path={nusc}", "--set", "cache_data_path=",
                   "--set", f"model_checkpoint_path={CLI_WEIGHTS}"]
        nd = NuscenesDataset(nusc, "test", dataset_size=1)
        seq, f0, _ = nd._pair_key(0)
        pts, seg = nd._load_frame(seq, f0)
        ego_dropped = len(pts) - len(nd._post_load_filter(pts, seg)[0])
        nu = dataset_eval("nuscenes_test_preprocess", nu_args, 1)
        nu.update(sequence=seq, ego_points_dropped=ego_dropped)
        nu["ok"] = nu["ok"] and ego_dropped >= EGO_POINTS
        emit({"phase": "dataset_cli", **nu,
              "seconds_total": time.time() - t_start})
        paths["dataset_nuscenes"] = nu["launches"]
        out["nuscenes"] = nu
        # (e) RT-UME on pair 0's features
        args = ev.parse_args(base)
        reset_launch_counts()
        rt = phase_rtume(dev, args, *ev._datasets(args, dataset_size=1))
        paths["rtume"] = launch_counts()
        out["rtume"] = rt
    out["ok"] = (out["sem"]["ok"] and all(r["ok"] for r in runs)
                 and all(same) and nu["ok"] and rt["ok"])
    return out, paths


def phase_reference(dev, model_gpu, model_cpu, cfg_small):
    """The small pair on the card and on the CPU with the same draws."""
    import torch

    from umeregrobust_tpu_torch.data.suite import small_pair
    from umeregrobust_tpu_torch.pipeline.e2e import register_pair_e2e

    pair = small_pair(42)
    s, tg = pair["src"], pair["tgt"]
    rng = np.random.default_rng(0)
    draws = {k: rng.permutation(np.flatnonzero(pair[t]["mask"]))[
        :cfg_small.num_init_keypoints] for k, t in (("src_kp", "src"),
                                                     ("tgt_kp", "tgt"))}
    res = {}
    for name, model, device in (("cuda", model_gpu, dev),
                                ("cpu", model_cpu, "cpu")):
        Ti, Tr = register_pair_e2e(
            model, (2048, 2048, 1024, 512, 256), cfg_small,
            s["coords"], s["grid"], s["mask"], tg["coords"], tg["grid"],
            tg["mask"], s["corr_pts"], s["corr_mask"], tg["corr_pts"],
            tg["corr_mask"], compute_dtype=torch.float32, draws=draws,
            device=device)
        res[name] = (Ti.cpu().numpy(), Tr.cpu().numpy())
    d_init = float(np.abs(res["cuda"][0] - res["cpu"][0]).max())
    d_ref = float(np.abs(res["cuda"][1] - res["cpu"][1]).max())
    ok = (d_init <= 1e-4 and d_ref <= 1e-3
          and all(np.isfinite(x).all() for x in res["cuda"]))
    return dict(max_abs_T_init=d_init, max_abs_T_refined=d_ref, ok=ok)


class OldConvKernels:
    """Within the block the backbone's per-tap convs take the FMA tile by
    the first port's rule (old_route): the forward as it ran before the
    tensor-core redesign, for a comparison in one call. A measurement
    aid; the port never routes so."""

    def __enter__(self):
        import torch

        import umeregrobust_tpu_torch.models.resunet as resunet
        from umeregrobust_tpu_torch.ops import cuda_conv

        self.mod, self.conv = resunet, resunet.sparse_conv

        def old(feats, w, nbr, bias=None, compute_dtype=torch.float32,
                pairs=1):
            out = cuda_conv.sparse_conv_fma(
                feats.to(torch.float32).contiguous(), w.contiguous(),
                nbr.contiguous(), old_route(nbr.shape[1] // pairs, w.shape[2],
                                            w.shape[0]), compute_dtype)
            return out if bias is None else out + bias.to(torch.float32)

        resunet.sparse_conv = old
        return self

    def __exit__(self, *exc):
        self.mod.sparse_conv = self.conv



class PlainGroupedConv:
    """Within the block the backbone's grouped k3 convs run as the tree
    before the grouped kernel ran them: `sparse_conv_grouped_plain` (9
    window gathers through the gather_rows kernel and per-pair cuBLAS
    products a conv; in training autograd through it keeps the windows).
    A measurement aid for an A/B in one call; the port never runs so on
    the card."""

    def __enter__(self):
        import umeregrobust_tpu_torch.models.resunet as resunet
        from umeregrobust_tpu_torch.ops.sparse import (
            sparse_conv_grouped_plain)

        self.mod, self.conv = resunet, resunet.sparse_conv_grouped

        def plain(*a, adjoint=None, **kw):
            return sparse_conv_grouped_plain(*a, **kw)

        resunet.sparse_conv_grouped = plain
        return self

    def __exit__(self, *exc):
        self.mod.sparse_conv_grouped = self.conv


class ParentRecomputeGroupedConv:
    """Within the block the backbone's grouped k3 convs run as the parent
    tree trained them: the forward kernel, and a backward that recomputes
    `sparse_conv_grouped_plain` on the saved inputs and differentiates it
    (its window gathers through gather_rows, their backward through
    gather_rows_backward, the products through per-pair cuBLAS calls). A
    measurement aid for an A/B in one call; the port never runs so."""

    def __enter__(self):
        import torch

        import umeregrobust_tpu_torch.models.resunet as resunet
        from umeregrobust_tpu_torch.ops.cuda_grouped import (
            sparse_conv_grouped_kernel)
        from umeregrobust_tpu_torch.ops.sparse import (
            sparse_conv_grouped_plain)

        class Recompute(torch.autograd.Function):
            @staticmethod
            def forward(ctx, feats, weights, bias, gmap, compute_dtype,
                        pairs):
                ctx.save_for_backward(feats, weights, bias)
                ctx.gmap, ctx.compute_dtype = gmap, compute_dtype
                ctx.pairs = pairs
                return sparse_conv_grouped_kernel(
                    feats.to(torch.float32).contiguous(),
                    weights.contiguous(), gmap, bias, compute_dtype)

            @staticmethod
            def backward(ctx, g):
                saved = ctx.saved_tensors
                need = ctx.needs_input_grad[:3]
                with torch.enable_grad():
                    leaves = [None if x is None else
                              x.detach().requires_grad_(nd)
                              for x, nd in zip(saved, need)]
                    out = sparse_conv_grouped_plain(
                        leaves[0], leaves[1], ctx.gmap, leaves[2],
                        ctx.compute_dtype, ctx.pairs)
                    want = [x for x, nd in zip(leaves, need) if nd]
                    got = iter(torch.autograd.grad(out, want, g)
                               if want else ())
                return (*(next(got) if nd else None for nd in need), None,
                        None, None)

        def recompute(feats, w, gmap, bias=None,
                      compute_dtype=torch.float32, pairs=1, adjoint=None):
            return Recompute.apply(feats, w, bias, gmap, compute_dtype,
                                   pairs)

        self.mod, self.conv = resunet, resunet.sparse_conv_grouped
        resunet.sparse_conv_grouped = recompute
        return self

    def __exit__(self, *exc):
        self.mod.sparse_conv_grouped = self.conv


GROUPED_AB_FEATURE_LIMIT = 1e-3  # x max |feature|, fp32 operands


def phase_grouped_ab(dev, model, caps, cfg, pairs, scan_model):
    """This tree's grouped k3 conv (the sparse_conv_grouped kernel) against
    its plain version's form ("parent": PlainGroupedConv, as the tree
    before the grouped kernel ran it), alternated in one call in the
    order parent, change, change, parent, after a warm-up of
    each. A round: the pairs one at a time through register_pair_e2e
    (pair i seeded i; pairs/s and each pair's NP / SP verdict), each
    pair's feature stage alone (pair_features_e2e; ms, host clock round a
    synchronize), then the pairs as one batch through
    register_pairs_batched (pairs/s); with the round's gather_rows and
    sparse_conv_grouped launches. The two forms' features (the first pair
    alone, and the batch) are compared. They differ in the kernel's fp32
    summation order against cuBLAS's, which the bf16 network carries
    through each next layer's rounding of its operands (a last-bit
    difference moves a bf16 operand by one of its ulps): with bf16
    operands their max abs difference is reported beside that between
    the parent's form and the per-tap kernels (`scan_model`, a third sum
    order); with fp32 operands, where no such rounding carries it, it is
    held within GROUPED_AB_FEATURE_LIMIT x max |feature|. Every pair's
    verdict must be the same in every round."""
    import contextlib

    import torch

    from umeregrobust_tpu_torch.pipeline.e2e import (
        pair_features_batched, pair_features_e2e, register_pair_e2e,
        register_pairs_batched)

    bargs = stacked_args(pairs)

    def form(kind):
        return PlainGroupedConv() if kind == "parent" else \
            contextlib.nullcontext()

    def features(dt=torch.bfloat16, m=model):
        one = pair_features_e2e(m, caps, *pair_args(pairs[0]),
                                compute_dtype=dt, device=dev)
        many = pair_features_batched(m, caps, *bargs, compute_dtype=dt,
                                     device=dev)
        return [t.cpu() for t in one + many]

    def max_diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def one_round():
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.time()
        verdicts = []
        for i, p in enumerate(pairs):
            _, T = register_pair_e2e(model, caps, cfg, *pair_args(p),
                                     device=dev, generator=torch.Generator(
                                         device=dev).manual_seed(i))
            v = verdict(T, p["gt"])
            verdicts.append((v["np_pass"], v["sp_pass"]))
        torch.cuda.synchronize()
        seq = len(pairs) / (time.time() - t0)
        lc = launch_counts()
        feat_ms = []
        for p in pairs:
            t0 = time.time()
            pair_features_e2e(model, caps, *pair_args(p), device=dev)
            torch.cuda.synchronize()
            feat_ms.append((time.time() - t0) * 1e3)
        t0 = time.time()
        register_pairs_batched(model, caps, cfg, *bargs, device=dev,
                               generators=[torch.Generator(
                                   device=dev).manual_seed(i)
                                   for i in range(len(pairs))])
        torch.cuda.synchronize()
        return dict(pairs_per_s=seq,
                    pairs_per_s_batched=len(pairs) / (time.time() - t0),
                    features_ms=feat_ms, verdicts=verdicts,
                    gather_rows_launches_e2e=lc["gather_rows"],
                    sparse_conv_grouped_launches_e2e=lc[
                        "sparse_conv_grouped"])

    feats, feats32, rounds = {}, {}, []
    for kind in ("parent", "change"):
        with form(kind):
            feats[kind] = features()  # also the warm-up
            feats32[kind] = features(torch.float32)
            one_round()
    scan = features(m=scan_model)
    for kind in ("parent", "change", "change", "parent"):
        with form(kind):
            rounds.append(dict(form=kind, **one_round()))
    same = [bool(torch.equal(a, b))
            for a, b in zip(feats["parent"], feats["change"])]
    diff32 = max_diff(feats32["parent"], feats32["change"])
    limit32 = GROUPED_AB_FEATURE_LIMIT * max(float(a.abs().max())
                                             for a in feats32["parent"])
    want = rounds[0]["verdicts"]
    same_verdicts = all(r["verdicts"] == want for r in rounds)

    def mean(kind, key):
        v = [r[key] for r in rounds if r["form"] == kind]
        return float(np.mean([np.median(x) if isinstance(x, list) else x
                              for x in v]))

    return dict(
        pairs=len(pairs), rounds=rounds, features_bit_identical=all(same),
        features_bit_identical_each=same,
        features_max_abs_diff=max_diff(feats["parent"], feats["change"]),
        features_max_abs_diff_scan_vs_parent=max_diff(feats["parent"], scan),
        features_max_abs=max(float(a.abs().max()) for a in feats["parent"]),
        features_max_abs_diff_fp32=diff32, features_limit_fp32=limit32,
        same_verdicts=same_verdicts,
        ok=diff32 <= limit32 and same_verdicts,
        **{f"{k}_{kind}": mean(kind, k) for kind in ("parent", "change")
           for k in ("pairs_per_s", "pairs_per_s_batched", "features_ms")})


def phase_profile(run, pairs, cfg, unprofiled_wall_s, model, run_all=None):
    """The e2e pairs again under torch.profiler (same seeds and config);
    `model` tags the lines ("grouped", "scan", "resunet" or "batched"; a
    run without an unprofiled run of its own passes None, and its idle
    estimate is NaN). run_all, when given, drives all the pairs in one
    call (the batched path) instead of run(p, i) a pair."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    stages = ("geometry", "forward", "feat_to_raw", "hypotheses", "icp")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        if run_all is not None:
            run_all()
        else:
            for i, p in enumerate(pairs):
                run(p, i)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    n = len(pairs)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.events()
    # device-side ranges of the stage annotations, and the kernels
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == cuda and e.name in stages]
    kernels = [e for e in events
               if e.device_type == cuda and e.name not in stages]
    busy_ms = sum(k.time_range.elapsed_us() for k in kernels) / 1e3
    per = {k: dict(host_ms=0.0, device_ms=0.0) for k in stages}
    for e in events:
        if e.device_type == cpu and e.name in per:
            per[e.name]["host_ms"] += e.cpu_time_total / 1e3
    for k in kernels:
        for lo, hi, name in ranges:
            if lo <= k.time_range.start <= hi:
                per[name]["device_ms"] += k.time_range.elapsed_us() / 1e3
                break
    for name, v in per.items():
        emit({"phase": "profile", "model": model, "stage": name,
              "host_ms_per_pair_profiled": v["host_ms"] / n,
              "device_ms_per_pair": v["device_ms"] / n})
    unprof_ms = (unprofiled_wall_s or float("nan")) * 1e3
    emit({"phase": "profile_summary", "model": model, "pairs": n,
          "icp_budget": cfg.icp_budget,
          "wall_ms_per_pair_profiled": wall_ms / n,
          "device_busy_ms_per_pair": busy_ms / n,
          "device_idle_share_profiled": 1.0 - busy_ms / wall_ms,
          # device time of this run over the wall of phase 5's run
          "wall_ms_per_pair_unprofiled": unprof_ms / n,
          "device_idle_share_unprofiled_est": 1.0 - busy_ms / unprof_ms,
          "kernels_per_pair": len(kernels) / n})
    top = sorted((a for a in prof.key_averages() if a.key not in stages),
                 key=lambda a: -a.self_device_time_total)
    for a in top[:12]:
        emit({"phase": "profile_op", "model": model, "op": a.key[:80],
              "count_per_pair": a.count / n,
              "device_ms_per_pair": a.self_device_time_total / 1e3 / n})


# ---------------------------------------------------------------------------
# phase 3 (widths): the moments and scorer kernels at feature widths other
# than 32, and the registration path and RT-UME at out_channels 16 / 64
WIDTHS = (8, 16, 64)


def width_cases(dev, pair):
    """ume_moments_fused (2048 keypoints of the nominal pair's SEM grid, r
    5, cap 750) and corr_scores_fused (the arbiter's shape: 17 hypotheses
    x 2048 source x 2048 target rows of its correlator clouds) at C = 8,
    16, 64 with random features, each against its plain version on the
    card (ume within 1e-5 x max |out|, corr within 1e-4 x max |score|),
    two launches bit-identical."""
    import torch

    from umeregrobust_tpu_torch.ops.cuda_corr import (
        corr_scores_fused, corr_scores_plain)
    from umeregrobust_tpu_torch.ops.cuda_ume import (
        ume_moments_fused, ume_moments_plain)

    g = torch.Generator(device="cpu").manual_seed(11)
    s = pair["src"]
    pts = torch.as_tensor(s["grid"][s["mask"]], dtype=torch.float32)
    kp = pts[torch.randperm(len(pts), generator=g)[:2048]]
    cp = torch.as_tensor(pair["tgt"]["corr_pts"][:2048], dtype=torch.float32)
    pts4 = torch.cat([cp, torch.zeros(len(cp), 1)], 1)
    H = 17
    noise = torch.randn(H, len(cp), 3, generator=g) * 0.3
    pts_t = torch.cat([cp[None] + noise, torch.zeros(H, len(cp), 1)], -1)
    out = {}
    for C in WIDTHS:
        Z = torch.randn(len(pts), 4 * C, generator=g)
        mask = torch.ones(len(pts), dtype=torch.bool)
        a = [x.to(dev) for x in (kp, pts, Z, mask)]
        got = ume_moments_fused(*a, 5.0, 750)
        again = ume_moments_fused(*a, 5.0, 750)
        want = ume_moments_plain(*a, 5.0, 750)
        e_ume = float((got - want).abs().max() / want.abs().max())
        f = torch.randn(len(cp), C, generator=g)
        gg = torch.randn(len(cp), C, generator=g)
        b = [x.to(dev) for x in (pts_t, f, pts4, gg)]
        sc = corr_scores_fused(*b)
        sc2 = corr_scores_fused(*b)
        scp = corr_scores_plain(*b)
        e_corr = float((sc - scp).abs().max() / scp.abs().max())
        out[f"C{C}"] = dict(
            ume_shape=list(got.shape), ume_rel_err=e_ume,
            ume_bit_identical=bool(torch.equal(got, again)),
            corr_rel_err=e_corr,
            corr_bit_identical=bool(torch.equal(sc, sc2)),
            ume_ms=time_ms(lambda: ume_moments_fused(*a, 5.0, 750)),
            corr_ms=time_ms(lambda: corr_scores_fused(*b)))
        out[f"C{C}"]["ok"] = (e_ume <= 1e-5 and e_corr <= 1e-4
                              and out[f"C{C}"]["ume_bit_identical"]
                              and out[f"C{C}"]["corr_bit_identical"])
    return out


def phase_widths(dev, pair, cfg):
    """register_pair_e2e and rtume_estimate on the card with a seeded
    random-weight ResUNetSmall2 at out_channels 16 and 64 (the nominal
    pair, reduced point; RT-UME on 512 of its SEM points, r 5, cap 750):
    finite transforms, the kernels each launched."""
    import torch

    from umeregrobust_tpu_torch.data.suite import REDUCED
    from umeregrobust_tpu_torch.models.resunet import ARCHS, init_resunet
    from umeregrobust_tpu_torch.pipeline.e2e import (
        pair_features_e2e, register_pair_e2e)
    from umeregrobust_tpu_torch.pipeline.rtume import rtume_estimate

    out = {}
    for C in (16, 64):
        model = init_resunet(ARCHS["ResUNetSmall2"], 1, C, device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(C))
        reset_launch_counts()
        t0 = time.time()
        T_init, T = register_pair_e2e(
            model, REDUCED["caps"], cfg, *pair_args(pair), device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        sec = time.time() - t0
        sf, tf, _, _ = pair_features_e2e(model, REDUCED["caps"],
                                         *pair_args(pair), device=dev)
        s, tg = pair["src"], pair["tgt"]
        kp = torch.as_tensor(s["grid"][s["mask"]][:512])
        Tr, D, G, _ = rtume_estimate(
            s["grid"], sf, kp, tg["grid"], tf, kp, src_mask=s["mask"],
            tgt_mask=tg["mask"], device=dev)
        torch.cuda.synchronize()
        lc = launch_counts()
        out[f"out_channels_{C}"] = dict(
            seconds=sec, features=list(sf.shape),
            T_finite=bool(torch.isfinite(T).all() and torch.isfinite(
                T_init).all()),
            rtume_finite=bool(torch.isfinite(Tr).all()),
            ume_shape=list(G.shape), launches=lc,
            ok=bool(torch.isfinite(T).all() and torch.isfinite(Tr).all()
                    and lc["ume_moments_fused"] >= 3
                    and lc["corr_scores_fused"] >= 3))
    return out


# ---------------------------------------------------------------------------
# phase 5i: training on the card (train/, losses/, the backward kernels)
TRAIN_B = 8
TRAIN_STEPS = 3
GRAD_LEAF_TOL = 1e-4  # card vs CPU, a gradient leaf, of its max |grad|
RESUNET_TRAIN_RATIOS = (1.0, 0.1328125, 0.046875, 0.0234375, 0.0078125,
                        0.0078125)  # default_level_capacities(16384, ResUNet)


def train_batch(n_pairs, seed, max_pc_size=16384):
    """n_pairs lidar pairs at HDL-64 density (phase 5h's scenes), collated
    at train_kitti_config's widths: max_pc_size voxels a cloud (the config
    has 100000; the training phase cuts it to 16384), 512 matches."""
    from umeregrobust_tpu_torch.data.synthetic import (
        SceneConfig, make_collated_batch)

    return make_collated_batch(SceneConfig(seed=seed, **HDL64), n_pairs,
                               max_pc_size=max_pc_size, num_matches=512,
                               seed=seed)


def ume_gather_indices(batch, dev, num_samples=256, max_nn=750, min_nn=300,
                       r=5.0):
    """The flattened row indices of the training UMEs' feature gathers of
    a batch (both clouds, every keypoint's ball, pair b's rows offset by b
    N, as gather_padded makes them): the gather kernels' main-path input."""
    import torch

    from umeregrobust_tpu_torch.pipeline.train_keypoints import _select
    from umeregrobust_tpu_torch.train.trainer import batch_to_device

    bt = batch_to_device(batch, dev)
    B, N = bt["src_mask"].shape
    out = []
    for b in range(B):
        _, _, nbr, tnbr, _, _ = _select(
            bt["src_pts"][b], bt["src_seg"][b], bt["src_mask"][b],
            bt["tgt_pts"][b], bt["tgt_mask"][b], bt["gt_tform"][b],
            num_samples, max_nn, min_nn, r, 0.6, (9,))
        for idx in (nbr, tnbr):
            out.append(torch.where(idx >= 0, idx + b * N, -1).reshape(-1))
    return torch.cat(out), B * N


STRESS_ROUNDS = 4
GUARD_BYTES = 1 << 20  # guard bytes on each side of a guarded tensor
GUARD_BYTE = 0xA5
_COUNT_FORMS = None


def count_forms_library():
    """csrc/bench/row_count_forms.cu (the three count / placement forms of
    gather_rows_backward's counting sort), built with the kernels' nvcc
    flags into the build directory and loaded; once a process."""
    global _COUNT_FORMS
    if _COUNT_FORMS is None:
        import ctypes

        from umeregrobust_tpu_torch.ops import _build

        src = _build.CSRC / "bench" / "row_count_forms.cu"
        lib = _build.BUILD_DIR / "bench" / f"librow_count_forms.{os.getpid()}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build._find_nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-shared", str(src), "-o",
                            str(lib), "-lcudart"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"row_count_forms.cu did not build:\n{r.stdout}")
        cdll = ctypes.CDLL(str(lib))
        vp, i = ctypes.c_void_p, ctypes.c_int
        cdll.umr_bench_row_count.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
        cdll.umr_bench_row_count.restype = i
        _COUNT_FORMS = cdll
    return _COUNT_FORMS


def row_count_forms(idx, N):
    """gather_rows_backward's count and placement in the three forms of
    csrc/bench/row_count_forms.cu at one shape (idx (M,), N rows):
    atomic_rank (the kernel's own: one atomic a position, its old value
    the rank), warp_aggregated (the count's atomic aggregated by
    __match_any_sync) and plain_atomics (count and placement each by an
    atomic): device ms (CUDA graph) of the count alone, of count + scan +
    placement, and of the whole row segments (the sort included), and
    whether each form's segments equal row_segments'."""
    import torch

    from umeregrobust_tpu_torch.ops import _build, cuda_gather

    lib = count_forms_library()
    dev, M = idx.device, idx.shape[0]
    ints = torch.empty(cuda_gather.segment_scratch(M, N), dtype=torch.int32,
                       device=dev)
    cursor = torch.empty(N, dtype=torch.int32, device=dev)
    st0, ps0 = cuda_gather.row_segments(idx, N)
    n = N + 1
    at = 2 * n + -(-n // cuda_gather._SCAN_TILE)
    i64 = int(idx.dtype == torch.int64)

    def run(form, stop):
        code = lib.umr_bench_row_count(
            idx.data_ptr(), ints.data_ptr(), cursor.data_ptr(), M, N, i64,
            form, stop, _build.stream_of(dev))
        if code != 0:
            raise RuntimeError(f"umr_bench_row_count: CUDA error {code}")

    out = {}
    for form, name in enumerate(("atomic_rank", "warp_aggregated",
                                 "plain_atomics")):
        run(form, 2)
        torch.cuda.synchronize()
        same = (torch.equal(ints[n: 2 * n], st0)
                and torch.equal(ints[at: at + ps0.numel()], ps0))
        out[name] = dict(
            count_ms=graph_ms(lambda f=form: run(f, 0)),
            count_place_ms=graph_ms(lambda f=form: run(f, 1)),
            segments_ms=graph_ms(lambda f=form: run(f, 2)),
            segments_equal=bool(same))
    return out


def guarded_empty(guard=GUARD_BYTES):
    """A context in which torch.empty on a CUDA device returns a view into
    a buffer `guard` bytes longer at each end, those bytes set to
    GUARD_BYTE; it yields the list of (buffer, guard, bytes) made, for
    guards_intact. The wrappers allocate their outputs and scratch with
    torch.empty, so a kernel's write past either end of one lands in a
    guard (a check for where compute-sanitizer cannot run)."""
    import contextlib
    import math

    import torch

    @contextlib.contextmanager
    def ctx():
        real, made = torch.empty, []

        def empty(*size, dtype=None, device=None, **kw):
            if kw or device is None or torch.device(device).type != "cuda":
                return real(*size, dtype=dtype, device=device, **kw)
            shape = (tuple(size[0]) if len(size) == 1
                     and not isinstance(size[0], int) else tuple(size))
            dtype = dtype or torch.get_default_dtype()
            n = math.prod(shape) * real(0, dtype=dtype).element_size()
            raw = real(2 * guard + n, dtype=torch.uint8, device=device)
            raw[:guard] = GUARD_BYTE
            raw[guard + n:] = GUARD_BYTE
            made.append((raw, guard, n))
            return raw[guard: guard + n].view(dtype).view(shape)

        torch.empty = empty
        try:
            yield made
        finally:
            torch.empty = real

    return ctx()


def guards_intact(made):
    """Whether every guard of guarded_empty's buffers still holds
    GUARD_BYTE."""
    return all(bool((raw[:g] == GUARD_BYTE).all())
               and bool((raw[g + n:] == GUARD_BYTE).all())
               for raw, g, n in made)


def backward_stress(dev, batch, windows, rounds=STRESS_ROUNDS):
    """The backward kernels launched back to back with no synchronize, as
    training launches them, `rounds` times: ResUNet's 11 wgrad layers
    (B = 2, bf16), gather_rows_backward at the UME shape and both window
    shapes, and ResUNetSmall2's grouped convs at B = 8 (bf16: the 18
    forwards, the 17 dX over the adjoint maps, the 18
    sparse_conv_grouped_wgrad), each twice a round, with the ResUNet
    pyramid and conv maps built again right behind them (the geometry's
    own torch indexing runs while they may still run). Every output and
    scratch tensor the wrappers allocate lies between guards
    (guarded_empty) that must come back unchanged, the inputs must come
    back unchanged, the two launches of a round and every round must give
    the first round's bits, and the rebuilt maps must equal the first
    ones. Then the grouped conv's weight-tile cache (grouped_cache_check):
    a layer's weights updated in place between two calls must give the
    plain version's output for the new weights, forward and dX."""
    import torch

    from umeregrobust_tpu_torch.models.resunet import ARCHS, init_resunet
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.ops import cuda_conv, cuda_gather, cuda_grouped
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, _capacities, batch_to_device, cloud_features)

    t0 = time.time()
    bf = torch.bfloat16
    cfg = TrainConfig(arch="ResUNet", batch_size=2,
                      level_capacity_ratios=RESUNET_TRAIN_RATIOS)
    model = init_resunet(ARCHS["ResUNet"], 1, 32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    two = batch_to_device({k: v[:2] for k, v in batch.items()}, dev)

    def pyramid():
        return capture_conv_layers(model, lambda: cloud_features(
            model, two, _capacities(cfg, model.arch), bf, train=False))

    g = torch.Generator(device="cpu").manual_seed(13)
    idx, N = ume_gather_indices(batch, dev)
    gathers = [(torch.randn(idx.shape[0], 32, generator=g).to(dev), idx, N)]
    for label in ("most_rows", "widest"):
        w = windows[label]
        gathers.append((torch.randn(w["idx"].shape[0], w["table"][1],
                                    generator=g).to(dev), w["idx"],
                        w["table"][0]))
    layers = pyramid()
    convs = [(f, torch.randn(nbr.shape[1], w.shape[2], generator=g).to(dev),
              nbr) for _, f, w, nbr, _ in layers]
    maps0 = [nbr for _, _, _, nbr, _ in layers]
    small = load_model(os.path.join(ROOT, "weights", "synthetic_pretrain.pkl"),
                       ARCHS["ResUNetSmall2"], device=dev)
    grouped = [(name, f, w, gmap, adj,
                torch.randn(gmap.center.shape[1], w.shape[2],
                            generator=g).to(dev))
               for name, f, w, gmap, _, _, adj in capture_grouped_layers(
                   small, lambda: cloud_features(
                       small, batch_to_device(batch, dev),
                       _capacities(TrainConfig(), small.arch), bf,
                       train=True))]
    ins = [t for c in convs for t in c] + [t for d, i, _ in gathers
                                           for t in (d, i)]
    ins += [t for _, f, w, _, _, dy in grouped for t in (f, w, dy)]
    keep = [t.clone() for t in ins]
    first, rows = None, []
    for r in range(rounds):
        with guarded_empty() as made:
            outs = []
            for _ in range(2):
                outs += [cuda_conv.sparse_conv_wgrad(f, dy, nbr, bf)
                         for f, dy, nbr in convs]
                outs += [cuda_gather.gather_rows_backward(d, i, n)
                         for d, i, n in gathers]
                for name, f, w, gmap, (adj, rev), dy in grouped:
                    outs.append(cuda_grouped.sparse_conv_grouped_kernel(
                        f, w, gmap, None, bf))
                    if name != "conv1":  # the stem's input needs no dX
                        outs.append(cuda_grouped.sparse_conv_grouped_dx(
                            dy, w, adj, rev, bf))
                    outs.append(cuda_grouped.sparse_conv_grouped_wgrad(
                        f, dy, gmap, bf))
        layers = pyramid()  # synchronizes at its end
        half = len(outs) // 2
        first = first or outs[:half]
        rows.append(dict(
            round=r, guarded_tensors=len(made), guards_intact=guards_intact(made),
            inputs_unchanged=all(torch.equal(a, b) for a, b in zip(ins, keep)),
            twice_identical=all(torch.equal(a, b) for a, b in
                                zip(outs[:half], outs[half:])),
            same_as_first=all(torch.equal(a, b) for a, b in
                              zip(outs[:half], first)),
            maps_same_as_first=len(layers) == len(maps0) and all(
                torch.equal(nbr, m) for (_, _, _, nbr, _), m in
                zip(layers, maps0))))
        del made, outs
    ok = all(all(v for k, v in row.items()
                 if k not in ("round", "guarded_tensors")) for row in rows)
    cache = grouped_cache_check(grouped, g)
    return dict(rounds=rounds, layers=len(convs), gathers=len(gathers),
                grouped_layers=len(grouped), guard_bytes=GUARD_BYTES,
                per_round=rows, weight_cache=cache,
                seconds=time.time() - t0, ok=ok and cache["ok"])


def grouped_cache_check(grouped, g):
    """The grouped conv's bf16 weight tiles are cached a parameter
    version: on one layer of `grouped` (name, feats, weights, map,
    adjoint, dY), a copy of the weights is used, then updated in place as
    the optimizer does (sub_), then used again. The second call must make
    new tiles (one build for the forward's layout, one for dX's), give
    the plain version's output for the new weights (GROUPED_LIMITS, and
    one bf16 ulp for dX) and differ from the first; a third call must
    make none."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_grouped
    from umeregrobust_tpu_torch.ops.sparse import (
        sparse_conv_grouped_dx_plain, sparse_conv_grouped_plain)

    bf = torch.bfloat16
    name, f, w, gmap, (adj, rev), dy = next(x for x in grouped
                                             if x[0] == "block3.conv1")
    wc = w.clone()

    def both():
        return (cuda_grouped.sparse_conv_grouped_kernel(f, wc, gmap, None, bf),
                cuda_grouped.sparse_conv_grouped_dx(dy, wc, adj, rev, bf))

    fa, xa = both()
    builds = dict(cuda_grouped.WEIGHT_TILE_BUILDS)
    with torch.no_grad():
        wc.sub_(1e-2 * torch.randn(wc.shape, generator=g).to(wc.device))
    fb, xb = both()
    made = {k: v - builds[k]
            for k, v in cuda_grouped.WEIGHT_TILE_BUILDS.items()}
    both()
    again = {k: v - builds[k] - made[k]
             for k, v in cuda_grouped.WEIGHT_TILE_BUILDS.items()}
    torch.cuda.synchronize()
    ref_f = sparse_conv_grouped_plain(f, wc, gmap, None, bf)
    ref_x = sparse_conv_grouped_dx_plain(dy, wc, adj, rev, bf)
    err_f = float((fb - ref_f).abs().max())
    lim_f = GROUPED_LIMITS["bfloat16"] * float(ref_f.abs().max())
    dx_chk = grouped_bwd_check(lambda: xb, ref_x, bf)
    res = dict(layer=name, tile_builds_on_update=made,
               tile_builds_after=again, fwd_err=err_f, fwd_limit=lim_f,
               dx_max_err_over_limit=dx_chk["max_err_over_limit"],
               fwd_changed=not bool(torch.equal(fa, fb)),
               dx_changed=not bool(torch.equal(xa, xb)))
    res["ok"] = (err_f <= lim_f and dx_chk["max_err_over_limit"] <= 1.0
                 and res["fwd_changed"] and res["dx_changed"]
                 and made[0] == 1 and made[2 if rev else 1] == 1
                 and sum(again.values()) == 0)
    return res


def gather_backward_shape(label, d, idx, N):
    """gather_rows_backward's times at one shape (dout d (M, C), idx (M,),
    N table rows): the whole function and each of its launches device
    alone, index_add_ over the valid positions and the plain version on
    the card, the bound, the rows' segment lengths, and the count and
    placement in their three forms (row_count_forms)."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_gather

    M, C = d.shape
    ok = (idx >= 0) & (idx < N)
    vi, vd = idx[ok].to(torch.int64), d[ok]

    def library():
        return torch.zeros(N, C, device=d.device).index_add_(0, vi, vd)

    counts = torch.bincount(vi, minlength=N)
    # bytes: the indices, the cotangent rows of valid indices (an index
    # outside [0, N) adds nothing and is never read), the table written
    n_valid = int(ok.sum())
    bb, by = bound_ms(n_valid * C * 4 + M * idx.element_size() + N * C * 4,
                      n_valid * C)
    return dict(
        shape=label, rows=M, valid=n_valid, table=[N, C],
        longest_segment=int(counts.max()) if N else 0,
        mean_segment=n_valid / max(N, 1),
        ms=graph_ms(lambda: cuda_gather.gather_rows_backward(d, idx, N)),
        launch_ms=kernel_split_ms(
            lambda: cuda_gather.gather_rows_backward(d, idx, N)),
        library_ms=graph_ms(library),
        plain_ms=time_ms(lambda: cuda_gather.gather_rows_backward_plain(
            d, idx, N)),
        bound_ms=bb, bound_by=by, count_forms=row_count_forms(idx, N))


def gather_backward_row(dev, batch, windows):
    """gather_rows_backward: forced cases (random indices with -1 and
    indices >= N, rows hit thousands of times (segments past the
    register sort, merged in rounds), N = 1 and 3, C = 3 / 5 / 12 / 64,
    int32 indices, nothing valid) and the main path's shape (the
    training UMEs' gathers of a B = 8 batch at train_kitti_config: 2 x 8
    x 256 x 750 rows of an (8 x 16384, 32) table) against the plain
    version (index_add_) run on the CPU, bit for bit, two launches
    bit-identical, and its row segments equal to row_segments_plain's;
    then at that shape and at the two window-gather shapes of a B = 8
    training forward (`windows`): gather_backward_shape's times."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_gather

    g = torch.Generator(device="cpu").manual_seed(3)
    cases = []
    for M, N, C, it, hot in ((40000, 3000, 32, torch.int64, 0),
                             (1000, 50, 64, torch.int64, 0),
                             (7, 3, 3, torch.int64, 0),
                             (5000, 1, 32, torch.int32, 0),
                             (300000, 20000, 32, torch.int32, 0),
                             (20000, 500, 12, torch.int64, 3000),
                             (200000, 3, 5, torch.int32, 0),
                             (64, 100, 32, None, 0)):
        idx = (torch.full((M,), -1, dtype=torch.int64) if it is None else
               torch.randint(-1, N + 2, (M,), generator=g).to(it))
        if hot:  # one row hit `hot` times
            idx[torch.randperm(M, generator=g)[:hot]] = 0
        d = torch.randn(M, C, generator=g)
        want = cuda_gather.gather_rows_backward_plain(d, idx, N)
        got = cuda_gather.gather_rows_backward(d.to(dev), idx.to(dev), N)
        again = cuda_gather.gather_rows_backward(d.to(dev), idx.to(dev), N)
        st, ps = cuda_gather.row_segments(idx.to(dev), N)
        st0, ps0 = cuda_gather.row_segments_plain(idx, N)
        cases.append(dict(
            M=M, N=N, C=C, bit_equal_cpu_plain=bool(torch.equal(got.cpu(),
                                                                want)),
            two_launches_identical=bool(torch.equal(got, again)),
            segments_equal=bool(torch.equal(st.cpu(), st0)
                                and torch.equal(ps.cpu(), ps0)),
            longest_segment=int((st0[1:] - st0[:-1]).max()),
            max_abs_err=float((got.cpu() - want).abs().max())))
    idx, N = ume_gather_indices(batch, dev)
    M, C = idx.shape[0], 32
    d = torch.randn(M, C, generator=g).to(dev)
    want = cuda_gather.gather_rows_backward_plain(d.cpu(), idx.cpu(), N)
    got = cuda_gather.gather_rows_backward(d, idx, N)
    again = cuda_gather.gather_rows_backward(d, idx, N)
    st, ps = cuda_gather.row_segments(idx, N)
    st0, ps0 = cuda_gather.row_segments_plain(idx.cpu(), N)
    err = float((got.cpu() - want).abs().max())
    shapes = [gather_backward_shape(
        "UME feature gathers of a B = 8 training batch", d, idx, N)]
    for label in ("most_rows", "widest"):
        w = windows[label]
        wd = torch.randn(w["idx"].shape[0], w["table"][1],
                         generator=g).to(dev)
        shapes.append(gather_backward_shape(
            f"window gathers of a B = 8 training forward ({label})", wd,
            w["idx"], w["table"][0]))
    main = shapes[0]
    row = dict(
        shape=f"UME feature gathers of a B = 8 training batch: {M} rows "
              f"({main['valid']} valid) into a ({N}, {C}) fp32 table",
        cases=cases, bit_equal_cpu_plain=bool(torch.equal(got.cpu(), want)),
        two_launches_identical=bool(torch.equal(got, again)),
        segments_equal=bool(torch.equal(st.cpu(), st0)
                            and torch.equal(ps.cpu(), ps0)),
        max_abs_err=max([err] + [c["max_abs_err"] for c in cases]),
        ms=main["ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], shapes=shapes,
        no_slower_than_index_add=[s_["ms"] <= s_["library_ms"]
                                  for s_ in shapes])
    row["ok"] = (row["bit_equal_cpu_plain"] and row["two_launches_identical"]
                 and row["segments_equal"]
                 and all(c["bit_equal_cpu_plain"]
                         and c["two_launches_identical"]
                         and c["segments_equal"] for c in cases))
    return row


def window_gathers(dev, batch, weights):
    """The grouped k3 convs' window gathers of one ResUNetSmall2 training
    forward and backward at train_kitti_config (B = 8, bf16 operands;
    tables of 3 Cin columns, fp32) as the parent tree trained
    (ParentRecomputeGroupedConv: the forward kernel, a backward that
    recomputes the plain version, whose window gathers these are; this
    tree's training gathers no window, so they stand here as large
    shapes of both gather kernels). Every gather of the conv with the
    most table rows and of the conv with the widest table: `gather_rows`
    against its plain
    version on the CPU and `gather_rows_backward` (a seeded cotangent)
    against its plain version on the CPU, bit for bit, two launches of
    each identical; the forward's device time (CUDA graph) of the first
    gather of each (gather_backward_row times the backward there)."""
    import torch

    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.ops import cuda_gather, sparse
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, _capacities, batch_to_device, cloud_features)

    model = load_model(weights, ARCHS["ResUNetSmall2"], device=dev)
    got, orig = [], sparse.gather_padded

    def record(x, idx, fill=0.0):
        got.append((x.detach(), idx.reshape(-1)))
        return orig(x, idx, fill)

    sparse.gather_padded = record
    try:
        with ParentRecomputeGroupedConv():
            src, tgt, _ = cloud_features(
                model, batch_to_device(batch, dev),
                _capacities(TrainConfig(), model.arch), torch.bfloat16,
                train=True)
            (torch.sum(src) + torch.sum(tgt)).backward()
    finally:
        sparse.gather_padded = orig
    del src, tgt, model
    tables = {}  # the recorded tables stay alive: no pointer is reused
    for x, idx in got:
        tables.setdefault(x.data_ptr(), (x, []))[1].append(idx)
    picks = {"most_rows": max(tables.values(), key=lambda t: t[0].shape),
             "widest": max(tables.values(),
                           key=lambda t: t[0].shape[::-1])}
    g = torch.Generator(device="cpu").manual_seed(11)
    rows = {}
    for label, (x, idxs) in picks.items():
        xc, N, C = x.cpu(), x.shape[0], x.shape[1]
        fwd = bwd = twice = True
        for idx in idxs:
            a, b = (cuda_gather.gather_rows(x, idx) for _ in range(2))
            fwd &= bool(torch.equal(a.cpu(), cuda_gather.gather_rows_plain(
                xc, idx.cpu())))
            d = torch.randn(idx.shape[0], C, generator=g)
            dd = d.to(dev)
            p, q = (cuda_gather.gather_rows_backward(dd, idx, N)
                    for _ in range(2))
            want = cuda_gather.gather_rows_backward_plain(d, idx.cpu(), N)
            bwd &= bool(torch.equal(p.cpu(), want))
            twice &= bool(torch.equal(a, b) and torch.equal(p, q))
        idx = idxs[0]
        ok = idx >= 0
        rows[label] = dict(
            table=[N, C], gathers=len(idxs), rows=idx.shape[0],
            valid=int(ok.sum()), forward_bit_equal=fwd,
            backward_bit_equal=bwd, two_launches_identical=twice,
            kernel_ms=graph_ms(lambda: cuda_gather.gather_rows(x, idx)),
            library_kernel_ms=graph_ms(lambda: torch.index_select(
                x, 0, torch.where(ok, idx, 0))),
            # bytes: the valid rows read, every output row written, the
            # indices
            bound_ms=bound_ms((int(ok.sum()) + idx.shape[0]) * C * 4
                              + idx.shape[0] * idx.element_size(), 0)[0],
            idx=idx)
    return dict(gathers=len(got), tables=len(tables), **rows,
                ok=all(r["forward_bit_equal"] and r["backward_bit_equal"]
                       and r["two_launches_identical"]
                       for r in rows.values()))

def wgrad_layer_row(name, f, w, nbr, pairs, g):
    """One real conv layer's weight gradient at bf16 operands against the
    plain version (<= 1e-4 x max |dW|), two launches bit-identical; dX
    (the forward kernels over the inverted map) against the plain
    version's dX; device times (CUDA graph) of the function, of each of
    its launches and of the first port's CUDA-core kernel at bf16
    (`sparse_conv_wgrad_fma`, in the same call), times of the plain
    version and of the library route (per tap index_select of the valid
    entries' rows and one fp32 torch.mm of the bf16-rounded operands),
    and the bound."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_conv
    from umeregrobust_tpu_torch.ops.sparse import (
        PerTapConv, invert_map_batch, round_to)

    bf = torch.bfloat16
    K, Cin, Cout = w.shape
    dy = torch.randn(nbr.shape[1], Cout, generator=g, device=f.device)
    got = cuda_conv.sparse_conv_wgrad(f, dy, nbr, bf)
    again = cuda_conv.sparse_conv_wgrad(f, dy, nbr, bf)
    want = cuda_conv.sparse_conv_wgrad_plain(f, dy, nbr, bf)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    x = f.clone().requires_grad_()
    PerTapConv.apply(x, w, nbr, bf, pairs).backward(dy)
    ok = (nbr >= 0) & (nbr < f.shape[0])
    inv = invert_map_batch(torch.where(ok, nbr, -1), f.shape[0])
    dx_plain = cuda_conv.sparse_conv_plain(dy, w.transpose(1, 2), inv, bf)
    dx_err = float((x.grad - dx_plain).abs().max())
    dx_scale = float(dx_plain.abs().max())
    kk, oo = torch.nonzero(ok, as_tuple=True)
    taps = [(k, nbr[k][oo[kk == k]], oo[kk == k]) for k in
            torch.unique(kk).tolist()]
    fr, gr = round_to(f, bf), round_to(dy, bf)

    def library():
        return [torch.mm(fr.index_select(0, i).T, gr.index_select(0, o))
                for _, i, o in taps]

    # bytes: the map, the X rows and dY rows that some valid entry names
    # (as conv_bound counts the forward's), dW written once
    valid = int(ok.sum())
    x_rows = int(torch.unique(nbr[ok]).numel())
    dy_rows = int(ok.any(0).sum())
    n_bytes = (nbr.numel() * nbr.element_size() + x_rows * Cin * 4
               + dy_rows * Cout * 4 + K * Cin * Cout * 4)
    bb, by = bound_ms(n_bytes, 2 * valid * Cin * Cout, BF16_PEAK)
    return dict(
        layer=name, K=K, cin=Cin, cout=Cout, rows_in=f.shape[0],
        rows_out=nbr.shape[1], valid=valid, x_rows_read=x_rows,
        dy_rows_read=dy_rows,
        plan=cuda_conv.wgrad_plan(nbr.shape[1], Cin, Cout, K)._asdict(),
        max_abs_err=err, rel_err=err / max(scale, 1e-30),
        bit_identical=bool(torch.equal(got, again)),
        dx_rel_err=dx_err / max(dx_scale, 1e-30),
        kernel_ms=graph_ms(lambda: cuda_conv.sparse_conv_wgrad(
            f, dy, nbr, bf), reps=5, inner=5),
        launch_ms=kernel_split_ms(lambda: cuda_conv.sparse_conv_wgrad(
            f, dy, nbr, bf), calls=5),
        old_kernel_ms=graph_ms(lambda: cuda_conv.sparse_conv_wgrad_fma(
            f, dy, nbr, bf), reps=5, inner=5),
        plain_ms=time_ms(lambda: cuda_conv.sparse_conv_wgrad_plain(
            f, dy, nbr, bf), reps=3, warmup=1),
        library_ms=time_ms(library, reps=5, warmup=1),
        bound_ms=bb, bound_by=by,
        ok=bool(err <= 1e-4 * scale and torch.equal(got, again)
                and dx_err <= 1e-4 * dx_scale))


def wgrad_forced_cases(dev):
    """sparse_conv_wgrad on forced maps (injective per tap, ~40% valid;
    K 27 / 125 / 343, Cin 1 / 3 / 20 / 32 / 64 / 512, Cout 5 / 7 / 32 /
    48 / 128 / 1024, entry segments 1-10, int32 and int64: channel counts
    that are no multiple of 8 take the tensor-core kernel's zero-padded
    rows and its scalar stores of an odd Cout, the stem kernel takes Cout
    < 32), fp32 and bf16, against the plain
    version (<= 2e-5 / 1e-4 x max |dW|), two launches bit-identical; and
    the fp32 dX of the conv's autograd on the card against autograd
    through the plain version on the CPU (<= 2e-5 x max |dX|)."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_conv
    from umeregrobust_tpu_torch.ops.sparse import sparse_conv

    g = torch.Generator(device="cpu").manual_seed(5)
    rows = []
    for n_in, n_out, K, cin, cout, it in (
            (3000, 2500, 27, 32, 32, torch.int64),
            (500, 300, 125, 64, 128, torch.int32),
            (20000, 20000, 27, 32, 32, torch.int64),
            (200, 100, 343, 1, 32, torch.int64),
            (300, 200, 125, 512, 1024, torch.int32),
            (700, 900, 27, 3, 48, torch.int64),
            (500, 400, 27, 20, 7, torch.int32),
            (200, 100, 343, 1, 5, torch.int32)):
        nbr = torch.stack([torch.where(
            torch.rand(n_out, generator=g) < 0.4,
            torch.randperm(max(n_in, n_out), generator=g)[:n_out],
            torch.tensor(-1)) for _ in range(K)])
        nbr = torch.where(nbr < n_in, nbr, torch.tensor(-1)).to(it)
        X = torch.randn(n_in, cin, generator=g)
        G = torch.randn(n_out, cout, generator=g)
        W = torch.randn(K, cin, cout, generator=g) * 0.1
        for cd, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-4)):
            a = [X.to(dev), G.to(dev), nbr.to(dev)]
            got = cuda_conv.sparse_conv_wgrad(*a, cd)
            again = cuda_conv.sparse_conv_wgrad(*a, cd)
            want = cuda_conv.sparse_conv_wgrad_plain(X, G, nbr, cd)
            e = float((got.cpu() - want).abs().max() / want.abs().max())
            row = dict(shape=[n_in, n_out, K, cin, cout, str(it)[6:]],
                       dtype=str(cd)[6:],
                       kernel=cuda_conv.wgrad_plan(n_out, cin, cout, K,
                                                   cd).kind, rel_err=e,
                       bit_identical=bool(torch.equal(got, again)))
            if cd == torch.float32:
                x = X.to(dev).requires_grad_()
                (sparse_conv(x, W.to(dev), nbr.to(dev)) * G.to(dev)).sum(
                ).backward()
                xc = X.clone().requires_grad_()
                (cuda_conv.sparse_conv_plain(xc, W, nbr.long())
                 * G).sum().backward()
                row["dx_rel_err"] = float((x.grad.cpu() - xc.grad).abs().max()
                                          / xc.grad.abs().max())
            row["ok"] = (e <= tol and row["bit_identical"]
                         and row.get("dx_rel_err", 0.0) <= 2e-5)
            rows.append(row)
    return rows


GROUPED_BWD_FP32_LIMIT = 1e-5  # x max |plain|
GROUPED_BWD_BF16_LIMIT = 1e-4  # x max |plain|, or one bf16 ulp of the entry


def grouped_bwd_check(fn, ref, cd):
    """fn() (a backward kernel's wrapper) against `ref` (its plain version
    on the card, the same arithmetic) at compute dtype cd: fp32 within
    GROUPED_BWD_FP32_LIMIT x max |ref|; bf16 (the result rounded to bf16:
    a last-bit difference of the fp32 sums may land one bf16 ulp away)
    each entry within the larger of one bf16 ulp of it and
    GROUPED_BWD_BF16_LIMIT x max |ref|; two launches bit-identical, the
    first launch's outputs and scratch between guards that must stay
    unwritten (guarded_empty)."""
    import torch

    with guarded_empty() as made:
        a = fn()
    b = fn()
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    diff = (a - ref).abs()
    if cd == torch.float32:
        lim = torch.full_like(ref, GROUPED_BWD_FP32_LIMIT * scale)
    else:
        _, e = torch.frexp(ref)
        lim = torch.clamp(torch.ldexp(torch.ones_like(ref), e - 8),
                          min=GROUPED_BWD_BF16_LIMIT * scale)
    over = float((diff / torch.clamp(lim, min=1e-30)).max())
    twice, guards = bool(torch.equal(a, b)), guards_intact(made)
    return dict(max_abs_err=float(diff.max()), scale=scale,
                max_err_over_limit=over, two_launches_identical=twice,
                guards_intact=guards,
                ok=over <= 1.0 and twice and guards
                and bool(torch.isfinite(a).all()))


def grouped_wgrad_bound(f, dy, gmap):
    """(bound ms, bound_by) of one grouped conv's weight gradient.
    Operations: 2 x 3 Cin x Cout a window that some slot uses; bytes: the
    fp32 X rows some slot reads and dY rows of used windows as they lie,
    the map, and dW (27, Cin, Cout) fp32 written once."""
    import torch

    from umeregrobust_tpu_torch.ops.sparse import ungroup_kernel_map

    Cin, Cout = f.shape[1], dy.shape[1]
    used_rows = gmap.masks.any(1) | gmap.patho
    used = int(used_rows.sum())
    nbr = ungroup_kernel_map(gmap)
    rows_read = int(torch.unique(nbr[(nbr >= 0)
                                     & (nbr < f.shape[0])]).numel())
    map_bytes = sum(x.numel() * x.element_size()
                    for x in (gmap.center, gmap.masks, gmap.patho))
    n_bytes = (rows_read * Cin * 4 + int(used_rows.any(0).sum()) * Cout * 4
               + map_bytes + 27 * Cin * Cout * 4)
    return bound_ms(n_bytes, 2 * used * 3 * Cin * Cout, BF16_PEAK)


def grouped_bwd_row(name, f, w, gmap, adjoint, pairs, g):
    """One grouped k3 layer's backward at its training shape (seeded dY):
    dW (sparse_conv_grouped_wgrad) and, where the layer's input needs a
    gradient (not the stem), dX (sparse_conv_grouped_dx: the forward
    kernel over the adjoint map, the weights transposed and, for a self
    map, the taps reversed), each
    at fp32 and bf16 against its plain version on the card
    (grouped_bwd_check); at bf16 device times alone (CUDA graph) of each,
    beside the parent tree's backward (autograd through
    sparse_conv_grouped_plain recomputed: what the change replaced; host
    clock round a synchronize), the per-tap route on ungroup_kernel_map
    of the same map (PerTapConv.backward: invert_map_batch, the per-tap
    forward kernel over it, sparse_conv_wgrad), the library route (a
    gather of the 27 tap rows and one torch.mm a direction; timed only)
    and the bound of each direction (grouped_bound's formula for dX,
    grouped_wgrad_bound for dW); dW's time beside the parent tree's
    weight-gradient kernel (parent_dw_kernel_ms: parent_wgrad, which
    rounds dY, so only its time is compared) and the per-tap route's dW
    alone (per_tap_dw_ms: sparse_conv_wgrad on ungroup_kernel_map), the
    windows dW stages over those used (wgrad_staging) and its plan; the
    layer's training forward (the
    forward kernel at these shapes, fwd_kernel_ms, fwd_bound_ms, against
    its plain version at bf16) and the parent tree's kernel forward and
    dX on the same inputs in the same call (parent_grouped)."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_conv, cuda_grouped
    from umeregrobust_tpu_torch.ops.cuda_grouped import (
        sparse_conv_grouped_dx as grouped_dx, sparse_conv_grouped_wgrad)
    from umeregrobust_tpu_torch.ops.sparse import (
        _per_tap, invert_map_batch, sparse_conv_grouped_dx_plain,
        sparse_conv_grouped_plain, sparse_conv_grouped_wgrad_plain,
        ungroup_kernel_map)

    bf = torch.bfloat16
    _, Cin, Cout = w.shape
    N_in, N_out = f.shape[0], gmap.center.shape[1]
    adj, rev = adjoint
    need_dx = name != "conv1"  # the stem's input is the constant feature
    dy = torch.randn(N_out, Cout, generator=g, device=f.device)
    wv = (w.flip(0) if rev else w).transpose(1, 2)
    checks = {}
    for cd in (torch.float32, bf):
        tag = str(cd)[6:]
        checks[f"dw_{tag}"] = grouped_bwd_check(
            lambda: sparse_conv_grouped_wgrad(f, dy, gmap, cd),
            sparse_conv_grouped_wgrad_plain(f, dy, gmap, cd), cd)
        if need_dx:
            checks[f"dx_{tag}"] = grouped_bwd_check(
                lambda: grouped_dx(dy, w, adj, rev, cd),
                sparse_conv_grouped_dx_plain(dy, w, adj, rev, cd, pairs), cd)

    def dw_kernel():
        return sparse_conv_grouped_wgrad(f, dy, gmap, bf)

    def dx_kernel():
        return grouped_dx(dy, w, adj, rev, bf)

    fx = f.clone().requires_grad_(need_dx)
    wx = w.clone().requires_grad_()

    def recompute():  # the parent tree's backward of this layer
        out = sparse_conv_grouped_plain(fx, wx, gmap, None, bf, pairs)
        return torch.autograd.grad(out, [fx, wx] if need_dx else [wx], dy)

    nbr = ungroup_kernel_map(gmap)
    ok_in = (nbr >= 0) & (nbr < N_in)

    def per_tap():  # PerTapConv.backward on the ungrouped map
        dw = cuda_conv.sparse_conv_wgrad(f, dy, nbr, bf)
        if not need_dx:
            return dw
        inv = invert_map_batch(torch.where(ok_in, nbr, -1), N_in)
        return dw, _per_tap(dy, w.transpose(1, 2), inv, bf, pairs)

    dw_ms = graph_ms(dw_kernel, reps=5, inner=10)
    parent_dw_ms = graph_ms(lambda: parent_wgrad(f, dy, gmap), reps=5,
                            inner=10)
    per_tap_dw_ms = graph_ms(lambda: cuda_conv.sparse_conv_wgrad(
        f, dy, nbr, bf), reps=5, inner=5)
    staged, used = wgrad_staging(gmap, Cin)
    dx_ms = graph_ms(dx_kernel, reps=5, inner=10) if need_dx else 0.0
    bw, bw_by = grouped_wgrad_bound(f, dy, gmap)
    bx, bx_by = (grouped_bound(dy, wv, adj)[:2] if need_dx else (0.0, None))
    wplan = cuda_grouped.wgrad_plan(N_out, Cin, Cout, bf)
    # the training forward of this layer (the same kernel, B = 8 shapes)
    # against its plain version, and the parent tree's kernel on the same
    # inputs in this call, forward and dX
    fwd = cuda_grouped.sparse_conv_grouped_kernel(f, w, gmap, None, bf)
    fwd_ref = sparse_conv_grouped_plain(f, w, gmap, None, bf, pairs)
    fwd_err = float((fwd - fwd_ref).abs().max())
    fwd_scale = float(fwd_ref.abs().max())
    del fwd, fwd_ref
    fwd_ms = graph_ms(lambda: cuda_grouped.sparse_conv_grouped_kernel(
        f, w, gmap, None, bf), reps=5, inner=10)
    parent_fwd_ms = graph_ms(lambda: parent_grouped(f, w, gmap), reps=5,
                             inner=10)
    parent_dx_ms = (graph_ms(lambda: parent_grouped(dy, w, adj,
                                                    2 if rev else 1),
                             reps=5, inner=10) if need_dx else 0.0)
    checks["fwd_bfloat16"] = dict(
        max_abs_err=fwd_err, scale=fwd_scale,
        max_err_over_limit=fwd_err / max(GROUPED_LIMITS["bfloat16"]
                                         * fwd_scale, 1e-30),
        two_launches_identical=True, guards_intact=True,
        ok=fwd_err <= GROUPED_LIMITS["bfloat16"] * fwd_scale)
    row = dict(
        layer=name, cin=Cin, cout=Cout, rows_in=N_in, rows_out=N_out,
        windows_used=int((gmap.masks.any(1) | gmap.patho).sum()),
        dx=need_dx, reverse_taps=rev,
        wgrad_plan=wplan._asdict(),
        dw_plan=dict(cluster=1, tile=f"{64 * wplan.warpgroups} channels x "
                     f"{64 * wplan.atoms} window columns",
                     runs=wplan.ranges, col_blocks=wplan.col_blocks,
                     cout_blocks=wplan.cout_blocks, stages=wplan.stages),
        dw_windows_staged=staged,
        dw_staged_over_used=staged / max(used, 1),
        checks=checks,
        max_abs_err=checks["dw_bfloat16"]["max_abs_err"],
        max_err_over_limit=max(c["max_err_over_limit"]
                               for c in checks.values()),
        two_launches_identical=all(c["two_launches_identical"]
                                   for c in checks.values()),
        guards_intact=all(c["guards_intact"] for c in checks.values()),
        ok=all(c["ok"] for c in checks.values()),
        dw_ms=time_ms(dw_kernel, reps=10), dw_kernel_ms=dw_ms,
        parent_dw_kernel_ms=parent_dw_ms, per_tap_dw_ms=per_tap_dw_ms,
        dx_kernel_ms=dx_ms, kernel_ms=dw_ms + dx_ms,
        parent_dx_kernel_ms=parent_dx_ms, fwd_kernel_ms=fwd_ms,
        fwd_parent_kernel_ms=parent_fwd_ms,
        fwd_bound_ms=grouped_bound(f, w, gmap)[0],
        dw_plain_ms=time_ms(lambda: sparse_conv_grouped_wgrad_plain(
            f, dy, gmap, bf), reps=3, warmup=1),
        recompute_ms=time_ms(recompute, reps=3, warmup=1),
        per_tap_ms=graph_ms(per_tap, reps=5, inner=5),
        dw_bound_ms=bw, dw_bound_by=bw_by, dx_bound_ms=bx, dx_bound_by=bx_by,
        bound_ms=bw + bx, bound_by=bw_by if bw >= bx else bx_by)
    # the library route: X's (dY's, over the adjoint) 27 tap rows gathered
    # into one bf16 tensor, then one torch.mm a direction
    fb = torch.nn.functional.pad(f.to(bf), (0, 0, 0, 1))
    yb = torch.nn.functional.pad(dy.to(bf), (0, 0, 0, 1))
    idx = torch.where(ok_in, nbr, N_in).T.contiguous()  # (N_out, 27)
    nadj = ungroup_kernel_map(adj)
    idx_a = torch.where((nadj >= 0) & (nadj < N_out), nadj,
                        N_out).T.contiguous()  # (N_in, 27)
    wt = wv.reshape(27 * Cout, Cin).to(bf)

    def library_dw():
        return torch.mm(fb[idx].reshape(N_out, 27 * Cin).T, yb[:N_out])

    def library_dx():
        return torch.mm(yb[idx_a].reshape(N_in, 27 * Cout), wt)

    if max(N_out * 27 * Cin, N_in * 27 * Cout) * 2 > IM2COL_LIMIT:
        row.update(library_dw_ms=None, library_dx_ms=None, library_ms=None)
    else:
        lw = graph_ms(library_dw, reps=5, inner=5)
        lx = graph_ms(library_dx, reps=5, inner=5) if need_dx else 0.0
        row.update(library_dw_ms=lw, library_dx_ms=lx, library_ms=lw + lx)
    return row


def grouped_bwd_layers(dev, batch, weights):
    """Every grouped k3 conv of a ResUNetSmall2 training forward (the
    in-repo weights) at train_kitti_config (B = 8), captured with the
    adjoint the model hands its backward: one grouped_bwd_row each."""
    import torch

    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, _capacities, batch_to_device, cloud_features)

    model = load_model(weights, ARCHS["ResUNetSmall2"], device=dev)
    bt = batch_to_device(batch, dev)
    with PyramidMaps() as pyr:
        layers = capture_grouped_layers(model, lambda: cloud_features(
            model, bt, _capacities(TrainConfig(), model.arch),
            torch.bfloat16, train=True))
    g = torch.Generator(device=dev).manual_seed(15)
    rows = []
    for name, f, w, gmap, pairs, _, adjoint in layers:
        rows.append(grouped_bwd_row(name, f, w, gmap, adjoint, pairs, g))
        emit({"phase": "grouped_bwd_layer", "model": "ResUNetSmall2",
              "B": TRAIN_B, **rows[-1]})
    return rows, pyr.lists[0]


def grouped_wgrad_forced_cases(dev):
    """The grouped backward's kernels on forced maps (forced_grouped_map,
    passed without their row order: the wrapper makes it):
    Cin 1 / 2 / 3 / 20 / 768 (1 and 2: the packed stem, with its one bulk
    copy of dY where Cout % 4 == 0 and one channel block, else its
    cp.async pieces; 768: 18 column blocks), Cout 5 / 7 / 48 / 200 / 256,
    N_out above and below N_in, more splits than one, a group no window
    uses and a stretch of rows that use none, a group whose one user sits
    in the last tile of the order, tiles whose rows mix masks (mixed_tiles:
    their share), many patho rows, both slot orders, int32 and int64
    centres, and an all-masked level (dW and dX exact zeros):
    sparse_conv_grouped_wgrad and the dX route (sparse_conv_grouped_dx,
    taps reversed in every other case) against their plain versions at
    fp32 and bf16 (grouped_bwd_check); and the weight gradient of the
    map given its row order (with_row_order) against the bare map's: the
    same bits."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_grouped
    from umeregrobust_tpu_torch.ops.cuda_grouped import (
        sparse_conv_grouped_dx as grouped_dx, sparse_conv_grouped_wgrad)
    from umeregrobust_tpu_torch.ops.sparse import (
        sparse_conv_grouped_dx_plain, sparse_conv_grouped_wgrad_plain)

    rng = np.random.default_rng(23)

    def unused(center, masks, pat):  # group 4 unused, rows 1000-8999 too
        masks[4], pat[4] = False, False
        masks[:, :, 1000:9000], pat[:, 1000:9000] = False, False

    def last_user(center, masks, pat):  # row 777 alone uses group 8, and
        # nothing else: its mask (256) sorts it into the order's last tile
        masks[8], pat[8] = False, False
        masks[:, :, 777], pat[:, 777] = False, False
        masks[8, 1, 777] = True

    i32, i64 = torch.int32, torch.int64
    cases = {  # n_in, n_out, cin, cout, centres, map options
        "cin1_cout48_nout_gt_nin": (3000, 9000, 1, 48, i64, {}),
        "cin3_cout7_nout_lt_nin": (5000, 2000, 3, 7, i32, {}),
        "cin20_cout5_transposed": (4000, 4000, 20, 5, i64,
                                   dict(transposed=True)),
        "cin768_cout256": (400, 300, 768, 256, i32, dict(p=0.2)),
        "cin2_cout5_stem": (2000, 3000, 2, 5, i32, {}),
        "cin2_cout200_stem": (2000, 3000, 2, 200, i64, {}),
        "last_tile_user": (3000, 3000, 32, 48, i64, dict(edit=last_user)),
        "mixed_tiles": (3000, 6000, 64, 64, i32, dict(p=0.12, patho=0.1)),
        "unused_group_and_rows": (2000, 20000, 32, 48, i64,
                                  dict(edit=unused)),
        "patho_rows": (1500, 1500, 24, 32, i64, dict(p=0.3, patho=0.6)),
        "all_masked": (800, 900, 16, 32, i32, dict(p=0.0, patho=0.0)),
        "many_splits": (30000, 70000, 8, 16, i64, dict(transposed=True)),
    }
    res, ok_all = {}, True
    for j, (label, (n_in, n_out, cin, cout, idx, opt)) in enumerate(
            cases.items()):
        gmap = forced_grouped_map(rng, dev, n_in, n_out, idx, **opt)
        f = torch.as_tensor(rng.standard_normal((n_in, cin)),
                            dtype=torch.float32, device=dev)
        dy = torch.as_tensor(rng.standard_normal((n_out, cout)),
                             dtype=torch.float32, device=dev)
        w = torch.as_tensor(rng.standard_normal((27, cin, cout))
                            / np.sqrt(27 * cin), dtype=torch.float32,
                            device=dev)
        rev = j % 2 == 1
        # the dX route's input: n_in rows of Cout, through the same map
        x = torch.as_tensor(rng.standard_normal((n_in, cout)),
                            dtype=torch.float32, device=dev)
        r = {}
        for cd in (torch.float32, torch.bfloat16):
            tag = str(cd)[6:]
            r[f"dw_{tag}"] = grouped_bwd_check(
                lambda: sparse_conv_grouped_wgrad(f, dy, gmap, cd),
                sparse_conv_grouped_wgrad_plain(f, dy, gmap, cd), cd)
            r[f"dx_{tag}"] = grouped_bwd_check(
                lambda: grouped_dx(x, w, gmap, rev, cd),
                sparse_conv_grouped_dx_plain(x, w, gmap, rev, cd), cd)
        if label == "last_tile_user":  # group 8: the last tile only
            order, tiles = cuda_grouped.grouped_row_order(gmap)
            r["group8_tiles"] = [int(t) for t in torch.nonzero(
                (tiles & 256) != 0).reshape(-1)]
            r["last_tile"] = int(tiles.numel()) - 1
            r["dw_bfloat16"]["ok"] &= r["group8_tiles"] == [r["last_tile"]]
        if label == "mixed_tiles":  # the share of tiles of mixed masks
            order, _ = cuda_grouped.grouped_row_order(gmap)
            key = cuda_grouped.row_keys_plain(gmap)[order.long()]
            n_t = -(-key.numel() // 64)
            kt = torch.nn.functional.pad(key, (0, n_t * 64 - key.numel()),
                                         value=-1).reshape(n_t, 64)
            mixed = [len(set(v for v in row.tolist() if v >= 0)) > 1
                     for row in kt]
            r["mixed_tiles"] = sum(mixed) / n_t
            r["dw_bfloat16"]["ok"] &= r["mixed_tiles"] > 0.5
        # the map with its row order gives the bare map's bits
        given = cuda_grouped.with_row_order(gmap)
        same = all(torch.equal(sparse_conv_grouped_wgrad(f, dy, gmap, cd),
                               sparse_conv_grouped_wgrad(f, dy, given, cd))
                   for cd in (torch.float32, torch.bfloat16))
        r["order_given_same_bits"] = same
        r["dw_bfloat16"]["ok"] &= same
        if label == "all_masked":  # nothing is read: exact zeros
            for cd in (torch.float32, torch.bfloat16):
                dw = sparse_conv_grouped_wgrad(f, dy, gmap, cd)
                dx = grouped_dx(x, w, gmap, False, cd)
                r[f"dw_{str(cd)[6:]}"]["ok"] &= not bool(dw.any()
                                                         or dx.any())
        ok = all(v["ok"] for v in r.values() if isinstance(v, dict))
        ok_all &= ok
        res[label] = dict(
            shape=f"{cin}->{cout}, {n_in}->{n_out} rows, "
                  f"{str(idx)[6:]} centres, reverse_taps {rev}",
            ok=ok, **r)
    return res, ok_all


def train_steps(trainer, batch, steps):
    """One warm-up step, then `steps` counted ones (launch counts set to 0
    just before them): per step ms (host clock round a synchronize),
    losses and metrics; peak device memory; launches a step; the grouped
    convs' window gathers a step (calls of ops/sparse.py's gather_padded,
    which only the grouped conv's plain version makes)."""
    import torch

    from umeregrobust_tpu_torch.ops import sparse
    from umeregrobust_tpu_torch.train.trainer import batch_to_device

    bt = batch_to_device(batch, trainer.device)
    warm = trainer.train_step(bt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    orig, windows = sparse.gather_padded, []

    def counted(*a, **kw):
        windows.append(1)
        return orig(*a, **kw)

    reset_launch_counts()
    rows = []
    sparse.gather_padded = counted
    try:
        for _ in range(steps):
            t0 = time.time()
            m = trainer.train_step(bt)
            torch.cuda.synchronize()
            rows.append(dict(ms=(time.time() - t0) * 1e3, **m))
    finally:
        sparse.gather_padded = orig
    lc = launch_counts()
    return dict(warmup=warm, steps=rows,
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                launches=lc, launches_per_step={k: v / steps
                                                for k, v in lc.items()},
                window_gathers_per_step=len(windows) / steps)


def train_ab(trainer, batch, steps=2):
    """ResUNetSmall2 training with the grouped backward's kernels (the
    change) against the parent tree's form (ParentRecomputeGroupedConv:
    the forward kernel, a backward that recomputes the plain version),
    alternated parent, change, change, parent: per turn train_steps (a
    warm-up step, then `steps`: ms a step, peak device memory, launches
    and window gathers a step, the losses), then one step under
    torch.profiler (profile_step: kernels a step, aten::mm calls, device
    busy ms) in the first turn of each form. The trainer's weights move
    on with every step, so each turn's losses are of its own steps."""
    import contextlib

    rows = []
    for i, kind in enumerate(("parent", "change", "change", "parent")):
        with (ParentRecomputeGroupedConv() if kind == "parent"
              else contextlib.nullcontext()):
            r = train_steps(trainer, batch, steps)
            prof = profile_step(trainer, batch) if i < 2 else {}
        rows.append(dict(form=kind, ms=[st["ms"] for st in r["steps"]],
                         total_loss=[st["total_loss"] for st in r["steps"]],
                         max_memory_allocated_bytes=r[
                             "max_memory_allocated_bytes"],
                         launches_per_step=r["launches_per_step"],
                         window_gathers_per_step=r["window_gathers_per_step"],
                         **{k: prof[k] for k in (
                             "wall_ms", "device_busy_ms", "kernels",
                             "mm_calls", "device_idle_share") if k in prof}))
    return rows


def profile_step(trainer, batch, top=8):
    """One train step under torch.profiler: its wall ms (host clock round
    a synchronize), the device's busy ms (the sum of its kernels'
    times), the CUDA kernels launched, the aten::mm calls, and the `top`
    ops by self device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from umeregrobust_tpu_torch.train.trainer import batch_to_device

    bt = batch_to_device(batch, trainer.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.train_step(bt)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(k.time_range.elapsed_us() for k in ks) / 1e3
    avgs = prof.key_averages()
    ops = sorted(avgs, key=lambda a: -a.self_device_time_total)
    return dict(wall_ms=wall, device_busy_ms=busy, kernels=len(ks),
                mm_calls=sum(a.count for a in avgs if a.key == "aten::mm"),
                device_idle_share=max(0.0, 1.0 - busy / wall),
                top_device_ops=[dict(op=a.key[:80], count=a.count,
                                     device_ms=a.self_device_time_total / 1e3)
                                for a in ops[:top]])


def card_vs_cpu(dev, batch, weights):
    """One pair at train_kitti_config's widths, fp32 (the in-repo weights):
    the step's loss, metrics and gradients on the card and on the CPU
    (plain versions); each loss within 1e-3 relative, and every leaf's
    gradient elementwise within GRAD_LEAF_TOL x that leaf's max |grad|
    on the CPU."""
    import torch

    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.ops.precision import tf32_off
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, _capacities, batch_losses, batch_to_device)

    cfg = TrainConfig(compute_dtype="float32", batch_size=1)
    one = {k: v[:1] for k, v in batch.items()}
    res, grads = {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = load_model(weights, ARCHS["ResUNetSmall2"], device=d)
        t0 = time.time()
        with tf32_off():
            loss, m, _ = batch_losses(model, batch_to_device(one, d), cfg,
                                      _capacities(cfg, model.arch), True)
            loss.backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
        res[name] = dict(seconds=time.time() - t0,
                         metrics={k: float(v) for k, v in m.items()},
                         grad_norms={k: float(p.grad.norm()) for k, p in
                                     model.named_parameters()})
        grads[name] = {k: p.grad.detach().cpu() for k, p in
                       model.named_parameters()}
    a, b = res["card"], res["cpu"]
    loss_err = {k: abs(a["metrics"][k] - v) / max(abs(v), 1e-30)
                for k, v in b["metrics"].items()
                if k.endswith("_loss")}
    leaf_err = {}
    for k, gc in grads["cpu"].items():
        scale = float(gc.abs().max())
        e = float((grads["card"][k] - gc).abs().max())
        leaf_err[k] = e / scale if scale > 0 else (0.0 if e == 0 else 1.0)
    worst = sorted(leaf_err, key=leaf_err.get, reverse=True)
    return dict(card=a, cpu=b, loss_rel_err=loss_err,
                grad_leaf_rel_err_max=leaf_err[worst[0]],
                grad_leaf_rel_err_worst={k: leaf_err[k] for k in worst[:5]},
                grad_leaves=len(leaf_err), grad_leaf_tol=GRAD_LEAF_TOL,
                ok=max(loss_err.values()) <= 1e-3
                and leaf_err[worst[0]] <= GRAD_LEAF_TOL)


def write_train_tree(root, n_train, n_val):
    """KITTI-layout scans (HDL-64 density, phase 5h's scenes) of the first
    pairs of kitti/train and kitti/val."""
    from umeregrobust_tpu_torch.data.registry import load_registry
    from umeregrobust_tpu_torch.data.synthetic import SceneConfig, make_pair

    for split, n, seed0 in (("train", n_train, 700), ("val", n_val, 800)):
        reg = load_registry("kitti", split, skip_invalid_entries=False)
        for i in range(n):
            seq, f0, f1 = (int(x) for x in reg.pairs[i])
            gt = reg.gt_tforms[i]
            pair = make_pair(SceneConfig(seed=seed0 + i, **HDL64),
                             seed=seed0 + i)
            R, t = pair["gt_tform"][:3, :3], pair["gt_tform"][:3, 3]
            tgt = ((pair["tgt_pts"] - t) @ R) @ gt[:3, :3].T + gt[:3, 3]
            d = os.path.join(root, "sequences", f"{seq:02d}")
            for sub in ("velodyne", "labels"):
                os.makedirs(os.path.join(d, sub), exist_ok=True)
            for fid, pts, seg in [(f0, pair["src_pts"], pair["src_seg"]),
                                  (f1, tgt, pair["tgt_seg"])]:
                pts = np.asarray(pts, np.float32)
                np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1
                               ).tofile(os.path.join(d, "velodyne",
                                                     f"{fid:06d}.bin"))
                np.where(seg == 9, 40, np.where(seg == 0, 0, 10)).astype(
                    np.uint32).tofile(os.path.join(d, "labels",
                                                   f"{fid:06d}.label"))
    return os.path.join(root, "sequences")


def phase_train(dev, t_start):
    """Phase 5j: (a) the backward kernels' checks and times (the grouped
    conv's: grouped_bwd_layers, grouped_wgrad_forced_cases); (b)
    ResUNetSmall2 (the in-repo weights) at train_kitti_config's widths:
    B = 8, 16384 voxels a cloud, 512 matches, 256 UME keypoints, max_nn
    750, min_nn 300, r 5, bf16 operands, TRAIN_STEPS steps on HDL-64
    density pairs, and one pair card vs CPU at fp32; (c) ResUNet (seeded
    random parameters, published widths, k7 stem, k5 layers) at B = 2,
    TRAIN_STEPS steps; (d) the train CLI on a KITTI-layout tree (2 train
    and 2 val pairs, batch 2, 1 epoch), its checkpoint loaded by the
    evaluate CLI. Returns (summary, kernel rows, launch counts by path)."""
    import contextlib
    import tempfile

    import torch

    from umeregrobust_tpu_torch.models.resunet import ARCHS, init_resunet
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, Trainer, _capacities, cloud_features, batch_to_device)

    weights = os.path.join(ROOT, "weights", "synthetic_pretrain.pkl")
    out, paths, kern = {}, {}, {}
    t0 = time.time()
    batch = train_batch(TRAIN_B, 900)
    out["batch"] = dict(seconds=time.time() - t0, pairs=TRAIN_B,
                        valid_voxels=batch["src_mask"].sum(1).tolist(),
                        matches=batch["match_mask"].sum(1).tolist())
    emit({"phase": "train_batch", **out["batch"],
          "seconds_total": time.time() - t_start})

    # (a) the backward kernels
    windows = window_gathers(dev, batch, weights)
    kern["gather_rows_backward"] = gather_backward_row(dev, batch, windows)
    out["windows"] = {k: ({kk: vv for kk, vv in v.items() if kk != "idx"}
                          if isinstance(v, dict) else v)
                      for k, v in windows.items()}
    out["stress"] = backward_stress(dev, batch, windows)
    del windows
    emit({"phase": "backward_stress", **out["stress"],
          "seconds_total": time.time() - t_start})
    kern["gather_rows_backward"].update(
        windows=out["windows"],
        ok=kern["gather_rows_backward"]["ok"] and out["windows"]["ok"]
        and out["stress"]["ok"])
    emit({"phase": "train_kernel", "kernel": "gather_rows_backward",
          **kern["gather_rows_backward"]})
    forced = wgrad_forced_cases(dev)
    emit({"phase": "wgrad_forced", "cases": forced})
    cfg_r = TrainConfig(arch="ResUNet", batch_size=2,
                        level_capacity_ratios=RESUNET_TRAIN_RATIOS)
    res_model = init_resunet(ARCHS["ResUNet"], 1, 32, device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(0))
    two = {k: v[:2] for k, v in batch.items()}
    layers = capture_conv_layers(res_model, lambda: cloud_features(
        res_model, batch_to_device(two, dev), _capacities(cfg_r, res_model.arch),
        torch.bfloat16, train=False))
    g = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for name, f, w, nbr, pairs in layers:
        rows.append(wgrad_layer_row(name, f, w, nbr, pairs, g))
        emit({"phase": "wgrad_layer", "model": "ResUNet", **rows[-1]})
    del layers
    kern["sparse_conv_wgrad"] = dict(
        shape="ResUNet's 11 conv layers at B = 2 (train pyramid, bf16): "
              + "; ".join(f"{r['layer']} K{r['K']} {r['cin']}->{r['cout']}"
                          f" {r['valid']} entries" for r in rows),
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["kernel_ms"] for r in rows),
        kernel_ms=sum(r["kernel_ms"] for r in rows),
        old_kernel_ms=sum(r["old_kernel_ms"] for r in rows),
        layers_no_slower_than_old=sum(r["kernel_ms"] <= r["old_kernel_ms"]
                                      for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows),
        library_ms=sum(r["library_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows),
        bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
        forced=forced,
        ok=all(r["ok"] for r in rows) and all(c["ok"] for c in forced)
        and out["stress"]["ok"])

    # the grouped k3 conv's backward: dW's kernel, dX through the forward
    # kernel over the adjoint map, at the 18 layers' B = 8 training shapes
    t0 = time.time()
    g_rows, train_maps = grouped_bwd_layers(dev, batch, weights)
    out["row_order"] = grouped_order_row(f"train_B{TRAIN_B}", train_maps)
    emit({"phase": "grouped_row_order", "model": "ResUNetSmall2",
          **out["row_order"]})
    del train_maps
    g_forced, g_forced_ok = grouped_wgrad_forced_cases(dev)
    g_seconds = time.time() - t0
    emit({"phase": "grouped_wgrad_forced", "ok": g_forced_ok, **g_forced})
    dx_rows = [r for r in g_rows if r["dx"]]
    lib = [r["library_ms"] for r in g_rows]
    out["grouped_bwd"] = dict(
        layers=len(g_rows), dx_layers=len(dx_rows),
        dx_kernel_ms=sum(r["dx_kernel_ms"] for r in dx_rows),
        parent_dx_kernel_ms=sum(r["parent_dx_kernel_ms"] for r in dx_rows),
        dx_bound_ms=sum(r["dx_bound_ms"] for r in dx_rows),
        fwd_kernel_ms=sum(r["fwd_kernel_ms"] for r in g_rows),
        fwd_parent_kernel_ms=sum(r["fwd_parent_kernel_ms"] for r in g_rows),
        fwd_bound_ms=sum(r["fwd_bound_ms"] for r in g_rows),
        fwd_max_err_over_limit=max(r["checks"]["fwd_bfloat16"][
            "max_err_over_limit"] for r in g_rows),
        dx_max_abs_err=max(r["checks"]["dx_bfloat16"]["max_abs_err"]
                           for r in dx_rows),
        kernel_ms=sum(r["kernel_ms"] for r in g_rows),
        dw_kernel_ms=sum(r["dw_kernel_ms"] for r in g_rows),
        parent_dw_kernel_ms=sum(r["parent_dw_kernel_ms"] for r in g_rows),
        per_tap_dw_ms=sum(r["per_tap_dw_ms"] for r in g_rows),
        library_dw_ms=(None if None in lib else
                       sum(r["library_dw_ms"] for r in g_rows)),
        dw_bound_ms=sum(r["dw_bound_ms"] for r in g_rows),
        dw_layers_faster_than_parent=sum(
            r["dw_kernel_ms"] < r["parent_dw_kernel_ms"] for r in g_rows),
        dw_layers_slower_than_per_tap=[
            r["layer"] for r in g_rows
            if r["dw_kernel_ms"] > r["per_tap_dw_ms"]],
        dw_layers_slower_than_library=[
            r["layer"] for r in g_rows if r["library_dw_ms"] is not None
            and r["dw_kernel_ms"] > r["library_dw_ms"]],
        dw_staged_over_used=sum(r["dw_windows_staged"] for r in g_rows)
        / max(sum(r["windows_used"] for r in g_rows), 1),
        recompute_ms=sum(r["recompute_ms"] for r in g_rows),
        per_tap_ms=sum(r["per_tap_ms"] for r in g_rows),
        library_ms=None if None in lib else sum(lib),
        bound_ms=sum(r["bound_ms"] for r in g_rows),
        max_err_over_limit=max(r["max_err_over_limit"] for r in g_rows),
        forced_ok=g_forced_ok, seconds=g_seconds,
        ok=len(g_rows) == 18 and len(dx_rows) == 17
        and all(r["ok"] for r in g_rows) and g_forced_ok)
    emit({"phase": "grouped_bwd_summary", "model": "ResUNetSmall2",
          "B": TRAIN_B, **out["grouped_bwd"],
          "seconds_total": time.time() - t_start})
    kern["sparse_conv_grouped_wgrad"] = dict(
        shape=f"ResUNetSmall2's 18 grouped k3 layers at train_kitti_config "
              f"(B = {TRAIN_B}, bf16): " + "; ".join(
                  f"{r['layer']} {r['cin']}->{r['cout']}, {r['rows_in']}->"
                  f"{r['rows_out']} rows, {r['windows_used']} windows"
                  for r in g_rows),
        max_abs_err=max(r["max_abs_err"] for r in g_rows),
        max_rel_err=max(r["checks"]["dw_bfloat16"]["max_abs_err"]
                        / max(r["checks"]["dw_bfloat16"]["scale"], 1e-30)
                        for r in g_rows),
        max_err_over_limit=max(r["max_err_over_limit"] for r in g_rows),
        ms=sum(r["dw_ms"] for r in g_rows),
        kernel_ms=sum(r["dw_kernel_ms"] for r in g_rows),
        plain_ms=sum(r["dw_plain_ms"] for r in g_rows),
        bound_ms=sum(r["dw_bound_ms"] for r in g_rows),
        bound_by=max(g_rows, key=lambda r: r["dw_bound_ms"])["dw_bound_by"],
        library_ms=(None if None in lib else
                    sum(r["library_dw_ms"] for r in g_rows)),
        parent_kernel_ms=out["grouped_bwd"]["parent_dw_kernel_ms"],
        per_tap_dw_ms=out["grouped_bwd"]["per_tap_dw_ms"],
        backward_kernel_ms=out["grouped_bwd"]["kernel_ms"],
        recompute_ms=out["grouped_bwd"]["recompute_ms"],
        per_tap_ms=out["grouped_bwd"]["per_tap_ms"],
        forced=g_forced, ok=out["grouped_bwd"]["ok"])

    # (b) ResUNetSmall2 at full width
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        cfg = TrainConfig()
        tr = Trainer(cfg, os.path.join(work, "small2"), device=dev,
                     model=load_model(weights, ARCHS["ResUNetSmall2"],
                                      device=dev))
        out["small2"] = train_steps(tr, batch, TRAIN_STEPS)
        paths["train_small2"] = out["small2"]["launches"]
        out["small2"]["profile"] = profile_step(tr, batch)
        out["small2_ab"] = train_ab(tr, batch)
        del tr
        emit({"phase": "train_small2", "B": TRAIN_B, **out["small2"],
              "seconds_total": time.time() - t_start})
        emit({"phase": "train_grouped_ab", "B": TRAIN_B,
              "turns": out["small2_ab"],
              "seconds_total": time.time() - t_start})
        out["card_vs_cpu"] = card_vs_cpu(dev, batch, weights)
        emit({"phase": "train_card_vs_cpu", **out["card_vs_cpu"],
              "seconds_total": time.time() - t_start})

        # (c) ResUNet at B = 2
        tr = Trainer(cfg_r, os.path.join(work, "resunet"), device=dev,
                     model=res_model)
        out["resunet"] = train_steps(tr, two, TRAIN_STEPS)
        paths["train_resunet"] = out["resunet"]["launches"]
        out["resunet"]["profile"] = profile_step(tr, two)
        del tr, res_model
        emit({"phase": "train_resunet", "B": 2, **out["resunet"],
              "seconds_total": time.time() - t_start})

        # (d) the train CLI, then its checkpoint in the evaluate CLI
        from umeregrobust_tpu_torch.cli import evaluate as ev
        from umeregrobust_tpu_torch.cli import train_coloring

        t0 = time.time()
        tree = write_train_tree(os.path.join(work, "kitti"), 2, 2)
        sets = [f"data_path={tree}", "cache_data_path=", "batch_size=2",
                "num_epochs=1", "train_size=2", "val_size=2",
                f"output_path={os.path.join(work, 'runs')}"]
        reset_launch_counts()
        with contextlib.redirect_stdout(sys.stderr):
            trainer = train_coloring.main(
                [a for s in sets for a in ("--set", s)])
        paths["train_cli"] = launch_counts()
        ckpt = os.path.join(trainer.out_dir, "last_epoch_checkpoint.pkl")
        cli = dict(seconds=time.time() - t0, epoch=trainer.epoch,
                   checkpoint=os.path.isfile(ckpt),
                   checkpoints=sorted(os.listdir(trainer.out_dir)),
                   launches=paths["train_cli"])
        with contextlib.redirect_stdout(sys.stderr):
            r = ev.main(["--synthetic", "1", "--set",
                         f"model_checkpoint_path={ckpt}"])
        cli.update(evaluate_n_pairs=r["n_pairs"],
                   evaluate_finite=all(p["finite"] for p in r["per_pair"]))
        cli["ok"] = (cli["checkpoint"] and trainer.epoch == 1
                     and cli["evaluate_finite"] and r["n_pairs"] == 1)
        out["cli"] = cli
        emit({"phase": "train_cli", **cli,
              "seconds_total": time.time() - t_start})
    return out, kern, paths


# ---------------------------------------------------------------------------
# phase 5l: the synthetic pretraining CLI (cli/train_synthetic.py, the port
# of tools/train_synthetic.py) from scratch at the tool's full width
SYNTH_ARGV = ["--batch", "4", "--pc-cap", "8192"]
SYNTH_SCENES = 8  # two batches
SYNTH_STEPS = 10
SYNTH_RESUME_STEPS = 2
# the tool's training UMEs: 128 keypoints, 512 neighbours at most, 64 at
# least, r 5 m (cli/train_synthetic.train_config)
SYNTH_UME = dict(num_samples=128, max_nn=512, min_nn=64, r=5.0)


def synth_grouped_layers(dev, model, batch, caps):
    """Every grouped k3 layer of one training forward of the tool's step
    (`batch` on the card, the tool's capacities): the forward kernel, dX
    (the forward kernel over the adjoint map; not the stem) and dW (a
    seeded dY), each at bf16 against its plain version on the card (the
    forward within GROUPED_LIMITS; dX and dW by grouped_bwd_check), with
    each one's device time alone (CUDA graph); the pyramid's grouped maps
    for the row order."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_grouped
    from umeregrobust_tpu_torch.ops.cuda_grouped import (
        sparse_conv_grouped_dx as grouped_dx, sparse_conv_grouped_wgrad)
    from umeregrobust_tpu_torch.ops.sparse import (
        sparse_conv_grouped_dx_plain, sparse_conv_grouped_plain,
        sparse_conv_grouped_wgrad_plain)
    from umeregrobust_tpu_torch.train.trainer import cloud_features

    bf = torch.bfloat16
    with PyramidMaps() as pyr:
        layers = capture_grouped_layers(model, lambda: cloud_features(
            model, batch, caps, bf, train=True))
    g = torch.Generator(device=dev).manual_seed(21)
    rows = []
    for name, f, w, gmap, pairs, _, (adj, rev) in layers:
        dy = torch.randn(gmap.center.shape[1], w.shape[2], generator=g,
                         device=dev)
        fwd = cuda_grouped.sparse_conv_grouped_kernel(f, w, gmap, None, bf)
        ref = sparse_conv_grouped_plain(f, w, gmap, None, bf, pairs)
        err, scale = float((fwd - ref).abs().max()), float(ref.abs().max())
        del fwd, ref
        checks = {"fwd": dict(
            max_abs_err=err, scale=scale,
            max_err_over_limit=err / max(GROUPED_LIMITS["bfloat16"] * scale,
                                         1e-30),
            ok=err <= GROUPED_LIMITS["bfloat16"] * scale)}
        checks["dw"] = grouped_bwd_check(
            lambda: sparse_conv_grouped_wgrad(f, dy, gmap, bf),
            sparse_conv_grouped_wgrad_plain(f, dy, gmap, bf), bf)
        need_dx = name != "conv1"  # the stem's input is the constant one
        if need_dx:
            checks["dx"] = grouped_bwd_check(
                lambda: grouped_dx(dy, w, adj, rev, bf),
                sparse_conv_grouped_dx_plain(dy, w, adj, rev, bf, pairs), bf)
        rows.append(dict(
            layer=name, cin=w.shape[1], cout=w.shape[2], rows_in=f.shape[0],
            rows_out=gmap.center.shape[1], dx=need_dx, checks=checks,
            ok=all(c["ok"] for c in checks.values()),
            fwd_kernel_ms=graph_ms(
                lambda: cuda_grouped.sparse_conv_grouped_kernel(
                    f, w, gmap, None, bf), reps=3, inner=5),
            dw_kernel_ms=graph_ms(
                lambda: sparse_conv_grouped_wgrad(f, dy, gmap, bf), reps=3,
                inner=5),
            dx_kernel_ms=(graph_ms(lambda: grouped_dx(dy, w, adj, rev, bf),
                                   reps=3, inner=5) if need_dx else 0.0)))
    return rows, pyr.lists[0]


def synth_gathers(dev, batch, n_pairs):
    """gather_rows and gather_rows_backward at the tool's training UME
    gathers (n_pairs pairs x 2 sides x 128 keypoints x 512 rows of an
    (n_pairs x 8192, 32) fp32 table, ume_gather_indices): each against
    its plain version on the CPU bit for bit, two launches identical, the
    device's time alone (CUDA graph) and the bound (forward: each table
    row some index names read once, every output row written, the
    indices; backward: gather_backward_shape's bytes)."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_gather

    idx, N = ume_gather_indices(batch, dev, **SYNTH_UME)
    M, C = idx.shape[0], 32
    g = torch.Generator(device="cpu").manual_seed(23)
    table, d = torch.randn(N, C, generator=g), torch.randn(M, C, generator=g)
    tc, dc = table.to(dev), d.to(dev)
    ic = idx.cpu()
    fwd = [cuda_gather.gather_rows(tc, idx) for _ in range(2)]
    bwd = [cuda_gather.gather_rows_backward(dc, idx, N) for _ in range(2)]
    want_f = cuda_gather.gather_rows_plain(table, ic)
    want_b = cuda_gather.gather_rows_backward_plain(d, ic, N)
    ok = (ic >= 0) & (ic < N)
    n_valid, rows_read = int(ok.sum()), int(torch.unique(ic[ok]).numel())
    shape = (f"{n_pairs} pairs x 2 sides x {SYNTH_UME['num_samples']} x "
             f"{SYNTH_UME['max_nn']} = {M} rows ({n_valid} valid) of a "
             f"({N}, {C}) fp32 table")
    rows = {}
    for name, got, want, fn, n_bytes in (
            ("gather_rows", fwd, want_f,
             lambda: cuda_gather.gather_rows(tc, idx),
             (rows_read + M) * C * 4 + M * idx.element_size()),
            ("gather_rows_backward", bwd, want_b,
             lambda: cuda_gather.gather_rows_backward(dc, idx, N),
             n_valid * C * 4 + M * idx.element_size() + N * C * 4)):
        bit = bool(torch.equal(got[0].cpu(), want))
        twice = bool(torch.equal(got[0], got[1]))
        rows[name] = dict(
            shape=shape, rows_read=rows_read, bit_equal_cpu_plain=bit,
            two_launches_identical=twice,
            max_abs_err=float((got[0].cpu() - want).abs().max()),
            kernel_ms=graph_ms(fn, reps=5, inner=10),
            bound_ms=bound_ms(n_bytes, n_valid * C if "back" in name
                              else 0)[0], ok=bit and twice)
    return rows


def phase_train_synthetic(dev, t_start, pair, reg_cfg, caps_reg):
    """Phase 5l, the synthetic pretraining CLI in-process:
    (a) from scratch at the tool's full width (SYNTH_ARGV: B = 4, 8192
    voxels a cloud, bf16, the tool's UME settings), SYNTH_SCENES scenes,
    SYNTH_STEPS steps, launch counts set to 0 just before main and read
    just after: every loss finite, non-finite steps, ms a step after the
    first, launches and (one profiled step after the run) kernels a step,
    peak memory; (b) --resume weights/synthetic_pretrain.pkl for
    SYNTH_RESUME_STEPS steps; (c) (a)'s pickle through
    models.weights.load_model, the nominal pair registered (verdict
    printed; not a bar after so few steps); (d) the kernels at the
    tool's shapes (synth_grouped_layers, the row order on the step's
    pyramid, synth_gathers). Returns (summary, launch counts by path)."""
    import contextlib
    import tempfile

    import torch

    from umeregrobust_tpu_torch.cli import train_synthetic
    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.pipeline.e2e import register_pair_e2e
    from umeregrobust_tpu_torch.train.trainer import _capacities

    weights = os.path.join(ROOT, "weights", "synthetic_pretrain.pkl")
    out, paths = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_synth_") as work:
        # (a) from scratch
        path = os.path.join(work, "scratch.pkl")
        t0 = time.time()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with contextlib.redirect_stdout(sys.stderr):
            run = train_synthetic.main(SYNTH_ARGV + [
                "--n-scenes", str(SYNTH_SCENES), "--steps", str(SYNTH_STEPS),
                "--out", path])
        torch.cuda.synchronize()
        paths["train_synthetic"] = launch_counts()
        losses = [m["total_loss"] for m in run.history]
        out["scratch"] = dict(
            argv=SYNTH_ARGV + ["--n-scenes", str(SYNTH_SCENES), "--steps",
                               str(SYNTH_STEPS)],
            seconds=time.time() - t0, batches=len(run.batches),
            valid_voxels=run.batches[0]["src_mask"].sum(1).tolist(),
            matches=run.batches[0]["match_mask"].sum(1).tolist(),
            total_loss=losses,
            metrics_last=run.history[-1],
            nonfinite_steps=sum(m["nonfinite_grad"] for m in run.history),
            first_step_s=run.first_step_s, ms_per_step=run.ms_per_step,
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
            launches=paths["train_synthetic"],
            launches_per_step={k: v / SYNTH_STEPS for k, v in
                               paths["train_synthetic"].items()},
            pickle=os.path.isfile(path),
            profile=profile_step(run.trainer, run.batches[0]))
        out["scratch"]["ok"] = (bool(np.all(np.isfinite(losses)))
                                and out["scratch"]["pickle"])
        emit({"phase": "train_synthetic", "part": "scratch",
              **out["scratch"], "seconds_total": time.time() - t_start})
        tr_cfg = run.trainer.cfg
        model = run.trainer.model
        batch = run.batches[0]
        del run

        # (d) the kernels at the tool's shapes
        t0 = time.time()
        rows, maps = synth_grouped_layers(
            dev, model, batch, _capacities(tr_cfg, model.arch))
        for r in rows:
            emit({"phase": "train_synthetic_grouped_layer", **r})
        order = grouped_order_row("train_synthetic_B4", maps)
        del maps, model
        gathers = synth_gathers(dev, batch, tr_cfg.batch_size)
        dx_rows = [r for r in rows if r["dx"]]
        out["kernels"] = dict(
            grouped=dict(
                layers=len(rows), dx_layers=len(dx_rows),
                fwd_kernel_ms=sum(r["fwd_kernel_ms"] for r in rows),
                dx_kernel_ms=sum(r["dx_kernel_ms"] for r in rows),
                dw_kernel_ms=sum(r["dw_kernel_ms"] for r in rows),
                fwd_max_err_over_limit=max(r["checks"]["fwd"][
                    "max_err_over_limit"] for r in rows),
                dx_max_err_over_limit=max(r["checks"]["dx"][
                    "max_err_over_limit"] for r in dx_rows),
                dw_max_err_over_limit=max(r["checks"]["dw"][
                    "max_err_over_limit"] for r in rows),
                rows=[(r["rows_in"], r["rows_out"]) for r in rows],
                ok=len(rows) == 18 and len(dx_rows) == 17
                and all(r["ok"] for r in rows)),
            row_order=order, **gathers, seconds=time.time() - t0)
        out["kernels"]["ok"] = all(v["ok"] for v in (
            out["kernels"]["grouped"], order, *gathers.values()))
        emit({"phase": "train_synthetic", "part": "kernels",
              **out["kernels"], "seconds_total": time.time() - t_start})

        # (b) --resume from the in-repo weights
        t0 = time.time()
        path_b = os.path.join(work, "resumed.pkl")
        with contextlib.redirect_stdout(sys.stderr):
            run = train_synthetic.main(SYNTH_ARGV + [
                "--n-scenes", "4", "--steps", str(SYNTH_RESUME_STEPS),
                "--resume", weights, "--out", path_b])
        losses_b = [m["total_loss"] for m in run.history]
        del run
        out["resume"] = dict(
            seconds=time.time() - t0, total_loss=losses_b,
            pickle=os.path.isfile(path_b),
            ok=bool(np.all(np.isfinite(losses_b))) and os.path.isfile(path_b))
        emit({"phase": "train_synthetic", "part": "resume", **out["resume"],
              "seconds_total": time.time() - t_start})

        # (c) the new pickle in the registration path
        t0 = time.time()
        model = load_model(path, ARCHS["ResUNetSmall2"], device=dev)
        _, T = register_pair_e2e(
            model, caps_reg, reg_cfg, *pair_args(pair), device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        out["register"] = dict(seconds=time.time() - t0,
                               **verdict(T, pair["gt"]))
        out["register"]["ok"] = out["register"]["finite"]
        del model
        emit({"phase": "train_synthetic", "part": "register",
              **out["register"], "seconds_total": time.time() - t_start})
    out["ok"] = all(out[k]["ok"] for k in ("scratch", "kernels", "resume",
                                           "register"))
    return out, paths

# ---------------------------------------------------------------------------
# phase 5k: the parallel layer (the points-sharded UME through the moments
# kernel's per-keypoint caps, the data-parallel train step), the hash table
# and grid NN, and the native host ops

SP_KEYPOINTS = 2048
SP_BLOCKS = (4, 8)  # emulated 'sp' ranks in one process
ICP_RAW = 131072  # the evaluate CLI's raw ICP size (icp_raw_max_size)
GRID_RADIUS, GRID_BUDGET = 0.4, 32
UME_DEVICE_MS_PR12 = (0.0858, 0.0891)  # ume_moments_fused, device alone


def raw_cloud(raw, n, rng):
    """A raw scan as the CLI's raw ICP stage holds it: rows permuted, cut
    or zero-padded to n, with its mask."""
    p = raw[rng.permutation(len(raw))[:n]].astype(np.float32)
    buf = np.zeros((n, 3), np.float32)
    buf[:len(p)] = p
    return buf, np.arange(n) < len(p)


def wall_ms(fn, reps=3):
    """Median host-clock ms of fn() round a synchronize (for functions
    that read the device on the host, as the hash loops do)."""
    import torch

    out, times = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def sp_parts(dev, mesh, p, feat, pm, r, cap, card):
    """Parts (a)-(c): the 'sp' UME on a one-rank mesh against
    ume_from_ball_query bit for bit; S = 4 and 8 blocks emulated through
    local_moments against the one-device kernel, and the global-order
    forced case; the kernel's caps against caps=None and the plain
    version. Returns ({part: result}, launches of the counted 'sp' run,
    the inputs and the one-device result on the host)."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_ume
    from umeregrobust_tpu_torch.parallel import (
        local_moments, points_block, ume_from_ball_query_sp)
    from umeregrobust_tpu_torch.parallel.points_sharded import (
        block_caps, block_counts)
    from umeregrobust_tpu_torch.pipeline.sampling import weighted_sample
    from umeregrobust_tpu_torch.pipeline.ume_gen import (
        moment_rows, moments_to_ume, ume_from_ball_query)

    g = torch.Generator(device=dev).manual_seed(1)
    kp = p[weighted_sample(pm.float() / pm.float().sum(), SP_KEYPOINTS,
                           g)].contiguous()
    M, N, C = kp.shape[0], p.shape[0], feat.shape[1]
    res = {}

    # (a) the one-rank mesh through the entry point, counted
    one = ume_from_ball_query(p, feat, kp, r, cap, p_mask=pm)
    torch.cuda.synchronize()
    reset_launch_counts()
    sp = ume_from_ball_query_sp(mesh, p, feat, kp, r, cap, p_mask=pm)
    torch.cuda.synchronize()
    launches = launch_counts()
    same = bool(torch.equal(sp, one))
    res["a_sp_ume"] = dict(
        shape=f"{M} keypoints x {N} points, C {C}, r {r}, cap {cap}",
        ranks=1, bit_identical_to_ume_from_ball_query=same,
        finite=bool(torch.isfinite(sp).all()),
        ms=time_ms(lambda: ume_from_ball_query_sp(mesh, p, feat, kp, r, cap,
                                                  p_mask=pm)),
        ms_ume_from_ball_query=time_ms(lambda: ume_from_ball_query(
            p, feat, kp, r, cap, p_mask=pm)),
        launches=launches["ume_moments_fused"], card=card,
        ok=same and bool(torch.isfinite(sp).all()))

    # (b) S blocks in one process, their sum against the one-device kernel
    Z = moment_rows(p, feat, pm)
    full = cuda_ume.ume_moments_fused(kp, p, Z, pm, r, cap)
    scale = float(full.abs().max())
    part_b = dict(card=card)
    ok_b = True
    for S in SP_BLOCKS:
        blocks = [[points_block(x, i, S) for x in (p, feat, pm)]
                  for i in range(S)]
        counts = torch.stack([block_counts(b[0], b[2], kp, r)
                              for b in blocks])
        total = 0
        for i, b in enumerate(blocks):
            total = total + local_moments(*b, kp, r,
                                          block_caps(counts, i, cap))
        err = float((total - full).abs().max())
        kept = sum(torch.minimum(block_caps(counts, i, cap), counts[i])
                   for i in range(S))
        exact_caps = bool(torch.equal(kept, torch.clamp(counts.sum(0),
                                                        max=cap)))
        part_b[f"S{S}"] = dict(max_abs_err=err, scale=scale,
                               caps_exact=exact_caps,
                               ok=err <= 1e-5 * scale and exact_caps)
        ok_b &= part_b[f"S{S}"]["ok"]
    # tests/test_points_sharded.py's forced case: every point in radius,
    # max_nn 100 over 8 blocks, m0 = 100 exactly
    cp = torch.zeros(512, 3, device=dev)
    cf = torch.ones(512, 4, device=dev)
    cm = torch.ones(512, dtype=torch.bool, device=dev)
    ck = torch.zeros(1, 3, device=dev)
    blocks = [[points_block(x, i, 8) for x in (cp, cf, cm)] for i in range(8)]
    counts = torch.stack([block_counts(b[0], b[2], ck, 1.0) for b in blocks])
    F = sum(local_moments(*b, ck, 1.0, block_caps(counts, i, 100))
            for i, b in enumerate(blocks))
    m0 = F[0, :4].tolist()
    m0_mesh = ume_from_ball_query_sp(mesh, cp, cf, ck, 1.0, 100,
                                     normalize=False)[0, :, 0].tolist()
    part_b["forced_global_order"] = dict(
        m0=m0, m0_mesh=m0_mesh,
        ok=m0 == [100.0] * 4 and m0_mesh == [100.0] * 4)
    part_b["ok"] = ok_b and part_b["forced_global_order"]["ok"]
    res["b_emulated_blocks"] = part_b

    # (c) per-keypoint caps on the card
    caps_full = torch.full((M,), cap, dtype=torch.int32, device=dev)
    with_full = cuda_ume.ume_moments_fused(kp, p, Z, pm, r, cap,
                                           caps=caps_full)
    gen = torch.Generator(device=dev).manual_seed(7)
    rc = torch.randint(0, cap + 1, (M,), generator=gen, device=dev,
                       dtype=torch.int32)
    rc[:16] = 0
    a = cuda_ume.ume_moments_fused(kp, p, Z, pm, r, cap, caps=rc)
    a2 = cuda_ume.ume_moments_fused(kp, p, Z, pm, r, cap, caps=rc)
    b = cuda_ume.ume_moments_plain(kp, p, Z, pm, r, cap, caps=rc)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    sc = float(b.abs().max())
    zero_rows = bool(torch.count_nonzero(a[rc == 0]) == 0)
    none_ms = graph_ms(lambda: cuda_ume.ume_moments_fused(kp, p, Z, pm, r,
                                                          cap))
    res["c_caps"] = dict(
        caps_full_bit_identical_to_none=bool(torch.equal(with_full, full)),
        random_caps_max_abs_err=err, scale=sc, zero_rows_exact=zero_rows,
        two_launches_identical=bool(torch.equal(a, a2)),
        kernel_ms_caps_none=none_ms,
        kernel_ms_caps_full=graph_ms(lambda: cuda_ume.ume_moments_fused(
            kp, p, Z, pm, r, cap, caps=caps_full)),
        kernel_ms_pr12_range=UME_DEVICE_MS_PR12,
        kernel_ms_caps_none_in_range=bool(
            UME_DEVICE_MS_PR12[0] <= none_ms <= UME_DEVICE_MS_PR12[1]),
        card=card,
        ok=bool(torch.equal(with_full, full)) and err <= 1e-5 * sc
        and zero_rows and bool(torch.equal(a, a2)))
    inputs = dict(p=p.cpu(), feat=feat.cpu(), pm=pm.cpu(), kp=kp.cpu(), r=r,
                  cap=cap, one=moments_to_ume(full, C, normalize=False).cpu())
    return res, launches, inputs


def dp_part(dev, mesh, work, card):
    """Part (d): ResUNetSmall2 (in-repo weights) at train_kitti_config, B =
    8, two steps on the one-rank mesh against two without it, and two
    more without it (whether a step repeats its bits at all). Returns
    (result, launches of the counted mesh steps, the batch)."""
    import torch

    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.parallel import shard_batch
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, Trainer, batch_to_device)

    weights = os.path.join(ROOT, "weights", "synthetic_pretrain.pkl")
    cfg = TrainConfig()
    batch = train_batch(TRAIN_B, 901)

    def run(name, m):
        model = load_model(weights, ARCHS["ResUNetSmall2"], device=dev)
        tr = Trainer(cfg, os.path.join(work, name), device=dev, model=model,
                     mesh=m)
        b = batch_to_device(shard_batch(m, batch) if m is not None
                            else batch, dev)
        steps = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            metrics = tr.train_step(b)
            torch.cuda.synchronize()
            steps.append(dict(ms=(time.time() - t0) * 1e3,
                              total_loss=metrics["total_loss"],
                              nonfinite_grad=metrics["nonfinite_grad"]))
        return steps, train_state(tr)

    reset_launch_counts()
    mesh_steps, mesh_state = run("mesh", mesh)
    launches = launch_counts()
    plain_steps, plain_state = run("plain", None)
    again_steps, again_state = run("plain_again", None)

    def differ(x, y):
        return sorted(k for k in y if not torch.equal(x[k], y[k]))

    diff = differ(mesh_state, plain_state)
    repeat = differ(again_state, plain_state)
    res = dict(arch="ResUNetSmall2", B=TRAIN_B, ranks=1,
               mesh_steps=mesh_steps, plain_steps=plain_steps,
               plain_again_steps=again_steps, tensors=len(plain_state),
               mesh_vs_plain_differing=diff,
               plain_vs_plain_differing=repeat,
               launches_per_step={k: v / 2 for k, v in launches.items()},
               card=card,
               ok=not diff and all(np.isfinite(s["total_loss"])
                                   for s in mesh_steps + plain_steps))
    return res, launches, batch


def grid_part(dev, pair, card):
    """Part (e): the hash-grid NN at the CLI's raw ICP size (131072 target
    and query points of an HDL-64 density scan pair, the source under the
    ground truth), radius 0.4 m, budget 32: on the card against its CPU
    run bit for bit, and against densegrid.dense_nn_query (budget raised
    to the largest window: exact) on every query whose 27 cells hold <=
    budget points; a voxel-key hash table at the same scale, every key
    found."""
    import torch

    from umeregrobust_tpu_torch.ops import gridnn, hashing
    from umeregrobust_tpu_torch.ops.densegrid import (
        build_dense_grid, dense_nn_query, max_window_count)
    from umeregrobust_tpu_torch.ops.voxel import quantize_np

    rng = np.random.default_rng(3)
    T = pair["gt_tform"].astype(np.float32)
    tgt, tmask = raw_cloud(pair["tgt_pts"], ICP_RAW, rng)
    src = (pair["src_pts"] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    q, qmask = raw_cloud(src, ICP_RAW, rng)
    tp, tm, qt, qm = (torch.as_tensor(x, device=dev)
                      for x in (tgt, tmask, q, qmask))
    build_ms, grid = wall_ms(lambda: gridnn.build_grid(
        tp, tm, GRID_RADIUS, device=dev))
    build_rounds = hashing.ROUNDS["build"]
    query_ms, (d, idx) = wall_ms(lambda: gridnn.nn_query(
        grid, qt, GRID_RADIUS, q_mask=qm, budget=GRID_BUDGET))
    overflow = int(gridnn.overflow_count(grid, GRID_BUDGET))
    cpu = gridnn.build_grid(tgt, tmask, GRID_RADIUS, device="cpu")
    d_c, idx_c = gridnn.nn_query(cpu, q, GRID_RADIUS, q_mask=qmask,
                                 budget=GRID_BUDGET)
    card_is_cpu = bool(torch.equal(idx.cpu(), idx_c)
                       and torch.equal(d.cpu(), d_c))
    vs_cpu = dict(
        cells=int((gridnn._cell_coords(tp, GRID_RADIUS).cpu()
                   != gridnn._cell_coords(torch.as_tensor(tgt),
                                          GRID_RADIUS)).any(1).sum()),
        idx=int((idx.cpu() != idx_c).sum()), dist=int((d.cpu() != d_c).sum()))
    # the queries the budget serves exactly: their 27 cells hold <= budget
    offs = torch.tensor([(0, a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                         for c in (-1, 0, 1)], dtype=torch.int32, device=dev)
    qc = gridnn._cell_coords(qt, GRID_RADIUS)
    cells = hashing.lookup(grid.cell_table,
                           (qc[:, None] + offs).reshape(-1, 4))
    lookup_rounds = hashing.ROUNDS["lookup"]  # all 27 x 131072 probes
    cnt = torch.where(cells >= 0, grid.count[cells.clamp(min=0).long()],
                      0).reshape(-1, 27).amax(1)
    covered = qm & (cnt <= GRID_BUDGET)
    # the dense grid over the target's box, exact: budget = its fullest
    # window; queries in chunks to bound the candidate tensor
    lo = np.floor(tgt[tmask].min(0) / GRID_RADIUS)
    hi = np.floor(tgt[tmask].max(0) / GRID_RADIUS)
    dims = tuple(int(x) for x in hi - lo + 1)
    dg = build_dense_grid(tp, tm, GRID_RADIUS, dims)
    wmax = int(max_window_count(dg))
    didx = torch.cat([dense_nn_query(dg, qt[s:s + 4096], GRID_RADIUS,
                                     q_mask=qm[s:s + 4096],
                                     budget=max(wmax, 1))[1]
                      for s in range(0, ICP_RAW, 4096)])
    diff = covered & (didx != idx.long())
    # a differing index is a tie only where both points lie at the same
    # distance from the query (to 1e-6 of it)
    both = diff & (didx >= 0) & (idx >= 0)
    dq = torch.linalg.vector_norm(
        qt[both].double() - tp[didx[both]].double(), dim=1)
    gq = torch.linalg.vector_norm(
        qt[both].double() - tp[idx[both].long()].double(), dim=1)
    ties = int(((dq - gq).abs() <= 1e-6 * dq.clamp(min=1e-3)).sum())
    # a voxel-key table at the same scale: every key found at its row
    coords, _ = quantize_np(tgt[tmask], 0.1)
    keys = torch.as_tensor(np.concatenate(
        [np.zeros((len(coords), 1), np.int32), coords], 1), device=dev)
    kmask = torch.ones(len(keys), dtype=torch.bool, device=dev)
    tbuild_ms, table = wall_ms(lambda: hashing.build_hash_table(
        keys, kmask, device=dev))
    tbuild_rounds = hashing.ROUNDS["build"]
    tlookup_ms, found = wall_ms(lambda: hashing.lookup(table, keys))
    tlookup_rounds = hashing.ROUNDS["lookup"]
    all_found = bool(torch.equal(found.long(), torch.arange(
        len(keys), device=dev)))
    n_diff = int(diff.sum())
    return dict(
        target_points=int(tmask.sum()), queries=int(qmask.sum()),
        radius=GRID_RADIUS, budget=GRID_BUDGET, overflow_count=overflow,
        covered_queries=int(covered.sum()), hits=int((idx >= 0).sum()),
        dense_window_max=wmax, dense_dims=dims,
        idx_differ_from_dense=n_diff, of_which_ties=ties,
        card_equals_cpu=card_is_cpu, card_vs_cpu_differing=vs_cpu,
        grid_build_ms=build_ms,
        grid_build_rounds=build_rounds, grid_query_ms=query_ms,
        grid_lookup_rounds=lookup_rounds, table_keys=len(keys),
        table_build_ms=tbuild_ms, table_build_rounds=tbuild_rounds,
        table_lookup_ms=tlookup_ms, table_lookup_rounds=tlookup_rounds,
        all_keys_found=all_found, card=card,
        ok=card_is_cpu and n_diff == ties and all_found)


def native_part(pair, card):
    """Part (f): the port's g++-built host ops against numpy / scipy on a
    kitti_test-size scan (quantize at 0.3 m; nn_radius of the source under
    the ground truth at 0.4 m: float32 against cKDTree's float64, so a
    differing index must be a tie or lie at the radius) and a 2500 x 2500
    cost matrix with no ties (Hungarian)."""
    from scipy.optimize import linear_sum_assignment
    from scipy.spatial import cKDTree

    from umeregrobust_tpu_torch import native
    from umeregrobust_tpu_torch.ops.voxel import quantize_np

    have = native.have_native()
    scan = pair["src_pts"].astype(np.float32)
    t0 = time.perf_counter()
    c1, i1 = native.quantize(scan, 0.3)
    q_ms = (time.perf_counter() - t0) * 1e3
    c2, i2 = quantize_np(scan, 0.3)
    quant_ok = np.array_equal(c1, c2) and np.array_equal(i1, i2)
    T = pair["gt_tform"].astype(np.float32)
    q = (scan @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    tgt = pair["tgt_pts"].astype(np.float32)
    t0 = time.perf_counter()
    idx, dist = native.nn_radius(q, tgt, GRID_RADIUS)
    nn_ms = (time.perf_counter() - t0) * 1e3
    kd_d, kd_i = cKDTree(tgt).query(q, k=1)
    kd_i = np.where(kd_d <= GRID_RADIUS, kd_i, -1)
    bad = np.flatnonzero(idx != kd_i)
    d_nat = np.linalg.norm(q[bad].astype(np.float64)
                           - tgt[np.maximum(idx[bad], 0)], axis=1)
    explained = ((np.abs(kd_d[bad] - GRID_RADIUS) < 1e-5)
                 | ((idx[bad] >= 0) & (np.abs(d_nat - kd_d[bad]) < 1e-6)))
    cost = np.random.default_rng(11).uniform(0.0, 1.0, (2500, 2500))
    t0 = time.perf_counter()
    r1, col1 = native.hungarian(cost)
    h_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    r2, col2 = linear_sum_assignment(cost)
    h_scipy_ms = (time.perf_counter() - t0) * 1e3
    hung_ok = np.array_equal(r1, r2) and np.array_equal(col1, col2)
    return dict(
        have_native=have, scan_points=len(scan), voxels=len(c1),
        quantize_equal=bool(quant_ok), quantize_ms=q_ms,
        nn_queries=len(q), nn_hits=int((idx >= 0).sum()),
        nn_differ_from_kdtree=len(bad),
        nn_unexplained=int((~explained).sum()), nn_radius_ms=nn_ms,
        hungarian_equal=bool(hung_ok), hungarian_ms=h_ms,
        hungarian_scipy_ms=h_scipy_ms, card=card,
        ok=have and quant_ok and hung_ok and bool(explained.all()))


def train_state(tr, grads=False):
    """A trainer's parameters, BN buffers and Adam state (and with grads
    the parameters' gradients), cloned."""
    import torch

    state = {f"param.{k}": v.detach().clone()
             for k, v in tr.model.named_parameters()}
    if grads:
        state.update({f"grad.{k}": v.grad.detach().clone()
                      for k, v in tr.model.named_parameters()
                      if v.grad is not None})
    state.update({f"buffer.{k}": v.clone()
                  for k, v in tr.model.named_buffers()})
    for i, st in tr.optimizer.state_dict()["state"].items():
        state.update({f"adam.{i}.{k}": torch.as_tensor(v).clone()
                      for k, v in st.items()})
    return state


def leaf_err(a, b):
    """max |a - b| over max |b| of one tensor (1e-30 floor)."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


TWO_RANKS = 2
TWO_RANK_CFG = dict(compute_dtype="float32")  # train_kitti_config at fp32
TWO_RANK_TIMEOUT = 600  # seconds for the 2-rank run, start-up included


def two_rank_worker(rank, world, store, inputs, out):
    """Phase 5k's 2-rank run: one process a rank, both on the one card,
    over a gloo group (two NCCL ranks cannot share a card): (a) the 'sp'
    UME over 2 blocks of the points; (d) one data-parallel step of
    ResUNetSmall2 at fp32, B / 2 pairs a rank. Writes its results to
    {out}_{rank}.pt."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from umeregrobust_tpu_torch.models.resunet import ARCHS
        from umeregrobust_tpu_torch.models.weights import load_model
        from umeregrobust_tpu_torch.parallel import (
            make_mesh, shard_batch, ume_from_ball_query_sp)
        from umeregrobust_tpu_torch.train.trainer import (
            TrainConfig, Trainer, batch_to_device)

        d = torch.load(inputs, weights_only=False)
        dev = torch.device(d["device"])
        a = d["sp"]
        sp = make_mesh(n_dp=1, n_sp=world, device_type=dev.type)
        F = ume_from_ball_query_sp(
            sp, a["p"].to(dev), a["feat"].to(dev), a["kp"].to(dev), a["r"],
            a["cap"], p_mask=a["pm"].to(dev), normalize=False)
        dp = make_mesh(n_dp=world, n_sp=1, device_type=dev.type)
        tr = Trainer(TrainConfig(**d["cfg"]), f"{out}_run{rank}", device=dev,
                     model=load_model(d["weights"], ARCHS["ResUNetSmall2"],
                                      device=dev), mesh=dp)
        b = batch_to_device(shard_batch(dp, d["batch"]), dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        m = tr.train_step(b)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        torch.save(dict(F=F.cpu(), metrics=m, ms=(time.time() - t0) * 1e3,
                        state={k: v.cpu() for k, v in
                               train_state(tr, grads=True).items()}),
                   f"{out}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def two_rank_parts(dev, work, sp_inputs, batch, card):
    """The 2-rank run of (a) and (d) (two_rank_worker), held to what this
    process computes: (a) the moments before normalisation within 1e-5 x
    max |F| of the one-device kernel's (as (b)), both ranks the same bits;
    (d) at fp32, the averaged gradients, the new BN state and the
    parameters after the step bit for bit against the mean of two
    one-process steps on the halves of the batch (the ranks' slices) and
    one Adam step on that mean, both ranks the same model; beside it,
    how far the step lies from one step on the whole batch (a cloud's
    bits depend on its place in a batch: ROADMAP Queue 3 item 12).
    Returns {part: result}."""
    import torch
    import torch.multiprocessing as mp

    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, Trainer, batch_to_device)

    weights = os.path.join(ROOT, "weights", "synthetic_pretrain.pkl")
    cfg = TrainConfig(**TWO_RANK_CFG)

    def trainer(name):
        return Trainer(cfg, os.path.join(work, name), device=dev,
                       model=load_model(weights, ARCHS["ResUNetSmall2"],
                                        device=dev))

    def cpu_state(tr):
        return {k: v.cpu() for k, v in train_state(tr, grads=True).items()}

    tr = trainer("whole32")
    whole_m = tr.train_step(batch_to_device(batch, dev))
    whole = cpu_state(tr)
    half = len(batch["src_pts"]) // TWO_RANKS
    halves = []
    for h in range(TWO_RANKS):
        tr = trainer(f"half{h}")
        tr.train_step(batch_to_device(
            {k: v[h * half:(h + 1) * half] for k, v in batch.items()}, dev))
        halves.append(cpu_state(tr))
    # what the ranks must hold: the halves' mean gradient and BN state, and
    # the parameters after one Adam step on that mean
    want = {}
    for k in halves[0]:
        if k.startswith(("grad.", "buffer.")):
            want[k] = (halves[0][k] + halves[1][k]) / TWO_RANKS
    tr = trainer("mean_step")
    for name, p_ in tr.model.named_parameters():
        p_.grad = want[f"grad.{name}"].to(dev)
    tr.optimizer.step()
    want.update({k: v.cpu() for k, v in train_state(tr).items()
                 if k.startswith(("param.", "adam."))})
    del tr
    torch.cuda.empty_cache()
    inputs = os.path.join(work, "two_rank_inputs.pt")
    torch.save(dict(sp=sp_inputs, batch=batch, cfg=TWO_RANK_CFG,
                    weights=weights, device=dev.type), inputs)
    out = os.path.join(work, "two_rank")
    t0 = time.time()
    ctx = mp.spawn(two_rank_worker, nprocs=TWO_RANKS, join=False,
                   args=(TWO_RANKS, os.path.join(work, "two_rank_store"),
                         inputs, out))
    deadline = time.time() + TWO_RANK_TIMEOUT
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.0)):
            if time.time() >= deadline:
                raise TimeoutError("a rank of the 2-rank run did not finish")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    wall = time.time() - t0
    ranks = [torch.load(f"{out}_{r}.pt", weights_only=False)
             for r in range(TWO_RANKS)]
    one = sp_inputs["one"]
    scale = float(one.abs().max())
    errs = [float((r["F"] - one).abs().max()) for r in ranks]
    same = all(torch.equal(r["F"], ranks[0]["F"]) for r in ranks)
    res = {"a_sp_ume_2_ranks": dict(
        ranks=TWO_RANKS, backend="gloo", max_abs_err=max(errs), scale=scale,
        ranks_bit_identical=same, wall_s=wall, card=card,
        ok=max(errs) <= 1e-5 * scale and same)}
    differing = sorted({k for r in ranks for k, v in want.items()
                        if not torch.equal(r["state"][k], v)})
    # beside it, the distance from one step on the whole batch
    dist_whole = {"metric_rel": 0.0, "buffer": 0.0, "grad": 0.0,
                  "param": 0.0}
    for r in ranks:
        for k, v in whole_m.items():
            dist_whole["metric_rel"] = max(dist_whole["metric_rel"], abs(
                r["metrics"][k] - v) / max(abs(v), 1e-7))
        for k, v in whole.items():
            kind = k.split(".")[0]
            if kind in dist_whole:
                dist_whole[kind] = max(dist_whole[kind],
                                       leaf_err(r["state"][k], v))
    same_model = all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k])
                     for k in whole)
    res["d_data_parallel_2_ranks"] = dict(
        ranks=TWO_RANKS, backend="gloo", B=len(batch["src_pts"]),
        compute_dtype="float32", tensors_checked=len(want),
        differing_from_mean_of_halves=differing,
        whole_batch_distance=dist_whole,
        loss=[r["metrics"]["total_loss"] for r in ranks],
        loss_one_process=whole_m["total_loss"],
        ms_a_step=[r["ms"] for r in ranks], ranks_same_model=same_model,
        card=card, ok=not differing and same_model)
    return res


def phase_parallel(dev, model, pair, cfg, t_start):
    """Phase 5k: parts (a)-(f) (one line each). A one-rank NCCL process
    group (a file store in a temporary directory) and a ('dp', 'sp') mesh
    of 1 x 1 serve (a) and (d); then (a) and (d) again over two gloo ranks
    on the one card (two_rank_parts). Returns ({part: result}, launch
    counts of the one-rank 'sp' and 'dp' runs by path)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from umeregrobust_tpu_torch.data.synthetic import SceneConfig, make_pair
    from umeregrobust_tpu_torch.models.resunet import build_unet_geometry
    from umeregrobust_tpu_torch.parallel import make_mesh

    card = smi("name,power.limit")
    src = {k: torch.as_tensor(v).to(dev) for k, v in pair["src"].items()}
    with torch.no_grad():
        geom = build_unet_geometry(src["coords"], src["mask"], model.arch,
                                   (16384, 10240, 4096, 1280, 256))
        feat = model(geom, src["mask"][:, None].float(), torch.bfloat16)
    res, paths = {}, {}
    with tempfile.TemporaryDirectory() as work:
        dist.init_process_group("nccl", init_method=f"file://{work}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(n_dp=1, n_sp=1)
            sp, paths["parallel_sp"], sp_inputs = sp_parts(
                dev, mesh, src["grid"], feat, src["mask"], cfg.ume_r_nn,
                cfg.ume_max_nn, card)
            res.update(sp)
            for k in sp:
                emit({"phase": "parallel", "part": k, **sp[k],
                      "seconds_total": time.time() - t_start})
            res["d_data_parallel"], paths["parallel_dp"], batch = dp_part(
                dev, mesh, work, card)
            emit({"phase": "parallel", "part": "d_data_parallel",
                  **res["d_data_parallel"],
                  "seconds_total": time.time() - t_start})
        finally:
            dist.destroy_process_group()
        two = two_rank_parts(dev, work, sp_inputs, batch, card)
        res.update(two)
        for k in two:
            emit({"phase": "parallel", "part": k, **two[k],
                  "seconds_total": time.time() - t_start})
    # HDL-64E's 0.08 deg azimuth step: ~137,000 returns a scan, cut to the
    # CLI's raw ICP size of 131072
    scan = make_pair(SceneConfig(seed=905, azimuth_bins=4500, **HDL64),
                     max_rotation_deg=30, max_translation=2.0, seed=905)
    res["e_grid_nn"] = grid_part(dev, scan, card)
    emit({"phase": "parallel", "part": "e_grid_nn", **res["e_grid_nn"],
          "seconds_total": time.time() - t_start})
    res["f_native"] = native_part(scan, card)
    emit({"phase": "parallel", "part": "f_native", **res["f_native"],
          "seconds_total": time.time() - t_start})
    return res, paths


def main() -> int:
    import contextlib

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 6: the e2e pairs under torch.profiler")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 1
    from dataclasses import replace

    from umeregrobust_tpu_torch.core.transforms import relative_rotation_error
    from umeregrobust_tpu_torch.data.suite import (
        REDUCED, REDUCED_CFG, REGIMES, prep_pair, tuning_seed)
    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.ops import _build
    from umeregrobust_tpu_torch.pipeline.e2e import (
        register_pair_e2e, register_pairs_batched)
    from umeregrobust_tpu_torch.pipeline.exactness import (
        escalated_budget, fine_grid_geometry, window_occupancy)
    from umeregrobust_tpu_torch.pipeline.registration import (
        RegistrationConfig)

    t_start = time.time()
    # --- 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(smi("name,power.limit"), flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # --- 2. build
    t0 = time.time()
    _build.load_library()
    emit({"phase": "build", "seconds": time.time() - t0,
          "library": os.path.relpath(str(_build.build_library()), ROOT),
          "ptxas_sparse_conv_taps": ptxas_report(),
          "ptxas_sparse_conv_grouped": ptxas_report("sparse_conv_grouped.cu"),
          "ptxas_sparse_conv_grouped_wgrad": ptxas_report(
              "sparse_conv_grouped_wgrad.cu"),
          "ptxas_nn1_argmin": ptxas_report("nn1_argmin.cu"),
          "ptxas_ball_query": ptxas_report("ball_query.cu"),
          "ptxas_kabsch": ptxas_report("kabsch.cu"),
          "ptxas_gather_rows_backward": {
              k: v for k, v in ptxas_report("gather_rows.cu").items()
              if k.startswith("seg_")}})

    # --- data and model
    cfg = RegistrationConfig(**REDUCED_CFG)  # bench.py:321-326
    t0 = time.time()
    names = list(REGIMES)
    pairs = [prep_pair(tuning_seed(r), r, **REDUCED) for r in names]
    log(f"data: {len(pairs)} pairs in {time.time() - t0:.1f}s")
    weights = os.path.join(ROOT, "weights", "synthetic_pretrain.pkl")
    model = load_model(weights, ARCHS["ResUNetSmall2"], device=dev)

    # --- 3. kernels
    kern = phase_kernels(dev, model, pairs[0], cfg)
    kern.update(phase_kernels_family(dev, pairs[0], cfg))
    kern["ball_query"] = phase_ball_query(dev)
    kern["kabsch_rotation"] = phase_kabsch(dev)
    conv_layers = phase_conv_layers(dev, pairs[0], weights)
    forced, forced_ok = conv_forced_cases(dev)
    emit({"phase": "conv_forced", "ok": forced_ok, **forced})
    grouped = phase_grouped_layers(dev, pairs, weights)
    kern["sparse_conv_grouped"] = dict(
        ok=grouped["ok"], max_abs_err=grouped["max_abs_err"],
        shape=f"ResUNetSmall2's {grouped['layers']} grouped k3 layers, "
              "one pair (reduced point, bf16): " + "; ".join(
                  f"{r['layer']} {r['cin']}->{r['cout']}, {r['rows_in']}->"
                  f"{r['rows_out']} rows" for r in grouped["rows"]),
        **{k: grouped[k] for k in (
            "ms", "kernel_ms", "parent_kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_kernel_ms",
            "per_tap_kernel_ms", "B", "kernel_ms_batched",
            "parent_kernel_ms_batched", "bound_ms_batched",
            "bit_identical_to_b1")},
        kernel_ms_b1=grouped["kernel_ms"])
    order = grouped["order"]
    od, o4 = order["one_pair"], order[f"B{len(pairs)}"]
    kern["grouped_row_order"] = dict(
        ok=od["ok"] and o4["ok"] and order["forced_ok"],
        max_abs_err=max(od["max_abs_err"], o4["max_abs_err"]),
        shape=f"the {od['maps']} grouped maps of a ResUNetSmall2 one-pair "
              "pyramid in one launch: " + ", ".join(map(str, od["rows"]))
              + " rows",
        **{k: od[k] for k in ("ms", "kernel_ms", "parent_ms",
                              "parent_kernel_ms", "host_ms",
                              "parent_host_ms", "plain_ms", "bound_ms",
                              "argsort_ms", "launches", "parent_launches",
                              "cluster")},
        bound_by="bytes", library_ms=None,
        B=len(pairs), kernel_ms_b1=od["kernel_ms"],
        kernel_ms_batched=o4["kernel_ms"], bound_ms_batched=o4["bound_ms"],
        parent_kernel_ms_batched=o4["parent_kernel_ms"],
        forced=order["forced"])
    for name in ("sparse_conv_rowtile", "sparse_conv_tapsplit"):
        kind = name[len("sparse_conv_"):]
        mine = [r for r in conv_layers["ResUNet"]["rows"]
                if r["kernel"] == kind]
        kern[name].update(
            ok=kern[name]["ok"] and forced_ok and all(
                v["ok"] for v in conv_layers.values()),
            shape="ResUNet layers routed here: " + "; ".join(
                f"{r['layer']} K{r['K']} {r['cin']}->{r['cout']}, "
                f"{r['rows_in']}->{r['rows_out']} rows, {r['valid']} valid"
                for r in mine),
            **{k: sum(r[k] for r in mine) for k in (
                "ms", "kernel_ms", "old_ms", "old_kernel_ms", "plain_ms",
                "bound_ms")},
            library_ms=(None if any(r["library_ms"] is None for r in mine)
                        else sum(r["library_ms"] for r in mine)),
            bound_by=max(mine, key=lambda r: r["bound_ms"])["bound_by"],
            max_abs_err=max([kern[name]["max_abs_err"]]
                            + [r["max_abs_err"] for r in mine]))
    pair_axis = phase_pair_axis(dev, model, pairs, cfg)
    for name, res in pair_axis.items():
        emit({"phase": "pair_axis", "kernel": name, **res})
        kern[name].update(
            kernel_ms_b1=res["kernel_ms_b1"], B=res["B"],
            kernel_ms_batched=res["kernel_ms_batched"],
            bound_ms_batched=res["bound_ms_batched"],
            bit_identical_to_b1=res["bit_identical_to_b1"],
            ok=kern[name]["ok"] and res["ok"],
            max_abs_err=max(kern[name]["max_abs_err"], res["max_abs_err"]))
    widths = width_cases(dev, pairs[0])
    emit({"phase": "widths_forced", **widths})
    for name, key in (("ume_moments_fused", "ume_rel_err"),
                      ("corr_scores_fused", "corr_rel_err")):
        kern[name].update(
            widths={c: w[key] for c, w in widths.items()},
            ok=kern[name]["ok"] and all(w["ok"] for w in widths.values()))
    for name, res in kern.items():
        emit({"kernel": name, **res})

    # --- 4. reference on a small input
    cfg_small = RegistrationConfig(
        num_init_keypoints=256, ume_n_samples=64, ume_max_nn=128,
        corr_coarse_src=None, corr_rescore_top=16, icp_max_corr=0.5,
        icp_max_iter=15, filter_mode="topk")
    ref = phase_reference(dev, model, load_model(
        weights, ARCHS["ResUNetSmall2"], device="cpu"), cfg_small)
    emit({"phase": "reference", **ref})

    # --- 5. end to end: ICP occupancy pre-check and budget escalation
    cell, dims = fine_grid_geometry(cfg)
    worst_win = worst_box = 0
    for p in pairs:
        w, b = window_occupancy(p["tgt"]["corr_pts"][p["tgt"]["corr_mask"]],
                                cell, dims)
        worst_win, worst_box = max(worst_win, w), max(worst_box, b)
    if worst_win > cfg.icp_budget:
        cfg = replace(cfg, icp_budget=escalated_budget(worst_win,
                                                       cfg.icp_budget))
    emit({"phase": "icp_precheck", "max_window_count": worst_win,
          "box_overflow": worst_box, "icp_budget": cfg.icp_budget})
    if worst_box != 0 or worst_win > cfg.icp_budget:
        raise RuntimeError("ICP grid does not cover the suite clouds")

    def run(p, seed, model=model):
        g = torch.Generator(device=dev).manual_seed(seed)
        return register_pair_e2e(model, REDUCED["caps"], cfg, *pair_args(p),
                                 generator=g, device=dev)

    def run_suite(model, phase):
        """The four regime pairs through `model` after a warm-up pair:
        per-pair results and the launch counts of the timed run."""
        run(pairs[0], 0, model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        wall, results = 0.0, []
        for i, (name, p) in enumerate(zip(names, pairs)):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            _, T = run(p, i, model)
            torch.cuda.synchronize()
            dt = time.time() - t0
            wall += dt
            launches = {k: v - before[k] for k, v in launch_counts().items()}
            T = T.double().cpu()
            gt = torch.as_tensor(p["gt"], dtype=torch.float64)
            rre = float(relative_rotation_error(gt[:3, :3], T[:3, :3]))
            rte = float(torch.linalg.vector_norm(T[:3, 3] - gt[:3, 3]))
            res = dict(pair=i, regime=name, seed=tuning_seed(name),
                       rre_deg=rre, rte_m=rte,
                       np_pass=rre <= 1.5 and rte <= 0.6,
                       sp_pass=rre <= 1.0 and rte <= 0.1, seconds=dt,
                       launches=launches,
                       finite=bool(torch.isfinite(T).all()))
            emit({"phase": phase, **res})
            results.append(res)
        total = launch_counts()
        emit({"phase": f"{phase}_summary", "pairs": len(results),
              "pairs_per_s": len(results) / wall, "wall_s": wall,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "np_recall": float(np.mean([r["np_pass"] for r in results])),
              "sp_recall": float(np.mean([r["sp_pass"] for r in results])),
              "launches": total, "seconds_total": time.time() - t_start})
        return results, total, wall

    results, e2e_launches, wall = run_suite(model, "e2e")

    # --- 5b. the ResUNet family at full width
    fam = phase_family(dev, pairs[0], cfg)
    emit({"phase": "family", **fam})

    # --- 5c. every conv of ResUNetSmall2 through the per-tap kernels
    scan_model = load_model(weights, ARCHS["ResUNetSmall2"], device=dev,
                            conv_impl="scan")
    scan_results, scan_launches, scan_wall = run_suite(scan_model, "scan")
    emit({"phase": "scan_vs_grouped", "pairs": [
        dict(regime=g["regime"], d_rre_deg=abs(g["rre_deg"] - sc["rre_deg"]),
             d_rte_m=abs(g["rte_m"] - sc["rte_m"]),
             same_verdict=(g["np_pass"], g["sp_pass"]) == (sc["np_pass"],
                                                           sc["sp_pass"]))
        for g, sc in zip(results, scan_results)],
        "pairs_per_s_grouped": len(results) / wall,
        "pairs_per_s_scan": len(scan_results) / scan_wall})
    # --- 5d. pair batching: the four regime pairs as one batch, then the
    # eight pairs tuning_seed(regime, i), i in {0, 1}, each against the
    # same pairs one at a time; ICP's budget covers every pair's windows
    for r, p in zip(names, pairs):
        p.update(regime=r, seed=tuning_seed(r))
    more = [dict(prep_pair(tuning_seed(r, 1), r, **REDUCED), regime=r,
                 seed=tuning_seed(r, 1)) for r in names]
    cfg_b = cfg
    for p in more:
        w, b = window_occupancy(p["tgt"]["corr_pts"][p["tgt"]["corr_mask"]],
                                cell, dims)
        if b != 0:
            raise RuntimeError("ICP grid does not cover the batch's clouds")
        if w > cfg_b.icp_budget:
            cfg_b = replace(cfg_b, icp_budget=escalated_budget(
                w, cfg_b.icp_budget))
    batch_res = {}
    for label, batch in (("regimes", pairs), ("regimes_x2", pairs + more)):
        res, lc = phase_batched(dev, model, REDUCED["caps"], cfg_b, batch,
                                list(range(len(batch))), label)
        emit({"phase": "batched", **res})
        batch_res[label] = (res, lc)
    with BlockMatmulProbe() as bmp:
        for batch in (pairs, pairs + more):
            register_pairs_batched(
                model, REDUCED["caps"], cfg_b, *stacked_args(batch),
                device=dev, generators=[torch.Generator(
                    device=dev).manual_seed(i) for i in range(len(batch))])
    block_mm = bmp.summary()
    emit({"phase": "block_matmul", "model": "ResUNetSmall2", **block_mm})
    grouped_ab = phase_grouped_ab(dev, model, REDUCED["caps"], cfg_b, pairs,
                                  scan_model)
    emit({"phase": "grouped_ab", **grouped_ab,
          "seconds_total": time.time() - t_start})
    res_b = phase_resunet_batched(dev, pairs[:2])
    emit({"phase": "batched_resunet", **res_b})
    for name in ("sparse_conv_rowtile", "sparse_conv_tapsplit"):
        c = res_b["conv_by_kernel"][name[len("sparse_conv_"):]]
        kern[name].update(
            B=res_b["B"], kernel_ms_b1=c["kernel_ms_b1"],
            kernel_ms_batched=c["kernel_ms"], bound_ms_batched=c["bound_ms"],
            ok=kern[name]["ok"] and res_b["conv_ok"],
            max_abs_err=max(kern[name]["max_abs_err"], c["max_abs_err"]))

    # --- 5e. the Hungarian parity path on the nominal pair
    hung = phase_hungarian(dev, model, REDUCED["caps"], cfg, pairs[0])
    emit({"phase": "hungarian", **hung})

    # --- 5f. the remaining RegistrationConfig paths on the regime pairs
    emit({"phase": "config_paths_start",
          "seconds_total": time.time() - t_start})
    cfg_paths, cfg_launches = phase_config_paths(dev, model, REDUCED["caps"],
                                                 cfg_b, pairs)
    for res in cfg_paths.values():
        emit({"phase": "config_paths", **res,
              "seconds_total": time.time() - t_start})

    # --- 5g. the evaluate CLI at the full kitti_test configuration
    cli_runs = [phase_cli("kitti_test", [
        "--synthetic", "3", "--set",
        f"model_checkpoint_path={CLI_WEIGHTS}"], MAIN_KERNELS)]
    cli_runs.append(phase_cli("kitti_test_parity", [
        "--synthetic", str(CLI_PARITY_PAIRS), "--set",
        f"model_checkpoint_path={CLI_WEIGHTS}", "--set", "parity=true"],
        CONFIG_PATHS["parity"][1]))
    for res in cli_runs:
        emit({"phase": "cli", **res, "seconds_total": time.time() - t_start})

    # --- 5h. the CLI's dataset mode (KITTI SEM cache, .pkl and .pth; one
    # nuScenes pair preprocessed), the SEM CLI and RT-UME
    emit({"phase": "datasets_start", "seconds_total": time.time() - t_start})
    data_res, data_paths = phase_datasets(dev, t_start)
    emit({"phase": "datasets", "ok": data_res["ok"],
          "rtume_launches": data_res["rtume"]["launches"],
          "rtume_keypoints_kept": data_res["rtume"]["keypoints"],
          "seconds_total": time.time() - t_start})

    # --- 5i. feature widths 16 and 64 through the registration path and
    # RT-UME
    wide = phase_widths(dev, pairs[0], cfg)
    for k, v in wide.items():
        emit({"phase": "widths", "model": k, **v,
              "seconds_total": time.time() - t_start})

    # --- 5j. training on the card
    emit({"phase": "train_start", "seconds_total": time.time() - t_start})
    train_res, train_kern, train_paths = phase_train(dev, t_start)
    kern.update(train_kern)
    o8 = train_res["row_order"]
    kern["grouped_row_order"].update(
        train=o8, ok=kern["grouped_row_order"]["ok"] and o8["ok"],
        max_abs_err=max(kern["grouped_row_order"]["max_abs_err"],
                        o8["max_abs_err"]))
    kern["gather_rows"]["ok"] = (kern["gather_rows"]["ok"]
                                 and train_res["windows"]["ok"])
    gb = train_res["grouped_bwd"]  # its dX route: this kernel, adjoint map
    kern["sparse_conv_grouped"].update(
        train_dx_kernel_ms=gb["dx_kernel_ms"],
        train_dx_parent_kernel_ms=gb["parent_dx_kernel_ms"],
        train_dx_bound_ms=gb["dx_bound_ms"],
        train_dx_max_abs_err=gb["dx_max_abs_err"],
        train_fwd_kernel_ms=gb["fwd_kernel_ms"],
        train_fwd_parent_kernel_ms=gb["fwd_parent_kernel_ms"],
        train_fwd_bound_ms=gb["fwd_bound_ms"],
        ok=kern["sparse_conv_grouped"]["ok"] and gb["ok"])

    # --- 5k. the parallel layer, the hash grid and the native host ops
    emit({"phase": "parallel_start", "seconds_total": time.time() - t_start})
    par, par_paths = phase_parallel(dev, model, pairs[0], cfg, t_start)
    kern["ume_moments_fused"].update(caps=par["c_caps"])
    kern["ume_moments_fused"]["ok"] &= par["c_caps"]["ok"]

    # --- 5l. the synthetic pretraining CLI from scratch at its full width
    emit({"phase": "train_synthetic_start",
          "seconds_total": time.time() - t_start})
    synth, synth_paths = phase_train_synthetic(dev, t_start, pairs[0], cfg,
                                               REDUCED["caps"])
    sk = synth["kernels"]
    sg = sk["grouped"]
    kern["sparse_conv_grouped"].update(
        train_synthetic=dict(
            fwd_kernel_ms=sg["fwd_kernel_ms"], dx_kernel_ms=sg["dx_kernel_ms"],
            fwd_max_err_over_limit=sg["fwd_max_err_over_limit"],
            dx_max_err_over_limit=sg["dx_max_err_over_limit"],
            rows=sg["rows"]),
        ok=kern["sparse_conv_grouped"]["ok"] and sg["ok"])
    kern["sparse_conv_grouped_wgrad"].update(
        train_synthetic=dict(dw_kernel_ms=sg["dw_kernel_ms"],
                             dw_max_err_over_limit=sg["dw_max_err_over_limit"]),
        ok=kern["sparse_conv_grouped_wgrad"]["ok"] and sg["ok"])
    kern["grouped_row_order"].update(
        train_synthetic={k: sk["row_order"][k] for k in (
            "rows", "mismatches", "kernel_ms", "bound_ms", "launches", "ok")},
        ok=kern["grouped_row_order"]["ok"] and sk["row_order"]["ok"])
    for name in ("gather_rows", "gather_rows_backward"):
        kern[name].update(train_synthetic=sk[name],
                          ok=kern[name]["ok"] and sk[name]["ok"])

    paths = {"e2e": e2e_launches, "family": fam["launches"],
             "scan": scan_launches, "batched": batch_res["regimes"][1],
             "batched_resunet": res_b["launches"],
             "hungarian": hung["launches"],
             **{f"config_{k}": v for k, v in cfg_launches.items()},
             **{f"cli_{r['run']}": r["launches"] for r in cli_runs},
             **data_paths, **train_paths,
             **{f"widths_{k}": v["launches"] for k, v in wide.items()},
             **par_paths, **synth_paths}
    if args.profile:
        phase_profile(run, pairs, cfg, wall, "grouped")
        with PlainGroupedConv():  # the plain version's grouped conv
            run(pairs[0], 0)  # warm-up
            phase_profile(run, pairs, cfg, None, "grouped_parent")
        phase_profile(lambda p, i: run(p, i, scan_model), pairs, cfg,
                      scan_wall, "scan")
        with OldConvKernels():
            run(pairs[0], 0, scan_model)  # warm-up
            phase_profile(lambda p, i: run(p, i, scan_model), pairs, cfg,
                          None, "scan_old_conv_kernels")
        from umeregrobust_tpu_torch.models.resunet import (
            default_level_capacities, init_resunet)

        res_model = init_resunet(
            ARCHS["ResUNet"], 1, 32, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        res_caps = default_level_capacities(pairs[0]["src"]["coords"].shape[0],
                                            ARCHS["ResUNet"])

        def run_resunet(p, seed):
            g = torch.Generator(device=dev).manual_seed(seed)
            return register_pair_e2e(res_model, res_caps, cfg, *pair_args(p),
                                     generator=g, device=dev)

        run_resunet(pairs[0], 0)  # warm-up
        phase_profile(run_resunet, pairs, cfg, None, "resunet")
        with OldConvKernels():
            run_resunet(pairs[0], 0)
            phase_profile(run_resunet, pairs, cfg, None,
                          "resunet_old_conv_kernels")
        del res_model
        # phase 5d's two batches (its seeds and budget), one batch each,
        # then again with the plain version's grouped conv
        for parent in (False, True):
            for label, tag, batch in (("regimes", "batched", pairs),
                                      ("regimes_x2", "batched_x2",
                                       pairs + more)):
                bargs = stacked_args(batch)

                def run_all():
                    return register_pairs_batched(
                        model, REDUCED["caps"], cfg_b, *bargs, device=dev,
                        generators=[torch.Generator(device=dev).manual_seed(
                            i) for i in range(len(batch))])

                with (PlainGroupedConv() if parent
                      else contextlib.nullcontext()):
                    if parent:
                        run_all()  # warm-up
                    phase_profile(None, batch, cfg_b, None if parent else
                                  float(np.mean(batch_res[label][0][
                                      "wall_s_batched"])),
                                  tag + ("_parent" if parent else ""),
                                  run_all=run_all)

    failures = [f"kernel {k}" for k, v in kern.items() if not v["ok"]]
    if not ref["ok"]:
        failures.append("reference: card and CPU transforms differ")
    for r in results + scan_results:
        lc = r["launches"]
        # feat_to_raw: the nn1 kernels twice, their merge copying the rows
        # (no gather_rows launch); feature_spatial_var: gather_rows twice
        if not (lc["nn1_argmin"] == 2 and lc["nn1_copy_rows"] == 2
                and lc["ume_moments_fused"] == 2
                and lc["corr_scores_fused"] >= 3 and lc["gather_rows"] >= 2):
            failures.append(f"pair {r['pair']}: launches {lc}")
        if not r["finite"]:
            failures.append(f"pair {r['pair']}: non-finite transform")
    for r in results:  # the grouped path: the k3 convs in the kernel
        lc = r["launches"]
        if (lc["sparse_conv_grouped"] != 18 or lc["gather_rows"] != 2
                or lc["grouped_row_order"] != 1):
            failures.append(f"pair {r['pair']}: grouped path launched "
                            f"sparse_conv_grouped {lc['sparse_conv_grouped']}"
                            f", gather_rows {lc['gather_rows']} and "
                            f"grouped_row_order {lc['grouped_row_order']} "
                            "times, not 18, 2 and 1")
    if not results[0]["np_pass"]:
        failures.append("nominal pair fails NP")
    if not fam["ok"]:
        failures.append("family phase (ResUNet through register_pair_e2e)")
    if not scan_results[0]["np_pass"]:
        failures.append("nominal pair fails NP with conv_impl='scan'")
    for g, sc in zip(results, scan_results):
        if (g["np_pass"], g["sp_pass"]) != (sc["np_pass"], sc["sp_pass"]):
            failures.append(f"pair {g['pair']}: scan verdict differs")
        if sc["launches"]["sparse_conv_rowtile"] == 0:
            failures.append(f"pair {g['pair']}: scan ran no per-tap kernel")
    for label, (res, _) in batch_res.items():
        if not res["ok"]:
            failures.append(f"batched {label}: verdicts, |dT_init| or launches"
                            " differ from the sequential path")
    if not grouped_ab["ok"]:
        failures.append("grouped A/B: fp32 features beyond "
                        f"{GROUPED_AB_FEATURE_LIMIT} x max from the parent's "
                        "form, or a pair's verdict differs")
    if not res_b["ok"]:
        failures.append("batched ResUNet: features differ from one pair's, "
                        "or a conv launch disagrees with its plain version")
    if not hung["ok"]:
        failures.append("Hungarian path: no finite rigid transform")
    for knob, res in cfg_paths.items():
        if not res["ok"]:
            failures.append(f"config path {knob}: transform, batched verdict,"
                            f" |dT_init| or launches {res['missing_kernels']}")
    for res in cli_runs:
        if not res["ok"]:
            failures.append(f"cli {res['run']}: non-finite transform or "
                            f"kernels {res['missing_kernels']} never launched")
    if not data_res["sem"]["ok"]:
        failures.append(f"SEM preprocessing: wrote {data_res['sem']['written']}"
                        f" then {data_res['sem']['written_again']} pairs")
    for res in data_res["kitti"] + [data_res["nuscenes"]]:
        if not res["ok"]:
            failures.append(f"dataset mode {res['run']}: pairs, transforms, "
                            f"ego filter or kernels {res['missing_kernels']}")
    if not all(data_res["kitti"][0]["T_bit_identical_pkl_pth"]):
        failures.append("dataset mode: .pth and .pkl transforms differ")
    for mode in ("diag", "n_rand", "grid"):
        if not data_res["rtume"][mode]["ok"]:
            failures.append(f"rtume {mode}: card and CPU differ, or "
                            "launches other than 2 a call")
    for k, v in wide.items():
        if not v["ok"]:
            failures.append(f"widths {k}: non-finite transform or kernels "
                            "not launched")
    for k in ("small2", "resunet"):
        if not all(np.isfinite(st["total_loss"])
                   for st in train_res[k]["steps"]):
            failures.append(f"train {k}: a non-finite loss")
    if train_res["small2"]["window_gathers_per_step"] != 0:
        failures.append("train small2: the grouped convs gathered "
                        f"{train_res['small2']['window_gathers_per_step']} "
                        "windows a step, not 0")
    if not train_res["card_vs_cpu"]["ok"]:
        failures.append("train: card and CPU losses differ beyond 1e-3, or "
                        f"a gradient leaf beyond {GRAD_LEAF_TOL} of its max")
    if not train_res["cli"]["ok"]:
        failures.append("train CLI: no checkpoint, or the evaluate CLI "
                        "could not use it")
    for part, res in par.items():
        if not res["ok"]:
            failures.append(f"parallel {part}")
    for part in ("scratch", "kernels", "resume", "register"):
        if not synth[part]["ok"]:
            failures.append(f"train_synthetic {part}: a non-finite loss, no "
                            "pickle, a kernel off its plain version or a "
                            "non-finite transform")
    # a kernel of a path must have launched in that path's counted run; the
    # SO(3) solver on every serving path (ICP, consensus, the estimator)
    serving = MAIN_KERNELS + ("kabsch_rotation",)
    on_path = {"e2e": serving, "batched": serving,
               "batched_resunet": ("nn1_argmin", "nn1_copy_rows",
                                   "sparse_conv_rowtile",
                                   "sparse_conv_tapsplit"),
               "hungarian": serving,
               **{p_: serving for p_ in data_paths if p_ != "rtume"},
               "rtume": ("ume_moments_fused", "kabsch_rotation"),
               "family": FORWARD_KERNELS,
               "train_small2": ("gather_rows", "gather_rows_backward",
                                "sparse_conv_grouped",
                                "sparse_conv_grouped_wgrad",
                                "grouped_row_order", "ball_query"),
               "train_resunet": ("gather_rows", "gather_rows_backward",
                                 "sparse_conv_rowtile", "sparse_conv_tapsplit",
                                 "sparse_conv_wgrad", "ball_query"),
               "train_cli": ("gather_rows", "gather_rows_backward",
                             "sparse_conv_grouped",
                             "sparse_conv_grouped_wgrad",
                             "grouped_row_order"),
               "train_synthetic": ("gather_rows", "gather_rows_backward",
                                   "sparse_conv_grouped",
                                   "sparse_conv_grouped_wgrad",
                                   "grouped_row_order"),
               "parallel_sp": ("ume_moments_fused",),
               "parallel_dp": ("gather_rows", "gather_rows_backward",
                               "sparse_conv_grouped",
                               "sparse_conv_grouped_wgrad"),
               **{f"widths_{k}": ("ume_moments_fused", "corr_scores_fused",
                                  "gather_rows", "sparse_conv_grouped",
                                  "grouped_row_order")
                  for k in wide},
               "scan": ("nn1_argmin", "nn1_copy_rows", "ume_moments_fused",
                        "corr_scores_fused", "gather_rows",
                        "sparse_conv_rowtile", "sparse_conv_tapsplit",
                        "kabsch_rotation")}
    for path, names_ in on_path.items():
        for k in names_:
            if paths[path][k] <= 0:
                failures.append(f"{k} never launched on the {path} path")

    rows = []
    for name, (src, rep) in KERNELS.items():
        k = kern[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=sum(c[name] for c in paths.values()),
            launches_by_path={p_: c[name] for p_, c in paths.items()},
            max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            shape=k["shape"], status="ok" if k["ok"] else "failed",
            **{key: k[key] for key in (
                "kernel_ms", "library_kernel_ms", "B", "kernel_ms_b1",
                "kernel_ms_batched", "bound_ms_batched",
                "bit_identical_to_b1") if key in k}))
    emit({"kernels": rows})
    if failures:
        log("chip_smoke FAILED: " + "; ".join(failures))
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
