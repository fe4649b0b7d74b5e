"""Benchmark evaluation CLI of the port, the counterpart of
umeregrobust_tpu/cli/evaluate.py (reference evaluate.py:113-310):

    python -m umeregrobust_tpu_torch.cli.evaluate --synthetic 3 \
        --set model_checkpoint_path=weights/synthetic_pretrain.pkl
    python -m umeregrobust_tpu_torch.cli.evaluate --synthetic 3 --set parity=true
    python -m umeregrobust_tpu_torch.cli.evaluate --synthetic 1 --device cpu

Per pair: SEM-voxelized clouds feed the coloring network; UME keypoint
matching generates transform hypotheses; the kernel correlator scores them
on the correlator clouds (src quantized at corr_ds, tgt at 0.3, the
reference's asymmetry, evaluate.py:261-264, with network features copied
by 1-NN); ICP refines the winner. Prints NP = (RRE <= 1.5 deg & RTE <= 0.6
m) and SP = (RRE <= 1 deg & RTE <= 0.1 m) recall (evaluate.py:304-305).

The configs are the port's own copies of the benchmark YAMLs
(umeregrobust_tpu_torch/configs/), read by utils/config.py. Every pair is
padded to the config's static capacities. Host prep (numpy) runs on
prefetch threads; all device work runs on the main thread, on the card
unless --device cpu (raises without CUDA). Random draws: pair i's numpy
prep uses np.random.default_rng(seed * 100003 + i), as in the JAX CLI;
its device draws (keypoints, match filter, correlator subsets, second
round) come from torch.Generator(device).manual_seed(seed * 100003 + i);
the Hungarian path's host filter from np.random.default_rng(seed * 9176 +
i).

Without --synthetic the CLI reads the benchmark's dataset: the YAML's
`dataset` (kitti / nuscenes), `split`, `data_path` (raw scans) and
`cache_data_path` (the SEM cache that cli/sem_preprocessing.py writes;
empty: preprocess the raw scans), each settable with --set. A
`model_checkpoint_path` ending in .pth / .pt is a MinkowskiEngine
checkpoint of the reference (models/convert.py); any other existing path
is a .pkl checkpoint of this project. The network is the ARCHS entry
whose parameter names and shapes the checkpoint holds exactly
(ResUNetSmall2 in smoke mode, as the reference's evaluate.py:163 builds);
its level capacities are ResUNetSmall2's five ratios of max_pc_size, or
models/resunet.default_level_capacities for any other entry.
"""
from __future__ import annotations

import argparse
import os
import time
import typing
from dataclasses import fields, replace
from typing import Dict

import numpy as np
import torch

from umeregrobust_tpu_torch.data.datasets import (
    NuscenesDataset, SemanticKITTIDataset)
from umeregrobust_tpu_torch.data.sem import SEMConfig, equalize_sampling
from umeregrobust_tpu_torch.data.synthetic import SceneConfig, make_pair
from umeregrobust_tpu_torch.devices import resolve_device
from umeregrobust_tpu_torch.models.resunet import (
    ARCHS, ArchSpec, ResUNet, default_level_capacities, init_resunet)
from umeregrobust_tpu_torch.models.convert import load_torch_checkpoint
from umeregrobust_tpu_torch.models.weights import (
    _flatten, load_checkpoint, model_from_params)
from umeregrobust_tpu_torch.ops.voxel import coords_to_grid_pts_np, quantize_np
from umeregrobust_tpu_torch.pipeline.e2e import (
    pair_features_e2e, register_pair_e2e)
from umeregrobust_tpu_torch.pipeline.exactness import (
    escalated_budget, fine_grid_geometry, window_occupancy)
from umeregrobust_tpu_torch.pipeline.registration import (
    RegistrationConfig, register_pair_hungarian)
from umeregrobust_tpu_torch.utils.config import (
    apply_overrides, load_yaml_config, update_namespace_from_yaml)
from umeregrobust_tpu_torch.utils.prefetch import prefetch, prefetch_map

BENCHMARK_CONFIGS = {
    "kitti_test": "benchmarks/test_kitti_config.yaml",
    "lokitti": "benchmarks/lokitti_config.yaml",
    "rotkitti": "benchmarks/rotkitti_config.yaml",
    "nuscenes_test": "benchmarks/test_nuscenes_config.yaml",
    "lonuscenes": "benchmarks/lonuscenes_config.yaml",
    "rotnuscenes": "benchmarks/rotnuscenes_config.yaml",
}

_CFG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def _pad_cloud(pts, seg, coords, cap, rng=None):
    """(points (cap, 3), labels, coords (cap, 4), mask) of a cloud, its
    rows ALWAYS randomly permuted (the fast paths take "the first M rows"
    as a uniform subsample), padded to cap."""
    n = min(len(pts), cap)
    rng = rng if rng is not None else np.random.default_rng()
    sel = rng.permutation(len(pts))[:cap]
    c4 = np.full((cap, 4), 2**20, np.int32)
    c4[:n, 0] = 0
    c4[:n, 1:] = coords[sel[:n]]
    p = np.zeros((cap, 3), np.float32)
    p[:n] = pts[sel[:n]]
    s = np.zeros((cap,), np.int32)
    s[:n] = seg[sel[:n]]
    mask = np.arange(cap) < n
    return p, s, c4, mask


# RegistrationConfig fields whose YAML/CLI spelling differs (reference
# YAML names kept for config parity)
_CFG_ALIASES = {"filter_by_ume_dist_cond": "filter_by_ume_dist"}

# the reference-parity profile (--set parity=true): every fast-path
# divergence off, reproducing the reference's single-stage semantics
# (evaluate.py:214-296: no triage, no coarse cascade, no consensus,
# kNN-20 correlator, exact per-point var weights, single-stage ICP)
PARITY_PROFILE = {
    "corr_mode": "knn",
    "consensus_cands": 0,
    "corr_triage_src": None,
    "corr_coarse_src": None,
    "corr_var_anchors": None,
    "feat_copy_radius": None,
    "icp_multires": 0,
    "icp_inner": 1,
    "filter_mode": "prob",
    "kp_struct_boost": 0.0,
}


def _coerce_field(tp, val):
    """Coerce a YAML/--set value to a RegistrationConfig field type."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[T]
        inner = [a for a in typing.get_args(tp) if a is not type(None)][0]
        if val is None:
            return None
        v = _coerce_field(inner, val)
        # Optional numerics: 0 disables (YAML has no typed nulls)
        return None if (isinstance(v, (int, float)) and v == 0) else v
    if origin is tuple:
        elem = typing.get_args(tp)[0]
        items = val.split(",") if isinstance(val, str) else list(val)
        return tuple(_coerce_field(elem, x) for x in items)
    if tp is bool:
        if isinstance(val, str):
            return val.strip().lower() in ("1", "true", "yes")
        return bool(val)
    return tp(val)


def _registration_cfg(args) -> RegistrationConfig:
    """The RegistrationConfig of the merged namespace, generated from the
    dataclass fields so every knob is settable (--set <field>=<value>).
    An explicit --set of the canonical spelling wins over the YAML's
    alias; `--set parity=true` applies PARITY_PROFILE for keys the user
    did not set explicitly."""
    hints = typing.get_type_hints(RegistrationConfig)
    explicit = {ov.partition("=")[0].strip()
                for ov in getattr(args, "set", []) or []}
    kw = {}
    for f in fields(RegistrationConfig):
        yaml_name = next((k for k, v in _CFG_ALIASES.items()
                          if v == f.name), f.name)
        if f.name in explicit and hasattr(args, f.name):
            kw[f.name] = _coerce_field(hints[f.name], getattr(args, f.name))
        elif hasattr(args, yaml_name):
            kw[f.name] = _coerce_field(hints[f.name],
                                       getattr(args, yaml_name))
        elif hasattr(args, f.name):
            kw[f.name] = _coerce_field(hints[f.name], getattr(args, f.name))
    if getattr(args, "parity", False):
        for k, v in PARITY_PROFILE.items():
            if k not in explicit and _CFG_ALIASES.get(k, k) not in explicit:
                kw[k] = v
    # reference keypoint-count semantics (evaluate.py:196-204): 10000
    # initial candidates when the UME-distance filter is on, else exactly
    # ume_n_samples, unless the user pinned num_init_keypoints
    if "num_init_keypoints" not in explicit:
        filt = kw.get("filter_by_ume_dist",
                      RegistrationConfig.filter_by_ume_dist)
        kw["num_init_keypoints"] = (10000 if filt
                                    else kw.get("ume_n_samples", 2500))
    return RegistrationConfig(**kw)


def _known_set_keys(yaml_keys) -> set:
    """Every key --set may name: the benchmark YAML keys, RegistrationConfig
    fields (+ aliases), and the CLI-only knobs read via getattr."""
    keys = set(yaml_keys)
    keys |= {f.name for f in fields(RegistrationConfig)}
    keys |= set(_CFG_ALIASES)
    keys |= {"parity", "icp_raw_max_size", "model_checkpoint_path",
             "corr_no_nksr", "out_ch", "seed", "max_pc_size",
             "pc_corr_max_size", "corr_ds", "hungarian_matching_flag",
             "skip_invalid_entries_flag", "data_path", "cache_data_path",
             "split", "dataset"}
    return keys


def _arch_of(params, state, out_channels: int) -> ArchSpec:
    """The one ARCHS entry whose parameter names and shapes the
    (params, bn_state) pytrees hold exactly (each entry's state dict is
    laid out on the meta device: no memory). Refused with the candidates
    named where none or several match."""
    held = {k: tuple(np.shape(v))
            for k, v in {**_flatten(params), **_flatten(state)}.items()}
    found = []
    for name, arch in ARCHS.items():
        with torch.device("meta"):
            want = {k: tuple(t.shape) for k, t in
                    ResUNet(arch, 1, out_channels).state_dict().items()}
        if want == held:
            found.append(name)
    if len(found) != 1:
        raise ValueError(
            f"the checkpoint's {len(held)} parameters match "
            f"{'no' if not found else 'several'} ARCHS entries "
            f"({found or 'none'}) at out_ch={out_channels}; candidates: "
            f"{sorted(ARCHS)}")
    return ARCHS[found[0]]


def _level_caps(sem_cap: int, arch: ArchSpec):
    """Per-level voxel capacities: ResUNetSmall2's five ratios of the SEM
    cap (the JAX CLI's), default_level_capacities for any other arch."""
    if arch == ARCHS["ResUNetSmall2"]:
        return tuple(int(-(-int(sem_cap * r) // 128) * 128)
                     for r in (1.0, 0.75, 0.4, 0.2, 0.08))
    return default_level_capacities(sem_cap, arch)


def _load_model(args, device):
    """(arch, its ResUNet on `device`): the weights of a MinkowskiEngine
    .pth / .pt checkpoint (models/convert.load_torch_checkpoint, taps in
    ME's x-fastest order) or of a .pkl checkpoint, the arch the one whose
    names and shapes they hold (`_arch_of`); a missing path gives a
    ResUNetSmall2 of seeded random parameters ("smoke mode", init_resunet
    from a generator seeded 0: not the JAX CLI's PRNGKey(0) parameters,
    which torch cannot draw)."""
    path = getattr(args, "model_checkpoint_path", "")
    if path and os.path.exists(path):
        if path.endswith((".pth", ".pt")):
            params, state = load_torch_checkpoint(path)
        else:
            blob = load_checkpoint(path)
            params, state = blob["params"], blob["bn_state"]
        arch = _arch_of(params, state, int(args.out_ch))
        model = model_from_params(params, state, arch, device=device,
                                  out_channels=int(args.out_ch))
        print(f"loaded checkpoint: {path}")
    else:
        print(f"checkpoint {path!r} not found -> random init (smoke mode)")
        arch = ARCHS["ResUNetSmall2"]
        model = init_resunet(arch, 1, int(args.out_ch), device=device,
                             generator=torch.Generator(
                                 device=device).manual_seed(0))
    return arch, model


def evaluate_pairs(args, pair_iter, n_pairs: int) -> Dict[str, float]:
    """Core loop over (sem_src, sem_tgt, raw_src, raw_tgt, gt) dicts.

    Host prep (voxelize / pad, numpy only) runs on prefetch threads; the
    main thread does all the device work, one pair at a time, and keeps up
    to MAX_INFLIGHT results on the device before reading them back, so the
    4x4 read of a pair overlaps later pairs' work. The ICP occupancy
    pre-check escalates the window budgets before the pair that needs it
    (pipeline/exactness.py). Returns recall, mean errors, pairs/s (pair 0
    excluded), per-pair seconds split into host prep (making or reading
    the scans, voxelizing, padding: worker threads) and pipeline (the
    main thread's call and the read of its transform) with the transform
    itself, the escalations and, on the card, the peak device memory."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    arch, model = _load_model(args, dev)
    reg_cfg = _registration_cfg(args)
    cell_fine, dims_fine = fine_grid_geometry(reg_cfg)
    occ_stats = {"worst_win": 0, "worst_raw": 0, "box_pts": 0,
                 "box_pairs": 0, "escalations": []}
    sem_cap = int(args.max_pc_size)
    corr_cap = int(args.pc_corr_max_size)
    caps = _level_caps(sem_cap, arch)
    seed = int(args.seed)

    def corr_prep(raw_pts, q, rng):
        # correlator clouds: src @ corr_ds, tgt @ 0.3 (reference hardcode);
        # rows always permuted (the fast paths' first-M-rows subsample)
        _, sel = quantize_np(raw_pts, q)
        p = raw_pts[sel]
        p = p[rng.permutation(len(p))[:corr_cap]]
        buf = np.zeros((corr_cap, 3), np.float32)
        buf[: len(p)] = p
        return buf, np.arange(corr_cap) < len(p)

    # full-resolution ICP polish stage (reference refine_registration,
    # evaluate.py:63-110): the complete raw clouds padded to a static cap
    raw_cap = int(getattr(args, "icp_raw_max_size", 131072))
    use_raw = reg_cfg.icp_raw_iter > 0

    def raw_prep(raw_pts, rng):
        p = raw_pts[rng.permutation(len(raw_pts))[:raw_cap]]
        buf = np.zeros((raw_cap, 3), np.float32)
        buf[: len(p)] = p
        return buf, np.arange(raw_cap) < len(p)

    def timed(it):  # each pair with the seconds its iterator took
        it = iter(it)
        while True:
            t0 = time.perf_counter()
            try:
                pair = next(it)
            except StopIteration:
                return
            yield pair, time.perf_counter() - t0

    def prep_one(idx_pair):
        # numpy only (a worker thread); per-pair seeded generator
        t0 = time.perf_counter()
        idx, (pair, read_s) = idx_pair
        rng = np.random.default_rng(seed * 100003 + idx)
        sp, _, sc, sm = _pad_cloud(*pair["sem_src"], sem_cap, rng)
        tp, _, tc, tm = _pad_cloud(*pair["sem_tgt"], sem_cap, rng)
        cs_p, cs_m = corr_prep(pair["raw_src"], float(args.corr_ds), rng)
        ct_p, ct_m = corr_prep(pair["raw_tgt"], 0.3, rng)
        raws = None
        if use_raw:
            raws = (*raw_prep(pair["raw_src"], rng),
                    *raw_prep(pair["raw_tgt"], rng))
        # exactness telemetry on the ICP target clouds (valid rows only)
        win, box = window_occupancy(ct_p[ct_m], cell_fine, dims_fine)
        raw_win = 0
        if use_raw:
            raw_win, rb = window_occupancy(raws[2][raws[3]], cell_fine,
                                           dims_fine)
            box += rb
        return ((sc, sp, sm, tc, tp, tm, cs_p, cs_m, ct_p, ct_m), raws,
                pair["gt_tform"], (win, raw_win, box),
                read_s + time.perf_counter() - t0)

    rre_list, rte_list, per_pair = [], [], []
    t_start = None
    inflight = []  # (T on the device, gt, pair record)
    MAX_INFLIGHT = 3

    def drain(entry, idx):
        T_dev, gt, rec = entry
        t0 = time.perf_counter()
        T = T_dev.cpu().numpy()
        rec["pipeline_s"] += time.perf_counter() - t0
        tr = np.clip(np.trace(T[:3, :3].astype(np.float64)
                              @ gt[:3, :3].astype(np.float64).T), -1.0, 3.0)
        rre = float(np.degrees(np.arccos((tr - 1.0) / 2.0)))
        rte = float(np.linalg.norm(T[:3, 3] - gt[:3, 3]))
        rre_list.append(rre)
        rte_list.append(rte)
        rec.update(rre_deg=rre, rte_m=rte, finite=bool(np.isfinite(T).all()),
                   T=T.tolist())
        if (idx + 1) % 10 == 0 or idx == n_pairs - 1:
            rr = np.asarray(rre_list)
            tt = np.asarray(rte_list)
            np_r = float(((rr <= 1.5) & (tt <= 0.6)).mean())
            sp_r = float(((rr <= 1.0) & (tt <= 0.1)).mean())
            # steady-state rate: pairs drained since t_start (pair 0 pays
            # the warm-up and is excluded, as in the final summary)
            if t_start is not None and idx > 0:
                rate = idx / max(time.time() - t_start, 1e-9)
                rate_s = f" ({rate:.2f} pairs/s)"
            else:
                rate_s = ""
            print(f"[{idx+1}/{n_pairs}] NP={100*np_r:.2f} SP={100*sp_r:.2f} "
                  f"mRRE={rr.mean():.3f} mRTE={tt.mean():.3f}{rate_s}",
                  flush=True)

    hungarian = bool(getattr(args, "hungarian_matching_flag", False))

    def run_pair(arrays, raws, idx, gen):
        raw = () if raws is None else raws
        if not hungarian:
            return register_pair_e2e(model, caps, reg_cfg, *arrays, *raw,
                                     generator=gen, device=dev)[1]
        # two-phase parity path: device features, host assignment
        (sc, sp, sm, tc, tp, tm, cs_p, cs_m, ct_p, ct_m) = arrays
        sf, tf, csf, ctf = pair_features_e2e(model, caps, *arrays,
                                             device=dev)
        return register_pair_hungarian(
            reg_cfg, sp, sf, sm, tp, tf, tm, cs_p, csf, cs_m, ct_p, ctf,
            ct_m, *raw, rng=np.random.default_rng(seed * 9176 + idx),
            generator=gen, device=dev).T_refined

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n_drained = 0
    for i, item in enumerate(prefetch_map(
            prep_one, enumerate(prefetch(timed(pair_iter), depth=4)),
            workers=4, depth=6)):
        arrays, raws, gt, (win, raw_win, box), prep_s = item
        occ_stats["worst_win"] = max(occ_stats["worst_win"], win)
        occ_stats["worst_raw"] = max(occ_stats["worst_raw"], raw_win)
        if box:
            occ_stats["box_pts"] += box
            occ_stats["box_pairs"] += 1
        # escalate BEFORE running this pair: the exact-query condition
        # (every 3-z-cell window <= budget) must hold for it; budgets only
        # grow
        if win > reg_cfg.icp_budget:
            nb = escalated_budget(win, reg_cfg.icp_budget)
            occ_stats["escalations"].append(
                f"pair {i}: icp_budget {reg_cfg.icp_budget}->{nb} "
                f"(window max {win})")
            print(f"escalated icp_budget -> {nb} (pair {i} window max "
                  f"{win})", flush=True)
            reg_cfg = replace(reg_cfg, icp_budget=nb)
        if raw_win > reg_cfg.icp_raw_budget and use_raw:
            nb = escalated_budget(raw_win, reg_cfg.icp_raw_budget)
            occ_stats["escalations"].append(
                f"pair {i}: icp_raw_budget {reg_cfg.icp_raw_budget}->{nb} "
                f"(raw window max {raw_win})")
            print(f"escalated icp_raw_budget -> {nb} (pair {i} raw window "
                  f"max {raw_win})", flush=True)
            reg_cfg = replace(reg_cfg, icp_raw_budget=nb)
        gen = torch.Generator(device=dev).manual_seed(seed * 100003 + i)
        t0 = time.perf_counter()
        T_ref = run_pair(arrays, raws, i, gen)
        rec = dict(pair=i, prep_s=prep_s,
                   pipeline_s=time.perf_counter() - t0)
        per_pair.append(rec)
        if i == 0:
            # the first pair pays the warm-up: drain it synchronously and
            # start the steady-state clock after
            drain((T_ref, gt, rec), 0)
            n_drained = 1
            t_start = time.time()
            continue
        inflight.append((T_ref, gt, rec))
        if len(inflight) > MAX_INFLIGHT:
            drain(inflight.pop(0), n_drained)
            n_drained += 1
    while inflight:
        drain(inflight.pop(0), n_drained)
        n_drained += 1
    wall = max(time.time() - (t_start or time.time()), 1e-9)

    rr = np.asarray(rre_list)
    tt = np.asarray(rte_list)
    print(f"icp grid occupancy: max_window_count={occ_stats['worst_win']} "
          f"raw={occ_stats['worst_raw']} "
          f"box_overflow_points={occ_stats['box_pts']} "
          f"({occ_stats['box_pairs']} pairs) | final budgets "
          f"icp_budget={reg_cfg.icp_budget} "
          f"icp_raw_budget={reg_cfg.icp_raw_budget}"
          + (f" | escalations: {'; '.join(occ_stats['escalations'])}"
             if occ_stats["escalations"] else ""), flush=True)
    if occ_stats["box_pairs"]:
        print(f"WARNING: {occ_stats['box_pts']} target points across "
              f"{occ_stats['box_pairs']} pairs fell outside the ICP grid "
              f"box (icp_dims {reg_cfg.icp_dims}) and were not "
              f"correspondence candidates; grow icp_dims via "
              f"--set icp_dims=X,Y,Z for full exactness", flush=True)
    out = {
        "np_recall": float(((rr <= 1.5) & (tt <= 0.6)).mean()),
        "sp_recall": float(((rr <= 1.0) & (tt <= 0.1)).mean()),
        "mean_rre": float(rr.mean()),
        "mean_rte": float(tt.mean()),
        "pairs_per_sec": float(max(len(rr) - 1, 1) / wall),
        "n_pairs": len(rr),
        "icp_exactness": dict(occ_stats),
        "per_pair": per_pair,
        "registration_config": reg_cfg,
    }
    if dev.type == "cuda":
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
    return out


def _datasets(args, dataset_size: int = -1):
    """(the evaluated dataset, the raw one) of the benchmark: the first
    reads the SEM cache (or preprocesses the raw scans when
    cache_data_path is empty); the second gives the correlator's clouds,
    from the raw scans when corr_no_nksr is set, without the grid-point
    mapping. dataset_size > 0 keeps the split's first pairs."""
    cls = SemanticKITTIDataset if args.dataset == "kitti" else NuscenesDataset
    kw = dict(data_path=args.data_path, split=args.split,
              cache_data_path=args.cache_data_path,
              skip_invalid_entries=args.skip_invalid_entries_flag,
              dataset_size=dataset_size)
    return (cls(**kw),
            cls(**kw, convert_points_to_grid=False,
                override_cache=bool(args.corr_no_nksr)))


def _dataset_pair_iter(dset, dset_raw):
    """(iterator, count) of the two datasets' pairs in the dict schema of
    _synthetic_pair_iter. Each evaluated cloud's grid points are quantized
    again at 0.3 m, and a row whose voxel an earlier row holds is dropped,
    so points, labels and coords stay row for row (the JAX CLI keeps every
    row beside the fewer coords, and its _pad_cloud then indexes past
    them)."""

    def it():
        for i in range(len(dset)):
            (sp, ss, _, tp, ts_, _, _, gt, _) = dset[i]
            (rsp, _, _, rtp, _, _, _, _, _) = dset_raw[i]
            sc, si = quantize_np(sp, 0.3)
            tc, ti = quantize_np(tp, 0.3)
            yield {
                "sem_src": (sp[si], ss[si], sc),
                "sem_tgt": (tp[ti], ts_[ti], tc),
                "raw_src": rsp, "raw_tgt": rtp, "gt_tform": gt,
            }

    return it(), len(dset)


def _synthetic_pair_iter(args, n: int):
    """n synthetic pairs (seeds seed + i), each scan SEM-equalized to
    60000 points, ground dropped and voxelized at 0.3 m: the JAX CLI's
    pairs, bit for bit (numpy from the same seeds)."""

    def it():
        for i in range(n):
            pair = make_pair(
                SceneConfig(extent=30.0, seed=int(args.seed) + i),
                max_rotation_deg=120, max_translation=8.0,
                seed=int(args.seed) + i)
            sems = []
            for pts, seg in [(pair["src_pts"], pair["src_seg"]),
                             (pair["tgt_pts"], pair["tgt_seg"])]:
                ep, es = equalize_sampling(pts, seg,
                                           SEMConfig(num_points=60000))
                keep = es != 0
                ep, es = ep[keep], es[keep]
                coords, sel = quantize_np(ep, 0.3)
                grid = coords_to_grid_pts_np(ep, coords, 0.3)
                sems.append((grid, es[sel], coords))
            yield {
                "sem_src": sems[0], "sem_tgt": sems[1],
                "raw_src": pair["src_pts"], "raw_tgt": pair["tgt_pts"],
                "gt_tform": pair["gt_tform"],
            }

    return it(), n


def parse_args(argv=None) -> argparse.Namespace:
    """The command line merged over the benchmark's YAML (then --set)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--benchmark", choices=sorted(BENCHMARK_CONFIGS),
                        default="kitti_test")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate N synthetic pairs instead of a dataset")
    parser.add_argument("--set", action="append", default=[],
                        help="override config keys: --set key=value")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                        "versions (default: the card, raises without CUDA)")
    args = parser.parse_args(argv)
    cfg_path = os.path.join(_CFG_DIR, BENCHMARK_CONFIGS[args.benchmark])
    known = _known_set_keys(load_yaml_config(cfg_path).keys())
    bad = [ov.partition("=")[0].strip() for ov in args.set
           if ov.partition("=")[0].strip() not in known]
    if bad:
        raise SystemExit(
            f"unknown --set key(s): {', '.join(bad)}; settable keys are "
            f"the benchmark YAML keys, every RegistrationConfig field, "
            f"and: parity, icp_raw_max_size, model_checkpoint_path, "
            f"corr_no_nksr")
    args = update_namespace_from_yaml(args, cfg_path)
    return apply_overrides(args, args.set)


def main(argv=None):
    from umeregrobust_tpu_torch.utils.cache import ensure_compile_cache

    ensure_compile_cache()
    args = parse_args(argv)
    np.random.seed(int(args.seed))
    print(f"Evaluate {args.dataset} benchmark: {args.benchmark}")
    if getattr(args, "parity", False):
        print(f"parity=true: reference-parity profile {dict(PARITY_PROFILE)} "
              f"(explicit --set keys win)")
    if getattr(args, "hungarian_matching_flag", False):
        print("hungarian_matching_flag=true: using the two-phase "
              "Hungarian parity path (host assignment)")

    if args.synthetic:
        pair_iter, n = _synthetic_pair_iter(args, args.synthetic)
    else:
        pair_iter, n = _dataset_pair_iter(*_datasets(args))
    results = evaluate_pairs(args, pair_iter, n)
    print(f"Evaluate {args.dataset} Benchmark: {args.benchmark} Results:")
    print(f"N.P: {100 * results['np_recall']:.03f} | "
          f"S.P: {100 * results['sp_recall']:.03f}")
    print(f"mRRE: {results['mean_rre']:.03f} | mRTE: {results['mean_rte']:.03f}")
    print(f"throughput: {results['pairs_per_sec']:.3f} pairs/sec")
    return results


if __name__ == "__main__":
    main()
