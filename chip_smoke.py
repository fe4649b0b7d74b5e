#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (umeregrobust_tpu_torch) on one
NVIDIA GPU: `python3 chip_smoke.py` from the repository root.

Phases (any failure ends the run with a non-zero exit):
  1. device: requires CUDA, turns TF32 off, prints the card's name and
     power limit;
  2. build: compiles the port's CUDA kernels (csrc/*.cu) with nvcc;
  3. kernels: on a real suite pair's clouds, at the main path's shapes,
     each kernel against its plain PyTorch version (nn1_argmin: identical
     indices; ume_moments_fused: max abs error <= 1e-5 x max |out|;
     corr_scores_fused: max abs error <= 1e-4 x max |score| and the same
     argmax at every stage's shape), with CUDA-event times (median of 20
     after warm-up) of kernel, plain version and, where one PyTorch call
     computes the same function, that call; and each kernel's bound;
  4. reference: the small pair through the whole path on the card and on
     the CPU (plain versions) with the same injected draws: the same
     transforms;
  5. end to end: one pair per regime of the reduced operating point
     (bench.py's suite, tuning seeds 100 + 37 r), through
     register_pair_e2e with the in-repo weights after the ICP occupancy
     pre-check and a warm-up pair: RRE/RTE and kernel launches per pair,
     pairs/s, peak device memory; the nominal pair must pass NP
     (RRE <= 1.5 deg, RTE <= 0.6 m);
  6. profile (only with --profile): the same pairs, seeds and config
     again under torch.profiler: per pipeline stage (register_pair_e2e's
     record_function ranges) host ms and the device ms of the kernels
     inside it, device busy ms, the idle share of the profiled wall and,
     as an estimate combining two runs, of phase 5's unprofiled wall;
     kernel launches and the top ops by device time.
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
HBM_BW = 3.35e12  # H100 SXM HBM3 bytes/s
KERNELS = {  # name -> (source, replaced TPU kernel)
    "nn1_argmin": ("umeregrobust_tpu_torch/csrc/nn1_argmin.cu",
                   "umeregrobust_tpu/ops/pallas_nn.py:63"),
    "ume_moments_fused": ("umeregrobust_tpu_torch/csrc/ume_moments.cu",
                          "umeregrobust_tpu/ops/pallas_ume.py:101"),
    "corr_scores_fused": ("umeregrobust_tpu_torch/csrc/corr_scores.cu",
                          "umeregrobust_tpu/ops/pallas_corr.py:91"),
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of fn() in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes, n_ops):
    t_b, t_o = n_bytes / HBM_BW * 1e3, n_ops / F32_PEAK * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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
    out["nn1_argmin"] = dict(
        shape=f"{M}x{N}", max_abs_err=float(mism), mismatches=mism,
        ok=mism == 0,
        ms=time_ms(lambda: cuda_nn.nn1_argmin(q, p, pm)),
        plain_ms=time_ms(lambda: cuda_nn.nn1_argmin_plain(q, p, pm)),
        library_ms=time_ms(lambda: torch.cdist(q, parked).argmin(1)),
        bound_ms=bb, bound_by=by)

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
    tested = selected = 0
    for c0 in range(0, kp.shape[0], 256):
        ok = (sqdist3(kp[c0:c0 + 256], p) <= r * r) & pm[None]
        cum = torch.cumsum(ok.int(), 1)
        full = cum[:, -1] >= cap
        first = torch.argmax((cum >= cap).int(), 1) + 1
        tested += int(torch.where(full, first, torch.full_like(first, N)).sum())
        selected += int(torch.clamp(cum[:, -1], max=cap).sum())
    Mk = kp.shape[0]
    bb, by = bound_ms(N * 512 + N * 13 + Mk * 12 + Mk * 512,
                      tested * 9 + selected * 128)
    out["ume_moments_fused"] = dict(
        shape=f"{Mk}x{N}", max_abs_err=err, scale=scale,
        ok=err <= 1e-5 * scale,
        ms=time_ms(lambda: cuda_ume.ume_moments_fused(kp, p, Z, pm, r, cap)),
        plain_ms=time_ms(lambda: cuda_ume.ume_moments_plain(kp, p, Z, pm, r,
                                                            cap)),
        library_ms=None, bound_ms=bb, bound_by=by)

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
    r2 = (2.0 * cfg.corr_kernel_sigma) ** 2
    for name, args in inputs.items():
        a = cuda_corr.corr_scores_fused(*args, sigma=cfg.corr_kernel_sigma)
        b = cuda_corr.corr_scores_plain(*args, sigma=cfg.corr_kernel_sigma)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        ok = err <= 1e-4 * float(b.abs().max()) and int(a.argmax()) == int(
            b.argmax())
        pts_t, sf, tp4, tf = args
        H, Sn, _ = pts_t.shape
        Tn = tp4.shape[0]
        n_in = sum(int((sqdist3(pts_t[h0:h0 + 16, :, :3], tp4[:, :3]) <= r2
                        ).sum()) for h0 in range(0, H, 16))
        bb, by = bound_ms(H * Sn * 16 + Sn * 128 + Tn * 16 + Tn * 128 + H * 4,
                          H * Sn * Tn * 9 + Sn * Tn * 64 + n_in * 5)
        per_stage[name] = dict(
            shape=f"{H}x{Sn}x{Tn}", max_abs_err=err, ok=ok,
            argmax=int(a.argmax()),
            ms=time_ms(lambda: cuda_corr.corr_scores_fused(
                *args, sigma=cfg.corr_kernel_sigma)),
            plain_ms=time_ms(lambda: cuda_corr.corr_scores_plain(
                *args, sigma=cfg.corr_kernel_sigma), reps=10),
            bound_ms=bb, bound_by=by, in_radius=n_in)
        ok_all &= ok
        err_all = max(err_all, err)
    tot = {k: sum(v[k] for v in per_stage.values())
           for k in ("ms", "plain_ms", "bound_ms")}
    by = max(per_stage.values(), key=lambda v: v["bound_ms"])["bound_by"]
    out["corr_scores_fused"] = dict(
        shape="per pair: " + ", ".join(f"{k} {v['shape']}"
                                       for k, v in per_stage.items()),
        max_abs_err=err_all, ok=ok_all, library_ms=None, bound_by=by,
        stages=per_stage, **tot)
    return out


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


def phase_profile(run, pairs, cfg, unprofiled_wall_s):
    """The e2e pairs again under torch.profiler (same seeds and config)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    stages = ("geometry", "forward", "feat_to_raw", "hypotheses", "icp")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
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
        emit({"phase": "profile", "stage": name,
              "host_ms_per_pair_profiled": v["host_ms"] / n,
              "device_ms_per_pair": v["device_ms"] / n})
    unprof_ms = unprofiled_wall_s * 1e3
    emit({"phase": "profile_summary", "pairs": n,
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
        emit({"phase": "profile_op", "op": a.key[:80],
              "count_per_pair": a.count / n,
              "device_ms_per_pair": a.self_device_time_total / 1e3 / n})


def main() -> int:
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
    from umeregrobust_tpu_torch.ops import _build, cuda_corr, cuda_nn, cuda_ume
    from umeregrobust_tpu_torch.pipeline.e2e import register_pair_e2e
    from umeregrobust_tpu_torch.pipeline.exactness import (
        escalated_budget, fine_grid_geometry, window_occupancy)
    from umeregrobust_tpu_torch.pipeline.registration import (
        RegistrationConfig)

    t_start = time.time()
    # --- 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # --- 2. build
    t0 = time.time()
    _build.load_library()
    emit({"phase": "build", "seconds": time.time() - t0,
          "library": os.path.relpath(str(_build.build_library()), ROOT)})

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
    for name, res in kern.items():
        emit({"kernel": name, **res})

    # --- 4. reference on a small input
    cfg_small = RegistrationConfig(
        num_init_keypoints=256, ume_n_samples=64, ume_max_nn=128,
        corr_coarse_src=None, corr_rescore_top=16, icp_max_corr=0.5,
        icp_max_iter=15, filter_mode="topk")
    ref = phase_reference(dev, model, load_model(
        weights, ARCHS["ResUNetSmall2"]), cfg_small)
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

    def run(p, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        s, tg = p["src"], p["tgt"]
        return register_pair_e2e(
            model, REDUCED["caps"], cfg, s["coords"], s["grid"], s["mask"],
            tg["coords"], tg["grid"], tg["mask"], s["corr_pts"],
            s["corr_mask"], tg["corr_pts"], tg["corr_mask"], generator=g,
            device=dev)

    run(pairs[0], 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods = {"nn1_argmin": cuda_nn, "ume_moments_fused": cuda_ume,
            "corr_scores_fused": cuda_corr}
    for m in mods.values():
        m.LAUNCHES = 0
    wall, results = 0.0, []
    for i, (name, p) in enumerate(zip(names, pairs)):
        before = {k: m.LAUNCHES for k, m in mods.items()}
        torch.cuda.synchronize()
        t0 = time.time()
        _, T = run(p, i)
        torch.cuda.synchronize()
        dt = time.time() - t0
        wall += dt
        launches = {k: m.LAUNCHES - before[k] for k, m in mods.items()}
        T = T.double().cpu()
        gt = torch.as_tensor(p["gt"], dtype=torch.float64)
        rre = float(relative_rotation_error(gt[:3, :3], T[:3, :3]))
        rte = float(torch.linalg.vector_norm(T[:3, 3] - gt[:3, 3]))
        res = dict(pair=i, regime=name, seed=tuning_seed(name), rre_deg=rre,
                   rte_m=rte, np_pass=rre <= 1.5 and rte <= 0.6,
                   sp_pass=rre <= 1.0 and rte <= 0.1, seconds=dt,
                   launches=launches, finite=bool(torch.isfinite(T).all()))
        emit({"phase": "e2e", **res})
        results.append(res)
    total_launches = {k: m.LAUNCHES for k, m in mods.items()}
    emit({"phase": "e2e_summary", "pairs": len(results),
          "pairs_per_s": len(results) / wall, "wall_s": wall,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "np_recall": float(np.mean([r["np_pass"] for r in results])),
          "sp_recall": float(np.mean([r["sp_pass"] for r in results])),
          "seconds_total": time.time() - t_start})
    if args.profile:
        phase_profile(run, pairs, cfg, wall)

    failures = [f"kernel {k}" for k, v in kern.items() if not v["ok"]]
    if not ref["ok"]:
        failures.append("reference: card and CPU transforms differ")
    for r in results:
        lc = r["launches"]
        if not (lc["nn1_argmin"] == 2 and lc["ume_moments_fused"] == 2
                and lc["corr_scores_fused"] >= 3):
            failures.append(f"pair {r['pair']}: launches {lc}")
        if not r["finite"]:
            failures.append(f"pair {r['pair']}: non-finite transform")
    if not results[0]["np_pass"]:
        failures.append("nominal pair fails NP")

    rows = []
    for name, (src, rep) in KERNELS.items():
        k = kern[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=total_launches[name], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            shape=k["shape"], status="ok" if k["ok"] else "failed"))
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
