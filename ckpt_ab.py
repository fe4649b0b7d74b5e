#!/usr/bin/env python3
"""Two ResUNetSmall2 checkpoints on the eight synthetic tuning pairs
tuning_seed(regime, i), i in {0, 1} (data/suite.py), at the reduced
operating point (REDUCED, REDUCED_CFG; ICP's budget escalated to cover
every pair's windows, as chip_smoke.py phase 5d does), turn about on
each pair (A, B, B, A, one seed a pair): per pair and checkpoint the
RRE / RTE and the NP (1.5 deg, 0.6 m) / SP (1 deg, 0.1 m) verdicts and
the seconds of each run (host clock round a synchronize), whether each
checkpoint's two runs gave the same transform, and each checkpoint's NP /
SP recall. One JSON line a pair, then a summary line.

    python3 ckpt_ab.py --b build/synth_900.pkl \
        [--a weights/synthetic_pretrain.pkl]
"""
import argparse
import json
import sys
import time
from dataclasses import replace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", default="weights/synthetic_pretrain.pkl")
    ap.add_argument("--b", required=True)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from umeregrobust_tpu_torch.core.transforms import relative_rotation_error
    from umeregrobust_tpu_torch.data.suite import (
        REDUCED, REDUCED_CFG, REGIMES, prep_pair, tuning_seed)
    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.pipeline.e2e import register_pair_e2e
    from umeregrobust_tpu_torch.pipeline.exactness import (
        escalated_budget, fine_grid_geometry, window_occupancy)
    from umeregrobust_tpu_torch.pipeline.registration import (
        RegistrationConfig)

    if not torch.cuda.is_available():
        print("ckpt_ab: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = RegistrationConfig(**REDUCED_CFG)
    cell, dims = fine_grid_geometry(cfg)
    pairs = [(r, i, prep_pair(tuning_seed(r, i), r, **REDUCED))
             for i in (0, 1) for r in REGIMES]
    for _, _, p in pairs:
        w, box = window_occupancy(
            p["tgt"]["corr_pts"][p["tgt"]["corr_mask"]], cell, dims)
        if box != 0:
            raise RuntimeError("ICP grid does not cover the pairs' clouds")
        if w > cfg.icp_budget:
            cfg = replace(cfg, icp_budget=escalated_budget(w, cfg.icp_budget))
    models = {k: load_model(path, ARCHS["ResUNetSmall2"], device=dev)
              for k, path in (("a", args.a), ("b", args.b))}
    sync = torch.cuda.synchronize

    def register(model, p, seed):
        s, t = p["src"], p["tgt"]
        g = torch.Generator(device=dev).manual_seed(seed)
        sync()
        t0 = time.time()
        _, T = register_pair_e2e(
            model, REDUCED["caps"], cfg, s["coords"], s["grid"], s["mask"],
            t["coords"], t["grid"], t["mask"], s["corr_pts"], s["corr_mask"],
            t["corr_pts"], t["corr_mask"], generator=g, device=dev)
        sync()
        return T.double().cpu(), time.time() - t0

    register(models["a"], pairs[0][2], 0)  # warm-up
    rows = []
    for n, (regime, i, p) in enumerate(pairs):
        runs = {"a": [], "b": []}
        for k in ("a", "b", "b", "a"):
            runs[k].append(register(models[k], p, n))
        gt = torch.as_tensor(p["gt"], dtype=torch.float64)
        row = dict(pair=n, regime=regime, i=i, seed=tuning_seed(regime, i))
        for k, ((T, s1), (T2, s2)) in runs.items():
            rre = float(relative_rotation_error(gt[:3, :3], T[:3, :3]))
            rte = float(torch.linalg.vector_norm(T[:3, 3] - gt[:3, 3]))
            row[k] = dict(rre_deg=rre, rte_m=rte,
                          np_pass=rre <= 1.5 and rte <= 0.6,
                          sp_pass=rre <= 1.0 and rte <= 0.1,
                          seconds=[s1, s2], repeat_identical=bool(
                              torch.equal(T, T2)),
                          finite=bool(torch.isfinite(T).all()))
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({
        "summary": True, "pairs": len(rows), "icp_budget": cfg.icp_budget,
        **{k: dict(path=path,
                   np_recall=float(np.mean([r[k]["np_pass"] for r in rows])),
                   sp_recall=float(np.mean([r[k]["sp_pass"] for r in rows])),
                   repeat_identical=all(r[k]["repeat_identical"]
                                        for r in rows))
           for k, path in (("a", args.a), ("b", args.b))}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
