"""Serving cells: batched registration through the program's
pipeline/e2e.register_pairs_batched, closed loop, one batch after
another for the window.

Set-up makes the traffic file's pool of pairs on worker processes, runs
the ICP window pre-check over it (the evaluate CLI's budget escalation),
loads the network and runs warm-up batches. Each batch takes the pool in
an order drawn from (seed, batch), moves its host arrays to the card
inside the timed call, and gives pair i a generator seeded from (seed,
batch, i). After the window one batch drawn from the seed is judged
against the reference (bench_port/portref): the backbone's features, the
hypotheses' winner T_init from the program's own features, and ICP's
T_refined from the program's own T_init.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import check, counts
from harness.common import (note, percentiles, rng_from, seed_from, smi,
                            worker_map)
from harness.model import PROGRAM, REFERENCE, ControlPrecision, make_model
from gen.pairs import SERVE_KEYS, serve_pair, serve_pool_specs


def escalated_budget(worst_window: int, budget: int) -> int:
    """pipeline/exactness.escalated_budget: the smallest multiple of 8
    covering the worst window (at most 128), or the budget as it is."""
    if worst_window <= budget:
        return int(budget)
    return int(min(-(-worst_window // 8) * 8, 128))


def _reg_kwargs(t: dict, pool: List[dict]) -> dict:
    reg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in t["registration"].items()}
    reg["icp_budget"] = escalated_budget(max(p["win"] for p in pool),
                                         reg.get("icp_budget", 8))
    reg["icp_raw_budget"] = escalated_budget(
        max(p["raw_win"] for p in pool), reg.get("icp_raw_budget", 24))
    return reg


def _caps(t: dict, config: dict):
    n0 = int(t["caps"]["sem"])
    return tuple(int(-(-int(n0 * r) // 128) * 128)
                 for r in config["level_capacity_ratios"])


class Serve:
    def __init__(self, cell, args, dev, clock):
        self.cell, self.args, self.dev, self.clock = cell, args, dev, clock
        t = cell.traffic
        self.B = int(t["batch"])
        self.dtype = getattr(torch, args.control or t["compute_dtype"])
        self.seed = int(args.seed)
        self.pool = worker_map(serve_pair, serve_pool_specs(t),
                               min(len(serve_pool_specs(t)), args.workers))
        self.stacked = {k: np.stack([p[k] for p in self.pool])
                        for k in SERVE_KEYS}
        self.reg = _reg_kwargs(t, self.pool)
        self.caps = _caps(t, cell.config)
        self.source = cell.config["weights"]["serve"]
        self.j = 1 + int(rng_from(self.seed, 7).integers(2))  # judged batch
        note({"phase": "pool", "pairs": len(self.pool),
              "sem_voxels": [int(p["src_mask"].sum()) for p in self.pool],
              "corr_pts": [int(p["corr_src_mask"].sum()) for p in self.pool],
              "raw_pts": [int(p["raw_src_mask"].sum()) for p in self.pool],
              "icp_budget": self.reg["icp_budget"],
              "icp_raw_budget": self.reg["icp_raw_budget"],
              "seconds": self.clock.now()})

    # -- the system under test ------------------------------------------
    def build(self):
        self.control = None
        if self.args.control:
            from portref.pipeline.e2e import register_pairs_batched
            from portref.pipeline.registration import RegistrationConfig

            self.model = make_model(REFERENCE, self.cell.config, self.source,
                                    seed_from(self.seed, 1), self.dev)
            self.control = ControlPrecision().__enter__()
        else:
            from umeregrobust_tpu_torch.pipeline.e2e import (
                register_pairs_batched)
            from umeregrobust_tpu_torch.pipeline.registration import (
                RegistrationConfig)

            self.model = make_model(PROGRAM, self.cell.config, self.source,
                                    seed_from(self.seed, 1), self.dev)
        self.entry = register_pairs_batched
        self.cfg = RegistrationConfig(**self.reg)
        self.capture: Dict[int, torch.Tensor] = {}
        self.batch_no = None
        self.hook = self.model.register_forward_hook(self._keep_features)
        n = 2 * self.B * self.stacked["src_mask"].shape[1]
        c = int(self.cell.config["out_channels"])
        pin = self.dev.type == "cuda"
        self.buf = torch.empty((n, c), dtype=torch.float32, pin_memory=pin)

    def _keep_features(self, module, inputs, out):
        if self.batch_no == self.j:
            self.buf[: out.shape[0]].copy_(out, non_blocking=True)
            self.buf[out.shape[0]:].zero_()
            self.capture[self.j] = self.buf

    def order(self, b: int) -> np.ndarray:
        """Batch b's pairs: group b mod G of the pool (G = pool / batch;
        group g holds every regime's pairs i with i mod G = g, so every
        batch has the same regime mix), in an order drawn from (seed, b);
        a pool smaller than the batch is repeated."""
        G = max(1, len(self.pool) // self.B)
        per = int(self.cell.traffic["per_regime"])
        group = np.array([k for k in range(len(self.pool))
                          if (k % per) % G == b % G])
        group = np.resize(group, max(len(group), self.B))  # a small pool
        return group[rng_from(self.seed, 11, b).permutation(len(group))][
            : self.B]

    def generators(self, b: int):
        return [torch.Generator(device=self.dev).manual_seed(
            seed_from(self.seed, 13, b, i)) for i in range(self.B)]

    def arrays(self, b: int):
        o = self.order(b)
        return [self.stacked[k][o] for k in SERVE_KEYS]

    def batch(self, b: int):
        """One timed batch: its host arrays, the program's call."""
        self.batch_no = b
        arrays = self.arrays(b)
        fault = self.args.fault
        if fault == "half_batch":  # the second half left out
            h = self.B // 2
            Ti, Tr = self.entry(self.model, self.caps, self.cfg,
                                *[a[:h] for a in arrays],
                                compute_dtype=self.dtype,
                                generators=self.generators(b)[:h],
                                device=self.dev)
            return torch.cat([Ti, Ti]), torch.cat([Tr, Tr])
        Ti, Tr = self.entry(self.model, self.caps, self.cfg, *arrays,
                            compute_dtype=self.dtype,
                            generators=self.generators(b), device=self.dev)
        if fault == "altered":  # one answer turned by 2 degrees
            c, s = np.cos(np.radians(2.0)), np.sin(np.radians(2.0))
            R = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                             dtype=Tr.dtype, device=Tr.device)
            Tr = Tr.clone()
            Tr[0, :3, :3] = R @ Tr[0, :3, :3]
        return Ti, Tr

    def warm_up(self):
        for w in range(int(self.cell.traffic["warmup_batches"])):
            self.batch(-1 - w)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- after the window -------------------------------------------------
    def free(self):
        if self.control is not None:
            self.control.__exit__(None, None, None)
        self.hook.remove()
        del self.model, self.entry
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, results, record=None):
        """The judged batch's numbers against the reference; with a traced
        record, the counts its readers need."""
        from portref.models.resunet import build_unet_geometry
        from portref.ops.precision import tf32_off
        from portref.pipeline.correlator import _score
        from portref.pipeline.e2e import _pair_inputs, pair_features_batched
        from portref.pipeline.registration import (
            RegistrationConfig, _hypotheses_and_select, copy_features_to_raw,
            refine_with_icp)

        j, B, dev = self.j, self.B, self.dev
        arrays = self.arrays(j)
        ref = make_model(REFERENCE, self.cell.config, self.source,
                         seed_from(self.seed, 1), dev)
        dtype = getattr(torch, self.cell.traffic["compute_dtype"])
        cfg = RegistrationConfig(**self.reg)
        pair = _pair_inputs(dev, *arrays[:10], add_axis=False)
        raw = [torch.as_tensor(a, device=dev).to(dt) for a, dt in zip(
            arrays[10:], (torch.float32, torch.bool) * 2)]
        (_, sg, sm, _, tg, tm, cs, csm, ct, ctm) = pair
        N = sg.shape[1]
        fp = self.capture[j].to(dev).reshape(B, 2, N, -1)
        with torch.no_grad(), tf32_off():
            sf, tf, _, _ = pair_features_batched(
                ref, self.caps, *arrays[:10], compute_dtype=dtype,
                device=dev)
            feat = 0.0
            for b in range(B):
                for side, (f_ref, m) in enumerate(((sf, sm), (tf, tm))):
                    feat = max(feat, check.rel_gap(fp[b, side][m[b]],
                                                   f_ref[b][m[b]]))
            del sf, tf
            Fs, Ft = fp[:, 0].contiguous(), fp[:, 1].contiguous()
            cs_f = copy_features_to_raw(cs, csm, sg, Fs, sm)
            ct_f = copy_features_to_raw(ct, ctm, tg, Ft, tm)
            scorer: List[dict] = []
            seen: dict = {}
            with counts.counting_scorer(scorer):
                T_init, _, _ = _hypotheses_and_select(
                    cfg, sg, Fs, sm, tg, Ft, tm, cs, cs_f, csm, ct, ct_f, ctm,
                    generators=self.generators(j), draws=[None] * B,
                    seen=seen)
            Ti_p, Tr_p = results[j]
            # the arbiter's own score of the program's pick and of the
            # reference's (its best), on the same structure clouds
            s2 = _score(cfg.corr_mode, *seen["struct"],
                        torch.stack([Ti_p.to(dev), T_init], dim=1),
                        knn_k=cfg.corr_knn, sigma=cfg.corr_kernel_sigma)
            s_prog, s_ref = (s2[:, 0].double().cpu().numpy(),
                             s2[:, 1].double().cpu().numpy())
            s_cand = torch.cat(seen["s_struct"], dim=-1).double().cpu()
            T_ref, _, _ = refine_with_icp(cfg, Ti_p.to(dev), cs, csm, ct,
                                          ctm, *raw)
        ri, ti = check.pose_gaps(Ti_p, T_init)
        rr, tr = check.pose_gaps(Tr_p, T_ref)
        # reported: how far the reference's own arbiter score of the
        # program's pick lies below its best (the reference's pick)
        score_gap = np.maximum(s_ref - s_prog, 0.0) / np.maximum(
            np.abs(s_ref), 1e-30)
        # T_init is held at the batch's third-worst pair: on pairs that
        # both sides misregister the reference ranks several wrong
        # candidates within a few percent, and sum order picks among them
        # (up to two pairs a batch in sound runs); PERF.md section 2
        third = min(3, len(ri))
        order = self.order(j)
        names = list(self.cell.traffic["regimes"])
        per = int(self.cell.traffic["per_regime"])
        gt = np.stack([self.pool[k]["gt"] for k in order])
        values = {"feat_rel_gap": feat,
                  "T_init_rot_deg_3rd": float(np.sort(ri)[-third]),
                  "T_init_trans_m_3rd": float(np.sort(ti)[-third]),
                  "T_init_rot_deg": float(ri.max()),
                  "T_init_trans_m": float(ti.max()),
                  "T_init_score_gap": float(score_gap.max()),
                  "T_init_rot_deg_median": float(np.median(ri)),
                  "T_init_trans_m_median": float(np.median(ti)),
                  "T_refined_rot_deg": float(rr.max()),
                  "T_refined_trans_m": float(tr.max())}
        note({"phase": "judged", "batch": j, **values,
              "T_init_rot_deg_each": ri.tolist(),
              "T_init_trans_m_each": ti.tolist(),
              "T_refined_rot_deg_each": rr.tolist(),
              "pool_pairs": order.tolist(),
              "regimes": [names[k // per] for k in order],
              "score_prog": s_prog.tolist(), "score_ref": s_ref.tolist(),
              "score_gap_each": score_gap.tolist(),
              "cand_scores_top3": torch.topk(s_cand, min(3, s_cand.shape[-1]),
                                             dim=-1).values.tolist(),
              "cand_scores_min": s_cand.min(dim=-1).values.tolist(),
              "gt_rot_deg": {k: check.pose_gaps(T, gt)[0].tolist()
                             for k, T in (("prog_init", Ti_p),
                                          ("ref_init", T_init),
                                          ("prog_refined", Tr_p),
                                          ("ref_refined", T_ref))},
              "gt_trans_m": {k: check.pose_gaps(T, gt)[1].tolist()
                             for k, T in (("prog_init", Ti_p),
                                          ("ref_init", T_init),
                                          ("prog_refined", Tr_p))}})
        if record is not None:
            coords = torch.stack([pair[0], pair[3]], dim=1).clone()
            mask = torch.stack([sm, tm], dim=1)
            cloud = torch.arange(2 * B, dtype=torch.int32,
                                 device=dev).reshape(B, 2, 1)
            coords[..., 0] += cloud * mask
            geom = build_unet_geometry(
                coords.reshape(-1, 4), mask.reshape(-1), ref.arch,
                tuple(2 * c for c in self.caps), pairs=B)
            layers = counts.conv_layers(ref, geom,
                                        self.cell.config["in_channels"])
            fam = counts.family_bounds(layers, training=False)
            record.bound_s["sparse_conv_grouped"] = fam["grouped"]
            record.bound_s["pertap"] = fam["pertap"]
            record.bound_s["corr_scores_fused"] = float(
                sum(s["bound_s"] for s in scorer))
            record.model_flops = counts.forward_flops(layers)
            note({"phase": "counts", "conv_layers": [
                {k: r[k] for k in ("kind", "cin", "cout", "ops")} |
                {k: r.get(k) for k in ("entries", "in_rows", "out_rows",
                                       "bound_s")} for r in layers],
                "scorer_calls": scorer})
        return values

    def run(self, seconds: float, trace: bool):
        """The window. Returns the end-to-end metrics, the traced record,
        and (attempted, failed)."""
        from harness.trace import Session

        self.build()
        self.warm_up()
        setup_s = self.clock.now()
        sync = (lambda: torch.cuda.synchronize(self.dev)) \
            if self.dev.type == "cuda" else (lambda: None)
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        results, per_batch, traced = [], [], None
        sync()
        t0 = time.perf_counter()
        b = 0
        while True:
            tb = time.perf_counter()
            session = Session() if trace and b == self.j else None
            Ti, Tr = self.batch(b)
            if session is not None:
                traced = session.stop()
            results.append((Ti, Tr))
            per_batch.append(time.perf_counter() - tb)
            b += 1
            if time.perf_counter() - t0 >= seconds and b > self.j:
                break
        sync()
        window = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else 0)
        results = [(Ti.cpu(), Tr.cpu()) for Ti, Tr in results]
        Tall = torch.cat([torch.cat([Ti, Tr], dim=1) for Ti, Tr in results])
        failed = int((~torch.isfinite(Tall).flatten(1).all(dim=1)).sum())
        attempted = self.B * len(results)
        note({"phase": "window", "batches": len(results), "seconds": window,
              "batch_s": percentiles(per_batch), "smi": smi()
              if self.dev.type == "cuda" else {}})
        self.free()
        record = traced.record() if traced is not None else None
        if record is not None:
            record.units, record.pairs = 1, self.B
            record.run_window_s, record.run_units = window, len(results)
        e2e = {"pairs_per_s": attempted / window,
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        return e2e, record, attempted, failed, peak, results
