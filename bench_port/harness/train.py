"""Training cells: the program's train step (train/trainer.make_train_step,
the step Trainer.train_step runs) at the traffic file's job, step after
step on the batches made at set-up, in turn.

Set-up makes the batches on worker processes, builds ONE step (model,
optimizer state) with the benchmark's weights, and drives it through its
first steps, one a batch, which are the warm-up and what is judged: the
loss of each of the first three, the first gradient's norm a leaf as
the optimizer holds it after step 1 (Adam's first moment / (1 - b1)),
and each leaf's change after step 3. That same step then runs the
window. After it, the reference (bench_port/portref) follows the same
three steps from the same weights and batches.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from harness import counts
from harness.common import note, percentiles, seed_from, smi, worker_map
from harness.model import ControlPrecision
from gen.pairs import collate, train_sample, train_specs

CHECKED = 3  # steps the reference follows


def train_config(t: dict, config: dict, dtype: str) -> dict:
    """The TrainConfig fields of the traffic file's job on this network."""
    kw = dict(t["job"])
    kw.update(arch=config["arch"], in_channels=config["in_channels"],
              out_channels=config["out_channels"], compute_dtype=dtype,
              batch_size=int(t["batch"]), max_pc_size=int(t["max_pc_size"]),
              num_pw_samples=int(t["num_matches"]),
              level_capacity_ratios=tuple(config["level_capacity_ratios"]))
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def _first_gradients(model, opt, b1: float) -> Dict[str, float]:
    out = {}
    for name, p in model.named_parameters():
        st = opt.state.get(p)
        if st and "mu" in st:
            out[name] = float(torch.linalg.vector_norm(
                st["mu"].double() / (1.0 - b1)))
    return out


def _per_pair_step(mod, cfg, model, opt):
    """The trainer's step (train/trainer.make_train_step) with the batch's
    pairs run one after another, each pair's loss / B back-propagated into
    the same gradients, then one optimizer step: the batch's mean loss and
    gradient (every pair's clouds are their own blocks, with their own BN
    statistics), in memory for one pair."""
    caps = mod._capacities(cfg, model.arch)
    params = list(model.parameters())

    def step(batch):
        opt.zero_grad(set_to_none=False)
        B = batch["src_coords"].shape[0]
        total_loss, pw_loss, states = 0.0, 0.0, []
        with mod.tf32_off():
            for b in range(B):
                sub = {k: v[b:b + 1] for k, v in batch.items()}
                total, metrics, state = mod.pair_losses(model, sub, cfg,
                                                        caps, train=True)
                (torch.sum(total) / B).backward()
                total_loss += float(torch.sum(total.detach())) / B
                pw_loss += float(torch.sum(metrics["pointwise_loss"])) / B
                states.append(state)
            grads = [p.grad for p in params if p.grad is not None]
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            if finite:
                opt.step()
                model.load_bn_state({k: torch.stack([s[k] for s in states])
                                     .mean(0) for k in states[0]})
        return {"total_loss": total_loss, "pointwise_loss": pw_loss,
                "nonfinite_grad": 0.0 if finite else 1.0}
    return step


class Steps:
    """One training step object and the readings of its first steps."""

    def __init__(self, trainer_mod, model, cfg, batches, dev, fault=None,
                 per_pair=False):
        self.mod, self.model, self.dev = trainer_mod, model, dev
        self.cfg = trainer_mod.TrainConfig(**cfg)
        self.opt = trainer_mod.make_optimizer(self.cfg, model.parameters())
        if fault == "unchanged":  # the step leaves the state as it was
            self.opt.step = lambda closure=None: None
        if fault == "half_batch":  # the loss of half the pairs alone
            real = trainer_mod.pair_losses
            h = self.cfg.batch_size // 2

            def half(*a, **k):
                total, metrics, state = real(*a, **k)
                return total[:h], {n: v[:h] for n, v in metrics.items()}, \
                    state
            trainer_mod.pair_losses = half
        if per_pair:
            self.step = _per_pair_step(trainer_mod, self.cfg, model,
                                       self.opt)
        else:
            self.step, _ = trainer_mod.make_train_step(self.cfg, model,
                                                       self.opt)
        self.batches = batches
        self.n = 0

    def one(self) -> dict:
        batch = self.batches[self.n % len(self.batches)]
        m = self.step(self.mod.batch_to_device(batch, self.dev))
        self.n += 1
        return m

    def first(self) -> dict:
        """The first CHECKED steps and their readings."""
        p0 = {n: p.detach().clone() for n, p in
              self.model.named_parameters()}
        losses, pw, grads = [], [], None
        for k in range(CHECKED):
            m = self.one()
            losses.append(m["total_loss"])
            pw.append(m["pointwise_loss"])
            if k == 0:
                grads = _first_gradients(self.model, self.opt,
                                         self.opt.defaults["betas"][0])
        delta = leaf_norms({n: p.detach() - p0[n] for n, p in
                            self.model.named_parameters()})
        del p0
        return {"losses": losses, "pw": pw, "grads": grads, "delta": delta}


def _finite(x: float) -> float:
    return float(x) if np.isfinite(x) else float("inf")


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers: the relative gap of the first step's loss, of its
    pointwise (InfoNCE) term, and the largest of the three steps'; a leaf's first-gradient norm gap and a leaf's
    change gap over the three steps, the worst leaf's and the median
    leaf's (each leaf's gap over its reference norm or the median leaf's,
    whichever is larger; leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change)."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    g_med = float(np.median(list(ref["grads"].values())))
    grad = {k: abs(prog["grads"].get(k, 0.0) - v) / max(v, g_med)
            for k, v in ref["grads"].items()}
    moved = [k for k, v in ref["grads"].items() if v >= 1e-3 * g_med]
    d_med = float(np.median([ref["delta"][k] for k in moved]))
    upd = {k: abs(prog["delta"][k] - ref["delta"][k])
           / max(ref["delta"][k], d_med) for k in moved}
    pw = abs(prog["pw"][0] - ref["pw"][0]) / max(abs(ref["pw"][0]), 1e-30)
    return {"loss1_rel_gap": _finite(losses[0]),
            "pw_loss1_rel_gap": _finite(pw),
            "loss_rel_gap": _finite(max(losses)),
            "grad_norm_gap": _finite(max(grad.values())),
            "grad_norm_gap_median": _finite(np.median(list(grad.values()))),
            "update_norm_gap": _finite(max(upd.values())),
            "update_norm_gap_median": _finite(np.median(list(upd.values()))),
            "_worst": {"grad": sorted(grad.items(), key=lambda kv: -kv[1])[:5],
                       "update": sorted(upd.items(),
                                        key=lambda kv: -kv[1])[:5],
                       "left_out": sorted(set(ref["grads"]) - set(moved))}}


class Train:
    def __init__(self, cell, args, dev, clock):
        self.cell, self.args, self.dev, self.clock = cell, args, dev, clock
        t = cell.traffic
        self.seed = int(args.seed)
        specs = train_specs(t)
        samples = worker_map(train_sample, specs,
                             min(len(specs), args.workers))
        B = int(t["batch"])
        self.batches = [collate(samples[k * B:(k + 1) * B], t,
                                seed_from(self.seed, 21, k))
                        for k in range(int(t["batches"]))]
        self.source = cell.config["weights"]["train"]
        self.dtype = args.control or t["compute_dtype"]
        note({"phase": "batches", "batches": len(self.batches),
              "voxels": [b["src_mask"].sum(1).tolist() for b in self.batches],
              "matches": [b["match_mask"].sum(1).tolist()
                          for b in self.batches],
              "seconds": self.clock.now()})

    def _steps(self, reference: bool, dtype: str, fault=None) -> Steps:
        from harness.model import PROGRAM, REFERENCE, make_model

        if reference:
            import portref.train.trainer as mod
        else:
            import umeregrobust_tpu_torch.train.trainer as mod
        model = make_model(REFERENCE if reference else PROGRAM,
                           self.cell.config, self.source,
                           seed_from(self.seed, 1), self.dev)
        cfg = train_config(self.cell.traffic, self.cell.config, dtype)
        return Steps(mod, model, cfg, self.batches, self.dev, fault,
                     per_pair=reference)

    def run(self, seconds: float, trace: bool):
        """The window (a traced run traces its step 1). Returns the
        end-to-end metrics, the traced record, steps and skipped steps."""
        from harness.trace import Session

        control = ControlPrecision().__enter__() if self.args.control \
            else None
        self.steps = self._steps(bool(self.args.control), self.dtype,
                                 self.args.fault)
        self.first = self.steps.first()
        for _ in range(int(self.cell.traffic["warmup_steps"]) - CHECKED):
            self.steps.one()
        setup_s = self.clock.now()
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        traced = 1 if trace else None
        per_step, skipped, session = [], 0, None
        t0 = time.perf_counter()
        k = 0
        while True:
            ts = time.perf_counter()
            if k == traced:
                self.traced_batch = self.steps.n % len(self.batches)
                session = Session()
            m = self.steps.one()
            if k == traced:
                session.stop()
            skipped += int(m["nonfinite_grad"])
            per_step.append(time.perf_counter() - ts)
            k += 1
            if time.perf_counter() - t0 >= seconds and (traced is None
                                                        or k > traced):
                break
        if cuda:
            torch.cuda.synchronize(self.dev)
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(self.dev) if cuda else 0
        note({"phase": "window", "steps": k, "seconds": window,
              "step_s": percentiles(per_step), "nonfinite_steps": skipped,
              "first_losses": self.first["losses"],
              "smi": smi() if cuda else {}})
        del self.steps
        if control is not None:
            control.__exit__(None, None, None)
        if cuda:
            torch.cuda.empty_cache()
        record = session.record() if session is not None else None
        if record is not None:
            record.units, record.pairs = 1, 0
            record.run_window_s, record.run_units = window, k
        e2e = {"step_ms": 1e3 * window / k, "peak_mem_gib": peak / 2 ** 30,
               "setup_s": setup_s}
        return e2e, record, k, skipped, peak, None

    def judge(self, results, record=None):
        ref = self._steps(True, self.cell.traffic["compute_dtype"]).first()
        values = compare(self.first, ref)
        note({"phase": "judged", **values,
              "losses": self.first["losses"], "ref_losses": ref["losses"]})
        values.pop("_worst")
        if record is not None:
            self._counts(record)
        return values

    def _counts(self, record):
        """The traced step's conv layers, counted on the reference's
        geometry of its batch (the trainer's cloud layout)."""
        from harness.model import REFERENCE, make_model
        from portref.models.resunet import build_unet_geometry
        import portref.train.trainer as mod

        ref = make_model(REFERENCE, self.cell.config, self.source, 0,
                         self.dev)
        cfg = mod.TrainConfig(**train_config(self.cell.traffic,
                                             self.cell.config, "float32"))
        bt = mod.batch_to_device(self.batches[self.traced_batch], self.dev)
        B = bt["src_coords"].shape[0]
        mask = torch.stack([bt["src_mask"], bt["tgt_mask"]], dim=1)
        coords = torch.stack([bt["src_coords"], bt["tgt_coords"]],
                             dim=1).clone()
        cloud = torch.arange(2 * B, dtype=torch.int32,
                             device=self.dev).reshape(B, 2, 1)
        coords[..., 0] = torch.where(mask, 2 * cloud, coords[..., 0])
        geom = build_unet_geometry(coords.reshape(-1, 4), mask.reshape(-1),
                                   ref.arch, mod._capacities(cfg, ref.arch),
                                   pairs=2 * B)
        layers = counts.conv_layers(ref, geom, self.cell.config["in_channels"])
        fam = counts.family_bounds(layers, training=True)
        record.bound_s["sparse_conv_grouped"] = fam["grouped"]
        record.bound_s["pertap"] = fam["pertap"]
        record.model_flops = counts.training_flops(layers)
