#!/usr/bin/env python3
"""Design sweeps of the grouped k3 conv kernel (csrc/sparse_conv_grouped.cu)
and its row order (csrc/grouped_row_order.cu) on one NVIDIA GPU:
`python3 grouped_sweep.py [--plans] [--variants] | --order` from the
repository root.

On ResUNetSmall2's grouped layers (the in-repo weights, the reduced
operating point of data/suite.py): the 18 layers of a one-pair forward,
the same layers of the four regime pairs as one B = 4 forward, and of a
B = 8 training batch (chip_smoke.py's train_batch) the 18 forwards and
the 17 dX over the adjoint maps. For each set it prints one JSON line a
layer and a sum line: the device time alone (CUDA graphs, chip_smoke's
graph_ms) of the kernel at its plan and of the parent tree's kernel
(csrc/bench/sparse_conv_grouped_parent.cu) on the same inputs, each
output checked against its plain version first. --plans also times the
kernel at every cluster size (1-4) and, where Cout > 64, with 64-channel
tiles, and prints the three sums each simple cluster rule would give
(a tile's 9 k_steps ceil(Cout / 64) steps over T a CTA, T in 48 ... 256).
--variants builds copies of the kernel source with one change each (six
stages; `wgmma` kept in flight across steps) into the build directory
and times them beside the library's kernel, turn about. --order runs
the row order alone instead: the grouped maps of the one-pair, B = 4 and
B = 8 training pyramids in one launch each (chip_smoke's
grouped_order_row: checked against the plain version, beside the parent
tree's three launches a map) at clusters of 4, 8 and 16 CTAs a map, turn
about; then the registration path under torch.profiler (chip_smoke's
phase_profile: host and device ms a stage, kernels a pair) at B = 1 (the
four regime pairs one at a time), B = 4 and B = 8 (phase 5d's batches),
with this tree's row order and feature copy and with the parent tree's
(ParentSliceForms), turn about. Times are one card's; compare them
within one call only.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# the kernel source's consumer loop end, and the same with one wgmma
# group kept in flight (the stage before is released once it completes)
_WAIT0 = """      asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
    }
  }"""
_WAIT1 = """      asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
      fence_regs(acc);
      __syncwarp();
      if (lane == 0 && step > 0)
        mbar_arrive(bars + 8 * (kStages + (step - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
    fence_regs(acc);
  }"""
_STAGES6 = [("constexpr int kStages = 4;", "constexpr int kStages = 6;"),
            ("return BN == 128 ? (split ? 1 : 2) : (split ? 2 : 3);",
             "return BN == 128 ? 1 : 2;")]
VARIANTS = {"stages6": _STAGES6, "wgmma_in_flight": [(_WAIT0, _WAIT1)]}


def build_variant(name, edits):
    """The kernel library's grouped conv entries built from a copy of
    csrc/sparse_conv_grouped.cu with `edits` (old, new) applied."""
    from umeregrobust_tpu_torch.ops import _build

    src = (_build.CSRC / "sparse_conv_grouped.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: its edit no longer applies")
        src = src.replace(old, new)
    d = _build.BUILD_DIR / "variants"
    d.mkdir(parents=True, exist_ok=True)
    cu, lib = d / f"grouped_{name}.cu", d / f"libgrouped_{name}.so"
    cu.write_text(src)
    r = subprocess.run(
        [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", str(cu), str(_build.CSRC / "grouped_row_order.cu"),
         str(_build.CSRC / "errors.cu"), "-o", str(lib), "-lcudart"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"variant {name} did not build:\n{r.stdout}")
    cdll = ctypes.CDLL(str(lib))
    for fn in ("umr_sparse_conv_grouped", "umr_grouped_weight_tiles",
               "umr_grouped_row_order"):
        getattr(cdll, fn).argtypes = _build._SIGNATURES[fn]
        getattr(cdll, fn).restype = ctypes.c_int
    cdll.umr_error_string.argtypes = [ctypes.c_int]
    cdll.umr_error_string.restype = ctypes.c_char_p
    return cdll


def layer_calls(layers, dx, dev):
    """(name, Cin, Cout, kernel call, plain call, parent call, dx) of each
    layer: the forward, or with dx the input gradient over the adjoint
    map (seeded dY), as the conv's wrapper runs it."""
    import torch

    from umeregrobust_tpu_torch.ops import cuda_grouped as cg
    from umeregrobust_tpu_torch.ops.sparse import (
        sparse_conv_grouped_dx_plain, sparse_conv_grouped_plain)

    import chip_smoke as cs

    bf, out = torch.bfloat16, []
    g = torch.Generator(device=dev).manual_seed(3)
    for name, f, w, gm, pairs, _, (adj, rev) in layers:
        _, cin, cout = w.shape
        if not dx:
            out.append((name, cin, cout,
                        lambda f=f, w=w, m=gm: cg.sparse_conv_grouped_kernel(
                            f, w, m, None, bf),
                        lambda f=f, w=w, m=gm, p=pairs:
                            sparse_conv_grouped_plain(f, w, m, None, bf, p),
                        lambda f=f, w=w, m=gm: cs.parent_grouped(f, w, m),
                        False))
        elif name != "conv1":  # the stem's input needs no gradient
            y = torch.randn(gm.center.shape[1], cout, generator=g,
                            device=dev)
            out.append((name, cout, cin,
                        lambda y=y, w=w, a=adj, r=rev:
                            cg.sparse_conv_grouped_dx(y, w, a, r, bf),
                        lambda y=y, w=w, a=adj, r=rev, p=pairs:
                            sparse_conv_grouped_dx_plain(y, w, a, r, bf, p),
                        lambda y=y, w=w, a=adj, r=rev: cs.parent_grouped(
                            y, w, a, 2 if r else 1), True))
    return out


def sweep(tag, calls, plans, libs):
    """Time each call at its plan, the parent's kernel and (plans) every
    cluster size and channel tile, (libs) every variant library; one JSON
    line a layer, then the sums."""
    import torch

    from umeregrobust_tpu_torch.ops import _build
    from umeregrobust_tpu_torch.ops import cuda_grouped as cg

    import chip_smoke as cs

    plan0, main, rows = cg.grouped_plan, _build._lib, []
    for name, cin, cout, fn, plain, parent, dx in calls:
        ref = plain()
        got = fn()
        torch.cuda.synchronize()
        # 1e-4 x max |plain| (GROUPED_LIMITS); a dX is rounded to bf16, so
        # also one bf16 ulp of the entry (grouped_bwd_check's rule)
        lim = torch.full_like(ref, 1e-4 * float(ref.abs().max()))
        if dx:
            lim = torch.maximum(lim, torch.ldexp(torch.ones_like(ref),
                                                 torch.frexp(ref)[1] - 8))
        ok = bool(((got - ref).abs() <= lim).all())
        row = dict(set=tag, layer=name, cin=cin, cout=cout, ok=ok,
                   plan=[plan0(1, 1, cin, cout).tile_cols,
                         plan0(1, 1, cin, cout).cluster],
                   kernel_ms=cs.graph_ms(fn, reps=5, inner=10),
                   parent_kernel_ms=cs.graph_ms(parent, reps=5, inner=10))
        if plans:
            cols = [plan0(1, 1, cin, cout).tile_cols]
            cols += [64] if cols[0] == 128 else []
            for n in cols:
                for c in range(1, 5):
                    cg.grouped_plan = (lambda *a, n=n, c=c, **k: plan0(
                        *a, **k)._replace(tile_cols=n, cluster=c))
                    try:
                        row[f"n{n}_cs{c}"] = cs.graph_ms(fn, reps=5, inner=10)
                    finally:
                        cg.grouped_plan = plan0
            for c in range(1, 5):  # at the plan's channel tile
                row[f"cs{c}_ms"] = row[f"n{cols[0]}_cs{c}"]
            row["best_plan_ms"] = min(v for k, v in row.items()
                                      if k.startswith("n") and "_cs" in k)
        for lname, lib in libs.items():
            times = []
            for turn in (lib, main, main, lib):  # variant, main, main, ...
                _build._lib = turn
                try:
                    times.append(cs.graph_ms(fn, reps=5, inner=10))
                finally:
                    _build._lib = main
            row[f"{lname}_ms"] = (times[0] + times[3]) / 2
            row[f"{lname}_main_ms"] = (times[1] + times[2]) / 2
        rows.append(row)
        print(json.dumps(row), flush=True)
    sums = {k: sum(r[k] for r in rows) for k in rows[0] if k.endswith("_ms")}
    if plans:
        def work(r):  # a tile's steps: 9 k_steps ceil(Cout / 64)
            return 9 * -(-3 * (-(-r["cin"] // 8) * 8) // 64) * -(
                -r["cout"] // 64)
        for T in (48, 64, 96, 128, 192, 256):
            sums[f"rule_T{T}_ms"] = sum(
                r[f"cs{min(4, max(1, -(-work(r) // T)))}_ms"] for r in rows)
    print(json.dumps(dict(set=tag, layers=len(rows),
                          ok=all(r["ok"] for r in rows), **sums)),
          flush=True)


class ParentSliceForms:
    """While active, the pyramid orders each map's rows by the parent
    tree's three launches a map (chip_smoke.parent_row_order) and the
    feature stage copies features by the parent tree's three steps
    (chip_smoke.three_step_copy: nn1_argmin, the mask's where,
    gather_padded): the path as it ran before the row order took one
    launch a pyramid and the copy moved into nn1_argmin's merge."""

    def __init__(self, cs):
        self.cs = cs

    def __enter__(self):
        from umeregrobust_tpu_torch.models import resunet
        from umeregrobust_tpu_torch.pipeline import e2e

        cs = self.cs
        self.saved = (resunet.with_row_orders, e2e.copy_features_to_raw)

        def orders(maps):
            return [m if m.order is not None else m._replace(
                **dict(zip(("order", "tiles"), cs.parent_row_order(m))))
                for m in maps]

        def copy(raw_pts, raw_mask, sem_pts, sem_feat, sem_mask):
            return cs.three_step_copy(raw_pts.contiguous(), raw_mask,
                                      sem_pts.contiguous(),
                                      sem_mask.contiguous(), sem_feat)

        resunet.with_row_orders, e2e.copy_features_to_raw = orders, copy
        return self

    def __exit__(self, *exc):
        from umeregrobust_tpu_torch.models import resunet
        from umeregrobust_tpu_torch.pipeline import e2e

        resunet.with_row_orders, e2e.copy_features_to_raw = self.saved


def order_sweep(cs, dev, model, pairs, batch):
    """--order: the row order's cluster sizes on three pyramids, then the
    path's profile with this tree's and the parent tree's forms."""
    import contextlib
    from dataclasses import replace

    import torch

    from umeregrobust_tpu_torch.data.suite import (
        REDUCED, REDUCED_CFG, REGIMES, prep_pair, tuning_seed)
    from umeregrobust_tpu_torch.ops import cuda_grouped
    from umeregrobust_tpu_torch.pipeline.e2e import (
        pair_features_batched, pair_features_e2e, register_pair_e2e,
        register_pairs_batched)
    from umeregrobust_tpu_torch.pipeline.exactness import (
        escalated_budget, fine_grid_geometry, window_occupancy)
    from umeregrobust_tpu_torch.pipeline.registration import (
        RegistrationConfig)
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, _capacities, cloud_features)

    caps = REDUCED["caps"]
    cs.parent_order_library()
    pyramids = {}
    with torch.no_grad():
        for label, build in (
                ("one_pair", lambda: pair_features_e2e(
                    model, caps, *cs.pair_args(pairs[0]), device=dev)),
                ("b4", lambda: pair_features_batched(
                    model, caps, *cs.stacked_args(pairs), device=dev)),
                ("train_b8", lambda: cloud_features(
                    model, batch, _capacities(TrainConfig(), model.arch),
                    torch.bfloat16, train=False))):
            with cs.PyramidMaps() as pyr:
                build()
            pyramids[label] = pyr.lists[0]
    keep = cuda_grouped._ORDER_CLUSTER
    for label, maps in pyramids.items():
        for c in (4, 8, 16, 16, 8, 4):
            cuda_grouped._ORDER_CLUSTER = c
            cs.emit({"sweep": "row_order", **cs.grouped_order_row(label,
                                                                 maps)})
    cuda_grouped._ORDER_CLUSTER = keep
    del pyramids

    # the path under the profiler, this tree's forms and the parent's
    cfg = RegistrationConfig(**REDUCED_CFG)
    more = [prep_pair(tuning_seed(r, 1), r, **REDUCED) for r in REGIMES]
    cell, dims = fine_grid_geometry(cfg)
    for p in pairs + more:
        w, _ = window_occupancy(p["tgt"]["corr_pts"][p["tgt"]["corr_mask"]],
                                cell, dims)
        if w > cfg.icp_budget:
            cfg = replace(cfg, icp_budget=escalated_budget(w,
                                                           cfg.icp_budget))

    def run(p, i):
        g = torch.Generator(device=dev).manual_seed(i)
        return register_pair_e2e(model, caps, cfg, *cs.pair_args(p),
                                 generator=g, device=dev)

    def run_all(ps):
        return lambda: register_pairs_batched(
            model, caps, cfg, *cs.stacked_args(ps), device=dev,
            generators=[torch.Generator(device=dev).manual_seed(i)
                        for i in range(len(ps))])

    for tag, ps in (("b1", pairs), ("b4", pairs), ("b8", pairs + more)):
        for form in ("parent", "slice", "slice", "parent"):
            with (ParentSliceForms(cs) if form == "parent"
                  else contextlib.nullcontext()):
                one = run_all(ps) if tag != "b1" else None
                (one or (lambda: run(ps[0], 0)))()  # warm-up
                cs.phase_profile(run, ps, cfg, None, f"{tag}_{form}",
                                 run_all=one)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", action="store_true",
                    help="also every cluster size and channel tile")
    ap.add_argument("--variants", action="store_true",
                    help="also the kernel source's variants")
    ap.add_argument("--order", action="store_true",
                    help="the row order's cluster sizes and the path's "
                         "profile against the parent's forms, alone")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("grouped_sweep: no CUDA device; it runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from umeregrobust_tpu_torch.data.suite import (
        REDUCED, REGIMES, prep_pair, tuning_seed)
    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.ops import _build
    from umeregrobust_tpu_torch.pipeline.e2e import (
        pair_features_batched, pair_features_e2e)
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, _capacities, batch_to_device, cloud_features)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.smi("name,power.limit"), flush=True)
    _build.load_library()
    cs.parent_grouped_library()
    libs = ({n: build_variant(n, e) for n, e in VARIANTS.items()}
            if args.variants else {})
    pairs = [prep_pair(tuning_seed(r), r, **REDUCED) for r in REGIMES]
    model = load_model(os.path.join(ROOT, "weights", "synthetic_pretrain.pkl"),
                       ARCHS["ResUNetSmall2"], device=dev)
    caps, bf = REDUCED["caps"], torch.bfloat16
    if args.order:
        order_sweep(cs, dev, model, pairs, batch_to_device(
            cs.train_batch(cs.TRAIN_B, 900), dev))
        return 0
    one = cs.capture_grouped_layers(model, lambda: pair_features_e2e(
        model, caps, *cs.pair_args(pairs[0]), device=dev))
    sweep("one_pair", layer_calls(one, False, dev), args.plans, libs)
    del one
    four = cs.capture_grouped_layers(model, lambda: pair_features_batched(
        model, caps, *cs.stacked_args(pairs), device=dev))
    sweep("b4", layer_calls(four, False, dev), args.plans, libs)
    del four
    batch = batch_to_device(cs.train_batch(cs.TRAIN_B, 900), dev)
    eight = cs.capture_grouped_layers(model, lambda: cloud_features(
        model, batch, _capacities(TrainConfig(), model.arch), bf,
        train=True))
    sweep("b8_forward", layer_calls(eight, False, dev), args.plans, libs)
    sweep("b8_dx", layer_calls(eight, True, dev), args.plans, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
