"""The work the inputs need, counted by the benchmark from its own
reference (bench_port/portref): each conv layer's valid (out, in, tap)
entries and rows from the reference's kernel maps, and the correlator's
in-radius pairs from the reference's scorer, as operations and bytes, and
from them the least time the card could take (the roofline bound).

A conv layer: operations 2 x entries x Cin x Cout; bytes: each input
row some entry names read once (fp32), the weights once (bf16), each
output row with an entry written once (fp32). The correlator: 2C + 8
operations an in-radius (hypothesis, source, target) triple (the feature
product and the distance), fp32; bytes: each input read once, the scores
written once.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from harness.common import BENCH, load_json

PEAKS = load_json(BENCH / "peaks.json")


def bound_s(ops: float, nbytes: float, flops_peak: float) -> float:
    return max(ops / flops_peak, nbytes / PEAKS["hbm_bytes_per_s"])


def _layer(feats, w, nbr) -> dict:
    from portref.ops.sparse import GroupedMap

    K, cin, cout = w.shape
    if isinstance(nbr, GroupedMap):
        c = nbr.center.to(torch.int64) - 2  # slot s reads row c + s
        rows = [torch.where(nbr.masks[:, s], c + s, -1) for s in range(3)]
        rows.append(torch.where(nbr.patho, c + 1, -1))
        named = torch.cat([r.reshape(-1) for r in rows])
        entries = int(nbr.masks.sum()) + int(nbr.patho.sum())
        out_rows = int((nbr.masks.any(dim=1) | nbr.patho).any(dim=0).sum())
        kind = "grouped"
    else:
        named = nbr.reshape(-1)
        entries = int((nbr >= 0).sum())
        out_rows = int((nbr >= 0).any(dim=0).sum())
        kind = "pertap"
    in_rows = int(torch.unique(named[named >= 0]).numel())
    ops = 2.0 * entries * cin * cout
    nbytes = 4.0 * (in_rows * cin + out_rows * cout) + 2.0 * K * cin * cout
    return {"kind": kind, "K": K, "cin": cin, "cout": cout,
            "entries": entries, "in_rows": in_rows, "out_rows": out_rows,
            "ops": ops, "bytes": nbytes,
            "bound_s": bound_s(ops, nbytes, PEAKS["bf16_flops"])}


def conv_layers(ref_model, geom, in_channels: int) -> List[dict]:
    """Every conv layer of one forward of the reference over `geom`
    (portref.models.resunet.build_unet_geometry), counted, not computed:
    each layer returns zeros, so the pass costs the counting alone."""
    import portref.models.resunet as rn

    rows: List[dict] = []

    def counting(feats, w, nbr, compute_dtype, pairs=1, adjoint=None):
        rows.append(_layer(feats, w, nbr))
        n_out = (nbr.masks.shape[-1] if isinstance(nbr, rn.GroupedMap)
                 else nbr.shape[1])
        return torch.zeros((n_out, w.shape[2]), device=feats.device)

    n0 = geom["levels"][0].mask.shape[0]
    real = rn._conv
    rn._conv = counting
    try:
        with torch.no_grad():
            ref_model._forward(geom, torch.zeros((n0, in_channels),
                                                 device=geom["order0"].device),
                               torch.float32, rn._BN(False, None, 1, {}))
    finally:
        rn._conv = real
    heads = int(geom["levels"][0].mask.sum())
    for mod in (ref_model.mlp1, ref_model.final):
        cin, cout = mod.w.shape
        rows.append({"kind": "dense", "ops": 2.0 * heads * cin * cout,
                     "bytes": 0.0, "bound_s": 0.0, "cin": cin,
                     "cout": cout})
    return rows


def forward_flops(layers: List[dict]) -> float:
    return float(sum(r["ops"] for r in layers))


def training_flops(layers: List[dict]) -> float:
    """Forward, dX and dW of every layer; the stem (the first layer) has no
    dX."""
    return float(sum(r["ops"] for r in layers) * 3 - layers[0]["ops"])


def family_bounds(layers: List[dict], training: bool) -> Dict[str, float]:
    """Summed bounds of the grouped k3 layers and of the per-tap layers:
    forward alone, or in training forward, dX (not the stem's) and dW."""
    out = {"grouped": 0.0, "pertap": 0.0}
    for i, r in enumerate(layers):
        if r["kind"] not in out:
            continue
        n = (3 - (i == 0)) if training else 1
        out[r["kind"]] += n * r["bound_s"]
    return out


@contextlib.contextmanager
def counting_scorer(sink: List[dict]):
    """While open, each call of the reference's radius scorer appends its
    in-radius triples, operations, bytes and bound to `sink`."""
    import portref.pipeline.correlator as corr
    from portref.ops.cuda_corr import _constants
    from portref.ops.neighbors import sqdist3

    real = corr.corr_scores_plain

    def counted(pts_t, src_featw, tgt_pts4, tgt_featw, sigma=1.5,
                radius_factor=2.0, **kw):
        _, r2 = (c.to(pts_t.device) for c in _constants(sigma,
                                                         radius_factor))
        H, S = pts_t.shape[-3:-1]
        T, C = tgt_featw.shape[-2:]
        P = pts_t.reshape(-1, H, S, pts_t.shape[-1])[..., :3].float()
        Q = tgt_pts4.reshape(-1, T, tgt_pts4.shape[-1])[..., :3].float()
        B = P.shape[0]
        hc = max(1, (1 << 26) // max(S * T, 1))  # 256 MiB of d2 at a time
        inside = 0
        for b in range(B):
            for h0 in range(0, H, hc):
                d2 = sqdist3(P[b, h0:h0 + hc], Q[b][None])
                inside += int((d2 <= r2).sum())
        ops = inside * (2.0 * C + 8.0)
        nbytes = 4.0 * B * (H * S * 4 + S * C + T * 4 + T * C + H)
        sink.append({"inside": inside, "ops": ops, "bytes": nbytes,
                     "bound_s": bound_s(ops, nbytes, PEAKS["fp32_flops"])})
        return real(pts_t, src_featw, tgt_pts4, tgt_featw, sigma=sigma,
                    radius_factor=radius_factor, **kw)

    corr.corr_scores_plain = counted
    try:
        yield sink
    finally:
        corr.corr_scores_plain = real
