"""The cell's network: its weights made by the benchmark (seeded, on the
card, in one draw) or read from the configuration's checkpoint file,
and put into the program's model and into the reference's alike
(`make_model`)."""
from __future__ import annotations

import hashlib
import importlib
import math
from typing import Dict

import torch

from harness.common import ROOT


def arch_tuple(config: dict):
    """(channels, tr_channels, kernel_sizes, strides, block) as the
    configuration file states them."""
    return (tuple(config["channels"]), tuple(config["tr_channels"]),
            tuple(config["kernel_sizes"]), tuple(config["strides"]),
            config["block"])


def check_file(path: str, sha256: str) -> str:
    full = ROOT / path
    h = hashlib.sha256(full.read_bytes()).hexdigest()
    if h != sha256:
        raise SystemExit(f"{path}: sha256 {h}, the configuration states "
                         f"{sha256}")
    return str(full)


def seeded_state(names_shapes: Dict[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Fresh parameters from one normal draw on `device`: He-normal conv
    and head weights (std sqrt(2 / (k_vol cin))), unit BN scales and
    variances, zero biases and means."""
    g = torch.Generator(device=device).manual_seed(seed)
    ws = [(n, s) for n, s in names_shapes.items() if n.endswith(".w")]
    total = sum(math.prod(s) for _, s in ws)
    draw = torch.randn(total, generator=g, device=device)
    out, o = {}, 0
    for n, s in ws:
        k = math.prod(s)
        out[n] = draw[o:o + k].reshape(s) * math.sqrt(2.0 / math.prod(s[:-1]))
        o += k
    for n, s in names_shapes.items():
        if n in out:
            continue
        fill = 1.0 if n.endswith((".scale", ".var")) else 0.0
        out[n] = torch.full(s, fill, device=device)
    return out


PROGRAM = "umeregrobust_tpu_torch"
REFERENCE = "portref"  # bench_port/portref


def make_model(package: str, config: dict, source: str, seed: int, device):
    """The ResUNet of `package` (PROGRAM or REFERENCE) on `device`: the
    checkpoint's weights or the benchmark's seeded ones. Refused where
    the package's architecture differs from the configuration file."""
    resunet = importlib.import_module(f"{package}.models.resunet")
    arch = resunet.ARCHS[config["arch"]]
    if tuple(arch) != arch_tuple(config):
        raise SystemExit(f"{package}'s {config['arch']} is {tuple(arch)}, "
                         f"the configuration file states "
                         f"{arch_tuple(config)}")
    if source == "seeded":
        with torch.device(device):
            model = resunet.ResUNet(arch, config["in_channels"],
                                    config["out_channels"])
        shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
        model.load_state_dict(seeded_state(shapes, seed, device))
        return model.eval()
    weights = importlib.import_module(f"{package}.models.weights")
    return weights.load_model(check_file(source, config["weights_sha256"]),
                              arch, device=device,
                              in_channels=config["in_channels"],
                              out_channels=config["out_channels"])


class ControlPrecision:
    """The control's precision below the configuration's: while entered,
    the reference's fp32 stages run with TF32 on (the configuration
    states fp32 with TF32 off); its backbone takes the control's dtype
    from the caller."""

    MODULES = ("portref.pipeline.e2e", "portref.train.trainer")

    def __enter__(self):
        import contextlib
        import importlib

        self.saved = []
        for name in self.MODULES:
            mod = importlib.import_module(name)
            self.saved.append((mod, mod.tf32_off))
            mod.tf32_off = contextlib.nullcontext
        self.flags = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return self

    def __exit__(self, *exc):
        for mod, fn in self.saved:
            mod.tf32_off = fn
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.flags
        return False
