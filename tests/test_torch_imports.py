"""The port stands alone and never falls back quietly: importing every
module pulls in neither jax nor the JAX package; no source of the port or
of chip_smoke.py imports them; the entry point refuses to run without a
GPU unless asked for the CPU; a kernel wrapper given a non-CPU tensor
raises when the kernel library cannot be built."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import _torch_parity  # noqa: F401  (single-threaded torch)
from umeregrobust_tpu_torch.ops import _build, cuda_corr, cuda_nn, cuda_ume

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "umeregrobust_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_importing_every_module_leaves_jax_out():
    # only the modules the port's imports ADD count (a site hook of the
    # interpreter may have imported anything before)
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'umeregrobust_tpu' or "
            "m.startswith('umeregrobust_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert len(MODULES) >= 25


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+umeregrobust_tpu\b"
    r"|from\s+umeregrobust_tpu(\.|\s+import\b))", re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PKG.rglob("*.py"))
                                        + [ROOT / "chip_smoke.py"]))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _FORBIDDEN.findall((ROOT / path).read_text()), path


def test_entry_point_refuses_to_fall_back_to_the_cpu():
    from umeregrobust_tpu_torch.pipeline.e2e import (
        register_pair_e2e, resolve_device)

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        register_pair_e2e(None, (), _cfg(), *([None] * 10))


def _cfg():
    from umeregrobust_tpu_torch.pipeline.registration import (
        RegistrationConfig)

    return RegistrationConfig()


def test_unported_knobs_raise():
    from umeregrobust_tpu_torch.pipeline.registration import (
        RegistrationConfig, check_supported)

    check_supported(RegistrationConfig())
    for kw in (dict(sr_kpts=64), dict(feat_copy_radius=0.5),
               dict(corr_mode="knn"), dict(filter_by_ume_dist=False),
               dict(icp_inner=1)):
        with pytest.raises(NotImplementedError):
            check_supported(RegistrationConfig(**kw))


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """A process that has no kernel library and cannot build one."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)


def test_load_library_raises_without_nvcc(no_nvcc):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


@pytest.mark.parametrize("call", [
    lambda d: cuda_nn.nn1_argmin(torch.zeros(4, 3, device=d),
                                 torch.zeros(8, 3, device=d),
                                 torch.ones(8, dtype=torch.bool, device=d)),
    lambda d: cuda_ume.ume_moments_fused(
        torch.zeros(4, 3, device=d), torch.zeros(8, 3, device=d),
        torch.zeros(8, 128, device=d),
        torch.ones(8, dtype=torch.bool, device=d), 1.0, 4),
    lambda d: cuda_corr.corr_scores_fused(
        torch.zeros(2, 8, 4, device=d), torch.zeros(8, 32, device=d),
        torch.zeros(16, 4, device=d), torch.zeros(16, 32, device=d)),
], ids=["nn1_argmin", "ume_moments_fused", "corr_scores_fused"])
def test_wrappers_raise_instead_of_falling_back(no_nvcc, call):
    # a non-CPU tensor never takes the plain version: without a kernel
    # library the wrapper raises
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call("meta")
    assert call("cpu").device.type == "cpu"  # CPU tensors: plain version
