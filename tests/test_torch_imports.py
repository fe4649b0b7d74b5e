"""The port stands alone and never falls back quietly: importing every
module pulls in neither jax nor the JAX package; no source of the port or
of chip_smoke.py imports them; the entry point refuses to run without a
GPU unless asked for the CPU; a kernel wrapper given a non-CPU tensor
raises when the kernel library cannot be built; every kernel that
chip_smoke.py lists has its CUDA source and its C entry point."""
import importlib.util
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import _torch_parity  # noqa: F401  (single-threaded torch)
from umeregrobust_tpu_torch.ops import (
    _build, cuda_conv, cuda_corr, cuda_gather, cuda_grouped, cuda_nn, cuda_ume)
from umeregrobust_tpu_torch.ops.neighbors import gather_padded
from umeregrobust_tpu_torch.ops.sparse import (
    GroupedMap, sparse_conv, sparse_conv_grouped)

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
    assert len(MODULES) >= 40
    for new in ("ops.cuda_gather", "ops.cuda_conv", "devices",
                "cli.evaluate", "utils.config", "utils.prefetch"):
        assert f"umeregrobust_tpu_torch.{new}" in MODULES


# the JAX package's modules the port has no counterpart of yet: none
UNPORTED = []
# the Pallas kernels' modules are the CUDA kernels' wrappers in the port
PORTED_AS = {"ops.pallas_corr": "ops.cuda_corr", "ops.pallas_nn": "ops.cuda_nn",
             "ops.pallas_ume": "ops.cuda_ume"}


def test_only_the_listed_modules_are_still_unported():
    jax_pkg = ROOT / "umeregrobust_tpu"
    jax_mods = {".".join(p.relative_to(jax_pkg).with_suffix("").parts
                         ).removesuffix(".__init__")
                for p in jax_pkg.rglob("*.py")} - {"__init__"}
    port = {m.removeprefix("umeregrobust_tpu_torch.") for m in MODULES}
    missing = {m for m in jax_mods - port if PORTED_AS.get(m) not in port}
    assert sorted(missing) == UNPORTED


@pytest.mark.parametrize("mod", [
    "losses", "losses.losses", "pipeline.train_keypoints",
    "pipeline.eval_metrics", "train", "train.trainer", "train.checkpoint",
    "train.optim", "cli.train_coloring"])
def test_the_training_modules_are_ported(mod):
    assert f"umeregrobust_tpu_torch.{mod}" in MODULES


# the modules of the data layer, the SEM CLI and the exporter run on the
# host with numpy and scipy, as in the JAX package
HOST_ONLY = ["data.laserscan", "data.registry", "data.matching_host",
             "data.sem", "data.datasets", "data.collate",
             "data.sem_preprocess", "data.nuscenes_export",
             "cli.sem_preprocessing", "native"]


@pytest.mark.parametrize("mod", HOST_ONLY + [
    "models.convert", "pipeline.rtume", "pipeline.keypoint_samplers",
    "parallel", "parallel.mesh", "parallel.points_sharded", "ops.gridnn",
    "ops.hashing", "ops.precision", "utils.cache", "utils.profiling"])
def test_every_ported_module_is_there(mod):
    assert f"umeregrobust_tpu_torch.{mod}" in MODULES


def test_host_only_modules_leave_torch_out():
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {HOST_ONLY!r}: "
            "importlib.import_module('umeregrobust_tpu_torch.' + m)\n"
            "bad = [m for m in set(sys.modules) - before if m == 'torch' or "
            "m.startswith(('torch.', 'jax', 'umeregrobust_tpu.'))]\n"
            "assert not bad, sorted(bad)[:20]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_the_port_reads_no_file_of_the_jax_package():
    # its metadata and configs are its own copies
    from umeregrobust_tpu_torch.data import registry

    assert pathlib.Path(registry._META_DIR).resolve() == \
        PKG / "data" / "metadata"
    for p in PKG.rglob("*.py"):
        assert "umeregrobust_tpu/data/metadata" not in p.read_text(), p


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


@pytest.mark.parametrize("make", ["load_model", "init_resunet"])
def test_model_constructors_default_to_the_card(make):
    from umeregrobust_tpu_torch.models.resunet import ARCHS, init_resunet
    from umeregrobust_tpu_torch.models.weights import load_model

    weights = str(ROOT / "weights" / "synthetic_pretrain.pkl")
    build = {"load_model": lambda **kw: load_model(
                 weights, ARCHS["ResUNetSmall2"], **kw),
             "init_resunet": lambda **kw: init_resunet(
                 ARCHS["ResUNetSmall2"], 1, 32, **kw)}[make]
    model = build(device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def _cfg():
    from umeregrobust_tpu_torch.pipeline.registration import (
        RegistrationConfig)

    return RegistrationConfig()


@pytest.mark.parametrize("kw", [
    dict(sr_kpts=64), dict(feat_copy_radius=0.5), dict(corr_mode="knn"),
    dict(filter_by_ume_dist=False), dict(icp_inner=1),
    dict(filter_mode="nope")], ids=lambda kw: next(iter(kw)))
def test_check_supported_accepts_every_ported_knob(kw):
    from umeregrobust_tpu_torch.pipeline.registration import (
        RegistrationConfig, check_supported)

    check_supported(RegistrationConfig())
    if kw.get("filter_mode") == "nope":
        with pytest.raises(ValueError, match="filter_mode"):
            check_supported(RegistrationConfig(**kw))
    else:
        check_supported(RegistrationConfig(**kw))


def test_cli_reads_only_its_own_configs():
    from umeregrobust_tpu_torch.cli import evaluate

    cfg_dir = pathlib.Path(evaluate._CFG_DIR).resolve()
    assert cfg_dir == PKG / "configs"
    for rel in evaluate.BENCHMARK_CONFIGS.values():
        assert (cfg_dir / rel).is_file(), rel
    for p in PKG.rglob("*.py"):
        assert "umeregrobust_tpu/configs" not in p.read_text(), p


def _grouped_map(d, n_out=8):
    """A GroupedMap of n_out rows whose windows are all unused."""
    return GroupedMap(
        center=torch.zeros((9, n_out), dtype=torch.int64, device=d),
        masks=torch.zeros((9, 3, n_out), dtype=torch.bool, device=d),
        patho=torch.zeros((9, n_out), dtype=torch.bool, device=d),
        worder=torch.arange(3, device=d))


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
    lambda d: cuda_ume.ume_moments_fused(
        torch.zeros(4, 3, device=d), torch.zeros(8, 3, device=d),
        torch.zeros(8, 128, device=d),
        torch.ones(8, dtype=torch.bool, device=d), 1.0, 4,
        caps=torch.full((4,), 2, dtype=torch.int32, device=d)),
    lambda d: cuda_corr.corr_scores_fused(
        torch.zeros(2, 8, 4, device=d), torch.zeros(8, 32, device=d),
        torch.zeros(16, 4, device=d), torch.zeros(16, 32, device=d)),
    lambda d: cuda_gather.gather_rows(
        torch.zeros(8, 4, device=d), torch.zeros(5, dtype=torch.int64,
                                                 device=d)),
    lambda d: gather_padded(torch.zeros(8, 4, device=d),
                            torch.zeros((5, 2), dtype=torch.int64, device=d)),
    lambda d: cuda_conv.sparse_conv_rowtile(
        torch.zeros(8, 4, device=d), torch.zeros(27, 4, 6, device=d),
        torch.zeros((27, 8), dtype=torch.int64, device=d)),
    lambda d: cuda_conv.sparse_conv_tapsplit(
        torch.zeros(8, 4, device=d), torch.zeros(27, 4, 6, device=d),
        torch.zeros((27, 8), dtype=torch.int64, device=d)),
    lambda d: sparse_conv(
        torch.zeros(8, 4, device=d), torch.zeros(125, 4, 6, device=d),
        torch.zeros((125, 8), dtype=torch.int64, device=d),
        compute_dtype=torch.bfloat16),
    lambda d: cuda_conv.conv_entries(
        torch.zeros((27, 8), dtype=torch.int64, device=d), 8).cnt,
    lambda d: cuda_gather.gather_rows_backward(
        torch.zeros(5, 4, device=d), torch.zeros(5, dtype=torch.int64,
                                                 device=d), 8),
    lambda d: cuda_conv.sparse_conv_wgrad(
        torch.zeros(8, 4, device=d), torch.zeros(8, 6, device=d),
        torch.zeros((27, 8), dtype=torch.int64, device=d)),
    lambda d: cuda_grouped.sparse_conv_grouped_kernel(
        torch.zeros(8, 4, device=d), torch.zeros(27, 4, 6, device=d),
        _grouped_map(d), compute_dtype=torch.bfloat16),
    lambda d: sparse_conv_grouped(
        torch.zeros(8, 4, device=d), torch.zeros(27, 4, 6, device=d),
        _grouped_map(d)),
    lambda d: cuda_grouped.sparse_conv_grouped_wgrad(
        torch.zeros(8, 4, device=d), torch.zeros(8, 6, device=d),
        _grouped_map(d), compute_dtype=torch.bfloat16),
], ids=["nn1_argmin", "ume_moments_fused", "ume_moments_fused_caps",
        "corr_scores_fused", "gather_rows", "gather_padded",
        "sparse_conv_rowtile", "sparse_conv_tapsplit", "sparse_conv",
        "conv_entries", "gather_rows_backward", "sparse_conv_wgrad",
        "sparse_conv_grouped_kernel", "sparse_conv_grouped",
        "sparse_conv_grouped_wgrad"])
def test_wrappers_raise_instead_of_falling_back(no_nvcc, call):
    # a non-CPU tensor never takes the plain version: without a kernel
    # library the wrapper raises
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call("meta")
    assert call("cpu").device.type == "cpu"  # CPU tensors: plain version


def test_gather_padded_on_the_card_takes_no_third_path(no_nvcc):
    # a CUDA-side table of another shape or a non-zero fill raises before
    # any kernel is looked for; nothing falls back to the plain version
    with pytest.raises(ValueError, match="fill 0"):
        gather_padded(torch.zeros(8, 4, device="meta"),
                      torch.zeros(5, dtype=torch.int64, device="meta"),
                      fill=1.0)
    with pytest.raises(ValueError, match="2-D table"):
        gather_padded(torch.zeros(8, device="meta"),
                      torch.zeros(5, dtype=torch.int64, device="meta"))


def _chip_smoke_kernels():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # imports the standard library and numpy
    return mod.KERNELS


@pytest.mark.parametrize("M,N", [(4096, 16384), (1, 1), (8, 5000),
                                 (135168, 513), (8, 300_000), (40, 3)])
def test_nn1_argmin_plan_mirrors_the_kernel(M, N):
    # the wrapper's constants are the kernel's; the plan cuts [0, N) into
    # segments of whole steps, none empty, about two blocks an SM
    src = (PKG / "csrc" / "nn1_argmin.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert cuda_nn.QUERIES_PER_BLOCK == const["kThreads"] * const["kQ"]
    assert (cuda_nn.TILE, cuda_nn.STEP) == (const["kTile"], const["kStep"])
    tiles, S, seg = cuda_nn.launch_plan(M, N, 132)
    assert tiles == -(-M // cuda_nn.QUERIES_PER_BLOCK)
    assert seg % cuda_nn.STEP == 0 and (S - 1) * seg < N <= S * seg
    assert tiles * S <= 2 * 132 or S == 1
    if (M, N) == (4096, 16384):
        assert (tiles, S, seg) == (8, 33, 500)


def test_every_listed_kernel_has_a_source_and_an_entry_point():
    kernels = _chip_smoke_kernels()
    assert sorted(kernels) == sorted([
        "nn1_argmin", "ume_moments_fused", "corr_scores_fused", "gather_rows",
        "sparse_conv_rowtile", "sparse_conv_tapsplit",
        "gather_rows_backward", "sparse_conv_wgrad", "sparse_conv_grouped",
        "sparse_conv_grouped_wgrad"])
    entry = {"ume_moments_fused": "umr_ume_moments",
             "corr_scores_fused": "umr_corr_scores"}
    for name, (source, replaces) in kernels.items():
        src = ROOT / source
        assert src.parent == PKG / "csrc" and src.suffix == ".cu", name
        fn = entry.get(name, f"umr_{name}")
        assert fn in _build._SIGNATURES, name
        assert f"UMR_EXPORT int {fn}(" in src.read_text(), name
        tpu_file, line = replaces.split(":")
        text = (ROOT / tpu_file).read_text().splitlines()
        assert "def " in text[int(line) - 1], (name, replaces)


def _c_params(src, fn):
    """The parameter list of `UMR_EXPORT int fn(...)` in a CUDA source."""
    m = re.search(rf"UMR_EXPORT int {fn}\(([^)]*)\)", src)
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("fn,source", [
    ("umr_nn1_argmin", "nn1_argmin.cu"), ("umr_ume_moments", "ume_moments.cu"),
    ("umr_corr_scores", "corr_scores.cu")])
def test_pair_axis_entries_have_their_ctypes_signature(fn, source):
    # the C entries of the three kernels with a pair axis take B, and
    # _SIGNATURES lists every argument with its ctypes type (a pointer
    # without one would be cut to 32 bits)
    params = _c_params((PKG / "csrc" / source).read_text(), fn)
    assert "int B" in params
    sig = _build._SIGNATURES[fn]
    assert len(sig) == len(params)
    for p, ct in zip(params, sig):
        want = (_build._VP if "*" in p else _build._FLT
                if p.startswith("float") else _build._INT)
        assert ct is want, (fn, p)


@pytest.mark.parametrize("call", [
    lambda d: cuda_nn.nn1_argmin(torch.zeros(2, 4, 3, device=d),
                                 torch.zeros(2, 8, 3, device=d),
                                 torch.ones(2, 8, dtype=torch.bool, device=d)),
    lambda d: cuda_ume.ume_moments_fused(
        torch.zeros(2, 4, 3, device=d), torch.zeros(2, 8, 3, device=d),
        torch.zeros(2, 8, 128, device=d),
        torch.ones(2, 8, dtype=torch.bool, device=d), 1.0, 4),
    lambda d: cuda_corr.corr_scores_fused(
        torch.zeros(2, 2, 8, 4, device=d), torch.zeros(2, 8, 32, device=d),
        torch.zeros(2, 16, 4, device=d), torch.zeros(2, 16, 32, device=d)),
    lambda d: gather_padded(torch.zeros(2, 8, 4, device=d),
                            torch.zeros((2, 5), dtype=torch.int64, device=d)),
], ids=["nn1_argmin", "ume_moments_fused", "corr_scores_fused",
        "gather_padded"])
def test_pair_axis_wrappers_raise_instead_of_falling_back(no_nvcc, call):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call("meta")
    assert call("cpu").shape[0] == 2  # CPU tensors: plain version, per pair


def test_make_mesh_refuses_to_fall_back_to_gloo():
    # without CUDA the default mesh raises before any process group starts
    import torch.distributed as dist

    from umeregrobust_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert not dist.is_initialized()


def test_batched_and_hungarian_entries_refuse_the_cpu_fallback():
    from umeregrobust_tpu_torch.pipeline.e2e import (
        pair_features_batched, register_pairs_batched)
    from umeregrobust_tpu_torch.pipeline.registration import (
        register_pair_hungarian)

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for call in (lambda: register_pairs_batched(None, (), _cfg(),
                                                *([None] * 10)),
                 lambda: pair_features_batched(None, (), *([None] * 10)),
                 lambda: register_pair_hungarian(_cfg(), *([None] * 12))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
