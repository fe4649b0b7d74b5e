"""Host-side utilities of the port: the YAML config layer, input
prefetching, the kernel build cache and wall-clock profiling (the last
loaded on first use, so that the host-only modules stay free of torch)."""
from umeregrobust_tpu_torch.utils.config import (
    apply_overrides,
    load_yaml_config,
    update_namespace_from_yaml,
)

_PROFILING = ("device_trace", "phase", "report", "reset")


def __getattr__(name):
    if name in _PROFILING:
        from umeregrobust_tpu_torch.utils import profiling

        return getattr(profiling, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
