"""Host-side utilities of the port: the YAML config layer and input
prefetching."""
