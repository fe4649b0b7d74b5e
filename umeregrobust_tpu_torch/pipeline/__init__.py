"""Registration pipeline: UME generation, matching, correlator, consensus,
ICP and the per-pair entry point `e2e.register_pair_e2e`."""
