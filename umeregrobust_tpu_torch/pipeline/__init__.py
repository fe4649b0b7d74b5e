"""Registration pipeline: UME generation, matching, correlator, consensus,
ICP, the per-pair entry point `e2e.register_pair_e2e`, the RT-UME
keypoint layer (`rtume.rtume_estimate`) and the keypoint samplers."""
