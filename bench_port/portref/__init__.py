"""The benchmark's reference: a frozen copy of the plain paths of
umeregrobust_tpu_torch (geometry, backbone, registration, losses, the
train step, the optimizer), renamed, each module cut to its plain
version: no kernel is built or launched. round_to also takes fp8 types,
scaled a tensor to the format's range (the control's precision). It
imports nothing of the program, so a change to the program cannot move
the yardstick."""
