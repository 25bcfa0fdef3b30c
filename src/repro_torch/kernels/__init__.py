"""Kernels of the port: hand-written Hopper kernels (``csrc/``), their
builds and wrappers, the plain PyTorch versions beside them (:mod:`.ref`),
and the device-dispatching entry points (:mod:`.ops`)."""
