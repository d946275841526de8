"""PyTorch and CUDA port of iou3dmatch_tpu for NVIDIA Hopper (H100).

Module names follow the JAX package ``iou3dmatch_tpu`` so each counterpart
is easy to find; that package is the reference the port is tested against,
and the port imports nothing from it. Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
