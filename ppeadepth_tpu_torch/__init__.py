"""PyTorch/CUDA port of PPEA-Depth for NVIDIA Hopper (H100).

Sits beside the JAX package `ppeadepth_tpu`, which is its reference. The
port imports torch and nothing of jax, flax or the JAX package; it reads
its configuration from a `ppeadepth_tpu.options.Config` (or any object with
the same field names) handed in by the caller. Modules mirror the JAX layout and carry the
reference's torch parameter names, so a JAX tree converted by
`ckpt.convert.state_dict_from_jax` loads with `strict=True`.

Public images are NHWC like the JAX API; inside, activations are NCHW
tensors in torch.channels_last memory, so the hand-written kernels
(`kernels/`, sources in `csrc/`) read NHWC bytes without a permute copy.
"""
