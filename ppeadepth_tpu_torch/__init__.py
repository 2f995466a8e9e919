"""PyTorch/CUDA port of PPEA-Depth for NVIDIA Hopper (H100).

Sits beside the JAX package `ppeadepth_tpu`, which is its reference. The
port imports torch and nothing of jax, flax or the JAX package; it reads
its configuration from its own `options.Config` (a copy of the JAX one,
whose instances, or any object with the same field names, work too).
Modules mirror the JAX layout and carry the reference's torch parameter
names, so a JAX tree converted by `ckpt.convert.state_dict_from_jax`
loads with `strict=True`. The CLI is `python -m ppeadepth_tpu_torch.train`.

Public images are NHWC like the JAX API; inside, activations are NCHW
tensors in torch.channels_last memory, so the hand-written kernels
(`kernels/`, sources in `csrc/`) read NHWC bytes without a permute copy.
"""
