"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each wrapper validates its inputs, runs the plain version for tensors on
the CPU, and launches its CUDA kernel (or raises) for tensors on a card.
`launch_counts` counts kernel launches only, so a caller can show that a
run on the card went through the kernels.
"""

# lk_dwconv counts kernel A's forward launches (serving and training),
# lk_dwconv_dx its input-gradient launches in the training backward, and
# lk_dwconv_banded those of either that took the banded (tensor-core)
# instance
launch_counts = {"lk_dwconv": 0, "lk_dwconv_dx": 0, "lk_dwconv_banded": 0,
                 "ffn_fused": 0, "plane_sweep": 0, "warp_fwd": 0, "warp_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
