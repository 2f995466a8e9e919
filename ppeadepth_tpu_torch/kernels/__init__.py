"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each wrapper validates its inputs, runs the plain version for tensors on
the CPU, and launches its CUDA kernel (or raises) for tensors on a card.
`launch_counts` counts kernel launches only, so a caller can show that a
run on the card went through the kernels.
"""

launch_counts = {"lk_dwconv": 0, "ffn_fused": 0, "plane_sweep": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
