"""The benchmark's plain PyTorch reference: PPEA-Depth's networks in
training form (`nets`) and its training step (`train`). It imports only
torch and numpy, and nothing of the measured program."""
