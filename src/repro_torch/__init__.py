"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100: the same modules,
with every TPU kernel on the serving path rewritten as a hand-written
Hopper kernel. Imports torch and numpy only."""
