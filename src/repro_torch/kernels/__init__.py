"""Hand-written Hopper kernels, their plain PyTorch versions, and the
public ops that dispatch between them."""
