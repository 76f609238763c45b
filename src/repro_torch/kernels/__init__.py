"""Hand-written Hopper kernels, their plain PyTorch versions (``ref``) and
the wrappers that dispatch between them by the tensor's device (``ops``)."""
