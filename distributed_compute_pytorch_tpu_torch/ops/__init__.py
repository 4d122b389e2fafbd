"""Numerical ops: attention reference math and the hand-written CUDA
kernels of the serving path (flash prefill, paged K/V write, paged
decode read), each beside its plain PyTorch version."""
