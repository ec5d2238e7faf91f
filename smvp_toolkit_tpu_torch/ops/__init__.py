"""SpMV operators: the SELL planner, the CUDA SELL kernels and the plain-PyTorch CSR SpMV."""
