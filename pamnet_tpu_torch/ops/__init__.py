"""Operations of the port: basis functions, segment sums and the CUDA kernels."""
