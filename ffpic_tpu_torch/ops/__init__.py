"""Device stages of the port: plain PyTorch versions and CUDA kernels."""
