"""Device ops of the port: plain PyTorch versions and CUDA kernel wrappers."""
