"""Device backend of the PyTorch/CUDA port: word-tensor field, NTT, curve
and MSM modules, their CUDA kernels (csrc/), and TorchBackend."""
