"""Device ops of the PyTorch port: distances, normalization, top-k, the
gather scan, the grouped scans (with their CUDA kernels), k-means and
product quantization."""
