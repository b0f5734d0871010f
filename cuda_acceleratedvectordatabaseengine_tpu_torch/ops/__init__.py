"""Device ops of the PyTorch port: distances, normalization, top-k, the
gather scan, the grouped scan (with its CUDA kernel) and k-means."""
