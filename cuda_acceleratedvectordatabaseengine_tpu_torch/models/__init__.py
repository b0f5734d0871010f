"""Index models of the PyTorch port: the packed list arena, IVF-Flat,
IVF-PQ, the exact flat index, probe calibration and state conversion from
the JAX package."""
