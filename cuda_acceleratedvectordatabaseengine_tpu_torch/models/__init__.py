"""Index models of the PyTorch port: the packed list arena, the search
cycle every index family serves through (``search``), IVF-Flat, IVF-PQ,
the exact flat index, probe calibration and state conversion from the JAX
package."""
