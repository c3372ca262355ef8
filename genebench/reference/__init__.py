"""The reference of the benchmark: Prodigal's meta mode in plain NumPy
and Python (`plain.py` for the scores, `writer.py` for the genes and the
files written of them), driven by `engine.py`.  Nothing here imports the
port or JAX."""
