"""The plain reference that decides ``correct``.

Written afresh in plain NumPy and PyTorch: it imports neither the port
(``repro_torch``) nor the JAX package, and takes nothing the program
made.  It works the index and the tokens out again from the benchmark's
own corpus and scores with the weights the benchmark drew.
"""
