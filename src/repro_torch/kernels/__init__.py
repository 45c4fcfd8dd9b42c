# Hand-written Hopper kernels, one package each (csrc/<name>.cu, kernel.py
# launch wrapper, ops.py dispatch, ref.py plain version), built by _build.
