"""Plain PyTorch and NumPy references that decide ``correct``.

Nothing here imports the program under test (``tha4_tpu_torch``), JAX or
the JAX package: each module restates the published computation from the
benchmark's own inputs.
"""
