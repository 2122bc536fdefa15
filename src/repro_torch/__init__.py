"""repro_torch — the PyTorch/CUDA port of `repro` ("Opening the Black Boxes
in Data Flow Optimization"), for NVIDIA Hopper.

Mirrors `repro` module for module; imports neither `jax` nor `repro`.  The
reference runs its data plane with 64-bit JAX (`jax_enable_x64`): columns
are int64/float64 and arithmetic on them stays 64-bit.  The port pins the
dtype of every tensor it creates and leaves torch's default dtype alone;
only while a UDF runs (`core.invoke`) is the default float64, so UDF
arithmetic that makes a float from integers (`x * 0.5`, `sum / count`) is
float64 as in the reference rather than torch's float32.
"""
