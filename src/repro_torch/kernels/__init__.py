"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``<name>/<name>.cu`` holds the kernel behind a plain C launcher,
``<name>/ops.py`` the wrapper (checks, launch count, CPU fallback to the
plain version only for CPU tensors), ``<name>/ref.py`` the plain version.
``build.py`` compiles the sources with ``nvcc`` at first use.
"""
