"""Hand-written CUDA kernels of the port and their wrappers.

``ops`` is the public surface (``zeta_op``, ``ranked_conv_op``, ...);
``ref`` holds the plain PyTorch versions; ``zeta_cuda`` and
``ranked_conv`` wrap the kernels in ``csrc/``; ``build`` compiles and
loads them.  Nothing here touches ``nvcc`` or the card at import time.
"""
