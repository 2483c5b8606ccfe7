"""Hand-written CUDA kernels of the port and their thin PyTorch wrappers.

``csrc/`` holds the CUDA C++ sources (built for ``sm_90a`` by ``build.py`` at
first use, bound with ``ctypes``); ``dse_sweep.py``, ``conv2d.py`` and
``flash_attention.py`` hold each kernel's wrapper, its plain PyTorch version
and its launch count; ``ops.py`` holds the public entry points the campaign
and the models call.  Importing this package builds and loads nothing —
that happens inside the first call that launches a kernel.
"""
