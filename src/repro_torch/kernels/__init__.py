"""Hand-written CUDA kernels of the port and their thin PyTorch wrappers.

``csrc/`` holds the CUDA C++ sources (built for ``sm_90a`` by ``build.py`` at
first use, bound with ``ctypes``); ``dse_sweep.py``, ``conv2d.py``,
``flash_attention.py`` and ``ssd_scan.py`` hold each kernel's wrapper, its
plain PyTorch version and its launch count; ``ops.py`` holds the public
entry points the campaign and the models call.  The package re-exports no
names: ``ssd_scan`` and ``flash_attention`` are both a module here and a
function in ``ops``.  Importing this package builds and loads nothing —
that happens inside the first call that launches a kernel.
"""
