"""PyTorch/CUDA port of the IMPart partitioner (``repro``).

The package mirrors ``repro``'s layout module for module and is held
against it by the ``tests/test_torch_*.py`` parity tests.  It imports
``torch`` and numpy only, never JAX and nothing of ``repro``.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
