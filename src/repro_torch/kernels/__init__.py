"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the dispatcher (``ops``).  Kernel sources live in
``csrc/`` and are compiled on first launch (``build``); importing this
package needs neither ``nvcc`` nor a card."""
