"""swtpu_torch — the PyTorch/CUDA port of swtpu, for NVIDIA Hopper (H100).

The package mirrors ``swtpu``'s layout module for module, so each port
function sits at the same path as the JAX function it is held against:

- ``core``      scoring systems, FASTA I/O, CIGAR and SAM encodings;
- ``oracle``    numpy scalar oracles and the host traceback walkers;
- ``kernels``   hand-written CUDA C++ kernels (``csrc/``) with their plain
                PyTorch versions beside them;
- ``ops``       engine dispatch (``best_engine``, ``best_ends_engine``);
- ``batch``     alignment with traceback (device endpoints, host walk);
- ``utils``     device resolution and CUDA-event timing;
- ``cli``       ``python -m swtpu_torch align ...``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``: with ``device=None`` and no card they raise. On the CPU
every kernel wrapper runs its plain PyTorch version; on a CUDA tensor it
launches its kernel or raises.
"""

__version__ = "0.1.0"
