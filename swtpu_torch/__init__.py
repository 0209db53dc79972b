"""swtpu_torch — the PyTorch/CUDA port of swtpu, for NVIDIA Hopper (H100).

The package mirrors ``swtpu``'s layout module for module, so each port
function sits at the same path as the JAX function it is held against:

- ``core``      scoring systems (BLOSUM62 for protein), FASTA I/O, the
                2-bit codec and ``.npz`` container, CIGAR and SAM encodings;
- ``oracle``    numpy scalar oracles and the host traceback walkers;
- ``kernels``   hand-written CUDA C++ kernels (``csrc/``) with their plain
                PyTorch versions beside them;
- ``ops``       engine dispatch (``best_engine``, ``best_ends_engine``) and
                the named engines of ``align --engine`` (``VARIANTS``);
- ``batch``     alignment with traceback (device endpoints, host walk),
                variable-length batches and overflow promotion;
- ``utils``     device resolution and CUDA-event timing;
- ``models``    the read mapper, center-star MSA and greedy assembly;
- ``cli``       ``python -m swtpu_torch align ...``, ``map``, ``msa``,
                ``assemble`` and ``pack``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``: with ``device=None`` and no card they raise. On the CPU
every kernel wrapper runs its plain PyTorch version; on a CUDA tensor it
launches its kernel or raises.
"""

__version__ = "0.1.0"

from swtpu_torch.core.scoring import ScoringParams, DNA_111, dna_matrix  # noqa: F401
from swtpu_torch.core.encode import (  # noqa: F401
    pack_2bit,
    unpack_2bit,
    random_dna,
    mutate,
    revcomp,
)
