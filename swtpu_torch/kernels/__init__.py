"""Device kernels: hand-written CUDA C++ (``csrc/``) bound with ctypes,
each with its plain PyTorch version beside it.

- ``sw_batch``    linear gap: ``sw_batch`` / ``sw_batch_ends`` (kernel),
                  ``sw_batch_plain`` / ``sw_batch_ends_plain``;
- ``sw_affine``   affine gap: ``sw_affine`` / ``sw_affine_ends`` (kernel),
                  ``sw_affine_plain`` / ``sw_affine_ends_plain``;
- ``sw_scan``, ``affine_scan``  the plain anti-diagonal tiers;
- ``_build``      nvcc at first use, ctypes loading.

Nothing here imports a compiler or builds a kernel at import; the first
launch on a CUDA tensor builds ``csrc/*.cu`` with nvcc.
"""
