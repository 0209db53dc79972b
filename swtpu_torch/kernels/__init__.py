"""Device kernels: hand-written CUDA C++ (``csrc/``) bound with ctypes,
each with its plain PyTorch version beside it.

- ``sw_batch``    linear gap: ``sw_batch`` / ``sw_batch_ends`` (kernel),
                  ``sw_batch_plain`` / ``sw_batch_ends_plain``;
- ``sw_affine``   affine gap: ``sw_affine`` / ``sw_affine_ends`` (kernel),
                  ``sw_affine_plain`` / ``sw_affine_ends_plain``;
- ``sw_profile``  general matrix (DNA 4x4, BLOSUM62), linear or affine:
                  ``sw_profile`` / ``sw_profile_ends`` (kernel: a thread or
                  a warp per pair, ``profile_form`` picks by shape),
                  ``sw_profile_plain`` / ``sw_profile_ends_plain``;
- ``sw_general``  any scoring the plain tier takes (gaps <= 0, Gotoh
                  extension <= 0, entries past [-127, 127]), linear or
                  Gotoh: ``sw_general`` / ``sw_general_ends`` (kernel),
                  ``sw_general_plain`` / ``sw_general_ends_plain``;
- ``sw_bf16``     the bf16 reduced-precision tier: ``sw_bf16`` (kernel),
                  ``sw_bf16_plain`` (the anti-diagonal tier in bf16);
- ``semiglobal_batch``, ``semiglobal_profile``  semi-global / global
                  (kernel), ``semiglobal_scan`` their plain tier;
- ``sw_banded``   fixed band |i - j| <= W: ``sw_banded_static`` (uniform)
                  / ``sw_banded_profile`` (general matrix) (kernel),
                  ``sw_banded_plain``;
- ``banded_batch``  per-round adaptive-band X-drop: ``banded_batch``
                  (kernels: a warp per pair up to W = 128, a CTA per pair
                  up to 1024), ``banded_batch_plain``; ``banded_scan`` its
                  plain tier (the XLA tier's copy) and result type;
- ``banded_block``  the block-adaptive band: ``block_forward`` (B9, one
                  launch a forward) and, for negative gaps,
                  ``block_gather`` (B10) and ``block_rows`` (B9 a block)
                  (kernels) with their plain versions,
                  ``banded_block_batch``, ``banded_block_align_device``;
- ``device_walk``  the banded device walkers ``block_walk`` and
                  ``xdrop_walk`` (kernels), the host walks as their plain
                  versions;
- ``longpair_strip``  one tile of a long pair: ``tile_strip_linear`` /
                  ``tile_strip_affine`` (kernel), ``strip_tile`` /
                  ``strip_tile_affine``, the plain tiles
                  ``_tile_colscan`` / ``_tile_colscan_affine``;
- ``sw_wavefront``  the anti-diagonal schedule: ``sw_wavefront``
                  (kernel), ``sw_wavefront_plain``;
- ``colscan``     the column-parallel schedule (a plain tier, CPU only);
- ``sw_scan``, ``affine_scan``  the plain anti-diagonal tiers;
- ``unpack``      the 2-bit DNA decode / encode as torch ops on a device;
- ``_build``      nvcc at first use, ctypes loading.

Nothing here imports a compiler or builds a kernel at import; the first
launch on a CUDA tensor builds its ``csrc/*.cu`` with nvcc
(``_build.SOURCES`` lists them).
"""
