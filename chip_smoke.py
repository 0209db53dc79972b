#!/usr/bin/env python3
"""Smoke run of the swtpu_torch port on one CUDA card.

Drives the port's main paths on the card, through the entry points
a user calls, and holds every CUDA kernel against its plain PyTorch
version: the DNA path (batched local alignment under uniform scoring:
scores, endpoints, traceback, the ``align`` CLI; the row-scan kernels of
``csrc/sw_rowscan.cu``), the protein / general-matrix path (BLOSUM62,
linear and Gotoh gaps; the profile kernels of ``csrc/sw_profile.cu``),
the variable-length read path of BASELINE config 4 (the 2-bit wire
decoded on the card, pads past each length, overflow promotion through
the bf16 tier of ``csrc/sw_bf16.cu`` with an int32 re-run on the row-scan
kernel, ``pack`` and ``.npz`` inputs, ``align --engine``), the
semi-global / global path (scores and endpoints, fixed and per-pair
lengths, traceback, the ``semiglobal`` and ``global`` CLI; the uniform and
profile forms of ``csrc/sw_semiglobal.cu``) and the banded path (fixed
band at BASELINE config 2 through ``csrc/sw_banded.cu``, the per-round
adaptive X-drop band through ``csrc/sw_xdrop.cu``, traceback, the
``banded`` CLI) and the block-adaptive band (``csrc/sw_block.cu``: the
block row-scan B9, the whole forward in one launch that reads the
corridor window in place, a warp per pair; for negative gap penalties
the window gather B10 and the per-block B9 under the host loop; the
device walkers of ``csrc/sw_walk.cu``; ``banded --block-adaptive``) and
long pairs on one card (``longpair_sw_score`` / ``_ends`` / ``_align``
through the strip tile of ``csrc/sw_strip.cu``, B13: row bands of a warp
each on many SMs, beside the earlier one-block kernel; the anti-diagonal
``wavefront``
schedule of ``csrc/sw_wavefront.cu``, B14; the ``longpair`` and ``align
--engine wavefront`` CLI) and database search (BASELINE config 5:
``all_vs_all_topk`` in its four modes on the row-scan and profile kernels,
Karlin-Altschul statistics, the ``search`` CLI with its hits walked in C++)
and the models (the read mapper on the fixed band's 2-bit wire with its
winners on the block tier, center-star MSA on the pinned semi-global
kernel, greedy assembly on ``best_engine``; ``map``, ``msa``, ``assemble``)
and the mesh on ``torch.distributed`` (data-parallel scores, the sharded
search and the sharded long-pair sweep at world 1 under NCCL and in a
2-rank gloo world on the one card; ``longpair`` under ``torchrun``) and the
harnesses (``fuzz``, ``selftest``, a ``torch.profiler`` trace), then
runs the benchmark suite (``python -m swtpu_torch bench``) through all of
them; last, the inputs JAX's TPU dispatch sends to its XLA tier: the
per-round band past W = 128 (the wide kernel of ``csrc/sw_xdrop.cu``) and
the local engines under the scorings the row-scan and profile kernels'
guards refuse (``csrc/sw_general.cu``). Every host walk runs the port's C++ walkers (``swtpu_torch/native``,
built with g++ in phase 2); the traceback phases print the walker and its
wall.

   1. environment: card name and power limit, device count;
   2. build: nvcc on the eleven CUDA sources at once, g++ on the C++ host
      walkers beside them; registers, spills and
      shared memory of each kernel; the per-round kernels' round loops,
      and the local row-scan, profile thread-form, semi-global, bf16 and
      fixed-band kernels' unmasked groups and the wavefront kernel's
      iteration (both tables), as compiled (``cuobjdump -sass``: int32 ALU
      instructions a cell, by pipe), and the per-round round body's own
      instructions a cell (two instantiations' difference) against the
      ALU slots of ``xdrop_ops``, which must not exceed them; the pipe-rate probe (``tools/pipe_probe.cu``: IMNMX, the DPX
      add-max and three-way max, HMNMX2, HFMA2.RELU, HADD2, IMAD, PRMT,
      LOP3 and IADD3, each alone on a full card, lanes an SM a clock);
   3. kernels vs plain versions on the card, exactly equal (integers,
      tolerance 0), on DNA and protein shapes, pads and scorings; the
      row-scan and the profile thread form (their skewed tile) also on n =
      15, 16, 17, 129 and m = 37, 16, 9, 130, 1 with internal pads, scores
      too wide for the packed key and (uniform) for the min-cap pad rule,
      the forced select tracker, against their CPU mirrors
      (``local_skew_mirror``) on 16 pairs and the library's choice of form;
      the profile kernel on a uniform scoring against the row-scan kernel;
      the bf16 kernel inside its exact range against the row-scan kernel
      too, above it (config 4's promotion workload, ``allow_overflow``)
      against its plain version bit for bit, drift included, and on the
      pad cases where the bf16 tier matches pads, and against its CPU
      mirror (``bf16_skew_mirror``) on the first pairs; both forms of the profile
      kernel (a thread per pair, a warp per pair) and the wrapper on every
      profile case, stripes of 128 rows crossed (n = 129, 300), a config-3
      bucket's 120 x 800 with padded targets, n = 1; 64-pair spot checks
      against the numpy oracle; the eight semi-global instantiations
      (argmax and pinned) on 8192 x 128 x 128 (half related pairs),
      1000 x 90 x 200 with internal pads and per-pair lengths down to 0,
      33 x 7 x 1 and 4 x 40 x 1024, under (1,1,1), (2,1,1), (2,3,5,1),
      (2,3,2,2), BLOSUM62 linear 11 and Gotoh 11/1 and a 4x4 DNA matrix
      linear 2 and Gotoh 3/1, and on 8 pairs against the oracle copy;
      the fixed-band kernel, both forms, at W = 8, 15, 16, 32, 64, 96 and 160 on
      8192 x 128 x 128 (half related; W = 15 / 16 straddle the skewed
      tile's two schedules) and W = 8, 32 and 160 on 1000 x 90 x
      200 with internal pads and lengths, 64 x 40 x 300, 64 x 300 x 40 and
      33 x 7 x 1 under (1,-1,1),
      (10,-30,15), Gotoh (1,-1,3,1), BLOSUM62 11 and 11/1 and a 4x4 DNA
      matrix 3/1, 64 pairs against the oracle copy, 32 against the CPU
      mirror (``banded_skew_mirror``) at W = 8 and 32; the per-round kernel
      at W = 8, 32, 64, 96 and 128 in every field (history, pos_y and
      offsets below each pair's n_rounds) on 512 x 256 related DNA pairs
      with lengths (64 short queries whose bands run off the target),
      Gotoh with the 8-bit history and a non-homologous (1,3,2) X = 40
      set at every W, and at W = 32 and 96 also protein BLOSUM62 11/1 at
      X = 120 and scores only; 8 pairs against the oracle copy; the block
      tier's one-launch B9 against the plain loop in every field, whole
      (histories, bases and deltas past each pair's end too) on 300 pairs
      of 256 (40 random, whose bands die early at X = 30) at W = 16, 32,
      64, 96 and 112 with K = 1 and 129 - W (and 32 at W = 64) and W = 48,
      80 and 128 at K = 129 - W, linear, Gotoh 3/1, BLOSUM62 and per-pair
      lengths (a length 0, pairs that end inside a block), an all-dead
      start, the negative-gap route (B10 and the per-block B9, linear -1
      and Gotoh 2/-1), B10 alone at bases far outside the targets, and the
      wires of both device walkers (``block_walk``, ``xdrop_walk``: their
      default chunks and chunks of 3 rows / 2 rounds, and the earlier
      serial kernels) against their plain versions (the host walks,
      encoded); the strip tile (B13),
      pipelined and one-block, against the plain column-scan tile on every
      return at R x C = 1 x 1, 7 x 300, 1000 x 64, 1499 x 700 (a prime R),
      4096 x 4096, 8191 x 48, 16384 x 64 and 16383 x 33 (the one-block
      kernel's 8 and 16 rows a thread, the last thread ragged) under
      (1,-1,1), Gotoh (2,-3,5,1), BLOSUM62 11/1 and a 4x4 matrix, with
      non-zero and -2^20 boundaries, pads and an all-negative tile; the
      wavefront kernel (B14) against its plain
      version and its schedule's CPU mirror (``wavefront_stream_mirror``,
      run on the card) on 8192 x 128 x 128 (10,-30,15), 300 x 100 x 150
      (1,-1,1), 1024 and 2500 x 128 x 128 protein BLOSUM62 11 with the pairs
      a stream the wrapper picks, and with 1 to 16 forced (ragged last
      streams, targets of 1 to 3 codes, both tables), pads included;
   4. DNA main path, scores: ``best_engine`` at the SpeedTest size,
      1,048,576 x (128 x 128), linear (10, -30, 15) and affine
      (10, -30, open 40, extend 15), timed with CUDA events; the first
      65,536 scores held against the plain version on the card;
      ``best_ends_engine`` on the same pairs, the first 16,384 held; each
      form's launch alone beside its bound by pipe, the endpoint's select
      tracker beside the key;
   5. DNA main path, traceback: ``sw_align_batch`` on 64 related pairs,
      linear and affine, with endpoint, rescoring, CIGAR and SAM checks;
      the device endpoints held against the plain version;
   6. DNA CLI: ``swtpu_torch.cli.main(["align", ...])``, captured and
      checked against the oracle;
   7. protein main path, scores: ``best_engine`` at 1,048,576 x
      (128 x 128) random protein, BLOSUM62 linear 11 and Gotoh 11/1
      (the JAX package's ``bench_protein`` scorings), timed; the first
      65,536 scores held against the plain version on the card, in chunks;
      ``best_ends_engine`` on the same pairs (the thread form's ends), the
      first 32,768 held;
   8. protein main path, BASELINE config 3: 64 mutated 120-mer fragments
      against the 256 SwissProt-like targets of
      ``swtpu/data/swissprot_like_256.fasta`` (read as data), 16,384 pairs
      in 6 target-length buckets, as the JAX package's
      ``bench_protein_swissprot`` builds them, each a launch of the profile
      kernel's warp form; wall ms and GCUPS over the real cells; each
      bucket's launch alone beside the thread form's and its bound over the
      real cells; the warp form's four instantiations on the widest bucket
      (wrapper, alone, plain, bound); every score against the plain
      version, 32 against the oracle;
   9. protein main path, traceback: ``sw_align_batch`` on 64 related
      protein 128-mers, Gotoh 11/1 and linear 11, with the same checks as
      phase 5 and a protein SEQ in SAM;
  10. protein CLI: ``align --alphabet protein``, captured and checked;
  11. config 4, varlen scores: 32,768 DNA reads of 100-300 bp against
      320-bp windows, DNA (1, -1, 1), three read sets on the 2-bit wire
      built as the JAX package's ``bench_varlen`` builds them;
      ``sw_scores_varlen(..., packed=True)`` timed end to end (upload,
      device decode, pads, kernel, score fetch), and with
      ``stream_chunks=4``; the wire floor (upload of the same bytes and
      one fetch), and the fused unit on pre-staged device tensors with
      CUDA events; every score against the plain version on the
      unpacked, masked codes, 32 against the oracle;
  12. config 4, promotion: 32,768 pairs of 300 x 320, 1/8 homologous;
      ``sw_scores_promoted_device`` timed end to end with its promoted
      fraction, and its fused split on device tensors; every score against
      the int32 kernel and ``sw_scores_promoted``, 32 against the oracle;
      the host remainder path (``cap_frac=1/2048``);
  13. config 4, traceback sample: ``sw_align_batch`` on 16 promotion
      pairs, with the checks of phase 5;
  14. the bf16 tier at the headline size, 1,048,576 x (128 x 128) under
      (10, -30, 15), timed beside ``best_engine``'s int32 kernel on the
      same codes (call and launch alone; bf16's bound by pipe); all scores
      equal;
  15. config-4 CLI: ``pack`` and ``pack --unpack``, ``align`` on ``.npz``
      inputs against the FASTA run, ``align --engine rowscan_bf16``
      against the oracle;
  16. kernel times at 32768 x (128 x 128) (DNA for the row-scan, bf16
      and uniform semi-global kernels, protein for the profile kernels;
      the fixed band at W = 32) and for the per-round kernel on 256
      related 2048-mers, scores only, at W = 96 and 32: the wrapper
      (code staging included) and the launch alone (the endpoint forms of
      the row-scan and the profile thread form: the select tracker too),
      beside the earlier per-round kernel's launch, the plain version's
      time (one call, whose result phase 23 reuses) and the bound; the
      profile kernel's form sweep (both forms alone at B = 512 to 131,072
      pairs of 120 x 128 / 320 / 800, linear and Gotoh, the warp form held
      against the thread form and, at 512 pairs, the plain version) and the
      forms ``profile_form`` picks; the one-line benchmark;
  17. semi-global path, scores and endpoints at 1,048,576 x (128 x 128)
      (the JAX package's ``bench_semiglobal_full`` inputs at the headline
      scale): random DNA under (1,1,1) and (2,3,5,1), random protein under
      BLOSUM62 linear 11 and Gotoh 11/1, through ``semiglobal_batch`` /
      ``semiglobal_profile``, timed; the first 65,536 scores and endpoints
      held against the plain version on the card, 16 against the oracle copy;
  18. global path at 1M pairs: DNA (1,1,1) and protein Gotoh 11/1, pinned;
  19. varlen: 32,768 DNA pairs, query lengths 96-128, target lengths
      112-128, (1,1,1), semi-global and global, timed;
  20. traceback: ``semiglobal_align_batch`` and ``nw_align_batch`` on 64
      related DNA pairs (linear), 16 affine and 16 protein Gotoh 11/1:
      paths from (0, 0) to the device endpoint, rescoring, CIGAR and SAM;
  21. the ``semiglobal`` and ``global`` CLI, DNA and protein, against the
      oracle copy;
  22. fixed-band path, BASELINE config 2: 1,048,576 random 128 x 128
      pairs at W = 32, DNA (1,-1,1) and Gotoh (1,-1,3,1), protein
      BLOSUM62 11 and 11/1, through ``banded_static_scores``, timed in
      band GCUPS over the in-band cells, and the launch alone beside its
      bound by pipe; the first 65,536 scores against the plain version, 64
      against the oracle copy; 2048 related 2048-mers;
  23. per-round adaptive band on the JAX ``bench_suite``'s sets: 256
      related DNA 2048-mers at W = 32, X = 70 (scores only, and with the
      int32 and 8-bit history, and through ``banded_forward_batch``),
      Gotoh 3/1, ~70%-identity protein BLOSUM62 11/1 at X = 120, the
      non-homologous (1,3,2) X = 40 early-exit set, W = 64 and 96, and
      16,384 pairs scores only; band GCUPS count rounds written x W; each
      scoring and the history against the plain version (W = 64 against
      the oracle copy on 2 pairs), and the 16,384 pairs' bound; ns a round
      at 1 and 16,384 pairs, the earlier kernel beside;
  24. traceback: ``banded_static_align_batch`` on 64 related 128-mers
      (DNA linear and Gotoh, protein 11/1), paths in the corridor and
      rescored; ``banded_align_batch`` on 16 related 2048-mers (linear,
      Gotoh, protein), paths from the origin rescored, 1 against the
      oracle copy, and on 16 of them at W = 96;
  25. the ``banded`` CLI (``--fixed`` and the per-round band at W = 96,
      DNA and protein) against the oracle copy;
  26. the block tier's forward on ``bench_suite``'s block rows at W = 64:
      256 related 2048-mers at K = 32 and 64, 1024 at K = 64, Gotoh 3/1 and
      protein BLOSUM62 11/1 at X = 120, through ``banded_block_batch``,
      timed (band GCUPS over n_rows x W) and at X = 2^20 through every block
      (``bench_forward_fn``); the first 64 pairs against the plain version in
      every field (the 1024 pairs, four copies of the 256: their first 256
      against the 256-pair run), 2 against the oracle copy; B9 (one launch
      a forward) through its wrapper and alone on the 1024 pairs (row 11)
      and the 256 (row 12), beside the earlier per-block kernel over the
      same blocks and the earlier forward (B10 and B9 a block), B10 alone
      (row 13), their plain times and bounds (``block_ops``);
  27. ``banded_block_align_device`` on 8 related 16384-mers (W =
      64, K = 64, X = 70, (1,1,1)): wall time, paths from the origin
      rescored, scores against the forward, 1 pair against the oracle
      copy; the forward beside the earlier per-block forward; ``block_walk``
      on every pair against its plain version and the earlier serial
      kernel, and with 1 and GROUP pairs a producer CTA, timed through its
      wrapper and alone (its default and both groupings) beside the serial
      kernel, ns a step of the longest pair; the wall's forward / walk /
      decode split;
  28. ``banded_align_batch`` on 8 related 16384-mers at W = 32: the device
      walk (``xdrop_walk``) against the host walk over the 8-bit history,
      rescored, 1 pair against the oracle copy; ``xdrop_walk`` against its
      plain version and the serial kernel, timed as in phase 27, and the
      forward / walk / decode split;
  29. ``banded --block-adaptive``: DNA scores, ``--traceback --cigar``,
      protein, Gotoh and per-pair lengths (FASTA) against records built
      from the oracle copy; its two refusals;
  30. long pairs: ``longpair_sw_ends`` and ``longpair_sw_score`` on one
      related 16384 x 16384 DNA pair (~85% identity), (1,-1,1) and Gotoh
      (2,-3,5,1), one whole-target block (the default); wall per call, B13's
      launches a sweep, B13 alone (CUDA events), its bands and warps, and
      GCUPS, beside the one-block kernel; B13's row on a related 4096 x 4096
      linear tile: wrapper, launch alone (pipelined and one-block), the
      plain tile's time and every return held equal;
  31. ``longpair_sw_align`` (device forward, low-memory host walk) on the
      16K linear pair and on a Gotoh 4096 x 4096 pair, and ``longpair_sw_ends``
      and ``_align`` on a BLOSUM62 11/1 4096 x 4096 pair: paths rescored,
      endpoints equal to the forward's, the 4096 x 4096 sweeps against the
      plain tile; host walk seconds; the 16K linear and Gotoh (score,
      end_i, end_j) against an independent forward, the host's full
      low-memory pass (``sw_traceback_lowmem`` without ends: the matrix
      maximum and its row-major-first cell), the linear path equal to
      ``longpair_sw_align``'s;
  32. the wavefront schedule through ``variant_engine("wavefront")`` (what
      ``align --engine wavefront`` runs): 128 and 8192 pairs of 128 x 128
      under (10,-30,15) and (1,-1,1), BLOSUM62 11, against ``best_engine``;
      queries past 128 (2 x (512 x 384), 2 x (1024 x 256)) through the strip
      tile;
  33. the ``longpair`` CLI (DNA with ``--cigar``, protein Gotoh) and ``align
      --engine wavefront`` against the oracle copy;
  34. search at BASELINE config 5's single-card scale (the JAX package's
      ``bench_search``): 16 queries x 131,072 random 128-mers (seed 10000),
      k = 10, chunks of 8192, DNA (1,-1,1) and protein BLOSUM62 11/1 (the
      database from the background model); streaming raw (the default,
      ``"auto"``), streaming packed (DNA), resident and the fused sweep
      (resident with no host sync), each equal to the others and to
      a brute-force top-k (``np.lexsort((ids, -scores))`` over
      ``best_engine``'s scores of all 2,097,152 pairs), and on a
      sub-database with a tail chunk to the oracle copy; resume from a
      checkpoint written mid-sweep and a flaky engine that raises once;
      the chunk step at 16 x 2048 alone (CUDA events) and each mode's wall
      (the second of 2 reps, fresh queries a rep) beside ``best_engine``'s
      device time on the 2,097,152 pairs (the floor); at 131,072 x 128
      the C++ pack and the upload of the database beside a SHA-256 of it
      (what a cache keyed on content would pay a call); the launch alone
      of each kernel the chunks ran, at the chunk's 131,072 pairs;
  35. statistics and the ``search`` CLI: ``calibrate_stats`` at 8192 pairs
      of 128 x 128 on the card and on the CPU (equal lambda and K); ``search
      --tsv --stats calibrate`` (DNA (1,-1,1), 16 x 2048 in one chunk),
      ``--tsv --stats preset``
      (protein 11/1, config 3's 64 queries against
      ``swissprot_like_256.fasta``) and ``--tsv`` under Gotoh (10,-30,40,15),
      16 x 2048:
      every hit's path (``--traceback``) rescored to its score, the TSV's
      coordinates, scores and bit scores equal to those the hits give,
      E-values and bit scores in opposite orders per query;
  36. the read mapper at the JAX package's ``bench_map`` size: a
      1,000,000-base genome (seed 10000), k = 9, 4096 mutation-model
      152-mers, ``min_score`` 20, with paths (the card's route: the fixed
      band on the 2-bit wire, winners on the block tier and its device
      walk), both strands, Gotoh winners on the per-round band; index
      seconds, the wall (min of 3 fresh read sets), reads/s, the
      correct-locus fraction, candidates, host seeding beside the card's
      screening; the first 256 reads' hits equal to the same route on the
      CPU's plain tiers, ``map_reads_pipelined`` equal to ``map_reads``;
  37. center-star MSA at ``bench_msa``'s sizes (48 x 256 and 256 x 256,
      match 2, mismatch 3, gap 2) on the pinned semi-global kernel: walls;
      at 48 x 256 rows, center and scores equal to the CPU's; at 256 x 256
      the projection invariant on every row (the center pick scores 32,640
      pairs in one launch);
  38. greedy assembly of ``assemble --random 20000x150x50`` (398 reads,
      158,006 ordered pairs in one ``best_engine`` call; the host loop that
      fills the batch timed beside it): the contig reconstructs the
      genome, the first 2048 screening scores equal the CPU's; the
      ``msa`` and ``assemble`` CLI print the same bytes on the card as with
      ``--device cpu``; ``map --random`` exits 0 with its true-locus count;
  39. the mesh at world 1 (NCCL, a world of one process on an in-memory
      store), at full width: ``data_parallel_scores`` on 1,048,576 random
      128 x 128 DNA pairs (10,-30,15) equal to ``best_engine``'s scores,
      ``sharded_all_vs_all_topk`` on phase 34's DNA 16 x 131,072 x 128 (k
      = 10) equal to ``all_vs_all_topk``'s hits, and ``longpair_sw_ends``
      on phase 30's 16K pairs (linear, Gotoh) through the mesh equal to the
      one-card sweep; each wall beside its one-card entry point's;
  40. a world of 2 ranks sharing the card over gloo (this script again,
      ``--mesh-rank``; NCCL refuses two ranks on one card): the three
      calls at the same sizes (strips of 8192 rows, half the batch and of
      the database a rank) equal to phase 39's on every rank; which gloo
      collectives take CUDA tensors; the walls (one shared card: not
      scaling); and, started beside the two ranks, ``torchrun
      --nproc-per-node 2 -m swtpu_torch longpair`` over gloo prints what the
      one-card CLI prints;
  41. the harnesses: ``fuzz --rounds 22 --pairs 512`` (every family twice,
      0 mismatches), ``selftest`` (JAX's 23 checks, every one ok on the
      card's kernels) and ``profile_trace`` around one 1M SpeedTest
      ``best_engine`` call: the kernels' busy share of the trace's window;
  42. the benchmark suite (``swtpu_torch/bench_suite.py``) in children on
      the card, as a user runs it: ``python -m swtpu_torch bench`` (every
      section at full size) and ``bench --suite dist --quick --cpu-mesh 2``
      (the anchor in a world of one under NCCL, the gloo curve in
      ``torchrun`` worlds of 1 and 2 CPU ranks): exit 0, JAX's kernel names
      in JAX's order, every parity field true, each section's wall; the
      suite's launches (its timing loops included) in the ``kernels``
      line's ``bench_launches``;
  43. the per-round band past W = 128 (``csrc/sw_xdrop.cu``, where JAX's
      TPU dispatch runs its XLA forward: to W = 256 one warp a pair,
      ``xdrop_wide_warp_kernel``; past it ``xdrop_wide_kernel``, a CTA a
      pair of warps of 128 register cells, one barrier a round):
      every field below n_rounds equal to the plain version at W = 129,
      160, 256, 512 and 1024 on 24 related 300-mers (linear
      with per-pair lengths, Gotoh 3/1 with the 8-bit history, BLOSUM62
      11/1 at X = 120), the wide launch equal to the warp kernel at W = 32,
      96 and 128; the main path: ``banded --random 8x16384x16384
      --bandwidth 256 --traceback`` and ``banded_align_batch`` on 8 related
      16384-mers at W = 256 through the device walk, equal to the host
      walk, ``banded --bandwidth 160`` and ``--bandwidth 384 --traceback
      --cigar`` equal to ``--device cpu``, ``map_reads`` with paths and
      ``map --bandwidth 160`` equal to the card's route on the CPU; times
      at 256 related 2048-mers, scores only, W = 256 (the one-warp form)
      and 512 (the CTA), beside the bound of ``xdrop_ops``;
  44. the general local engine (``csrc/sw_general.cu``, where JAX's TPU
      dispatch runs its XLA tier; its tile form where no gap penalty is
      negative, its sweep form else): scores and endpoints equal to the
      plain tier under gap 0, gap -1, Gotoh 3/0 and ``dna_matrix(200, -150)``
      linear 5 and Gotoh 30/5 on 4096 x 128 x 128, 1000 x 90 x 200, 33 x 7
      x 1 and 64 x 300 x 40; the main path: ``best_engine`` and
      ``best_ends_engine`` with gap 0 at 32768 x 128 x 128, ``align
      --traceback --cigar --gap 0`` and ``align --traceback`` with Gotoh
      3/0 equal to ``--device cpu``; times at 32768 x 128 x 128, gap 0 and
      Gotoh 3/0, scores and endpoints, the tile form (the main path's) and,
      at gap 0 scores, the sweep form beside it, beside the bound of the
      profile thread form's cell (``general_pipe``) over the n x m cells
      a pair;
  45. gap penalties of 0 and below and matrix entries past +-127, where
      JAX's device serves them and the card refused them before: the
      wavefront kernel (B14) under a negative gap, one pair a stream on the
      TPU's schedule, at gap -1 and -3 on n = 7, 100 and 128 (B = 1, 3,
      200; DNA on both tables, BLOSUM62) against its plain version and
      mirror; B13 (pipelined and one-block) under linear -1, Gotoh 2/-1
      and 3/0 on 1 x 1 to 16383 x 33 with random boundaries against the
      plain tile; both semi-global forms under gap 0, -1, Gotoh 2/-1, 3/0,
      0/1, BLOSUM62 11/0, 11/-1 and x 12, argmax (both trackers) and
      pinned, fixed and per-pair lengths, against the plain tier and the
      CPU mirror; the main path: ``align --random 8x128x128 --engine
      wavefront --gap -1`` (fault C4: 256 a pair, B14 launched), the
      wavefront at 128 and 8192 pairs, ``longpair_sw_ends`` on phase 30's
      16K pair at gap -1 and Gotoh 2/-1 against the host's full forward,
      the ``longpair``, ``semiglobal`` and ``global`` CLI against
      ``--device cpu``, the semi-global forms at 32768 and 1M x 128 x 128
      (gap 0, -1, BLOSUM62 11/0); times beside the bound; their rows
      (``*_negative``, ``*_gaps``) in the kernels line, by form.
      ``python3 chip_smoke.py --phase 45`` runs phases 1, 2 and 45 alone.

Depth cut to keep the run near 600 s (PERF.md section 4): phase 16's
profile form sweep, phase 27's 128-pair 16K set, phase 34's in-smoke reps
(one timed rep a mode).

Launch counts are zeroed just before each path (phases 4, 7, 11, 17, 22,
26, 30, 34, 35 and 36) and read just after it (phases 6, 10, 15, 21, 25, 29,
33, 34, 35 and 38; rows 1-6 add phase 35's launches to their own and keep
phase 34's, every one a chunk of 131,072 pairs, in ``search_launches``,
charged at that shape's own time in ``search_lost_ms``; phases 36-38's
launches, the models' window, go in ``models_launches``, phases 39-40's,
the mesh's window with both ranks' of phase 40, in ``mesh_launches``,
phase 41's, the harnesses' window, in ``harness_launches``, and phase
42's, the suite's, in ``bench_launches``; phases 43, 44 and 45 zero and
read their own kernels' counts around their main path); every
kernel of a path must have launched in its window (B10 excepted: the block
tier's one-launch B9 reads the corridor window itself, so B10 runs only on
the negative-gap route and its count there must be 0); B13's are also
counted by tile size. A window counts each entry-point call once: every
timing loop (``timed``), warm-up and check that launches a kernel runs
between a ``snapshot`` of the counts and their ``restore`` (``off_path``),
in every window. Any failed check raises, and the run exits nonzero.
Without a card it exits 2 and prints no result.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 45   # phases 1, 2 and 45 alone
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import functools
import hashlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 10000
T_START = time.perf_counter()  # phase headers and the total count from here
# the 1M-pair calls (phases 4, 7, 17, 18, 22) are held against their plain
# version on their first quarter
CHECK_PAIRS = 1 << 16
ROWSCAN, PROFILE, BF16 = "sw_rowscan.cu", "sw_profile.cu", "sw_bf16.cu"
SEMIGLOBAL = "sw_semiglobal.cu"
SG_KERNEL = "sw_semiglobal_kernelI"  # + <AFFINE, PROFILE, END> as nvcc mangles them
RS_KERNEL = "sw_rowscan_kernelI"  # + <AFFINE, END, WIDE>
PT_KERNEL = "sw_profile_kernelI"  # the profile thread form, + <AFFINE, END>
BANDED, XDROP = "sw_banded.cu", "sw_xdrop.cu"
BLOCK, WALK = "sw_block.cu", "sw_walk.cu"
STRIP, WAVEFRONT = "sw_strip.cu", "sw_wavefront.cu"
GENERAL = "sw_general.cu"
SOURCES = [ROWSCAN, PROFILE, BF16, SEMIGLOBAL, BANDED, XDROP, BLOCK, WALK, STRIP,
           WAVEFRONT, GENERAL]
SWISSPROT = Path(__file__).resolve().parent / "swtpu" / "data" / "swissprot_like_256.fasta"
# DRAM rate of an H100 SXM (NVIDIA data sheet). Results per clock per SM
# at compute capability 9.0 (CUDA C++ Programming Guide, "Throughput of
# Native Arithmetic Instructions"): 64 for 32-bit integer add, compare,
# min/max and logical operations (the packed 16-bit float ops' rate is
# the one phase 2's probe measures, two results a lane). Shared memory: 32 banks, one
# 32-bit word each per clock. 32-bit integer multiply-add (IMAD, which
# ptxas also uses for adds and moves) issues on the FMA pipe, 64 a clock
# per SM beside the ALU's 64; four schedulers issue one warp instruction
# a clock each, 128 lanes per SM in all.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
SMEM_WORDS_PER_SM = 32

# kernel -> (source, mangled-name fragment in nvcc's report, the TPU
# kernel it replaces, int32 ops per DP cell the function needs, shared-memory
# lookups per cell, bf16 results per cell). Local row-scan (since PR 13 the
# skewed tile of csrc/sw_local_tile.cuh; H kept minus the gap open): the
# uniform score 3 (compare, select, the pad's min), linear H 2 (the
# diagonal's add, a DPX three-way max with the 0 floor), Gotoh 4 (E and F
# a DPX add-max each, the add, the three-way max), D's subtract 1, and the
# score's best half a three-way max (ends: the key's multiply-add and a
# max, 2): 6.5 / 8 / 8.5 / 10 (linear scores / ends, Gotoh scores / ends);
# the profile forms score by the lane table's offset add and a lookup, 1:
# 4.5 / 6 / 6.5 / 8. PR 1 and PR 2 counted the kernels as written, every op
# on the ALU: 9 / 11 / 14 / 16 (score select 3: compare, select, pad
# select; linear H 5: add, max 0, max(up, left), subtract gap, max; affine
# F 3 + E 3 + H 4; best 1 or, for ends, 3: compare, two selects) and 7 / 9
# / 12 / 14 (profile: the table offset add and a lookup for the select).
# bf16: one word covers two cells, one per half; per word the xor, the
# match indicator (one DPX op), the score's IMAD, the three-way max of the
# cell (DPX on the 16-bit patterns) and half of a three-way max for the
# best, and two packed bf16 ops (fma.relu, the subtract of G): 2.25 int32
# ops and 2 bf16 results a cell (the earlier kernel: 2 and 5). Semi-global (no max 0; H kept minus the gap
# open, which the score carries): the score 2 (compare, select; profile:
# the lane-table offset add and a lookup, 1), linear H 3 (the diagonal's
# DPX add-max, the max of up and left, the subtract), Gotoh 5 (E and F a
# DPX add-max each, the diagonal's add-max, the max, the subtract), the
# argmax 2 (the key's multiply-add and a max; the pinned forms track
# nothing: the corner is a row's last cell): lowered from the unskewed
# kernel's 9 / 7 / 14 / 12 (uniform) and 8 / 6 / 13 / 11 (profile) to what
# the DPX form needs; phase 2 prints the instructions a cell as compiled.
# Rows 1-10 and 17 are bounded by pipe: see ALU_OPS. The fixed band (H kept minus the
# gap open): the score 2 (compare, select; profile: the table offset add
# and a lookup, 1), linear H 2 (the diagonal's add, a DPX three-way max
# with the floor), Gotoh 4 (E and F a DPX add-max each, the add, the
# three-way max), G's subtract 1, half of a three-way max for the best:
# 5.5 / 7.5 uniform, 4.5 / 6.5 profile per in-band cell (the earlier
# kernel's row-scan counts: 9 / 14, 7 / 12).
KERNELS = {
    # <AFFINE, END, WIDE>: END 0 the score, 1 / 2 the endpoint with its
    # packed key / with (best, step) apart; WIDE the pad select for scores
    # past the min cap's range
    "sw_batch": (ROWSCAN, (RS_KERNEL + "Lb0ELi0ELb0E", RS_KERNEL + "Lb0ELi0ELb1E"),
                 "swtpu/kernels/pallas/sw_batch.py:317", 6.5, 0, 0),
    "sw_batch_ends": (ROWSCAN, (RS_KERNEL + "Lb0ELi1E", RS_KERNEL + "Lb0ELi2ELb0E",
                                RS_KERNEL + "Lb0ELi2ELb1E"),
                      "swtpu/kernels/pallas/sw_batch.py:215", 8, 0, 0),
    "sw_affine": (ROWSCAN, (RS_KERNEL + "Lb1ELi0ELb0E", RS_KERNEL + "Lb1ELi0ELb1E"),
                  "swtpu/kernels/pallas/sw_affine.py:145", 8.5, 0, 0),
    "sw_affine_ends": (ROWSCAN, (RS_KERNEL + "Lb1ELi1E", RS_KERNEL + "Lb1ELi2ELb0E",
                                 RS_KERNEL + "Lb1ELi2ELb1E"),
                       "swtpu/kernels/pallas/sw_affine.py:175", 10, 0, 0),
    # the profile kernel's thread form <AFFINE, END>
    "sw_profile": (PROFILE, PT_KERNEL + "Lb0ELi0E",
                   "swtpu/kernels/pallas/sw_profile.py:287", 4.5, 1, 0),
    "sw_profile_ends": (PROFILE, (PT_KERNEL + "Lb0ELi1E", PT_KERNEL + "Lb0ELi2E"),
                        "swtpu/kernels/pallas/sw_profile.py:353", 6, 1, 0),
    "sw_profile_affine": (PROFILE, PT_KERNEL + "Lb1ELi0E",
                          "swtpu/kernels/pallas/sw_profile.py:287", 6.5, 1, 0),
    "sw_profile_affine_ends": (PROFILE, (PT_KERNEL + "Lb1ELi1E", PT_KERNEL + "Lb1ELi2E"),
                               "swtpu/kernels/pallas/sw_profile.py:353", 8, 1, 0),
    # the profile kernel's warp form (a warp per pair, for batches too small
    # to fill the card): the same function, so the same counts
    "sw_profile_warp": (PROFILE, "sw_profile_warp_kernelILb0ELb0E",
                        "swtpu/kernels/pallas/sw_profile.py:287", 4.5, 1, 0),
    "sw_profile_ends_warp": (PROFILE, "sw_profile_warp_kernelILb0ELb1E",
                             "swtpu/kernels/pallas/sw_profile.py:353", 6, 1, 0),
    "sw_profile_affine_warp": (PROFILE, "sw_profile_warp_kernelILb1ELb0E",
                               "swtpu/kernels/pallas/sw_profile.py:287", 6.5, 1, 0),
    "sw_profile_affine_ends_warp": (PROFILE, "sw_profile_warp_kernelILb1ELb1E",
                                    "swtpu/kernels/pallas/sw_profile.py:353", 8, 1, 0),
    "sw_bf16": (BF16, "sw_bf16_kernel",
                "swtpu/kernels/pallas/sw_bf16.py:134", 2.25, 0, 2),
    # <AFFINE, PROFILE, END>: END 0 / 1 the argmax with its packed key /
    # with (best, step) apart (scores too wide for the key), 2 the pinned
    # (global) forms, which extend the TPU kernel (JAX ran it for the
    # argmax only)
    "semiglobal_batch": (SEMIGLOBAL, (SG_KERNEL + "Lb0ELb0ELi0E", SG_KERNEL + "Lb0ELb0ELi1E"),
                         "swtpu/kernels/pallas/semiglobal_batch.py:194", 7, 0, 0),
    "semiglobal_batch_pinned": (SEMIGLOBAL, SG_KERNEL + "Lb0ELb0ELi2E",
                                "swtpu/kernels/pallas/semiglobal_batch.py:194", 5, 0, 0),
    "semiglobal_batch_affine": (SEMIGLOBAL, (SG_KERNEL + "Lb1ELb0ELi0E",
                                             SG_KERNEL + "Lb1ELb0ELi1E"),
                                "swtpu/kernels/pallas/semiglobal_batch.py:194", 9, 0, 0),
    "semiglobal_batch_affine_pinned": (SEMIGLOBAL, SG_KERNEL + "Lb1ELb0ELi2E",
                                       "swtpu/kernels/pallas/semiglobal_batch.py:194",
                                       7, 0, 0),
    "semiglobal_profile": (SEMIGLOBAL, (SG_KERNEL + "Lb0ELb1ELi0E", SG_KERNEL + "Lb0ELb1ELi1E"),
                           "swtpu/kernels/pallas/semiglobal_profile.py:201", 6, 1, 0),
    "semiglobal_profile_pinned": (SEMIGLOBAL, SG_KERNEL + "Lb0ELb1ELi2E",
                                  "swtpu/kernels/pallas/semiglobal_profile.py:201", 4, 1, 0),
    "semiglobal_profile_affine": (SEMIGLOBAL, (SG_KERNEL + "Lb1ELb1ELi0E",
                                               SG_KERNEL + "Lb1ELb1ELi1E"),
                                  "swtpu/kernels/pallas/semiglobal_profile.py:201", 8, 1, 0),
    "semiglobal_profile_affine_pinned": (SEMIGLOBAL, SG_KERNEL + "Lb1ELb1ELi2E",
                                         "swtpu/kernels/pallas/semiglobal_profile.py:201",
                                         6, 1, 0),
    # fixed band <AFFINE, PROFILE>: the DPX cell's counts per in-band cell
    "sw_banded_static": (BANDED, "sw_banded_kernelILb0ELb0E",
                         "swtpu/kernels/pallas/sw_banded.py:239", 5.5, 0, 0),
    "sw_banded_static_affine": (BANDED, "sw_banded_kernelILb1ELb0E",
                                "swtpu/kernels/pallas/sw_banded.py:239", 7.5, 0, 0),
    "sw_banded_profile": (BANDED, "sw_banded_kernelILb0ELb1E",
                          "swtpu/kernels/pallas/sw_banded.py:239", 4.5, 1, 0),
    "sw_banded_profile_affine": (BANDED, "sw_banded_kernelILb1ELb1E",
                                 "swtpu/kernels/pallas/sw_banded.py:239", 6.5, 1, 0),
    # the per-round kernel <CPL, AFFINE, MATRIX, HIST, EXACT> and, timed
    # beside it, the earlier one <CPL, AFFINE>: one source, two TPU rows; the
    # W = 32 / 64 calls (CPL 1, 2) stand for the packed TPU kernel. Its ops
    # are counted per cell and per pair and round: see xdrop_ops
    "banded_batch": (XDROP, tuple(f"{k}ILi{c}E" for k in ("xdrop_round_kernel",
                                                           "sw_xdrop_kernel")
                                  for c in (1, 2, 3, 4)),
                     "swtpu/kernels/pallas/banded_batch.py:493", None, 0, 0),
    "banded_batch_w32_w64": (XDROP, tuple(f"{k}ILi{c}E" for k in ("xdrop_round_kernel",
                                                                   "sw_xdrop_kernel")
                                          for c in (1, 2)),
                             "swtpu/kernels/pallas/banded_packed.py:412", None, 0, 0),
    # the block tier: B9 for both TPU forms, the one-launch forward (a warp
    # per pair) and, for negative gap penalties, the per-block kernel (a
    # thread per pair); its launches on the batches JAX would have folded
    # count for row 12 (see b9_shape); ops per band cell, pair-row and
    # pair-block: see block_ops
    "block_rows": (BLOCK, ("block_fwd_kernel", "block_rows_kernel"),
                   "swtpu/kernels/pallas/banded_block.py:827", None, 0, 0),
    "block_rows_small": (BLOCK, ("block_fwd_kernel", "block_rows_kernel"),
                         "swtpu/kernels/pallas/banded_block.py:761", None, 0, 0),
    "block_gather": (BLOCK, "block_gather_kernel",
                     "swtpu/kernels/pallas/banded_block.py:872", None, 0, 0),
    # the device walkers port XLA code (no row of the TPU table): the map
    # kernels, and the earlier one-thread-a-pair kernels timed beside them
    "block_walk": (WALK, ("block_walk_kernel", "block_walk_serial_kernel"),
                   "swtpu/kernels/pallas/banded_block.py:1275", None, 0, 0),
    "xdrop_walk": (WALK, ("xdrop_walk_kernel", "xdrop_walk_serial_kernel"),
                   "swtpu/kernels/xla/banded_scan.py:334", None, 0, 0),
    # the long-pair strip tile <BR, AFFINE> (B13: the pipelined warp bands,
    # and the one-block kernel timed beside it) and the wavefront (B14);
    # ops per cell: see strip_ops, and ALU_OPS for B14
    "strip_tile": (STRIP, ("strip_pipe_kernel", "strip_tile_kernel"),
                   "swtpu/kernels/pallas/longpair_strip.py:263", None, 0, 0),
    # <PAIRS>: the lane table by pairs of columns (alphabets of up to 4
    # letters) or by columns. Ops and lookups a cell at the row's shape
    # (DNA): 4.0 and half a lookup, since an 8-byte lookup and its add
    # serve two cells; by columns (protein) 4.5 and one (see ALU_OPS)
    "sw_wavefront": (WAVEFRONT, ("sw_wavefront_kernelILb0E", "sw_wavefront_kernelILb1E"),
                     "swtpu/kernels/pallas/sw_wavefront.py:110", 4.0, 0.5, 0),
    # the counterparts of JAX's XLA tier where its TPU dispatch runs it (no
    # row of the TPU table): the per-round band past W = 128, its one-warp
    # form <CPL, AFFINE, MATRIX, HIST, EXACT> to W = 256 and its CTA <AFFINE,
    # MATRIX, HIST, EXACT> (ops: xdrop_ops) and the general local engine,
    # its tile form <AFFINE, END> and its sweep form <AFFINE, ENDS> (ops:
    # the profile thread form's cell, general_pipe)
    "banded_batch_wide": (XDROP, ("xdrop_wide_warp_kernel", "xdrop_wide_kernel"),
                          "swtpu/kernels/xla/banded_scan.py:66", None, 0, 0),
    "sw_general": (GENERAL, tuple(f"sw_general_tile_kernelILb{a}ELi{e}E" for a in (0, 1)
                                  for e in (0, 1, 2))
                   + tuple(f"sw_general_kernelILb{a}ELb{e}E" for a in (0, 1)
                           for e in (0, 1)),
                   "swtpu/kernels/xla/sw_scan.py:126", None, 1, 0),
}
# the int32 ops a cell that only the ALU pipe issues, for the kernels
# bounded by pipe (rows 1-10 and 17): the compare and select of the uniform
# score (local: and the pad's min), every max and DPX op (local linear H
# 1, Gotoh 3, half a three-way max for the score's best or the key's max;
# semi-global linear H 2, Gotoh 4, the
# argmax key's max; fixed band the compare and select, the three-way max,
# E and F, half a three-way max for the best; bf16 the xor, the
# indicator, the cell's three-way max and half of the best's). The rest of
# KERNELS' count (the subtract of D or G, the diagonal's add, the key's
# multiply-add, the profile's table offset, bf16's score IMAD) can
# issue as IMADs on the FMA pipe, and bf16's packed float ops on the FMA
# pipe too, so a cell takes at least max(ALU ops / 64, all instructions /
# 128) clocks of an SM (pipe_slots), and bf16 its bf16 results at the
# rate phase 2's probe measures. The wavefront (row 17) computes the local
# linear profile cell too (4.5 / 1.5; PR 7 counted 8 as written), its DNA
# form with half a lookup's add a cell (4.0 / 1.5)
ALU_OPS = {
    "sw_batch": 4.5, "sw_batch_ends": 5, "sw_affine": 6.5, "sw_affine_ends": 7,
    "sw_profile": 1.5, "sw_profile_ends": 2, "sw_profile_affine": 3.5,
    "sw_profile_affine_ends": 4,
    "sw_profile_warp": 1.5, "sw_profile_ends_warp": 2, "sw_profile_affine_warp": 3.5,
    "sw_profile_affine_ends_warp": 4,
    "sw_wavefront": 1.5,
    "semiglobal_batch": 5, "semiglobal_batch_pinned": 4,
    "semiglobal_batch_affine": 7, "semiglobal_batch_affine_pinned": 6,
    "semiglobal_profile": 3, "semiglobal_profile_pinned": 2,
    "semiglobal_profile_affine": 5, "semiglobal_profile_affine_pinned": 4,
    "sw_bf16": 1.75,
    "sw_banded_static": 3.5, "sw_banded_static_affine": 5.5,
    "sw_banded_profile": 1.5, "sw_banded_profile_affine": 3.5,
}
DNA_PATH = ["sw_batch", "sw_batch_ends", "sw_affine", "sw_affine_ends"]
PROTEIN_PATH = ["sw_profile", "sw_profile_ends", "sw_profile_affine",
                "sw_profile_affine_ends", "sw_profile_warp", "sw_profile_ends_warp",
                "sw_profile_affine_warp", "sw_profile_affine_ends_warp"]
CONFIG4_PATH = ["sw_bf16", "sw_batch"]
SEMIGLOBAL_PATH = [k for k, v in KERNELS.items() if v[0] == SEMIGLOBAL]
# phases 43 and 44 (the XLA tier's counterparts) count their own launches
XLA_TIER_PATH = ["banded_batch_wide", "sw_general"]
BANDED_PATH = [k for k, v in KERNELS.items()
               if v[0] in (BANDED, XDROP) and k not in XLA_TIER_PATH]
BLOCK_PATH = [k for k, v in KERNELS.items() if v[0] in (BLOCK, WALK)]
LONGPAIR_PATH = ["strip_tile", "sw_wavefront"]
# search scores on rows 1, 3 and 5 and walks its hits on rows 2, 4 and 6:
# DNA uniform (1,-1,1) and Gotoh, protein BLOSUM62 11/1 (the profile form
# the rule picks: the thread form for the 131,072-pair chunks, the warp
# form for the few hits)
SEARCH_PATH = DNA_PATH + PROTEIN_PATH
SEARCH_NEEDS = [("sw_batch",), ("sw_batch_ends",), ("sw_affine",), ("sw_affine_ends",),
                ("sw_profile_affine", "sw_profile_affine_warp"),
                ("sw_profile_affine_ends", "sw_profile_affine_ends_warp")]


def pipe_slots(name):
    """A kernel's work a cell in ALU-lane slots (the int32 rate's unit),
    for the kernels bounded by pipe: its ALU-only ops, or all its
    instructions (int32 ops, and a packed bf16 instruction per two bf16
    results) at the issue rate, whichever takes longer."""
    instr = KERNELS[name][3] + KERNELS[name][5] / 2
    return max(ALU_OPS[name], instr * INT32_LANES_PER_SM / DISPATCH_LANES_PER_SM)


def xdrop_ops(affine, matrix):
    """ALU slots (the int32 rate's unit) the per-round X-drop function
    needs in its DPX form, by pipe as ALU_OPS counts: (per band cell, per
    pair and round), each the larger of its ALU-only ops and all its ops /
    2 (adds and subtracts can issue as IMADs on the FMA pipe). Per cell,
    linear: the uniform score 2 (compare, select; the matrix: the table
    offset add, its lookup counted apart), the diagonal's add 1, H one
    three-way max with the 0 floor (__vimax3_s32_relu; a dead neighbour
    reads as -2^29, so no dead test), the gap's subtract 1 (H kept minus
    it), the X-drop 2 (compare, select) and the round max 1: 8 ops, 6 only
    on the ALU. Gotoh: E and F one add-max with the floor each
    (__viaddmax_s32_relu) and their clears with the cell's cut 2 (selects):
    12 ops, 10 on the ALU. Once per pair and round: the direction compare,
    the cursor add and its overrun test, the max update 3 (compare, two
    selects), the cut max - X, the dead-round test and the loop 2 (add,
    compare): 10 ops, 7 on the ALU. Not counted, as the kernel's own cost:
    the moves' selects, the other move's score and diagonal (both are
    formed ahead of the direction), character addresses and shuffles, the
    padding cap of cells past W, and the per-round work that every lane
    repeats (phase 2 prints the round body's instructions a cell as
    compiled beside this count). The plain tier's op count, 15 a linear
    cell (+10 Gotoh, -2 matrix), exceeds what the DPX body issues."""
    cell_alu, cell_ops = 6 + 4 * affine - 2 * matrix, 8 + 4 * affine - matrix
    round_alu, round_ops = 7, 10
    half = INT32_LANES_PER_SM / DISPATCH_LANES_PER_SM
    return max(cell_alu, cell_ops * half), max(round_alu, round_ops * half)


def block_ops(affine, matrix, W):
    """int32 ops the block X-drop function needs (oracle/banded_block.py):
    (per band cell, per pair and row, per pair and block), counted as
    xdrop_ops counts. Per cell, linear: the uniform score 3 (compare, pad
    test, select; the matrix: the table offset add 1, its lookup counted
    apart), the diagonal 3 (dead test, add, floor at 0), up 2 and left 2
    (subtract, max: with gaps >= 0 the floor makes the dead tests
    redundant) and the row max 1: 11. Gotoh: the score 3, the diagonal 3,
    F 5 and E 5 (two dead tests, two subtracts, a max each), H's max 3, the
    death 3 (compare, two selects), the floors of E and F 2 and the row max
    1: 25. Per pair and row: the row's base, the pin chain 2, the slot-0
    left test 2, the query code offset, the strict row-max test, and the
    column-0 pin, which holds at most one slot a row (linear 2: compare,
    select; Gotoh 4: compare, three selects): 9 linear, 11 Gotoh. Per pair
    and block: the X-drop and the first argmax 4 a slot (compare, select,
    compare, select), the realign 1 a slot (Gotoh 3: F too), the delta
    clip 4, the state and bookkeeping 10: 5 W + 14 linear, 7 W + 14 Gotoh."""
    cell = (25 if affine else 11) - 2 * matrix
    return cell, 9 + 2 * affine, 5 * W + 14 + 2 * W * affine


def strip_ops(affine):
    """int32 ops the tile function needs per DP cell, counted as the
    kernel table counts them: the score (the table offset add; its lookup
    counted apart), linear H 5 (diagonal add, floor at 0, max of up and
    left, the gap subtract, the max), Gotoh E 3 and F 3 (two subtracts and
    a max each), the candidate 3 (add, max with E, floor at 0) and H's max
    with F 1, and the row-major-first endpoint 3 (compare, two selects):
    9 linear, 14 Gotoh."""
    return 14 if affine else 9


#: int32 ops a device-walk step needs: the three neighbours' reads (row
#: base or pos_y, slot, band test, dead test: 8 each), the score 4, the
#: three equality tests with their guards 9, the move select and the cursor
#: updates 6, the 2-bit packing 3
WALK_OPS = 46


def in_band_cells(n, m, W):
    """Cells (i, j), 1 <= i <= n, 1 <= j <= m, with |i - j| <= W."""
    i = np.arange(1, n + 1)
    return int(np.clip(np.minimum(m, i + W) - np.maximum(1, i - W) + 1, 0, None).sum())


#: SASS opcodes that are not int32 ALU work: shuffles and reductions,
#: memory, control, and the uniform datapath (U*)
NOT_ALU = ("SHFL", "REDUX", "VOTE", "LDG", "STG", "LDS", "STS", "LDC", "ULDC", "BRA",
           "BSSY", "BSYNC", "EXIT", "WARPSYNC", "NOP", "CALL", "RET", "BAR", "S2R",
           "S2UR", "CS2R", "ENDCOLLECTIVE", "ELECT", "PLOP3", "MEMBAR", "ATOM", "RED",
           "U")
BRANCH = re.compile(r"BRA(?:\.U)?\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)")


@functools.lru_cache(maxsize=None)
def sass_text(lib, cuobjdump):
    """``cuobjdump -sass`` of a built library (once a library)."""
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def sass_of(lib, fragment, cuobjdump):
    """[(address, instruction)] of the kernel whose mangled name holds
    ``fragment`` in a built library (``cuobjdump -sass``)."""
    for f in re.split(r"\n\s*Function : ", sass_text(lib, cuobjdump))[1:]:
        if fragment in f.split("\n")[0]:
            return [(int(m.group(1), 16), m.group(2).strip()) for m in (
                re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", x) for x in f.split("\n"))
                if m]
    raise KeyError(fragment)


def loop_ops(ins, marker="REDUX"):
    """int32 ALU instructions in a pass of a kernel's round loop as
    compiled: the shortest backward branch whose body holds ``marker`` (one
    a round) and no EXIT (a divergence fallback jumps back into the loop
    from past it), every instruction of its body counted once but the basic
    blocks that store (a history write, which a scores-only call skips),
    register moves apart. Returns (ALU instructions, moves, rounds a pass)."""
    addr = {a: i for i, (a, _) in enumerate(ins)}
    best = None
    for i, (a, op) in enumerate(ins):
        m = BRANCH.search(op)
        if m and "BRA.DIV" not in op:
            tgt = int(m.group(1), 16)
            body = ins[addr[tgt]:i + 1] if tgt < a and tgt in addr else []
            if (any(marker in o for _, o in body) and not any("EXIT" in o for _, o in body)
                    and (best is None or len(body) < len(best))):
                best = body
    check(best is not None, f"no round loop holding {marker} in the SASS")
    targets = {int(x, 16) for _, o in best for x in BRANCH.findall(o)}
    blocks, cur = [], []
    for a, o in best:
        if a in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append(o.split()[1] if o.startswith("@") else o.split()[0])
        if "BRA" in o:
            blocks.append(cur)
            cur = []
    ops = [x for blk in blocks + [cur] if not any(y.startswith("STG") for y in blk)
           for x in blk]
    moves = sum(x.startswith(("MOV", "IMAD.MOV")) for x in ops)
    alu = sum(not x.startswith(NOT_ALU) for x in ops) - moves
    return alu, moves, sum(marker in x for x in ops)


def group_loop_ops(ins, marker, count, cells):
    """int32 and bf16 instructions a cell of a kernel's unmasked group of
    steps as compiled (``cells`` cells, their code, scratch and ring work
    included): the shortest loop with ``count`` instructions whose opcode
    starts with ``marker`` (one group's cells; a masked form of the group
    adds its tests and selects, so it is longer). Returns (ALU
    instructions, IMADs, moves, packed bf16 instructions, cells); IMADs and
    the packed bf16 ops (H*) issue on the FMA pipe, moves (MOV, IMAD.MOV)
    are counted apart."""
    addr = {a: i for i, (a, _) in enumerate(ins)}

    def opc(o):
        return o.split()[1] if o.startswith("@") else o.split()[0]

    loops = []
    for i, (a, o) in enumerate(ins):
        m = BRANCH.search(o)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in addr:
            loops.append([opc(x) for _, x in ins[addr[int(m.group(1), 16)]:i + 1]])
    for ops in sorted(loops, key=len):
        if sum(x.startswith(marker) for x in ops) == count:
            moves = sum(x.startswith(("MOV", "IMAD.MOV")) for x in ops)
            imad = sum(x.startswith("IMAD") for x in ops) - sum(
                x.startswith("IMAD.MOV") for x in ops)
            half = sum(x.startswith(("HFMA2", "HADD2", "HMUL2", "HMNMX2")) for x in ops)
            alu = sum(not x.startswith(NOT_ALU) for x in ops) - moves - imad - half
            return alu, imad, moves, half, cells
    raise RuntimeError(f"check failed: no group loop with {count} {marker}")


def wavefront_loop_ops(ins, cells):
    """The wavefront kernel's iteration loop as compiled: the shortest loop
    holding ``cells`` VIADDMNMX.RELU (one a cell, 8 x 8 an iteration; the
    table by column pairs runs two iterations a pass).
    Blocks a forward branch in the loop skips (the ring's refill, one
    iteration in 8; the forcing step, once a pair a lane, which the warp
    runs in nearly every iteration) are counted apart. Returns (ALU
    instructions, IMADs, moves, lookups (LDS), other instructions of the
    path every iteration runs; instructions of the skipped blocks)."""
    addr = {a: i for i, (a, _) in enumerate(ins)}

    def opc(o):
        return o.split()[1] if o.startswith("@") else o.split()[0]

    body = None
    for i, (a, o) in enumerate(ins):
        m = BRANCH.search(o)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in addr:
            loop = ins[addr[int(m.group(1), 16)]:i + 1]
            if (sum(opc(x).startswith("VIADDMNMX.RELU") for _, x in loop) == cells
                    and (body is None or len(loop) < len(body))):
                body = loop
    check(body is not None, f"no wavefront loop with {cells} VIADDMNMX.RELU")
    end = body[-1][0]
    skipped = set()
    for a, o in body[:-1]:
        m = BRANCH.search(o)
        if m and a < int(m.group(1), 16) <= end:
            skipped.update(x for x, _ in body if a < x < int(m.group(1), 16))
    ops = [opc(o) for a, o in body if a not in skipped]
    moves = sum(x.startswith(("MOV", "IMAD.MOV")) for x in ops)
    imad = sum(x.startswith("IMAD") for x in ops) - sum(x.startswith("IMAD.MOV") for x in ops)
    lds = sum(x.startswith("LDS") for x in ops)
    alu = sum(not x.startswith(NOT_ALU) for x in ops) - moves - imad
    return alu, imad, moves, lds, len(ops) - alu - imad - moves - lds, len(skipped)


def probe_rates(cuobjdump, n_sm, clock_hz):
    """Phase 2's pipe-rate probe (tools/pipe_probe.cu): each instruction
    kind's results a lane-clock of an SM, {SASS opcode: lanes}, from its
    kernel's loop as compiled (`cuobjdump`) and its time on a full card."""
    from swtpu_torch.kernels import _build
    from swtpu_torch.utils import time_kernel

    src = Path(__file__).resolve().parent / "tools" / "pipe_probe.cu"
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "pipe_probe.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                        str(src)], check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.swtpu_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        lib.swtpu_probe_names.restype = ctypes.c_char_p
        names = lib.swtpu_probe_names().decode().split()
        threads, iters = 256, 1024
        blocks = n_sm * 8  # 2048 threads an SM: full occupancy
        out = torch.empty(threads * blocks, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        rates = {}
        singles = [x for x in names if "+" not in x]
        for k, name in enumerate(names):
            # the kernel's template pair: a kind alone runs <k, k>, a mix <A, B>
            a, b = (singles.index(x) for x in (name.split("+") * 2)[:2])
            ins = sass_of(lib_path, f"probe_kernelILi{a}ELi{b}E", cuobjdump)
            body = loop_body(ins)
            # the kind's instructions: the opcodes of its 128 a pass (ptxas
            # may split a kind over two opcodes, e.g. HFMA2 and HFMA2.MMA),
            # not the loop's few bookkeeping ones
            kinds = {o: c for o, c in collections.Counter(body).items() if c >= 32}
            per_iter = sum(kinds.values())
            compiled = " + ".join(f"{c} {o}" for o, c in sorted(kinds.items()))
            check(per_iter >= 128, f"probe {name}: {compiled} in its loop")

            def run(k=k):
                check(lib.swtpu_probe(k, blocks, threads, iters, out.data_ptr(), stream) == 0,
                      f"probe {name} launch")

            sec = time_kernel(run, (), iters=5)
            rates[name] = per_iter * iters * threads * blocks / (sec * clock_hz * n_sm)
            verdict = ""
            if "+" in name:  # two kinds together: one pipe, or two
                alone = max(rates[x] for x in name.split("+"))
                verdict = (f" (alone {' / '.join(f'{rates[x]:.1f}' for x in name.split('+'))}:"
                           f" {'one pipe' if rates[name] < 1.5 * alone else 'two pipes'})")
            print(f"pipe probe {name}: {compiled} a loop pass of {len(body)} "
                  f"instructions, {rates[name]:.1f} lanes an SM a clock{verdict}", flush=True)
    return rates


def loop_body(ins):
    """Opcodes of the shortest backward-branch loop of a kernel's SASS."""
    addr = {a: i for i, (a, _) in enumerate(ins)}
    best = None
    for i, (a, o) in enumerate(ins):
        m = BRANCH.search(o)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in addr:
            body = ins[addr[int(m.group(1), 16)]:i + 1]
            if best is None or len(body) < len(best):
                best = body
    check(best is not None, "no loop in the SASS")
    return [o.split()[1] if o.startswith("@") else o.split()[0] for _, o in best]


def tup(x):
    return x if isinstance(x, tuple) else (x,)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi(fields):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def mark(part):
    """A part of a phase, with the seconds since start."""
    print(f"-- {part} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def random_codes(rng, shape):
    return rng.integers(0, 4, size=shape, dtype=np.uint8)


def related_pairs(rng, B, L, letters=4):
    """Targets = the query with ~10% substitutions and a few indels,
    cut or filled with random letters to length L."""
    qs = rng.integers(0, letters, size=(B, L), dtype=np.uint8)
    ts = np.empty_like(qs)
    for b in range(B):
        t = qs[b].copy()
        sub = rng.random(L) < 0.10
        t[sub] = (t[sub] + rng.integers(1, letters, size=int(sub.sum()))) % letters
        t = list(t)
        for _ in range(int(rng.integers(1, 4))):  # deletions
            del t[int(rng.integers(0, len(t)))]
        for _ in range(int(rng.integers(1, 4))):  # insertions
            t.insert(int(rng.integers(0, len(t))), int(rng.integers(0, letters)))
        t = np.array(t[:L], dtype=np.uint8)
        ts[b, : len(t)] = t
        ts[b, len(t):] = rng.integers(0, letters, size=L - len(t), dtype=np.uint8)
    return qs, ts


def local_pairs(rng, B, n, m, letters, pads=0.03):
    """B random pairs of n x m codes below ``letters``, the first half
    related (the query's codes copied into the target's first columns),
    and a ``pads`` share of codes set to the pads (letters / letters + 1,
    protein's 24 / 25) inside both sides."""
    q = rng.integers(0, letters, (B, n)).astype(np.uint8)
    t = rng.integers(0, letters, (B, m)).astype(np.uint8)
    k = min(n, m)
    t[: B // 2, :k] = q[: B // 2, :k]
    pq, pt = (4, 5) if letters == 4 else (24, 25)
    q[rng.random(q.shape) < pads] = pq
    t[rng.random(t.shape) < pads] = pt
    return q, t


def semiglobal_pairs(rng, B, n, m, letters=4):
    """B pairs of n x m codes for the semi-global kernels: the first half
    related (a 2-letter random head, then ``related_pairs``' target of the
    query, cut or filled with random letters to m), so that their
    endpoints lie inside the matrix; the rest random."""
    qs = rng.integers(0, letters, size=(B, n), dtype=np.uint8)
    ts = rng.integers(0, letters, size=(B, m), dtype=np.uint8)
    h = B // 2
    if h and n:
        qs[:h], rel = related_pairs(rng, h, n, letters)
        head = rng.integers(0, letters, size=(h, 2), dtype=np.uint8)
        rel = np.concatenate([head, rel], axis=1)[:, :m]
        ts[:h, : rel.shape[1]] = rel
    return qs, ts


def read_set(seed, B, m=320):
    """One read set of BASELINE config 4 on the 2-bit wire, drawn as the
    JAX package's ``bench_varlen`` draws it: B reads of 100-300 bp (300
    bytes of codes each, real up to its length) and B 320-bp windows."""
    from swtpu_torch.core.encode import pack_2bit

    r = np.random.default_rng(seed)
    lens = r.integers(100, 301, B)
    qs = pack_2bit(r.integers(0, 4, size=(B, 300)).astype(np.uint8))
    ts = pack_2bit(r.integers(0, 4, size=(B, m)).astype(np.uint8))
    return qs, ts, lens


def promotion_workload(B, n=300, m=320):
    """Config 4's promotion workload, drawn as ``bench_varlen`` draws it:
    B pairs of n x m, the first B / 8 homologous (the query with 2%
    substitutions, so their scores near 300 cross the bf16 exact bound),
    the rest random; then B fresh queries for the warm-up call."""
    from swtpu_torch.core.encode import mutate

    rng = np.random.default_rng(SEED)
    qs = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(B, m)).astype(np.uint8)
    for b in range(B // 8):
        ts[b, :n] = mutate(rng, qs[b], p_mismatch=0.02, p_insert=0, p_delete=0)
    qs_warm = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    return qs, ts, qs_warm


def config3_queries(db, lens, nq=64, Lq=120):
    """BASELINE config 3's queries as the JAX package's
    ``bench_protein_swissprot`` draws them: mutated 120-mer fragments of the
    SwissProt-like targets (10% substitutions, pads replaced)."""
    crng = np.random.default_rng(SEED)
    cq = np.empty((nq, Lq), np.uint8)
    for i in range(nq):
        src = int(crng.integers(0, len(db)))
        start = int(crng.integers(0, max(1, lens[src] - Lq)))
        frag = db[src, start: start + Lq].copy()
        sub = crng.random(Lq) < 0.1
        frag[sub] = crng.integers(0, 20, int(sub.sum()))
        cq[i] = np.where(frag >= 24, crng.integers(0, 20, Lq), frag)
    return cq


def rescore(path, q, t, params):
    """Score of a local alignment path, from its steps alone."""
    mat = params.matrix
    go, ge = params.gap_open, params.gap_extend
    total, prev_step = 0, None
    for (i0, j0), (i1, j1) in zip(path, path[1:]):
        step = (i1 - i0, j1 - j0)
        if step == (1, 1):
            total += int(mat[q[i1 - 1], t[j1 - 1]])
        else:
            total -= ge if step == prev_step else go
        prev_step = step
    return total


def decode_times(decode, wire, reps=2):
    """``decode`` (the port's decode_device_walk) of a device walk's wire
    alone, the best of ``reps``: (ms to arrays, as bench_suite decodes; ms
    to the (score, path) lists the entry points return). The result is
    freed after the span, as a caller keeps it."""
    best = [float("inf"), float("inf")]
    for _ in range(reps):
        for k, as_arrays in enumerate((True, False)):
            t0 = time.perf_counter()
            out = decode(wire, as_arrays=as_arrays)
            best[k] = min(best[k], (time.perf_counter() - t0) * 1e3)
            del out
    return best


def run_cli(cli_main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue().splitlines()


def max_abs_err(got, want):
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(tup(got), tup(want)))


MODEL_PATH = DNA_PATH + SEMIGLOBAL_PATH + BANDED_PATH + BLOCK_PATH


def models_phases(cli_main, launches, zero_launches, off_path, b9_folded, kb, ksb, kbb,
                  kbk, kdw, ksg, smi):
    """Phases 36-38, the models' window: the mapper, the MSA and the
    assembler with their CLI. Returns the window's launches by row."""
    from swtpu_torch.core.encode import mutate, revcomp
    from swtpu_torch.models import assembly as pas
    from swtpu_torch.models import mapper as pm
    from swtpu_torch.models import msa as pmsa
    from swtpu_torch.ops.variants import best_engine
    from swtpu_torch.core.scoring import DNA_111

    zero_launches(MODEL_PATH)
    b9_folded["launches"] = 0  # the models' B9 launches all count for row 11

    def wall(fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def hit_key(h):
        return None if h is None else (h.read, h.contig, h.pos, h.score, h.strand,
                                       h.n_seeds, h.path, h.window_start)

    def model_launches():
        return dict(row10=ksb.sw_banded_static.launches + ksb.sw_banded_profile.launches,
                    row11_12=kbk.block_forward.launches + kbk.block_rows.launches,
                    row14_15=kbb.banded_batch.launches,
                    block_walk=kdw.block_walk.launches, row8=ksg.semiglobal_batch.launches,
                    rows1_4=kb.sw_batch.launches)

    # 36. the read mapper ----------------------------------------------------
    phase("36 read mapper at bench_map's size: 1,000,000-base genome, k = 9, 4096 "
          "mutation-model 152-mers, min_score 20, paths; both strands; Gotoh winners")
    G, R, L, BW = 1_000_000, 4096, 152, 32
    genome = np.random.default_rng(SEED).integers(0, 4, size=G).astype(np.uint8)
    t0 = time.perf_counter()
    idx = pm.build_index([genome], k=9)
    t_index = time.perf_counter() - t0

    def read_set(seed, flip=False):
        r = np.random.default_rng(seed)
        starts = r.integers(0, G - L, size=R)
        reads = np.stack([mutate(r, genome[s: s + L], out_len=L) for s in starts])
        strand = np.zeros(R, bool)
        if flip:
            strand = r.random(R) < 0.5
            reads[strand] = np.stack([revcomp(x) for x in reads[strand]])
        return reads, starts, strand

    def correct(hits, starts, strand=None):
        return sum(1 for i, h in enumerate(hits) if h is not None
                   and abs(h.pos - int(starts[i])) <= BW
                   and (strand is None or (h.strand == "-") == bool(strand[i])))

    # the warm-up set and one fresh timed set (phase 42's map_seed_extend
    # record times the min of two more; PR 17 timed three here)
    sets = [read_set(s) for s in (1, 2)]
    kw = dict(index=idx, min_score=20, traceback=True)
    # the path's run: the warm-up set, then both strands and Gotoh winners
    hits0, warm_s = wall(pm.map_reads, sets[0][0], **kw)
    flipped = read_set(5, flip=True)
    hits_bs, bs_s = wall(pm.map_reads, flipped[0], both_strands=True, **kw)
    gotoh = dict(gap_open=3, gap_extend=1)
    hits_g, g_s = wall(pm.map_reads, sets[0][0][:512], **gotoh, **kw)
    counts36 = model_launches()
    walls = []
    with off_path():
        for reads, starts, _ in sets[1:]:
            hits, w = wall(pm.map_reads, reads, **kw)
            walls.append(w)
        ok = correct(hits, sets[-1][1])
        reads, starts, _ = sets[-1]
        lens = np.full(R, L, np.int64)
        t0 = time.perf_counter()
        seeded = pm._seed_rows(reads, lens, idx, False, 2, 64, 8, BW)
        seed_s = time.perf_counter() - t0
        cands = seeded[0][3]
        (scores, _), screen_s = wall(pm.extend_candidates, idx, reads, lens, cands)
        hits_p, pipe_s = wall(pm.map_reads_pipelined, reads, **kw)
        check([hit_key(h) for h in hits_p] == [hit_key(h) for h in hits],
              "map_reads_pipelined vs map_reads")
        # the same route on the CPU's plain tiers, first 256 reads
        t0 = time.perf_counter()
        for rows_, extra, label in ((reads, {}, "paths"),
                                    (flipped[0], dict(both_strands=True), "both strands"),
                                    (sets[0][0][:512], gotoh, "Gotoh")):
            got = {"paths": hits, "both strands": hits_bs, "Gotoh": hits_g}[label]
            want = pm.map_reads(rows_[:256], device="cpu", route="card", **extra, **kw)
            check([hit_key(h) for h in got[:256]] == [hit_key(h) for h in want],
                  f"map_reads ({label}): the card vs the card's route on the CPU")
        cpu_s = time.perf_counter() - t0
    best = min(walls)
    ok_bs = correct(hits_bs, flipped[1], flipped[2])
    print(f"index {t_index:.3f} s; map_reads with paths, 4096 x 152 vs 1 Mbp: wall "
          f"{best * 1e3:.1f} ms (a fresh set; warm-up {warm_s * 1e3:.1f}), "
          f"{R / best:.0f} reads/s, correct locus {ok / R:.4f}; candidates {len(cands.read)}; "
          f"host seeding {seed_s * 1e3:.1f} ms, the card's screen {screen_s * 1e3:.1f} ms "
          f"(fixed band on the 2-bit wire), the rest (winners' block forward, device walk, "
          f"decode, selection) {(best - seed_s - screen_s) * 1e3:.1f} ms; pipelined "
          f"{pipe_s * 1e3:.1f} ms, equal hits; both strands (half the reads reverse "
          f"complemented) {bs_s * 1e3:.1f} ms, correct locus and strand {ok_bs / R:.4f}; "
          f"Gotoh 3/1 winners on the per-round band, 512 reads {g_s * 1e3:.1f} ms; the "
          f"first 256 reads of each equal to the CPU's plain tiers ({cpu_s:.1f} s) [{smi}]",
          flush=True)
    print(f"mapper launches: {counts36}", flush=True)
    # the JAX package's bench_map records 0.8643 on these inputs
    check(ok >= 0.85 * R and ok_bs >= 0.85 * R, f"correct locus {ok}, {ok_bs} of {R}")
    check(counts36["row10"] > 0 and counts36["row11_12"] > 0 and counts36["block_walk"] > 0
          and counts36["row14_15"] > 0, f"a mapper kernel did not launch: {counts36}")

    # 37. MSA --------------------------------------------------------------
    phase("37 center-star MSA at bench_msa's sizes: 48 x 256 and 256 x 256, match 2, "
          "mismatch 3, gap 2")

    def family(seed, N, Lf=256):
        r = np.random.default_rng(seed)
        anc = r.integers(0, 4, size=Lf).astype(np.uint8)
        return [mutate(r, anc) for _ in range(N)]

    def projection_ok(res):
        ok_ = True
        for k in range(len(res.rows)):
            if k == res.center:
                continue
            ra, rb = res.rows[res.center], res.rows[k]
            keep = ~((ra == pmsa.GAP) & (rb == pmsa.GAP))
            a, b = ra[keep], rb[keep]
            both = (a != pmsa.GAP) & (b != pmsa.GAP)
            proj = int(np.where(a[both] == b[both], 2, -3).sum()) - 2 * int(
                ((a != pmsa.GAP) ^ (b != pmsa.GAP)).sum())
            ok_ &= proj == res.scores[k]
        return ok_

    mkw = dict(match=2, mismatch=3, gap=2)
    before = model_launches()
    fams = [family(s, 48) for s in (1, 2, 3)]
    res0, warm_s = wall(pmsa.msa_center_star, fams[0], **mkw)
    big = family(7, 256)
    res_big, big_s = wall(pmsa.msa_center_star, big, **mkw)
    counts37 = {k: v - before[k] for k, v in model_launches().items()}
    msa_walls = []
    with off_path():
        for seqs in fams[1:]:
            res, w = wall(pmsa.msa_center_star, seqs, **mkw)
            msa_walls.append(w)
            check(projection_ok(res), "MSA 48 x 256 projection invariant")
        t0 = time.perf_counter()
        want = pmsa.msa_center_star(fams[0], device="cpu", **mkw)
        cpu_s = time.perf_counter() - t0
    check(res0.center == want.center and np.array_equal(res0.scores, want.scores)
          and all(np.array_equal(a, b) for a, b in zip(res0.rows, want.rows))
          and res0.sp == want.sp, "MSA 48 x 256: the card vs the CPU")
    check(projection_ok(res_big), "MSA 256 x 256 projection invariant")
    print(f"msa_center_star 48 x 256: wall {min(msa_walls) * 1e3:.1f} ms (min of 2 fresh "
          f"families: {', '.join(f'{w * 1e3:.1f}' for w in msa_walls)}; warm-up "
          f"{warm_s * 1e3:.1f}), equal to the CPU's ({cpu_s:.2f} s); 256 x 256: "
          f"{big_s * 1e3:.1f} ms, 32,640 pairs scored in the center pick, projection "
          f"invariant on every row; launches {counts37} [{smi}]", flush=True)
    check(counts37["row8"] == 6, f"MSA: row 8 launches {counts37}")

    # 38. assembly and the CLIs ---------------------------------------------
    phase("38 assembly (assemble --random 20000x150x50: 398 reads, 158,006 pairs in one "
          "best_engine call) and the map / msa / assemble CLI")
    before = model_launches()
    rng = np.random.default_rng(SEED)  # the CLI's draws for --random 20000x150x50
    genome_a = rng.integers(0, 4, size=20000).astype(np.uint8)
    reads_a = pas.make_reads(rng, genome_a, read_len=150, step=50)
    contig, asm_s = wall(pas.assemble_greedy, reads_a)
    check(np.array_equal(contig, genome_a), "assembly reconstructs the genome")
    with off_path():
        t0 = time.perf_counter()
        bq, bt, pairs = pas._screen_batch(reads_a)
        loop_s = time.perf_counter() - t0
        fn = best_engine(DNA_111)
        card_scores, eng_s = wall(fn, bq, bt)
        cpu_scores = best_engine(DNA_111, "cpu")(bq[:2048], bt[:2048])
        check(torch.equal(card_scores[:2048].cpu(), cpu_scores),
              "assembly screen: the card vs the CPU on the first 2048 pairs")
    counts38 = {k: v - before[k] for k, v in model_launches().items()}
    print(f"assemble_greedy on {len(reads_a)} reads of 150: wall {asm_s:.3f} s, of it the "
          f"host loop filling the {len(pairs)}-pair batch {loop_s:.3f} s and the "
          f"best_engine call {eng_s * 1e3:.1f} ms; the contig reconstructs the 20,000-base "
          f"genome; launches {counts38} [{smi}]", flush=True)
    check(counts38["rows1_4"] == 1, f"assembly: rows 1-4 launches {counts38}")

    def run_both(argv):
        out = []
        for extra in ([], ["--device", "cpu"]):
            o, e = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
                cli_main(argv + extra)
            out.append((o.getvalue(), e.getvalue(), time.perf_counter() - t0))
        return out

    for argv in (["msa", "--random", "48x256", "--scoring", "2,-3", "--gap", "2"],
                 ["assemble", "--random", "4000x150x50"]):
        (co, ce, cs), (po, pe, ps) = run_both(argv)
        check((co, ce) == (po, pe) and co, f"{' '.join(argv)}: the card vs --device cpu")
        print(f"{' '.join(argv)}: the same {len(co)} bytes of stdout and stderr on the "
              f"card ({cs:.2f} s) and the CPU ({ps:.2f} s)", flush=True)
    o = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(o):
        cli_main(["map", "--random", "200000x1024x150", "--traceback"])
    rec = json.loads(o.getvalue())
    check(rec["reads"] == 1024 and rec["correct_locus"] >= 0.85 * 1024,
          f"map --random: {rec}")
    print(f"map --random 200000x1024x150 --traceback: {json.dumps(rec)}, true-locus "
          f"fraction {rec['correct_locus'] / rec['reads']:.4f} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    models = {name: launches(name) for name in MODEL_PATH}
    print(f"models window launches (phases 36-38): {models}", flush=True)
    for need in (("sw_banded_static",), ("block_rows",), ("block_walk",),
                 ("banded_batch", "banded_batch_w32_w64"), ("semiglobal_batch_pinned",),
                 ("sw_batch",)):
        check(any(models[k] > 0 for k in need),
              f"a models kernel did not launch: {need} in {models}")
    check(models["block_gather"] == 0, f"B10 launched in the models window: {models}")
    return models


MESH_B = 1 << 20  # the SpeedTest's pairs for data_parallel_scores
MESH_NEEDS = [("sw_batch",), ("strip_tile",)]
HARNESS_NEEDS = [("sw_batch",), ("sw_batch_ends",), ("sw_affine",), ("sw_affine_ends",),
                 ("sw_profile", "sw_profile_warp"), ("sw_profile_affine", "sw_profile_affine_warp"),
                 ("sw_profile_ends", "sw_profile_ends_warp"),
                 ("sw_profile_affine_ends", "sw_profile_affine_ends_warp"),
                 ("semiglobal_batch",), ("semiglobal_batch_pinned",),
                 ("semiglobal_profile_affine",),
                 ("sw_banded_static", "sw_banded_static_affine"),
                 ("banded_batch", "banded_batch_w32_w64"),
                 ("block_rows", "block_rows_small"), ("block_walk",), ("xdrop_walk",),
                 ("strip_tile",)]


def speedtest_pairs():
    """1,048,576 random 128 x 128 DNA pairs drawn on the card (seed 10000 +
    39): the same codes in every process on this card."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 39)
    return tuple(torch.randint(0, 4, (MESH_B, 128), generator=g, device="cuda",
                               dtype=torch.uint8) for _ in range(2))


def mesh_inputs():
    """The mesh phases' inputs, drawn alike in the parent and in each rank
    of phase 40: ``speedtest_pairs``, phase 34's DNA queries and database
    (its draws replayed) and phase 30's related 16384 x 16384 pair."""
    from swtpu_torch.core.encode import mutate

    dq, dt = speedtest_pairs()
    s_ = np.random.default_rng(SEED)
    Q = s_.integers(0, 4, size=(16, 128)).astype(np.uint8)
    s_.integers(0, 4, size=(2048, 128))  # phase 34's chunk draw
    T = s_.integers(0, 4, size=(131072, 128)).astype(np.uint8)
    lr = np.random.default_rng(SEED)
    lq = lr.integers(0, 4, 16384).astype(np.uint8)
    lt = mutate(lr, lq, p_mismatch=0.1, p_insert=0.025, p_delete=0.025, out_len=16384)
    return dq, dt, Q, T, lq, lt


def mesh_calls(mesh, sp, dq, dt, Q, T, lq, lt):
    """The mesh phases' three calls through ``mesh`` / ``sp``, or with
    ``mesh=None`` their one-card entry points: name -> fn() -> host result."""
    from swtpu_torch.core.scoring import DNA_10_30_15, DNA_111, ScoringParams, dna_matrix
    from swtpu_torch.ops import best_engine
    from swtpu_torch.parallel import (
        all_vs_all_topk, data_parallel_scores, longpair_sw_ends, sharded_all_vs_all_topk,
    )

    gotoh = ScoringParams(dna_matrix(2, -3), 5, 1)

    def dp():
        if mesh is None:
            return best_engine(DNA_10_30_15)(dq, dt).cpu().numpy()
        return data_parallel_scores(dq, dt, DNA_10_30_15, mesh).full_tensor().cpu().numpy()

    def search():
        if mesh is None:
            return all_vs_all_topk(Q, T, DNA_111, k=10, chunk_size=8192)
        return sharded_all_vs_all_topk(Q, T, DNA_111, mesh, k=10)

    return {
        "data_parallel_scores": dp,
        "sharded_all_vs_all_topk": search,
        "longpair_sw_ends (1,-1,1)": lambda: longpair_sw_ends(lq, lt, DNA_111, sp),
        "longpair_sw_ends Gotoh (2,-3,5,1)": lambda: longpair_sw_ends(lq, lt, gotoh, sp),
    }


def digest(results):
    """A SHA-256 of the calls' host results, to hold ranks and phases equal."""
    h = hashlib.sha256()
    for name in sorted(results):
        for part in tup(results[name]):
            h.update(np.ascontiguousarray(np.asarray(part)).tobytes())
    return h.hexdigest()


def mesh_worker(rank, world, store, out_path):
    """One rank of phase 40: the three calls on the card over gloo, each
    counted on its first call and then timed (min of 3 walls, barriers
    around each); every rank's digest must be rank 0's. Rank 0 writes the
    results, the walls, both ranks' launches and the gloo probe."""
    import torch.distributed as dist

    from swtpu_torch.kernels import longpair_strip as kls
    from swtpu_torch.kernels import sw_batch as kb
    from swtpu_torch.parallel import init_distributed, make_mesh
    from swtpu_torch.parallel.mesh import host_staged

    init_distributed("file://" + store, world, rank, backend="gloo")
    dev = torch.device("cuda")
    mesh, sp = make_mesh(world), make_mesh(world, axis="sp")
    dq, dt, Q, T, lq, lt = mesh_inputs()
    strips = (kls.tile_strip_linear, kls.tile_strip_affine)
    results, walls, counts = {}, {}, {}
    for name, fn in mesh_calls(mesh, sp, dq, dt, Q, T, lq, lt).items():
        kb.sw_batch.launches = 0
        for w in strips:
            w.launches = 0
        results[name] = fn()
        counts[name] = dict(sw_batch=kb.sw_batch.launches,
                            strip_tile=sum(w.launches for w in strips))
        reps = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            reps.append(time.perf_counter() - t0)
        walls[name] = min(reps) * 1e3
    # what gloo does with CUDA tensors (the collectives that return)
    x = torch.full((4,), rank + 1, dtype=torch.int32, device=dev)
    probe = {}

    def gather():
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return [int(o[0]) for o in out] == list(range(1, world + 1))

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return int(y[0]) == 1

    def reduce():
        y = x.clone()
        dist.all_reduce(y)
        return int(y[0]) == world * (world + 1) // 2

    for cname, cfn in (("all_gather", gather), ("broadcast", broadcast),
                       ("all_reduce", reduce)):
        try:
            probe[cname] = "returns the right values" if cfn() else "returns wrong values"
        except Exception as e:  # noqa: BLE001  (the probe reports any failure)
            probe[cname] = f"raises {type(e).__name__}"
    mine = dict(digest=digest(results), counts=counts, walls=walls)
    every = [None] * world
    dist.all_gather_object(every, mine)
    if rank == 0:
        dp = results["data_parallel_scores"]
        s_, i_ = results["sharded_all_vs_all_topk"]
        ends = [list(results[k]) for k in results if k.startswith("longpair")]
        np.savez(out_path, dp=dp, hits_s=s_, hits_i=i_, ends=np.array(ends),
                 meta=np.array(json.dumps(dict(
                     ranks=every, probe=probe, staged=host_staged(dev),
                     backend=dist.get_backend(), mesh_type=mesh.device_type))))
    dist.destroy_process_group()
    return 0


def mesh_phases(cli_main, launches, zero_launches, off_path, smi):
    """Phases 39-40, the mesh's window. Returns its launches by row (both
    ranks' of phase 40 added)."""
    import os
    import torch.distributed as dist

    from swtpu_torch.parallel import make_mesh

    zero_launches(list(KERNELS))

    def wall(fn):
        """min of 3 walls, off the path."""
        reps = []
        with off_path():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                reps.append(time.perf_counter() - t0)
        return min(reps) * 1e3

    # 39. the mesh at world 1 -------------------------------------------------
    phase("39 the mesh at world 1 (NCCL): data_parallel_scores on 1,048,576 x (128x128) "
          "DNA (10,-30,15), sharded_all_vs_all_topk on 16 x 131,072 x 128, the sharded "
          "long-pair sweep on the 16K pairs")
    print(smi, flush=True)
    dq, dt, Q, T, lq, lt = mesh_inputs()
    t0 = time.perf_counter()
    mesh, sp = make_mesh(), make_mesh(axis="sp")
    check(dist.get_backend() == "nccl" and mesh.device_type == "cuda"
          and mesh.size() == sp.size() == 1, "the world-1 mesh is NCCL on the card")
    calls = mesh_calls(mesh, sp, dq, dt, Q, T, lq, lt)
    results = {name: fn() for name, fn in calls.items()}
    first_s = time.perf_counter() - t0
    one = mesh_calls(None, None, dq, dt, Q, T, lq, lt)
    with off_path():
        ref = {name: fn() for name, fn in one.items()}
    for name in calls:
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(tup(results[name]), tup(ref[name])))
        check(same, f"{name} at world 1 differs from its one-card entry point")
        print(f"{name} through the world-1 mesh equals its one-card entry point; wall "
              f"{wall(calls[name]):.3f} ms, one-card {wall(one[name]):.3f} ms (min of 3)",
              flush=True)
    print(f"the world of one (NCCL on an in-memory store), its two meshes and the "
          f"calls' first runs: {first_s:.2f} s; ends "
          f"{[results[k] for k in results if k.startswith('long')]}", flush=True)
    del dq, dt
    torch.cuda.empty_cache()
    want = digest(results)
    world1 = {name: launches(name) for name in KERNELS}

    # 40. two ranks on the one card ---------------------------------------------
    phase("40 a 2-rank gloo world on the one card: the same three calls (strips of "
          "8192 rows, half the batch and of the database a rank), then torchrun "
          "--nproc-per-node 2 -m swtpu_torch longpair")
    print(smi, flush=True)
    tmp = tempfile.TemporaryDirectory()
    store, out = str(Path(tmp.name) / "store"), str(Path(tmp.name) / "rank0.npz")
    t0 = time.perf_counter()
    # the longpair CLI in a torchrun world of 2 starts beside the two ranks:
    # both wait mostly on process start-up (the ranks' walls below run
    # beside it); its stdout is held against the one-card CLI's at the end
    argv = ["longpair", "--random", "2x8192x6000", "--block", "1024", "--cigar"]
    tr = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "2", "-m", "swtpu_torch", *argv, "--backend",
                           "gloo"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          cwd=str(Path(__file__).resolve().parent))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(r), "2", store,
         out], env=dict(os.environ, LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    logs = []
    try:
        for r, p_ in enumerate(procs):
            so, se = p_.communicate(timeout=400)
            logs.append((r, p_.returncode, so, se))
        spawn_s = time.perf_counter() - t0
        with off_path():
            one_card = run_cli(cli_main, argv)
        tr_out, tr_err = tr.communicate(timeout=400)
        tr_s = time.perf_counter() - t0
    finally:
        for p_ in procs + [tr]:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
    for r, rc, so, se in logs:
        check(rc == 0, f"rank {r} of the 2-rank world exited {rc}:\n{so[-3000:]}\n{se[-3000:]}")
    z = np.load(out)
    meta = json.loads(str(z["meta"]))
    got = {"data_parallel_scores": z["dp"], "sharded_all_vs_all_topk": (z["hits_s"], z["hits_i"])}
    for k, e in zip([k for k in results if k.startswith("long")], z["ends"]):
        got[k] = tuple(int(x) for x in e)
    check(digest(got) == want and all(r_["digest"] == want for r_ in meta["ranks"]),
          "the 2-rank world's results differ from phase 39's")
    tmp.cleanup()
    print(f"2 ranks (gloo, both on {torch.cuda.get_device_name(0)}): every call equals "
          f"phase 39's on both ranks; the spawn, 3 calls x 4 and the gloo probe took "
          f"{spawn_s:.1f} s (the torchrun world below starting beside them)", flush=True)
    print(f"gloo with CUDA tensors on this card: {meta['probe']}; the port stages its own "
          f"exchanges through the host under gloo (host_staged: {meta['staged']}): the "
          f"sweep's rows (isend / irecv), the gathered endpoint rows and top-k candidates "
          f"(all_gather), and the DTensor lives on a {meta['mesh_type']} mesh", flush=True)
    for name in calls:
        w_ = [r_["walls"][name] for r_ in meta["ranks"]]
        print(f"  {name}: 2 ranks on one shared card (not scaling) {w_[0]:.3f} / "
              f"{w_[1]:.3f} ms (rank 0 / 1, min of 3); launches a rank "
              f"{[r_['counts'][name] for r_ in meta['ranks']]} [{smi}]", flush=True)
    mesh_counts = dict(world1)
    for r_ in meta["ranks"]:
        for c in r_["counts"].values():
            mesh_counts["sw_batch"] += c["sw_batch"]
            mesh_counts["strip_tile"] += c["strip_tile"]
    # the longpair CLI in the torchrun world of 2 against the one-card CLI
    check(tr.returncode == 0, f"torchrun longpair exited {tr.returncode}:\n{tr_err[-3000:]}")
    check(tr_out.splitlines() == one_card and len(one_card) == 2,
          f"torchrun longpair's stdout differs from the one-card CLI's:\n{tr_out[:2000]}")
    check(tr_err.count("target trimmed 6000 -> 5120") == 2,
          f"torchrun longpair's trim warnings (rank 0's, once a pair):\n{tr_err[-2000:]}")
    print(f"torchrun --nproc-per-node 2 -m swtpu_torch {' '.join(argv)} --backend gloo: "
          f"stdout equal to the one-card CLI's ({len(tr_out)} bytes; {tr_s:.1f} s from "
          f"the start of this phase)", flush=True)
    print(f"mesh window launches (phases 39-40, both ranks): "
          f"{ {k: v for k, v in mesh_counts.items() if v} }", flush=True)
    for need in MESH_NEEDS:
        check(any(mesh_counts[k] > 0 for k in need),
              f"a mesh kernel did not launch: {need} in {mesh_counts}")
    return mesh_counts


def harness_phases(cli_main, launches, zero_launches, b9_folded, smi):
    """Phase 41, the harnesses' window. Returns its launches by row, the
    trace's busy share and the fuzz stats."""
    from swtpu_torch.core.scoring import DNA_10_30_15
    from swtpu_torch.ops import best_engine
    from swtpu_torch.utils.obs import profile_trace, trace_busy

    zero_launches(list(KERNELS))
    b9_folded["launches"] = 0  # the harnesses' B9 launches all count for row 11
    phase("41 the harnesses: fuzz --rounds 22 --pairs 512, selftest, profile_trace "
          "around one 1M SpeedTest best_engine call")
    print(smi, flush=True)
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    lines = run_cli(cli_main, ["fuzz", "--rounds", "22", "--pairs", "512", "--save-dir",
                               tmp.name])
    fuzz_s = time.perf_counter() - t0
    stats = json.loads(next(x for x in lines if x.startswith("{")))
    check(stats["rounds"] == 22 and stats["mismatches"] == 0 and not any(
        Path(tmp.name).iterdir()), f"fuzz on the card: {lines}")
    tmp.cleanup()
    fuzz_counts = {k: v for k, v in ((n, launches(n)) for n in KERNELS) if v}
    print(f"fuzz --rounds 22 --pairs 512 (every family twice): {stats} in {fuzz_s:.1f} s; "
          f"launches {fuzz_counts}", flush=True)
    t0 = time.perf_counter()
    try:
        lines = run_cli(cli_main, ["selftest"])
        rc = 0
    except SystemExit as e:
        rc, lines = e.code, []
    self_s = time.perf_counter() - t0
    recs = [json.loads(x) for x in lines]
    check(rc == 0 and len(recs) == 23 and all(r_["ok"] for r_ in recs),
          f"selftest on the card: rc {rc}, {recs}")
    print(f"selftest: all {len(recs)} checks ok on the card ({self_s:.1f} s): "
          + ", ".join(r_["selftest"] for r_ in recs), flush=True)
    qd, td = speedtest_pairs()
    fn = best_engine(DNA_10_30_15)
    fn(qd, td)  # warm: the trace sees one steady call
    torch.cuda.synchronize()
    tmp = tempfile.TemporaryDirectory()
    with profile_trace(tmp.name) as prof:
        t0 = time.perf_counter()
        fn(qd, td)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    busy, window = trace_busy(prof.trace_path)
    n_kernels = sum(1 for e in json.load(open(prof.trace_path))["traceEvents"]
                    if e.get("cat") == "kernel")
    size_kb = Path(prof.trace_path).stat().st_size / 1024
    tmp.cleanup()
    check(busy > 0 and n_kernels >= 1, "the trace holds the call's kernels")
    print(f"profile_trace around one best_engine call at 1,048,576 x (128x128) (10,-30,15): "
          f"{n_kernels} kernel events, kernels busy {busy / 1e3:.3f} ms of the trace's "
          f"{window / 1e3:.3f} ms window: busy share {busy / window:.1%}, idle "
          f"{1 - busy / window:.1%}; the call's wall {call_ms:.3f} ms (busy / wall "
          f"{busy / 1e3 / call_ms:.1%}); trace {size_kb:.0f} KB [{smi}]", flush=True)
    del qd, td
    torch.cuda.empty_cache()
    harness = {name: launches(name) for name in KERNELS}
    print(f"harness window launches (phase 41): { {k: v for k, v in harness.items() if v} }",
          flush=True)
    for need in HARNESS_NEEDS:
        check(any(harness[k] > 0 for k in need),
              f"a kernel did not launch in the harnesses' window: {need} in {harness}")
    return harness


#: what the suite drives on the card (phase 42): a row of each group
SUITE_NEEDS = [("sw_batch",), ("sw_batch_ends",), ("sw_affine",),
               ("sw_profile", "sw_profile_warp"), ("sw_profile_affine", "sw_profile_affine_warp"),
               ("sw_bf16",), ("sw_wavefront",), ("semiglobal_batch",),
               ("semiglobal_batch_pinned",), ("semiglobal_profile_affine",),
               ("sw_banded_static",), ("sw_banded_static_affine",), ("banded_batch_w32_w64",),
               ("block_rows", "block_rows_small"), ("block_walk",), ("xdrop_walk",),
               ("strip_tile",)]
#: the dist section in phase 42: the anchor at --quick sizes, the gloo
#: curve in worlds of 1 and 2 CPU ranks (its full size, 4 worlds, takes
#: over 7 minutes of host time; PERF.md section 4)
SUITE_DIST = ["--suite", "dist", "--quick", "--cpu-mesh", "2"]
#: the suite's children (python -m swtpu_torch bench ...): a section's limit
SUITE_TIMEOUT = 300


def jax_folds(B, W, affine):
    """Whether JAX ran B9 at this shape on its folded kernel (``_fold_G``
    > 1 in swtpu/kernels/pallas/banded_block.py): a linear batch under 8
    x 128 pairs whose fold leaves segments of at least 2 slots."""
    S = -(-B // 128)
    if affine or S >= 8 or 8 % S:
        return False
    return W % (8 // S) == 0 and W // (8 // S) >= 2


def run_bench(argv, out_dir):
    """``python -m swtpu_torch bench ARGV`` in a child on the card: (its
    records, its section walls from stderr, its launch counts by record,
    its wall). Raises on a non-zero exit, with the child's output."""
    counts = Path(out_dir) / f"launches-{len(list(Path(out_dir).iterdir()))}.json"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "swtpu_torch", "bench", *argv,
                           "--launches", str(counts)],
                          capture_output=True, text=True, timeout=SUITE_TIMEOUT,
                          cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench {' '.join(argv)} exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
    recs = [json.loads(x[len("JSON: "):]) for x in proc.stdout.splitlines()
            if x.startswith("JSON: ")]
    sections = re.findall(r"^# section (\w+): ([\d.]+) s wall$", proc.stderr, re.M)
    return recs, sections, json.loads(counts.read_text())["by_record"], wall


def suite_phase(launches, zero_launches, off_path, b9_folded, smi):
    """Phase 42, the benchmark suite (``swtpu_torch/bench_suite.py``) in
    children on the card. Returns the suite's launches by row."""
    import importlib

    from swtpu_torch import bench_suite

    phase("42 the benchmark suite: python -m swtpu_torch bench (every section, full "
          "size) and bench --suite dist --quick --cpu-mesh 2 (the NCCL anchor, the gloo "
          "curve)")
    print(smi, flush=True)
    tmp = tempfile.TemporaryDirectory()
    by_record, all_recs = {}, []
    for argv, want in ((["--suite", "all"], bench_suite.expected_kernels("all")),
                       (SUITE_DIST, bench_suite.expected_kernels("dist", cpu_mesh=2))):
        recs, sections, counts, wall = run_bench(argv, tmp.name)
        names = [r["kernel"] for r in recs]
        check(names == want, f"bench {' '.join(argv)}: records {names}, JAX's names {want}")
        bad = [r["kernel"] for r in recs
               if any(r.get(f) is not True for f in bench_suite.PARITY_FIELDS if f in r)]
        check(not bad, f"bench {' '.join(argv)}: a parity field is not true in {bad}")
        kind = torch.cuda.get_device_name(0)
        check(all(r.get("device", kind) in (kind, "cpu") for r in recs)
              and any(r.get("device") == kind for r in recs),
              f"bench {' '.join(argv)}: the records' device")
        for sec, s_ in sections:
            print(f"bench section {sec}: {s_} s wall", flush=True)
        n_par = sum(1 for r in recs for f in bench_suite.PARITY_FIELDS if f in r)
        print(f"bench {' '.join(argv)}: exit 0 in {wall:.1f} s, {len(recs)} records, "
              f"{len(set(names))} distinct kernel names = JAX's, {n_par} parity fields "
              f"all true [{smi}]", flush=True)
        for name, c in counts.items():
            mine = by_record.setdefault(name, {})
            for k, v in c.items():
                mine[k] = mine.get(k, 0) + v
        all_recs += recs
    tmp.cleanup()
    for r in all_recs:
        print("bench record: " + json.dumps(r), flush=True)
    # the suite's launches by row: its counts set on the wrappers for a
    # moment; B9's count for row 12 where JAX ran its folded kernel
    batch = {r["kernel"]: r.get("batch") for r in all_recs}
    totals, folded = {}, 0
    for name, c in by_record.items():
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
        b9 = sum(v for k, v in c.items() if k in ("banded_block.block_forward.launches",
                                                 "banded_block.block_rows.launches"))
        if b9 and batch.get(name) and jax_folds(batch[name], 64, "affine" in name):
            folded += b9
    with off_path():
        zero_launches(list(KERNELS))
        for key, v in totals.items():
            mod, fn, attr = key.split(".")
            setattr(getattr(importlib.import_module(f"swtpu_torch.kernels.{mod}"), fn),
                    attr, v)
        saved, b9_folded["launches"] = b9_folded["launches"], folded
        bench = {name: launches(name) for name in KERNELS}
        b9_folded["launches"] = saved
    print(f"suite launches (phase 42, every call of its timing loops): "
          f"{ {k: v for k, v in bench.items() if v} }", flush=True)
    for need in SUITE_NEEDS:
        check(any(bench[k] > 0 for k in need),
              f"a kernel did not launch in the suite: {need} in {bench}")
    return bench


def xla_tier_fields(res, dev):
    """A per-round result's tensors on the card, the per-round ones zeroed
    at and past each pair's n_rounds (the kernels write only below it)."""
    out = [torch.as_tensor(x, device=dev) for x in (res.score, res.max_round,
                                                    res.n_rounds)]
    if res.pos_y is not None:
        live = torch.arange(res.pos_y.shape[0], device=dev)[:, None] < out[2][None, :]
        out.append(torch.where(live[..., None], torch.as_tensor(
            res.band_history, device=dev).int(), 0))
        out += [torch.where(live, torch.as_tensor(x, device=dev), 0)
                for x in (res.pos_y, res.offsets) if x is not None]
    return tuple(out)


def wide_band_phase(ctx):
    """Phase 43, the per-round band past W = 128 (csrc/sw_xdrop.cu's
    one-warp form to 256 and its CTA past it, where JAX's TPU dispatch
    runs its XLA forward): the kernels against the plain version, their
    times and bound, and the entry points through them. Returns (the main
    path's launches, the row)."""
    from swtpu_torch.batch import (banded_align_batch, banded_forward_batch,
                                   banded_walk_batch)
    from swtpu_torch.core.encode import mutate
    from swtpu_torch.core.protein import BLOSUM62
    from swtpu_torch.core.scoring import DNA_111
    from swtpu_torch.kernels import banded_batch as kbb
    from swtpu_torch.models import mapper as pm

    dev, smi, timed, off_path = ctx["dev"], ctx["smi"], ctx["timed"], ctx["off_path"]
    name = "banded_batch_wide"
    phase("43 the per-round band past W = 128 (a warp a pair to 256, a CTA of warps "
          "past it): kernel vs plain at W = 129-1024, times at 256 related 2048-mers, banded --bandwidth "
          "256 --traceback at 16K, banded / map --bandwidth 160")
    print(smi, flush=True)
    rng = np.random.default_rng(SEED + 43)
    err = 0
    # the kernel vs its plain version on small related sets (the plain
    # version is a Python loop of rounds): linear with per-pair lengths,
    # Gotoh with the 8-bit history, BLOSUM62 11/1 at X = 120 with lengths
    B, L = 24, 300
    dq, dt = related_pairs(rng, B, L)
    pq, pt = related_pairs(rng, B, L, letters=20)
    lens = dict(lens_q=rng.integers(L // 2, L + 1, B), lens_t=rng.integers(L // 2, L + 1, B))
    cases = (("linear, lengths", dq, dt, dict(lens)),
             ("Gotoh 3/1, 8-bit history", dq, dt,
              dict(gap_open=3, gap_extend=1, compress_history=True)),
             ("BLOSUM62 11/1, X = 120, lengths", pq, pt,
              dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120, **lens)))
    with off_path():
        for W in (129, 160, 256, 512, 1024):
            for label, q, t, kw in cases:
                qd, td = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
                got = kbb.banded_batch(qd, td, bandwidth=W, **kw)
                want = kbb.banded_batch_plain(qd, td, bandwidth=W, device=dev, **kw)
                e = max_abs_err(xla_tier_fields(got, dev), xla_tier_fields(want, dev))
                err = max(err, e)
                check(e == 0, f"{name} differs from its plain version at W={W} ({label})")
        # below 129 the wide launch writes what the warp kernel writes
        for W in (32, 96, 128):
            staged = kbb.stage(torch.from_numpy(dq).to(dev), torch.from_numpy(dt).to(dev),
                               None, None, dev)
            got = kbb.xdrop_wide_launch_t(*staged, W, 70, 1, 1, 1)
            want = kbb.xdrop_launch_t(*staged, W, 70, 1, 1, 1)
            check(all(torch.equal(a, b) for a, b in zip(
                xla_tier_fields(kbb.BandedBatchResult(*got), dev),
                xla_tier_fields(kbb.BandedBatchResult(*want), dev))),
                f"the wide launch vs the warp kernel at W={W}")
    print(f"{name}: every field below n_rounds equals the plain version at W = 129, 160, "
          f"256, 512 and 1024 on {B} related {L}-mers ({', '.join(c[0] for c in cases)}); "
          f"the wide launch equals the warp kernel at W = 32, 96 and 128", flush=True)

    # the main path: counts from here
    ctx["zero_launches"]([name, "xdrop_walk"])
    # banded --random 8x16384x16384 --bandwidth 256 --traceback: the walk on
    # the card (linear, n + m + 1 > 6000); the CLI's random pairs die early
    argv = ["banded", "--random", "8x16384x16384", "--bandwidth", "256", "--traceback"]
    t0 = time.perf_counter()
    lines = run_cli(ctx["cli_main"], argv)
    cli_s = time.perf_counter() - t0
    rs = np.random.default_rng(SEED)  # the CLI's --random inputs
    cq = rs.integers(0, 4, size=(8, 16384)).astype(np.uint8)
    ct = rs.integers(0, 4, size=(8, 16384)).astype(np.uint8)
    with off_path():
        host = banded_walk_batch(cq, ct, banded_forward_batch(cq, ct, bandwidth=256),
                                 bandwidth=256)
    got = [(r["score"], [tuple(x) for x in r["path"]]) for r in map(json.loads, lines)]
    check(got == host, "banded --bandwidth 256 --traceback: the device walk vs the host walk")
    # the same at 16K on related pairs, whose bands run the whole matrix
    q16, t16 = related_pairs(rng, 8, 16384)
    t0 = time.perf_counter()
    out = banded_align_batch(q16, t16, bandwidth=256)
    wall16 = time.perf_counter() - t0
    with off_path():
        t0 = time.perf_counter()
        host16 = banded_walk_batch(q16, t16, banded_forward_batch(q16, t16, bandwidth=256),
                                   bandwidth=256)
        host_s = time.perf_counter() - t0
    check(out == host16, "16K W = 256: the device walk vs the host walk")
    for b, (score, path) in enumerate(out):
        check(path[0] == (0, 0) and rescore(path, q16[b], t16[b], DNA_111) == score,
              f"16K W = 256 traceback: path of pair {b}")
    print(f"{' '.join(argv)}: {len(lines)} records ({cli_s:.1f} s wall), paths equal the "
          f"host walk's; banded_align_batch on 8 related 16384-mers at W = 256: "
          f"{wall16 * 1e3:.1f} ms wall (forward, device walk, decode) against "
          f"{host_s * 1e3:.1f} ms with the C++ host walk, equal paths, rescored, mean path "
          f"{np.mean([len(p) for _, p in out]):.0f} cells [{smi}]", flush=True)
    # banded --bandwidth 160 --traceback --cigar and map --bandwidth 160
    argv = ["banded", "--random", "32x300x300", "--bandwidth", "160", "--traceback",
            "--cigar"]
    card = run_cli(ctx["cli_main"], argv)
    with off_path():
        cpu = run_cli(ctx["cli_main"], argv + ["--device", "cpu"])
    check(card == cpu and len(card) == 32, f"{' '.join(argv)}: the card vs --device cpu")
    # past 256 the CTA: banded --bandwidth 384 --traceback --cigar
    argv384 = ["banded", "--random", "8x300x300", "--bandwidth", "384", "--traceback",
               "--cigar"]
    card384 = run_cli(ctx["cli_main"], argv384)
    with off_path():
        cpu384 = run_cli(ctx["cli_main"], argv384 + ["--device", "cpu"])
    check(card384 == cpu384 and len(card384) == 8,
          f"{' '.join(argv384)}: the card vs --device cpu")
    G, R, Lr = 200_000, 256, 150
    mrng = np.random.default_rng(SEED + 44)
    genome = mrng.integers(0, 4, size=G).astype(np.uint8)
    starts = mrng.integers(0, G - Lr, size=R)
    reads = np.stack([mutate(mrng, genome[s: s + Lr], out_len=Lr) for s in starts])
    idx = pm.build_index([genome], k=9)
    kw = dict(index=idx, bandwidth=160, traceback=True, min_score=20)
    t0 = time.perf_counter()
    hits = pm.map_reads(reads, **kw)
    map_s = time.perf_counter() - t0
    margv = ["map", "--random", f"{G}x{R}x{Lr}", "--bandwidth", "160", "--traceback"]
    mcard = run_cli(ctx["cli_main"], margv)
    with off_path():
        t0 = time.perf_counter()
        want = pm.map_reads(reads, device="cpu", route="card", **kw)
        cpu_s = time.perf_counter() - t0
        route = pm._route
        pm._route = lambda device: "card"  # the CLI on the CPU, the card's route
        try:
            mcpu = run_cli(ctx["cli_main"], margv + ["--device", "cpu"])
        finally:
            pm._route = route
    def key(h):
        return None if h is None else (h.read, h.contig, h.pos, h.score, h.strand,
                                       h.n_seeds, h.path, h.window_start)

    check([key(h) for h in hits] == [key(h) for h in want],
          "map_reads at W = 160: the card vs the card's route on the CPU")
    check(mcard == mcpu, f"{' '.join(margv)}: the card vs --device cpu on the card's route")
    counts = {k: ctx["launches"](k) for k in (name, "xdrop_walk")}
    warp_launches = kbb.banded_batch.launches_wide_warp
    cta_launches = counts[name] - warp_launches
    print(f"{' '.join(argv)} and {' '.join(argv384)}: {len(card)} and {len(card384)} "
          f"records equal --device cpu; map_reads with "
          f"paths at W = 160 ({R} reads of {Lr} against {G:,} bases, the fixed band's "
          f"screen and the winners on the wide kernel): {map_s * 1e3:.1f} ms wall, "
          f"{sum(h is not None for h in hits)} mapped, hits equal the card's route on the "
          f"CPU ({cpu_s:.1f} s); {' '.join(margv)}: {mcard[0]} on the card and on the CPU "
          f"(the card's route; --device cpu alone takes JAX's off-TPU route, which screens "
          f"with the per-round band); main-path launches {counts}: the one-warp form "
          f"{warp_launches} (W = 160, 256), the CTA {cta_launches} (W = 384)", flush=True)
    check(warp_launches > 0 and cta_launches > 0 and counts["xdrop_walk"] > 0,
          f"a kernel was not launched on the wide band's path: {counts}, one warp "
          f"{warp_launches}, CTA {cta_launches}")

    # times at bench_suite's per-round shape, 256 related 2048-mers, scores
    # only, W = 256 (the one-warp form) and 512 (the CTA), each the form
    # the main path launches there (the CTA at W = 256, the design the
    # one-warp form beat, is checked here and timed by
    # tools/xla_tier_times.py); the bound as phase 16 counts it (xdrop_ops)
    arng = np.random.default_rng(SEED + 9)
    Ba, La = 256, 2048
    aq = arng.integers(0, 4, size=(Ba, La)).astype(np.uint8)
    at = np.stack([mutate(arng, aq[b], out_len=La) for b in range(Ba)])
    aq_d, at_d = torch.from_numpy(aq).to(dev), torch.from_numpy(at).to(dev)
    ops_cell, ops_round = xdrop_ops(False, False)
    timings = {}
    with off_path():
        staged = kbb.stage(aq_d, at_d, None, None, dev)
        for W in (256, 512):
            res = kbb.banded_batch(aq_d, at_d, bandwidth=W, with_history=False)
            t0 = time.perf_counter()
            plain = kbb.banded_batch_plain(aq_d, at_d, bandwidth=W, with_history=False,
                                           device=dev)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            launch = {"wide_warp": kbb.xdrop_wide_warp_launch_t,
                      "wide": kbb.xdrop_wide_launch_t}[kbb.banded_form(W)]
            cta = kbb.xdrop_wide_launch_t(*staged, W, 70, 1, 1, 1, with_history=False)
            e = max(max_abs_err(xla_tier_fields(res, dev), xla_tier_fields(plain, dev)),
                    max_abs_err(xla_tier_fields(kbb.BandedBatchResult(*cta), dev),
                                xla_tier_fields(plain, dev)))
            err = max(err, e)
            check(e == 0, f"{name} differs from its plain version on 256 x 2048 at W={W}")
            ms = timed(lambda W=W: kbb.banded_batch(aq_d, at_d, bandwidth=W,
                                                    with_history=False), (), iters=5) * 1e3
            kernel_ms = timed(lambda W=W, launch=launch: launch(
                *staged, W, 70, 1, 1, 1, with_history=False), (), iters=5) * 1e3
            rounds = int(res.n_rounds.sum())
            cells = rounds * W
            times = {"int32 ops": (cells * ops_cell + rounds * ops_round)
                     / ctx["int32_rate"] * 1e3,
                     "bytes": (2 * Ba * La + 12 * Ba) / HBM_BYTES_PER_S * 1e3}
            binds = max(times, key=times.get)
            longest = int(res.n_rounds.max())
            ns_round = kernel_ms * 1e6 / longest
            timings[W] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                              bound_ms=times[binds], binds=binds, ns_round=ns_round)
            form = "the one-warp form" if kbb.banded_form(W) == "wide_warp" else "the CTA"
            print(f"{name} W={W}, {Ba} related 2048-mers, scores only: wrapper {ms:.4f} ms "
                  f"({times[binds] / ms:.1%} of the bound), {form} alone {kernel_ms:.4f} ms "
                  f"({ns_round:.1f} ns a round of the longest pair), plain {plain_ms:.1f} "
                  f"ms (both forms equal), bound {times[binds]:.4f} ms by "
                  f"{binds} ({ops_cell} ALU slots per band cell over {cells} band cells, "
                  f"{ops_round} per pair and round over {rounds} rounds: xdrop_ops), "
                  f"wrapper "
                  f"{cells / ms / 1e6:.2f} band GCUPS [{smi}]", flush=True)
            del res, plain, cta
    t = timings[256]

    def form_row(x, launches):
        return {k: v for k, v in x.items() if k != "binds"} | {
            "launches": launches,
            "bound_by": "bytes" if x["binds"] == "bytes" else "operations"}

    # lost ms charges each form's main-path launches at its own table shape
    row = dict(name=name, route="cuda", source=f"swtpu_torch/csrc/{XDROP}",
               replaces=KERNELS[name][2], launches=counts[name], max_abs_err=err,
               ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
               bound_by="bytes" if t["binds"] == "bytes" else "operations",
               library_ms=None, kernel_ms=t["kernel_ms"],
               ns_a_round=t["ns_round"], launches_warp=warp_launches,
               launches_cta=cta_launches,
               by_form={"one warp, W = 256": form_row(timings[256], warp_launches),
                        "CTA, W = 512": form_row(timings[512], cta_launches)})
    del aq_d, at_d, staged
    torch.cuda.empty_cache()
    return counts, row


def general_pipe(affine, ends):
    """The profile thread form's row of ALU_OPS / KERNELS whose cell the
    general kernel's tile form runs (the same instantiation of
    csrc/sw_local_tile.cuh): the function's least work a cell by pipe,
    the bound of every form of the general kernel."""
    return "sw_profile" + ("_affine" if affine else "") + ("_ends" if ends else "")


def charged_forms(row):
    """What a row's lost ms charges: its launches at its timed shape, or,
    for a row timed in several forms or instantiations (``by_form``:
    sw_general, banded_batch_wide), each one's main-path launches at its
    own time and bound."""
    forms = [f for f in row.get("by_form", {}).values() if f["launches"]]
    return forms or [row]


def general_engine_phase(ctx):
    """Phase 44, the local engines under the scorings the row-scan and
    profile kernels' guards refuse (the general kernel of
    csrc/sw_general.cu, where JAX's TPU dispatch runs its XLA tier): both
    forms against the plain version (the tile form where no gap penalty is
    negative, the sweep form for gap -1), their times beside the bound,
    and the entry points through them. Returns (the main path's launches,
    the row)."""
    from swtpu_torch.core.scoring import ScoringParams, dna_matrix
    from swtpu_torch.kernels import sw_general as kg
    from swtpu_torch.kernels.sw_profile import profile_table
    from swtpu_torch.ops.variants import best_ends_engine, best_engine, local_form

    dev, smi, timed, off_path = ctx["dev"], ctx["smi"], ctx["timed"], ctx["off_path"]
    name = "sw_general"
    phase("44 the general local engine: the tile form under gap 0, Gotoh 3/0, "
          "dna_matrix(200, -150) linear and Gotoh, the sweep form under gap -1, vs plain; "
          "32768 x 128 x 128 timed, the sweep form beside the tile at gap 0; align --traceback "
          "--cigar --gap 0")
    print(smi, flush=True)
    scorings = {
        "gap 0": ScoringParams.linear(dna_matrix(1, -1), 0),
        "gap -1": ScoringParams.linear(dna_matrix(2, -3), -1),
        "Gotoh 3/0": ScoringParams(dna_matrix(2, -3), 3, 0),
        "dna_matrix(200, -150) linear 5": ScoringParams.linear(dna_matrix(200, -150), 5),
        "dna_matrix(200, -150) Gotoh 30/5": ScoringParams(dna_matrix(200, -150), 30, 5),
    }
    rng = np.random.default_rng(SEED + 45)
    err = 0
    with off_path():
        for (B, n, m) in ((4096, 128, 128), (1000, 90, 200), (33, 7, 1), (64, 300, 40)):
            q, t = local_pairs(rng, B, n, m, 4)
            qd, td = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
            for label, p in scorings.items():
                for kern, plain in ((kg.sw_general, kg.sw_general_plain),
                                    (kg.sw_general_ends, kg.sw_general_ends_plain)):
                    tiles = kern.launches_tile
                    e = max_abs_err(kern(qd, td, p), plain(qd, td, p, dev))
                    err = max(err, e)
                    form = kg.general_form(p)
                    check(kern.launches_tile - tiles == (form == "tile"),
                          f"{kern.__name__} ({label}) did not launch the {form} form")
                    check(e == 0, f"{kern.__name__} ({form} form) differs from its plain "
                                  f"version on {B} x {n} x {m} ({label})")
    print(f"{name}: scores and endpoints equal the plain tier on 4096 x 128 x 128, 1000 x "
          f"90 x 200, 33 x 7 x 1 and 64 x 300 x 40 (half related, 3% pads inside): the "
          f"tile form under {', '.join(k for k, p in scorings.items() if kg.general_form(p) == 'tile')}; "
          f"the sweep form under {', '.join(k for k, p in scorings.items() if kg.general_form(p) == 'sweep')}",
          flush=True)

    # the main path: best_engine / best_ends_engine on gap 0 at 32768 x
    # 128 x 128, and align --traceback --cigar --gap 0 (its ends on the
    # general kernel, the C++ walk)
    ctx["zero_launches"]([name])
    B, n, m = 32768, 128, 128
    q, t = local_pairs(rng, B, n, m, 4)
    qd, td = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
    p0 = scorings["gap 0"]
    check(local_form(p0) == "general" and local_form(scorings["Gotoh 3/0"]) == "general",
          "local_form sends gap 0 and Gotoh 3/0 to the general kernel")
    check(kg.general_form(p0) == "tile" and kg.general_form(scorings["Gotoh 3/0"]) == "tile"
          and kg.general_form(scorings["gap -1"]) == "sweep",
          "general_form: the tile form for gap 0 and Gotoh 3/0, the sweep for gap -1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = best_engine(p0)(qd, td)
    ends = best_ends_engine(p0)(qd, td)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    with off_path():
        check(torch.equal(scores[:8192], kg.sw_general_plain(qd[:8192], td[:8192], p0,
                                                             dev)),
              "best_engine gap 0: the first 8192 scores vs the plain version")
        for g, w in zip(ends, kg.sw_general_ends_plain(qd[:8192], td[:8192], p0, dev)):
            check(torch.equal(g[:8192], w), "best_ends_engine gap 0 vs the plain version")
    argv = ["align", "--random", "64x128x128", "--gap", "0", "--traceback", "--cigar"]
    card = run_cli(ctx["cli_main"], argv)
    argv3 = ["align", "--random", "64x128x128", "--scoring", "2,-3", "--gap-open", "3",
             "--gap-extend", "0", "--traceback"]
    card3 = run_cli(ctx["cli_main"], argv3)
    with off_path():
        cpu = run_cli(ctx["cli_main"], argv + ["--device", "cpu"])
        cpu3 = run_cli(ctx["cli_main"], argv3 + ["--device", "cpu"])
    check(card == cpu and len(card) == 64, f"{' '.join(argv)}: the card vs --device cpu")
    check(card3 == cpu3 and len(card3) == 64, f"{' '.join(argv3)}: the card vs --device cpu")
    counts = {name: ctx["launches"](name)}
    # the main path's launches by instantiation: its linear scoring is gap
    # 0 and its Gotoh one 3/0, the two scorings timed below, both on the
    # tile form
    def form_name(label, ends_):
        return label + (" ends" if ends_ else "")

    path_forms = {}
    tile_launches = sweep_launches = 0
    for ends_, w in ((False, kg.sw_general), (True, kg.sw_general_ends)):
        path_forms[("gap 0", ends_)] = w.launches - w.launches_affine
        path_forms[("Gotoh 3/0", ends_)] = w.launches_affine
        tile_launches += w.launches_tile
        sweep_launches += w.launches - w.launches_tile
    print(f"best_engine + best_ends_engine, gap 0, {B} x {n} x {m}: {path_s * 1e3:.1f} ms "
          f"wall, the first 8192 equal the plain version; {' '.join(argv)} and "
          f"{' '.join(argv3)}: 64 records each equal --device cpu (the ends on the "
          f"general kernel, the C++ walk); main-path launches {counts}: tile form "
          f"{tile_launches}, sweep form {sweep_launches} (by scoring and form: "
          f"{', '.join(f'{form_name(*k)} {c}' for k, c in path_forms.items())})",
          flush=True)
    check(kg.sw_general.launches_tile > 0 and kg.sw_general_ends.launches_tile > 0,
          f"the tile form was not launched on the general engine's path: {counts}")
    check(sweep_launches == 0, "the main path's scorings went to the sweep form")

    # times at phase 16's shape, 32768 x 128 x 128, each instantiation under
    # its own scoring and table: the tile form (the main path's) and, at
    # gap 0 scores, the sweep form beside it (the earlier kernel of these
    # scorings; tools/xla_tier_times.py times it at all four and the
    # tile's select tracker); every form checked equal to the plain
    # version; the bound over the function's n x m cells a pair by pipe
    # and lookups, as the profile thread form's (the tile form's cell is
    # its cell)
    cells = B * n * m
    timings = {}
    with off_path():
        for label, p in (("gap 0", p0), ("Gotoh 3/0", scorings["Gotoh 3/0"])):
            table = profile_table(p, dev)
            for ends_ in (False, True):
                kern = kg.sw_general_ends if ends_ else kg.sw_general
                plain = kg.sw_general_ends_plain if ends_ else kg.sw_general_plain
                ms = timed(kern, (qd, td, p), iters=10) * 1e3
                kernel_ms = timed(kg.general_tile_launch_t, (qd, td, table, p, ends_),
                                  iters=10) * 1e3
                sweep_ms = (timed(kg.general_sweep_launch_t, (qd, td, table, p, ends_),
                                  iters=5) * 1e3 if p is p0 and not ends_ else None)
                t0 = time.perf_counter()
                want = plain(qd, td, p, dev)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                e = max(max_abs_err(kern(qd, td, p), want),
                        max_abs_err(kg.general_tile_launch_t(qd, td, table, p, ends_), want),
                        max_abs_err(kg.general_sweep_launch_t(qd, td, table, p, ends_), want))
                if ends_:
                    e = max(e, max_abs_err(kg.general_tile_launch_t(
                        qd, td, table, p, ends_, True), want))
                err = max(err, e)
                check(e == 0, f"{kern.__name__} at {B} x {n} x {m} ({label}): a form "
                              "differs from the plain version")
                pipe = general_pipe(not p.is_linear, ends_)
                times = {"int32 ops": cells * pipe_slots(pipe) / ctx["int32_rate"] * 1e3,
                         "shared-memory lookups": cells / ctx["lookup_rate"] * 1e3,
                         "bytes": (B * (n + m) + 4 * table.numel()
                                   + 4 * B * (3 if ends_ else 1)) / HBM_BYTES_PER_S * 1e3}
                binds = max(times, key=times.get)
                launches = path_forms[(label, ends_)]
                lost = launches * max(kernel_ms - times[binds], 0.0)
                timings[(label, ends_)] = dict(
                    ms=ms, kernel_ms=kernel_ms, sweep_ms=sweep_ms,
                    plain_ms=plain_ms, bound_ms=times[binds], binds=binds,
                    launches=launches, lost_ms=lost)
                print(f"{kern.__name__} {label}, {B} x {n} x {m}: wrapper {ms:.4f} ms, tile "
                      f"form alone {kernel_ms:.4f} ms ({times[binds] / kernel_ms:.1%} of "
                      f"the bound)"
                      + ("" if sweep_ms is None else
                         f"; the sweep form alone {sweep_ms:.4f} ms "
                         f"({times[binds] / sweep_ms:.1%})")
                      + f"; plain {plain_ms:.1f} ms (every form equal), bound "
                      f"{times[binds]:.4f} ms by {binds} ({pipe}'s cell: "
                      f"{pipe_slots(pipe)} ALU slots and a lookup over the {cells} cells, "
                      f"n x m a pair), {cells / kernel_ms / 1e6:.1f} GCUPS; {launches} "
                      f"main-path launches, {lost:.3f} ms lost [{smi}]", flush=True)
    t = timings[("gap 0", False)]
    row = dict(name=name, route="cuda", source=f"swtpu_torch/csrc/{GENERAL}",
               replaces=KERNELS[name][2], launches=counts[name], max_abs_err=err,
               ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
               bound_by="bytes" if t["binds"] == "bytes" else "operations",
               library_ms=None, kernel_ms=t["kernel_ms"], sweep_ms=t["sweep_ms"],
               launches_tile=tile_launches, launches_sweep=sweep_launches,
               by_form={form_name(*key): {k: v for k, v in x.items() if k != "binds"}
                        for key, x in timings.items()})
    del qd, td
    torch.cuda.empty_cache()
    return counts, row



def gaps_phase(ctx):
    """Phase 45, the inputs JAX's device serves under gap penalties of 0
    and below and matrix entries past +-127, which the card refused before:
    the wavefront kernel (B14) under a negative gap on the TPU's schedule
    (fault C4), the strip tile (B13) under negative gaps, linear and Gotoh,
    and the semi-global kernels' uniform and profile forms under gaps <= 0
    and BLOSUM62 x 12. Each new form against its plain version, the main
    path's entry points and CLIs on the card (against ``--device cpu``, the
    host's full forward or the plain version), times beside the bound.
    Returns the kernels line's rows of the new forms."""
    from swtpu_torch.batch.lowmem import sw_traceback_lowmem
    from swtpu_torch.core.encode import mutate
    from swtpu_torch.core.protein import BLOSUM62, random_protein
    from swtpu_torch.core.scoring import ScoringParams, dna_matrix
    from swtpu_torch.kernels import longpair_strip as kls
    from swtpu_torch.kernels import semiglobal_batch as ksg
    from swtpu_torch.kernels import semiglobal_profile as ksp
    from swtpu_torch.kernels import sw_profile as kp
    from swtpu_torch.kernels import sw_wavefront as kwf
    from swtpu_torch.ops.variants import variant_engine
    from swtpu_torch.parallel import longpair as lp

    dev, smi, timed, off_path = ctx["dev"], ctx["smi"], ctx["timed"], ctx["off_path"]
    cli_main = ctx["cli_main"]
    NEGB = kls.NEGB
    phase("45 gaps of 0 and below where JAX's device serves them: the wavefront at gap "
          "-1 / -3 (C4), B13 under linear -1 and Gotoh 2/-1, 3/0, the semi-global forms "
          "under gaps <= 0 and BLOSUM62 x 12, vs plain; the CLI vs --device cpu; times")
    print(smi, flush=True)
    rng = np.random.default_rng(SEED + 47)
    i32 = dict(dtype=torch.int32, device=dev)
    WF, ST, SGB, SGP = ("sw_wavefront_negative", "strip_tile_negative",
                        "semiglobal_batch_gaps", "semiglobal_profile_gaps")
    err = dict.fromkeys((WF, ST, SGB, SGP), 0)
    wf = kwf.sw_wavefront
    wrappers = {WF: (wf,), ST: (kls.tile_strip_linear, kls.tile_strip_affine),
                SGB: (ksg.semiglobal_batch,), SGP: (ksp.semiglobal_profile,)}

    def zero():
        for ws in wrappers.values():
            for w in ws:
                for k in [k for k in vars(w) if k.startswith("launches")]:
                    setattr(w, k, 0)

    def count(name):
        if name == WF:  # the negative form's launches
            return wf.launches_negative
        return sum(w.launches for w in wrappers[name])

    def to_dev(*xs):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in xs)

    lin1 = ScoringParams.linear(dna_matrix(1, -1), -1)
    g21 = ScoringParams(dna_matrix(2, -3), 2, -1)
    g30 = ScoringParams(dna_matrix(2, -3), 3, 0)
    uniform = {"gap 0": dict(match=1, mismatch=1, gap=0),
               "gap -1": dict(match=1, mismatch=1, gap=-1),
               "Gotoh 2/-1": dict(match=2, mismatch=1, gap_open=2, gap_extend=-1),
               "Gotoh 3/0": dict(match=2, mismatch=3, gap_open=3, gap_extend=0),
               "Gotoh 0/1": dict(match=1, mismatch=1, gap_open=0, gap_extend=1)}
    profile = {"BLOSUM62 11/0": ScoringParams(BLOSUM62, 11, 0),
               "BLOSUM62 11/-1": ScoringParams(BLOSUM62, 11, -1),
               "BLOSUM62 x 12 11/1": ScoringParams(BLOSUM62 * 12, 11, 1)}

    def sg_call(sc, q, t, plain=False, **kw):
        if isinstance(sc, dict):
            fn = ksg.semiglobal_batch_plain if plain else ksg.semiglobal_batch
            return fn(q, t, **sc, **kw, **({"device": dev} if plain else {}))
        fn = ksp.semiglobal_profile_plain if plain else ksp.semiglobal_profile
        return fn(q, t, sc, **kw, **({"device": dev} if plain else {}))

    def sg_alone(sc, q, t, select=False):
        if isinstance(sc, dict):
            go, ge, affine = ksg.gaps(**{k: v for k, v in sc.items() if k.startswith("gap")})
            return ksg.semiglobal_launch_t(q, t, sc["match"], -sc["mismatch"], go, ge, affine,
                                           False, select=select)
        return ksg.semiglobal_launch_t(
            q, t, int(np.abs(sc.matrix).max()), 0, sc.gap_open, sc.gap_extend,
            not sc.is_linear, False, table=kp.profile_table(sc, dev),
            n_codes=sc.alphabet_size + 1, select=select)

    # every new form against its plain version (and its CPU mirror), off the path
    mark("plain checks")
    with off_path():
        for g in (-1, -3):
            for A, mat in ((4, dna_matrix(1, -1)), (20, BLOSUM62)):
                p = ScoringParams.linear(mat, g)
                for B, n, m in ((1, 7, 128), (3, 100, 150), (200, 128, 128)):
                    qd, td = to_dev(*local_pairs(rng, B, n, m, A, pads=0.05))
                    want = kwf.sw_wavefront_plain(qd, td, p)
                    e = max_abs_err(wf(qd, td, p), want)
                    if B <= 3:
                        e = max(e, max_abs_err(kwf.wavefront_stream_mirror(qd, td, p, 1),
                                               want))
                    if A == 4:  # DNA on the lane table by columns too
                        e = max(e, max_abs_err(kwf.wavefront_launch_t(
                            qd, td, kwf.wavefront_table(p, dev), p, 1, False), want))
                    err[WF] = max(err[WF], e)
                    check(e == 0, f"B14 at gap {g} differs from its plain version on "
                                  f"{B} x {n} x {m} ({A} letters)")
        for label, p in (("linear -1", lin1), ("Gotoh 2/-1", g21), ("Gotoh 3/0", g30)):
            # the last tile's boundaries near 2^27: the endpoint's (value,
            # row) kept apart (the wide form)
            for R, C, high in ((1, 1, 0), (7, 300, 0), (1499, 700, 0), (16383, 33, 0),
                               (40, 1024, 0), (300, 200, kls.KEY_MAX - 150)):
                q = rng.integers(0, 5, R).astype(np.uint8)
                t = rng.integers(0, 5, C).astype(np.uint8)
                top = high + rng.integers(0, 60, C)
                left = high + rng.integers(0, 60, R + 1)
                topf = high + rng.integers(-2, 40, C)
                lefte = high + rng.integers(-2, 40, R + 1)
                lefte[0] = NEGB
                table = torch.as_tensor(kls._extended_table(p), device=dev)
                if p.is_linear:
                    want = kls._tile_colscan(q, t, top, left[1:], left[0], table, 4, p.gap)
                else:
                    want = kls._tile_colscan_affine(q, t, top, topf, left[1:], lefte[1:],
                                                    left[0], table, 4, p.gap_open,
                                                    p.gap_extend)
                sargs = (kls.stage_codes(q, p, dev), kls.stage_codes(t, p, dev),
                         kp.profile_table(p, dev), torch.as_tensor(top, **i32),
                         None if p.is_linear else torch.as_tensor(topf, **i32),
                         torch.as_tensor(left, **i32),
                         None if p.is_linear else torch.as_tensor(lefte, **i32), p)
                e = max(max_abs_err(kls.strip_launch_t(*sargs), want),
                        max_abs_err(kls._one_block_launch_t(*sargs), want))
                err[ST] = max(err[ST], e)
                check(e == 0, f"B13 ({label}) differs from the plain tile on {R} x {C}"
                              + (" (the wide key)" if high else ""))
        for B, n, m, lens in ((4096, 128, 128, False), (1000, 90, 200, True),
                              (33, 7, 1, True), (64, 40, 13, True)):
            qn, tn = semiglobal_pairs(rng, B, n, m)
            pq, pt = random_protein(rng, (B, n)), random_protein(rng, (B, m))
            kw = (dict(lens_q=rng.integers(-1, n + 2, B), lens_t=rng.integers(-1, m + 2, B))
                  if lens else {})
            for scs, (q, t), name in ((uniform, to_dev(qn, tn), SGB),
                                      (profile, to_dev(pq, pt), SGP)):
                for label, sc in scs.items():
                    for pin in (False, True):
                        want = sg_call(sc, q, t, plain=True, **kw, pin_end=pin)
                        e = max_abs_err(sg_call(sc, q, t, **kw, pin_end=pin), want)
                        if not pin and not lens:
                            e = max(e, max_abs_err(sg_alone(sc, q, t, select=True), want))
                        err[name] = max(err[name], e)
                        check(e == 0, f"the semi-global form ({label}, pinned {pin}) "
                                      f"differs from its plain version on {B} x {n} x {m}")
            if n == 40:  # the kernel's CPU mirror on 16 pairs with lengths
                for sc, (q, t) in ((uniform["gap -1"], (qn, tn)),
                                   (profile["BLOSUM62 11/-1"], (pq, pt))):
                    k16 = {k: v[:16] for k, v in kw.items()}
                    qd, td = to_dev(q[:16], t[:16])
                    got = sg_call(sc, qd, td, **k16)
                    mirror = (ksg.semiglobal_skew_mirror(q[:16], t[:16], **sc, **k16)
                              if isinstance(sc, dict) else
                              ksg.semiglobal_skew_mirror(q[:16], t[:16], **k16, params=sc))
                    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, mirror)),
                          "the semi-global kernel vs its CPU mirror under a negative gap")
    print(f"{WF}: B14 at gap -1 and -3 (DNA by pairs of columns and by columns, BLOSUM62) "
          f"on 1 x 7 x 128, 3 x 100 x 150 and 200 x 128 x 128 equals its plain version "
          f"and mirror; {ST}: B13 (pipelined and one-block) under linear -1, Gotoh 2/-1 "
          f"and 3/0 on 1 x 1 to 16383 x 33 with random boundaries (and near 2^27: "
          f"the wide key) equals the plain tile; "
          f"{SGB} / {SGP}: gaps 0, -1, Gotoh 2/-1, 3/0, 0/1, BLOSUM62 11/0, 11/-1 and x 12 "
          f"(entries to 132), argmax (the key and the select tracker) and pinned, fixed and "
          f"per-pair lengths (-1 to n + 1), equal their plain versions and the mirror",
          flush=True)

    # the main path: every count zeroed, then the entry points and the CLI
    mark("main path")
    zero()
    argv = ["align", "--random", "8x128x128", "--engine", "wavefront", "--gap", "-1"]
    card = run_cli(cli_main, argv)
    check(wf.launches_negative == 1, "C4: align --engine wavefront --gap -1 did not run B14")
    with off_path():
        cpu = run_cli(cli_main, argv + ["--device", "cpu"])
    c4 = [json.loads(x)["score"] for x in card]
    check(card == cpu and c4 == [256] * 8, f"C4: {' '.join(argv)} printed {c4}")
    print(f"C4 repaired: {' '.join(argv)} prints {c4} on the card (B14, one launch), equal "
          "to --device cpu", flush=True)
    wfd = {}
    for B in (128, 8192):
        qd, td = to_dev(*local_pairs(rng, B, 128, 128, 4, pads=0))
        got = variant_engine("wavefront", lin1, 128)(qd, td)
        with off_path():
            check(torch.equal(got, kwf.sw_wavefront_plain(qd, td, lin1)),
                  f"B14 at gap -1 on {B} pairs vs its plain version")
        wfd[B] = (qd, td)
    lrng = np.random.default_rng(SEED)  # phase 30's 16K pair
    L = 16384
    lq = lrng.integers(0, 4, L).astype(np.uint8)
    lt = mutate(lrng, lq, p_mismatch=0.1, p_insert=0.025, p_delete=0.025, out_len=L)
    for label, p in (("linear -1", lin1), ("Gotoh 2/-1", g21)):
        before = count(ST)
        ends = lp.longpair_sw_ends(lq, lt, p)
        t0 = time.perf_counter()
        sc, path = sw_traceback_lowmem(lq, lt, p, ends=None)
        check(count(ST) - before == 1 and (sc, *path[-1]) == ends,
              f"longpair_sw_ends on the 16K pair ({label}) vs the host's full forward")
        print(f"longpair_sw_ends 16384 x 16384 {label}: {ends}, one B13 launch; the host's "
              f"full forward (C++, {time.perf_counter() - t0:.2f} s) agrees", flush=True)
    sg_argv = []
    for argv in (["longpair", "--random", "1x300x300", "--gap", "-1"],
                 ["semiglobal", "--random", "4x64x256", "--gap", "-1", "--traceback"],
                 ["global", "--random", "4x64x256", "--gap", "-1", "--traceback"],
                 ["semiglobal", "--alphabet", "protein", "--random", "4x64x256",
                  "--gap-open", "11", "--gap-extend", "0", "--cigar"]):
        card = run_cli(cli_main, argv)
        with off_path():
            cpu = run_cli(cli_main, argv + ["--device", "cpu"])
        check(card == cpu and len(card) >= 1, f"{' '.join(argv)}: the card vs --device cpu")
        sg_argv.append(" ".join(argv))
    print(f"{'; '.join(sg_argv)}: equal to --device cpu", flush=True)
    big = {}
    for A in (4, 20):
        gen = random_codes if A == 4 else random_protein
        big[A] = to_dev(gen(rng, (1 << 20, 128)), gen(rng, (1 << 20, 128)))
    for label, sc in (("gap 0", uniform["gap 0"]), ("gap -1", uniform["gap -1"]),
                      ("BLOSUM62 11/0", profile["BLOSUM62 11/0"])):
        q, t = big[4 if isinstance(sc, dict) else 20]
        for B in (1 << 15, 1 << 20):
            out = sg_call(sc, q[:B], t[:B])
            with off_path():
                check(max_abs_err(tuple(x[:8192] for x in out),
                                  sg_call(sc, q[:8192], t[:8192], plain=True)) == 0,
                      f"the semi-global form ({label}) at {B} pairs: the first 8192")
    counts = {k: count(k) for k in (WF, ST, SGB, SGP)}
    print(f"phase 45's main-path launches: {counts} (B14's all under a negative gap: "
          f"{wf.launches_negative} of {wf.launches})", flush=True)
    check(all(v > 0 for v in counts.values()) and wf.launches == wf.launches_negative,
          f"a new form was not launched on its path: {counts}")

    # times, off the path: each form at its main-path shapes beside its bound
    mark("times")
    rows = []

    def bound(cells, slots, lookups, nbytes):
        times = {"int32 ops": cells * slots / ctx["int32_rate"] * 1e3,
                 "shared-memory lookups": cells * lookups / ctx["lookup_rate"] * 1e3,
                 "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
        binds = max(times, key=times.get)
        return times[binds], binds

    forms = {}
    table1 = kwf.wavefront_table(lin1, dev)
    cli_q, cli_t = to_dev(*local_pairs(np.random.default_rng(SEED), 8, 128, 128, 4, pads=0))
    for B, (qd, td) in ((8192, wfd[8192]), (128, wfd[128]), (8, (cli_q, cli_t))):
        # the TPU schedule's cells: 128 positions x wavefront_steps(n, m)
        cells = B * 128 * kwf.wavefront_steps(128, 128)
        ms = timed(wf, (qd, td, lin1), iters=20) * 1e3
        alone = timed(kwf.wavefront_launch_t, (qd, td, table1, lin1), iters=20) * 1e3
        plain_ms = timed(kwf.sw_wavefront_plain, (qd, td, lin1), iters=1, warmup=1,
                         reps=1) * 1e3
        b, binds = bound(cells, pipe_slots("sw_wavefront"), KERNELS["sw_wavefront"][4],
                         B * 256 + 4 * B)
        forms[f"{B} pairs"] = dict(launches=1, ms=ms, kernel_ms=alone, plain_ms=plain_ms,
                                   bound_ms=b, binds=binds)
        print(f"{WF} {B} x 128 x 128 gap -1 (one pair a stream, 256 steps): wrapper "
              f"{ms:.4f} ms, alone {alone:.4f} ms ({b / alone:.1%} of the bound {b:.4f} ms "
              f"by {binds} over the schedule's {cells} cells), plain {plain_ms:.1f} ms "
              f"[{smi}]", flush=True)
    check(sum(f["launches"] for f in forms.values()) == counts[WF],
          f"{WF}: the window's launches {counts[WF]} are its forms'")
    rows.append(row_of(WF, WAVEFRONT, "sw_wavefront", forms, "8192 pairs", counts[WF], err))

    forms = {}
    for label, p, (q, t) in (("16384 x 16384 linear -1", lin1, (lq, lt)),
                             ("16384 x 16384 Gotoh 2/-1", g21, (lq, lt)),
                             ("300 x 300 linear -1 (the CLI's)", lin1,
                              tuple(np.random.default_rng(SEED).integers(0, 4, (2, 300))
                                    .astype(np.uint8))),
                             ("4096 x 4096 linear -1", lin1, (lq[:4096], lt[:4096]))):
        R, C = len(q), len(t)
        affine = not p.is_linear
        zc, zr = torch.zeros(C, **i32), torch.zeros(R + 1, **i32)
        nc, nr = torch.full((C,), NEGB, **i32), torch.full((R + 1,), NEGB, **i32)
        sargs = (kls.stage_codes(q, p, dev), kls.stage_codes(t, p, dev),
                 kp.profile_table(p, dev), zc, nc if affine else None, zr,
                 nr if affine else None, p)
        wrap = kls.tile_strip_affine if affine else kls.tile_strip_linear
        wargs = (sargs[0], sargs[1], zc, nc, zr, nr, p) if affine else (
            sargs[0], sargs[1], zc, zr, p)
        ms = timed(wrap, wargs, iters=3, warmup=1) * 1e3
        alone = timed(kls.strip_launch_t, sargs, iters=3, warmup=1) * 1e3
        plain_ms = None
        if R == 4096:  # the plain tile once, every return held equal
            t0 = time.perf_counter()
            table = torch.as_tensor(kls._extended_table(p), device=dev)
            want = kls._tile_colscan(q, t, zc, zr[1:], 0, table, 4, p.gap)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            e = max_abs_err(kls.strip_launch_t(*sargs), want)
            err[ST] = max(err[ST], e)
            check(e == 0, "B13 at gap -1 differs from the plain tile at 4096 x 4096")
        b, binds = bound(R * C, strip_ops(affine) * 1.0, 1,
                         R + C + 4 * (2 * C + R + 1) + 4 * (R + C) * (2 if affine else 1))
        launches = {"16384 x 16384 linear -1": 1, "16384 x 16384 Gotoh 2/-1": 1,
                    "300 x 300 linear -1 (the CLI's)": 1}.get(label, 0)
        forms[label] = dict(launches=launches, ms=ms, kernel_ms=alone, plain_ms=plain_ms,
                            bound_ms=b, binds=binds)
        print(f"{ST} {label}: wrapper {ms:.3f} ms, alone {alone:.3f} ms ({b / alone:.2%} of "
              f"the bound {b:.4f} ms by {binds}); {launches} main-path launches"
              + ("" if plain_ms is None else f"; plain tile {plain_ms:.1f} ms") + f" [{smi}]",
              flush=True)
    check(sum(f["launches"] for f in forms.values()) == counts[ST],
          f"{ST}: the window's launches {counts[ST]} are its forms'")
    rows.append(row_of(ST, STRIP, "strip_tile", forms, "4096 x 4096 linear -1", counts[ST],
                       err))

    for name, kname, scs in ((SGB, "semiglobal_batch", (("gap -1", uniform["gap -1"]),
                                                        ("gap 0", uniform["gap 0"]))),
                             (SGP, "semiglobal_profile",
                              (("BLOSUM62 11/0", profile["BLOSUM62 11/0"]),))):
        forms = {}
        cli_rng = np.random.default_rng(SEED)  # the CLI's 4 x 64 x 256 shape
        A = 4 if name == SGB else 20
        cli_pair = to_dev(cli_rng.integers(0, A, (4, 64)).astype(np.uint8),
                          cli_rng.integers(0, A, (4, 256)).astype(np.uint8))
        for label, sc in scs:
            q, t = big[4 if isinstance(sc, dict) else 20]
            for B in (1 << 15, 1 << 20) + ((4,) if label == scs[0][0] else ()):
                qb, tb = (q[:B], t[:B]) if B > 4 else cli_pair
                ms = timed(lambda a, c: sg_call(sc, a, c), (qb, tb), iters=10) * 1e3
                alone = timed(lambda a, c: sg_alone(sc, a, c), (qb, tb), iters=10) * 1e3
                plain_ms = None
                if B != 1 << 20:
                    plain_ms = timed(lambda a, c: sg_call(sc, a, c, plain=True), (qb, tb),
                                     iters=1, warmup=1, reps=1) * 1e3
                n_, m_ = qb.shape[1], tb.shape[1]
                affine = (ksg.gaps(**{k: v for k, v in sc.items() if k.startswith("gap")})[2]
                          if isinstance(sc, dict) else not sc.is_linear)
                form = kname + ("_affine" if affine else "")  # the instantiation's cell
                b, binds = bound(B * n_ * m_, pipe_slots(form), KERNELS[form][4],
                                 B * (n_ + m_) + 12 * B)
                # the window's calls: one at 32768 and one at 1M pairs a
                # scoring; the CLI's (semiglobal and global --gap -1, DNA;
                # semiglobal 11/0, protein) at its own shape
                cli_calls = (2 if name == SGB else 1) if label == scs[0][0] else 0
                forms[f"{label} {B} x {n_} x {m_}"] = dict(
                    launches=1 if B > 4 else cli_calls, ms=ms, kernel_ms=alone,
                    plain_ms=plain_ms, bound_ms=b, binds=binds)
                print(f"{name} {label} {B} x {n_} x {m_} (argmax): wrapper {ms:.4f} ms, alone "
                      f"{alone:.4f} ms ({b / alone:.1%} of the bound {b:.4f} ms by {binds})"
                      + ("" if plain_ms is None else f", plain {plain_ms:.1f} ms")
                      + f" [{smi}]", flush=True)
        check(sum(f["launches"] for f in forms.values()) == counts[name],
              f"{name}: the window's launches {counts[name]} are its forms'")
        main = f"{scs[0][0]} {1 << 15} x 128 x 128"
        rows.append(row_of(name, SEMIGLOBAL, kname, forms, main, counts[name], err))
    del big
    torch.cuda.empty_cache()
    return rows


def row_of(name, source, kernel, forms, main, launches, err):
    """A kernels-line row of one of phase 45's new forms: the named form's
    numbers, every timed form in ``by_form`` (lost ms charges each at its
    own time), the TPU kernel of the row it extends."""
    f = forms[main]
    return dict(name=name, route="cuda", source=f"swtpu_torch/csrc/{source}",
                replaces=KERNELS[kernel][2], launches=launches, max_abs_err=err[name],
                ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                bound_by="bytes" if f["binds"] == "bytes" else "operations",
                library_ms=None, kernel_ms=f["kernel_ms"],
                by_form={k: {x: v for x, v in g.items() if x != "binds"}
                         for k, g in forms.items()})


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":  # a rank of phase 40
        rank, world, store, out = sys.argv[2:6]
        return mesh_worker(int(rank), int(world), store, out)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2

    from swtpu_torch.batch import (
        banded_align_batch, banded_forward_batch, banded_static_align_batch,
        banded_walk_batch, nw_align_batch, promote, semiglobal_align_batch,
        sw_align_batch, sw_scores_promoted, sw_scores_varlen,
    )
    from swtpu_torch.batch.bucketing import _fused_masked_engine
    from swtpu_torch.batch.traceback import banded_static_scores
    from swtpu_torch.cli import main as cli_main
    from swtpu_torch.core.cigar import cigar_stats, path_to_cigar
    from swtpu_torch.core.encode import mutate, unpack_2bit
    from swtpu_torch.core.io import decode_dna, load_fasta_batch, write_fasta
    from swtpu_torch.core.protein import BLOSUM62, decode_protein, random_protein
    from swtpu_torch.core.sam import sam_record
    from swtpu_torch.core.scoring import (
        DNA_10_30_15, DNA_111, ScoringParams, dna_matrix,
    )
    from swtpu_torch.kernels import (
        _build, banded_batch as kbb, banded_block as kbk, device_walk as kdw,
        longpair_strip as kls, semiglobal_batch as ksg, semiglobal_profile as ksp,
        sw_affine as ka, sw_banded as ksb, sw_batch as kb, sw_bf16 as kbf,
        sw_general as kg, sw_profile as kp, sw_wavefront as kwf,
    )
    from swtpu_torch.kernels.banded_scan import (
        BandedBatchResult, _prep_padded, decode_device_walk,
    )
    from swtpu_torch.oracle.banded_affine import banded_affine_xdrop
    from swtpu_torch.oracle.banded_block import (
        banded_xdrop_block, banded_xdrop_block_affine,
    )
    from swtpu_torch.oracle.banded_static import sw_banded_static_score_batch
    from swtpu_torch.oracle.affine import (
        sw_affine_score_batch, sw_affine_traceback,
    )
    from swtpu_torch.oracle.semiglobal import (
        banded_xdrop, nw_affine_full, nw_full, semiglobal_affine_full,
        semiglobal_full,
    )
    from swtpu_torch.oracle.sw import sw_score, sw_score_batch, sw_traceback
    from swtpu_torch.ops import best_ends_engine, best_engine
    from swtpu_torch.ops.variants import resolve_engine, variant_engine
    from swtpu_torch.batch.lowmem import sw_traceback_lowmem
    from swtpu_torch.parallel import longpair as lp
    from swtpu_torch.utils import time_kernel
    from swtpu_torch import native

    dev = torch.device("cuda")
    AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
    P_LIN = ScoringParams.linear(BLOSUM62, 11)
    P_GOTOH = ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)
    DNA_GENERAL = np.array(
        [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]]
    )
    # kernel -> (wrapper, plain version, scoring its times are taken at)
    kernel_fns = {
        "sw_batch": (kb.sw_batch, kb.sw_batch_plain, DNA_10_30_15),
        "sw_batch_ends": (kb.sw_batch_ends, kb.sw_batch_ends_plain, DNA_10_30_15),
        "sw_affine": (ka.sw_affine, ka.sw_affine_plain, AFF),
        "sw_affine_ends": (ka.sw_affine_ends, ka.sw_affine_ends_plain, AFF),
        "sw_profile": (kp.sw_profile, kp.sw_profile_plain, P_LIN),
        "sw_profile_ends": (kp.sw_profile_ends, kp.sw_profile_ends_plain, P_LIN),
        "sw_profile_affine": (kp.sw_profile, kp.sw_profile_plain, P_GOTOH),
        "sw_profile_affine_ends": (kp.sw_profile_ends, kp.sw_profile_ends_plain,
                                   P_GOTOH),
        "sw_bf16": (kbf.sw_bf16, kbf.sw_bf16_plain, DNA_10_30_15),
    }
    for name in PROTEIN_PATH[4:]:  # the warp form: the same wrappers
        kernel_fns[name] = kernel_fns[name[:-len("_warp")]]

    def profile_name(ends, p, warp=False):
        return "sw_profile" + ("" if p.is_linear else "_affine") + (
            "_ends" if ends else "") + ("_warp" if warp else "")

    def warp_form(B, n, m):
        return kp.profile_form(B, n, m, n_sm) == "warp"

    # the semi-global scorings: uniform ones as the wrapper's keyword
    # arguments (match, mismatch penalty, gaps), general ones as params
    SG_111 = dict(match=1, mismatch=1, gap=1)
    SG_AFF = dict(match=2, mismatch=3, gap_open=5, gap_extend=1)
    # semi-global kernel -> (wrapper, scoring its times are taken at, pinned)
    sg_fns = {
        "semiglobal_batch": (ksg.semiglobal_batch, SG_111, False),
        "semiglobal_batch_pinned": (ksg.semiglobal_batch, SG_111, True),
        "semiglobal_batch_affine": (ksg.semiglobal_batch, SG_AFF, False),
        "semiglobal_batch_affine_pinned": (ksg.semiglobal_batch, SG_AFF, True),
        "semiglobal_profile": (ksp.semiglobal_profile, P_LIN, False),
        "semiglobal_profile_pinned": (ksp.semiglobal_profile, P_LIN, True),
        "semiglobal_profile_affine": (ksp.semiglobal_profile, P_GOTOH, False),
        "semiglobal_profile_affine_pinned": (ksp.semiglobal_profile, P_GOTOH,
                                             True),
    }

    def sg_gaps(sc):
        """(go, ge, affine) of a uniform semi-global scoring."""
        return ksg.gaps(**{k: v for k, v in sc.items() if k.startswith("gap")})

    def sg_run(sc, q, t, plain=False, **kw):
        """A semi-global wrapper, or its plain version, on one scoring."""
        if isinstance(sc, dict):
            fn = ksg.semiglobal_batch_plain if plain else ksg.semiglobal_batch
            return fn(q, t, **sc, **kw)
        fn = ksp.semiglobal_profile_plain if plain else ksp.semiglobal_profile
        return fn(q, t, sc, **kw)

    def sg_mirror(sc, q, t, **kw):
        """The CPU mirror of the kernel's schedule on one scoring."""
        if isinstance(sc, dict):
            return ksg.semiglobal_skew_mirror(q, t, **sc, **kw)
        return ksg.semiglobal_skew_mirror(q, t, **kw, params=sc)

    def sg_bare(sc, pin, q, t, select=False):
        """A semi-global form's launch alone on [B, L] codes on the card
        (``select``: the argmax's select tracker where the key would run)."""
        if isinstance(sc, dict):
            go, ge, affine = sg_gaps(sc)
            return ksg.semiglobal_launch_t(q, t, sc["match"], -sc["mismatch"], go, ge,
                                           affine, pin, select=select)
        return ksg.semiglobal_launch_t(
            q, t, int(np.abs(sc.matrix).max()), 0, sc.gap_open, sc.gap_extend,
            not sc.is_linear, pin, table=kp.profile_table(sc, dev),
            n_codes=sc.alphabet_size + 1, select=select)

    def sg_letters(sc):
        """The codes a scoring's inputs are drawn from: 20 for protein."""
        return 4 if isinstance(sc, dict) or sc.alphabet_size == 4 else 20

    def sg_name(sc, pin):
        uniform = isinstance(sc, dict)
        affine = sg_gaps(sc)[2] if uniform else not sc.is_linear
        return ("semiglobal_batch" if uniform else "semiglobal_profile") + (
            "_affine" if affine else "") + ("_pinned" if pin else "")

    def sg_params(sc):
        """A semi-global scoring as ScoringParams (for rescoring)."""
        if not isinstance(sc, dict):
            return sc
        go, ge, _ = sg_gaps(sc)
        return ScoringParams(dna_matrix(sc["match"], -sc["mismatch"]), go, ge)

    def sg_oracle(sc, pin):
        """The oracle copy's walker for a scoring: (q, t) -> (score, path)."""
        p = sg_params(sc)
        kw = (dict(match=sc["match"], mismatch=sc["mismatch"])
              if isinstance(sc, dict) else dict(matrix=p.matrix))
        if p.is_linear:
            fn = nw_full if pin else semiglobal_full
            return lambda q, t: fn(q, t, gap=p.gap, **kw)
        fn = nw_affine_full if pin else semiglobal_affine_full
        return lambda q, t: fn(q, t, gap_open=p.gap_open,
                               gap_extend=p.gap_extend, **kw)

    # the fixed-band scorings (BASELINE config 2's (1, -1, 1), Gotoh
    # (1, -1, 3, 1), protein BLOSUM62 11 and 11/1) and the kernel each runs
    FIX_111 = ScoringParams.linear(dna_matrix(1, -1), 1)
    FIX_AFF = ScoringParams(dna_matrix(1, -1), gap_open=3, gap_extend=1)

    def banded_name(p):
        uniform = kb._uniform_match_mismatch(p) is not None
        return ("sw_banded_static" if uniform else "sw_banded_profile") + (
            "" if p.is_linear else "_affine")

    # B9's two kernels (the one-launch forward, the per-block kernel of the
    # negative-gap route) count together
    b9_wrappers = (kbk.block_forward, kbk.block_rows)
    block_wrappers = {
        "block_rows": b9_wrappers, "block_rows_small": b9_wrappers,
        "block_gather": (kbk.block_gather,), "block_walk": (kdw.block_walk,),
        "xdrop_walk": (kdw.xdrop_walk,),
    }
    banded_wrappers = {
        "sw_banded_static": ksb.sw_banded_static,
        "sw_banded_static_affine": ksb.sw_banded_static,
        "sw_banded_profile": ksb.sw_banded_profile,
        "sw_banded_profile_affine": ksb.sw_banded_profile,
        "banded_batch": kbb.banded_batch,
        "banded_batch_w32_w64": kbb.banded_batch,
    }

    def launches(name):
        if name == "banded_batch_wide":  # the per-round wrapper's wide launches
            return kbb.banded_batch.launches_wide
        if name == "sw_general":  # both wrappers, linear and Gotoh
            return kg.sw_general.launches + kg.sw_general_ends.launches
        if name == "strip_tile":  # B13: its linear and affine calls
            return kls.tile_strip_linear.launches + kls.tile_strip_affine.launches
        if name == "sw_wavefront":
            return kwf.sw_wavefront.launches
        # the profile wrappers count all their launches and, apart, those
        # of the affine instantiation; the semi-global wrappers those of
        # the affine, the pinned and the affine pinned ones; the fixed-band
        # wrappers those of the affine form; the per-round wrapper those
        # at W = 32 or 64; B9's are split by batch shape (b9_shape)
        if name in BLOCK_PATH:
            total = sum(w.launches for w in block_wrappers[name])
            if block_wrappers[name] is b9_wrappers:
                return (b9_folded["launches"] if name.endswith("_small")
                        else total - b9_folded["launches"])
            return total
        if name in BANDED_PATH:
            w = banded_wrappers[name]
            if w is kbb.banded_batch:
                return (w.launches_w32_w64 if name.endswith("w64")
                        else w.launches - w.launches_w32_w64)
            return (w.launches_affine if name.endswith("_affine")
                    else w.launches - w.launches_affine)
        if name in SEMIGLOBAL_PATH:
            w = sg_fns[name][0]
            affine, pin = "_affine" in name, name.endswith("_pinned")
            both = w.launches_affine_pinned
            if affine and pin:
                return both
            if affine:
                return w.launches_affine - both
            if pin:
                return w.launches_pinned - both
            return w.launches - w.launches_affine - w.launches_pinned + both
        kern = kernel_fns[name][0]
        if name not in PROTEIN_PATH:
            return kern.launches
        # the profile wrappers count every launch, the affine ones, the warp
        # form's and its affine ones
        affine, wa = "affine" in name, kern.launches_warp_affine
        if name.endswith("_warp"):
            return wa if affine else kern.launches_warp - wa
        return (kern.launches_affine - wa if affine else
                kern.launches - kern.launches_affine - kern.launches_warp + wa)

    b9_folded = {"launches": 0}

    @contextlib.contextmanager
    def b9_shape(B, W, affine):
        """B9's launches inside count for row 12 where JAX would have run
        its folded kernel at this batch shape, else for row 11."""
        before = sum(w.launches for w in b9_wrappers)
        yield
        if jax_folds(B, W, affine):
            b9_folded["launches"] += sum(w.launches for w in b9_wrappers) - before

    wrappers = list({id(v[0]): v[0] for v in kernel_fns.values()}.values())
    wrappers += [ksg.semiglobal_batch, ksp.semiglobal_profile, ksb.sw_banded_static,
                 ksb.sw_banded_profile, kbb.banded_batch, kbk.block_gather,
                 kbk.block_rows, kbk.block_forward, kdw.block_walk, kdw.xdrop_walk,
                 kls.tile_strip_linear, kls.tile_strip_affine, kwf.sw_wavefront,
                 kg.sw_general, kg.sw_general_ends]
    longpair_wrappers = {"strip_tile": (kls.tile_strip_linear, kls.tile_strip_affine),
                         "sw_wavefront": (kwf.sw_wavefront,)}

    def counts_of(w):
        return {k: v for k, v in vars(w).items() if k.startswith("launches")}

    def zero_launches(names):
        for name in names:
            if name == "banded_batch_wide":  # its launches and its forms'
                for k in counts_of(kbb.banded_batch):
                    if k.startswith("launches_wide"):
                        setattr(kbb.banded_batch, k, 0)
                continue
            if name == "sw_general":
                for w in (kg.sw_general, kg.sw_general_ends):
                    for k in counts_of(w):
                        setattr(w, k, 0)
                continue
            if name in LONGPAIR_PATH or name in BLOCK_PATH:
                for w in (longpair_wrappers if name in LONGPAIR_PATH
                          else block_wrappers)[name]:
                    w.launches = 0
                continue
            w = (banded_wrappers[name] if name in BANDED_PATH else
                 (sg_fns if name in SEMIGLOBAL_PATH else kernel_fns)[name][0])
            for k in counts_of(w):
                setattr(w, k, 0)

    def snapshot():
        return [(w, counts_of(w)) for w in wrappers]

    def restore(saved):
        """Launches since ``snapshot`` (checks and timings beside a main
        path) leave every wrapper's counts as they were."""
        for w, counts in saved:
            for k, v in counts.items():
                setattr(w, k, v)

    @contextlib.contextmanager
    def off_path():
        """Launches inside (a check, a timing loop) are not the path's own:
        every count is as it was after the block."""
        saved = snapshot()
        try:
            yield
        finally:
            restore(saved)

    @contextlib.contextmanager
    def numpy_walkers():
        """The walk sites walk with the numpy oracles inside (what every
        host walk ran before the C++ walkers)."""
        saved = native.available
        native.available = lambda: False
        try:
            yield
        finally:
            native.available = saved

    def timed(fn, args, **kw):
        """``time_kernel`` off the path: a window counts each entry-point
        call once, never a timing loop's repeats."""
        with off_path():
            return time_kernel(fn, args, **kw)

    # 1. environment -------------------------------------------------------
    phase("1 environment")
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = n_sm * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    lookup_rate = n_sm * SMEM_WORDS_PER_SM * sm_clock_mhz * 1e6
    rows = []  # the kernels line

    def rows_by_name(name):
        return next(r for r in rows if r["name"] == name)
    print(f"device {kind} count {count} torch {torch.__version__} "
          f"cuda {torch.version.cuda} max SM clock {sm_clock_mhz:.0f} MHz",
          flush=True)

    # 2. build ------------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    sources = SOURCES
    check(set(sources) == set(_build.SOURCES), f"sources {_build.SOURCES}")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        gxx = pool.submit(native.build)  # the C++ host walkers, beside nvcc
        _build.build_all(sources)  # one nvcc per source, in parallel
        print(f"nvcc {', '.join(sources)}: {time.perf_counter() - t0:.1f} s "
              f"(0.0 s means they were already built)", flush=True)
        gxx.result()
    check(native.available(), "the C++ host walkers")
    print(f"g++ {native.SRC.name} -> {native.library_path().name} (beside nvcc): "
          f"native.available() is True, every host walk below runs in C++", flush=True)
    seen = set()
    many = {}  # B9's and the per-round kernel's instantiations: a line a kernel
    for source in sources:
        for e in re.split(r"Compiling entry function '", _build.build_log(source))[1:]:
            mangled = e.split("'")[0]
            names = [k for k, v in KERNELS.items()
                     if v[0] == source and any(f in mangled for f in tup(v[1]))]
            check(names, f"unknown kernel in nvcc report: {e[:80]}")
            inst = re.search(r"kernelI(.*)EEv", mangled)
            several = len(names) > 1 or isinstance(KERNELS[names[0]][1], tuple)
            tag = (f" <{inst.group(1)}>" if inst else " (" + next(
                f for f in tup(KERNELS[names[0]][1]) if f in mangled) + ")")
            name = "/".join(names) + (tag if several else "")
            regs = re.search(r"Used (\d+) registers", e)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
            smem = re.search(r"(\d+) bytes smem", e)
            check(regs and spill, f"no register report for {name}")
            if ("block_rows" in names or "xdrop_round_kernel" in mangled
                    or "xdrop_wide_kernel" in mangled or "xdrop_wide_warp_kernel" in mangled):
                kern = next(k for k in ("block_fwd_kernel", "block_rows_kernel",
                                        "xdrop_round_kernel", "xdrop_wide_kernel",
                                        "xdrop_wide_warp_kernel")
                            if k in mangled)
                many.setdefault(kern, []).append(
                    (int(regs.group(1)), int(spill.group(1)), int(spill.group(2))))
                seen.update(names)
                continue
            print(f"{name}: registers {regs.group(1)}, spill stores "
                  f"{spill.group(1)} B, spill loads {spill.group(2)} B, shared "
                  f"memory {smem.group(1) if smem else 0} B", flush=True)
            seen.update(names)
    templates = {"block_fwd_kernel": "S, AFFINE, MATRIX, VARLEN, HIST",
                 "block_rows_kernel": "WR, AFFINE, MATRIX, VARLEN, HIST",
                 "xdrop_round_kernel": "CPL, AFFINE, MATRIX, HIST, EXACT",
                 "xdrop_wide_kernel": "AFFINE, MATRIX, HIST, EXACT",
                 "xdrop_wide_warp_kernel": "CPL, AFFINE, MATRIX, HIST, EXACT"}
    for kern, stats in sorted(many.items()):
        regs_, st_, ld_ = zip(*stats)
        label = ("block_rows/block_rows_small" if kern.startswith("block")
                 else "banded_batch_wide" if kern.startswith("xdrop_wide")
                 else "banded_batch/banded_batch_w32_w64")
        print(f"{label} {kern} <{templates[kern]}>: {len(stats)} "
              f"instantiations, registers {min(regs_)}-{max(regs_)}, spill stores "
              f"max {max(st_)} B, spill loads max {max(ld_)} B", flush=True)
    check(seen == set(KERNELS), f"nvcc built {sorted(seen)}")
    # the per-round kernels' round loops as compiled: int32 ALU instructions
    # a round over the cells a lane holds (scores only, linear, uniform
    # scoring, W = 32, 96 and 128, the wide band's one-warp form at 256),
    # the earlier kernel beside them
    cuobjdump = str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    # the SASS of every library read below, dumped at once (seconds each)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda src: sass_text(_build.library_path(src), cuobjdump),
                      (XDROP, SEMIGLOBAL, ROWSCAN, PROFILE, BF16, BANDED, WAVEFRONT)))
    xdrop_sass = {}
    for label, frag, cpl in (
            ("W=32", "xdrop_round_kernelILi1ELb0ELb0ELb0ELb1E", 1),
            ("W=96", "xdrop_round_kernelILi3ELb0ELb0ELb0ELb1E", 3),
            ("W=32 Gotoh", "xdrop_round_kernelILi1ELb1ELb0ELb0ELb1E", 1),
            ("W=128", "xdrop_round_kernelILi4ELb0ELb0ELb0ELb1E", 4),
            ("W=256 one warp", "xdrop_wide_warp_kernelILi8ELb0ELb0ELb0ELb1E", 8),
            ("earlier W=32", "sw_xdrop_kernelILi1ELb0E", 1),
            ("earlier W=96", "sw_xdrop_kernelILi3ELb0E", 3)):
        alu, moves, passes = loop_ops(sass_of(_build.library_path(XDROP), frag, cuobjdump))
        xdrop_sass[label] = alu / passes / cpl
        print(f"per-round kernel {label} ({frag}): round loop {alu} int32 ALU "
              f"instructions and {moves} moves for {passes} round(s) of {cpl} cell(s) "
              f"a lane: {alu / passes / cpl:.1f} int32 ops a cell as compiled",
              flush=True)
    # a cell's own instructions as compiled, the round's work that every
    # lane repeats taken out: the difference between two instantiations of
    # the round body (xdrop_pair) over the cells it adds, against the ALU
    # slots that bound the band (xdrop_ops), which must not exceed it
    slots = xdrop_ops(False, False)[0]
    for lo, hi in (("W=32", "W=96"), ("W=128", "W=256 one warp")):
        c_lo, c_hi = (int(x.split("=")[1].split()[0]) // 32 for x in (lo, hi))
        cell = (xdrop_sass[hi] * c_hi - xdrop_sass[lo] * c_lo) / (c_hi - c_lo)
        print(f"per-round round body, {lo} to {hi}: {cell:.2f} int32 ALU instructions "
              f"a cell as compiled beyond the round's own, against the bound's {slots} "
              f"ALU slots a linear cell (xdrop_ops)", flush=True)
        check(cell >= slots, f"xdrop_ops counts {slots} ALU slots a cell, above the "
                             f"{cell:.2f} the round body issues ({lo} to {hi})")

    # the semi-global kernel's unmasked group as compiled: int32 ALU
    # instructions a cell, beside the cell's own count in KERNELS (which
    # leaves out the steps' code, scratch and ring work)
    sg_lib = _build.library_path(SEMIGLOBAL)
    for name in SEMIGLOBAL_PATH:
        for frag in tup(KERNELS[name][1]):
            affine = frag[len(SG_KERNEL):].startswith("Lb1E")  # <AFFINE, ...>
            alu, imad, moves, _, cells = group_loop_ops(
                sass_of(sg_lib, frag, cuobjdump), "VIADDMNMX",
                (3 if affine else 1) * ksg.GROUP * ksg.ROWS, ksg.GROUP * ksg.ROWS)
            print(f"{name} ({frag}): unmasked group {alu} int32 ALU instructions, "
                  f"{imad} IMADs and {moves} moves for {cells} cells: "
                  f"{(alu + imad) / cells:.2f} int32 instructions a cell as compiled, "
                  f"{alu / cells:.2f} of them on the ALU (the cell's own: "
                  f"{KERNELS[name][3]}, {ALU_OPS[name]} on the ALU)", flush=True)

    # the local row-scan and the profile thread form (the skewed tile of
    # csrc/sw_local_tile.cuh): the unmasked group as compiled, by pipe,
    # every instantiation (the score's narrow and WIDE forms, the key, the
    # select tracker)
    for name in DNA_PATH + PROTEIN_PATH[:4]:
        source = KERNELS[name][0]
        for frag in tup(KERNELS[name][1]):
            affine = "ILb1E" in frag  # <AFFINE, ...>
            alu, imad, moves, _, cells = group_loop_ops(
                sass_of(_build.library_path(source), frag, cuobjdump), "VIADDMNMX",
                (3 if affine else 1) * kb.GROUP * kb.ROWS, kb.GROUP * kb.ROWS)
            print(f"{name} ({frag}): unmasked group {alu} int32 ALU instructions, "
                  f"{imad} IMADs and {moves} moves for {cells} cells: "
                  f"{(alu + imad) / cells:.2f} int32 instructions a cell as compiled, "
                  f"{alu / cells:.2f} of them on the ALU (the cell's own: "
                  f"{KERNELS[name][3]}, {ALU_OPS[name]} on the ALU)", flush=True)

    # the bf16 and fixed-band kernels' unmasked group as compiled, by pipe
    for name, source, frag, marker, n_marker, cells in (
            ("sw_bf16", BF16, "sw_bf16_kernelILb0E", "VIMNMX3", 96, 128),
            ("sw_bf16 (match-indicator form)", BF16, "sw_bf16_kernelILb1E", "VIMNMX3", 96, 128),
            ("sw_banded_static", BANDED, "sw_banded_kernelILb0ELb0E", "VIADDMNMX", 64, 64),
            ("sw_banded_static_affine", BANDED, "sw_banded_kernelILb1ELb0E", "VIADDMNMX",
             192, 64),
            ("sw_banded_profile", BANDED, "sw_banded_kernelILb0ELb1E", "VIADDMNMX", 64, 64),
            ("sw_banded_profile_affine", BANDED, "sw_banded_kernelILb1ELb1E", "VIADDMNMX",
             192, 64)):
        alu, imad, moves, half, cells = group_loop_ops(
            sass_of(_build.library_path(source), frag, cuobjdump), marker, n_marker, cells)
        kname = name.split(" ")[0]
        print(f"{name} ({frag}): unmasked group {alu} int32 ALU instructions, {imad} "
              f"IMADs, {half} packed bf16 and {moves} moves for {cells} cells: "
              f"{(alu + imad) / cells:.2f} int32 and {half / cells:.2f} bf16 instructions "
              f"a cell as compiled, {alu / cells:.2f} on the ALU (the cell's own: "
              f"{KERNELS[kname][3]} int32, {ALU_OPS[kname]} on the ALU)", flush=True)
    # the wavefront kernel's iteration loop as compiled, each form <PAIRS>:
    # a pass of the loop runs an iteration (PAIRS: two) of 8 steps of 8
    # cells a lane
    for frag in KERNELS["sw_wavefront"][1]:
        cells = (2 if frag.endswith("Lb1E") else 1) * kwf.ROWS * kwf.ROWS
        alu, imad, moves, lds, other, skipped = wavefront_loop_ops(
            sass_of(_build.library_path(WAVEFRONT), frag, cuobjdump), cells)
        print(f"sw_wavefront ({frag}): a loop pass ({cells} cells a lane) runs {alu} int32 "
              f"ALU instructions, {imad} IMADs, {moves} moves, {lds} shared-memory loads "
              f"(the lookups and the codes) and {other} others: "
              f"{(alu + imad) / cells:.2f} int32 instructions a cell as compiled, "
              f"{alu / cells:.2f} on the ALU, "
              f"{(alu + imad + moves + lds + other) / cells:.2f} issued; beside them "
              f"{skipped} in the refill (one iteration in 8) and forcing blocks (the "
              f"cell's own: {4.0 if frag.endswith('Lb1E') else 4.5} int32, "
              f"{ALU_OPS['sw_wavefront']} on the ALU, "
              f"{0.5 if frag.endswith('Lb1E') else 1} lookup)", flush=True)
    # the pipe-rate probe: which pipe each instruction kind issues on
    rates = probe_rates(cuobjdump, n_sm, sm_clock_mhz * 1e6)
    # the packed bf16 ops' results a clock an SM, as measured (2 a lane)
    bf16_rate = n_sm * 2 * min(rates["HFMA2"], rates["HADD2"]) * sm_clock_mhz * 1e6

    # 3. kernels vs plain versions -----------------------------------------
    ctx = dict(dev=dev, smi=smi, timed=timed, off_path=off_path, cli_main=cli_main,
               launches=launches, zero_launches=zero_launches, int32_rate=int32_rate,
               lookup_rate=lookup_rate)
    if sys.argv[1:] == ["--phase", "45"]:  # phases 1, 2 and 45 alone
        return report(gaps_phase(ctx), kind, count)

    phase("3 kernels vs plain versions (exact)")
    rng = np.random.default_rng(SEED)
    max_err = {name: 0 for name in KERNELS}
    flag_q = random_codes(rng, (32768, 128))
    flag_t = random_codes(rng, (32768, 128))
    odd_q = random_codes(rng, (1000, 90))
    odd_q[:, 70:] = 4
    odd_t = random_codes(rng, (1000, 200))
    mark("row-scan kernels")
    cases = [
        ("32768x128x128", flag_q, flag_t, [DNA_10_30_15, AFF]),
        ("1000x90x200 pad tail", odd_q, odd_t, [DNA_10_30_15, AFF]),
        ("32768x128x128 tie-rich", flag_q, flag_t, [
            ScoringParams.linear(dna_matrix(2, -1), 1),
            ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1),
        ]),
        ("32768x128x128 mismatch>=0", flag_q, flag_t, [
            ScoringParams.linear(dna_matrix(1, 1), 1),
            ScoringParams(dna_matrix(1, 1), gap_open=2, gap_extend=1),
        ]),
    ]
    for label, qh, th, plist in cases:
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        for p in plist:
            names = ["sw_affine", "sw_affine_ends"]
            if p.is_linear:  # the affine kernel with open == extend too
                names = ["sw_batch", "sw_batch_ends"] + names
            for name in names:
                kern, plain, _ = kernel_fns[name]
                got = kern(qd, td, p)
                torch.cuda.synchronize()
                err = max_abs_err(got, plain(qd, td, p))
                max_err[name] = max(max_err[name], err)
                print(f"{label} ({int(p.matrix[0, 0])},{int(p.matrix[0, 1])},"
                      f"{p.gap_open},{p.gap_extend}) {name}: max |kernel - "
                      f"plain| = {err}", flush=True)
                check(err == 0, f"{name} differs from its plain version on {label}")
    # the skewed tile's odd shapes (n below, at and past a sweep of 16 rows,
    # 129, m not a multiple of 4, below 16, 1), internal pads on both
    # sides, half the pairs related, scores too wide for the packed key and
    # for the min-cap pad rule: each instantiation against its plain
    # version and, on the first 16 pairs, its CPU mirror; the library's
    # choice of form against the mirror's; the forced select tracker
    # against the key (their own generator, so later phases keep their
    # inputs)
    lrng = np.random.default_rng(SEED + 21)
    wide_scorings = [ScoringParams.linear(dna_matrix(10**6, -1), 1),
                     ScoringParams(dna_matrix(3, -(2**21)), gap_open=5, gap_extend=1)]
    rs_lib = _build.load(ROWSCAN)
    rs_lib.swtpu_sw_rowscan_form.restype = ctypes.c_int
    for B_, n_, m_ in ((512, 15, 37), (512, 16, 16), (512, 17, 9), (256, 129, 130),
                       (300, 33, 1)):
        qh, th = local_pairs(lrng, B_, n_, m_, 4)
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        for p in [DNA_10_30_15, AFF, ScoringParams.linear(dna_matrix(2, -1), 1),
                  ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1)] + wide_scorings:
            mm = kb._uniform_match_mismatch(p)
            names = ["sw_affine", "sw_affine_ends"]
            if p.is_linear:
                names = ["sw_batch", "sw_batch_ends"] + names
            forms = []
            for name in names:
                kern, plain, _ = kernel_fns[name]
                affine, ends = "affine" in name, name.endswith("_ends")
                got = tup(kern(qd, td, p))
                err = max_abs_err(got, tup(plain(qd, td, p)))
                max_err[name] = max(max_err[name], err)
                check(err == 0, f"{name} differs from its plain version on {B_}x{n_}x{m_}")
                mirror = tup(kb.local_skew_mirror(qh[:16], th[:16], p, ends, profile=False,
                                                  affine=affine))
                check(all(torch.equal(g[:16].cpu(), w) for g, w in zip(got, mirror)),
                      f"{name} differs from its CPU mirror on {B_}x{n_}x{m_}")
                end, wide, _ = kb.local_tracker(False, ends, n_, m_, *mm, p.gap_open,
                                                p.gap_extend)
                lib_form = rs_lib.swtpu_sw_rowscan_form(int(ends), 0, n_, m_, *mm, p.gap_open,
                                                        p.gap_extend)
                check(lib_form == 2 * end + wide, f"{name}: the library's form {lib_form}, "
                      f"the mirror's {(end, wide)}")
                if end == kb.END_KEY:  # the select tracker gives the same
                    sel = kb.rowscan_launch_t(qd, td, p, *mm, affine, True, select=True)
                    check(all(torch.equal(g, w) for g, w in zip(sel, got)),
                          f"{name}: the select tracker differs from the key")
                forms.append(f"{name} {('score', 'key', 'select')[end]}"
                             f"{' wide' if wide else ''}")
            print(f"{B_}x{n_}x{m_} ({mm[0]},{mm[1]},{p.gap_open},{p.gap_extend}): "
                  f"{', '.join(forms)} equal to the plain version and, on 16 pairs, the "
                  "CPU mirror", flush=True)
    mark("profile kernels")
    # the profile kernels: protein and general DNA matrices (their own
    # generator, so the DNA phases keep their inputs)
    prng = np.random.default_rng(SEED + 1)
    prot_q = random_protein(prng, (8192, 128))
    prot_t = random_protein(prng, (8192, 128))
    ptail_q = random_protein(prng, (1000, 90))
    ptail_q[:, 70:] = 24
    ptail_t = random_protein(prng, (1000, 200))
    ptail_t[:500, 180:] = 25
    dna_n_q, dna_n_t = flag_q[:8192].copy(), flag_t[:8192].copy()  # internal N (code 4)
    dna_n_q[prng.random(dna_n_q.shape) < 0.05] = 4
    dna_n_t[prng.random(dna_n_t.shape) < 0.05] = 4
    profile_cases = [
        ("8192x128x128 protein", prot_q, prot_t, [P_LIN, P_GOTOH]),
        ("1000x90x200 protein pad tail", ptail_q, ptail_t, [P_LIN, P_GOTOH]),
        ("8192x128x128 DNA general matrix, internal N", dna_n_q, dna_n_t, [
            ScoringParams.linear(DNA_GENERAL, 2),
            ScoringParams(DNA_GENERAL, gap_open=3, gap_extend=1),
        ]),
        ("8192x128x128 protein tie-rich", prot_q, prot_t,
         [ScoringParams.linear(BLOSUM62, 1)]),
        ("4x40x1024 protein", random_protein(prng, (4, 40)),
         random_protein(prng, (4, 1024)), [P_LIN, P_GOTOH]),
        ("33x7x1 protein", random_protein(prng, (33, 7)),
         random_protein(prng, (33, 1)), [P_LIN, P_GOTOH]),
    ]
    # the warp form's shapes: stripes of 128 rows (n = 129, 300), a
    # config-3 bucket's (120 x 800, targets padded with 25 past their
    # lengths), a one-row query
    c3q = random_protein(prng, (512, 120))
    c3t = random_protein(prng, (512, 800))
    c3t[np.arange(800)[None, :] >= prng.integers(80, 801, 512)[:, None]] = 25
    w3q, w3t = random_protein(prng, (64, 300)), random_protein(prng, (64, 320))
    w3q[:16, :300] = w3t[:16, :300]
    w3q[:, 290:] = 24
    w3t[::3, 7] = 25
    profile_cases += [
        ("512x120x800 protein, config-3 bucket", c3q, c3t, [P_LIN, P_GOTOH]),
        ("64x300x320 protein, 3 stripes, pads", w3q, w3t, [P_LIN, P_GOTOH]),
        ("8x129x33 protein", random_protein(prng, (8, 129)),
         random_protein(prng, (8, 33)), [P_LIN, P_GOTOH]),
        ("40x1x50 protein", random_protein(prng, (40, 1)),
         random_protein(prng, (40, 50)), [P_LIN, P_GOTOH]),
    ]
    # the thread form's skewed tile: n = 15, 16, 17, 129, m not a multiple
    # of 4 or below 16, internal pads, half related; a target long enough
    # that the packed key cannot hold the scores (its own generator)
    lrng = np.random.default_rng(SEED + 22)
    tile_labels = set()
    for B_, n_, m_ in ((512, 15, 37), (512, 16, 16), (512, 17, 9), (256, 129, 130),
                       (4, 1200, 3000)):
        tile_labels.add(f"{B_}x{n_}x{m_} protein, internal pads")
        profile_cases.append((f"{B_}x{n_}x{m_} protein, internal pads",
                              *local_pairs(lrng, B_, n_, m_, 20),
                              [P_GOTOH] if n_ * m_ > 40000 else [P_LIN, P_GOTOH]))
    pt_lib = _build.load(PROFILE)
    pt_lib.swtpu_sw_profile_form.restype = ctypes.c_int
    for label, qh, th, plist in profile_cases:
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        n_, m_ = qh.shape[1], th.shape[1]
        for p in plist:
            table = kp.profile_table(p, dev)
            for ends, kern, plain in ((False, kp.sw_profile, kp.sw_profile_plain),
                                      (True, kp.sw_profile_ends,
                                       kp.sw_profile_ends_plain)):
                want = plain(qd, td, p)
                # both forms, and the wrapper (the form profile_form picks)
                for warp in (False, True):
                    name = profile_name(ends, p, warp)
                    got = (kp.profile_warp_launch_t(qd, td, table, p, ends) if warp
                           else kp.profile_launch_t(qd, td, table, p, ends))
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    max_err[name] = max(max_err[name], err)
                    check(err == 0, f"{name} differs from its plain version on {label}")
                check(max_abs_err(kern(qd, td, p), want) == 0, f"{kern.__name__} on {label}")
                # the thread form: its tracker as the library and the mirror
                # choose it, the select tracker, the CPU mirror on 16 pairs
                end, _, _ = kb.local_tracker(True, ends, n_, m_, 0, 0, p.gap_open,
                                             p.gap_extend)
                check(pt_lib.swtpu_sw_profile_form(int(ends), 0, n_, m_, p.gap_open,
                                                   p.gap_extend) == end,
                      f"{profile_name(ends, p)}: the library's tracker on {label}")
                if end == kb.END_KEY:
                    check(max_abs_err(kp.profile_launch_t(qd, td, table, p, True,
                                                          select=True), want) == 0,
                          f"{profile_name(ends, p)}: the select tracker on {label}")
                mirrored = label in tile_labels and n_ * m_ <= 40000
                if mirrored:
                    mirror = tup(kp.profile_skew_mirror(qh[:16], th[:16], p, ends))
                    check(all(torch.equal(g[:16].cpu(), w) for g, w in zip(tup(want), mirror)),
                          f"{profile_name(ends, p)} differs from its CPU mirror on {label}")
                print(f"{label} gap=({p.gap_open},{p.gap_extend}) {profile_name(ends, p)}"
                      f" ({('score', 'key', 'select')[end]}) and "
                      f"{profile_name(ends, p, True)}: max |kernel - plain| = 0"
                      f"{'; the mirror equal on 16 pairs' if mirrored else ''}; the "
                      f"wrapper ran the {kp.profile_form(*qh.shape, th.shape[1], n_sm)} "
                      "form", flush=True)
    # the profile kernel on a uniform scoring equals the row-scan kernel
    qd, td = torch.from_numpy(flag_q).to(dev), torch.from_numpy(flag_t).to(dev)
    for p in (DNA_10_30_15, AFF):
        row = ((kb.sw_batch, kb.sw_batch_ends) if p.is_linear
               else (ka.sw_affine, ka.sw_affine_ends))
        for ends, kern, rkern in ((False, kp.sw_profile, row[0]),
                                  (True, kp.sw_profile_ends, row[1])):
            err = max_abs_err(kern(qd, td, p), rkern(qd, td, p))
            check(err == 0, f"{profile_name(ends, p)} differs from "
                  f"{rkern.__name__} on uniform scoring")
    print("32768x128x128 uniform DNA scoring: the profile kernels equal the "
          "row-scan kernels", flush=True)
    mark("bf16 kernel")
    # the bf16 kernel inside its exact range: its plain version, the
    # row-scan kernel and, on 64 pairs, the oracle (its own generator)
    brng = np.random.default_rng(SEED + 2)
    bf16_cases = [
        ("32768x128x128", flag_q, flag_t),
        ("1000x90x200 pad tail", odd_q, odd_t),
        ("4x40x1024", random_codes(brng, (4, 40)), random_codes(brng, (4, 1024))),
        ("33x7x1", random_codes(brng, (33, 7)), random_codes(brng, (33, 1))),
    ]
    for label, qh, th in bf16_cases:
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        for p in (DNA_10_30_15, DNA_111):
            got = kbf.sw_bf16(qd, td, p)
            torch.cuda.synchronize()
            err = max_abs_err(got, kbf.sw_bf16_plain(qd, td, p))
            max_err["sw_bf16"] = max(max_err["sw_bf16"], err)
            check(err == 0, f"sw_bf16 differs from its plain version on {label}")
            check(torch.equal(got[:64].cpu(), kbf.bf16_skew_mirror(qh[:64], th[:64], p)),
                  f"sw_bf16 differs from its CPU mirror on {label}")
            check(torch.equal(got, kb.sw_batch(qd, td, p)),
                  f"sw_bf16 differs from sw_batch inside the predicate on {label}")
            if label == "32768x128x128":
                check(np.array_equal(got[:64].cpu().numpy(),
                                     sw_score_batch(qh[:64], th[:64], p)),
                      "sw_bf16 vs the oracle on 64 pairs")
            print(f"{label} ({int(p.matrix[0, 0])},{int(p.matrix[0, 1])},"
                  f"{p.gap}) sw_bf16: max |kernel - plain| = {err}; equal to "
                  f"sw_batch and, on the first 64 pairs, the CPU mirror", flush=True)
    # above the exact range: config 4's promotion workload (phase 12),
    # raw values with allow_overflow, under its scoring and under (7, -1, 1)
    prom_q, prom_t, prom_warm = promotion_workload(32768)
    qd, td = torch.from_numpy(prom_q).to(dev), torch.from_numpy(prom_t).to(dev)
    for p in (DNA_111, ScoringParams.linear(dna_matrix(7, -1), 1)):
        raw = kbf.sw_bf16(qd, td, p, allow_overflow=True)
        torch.cuda.synchronize()
        err = max_abs_err(raw, kbf.sw_bf16_plain(qd, td, p, allow_overflow=True))
        max_err["sw_bf16"] = max(max_err["sw_bf16"], err)
        check(err == 0, "sw_bf16 differs from its plain version above the bound")
        check(torch.equal(raw[:32].cpu(), kbf.bf16_skew_mirror(
            prom_q[:32], prom_t[:32], p, allow_overflow=True)),
            "sw_bf16 differs from its CPU mirror above the bound")
        exact = kb.sw_batch(qd, td, p)
        low = (raw < 255) | (exact < 255)
        check(torch.equal(raw[low], exact[low]),
              "sw_bf16 below 255 differs from the int32 kernel")
        check(torch.equal(raw >= 255, exact >= 255),
              "sw_bf16 and the int32 kernel disagree on the pairs at 255 or more")
        print(f"32768x300x320 promotion workload ({int(p.matrix[0, 0])},"
              f"{int(p.matrix[0, 1])},{p.gap}), allow_overflow: max |kernel - "
              f"plain| = {err} (the first 32 equal the CPU mirror); "
              f"{int((raw >= 255).sum())} pairs at 255 or more in "
              f"both tiers, {int((raw != exact).sum())} of them drifted (raw "
              f"minus exact in [{int((raw - exact)[~low].min())}, "
              f"{int((raw - exact)[~low].max())}]); every pair below 255 "
              f"exact", flush=True)
    # the pads of the bf16 tier: equal codes match, pads included
    pq = random_codes(brng, (16, 32))
    pq[:, 10:14] = 4  # N on both sides
    q30 = random_codes(brng, (16, 30))  # n = 30 pads to 32 rows of code 4
    t32 = np.concatenate([q30, np.full((16, 2), 4, np.uint8)], axis=1)
    for label, qh, th in (("N in both sequences", pq, pq),
                          ("target NN against the query's pad rows", q30, t32)):
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        got = kbf.sw_bf16(qd, td, DNA_111)
        err = max_abs_err(got, kbf.sw_bf16_plain(qd, td, DNA_111))
        max_err["sw_bf16"] = max(max_err["sw_bf16"], err)
        check(err == 0 and bool((got == 32).all()), f"sw_bf16 pad case: {label}")
        # the int32 tiers score every pad at -2^20
        int32 = kb.sw_batch(qd, td, DNA_111)
        check(torch.equal(int32, kb.sw_batch_plain(qd, td, DNA_111))
              and bool((int32 < 32).all()), f"sw_batch pad case: {label}")
        print(f"pad case, {label}: sw_bf16 32 (equal to its plain version), "
              f"sw_batch {sorted(set(int32.tolist()))}", flush=True)
    # 64-pair spot checks against the numpy oracle
    for label, qh, th, plist in (
        ("DNA", flag_q[:64], flag_t[:64], (DNA_10_30_15, AFF)),
        ("protein", prot_q[:64], prot_t[:64], (P_LIN, P_GOTOH)),
    ):
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        for p in plist:
            batch_oracle, walker = ((sw_score_batch, sw_traceback) if p.is_linear
                                    else (sw_affine_score_batch, sw_affine_traceback))
            if label == "DNA":
                fn_s, fn_e = ((kb.sw_batch, kb.sw_batch_ends) if p.is_linear
                              else (ka.sw_affine, ka.sw_affine_ends))
            else:
                fn_s, fn_e = kp.sw_profile, kp.sw_profile_ends
            want = batch_oracle(qh, th, p)
            check(np.array_equal(fn_s(qd, td, p).cpu().numpy(), want),
                  f"{fn_s.__name__} vs oracle")
            sc, ei, ej = (x.cpu().numpy() for x in fn_e(qd, td, p))
            for b in range(64):
                s0, path = walker(qh[b], th[b], p)
                check(s0 == sc[b] and (ei[b], ej[b]) == (path[-1] if s0 else (0, 0)),
                      f"{fn_e.__name__} vs oracle at pair {b}")
            print(f"oracle spot check, 64 {label} pairs, gap=({p.gap_open},"
                  f"{p.gap_extend}), {fn_s.__name__} and {fn_e.__name__}: "
                  f"scores and endpoints equal", flush=True)
    del flag_q, flag_t, prot_q, prot_t, dna_n_q, dna_n_t, qd, td
    torch.cuda.empty_cache()
    mark("semi-global kernels")
    # the semi-global kernels, argmax and pinned, on every scoring of the
    # CPU tests (their own generator); related pairs put the endpoints
    # inside the matrix, internal pads meet the XLA pad rule
    sgrng = np.random.default_rng(SEED + 5)
    sg_scorings = [
        ("(1,1,1)", SG_111), ("(2,1,1)", dict(match=2, mismatch=1, gap=1)),
        ("(2,3,5,1)", SG_AFF),
        ("(2,3,2,2)", dict(match=2, mismatch=3, gap_open=2, gap_extend=2)),
        ("BLOSUM62 11", P_LIN), ("BLOSUM62 11/1", P_GOTOH),
        ("DNA matrix 2", ScoringParams.linear(DNA_GENERAL, 2)),
        ("DNA matrix 3/1", ScoringParams(DNA_GENERAL, gap_open=3, gap_extend=1)),
    ]
    sg_first16 = {}
    for label, B, n, m in (("8192x128x128", 8192, 128, 128),
                           ("1000x90x200 varlen, internal pads", 1000, 90, 200),
                           ("33x7x1", 33, 7, 1), ("4x40x1024", 4, 40, 1024)):
        codes = {4: semiglobal_pairs(sgrng, B, n, m, 4),
                 20: semiglobal_pairs(sgrng, B, n, m, 20)}
        lens = {}
        if "varlen" in label:
            for A, (qh, th) in codes.items():
                pad_q, pad_t = (4, 5) if A == 4 else (24, 25)
                qh[sgrng.random(qh.shape) < 0.02] = pad_q
                th[sgrng.random(th.shape) < 0.02] = pad_t
            lq, lt = sgrng.integers(0, n + 1, B), sgrng.integers(0, m + 1, B)
            lq[:3], lt[:3] = (0, n, 0), (m, 0, 0)
            lens = dict(lens_q=lq, lens_t=lt)
        if B == 8192:
            sg_first16 = {A: (qh[:8], th[:8]) for A, (qh, th) in codes.items()}
        dev_codes = {A: (torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev))
                     for A, (qh, th) in codes.items()}
        for slabel, sc in sg_scorings:
            qd, td = dev_codes[sg_letters(sc)]
            inside = []
            for pin in (False, True):
                name = sg_name(sc, pin)
                got = sg_run(sc, qd, td, pin_end=pin, **lens)
                torch.cuda.synchronize()
                err = max_abs_err(got, sg_run(sc, qd, td, plain=True, pin_end=pin,
                                              **lens))
                max_err[name] = max(max_err[name], err)
                check(err == 0, f"{name} differs from its plain version on {label} "
                      f"{slabel}")
                inside.append(int((got[1] > 0).sum()))
            print(f"{label} {slabel}: {sg_name(sc, False)} and {sg_name(sc, True)}: "
                  f"max |kernel - plain| = 0; {inside[0]} of {B} argmax endpoints "
                  f"inside the matrix", flush=True)
    del dev_codes, qd, td
    # the skewed tile's odd shapes (rows below, at and past a sweep of ROWS,
    # ragged; columns 0, 1, below ROWS, 3 mod GROUP; lengths down to 0) and
    # scores too wide for the argmax's packed key: each form against its
    # plain version and against the CPU mirror of its schedule
    R = ksg.ROWS
    wide = [("wide (10^6,1,1)", dict(match=10**6, mismatch=1, gap=1)),
            ("wide (10^6,3,5,1)", dict(match=10**6, mismatch=3, gap_open=5,
                                        gap_extend=1))]
    for B, n, m in ((64, R // 2 - 1, 2 * R + 3), (64, 2 * R + 3, R + 5), (16, R + 1, 0),
                    (16, R + 1, 1), (64, 2 * R, R - 3), (64, R + 1, R + 7), (8, 1, 1)):
        codes = {A: semiglobal_pairs(sgrng, B, n, m, A) if n >= 4 else (  # related: n >= 4
            sgrng.integers(0, A, (B, n), dtype=np.uint8),
            sgrng.integers(0, A, (B, m), dtype=np.uint8)) for A in (4, 20)}
        lq, lt = sgrng.integers(0, n + 1, B), sgrng.integers(0, m + 1, B)
        lq[:3], lt[:3] = (0, n, 0), (m, 0, 0)
        for slabel, sc in [sg_scorings[i] for i in (1, 2, 4, 5)] + wide:
            qh, th = codes[sg_letters(sc)]
            qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
            for pin in (False, True):
                name = sg_name(sc, pin)
                for lens in (dict(lens_q=lq, lens_t=lt), {}):
                    got = sg_run(sc, qd, td, pin_end=pin, **lens)
                    err = max(max_abs_err(got, sg_run(sc, qd, td, plain=True, pin_end=pin,
                                                      **lens)),
                              max_abs_err(tuple(x.cpu() for x in got), sg_mirror(
                                  sc, qh, th, pin_end=pin, **lens)))
                    max_err[name] = max(max_err[name], err)
                    check(err == 0, f"{name} differs from its plain version or the "
                          f"mirror on {B}x{n}x{m} {slabel}")
        print(f"{B}x{n}x{m}, with and without lengths: every semi-global form on "
              "(2,1,1), (2,3,5,1), BLOSUM62 11 and 11/1 and two wide scorings equals its "
              "plain version and the CPU mirror", flush=True)
    # 8-pair spot checks against the oracle copy (the first 8 of the 8192
    # set: related pairs)
    for slabel, sc in (("(1,1,1)", SG_111), ("(2,3,5,1)", SG_AFF),
                       ("BLOSUM62 11", P_LIN), ("BLOSUM62 11/1", P_GOTOH)):
        qh, th = sg_first16[sg_letters(sc)]
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        for pin in (False, True):
            sc_d, ei, ej = (x.cpu().numpy() for x in sg_run(sc, qd, td, pin_end=pin))
            walker = sg_oracle(sc, pin)
            for b in range(8):
                s0, path = walker(qh[b], th[b])
                check((s0, path[-1]) == (sc_d[b], (ei[b], ej[b])),
                      f"{sg_name(sc, pin)} vs the oracle copy at pair {b}")
        print(f"oracle spot check, 8 pairs, {slabel}: {sg_name(sc, False)} and "
              f"{sg_name(sc, True)} scores and endpoints equal", flush=True)
    del qd, td
    torch.cuda.empty_cache()

    mark("fixed-band kernel")
    # the fixed-band kernel (row 10), both forms, on the shape classes of
    # the Pallas kernel's tests (its own generator): half related pairs,
    # ragged shapes both ways, internal pads and per-pair lengths, W from 8
    # to past max(n, m); 64 pairs against the oracle copy
    frng = np.random.default_rng(SEED + 7)
    fixed_scorings = [("(1,-1,1)", FIX_111), ("(10,-30,15)", DNA_10_30_15),
                      ("Gotoh (1,-1,3,1)", FIX_AFF), ("BLOSUM62 11", P_LIN),
                      ("BLOSUM62 11/1", P_GOTOH),
                      ("DNA matrix 3/1", ScoringParams(DNA_GENERAL, 3, 1))]

    def banded_pairs(rng, B, n, m, A):
        """Half the pairs related (the query, cut or filled to m, with 10%
        substitutions), half random."""
        qs = rng.integers(0, A, size=(B, n), dtype=np.uint8)
        ts = rng.integers(0, A, size=(B, m), dtype=np.uint8)
        k = min(n, m)
        ts[: B // 2, :k] = qs[: B // 2, :k]
        sub = rng.random((B // 2, k)) < 0.1
        ts[: B // 2, :k][sub] = rng.integers(0, A, int(sub.sum()), dtype=np.uint8)
        return qs, ts

    def fixed_kernels(p):
        """The fixed-band wrappers that take ``p``: the profile form always,
        the uniform form for a uniform matrix."""
        uniform = kb._uniform_match_mismatch(p) is not None
        return [ksb.sw_banded_profile] + ([ksb.sw_banded_static] if uniform else [])

    def fixed_name(kern, p):
        return kern.__name__ + ("" if p.is_linear else "_affine")

    for label, B, n, m in (("8192x128x128", 8192, 128, 128),
                           ("1000x90x200 varlen, internal pads", 1000, 90, 200),
                           ("64x40x300", 64, 40, 300), ("64x300x40", 64, 300, 40),
                           ("33x7x1", 33, 7, 1)):
        codes = {A: banded_pairs(frng, B, n, m, A) for A in (4, 20)}
        lens = {}
        if "varlen" in label:
            for A, (qh, th) in codes.items():
                qh[frng.random(qh.shape) < 0.02] = 4 if A == 4 else 24
                th[frng.random(th.shape) < 0.02] = 5 if A == 4 else 25
            lens = dict(lens_q=frng.integers(0, n + 1, B),
                        lens_t=frng.integers(0, m + 1, B))
        dev_codes = {A: (torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev))
                     for A, (qh, th) in codes.items()}
        for slabel, p in fixed_scorings:
            A = 4 if p.alphabet_size == 4 else 20
            qd, td = dev_codes[A]
            names = set()
            # W = 15 / 16: the two sides of the skewed tile's schedules at
            # n = m = 128 (K = 30 offsets a sweep)
            widths = (8, 15, 16, 32, 64, 96, 160) if B == 8192 else (8, 32, 160)
            for W in widths:
                want = ksb.sw_banded_plain(qd, td, p, W, **lens)
                for kern in fixed_kernels(p):
                    name = fixed_name(kern, p)
                    got = kern(qd, td, p, W, **lens)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    max_err[name] = max(max_err[name], err)
                    check(err == 0, f"{name} differs from its plain version on "
                          f"{label} {slabel} W={W}")
                    if W in (8, 32) and B in (8192, 1000):
                        qh, th = codes[A]
                        lens32 = {k: v[:32] for k, v in lens.items()}
                        check(torch.equal(got[:32].cpu(), ksb.banded_skew_mirror(
                            qh[:32], th[:32], p, W, profile=kern is ksb.sw_banded_profile,
                            **lens32)), f"{name} differs from its CPU mirror on {label}")
                    names.add(name)
                if B == 8192 and W == 32:
                    qh, th = codes[A]
                    check(np.array_equal(want[:64].cpu().numpy(),
                                         sw_banded_static_score_batch(qh[:64], th[:64],
                                                                      p, W)),
                          f"fixed band vs the oracle copy, {slabel}")
            print(f"{label} {slabel}: {', '.join(sorted(names))} at W = "
                  f"{', '.join(map(str, widths))}: max |kernel - plain| = 0"
                  + ("; 32 pairs equal the CPU mirror at W = 8, 32" if B in (8192, 1000)
                     else "")
                  + ("; 64 pairs equal the oracle copy at W = 32" if B == 8192
                     else ""), flush=True)
    del dev_codes, qd, td
    mark("per-round kernel")
    # the per-round kernel (rows 14-15) at W = 8, 32, 64, 96 and 128 against
    # its plain version in every field (score, max_round, n_rounds, and
    # below each pair's n_rounds the history, pos_y and offsets): related
    # DNA pairs (the reference's
    # generator) with per-pair lengths, 64 of them short queries against
    # long targets, whose bands run off the target's end; Gotoh with the
    # 8-bit history; ~70%-identity protein under BLOSUM62 11/1 at X = 120;
    # a non-homologous set at (1, 3, 2), X = 40, where bands die early; 8
    # pairs against the oracle copy
    xrng = np.random.default_rng(SEED + 8)
    B, L = 512, 256
    xq = xrng.integers(0, 4, size=(B, L), dtype=np.uint8)
    xt = np.stack([mutate(xrng, q, p_mismatch=0.1, p_insert=0.03, p_delete=0.03,
                          out_len=L) for q in xq])
    xnh = xrng.integers(0, 4, size=(B, L), dtype=np.uint8)
    xlq, xlt = xrng.integers(1, L + 1, B), xrng.integers(1, L + 1, B)
    xlq[:64] = xrng.integers(1, 40, 64)
    xpq = xrng.integers(0, 20, size=(B, L), dtype=np.uint8)
    xpt = xpq.copy()
    for b in range(B):
        idx = xrng.integers(0, L, L // 3)
        xpt[b, idx] = xrng.integers(0, 20, L // 3)
    xdev = {k: torch.from_numpy(v).to(dev) for k, v in
            (("q", xq), ("t", xt), ("nh", xnh), ("pq", xpq), ("pt", xpt))}
    xlens = dict(lens_q=xlq, lens_t=xlt)
    xdrop_modes = [
        ("DNA (1,1,1) X=70 varlen", "q", "t", dict(xlens)),
        ("DNA Gotoh 3/1 X=70, 8-bit history", "q", "t",
         dict(gap_open=3, gap_extend=1, compress_history=True)),
        ("protein BLOSUM62 11/1 X=120 varlen", "pq", "pt",
         dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120, **xlens)),
        ("non-homologous (1,3,2) X=40", "q", "nh",
         dict(mismatch=3, gap=2, x_threshold=40)),
        ("DNA Gotoh 3/1 varlen, scores only", "q", "t",
         dict(gap_open=3, gap_extend=1, with_history=False, **xlens)),
    ]

    def xdrop_fields(res):
        """The result's tensors on the card, the per-round ones (history,
        pos_y, offsets) zeroed at and past each pair's n_rounds: the kernel
        writes only below it."""
        out = [torch.as_tensor(x, device=dev) for x in (res.score, res.max_round,
                                                        res.n_rounds)]
        if res.pos_y is not None:
            live = (torch.arange(res.pos_y.shape[0], device=dev)[:, None]
                    < out[2][None, :])
            out += [torch.where(live[..., None], torch.as_tensor(res.band_history,
                                                                device=dev), 0)]
            out += [torch.where(live, torch.as_tensor(x, device=dev), 0)
                    for x in (res.pos_y, res.offsets) if x is not None]
        return tuple(out)

    def xdrop_name(W):
        return "banded_batch_w32_w64" if W in kbb.PACKED_WIDTHS else "banded_batch"

    rcap = (np.maximum(xlq, xlt) + 1) * 2 - 1
    for W in (8, 32, 64, 96, 128):
        ends = []
        # every set at the two timed widths; linear, Gotoh 8-bit and the
        # non-homologous set at the others
        for label, qk, tk, kw in (xdrop_modes if W in (32, 96) else
                                  [xdrop_modes[i] for i in (0, 1, 3)]):
            got = kbb.banded_batch(xdev[qk], xdev[tk], bandwidth=W, **kw)
            torch.cuda.synchronize()
            want = kbb.banded_batch_plain(xdev[qk], xdev[tk], bandwidth=W, device=dev,
                                          **kw)
            gf, wf = xdrop_fields(got), xdrop_fields(want)
            check(len(gf) == len(wf), f"per-round kernel fields, {label}")
            err = max_abs_err(gf, wf)
            max_err[xdrop_name(W)] = max(max_err[xdrop_name(W)], err)
            check(err == 0, f"{xdrop_name(W)} differs from its plain version on "
                  f"{label} at W={W}")
            nr = got.n_rounds.cpu().numpy()
            cap = rcap if "lens_q" in kw else np.full(B, 2 * L + 1)
            ends.append(f"{label}: {int((nr < cap).sum())} of {B} ended before "
                        f"the round cap, mean {nr.mean():.1f} rounds")
            if W == 32 and label.startswith("DNA (1,1,1)"):
                res = got.numpy()
                for b in range(8):
                    st = banded_xdrop(xq[b, : xlq[b]], xt[b, : xlt[b]], return_state=True)
                    nrb = st.n_rounds
                    check((st.score, st.n_rounds, st.max_round) == (
                        res.score[b], res.n_rounds[b], res.max_round[b])
                        and np.array_equal(st.band_history, res.band_history[:nrb, b])
                        and np.array_equal(st.pos_y, res.pos_y[:nrb, b]),
                        f"per-round kernel vs the oracle copy at pair {b}")
        print(f"W={W} ({xdrop_name(W)}): every field equals the plain version "
              "(per-round ones below n_rounds); " + "; ".join(ends), flush=True)
    print("per-round kernel at W = 32: 8 varlen DNA pairs equal the oracle copy "
          "(score, rounds, history, pos_y)", flush=True)
    del xdev
    torch.cuda.empty_cache()
    mark("block tier")
    # B9 (rows 11-12) against the plain loop, every field whole (history,
    # bases / deltas, past each pair's end too): the one-launch forward on
    # 300 pairs of 256 (260 related, 40 random), W = 16, 32, 64, 96 and 112
    # with K = 1 and 129 - W (and 32 at W = 64: bench_suite's), W = 48, 80
    # and 128 at K = 129 - W (each lane's slot count with phantom slots),
    # linear, Gotoh 3/1 at X = 30 (the random pairs' bands die early),
    # BLOSUM62 at X = 60 and per-pair lengths at X = 30 (pairs ending
    # inside a block, one of length 0); an all-dead start; the negative-gap
    # route (B10 and the per-block B9 under the host loop); B10 alone at
    # bases far outside the targets; both walkers' wires against their
    # plain versions
    brng = np.random.default_rng(SEED + 12)
    B, L = 300, 256
    bq = brng.integers(0, 4, size=(B, L), dtype=np.uint8)
    bt = np.stack([mutate(brng, q, out_len=L) for q in bq])
    bt[-40:] = brng.integers(0, 4, size=(40, L))
    bpq = brng.integers(0, 20, size=(B, L), dtype=np.uint8)
    bpt = bpq.copy()
    bpt[:, ::3] = brng.integers(0, 20, size=bpt[:, ::3].shape)
    blq, blt = brng.integers(0, L + 1, B), brng.integers(L // 2, L + 1, B)
    blq[:2] = (0, 7)
    bdev = {k: torch.from_numpy(v).to(dev) for k, v in
            (("q", bq), ("t", bt), ("pq", bpq), ("pt", bpt))}
    block_modes = [
        ("DNA (1,1,1)", "q", "t", dict()),
        ("DNA Gotoh 3/1 X=30", "q", "t", dict(gap_open=3, gap_extend=1, x_threshold=30)),
        ("protein BLOSUM62 X=60", "pq", "pt", dict(matrix=BLOSUM62, x_threshold=60)),
        ("DNA varlen X=30", "q", "t", dict(lens_q=blq, lens_t=blt, x_threshold=30)),
    ]

    def block_fields(res):
        """Every field of a block-tier result, whole."""
        return (res.score, res.end_y, res.end_j, res.n_rows, res.band_history,
                res.bases, res.deltas)

    def block_check(q, t, K, label, **kw):
        """The kernels against the plain loop on the card; returns the
        kernels' result."""
        kw = dict(kw, block=K, with_history=True, with_meta=True)
        got = kbk.banded_block_batch(q, t, **kw)
        torch.cuda.synchronize()
        want = kbk.banded_block_batch_plain(q, t, device=dev, **kw)
        err = max_abs_err(block_fields(got), block_fields(want))
        max_err["block_rows"] = max(max_err["block_rows"], err)
        check(err == 0, f"block tier differs from its plain version on {label}")
        return got

    for W in (16, 32, 48, 64, 80, 96, 112, 128):
        Ks = sorted({129 - W} | ({1, 32 if W == 64 else 1}
                                 if W in (16, 32, 64, 96, 112) else set()))
        for label, qk, tk, kw in block_modes:
            for K in Ks:
                res = block_check(bdev[qk], bdev[tk], K, f"{label} W={W} K={K}",
                                  width=W, **kw)
            nr = res.n_rows.cpu().numpy()
            full = blq if "lens_q" in kw else np.full(B, L)
            print(f"block tier W={W} K={Ks} {label}: every field equals the plain "
                  f"version; {int((nr < full).sum())} of {B} bands died early",
                  flush=True)
    zq, zt = torch.zeros((64, 96), dtype=torch.uint8, device=dev), torch.ones(
        (64, 96), dtype=torch.uint8, device=dev)
    res = block_check(zq, zt, 8, "an all-dead start", width=16, mismatch=5, gap=5,
                      x_threshold=1)
    check(int(res.end_y.abs().sum() + res.end_j.abs().sum() + res.score.abs().sum())
          == 0, "all-dead start: score 0 at (0, 0)")
    # the negative-gap route: B10 and the per-block B9 (the oracle's serial
    # chain) under the host loop, not the one-launch forward, on every
    # per-block instantiation: each register width (WR = 16, 32, 48, 64) and
    # the shared-memory form (W = 112), linear, per-pair lengths, BLOSUM62,
    # BLOSUM62 with lengths, Gotoh and Gotoh BLOSUM62, histories on and off
    # (64 pairs of 80: the plain loop's serial chain is a launch a slot)
    nrng = np.random.default_rng(SEED + 18)
    nb, nn = 64, 80
    nq = nrng.integers(0, 20, size=(nb, nn), dtype=np.uint8)
    nt = nq.copy()
    nt[:, ::4] = nrng.integers(0, 20, size=nt[:, ::4].shape)
    nt[-16:] = nrng.integers(0, 20, size=(16, nn))
    nlq, nlt = nrng.integers(0, nn + 1, nb), nrng.integers(nn // 2, nn + 1, nb)
    nlq[:2] = (0, 7)
    ndna = [torch.from_numpy(x % 4).to(dev) for x in (nq, nt)]
    nprot = [torch.from_numpy(x).to(dev) for x in (nq, nt)]
    lens = dict(lens_q=nlq, lens_t=nlt)
    neg_modes = [
        ("linear -1", ndna, dict(gap=-1, x_threshold=20)),
        ("linear -1 varlen", ndna, dict(gap=-1, x_threshold=20, **lens)),
        ("BLOSUM62 -1", nprot, dict(matrix=BLOSUM62, gap=-1, x_threshold=40)),
        ("BLOSUM62 -1 varlen", nprot, dict(matrix=BLOSUM62, gap=-1, x_threshold=40,
                                           **lens)),
        ("Gotoh 2/-1", ndna, dict(gap_open=2, gap_extend=-1, x_threshold=20)),
        ("Gotoh BLOSUM62 2/-1", nprot, dict(matrix=BLOSUM62, gap_open=2, gap_extend=-1,
                                            x_threshold=40)),
    ]
    n_neg = 0
    for W, K in ((16, 8), (32, 16), (48, 33), (64, 65), (112, 17)):
        for label, (q, t), kw in neg_modes:
            kw = dict(kw, width=W, block=K, with_meta=True)
            want = kbk.banded_block_batch_plain(q, t, device=dev, with_history=True, **kw)
            for hist in (True, False):
                before = (kbk.block_forward.launches, kbk.block_rows.launches,
                          kbk.block_gather.launches)
                got = kbk.banded_block_batch(q, t, with_history=hist, **kw)
                runs = (kbk.block_forward.launches - before[0],
                        kbk.block_rows.launches - before[1],
                        kbk.block_gather.launches - before[2])
                check(runs[0] == 0 and runs[1] == runs[2] > 0,
                      f"negative gaps take the per-block kernels: {runs}")
                pick = (lambda f: f) if hist else (lambda f: f[:4] + f[5:])  # noqa: E731
                err = max_abs_err(pick(block_fields(got)), pick(block_fields(want)))
                max_err["block_rows"] = max(max_err["block_rows"], err)
                check(err == 0 and (hist or got.band_history is None),
                      f"the per-block kernels differ from the plain loop on {label} W={W} "
                      f"K={K}, history {hist}")
                n_neg += 1
    print(f"block tier: negative gap penalties run B10 and the per-block B9 under the "
          f"host loop, equal to the plain loop on {n_neg} runs (W = 16, 32, 48, 64 in "
          f"registers, 112 in shared memory; linear, lengths, BLOSUM62, BLOSUM62 with "
          f"lengths, Gotoh, Gotoh BLOSUM62; histories on and off)", flush=True)
    t16 = bdev["t"].to(torch.int16).contiguous()
    gb = torch.from_numpy(brng.integers(-300, 600, B).astype(np.int32)).to(dev)
    for C in (1, 64, 127):
        err = max_abs_err(kbk.block_gather(t16, gb, C), kbk.block_gather_plain(t16, gb, C))
        max_err["block_gather"] = max(max_err["block_gather"], err)
        check(err == 0, f"block_gather differs from its plain version at C={C}")
    for label, qk, tk, kw in (block_modes[0], block_modes[2], block_modes[3]):
        run = kbk._setup(bdev[qk], bdev[tk], 1, 1, 1, 64, 32, kw.get("x_threshold", 70),
                         None, kw.get("matrix"), True, None, None, kw.get("lens_q"),
                         kw.get("lens_t"), dev)
        kbk._forward(run)
        want = kdw.block_walk_plain(run)
        # the map kernel through its wrapper, a pair and GROUP pairs a
        # producer CTA at the default chunk and at chunks of 3 rows, the
        # earlier serial kernel
        for wire in (kdw.block_walk(run), *(kdw.block_walk_launch_t(run, _chunk=C, _group=G)
                                            for C in (None, 3) for G in (1, kdw.GROUP)),
                     kdw._block_serial_launch_t(run)):
            err = max_abs_err(wire.cpu(), want)
            max_err["block_walk"] = max(max_err["block_walk"], err)
            check(err == 0, f"block_walk's wire differs from its plain version on {label}")
    for label, qk, tk, kw in (block_modes[0], block_modes[2]):
        kw = {k: v for k, v in kw.items() if k != "x_threshold"}
        X = 120 if "matrix" in kw else 70
        res = kbb.banded_batch(bdev[qk], bdev[tk], blq, blt, bandwidth=32,
                               x_threshold=X, compress_history=False, **kw)
        pad = _prep_padded(bdev[qk], bdev[tk], blq, blt, 32, dev, torch.int16)
        want = kdw.xdrop_walk_plain(res, pad, 32, X, **kw)
        pad32 = (*pad[:2], pad[2].int(), pad[3].int())
        launch = (pad32, 32, X, 1, 1, 1, ksb.banded_table(kw["matrix"], dev)
                  if "matrix" in kw else None)
        for wire in (kdw.xdrop_walk(res, pad, 32, X, **kw),
                     kdw.xdrop_walk_launch_t(res, *launch, _chunk=2),
                     kdw._xdrop_serial_launch_t(res, *launch)):
            err = max_abs_err(wire.cpu(), want)
            max_err["xdrop_walk"] = max(max_err["xdrop_walk"], err)
            check(err == 0, f"xdrop_walk's wire differs from its plain version on {label}")
    print("block tier: an all-dead start (score 0 at (0, 0)) and B10 alone at bases "
          "-300..600 equal the plain versions; block_walk (DNA, protein, varlen) and "
          "xdrop_walk (DNA varlen, protein X=120) write the plain versions' wires, at "
          "their default chunks and at chunks of 3 rows / 2 rounds (block_walk with 1 "
          f"and {kdw.GROUP} pairs a producer CTA), and so do the earlier serial "
          "kernels", flush=True)
    del bdev, zq, zt, t16
    torch.cuda.empty_cache()
    mark("strip tile (B13) vs the plain column-scan tile")
    srng = np.random.default_rng(SEED + 16)
    NEGB = kls.NEGB
    strip_scorings = [("(1,-1,1)", DNA_111),
                      ("Gotoh (2,-3,5,1)", ScoringParams(dna_matrix(2, -3), 5, 1)),
                      ("BLOSUM62 11/1", P_GOTOH),
                      ("4x4 matrix linear 2", ScoringParams.linear(DNA_GENERAL, 2))]

    def strip_pair(rng_, p, R, C, bounds):
        """Codes with in-length pads on both sides, and boundaries: random
        H, E and F (non-zero), or all -2^20."""
        letters = 20 if p.alphabet_size > 4 else 4
        q, t = rng_.integers(0, letters, R), rng_.integers(0, letters, C)
        q[rng_.random(R) < 0.02] = p.alphabet_size
        t[rng_.random(C) < 0.02] = p.alphabet_size + 1
        if bounds == "random":
            return q, t, (rng_.integers(-5, 60, C), rng_.integers(-40, 40, C),
                          rng_.integers(-5, 60, R), rng_.integers(-40, 40, R), 7)
        nc, nr = np.full(C, NEGB), np.full(R, NEGB)
        return q, t, (nc, nc, nr, nr, NEGB)

    def strip_run(q, t, b, p, device=dev):
        """B13 through its entry points (strip_tile / strip_tile_affine)."""
        top, topf, left, lefte, corner = b
        if p.is_linear:
            return kls.strip_tile(q, t, top, left, corner, p, device=device)
        return kls.strip_tile_affine(q, t, top, topf, left, lefte, corner, p,
                                     device=device)

    def strip_plain(q, t, b, p):
        """The plain column-scan tile, on the card."""
        table = torch.as_tensor(kls._extended_table(p), device=dev)
        top, topf, left, lefte, corner = b
        if p.is_linear:
            return kls._tile_colscan(q, t, top, left, corner, table, p.alphabet_size,
                                     p.gap)
        return kls._tile_colscan_affine(q, t, top, topf, left, lefte, corner, table,
                                        p.alphabet_size, p.gap_open, p.gap_extend)

    def strip_one_block(q, t, b, p):
        """The one-block B13 (the earlier schedule) on the same tile."""
        q8, t8 = kls.stage_codes(q, p, dev), kls.stage_codes(t, p, dev)
        top, topf, left, lefte, corner = b
        i32v = (lambda x: torch.as_tensor(np.asarray(x)).to(dev, torch.int32)  # noqa: E731
                .contiguous())
        lext = torch.cat([i32v([corner]), i32v(left)])
        lexte = torch.cat([i32v([NEGB]), i32v(lefte)]) if not p.is_linear else None
        return kls._one_block_launch_t(q8, t8, kp.profile_table(p, dev), i32v(top),
                                       None if p.is_linear else i32v(topf), lext, lexte,
                                       p)

    n_tiles = 0
    # the pipelined kernel through the entry points and the one-block
    # kernel, both against the plain tile; 8191 x 48, 16384 x 64 and 16383
    # x 33: the one-block kernel's 8 and 16 rows a thread, the last
    # thread's rows ragged in the third; the pipelined kernel's bands as
    # strip_plan picks them (printed)
    for R, C in ((1, 1), (7, 300), (1000, 64), (1499, 700), (4096, 4096),
                 (8191, 48), (16384, 64), (16383, 33)):
        for k, (label, p) in enumerate(strip_scorings):
            # the 4096 x 4096 tiles: one boundary kind a scoring, in turn
            kinds = (("random", "neg") if R * C < 1 << 22
                     else (("random", "neg")[k % 2],))
            for bounds in kinds:
                q, t, b = strip_pair(srng, p, R, C, bounds)
                want = strip_plain(q, t, b, p)
                err = max(max_abs_err(strip_run(q, t, b, p), want),
                          max_abs_err(strip_one_block(q, t, b, p), want))
                max_err["strip_tile"] = max(max_err["strip_tile"], err)
                check(err == 0, f"strip tile differs from the plain tile at {R} x {C}, "
                      f"{label}, {bounds} boundaries")
                n_tiles += 1
        print(f"strip tile {R} x {C}: rows a lane and bands {kls.strip_plan(R, C)}",
              flush=True)
    neg = ScoringParams.linear(dna_matrix(-1, -1), 1)  # no positive cell
    zq, zb = np.zeros(300, np.int64), (np.zeros(200), None, np.zeros(300), None, 0)
    got = strip_run(zq, zq[:200], zb, neg)
    err = max_abs_err(got, strip_plain(zq, zq[:200], zb, neg))
    check(err == 0 and [int(x) for x in got[2:]] == [0, 0, 0],
          "strip tile on an all-negative tile: best 0 at (0, 0)")
    print(f"strip tile: {n_tiles + 1} tiles (R x C from 1 x 1 to 4096 x 4096, 8191 x "
          "48, 16384 x 64 and 16383 x 33, a prime R, four scorings, non-zero and -2^20 "
          "boundaries, pads, an all-negative tile) equal the plain tile on every return, "
          "the pipelined and the one-block kernel alike", flush=True)
    mark("wavefront kernel (B14) vs its plain version and its schedule's mirror")
    G4W = ScoringParams.linear(np.arange(16).reshape(4, 4) % 5 - 2, 2)
    for label, p, B, n, m, letters, pairs, paired in (
            ("8192 x 128 x 128, (10,-30,15)", DNA_10_30_15, 8192, 128, 128, 4, None, None),
            ("300 x 100 x 150, (1,-1,1)", DNA_111, 300, 100, 150, 4, None, None),
            ("1024 x 128 x 128, protein BLOSUM62 11", P_LIN, 1024, 128, 128, 20, None, None),
            ("2500 x 128 x 128, protein BLOSUM62 11", P_LIN, 2500, 128, 128, 20, None, None),
            # pairs a stream forced: ragged last streams, one and many pairs
            # a stream, targets shorter than 4, both tables, and DNA on the
            # table by columns (the form protein takes)
            ("1001 x 128 x 128, (10,-30,15), P 4", DNA_10_30_15, 1001, 128, 128, 4, 4, None),
            ("1001 x 128 x 128, (10,-30,15), P 4, by columns", DNA_10_30_15, 1001, 128, 128,
             4, 4, False),
            ("999 x 128 x 3, (1,-1,1), P 16", DNA_111, 999, 128, 3, 4, 16, None),
            ("301 x 128 x 2, BLOSUM62 11, P 3", P_LIN, 301, 128, 2, 20, 3, None),
            ("130 x 60 x 130, 4 x 4 matrix, P 3", G4W, 130, 60, 130, 4, 3, None),
            ("77 x 128 x 1, BLOSUM62 11, P 1", P_LIN, 77, 128, 1, 20, 1, None),
            ("515 x 100 x 33, (1,-1,1), P 1", DNA_111, 515, 100, 33, 4, 1, None),
            ("64 x 128 x 300, BLOSUM62 11, P 7", P_LIN, 64, 128, 300, 20, 7, None)):
        qs = srng.integers(0, letters, (B, n)).astype(np.uint8)
        ts = srng.integers(0, letters, (B, m)).astype(np.uint8)
        qs[:, n - 5:] = p.alphabet_size  # tail pads
        ts[srng.random(ts.shape) < 0.02] = p.alphabet_size + 1  # internal pads
        qd, td = torch.from_numpy(qs).to(dev), torch.from_numpy(ts).to(dev)
        if pairs is None:
            got = kwf.sw_wavefront(qd, td, p)
            pairs = kwf.wavefront_stream(B, n, m, n_sm, p.alphabet_size)
        else:
            got = kwf.wavefront_launch_t(qd, td, kwf.wavefront_table(p, dev), p, pairs,
                                         paired)
        err = max(max_abs_err(got, kwf.sw_wavefront_plain(qd, td, p)),
                  max_abs_err(got, kwf.wavefront_stream_mirror(qd, td, p, pairs)))
        max_err["sw_wavefront"] = max(max_err["sw_wavefront"], err)
        check(err == 0, f"sw_wavefront differs from its plain version or mirror on {label}")
        print(f"sw_wavefront on {label} ({pairs} pairs a stream; tail and internal pads): "
              "equal to its plain version and its mirror", flush=True)
    del qd, td, zq

    # DNA main path: counts from here to the end of phase 6 ----------------
    zero_launches(DNA_PATH)

    # 4. DNA main path, scores ---------------------------------------------
    phase("4 DNA main path, scores: best_engine at 1,048,576 x (128x128)")
    B, n, m = 1 << 20, 128, 128
    qh, th = random_codes(rng, (B, n)), random_codes(rng, (B, m))
    qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
    for p, batch_oracle in ((DNA_10_30_15, sw_score_batch),
                            (AFF, sw_affine_score_batch)):
        fn = best_engine(p)
        scores = fn(qd, td)
        torch.cuda.synchronize()
        check(scores.shape == (B,) and scores.dtype == torch.int32
              and scores.device.type == "cuda", "best_engine output")
        # the first CHECK_PAIRS scores against the plain version, on the card
        name = "sw_batch" if p.is_linear else "sw_affine"
        t0 = time.perf_counter()
        err = max_abs_err(scores[:CHECK_PAIRS], kernel_fns[name][1](
            qd[:CHECK_PAIRS], td[:CHECK_PAIRS], p))
        max_err[name] = max(max_err[name], err)
        print(f"best_engine gap=({p.gap_open},{p.gap_extend}) vs {name}'s "
              f"plain version over the first {CHECK_PAIRS} pairs: max |kernel - "
              f"plain| = {err} ({time.perf_counter() - t0:.1f} s)", flush=True)
        check(err == 0, f"{name} differs from its plain version at 1M pairs")
        torch.cuda.empty_cache()
        s_host = scores.cpu().numpy()
        check(s_host.min() >= 0 and s_host.max() <= 10 * n, "score range")
        idx = rng.choice(B, 64, replace=False)
        check(np.array_equal(s_host[idx], batch_oracle(qh[idx], th[idx], p)),
              "best_engine vs oracle on 64 random pairs")
        sec = timed(fn, (qd, td), iters=10)
        cells = B * n * m
        print(f"best_engine gap=({p.gap_open},{p.gap_extend}): "
              f"{sec * 1e3:.3f} ms per call, {cells / sec / 1e9:.1f} GCUPS, "
              f"{1e6 / B * sec * 1e3:.3f} ms per 1M alignments, mean score "
              f"{s_host.mean():.3f} [{smi}]", flush=True)
        # the endpoints of the same pairs (the traceback's first half at
        # this scale), the first 16,384 held
        ends = best_ends_engine(p)(qd, td)
        name = name + "_ends"
        err = max_abs_err(tuple(x[:CHECK_PAIRS // 4] for x in ends), kernel_fns[name][1](
            qd[:CHECK_PAIRS // 4], td[:CHECK_PAIRS // 4], p))
        max_err[name] = max(max_err[name], err)
        check(err == 0 and torch.equal(ends[0], scores),
              f"{name} differs from its plain version at 1M pairs")
        ends_s = timed(best_ends_engine(p), (qd, td), iters=10)
        print(f"best_ends_engine gap=({p.gap_open},{p.gap_extend}): {ends_s * 1e3:.3f} ms "
              f"per call; scores equal best_engine's, the first {CHECK_PAIRS // 4} ends the "
              "plain version", flush=True)
        del ends
        # the launch alone on the [B, L] codes as given (the wrappers
        # transpose nothing), beside its bound by pipe; the endpoint's
        # select tracker on the same inputs
        mm = kb._uniform_match_mismatch(p)
        for ends_ in (False, True):
            name = ("sw_batch" if p.is_linear else "sw_affine") + ("_ends" if ends_ else "")
            alone = timed(kb.rowscan_launch_t, (qd, td, p, *mm, not p.is_linear, ends_),
                          iters=5) * 1e3
            bound = cells * pipe_slots(name) / int32_rate * 1e3
            sel = ""
            if ends_:
                sel_ms = timed(lambda: kb.rowscan_launch_t(qd, td, p, *mm, not p.is_linear,
                                                           True, select=True), (), iters=5)
                sel = f"; the select tracker {sel_ms * 1e3:.3f} ms"
            print(f"  {name} launch alone at 1M pairs {alone:.3f} ms, bound by pipe "
                  f"{bound:.3f} ms ({bound / alone:.1%}; {KERNELS[name][3]} ops a cell, "
                  f"{ALU_OPS[name]} on the ALU), {alone - bound:.3f} ms lost a launch{sel}",
                  flush=True)
    del qd, td, qh, th, scores
    torch.cuda.empty_cache()

    # 5. DNA main path, traceback ------------------------------------------
    phase("5 DNA main path, traceback: sw_align_batch on 64 related pairs")

    def traceback_phase(qs, ts, plist, names_of, alphabet, seq_of, numpy_too=False):
        qs_d, ts_d = torch.from_numpy(qs).to(dev), torch.from_numpy(ts).to(dev)
        L = qs.shape[1]
        for p in plist:
            ends_fn = best_ends_engine(p)
            got = ends_fn(qs, ts)
            name = names_of(p)
            err = max_abs_err(got, kernel_fns[name][1](qs_d, ts_d, p))
            max_err[name] = max(max_err[name], err)
            check(err == 0, f"{name} differs from its plain version on {len(qs)} pairs")
            sc, ei, ej = (x.cpu().numpy() for x in got)
            ends_s = timed(ends_fn, (qs_d, ts_d))
            t0 = time.perf_counter()
            res = sw_align_batch(qs, ts, p)
            walk_s = time.perf_counter() - t0
            np_note = ""
            if numpy_too:  # the same call with the numpy walkers, off the path
                with off_path(), numpy_walkers():
                    t0 = time.perf_counter()
                    check(sw_align_batch(qs, ts, p) == res, "C++ vs numpy walks")
                    np_note = (f"; with the numpy walkers {time.perf_counter() - t0:.2f} s, "
                               "the same paths")
            n_mapped = 0
            for b, (score, path) in enumerate(res):
                check(score == sc[b], f"score of pair {b}")
                if score == 0:
                    continue
                n_mapped += 1
                check(path[-1] == (ei[b], ej[b]), f"endpoint of pair {b}")
                check(rescore(path, qs[b], ts[b], p) == score, f"rescore of pair {b}")
                cig = path_to_cigar(path, qs[b], ts[b], query_len=L)
                st = cigar_stats(cig)
                check(st["query_consumed"] == L, f"CIGAR query length, pair {b}")
                check(st["target_consumed"] == path[-1][1] - path[0][1],
                      f"CIGAR target length, pair {b}")
                rec = sam_record(f"q{b}", f"t{b}", qs[b], ts[b], score, path,
                                 alphabet, query_len=L).split("\t")
                check(len(rec) == 13 and rec[5] == cig and rec[9] == seq_of(qs[b])
                      and rec[11] == f"AS:i:{score}", f"SAM record, pair {b}")
            check(n_mapped * 32 > len(qs) * 25,
                  f"only {n_mapped} of {len(qs)} related pairs aligned")
            print(f"gap=({p.gap_open},{p.gap_extend}): device ends "
                  f"{ends_s * 1e3:.4f} ms, equal to {name}'s plain version; "
                  f"sw_align_batch {walk_s:.2f} s wall (C++ host walk{np_note}), "
                  f"{n_mapped} aligned, mean score {float(np.mean([r[0] for r in res])):.2f}; "
                  f"endpoints, rescoring, CIGAR and SAM checked", flush=True)

    qs, ts = related_pairs(rng, 64, 128)
    traceback_phase(
        qs, ts, (DNA_10_30_15, AFF),
        lambda p: "sw_batch_ends" if p.is_linear else "sw_affine_ends", "dna",
        lambda q: "".join("ACGT"[c] for c in q), numpy_too=True,
    )

    # 6. DNA CLI -----------------------------------------------------------
    phase("6 DNA CLI: swtpu_torch align")
    base = ["align", "--random", "64x128x128", "--scoring", "10,-30"]
    lines = run_cli(cli_main, base + ["--gap", "15", "--cigar"])
    recs = [json.loads(x) for x in lines]
    rs = np.random.default_rng(SEED)  # the CLI's --random inputs
    cq = rs.integers(0, 4, size=(64, 128)).astype(np.uint8)
    ct = rs.integers(0, 4, size=(64, 128)).astype(np.uint8)
    want = sw_score_batch(cq, ct, DNA_10_30_15)
    check(len(recs) == 64 and [r["pair"] for r in recs] == [f"pair{i}" for i in range(64)],
          "CLI --cigar records")
    check([r["score"] for r in recs] == want.tolist(), "CLI --cigar scores")
    check(all(cigar_stats(r["cigar"])["query_consumed"] == 128 for r in recs),
          "CLI CIGAR lengths")
    print(f"align --cigar: 64 records, scores equal the oracle; first: {lines[0]}",
          flush=True)
    recs = [json.loads(x) for x in run_cli(cli_main, base + ["--gap", "15"])]
    check([r["score"] for r in recs] == want.tolist(), "CLI score-only")
    lines = run_cli(cli_main, base + ["--gap-open", "40", "--gap-extend", "15", "--sam"])
    body = [x for x in lines if not x.startswith("@")]
    want = sw_affine_score_batch(cq, ct, AFF)
    check(len(body) == 64 and all(
        (x.split("\t")[11] == f"AS:i:{w}") if w else x.split("\t")[1] == "4"
        for x, w in zip(body, want)), "CLI affine --sam")
    print("align score-only and affine --sam: outputs equal the oracle", flush=True)

    launch_counts = {name: launches(name) for name in DNA_PATH}
    print(f"DNA main-path launches: {launch_counts}", flush=True)
    check(all(v > 0 for v in launch_counts.values()),
          f"a kernel was not launched on the DNA main path: {launch_counts}")

    # protein main path: counts from here to the end of phase 10 -----------
    zero_launches(PROTEIN_PATH)

    # 7. protein main path, scores -----------------------------------------
    phase("7 protein main path, scores: best_engine at 1,048,576 x (128x128)")
    B, n, m, chunk = 1 << 20, 128, 128, 1 << 15
    prng = np.random.default_rng(SEED)
    qh, th = random_protein(prng, (B, n)), random_protein(prng, (B, m))
    qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
    for p, batch_oracle in ((P_LIN, sw_score_batch), (P_GOTOH, sw_affine_score_batch)):
        fn = best_engine(p)
        scores = fn(qd, td)
        torch.cuda.synchronize()
        check(scores.shape == (B,) and scores.dtype == torch.int32
              and scores.device.type == "cuda", "best_engine output (protein)")
        name = profile_name(False, p)
        t0 = time.perf_counter()
        # the plain tier's [B, n + 1, 32] int32 profile is 17 GB at 1M
        # pairs: compare in chunks
        err = 0
        for lo in range(0, CHECK_PAIRS, chunk):
            err = max(err, max_abs_err(
                scores[lo:lo + chunk],
                kp.sw_profile_plain(qd[lo:lo + chunk], td[lo:lo + chunk], p)))
        max_err[name] = max(max_err[name], err)
        torch.cuda.empty_cache()
        print(f"best_engine BLOSUM62 gap=({p.gap_open},{p.gap_extend}) vs "
              f"{name}'s plain version over the first {CHECK_PAIRS} pairs: max "
              f"|kernel - plain| = {err} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        check(err == 0, f"{name} differs from its plain version at 1M protein pairs")
        s_host = scores.cpu().numpy()
        check(s_host.min() >= 0 and s_host.max() <= 11 * n, "protein score range")
        idx = rng.choice(B, 64, replace=False)
        check(np.array_equal(s_host[idx], batch_oracle(qh[idx], th[idx], p)),
              "protein best_engine vs oracle on 64 random pairs")
        sec = timed(fn, (qd, td), iters=10)
        cells = B * n * m
        print(f"best_engine BLOSUM62 gap=({p.gap_open},{p.gap_extend}): "
              f"{sec * 1e3:.3f} ms per call, {cells / sec / 1e9:.1f} GCUPS, "
              f"mean score {s_host.mean():.3f} [{smi}]", flush=True)
        # the endpoints of the same pairs (the traceback's first half at
        # this scale: the thread form's ends), the first 16,384 held
        ends = best_ends_engine(p)(qd, td)
        name = profile_name(True, p)
        err = max(max_abs_err(tuple(x[lo:lo + chunk // 2] for x in ends),
                              kp.sw_profile_ends_plain(qd[lo:lo + chunk // 2],
                                                       td[lo:lo + chunk // 2], p))
                  for lo in (0, chunk // 2))
        max_err[name] = max(max_err[name], err)
        check(err == 0 and torch.equal(ends[0], scores),
              f"{name} differs from its plain version at 1M protein pairs")
        ends_s = timed(best_ends_engine(p), (qd, td), iters=5)
        print(f"best_ends_engine BLOSUM62 gap=({p.gap_open},{p.gap_extend}): "
              f"{ends_s * 1e3:.3f} ms per call; scores equal best_engine's, the first "
              f"{chunk} ends the plain version", flush=True)
        del ends
        # the thread form's launch alone at this shape, beside its bound by
        # pipe (and by its lookups); the endpoint's select tracker
        table = kp.profile_table(p, dev)
        for ends_ in (False, True):
            name = profile_name(ends_, p)
            alone = timed(kp.profile_launch_t, (qd, td, table, p, ends_), iters=5) * 1e3
            bound = max(cells * pipe_slots(name) / int32_rate,
                        cells * KERNELS[name][4] / lookup_rate) * 1e3
            sel = ""
            if ends_:
                sel_ms = timed(lambda: kp.profile_launch_t(qd, td, table, p, True,
                                                           select=True), (), iters=5)
                sel = f"; the select tracker {sel_ms * 1e3:.3f} ms"
            print(f"  {name} launch alone at 1M pairs {alone:.3f} ms, bound by pipe "
                  f"{bound:.3f} ms ({bound / alone:.1%}; {KERNELS[name][3]} ops a cell, "
                  f"{ALU_OPS[name]} on the ALU, one lookup), {alone - bound:.3f} ms lost a "
                  f"launch{sel}", flush=True)
    del qd, td, qh, th, scores
    torch.cuda.empty_cache()

    # 8. protein main path, BASELINE config 3 ------------------------------
    phase("8 protein main path, BASELINE config 3: 64 queries x 256 "
          "SwissProt-like targets")
    _, db, lens = load_fasta_batch(str(SWISSPROT), "protein", pad_to=16,
                                   pad_code=25)
    nq, Lq = 64, 120
    cq = config3_queries(db, lens, nq, Lq)  # the JAX bench's own draws
    nt = len(db)
    qq = np.broadcast_to(cq[:, None, :], (nq, nt, Lq)).reshape(-1, Lq)
    tt = np.broadcast_to(db[None], (nq, nt, db.shape[1])).reshape(-1, db.shape[1])
    real_cells = int(nq * lens.sum() * Lq)
    tl = np.broadcast_to(lens[None], (nq, nt)).reshape(-1)
    order = np.argsort(tl, kind="stable")
    nb = 6
    splits = [len(order) * i // nb for i in range(nb + 1)]
    bucket_idx = [order[lo:hi] for lo, hi in zip(splits[:-1], splits[1:])]
    buckets = []
    for idxs in bucket_idx:
        bm = int(-(-int(tl[idxs].max()) // 16) * 16)
        buckets.append((torch.from_numpy(np.ascontiguousarray(qq[idxs])).to(dev),
                        torch.from_numpy(np.ascontiguousarray(tt[idxs, :bm])).to(dev)))
    print(f"{nq} x {nt} = {nq * nt} pairs, target lengths {int(lens.min())}-"
          f"{int(lens.max())} (mean {lens.mean():.1f}), buckets of widths "
          f"{[int(b[1].shape[1]) for b in buckets]}; {real_cells} real cells",
          flush=True)
    bucket_cells = [int(tl[idxs].sum()) * Lq for idxs in bucket_idx]
    check(all(warp_form(dq.shape[0], Lq, dt.shape[1]) for dq, dt in buckets),
          "config 3's buckets go to the warp form")
    for p, oracle in ((P_LIN, sw_score_batch), (P_GOTOH, sw_affine_score_batch)):
        fn = best_engine(p)
        got = np.zeros(nq * nt, np.int32)
        err = 0
        name = profile_name(False, p, warp=True)
        before = launches(name)
        for idxs, (dq, dt) in zip(bucket_idx, buckets):
            s = fn(dq, dt)
            with off_path():
                err = max(err, max_abs_err(s, kp.sw_profile_plain(dq, dt, p)))
            got[idxs] = s.cpu().numpy()
        check(launches(name) == before + nb, f"config 3 runs {name} a bucket")
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{name} differs from its plain version on config 3")
        want = np.array([int(oracle(qq[k: k + 1], tt[k: k + 1, : lens[k % nt]], p)[0])
                         for k in range(32)], np.int32)
        check(np.array_equal(got[:32], want), "config 3: first 32 pairs vs oracle")

        def run_all(fn=fn):
            return [fn(dq, dt) for dq, dt in buckets]

        sec = timed(run_all, (), iters=5)
        print(f"config 3 BLOSUM62 gap=({p.gap_open},{p.gap_extend}): all "
              f"{nb} buckets {sec * 1e3:.3f} ms wall, {real_cells / sec / 1e9:.1f} "
              f"GCUPS over the real cells; every score equals the plain version, "
              f"the first 32 the oracle; mean score {got.mean():.2f} [{smi}]",
              flush=True)
        # each bucket's launch alone (the warp form), beside the thread form
        # on the same bucket, and the bound over its real cells
        table = kp.profile_table(p, dev)
        ops, lookups = KERNELS[name][3:5]
        tot = [0.0, 0.0, 0.0]
        for k, (dq, dt) in enumerate(buckets):
            alone = timed(kp.profile_warp_launch_t, (dq, dt, table, p, False),
                          iters=10) * 1e3
            thread = timed(kp.profile_launch_t, (dq, dt, table, p, False), iters=5) * 1e3
            bound = max(bucket_cells[k] * pipe_slots(name) / int32_rate,
                        bucket_cells[k] * lookups / lookup_rate) * 1e3
            tot = [tot[0] + alone, tot[1] + thread, tot[2] + bound]
            print(f"  bucket {k}: {dq.shape[0]} pairs of {Lq} x {dt.shape[1]} "
                  f"({bucket_cells[k]} real cells): warp form alone {alone:.4f} ms, "
                  f"thread form {thread:.4f} ms, bound {bound:.4f} ms ({ops} int32 ops "
                  f"a cell, {ALU_OPS[name]} on the ALU, by pipe), {bound / alone:.1%} of it",
                  flush=True)
        print(f"  the 6 buckets: warp form alone {tot[0]:.4f} ms, thread form "
              f"{tot[1]:.4f} ms, bound {tot[2]:.4f} ms ({tot[2] / tot[0]:.1%})", flush=True)
    # the warp form's four instantiations on the widest bucket: wrapper,
    # launch alone, plain version, bound (the kernels line's rows)
    dq, dt = buckets[-1]
    idxs = bucket_idx[-1]
    wide_cells = bucket_cells[-1]
    for p in (P_LIN, P_GOTOH):
        table = kp.profile_table(p, dev)
        for ends, kern, plain in ((False, kp.sw_profile, kp.sw_profile_plain),
                                  (True, kp.sw_profile_ends, kp.sw_profile_ends_plain)):
            name = profile_name(ends, p, warp=True)
            lookups = KERNELS[name][4]
            with off_path():
                t0 = time.perf_counter()
                want = plain(dq, dt, p)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                err = max_abs_err(kern(dq, dt, p), want)
            max_err[name] = max(max_err[name], err)
            check(err == 0, f"{name} differs from its plain version on the widest bucket")
            ms = timed(kern, (dq, dt, p), iters=10) * 1e3
            alone = timed(kp.profile_warp_launch_t, (dq, dt, table, p, ends), iters=10) * 1e3
            bound = max(wide_cells * pipe_slots(name) / int32_rate,
                        wide_cells * lookups / lookup_rate,
                        (dq.numel() + dt.numel() + 4 * table.numel()
                         + 4 * dq.shape[0] * (3 if ends else 1)) / HBM_BYTES_PER_S) * 1e3
            rows.append(dict(
                name=name, route="cuda", source=f"swtpu_torch/csrc/{PROFILE}",
                replaces=KERNELS[name][2], launches=None, max_abs_err=max_err[name],
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="operations",
                library_ms=None, kernel_ms=alone))
            print(f"{name}, widest bucket ({dq.shape[0]} x {Lq} x {dt.shape[1]}, "
                  f"{wide_cells} real cells): wrapper {ms:.4f} ms, launch alone "
                  f"{alone:.4f} ms, plain {plain_ms:.1f} ms (equal), bound {bound:.4f} ms "
                  f"({bound / alone:.1%})", flush=True)
    del buckets, dq, dt
    torch.cuda.empty_cache()

    # 9. protein main path, traceback --------------------------------------
    phase("9 protein main path, traceback: sw_align_batch on 64 related "
          "protein pairs")
    qs, ts = related_pairs(rng, 64, 128, letters=20)
    traceback_phase(qs, ts, (P_GOTOH, P_LIN),
                    lambda p: profile_name(True, p), "protein", decode_protein,
                    numpy_too=True)

    # 10. protein CLI ------------------------------------------------------
    phase("10 protein CLI: swtpu_torch align --alphabet protein")
    base = ["align", "--alphabet", "protein", "--random", "64x128x128"]
    rs = np.random.default_rng(SEED)  # the CLI's --random inputs
    cq = rs.integers(0, 20, size=(64, 128)).astype(np.uint8)
    ct = rs.integers(0, 20, size=(64, 128)).astype(np.uint8)
    want = sw_score_batch(cq, ct, P_LIN)
    recs = [json.loads(x) for x in run_cli(cli_main, base + ["--gap", "11", "--cigar"])]
    check([r["score"] for r in recs] == want.tolist(), "protein CLI --cigar scores")
    check(all(cigar_stats(r["cigar"])["query_consumed"] == 128 for r in recs
              if r["score"]), "protein CLI CIGAR lengths")
    recs = [json.loads(x) for x in run_cli(cli_main, base + ["--gap", "11"])]
    check([r["score"] for r in recs] == want.tolist(), "protein CLI score-only")
    lines = run_cli(cli_main, base + ["--gap-open", "11", "--gap-extend", "1", "--sam"])
    body = [x.split("\t") for x in lines if not x.startswith("@")]
    want = sw_affine_score_batch(cq, ct, P_GOTOH)
    check(len(body) == 64 and all(
        ((r[11] == f"AS:i:{w}") if w else r[1] == "4") and r[9] == decode_protein(q)
        for r, w, q in zip(body, want, cq)), "protein CLI Gotoh --sam")
    print("align --alphabet protein --cigar, score-only and Gotoh --sam: "
          "outputs equal the oracle", flush=True)

    launch_counts.update({name: launches(name) for name in PROTEIN_PATH})
    print(f"protein main-path launches: "
          f"{ {k: launch_counts[k] for k in PROTEIN_PATH} }", flush=True)
    check(all(launch_counts[k] > 0 for k in PROTEIN_PATH),
          f"a kernel was not launched on the protein main path: {launch_counts}")

    # config-4 path: counts from here to the end of phase 15 ---------------
    zero_launches(CONFIG4_PATH)

    # 11. config 4, varlen scores ------------------------------------------
    phase("11 BASELINE config 4, varlen scores: 32,768 reads of 100-300 bp x "
          "320-bp windows on the 2-bit wire, DNA (1, -1, 1)")
    B4, N4, M4 = 32768, 300, 320
    sets = [read_set(s, B4, M4) for s in (SEED, SEED + 1, SEED + 2)]
    with off_path():  # a warm-up, not the path's own call
        sw_scores_varlen(sets[0][0], sets[0][1], DNA_111, sets[0][2], packed=True)
    walls, results = [], []
    for qs_p, ts_p, lens in sets[1:]:  # distinct data per timed call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(sw_scores_varlen(qs_p, ts_p, DNA_111, lens, packed=True))
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    cells = int(sets[-1][2].sum()) * M4
    print(f"sw_scores_varlen(packed=True), {B4} reads: wall {wall * 1e3:.3f} ms "
          f"(min of {[round(w * 1e3, 3) for w in walls]}), {cells / wall / 1e9:.1f} "
          f"GCUPS over the {cells} real cells, {B4 / wall:.0f} alignments/s "
          f"[{smi}]", flush=True)
    # stream_chunks=4: four chunks, each uploaded and run in turn
    with off_path():  # a warm-up (the chunk shapes), not the path's own call
        sw_scores_varlen(*sets[0][:2], DNA_111, sets[0][2], packed=True,
                         stream_chunks=4)
    chunk_walls = []
    for (qs_p, ts_p, lens), want in zip(sets[1:], results):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sw_scores_varlen(qs_p, ts_p, DNA_111, lens, packed=True,
                               stream_chunks=4)
        chunk_walls.append(time.perf_counter() - t0)
        check(np.array_equal(got, want), "stream_chunks=4: scores differ")
    print(f"stream_chunks=4: wall {min(chunk_walls) * 1e3:.3f} ms (min of "
          f"{[round(w * 1e3, 3) for w in chunk_walls]}), scores equal; one "
          f"chunk {wall * 1e3:.3f} ms", flush=True)
    floors = []
    for qs_p, ts_p, _ in sets[1:]:  # the same bytes, fresh copies
        qf, tf = qs_p.copy(), ts_p.copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(qf).to(dev), torch.from_numpy(tf).to(dev)
        torch.cuda.synchronize()
        floors.append(time.perf_counter() - t0)
    fetched = torch.zeros(B4, dtype=torch.int32, device=dev)
    fetched.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fetched.cpu()
    t_fetch = time.perf_counter() - t0
    floor = min(floors) + t_fetch
    wire_bytes = sets[1][0].nbytes + sets[1][1].nbytes
    print(f"wire floor: upload of the same {wire_bytes} bytes {min(floors) * 1e3:.3f} "
          f"ms + one fetch {t_fetch * 1e3:.3f} ms = {floor * 1e3:.3f} ms; wall / "
          f"floor = {wall / floor:.2f}", flush=True)
    # the fused unit (decode, pads, kernel) on pre-staged device tensors
    saved = snapshot()
    engine, ekey = resolve_engine(DNA_111, None, dev)
    fused = _fused_masked_engine(engine, ekey, N4, M4, 4, 5, packed=True)
    qs_p, ts_p, lens = sets[-1]
    dq, dt = torch.from_numpy(qs_p).to(dev), torch.from_numpy(ts_p).to(dev)
    lq_d = torch.from_numpy(lens.astype(np.int32)).to(dev)
    lt_d = torch.full((B4,), M4, dtype=torch.int32, device=dev)
    check(np.array_equal(fused(dq, dt, lq_d, lt_d).cpu().numpy(), results[-1]),
          "the fused unit on device tensors vs sw_scores_varlen")
    per = timed(lambda a, b: fused(a, b, lq_d, lt_d), (dq, dt), iters=10)
    print(f"fused decode + pads + kernel on device tensors: {per * 1e3:.4f} ms, "
          f"{cells / per / 1e9:.1f} GCUPS, {B4 / per:.0f} alignments/s", flush=True)
    # where that time goes: the decode and pads alone (the same unit with
    # an engine that returns its inputs) and the launch on the decoded
    # [B, L] codes (the wrapper transposes nothing)
    decode = _fused_masked_engine(lambda q, t: (q, t), "decode and pads only",
                                  N4, M4, 4, 5, packed=True)
    qm_d, tm_d = decode(dq, dt, lq_d, lt_d)
    parts = {
        "decode + pads": timed(lambda a, b: decode(a, b, lq_d, lt_d),
                               (dq, dt), iters=10),
        "sw_batch launch alone": timed(
            lambda: kb.rowscan_launch_t(qm_d, tm_d, DNA_111, 1, -1, False, False), (),
            iters=10),
    }
    # the same launch on a quarter of the pairs, whose scratch fits in L2
    qm4, tm4 = qm_d[:B4 // 4].contiguous(), tm_d[:B4 // 4].contiguous()
    quarter = timed(
        lambda: kb.rowscan_launch_t(qm4, tm4, DNA_111, 1, -1, False, False), (),
        iters=10)
    print("of which " + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in parts.items())
          + f"; the launch runs {B4 * N4 * M4 / parts['sw_batch launch alone'] / 1e9:.1f} "
          f"GCUPS over the {B4 * N4 * M4} padded cells, with a "
          f"{4 * M4 * B4 / 1e6:.1f} MB hand-off scratch (L2: 50 MB); on "
          f"the first {B4 // 4} pairs ({M4 * B4 / 1e6:.1f} MB scratch) "
          f"{quarter * 1e3:.4f} ms, {B4 * N4 * M4 / 4 / quarter / 1e9:.1f} GCUPS",
          flush=True)
    del qm_d, tm_d, qm4, tm4
    # every score against the plain version on the unpacked, masked codes
    for (qs_p, ts_p, lens), got in zip(sets[1:], results):
        qm = np.where(np.arange(N4)[None, :] < lens[:, None],
                      unpack_2bit(qs_p)[:, :N4], 4).astype(np.uint8)
        tm = unpack_2bit(ts_p)
        want = kb.sw_batch_plain(torch.from_numpy(qm).to(dev),
                                 torch.from_numpy(tm).to(dev), DNA_111)
        err = int(np.abs(got.astype(np.int64) - want.cpu().numpy()).max())
        max_err["sw_batch"] = max(max_err["sw_batch"], err)
        check(err == 0, "config 4 varlen scores differ from the plain version")
    check([int(x) for x in got[:32]] == [
        sw_score(qm[k, :lens[k]], tm[k], DNA_111) for k in range(32)],
        "config 4 varlen scores vs the oracle on 32 reads")
    print(f"every score of both timed sets equals the plain version; 32 equal "
          f"the oracle; mean score {got.mean():.3f}", flush=True)
    restore(saved)
    del dq, dt, lq_d, lt_d
    check(kb.sw_batch.launches > 0, "sw_scores_varlen launched no sw_batch")

    # 12. config 4, promotion ----------------------------------------------
    phase("12 BASELINE config 4, promotion: 32,768 pairs of 300 x 320, 1/8 "
          "homologous, bf16 tier + int32 re-run")
    with off_path():  # a warm-up, not the path's own call
        promote.sw_scores_promoted_device(prom_warm, prom_t, DNA_111)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, promoted = promote.sw_scores_promoted_device(prom_q, prom_t, DNA_111)
    wall = time.perf_counter() - t0
    frac = float(promoted.mean())
    check(0 < frac < 1, f"promoted fraction {frac}")
    print(f"sw_scores_promoted_device, {B4} pairs: wall {wall * 1e3:.3f} ms, "
          f"promoted_frac {frac:.4f} ({int(promoted.sum())} pairs), "
          f"{B4 / wall:.0f} alignments/s [{smi}]", flush=True)
    check(kbf.sw_bf16.launches > 0,
          "sw_scores_promoted_device launched no sw_bf16")
    saved = snapshot()
    qd = torch.from_numpy(prom_q).to(dev)
    td = torch.from_numpy(prom_t).to(dev)
    cap = B4 // 4  # cap_frac 0.25, as the call above
    split = promote.promoted_split(qd, td, DNA_111, cap)
    check(np.array_equal(split[0].cpu().numpy(), scores)
          and np.array_equal(split[1].cpu().numpy(), promoted),
          "the fused split vs sw_scores_promoted_device")
    per = timed(lambda a, b: promote.promoted_split(a, b, DNA_111, cap)[0],
                (qd, td), iters=10)
    print(f"fused split (bf16 pass, mask, capped compaction, int32 re-run of "
          f"{cap} slots, scatter) on device tensors: {per * 1e3:.4f} ms, "
          f"{B4 / per:.0f} alignments/s", flush=True)
    parts = {
        "bf16 pass (sw_bf16, all pairs)": timed(
            lambda a, b: kbf.sw_bf16(a, b, DNA_111, allow_overflow=True),
            (qd, td), iters=10),
        f"int32 re-run (sw_batch, {cap} pairs)": timed(
            lambda a, b: kb.sw_batch(a, b, DNA_111), (qd[:cap], td[:cap]),
            iters=10),
    }
    print("of which " + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in parts.items()),
          flush=True)
    exact = kb.sw_batch(qd, td, DNA_111).cpu().numpy()
    check(np.array_equal(scores, exact), "promoted scores vs the int32 kernel")
    restore(saved)
    host = sw_scores_promoted(prom_q, prom_t, DNA_111)
    check(np.array_equal(host[0], scores) and np.array_equal(host[1], promoted),
          "sw_scores_promoted_device vs sw_scores_promoted")
    check(np.array_equal(scores[:32], sw_score_batch(prom_q[:32], prom_t[:32], DNA_111)),
          "promoted scores vs the oracle on 32 pairs")
    rem = promote.sw_scores_promoted_device(prom_q, prom_t, DNA_111,
                                            cap_frac=1 / 2048)
    check(np.array_equal(rem[0], scores) and np.array_equal(rem[1], promoted),
          "cap_frac=1/2048: the host remainder path")
    print(f"every score equals the int32 kernel and sw_scores_promoted, 32 the "
          f"oracle; cap_frac=1/2048 ({B4 // 2048} slots on the device, the rest "
          f"from the host) gives the same scores and mask", flush=True)
    del qd, td, split

    # 13. config 4, traceback sample ---------------------------------------
    phase("13 BASELINE config 4, traceback sample: sw_align_batch on 16 "
          "promotion pairs")
    traceback_phase(prom_q[:16], prom_t[:16], (DNA_111,),
                    lambda p: "sw_batch_ends", "dna",
                    lambda q: "".join("ACGT"[c] for c in q))

    # 14. the bf16 tier at the headline size --------------------------------
    phase("14 the bf16 tier at 1,048,576 x (128x128), (10, -30, 15), beside "
          "best_engine's int32 kernel")
    saved = snapshot()
    B, n, m = 1 << 20, 128, 128
    hrng = np.random.default_rng(SEED + 3)
    qd = torch.from_numpy(random_codes(hrng, (B, n))).to(dev)
    td = torch.from_numpy(random_codes(hrng, (B, m))).to(dev)
    int32_fn = best_engine(DNA_10_30_15)
    check(torch.equal(kbf.sw_bf16(qd, td, DNA_10_30_15), int32_fn(qd, td)),
          "sw_bf16 vs best_engine at 1M pairs")
    cells = B * n * m
    # both launches take the [B, L] codes as they are
    bf16_bound = max(cells * pipe_slots("sw_bf16") / int32_rate,
                     cells * KERNELS["sw_bf16"][5] / bf16_rate)
    for label, fn, args, bare in (
            ("sw_bf16", kbf.sw_bf16, (qd, td, DNA_10_30_15),
             lambda: kbf.bf16_launch_t(qd, td, DNA_10_30_15)),
            ("best_engine (int32 sw_batch)", int32_fn, (qd, td),
             lambda: kb.rowscan_launch_t(qd, td, DNA_10_30_15, 10, -30,
                                         False, False))):
        sec = timed(fn, args, iters=10)
        bare_s = timed(bare, (), iters=10)
        extra = (f", the call {(sec - bare_s) * 1e3:.3f} ms past it; bound by pipe "
                 f"{bf16_bound * 1e3:.4f} ms ({bf16_bound / bare_s:.1%} of the launch)"
                 if label == "sw_bf16" else "")
        print(f"{label}: {sec * 1e3:.3f} ms per call ({cells / sec / 1e9:.1f} "
              f"GCUPS), launch alone {bare_s * 1e3:.3f} ms ({cells / bare_s / 1e9:.1f} "
              f"GCUPS){extra} [{smi}]", flush=True)
    print(f"all {B} scores equal", flush=True)
    restore(saved)
    del qd, td
    torch.cuda.empty_cache()

    # 15. config-4 CLI -----------------------------------------------------
    phase("15 config-4 CLI: pack, align on .npz inputs, align --engine rowscan_bf16")
    crng = np.random.default_rng(SEED + 4)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        reads = [(f"r{i}", "".join(decode_dna(crng.integers(0, 4, int(k)))))
                 for i, k in enumerate(crng.integers(60, 151, 16))]
        wins = [(f"w{i}", decode_dna(crng.integers(0, 4, 160))) for i in range(16)]
        with_n = [(name, s[:5] + "N" + s[6:]) for name, s in reads]
        for name, recs in (("q", reads), ("t", wins), ("n", with_n)):
            write_fasta(tmp / f"{name}.fa", recs)
            out = run_cli(cli_main, ["pack", str(tmp / f"{name}.fa"),
                                     str(tmp / f"{name}.npz")])
            check(json.loads(out[0])["records"] == 16, f"pack {name}.fa")
        run_cli(cli_main, ["pack", str(tmp / "n.npz"), str(tmp / "back.fa"), "--unpack"])
        check((tmp / "back.fa").read_text() == (tmp / "n.fa").read_text(),
              "pack --unpack round trip, in-length N included")
        argv = ["align", "--scoring", "2,-1", "--gap", "1", "--cigar"]
        from_npz = run_cli(cli_main, argv + ["--queries", str(tmp / "q.npz"),
                                             "--targets", str(tmp / "t.npz")])
        from_fa = run_cli(cli_main, argv + ["--queries", str(tmp / "q.fa"),
                                            "--targets", str(tmp / "t.fa")])
        check(from_npz == from_fa and len(from_npz) == 16,
              "align on .npz inputs vs the FASTA run")
    print(f"pack / pack --unpack round trip exact; align --cigar on .npz equals "
          f"the FASTA run; first: {from_npz[0][:100]}", flush=True)
    rs = np.random.default_rng(SEED)  # the CLI's --random inputs
    cq = rs.integers(0, 4, size=(64, 128)).astype(np.uint8)
    ct = rs.integers(0, 4, size=(64, 128)).astype(np.uint8)
    before = kbf.sw_bf16.launches
    recs = [json.loads(x) for x in run_cli(cli_main, [
        "align", "--engine", "rowscan_bf16", "--random", "64x128x128",
        "--scoring", "10,-30", "--gap", "15"])]
    check(kbf.sw_bf16.launches == before + 1, "--engine rowscan_bf16 ran sw_bf16")
    check([r["score"] for r in recs] == sw_score_batch(cq, ct, DNA_10_30_15).tolist(),
          "align --engine rowscan_bf16 vs the oracle")
    print("align --engine rowscan_bf16: 64 scores equal the oracle", flush=True)

    config4_counts = {name: launches(name) for name in CONFIG4_PATH}
    print(f"config-4 path launches: {config4_counts}", flush=True)
    check(all(v > 0 for v in config4_counts.values()),
          f"a kernel was not launched on the config-4 path: {config4_counts}")
    launch_counts["sw_bf16"] = config4_counts["sw_bf16"]

    # 16. kernel times -----------------------------------------------------
    phase("16 kernel times at 32768 x (128x128)")
    print(smi, flush=True)
    B, n, m = 32768, 128, 128
    inputs = {
        ROWSCAN: (random_codes(rng, (B, n)), random_codes(rng, (B, m))),
        PROFILE: (random_protein(rng, (B, n)), random_protein(rng, (B, m))),
    }
    inputs[BF16] = inputs[ROWSCAN]  # the same DNA codes
    for source, (qh, th) in inputs.items():
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        # every launch takes the [B, L] codes as they are (no transposes)
        for name, (src, _, replaces, ops, lookups, bf16_ops) in KERNELS.items():
            if src != source or name.endswith("_warp"):  # the warp form: phase 8
                continue
            kern, plain, p = kernel_fns[name]
            ends = name.endswith("_ends")
            ms = timed(kern, (qd, td, p), iters=20) * 1e3
            if source == ROWSCAN:
                def bare(p=p, ends=ends, select=False):
                    return kb.rowscan_launch_t(
                        qd, td, p, *kb._uniform_match_mismatch(p),
                        not p.is_linear, ends, select=select)
            elif source == BF16:
                def bare(p=p):
                    return kbf.bf16_launch_t(qd, td, p)
            else:
                table = kp.profile_table(p, dev)

                def bare(p=p, ends=ends, table=table, select=False):
                    return kp.profile_launch_t(qd, td, table, p, ends, select=select)

            for g, w in zip(tup(bare()), tup(kern(qd, td, p))):
                check(torch.equal(g, w), f"{name}: bare launch vs wrapper")
            kernel_ms = timed(bare, (), iters=20) * 1e3
            extra = {}
            if ends:  # the endpoint's select tracker on the same inputs
                for g, w in zip(bare(select=True), bare()):
                    check(torch.equal(g, w), f"{name}: select tracker vs the key")
                extra["select_kernel_ms"] = timed(lambda: bare(select=True), (),
                                                  iters=20) * 1e3
            plain_ms = timed(plain, (qd, td, p), iters=1, warmup=1, reps=1) * 1e3
            n_out = 3 if ends else 1
            table_bytes = 4 * kp.profile_table(p, dev).numel() if source == PROFILE else 0
            bytes_ = B * (n + m) + table_bytes + 4 * B * n_out
            slots = pipe_slots(name) if name in ALU_OPS else ops
            times = {
                "int32 ops": B * n * m * slots / int32_rate * 1e3,
                "bf16 ops": B * n * m * bf16_ops / bf16_rate * 1e3,
                "shared-memory lookups": B * n * m * lookups / lookup_rate * 1e3,
                "bytes": bytes_ / HBM_BYTES_PER_S * 1e3,
            }
            binds = max(times, key=times.get)
            bound = times[binds]
            rows.append(dict(
                name=name, route="cuda", source=f"swtpu_torch/csrc/{source}",
                replaces=replaces, launches=launch_counts[name],
                max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="bytes" if binds == "bytes" else "operations",
                library_ms=None, kernel_ms=kernel_ms, **extra,
            ))
            by_pipe = (f", {ALU_OPS[name]} on the ALU only, {slots} slots by pipe"
                       if name in ALU_OPS else "")
            sel = (f" (the select tracker {extra['select_kernel_ms']:.4f} ms)" if extra
                   else "")
            print(f"{name}: wrapper {ms:.4f} ms ({bound / ms:.1%} of the bound), "
                  f"launch alone {kernel_ms:.4f} ms ({bound / kernel_ms:.1%}){sel}, "
                  f"plain {plain_ms:.2f} ms, bound {bound:.4f} ms by {binds} "
                  f"({ops} int32 ops/cell{by_pipe}: {times['int32 ops']:.4f} ms; "
                  f"{bf16_ops} bf16 results/cell: {times['bf16 ops']:.4f} ms; "
                  f"{lookups} lookups/cell: {times['shared-memory lookups']:.4f} "
                  f"ms; at {sm_clock_mhz:.0f} MHz), wrapper "
                  f"{B * n * m / ms / 1e6:.1f} GCUPS", flush=True)
        del qd, td
    # the semi-global kernels: uniform on the DNA codes, profile on the
    # protein codes; their launches are counted on their path (phases
    # 17-21), after these timings
    for name in SEMIGLOBAL_PATH:
        replaces, ops, lookups, _ = KERNELS[name][2:]
        _, sc, pin = sg_fns[name]
        qh, th = inputs[ROWSCAN if isinstance(sc, dict) else PROFILE]
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        table = None if isinstance(sc, dict) else kp.profile_table(sc, dev)

        def bare(sc=sc, pin=pin):  # the launch alone, on the [B, L] codes as given
            return sg_bare(sc, pin, qd, td)

        def wrapped(a, b, sc=sc, pin=pin):
            return sg_run(sc, a, b, pin_end=pin)

        def plain(a, b, sc=sc, pin=pin):
            return sg_run(sc, a, b, plain=True, pin_end=pin)

        for g, w in zip(bare(), wrapped(qd, td)):
            check(torch.equal(g, w), f"{name}: bare launch vs wrapper")
        ms = timed(wrapped, (qd, td), iters=20) * 1e3
        kernel_ms = timed(bare, (), iters=20) * 1e3
        plain_ms = timed(plain, (qd, td), iters=1, warmup=1, reps=1) * 1e3
        extra = {}
        if not pin:  # the argmax's select tracker on the same inputs
            for g, w in zip(sg_bare(sc, pin, qd, td, select=True), bare()):
                check(torch.equal(g, w), f"{name}: select tracker vs the key")
            extra["select_kernel_ms"] = timed(
                lambda: sg_bare(sc, pin, qd, td, select=True), (), iters=20) * 1e3
        table_bytes = 0 if table is None else 4 * table.numel()
        bytes_ = B * (n + m) + table_bytes + 4 * B * 3
        times = {
            "int32 ops": B * n * m * pipe_slots(name) / int32_rate * 1e3,
            "shared-memory lookups": B * n * m * lookups / lookup_rate * 1e3,
            "bytes": bytes_ / HBM_BYTES_PER_S * 1e3,
        }
        binds = max(times, key=times.get)
        bound = times[binds]
        rows.append(dict(
            name=name, route="cuda", source=f"swtpu_torch/csrc/{SEMIGLOBAL}",
            replaces=replaces, launches=None, max_abs_err=max_err[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if binds == "bytes" else "operations",
            library_ms=None, kernel_ms=kernel_ms, **extra,
        ))
        sel = (f" (the select tracker {extra['select_kernel_ms']:.4f} ms)" if extra
               else "")
        print(f"{name}: wrapper {ms:.4f} ms ({bound / ms:.1%} of the bound), "
              f"launch alone {kernel_ms:.4f} ms ({bound / kernel_ms:.1%}){sel}, "
              f"plain {plain_ms:.2f} ms, bound {bound:.4f} ms by {binds} ({ops} "
              f"int32 ops/cell, {ALU_OPS[name]} on the ALU only: "
              f"{times['int32 ops']:.4f} ms; {lookups} "
              f"lookups/cell: {times['shared-memory lookups']:.4f} ms; at "
              f"{sm_clock_mhz:.0f} MHz), wrapper {B * n * m / ms / 1e6:.1f} GCUPS",
              flush=True)
        del qd, td
    # the fixed-band kernel at W = 32 on the same codes (DNA for the
    # uniform form, protein for the profile form), bound over the in-band
    # cells; the per-round kernel on 256 related DNA 2048-mers (the JAX
    # bench_suite's adaptive set, drawn again in phase 23), scores only, at
    # W = 96 (row 14) and W = 32 (row 15), bound over the rounds written
    # x W. Their launches are counted on their path (phases 22-25), after
    # these timings
    Wf = 32
    band_cells = B * in_band_cells(n, m, Wf)
    for name, p in (("sw_banded_static", FIX_111), ("sw_banded_static_affine", FIX_AFF),
                    ("sw_banded_profile", P_LIN), ("sw_banded_profile_affine", P_GOTOH)):
        replaces, ops, lookups, _ = KERNELS[name][2:]
        profile = name.startswith("sw_banded_profile")
        qh, th = inputs[PROFILE if profile else ROWSCAN]
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        kern = ksb.sw_banded_profile if profile else ksb.sw_banded_static
        table = ksb.banded_table(p.matrix, dev) if profile else None

        def bare(p=p, table=table):  # the launch alone, on the [B, L] codes as given
            return ksb.banded_launch_t(qd, td, p, Wf, table)

        check(torch.equal(bare(), kern(qd, td, p, Wf)), f"{name}: bare launch vs wrapper")
        ms = timed(kern, (qd, td, p, Wf), iters=20) * 1e3
        kernel_ms = timed(bare, (), iters=20) * 1e3
        plain_ms = timed(ksb.sw_banded_plain, (qd, td, p, Wf), iters=1, warmup=1,
                         reps=1) * 1e3
        bytes_ = B * (n + m) + (0 if table is None else 4 * table.numel()) + 4 * B
        times = {
            "int32 ops": band_cells * pipe_slots(name) / int32_rate * 1e3,
            "shared-memory lookups": band_cells * lookups / lookup_rate * 1e3,
            "bytes": bytes_ / HBM_BYTES_PER_S * 1e3,
        }
        binds = max(times, key=times.get)
        bound = times[binds]
        rows.append(dict(
            name=name, route="cuda", source=f"swtpu_torch/csrc/{BANDED}",
            replaces=replaces, launches=None, max_abs_err=max_err[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if binds == "bytes" else "operations",
            library_ms=None, kernel_ms=kernel_ms,
        ))
        print(f"{name} W={Wf}: wrapper {ms:.4f} ms ({bound / ms:.1%} of the bound), "
              f"launch alone {kernel_ms:.4f} ms ({bound / kernel_ms:.1%}), plain "
              f"{plain_ms:.2f} ms, bound {bound:.4f} ms by {binds} ({ops} int32 "
              f"ops/in-band cell, {ALU_OPS[name]} on the ALU only, over {band_cells} "
              f"cells: {times['int32 ops']:.4f} ms by pipe; {lookups} lookups/cell; at "
              f"{sm_clock_mhz:.0f} MHz), wrapper {band_cells / ms / 1e6:.1f} band GCUPS",
              flush=True)
        del qd, td
    arng = np.random.default_rng(SEED + 9)
    Ba, La = 256, 2048
    adq = arng.integers(0, 4, size=(Ba, La)).astype(np.uint8)
    adt = np.stack([mutate(arng, adq[b], out_len=La) for b in range(Ba)])
    adq_d, adt_d = torch.from_numpy(adq).to(dev), torch.from_numpy(adt).to(dev)
    xdrop_plain = {}  # W -> the plain version's result, for phase 23
    ops_cell, ops_round = xdrop_ops(False, False)
    for name, W in (("banded_batch", 96), ("banded_batch_w32_w64", 32)):
        replaces = KERNELS[name][2]
        staged = kbb.stage(adq_d, adt_d, None, None, dev)
        qp, tp, lq, lt = _prep_padded(adq_d, adt_d, None, None, W, dev, torch.int16)
        lq, lt = lq.int(), lt.int()

        def wrapped(q, t, W=W):
            return kbb.banded_batch(q, t, bandwidth=W, with_history=False)

        def plain(q, t, W=W):
            xdrop_plain[W] = kbb.banded_batch_plain(q, t, bandwidth=W,
                                                    with_history=False, device=dev)
            return xdrop_plain[W]

        def bare(W=W, staged=staged):
            return kbb.xdrop_launch_t(*staged, W, 70, 1, 1, 1, with_history=False)

        def earlier(W=W, qp=qp, tp=tp, lq=lq, lt=lt):
            return kbb._earlier_launch_t(qp, tp, lq, lt, W, 70, 1, 1, 1,
                                         with_history=False)

        res = wrapped(adq_d, adt_d)
        for fn, what in ((bare, "bare launch"), (earlier, "the earlier kernel")):
            check(all(torch.equal(g, w) for g, w in zip(fn()[:3], xdrop_fields(res))),
                  f"{name}: {what} vs wrapper")
        rounds = int(res.n_rounds.sum())
        cells = rounds * W
        ms = timed(wrapped, (adq_d, adt_d), iters=10) * 1e3
        kernel_ms = timed(bare, (), iters=10) * 1e3
        earlier_ms = timed(earlier, (), iters=10) * 1e3
        # one plain call: ~4100 Python rounds take seconds
        plain_ms = timed(plain, (adq_d, adt_d), iters=1, warmup=0, reps=1) * 1e3
        err = max_abs_err(xdrop_fields(res), xdrop_fields(xdrop_plain[W]))
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{name} differs from its plain version at W={W}")
        # the function's bytes: the codes read once, the lengths, three
        # int32 outputs
        bytes_ = 2 * Ba * La + 8 * Ba + 12 * Ba
        times = {
            "int32 ops": (cells * ops_cell + rounds * ops_round) / int32_rate * 1e3,
            "bytes": bytes_ / HBM_BYTES_PER_S * 1e3,
        }
        binds = max(times, key=times.get)
        bound = times[binds]
        ns_round = kernel_ms * 1e6 / int(res.n_rounds.max())
        rows.append(dict(
            name=name, route="cuda", source=f"swtpu_torch/csrc/{XDROP}",
            replaces=replaces, launches=None, max_abs_err=max_err[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if binds == "bytes" else "operations",
            library_ms=None, kernel_ms=kernel_ms, earlier_kernel_ms=earlier_ms,
            ns_a_round=ns_round,
        ))
        print(f"{name} W={W}, {Ba} related 2048-mers, scores only: wrapper {ms:.4f} "
              f"ms ({bound / ms:.1%} of the bound), launch alone {kernel_ms:.4f} ms "
              f"({bound / kernel_ms:.1%}; {ns_round:.1f} ns a round of the longest "
              f"pair), the earlier kernel {earlier_ms:.4f} ms (equal), plain "
              f"{plain_ms:.2f} ms (equal), bound "
              f"{bound:.4f} ms by {binds} ({ops_cell} ALU slots per band cell over "
              f"{cells} band cells = rounds written x W, {ops_round} per pair and "
              f"round over {rounds} rounds: xdrop_ops; at {sm_clock_mhz:.0f} MHz), "
              f"wrapper "
              f"{cells / ms / 1e6:.2f} band GCUPS", flush=True)
        del qp, tp, staged
    # the profile kernel's two forms, launch alone, at n = 120 on B pairs of
    # random protein against m-long targets (linear 11, Gotoh 11/1): points
    # on both sides of profile_form's thresholds (the full sweep that set
    # them, B = 512 to 131,072 at each m, is PERF.md's, cut here for time);
    # the warp form held against the thread form on every pair and, at 512
    # pairs, the plain version
    print(f"profile form sweep, launch alone (ms) [{smi}]: B x 120 x m, warp form / "
          "thread form, the faster, and the form profile_form picks", flush=True)
    srng = np.random.default_rng(SEED + 13)
    picks = []
    for m_, B_ in ((128, 512), (128, 32768), (320, 512), (320, 8192), (800, 512)):
        q_ = torch.from_numpy(random_protein(srng, (B_, 120))).to(dev)
        t_ = torch.from_numpy(random_protein(srng, (B_, m_))).to(dev)
        line = []
        for p in (P_LIN, P_GOTOH):
            table = kp.profile_table(p, dev)
            got = kp.profile_warp_launch_t(q_, t_, table, p, False)
            name = profile_name(False, p, warp=True)
            err = max_abs_err(got, kp.profile_launch_t(q_, t_, table, p, False))
            if B_ == 512:  # and the plain version, once a width
                err = max(err, max_abs_err(got, kp.sw_profile_plain(q_, t_, p)))
            max_err[name] = max(max_err[name], err)
            check(err == 0, f"{name} differs on the sweep's {B_} x 120 x {m_}")
            it = 3 if B_ * m_ > 10**7 else 10
            w = timed(kp.profile_warp_launch_t, (q_, t_, table, p, False), iters=it) * 1e3
            th = timed(kp.profile_launch_t, (q_, t_, table, p, False), iters=it) * 1e3
            pick = kp.profile_form(B_, 120, m_, n_sm)
            picks.append((pick, "warp" if w < th else "thread", min(w, th) / max(w, th)))
            line.append(f"gap=({p.gap_open},{p.gap_extend}) {w:.4f} / {th:.4f}, "
                        f"{picks[-1][1]}, picks {pick}")
        print(f"  {B_} x 120 x {m_}: " + "; ".join(line), flush=True)
        del q_, t_
        torch.cuda.empty_cache()
    right_pick = sum(p == f for p, f, _ in picks)
    near = sum(p == f or r > 0.9 for p, f, r in picks)
    print(f"profile_form (warp up to {kp.WARP_PAIRS_PER_SM} pairs an SM or past m = "
          f"{kp.THREAD_MAX_M}) picks the faster form on {right_pick} of {len(picks)} "
          f"sweep points, one within 10% of it on {near}", flush=True)
    from swtpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(["--batch", str(B)])
    rec = json.loads(buf.getvalue().splitlines()[-1])
    check(rec["metric"] == "sw_batch_128x128_gcups_cuda" and rec["value"] > 0,
          "bench line")
    print(f"bench: {json.dumps(rec)}", flush=True)

    # semi-global path: counts from here to the end of phase 21 ------------
    zero_launches(SEMIGLOBAL_PATH)

    # 17. semi-global path, scores and endpoints at 1M pairs ---------------
    phase("17 semi-global path, scores and endpoints at 1,048,576 x (128x128)")
    B, n, m, chunk = 1 << 20, 128, 128, 1 << 15
    srng = np.random.default_rng(SEED + 6)
    big = {4: random_codes(srng, (B, n)), 20: random_protein(srng, (B, n))}
    big = {A: (torch.from_numpy(qh).to(dev),
               torch.from_numpy(random_codes(srng, (B, m)) if A == 4
                                else random_protein(srng, (B, m))).to(dev))
           for A, qh in big.items()}

    def headline(sc, pin, label):
        """One scoring through the wrapper at 1M pairs: the first
        CHECK_PAIRS outputs against the plain version (in chunks: the plain
        tier's profile is [B, n + 1, 32] int32), 64 pairs against the oracle
        copy, timed."""
        qd, td = big[sg_letters(sc)]
        name = sg_name(sc, pin)
        out = sg_run(sc, qd, td, pin_end=pin)
        torch.cuda.synchronize()
        check(all(x.shape == (B,) and x.dtype == torch.int32
                  and x.device.type == "cuda" for x in out), f"{name} outputs")
        t0 = time.perf_counter()
        err = 0
        for lo in range(0, CHECK_PAIRS, chunk):
            err = max(err, max_abs_err(
                tuple(x[lo:lo + chunk] for x in out),
                sg_run(sc, qd[lo:lo + chunk], td[lo:lo + chunk], plain=True,
                       pin_end=pin)))
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{name} differs from its plain version at 1M pairs")
        plain_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        s_host, ei, ej = (x.cpu().numpy() for x in out)
        if pin:
            check((ei == n).all() and (ej == m).all(), f"{name}: pinned ends")
        idx = srng.choice(B, 16, replace=False)
        idx_d = torch.from_numpy(idx).to(dev)
        qh, th = qd[idx_d].cpu().numpy(), td[idx_d].cpu().numpy()
        walker = sg_oracle(sc, pin)
        for k, b in enumerate(idx):
            s0, path = walker(qh[k], th[k])
            check((s0, path[-1]) == (s_host[b], (ei[b], ej[b])),
                  f"{name} vs the oracle copy at pair {b}")
        sec = timed(lambda q, t: sg_run(sc, q, t, pin_end=pin), (qd, td),
                    iters=10)
        print(f"{label} {name}: {sec * 1e3:.3f} ms per call, "
              f"{B * n * m / sec / 1e9:.1f} GCUPS; the first {CHECK_PAIRS} outputs "
              f"equal the plain version ({plain_s:.1f} s), 16 the oracle copy; mean score "
              f"{s_host.mean():.3f}, {int((ei > 0).sum())} ends off the origin "
              f"[{smi}]", flush=True)
        launch_alone_1m(sc, pin, sec * 1e3)

    def launch_alone_1m(sc, pin, wrapper_ms=None):
        """A form's launch alone at 1M pairs beside its bound (the shape
        where the path's headline launches run), off the path."""
        qd, td = big[sg_letters(sc)]
        name = sg_name(sc, pin)
        alone = timed(lambda q, t: sg_bare(sc, pin, q, t), (qd, td), iters=5) * 1e3
        bound = max(B * n * m * pipe_slots(name) / int32_rate,
                    B * n * m * KERNELS[name][4] / lookup_rate) * 1e3
        over = "" if wrapper_ms is None else f"; the wrapper {wrapper_ms - alone:+.3f} ms"
        if not pin:
            sel = timed(lambda q, t: sg_bare(sc, pin, q, t, select=True), (qd, td),
                        iters=5) * 1e3
            over += f"; the select tracker {sel:.3f} ms ({sel / alone:.3f}x)"
        print(f"  {name} launch alone at 1M pairs {alone:.3f} ms, bound {bound:.3f} ms "
              f"({bound / alone:.1%}), {alone - bound:.3f} ms lost a launch{over}",
              flush=True)

    for label, sc in (("DNA (1,1,1)", SG_111), ("DNA (2,3,5,1)", SG_AFF),
                      ("protein BLOSUM62 11", P_LIN),
                      ("protein BLOSUM62 11/1", P_GOTOH)):
        headline(sc, False, label)

    # 18. global path at 1M pairs ------------------------------------------
    phase("18 global path at 1,048,576 x (128x128)")
    for label, sc in (("DNA (1,1,1)", SG_111), ("protein BLOSUM62 11/1", P_GOTOH)):
        headline(sc, True, label)
    for sc in (SG_AFF, P_LIN):  # the pinned forms no global headline drives
        launch_alone_1m(sc, True)
    del big
    torch.cuda.empty_cache()

    # 19. varlen -------------------------------------------------------------
    phase("19 semi-global and global, varlen: 32,768 DNA pairs, query lengths "
          "96-128, target lengths 112-128")
    B = 32768
    vq, vt = random_codes(srng, (B, 128)), random_codes(srng, (B, 128))
    lq, lt = srng.integers(96, 129, B), srng.integers(112, 129, B)
    vq[np.arange(128)[None, :] >= lq[:, None]] = 4  # pads past each length
    vt[np.arange(128)[None, :] >= lt[:, None]] = 5
    qd, td = torch.from_numpy(vq).to(dev), torch.from_numpy(vt).to(dev)
    cells = int((lq * lt).sum())
    for pin in (False, True):
        name = sg_name(SG_111, pin)
        got = sg_run(SG_111, qd, td, pin_end=pin, lens_q=lq, lens_t=lt)
        err = max_abs_err(got, sg_run(SG_111, qd, td, plain=True, pin_end=pin,
                                      lens_q=lq, lens_t=lt))
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{name} differs from its plain version on varlen pairs")
        if pin:
            check(np.array_equal(got[1].cpu().numpy(), lq)
                  and np.array_equal(got[2].cpu().numpy(), lt), "varlen pinned ends")
        sec = timed(lambda q, t, pin=pin: sg_run(
            SG_111, q, t, pin_end=pin, lens_q=lq, lens_t=lt), (qd, td), iters=10)
        print(f"varlen {name}: {sec * 1e3:.4f} ms per call (lengths uploaded), "
              f"{cells / sec / 1e9:.1f} GCUPS over the {cells} real cells; equal "
              f"to the plain version", flush=True)
    del qd, td

    # 20. traceback ----------------------------------------------------------
    phase("20 semi-global and global traceback: 64 related DNA pairs "
          "(linear), 16 affine, 16 protein Gotoh 11/1")

    def sg_traceback(qs, ts, sc, alphabet, seq_of):
        qd, td = torch.from_numpy(qs).to(dev), torch.from_numpy(ts).to(dev)
        p, L = sg_params(sc), qs.shape[1]
        kw = dict(sc) if isinstance(sc, dict) else dict(params=sc)
        for pin, fn in ((False, semiglobal_align_batch), (True, nw_align_batch)):
            name = sg_name(sc, pin)
            saved = snapshot()  # the check below is not the path's own
            sc_d, ei, ej = (x.cpu().numpy() for x in sg_run(sc, qd, td, pin_end=pin))
            restore(saved)
            t0 = time.perf_counter()
            res = fn(qs, ts, **kw)
            walk_s = time.perf_counter() - t0
            for b, (score, path) in enumerate(res):
                check(score == sc_d[b] and path[0] == (0, 0)
                      and path[-1] == (ei[b], ej[b]), f"{name}: ends of pair {b}")
                if pin:
                    check(path[-1] == (L, ts.shape[1]), f"{name}: corner of pair {b}")
                check(rescore(path, qs[b], ts[b], p) == score,
                      f"{name}: rescore of pair {b}")
                rec = sam_record(f"q{b}", f"t{b}", qs[b], ts[b], score, path,
                                 alphabet, query_len=L).split("\t")
                check(rec[9] == seq_of(qs[b]), f"{name}: SAM SEQ of pair {b}")
                if len(path) < 2:
                    check(rec[1] == "4", f"{name}: unmapped SAM record of pair {b}")
                    continue
                st = cigar_stats(path_to_cigar(path, qs[b], ts[b]))
                check(st["query_consumed"] == path[-1][0]
                      and st["target_consumed"] == path[-1][1],
                      f"{name}: CIGAR of pair {b}")
                check(len(rec) == 13 and rec[3] == "1" and rec[11] == f"AS:i:{score}"
                      and rec[5] == path_to_cigar(path, qs[b], ts[b], query_len=L),
                      f"{name}: SAM record of pair {b}")
            # JAX walks uniform Gotoh semi-global in numpy; the port too
            walker = "numpy" if isinstance(sc, dict) and sg_gaps(sc)[2] else "C++"
            print(f"{name}: {len(res)} pairs, sg/nw_align_batch {walk_s:.2f} s wall "
                  f"({walker} host walk), {sum(len(r[1]) > 1 for r in res)} off the origin, "
                  f"mean score {float(np.mean([r[0] for r in res])):.2f}; ends, "
                  f"rescoring, CIGAR and SAM checked", flush=True)

    dna_seq = lambda q: "".join("ACGT"[c] for c in q)  # noqa: E731
    qs, ts = related_pairs(srng, 64, 128)
    sg_traceback(qs, ts, SG_111, "dna", dna_seq)
    sg_traceback(qs[:16], ts[:16], SG_AFF, "dna", dna_seq)
    qs, ts = related_pairs(srng, 16, 128, letters=20)
    sg_traceback(qs, ts, P_GOTOH, "protein", decode_protein)

    # 21. semi-global and global CLI ----------------------------------------
    phase("21 semiglobal and global CLI, DNA and protein")
    for argv, sc, pin in (
        (["semiglobal", "--random", "64x128x128", "--scoring", "2,-1",
          "--cigar"], dict(match=2, mismatch=1, gap=1), False),
        (["global", "--random", "64x128x128", "--scoring", "2,-1",
          "--gap-open", "5", "--gap-extend", "1", "--sam"],
         dict(match=2, mismatch=1, gap_open=5, gap_extend=1), True),
        (["semiglobal", "--alphabet", "protein", "--random", "32x128x128",
          "--gap-open", "11", "--gap-extend", "1", "--traceback"], P_GOTOH, False),
        (["global", "--alphabet", "protein", "--random", "32x128x128", "--gap",
          "11", "--sam"], P_LIN, True),
    ):
        B = int(argv[argv.index("--random") + 1].split("x")[0])
        rs = np.random.default_rng(SEED)  # the CLI's --random inputs
        cq = rs.integers(0, sg_letters(sc), size=(B, 128)).astype(np.uint8)
        ct = rs.integers(0, sg_letters(sc), size=(B, 128)).astype(np.uint8)
        walker = sg_oracle(sc, pin)
        want = [walker(q, t) for q, t in zip(cq, ct)]
        lines = run_cli(cli_main, argv)
        if "--sam" in argv:
            body = [x.split("\t") for x in lines if not x.startswith("@")]
            check(len(body) == B and all(
                (r[1] == "4" and len(path) < 2) or r[11] == f"AS:i:{s0}"
                for r, (s0, path) in zip(body, want)),
                f"{argv[0]} --sam vs the oracle copy")
        else:
            recs = [json.loads(x) for x in lines]
            ok = len(recs) == B
            for r, (s0, path), q, t in zip(recs, want, cq, ct):
                ok &= r["score"] == s0 and tuple(r["end"]) == path[-1]
                if "path" in r:
                    ok &= [tuple(c) for c in r["path"]] == path
                if "cigar" in r:
                    ok &= r["cigar"] == path_to_cigar(path, q, t)
            check(ok, f"{argv[0]} JSON vs the oracle copy")
        print(f"{' '.join(argv[:3])} ...: {B} records equal the oracle copy; "
              f"first: {lines[-1][:100]}", flush=True)

    sg_counts = {name: launches(name) for name in SEMIGLOBAL_PATH}
    print(f"semi-global path launches: {sg_counts}", flush=True)
    check(all(v > 0 for v in sg_counts.values()),
          f"a kernel was not launched on the semi-global path: {sg_counts}")

    # banded path: counts from here to the end of phase 25 -----------------
    zero_launches(BANDED_PATH)

    # 22. fixed-band path, BASELINE config 2 -------------------------------
    phase("22 fixed-band path, BASELINE config 2: 1,048,576 x (128x128) at W = 32")
    B, n, Wf, chunk = 1 << 20, 128, 32, 1 << 15
    grng = np.random.default_rng(SEED + 10)
    big = {4: (random_codes(grng, (B, n)), random_codes(grng, (B, n))),
           20: (random_protein(grng, (B, n)), random_protein(grng, (B, n)))}
    big_d = {A: (torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev))
             for A, (q, t) in big.items()}
    cells = B * in_band_cells(n, n, Wf)
    for label, p in (("DNA (1,-1,1)", FIX_111), ("DNA Gotoh (1,-1,3,1)", FIX_AFF),
                     ("protein BLOSUM62 11", P_LIN), ("protein BLOSUM62 11/1", P_GOTOH)):
        A = 4 if p.alphabet_size == 4 else 20
        qd, td = big_d[A]
        name = banded_name(p)

        def fn(q, t, p=p):
            return banded_static_scores(q, t, p, Wf)

        scores = fn(qd, td)
        torch.cuda.synchronize()
        check(scores.shape == (B,) and scores.dtype == torch.int32
              and scores.device.type == "cuda", f"{name} output")
        t0 = time.perf_counter()
        err = 0
        for lo in range(0, CHECK_PAIRS, chunk):
            err = max(err, max_abs_err(scores[lo:lo + chunk], ksb.sw_banded_plain(
                qd[lo:lo + chunk], td[lo:lo + chunk], p, Wf)))
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{name} differs from its plain version at 1M pairs")
        plain_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        s_host = scores.cpu().numpy()
        idx = grng.choice(B, 64, replace=False)
        qh, th = big[A]
        check(np.array_equal(s_host[idx], sw_banded_static_score_batch(
            qh[idx], th[idx], p, Wf)), f"{name} vs the oracle copy on 64 pairs")
        sec = timed(fn, (qd, td), iters=10)
        table = ksb.banded_table(p.matrix, dev) if name.startswith("sw_banded_profile") else None
        alone = timed(lambda p=p, table=table: ksb.banded_launch_t(qd, td, p, Wf, table), (),
                      iters=10)
        bound = cells * pipe_slots(name) / int32_rate
        print(f"{label} {name}: {sec * 1e3:.3f} ms per call ({sec * 1e3:.3f} ms per "
              f"1M alignments), {cells / sec / 1e9:.1f} band GCUPS over {cells} "
              f"in-band cells, launch alone {alone * 1e3:.3f} ms ({bound / alone:.1%} of "
              f"its bound by pipe, {bound * 1e3:.4f} ms); the first {CHECK_PAIRS} scores "
              f"equal the plain version ({plain_s:.1f} s), 64 the oracle copy; mean score "
              f"{s_host.mean():.3f} [{smi}]",
              flush=True)
    del big, big_d, qd, td, scores
    torch.cuda.empty_cache()
    # bench_suite's 2048 related 2048-mers at W = 32 (the 256 drawn in phase
    # 16, eight times over)
    fq = torch.from_numpy(np.tile(adq, (8, 1))).to(dev)
    ft = torch.from_numpy(np.tile(adt, (8, 1))).to(dev)
    for label, p in (("(1,-1,1)", FIX_111), ("Gotoh (1,-1,3,1)", FIX_AFF)):
        scores = banded_static_scores(fq, ft, p, Wf)
        err = max_abs_err(scores[:256], ksb.sw_banded_plain(fq[:256], ft[:256], p, Wf))
        max_err[banded_name(p)] = max(max_err[banded_name(p)], err)
        check(err == 0 and torch.equal(scores.view(8, 256), scores[:256].expand(8, 256)),
              f"{banded_name(p)} on 2048-mers")
        sec = timed(lambda q, t, p=p: banded_static_scores(q, t, p, Wf), (fq, ft),
                    iters=5)
        c2 = 2048 * in_band_cells(La, La, Wf)
        print(f"2048 related 2048-mers {label}: {sec * 1e3:.3f} ms per call, "
              f"{c2 / sec / 1e9:.1f} band GCUPS (2048 threads: 16 blocks on "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs); "
              f"the first 256 equal the plain version, mean score "
              f"{scores.float().mean().item():.1f}", flush=True)
    del fq, ft

    # 23. per-round adaptive path -------------------------------------------
    phase("23 per-round adaptive band: 256 related 2048-mers (bench_suite's "
          "sets), W = 32 / 64 / 96, with and without history; 16,384 pairs")
    pq = arng.integers(0, 20, size=(Ba, La)).astype(np.uint8)
    pt = pq.copy()
    for b in range(Ba):
        idx = arng.integers(0, La, La // 3)
        pt[b, idx] = arng.integers(0, 20, La // 3)
    nt = arng.integers(0, 4, size=(Ba, La)).astype(np.uint8)
    sets = {"dna": (adq_d, adt_d), "protein": (torch.from_numpy(pq).to(dev),
                                               torch.from_numpy(pt).to(dev)),
            "non-homologous": (adq_d, torch.from_numpy(nt).to(dev))}
    # each scoring and the history once against the plain version (~4100
    # Python rounds a call): W = 32 and 96 reuse phase 16's plain calls on
    # the same inputs; W = 64, held against its plain version in phase 3,
    # against the oracle copy on 2 pairs
    adaptive = [
        ("DNA (1,1,1) X=70 W=32", "dna", dict(), "phase 16"),
        ("DNA Gotoh 3/1 X=70 W=32", "dna", dict(gap_open=3, gap_extend=1), "plain"),
        ("protein BLOSUM62 11/1 X=120 W=32", "protein",
         dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120), "plain"),
        ("non-homologous (1,3,2) X=40 W=32, early exit", "non-homologous",
         dict(mismatch=3, gap=2, x_threshold=40, early_exit=True), "plain"),
        ("DNA (1,1,1) X=70 W=64", "dna", dict(bandwidth=64), "oracle"),
        ("DNA (1,1,1) X=70 W=96", "dna", dict(bandwidth=96), "phase 16"),
    ]
    for label, key, kw, ref in adaptive:
        qd, td = sets[key]
        W = kw.get("bandwidth", 32)
        res = kbb.banded_batch(qd, td, with_history=False, **kw)
        if ref == "oracle":
            got, qh, th = res.numpy(), qd[:2].cpu().numpy(), td[:2].cpu().numpy()
            for b in range(2):
                st = banded_xdrop(qh[b], th[b], bandwidth=W, return_state=True)
                check((st.score, st.n_rounds, st.max_round) == (
                    got.score[b], got.n_rounds[b], got.max_round[b]),
                    f"{label} vs the oracle copy at pair {b}")
            how = "2 pairs equal the oracle copy"
        else:
            want = (xdrop_plain[W] if ref == "phase 16" else kbb.banded_batch_plain(
                qd, td, with_history=False, device=dev, **kw))
            err = max_abs_err(xdrop_fields(res), xdrop_fields(want))
            max_err[xdrop_name(W)] = max(max_err[xdrop_name(W)], err)
            check(err == 0, f"{xdrop_name(W)} differs from its plain version on {label}")
            how = "equal to the plain version" + (
                " (phase 16's call)" if ref == "phase 16" else "")
        sec = timed(lambda q, t, kw=kw: kbb.banded_batch(
            q, t, with_history=False, **kw), (qd, td), iters=5)
        rounds = int(res.n_rounds.sum())
        print(f"{label}: {sec * 1e3:.3f} ms per call, {rounds * W / sec / 1e9:.2f} "
              f"band GCUPS ({rounds} rounds x W); mean score "
              f"{res.score.float().mean().item():.1f}, mean rounds {rounds / Ba:.1f} "
              f"of {2 * La + 1}; {how} [{smi}]", flush=True)
    # with history: the user's entry point (host arrays, 8-bit history
    # auto-selected at this size) and the device calls it makes; both
    # histories against one plain call (the 8-bit form decodes exactly)
    t0 = time.perf_counter()
    host = banded_forward_batch(adq, adt)
    fwd_s = time.perf_counter() - t0
    check(host.band_history.dtype == np.uint8 and host.offsets is not None,
          "banded_forward_batch picks the 8-bit history past 8 MB")
    want8 = kbb.banded_batch_plain(adq_d, adt_d, compress_history=True, device=dev)
    want32 = BandedBatchResult(
        want8.score, want8.max_round, want8.n_rounds,
        torch.where(want8.band_history > 0,
                    want8.band_history.int() - 1 + want8.offsets[:, :, None], 0),
        want8.pos_y)
    for comp in (True, False):
        res = kbb.banded_batch(adq_d, adt_d, compress_history=comp)
        err = max_abs_err(xdrop_fields(res), xdrop_fields(want8 if comp else want32))
        max_err["banded_batch_w32_w64"] = max(max_err["banded_batch_w32_w64"], err)
        check(err == 0, f"banded_batch_w32_w64 with history (8-bit {comp}) vs plain")
        if comp:
            check(all(torch.equal(a, b) for a, b in zip(xdrop_fields(host),
                                                        xdrop_fields(res))),
                  "banded_forward_batch vs the device result")
        sec = timed(lambda q, t, comp=comp: kbb.banded_batch(
            q, t, compress_history=comp), (adq_d, adt_d), iters=5)
        hist_mb = res.band_history.numel() * res.band_history.element_size() / 2**20
        rounds = int(res.n_rounds.sum())
        print(f"DNA (1,1,1) W=32 with {'8-bit' if comp else 'int32'} history "
              f"({hist_mb:.0f} MiB): {sec * 1e3:.3f} ms per call, "
              f"{rounds * 32 / sec / 1e9:.2f} band GCUPS; equal to the plain version",
              flush=True)
    del want8, want32, host
    print(f"banded_forward_batch (upload, kernel, 8-bit history to the host): "
          f"{fwd_s * 1e3:.1f} ms wall", flush=True)
    # 16,384 pairs, scores only: the DNA set 64 times over
    q16 = adq_d.repeat(64, 1)
    t16 = adt_d.repeat(64, 1)
    with off_path():
        base = kbb.banded_batch(adq_d, adt_d, with_history=False)
    res = kbb.banded_batch(q16, t16, with_history=False)
    check(all(torch.equal(x.view(64, Ba), y.expand(64, Ba))
              for x, y in zip(xdrop_fields(res), xdrop_fields(base))),
          "16,384 pairs: every copy equals the 256-pair run")
    sec = timed(lambda q, t: kbb.banded_batch(q, t, with_history=False),
                (q16, t16), iters=3)
    staged = kbb.stage(q16, t16, None, None, dev)
    alone = timed(lambda: kbb.xdrop_launch_t(*staged, 32, 70, 1, 1, 1,
                                             with_history=False), (), iters=3) * 1e3
    qp, tp, lq16, lt16 = _prep_padded(q16, t16, None, None, 32, dev, torch.int16)
    lq16, lt16 = lq16.int(), lt16.int()
    check(all(torch.equal(x, y) for x, y in zip(kbb._earlier_launch_t(
        qp, tp, lq16, lt16, 32, 70, 1, 1, 1, with_history=False)[:3], xdrop_fields(res))),
        "16,384 pairs: the earlier kernel equals the kernel")
    earlier16 = timed(lambda: kbb._earlier_launch_t(qp, tp, lq16, lt16, 32, 70, 1, 1, 1,
                                                    with_history=False), (), iters=3) * 1e3
    rounds = int(res.n_rounds.sum())
    longest = int(res.n_rounds.max())
    bound = (rounds * 32 * ops_cell + rounds * ops_round) / int32_rate * 1e3
    xdrop_shapes = {"16,384 pairs": (sec * 1e3, alone, earlier16, bound, longest)}
    print(f"16,384 pairs (the DNA set x 64), W=32, scores only: {sec * 1e3:.3f} ms "
          f"per call, launch alone {alone:.3f} ms ({alone * 1e6 / longest:.1f} ns a "
          f"round of the longest pair), the earlier kernel {earlier16:.3f} ms (equal), "
          f"{rounds * 32 / sec / 1e9:.2f} band GCUPS, {16384 / sec:.0f} alignments/s, "
          f"{bound / alone:.1%} of its int32 bound {bound:.4f} ms ({alone - bound:.3f} ms "
          f"lost a launch); every copy equals the 256-pair run", flush=True)
    del q16, t16, res, base, staged, qp, tp
    # one pair: the round chain's own latency (the first 2048-mer pair)
    one = kbb.stage(adq_d[:1], adt_d[:1], None, None, dev)
    check(all(torch.equal(x, y[:1]) for x, y in zip(kbb.xdrop_launch_t(
        *one, 32, 70, 1, 1, 1, with_history=False)[:3], xdrop_fields(xdrop_plain[32]))),
        "one pair equals the plain version's first")
    alone1 = timed(lambda: kbb.xdrop_launch_t(*one, 32, 70, 1, 1, 1, with_history=False),
                   (), iters=10) * 1e3
    qp, tp, lq1, lt1 = _prep_padded(adq_d[:1], adt_d[:1], None, None, 32, dev, torch.int16)
    earlier1 = timed(lambda: kbb._earlier_launch_t(qp, tp, lq1.int(), lt1.int(), 32, 70,
                                                   1, 1, 1, with_history=False),
                     (), iters=10) * 1e3
    n1 = int(xdrop_plain[32].n_rounds[0])
    xdrop_shapes["1 pair"] = (None, alone1, earlier1, None, n1)
    print(f"1 pair, W=32: launch alone {alone1:.4f} ms over {n1} rounds, "
          f"{alone1 * 1e6 / n1:.1f} ns a round (the earlier kernel "
          f"{earlier1 * 1e6 / n1:.1f}); 256 pairs: {rows_by_name('banded_batch_w32_w64')['ns_a_round']:.1f} "
          f"ns a round of the longest pair", flush=True)
    del one, qp, tp
    torch.cuda.empty_cache()

    # 24. banded traceback ---------------------------------------------------
    phase("24 banded traceback: banded_static_align_batch on 64 related "
          "128-mers, banded_align_batch on 16 related 2048-mers")
    trng = np.random.default_rng(SEED + 11)
    dq, dt = related_pairs(trng, 64, 128)
    pq2, pt2 = related_pairs(trng, 64, 128, letters=20)
    for label, p, q, t in (("DNA (1,-1,1)", FIX_111, dq, dt),
                           ("DNA Gotoh (1,-1,3,1)", FIX_AFF, dq, dt),
                           ("protein BLOSUM62 11/1", P_GOTOH, pq2, pt2)):
        saved = snapshot()
        sc_d = banded_static_scores(q, t, p, Wf).cpu().numpy()
        restore(saved)
        t0 = time.perf_counter()
        res = banded_static_align_batch(q, t, p, Wf)
        walk_s = time.perf_counter() - t0
        for b, (score, path) in enumerate(res):
            check(score == sc_d[b], f"fixed band: score of pair {b}")
            if score == 0:
                continue
            check(all(abs(i - j) <= Wf for i, j in path), f"fixed band: corridor, {b}")
            check(rescore(path, q[b], t[b], p) == score, f"fixed band: rescore, {b}")
        print(f"banded_static_align_batch {label}: 64 pairs, {walk_s:.2f} s wall "
              f"(C++ host walk), mean score {float(np.mean([r[0] for r in res])):.2f}; "
              f"paths in the corridor and rescored", flush=True)
    for label, key, kw, p in (
            ("DNA (1,1,1)", "dna", dict(), ScoringParams.linear(dna_matrix(1, -1), 1)),
            ("DNA Gotoh 3/1", "dna", dict(gap_open=3, gap_extend=1),
             ScoringParams(dna_matrix(1, -1), 3, 1)),
            ("protein BLOSUM62 11/1 X=120", "protein",
             dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120),
             P_GOTOH)):
        qd, td = sets[key]
        q, t = qd[:16].cpu().numpy(), td[:16].cpu().numpy()
        t0 = time.perf_counter()
        res = banded_align_batch(q, t, **kw)
        walk_s = time.perf_counter() - t0
        for b, (score, path) in enumerate(res):
            check(path[0] == (0, 0) and rescore(path, q[b], t[b], p) == score,
                  f"banded_align_batch {label}: path of pair {b}")
        if "gap_open" in kw:
            ref = banded_affine_xdrop(q[0], t[0], 1, 1, kw["gap_open"],
                                      kw["gap_extend"],
                                      x_threshold=kw.get("x_threshold", 70),
                                      matrix=kw.get("matrix"))
        else:
            ref = banded_xdrop(q[0], t[0])
        check(res[0] == ref, f"banded_align_batch {label} vs the oracle copy, pair 0")
        print(f"banded_align_batch {label}: 16 pairs, {walk_s:.2f} s wall (device "
              f"forward and C++ host walk), mean score "
              f"{float(np.mean([r[0] for r in res])):.1f}, mean path "
              f"{float(np.mean([len(r[1]) for r in res])):.0f} cells; paths from the "
              f"origin rescored, 2 equal the oracle copy", flush=True)
    # a user's call at a width past the packed kernel's (CPL 3)
    q, t, p = adq[:16], adt[:16], ScoringParams.linear(dna_matrix(1, -1), 1)
    res = banded_align_batch(q, t, bandwidth=96)
    for b, (score, path) in enumerate(res):
        check(path[0] == (0, 0) and rescore(path, q[b], t[b], p) == score,
              f"banded_align_batch W=96: path of pair {b}")
    check(res[0] == banded_xdrop(q[0], t[0], bandwidth=96),
          "banded_align_batch W=96 vs the oracle copy")
    print(f"banded_align_batch DNA (1,1,1) W=96: 16 pairs, mean score "
          f"{float(np.mean([r[0] for r in res])):.1f}; paths from the origin "
          f"rescored, 1 equals the oracle copy", flush=True)

    # 25. banded CLI ---------------------------------------------------------
    phase("25 banded CLI: --fixed and the per-round band, DNA and protein")
    for argv, A in (
        (["banded", "--fixed", "--random", "64x128x128", "--bandwidth", "32"], 4),
        (["banded", "--fixed", "--alphabet", "protein", "--random", "32x128x128",
          "--gap-open", "11", "--gap-extend", "1", "--cigar"], 20),
        (["banded", "--random", "32x300x300", "--bandwidth", "96", "--cigar"], 4),
        (["banded", "--alphabet", "protein", "--random", "16x300x300", "--gap-open",
          "11", "--gap-extend", "1", "--x-drop", "120", "--sam"], 20),
    ):
        nb, L1, _ = (int(x) for x in argv[argv.index("--random") + 1].split("x"))
        rs = np.random.default_rng(SEED)  # the CLI's --random inputs
        cq = rs.integers(0, A, size=(nb, L1)).astype(np.uint8)
        ct = rs.integers(0, A, size=(nb, L1)).astype(np.uint8)
        lines = run_cli(cli_main, argv)
        if "--fixed" in argv:
            p = FIX_111 if A == 4 else P_GOTOH
            ok = [json.loads(x)["score"] for x in lines] == (
                sw_banded_static_score_batch(cq, ct, p, 32).tolist())
        elif A == 4:
            want = [banded_xdrop(q, t, bandwidth=96) for q, t in zip(cq, ct)]
            ok = len(lines) == nb and all(
                (r["score"], tuple(r["start"]), tuple(r["end"]), r["cigar"]) == (
                    s0, path[0], path[-1], path_to_cigar(path, q, t))
                for r, (s0, path), q, t in zip(map(json.loads, lines), want, cq, ct))
        else:
            want = [banded_affine_xdrop(q, t, 1, 1, 11, 1, x_threshold=120,
                                        matrix=BLOSUM62) for q, t in zip(cq, ct)]
            body = [x.split("\t") for x in lines if not x.startswith("@")]
            ok = len(body) == nb and all(
                (r[1] == "4" and len(path) < 2) or r[11] == f"AS:i:{s0}"
                for r, (s0, path) in zip(body, want))
        check(ok, f"{' '.join(argv[:3])} vs the oracle copy")
        print(f"{' '.join(argv[:4])} ...: {nb} records equal the oracle copy; first: "
              f"{lines[-1][:100]}", flush=True)

    banded_counts = {name: launches(name) for name in BANDED_PATH}
    print(f"banded path launches: {banded_counts}", flush=True)
    check(all(v > 0 for v in banded_counts.values()),
          f"a kernel was not launched on the banded path: {banded_counts}")

    # block tier path: counts from here to the end of phase 29 --------------
    zero_launches(BLOCK_PATH)
    b9_folded["launches"] = 0
    # 26. block tier forward ---------------------------------------------------
    phase("26 block tier forward: bench_suite's block rows at W = 64 (256 and 1024 "
          "related 2048-mers, K = 32 and 64, Gotoh 3/1, protein BLOSUM62 11/1)")
    print(smi, flush=True)
    prng = np.random.default_rng(SEED + 13)
    bpq = prng.integers(0, 24, size=(Ba, La)).astype(np.uint8)
    bpt = bpq.copy()
    for b in range(Ba):
        idx = prng.integers(0, La, La // 3)
        bpt[b, idx] = prng.integers(0, 24, La // 3)
    block_sets = {"dna": (adq_d, adt_d), "dna1024": (adq_d.repeat(4, 1), adt_d.repeat(4, 1)),
                  "protein": (torch.from_numpy(bpq).to(dev), torch.from_numpy(bpt).to(dev))}
    block_rows_spec = [
        ("DNA (1,1,1) W=64 K=32, 256 pairs", "dna", dict(block=32)),
        ("DNA (1,1,1) W=64 K=64, 256 pairs", "dna", dict(block=64)),
        ("DNA (1,1,1) W=64 K=64, 1024 pairs", "dna1024", dict(block=64)),
        ("DNA Gotoh 3/1 W=64 K=64, 256 pairs", "dna",
         dict(block=64, gap_open=3, gap_extend=1)),
        ("protein BLOSUM62 11/1 X=120 W=64 K=64, 256 pairs", "protein",
         dict(block=64, matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120)),
    ]
    for label, key, kw in block_rows_spec:
        with b9_shape(block_sets[key][0].shape[0], 64, "gap_open" in kw):
            qd, td = block_sets[key]
            K, Bb = kw["block"], qd.shape[0]
            res = kbk.banded_block_batch(qd, td, width=64, **kw)
            sec = timed(lambda q, t, kw=kw: kbk.banded_block_batch(q, t, width=64, **kw),
                        (qd, td), iters=5)
            nrows = int(res.n_rows.sum())
            # the alive band (X = 2^20, every block) is phase 42's
            # banded_block_* records, at these shapes
            fields = (res.score, res.end_y, res.end_j, res.n_rows)
            if key == "dna1024":  # four copies of the 256 pairs, checked below
                check(all(torch.equal(a[:256], b) for a, b in zip(fields, first256)),
                      f"block tier on {label}: the first 256 pairs vs the 256-pair run")
                checked = "the first 256 equal the 256-pair run"
            else:
                saved = snapshot()  # checks: the first 64 pairs against the plain version
                got64 = kbk.banded_block_batch(qd[:64], td[:64], width=64,
                                               with_history=True, with_meta=True, **kw)
                want64 = kbk.banded_block_batch_plain(qd[:64], td[:64], width=64,
                                                      with_history=True, with_meta=True,
                                                      device=dev, **kw)
                restore(saved)
                err = max_abs_err(block_fields(got64), block_fields(want64))
                name = "block_rows_small" if jax_folds(Bb, 64, "gap_open" in kw) else (
                    "block_rows")
                max_err[name] = max(max_err[name], err)
                check(err == 0 and all(torch.equal(a[:64], b) for a, b in zip(
                    fields, (got64.score, got64.end_y, got64.end_j, got64.n_rows))),
                    f"block tier on {label}: the first 64 pairs vs the plain version")
                del got64, want64
                if key == "dna" and K == 64:
                    first256 = fields
                qh, th = qd[:2].cpu().numpy(), td[:2].cpu().numpy()
                okw = dict(width=64, block=K, x_threshold=kw.get("x_threshold", 70),
                           matrix=kw.get("matrix"), return_state=True)
                for b in range(2):
                    st = (banded_xdrop_block_affine(
                        qh[b], th[b], gap_open=kw["gap_open"], gap_extend=kw["gap_extend"],
                        **okw) if "gap_open" in kw else banded_xdrop_block(qh[b], th[b], **okw))
                    check((st.score, st.end, st.n_rows) == (
                        int(res.score[b]), (int(res.end_y[b]), int(res.end_j[b])),
                        int(res.n_rows[b])), f"block tier on {label} vs the oracle copy, {b}")
                checked = ("the first 64 pairs equal the plain version in every field, 2 "
                           "the oracle copy")
            print(f"{label}: {sec * 1e3:.3f} ms per call, {nrows * 64 / sec / 1e9:.2f} band "
                  f"GCUPS over n_rows x W ({nrows} rows), {Bb / sec:.0f} alignments/s; "
                  f"mean score "
                  f"{res.score.float().mean().item():.1f}; {checked} [{smi}]", flush=True)
    del first256
    # rows 11-13: B9 on the 1024 pairs (row 11: JAX's straight kernel) and
    # the 256 pairs (row 12: where JAX folded), B10 on the 256 pairs. B9 is
    # one launch a forward: through its wrapper and alone, the state reset
    # before each; beside it, in the same run, the earlier per-block kernel
    # (a thread per pair, now the negative-gap route) replayed over each block's
    # recorded window, and the earlier whole forward (B10 and the per-block
    # B9 under the host loop); scores and endpoints, no history
    W = 64
    bc, br, bblk = block_ops(False, False, W)
    for key, b9name in (("dna1024", "block_rows"), ("dna", "block_rows_small")):
        with b9_shape(block_sets[key][0].shape[0], W, False):
            qd, td = block_sets[key]
            K = 64
            rr = kbk._setup(qd, td, 1, 1, 1, W, K, 70, None, None, False, None, None, None,
                            None, dev)
            state_of = lambda r: (r.carried, r.state, r.done, r.n_rows, r.bases,  # noqa: E731
                                  r.deltas)
            init = [x.clone() for x in state_of(rr)]

            def reset(rr=rr, init=init):
                for x, x0 in zip(state_of(rr), init):
                    x.copy_(x0)

            # every time below runs reset() before each forward and has
            # reset's own time taken off
            reset_ms = timed(reset, (), iters=5) * 1e3
            saved = snapshot()  # the row's own timings are not the path's
            kbk.block_forward(rr)
            final = [x.clone() for x in state_of(rr)]
            ms = timed(lambda rr=rr, reset=reset: (reset(), kbk.block_forward(rr)),
                       (), iters=5) * 1e3 - reset_ms
            restore(saved)
            kernel_ms = timed(
                lambda rr=rr, reset=reset: (reset(), kbk.forward_launch_t(rr)), (),
                iters=5) * 1e3 - reset_ms
            check(all(torch.equal(a, b) for a, b in zip(state_of(rr), final)),
                  f"{b9name}: repeated forwards agree")
            NB = La // K
            reset()
            wins, gbases = [], []
            for b in range(NB):
                gbases.append(rr.state[0].clone())
                wins.append(kbk.gather_launch_t(rr.t16, rr.state[0], K + W - 1))
                kbk.rows_launch_t(rr, b, K, wins[-1])
            check(all(torch.equal(a, b) for a, b in zip(state_of(rr), final)),
                  f"{b9name}: the per-block kernel vs the one-launch forward")
            check(jax_folds(qd.shape[0], W, False) == (b9name == "block_rows_small"),
                  "row 11 / 12 split")

            def replay(step, rr=rr, wins=wins, reset=reset):
                reset()
                for b in range(NB):
                    step(rr, b, K, wins[b])

            earlier_ms = timed(replay, (kbk.block_rows,), iters=5) * 1e3 - reset_ms
            earlier_kernel_ms = timed(replay, (kbk.rows_launch_t,),
                                      iters=5) * 1e3 - reset_ms
            earlier_fwd_ms = timed(
                lambda rr=rr, reset=reset: (reset(), kbk.block_loop(
                    rr, True, kbk.gather_launch_t, kbk.rows_launch_t)), (),
                iters=5) * 1e3 - reset_ms
            plain_ms = timed(replay, (kbk.block_rows_plain,), iters=1, warmup=0,
                             reps=1) * 1e3 - reset_ms
            err = max_abs_err(state_of(rr), tuple(final))
            max_err[b9name] = max(max_err[b9name], err)
            check(err == 0, f"{b9name}: the plain version differs from the kernel")
            nr = rr.n_rows.long()
            nrows, pblocks = int(nr.sum()), int(((nr + K - 1) // K).sum())
            Bq = qd.shape[0]
            ops = nrows * W * bc + nrows * br + pblocks * bblk
            # each input once (query and target codes 2 B, the start carry
            # and state), each output once (carry and state, bases / deltas)
            bytes_ = (2 * nrows + 2 * (nrows + W * Bq) + 2 * 4 * W * Bq + 2 * 16 * Bq
                      + 8 * pblocks)
            times = {"int32 ops": ops / int32_rate * 1e3, "bytes": bytes_ / HBM_BYTES_PER_S * 1e3}
            binds = max(times, key=times.get)
            rows.append(dict(
                name=b9name, route="cuda", source=f"swtpu_torch/csrc/{BLOCK}",
                replaces=KERNELS[b9name][2], launches=None, max_abs_err=max_err[b9name],
                ms=ms, plain_ms=plain_ms, bound_ms=times[binds],
                bound_by="bytes" if binds == "bytes" else "operations", library_ms=None,
                kernel_ms=kernel_ms, earlier_ms=earlier_ms,
                earlier_kernel_ms=earlier_kernel_ms))
            print(f"{b9name}, {Bq} related 2048-mers, W={W} K={K}: one launch a forward, "
                  f"wrapper {ms:.4f} ms ({times[binds] / ms:.1%} of the bound), launch "
                  f"alone {kernel_ms:.4f} ms (the state reset's {reset_ms:.4f} ms "
                  f"taken off every time here); the earlier per-block kernel over the same {NB} blocks: "
                  f"wrapper {earlier_ms:.4f} ms, launches alone {earlier_kernel_ms:.4f} "
                  f"ms ({times[binds] / earlier_kernel_ms:.1%}), the earlier forward "
                  f"(B10 and B9 a block, host poll) {earlier_fwd_ms:.4f} ms; plain "
                  f"{plain_ms:.1f} ms (equal), bound {times[binds]:.4f} ms by {binds} "
                  f"({bc} int32 ops per band cell over {nrows * W} cells, {br} per "
                  f"pair-row, {bblk} per pair-block over {pblocks}: "
                  f"{times['int32 ops']:.4f} ms; {bytes_} bytes: {times['bytes']:.4f} "
                  f"ms; at {sm_clock_mhz:.0f} MHz), {nrows * W / kernel_ms / 1e6:.2f} "
                  f"band GCUPS alone [{smi}]", flush=True)
        if key != "dna":
            continue

        def gathers(fn, t16=rr.t16, gbases=gbases, K=K):
            return [fn(t16, gbases[b], K + W - 1) for b in range(NB)]

        saved = snapshot()  # B10 is off the path: the one-launch B9 reads in place
        err = max(max_abs_err(g, w) for g, w in zip(gathers(kbk.block_gather), wins))
        err = max(err, max(max_abs_err(g, w) for g, w in
                           zip(gathers(kbk.block_gather_plain), wins)))
        max_err["block_gather"] = max(max_err["block_gather"], err)
        check(err == 0, "block_gather differs from its plain version on the 2048-mers")
        ms = timed(gathers, (kbk.block_gather,), iters=5) * 1e3
        restore(saved)
        kernel_ms = timed(gathers, (kbk.gather_launch_t,), iters=5) * 1e3
        plain_ms = timed(gathers, (kbk.block_gather_plain,), iters=1, warmup=1,
                         reps=1) * 1e3
        elems = (K + W - 1) * NB * qd.shape[0]  # B10 writes every pair's window
        times = {"int32 ops": 6 * elems / int32_rate * 1e3,
                 "bytes": (4 * elems + 4 * NB * qd.shape[0]) / HBM_BYTES_PER_S * 1e3}
        binds = max(times, key=times.get)
        rows.append(dict(
            name="block_gather", route="cuda", source=f"swtpu_torch/csrc/{BLOCK}",
            replaces=KERNELS["block_gather"][2], launches=None,
            max_abs_err=max_err["block_gather"], ms=ms, plain_ms=plain_ms,
            bound_ms=times[binds], bound_by="bytes" if binds == "bytes" else "operations",
            library_ms=None, kernel_ms=kernel_ms))
        print(f"block_gather, the same {NB} blocks: wrapper {ms:.4f} ms "
              f"({times[binds] / ms:.1%} of the bound), launches alone {kernel_ms:.4f} "
              f"ms, plain {plain_ms:.2f} ms (equal), bound {times[binds]:.4f} ms by "
              f"{binds} ({elems} window codes: 2 bytes read and 2 written each, 6 "
              f"int32 ops each)", flush=True)
    del rr, wins, gbases, init, final, block_sets
    torch.cuda.empty_cache()

    # 27. block tier traceback at reference scale ------------------------------
    phase("27 block tier traceback: banded_block_align_device on 8 related "
          "16384-mers, W = 64, K = 64, X = 70, (1,1,1)")
    lrng = np.random.default_rng(SEED + 14)
    L16 = 16384
    # 8 pairs (the 128-pair set of PRs 6-16 is cut for time: PERF.md keeps
    # its last numbers)
    q16 = lrng.integers(0, 4, size=(8, L16)).astype(np.uint8)
    t16h = np.stack([mutate(lrng, q, out_len=L16) for q in q16])
    p111 = ScoringParams.linear(dna_matrix(1, -1), 1)
    walk_times = {}  # pairs: the walkers' times on them
    for Bb in (8,):
        with b9_shape(Bb, 64, False):
            q, t = q16[:Bb], t16h[:Bb]
            with off_path():  # a warm-up, not the path's own call
                kbk.banded_block_align_device(q, t, width=64, block=64)
            t0 = time.perf_counter()
            out = kbk.banded_block_align_device(q, t, width=64, block=64)
            wall = time.perf_counter() - t0
            for b, (score, path) in enumerate(out):
                check(path[0] == (0, 0) and rescore(path, q[b], t[b], p111) == score,
                      f"16K block traceback: path of pair {b}")
            # where the wall goes: the forward with its history and the walk on
            # staged tensors (CUDA events), the host decode of the wire alone;
            # these checks and timings are not the path's own launches
            saved = snapshot()
            run = kbk._setup(q, t, 1, 1, 1, 64, 64, 70, None, None, True, None, None, None,
                             None, dev)
            def fresh(run=run):
                return kbk._new_run(run.qT, run.t16, None, None, None, None, 64, 64, 70,
                                    1, 1, 1, None, None, 32, True)

            fwd_ms = timed(lambda: kbk._forward(fresh()), (), iters=2) * 1e3
            # beside it, the earlier forward: B10 and the per-block B9 a block
            earlier_fwd_ms = timed(lambda: kbk.block_loop(
                fresh(), True, kbk.gather_launch_t, kbk.rows_launch_t), (), iters=2) * 1e3
            kbk._forward(run)
            wire = kdw.block_walk(run).cpu()
            want = kdw.block_walk_plain(run)  # the host walk on every pair
            err = max_abs_err(wire, want)
            max_err["block_walk"] = max(max_err["block_walk"], err)
            check(err == 0, f"block_walk differs from its plain version at {Bb} x 16K")
            check(torch.equal(kdw._block_serial_launch_t(run).cpu(), want),
                  "16K block walk: the earlier serial kernel")
            groups = (1, kdw.GROUP)
            for G in groups:
                check(torch.equal(kdw.block_walk_launch_t(run, _group=G).cpu(), want),
                      f"16K block walk: {G} pairs a producer CTA")
            # the map kernel through its wrapper and alone (its default, and
            # a pair / GROUP pairs a producer CTA), the earlier serial kernel
            # alone, and a step's share of each
            walk_ms = timed(kdw.block_walk, (run,), iters=5) * 1e3
            kernel_ms = timed(kdw.block_walk_launch_t, (run,), iters=5) * 1e3
            group_ms = {G: timed(lambda G=G: kdw.block_walk_launch_t(run, _group=G), (),
                                 iters=5) * 1e3 for G in groups}
            serial_ms = timed(kdw._block_serial_launch_t, (run,), iters=2) * 1e3
            restore(saved)
            nsteps = np.ascontiguousarray(wire[:, 12:16].numpy()).view("<i4").ravel()
            walk_times[Bb] = dict(ms=walk_ms, kernel_ms=kernel_ms, earlier_kernel_ms=serial_ms,
                                  group=kdw.default_group(Bb),
                                  kernel_ms_by_group={str(G): v for G, v in group_ms.items()},
                                  steps=int(nsteps.sum()), longest=int(nsteps.max()))
            arr_ms, list_ms = decode_times(decode_device_walk, wire)
            check(decode_device_walk(wire) == out, "16K block traceback: decode")
            check([s0 for s0, _ in out] == (run.state[1] - 70).cpu().tolist(),
                  "16K block traceback: scores vs the forward")
            out8, walk_run, walk_wire = out, run, wire
            by_group = ", ".join(f"{G} a CTA {v:.4f} ms ({v * 1e6 / nsteps.max():.1f} ns a "
                                 f"step)" for G, v in group_ms.items())
            print(f"{Bb} pairs: {wall * 1e3:.1f} ms wall (upload, forward, device walk, "
                  f"wire fetch, decode to lists), {Bb / wall:.1f} alignments/s; on staged "
                  f"tensors the forward with history {fwd_ms:.1f} ms (the earlier "
                  f"per-block forward {earlier_fwd_ms:.1f} ms), the walk {walk_ms:.3f} ms "
                  f"(the earlier serial kernel {serial_ms:.3f} ms), the C++ host decode "
                  f"{list_ms:.1f} ms to tuple lists ({arr_ms:.1f} ms to arrays, "
                  f"bench_suite's): forward + walk + decode {fwd_ms + walk_ms + list_ms:.1f} "
                  f"ms of the wall; mean path {np.mean([len(p) for _, p in out]):.0f} "
                  f"cells, mean score {np.mean([s0 for s0, _ in out]):.1f}; paths from the "
                  f"origin rescored; the wire equals the plain version's and the serial "
                  f"kernel's; the map kernel alone by pairs a producer CTA: {by_group} "
                  f"(default {kdw.default_group(Bb)}) [{smi}]", flush=True)
    check(out8[0] == banded_xdrop_block(q16[0], t16h[0], width=64, block=64),
          "16K block traceback vs the oracle copy, pair 0")
    # the block walker's row on the 8 pairs
    run, wire = walk_run, walk_wire
    plain_ms = timed(kdw.block_walk_plain, (run,), iters=1, warmup=0, reps=1) * 1e3

    def walk_bound(steps, wire_bytes):
        times = {"int32 ops": steps * WALK_OPS / int32_rate * 1e3,
                 "bytes": (steps * 24 + wire_bytes) / HBM_BYTES_PER_S * 1e3}
        binds = max(times, key=times.get)
        return times[binds], "bytes" if binds == "bytes" else "operations"

    def walk_row(name, t, plain_ms, wire_bytes, **extra):
        bound, by = walk_bound(t["steps"], wire_bytes)
        per_step = {k.replace("ms", "ns_a_step"): t[k] * 1e6 / t["longest"]
                    for k in ("kernel_ms", "earlier_kernel_ms")}
        rows.append(dict(
            name=name, route="cuda", source=f"swtpu_torch/csrc/{WALK}",
            replaces=KERNELS[name][2], launches=None, max_abs_err=max_err[name],
            ms=t["ms"], plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
            kernel_ms=t["kernel_ms"], earlier_kernel_ms=t["earlier_kernel_ms"], **per_step,
            **{k: t[k] for k in ("group", "kernel_ms_by_group") if k in t}, **extra))
        print(f"{name}, {t['steps']} steps (longest pair {t['longest']}): wrapper "
              f"{t['ms']:.4f} ms, launch alone {t['kernel_ms']:.4f} ms "
              f"({per_step['kernel_ns_a_step']:.1f} ns a step of the longest pair, "
              f"{bound / t['kernel_ms']:.2%} of the bound), the earlier serial kernel "
              f"{t['earlier_kernel_ms']:.4f} ms ({per_step['earlier_kernel_ns_a_step']:.1f} "
              f"ns a step, {t['earlier_kernel_ms'] / t['kernel_ms']:.1f}x); plain (host "
              f"walk, encoded) {plain_ms:.1f} ms, equal wires; bound {bound:.4f} ms by {by} "
              f"({WALK_OPS} int32 ops and 24 bytes a step: the walk is a chain of "
              f"dependent steps, so latency binds it) [{smi}]", flush=True)

    walk_row("block_walk", walk_times[8], plain_ms, wire.numel())
    del run, wire, walk_run, walk_wire
    torch.cuda.empty_cache()

    # 28. per-round band at reference scale: the device walk --------------------
    phase("28 per-round band at reference scale: banded_align_batch on 8 related "
          "16384-mers, W = 32, X = 70 (linear: the walk runs on the card)")
    q, t = q16[:8], t16h[:8]
    with off_path():  # a warm-up, not the path's own call
        banded_align_batch(q, t)
    before = kdw.xdrop_walk.launches
    t0 = time.perf_counter()
    out = banded_align_batch(q, t)
    wall = time.perf_counter() - t0
    check(kdw.xdrop_walk.launches == before + 1, "banded_align_batch at 16K walks on the card")
    saved = snapshot()
    t0 = time.perf_counter()
    host = banded_walk_batch(q, t, banded_forward_batch(q, t))
    host_s = time.perf_counter() - t0
    res = kbb.banded_batch(q, t, bandwidth=32, compress_history=False)
    restore(saved)
    check(out == host, "16K per-round: the device walk vs the host walk")
    for b, (score, path) in enumerate(out):
        check(path[0] == (0, 0) and rescore(path, q[b], t[b], p111) == score,
              f"16K per-round traceback: path of pair {b}")
    check(out[0] == banded_xdrop(q[0], t[0]), "16K per-round vs the oracle copy")
    print(f"8 pairs: {wall * 1e3:.1f} ms wall (upload, per-round forward, device walk, "
          f"wire, C++ decode) against {host_s * 1e3:.1f} ms with the C++ host walk over "
          f"the 8-bit history; equal paths, rescored, 1 equals the oracle copy; mean path "
          f"{np.mean([len(p) for _, p in out]):.0f} cells [{smi}]", flush=True)
    saved = snapshot()  # the checks and the row's own timings are not the path's
    q_d, t_d = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
    pad = _prep_padded(q_d, t_d, None, None, 32, dev, torch.int16)
    pad32 = (*pad[:2], pad[2].int(), pad[3].int())
    wire = kdw.xdrop_walk(res, pad)
    fwd_ms = timed(lambda: kbb.banded_batch(q_d, t_d, bandwidth=32,
                                                  compress_history=False),
                   (), iters=2) * 1e3
    arr_ms, list_ms = decode_times(decode_device_walk, wire.cpu())
    check(decode_device_walk(wire.cpu()) == out, "16K per-round: decode")
    plain_ms = timed(kdw.xdrop_walk_plain, (res, pad), iters=1, warmup=0,
                     reps=1) * 1e3
    err = max_abs_err(wire.cpu(), kdw.xdrop_walk_plain(res, pad))
    max_err["xdrop_walk"] = max(max_err["xdrop_walk"], err)
    check(err == 0, "xdrop_walk differs from its plain version at 16K")
    check(torch.equal(kdw._xdrop_serial_launch_t(res, pad32, 32, 70, 1, 1, 1), wire),
          "16K per-round walk: the earlier serial kernel")
    ms = timed(kdw.xdrop_walk, (res, pad), iters=5) * 1e3
    kernel_ms = timed(kdw.xdrop_walk_launch_t, (res, pad32, 32, 70, 1, 1, 1),
                      iters=5) * 1e3
    serial_ms = timed(kdw._xdrop_serial_launch_t, (res, pad32, 32, 70, 1, 1, 1),
                      iters=2) * 1e3
    restore(saved)
    nsteps = np.ascontiguousarray(wire[:, 12:16].cpu().numpy()).view("<i4").ravel()
    print(f"on staged tensors: the per-round forward with its int32 history "
          f"{fwd_ms:.1f} ms, the walk {ms:.3f} ms (the earlier serial kernel "
          f"{serial_ms:.3f} ms), the C++ host decode {list_ms:.1f} ms to tuple lists "
          f"({arr_ms:.1f} ms to arrays): forward + walk + decode "
          f"{fwd_ms + ms + list_ms:.1f} ms of the {wall * 1e3:.1f} ms wall", flush=True)
    walk_row("xdrop_walk", dict(ms=ms, kernel_ms=kernel_ms, earlier_kernel_ms=serial_ms,
                                steps=int(nsteps.sum()), longest=int(nsteps.max())),
             plain_ms, wire.numel())
    del res, pad, wire, q16, t16h
    torch.cuda.empty_cache()

    # 29. the banded --block-adaptive CLI ---------------------------------------
    phase("29 banded --block-adaptive CLI: DNA, protein, Gotoh, per-pair lengths, "
          "--traceback / --cigar, and the two refusals")
    crng = np.random.default_rng(SEED + 15)
    tmp = tempfile.TemporaryDirectory()
    fq, ft = Path(tmp.name) / "q.fa", Path(tmp.name) / "t.fa"
    vq = [crng.integers(0, 4, int(crng.integers(300, 1201))).astype(np.uint8)
          for _ in range(8)]
    vt = [mutate(crng, q_) for q_ in vq]
    write_fasta(str(fq), [(f"q{p}", decode_dna(x)) for p, x in enumerate(vq)])
    write_fasta(str(ft), [(f"t{p}", decode_dna(x)) for p, x in enumerate(vt)])

    def cli_random(spec, A):
        b_, n_, m_ = (int(x) for x in spec.split("x"))
        rs = np.random.default_rng(SEED)  # the CLI's --random inputs
        return (list(rs.integers(0, A, size=(b_, n_)).astype(np.uint8)),
                list(rs.integers(0, A, size=(b_, m_)).astype(np.uint8)))

    cli_cases = [
        (["--random", "16x2048x2048", "--bandwidth", "32"], 4, dict()),
        (["--random", "8x1024x1024", "--bandwidth", "32", "--traceback", "--cigar"], 4,
         dict()),
        (["--alphabet", "protein", "--random", "8x600x600", "--bandwidth", "32",
          "--x-drop", "120"], 20, dict(matrix=BLOSUM62, x_threshold=120)),
        (["--random", "8x1024x1024", "--bandwidth", "32", "--gap-open", "3",
          "--gap-extend", "1"], 4, dict(gap_open=3, gap_extend=1)),
        (["--queries", str(fq), "--targets", str(ft), "--bandwidth", "32", "--traceback"],
         4, dict()),
    ]
    for argv, A, kw in cli_cases:
        if "--random" in argv:
            cq, ct = cli_random(argv[argv.index("--random") + 1], A)
            names = [f"pair{p}" for p in range(len(cq))]
        else:
            cq, ct, names = vq, vt, [f"q{p}|t{p}" for p in range(len(vq))]
        with b9_shape(len(cq), 64, "gap_open" in kw):
            lines = [json.loads(x) for x in run_cli(
                cli_main, ["banded", "--block-adaptive"] + argv)]
        okw = dict(width=64, block=32, x_threshold=kw.get("x_threshold", 70),
                   matrix=kw.get("matrix"))
        ok = len(lines) == len(cq)
        for rec, name, q_, t_ in zip(lines, names, cq, ct):
            if "gap_open" in kw:
                st = banded_xdrop_block_affine(q_, t_, gap_open=3, gap_extend=1,
                                               return_state=True, **okw)
            else:
                st = banded_xdrop_block(q_, t_, return_state=True, **okw)
            want = dict(pair=name, score=st.score)
            if "--traceback" in argv or "--cigar" in argv:
                want.update(start=list(st.path[0]), end=list(st.path[-1]))
                if "--traceback" in argv:
                    want["path"] = [list(x) for x in st.path]
                if "--cigar" in argv:
                    want["cigar"] = path_to_cigar(st.path, q_, t_)
            else:
                want["end"] = list(st.end)
            ok = ok and rec == want
        check(ok, f"banded --block-adaptive {' '.join(argv[:2])} vs the oracle copy")
        print(f"banded --block-adaptive {' '.join(argv)}: {len(lines)} records equal "
              f"the oracle copy's; first: {json.dumps(lines[0])[:100]}", flush=True)
    for argv, msg in ((["--random", "2x64x64", "--gap-open", "3", "--cigar"],
                       "affine traceback"),
                      (["--queries", str(fq), "--targets", str(ft), "--gap-open", "3"],
                       "uniform lengths")):
        try:
            run_cli(cli_main, ["banded", "--block-adaptive"] + argv)
            check(False, f"banded --block-adaptive {argv} ran")
        except SystemExit as e:
            check(msg in str(e), f"banded --block-adaptive refusal: {e}")
            print(f"banded --block-adaptive refuses ({msg}): {e}", flush=True)
    tmp.cleanup()
    block_counts = {name: launches(name) for name in BLOCK_PATH}
    print(f"block tier path launches: {block_counts} (B10 launches only on the "
          f"negative-gap route: the one-launch B9 reads the corridor window in "
          f"place; of B9's, {kbk.block_forward.launches} one-launch forwards, "
          f"{kbk.block_rows.launches} per-block launches)", flush=True)
    check(kbk.block_rows.launches == 0 and block_counts["block_gather"] == 0,
          "the block tier path's forwards are one launch each (no B10, no per-block B9)")
    check(all(v > 0 for k, v in block_counts.items() if k != "block_gather"),
          f"a kernel was not launched on the block tier path: {block_counts}")

    # long-pair path: counts from here to the end of phase 33 ------------------
    zero_launches(LONGPAIR_PATH)
    # 30. long pairs on one card ------------------------------------------------
    phase("30 long pairs: longpair_sw_ends / longpair_sw_score on one related 16384 x "
          "16384 DNA pair, (1,-1,1) and Gotoh (2,-3,5,1)")
    print(smi, flush=True)
    lrng = np.random.default_rng(SEED)
    L = 16384
    lq = lrng.integers(0, 4, L).astype(np.uint8)
    # ~85% identity: 10% substitutions, 2.5% insertions and deletions
    lt = mutate(lrng, lq, p_mismatch=0.1, p_insert=0.025, p_delete=0.025, out_len=L)
    LP_GOTOH = ScoringParams(dna_matrix(2, -3), 5, 1)
    i32 = dict(dtype=torch.int32, device=dev)
    zl, nl = torch.zeros(L, **i32), torch.full((L,), NEGB, **i32)
    zl1, nl1 = torch.zeros(L + 1, **i32), torch.full((L + 1,), NEGB, **i32)
    strip_timed, lp_ends, strip_br_ms = {}, {}, {}

    def br_sweep(label, sargs, out, rounds=3):
        """B13 alone at every rows-a-lane (1, 2, 4, 8, 16) on one staged tile,
        each held equal to ``out``: the least of ``rounds`` interleaved
        timings (a card's clocks drift within a run), printed beside
        strip_plan's pick. PERF.md section 6 reads the rule from these."""
        R, C = int(sargs[0].shape[0]), int(sargs[1].shape[0])
        by_br = {}
        for br in (1, 2, 4, 8, 16):
            got = kls._pipe_launch(*sargs, br=br)[0]
            check(all(torch.equal(a, b) for a, b in zip(got, out)),
                  f"B13 at {br} rows a lane differs on {label}")
        for _ in range(rounds):
            for br in (1, 2, 4, 8, 16):
                ms_ = timed(lambda br=br: kls._pipe_launch(*sargs, br=br), (),
                            iters=2, warmup=1, reps=1) * 1e3
                by_br[br] = min(by_br.get(br, float("inf")), ms_)
        pick = kls.strip_plan(R, C)[0]
        fastest = min(by_br, key=by_br.get)
        strip_br_ms[label] = dict(by_br=by_br, pick=pick, fastest=fastest)
        print(f"B13 alone on {label} by rows a lane (bands): " + ", ".join(
            f"{br} ({-(-R // (32 * br))}): {t_:.4f} ms" for br, t_ in by_br.items())
            + f"; strip_plan picks {pick} ({by_br[pick]:.4f} ms), the fastest is "
            f"{fastest} ({by_br[pick] / by_br[fastest] - 1:.1%} slower) [{smi}]",
            flush=True)
    # B13's main-path launches by tile size (PERF.md splits its row by size)
    strip_sizes = {"16384 x 16384": 0, "4096 x 4096": 0, "wavefront queries": 0,
                   "CLI tiles": 0}
    strip_mark = [launches("strip_tile")]

    def strip_count(size):
        now = launches("strip_tile")
        strip_sizes[size] += now - strip_mark[0]
        strip_mark[0] = now
    for label, p in (("(1,-1,1)", DNA_111), ("Gotoh (2,-3,5,1)", LP_GOTOH)):
        before = launches("strip_tile")
        ends = lp.longpair_sw_ends(lq, lt, p)
        lp_ends[label] = ends
        per_sweep = launches("strip_tile") - before
        check(lp.longpair_sw_score(lq, lt, p) == ends[0] > 0,
              f"longpair_sw_score vs _ends on {label}")
        walls = []
        for _ in range(3):  # the wall's repeats are not the path's own calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with off_path():
                again = lp.longpair_sw_ends(lq, lt, p)
            walls.append(time.perf_counter() - t0)
            check(again == ends, f"longpair_sw_ends on {label} is repeatable")
        wall_ms = min(walls) * 1e3
        # B13 alone on the sweep's one tile, its inputs staged on the card
        q8, t8 = kls.stage_codes(lq, p, dev), kls.stage_codes(lt, p, dev)
        table = kp.profile_table(p, dev)
        affine = not p.is_linear

        sargs = (q8, t8, table, zl, nl if affine else None, zl1, nl1 if affine else None,
                 p)

        def bare(launch=kls.strip_launch_t, sargs=sargs):
            return launch(*sargs)

        out, grid = kls._pipe_launch(*sargs)
        check(tuple(int(x) for x in out[-3:]) == ends, f"B13 alone vs the sweep, {label}")
        check(all(torch.equal(a, b) for a, b in zip(out, bare(kls._one_block_launch_t))),
              f"B13's pipelined and one-block kernels on the 16K tile, {label}")
        kernel_ms = timed(bare, (), iters=3, warmup=1) * 1e3
        earlier_ms = timed(bare, (kls._one_block_launch_t,), iters=3, warmup=1) * 1e3
        strip_timed[label] = (kernel_ms, earlier_ms)
        br_sweep(f"16384 x 16384 {label}", sargs, out)
        print(f"{label}: (score, end_i, end_j) = {ends}; block {L} (the default), "
              f"{per_sweep} B13 launch a sweep; longpair_sw_ends {wall_ms:.3f} ms wall "
              f"({L * L / wall_ms / 1e6:.2f} GCUPS); B13 alone {kernel_ms:.3f} ms "
              f"({L * L / kernel_ms / 1e6:.2f} GCUPS: rows a lane and bands "
              f"{kls.strip_plan(L, L)}, {grid} warps, one a CTA, on {n_sm} SMs); the "
              f"one-block kernel beside it {earlier_ms:.3f} ms (one CTA)", flush=True)
    strip_count("16384 x 16384")
    # B13's row: a related 4096 x 4096 pair's linear tile (the size of
    # phase 31's sweeps) through the wrapper, alone, and the plain tile on
    # the card once (its time, and every return held equal)
    q4 = lrng.integers(0, 4, 4096).astype(np.uint8)
    t4 = mutate(lrng, q4, p_mismatch=0.1, p_insert=0.025, p_delete=0.025)
    p = DNA_111
    q8, t8 = kls.stage_codes(q4, p, dev), kls.stage_codes(t4, p, dev)
    table = kp.profile_table(p, dev)
    z, z1 = torch.zeros(4096, **i32), torch.zeros(4097, **i32)

    sargs = (q8, t8, table, z, None, z1, None, DNA_111)

    def bare(launch=kls.strip_launch_t, sargs=sargs):
        return launch(*sargs)

    ms = timed(lambda: kls.tile_strip_linear(q8, t8, z, z1, p, table=table), (),
               iters=5) * 1e3
    kernel_ms = timed(bare, (), iters=5) * 1e3
    earlier_ms = timed(bare, (kls._one_block_launch_t,), iters=5) * 1e3
    t0 = time.perf_counter()
    want = strip_plain(q4, t4, (z, None, z, None, 0), p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_abs_err(bare(), want), max_abs_err(bare(kls._one_block_launch_t), want))
    br_sweep("4096 x 4096 (1,-1,1)", sargs, bare())
    max_err["strip_tile"] = max(max_err["strip_tile"], err)
    check(err == 0, "B13 differs from the plain tile on the 4096 x 4096 linear tile")
    cells = 4096 * 4096
    times = {"int32 ops": cells * strip_ops(False) / int32_rate * 1e3,
             "shared-memory lookups": cells / lookup_rate * 1e3,
             "bytes": (2 * 4096 + 4 * (2 * 4096 + 1) + 4 * 2 * 4096 + 12)
             / HBM_BYTES_PER_S * 1e3}
    binds = max(times, key=times.get)
    rows.append(dict(
        name="strip_tile", route="cuda", source=f"swtpu_torch/csrc/{STRIP}",
        replaces=KERNELS["strip_tile"][2], launches=None,
        max_abs_err=max_err["strip_tile"], ms=ms, plain_ms=plain_ms,
        bound_ms=times[binds], bound_by="bytes" if binds == "bytes" else "operations",
        library_ms=None, kernel_ms=kernel_ms, earlier_kernel_ms=earlier_ms))
    (lin16, lin16_old), (aff16, aff16_old) = (strip_timed["(1,-1,1)"],
                                              strip_timed["Gotoh (2,-3,5,1)"])
    aff_bound = 16 * cells * strip_ops(True) / int32_rate * 1e3
    rows[-1].update(kernel_ms_16k=lin16, earlier_kernel_ms_16k=lin16_old,
                    bound_ms_16k=16 * times["int32 ops"], kernel_ms_16k_gotoh=aff16,
                    earlier_kernel_ms_16k_gotoh=aff16_old, bound_ms_16k_gotoh=aff_bound)
    print(f"strip_tile (B13), a related 4096 x 4096 linear tile: wrapper {ms:.3f} ms "
          f"({times[binds] / ms:.2%} of the bound), launch alone {kernel_ms:.3f} ms "
          f"(rows a lane and bands {kls.strip_plan(4096, 4096)}; the one-block kernel "
          f"{earlier_ms:.3f} ms), plain tile {plain_ms:.1f} ms (every return equal), "
          f"bound {times[binds]:.4f} ms by {binds} ({strip_ops(False)} int32 ops a "
          f"cell: {times['int32 ops']:.4f} ms; one lookup a cell: "
          f"{times['shared-memory lookups']:.4f} ms; at {sm_clock_mhz:.0f} MHz); at "
          f"16384 x 16384 alone {lin16:.3f} ms linear ("
          f"{16 * times['int32 ops'] / lin16:.2%} of its bound; one-block "
          f"{lin16_old:.3f} ms), {aff16:.3f} ms Gotoh ({aff_bound / aff16:.2%} of its "
          f"bound {aff_bound:.4f} ms; one-block {aff16_old:.3f} ms)", flush=True)
    # strip_plan's rule against every rows-a-lane on the other tile shapes:
    # square, tall, wide, thin, the wavefront's long queries, a short strip
    swrng = np.random.default_rng(SEED + 19)
    for R, C, p in ((1024, 1024, DNA_111), (4096, 4096, LP_GOTOH), (16384, 4096, DNA_111),
                    (4096, 16384, DNA_111), (16384, 64, DNA_111), (1024, 256, DNA_111),
                    (512, 384, DNA_111), (1499, 700, DNA_111), (40, 1024, DNA_111)):
        sq = swrng.integers(0, 4, R).astype(np.uint8)
        st = mutate(swrng, np.resize(sq, C), p_mismatch=0.1, out_len=C)
        affine = not p.is_linear
        zc, nc = torch.zeros(C, **i32), torch.full((C,), NEGB, **i32)
        zr, nr = torch.zeros(R + 1, **i32), torch.full((R + 1,), NEGB, **i32)
        sargs = (kls.stage_codes(sq, p, dev), kls.stage_codes(st, p, dev),
                 kp.profile_table(p, dev), zc, nc if affine else None, zr,
                 nr if affine else None, p)
        br_sweep(f"{R} x {C} {'Gotoh (2,-3,5,1)' if affine else '(1,-1,1)'}", sargs,
                 kls.strip_launch_t(*sargs))
    regret = {k: v["by_br"][v["pick"]] / v["by_br"][v["fastest"]] - 1
              for k, v in strip_br_ms.items()}
    worst = max(regret, key=regret.get)
    print(f"strip_plan's pick against the fastest rows a lane on {len(regret)} tiles: "
          f"{sum(r == 0 for r in regret.values())} the fastest, the worst {worst} "
          f"{regret[worst]:.1%} slower [{smi}]", flush=True)
    del strip_timed, strip_br_ms, bare, q8, t8, want

    # 31. long-pair traceback -------------------------------------------------
    phase("31 long-pair traceback: longpair_sw_align on the 16K linear pair and a "
          "Gotoh 4096 x 4096 pair; a BLOSUM62 11/1 4096 x 4096 pair")

    def long_align(label, q, t, p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ends = lp.longpair_sw_ends(q, t, p)
        fwd = time.perf_counter() - t0
        t0 = time.perf_counter()
        score, path = lp.longpair_sw_align(q, t, p)
        wall = time.perf_counter() - t0
        check(score == ends[0] > 0 and tuple(path[-1]) == ends[1:]
              and rescore(path, q, t, p) == score,
              f"longpair_sw_align on {label}: path vs the device forward")
        print(f"{label}: score {score}, end {path[-1]}, start {path[0]}, {len(path)} "
              f"path cells rescored; longpair_sw_align {wall:.2f} s wall (device "
              f"forward {fwd * 1e3:.1f} ms, C++ low-memory host walk {wall - fwd:.2f} s)",
              flush=True)
        return score, path

    strip_mark[0] = launches("strip_tile")  # the row's timing above is restored
    lin = long_align("16384 x 16384 (1,-1,1)", lq, lt, DNA_111)
    strip_count("16384 x 16384")
    # the 16K sweeps against an independent forward: the host's full
    # low-memory pass finds the matrix maximum and its row-major-first cell
    for label, p in (("(1,-1,1)", DNA_111), ("Gotoh (2,-3,5,1)", LP_GOTOH)):
        t0 = time.perf_counter()
        sc, path = sw_traceback_lowmem(lq, lt, p, ends=None)
        host_s = time.perf_counter() - t0
        check((sc, *path[-1]) == lp_ends[label] and rescore(path, lq, lt, p) == sc,
              f"the 16K {label} sweep vs the host's full forward")
        if p is DNA_111:
            check((sc, path) == lin, "longpair_sw_align's 16K path vs the host's "
                  "full forward and walk")
        print(f"16384 x 16384 {label}: the host's full forward and walk "
              f"(sw_traceback_lowmem in C++, no ends, {host_s:.2f} s) give "
              f"{(sc, *path[-1])}, the sweep's (score, end_i, end_j)", flush=True)
    pq = lrng.integers(0, 20, 4096).astype(np.uint8)
    pt = pq.copy()
    sub = lrng.random(4096) < 0.15
    pt[sub] = lrng.integers(0, 20, int(sub.sum()))
    pt = np.concatenate([lrng.integers(0, 20, 7).astype(np.uint8), pt])[:4096]
    z4, n4 = np.zeros(4096), np.full(4096, NEGB)
    for label, q_, t_, p in (("4096 x 4096 Gotoh (2,-3,5,1)", q4, t4, LP_GOTOH),
                             ("4096 x 4096 protein BLOSUM62 11/1", pq, pt, P_GOTOH)):
        score, path = long_align(label, q_, t_, p)
        want = strip_plain(q_, t_, (z4, n4, z4, n4, 0), p)
        check(tuple(int(x) for x in want[-3:]) == (score, *path[-1]),
              f"the {label} sweep vs the plain tile")
    print("the 4096 x 4096 sweeps equal the plain tile's (best, end_i, end_j)",
          flush=True)
    del zl, nl, zl1, nl1

    # 32. the wavefront schedule ----------------------------------------------
    phase("32 the wavefront schedule (align --engine wavefront): 128 and 8192 pairs of "
          "128 x 128, (10,-30,15), (1,-1,1), BLOSUM62 11; queries past 128")
    print(smi, flush=True)
    wrng = np.random.default_rng(SEED + 17)
    for label, p, B, letters in (
            ("(10,-30,15)", DNA_10_30_15, 128, 4), ("(10,-30,15)", DNA_10_30_15, 8192, 4),
            ("(1,-1,1)", DNA_111, 128, 4), ("(1,-1,1)", DNA_111, 8192, 4),
            ("BLOSUM62 11", P_LIN, 128, 20), ("BLOSUM62 11", P_LIN, 8192, 20)):
        qd = torch.from_numpy(wrng.integers(0, letters, (B, 128)).astype(np.uint8)).to(dev)
        td = torch.from_numpy(wrng.integers(0, letters, (B, 128)).astype(np.uint8)).to(dev)
        fn = variant_engine("wavefront", p, 128)
        got = fn(qd, td)
        ms = timed(fn, (qd, td), iters=20) * 1e3
        saved = snapshot()  # the check runs another path's kernel
        check(torch.equal(got, best_engine(p)(qd, td)),
              f"wavefront vs best_engine, {label}, {B} pairs")
        restore(saved)
        pairs = kwf.wavefront_stream(B, 128, 128, n_sm, p.alphabet_size)
        print(f"wavefront {label}, {B} pairs of 128 x 128 ({pairs} pairs a stream): "
              f"{ms:.4f} ms a call, {B * 128 * 128 / ms / 1e6:.1f} GCUPS; equal to "
              "best_engine's kernel", flush=True)
        if B == 8192 and p is DNA_10_30_15:  # B14's row
            wms = timed(kwf.sw_wavefront, (qd, td, p), iters=20) * 1e3
            wtable = kwf.wavefront_table(p, dev)
            kernel_ms = timed(kwf.wavefront_launch_t, (qd, td, wtable, p),
                              iters=20) * 1e3
            plain_ms = timed(kwf.sw_wavefront_plain, (qd, td, p), iters=1,
                             warmup=1, reps=1) * 1e3
            cells = B * 128 * 128
            times = {"int32 ops": cells * pipe_slots("sw_wavefront") / int32_rate * 1e3,
                     "shared-memory lookups":
                         cells * KERNELS["sw_wavefront"][4] / lookup_rate * 1e3,
                     "bytes": (B * 256 + 4 * B) / HBM_BYTES_PER_S * 1e3}
            binds = max(times, key=times.get)
            rows.append(dict(
                name="sw_wavefront", route="cuda", source=f"swtpu_torch/csrc/{WAVEFRONT}",
                replaces=KERNELS["sw_wavefront"][2], launches=None,
                max_abs_err=max_err["sw_wavefront"], ms=wms, plain_ms=plain_ms,
                bound_ms=times[binds],
                bound_by="bytes" if binds == "bytes" else "operations",
                library_ms=None, kernel_ms=kernel_ms))
            print(f"sw_wavefront (B14), 8192 x 128 x 128 (10,-30,15): wrapper {wms:.4f} "
                  f"ms ({times[binds] / wms:.1%} of the bound), launch alone "
                  f"{kernel_ms:.4f} ms ({times[binds] / kernel_ms:.1%}), plain "
                  f"{plain_ms:.1f} ms, bound {times[binds]:.4f} ms by {binds} "
                  f"({KERNELS['sw_wavefront'][3]} int32 ops a real cell, "
                  f"{ALU_OPS['sw_wavefront']} on the ALU, by pipe: {times['int32 ops']:.4f} ms; "
                  f"{KERNELS['sw_wavefront'][4]} lookups: "
                  f"{times['shared-memory lookups']:.4f} ms)", flush=True)
    strip_count("4096 x 4096")
    for B, n, m in ((2, 512, 384), (2, 1024, 256)):
        qd = torch.from_numpy(wrng.integers(0, 4, (B, n)).astype(np.uint8)).to(dev)
        td = torch.from_numpy(wrng.integers(0, 4, (B, m)).astype(np.uint8)).to(dev)
        fn = variant_engine("wavefront", DNA_111, n)
        before = launches("strip_tile")
        got = fn(qd, td)
        per = launches("strip_tile") - before
        ms = timed(fn, (qd, td), iters=3) * 1e3
        saved = snapshot()
        check(torch.equal(got, best_engine(DNA_111)(qd, td)) and per == B,
              f"wavefront on {B} x ({n} x {m}): the strip tile, a launch a pair")
        restore(saved)
        print(f"wavefront on {B} x ({n} x {m}): {per} strip-tile launches a call (one a "
              f"pair), {ms:.3f} ms; equal to best_engine's kernel", flush=True)
    del qd, td

    # 33. the longpair CLI and align --engine wavefront -------------------------
    strip_count("wavefront queries")
    phase("33 the longpair CLI and align --engine wavefront against the oracle copy")
    for argv, A, p in (
            (["longpair", "--random", "2x1200x1000", "--cigar"], 4, DNA_111),
            (["longpair", "--alphabet", "protein", "--random", "1x900x800", "--gap-open",
              "11", "--gap-extend", "1", "--traceback"], 20, P_GOTOH)):
        lines = [json.loads(x) for x in run_cli(cli_main, argv)]
        cq, ct = cli_random(argv[argv.index("--random") + 1], A)
        ok = len(lines) == len(cq)
        for k, (rec, q_, t_) in enumerate(zip(lines, cq, ct)):
            sc, path = (sw_traceback if p.is_linear else sw_affine_traceback)(q_, t_, p)
            want = dict(pair=f"pair{k}", score=sc)
            if "--traceback" in argv:
                want["path"] = [list(x) for x in path]
            if "--cigar" in argv:
                want["cigar"] = path_to_cigar(path, q_, t_, query_len=len(q_))
            ok = ok and rec == want
        check(ok, f"{' '.join(argv[:4])} vs the oracle copy")
        print(f"{' '.join(argv)}: {len(lines)} records equal the oracle copy's; first: "
              f"{json.dumps(lines[0])[:100]}", flush=True)
    argv = ["align", "--random", "128x128x128", "--scoring", "10,-30", "--gap", "15",
            "--engine", "wavefront"]
    lines = [json.loads(x)["score"] for x in run_cli(cli_main, argv)]
    cq, ct = cli_random("128x128x128", 4)
    check(lines == sw_score_batch(np.stack(cq), np.stack(ct), DNA_10_30_15).tolist(),
          "align --engine wavefront vs the oracle copy")
    print(f"{' '.join(argv)}: 128 scores equal the oracle copy's", flush=True)
    strip_count("CLI tiles")
    print(f"B13 launches on the long-pair path by tile size: {strip_sizes}", flush=True)
    longpair_counts = {name: launches(name) for name in LONGPAIR_PATH}
    print(f"long-pair path launches: {longpair_counts}", flush=True)
    check(all(v > 0 for v in longpair_counts.values()),
          f"a kernel was not launched on the long-pair path: {longpair_counts}")
    # 34. search -------------------------------------------------------------
    zero_launches(SEARCH_PATH)
    phase("34 search at BASELINE config 5's one-card scale: all_vs_all_topk, 16 queries "
          "x 131,072 targets of 128, k = 10, chunks of 8192; DNA (1,-1,1), protein "
          "BLOSUM62 11/1")
    from swtpu_torch.core.stats import background_freqs
    from swtpu_torch.parallel import search as psearch

    Nq, Ns, L, K, CH = 16, 131072, 128, 10, 8192
    srng = np.random.default_rng(SEED)  # bench_search's draws: queries, a chunk, the DB
    pfreq = background_freqs("protein")
    search_sets = {
        "DNA (1,-1,1)": (DNA_111, srng.integers(0, 4, size=(Nq, L)).astype(np.uint8),
                         srng.integers(0, 4, size=(2048, L)).astype(np.uint8),
                         srng.integers(0, 4, size=(Ns, L)).astype(np.uint8)),
    }
    search_sets["protein BLOSUM62 11/1"] = (
        P_GOTOH, srng.choice(20, size=(Nq, L), p=pfreq).astype(np.uint8),
        srng.choice(20, size=(2048, L), p=pfreq).astype(np.uint8),
        srng.choice(20, size=(Ns, L), p=pfreq).astype(np.uint8))
    def sha256_4(a):
        """A SHA-256 of the array in four slices on threads, then of their
        digests: the one pass a cache keyed on content would pay a call."""
        mv = memoryview(np.ascontiguousarray(a)).cast("B")
        step = -(-mv.nbytes // 4)
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            parts = pool.map(lambda i: hashlib.sha256(mv[i: i + step]).digest(),
                             range(0, mv.nbytes, step))
            return hashlib.sha256(b"".join(parts)).digest()

    def best_of_3(fn, *args):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return min(out) * 1e3

    dna_db = search_sets["DNA (1,-1,1)"][3]
    host_ms = {"SHA-256 (4 threads)": best_of_3(sha256_4, dna_db),
               "C++ pack": best_of_3(psearch._packed_db, dna_db),
               "raw upload (resident)": best_of_3(psearch._resident_db, dna_db, CH, 5, dev)}
    print("the 131,072 x 128 DNA database, best of 3, ms: " + ", ".join(
        f"{k_} {v:.2f}" for k_, v in host_ms.items()), flush=True)
    MODES = (("streaming raw (auto)", dict()),
             ("streaming packed", dict(packed=True)),
             ("resident", dict(resident=True)),
             ("fused sweep", dict(resident=True, max_retries=0)))

    def query_set(seed, p):
        r = np.random.default_rng(seed)
        if p.alphabet_size == 4:
            return r.integers(0, 4, size=(Nq, L)).astype(np.uint8)
        return r.choice(20, size=(Nq, L), p=pfreq).astype(np.uint8)

    def same_hits(a, b):
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    def brute_topk(scores, k):
        ids = np.arange(scores.shape[1])[None].repeat(scores.shape[0], 0)
        order = np.lexsort((ids, -scores), axis=1)[:, :k]
        return (np.take_along_axis(scores, order, axis=1).astype(np.int32),
                order.astype(np.int32))

    def chunk_launch(name, p, qd, td):
        """The launch alone of a chunk's kernel (the thread forms)."""
        ends = name.endswith("_ends")
        if KERNELS[name][0] == ROWSCAN:
            return lambda: kb.rowscan_launch_t(qd, td, p, *kb._uniform_match_mismatch(p),
                                               not p.is_linear, ends)
        check(KERNELS[name][0] == PROFILE and not name.endswith("_warp"),
              f"{name} ran a search chunk: no bare launch for it here")
        table = kp.profile_table(p, dev)
        return lambda: kp.profile_launch_t(qd, td, table, p, ends)

    search_times, chunk_times = {}, {}
    for label, (p, sq, chunk, sdb) in search_sets.items():
        before = {name: launches(name) for name in SEARCH_PATH}
        oracle = sw_score_batch if p.is_linear else sw_affine_score_batch
        fn = best_engine(p)
        # the floor: best_engine on all 2,097,152 pairs, which the brute force sorts
        qq = torch.from_numpy(sq).to(dev).repeat_interleave(Ns, dim=0)
        tt = torch.from_numpy(sdb).to(dev).repeat(Nq, 1)
        with off_path():
            brute = brute_topk(fn(qq, tt).view(Nq, Ns).cpu().numpy(), K)
        floor_ms = timed(fn, (qq, tt), iters=3) * 1e3
        del qq, tt
        torch.cuda.empty_cache()
        # the chunk step alone at 16 x 2048 (CUDA events), beside its engine call
        step = psearch._Step(fn, Nq, L, 2048, L, K, K, 2048, False, False, dev)
        q_d, c_d = torch.from_numpy(sq).to(dev), torch.from_numpy(chunk).to(dev)
        state0 = psearch.to_keys(torch.full((Nq, K), -1), torch.full(
            (Nq, K), np.iinfo(np.int32).max)).to(dev)
        step_ms = timed(step, (q_d, c_d, state0, 0), iters=20) * 1e3
        eng_ms = timed(fn, (q_d.repeat_interleave(2048, 0), c_d.repeat(Nq, 1)),
                       iters=20) * 1e3
        print(f"{label}: best_engine on the 2,097,152 pairs {floor_ms:.3f} ms (the "
              f"floor); the chunk step at 16 x 2048 alone {step_ms:.4f} ms, its engine "
              f"call {eng_ms:.4f} ms [{smi}]", flush=True)
        for mlabel, kw in MODES:
            if kw.get("packed") and p.alphabet_size != 4:
                continue
            got = psearch.all_vs_all_topk(sq, sdb, p, k=K, chunk_size=CH, **kw)
            check(same_hits(got, brute), f"search {label} {mlabel} vs the brute force")
            walls = []
            with off_path():
                for rep in range(2):  # rep 0 warms up; a fresh query set a rep
                    qr = query_set(777 + rep, p)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    psearch.all_vs_all_topk(qr, sdb, p, k=K, chunk_size=CH, **kw)
                    if rep:
                        walls.append(time.perf_counter() - t0)
            search_times[(label, mlabel)] = min(walls) * 1e3
            pairs = Nq * Ns
            print(f"  {mlabel}: equal to the brute force; wall {min(walls) * 1e3:.2f} ms "
                  f"(rep 2 of 2), "
                  f"{pairs / min(walls) / 1e6:.2f} M alignments/s, "
                  f"{pairs * L * L / min(walls) / 1e9:.1f} GCUPS; "
                  f"{min(walls) * 1e3 / floor_ms:.2f}x the floor", flush=True)
        # each kernel the chunks ran, alone at the chunk's shape (16 x 8192)
        qd = torch.from_numpy(sq).to(dev).repeat_interleave(CH, dim=0)
        td = torch.from_numpy(sdb[:CH]).to(dev).repeat(Nq, 1)
        for name in SEARCH_PATH:
            if launches(name) == before[name]:
                continue
            bare = chunk_launch(name, p, qd, td)
            with off_path():
                check(torch.equal(tup(bare())[0], fn(qd, td)),
                      f"{name}: the chunk's bare launch vs best_engine")
            B = Nq * CH
            table_bytes = (4 * kp.profile_table(p, dev).numel()
                           if KERNELS[name][0] == PROFILE else 0)
            slots = pipe_slots(name) if name in ALU_OPS else KERNELS[name][3]
            times = {"operations": B * L * L * slots / int32_rate * 1e3,
                     "lookups": B * L * L * KERNELS[name][4] / lookup_rate * 1e3,
                     "bytes": (B * 2 * L + table_bytes + 4 * B) / HBM_BYTES_PER_S * 1e3}
            binds = max(times, key=times.get)
            chunk_times[name] = (timed(bare, (), iters=20) * 1e3, times[binds])
            print(f"  {name}, the chunk's kernel, launch alone at {B} pairs: "
                  f"{chunk_times[name][0]:.4f} ms, bound {times[binds]:.4f} ms by {binds} "
                  f"({times[binds] / chunk_times[name][0]:.1%})", flush=True)
        del qd, td
        with off_path():
            # a sub-database with a tail chunk against the oracle copy (4 queries)
            sub = chunk[: 2048 - 512 + 3] if p.is_linear else chunk[:515]
            sc = 512 if p.is_linear else 128
            ref = brute_topk(np.stack([oracle(np.repeat(sq[i: i + 1], len(sub), 0), sub, p)
                                       for i in range(4)]), K)
            for mlabel, kw in MODES:
                if kw.get("packed") and p.alphabet_size != 4:
                    continue
                check(same_hits(psearch.all_vs_all_topk(sq[:4], sub, p, k=K, chunk_size=sc,
                                                        **kw), ref),
                      f"search {label} {mlabel} on {len(sub)} targets vs the oracle copy")
            # recovery: resume from a checkpoint written mid-sweep; a flaky engine
            with tempfile.TemporaryDirectory() as d:
                ck = psearch.SearchCheckpoint(str(Path(d) / "cursor.npz"))
                psearch.all_vs_all_topk(sq, sdb[: Ns // 2], p, k=K, chunk_size=CH,
                                        checkpoint=ck, resident=False)
                check(ck.load()["cursor"] == Ns // 2, "checkpoint cursor mid-sweep")
                check(same_hits(psearch.all_vs_all_topk(sq, sdb, p, k=K, chunk_size=CH,
                                                        checkpoint=ck, resident=False),
                                brute), f"search {label}: resumed from the checkpoint")
            calls = [0]

            def flaky(q, t, fn=fn):
                calls[0] += 1
                if calls[0] == 5:
                    raise RuntimeError("injected fault")
                return fn(q, t)

            check(same_hits(psearch.all_vs_all_topk(sq, sdb, p, k=K, chunk_size=CH,
                                                    engine=flaky), brute)
                  and calls[0] == Ns // CH + 5,
                  f"search {label}: a flaky engine's replay ({calls[0]} calls)")
        print(f"  on {len(sub)} targets (chunks of {sc}, a tail of {len(sub) % sc}) every "
              f"mode equals the oracle copy (4 queries); resume from a checkpoint at "
              f"{Ns // 2} and a flaky engine (one fault, {calls[0]} engine calls) give "
              f"the uninterrupted hits", flush=True)
        del sdb
    search_sets.clear()
    search_counts = {name: launches(name) for name in SEARCH_PATH}
    print(f"search path launches (chunks of {Nq * CH} pairs): {search_counts}", flush=True)
    check(search_counts["sw_batch"] > 0 and search_counts["sw_profile_affine"]
          + search_counts["sw_profile_affine_warp"] > 0,
          f"a chunk kernel was not launched on the search path: {search_counts}")

    # 35. statistics and the search CLI ---------------------------------------
    zero_launches(SEARCH_PATH)
    phase("35 statistics and the search CLI: calibrate_stats on the card and the CPU; "
          "search --tsv --stats calibrate / preset, Gotoh --tsv")
    from swtpu_torch.core.stats import bit_score, calibrate_stats, e_value, resolve_stats

    t0 = time.perf_counter()
    st_card = calibrate_stats(DNA_111, "dna", m=128, pairs=8192)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_cpu = calibrate_stats(DNA_111, "dna", m=128, pairs=8192, device="cpu")
    cpu_s = time.perf_counter() - t0
    check((st_card.lam, st_card.K) == (st_cpu.lam, st_cpu.K),
          f"calibrate_stats on the card {st_card} vs the CPU {st_cpu}")
    print(f"calibrate_stats (1,-1,1) at 8192 pairs of 128 x 128: lambda {st_card.lam!r}, "
          f"K {st_card.K!r} on the card ({card_s:.2f} s) and on the CPU ({cpu_s:.2f} s)",
          flush=True)

    def run_cli_err(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli_main(argv)
        return out.getvalue().splitlines(), err.getvalue()

    tmp35 = tempfile.TemporaryDirectory()
    sp_names, sp_db, sp_lens = load_fasta_batch(str(SWISSPROT), "protein", pad_code=25)
    c3q = config3_queries(sp_db, sp_lens)
    c3fa = str(Path(tmp35.name) / "config3_queries.fa")
    write_fasta(c3fa, [(f"cq{i}", decode_protein(x)) for i, x in enumerate(c3q)])
    dna_rand = "16x2048x128"  # one chunk of 32,768 pairs, phase 16's shape
    rs = np.random.default_rng(SEED)  # the CLI's --random inputs
    rq = rs.integers(0, 4, size=(16, 128)).astype(np.uint8)
    rt = rs.integers(0, 4, size=(2048, 128)).astype(np.uint8)
    cli_sets = [
        ("DNA (1,-1,1), --stats calibrate", DNA_111,
         ["--random", dna_rand, "--chunk", "2048"], ["--stats", "calibrate"],
         {f"q{i}": x for i, x in enumerate(rq)}, {f"t{i}": x for i, x in enumerate(rt)}),
        ("protein 11/1, config 3, --stats preset", P_GOTOH,
         ["--alphabet", "protein", "--queries", c3fa, "--targets", str(SWISSPROT),
          "--gap-open", "11", "--gap-extend", "1", "--chunk", "256"],
         ["--stats", "preset"], {f"cq{i}": x for i, x in enumerate(c3q)},
         {n: sp_db[j, : sp_lens[j]] for j, n in enumerate(sp_names)}),
        ("DNA Gotoh (10,-30,40,15)", AFF,
         ["--random", dna_rand, "--scoring", "10,-30", "--gap-open", "40",
          "--gap-extend", "15", "--chunk", "2048"], [],
         {f"q{i}": x for i, x in enumerate(rq)}, {f"t{i}": x for i, x in enumerate(rt)}),
    ]
    for label, p, argv, stats_argv, qmap, tmap in cli_sets:
        t0 = time.perf_counter()
        tsv, err = run_cli_err(["search"] + argv + ["--tsv"] + stats_argv)
        tsv_s = time.perf_counter() - t0
        recs = [json.loads(x) for x in run_cli(cli_main, ["search"] + argv + ["--traceback"])]
        hits = [(r["query"], h) for r in recs for h in r["hits"]]
        for qn_, h in hits:
            check(rescore([tuple(x) for x in h["path"]], qmap[qn_], tmap[h["target"]], p)
                  == h["score"], f"search CLI {label}: rescore of {qn_} / {h['target']}")
        rows_ = [r.split("\t") for r in tsv]
        kept = [(q_, h) for q_, h in hits if len(h["path"]) >= 2]
        check(len(rows_) == len(kept) and len(rows_) >= len(qmap),
              f"search CLI {label}: {len(rows_)} TSV rows for {len(kept)} hits")
        ka = None
        t_lens = [len(x) for x in tmap.values()]
        if stats_argv:  # the statistics the CLI resolves, at its geometry
            med_q = np.median([len(x) for x in qmap.values()])
            with off_path():
                ka = resolve_stats(p, "dna" if p.alphabet_size == 4 else "protein",
                                   mode=stats_argv[1], seed=SEED,
                                   m=max(8, int(round(med_q / 8)) * 8),
                                   n=max(16, int(round(np.median(t_lens) / 16)) * 16))
            check(f"lambda={ka.lam:.4f}" in err, f"search CLI {label}: the KA line {err}")
        for row, (q_, h) in zip(rows_, kept):
            path = h["path"]
            coords = [str(path[0][0] + 1), str(path[-1][0]), str(path[0][1] + 1),
                      str(path[-1][1])]
            tail = ([f"{float(e_value(h['score'], len(qmap[q_]), float(np.mean(t_lens)), ka, db_seqs=len(tmap))):.2g}",
                     f"{float(bit_score(h['score'], ka)):.1f}"] if ka is not None
                    else [str(h["score"])])
            check(row[:2] == [q_, h["target"]] and row[6:10] == coords
                  and row[-len(tail):] == tail, f"search CLI {label}: TSV row {row}")
        if ka is not None:  # E-values fall as bit scores rise, per query
            for q_ in qmap:
                pairs = sorted((float(r[11]), float(r[10])) for r in rows_ if r[0] == q_)
                check(all(a[1] >= b[1] for a, b in zip(pairs, pairs[1:])),
                      f"search CLI {label}: E-value order of {q_}")
        print(f"search {' '.join(argv[:2])} ... {label}: {len(rows_)} TSV rows "
              f"({tsv_s:.2f} s wall with the C++ walk of every hit); every hit's path "
              f"rescored to its score, coordinates and "
              f"{'E-values and bit scores' if ka is not None else 'scores'} equal the TSV's"
              + (f", E-values ordered; {err.strip()}" if ka is not None else ""),
              flush=True)
    tmp35.cleanup()
    cli_counts = {name: launches(name) for name in SEARCH_PATH}
    print(f"statistics and search CLI launches: {cli_counts}", flush=True)
    check(all(any(cli_counts[k] > 0 for k in need) for need in SEARCH_NEEDS),
          f"a kernel was not launched on the search CLI's path: {cli_counts}")

    models_counts = models_phases(
        cli_main, launches, zero_launches, off_path, b9_folded, kb, ksb, kbb, kbk, kdw,
        ksg, smi)
    mesh_counts = mesh_phases(cli_main, launches, zero_launches, off_path, smi)
    harness_counts = harness_phases(cli_main, launches, zero_launches, b9_folded, smi)
    import torch.distributed as dist

    dist.destroy_process_group()  # phase 39's world of one
    suite_counts = suite_phase(launches, zero_launches, off_path, b9_folded, smi)
    for phase_fn in (wide_band_phase, general_engine_phase):
        counts, row = phase_fn(ctx)
        rows.append(row)
    rows.extend(gaps_phase(ctx))

    for row in rows:
        row["models_launches"] = models_counts.get(row["name"], 0)
        row["mesh_launches"] = mesh_counts.get(row["name"], 0)
        row["harness_launches"] = harness_counts.get(row["name"], 0)
        row["bench_launches"] = suite_counts.get(row["name"], 0)
        if row["launches"] is None:
            row["launches"] = {**launch_counts, **sg_counts, **banded_counts,
                               **block_counts, **longpair_counts}[row["name"]]
        row["launches"] += cli_counts.get(row["name"], 0)  # rows 1-6
        # the time a path loses in the kernel: its launches (each entry-
        # point call once) x (launch alone - bound) at the row's timed
        # shape; the search's chunks at theirs (16 x 8192 pairs)
        row["search_launches"] = search_counts.get(row["name"], 0)
        row["search_ms"], row["search_bound_ms"] = chunk_times.get(row["name"], (None, None))
        row["search_lost_ms"] = (row["search_launches"] * max(
            row["search_ms"] - row["search_bound_ms"], 0.0) if row["search_launches"] else 0.0)
    return report(rows, kind, count)


def report(rows, kind, count):
    """The run's last lines: each row's lost ms (its launches, by form
    where it has forms, x (alone - bound), plus its search chunks'), the
    total, the kernels line and the contract's line."""
    for row in rows:
        row["lost_ms"] = sum(f["launches"] * max(f["kernel_ms"] - f["bound_ms"], 0.0)
                             for f in charged_forms(row)) + row.get("search_lost_ms", 0.0)
    print("lost ms = launches x (launch alone - bound) at each row's timed shape "
          "(and instantiation) [+ search launches x (alone - bound) at the chunk's "
          "131,072 pairs]: "
          + "; ".join(f"{r['name']} " + " + ".join(
                          f"{f['launches']} x ({f['kernel_ms']:.4f} - {f['bound_ms']:.4f})"
                          for f in charged_forms(r))
                      + (f" + {r['search_launches']} x ({r['search_ms']:.4f} - "
                         f"{r['search_bound_ms']:.4f})" if r.get("search_launches") else "")
                      + f" = {r['lost_ms']:.3f}"
                      for r in sorted(rows, key=lambda r: -r["lost_ms"])), flush=True)
    print(f"total {time.perf_counter() - T_START:.1f} s", flush=True)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
