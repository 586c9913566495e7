#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-runs 8] [--reps 5]
    python3 chip_smoke.py --mosaic-only
    python3 chip_smoke.py --distributed-only [--n-runs 8]
    python3 chip_smoke.py --lm-only [--reps 5]
    python3 chip_smoke.py --train-only [--reps 5]

The second form only times the brick mosaic on random tiles at the brick
window's shape (`mosaic_only`); a copy of the script at the root of an older
checkout times that checkout's mosaic kernel the same way.  The first form
runs these phases, in order, each printing its seconds:

1. card: a CUDA device must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build: compiles ``src/repro_torch/csrc/*.cu`` into ``build/kernels`` (one
   ``nvcc`` per source, all started together) and prints the ``-Xptxas -v``
   register, shared-memory and spill lines.
3. kernels: ``coadd_fused``, ``warp_batch``, ``coadd_moments``,
   ``coadd_hist`` and ``coadd_clip`` against their plain torch versions on
   the card, at the main path's frame and grid sizes and at edge cases
   (npix not a multiple of the 32 x 8 block, H != W, rejected slots, a grid
   partly outside every image, an empty gate, flat offsets past 2**31, a
   sigma = 0 stack, an outlier frame).  The robust kernels take the plain
   version's fixed operands (clip centre and radius, histogram bounds);
   ``coadd_hist`` is held at every bin count it is built for (8, 16, 32).
   Values are held at atol 2e-2 / rtol 1e-4, the reference's own
   kernel-vs-oracle tolerance; depth, coverage and bins exactly, except at
   pixels where an accepted sample lies within 1e-3 px of an image edge or
   within 1e-4 (relative) of a clip or bin boundary, which are counted and
   printed.  ``warp_batch`` (the culled ``warp_project_kernel``) is also
   held bitwise against the unculled kernel (``warp_project_unculled_f32``,
   the check form no wrapper launches) on each case and on the synthetic
   skies below.  Then PSF matching: ``psf_match_sep`` and ``psf_match_2d``
   against their plain version, bitwise, ungated and under a random
   ``skip`` (zeros there, the same words elsewhere), on a K = 1 bank,
   the 15-tap Gaussian bank at target 2.5, the 13 x 13 homogenization bank,
   random asymmetric taps (7 x 11, 13 x 7, 7 x 13), H != W, frames smaller
   than the kernel, frames of 515 x 509 and 70 x 101 (neither a multiple of
   4 nor of the 2-D kernel's 64-px tile), delta rows and a padded pack
   index; and ``coadd_fused`` and the three robust passes composed with
   each bank (``psf_kernels=``) against the plain scans, depth exactly.
   Each bank's scratch is also written gated as the engine writes it
   (``ops.matched_packs`` given the accept and the flag: rejected slots
   whose flag is set are zeros, ``ops.prepass_skip``) and ungated, every
   culled pass over either bitwise the unculled kernel and the passes over
   the two bitwise each other; so is the poisoned pack,
   PSF-matched with both main banks (its poisoned slots are still matched
   and keep their NaNs).
   Every pack scan is also held bitwise against the unculled kernel
   (``pack_scan_unculled_f32``, the check form no wrapper launches): each
   case above, all four accumulators (``coadd_hist`` at 8, 16 and 32 bins,
   ``coadd_clip`` about the clipped mean and the median), unmatched and
   over each bank's PSF scratch, and a pack whose rejected slots hold a
   NaN, an inf and a 2**70 pixel inside the query footprint (NaN words
   compared too), and six synthetic skies at dec +-60, +-80 and across
   RA 0/360 (``ref.scattered_frames``: 128 frames over a 250-px grid).
   The count of differing words must be 0.
   Then the batched pack scans (``coadd_fused_batch``, ``coadd_moments_batch``,
   ``coadd_hist_batch`` at 8, 16 and 32 bins, ``coadd_clip_batch`` about
   the clipped mean and the median: ONE launch of the query-axis
   ``pack_scan_kernel`` for K queries) at K = 1, 3 and 16, the main box
   moved in RA, dense (4 packs of 16) and sparse (2 packs and 2 padding
   rows), with and without the slot flag: each query bitwise its one-query
   launch on the same operands, and against the plain versions
   (``ref.*_batch_ref``) query by query at the tolerances above; and the
   poisoned pack by 3 queries, bitwise its one-query launches (NaN words
   too), the coadd's NaN pixels and the depth those of the plain version.
   Then the staging shapes of the culled scan body (``ref.staging_scans``,
   3 queries each: a pack across two 256-slot rounds at cap 300, cap 1 and
   33, padding rows repeating pack 0, every slot rejected and flagged, no
   flag, sub-tiles too wide to cull so that a block keeps more than 256
   slots across packs, and a poisoned pack): every query's culled passes
   bitwise the unculled kernel, each batched query bitwise its one-query
   launch, NaN words too.
   Then ``mosaic_bricks`` against its plain version, bitwise: the lattice
   cover (4 x 4 bricks of 256 x 256 into 1024 x 1024), one tile, bh != bw,
   overlapping tiles, offsets past the edges and negative (clamped as the
   reference places them), uncovered pixels, npix 997 (not a multiple of
   the 64 x 64 block), 700 tiles (more than one 256-tile chunk) and B = 0;
   and the shapes that split the kernel's float4 and scalar paths: clamped
   columns not a multiple of 4, bw % 4 != 0, npix % 4 != 0, 300
   overlapping tiles with negative offsets, and aligned and unaligned tiles
   mixed.
4. main path: a survey of 2880 frames of 512 x 512 px (the reference
   survey's geometry), one r-band query at npix 1024, all six methods
   through ``CoaddEngine.run`` with the fused kernel, exactly one
   ``coadd_fused`` launch per query; then the map stage alone, the paper's
   unfused MapReduce: ``mapper.map_batch(use_kernel=True)`` per gated pack
   of the sql_structured plan, reduced by ``reducer.reduce_local``.  The
   methods must agree (coadd atol 1e-3, depth equal), as must the fused and
   unfused results and the engine's plain path (``use_kernel=False``).
   Then the robust path: ``reduce="clipped"`` and ``"median"`` for all six
   methods, exactly 2 and 3 launches per query (moments, [hist,] clip); the
   methods and the plain path agree at atol 1e-3 with equal depth, except
   at counted decision flips.  Then PSF matching at ``match_psf_sigma=2.5``
   with the survey's measured stamps: all six methods x three estimators,
   exactly one ``psf_match_2d`` launch per query before its 1, 2 or 3
   passes, no slot clamped, the mean's depth equal to the unmatched run's,
   the methods agreeing at 1e-3; then ``sql_structured`` with the Gaussian
   fallback (``measured_psf=False``: one ``psf_match_sep`` a query); each
   pre-pass matches only the slots a pass reads (its matched and skipped
   slots printed), and every one of these queries run again with the
   pre-pass ungated (``ops.psf_match`` given ``skip=None``) gives bitwise
   the same coadd and depth; the dense
   pre-pass over all 2880 frames, ungated and gated, bitwise its plain
   version; then the plain path (``use_kernel=False``, the cached matched
   layout).  ``warp_batch`` over every gated pack of the unfused stage is
   held bitwise against its check form, with the (tile, image) pairs it
   samples.
   Then every method's pass, unmatched and over its PSF scratch (gated and
   ungated, the two bitwise each other), through all culled passes against
   the unculled kernel, bitwise, with the slots and samples the culled
   kernel skips (counted by the plain twin of its footprint test,
   ``ref.footprint_keep``).
   Then the brick path (DESIGN.md §9) on the same survey: a lattice of
   256-pixel bricks 0.25 deg on a side (10 x 12 bricks at the main query's
   1024 px/deg) and the 4 x 4 window ``window_query(3, 7, 2, 6, "r")``,
   npix 1024.  For the six methods' means, and ``sql_structured`` and
   ``raw_fits`` clipped, median and PSF-matched (mean at 2.5): the fresh
   ``run_window``, then ``run(use_bricks=True)`` cold (16 bricks
   materialized, then exactly 1 ``mosaic_bricks`` launch), warm (16 hits, 1
   launch, no scan) and after ``brick_store.drop_device()`` (16 spilled, 1
   launch, no scan), each bitwise ``run_window``; then
   ``materialize_bricks`` over the window and its rerun (all skipped).
   Then detection: the reference drill's own configuration on the card
   (8 of 8 recovered, 0 spurious, 0 on the static sky), and at main scale
   a static-sky control, 8 transients injected into the newest epoch
   inside the window, and a fresh engine's ``difference_image``
   (brick-served clipped template, PSF-matched at 2.5) with
   ``detect_sources`` on the kernel path and on the plain path: the two
   catalogs must agree (x, y, npix exactly; flux and snr at rtol 1e-4).
   Then the language model's kernels ("3 lm kernels"): ``flash_attention``
   (csrc/flash.cu) against its plain version ``flash_ref`` at atol = rtol
   2e-5 (float32) or 2e-2 (bfloat16), the JAX package's own kernel
   tolerances: causal and not, window 64, GQA 32/8 and 4/1, S = 1, 1000
   and 2048, D = 64, 128 and 256, the model's strided (B, S, H, D) layout,
   and in bfloat16 (the tensor-core kernel) S = 1, 63, 65 and 129 at the
   edges of its 64-key tile, D 128 and D 256 non-causal;
   and ``ssd_log`` (csrc/ssd.cu, three kernels a call) against
   ``ssd_chunked_ref`` at atol 2e-4 * max(scale, 1), output and final
   state: T = 1, 50 (one chunk), 641 and 1025 (a last chunk of one step),
   1000 and 2048, chunk 64 and 256, N = 64 and 128, P = 64, log-decay down
   to -50 a step, the model's strided slices, B 4 x H 64 in float32, H 24
   and 20 (head groups of 16 that do not divide H), and the ``a``-form
   ``ssd`` also against the step-by-step scan.  Then the flash backward
   (`FLASH_BWD_CASES`: qwen2's 12:2 D 128 at 2 x 4096 in bf16 and float32,
   granite 24:8 D 64, gemma 8:1 D 256 float32 on the split grid, whisper's
   non-causal 20 heads at S 1500, window 256, a ragged S 1000, MQA 8:1 D
   128 at S 1000, S 63, 65 and 129 at D 64 and D 256 in bf16 at S 129,
   and off the split grid with the GQA group summed inside a dkdv block:
   qwen2 at batch 5 in bf16 and granite at batch 3 in float32), q, k, v and
   dO in the model's strided layout: the forward's O with the LSE
   written bitwise its O without, the LSE within 1e-5 of the plain one's
   scale; ``flash_bwd_preprocess_kernel`` (D), ``flash_bwd_dkdv_kernel``
   and ``flash_bwd_dq_kernel`` against ``flash_bwd_ref`` on the same
   operands (float32 within 1e-4 of each gradient's scale; bf16 by the
   forward's allowance, element by element and row by row), and on the
   split grid ``flash_bwd_dkdv_reduce_kernel`` bitwise against
   ``dkdv_reduce_ref`` on the dkdv kernel's partials; two backward runs
   bitwise.  Each bf16 case's gradients are held by the ratio rule against
   the unrounded float32 gradient: relative L2 at most 1.5 x SDPA's
   backward's + 2^-8.  Each dtype has a GQA case on each grid.  Then the
   SSD backward (`SSD_BWD_CASES`: T = 1, 50, 641, 1000, 1025, 2048 and
   2112, chunk 64 and 256, N 64 and 128, H 24 and 20 under head groups of
   16, a 64-head ragged call, mamba2-130m's and Zamba2's training shapes
   at 2 x 4096 in bf16 and float32, the model's strided slices, a random
   final-state cotangent or none, and sub-chunks whose last rows end
   inside an mma tile: T 17 and 100 at N 128 float32, T 641 at N 64 bf16
   with a final-state cotangent): ``ssd_bwd_state_pass_kernel`` (the chunk
   sums fused into the reverse pass), ``ssd_bwd_chunk_scan_kernel`` and
   ``ssd_bwd_reduce_kernel`` on the forward kernels' scratch against
   ``ssd_chunked_bwd_ref`` (float32 within 1e-4 of each gradient's scale;
   bf16 dB, dC and dx also within one bf16 ulp, and by the ratio rule
   against the plain version from the float32 gradient; the state pass on
   its own output, the state gradients dS', within 1e-4 of the scale); two
   calls and the kernels launched alone bitwise; exactly three launches a
   call.
4. batch path ("4 batch path", after the main path): ``run_batch`` of K = 4
   queries (the main box and three moved by +0.25, +0.5 and -0.25 deg in
   RA) for ``raw_fits`` (dense) and ``sql_structured`` (sparse, the union
   of the four queries' packs), mean, clipped and median, unmatched and
   PSF-matched at 2.5 with the measured 13 x 13 bank, each twice: exactly
   1, 2 or 3 batched launches a batch (plus 1 ``psf_match_2d``) and no
   one-query pass launch; every query bitwise its own ``engine.run``.
   Prints batch ms (host), pass ms, the four runs' ms and the four host
   grids' ms.
4. service ("4 service"): ``CoaddService`` on the main engine, the serve
   drill's burst (``repro_torch.launch.serve.drill_queries``, 16 clients, a
   pool of 8) scaled to the main survey: cheap 0.8 x 0.9 deg boxes at npix
   1024, every fourth query the whole footprint at npix 2048.  Every
   response bitwise ``engine.run``, coalesce factor above 1, nothing shed,
   at least one batched launch; prints wall, p50, p95 and the counters.
4. streaming ("4 streaming"): the main survey under a device budget, one
   engine a layout at a quarter of the layout's device bytes (4x
   oversubscribed), built only through ``CoaddEngine(...,
   device_budget_bytes=...)``.  Its first query, timed, pays the layout's
   one-time costs: packing, the pixel array's registration in place
   (``cudaHostRegister``, its time printed) and every upload.  Then
   each method on its layout x three estimators, unmatched and PSF-matched
   at 2.5 (a chunk matched once after its upload), cold (every chunk
   re-uploaded) and warm, against the eager kernel path's results above:
   depth exactly and coadd at atol 5e-2 / rtol 1e-3 (the reference's
   streaming tolerance), a robust pixel that differs only with a sample
   within 1e-4 of a decision boundary (counted); exactly one host sync a
   query (a spy on ``engine._sync``); as many windows a pass as gated
   chunks, one launch each.  Then the K = 4 batch (``raw_fits``,
   ``sql_structured``, three estimators) against the eager batches, and the
   brick window streamed: ``run_window``, then cold, warm and spilled
   serves, one ``mosaic_bricks`` launch each, bitwise ``run_window``.  Per
   engine: ``ResidencyManager.peak_bytes`` at most the budget + one chunk +
   a matched build's transients, and the rise of
   ``torch.cuda.max_memory_allocated`` at most that peak plus the queries'
   scratch (``STREAM_SCRATCH_MAPS`` maps of npix^2 a query).  Prints cold
   and warm ms, windows, uploads, hits, evictions, bytes uploaded and the
   upload rate against a pinned cudaMemcpy of 1 GiB, a profiled cold dense
   query's device idle share, and the layout's upload rate straight from
   the registered array and through a ring of two pinned staging buffers.
   The streaming engines run under the default fault policy
   (``on_fault="retry"``: every window through the `WindowTracker`).
4. faults ("4 faults"): the fault domain (DESIGN.md §8) on the streaming
   phase's per-file and structured engines (``raw_fits`` at 9 windows a
   pass, ``sql_structured`` at 2), each drill bitwise the same engine's
   clean streamed kernel-path run: an upload failure, NaN poison that heals
   (the poisoned chunk dropped and uploaded again), persistent poison under
   ``on_fault="quarantine"`` (partial, the pack uncovered, depth exactly
   the run with the pack gated off at plan time, coadd within 1e-5 of it;
   then ``reverify_quarantined`` restores full coverage), a kill and a
   resume that replays only the finished windows (mean; median mid-pass
   and on the pass seam), a straggler speculated (its backup's digest
   agreeing), a `FaultSchedule.seeded` drill with all of them, the K = 4
   batch and PSF-matched queries (both bank ranks) under faults, and
   finite corruption healed under ``verify_digests`` (its cost printed).  Prints
   the clean path's "retry"/"raise" time ratio cold and warm (interleaved,
   0 retries, bitwise, one host sync a query), ``journal_dir``'s ratio to
   the in-memory journal with the journal bytes a query, each heal's ms
   over the clean query, and the host syncs and event waits a query; holds
   ``peak_bytes`` and the ``max_memory_allocated`` rise as phase "4
   streaming" does.  Then the SIGKILL drill: this script as a subprocess
   (``--crash-child``) streams ``raw_fits`` over a reduced survey
   (`CRASH_CFG`, 720 frames) with ``journal_dir``, once uninterrupted, once
   killed by its own SIGKILL after the first window's journal commit, then
   once more on that journal: it resumes the finished window and is bitwise
   the uninterrupted run.
4. distributed ("4 distributed", after the faults): multi-device jobs,
   ``CoaddEngine.run_distributed``, in two forms, each through
   ``repro_torch.launch.mesh.run_ranks`` (spawned ranks meeting through a
   ``file://`` store under ``build/distributed``, the survey pickled there
   for them): (a) one NCCL rank on the card, mesh (1, 1), the main survey:
   the main query and the K = 4 batch as one job each, sparse and dense,
   eager and streamed at a quarter of the structured layout, unmatched,
   with the 13 x 13 bank and with the 15-tap fallback; (b) eight gloo
   ranks sharing the card (NCCL puts no two ranks on one device), meshes
   (4, 2) ``("data", "model")`` and (2, 2, 2) ``("pod", "data", "model")``
   over the survey cut to 2 of its 8 epochs (``CRASH_CFG``, 720 frames),
   the K = 4 batch, sparse and dense, eager and streamed at a quarter of a
   rank's share.  Each job runs twice counted (exactly one
   ``warp_project`` launch a query a window a rank, plus one
   ``psf_match_*`` under a bank, and exactly ``windows`` dispatches), once
   with a sync after the map and after the collectives (each rank's map
   and collective ms), and once held (each ``warp_batch`` launch bitwise
   its check form ``warp_project_unculled_f32``, each ``psf_match_*``
   launch bitwise its plain version).  Every job within 1e-2 of the
   single-host ``run(q, "sql_structured")`` on the same engine, depth
   exactly; sparse within 1e-4 of dense, depth exactly; sparse
   ``packs_scanned`` below dense; unequal per-shard budgets on (b); every
   rank's results bitwise rank 0's.  Prints job ms cold and warm, upload
   ms and GB/s, windows, uploads, launches a window a rank and the
   budgets; ``--distributed-only`` runs just this phase.
4. zamba2 serving ("4 zamba2 serving", after the coadd main path): the full
   ``zamba2-1.2b`` configuration (38 Mamba-2 layers, d_model 2048, 1.17 B
   parameters from ``LM.init(0)``) through ``LM.prefill`` and 32 decode
   steps (``LM.decode_step``) for two request batches, 4 prompts of 2048 tokens
   and 1 of 1000 (ragged against the chunk and the tile), each on the
   kernel path and the plain path (``use_kernels=False``), in bfloat16 and
   in float32 on the same weights; the bf16 kernel path decodes greedily
   and the other runs are fed its tokens.  Each counted prefill launches
   exactly 6 ``flash_attention`` and 38 ``ssd_log`` kernels, and decoding
   none.  The prefill logits, every cache leaf and the decode logits are
   held: float32 kernel vs plain within 1e-4 of each value's scale.  In
   bfloat16 every kernel call of a kernel-path prefill is held against its
   plain version on the same operands at the phase-3 tolerances (a bf16
   prefill's values spread by a few % between runs whose float32 sums
   differ in order), and end to end the kernel path lies no farther from
   the float32 plain run than two bf16 comparators do: the same model with
   its kernels swapped for their plain versions (``flash_ref``,
   ``ssd_chunked_ref``, which round where the kernels do) and the plain
   path (which rounds the attention logits to bf16, as the JAX model
   does): relative L2 error at most 1.5 times and max error at most 2
   times the comparator's, each plus one bf16 ulp.  Prints prefill ms,
   ms a decode step, tokens/s and ``max_memory_allocated`` for every run.
4. lm families ("4 lm families", after the Zamba2 phase): every other LM
   family at full width and depth (`LM_FAMILIES`: mamba2-130m, qwen2-1.5b,
   gemma-2b, granite-moe-3b-a800m, whisper-large-v3 with 1500 encoder
   frames, llama-3.2-vision-11b with 1600 image embeddings; each
   configuration's parameters freed before the next is drawn), one request
   of 4 prompts of 2048 tokens, a counted prefill and 32 decode steps in
   four runs on the same ``LM.init(0)`` weights: bf16 with the kernels
   (greedy), bf16 with the kernels swapped for their plain versions,
   float32 with the kernels and float32 on the plain path, fed the first
   run's tokens.  Each counted prefill launches exactly the table's
   ``flash_attention`` and ``ssd_log`` kernels (28 / 18 / 32 / 64 / 40
   flash, 24 SSD), decoding none.  The prefill logits, every prefill cache
   leaf and the decode logits are held: float32 kernel vs plain within
   1e-4 of each value's scale; bf16 by the ratio rule against the swapped
   run, from the float32 kernel run; each kernel call of a bf16 prefill
   held against its plain version.  The MoE router's choices of the bf16
   kernel run are replayed into the other runs, whose own choices are
   counted as routing flips with their margins (bf16 ulps of the router
   logit); per call (each MoE layer's input also routed with its
   attention from ``flash_ref``) a flip beyond 1 ulp fails the run.
   Prints prefill ms, ms a decode step, tokens/s and the
   ``max_memory_allocated`` rise of every run beside the card's name and
   power limit; ``--lm-only`` runs phases "3 lm kernels", "4 lm
   families" and "4 lm training" and the families' and the backward's
   kernel timings, and exits.
4. lm training ("4 lm training", after the families; `TRAIN_CELLS`):
   qwen2-1.5b, mamba2-130m and zamba2-1.2b at full width and depth,
   float32 masters, bf16 compute, remat on, 2 x 4096 tokens (train_4k's
   sequence length, the global batch cut from 256 to 2).  For each: (a)
   one step's loss, grad norm and every gradient leaf on the kernel path
   against the plain path on the same weights and batch (float32 within
   1e-4 of each leaf's scale; mamba2, whose 256-step chunks the float32
   plain form rounds ~1.7e-4 off the exact gradient, against the plain
   path run in float64; bf16 by the ratio rule against the plain path and
   against the kernel path with its kernels swapped for their plain
   versions), exactly the launches of `step_launches` a step (from the
   config alone; the model's remat units must agree): qwen2 2
   forward and 1 of each backward flash kernel a layer (the split grid's
   reduction in bf16, where its 2 x 2 kv heads of 32 key tiles are under
   one and a half waves; none in float32, 64 key tiles), mamba2 48
   ``ssd_log`` and 24 of each SSD backward kernel, Zamba2 74 and 38 with
   12 flash forward and 6 of each flash backward kernel (its two tail
   layers are not rematted); (b) 10 AdamW steps (``make_train_step``,
   ``TokenPipeline`` over ``synthetic_corpus``): ms a step, tokens/s,
   model FLOP/s (a share of the bf16 peak, for information only),
   ``max_memory_allocated``, and one more step split by CUDA events into
   forward, backward (the flash and the SSD backward calls alone) and
   optimizer.  Then (c) the crash/resume drill through
   ``launch/train.py``'s loop (qwen2's widths, 2 layers, vocab 512, 12
   steps of 4 x 256, a checkpoint every 4, crashed after step 6 and
   resumed: final losses within 1e-6, bitwise or not printed).
   ``--train-only`` runs the flash and SSD backward's cases, this phase
   and the backward's timings, and exits.
5. measure: each kernel's time on the card (CUDA events, warm), its plain
   version's, the nearest PyTorch call's (``F.grid_sample`` bilinear over
   the same samples, plus a sum for the coadd; it covers only the
   sampling), and the least time the card could take (bytes over
   3.35 TB/s, or fp32 operations over 67 TFLOP/s, whichever is larger).
   A pack scan's ``bound_ms`` counts the work that contributes (the
   samples inside an accepted frame, the accepted slots' pixels:
   ``contrib_bound``), and ``unculled_ms`` times the unculled kernel beside
   it; the bound over every scanned slot (``coadd_bound``) and the samples
   the twin of the footprint test keeps are printed on the human lines,
   not in the kernels line, and the brick window's 16 materialization
   passes are timed culled and unculled.  ``ssd_log`` prints each of its
   three kernels' time (a profiler trace), the memory a call allocates
   and their registers and spills.
   The PSF kernels' library call is ``F.conv2d`` depthwise on a
   replicate-padded batch, TF32 off (a yardstick only: the port never
   calls it).  ``mosaic_bricks``'s library call is ``F.fold`` (col2im,
   kernel and stride 256) of the 16 window tiles, coadd and depth; the
   mosaic is also timed launched alone (its C entry point, no wrapper) and
   as 100 launches captured in a CUDA graph (the kernel's own time: a host
   call takes about as long as the kernel), on one set of operands that
   stays in the L2 (``graph_ms``) and over 8 copies in turn that do not
   (``graph_hbm_ms``, the time to hold against the HBM byte bound).
   ``flash_attention`` and ``ssd_log`` are timed at the Zamba2 prefill's
   shapes (B 4, H 32, S 2048, D 64 causal bf16; B 4, T 2048, H 64, N 64,
   P 64, bf16 inputs), bounded by bf16 tensor-core products at 989 TFLOP/s
   and float32 softmax operations (flash), float32 operations at 67 TFLOP/s
   (SSD) or bytes; flash's library call is ``F.scaled_dot_product_attention``
   (``is_causal=True``), and no single PyTorch call computes the SSD scan.
   Both are also timed at the other families' prefill shapes
   (``FAMILY_FLASH``, ``FAMILY_SSD``): through the wrapper, launched alone
   (the C entry point on preallocated outputs), plain, and for flash
   ``F.scaled_dot_product_attention`` (``enable_gqa`` where the heads are
   grouped), each with its bound and launches a prefill (the kernels
   line's ``family_shapes``).
   The backward kernels at qwen2's training shape (2 x 4096, 12:2, D 128,
   causal bf16, the split grid): each launched alone, all through the
   wrapper, ``flash_bwd_ref`` (D in plain torch, ``dkdv_reduce_ref``), and
   ``F.scaled_dot_product_attention``'s backward (dq, dk and dv together,
   ``dkdv``'s library time; under a window with its boolean ``attn_mask``);
   bounds: bytes, or the products each kernel cannot avoid (dkdv 4, dq 3 a
   pair; the whole backward 5, 2.5 times the forward's) on the bf16 tensor
   cores beside 5 float32 operations a pair; the reduction by bytes.
   The SSD backward at Zamba2's and mamba2-130m's training shapes
   (`SSD_BWD_TIMED`, bf16 strided, no final-state cotangent): through the
   wrapper, each kernel launched alone (its C entry point on preallocated
   outputs), ``ssd_chunked_bwd_ref``, the forward kernels (each alone from
   a profiler trace, at the same shape) and the three kernels at each head
   group of `SSD_BWD_GROUPS`; bounds (`ssd_bwd_bound`) by bytes or by the
   operations on the units that run them (the products on the TF32 tensor
   cores with each 3xTF32 pass counted, the elementwise work in float32),
   and beside them the float32 CUDA-core reckoning (every product once in
   float32 `fmaf`); no PyTorch call computes it (library none).
   The kernels redesigned for the card (``flash_fwd_bf16_kernel``,
   ``psf_match_2d_kernel``, ``psf_match_sep_kernel``,
   ``warp_project_kernel``) also print their registers and spills (ptxas
   ``-v``); ``warp_project`` the unculled kernel's time; ``psf_match_2d``
   its -fmad=false ceiling (twice the operation bound: no product may fuse
   with its sum); both PSF kernels their time launched alone, without the
   wrapper's checks, and the gated
   pre-pass's time alone; ``psf_match_2d`` also its any-width path alone on
   the same bank (``psf_match_2d_any_f32``, held bitwise too); and the dense
   pre-pass (2880 slots) gated, ungated and with every slot skipped (its
   zero writes alone).  The batched pack scans over the ``sql_structured``
   union of K = 4 and 16 boxes, each beside K one-query launches on the
   same pack index; µs a query; the bound (``batch_bound``: the pixels of
   the slots any query accepts read once, every query's maps and
   contributing samples); the library time K times the one-query row's.
   Every pack scan is also timed launched alone through ``pack_scan_f32``
   on the same operands (``alone_ms``; the wrappers are given the index's
   host copy, as the engine gives it), its outputs bitwise the wrapper's,
   and carries its culled
   kernel's registers and spills; ``coadd_moments_batch`` at K = 4 also
   split by its inputs alone: every slot rejected and flagged (the
   skeleton) and every frame accepted over grids moved off the survey
   (the footprint tests, no slot sampled).  Each method's fused, moments
   and clip passes are timed launched alone over its own packs, and its
   fused pass's skeleton (every slot rejected and flagged).

The line before the last is ``{"kernels": [...]}``, after the card's name
and power limit printed again; the last is the device line.  The script
exits nonzero, before printing either, on any failure.  Everything it
builds goes to ``build/``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

COADD_ATOL, COADD_RTOL = 2e-2, 1e-4     # kernel vs plain (tests/test_kernels.py:30)
PATH_ATOL = 1e-3                        # across methods and paths (tests/test_coadd_engine.py:26)
ROBUST = ("clipped", "median")
CLIP_K, NBINS = 3.0, 16                 # the engine's defaults
ROBUST_REPS = 2                         # warm repeats per robust query (2 or 3 passes)
PSF_REPS = 2                            # warm repeats per PSF-matched query
OUTLIER = 1e4                           # added to one frame of the outlier case
DEVICE = "cuda"                         # the card the script drives
FLAT_OFFSET_LIMIT = 2**31               # flat element offsets must pass the int32 range
HBM_BYTES_PER_S = 3.35e12               # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12                  # H100 SXM fp32 outside the tensor cores

# fp32 operations of one sample (one output pixel x one slot), counted from
# the formula the kernels and their plain versions evaluate, each sin, cos,
# division, floor and comparison as one: dra (1), sin/cos (2), cosc (4),
# xi (3), eta (6), sx (5), sy (5), floors and fractions (4), bilinear
# weights and blend (13), inside test (4), times the accept weight (2).
# The fused kernel adds both sums (2).  Per output pixel the sky trig is 4;
# per slot the reference-declination trig and the CD determinant are 7.
# coadd_moments adds vm*vm/m behind a coverage test (3), its product with
# a (1) and three sums (3); coadd_clip the keep test (m > 0, m*center, the
# difference, its magnitude, m*thresh, the comparison, the and: 7) and two
# sums (2), the keep itself being a select; coadd_hist drops vm*a (-1) and
# adds the sample x behind a coverage test (2), the bin (subtract, scale,
# floor, NaN test, two clamps, convert: 7) and one add into that bin (1),
# at any bin count: the kernel's compare-select over every bin is its own
# cost, not the histogram's.
WARP_SAMPLE_OPS = 49
COADD_SAMPLE_OPS = WARP_SAMPLE_OPS + 2
MOMENTS_SAMPLE_OPS = WARP_SAMPLE_OPS + 7
CLIP_SAMPLE_OPS = WARP_SAMPLE_OPS + 9
HIST_SAMPLE_OPS = WARP_SAMPLE_OPS + 9
PIXEL_OPS = 4
SLOT_OPS = 7
# PSF matching: an fp32 multiply and add per tap and pass, 2 * Kh * Kw a
# matched pixel for a 2-D kernel, 2 * 2K for a separable one (K = 1: one
# multiply).
# The pack scans' kinds at the unculled entry point (csrc/warp.cu launch_kind).
SCAN_KIND = {"coadd_fused": 0, "coadd_moments": 1, "coadd_clip": 2, "coadd_hist": 3}
# Each pass's accumulator, the template argument of its culled kernel.
ACCUMULATOR = {"coadd_fused": "SumAcc", "coadd_moments": "MomentsAcc", "coadd_clip": "ClipAcc",
               "coadd_hist": "HistAcc"}
KERNELS = ("coadd_fused", "warp_project", "coadd_moments", "coadd_hist", "coadd_clip",
           "psf_match_sep", "psf_match_2d", "mosaic_bricks", "flash_attention_single",
           "ssd_chunked", "coadd_fused_batch", "coadd_moments_batch", "coadd_hist_batch",
           "coadd_clip_batch")
PSF_TARGET = 2.5                        # the main path's match_psf_sigma: no slot clamps
REDUCES = ("mean",) + ROBUST
PASSES = {"mean": ("coadd_fused",), "clipped": ("coadd_moments", "coadd_clip"),
          "median": ("coadd_moments", "coadd_hist", "coadd_clip")}

MAIN_QUERY = dict(band="r", ra_bounds=(37.5, 38.5), dec_bounds=(-0.5, 0.5), npix=1024)
# Batched queries (paper Fig. 5): the main path's batch is the main query and
# three boxes moved by these RA offsets (deg), K = 4; phase 5 also times 16
# (twelve more offsets, every box inside the survey's RA 37-40).  Phase 3
# holds the batched kernels at BATCH_KS queries.  The batch path runs one
# dense and one sparse (union index) method, BATCH_REPS times each.
BATCH_OFFSETS = (0.0, 0.25, 0.5, -0.25)
BATCH16_OFFSETS = BATCH_OFFSETS + tuple(0.125 * i for i in (-4, -3, -1, 1, 3, 5, 6, 7, 8, 9,
                                                             10, 11))
BATCH_KS = (1, 3, 16)
BATCH_METHODS = ("raw_fits", "sql_structured")
BATCH_REPS = 2
# The TPU program each batched wrapper replaces: the reference's vmapped
# pack-scan call site (src/repro/core/engine.py).
BATCH_REPLACES = {"coadd_fused_batch": 387, "coadd_moments_batch": 692,
                  "coadd_hist_batch": 707, "coadd_clip_batch": 723}
# The service drill (repro_torch.launch.serve) scaled to the main survey
# (RA 37-40, Dec +-1.2): cheap 0.8 x 0.9 deg boxes at the main query's npix,
# every fourth query the whole footprint at 2048; 16 clients, 8 queries.
SERVICE_CLIENTS, SERVICE_POOL, SERVICE_SEED = 16, 8, 0
SERVICE_SHAPE = (37.2, 0.3, 0.8, (-0.45, 0.45), 1024, (37.0, 40.0), (-1.2, 1.2), 2048)
# The brick path: 256-pixel bricks 0.25 deg on a side (the main query's
# 1024 px/deg) and a 4 x 4 window of them; the dense method it also runs
# robust and PSF-matched; warm repeats per brick-served query.
BRICK_DEG, BRICK_NPIX = 0.25, 256
BRICK_WINDOW = (3, 7, 2, 6)
BRICK_DENSE = "raw_fits"
WARM_REPS = 3
# Streaming residency (phase "4 streaming"): one budgeted engine a layout,
# its budget a quarter of the layout's device bytes (4x oversubscribed, as
# tests/test_streaming.py:36-44), each on the methods planned on it; held
# against the eager kernel path at the reference's streaming tolerance
# (tests/test_streaming.py:129), depth exactly.
STREAM_FRAC = 4
STREAM_ATOL, STREAM_RTOL = 5e-2, 1e-3
STREAM_LAYOUTS = {"per_file": ("raw_fits", "raw_fits_prefiltered"),
                  "unstructured": ("unstructured_seq", "sql_unstructured"),
                  "structured": ("structured_seq_prefiltered", "sql_structured")}
# Device bytes a streamed query may allocate beyond the residency manager's
# peak (chunks, in-flight and transient bytes), in (npix, npix) float32 maps
# a query: the histogram pass's running sum and a window's output, 2 x
# NBINS, the median's cumulative histogram, NBINS, and 16 single maps
# (moments, bounds, centre, radius, grids, outputs).
STREAM_SCRATCH_MAPS = 3 * NBINS + 16
# The fault domain (phase "4 faults"), on the streaming phase's per-file and
# structured engines: the clean path's policies and journals timed in turns
# (raise, retry, retry, raise); a straggler sleeps FAULT_SLOW_S, speculated
# past FAULT_STRAGGLER times the median window; the seeded drill's seed (the
# reference's, tests/test_faults.py).  The SIGKILL drill's reduced survey
# (a quarter of the main survey's epochs: 720 frames) and its crash stage.
FAULT_LAYOUTS = ("per_file", "structured")
FAULT_INTERLEAVE = ("raise", "retry", "retry", "raise")
FAULT_JOURNAL_INTERLEAVE = ("memory", "disk", "disk", "memory")
FAULT_SLOW_S, FAULT_STRAGGLER, FAULT_SEED = 0.05, 3.0, 82
CRASH_CFG = dict(n_runs=2, n_camcols=6, n_bands=5, n_fields=12, height=512, width=512, seed=82)
CRASH_STAGE = "manifest_done:0"
CRASH_TIMEOUT_S = 300
H2D_PROBE_BYTES = 1 << 30               # pinned cudaMemcpy H2D yardstick
# Multi-device coadd jobs (phase "4 distributed", `distributed_phase`):
# form (a) one NCCL rank on the card, mesh (1, 1), at full width; form (b)
# eight gloo ranks sharing the card (NCCL puts no two ranks on one device)
# over the survey cut to 2 of its 8 epochs (CRASH_CFG's 720 frames: eight
# ranks each holding the full survey and its layout would need ~56 GB of
# host memory).  Held against the single-host run at the reference's
# tolerances: 1e-2 (tests/test_distributed.py:38), sparse vs dense 1e-4
# (:47), depth exactly.  Form (a) streams at STREAM_FRAC of the structured
# layout (the streaming cell's budget), form (b) at a quarter of each
# rank's share of it.  A check-form launch holds DIST_HOLD_IMAGES images.
DIST_ATOL, DIST_SPARSE_ATOL = 1e-2, 1e-4
DIST_WORLD_B = 8
DIST_MESHES = {"1x1": ((1, 1), ("data", "model"), ("data",)),
               "4x2": ((4, 2), ("data", "model"), ("data",)),
               "2x2x2": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"))}
DIST_PSF = {None: None, "2d": None, "sep": False}   # bank -> measured_psf
DIST_TIMEOUT_S = 480
DIST_HOLD_IMAGES = 128
# The brick mosaic's own time: launches captured in one CUDA graph, on one
# set of operands (16.8 MB, L2-resident) and over 8 copies in turn (134 MB,
# well over the H100's 50 MB L2, so each launch's operands come from HBM).
MOSAIC_GRAPH_LAUNCHES, MOSAIC_ROTATE, MOSAIC_SEED = 100, 8, 21
# The reference's detection drill (examples/coadd_stripe82.py:28-31).
DRILL_CFG = dict(n_runs=3, n_fields=5, n_sources=100, height=20, width=20)
DRILL_QUERY = dict(band="r", ra_bounds=(37.3, 37.9), dec_bounds=(-0.5, 0.3), npix=48)
DRILL_PSF, NSIGMA, N_TRANSIENTS, TRANSIENT_FLUX, TRANSIENT_SEED = 2.0, 5.0, 8, 400.0, 7
CATALOG_RTOL, FLUX_ATOL = 1e-4, 1e-3   # kernel vs plain catalog: flux and snr
# The language model's kernels (flash, SSD) against their plain versions:
# tests/test_kernels.py's tolerances (:78 for flash, atol 2e-4 * max(scale, 1)
# for the SSD scan, :121).  (name, B, Hq, Hkv, S, D, causal, window, dtype,
# the model's strided (B, S, H, D) layout) and (name, B, T, H, N, chunk,
# dtype, form: log-decay, "a"-form wrapper, or the model's strided slices).
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# A second bfloat16 check of the tensor-core kernel, row by row.  At S 2048
# FLASH_TOL is about half a typical output (|o| ~ sqrt(e / S)), so a dropped
# or doubled kv tile could pass it.  Each output row's max |diff| from
# flash_ref, in bf16 ulps of the row's largest |value|, at most
# FLASH_ROW_ULPS, and the relative L2 error at most FLASH_REL_L2: about twice
# the largest readings on an H100 (PERF.md).
FLASH_ROW_ULPS, FLASH_REL_L2 = 4.0, 5e-3
SSD_TOL, SSD_P = 2e-4, 64
BF16_TC_OPS_PER_S = 989e12              # H100 SXM bf16 tensor cores, dense
TF32_TC_OPS_PER_S = 495e12              # H100 SXM TF32 tensor cores, dense
FLASH_CASES = (
    ("zamba2_prefill", 4, 32, 32, 2048, 64, True, None, "bfloat16", True),
    ("zamba2_ragged", 1, 32, 32, 1000, 64, True, None, "bfloat16", True),
    ("causal_s2048_f32", 1, 32, 32, 2048, 64, True, None, "float32", False),
    ("noncausal_s1000_d128", 1, 8, 8, 1000, 128, False, None, "float32", False),
    ("window64_s2048", 1, 8, 8, 2048, 64, True, 64, "bfloat16", False),
    ("window64_noncausal_s1000", 1, 8, 8, 1000, 64, False, 64, "float32", False),
    ("gqa32_8_s2048_d128", 1, 32, 8, 2048, 128, True, None, "bfloat16", False),
    ("gqa32_8_s1000_f32", 1, 32, 8, 1000, 64, True, None, "float32", False),
    ("gqa4_1_s1000_d128", 2, 4, 1, 1000, 128, True, None, "float32", False),
    ("gqa4_1_s2048_window64", 2, 4, 1, 2048, 64, True, 64, "bfloat16", False),
    ("s1_d64", 2, 4, 4, 1, 64, True, None, "float32", False),
    ("s1_d128_noncausal", 2, 4, 1, 1, 128, False, None, "bfloat16", False),
    ("d256_s1000", 1, 8, 4, 1000, 256, True, None, "bfloat16", False),
    # bf16 on the tensor cores at the edges of the 64-key tile, D 128, D 256
    ("bf16_s1", 2, 4, 2, 1, 64, True, None, "bfloat16", False),
    ("bf16_s63", 2, 4, 2, 63, 64, True, None, "bfloat16", False),
    ("bf16_s65_strided", 2, 4, 2, 65, 64, True, None, "bfloat16", True),
    ("bf16_s129", 2, 4, 2, 129, 64, True, None, "bfloat16", False),
    ("bf16_noncausal_s1000_d128", 1, 8, 4, 1000, 128, False, None, "bfloat16", False),
    ("bf16_noncausal_s129_d256", 2, 4, 2, 129, 256, False, None, "bfloat16", True),
    # The other families' prefills (phase "4 lm families"), in the model's layout:
    # gemma-2b (float32: its embed_scale promotes the residual stream), qwen2-1.5b,
    # granite-moe-3b-a800m, whisper-large-v3's encoder, llama-3.2-vision-11b.
    ("gemma_mqa8_1_d256_f32", 4, 8, 1, 2048, 256, True, None, "float32", True),
    ("qwen2_gqa12_2_d128", 4, 12, 2, 2048, 128, True, None, "bfloat16", True),
    ("granite_gqa24_8_d64", 4, 24, 8, 2048, 64, True, None, "bfloat16", True),
    ("whisper_encoder_s1500", 4, 20, 20, 1500, 64, False, None, "bfloat16", True),
    ("llama_vision_gqa32_8_d128", 4, 32, 8, 2048, 128, True, None, "bfloat16", True),
)
# The flash backward kernels (flash_bwd_preprocess_kernel, flash_bwd_dkdv_kernel,
# flash_bwd_dq_kernel) against flash_bwd_ref on the same operands (q, k, v and
# dO in the model's strided (B, S, H, D) layout; O and the LSE from the
# forward kernel): (name, B, Hq, Hkv, S, D, causal, window, dtype).  float32
# within BWD_F32_REL of each gradient's scale; bfloat16 by the forward's
# allowance (FLASH_TOL element by element, flash_rows row by row).  The
# forward's O with the LSE written must be bitwise its O without, and the
# LSE within LSE_REL of the plain one's scale; two backward runs bitwise.
# bfloat16 also by the ratio rule (BF16_L2, BF16_ULP) against the float32
# gradient, SDPA's backward the comparator.
FLASH_BWD_CASES = (
    ("qwen2_train", 2, 12, 2, 4096, 128, True, None, "bfloat16"),
    ("qwen2_train_f32", 2, 12, 2, 4096, 128, True, None, "float32"),
    ("granite_gqa24_8_d64", 1, 24, 8, 2048, 64, True, None, "bfloat16"),
    ("gemma_mqa8_1_d256_f32", 1, 8, 1, 2048, 256, True, None, "float32"),
    ("whisper_encoder_s1500", 1, 20, 20, 1500, 64, False, None, "bfloat16"),
    ("window256_s2048", 1, 12, 2, 2048, 128, True, 256, "bfloat16"),
    ("ragged_s1000", 1, 12, 2, 1000, 128, True, None, "bfloat16"),
    # the split grid at MQA, ragged edges of the 128-key dkdv tile, D 256 bf16
    ("mqa8_1_d128_s1000", 1, 8, 1, 1000, 128, True, None, "bfloat16"),
    ("bf16_s63_d64", 2, 4, 2, 63, 64, True, None, "bfloat16"),
    ("bf16_s65_d64", 2, 4, 2, 65, 64, True, None, "bfloat16"),
    ("bf16_s129_d64", 2, 4, 2, 129, 64, True, None, "bfloat16"),
    ("bf16_d256_s129", 2, 4, 2, 129, 256, True, None, "bfloat16"),
    # off the split grid, the group summed inside a dkdv block: 5 x 2 x 32
    # blocks and 3 x 8 x 32, both over one and a half waves
    ("qwen2_b5_nosplit", 5, 12, 2, 4096, 128, True, None, "bfloat16"),
    ("granite_b3_f32_nosplit", 3, 24, 8, 2048, 64, True, None, "float32"),
)
BWD_F32_REL, LSE_REL = 1e-4, 1e-5
# flash_bwd_times: the wrapper, SDPA's backward and the two dkdv grids (the
# shape's and the other, forced) timed in turn over BWD_WINDOWS windows of
# `reps` calls each; the median and the spread are kept.
BWD_WINDOWS = 5
# The split rule's sweep (bwd_grid_sweep): qwen2's 12:2 D 128 S 4096 causal
# at batch 1-5 in bf16 (64-320 kv-head blocks of 128 keys) and 1-3 in
# float32 (128-384 of 64), the kernels on each dkdv grid timed in turn.
BWD_GRID_SWEEP = (tuple((b, "bfloat16") for b in range(1, 6))
                  + tuple((b, "float32") for b in range(1, 4)))
# A gradient row is held in bf16 ulps of the larger of its own scale and
# BWD_ROW_FLOOR of the gradient's: row 0 of dQ under the causal mask is
# P (dP - D) with P = 1 and dP = D up to rounding, a sum that cancels to 0 in
# one order and to 1e-9 in another.
BWD_ROW_FLOOR = 2.0 ** -10
#: The FLASH_CASES and SSD_CASES that phase 5 times: (case, the configuration
#: whose prefill gives the shape).
FAMILY_FLASH = {"gemma_mqa8_1_d256_f32": "gemma-2b", "qwen2_gqa12_2_d128": "qwen2-1.5b",
                "granite_gqa24_8_d64": "granite-moe-3b-a800m",
                "whisper_encoder_s1500": "whisper-large-v3",
                "llama_vision_gqa32_8_d128": "llama-3.2-vision-11b"}
FAMILY_SSD = {"mamba2_130m_prefill": "mamba2-130m"}
SSD_CASES = (
    ("zamba2_prefill", 4, 2048, 64, 64, 64, "bfloat16", "strided"),
    ("zamba2_ragged", 1, 1000, 64, 64, 64, "bfloat16", "strided"),
    ("t2048_chunk256_n128", 2, 2048, 8, 128, 256, "float32", "log"),
    ("t1000_chunk64_n128", 2, 1000, 8, 128, 64, "float32", "log"),
    ("t1000_chunk256_n64", 2, 1000, 8, 64, 256, "bfloat16", "log"),
    ("t2048_chunk64_n64", 2, 2048, 8, 64, 64, "float32", "log"),
    ("a_form_t1000", 2, 1000, 4, 64, 64, "float32", "a"),
    ("t1", 2, 1, 4, 64, 64, "float32", "log"),
    # The chunk-parallel split: T within one chunk, T = 1 strided at N 128,
    # T = 64 k + 1 (a last chunk of one step, also inside a 256-step chunk),
    # the prefill's width in float32, and H that the head group (16, from
    # ops.heads_per_block at these sizes) does not divide.
    ("t50_one_chunk", 2, 50, 8, 64, 64, "float32", "log"),
    ("t1_n128_strided", 3, 1, 8, 128, 64, "bfloat16", "strided"),
    ("t641_64k_plus_1", 2, 641, 8, 64, 64, "float32", "log"),
    ("t1025_chunk256_n128", 2, 1025, 8, 128, 256, "bfloat16", "log"),
    ("b4_h64_f32", 4, 2048, 64, 64, 64, "float32", "log"),
    ("h24_group16", 4, 2112, 24, 64, 64, "float32", "log"),
    ("h20_group16_n128", 4, 2112, 20, 128, 64, "bfloat16", "strided"),
    # mamba2-130m's prefill (24 heads, N 128, chunk 256; head groups of 8 at
    # this size), and its heads under groups of 16 (a last group of 8) at N 128.
    ("mamba2_130m_prefill", 4, 2048, 24, 128, 256, "bfloat16", "strided"),
    ("h24_group16_n128", 4, 2112, 24, 128, 64, "bfloat16", "strided"),
)
# The SSD backward kernels (ssd_bwd_state_pass_kernel, ssd_bwd_chunk_scan_kernel,
# ssd_bwd_reduce_kernel) against ssd_chunked_bwd_ref on the same operands
# (the forward kernels' scratch, a random dy and, where the last field says
# so, a random final-state cotangent; else none, as in training): (name, B,
# T, H, N, chunk, dtype, form, final).  float32 within BWD_F32_REL of each
# gradient's scale; bfloat16 dB, dC and dx (each one float32 sum rounded
# once, on both sides) also within SSD_BWD_BF16_RTOL (one bf16 ulp) of the
# value, and by the ratio rule (BF16_L2, BF16_ULP) against the plain version
# from the float32 gradient; two runs and each kernel launched alone
# bitwise.  The state pass is also held on what it leaves in the dS' scratch,
# launched alone (STAGES): the gradient dS' of the state leaving each chunk,
# against ssd_chunked_bwd_ref's (states=True), within BWD_F32_REL of the
# scale in both dtypes (the chunk sums it adds stay in its registers).
STAGES = {"ssd_bwd_state_pass_kernel": "dS'"}
SSD_BWD_CASES = (
    ("t1", 2, 1, 4, 64, 64, "float32", "log", True),
    ("t50_one_chunk", 2, 50, 8, 64, 64, "float32", "log", True),
    ("t641_64k_plus_1", 2, 641, 8, 64, 64, "float32", "log", False),
    ("t1000_chunk256_n64", 2, 1000, 8, 64, 256, "bfloat16", "log", True),
    ("t2048_chunk256_n128", 2, 2048, 8, 128, 256, "float32", "log", True),
    ("t1025_chunk256_n128", 2, 1025, 8, 128, 256, "bfloat16", "log", False),
    ("t1_n128_strided", 3, 1, 8, 128, 64, "bfloat16", "strided", True),
    ("h24_group16", 4, 2112, 24, 64, 64, "float32", "log", True),
    ("h20_group16_n128", 4, 2112, 20, 128, 64, "bfloat16", "strided", True),
    ("zamba2_ragged", 1, 1000, 64, 64, 64, "bfloat16", "strided", True),
    # the mma tiles' edges inside a sub-chunk: 17 and 36 rows in the last
    ("t17_n128_f32", 2, 17, 8, 128, 64, "float32", "log", True),
    ("t100_n128_f32", 2, 100, 8, 128, 64, "float32", "log", False),
    ("t641_n64_bf16_final", 2, 641, 8, 64, 64, "bfloat16", "strided", True),
    # the training shapes (phase "4 lm training", 2 x 4096)
    ("mamba2_130m_train", 2, 4096, 24, 128, 256, "bfloat16", "strided", False),
    ("mamba2_130m_train_f32", 2, 4096, 24, 128, 256, "float32", "strided", False),
    ("zamba2_train", 2, 4096, 64, 64, 64, "bfloat16", "strided", False),
    ("zamba2_train_f32", 2, 4096, 64, 64, 64, "float32", "strided", False),
)
SSD_BWD_BF16_RTOL = 2.0 ** -7
# Phase 5 times the SSD backward at these training shapes: (B, T, H, N, chunk).
SSD_BWD_TIMED = {"zamba2-1.2b": (2, 4096, 64, 64, 64), "mamba2-130m": (2, 4096, 24, 128, 256)}
# ... and its three kernels at each of these head groups (ssd_bwd_group_sweep).
SSD_BWD_GROUPS = (2, 4, 8, 12, 16)
# The Zamba2 serving path: the full configuration, random weights from
# LM.init(LM_SEED), two request batches of (prompts, tokens), greedy decode
# steps.  Kernel vs plain path: float32 within F32_REL of each value's scale
# (max |diff| over max |value|).  bfloat16: a bf16 prefill's values spread
# by a few % of their scale between any two runs whose float32 sums differ
# in order, since each flipped rounding travels through 38 layers.  So each
# kernel call of a bf16 kernel-path prefill is held against its plain
# version on the same operands, at the phase-3 tolerances (FLASH_TOL,
# SSD_TOL); and end to end the kernel path may lie no farther from the
# float32 plain run than a bf16 comparator does: the same model with its
# kernels swapped for their plain versions (``flash_ref``, ``ssd_chunked_ref``,
# which round where the kernels do), and the JAX-style plain path (which
# rounds the attention logits to bf16, as the JAX model does).  Its relative
# L2 error at most BF16_L2 times the comparator's and its max error at most
# BF16_MAX times, each plus one bf16 ulp (2**-8).  The max of a small leaf is
# a noisy statistic: on the first full run its kernel/plain ratio reached
# 1.48 (the decoded SSM states).
LM_ARCH, LM_SEED, LM_DECODE = "zamba2-1.2b", 0, 32
LM_BATCHES = ((4, 2048), (1, 1000))
F32_REL = 1e-4
BF16_L2, BF16_MAX, BF16_ULP = 1.5, 2.0, 2.0 ** -8
# The other LM families (phase "4 lm families"): each configuration at full
# width and depth, random weights from LM.init(LM_SEED) on the card, one
# FAMILY_BATCH request (whisper's encoder frames and llama-vision's image
# embeddings drawn from a generator seeded with LM_SEED), a counted prefill
# and LM_DECODE decode steps, in four runs on the same weights: bf16 with
# the kernels (greedy), bf16 with the kernels swapped for their plain
# versions, float32 with the kernels (the bf16 runs' yardstick) and float32
# on the plain path, the last three fed the first's tokens.  The float32
# kernel run within F32_REL of the plain run's scale; bf16 by the ratio
# rule against the swapped run; a bf16 prefill's kernel calls each held
# against its plain version.  Exact (flash_attention, ssd_log) launches a
# prefill, none a decode step:
LM_FAMILIES = {"mamba2-130m": (0, 24), "qwen2-1.5b": (28, 0), "gemma-2b": (18, 0),
               "granite-moe-3b-a800m": (32, 0), "whisper-large-v3": (64, 0),
               "llama-3.2-vision-11b": (40, 0)}
FAMILY_BATCH = (4, 2048)
# MoE routing.  A run whose activations differ by a rounding can choose
# another expert where two router logits (bf16 in a bf16 run) are within
# that rounding of each other, and a token with another expert set moves by
# a whole expert's output: no tolerance on values covers that.  So the bf16
# kernel run's expert choices are recorded and replayed into the three
# other runs, and each run's own choices are counted as routing flips with
# their margins: the least gap, in that run's router logits, between an
# expert it chose that the kernel run did not and one the kernel run chose
# that it did not, in bf16 ulps of the larger logit (0: a tie).  These are
# reported, as the coadd's decision flips are.  In the bf16 prefill whose
# kernel calls are held, each MoE layer's input is also routed as it would
# be with the layer's attention computed by flash_ref on the same operands.
# Each such flip must be one the two sets of logits imply (the pair it
# swaps ordered one way by one set and the other way by the other, ties
# by the lower index): anything else is a fault of the top-k or its tie
# rule.  Its margin is reported with the count beyond FLIP_ULPS: on the
# H100, one flash call's rounding moves a router logit by up to 5 ulps.
FLIP_ULPS = 1.0
PATH_NAMES = {True: "kernel", False: "plain", "swapped": "swapped"}
# The LM training path (phase "4 lm training"): each of TRAIN_CELLS at full
# width (TRAIN_ARCH, qwen2-1.5b: 28 layers, d_model 1536, GQA 12:2, head dim
# 128, vocab 151936, 1.54 B parameters; mamba2-130m: 24 Mamba-2 layers, d_model
# 768, 24 SSD heads, N 128, chunk 256; zamba2-1.2b: 38 Mamba-2 layers, d_model
# 2048, 64 SSD heads, N 64, and a shared attention block of 32 heads after
# every 6; each its own config file) and depth unless the cell cuts it,
# float32 masters, bf16 compute, remat on, at train_4k's sequence length with
# the global batch cut from 256 to TRAIN_BATCH[0] so that one card holds a
# step.  (a) One step's loss, grad norm and every gradient leaf on the kernel
# path (use_kernels=True) against the model's plain path, on the same weights
# (LM.init(TRAIN_SEED)) and batch: float32 within F32_REL of each leaf's
# scale; bf16 by the ratio rule (BF16_L2, BF16_MAX, BF16_ULP) against two
# comparators, the plain path and the kernel path with its kernels swapped
# for their plain versions, each measured from the float32 kernel run.  A
# step launches exactly `step_launches`, worked out from the config alone
# and cross-checked against the model's remat units (`unit_launches`):
# each forward kernel twice a layer
# under remat (once in the hybrid's tail layers) and each backward kernel
# once a layer (flash_bwd_dkdv_reduce_kernel where ops.bwd_split picks the
# split grid, as it does at qwen2's bf16 shape): mamba2 48 SSD forward and 24
# of each SSD backward kernel, Zamba2 74 and 38 with 12 flash forward and 6
# of each flash backward kernel.  (b) TRAIN_STEPS AdamW steps
# (make_train_step) on TokenPipeline batches of synthetic_corpus, then one
# more step instrumented with CUDA events (the flash and SSD backward calls
# each timed).  (c) The crash/resume drill through launch/train.py's loop
# (TRAIN_DRILL: qwen2's widths, 2 layers); final losses within DRILL_TOL
# (tests/test_distributed.py:93's bound).
TRAIN_ARCH, TRAIN_SEED = "qwen2-1.5b", 0
TRAIN_CELLS = ((TRAIN_ARCH, {}), ("mamba2-130m", {}), ("zamba2-1.2b", {}))
# A configuration whose SSD chunks are longer than the kernels' 64-step
# sub-chunks (mamba2-130m: 256) holds its float32 kernel path against the
# plain path run in float64: the float32 plain form rounds its decay sums at
# |cum| in the thousands there, and on the H100 its own A_log gradient lies
# 1.7e-4 of the scale from the float64 one (the kernel path's 4.3e-5).
SSD_FAMILIES = ("ssm", "hybrid")
TRAIN_BATCH = (2, 4096)
TRAIN_STEPS = 10
TRAIN_DRILL = dict(n_layers=2, vocab=512, steps=12, global_batch=4, seq_len=256, ckpt_every=4,
                   crash_at=6)
DRILL_TOL = 1e-6


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


@contextlib.contextmanager
def phase(name):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` warm calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def coadd_bound(n_slots, h, w, q, sample_ops=COADD_SAMPLE_OPS, maps=4):
    """Bound of one pack-scan pass over ``n_slots`` scanned slots.

    ``maps`` counts the (Q, Q) float32 maps read or written: the two grids,
    the fixed operands and the outputs (4 for coadd_fused).
    """
    nbytes = n_slots * (h * w + 8 + 1) * 4 + maps * q * q * 4  # pixels, wcs, accept; maps
    ops = n_slots * q * q * sample_ops + q * q * PIXEL_OPS + n_slots * SLOT_OPS
    return bound(nbytes, ops)


def contrib_bound(depth_sum, n_accepted, h, w, q, sample_ops=COADD_SAMPLE_OPS, maps=4):
    """Bound of one pack-scan pass over the work that contributes: the
    samples that land inside an accepted frame (the pass's depth map summed,
    unit weights) and the accepted slots' pixels, beside the (Q, Q) maps.
    A culled scan skips the rest, so it may run below `coadd_bound`."""
    nbytes = n_accepted * h * w * 4 + maps * q * q * 4
    ops = depth_sum * sample_ops + q * q * PIXEL_OPS
    return bound(nbytes, ops)


def batch_bound(depth_sum, n_accepted, k, h, w, q, sample_ops=COADD_SAMPLE_OPS, maps=4):
    """`contrib_bound` of one batched pass over K queries: the pixels of the
    slots any query accepts read once (the queries share them), each
    query's ``maps`` (Q, Q) maps, and every query's contributing samples
    (``depth_sum`` over all K)."""
    nbytes = n_accepted * h * w * 4 + k * maps * q * q * 4
    ops = depth_sum * sample_ops + k * q * q * PIXEL_OPS
    return bound(nbytes, ops)


def device_breakdown(torch, prof, wall_ms, pass_ms):
    """A profiled interval's device work -> one line: the device time of the
    largest kernels and copies, the device's busy time (the union of its
    events) and its idle share of the host interval ``wall_ms`` and of the
    pass interval ``pass_ms``."""
    spans, by_name = [], {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (end - start) / 1e3
    busy, last = 0.0, None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    busy /= 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (f"device busy {busy:.3f} ms of {wall_ms:.1f} ms host ({100 * (1 - busy / wall_ms):.1f} % "
            f"idle; pass {pass_ms:.3f} ms, {100 * max(0.0, 1 - busy / pass_ms):.1f} % idle); by "
            "kernel and copy (ms): " + ", ".join(f"{n[:48]} {t:.3f}" for n, t in top))


def offset_queries(CoaddQuery, base, offsets):
    """The query ``base`` (a dict) moved by each RA offset (deg)."""
    lo, hi = base["ra_bounds"]
    return [CoaddQuery(**{**base, "ra_bounds": (lo + o, hi + o)}) for o in offsets]


def warp_bound(n, h, w, q):
    """Bound of one warp_project launch over ``n`` images."""
    nbytes = n * (h * w + 8 + 1) * 4 + 2 * q * q * 4 + 2 * n * q * q * 4
    ops = n * q * q * WARP_SAMPLE_OPS + q * q * PIXEL_OPS + n * SLOT_OPS
    return bound(nbytes, ops)


def psf_ops(taps):
    """fp32 operations a matched pixel costs for a bank of ``taps`` widths."""
    if all(k == 1 for k in taps):
        return 1
    return 2 * taps[0] * taps[1] if len(taps) == 2 else 4 * taps[0]


def psf_bound(n_img, h, w, taps):
    """Bound of one psf_match launch over ``n_img`` frames: each frame read
    once, each matched frame written once, each slot's taps read once."""
    ntaps = 1
    for k in taps:
        ntaps *= k
    nbytes = n_img * (2 * h * w + ntaps) * 4
    return bound(nbytes, n_img * h * w * psf_ops(taps))


def template_args(tail):
    """The template arguments at the head of a mangled name's tail (what
    follows the kernel's name), readably: "SumAcc, culled", "bf16, 64"."""
    head = tail.split("Ev", 1)[0]
    token = re.compile(r"NS_(\d+)|(\d+)__nv_bfloat16|If|Li(-?\d+)E|Lb([01])E")
    out, i = [], 0
    while i < len(head):
        m = token.match(head, i)
        if not m:
            i += 1
            continue
        i = m.end()
        if m.group(1):                      # a name of the kernel's namespace
            out.append(head[i:i + int(m.group(1))])
            i += int(m.group(1))
        elif m.group(2):
            out.append("bf16")
        elif m.group(0) == "If":
            out.append("f32")
        elif m.group(3):
            out.append(m.group(3))
        else:
            out.append("culled" if m.group(4) == "1" else "unculled")
    return ", ".join(out)


def ptxas_summary(log, kernel):
    """Registers and spills of each instantiation of ``kernel`` from its
    source's ``nvcc -Xptxas -v`` output -> {"kernel<64>": "80 registers, 0
    bytes spill stores, 0 bytes spill loads"}; {} when the log is empty (the
    library was already built)."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            current = None
            if re.search(rf"\d{kernel}[IE]", mangled):   # the name, not a longer one
                args = template_args(mangled.split(kernel, 1)[1])
                current = f"{kernel}<{args}>" if args else kernel
                out[current] = ""
        elif current and "spill stores" in line:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[current] += f", {spills.group(1)} bytes spill stores, {spills.group(2)} loads"
        elif current and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out[current] = f"{regs.group(1)} registers" + out[current]
            current = None
    return out


def grid_sample_grid(torch, sky_to_pixel, wcs, grid_ra, grid_dec, h, w):
    """(N,Q,Q,2) normalized sampling grid of ``F.grid_sample`` (align_corners)."""
    n = wcs.shape[0]
    out = torch.empty((n,) + tuple(grid_ra.shape) + (2,), device=wcs.device)
    for i in range(0, n, 64):
        wv = wcs[i:i + 64]
        sx, sy = sky_to_pixel(grid_ra, grid_dec, wv.T.reshape(8, wv.shape[0], 1, 1))
        out[i:i + 64, ..., 0] = sx / (w - 1) * 2 - 1
        out[i:i + 64, ..., 1] = sy / (h - 1) * 2 - 1
    return out


# ------------------------------------------------ the Zamba2 serving path --
def attention_pairs(s, causal, window):
    """Unmasked (q, k) pairs of one (batch, head) attention slice."""
    lo = (lambda q: max(q - window + 1, 0)) if window is not None else (lambda q: 0)
    return sum((q if causal else s - 1) - lo(q) + 1 for q in range(s))


def flash_bound(b, hq, hkv, s, d, causal, window, esize, tc_ops_per_s):
    """Bound of one flash_attention call: q, k, v read and o written once; per
    unmasked pair 4 D product flops at ``tc_ops_per_s`` and 5 float32 softmax
    operations (scale, max, subtract, exp, sum) on the CUDA cores."""
    pairs = b * hq * attention_pairs(s, causal, window)
    nbytes = (2 * hq + 2 * hkv) * b * s * d * esize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(4 * d * pairs / tc_ops_per_s, 5 * pairs / FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bound(b, t, h, n, p, chunk, esize):
    """Bound of one ssd_log call: inputs read and y, the state written once;
    float32 operations on the CUDA cores.  Per (batch, chunk) the causal half
    of C B^T; per (head, chunk) the decay mask (3 a pair), the causal half of
    G X, C S (not for the first chunk, whose state is 0) with its decay and
    sum (2 P a step), the weights on B (N a step), B^T X and the state's decay
    and sum; one add a step for the cumulative sum."""
    lc = min(chunk, t)
    sizes = [lc] * (t // lc) + ([t % lc] if t % lc else [])
    pairs = sum(r * (r + 1) // 2 for r in sizes)
    nc = len(sizes)
    ops = b * 2 * n * pairs + b * h * (
        3 * pairs + 2 * p * pairs + 2 * n * p * (t - sizes[0]) + 2 * p * t + n * t
        + 2 * n * p * t + 2 * n * p * nc + t)
    nbytes = 4 * b * t * h + (2 * b * t * n + b * t * h * p) * esize + 4 * (b * t * h * p
                                                                           + b * h * n * p)
    return bound(nbytes, ops)


def flash_rows(torch, what, out, plain, floor=0.0):
    """Hold a bf16 flash output against flash_ref row by row -> (largest
    per-row max |diff| in bf16 ulps of the row's largest |value|, relative L2
    error).  ``floor``: the row's scale is at least this share of the whole
    tensor's (a gradient row can be one exact cancellation: 0 in one sum
    order, 1e-9 in another)."""
    o, r = out.float(), plain.float()
    err = (o - r).abs().amax(-1)
    scale = torch.clamp_min(r.abs().amax(-1), floor * float(r.abs().max()))
    # bf16 spacing at the row's largest |value|: 2**(e - 8) for one in
    # [2**(e - 1), 2**e); a zero row allows no error at all.
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    ulps = float((err / torch.where(scale > 0, ulp, torch.full_like(ulp, 2.0 ** -133))).max())
    l2 = float((o - r).norm()) / max(float(r.norm()), 1e-30)
    require(ulps <= FLASH_ROW_ULPS and l2 <= FLASH_REL_L2,
            f"flash {what}: a row {ulps:.3g} bf16 ulps of its scale from flash_ref (limit "
            f"{FLASH_ROW_ULPS}), relative L2 {l2:.3g} (limit {FLASH_REL_L2})")
    return ulps, l2


def flash_cases(torch, flash, flash_ref, dev):
    """Hold csrc/flash.cu against its plain version in every FLASH_CASES case."""
    g = torch.Generator(device=dev).manual_seed(15)
    worst = 0.0
    for name, b, hq, hkv, s, d, causal, window, dtype, strided in FLASH_CASES:
        dt = getattr(torch, dtype)
        if strided:   # the model's (B, S, H, D) activations seen as (B, H, S, D)
            q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt).transpose(1, 2)
                       for h in (hq, hkv, hkv))
        else:
            q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(dt)
                       for h in (hq, hkv, hkv))
        out = flash(q, k, v, causal, window)
        plain = flash_ref(q, k, v, causal, window)
        torch.cuda.synchronize()
        require(out.shape == plain.shape and out.dtype == plain.dtype,
                f"flash {name}: shape or dtype")
        require(bool(torch.isfinite(out).all()), f"flash {name}: non-finite output")
        err = float((out.float() - plain.float()).abs().max())
        tol = FLASH_TOL[dtype]
        bad = (out.float() - plain.float()).abs() > tol + tol * plain.float().abs()
        require(not bool(bad.any()), f"flash {name}: max |diff| {err:.3g} beyond atol = rtol = "
                                     f"{tol}")
        worst = max(worst, err)
        rows = ""
        if dtype == "bfloat16":
            rows = ", row ulps {:.3g}, relative L2 {:.3g}".format(
                *flash_rows(torch, name, out, plain))
        print(f"  flash {name}: B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal} "
              f"window={window} {dtype}{' strided' if strided else ''}: max |diff| {err:.3g}"
              + rows)
    # bf16 operands off 16 bytes (views one element into their storage): the
    # tensor-core kernel copies their rows element by element.
    n = 2 * 4 * 129 * 64
    q, k, v = (torch.randn(n + 1, generator=g, device=dev).bfloat16()[1:].view(2, 4, 129, 64)
               for _ in range(3))
    out, plain = flash(q, k, v, True, None), flash_ref(q, k, v, True, None)
    torch.cuda.synchronize()
    tol = FLASH_TOL["bfloat16"]
    err = float((out.float() - plain.float()).abs().max())
    require(not bool(((out.float() - plain.float()).abs() > tol + tol * plain.float().abs()).any()),
            f"flash bf16_unaligned_s129: max |diff| {err:.3g} beyond atol = rtol = {tol}")
    ulps, l2 = flash_rows(torch, "bf16_unaligned_s129", out, plain)
    print(f"  flash bf16_unaligned_s129: B=2 Hq=4 Hkv=4 S=129 D=64 causal=True bfloat16, "
          f"operands off 16 bytes: max |diff| {err:.3g}, row ulps {ulps:.3g}, relative L2 "
          f"{l2:.3g}")
    return max(worst, err)


def sdpa_backward(torch, F, q, k, v, do, causal, window):
    """A function that runs F.scaled_dot_product_attention's backward at
    (q, k, v) with output gradient ``do`` -> (dq, dk, dv); the forward runs
    once, here.  A window is a boolean attn_mask (with the causal mask)."""
    from repro_torch.kernels.attention.ref import _mask

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    gqa = q.shape[1] != k.shape[1]
    if window is None:
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=gqa)
    else:
        out = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=gqa,
                                             attn_mask=_mask(q.shape[2], causal, window, q.device))
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)


def flash_bwd_cases(torch, dev):
    """Hold the forward's LSE and the backward kernels against their plain
    versions in every FLASH_BWD_CASES case -> {kernel: worst max |diff|}."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.attention.ref import dkdv_reduce_ref, flash_bwd_ref, flash_ref

    g = torch.Generator(device=dev).manual_seed(25)
    worst = dict.fromkeys(flash_ops.BWD_KERNELS, 0.0)
    grids = set()   # (dtype, split grid) of the GQA cases
    for name, b, hq, hkv, s, d, causal, window, dtype in FLASH_BWD_CASES:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt).transpose(1, 2)
                       for h in (hq, hkv, hkv, hq))
        scale = 1.0 / math.sqrt(d)
        o_plain_fwd = flash_ops._forward(q, k, v, causal, window, scale, with_lse=False)
        o, lse = flash_ops._forward(q, k, v, causal, window, scale, with_lse=True)
        _, lse_p = flash_ref(q, k, v, causal, window, scale, return_lse=True)
        torch.cuda.synchronize()
        require(torch.equal(o, o_plain_fwd), f"flash bwd {name}: the forward's O with the LSE "
                                             "written is not bitwise its O without")
        lse_err = float((lse - lse_p).abs().max())
        lse_lim = LSE_REL * max(float(lse_p.abs().max()), 1.0)
        require(lse_err <= lse_lim, f"flash bwd {name}: LSE max |diff| {lse_err:.3g} > "
                                    f"{lse_lim:.3g}")
        del o_plain_fwd, lse_p
        got = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window, scale)
        again = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window, scale)
        want = flash_bwd_ref(q, k, v, o, lse, do, causal, window, scale)
        (*alone, delta, part), calls = flash_ops.bwd_launches(q, k, v, o, lse, do, causal,
                                                              window, scale)
        for call in calls.values():   # each kernel alone, uncounted
            call()
        delta_p = (do.float() * o.float()).sum(-1)
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(got, again)) and
                all(torch.equal(a, c) for a, c in zip(got, alone)),
                f"flash bwd {name}: two backward runs on the same operands differ")
        split = part is not None
        require(split == ("flash_bwd_dkdv_reduce_kernel" in calls)
                == flash_ops.bwd_split(b, hq, hkv, s, flash_ops.bwd_key_tile(d, dt)),
                f"flash bwd {name}: the split grid's launches")
        if hq > hkv:
            grids.add((dtype, split))
        if split:   # the reduction on the dkdv kernel's partials, bitwise its plain version
            red = dkdv_reduce_ref(part, hkv, scale, dt)
            require(torch.equal(red[0], alone[1]) and torch.equal(red[1], alone[2]),
                    f"flash bwd {name}: flash_bwd_dkdv_reduce_kernel is not bitwise "
                    "dkdv_reduce_ref")
            del red
        errs = {}
        for what, x, y in zip(("dq", "dk", "dv"), got, want):
            require(x.shape == y.shape and x.dtype == y.dtype and x.stride(3) == 1,
                    f"flash bwd {name} {what}: shape, dtype or layout")
            require(bool(torch.isfinite(x).all()), f"flash bwd {name} {what}: non-finite")
            err = float((x.float() - y.float()).abs().max())
            scale_y = float(y.float().abs().max())
            if dtype == "float32":
                require(err <= BWD_F32_REL * scale_y, f"flash bwd {name} {what}: max |diff| "
                                                      f"{err:.3g} > {BWD_F32_REL} x {scale_y:.3g}")
                errs[what] = f"{err:.3g} of scale {scale_y:.3g}"
            else:
                tol = FLASH_TOL[dtype]
                bad = (x.float() - y.float()).abs() > tol + tol * y.float().abs()
                require(not bool(bad.any()), f"flash bwd {name} {what}: max |diff| {err:.3g} "
                                             f"beyond atol = rtol = {tol}")
                ulps, l2 = flash_rows(torch, f"bwd {name} {what}", x, y, BWD_ROW_FLOOR)
                errs[what] = f"{err:.3g} (row ulps {ulps:.3g}, relative L2 {l2:.3g})"
            kernel = "flash_bwd_dq_kernel" if what == "dq" else "flash_bwd_dkdv_kernel"
            worst[kernel] = max(worst[kernel], err)
        d_err = float((delta - delta_p).abs().max())
        require(d_err <= BWD_F32_REL * max(float(delta_p.abs().max()), 1.0),
                f"flash bwd {name}: D max |diff| {d_err:.3g}")
        worst["flash_bwd_preprocess_kernel"] = max(worst["flash_bwd_preprocess_kernel"], d_err)
        info = ""
        if dtype == "bfloat16":   # the ratio rule, both from the unrounded float32 gradient
            f32 = [t.float() for t in (q, k, v, do)]
            o32, lse32 = flash_ref(*f32[:3], causal, window, scale, return_lse=True)
            exact = flash_bwd_ref(*f32[:3], o32, lse32, f32[3], causal, window, scale)
            lib = sdpa_backward(torch, F, q, k, v, do, causal, window)()
            for w, x, y, e in zip(("dq", "dk", "dv"), got, lib, exact):
                mine, theirs = l2_rel(x, e), l2_rel(y, e)
                require(mine <= BF16_L2 * theirs + BF16_ULP,
                        f"flash bwd {name} {w}: relative L2 {mine:.3g} from the float32 "
                        f"gradient > {BF16_L2} x SDPA's {theirs:.3g} + {BF16_ULP:.3g}")
                info += f"{', ' if info else ''}{w} {mine:.3g} / {theirs:.3g}"
            info = "; relative L2 from the float32 gradient, kernels / SDPA: " + info
            del f32, o32, lse32, exact, lib
        print(f"  flash bwd {name}: B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal} "
              f"window={window} {dtype} strided{', split grid' if split else ''}: O with the "
              f"LSE bitwise O without, LSE max |diff| {lse_err:.3g}, D max |diff| {d_err:.3g}, "
              + ", ".join(f"{w} {e}" for w, e in errs.items())
              + ("; the reduction bitwise dkdv_reduce_ref" if split else "")
              + "; two runs bitwise" + info, flush=True)
        del q, k, v, do, o, lse, got, again, want, delta, delta_p, calls, alone, part
    torch.cuda.empty_cache()
    require(grids == {(t, sp) for t in ("bfloat16", "float32") for sp in (False, True)},
            f"flash bwd: a GQA case on each grid in each dtype, got {sorted(grids)}")
    return worst


def ssd_cases(torch, ssd_log, ssd, chunked_ref, batched_ref, ssd_heads_per_block, dev):
    """Hold csrc/ssd.cu against its plain versions in every SSD_CASES case."""
    g = torch.Generator(device=dev).manual_seed(16)
    worst = 0.0
    for name, b, t, h, n, chunk, dtype, form in SSD_CASES:
        log_a, Bm, Cm, x = ssd_operands(torch, g, dev, b, t, h, n, dtype, form)
        y_p, s_p = chunked_ref(log_a, Bm, Cm, x, chunk)
        if form == "a":
            a = torch.exp(log_a)
            y = ssd(a, Bm, Cm, x, chunk)
            s = None
            y_step = batched_ref(a, Bm, Cm, x)
        else:
            y, s = ssd_log(log_a, Bm, Cm, x, chunk)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(y).all()), f"ssd {name}: non-finite output")
        holds = [("y", y, y_p)] + ([("state", s, s_p)] if s is not None else [])
        if form == "a":
            holds.append(("y vs step scan", y, y_step))
        for what, got, want in holds:
            err = float((got.float() - want.float()).abs().max())
            atol = SSD_TOL * max(float(want.abs().max()), 1.0)
            require(err <= atol, f"ssd {name} {what}: max |diff| {err:.3g} > {atol:.3g}")
            worst = max(worst, err)
        group = ssd_heads_per_block(b, -(-t // min(chunk, 64)), h,
                                    torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"  ssd {name}: B={b} T={t} H={h} N={n} P={SSD_P} chunk={chunk} {dtype} {form} "
              f"group={group}: "
              + ", ".join(f"{what} max |diff| "
                          f"{float((got.float() - want.float()).abs().max()):.3g}"
                          for what, got, want in holds))
    return worst


def ssd_operands(torch, g, dev, b, t, h, n, dtype, form):
    """An SSD call's operands: log-decay spread over [-50, 0] a step (exp
    underflows float32 below -87), for ``a`` then redrawn as the log of a
    decay in [0.02, 0.97]; B, C and x as views of one (B, T, H P + 2 N)
    tensor (the model's slices of its conv output) for ``strided``, else
    contiguous."""
    dt = getattr(torch, dtype)
    log_a = -torch.rand((b, t, h), generator=g, device=dev) ** 4 * 50.0
    if form == "a":
        log_a = torch.log(torch.rand((b, t, h), generator=g, device=dev) * 0.95 + 0.02)
    if form == "strided":
        xbc = torch.randn((b, t, h * SSD_P + 2 * n), generator=g, device=dev).to(dt)
        return (log_a, xbc[..., h * SSD_P:h * SSD_P + n], xbc[..., h * SSD_P + n:],
                xbc[..., :h * SSD_P].reshape(b, t, h, SSD_P))
    Bm, Cm = (torch.randn((b, t, n), generator=g, device=dev).to(dt) for _ in range(2))
    return log_a, Bm, Cm, torch.randn((b, t, h, SSD_P), generator=g, device=dev).to(dt)


def ssd_bwd_cases(torch, dev):
    """Hold the SSD backward kernels against ssd_chunked_bwd_ref in every
    SSD_BWD_CASES case -> {kernel: worst max |diff| of what it writes}."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    g = torch.Generator(device=dev).manual_seed(27)
    worst = dict.fromkeys(ssd_ops.BWD_KERNELS, 0.0)
    names = ("dlog_a", "dB", "dC", "dx")
    for name, b, t, h, n, chunk, dtype, form, final in SSD_BWD_CASES:
        ops_in = ssd_operands(torch, g, dev, b, t, h, n, dtype, form)
        dy = torch.randn((b, t, h, SSD_P), generator=g, device=dev)
        ds = torch.randn((b, h, n, SSD_P), generator=g, device=dev) if final else None
        _, _, scratch = ssd_ops._forward(*ops_in, chunk, "float32")
        before = dict(ssd_ops.ssd_log_bwd.kernel_launches)
        got = ssd_ops.ssd_log_bwd(*ops_in, dy, ds, chunk, scratch)
        again = ssd_ops.ssd_log_bwd(*ops_in, dy, ds, chunk, scratch)
        outs, calls = ssd_ops.bwd_launches(*ops_in, dy, ds, chunk, scratch)
        staged = {}
        for kernel, call in calls.items():   # each kernel alone, uncounted
            call()
            if kernel in STAGES:   # what it leaves in the dS' scratch
                staged[kernel] = outs[4].clone()
        *want, ds_out = ssd_chunked_bwd_ref(*ops_in, dy, ds, chunk, states=True)
        torch.cuda.synchronize()
        counts = {k: v - before[k] for k, v in ssd_ops.ssd_log_bwd.kernel_launches.items()}
        require(counts == dict.fromkeys(ssd_ops.BWD_KERNELS, 2),
                f"ssd bwd {name}: two calls launched {counts}")
        require(all(torch.equal(a, c) and torch.equal(a, d)
                    for a, c, d in zip(got, again, outs[:4])),
                f"ssd bwd {name}: two backward runs on the same operands differ")
        errs = {}
        for (kernel, what), x, y in zip(STAGES.items(), staged.values(), (ds_out,)):
            err = float((x - y).abs().max())
            scale_y = float(y.abs().max())
            require(err <= BWD_F32_REL * scale_y, f"ssd bwd {name} {what} ({kernel}): max "
                                                  f"|diff| {err:.3g} > {BWD_F32_REL} x "
                                                  f"{scale_y:.3g}")
            errs[what] = f"{err:.3g} of scale {scale_y:.3g}"
            worst[kernel] = max(worst[kernel], err)
        for what, x, y in zip(names, got, want):
            require(x.shape == y.shape and x.dtype == y.dtype, f"ssd bwd {name} {what}: shape "
                                                               "or dtype")
            require(bool(torch.isfinite(x).all()), f"ssd bwd {name} {what}: non-finite")
            err = float((x.float() - y.float()).abs().max())
            scale_y = float(y.float().abs().max())
            if x.dtype == torch.float32:
                require(err <= BWD_F32_REL * scale_y, f"ssd bwd {name} {what}: max |diff| "
                                                      f"{err:.3g} > {BWD_F32_REL} x {scale_y:.3g}")
            else:   # both sides round one float32 sum to bf16: one ulp of the value
                bad = ((x.float() - y.float()).abs()
                       > BWD_F32_REL * scale_y + SSD_BWD_BF16_RTOL * y.float().abs())
                require(not bool(bad.any()), f"ssd bwd {name} {what}: max |diff| {err:.3g} "
                                             f"beyond {BWD_F32_REL} x {scale_y:.3g} + one bf16 "
                                             "ulp")
            errs[what] = f"{err:.3g} of scale {scale_y:.3g}"
            kernel = ("ssd_bwd_reduce_kernel" if what in ("dB", "dC")
                      else "ssd_bwd_chunk_scan_kernel")
            worst[kernel] = max(worst[kernel], err)
        info = ""
        if dtype == "bfloat16":   # the ratio rule, both from the float32 gradient
            exact = ssd_chunked_bwd_ref(ops_in[0], *(v.float() for v in ops_in[1:]), dy, ds,
                                        chunk)
            for what, x, y, e in zip(names[1:], got[1:], want[1:], exact[1:]):
                mine, theirs = l2_rel(x, e), l2_rel(y, e)
                require(mine <= BF16_L2 * theirs + BF16_ULP,
                        f"ssd bwd {name} {what}: relative L2 {mine:.3g} from the float32 "
                        f"gradient > {BF16_L2} x the plain version's {theirs:.3g} + "
                        f"{BF16_ULP:.3g}")
                info += f"{', ' if info else ''}{what} {mine:.3g} / {theirs:.3g}"
            info = "; relative L2 from the float32 gradient, kernels / plain: " + info
            del exact
        tile = min(chunk, ssd_ops.MAX_TILE)
        group = ssd_ops.heads_per_block(b, -(-t // tile), h,
                                        torch.cuda.get_device_properties(dev).multi_processor_count,
                                        ssd_ops.BWD_BLOCKS_PER_SM)
        print(f"  ssd bwd {name}: B={b} T={t} H={h} N={n} P={SSD_P} chunk={chunk} {dtype} "
              f"{form} group={group} final-state cotangent {'random' if final else 'none'}: "
              + ", ".join(f"{w} {e}" for w, e in errs.items())
              + "; two runs and the kernels alone bitwise" + info, flush=True)
        del ops_in, dy, ds, scratch, got, again, outs, calls, want, ds_out, staged
    torch.cuda.empty_cache()
    return worst


def ssd_bwd_bound(b, t, h, n, p, chunk, esize, n_groups):
    """Bounds of one ssd_log_bwd call in the kernels' decomposition
    (sub-chunks of min(chunk, 64)) -> ({kernel or "call": (ms, by)}, {kernel
    or "call": ms of the float32 CUDA-core reckoning}).

    The first is the larger of bytes (each input read and each output
    written once: the call log_a, B, C, x, dy in, d log_a, dB, dC, dx out; a
    kernel its own operands, the scratch included) and the operations on
    the units that run them: the products on the TF32 tensor cores, every
    3xTF32 pass counted (an operand read from bf16 takes no lo part, one
    pass fewer), the causal half of each (L, L) product; per (batch,
    sub-chunk) C B^T and the group's (sum W) B and (sum W)^T C, counted
    once, as if one group held every head; per (head, sub-chunk) D = dy x^T,
    A^T dy, dy S^T, x dS'^T, B dS' and the chunk sums C^T (e o dy); beside
    the float32 elementwise work on the CUDA cores (the mask and the
    products A, W and A o D, 5 a pair; the carry, 2 N P a sub-chunk).  The
    second counts every product once in float32 on the CUDA cores, as a
    float32 `fmaf` design runs them (per (head, sub-chunk) D, A^T dy, W B
    and W^T C, the three state products and the chunk sums; per (batch,
    sub-chunk) C B^T): a column to compare the tensor-core kernels with
    float32 CUDA-core ones."""
    tile = min(chunk, 64)
    sizes = [tile] * (t // tile) + ([t % tile] if t % tile else [])
    pairs = sum(r * (r + 1) // 2 for r in sizes)
    nc = len(sizes)
    state = 4 * b * nc * h * n * p          # one (B, n_chunks, H, N, P) float32 scratch
    cums = 4 * b * nc * h * 64
    ops_in, ops_dy, ops_bc = b * t * h * p * esize, 4 * b * t * h * p, b * t * n * esize
    part = 4 * 2 * b * nc * n_groups * 64 * n
    lo = int(esize == 4)                    # the lo pass of an operand read from float32
    state_prod = 2 * b * h * n * p * t      # one (N, P) product over every step of every head
    pass_tc = state_prod * (2 + lo)
    scan_tc = (b * (2 * n * pairs * (1 + 2 * lo) + 2 * 2 * n * pairs * (2 + lo))
               + b * h * 2 * p * pairs * ((2 + lo) + 3) + state_prod * (3 + 2 * (2 + lo)))
    scan_fp = 5 * b * h * pairs
    carry = 2 * b * h * nc * n * p

    def on_units(nbytes, tc_ops, fp_ops):
        by = {"bytes": nbytes / HBM_BYTES_PER_S, "TF32 operations": tc_ops / TF32_TC_OPS_PER_S,
              "fp32 operations": fp_ops / FP32_OPS_PER_S}
        name = max(by, key=by.get)
        return by[name] * 1e3, name

    parts = {
        "ssd_bwd_state_pass_kernel": on_units(ops_bc + ops_dy + cums + state, pass_tc, carry),
        "ssd_bwd_chunk_scan_kernel": on_units(2 * ops_bc + ops_in + ops_dy + 2 * state + cums
                                              + 4 * b * t * h + ops_in + part, scan_tc, scan_fp),
        "ssd_bwd_reduce_kernel": on_units(part + 2 * ops_bc, 0, part // 4),
    }
    parts["call"] = on_units(8 * b * t * h + 4 * ops_bc + 2 * ops_in + ops_dy,
                             pass_tc + scan_tc, scan_fp + carry)
    fp32_scan = b * (2 * n * pairs + h * (pairs * (4 * p + 4 * n + 5) + 6 * n * p * t))
    fp32 = {
        "ssd_bwd_state_pass_kernel": bound(ops_bc + ops_dy + cums + state,
                                           state_prod + carry)[0],
        "ssd_bwd_chunk_scan_kernel": bound(2 * ops_bc + ops_in + ops_dy + 2 * state + cums
                                           + 4 * b * t * h + ops_in + part, fp32_scan)[0],
        "ssd_bwd_reduce_kernel": parts["ssd_bwd_reduce_kernel"][0],
        "call": bound(8 * b * t * h + 4 * ops_bc + 2 * ops_in + ops_dy,
                      fp32_scan + state_prod + carry)[0],
    }
    return parts, fp32


def ssd_forward_by_kernel(torch, ssd_ops, ops_in, chunk, reps):
    """Device ms of each forward kernel of one ssd_log call on ``ops_in``,
    from a profiler trace of ``reps`` calls ({} when the trace holds no
    device time)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ssd_ops._forward(*ops_in, chunk, "float32")
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for part in ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel"):
            if part in ev.key and dt:
                parts[part] = parts.get(part, 0.0) + dt / reps / 1e3
    return parts


def ssd_bwd_group_sweep(torch, ssd_ops, ops_in, dy, chunk, scratch, reps):
    """The backward's three kernels at each head group of SSD_BWD_GROUPS
    (the chunk scan's blocks own that many heads) -> {group: ms}."""
    out = {}
    for group in SSD_BWD_GROUPS:
        _, calls = ssd_ops.bwd_launches(*ops_in, dy, None, chunk, scratch, group=group)

        def run():
            for call in calls.values():
                call()
        out[group] = cuda_ms(torch, run, reps)
        del calls
    return out


def ssd_bwd_times(torch, dev, reps, launches, case_err, logs):
    """The SSD backward at each training shape of SSD_BWD_TIMED: through the
    wrapper, each kernel launched alone (CUDA events, warm), the plain
    version, the bounds (on the units that run it, and the float32
    CUDA-core reckoning), the forward's kernels at the same shape, the head
    group swept -> the kernels' rows (the first shape's numbers, every
    shape's in ``bwd_shapes``)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    g = torch.Generator(device=dev).manual_seed(28)
    shapes = []
    for arch, (b, t, h, n, chunk) in SSD_BWD_TIMED.items():
        ops_in = ssd_operands(torch, g, dev, b, t, h, n, "bfloat16", "strided")
        dy = torch.randn((b, t, h, SSD_P), generator=g, device=dev)
        _, _, scratch = ssd_ops._forward(*ops_in, chunk, "float32")
        outs, calls = ssd_ops.bwd_launches(*ops_in, dy, None, chunk, scratch)
        n_groups = outs[5].shape[3]
        wrapper_ms = cuda_ms(torch, lambda: ssd_ops.ssd_log_bwd(*ops_in, dy, None, chunk,
                                                                scratch), reps)
        alone = {k: cuda_ms(torch, call, reps) for k, call in calls.items()}
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        ssd_ops.ssd_log_bwd(*ops_in, dy, None, chunk, scratch)
        call_bytes = torch.cuda.max_memory_allocated() - base_mem
        plain_ms = cuda_ms(torch, lambda: ssd_chunked_bwd_ref(*ops_in, dy, None, chunk), 2)
        fwd_ms = cuda_ms(torch, lambda: ssd_ops._forward(*ops_in, chunk, "float32"), reps)
        fwd_parts = ssd_forward_by_kernel(torch, ssd_ops, ops_in, chunk, reps)
        sweep = ssd_bwd_group_sweep(torch, ssd_ops, ops_in, dy, chunk, scratch, reps)
        bounds, fp32 = ssd_bwd_bound(b, t, h, n, SSD_P, chunk, 2, n_groups)
        shape = (f"{arch} training: B={b} T={t} H={h} N={n} P={SSD_P} chunk {chunk} (sub-chunks "
                 f"of {min(chunk, 64)}), bf16 strided B, C, x, no final-state cotangent, "
                 f"{n_groups} head groups")
        shapes.append(dict(arch=arch, shape=shape, ms=wrapper_ms, alone_ms=alone,
                           plain_ms=plain_ms, forward_ms=fwd_ms, forward_by_kernel_ms=fwd_parts,
                           group_sweep_ms=sweep, call_bytes=call_bytes,
                           bound_ms=bounds["call"][0], bound_by=bounds["call"][1],
                           fp32_bound_ms=fp32["call"],
                           kernel_bounds={k: v[0] for k, v in bounds.items()},
                           kernel_bound_by={k: v[1] for k, v in bounds.items()},
                           kernel_fp32_bounds=fp32))
        print(f"  ssd backward at {shape}: through the wrapper {wrapper_ms:.3f} ms (alone: "
              + ", ".join(f"{k} {v:.4f}" for k, v in alone.items())
              + f"); bound {bounds['call'][0]:.4f} ms by {bounds['call'][1]} ("
              + ", ".join(f"{k} {v[0]:.4f} by {v[1]}" for k, v in bounds.items() if k != "call")
              + f"); float32 CUDA-core bound {fp32['call']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in fp32.items() if k != "call")
              + f"); plain ssd_chunked_bwd_ref {plain_ms:.3f} ms; the forward kernels "
              f"{fwd_ms:.3f} ms (by kernel, profiler: "
              + ", ".join(f"{k} {v:.4f}" for k, v in fwd_parts.items())
              + "); the backward by head group: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sweep.items())
              + f" ms; memory a call allocates {call_bytes} bytes; library: none", flush=True)
        del ops_in, dy, scratch, outs, calls
        torch.cuda.empty_cache()
    m = shapes[0]
    rows = []
    for kern in ssd_ops.BWD_KERNELS:
        rows.append(dict(
            name=kern, route="cuda", source="src/repro_torch/csrc/ssd.cu",
            replaces="none: the JAX package differentiates row 10's function in XLA "
                     "(src/repro/models/ssm.py:70, _ssd_chunked)",
            launches=launches[kern], max_abs_err=case_err[kern], ms=m["alone_ms"][kern],
            plain_ms=m["plain_ms"], plain="ssd_chunked_bwd_ref (all four gradients)",
            bound_ms=m["kernel_bounds"][kern], bound_by=m["kernel_bound_by"][kern],
            fp32_bound_ms=m["kernel_fp32_bounds"][kern],
            library_ms=None, library="none: no PyTorch call computes the SSD's gradient",
            backward_wrapper_ms=m["ms"], backward_bound_ms=m["bound_ms"], shape=m["shape"],
            ptxas=ptxas_summary(logs.get("ssd", ""), kern),
            **({"bwd_shapes": shapes} if kern == "ssd_bwd_chunk_scan_kernel" else {})))
    return rows


def family_shapes(torch, F, dev, reps):
    """The flash and SSD kernels at the other families' prefill shapes
    (FAMILY_FLASH, FAMILY_SSD): through the wrapper, launched alone (the C
    entry point on preallocated outputs, no checks), the plain version,
    flash's F.scaled_dot_product_attention, the bound, the max |diff| from
    the plain version and the launches a prefill.  -> (flash rows, ssd rows)."""
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.attention.ref import flash_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    g = torch.Generator(device=dev).manual_seed(18)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = {c[0]: c for c in FLASH_CASES}
    flash_out = []
    for name, arch in FAMILY_FLASH.items():
        _, b, hq, hkv, s, d, causal, window, dtype, _ = cases[name]
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt).transpose(1, 2)
                   for h in (hq, hkv, hkv))
        scale = 1.0 / math.sqrt(d)
        out = flash_ops.flash_attention(q, k, v, causal, window)
        err = float((out.float() - flash_ref(q, k, v, causal, window).float()).abs().max())
        k_ms = cuda_ms(torch, lambda: flash_ops.flash_attention(q, k, v, causal, window), reps)
        a_ms = cuda_ms(torch, lambda: flash_ops._launch(q, k, v, out, causal, window, scale,
                                                        q.device.index, stream), reps)
        p_ms = cuda_ms(torch, lambda: flash_ref(q, k, v, causal, window), 2)
        l_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hq != hkv), reps)
        esize = out.element_size()
        if dt == torch.bfloat16:
            b_ms, b_by = flash_bound(b, hq, hkv, s, d, causal, window, esize, BF16_TC_OPS_PER_S)
        else:   # float32: products and softmax on the CUDA cores
            pairs = b * hq * attention_pairs(s, causal, window)
            b_ms, b_by = bound((2 * hq + 2 * hkv) * b * s * d * esize, (4 * d + 5) * pairs)
        flash_out.append(dict(name=name, arch=arch, ms=k_ms, alone_ms=a_ms, plain_ms=p_ms,
                              library_ms=l_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                              launches_per_prefill=LM_FAMILIES[arch][0],
                              shape=f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal} "
                                    f"{dtype}, strided (B,S,H,D)"))
        del q, k, v, out
    cases = {c[0]: c for c in SSD_CASES}
    ssd_out = []
    for name, arch in FAMILY_SSD.items():
        _, b, t, h, n, chunk, dtype, _ = cases[name]
        dt = getattr(torch, dtype)
        log_a = -torch.rand((b, t, h), generator=g, device=dev) ** 4 * 50.0
        xbc = torch.randn((b, t, h * SSD_P + 2 * n), generator=g, device=dev).to(dt)
        ops_in = (log_a, xbc[..., h * SSD_P:h * SSD_P + n], xbc[..., h * SSD_P + n:],
                  xbc[..., :h * SSD_P].reshape(b, t, h, SSD_P))
        y, st = ssd_ops.ssd_log(*ops_in, chunk)
        y_p, st_p = ssd_chunked_ref(*ops_in, chunk)
        err = max(float((y - y_p).abs().max()), float((st - st_p).abs().max()))
        tile = min(chunk, ssd_ops.MAX_TILE)
        nc = -(-t // tile)
        group = ssd_ops.heads_per_block(b, nc, h,
                                        torch.cuda.get_device_properties(dev).multi_processor_count)
        scratch = (torch.empty((b, nc, h, n, SSD_P), device=dev),
                   torch.empty((b, nc, h, ssd_ops.MAX_TILE), device=dev))
        k_ms = cuda_ms(torch, lambda: ssd_ops.ssd_log(*ops_in, chunk), reps)
        a_ms = cuda_ms(torch, lambda: ssd_ops._launch(*ops_in, y, scratch[0], scratch[1], st,
                                                      tile, group), reps)
        p_ms = cuda_ms(torch, lambda: ssd_chunked_ref(*ops_in, chunk), 2)
        b_ms, b_by = ssd_bound(b, t, h, n, SSD_P, chunk, 2 if dt == torch.bfloat16 else 4)
        ssd_out.append(dict(name=name, arch=arch, ms=k_ms, alone_ms=a_ms, plain_ms=p_ms,
                            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                            launches_per_prefill=LM_FAMILIES[arch][1], group=group,
                            shape=f"B={b} T={t} H={h} N={n} P={SSD_P} chunk {chunk}, {dtype} "
                                  "strided B, C, x"))
        del log_a, xbc, ops_in, y, st, y_p, st_p, scratch
    for row in flash_out + ssd_out:
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.3f}"
        print(f"  {row['name']} ({row['arch']}, {row['shape']}): {row['ms']:.3f} ms "
              f"(alone {row['alone_ms']:.3f}, plain {row['plain_ms']:.3f}, library {lib}, "
              f"bound {row['bound_ms']:.4f} by {row['bound_by']}; max |diff| "
              f"{row['max_abs_err']:.3g}; {row['launches_per_prefill']} a prefill)", flush=True)
    return flash_out, ssd_out


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def max_rel(got, want):
    """max |got - want| over max |want| (in float64)."""
    scale = max(float(want.double().abs().max()), 1e-30)
    return float((got.double() - want.double()).abs().max()) / scale


def l2_rel(got, want):
    """||got - want|| over ||want|| (Frobenius norms, in float64)."""
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp_min(1e-300))


def lm_run(torch, model, params, batch, max_len, fed, counted, want_prefill,
           decoded_cache=True):
    """One serving run of ``batch`` ({"tokens": (B, S), ...}): a counted
    prefill, then LM_DECODE counted decode steps.

    The steps are greedy when ``fed`` is empty (the tokens are appended to
    it), else they take the tokens of ``fed``.  Returns the prefill logits,
    a copy of the prefill's cache, the decode logits, the final cache
    (unless ``decoded_cache`` is false), the timings and the peak memory
    and its rise over the memory allocated before the run, and the
    prefill's launch counts.
    """
    b, s = batch["tokens"].shape
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {k: fn.launches for k, fn in counted.items()}
    require(prefill_launches == want_prefill,
            f"prefill launches {prefill_launches}, expected {want_prefill}")
    prefill_cache = {path: leaf.clone() for path, leaf in tree_leaves(cache)}
    greedy = not fed
    for fn in counted.values():
        fn.launches = 0
    tok = logits.argmax(-1, keepdim=True)
    dec = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_DECODE):
        if greedy:
            fed.append(tok)
        lg, cache = model.decode_step(params, cache, fed[i], s + i)
        dec.append(lg)
        tok = lg.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    got = {k: fn.launches for k, fn in counted.items()}
    require(not any(got.values()), f"decode launched kernels: {got}")
    out = {"prefill logits": logits,
           **{f"prefill cache {p}": x for p, x in prefill_cache.items()},
           "decode logits": torch.stack(dec)}
    if decoded_cache:
        out.update({f"decoded cache {p}": x for p, x in tree_leaves(cache)})
    del cache
    for what, x in out.items():
        require(bool(torch.isfinite(x.float()).all()), f"{what}: non-finite values")
    peak = torch.cuda.max_memory_allocated()
    return out, dict(prefill_ms=prefill_ms, prefill_tokens_per_s=b * s / prefill_ms * 1e3,
                     decode_ms_per_token=decode_ms / LM_DECODE,
                     decode_tokens_per_s=b * LM_DECODE / decode_ms * 1e3,
                     max_memory_allocated=peak, memory_rise=peak - base_mem), prefill_launches


@contextlib.contextmanager
def lm_kernels_replaced(flash, ssd_log):
    """The model's kernel wrappers replaced by ``flash`` and ``ssd_log``,
    each of which receives the wrapper it replaces first."""
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    saved = flash_ops.flash_attention, ssd_ops.ssd_log
    flash_ops.flash_attention = functools.partial(flash, saved[0])
    ssd_ops.ssd_log = functools.partial(ssd_log, saved[1])
    # A wrapper counts its launches on its module's name: here on the
    # replacement, so launches made to compare stay out of the counts.
    flash_ops.flash_attention.launches = ssd_ops.ssd_log.launches = 0
    try:
        yield
    finally:
        flash_ops.flash_attention, ssd_ops.ssd_log = saved


def kernels_swapped_for_plain():
    """The model with its kernels swapped for their plain versions, which
    round where the kernels do (a bf16 comparator for the kernel path)."""
    from repro_torch.kernels.attention.ref import flash_ref
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    return lm_kernels_replaced(lambda _, *a: flash_ref(*a), lambda _, *a: ssd_chunked_ref(*a))


def kernels_held_per_call(held, rows):
    """The model with each kernel call also run through the kernel's plain
    version on the same operands.  ``held[name]`` gathers the calls, the
    largest |diff| and the largest |diff| over its allowance (the phase-3
    tolerances: FLASH_TOL as atol = rtol, SSD_TOL * max(scale, 1));
    ``rows`` the largest bf16 flash row ulps and relative L2 (`flash_rows`,
    which fails the run beyond its limits)."""
    import torch

    from repro_torch.kernels.attention.ref import flash_ref
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    def note(name, *holds):
        calls, err, over = held[name]
        for got, want, allowed in holds:
            diff = (got.float() - want.float()).abs()
            err, over = max(err, float(diff.max())), max(over, float((diff / allowed).max()))
        held[name] = (calls + 1, err, over)

    def flash(kernel, q, k, v, causal=True, window=None, scale=None):
        out = kernel(q, k, v, causal, window, scale)
        plain = flash_ref(q, k, v, causal, window, scale).float()
        tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
        note("flash_attention_single", (out, plain, tol + tol * plain.abs()))
        if q.dtype == torch.bfloat16:
            got = flash_rows(torch, "in the model", out, plain)
            rows[:] = [max(a, b) for a, b in zip(rows, got)]
        return out

    def ssd_log(kernel, log_a, Bm, Cm, x, chunk=64, intra_dtype="float32"):
        y, s = kernel(log_a, Bm, Cm, x, chunk, intra_dtype)
        y_p, s_p = ssd_chunked_ref(log_a, Bm, Cm, x, chunk, intra_dtype)
        note("ssd_chunked", *((got, want, SSD_TOL * max(float(want.abs().max()), 1.0))
                              for got, want in ((y, y_p), (s, s_p))))
        return y, s

    return lm_kernels_replaced(flash, ssd_log)


def zamba2_serving(torch, np, dev, counted):
    """The Zamba2 serving path at full width and depth: for each request
    batch, the kernel path and the plain path in bfloat16 and in float32 on
    the same weights and tokens (the bf16 kernel path decodes greedily; the
    other runs are fed its tokens), the bf16 kernel path's model with its
    kernels swapped for their plain versions, and a bf16 kernel-path prefill
    with each kernel call held against its plain version."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model

    base = get_config(LM_ARCH)
    models = {(dtype, kern): build_model(dataclasses.replace(base, dtype=dtype), device=dev,
                                         use_kernels=kern)
              for dtype in ("bfloat16", "float32") for kern in (True, False)}
    t0 = time.perf_counter()
    params = models["bfloat16", True].init(LM_SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, x in tree_leaves(params))
    groups = base.n_layers // base.shared_attn_period
    print(f"  {LM_ARCH}: {base.n_layers} Mamba-2 layers, {groups} shared-block applications, "
          f"d_model {base.d_model}, {n_params} float32 parameters from LM.init({LM_SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")
    # Warm each model up (cuBLAS handles, allocator) on a short prompt, uncounted.
    for model in models.values():
        model.prefill(params, {"tokens": torch.zeros((1, 128), dtype=torch.long, device=dev)},
                      128)
    none = {k: 0 for k in counted}
    want = dict(none, flash_attention_single=groups, ssd_chunked=base.n_layers)
    runs, launches = [], {k: 0 for k in counted}
    for b, s in LM_BATCHES:
        rng = np.random.default_rng(LM_SEED + s)
        tokens = torch.from_numpy(rng.integers(0, base.vocab_size, (b, s))).to(dev)
        fed = []
        res, stats = {}, {}
        for key in (("bfloat16", True), ("bfloat16", False), ("float32", True),
                    ("float32", False)):
            res[key], stats[key], got = lm_run(torch, models[key], params, {"tokens": tokens},
                                               s + LM_DECODE, fed, counted,
                                               want if key[1] else none)
            for k in counted:
                launches[k] += got[k]
        with kernels_swapped_for_plain():
            res["bfloat16", "swapped"], _, _ = lm_run(torch, models["bfloat16", True], params,
                                                      {"tokens": tokens}, s + LM_DECODE, fed,
                                                      counted, none)
        # Each kernel call of a bf16 kernel-path prefill against its plain
        # version on the same operands (uncounted: launches made to compare).
        held = dict.fromkeys(("flash_attention_single", "ssd_chunked"), (0, 0.0, 0.0))
        rows = [0.0, 0.0]
        with kernels_held_per_call(held, rows):
            models["bfloat16", True].prefill(params, {"tokens": tokens}, s + LM_DECODE)
        torch.cuda.synchronize()
        print(f"  {b} x {s} bfloat16 prefill, each kernel call vs its plain version on the "
              f"same operands (calls, max |diff|, max |diff| over its allowance): "
              + ", ".join(f"{k} ({n}, {e:.3g}, {o:.3g})" for k, (n, e, o) in held.items())
              + f"; flash row ulps {rows[0]:.3g}, relative L2 {rows[1]:.3g}", flush=True)
        for k, (n, _, over) in held.items():
            require(n == want[k] and over <= 1.0,
                    f"{b}x{s} bfloat16 {k}: {n} calls held, expected {want[k]}; largest "
                    f"|diff| {over:.3g} of its allowance")
        # float32: the kernel path within F32_REL of the plain path's scale.
        f32 = {w: max_rel(res["float32", True][w], res["float32", False][w])
               for w in res["float32", False]}
        print(f"  {b} x {s} float32 kernel vs plain, of the scale (limit {F32_REL}): "
              + ", ".join(f"{w} {v:.3g}" for w, v in f32.items()), flush=True)
        worst32 = max(f32, key=f32.get)
        require(f32[worst32] <= F32_REL, f"{b}x{s} float32 {worst32}: kernel vs plain "
                                         f"{f32[worst32]:.3g} of the scale > {F32_REL}")
        # bfloat16: the kernel path no farther from the float32 plain run than
        # either comparator is (relative L2 and max error, see BF16_L2).
        spread = {}
        for w, ref32 in res["float32", False].items():
            spread[w] = {path: (l2_rel(res["bfloat16", path][w], ref32),
                                max_rel(res["bfloat16", path][w], ref32))
                         for path in (True, "swapped", False)}
        for path, name in (("swapped", "swapped"), (False, "plain")):
            print(f"  {b} x {s} bfloat16 from the float32 plain run (kernel L2, {name} L2, "
                  f"kernel max, {name} max; kernel from {name}, max): "
                  + ", ".join(f"{w} ({sp[True][0]:.3g}, {sp[path][0]:.3g}, {sp[True][1]:.3g}, "
                              f"{sp[path][1]:.3g}; "
                              f"{max_rel(res['bfloat16', True][w], res['bfloat16', path][w]):.3g})"
                              for w, sp in spread.items()), flush=True)
            for w, sp in spread.items():
                (l2_k, mx_k), (l2_c, mx_c) = sp[True], sp[path]
                require(l2_k <= BF16_L2 * l2_c + BF16_ULP and mx_k <= BF16_MAX * mx_c + BF16_ULP,
                        f"{b}x{s} bfloat16 {w}: from the float32 run, kernel path L2 "
                        f"{l2_k:.3g} max {mx_k:.3g}, {name} path L2 {l2_c:.3g} max {mx_c:.3g}")
        for key, st in stats.items():
            run = dict(dtype=key[0], path="kernel" if key[1] else "plain", batch=b, prompt=s,
                       decode_steps=LM_DECODE, **st)
            runs.append(run)
            print(f"  {key[0]} {'kernel' if key[1] else 'plain '} {b} x {s}: prefill "
                  f"{st['prefill_ms']:.1f} ms ({st['prefill_tokens_per_s']:.0f} tokens/s), "
                  f"decode {st['decode_ms_per_token']:.2f} ms a step "
                  f"({st['decode_tokens_per_s']:.1f} tokens/s), max_memory_allocated "
                  f"{st['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        print(f"  {b} x {s} greedy tokens (first 8 of each sequence): "
              f"{torch.cat(fed, 1)[:, :8].tolist()}", flush=True)
        del res
    del params, models
    torch.cuda.empty_cache()
    return runs, launches


def bf16_ulps(torch, gap, scale):
    """``gap`` in bf16 ulps of ``scale`` (2**(e - 8) for |scale| in [2**(e-1), 2**e))."""
    return gap / torch.ldexp(torch.ones_like(scale), torch.frexp(scale.abs()).exponent - 8)


def routing_flips(torch, logits, own, forced, forced_logits=None):
    """The margins (`FLIP_ULPS`'s unit) of the tokens whose top-k set under
    ``logits`` (chosen: ``own``) is not ``forced``'s; an empty tensor if none.

    With ``forced_logits`` (the logits ``forced`` was chosen from) also each
    flip's logit change in the same unit, and the check that the flip is
    one the two sets of logits imply: the margin's pair (the least
    own-only logit ``lo``, the largest forced-only ``hi``) ordered the
    other way round by ``forced_logits`` (ties: the lower index first),
    so margin <= |change of lo| + |change of hi|.  -> (margins, changes,
    inconsistent flips)."""
    own_m = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    own_m.scatter_(-1, own, True)
    forced_m = torch.zeros_like(own_m).scatter_(-1, forced, True)
    differ = (own_m != forced_m).any(-1)
    z, om, fm = logits[differ], own_m[differ], forced_m[differ]
    lo_v, lo = torch.where(om & ~fm, z, float("inf")).min(-1)
    hi_v, hi = torch.where(fm & ~om, z, float("-inf")).max(-1)
    scale = torch.maximum(lo_v.abs(), hi_v.abs())
    margins = bf16_ulps(torch, lo_v - hi_v, scale)
    if forced_logits is None:
        return margins
    zf = forced_logits[differ]
    f_lo, f_hi = zf.gather(-1, lo[:, None])[:, 0], zf.gather(-1, hi[:, None])[:, 0]
    change = (f_lo - lo_v).abs() + (f_hi - hi_v).abs()
    own_order = (lo_v > hi_v) | ((lo_v == hi_v) & (lo < hi))
    forced_order = (f_hi > f_lo) | ((f_hi == f_lo) & (hi < lo))
    bad = int((~(own_order & forced_order)).sum())
    return margins, bf16_ulps(torch, change, scale), bad


def router_logits(params, x):
    from repro_torch.models.layers import cast

    return (x @ cast(params["router"], x.dtype)).float()


@contextlib.contextmanager
def routing(record=None, replay=None, flips=None):
    """The MoE router (`repro_torch.models.moe.route`) recording each call's
    expert choices into ``record``, or taking them from ``replay`` (in call
    order) and appending the run's own flips from them to ``flips``."""
    import torch

    from repro_torch.models import moe as moe_mod

    saved = moe_mod.route
    forced_calls = iter(replay if replay is not None else ())

    def route(params, x, cfg):
        gates, topv, topi = saved(params, x, cfg)
        if record is not None:
            record.append(topi)
        if replay is None:
            return gates, topv, topi
        forced = next(forced_calls)
        flips.append(routing_flips(torch, router_logits(params, x), topi, forced))
        topv = gates.gather(-1, forced)
        return gates, topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9), forced

    moe_mod.route = route
    try:
        yield
    finally:
        moe_mod.route = saved
    require(replay is None or next(forced_calls, None) is None,
            "a replayed run routed fewer times than the recorded one")


@contextlib.contextmanager
def moe_flips_per_call(flips):
    """Each MoE block also routes its input as it would be had the block's
    attention been ``flash_ref`` on the same operands; the flips between
    the two (margins in the plain routing's logits) go to ``flips``."""
    import torch

    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.attention.ref import flash_ref
    from repro_torch.models import attention as attn
    from repro_torch.models import blocks
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import rmsnorm

    saved = blocks.moe_block_apply

    def apply(params, x, cfg, return_kv=False, use_kernel=True):
        xn = rmsnorm(params["ln_attn"], x)
        kernel = flash_ops.flash_attention
        flash_ops.flash_attention = lambda q, k, v, causal=True, window=None, scale=None: (
            flash_ref(q, k, v, causal, window, scale))
        try:
            h_plain = attn.attend_full(params["attn"], xn, cfg, use_kernel=use_kernel)
        finally:
            flash_ops.flash_attention = kernel
        res = attn.attend_full(params["attn"], xn, cfg, return_kv=return_kv,
                               use_kernel=use_kernel)
        h, kv = res if return_kv else (res, None)
        xp = rmsnorm(params["ln_mlp"], x + h_plain)
        x = x + h
        xm = rmsnorm(params["ln_mlp"], x)
        _, _, topi_p = moe_mod.route(params["moe"], xp, cfg)
        _, _, topi_k = moe_mod.route(params["moe"], xm, cfg)
        flips.append(routing_flips(torch, router_logits(params["moe"], xp), topi_p, topi_k,
                                   router_logits(params["moe"], xm)))
        out, aux = moe_mod.moe_apply(params["moe"], xm, cfg)
        x = x + out
        return (x, aux, kv) if return_kv else (x, aux)

    blocks.moe_block_apply = apply
    try:
        yield
    finally:
        blocks.moe_block_apply = saved


def ulps_histogram(torch, values):
    """{bf16 ulps rounded to 0.5: tokens} of a list of margin tensors."""
    m = torch.cat([v.float().cpu() for v in values]) if values else torch.zeros(0)
    hist = {}
    for v in (m * 2).round().div(2).tolist():
        hist[v] = hist.get(v, 0) + 1
    return dict(sorted(hist.items()))


def flip_summary(torch, flips):
    """(flipped tokens, largest margin, margins as {ulps: tokens}) of a run."""
    hist = ulps_histogram(torch, flips)
    return sum(hist.values()), max(hist, default=0.0), hist


def lm_families(torch, np, dev, counted, card):
    """Every other LM family at full width and depth (`LM_FAMILIES`): per
    configuration four serving runs of one FAMILY_BATCH request (see
    LM_FAMILIES), a bf16 prefill with each kernel call held against its
    plain version, and the MoE routing flips.  -> (runs, launches)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model

    runs, launches = [], {k: 0 for k in counted}
    none = {k: 0 for k in counted}
    b, s = FAMILY_BATCH
    for arch, (n_flash, n_ssd) in LM_FAMILIES.items():
        base = get_config(arch)
        want = dict(none, flash_attention_single=n_flash, ssd_chunked=n_ssd)
        models = {(dtype, kern): build_model(dataclasses.replace(base, dtype=dtype), device=dev,
                                             use_kernels=kern)
                  for dtype, kern in (("bfloat16", True), ("float32", True), ("float32", False))}
        n_params = base.param_count()
        free, total = torch.cuda.mem_get_info(dev)
        require(4 * n_params < free, f"{arch}: {4 * n_params} bytes of float32 parameters, "
                                     f"{free} bytes free of {total}")
        t0 = time.perf_counter()
        params = models["bfloat16", True].init(LM_SEED)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for _, x in tree_leaves(params))
        print(f"  {arch} ({base.family}): {base.n_layers} layers"
              + (f" + {base.n_encoder_layers} encoder layers" if base.n_encoder_layers else "")
              + f", d_model {base.d_model}, {n_params} float32 parameters "
              f"({n_params * 4 / 2**30:.2f} GiB of {total / 2**30:.1f}) from "
              f"LM.init({LM_SEED}) in {time.perf_counter() - t0:.1f} s", flush=True)
        gen = torch.Generator(device=dev).manual_seed(LM_SEED)
        rng = np.random.default_rng(LM_SEED + s)

        def request(nb, ns):
            batch = {"tokens": torch.from_numpy(rng.integers(0, base.vocab_size, (nb, ns))).to(dev)}
            if base.family == "encdec":
                batch["enc_frames"] = torch.randn((nb, base.encoder_seq, base.d_model),
                                                  generator=gen, device=dev)
            if base.family == "vlm":
                batch["img_embeds"] = torch.randn((nb, base.n_image_tokens, base.d_model),
                                                  generator=gen, device=dev)
            return batch

        warm = request(1, 128)
        for model in models.values():   # cuBLAS handles, the allocator; uncounted
            model.prefill(params, warm, 128)
        del warm
        batch = request(b, s)
        fed, recorded, flips = [], [], {}
        res, stats = {}, {}
        for key in (("bfloat16", True), ("bfloat16", "swapped"), ("float32", True),
                    ("float32", False)):
            model = models["bfloat16", True] if key[1] == "swapped" else models[key]
            flips[key] = []
            with contextlib.ExitStack() as stack:
                stack.enter_context(routing(record=recorded) if key == ("bfloat16", True)
                                    else routing(replay=recorded, flips=flips[key]))
                if key[1] == "swapped":
                    stack.enter_context(kernels_swapped_for_plain())
                res[key], stats[key], got = lm_run(
                    torch, model, params, batch, s + LM_DECODE, fed, counted,
                    want if key[1] is True else none, decoded_cache=False)
            for k in counted:
                launches[k] += got[k]
        # Each kernel call of a bf16 kernel-path prefill against its plain
        # version on the same operands (uncounted), and the per-call flips.
        held = dict.fromkeys(("flash_attention_single", "ssd_chunked"), (0, 0.0, 0.0))
        rows, call_flips = [0.0, 0.0], []
        with kernels_held_per_call(held, rows), moe_flips_per_call(call_flips):
            models["bfloat16", True].prefill(params, batch, s + LM_DECODE)
        torch.cuda.synchronize()
        print(f"  {arch} {b} x {s} bfloat16 prefill, each kernel call vs its plain version on "
              f"the same operands (calls, max |diff|, max |diff| over its allowance): "
              + ", ".join(f"{k} ({n}, {e:.3g}, {o:.3g})" for k, (n, e, o) in held.items())
              + f"; flash row ulps {rows[0]:.3g}, relative L2 {rows[1]:.3g}", flush=True)
        for k, (n, _, over) in held.items():
            require(n == want[k] and over <= 1.0,
                    f"{arch} bfloat16 {k}: {n} calls held, expected {want[k]}; largest "
                    f"|diff| {over:.3g} of its allowance")
        moe_flips = {}
        if base.family == "moe":
            n, worst, hist = flip_summary(torch, [m for m, _, _ in call_flips])
            changes = ulps_histogram(torch, [c for _, c, _ in call_flips])
            bad = sum(x for _, _, x in call_flips)
            beyond = sum(v for k, v in hist.items() if k > FLIP_ULPS)
            moe_flips["per_call"] = dict(tokens=n, max_ulps=worst, ulps=hist,
                                         beyond_one_ulp=beyond, logit_change_ulps=changes)
            print(f"  {arch} routing flips per call (each MoE layer's input with its attention "
                  f"from flash_ref on the same operands; {b * s} tokens x {base.n_layers} "
                  f"layers): {n} tokens, {beyond} with a margin beyond {FLIP_ULPS} bf16 ulp; "
                  f"margins in bf16 logit ulps {hist}; the pair's logit change {changes}; "
                  f"{bad} not implied by the two sets of logits", flush=True)
            require(bad == 0, f"{arch}: {bad} routing flips per call not implied by the "
                              f"logits (a top-k or tie-rule fault)")
            for key in list(flips)[1:]:
                n, worst, hist = flip_summary(torch, flips[key])
                name = f"{key[0]} {PATH_NAMES[key[1]]}"
                moe_flips[name] = dict(tokens=n, max_ulps=worst, ulps=hist)
                print(f"  {arch} routing flips of the {name} run from the bf16 kernel run "
                      f"(prefill and {LM_DECODE} decode steps; replayed): {n} tokens, largest "
                      f"margin {worst:.3g} bf16 ulps, margins {hist}", flush=True)
        f32 = {w: max_rel(res["float32", True][w], res["float32", False][w])
               for w in res["float32", False]}
        worst32 = max(f32, key=f32.get)
        print(f"  {arch} float32 kernel vs plain, of the scale (limit {F32_REL}): largest "
              f"{worst32} {f32[worst32]:.3g}; prefill logits {f32['prefill logits']:.3g}, "
              f"decode logits {f32['decode logits']:.3g}", flush=True)
        require(f32[worst32] <= F32_REL, f"{arch} float32 {worst32}: kernel vs plain "
                                         f"{f32[worst32]:.3g} of the scale > {F32_REL}")
        yard = res["float32", True]
        worst_ratio = (0.0, "")
        for w, ref32 in yard.items():
            (l2_k, mx_k), (l2_c, mx_c) = ((l2_rel(res["bfloat16", p][w], ref32),
                                           max_rel(res["bfloat16", p][w], ref32))
                                          for p in (True, "swapped"))
            require(l2_k <= BF16_L2 * l2_c + BF16_ULP and mx_k <= BF16_MAX * mx_c + BF16_ULP,
                    f"{arch} bfloat16 {w}: from the float32 kernel run, kernel path L2 "
                    f"{l2_k:.3g} max {mx_k:.3g}, swapped L2 {l2_c:.3g} max {mx_c:.3g}")
            ratio = l2_k / max(l2_c, 1e-30)
            if ratio > worst_ratio[0]:
                worst_ratio = (ratio, f"{w}: L2 {l2_k:.3g} vs {l2_c:.3g}, max {mx_k:.3g} vs "
                                      f"{mx_c:.3g}")
        print(f"  {arch} bfloat16 from the float32 kernel run, kernel vs swapped (largest L2 "
              f"ratio): {worst_ratio[0]:.3g} ({worst_ratio[1]})", flush=True)
        for key, st in stats.items():
            path = PATH_NAMES[key[1]]
            runs.append(dict(arch=arch, family=base.family, dtype=key[0], path=path, batch=b,
                             prompt=s, decode_steps=LM_DECODE, card=card, **st,
                             **({"routing_flips": moe_flips} if moe_flips and path == "kernel"
                                and key[0] == "bfloat16" else {})))
            print(f"  {arch} {key[0]} {path} {b} x {s}: prefill {st['prefill_ms']:.1f} ms "
                  f"({st['prefill_tokens_per_s']:.0f} tokens/s), decode "
                  f"{st['decode_ms_per_token']:.2f} ms a step ({st['decode_tokens_per_s']:.1f} "
                  f"tokens/s), max_memory_allocated rise {st['memory_rise'] / 2**30:.2f} GiB "
                  f"(peak {st['max_memory_allocated'] / 2**30:.2f}); {card}", flush=True)
        print(f"  {arch} greedy tokens (first 8 of each sequence): "
              f"{torch.cat(fed, 1)[:, :8].tolist()}", flush=True)
        del res, params, models, batch, recorded, flips, yard
        torch.cuda.empty_cache()
    return runs, launches


def train_grads(torch, model, params, batch):
    """One forward and backward of ``model.loss`` -> (loss, grad norm,
    {path: gradient}, ms)."""
    from repro_torch.optim.adamw import global_norm

    paths, leaves = zip(*tree_leaves(params))
    for x in leaves:
        x.requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = dict(zip(paths, grads))
    return loss.detach(), global_norm(grads), grads, ms


def lm_counts():
    """Every LM kernel's launch count: the flash forward and each backward
    kernel, the SSD forward (``ssd_chunked``) and each SSD backward kernel."""
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    return {"flash_attention_single": flash_ops.flash_attention.launches,
            **flash_ops.flash_attention_bwd.kernel_launches,
            "ssd_chunked": ssd_ops.ssd_log.launches, **ssd_ops.ssd_log_bwd.kernel_launches}


def zero_lm_counts():
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    flash_ops.flash_attention.launches = ssd_ops.ssd_log.launches = 0
    flash_ops.flash_attention_bwd.launches = ssd_ops.ssd_log_bwd.launches = 0
    for counts in (flash_ops.flash_attention_bwd.kernel_launches,
                   ssd_ops.ssd_log_bwd.kernel_launches):
        for k in counts:
            counts[k] = 0


def step_launches(torch, cfg, b, s, dtype):
    """The launches one remat training step of a dense, ssm or hybrid
    configuration must make, from its config alone: each layer's forward
    kernel twice (the recompute), except the hybrid's n_layers %
    shared_attn_period tail layers, which are not rematted, once; each
    backward kernel once a layer (the flash reduction on the split grid
    only).  The hybrid's shared attention block after every
    shared_attn_period layers counts as a layer of attention."""
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    n_attn, n_ssd, tail = {
        "dense": (cfg.n_layers, 0, 0), "ssm": (0, cfg.n_layers, 0),
        "hybrid": (cfg.n_layers // cfg.shared_attn_period, cfg.n_layers,
                   cfg.n_layers % cfg.shared_attn_period)}[cfg.family]
    split = n_attn and flash_ops.bwd_split(
        b, cfg.n_heads, cfg.n_kv_heads, s,
        flash_ops.bwd_key_tile(cfg.head_dim, getattr(torch, dtype)))
    return {"flash_attention_single": 2 * n_attn,
            **{k: n_attn * bool(split or k != "flash_bwd_dkdv_reduce_kernel")
               for k in flash_ops.BWD_KERNELS},
            "ssd_chunked": 2 * n_ssd - tail, **dict.fromkeys(ssd_ops.BWD_KERNELS, n_ssd)}


def unit_launches(model):
    """(attention forwards, SSD forwards, attention layers, SSD layers) of
    one step by the model's own remat units: a cross-check of
    `step_launches`."""
    out = [0, 0, 0, 0]
    for blocks, remat in model._units():
        for kind, _ in blocks:
            ssd = kind in ("mamba", "tail")
            out[ssd] += 2 if remat else 1
            out[2 + ssd] += 1
    return tuple(out)


def describe_lm(cfg):
    """A configuration's widths, as phase 4's lines print them."""
    out = f"{cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}"
    if cfg.n_heads:
        out += (f", attention {cfg.n_heads}:{cfg.n_kv_heads} heads of {cfg.head_dim}"
                + (f" (shared, after every {cfg.shared_attn_period} layers)"
                   if cfg.family == "hybrid" else ""))
    if cfg.family in ("ssm", "hybrid"):
        out += (f", SSD {cfg.n_ssm_heads} heads of {cfg.ssm_head_dim}, N {cfg.ssm_state}, "
                f"chunk {cfg.ssm_chunk}")
    return out + f", vocab {cfg.vocab_size}"


def lm_training(torch, np, dev, card):
    """Phase "4 lm training" (see TRAIN_CELLS) -> (record, the launches of
    every configuration's TRAIN_STEPS steps)."""
    record, launches = {}, {}
    for arch, cut in TRAIN_CELLS:
        record[arch], got = train_cell(torch, dev, card, arch, cut)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    record["drill"] = train_drill(torch, dev)
    return record, launches


def train_cell(torch, dev, card, arch, cut):
    """One configuration of phase "4 lm training" -> (record, the launches
    of its TRAIN_STEPS steps)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.packing import pack_documents, synthetic_corpus
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.specs import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, tree_map
    from repro_torch.optim.schedule import warmup_cosine

    full = get_config(arch)
    base = dataclasses.replace(full, **cut)
    b, s = TRAIN_BATCH
    tokens = b * s
    before_phase = torch.cuda.memory_allocated()   # earlier phases' tensors still held
    models = {(dtype, kern): build_model(dataclasses.replace(base, dtype=dtype), device=dev,
                                         use_kernels=kern)
              for dtype in ("float32", "bfloat16") for kern in (True, False)}
    require(base.remat, f"{arch}: remat must be on")
    t0 = time.perf_counter()
    params = models["float32", True].init(TRAIN_SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, x in tree_leaves(params))
    depth = ("" if not cut else
             f"; depth cut from {full.n_layers} to {base.n_layers} layers so that the script "
             "keeps to its time")
    print(f"  {arch}: {describe_lm(base)}; {n_params} float32 parameters from "
          f"LM.init({TRAIN_SEED}) in {time.perf_counter() - t0:.1f} s; batch {b} x {s} "
          f"(train_4k's sequence length, global batch cut from 256){depth}", flush=True)
    docs, srcs = synthetic_corpus(vocab=base.vocab_size, seed=TRAIN_SEED)
    pipe = TokenPipeline(pack_documents(docs, srcs, shard_len=4 * s),
                         PipelineConfig(b, s, seed=TRAIN_SEED))

    def batch_at(step):
        return {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}

    def per_step(dtype):
        return step_launches(torch, base, b, s, dtype)

    want = per_step("float32")
    units = unit_launches(models["float32", True])
    require(units == tuple(want[k] for k in ("flash_attention_single", "ssd_chunked",
                                             "flash_bwd_dq_kernel", "ssd_bwd_chunk_scan_kernel")),
            f"{arch}: the model's remat units make {units} (attention and SSD forwards, "
            f"attention and SSD layers) a step, its config {want}")

    # ---- (a) one step, kernel path against the plain path ----
    batch = batch_at(0)
    for model in models.values():   # cuBLAS handles, the allocator; uncounted
        with torch.no_grad():
            model.loss(params, {k: v[:1, :256] for k, v in batch.items()})
    runs = {}
    zero_lm_counts()
    loss32, gn32, yard, ms = train_grads(torch, models["float32", True], params, batch)
    got = lm_counts()
    require(got == per_step("float32"), f"{arch} float32 kernel-path step launched {got}, "
                                        f"expected {per_step('float32')}")
    runs["float32 kernel"] = dict(loss=float(loss32), grad_norm=float(gn32), ms=ms,
                                  launches=got)
    def rel(loss, gn, grads, loss_w, gn_w, grads_w):
        """Each value's max |diff| over the scale of the second run's."""
        out = {"loss": abs(float(loss) - float(loss_w)) / abs(float(loss_w)),
               "grad_norm": abs(float(gn) - float(gn_w)) / float(gn_w)}
        out.update({path: max_rel(grads[path], g) for path, g in grads_w.items()})
        return out

    long_chunks = base.family in SSD_FAMILIES and base.ssm_chunk > ssd_ops.MAX_TILE
    loss_p, gn_p, grads, ms = train_grads(torch, models["float32", False], params, batch)
    f32 = rel(loss32, gn32, yard, loss_p, gn_p, grads)
    worst32 = max(f32, key=f32.get)
    runs["float32 plain"] = dict(loss=float(loss_p), grad_norm=float(gn_p), ms=ms)
    print(f"  float32 kernel vs plain path, of each value's scale (limit {F32_REL}"
          f"{': held against float64 below' if long_chunks else ''}): loss "
          f"{f32['loss']:.3g}, grad norm {f32['grad_norm']:.3g}, largest {worst32} "
          f"{f32[worst32]:.3g}", flush=True)
    held32 = dict(against="float32 plain", at=worst32, rel=f32[worst32])
    if long_chunks:   # the plain path in float64 (see SSD_FAMILIES)
        model64 = build_model(dataclasses.replace(base, dtype="float64"), device=dev,
                              use_kernels=False)
        params64 = tree_map(lambda x: x.detach().double(), params)
        loss64, gn64, grads64, ms = train_grads(torch, model64, params64, batch)
        f64 = rel(loss32, gn32, yard, loss64, gn64, grads64)
        own = rel(loss_p, gn_p, grads, loss64, gn64, grads64)
        worst64, worst_own = max(f64, key=f64.get), max(own, key=own.get)
        runs["float64 plain"] = dict(loss=float(loss64), grad_norm=float(gn64), ms=ms)
        print(f"  float32 kernel vs the float64 plain path, of each value's scale (limit "
              f"{F32_REL}): loss {f64['loss']:.3g}, grad norm {f64['grad_norm']:.3g}, largest "
              f"{worst64} {f64[worst64]:.3g}; the float32 plain path's own: largest "
              f"{worst_own} {own[worst_own]:.3g}", flush=True)
        held32 = dict(against="float64 plain", at=worst64, rel=f64[worst64],
                      float32_plain_vs_float64=dict(at=worst_own, rel=own[worst_own]),
                      kernel_vs_float32_plain=dict(at=worst32, rel=f32[worst32]))
        worst32, f32 = worst64, f64
        del model64, params64, grads64
    require(f32[worst32] <= F32_REL, f"{arch} float32 {worst32}: kernel vs "
                                     f"{held32['against']} {f32[worst32]:.3g} of its scale > "
                                     f"{F32_REL}")
    del grads
    torch.cuda.empty_cache()

    def from_yard(loss, gn, grads):
        """(relative L2, max over scale) of every value from the float32 kernel run."""
        out = {"loss": (abs(float(loss - loss32)) / abs(float(loss32)),) * 2,
               "grad_norm": (abs(float(gn - gn32)) / float(gn32),) * 2}
        out.update({path: (l2_rel(g, yard[path]), max_rel(g, yard[path]))
                    for path, g in grads.items()})
        return out

    bf16 = {}
    for name, key, ctx in (("kernel", ("bfloat16", True), contextlib.nullcontext),
                           ("plain", ("bfloat16", False), contextlib.nullcontext),
                           ("swapped", ("bfloat16", True), kernels_swapped_for_plain)):
        zero_lm_counts()
        with ctx():
            loss, gn, grads, ms = train_grads(torch, models[key], params, batch)
        bf16[name] = from_yard(loss, gn, grads)
        runs[f"bfloat16 {name}"] = dict(loss=float(loss), grad_norm=float(gn), ms=ms)
        if name == "kernel":
            got = lm_counts()
            require(got == per_step("bfloat16"), f"{arch} bf16 kernel-path step launched "
                                                 f"{got}, expected {per_step('bfloat16')}")
            runs["bfloat16 kernel"]["launches"] = got
        del grads
        torch.cuda.empty_cache()
    worst = {}
    for comp in ("plain", "swapped"):
        ratio, what = 0.0, ""
        for path, (l2_k, mx_k) in bf16["kernel"].items():
            l2_c, mx_c = bf16[comp][path]
            require(l2_k <= BF16_L2 * l2_c + BF16_ULP and mx_k <= BF16_MAX * mx_c + BF16_ULP,
                    f"{arch} bfloat16 {path}: from the float32 kernel run, kernel path "
                    f"L2 {l2_k:.3g} max {mx_k:.3g}, {comp} L2 {l2_c:.3g} max {mx_c:.3g}")
            if l2_k / max(l2_c, 1e-30) > ratio:
                ratio = l2_k / max(l2_c, 1e-30)
                what = f"{path}: L2 {l2_k:.3g} vs {l2_c:.3g}, max {mx_k:.3g} vs {mx_c:.3g}"
        worst[comp] = dict(l2_ratio=ratio, at=what)
        print(f"  bfloat16 from the float32 kernel run, kernel vs {comp} (largest L2 ratio): "
              f"{ratio:.3g} ({what}); loss kernel {bf16['kernel']['loss'][0]:.3g} vs "
              f"{bf16[comp]['loss'][0]:.3g}, grad norm {bf16['kernel']['grad_norm'][0]:.3g} "
              f"vs {bf16[comp]['grad_norm'][0]:.3g}", flush=True)
    for name, r in runs.items():
        print(f"  one step {name}: loss {r['loss']:.6f}, grad norm {r['grad_norm']:.6f}, "
              f"forward + backward {r['ms']:.1f} ms"
              + (f", launches {r['launches']}" if "launches" in r else ""), flush=True)
    del yard, bf16
    torch.cuda.empty_cache()

    # ---- (b) TRAIN_STEPS AdamW steps on the kernel path ----
    model = models["bfloat16", True]
    ocfg = AdamWConfig(schedule=warmup_cosine(2, TRAIN_STEPS))
    step_fn = make_train_step(model, ocfg)
    opt = adamw_init(params)
    losses, times = [], []
    zero_lm_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        batch = batch_at(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    launches = lm_counts()
    want = {k: TRAIN_STEPS * n for k, n in per_step("bfloat16").items()}
    require(launches == want, f"{arch}: {TRAIN_STEPS} steps launched {launches}, expected {want}")
    require(all(math.isfinite(x) for x in losses), f"{arch}: non-finite losses {losses}")
    # One more step, its parts timed with CUDA events, the backward kernels'
    # calls (flash and SSD) each between two events of their own.
    batch = batch_at(TRAIN_STEPS)
    paths, leaves = zip(*tree_leaves(params))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    bwd_ev = {"flash": [], "ssd": []}
    plain = {"flash": (flash_ops, "flash_attention_bwd"), "ssd": (ssd_ops, "ssd_log_bwd")}
    saved = {key: getattr(mod, name) for key, (mod, name) in plain.items()}

    def timed(key):
        def call(*args, **kwargs):
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = saved[key](*args, **kwargs)
            pair[1].record()
            bwd_ev[key].append(pair)
            return out
        # The wrappers count on their module's name: here on the timing wrapper.
        call.launches = 0
        call.kernel_launches = dict(saved[key].kernel_launches)
        return call

    for key, (mod, name) in plain.items():
        setattr(mod, name, timed(key))
    try:
        ev[0].record()
        loss = model.loss(params, batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        by_leaf = dict(zip(map(id, leaves), grads))
        adamw_update(tree_map(lambda x: by_leaf[id(x)], params), opt, params, ocfg)
        ev[3].record()
        torch.cuda.synchronize()
    finally:
        for key, (mod, name) in plain.items():
            setattr(mod, name, saved[key])
    del grads, by_leaf
    want_one = per_step("bfloat16")
    split = {"forward_ms": ev[0].elapsed_time(ev[1]), "backward_ms": ev[1].elapsed_time(ev[2]),
             "flash_bwd_kernels_ms": sum(a.elapsed_time(z) for a, z in bwd_ev["flash"]),
             "ssd_bwd_kernels_ms": sum(a.elapsed_time(z) for a, z in bwd_ev["ssd"]),
             "optimizer_ms": ev[2].elapsed_time(ev[3])}
    n_calls = {k: len(v) for k, v in bwd_ev.items()}
    require(n_calls == {"flash": want_one["flash_bwd_dq_kernel"],
                        "ssd": want_one["ssd_bwd_chunk_scan_kernel"]},
            f"{arch} instrumented step: backward calls {n_calls}")
    med = statistics.median(times)
    n_attn = want_one["flash_bwd_dq_kernel"]
    pairs = b * base.n_heads * attention_pairs(s, True, None) if n_attn else 0
    flops = 6 * n_params * tokens + 3 * 4 * base.head_dim * pairs * n_attn
    rec = dict(arch=arch, layers=base.n_layers, cut=cut, batch=b, seq=s, params=n_params,
               card=card, runs=runs, float32_worst=held32,
               bf16_worst=worst, step_ms=times, step_ms_median=med, step_ms_min=min(times),
               step_ms_max=max(times), tokens_per_s=tokens / med * 1e3, losses=losses,
               model_flops_per_step=flops,
               model_flops_share_of_bf16_peak_info_only=flops / (med * 1e-3) /
               BF16_TC_OPS_PER_S,
               max_memory_allocated=peak, allocated_before_phase=before_phase,
               step_split=split, backward_calls=n_calls, launches=launches)
    print(f"  {TRAIN_STEPS} AdamW steps ({arch}, {b} x {s}, bf16 compute, float32 "
          f"masters, remat): {med:.1f} ms a step (median; min {min(times):.1f}, max "
          f"{max(times):.1f}; first {times[0]:.1f}), {tokens / med * 1e3:.0f} tokens/s, model "
          f"FLOP/s {flops / (med * 1e-3) / 1e12:.1f} T = "
          f"{rec['model_flops_share_of_bf16_peak_info_only']:.3f} of the dense bf16 peak "
          f"(6 N T plus attention; information only, not a metric); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({before_phase / 2**30:.2f} of it allocated before the "
          f"phase); losses {[round(x, 4) for x in losses]}; launches {launches}; {card}",
          flush=True)
    print(f"  one more step by CUDA events: forward {split['forward_ms']:.1f} ms, backward "
          f"{split['backward_ms']:.1f} ms (of it the {n_calls['flash']} flash backward calls "
          f"{split['flash_bwd_kernels_ms']:.1f} ms, the {n_calls['ssd']} SSD backward calls "
          f"{split['ssd_bwd_kernels_ms']:.1f} ms), optimizer {split['optimizer_ms']:.1f} ms",
          flush=True)
    del params, opt, models, model, step_fn, batch, leaves, loss
    torch.cuda.empty_cache()
    return rec, launches


def train_drill(torch, dev):
    """Phase "4 lm training" (c): the crash/resume drill through
    launch/train.py's loop (TRAIN_DRILL, TRAIN_ARCH's widths)."""
    import shutil

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as train_mod

    d = TRAIN_DRILL
    cfg_d = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=d["n_layers"])
    root = os.path.join(ROOT, "build", "train_drill")
    shutil.rmtree(root, ignore_errors=True)

    def drill_args(run, crash=-1):
        return train_mod.parser().parse_args(
            ["--vocab", str(d["vocab"]), "--steps", str(d["steps"]), "--global-batch",
             str(d["global_batch"]), "--seq-len", str(d["seq_len"]), "--ckpt-every",
             str(d["ckpt_every"]), "--log-every", "100", "--crash-at-step", str(crash),
             "--run-dir", os.path.join(root, run), "--device", dev.type])

    t0 = time.perf_counter()
    clean = train_mod.train(drill_args("clean"), cfg_d)
    crashed = False
    try:
        train_mod.train(drill_args("crashed", d["crash_at"]), cfg_d)
    except SystemExit:
        crashed = True
    require(crashed, "the drill's run did not crash")
    resumed = train_mod.train(drill_args("crashed"), cfg_d)
    diff = abs(clean["final_loss"] - resumed["final_loss"])
    bitwise = clean["final_loss"] == resumed["final_loss"]
    require(diff <= DRILL_TOL, f"crash/resume: final loss {resumed['final_loss']!r} vs "
                               f"uninterrupted {clean['final_loss']!r}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"  crash/resume drill ({TRAIN_ARCH} widths, {d['n_layers']} layers, vocab "
          f"{d['vocab']}, {d['steps']} steps of {d['global_batch']} x {d['seq_len']}, a "
          f"checkpoint every {d['ckpt_every']}, crashed after step {d['crash_at']}): final "
          f"loss {clean['final_loss']!r} uninterrupted, {resumed['final_loss']!r} resumed, "
          f"|diff| {diff:.3g} (limit {DRILL_TOL}), bitwise {bitwise}", flush=True)
    return dict(config=dict(d, arch=TRAIN_ARCH), final_loss=clean["final_loss"],
                resumed_final_loss=resumed["final_loss"], diff=diff, bitwise=bitwise,
                seconds=time.perf_counter() - t0)


def bwd_bound(b, hq, hkv, s, d, causal, window, esize, products, nbytes):
    """Bound of a backward kernel: ``products`` D-deep products per unmasked
    (q, k) pair (2 D flops each; on the bf16 tensor cores, or the float32
    CUDA cores for 4-byte operands) and 5 float32 operations a pair (exp,
    two subtractions, two products) on the CUDA cores, against ``nbytes``
    read and written once."""
    pairs = b * hq * attention_pairs(s, causal, window)
    rate = BF16_TC_OPS_PER_S if esize == 2 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(2 * d * products * pairs / rate, 5 * pairs / FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bwd_grid_sweep(torch, dev, reps):
    """The split rule's A/B over BWD_GRID_SWEEP: the backward's kernels on
    the split grid and on the kv-head grid, each forced, timed in turn ->
    one row a shape (medians and spreads of BWD_WINDOWS windows, the
    kv-head grid's blocks and the grid the rule picks)."""
    from repro_torch.kernels.attention import ops as flash_ops

    g = torch.Generator(device=dev).manual_seed(27)
    hq, hkv, s, d = 12, 2, 4096, 128
    rows = []
    for b, dtype in BWD_GRID_SWEEP:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                       .transpose(1, 2) for h in (hq, hkv, hkv, hq))
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_ops._forward(q, k, v, True, None, scale, with_lse=True)
        grids = {split: flash_ops.bwd_launches(q, k, v, o, lse, do, True, None, scale,
                                               split=split)[1] for split in (True, False)}
        wins = {split: [] for split in grids}
        for _ in range(BWD_WINDOWS):
            for split, calls in grids.items():
                wins[split].append(cuda_ms(torch, lambda: [c() for c in calls.values()], reps))
        tile = flash_ops.bwd_key_tile(d, dt)
        row = dict(batch=b, dtype=dtype, kv_head_blocks=b * hkv * -(-s // tile),
                   split_ms=statistics.median(wins[True]),
                   split_range=(min(wins[True]), max(wins[True])),
                   kv_head_ms=statistics.median(wins[False]),
                   kv_head_range=(min(wins[False]), max(wins[False])),
                   rule_splits=flash_ops.bwd_split(b, hq, hkv, s, tile))
        rows.append(row)
        print(f"  flash backward grid sweep B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal "
              f"{dtype} ({row['kv_head_blocks']} kv-head blocks): split grid "
              f"{row['split_ms']:.4f} ms ({row['split_range'][0]:.4f}-"
              f"{row['split_range'][1]:.4f}), kv-head grid {row['kv_head_ms']:.4f} ms "
              f"({row['kv_head_range'][0]:.4f}-{row['kv_head_range'][1]:.4f}); the rule "
              f"picks the {'split' if row['rule_splits'] else 'kv-head'} grid", flush=True)
        del q, k, v, do, o, lse, grids
    torch.cuda.empty_cache()
    return rows


def flash_bwd_times(torch, F, dev, reps, launches, case_err, logs):
    """The backward kernels at every FLASH_BWD_CASES shape: each launched
    alone, all through the wrapper, the plain versions,
    F.scaled_dot_product_attention's backward, the bounds -> the kernels'
    rows, at qwen2's training shape (the first case, on the split grid),
    dkdv's carrying every shape's numbers; ``logs``: build_all's compiler
    output (each kernel's registers and spills).  The wrapper, SDPA and,
    at a GQA shape, the kernels on the shape's grid and on the other grid
    (forced: the split rule's A/B) are timed in turn, BWD_WINDOWS windows,
    median and spread."""
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.attention.ref import dkdv_reduce_ref, flash_bwd_ref

    g = torch.Generator(device=dev).manual_seed(26)
    shapes = []
    for name, b, hq, hkv, s, d, causal, window, dtype in FLASH_BWD_CASES:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                       .transpose(1, 2) for h in (hq, hkv, hkv, hq))
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_ops._forward(q, k, v, causal, window, scale, with_lse=True)
        (*_, part), calls = flash_ops.bwd_launches(q, k, v, o, lse, do, causal, window, scale)
        alone = {kern: cuda_ms(torch, call, reps) for kern, call in calls.items()}
        reduce_plain_ms = None if part is None else cuda_ms(
            torch, lambda: dkdv_reduce_ref(part, hkv, scale, dt), reps)
        timed = {"wrapper": lambda: flash_ops.flash_attention_bwd(
                     q, k, v, o, lse, do, causal, window, scale),
                 "sdpa": sdpa_backward(torch, F, q, k, v, do, causal, window),
                 "grid": lambda: [call() for call in calls.values()]}
        other = {}
        if hq > hkv:
            _, other = flash_ops.bwd_launches(q, k, v, o, lse, do, causal, window, scale,
                                              split=part is None)
            timed["other grid"] = lambda: [call() for call in other.values()]
        wins = {key: [] for key in timed}
        for _ in range(BWD_WINDOWS):
            for key, fn in timed.items():
                wins[key].append(cuda_ms(torch, fn, reps))
        med = {key: statistics.median(ts) for key, ts in wins.items()}
        spread = {key: (min(ts), max(ts)) for key, ts in wins.items()}
        wrapper_ms, sdpa_ms = med["wrapper"], med["sdpa"]
        plain_ms = cuda_ms(torch, lambda: flash_bwd_ref(q, k, v, o, lse, do, causal, window,
                                                        scale), 2)
        delta_ms = cuda_ms(torch, lambda: (do.float() * o.float()).sum(-1), reps)
        fwd_ms = cuda_ms(torch, lambda: flash_ops._forward(q, k, v, causal, window, scale, True),
                         reps)
        del timed
        esize = q.element_size()
        act = b * hq * s * d * esize
        kv = b * hkv * s * d * esize
        rows = b * hq * s * 4
        bounds = {
            "flash_bwd_preprocess_kernel": bound(2 * act + rows, 2 * d * b * hq * s),
            "flash_bwd_dkdv_kernel": bwd_bound(b, hq, hkv, s, d, causal, window, esize, 4,
                                               2 * act + 4 * kv + 2 * rows),
            "flash_bwd_dq_kernel": bwd_bound(b, hq, hkv, s, d, causal, window, esize, 3,
                                             3 * act + 2 * kv + 2 * rows),
        }
        if part is not None:   # the partials read once, dK and dV written once
            bounds["flash_bwd_dkdv_reduce_kernel"] = bound(part.numel() * 4 + 2 * kv,
                                                           part.numel() + b * hkv * s * d)
        whole = bwd_bound(b, hq, hkv, s, d, causal, window, esize, 5,
                          4 * act + 4 * kv + rows)
        shape = (f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal} window={window} "
                 f"{dtype}, strided (B,S,H,D)")
        grid = "split" if part is not None else "kv-head"
        ab = ({} if hq == hkv else {f"{grid} grid": med["grid"],
                                    f"{'kv-head' if part is not None else 'split'} grid forced":
                                    med["other grid"]})
        sdpa_kind = "boolean attn_mask, not the flash backend" if window else "is_causal"
        shapes.append(dict(case=name, shape=shape, ms=wrapper_ms, ms_range=spread["wrapper"],
                           alone_ms=alone, plain_ms=plain_ms, delta_plain_ms=delta_ms,
                           reduce_plain_ms=reduce_plain_ms, sdpa_bwd_ms=sdpa_ms,
                           sdpa_bwd_ms_range=spread["sdpa"], sdpa=sdpa_kind,
                           grid_ab_ms=ab, grid_ab_ranges={k: spread[w] for k, w in zip(
                               ab, ("grid", "other grid"))},
                           bound_ms=whole[0], bound_by=whole[1],
                           kernel_bounds={k: v[0] for k, v in bounds.items()},
                           forward_with_lse_ms=fwd_ms))

        def rng(key):
            return f"{med[key]:.4f} ms ({spread[key][0]:.4f}-{spread[key][1]:.4f})"
        print(f"  flash backward {name} ({shape}, {grid} grid), medians of {BWD_WINDOWS} "
              f"windows (min-max): the kernels through the wrapper {rng('wrapper')} (alone: "
              + ", ".join(f"{kk} {t:.3f}" for kk, t in alone.items())
              + f"); F.scaled_dot_product_attention's backward ({sdpa_kind}) {rng('sdpa')}"
              + ("" if hq == hkv else f"; the kernels on the {grid} grid {rng('grid')}, on the "
                 f"other grid (forced) {rng('other grid')}")
              + f"; plain flash_bwd_ref {plain_ms:.3f} ms; bound {whole[0]:.4f} ms by "
              f"{whole[1]} (2.5 x the forward's products); the forward kernel with the LSE "
              f"{fwd_ms:.3f} ms", flush=True)
        if name == FLASH_BWD_CASES[0][0]:
            require(part is not None, f"{name}: expected the split grid")
            main_case = dict(alone=alone, bounds=bounds, plain_ms=plain_ms, delta_ms=delta_ms,
                             reduce_plain_ms=reduce_plain_ms, sdpa_ms=sdpa_ms,
                             wrapper_ms=wrapper_ms, whole=whole, shape=shape)
        del q, k, v, do, o, lse, calls, part, other
        torch.cuda.empty_cache()
    sweep = bwd_grid_sweep(torch, dev, reps)
    m = main_case
    plains = {"flash_bwd_preprocess_kernel": (m["delta_ms"], "(do * o).sum(-1) in float32"),
              "flash_bwd_dkdv_reduce_kernel": (m["reduce_plain_ms"],
                                               "dkdv_reduce_ref (the group's partials added)")}
    out_rows = []
    for kern in flash_ops.BWD_KERNELS:
        b_ms, b_by = m["bounds"][kern]
        plain_ms, plain = plains.get(kern, (m["plain_ms"], "flash_bwd_ref (all three gradients)"))
        out_rows.append(dict(
            name=kern, route="cuda", source="src/repro_torch/csrc/flash.cu",
            replaces="none: the JAX package's backward is XLA through mha_ref "
                     "(src/repro/kernels/attention/ops.py:48)",
            launches=launches[kern], max_abs_err=case_err[kern], ms=m["alone"][kern],
            plain_ms=plain_ms, plain=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=m["sdpa_ms"] if kern == "flash_bwd_dkdv_kernel" else None,
            library=("F.scaled_dot_product_attention's backward (dq, dk and dv together)"
                     if kern == "flash_bwd_dkdv_kernel" else "none"),
            backward_wrapper_ms=m["wrapper_ms"], backward_bound_ms=m["whole"][0],
            shape=f"qwen2-1.5b training: {m['shape']}",
            ptxas=ptxas_summary(logs.get("flash", ""), kern),
            **({"bwd_shapes": shapes, "grid_sweep": sweep}
               if kern == "flash_bwd_dkdv_kernel" else {})))
    return out_rows


def lm_only(torch, np, F, reps):
    """``--lm-only``: phases "3 lm kernels", "4 lm families" and "4 lm
    training", and the families' kernel shapes and the flash backward timed
    as phase 5 times them."""
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.attention.ref import flash_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    dev = torch.device(DEVICE)
    smi = card_line()
    print(smi)
    with phase("2 build"):
        logs = build.build_all()
    with phase("3 lm kernels"):
        flash_cases(torch, flash_ops.flash_attention, flash_ref, dev)
        bwd_err = {**flash_bwd_cases(torch, dev), **ssd_bwd_cases(torch, dev)}
        ssd_cases(torch, ssd_ops.ssd_log, ssd_ops.ssd, ssd_ref.ssd_chunked_ref,
                  ssd_ref.ssd_batched_ref, ssd_ops.heads_per_block, dev)
    counted = {"flash_attention_single": flash_ops.flash_attention,
               "ssd_chunked": ssd_ops.ssd_log}
    with phase("4 lm families"):
        runs, launches = lm_families(torch, np, dev, counted, smi)
        print(json.dumps({"lm_families": runs}))
    with phase("4 lm training"):
        training, train_launches = lm_training(torch, np, dev, smi)
        print(json.dumps({"lm_training": training}))
    with phase("5 measure"):
        fam_flash, fam_ssd = family_shapes(torch, F, dev, reps)
        print(json.dumps({"family_shapes": fam_flash + fam_ssd, "launches": launches}))
        print(json.dumps({"flash_backward": flash_bwd_times(torch, F, dev, reps, train_launches,
                                                             bwd_err, logs)}))
        print(json.dumps({"ssd_backward": ssd_bwd_times(torch, dev, reps, train_launches,
                                                         bwd_err, logs)}))
    print(f"card: {smi}")
    return 0


def train_only(torch, np, F, reps):
    """``--train-only``: the flash and SSD backward's cases of phase "3 lm
    kernels", phase "4 lm training" and the backward kernels' times."""
    from repro_torch.kernels import build

    dev = torch.device(DEVICE)
    smi = card_line()
    print(smi)
    with phase("2 build"):
        logs = build.build_all()
    with phase("3 lm kernels"):
        bwd_err = {**flash_bwd_cases(torch, dev), **ssd_bwd_cases(torch, dev)}
    with phase("4 lm training"):
        training, train_launches = lm_training(torch, np, dev, smi)
        print(json.dumps({"lm_training": training}))
    with phase("5 measure"):
        print(json.dumps({"flash_backward": flash_bwd_times(torch, F, dev, reps, train_launches,
                                                             bwd_err, logs)}))
        print(json.dumps({"ssd_backward": ssd_bwd_times(torch, dev, reps, train_launches,
                                                         bwd_err, logs)}))
    print(f"card: {smi}")
    return 0


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def mosaic_times(torch, build, warp_ops, dev, tiles, covs, offs, q):
    """The brick mosaic's times on its operands -> {"ms": through the
    wrapper, "alone_ms": its C entry point from a host loop, "graph_ms":
    MOSAIC_GRAPH_LAUNCHES launches captured in a CUDA graph (the kernel's
    own time; a host call takes about as long as the kernel) on one set of
    operands, which then stays in the L2, "graph_hbm_ms": the same over
    MOSAIC_ROTATE copies of the operands in turn, so each launch reads its
    tiles from HBM and writes canvases that no longer sit in the L2,
    "out": the last launch's coadd and depth}."""
    lib = build.library("mosaic")
    n_t, bh, bw = tiles.shape
    sets = [(tiles, covs)] + [(tiles.clone(), covs.clone()) for _ in range(MOSAIC_ROTATE - 1)]
    outs = [[torch.empty((q, q), dtype=torch.float32, device=dev) for _ in range(2)]
            for _ in sets]

    def alone(i=0):
        (t, c), (o_c, o_d) = sets[i], outs[i]
        build.check(lib, lib.mosaic_bricks_f32(
            t.data_ptr(), c.data_ptr(), offs.data_ptr(), o_c.data_ptr(), o_d.data_ptr(),
            n_t, bh, bw, q, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream),
            "mosaic_bricks launch")

    times = {"ms": cuda_ms(torch, lambda: warp_ops.mosaic_bricks(tiles, covs, offs, q), 200),
             "alone_ms": cuda_ms(torch, alone, 200)}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        alone()
    torch.cuda.synchronize()
    for key, rotate in (("graph_ms", 1), ("graph_hbm_ms", MOSAIC_ROTATE)):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(MOSAIC_GRAPH_LAUNCHES):
                alone(i % rotate)
        times[key] = cuda_ms(torch, graph.replay, 5) / MOSAIC_GRAPH_LAUNCHES
        del graph
    torch.cuda.synchronize()
    times["out"] = outs[0]
    return times


def mosaic_only(torch, np, dev):
    """``--mosaic-only``: the brick mosaic alone at the brick window's shape
    (16 tiles of BRICK_NPIX^2 on the lattice into a 1024^2 canvas, random
    tiles from MOSAIC_SEED), held bitwise against its plain version, and its
    times (`mosaic_times`) as one JSON line.  It needs only the mosaic's
    wrapper, its C entry point and its plain version, so a copy of this
    script at the root of an older checkout times that checkout's kernel."""
    from repro_torch.kernels import build
    from repro_torch.kernels.warp import ops as warp_ops
    from repro_torch.kernels.warp import ref

    side, q = 4, 4 * BRICK_NPIX
    rng = np.random.default_rng(MOSAIC_SEED)
    shape = (side * side, BRICK_NPIX, BRICK_NPIX)
    tiles = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    covs = torch.from_numpy(rng.integers(0, 9, size=shape).astype(np.float32)).to(dev)
    offs = torch.tensor([(r * BRICK_NPIX, c * BRICK_NPIX) for r in range(side)
                         for c in range(side)], dtype=torch.int32, device=dev)
    times = mosaic_times(torch, build, warp_ops, dev, tiles, covs, offs, q)
    want = ref.mosaic_bricks_ref(tiles, covs, offs, q)
    require(all(torch.equal(a, b) for a, b in zip(times.pop("out"), want)),
            "mosaic: not bitwise its plain version")
    nbytes = 2 * tiles.numel() * 4 + offs.numel() * 4 + 2 * q * q * 4
    times["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"mosaic": times}), flush=True)


def robust_bounds(warp_ops, reducer, scan, nbins=NBINS):
    """The decision boundaries of one query's robust passes over ``scan``:
    {"clipped": clip (centre, radius), "median": clip and the bins}."""
    mom = warp_ops.coadd_moments(*scan)
    mu, sigma = reducer.clip_stats(*mom)
    lo, bw, inv_w = reducer.hist_bounds(*mom, nbins)
    med = reducer.hist_median(warp_ops.coadd_hist(*scan, lo, inv_w, nbins), mom[0], lo, bw)
    return {"clipped": dict(clip=(mu, reducer.clip_threshold(mu, sigma, CLIP_K))),
            "median": dict(clip=(med, reducer.clip_threshold(med, sigma, CLIP_K)),
                           bins=(lo, bw, inv_w, nbins))}


def hold_stream(torch, np, ref, dev, what, red, got, want, flips_at, decision_flips):
    """A streamed result against the eager one: depth exactly and coadd at
    the streaming tolerance; for a robust estimator, differing pixels only
    where a sample lies within 1e-4 (relative) of a clip or bin boundary
    (``flips_at``: the eager pass's scan and boundaries) -> decision flips."""
    c, d, c0, d0 = got.coadd, got.depth, want.coadd, want.depth
    bad = (d != d0) | ~(np.abs(c - c0) <= STREAM_ATOL + STREAM_RTOL * np.abs(c0))
    if red == "mean" or not bad.any():
        require(not bad.any(), f"{what}: {int(bad.sum())} pixels differ from the eager run "
                               f"(max |coadd| {float(np.abs(c - c0).max()):.3g}, depth equal "
                               f"{bool(np.array_equal(d, d0))})")
        return 0
    hscan, hbounds = flips_at
    near, far = ref.decision_flips(torch.from_numpy(bad).to(dev), *hscan, **hbounds[red])
    require(not far.any(), f"{what}: {int(far.sum())} pixels differ away from every decision "
                           "boundary")
    for p in near.nonzero().tolist():
        decision_flips.append(("streaming", what) + tuple(p))
    return int(near.sum())


def streaming_phase(torch, np, dev, survey, main_eng, query, bqueries, eager, flips_at,
                    batch_eager, batch_flips, brick_fresh, counted, decision_flips, keep):
    """Phase "4 streaming": the main survey under a device budget.

    One engine a layout (budget 1/STREAM_FRAC of the layout's device bytes),
    built as a user builds it; its first query (the layout's packing, its
    pixels' registration in place and every upload included), then the
    layout's methods x three estimators, unmatched and PSF-matched, cold
    (every chunk re-uploaded) and warm, each held against the eager kernel
    path (``eager[target, red, method]``); the K = 4 batch of ``bqueries``
    on the dense and the sparse batch method; the brick window under the
    budget; checks one host sync a query, the window count, the residency
    manager's peak against the budget and ``max_memory_allocated`` against
    that peak.  The per-file and structured engines go into ``keep`` (by
    layout, nothing resident) for phase "4 faults".  -> the numbers it
    printed.
    """
    import repro_torch.core.engine as engine_mod
    from repro_torch import CoaddEngine
    from repro_torch.core.seqfile import PackedDataset
    from repro_torch.kernels.warp import ops as warp_ops
    from repro_torch.kernels.warp import ref

    out = {"queries": []}
    q = query.npix
    # The yardstick: a pinned cudaMemcpy H2D of 1 GiB.
    host = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    buf = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, device=dev)
    h2d_ms = cuda_ms(torch, lambda: buf.copy_(host, non_blocking=True), 3)
    out["h2d_gb_s"] = H2D_PROBE_BYTES / h2d_ms / 1e6
    del host, buf
    print(f"  pinned cudaMemcpy H2D of {H2D_PROBE_BYTES} bytes: {h2d_ms:.3f} ms, "
          f"{out['h2d_gb_s']:.2f} GB/s", flush=True)

    syncs = [0]
    real_sync = engine_mod._sync

    def counted_sync(tensors):
        syncs[0] += 1
        return real_sync(tensors)

    def one_sync(what, fn):
        """``fn()`` with exactly one `_sync` -> (result, host ms)."""
        s0 = syncs[0]
        t0 = time.perf_counter()
        r = fn()
        ms = (time.perf_counter() - t0) * 1e3
        require(syncs[0] - s0 == 1, f"{what}: {syncs[0] - s0} host syncs, expected 1")
        return r, ms

    pins = []
    real_pin = PackedDataset.pin

    def timed_pin(ds):
        seconds = real_pin(ds)
        pins.append(seconds)
        return seconds

    for fn in counted.values():
        fn.launches = 0
    engine_mod._sync = counted_sync
    PackedDataset.pin = timed_pin
    try:
        for layout, methods in STREAM_LAYOUTS.items():
            main_ds = main_eng.exec_dataset(layout)[0]
            budget = main_ds.chunk_nbytes(0, main_ds.n_packs) // STREAM_FRAC
            eng = CoaddEngine(survey, pack_capacity=64, device=DEVICE, device_budget_bytes=budget,
                              brick_deg=BRICK_DEG, brick_npix=BRICK_NPIX)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base_alloc = torch.cuda.memory_allocated()
            # The engine's first query pays the layout's one-time costs.
            pins.clear()
            what = f"streaming first {methods[0]}/mean"
            first, first_ms = one_sync(what, lambda: eng.run(query, methods[0]))
            hold_stream(torch, np, ref, dev, what, "mean", first, eager[None, "mean", methods[0]],
                        flips_at[None], decision_flips)
            exec_ds = eng.exec_dataset(layout)[0]
            pin_s = max(pins, default=0.0)
            require(pin_s > 0, f"{what}: the layout was not pinned")
            print(f"  {layout}: {exec_ds.n_packs} packs, "
                  f"{exec_ds.chunk_nbytes(0, exec_ds.n_packs)} device bytes, budget {budget}; "
                  f"first query of a fresh budgeted engine {first_ms:.1f} ms (packing, "
                  f"{first.stats.chunk_uploads} uploads and cudaHostRegister of "
                  f"{exec_ds.pixels.nbytes} bytes in {pin_s:.3f} s included)", flush=True)
            chunks = {}
            for target in (None, PSF_TARGET):
                eng.match_psf_sigma = target
                if target is not None:
                    t0 = time.perf_counter()
                    eng.psf_kernel_bank(layout)
                    print(f"  {layout}: host PSF bank in {time.perf_counter() - t0:.3f} s "
                          "(once a layout, before the timed queries)", flush=True)
                chunks[target] = eng._chunk_packs(exec_ds)
                bank_pack = eng._bank_pack_nbytes(layout)
                for m in methods:
                    gated = np.nonzero(eng._exec_gate(eng.plan(query, m)).any(axis=1))[0]
                    n_chunks = len(np.unique(gated // chunks[target]))
                    for red in REDUCES:
                        what = f"streaming {m}/{red}/psf={target}"
                        eng.residency.clear()   # cold: every chunk uploads again
                        b0 = eng.residency.bytes_uploaded
                        cold, cold_ms = one_sync(what, lambda: eng.run(query, m, reduce=red))
                        up_bytes = eng.residency.bytes_uploaded - b0
                        warm, warm_ms = one_sync(what, lambda: eng.run(query, m, reduce=red))
                        flips = 0
                        for r in (cold, warm):
                            s = r.stats
                            require(s.windows == s.reduce_passes * n_chunks
                                    and (n_chunks <= 1 or s.windows > s.reduce_passes)
                                    and s.dispatches == s.windows,
                                    f"{what}: {s.windows} windows, {s.dispatches} launches over "
                                    f"{n_chunks} gated chunks")
                            flips = hold_stream(torch, np, ref, dev, what, red, r,
                                                eager[target, red, m], flips_at[target],
                                                decision_flips)
                        require(np.array_equal(cold.coadd.view(np.int32), warm.coadd.view(np.int32))
                                and np.array_equal(cold.depth, warm.depth),
                                f"{what}: warm differs from cold")
                        cs, ws = cold.stats, warm.stats
                        row = dict(layout=layout, method=m, reduce=red, psf=target,
                                   cold_ms=cold_ms, warm_ms=warm_ms,
                                   cold_pass_ms=cs.t_map_reduce_s * 1e3,
                                   warm_pass_ms=ws.t_map_reduce_s * 1e3, windows=cs.windows,
                                   chunks=n_chunks, uploads=(cs.chunk_uploads, ws.chunk_uploads),
                                   hits=(cs.residency_hits, ws.residency_hits),
                                   evictions=(cs.residency_evictions, ws.residency_evictions),
                                   matched_builds=(cs.matched_cache_builds,
                                                   ws.matched_cache_builds),
                                   bytes_uploaded=up_bytes,
                                   upload_gb_s=up_bytes / cs.t_map_reduce_s / 1e9,
                                   flips=flips)
                        out["queries"].append(row)
                        print(f"  streaming {m:28s} {red:7s} psf={target} cold_ms={cold_ms:.1f} "
                              f"warm_ms={warm_ms:.1f} pass_ms={row['cold_pass_ms']:.1f}/"
                              f"{row['warm_pass_ms']:.1f} windows={cs.windows} "
                              f"uploads={row['uploads']} hits={row['hits']} "
                              f"evictions={row['evictions']} matched_builds="
                              f"{row['matched_builds']} bytes_uploaded={up_bytes} "
                              f"upload_GB/s={row['upload_gb_s']:.2f} flips={flips}", flush=True)
            eng.match_psf_sigma = None
            # The K = 4 batch on the batch path's methods planned here.
            for m in [m for m in methods if m in BATCH_METHODS]:
                for red in REDUCES:
                    what = f"streaming batch {m}/{red}"
                    res, ms = one_sync(what, lambda: eng.run_batch(bqueries, m, reduce=red))
                    for k, (r, w) in enumerate(zip(res, batch_eager[m, red])):
                        hold_stream(torch, np, ref, dev, f"{what} query {k}", red, r, w,
                                    batch_flips[k], decision_flips)
                    s0 = res[0].stats
                    require(s0.dispatches == s0.windows > s0.reduce_passes,
                            f"{what}: {s0.windows} windows, {s0.dispatches} launches")
                    print(f"  streaming batch K={len(bqueries)} {m:16s} {red:7s} batch_ms={ms:.1f} "
                          f"pass_ms={s0.t_map_reduce_s * 1e3:.1f} windows={s0.windows} "
                          f"uploads={s0.chunk_uploads} hits={s0.residency_hits}", flush=True)
                    out.setdefault("batch", []).append(dict(method=m, reduce=red, ms=ms,
                                                            windows=s0.windows))
            if layout == "structured":
                out["bricks"] = streamed_bricks(torch, np, eng, one_sync, brick_fresh, counted,
                                                warp_ops)
            # The budget held: the manager's peak, and what the allocator saw.
            c_raw, c_psf = chunks[None], chunks[PSF_TARGET]
            limit = (budget + exec_ds.chunk_nbytes(0, c_raw)
                     + (exec_ds.pixels[0].nbytes + bank_pack) * c_psf)
            peak = eng.residency.peak_bytes
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - base_alloc
            k = len(bqueries) if any(m in BATCH_METHODS for m in methods) else 1
            slack = k * STREAM_SCRATCH_MAPS * q * q * 4
            require(peak <= limit, f"{layout}: peak_bytes {peak} above budget + one chunk + "
                                   f"transients ({limit})")
            require(rise <= peak + slack, f"{layout}: max_memory_allocated rose {rise} bytes, "
                                          f"above peak_bytes {peak} + scratch {slack}")
            print(f"  {layout}: chunks of {c_raw} packs ({c_psf} PSF-matched); peak_bytes {peak} "
                  f"(budget {budget}, limit {limit}); max_memory_allocated rose {rise} bytes "
                  f"(peak + scratch {peak + slack})", flush=True)
            out.setdefault("memory", {})[layout] = dict(budget=budget, peak_bytes=peak, rise=rise,
                                                        limit=limit, slack=slack, pin_s=pin_s,
                                                        first_ms=first_ms, chunk_packs=c_raw,
                                                        chunk_packs_psf=c_psf)
            if layout == "per_file":
                # Where a cold dense query's time goes: one under the profiler.
                eng.residency.clear()
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    r = eng.run(query, methods[0])
                    wall_ms = (time.perf_counter() - t0) * 1e3
                out["profile"] = device_breakdown(torch, prof, wall_ms,
                                                  r.stats.t_map_reduce_s * 1e3)
                print(f"  streaming {methods[0]} mean cold, profiled: {out['profile']}", flush=True)
                out.update(staging_rates(torch, np, dev, exec_ds, chunks[None]))
            eng.residency.clear()
            if layout in FAULT_LAYOUTS:
                keep[layout] = eng
            del eng
    finally:
        engine_mod._sync = real_sync
        PackedDataset.pin = real_pin
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"  streaming launches: {launches}")
    for name in ("coadd_fused", "coadd_moments", "coadd_hist", "coadd_clip", "psf_match_2d",
                 "mosaic_bricks", "coadd_fused_batch", "coadd_moments_batch", "coadd_hist_batch",
                 "coadd_clip_batch"):
        require(launches[name] > 0, f"streaming: no {name} launch")
    out["launches"] = launches
    return out


def staging_rates(torch, np, dev, exec_ds, chunk):
    """Upload rates of the layout's pixels chunk by chunk on a side stream:
    straight from the registered array, and through a ring of two pinned
    staging buffers of one chunk each filled by a host copy (the other way
    to page-locked memory) -> {"registered_gb_s", "ring_gb_s",
    "ring_alloc_s"}."""
    px = exec_ds.pixels
    n, shape = px.shape[0], px.shape[1:]
    side = torch.cuda.Stream(dev)
    dst = [torch.empty((chunk,) + shape, dtype=torch.float32, device=dev) for _ in range(2)]
    spans = [(c, min(c + chunk, n)) for c in range(0, n, chunk)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (a, b) in enumerate(spans):
        with torch.cuda.stream(side):
            dst[i % 2][:b - a].copy_(torch.from_numpy(px[a:b]), non_blocking=True)
    side.synchronize()
    reg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stage = [torch.empty((chunk,) + shape, dtype=torch.float32, pin_memory=True)
             for _ in range(2)]
    alloc_s = time.perf_counter() - t0
    done = [None, None]
    t0 = time.perf_counter()
    for i, (a, b) in enumerate(spans):
        k = i % 2
        if done[k] is not None:
            done[k].synchronize()            # the buffer's last copy has left it
        np.copyto(stage[k].numpy()[:b - a], px[a:b])
        with torch.cuda.stream(side):
            dst[k][:b - a].copy_(stage[k][:b - a], non_blocking=True)
            done[k] = torch.cuda.Event()
            done[k].record(side)
    side.synchronize()
    ring_s = time.perf_counter() - t0
    rates = dict(registered_gb_s=px.nbytes / reg_s / 1e9, ring_gb_s=px.nbytes / ring_s / 1e9,
                 ring_alloc_s=alloc_s)
    print(f"  upload of {px.nbytes} pixel bytes in chunks of {chunk} packs on a side stream: "
          f"registered in place {rates['registered_gb_s']:.2f} GB/s; ring of two pinned staging "
          f"buffers (host copy, then H2D) {rates['ring_gb_s']:.2f} GB/s, its buffers allocated "
          f"in {alloc_s:.3f} s", flush=True)
    del dst, stage
    return rates


def streamed_bricks(torch, np, eng, one_sync, fresh_eager, counted, warp_ops):
    """The brick window under the budget: the fresh streamed window scan
    (against the eager one at the streaming tolerance), its 16 bricks
    materialized by streamed scans, then warm and spilled serves: exactly
    one ``mosaic_bricks`` launch each, bitwise the streamed ``run_window``."""
    m = "sql_structured"
    wq = eng.brick_grid.window_query(*BRICK_WINDOW, "r")
    fresh, fresh_ms = one_sync("streaming run_window", lambda: eng.run_window(wq, m))
    require(np.array_equal(fresh.depth, fresh_eager.depth)
            and np.allclose(fresh.coadd, fresh_eager.coadd, atol=STREAM_ATOL, rtol=STREAM_RTOL),
            "streaming run_window differs from the eager window")
    n_b = 16
    times = {}
    for tier, tiers in (("cold", (0, n_b, 0)), ("warm", (n_b, 0, 0)), ("spilled", (0, 0, n_b))):
        if tier == "spilled":
            require(eng.brick_store.drop_device() == n_b, "drop_device")
        before = warp_ops.mosaic_bricks.launches
        t0 = time.perf_counter()
        r = eng.run(wq, m, use_bricks=True)
        times[tier] = (time.perf_counter() - t0) * 1e3
        s = r.stats
        require((s.bricks_hit, s.bricks_missed, s.bricks_spilled) == tiers
                and warp_ops.mosaic_bricks.launches - before == 1,
                f"streaming bricks {tier}: hit/missed/spilled "
                f"{(s.bricks_hit, s.bricks_missed, s.bricks_spilled)}, "
                f"{warp_ops.mosaic_bricks.launches - before} mosaic launches")
        if tier != "cold":
            require(s.dispatches == 1, f"streaming bricks {tier}: {s.dispatches} launches")
        require(np.array_equal(r.coadd.view(np.int32), fresh.coadd.view(np.int32))
                and np.array_equal(r.depth, fresh.depth),
                f"streaming bricks {tier}: not bitwise run_window")
    print(f"  streaming bricks {m}: run_window {fresh_ms:.1f} ms ({fresh.stats.windows} windows), "
          f"cold {times['cold']:.1f} ms (16 materialized by streamed scans), warm "
          f"{times['warm']:.1f}, spilled {times['spilled']:.1f} ms: one mosaic_bricks launch "
          f"each, bitwise run_window", flush=True)
    return dict(fresh_ms=fresh_ms, **{f"{k}_ms": v for k, v in times.items()})


def faults_phase(torch, np, dev, survey, engines, query, bqueries, counted):
    """Phase "4 faults": the streamed path's fault domain (DESIGN.md §8) on
    the streaming phase's engines (``engines``: the per-file and structured
    layouts at a quarter of their device bytes, ``raw_fits`` 9 windows a
    pass, ``sql_structured`` 2).

    Every drill is held bitwise against the same engine's clean streamed
    run (default ``on_fault="retry"``), cold (``residency.clear()``): an
    upload failure, NaN poison that heals (the poisoned chunk dropped and
    uploaded again), persistent poison under ``"quarantine"`` (partial, the
    pack uncovered, depth exactly the run with that pack gated off at plan
    time and coadd within 1e-5 of it, then ``reverify_quarantined``
    restores full coverage), ``QueryKilled`` then a resume that replays only
    the finished windows (mean; median mid-pass and on the pass seam), a
    straggler speculated (its backup's digest agreeing), a
    `FaultSchedule.seeded` drill with all of these, the K = 4 batch and
    PSF-matched queries (both bank ranks) under faults.  Times the clean
    path under ``"retry"`` against ``"raise"`` (cold and warm, interleaved:
    0 retries, bitwise, one `_sync`), ``journal_dir`` against the in-memory
    journal (fresh engines; the journal bytes a query), each heal's ms over
    the clean query, host syncs and event waits a query; then the SIGKILL
    drill (`crash_drill`).  Checks each engine's ``peak_bytes`` and the
    ``max_memory_allocated`` rise as phase "4 streaming" does.  -> the
    numbers it printed.
    """
    import shutil

    import repro_torch.core.engine as engine_mod
    from repro_torch import CoaddEngine
    from repro_torch.core import durable
    from repro_torch.core.faults import ChaosInjector, FaultSchedule, PoisonSpec, QueryKilled

    out = {"overhead": [], "heals": [], "durable": []}
    q = query.npix
    syncs = [0]
    real_sync = engine_mod._sync

    def counted_sync(tensors):
        syncs[0] += 1
        return real_sync(tensors)

    def run(eng, m, red="mean", cold=True, batch=False):
        """One query (or the K = 4 batch) -> (result(s), host ms, host syncs,
        event waits)."""
        if cold:
            eng.residency.clear()
        s0, w0 = syncs[0], eng.event_waits
        t0 = time.perf_counter()
        r = eng.run_batch(bqueries, m, reduce=red) if batch else eng.run(query, m, reduce=red)
        return r, (time.perf_counter() - t0) * 1e3, syncs[0] - s0, eng.event_waits - w0

    def bitwise(what, got, want):
        for g, w in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            require(np.array_equal(g.coadd.view(np.int32), w.coadd.view(np.int32))
                    and np.array_equal(g.depth, w.depth), f"{what}: not bitwise the clean run")

    def drill(eng, what, m, sched, red="mean", batch=False, runs=1, **knobs):
        """``runs`` queries under one injector and the knobs -> ([(result,
        ms, syncs, waits, error)], injector), the knobs restored."""
        saved = {k: getattr(eng, k) for k in knobs}
        inj = ChaosInjector(sched)
        eng.fault_injector = inj
        for k, v in knobs.items():
            setattr(eng, k, v)
        got = []
        try:
            for i in range(runs):
                t0 = time.perf_counter()
                try:
                    got.append(run(eng, m, red, cold=i == 0, batch=batch) + (None,))
                except QueryKilled as e:
                    got.append((None, (time.perf_counter() - t0) * 1e3, 0, 0, e))
        finally:
            eng.fault_injector = None
            for k, v in saved.items():
                setattr(eng, k, v)
        return got, inj

    def record(what, m, red, heal_ms, clean_ms, stats, inj, extra=""):
        row = dict(drill=what, method=m, reduce=red, ms=heal_ms, clean_ms=clean_ms,
                   heal_ms=heal_ms - clean_ms, retries=stats.retries,
                   speculative=stats.speculative_windows, resumed=stats.resumed_windows,
                   quarantined=stats.quarantined_packs, uploads=stats.chunk_uploads,
                   injected=dict(inj.injected))
        out["heals"].append(row)
        print(f"  faults {what:32s} {m:16s} {red:6s} {heal_ms:8.1f} ms (clean {clean_ms:.1f}, "
              f"heal +{heal_ms - clean_ms:.1f}) retries={stats.retries} "
              f"speculative={stats.speculative_windows} resumed={stats.resumed_windows} "
              f"quarantined={stats.quarantined_packs} uploads={stats.chunk_uploads} "
              f"injected={dict(inj.injected)}{extra}", flush=True)

    for fn in counted.values():
        fn.launches = 0
    engine_mod._sync = counted_sync
    jroot = os.path.join(ROOT, "build", "fault_journals")
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_alloc = torch.cuda.memory_allocated()
        methods = {"per_file": "raw_fits", "structured": "sql_structured"}
        # Each engine's memory limit, as phase "4 streaming" computes it (its
        # PSF banks still cached): budget + one chunk + a matched build's
        # transients.
        limits, gated, n_win = {}, {}, {}
        for layout, eng in engines.items():
            exec_ds = eng.exec_dataset(layout)[0]
            c_raw = eng._chunk_packs(exec_ds)
            eng.match_psf_sigma = PSF_TARGET
            c_psf, bank_pack = eng._chunk_packs(exec_ds), eng._bank_pack_nbytes(layout)
            eng.match_psf_sigma = None
            limits[layout] = (eng.device_budget_bytes + exec_ds.chunk_nbytes(0, c_raw)
                              + (exec_ds.pixels[0].nbytes + bank_pack) * c_psf,
                              exec_ds.chunk_nbytes(0, c_raw))
            m = methods[layout]
            gate_any = eng._exec_gate(eng.plan(query, m)).any(axis=1)
            gated[m] = np.nonzero(gate_any)[0]
            n_win[m] = len(eng._stream_windows(exec_ds, gate_any))
        clean = {}
        for layout, eng in engines.items():
            m = methods[layout]
            eng.residency.clear()
            for red in ("mean", "median"):
                r, ms, ns, nw = run(eng, m, red)
                require(ns == 1 and r.stats.retries == 0 and not r.stats.partial,
                        f"faults clean {m}/{red}: {ns} syncs, {r.stats.retries} retries")
                clean[m, red] = (r, ms)

        # The clean path: "retry" (the tracker) against "raise" (the bare
        # loop), interleaved, cold and then warm.
        for layout, eng in engines.items():
            m = methods[layout]
            for red in ("mean", "median"):
                for cold in (True, False):
                    times = {"raise": [], "retry": []}
                    waits = {}
                    for pol in FAULT_INTERLEAVE:
                        eng.on_fault = pol
                        r, ms, ns, nw = run(eng, m, red, cold=cold)
                        what = f"faults overhead {m}/{red}/{pol}/{'cold' if cold else 'warm'}"
                        require(ns == 1, f"{what}: {ns} host syncs, expected 1")
                        require(r.stats.retries == 0, f"{what}: {r.stats.retries} retries on a "
                                                      "clean query")
                        bitwise(what, r, clean[m, red][0])
                        times[pol].append(ms)
                        waits[pol] = nw
                    eng.on_fault = "retry"
                    ratio = statistics.median(times["retry"]) / statistics.median(times["raise"])
                    if cold:
                        # The heals' yardstick: the clean cold query after warm-up.
                        clean[m, red] = (clean[m, red][0], statistics.median(times["retry"]))
                    row = dict(method=m, reduce=red, cold=cold, raise_ms=times["raise"],
                               retry_ms=times["retry"], ratio=ratio, syncs=1,
                               event_waits_raise=waits["raise"], event_waits_retry=waits["retry"],
                               windows=r.stats.windows)
                    out["overhead"].append(row)
                    print(f"  faults clean path {m:16s} {red:6s} {'cold' if cold else 'warm'}: "
                          f"retry/raise {ratio:.3f} (retry {times['retry']}, raise "
                          f"{times['raise']} ms); {r.stats.windows} windows, 1 host sync, event "
                          f"waits {waits['retry']} (raise {waits['raise']}), 0 retries, bitwise",
                          flush=True)

        pf, st = engines["per_file"], engines["structured"]
        spec_chunks = 0

        # Transient faults and poison that heal.
        for m, eng, red in (("raw_fits", pf, "mean"), ("sql_structured", st, "median")):
            (res,), inj = drill(eng, "upload", m, FaultSchedule(upload_fail_ordinals=(0,)), red)
            r, ms = res[0], res[1]
            require(inj.injected["upload_fail"] == 1 and r.stats.retries >= 1,
                    f"faults upload {m}: {dict(inj.injected)}, {r.stats.retries} retries")
            bitwise(f"faults upload {m}/{red}", r, clean[m, red][0])
            record("upload failure (ordinal 0)", m, red, ms, clean[m, red][1], r.stats, inj)
        for m, eng, red in (("raw_fits", pf, "mean"), ("sql_structured", st, "mean")):
            bad = int(gated[m][0])
            (res,), inj = drill(eng, "poison", m,
                                FaultSchedule(poison=(PoisonSpec(bad, "nan", 1),)), red)
            r, ms = res[0], res[1]
            c = clean[m, red][0]
            require(inj.injected["poison"] == 1 and r.stats.retries == 1
                    and r.stats.chunk_uploads == c.stats.chunk_uploads + 1,
                    f"faults poison {m}: {dict(inj.injected)}, {r.stats.retries} retries, "
                    f"{r.stats.chunk_uploads} uploads (clean {c.stats.chunk_uploads})")
            bitwise(f"faults poison {m}", r, c)
            record("NaN poison, heals (count=1)", m, red, ms, clean[m, red][1], r.stats, inj,
                   f"; the poisoned chunk dropped and uploaded again, event waits {res[3]}")

        # Persistent poison under quarantine, then re-verification.
        m = "sql_structured"
        bad = int(gated[m][0])
        for red in ("mean", "median"):
            plan = st.plan(query, m, red)
            plan.gate[bad] = False
            st.residency.clear()
            want = st.execute(plan)
            (res,), inj = drill(st, "quarantine", m,
                                FaultSchedule(poison=(PoisonSpec(bad, "nan", None),)), red,
                                on_fault="quarantine")
            r, ms = res[0], res[1]
            what = f"faults quarantine {m}/{red}"
            require(r.stats.partial and r.stats.uncovered_packs == (bad,)
                    and r.stats.quarantined_packs == 1,
                    f"{what}: partial {r.stats.partial}, uncovered {r.stats.uncovered_packs}")
            require(np.array_equal(r.depth, want.depth), f"{what}: depth differs from the run "
                                                         "with the pack gated off")
            require(np.allclose(r.coadd, want.coadd, rtol=1e-5, atol=1e-5),
                    f"{what}: coadd max |diff| {float(np.abs(r.coadd - want.coadd).max()):.3g}")
            released = st.reverify_quarantined()
            require(released == [bad], f"{what}: reverify released {released}")
            after, _, _, _ = run(st, m, red)
            require(not after.stats.partial and after.stats.requarantine_released == 1,
                    f"{what}: after reverify partial {after.stats.partial}")
            bitwise(f"{what} after reverify", after, clean[m, red][0])
            record("persistent poison, quarantine", m, red, ms, clean[m, red][1], r.stats, inj,
                   f"; uncovered {r.stats.uncovered_packs}, depth exactly the gated run, "
                   f"coadd max |diff| {float(np.abs(r.coadd - want.coadd).max()):.3g}; "
                   "reverify_quarantined restored full coverage, bitwise")

        # Kill, then resume: only the missing windows run.
        for m, eng, red, after in (("sql_structured", st, "mean", 1),
                                   ("raw_fits", pf, "mean", 4),
                                   ("raw_fits", pf, "median", 5),
                                   ("raw_fits", pf, "median", n_win["raw_fits"])):
            got, inj = drill(eng, "kill", m, FaultSchedule(kill_after_windows=after), red, runs=2)
            (_, kill_ms, _, _, err), (r, ms, ns, nw, err2) = got
            what = f"faults kill after {after} {m}/{red}"
            require(err is not None and err2 is None, f"{what}: killed {err}, resume {err2}")
            require(r.stats.resumed_windows == after
                    and r.stats.dispatches == r.stats.windows - after and ns == 1,
                    f"{what}: resumed {r.stats.resumed_windows}, {r.stats.dispatches} launches "
                    f"of {r.stats.windows} windows, {ns} syncs")
            require(not eng._journals, f"{what}: a journal left after the resume")
            bitwise(what, r, clean[m, red][0])
            seam = " (the pass seam)" if red != "mean" and after == n_win[m] else ""
            record(f"kill after {after} windows, resume{seam}", m, red, kill_ms + ms,
                   clean[m, red][1], r.stats, inj,
                   f"; killed query {kill_ms:.1f} ms, resume {ms:.1f} ms, {nw} event waits")

        # A straggler speculated; then the seeded drill with every fault.
        m, red = "raw_fits", "mean"
        (res,), inj = drill(pf, "straggler", m,
                            FaultSchedule(slow_windows={n_win[m] - 2: FAULT_SLOW_S}), red,
                            straggler_factor=FAULT_STRAGGLER)
        r, ms = res[0], res[1]
        require(inj.injected["slow"] == 1 and r.stats.speculative_windows >= 1,
                f"faults straggler: {dict(inj.injected)}, {r.stats.speculative_windows} backups")
        bitwise("faults straggler", r, clean[m, red][0])
        spec_chunks = max(spec_chunks, r.stats.speculative_windows)
        record("straggler, speculated", m, red, ms, clean[m, red][1], r.stats, inj,
               "; backup digest agreed")
        sched = FaultSchedule.seeded(FAULT_SEED, n_uploads=n_win[m], n_windows=n_win[m],
                                     gated_packs=gated[m], slow_s=FAULT_SLOW_S)
        (res,), inj = drill(pf, "seeded", m, sched, red, straggler_factor=FAULT_STRAGGLER)
        r, ms = res[0], res[1]
        require(all(inj.injected[k] >= 1 for k in ("upload_fail", "poison", "slow"))
                and r.stats.retries >= 2,
                f"faults seeded: {dict(inj.injected)}, {r.stats.retries} retries")
        bitwise("faults seeded", r, clean[m, red][0])
        spec_chunks = max(spec_chunks, r.stats.speculative_windows)
        record(f"seeded {FAULT_SEED}: {sched.upload_fail_ordinals}, "
               f"{[p.pack for p in sched.poison]}, {sorted(sched.slow_windows)}", m, red, ms,
               clean[m, red][1], r.stats, inj)

        # The K = 4 batch and PSF-matched queries (both bank ranks) under faults.
        m = "sql_structured"
        cb, cb_ms, _, _ = run(st, m, "median", batch=True)
        (res,), inj = drill(st, "batch", m, FaultSchedule(upload_fail_ordinals=(0,)), "median",
                            batch=True)
        require(res[0][0].stats.retries >= 1, "faults batch: no retry")
        bitwise("faults batch upload", res[0], cb)
        record(f"K={len(bqueries)} batch, upload failure", m, "median", res[1], cb_ms,
               res[0][0].stats, inj)
        for measured, sched in ((None, FaultSchedule(poison=(PoisonSpec(bad, "nan", 1),))),
                                (False, FaultSchedule(upload_fail_ordinals=(0,)))):
            st.match_psf_sigma, st.measured_psf = PSF_TARGET, measured
            want, want_ms, _, _ = run(st, m, "mean")
            (res,), inj = drill(st, "psf", m, sched, "mean")
            require(res[0].stats.retries >= 1, f"faults psf measured={measured}: no retry")
            bitwise(f"faults psf measured={measured}", res[0], want)
            record(f"PSF {PSF_TARGET} {'2d' if measured is None else 'sep'} bank, "
                   f"{'poison' if measured is None else 'upload'}", m, "mean", res[1], want_ms,
                   res[0].stats, inj)
        st.match_psf_sigma, st.measured_psf = None, None

        # verify_digests: the host hashes every chunk it uploads against the
        # layout's digests (made once); finite corruption heals.
        m, red = "raw_fits", "mean"
        t0 = time.perf_counter()
        pf.exec_dataset("per_file")[0].pack_digests()
        digests_s = time.perf_counter() - t0
        pf.verify_digests = True
        try:
            dig, dig_ms, ns, _ = run(pf, m, red)
            require(ns == 1 and dig.stats.retries == 0, "faults verify_digests: not clean")
            bitwise("faults verify_digests clean", dig, clean[m, red][0])
            (res,), inj = drill(pf, "flip", m,
                                FaultSchedule(poison=(PoisonSpec(int(gated[m][0]), "flip", 1),)),
                                red)
        finally:
            pf.verify_digests = False
        require(res[0].stats.retries == 1, f"faults flip: {res[0].stats.retries} retries")
        bitwise("faults flip under verify_digests", res[0], clean[m, red][0])
        out["verify_digests"] = dict(layout_digests_s=digests_s, clean_ms=dig_ms,
                                     cost_ms=dig_ms - clean[m, red][1])
        print(f"  faults verify_digests {m}: the layout's digests in {digests_s:.3f} s (once); "
              f"a clean cold query {dig_ms:.1f} ms (+{dig_ms - clean[m, red][1]:.1f} over "
              f"{clean[m, red][1]:.1f}: a sha256 of its 3.02 GB uploads)", flush=True)
        record("finite corruption (flip), verify_digests", m, red, res[1], dig_ms, res[0].stats,
               inj)

        # The budget held, as in phase "4 streaming" (a straggler's backup
        # may hold one more chunk until it ends).  Both engines stay alive
        # through the phase, each holding its chunks: the allocator's rise
        # is held to the sum of their peaks.
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base_alloc
        peaks = 0
        for layout, eng in engines.items():
            limit, chunk = limits[layout]
            limit += spec_chunks * chunk if layout == "per_file" else 0
            peak = eng.residency.peak_bytes
            require(peak <= limit, f"faults {layout}: peak_bytes {peak} above {limit}")
            peaks += peak
            out.setdefault("memory", {})[layout] = dict(peak_bytes=peak, limit=limit)
        slack = len(bqueries) * STREAM_SCRATCH_MAPS * q * q * 4
        require(rise <= peaks + slack, f"faults: max_memory_allocated rose {rise} bytes, above "
                                       f"the engines' peak_bytes {peaks} + scratch {slack}")
        out["memory"]["rise"] = rise
        print(f"  faults memory: peak_bytes {out['memory']}; max_memory_allocated rose {rise} "
              f"bytes (peak + scratch {peaks + slack})", flush=True)

        # journal_dir against the in-memory journal: fresh engines, one a layout.
        journal_bytes = [0]
        real_set = durable.DiskJournal.__setitem__

        def counting_set(journal, key, parts):
            journal_bytes[0] += sum(int(np.asarray(p).nbytes) for p in parts)
            return real_set(journal, key, parts)

        durable.DiskJournal.__setitem__ = counting_set
        try:
            for layout, eng in engines.items():
                m = methods[layout]
                jd = os.path.join(jroot, layout)
                shutil.rmtree(jd, ignore_errors=True)
                deng = CoaddEngine(survey, pack_capacity=64, device=DEVICE,
                                   device_budget_bytes=eng.device_budget_bytes, journal_dir=jd)
                deng.run(query, m)           # its first query pays the layout's packing
                for red in ("mean", "median"):
                    for cold in (True, False):
                        times = {"memory": [], "disk": []}
                        for kind in FAULT_JOURNAL_INTERLEAVE:
                            e = deng if kind == "disk" else eng
                            journal_bytes[0] = 0
                            r, ms, ns, nw = run(e, m, red, cold=cold)
                            what = f"faults journal_dir {m}/{red}/{kind}"
                            require(ns == 1 and r.stats.retries == 0, f"{what}: {ns} syncs")
                            bitwise(what, r, clean[m, red][0])
                            times[kind].append(ms)
                            if kind == "disk":
                                jbytes, jwaits = journal_bytes[0], nw
                        require(not deng.journal_store.jobs(), f"{m}: a disk journal left")
                        ratio = statistics.median(times["disk"]) / statistics.median(
                            times["memory"])
                        out["durable"].append(dict(method=m, reduce=red, cold=cold, ratio=ratio,
                                                   disk_ms=times["disk"],
                                                   memory_ms=times["memory"],
                                                   journal_bytes=jbytes, event_waits=jwaits))
                        print(f"  faults journal_dir {m:16s} {red:6s} "
                              f"{'cold' if cold else 'warm'}: disk/memory {ratio:.3f} (disk "
                              f"{times['disk']}, memory {times['memory']} ms); {jbytes} journal "
                              f"bytes a query, {jwaits} event waits", flush=True)
                del deng
                shutil.rmtree(jd, ignore_errors=True)
        finally:
            durable.DiskJournal.__setitem__ = real_set
    finally:
        engine_mod._sync = real_sync
        for eng in engines.values():
            eng.residency.clear()
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"  faults launches: {launches}")
    for name in ("coadd_fused", "coadd_moments", "coadd_hist", "coadd_clip", "psf_match_sep",
                 "psf_match_2d", "coadd_moments_batch", "coadd_hist_batch", "coadd_clip_batch"):
        require(launches[name] > 0, f"faults: no {name} launch")
    out["launches"] = launches
    out["crash"] = crash_drill(np)
    return out


def crash_drill(np):
    """The SIGKILL drill: this script as a subprocess (``--crash-child``)
    streams ``raw_fits`` over a reduced survey (`CRASH_CFG`) with
    ``journal_dir``: once uninterrupted, once killed by its own SIGKILL at
    `CRASH_STAGE` (`durable.set_crash_hook`), then a fresh process on the
    killed one's journal, which must resume (``resumed_windows`` > 0, only
    the missing windows launched, no journal left) bitwise the
    uninterrupted run.  -> the numbers it printed."""
    import shutil

    root = os.path.join(ROOT, "build", "crash_drill")
    shutil.rmtree(root, ignore_errors=True)

    def child(name, crash=None):
        cmd = [sys.executable, os.path.abspath(__file__), "--crash-child",
               os.path.join(root, name)]
        if crash:
            cmd += ["--crash", crash]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=CRASH_TIMEOUT_S)
        return proc, time.perf_counter() - t0

    def load(name):
        path = os.path.join(root, name, "out.npz")
        with np.load(path) as z:
            coadd, depth = z["coadd"], z["depth"]
        with open(path + ".json") as fh:
            return coadd, depth, json.load(fh)

    clean, clean_s = child("clean")
    require(clean.returncode == 0, f"crash drill: the clean run exited {clean.returncode}\n"
                                   f"{clean.stderr[-2000:]}")
    killed, killed_s = child("drill", CRASH_STAGE)
    require(killed.returncode == -9, f"crash drill: exited {killed.returncode}, expected "
                                     f"SIGKILL\n{killed.stderr[-2000:]}")
    require(not os.path.exists(os.path.join(root, "drill", "out.npz")),
            "crash drill: the killed run finished")
    resumed, resumed_s = child("drill")
    require(resumed.returncode == 0, f"crash drill: the resume exited {resumed.returncode}\n"
                                     f"{resumed.stderr[-2000:]}")
    c0, d0, s0 = load("clean")
    c1, d1, s1 = load("drill")
    require(s1["resumed_windows"] >= 1
            and s1["dispatches"] == s1["windows"] - s1["resumed_windows"]
            and not s1["jobs_left"],
            f"crash drill: resume stats {s1}")
    require(np.array_equal(c1.view(np.int32), c0.view(np.int32)) and np.array_equal(d1, d0),
            "crash drill: the resumed coadd is not bitwise the uninterrupted one")
    row = dict(stage=CRASH_STAGE, survey=CRASH_CFG, clean=s0, resumed=s1,
               clean_s=clean_s, killed_s=killed_s, resumed_s=resumed_s)
    print(f"  faults SIGKILL at {CRASH_STAGE}: {s0['frames']} frames, {s0['windows']} windows; "
          f"the killed process died mid-query ({killed_s:.1f} s), a fresh one resumed "
          f"{s1['resumed_windows']} windows and launched {s1['dispatches']} ({resumed_s:.1f} s; "
          f"uninterrupted {clean_s:.1f} s, query {s0['query_ms']:.1f} ms, resumed query "
          f"{s1['query_ms']:.1f} ms), bitwise", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return row


def crash_child(out_dir, crash):
    """``--crash-child``: one durable streamed ``raw_fits`` query over
    `CRASH_CFG` on the card, its result into ``out_dir``; with ``crash``
    (``stage:ordinal``) the process SIGKILLs itself at that durable commit."""
    import signal

    import numpy as np
    import torch

    from repro_torch import CoaddEngine, CoaddQuery, SurveyConfig, make_survey
    from repro_torch.core import durable

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    survey = make_survey(SurveyConfig(**CRASH_CFG), processes=os.cpu_count() or 1)
    probe = CoaddEngine(survey, pack_capacity=64, device=DEVICE).exec_dataset("per_file")[0]
    budget = probe.chunk_nbytes(0, probe.n_packs) // STREAM_FRAC
    del probe
    if crash:
        stage, ordinal = crash.rsplit(":", 1)
        seen = [0]

        def hook(s):
            if s == stage:
                if seen[0] == int(ordinal):
                    os.kill(os.getpid(), signal.SIGKILL)
                seen[0] += 1

        durable.set_crash_hook(hook)
    os.makedirs(out_dir, exist_ok=True)
    eng = CoaddEngine(survey, pack_capacity=64, device=DEVICE, device_budget_bytes=budget,
                      journal_dir=os.path.join(out_dir, "journal"))
    t0 = time.perf_counter()
    res = eng.run(CoaddQuery(**MAIN_QUERY), "raw_fits")
    ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(out_dir, "out.npz")
    np.savez(path, coadd=res.coadd, depth=res.depth)
    with open(path + ".json", "w") as fh:
        json.dump(dict(frames=len(survey), windows=res.stats.windows,
                       dispatches=res.stats.dispatches,
                       resumed_windows=res.stats.resumed_windows, query_ms=ms,
                       jobs_left=eng.journal_store.jobs()), fh)
    return 0


def dist_rank(rank, world, spec):
    """One rank of phase "4 distributed" (`distributed_phase`), started by
    `repro_torch.launch.mesh.run_ranks` -> its rows.

    Loads the pickled survey, builds the meshes of ``spec`` over the group
    (``spec["backend"]``) and, for each engine setting (sparse or dense,
    eager or streamed, no bank, the 13 x 13 bank or the 15-tap fallback),
    each query set and mesh, runs ``run_distributed``: twice counted (the
    ``warp_project`` and ``psf_match_*`` launches: one each a query a
    window; exactly ``windows`` dispatches), once timed by stage (the map
    and the collectives, each closed by a sync), once held (each
    ``warp_batch`` launch bitwise its check form ``warp_project_unculled_f32``
    and each ``psf_match_*`` launch bitwise its plain version, in slices of
    `DIST_HOLD_IMAGES`).  Rank 0 also runs the single-host
    ``run(q, "sql_structured")`` on the same engine and keeps its results
    to hold sparse against dense.  Every rank returns the digest of each
    job's results, which must be rank 0's."""
    import hashlib
    import pickle

    import numpy as np
    import torch

    from repro_torch import CoaddEngine, CoaddQuery
    from repro_torch.core import reducer
    from repro_torch.core.seqfile import pack_structured
    from repro_torch.distributed.sharding import shard_count, shard_local_compaction
    from repro_torch.kernels import build
    from repro_torch.kernels.warp import ops as warp_ops
    from repro_torch.kernels.warp import ref
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    with open(spec["survey"], "rb") as fh:
        survey = pickle.load(fh)
    meshes = {name: (make_mesh(DIST_MESHES[name][0], DIST_MESHES[name][1], dev.type,
                               spec["backend"]), DIST_MESHES[name][2]) for name in spec["meshes"]}
    qsets = {name: [CoaddQuery(**q) for q in qs] for name, qs in spec["queries"].items()}
    kernels = {"warp_project": warp_ops.warp_batch, "psf_match_2d": warp_ops.psf_match_2d,
               "psf_match_sep": warp_ops.psf_match_sep}
    sync = torch.cuda.synchronize
    held = {"warp_project": [0, 0], "psf_match": [0, 0]}   # launches held, differing words

    def words_differ(a, b):
        return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())

    def held_warp(px, wv, acc, gra, gdec):
        tile, cov = real["warp_project"](px, wv, acc, gra, gdec)
        q = gra.shape[0]
        lib = build.library("warp")
        for a in range(0, px.shape[0], DIST_HOLD_IMAGES):
            b = min(a + DIST_HOLD_IMAGES, px.shape[0])
            outs = [torch.empty((b - a, q, q), device=dev) for _ in range(2)]
            err = lib.warp_project_unculled_f32(
                *(t.data_ptr() for t in (px[a:b], wv[a:b], acc[a:b], gra, gdec, *outs)),
                b - a, px.shape[1], px.shape[2], q, dev.index or 0,
                torch.cuda.current_stream().cuda_stream)
            require(err == 0, f"warp_project_unculled_f32: CUDA error {err}")
            held["warp_project"][1] += words_differ(tile[a:b], outs[0]) + words_differ(
                cov[a:b], outs[1])
        held["warp_project"][0] += 1
        return tile, cov

    def held_psf(name):
        def launch(pixels, pack_idx, bank, skip=None, *, host_idx=None):
            out = real[name](pixels, pack_idx, bank, skip, host_idx=host_idx)
            n = pixels.shape[1]
            for a in range(0, n, DIST_HOLD_IMAGES):
                b = min(a + DIST_HOLD_IMAGES, n)
                want = ref.psf_match_ref(pixels[:, a:b].contiguous(), pack_idx,
                                         bank[:, a:b].contiguous())
                held["psf_match"][1] += words_differ(out[:, a:b], want)
            held["psf_match"][0] += 1
            return out
        return launch

    def staged_run(eng, qs, mesh, data_axes):
        """One run with a sync closing the map and the collectives -> their
        ms.  The stand-ins are gone when it returns (none keeps ``eng``)."""
        stage = {"map": 0.0, "collective": 0.0}

        def timed(name, fn):
            def call(*a, **k):
                sync()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                sync()
                stage[name] += (time.perf_counter() - t0) * 1e3
                return out
            return call

        real_rc, real_gc = reducer.reduce_collective, reducer.gather_collective
        eng._map_shard_window = timed("map", eng._map_shard_window)
        reducer.reduce_collective = timed("collective", real_rc)
        reducer.gather_collective = timed("collective", real_gc)
        try:
            eng.run_distributed(qs, mesh, data_axes=data_axes)
        finally:
            del eng._map_shard_window
            reducer.reduce_collective, reducer.gather_collective = real_rc, real_gc
        return stage

    real = dict(kernels)
    rows, keep, pending = [], {}, []
    # One packed (and page-locked) structured layout for every engine.
    layout = pack_structured(survey, 64)
    pin_s = layout.pin() if dev.type == "cuda" else 0.0
    for cfg in spec["configs"]:
        kw = dict(pack_capacity=64, device=dev, sparse=cfg["sparse"])
        if cfg["bank"]:
            kw.update(match_psf_sigma=PSF_TARGET, measured_psf=DIST_PSF[cfg["bank"]])
        if cfg["stream"]:
            kw["device_budget_bytes"] = layout.chunk_nbytes(0, layout.n_packs) // cfg["stream"]
        eng = CoaddEngine(survey, **kw)
        eng._datasets["structured"] = layout
        exec_ds = eng.exec_dataset("structured")[0]
        for mname, (mesh, data_axes) in meshes.items():
            axes = tuple(data_axes) + ("model",)
            up_ms = up_bytes = None
            if not cfg["stream"]:
                eng.psf_kernel_bank("structured")   # the host bank solve: not the upload
                sync()
                t0 = time.perf_counter()
                mds = eng.mesh_dataset("structured", mesh, axes)
                sync()
                up_ms = (time.perf_counter() - t0) * 1e3
                up_bytes = sum(t.numel() * t.element_size() for t in (
                    mds.pixels, mds.wcs, *mds.ints.values(), *mds.floats.values(),
                    *(() if mds.psf_kernels is None else (mds.psf_kernels,))))
                del mds
            for qname, qs in qsets.items():
                job = dict(cfg, mesh=mname, queries=qname, rank=rank, upload_ms=up_ms,
                           upload_bytes=up_bytes)
                times, uploads = [], []
                for rep in range(2):
                    before = {k: f.launches for k, f in kernels.items()}
                    d0 = eng.dispatch_count
                    sync()
                    t0 = time.perf_counter()
                    res = eng.run_distributed(qs, mesh, data_axes=data_axes)
                    times.append((time.perf_counter() - t0) * 1e3)
                    got = {k: f.launches - before[k] for k, f in kernels.items()}
                    st = res[0].stats
                    uploads.append(st.chunk_uploads)
                    win = st.windows
                    want = {"warp_project": win * len(qs), "psf_match_2d": 0, "psf_match_sep": 0}
                    if cfg["bank"]:
                        want["psf_match_" + cfg["bank"]] = win * len(qs)
                    require(got == want, f"distributed {job}: launches {got}, expected {want}")
                    require(st.dispatches == win == eng.dispatch_count - d0
                            and all(r.stats.dispatches == 0 for r in res[1:]),
                            f"distributed {job}: {st.dispatches} dispatches, {win} windows")
                    for k in got:
                        job.setdefault("launches", {}).setdefault(k, 0)
                        job["launches"][k] += got[k]
                digest = hashlib.sha256()
                for r in res:
                    digest.update(r.coadd.tobytes() + r.depth.tobytes())
                job.update(cold_ms=times[0], warm_ms=times[1], windows=st.windows,
                           packs_scanned=st.packs_scanned, scan_budget=st.scan_budget,
                           packs_touched=[r.stats.packs_touched for r in res],
                           chunk_uploads=uploads, residency_hits=st.residency_hits,
                           peak_resident_bytes=st.peak_resident_bytes,
                           launches_per_window=len(qs) * (2 if cfg["bank"] else 1),
                           digest=digest.hexdigest(), t_locate_ms=st.t_locate_s * 1e3,
                           pass_ms=st.t_map_reduce_s * 1e3)
                # The stages, each closed by a sync (a breakdown run; the
                # counted runs above have none).
                stage = staged_run(eng, qs, mesh, data_axes)
                job.update(map_ms=stage["map"], collective_ms=stage["collective"])
                # The held run: every launch against its check form or plain
                # version.  A wrapper counts its launch on the function its
                # module binds to its name, so each stand-in carries a count.
                warp_ops.warp_batch = held_warp
                warp_ops.psf_match_2d = held_psf("psf_match_2d")
                warp_ops.psf_match_sep = held_psf("psf_match_sep")
                for f in (warp_ops.warp_batch, warp_ops.psf_match_2d, warp_ops.psf_match_sep):
                    f.launches = 0
                h0 = {k: list(v) for k, v in held.items()}
                try:
                    res_h = eng.run_distributed(qs, mesh, data_axes=data_axes)
                finally:
                    warp_ops.warp_batch = real["warp_project"]
                    warp_ops.psf_match_2d = real["psf_match_2d"]
                    warp_ops.psf_match_sep = real["psf_match_sep"]
                job["held"] = {k: [held[k][0] - h0[k][0], held[k][1] - h0[k][1]] for k in held}
                require(all(v[1] == 0 for v in job["held"].values()),
                        f"distributed {job}: launches differ from their check forms "
                        f"{job['held']}")
                require(all(np.array_equal(a.coadd.view(np.int32), b.coadd.view(np.int32))
                            and np.array_equal(a.depth, b.depth) for a, b in zip(res, res_h)),
                        f"distributed {job}: the held run differs from the counted run")
                if rank == 0:
                    pending.append((job, mesh, axes, qs, res))
                rows.append(job)
                del res, res_h
        # Rank 0 against the single-host run, after the config's jobs: the
        # layout it uploads is not resident beside a dense map's tiles.
        for job, mesh, axes, qs, res in pending:
            n_sh = shard_count(mesh, axes)
            gates = np.stack([exec_ds.flat_slot_mask(eng.sql.select(q),
                                                     pad_to=exec_ds.flat_len(n_sh))
                              for q in qs])
            job["budgets"] = [int(b) for b in
                              shard_local_compaction(gates.any(axis=0), n_sh)[3]]
            dc, dd, cov = [], [], []
            for q, r in zip(qs, res):
                single = eng.run(q, "sql_structured")
                dc.append(float(np.abs(r.coadd - single.coadd).max()))
                dd.append(int((r.depth != single.depth).sum()))
                cov.append(int(single.depth.max() > 0))
            job.update(max_abs_vs_single=dc, depth_differs=dd, covered=cov,
                       finite=bool(all(np.isfinite(r.coadd).all() for r in res)))
            keep[(cfg["stream"], cfg["bank"], job["mesh"], job["queries"], cfg["sparse"])] = [
                (r.coadd, r.depth) for r in res]
        pending.clear()
        del eng
        torch.cuda.empty_cache()
    sparse_dense = []
    for key, got in keep.items():
        if key[-1] and key[:-1] + (False,) in keep:
            want = keep[key[:-1] + (False,)]
            sparse_dense.append(dict(
                stream=key[0], bank=key[1], mesh=key[2], queries=key[3],
                max_abs=max(float(np.abs(g[0] - w[0]).max()) for g, w in zip(got, want)),
                depth_differs=sum(int((g[1] != w[1]).sum()) for g, w in zip(got, want))))
    return dict(rows=rows, sparse_dense=sparse_dense, pin_s=pin_s)


def distributed_phase(torch, np, survey, query, bqueries, procs):
    """Phase "4 distributed": ``run_distributed`` in form (a), one NCCL rank
    at full width, and form (b), eight gloo ranks sharing the card over the
    cut survey (`dist_rank` on each, through ``run_ranks``) -> the rows.

    Holds every job within `DIST_ATOL` of the single-host run with depth
    exactly, sparse within `DIST_SPARSE_ATOL` of dense with depth exactly,
    every rank's results bitwise rank 0's, sparse ``packs_scanned`` below
    dense, unequal per-shard budgets on form (b)'s band-gated jobs."""
    import concurrent.futures
    import pickle
    import shutil

    from repro_torch import SurveyConfig, make_survey
    from repro_torch.launch.mesh import DEFAULT_BACKEND

    root = os.path.join(ROOT, "build", "distributed")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.empty_cache()

    def qdict(q):
        return dict(band=q.band, ra_bounds=tuple(q.ra_bounds), dec_bounds=tuple(q.dec_bounds),
                    npix=q.npix)

    queries = {"main": [qdict(query)], "k4": [qdict(q) for q in bqueries]}

    def pickled(form, sv=None):
        """The form's survey pickled for its ranks -> (path, frames, s)."""
        t0 = time.perf_counter()
        if sv is None:
            sv = make_survey(SurveyConfig(**CRASH_CFG), processes=procs)
        path = os.path.join(root, f"survey_{form}.pkl")
        with open(path, "wb") as fh:
            pickle.dump(sv, fh, protocol=pickle.HIGHEST_PROTOCOL)
        return path, len(sv), time.perf_counter() - t0

    forms = {}
    dev_type = torch.device(DEVICE).type
    # Form (b)'s cut survey renders (in its own process pool) while form
    # (a)'s rank runs.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        prepared = {"a": pool.submit(pickled, "a", survey), "b": pool.submit(pickled, "b")}
        for form, world, backend in (("a", 1, DEFAULT_BACKEND[dev_type]),
                                     ("b", DIST_WORLD_B, "gloo")):
            forms[form] = distributed_form(form, world, backend, *prepared[form].result(),
                                           queries, root)
    shutil.rmtree(root, ignore_errors=True)
    return forms


def distributed_form(form, world, backend, path, n_frames, prep_s, queries, root):
    """One form of phase "4 distributed" (`distributed_phase`): its ranks
    through ``run_ranks``, their rows held and printed -> the form's row."""
    from repro_torch.launch.mesh import run_ranks

    # Form (a): every bank, streamed at STREAM_FRAC of the layout; form
    # (b): unmatched, streamed at a quarter of each rank's share.
    banks = tuple(DIST_PSF) if form == "a" else (None,)
    frac = STREAM_FRAC * world
    configs = [dict(sparse=sp, stream=st, bank=bk) for bk in banks for st in (None, frac)
               for sp in (True, False)]
    spec = dict(survey=path, device=DEVICE, backend=backend, configs=configs,
                meshes=["1x1"] if form == "a" else ["4x2", "2x2x2"],
                queries=queries if form == "a" else {"k4": queries["k4"]})
    store = os.path.join(root, f"store_{form}")
    os.makedirs(store)
    # A dense map's tiles and coverage are 2 x 15 GB a query at full
    # width; the ranks' allocators grow segments in place rather than
    # leave the card fragmented between jobs.
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        out = run_ranks(dist_rank, world, store, backend, args=(spec,),
                        timeout_s=DIST_TIMEOUT_S)
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    wall_s = time.perf_counter() - t0
    rows0 = out[0]["rows"]
    for r, o in enumerate(out[1:], 1):
        for a, b in zip(rows0, o["rows"]):
            require(a["digest"] == b["digest"],
                    f"distributed ({form}) rank {r}: results differ from rank 0's "
                    f"({a['mesh']}, {a['queries']}, sparse={a['sparse']}, "
                    f"stream={a['stream']}, bank={a['bank']})")
    for job in rows0:
        what = (f"({form}) {job['mesh']} {job['queries']} "
                f"{'sparse' if job['sparse'] else 'dense'} "
                f"{'streamed' if job['stream'] else 'eager'} bank={job['bank']}")
        require(job["finite"] and all(job["covered"]), f"distributed {what}: empty or NaN")
        require(max(job["max_abs_vs_single"]) < DIST_ATOL,
                f"distributed {what}: coadd {job['max_abs_vs_single']} from single-host")
        require(not any(job["depth_differs"]),
                f"distributed {what}: depth differs from single-host at "
                f"{job['depth_differs']} pixels")
        ranks = " ".join(f"r{r}:{o['rows'][rows0.index(job)]['map_ms']:.1f}/"
                         f"{o['rows'][rows0.index(job)]['collective_ms']:.1f}"
                         for r, o in enumerate(out))
        up = ("" if job["upload_ms"] is None else
              f" upload {job['upload_ms']:.1f} ms for {job['upload_bytes']} B a rank "
              f"({job['upload_bytes'] / job['upload_ms'] / 1e6:.2f} GB/s)")
        print(f"  distributed {what}: job ms cold {job['cold_ms']:.1f} warm "
              f"{job['warm_ms']:.1f} (pass {job['pass_ms']:.1f}, locate "
              f"{job['t_locate_ms']:.1f}); windows {job['windows']}, "
              f"uploads cold/warm {job['chunk_uploads']}, packs_scanned {job['packs_scanned']}, "
              f"scan_budget {job['scan_budget']}, budgets {job['budgets']}, "
              f"launches/window/rank {job['launches_per_window']}; map/collective ms "
              f"by rank {ranks};{up} max|d single| {max(job['max_abs_vs_single']):.3g}; "
              f"held {job['held']}", flush=True)
    for sd in out[0]["sparse_dense"]:
        require(sd["max_abs"] < DIST_SPARSE_ATOL and sd["depth_differs"] == 0,
                f"distributed ({form}) sparse vs dense {sd}")
    for job in rows0:
        if job["sparse"]:
            dense = [j for j in rows0 if not j["sparse"] and all(
                j[k] == job[k] for k in ("stream", "bank", "mesh", "queries"))]
            require(dense and job["packs_scanned"] < dense[0]["packs_scanned"],
                    f"distributed ({form}): sparse packs_scanned {job['packs_scanned']} "
                    f"not below dense")
            if form == "b":
                require(min(job["budgets"]) < max(job["budgets"]),
                        f"distributed (b): budgets {job['budgets']} all equal")
    launches = {}
    for o in out:
        for job in o["rows"]:
            for k, v in job["launches"].items():
                launches[k] = launches.get(k, 0) + v
    row = dict(world=world, backend=backend, frames=n_frames, prep_s=prep_s, wall_s=wall_s,
               launches=launches, sparse_dense=out[0]["sparse_dense"],
               rows=[{k: v for k, v in j.items() if k != "digest"} for j in rows0],
               ranks=[[dict(map_ms=j["map_ms"], collective_ms=j["collective_ms"])
                       for j in o["rows"]] for o in out])
    print(f"  distributed ({form}): {world} rank(s), {backend}, {n_frames} frames, "
          f"survey pickled in {prep_s:.1f} s, ranks ran {wall_s:.1f} s (layout pinned in "
          f"{max(o['pin_s'] for o in out):.2f} s); launches {launches}; "
          f"every rank bitwise rank 0; sparse vs dense {out[0]['sparse_dense']}", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-runs", type=int, default=8,
                    help="survey epochs of the main path (8 = the reference geometry)")
    ap.add_argument("--reps", type=int, default=5, help="warm repeats per timing")
    ap.add_argument("--mosaic-only", action="store_true",
                    help="only time the brick mosaic on random tiles and exit (mosaic_only)")
    ap.add_argument("--distributed-only", action="store_true",
                    help="only run phase 4 distributed on the main survey and exit")
    ap.add_argument("--lm-only", action="store_true",
                    help="only hold the LM kernels (phase 3 lm kernels), run phases 4 lm "
                         "families and 4 lm training, time the families' kernel shapes and "
                         "the flash backward, and exit")
    ap.add_argument("--train-only", action="store_true",
                    help="only hold the flash backward kernels, run phase 4 lm training and "
                         "time the backward kernels, and exit")
    ap.add_argument("--crash-child", metavar="DIR",
                    help="the SIGKILL drill's subprocess (crash_child); not for direct use")
    ap.add_argument("--crash", metavar="STAGE:N", help="with --crash-child: SIGKILL there")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.crash_child:
        return crash_child(args.crash_child, args.crash)
    if args.mosaic_only:
        print(card_line())
        mosaic_only(torch, np, torch.device(DEVICE))
        return 0
    if args.distributed_only:
        from repro_torch import CoaddQuery, SurveyConfig, make_survey
        from repro_torch.kernels import build

        print(card_line())
        build.build_all()
        survey = make_survey(SurveyConfig(**dict(CRASH_CFG, n_runs=args.n_runs)),
                             processes=os.cpu_count() or 1)
        with phase("4 distributed"):
            print(json.dumps({"distributed": distributed_phase(
                torch, np, survey, CoaddQuery(**MAIN_QUERY),
                offset_queries(CoaddQuery, MAIN_QUERY, BATCH_OFFSETS), os.cpu_count() or 1)}))
        return 0

    import torch.nn.functional as F

    if args.lm_only:
        return lm_only(torch, np, F, args.reps)
    if args.train_only:
        return train_only(torch, np, F, args.reps)

    from repro_torch import (CoaddEngine, CoaddQuery, METHODS, SurveyConfig, detect_sources,
                             difference_image, inject_transients, make_survey,
                             match_detections)
    from repro_torch.core import mapper, psf, reducer
    from repro_torch.core.detect import sky_to_grid
    from repro_torch.core.geometry import sky_to_pixel
    from repro_torch.core.seqfile import finite_slots, pack_structured
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.attention.ref import flash_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.warp import ops as warp_ops
    from repro_torch.kernels.warp import ref
    from repro_torch.launch.serve import DrillShape, drill_failures, drill_queries, run_service

    dev = torch.device(DEVICE)
    procs = os.cpu_count() or 1
    counted = {"coadd_fused": warp_ops.coadd_fused, "warp_project": warp_ops.warp_batch,
               "coadd_moments": warp_ops.coadd_moments, "coadd_hist": warp_ops.coadd_hist,
               "coadd_clip": warp_ops.coadd_clip, "psf_match_sep": warp_ops.psf_match_sep,
               "psf_match_2d": warp_ops.psf_match_2d, "mosaic_bricks": warp_ops.mosaic_bricks,
               "flash_attention_single": flash_ops.flash_attention,
               "ssd_chunked": ssd_ops.ssd_log,
               "coadd_fused_batch": warp_ops.coadd_fused_batch,
               "coadd_moments_batch": warp_ops.coadd_moments_batch,
               "coadd_hist_batch": warp_ops.coadd_hist_batch,
               "coadd_clip_batch": warp_ops.coadd_clip_batch}

    # ------------------------------------------------------------ 1 card --
    with phase("1 card"):
        smi = card_line()
        print(smi)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # ----------------------------------------------------------- 2 build --
    with phase("2 build"):
        logs = build.build_all()
        for name, log in logs.items():
            for line in log.splitlines():
                if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
                    print(f"  [{name}] {line.strip()}")
        for name in ("warp", "psf", "mosaic", "flash", "ssd"):
            print(f"  loaded {build.library_path(name).relative_to(ROOT)}")
            build.library(name)

    # --------------------------------------------------------- 3 kernels --
    edge_flips = []       # (case, kernel, image or -1, row, col)
    decision_flips = []   # (case, kernel, row, col)

    def hold(case, kernel, out, cov, out_p, cov_p, h, w, wcs, acc, gra, gdec):
        """Hold a kernel's (value, coverage) against the plain version's."""
        near, far = ref.coverage_flips(cov, cov_p, h, w, wcs, acc, gra, gdec)
        require(not far.any(), f"{case}/{kernel}: {int(far.sum())} coverage pixels "
                               "differ away from every image edge")
        max_err = hold_values(case, kernel, out, out_p, near)
        for p in near.nonzero().tolist():
            edge_flips.append((case, kernel) + tuple(p))
        return max_err, int(near.sum())

    def hold_values(case, kernel, out, out_p, near):
        """Values at the kernel tolerance, off the ``near`` pixels."""
        keep = ~near
        err = (out - out_p).abs()
        ok = err <= COADD_ATOL + COADD_RTOL * out_p.abs()
        max_err = float(err[keep].max()) if keep.any() else 0.0
        require(bool(ok[keep].all()), f"{case}/{kernel}: values outside atol {COADD_ATOL} "
                                      f"rtol {COADD_RTOL}: max {max_err}")
        require(bool(torch.isfinite(out).all()), f"{case}/{kernel}: non-finite output")
        return max_err

    def hold_decisions(case, kernel, diff, scan, **boundaries):
        """Differing pixels must sit at an image edge or a decision boundary."""
        near, far = ref.decision_flips(diff, *scan, **boundaries)
        require(not far.any(), f"{case}/{kernel}: {int(far.sum())} pixels differ away from "
                               "every image edge and decision boundary")
        for p in near.nonzero().tolist():
            decision_flips.append((case, kernel) + tuple(p))
        return near

    def unculled(name, scan, *fixed, nbins=0):
        """The unculled pack scan (``pack_scan_unculled_f32``) on a culled
        wrapper's operands -> its outputs, as the wrapper returns them.  The
        check form: no wrapper launches it and it counts no launch."""
        pixels, _, idx, _, gra, _ = scan
        q = gra.shape[0]
        n_out = {"coadd_fused": 2, "coadd_moments": 3, "coadd_clip": 2, "coadd_hist": 1}[name]
        shape = (nbins, q, q) if name == "coadd_hist" else (q, q)
        outs = [torch.empty(shape, device=dev) for _ in range(n_out)]
        ptrs = [t.data_ptr() for t in scan]
        ins = [t.data_ptr() for t in fixed] + [None] * (2 - len(fixed))
        outp = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
        err = build.library("warp").pack_scan_unculled_f32(
            SCAN_KIND[name], nbins, *ptrs, *ins, *outp, idx.shape[0], *pixels.shape[1:], q,
            torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"pack_scan_unculled_f32 ({name}): CUDA error {err}")
        return outs[0] if name == "coadd_hist" else tuple(outs)

    def scan_alone(name, scan, finite, *fixed, nbins=0):
        """The culled pass ``name`` launched alone through ``pack_scan_f32``
        on a wrapper's operands (a (K, G, cap) accept: K queries) -> (launch,
        outputs): ``launch()`` runs it into ``outputs``, without the
        wrappers' checks (their pack-index check syncs the host) and without
        counting a launch."""
        pixels, _, idx, acc, gra, _ = scan
        n_q = acc.shape[0] if acc.dim() == 3 else 1
        q = gra.shape[-1]
        n_out = {"coadd_fused": 2, "coadd_moments": 3, "coadd_clip": 2, "coadd_hist": 1}[name]
        lead = (n_q,) if acc.dim() == 3 else ()
        shape = lead + ((nbins, q, q) if name == "coadd_hist" else (q, q))
        outs = [torch.empty(shape, device=dev) for _ in range(n_out)]
        ptrs = ([t.data_ptr() for t in scan[:4]] + [None if finite is None else finite.data_ptr()]
                + [t.data_ptr() for t in scan[4:]]
                + [t.data_ptr() for t in fixed] + [None] * (2 - len(fixed))
                + [t.data_ptr() for t in outs] + [None] * (3 - len(outs)))
        lib = build.library("warp")

        def launch():
            err = lib.pack_scan_f32(SCAN_KIND[name], nbins, *ptrs, n_q, idx.shape[0],
                                    *pixels.shape[1:], q, torch.cuda.current_device(),
                                    torch.cuda.current_stream().cuda_stream)
            require(err == 0, f"pack_scan_f32 ({name}) alone: CUDA error {err}")

        return launch, outs

    def alone_ms(name, scan, finite, *fixed, nbins=0, want=None):
        """``scan_alone``'s time over ``--reps`` launches; its outputs bitwise
        ``want`` (the wrapper's) when given."""
        launch, outs = scan_alone(name, scan, finite, *fixed, nbins=nbins)
        ms = cuda_ms(torch, launch, args.reps)
        if want is not None:
            torch.cuda.synchronize()
            require(sum(words_differ(a, b) for a, b in zip(outs, want)) == 0,
                    f"{name} launched alone differs from its wrapper")
        return ms

    def words_differ(a, b):
        """How many float32 words of two outputs differ, NaN payloads too."""
        return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())

    cull_checks = {"passes": 0, "differing_words": 0}

    def cull_check(case, scan, finite, outputs=None):
        """Every culled pass (the counted wrappers, given the slot flag) against
        the unculled kernel on the same operands, bitwise: coadd_fused,
        coadd_moments, coadd_hist at 8, 16 and 32 bins and coadd_clip about
        the clipped mean and the binapprox median, on the fixed operands the
        culled moments give.  -> the culled moments; each pass's culled
        outputs are appended to the list ``outputs`` when one is given."""
        rows = []
        rows.append(("coadd_fused", warp_ops.coadd_fused(*scan, finite=finite),
                     unculled("coadd_fused", scan)))
        mom = warp_ops.coadd_moments(*scan, finite=finite)
        rows.append(("coadd_moments", mom, unculled("coadd_moments", scan)))
        mu, sigma = reducer.clip_stats(*mom)
        for nbins in warp_ops.HIST_BINS:
            lo, bw, inv_w = reducer.hist_bounds(*mom, nbins)
            hist = warp_ops.coadd_hist(*scan, lo, inv_w, nbins, finite=finite)
            rows.append((f"coadd_hist[{nbins}]", (hist,),
                         (unculled("coadd_hist", scan, lo, inv_w, nbins=nbins),)))
            if nbins == NBINS:
                median = reducer.hist_median(hist, mom[0], lo, bw)
        for red, center in (("clipped", mu), ("median", median)):
            thresh = reducer.clip_threshold(center, sigma, CLIP_K)
            rows.append((f"coadd_clip[{red}]", warp_ops.coadd_clip(*scan, center, thresh,
                                                                   finite=finite),
                         unculled("coadd_clip", scan, center, thresh)))
        torch.cuda.synchronize()
        for name, got, want in rows:
            n = sum(words_differ(a, b) for a, b in zip(got, want))
            cull_checks["passes"] += 1
            cull_checks["differing_words"] += n
            require(n == 0, f"{case}/{name}: the culled kernel differs from the unculled one "
                            f"at {n} words")
            if outputs is not None:
                outputs.append((name, got))
        return mom

    gate_checks = {"scratches": 0, "passes": 0, "differing_words": 0}

    def gate_check(case, pixels, wcs, idx, acc, gra, gdec, bank, finite):
        """The PSF pre-pass gated as the engine runs it (``ops.matched_packs``
        given the accept and the flag) against the ungated one: zeros exactly
        at the skipped slots, the same words elsewhere; every culled pass
        over either scratch bitwise the unculled kernel, and the passes over
        the two bitwise each other, NaN words included -> (slots matched,
        slots skipped)."""
        flag = warp_ops.matched_finite(finite, idx, bank)
        skip = warp_ops.prepass_skip(acc, flag)
        gated = warp_ops.matched_packs(pixels, wcs, idx, bank, acc, flag)
        ungated = warp_ops.matched_packs(pixels, wcs, idx, bank)
        torch.cuda.synchronize()
        off = skip != 0
        require(not gated[0][off].any() and not torch.signbit(gated[0][off]).any()
                and words_differ(gated[0][~off], ungated[0][~off]) == 0,
                f"{case}: the gated pre-pass is not zeros at the skipped slots and the ungated "
                "one elsewhere")
        outs = []
        for what, scratch in (("gated", gated), ("ungated", ungated)):
            outs.append([])
            cull_check(f"{case} ({what} scratch)", scratch + (acc, gra, gdec), flag, outs[-1])
        for (name, a), (_, b) in zip(*outs):
            n = sum(words_differ(x, y) for x, y in zip(a, b))
            gate_checks["passes"] += 1
            gate_checks["differing_words"] += n
            require(n == 0, f"{case}/{name}: the pass over the gated scratch differs from the "
                            f"ungated at {n} words")
        gate_checks["scratches"] += 1
        n_skip = int(off.sum())
        return off.numel() - n_skip, n_skip

    batch_checks = {"cases": 0, "passes": 0, "differing_words": 0}
    batch_fns = (warp_ops.coadd_fused_batch, warp_ops.coadd_moments_batch,
                 warp_ops.coadd_hist_batch, warp_ops.coadd_clip_batch)
    single_fns = (warp_ops.coadd_fused, warp_ops.coadd_moments, warp_ops.coadd_hist,
                  warp_ops.coadd_clip)

    def batch_passes(fns, scan, finite, fixed, k=None):
        """Every pass through ``fns`` (the batched wrappers, or the one-query
        ones with ``k``, query k's fixed operands) -> [(name, outputs)]:
        fused, moments, hist at each bin count, clip about each centre.
        ``fixed`` = (bins {nbins: (lo, bw, inv_w)}, centres, radii)."""
        bins, centers, threshs = fixed
        pick = (lambda t: t) if k is None else (lambda t: t[k])
        fused, moments, hist, clip = fns
        out = [("coadd_fused", fused(*scan, finite=finite)),
               ("coadd_moments", moments(*scan, finite=finite))]
        for nb, (lo, _, inv_w) in bins.items():
            out.append((f"coadd_hist[{nb}]", (hist(*scan, pick(lo), pick(inv_w), nb,
                                                   finite=finite),)))
        for red in centers:
            out.append((f"coadd_clip[{red}]", clip(*scan, pick(centers[red]), pick(threshs[red]),
                                                   finite=finite)))
        return out

    def batch_vs_singles(case, scan, finite, fixed):
        """Each query of every batched pass against its one-query launch on
        the same operands, every word (NaN payloads too) -> batched outputs."""
        got = batch_passes(batch_fns, scan, finite, fixed)
        pixels, wcs, idx, acc, gra, gdec = scan
        for k in range(acc.shape[0]):
            want = batch_passes(single_fns, (pixels, wcs, idx, acc[k], gra[k], gdec[k]), finite,
                                fixed, k)
            torch.cuda.synchronize()
            for (name, a), (_, b) in zip(got, want):
                n = sum(words_differ(x[k], y) for x, y in zip(a, b))
                batch_checks["passes"] += 1
                batch_checks["differing_words"] += n
                require(n == 0, f"{case}/{name} batched (flag {finite is not None}): query {k} "
                                f"differs from its one-query launch at {n} words")
        return dict(got)

    def batch_case(case, scan, finite):
        """The batched kernels of one (K, G, cap) accept: against the one-query
        launches bitwise, with and without the slot flag; then against their
        plain versions (``ref.*_batch_ref``) query by query at the phase-3
        tolerances, on fixed operands from the plain moments."""
        pixels, wcs, idx, acc, gra, gdec = scan
        h, w = pixels.shape[-2:]
        s_p = ref.moments_scan_batch_ref(*scan)
        mu, sigma = reducer.clip_stats(*s_p)
        bins = {nb: reducer.hist_bounds(*s_p, nb) for nb in warp_ops.HIST_BINS}
        h_p = {nb: ref.hist_scan_batch_ref(*scan, lo, inv_w, nb)
               for nb, (lo, _, inv_w) in bins.items()}
        centers = {"clipped": mu, "median": reducer.hist_median(h_p[NBINS], s_p[0],
                                                                *bins[NBINS][:2])}
        threshs = {red: reducer.clip_threshold(c, sigma, CLIP_K) for red, c in centers.items()}
        fixed = (bins, centers, threshs)
        batch_vs_singles(case, scan, finite, fixed)
        got = batch_vs_singles(case, scan, None, fixed)
        c_p, d_p = ref.coadd_scan_batch_ref(*scan)
        clip_p = {red: ref.clip_scan_batch_ref(*scan, centers[red], threshs[red])
                  for red in centers}
        torch.cuda.synchronize()
        flat_wcs = wcs[idx.long()].reshape(-1, 8)
        for k in range(acc.shape[0]):
            dscan = (pixels, wcs, idx, acc[k], gra[k], gdec[k])
            c_k, d_k = (t[k] for t in got["coadd_fused"])
            e, n = hold(case, "coadd_fused_batch", c_k, d_k, c_p[k], d_p[k], h, w, flat_wcs,
                        acc[k].reshape(-1), gra[k], gdec[k])
            note_batch("coadd_fused_batch", e, n)
            s_k = got["coadd_moments"]
            near = hold_decisions(case, "coadd_moments_batch", s_k[0][k] != s_p[0][k], dscan)
            note_batch("coadd_moments_batch",
                       max(hold_values(case, "coadd_moments_batch", a[k], b[k], near)
                           for a, b in zip(s_k, s_p)), int(near.sum()))
            for nb, (lo, bw, inv_w) in bins.items():
                (h_k,) = got[f"coadd_hist[{nb}]"]
                near = hold_decisions(case, f"coadd_hist_batch[{nb}]",
                                      (h_k[k] != h_p[nb][k]).any(0), dscan,
                                      bins=(lo[k], bw[k], inv_w[k], nb))
                require(torch.equal(h_k[k].sum(0), s_k[0][k]),
                        f"{case}/coadd_hist_batch[{nb}]: query {k}'s bins do not sum to S0")
                note_batch("coadd_hist_batch", float((h_k[k] - h_p[nb][k]).abs().max()),
                           int(near.sum()))
            for red in centers:
                cb, db = (t[k] for t in got[f"coadd_clip[{red}]"])
                cp, dp = (t[k] for t in clip_p[red])
                diff = (db != dp) | ((cb - cp).abs() > COADD_ATOL + COADD_RTOL * cp.abs())
                near = hold_decisions(case, f"coadd_clip_batch[{red}]", diff, dscan,
                                      clip=(centers[red][k], threshs[red][k]))
                note_batch("coadd_clip_batch",
                           hold_values(case, f"coadd_clip_batch[{red}]", cb, cp, near),
                           int(near.sum()))
        batch_checks["cases"] += 1
        return got

    warp_checks = {"calls": 0, "differing_words": 0, "pairs": 0, "pairs_sampled": 0}

    def warp_unculled(px, wv, a, gra, gdec):
        """The unculled warp_project (``warp_project_unculled_f32``) on the
        wrapper's operands -> (tile, cov).  The check form: no wrapper
        launches it and it counts no launch."""
        n, h, w = px.shape
        q = gra.shape[0]
        outs = [torch.empty((n, q, q), device=dev) for _ in range(2)]
        err = build.library("warp").warp_project_unculled_f32(
            *(t.data_ptr() for t in (px, wv, a, gra, gdec, *outs)), n, h, w, q,
            torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"warp_project_unculled_f32: CUDA error {err}")
        return tuple(outs)

    def warp_check(case, px, wv, a, gra, gdec):
        """warp_project (the counted wrapper, culled) against its check form,
        every word -> (tile, cov); counts the (tile, image) pairs the plain
        twin of the footprint test keeps (``ref.footprint_keep``)."""
        got = warp_ops.warp_batch(px, wv, a, gra, gdec)
        want = warp_unculled(px, wv, a, gra, gdec)
        torch.cuda.synchronize()
        n = sum(words_differ(x, y) for x, y in zip(got, want))
        warp_checks["calls"] += 1
        warp_checks["differing_words"] += n
        require(n == 0, f"{case}/warp_project: the culled kernel differs from the unculled one "
                        f"at {n} words")
        keep = ref.footprint_keep(wv, a, None, gra, gdec, *px.shape[1:])
        warp_checks["pairs"] += keep.numel()
        warp_checks["pairs_sampled"] += int(keep.sum())
        return got

    def cull_counts(scan, finite):
        """What the culled kernel skips on one pass, by the plain twin of its
        footprint test (``ref.footprint_keep``) -> dict."""
        pixels, wcs, idx, acc, gra, gdec = scan
        h, w = pixels.shape[-2:]
        q = gra.shape[0]
        rows = idx.long()
        flat_wcs, flat_acc = wcs[rows].reshape(-1, 8), acc.reshape(-1)
        flat_fin = None if finite is None else finite[rows].reshape(-1) != 0
        ny, nx = -(-q // ref.TILE_Y), -(-q // ref.TILE_X)
        live = torch.zeros((ny * ref.TILE_Y, nx * ref.TILE_X), device=dev)
        live[:q, :q] = 1.0
        live = live.reshape(ny, ref.TILE_Y, nx, ref.TILE_X).sum((1, 3))
        pairs = samples = 0
        for s0 in range(0, flat_wcs.shape[0], 256):
            keep = ref.footprint_keep(flat_wcs[s0:s0 + 256], flat_acc[s0:s0 + 256],
                                      None if flat_fin is None else flat_fin[s0:s0 + 256],
                                      gra, gdec, h, w)
            pairs += int(keep.sum())
            samples += int((keep * live[..., None]).sum())
        n = flat_wcs.shape[0]
        return dict(slots=n, accepted=int((flat_acc != 0).sum()),
                    rejected_skipped=0 if flat_fin is None else int(((flat_acc == 0)
                                                                     & flat_fin).sum()),
                    pairs=pairs, pairs_scanned=n * ny * nx, samples=samples,
                    samples_scanned=n * q * q)

    def print_counts(what, c, depth_sum):
        print(f"  {what}: {c['slots']} slots ({c['accepted']} accepted, "
              f"{c['rejected_skipped']} rejected and skipped); (tile, slot) pairs sampled "
              f"{c['pairs']} of {c['pairs_scanned']}; samples {c['samples']} of "
              f"{c['samples_scanned']} ({100.0 * c['samples'] / c['samples_scanned']:.2f} %), "
              f"skipped {c['samples_scanned'] - c['samples']}; contributing {depth_sum:.0f}",
              flush=True)

    def robust_kernels(case, scan, bank=None, dscan=None):
        """coadd_moments, coadd_hist and coadd_clip (both centres) against their
        plain versions, on the plain version's fixed operands.

        With a PSF ``bank`` both sides match the frames first
        (``psf_kernels=``); ``dscan`` is then the matched scan, whose samples
        place the decision boundaries.
        """
        kw = {} if bank is None else {"psf_kernels": bank}
        dscan = scan if dscan is None else dscan
        errs, flips = {}, {}
        s_k = warp_ops.coadd_moments(*scan, **kw)
        s_p = ref.moments_scan_ref(*scan, **kw)
        torch.cuda.synchronize()
        near = hold_decisions(case, "coadd_moments", s_k[0] != s_p[0], dscan)
        errs["coadd_moments"] = max(hold_values(case, "coadd_moments", a, b, near)
                                    for a, b in zip(s_k, s_p))
        flips["coadd_moments"] = int(near.sum())
        mu, sigma = reducer.clip_stats(*s_p)
        errs["coadd_hist"], flips["coadd_hist"] = 0.0, 0
        for nbins in warp_ops.HIST_BINS:   # every bin count the kernel is built for
            lo, bw, inv_w = reducer.hist_bounds(*s_p, nbins)
            h_k = warp_ops.coadd_hist(*scan, lo, inv_w, nbins, **kw)
            h_p = ref.hist_scan_ref(*scan, lo, inv_w, nbins, **kw)
            torch.cuda.synchronize()
            near = hold_decisions(case, f"coadd_hist[{nbins}]", (h_k != h_p).any(0), dscan,
                                  bins=(lo, bw, inv_w, nbins))
            # With 0/1 accept and coverage every sample lands in exactly one bin.
            require(torch.equal(h_k.sum(0), s_k[0]),
                    f"{case}/coadd_hist[{nbins}]: bins do not sum to S0")
            errs["coadd_hist"] = max(errs["coadd_hist"], float((h_k - h_p).abs().max()))
            flips["coadd_hist"] += int(near.sum())
            if nbins == NBINS:
                median = reducer.hist_median(h_p, s_p[0], lo, bw)
                h_default = h_k
        centers = {"clipped": mu, "median": median}
        clipped = {}
        errs["coadd_clip"], flips["coadd_clip"] = 0.0, 0
        for red, center in centers.items():
            thresh = reducer.clip_threshold(center, sigma, CLIP_K)
            c_k, d_k = warp_ops.coadd_clip(*scan, center, thresh, **kw)
            c_p, d_p = ref.clip_scan_ref(*scan, center, thresh, **kw)
            torch.cuda.synchronize()
            diff = (d_k != d_p) | ((c_k - c_p).abs() > COADD_ATOL + COADD_RTOL * c_p.abs())
            near = hold_decisions(case, f"coadd_clip[{red}]", diff, dscan, clip=(center, thresh))
            errs["coadd_clip"] = max(errs["coadd_clip"],
                                     hold_values(case, f"coadd_clip[{red}]", c_k, c_p, near))
            flips["coadd_clip"] += int(near.sum())
            clipped[red] = (c_k, d_k)
        return errs, flips, s_k, h_default, clipped

    def kernel_case(case, ds, qry, accept, pack_idx, pixels=None):
        """Run every kernel and its plain version on one set of operands."""
        t0 = time.perf_counter()
        pixels = torch.from_numpy(ds.pixels).to(dev) if pixels is None else pixels
        wcs = torch.from_numpy(ds.wcs).to(dev)
        gra, gdec = (torch.from_numpy(a).to(dev) for a in mapper.query_grid_sky(qry))
        idx = torch.tensor(pack_idx, dtype=torch.int32, device=dev)
        acc = torch.from_numpy(np.asarray(accept, np.float32)).to(dev)
        _, cap, h, w = pixels.shape
        rows = idx.long()
        flat_wcs = wcs[rows].reshape(-1, 8)
        flat_acc = acc.reshape(-1)
        c_k, d_k = warp_ops.coadd_fused(pixels, wcs, idx, acc, gra, gdec)
        c_p, d_p = ref.coadd_scan_ref(pixels, wcs, idx, acc, gra, gdec)
        torch.cuda.synchronize()
        errs, flips = {}, {}
        errs["coadd_fused"], flips["coadd_fused"] = hold(
            case, "coadd_fused", c_k, d_k, c_p, d_p, h, w, flat_wcs, flat_acc, gra, gdec)
        # warp_project over the first scanned pack's slots.
        px0 = pixels[rows[0]]
        t_k, v_k = warp_ops.warp_batch(px0, wcs[rows[0]], acc[0], gra, gdec)
        t_p, v_p = ref.warp_batch_ref(px0, wcs[rows[0]], acc[0], gra, gdec)
        torch.cuda.synchronize()
        errs["warp_project"], flips["warp_project"] = 0.0, 0
        for i in range(cap):
            e, n = hold(case, f"warp_project[{i}]", t_k[i], v_k[i], t_p[i], v_p[i], h, w,
                        wcs[rows[0], i:i + 1], acc[0, i:i + 1], gra, gdec)
            errs["warp_project"] = max(errs["warp_project"], e)
            flips["warp_project"] += n
        warp_check(case, px0, wcs[rows[0]], acc[0], gra, gdec)
        scan = (pixels, wcs, idx, acc, gra, gdec)
        r_errs, r_flips, s_k, h_k, clipped = robust_kernels(case, scan)
        errs.update(r_errs)
        flips.update(r_flips)
        if not float(acc.abs().sum()):
            outs = [c_k, d_k, t_k, v_k, *s_k, h_k] + [t for pair in clipped.values() for t in pair]
            require(not any(bool(t.any()) for t in outs),
                    f"{case}: an empty gate must give exact zeros")
        cull_check(case, scan, finite_slots(pixels))
        print(f"  {case:16s} P,cap,H,W={tuple(pixels.shape)} G={len(pack_idx)} "
              f"Q={qry.npix} accepted={int((acc != 0).sum())} depth_max={float(d_k.max()):.0f} "
              f"| max_err {', '.join(f'{k}={v:.3g}' for k, v in errs.items())} "
              f"| flips {flips} | {time.perf_counter() - t0:.1f} s", flush=True)
        return errs, flips, (pixels, wcs, idx, acc, gra, gdec), s_k, clipped

    case_err = {k: 0.0 for k in KERNELS}
    case_flips = {k: 0 for k in KERNELS}

    def note_batch(kernel, err, flips):
        case_err[kernel] = max(case_err[kernel], err)
        case_flips[kernel] += flips

    def run_case(*case, kernel_case=kernel_case):
        errs, flips, *rest = kernel_case(*case)
        for k in errs:
            case_err[k] = max(case_err[k], errs[k])
            case_flips[k] += flips.get(k, 0)
        return rest

    def psf_match_case(case, pixels, pack_idx, bank):
        """psf_match (either rank) against its plain version, bitwise, then
        gated by a random ``skip``: zeros there, the same words elsewhere
        -> (counted kernel's name, max error, the plain output)."""
        idx = torch.tensor(pack_idx, dtype=torch.int32, device=dev)
        name = "psf_match_2d" if bank.dim() == 4 else "psf_match_sep"
        m_k = warp_ops.psf_match(pixels, idx, bank)
        m_p = ref.psf_match_ref(pixels, idx, bank)
        torch.cuda.synchronize()
        err = hold_values(case, name, m_k, m_p, torch.zeros_like(m_k, dtype=torch.bool))
        require(torch.equal(m_k, m_p), f"{case}/{name}: not bitwise its plain version "
                                       f"(max |diff| {err:.3g})")
        skip = torch.from_numpy((np.random.default_rng(len(case)).random(m_k.shape[:2]) < 0.5)
                                .astype(np.uint8)).to(dev)
        m_g = warp_ops.psf_match(pixels, idx, bank, skip)
        m_gp = ref.psf_match_ref(pixels, idx, bank, skip)
        torch.cuda.synchronize()
        require(words_differ(m_g, m_gp) == 0 and torch.equal(m_g[skip == 0], m_k[skip == 0]),
                f"{case}/{name}: gated, not its plain version or not zeros where skipped")
        return name, err, m_p

    def psf_case(case, ds, qry, accept, pack_idx, bank):
        """The PSF-matching kernel, then coadd_fused and the robust passes
        composed with it (``psf_kernels=``), against their plain versions."""
        t0 = time.perf_counter()
        pixels = torch.from_numpy(ds.pixels).to(dev)
        wcs = torch.from_numpy(ds.wcs).to(dev)
        gra, gdec = (torch.from_numpy(a).to(dev) for a in mapper.query_grid_sky(qry))
        idx = torch.tensor(pack_idx, dtype=torch.int32, device=dev)
        acc = torch.from_numpy(np.asarray(accept, np.float32)).to(dev)
        h, w = pixels.shape[-2:]
        rows = idx.long()
        name, m_err, matched = psf_match_case(case, pixels, pack_idx, bank)
        errs, flips = {name: m_err}, {}
        scan = (pixels, wcs, idx, acc, gra, gdec)
        c_k, d_k = warp_ops.coadd_fused(*scan, psf_kernels=bank)
        c_p, d_p = ref.coadd_scan_ref(*scan, psf_kernels=bank)
        _, d_u = warp_ops.coadd_fused(*scan)
        torch.cuda.synchronize()
        require(torch.equal(d_k, d_u), f"{case}: PSF-matched depth differs from unmatched")
        errs["coadd_fused"], flips["coadd_fused"] = hold(
            case, "coadd_fused+psf", c_k, d_k, c_p, d_p, h, w, wcs[rows].reshape(-1, 8),
            acc.reshape(-1), gra, gdec)
        dscan = (matched, wcs[rows], torch.arange(len(pack_idx), dtype=torch.int32, device=dev),
                 acc, gra, gdec)
        r_errs, r_flips, *_ = robust_kernels(case, scan, bank, dscan)
        errs.update(r_errs)
        flips.update(r_flips)
        # The culled passes over the kernel's own scratch, gated as the engine
        # runs it and ungated.
        gate_check(case, pixels, wcs, idx, acc, gra, gdec, bank, finite_slots(pixels))
        print(f"  {case:16s} P,cap,H,W={tuple(pixels.shape)} bank={tuple(bank.shape[2:])} "
              f"G={len(pack_idx)} Q={qry.npix} | max_err "
              f"{', '.join(f'{k}={v:.3g}' for k, v in errs.items())} | flips {flips} "
              f"| {time.perf_counter() - t0:.1f} s", flush=True)
        return errs, flips

    with phase("3 kernels"):
        rng = np.random.default_rng(0)
        # 64 frames of the main path's 512 x 512 size in one structured pack.
        # Sources are thinned to the main survey's density: rendering holds
        # one float64 frame per source in a frame.
        t0 = time.perf_counter()
        sv = make_survey(SurveyConfig(n_runs=8, n_camcols=1, n_bands=1, n_fields=8,
                                      height=512, width=512, n_sources=70, seed=82),
                         processes=procs)
        ds = pack_structured(sv, 64)
        ones = ds.valid.astype(np.float32)
        q_main = CoaddQuery(band="u", ra_bounds=(37.5, 38.5), dec_bounds=(-0.5, 0.5),
                            npix=1024)
        cases = [
            ("main_shapes", ds, q_main, ones, [0]),
            ("npix_997", ds, CoaddQuery(band="u", ra_bounds=(37.2, 38.7),
                                        dec_bounds=(-0.3, 0.3), npix=997), ones, [0]),
            ("rejected_slots", ds, CoaddQuery(band="u", ra_bounds=(37.5, 38.5),
                                              dec_bounds=(-0.3, 0.3), npix=256),
             ones * (rng.random(ones.shape) < 0.5), [0]),
            ("outside_grid", ds, CoaddQuery(band="u", ra_bounds=(36.4, 37.3),
                                            dec_bounds=(-0.2, 0.7), npix=128), ones, [0]),
            ("padded_sparse", ds, q_main, np.concatenate([ones, 0 * ones]), [0, 0]),
            ("empty_gate", ds, q_main, 0 * ones, [0]),
        ]
        # H != W, as SDSS frames are (1489 x 2048).
        sv_wide = make_survey(SurveyConfig(n_runs=2, n_camcols=1, n_bands=1, n_fields=2,
                                           height=1489, width=2048, n_sources=20, seed=82),
                              processes=procs)
        print(f"  rendered the case frames in {time.perf_counter() - t0:.1f} s", flush=True)
        ds_wide = pack_structured(sv_wide, 4)
        q_wide = CoaddQuery(band="u", ra_bounds=(37.0, 37.5), dec_bounds=(-0.25, 0.25),
                            npix=512)
        wide_ones = ds_wide.valid.astype(np.float32)
        cases.append(("h1489_w2048", ds_wide, q_wide, wide_ones, [0]))
        # Flat offsets past the int32 range: the frames sit in the last pack
        # of a (P, 4, 1489, 2048) layout of 2.2e9 floats.
        n_big = FLAT_OFFSET_LIMIT // ds_wide.pixels[0].size + 2
        big = torch.zeros((n_big,) + ds_wide.pixels.shape[1:], dtype=torch.float32,
                          device=dev)
        big[-1] = torch.from_numpy(ds_wide.pixels[0]).to(dev)
        require(big.numel() > FLAT_OFFSET_LIMIT, "offsets_64bit: layout too small")
        big_ds = type(ds_wide)(**{**ds_wide.__dict__, "wcs": np.repeat(ds_wide.wcs, n_big, 0)})
        cases.append(("offsets_64bit", big_ds, q_wide, wide_ones, [n_big - 1], big))
        for case in cases:
            run_case(*case)

        # Rejected slots poisoned inside the query footprint with a NaN, an
        # inf and a 2**70 pixel.  Their flag is clear, so the culled kernels
        # sample them as the unculled one does: the same bits, NaN included.
        gra_m, gdec_m = (torch.from_numpy(a).to(dev) for a in mapper.query_grid_sky(q_main))
        poison, acc_p, planted = ds.pixels[:1].copy(), ones[:1].copy(), []
        h0, w0 = ds.pixels.shape[-2:]
        for slot in range(ds.pixels.shape[1]):
            sx, sy = sky_to_pixel(gra_m, gdec_m, torch.from_numpy(ds.wcs[0, slot]).to(dev))
            inside = ((sx >= 0) & (sx <= w0 - 1) & (sy >= 0) & (sy <= h0 - 1)).nonzero()
            if len(inside) and len(planted) < 3:
                at = inside[len(inside) // 2]
                y, x = int(torch.floor(sy[tuple(at)])), int(torch.floor(sx[tuple(at)]))
                poison[0, slot, y, x] = (np.nan, np.inf, np.float32(2.0 ** 70))[len(planted)]
                acc_p[0, slot] = 0.0
                planted.append((slot, y, x))
        require(len(planted) == 3, "poisoned_rejected: three slots must cover the query")
        pix_p = torch.from_numpy(poison).to(dev)
        scan_p = (pix_p, torch.from_numpy(ds.wcs[:1]).to(dev),
                  torch.zeros(1, dtype=torch.int32, device=dev), torch.from_numpy(acc_p).to(dev),
                  gra_m, gdec_m)
        fin_p = finite_slots(pix_p)
        require(not any(int(fin_p[0, k]) for k, _, _ in planted)
                and int(fin_p.sum()) == fin_p.numel() - 3, "poisoned_rejected: slot flags")
        mom_p = cull_check("poisoned_rejected", scan_p, fin_p)
        c_pk, _ = warp_ops.coadd_fused(*scan_p, finite=fin_p)
        c_pp, _ = ref.coadd_scan_ref(*scan_p)
        mom_pp = ref.moments_scan_ref(*scan_p)
        torch.cuda.synchronize()
        print(f"  poisoned_rejected: NaN, inf, 2**70 at (slot, y, x) {planted}, accept 0: culled "
              f"bitwise the unculled kernel; NaN pixels kernel / plain: coadd "
              f"{int(c_pk.isnan().sum())} / {int(c_pp.isnan().sum())}, S1 "
              f"{int(mom_p[1].isnan().sum())} / {int(mom_pp[1].isnan().sum())}, S2 "
              f"{int(mom_p[2].isnan().sum())} / {int(mom_pp[2].isnan().sum())}", flush=True)
        del poison

        # Culling where the survey's patch does not reach: frames scattered
        # over grids at dec +-60 and +-80 and across RA 0/360
        # (ref.scattered_frames), every accumulator culled vs unculled, bitwise.
        rng_w = np.random.default_rng(17)
        for ra_c, dec_c in ((117.0, 60.0), (250.0, -60.0), (45.0, 80.0), (300.0, -80.0),
                            (0.0, 0.4), (359.95, 70.0)):
            gr_w, gd_w, wv_w = ref.scattered_frames(ra_c, dec_c, 250, 0.5, 128, 64, 96,
                                                    seed=int(ra_c) + 1000)
            scan_w = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
                rng_w.normal(100.0, 10.0, (2, 64, 64, 96)).astype(np.float32),
                wv_w.reshape(2, 64, 8), np.arange(2, dtype=np.int32),
                rng_w.choice(np.float32([0.0, 0.5, 1.0]), (2, 64)), gr_w, gd_w))
            fin_w = finite_slots(scan_w[0])
            mom_w = cull_check(f"wide_sky ra {ra_c} dec {dec_c}", scan_w, fin_w)
            c_w = cull_counts(scan_w, fin_w)
            require(0 < c_w["pairs"] < c_w["pairs_scanned"] and float(mom_w[0].sum()) > 0,
                    f"wide_sky ra {ra_c} dec {dec_c}: the frames must reach the grid and "
                    "some (tile, slot) pairs must be culled")
            print_counts(f"wide_sky ra {ra_c} dec {dec_c}", c_w, float(mom_w[0].sum()))
            pairs0 = dict(warp_checks)
            warp_check(f"wide_sky ra {ra_c} dec {dec_c}", scan_w[0].reshape(128, 64, 96),
                       scan_w[1].reshape(128, 8), scan_w[3].reshape(128), *scan_w[4:])
            sampled = warp_checks["pairs_sampled"] - pairs0["pairs_sampled"]
            require(sampled < warp_checks["pairs"] - pairs0["pairs"],
                    f"wide_sky ra {ra_c} dec {dec_c}: warp_project culls no (tile, image) pair")
        print(f"  culled vs unculled in phase 3: {cull_checks['passes']} passes, "
              f"{cull_checks['differing_words']} differing words; warp_project "
              f"{warp_checks['calls']} calls, {warp_checks['differing_words']} differing words, "
              f"(tile, image) pairs sampled {warp_checks['pairs_sampled']} of "
              f"{warp_checks['pairs']}", flush=True)

        # The batched pack scans: the pack split into 4 packs of 16, scanned
        # dense (every pack) and sparse (2 packs and 2 padding rows), by 1, 3
        # and 16 queries, each the main box moved in RA, with random accepts.
        t0 = time.perf_counter()
        n_split = ds.pixels.shape[1] // 16
        split = (torch.from_numpy(ds.pixels).to(dev).reshape(n_split, 16, *ds.pixels.shape[2:]),
                 torch.from_numpy(ds.wcs).to(dev).reshape(n_split, 16, 8))
        fin_split = finite_slots(split[0])
        valid_split = torch.from_numpy(ds.valid.reshape(n_split, 16)).to(dev)
        rng_b = np.random.default_rng(19)
        for n_q in BATCH_KS:
            qs = offset_queries(CoaddQuery, dict(MAIN_QUERY, band="u"), BATCH16_OFFSETS[:n_q])
            grids = [mapper.query_grid_sky(qq) for qq in qs]
            gra_b, gdec_b = (torch.from_numpy(np.stack([g[i] for g in grids])).to(dev)
                             for i in (0, 1))
            for kind, packs in (("dense", list(range(n_split))), ("sparse", [1, 3, 0, 0])):
                idx_b = torch.tensor(packs, dtype=torch.int32, device=dev)
                acc_b = torch.from_numpy((rng_b.random((n_q, len(packs), 16)) < 0.7)
                                         .astype(np.float32)).to(dev)
                acc_b *= valid_split[idx_b.long()]
                if kind == "sparse":
                    acc_b[:, 2:] = 0.0           # padding rows, as compact_gates writes them
                batch_case(f"batch K={n_q} {kind}", split + (idx_b, acc_b, gra_b, gdec_b),
                           fin_split)
        del split, fin_split
        # The poisoned pack by 3 queries (every poisoned slot rejected by all,
        # some clean slots by one): each query bitwise its one-query launch,
        # NaN words too; against the plain version, the coadd's NaN pixels and
        # the depth exactly.
        qs = offset_queries(CoaddQuery, dict(MAIN_QUERY, band="u"), (0.0, 0.25, -0.25))
        grids = [mapper.query_grid_sky(qq) for qq in qs]
        gra_b, gdec_b = (torch.from_numpy(np.stack([g[i] for g in grids])).to(dev) for i in (0, 1))
        acc_b = scan_p[3].repeat(3, 1, 1)
        acc_b[1, 0, ::5] = 0.0
        acc_b[2, 0, 1::7] = 0.0
        scan_bp = scan_p[:3] + (acc_b, gra_b, gdec_b)
        s_bp = warp_ops.coadd_moments_batch(*scan_bp, finite=fin_p)
        mu_bp, sigma_bp = reducer.clip_stats(*s_bp)
        bins_bp = {nb: reducer.hist_bounds(*s_bp, nb) for nb in warp_ops.HIST_BINS}
        got_p = batch_vs_singles("poisoned_rejected batch", scan_bp, fin_p, (
            bins_bp, {"clipped": mu_bp}, {"clipped": reducer.clip_threshold(mu_bp, sigma_bp,
                                                                            CLIP_K)}))
        c_bp, d_bp = ref.coadd_scan_batch_ref(*scan_bp)
        torch.cuda.synchronize()
        c_bk, d_bk = got_p["coadd_fused"]
        require(torch.equal(torch.isnan(c_bk), torch.isnan(c_bp)) and torch.equal(d_bk, d_bp)
                and bool(torch.isnan(c_bk).any()),
                "poisoned_rejected batch: NaN pixels or depth differ from the plain version")
        print(f"  batched pack scans: {batch_checks['cases']} cases (K {BATCH_KS}, dense and "
              f"sparse, flag and none) + the poisoned pack by 3 queries (NaN coadd pixels "
              f"{[int(torch.isnan(c_bk[k]).sum()) for k in range(3)]}, plain the same): "
              f"{batch_checks['passes']} query passes against their one-query launches, "
              f"{batch_checks['differing_words']} differing words; against the plain "
              f"version max_err " + ", ".join(f"{k}={case_err[k]:.3g}" for k in BATCH_REPLACES)
              + f", flips {dict((k, case_flips[k]) for k in BATCH_REPLACES)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del scan_bp, got_p, acc_b, gra_b, gdec_b

        # The staging shapes of the culled scan body (ref.staging_scans, 3
        # queries each): every query's culled passes bitwise the unculled
        # kernel, and each batched query bitwise its one-query launch.
        t0 = time.perf_counter()
        checks0 = (cull_checks["passes"], batch_checks["passes"])
        kept_max = {}
        for name, (*arrays, flag) in ref.staging_scans().items():
            scan_s = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
            fin_s = finite_slots(scan_s[0]) if flag else None
            for k in range(scan_s[3].shape[0]):
                cull_check(f"staging {name} query {k}",
                           scan_s[:3] + tuple(t[k] for t in scan_s[3:]), fin_s)
            s_s = warp_ops.coadd_moments_batch(*scan_s, finite=fin_s)
            mu_s, sig_s = reducer.clip_stats(*s_s)
            got_s = batch_vs_singles(f"staging {name}", scan_s, fin_s, (
                {nb: reducer.hist_bounds(*s_s, nb) for nb in warp_ops.HIST_BINS},
                {"clipped": mu_s}, {"clipped": reducer.clip_threshold(mu_s, sig_s, CLIP_K)}))
            # The most slots one block of query 0 keeps, by the footprint twin.
            pixels_s, wcs_s, idx_s, acc_s, gra_s, gdec_s = scan_s
            rows_s = idx_s.long()
            keep = ref.footprint_keep(wcs_s[rows_s].reshape(-1, 8), acc_s[0].reshape(-1),
                                      None if fin_s is None else fin_s[rows_s].reshape(-1) != 0,
                                      gra_s[0], gdec_s[0], *pixels_s.shape[-2:])
            kept_max[name] = int(keep.sum(-1).max())
            coadd_s = got_s["coadd_fused"][0]
            require(bool(coadd_s.isnan().any()) == (name == "poisoned"),
                    f"staging {name}: NaN coadd pixels only where a poisoned slot is sampled")
            require(name != "all_rejected" or not coadd_s.any(),
                    "staging all_rejected: every slot rejected must give zeros")
        require(kept_max["wide_cap"] > 256 and kept_max["all_rejected"] == 0,
                f"staging shapes: most slots a block keeps {kept_max}")
        print(f"  staging shapes {sorted(kept_max)}: {cull_checks['passes'] - checks0[0]} passes "
              f"culled vs unculled and {batch_checks['passes'] - checks0[1]} batched query "
              f"passes vs their one-query launches, {cull_checks['differing_words']} / "
              f"{batch_checks['differing_words']} differing words in phase 3; most slots a "
              f"block keeps {kept_max} ({time.perf_counter() - t0:.1f} s)", flush=True)

        # PSF matching: the main path's two banks at its sizes, then edge cases.
        def to_dev(bank):
            return torch.from_numpy(np.ascontiguousarray(bank, np.float32)).to(dev)

        def main_banks(pk):
            sig = pk.floats["psf_sigma"]
            return {"gauss_k15": psf.matching_kernel_bank(sig, PSF_TARGET),
                    "homog_13": psf.homogenization_bank(pk.psf_stamps, sig, PSF_TARGET)}

        banks = main_banks(ds)
        require(banks["gauss_k15"].shape[-1] == 15 and banks["homog_13"].shape[-2:] == (13, 13),
                "psf banks: expected 15 taps and 13 x 13 at target 2.5")
        lead = ds.floats["psf_sigma"].shape
        banks["k1"] = rng.uniform(0.5, 1.5, lead + (1,))
        banks["asym_sep"] = rng.uniform(0.0, 0.25, lead + (9,))
        banks["asym_2d"] = rng.uniform(-0.02, 0.05, lead + (7, 11))
        banks["asym_13x7"] = rng.uniform(-0.02, 0.05, lead + (13, 7))
        banks["asym_7x13"] = rng.uniform(-0.02, 0.05, lead + (7, 13))
        q_psf = CoaddQuery(band="u", ra_bounds=(37.5, 38.5), dec_bounds=(-0.5, 0.5), npix=256)
        for name, bank in banks.items():
            qry = q_main if name in ("gauss_k15", "homog_13") else q_psf
            run_case(f"psf_{name}", ds, qry, ones, [0], to_dev(bank), kernel_case=psf_case)
        run_case("psf_padded_idx", ds, q_psf, np.concatenate([ones, 0 * ones]), [0, 0],
                 to_dev(banks["homog_13"]), kernel_case=psf_case)
        # The poisoned pack PSF-matched, with every fourth clean slot rejected
        # too: the gate skips those, while the poisoned slots (flag clear) are
        # still matched and keep their NaNs through every pass.
        acc_g = scan_p[3].clone()
        clean = [k for k in range(acc_g.shape[1]) if k not in {s for s, _, _ in planted}]
        acc_g[0, clean[::4]] = 0.0
        for name in ("gauss_k15", "homog_13"):
            bank = to_dev(banks[name][:1])
            n_m, n_s = gate_check(f"poisoned_rejected psf_{name}", *scan_p[:3], acc_g, gra_m,
                                  gdec_m, bank, fin_p)
            c_m, _ = warp_ops.coadd_fused(*scan_p[:3], acc_g, gra_m, gdec_m, bank,
                                          finite=fin_p)
            torch.cuda.synchronize()
            require(n_s == len(clean[::4]) and bool(c_m.isnan().any()),
                    f"poisoned_rejected psf_{name}: skipped {n_s}, or the NaNs were lost")
            print(f"  poisoned_rejected psf_{name}: pre-pass matched {n_m}, skipped {n_s}; "
                  f"passes over the gated scratch bitwise the ungated and the unculled kernel; "
                  f"NaN coadd pixels {int(c_m.isnan().sum())}", flush=True)
        del pix_p, scan_p
        for name, bank in main_banks(ds_wide).items():
            run_case(f"psf_wide_{name}", ds_wide, q_wide, wide_ones, [0], to_dev(bank),
                     kernel_case=psf_case)
        # Frames smaller than the kernel clamp on both sides at once; delta
        # rows (empty slots) must return the frames bitwise.
        tiny = torch.from_numpy(rng.normal(size=(2, 8, 5, 6)).astype(np.float32)).to(dev)
        for taps in ((15,), (15, 15), (13, 1)):
            bank = to_dev(rng.uniform(0.0, 0.2, (2, 8) + taps))
            name, err, _ = psf_match_case(f"psf_tiny_5x6_{taps}", tiny, [1, 0], bank)
            case_err[name] = max(case_err[name], err)
        for taps in ((15,), (13, 13)):
            delta = np.zeros(taps, np.float32)
            delta[tuple(k // 2 for k in taps)] = 1.0
            out = warp_ops.psf_match(tiny, torch.tensor([1, 0], dtype=torch.int32, device=dev),
                                     to_dev(np.broadcast_to(delta, (2, 8) + taps)))
            require(torch.equal(out, tiny[[1, 0]]), f"psf delta rows {taps}: not the frames")
        # Widths and heights that are neither multiples of 4 (no 16-byte
        # rows) nor of the 2-D kernel's 64-px tile, Kh != Kw.
        for h_o, w_o in ((515, 509), (70, 101)):
            odd = torch.from_numpy(rng.normal(size=(2, 8, h_o, w_o)).astype(np.float32)).to(dev)
            for taps in ((13, 7), (7, 13), (13, 13), (15,)):
                bank = to_dev(rng.uniform(-0.02, 0.05, (2, 8) + taps))
                name, err, _ = psf_match_case(f"psf_odd_{h_o}x{w_o}_{taps}", odd, [1, 0, 1],
                                              bank)
                case_err[name] = max(case_err[name], err)
        print(f"  psf tiny 5 x 6 and odd 515 x 509, 70 x 101 frames, delta rows: max_err "
              f"sep={case_err['psf_match_sep']:.3g}, 2d={case_err['psf_match_2d']:.3g} "
              f"(both bitwise); gated pre-pass vs ungated: {gate_checks['scratches']} "
              f"scratches, {gate_checks['passes']} passes, {gate_checks['differing_words']} "
              f"differing words", flush=True)
        del case, cases, big, big_ds, sv_wide, ds_wide, tiny, odd
        torch.cuda.empty_cache()

        # Coverage of the main pack's frames on the main grid, plain.
        gra, gdec = (torch.from_numpy(a).to(dev) for a in mapper.query_grid_sky(q_main))
        wcs0 = torch.from_numpy(ds.wcs[0]).to(dev)
        _, cov0 = ref.warp_batch_ref(torch.from_numpy(ds.pixels[0]).to(dev), wcs0,
                                     torch.from_numpy(ones[0]).to(dev), gra, gdec)
        depth0 = cov0.sum(0)

        # sigma = 0: every slot holds the same frame, so every pixel's samples
        # are equal and sigma is at most float32 cancellation noise; the
        # radius guard must keep every sample, for both estimators, and the
        # kept sums must be the moments' own (the same sums, bitwise).
        slot = int(cov0.sum((1, 2)).argmax())
        same = type(ds)(**{**ds.__dict__,
                           "pixels": np.ascontiguousarray(np.broadcast_to(
                               ds.pixels[:1, slot:slot + 1], ds.pixels[:1].shape)),
                           "wcs": np.ascontiguousarray(np.broadcast_to(
                               ds.wcs[:1, slot:slot + 1], ds.wcs[:1].shape))})
        _, s_k, clipped = run_case("sigma_0", same, q_main, ones[:1], [0])
        require(float(s_k[0].max()) == ones.shape[1], "sigma_0: the stack is not full depth")
        for red, (c, d) in clipped.items():
            require(torch.equal(d, s_k[0]) and torch.equal(c, s_k[1]),
                    f"sigma_0/{red}: the clip removed {int((s_k[0] - d).sum())} samples")
        print("  sigma_0: every sample kept by both estimators, sums bitwise the moments'")

        # An outlier: the pack and a copy of it in which one frame is raised
        # by OUTLIER.  Where that frame covers a pixel whose stack is at least
        # k^2 + 2 = 11 deep, its sample lies beyond k sigma of the mean (and
        # of the binapprox median) and must be the one sample clipped.
        # (At 3 to 10 deep a 3-sigma clip cannot reject one outlier of n:
        # it sits sigma * sqrt(n - 1) from the mean.)
        k = int(((cov0 > 0) & (2 * depth0 >= 11)).sum((1, 2)).argmax())
        raised = ds.pixels[:1].copy()
        raised[0, k] += np.float32(OUTLIER)
        doubled = type(ds)(**{**ds.__dict__, "pixels": np.concatenate([ds.pixels[:1], raised]),
                              "wcs": np.concatenate([ds.wcs[:1], ds.wcs[:1]])})
        _, s_k, clipped = run_case("outlier", doubled, q_main, np.concatenate([ones[:1]] * 2),
                                   [0, 1])
        at = (cov0[k] > 0) & (s_k[0] >= 11)
        require(bool(at.any()), "outlier: no pixel where the outlier frame is 11 deep")
        for red, (c, d) in clipped.items():
            require(torch.equal(d[at], s_k[0][at] - 1),
                    f"outlier/{red}: the clip did not remove exactly the outlier at "
                    f"{int((d[at] != s_k[0][at] - 1).sum())} of {int(at.sum())} pixels")
        print(f"  outlier: slot {k} + {OUTLIER:g} clipped at all {int(at.sum())} pixels "
              f"11 or more deep, by both estimators")
        del sv, ds, same, doubled, raised, cov0, depth0, s_k, clipped
        torch.cuda.empty_cache()

        # The brick mosaic: bitwise its plain version at every case.
        def mosaic_case(case, n, bh, bw, npix, offsets):
            tiles = rng.normal(size=(n, bh, bw)).astype(np.float32)
            covs = rng.integers(0, 9, size=(n, bh, bw)).astype(np.float32)
            ops_in = [torch.from_numpy(a).to(dev)
                      for a in (tiles, covs, np.asarray(offsets, np.int32).reshape(n, 2))]
            c_k, d_k = warp_ops.mosaic_bricks(*ops_in, npix)
            c_p, d_p = ref.mosaic_bricks_ref(*ops_in, npix)
            torch.cuda.synchronize()
            require(torch.equal(c_k, c_p) and torch.equal(d_k, d_p),
                    f"{case}/mosaic_bricks: not bitwise its plain version")
            err = float(torch.maximum((c_k - c_p).abs().max(), (d_k - d_p).abs().max()))
            case_err["mosaic_bricks"] = max(case_err["mosaic_bricks"], err)
            print(f"  {case:16s} B={n} tile={bh}x{bw} npix={npix} "
                  f"uncovered={int((d_p == 0).sum())} | mosaic_bricks bitwise", flush=True)
            return c_k, d_k

        lattice = [(r * 256, c * 256) for r in range(4) for c in range(4)]
        mosaic_case("mosaic_lattice", 16, 256, 256, 1024, lattice)
        mosaic_case("mosaic_one_tile", 1, 256, 256, 1024, [(100, 300)])
        mosaic_case("mosaic_bh_ne_bw", 6, 96, 160, 512, rng.integers(0, 352, (6, 2)))
        mosaic_case("mosaic_overlap", 40, 64, 64, 256, rng.integers(0, 200, (40, 2)))
        mosaic_case("mosaic_clamped", 5, 128, 128, 600,
                    [(-3, 0), (0, 900), (5000, -7), (-2000, 3), (700, 700)])
        _, d_u = mosaic_case("mosaic_uncovered", 3, 100, 100, 997,
                             [(0, 0), (400, 500), (896, 896)])
        require(int((d_u == 0).sum()) >= 997 * 997 - 3 * 100 * 100,
                "mosaic_uncovered: uncovered pixels are not 0")
        mosaic_case("mosaic_npix_997", 16, 249, 249, 997,
                    [(r * 249, c * 249) for r in range(4) for c in range(4)])
        mosaic_case("mosaic_700_tiles", 700, 16, 16, 100, rng.integers(-120, 120, (700, 2)))
        # The kernel's float4 path (a brick's clamped column and width
        # multiples of 4) and its scalar path, alone and mixed.
        mosaic_case("mosaic_column_not_4", 16, 256, 256, 1024,
                    [(r * 256 + 1, c * 256 + 3) for r in range(4) for c in range(4)])
        mosaic_case("mosaic_width_not_4", 12, 250, 250, 1000, rng.integers(-300, 800, (12, 2)))
        mosaic_case("mosaic_npix_not_4", 16, 256, 256, 1030,
                    [(r * 256, c * 256) for r in range(4) for c in range(4)] [:15] + [(-1, -1)])
        mosaic_case("mosaic_300_overlap", 300, 32, 32, 256, rng.integers(-300, 300, (300, 2)))
        mosaic_case("mosaic_mixed", 40, 64, 64, 512,
                    [(64 * (i % 8), 64 * (i // 8)) for i in range(20)]
                    + [tuple(v) for v in rng.integers(-64, 512, (20, 2))])
        c_e, d_e = mosaic_case("mosaic_empty", 0, 16, 16, 64, np.zeros((0, 2)))
        require(not c_e.any() and not d_e.any(), "mosaic_empty: B = 0 must give zero canvases")

    with phase("3 lm kernels"):
        case_err["flash_attention_single"] = flash_cases(torch, flash_ops.flash_attention,
                                                         flash_ref, dev)
        case_err.update(flash_bwd_cases(torch, dev))
        case_err.update(ssd_bwd_cases(torch, dev))
        case_err["ssd_chunked"] = ssd_cases(torch, ssd_ops.ssd_log, ssd_ops.ssd,
                                            ssd_ref.ssd_chunked_ref, ssd_ref.ssd_batched_ref,
                                            ssd_ops.heads_per_block, dev)

    # ------------------------------------------------------- 4 main path --
    cfg = SurveyConfig(n_runs=args.n_runs, n_camcols=6, n_bands=5, n_fields=12,
                       height=512, width=512, seed=82)
    query = CoaddQuery(**MAIN_QUERY)
    with phase("4 main path"):
        t0 = time.perf_counter()
        survey = make_survey(cfg, processes=procs)
        print(f"  survey: {len(survey)} frames of {cfg.height} x {cfg.width} px "
              f"(n_runs={cfg.n_runs}{'' if cfg.n_runs == 8 else ', cut from 8'}) "
              f"rendered in {time.perf_counter() - t0:.1f} s on {procs} processes")
        eng = CoaddEngine(survey, pack_capacity=64, device=DEVICE, brick_deg=BRICK_DEG,
                          brick_npix=BRICK_NPIX)
        t0 = time.perf_counter()
        for layout in ("per_file", "unstructured", "structured"):
            eng.device_dataset(layout)
        torch.cuda.synchronize()
        print(f"  packed and uploaded 3 layouts in {time.perf_counter() - t0:.1f} s: "
              f"resident {eng.resident_bytes / 2**30:.2f} GiB, "
              f"uploads {eng.pack_upload_count}")
        torch.cuda.reset_peak_memory_stats()

        # The counted run: every count is 0 just before it and read just after.
        for fn in counted.values():
            fn.launches = 0
        results, query_ms = {}, {}
        for m in METHODS:
            times = []
            for _ in range(args.reps + 1):
                before = warp_ops.coadd_fused.launches
                t0 = time.perf_counter()
                res = eng.run(query, m)
                times.append((time.perf_counter() - t0) * 1e3)
                require(warp_ops.coadd_fused.launches - before == 1,
                        f"{m}: {warp_ops.coadd_fused.launches - before} coadd_fused "
                        "launches in one query, expected exactly 1")
            results[m] = res
            query_ms[m] = statistics.median(times[1:])
        plan = eng.plan(query, "sql_structured")
        dsv, idx, accept = eng._scan_operands(plan)
        gra, gdec = eng._grids(query)
        unfused_c = torch.zeros_like(gra)
        unfused_d = torch.zeros_like(gra)
        gated = [g for g in range(idx.shape[0]) if bool(accept[g].any())]
        for g in gated:
            p = int(idx[g])
            tiles, covs = mapper.map_batch(dsv.pixels[p], dsv.wcs[p], accept[g], gra, gdec,
                                           use_kernel=True)
            c, d = reducer.reduce_local(tiles, covs)
            unfused_c += c
            unfused_d += d
        unfused = (unfused_c.cpu().numpy(), unfused_d.cpu().numpy())
        launches = {k: fn.launches for k, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated()
        # warp_project over every gated pack against its check form (after
        # the counts are read: these launches only compare).
        warp0 = dict(warp_checks)
        for g in gated:
            p = int(idx[g])
            warp_check(f"main_path pack {p}", dsv.pixels[p], dsv.wcs[p], accept[g].float(), gra,
                       gdec)
        main_pairs = (warp_checks["pairs_sampled"] - warp0["pairs_sampled"],
                      warp_checks["pairs"] - warp0["pairs"])
        print(f"  warp_project culled vs unculled over the {len(gated)} gated packs: "
              f"{warp_checks['differing_words'] - warp0['differing_words']} differing words; "
              f"(tile, image) pairs sampled {main_pairs[0]} of {main_pairs[1]} "
              f"({100.0 * (1 - main_pairs[0] / main_pairs[1]):.2f} % culled)", flush=True)
        print(f"  main-path launches: {launches}")
        require(launches["coadd_fused"] == len(METHODS) * (args.reps + 1),
                "coadd_fused launch count")
        require(launches["warp_project"] == len(gated) > 0, "warp_project launch count")
        require(not any(launches[k] for k in ("coadd_moments", "coadd_hist", "coadd_clip")),
                "a mean query launched a robust kernel")

        base = results["sql_structured"]
        require(base.coadd.shape == (query.npix, query.npix), "coadd shape")
        require(np.isfinite(base.coadd).all() and np.isfinite(base.normalized).all(),
                "non-finite coadd")
        require(base.depth.max() > 0, "the query covers nothing")
        for m, r in results.items():
            s = r.stats
            dc = float(np.abs(r.coadd - base.coadd).max())
            slots = s.packs_scanned * eng.exec_dataset(eng.plan(query, m).layout)[0].capacity
            print(f"  {m:28s} query_ms={query_ms[m]:.3f} locate_ms={s.t_locate_s * 1e3:.3f} "
                  f"pass_ms={s.t_map_reduce_s * 1e3:.3f} packs_scanned={s.packs_scanned} "
                  f"slots_scanned={slots} packs_gated={s.packs_gated} "
                  f"files_considered={s.files_considered} "
                  f"files_contributing={s.files_contributing} "
                  f"us_per_scanned_frame={query_ms[m] * 1e3 / slots:.3f} "
                  f"max|coadd-sql_structured|={dc:.3g}")
            require(dc <= PATH_ATOL, f"{m}: coadd differs from sql_structured by {dc}")
            require(np.array_equal(r.depth, base.depth), f"{m}: depth differs")
            require(s.files_contributing == base.stats.files_contributing,
                    f"{m}: files_contributing differs")
        du = float(np.abs(unfused[0] - base.coadd).max())
        require(du <= PATH_ATOL, f"unfused map+reduce differs from the fused kernel by {du}")
        require(np.array_equal(unfused[1], base.depth), "unfused depth differs")
        print(f"  unfused map_batch(use_kernel=True) + reduce_local over {len(gated)} packs: "
              f"max|coadd-fused|={du:.3g}, depth equal")

        eng.use_kernel = False
        t0 = time.perf_counter()
        plain = eng.run(query, "sql_structured")
        plain_query_ms = (time.perf_counter() - t0) * 1e3
        eng.use_kernel = True
        flat_wcs = dsv.wcs[idx.long()].reshape(-1, 8)
        flat_acc = accept.reshape(-1).float()
        near, far = ref.coverage_flips(
            torch.from_numpy(base.depth).to(dev), torch.from_numpy(plain.depth).to(dev),
            cfg.height, cfg.width, flat_wcs, flat_acc, gra, gdec)
        require(not far.any(), f"plain path: {int(far.sum())} depth pixels differ "
                               "away from every image edge")
        keep = ~near.cpu().numpy()
        dp = float(np.abs(plain.coadd - base.coadd)[keep].max())
        require(dp <= PATH_ATOL, f"plain path coadd differs by {dp}")
        for p in near.nonzero().tolist():
            edge_flips.append(("main_path", "engine plain vs kernel", -1) + tuple(p))
        print(f"  sql_structured use_kernel=False: query_ms={plain_query_ms:.1f}, "
              f"max|coadd-kernel|={dp:.3g}, edge_flips={int(near.sum())}")
        print(f"  resident_bytes={eng.resident_bytes} max_memory_allocated={peak}")
        grid_times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            mapper.query_grid_sky(query)
            grid_times.append((time.perf_counter() - t0) * 1e3)
        print(f"  host query grid (query_grid_sky, npix {query.npix}, float64 numpy): "
              f"{statistics.median(grid_times):.1f} ms per query")

        # The robust path, counted on its own: every count 0 just before it.
        for fn in counted.values():
            fn.launches = 0
        per_query = {"clipped": {"coadd_moments": 1, "coadd_clip": 1},
                     "median": {"coadd_moments": 1, "coadd_hist": 1, "coadd_clip": 1}}
        robust, robust_ms, robust_pass_ms = {}, {}, {}
        for red in ROBUST:
            want = {k: per_query[red].get(k, 0) for k in counted}
            for m in METHODS:
                times, pass_times = [], []
                for _ in range(ROBUST_REPS + 1):
                    before = {k: fn.launches for k, fn in counted.items()}
                    t0 = time.perf_counter()
                    res = eng.run(query, m, reduce=red)
                    times.append((time.perf_counter() - t0) * 1e3)
                    pass_times.append(res.stats.t_map_reduce_s * 1e3)
                    got = {k: fn.launches - before[k] for k, fn in counted.items()}
                    require(got == want, f"{m}/{red}: launches {got}, expected {want}")
                    require(res.stats.dispatches == sum(want.values()),
                            f"{m}/{red}: {res.stats.dispatches} dispatches")
                robust[red, m] = res
                robust_ms[red, m] = statistics.median(times[1:])
                robust_pass_ms[red, m] = statistics.median(pass_times[1:])
        robust_launches = {k: fn.launches for k, fn in counted.items()}
        print(f"  robust-path launches: {robust_launches}")
        n_q = len(METHODS) * (ROBUST_REPS + 1)
        require(robust_launches == {"coadd_fused": 0, "warp_project": 0, "coadd_moments": 2 * n_q,
                                    "coadd_hist": n_q, "coadd_clip": 2 * n_q,
                                    "psf_match_sep": 0, "psf_match_2d": 0, "mosaic_bricks": 0,
                                    "flash_attention_single": 0, "ssd_chunked": 0,
                                    "coadd_fused_batch": 0, "coadd_moments_batch": 0,
                                    "coadd_hist_batch": 0, "coadd_clip_batch": 0},
                "robust launch counts")

        # Each estimator's fixed operands on the sql_structured pass (after
        # the counted run): they place the decision boundaries the methods
        # and paths are held against.
        scan = (dsv.pixels, dsv.wcs, idx, accept.float(), gra, gdec)
        s_main = warp_ops.coadd_moments(*scan)
        mu, sigma = reducer.clip_stats(*s_main)
        lo, bw, inv_w = reducer.hist_bounds(*s_main, NBINS)
        hist_main = warp_ops.coadd_hist(*scan, lo, inv_w, NBINS)
        med = reducer.hist_median(hist_main, s_main[0], lo, bw)
        bounds = {
            "clipped": dict(clip=(mu, reducer.clip_threshold(mu, sigma, CLIP_K))),
            "median": dict(clip=(med, reducer.clip_threshold(med, sigma, CLIP_K)),
                           bins=(lo, bw, inv_w, NBINS)),
        }

        def hold_path(red, what, r, base, hscan=None, hbounds=None):
            """Two robust results agree: coadd at PATH_ATOL, depth equal, except
            at pixels with a sample on an image edge or decision boundary
            (placed by the pass ``hscan`` and its fixed operands ``hbounds``;
            the unmatched sql_structured pass by default)."""
            hscan, hbounds = hscan or scan, hbounds or bounds
            c, d = (torch.from_numpy(a).to(dev) for a in (r.coadd, r.depth))
            c0, d0 = (torch.from_numpy(a).to(dev) for a in (base.coadd, base.depth))
            diff = (d != d0) | ((c - c0).abs() > PATH_ATOL)
            near, far = ref.decision_flips(diff, *hscan, **hbounds[red])
            require(not far.any(), f"{what}/{red}: {int(far.sum())} pixels differ away from "
                                   "every image edge and decision boundary")
            for p in near.nonzero().tolist():
                decision_flips.append(("main_path", f"{what}/{red}") + tuple(p))
            dc = float((c - c0).abs()[~near].max())
            require(np.isfinite(r.coadd).all(), f"{what}/{red}: non-finite coadd")
            return dc, int(near.sum())

        for red in ROBUST:
            base = robust[red, "sql_structured"]
            mean_depth = results["sql_structured"].depth
            require(base.coadd.shape == (query.npix, query.npix), f"{red}: coadd shape")
            require(np.isfinite(base.normalized).all(), f"{red}: non-finite normalized coadd")
            require((base.depth <= mean_depth).all() and (base.depth[mean_depth > 0] > 0).all(),
                    f"{red}: depth outside (0, mean depth]")
            for m in METHODS:
                r = robust[red, m]
                dc, flips = hold_path(red, m, r, base)
                require(r.stats.files_contributing == base.stats.files_contributing,
                        f"{m}/{red}: files_contributing differs")
                require(r.stats.reduce == red and r.stats.reduce_passes == 2 + (red == "median"),
                        f"{m}/{red}: stats.reduce / reduce_passes")
                print(f"  {red:7s} {m:28s} query_ms={robust_ms[red, m]:.3f} "
                      f"pass_ms={robust_pass_ms[red, m]:.3f} "
                      f"clipped_samples={int(mean_depth.sum() - r.depth.sum())} "
                      f"max|coadd-sql_structured|={dc:.3g} decision_flips={flips}")
            eng.use_kernel = False
            t0 = time.perf_counter()
            plain_r = eng.run(query, "sql_structured", reduce=red)
            plain_ms = (time.perf_counter() - t0) * 1e3
            eng.use_kernel = True
            dc, flips = hold_path(red, "engine plain vs kernel", plain_r, base)
            print(f"  {red:7s} sql_structured use_kernel=False: query_ms={plain_ms:.1f}, "
                  f"max|coadd-kernel|={dc:.3g}, decision_flips={flips}")

        # PSF matching at PSF_TARGET with the survey's measured stamps (the
        # engine retuned: every bank is keyed by its PSF state).  The banks
        # are solved and uploaded first, outside the counted run.
        eng.match_psf_sigma = PSF_TARGET
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            bank_slots = sum(eng.psf_kernel_bank(layout)[..., 0, 0].size
                             for layout in ("per_file", "unstructured", "structured"))
        clamps = [str(c.message) for c in caught if issubclass(c.category, RuntimeWarning)]
        require(not clamps, f"psf banks clamp slots at target {PSF_TARGET}: {clamps}")
        print(f"  measured-PSF banks at target {PSF_TARGET}: 3 layouts, {bank_slots} slots, "
              f"0 clamped, solved in {time.perf_counter() - t0:.1f} s")

        def psf_query(red, m, kernel):
            """One PSF-matched query, repeated: exactly one ``kernel`` launch
            (psf_match_2d or psf_match_sep) and the estimator's passes."""
            want = {k: int(k == kernel) + PASSES[red].count(k) for k in counted}
            times, pass_times = [], []
            for _ in range(PSF_REPS + 1):
                before = {k: fn.launches for k, fn in counted.items()}
                t0 = time.perf_counter()
                res = eng.run(query, m, reduce=red)
                times.append((time.perf_counter() - t0) * 1e3)
                pass_times.append(res.stats.t_map_reduce_s * 1e3)
                got = {k: fn.launches - before[k] for k, fn in counted.items()}
                require(got == want, f"psf {m}/{red}: launches {got}, expected {want}")
                require(res.stats.dispatches == sum(want.values()),
                        f"psf {m}/{red}: {res.stats.dispatches} dispatches")
            return res, statistics.median(times[1:]), statistics.median(pass_times[1:])

        # The PSF-matched run, counted on its own: every count 0 just before it.
        for fn in counted.values():
            fn.launches = 0
        psf_res, psf_ms, psf_pass_ms = {}, {}, {}
        for red in REDUCES:
            for m in METHODS:
                psf_res[red, m], psf_ms[red, m], psf_pass_ms[red, m] = psf_query(
                    red, m, "psf_match_2d")
        eng.measured_psf = False            # the separable Gaussian fallback
        for red in REDUCES:
            psf_res[red, "fallback"], psf_ms[red, "fallback"], psf_pass_ms[red, "fallback"] = \
                psf_query(red, "sql_structured", "psf_match_sep")
        psf_launches = {k: fn.launches for k, fn in counted.items()}
        print(f"  psf-path launches: {psf_launches}")
        n_rep = PSF_REPS + 1
        require(psf_launches["psf_match_2d"] == len(REDUCES) * len(METHODS) * n_rep
                and psf_launches["psf_match_sep"] == len(REDUCES) * n_rep
                and psf_launches["warp_project"] == 0, "psf launch counts")
        bank_sep = eng._device_psf_kernels("structured")
        eng.measured_psf = None
        bank_2d = eng._device_psf_kernels("structured")
        require(bank_sep.shape[2:] == (15,) and bank_2d.shape[2:] == (13, 13),
                f"psf banks {tuple(bank_sep.shape)} / {tuple(bank_2d.shape)}")

        # Each query's pre-pass: the slots it matches and the rejected ones
        # it writes as zeros (ops.prepass_skip).  Then every PSF-matched query
        # again with the pre-pass ungated (ops.psf_match given skip=None:
        # every slot matched): bitwise the gated run's coadd and depth.
        # After the counts are read.
        psf_kinds = [(None, m, m) for m in METHODS] + [(False, "sql_structured", "fallback")]
        prepass = {}
        for measured, m, key in psf_kinds:
            eng.measured_psf = measured
            pl = eng.plan(query, m)
            d_m, i_m, a_m = eng._scan_operands(pl)
            sk = warp_ops.prepass_skip(
                a_m, warp_ops.matched_finite(d_m.finite, i_m, eng._device_psf_kernels(pl.layout)))
            prepass[key] = (sk.numel() - int(sk.sum()), int(sk.sum()))
        gate = warp_ops.psf_match
        warp_ops.psf_match = lambda pixels, pack_idx, bank, skip=None, **kw: gate(pixels, pack_idx,
                                                                                 bank, **kw)
        try:
            for measured, m, key in psf_kinds:
                eng.measured_psf = measured
                for red in REDUCES:
                    r, g = eng.run(query, m, reduce=red), psf_res[red, key]
                    require(np.array_equal(r.coadd.view(np.int32), g.coadd.view(np.int32))
                            and np.array_equal(r.depth.view(np.int32), g.depth.view(np.int32)),
                            f"psf {key}/{red}: the gated pre-pass changed the result")
        finally:
            warp_ops.psf_match = gate
            eng.measured_psf = None
        print(f"  psf queries gated vs ungated pre-pass: {len(psf_kinds) * len(REDUCES)} "
              f"queries, coadd and depth bitwise", flush=True)
        # The dense pre-pass of the main path (all 2880 frames), bitwise.
        plan_d = eng.plan(query, BRICK_DENSE)
        dev_d, idx_d, acc_d = eng._scan_operands(plan_d)
        bank_d = eng._device_psf_kernels(plan_d.layout)
        m_k = warp_ops.psf_match_2d(dev_d.pixels, idx_d, bank_d)
        m_p = ref.psf_match_ref(dev_d.pixels, idx_d, bank_d)
        torch.cuda.synchronize()
        require(torch.equal(m_k, m_p), f"psf_match_2d over {BRICK_DENSE}'s "
                                       f"{m_k.shape[0] * m_k.shape[1]} frames: not bitwise")
        print(f"  psf_match_2d over {BRICK_DENSE}'s {m_k.shape[0] * m_k.shape[1]} frames, "
              f"bank {tuple(bank_d.shape[2:])}: bitwise its plain version")
        del m_k, m_p
        skip_d = warp_ops.prepass_skip(acc_d, warp_ops.matched_finite(dev_d.finite, idx_d, bank_d))
        m_k = warp_ops.psf_match_2d(dev_d.pixels, idx_d, bank_d, skip_d)
        m_p = ref.psf_match_ref(dev_d.pixels, idx_d, bank_d, skip_d)
        torch.cuda.synchronize()
        require(words_differ(m_k, m_p) == 0, f"gated psf_match_2d over {BRICK_DENSE}'s "
                                             "frames: not bitwise its plain version")
        print(f"  gated psf_match_2d over {BRICK_DENSE}'s frames: {int((skip_d == 0).sum())} "
              f"matched, {int(skip_d.sum())} skipped (zeros): bitwise its plain version")
        del m_k, m_p, dev_d
        torch.cuda.empty_cache()

        # The matched sql_structured pass places the boundaries; its S0 is
        # the coverage, which matching must not change.
        pscan = warp_ops.matched_packs(dsv.pixels, dsv.wcs, idx, bank_2d) + scan[3:]
        s_psf = warp_ops.coadd_moments(*pscan)
        require(torch.equal(s_psf[0], s_main[0]), "PSF-matched S0 differs from the unmatched")
        mu_p, sigma_p = reducer.clip_stats(*s_psf)
        lo_p, bw_p, inv_w_p = reducer.hist_bounds(*s_psf, NBINS)
        med_p = reducer.hist_median(warp_ops.coadd_hist(*pscan, lo_p, inv_w_p, NBINS),
                                    s_psf[0], lo_p, bw_p)
        psf_bounds = {
            "clipped": dict(clip=(mu_p, reducer.clip_threshold(mu_p, sigma_p, CLIP_K))),
            "median": dict(clip=(med_p, reducer.clip_threshold(med_p, sigma_p, CLIP_K)),
                           bins=(lo_p, bw_p, inv_w_p, NBINS)),
        }
        unmatched = results["sql_structured"]
        for red in REDUCES:
            base = psf_res[red, "sql_structured"]
            require(np.isfinite(base.coadd).all() and np.isfinite(base.normalized).all(),
                    f"psf/{red}: non-finite coadd")
            require(np.abs(base.coadd - (robust[red, "sql_structured"] if red in ROBUST
                                         else unmatched).coadd).max() > 1e-3,
                    f"psf/{red}: matching changed nothing")
            for m in METHODS + ("fallback",):
                r = psf_res[red, m]
                if red == "mean":
                    dc = float(np.abs(r.coadd - base.coadd).max())
                    flips = 0
                    require(np.array_equal(r.depth, unmatched.depth),
                            f"psf {m}/mean: depth differs from the unmatched run")
                    if m != "fallback":
                        require(dc <= PATH_ATOL, f"psf {m}/mean: coadd differs by {dc}")
                elif m == "fallback":   # another bank: its own clip decisions
                    dc, flips = float(np.abs(r.coadd - base.coadd).max()), 0
                else:
                    dc, flips = hold_path(red, f"psf {m}", r, base, pscan, psf_bounds)
                require(r.stats.files_contributing == unmatched.stats.files_contributing,
                        f"psf {m}/{red}: files_contributing differs")
                print(f"  psf {red:7s} {m:28s} query_ms={psf_ms[red, m]:.3f} "
                      f"pass_ms={psf_pass_ms[red, m]:.3f} prepass_matched={prepass[m][0]} "
                      f"prepass_skipped={prepass[m][1]} depth_sum={float(r.depth.sum()):.0f} "
                      f"max|coadd-sql_structured(measured)|={dc:.3g} decision_flips={flips}")

        # The plain path: the structured layout matched once and cached.
        eng.use_kernel = False
        for red in REDUCES:
            t0 = time.perf_counter()
            plain_p = eng.run(query, "sql_structured", reduce=red)
            plain_ms = (time.perf_counter() - t0) * 1e3
            base = psf_res[red, "sql_structured"]
            if red == "mean":
                near, far = ref.coverage_flips(
                    torch.from_numpy(base.depth).to(dev), torch.from_numpy(plain_p.depth).to(dev),
                    cfg.height, cfg.width, flat_wcs, flat_acc, gra, gdec)
                require(not far.any(), f"psf plain path: {int(far.sum())} depth pixels differ "
                                       "away from every image edge")
                keep = ~near.cpu().numpy()
                dc, flips = float(np.abs(plain_p.coadd - base.coadd)[keep].max()), int(near.sum())
                require(dc <= PATH_ATOL, f"psf plain path coadd differs by {dc}")
                for p in near.nonzero().tolist():
                    edge_flips.append(("main_path", "psf engine plain vs kernel", -1) + tuple(p))
            else:
                dc, flips = hold_path(red, "psf engine plain vs kernel", plain_p, base, pscan,
                                      psf_bounds)
            s = plain_p.stats
            require(s.matched_cache_builds + s.matched_cache_hits == 1,
                    f"psf plain/{red}: matched cache builds {s.matched_cache_builds}, "
                    f"hits {s.matched_cache_hits}")
            print(f"  psf {red:7s} sql_structured use_kernel=False: query_ms={plain_ms:.1f} "
                  f"(matched-layout builds {s.matched_cache_builds}), "
                  f"max|coadd-kernel|={dc:.3g}, flips={flips}")
        eng.use_kernel = True
        eng._matched_cache.clear()

        # Culled against unculled over the main path: each method's pass,
        # unmatched and over its PSF scratch (the measured 13 x 13 bank), with
        # what the culled kernel skips by the plain twin of its test.
        checks0 = dict(cull_checks)
        main_counts = {}
        for m in METHODS:
            m_plan = eng.plan(query, m)
            m_dev, m_idx, m_acc = eng._scan_operands(m_plan)
            m_scan = (m_dev.pixels, m_dev.wcs, m_idx, m_acc.float(), gra, gdec)
            m_bank = eng._device_psf_kernels(m_plan.layout)
            for psf_on in (False, True):
                scan_c, fin_c = m_scan, m_dev.finite
                if psf_on:
                    # The gated scratch and the ungated one, each culled vs
                    # unculled, and the two bitwise each other.
                    gate_check(f"main_path {m}", m_dev.pixels, m_dev.wcs, m_idx, m_scan[3], gra,
                               gdec, m_bank, fin_c)
                    fin_c = warp_ops.matched_finite(fin_c, m_idx, m_bank)
                    scan_c = warp_ops.matched_packs(
                        m_dev.pixels, m_dev.wcs, m_idx, m_bank, m_scan[3], fin_c) + m_scan[3:]
                    mom_c = warp_ops.coadd_moments(*scan_c, finite=fin_c)
                else:
                    mom_c = cull_check(f"main_path {m}", scan_c, fin_c)
                what = f"{m}{' psf' if psf_on else ''}"
                main_counts[what] = cull_counts(scan_c, fin_c)
                print_counts(what, main_counts[what], float(mom_c[0].sum()))
                del scan_c
        torch.cuda.empty_cache()
        print(f"  culled vs unculled over the main path: "
              f"{cull_checks['passes'] - checks0['passes']} passes (6 methods x unmatched, PSF "
              f"gated and PSF ungated x 7), "
              f"{cull_checks['differing_words'] - checks0['differing_words']} differing words; "
              f"gated vs ungated scratch: {gate_checks['passes']} passes in all, "
              f"{gate_checks['differing_words']} differing words", flush=True)

        # The brick path (DESIGN.md §9), counted on its own: every count 0
        # just before it.  Each case starts from an empty brick store.
        eng.match_psf_sigma = None
        grid = eng.brick_grid
        wq = grid.window_query(*BRICK_WINDOW, "r")
        cover = grid.decompose(wq)
        require((grid.n_rows, grid.n_cols) == (10, 12) and cover is not None
                and cover.k == 4 and wq.npix == query.npix,
                f"brick lattice {grid.n_rows}x{grid.n_cols}, window {wq}")
        n_b = len(cover.bricks)
        print(f"  brick lattice {grid.n_rows} x {grid.n_cols} bricks of {BRICK_NPIX}^2 px, "
              f"{BRICK_DEG} deg; window rows {cover.r0}-{cover.r1} cols {cover.c0}-{cover.c1}: "
              f"ra {wq.ra_bounds}, dec {wq.dec_bounds}, npix {wq.npix}")
        brick_cases = ([("mean", m, None) for m in METHODS]
                       + [(red, m, None) for red in ROBUST for m in ("sql_structured", BRICK_DENSE)]
                       + [("mean", m, PSF_TARGET) for m in ("sql_structured", BRICK_DENSE)])
        for fn in counted.values():
            fn.launches = 0
        mosaics = 0

        def served(red, m, target, fresh, scanned, tiers):
            """One run(use_bricks=True): ``scanned`` bricks materialized, then
            exactly one mosaic launch; ``tiers`` = (hit, missed, spilled);
            bitwise ``fresh``."""
            nonlocal mosaics
            before = {k: fn.launches for k, fn in counted.items()}
            t0 = time.perf_counter()
            res = eng.run(wq, m, use_bricks=True, reduce=red)
            ms = (time.perf_counter() - t0) * 1e3
            got = {k: fn.launches - before[k] for k, fn in counted.items()}
            want = {k: scanned * (PASSES[red].count(k) + (target is not None
                                                           and k == "psf_match_2d"))
                    + (k == "mosaic_bricks") for k in counted}
            what = f"bricks {m}/{red}/psf={target}"
            require(got == want, f"{what}: launches {got}, expected {want}")
            s = res.stats
            require((s.bricks_hit, s.bricks_missed, s.bricks_spilled) == tiers,
                    f"{what}: hit/missed/spilled {(s.bricks_hit, s.bricks_missed, s.bricks_spilled)}"
                    f", expected {tiers}")
            require((s.residual_packs_scanned > 0) == (scanned > 0)
                    and s.dispatches == sum(want.values()), f"{what}: residual scan / dispatches")
            require(np.array_equal(res.coadd, fresh.coadd) and np.array_equal(res.depth, fresh.depth),
                    f"{what} {tiers}: mosaic differs from run_window "
                    f"(max {float(np.abs(res.coadd - fresh.coadd).max())})")
            mosaics += 1
            return res, ms

        brick_ms = {}
        for red, m, target in brick_cases:
            eng.match_psf_sigma = target
            eng.brick_store.clear()
            t0 = time.perf_counter()
            fresh = eng.run_window(wq, m, red)
            fresh_ms = (time.perf_counter() - t0) * 1e3
            require(np.isfinite(fresh.coadd).all() and fresh.depth.max() > 0,
                    f"run_window {m}/{red}: empty or non-finite")
            _, cold_ms = served(red, m, target, fresh, n_b, (0, n_b, 0))
            warm_ms = statistics.median(served(red, m, target, fresh, 0, (n_b, 0, 0))[1]
                                        for _ in range(WARM_REPS))
            require(eng.brick_store.drop_device() == n_b, "drop_device")
            _, spill_ms = served(red, m, target, fresh, 0, (0, 0, n_b))
            brick_ms[red, m, target] = (fresh_ms, cold_ms, warm_ms, spill_ms)
            print(f"  bricks {red:7s} {m:28s} psf={target} fresh_ms={fresh_ms:.1f} "
                  f"cold_ms={cold_ms:.1f} warm_ms={warm_ms:.1f} spilled_ms={spill_ms:.1f} "
                  f"depth_sum={float(fresh.depth.sum()):.0f} bitwise run_window: cold, warm, spilled")
            if (red, m, target) == ("mean", "sql_structured", None):
                fresh_mean = fresh

        # Materialize the window's bricks as a job, then rerun: all skipped.
        eng.match_psf_sigma = None
        eng.brick_store.clear()
        eps = 1e-9
        region = ((grid.ra0 + cover.c0 * BRICK_DEG + eps, grid.ra0 + cover.c1 * BRICK_DEG - eps),
                  (grid.dec0 + cover.r0 * BRICK_DEG + eps, grid.dec0 + cover.r1 * BRICK_DEG - eps))
        t0 = time.perf_counter()
        rep = eng.materialize_bricks(bands=("r",), region=region)
        mat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rerun = eng.materialize_bricks(bands=("r",), region=region)
        rerun_ms = (time.perf_counter() - t0) * 1e3
        require((rep.completed, rep.skipped) == (n_b, 0) and (rerun.completed, rerun.skipped)
                == (0, n_b), f"materialize_bricks: {rep.completed}/{rep.skipped} then "
                             f"{rerun.completed}/{rerun.skipped} completed/skipped")
        require(eng.warm_brick_cover(wq) is not None, "materialized window is not warm")
        served("mean", "sql_structured", None, fresh_mean, 0, (n_b, 0, 0))
        mosaic_inputs = [eng.brick_store.host_arrays(eng._brick_key("r", r, c))
                         for r, c in cover.bricks]
        mosaic_offsets = [((r - cover.r0) * BRICK_NPIX, (c - cover.c0) * BRICK_NPIX)
                          for r, c in cover.bricks]
        brick_launches = {k: fn.launches for k, fn in counted.items()}
        print(f"  brick-path launches: {brick_launches}")
        require(brick_launches["mosaic_bricks"] == mosaics == 5 * len(brick_cases) + 1,
                "mosaic_bricks launch count")
        decompose_times = []
        for _ in range(WARM_REPS):
            t0 = time.perf_counter()
            grid.decompose(wq)
            decompose_times.append((time.perf_counter() - t0) * 1e3)
        decompose_ms = statistics.median(decompose_times)
        print(f"  materialize_bricks over the window: {rep.completed} bricks in {mat_s:.2f} s; "
              f"rerun {rerun.skipped} skipped in {rerun_ms:.1f} ms; host decompose of the "
              f"window (its float64 lattice grid): {decompose_ms:.1f} ms per brick query")

        # Detection (DESIGN.md §11), counted on its own.
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        dq = CoaddQuery(**DRILL_QUERY)

        def drill(injected):
            sv_d = make_survey(SurveyConfig(**DRILL_CFG))
            truths = (inject_transients(sv_d, dq, n=N_TRANSIENTS, flux=TRANSIENT_FLUX,
                                        seed=TRANSIENT_SEED) if injected else np.zeros((0, 2)))
            e = CoaddEngine(sv_d, pack_capacity=16, match_psf_sigma=DRILL_PSF, device=DEVICE)
            return truths, detect_sources(*difference_image(e, dq, reduce="clipped"),
                                          nsigma=NSIGMA, device=DEVICE)

        truths, cat = drill(True)
        rec, spur = match_detections(cat, dq, truths)
        _, static_d = drill(False)
        print(f"  detect drill (reference configuration, npix {dq.npix}): recovered {rec}/"
              f"{len(truths)}, spurious {spur}, static-sky detections {len(static_d)} "
              f"({time.perf_counter() - t0:.1f} s)")
        require(rec >= N_TRANSIENTS and spur == 0 and len(static_d) == 0,
                "detect drill: expected 8/8 recovered, 0 spurious, 0 static")

        # Main scale: the static control on the main engine, then transients
        # injected into the newest epoch inside the window and a fresh engine.
        # The template sits on the lattice grid, the epoch (time-bounded, so
        # never brick-served) on the query's own grid: how far apart, in
        # output pixels of the query grid (float64 on the host).
        lat_ra, lat_dec = grid._window_sky64(*BRICK_WINDOW)
        gx, gy = sky_to_pixel(lat_ra, lat_dec, wq.grid_wcs_vector().astype(np.float64))
        iy, ix = np.mgrid[0:wq.npix, 0:wq.npix]
        grid_off = np.hypot(gx - ix, gy - iy)
        print(f"  lattice vs query grid of the window: offset max {grid_off.max():.4f} px, "
              f"median {np.median(grid_off):.4f} px")
        eng.match_psf_sigma = PSF_TARGET
        t0 = time.perf_counter()
        static = detect_sources(*difference_image(eng, wq, use_bricks=True, reduce="clipped"),
                                nsigma=NSIGMA, device=DEVICE)
        static_s = time.perf_counter() - t0
        # The transients go into a copy of the frames: the streaming phase
        # builds its engines from ``survey`` and holds them against ``eng``.
        sv_t = dataclasses.replace(survey, images=[
            dataclasses.replace(im, pixels=im.pixels.copy()) for im in survey.images])
        t0 = time.perf_counter()
        truths = inject_transients(sv_t, wq, n=N_TRANSIENTS, flux=TRANSIENT_FLUX,
                                   seed=TRANSIENT_SEED)
        eng_d = CoaddEngine(sv_t, pack_capacity=64, device=DEVICE, match_psf_sigma=PSF_TARGET,
                            brick_deg=BRICK_DEG, brick_npix=BRICK_NPIX)
        eng_d.device_dataset("structured")
        setup_s = time.perf_counter() - t0
        catalogs, diff_s = {}, {}
        for path in ("kernel", "plain"):
            eng_d.use_kernel = path == "kernel"
            eng_d.brick_store.clear()
            t0 = time.perf_counter()
            diff = difference_image(eng_d, wq, use_bricks=True, reduce="clipped")
            catalogs[path] = detect_sources(*diff, nsigma=NSIGMA, device=DEVICE)
            diff_s[path] = time.perf_counter() - t0
            require(np.isfinite(diff[0]).all() and diff[0].shape == (wq.npix, wq.npix),
                    f"main-scale difference ({path}): non-finite or misshapen")
        cat_k, cat_p = catalogs["kernel"], catalogs["plain"]
        require(len(cat_k) == len(cat_p) and all(
            np.array_equal(getattr(cat_k, f), getattr(cat_p, f)) for f in ("x", "y", "npix")),
            f"main-scale catalogs differ: kernel {list(zip(cat_k.x, cat_k.y))}, "
            f"plain {list(zip(cat_p.x, cat_p.y))}")
        require(np.allclose(cat_k.snr, cat_p.snr, rtol=CATALOG_RTOL, atol=0)
                and np.allclose(cat_k.flux, cat_p.flux, rtol=CATALOG_RTOL, atol=FLUX_ATOL),
                "main-scale catalogs: snr or flux beyond tolerance")
        rec, spur = match_detections(cat_k, wq, truths)
        tx, ty = sky_to_grid(wq, truths[:, 0], truths[:, 1])
        unmatched = [(int(x), int(y)) for x, y in zip(cat_k.x, cat_k.y)
                     if ((x - tx) ** 2 + (y - ty) ** 2).min() > 9.0]
        print(f"  static-control detections (x, y, snr): "
              f"{[(int(x), int(y), round(float(v), 1)) for x, y, v in zip(static.x, static.y, static.snr)]}; "
              f"injected run's unmatched detections: {unmatched}")
        detect_launches = {k: fn.launches for k, fn in counted.items()}
        print(f"  main-scale detection (window npix {wq.npix}, clipped template from bricks, "
              f"psf {PSF_TARGET}): static control {len(static)} detections ({static_s:.1f} s); "
              f"injected {N_TRANSIENTS} at flux {TRANSIENT_FLUX:g}: {len(cat_k)} detections, "
              f"recovered {rec}, spurious {spur}; kernel and plain catalogs agree "
              f"(x, y, npix equal; max |dsnr| "
              f"{float(np.abs(cat_k.snr - cat_p.snr).max()) if len(cat_k) else 0.0:.3g}); "
              f"set-up {setup_s:.1f} s, difference+detect {diff_s['kernel']:.1f} s kernel, "
              f"{diff_s['plain']:.1f} s plain")
        print(f"  detection launches: {detect_launches}")
        require(detect_launches["mosaic_bricks"] == 2, "detection: mosaic_bricks launch count")
        eng.match_psf_sigma = None
        del eng_d, diff, sv_t
        torch.cuda.empty_cache()

    # ------------------------------------------------------ 4 batch path --
    # K = 4 queries (the main box and three moved in RA) through run_batch:
    # one dense and one sparse method, three estimators, unmatched and
    # PSF-matched (the measured 13 x 13 bank).  Counted on its own: each pass
    # ONE launch of its batched kernel for all four, plus one psf_match_2d.
    bqueries = offset_queries(CoaddQuery, MAIN_QUERY, BATCH_OFFSETS)
    with phase("4 batch path"):
        for fn in counted.values():
            fn.launches = 0
        batch_res, batch_ms, batch_pass_ms = {}, {}, {}
        for target in (None, PSF_TARGET):
            eng.match_psf_sigma = target
            for m in BATCH_METHODS:
                for red in REDUCES:
                    want = {k: (PASSES[red].count(k.removesuffix("_batch")) if k.endswith("_batch")
                                else int(target is not None and k == "psf_match_2d"))
                            for k in counted}
                    for _ in range(BATCH_REPS):
                        before = {k: fn.launches for k, fn in counted.items()}
                        d0 = eng.dispatch_count
                        t0 = time.perf_counter()
                        res = eng.run_batch(bqueries, m, reduce=red)
                        ms = (time.perf_counter() - t0) * 1e3
                        got = {k: fn.launches - before[k] for k, fn in counted.items()}
                        what = f"batch {m}/{red}/psf={target}"
                        require(got == want, f"{what}: launches {got}, expected {want}")
                        require(eng.dispatch_count - d0 == res[0].stats.dispatches
                                == sum(want.values()), f"{what}: dispatches")
                    batch_res[target, m, red] = res
                    batch_ms[target, m, red] = ms
                    batch_pass_ms[target, m, red] = res[0].stats.t_map_reduce_s * 1e3
        batch_launches = {k: fn.launches for k, fn in counted.items()}
        print(f"  batch-path launches: {batch_launches}")
        n_b = len(BATCH_METHODS) * BATCH_REPS
        require(batch_launches["coadd_fused_batch"] == 2 * n_b
                and batch_launches["coadd_moments_batch"] == 4 * n_b
                and batch_launches["coadd_hist_batch"] == 2 * n_b
                and batch_launches["coadd_clip_batch"] == 4 * n_b
                and batch_launches["psf_match_2d"] == 3 * n_b, "batch launch counts")
        # Each query alone (uncounted): the batch gives its bits.
        t0 = time.perf_counter()
        grids_b = [eng._plan_grids(eng.plan(qq, "sql_structured")) for qq in bqueries]
        torch.cuda.synchronize()
        grid_ms = (time.perf_counter() - t0) * 1e3
        del grids_b
        single_ms = {}
        for (target, m, red), res in batch_res.items():
            eng.match_psf_sigma = target
            t0 = time.perf_counter()
            alone = [eng.run(qq, m, reduce=red) for qq in bqueries]
            single_ms[target, m, red] = (time.perf_counter() - t0) * 1e3
            for k, (r, a) in enumerate(zip(res, alone)):
                require(np.array_equal(r.coadd.view(np.int32), a.coadd.view(np.int32))
                        and np.array_equal(r.depth.view(np.int32), a.depth.view(np.int32)),
                        f"batch {m}/{red}/psf={target}: query {k} differs from its own run")
                require(r.stats.batch_scan == "" and np.isfinite(r.coadd).all()
                        and r.stats.files_contributing == a.stats.files_contributing,
                        f"batch {m}/{red}/psf={target}: query {k} stats or non-finite")
            require(res[0].depth.max() > 0, f"batch {m}/{red}: the main query covers nothing")
            s0 = res[0].stats
            print(f"  batch K={len(bqueries)} {red:7s} {m:16s} psf={target} "
                  f"batch_ms={batch_ms[target, m, red]:.1f} "
                  f"pass_ms={batch_pass_ms[target, m, red]:.3f} "
                  f"four_runs_ms={single_ms[target, m, red]:.1f} packs_scanned={s0.packs_scanned} "
                  f"launches={s0.dispatches} depth_sums="
                  f"{[int(r.depth.sum()) for r in res]}: each query bitwise its own run")
        print(f"  host grids of the batch's {len(bqueries)} queries (query_grid_sky, float64 "
              f"numpy): {grid_ms:.1f} ms, inside batch_ms and outside pass_ms", flush=True)
        # Where a batch's time goes: one batch under the profiler, its device
        # work by kernel and copy, busy time (the union of the device
        # events) against the host interval, after the counts are read.
        for target, m, red in ((None, "sql_structured", "median"), (PSF_TARGET, "raw_fits", "mean")):
            eng.match_psf_sigma = target
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = eng.run_batch(bqueries, m, reduce=red)
                wall_ms = (time.perf_counter() - t0) * 1e3
            print(f"  batch K={len(bqueries)} {red} {m} psf={target} profiled: "
                  f"{device_breakdown(torch, prof, wall_ms, res[0].stats.t_map_reduce_s * 1e3)}",
                  flush=True)
        eng.match_psf_sigma = None

    # --------------------------------------------------------- 4 service --
    # CoaddService on the main engine: the drill's burst, scaled to the main
    # survey, every response bitwise engine.run, coalesce factor above 1.
    with phase("4 service"):
        shape = DrillShape(*SERVICE_SHAPE)
        s_queries = drill_queries(SERVICE_SEED, SERVICE_CLIENTS, SERVICE_POOL, shape)
        serial = {}
        t0 = time.perf_counter()
        for qq in s_queries:
            if qq not in serial:
                serial[qq] = eng.run(qq, "sql_structured")
        serial_s = time.perf_counter() - t0
        for fn in counted.values():
            fn.launches = 0
        svc, s_results, s_wall = asyncio.run(run_service(eng, s_queries))
        service_launches = {k: fn.launches for k, fn in counted.items()}
        mismatched, failures = drill_failures(svc, s_queries, s_results, serial, SERVICE_CLIENTS)
        require(not failures, "service: " + "; ".join(failures))
        require(service_launches["coadd_fused_batch"] > 0, "service: no batched launch")
        service = svc.stats.snapshot()
        print(f"  service: {SERVICE_CLIENTS} clients over {len(serial)} distinct queries "
              f"(cheap npix {shape.cheap_npix}, whole footprint npix {shape.monster_npix}): "
              f"wall {s_wall * 1e3:.1f} ms against {serial_s * 1e3:.1f} ms for the distinct "
              f"queries one by one; {service['dispatches']} dispatches, coalesce factor "
              f"{service['coalesce_factor']}, merged {service['merged_inflight']}, p50 "
              f"{service['p50_ms']} ms, p95 {service['p95_ms']} ms; every response bitwise "
              f"engine.run", flush=True)
        print(f"  service launches: {service_launches}")
        print(json.dumps({"service": service}))
        del s_results, serial

    # ------------------------------------------------------ 4 streaming --
    # The main survey under a device budget (streaming residency): each
    # layout's methods x three estimators, unmatched and PSF-matched, cold
    # and warm; the K = 4 batch; the brick window.  Held against the eager
    # kernel path's results above.  Counted on its own.
    with phase("4 streaming"):
        eager = {(None, "mean", m): results[m] for m in METHODS}
        eager.update({(None, red, m): robust[red, m] for red in ROBUST for m in METHODS})
        eager.update({(PSF_TARGET, red, m): psf_res[red, m] for red in REDUCES for m in METHODS})
        batch_flips = []
        for qq in bqueries:
            d_k, i_k, a_k = eng._scan_operands(eng.plan(qq, "sql_structured"))
            scan_k = (d_k.pixels, d_k.wcs, i_k, a_k.float(), *eng._grids(qq))
            batch_flips.append((scan_k, robust_bounds(warp_ops, reducer, scan_k)))
        stream_engines = {}
        streaming = streaming_phase(
            torch, np, dev, survey, eng, query, bqueries, eager,
            {None: (scan, bounds), PSF_TARGET: (pscan, psf_bounds)},
            {(m, red): batch_res[None, m, red] for m in BATCH_METHODS for red in REDUCES},
            batch_flips, fresh_mean, counted, decision_flips, stream_engines)
        del batch_flips
        print(json.dumps({"streaming": streaming}))

    # --------------------------------------------------------- 4 faults --
    # The streamed path's fault domain on the streaming phase's engines:
    # every drill bitwise the engine's clean streamed kernel-path run, the
    # quarantine drill exact in depth; the clean-path overheads.  Counted on
    # its own.
    with phase("4 faults"):
        faults = faults_phase(torch, np, dev, survey, stream_engines, query, bqueries, counted)
        stream_engines.clear()
        print(json.dumps({"faults": faults}))

    # ---------------------------------------------------- 4 distributed --
    # Multi-device coadd jobs: form (a), one NCCL rank at full width, and
    # form (b), eight gloo ranks sharing the card; each rank maps through
    # warp_project (and psf_match_* under a bank), every launch held.
    with phase("4 distributed"):
        print(f"  card: {card_line()}")
        distributed = distributed_phase(torch, np, survey, query, bqueries, procs)
        print(json.dumps({"distributed": distributed}))

    # ---------------------------------------------- 4 zamba2 serving path --
    with phase("4 zamba2 serving"):
        lm_runs, lm_launches = zamba2_serving(torch, np, dev, counted)

    # ----------------------------------------------- 4 the other LM families --
    with phase("4 lm families"):
        family_runs, family_launches = lm_families(torch, np, dev, counted, smi)
        print(json.dumps({"lm_families": family_runs}))

    # ------------------------------------------------- 4 lm training path --
    with phase("4 lm training"):
        training, train_launches = lm_training(torch, np, dev, smi)
        print(json.dumps({"lm_training": training}))

    # --------------------------------------------------------- 5 measure --
    kernels = []
    scanned_bounds = {}   # every-slot bounds (coadd_bound), printed beside the kernels line
    with phase("5 measure"):
        h, w = cfg.height, cfg.width
        q = query.npix
        n_slots = idx.shape[0] * dsv.capacity
        acc_f = accept.float()
        fin = dsv.finite
        # The wrappers are timed given the host copy of the pack index, as
        # the engine calls them: the index check then needs no host sync.
        idx_h = idx.cpu().numpy()
        k_ms = cuda_ms(torch, lambda: warp_ops.coadd_fused(dsv.pixels, dsv.wcs, idx, acc_f,
                                                           gra, gdec, finite=fin, host_idx=idx_h),
                       args.reps)
        scan5 = (dsv.pixels, dsv.wcs, idx, acc_f, gra, gdec)
        u_ms = cuda_ms(torch, lambda: unculled("coadd_fused", scan5), args.reps)
        a_ms = alone_ms("coadd_fused", scan5, fin, want=warp_ops.coadd_fused(*scan5, finite=fin))
        # Registers and spills of each accumulator's culled kernel (ptxas -v).
        scan_ptxas = ptxas_summary(logs.get("warp", ""), "pack_scan_kernel")

        def acc_ptxas(kernel):
            acc = ACCUMULATOR[kernel.removesuffix("_batch")]
            return {k: v for k, v in scan_ptxas.items()
                    if k.startswith(f"pack_scan_kernel<{acc}") and "unculled" not in k}

        # The work that contributes: the pass's unit-weight depth and the
        # accepted slots (the sql_structured pass's S0 is its depth map).
        depth_sum = float(warp_ops.coadd_moments(*scan5, finite=fin)[0].sum())
        n_acc = int((acc_f != 0).sum())
        counts5 = main_counts["sql_structured"]
        p_ms = cuda_ms(torch, lambda: ref.coadd_scan_ref(dsv.pixels, dsv.wcs, idx, acc_f,
                                                         gra, gdec), 2)
        c_k, d_k = warp_ops.coadd_fused(dsv.pixels, dsv.wcs, idx, acc_f, gra, gdec)
        c_p, d_p = ref.coadd_scan_ref(dsv.pixels, dsv.wcs, idx, acc_f, gra, gdec)
        near, _ = ref.coverage_flips(d_k, d_p, h, w, flat_wcs, flat_acc, gra, gdec)
        err = float((c_k - c_p).abs()[~near].max())
        imgs = dsv.pixels[idx.long()].reshape(-1, 1, h, w)
        grid = grid_sample_grid(torch, sky_to_pixel, flat_wcs, gra, gdec, h, w)
        acc_col = flat_acc.reshape(-1, 1, 1, 1)

        def library_coadd():
            s = F.grid_sample(imgs, grid, mode="bilinear", padding_mode="border",
                              align_corners=True)
            return (s * acc_col).sum(0)

        l_ms = cuda_ms(torch, library_coadd, 2)
        # The robust passes sample the same (slot, pixel) pairs.
        sample_ms = cuda_ms(torch, lambda: F.grid_sample(imgs, grid, mode="bilinear",
                                                         padding_mode="border",
                                                         align_corners=True), 2)
        del grid, imgs
        scanned_bounds["coadd_fused"] = coadd_bound(n_slots, h, w, q)
        b_ms, b_by = contrib_bound(depth_sum, n_acc, h, w, q)
        kernels.append(dict(
            name="coadd_fused", route="cuda", source="src/repro_torch/csrc/warp.cu",
            replaces="src/repro/kernels/warp/warp.py:371", launches=launches["coadd_fused"],
            max_abs_err=max(err, case_err["coadd_fused"]), ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
            library="F.grid_sample bilinear + sum (sampling only)", kernel_ms=k_ms,
            unculled_ms=u_ms, alone_ms=a_ms,
            bound_note="bound_ms: the contributing samples and accepted slots (contrib_bound)",
            samples_contributing=depth_sum, ptxas=acc_ptxas("coadd_fused"),
            edge_flips=case_flips["coadd_fused"] + int(near.sum()),
            shape=f"sql_structured pass: G={idx.shape[0]} packs x 64 slots of {h}x{w}, Q={q}",
        ))
        print_counts("timed sql_structured pass", counts5, depth_sum)

        g0 = gated[0]
        p0 = int(idx[g0])
        px, wv, a0 = dsv.pixels[p0], dsv.wcs[p0], accept[g0].float()
        k_ms = cuda_ms(torch, lambda: warp_ops.warp_batch(px, wv, a0, gra, gdec), args.reps)
        u_ms = cuda_ms(torch, lambda: warp_unculled(px, wv, a0, gra, gdec), args.reps)
        p_ms = cuda_ms(torch, lambda: ref.warp_batch_ref(px, wv, a0, gra, gdec), 2)
        t_k, v_k = warp_ops.warp_batch(px, wv, a0, gra, gdec)
        t_p, v_p = ref.warp_batch_ref(px, wv, a0, gra, gdec)
        err, flips = 0.0, 0
        for i in range(px.shape[0]):
            near, far = ref.coverage_flips(v_k[i], v_p[i], h, w, wv[i:i + 1], a0[i:i + 1],
                                           gra, gdec)
            require(not far.any(), f"warp_project slot {i}: coverage differs off the edges")
            err = max(err, float((t_k[i] - t_p[i]).abs()[~near].max()))
            flips += int(near.sum())
        grid = grid_sample_grid(torch, sky_to_pixel, wv, gra, gdec, h, w)
        img1 = px.reshape(-1, 1, h, w)
        l_ms = cuda_ms(torch, lambda: F.grid_sample(img1, grid, mode="bilinear",
                                                    padding_mode="border",
                                                    align_corners=True), args.reps)
        del grid
        b_ms, b_by = warp_bound(px.shape[0], h, w, q)
        kernels.append(dict(
            name="warp_project", route="cuda", source="src/repro_torch/csrc/warp.cu",
            replaces="src/repro/kernels/warp/warp.py:240", launches=launches["warp_project"],
            max_abs_err=max(err, case_err["warp_project"]), ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
            library="F.grid_sample bilinear (sampling only)", kernel_ms=k_ms, unculled_ms=u_ms,
            ptxas=ptxas_summary(logs.get("warp", ""), "warp_project_kernel"),
            edge_flips=case_flips["warp_project"] + flips,
            shape=f"one pack: N={px.shape[0]} frames of {h}x{w}, Q={q}",
            distributed_launches={f: distributed[f]["launches"]["warp_project"]
                                  for f in distributed},
        ))
        # The robust kernels on the sql_structured pass, with its own fixed
        # operands: held against their plain versions, then timed.
        m_errs, m_flips, *_ = robust_kernels("sql_structured_pass", scan)
        center, thresh = bounds["clipped"]["clip"]
        robust_calls = {
            "coadd_moments": (lambda: warp_ops.coadd_moments(*scan, finite=fin, host_idx=idx_h),
                              lambda: ref.moments_scan_ref(*scan), (), 0,
                              MOMENTS_SAMPLE_OPS, 5, 579),
            "coadd_hist": (lambda: (warp_ops.coadd_hist(*scan, lo, inv_w, NBINS, finite=fin,
                                                        host_idx=idx_h),),
                           lambda: ref.hist_scan_ref(*scan, lo, inv_w, NBINS), (lo, inv_w),
                           NBINS, HIST_SAMPLE_OPS, 4 + NBINS, 640),
            "coadd_clip": (lambda: warp_ops.coadd_clip(*scan, center, thresh, finite=fin,
                                                       host_idx=idx_h),
                           lambda: ref.clip_scan_ref(*scan, center, thresh), (center, thresh),
                           0, CLIP_SAMPLE_OPS, 6, 606),
        }
        for name, (kern, plain, fixed, nb, sample_ops, maps, line) in robust_calls.items():
            k_ms = cuda_ms(torch, kern, args.reps)
            p_ms = cuda_ms(torch, plain, 2)
            u_ms = cuda_ms(torch, lambda: unculled(name, scan, *fixed, nbins=nb), args.reps)
            a_ms = alone_ms(name, scan, fin, *fixed, nbins=nb, want=kern())
            scanned_bounds[name] = coadd_bound(n_slots, h, w, q, sample_ops, maps)
            b_ms, b_by = contrib_bound(depth_sum, n_acc, h, w, q, sample_ops, maps)
            kernels.append(dict(
                name=name, route="cuda", source="src/repro_torch/csrc/warp.cu",
                replaces=f"src/repro/kernels/warp/warp.py:{line}",
                launches=robust_launches[name], max_abs_err=max(m_errs[name], case_err[name]),
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=sample_ms,
                library="F.grid_sample bilinear over the pass's samples (sampling only)",
                kernel_ms=k_ms, unculled_ms=u_ms, alone_ms=a_ms, ptxas=acc_ptxas(name),
                decision_flips=case_flips[name] + m_flips[name],
                shape=f"sql_structured pass: G={idx.shape[0]} packs x 64 slots of {h}x{w}, "
                      f"Q={q}" + (f", nbins={NBINS}" if name == "coadd_hist" else ""),
            ))
        # The PSF kernels on the sql_structured pass's packs with the main
        # path's banks: held against their plain version, then timed beside
        # F.conv2d (depthwise, on a replicate-padded batch) as the library call.
        n_img = idx.shape[0] * dsv.capacity
        imgs = dsv.pixels[idx.long()].reshape(1, n_img, h, w)
        for name, bank, line in (("psf_match_sep", bank_sep, 301), ("psf_match_2d", bank_2d, 337)):
            taps = tuple(bank.shape[2:])
            weight = bank[idx.long()].reshape(n_img, 1, *taps)

            def kern(bank=bank):
                return warp_ops.psf_match(dsv.pixels, idx, bank, host_idx=idx_h)

            def plain(bank=bank):
                return ref.psf_match_ref(dsv.pixels, idx, bank)

            if len(taps) == 2:
                rh, rw = taps[0] // 2, taps[1] // 2

                def library(weight=weight, rh=rh, rw=rw):
                    padded = F.pad(imgs, (rw, rw, rh, rh), mode="replicate")
                    return F.conv2d(padded, weight, groups=n_img)
            else:
                r = taps[0] // 2

                def library(weight=weight, r=r):
                    padded = F.pad(imgs, (r, r, r, r), mode="replicate")
                    rows_done = F.conv2d(padded, weight.reshape(n_img, 1, 1, -1), groups=n_img)
                    return F.conv2d(rows_done, weight.reshape(n_img, 1, -1, 1), groups=n_img)

            out_k, out_p, out_l = kern(), plain(), library()
            torch.cuda.synchronize()
            err = hold_values("sql_structured_pass", name, out_k, out_p,
                              torch.zeros_like(out_k, dtype=torch.bool))
            require(torch.equal(out_k, out_p),
                    f"sql_structured pass: {name} not bitwise its plain version")
            lib_diff = float((out_l.reshape(out_k.shape) - out_k).abs().max())
            del out_k, out_l
            k_ms = cuda_ms(torch, kern, args.reps)
            p_ms = cuda_ms(torch, plain, 2)
            l_ms = cuda_ms(torch, library, args.reps)
            b_ms, b_by = psf_bound(n_img, h, w, taps)
            row = dict(
                name=name, route="cuda", source="src/repro_torch/csrc/psf.cu",
                replaces=f"src/repro/kernels/warp/warp.py:{line}",
                launches=psf_launches[name], max_abs_err=max(err, case_err[name]), ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                library="F.conv2d depthwise on an F.pad replicate batch, TF32 off",
                library_max_abs_diff=lib_diff, kernel_ms=k_ms,
                shape=f"sql_structured pass: {n_img} frames of {h}x{w}, bank {taps}",
                distributed_launches={f: distributed[f]["launches"][name] for f in distributed},
            )
            if name == "psf_match_2d":
                # No product may fuse with its sum (-fmad=false): an FMUL and
                # an FADD a tap, twice the operation bound (printed only).
                psf_ceiling_ms = 2 * n_img * h * w * psf_ops(taps) / FP32_OPS_PER_S * 1e3
            row["ptxas"] = ptxas_summary(logs.get("psf", ""), f"{name}_kernel")
            # The kernel alone (the wrapper's pack-index check syncs the host
            # on every call, which "ms" includes); psf_match_2d also by its
            # any-width path, which the fixed width otherwise skips.
            out_k = torch.empty((idx.shape[0], dsv.capacity, h, w), device=dev)
            lib = build.library("psf")
            stream = torch.cuda.current_stream().cuda_stream

            def launch_only(entry, bank=bank, skip=None):
                err = getattr(lib, entry)(dsv.pixels.data_ptr(), idx.data_ptr(), bank.data_ptr(),
                                          None if skip is None else skip.data_ptr(),
                                          out_k.data_ptr(), n_img, dsv.capacity, h, w, *taps,
                                          torch.cuda.current_device(), stream)
                require(err == 0, f"{entry} launch: CUDA error {err}")

            row["launch_ms"] = cuda_ms(torch, functools.partial(launch_only, f"{name}_f32"),
                                       args.reps)
            if name == "psf_match_2d":
                launch_only(f"{name}_any_f32")
                torch.cuda.synchronize()
                require(torch.equal(out_k, out_p), f"sql_structured pass: {name}'s any-width "
                                                   "path not bitwise its plain version")
                row["any_width_launch_ms"] = cuda_ms(
                    torch, functools.partial(launch_only, f"{name}_any_f32"), args.reps)
            # The pre-pass the engine runs on this pass: gated (ops.prepass_skip).
            skip5 = warp_ops.prepass_skip(acc_f, warp_ops.matched_finite(fin, idx, bank))
            row["gated_launch_ms"] = cuda_ms(
                torch, functools.partial(launch_only, f"{name}_f32", skip=skip5), args.reps)
            row["gated_slots_matched"] = int((skip5 == 0).sum())
            del out_k
            del out_p
            kernels.append(row)
        del imgs
        # The dense pre-pass the engine runs (raw_fits, every pack), gated,
        # ungated and with every slot skipped (the gated pass's zero writes
        # alone), through the wrapper, with the measured bank.
        eng.match_psf_sigma = PSF_TARGET
        plan_d = eng.plan(query, BRICK_DENSE)
        dev_d, idx_d, acc_d = eng._scan_operands(plan_d)
        bank_d = eng._device_psf_kernels(plan_d.layout)
        eng.match_psf_sigma = None
        skip_d = warp_ops.prepass_skip(acc_d, warp_ops.matched_finite(dev_d.finite, idx_d, bank_d))
        dense_ms = {what: cuda_ms(torch, functools.partial(warp_ops.psf_match_2d, dev_d.pixels,
                                                           idx_d, bank_d, sk), args.reps)
                    for what, sk in (("gated", skip_d), ("ungated", None),
                                     ("all skipped", torch.ones_like(skip_d)))}
        n_d = skip_d.numel()
        print(f"  dense psf_match_2d pre-pass ({BRICK_DENSE}, {n_d} slots, 13 x 13): gated "
              f"{dense_ms['gated']:.3f} ms ({n_d - int(skip_d.sum())} matched, "
              f"{int(skip_d.sum())} written as zeros), ungated {dense_ms['ungated']:.3f} ms, "
              f"every slot skipped (zeros only) {dense_ms['all skipped']:.3f} ms", flush=True)
        del dev_d
        # The brick mosaic on the window's 16 materialized tiles, beside
        # F.fold (col2im) as the library call.
        tiles = torch.from_numpy(np.stack([a for a, _ in mosaic_inputs])).to(dev)
        covs = torch.from_numpy(np.stack([b for _, b in mosaic_inputs])).to(dev)
        offs = torch.tensor(mosaic_offsets, dtype=torch.int32, device=dev)
        n_t = tiles.shape[0]
        cols = [t.reshape(n_t, -1).T[None] for t in (tiles, covs)]

        def fold():
            return tuple(F.fold(c, (q, q), (BRICK_NPIX, BRICK_NPIX), stride=BRICK_NPIX)[0, 0]
                         for c in cols)

        out_k = warp_ops.mosaic_bricks(tiles, covs, offs, q)
        out_p = ref.mosaic_bricks_ref(tiles, covs, offs, q)
        out_l = fold()
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
                "window mosaic: not bitwise its plain version")
        lib_diff = max(float((a - b).abs().max()) for a, b in zip(out_k, out_l))
        mos = mosaic_times(torch, build, warp_ops, dev, tiles, covs, offs, q)
        require(all(torch.equal(a, b) for a, b in zip(mos.pop("out"), out_k)),
                "window mosaic launched alone differs from the wrapper's")
        k_ms = mos["ms"]
        p_ms = cuda_ms(torch, lambda: ref.mosaic_bricks_ref(tiles, covs, offs, q), args.reps)
        l_ms = cuda_ms(torch, fold, 200)
        elems = tiles.numel()
        b_ms, b_by = bound(2 * elems * 4 + offs.numel() * 4 + 2 * q * q * 4, 2 * elems)
        kernels.append(dict(
            name="mosaic_bricks", route="cuda", source="src/repro_torch/csrc/mosaic.cu",
            replaces="src/repro/kernels/warp/warp.py:700",
            launches=brick_launches["mosaic_bricks"], max_abs_err=case_err["mosaic_bricks"],
            ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
            library=f"F.fold (col2im, kernel and stride {BRICK_NPIX}) of coadd and depth",
            library_max_abs_diff=lib_diff, kernel_ms=k_ms, alone_ms=mos["alone_ms"],
            graph_ms=mos["graph_ms"], graph_hbm_ms=mos["graph_hbm_ms"],
            ptxas=ptxas_summary(logs.get("mosaic", ""), "mosaic_bricks_kernel"),
            shape=f"brick window: {n_t} tiles of {BRICK_NPIX}x{BRICK_NPIX} into {q}x{q}",
        ))
        del tiles, covs, cols, out_k, out_p, out_l
        # The batched pack scans over the sql_structured union of K = 4 and 16
        # queries (the main box moved in RA), each beside K one-query
        # launches on the same pack index; plain ms at K = 4 (the batch
        # path's K); the library time is K x the one-query row's library call.
        lib_single = {k["name"]: k["library_ms"] for k in kernels}
        plans16 = [eng.plan(qq, "sql_structured") for qq in
                   offset_queries(CoaddQuery, MAIN_QUERY, BATCH16_OFFSETS)]
        batch_rows = {}
        for n_q in (4, 16):
            plans = plans16[:n_q]
            t0 = time.perf_counter()
            grids_b = [eng._plan_grids(pl) for pl in plans]
            torch.cuda.synchronize()
            grid_ms = (time.perf_counter() - t0) * 1e3
            gra_b, gdec_b = (torch.stack([g[i] for g in grids_b]) for i in (0, 1))
            dev_b, idx_b, acc_b = eng._operands(
                "structured", np.stack([eng._exec_gate(pl) for pl in plans]),
                np.stack([pl.qvec for pl in plans]))
            acc_b = acc_b.float()
            scan_b = (dev_b.pixels, dev_b.wcs, idx_b, acc_b, gra_b, gdec_b)
            fin_b = dev_b.finite
            idx_bh = idx_b.cpu().numpy()
            s_b = warp_ops.coadd_moments_batch(*scan_b, finite=fin_b, host_idx=idx_bh)
            mu_b, sig_b = reducer.clip_stats(*s_b)
            lo_b, _, iw_b = reducer.hist_bounds(*s_b, NBINS)
            th_b = reducer.clip_threshold(mu_b, sig_b, CLIP_K)
            depth_b = float(s_b[0].sum())
            n_acc_b = int((acc_b != 0).any(0).sum())

            def one(k):
                return (dev_b.pixels, dev_b.wcs, idx_b, acc_b[k], gra_b[k], gdec_b[k])

            kw_b = dict(finite=fin_b, host_idx=idx_bh)
            calls = {
                "coadd_fused_batch": (
                    lambda: warp_ops.coadd_fused_batch(*scan_b, **kw_b),
                    lambda: [warp_ops.coadd_fused(*one(k), **kw_b) for k in range(n_q)],
                    lambda: ref.coadd_scan_batch_ref(*scan_b), COADD_SAMPLE_OPS, 4, ()),
                "coadd_moments_batch": (
                    lambda: warp_ops.coadd_moments_batch(*scan_b, **kw_b),
                    lambda: [warp_ops.coadd_moments(*one(k), **kw_b) for k in range(n_q)],
                    lambda: ref.moments_scan_batch_ref(*scan_b), MOMENTS_SAMPLE_OPS, 5, ()),
                "coadd_hist_batch": (
                    lambda: warp_ops.coadd_hist_batch(*scan_b, lo_b, iw_b, NBINS, **kw_b),
                    lambda: [warp_ops.coadd_hist(*one(k), lo_b[k], iw_b[k], NBINS, **kw_b)
                             for k in range(n_q)],
                    lambda: ref.hist_scan_batch_ref(*scan_b, lo_b, iw_b, NBINS),
                    HIST_SAMPLE_OPS, 4 + NBINS, (lo_b, iw_b)),
                "coadd_clip_batch": (
                    lambda: warp_ops.coadd_clip_batch(*scan_b, mu_b, th_b, **kw_b),
                    lambda: [warp_ops.coadd_clip(*one(k), mu_b[k], th_b[k], **kw_b)
                             for k in range(n_q)],
                    lambda: ref.clip_scan_batch_ref(*scan_b, mu_b, th_b), CLIP_SAMPLE_OPS, 6,
                    (mu_b, th_b)),
            }
            if n_q == 4:
                c_k, d_k = warp_ops.coadd_fused_batch(*scan_b, **kw_b)
                c_p, d_p = ref.coadd_scan_batch_ref(*scan_b)
                torch.cuda.synchronize()
                err_b = 0.0
                flat_wcs_b = dev_b.wcs[idx_b.long()].reshape(-1, 8)
                for k in range(n_q):
                    near, far = ref.coverage_flips(d_k[k], d_p[k], h, w, flat_wcs_b,
                                                   acc_b[k].reshape(-1), gra_b[k], gdec_b[k])
                    require(not far.any(), f"batch K=4 query {k}: coverage differs off the edges")
                    err_b = max(err_b, float((c_k[k] - c_p[k]).abs()[~near].max()))
                    case_flips["coadd_fused_batch"] += int(near.sum())
                case_err["coadd_fused_batch"] = max(case_err["coadd_fused_batch"], err_b)
                del c_k, d_k, c_p, d_p
            for name, (kern, singles, plain, sample_ops, maps, fixed) in calls.items():
                row = batch_rows.setdefault(name, {})
                single = name.removesuffix("_batch")
                want = kern()
                want = want if isinstance(want, tuple) else (want,)
                row[n_q] = dict(ms=cuda_ms(torch, kern, args.reps),
                                alone_ms=alone_ms(single, scan_b, fin_b, *fixed,
                                                  nbins=NBINS if single == "coadd_hist" else 0,
                                                  want=want),
                                singles_ms=cuda_ms(torch, singles, args.reps),
                                bound=batch_bound(depth_b, n_acc_b, n_q, h, w, q, sample_ops,
                                                  maps),
                                grid_ms=grid_ms, packs=idx_b.shape[0], accepted=n_acc_b,
                                depth_sum=depth_b)
                if n_q == 4:
                    row[n_q]["plain_ms"] = cuda_ms(torch, plain, 1)
            if n_q == 4:
                # The moments pass split by its inputs alone: the skeleton
                # (every slot rejected and flagged, so no candidate), then
                # every frame accepted over the grids moved 20 deg off the
                # survey (every footprint tested, no slot sampled).
                framed = (dev_b.wcs[idx_b.long()][..., 4:].abs().sum(-1) != 0).float()
                split = {"skeleton": ((torch.zeros_like(acc_b), gdec_b), torch.ones_like(fin_b)),
                         "footprint": ((framed.expand_as(acc_b).contiguous(), gdec_b + 20.0),
                                       fin_b)}
                for what, ((acc_x, gdec_x), fin_x) in split.items():
                    scan_x = (dev_b.pixels, dev_b.wcs, idx_b, acc_x, gra_b, gdec_x)
                    launch, outs = scan_alone("coadd_moments", scan_x, fin_x)
                    launch()
                    torch.cuda.synchronize()
                    require(not any(bool(t.any()) for t in outs),
                            f"coadd_moments_batch {what} split: a sample was added")
                    batch_rows["coadd_moments_batch"][f"{what}_ms"] = cuda_ms(torch, launch,
                                                                               args.reps)
                del framed, split
            del scan_b, grids_b, gra_b, gdec_b, acc_b, s_b, mu_b, sig_b, lo_b, iw_b, th_b
            torch.cuda.empty_cache()
        for name, row in batch_rows.items():
            single = name.removesuffix("_batch")
            r4, r16 = row[4], row[16]
            kernels.append(dict(
                name=name, route="cuda", source="src/repro_torch/csrc/warp.cu",
                replaces=f"src/repro/core/engine.py:{BATCH_REPLACES[name]}",
                launches=batch_launches[name], max_abs_err=case_err[name], ms=r4["ms"],
                plain_ms=r4["plain_ms"], bound_ms=r4["bound"][0], bound_by=r4["bound"][1],
                library_ms=4 * lib_single[single],
                library=f"4 x the {single} row's library call (no PyTorch call batches it)",
                kernel_ms=r4["ms"], alone_ms=r4["alone_ms"], singles_ms=r4["singles_ms"],
                us_per_query=r4["ms"] * 250.0, ms_k16=r16["ms"], alone_ms_k16=r16["alone_ms"],
                singles_ms_k16=r16["singles_ms"], ptxas=acc_ptxas(name),
                **{k: v for k, v in row.items() if k in ("skeleton_ms", "footprint_ms")},
                us_per_query_k16=r16["ms"] * 1e3 / 16, bound_ms_k16=r16["bound"][0],
                bound_by_k16=r16["bound"][1], host_grid_ms=r4["grid_ms"],
                host_grid_ms_k16=r16["grid_ms"],
                flips=case_flips[name], service_launches=service_launches[name],
                shape=f"sql_structured union of K=4 (and 16) queries: G={r4['packs']} "
                      f"({r16['packs']}) packs x 64 slots of {h}x{w}, Q={q}, "
                      f"{r4['accepted']} ({r16['accepted']}) slots accepted by some query"
                      + (f", nbins={NBINS}" if name == "coadd_hist_batch" else ""),
            ))
            split = (f"; moments split alone: skeleton {row['skeleton_ms']:.3f} ms, footprint "
                     f"tests {row['footprint_ms']:.3f} ms" if "skeleton_ms" in row else "")
            print(f"  {name}: K=4 {r4['ms']:.3f} ms (alone {r4['alone_ms']:.3f}; "
                  f"{r4['ms'] * 250.0:.1f} us a query) against "
                  f"4 one-query launches {r4['singles_ms']:.3f} ms; K=16 {r16['ms']:.3f} ms "
                  f"(alone {r16['alone_ms']:.3f}; "
                  f"{r16['ms'] * 1e3 / 16:.1f} us a query) against 16 launches "
                  f"{r16['singles_ms']:.3f} ms; bound K=4 {r4['bound'][0]:.3f} by "
                  f"{r4['bound'][1]}, K=16 {r16['bound'][0]:.3f} by {r16['bound'][1]}; host "
                  f"grids {r4['grid_ms']:.1f} / {r16['grid_ms']:.1f} ms{split}", flush=True)
        # The LM kernels at the other families' prefill shapes, then at the
        # Zamba2 prefill's (the 4 x 2048 batch):
        fam_flash, fam_ssd = family_shapes(torch, F, dev, args.reps)
        # flash beside F.scaled_dot_product_attention; no single PyTorch call
        # computes the SSD scan.
        g = torch.Generator(device=dev).manual_seed(17)
        fb, fh, fs, fd = 4, 32, 2048, 64
        qkv = [torch.randn((fb, fs, fh, fd), generator=g, device=dev).bfloat16().transpose(1, 2)
               for _ in range(3)]
        out_k = flash_ops.flash_attention(*qkv, True, None)
        out_p = flash_ref(*qkv, True, None)
        out_l = F.scaled_dot_product_attention(*qkv, is_causal=True)
        torch.cuda.synchronize()
        err = float((out_k.float() - out_p.float()).abs().max())
        require(err <= FLASH_TOL["bfloat16"] * (1 + float(out_p.float().abs().max())),
                f"flash at the prefill's shapes: max |diff| {err:.3g}")
        ulps, l2 = flash_rows(torch, "at the prefill's shapes", out_k, out_p)
        print(f"  flash at the prefill's shapes: max |diff| {err:.3g}, row ulps {ulps:.3g}, "
              f"relative L2 {l2:.3g}")
        lib_diff = float((out_k.float() - out_l.float()).abs().max())
        del out_k, out_p, out_l
        k_ms = cuda_ms(torch, lambda: flash_ops.flash_attention(*qkv, True, None), args.reps)
        p_ms = cuda_ms(torch, lambda: flash_ref(*qkv, True, None), 2)
        l_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(*qkv, is_causal=True),
                       args.reps)
        b_ms, b_by = flash_bound(fb, fh, fh, fs, fd, True, None, 2, BF16_TC_OPS_PER_S)
        kernels.append(dict(
            name="flash_attention_single", route="cuda", source="src/repro_torch/csrc/flash.cu",
            replaces="src/repro/kernels/attention/flash.py:80",
            launches=lm_launches["flash_attention_single"]
            + family_launches["flash_attention_single"]
            + train_launches["flash_attention_single"],
            max_abs_err=max(err, case_err["flash_attention_single"]), ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
            library="F.scaled_dot_product_attention(is_causal=True)",
            library_max_abs_diff=lib_diff, kernel_ms=k_ms,
            launches_per_prefill=lm_launches["flash_attention_single"] // (2 * len(LM_BATCHES)),
            shape=f"Zamba2 prefill: B={fb} H={fh} S={fs} D={fd} causal bf16, strided (B,S,H,D)",
            ptxas=ptxas_summary(logs.get("flash", ""), "flash_fwd_bf16_kernel"),
            family_shapes=fam_flash,
        ))
        del qkv
        kernels.extend(flash_bwd_times(torch, F, dev, args.reps, train_launches, case_err, logs))
        kernels.extend(ssd_bwd_times(torch, dev, args.reps, train_launches, case_err, logs))
        sb, st, sh, sn = 4, 2048, 64, 64
        la = -torch.rand((sb, st, sh), generator=g, device=dev) ** 4 * 50.0
        xbc = torch.randn((sb, st, sh * SSD_P + 2 * sn), generator=g, device=dev).bfloat16()
        ssd_in = (la, xbc[..., sh * SSD_P:sh * SSD_P + sn], xbc[..., sh * SSD_P + sn:],
                  xbc[..., :sh * SSD_P].reshape(sb, st, sh, SSD_P))
        y_k, s_k = ssd_ops.ssd_log(*ssd_in, 64)
        y_p, s_p = ssd_ref.ssd_chunked_ref(*ssd_in, 64)
        torch.cuda.synchronize()
        err = max(float((y_k - y_p).abs().max()), float((s_k - s_p).abs().max()))
        require(err <= SSD_TOL * max(float(y_p.abs().max()), float(s_p.abs().max()), 1.0),
                f"ssd at the prefill's shapes: max |diff| {err:.3g}")
        del y_k, s_k, y_p, s_p
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        k_ms = cuda_ms(torch, lambda: ssd_ops.ssd_log(*ssd_in, 64), args.reps)
        ssd_peak = torch.cuda.max_memory_allocated() - base_mem
        p_ms = cuda_ms(torch, lambda: ssd_ref.ssd_chunked_ref(*ssd_in, 64), 2)
        b_ms, b_by = ssd_bound(sb, st, sh, sn, SSD_P, 64, 2)
        # Each of the call's kernels, from a profiler trace of a few calls.
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                ssd_ops.ssd_log(*ssd_in, 64)
            torch.cuda.synchronize()
        ssd_parts = {}
        for ev in prof.key_averages():
            dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            for part in ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                         "ssd_chunk_scan_kernel"):
                if part in ev.key and dt:
                    ssd_parts[part] = ssd_parts.get(part, 0.0) + dt / args.reps / 1e3
        print(f"  ssd_log at the prefill's shapes: {k_ms:.3f} ms a call of "
              f"{ssd_ops.KERNELS_PER_CALL} kernel launches, by kernel (profiler) "
              f"{ {k: round(v, 4) for k, v in ssd_parts.items()} }; memory a call beyond its "
              f"operands {ssd_peak} bytes (y, state and the chunk states' scratch)")
        kernels.append(dict(
            name="ssd_chunked", route="cuda", source="src/repro_torch/csrc/ssd.cu",
            replaces="src/repro/kernels/ssd/ssd.py:68",
            launches=lm_launches["ssd_chunked"] + family_launches["ssd_chunked"]
            + train_launches["ssd_chunked"],
            max_abs_err=max(err, case_err["ssd_chunked"]), ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library="none: no single PyTorch call computes the SSD scan", kernel_ms=k_ms,
            launches_per_prefill=lm_launches["ssd_chunked"] // (2 * len(LM_BATCHES)),
            kernel_ms_by_part=ssd_parts,
            call_bytes=ssd_peak,
            shape=f"Zamba2 prefill: B={sb} T={st} H={sh} N={sn} P={SSD_P} chunk 64, bf16 "
                  "strided B, C, x",
            ptxas={k: v for part in ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                                     "ssd_chunk_scan_kernel")
                   for k, v in ptxas_summary(logs.get("ssd", ""), part).items()},
            family_shapes=fam_ssd,
        ))
        del la, xbc, ssd_in
        for m in METHODS:
            m_dev, m_idx, m_acc = eng._scan_operands(eng.plan(query, m))
            m_scan = (m_dev.pixels, m_dev.wcs, m_idx, m_acc.float(), gra, gdec)
            m_idx_h = m_idx.cpu().numpy()
            m_ms = cuda_ms(torch, lambda: warp_ops.coadd_fused(*m_scan, finite=m_dev.finite,
                                                               host_idx=m_idx_h), args.reps)
            mu_ms = cuda_ms(torch, lambda: unculled("coadd_fused", m_scan), args.reps)
            # Each pass of the method launched alone: fused, moments, and
            # clip about the clipped mean.
            m_fin = m_dev.finite
            m_mom = warp_ops.coadd_moments(*m_scan, finite=m_fin)
            m_mu, m_sigma = reducer.clip_stats(*m_mom)
            m_fixed = {"coadd_fused": (), "coadd_moments": (),
                       "coadd_clip": (m_mu, reducer.clip_threshold(m_mu, m_sigma, CLIP_K))}
            m_alone = {name: alone_ms(name, m_scan, m_fin, *fixed)
                       for name, fixed in m_fixed.items()}
            # The skeleton alone: every slot rejected and flagged.
            m_alone["skeleton"] = alone_ms(
                "coadd_fused", m_scan[:3] + (torch.zeros_like(m_scan[3]),) + m_scan[4:],
                torch.ones_like(m_fin))
            print(f"  pass of {m} over {m_scan[3].numel()} slots: coadd_fused {m_ms:.3f} ms "
                  f"(unculled {mu_ms:.3f}), {m_ms / query_ms[m]:.3f} of the query's "
                  f"{query_ms[m]:.1f} ms; launched alone: " + ", ".join(
                      f"{name} {t:.3f}" for name, t in m_alone.items()) + " ms")
            del m_mom, m_mu, m_sigma, m_fixed
        # The brick window's materialization passes, one coadd_fused pass a
        # brick onto its lattice tile, culled and unculled: a frame covers a
        # larger share of a brick's tile than of the query grid.
        for m in ("sql_structured", BRICK_DENSE):
            b_scans = []
            for r, c in cover.bricks:
                b_plan = eng._brick_plan("r", r, c, m)
                b_dev, b_idx, b_acc = eng._scan_operands(b_plan)
                b_scans.append(((b_dev.pixels, b_dev.wcs, b_idx, b_acc.float(),
                                 *eng._plan_grids(b_plan)), b_dev.finite))
            bk_ms = cuda_ms(torch, lambda: [warp_ops.coadd_fused(*s, finite=f)
                                            for s, f in b_scans], args.reps)
            bu_ms = cuda_ms(torch, lambda: [unculled("coadd_fused", s) for s, _ in b_scans],
                            args.reps)
            print(f"  brick window materialization, {m}: {len(b_scans)} coadd_fused passes "
                  f"onto {BRICK_NPIX}^2 tiles over {b_scans[0][0][3].numel()} slots each: "
                  f"culled {bk_ms:.3f} ms, unculled {bu_ms:.3f} ms", flush=True)
            del b_scans
        for k in kernels:
            lib_ms = "none" if k["library_ms"] is None else f"{k['library_ms']:.3f}"
            ceiling = (f", launch alone {k['launch_ms']:.3f}"
                       + (f", any-width path alone {k['any_width_launch_ms']:.3f}"
                          if "any_width_launch_ms" in k else "")
                       + f", gated alone {k['gated_launch_ms']:.3f} "
                       f"({k['gated_slots_matched']} slots matched)"
                       if "launch_ms" in k else "")
            if k["name"] == "psf_match_2d":
                ceiling = f", -fmad=false ceiling {psf_ceiling_ms:.3f}" + ceiling
            if k["name"] == "warp_project":
                ceiling = f", unculled {k['unculled_ms']:.3f}"
            ptxas = f"; ptxas {k['ptxas']}" if "ptxas" in k else ""
            if "alone_ms" in k:
                ceiling = f", launched alone {k['alone_ms']:.3f}"
            extra = (f", unculled {k['unculled_ms']:.3f}, every-slot bound "
                     f"{scanned_bounds[k['name']][0]:.3f} by {scanned_bounds[k['name']][1]}"
                     if k["name"] in scanned_bounds else "")
            print(f"  {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.3f}, library "
                  f"{lib_ms}, bound {k['bound_ms']:.3f} by {k['bound_by']}{ceiling}{extra})"
                  f"{ptxas}")
        print(json.dumps({"zamba2_serving": lm_runs}))
        for r in family_runs:
            if r["dtype"] == "bfloat16" and r["path"] == "kernel":
                print(f"  {r['arch']} bf16 kernel 4 x 2048: prefill {r['prefill_ms']:.1f} ms, "
                      f"decode {r['decode_ms_per_token']:.2f} ms a step "
                      f"({r['decode_tokens_per_s']:.1f} tokens/s), memory rise "
                      f"{r['memory_rise'] / 2**30:.2f} GiB")

    print(f"edge flips: {len(edge_flips)}; (case, kernel, [image,] row, col) of the first "
          f"100: {edge_flips[:100]}")
    print(f"decision flips: {len(decision_flips)}; (case, kernel, row, col) of the first "
          f"100: {decision_flips[:100]}")
    print(f"card: {smi}")   # again here, where the end of a long output still shows it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
