#!/usr/bin/env python3
"""Smoke run of the PyTorch port (crossclr_tpu_torch) on one NVIDIA GPU.

Drives the port's paths and proves that they went through the repo's own
CUDA kernels: retrieval serving at the full width of
configs/lsmdc_transformer.json with attention="flash" on both towers, from
seeded weights and from a checkpoint the port trained (eval, /reload, the
int8 index, micro-batching),
training at the full width of configs/youcook2_mlp.json through the fused
CrossCLR-intra loss kernels, training the transformer towers of
configs/lsmdc_transformer.json through the flash forward and backward
kernels with attention dropout, the global-negative losses through the
row-block kernels, and training the full CrossCLR loss of
configs/fullcrossclr_fused_ragged.json through the keep-mask branch of
the loss kernels (dual at its learnable τ, sym at a static τ), and
training configs/podslice_32k.json at B = 65,536 through the GradCache
two-pass step and the per-direction loss kernels; every training leg reads
its batches through the host data path (the native gather into a pinned
ring, prefetched to the card on a side stream); the data-parallel
step through the train CLI, one process per rank; ring attention with
the sequence-parallel step on a data x model grid of processes; and
tensor parallelism (towers split over the model axis) and LAMB.
Phases, one line each; any failure raises and exits non-zero:

  1. device    — a CUDA device must exist (there is no CPU path); prints
                 nvidia-smi's name and power limit, torch and CUDA versions.
  2. build     — builds every crossclr_tpu_torch/ops/csrc/*.cu with nvcc
                 for sm_90a, one nvcc process each, all started together;
                 prints the time, the .so paths and ptxas' report, and the
                 registers of each instantiation of the tensor-core kernels
                 (flash_fwd_bf16_kernel, flash_dkv_bf16_kernel,
                 flash_dq_bf16_kernel: 9 padded head dims (16 ... 128 and
                 latent attention's 192) x 2 dropout builds each; direction_fwd_bf16_kernel: 3 feature-chunk
                 widths; direction_bwd_bf16_kernel: 3 widths x 2
                 coefficient forms; sym_fwd_bf16_kernel,
                 dual_fwd_bf16_kernel, sym_bwd_bf16_kernel,
                 dual_bwd_bf16_kernel, rows_lse_bf16_kernel,
                 rows_bwd_rows_bf16_kernel and rows_bwd_cols_bf16_kernel: 3
                 widths x unpruned and pruned each; 105 in all), none of
                 which may spill but dk/dv at 192 (4 bytes: its 192
                 accumulator registers meet the 255-register ceiling).  First it builds the host gather,
                 crossclr_tpu_torch/data/csrc/host_io.cc, with g++, and
                 prints its time; a failed build fails the phase.
  2b. data     — the host data path: at the transformer leg's widths
                 (640 ragged pairs, batch 64), fp32, bf16 and int8 stores
                 (the latter two written to a temp directory), one-batch
                 chunks and chunks of 4, a fast consumer and a slow one
                 (device work queued on its stream and a host sleep before
                 each draw): 12 chunks through train.py's path
                 (stacked_chunks into a pinned ring of 4,
                 prefetch_to_device), all held to the end, each equal bit
                 for bit to the host stream once copied back, and each int8
                 chunk's device dequantization equal bit for bit to the
                 host's.  Then at the leg's batch (1024 rows) the numpy
                 gather, the native gather into fresh pages and into the
                 pinned ring, the pinned and the pageable H2D (CUDA
                 events) and the prefetch worker's own gather and H2D,
                 each in ms and GB/s, and the pinned bytes.
  3. kernel    — the flash forward against the plain version on the same
                 CUDA tensors (H=8, Dh=48, S in {64, 96, 37}, ragged masks,
                 one entry fully masked; fp32 and bf16) within the stated
                 limits, then both timed at the serve encode shape (B=1024,
                 H=8, S=96, Dh=48, bf16; CUDA events, median of 20); then
                 latent attention's shape (a GradCache chunk of 128 rows of
                 the Moonlight text tower: 16 heads, S=96, queries and keys
                 192 wide, values 128, bf16, ragged masks): the forward and
                 autograd's dq, dk, dv against autograd through the plain
                 version in fp32, and the forward and forward + backward
                 timed.
  4. attention — the forward with dropout (r in {0.1, 0.5}, once at nonzero
                 offsets) against the plain version; the exact keep mask
                 recovered, fp32 and bf16, from the forward's output
                 (q = k = 0, v = I, Dh = S in {64, 96}) and from dk/dv's dv
                 (dO = I: dv is its transpose); two launches of each flash
                 kernel on the same inputs, both dtypes, bit for bit equal;
                 dq, dk and dv (r in {0, 0.1}) against
                 autograd through the plain version; at the transformer
                 leg's shapes (B=1024, S in {96, 64}, H=8, Dh=48, bf16,
                 dropout 0.1, one entry fully masked) the forward against
                 the plain version, dq, dk and dv against the plain version
                 of the same backward (delta from the bf16 output), each
                 backward kernel against its own plain version on the same
                 operands, and the gap to autograd through fp32 logged; then,
                 at (B, S) in {(1024, 96), (1024, 64), (4096, 96)}, the
                 kernels in both builds (dropout 0 and 0.1), their plain
                 versions and torch's scaled_dot_product_attention (the
                 library yardstick, timed only) forward and backward.
  5. slice     — the port's build_service with seeded random weights on
                 cuda (4096 synthetic pairs, video corpus, text queries),
                 served by a ThreadingHTTPServer on 127.0.0.1:0; 8 POST
                 /search (1, 3, 5, 16 query rows, k=10), GET /healthz and
                 /metrics.  Checks HTTP 200, shapes, index range, descending
                 scores in [-1, 1], that the forward kernel's launch count
                 grew during the corpus encode and during every search (and
                 no backward kernel launched), and that query embeddings
                 from the kernel path have cosine >= 0.999 with the same
                 weights run through the plain attention.
  5b. serve    — serving what the port trains, through the entry points a
                 user calls, on configs/lsmdc_transformer.json at full width
                 (flash attention, dropout 0.1, EMA 0.999, 4096 synthetic
                 pairs made once for the phase, batch 1024, one step a
                 dispatch): train.main to step 4 with a checkpoint;
                 eval.main on it (all rows with --embeddings-output and
                 --topk 10, the held-out rows with --ema): finite metrics at
                 step 4, flash_fwd launched and no backward kernel, rows/s
                 of the whole CLI call; build_service --checkpoint-dir, its
                 corpus against the eval dump, 8 HTTP searches each
                 launching flash_fwd and no backward kernel; --corpus-emb
                 on the eval dump under --strict-index; the int8 index
                 (--corpus-dtype int8 on the same dump): the card's int32
                 accumulators equal to a CPU int32 product bit for bit at
                 256 and 1 query rows, every score of 256 text queries and
                 of 256 corpus rows as exact-match queries within 1e-2 of
                 the fp32 index, top-1 kept wherever the fp32 margin
                 clears 2e-2; 16 concurrent HTTP clients behind a 5 ms
                 window against the serial answers (indices equal, scores
                 within 1e-5, fewer dispatches than requests); /search
                 p50 of single-row queries for the fp32 and the int8 index
                 and for 1 and 16 clients with and without the window, over
                 HTTP (the client's clock) and through search() in the
                 process (no JSON);
                 then train.main resumed to step 8 in the same directory
                 and POST /reload: step 8, the corpus re-encoded through
                 flash_fwd, its seconds.  Counts set to 0 at the start of
                 the phase and read at its end: flash_dq = flash_dkv =
                 8 x 8.
  5c. aot      — on the serve phase's checkpoint (step 8): eval.main on all
                 rows (the dump and the one-process metrics); the live
                 services for the fp32 index (encoded), the bf16 and the
                 int8 index (the dump); export_search of each, text ->
                 video, queries 96 x 768 with a mask, k = 16 (export s,
                 artifact MB); an --aot-worker child loads each with
                 SearchArtifact alone (load s; crossclr_tpu_torch.models,
                 .training and .serve never imported), searches at 1, 5
                 and 64 rows (indices equal to the live search(), scores
                 within 1e-5; kernel 1 launched exactly 4 times a search),
                 times 20 searches at 1 and at 64 rows against the live
                 ones, and serves the fp32 artifact with serve --artifact
                 over HTTP (answers equal to SearchArtifact.search, k
                 clamped, /reload refused, SIGTERM).
  5d. shard    — two --shard-worker gloo ranks sharing cuda:0 (host-staged):
                 serve --shard-corpus from the checkpoint (each rank
                 encodes its 2048 rows), fp32 and int8, rank 0 on HTTP
                 (1, 5, 64 query rows; /reload; SIGTERM stops both)
                 against the aot phase's one-process services (indices
                 equal, scores within 1e-5); the eval CLI on the ranks
                 against one process (R@K equal, MdR and MnR within 1e-6,
                 the top-10 dump equal); sharded_retrieve_topk on
                 1,048,576 x 384 fp32 rows (1.5 GB, a block a rank), 64
                 queries, k = 16, against dense retrieve_topk, ms a search
                 each; then a one-rank NCCL group's sharded search bit for
                 bit with the dense one (fp32, and int8 on 65,536 rows).
  5e. profile  — the transformer leg for 2 one-step dispatches:
                 --save-config round-trips; --tensorboard-dir refused
                 naming the missing package with both writers' imports
                 blocked, and where one is installed (the card's machine
                 has one) its event file written; --profile-dir's trace names
                 the flash forward, dq, dk/dv and sym kernels among its
                 kernel events, flash_dq = flash_dkv = 16 and sym_fwd =
                 sym_bwd = 2; utils.profiling.nan_debug raises at the
                 operator that makes a NaN on the card.
  6. loss      — the four loss kernels of ops/csrc/fused_dual.cu (sym_fwd,
                 sym_bwd at τ=0.03; dual_fwd, dual_bwd at a tensor τ of 0.03
                 and 0.01) against their plain versions on the same CUDA
                 tensors, B in {1024, 4096, 1000} x D in {256, 512} and
                 the transformer slice's 1024 x 384, fp32
                 operands (highest) and bf16 operands (default), within the
                 limits below, dual_fwd also with all-kept and none-kept
                 keep masks; the fused loss on CUDA against the eager
                 loss; then each kernel and its plain version timed at the
                 MLP slice's shape (B=1024, D=256), the transformer slice's
                 (B=1024, D=384) and the reference's headline shape
                 (B=4096, D=512), and the loss fwd+bwd of both routes at the
                 headline shape (CUDA events, median of 20), with
                 contrastive pairs/s.  Then the keep-mask (pruned) branch
                 of the four kernels against their plain versions at
                 B x D in {1024 x 384, 1000 x 384, 4096 x 384, 4096 x 512},
                 both tiers, sym at τ = 0.03 and dual at a tensor τ of
                 0.03 and 0.01, with keep masks from
                 connectivity_keep_and_weights at prune 0.1, all pruned
                 (each lse then equals its positive logit) and all kept;
                 at 1024 x 384 the pruned dual lse also against
                 rows_lse_cuda on the same operands (two kernels, one
                 function); sym_fwd, sym_bwd, dual_fwd and dual_bwd (dual at
                 a tensor τ) at the MLP leg's 1024 x 256 and, pruned, the
                 full-CrossCLR
                 leg's 1024 x 384, both tiers, on random features at τ =
                 0.03 and on features collapsed near one direction at τ =
                 1/79 (g·e^{-lse} subnormal; Σ coeff⊙z within DS_RTOL),
                 two launches of each bf16 build bit for bit; then the
                 pruned pairs and their plain
                 versions timed, forward and backward, at 1024 x 384 and
                 4096 x 384 (bf16 operands), beside the rows route's two
                 directions on the same operands.
  7. direction — the per-direction kernels of ops/csrc/fused_crossclr.cu
                 (lse_fwd, lse_bwd) against their plain versions on the
                 same CUDA tensors, both directions, B x D in {4096 x 256,
                 1000 x 384, 4096 x 512}, fp32 (highest) and bf16 (default)
                 operands, τ in {0.03, 0.01 (subtract-first backward),
                 1/79 (s near 80, the factored backward's edge)} and
                 w in {0.8, 0}, within the loss kernels' limits; lse_fwd at
                 4096 x 256 on random features at τ = 0.03 and collapsed
                 ones at τ = 1/79, two launches of the bf16 build bit for
                 bit; the per-direction pair's lse against the sym pair's at
                 4096 x 256.  At the leg's 65,536 x 256, both tiers and
                 both directions: every row's lse against the plain lse
                 taken in blocks of 2048 anchor rows (each against all
                 131,072 candidates), and the gradient rows of three
                 blocks against the plain backward on those rows (the bf16
                 sym_bwd's rows too: both its directions are the factored
                 lse_bwd there); once
                 for random unit features at the leg's τ = 0.03, once at
                 τ = 1/79 for features collapsed near one direction (as a
                 random-init tower's are), where lse passes 87 and the
                 factored backward's g·e^{-lse} is subnormal (it also logs
                 how far the factored gradient there lies from the
                 subtract-first one, unchecked).  Then each kernel and its
                 plain version timed
                 at 4096 x 256 (median of 20), and the kernels alone at the
                 leg's 65,536 x 256 (median of 3) beside the sym pair at
                 that shape (bf16 operands).
  8. global    — the three row-block kernels of ops/csrc/fused_global.cu
                 (rows_lse, rows_bwd_rows, rows_bwd_cols): (a) each against
                 its plain version on the same CUDA tensors at B x D in
                 {4096 x 384, 1000 x 384, 1000 x 640}, offset 0 with
                 anchors = candidates, fp32 (highest) and bf16 (default)
                 operands, pruned (keep masks from
                 connectivity_keep_and_weights at prune 0.1) and unpruned,
                 at τ = 0.03 and 0.05 (the Σ p⊙z term of dτ row by row
                 within LSE_TOL and in total within DS_RTOL), two launches
                 of each bf16 kernel bit for bit; (b) four emulated ranks:
                 blocks of 1024 rows at offsets 0, 1024, 2048, 3072 of 4096
                 give the one-call lse and Σ p⊙z rows, and their summed
                 candidate gradients and concatenated row gradients the
                 one-call gradients, each block held to plain too; (b') the
                 same at blocks of 250 rows at offsets 0, 250, 500, 750 of
                 1000 x 384, where a rank's own columns start inside a
                 candidate tile;
                 (c) a 1-rank NCCL group: global_cross_clr and
                 global_cross_clr_intra (use_fused) at 4096 x 384 against
                 cross_clr_fused / cross_clr_intra_fused and the eager
                 losses, values and feature gradients, each rows kernel
                 launched exactly twice per loss (the counts set to 0 just
                 before and read just after: the rows kernels' main path);
                 (d) each kernel held to its plain version and then
                 both timed at the leg's 1024 x 384, at 4096 x 384 and at
                 4096 x 512 (bf16 operands, pruned; CUDA events, median of
                 20); (d') the same at one rank's block of the global
                 losses at 4 ranks: 1024 anchor rows at offset 1024 of a
                 batch of 4096, D = 384.
  9. train     — crossclr_tpu_torch.train.main on configs/youcook2_mlp.json
                 at full width (synthetic data, 16384 pairs): 300 steps with
                 eval every 100, a resume to 340 steps, then 100 steps with a
                 learnable temperature.  Checks the sym kernels launched in
                 the first leg and the dual kernels in the second, finite
                 losses, a last logged loss below the first, eval v2t/R@1
                 above chance, the step count continuing on resume, and
                 logit_scale moved and within ±ln 100.  Then the transformer
                 leg: train.main on configs/lsmdc_transformer.json at full
                 width (flash attention, dropout 0.1 on both towers, 4096
                 synthetic pairs, batch 1024, 40 steps, eval every 20):
                 flash_dq and flash_dkv launched exactly 8 x 40 times (4
                 layers x 2 towers per step; eval runs without grad),
                 flash_fwd at least that often, the sym loss kernels
                 launched, the loss falling and R@1 above chance.  Launch
                 counts reset before each leg; prints the steady train
                 pairs/s of each.  Then the full-CrossCLR leg: train.main on
                 configs/fullcrossclr_fused_ragged.json at full width (its
                 crossclr_fused loss with learnable τ at the default tier,
                 attention "xla", 4096 synthetic ragged pairs, batch 1024,
                 30 steps, eval every 15): dual_fwd and dual_bwd (their
                 keep-mask branch) launched exactly 30 times each, no
                 flash, sym or rows kernel, the loss falling, R@1 above
                 chance, logit_scale moved and within ±ln 100; prints the
                 weight ESS that the trainer reports on the leg's first
                 batch.  Then the same leg at the config's static τ
                 (train.learnable_temperature=false, 10 steps): sym_fwd
                 and sym_bwd launched exactly 10 times each, no dual,
                 flash or rows kernel, the loss falling.  Then the
                 large-batch leg: train.main on configs/podslice_32k.json at
                 its widths (MLP towers 512/384 -> 2048 -> 256, bf16,
                 crossclr_intra_fused at τ = 0.03, default tier,
                 embedding_chunk 1024), synthetic data, 73,000 pairs, batch
                 65,536, warmup 2, 8 steps in one dispatch: lse_fwd and
                 lse_bwd launched exactly 16 times each and no other
                 kernel, every step's loss finite and the last below the
                 first; prints seconds and pairs/s.  After the
                 transformer leg, the same leg from a bf16 and from an
                 int8 file store written from its synthetic pairs (20
                 steps each, flash_dq and flash_dkv 8 x 20 launches, the
                 loss falling); prints their pairs/s.
 10. gradcache — the two-pass step on the card at the podslice widths
                 in chunks of 1024: at B = 8192 pass 3's embeddings equal
                 pass 1's bit for bit (bf16 towers); with fp32 towers and
                 fp32 loss operands, at B = 8192 (the sym pair) and at the
                 leg's 65,536 (the per-direction kernels), every parameter
                 gradient within 1e-5 of its largest entry of the one-pass
                 step's.
 11. paths     — each training leg (MLP, transformer, full-CrossCLR,
                 large-batch) driven through Trainer.fit twice in one call:
                 by the serial pageable iterator (infinite_batches, copied
                 on the step's thread) and by train.py's prefetched chunks;
                 prints both steady pairs/s.
 12. dp        — the train CLI in child processes of this script
                 (--dp-worker, one per rank; each joined within DP_JOIN_S
                 or the phase fails), one step a dispatch, each step
                 logged: (a) configs/podslice_32k.json at its batch of
                 32,768, 4 steps, in one child: with no group, then on a
                 one-rank NCCL group from a launcher's environment
                 (RANK=0 WORLD_SIZE=1, a free MASTER_PORT): every step's
                 loss and grad_norm bit for bit, the same launches
                 (sym_fwd and sym_bwd 4 each, no other kernel); (b) two
                 ranks on the one card, each child joined by gloo before
                 it calls the CLI with --device cuda:0 (NCCL refuses two
                 ranks on one device), each running the same config
                 (16,384 rows a rank, ZeRO-1, GradCache at chunk 1024,
                 global negatives through the rows kernels at 16,384
                 anchor rows of 32,768 x 256) and then
                 configs/fullcrossclr_fused_ragged.json at 1024 (512 a
                 rank, 5 steps), held to one process on the two ranks'
                 HostShard batches joined: the loss and grad_norm per step
                 and the mean |Δ| of the parameters after the last step
                 (rank 0's checkpoint) within DP_LOSS_RTOL, DP_NORM_RTOL
                 and DP_PARAM_MEAN, each rows kernel launched exactly 2
                 times a step on each rank and no other kernel.  Prints
                 each leg's steady pairs/s of the global batch and ms a
                 step, and the phase's seconds.
 13. ring      — ring attention (parallel/ring_attention.py) and the
                 sequence-parallel train step: (a) on a one-rank
                 NCCL group, the ring over it against the flash kernels at
                 B=1024, S=96, both builds, dropout 0 and 0.1: the output
                 bit for bit in both builds, dq/dk/dv bit for bit in fp32
                 (bf16 checked too); then in RING_RANKS child processes
                 (--ring-worker), gloo ranks sharing cuda:0 whose blocks
                 are staged through page-locked host memory (NCCL refuses
                 two ranks on one device; the transport logged), each
                 rank's sequence shard of the same global inputs: at the
                 transformer leg's shapes (B=1024, H=8, S in {96, 64},
                 Dh=48, ragged masks, one entry fully masked), fp32 and
                 bf16, dropout 0 and 0.1, the ring-of-flash's output and
                 dq/dk/dv against the flash kernels on the whole sequence
                 and against the plain ring on the card (fp32 at the flash
                 limits; bf16 outputs at LIMITS, gradients within
                 RING_BF16_REL of the largest entry; the gap of both bf16
                 backwards to autograd through fp32 logged); at B=2,
                 S=16,384 (bf16, dropout 0.1) against the flash kernels
                 alone, and both timed (fwd, fwd+bwd; median of 5, host
                 clock).  (b) in the same children, the train CLI on
                 configs/lsmdc_transformer.json at full width with
                 --n-model 2 and ring towers, dropout 0.1, batch 1024, 5
                 steps, one step a dispatch, against one process (a
                 --dp-worker child) of flash towers on the same batches:
                 the loss and grad_norm per step within RING_LOSS_RTOL and
                 RING_NORM_RTOL, both ranks equal bit for bit, the mean |Δ|
                 of the parameters after the last step (rank 0's
                 checkpoint) within RING_PARAM_MEAN, each rank launching
                 flash_fwd, flash_dq and flash_dkv exactly 16 times a step
                 (2 towers x 4 layers x 2 ring blocks; counts set to 0
                 just before the CLI and read each step), the sym loss
                 kernels launched; the ring checkpoint restored into flash
                 towers that encode.  Prints both runs' steady pairs/s and
                 ms a step (two ranks staged through the host on one card:
                 not scaling) and the phase's seconds.
 14. tp        — tensor parallelism and LAMB, last: (a) in TP_RANKS
                 --ring-worker children (gloo ranks sharing cuda:0), the
                 train CLI on configs/lsmdc_transformer.json at full width
                 with --n-model 2 and flash towers, which splits both
                 towers tensor-parallel (each rank 4 of the 8 heads,
                 Dense_0 / Dense_1 and input_proj / output_proj split),
                 dropout 0.1, batch 1024, 5 steps, against the ring phase's
                 one process of flash towers on the same batches: the loss
                 and grad_norm per step within TP_LOSS_RTOL and
                 TP_NORM_RTOL, both ranks equal bit for bit, the mean |Δ| of
                 the parameters after the last step (rank 0's checkpoint,
                 whole tensors) within TP_PARAM_MEAN, each rank launching
                 flash_fwd, flash_dq and flash_dkv exactly TP_FLASH_LAUNCHES
                 times a step on its own heads and the sym pair once a
                 step; the checkpoint restored in one process (whole towers
                 and moments) and encoding; the eval CLI in one process on
                 it.  (b) the MLP leg's config at full width under
                 train.optimizer=lamb (LAMB_OVERRIDES, 40 steps): the loss
                 falls, the sym pair 40 launches; one LAMB update on the
                 card from its checkpoint against the same update in
                 float64 on the CPU within LAMB_UPDATE_RTOL of each
                 parameter's largest |Δ|; then the dp phase's two-rank
                 podslice leg under LAMB (podslice_lamb) against one
                 process.  Prints each run's ms a step and the phase's
                 seconds.  The attention phase also recovers the keep mask
                 of a rank's heads (heads 4-7 of 8 on a second data shard)
                 and checks the forward at heads 8-15 of 16.

python3 chip_smoke.py --dp-fault {none,averaged,unsummed} runs (b) alone,
the podslice leg under LAMB too, with that gradient reduction in the
ranks and logs each reading beside its limit: the readings DP_PARAM_MEAN
is set between.
python3 chip_smoke.py --sp-fault {none,unsummed,doubled} does the same for
the ring phase's (b): the model group's gradient sum left out, or the ring
towers' summed gradients not divided by n_model (RING_* limits).
python3 chip_smoke.py --tp-fault {none,uncopied} does the same for the tp
phase's (a): the cotangent of a split layer's replicated input not summed
over the model group (TP_* limits).

The second-to-last line is the kernels' JSON record: twelve kernels, each
with its time, its plain version's, the library call's where one exists,
and its bound from this run's shapes; the flash records also name the
shape and build they were timed at and what the library call computes,
and their launches by path (transformer training, the serve phase's
train-eval-serve-reload, the ring and the tp phases' training on both
ranks, the profile phase's training and, for the forward, the slice's
serving, the aot phase's eval, encodes and artifact searches and the
shard phase's ranks);
the loss records add their pruned branch's time, plain time, bound and
launches on the full-CrossCLR legs; the rows records are timed at 1024 x
384 and add their time, plain time and bound at one rank's block (1024 of
4096 x 384), and their launches by path (the global losses, the dp
phase's two legs and the tp phase's podslice leg under LAMB; the loss
records' add the dp phase's one-rank leg, the tp phase's split training
and its LAMB MLP leg);
the per-direction records are timed at 4096 x 256 and add
their time and bound at the leg's 65,536 x 256.
The last line is {"ok": true, "device": {...}}.

Run from the root of a checkout:  python3 chip_smoke.py

With --baseline DIR (DIR holding another revision's flash_fwd.cu,
flash_bwd.cu, fused_crossclr.cu, fused_dual.cu, fused_global.cu and their
headers, e.g. the csrc directory of a parent commit's `git archive`
unpacked under the ignored _checkout/), it runs only phases 1-2 and a
comparison: this checkout's flash, per-direction, loss-pair and rows
kernels against that revision's on the same operands, bit for bit where
the design was kept (every fp32 output, the bf16 flash forward, dq and
dk/dv, lse_fwd and lse_bwd in both tiers, sym_fwd, dual_fwd, sym_bwd and
dual_bwd in both tiers, unpruned and pruned, at 1024 x 256 and 1024 x 384,
the rows kernels in both tiers, pruned and not, at 1024 x 384; the
redesigned bf16 sym_bwd (REDESIGNED) is logged only: it is held to its
plain version by the phases above; a revision whose entry points take no
scratch is called through ParentLossLibrary);
then at B=1024, S in {96, 64}, H=8, Dh=48, bf16, dropout 0 and 0.1 each
flash kernel timed in turns (baseline, this, this, baseline; median of 20
each) beside its plain version, SDPA and its bound; bf16 lse_fwd and
lse_bwd the same way at 4096 x 256 (median of 20, beside the plain
version) and at the leg's 65,536 x 256 (median of 3) beside the bound;
bf16 sym_fwd, dual_fwd, sym_bwd and dual_bwd at 1024 x 256 and, pruned,
1024 x 384 (median of 20) beside their plain versions and bounds, and
dual_fwd also at 4096 x 512; bf16 rows_lse, rows_bwd_rows and
rows_bwd_cols at 1024 x 384 and at one rank's block (1024 of 4096 x 384,
offset 1024), pruned; bf16 sym_bwd at the benchmark cells' 32,768 x 256
and 4096 x 384 beside its bound; and the loss fwd+bwd at the headline
4096 x 512 through the sym and the dual route (default tier) beside the
plain pair's; the last line is a JSON record of those times.
"""

import argparse
import contextlib
import copy
import csv
import dataclasses
import importlib
import io
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent
FLASH_SOURCES = {
    "flash_fwd": "crossclr_tpu_torch/ops/csrc/flash_fwd.cu",
    "flash_dq": "crossclr_tpu_torch/ops/csrc/flash_bwd.cu",
    "flash_dkv": "crossclr_tpu_torch/ops/csrc/flash_bwd.cu",
}
FLASH_REPLACES = {
    "flash_fwd": "crossclr_tpu/ops/flash_attention.py:201",
    "flash_dq": "crossclr_tpu/ops/flash_attention.py:351",
    "flash_dkv": "crossclr_tpu/ops/flash_attention.py:392",
}
LOSS_SOURCE = "crossclr_tpu_torch/ops/csrc/fused_dual.cu"
LOSS_REPLACES = {
    "sym_fwd": "crossclr_tpu/ops/fused_dual.py:831",
    "sym_bwd": "crossclr_tpu/ops/fused_dual.py:1023",
    "dual_fwd": "crossclr_tpu/ops/fused_dual.py:108",
    "dual_bwd": "crossclr_tpu/ops/fused_dual.py:301",
}
ROWS_SOURCE = "crossclr_tpu_torch/ops/csrc/fused_global.cu"
ROWS_REPLACES = {
    "rows_lse": "crossclr_tpu/ops/fused_global.py:92",
    "rows_bwd_rows": "crossclr_tpu/ops/fused_global.py:155",
    "rows_bwd_cols": "crossclr_tpu/ops/fused_global.py:228",
}
DIRECTION_SOURCE = "crossclr_tpu_torch/ops/csrc/fused_crossclr.cu"
# the loss kernels' bf16 tensor-core builds and their instantiations: lse_fwd
# (3 feature-chunk widths), lse_bwd (3 widths x the factored and
# subtract-first forms), sym_fwd, dual_fwd, sym_bwd, dual_bwd, rows_lse,
# rows_bwd_rows and rows_bwd_cols (3 widths x unpruned and pruned each), and
# sym_bwd's Hopper design (unpruned at 64 and 128 candidate rows, pruned at 64)
LOSS_MMA_KERNELS = {"fused_crossclr.cu": (("direction_fwd_bf16_kernel", 3),
                                          ("direction_bwd_bf16_kernel", 6)),
                    "fused_dual.cu": (("sym_fwd_bf16_kernel", 6),
                                      ("dual_fwd_bf16_kernel", 6),
                                      ("sym_bwd_bf16_kernel", 6),
                                      ("sym_bwd_wgmma_kernel", 3),
                                      ("dual_bwd_bf16_kernel", 6)),
                    "fused_global.cu": (("rows_lse_bf16_kernel", 6),
                                        ("rows_bwd_rows_bf16_kernel", 6),
                                        ("rows_bwd_cols_bf16_kernel", 6))}
DIRECTION_REPLACES = {
    "lse_fwd": "crossclr_tpu/ops/fused_crossclr.py:179",
    "lse_bwd": "crossclr_tpu/ops/fused_crossclr.py:279",
}
LOSS_SHAPES = [(1024, 256), (1024, 384), (1024, 512), (4096, 256),
               (4096, 512), (1000, 256), (1000, 512)]
SLICE_LOSS_SHAPE = (1024, 256)  # configs/youcook2_mlp.json: batch, embed
TRANSFORMER_LOSS_SHAPE = (1024, 384)  # configs/lsmdc_transformer.json
HEADLINE_LOSS_SHAPE = (4096, 512)  # the reference's headline benchmark
# the bf16 builds this revision redesigned: --baseline holds them to their
# plain versions (the phases above), not to the baseline's bits
REDESIGNED = ("sym_bwd",)
NEG_WEIGHT = 0.8
# loss kernels vs plain (tests/test_fused_kernel.py:37,133,169,251): lse
# atol = rtol = 2e-5; gradients max |err| <= 5e-5 of the largest |entry|;
# Σ coeff⊙z (the dτ term) rtol 1e-4.  The same limits hold at the default
# tier: kernel and plain take the same bf16 operands (widened exactly to
# fp32) and differ only in the order of their fp32 sums.
LSE_TOL = 2e-5
GRAD_BOUND = 5e-5
DS_RTOL = 1e-4
TRAIN_CONFIG = "configs/youcook2_mlp.json"
TRAIN_OVERRIDES = [
    "data.source=synthetic", "data.num_pairs=16384", "data.video_dim=512",
    "data.text_dim=384", "train.warmup_steps=30", "eval_every=100",
    "log_every=20",
]
LOGIT_SCALE_BOUND = 4.6051702  # ln 100, the trainer's clamp
OVERRIDES = [
    "video_tower.attention=flash", "text_tower.attention=flash",
    "data.source=synthetic", "data.num_pairs=4096", "data.video_dim=512",
    "data.text_dim=768", "data.video_seq_len=64", "data.text_seq_len=96",
    "data.variable_lengths=true", "data.batch_size=1024",
]
# kernel vs plain: (out atol, out rtol, lse atol).  fp32: the same sums in
# another order; bf16: the output rounds to bf16 (one ulp near 1 is 7.8e-3)
LIMITS = {
    torch.float32: (2e-5, 0.0, 1e-5),
    torch.bfloat16: (1.6e-2, 1.6e-2, 1e-3),
}
COSINE_MIN = 0.999
SCORE_SLACK = 1e-5  # a cosine of unit fp32 vectors may exceed 1 by rounding
SERVE_SHAPE = (1024, 8, 96, 48)  # (B, H, S, Dh) of one text-tower encode
# flash backward vs autograd through the plain version: fp32 max |err| <=
# 5e-5 of the largest |entry| (both sum in fp32, in another order); bf16
# atol = rtol = 1.6e-2 (one bf16 ulp of the outputs plus the order of sums)
FLASH_GRAD_BOUND = 5e-5
FLASH_BF16_TOL = 1.6e-2
# the bf16 builds of the flash kernels: tensor-core kernels (mma.sync), 18
# instantiations each (9 padded head dims, latent attention's 192 among
# them, x 2 dropout builds)
MMA_KERNELS = ("flash_fwd_bf16_kernel", "flash_dkv_bf16_kernel",
               "flash_dq_bf16_kernel")
# bytes an instantiation may spill, by (kernel, padded head dim): dk/dv at
# latent attention's 192 holds 2 x 24 x 4 fp32 accumulators (dv's padded
# to 192 too) at the 255-register ceiling and spills 4 bytes (nvcc 12.9,
# sm_90a); every other instantiation spills nothing
SPILL_ALLOWED = {("flash_dkv_bf16_kernel", 192): 4}
# the exact keep mask read back as out · n · (1 − r) (or dv · n · (1 − r)):
# fp32 within 1e-4 of 0 or 1; bf16 within one bf16 ulp at 1, the rounding
# of the output itself
KEEP_OFF = {torch.float32: 1e-4, torch.bfloat16: 2.0**-8}
# (B, S) of the attention timings: the text and video towers at the
# transformer slice's batch, and the text tower at the headline batch
ATTENTION_TIMING = [(1024, 96), (1024, 64), (4096, 96)]
LEG_BATCH, LEG_DROPOUT = 1024, 0.1  # the transformer leg's batch and rate
TRANSFORMER_CONFIG = "configs/lsmdc_transformer.json"
# 40 steps: its widths and its 20 steps a dispatch are the config's.  The
# synthetic batch is 873 MB (SyntheticPairs' features are float64 under
# NumPy 2), so a stacked chunk of 20 is 17.5 GB, under the quarter of the
# card's memory that the trainer allows a chunk, and the train CLI's
# page-locked ring of two chunks locks 35 GB of host memory
TRANSFORMER_STEPS = 40
TRANSFORMER_OVERRIDES = [
    *OVERRIDES, f"video_tower.dropout={LEG_DROPOUT}",
    f"text_tower.dropout={LEG_DROPOUT}",
    "train.warmup_steps=30", "eval_every=20", "log_every=10",
]
# serving what the port trains: the transformer leg's config and widths
# with an EMA, one step a dispatch (a pinned ring of two batches), trained
# to SERVE_STEPS[0], evaluated and served, trained on to SERVE_STEPS[1]
# and reloaded
SERVE_STEPS = (4, 8)
SERVE_OVERRIDES = [
    *TRANSFORMER_OVERRIDES, "train.ema_decay=0.999", "train.warmup_steps=2",
    "train.steps_per_call=1", "eval_every=4", "log_every=1",
]
INT8_SCORE_BOUND = 1e-2  # the JAX package's stated move of a cosine score
# the aot, shard and profile phases (PR 19), on the serve phase's
# checkpoint: text -> video search artifacts, k = AOT_K, queries of the
# text tower's S x D with a mask; their answers at AOT_ROWS rows against
# the live search() (the same program op for op: indices equal, scores
# within AOT_SCORE_TOL), kernel 1 once per layer of the text tower a search
AOT_K = 16
AOT_QUERY_SHAPE = (96, 768)
AOT_ROWS = (1, 5, 64)
AOT_REPS = 20  # searches timed at 1 and at 64 rows, each
AOT_SCORE_TOL = 1e-5
AOT_FLASH_PER_SEARCH = 4
WORKER_JOIN_S = 300  # the aot and shard phases' children, start to exit
# the shard phase: SHARD_RANKS gloo ranks sharing cuda:0; /search at
# SHARD_ROWS rows, k = 10; sharded_retrieve_topk on SHARD_BIG fp32 rows
# (1.5 GB) made on the card from SHARD_SEED, SHARD_QUERIES queries; a
# one-rank NCCL group on it and on SHARD_INT8_ROWS of it as an int8 index;
# the eval CLI on the ranks against one process: R@K equal, MdR and MnR
# within EVAL_MEAN_TOL (the ranks' partial counts are exact integers)
SHARD_RANKS = 2
SHARD_ROWS = (1, 5, 64)
SHARD_BIG = (1_048_576, 384)
SHARD_QUERIES, SHARD_K = 64, 16
SHARD_SEED = 71
SHARD_REPS = 10
SHARD_INT8_ROWS = 65_536
# dense retrieve_topk (lax.top_k's tie order: evaluation.topk's two
# passes) against the same search through torch.topk of the fp32 scores, on the
# whole SHARD_BIG index at these query counts, in turns
TOPK_QUERIES = (64, 1024)
TOPK_REPS = 4
EVAL_MEAN_TOL = 1e-6
# the profile phase: the transformer leg for PROFILE_STEPS one-step
# dispatches under --profile-dir; the trace's kernel events must name these
PROFILE_STEPS = 2
PROFILE_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "sym_fwd", "sym_bwd")
SERVE_CLIENTS, BATCH_WINDOW_MS = 16, 5.0
BATCHED_SCORE_TOL = 1e-5  # a batch of other rows: the same sums in another order
# the transformer leg again from bf16 and int8 file stores written from the
# same synthetic pairs (the JAX package's default store dtype is bf16)
STORE_STEPS = 40  # two dispatches of 20: the second is the steady rate
# the host data path: prefetched chunks against the host stream at the
# transformer leg's widths, DATA_DRAWS chunks (six wraps of the train
# CLI's ring of two) per case
DATA_PAIRS, DATA_BATCH, DATA_DRAWS = 640, 64, 12
DATA_SLOW_S = 0.02  # the slow consumer's host sleep per chunk
DATA_TIMING_PAIRS = 2048  # the H2D and gather rates at the leg's batch
FULL_CONFIG = "configs/fullcrossclr_fused_ragged.json"
FULL_STEPS = 30
# the config's widths and loss as shipped; synthetic ragged data (its
# data/*.npy files are not in the repository), batch 1024 for 4096, and a
# warmup and dispatch size that fit 30 steps
FULL_OVERRIDES = [
    "data.source=synthetic", "data.num_pairs=4096", "data.video_dim=512",
    "data.text_dim=768", "data.video_seq_len=64", "data.text_seq_len=96",
    "data.variable_lengths=true", f"data.batch_size={LEG_BATCH}",
    "train.warmup_steps=10", "train.steps_per_call=5", "eval_every=15",
    "log_every=5",
]
# the rows kernels: the config's batch and the ragged edges, its width, and
# a width past one 512-feature chunk (the backward splits it over blocks)
FULL_STATIC_STEPS = 10  # the static-τ full-CrossCLR leg (sym route)
# the pruned loss kernels: the leg's batch, the ragged edges and the
# config's batch at its width, and the reference's headline shape
PRUNED_SHAPES = [(1024, 384), (1000, 384), (4096, 384), (4096, 512)]
PRUNED_TIMING = [(1024, 384), (4096, 384)]  # the leg's and the config's batch
# the per-direction kernels: the config's batch cut to 4096 at its width,
# the ragged edges at the transformer width, and the headline width
DIRECTION_SHAPES = [(4096, 256), (1000, 384), (4096, 512)]
DIRECTION_TAUS = (0.03, 0.01, 1.0 / 79)  # factored; subtract-first; s near 80
DIRECTION_TIMING = (4096, 256)  # kernel and plain version, median of 20
# at the leg's shape the plain version runs on blocks of anchor rows: every
# row's lse, and the gradient of the first, a middle and the last block
DIRECTION_BLOCK = 2048
DIRECTION_LEG_CASES = ((0.03, 0.0), (1.0 / 79, 0.005))  # (τ, collapse noise)
SUBNORMAL_LSE = 87.336544  # -ln of fp32's least normal, 2^-126
PODSLICE_CONFIG = "configs/podslice_32k.json"
# twice the config's batch, past the JAX dual kernels' budget at D = 256
# (B > 49,152), so the loss takes the per-direction kernels
PODSLICE_BATCH = 65536
PODSLICE_CELL_BATCH = 32768  # portbench's podslice_train
PODSLICE_STEPS = 8  # one dispatch at the config's steps_per_call
PODSLICE_PAIRS = 73000  # 7300 held out for eval, 65,700 left to train on
PODSLICE_OVERRIDES = [
    "data.source=synthetic", f"data.num_pairs={PODSLICE_PAIRS}",
    "data.video_dim=512", "data.text_dim=384",
    f"data.batch_size={PODSLICE_BATCH}", "train.warmup_steps=2",
]
GRAD_CACHE_BATCH = 8192  # pass 3's masks against pass 1's
# the two-pass step against the one-pass step: the sym pair's batch, then
# the leg's (the per-direction kernels)
GRAD_CACHE_COMPARE = (GRAD_CACHE_BATCH, PODSLICE_BATCH)
GRAD_CACHE_BOUND = 1e-5  # max |error| / max |gradient|, fp32 towers
# the data-parallel phase: the podslice config at its own batch of 32,768
# (4 steps) and the full-CrossCLR config at the leg's 1024 (5 steps), one
# step a dispatch and every step logged, the eval and the checkpoint at the
# end; (a) one NCCL rank against no group, (b) two gloo ranks on the one
# card (NCCL refuses two ranks on one device) against one process on the
# two ranks' HostShard batches joined
DP_LEGS = {"podslice": PODSLICE_CONFIG, "full": FULL_CONFIG,
           "podslice_lamb": PODSLICE_CONFIG}
DP_PHASE_LEGS = ("podslice", "full")  # the tp phase runs podslice_lamb
DP_STEPS = {"podslice": 4, "full": 5, "podslice_lamb": 4}
DP_OVERRIDES = {
    # 36,410 pairs: 3,641 held out, 32,769 train rows, 16,384 a rank
    "podslice": ["data.source=synthetic", "data.num_pairs=36410",
                 "data.video_dim=512", "data.text_dim=384",
                 "data.batch_size=32768", "train.warmup_steps=2",
                 "train.steps_per_call=1", "eval_every=4", "log_every=1"],
    # 1200 pairs: 120 held out, 1080 train rows, 540 a rank
    "full": [*FULL_OVERRIDES, "data.num_pairs=1200", "train.steps_per_call=1",
             "eval_every=5", "log_every=1"],
}
DP_OVERRIDES["podslice_lamb"] = [*DP_OVERRIDES["podslice"], "train.optimizer=lamb"]
DP_RANKS = 2
DP_JOIN_S = 300  # each group of child processes, start to exit
# the two-rank step against one process on the joined batch: the loss per
# step within DP_LOSS_RTOL of its value (the rows kernels against the sym
# or dual pair, on bf16 operands; the transformer towers run at half the
# rows), grad_norm within the JAX mesh tests' rtol 1e-3, and the mean |Δ|
# over every parameter element after the last step within DP_PARAM_MEAN:
# between what the sound step reads (1.169e-4 podslice, 1.113e-6 full, on
# an H100) and what each rank's gradient left unsummed reads (1.288e-4,
# 5.959e-5; python3 chip_smoke.py --dp-fault unsummed, PERF.md).  The
# podslice gap is thin: Adam moves each element about lr a step whatever
# its gradient, and the bf16 towers' near-zero entries flip sign in both
# runs; its grad_norm (5.7e-7 sound, 0.65 unsummed) is the sharp check.
# A mean instead of a sum moves no parameter (Adam is blind to the
# gradient's scale): grad_norm alone catches it (relative error 0.5)
# The podslice leg under LAMB (the tp phase): loss 2.5e-6 and mean |Δ|
# 6.088e-6 sound, 2.9e-5 and 6.810e-6 unsummed (grad_norm 1.9e-7 against
# 0.50); its limits sit between, as podslice's do
DP_LOSS_RTOL = {"podslice": 1e-4, "full": 1e-3, "podslice_lamb": 1e-5}
DP_NORM_RTOL = 1e-3
DP_PARAM_MEAN = {"podslice": 1.22e-4, "full": 1e-5, "podslice_lamb": 6.4e-6}
# printed beside the readings, not held: AdamW's |update| is at most
# DP_ADAM_U / 2 · lr a step at these step counts (Cauchy-Schwarz on the
# bias-corrected moments), so any two finite runs stay within
# DP_ADAM_U · Σ lr of each other
DP_ADAM_U = 2.02
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")
# the ring phase: RING_RANKS gloo ranks sharing cuda:0 (NCCL refuses two
# ranks on one device) as a 1 x RING_RANKS grid.  (a) the ring-of-flash at
# the transformer leg's attention shapes (the text and video towers at its
# batch, H = 8, Dh = 48) and at one long sequence whose plain scores would
# take B·H·S²·4 = 17 GB; (b) the train CLI on the transformer config at
# full width with ring towers, batch LEG_BATCH (the leg's cut of the
# config's 4096), one step a dispatch, against one process of flash towers
# on the same batches (1200 pairs: 120 held out, 1080 train rows)
RING_RANKS = 2
RING_JOIN_S = 300  # the ranks' children, start to exit
RING_LEG_SHAPES = [(LEG_BATCH, 96), (LEG_BATCH, 64)]
RING_RATES = (0.0, LEG_DROPOUT)
RING_LONG, RING_LONG_VALID = (2, 16384), 12000  # (B, S), entry 1's valid keys
RING_TIMING_RUNS = 5
RING_STEPS = 5
RING_FLASH_LAUNCHES = 2 * 4 * RING_RANKS  # towers x layers x ring blocks, a step
RING_OVERRIDES = [
    "data.source=synthetic", "data.num_pairs=1200", "data.video_dim=512",
    "data.text_dim=768", "data.video_seq_len=64", "data.text_seq_len=96",
    "data.variable_lengths=true", f"data.batch_size={LEG_BATCH}",
    f"video_tower.dropout={LEG_DROPOUT}", f"text_tower.dropout={LEG_DROPOUT}",
    "train.warmup_steps=2", "train.steps_per_call=1", "eval_every=5",
    "log_every=1",
]
# (a) limits: fp32 as the flash kernels against plain (LIMITS,
# FLASH_GRAD_BOUND); bf16 outputs LIMITS; bf16 dq/dk/dv max |err| over
# the largest |entry|, against the plain ring on the card (the same
# algebra: Δ from the merged fp32 output) and against the flash kernels on
# the whole sequence (Δ from the output rounded to bf16): set from an
# H100's readings, at most 6.8e-3 of the largest entry in both (each
# block's gradient rounds to bf16 before the fp32 sum, as in the JAX ring,
# then the sum rounds again: one to two bf16 ulps of 2^-7 = 7.8e-3), at
# two ulps
RING_BF16_REL = 1.6e-2
# (b) limits, bf16 ring towers against bf16 flash towers, set between what
# the sound step reads on an H100 (loss 2.0e-5, grad_norm 3.7e-5,
# parameters' mean |Δ| 2.5e-6) and what the faulted reductions read
# (python3 chip_smoke.py --sp-fault, PERF.md): each rank's gradient share
# unsummed, loss 3.1e-2, grad_norm 0.20-0.76, mean |Δ| 3.4e-5; each rank's
# objective without 1/n_model, grad_norm 1.0 (AdamW is blind to the
# gradient's scale: the loss and the parameters do not move, grad_norm
# alone catches it)
RING_LOSS_RTOL = 1e-3
RING_NORM_RTOL = 1e-3
RING_PARAM_MEAN = 1e-5
# the tp phase: (a) the ring phase's leg (the transformer config at full
# width, flash attention, dropout 0.1, batch 1024, 5 one-step dispatches)
# through the train CLI at --n-model TP_RANKS with flash towers, so every
# tower is split tensor-parallel over TP_RANKS gloo ranks sharing cuda:0
# (host-staged: NCCL refuses two ranks on one device), against the ring
# phase's one process of flash towers on the same batches; each rank runs
# kernels 1-3 once a layer and tower a step on its own heads
TP_RANKS = 2
TP_FLASH_LAUNCHES = 2 * 4  # towers x layers, a step and rank
# (a) limits, bf16 split towers against bf16 whole towers: between what the
# sound step reads on an H100 (loss 5.3e-5, grad_norm 1.2e-4, parameters'
# mean |Δ| 3.4e-6) and what the step reads with the cotangent of the split
# layers' replicated inputs left unsummed (python3 chip_smoke.py
# --tp-fault uncopied, PERF.md: loss 0.81, grad_norm 0.36, mean |Δ| 2.6e-4)
TP_LOSS_RTOL = 1e-3
TP_NORM_RTOL = 1e-3
TP_PARAM_MEAN = 2e-5
# (b) LAMB: the MLP leg's config at full width, batch 1024, with
# train.optimizer=lamb at a LAMB rate; one update on the card against the
# same update in float64 on the CPU, max |error| over the largest |Δ| of
# each parameter
LAMB_STEPS = 40
LAMB_OVERRIDES = ["train.optimizer=lamb", "train.learning_rate=0.005",
                  "train.warmup_steps=5", "train.steps_per_call=1",
                  f"eval_every={LAMB_STEPS}", "log_every=5"]
LAMB_UPDATE_RTOL = 1e-6
GLOBAL_SHAPES = [(4096, 384), (1000, 384), (1000, 640)]
GLOBAL_TIMING = [(1024, 384), (4096, 384), (4096, 512)]
EMULATED_RANKS = 4
# one rank's block of the global losses at 4 ranks: b_loc anchor rows of a
# batch of B at the second rank's offset (b_loc, B, D, off)
RANK_SHAPE = (1024, 4096, 384, 1024)
DS_KEY = "rows_bwd_rows Σ p⊙z per row"  # the dτ term, held apart from d rows
PRUNE = 0.1

# the card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# bound of a kernel is the larger of its bytes over the memory rate and its
# operations over the peak of its operands' type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
                  f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    return smi


def build_phase() -> None:
    from crossclr_tpu_torch.data import native_io
    from crossclr_tpu_torch.ops import _build

    # the host gather first: g++, seconds, while nvcc takes longer
    native_io.load_library()
    info = native_io.build_info
    log("build", f"{info['compiler']} {' '.join(native_io.CXX_FLAGS)} "
                 f"{native_io._SOURCE.relative_to(ROOT)} -> {info['path']} in "
                 f"{info['seconds']:.2f} s (built={info['built']})")
    sources = sorted(p.name for p in _build._CSRC.glob("*.cu"))
    check({"flash_fwd.cu", "flash_bwd.cu", "fused_dual.cu", "fused_global.cu",
           "fused_crossclr.cu"} <= set(sources),
          f"kernel sources missing: {sources}")
    _build.load_libraries(sources)
    for source in sources:
        info = _build.build_info[source]
        log("build", f"nvcc {' '.join(_build.NVCC_FLAGS)} {source} -> "
                     f"{info['path']} in {info['seconds']:.2f} s "
                     f"(built={info['built']})")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("build", "ptxas: " + line.strip())
    # the tensor-core kernels: every instantiation (flash: one per padded
    # head dim and dropout build; the loss kernels: one per feature chunk
    # and coefficient form or keep-mask branch) logged, none may spill
    report, spills = {}, []
    for source in ("flash_fwd.cu", "flash_bwd.cu", *LOSS_MMA_KERNELS):
        report.update(ptxas_report(_build.build_info[source]["log"]))
    for kernel, want in (*((k, 18) for k in MMA_KERNELS),
                         *(k for kernels in LOSS_MMA_KERNELS.values() for k in kernels)):
        found = {name: r for name, r in report.items() if kernel in name}
        check(len(found) == want, f"ptxas reported {len(found)} instantiations "
                                  f"of {kernel}, want {want}")
        for name, r in sorted(found.items(), key=lambda x: template_args(x[0])):
            args = ", ".join(map(str, template_args(name)))
            log("build", f"{kernel}<{args}>: {r.get('registers')} "
                         f"registers, spill stores {r.get('spill_stores')} B, "
                         f"spill loads {r.get('spill_loads')} B")
            allowed = SPILL_ALLOWED.get((kernel, template_args(name)[0]), 0)
            stores, loads = r.get("spill_stores"), r.get("spill_loads")
            if stores is None or loads is None or max(stores, loads) > allowed:
                spills.append(f"{kernel}<{args}>: {r}")
    check(not spills, f"spilling instantiations: {spills}")


def ptxas_report(text: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from nvcc's -Xptxas -v output."""
    report, name = {}, None
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
            report.setdefault(name, {})
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            report[name].update(spill_stores=int(spill.group(1)),
                                spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            report[name]["registers"] = int(regs.group(1))
    return report


def template_args(mangled: str) -> tuple:
    """The int and bool template arguments of a tensor-core kernel's name,
    in order: (padded head dim, dropout build), (features per warp,
    factored or pruned) or (features per chunk,)."""
    found = re.search(r"I((?:L[ib]\d+E)+)E", mangled)
    return tuple(int(x) if kind == "i" else bool(int(x))
                 for kind, x in re.findall(r"L([ib])(\d+)E", found.group(1)))


def ragged_mask(b: int, s: int, gen: torch.Generator) -> torch.Tensor:
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None]).float()
    mask[-1] = 0.0  # one batch entry with no valid key
    return mask


def qkv(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    return q, k, v, ragged_mask(shape[0], shape[2], gen)


def compare(fa, q, k, v, mask, tag: str, phase: str = "kernel", **drop) -> float:
    with torch.inference_mode():
        out, lse = fa.flash_attention_fwd(q, k, v, mask, **drop)
        ref, ref_lse = fa.mha_reference(q, k, v, mask, return_lse=True, **drop)
    torch.cuda.synchronize()
    atol, rtol, lse_atol = LIMITS[q.dtype]
    diff = (out.float() - ref.float()).abs()
    out_err = diff.max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    log(phase, f"{tag}: max|out-plain| {out_err:.3e} (atol {atol}, rtol "
               f"{rtol}), max|lse-plain| {lse_err:.3e} (atol {lse_atol})")
    check(bool(torch.isfinite(out.float()).all()), f"{tag}: non-finite output")
    check(bool((diff <= atol + rtol * ref.float().abs()).all()),
          f"{tag}: output outside the limit")
    check(lse_err <= lse_atol, f"{tag}: lse outside the limit")
    check(bool((out[-1] == 0).all()), f"{tag}: fully masked entry not zero")
    check(bool((lse[-1] == fa.MAX_FLOOR).all()), f"{tag}: fully masked lse")
    return out_err


def median_ms(fn, n: int = 20, grad: bool = False, warmup: int = 3) -> float:
    with contextlib.nullcontext() if grad else torch.inference_mode():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(fa, smi: str) -> float:
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for s in (64, 96, 37):
            q, k, v, mask = qkv((4, 8, s, 48), dtype, seed=s)
            worst = max(worst, compare(fa, q, k, v, mask,
                                       f"{str(dtype)[6:]} S={s}"))
    q, k, v, mask = qkv(SERVE_SHAPE, torch.bfloat16, seed=1)
    worst = max(worst, compare(fa, q, k, v, mask, "bfloat16 serve shape"))
    ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v, mask))
    plain_ms = median_ms(lambda: fa.mha_reference(q, k, v, mask))
    log("kernel", f"B,H,S,Dh={SERVE_SHAPE} bf16: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (median of 20; {smi})")
    return max(worst, mla_leg(fa, smi))


# latent attention (the Moonlight text tower's): B, H, S of one GradCache
# chunk, query/key and value widths; its gradients within MLA_GRAD_REL of
# their largest entry (bf16 outputs of sums over S keys)
MLA_SHAPE, MLA_WIDTHS, MLA_GRAD_REL = (128, 16, 96), (192, 128), 2e-2


def mla_leg(fa, smi: str) -> float:
    """The flash kernels at latent attention's widths (values zero-padded
    to the query/key width inside ``flash_attention``) against autograd
    through the plain version; returns the forward's worst error."""
    (b, h, s), (dqk, dv) = MLA_SHAPE, MLA_WIDTHS
    gen = torch.Generator(device="cuda").manual_seed(192)
    q, k = (torch.randn(b, h, s, dqk, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn(b, h, s, dv, generator=gen, device="cuda").to(torch.bfloat16)
    mask = ragged_mask(b, s, gen)
    g = torch.randn(b, h, s, dv, generator=gen, device="cuda").to(torch.bfloat16)
    got = attention_grads(fa.flash_attention, q, k, v, mask, g)
    want = attention_grads(fa.mha_reference, q.float(), k.float(), v.float(), mask, g)
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v, mask)
        ref = fa.mha_reference(q.float(), k.float(), v.float(), mask)
    atol, rtol, _ = LIMITS[torch.bfloat16]
    diff = (out.float() - ref).abs()
    check(bool((diff <= atol + rtol * ref.abs()).all()),
          "MLA widths: output outside the limit")
    check(bool((out[-1] == 0).all()), "MLA widths: fully masked entry not zero")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = (a.float() - w).abs().max().item()
        top = w.abs().max().item()
        log("kernel", f"MLA widths {name}: max|kernel-plain| {err:.3e} of largest "
                      f"{top:.3e} (limit {MLA_GRAD_REL} of it)")
        check(err <= MLA_GRAD_REL * top, f"MLA widths: {name} outside the limit")
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ms = median_ms(lambda: fa.flash_attention(q, k, v, mask))

    def step():
        out = fa.flash_attention(*leaves, mask)
        torch.autograd.grad(out, leaves, g)

    both_ms = median_ms(step, grad=True)
    log("kernel", f"B,H,S={MLA_SHAPE} qk/v {dqk}/{dv} bf16: max|out-plain| "
                  f"{diff.max().item():.3e}; forward {ms:.4f} ms, forward + "
                  f"backward {both_ms:.4f} ms (median of 20; {smi})")
    return diff.max().item()


# ---------------------------------------------------------------------------
# attention dropout and the flash backward (training the transformer towers)
# ---------------------------------------------------------------------------


def attention_grads(fn, q, k, v, mask, g, **drop):
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v, mask, **drop)
    (out.float() * g.float()).sum().backward()
    return q.grad, k.grad, v.grad


def attention_check_phase(fa) -> dict:
    """The forward with dropout, the exact keep mask and the backward
    kernels against the plain version; returns each flash kernel's worst
    absolute error."""
    worst = dict.fromkeys(fa.KERNELS, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        for s in (64, 96, 37):
            q, k, v, mask = qkv((4, 8, s, 48), dtype, seed=100 + s)
            for rate in (0.1, 0.5):
                # S=37 sits at nonzero offsets, as a ring block would, and
                # its 8 heads are heads 8-15 of 16, as a tensor-parallel
                # rank's are
                offsets = (dict(q_offset=5, k_offset=70, bh_offset=32,
                                head_count=16, head_offset=8)
                           if s == 37 else {})
                tag = (f"{str(dtype)[6:]} S={s} dropout {rate}"
                       + (f" at {offsets}" if offsets else ""))
                err = compare(fa, q, k, v, mask, tag, "attention",
                              dropout_rate=rate, dropout_seed=977 * s, **offsets)
                worst["flash_fwd"] = max(worst["flash_fwd"], err)

    # q = k = 0 and v = I: each valid key has probability 1/n_valid, so
    # out · n_valid · (1 − r) is the keep mask itself, entry for entry; and
    # with dO = I, dv = P̂ᵀ, so dv · n_valid · (1 − r) is its transpose
    rate = 0.3
    for dtype in (torch.float32, torch.bfloat16):
        for s in (64, 96):
            keep_mask_check(fa, dtype, s, rate)
            keep_mask_check(fa, dtype, s, rate, split=2)
    repeat_launch_check(fa)
    for dtype in (torch.float32, torch.bfloat16):
        for s in (64, 96, 37):
            q, k, v, mask = qkv((4, 8, s, 48), dtype, seed=200 + s)
            gen = torch.Generator(device="cuda").manual_seed(300 + s)
            g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            for rate in (0.0, 0.1):
                drop = dict(dropout_rate=rate, dropout_seed=31 * s)
                got = attention_grads(fa.flash_attention, q, k, v, mask, g, **drop)
                want = attention_grads(fa.mha_reference, q, k, v, mask, g, **drop)
                errs = check_grads(got, want, worst, f"{dtype} S={s} dropout {rate}")
                log("attention", f"{str(dtype)[6:]} S={s} dropout {rate}: "
                                 f"max|kernel-autograd(plain)| dq {errs[0]:.3e}, "
                                 f"dk {errs[1]:.3e}, dv {errs[2]:.3e}")
    return worst


def keep_mask_check(fa, dtype, s: int, rate: float, split: int = 1) -> None:
    """The keep mask read back exactly through the forward's output and
    through dv, at Dh = S.  With ``split`` > 1 the launch holds the last
    8 / split heads of 8 (``head_count``, ``head_offset``) of a second data
    shard's rows (``bh_offset``), as a tensor-parallel rank does: its mask
    is that slice of the whole mask."""
    b, h, seed = 2, 8, 4242 + s
    hl = h // split
    place = {} if split == 1 else dict(head_count=h, head_offset=h - hl,
                                       bh_offset=b * h)
    zeros = torch.zeros(b, hl, s, s, device="cuda", dtype=dtype)
    eye = torch.eye(s, device="cuda", dtype=dtype).expand(b, hl, s, s).contiguous()
    mask = torch.ones(b, s, device="cuda")
    mask[1, s // 3:] = 0.0
    drop = dict(dropout_rate=rate, dropout_seed=seed, **place)
    with torch.inference_mode():
        out, lse = fa.flash_attention_fwd(zeros, zeros, eye, mask, **drop)
        delta = torch.zeros(b, hl, s, device="cuda")  # dv does not read it
        _, dv = fa.flash_dkv_cuda(zeros, zeros, zeros, mask, lse, delta, eye, **drop)
    n_scale = mask.sum(dim=1)[:, None, None, None] * (1 - rate)
    keep = fa.dropout_keep_mask(b, h, s, seed, rate, bh_offset=place.get("bh_offset", 0),
                                device="cuda")[:, h - hl:]
    want = (keep & mask.bool()[:, None, None, :]).float()
    for what, got, expect in (("forward", out.float() * n_scale, want),
                              ("dv", dv.float() * n_scale, want.transpose(-1, -2))):
        off = (got - expect).abs().max().item()
        check(torch.equal(torch.round(got), expect) and off < KEEP_OFF[dtype],
              f"{dtype} S={s}: the keep mask through the {what} differs from "
              f"dropout_keep_mask (max |x·n·(1−r) − keep| {off:.3e})")
        log("attention", f"keep mask recovered exactly through the {what}, "
                         f"{str(dtype)[6:]} S=Dh={s}, rate {rate}"
                         + (f", heads {h - hl}-{h - 1} of {h} at bh_offset "
                            f"{b * h}" if split > 1 else "")
                         + f": kept {want[0].mean().item():.4f} of entry 0, max "
                         f"|x·n·(1−r) − keep| {off:.2e} (limit {KEEP_OFF[dtype]:.2e})")


def repeat_launch_check(fa) -> None:
    """Two launches of each flash kernel on the same inputs give the same
    bits (one writer per output row, a fixed order of sums)."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, mask = qkv((4, 8, 96, 48), dtype, seed=11)
        gen = torch.Generator(device="cuda").manual_seed(12)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        drop = dict(dropout_rate=LEG_DROPOUT, dropout_seed=13)
        runs = []
        with torch.inference_mode():
            for _ in range(2):
                out, lse = fa.flash_attention_fwd(q, k, v, mask, **drop)
                delta = (g.float() * out.float()).sum(dim=-1)
                ops = (q, k, v, mask, lse, delta, g)
                runs.append((out, lse, fa.flash_dq_cuda(*ops, **drop),
                             *fa.flash_dkv_cuda(*ops, **drop)))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"{dtype}: two launches on the same inputs differ")
        log("attention", f"{str(dtype)[6:]} B=4 S=96 dropout {LEG_DROPOUT}: two "
                         "launches of flash_fwd, flash_dq and flash_dkv give the "
                         "same bits")


def check_grads(got, want, worst: dict, tag: str) -> list[float]:
    """dq, dk, dv of the kernels against the plain version's within the
    limits of their dtype (the fully masked entry's exactly 0); folds each
    error into ``worst`` and returns the three."""
    torch.cuda.synchronize()
    errs = []
    for name, a, w in zip(("flash_dq", "flash_dkv", "flash_dkv"), got, want):
        err = (a.float() - w.float()).abs().max().item()
        if a.dtype == torch.float32:
            ok = err <= FLASH_GRAD_BOUND * w.abs().max().item()
        else:
            ok = bool(((a.float() - w.float()).abs() <= FLASH_BF16_TOL
                       + FLASH_BF16_TOL * w.float().abs()).all())
        check(ok and a.dtype == w.dtype and bool(torch.isfinite(a.float()).all())
              and bool((a[-1] == 0).all()),
              f"{tag}: {name} outside the limit (max err {err:.3e})")
        worst[name] = max(worst[name], err)
        errs.append(err)
    return errs


def plain_backward(fa, q, k, v, mask, g, drop: dict, out=None, lse=None):
    """dq, dk, dv of the flash design in plain torch: delta from the
    forward's output in q's dtype (the plain forward's unless ``out`` and
    ``lse`` are given), then the backward kernels' plain versions."""
    with torch.inference_mode():
        if out is None:
            out, lse = fa.mha_reference(q, k, v, mask, return_lse=True, **drop)
        delta = (g.float() * out.float()).sum(dim=-1)
        operands = (q, k, v, mask, lse, delta, g)
        return (fa.flash_dq_plain(*operands, **drop),
                *fa.flash_dkv_plain(*operands, **drop)), operands


def leg_shape_check(fa, q, k, v, mask, g, drop: dict, worst: dict, tag: str) -> None:
    """At a transformer leg's shape and dropout: the forward against the
    plain version; dq, dk, dv through autograd against the plain version
    of the same backward; each backward kernel against its plain version
    on the kernel forward's own operands.  Also logs, unchecked, the gap to
    autograd through the fp32 plain attention: delta = rowsum(dO∘out)
    takes the output rounded to bf16, as the JAX package's backward does,
    which on a row with few valid keys exceeds one bf16 ulp of dq."""
    worst["flash_fwd"] = max(worst["flash_fwd"],
                             compare(fa, q, k, v, mask, tag, "attention", **drop))
    got = attention_grads(fa.flash_attention, q, k, v, mask, g, **drop)
    want, _ = plain_backward(fa, q, k, v, mask, g, drop)
    auto = check_grads(got, want, worst, tag + " autograd")
    exact = attention_grads(fa.mha_reference, q, k, v, mask, g, **drop)
    gap = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, exact)]
    del got, want, exact
    with torch.inference_mode():
        out, lse = fa.flash_attention_fwd(q, k, v, mask, **drop)
    want, operands = plain_backward(fa, q, k, v, mask, g, drop, out, lse)
    with torch.inference_mode():
        got = (fa.flash_dq_cuda(*operands, **drop),
               *fa.flash_dkv_cuda(*operands, **drop))
    own = check_grads(got, want, worst, tag + " kernels vs their plain versions")
    log("attention", f"{tag}: max|kernel-plain| through autograd dq "
                     f"{auto[0]:.3e}, dk {auto[1]:.3e}, dv {auto[2]:.3e}; each "
                     f"kernel on its own operands dq {own[0]:.3e}, dk "
                     f"{own[1]:.3e}, dv {own[2]:.3e} (atol = rtol = "
                     f"{FLASH_BF16_TOL}); unchecked gap to autograd through "
                     f"the fp32 plain attention dq {gap[0]:.3e}, dk {gap[1]:.3e}, "
                     f"dv {gap[2]:.3e}")


def attention_bounds(b: int, s: int, mask, dtype, h: int = 8, dh: int = 48) -> dict:
    """Each flash kernel's least time on the card from this run's inputs:
    each input read once and each output written once, over the memory
    rate, or its products over the valid (query, key) pairs at the peak
    of its operands' type, whichever is larger."""
    tensor = b * h * s * dh * torch.tensor([], dtype=dtype).element_size()
    row = b * h * s * 4  # an fp32 [B, H, S] vector: lse or delta
    mask_bytes = b * s * 4
    pairs = h * s * mask.sum().item()  # every query row x its valid keys
    work = {  # (bytes, flops)
        "flash_fwd": (4 * tensor + row + mask_bytes, 2 * 2 * pairs * dh),
        "flash_dq": (5 * tensor + 2 * row + mask_bytes, 3 * 2 * pairs * dh),
        "flash_dkv": (6 * tensor + 2 * row + mask_bytes, 4 * 2 * pairs * dh),
    }
    return {name: bound(nbytes, flops, dtype) for name, (nbytes, flops) in work.items()}


def bound(nbytes: float, flops: float, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_timing_phase(fa, smi: str, worst: dict) -> dict:
    """At the transformer leg's shapes first :func:`leg_shape_check`, its
    errors folded into ``worst``; then the flash kernels (both builds:
    dropout 0 and the leg's 0.1), their plain versions and torch's
    scaled_dot_product_attention at the slice's shapes (bf16, H=8, Dh=48).
    Returns {(name, B, S): ms}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    drop = dict(dropout_rate=LEG_DROPOUT, dropout_seed=5)
    for b, s in ATTENTION_TIMING:
        q, k, v, mask = qkv((b, 8, s, 48), torch.bfloat16, seed=7)
        gen = torch.Generator(device="cuda").manual_seed(8)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        if b == LEG_BATCH:  # a shape the transformer leg launches
            leg_shape_check(fa, q, k, v, mask, g, drop, worst,
                            f"bfloat16 B={b} S={s} dropout {LEG_DROPOUT}")
        mask[-1, 0] = 1.0  # every entry has a valid key (SDPA would give NaN)
        with torch.inference_mode():
            out, lse = fa.flash_attention_fwd(q, k, v, mask)
            delta = (g.float() * out.float()).sum(dim=-1)
            out_d, lse_d = fa.flash_attention_fwd(q, k, v, mask, **drop)
            delta_d = (g.float() * out_d.float()).sum(dim=-1)
        ops = (q, k, v, mask, lse, delta, g)
        ops_d = (q, k, v, mask, lse_d, delta_d, g)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        key_mask = mask.bool()[:, None, None, :]
        plain_out = fa.mha_reference(*leaves, mask)
        sdpa_out = sdpa(*leaves, attn_mask=key_mask)
        fns = {
            "flash_fwd": lambda: fa.flash_attention_fwd(q, k, v, mask),
            "flash_fwd dropout": lambda: fa.flash_attention_fwd(q, k, v, mask, **drop),
            "flash_dq": lambda: fa.flash_dq_cuda(*ops),
            "flash_dq dropout": lambda: fa.flash_dq_cuda(*ops_d, **drop),
            "flash_dkv": lambda: fa.flash_dkv_cuda(*ops),
            "flash_dkv dropout": lambda: fa.flash_dkv_cuda(*ops_d, **drop),
            "plain fwd": lambda: fa.mha_reference(q, k, v, mask),
            "plain fwd dropout": lambda: fa.mha_reference(q, k, v, mask, **drop),
            "plain dq dropout": lambda: fa.flash_dq_plain(*ops_d, **drop),
            "plain dkv dropout": lambda: fa.flash_dkv_plain(*ops_d, **drop),
            "sdpa fwd": lambda: sdpa(q, k, v, attn_mask=key_mask),
        }
        grad_fns = {
            "flash fwd+bwd": lambda: fa.flash_attention(*leaves, mask).backward(g),
            "flash fwd+bwd dropout": lambda: fa.flash_attention(
                *leaves, mask, **drop).backward(g),
            "plain bwd": lambda: torch.autograd.grad(plain_out, leaves, g,
                                                     retain_graph=True),
            "plain fwd+bwd": lambda: fa.mha_reference(*leaves, mask).backward(g),
            "sdpa bwd": lambda: torch.autograd.grad(sdpa_out, leaves, g,
                                                    retain_graph=True),
            "sdpa fwd+bwd": lambda: sdpa(*leaves, attn_mask=key_mask).backward(g),
        }
        for name, fn in fns.items():
            times[(name, b, s)] = median_ms(fn)
        for name, fn in grad_fns.items():
            times[(name, b, s)] = median_ms(fn, grad=True)
        del plain_out, sdpa_out
        bounds = attention_bounds(b, s, mask, torch.bfloat16)
        times[("bounds", b, s)] = bounds
        log("attention", f"B={b} S={s} H=8 Dh=48 bf16, ms (median of 20): "
            + ", ".join(f"{name} {times[(name, b, s)]:.4f}"
                        for name in (*fns, *grad_fns))
            + "; bounds " + ", ".join(f"{n} {x['bound_ms']:.4f} ({x['bound_by']})"
                                      for n, x in bounds.items())
            + f" ({smi})")
    return times


class ParentLossLibrary:
    """Another revision's fused_dual.cu or fused_global.cu library, called
    as this checkout's wrapper calls it.  Where that revision's entry point
    takes no scratch (crossclr_sym_bwd before it split its candidates,
    crossclr_sym_fwd and crossclr_dual_bwd before theirs did,
    crossclr_dual_fwd and crossclr_rows_bwd_rows before theirs did,
    crossclr_rows_lse and crossclr_rows_bwd_cols before theirs did), the
    scratch argument is dropped and the size query answers 0; its
    crossclr_dual_bwd_partials took n alone; a revision before the Hopper
    sym backward never takes it (crossclr_sym_bwd_wgmma answers 0)."""

    # entry point: (its scratch-size query, the index of its scratch argument)
    SPLITS = {"crossclr_sym_fwd": ("crossclr_sym_fwd_scratch", 7),
              "crossclr_dual_fwd": ("crossclr_dual_fwd_scratch", 8),
              "crossclr_sym_bwd": ("crossclr_sym_bwd_scratch", 11),
              "crossclr_dual_bwd": ("crossclr_dual_bwd_scratch", 12),
              "crossclr_rows_lse": ("crossclr_rows_lse_scratch", 8),
              "crossclr_rows_bwd_rows": ("crossclr_rows_bwd_rows_scratch", 11),
              "crossclr_rows_bwd_cols": ("crossclr_rows_bwd_cols_scratch", 11)}

    def __init__(self, lib):
        self.lib = lib
        self.unsplit = {name for name, (query, _) in self.SPLITS.items()
                        if not hasattr(lib, query)}

    @classmethod
    def argtypes(cls, lib, name: str, argtypes: list):
        """The argtypes of ``name`` in ``lib``, None where it lacks it."""
        split = {query: entry for entry, (query, _) in cls.SPLITS.items()}
        if name in split and not hasattr(lib, name):
            return None
        if name in cls.SPLITS and not hasattr(lib, cls.SPLITS[name][0]):
            index = cls.SPLITS[name][1]
            return argtypes[:index] + argtypes[index + 1:]
        if name == "crossclr_dual_bwd_partials" and not hasattr(
                lib, "crossclr_dual_bwd_scratch"):
            return argtypes[1:2]
        if name == "crossclr_sym_bwd_wgmma" and not hasattr(lib, name):
            return None
        return argtypes

    def __getattr__(self, name):
        fn = getattr(self.lib, name, None)
        if name in self.SPLITS and name in self.unsplit:
            index = self.SPLITS[name][1]
            return lambda *args: fn(*args[:index], *args[index + 1:])
        if fn is None and name.endswith("_scratch"):
            return lambda *_: 0
        if fn is None and name == "crossclr_sym_bwd_wgmma":
            return lambda *_: 0  # a revision before the Hopper sym backward
        if name == "crossclr_dual_bwd_partials" and "crossclr_dual_bwd" in self.unsplit:
            return lambda dtype, n, d, pruned: fn(n)
        if fn is None:
            raise AttributeError(name)
        return fn


class HeadlessFlashLibrary:
    """Another revision's flash library from before the dropout words
    carried a head count and offset, called as this checkout's wrapper
    calls it: the two head words (the launch's own heads and offset 0 on
    every call the baseline compares) are dropped before the stream."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name.startswith("crossclr_flash_"):
            return lambda *args: fn(*args[:-3], args[-1])
        return fn


def build_baseline(fa, fc, fd, fg, csrc: Path, out_dir: Path) -> dict:
    """Build another revision's flash, per-direction, loss-pair and rows
    sources (``csrc`` holds its flash_fwd.cu, flash_bwd.cu,
    fused_crossclr.cu, fused_dual.cu, fused_global.cu and their headers)
    with this build's nvcc flags, one nvcc each, started together; returns
    {source: library} with the launchers' signatures set."""
    import ctypes

    from crossclr_tpu_torch.ops import _build

    signatures = {**fa._SIGNATURES, fc.SOURCE: fc._SIGNATURES,
                  fd.SOURCE: fd._SIGNATURES, fg.SOURCE: fg._SIGNATURES}
    queries = {*fd._SIZE_QUERIES, *fg._SIZE_QUERIES}
    procs = {}
    for source in signatures:
        so = out_dir / f"baseline_{source[:-3]}.so"
        procs[source] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for source, (so, proc) in procs.items():
        text = proc.communicate()[0]
        check(proc.returncode == 0, f"baseline {csrc / source} did not build:\n{text}")
        lib = ctypes.CDLL(str(so))
        adapted = source in (fd.SOURCE, fg.SOURCE)
        # a revision before the head words: no head_count, head_offset
        headless = (source in fa._SIGNATURES
                    and "head_offset" not in (csrc / "flash_common.cuh").read_text())
        for name, argtypes in signatures[source].items():
            if adapted:
                argtypes = ParentLossLibrary.argtypes(lib, name, argtypes)
                if argtypes is None:
                    continue
            if headless:
                argtypes = argtypes[:-3] + argtypes[-1:]
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = (
                ctypes.c_longlong if name in queries and len(argtypes) >= 4
                else ctypes.c_int)
        # fused_global.cu names its error string function apart
        for name in ("crossclr_cuda_error_string", "crossclr_rows_error_string"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = [ctypes.c_int]
                getattr(lib, name).restype = ctypes.c_char_p
        libs[source] = (ParentLossLibrary(lib) if adapted
                        else HeadlessFlashLibrary(lib) if headless else lib)
    return libs


def same_bits(new, old, tag: str, must: bool) -> None:
    """Log how far this checkout's outputs lie from the baseline's; with
    ``must``, fail unless they are equal bit for bit."""
    new, old = (x if isinstance(x, tuple) else (x,) for x in (new, old))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(new, old))
    diff = max((x.float() - y.float()).abs().max().item() for x, y in zip(new, old))
    log("baseline", f"{tag}: max |this − baseline| {diff:.3e}, bit for bit {same}"
                    + ("" if must else " (redesigned: held to plain, not to the "
                                       "baseline)"))
    if must:
        check(same, f"{tag}: differs from the baseline build")


def turns(fn, baseline, n: int, warmup: int, grad: bool = False) -> tuple[list, list]:
    """``fn`` timed in turns, baseline, this, this, baseline (median of
    ``n`` each): ([this, this], [baseline, baseline])."""
    with baseline():
        old_1 = median_ms(fn, n=n, grad=grad, warmup=warmup)
    new = [median_ms(fn, n=n, grad=grad, warmup=warmup) for _ in range(2)]
    with baseline():
        old_2 = median_ms(fn, n=n, grad=grad, warmup=warmup)
    return new, [old_1, old_2]


def baseline_phase(fa, fc, fd, fg, smi: str, csrc: Path) -> dict:
    """The flash, per-direction, loss-pair and rows kernels of this
    checkout against those built from ``csrc`` on the same operands: bit
    for bit wherever this checkout kept the design (every fp32 output, the
    bf16 flash kernels, lse_fwd and lse_bwd in both tiers, sym_fwd,
    dual_fwd, sym_bwd and dual_bwd in both tiers, pruned and not, and
    rows_bwd_rows in both tiers); the redesigned bf16 builds of REDESIGNED
    only logged.
    Then, at the transformer leg's shapes (B=1024, S in {96, 64}, H=8,
    Dh=48, bf16, dropout 0 and the leg's 0.1), each flash kernel timed in
    turns, baseline, this checkout, this checkout, baseline (CUDA events,
    median of 20 each), beside its plain version, SDPA and its bound; bf16
    lse_fwd and lse_bwd timed the same way at 4096 x 256 (median of 20,
    beside the plain version) and at the leg's 65,536 x 256 (median of 3),
    beside the bound; bf16 sym_fwd, dual_fwd, sym_bwd and dual_bwd at the
    MLP leg's 1024 x 256 and, pruned, at the full-CrossCLR leg's 1024 x 384,
    dual_fwd also at the headline 4096 x 512, and the bf16 rows kernels at
    1024 x 384 and at one rank's block (RANK_SHAPE), pruned (median of 20),
    beside their plain versions and bounds."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records = {"flash": [], "direction": [], "loss": [], "rows": []}
    with tempfile.TemporaryDirectory(prefix="crossclr_baseline_") as tmp:
        libs = build_baseline(fa, fc, fd, fg, csrc, Path(tmp))
        flash_base = lambda: mock.patch.object(fa, "_library", libs.__getitem__)  # noqa: E731
        dir_base = lambda: mock.patch.object(fc, "_library", lambda: libs[fc.SOURCE])  # noqa: E731
        pair_base = lambda: mock.patch.object(fd, "_library", lambda: libs[fd.SOURCE])  # noqa: E731
        rows_base = lambda: mock.patch.object(fg, "_library", lambda: libs[fg.SOURCE])  # noqa: E731
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = qkv((LEG_BATCH, 8, 96, 48), dtype, seed=21)
            gen = torch.Generator(device="cuda").manual_seed(22)
            g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            drop = dict(dropout_rate=LEG_DROPOUT, dropout_seed=23)
            with torch.inference_mode():
                out, lse = fa.flash_attention_fwd(q, k, v, mask, **drop)
                ops = (q, k, v, mask, lse, (g.float() * out.float()).sum(dim=-1), g)
                fns = {"flash_fwd": lambda: fa.flash_attention_fwd(q, k, v, mask, **drop),
                       "flash_dq": lambda: fa.flash_dq_cuda(*ops, **drop),
                       "flash_dkv": lambda: fa.flash_dkv_cuda(*ops, **drop)}
                for name, fn in fns.items():
                    new = fn()
                    with flash_base():
                        old = fn()
                    same_bits(new, old, f"{name} {str(dtype)[6:]} B={LEG_BATCH} S=96 "
                                        f"dropout {LEG_DROPOUT}", True)
        b, d = DIRECTION_TIMING
        v32, t32, g_v, g_t = loss_inputs(b, d, seed=24)
        for tier in ("highest", "default"):
            v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
            for tau in DIRECTION_TAUS:
                s = 1.0 / tau
                fwd = lambda: (fc.lse_fwd_cuda(v, t, s, NEG_WEIGHT),  # noqa: E731
                               fc.lse_fwd_cuda(t, v, s, NEG_WEIGHT))
                new = fwd()
                with dir_base():
                    old = fwd()
                tag = f"B={b} D={d} {tier} τ={tau:.6g} w={NEG_WEIGHT}"
                same_bits(new, old, f"lse_fwd {tag}", True)
                bwd = lambda: fc.lse_bwd_cuda(v, t, *new, g_v, g_t, s, NEG_WEIGHT)  # noqa: E731
                grad = bwd()
                with dir_base():
                    old = bwd()
                same_bits(grad, old, f"lse_bwd {tag}", True)
        # the loss pair: the MLP leg's shape and the full-CrossCLR leg's,
        # each unpruned and with keep masks; sym at τ = 0.03, dual at a
        # tensor τ of 0.03
        for b, d in (SLICE_LOSS_SHAPE, PRUNED_TIMING[0]):
            v32, t32, g_v, g_t = loss_inputs(b, d, seed=25)
            for keep in ((), keep_masks(v32, t32)):
                for tier in ("highest", "default"):
                    v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
                    s = 1.0 / 0.03
                    scale = torch.full((1,), s, device="cuda")
                    lse = fd.sym_fwd_plain(v, t, s, NEG_WEIGHT, *keep)
                    fns = {
                        "sym_fwd": lambda: fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT, *keep),
                        "sym_bwd": lambda: fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s,
                                                           NEG_WEIGHT, *keep),
                        "dual_fwd": lambda: fd.dual_fwd_cuda(v, t, scale, NEG_WEIGHT,
                                                             *keep),
                        "dual_bwd": lambda: fd.dual_bwd_cuda(v, t, scale, *lse, g_v,
                                                             g_t, NEG_WEIGHT, *keep),
                    }
                    for name, fn in fns.items():
                        new = fn()
                        with pair_base():
                            old = fn()
                        same_bits(new, old, f"{name} B={b} D={d} {tier}"
                                            + (" pruned" if keep else ""),
                                  name not in REDESIGNED or tier == "highest")
        # the rows kernels at the full-CrossCLR leg's shape, 1024 anchors
        # against their own batch, pruned and not
        b, d = GLOBAL_TIMING[0]
        v32, t32, masks, g = rows_inputs(b, d, seed=26)
        scale = torch.full((1,), 1.0 / 0.03, device="cuda")
        for keep in ((None, None), (masks[1], masks[0])):
            for tier in ("highest", "default"):
                v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
                args = (v, v, t, 0, scale, NEG_WEIGHT, *keep)
                lse = fg.rows_lse_plain(*args)
                bargs = (*args[:5], lse, g, NEG_WEIGHT, *keep)
                fns = {"rows_lse": lambda: fg.rows_lse_cuda(*args),
                       "rows_bwd_rows": lambda: fg.rows_bwd_rows_cuda(*bargs),
                       "rows_bwd_cols": lambda: fg.rows_bwd_cols_cuda(*bargs)}
                for name, fn in fns.items():
                    new = fn()
                    with rows_base():
                        old = fn()
                    same_bits(new, old, f"{name} B={b} D={d} {tier}"
                                        + (" pruned" if keep[0] is not None else ""),
                              name not in REDESIGNED or tier == "highest")
        for b, s in ATTENTION_TIMING[:2]:
            q, k, v, mask = qkv((b, 8, s, 48), torch.bfloat16, seed=7)
            mask[-1, 0] = 1.0  # every entry has a valid key (SDPA would give NaN)
            gen = torch.Generator(device="cuda").manual_seed(8)
            g = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
            key_mask = mask.bool()[:, None, None, :]
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            sdpa_out = sdpa(*leaves, attn_mask=key_mask)
            library = {
                "flash_fwd": median_ms(lambda: sdpa(q, k, v, attn_mask=key_mask)),
                "sdpa_bwd": median_ms(lambda: torch.autograd.grad(
                    sdpa_out, leaves, g, retain_graph=True), grad=True),
            }
            del sdpa_out
            bounds = attention_bounds(b, s, mask, torch.bfloat16)
            for rate in (0.0, LEG_DROPOUT):
                drop = dict(dropout_rate=rate, dropout_seed=5)
                with torch.inference_mode():
                    out, lse = fa.flash_attention_fwd(q, k, v, mask, **drop)
                    ops = (q, k, v, mask, lse,
                           (g.float() * out.float()).sum(dim=-1), g)
                fns = {
                    "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v, mask, **drop),
                                  lambda: fa.mha_reference(q, k, v, mask, **drop)),
                    "flash_dq": (lambda: fa.flash_dq_cuda(*ops, **drop),
                                 lambda: fa.flash_dq_plain(*ops, **drop)),
                    "flash_dkv": (lambda: fa.flash_dkv_cuda(*ops, **drop),
                                  lambda: fa.flash_dkv_plain(*ops, **drop)),
                }
                for name, (fn, plain) in fns.items():
                    new, old = turns(fn, flash_base, 20, 3)
                    record = {
                        "name": name, "B": b, "S": s, "dropout": rate,
                        "ms": new, "baseline_ms": old,
                        "plain_ms": median_ms(plain), **bounds[name],
                        "library_ms": library.get(name, library["sdpa_bwd"]),
                    }
                    records["flash"].append(record)
                    log("baseline", f"{name} B={b} S={s} bf16 dropout {rate}: "
                                    f"{new[0]:.4f} / {new[1]:.4f} ms, baseline "
                                    f"{old[0]:.4f} / {old[1]:.4f}, plain "
                                    f"{record['plain_ms']:.4f}, SDPA "
                                    f"{record['library_ms']:.4f}"
                                    f"{'' if name == 'flash_fwd' else ' (whole bwd)'}, "
                                    f"bound {record['bound_ms']:.4f} "
                                    f"({record['bound_by']}) ({smi})")
        s = 1.0 / 0.03
        for (b, d), n in ((DIRECTION_TIMING, 20), ((PODSLICE_BATCH, 256), 3)):
            v32, t32, g_v, g_t = loss_inputs(b, d, seed=3)
            v, t = (x.contiguous() for x in fd._fetch_cast("default", v32, t32))
            del v32, t32
            lse = (fc.lse_fwd_cuda(v, t, s, NEG_WEIGHT), fc.lse_fwd_cuda(t, v, s, NEG_WEIGHT))
            args = (v, t, *lse, g_v, g_t, s, NEG_WEIGHT)
            bounds = direction_bounds(b, d)
            pairs = {"lse_fwd": (lambda: fc.lse_fwd_cuda(v, t, s, NEG_WEIGHT),
                                 lambda: fc.lse_fwd_plain(v, t, s, NEG_WEIGHT)),
                     "lse_bwd": (lambda: fc.lse_bwd_cuda(*args),
                                 lambda: fc.lse_bwd_plain(*args))}
            for name, (fn, plain) in pairs.items():
                new, old = turns(fn, dir_base, n, 3 if n == 20 else 1)
                plain_ms = median_ms(plain) if n == 20 else None
                record = {"name": name, "B": b, "D": d, "ms": new, "baseline_ms": old,
                          "plain_ms": plain_ms, **bounds[name], "library_ms": None}
                records["direction"].append(record)
                log("baseline", f"{name} B={b} D={d} bf16 operands τ=0.03: "
                                f"{new[0]:.4f} / {new[1]:.4f} ms, baseline {old[0]:.4f} / "
                                f"{old[1]:.4f}, plain "
                                + (f"{plain_ms:.4f}" if plain_ms is not None else
                                   "not timed (its [B, 2B] logits take 34 GB)")
                                + f", bound {record['bound_ms']:.4f} "
                                  f"({record['bound_by']}) (median of {n}; {smi})")
            del v, t, lse, args, pairs
            torch.cuda.empty_cache()
        # the loss pair's bf16 kernels at the MLP leg's shape and, pruned,
        # the full-CrossCLR leg's, and the dual forward at the headline
        # shape: sym at τ = 0.03, dual at a tensor τ of 0.03
        scale = torch.full((1,), s, device="cuda")
        for (b, d), pruned in ((SLICE_LOSS_SHAPE, False), (PRUNED_TIMING[0], True),
                               (HEADLINE_LOSS_SHAPE, False)):
            v32, t32, g_v, g_t = loss_inputs(b, d, seed=3)
            v, t = (x.contiguous() for x in fd._fetch_cast("default", v32, t32))
            keep = keep_masks(v32, t32) if pruned else ()
            lse = fd.sym_fwd_plain(v, t, s, NEG_WEIGHT, *keep)
            sym = (v, t, *lse, g_v, g_t, s, NEG_WEIGHT, *keep)
            dual = (v, t, scale, *lse, g_v, g_t, NEG_WEIGHT, *keep)
            pairs = {
                "sym_fwd": (lambda: fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT, *keep),
                            lambda: fd.sym_fwd_plain(v, t, s, NEG_WEIGHT, *keep)),
                "dual_fwd": (lambda: fd.dual_fwd_cuda(v, t, scale, NEG_WEIGHT, *keep),
                             lambda: fd.dual_fwd_plain(v, t, scale, NEG_WEIGHT, *keep)),
                "sym_bwd": (lambda: fd.sym_bwd_cuda(*sym), lambda: fd.sym_bwd_plain(*sym)),
                "dual_bwd": (lambda: fd.dual_bwd_cuda(*dual),
                             lambda: fd.dual_bwd_plain(*dual)),
            }
            if (b, d) == HEADLINE_LOSS_SHAPE:
                pairs = {"dual_fwd": pairs["dual_fwd"]}
            bounds = loss_bounds(b, d, pruned)
            for name, (fn, plain) in pairs.items():
                new, old = turns(fn, pair_base, 20, 3)
                record = {"name": name, "B": b, "D": d, "pruned": pruned, "ms": new,
                          "baseline_ms": old, "plain_ms": median_ms(plain),
                          **bounds[name], "library_ms": None}
                records["loss"].append(record)
                log("baseline", f"{name} B={b} D={d} bf16 operands τ=0.03"
                                + (f" pruned ({PRUNE})" if pruned else "")
                                + f": {new[0]:.4f} / {new[1]:.4f} ms, baseline "
                                  f"{old[0]:.4f} / {old[1]:.4f}, plain "
                                  f"{record['plain_ms']:.4f}, bound "
                                  f"{record['bound_ms']:.4f} ({record['bound_by']}) "
                                  f"(median of 20; {smi})")
        # kernel 5, the sym backward, where the benchmark's cells run it:
        # podslice_train's 32,768 x 256 (median of 5) and lsmdc_train's
        # 4096 x 384 (median of 20), in turns with the baseline's, beside
        # its bound
        for (b, d), n in (((PODSLICE_CELL_BATCH, 256), 5), ((4096, 384), 20)):
            v32, t32, g_v, g_t = loss_inputs(b, d, seed=3)
            v, t = (x.contiguous() for x in fd._fetch_cast("default", v32, t32))
            del v32, t32
            lse = fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT)
            new, old = turns(lambda: fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s, NEG_WEIGHT),
                             pair_base, n, 2)
            record = {"name": "sym_bwd", "B": b, "D": d, "pruned": False, "ms": new,
                      "baseline_ms": old, "plain_ms": None,
                      **loss_bounds(b, d)["sym_bwd"], "library_ms": None}
            records["loss"].append(record)
            log("baseline", f"sym_bwd B={b} D={d} bf16 operands τ=0.03: "
                            f"{new[0]:.4f} / {new[1]:.4f} ms, baseline {old[0]:.4f} / "
                            f"{old[1]:.4f}, bound {record['bound_ms']:.4f} "
                            f"({record['bound_by']}) (median of {n}; {smi})")
            del v, t, lse
            torch.cuda.empty_cache()
        # the rows kernels at the full-CrossCLR leg's shape (1024 anchors
        # against their own batch) and at one rank's, pruned
        b, d = GLOBAL_TIMING[0]
        for b_loc, b, d, off in ((b, b, d, 0), RANK_SHAPE):
            args, bargs = rank_args(fd, fg, b_loc, b, d, off, seed=3)
            bounds = rows_bounds(b_loc, b, d)
            pairs = {"rows_lse": (lambda: fg.rows_lse_cuda(*args),
                                  lambda: fg.rows_lse_plain(*args)),
                     "rows_bwd_rows": (lambda: fg.rows_bwd_rows_cuda(*bargs),
                                       lambda: fg.rows_bwd_rows_plain(*bargs)),
                     "rows_bwd_cols": (lambda: fg.rows_bwd_cols_cuda(*bargs),
                                       lambda: fg.rows_bwd_cols_plain(*bargs))}
            for name, (fn, plain) in pairs.items():
                new, old = turns(fn, rows_base, 20, 3)
                record = {"name": name, "B_loc": b_loc, "B": b, "D": d, "off": off,
                          "pruned": True, "ms": new, "baseline_ms": old,
                          "plain_ms": median_ms(plain), **bounds[name],
                          "library_ms": None}
                records["rows"].append(record)
                log("baseline", f"{name} b_loc={b_loc} of B={b} D={d} off={off} bf16 "
                                f"operands τ=0.03 pruned ({PRUNE}): {new[0]:.4f} / "
                                f"{new[1]:.4f} ms, baseline {old[0]:.4f} / "
                                f"{old[1]:.4f}, plain {record['plain_ms']:.4f}, bound "
                                f"{record['bound_ms']:.4f} ({record['bound_by']}) "
                                f"(median of 20; {smi})")
            del args, bargs, pairs
        # the reference's headline: the loss fwd+bwd at 4096 x 512 through
        # each route, bf16 operands
        records["headline"] = headline_turns(fd, pair_base, smi)
    return records


def headline_turns(fd, pair_base, smi: str) -> list:
    """The loss fwd+bwd (cross_clr_intra_fused, default tier) at the
    headline shape through the sym route (τ = 0.03) and the dual route (a
    tensor τ of 0.03), in turns against the baseline's loss pair, beside
    the plain pair's fwd+bwd."""
    from crossclr_tpu_torch.ops.fused_crossclr import cross_clr_intra_fused

    b, d = HEADLINE_LOSS_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    video, text = (torch.randn(b, d, generator=gen, device="cuda", requires_grad=True)
                   for _ in range(2))
    tau_leaf = torch.tensor(0.03, device="cuda", requires_grad=True)
    records = []
    for route, tau in (("sym", 0.03), ("dual", tau_leaf)):
        def step():
            cross_clr_intra_fused(video, text, temperature=tau,
                                  negative_weight=NEG_WEIGHT,
                                  precision="default").backward()

        new, old = turns(step, pair_base, 20, 3, grad=True)
        plain_ms = median_ms(lambda: plain_loss(fd, video, text, tau, "default")
                             .backward(), grad=True)
        records.append({"route": route, "B": b, "D": d, "ms": new,
                        "baseline_ms": old, "plain_ms": plain_ms})
        log("baseline", f"loss fwd+bwd, {route} route, default, B={b} D={d}: "
                        f"{new[0]:.4f} / {new[1]:.4f} ms "
                        f"({b / new[0] * 1e3:.0f} pairs/s), baseline {old[0]:.4f} / "
                        f"{old[1]:.4f}, plain {plain_ms:.4f} (median of 20; {smi})")
    return records


def post(url: str, payload: dict, path: str = "/search") -> tuple[int, dict]:
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def get(url: str, path: str) -> tuple[int, dict]:
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def check_result(out: dict, rows: int, k: int, corpus_rows: int) -> None:
    idx, scores = out["indices"], out["scores"]
    check(len(idx) == rows and all(len(r) == k for r in idx), "index shape")
    check(len(scores) == rows and all(len(r) == k for r in scores), "score shape")
    check(all(0 <= i < corpus_rows for r in idx for i in r), "index range")
    for row in scores:
        check(row == sorted(row, reverse=True), "scores not descending")
        check(all(abs(x) <= 1.0 + SCORE_SLACK for x in row), "score outside [-1, 1]")


def slice_phase(fa, smi: str) -> int:
    from crossclr_tpu_torch.data import dataset_from_config
    from crossclr_tpu_torch.eval import _encode_split
    from crossclr_tpu_torch.models import encoders
    from crossclr_tpu_torch.serve import _make_handler, build_service
    from crossclr_tpu_torch.training import TrainState
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(ROOT / "configs/lsmdc_transformer.json"),
                          OVERRIDES)
    reset_counts(fa)  # every count starts here, just before the serving path
    t0 = time.perf_counter()
    service = build_service(cfg, None, "video", random_params=True,
                            device="cuda")
    torch.cuda.synchronize()
    encode_launches = fa.launch_counts["flash_fwd"]
    log("slice", f"build_service (4096 synthetic pairs, both towers encoded) "
                 f"{time.perf_counter() - t0:.2f} s, corpus "
                 f"{tuple(service.corpus_emb.shape)}, kernel launches "
                 f"{encode_launches}")
    check(encode_launches > 0, "corpus encode launched no kernel")
    check(bool(torch.isfinite(service.corpus_emb).all()), "non-finite corpus")

    data, _ = dataset_from_config(cfg.data)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        start = 0
        for rows in (1, 3, 5, 16) * 2:
            before = fa.launch_counts["flash_fwd"]
            status, out = post(url, {
                "features": data.text[start:start + rows].tolist(),
                "mask": data.text_mask[start:start + rows].tolist(), "k": 10,
            })
            check(status == 200, f"/search answered {status}")
            check_result(out, rows, 10, service.corpus_rows)
            check(fa.launch_counts["flash_fwd"] > before,
                  "a search launched no kernel")
            start += rows
        status, health = get(url, "/healthz")
        check(status == 200 and health["corpus_rows"] == 4096, "/healthz")
        status, metrics = get(url, "/metrics")
        check(status == 200 and metrics["search_requests"] == 8
              and metrics["search_errors"] == 0, "/metrics")
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = fa.launch_counts["flash_fwd"]
    check(fa.launch_counts["flash_dq"] == fa.launch_counts["flash_dkv"] == 0,
          f"serving launched a backward kernel: {fa.launch_counts}")
    log("slice", f"8 searches answered; kernel launches in the main path "
                 f"{launches} (corpus encode {encode_launches}); /metrics "
                 f"p50 {metrics['latency_ms']['p50']} ms ({smi})")

    # the same weights through the plain attention, called explicitly
    feats, mask = data.text[:16], data.text_mask[:16]
    plain_model = copy.deepcopy(service.state.model)
    for m in plain_model.modules():
        if isinstance(m, encoders._MHA):
            m.attend = fa.mha_reference
    trainer = service.trainer
    fast = trainer.encode_modality(service.state, "text", feats, mask)
    plain = trainer.encode_modality(TrainState(0, plain_model), "text", feats, mask)
    cos = torch.nn.functional.cosine_similarity(fast, plain, dim=1)
    log("slice", f"query embeddings kernel vs plain attention: min cosine "
                 f"{cos.min().item():.6f} (limit {COSINE_MIN})")
    check(bool((cos >= COSINE_MIN).all()), "kernel path disagrees with plain")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _encode_split(trainer, service.state, data, cfg.data.batch_size)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log("slice", f"corpus encode (video + text towers, batch 1024): "
                 f"{len(data) / seconds:.1f} rows/s over {len(data)} rows ({smi})")
    return launches


class Served:
    """A service behind its HTTP server (serve.ServiceHTTPServer, as
    ``python -m crossclr_tpu_torch.serve`` runs it) on 127.0.0.1:0."""

    def __init__(self, service):
        from crossclr_tpu_torch.serve import ServiceHTTPServer

        self.service = service
        self.httpd = ServiceHTTPServer(("127.0.0.1", 0), service)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.service._batcher is not None:
            self.service._batcher.close()


def search_latencies(send, clients: int, per_client: int) -> list[float]:
    """Seconds of each single-row search ``send(row)``, on its caller's
    clock; ``clients`` threads released together, each sending
    ``per_client`` requests in turn."""
    gate = threading.Barrier(clients, timeout=300)
    out, errors = [], []

    def client(i: int) -> None:
        try:
            gate.wait()
            for j in range(per_client):
                t0 = time.perf_counter()
                send(i * per_client + j)
                out.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        check(not t.is_alive(), "a search client did not finish in 300 s")
    if errors:
        raise errors[0]
    return out


@contextlib.contextmanager
def dataset_once():
    """The synthetic pairs made once for every entry point inside the scope
    (set-up, 14-18 s a time at the transformer legs' size), as a store
    would be read: ``data.dataset_from_config`` memoized, a synthetic
    config by the fields ``SyntheticPairs`` reads (its paths and batch size
    make no other pairs), another by the whole config."""
    from crossclr_tpu_torch import data as data_pkg

    made, make = {}, data_pkg.dataset_from_config

    def once(data_cfg):
        key = data_cfg
        if data_cfg.source == "synthetic":
            key = (data_cfg.num_pairs, data_cfg.video_dim, data_cfg.text_dim,
                   data_cfg.video_seq_len, data_cfg.text_seq_len,
                   data_cfg.variable_lengths, data_cfg.seed)
        if key not in made:
            made[key] = make(data_cfg)
        return made[key]

    with mock.patch.object(data_pkg, "dataset_from_config", once):
        yield once


def serve_checkpoint_phase(fa, smi: str, tmp: Path) -> dict:
    """Serving what the port trains, through the entry points a user
    calls: train.main on the transformer config at full width (flash
    attention, dropout 0.1, EMA) to SERVE_STEPS[0] with a checkpoint;
    eval.main on it (all rows with the embeddings and top-k dumps; the
    held-out rows with --ema); build_service from the checkpoint and 8
    HTTP searches, each launching flash_fwd and no backward kernel; a
    --corpus-emb service on the eval dump under --strict-index; the int8
    index (int32 accumulators against a CPU int32 product bit for bit;
    for text queries and for corpus rows as exact-match queries, every
    score within INT8_SCORE_BOUND of the fp32 index and top-1 kept
    wherever the fp32 margin clears twice the bound); SERVE_CLIENTS
    concurrent clients behind a
    BATCH_WINDOW_MS window against the serial answers; /search latency;
    then train.main resumed to SERVE_STEPS[1] and POST /reload: the step
    advances and the corpus is re-encoded through the kernel.  Every
    count is set to 0 at the start and read at the end.  The checkpoint
    (``tmp / "ckpt"``, at SERVE_STEPS[1]) stays for the aot, shard and
    profile phases; the caller holds the pairs in ``dataset_once``.
    Returns the flash kernels' launches on this path."""
    import numpy as np

    from crossclr_tpu_torch import data as data_pkg
    from crossclr_tpu_torch import eval as teval
    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.evaluation import similarity_matrix
    from crossclr_tpu_torch.evaluation.retrieval import (
        _int8_dot, _quantize_queries, _quantized_sim)
    from crossclr_tpu_torch.serve import build_service
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    config = str(ROOT / TRANSFORMER_CONFIG)
    first, last = SERVE_STEPS
    t_phase = time.perf_counter()
    ckpt = str(tmp / "ckpt")
    overrides = [*SERVE_OVERRIDES, f"checkpoint_dir={ckpt}"]
    cfg = apply_overrides(load_config(config), overrides)
    data, _ = data_pkg.dataset_from_config(cfg.data)
    reset_counts(fa)  # this path's counts start here

    def flash_delta(before: dict) -> dict:
        return {k: fa.launch_counts[k] - before[k] for k in fa.launch_counts}

    t0 = time.perf_counter()
    rc = train.main(["--config", config, "--device", "cuda", "--steps",
                     str(first), "--metrics-csv", str(tmp / "m.csv"), *overrides])
    check(rc == 0, f"train.main exited {rc}")
    log("serve", f"train.main to step {first} with a checkpoint (EMA 0.999): "
                 f"{time.perf_counter() - t0:.2f} s; launches {dict(fa.launch_counts)}")

    # eval: all rows live with the dumps, the held-out rows with --ema
    runs = {}
    for tag, flags in (
        ("all", ["--split", "all", "--embeddings-output", str(tmp / "emb.npz"),
                 "--topk", "10", "--topk-output", str(tmp / "topk.npz")]),
        ("eval_ema", ["--split", "eval", "--ema"]),
    ):
        before = dict(fa.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = teval.main(["--config", config, "--device", "cuda", "--output",
                         str(tmp / f"{tag}.json"), *flags, *overrides])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"eval.main exited {rc}")
        metrics = json.loads((tmp / f"{tag}.json").read_text())
        launched = flash_delta(before)
        check(all(math.isfinite(v) for k, v in metrics.items() if "/" in k),
              f"eval {tag}: metrics {metrics}")
        check(metrics["step"] == first, f"eval {tag}: step {metrics['step']}")
        check(launched["flash_fwd"] > 0 and launched["flash_dq"] == 0
              == launched["flash_dkv"], f"eval {tag}: launches {launched}")
        runs[tag] = (metrics, seconds)
        log("serve", f"eval.main --{tag.replace('_', ' --')}: {metrics['rows']} "
                     f"rows in {seconds:.2f} s ({metrics['rows'] / seconds:.1f} "
                     f"rows/s, the whole CLI call); v2t/R@1 "
                     f"{metrics['v2t/R@1']:.3f} t2v/R@1 {metrics['t2v/R@1']:.3f} "
                     f"MdR {metrics['v2t/MdR']}/{metrics['t2v/MdR']}; launches "
                     f"{launched} ({smi})")
    check(runs["eval_ema"][0].get("ema") is True, "eval --ema not recorded")
    with np.load(tmp / "emb.npz") as z:
        dump = {k: z[k] for k in z.files}
    with np.load(tmp / "topk.npz") as z:
        topk = {k: z[k] for k in z.files}
    check(dump["video"].shape == (len(data), cfg.video_tower.embed_dim)
          and int(dump["step"]) == first
          and not bool(dump["ema"]), "the eval dump's shape, step or flavour")
    check(topk["indices"].shape == (len(data), 10) and np.isfinite(
        topk["scores"]).all(), "the top-k dump")

    # the service from the checkpoint, searched over HTTP
    before = dict(fa.launch_counts)
    t0 = time.perf_counter()
    service = build_service(cfg, ckpt, "video", device="cuda")
    torch.cuda.synchronize()
    encode = flash_delta(before)
    check(service.step == service.index_step == first, "service step")
    check(encode["flash_fwd"] > 0, f"corpus encode launches {encode}")
    gap = float(np.abs(service.corpus_emb.cpu().numpy() - dump["video"]).max())
    log("serve", f"build_service --checkpoint-dir (step {first}): "
                 f"{time.perf_counter() - t0:.2f} s; corpus encode launches "
                 f"{encode}; corpus vs the eval dump max |Δ| {gap:.3e}")
    check(gap <= BATCHED_SCORE_TOL, f"corpus vs eval dump {gap}")
    served = Served(service)
    try:
        start = 0
        for rows in (1, 3, 5, 16) * 2:
            before = dict(fa.launch_counts)
            status, out = post(served.url, {
                "features": data.text[start:start + rows].tolist(),
                "mask": data.text_mask[start:start + rows].tolist(), "k": 10})
            check(status == 200, f"/search answered {status}")
            check_result(out, rows, 10, service.corpus_rows)
            launched = flash_delta(before)
            check(launched["flash_fwd"] > 0 and launched["flash_dq"] == 0
                  == launched["flash_dkv"], f"a search launched {launched}")
            start += rows
        status, health = get(served.url, "/healthz")
        check(status == 200 and health["step"] == first
              and health["index_step"] == first, f"/healthz {health}")

        # the eval dump as a precomputed index, held strictly
        pre = build_service(cfg, ckpt, "video", device="cuda",
                            corpus_emb_path=str(tmp / "emb.npz"),
                            strict_index=True)
        check(not pre.index_stale and not pre.index_tower_mismatch
              and torch.equal(pre.corpus_emb.cpu(), torch.from_numpy(dump["video"])),
              "--corpus-emb index")
        feats, mask = data.text[:64], data.text_mask[:64]
        a, b = service.search(feats, mask, k=10), pre.search(feats, mask, k=10)
        check(a["indices"] == b["indices"], "--corpus-emb answers")
        log("serve", f"--corpus-emb (the eval dump, step {first}) under "
                     f"--strict-index: served, 64 queries answered as the "
                     f"checkpoint's own index does")

        # the int8 index, from the same dump
        q8 = build_service(cfg, ckpt, "video", device="cuda", corpus_dtype="int8",
                           corpus_emb_path=str(tmp / "emb.npz"))
        values = q8.corpus_emb.values
        check(values.dtype == torch.int8 and values.is_cuda, "int8 index placement")
        q = service.trainer.encode_modality(
            service.state, "text", np.asarray(data.text[:256], np.float32),
            np.asarray(data.text_mask[:256], np.float32))
        qv, qs = _quantize_queries(q)
        for rows in (256, 1):  # torch._int_mm's padding: one row too
            acc = _int8_dot(qv[:rows], values)
            want = qv[:rows].cpu().int() @ values.cpu().int().T
            check(torch.equal(acc.cpu(), want),
                  f"int8 accumulators at {rows} rows: card vs CPU int32")
        # text queries, and corpus rows as exact-match queries (the JAX
        # tests' case): every score within the bound of the fp32
        # index's, and top-1 kept wherever the fp32 margin clears twice
        # the bound (within it the two may rightly differ)
        exact = torch.from_numpy(dump["video"][:256]).cuda()
        report = []
        for tag, queries in (("text", q), ("exact-match", exact)):
            qv, qs = _quantize_queries(queries)
            sim8 = _quantized_sim(qv, qs, q8.corpus_emb)
            sim32 = similarity_matrix(queries, pre.corpus_emb)
            score_err = (sim8 - sim32).abs().max().item()
            top = sim32.topk(2, dim=1)
            clear = (top.values[:, 0] - top.values[:, 1]) > 2 * INT8_SCORE_BOUND
            same = sim8.argmax(dim=1) == top.indices[:, 0]
            report.append(f"{tag} queries: scores max |Δ| {score_err:.3e} "
                          f"(limit {INT8_SCORE_BOUND}), top-1 agreement "
                          f"{same.float().mean().item():.4f}, {int(clear.sum())} "
                          f"of 256 clear of twice the bound (all of them kept)")
            check(score_err <= INT8_SCORE_BOUND, f"int8 {tag} scores {score_err}")
            check(bool(same[clear].all()), f"int8 {tag} top-1 flipped past the bound")
        self_top1 = (sim8.argmax(dim=1) == torch.arange(256, device="cuda"))
        log("serve", "int8 index: accumulators equal a CPU int32 product bit "
                     "for bit (256 and 1 query rows); " + "; ".join(report)
                     + f"; exact-match self top-1 {self_top1.float().mean().item():.4f}")

        # micro-batching: concurrent clients against the serial answers
        win = build_service(cfg, ckpt, "video", device="cuda",
                            corpus_emb_path=str(tmp / "emb.npz"),
                            batch_window_ms=BATCH_WINDOW_MS)
        win_served = Served(win)
        try:
            gate = threading.Barrier(SERVE_CLIENTS, timeout=300)
            answers = [None] * SERVE_CLIENTS

            def client(i: int) -> None:
                gate.wait()
                rows = slice(2 * i, 2 * i + 2)
                answers[i] = post(win_served.url, {
                    "features": data.text[rows].tolist(),
                    "mask": data.text_mask[rows].tolist(), "k": 5 + i % 6})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
                check(not t.is_alive(), "a batched client did not finish")
            worst = 0.0
            for i, (status, out) in enumerate(answers):
                check(status == 200, f"batched /search answered {status}")
                rows = slice(2 * i, 2 * i + 2)
                want = pre.search(data.text[rows], data.text_mask[rows],
                                  k=5 + i % 6)
                check(out["indices"] == want["indices"],
                      f"client {i}: batched indices differ from serial")
                worst = max(worst, float(np.abs(np.asarray(out["scores"])
                                                - np.asarray(want["scores"])).max()))
            dispatches = win.stats()["search_dispatches"]
            log("serve", f"{SERVE_CLIENTS} concurrent clients, {BATCH_WINDOW_MS} "
                         f"ms window: {dispatches} dispatches for "
                         f"{SERVE_CLIENTS} requests; vs serial: indices equal, "
                         f"scores max |Δ| {worst:.3e} (limit {BATCHED_SCORE_TOL})")
            check(dispatches < SERVE_CLIENTS, f"no coalescing: {dispatches}")
            check(worst <= BATCHED_SCORE_TOL, f"batched scores {worst}")

            # /search latency, single-row queries, k=10: over HTTP on
            # the client's clock (JSON of a [1, 96, 768] query both ways
            # included), and search() called in the process
            q8_served = Served(q8)
            pre_served = Served(pre)

            def over_http(url):
                def send(row):
                    row %= len(data)
                    status, _ = post(url, {
                        "features": data.text[row:row + 1].tolist(),
                        "mask": data.text_mask[row:row + 1].tolist(), "k": 10})
                    check(status == 200, f"/search answered {status}")
                return send

            def in_process(svc):
                def send(row):
                    row %= len(data)
                    svc.search(data.text[row:row + 1], data.text_mask[row:row + 1],
                               k=10)
                return send

            try:
                p50 = {}
                for tag, http, svc, clients, per in (
                    ("fp32, 1 client", pre_served.url, pre, 1, 32),
                    ("int8, 1 client", q8_served.url, q8, 1, 32),
                    ("fp32, 1 client, window", win_served.url, win, 1, 32),
                    (f"fp32, {SERVE_CLIENTS} clients", pre_served.url, pre,
                     SERVE_CLIENTS, 4),
                    (f"fp32, {SERVE_CLIENTS} clients, window", win_served.url,
                     win, SERVE_CLIENTS, 4),
                ):
                    for how, send in (("http", over_http(http)),
                                      ("search()", in_process(svc))):
                        lats = sorted(search_latencies(send, clients, per))
                        p50[f"{tag}, {how}"] = lats[len(lats) // 2] * 1e3
                log("serve", "/search p50 (ms, single-row queries, k=10, the "
                             f"caller's clock, {BATCH_WINDOW_MS} ms window): "
                             + "; ".join(f"{k} {v:.2f}" for k, v in p50.items())
                             + f" ({smi})")
            finally:
                q8_served.close()
                pre_served.close()
        finally:
            win_served.close()

        # training resumes in the same directory; /reload picks it up
        before_corpus = service.corpus_emb.clone()
        rc = train.main(["--config", config, "--device", "cuda", "--steps",
                         str(last), "--metrics-csv", str(tmp / "m.csv"),
                         *overrides])
        check(rc == 0, f"train.main (resume) exited {rc}")
        before = dict(fa.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        status, body = post(served.url, {}, path="/reload")
        reload_s = time.perf_counter() - t0
        launched = flash_delta(before)
        check(status == 200 and body == {"status": "ok", "step": last,
                                         "index_step": last}, f"/reload {body}")
        check(launched["flash_fwd"] > 0 and launched["flash_dq"] == 0
              == launched["flash_dkv"], f"/reload launches {launched}")
        check(not torch.equal(service.corpus_emb, before_corpus),
              "/reload did not re-encode the corpus")
        status, out = post(served.url, {"features": data.text[:3].tolist(),
                                        "mask": data.text_mask[:3].tolist(),
                                        "k": 10})
        check(status == 200, f"/search after /reload answered {status}")
        check_result(out, 3, 10, service.corpus_rows)
        log("serve", f"train.main resumed to step {last}; POST /reload: step "
                     f"{first} -> {body['step']} in {reload_s:.2f} s (restore "
                     f"and a corpus re-encode of {service.corpus_rows} rows); "
                     f"launches {launched} ({smi})")
    finally:
        served.close()
    launches = dict(fa.launch_counts)
    log("serve", f"the phase took {time.perf_counter() - t_phase:.1f} s; flash "
                 f"launches on this path {launches}")
    want = 8 * last  # 4 layers x 2 towers a train step
    check(launches["flash_dq"] == launches["flash_dkv"] == want,
          f"serve phase backward launches {launches}, want {want}")
    return launches



# ---------------------------------------------------------------------------
# exported artifacts, the sharded index and the profiling hooks (PR 19), on
# the serve phase's checkpoint
# ---------------------------------------------------------------------------


def served_until_sigterm(serve, argv: list[str], requests) -> tuple[int, dict]:
    """``serve.main(argv)`` in this process with ``requests(url)`` run in a
    thread once it listens; the thread then sends this process SIGTERM, as
    a pod eviction would.  Returns main's code and what ``requests``
    returned."""
    import signal

    ready, address, replies = threading.Event(), [], {}

    class Server(serve.ServiceHTTPServer):
        def __init__(self, addr, service):
            super().__init__(addr, service)
            address.append(self.server_address)
            ready.set()

    def client():
        try:
            check(ready.wait(300), "the server did not start listening")
            replies.update(requests(f"http://127.0.0.1:{address[0][1]}"))
        except Exception as e:  # noqa: BLE001 — reported by the caller
            replies["error"] = f"{type(e).__name__}: {e}"
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    with mock.patch.object(serve, "ServiceHTTPServer", Server):
        thread = threading.Thread(target=client)
        thread.start()
        rc = serve.main(argv)
        thread.join(300)
    return rc, replies


def post_any(url: str, payload: dict, path: str) -> tuple[int, dict]:
    """``post`` that returns an HTTP error's code and body too."""
    try:
        return post(url, payload, path)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def aot_worker(spec_path: Path) -> int:
    """A child of the aot phase, a process that has imported none of the
    port: loads each artifact with ``SearchArtifact`` alone (its time, and
    which of the port's modules that imported), searches the phase's
    queries at AOT_ROWS rows with kernel 1's launches counted per search,
    times AOT_REPS searches at 1 and 64 rows, then serves the fp32
    artifact through ``serve --artifact`` over HTTP: /search against
    ``SearchArtifact.search``, /reload refused.  Writes ``spec["out"]``."""
    import numpy as np

    spec = json.loads(spec_path.read_text())
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent
    from crossclr_tpu_torch.aot import SearchArtifact

    with np.load(spec["queries"]) as z:
        feats, mask = z["text"], z["mask"]
    out = {}
    for dtype, path in spec["artifacts"].items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art = SearchArtifact.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        fa = sys.modules["crossclr_tpu_torch.ops.flash_attention"]
        port = sorted(m for m in sys.modules if m.startswith("crossclr_tpu_torch."))
        results, per_search = {}, []
        for rows in AOT_ROWS:
            before = fa.launch_counts["flash_fwd"]
            results[rows] = art.search(feats[:rows], mask[:rows])
            per_search.append(fa.launch_counts["flash_fwd"] - before)
        p50 = {}
        for rows in (1, 64):
            lats = []
            for _ in range(AOT_REPS):
                t0 = time.perf_counter()
                art.search(feats[:rows], mask[:rows])
                lats.append(time.perf_counter() - t0)
            p50[rows] = statistics.median(lats) * 1e3
        out[dtype] = {"load_s": load_s, "port_modules": port, "results": results,
                      "per_search": per_search, "p50_ms": p50}
    from crossclr_tpu_torch import serve

    art = SearchArtifact.load(spec["artifacts"]["float32"])

    def requests(url):
        got = {}
        for k in (AOT_K, 99):
            got[k] = post_any(url, {"features": feats[:3].tolist(),
                                    "mask": mask[:3].tolist(), "k": k}, "/search")
        got["want"] = art.search(feats[:3], mask[:3])
        got["reload"] = post_any(url, {}, "/reload")
        got["health"] = get(url, "/healthz")[1]
        return got

    rc, replies = served_until_sigterm(
        serve, ["--artifact", spec["artifacts"]["float32"], "--port", "0"], requests)
    out["http"] = {"rc": rc, **{str(k): v for k, v in replies.items()}}
    out["flash_fwd"] = sys.modules["crossclr_tpu_torch.ops.flash_attention"].launch_counts[
        "flash_fwd"]
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


def worker_spawn(tmp: Path, tag: str, flag: str, specs: list[dict],
                 join_s: float = WORKER_JOIN_S) -> list[dict]:
    """One ``chip_smoke.py <flag>`` child per spec, all started together,
    each given a launcher's environment as a rank of them (a worker that
    joins no group ignores it; the ranks of the ring, tp and shard phases
    join one gloo group from it on cuda:0, as NCCL refuses two ranks on
    one device).  A child that fails, or any still running after
    ``join_s``, fails the phase.  Returns each child's ``out`` JSON."""
    base = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    port = str(free_port())
    procs = []
    try:
        for r, spec in enumerate(specs):
            path = tmp / f"{tag}_{r}.json"
            path.write_text(json.dumps({**spec, "out": str(tmp / f"{tag}_{r}_out.json")}))
            env = {"RANK": str(r), "WORLD_SIZE": str(len(specs)), "LOCAL_RANK": "0",
                   "LOCAL_WORLD_SIZE": str(len(specs)), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": port}
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(path)],
                cwd=ROOT, env={**base, **env}, stdout=sys.stderr))
        deadline = time.monotonic() + join_s
        for r, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{tag}: child {r} still running after "
                                     f"{join_s} s") from None
            check(rc == 0, f"{tag}: child {r} exited {rc}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    return [json.loads((tmp / f"{tag}_{r}_out.json").read_text())
            for r in range(len(specs))]


def same_answers(got: dict, want: dict, tag: str, tol: float = AOT_SCORE_TOL) -> float:
    """Indices equal and scores within ``tol``; returns the scores' max |Δ|."""
    import numpy as np

    check(got["indices"] == want["indices"], f"{tag}: indices differ")
    gap = float(np.abs(np.asarray(got["scores"]) - np.asarray(want["scores"])).max())
    check(gap <= tol, f"{tag}: scores max |Δ| {gap} > {tol}")
    return gap


def search_cost_turns(fa, svc, feats, mask) -> list[str]:
    """What this slice adds to a live search, in turns in one call (after
    the phase's path counts are read): search()'s p50 at 1 row, k = 10,
    with ``evaluation.topk`` (exact ties to the lowest index) and with
    ``torch.topk`` patched in its place (repaired, plain, plain,
    repaired; AOT_REPS searches each); and one forward launch at the
    query's attention shape through ``crossclr::flash_fwd`` against the
    direct ctypes launch, 200 of each in turns.  Returns log lines."""
    from crossclr_tpu_torch.evaluation import retrieval

    def p50() -> float:
        lats = []
        for _ in range(AOT_REPS):
            t0 = time.perf_counter()
            svc.search(feats[:1], mask[:1], k=10)
            lats.append(time.perf_counter() - t0)
        return statistics.median(lats) * 1e3

    def plain(scores, k, index=None):
        return tuple(torch.topk(scores, k, dim=-1))

    got = {"evaluation.topk": [], "torch.topk": []}
    for tag in ("evaluation.topk", "torch.topk", "torch.topk", "evaluation.topk"):
        with (mock.patch.object(retrieval, "topk", plain) if tag == "torch.topk"
              else contextlib.nullcontext()):
            got[tag].append(p50())
    q, k, v, _ = qkv((1, 8, AOT_QUERY_SHAPE[0], 48), torch.bfloat16, 73)
    m = torch.ones((1, AOT_QUERY_SHAPE[0]), device="cuda")
    per_call = {"crossclr::flash_fwd": [], "ctypes launch": []}
    calls = {"crossclr::flash_fwd": lambda: fa.flash_attention(q, k, v, m),
             "ctypes launch": lambda: fa.flash_attention_fwd(q, k, v, m)}
    with torch.inference_mode():
        for tag in ("crossclr::flash_fwd", "ctypes launch", "ctypes launch",
                    "crossclr::flash_fwd"):
            calls[tag]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                calls[tag]()
            torch.cuda.synchronize()
            per_call[tag].append((time.perf_counter() - t0) / 200 * 1e6)
    return [
        "search() p50 at 1 row, k=10, in turns: "
        + "; ".join(f"{t} {', '.join(f'{x:.3f}' for x in v)} ms" for t, v in got.items()),
        f"one forward at [1, 8, {AOT_QUERY_SHAPE[0]}, 48] bf16, in turns: "
        + "; ".join(f"{t} {', '.join(f'{x:.1f}' for x in v)} us a call"
                    for t, v in per_call.items()),
    ]


def aot_phase(fa, smi: str, tmp: Path) -> dict:
    """Exported search artifacts of the serve phase's checkpoint (the
    transformer config at full width, flash towers, SERVE_STEPS[1]):
    ``eval.main`` at that step (all rows: the embeddings dump, and the one
    process the shard phase's ranks are held to); the live services for
    the fp32 index (encoded from the checkpoint) and the bf16 and int8
    ones (the dump); ``export_search`` of each, text → video, queries
    AOT_QUERY_SHAPE with a mask, k = AOT_K; the artifacts loaded and
    searched in an ``--aot-worker`` child (no model code imported;
    AOT_FLASH_PER_SEARCH launches of kernel 1 per search; the live
    ``search()``'s indices, scores within AOT_SCORE_TOL, at AOT_ROWS
    rows), and served there by ``serve --artifact``.  Every count is set
    to 0 at the start and read at the end, the child's added.  Returns
    ``{"launches", "services", "eval"}`` for the shard phase."""
    import numpy as np

    from crossclr_tpu_torch import data as data_pkg
    from crossclr_tpu_torch import eval as teval
    from crossclr_tpu_torch.aot import export_search, save_artifact
    from crossclr_tpu_torch.serve import build_service
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    t_phase = time.perf_counter()
    config = str(ROOT / TRANSFORMER_CONFIG)
    ckpt = str(tmp / "ckpt")
    overrides = [*SERVE_OVERRIDES, f"checkpoint_dir={ckpt}"]
    cfg = apply_overrides(load_config(config), overrides)
    data, _ = data_pkg.dataset_from_config(cfg.data)
    reset_counts(fa)
    rc = teval.main(["--config", config, "--device", "cuda", "--split", "all",
                     "--embeddings-output", str(tmp / "emb_last.npz"), "--topk", "10",
                     "--topk-output", str(tmp / "topk_last.npz"), "--output",
                     str(tmp / "eval_last.json"), *overrides])
    check(rc == 0, f"eval.main exited {rc}")
    services = {"float32": build_service(cfg, ckpt, "video", device="cuda")}
    for dtype in ("bfloat16", "int8"):
        services[dtype] = build_service(cfg, ckpt, "video", device="cuda",
                                        corpus_dtype=dtype, strict_index=True,
                                        corpus_emb_path=str(tmp / "emb_last.npz"))
    rows = max(AOT_ROWS)
    feats = np.asarray(data.text[:rows], np.float32)
    mask = np.asarray(data.text_mask[:rows], np.float32)
    np.savez(tmp / "aot_queries.npz", text=feats, mask=mask)
    artifacts, lines, live = {}, [], {}
    for dtype, svc in services.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob, meta, parts = export_search(svc, k=AOT_K, query_shape=AOT_QUERY_SHAPE)
        export_s = time.perf_counter() - t0
        path = tmp / f"search_{dtype}.npz"
        save_artifact(str(path), blob, meta, parts)
        artifacts[dtype] = str(path)
        check(meta["platforms"] == ["cuda"] and meta["index_dtype"] == dtype
              and meta["step"] == SERVE_STEPS[1], f"{dtype} artifact meta {meta}")
        answers = {n: svc.search(feats[:n], mask[:n], k=AOT_K) for n in AOT_ROWS}
        p50 = {}
        for n in (1, 64):
            lats = []
            for _ in range(AOT_REPS):
                t0 = time.perf_counter()
                svc.search(feats[:n], mask[:n], k=AOT_K)
                lats.append(time.perf_counter() - t0)
            p50[n] = statistics.median(lats) * 1e3
        live[dtype] = (answers, p50, export_s, path.stat().st_size / 2**20)
    parent = dict(fa.launch_counts)
    lines.extend(search_cost_turns(fa, services["float32"], feats, mask))
    (child,) = worker_spawn(tmp, "aot", "--aot-worker",
                            [{"artifacts": artifacts, "queries": str(tmp / "aot_queries.npz")}])
    for dtype, (answers, p50, export_s, mb) in live.items():
        got = child[dtype]
        check(not {"crossclr_tpu_torch.models", "crossclr_tpu_torch.training",
                   "crossclr_tpu_torch.serve"} & set(got["port_modules"]),
              f"{dtype}: loading the artifact imported {got['port_modules']}")
        check(got["per_search"] == [AOT_FLASH_PER_SEARCH] * len(AOT_ROWS),
              f"{dtype}: kernel 1 launches per search {got['per_search']}")
        gaps = [same_answers(got["results"][str(n)], answers[n], f"aot {dtype} {n} rows")
                for n in AOT_ROWS]
        lines.append(f"{dtype}: export {export_s:.2f} s, {mb:.2f} MB, load "
                     f"{got['load_s']:.2f} s (modules of the port: "
                     f"{', '.join(m.split('.', 1)[1] for m in got['port_modules'] if m.count('.') == 1)}); "
                     f"vs live search() at {AOT_ROWS} rows: indices equal, scores max "
                     f"|Δ| {max(gaps):.3e}; p50 ms artifact / live: 1 row "
                     f"{got['p50_ms']['1']:.2f} / {p50[1]:.2f}, 64 rows "
                     f"{got['p50_ms']['64']:.2f} / {p50[64]:.2f}; kernel 1 "
                     f"{got['per_search']} launches per search")
    http = child["http"]
    check(http["rc"] == 0 and "error" not in http, f"serve --artifact: {http}")
    for k in (str(AOT_K), "99"):  # k past the baked width clamps to it
        status, body = http[k]
        check(status == 200, f"serve --artifact /search k={k}: {status}")
        same_answers(body, http["want"], f"serve --artifact k={k}", tol=0.0)
    check(http["reload"][0] == 400 and "immutable" in http["reload"][1]["error"],
          f"serve --artifact /reload {http['reload']}")
    check(http["health"]["artifact"] is True, f"/healthz {http['health']}")
    # every search of the child: AOT_ROWS and the timed ones of each
    # artifact, then three of the fp32 one over HTTP and beside it
    child_launches = child["flash_fwd"]
    want = AOT_FLASH_PER_SEARCH * (3 * (len(AOT_ROWS) + 2 * AOT_REPS) + 3)
    check(child_launches == want, f"the child's kernel 1 launches {child_launches}, "
                                  f"want {want}")
    launches = {"flash_fwd": parent["flash_fwd"] + child_launches}
    check(parent["flash_dq"] == parent["flash_dkv"] == 0, f"aot launches {parent}")
    for line in lines:  # each carries the card's name and power limit
        log("aot", f"{line} ({smi})")
    log("aot", f"serve --artifact over HTTP: /search = SearchArtifact.search bit for "
               f"bit at k = {AOT_K} and 99 (clamped), /reload refused (400); the phase "
               f"took {time.perf_counter() - t_phase:.1f} s; kernel 1 launches "
               f"{parent['flash_fwd']} here + {child_launches} in the child ({smi})")
    return {"launches": launches, "services": services,
            "eval": json.loads((tmp / "eval_last.json").read_text())}


def shard_worker(spec_path: Path) -> int:
    """A rank of the shard phase: joins a gloo group on cuda:0 from the
    launcher's environment, then (1) ``serve --shard-corpus`` from the
    checkpoint for each index dtype, rank 0 answering HTTP (SHARD_ROWS-row
    searches, k = 10; /reload on the fp32 index) until it sends itself
    SIGTERM; (2) the eval CLI on the ranks; (3) ``sharded_retrieve_topk``
    on SHARD_BIG fp32 rows made on the card from a seed, each rank keeping
    its block, SHARD_QUERIES queries, timed; rank 0 also times dense
    ``retrieve_topk`` on the whole index and keeps both answers.  Kernel
    counts are set to 0 before each part and read after.  Writes
    ``spec["out"]``."""
    import numpy as np
    import torch.distributed as dist

    spec = json.loads(spec_path.read_text())
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent
    from crossclr_tpu_torch import data as data_pkg
    from crossclr_tpu_torch import eval as teval
    from crossclr_tpu_torch import serve
    from crossclr_tpu_torch.evaluation import retrieve_topk, shard_corpus, sharded_retrieve_topk

    fa = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    out = {}
    try:
        with dataset_once():
            from crossclr_tpu_torch.utils.config import apply_overrides, load_config

            cfg = apply_overrides(load_config(spec["config"]), spec["overrides"])
            data, _ = data_pkg.dataset_from_config(cfg.data)
            for dtype in ("float32", "int8"):
                def requests(url, dtype=dtype):
                    got, start = {}, 0
                    for n in SHARD_ROWS:
                        got[n] = post_any(url, {
                            "features": data.text[start:start + n].tolist(),
                            "mask": data.text_mask[start:start + n].tolist(),
                            "k": 10}, "/search")
                        start += n
                    if dtype == "float32":
                        got["reload"] = post_any(url, {}, "/reload")
                    got["health"] = get(url, "/healthz")[1]
                    return got

                argv = ["--shard-corpus", "--device", "cuda:0", "--port", "0",
                        "--config", spec["config"], "--corpus-dtype", dtype,
                        *spec["overrides"]]
                reset_counts(fa)
                t0 = time.perf_counter()
                if rank == 0:
                    rc, replies = served_until_sigterm(serve, argv, requests)
                else:
                    rc, replies = serve.main(argv), {}
                out[dtype] = {"rc": rc, "seconds": time.perf_counter() - t0,
                              "launches": dict(fa.launch_counts),
                              "replies": {str(k): v for k, v in replies.items()}}
            reset_counts(fa)
            t0 = time.perf_counter()
            rc = teval.main(["--config", spec["config"], "--device", "cuda:0",
                             "--split", "all", "--topk", "10", "--topk-output",
                             spec["topk"], "--output", spec["eval"], *spec["overrides"]])
            out["eval"] = {"rc": rc, "seconds": time.perf_counter() - t0,
                           "launches": dict(fa.launch_counts)}
        n, d = SHARD_BIG
        gen = torch.Generator(device="cuda").manual_seed(SHARD_SEED)
        whole = torch.randn((n, d), generator=gen, device="cuda")
        queries = torch.randn((SHARD_QUERIES, d), generator=gen, device="cuda")
        local = shard_corpus(whole)
        if rank:
            del whole
        torch.cuda.synchronize()

        def timed(fn):
            lats, res = [], None
            for i in range(SHARD_REPS + 2):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                if i >= 2:  # two warm-ups
                    lats.append(time.perf_counter() - t0)
            return res, statistics.median(lats) * 1e3

        (s, i), sharded_ms = timed(lambda: sharded_retrieve_topk(
            queries, local, k=SHARD_K, n_real=n))
        big = {"sharded_ms": sharded_ms, "local_rows": int(local.shape[0])}
        if rank == 0:
            lats = []
            for j in range(SHARD_REPS + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ds, di = retrieve_topk(queries, whole, k=SHARD_K)
                torch.cuda.synchronize()
                if j >= 2:
                    lats.append(time.perf_counter() - t0)
            big.update(dense_ms=statistics.median(lats) * 1e3,
                       same_indices=bool(torch.equal(i, di)),
                       max_score_gap=float((s - ds).abs().max()))
        out["big"] = big
    finally:
        dist.destroy_process_group()
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


def topk_cost(whole, gen) -> list[str]:
    """What ``retrieve_topk``'s tie order costs at corpus scale: the dense
    search of TOPK_QUERIES queries on the whole SHARD_BIG index (its
    ``topk``: the k-th score, then int32 words that rank ties by
    position) against the same search with ``torch.topk`` of the fp32
    scores (ties in no set order), in turns (ours, plain, plain, ours,
    ...; one warm-up each), ms a search by CUDA-synchronized wall clock,
    and the peak memory each allocates on top of the index.  The scores
    must be equal, and tie groups straddling the k-th score must come
    out in ``lax.top_k``'s order on the card."""
    from crossclr_tpu_torch.evaluation import retrieve_topk, topk
    from crossclr_tpu_torch.losses.functional import l2_normalize

    ties = torch.tensor([[1.0, -0.0, 0.0, 3.0, 3.0, float("-inf"), -2.5, 3.0, 1.0]],
                        device="cuda")
    check(topk(ties, 6)[1].tolist() == [[3, 4, 7, 0, 8, 1]],
          f"topk's order of ties on the card: {topk(ties, 6)[1].tolist()}")

    def plain(q, c, k, chunk=1024):  # retrieve_topk with torch.topk
        q, c = l2_normalize(q, dim=1), l2_normalize(c, dim=1)
        s, i = zip(*(torch.topk(q[a:a + chunk] @ c.T, k)
                     for a in range(0, q.shape[0], chunk)))
        return torch.cat(s), torch.cat(i)

    lines = []
    for nq in TOPK_QUERIES:
        q = torch.randn((nq, whole.shape[1]), generator=gen, device="cuda")
        ms = {"ours": [], "plain": []}
        peak, res = {}, {}
        for rep in range(TOPK_REPS + 1):
            for name in (("ours", "plain") if rep % 2 == 0 else ("plain", "ours")):
                fn = retrieve_topk if name == "ours" else plain
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                res[name] = fn(q, whole, k=SHARD_K)
                torch.cuda.synchronize()
                if rep:
                    ms[name].append((time.perf_counter() - t0) * 1e3)
                peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        check(torch.equal(res["ours"][0], res["plain"][0]),
              f"retrieve_topk at {nq} queries: scores differ from torch.topk's")
        same = float((res["ours"][1] == res["plain"][1]).all(dim=1).float().mean())
        lines.append(
            f"dense retrieve_topk, {nq} queries x {whole.shape[0]} x {whole.shape[1]} "
            f"fp32, k={SHARD_K}: {statistics.median(ms['ours']):.2f} ms a search, peak "
            f"{peak['ours']:.2f} GiB over the index; the same search through "
            f"torch.topk {statistics.median(ms['plain']):.2f} ms, peak "
            f"{peak['plain']:.2f} GiB (medians of {TOPK_REPS} in turns; scores "
            f"equal, indices equal in {same:.4f} of the rows)")
    return lines


def shard_phase(fa, smi: str, tmp: Path, aot: dict) -> dict:
    """The row-sharded index on SHARD_RANKS gloo ranks sharing cuda:0
    (``--shard-worker`` children, host-staged as the dp, ring and tp
    phases), against one process: ``serve --shard-corpus`` from the serve
    phase's checkpoint (each rank encodes its 2048 rows of 4096 through
    kernel 1) for the fp32 and the int8 index, the aot phase's one-process
    services' answers (indices equal, scores within AOT_SCORE_TOL) and
    /reload; the eval CLI on the ranks against the aot phase's one
    process (R@K equal, MdR and MnR within EVAL_MEAN_TOL, the top-k dump's
    indices equal); ``sharded_retrieve_topk`` on SHARD_BIG fp32 rows
    against dense ``retrieve_topk``, timed; then a one-rank NCCL group's
    sharded search bit for bit with the dense one, and :func:`topk_cost`.
    Returns kernel 1's launches in the ranks."""
    import numpy as np
    import torch.distributed as dist

    from crossclr_tpu_torch import data as data_pkg
    from crossclr_tpu_torch.evaluation import (
        quantize_corpus, retrieve_topk, shard_corpus, sharded_retrieve_topk)
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    t_phase = time.perf_counter()
    config = str(ROOT / TRANSFORMER_CONFIG)
    overrides = [*SERVE_OVERRIDES, f"checkpoint_dir={tmp / 'ckpt'}"]
    data, _ = data_pkg.dataset_from_config(
        apply_overrides(load_config(config), overrides).data)
    spec = {"config": config, "overrides": overrides, "eval": str(tmp / "eval_sharded.json"),
            "topk": str(tmp / "topk_sharded.npz")}
    ranks = worker_spawn(tmp, "shard", "--shard-worker", [spec] * SHARD_RANKS)
    lead = ranks[0]
    launches = {"flash_fwd": 0}
    lines = []
    for dtype in ("float32", "int8"):
        got = lead[dtype]["replies"]
        check(all(r[dtype]["rc"] == 0 for r in ranks) and "error" not in got,
              f"serve --shard-corpus {dtype}: {[r[dtype]['rc'] for r in ranks]} {got}")
        svc = aot["services"][dtype]
        gaps, start = [], 0
        for n in SHARD_ROWS:
            status, body = got[str(n)]
            check(status == 200, f"sharded /search {dtype} {n} rows: {status}")
            want = svc.search(data.text[start:start + n], data.text_mask[start:start + n],
                              k=10)
            gaps.append(same_answers(body, want, f"shard {dtype} {n} rows"))
            start += n
        if dtype == "float32":
            check(got["reload"] == [200, {"status": "ok", "step": SERVE_STEPS[1],
                                          "index_step": SERVE_STEPS[1]}],
                  f"sharded /reload {got['reload']}")
        check(got["health"]["corpus_rows"] == svc.corpus_rows, f"/healthz {got['health']}")
        for r, rank in enumerate(ranks):
            check(rank[dtype]["launches"]["flash_fwd"] > 0,
                  f"rank {r} {dtype}: no encode through kernel 1")
            launches["flash_fwd"] += rank[dtype]["launches"]["flash_fwd"]
        lines.append(f"serve --shard-corpus {dtype}: {SHARD_RANKS} ranks, "
                     f"{lead[dtype]['seconds']:.1f} s start to stop; vs one process "
                     f"at {SHARD_ROWS} rows: indices equal, scores max |Δ| "
                     f"{max(gaps):.3e}; kernel 1 "
                     f"{[r[dtype]['launches']['flash_fwd'] for r in ranks]} by rank")
    # the eval CLI on the ranks against one process
    want, got = aot["eval"], json.loads(Path(spec["eval"]).read_text())
    for key, value in want.items():
        if "R@" in key or not isinstance(value, float):
            check(got[key] == value, f"sharded eval {key}: {got[key]} vs {value}")
        else:
            check(abs(got[key] - value) <= EVAL_MEAN_TOL,
                  f"sharded eval {key}: {got[key]} vs {value}")
    with np.load(tmp / "topk_last.npz") as a, np.load(spec["topk"]) as b:
        check(np.array_equal(a["indices"], b["indices"]), "sharded eval top-k dump")
    for r, rank in enumerate(ranks):
        check(rank["eval"]["rc"] == 0 and rank["eval"]["launches"]["flash_fwd"] > 0,
              f"rank {r} eval {rank['eval']}")
        launches["flash_fwd"] += rank["eval"]["launches"]["flash_fwd"]
    lines.append(f"eval CLI on {SHARD_RANKS} ranks ({lead['eval']['seconds']:.1f} s): "
                 f"R@K equal to one process, MdR/MnR within {EVAL_MEAN_TOL} "
                 f"(v2t/R@1 {got['v2t/R@1']:.3f}, t2v/MnR {got['t2v/MnR']:.3f}), "
                 f"top-10 dump equal")
    big = lead["big"]
    check(big["same_indices"] and big["max_score_gap"] <= AOT_SCORE_TOL,
          f"sharded_retrieve_topk at {SHARD_BIG}: {big}")
    lines.append(f"sharded_retrieve_topk, {SHARD_BIG[0]} x {SHARD_BIG[1]} fp32 "
                 f"({SHARD_BIG[0] * SHARD_BIG[1] * 4 / 1e9:.2f} GB, {big['local_rows']} "
                 f"rows a rank), {SHARD_QUERIES} queries, k={SHARD_K}: "
                 f"{' / '.join(f'{r['big']['sharded_ms']:.2f}' for r in ranks)} ms a search "
                 f"by rank (2 gloo ranks on one card, host-staged) against dense "
                 f"retrieve_topk {big['dense_ms']:.2f} ms in one process; indices equal, "
                 f"scores max |Δ| {big['max_score_gap']:.3e}")
    # a one-rank NCCL group: the dense search bit for bit
    n, d = SHARD_BIG
    gen = torch.Generator(device="cuda").manual_seed(SHARD_SEED)
    whole = torch.randn((n, d), generator=gen, device="cuda")
    queries = torch.randn((SHARD_QUERIES, d), generator=gen, device="cuda")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        for tag, index in (("fp32", whole), ("int8", None)):
            if index is None:
                index = quantize_corpus(whole[:SHARD_INT8_ROWS]).to("cuda")
            got = sharded_retrieve_topk(queries, shard_corpus(index), k=SHARD_K)
            want = retrieve_topk(queries, index, k=SHARD_K)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"one NCCL rank {tag}: not the dense search bit for bit")
    finally:
        dist.destroy_process_group()
    lines.append(f"one NCCL rank: sharded_retrieve_topk bit for bit with "
                 f"retrieve_topk (fp32 {n} x {d}, int8 {SHARD_INT8_ROWS} x {d})")
    lines += topk_cost(whole, gen)
    del whole
    for line in lines:  # each carries the card's name and power limit
        log("shard", f"{line} ({smi})")
    log("shard", f"the phase took {time.perf_counter() - t_phase:.1f} s; kernel 1 "
                 f"launches in the ranks {launches['flash_fwd']} ({smi})")
    return launches


def profile_phase(fa, fd, smi: str, tmp: Path) -> dict:
    """The profiling hooks on the transformer leg (full width, flash,
    dropout 0.1, batch 1024), PROFILE_STEPS one-step dispatches from the
    serve phase's pairs: ``--save-config`` writes the resolved config and
    it loads back equal; ``--tensorboard-dir`` is refused naming the
    missing package with both writers' imports blocked and, where one is
    installed, writes its event file;
    ``--profile-dir`` writes a trace whose kernel events name the flash
    forward, dq, dk/dv and sym kernels; ``utils.profiling.nan_debug``
    raises at the operator that makes a NaN on the card.  Counts are set
    to 0 before the profiled run and read after.  Returns its launches."""
    import importlib.util

    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config
    from crossclr_tpu_torch.utils.profiling import nan_debug

    t_phase = time.perf_counter()
    config = str(ROOT / TRANSFORMER_CONFIG)
    overrides = [*TRANSFORMER_OVERRIDES, "train.steps_per_call=1",
                 f"eval_every={PROFILE_STEPS}", f"checkpoint_dir={tmp / 'profiled'}"]
    argv = ["--config", config, "--device", "cuda", "--steps", str(PROFILE_STEPS)]
    lines = []
    # each run trains from step 0 in a directory of its own
    elsewhere = [*overrides, f"checkpoint_dir={tmp / 'tensorboard'}"]
    rc = train.main([*argv, "--save-config", str(tmp / "resolved.json"), *overrides])
    want = apply_overrides(load_config(config), [*overrides,
                                                 f"train.total_steps={PROFILE_STEPS}"])
    check(rc == 0 and load_config(tmp / "resolved.json") == want,
          "--save-config did not round-trip")
    lines.append("--save-config: the resolved config loads back equal")
    # refused, naming what is missing, where neither writer is importable
    with mock.patch.dict(sys.modules, {"tensorboardX": None, "tensorboard": None}):
        try:
            train.main([*argv, "--tensorboard-dir", str(tmp / "tb"), *elsewhere])
            raise AssertionError("--tensorboard-dir ran without a TensorBoard writer")
        except SystemExit as e:
            check("neither tensorboardX nor tensorboard" in str(e),
                  f"--tensorboard-dir refused with {e}")
            lines.append(f"--tensorboard-dir with both writers blocked: {e}")
    writers = [m for m in ("tensorboardX", "tensorboard") if importlib.util.find_spec(m)]
    if writers:  # and streamed where one is installed
        check(train.main([*argv, "--tensorboard-dir", str(tmp / "tb"), *elsewhere]) == 0
              and any((tmp / "tb").glob("events.out.tfevents.*")), "--tensorboard-dir")
        lines.append(f"--tensorboard-dir: event file written ({', '.join(writers)} "
                     "installed on this machine)")
    reset_counts(fa)
    reset_counts(fd)
    t0 = time.perf_counter()
    rc = train.main([*argv, "--profile-dir", str(tmp / "trace"), "--metrics-csv",
                     str(tmp / "profiled.csv"), *overrides])
    seconds = time.perf_counter() - t0
    launches = {**dict(fa.launch_counts), **dict(fd.launch_counts)}
    check(rc == 0, f"train.main --profile-dir exited {rc}")
    traces = list((tmp / "trace").glob("*.pt.trace.json"))
    check(len(traces) == 1, f"--profile-dir wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in name for name in kernels) for k in PROFILE_KERNELS}
    check(all(named.values()), f"the trace's kernel events name {named}")
    per_step = 2 * 4 * PROFILE_STEPS  # towers x layers a step
    check(launches["flash_dq"] == launches["flash_dkv"] == per_step
          and launches["sym_fwd"] == launches["sym_bwd"] == PROFILE_STEPS
          and launches["sym_bwd_wgmma"] == PROFILE_STEPS,
          f"profiled launches {launches}")
    lines.append(f"--profile-dir: {traces[0].stat().st_size / 2**20:.1f} MB trace, "
                 f"{len(kernels)} kernel events; by name {named}; the run "
                 f"{seconds:.1f} s with the trace written; launches "
                 f"{ {k: v for k, v in launches.items() if v} }")
    x = torch.tensor([-1.0, 4.0], device="cuda", requires_grad=True)
    try:
        with nan_debug():
            (torch.sqrt(x) * 0.0).sum().backward()
        raise AssertionError("nan_debug did not raise on a NaN gradient")
    except RuntimeError as e:
        check("SqrtBackward0" in str(e) and "nan" in str(e), f"nan_debug: {e}")
    lines.append("nan_debug: raised at SqrtBackward0 on the card")
    for line in lines:  # each carries the card's name and power limit
        log("profile", f"{line} ({smi})")
    log("profile", f"the phase took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# ---------------------------------------------------------------------------
# the loss kernels (training)
# ---------------------------------------------------------------------------


def loss_inputs(b: int, d: int, seed: int):
    """Unit-norm fp32 features and positive lse cotangents, as the loss
    gives them (its mean over rows and directions: 1/(2B), here varied
    by up to ±50% per row)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v, t = (torch.nn.functional.normalize(
        torch.randn(b, d, generator=gen, device="cuda"), dim=1) for _ in range(2))
    g_v, g_t = ((0.5 + torch.rand(b, 1, generator=gen, device="cuda")) / (2 * b)
                for _ in range(2))
    return v, t, g_v, g_t


def lse_err(got, want, what: str) -> float:
    err = max((a - c).abs().max().item() for a, c in zip(got, want))
    ok = all(bool(((a - c).abs() <= LSE_TOL + LSE_TOL * c.abs()).all())
             for a, c in zip(got, want))
    check(ok and all(bool(torch.isfinite(a).all()) for a in got),
          f"{what}: lse outside atol = rtol = {LSE_TOL} (max err {err:.3e})")
    return err


def grad_err(got, want, what: str) -> float:
    err, ratio = 0.0, 0.0
    for a, c in zip(got, want):
        e = (a - c).abs().max().item()
        err = max(err, e)
        ratio = max(ratio, e / max(c.abs().max().item(), 1e-30))
    check(ratio <= GRAD_BOUND and all(bool(torch.isfinite(a).all()) for a in got),
          f"{what}: gradient error {ratio:.3e} of the largest entry "
          f"(limit {GRAD_BOUND})")
    return err


def plain_loss(fd, video, text, tau, tier):
    """The fused loss with the plain pair in place of the kernels,
    differentiated by autograd: the cuBLAS-products-plus-eager-softmax
    baseline at the same operand tier."""
    from crossclr_tpu_torch.losses.functional import l2_normalize

    v = l2_normalize(video.float(), dim=1)
    t = l2_normalize(text.float(), dim=1)
    vk, tk = fd._fetch_cast(tier, v, t)
    if isinstance(tau, torch.Tensor):
        lse_v, lse_t = fd.dual_fwd_plain(vk, tk, (1.0 / tau).reshape(1), NEG_WEIGHT)
    else:
        lse_v, lse_t = fd.sym_fwd_plain(vk, tk, 1.0 / tau, NEG_WEIGHT)
    pos = (v * t).sum(dim=1, keepdim=True) / tau
    return ((lse_v - pos).mean() + (lse_t - pos).mean()) / 2


def loss_check_phase(fd) -> dict:
    """Every loss kernel against its plain version on identical inputs;
    returns the worst absolute error of each kernel."""
    from crossclr_tpu_torch.losses import functional as F
    from crossclr_tpu_torch.ops.fused_crossclr import cross_clr_intra_fused

    worst = dict.fromkeys(fd.KERNELS, 0.0)

    def note(name, err):
        worst[name] = max(worst[name], err)

    for b, d in LOSS_SHAPES:
        v32, t32, g_v, g_t = loss_inputs(b, d, seed=b + d)
        for tier in ("highest", "default"):
            v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
            tag = f"B={b} D={d} {tier}"
            s = 1.0 / 0.03
            ref = fd.sym_fwd_plain(v, t, s, NEG_WEIGHT)
            errs = [lse_err(fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT), ref,
                            f"{tag} sym_fwd")]
            note("sym_fwd", errs[-1])
            errs.append(grad_err(
                fd.sym_bwd_cuda(v, t, *ref, g_v, g_t, s, NEG_WEIGHT),
                fd.sym_bwd_plain(v, t, *ref, g_v, g_t, s, NEG_WEIGHT),
                f"{tag} sym_bwd"))
            note("sym_bwd", errs[-1])
            for tau in (0.03, 0.01):
                scale = torch.full((1,), 1.0 / tau, device="cuda")
                ref = fd.dual_fwd_plain(v, t, scale, NEG_WEIGHT)
                errs.append(lse_err(fd.dual_fwd_cuda(v, t, scale, NEG_WEIGHT),
                                    ref, f"{tag} τ={tau} dual_fwd"))
                # the keep-mask branch's edges: every candidate kept, and
                # none but the positive
                for fill in (True, False):
                    keep = tuple(torch.full((b,), fill, dtype=torch.bool, device="cuda")
                                 for _ in range(2))
                    errs[-1] = max(errs[-1], lse_err(
                        fd.dual_fwd_cuda(v, t, scale, NEG_WEIGHT, *keep),
                        fd.dual_fwd_plain(v, t, scale, NEG_WEIGHT, *keep),
                        f"{tag} τ={tau} dual_fwd {'all kept' if fill else 'none kept'}"))
                note("dual_fwd", errs[-1])
                got = fd.dual_bwd_cuda(v, t, scale, *ref, g_v, g_t, NEG_WEIGHT)
                want = fd.dual_bwd_plain(v, t, scale, *ref, g_v, g_t, NEG_WEIGHT)
                errs.append(grad_err(got[:2], want[:2], f"{tag} τ={tau} dual_bwd"))
                note("dual_bwd", errs[-1])
                ds_rel = ((got[2] - want[2]).abs() / want[2].abs()).item()
                check(ds_rel <= DS_RTOL, f"{tag} τ={tau}: Σ coeff⊙z rel err "
                                         f"{ds_rel:.3e} (limit {DS_RTOL})")
            torch.cuda.synchronize()
            log("loss", f"{tag}: max|kernel-plain| sym_fwd {errs[0]:.3e}, "
                        f"sym_bwd {errs[1]:.3e}, dual_fwd {errs[2]:.3e} / "
                        f"{errs[4]:.3e} (unpruned, all kept, none kept), dual_bwd "
                        f"{errs[3]:.3e} / {errs[5]:.3e} (τ=0.03 / 0.01; dτ term "
                        f"within rtol {DS_RTOL})")

    # the fused loss through the kernels against the eager loss (fp32)
    b, d = SLICE_LOSS_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    video, text = (torch.randn(b, d, generator=gen, device="cuda") for _ in range(2))
    for tensor_tau in (False, True):
        out = []
        for fn in (cross_clr_intra_fused, F.cross_clr_intra):
            v = video.clone().requires_grad_()
            t = text.clone().requires_grad_()
            tau = (torch.tensor(0.03, device="cuda", requires_grad=True)
                   if tensor_tau else 0.03)
            loss = fn(v, t, temperature=tau, negative_weight=NEG_WEIGHT)
            loss.backward()
            out.append((loss.detach(), v.grad, t.grad,
                        tau.grad if tensor_tau else None))
        (lk, vk, tk, dk), (lp, vp, tp, dp) = out
        lerr = abs(lk.item() - lp.item())
        check(lerr <= LSE_TOL + LSE_TOL * abs(lp.item()),
              f"fused loss {lk.item()} vs eager {lp.item()}")
        grad_err((vk, tk), (vp, tp), "fused loss feature gradients")
        if tensor_tau:
            check(abs(dk.item() - dp.item()) <= DS_RTOL * abs(dp.item()),
                  f"fused loss dτ {dk.item()} vs eager {dp.item()}")
        log("loss", f"cross_clr_intra_fused ({'tensor' if tensor_tau else 'float'}"
                    f" τ=0.03, B={b} D={d}) vs the eager loss: |Δloss| "
                    f"{lerr:.3e}" + (f", dτ {dk.item():.6g} vs {dp.item():.6g}"
                                     if tensor_tau else ""))
    return worst


def loss_timing_phase(fd, smi: str) -> dict:
    """Each kernel and its plain version, at the training slice's shape
    and the headline shape (bf16 operands: the slice's `default` tier);
    then the loss fwd+bwd of each route at the headline shape."""
    from crossclr_tpu_torch.ops.fused_crossclr import cross_clr_intra_fused

    times = {}
    for b, d in (SLICE_LOSS_SHAPE, TRANSFORMER_LOSS_SHAPE, HEADLINE_LOSS_SHAPE):
        v32, t32, g_v, g_t = loss_inputs(b, d, seed=3)
        v, t = (x.contiguous() for x in fd._fetch_cast("default", v32, t32))
        s = 1.0 / 0.03
        scale = torch.full((1,), s, device="cuda")
        lse = fd.sym_fwd_plain(v, t, s, NEG_WEIGHT)
        pairs = {
            "sym_fwd": (lambda: fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT),
                        lambda: fd.sym_fwd_plain(v, t, s, NEG_WEIGHT)),
            "sym_bwd": (lambda: fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s, NEG_WEIGHT),
                        lambda: fd.sym_bwd_plain(v, t, *lse, g_v, g_t, s, NEG_WEIGHT)),
            "dual_fwd": (lambda: fd.dual_fwd_cuda(v, t, scale, NEG_WEIGHT),
                         lambda: fd.dual_fwd_plain(v, t, scale, NEG_WEIGHT)),
            "dual_bwd": (
                lambda: fd.dual_bwd_cuda(v, t, scale, *lse, g_v, g_t, NEG_WEIGHT),
                lambda: fd.dual_bwd_plain(v, t, scale, *lse, g_v, g_t, NEG_WEIGHT)),
        }
        for name, (kernel, plain) in pairs.items():
            ms, plain_ms = median_ms(kernel), median_ms(plain)
            times[(name, b, d)] = (ms, plain_ms)
            log("loss", f"{name} B={b} D={d} bf16 operands: kernel {ms:.4f} ms, "
                        f"plain {plain_ms:.4f} ms (median of 20; {smi})")

    b, d = HEADLINE_LOSS_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    video, text = (torch.randn(b, d, generator=gen, device="cuda", requires_grad=True)
                   for _ in range(2))
    tau_leaf = torch.tensor(0.03, device="cuda", requires_grad=True)
    for route, tau in (("sym", 0.03), ("dual", tau_leaf)):
        for tier in ("highest", "default"):
            def kernel_step():
                cross_clr_intra_fused(video, text, temperature=tau,
                                      negative_weight=NEG_WEIGHT,
                                      precision=tier).backward()

            def plain_step():
                plain_loss(fd, video, text, tau, tier).backward()

            ms = median_ms(kernel_step, grad=True)
            plain_ms = median_ms(plain_step, grad=True)
            log("loss", f"loss fwd+bwd, {route} route, {tier}, B={b} D={d}: "
                        f"kernel {ms:.4f} ms ({b / ms * 1e3:.0f} pairs/s), plain "
                        f"{plain_ms:.4f} ms ({b / plain_ms * 1e3:.0f} pairs/s) "
                        f"(median of 20; {smi})")
    return times


# ---------------------------------------------------------------------------
# the keep-mask (pruned) branch of the loss kernels (the full CrossCLR loss)
# ---------------------------------------------------------------------------


def keep_masks(v, t):
    """The pruning masks of the full CrossCLR loss, from the connectivity of
    the features themselves at prune 0.1: ``(keep_v, keep_t)``."""
    from crossclr_tpu_torch.losses import functional as F

    return tuple(F.connectivity_keep_and_weights(
        F.connectivity_scores(x), prune_percent=PRUNE,
        weight_temperature=0.0035)[0] for x in (v, t))


def pruned_check_phase(fd, fg) -> dict:
    """The keep-mask branch of every loss kernel against its plain version
    on identical inputs, with connectivity masks and both edges; at the
    leg's shape the pruned dual lse also against the rows kernel.  Returns
    the worst absolute error of each kernel."""
    worst = dict.fromkeys(fd.KERNELS, 0.0)

    def note(name, err):
        worst[name] = max(worst[name], err)

    for b, d in PRUNED_SHAPES:
        v32, t32, g_v, g_t = loss_inputs(b, d, seed=b + d + 1)
        masks = {"prune 0.1": keep_masks(v32, t32)}
        for kind, fill in (("all pruned", False), ("all kept", True)):
            masks[kind] = tuple(torch.full((b,), fill, dtype=torch.bool,
                                           device="cuda") for _ in range(2))
        for tier in ("highest", "default"):
            v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
            errs = dict.fromkeys(fd.KERNELS, 0.0)
            for kind, keep in masks.items():
                tag = f"B={b} D={d} {tier} {kind}"
                s = 1.0 / 0.03
                ref = fd.sym_fwd_plain(v, t, s, NEG_WEIGHT, *keep)
                got = fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT, *keep)
                errs["sym_fwd"] = max(errs["sym_fwd"], lse_err(got, ref, f"{tag} sym_fwd"))
                if kind == "all pruned":  # only the positive is left
                    pos = s * (v.float() * t.float()).sum(dim=1, keepdim=True)
                    lse_err(got, (pos, pos), f"{tag} sym_fwd vs the positive logit")
                errs["sym_bwd"] = max(errs["sym_bwd"], grad_err(
                    fd.sym_bwd_cuda(v, t, *ref, g_v, g_t, s, NEG_WEIGHT, *keep),
                    fd.sym_bwd_plain(v, t, *ref, g_v, g_t, s, NEG_WEIGHT, *keep),
                    f"{tag} sym_bwd"))
                for tau in (0.03, 0.01):
                    scale = torch.full((1,), 1.0 / tau, device="cuda")
                    ref = fd.dual_fwd_plain(v, t, scale, NEG_WEIGHT, *keep)
                    got = fd.dual_fwd_cuda(v, t, scale, NEG_WEIGHT, *keep)
                    errs["dual_fwd"] = max(errs["dual_fwd"], lse_err(
                        got, ref, f"{tag} τ={tau} dual_fwd"))
                    if kind == "all pruned":
                        pos = (1.0 / tau) * (v.float() * t.float()).sum(dim=1, keepdim=True)
                        lse_err(got, (pos, pos), f"{tag} τ={tau} dual_fwd vs the "
                                                 f"positive logit")
                    if kind == "prune 0.1" and (b, d) == TRANSFORMER_LOSS_SHAPE:
                        # two kernels, one function: the rows kernel's lse
                        rows = (fg.rows_lse_cuda(v, v, t, 0, scale, NEG_WEIGHT,
                                                 keep[1], keep[0]),
                                fg.rows_lse_cuda(t, t, v, 0, scale, NEG_WEIGHT,
                                                 keep[0], keep[1]))
                        err = lse_err(got, rows, f"{tag} τ={tau} dual_fwd vs rows_lse")
                        log("loss", f"{tag} τ={tau}: pruned dual_fwd vs rows_lse_cuda "
                                    f"on the same operands: max|Δlse| {err:.3e}")
                    kg = fd.dual_bwd_cuda(v, t, scale, *ref, g_v, g_t, NEG_WEIGHT, *keep)
                    pg = fd.dual_bwd_plain(v, t, scale, *ref, g_v, g_t, NEG_WEIGHT, *keep)
                    errs["dual_bwd"] = max(errs["dual_bwd"], grad_err(
                        kg[:2], pg[:2], f"{tag} τ={tau} dual_bwd"))
                    ds_rel = ((kg[2] - pg[2]).abs() / pg[2].abs()).item()
                    check(ds_rel <= DS_RTOL, f"{tag} τ={tau}: Σ coeff⊙z rel err "
                                             f"{ds_rel:.3e} (limit {DS_RTOL})")
            torch.cuda.synchronize()
            for name, err in errs.items():
                note(name, err)
            log("loss", f"B={b} D={d} {tier}, pruned (prune 0.1, all pruned, all "
                        f"kept; sym τ=0.03, dual τ=0.03 / 0.01): max|kernel-plain| "
                        + ", ".join(f"{k} {x:.3e}" for k, x in errs.items())
                        + f" (dτ term within rtol {DS_RTOL})")
    return worst


def leg_check_phase(fd) -> dict:
    """sym_fwd, sym_bwd, dual_fwd and dual_bwd at the MLP leg's shape and,
    with keep masks, the full-CrossCLR leg's, both tiers, against their
    plain versions (each backward fed the plain lse): random features at
    τ = 0.03 and features collapsed near one direction at τ = 1/79 (lse
    near 86.6, g·e^{-lse} subnormal; every logit near s, so Σ coeff⊙z
    gathers ~3n² terms of one sign); dual at a tensor τ of the same value,
    its Σ coeff⊙z within DS_RTOL; two launches of each bf16 build bit for
    bit.  Returns the worst absolute error of each kernel."""
    worst = dict.fromkeys(("sym_fwd", "sym_bwd", "dual_fwd", "dual_bwd"), 0.0)
    for tau, noise in DIRECTION_LEG_CASES:
        s = 1.0 / tau
        scale = torch.full((1,), s, device="cuda")
        for (b, d), pruned in ((SLICE_LOSS_SHAPE, False), (PRUNED_TIMING[0], True)):
            v32, t32, g_v, g_t = leg_inputs(b, d, noise, seed=13)
            keep = keep_masks(v32, t32) if pruned else ()
            for tier in ("highest", "default"):
                v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
                tag = (f"B={b} D={d} {tier} τ={tau:.6g}" + (" pruned" if pruned else "")
                       + (f", collapsed (noise {noise})" if noise else ""))
                lse = fd.sym_fwd_plain(v, t, s, NEG_WEIGHT, *keep)
                sym = (v, t, *lse, g_v, g_t, s, NEG_WEIGHT, *keep)
                dual_lse = fd.dual_fwd_plain(v, t, scale, NEG_WEIGHT, *keep)
                dual = (v, t, scale, *dual_lse, g_v, g_t, NEG_WEIGHT, *keep)
                runs = {"sym_fwd": lambda: fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT, *keep),
                        "sym_bwd": lambda: fd.sym_bwd_cuda(*sym),
                        "dual_fwd": lambda: fd.dual_fwd_cuda(v, t, scale, NEG_WEIGHT,
                                                             *keep),
                        "dual_bwd": lambda: fd.dual_bwd_cuda(*dual)}
                got = {name: run() for name, run in runs.items()}
                errs = {"sym_fwd": lse_err(got["sym_fwd"], lse, f"{tag} sym_fwd"),
                        "sym_bwd": grad_err(got["sym_bwd"], fd.sym_bwd_plain(*sym),
                                            f"{tag} sym_bwd"),
                        "dual_fwd": lse_err(got["dual_fwd"], dual_lse,
                                            f"{tag} dual_fwd")}
                want = fd.dual_bwd_plain(*dual)
                errs["dual_bwd"] = grad_err(got["dual_bwd"][:2], want[:2],
                                            f"{tag} dual_bwd")
                ds_rel = ((got["dual_bwd"][2] - want[2]).abs() / want[2].abs()).item()
                check(ds_rel <= DS_RTOL, f"{tag}: Σ coeff⊙z rel err {ds_rel:.3e} "
                                         f"(limit {DS_RTOL})")
                for name, err in errs.items():
                    worst[name] = max(worst[name], err)
                if tier == "default":
                    for name, run in runs.items():
                        again = run()
                        torch.cuda.synchronize()
                        check(all(torch.equal(x, y) for x, y in zip(got[name], again)),
                              f"{tag}: two launches of {name} differ")
                log("loss", f"{tag}: max|kernel-plain| "
                            + ", ".join(f"{k} {x:.3e}" for k, x in errs.items())
                            + f", Σ coeff⊙z rel err {ds_rel:.3e}; lse "
                            f"{min(x.min().item() for x in lse):.4f} to "
                            f"{max(x.max().item() for x in lse):.4f}"
                            + (", two launches bit for bit" if tier == "default" else ""))
    return worst


def pruned_timing_phase(fd, fg, smi: str) -> dict:
    """The pruned branch of each loss kernel and its plain version, bf16
    operands, connectivity masks, at the leg's and the config's batch;
    beside them the pairs' fwd+bwd and the rows route (both directions)
    that took the full CrossCLR loss before.  Returns {(name, B, D): (ms,
    plain_ms)}."""
    times = {}
    for b, d in PRUNED_TIMING:
        v32, t32, g_v, g_t = loss_inputs(b, d, seed=3)
        v, t = (x.contiguous() for x in fd._fetch_cast("default", v32, t32))
        keep = keep_masks(v32, t32)
        s = 1.0 / 0.03
        scale = torch.full((1,), s, device="cuda")
        lse = fd.sym_fwd_plain(v, t, s, NEG_WEIGHT, *keep)
        pairs = {
            "sym_fwd": (lambda: fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT, *keep),
                        lambda: fd.sym_fwd_plain(v, t, s, NEG_WEIGHT, *keep)),
            "sym_bwd": (
                lambda: fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s, NEG_WEIGHT, *keep),
                lambda: fd.sym_bwd_plain(v, t, *lse, g_v, g_t, s, NEG_WEIGHT, *keep)),
            "dual_fwd": (lambda: fd.dual_fwd_cuda(v, t, scale, NEG_WEIGHT, *keep),
                         lambda: fd.dual_fwd_plain(v, t, scale, NEG_WEIGHT, *keep)),
            "dual_bwd": (
                lambda: fd.dual_bwd_cuda(v, t, scale, *lse, g_v, g_t, NEG_WEIGHT, *keep),
                lambda: fd.dual_bwd_plain(v, t, scale, *lse, g_v, g_t, NEG_WEIGHT,
                                          *keep)),
        }
        bounds = loss_bounds(b, d, pruned=True)
        for name, (kernel, plain) in pairs.items():
            ms, plain_ms = median_ms(kernel), median_ms(plain)
            times[(name, b, d)] = (ms, plain_ms)
            log("loss", f"{name} pruned B={b} D={d} bf16 operands: kernel {ms:.4f} "
                        f"ms, plain {plain_ms:.4f} ms, bound "
                        f"{bounds[name]['bound_ms']:.4f} ms ({bounds[name]['bound_by']}) "
                        f"(median of 20; {smi})")
        # the rows route: each direction's lse, d rows and candidates' grads
        dirs = [((v, v, t, 0, scale), (keep[1], keep[0]), g_v),
                ((t, t, v, 0, scale), (keep[0], keep[1]), g_t)]
        lses = [fg.rows_lse_plain(*a, NEG_WEIGHT, *k) for a, k, _ in dirs]

        def rows_fwd():
            for a, k, _ in dirs:
                fg.rows_lse_cuda(*a, NEG_WEIGHT, *k)

        def rows_bwd():
            for (a, k, g), lse_r in zip(dirs, lses):
                fg.rows_bwd_rows_cuda(*a, lse_r, g, NEG_WEIGHT, *k)
                fg.rows_bwd_cols_cuda(*a, lse_r, g, NEG_WEIGHT, *k)

        rows_ms = (median_ms(rows_fwd), median_ms(rows_bwd))
        times[("rows route", b, d)] = rows_ms
        log("loss", f"B={b} D={d} bf16, pruned, fwd + bwd: dual pair "
                    f"{times[('dual_fwd', b, d)][0]:.4f} + "
                    f"{times[('dual_bwd', b, d)][0]:.4f} ms, sym pair "
                    f"{times[('sym_fwd', b, d)][0]:.4f} + "
                    f"{times[('sym_bwd', b, d)][0]:.4f} ms, the rows route (both "
                    f"directions) {rows_ms[0]:.4f} + {rows_ms[1]:.4f} ms "
                    f"(median of 20; {smi})")
    return times


# ---------------------------------------------------------------------------
# the per-direction kernels (large-batch training)
# ---------------------------------------------------------------------------


def direction_check_phase(fc, fd) -> dict:
    """Both per-direction kernels against their plain versions, each
    direction, on identical inputs; then the per-direction pair's lse
    against the sym pair's.  Returns the worst absolute error of each."""
    worst = dict.fromkeys(fc.KERNELS, 0.0)
    for b, d in DIRECTION_SHAPES:
        v32, t32, g_v, g_t = loss_inputs(b, d, seed=b + d + 2)
        for tier in ("highest", "default"):
            v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
            errs = dict.fromkeys(fc.KERNELS, 0.0)
            for tau in DIRECTION_TAUS:
                for w in (NEG_WEIGHT, 0.0):
                    tag = f"B={b} D={d} {tier} τ={tau:.6g} w={w}"
                    s = 1.0 / tau
                    for a, o, g_a, g_o in ((v, t, g_v, g_t), (t, v, g_t, g_v)):
                        lse_a = fc.lse_fwd_plain(a, o, s, w)
                        lse_o = fc.lse_fwd_plain(o, a, s, w)
                        errs["lse_fwd"] = max(errs["lse_fwd"], lse_err(
                            (fc.lse_fwd_cuda(a, o, s, w),), (lse_a,),
                            f"{tag} lse_fwd"))
                        errs["lse_bwd"] = max(errs["lse_bwd"], grad_err(
                            (fc.lse_bwd_cuda(a, o, lse_a, lse_o, g_a, g_o, s, w),),
                            (fc.lse_bwd_plain(a, o, lse_a, lse_o, g_a, g_o, s, w),),
                            f"{tag} lse_bwd"))
            torch.cuda.synchronize()
            for name, err in errs.items():
                worst[name] = max(worst[name], err)
            log("direction", f"B={b} D={d} {tier} (τ = 0.03, 0.01, 1/79; w = "
                             f"{NEG_WEIGHT}, 0; both directions): max|kernel-plain| "
                             + ", ".join(f"{k} {x:.3e}" for k, x in errs.items()))
    # at 4096 x 256: random features at τ = 0.03 and collapsed ones at
    # τ = 1/79, and two launches of the bf16 forward bit for bit
    b, d = DIRECTION_TIMING
    for tau, noise in DIRECTION_LEG_CASES:
        s = 1.0 / tau
        v32, t32, _, _ = leg_inputs(b, d, noise, seed=12)
        for tier in ("highest", "default"):
            v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
            tag = (f"B={b} D={d} {tier} τ={tau:.6g} w={NEG_WEIGHT}"
                   + (f", collapsed (noise {noise})" if noise else ""))
            err = 0.0
            for a, o in ((v, t), (t, v)):
                got = fc.lse_fwd_cuda(a, o, s, NEG_WEIGHT)
                err = max(err, lse_err((got,), (fc.lse_fwd_plain(a, o, s, NEG_WEIGHT),),
                                       f"{tag} lse_fwd"))
                if tier == "default":
                    again = fc.lse_fwd_cuda(a, o, s, NEG_WEIGHT)
                    torch.cuda.synchronize()
                    check(torch.equal(got, again), f"{tag}: two launches of lse_fwd differ")
            worst["lse_fwd"] = max(worst["lse_fwd"], err)
            log("direction", f"{tag}: max|kernel-plain| lse_fwd {err:.3e} (both "
                             f"directions)" + (", two launches bit for bit"
                                               if tier == "default" else ""))
    # two kernel pairs, one function: the per-direction lse against sym's
    v32, t32, _, _ = loss_inputs(b, d, seed=9)
    s = 1.0 / 0.03
    for tier in ("highest", "default"):
        v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
        got = (fc.lse_fwd_cuda(v, t, s, NEG_WEIGHT), fc.lse_fwd_cuda(t, v, s, NEG_WEIGHT))
        err = lse_err(got, fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT),
                      f"B={b} D={d} {tier} per-direction vs sym lse")
        log("direction", f"B={b} D={d} {tier} τ=0.03: the per-direction pair's lse "
                         f"vs the sym pair's: max|Δlse| {err:.3e} (atol = rtol = "
                         f"{LSE_TOL})")
    return worst


def leg_inputs(b: int, d: int, noise: float, seed: int):
    """:func:`loss_inputs`; with ``noise`` > 0 the features collapsed near
    one shared unit direction u, ``normalize(u + noise·N(0, I))``: every
    cosine near ``1 − noise²·D``, as a random-init tower's embeddings lie."""
    v, t, g_v, g_t = loss_inputs(b, d, seed)
    if noise:
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        u = torch.nn.functional.normalize(
            torch.randn(1, d, generator=gen, device="cuda"), dim=1)
        v, t = (torch.nn.functional.normalize(
            u + noise * torch.randn(b, d, generator=gen, device="cuda"), dim=1)
            for _ in range(2))
    return v, t, g_v, g_t


def direction_leg_check_phase(fc, fd) -> dict:
    """Both per-direction kernels at the leg's 65,536 x 256, where the
    plain version's [B, 2B] logits (34 GB) do not fit: every row's lse
    against the plain lse taken in blocks of DIRECTION_BLOCK anchor rows,
    and the gradient rows of three blocks against the plain backward on
    those rows (fed the plain lse); both tiers, both directions, w = 0.8,
    each case of DIRECTION_LEG_CASES.  The bf16 sym backward's rows too
    (both its directions are the factored lse_bwd there).  Returns the
    worst absolute error of each kernel, sym_bwd's included."""
    b, d = PODSLICE_BATCH, 256
    worst = dict.fromkeys((*fc.KERNELS, "sym_bwd"), 0.0)
    n = b // DIRECTION_BLOCK
    every = [slice(i * DIRECTION_BLOCK, (i + 1) * DIRECTION_BLOCK) for i in range(n)]
    checked = [every[0], every[n // 2], every[-1]]
    for tau, noise in DIRECTION_LEG_CASES:
        s = 1.0 / tau
        v32, t32, g_v, g_t = leg_inputs(b, d, noise, seed=11)
        for tier in ("highest", "default"):
            v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
            tag = (f"B={b} D={d} {tier} τ={tau:.6g} w={NEG_WEIGHT}"
                   + (f", collapsed (noise {noise})" if noise else ""))
            lse_v, lse_t = (torch.cat([fc.lse_fwd_plain(a, o, s, NEG_WEIGHT, rows)
                                       for rows in every])
                            for a, o in ((v, t), (t, v)))
            errs = {"lse_fwd": lse_err(
                (fc.lse_fwd_cuda(v, t, s, NEG_WEIGHT), fc.lse_fwd_cuda(t, v, s, NEG_WEIGHT)),
                (lse_v, lse_t), f"{tag} lse_fwd"), "lse_bwd": 0.0, "sym_bwd": 0.0}
            drift = 0.0  # the factored gradient against the subtract-first one
            # the bf16 sym backward: both directions' factored lse_bwd
            sym = (fd.sym_bwd_cuda(v, t, lse_v, lse_t, g_v, g_t, s, NEG_WEIGHT)
                   if tier == "default" else None)
            for k, (a, o, la, lo, ga, go) in enumerate(((v, t, lse_v, lse_t, g_v, g_t),
                                                        (t, v, lse_t, lse_v, g_t, g_v))):
                grad = fc.lse_bwd_cuda(a, o, la, lo, ga, go, s, NEG_WEIGHT)
                for rows in checked:
                    want = fc.lse_bwd_plain(a, o, la, lo, ga, go, s, NEG_WEIGHT, rows)
                    errs["lse_bwd"] = max(errs["lse_bwd"], grad_err(
                        (grad[rows],), (want,),
                        f"{tag} lse_bwd rows {rows.start}-{rows.stop - 1}"))
                    if sym is not None:
                        errs["sym_bwd"] = max(errs["sym_bwd"], grad_err(
                            (sym[k][rows],), (want,),
                            f"{tag} sym_bwd rows {rows.start}-{rows.stop - 1}"))
                    if noise:  # the plain backward's other form, logged only
                        with mock.patch.object(fc, "factored", lambda *_: False):
                            exact = fc.lse_bwd_plain(a, o, la, lo, ga, go, s,
                                                     NEG_WEIGHT, rows)
                        drift = max(drift, ((grad[rows] - exact).abs().max()
                                            / exact.abs().max()).item())
            for name, err in errs.items():
                worst[name] = max(worst[name], err)
            lse = torch.cat([lse_v, lse_t])
            line = (f"{tag}: max|kernel-plain| lse_fwd {errs['lse_fwd']:.3e} over all "
                    f"{b} rows of each direction, lse_bwd {errs['lse_bwd']:.3e}"
                    + (f" and sym_bwd {errs['sym_bwd']:.3e}" if sym is not None else "")
                    + f" over rows {', '.join(f'{r.start}-{r.stop - 1}' for r in checked)}; "
                    f"lse {lse.min().item():.4f} to {lse.max().item():.4f}")
            if noise:
                line += (f", e^(-lse) subnormal (lse > {SUBNORMAL_LSE}) in "
                         f"{int((lse > SUBNORMAL_LSE).sum())} of {2 * b} rows; the "
                         f"factored kernel's gradient vs the subtract-first plain: "
                         f"{drift:.3e} of the largest entry (logged, unchecked)")
            log("direction", line)
            del v, t, lse_v, lse_t, lse, grad, want, sym
            torch.cuda.empty_cache()
    return worst


def direction_timing_phase(fc, fd, smi: str) -> dict:
    """Each per-direction kernel and its plain version at 4096 x 256 (median
    of 20); the kernels alone at the leg's 65,536 x 256 (median of 3), beside
    the sym pair at that shape.  bf16 operands.  Returns {(name, B, D): ms}
    with the plain times under ("plain " + name, B, D)."""
    times = {}
    s = 1.0 / 0.03
    for (b, d), n in ((DIRECTION_TIMING, 20), ((PODSLICE_BATCH, 256), 3)):
        v32, t32, g_v, g_t = loss_inputs(b, d, seed=3)
        v, t = (x.contiguous() for x in fd._fetch_cast("default", v32, t32))
        del v32, t32
        lse_v = fc.lse_fwd_cuda(v, t, s, NEG_WEIGHT)
        lse_t = fc.lse_fwd_cuda(t, v, s, NEG_WEIGHT)
        bargs = (v, t, lse_v, lse_t, g_v, g_t, s, NEG_WEIGHT)
        pairs = {"lse_fwd": (lambda: fc.lse_fwd_cuda(v, t, s, NEG_WEIGHT),
                             lambda: fc.lse_fwd_plain(v, t, s, NEG_WEIGHT)),
                 "lse_bwd": (lambda: fc.lse_bwd_cuda(*bargs),
                             lambda: fc.lse_bwd_plain(*bargs))}
        bounds = direction_bounds(b, d)
        warmup = 3 if n == 20 else 1
        for name, (kernel, plain) in pairs.items():
            times[(name, b, d)] = ms = median_ms(kernel, n=n, warmup=warmup)
            line = f"{name} B={b} D={d} bf16 operands: kernel {ms:.4f} ms"
            if b == DIRECTION_TIMING[0]:
                times[("plain " + name, b, d)] = plain_ms = median_ms(plain)
                line += f", plain {plain_ms:.4f} ms"
            log("direction", line + f", bound {bounds[name]['bound_ms']:.4f} ms "
                                    f"({bounds[name]['bound_by']}) (median of {n}; {smi})")
        if b == PODSLICE_BATCH:
            lse = fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT)
            sym = (median_ms(lambda: fd.sym_fwd_cuda(v, t, s, NEG_WEIGHT), n=n,
                             warmup=1),
                   median_ms(lambda: fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s,
                                                     NEG_WEIGHT), n=n, warmup=1))
            mine = (2 * times[("lse_fwd", b, d)], 2 * times[("lse_bwd", b, d)])
            times[("sym pair", b, d)] = sym
            log("direction", f"B={b} D={d} bf16, both directions, fwd + bwd: the "
                             f"per-direction pair (two launches each) {mine[0]:.1f} + "
                             f"{mine[1]:.1f} ms, the sym pair {sym[0]:.1f} + "
                             f"{sym[1]:.1f} ms (median of {n}; {smi})")
        del v, t, lse_v, lse_t, bargs, pairs
        torch.cuda.empty_cache()
    return times


def direction_bounds(b: int, d: int) -> dict:
    """Each per-direction kernel's least time at bf16 operands (the leg's
    `default` tier), counted as the rows kernels are: A·Oᵀ is one product
    of 2·B²·D operations and A·Aᵀ is symmetric, half of one; the forward is
    those 1.5 units, the backward recomputes them and adds P·O and Q·A,
    3.5 units.  Each input is read once and each output written once."""
    unit = 2 * b * b * d
    features = 2 * b * d * 2  # anchor, other in bf16
    work = {"lse_fwd": (features + b * 4, 1.5 * unit),
            "lse_bwd": (features + 4 * b * 4 + b * d * 4, 3.5 * unit)}
    return {name: bound(nbytes, flops, torch.bfloat16)
            for name, (nbytes, flops) in work.items()}


# ---------------------------------------------------------------------------
# the row-block kernels (global negatives)
# ---------------------------------------------------------------------------


def rows_inputs(b: int, d: int, seed: int):
    """Unit-norm fp32 features, their pruning masks (:func:`keep_masks`)
    and positive lse cotangents."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v, t = (torch.nn.functional.normalize(
        torch.randn(b, d, generator=gen, device="cuda"), dim=1) for _ in range(2))
    g = (0.5 + torch.rand(b, 1, generator=gen, device="cuda")) / (2 * b)
    return v, t, keep_masks(v, t), g


def rank_args(fd, fg, b_loc: int, b: int, d: int, off: int, seed: int):
    """The rows kernels' arguments at bf16 operands, pruned, τ = 0.03,
    for anchor rows off .. off + b_loc of a batch of b: (args, bargs),
    bargs with the plain lse and the rows' cotangents."""
    v32, t32, masks, g = rows_inputs(b, d, seed=seed)
    v, t = (x.contiguous() for x in fd._fetch_cast("default", v32, t32))
    scale = torch.full((1,), 1.0 / 0.03, device="cuda")
    keep = (masks[1], masks[0])
    args = (v[off:off + b_loc].contiguous(), v, t, off, scale, NEG_WEIGHT, *keep)
    bargs = (*args[:5], fg.rows_lse_plain(*args), g[off:off + b_loc].contiguous(),
             NEG_WEIGHT, *keep)
    return args, bargs


def rows_check(fg, rows, a_all, o_all, off, scale, g, masks, worst, tag):
    """Each rows kernel against its plain version on the same operands;
    returns the kernels' outputs (lse, d_rows, ds_rows, d_other, d_anchor)."""
    args = (rows, a_all, o_all, off, scale, NEG_WEIGHT, *masks)

    def once_more(fn, got, name):
        # the tensor-core builds: their parts' fixed order
        if rows.dtype == torch.bfloat16:
            again = fn()
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(again, got)),
                  f"{tag}: two launches of {name} differ")

    want = fg.rows_lse_plain(*args)
    lse = fg.rows_lse_cuda(*args)
    once_more(lambda: (fg.rows_lse_cuda(*args),), (lse,), "rows_lse")
    worst["rows_lse"] = max(worst["rows_lse"], lse_err([lse], [want], f"{tag} rows_lse"))
    bargs = (*args[:5], want, g, NEG_WEIGHT, *masks)
    d_rows, ds_rows = fg.rows_bwd_rows_cuda(*bargs)
    once_more(lambda: fg.rows_bwd_rows_cuda(*bargs), (d_rows, ds_rows), "rows_bwd_rows")
    p_rows, p_ds = fg.rows_bwd_rows_plain(*bargs)
    worst["rows_bwd_rows"] = max(worst["rows_bwd_rows"], grad_err(
        [d_rows], [p_rows], f"{tag} rows_bwd_rows"))
    # Σ p⊙z row by row (every z of a split feature dimension writes the
    # same value from z = 0), then the total that feeds dτ
    worst[DS_KEY] = max(worst[DS_KEY], lse_err(
        [ds_rows], [p_ds], f"{tag} rows_bwd_rows Σ p⊙z per row"))
    ds_rel = ((ds_rows.sum() - p_ds.sum()).abs() / p_ds.sum().abs()).item()
    check(ds_rel <= DS_RTOL, f"{tag}: Σ p⊙z rel err {ds_rel:.3e} (limit {DS_RTOL})")
    cols = fg.rows_bwd_cols_cuda(*bargs)
    once_more(lambda: fg.rows_bwd_cols_cuda(*bargs), cols, "rows_bwd_cols")
    worst["rows_bwd_cols"] = max(worst["rows_bwd_cols"], grad_err(
        cols, fg.rows_bwd_cols_plain(*bargs), f"{tag} rows_bwd_cols"))
    return lse, d_rows, ds_rows, *cols


def global_check_phase(fd, fg) -> dict:
    """(a) the rows kernels against their plain versions; (b) four
    emulated ranks against one call.  Returns each kernel's worst absolute
    error."""
    worst = dict.fromkeys((*fg.KERNELS, DS_KEY), 0.0)
    for b, d in GLOBAL_SHAPES:
        v32, t32, masks, g = rows_inputs(b, d, seed=b + d)
        for tier in ("highest", "default"):
            v, t = (x.contiguous() for x in fd._fetch_cast(tier, v32, t32))
            for pruned in (False, True):
                keep = (masks[1], masks[0]) if pruned else (None, None)
                for tau in (0.03, 0.05):
                    scale = torch.full((1,), 1.0 / tau, device="cuda")
                    rows_check(fg, v, v, t, 0, scale, g, keep, worst,
                               f"B={b} D={d} {tier} pruned={pruned} τ={tau}")
            torch.cuda.synchronize()
            log("global", f"B={b} D={d} {tier}: rows kernels vs plain, pruned "
                          f"and unpruned, τ in (0.03, 0.05): worst max|kernel-plain| "
                          + ", ".join(f"{k} {x:.3e}" for k, x in worst.items()))

    # (b) blocks of b_loc rows at offsets r·b_loc against one call: whole
    # tiles at 4096 (b_loc = 1024), and (b') unaligned ones at 1000 (b_loc =
    # 250: each rank's own columns start inside a candidate tile)
    for b, d in (GLOBAL_SHAPES[0], GLOBAL_SHAPES[1]):
        b_loc = b // EMULATED_RANKS
        v32, t32, masks, g = rows_inputs(b, d, seed=17)
        v, t = (x.contiguous() for x in fd._fetch_cast("default", v32, t32))
        scale = torch.full((1,), 1.0 / 0.03, device="cuda")
        for pruned in (False, True):
            keep = (masks[1], masks[0]) if pruned else (None, None)
            tag = f"emulated ranks B={b} pruned={pruned}"
            whole = rows_check(fg, v, v, t, 0, scale, g, keep, worst, tag + " one call")
            parts = [rows_check(fg, v[r * b_loc:(r + 1) * b_loc].contiguous(), v, t,
                                r * b_loc, scale,
                                g[r * b_loc:(r + 1) * b_loc].contiguous(), keep, worst,
                                f"{tag} rank {r}")
                     for r in range(EMULATED_RANKS)]
            lse_err([torch.cat([p[0] for p in parts])], [whole[0]], tag + " lse")
            grad_err([torch.cat([p[1] for p in parts]), sum(p[3] for p in parts),
                      sum(p[4] for p in parts)], [whole[1], whole[3], whole[4]],
                     tag + " gradients")
            lse_err([torch.cat([p[2] for p in parts])], [whole[2]],
                    tag + " Σ p⊙z per row")
            ds_rel = ((sum(p[2].sum() for p in parts) - whole[2].sum()).abs()
                      / whole[2].sum().abs()).item()
            check(ds_rel <= DS_RTOL, f"{tag}: Σ p⊙z rel err {ds_rel:.3e}")
            log("global", f"{EMULATED_RANKS} emulated ranks of {b_loc} rows at offsets "
                          f"{[r * b_loc for r in range(EMULATED_RANKS)]} of {b}, "
                          f"pruned={pruned}, bf16 operands: the blocks' lse, "
                          f"concatenated row gradients and summed candidate gradients "
                          f"equal one call's")
    return worst


def global_loss_phase(fg) -> dict:
    """(c) the global losses through a 1-rank NCCL group against the
    one-device fused and eager losses (fp32 operands).  Returns the rows
    kernels' launches in the global losses: their main path."""
    import torch.distributed as dist

    from crossclr_tpu_torch.losses import functional as F
    from crossclr_tpu_torch.ops.fused_crossclr import cross_clr_intra_fused
    from crossclr_tpu_torch.parallel import global_cross_clr, global_cross_clr_intra

    b, d = GLOBAL_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(23)
    video, text = (torch.randn(b, d, generator=gen, device="cuda") for _ in range(2))
    cases = {
        "global_cross_clr": (
            lambda v, t: global_cross_clr(v, t, use_fused=True),
            [("cross_clr_fused", lambda v, t: fg.cross_clr_fused(v, t)),
             ("eager cross_clr", lambda v, t: F.cross_clr(v, t))]),
        "global_cross_clr_intra": (
            lambda v, t: global_cross_clr_intra(v, t, use_fused=True),
            [("cross_clr_intra_fused", lambda v, t: cross_clr_intra_fused(v, t)),
             ("eager cross_clr_intra", lambda v, t: F.cross_clr_intra(v, t))]),
    }

    def run(fn):
        v = video.clone().requires_grad_()
        t = text.clone().requires_grad_()
        loss = fn(v, t)
        loss.backward()
        return loss.detach(), v.grad, t.grad

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    launches = dict.fromkeys(fg.KERNELS, 0)
    try:
        for name, (fn, refs) in cases.items():
            reset_counts(fg)  # the rows kernels' path: one global loss
            got = run(fn)
            torch.cuda.synchronize()
            grown = dict(fg.launch_counts)
            check(all(grown[k] == 2 for k in fg.KERNELS),
                  f"{name} launched the rows kernels {grown} times, want 2 each")
            for k in fg.KERNELS:
                launches[k] += grown[k]
            for ref_name, ref in refs:
                want = run(ref)
                lerr = abs(got[0].item() - want[0].item())
                check(lerr <= LSE_TOL + LSE_TOL * abs(want[0].item()),
                      f"{name} {got[0].item()} vs {ref_name} {want[0].item()}")
                gerr = grad_err(got[1:], want[1:], f"{name} vs {ref_name} gradients")
                log("global", f"{name} (1-rank NCCL group, use_fused, B={b} D={d}) "
                              f"{got[0].item():.9g} vs {ref_name} {want[0].item():.9g}: "
                              f"|Δloss| {lerr:.3e}, max|Δgrad| {gerr:.3e}")
    finally:
        dist.destroy_process_group()
    return launches


def rows_bounds(b_loc: int, b: int, d: int) -> dict:
    """Each rows kernel's least time at bf16 operands (the leg's `default`
    tier) at the bf16 peak, for b_loc anchor rows of a batch of B. The
    inter logits are one product of 2·b_loc·B·D; the intra ones hold the
    anchors' own symmetric b_loc×b_loc block, of which only one triangle
    is needed (half a product at b_loc = B). The forward is those logits;
    each backward recomputes them and adds two gradient products. Each
    input is read once (features, the two bool masks, the scale, lse and
    g) and each output written once; at b_loc = B one [B, D] array serves
    as anchor_rows and anchor_all, below it the anchor rows are an array
    of their own (a rank's block)."""
    features = 2 * b * d * 2  # anchor_all, other_all in bf16
    if b_loc < b:
        features += b_loc * d * 2  # anchor_rows
    masks = 2 * b + 4  # + the scale
    rows = b_loc * 4
    product = 2 * b_loc * b * d
    logits = product + (product - b_loc * b_loc * d)  # inter + intra
    work = {
        "rows_lse": (features + masks + rows, logits),
        "rows_bwd_rows": (features + masks + 2 * rows + b_loc * d * 4 + rows,
                          logits + 2 * product),
        "rows_bwd_cols": (features + masks + 2 * rows + 2 * b * d * 4,
                          logits + 2 * product),
    }
    return {name: bound(nbytes, flops, torch.bfloat16)
            for name, (nbytes, flops) in work.items()}


def global_timing_phase(fd, fg, smi: str, worst: dict) -> dict:
    """(d) each rows kernel and its plain version, bf16 operands, pruned,
    offset 0 with anchors = candidates at each GLOBAL_TIMING shape, and
    (d') one rank's block at RANK_SHAPE, first held to the plain version on
    the timed operands (into ``worst``); returns {(name, b_loc, B, D):
    (ms, plain_ms)}."""
    times = {}
    cases = [(b, b, d, 0) for b, d in GLOBAL_TIMING] + [RANK_SHAPE]
    for b_loc, b, d, off in cases:
        args, bargs = rank_args(fd, fg, b_loc, b, d, off, seed=3)
        rows, a_all, o_all, _, scale, _, *keep = args
        rows_check(fg, rows, a_all, o_all, off, scale, bargs[6], keep, worst,
                   f"timed b_loc={b_loc} of B={b} D={d} off={off} default pruned")
        log("global", f"b_loc={b_loc} of B={b} D={d} off={off} default, pruned, the "
                      "timed operands: rows kernels vs plain, worst max|kernel-plain| "
                      "so far " + ", ".join(f"{k} {x:.3e}" for k, x in worst.items()))
        pairs = {
            "rows_lse": (lambda: fg.rows_lse_cuda(*args),
                         lambda: fg.rows_lse_plain(*args)),
            "rows_bwd_rows": (lambda: fg.rows_bwd_rows_cuda(*bargs),
                              lambda: fg.rows_bwd_rows_plain(*bargs)),
            "rows_bwd_cols": (lambda: fg.rows_bwd_cols_cuda(*bargs),
                              lambda: fg.rows_bwd_cols_plain(*bargs)),
        }
        bounds = rows_bounds(b_loc, b, d)
        for name, (kernel, plain) in pairs.items():
            ms, plain_ms = median_ms(kernel), median_ms(plain)
            times[(name, b_loc, b, d)] = (ms, plain_ms)
            log("global", f"{name} b_loc={b_loc} of B={b} D={d} off={off} bf16 "
                          f"operands, pruned: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                          f"ms, bound {bounds[name]['bound_ms']:.4f} ms "
                          f"({bounds[name]['bound_by']}) (median of 20; {smi})")
        del args, bargs, pairs
    return times


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------


def csv_rows(path: Path) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def run_train(train, options: list[str], overrides: list[str]) -> None:
    # argparse takes the positional overrides after every option
    rc = train.main(["--config", str(ROOT / TRAIN_CONFIG), *options,
                     *TRAIN_OVERRIDES, *overrides])
    check(rc == 0, f"train.main exited {rc}")


def train_rows(path: Path) -> tuple[list[dict], list[dict]]:
    rows = csv_rows(path)
    return ([r for r in rows if r.get("loss")],
            [r for r in rows if r.get("eval/v2t/R@1")])


def check_train_rows(rows: list[dict], evals: list[dict], n_eval: int, tag: str):
    losses = [float(r["loss"]) for r in rows]
    check(len(losses) >= 2 and all(math.isfinite(x) for x in losses),
          f"{tag}: losses {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    chance = 100.0 / n_eval
    for r in evals:
        check(float(r["eval/v2t/R@1"]) > chance,
              f"{tag}: eval v2t/R@1 {r['eval/v2t/R@1']} at step {r['step']} "
              f"not above chance {chance:.4f}")
    return losses


def reset_counts(fd) -> None:
    for name in fd.launch_counts:
        fd.launch_counts[name] = 0


def train_phase(fd, smi: str) -> dict:
    """The training CLI at full width: sym route, resume, then learnable τ
    (dual route).  Returns each loss kernel's launches on its path."""
    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.training import CheckpointManager

    n_eval = int(16384 * 0.1)  # data.eval_fraction's default
    launches = {}
    with tempfile.TemporaryDirectory(prefix="crossclr_smoke_") as tmp:
        tmp = Path(tmp)
        ckpt, metrics = tmp / "ckpt", tmp / "metrics.csv"
        leg = ["--metrics-csv", str(metrics)]
        reset_counts(fd)  # the sym path: leg 1 and its resume
        t0 = time.perf_counter()
        run_train(train, ["--steps", "300", *leg], [f"checkpoint_dir={ckpt}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        leg1 = dict(fd.launch_counts)
        rows, evals = train_rows(metrics)
        losses = check_train_rows(rows, evals, n_eval, "leg 1")
        check([int(r["step"]) for r in evals] == [100, 200, 300],
              f"leg 1 evals at {[r['step'] for r in evals]}")
        check(CheckpointManager(ckpt).latest_step() == 300, "leg 1 checkpoint")
        pairs_per_sec = float(rows[-1]["pairs_per_sec"])
        log("train", f"leg 1 (τ=0.03, sym route): 300 steps in {seconds:.1f} s; "
                     f"loss {losses[0]:.4f} (step {rows[0]['step']}) -> "
                     f"{losses[-1]:.4f} (step 300); eval v2t/R@1 "
                     f"{float(evals[-1]['eval/v2t/R@1']):.2f}, t2v/R@1 "
                     f"{float(evals[-1]['eval/t2v/R@1']):.2f} over {n_eval} "
                     f"held-out pairs (chance {100 / n_eval:.3f}); launches {leg1}")
        log("train", f"steady train rate (steps 221-300, batch 1024): "
                     f"{pairs_per_sec:.1f} pairs/s, "
                     f"{float(rows[-1]['steps_per_sec']):.2f} steps/s ({smi})")
        check(leg1["sym_fwd"] > 0 and leg1["sym_bwd"] > 0,
              f"leg 1 launched no sym kernel: {leg1}")
        check(leg1["dual_fwd"] == 0 and leg1["dual_bwd"] == 0,
              f"leg 1 took the dual route: {leg1}")

        run_train(train, ["--steps", "340", *leg], [f"checkpoint_dir={ckpt}"])
        rows2, _ = train_rows(metrics)
        resumed = [int(r["step"]) for r in rows2[len(rows):]]
        check(CheckpointManager(ckpt).latest_step() == 340 and resumed
              and min(resumed) > 300 and max(resumed) == 340,
              f"resume did not continue the step count: {resumed}")
        launches.update({k: fd.launch_counts[k] for k in ("sym_fwd", "sym_bwd")})
        log("train", f"resumed from step 300 to {max(resumed)}; sym launches "
                     f"{launches}")

        ckpt2, metrics2 = tmp / "ckpt_tau", tmp / "metrics_tau.csv"
        reset_counts(fd)  # the dual path: learnable temperature
        run_train(train, ["--steps", "100", "--metrics-csv", str(metrics2)],
                  ["train.learnable_temperature=true", f"checkpoint_dir={ckpt2}"])
        torch.cuda.synchronize()
        leg2 = dict(fd.launch_counts)
        rows, evals = train_rows(metrics2)
        losses = check_train_rows(rows, evals, n_eval, "leg 2")
        scales = [float(r["logit_scale"]) for r in rows]
        check(all(abs(x) <= LOGIT_SCALE_BOUND + 1e-6 for x in scales)
              and scales[-1] != 0.0,
              f"logit_scale did not move or left ±ln 100: {scales}")
        check(leg2["dual_fwd"] > 0 and leg2["dual_bwd"] > 0,
              f"leg 2 launched no dual kernel: {leg2}")
        check(leg2["sym_fwd"] == 0 and leg2["sym_bwd"] == 0,
              f"leg 2 took the sym route: {leg2}")
        launches.update({k: leg2[k] for k in ("dual_fwd", "dual_bwd")})
        log("train", f"leg 2 (learnable τ, dual route): loss {losses[0]:.4f} -> "
                     f"{losses[-1]:.4f}; logit_scale {scales[0]:.6f} -> "
                     f"{scales[-1]:.6f} (effective τ "
                     f"{float(rows[-1]['effective_temperature']):.6f}); eval "
                     f"v2t/R@1 {float(evals[-1]['eval/v2t/R@1']):.2f}; "
                     f"steady {float(rows[-1]['pairs_per_sec']):.1f} pairs/s; "
                     f"launches {leg2} ({smi})")
    return launches


def transformer_train_phase(fa, fd, smi: str) -> dict:
    """The training CLI on the transformer towers at full width, with
    attention dropout; returns the flash kernels' launches on that path."""
    from crossclr_tpu_torch import train

    n_eval = int(4096 * 0.1)  # data.eval_fraction's default
    want = 8 * TRANSFORMER_STEPS  # 4 layers x 2 towers per train step
    with tempfile.TemporaryDirectory(prefix="crossclr_smoke_") as tmp:
        tmp = Path(tmp)
        metrics = tmp / "metrics.csv"
        reset_counts(fa)  # the transformer path
        reset_counts(fd)
        t0 = time.perf_counter()
        rc = train.main(["--config", str(ROOT / TRANSFORMER_CONFIG),
                         "--steps", str(TRANSFORMER_STEPS),
                         "--metrics-csv", str(metrics), *TRANSFORMER_OVERRIDES,
                         f"checkpoint_dir={tmp / 'ckpt'}"])
        check(rc == 0, f"train.main exited {rc}")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        flash, loss = dict(fa.launch_counts), dict(fd.launch_counts)
        rows, evals = train_rows(metrics)
    losses = check_train_rows(rows, evals, n_eval, "transformer leg")
    check([int(r["step"]) for r in evals] == [20, 40],
          f"transformer leg evals at {[r['step'] for r in evals]}")
    check(flash["flash_dq"] == want and flash["flash_dkv"] == want,
          f"flash backward launches {flash}, want {want} each")
    check(flash["flash_fwd"] >= want, f"flash forward launches {flash}")
    check(loss["sym_fwd"] > 0 and loss["sym_bwd"] > 0,
          f"transformer leg launched no sym kernel: {loss}")
    log("train", f"transformer leg (LSMDC towers, flash attention, dropout "
                 f"0.1, batch 1024): {TRANSFORMER_STEPS} steps in {seconds:.1f} s; "
                 f"loss {losses[0]:.4f} (step {rows[0]['step']}) -> "
                 f"{losses[-1]:.4f} (step {rows[-1]['step']}); eval v2t/R@1 "
                 f"{float(evals[-1]['eval/v2t/R@1']):.2f}, t2v/R@1 "
                 f"{float(evals[-1]['eval/t2v/R@1']):.2f} over {n_eval} held-out "
                 f"pairs (chance {100 / n_eval:.3f}); launches {flash} {loss}")
    log("train", f"transformer steady train rate (the last eval interval "
                 f"after its first dispatch, batch 1024): "
                 f"{float(rows[-1]['pairs_per_sec']):.1f} pairs/s, "
                 f"{float(rows[-1]['steps_per_sec']):.2f} steps/s ({smi})")
    return flash


def run_full_leg(fa, fd, fg, fc, steps: int, extra: list[str]):
    """train.main on the full-CrossCLR config at full width, every launch
    count set to 0 just before and read just after.  Returns (the counts,
    the logged rows, the eval rows, seconds, what the trainer wrote to
    stderr)."""
    from crossclr_tpu_torch import train

    with tempfile.TemporaryDirectory(prefix="crossclr_smoke_") as tmp:
        tmp = Path(tmp)
        metrics = tmp / "metrics.csv"
        for counts in (fa, fd, fg, fc):  # the full-CrossCLR path
            reset_counts(counts)
        t0 = time.perf_counter()
        err = io.StringIO()  # the trainer reports its weight ESS on stderr
        try:
            with contextlib.redirect_stderr(err):
                rc = train.main(["--config", str(ROOT / FULL_CONFIG),
                                 "--steps", str(steps), "--metrics-csv",
                                 str(metrics), *FULL_OVERRIDES, *extra,
                                 f"checkpoint_dir={tmp / 'ckpt'}"])
        finally:
            sys.stderr.write(err.getvalue())
        check(rc == 0, f"train.main exited {rc}")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**fa.launch_counts, **fd.launch_counts, **fg.launch_counts,
                  **fc.launch_counts}
        rows, evals = train_rows(metrics)
    return counts, rows, evals, seconds, err.getvalue()


def check_only(counts: dict, want: dict, tag: str) -> None:
    """Exactly the launches ``want`` and no other kernel's."""
    check(counts == {k: want.get(k, 0) for k in counts},
          f"{tag}: launches {counts}, want {want} and none of any other kernel")


def sym_launches(steps: int) -> dict:
    """A sym-route leg's launches: a forward and a backward a step, each
    backward in the Hopper design (the legs' features are contiguous
    copies, 256 or 384 wide)."""
    return {"sym_fwd": steps, "sym_bwd": steps, "sym_bwd_wgmma": steps}


def full_train_phase(fa, fd, fg, fc, smi: str) -> dict:
    """The training CLI on the full-CrossCLR config at full width, its
    learnable τ: the keep-mask branch of the dual kernels.  Returns the
    leg's launches."""
    n_eval = int(4096 * 0.1)  # data.eval_fraction's default
    counts, rows, evals, seconds, err = run_full_leg(fa, fd, fg, fc, FULL_STEPS, [])
    losses = check_train_rows(rows, evals, n_eval, "full-CrossCLR leg")
    check([int(r["step"]) for r in evals] == [15, 30],
          f"full-CrossCLR leg evals at {[r['step'] for r in evals]}")
    # one forward and one backward of the pair per step
    check_only(counts, {"dual_fwd": FULL_STEPS, "dual_bwd": FULL_STEPS},
               "full-CrossCLR leg")
    scales = [float(r["logit_scale"]) for r in rows]
    check(all(abs(x) <= LOGIT_SCALE_BOUND + 1e-6 for x in scales)
          and scales[-1] != 0.0,
          f"logit_scale did not move or left ±ln 100: {scales}")
    ess = [ln for ln in err.splitlines() if "positive-weight ESS" in ln]
    check(len(ess) == 1, f"full-CrossCLR leg: {len(ess)} weight ESS lines, want 1")
    log("train", f"full-CrossCLR leg, the trainer's report: {ess[0]}")
    launched = {k: x for k, x in counts.items() if x}
    log("train", f"full-CrossCLR leg ({FULL_CONFIG}, crossclr_fused, learnable τ, "
                 f"default tier, batch {LEG_BATCH}): {FULL_STEPS} steps in "
                 f"{seconds:.1f} s; loss {losses[0]:.4f} (step {rows[0]['step']}) -> "
                 f"{losses[-1]:.4f} (step {rows[-1]['step']}); logit_scale "
                 f"{scales[0]:.6f} -> {scales[-1]:.6f}; eval v2t/R@1 "
                 f"{float(evals[-1]['eval/v2t/R@1']):.2f}, t2v/R@1 "
                 f"{float(evals[-1]['eval/t2v/R@1']):.2f} over {n_eval} held-out "
                 f"pairs (chance {100 / n_eval:.3f}); launches {launched}")
    log("train", f"full-CrossCLR steady train rate (the last eval interval after "
                 f"its first dispatch, batch {LEG_BATCH}): "
                 f"{float(rows[-1]['pairs_per_sec']):.1f} pairs/s, "
                 f"{float(rows[-1]['steps_per_sec']):.2f} steps/s ({smi})")
    return launched


def full_static_phase(fa, fd, fg, fc, smi: str) -> dict:
    """The same leg at the config's static τ: the keep-mask branch of the
    sym kernels (2·m0 = 66.7 passes the pruned gate).  Returns its
    launches."""
    n_eval = int(4096 * 0.1)
    counts, rows, evals, seconds, _ = run_full_leg(
        fa, fd, fg, fc, FULL_STATIC_STEPS, ["train.learnable_temperature=false"])
    losses = check_train_rows(rows, evals, n_eval, "static-τ full-CrossCLR leg")
    check_only(counts, sym_launches(FULL_STATIC_STEPS), "static-τ full-CrossCLR leg")
    launched = {k: x for k, x in counts.items() if x}
    log("train", f"static-τ full-CrossCLR leg (τ=0.03, sym route, batch "
                 f"{LEG_BATCH}): {FULL_STATIC_STEPS} steps in {seconds:.1f} s; loss "
                 f"{losses[0]:.4f} (step {rows[0]['step']}) -> {losses[-1]:.4f} "
                 f"(step {rows[-1]['step']}); launches {launched}; last dispatch "
                 f"{float(rows[-1]['pairs_per_sec']):.1f} pairs/s ({smi})")
    return launched


def podslice_train_phase(fa, fd, fg, fc, smi: str) -> dict:
    """The training CLI on configs/podslice_32k.json at its widths and
    B = 65,536: the GradCache two-pass step (chunk 1024 as shipped) and the
    per-direction loss kernels, every launch count set to 0 just before
    and read just after.  Returns the leg's launches."""
    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.training import Trainer

    losses = []  # each step's loss, a device scalar: no extra sync
    train_step = Trainer.train_step

    def recording_step(self, state, batch):
        state, metrics = train_step(self, state, batch)
        losses.append(metrics["loss"])
        return state, metrics

    n_eval = int(PODSLICE_PAIRS * 0.1)  # data.eval_fraction's default
    with tempfile.TemporaryDirectory(prefix="crossclr_smoke_") as tmp:
        tmp = Path(tmp)
        metrics = tmp / "metrics.csv"
        for counts in (fa, fd, fg, fc):  # the large-batch path
            reset_counts(counts)
        Trainer.train_step = recording_step
        t0 = time.perf_counter()
        try:
            rc = train.main(["--config", str(ROOT / PODSLICE_CONFIG), "--steps",
                             str(PODSLICE_STEPS), "--metrics-csv", str(metrics),
                             *PODSLICE_OVERRIDES, f"checkpoint_dir={tmp / 'ckpt'}"])
        finally:
            Trainer.train_step = train_step
        check(rc == 0, f"train.main exited {rc}")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**fa.launch_counts, **fd.launch_counts, **fg.launch_counts,
                  **fc.launch_counts}
        rows, evals = train_rows(metrics)
    # two launches of each kernel per step: (v, t) and (t, v)
    check_only(counts, {"lse_fwd": 2 * PODSLICE_STEPS, "lse_bwd": 2 * PODSLICE_STEPS},
               "podslice leg")
    losses = [float(x) for x in losses]
    check(len(losses) == PODSLICE_STEPS and all(math.isfinite(x) for x in losses),
          f"podslice leg: losses {losses}")
    check(losses[-1] < losses[0], f"podslice leg: loss did not fall: {losses}")
    check(len(rows) == 1 and int(rows[0]["step"]) == PODSLICE_STEPS,
          f"podslice leg: one dispatch of {PODSLICE_STEPS} steps, logged {rows}")
    launched = {k: x for k, x in counts.items() if x}
    log("train", f"podslice leg ({PODSLICE_CONFIG}, crossclr_intra_fused τ=0.03, "
                 f"default tier, batch {PODSLICE_BATCH}, embedding_chunk 1024, one "
                 f"dispatch of {PODSLICE_STEPS} steps): {seconds:.1f} s with data, "
                 f"eval and checkpoint; per-step loss "
                 + ", ".join(f"{x:.4f}" for x in losses)
                 + f"; eval v2t/R@1 {float(evals[-1]['eval/v2t/R@1']):.3f}, t2v/R@1 "
                 f"{float(evals[-1]['eval/t2v/R@1']):.3f} over {n_eval} held-out "
                 f"pairs (chance {100 / n_eval:.4f}); launches {launched}")
    log("train", f"podslice train rate (the dispatch of {PODSLICE_STEPS} steps, "
                 f"first step included): {float(rows[-1]['pairs_per_sec']):.1f} "
                 f"pairs/s, {float(rows[-1]['steps_per_sec']):.4f} steps/s ({smi})")
    return launched


def grad_cache_phase(fc, smi: str) -> None:
    """The two-pass step on the card at the podslice widths in chunks of
    1024: at B = GRAD_CACHE_BATCH with the config's bf16 towers, pass 3's
    embeddings equal pass 1's bit for bit; with fp32 towers and fp32 loss
    operands, at each batch of GRAD_CACHE_COMPARE, every parameter
    gradient within GRAD_CACHE_BOUND of its largest entry of the one-pass
    step's, the per-direction kernels launched twice each per step where
    the loss's route is theirs."""
    from crossclr_tpu_torch.data import SyntheticPairs, epoch_batches
    from crossclr_tpu_torch.training import Trainer, loss_route
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    def first_batch(b: int):
        data = SyntheticPairs(num_pairs=b, video_dim=512, text_dim=384, seed=4)
        return next(iter(epoch_batches(data, b)))

    cfg = load_config(ROOT / PODSLICE_CONFIG)
    batch = first_batch(GRAD_CACHE_BATCH)
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cuda")
    state = trainer.init_state()
    calls = []
    hook = state.model.register_forward_hook(
        lambda module, args, out: calls.append(
            (torch.is_grad_enabled(), tuple(x.detach().clone() for x in out))))
    _, metrics = trainer.train_step(state, batch)
    hook.remove()
    k = GRAD_CACHE_BATCH // cfg.train.embedding_chunk
    check([grad for grad, _ in calls] == [False] * k + [True] * k,
          f"two-pass step: {len(calls)} tower calls, want {k} without and {k} "
          "with autograd")
    for i in range(k):
        for a, b in zip(calls[i][1], calls[k + i][1]):
            check(torch.equal(a, b), f"pass 3 re-encoded chunk {i} differently")
    log("gradcache", f"B={GRAD_CACHE_BATCH}, chunk {cfg.train.embedding_chunk}, "
                     f"bf16 towers: pass 3's embeddings equal pass 1's bit for bit "
                     f"over {k} chunks; loss {float(metrics['loss']):.4f}")

    fp32 = apply_overrides(cfg, ["video_tower.dtype=float32",
                                 "text_tower.dtype=float32",
                                 "train.loss_precision=highest"])
    for b in GRAD_CACHE_COMPARE:
        batch = first_batch(b)
        pair = loss_route(fp32.train, b, fp32.video_tower.embed_dim)
        before = dict(fc.launch_counts)
        grads = []
        for chunk in (None, fp32.train.embedding_chunk):
            tr = Trainer(fp32.video_tower, fp32.text_tower,
                         dataclasses.replace(fp32.train, embedding_chunk=chunk), "cuda")
            st = tr.init_state()
            grads.append(tr.value_and_grad(st, tr.step_inputs(batch))[2])
            del tr, st
        worst = 0.0
        for name, g in grads[0].items():
            err = (grads[1][name] - g).abs().max().item()
            ratio = err / max(g.abs().max().item(), 1e-30)
            worst = max(worst, ratio)
            check(ratio <= GRAD_CACHE_BOUND,
                  f"B={b}: two-pass gradient of {name}: {ratio:.3e} of its "
                  f"largest entry (limit {GRAD_CACHE_BOUND})")
        launched = {k: x - before[k] for k, x in fc.launch_counts.items()}
        per_step = 2 if pair == "per_direction" else 0
        check(launched == dict.fromkeys(fc.KERNELS, 2 * per_step),
              f"B={b} ({pair} route): per-direction launches {launched}")
        log("gradcache", f"B={b} ({pair} route), fp32 towers and loss operands: "
                         f"the two-pass gradients vs the one-pass step's, worst "
                         f"max|Δ| {worst:.3e} of a parameter's largest entry "
                         f"(limit {GRAD_CACHE_BOUND}; {smi})")
        del batch, grads
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the host data path
# ---------------------------------------------------------------------------


def host_bits(x) -> "np.ndarray":
    """A device batch field as host numpy bits: bf16 as its uint16 payload."""
    import numpy as np

    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).cpu().numpy().view(np.uint16)
    return x.cpu().numpy()


def write_stores(data, tmp: Path) -> dict:
    """bf16 and int8 file stores of ``data`` (with its masks) in ``tmp``:
    {dtype: data.* overrides naming them}."""
    import numpy as np

    from crossclr_tpu_torch.data import f32_to_bf16, quantize_features

    stores = {}
    for dtype in ("bfloat16", "int8"):
        paths = {}
        for name in ("video", "text"):
            path = tmp / f"{name}_{dtype}.npy"
            x = getattr(data, name)
            if dtype == "int8":
                q, scale = quantize_features(x)
                np.save(path, q)
                np.save(path.with_name(path.stem + "_scale.npy"), scale)
            else:
                np.save(path, f32_to_bf16(x))
            paths[name] = path
            mask = getattr(data, f"{name}_mask")
            if mask is not None:
                np.save(tmp / f"{name}_mask.npy", mask)
                paths[f"{name}_mask"] = tmp / f"{name}_mask.npy"
        stores[dtype] = ["data.source=files", f"data.features_dtype={dtype}",
                         *(f"data.{k}_path={v}" for k, v in paths.items())]
    return stores


def store_dataset(store: list[str], dtype: str):
    """The FeaturePairDataset that ``write_stores``' overrides name."""
    from crossclr_tpu_torch.data import FeaturePairDataset

    overrides = dict(o.split("=", 1) for o in store)
    return FeaturePairDataset(
        overrides["data.video_path"], overrides["data.text_path"],
        video_mask_path=overrides.get("data.video_mask_path"),
        text_mask_path=overrides.get("data.text_mask_path"), dtype=dtype)


def check_stream(data, n: int, slow: bool, tag: str) -> dict:
    """DATA_DRAWS prefetched chunks, all held until the end (so three ring
    wraps pass under them), each equal bit for bit to the host stream
    once copied back; an int8 chunk's device dequantization equal bit for
    bit to the host's.  The slow consumer queues ~10 ms of device work on
    its stream and sleeps DATA_SLOW_S before each draw.  Returns the
    prefetcher's stats."""
    import numpy as np

    from crossclr_tpu_torch.data import infinite_batches, stack_batches, train_stream
    from crossclr_tpu_torch.data.quantize import dequantize_batch

    host = infinite_batches(data, DATA_BATCH, seed=3)
    if n > 1:
        host = stack_batches(host, n)
    it = train_stream(data, DATA_BATCH, n, device="cuda", seed=3)
    held = []
    try:
        for _ in range(DATA_DRAWS):
            if slow:
                torch.cuda._sleep(20_000_000)
                time.sleep(DATA_SLOW_S)
            held.append(next(it))
    finally:
        it.close()
    check(not it._thread.is_alive(), f"{tag}: prefetch worker still alive")
    for i, got in enumerate(held):
        want = next(host)
        check(got.keys() == want.keys(), f"{tag}: fields {sorted(got)}")
        for k, v in want.items():
            check(got[k].device.type == "cuda" and np.array_equal(host_bits(got[k]), v),
                  f"{tag}: chunk {i} field {k} differs from the host stream")
        if "video_scale" in want:
            deq = dequantize_batch(got)
            for k in ("video", "text"):
                scale = want[f"{k}_scale"]
                ref = want[k].astype(np.float32) * scale.reshape(
                    scale.shape + (1,) * (want[k].ndim - scale.ndim))
                check(np.array_equal(deq[k].cpu().numpy(), ref),
                      f"{tag}: chunk {i} {k} dequantized on the device differs")
    return it.stats


def data_phase(smi: str) -> dict:
    """The host data path on the card: prefetched chunks against the host
    stream, then the gather and copy rates at the transformer leg's batch.
    Returns the rates."""
    import numpy as np

    from crossclr_tpu_torch.data import SyntheticPairs, gather_rows, train_stream
    from crossclr_tpu_torch.data.datasets import TRAIN_RING
    from crossclr_tpu_torch.data.native_io import gather_rows_plain

    data = SyntheticPairs(num_pairs=DATA_PAIRS, video_dim=512, text_dim=768,
                          video_seq_len=64, text_seq_len=96,
                          variable_lengths=True, seed=5)
    with tempfile.TemporaryDirectory(prefix="crossclr_smoke_") as tmp:
        stores = {"float32": data, **{d: store_dataset(o, d) for d, o in
                                      write_stores(data, Path(tmp)).items()}}
        for dtype, store in stores.items():
            for n in (1, 4):
                for slow in (False, True):
                    tag = (f"{dtype} store, {'stacked 4' if n > 1 else 'steps_per_call 1'}, "
                           f"{'slow' if slow else 'fast'} consumer")
                    stats = check_stream(store, n, slow, tag)
                    check(len(stats["h2d_ms"]) >= DATA_DRAWS,
                          f"{tag}: {len(stats['h2d_ms'])} copies timed")
                    log("data", f"{tag}: {DATA_DRAWS} chunks of {n} x {DATA_BATCH} "
                                "equal to the host stream bit for bit"
                                + (", dequantized on the device equal to the host's"
                                   if dtype == "int8" else "")
                                + f"; worker gather median "
                                f"{statistics.median(stats['gather_ms']):.3f} ms, "
                                f"H2D {statistics.median(stats['h2d_ms']):.3f} ms")

    # rates at the leg's batch (1024 rows of 64 x 512 and 96 x 768 fp32)
    big = SyntheticPairs(num_pairs=DATA_TIMING_PAIRS, video_dim=512, text_dim=768,
                         video_seq_len=64, text_seq_len=96,
                         variable_lengths=True, seed=6)
    idx = np.sort(np.random.default_rng(0).choice(DATA_TIMING_PAIRS, LEG_BATCH,
                                                  replace=False))
    fields = {"video": big.video, "text": big.text, "video_mask": big.video_mask,
              "text_mask": big.text_mask}
    nbytes = sum(src[idx].nbytes for src in fields.values())

    def host_ms(fn, n=5):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    from crossclr_tpu_torch.data.datasets import _pinned_empty

    t0 = time.perf_counter()
    pinned = {k: _pinned_empty((LEG_BATCH, *src.shape[1:]), src.dtype)
              for k, src in fields.items()}
    pin_s = time.perf_counter() - t0
    # torch's pinned allocator for the same batch, for comparison: it rounds
    # each block up to a power of two and keeps it cached
    t0 = time.perf_counter()
    torch_pinned = [torch.empty(src[:LEG_BATCH].shape, pin_memory=True,
                                dtype=torch.from_numpy(src[:1]).dtype)
                    for src in fields.values()]
    torch_pin_s = time.perf_counter() - t0
    del torch_pinned
    rates = {
        "plain gather (numpy, fresh pages)": host_ms(
            lambda: [gather_rows_plain(src, idx) for src in fields.values()]),
        "native gather (fresh pages)": host_ms(
            lambda: [gather_rows(src, idx) for src in fields.values()]),
        "native gather (into the pinned ring)": host_ms(
            lambda: [gather_rows(src, idx, out=pinned[k]) for k, src in fields.items()]),
    }
    dev = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, device="cuda")
           for k, v in pinned.items()}

    def copy_ms(host, non_blocking):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(5):
            src = host()  # assembled before the clock starts
            start.record()
            for k, h in src.items():
                dev[k].copy_(h, non_blocking=non_blocking)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    pinned_t = {k: torch.from_numpy(v) for k, v in pinned.items()}
    check(all(t.is_pinned() for t in pinned_t.values()), "ring buffers not pinned")
    rates["H2D pinned (non_blocking)"] = copy_ms(lambda: pinned_t, True)
    rates["H2D pageable (fresh arrays)"] = copy_ms(
        lambda: {k: torch.from_numpy(gather_rows(src, idx)) for k, src in fields.items()},
        False)
    it = train_stream(big, LEG_BATCH, 1, device="cuda", seed=3)
    try:
        for _ in range(8):
            next(it)
    finally:
        it.close()
    stats = it.stats
    rates["prefetch worker gather"] = statistics.median(stats["gather_ms"][1:])
    rates["prefetch worker H2D"] = statistics.median(stats["h2d_ms"][1:])
    ring_bytes = TRAIN_RING * nbytes
    for what, ms in rates.items():
        log("data", f"{what}: {ms:.3f} ms for {nbytes / 1e6:.1f} MB = "
                    f"{nbytes / ms / 1e6:.2f} GB/s (batch {LEG_BATCH}, leg widths; {smi})")
    log("data", f"page-locked: one batch {nbytes / 1e6:.1f} MB registered in "
                f"{pin_s:.3f} s (torch's pinned allocator: {torch_pin_s:.3f} s); "
                f"the train CLI's ring of {TRAIN_RING} at steps_per_call 1 locks "
                f"{ring_bytes / 1e9:.3f} GB, at the leg's 20 "
                f"{20 * ring_bytes / 1e9:.3f} GB")
    del dev, pinned, pinned_t
    return {"batch_bytes": nbytes, "ms": rates}


def leg_trainer(config: str, overrides: list[str]):
    """The CLI's trainer and train rows for a config and overrides."""
    from crossclr_tpu_torch.data import dataset_from_config, train_eval_split
    from crossclr_tpu_torch.training import Trainer
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(ROOT / config), overrides)
    dataset, _ = dataset_from_config(cfg.data)
    train_data, _ = train_eval_split(dataset, max(int(len(dataset) * 0.1), 1))
    return cfg, Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cuda"), train_data


def paths_phase(smi: str) -> dict:
    """Each training leg's steady pairs/s through Trainer.fit twice in one
    call: the serial pageable iterator (infinite_batches, copied on the
    step's thread, steps_per_call steps a dispatch) and the train CLI's
    prefetched stacked chunks.  The first dispatch of each fit is outside
    the rate; the large-batch leg's rate is its one 8-step dispatch after
    a first one.  Returns {leg: (serial, prefetched)}."""
    from crossclr_tpu_torch.data import infinite_batches, train_stream
    from crossclr_tpu_torch.train import chunk_steps

    legs = {  # (config, overrides, steps): two dispatches or more each
        "mlp": (TRAIN_CONFIG, TRAIN_OVERRIDES, 40),
        "transformer": (TRANSFORMER_CONFIG, TRANSFORMER_OVERRIDES, 40),
        "full_crossclr": (FULL_CONFIG, FULL_OVERRIDES, 15),
        "large_batch": (PODSLICE_CONFIG, PODSLICE_OVERRIDES, 2 * PODSLICE_STEPS),
    }
    out = {}
    for leg, (config, overrides, steps) in legs.items():
        cfg, trainer, data = leg_trainer(config, overrides)
        b, spc, n = cfg.data.batch_size, cfg.train.steps_per_call, chunk_steps(cfg)
        rates = []
        for prefetched in (False, True):
            state = trainer.init_state()
            if prefetched:
                it = train_stream(data, b, n, device="cuda", seed=3,
                                  max_chunk_bytes=trainer.stacked_budget())
            else:
                it = infinite_batches(data, b, seed=3)
            try:
                state, history = trainer.fit(state, it, steps=steps, log_every=steps,
                                             prestacked=prefetched and n > 1)
            finally:
                if prefetched:
                    it.close()
            torch.cuda.synchronize()
            rates.append(history[-1]["pairs_per_sec"])
            del state
            torch.cuda.empty_cache()
        out[leg] = tuple(rates)
        log("paths", f"{leg} leg ({config}, batch {b}, {spc} steps a dispatch, "
                     f"{steps} steps): steady {rates[0]:.1f} pairs/s serial "
                     f"pageable, {rates[1]:.1f} pairs/s prefetched "
                     f"({rates[1] / rates[0]:.2f}x; {smi})")
    return out


def store_legs_phase(fa, smi: str) -> dict:
    """The transformer leg through train.main from bf16 and int8 file stores
    written from its synthetic pairs: flash_dq and flash_dkv launched
    8 x STORE_STEPS times each, the loss falling.  Returns {dtype: steady
    pairs/s}."""
    from crossclr_tpu_torch import data as data_pkg
    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    data, _ = data_pkg.dataset_from_config(apply_overrides(
        load_config(ROOT / TRANSFORMER_CONFIG), TRANSFORMER_OVERRIDES).data)
    base = [o for o in TRANSFORMER_OVERRIDES if not o.startswith("data.")]
    out = {}
    with tempfile.TemporaryDirectory(prefix="crossclr_smoke_") as tmp:
        tmp = Path(tmp)
        for dtype, store in write_stores(data, tmp).items():
            metrics = tmp / f"metrics_{dtype}.csv"
            reset_counts(fa)
            rc = train.main(["--config", str(ROOT / TRANSFORMER_CONFIG), "--steps",
                             str(STORE_STEPS), "--metrics-csv", str(metrics), *base,
                             *store, f"data.batch_size={LEG_BATCH}",
                             "train.warmup_steps=10",
                             f"checkpoint_dir={tmp / ('ckpt_' + dtype)}"])
            check(rc == 0, f"train.main exited {rc}")
            torch.cuda.synchronize()
            flash = dict(fa.launch_counts)
            rows, evals = train_rows(metrics)
            losses = check_train_rows(rows, evals, int(4096 * 0.1),
                                      f"{dtype} store transformer leg")
            want = 8 * STORE_STEPS
            check(flash["flash_dq"] == want and flash["flash_dkv"] == want,
                  f"{dtype} store leg: flash launches {flash}, want {want}")
            out[dtype] = float(rows[-1]["pairs_per_sec"])
            log("train", f"transformer leg from a {dtype} file store: "
                         f"{STORE_STEPS} steps, loss {losses[0]:.4f} -> "
                         f"{losses[-1]:.4f}; launches {flash}; steady "
                         f"{out[dtype]:.1f} pairs/s ({smi})")
    return out


# ---------------------------------------------------------------------------
# data parallelism: one process per rank
# ---------------------------------------------------------------------------


def dp_worker(spec_path: Path) -> int:
    """A child of the data-parallel phase: each run of ``spec["runs"]``
    through ``train.main``, every kernel count set to 0 just before and
    read just after, each step's loss and grad_norm recorded (as exact
    hex).  A run that names an ``env`` runs with exactly those launcher
    variables (none: no group).  With ``spec["join"]`` the child first
    joins a gloo group itself, from the launcher's environment, on
    ``spec["device"]``, and every run shares it (the emulation of two cards
    on one: NCCL refuses two ranks on one device); ``spec["fault"]``
    replaces the gradient reduction by a known-wrong one (``dp_fault``).
    Writes the results to ``spec["out"]``."""
    import torch.distributed as dist

    spec = json.loads(spec_path.read_text())
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent
    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.training import Trainer

    kernels = [importlib.import_module(f"crossclr_tpu_torch.ops.{m}") for m in
               ("flash_attention", "fused_dual", "fused_global", "fused_crossclr")]
    steps, backends = [], []
    train_step = Trainer.train_step

    def recording_step(self, state, batch):
        state, metrics = train_step(self, state, batch)
        steps.append((metrics["loss"], metrics["grad_norm"]))
        backends.append(None if self.group is None else dist.get_backend(self.group))
        return state, metrics

    Trainer.train_step = recording_step
    if spec.get("fault"):
        Trainer.sum_grads = dp_fault(Trainer.sum_grads, spec["fault"])
    grouped = spec.get("join") is not None
    if grouped:
        torch.cuda.set_device(torch.device(spec["device"]))
        dist.init_process_group(spec["join"], init_method="env://")
    results = []
    try:
        for run in spec["runs"]:
            if "env" in run:
                for k in LAUNCHER_VARS:
                    os.environ.pop(k, None)
                os.environ.update(run["env"])
            steps.clear()
            backends.clear()
            for module in kernels:
                reset_counts(module)
            t0 = time.perf_counter()
            rc = train.main(run["argv"])
            torch.cuda.synchronize()
            results.append({
                "rc": rc, "seconds": time.perf_counter() - t0,
                "loss": [float(x).hex() for x, _ in steps],
                "grad_norm": [float(g).hex() for _, g in steps],
                "backends": sorted(set(map(str, backends))),
                "counts": {k: n for module in kernels
                           for k, n in module.launch_counts.items()},
            })
    finally:
        if grouped:
            dist.destroy_process_group()
    Path(spec["out"]).write_text(json.dumps(results))
    return 0


def dp_fault(sum_grads, fault: str):
    """``Trainer.sum_grads`` with a known-wrong reduction, to read what the
    dp checks read under it (``--dp-fault``): ``averaged`` divides the
    summed gradients by the world size (DistributedDataParallel's mean
    where the JAX step psums); ``unsummed`` leaves each rank its own
    gradient (no collective: under ZeRO-1 its own rows of it)."""
    import torch.distributed as dist

    def averaged(self, grads, norms):
        grads, norms = sum_grads(self, grads, norms)
        return {k: g / self.world for k, g in grads.items()}, norms

    def unsummed(self, grads, norms):
        collectives = dist.reduce_scatter_tensor, dist.all_reduce
        dist.reduce_scatter_tensor = (
            lambda out, inp, **kw: out.copy_(inp.view(self.world, -1)[self.rank]))
        dist.all_reduce = lambda tensor, **kw: None
        try:
            return sum_grads(self, grads, norms)
        finally:
            dist.reduce_scatter_tensor, dist.all_reduce = collectives

    return {"averaged": averaged, "unsummed": unsummed}[fault]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_spawn(tmp: Path, tag: str, children: list[tuple[dict, dict]]) -> list:
    """Start one ``--dp-worker`` child per ``(spec, launcher env)``, all
    together, join them within DP_JOIN_S and return their results; a child
    that fails, or any still running at the limit, fails the phase."""
    base = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    procs = []
    try:
        for i, (spec, env) in enumerate(children):
            path = tmp / f"{tag}_{i}.json"
            path.write_text(json.dumps({**spec, "out": str(tmp / f"{tag}_{i}_out.json")}))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker", str(path)],
                cwd=ROOT, env={**base, **env}, stdout=sys.stderr))
        deadline = time.monotonic() + DP_JOIN_S
        for i, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{tag}: child {i} still running after "
                                     f"{DP_JOIN_S} s") from None
            check(rc == 0, f"{tag}: child {i} exited {rc}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    return [json.loads((tmp / f"{tag}_{i}_out.json").read_text())
            for i in range(len(children))]


def dp_argv(leg: str, tmp: Path, run: str, device: str = "cuda") -> list[str]:
    # argparse takes the positional overrides after every option
    options = ["--config", str(ROOT / DP_LEGS[leg]), "--steps", str(DP_STEPS[leg]),
               "--device", device, "--metrics-csv", str(tmp / f"{run}.csv")]
    return [*options, *DP_OVERRIDES[leg], f"checkpoint_dir={tmp / run}"]


def dp_rate(tmp: Path, run: str) -> tuple[float, float]:
    """The steady pairs/s of the global batch (the last logged step, the
    clock restarted after the first dispatch) and ms a step."""
    last = [r for r in csv_rows(tmp / f"{run}.csv") if r.get("loss")][-1]
    return float(last["pairs_per_sec"]), 1000.0 / float(last["steps_per_sec"])


def dp_reference(leg: str):
    """One process, no group, on the DP_RANKS ranks' HostShard batches
    joined, for the leg's steps: ``(each step's loss, grad_norm, the
    final parameters on the host, the config)``."""
    import numpy as np

    from crossclr_tpu_torch.data import (HostShard, dataset_from_config,
                                         infinite_batches, train_eval_split)
    from crossclr_tpu_torch.training import Trainer
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(ROOT / DP_LEGS[leg]), DP_OVERRIDES[leg])
    dataset, _ = dataset_from_config(cfg.data)
    train_data, _ = train_eval_split(
        dataset, max(int(len(dataset) * cfg.data.eval_fraction), 1))
    b_loc = cfg.data.batch_size // DP_RANKS
    streams = [infinite_batches(HostShard(train_data, r, DP_RANKS), b_loc,
                                seed=cfg.data.seed) for r in range(DP_RANKS)]
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cuda")
    check(trainer.group is None, "the reference runs without a group")
    state = trainer.init_state()
    losses, norms = [], []
    for _ in range(DP_STEPS[leg]):
        parts = [next(s) for s in streams]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    params = {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}
    return losses, norms, params, cfg


def dp_one_rank(tmp: Path, smi: str) -> dict:
    """(a) The podslice config at B = 32,768 in one child: with no group,
    then on a one-rank NCCL group from a launcher's environment (RANK=0
    WORLD_SIZE=1, a free MASTER_PORT): the per-step losses and grad_norms
    bit for bit, the same launches.  Returns them."""
    steps = DP_STEPS["podslice"]
    launcher = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    t0 = time.perf_counter()
    (alone, grouped), = dp_spawn(tmp, "a", [(
        {"runs": [{"argv": dp_argv("podslice", tmp, "a_alone"), "env": {}},
                  {"argv": dp_argv("podslice", tmp, "a_group"), "env": launcher}]},
        {})])
    seconds = time.perf_counter() - t0
    for run in (grouped, alone):
        check(run["rc"] == 0 and len(run["loss"]) == steps,
              f"(a): {run['rc']=}, {len(run['loss'])} steps")
    check(grouped["loss"] == alone["loss"],
          f"(a) losses: one NCCL rank {grouped['loss']} vs no group "
          f"{alone['loss']}")
    check(grouped["grad_norm"] == alone["grad_norm"],
          f"(a) grad_norm: {grouped['grad_norm']} vs {alone['grad_norm']}")
    check(grouped["backends"] == ["nccl"] and alone["backends"] == ["None"],
          f"(a) groups: {grouped['backends']} and {alone['backends']}")
    check(grouped["counts"] == alone["counts"],
          f"(a) launches {grouped['counts']} vs {alone['counts']}")
    check_only(grouped["counts"], sym_launches(steps), "(a) one NCCL rank")
    counts = {k: x for k, x in grouped["counts"].items() if x}
    rate, ms = dp_rate(tmp, "a_group")
    rate0, ms0 = dp_rate(tmp, "a_alone")
    log("dp", f"(a) {PODSLICE_CONFIG} at B=32768, {steps} steps, no group then one "
              f"NCCL rank in one child: losses bit for bit "
              f"({', '.join(str(float.fromhex(x)) for x in grouped['loss'])}), "
              f"grad_norm bit for bit, launches {counts} in both; the child "
              f"{seconds:.1f} s, its runs {alone['seconds']:.1f} s and "
              f"{grouped['seconds']:.1f} s")
    log("dp", f"(a) steady train rate: one NCCL rank {rate:.1f} pairs/s "
              f"({ms:.2f} ms a step), no group {rate0:.1f} pairs/s ({ms0:.2f} ms "
              f"a step) ({smi})")
    return counts


def dp_two_ranks(tmp: Path, smi: str, fault: str | None = None,
                 legs=DP_PHASE_LEGS) -> dict:
    """(b) DP_RANKS ranks sharing cuda:0, each child joined by gloo before
    it calls the CLI with --device cuda:0, running the podslice leg (global
    negatives through the rows kernels at 16,384 anchor rows of 32,768 x
    256, ZeRO-1, GradCache at chunk 1024) and then the full-CrossCLR leg
    (crossclr_fused, learnable τ, 512 rows a rank), against one process on
    the joined batches: the loss and grad_norm per step and the mean |Δ| of
    the parameters after the last step (rank 0's checkpoint), each within
    its limit; the rows kernels launched exactly 2 times a step on each
    rank and no other kernel.  ``legs`` names the legs to run (the tp
    phase runs ``podslice_lamb``: the podslice leg under LAMB).  Returns
    the launches by leg.  With a
    ``fault`` (``dp_fault``'s, or ``none`` for the port's own reduction)
    in the children, each reading is logged beside its limit, as caught or
    missed, and fails nothing."""
    import numpy as np

    from crossclr_tpu_torch.training.trainer import AdamW

    def hold(ok: bool, what: str) -> None:
        if fault is None:
            check(ok, what)
        else:
            log("dp", f"fault {fault}: {'missed' if ok else 'CAUGHT'}: {what}")

    port = str(free_port())
    ranks = [({"join": "gloo", "device": "cuda:0",
               "fault": None if fault == "none" else fault,
               "runs": [{"argv": dp_argv(leg, tmp, f"b_{leg}_{r}", "cuda:0")}
                        for leg in legs]},
              {"RANK": str(r), "WORLD_SIZE": str(DP_RANKS), "LOCAL_RANK": str(r),
               "LOCAL_WORLD_SIZE": str(DP_RANKS), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port})
             for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    results = dp_spawn(tmp, "b", ranks)
    seconds_children = time.perf_counter() - t0
    out = {}
    t0 = time.perf_counter()
    for i, leg in enumerate(legs):
        runs = [res[i] for res in results]
        n = DP_STEPS[leg]
        losses, norms, params, cfg = dp_reference(leg)
        adam = AdamW(cfg.train)
        counts = {}
        for r, run in enumerate(runs):
            check(run["rc"] == 0 and len(run["loss"]) == n,
                  f"(b) {leg} rank {r}: {run['rc']=}, {len(run['loss'])} steps")
            check(run["backends"] == ["gloo"],
                  f"(b) {leg} rank {r}: groups {run['backends']}, want gloo")
            check_only(run["counts"], {k: 2 * n for k in
                                       ("rows_lse", "rows_bwd_rows", "rows_bwd_cols")},
                       f"(b) {leg} rank {r}")
            for k, x in run["counts"].items():
                counts[k] = counts.get(k, 0) + x
            got = [float.fromhex(x) for x in run["loss"]]
            loss_err = max(abs(g - w) / abs(w) for g, w in zip(got, losses))
            hold(loss_err <= DP_LOSS_RTOL[leg],
                 f"(b) {leg} rank {r}: losses {got} vs one process {losses}: "
                 f"max relative error {loss_err:.3e} (limit {DP_LOSS_RTOL[leg]})")
            got_norms = [float.fromhex(x) for x in run["grad_norm"]]
            norm_err = max(abs(g - w) / abs(w) for g, w in zip(got_norms, norms))
            hold(norm_err <= DP_NORM_RTOL,
                 f"(b) {leg} rank {r}: grad_norm {got_norms} vs {norms}: "
                 f"max relative error {norm_err:.3e} (limit {DP_NORM_RTOL})")
            log("dp", f"(b) {leg} rank {r}: loss per step "
                      + ", ".join(f"{x:.6f}" for x in got)
                      + " vs one process " + ", ".join(f"{x:.6f}" for x in losses)
                      + f": max relative error {loss_err:.3e} (limit "
                      f"{DP_LOSS_RTOL[leg]}); grad_norm max relative error "
                      f"{norm_err:.3e} (limit {DP_NORM_RTOL})")
        saved = torch.load(tmp / f"b_{leg}_0" / f"step_{n}.pt", map_location="cpu",
                           weights_only=True)
        check(saved["model"].keys() == params.keys(), f"(b) {leg}: parameter names")
        diffs = {k: (saved["model"][k].float() - v).abs() for k, v in params.items()}
        worst = max(diffs, key=lambda k: diffs[k].max().item())
        worst_err = diffs[worst].max().item()
        # over every parameter element: each step's update moves every one
        mean = (sum(d.double().sum().item() for d in diffs.values())
                / sum(d.numel() for d in diffs.values()))
        hold(mean <= DP_PARAM_MEAN[leg],
             f"(b) {leg}: parameters after {n} steps vs one process: mean |Δ| "
             f"{mean:.3e} (limit {DP_PARAM_MEAN[leg]:.3g})")
        # printed, not held: AdamW's update is about lr a step whatever its
        # gradient, so any two finite runs stay inside this
        adam_gap = DP_ADAM_U * sum(adam.learning_rate(c) for c in range(n))
        gap = (f"AdamW's widest gap {adam_gap:.3e} = {DP_ADAM_U} x Σ lr"
               if cfg.train.optimizer == "adamw" else cfg.train.optimizer)
        out[f"b_{leg}"] = counts
        rate, ms = dp_rate(tmp, f"b_{leg}_0")
        log("dp", f"(b) {leg} ({DP_LEGS[leg]}, B={cfg.data.batch_size}, "
                  f"{cfg.data.batch_size // DP_RANKS} a rank, {DP_RANKS} gloo ranks "
                  f"on cuda:0, {n} steps): parameters after the last step vs one "
                  f"process: mean |Δ| {mean:.3e} (limit {DP_PARAM_MEAN[leg]:.3g}); "
                  f"max |Δ| {worst_err:.3e} ({worst}; {gap}); launches "
                  f"{({k: x for k, x in counts.items() if x})}")
        log("dp", f"(b) {leg} steady train rate: {rate:.1f} pairs/s of the "
                  f"global batch ({ms:.2f} ms a step; both ranks on one card, "
                  f"gloo) ({smi})")
    seconds_references = time.perf_counter() - t0
    log("dp", f"(b) {seconds_children:.1f} s for the {DP_RANKS} ranks' children "
              f"(their runs: " + "; ".join(
                  f"rank {r} " + ", ".join(f"{run['seconds']:.1f}" for run in res)
                  for r, res in enumerate(results))
              + f" s), {seconds_references:.1f} s for the one-process references")
    return out


def dp_phase(smi: str) -> dict:
    """The data-parallel step through the train CLI, one process per rank:
    (a) ``dp_one_rank``, (b) ``dp_two_ranks``.  Returns the launches by
    leg."""
    torch.cuda.empty_cache()  # the children share the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="crossclr_dp_") as tmp:
        tmp = Path(tmp)
        out = {"a": dp_one_rank(tmp, smi)}
        seconds_a = time.perf_counter() - t0
        out.update(dp_two_ranks(tmp, smi))
    log("dp", f"the phase took {time.perf_counter() - t0:.1f} s: (a) "
              f"{seconds_a:.1f} s, (b) {time.perf_counter() - t0 - seconds_a:.1f} s")
    return out


# ---------------------------------------------------------------------------
# sequence parallelism: ring attention over a model group
# ---------------------------------------------------------------------------


def ring_shapes_check(fa, rank: int, group) -> list[dict]:
    """(a) in one rank of a ring of RING_RANKS: at the transformer leg's
    shapes, both builds, dropout 0 and LEG_DROPOUT, the ring-of-flash over
    the group (this rank's sequence shard, every rank the same global
    inputs) against the flash kernels on the whole sequence and against the
    plain ring on the card, output and dq/dk/dv; the unchecked gap of both
    bf16 backwards to autograd through the fp32 plain attention.  Then at
    RING_LONG (bf16, dropout LEG_DROPOUT) against the flash kernels only,
    and both timed.  Returns the readings; a reading outside its limit
    raises."""
    import torch.distributed as dist

    from crossclr_tpu_torch.parallel.ring_attention import ring_attention

    n = RING_RANKS
    records = []

    def ring(q, k, v, mask, g, lo, hi, impl, drop):
        ql, kl, vl = (x[:, :, lo:hi].detach().clone().requires_grad_()
                      for x in (q, k, v))
        out = ring_attention(ql, kl, vl, None if mask is None else mask[:, lo:hi],
                             group=group, block_impl=impl, **drop)
        out.backward(g[:, :, lo:hi])
        return out.detach(), ql.grad, kl.grad, vl.grad

    def errs(got, want, lo, hi, sliced=True):
        return [((a.float() - (w[:, :, lo:hi] if sliced else w).float()).abs().max().item(),
                 (w[:, :, lo:hi] if sliced else w).float().abs().max().item())
                for a, w in zip(got, want)]

    def hold_out(got, want, dtype, tag):
        atol, rtol, _ = LIMITS[dtype]
        ok = bool(((got.float() - want.float()).abs()
                   <= atol + rtol * want.float().abs()).all())
        check(ok and bool(torch.isfinite(got.float()).all()),
              f"{tag}: output outside atol {atol}, rtol {rtol}")

    def hold_grads(pairs, dtype, tag):
        for name, (err, top) in zip(("dq", "dk", "dv"), pairs):
            limit = (FLASH_GRAD_BOUND if dtype == torch.float32 else RING_BF16_REL) * top
            check(math.isfinite(err) and err <= limit,
                  f"{tag}: {name} max|err| {err:.3e} over {limit:.3e}")

    for b, s in RING_LEG_SHAPES:
        lo, hi = rank * s // n, (rank + 1) * s // n
        for dtype in (torch.float32, torch.bfloat16):
            for rate in RING_RATES:
                tag = f"B={b} S={s} {str(dtype)[6:]} dropout {rate}"
                q, k, v, mask = qkv((b, 8, s, 48), dtype, 31 + s)
                g = torch.randn(q.shape, generator=torch.Generator(device="cuda")
                                .manual_seed(37 + s), device="cuda").to(dtype)
                drop = dict(dropout_rate=rate, dropout_seed=41) if rate else {}
                with torch.inference_mode():
                    out_f, lse_f = fa.flash_attention_fwd(q, k, v, mask, **drop)
                    whole = (out_f, *fa.flash_attention_bwd(q, k, v, mask, out_f,
                                                            lse_f, g, **drop))
                got = ring(q, k, v, mask, g, lo, hi, "flash", drop)
                plain = ring(q, k, v, mask, g, lo, hi, "jnp", drop)
                vs_whole = errs(got, whole, lo, hi)
                vs_plain = errs(got, plain, lo, hi, sliced=False)
                hold_out(got[0], whole[0][:, :, lo:hi], dtype, tag + " vs whole flash")
                hold_out(got[0], plain[0], dtype, tag + " vs plain ring")
                hold_grads(vs_whole[1:], dtype, tag + " vs whole flash")
                hold_grads(vs_plain[1:], dtype, tag + " vs plain ring")
                check(all(bool((x[-1] == 0).all()) for x in got),
                      f"{tag}: the fully masked entry not zero")
                record = {"tag": tag, "vs_whole": vs_whole, "vs_plain": vs_plain}
                if dtype == torch.bfloat16:
                    exact = attention_grads(fa.mha_reference, q.float(), k.float(),
                                            v.float(), mask, g, **drop)
                    record["ring_to_fp32"] = [
                        (a.float() - w[:, :, lo:hi]).abs().max().item()
                        for a, w in zip(got[1:], exact)]
                    record["whole_to_fp32"] = [
                        (a.float() - w).abs().max().item()
                        for a, w in zip(whole[1:], exact)]
                    del exact
                records.append(record)
                del q, k, v, g, whole, got, plain
    # one long sequence: the plain scores would take B·H·S² fp32
    b, s = RING_LONG
    lo, hi = rank * s // n, (rank + 1) * s // n
    q, k, v, _ = qkv((b, 8, s, 48), torch.bfloat16, 43)
    mask = torch.ones(b, s, device="cuda")
    mask[1, RING_LONG_VALID:] = 0.0  # the second entry ragged
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(47),
                    device="cuda").to(torch.bfloat16)
    drop = dict(dropout_rate=LEG_DROPOUT, dropout_seed=53)
    tag = f"B={b} S={s} bfloat16 dropout {LEG_DROPOUT}"
    with torch.inference_mode():
        out_f, lse_f = fa.flash_attention_fwd(q, k, v, mask, **drop)
        whole = (out_f, *fa.flash_attention_bwd(q, k, v, mask, out_f, lse_f, g, **drop))
    got = ring(q, k, v, mask, g, lo, hi, "flash", drop)
    vs_whole = errs(got, whole, lo, hi)
    hold_out(got[0], whole[0][:, :, lo:hi], torch.bfloat16, tag + " vs whole flash")
    hold_grads(vs_whole[1:], torch.bfloat16, tag + " vs whole flash")
    del whole, got

    def ring_ms(grad: bool) -> list[float]:
        times = []
        for _ in range(RING_TIMING_RUNS):
            dist.barrier(group=group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if grad:
                ring(q, k, v, mask, g, lo, hi, "flash", drop)
            else:
                with torch.inference_mode():
                    ring_attention(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi],
                                   mask[:, lo:hi], group=group, block_impl="flash",
                                   **drop)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    def whole_ms(grad: bool) -> list[float]:
        # rank 0 alone, the others waiting at the barrier
        times = []
        if rank == 0:
            for _ in range(RING_TIMING_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if grad:
                    attention_grads(fa.flash_attention, q, k, v, mask, g, **drop)
                else:
                    with torch.inference_mode():
                        fa.flash_attention_fwd(q, k, v, mask, **drop)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        dist.barrier(group=group)
        return times

    ring_ms(True)  # warm: the pinned host buffers, the kernels' first calls
    timing = {"ring_fwd": ring_ms(False), "ring_fwd_bwd": ring_ms(True),
              "whole_fwd": whole_ms(False), "whole_fwd_bwd": whole_ms(True)}
    records.append({"tag": tag, "vs_whole": vs_whole, "timing": timing})
    return records


def ring_worker(spec_path: Path) -> int:
    """A rank of the ring or the tp phase: joins a gloo group on cuda:0
    from the launcher's environment (NCCL refuses two ranks on one
    device), runs ``ring_shapes_check`` when ``spec["shapes"]``, then the
    train CLI with ``spec["argv"]`` (``--n-model``: ring towers, or flash
    towers split tensor-parallel), every kernel count set to 0 just before
    and read just after, each step's loss, grad_norm (exact hex) and flash
    launches recorded.  ``spec["fault"]`` breaks the model group's
    reduction (``sp_fault``), ``spec["tp_fault"]`` a conjugate collective
    of the split towers (``tp_fault``).  Writes the results to
    ``spec["out"]``."""
    import torch.distributed as dist

    spec = json.loads(spec_path.read_text())
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent
    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.parallel.ring_attention import transport
    from crossclr_tpu_torch.training import Trainer

    fa = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")
    kernels = [importlib.import_module(f"crossclr_tpu_torch.ops.{m}") for m in
               ("flash_attention", "fused_dual", "fused_global", "fused_crossclr")]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    out = {"transport": transport(dist.group.WORLD, "cuda:0")}
    try:
        if spec.get("shapes"):
            t0 = time.perf_counter()
            out["shapes"] = ring_shapes_check(fa, rank, dist.group.WORLD)
            out["shapes_seconds"] = time.perf_counter() - t0
        if spec.get("fault"):
            sp_fault(Trainer, spec["fault"])
        if spec.get("tp_fault"):
            tp_fault(spec["tp_fault"])
        steps = []
        train_step = Trainer.train_step

        def recording_step(self, state, batch):
            before = dict(fa.launch_counts)
            state, metrics = train_step(self, state, batch)
            steps.append((metrics["loss"], metrics["grad_norm"],
                          {k: fa.launch_counts[k] - before[k] for k in fa.KERNELS}))
            return state, metrics

        Trainer.train_step = recording_step
        for module in kernels:
            reset_counts(module)
        t0 = time.perf_counter()
        rc = train.main(spec["argv"])
        torch.cuda.synchronize()
        out.update({
            "rc": rc, "seconds": time.perf_counter() - t0,
            "loss": [float(x).hex() for x, _, _ in steps],
            "grad_norm": [float(g).hex() for _, g, _ in steps],
            "step_launches": [c for _, _, c in steps],
            "counts": {k: n for module in kernels
                       for k, n in module.launch_counts.items()},
        })
    finally:
        dist.destroy_process_group()
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


def sp_fault(trainer_cls, fault: str) -> None:
    """A known-wrong reduction over the model group, to read what the ring
    phase's checks read under it (``--sp-fault``): ``unsummed`` leaves each
    rank its share of the gradient (no sum over the model group);
    ``doubled`` leaves out the division of the ring towers' summed
    gradients by n_model, so the sum counts every rank's whole gradient
    n_model times."""
    if fault == "unsummed":
        trainer_cls.sum_model_grads = lambda self, grads: grads
    elif fault == "doubled":
        summed = trainer_cls.sum_model_grads

        def doubled(self, grads):
            grads = summed(self, grads)
            for k in self._ring_summed:
                grads[k].mul_(self.n_model)
            return grads

        trainer_cls.sum_model_grads = doubled


def tp_fault(fault: str) -> None:
    """A conjugate collective of the split towers left out, to read what
    the tp phase's checks read under it (``--tp-fault``): ``uncopied``
    leaves the cotangent of a split layer's replicated input unsummed
    over the model group (``copy_to_model``'s backward an identity), so
    every gradient below a split layer holds this rank's heads' and hidden
    units' share only."""
    from crossclr_tpu_torch.parallel import tensor_parallel

    if fault == "uncopied":
        tensor_parallel._CopyToModel.backward = staticmethod(lambda ctx, g: (g, None))


def ring_argv(tmp: Path, run: str, attention: str, n_model: int,
              device: str) -> list[str]:
    options = ["--config", str(ROOT / TRANSFORMER_CONFIG), "--steps", str(RING_STEPS),
               "--device", device, "--metrics-csv", str(tmp / f"{run}.csv")]
    if n_model > 1:
        options += ["--n-model", str(n_model)]
    return [*options, *RING_OVERRIDES, f"video_tower.attention={attention}",
            f"text_tower.attention={attention}", f"checkpoint_dir={tmp / run}"]


def ring_one_rank_check(fa) -> list[str]:
    """(a) a one-rank NCCL group: the ring over it (no rotation) against the
    flash kernels on the same inputs at the leg's text shape, both builds,
    dropout 0 and LEG_DROPOUT: the output bit for bit in both builds, the
    gradients bit for bit in fp32 (the same arithmetic: the merged output is
    the kernel's, Δ from it); the bf16 gradients checked bit for bit too
    and reported.  Returns the log lines."""
    import torch.distributed as dist

    from crossclr_tpu_torch.parallel.ring_attention import ring_attention, transport

    b, s = RING_LEG_SHAPES[0]
    lines = []
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        for dtype in (torch.float32, torch.bfloat16):
            for rate in RING_RATES:
                q, k, v, mask = qkv((b, 8, s, 48), dtype, 59)
                g = torch.randn(q.shape, generator=torch.Generator(device="cuda")
                                .manual_seed(61), device="cuda").to(dtype)
                drop = dict(dropout_rate=rate, dropout_seed=67) if rate else {}
                flash = attention_grads(fa.flash_attention, q, k, v, mask, g, **drop)
                ring = attention_grads(
                    lambda *a, **kw: ring_attention(*a, group=group, block_impl="flash",
                                                    **kw), q, k, v, mask, g, **drop)
                with torch.inference_mode():
                    out_f = fa.flash_attention(q, k, v, mask, **drop)
                    out_r = ring_attention(q, k, v, mask, group=group,
                                           block_impl="flash", **drop)
                same = [torch.equal(a, w) for a, w in zip(ring, flash)]
                check(torch.equal(out_r, out_f), f"one NCCL rank {dtype} dropout "
                                                 f"{rate}: output not bit for bit")
                if dtype == torch.float32:
                    check(all(same), f"one NCCL rank fp32 dropout {rate}: dq, dk, dv "
                                     f"bit for bit {same}")
                lines.append(f"{str(dtype)[6:]} dropout {rate}: output bit for bit, "
                             f"dq/dk/dv bit for bit {same}")
        lines.append(f"transport {transport(group, 'cuda')!r}")
    finally:
        dist.destroy_process_group()
    return lines


def ring_two_ranks(tmp: Path, smi: str, fault: str | None = None,
                   shapes: bool = True) -> dict:
    """(b) the train CLI at --n-model RING_RANKS on the transformer config at
    full width with ring towers, RING_RANKS gloo ranks sharing cuda:0 (and
    (a)'s shapes in the same children first, ``shapes``), against one
    process of flash towers on the same batches: the loss and grad_norm per
    step, the mean |Δ| of the parameters after the last step (rank 0's
    checkpoint against the reference's), equal across the ranks, and the
    flash kernels launched RING_FLASH_LAUNCHES times each a step on each
    rank; the checkpoint restored into flash towers and encoding through
    the flash forward.  With a ``fault`` (``sp_fault``'s, or ``none``) each
    reading is logged beside its limit, as caught or missed, and fails
    nothing.  Returns the flash kernels' launches (both ranks, the whole
    run) and the readings."""
    from crossclr_tpu_torch.training import CheckpointManager, Trainer
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    def hold(ok: bool, what: str) -> None:
        if fault is None:
            check(ok, what)
        else:
            log("ring", f"fault {fault}: {'missed' if ok else 'CAUGHT'}: {what}")

    # every rank the same command line, as a launcher gives it
    specs = [{"shapes": shapes and fault is None,
              "fault": None if fault in (None, "none") else fault,
              "argv": ring_argv(tmp, "ring", "ring", RING_RANKS, "cuda:0")}] * RING_RANKS
    t0 = time.perf_counter()
    ranks = worker_spawn(tmp, "ring", "--ring-worker", specs, RING_JOIN_S)
    seconds_ranks = time.perf_counter() - t0
    t0 = time.perf_counter()
    (ref,), = dp_spawn(tmp, "ring_ref", [(
        {"runs": [{"argv": ring_argv(tmp, "ring_ref", "flash", 1, "cuda"), "env": {}}]},
        {})])
    seconds_ref = time.perf_counter() - t0
    check(ref["rc"] == 0 and len(ref["loss"]) == RING_STEPS,
          f"(b) the flash reference: {ref['rc']=}, {len(ref['loss'])} steps")
    want_loss = [float.fromhex(x) for x in ref["loss"]]
    want_norm = [float.fromhex(x) for x in ref["grad_norm"]]
    per_step = {k: RING_FLASH_LAUNCHES for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    launches = dict.fromkeys(per_step, 0)
    for r, run in enumerate(ranks):
        check(run["rc"] == 0 and len(run["loss"]) == RING_STEPS,
              f"(b) rank {r}: {run['rc']=}, {len(run['loss'])} steps")
        check(all(c == per_step for c in run["step_launches"]),
              f"(b) rank {r}: flash launches per step {run['step_launches']}, "
              f"want {per_step}")
        check(run["counts"]["sym_fwd"] > 0 and run["counts"]["sym_bwd"] > 0,
              f"(b) rank {r} launched no sym kernel: {run['counts']}")
        for k in launches:
            launches[k] += run["counts"][k]
        got = [float.fromhex(x) for x in run["loss"]]
        loss_err = max(abs(a - w) / abs(w) for a, w in zip(got, want_loss))
        norms = [float.fromhex(x) for x in run["grad_norm"]]
        norm_err = max(abs(a - w) / abs(w) for a, w in zip(norms, want_norm))
        hold(loss_err <= RING_LOSS_RTOL,
             f"(b) rank {r}: losses {got} vs one process of flash towers "
             f"{want_loss}: max relative error {loss_err:.3e} (limit {RING_LOSS_RTOL})")
        hold(norm_err <= RING_NORM_RTOL,
             f"(b) rank {r}: grad_norm {norms} vs {want_norm}: max relative error "
             f"{norm_err:.3e} (limit {RING_NORM_RTOL})")
        log("ring", f"(b) rank {r}: loss max relative error {loss_err:.3e} (limit "
                    f"{RING_LOSS_RTOL}), grad_norm {norm_err:.3e} (limit "
                    f"{RING_NORM_RTOL})")
    hold(ranks[0]["loss"] == ranks[1]["loss"]
         and ranks[0]["grad_norm"] == ranks[1]["grad_norm"],
         "(b) both ranks' losses and grad_norms bit for bit equal")
    saved = torch.load(tmp / "ring" / f"step_{RING_STEPS}.pt", map_location="cpu",
                       weights_only=True)
    ref_saved = torch.load(tmp / "ring_ref" / f"step_{RING_STEPS}.pt",
                           map_location="cpu", weights_only=True)
    check(saved["model"].keys() == ref_saved["model"].keys(),
          "(b) ring and flash towers' parameter names")
    diffs = {k: (saved["model"][k].float() - v.float()).abs()
             for k, v in ref_saved["model"].items()}
    mean = (sum(d.double().sum().item() for d in diffs.values())
            / sum(d.numel() for d in diffs.values()))
    worst = max(diffs, key=lambda k: diffs[k].max().item())
    params_line = (f"(b) parameters after {RING_STEPS} steps vs one process of flash "
                   f"towers: mean |Δ| {mean:.3e} (limit {RING_PARAM_MEAN:.3g}); max "
                   f"|Δ| {diffs[worst].max().item():.3e} ({worst})")
    hold(mean <= RING_PARAM_MEAN, params_line)
    log("ring", params_line)
    # the ring run's checkpoint restores into flash towers, which encode
    cfg = apply_overrides(load_config(ROOT / TRANSFORMER_CONFIG), [
        *RING_OVERRIDES, "video_tower.attention=flash", "text_tower.attention=flash"])
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cuda")
    state = CheckpointManager(tmp / "ring").restore(trainer.init_state())
    check(state.step == RING_STEPS and all(
        torch.equal(p.detach().cpu(), saved["model"][k])
        for k, p in state.model.state_dict().items()),
          "(b) the ring checkpoint restored into flash towers")
    gen = torch.Generator().manual_seed(71)
    batch = {"video": torch.randn(4, 64, 512, generator=gen),
             "text": torch.randn(4, 96, 768, generator=gen)}
    v_emb, t_emb = trainer.encode(state, batch)
    check(bool(torch.isfinite(v_emb).all() and torch.isfinite(t_emb).all()),
          "(b) flash towers from the ring checkpoint: non-finite embeddings")
    rate, ms = dp_rate(tmp, "ring")
    rate_ref, ms_ref = dp_rate(tmp, "ring_ref")
    log("ring", f"(b) {TRANSFORMER_CONFIG} at full width, ring towers, --n-model "
                f"{RING_RANKS} on {RING_RANKS} gloo ranks sharing cuda:0 "
                f"(transport {ranks[0]['transport']!r}), batch {LEG_BATCH}, dropout "
                f"{LEG_DROPOUT}, {RING_STEPS} steps: loss per step "
                + ", ".join(f"{float.fromhex(x):.6f}" for x in ranks[0]["loss"])
                + " vs one process of flash towers "
                + ", ".join(f"{x:.6f}" for x in want_loss)
                + f"; flash launches per step and rank {per_step}; the checkpoint "
                  f"restored into flash towers and encoded")
    log("ring", f"(b) steady train rate: ring {rate:.1f} pairs/s ({ms:.2f} ms a "
                f"step; {RING_RANKS} ranks on one card through gloo staged in host "
                f"memory: not scaling), one process of flash towers {rate_ref:.1f} "
                f"pairs/s ({ms_ref:.2f} ms a step) ({smi})")
    log("ring", f"(b) {seconds_ranks:.1f} s for the ranks' children (train.main "
                + ", ".join(f"{run['seconds']:.1f}" for run in ranks)
                + f" s), {seconds_ref:.1f} s for the flash reference")
    return {"launches": launches, "ranks": ranks, "ref": ref}


def ring_phase(fa, smi: str, tmp: Path) -> dict:
    """Ring attention and the sequence-parallel train step: (a) in the
    ranks of (b) and on a one-rank NCCL group, (b) ``ring_two_ranks`` in
    ``tmp`` (where its one process of flash towers stays for the tp
    phase).  Returns ``ring_two_ranks``' result: the flash kernels'
    launches on the ring training path, the ranks' and the reference's
    readings."""
    torch.cuda.empty_cache()  # the children share the card
    t0 = time.perf_counter()
    for line in ring_one_rank_check(fa):
        log("ring", f"(a) one-rank NCCL group, B={RING_LEG_SHAPES[0][0]} "
                    f"S={RING_LEG_SHAPES[0][1]}: {line}")
    out = ring_two_ranks(tmp, smi)
    for r, run in enumerate(out["ranks"]):
        for rec in run["shapes"]:
            whole = ", ".join(f"{n} {e:.3e} of max {m:.3e}" for n, (e, m) in
                              zip(("out", "dq", "dk", "dv"), rec["vs_whole"]))
            line = f"(a) rank {r}, {rec['tag']}: ring-of-flash vs the flash kernels " \
                   f"on the whole sequence: {whole}"
            if "vs_plain" in rec:
                line += "; vs the plain ring: " + ", ".join(
                    f"{n} {e:.3e}" for n, (e, _) in
                    zip(("out", "dq", "dk", "dv"), rec["vs_plain"]))
            if "ring_to_fp32" in rec:
                line += ("; unchecked gap to fp32 autograd dq/dk/dv: ring "
                         + ", ".join(f"{e:.3e}" for e in rec["ring_to_fp32"])
                         + ", whole-sequence flash "
                         + ", ".join(f"{e:.3e}" for e in rec["whole_to_fp32"]))
            log("ring", line)
            if "timing" in rec and r == 0:
                t = {k: statistics.median(v) for k, v in rec["timing"].items() if v}
                log("ring", f"(a) {rec['tag']} timed (median of {RING_TIMING_RUNS}, "
                            f"host clock around a synchronize): ring of {RING_RANKS} "
                            f"gloo ranks on one card fwd {t['ring_fwd']:.2f} ms, "
                            f"fwd+bwd {t['ring_fwd_bwd']:.2f} ms; the flash kernels "
                            f"on the whole sequence fwd {t['whole_fwd']:.2f} ms, "
                            f"fwd+bwd {t['whole_fwd_bwd']:.2f} ms (host-staged ranks "
                            f"sharing one card: not scaling) ({smi})")
        log("ring", f"(a) rank {r}: {run['shapes_seconds']:.1f} s")
    log("ring", f"the phase took {time.perf_counter() - t0:.1f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# tensor parallelism over a model group, and LAMB
# ---------------------------------------------------------------------------


def tp_two_ranks(tmp: Path, smi: str, fault: str | None = None,
                 ref: dict | None = None) -> dict:
    """(a) the train CLI at --n-model TP_RANKS on the transformer config at
    full width with flash towers, which splits both tensor-parallel, over
    TP_RANKS gloo ranks sharing cuda:0, against one process of flash towers
    on the same batches (``ref``: the ring phase's, run here when None):
    the loss and grad_norm per step, the mean |Δ| of the parameters after
    the last step (rank 0's checkpoint, whole tensors) within the TP_*
    limits, both ranks equal, each rank launching flash_fwd, flash_dq and
    flash_dkv exactly TP_FLASH_LAUNCHES times a step on its own heads and
    the sym pair once a step; the checkpoint restored in one process (whole
    towers and moments) and encoding, and the eval CLI on it in one
    process.  With a ``fault`` (``tp_fault``'s, or ``none``) each reading is
    logged beside its limit, as caught or missed, and fails nothing.
    Returns the launches of both ranks' whole runs by kernel."""
    from crossclr_tpu_torch import eval as teval
    from crossclr_tpu_torch.training import CheckpointManager, Trainer
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    def hold(ok: bool, what: str) -> None:
        if fault is None:
            check(ok, what)
        else:
            log("tp", f"fault {fault}: {'missed' if ok else 'CAUGHT'}: {what}")

    flash = ["video_tower.attention=flash", "text_tower.attention=flash"]
    specs = [{"shapes": False, "tp_fault": None if fault in (None, "none") else fault,
              "argv": ring_argv(tmp, "tp", "flash", TP_RANKS, "cuda:0")}] * TP_RANKS
    t0 = time.perf_counter()
    ranks = worker_spawn(tmp, "tp", "--ring-worker", specs, RING_JOIN_S)
    seconds_ranks = time.perf_counter() - t0
    t0 = time.perf_counter()
    if ref is None:
        (ref,), = dp_spawn(tmp, "ring_ref", [(
            {"runs": [{"argv": ring_argv(tmp, "ring_ref", "flash", 1, "cuda"),
                       "env": {}}]}, {})])
    seconds_ref = time.perf_counter() - t0
    check(ref["rc"] == 0 and len(ref["loss"]) == RING_STEPS,
          f"(a) the flash reference: {ref['rc']=}, {len(ref['loss'])} steps")
    want_loss = [float.fromhex(x) for x in ref["loss"]]
    want_norm = [float.fromhex(x) for x in ref["grad_norm"]]
    per_step = {k: TP_FLASH_LAUNCHES for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    launches = {}
    for r, run in enumerate(ranks):
        check(run["rc"] == 0 and len(run["loss"]) == RING_STEPS,
              f"(a) rank {r}: {run['rc']=}, {len(run['loss'])} steps")
        check(all(c == per_step for c in run["step_launches"]),
              f"(a) rank {r}: flash launches per step {run['step_launches']}, "
              f"want {per_step}")
        check_only(run["counts"], {**sym_launches(RING_STEPS),
                                   "flash_fwd": run["counts"]["flash_fwd"],
                                   "flash_dq": RING_STEPS * TP_FLASH_LAUNCHES,
                                   "flash_dkv": RING_STEPS * TP_FLASH_LAUNCHES},
                   f"(a) rank {r}")
        for k, x in run["counts"].items():
            launches[k] = launches.get(k, 0) + x
        got = [float.fromhex(x) for x in run["loss"]]
        loss_err = max(abs(a - w) / abs(w) for a, w in zip(got, want_loss))
        norms = [float.fromhex(x) for x in run["grad_norm"]]
        norm_err = max(abs(a - w) / abs(w) for a, w in zip(norms, want_norm))
        hold(loss_err <= TP_LOSS_RTOL,
             f"(a) rank {r}: losses {got} vs one process of flash towers "
             f"{want_loss}: max relative error {loss_err:.3e} (limit {TP_LOSS_RTOL})")
        hold(norm_err <= TP_NORM_RTOL,
             f"(a) rank {r}: grad_norm {norms} vs {want_norm}: max relative error "
             f"{norm_err:.3e} (limit {TP_NORM_RTOL})")
        log("tp", f"(a) rank {r}: loss max relative error {loss_err:.3e} (limit "
                  f"{TP_LOSS_RTOL}), grad_norm {norm_err:.3e} (limit {TP_NORM_RTOL})")
    hold(ranks[0]["loss"] == ranks[1]["loss"]
         and ranks[0]["grad_norm"] == ranks[1]["grad_norm"],
         "(a) both ranks' losses and grad_norms bit for bit equal")
    saved = torch.load(tmp / "tp" / f"step_{RING_STEPS}.pt", map_location="cpu",
                       weights_only=True)
    ref_saved = torch.load(tmp / "ring_ref" / f"step_{RING_STEPS}.pt",
                           map_location="cpu", weights_only=True)
    check(saved["model"].keys() == ref_saved["model"].keys() and all(
        saved["model"][k].shape == v.shape for k, v in ref_saved["model"].items()),
          "(a) the split run's checkpoint holds the whole towers' tensors")
    diffs = {k: (saved["model"][k].float() - v.float()).abs()
             for k, v in ref_saved["model"].items()}
    mean = (sum(d.double().sum().item() for d in diffs.values())
            / sum(d.numel() for d in diffs.values()))
    worst = max(diffs, key=lambda k: diffs[k].max().item())
    params_line = (f"(a) parameters after {RING_STEPS} steps vs one process of "
                   f"flash towers: mean |Δ| {mean:.3e} (limit {TP_PARAM_MEAN:.3g}); "
                   f"max |Δ| {diffs[worst].max().item():.3e} ({worst})")
    hold(mean <= TP_PARAM_MEAN, params_line)
    log("tp", params_line)
    # the split run's checkpoint in one process: whole towers and moments
    cfg = apply_overrides(load_config(ROOT / TRANSFORMER_CONFIG),
                          [*RING_OVERRIDES, *flash])
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cuda")
    state = trainer.restored_state(
        CheckpointManager(tmp / "tp").restore(trainer.init_state()))
    check(state.step == RING_STEPS and all(
        torch.equal(p.detach().cpu(), saved["model"][k])
        and state.opt_state["mu"][k].shape == p.shape
        for k, p in state.model.state_dict().items()),
          "(a) the split run's checkpoint restored in one process")
    gen = torch.Generator().manual_seed(73)
    batch = {"video": torch.randn(4, 64, 512, generator=gen),
             "text": torch.randn(4, 96, 768, generator=gen)}
    v_emb, t_emb = trainer.encode(state, batch)
    check(bool(torch.isfinite(v_emb).all() and torch.isfinite(t_emb).all()),
          "(a) the restored towers: non-finite embeddings")
    t0 = time.perf_counter()
    rc = teval.main(["--config", str(ROOT / TRANSFORMER_CONFIG), "--device", "cuda",
                     "--checkpoint-dir", str(tmp / "tp"), "--output",
                     str(tmp / "tp_eval.json"), *RING_OVERRIDES, *flash])
    seconds_eval = time.perf_counter() - t0
    check(rc == 0, f"(a) eval.main on the split run's checkpoint exited {rc}")
    metrics = json.loads((tmp / "tp_eval.json").read_text())
    check(metrics["step"] == RING_STEPS and all(
        math.isfinite(v) for v in metrics.values() if isinstance(v, float)),
          f"(a) eval.main metrics {metrics}")
    _, evals = train_rows(tmp / "tp.csv")
    rate, ms = dp_rate(tmp, "tp")
    rate_ref, ms_ref = dp_rate(tmp, "ring_ref")
    log("tp", f"(a) {TRANSFORMER_CONFIG} at full width, flash towers split over "
              f"--n-model {TP_RANKS} on {TP_RANKS} gloo ranks sharing cuda:0, batch "
              f"{LEG_BATCH}, dropout {LEG_DROPOUT}, {RING_STEPS} steps: loss per step "
              + ", ".join(f"{float.fromhex(x):.6f}" for x in ranks[0]["loss"])
              + " vs one process " + ", ".join(f"{x:.6f}" for x in want_loss)
              + f"; flash launches per step and rank {per_step}; the checkpoint "
                f"restored in one process and encoded")
    log("tp", f"(a) eval.main in one process on the split run's checkpoint: "
              f"v2t/R@1 {metrics['v2t/R@1']:.3f}, t2v/R@1 {metrics['t2v/R@1']:.3f} "
              f"over {metrics['rows']} rows in {seconds_eval:.1f} s; the split "
              f"run's own eval at step {RING_STEPS}: v2t/R@1 "
              + (f"{float(evals[-1]['eval/v2t/R@1']):.3f}, t2v/R@1 "
                 f"{float(evals[-1]['eval/t2v/R@1']):.3f}" if evals else "none"))
    log("tp", f"(a) steady train rate: split towers {rate:.1f} pairs/s ({ms:.2f} ms "
              f"a step; {TP_RANKS} ranks on one card through gloo staged in host "
              f"memory: not scaling), one process of flash towers {rate_ref:.1f} "
              f"pairs/s ({ms_ref:.2f} ms a step) ({smi})")
    log("tp", f"(a) {seconds_ranks:.1f} s for the ranks' children (train.main "
              + ", ".join(f"{run['seconds']:.1f}" for run in ranks)
              + f" s), {seconds_ref:.1f} s for the flash reference")
    return launches


def lamb_phase(fd, smi: str, tmp: Path) -> dict:
    """(b) LAMB: the MLP leg's config at full width, batch 1024, through
    the train CLI with LAMB_OVERRIDES for LAMB_STEPS steps: the loss falls
    and the sym pair launches once a step; then, from its checkpoint, one
    update on the card (fp32) against the same update in float64 on the
    CPU from the same recorded gradients, moments and parameters: each
    parameter's max |error| within LAMB_UPDATE_RTOL of its largest |Δ|.
    Returns the sym pair's launches."""
    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.data import dataset_from_config, epoch_batches
    from crossclr_tpu_torch.training import LAMB, CheckpointManager, Trainer
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    ckpt, metrics = tmp / "lamb", tmp / "lamb.csv"
    reset_counts(fd)
    t0 = time.perf_counter()
    run_train(train, ["--steps", str(LAMB_STEPS), "--metrics-csv", str(metrics)],
              [*LAMB_OVERRIDES, f"checkpoint_dir={ckpt}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(fd.launch_counts)
    check_only(counts, sym_launches(LAMB_STEPS), "(b) LAMB leg")
    rows, evals = train_rows(metrics)
    losses = check_train_rows(rows, evals, int(16384 * 0.1), "(b) LAMB leg")
    cfg = apply_overrides(load_config(ROOT / TRAIN_CONFIG),
                          [*TRAIN_OVERRIDES, *LAMB_OVERRIDES])
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cuda")
    check(isinstance(trainer.optimizer, LAMB), "(b) the trainer's optimizer")
    state = CheckpointManager(ckpt).restore(trainer.init_state())
    dataset, _ = dataset_from_config(cfg.data)
    batch = next(epoch_batches(dataset, cfg.data.batch_size, seed=1))
    _, _, grads = trainer.value_and_grad(state, trainer.step_inputs(batch))
    params = {k: p.detach() for k, p in state.model.named_parameters()}

    def moments(to):
        return {"count": state.opt_state["count"],
                **{m: {k: to(v) for k, v in state.opt_state[m].items()}
                   for m in ("mu", "nu")}}

    def host(x):
        return x.detach().double().cpu()

    _, card = trainer.optimizer.updates(params, grads, moments(torch.clone))
    _, want = trainer.optimizer.updates({k: host(v) for k, v in params.items()},
                                        {k: host(v) for k, v in grads.items()},
                                        moments(host))
    errs = {k: ((host(card[k]) - w).abs().max() / w.abs().max()).item()
            for k, w in want.items() if w.abs().max() > 0}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= LAMB_UPDATE_RTOL,
          f"(b) one LAMB update on the card vs float64 on the CPU: {worst} "
          f"max |error| {errs[worst]:.3e} of its largest |Δ| (limit "
          f"{LAMB_UPDATE_RTOL})")
    log("tp", f"(b) {TRAIN_CONFIG} at full width with LAMB (lr "
              f"{cfg.train.learning_rate}, batch {cfg.data.batch_size}): "
              f"{LAMB_STEPS} steps in {seconds:.1f} s, loss {losses[0]:.4f} (step "
              f"{rows[0]['step']}) -> {losses[-1]:.4f}; eval v2t/R@1 "
              f"{float(evals[-1]['eval/v2t/R@1']):.2f}; steady "
              f"{float(rows[-1]['pairs_per_sec']):.1f} pairs/s ({smi}); launches "
              f"{({k: x for k, x in counts.items() if x})}")
    log("tp", f"(b) one LAMB update at step {state.step} on the card (fp32) vs "
              f"float64 on the CPU from the same gradients and moments: worst "
              f"{worst} max |error| {errs[worst]:.3e} of its largest |Δ| (limit "
              f"{LAMB_UPDATE_RTOL}) over {len(errs)} parameters")
    return counts


def tp_phase(fa, fd, smi: str, tmp: Path, ring: dict | None) -> dict:
    """Tensor parallelism and LAMB, last: (a) ``tp_two_ranks`` against the
    ring phase's one process of flash towers, (b) ``lamb_phase`` and the dp
    phase's two-rank podslice leg under LAMB (``dp_two_ranks``).  Returns
    the launches of each path."""
    torch.cuda.empty_cache()  # the children share the card
    t0 = time.perf_counter()
    out = {"tp": tp_two_ranks(tmp, smi, ref=None if ring is None else ring["ref"])}
    seconds_a = time.perf_counter() - t0
    out["lamb"] = lamb_phase(fd, smi, tmp)
    seconds_lamb = time.perf_counter() - t0 - seconds_a
    out.update(dp_two_ranks(tmp, smi, legs=("podslice_lamb",)))
    log("tp", f"the phase took {time.perf_counter() - t0:.1f} s: (a) {seconds_a:.1f} "
              f"s, (b) the MLP leg {seconds_lamb:.1f} s, the podslice leg "
              f"{time.perf_counter() - t0 - seconds_a - seconds_lamb:.1f} s ({smi})")
    return out


def loss_bounds(b: int, d: int, pruned: bool = False) -> dict:
    """Each loss kernel's least time at bf16 operands (the `default`
    tier), in units of one B×B×D product (2·B²·D operations) against the
    bf16 peak. V·Vᵀ and T·Tᵀ are symmetric, so each needs only its lower
    triangle, half a unit, with or without keep masks (the JAX package's
    sym kernels share them so: crossclr_tpu/ops/fused_dual.py:804-818).
    The forward is V·Tᵀ plus the two halves, 2 units; the backward
    recomputes those 2 and adds the four gradient products, 6 units.
    Each input is read once (the pruned variant's two bool masks too)
    and each output written once."""
    unit = 2 * b * b * d
    features = 2 * b * d * 2 + (2 * b if pruned else 0)  # V, T in bf16
    fwd = (features + 2 * b * 4, 2 * unit)  # + lse_v, lse_t
    bwd = (features + 4 * b * 4 + 2 * b * d * 4, 6 * unit)
    work = {"sym_fwd": fwd, "sym_bwd": bwd,
            "dual_fwd": (fwd[0] + 4, fwd[1]),  # + the scale
            "dual_bwd": (bwd[0] + 8, bwd[1])}  # + the scale and its term
    return {name: bound(nbytes, flops, torch.bfloat16)
            for name, (nbytes, flops) in work.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help="only compare the flash, per-direction, loss-pair and rows "
             "kernels with those of another revision: a directory holding its "
             "flash_fwd.cu, flash_bwd.cu, fused_crossclr.cu, fused_dual.cu, "
             "fused_global.cu and their headers (e.g. "
             "<unpacked git archive>/crossclr_tpu_torch/ops/csrc); prints their "
             "times and a JSON line of records")
    parser.add_argument("--dp-worker", type=Path, default=None,
                        help=argparse.SUPPRESS)  # a child of the dp phase
    parser.add_argument("--ring-worker", type=Path, default=None,
                        help=argparse.SUPPRESS)  # a rank of the ring phase
    parser.add_argument("--aot-worker", type=Path, default=None,
                        help=argparse.SUPPRESS)  # the aot phase's loader
    parser.add_argument("--shard-worker", type=Path, default=None,
                        help=argparse.SUPPRESS)  # a rank of the shard phase
    parser.add_argument(
        "--dp-fault", choices=("none", "averaged", "unsummed"), default=None,
        help="only run the dp phase's two ranks (b), with this gradient "
             "reduction in the ranks (none: the port's own; averaged: "
             "divided by the world size; unsummed: each rank's own), and "
             "log each check's reading beside its limit without failing")
    parser.add_argument(
        "--sp-fault", choices=("none", "unsummed", "doubled"), default=None,
        help="only run the ring phase's train CLI (b), with this reduction "
             "over the model group in the ranks (none: the port's own; "
             "unsummed: each rank's share of the gradient, not summed over "
             "the model group; doubled: the ring towers' summed gradients "
             "not divided by n_model), and log each check's reading beside "
             "its limit without failing")
    parser.add_argument(
        "--tp-fault", choices=("none", "uncopied"), default=None,
        help="only run the tp phase's train CLI (a), with this conjugate "
             "collective in the ranks (none: the port's own; uncopied: the "
             "cotangent of a split layer's replicated input not summed over "
             "the model group), and log each check's reading beside its "
             "limit without failing")
    args = parser.parse_args(argv)
    if args.dp_worker is not None:
        return dp_worker(args.dp_worker)
    if args.ring_worker is not None:
        return ring_worker(args.ring_worker)
    if args.aot_worker is not None:
        return aot_worker(args.aot_worker)
    if args.shard_worker is not None:
        return shard_worker(args.shard_worker)
    t_start = time.perf_counter()
    smi = device_phase()
    sys.path.insert(0, str(ROOT))
    # the plain versions' products in full fp32 (PyTorch's default, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")
    fd = importlib.import_module("crossclr_tpu_torch.ops.fused_dual")
    fg = importlib.import_module("crossclr_tpu_torch.ops.fused_global")
    fc = importlib.import_module("crossclr_tpu_torch.ops.fused_crossclr")
    build_phase()
    if args.baseline is not None:
        records = baseline_phase(fa, fc, fd, fg, smi, args.baseline.resolve())
        print(json.dumps({"baseline": str(args.baseline), **records}), flush=True)
        return 0
    if args.dp_fault is not None:
        with tempfile.TemporaryDirectory(prefix="crossclr_dp_") as tmp:
            dp_two_ranks(Path(tmp), smi, args.dp_fault, legs=tuple(DP_LEGS))
        return 0
    if args.sp_fault is not None:
        with tempfile.TemporaryDirectory(prefix="crossclr_ring_") as tmp:
            ring_two_ranks(Path(tmp), smi, args.sp_fault)
        return 0
    if args.tp_fault is not None:
        with tempfile.TemporaryDirectory(prefix="crossclr_tp_") as tmp:
            tp_two_ranks(Path(tmp), smi, args.tp_fault)
        return 0
    seconds, clock = {}, [t_start]

    def took(phase: str) -> None:  # the seconds since the last phase ended
        seconds[phase] = round(time.perf_counter() - clock[0], 1)
        clock[0] = time.perf_counter()

    took("device and build")
    data_phase(smi)
    took("data")
    fwd_worst = kernel_phase(fa, smi)
    flash_worst = attention_check_phase(fa)
    flash_worst["flash_fwd"] = max(flash_worst["flash_fwd"], fwd_worst)
    flash_times = attention_timing_phase(fa, smi, flash_worst)
    took("kernel and attention")
    # every in-process leg's synthetic pairs are made once, from here to the
    # paths phase
    pairs = contextlib.ExitStack()
    pairs.enter_context(dataset_once())
    serve_launches = slice_phase(fa, smi)
    took("slice")
    # the serve phase's checkpoint serves the aot, shard and profile phases
    with tempfile.TemporaryDirectory(prefix="crossclr_serve_") as tmp:
        tmp = Path(tmp)
        checkpoint_launches = serve_checkpoint_phase(fa, smi, tmp)
        took("serve")
        aot = aot_phase(fa, smi, tmp)
        took("aot")
        shard_launches = shard_phase(fa, smi, tmp, aot)
        took("shard")
        aot_launches = aot["launches"]
        del aot  # its services
        profile_launches = profile_phase(fa, fd, smi, tmp)
        took("profile")
    loss_worst = loss_check_phase(fd)
    loss_times = loss_timing_phase(fd, smi)
    pruned_worst = pruned_check_phase(fd, fg)
    for name, err in leg_check_phase(fd).items():
        loss_worst[name] = max(loss_worst[name], err)
    pruned_times = pruned_timing_phase(fd, fg, smi)
    direction_worst = direction_check_phase(fc, fd)
    leg_worst = direction_leg_check_phase(fc, fd)
    for name in fc.KERNELS:
        direction_worst[name] = max(direction_worst[name], leg_worst[name])
    loss_worst["sym_bwd"] = max(loss_worst["sym_bwd"], leg_worst["sym_bwd"])
    direction_times = direction_timing_phase(fc, fd, smi)
    took("loss and direction")
    rows_worst = global_check_phase(fd, fg)
    rows_launches = global_loss_phase(fg)
    rows_times = global_timing_phase(fd, fg, smi, rows_worst)
    took("global")
    loss_launches = train_phase(fd, smi)
    took("train mlp")
    flash_launches = transformer_train_phase(fa, fd, smi)
    took("train transformer")
    store_legs_phase(fa, smi)
    took("store legs")
    # the pruned branch's path: the full-CrossCLR legs, dual then sym
    pruned_launches = {**full_train_phase(fa, fd, fg, fc, smi),
                       **full_static_phase(fa, fd, fg, fc, smi)}
    took("train full-CrossCLR")
    # the per-direction kernels' path: large-batch training
    direction_launches = podslice_train_phase(fa, fd, fg, fc, smi)
    took("train large-batch")
    grad_cache_phase(fc, smi)
    took("gradcache")
    paths_phase(smi)
    took("paths")
    pairs.close()  # the child-process phases below make their own
    dp_launches = dp_phase(smi)
    took("dp")
    # the ring phase's one process of flash towers serves the tp phase too
    with tempfile.TemporaryDirectory(prefix="crossclr_grid_") as tmp:
        ring = ring_phase(fa, smi, Path(tmp))
        took("ring")
        tp_launches = tp_phase(fa, fd, smi, Path(tmp), ring)
        took("tp")
    ring_launches = ring["launches"]
    log("train", f"flash_fwd launches: serving {serve_launches}, transformer "
                 f"training {flash_launches['flash_fwd']}, train-eval-serve-reload "
                 f"{checkpoint_launches['flash_fwd']}")

    # the text tower at the leg's batch, timed in the build the leg's
    # train steps launch (dropout 0.1) against the plain version of the
    # same function; torch has one call for the forward and one for the
    # whole backward, so both backward records carry the latter
    b, s = ATTENTION_TIMING[0]
    flash_bounds = flash_times[("bounds", b, s)]
    timed_at = f"B={b} H=8 S={s} Dh=48 bf16, dropout {LEG_DROPOUT}"
    flash_rows = {  # (kernel, plain version, library call, what it computes)
        "flash_fwd": ("flash_fwd dropout", "plain fwd dropout", "sdpa fwd",
                      "scaled_dot_product_attention forward, dropout 0"),
        "flash_dq": ("flash_dq dropout", "plain dq dropout", "sdpa bwd",
                     "scaled_dot_product_attention backward (dq, dk and dv "
                     "together), dropout 0"),
        "flash_dkv": ("flash_dkv dropout", "plain dkv dropout", "sdpa bwd",
                      "scaled_dot_product_attention backward (dq, dk and dv "
                      "together), dropout 0"),
    }
    records = []
    for name, (kernel_key, plain_key, library_key, library_call) in flash_rows.items():
        launches = {"transformer_training": flash_launches[name],
                    "train_eval_serve_reload": checkpoint_launches[name],
                    "ring_training": ring_launches[name],
                    "tensor_parallel_training": tp_launches["tp"][name],
                    "profiled_training": profile_launches[name]}
        if name == "flash_fwd":
            launches["serving_random_weights"] = serve_launches
            launches["aot_artifact"] = aot_launches["flash_fwd"]
            launches["sharded_serve_eval"] = shard_launches["flash_fwd"]
        records.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCES[name],
            "replaces": FLASH_REPLACES[name], "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": flash_worst[name],
            "ms": flash_times[(kernel_key, b, s)],
            "plain_ms": flash_times[(plain_key, b, s)],
            **flash_bounds[name],
            "library_ms": flash_times[(library_key, b, s)],
            "timed_at": timed_at, "library_call": library_call,
        })
    bounds = loss_bounds(*SLICE_LOSS_SHAPE)
    # the pruned branch at the full-CrossCLR leg's shape
    b, d = PRUNED_TIMING[0]
    pruned_bounds = loss_bounds(b, d, pruned=True)
    for name in fd.KERNELS:
        ms, plain_ms = loss_times[(name, *SLICE_LOSS_SHAPE)]
        pruned_ms, pruned_plain_ms = pruned_times[(name, b, d)]
        launches = {"mlp": loss_launches[name],
                    "full_crossclr": pruned_launches[name],
                    "data_parallel_one_rank": dp_launches["a"].get(name, 0),
                    "tensor_parallel_training": tp_launches["tp"].get(name, 0),
                    "lamb_mlp": tp_launches["lamb"].get(name, 0),
                    "profiled_training": profile_launches.get(name, 0)}
        records.append({
            "name": name, "route": "cuda", "source": LOSS_SOURCE,
            "replaces": LOSS_REPLACES[name], "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(loss_worst[name], pruned_worst[name]),
            "ms": ms, "plain_ms": plain_ms, **bounds[name], "library_ms": None,
            "pruned_ms": pruned_ms, "pruned_plain_ms": pruned_plain_ms,
            "pruned_bound_ms": pruned_bounds[name]["bound_ms"],
            "pruned_timed_at": f"B={b} D={d} bf16, keep masks at prune {PRUNE}",
        })
    # the full-CrossCLR leg's shape: 1024 anchors against their own batch;
    # and one rank's block of the global losses at 4 ranks
    b, d = GLOBAL_TIMING[0]
    bounds = rows_bounds(b, b, d)
    rank_loc, rank_b, rank_d, rank_off = RANK_SHAPE
    rank_bounds = rows_bounds(rank_loc, rank_b, rank_d)
    for name in fg.KERNELS:
        ms, plain_ms = rows_times[(name, b, b, d)]
        rank_ms, rank_plain_ms = rows_times[(name, rank_loc, rank_b, rank_d)]
        launches = {"global_losses": rows_launches[name],
                    **{f"data_parallel_{leg}": dp_launches[f"b_{leg}"][name]
                       for leg in DP_PHASE_LEGS},
                    "data_parallel_podslice_lamb":
                        tp_launches["b_podslice_lamb"][name]}
        records.append({
            "name": name, "route": "cuda", "source": ROWS_SOURCE,
            "replaces": ROWS_REPLACES[name], "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": rows_worst[name], "ms": ms, "plain_ms": plain_ms,
            **bounds[name], "library_ms": None,
            "timed_at": f"B={b} D={d} bf16, keep masks at prune {PRUNE}",
            "rank_ms": rank_ms, "rank_plain_ms": rank_plain_ms,
            "rank_bound_ms": rank_bounds[name]["bound_ms"],
            "rank_timed_at": f"b_loc={rank_loc} of B={rank_b} D={rank_d} "
                             f"off={rank_off} bf16, keep masks at prune {PRUNE}",
        })
    # timed at 4096 x 256 beside the plain version, and alone at the leg's
    # shape, where the plain version's [B, 2B] logits would take 34 GB
    b, d = DIRECTION_TIMING
    bounds = direction_bounds(b, d)
    leg_bounds = direction_bounds(PODSLICE_BATCH, 256)
    for name in fc.KERNELS:
        records.append({
            "name": name, "route": "cuda", "source": DIRECTION_SOURCE,
            "replaces": DIRECTION_REPLACES[name],
            "launches": direction_launches[name],
            "max_abs_err": direction_worst[name],
            "ms": direction_times[(name, b, d)],
            "plain_ms": direction_times[("plain " + name, b, d)],
            **bounds[name], "library_ms": None,
            "timed_at": f"B={b} D={d} bf16",
            "leg_ms": direction_times[(name, PODSLICE_BATCH, 256)],
            "leg_bound_ms": leg_bounds[name]["bound_ms"],
            "leg_timed_at": f"B={PODSLICE_BATCH} D=256 bf16",
        })
    log("smoke", f"seconds by phase: {seconds} ({smi})")
    log("smoke", f"the run took {time.perf_counter() - t_start:.1f} s ({smi})")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
