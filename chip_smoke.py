#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (vlsa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out record.json]

Run from the root of the repository.  Phases, in order; any failure exits
non-zero and prints no result:

  1. device: CUDA is required; prints the card's name and power limit;
  2. kernel: builds csrc/coattn_fwd.cu, csrc/coattn_bwd_dq.cu,
     csrc/coattn_bwd_dx.cu, csrc/abmil_fwd.cu, csrc/abmil_bwd.cu and
     csrc/flash_attn_fwd.cu with nvcc (one process each, started together)
     and holds each storage variant of
     the co-attention forward kernel against the port's plain version on the
     card (B=8, N=10240, C=512, P=12, scale 30, 10% of patches masked, one
     empty bag; B=5, N=12291, a partial last tile; and B=4, N=3000 at
     C=1024, the kernel's wide instance, checked by its path counter
     `LAUNCHES_FWD_PATH`), in f32; tolerances f32 2e-6 (its split-TF32
     products; the timed phases hold it at 1e-4), bf16 and int8 1e-3;
     beside that gap it prints the gap to the plain model of the kernel's
     rounding (`coattn_fwd_rounded`); the empty bag gives out = 0,
     m = -1e30, l = 1e-30; the streaming kernel's ptxas lines go to the
     record, and an instance that spills fails the run;
  2b. backward kernel: holds each variant of the dQ kernel against its plain
     version at the same shape and at B=4, N=3000, C=1024 (the wide
     instance, checked by `LAUNCHES_BWD_PATH`), with (out, m, l) from the
     forward kernel; tolerances (max|a-b| / max|b|) f32 2.5e-6 (its split-TF32
     products; the timed phases hold it at 1e-3), bf16 and int8 2e-3; the
     backward kernels' ptxas lines go to the record, and an instance that
     spills fails the run;
  2c. ABMIL kernels: holds each variant of csrc/abmil_fwd.cu and
     csrc/abmil_bwd.cu against its plain version at B=8,
     N=10240 and (D, hid) = (512, 256) (the resident instances), (1024,
     256), (768, 128) and (1536, 512) (the general ones, counted by
     `LAUNCHES_ROUTE`; 10% of patches masked, one empty bag): the
     forward (f32 1e-4, bf16 and int8 1e-3), the weights-only backward and,
     for f32 and bf16, the backward with dX (dW1, db1, dw2: f32 1e-3, bf16
     and int8 2e-3; dX: f32 1e-3, bf16 1e-2, one bf16 ulp); every storage
     also at B=5, N=12291, which ends in a partial tile (64 patches f32 and
     general, 128 bf16 and int8) and a partial chunk of the launch plans, at
     (512, 256) and (1024, 256); bf16 in vlsa_tpu's precise mode (W1 and dz
     as bf16 hi + lo) at (512, 256) and (1024, 256) against the plain f32
     version at the bf16 limits, its forward within 2e-5 of the plain model
     of its rounding (`abmil_fwd_rounded`, precise=True), its backward
     against the exact model of its rounding (`abmil_bwd_rounded`,
     exact=True): dX beyond its rounding to bf16, db1 and dw2 over their
     sums' scale within 2e-5, dW1 within 5e-5 of max|dW1|, limits the
     single-rounded model must miss in dW1 and dX; all of this again at
     every width the kernels take (`ABMIL_ANY_WIDTHS`: (2560,
     256), (2560, 512), (4096, 256), (4096, 1024), (1000, 384), (768, 96),
     (100, 32), (1536, 1024), (64, 32): W1 zero-padded to whole passes and
     slices, rows of any length and alignment), ragged and precise at (2560, 256)
     and (1000, 384); beside the int8
     forward's gap it prints the gap to `abmil_fwd_rounded`, the plain model
     of its W1 split; the kernels' ptxas lines (registers, static shared
     memory, spills) and dynamic shared memory go to the record, and an f32
     instance, a bf16 or int8 forward instance, a general forward instance
     (11) or a backward pass of any storage (24) that spills fails the run,
     as does a forward instance or a backward pass with a stack frame;
  2d. flash kernel: holds both variants of csrc/flash_attn_fwd.cu against
     the plain version at B=64, H=12, hd=64 and L = 785 (CONCH at 448 px),
     197, 1, 801 and 1025 (CONCH at 512 px): bf16 on the path `flash_plan`
     gives (the streamed kernel for every L), checked by the path counters,
     and the resident kernel forced at 785 and 197 (f32 1e-4, bf16 2e-3,
     f32 output); then the zero-query probe (q = 0, v = 1: every output
     exactly L * bf16(1/L), within 1e-6, the mark of P normalised before it
     is rounded) on every bf16 path at L = 197, 785, 801 and 1025; ptxas's
     lines (registers, static shared memory, spills) go to the record, and a
     resident instance or the streamed kernel that spills, or a stack frame
     in the streamed kernel, fails the run;
  2e. full (dX) backward kernel: holds both variants of csrc/coattn_bwd_dx.cu
     against its plain version at the shape of phase 2 and at B=4, N=3000,
     C=1024 (the wide instance; the masked rows holding features), with
     (out, m, l) from the forward kernel: dq f32 2.5e-6, bf16 2e-3, dX f32
     4e-6 (the timed phase 4d holds f32 at 1e-3), bf16 dX within one bf16
     ulp at the scale of its largest element; dX is exactly 0 on masked rows
     and the empty bag, and within 2e-2 of a true-f32 autograd of the plain
     pooling;
  2f. the co-attention kernels above 16 queries (ceil(P/16) query groups of
     16 rows, the last zero-padded; the forward and dQ with the groups on
     the grid, dX looping over them on each tile): every forward and dQ
     variant and both dX storages at P = 17, 32, 64 and 128 (B=8, N=10240,
     C=512) and at P=32, C=1024 (the wide instances) against their plain
     versions (forward TOL, dq TOL_DQ, dX dq 1e-3, bf16 dX one ulp; f32
     within TOL_F32_FWD and TOL_F32_BWD of the exact function, the plain
     version in float64, whose f32 run is printed beside it; the forward's
     gap to `coattn_fwd_rounded` printed), the empty bag
     and masked rows as phases 2 and 2e, each call one launch on its query
     route (`LAUNCHES_QUERY_PATH`: "grid", "loop");
  2g. past the old limits, each route against its plain version at 2c's and
     2f's tolerances: the ABMIL kernels (every storage and precise bf16,
     forward and both backwards) at (D, hid) = (10240, 256), (512, 1536)
     and (9000, 1100), B=2, N=2048, a ragged mask and an empty bag (D past
     8192 on the "wide" route, `LAUNCHES_ROUTE`: D's vectors in device
     memory; hid past 1024: b1 and w2 a pass at a time, the backward's
     column sums in a per-block workspace); the looped dX (f32, bf16) at P
     = 8,657 and 20,000 (B=2, N=1024, C=512; each query group's stats staged
     as it comes, the dq partials' blocks capped); the forward and dQ,
     every variant, at P = 1,048,592 (65,537 query groups, B=1, N=64, C=8:
     the grid launched a chunk of 65,535 groups at a time, the "chunked"
     route; f32 dq against the exact function at 2f's f32 dX limit, its
     largest gap over 8.4 million entries of 8 channels being past 2f's dq
     limit, beside a product on TF32-rounded operands that must fail it);
     each storage's and variant's launches counted for the kernels line;
  3. serving: builds the flagship VLSA at the full CONCH width from a seed
     and answers requests of 8 synthetic bags (N~8192 jittered) in every
     storage variant -- 2 in bf16 and 2 in int8 with host 1/||x|| among
     them -- counting the kernel's launches, and holds the incidence
     probabilities against the same requests with the plain co-attention;
  3b. training: builds the flagship trainer on TCGA-BLCA fold 0 (12 label
     bins) and takes Adam steps of SurvIFMLE + SurvEMD on batches of 32
     patients' synthetic bags: one in each variant (phase 3g takes 20
     bf16 steps in a row), counting both kernels' launches; every step has
     a finite loss, an unchanged frozen tower and moved learnable
     parameters; on the main path's last batch of each variant the
     gradients through the kernels and through the plain co-attention
     agree within 2e-3 per parameter (max|a-b| / max|b|, the text tower
     computing in f32 for this check: see f32_text_tower); with the
     configured bf16 tower the kernel's gap stays within 4x of the gap a
     1e-7 relative change of the plain output makes;
     one more bf16 step runs under torch.profiler for the kernels' share;
  3c. SA serving: builds the SA baseline (DeepMIL/ABMIL of
     configs/IFMLE/tcga_blca/cfg_sa_base_conch.yaml, D=512, hid=256, fold 0's
     12 bins) from a seed and answers requests of 8 synthetic bags: 3 in
     bf16, 3 in int8, 1 in f32, counting the ABMIL kernels' launches, and
     holds the incidence probabilities against the plain pooling (1e-3);
  3d. SA training: Adam steps of SurvIFMLE on TCGA-BLCA fold 0 with 32
     patients' bags a step: one in bf16, one in f32 and one in int8, then
     one each in bf16 and f32 with `deepmil_use_feat_proj: True` (x needs a
     gradient: the dX kernels); every step has a finite loss, moved
     parameters and an unchanged fc2 bias; on each variant's last batch the
     gradients through the kernels agree with those through the plain
     versions within 2e-3 per parameter; one more step each in bf16 and in
     f32 (the shipped config's storage) is profiled, with its peak device
     memory;
  3e. extraction: `FeatureExtractor` with CONCH at full width (448 px, batch
     64, bf16, device preprocessing, seeded weights) runs `extract_to_store`
     over two synthetic slides of 130 and 140 512x512 u8 tiles (ragged last
     batches) into .npy and then .q8npz stores, and a float32 extractor one
     batch, counting the flash kernel's launches (12 a batch, every bf16
     one on the path of flash_plan(785)); the stores
     read back through SurvBagDataset (.npy exact, .q8npz within one int8
     step of the quantized .npy features); the features agree with the same
     run through the plain attention (bf16 2e-2, f32 1e-4); device
     preprocessing of 4 tiles equals the host stack (u8 byte-exact, the
     normalize within 1 ulp); the tower's time per batch (CUDA events,
     median of 10) and one profiled batch; then the same extractor at 512
     px (L = 1025, the path of `runner.extract --image_size 512`) over one
     slide of 100 tiles (batches of 64 and 36) to .npy, its counters from 0:
     12 bf16 flash launches a batch, all on the path of flash_plan(1025),
     the features within 2e-2 of the plain attention's, tiles/s and the
     tower's time per batch;
  3q. the rest of extraction (run after 3e): `FeatureExtractor` and
     `extract_to_store` over 3e's tile slides (the same seed) to .npy at
     448 px, batch 64, bf16, every counter from 0 before each path: CLIP
     ViT-B/16 (`model_name="clip_vit"`: no kernel launched, finite 512-d
     features, a float32 extractor's batch within cosine 0.99 of the bf16
     one) and the w8a8 CONCH trunk (`trunk_quant=True`: exactly 12 bf16
     flash launches a batch, 72 in all, every one on flash_plan(785)'s
     path and no other kernel; the features within 2e-2 of the same tower
     on the plain attention, cosine above 0.99 to the float bf16 tower of
     3e's weights); `torch._int_mm` exact in int32 at the trunk's largest
     product, [50240, 3072] x [3072, 768], and the w8a8 linear and the
     weight quantizer bit for bit the CPU's; CLIP's RN50 (f32, BatchNorm
     statistics from a seed) on 2 images card against CPU within 1e-4;
     each tower's ms a batch (CUDA events, median of 10; RN50 at 64
     images), tiles/s beside 3e's bf16 run, and one profiled w8a8 batch by
     kernel group (int8 GEMMs apart); row 11's w8a8 launches join the
     kernels line;
  3r. CoCa captions (after 3q): CONCH's visual model as extraction builds
     it (448 px, bf16 trunk), the published CONCH text tower and
     `MultimodalDecoder` (768, 12 heads, 12 layers, context 128, vocabulary
     32007) in f32 from a seed, TF32 off; 4 of 3e's random tiles through
     the device preprocess, then, every counter from 0 before, the trunk
     (exactly 12 streamed bf16 launches of row 11, no other kernel; they
     join the kernels line) and `coca_generate` on three paths: beam search
     at its defaults (6 beams, 3 groups), greedy `top_k` 1 with
     `repetition_penalty` 1.3, `top_p` 0.1 (seed 0), seq_len 30, min_seq_len
     5; the caption tokens [4, 256, 768] within 2e-2 of the same forward
     under `ops.flags.disable_kernels()`; every row starting with <sot>,
     pads only after the first <eos>, the beam's at most 30 wide; each
     path's final buffers re-scored on the CPU with the same modules (one
     teacher-forced decode step), the card's logits at the generated
     positions within 1e-4, and each greedy token the CPU's argmax wherever
     the CPU's top-2 margin exceeds twice the logit gap (the positions under
     it counted); prints ms a decode step (CUDA events, beam and sampling
     rows), the host's ms a step, captions/s a path, one profiled beam step
     by kernel group and the peak device memory;
  3f. training with the feature projecter: the flagship trainer with
     `vlsa_img_encoder_use_feat_proj: True` (the patch features then need a
     gradient: the dX kernel) takes Adam steps on TCGA-BLCA fold 0: 1 in
     bf16, 1 in f32, 1 in int8 (dequantized to bf16 by VLFAN) and 1 in bf16
     with host 1/||x|| (dropped by VLFAN), counting the forward and dX
     launches (the dQ-only kernel launches none) and the peak device memory
     of each step; every step has a finite loss, an unchanged frozen tower
     and moved learnable parameters, the projecter's included; on each
     storage's last batch (text tower in f32, patients censored in the last
     bin left out) the gradients through the kernels agree within 2e-3 per
     parameter with CoattnPoolFull run on the plain versions of both
     kernels and, for f32, with autograd through the plain pooling (for the
     bf16 storages that gap is logged); one request of 8 bf16 bags is served
     by the trained model (1e-3 of the plain co-attention) and one more bf16
     step is profiled, with the projecter's GEMM and LayerNorm as groups;
  3g. the run lifecycle (`python -m vlsa_tpu_torch.main`'s handlers): the
     flagship config (configs/IFMLE/tcga_blca/cfg_vlsa_conch.yaml, fold 0,
     full CONCH width, bf16 storage, random weights from the seed) through
     `VLSAHandler(cfg).exec()` for 1 epoch (cut from 10; 2 until phase 3i
     came), then
     cfg_sa_base_conch.yaml (f32 storage, bags of N~1024, for the script's
     time) through `SAHandler` for 1, on
     the 298 training and 75 test patients, save_path in a temporary
     directory, every launch counter from 0 just before: each epoch trains
     and evaluates the test split, then the last checkpoint is loaded and
     both splits are evaluated again; the launches must be exactly those of
     the path (VLSA: the bf16 co-attention forward and dQ kernels; SA: the
     f32 ABMIL forward and backward); every epoch's and the final train and
     test metrics are finite, each C-index in [0, 1]; the last checkpoint
     holds no text-tower entry and loads back; the test probabilities after
     the reload equal the last epoch's in-memory pass bit for bit; the
     prediction CSVs have 298 and 75 rows of non-increasing curves; the
     test probabilities are within 1e-3 of a pass of the same weights
     through the plain pooling, and each C-index within the share of
     comparable pairs that could change order (plain gap below
     max(2e-3, twice the estimate's largest kernel-plain gap); the share
     below 2e-3 is printed); prints each epoch's time, slides/s, the seconds
     it waited for batches and the seconds the batcher's producer thread
     spent building them (`prefetch: 2`, as shipped), and each evaluation
     pass's time, beside the card's name and power limit;
  3h. the run lifecycle from feature stores: checks the free disk, writes
     fold 0's 437 slides (bags of N~8192, the shipped length) as a .npy f32
     store (7.3 GB, 8 threads) in a temporary directory and converts it to
     .q8npz with
     `python -m vlsa_tpu_torch.data.convert --dtype int8`, printing sizes
     and seconds; holds one batch of 32 test patients of each store
     (.npy in f32 and bf16, .q8npz in int8 with 1/||x||), built by the native
     loader in page-locked memory, byte for byte against the numpy path's,
     and times its features' copy to the card from page-locked and from
     pageable memory (in turns, the least of two each);
     then five 1-epoch `exec()`s from the stores, each with every launch
     and batch counter from 0 just before: the flagship in bf16 from .npy,
     in int8 with the store's 1/||x|| from .q8npz, SA in f32 from .npy, a
     few-shot flagship (`num_shot: 4`, bf16, .npy; its training set exactly
     `FewShotSurvBagDataset`'s sample) and SA with SurvPLE, the Cox
     evaluator and `origin` labels (f32, .npy); each run builds every batch
     natively (no numpy batch), launches exactly its path's kernels, gives
     finite metrics and C-indices in [0, 1], and test predictions within
     1e-3 of the plain pooling's; prints each run's epoch time, slides/s,
     wait and build shares, evaluation passes and host memory (the resident
     set's peak within the run and its rise over the run's start; torch's
     page-locked pool, which the run releases at its end) beside the card's
     name and power limit (every run reads a page cache that writing the
     stores warmed);
  3s. vlsa_tpu's checkpoint format (after 3h, from its kept flagship bf16
     .npy run): the filtered state written as vlsa_tpu writes a run's
     checkpoint (flax's msgpack layout, `pack_flax_msgpack`) into a copy of
     the run directory; its tensors equal to 3h's torch checkpoint's, the
     test pass of `test_model(ckpt_path=...)` from each bit for bit, and
     `load_vlsa_from_run` on both directories giving bit-identical logits;
     its co-attention launches join the kernels line;
  3u. vlsa_tpu's runs resumed (after 3s): the committed checkpoints of
     vlsa_tpu_torch/assets/checkpoints/ (a DeepMIL/ABMIL 64-32-12 run with
     Adam's optax state, and a tree of bf16, int8 and f32 leaves) read from
     vlsa_tpu's msgpack and orbax backends (the orbax directories through
     the port's own OCDBT, zarr and zstd readers) into bit-identical state
     dicts and optimizer states, the zstd decoder's MB/s over their frames;
     the SA run resumed through `auto_resume` for its second epoch (fold 0,
     bags of N~1024 at D=64; the general ABMIL instances, rows 7-8), finite
     metrics; then 3h's kept flagship bf16 run with its Adam state packed
     into optax's tree (`optax_adam_tree`) beside its weights in vlsa_tpu's
     msgpack layout, resumed for one epoch through `auto_resume` (exec's
     training loop and its evaluation each epoch; the final passes left out
     for the script's time) from that file and from the port's own torch
     checkpoint: every evaluation event (the losses and metrics) and the
     test probabilities bit-identical (rows 1 and 6);
     its launches join the kernels line;
  3t. multi-process runs (after 3h): four ranks spawned on the one card,
     joined with gloo (ranks sharing a card; each collective staged through
     host memory).  The sequence-parallel pools at B=8, N=10240, C=512, P=12
     (10% masked, an empty bag) on {data: 2, model: 2} and {data: 1,
     model: 4}: co-attention f32 and bf16 (rows 1, 6) and bf16 with dX
     (row 5, the projecter), ABMIL at (512, 256) f32 and bf16 with and
     without dX (rows 7, 8); each rank's launches on its chunk held against
     the plain versions at phases 2-2e's limits (the backward with the
     merged stats), the pool as the models call it (its launches counted),
     and the merged output and gradients against the single-process kernels
     on the data rank's whole bags at twice those limits (both sides are
     within one limit of the same plain function).  Then the flagship
     (bf16 features, the CONCH tower at full width in bf16, tensor and
     sequence parallel) and the SA 512-256-12 (f32) on {data: 2, model: 2}:
     2 steps of 32 bags and an evaluation pass of the test split, every rank
     with the same losses and metrics; the SA's losses within 1e-4 of the
     same steps on one rank, the flagship's first step (its loss and every
     gradient) within twice bf16's own effect on one rank (one rank's step
     against its step with the tower in f32); the
     step ms by layout and the collectives' host seconds are printed, not
     a scaling figure (the ranks time-slice one card).  Last, `python -m
     vlsa_tpu_torch.main --handler SA` as two processes joined through a
     `distributed` dict (mesh {data: 2}), each with its own save path: both
     ranks evaluate rank 0's last checkpoint, which rank 0 alone reads and
     sends on, print the same final metrics, and only rank 0 writes the
     run's files.  Then what a mesh ran only on one rank before (ROADMAP.md
     §A.18), each against one rank's run of the same global steps (the
     first step's gradients within 2e-3, the losses within 1e-4): one
     adahessian step of the flagship (its tower in f32) on {data: 2, model:
     2} with TP and SP and of the SA on {data: 4, model: 1}, every rank
     and the one rank drawing the same z; 2 steps of the SA's Cox model
     (SurvPLE) with accum_steps 2 on {4, 1} and {2, 2}, each rank fed its
     shares of vlsa_tpu's contiguous micro-batches.  Its launches join the
     kernels line;
  3i. the released CONCH weights and zero-shot: writes a CONCH-format
     `pytorch_model.bin` beside the stores (the text tower under `text.*`
     at its published width: 12 layers of 768, vocabulary 32007, context
     128, output 512; `logit_scale` 4.0; `visual.*` and `text_decoder.*`
     decoys; random from a seed) and runs configs/IFMLE/tcga_blca/
     cfg_zero_shot_conch.yaml on fold 0 with `path_clip_model` naming its
     directory, from phase 3h's stores (bf16 from .npy, int8 from .q8npz),
     each with `logit_top10`, `logit_max` and `logit_mean`: every run
     launches no kernel, trains nothing, gives finite metrics and C-indices
     in [0, 1] on the 75 test patients, has the file's tower (bf16 where
     the frozen tower stores it so) and logit scale exactly, text
     prototypes of the tower computing in f32 within 1e-4 of the CPU's
     (the bf16 tower's gap printed), and the first test batch's
     probabilities within 1e-3 of the port's computation on the CPU from the
     same text prototypes (the gap to a float64 computation printed); then
     writes a
     reference-format CoOp checkpoint and trains the flagship 1 epoch (bf16,
     .npy) with that tower and the CoOp learner warm-started from it: both
     as the files hold them before the run, exactly rows 1 and 6 (bf16)
     launched, test predictions within 1e-3 of the plain pooling's; prints
     each run's pass seconds and peak device memory beside the card's name
     and power limit;
  3j. interpretation: reloads phase 3h's flagship run (bf16, .npy) with
     `load_vlsa_from_run` (its logits on 16 test bags within 1e-6 of the
     model 3h trained), then `interpret_cohort` over fold 0's 75 test
     patients, batch 16, in f32 from the .npy store and from the .q8npz
     store (dequantized on the host): exactly one f32 co-attention forward
     a batch and no other kernel; the CSV's 75 rows and columns; every value
     finite, probabilities summing to 1 within 1e-5; the efficiency axiom
     per patient within 1e-4 (v in float64 from the returned similarities);
     the .npy cohort within 1e-5 of the same cohort through the plain
     pooling on the card, its first batch within 1e-4 of the port on the
     CPU (from the card's text prototypes), and 4 patients' Shapley values
     within 1e-5 of max|phi| of a float64 enumeration of the 2^12
     coalitions in the reference's order; `calc_text_img_similarity` on a
     stored bag padded by 1024 masked rows in f32 and bf16 (vlsa_tpu's keys
     and shapes, one forward a call, attention rows summing to 1, 0 on the
     padding) and `calc_abmil_text_img_similarity` with a full-width
     DeepMIL-encoder VLSA (no kernel; the attention sums to 1, 0 on the
     padding); then two 1-epoch runs from the stores as 3h's: SA with
     `deepmil_pooling: gated_attention` (f32, no kernel launched) and the
     flagship with `vlsa_img_encoder_query_pooling: attention` (bf16, rows
     1 and 6), whose new poolings' parameters move; prints the cohort's
     wall seconds and patients/s, its card time by part (CUDA events:
     encode + decoupled product, Shapley), its peak device memory and the
     single bags' times beside the card's name and power limit; the stores
     and checkpoints are then removed;
  3l. the flagship with 32 learned, gated VLFAN queries (`vlsa_img_encoder_
     query: Parameter`, `num_query: 32`, `gated_query: True`: 33 parameter
     rows folded to P = 32), every counter from 0 before each path: 2 bf16
     and 2 int8 (with 1/||x||) requests of 8 bags served (1e-3 of the plain
     co-attention), 1 epoch from phase 3h's bf16 .npy store through
     `vlsa_tpu_torch.main.main` with 3h's checks and the reloaded
     checkpoint's test probabilities bit for bit, a store batch's gradients
     (text tower in f32) within 2e-3 of the plain co-attention's, and with
     `vlsa_img_encoder_use_feat_proj: True` 2 Adam steps from the store
     (finite losses, a bit-identical tower, moved parameters) whose last
     batch's gradients are within 2e-3 of CoattnPoolFull on the plain
     kernels; every launch on the query routes (forward and dQ "grid", dX
     "loop"); rows 1-6 at P=32 go to the kernels line with these launches;
  3n. vlsa_tpu's optimizers and adahessian's switch, while phase 3h's
     stores are there: every name of the factory (`OPT_NAMES`, lookahead_adam
     among them) 2 steps of the SA at 2560-256-12 in f32 from its own
     initial weights, each step one general forward and one backward
     launched, finite losses and parameters; adahessian 3 steps on the SA and
     3 on the flagship (phase 3b's batch, the text tower in f32), no kernel
     launched in a step (`ops.flags.disable_kernels`), the frozen tower
     untouched, the evaluation forward after them on the kernels; the
     Hessian diagonal's estimate for a fixed z, card (plain versions under
     the switch) against the port on the CPU, within 1e-3 of each leaf's
     largest element or 4x the CPU's own gap at 1e-7 weight noise; the
     Hessian estimate through the ABMIL kernels
     (outside the switch) raises;
     and 1 epoch of the flagship with `opt_name: adahessian` from phase 3h's
     bf16 .npy store through `vlsa_tpu_torch.main` with 3h's checks (the
     evaluation passes alone launch);
  3o. the rest of the MIL zoo, while phase 3h's stores are there: cluster
     files (8 clusters a patient) and each slide's 8-neighbour grid graph
     written beside the .npy store (one graph also as a stub
     torch_geometric .pt through `convert --graphs`, the same edges);
     TransMIL and ILRA (patch bags), DeepAttnMISL (cluster bags) and
     PatchGCN (graph bags) at net_dims 512-256-12, each 1 epoch through
     `vlsa_tpu_torch.main` (buckets up to 8,192, longer patients
     truncated), no kernel launched, finite metrics, the reloaded
     checkpoint's test probabilities bit for bit, then a served request and
     a step on 3 bags card against CPU f32 within 2e-3 (loss and each
     gradient); the epoch's seconds, slides/s, peak device memory and peak
     resident set, PatchGCN's edges, and PatchGCN's peak device memory in a
     step on a grid graph and with half its edges sent into 16 nodes (held
     within 1.05x); then the full-width flagship with
     TransMIL and ILRA image encoders, a request served and an Adam step
     from the store;
  3p. the CLF handler and the CLIP and HF text towers, while phase 3h's
     stores are there: label tables of fold 0's slides written by the
     script; DeepMIL/ABMIL 512-256-2 (Binary, CE) 1 epoch through
     `vlsa_tpu_torch.main --handler CLF` from the .npy f32 store (native
     batches, the exact f32 ABMIL launches, finite metrics, the reload bit
     for bit, each metric recomputed from the run's prediction CSVs equal to
     the reported one), 512-256-3 (Multi-class, LabelSmoothingCrossEntropy)
     served: the test split's pass (its metrics again from its CSV), and for
     both a request card against the port on the CPU within 1e-3 and the
     kernels of a profiled step or request by name and count; the flagship
     with `vlsa_api` CLIP and HF (a tokenizer directory written by
     `export_hf_clip_tokenizer` and a seeded CLIP-layout checkpoint,
     imported tensor for tensor), each a request card against CPU with the
     tower in f32 (1e-3), then 1 epoch from the bf16 .npy store (its bags
     truncated to 4,096 patches) through `main` with phase 3h's checks and
     a profiled step; prints each run's
     epoch seconds, peak device memory and launches, and the launches this
     phase adds to rows 1, 6, 7 and 8; the stores are then removed;
  3k. the SA baseline at 1024-d features: fold 0's 437 slides as bags of
     N~2048 jittered at D=1024 (a patient's bag up to 17,612 patches)
     written as a .npy f32 store, as phase 3h; cfg_sa_base_conch.yaml at
     net_dims 1024-256-12 for
     one epoch (f32 features; its .q8npz run was cut for the script's time: phase 3m
     runs int8) through the command line's entry,
     `vlsa_tpu_torch.main.main(["--config", <the config as YAML>,
     "--handler", "SA"])`, with 3h's checks (native batches, exact launches,
     every one on the general instances, finite metrics, test predictions
     within 1e-3 of the plain pooling's), the reloaded checkpoint's test
     probabilities bit for bit those of the model in memory, a served
     request of 8 bags within 1e-3 of the plain pooling and a training
     batch's parameter gradients within 2e-3 of the plain path's; the
     store is removed at the end;
  3m. the SA baseline at 2560-d features (Virchow, Virchow2): as 3k at
     net_dims 2560-256-12, bags of N~1024 jittered (cut from 3k's N~2048),
     a .npy f32 store and its .q8npz conversion, one epoch from each (f32,
     int8) through `main` with 3k's checks (3k and 3m also hold the batch
     pool's page-locked peak to at most prefetch + 2 times the run's
     largest batch, and print it beside the resident set), then one Adam
     step with
     `deepmil_use_feat_proj: True` from the f32 store (the general backward
     with dX at 2560) with its gradients against the plain path; the stores'
     bytes and each run's host memory peak are printed; the stores are
     removed at the end;
  4. times: CUDA events, median of 25 runs with the L2 cache flushed
     before each, for each kernel, its plain version and a PyTorch
     yardstick the port never calls (one scaled_dot_product_attention call;
     for dQ its gradient with respect to q), beside the least time the card
     could take (bound_ms); every forward variant also at B=64, one a
     storage at C=1024 (the wide instance), and dQ at the training shape
     B=32, N=16384, with kernel/bound, kernel/library and the backward's
     block count (`kernel_plan`); every forward and dQ variant also at P=32
     and 64 (B=8, the query groups on the grid), and what bounds each row at
     P=12 and at P=128 (printed); at
     every timed shape the kernels' results are first held against their
     plain versions with the tolerances above;
  4b. ABMIL times: the same for each ABMIL kernel and its plain version at
     B=8, N=10240 and at the training shape B=32, N=16384, at B=8 also at
     each other width of ABMIL_WIDTHS and at (2560, 256) and
     (1000, 384) (ABMIL_ANY_TIMED), and for precise bf16 (its plain version
     the model of its rounding), beside one cuBLAS
     x @ W1^T in the storage type (`gemm_ms`, a partial yardstick the port
     never calls: no single PyTorch call computes ABMIL pooling, so
     library_ms is null); f32's bound takes the lesser of its two routes to
     f32-accurate products, the CUDA cores or 3 TF32 tensor-core products;
     beside the bf16 and int8 backward, their design's byte floor (x read
     twice, the bf16 dz workspace -- int8: two planes -- written and read
     once); every storage also on the wide route (2g's) at B=8, N=2048,
     (10240, 256);
  4c. flash times: at B=64, H=12, bf16 at L = 197 and 785 on the resident
     and the streamed path in turns (resident, streamed, streamed,
     resident), bf16 at L = 1025 (streamed) and f32 at 785, each beside the
     plain version, one scaled_dot_product_attention call (library_ms,
     never called by the port), the bound (`bound_flash`, exponentials
     counted) and, for the streamed kernel, its design's floor
     (`floor_flash_streamed`: two sweeps over 64-row and 64-key tiles);
  4d. dX times: both variants of the full backward at B=8, N=10240 (also at
     P=32 and 64, the looped instance), at B=2, N=1024, P=20,000 (2g's route
     past 8,656 queries) and bf16
     at the training shape B=32, N=16384, with its block count, beside the
     plain version, the
     gradient of one scaled_dot_product_attention call with respect to q, k
     and v (library_ms, never called by the port) and the bound (`bound_dx`);
     then 2g's chunked forward and dQ in bf16 at B=2, N=64, C=8, P=1,048,592
     as phase 4 times them.  The kernels line lists 2g's routes with
     "on_main_path" false and their 2g launches as "held_launches".

Each phase's seconds are printed and recorded (`phase_seconds`).  The last
two lines are the kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": <n>}}.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPE = dict(B=8, N=10240, C=512, P=12)
SCALE = 30.0
TOL = {"f32": 1e-4, "bf16": 1e-3, "int8": 1e-3}
# phase 2 also holds the f32 forward within 2e-6 of the plain version: its
# split-TF32 products (~2^-21) meet that; bf16 hi + lo operands (~2^-16,
# 5.2e-6 on the card) would not
TOL_F32_FWD = 2e-6
# the forward's wide instance (C > 512, blocks by channel group) at VLFAN's
# default width
FWD_WIDE = dict(B=4, N=3000, C=1024)
# dq tolerances of scripts/validate_kernels_chip.py:87-95
TOL_DQ = {"f32": 1e-3, "bf16": 2e-3, "int8": 2e-3}
# phases 2b and 2e also hold the f32 backward (dq, dX) within these of the
# plain version: split TF32 (~2^-21 a product) meets them, bf16 hi + lo
# operands (~2^-16) would not
TOL_F32_BWD = {"dq": 2.5e-6, "dx": 4e-6}
TOL_GRAD = 2e-3  # parameter gradients, kernel path vs plain path
VARIANTS = ("f32", "f32_inv", "bf16", "bf16_inv", "int8", "int8_inv")
# the TPU kernel each variant replaces (vlsa_tpu/ops/coattn.py)
REPLACES = {
    "f32": "vlsa_tpu/ops/coattn.py:316 _coattn_fwd_kernel",
    "bf16": "vlsa_tpu/ops/coattn.py:316 _coattn_fwd_kernel",
    "f32_inv": "vlsa_tpu/ops/coattn.py:336 _coattn_fwd_kernel_i",
    "bf16_inv": "vlsa_tpu/ops/coattn.py:336 _coattn_fwd_kernel_i",
    "int8": "vlsa_tpu/ops/coattn.py:322 _coattn_fwd_kernel_q8",
    "int8_inv": "vlsa_tpu/ops/coattn.py:328 _coattn_fwd_kernel_q8i",
}
REPLACES_DQ = {
    "f32": "vlsa_tpu/ops/coattn.py:458 _coattn_bwd_dq_kernel",
    "bf16": "vlsa_tpu/ops/coattn.py:458 _coattn_bwd_dq_kernel",
    "f32_inv": "vlsa_tpu/ops/coattn.py:480 _coattn_bwd_dq_kernel_i",
    "bf16_inv": "vlsa_tpu/ops/coattn.py:480 _coattn_bwd_dq_kernel_i",
    "int8": "vlsa_tpu/ops/coattn.py:464 _coattn_bwd_dq_kernel_q8",
    "int8_inv": "vlsa_tpu/ops/coattn.py:472 _coattn_bwd_dq_kernel_q8i",
}
SOURCE = "vlsa_tpu_torch/ops/csrc/coattn_fwd.cu"
SOURCE_DQ = "vlsa_tpu_torch/ops/csrc/coattn_bwd_dq.cu"
# ABMIL (vlsa_tpu/ops/abmil.py): shapes, tolerances (max|a-b| / max|b|; f32
# and int8 those of scripts/validate_kernels_chip.py:93-94), sources and the
# TPU kernel each variant replaces
ABMIL_SHAPE = dict(B=8, N=10240)
ABMIL_TRAIN_SHAPE = dict(B=32, N=16384)
# f32 at an N that ends in a partial tile and, on the plan of any card of
# tens of SMs, a partial chunk (both checked at run time)
ABMIL_RAGGED = dict(B=5, N=12291)
ABMIL_STORAGES = ("f32", "bf16", "int8")
# the widths (D, hid) phases 2c and 4b hold and time: the resident
# instances' 512, 256 (CONCH) and, on the general instances, UNI or
# ResNet-50 at 1024 with the shipped 256, CTransPath at 768 with Ilse et
# al.'s 128, Prov-GigaPath at 1536 with CLAM's 512; precise bf16 (vlsa_tpu's
# VLSA_TPU_ABMIL_PRECISE=1) at ABMIL_PRECISE_WIDTHS, held against the plain
# f32 version at the bf16 limits and against its plain model: the forward
# (`abmil_fwd_rounded`, precise=True) within TOL_ABMIL_MODEL, the limit the
# int8 forward's model is held at; the backward against its exact model
# (`abmil_bwd_rounded`, exact=True: the kernel's operand roundings, then f64)
# by `abmil.bwd_model_gaps`: dX beyond its one rounding to bf16, and db1 and
# dw2 over the scale of their sums (`abmil_bwd_sum_scales`), within
# TOL_ABMIL_MODEL; dW1 within TOL_ABMIL_PRECISE_DW1 of max|dW1|: its f32 sums
# over the B*N = 81,920 rows on the tensor cores are themselves up to
# 3.0e-5 from the exact sums at D=1024, hid=256 on an H100 (the
# single-rounded model's 2.3e-3).  The single-rounded model must miss the
# dW1 and dX limits, so that they tell the two roundings apart.
ABMIL_WIDTHS = ((512, 256), (1024, 256), (768, 128), (1536, 512))
ABMIL_RAGGED_WIDTHS = ((512, 256), (1024, 256))
ABMIL_PRECISE_WIDTHS = ((512, 256), (1024, 256))
# every width the kernels take (W1 zero-padded to whole passes and
# slices, rows of any length and alignment): Virchow's 2560 with the shipped
# 256 and CLAM's 512, 4096 at 256 and 1024, widths that pad hid (384, 96,
# 32; 1024 at 1536) and D (1000, 100: int8 rows at both and bf16 rows at 100
# not 16-byte aligned), and 64-32, the width of phase 3u's resumed SA run
# (RESUME_SA_DIMS); held in 2c as ABMIL_WIDTHS are, ragged and precise at
# two of them, and timed in 4b at ABMIL_ANY_TIMED
ABMIL_ANY_WIDTHS = ((2560, 256), (2560, 512), (4096, 256), (4096, 1024), (1000, 384),
                    (768, 96), (100, 32), (1536, 1024), (64, 32))
ABMIL_ANY_RAGGED_WIDTHS = ((2560, 256), (1000, 384))
ABMIL_ANY_PRECISE_WIDTHS = ((2560, 256), (1000, 384))
ABMIL_ANY_TIMED = ((2560, 256), (1000, 384))
# `abmil_bf16_dz_accuracy` at ABMIL_DZ_WIDTHS: bf16 dW1 against an f64
# model of its rounding, the kernel's pass 2 within TOL_DW1_OWN_DZ of the sum
# over its own dz, and at most DZ_APART_FACTOR times as many dz entries as
# the plain version rounded apart from the model's; there the tensor cores'
# own accumulation over D had put dW1 2.6e-3 from its plain version at
# (4096, 1024), rounding 5.2 times as many apart
ABMIL_DZ_WIDTHS = ((4096, 1024), (2560, 512))
TOL_DW1_OWN_DZ = 5e-4
DZ_APART_FACTOR = 2
TOL_ABMIL_MODEL = 2e-5
TOL_ABMIL_PRECISE_DW1 = 5e-5
TOL_ABMIL = {"f32": 1e-4, "bf16": 1e-3, "int8": 1e-3}
TOL_ABMIL_DW = {"f32": 1e-3, "bf16": 2e-3, "int8": 2e-3}
TOL_ABMIL_DX = {"f32": 1e-3, "bf16": 1e-2}
SOURCE_ABMIL = "vlsa_tpu_torch/ops/csrc/abmil_fwd.cu"
SOURCE_ABMIL_BWD = "vlsa_tpu_torch/ops/csrc/abmil_bwd.cu"
REPLACES_ABMIL = {"f32": "vlsa_tpu/ops/abmil.py:122 _abmil_kernel",
                  "bf16": "vlsa_tpu/ops/abmil.py:122 _abmil_kernel",
                  "int8": "vlsa_tpu/ops/abmil.py:334 _abmil_q8_kernel"}
REPLACES_ABMIL_BWD = {"f32": "vlsa_tpu/ops/abmil.py:205 _abmil_bwd_kernel",
                      "bf16": "vlsa_tpu/ops/abmil.py:205 _abmil_bwd_kernel",
                      "int8": "vlsa_tpu/ops/abmil.py:419 _abmil_q8_bwd_kernel"}
TRAIN_SHAPE = dict(B=32, N=16384, C=512, P=12)
# the co-attention forward also at an N that ends in a partial tile, whose
# bags' tile ranges start and end inside the blocks' flat ranges
FWD_RAGGED = dict(B=5, N=12291)
# the full (dX) backward (vlsa_tpu/ops/coattn.py:345): its storages, source and
# tolerances (max|a-b| / max|b|; bf16 dX within one bf16 ulp at the scale of
# its largest element; the gap to true f32 that of
# scripts/validate_kernels_chip.py:91, coattn_bf16_dx)
DX_STORAGES = ("f32", "bf16")
SOURCE_DX = "vlsa_tpu_torch/ops/csrc/coattn_bwd_dx.cu"
REPLACES_DX = "vlsa_tpu/ops/coattn.py:345 _coattn_bwd_kernel"
TOL_DX_DQ = {"f32": 1e-3, "bf16": 2e-3}
TOL_DX_F32 = 1e-3
TOL_DX_TRUE_F32 = 2e-2
# the feature-projecter training steps: (feats_dtype, 1/||x|| shipped, steps)
FEAT_PROJ_STEPS = (("bfloat16", False, 1), ("float32", False, 1), ("int8", False, 1),
                   ("bfloat16", True, 1))
# flash self-attention (vlsa_tpu/models/vision_tower.py:312): the CONCH trunk's
# attention at extraction, 448-px input, patch 16, so L = 1 + 28^2; hd = 64
FLASH_SHAPE = dict(B=64, H=12, L=785)
# 801: just past the resident kernel's capacity; 1025: CONCH at 512 px
FLASH_LENGTHS = (785, 197, 1, 801, 1025)
FLASH_RESIDENT_LENGTHS = (785, 197)  # the resident kernel, forced (flash_plan takes streamed)
# the zero-query probe: q = 0, v = 1 gives exactly L * bf16(1/L) when P is
# normalised before it is rounded (an online softmax gives 1)
FLASH_PROBE_LENGTHS = (197, 785, 801, 1025)
TOL_FLASH_PROBE = 1e-6
FLASH_TIMED_LENGTHS = (197, 785, 1025)
FLASH_VARIANTS = ("bf16", "f32")
TOL_FLASH = {"f32": 1e-4, "bf16": 2e-3}
SOURCE_FLASH = "vlsa_tpu_torch/ops/csrc/flash_attn_fwd.cu"
REPLACES_FLASH = "vlsa_tpu/models/vision_tower.py:312 _flash_self_attention"
# extraction: CONCH at full width, 448 px, batch 64, over synthetic slides of
# 512x512 u8 tiles whose tile counts leave a ragged last batch
EXTRACT_TILES = (130, 140)
EXTRACT_TILE_PX = 512
# and at 512 px (L = 1 + 32^2 = 1025): one slide whose 100 tiles leave a
# ragged last batch (64 + 36)
EXTRACT_512_TILES = 100
TOL_FEATS = {"bf16": 2e-2, "f32": 1e-4}  # features, flash kernel vs plain attention
# phase 3q, the rest of extraction on EXTRACT_TILES: CLIP ViT-B/16 and the
# w8a8 CONCH trunk at 448 px (batch 64, bf16), CLIP's RN50 at 224 px (f32,
# OpenAI's build_model widths: layers (3, 4, 6, 3), width 64, 32 heads,
# output 1024) with its BatchNorm statistics drawn from a seed
RN50 = dict(layers=(3, 4, 6, 3), width=64, heads=32, output_dim=1024, input_resolution=224)
RN50_SEED = 50
RN50_CARD_BATCH = 2
TOL_RN50 = 1e-4  # RN50's output, the card against the CPU (TF32 off)
MIN_COSINE = 0.99  # w8a8 against the float tower, and CLIP's bf16 against its f32 batch
# the int32 exactness check of the trunk's largest int8 product (fc2's
# [B*L, 3072] x [3072, 768] at B=64, L=785), same-sign operands so the sums
# pass f32's 2^24
INT_MM_SHAPE = (64 * 785, 3072, 768)
# the kernels of a profiled extraction batch and of a feature-projecter step
# by kind (first match wins); GEMM_KERNELS names cuBLAS's and CUTLASS's GEMMs
GEMM_KERNELS = r"nvjet|gemm|xmma|cutlass|sm90_"
PROFILE_GROUPS = {"flash": r"flash_fwd", "gemm": GEMM_KERNELS,
                  "layer_norm": r"layer_norm", "gelu": r"Gelu",
                  "copy_cast": r"copy|index|cat|Cat", "elementwise": r"elementwise"}
# phase 3q's w8a8 batch: cuBLAS's int8 GEMMs apart from the float ones
Q8_PROFILE_GROUPS = {"flash": r"flash_fwd", "int8 gemm": r"s8|i8|imma|int8",
                     "gemm": GEMM_KERNELS, "reduce": r"reduce", "layer_norm": r"layer_norm",
                     "gelu": r"Gelu", "copy_cast": r"copy|index|cat|Cat",
                     "elementwise": r"elementwise"}
FEAT_PROJ_GROUPS = {"coattn": r"coattn", "gemm": GEMM_KERNELS,
                    "layer_norm": r"layer_norm|LayerNorm|GammaBeta",
                    "copy_cast": r"copy|index|cat|Cat", "elementwise": r"elementwise|reduce"}
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and operations/s by
# operand type (f32 outside the tensor cores, tf32 on them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12, "tf32": 495e12}
# the SFU's exponentials: 16 a clock per SM on 132 SMs, at the clock the f32
# peak implies (128 FMA lanes per SM: 67e12 / (132 * 256) = 1.98 GHz)
SM_COUNT = 132
SFU_PER_CLOCK_PER_SM = 16
EXP_PER_S = SFU_PER_CLOCK_PER_SM * SM_COUNT * PEAK_OPS["f32"] / (SM_COUNT * 256)


def bound_ms(nbytes, ops, storage):
    """(ms, what bounds) of work that moves `nbytes` and does `ops`
    operations on `storage` operands: max(bytes / HBM rate, operations /
    peak rate).  f32 products take the card's faster route to f32 accuracy:
    the CUDA cores (67 TFLOP/s) or 3 TF32 products each on the tensor cores
    (495 TFLOP/s), "operations (3xTF32)" when that route bounds."""
    t_bytes, t_ops, by_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[storage], "operations"
    if storage == "f32" and 3 * ops / PEAK_OPS["tf32"] < t_ops:
        t_ops, by_ops = 3 * ops / PEAK_OPS["tf32"], "operations (3xTF32)"
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else by_ops)
# the flagship served configuration: configs/IFMLE/tcga_blca/cfg_vlsa_conch.yaml
# with its grid lists resolved and the flagship's 12 ranks and 12 queries
FLAGSHIP_CFG = {
    "arch": "VLSA", "seed": 42, "dataset_name": "tcga_blca",
    "path_patch": "synthetic://N=8192,D=512,seed=7", "net_output_converter": "softmax",
    "vlsa_api": "CONCH", "vlsa_frozen_logit_scale": False,
    "vlsa_img_encoder_name": "VLFAN", "vlsa_img_encoder_dim_in": 512,
    "vlsa_img_encoder_dim_hid": 256, "vlsa_img_encoder_use_feat_proj": False,
    "vlsa_img_encoder_drop_rate": 0.25, "vlsa_img_encoder_pred_head": "default",
    "vlsa_img_encoder_query": "Text", "vlsa_img_encoder_num_query": 12,
    "vlsa_img_encoder_query_pooling": "mean", "vlsa_img_encoder_gated_query": False,
    "vlsa_img_encoder_query_text_method": "TaskRes",
    "vlsa_img_encoder_query_text_res_ratio": 0.5,
    "vlsa_img_encoder_query_text_dim_reduction": 4,
    "vlsa_img_encoder_query_text_keep_ratio": 0.8,
    "vlsa_img_encoder_query_text_load_path":
        "vlsa_tpu/assets/tools/survival_text_prototypes.json",
    "vlsa_img_encoder_query_text_load_idx": "tcga_blca_0",
    "vlsa_txt_encoder_name": "mahmoodlab/conch", "vlsa_txt_encoder_frozen": True,
    "vlsa_txt_encoder_dtype": "bfloat16",
    "vlsa_pmt_learner_name": "CoOp", "vlsa_pmt_learner_pretrained": False,
    "vlsa_pmt_learner_coop_method": "rank", "vlsa_pmt_learner_coop_num_ranks": 12,
    "vlsa_pmt_learner_coop_num_base_ranks": 4,
    "vlsa_pmt_learner_coop_num_tokens_per_rank": 4,
    "vlsa_pmt_learner_coop_num_context_tokens": 8,
    "vlsa_pmt_learner_coop_rank_tokens_position": "tail",
    "vlsa_pmt_learner_coop_init_prompt_path": "vlsa_tpu/assets/tools/survival_prompts.json",
    "vlsa_pmt_learner_coop_init_prompt_rank_idx": 0,
    "vlsa_pmt_learner_coop_init_prompt_context_idx": 0,
    "vlsa_pmt_learner_coop_rank_specific_context": False,
}
# the flagship's training surface (configs/IFMLE/tcga_blca/cfg_vlsa_conch.yaml):
# TCGA-BLCA labels and folds from the repository, synthetic CONCH-width bags
TRAIN_CFG = dict(
    FLAGSHIP_CFG, task="vlsa", data_mode="patch", feat_format="pt",
    path_table=os.path.join(ROOT, "assets/data_split/5foldcv/{0}/mahmoodlab_{0}_survival.csv"),
    data_split_path=os.path.join(ROOT, "assets/data_split/5foldcv/{0}/splits_{2}.csv"),
    data_split_seed=[0, 1, 2, 3, 4], time_format="interval", time_bins=None,
    vlsa_img_encoder_frozen=False, vlsa_pmt_learner_coop_num_ranks=None,
    vlsa_pmt_learner_coop_frozen_context_embeds=False,
    vlsa_pmt_learner_coop_frozen_rank_embeds=False,
    loss_type="SurvIFMLE-SurvEMD", loss_survifmle_weight=1.0, loss_survemd_weight=1.0,
    loss_survemd_p=2, opt_name="adam", opt_lr=2e-4, opt_weight_decay=1e-5,
    bp_every_batch=32, feats_dtype="bfloat16")
# the training steps: (feats_dtype, 1/||x|| shipped with the batch, steps)
TRAIN_STEPS = (("bfloat16", False, 1), ("float32", False, 1), ("float32", True, 1),
               ("bfloat16", True, 1), ("int8", False, 1), ("int8", True, 1))
LEARNABLE = ("prompt_learner.", "query_adapter.residual_features",
             "mil_encoder.visual_adapter.", "logit_scale")
# the served requests: (feats_dtype, host 1/||x||, number of requests)
SERVED = (("bfloat16", False, 2), ("int8", True, 2), ("float32", False, 1),
          ("float32", True, 1), ("bfloat16", True, 1), ("int8", False, 1))
BAGS_PER_REQUEST = 8
# the SA baseline: configs/IFMLE/tcga_blca/cfg_sa_base_conch.yaml as a dict
# (net_dims' last entry is corrected to the fold's bin count)
SA_CFG = {
    "task": "sa", "seed": 42, "dataset_name": "tcga_blca",
    "path_patch": "synthetic://N=8192,D=512,seed=7", "data_mode": "patch",
    "feat_format": "pt",
    "path_table": os.path.join(ROOT, "assets/data_split/5foldcv/{0}/mahmoodlab_{0}_survival.csv"),
    "data_split_path": os.path.join(ROOT, "assets/data_split/5foldcv/{0}/splits_{2}.csv"),
    "data_split_seed": [0, 1, 2, 3, 4], "time_format": "interval", "time_bins": None,
    "arch": "DeepMIL", "net_output_converter": "softmax", "net_dims": "512-256-4",
    "deepmil_network": "ABMIL", "deepmil_pooling": "attention",
    "deepmil_use_feat_proj": False, "deepmil_drop_rate": 0.25,
    "loss_type": "SurvIFMLE", "loss_survifmle_weight": 1.0, "evaluator": "NLL-IF",
    "opt_name": "adam", "opt_lr": 2e-4, "opt_weight_decay": 1e-5, "bp_every_batch": 32,
}
# SA requests (feats_dtype, number of requests) and training steps
# (feats_dtype, deepmil_use_feat_proj, steps)
SA_SERVED = (("bfloat16", 3), ("int8", 3), ("float32", 1))
SA_TRAIN_STEPS = (("bfloat16", False, 1), ("float32", False, 1), ("int8", False, 1),
                  ("bfloat16", True, 1), ("float32", True, 1))
# the run lifecycle (phase 3g): the shipped configs' run keys as scalars,
# fold 0 (no grid), save_path a temporary directory; the epochs are the only
# cut (the configs ask for 10)
LIFECYCLE_RUN = dict(
    save_prediction=True, eval_training_loader_per_epoch=False, ckpt_for_eval="last",
    num_shot=-1, data_split_seed=0, path_coord=None, path_cluster=None, path_graph=None,
    init_wt=False, batch_size=1, es=False, es_patience=20, es_warmup=0, es_verbose=True,
    es_start_epoch=0, monitor_metrics="loss", lrs=False, lrs_factor=0.5, lrs_patience=10,
    test=False)
LIFECYCLE_VLSA_CFG = dict(TRAIN_CFG, **LIFECYCLE_RUN, evaluator="VL-IF",
                          model_saver_module_filter="prompt_encoder", epochs=1)
LIFECYCLE_SA_CFG = dict(SA_CFG, **LIFECYCLE_RUN, epochs=1)
LIFECYCLE_REDUCED = {"vlsa": {"epochs": "10 -> 1"},
                     "sa": {"epochs": "10 -> 1",
                            "bag N": "~8192 -> ~1024 (for the script's time: ~4096 until "
                                     "phase 3o came; phase 3h's SA runs read N~8192 from "
                                     "the store)"}}
# phase 3g's SA run draws its synthetic bags at an eighth of the flagship's
# length, which phase 3h's store keeps
LIFECYCLE_SA_BAGS = "synthetic://N=1024,D=512,seed=7"
# the metrics each epoch's and the final evaluation must give, finite
LIFECYCLE_METRICS = ("c_index", "loss", "loss_mle", "IBS", "MAE", "D_calibration", "c_index2",
                     "loss_SurvIFMLE")
TOL_LIFECYCLE_PROBS = 1e-3  # test probabilities, kernel path vs plain (phase 3's limit)
PAIR_GAP = 2e-3  # comparable pairs closer than this in the plain path may change order
# the run lifecycle from feature stores (phase 3h): fold 0's slides hold the
# bags of phase 3g, written as a .npy f32 store and converted to .q8npz by
# `python -m vlsa_tpu_torch.data.convert --dtype int8`; each run 1 epoch of
# the shipped configs (as phase 3g) from a store: (name, config, store,
# changes, the kernels' variant)
STORE_BAGS = "synthetic://N=8192,D=512,seed=7"
# a slide's bytes in both stores, at the mean bag (8192 patches of 512:
# f32, and int8 with two f32 sidecars); the free disk needed is that times
# the slides times STORE_MARGIN
STORE_SLIDE_BYTES = 8192 * (512 * 4 + 512 + 8)
STORE_MARGIN = 1.25
STORE_RUNS = (
    ("vlsa_bf16_npy", LIFECYCLE_VLSA_CFG, "npy", dict(feats_dtype="bfloat16"), "bf16"),
    ("vlsa_int8_q8npz", LIFECYCLE_VLSA_CFG, "q8npz",
     dict(feats_dtype="int8", feats_precompute_inv=True), "int8_inv"),
    ("sa_f32_npy", LIFECYCLE_SA_CFG, "npy", {}, "f32"),
    ("vlsa_fewshot_bf16_npy", LIFECYCLE_VLSA_CFG, "npy",
     dict(feats_dtype="bfloat16", num_shot=4), "bf16"),
    ("sa_cox_origin_f32_npy", LIFECYCLE_SA_CFG, "npy",
     dict(loss_type="SurvPLE", time_format="origin", evaluator="Cox",
          net_output_converter=None, net_dims="512-256-1"), "f32"),
)
STORE_REDUCED = {"epochs": "10 -> 1"}
# phase 3k: the SA baseline at 1024-d features (UNI, ResNet-50 truncated,
# CLIP-RN50): cfg_sa_base_conch.yaml with net_dims 1024-256-K (K corrected
# to fold 0's 12 bins), fold 0's 437 slides as bags of N~2048 jittered at
# D=1024 (a patient's slides together up to 17,612 patches, one batch at a
# bucket of 32,768; cut from N~4096 for the script's time), a .npy f32
# store converted to .q8npz as phase 3h's; one epoch from each, with 3h's checks,
# the reload bit for bit, one served request and a step's gradients
# against the plain path: the general ABMIL instances, rows 7-10
SA1024_BAGS = "synthetic://N=2048,D=1024,seed=7"
SA1024_SLIDE_BYTES = 2048 * (1024 * 4 + 1024 + 8)
SA1024_CFG = dict(LIFECYCLE_SA_CFG, net_dims="1024-256-4")
# cut to its f32 run for the script's time (phase 3m runs int8 on the
# general instances at 2560-d): the store is not converted
SA1024_RUNS = (
    ("sa1024_f32_npy", SA1024_CFG, "npy", {}, "f32"),
)
SA1024_REDUCED = {"runs": "f32 .npy and int8 .q8npz -> f32 .npy (phase 3m runs int8)",
                  "bag N": "~4096 -> ~2048 for the script's time"}
# phase 3m: the SA baseline at 2560-d features (Virchow and Virchow2 tile
# embeddings: the 1280-d class token beside the 1280-d mean patch token):
# cfg_sa_base_conch.yaml with net_dims 2560-256-K (K corrected to fold 0's 12
# bins), fold 0's 437 slides as bags of N~1024 jittered at D=2560 (cut from
# N~2048 for the script's time; a 2560-d f32 slide at N~4096 is ~42 MB, the
# store 18 GB),
# a .npy f32 store and its .q8npz conversion; one epoch from each through
# `main`, with phase 3k's checks (the reload bit for bit, a served request and
# a step's gradients against the plain path), then one Adam step with
# `deepmil_use_feat_proj: True` from the f32 store (the general backward
# with dX at 2560, a projecter of 2560 -> 2560) whose gradients are held
# against the plain path: the general instances of rows 7-10 at 2560, 256
SA2560_BAGS = "synthetic://N=1024,D=2560,seed=7"
SA2560_SLIDE_BYTES = 1024 * (2560 * 4 + 2560 + 8)
SA2560_CFG = dict(LIFECYCLE_SA_CFG, net_dims="2560-256-4")
SA2560_RUNS = (
    ("sa2560_f32_npy", SA2560_CFG, "npy", {}, "f32"),
    ("sa2560_int8_q8npz", SA2560_CFG, "q8npz", dict(feats_dtype="int8"), "int8"),
)
SA2560_REDUCED = {"epochs": "10 -> 1",
                  "bag N": "~4096 -> ~1024: a 2560-d f32 slide at N~4096 is ~42 MB; "
                           "~2048 until the script's time needed the cut"}
# phase 3n: vlsa_tpu's optimizers and adahessian's switch.  Every name of the
# factory (and lookahead_adam) 2 steps of the SA at 2560-256-12, f32, on the
# kernels; adahessian 3 steps of the flagship on phase 3b's batch (f32 text
# tower) and of the SA at 2560, no kernel launched in a step and the
# evaluation pass after it on the kernels; the Hessian diagonal's estimate,
# for a fixed z and the same weights in eval mode, card (the plain versions
# under the switch) against the port on the CPU on OPT_HESSIAN_BAGS bags,
# within TOL_HESSIAN of each leaf's largest element or HESSIAN_NOISE_FACTOR
# times the CPU's own gap at f32-rounding weight noise; a double backward
# through the kernels raises; and 1 epoch of the flagship with opt_name
# adahessian from phase 3h's bf16 .npy store through `main`
OPT_NAMES = ("adam", "adamw", "sgd", "nesterov", "momentum", "nadam", "radam", "adadelta",
             "adafactor", "novograd", "nvnovograd", "rmsprop", "rmsproptf", "adamp", "sgdp",
             "adahessian", "lookahead_adam")
OPT_STEPS = 2
OPT_SA_BAGS = "synthetic://N=2048,D=2560,seed=11"
OPT_BATCH = 8  # patients a batch of the optimizer steps
ADAHESSIAN_STEPS = 3
OPT_HESSIAN_BAGS = 4
TOL_HESSIAN = 1e-3
HESSIAN_NOISE_FACTOR = 4
ADAHESSIAN_RUN = ("vlsa_adahessian_bf16_npy", LIFECYCLE_VLSA_CFG, "npy",
                  dict(feats_dtype="bfloat16", opt_name="adahessian"), "bf16")
# phase 3o: the rest of the MIL zoo (the paper's SA baselines), each at
# net_dims 512-256-K (K corrected to fold 0's 12 bins) 1 epoch from phase
# 3h's .npy store (bags of N~8192, buckets up to 8,192: `max_bucket`, the
# longer patients truncated, `bag_overflow: truncate`) through `main`:
# TransMIL and ILRA on patch bags, DeepAttnMISL on cluster bags
# (ZOO_CLUSTERS clusters a patient), PatchGCN on graph bags (each slide's
# 8-neighbour grid); no kernel (torch ops, as vlsa_tpu's XLA ops); then a
# served request and a step on ZOO_CPU_BAGS bags card against CPU f32
# within TOL_GRAD, each leaf's gradient against max(its largest element,
# ZOO_GRAD_FLOOR x the model's largest gradient); and the flagship with
# TransMIL and ILRA encoders served and trained a step
ZOO_CLUSTERS = 8
ZOO_NETWORKS = (("TransMIL", "patch", {}), ("ILRA", "patch", {}),
                ("DeepAttnMISL", "cluster", {"deepmil_num_clusters": ZOO_CLUSTERS}),
                ("PatchGCN", "graph", {}))
ZOO_CFG = dict(LIFECYCLE_SA_CFG, net_dims="512-256-4", max_bucket=8192,
               bag_overflow="truncate")
ZOO_CPU_BAGS = 3
ZOO_GRAD_FLOOR = 1e-2
ZOO_VLSA_ENCODERS = ("TransMIL", "ILRA")
# PatchGCN's memory against the in-degree: a training step on ZOO_SKEW_BAGS
# bags of the largest bucket, once on each bag's grid graph and once with
# the same edges, half of them sent into ZOO_SKEW_HUBS nodes; the edge lists'
# memory follows E, so the hub graph's peak stays within ZOO_SKEW_RATIO of
# the grid's
ZOO_SKEW_BAGS = 8
ZOO_SKEW_HUBS = 16
ZOO_SKEW_RATIO = 1.05
ZOO_REDUCED = {"epochs": "10 -> 1",
               "bag N": "patients past 8,192 patches truncated to 8,192 (16,384 until the "
                        "script's time asked for less; TransMIL and PatchGCN at a bucket of "
                        "131,072 would not fit)"}
# phase 3p: the CLF handler (slide classification, runner/clf.py) and VLSA on
# the CLIP and HF text towers, while phase 3h's stores are there.  CLF: one
# bag a slide of fold 0 from 3h's .npy f32 store, labels written by the script
# (drawn a patient from CLF_LABEL_SEED), DeepMIL/ABMIL at 512-256-2 (Binary,
# CE) 1 epoch through `main --handler CLF`, and at 512-256-3 (Multi-class,
# LabelSmoothingCrossEntropy) served only: the test split's pass and a
# request.  VLSA: the flagship config with `vlsa_api` CLIP (the bundled BPE)
# and HF (a tokenizer directory written by the port's
# export_hf_clip_tokenizer, a CLIP-layout checkpoint of the tower at its
# published width, random from CLIP_TEXT_SEED, beside it), each served a
# request (card against the port on the CPU, the text tower in f32 on both)
# and trained 1 epoch from 3h's bf16 .npy store through `main`
CLF_CFG = dict(LIFECYCLE_RUN, task="clf", seed=42, dataset_name="tcga_blca",
               data_mode="patch", feat_format="npy", arch="DeepMIL", net_dims="512-256-2",
               net_output_converter="softmax", deepmil_network="ABMIL",
               deepmil_pooling="attention", deepmil_use_feat_proj=False,
               deepmil_drop_rate=0.25, loss_type="CE", loss_ce_smoothing=0.1,
               evaluator="Binary", opt_name="adam", opt_lr=2e-4, opt_weight_decay=1e-5,
               bp_every_batch=32, epochs=1)
CLF_MULTI = dict(net_dims="512-256-3", evaluator="Multi-class",
                 loss_type="LabelSmoothingCrossEntropy",
                 loss_labelsmoothingcrossentropy_smoothing=0.1)
CLF_LABEL_SEED = 20
CLIP_TEXT_SEED = 21
PROFILE_TRIES = 3  # profiled steps a run, until a trace names every kernel expected
CLIP_LOGIT_SCALE = 4.5  # near log(100), CLIP's trained scale; exact in f32
TEXT_APIS = ("CLIP", "HF")
# the CLIP and HF epochs read 3h's bags truncated to this many patches (3p
# holds the text towers; 3h the bags' lengths), for the script's time
TEXT_API_BUCKET = 4096
TEXT_API_REDUCED = {"epochs": "10 -> 1", "bag N": "3h's bags (N~8192) truncated to 4,096"}
CLF_REDUCED = {"epochs": "10 -> 1", "labels": "synthetic, drawn a patient",
               "runs": "Multi-class served only (its pass over the test split and a request)"}
RSS_SAMPLE_S = 0.05  # the resident set's sampling period within a run
# the share of the host's memory (MemTotal) a run of phases 3k and 3m may
# peak at: an f32 epoch of the SA at 2560-d peaked at 70.6 GiB (62 GiB of it
# page-locked batches) of a 96 GiB host, an open fault (ROADMAP.md §C)
HOST_RSS_SHARE = 0.8
# phase 3i: the released CONCH weights and zero-shot.  A CONCH-format
# checkpoint (a CoCa state dict, the text tower under `text.*`) at the
# published text tower's full width, random from ZS_SEED, with `visual.*`
# and `text_decoder.*` decoys; its logit scale ZS_LOGIT_SCALE
ZS_TOWER = dict(width=768, layers=12, vocab=32007, context=128, output=512)
ZS_LOGIT_SCALE = 4.0
ZS_SEED = 14
# the shipped zero-shot config, fold 0 (its grid: the three poolings), run
# from phase 3h's stores: (store, feats_dtype)
ZS_CONFIG = "configs/IFMLE/tcga_blca/cfg_zero_shot_conch.yaml"
ZS_POOLINGS = ("logit_top10", "logit_max", "logit_mean")
ZS_STORES = (("npy", "bfloat16"), ("q8npz", "int8"))
TOL_ZS_PROBS = 1e-3  # test probabilities, the card against the port on the CPU
# the text prototypes of the tower computing in f32, card against CPU (the
# same f32 arithmetic summed in another order; in bf16, where each
# matmul's operands are rounded, such differences flip roundings layer
# after layer: that gap is printed)
TOL_ZS_TEXT_F32 = 1e-4
# the flagship (phase 3h's bf16 .npy run) with that tower and a CoOp learner
# warm-started from a reference-format checkpoint, `coop-fold{seed}-{method}`
ZS_COOP_CKPT = "coop-fold{}-{}.pth"


# phase 3j: interpretation.  Phase 3h's flagship run (bf16 from .npy) is
# reloaded from its directory; the cohort is fold 0's 75 test patients at
# vlsa_tpu's interpret_cohort batch of 16, always in f32 (a .q8npz store
# dequantized on the host); tolerances max|a-b| / max|b|
INTERP_RUN = "vlsa_bf16_npy"
INTERP_BATCH = 16
INTERP_STORES = ("npy", "q8npz")
INTERP_KEYS = ("decoupled_similarity", "shap_importance", "probs")
TOL_INTERP_RELOAD = 1e-6  # logits, the reloaded model against the one 3h trained
# the cohort, the f32 kernel against the plain pooling (phase 2 holds row 1
# f32, split TF32, at 2e-6)
TOL_INTERP_PLAIN = 1e-5
# the first batch, card against the port on the CPU from the card's text
# prototypes (the bf16 tower's card-CPU gap, 2.68e-3 in phase 3i, must not
# decide it)
TOL_INTERP_CPU = 1e-4
TOL_INTERP_F64 = 1e-5  # Shapley values against a float64 enumeration, of max|phi|
INTERP_F64_PATIENTS = 4
TOL_INTERP_EFFICIENCY = 1e-4  # |sum phi - (v(all) - 1)| <= this * max(1, |v(all)|)
TOL_INTERP_SUM = 1e-5  # probabilities and attention rows summing to 1
INTERP_PAD = 1024  # the single bags: a stored bag padded by this many masked rows
# the ROADMAP §A.10 modules at full width: 1-epoch runs from phase 3h's
# stores (as STORE_RUNS), the kernels' variant (None: the pooling launches
# none) and the parameters of the new pooling that must move
A10_RUNS = (
    ("sa_gated_f32_npy", LIFECYCLE_SA_CFG, "npy", dict(deepmil_pooling="gated_attention"),
     None, ("sigma.fc1.weight", "sigma.score.weight", "sigma.fc2.weight")),
    ("vlsa_attention_pool_bf16_npy", LIFECYCLE_VLSA_CFG, "npy",
     dict(feats_dtype="bfloat16", vlsa_img_encoder_query_pooling="attention"), "bf16",
     ("mil_encoder.query_pool.fc1_kernel", "mil_encoder.query_pool.fc2_kernel")),
)

# the co-attention kernels above 16 queries (ceil(P / 16) query groups of 16
# rows, the last zero-padded): phase 2f holds rows 1-6 at QUERY_COUNTS at
# SHAPE's B, N and C and at QUERY_WIDE (the wide instances) against their
# plain versions (forward TOL, dQ TOL_DQ, dX TOL_DX_DQ and one bf16 ulp; f32
# at TOL_F32_FWD and TOL_F32_BWD against the exact function, the plain
# version in float64: above 16 rows its f32 run is itself 2e-6-3.7e-6 from
# exact), phases 4 and 4d time them at QUERY_TIMED, and phase 4 logs each
# bound at QUERY_BOUND_P
QUERY_COUNTS = (17, 32, 64, 128)
QUERY_WIDE = dict(B=8, N=10240, C=1024, P=32)
QUERY_TIMED = (32, 64)
QUERY_BOUND_P = 128
# phase 2g: the routes past the old limits.  ABMIL past D = 8192 (the "wide"
# route: the forward's PV sums and the backward's g in device memory) and
# past hid = 1024 (more passes, each with its b1 and w2); the looped dX past
# 8,656 queries (each group's stats staged as it comes, the dq partials'
# blocks capped); the forward and dQ past 65,535 query groups (launched a
# chunk of groups at a time).  Phases 4b and 4d time one entry of each
# (ANY_WIDTH_TIMED_4B, LOOP_TIMED_4D, GRID_TIMED_4D)
ANY_WIDTHS_2G = ((10240, 256), (512, 1536), (9000, 1100))
ANY_WIDTH_TIMED_4B = dict(B=8, N=2048, D=10240, H=256)
LOOP_TIMED_4D = dict(B=2, N=1024, C=512, P=20000)
GRID_TIMED_4D = dict(B=2, N=64, C=8, P=1_048_576 + 16)  # bag 1 empty (make_inputs)
GRID_TIMED_VARIANT = "bf16"
ANY_WIDTH_SHAPE_2G = dict(B=2, N=2048)
LOOP_QUERIES_2G = (8657, 20000)
LOOP_SHAPE_2G = dict(B=2, N=1024, C=512)
GRID_QUERIES_2G = 1_048_576 + 16
GRID_SHAPE_2G = dict(B=1, N=64, C=8)
# f32 dq on the chunked route (C = 8, 65,537 groups) against the exact
# function: 2f's f32 dX limit.  An H100 read 2.78e-6 there, past 2f's dq
# limit of 2.5e-6: its largest gap over 8.4 million entries, of 8 channels
# each; a product on operands rounded once to TF32 reads far past this
# limit, and phase 2g fails if it does not
TOL_F32_DQ_CHUNKED = TOL_F32_BWD["dx"]
# phase 3l: the flagship (configs/IFMLE/tcga_blca/cfg_vlsa_conch.yaml) with
# 32 learned, gated VLFAN queries (33 parameter rows, folded to P = 32 by
# `effective_query`): served (requests as phase 3's: (feats_dtype, host
# 1/||x||, count)), trained 1 epoch from phase 3h's bf16 .npy store through
# `python -m vlsa_tpu_torch.main` (QUERIES_RUN, as STORE_RUNS), and with the
# feature projecter QUERIES_FEAT_PROJ_STEPS steps from the same store.  The
# kernels (and variants) those paths launch: the kernels line's P=32 rows
# that must show launches
GATED_QUERIES = dict(vlsa_img_encoder_query="Parameter", vlsa_img_encoder_num_query=32,
                     vlsa_img_encoder_gated_query=True)
QUERIES_SERVED = (("bfloat16", False, 2), ("int8", True, 2))
QUERIES_RUN = ("vlsa_q32_bf16_npy", LIFECYCLE_VLSA_CFG, "npy",
               dict(feats_dtype="bfloat16", **GATED_QUERIES), "bf16")
QUERIES_FEAT_PROJ_STEPS = 2
QUERIES_PATH_KERNELS = {("fwd", "bf16"), ("fwd", "int8_inv"), ("dq", "bf16"), ("dx", "bf16")}
# phase 3r: CoCa captions (ROADMAP §A.16) at CONCH's full width from a seed:
# the visual model as extraction builds it (448 px, bf16 trunk on row 11),
# the published CONCH text tower and MultimodalDecoder (768, 12 heads, 12
# layers, context 128, vocabulary 32007) in f32, TF32 off; CAPTION_TILES of
# 3e's random 512-px u8 tiles (seed 0) through the device preprocess; each
# path of CAPTION_PATHS at seq_len 30, min_seq_len 5.  Caption tokens held
# against the plain attention at TOL_FEATS["bf16"]; every path's final
# buffers re-scored on the CPU with the same modules (one teacher-forced
# step), the card's logits at the generated positions within
# TOL_CAPTION_LOGITS (max|a-b| / max|b|)
CAPTION_SEED = 22
CAPTION_TILES = 4
CAPTION_SEQ_LEN, CAPTION_MIN_SEQ_LEN = 30, 5
CAPTION_PATHS = {"beam": {},
                 "greedy": dict(generation_type="top_k", top_k=1, repetition_penalty=1.3),
                 "top_p": dict(generation_type="top_p", top_p=0.1, seed=0)}
TOL_CAPTION_LOGITS = 1e-4
CAPTION_STEP_RUNS = 5
CAPTION_GROUPS = {"gemm": GEMM_KERNELS, "softmax": r"softmax", "layer_norm": r"layer_norm",
                  "gelu": r"Gelu", "copy_cast": r"copy|index|cat|Cat",
                  "elementwise": r"elementwise|reduce"}
# phase 3s: INTERP_RUN's trained model written as vlsa_tpu writes a run's
# checkpoint (flax's msgpack layout) into a copy of its run directory
FLAX_RUN = INTERP_RUN + "_flax"
# phase 3u: resuming vlsa_tpu's runs.  The committed fixtures
# (tests/test_torch_orbax.py::make_fixtures): a DeepMIL/ABMIL run at
# RESUME_SA_DIMS with Adam's optax state after 3 steps, saved at epoch 1 in
# vlsa_tpu's msgpack and orbax backends, and a tree of bf16, int8 and f32
# leaves in both; the SA run resumed for its second epoch on fold 0 with
# bags of RESUME_SA_BAGS.  Then INTERP_RUN with its Adam state in optax's
# tree (RESUMED_RUN), resumed for one epoch beside the same run resumed
# from the port's torch checkpoint
RESUME_FIXTURES = os.path.join(ROOT, "vlsa_tpu_torch", "assets", "checkpoints")
RESUME_SA_DIMS = "64-32-12"
RESUME_SA_BAGS = "synthetic://N=1024,D=64,seed=7"
RESUMED_RUN = FLAX_RUN + "_optax"
ZSTD_REPEATS = 5  # passes over the fixtures' zstd frames, for the decoder's MB/s


class SmokeFailure(Exception):
    pass


# phase 3t's ranks but rank 0 log nothing (their failures are still gathered)
QUIET = False


def log(msg: str) -> None:
    if not QUIET:
        print(f"[chip_smoke] {msg}", flush=True)


# phase 3t's ranks gather their failures here instead of raising them: a rank
# that stopped short of a collective would leave its peers waiting in it
DEFERRED: Optional[list] = None


def check(cond: bool, msg: str) -> None:
    if not cond:
        if DEFERRED is not None:
            DEFERRED.append(msg)
            return
        raise SmokeFailure(msg)


def storage_of(variant: str) -> str:
    return variant.split("_")[0]


def hold(what: str, got, ref, tol: float) -> dict:
    """Hold a kernel's result against its plain version on the same inputs:
    fails on a non-finite value or where max|a-b| / max|b| exceeds tol."""
    diff = (got - ref).abs().max().item()
    rel = diff / max(ref.abs().max().item(), 1e-30)
    log(f"{what}: max|k-p| {diff:.3e}  rel {rel:.3e}  (tol {tol:g})")
    check(bool(got.isfinite().all()), f"{what}: non-finite kernel result")
    check(rel <= tol, f"{what}: the kernel deviates {rel:.3e} from its plain version")
    return {"max_abs_err": diff, "rel_err": rel}


# ---------------------------------------------------------------- phase 2

def make_inputs(torch, B, N, C, P, variant, seed=0, device="cuda", keep_masked=False):
    """Random queries and bags on the card: 10% of patches masked and the
    last bag empty, their rows zero unless `keep_masked` (a feature
    projecter's output has features there); int8 is quantized per patch,
    and `_inv` variants carry 1/||x|| of the stored rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(P, C, generator=g, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    x = torch.randn(B, N, C, generator=g, device=device)
    mask = torch.rand(B, N, generator=g, device=device) > 0.1
    mask[-1] = False
    if not keep_masked:
        x = x * mask[..., None]
    x_scale = x_inv = None
    storage = storage_of(variant)
    if storage == "int8":
        amax = x.abs().amax(-1) / 127.0
        x = torch.clamp(torch.round(x / torch.where(amax > 0, amax, 1.0)[..., None]),
                        -127, 127).to(torch.int8)
        x_scale = amax.contiguous()
    elif storage == "bf16":
        x = x.to(torch.bfloat16)
    if variant.endswith("_inv"):
        sq = (x.float() ** 2).sum(-1)
        x_inv = torch.where(sq > 0, sq.rsqrt(), torch.zeros_like(sq)).contiguous()
    return q, x.contiguous(), mask.contiguous(), x_scale, x_inv


def phase_kernel(torch, co):
    from vlsa_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build("coattn_fwd", "coattn_bwd_dq", "coattn_bwd_dx", "abmil_fwd", "abmil_bwd",
                 "flash_attn_fwd")
    log(f"built coattn_fwd, coattn_bwd_dq, coattn_bwd_dx, abmil_fwd, abmil_bwd and "
        f"flash_attn_fwd in {time.perf_counter() - t0:.1f} s; nvcc seconds each "
        f"{ {k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()} }")
    for name, build_log in _build.BUILD_LOGS.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill stores" in line:
                log(f"  ptxas {name}: " + line.strip())
    errs = {}
    shapes = [(SHAPE["B"], SHAPE["N"], SHAPE["C"], "")] * len(VARIANTS) \
        + [(FWD_RAGGED["B"], FWD_RAGGED["N"], SHAPE["C"], "_ragged")] * len(VARIANTS) \
        + [(FWD_WIDE["B"], FWD_WIDE["N"], FWD_WIDE["C"], "_wide")] * len(VARIANTS)
    for (B, N, C, suffix), v in zip(shapes, VARIANTS * 3):
        q, x, mask, xs, xi = make_inputs(torch, B, N, C, SHAPE["P"], variant=v)
        paths = dict(co.LAUNCHES_FWD_PATH)
        out, m, l = co.coattn_fwd(q, x, mask, SCALE, xs, xi)
        torch.cuda.synchronize()
        path = "wide" if C > 512 else "group"
        check(co.LAUNCHES_FWD_PATH == dict(paths, **{path: paths[path] + 1}),
              f"{v} at C={C}: the forward's instance counts {co.LAUNCHES_FWD_PATH}, not one "
              f"more {path} launch than {paths}")
        ref = co.coattn_pool_reference(q, x, mask, SCALE, xs)
        diff = (out - ref).abs().max().item()
        rel = diff / max(ref.abs().max().item(), 1e-30)
        # the kernel against the plain model of its own rounding (q and the
        # weights as bf16 hi + lo; f32 in split TF32), beside its gap to true f32
        model = co.coattn_fwd_rounded(q, x, mask, SCALE, xs, xi)[0]
        rel_model = rel_err(out, model)
        # f32: also its gap to the exact function (the plain version in float64)
        exact = ""
        if storage_of(v) == "f32":
            ref64 = co.coattn_pool_reference(q, x, mask, SCALE, xs, dtype=torch.float64)
            exact = f"  vs exact {rel_err(out, ref64):.3e}"
            del ref64
        empty = out[-1].abs().max().item()
        empty_stats = bool(torch.all(m[-1] == -1e30)) and bool(torch.all(l[-1] == 1e-30))
        tol = TOL_F32_FWD if storage_of(v) == "f32" else TOL[storage_of(v)]
        log(f"kernel {v:9s} B={B} N={N} C={C} ({path}) max|k-p| {diff:.3e}  rel {rel:.3e}  "
            f"(tol {tol:g})  vs its rounding model {rel_model:.3e}{exact}  empty bag {empty:g}"
            f"  finite m,l {bool(torch.isfinite(m).all())}")
        check(bool(torch.isfinite(out).all()), f"{v}: non-finite kernel output")
        check(rel <= tol, f"{v} at C={C}: kernel deviates {rel:.3e} from its plain version")
        check(empty == 0.0 and empty_stats, f"{v}: the empty bag pooled to {empty}, stats "
                                            f"{m[-1].tolist()}, {l[-1].tolist()}")
        errs[v + suffix] = {"max_abs_err": diff, "rel_err": rel, "model_rel_err": rel_model}
        del q, x, mask, xs, xi, out, ref, model
    return errs


# ---------------------------------------------------------------- phase 2b

def make_cotangent(torch, B, P, C, seed=2, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(B, P, C, generator=g, device=device)


def phase_backward_kernel(torch, co):
    """Each dQ variant at SHAPE and, for the wide instance, at C=1024; f32
    within TOL_F32_BWD."""
    errs = {}
    for (B, N, C), suffix in (((SHAPE["B"], SHAPE["N"], SHAPE["C"]), ""),
                              ((FWD_WIDE["B"], FWD_WIDE["N"], FWD_WIDE["C"]), "_wide")):
        for v in VARIANTS:
            q, x, mask, xs, xi = make_inputs(torch, B, N, C, SHAPE["P"], variant=v)
            out, m, l = co.coattn_fwd(q, x, mask, SCALE, xs, xi)
            g = make_cotangent(torch, B, SHAPE["P"], C)
            paths = dict(co.LAUNCHES_BWD_PATH)
            dq = co.coattn_bwd_dq(q, x, mask, SCALE, g, out, m, l, xs, xi)
            torch.cuda.synchronize()
            path = "wide" if C > 512 else "group"
            check(co.LAUNCHES_BWD_PATH == dict(paths, **{path: paths[path] + 1}),
                  f"dq {v} at C={C}: the backward's instance counts {co.LAUNCHES_BWD_PATH}, "
                  f"not one more {path} launch than {paths}")
            tol = TOL_F32_BWD["dq"] if storage_of(v) == "f32" else TOL_DQ[storage_of(v)]
            errs[v + suffix] = hold(f"dq kernel {v} B={B} N={N} C={C} ({path})", dq,
                                    co.coattn_bwd_dq_reference(q, x, mask, SCALE, g, out, m, l,
                                                               xs, xi), tol)
            del q, x, mask, xs, xi, out, m, l, g, dq
    return errs


# ---------------------------------------------------------------- phase 2c

def make_abmil_inputs(torch, B, N, storage, seed=0, device="cuda", D=512, H=256):
    """ABMIL inputs on the card at D, hid=H: 10% of patches masked and the
    last bag empty, int8 quantized per patch; W1 and b1 at torch's default
    Linear scale, w2 at 0.25 N(0, 1) so that the attention is peaked (logit
    spread ~2), and an output cotangent g [B, D]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, N, D, generator=gen, device=device)
    mask = torch.rand(B, N, generator=gen, device=device) > 0.1
    mask[-1] = False
    x = x * mask[..., None]
    x_scale = None
    if storage == "int8":
        amax = x.abs().amax(-1) / 127.0
        x = torch.clamp(torch.round(x / torch.where(amax > 0, amax, 1.0)[..., None]),
                        -127, 127).to(torch.int8)
        x_scale = amax.contiguous()
    elif storage == "bf16":
        x = x.to(torch.bfloat16)
    bound = D ** -0.5
    w1 = (torch.rand(H, D, generator=gen, device=device) * 2 - 1) * bound
    b1 = (torch.rand(H, generator=gen, device=device) * 2 - 1) * bound
    w2 = 0.25 * torch.randn(H, generator=gen, device=device)
    g = torch.randn(B, D, generator=gen, device=device)
    return x.contiguous(), x_scale, mask.contiguous(), w1, b1, w2, g


def abmil_bwd_with_dz(torch, ab, x, mask, w1, b1, w2, g, out, m, l):
    """The bf16 weights-only backward launched as `ab.abmil_bwd` launches it
    (not counted), its dz workspace kept: (dW1, dz [B, N, hid] bf16, the
    kernel's own rounding of dz, which its pass 2 sums into dW1)."""
    B, N, D = x.shape
    hid = w1.shape[0]
    index = ab._device_index(x.device)
    plan = ab.bwd_plan(x.dtype, B, N, ab._n_sm(index), D, hid, False)
    f32 = dict(dtype=torch.float32, device=x.device)
    dw1, db1, dw2 = torch.empty(hid, D, **f32), torch.empty(hid, **f32), torch.empty(hid, **f32)
    ds = torch.empty(plan["ds"], dtype=plan["ds_dtype"], device=x.device)
    ws_dw1 = torch.empty(plan["ws_dw1"], **f32)
    ws_db1, ws_dw2 = torch.empty(plan["ws_b"], **f32), torch.empty(plan["ws_b"], **f32)
    w1_ws = torch.empty(plan["w1_bf16"], dtype=torch.bfloat16, device=x.device)
    ws_sums = ab._empty(plan["ws_sums"], torch.float32, x.device)
    p = ab._ptr
    err = ab._library("abmil_bwd").abmil_bwd(
        p(x), None, p(mask), p(w1), p(b1), p(w2), p(g), p(out), p(m), p(l), B, N, D, hid,
        plan["chunk1"], plan["S1"], plan["chunk2"], plan["S2"], 1, 0, 0, index, p(w1_ws), None,
        p(ds), p(ws_dw1), p(ws_sums), p(ws_db1), p(ws_dw2), None, p(dw1), p(db1), p(dw2),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err == 0, f"abmil_bwd bf16 at D={D} hid={hid}: cudaError {err}")
    torch.cuda.synchronize()
    return dw1, ds[..., :hid]


def abmil_bf16_dz_accuracy(torch, ab, D, H):
    """bf16's dW1 at (D, H) against an f64 model of its rounding
    (`abmil_bwd_rounded(exact=True)`: dz from the same inputs in f64, then
    rounded to bf16, the TPU kernel's rounding).  The kernel and its plain
    version each round some dz entries to the bf16 neighbour of the
    model's, the more often the less accurate their f32 dz; one such entry
    of a patch with a large dz moves a whole row of dW1 by a bf16 ulp of its
    part, which neither max|dW1| nor the Frobenius norm averages out.
    Holds (a) the kernel's dW1 within TOL_DW1_OWN_DZ of max|dW1| of the f64
    sum over its own bf16 dz (its pass 2 sums what its pass 1 wrote), and
    (b) the dz entries it rounds apart from the model at most DZ_APART_FACTOR
    times the plain version's (its f32 dz as accurate as the plain one's).
    Logs the max and Frobenius gaps, both counts, and the kernel's entry
    that moves dW1 most with its share of the kernel's max gap."""
    x, _xs, mask, w1, b1, w2, g = make_abmil_inputs(torch, **ABMIL_SHAPE, storage="bf16", D=D,
                                                    H=H)
    where = f"abmil_bwd bf16 at B=8 N=10240 D={D} hid={H}"
    out, m, l = ab.abmil_fwd(x, mask, w1, b1, w2)
    dw1_k, dz_k = abmil_bwd_with_dz(torch, ab, x, mask, w1, b1, w2, g, out, m, l)
    _dx, dw1_p, _db1, _dw2 = ab.abmil_bwd_reference(x, mask, w1, b1, w2, g, out, m, l,
                                                    need_dx=False)
    _dx, dw1_e, _db1, _dw2 = ab.abmil_bwd_rounded(x, mask, w1, b1, w2, g, out, m, l,
                                                  need_dx=False, exact=True)
    live = mask[..., None]
    xd = x.double()
    dz_k = torch.where(live, dz_k.double(), 0.0)
    dw1_own = torch.einsum("bnh,bnd->hd", dz_k, xd)
    gap = lambda a, b: float((a.double() - b).abs().max() / b.abs().max())  # noqa: E731
    fro = lambda a, b: float((a.double() - b).norm() / b.norm())  # noqa: E731
    rec = {"kernel_to_plain": gap(dw1_k, dw1_p.double()),
           "kernel_to_own_dz": gap(dw1_k, dw1_own), "kernel_to_exact": gap(dw1_k, dw1_e),
           "plain_to_exact": gap(dw1_p, dw1_e), "kernel_to_exact_fro": fro(dw1_k, dw1_e),
           "plain_to_exact_fro": fro(dw1_p, dw1_e)}
    del dw1_own, _dx, _db1, _dw2
    _xf, _h, _a, _ds, dz_f = ab._bwd_terms(x, mask, w1, b1, w2, g, out, m, l, None, False)
    dz_p = torch.where(live, dz_f.to(torch.bfloat16).double(), 0.0)
    del _xf, _h, _a, _ds, dz_f
    exact = [t.double() for t in (w1, b1, w2, g, out, m, l)]
    _xf, _h, _a, _ds, dz_e = ab._bwd_terms(x, mask, *exact, None, False)
    del _xf, _h, _a, _ds
    dz_r = torch.where(live, dz_e.to(torch.float32).to(torch.bfloat16).double(), 0.0)
    del dz_e
    diff = dz_k != dz_r
    rec["dz_apart_kernel"] = int(diff.sum())
    rec["dz_apart_plain"] = int((dz_p != dz_r).sum())
    if rec["dz_apart_kernel"]:
        moved = (dz_k - dz_r).abs() * xd.abs().amax(-1, keepdim=True)
        _B, N_, H_ = moved.shape
        b, rest = divmod(int(moved.argmax()), N_ * H_)
        n, j = divmod(rest, H_)
        rec.update(worst_entry=[b, n, j],
                   worst_share=float(moved[b, n, j] / (dw1_k.double() - dw1_e).abs().max()))
    log(f"{where}: dW1 {rec['kernel_to_plain']:.3e} from its plain version; from the f64 "
        f"model (max, Frobenius) the kernel {rec['kernel_to_exact']:.3e}, "
        f"{rec['kernel_to_exact_fro']:.3e}, the plain version {rec['plain_to_exact']:.3e}, "
        f"{rec['plain_to_exact_fro']:.3e}; dz entries rounded apart from the f64 model's: "
        f"kernel {rec['dz_apart_kernel']}, plain {rec['dz_apart_plain']} (limit "
        f"{DZ_APART_FACTOR}x); from the f64 sum over its own dz "
        f"{rec['kernel_to_own_dz']:.3e} (tol {TOL_DW1_OWN_DZ:g}); {rec}")
    check(rec["kernel_to_own_dz"] <= TOL_DW1_OWN_DZ,
          f"{where}: dW1 deviates {rec['kernel_to_own_dz']:.3e} from the sum over its own dz")
    check(rec["dz_apart_kernel"] <= DZ_APART_FACTOR * rec["dz_apart_plain"],
          f"{where}: the kernel rounds {rec['dz_apart_kernel']} dz entries apart from the f64 "
          f"model, the plain version {rec['dz_apart_plain']}")
    return rec


def abmil_fwd_kernel(ab, x, xs, mask, w1, b1, w2):
    if xs is None:
        return ab.abmil_fwd(x, mask, w1, b1, w2)
    return ab.abmil_q8_fwd(x, xs, mask, w1, b1, w2)


def abmil_bwd_kernel(ab, x, xs, mask, w1, b1, w2, g, out, m, l, need_dx):
    """(dX or None, dW1, db1, dw2) from the backward kernel."""
    if xs is None:
        return ab.abmil_bwd(x, mask, w1, b1, w2, g, out, m, l, need_dx=need_dx)
    return (None,) + tuple(ab.abmil_q8_bwd(x, xs, mask, w1, b1, w2, g, out, m, l))


@contextlib.contextmanager
def abmil_precise(ab):
    """vlsa_tpu's precise mode for the ABMIL kernels within the block (the
    module reads VLSA_TPU_ABMIL_PRECISE once at import; its wrappers read
    the attribute at each call)."""
    old = ab._PRECISE
    ab._PRECISE = True
    try:
        yield
    finally:
        ab._PRECISE = old


def hold_routes(ab, before, fwd, bwd, route):
    """The calls since `before` (LAUNCHES_ROUTE, LAUNCHES_BWD_ROUTE) ran
    `fwd` forwards and `bwd` backwards, all on `route`'s instances."""
    now = (dict(ab.LAUNCHES_ROUTE), dict(ab.LAUNCHES_BWD_ROUTE))
    want = (dict(before[0], **{route: before[0][route] + fwd}),
            dict(before[1], **{route: before[1][route] + bwd}))
    check(now == want, f"ABMIL routes {now}, expected {want}")


def hold_abmil(torch, ab, x, xs, mask, w1, b1, w2, g, storage, where):
    """Hold the forward, the weights-only backward and (f32, bf16) the
    backward with dX against their plain versions on the same inputs, each
    call on the instances of its width (`ab.route`).  Returns {kernel:
    {"max_abs_err", "rel_err"}}, the worst over its outputs, and the
    forward's (out, m, l)."""
    D, H = x.shape[2], w1.shape[0]
    rt = ab.route(x.dtype, D, H)
    where = f"{where} D={D} hid={H} ({rt})"
    routes = (dict(ab.LAUNCHES_ROUTE), dict(ab.LAUNCHES_BWD_ROUTE))
    out, m, l = abmil_fwd_kernel(ab, x, xs, mask, w1, b1, w2)
    torch.cuda.synchronize()
    ref, m_ref, l_ref = ab.abmil_fwd_reference(x, mask, w1, b1, w2, x_scale=xs)
    errs = {"abmil_fwd": hold(f"abmil fwd {storage} {where}", out, ref, TOL_ABMIL[storage])}
    check(float(out[-1].abs().max()) == 0.0 and float(m[-1]) == float(m_ref[-1])
          and float(l[-1]) == float(l_ref[-1]),
          f"abmil fwd {storage}: the empty bag pooled to {float(out[-1].abs().max())}, "
          f"m {float(m[-1])}, l {float(l[-1])}")
    hold(f"abmil fwd {storage} {where} l", l, l_ref, TOL_ABMIL[storage])
    del ref, m_ref, l_ref
    if storage == "int8":  # the gap to the plain model of the kernel's W1 split
        rnd, m_rnd, l_rnd = ab.abmil_fwd_rounded(x, mask, w1, b1, w2, x_scale=xs)
        live = mask.any(-1)
        gap = {"out": rel_err(out, rnd), "m": float((m - m_rnd)[live].abs().max()),
               "l": rel_err(l, l_rnd)}
        log(f"  abmil fwd int8 {where}: gap to abmil_fwd_rounded out {gap['out']:.3e}, "
            f"m {gap['m']:.3e}, l {gap['l']:.3e}")
        errs["abmil_fwd"]["rounded_gap"] = gap
        del rnd, m_rnd, l_rnd
    for need_dx in ((False,) if storage == "int8" else (False, True)):
        name = "abmil_bwd_dx" if need_dx else "abmil_bwd"
        got = abmil_bwd_kernel(ab, x, xs, mask, w1, b1, w2, g, out, m, l, need_dx)
        torch.cuda.synchronize()
        want = ab.abmil_bwd_reference(x, mask, w1, b1, w2, g, out, m, l, x_scale=xs,
                                      need_dx=need_dx)
        worst = {"max_abs_err": 0.0, "rel_err": 0.0}
        for leaf, a, b in zip(("dX", "dW1", "db1", "dw2"), got, want):
            if b is None:
                check(a is None, f"{name} {storage}: a dX nobody asked for")
                continue
            tol = TOL_ABMIL_DX[storage] if leaf == "dX" else TOL_ABMIL_DW[storage]
            e = hold(f"{name} {storage} {where} {leaf}", a.float(), b.float(), tol)
            worst = {k: max(worst[k], e[k]) for k in worst}
        errs[name] = worst
        del got, want
    hold_routes(ab, routes, 1, 1 if storage == "int8" else 2, rt)
    return errs, (out, m, l)


def hold_abmil_precise(torch, ab, x, mask, w1, b1, w2, g, where):
    """bf16 in precise mode: the forward and both backwards against the
    plain f32 version (x's bf16 values, W1 unrounded) at the bf16 limits,
    and against the models of their rounding: the forward's out and l within
    TOL_ABMIL_MODEL of `abmil_fwd_rounded`, the backward's leaves by
    `ab.bwd_model_gaps` against `abmil_bwd_rounded(exact=True)` (dW1 within
    TOL_ABMIL_PRECISE_DW1, dX, db1 and dw2 within TOL_ABMIL_MODEL), which
    the single-rounded model must miss in dW1 and dX; each gap logged.
    Returns {kernel: errors} and the forward's (out, m, l)."""
    D, H = x.shape[2], w1.shape[0]
    where = f"{where} D={D} hid={H} (precise)"
    routes = (dict(ab.LAUNCHES_ROUTE), dict(ab.LAUNCHES_BWD_ROUTE))
    tols = {"dX": TOL_ABMIL_MODEL, "dW1": TOL_ABMIL_PRECISE_DW1, "db1": TOL_ABMIL_MODEL,
            "dw2": TOL_ABMIL_MODEL}
    with abmil_precise(ab):
        out, m, l = ab.abmil_fwd(x, mask, w1, b1, w2)
        torch.cuda.synchronize()
        xf = x.float()
        ref, _m, l_ref = ab.abmil_fwd_reference(xf, mask, w1, b1, w2)
        errs = {"abmil_fwd": hold(f"abmil fwd bf16 {where}", out, ref, TOL_ABMIL["bf16"])}
        hold(f"abmil fwd bf16 {where} l", l, l_ref, TOL_ABMIL["bf16"])
        mod, m_mod, l_mod = ab.abmil_fwd_rounded(x, mask, w1, b1, w2, precise=True)
        errs["abmil_fwd"]["model"] = {
            "out": hold(f"abmil fwd bf16 {where} vs its model", out, mod, TOL_ABMIL_MODEL),
            "l": hold(f"abmil fwd bf16 {where} l vs its model", l, l_mod, TOL_ABMIL_MODEL)}
        del ref, mod
        args = (x, mask, w1, b1, w2, g, out, m, l)
        exact = ab.abmil_bwd_rounded(*args, precise=True, exact=True)
        scales = ab.abmil_bwd_sum_scales(*args, precise=True)
        single = ab.abmil_bwd_rounded(*args, precise=False, exact=True)
        single = ab.bwd_model_gaps((single[0].to(torch.bfloat16),) + single[1:], exact, scales)
        log(f"  abmil_bwd bf16 {where}: the single-rounded model's gaps to the precise "
            f"model {single}")
        check(single["dW1"] > tols["dW1"] and single["dX"] > tols["dX"],
              f"abmil_bwd bf16 {where}: the single-rounded model meets the precise limits "
              f"{tols}: {single}")
        for need_dx in (False, True):
            name = "abmil_bwd_dx" if need_dx else "abmil_bwd"
            got = ab.abmil_bwd(x, mask, w1, b1, w2, g, out, m, l, need_dx=need_dx)
            torch.cuda.synchronize()
            want = ab.abmil_bwd_reference(xf, mask, w1, b1, w2, g, out, m, l, need_dx=need_dx)
            worst = {"max_abs_err": 0.0, "rel_err": 0.0}
            for leaf, a, b in zip(("dX", "dW1", "db1", "dw2"), got, want):
                if b is None:
                    check(a is None, f"{name} precise: a dX nobody asked for")
                    continue
                tol = TOL_ABMIL_DX["bf16"] if leaf == "dX" else TOL_ABMIL_DW["bf16"]
                e = hold(f"{name} bf16 {where} {leaf}", a.float(), b.float(), tol)
                worst = {k: max(worst[k], e[k]) for k in worst}
            gaps = ab.bwd_model_gaps(got, exact, scales)
            log(f"{name} bf16 {where} vs its exact model {gaps} (limits {tols})")
            bad = {k: v for k, v in gaps.items() if not v <= tols[k]}
            check(not bad, f"{name} bf16 {where}: gaps to its exact model {bad} above {tols}")
            errs[name] = dict(worst, model_gaps=gaps, single_rounded_gaps=single)
            del got, want
        del exact, scales
    hold_routes(ab, routes, 1, 2, "precise")
    return errs, (out, m, l)


def ptxas_lines(name: str) -> list:
    """ptxas's lines for csrc/<name>.cu's kernels (registers, static shared
    memory, spills), logged."""
    from vlsa_tpu_torch.ops import _build
    check(name in _build.BUILD_LOGS, f"no nvcc output for {name}.cu")
    report = _build.ptxas_report(_build.BUILD_LOGS[name])
    for r in report:
        log(f"  ptxas {name} {r['function']}: {r['registers']} registers, {r['smem']} bytes "
            f"static smem, stack {r['stack']}, spill stores {r['spill_stores']}, "
            f"loads {r['spill_loads']}")
    return report


def abmil_ptxas(ab) -> dict:
    """ptxas's lines for csrc/abmil_fwd.cu's and csrc/abmil_bwd.cu's kernels
    and every forward's and backward pass's dynamic shared memory at each of
    ABMIL_WIDTHS and ABMIL_ANY_WIDTHS and at the domain's corners; fails if
    an f32 kernel (5), a forward instance (abmil_fwd_partial<T>, 2;
    abmil_fwd_general, 7) or a backward pass (abmil_bwd_dz_*,
    abmil_bwd_dw_*: 2 f32, 3 bf16-operand pass-1 instances, 7 general ones,
    8 pass-2 ones: 4 storages by x's rows 16-byte aligned or not) spills, if
    a forward instance or a backward pass keeps a stack frame, or if a
    block's shared memory exceeds what the card gives."""
    import torch
    report = {name: ptxas_lines(name) for name in ("abmil_fwd", "abmil_bwd")}
    f32 = [r for rs in report.values() for r in rs if "_f32" in r["function"]]
    check(len(f32) == 5, f"ptxas shows {len(f32)} f32 ABMIL kernels, not 5 (the forward, "
                         "pass 1 with and without dX, pass 2 for rows 16-byte aligned or not)")
    fwd_q = [r for r in report["abmil_fwd"]
             if "abmil_fwd_partial" in r["function"] and "_f32" not in r["function"]]
    check(len(fwd_q) == 2, f"ptxas shows {len(fwd_q)} bf16 and int8 forward instances, not 2")
    fwd_g = [r for r in report["abmil_fwd"] if "abmil_fwd_general" in r["function"]]
    check(len(fwd_g) == 7, f"ptxas shows {len(fwd_g)} general forward instances, not 7 "
                           "(f32: 3 pass widths; int8: 2; bf16, precise: 1)")
    passes = [r for r in report["abmil_bwd"] if "abmil_bwd_d" in r["function"]]
    check(len(passes) == 20, f"ptxas shows {len(passes)} ABMIL backward passes, not 20")
    for r in f32 + fwd_q + fwd_g + passes:
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"an ABMIL kernel spills: {r}")
    for r in fwd_q + fwd_g + passes:
        check(r["stack"] == 0, f"an ABMIL kernel keeps a stack frame: {r}")
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    fwd, bwd = ab._library("abmil_fwd"), ab._library("abmil_bwd")
    smem = {}
    for D, H in (ABMIL_WIDTHS + ABMIL_ANY_WIDTHS + ANY_WIDTHS_2G
                 + ((64, 64), (2048, 512), (1, 1), (8192, 1024), (132104, 8192))):
        for i, s_ in enumerate(ABMIL_STORAGES):
            for precise in ((0, 1) if s_ == "bf16" else (0,)):
                key = f"{s_}{'_precise' if precise else ''}_D{D}_h{H}"
                smem[key] = {"fwd": fwd.abmil_fwd_smem_bytes(i, D, H, precise),
                             "bwd_pass1": bwd.abmil_bwd_smem_bytes(i, D, H, precise, 1),
                             "bwd_pass2": bwd.abmil_bwd_smem_bytes(i, D, H, precise, 2)}
    log(f"  ABMIL dynamic shared memory, bytes a block (the card gives {optin}): {smem}")
    top = max(v for rec in smem.values() for v in rec.values())
    check(top <= optin, f"ABMIL shared memory {top} above {optin}")
    return {"kernels": report, "dynamic_smem": smem}


def coattn_bwd_ptxas(co) -> dict:
    """ptxas's lines for csrc/coattn_bwd_dq.cu's and csrc/coattn_bwd_dx.cu's
    kernels and the streaming kernel's dynamic shared memory at C=512, P=16
    for each storage; fails if a streaming instance spills, keeps arrays in
    local memory (a stack frame) or its shared memory exceeds the card's."""
    import torch
    report = {name: ptxas_lines(name) for name in ("coattn_bwd_dq", "coattn_bwd_dx")}
    for name, count in (("coattn_bwd_dq", 12), ("coattn_bwd_dx", 8)):
        stream = [r for r in report[name] if "coattn_bwd_stream" in r["function"]]
        check(len(stream) == count, f"ptxas shows {len(stream)} {name} streaming instances, "
                                    f"not {count} (storages, host norms or not, C <= 512 or "
                                    f"wide; dX: P <= 16 or looped)")
        for r in stream:
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0 and r["stack"] == 0,
                  f"a co-attention backward instance spills or keeps a stack frame: {r}")
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    smem = {}
    for name, storages in (("coattn_bwd_dq", ("f32", "bf16", "int8")),
                           ("coattn_bwd_dx", ("f32", "bf16"))):
        lib = co._library(name)
        for i, s_ in enumerate(storages):
            for P in (16, 256):
                smem[f"{name}[{s_}] P={P}"] = getattr(lib, f"{name}_smem_bytes")(P, SHAPE["C"], i)
    log(f"  co-attention backward dynamic shared memory {smem} bytes a block at C=512, P=16 "
        f"and 256 (the card gives {optin})")
    check(0 < min(smem.values()) and max(smem.values()) <= optin,
          f"co-attention backward shared memory {smem} against {optin}")
    return {"kernels": report, "dynamic_smem": smem}


def coattn_fwd_ptxas(co) -> dict:
    """ptxas's lines for csrc/coattn_fwd.cu's kernels and the streaming
    kernel's dynamic shared memory at C=512 for each storage; fails if a
    streaming instance spills or its shared memory exceeds the card's."""
    import torch
    report = ptxas_lines("coattn_fwd")
    stream = [r for r in report if "coattn_fwd_stream" in r["function"]]
    check(len(stream) == 12, f"ptxas shows {len(stream)} streaming instances, not 12 "
                             "(3 storages, host norms or not, C <= 512 or wide)")
    for r in stream:
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"a co-attention forward instance spills: {r}")
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = co._library("coattn_fwd")
    smem = {s: lib.coattn_fwd_smem_bytes(SHAPE["P"], SHAPE["C"], i)
            for i, s in enumerate(("f32", "bf16", "int8"))}
    log(f"  co-attention forward dynamic shared memory {smem} bytes a block at C=512 "
        f"(the card gives {optin})")
    check(0 < min(smem.values()) and max(smem.values()) <= optin,
          f"co-attention forward shared memory {smem} against {optin}")
    return {"kernels": report, "dynamic_smem": smem}


def phase_abmil_kernels(torch, ab):
    """Every storage at each of ABMIL_WIDTHS and ABMIL_ANY_WIDTHS and,
    ragged, at ABMIL_RAGGED_WIDTHS and ABMIL_ANY_RAGGED_WIDTHS; precise bf16
    at ABMIL_PRECISE_WIDTHS and ABMIL_ANY_PRECISE_WIDTHS."""
    errs = {}
    for D, H in ABMIL_WIDTHS + ABMIL_ANY_WIDTHS:
        for s in ABMIL_STORAGES:
            inputs = make_abmil_inputs(torch, **ABMIL_SHAPE, storage=s, D=D, H=H)
            key = s if (D, H) == (512, 256) else f"{s}_D{D}_h{H}"
            errs[key], _stats = hold_abmil(torch, ab, *inputs, s, "at B=8 N=10240")
            del inputs, _stats
            torch.cuda.empty_cache()
    B, N = ABMIL_RAGGED["B"], ABMIL_RAGGED["N"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for D, H in ABMIL_RAGGED_WIDTHS + ABMIL_ANY_RAGGED_WIDTHS:
        for s in ABMIL_STORAGES:
            dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[s]
            plans = {"fwd": ab.fwd_plan(dtype, B, N, n_sm, D, H),
                     "bwd": ab.bwd_plan(dtype, B, N, n_sm, D, H)}
            chunks = (plans["fwd"]["chunk"], plans["bwd"]["chunk1"])
            check(N % plans["fwd"]["tile"] != 0 and N % ab._TILE[dtype] != 0
                  and all(N % c != 0 and N > c for c in chunks),
                  f"{s} at B={B} N={N}: no partial tile and chunk to hold (plans {plans})")
            inputs = make_abmil_inputs(torch, **ABMIL_RAGGED, storage=s, D=D, H=H)
            key = f"{s}_ragged" + ("" if (D, H) == (512, 256) else f"_D{D}_h{H}")
            errs[key], _stats = hold_abmil(torch, ab, *inputs, s, f"at B={B} N={N}")
            errs[key]["chunks"] = chunks
            del inputs, _stats
            torch.cuda.empty_cache()
    for D, H in ABMIL_PRECISE_WIDTHS + ABMIL_ANY_PRECISE_WIDTHS:
        x, _xs, mask, w1, b1, w2, g = make_abmil_inputs(torch, **ABMIL_SHAPE, storage="bf16",
                                                        D=D, H=H)
        errs[f"bf16_precise_D{D}_h{H}"], _stats = hold_abmil_precise(
            torch, ab, x, mask, w1, b1, w2, g, "at B=8 N=10240")
        del x, mask, w1, b1, w2, g, _stats
        torch.cuda.empty_cache()
    for D, H in ABMIL_DZ_WIDTHS:
        errs[f"bf16_dz_accuracy_D{D}_h{H}"] = abmil_bf16_dz_accuracy(torch, ab, D, H)
        torch.cuda.empty_cache()
    return errs


def make_qkv(torch, B, H, L, variant, seed=0, device="cuda"):
    """q, k, v [B, H, L, 64] ~ N(0, 1) in the variant's type."""
    g = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.bfloat16 if variant == "bf16" else torch.float32
    return [torch.randn(B, H, L, 64, generator=g, device=device).to(dtype) for _ in range(3)]


def flash_ptxas() -> list:
    """ptxas's lines for csrc/flash_attn_fwd.cu's kernels; fails if a
    resident instance or the streamed kernel spills, or the streamed kernel
    keeps a stack frame."""
    report = ptxas_lines("flash_attn_fwd")
    resident = [r for r in report if "flash_fwd_bf16_resident" in r["function"]]
    streamed = [r for r in report if "flash_fwd_bf16_streamed" in r["function"]]
    check(len(resident) > 0 and len(streamed) == 1,
          f"ptxas shows {len(resident)} resident and {len(streamed)} streamed flash kernels")
    for r in resident + streamed:
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"a flash kernel spills: {r}")
    check(streamed[0]["stack"] == 0, f"the streamed flash kernel keeps a stack frame: {streamed[0]}")
    return report


def flash_probe(torch, fa, L, path, B=64, H=12):
    """The zero-query probe on one bf16 path: q = 0, k ~ N(0, 1), v = 1.
    Every score is 0, so P = 1/L rounded to bf16 and each output is L *
    bf16(1/L) exactly; its worst relative deviation is returned."""
    g = torch.Generator(device="cuda").manual_seed(L)
    q = torch.zeros(B, H, L, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(B, H, L, 64, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.ones_like(q)
    want = L * torch.tensor(1.0 / L).to(torch.bfloat16).double().item()
    out = fa.flash_attn_fwd(q, k, v, _force_path=path)
    torch.cuda.synchronize()
    return float((out.double() - want).abs().max() / want), want


def phase_flash_kernel(torch, fa):
    """Each variant of csrc/flash_attn_fwd.cu against its plain version at
    B=64, H=12 and L = 785 (the extraction shape), 197, 1, 801 and 1025;
    bf16 on the path of `flash_plan(L)`, and the resident kernel forced at
    785 and 197; then the zero-query probe on every bf16 path."""
    ptxas = flash_ptxas()
    errs = {}
    cases = [(v, L, None) for v in FLASH_VARIANTS for L in FLASH_LENGTHS]
    cases += [("bf16", L, "resident") for L in FLASH_RESIDENT_LENGTHS]
    for v, L, force in cases:
        q, k, vv = make_qkv(torch, FLASH_SHAPE["B"], FLASH_SHAPE["H"], L, v)
        before = dict(fa.LAUNCHES_PATH)
        out = fa.flash_attn_fwd(q, k, vv, _force_path=force)
        torch.cuda.synchronize()
        path = force or (fa.flash_plan(L)[0] if v == "bf16" else None)
        if path is not None:
            check(fa.LAUNCHES_PATH == dict(before, **{path: before[path] + 1}),
                  f"flash {v} at L={L}: expected one {path} launch, counts {before} -> "
                  f"{fa.LAUNCHES_PATH}")
        what = f"flash {v}{'' if path is None else ' ' + path}{' (forced)' if force else ''}"
        errs.setdefault(v if force is None else f"{v}_{force}", {})[L] = hold(
            f"{what} at B=64 H=12 L={L}", out, fa.flash_self_attention_reference(q, k, vv),
            TOL_FLASH[v])
        del q, k, vv, out
        torch.cuda.empty_cache()
    probe = {}
    for L in FLASH_PROBE_LENGTHS:
        paths = [None] + (["resident"] if L <= fa.RESIDENT_CAPACITY else [])
        for path in paths:
            dev, want = flash_probe(torch, fa, L, path)
            name = path or fa.flash_plan(L)[0]
            log(f"zero-query probe, bf16 {name}{' (forced)' if path else ''} at L={L}: every "
                f"output {want!r} = L * bf16(1/L) within {dev:.3e} (tol {TOL_FLASH_PROBE:g})")
            check(dev <= TOL_FLASH_PROBE, f"zero-query probe, bf16 {name} at L={L}: deviates "
                                          f"{dev:.3e} from L * bf16(1/L) = {want!r}")
            probe[f"{name}_L{L}"] = dev
        torch.cuda.empty_cache()
    errs["probe"] = probe
    return errs, ptxas


# ---------------------------------------------------------------- phase 2e

def bf16_ulp_of_max(ref) -> float:
    """One bf16 ulp at the scale of ref's largest element."""
    return 2.0 ** (math.floor(math.log2(max(ref.float().abs().max().item(), 1e-30))) - 7)


def hold_dx(torch, co, storage, q, x, mask, g, where, tight=False, exact=False):
    """Hold the full backward kernel's (dq, dX) against its plain version
    on the same inputs, with (out, m, l) from the forward kernel (f32 within
    TOL_F32_BWD where `tight`, of the exact function, the plain version in
    float64, where `exact`); dX must be exactly 0 on masked rows and the
    empty bag.  Returns the errors (the worst absolute error over both
    outputs as max_abs_err) and dX."""
    out, m, l = co.coattn_fwd(q, x, mask, SCALE)
    dq, dx = co.coattn_bwd_dx(q, x, mask, SCALE, g, out, m, l)
    torch.cuda.synchronize()
    rdq, rdx = co.coattn_bwd_dx_reference(
        q, x, mask, SCALE, g, out, m, l,
        dtype=torch.float64 if exact and storage == "f32" else torch.float32)
    if exact and storage == "f32":
        where += " (exact)"
    f32_tight = tight and storage == "f32"
    e_dq = hold(f"dx kernel {storage} {where} dq", dq, rdq,
                TOL_F32_BWD["dq"] if f32_tight else TOL_DX_DQ[storage])
    check(dx.dtype == x.dtype and dx.shape == x.shape, f"dX {dx.dtype} {tuple(dx.shape)}")
    if storage == "f32":
        e_dx = hold(f"dx kernel {storage} {where} dX", dx, rdx,
                    TOL_F32_BWD["dx"] if f32_tight else TOL_DX_F32)
    else:
        ulp = bf16_ulp_of_max(rdx)
        diff = (dx.float() - rdx.float()).abs().max().item()
        e_dx = {"max_abs_err": diff, "ulp_of_max": ulp,
                "rel_err": diff / max(rdx.float().abs().max().item(), 1e-30)}
        log(f"dx kernel {storage} {where} dX: max|k-p| {diff:.3e}  rel {e_dx['rel_err']:.3e}"
            f"  (tol one bf16 ulp of the largest element, {ulp:.3e})")
        check(bool(dx.isfinite().all()), f"dx kernel {storage}: non-finite dX")
        check(diff <= ulp, f"bf16 dX deviates {diff:.3e}, more than one bf16 ulp ({ulp:.3e}) "
                           f"of its plain version")
    zero = float(dx[~mask].float().abs().max()) if bool((~mask).any()) else 0.0
    check(zero == 0.0 and float(dx[-1].float().abs().max()) == 0.0,
          f"dX {storage}: {zero} on masked rows, {float(dx[-1].float().abs().max())} "
          f"on the empty bag")
    return {"dq": e_dq, "dx": e_dx,
            "max_abs_err": max(e_dq["max_abs_err"], e_dx["max_abs_err"])}, dx


def phase_dx_kernel(torch, co):
    """Both variants of csrc/coattn_bwd_dx.cu against the plain version at
    SHAPE, and the bf16 dX against a true-f32 autograd of the plain pooling
    on the same stored values; then both at C=1024, the wide instance."""
    errs = {}
    for s in DX_STORAGES:
        B, N, C = FWD_WIDE["B"], FWD_WIDE["N"], FWD_WIDE["C"]
        q, x, mask, _xs, _xi = make_inputs(torch, B, N, C, SHAPE["P"], variant=s, keep_masked=True)
        g = make_cotangent(torch, B, SHAPE["P"], C)
        paths = dict(co.LAUNCHES_BWD_PATH)
        errs[s + "_wide"], _dx = hold_dx(torch, co, s, q, x, mask, g,
                                         f"at B={B} N={N} C={C} (wide)", tight=True)
        check(co.LAUNCHES_BWD_PATH == dict(paths, wide=paths["wide"] + 1),
              f"dx {s} at C={C}: the backward's instance counts {co.LAUNCHES_BWD_PATH}, "
              f"not one more wide launch than {paths}")
        del q, x, mask, g, _dx
    for s in DX_STORAGES:
        q, x, mask, _xs, _xi = make_inputs(torch, **SHAPE, variant=s, keep_masked=True)
        g = make_cotangent(torch, SHAPE["B"], SHAPE["P"], SHAPE["C"])
        errs[s], dx = hold_dx(torch, co, s, q, x, mask, g,
                              f"at B={SHAPE['B']} N={SHAPE['N']}", tight=True)
        xf = x.float().requires_grad_(True)
        co.coattn_pool_reference(q, xf, mask, SCALE).backward(g)
        gap = rel_err(dx.float(), xf.grad)
        errs[s]["true_f32_rel"] = gap
        log(f"dx kernel {s} dX vs a true-f32 autograd of the plain pooling: {gap:.3e} "
            f"(tol {TOL_DX_TRUE_F32:g})")
        check(gap <= TOL_DX_TRUE_F32, f"{s} dX deviates {gap:.3e} from true f32")
        del q, x, mask, g, xf, dx
        torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------- phase 2f

def phase_query_kernels(torch, co):
    """Rows 1-6 above 16 queries: every forward and dQ variant and both dX
    storages at each of QUERY_COUNTS (B=8, N=10240, C=512) and at QUERY_WIDE,
    against their plain versions on the same inputs; each call one launch on
    its query route ("grid": the forward and dQ, "loop": dX).  f32 is held
    against the exact function (the plain version in float64) at
    TOL_F32_FWD and TOL_F32_BWD; the f32 plain version's own gap to it is
    logged, and beside the forward's gap its gap to `coattn_fwd_rounded`."""
    exact = dict(dtype=torch.float64)
    errs = {}
    for sh in [dict(SHAPE, P=P) for P in QUERY_COUNTS] + [QUERY_WIDE]:
        B, N, C, P = sh["B"], sh["N"], sh["C"], sh["P"]
        tag = f"P={P}" + ("" if C == SHAPE["C"] else f" C={C}")
        for v in VARIANTS:
            q, x, mask, xs, xi = make_inputs(torch, B, N, C, P, variant=v)
            paths = dict(co.LAUNCHES_QUERY_PATH)
            out, m, l = co.coattn_fwd(q, x, mask, SCALE, xs, xi)
            g = make_cotangent(torch, B, P, C)
            dq = co.coattn_bwd_dq(q, x, mask, SCALE, g, out, m, l, xs, xi)
            torch.cuda.synchronize()
            check(co.LAUNCHES_QUERY_PATH == dict(paths, grid=paths["grid"] + 2),
                  f"{v} {tag}: query routes {co.LAUNCHES_QUERY_PATH}, not two more grid "
                  f"launches than {paths}")
            f32 = storage_of(v) == "f32"
            ref = co.coattn_pool_reference(q, x, mask, SCALE, xs)
            if f32:
                ref64 = co.coattn_pool_reference(q, x, mask, SCALE, xs, **exact)
                log(f"  plain f32 {v} {tag} vs exact {rel_err(ref, ref64):.3e}")
                ref = ref64
            rec = {"fwd": hold(f"kernel {v} B={B} N={N} {tag}" + (" (exact)" if f32 else ""),
                               out, ref, TOL_F32_FWD if f32 else TOL[storage_of(v)])}
            rec["fwd"]["model_rel_err"] = rel_err(
                out, co.coattn_fwd_rounded(q, x, mask, SCALE, xs, xi)[0])
            log(f"  kernel {v} {tag} vs its rounding model {rec['fwd']['model_rel_err']:.3e}")
            check(float(out[-1].abs().max()) == 0.0 and bool(torch.all(m[-1] == -1e30))
                  and bool(torch.all(l[-1] == 1e-30)), f"{v} {tag}: the empty bag")
            rec["dq"] = hold(f"dq kernel {v} B={B} N={N} {tag}" + (" (exact)" if f32 else ""),
                             dq, co.coattn_bwd_dq_reference(q, x, mask, SCALE, g, out, m, l, xs,
                                                            xi, **(exact if f32 else {})),
                             TOL_F32_BWD["dq"] if f32 else TOL_DQ[storage_of(v)])
            errs[f"{v} {tag}"] = rec
            del q, x, mask, xs, xi, out, m, l, g, dq
        for s_ in DX_STORAGES:
            q, x, mask, _xs, _xi = make_inputs(torch, B, N, C, P, variant=s_, keep_masked=True)
            g = make_cotangent(torch, B, P, C)
            paths = dict(co.LAUNCHES_QUERY_PATH)
            errs[f"dx[{s_}] {tag}"], _dx = hold_dx(torch, co, s_, q, x, mask, g,
                                                   f"at B={B} N={N} {tag}", tight=True,
                                                   exact=True)
            check(co.LAUNCHES_QUERY_PATH == dict(paths, grid=paths["grid"] + 1,
                                                 loop=paths["loop"] + 1),
                  f"dx {s_} {tag}: query routes {co.LAUNCHES_QUERY_PATH} after {paths}")
            del q, x, mask, g, _dx
        torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------- phase 2g

def phase_any_width_and_queries(torch, ab, co):
    """The routes past the old limits, each against its plain version at
    phase 2c's and 2f's tolerances: ABMIL (every storage and precise bf16,
    forward and both backwards) at each of ANY_WIDTHS_2G (B=2, N=2048: a
    ragged mask and an empty bag), "wide" past D = 8192 (`ab.route`); the
    looped dX (f32, bf16) at LOOP_QUERIES_2G (B=2, N=1024, C=512); the
    forward and dQ, every variant, at GRID_QUERIES_2G queries (65,537 groups
    of 16, B=1, N=64, C=8: past one launch's 65,535), each call on the
    "chunked" query route (f32 against the exact function: the forward at
    TOL_F32_FWD, dq at TOL_F32_DQ_CHUNKED, beside a TF32-only control that
    must fail that limit).  Returns the errors and the launches of each
    route, storage and variant."""
    exact = dict(dtype=torch.float64)
    errs, launches = {}, {}
    before = (dict(ab.LAUNCHES_ROUTE), dict(ab.LAUNCHES_BWD_ROUTE))
    wide = {"abmil_fwd": dict.fromkeys(ABMIL_STORAGES, 0), "abmil_bwd": dict.fromkeys(
        ABMIL_STORAGES, 0), "abmil_bwd_dx": dict.fromkeys(DX_STORAGES, 0)}
    for D, H in ANY_WIDTHS_2G:
        for s_ in ABMIL_STORAGES:
            inputs = make_abmil_inputs(torch, **ANY_WIDTH_SHAPE_2G, storage=s_, D=D, H=H)
            counts = (dict(ab.LAUNCHES), dict(ab.LAUNCHES_BWD))
            errs[f"{s_}_D{D}_h{H}"], _stats = hold_abmil(torch, ab, *inputs, s_,
                                                        "at B=2 N=2048")
            if ab.route(inputs[0].dtype, D, H) == "wide":
                wide["abmil_fwd"][s_] += ab.LAUNCHES[s_] - counts[0][s_]
                wide["abmil_bwd"][s_] += ab.LAUNCHES_BWD[s_] - counts[1][s_]
                if s_ in wide["abmil_bwd_dx"]:
                    wide["abmil_bwd_dx"][s_] += (ab.LAUNCHES_BWD[f"{s_}_dx"]
                                                 - counts[1][f"{s_}_dx"])
            del inputs, _stats
        x, _xs, mask, w1, b1, w2, g = make_abmil_inputs(torch, **ANY_WIDTH_SHAPE_2G,
                                                        storage="bf16", D=D, H=H)
        errs[f"bf16_precise_D{D}_h{H}"], _stats = hold_abmil_precise(
            torch, ab, x, mask, w1, b1, w2, g, "at B=2 N=2048")
        del x, mask, w1, b1, w2, g, _stats
        torch.cuda.empty_cache()
    launches["abmil"] = {"fwd": count_delta(ab.LAUNCHES_ROUTE, before[0]),
                         "bwd": count_delta(ab.LAUNCHES_BWD_ROUTE, before[1])}
    launches["abmil_wide"] = wide
    check(launches["abmil"]["fwd"]["wide"] > 0 and launches["abmil"]["bwd"]["wide"] > 0,
          f"no ABMIL call took the wide route: {launches['abmil']}")
    sh = LOOP_SHAPE_2G
    paths = dict(co.LAUNCHES_QUERY_PATH)
    launches["dx"] = {s_: {} for s_ in DX_STORAGES}
    for P in LOOP_QUERIES_2G:
        for s_ in DX_STORAGES:
            q, x, mask, _xs, _xi = make_inputs(torch, sh["B"], sh["N"], sh["C"], P, variant=s_,
                                               keep_masked=True)
            g = make_cotangent(torch, sh["B"], P, sh["C"])
            plan = co.kernel_plan("coattn_bwd_dx", x.dtype, sh["B"], sh["N"], SM_COUNT,
                                  sh["C"], P)
            n_dx = co.LAUNCHES_DX[s_]
            errs[f"dx[{s_}] P={P}"], _dx = hold_dx(
                torch, co, s_, q, x, mask, g, f"at B={sh['B']} N={sh['N']} P={P}", tight=True,
                exact=True)
            launches["dx"][s_][P] = co.LAUNCHES_DX[s_] - n_dx
            errs[f"dx[{s_}] P={P}"]["blocks"] = plan["blocks"]
            del q, x, mask, g, _dx
            torch.cuda.empty_cache()
    sh, P = GRID_SHAPE_2G, GRID_QUERIES_2G
    launches["chunked"] = {}
    for v in VARIANTS:
        q, x, mask, xs, xi = make_inputs(torch, 2, sh["N"], sh["C"], P, variant=v)
        x, mask = x[:1].contiguous(), mask[:1].contiguous()  # the bag that is not empty
        xs = None if xs is None else xs[:1].contiguous()
        xi = None if xi is None else xi[:1].contiguous()
        f32 = storage_of(v) == "f32"
        counts = (co.LAUNCHES[v], co.LAUNCHES_BWD[v])
        out, m, l = co.coattn_fwd(q, x, mask, SCALE, xs, xi)
        g = make_cotangent(torch, 1, P, sh["C"])
        dq = co.coattn_bwd_dq(q, x, mask, SCALE, g, out, m, l, xs, xi)
        torch.cuda.synchronize()
        launches["chunked"][v] = {"fwd": co.LAUNCHES[v] - counts[0],
                                  "dq": co.LAUNCHES_BWD[v] - counts[1]}
        where = f"{v} B=1 N={sh['N']} C={sh['C']} P={P}" + (" (exact)" if f32 else "")
        ref = co.coattn_pool_reference(q, x, mask, SCALE, xs, **(exact if f32 else {}))
        rec = {"fwd": hold(f"kernel {where}", out, ref,
                           TOL_F32_FWD if f32 else TOL[storage_of(v)])}
        del ref
        ref_dq = co.coattn_bwd_dq_reference(q, x, mask, SCALE, g, out, m, l, xs, xi,
                                            **(exact if f32 else {}))
        rec["dq"] = hold(f"dq kernel {where}", dq, ref_dq,
                         TOL_F32_DQ_CHUNKED if f32 else TOL_DQ[storage_of(v)])
        if f32:
            # the limit must still tell split TF32 from one TF32 pass: the
            # same function on operands rounded to TF32, in float64
            rec["dq"]["plain_f32_rel_err"] = rel_err(co.coattn_bwd_dq_reference(
                q, x, mask, SCALE, g, out, m, l, xs, xi), ref_dq)
            rec["dq"]["tf32_control_rel_err"] = rel_err(co.coattn_bwd_dq_reference(
                tf32_rounded(torch, q), tf32_rounded(torch, x), mask, SCALE,
                tf32_rounded(torch, g), out, m, l, xs, xi, **exact), ref_dq)
            log(f"  dq {where}: the plain f32 version {rec['dq']['plain_f32_rel_err']:.3e} "
                f"from the exact function, a TF32-only product "
                f"{rec['dq']['tf32_control_rel_err']:.3e} (must exceed {TOL_F32_DQ_CHUNKED:g})")
            check(rec["dq"]["tf32_control_rel_err"] > TOL_F32_DQ_CHUNKED,
                  f"dq {where}: a TF32-only product ({rec['dq']['tf32_control_rel_err']:.3e}) "
                  f"would pass the limit {TOL_F32_DQ_CHUNKED:g}")
        check(launches["chunked"][v] == {"fwd": 1, "dq": 1},
              f"{v} P={P}: the kernels' launches {launches['chunked'][v]}, not one each")
        errs[f"{v} P={P}"] = rec
        del q, x, mask, xs, xi, out, m, l, g, dq, ref_dq
        torch.cuda.empty_cache()
    launches["queries"] = count_delta(co.LAUNCHES_QUERY_PATH, paths)
    want = {"loop": len(LOOP_QUERIES_2G) * len(DX_STORAGES), "chunked": 2 * len(VARIANTS)}
    check(all(launches["queries"][k] == n for k, n in want.items()),
          f"query routes {launches['queries']}, expected {want}")
    return {"errors": errs, "launches": launches}


# ---------------------------------------------------------------- phase 3

@contextlib.contextmanager
def plain_coattention(rel_noise: float = 0.0, seed: int = 0):
    """Route VLFAN's pooling through the plain version under autograd, also
    on the card, bag by bag under activation checkpointing (one bag's
    intermediates at a time: with a feature projecter the features need a
    gradient at the training bucket); with `rel_noise`, its output times
    (1 + rel_noise * z), z ~ N(0, 1) drawn from `seed`."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from vlsa_tpu_torch.models import mil
    from vlsa_tpu_torch.ops.coattn import coattn_pool_reference

    def pool(q, x, mask, scale, x_scale=None, x_inv=None):
        out = torch.cat([checkpoint(coattn_pool_reference, q, x[i:i + 1], mask[i:i + 1], scale,
                                    None if x_scale is None else x_scale[i:i + 1],
                                    use_reentrant=False) for i in range(x.shape[0])])
        if rel_noise:
            gen = torch.Generator(device=out.device).manual_seed(seed)
            out = out * (1 + rel_noise * torch.randn(out.shape, generator=gen,
                                                     device=out.device))
        return out
    kernel_pool = mil.coattn_pool
    mil.coattn_pool = pool
    try:
        yield
    finally:
        mil.coattn_pool = kernel_pool


def phase_serving(torch, co, device):
    import numpy as np
    from vlsa_tpu_torch.config import serving_config
    from vlsa_tpu_torch.models.vlsa_build import build_vlsa_from_config
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags

    cfg = serving_config(FLAGSHIP_CFG)
    t0 = time.perf_counter()
    model, _tok = build_vlsa_from_config(cfg, device=device)
    build_s = time.perf_counter() - t0
    tower = model.prompt_encoder
    log(f"flagship built in {build_s:.1f} s: tower width {tower.width}, "
        f"{len(tower.resblocks)} layers, {sum(p.numel() for p in model.parameters())} "
        f"parameters, text trim {model.text_trim_len}")
    engines = {}
    requests = []
    r = 0
    for feats_dtype, inv, count in SERVED:
        key = (feats_dtype, inv)
        engines[key] = InferEngine(model, feats_dtype=feats_dtype, precompute_inv=inv)
        for _ in range(count):
            requests.append((key, request_bags(cfg["path_patch"], r, BAGS_PER_REQUEST)))
            r += 1
    t0 = time.perf_counter()
    for e in engines.values():
        e.text_precompute()
    torch.cuda.synchronize()
    text_ms = 1e3 * (time.perf_counter() - t0) / len(engines)

    # ---- the main path: every launch counter from 0 ----
    # a request's time = host prep (padding, bf16 rounding or int8
    # quantization, copy to the card) + the model on the card
    co.reset_launches()
    batches, outputs, prep_ms, forward_ms = [], [], [], []
    for key, bags in requests:
        t = time.perf_counter()
        batch = engines[key].prepare(bags)
        torch.cuda.synchronize()
        t_mid = time.perf_counter()
        out = engines[key].forward(batch)
        torch.cuda.synchronize()
        prep_ms.append(1e3 * (t_mid - t))
        forward_ms.append(1e3 * (time.perf_counter() - t_mid))
        batches.append((key, batch))
        outputs.append(out)
    launches = dict(co.LAUNCHES)
    log(f"main path: {len(batches)} requests, kernel launches {launches}")

    expected = {v: 0 for v in VARIANTS}
    for (feats_dtype, inv), _b in batches:
        expected[co.variant_name(
            {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "int8": torch.int8}[feats_dtype], inv)] += 1
    check(launches == expected, f"launch counts {launches}, expected {expected}")
    check(all(n > 0 for n in launches.values()), "a kernel variant was never launched")

    worst = 0.0
    by_mode = {}
    with plain_coattention():
        for (key, batch), out, p_ms, f_ms in zip(batches, outputs, prep_ms, forward_ms):
            probs = out["probs"]
            check(tuple(probs.shape) == (BAGS_PER_REQUEST, 12), f"probs shape {probs.shape}")
            check(bool(torch.isfinite(out["logits"]).all()), "non-finite logits")
            sums = probs.sum(-1)
            check(float((sums - 1).abs().max()) <= 1e-5, "probabilities do not sum to 1")
            plain = engines[key].forward(batch)["probs"]
            dev = float((probs - plain).abs().max())
            worst = max(worst, dev)
            check(dev <= 1e-3, f"{key}: kernel and plain probabilities differ by {dev:.3e}")
            mode = f"{key[0]}{'_inv' if key[1] else ''}"
            rec = by_mode.setdefault(mode, {"requests": 0, "prep": [], "forward": [],
                                            "max_prob_dev": 0.0})
            rec["requests"] += 1
            rec["prep"].append(p_ms)
            rec["forward"].append(f_ms)
            by_mode[mode]["max_prob_dev"] = max(by_mode[mode]["max_prob_dev"], dev)
    check(sum(co.LAUNCHES.values()) == sum(launches.values()),
          "the plain run launched the kernel")
    for mode, rec in by_mode.items():
        rec["median_prep_ms"] = float(np.median(rec.pop("prep")))
        rec["median_forward_ms"] = float(np.median(rec.pop("forward")))
        log(f"served {mode:13s} {rec['requests']} requests of {BAGS_PER_REQUEST} bags: median "
            f"host prep {rec['median_prep_ms']:.1f} ms + model {rec['median_forward_ms']:.2f} ms,"
            f" max |p_kernel - p_plain| {rec['max_prob_dev']:.2e}")
    max_n = max(int(b["mask"].shape[1]) for _k, b in batches)
    return {"build_s": build_s, "text_precompute_ms": text_ms, "launches": launches,
            "max_prob_dev": worst, "by_mode": by_mode, "max_patches": max_n}


# ---------------------------------------------------------------- phase 3b

def inv_norms(torch, feats):
    """1/||x|| of the stored rows [B, N] f32 (0 for zero rows), bag by bag."""
    rows = []
    for f in feats:
        sq = (f.float() ** 2).sum(-1)
        rows.append(torch.where(sq > 0, sq.clamp_min(1e-30).rsqrt(), torch.zeros_like(sq)))
    return torch.stack(rows).contiguous()


@contextlib.contextmanager
def f32_text_tower(torch, tower):
    """Compute the frozen text tower in f32 (its bf16-stored weights upcast).
    In bf16 compute every matmul operand of the backward is rounded to bf16,
    so a change of the co-attention output at the size of f32 rounding moves
    the prompt embeddings' gradient by bf16 rounding flips
    (`phase_training` measures it); only an f32 tower lets the gradients
    tell the kernel from the plain version at TOL_GRAD."""
    mods = [m for m in tower.modules() if hasattr(m, "compute_dtype")]
    saved = [m.compute_dtype for m in mods]
    for m in mods:
        m.compute_dtype = torch.float32
    try:
        yield
    finally:
        for m, dtype in zip(mods, saved):
            m.compute_dtype = dtype


def param_grads(torch, model, engine, batch):
    model.zero_grad(set_to_none=True)
    loss, _raw = engine.loss(batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return grads


def grad_devs(a: dict, b: dict, leaves) -> dict:
    """max|a-b| / max|b| per gradient leaf; both must hold exactly `leaves`."""
    check(set(a) == set(b) == set(leaves),
          f"gradient leaves {sorted(a)} and {sorted(b)}, expected {sorted(leaves)}")
    return {n: float((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30)) for n in b}


def profile_step(torch, engine, batch, family="coattn", groups=None):
    """Wall time of one training step under torch.profiler, the device time of
    all its kernels and of the kernels whose name holds `family`, each such
    kernel's ms and launches by name (None if the profiler shows no device
    time); with
    `groups` ({name: regex}), the device time of each group's kernels (the
    first group whose regex a kernel's name matches; "other" the rest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    warm = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a fresh trace can miss its first kernels (the SA forward went
        # unrecorded so): a few tiny ones go first, ~2 us each
        for _ in range(16):
            warm.add_(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    total_us = 0.0
    top, by_kernel, counts = [], {}, {}
    by_group = dict.fromkeys([*groups, "other"], 0.0) if groups else {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        total_us += us
        if family in evt.key:  # the longest name, past a namespace of the family's name
            name = max(re.findall(rf"{family}\w*", evt.key), key=len)
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
            counts[name] = counts.get(name, 0) + evt.count
        if groups:
            g = next((g for g, rx in groups.items() if re.search(rx, evt.key)), "other")
            by_group[g] += us / 1e3
        top.append((us, evt.key[:80]))
    top.sort(reverse=True)
    key = f"{family}_ms"
    if total_us == 0:
        return {"wall_ms": wall_ms, "device_ms": None, key: None, "kernels": {}, "counts": {},
                "top": [], "groups": {}}
    return {"wall_ms": wall_ms, "device_ms": total_us / 1e3, key: sum(by_kernel.values()),
            "kernels": by_kernel, "counts": counts, "groups": by_group,
            "top": [{"kernel": k, "ms": us / 1e3} for us, k in top[:8]]}


def phase_training(torch, co, device):
    import numpy as np
    from vlsa_tpu_torch.config import training_config
    from vlsa_tpu_torch.runner.train import Trainer

    cfg = training_config(TRAIN_CFG, fold=0)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device)
    build_s = time.perf_counter() - t0
    model, engine, batcher = trainer.model, trainer.engine, trainer.batcher
    batcher.prefetch = 0  # the storage changes between steps: each batch built on demand
    check(trainer.meta.num_bins == 12, f"fold 0 gives {trainer.meta.num_bins} bins, not 12")
    tower = model.prompt_encoder
    tower0 = {k: v.detach().clone() for k, v in tower.state_dict().items()}
    learnable = [n for n, p in model.named_parameters() if p.requires_grad]
    check(all(any(n.startswith(prefix) for n in learnable) for prefix in LEARNABLE)
          and not any(n.startswith("prompt_encoder.") for n in learnable),
          f"unexpected learnable parameters {learnable}")
    log(f"trainer built in {build_s:.1f} s: {len(trainer.dataset)} training patients, "
        f"{trainer.meta.num_bins} bins, {len(learnable)} learnable tensors, "
        f"tower width {tower.width} ({next(iter(tower.resblocks)).c_fc_weight.dtype})")

    # ---- the main path: every launch counter from 0 ----
    batches = trainer.batches()
    co.reset_launches()
    steps, expected = [], {v: 0 for v in VARIANTS}
    last_batch = {}  # variant -> its last batch on the main path
    for feats_dtype, with_inv, count in TRAIN_STEPS:
        batcher.feats_dtype = feats_dtype
        batcher.precompute_inv = with_inv
        for _ in range(count):
            t = time.perf_counter()
            batch = {k: v.to(device) for k, v in next(batches).items()}
            if with_inv and feats_dtype != "int8":
                batch["feats_inv"] = inv_norms(torch, batch["feats"])
            torch.cuda.synchronize()
            t_mid = time.perf_counter()
            before = {n: p.detach().clone() for n, p in model.named_parameters()
                      if p.requires_grad}
            t_step = time.perf_counter()
            loss, raw = engine.train_step(batch)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t_step)
            variant = co.variant_name(batch["feats"].dtype, "feats_inv" in batch)
            expected[variant] += 1
            last_batch[variant] = batch
            rec = {"variant": variant, "loss": float(loss), "bags": int(batch["valid"].sum()),
                   "bucket": int(batch["mask"].shape[1]),
                   "patches": int(batch["mask"].sum()),
                   "prep_ms": 1e3 * (t_mid - t), "step_ms": step_ms}
            check(bool(np.isfinite(rec["loss"])) and bool(torch.isfinite(raw).all()),
                  f"step {len(steps)} ({variant}): non-finite loss or logits")
            check(all(torch.equal(v, tower0[k]) for k, v in tower.state_dict().items()),
                  f"step {len(steps)} ({variant}): the frozen tower changed")
            still = [n for n, p in model.named_parameters()
                     if p.requires_grad and torch.equal(p.detach(), before[n])]
            check(not still, f"step {len(steps)} ({variant}): {still} did not move")
            steps.append(rec)
            log(f"train step {len(steps) - 1} {variant:9s} loss {rec['loss']:.4f}  "
                f"{rec['bags']} bags, bucket {rec['bucket']}, {rec['patches']} patches: "
                f"host prep {rec['prep_ms']:.0f} ms + step {step_ms:.1f} ms")
    launches = {"fwd": dict(co.LAUNCHES), "bwd": dict(co.LAUNCHES_BWD)}
    log(f"main path: {len(steps)} training steps, launches {launches}")
    check(launches["fwd"] == expected and launches["bwd"] == expected,
          f"training launches {launches}, expected {expected} of each kernel")

    # ---- the gradients through the kernels against the plain co-attention,
    # on the main path's last batch of each variant (32 bags at its bucket) ----
    def kernel_and_plain(batch):
        g_kernel = param_grads(torch, model, engine, batch)
        with plain_coattention():
            g_plain = param_grads(torch, model, engine, batch)
        return grad_devs(g_kernel, g_plain, learnable), g_plain

    # A patient censored in the last bin has 1 - CIF[K-1] = 0 up to f32
    # rounding, so its SurvIFMLE term (vlsa_tpu/losses/surv.py:100 alike) is
    # -log of rounding noise clamped at 1e-7, and its gradient that noise
    # times up to 1e7: a 1e-6 change of the logits flips it.  The check
    # leaves such patients out of `valid`.
    K = trainer.meta.num_bins
    for variant, b in last_batch.items():
        ill = b["valid"] & (b["e"] == 0) & (b["t"] == K - 1)
        last_batch[variant] = dict(b, valid=b["valid"] & ~ill)
    grad_check = {}
    with f32_text_tower(torch, tower):
        for variant, b in last_batch.items():
            dev, _g = kernel_and_plain(b)
            worst = max(dev, key=dev.get)
            grad_check[variant] = {"bucket": int(b["mask"].shape[1]),
                                   "bags": int(b["valid"].sum()), "dev": dev}
            log(f"gradients, kernel vs plain co-attention, {variant} batch: "
                f"{int(b['valid'].sum())} bags (censored in the last bin left out), bucket "
                f"{b['mask'].shape[1]}, text tower in f32: worst {worst} {dev[worst]:.2e} "
                f"(tol {TOL_GRAD:g})")
            check(dev[worst] <= TOL_GRAD, f"{variant}: gradient of {worst} deviates "
                                          f"{dev[worst]:.3e}")
    # with the configured bf16 tower the kernel's gap is held against the
    # gap that a change of the plain output at the size of f32 rounding
    # (1e-7 relative, three draws) makes on its own
    b = last_batch["bf16"]
    dev_bf16_tower, g_plain = kernel_and_plain(b)
    noise = dict.fromkeys(g_plain, 0.0)
    for seed in range(3):
        with plain_coattention(rel_noise=1e-7, seed=seed):
            g_noisy = param_grads(torch, model, engine, b)
        for n, d in grad_devs(g_noisy, g_plain, learnable).items():
            noise[n] = max(noise[n], d)
    del last_batch, b, g_plain, g_noisy
    torch.cuda.empty_cache()
    log("gradients with the bf16 tower, bf16 batch: kernel vs plain | plain vs plain with "
        "1e-7 noise: " + ", ".join(f"{n} {dev_bf16_tower[n]:.1e} | {noise[n]:.1e}"
                                   for n in noise))
    above = {n: d for n, d in dev_bf16_tower.items() if d > max(TOL_GRAD, 4 * noise[n])}
    check(not above, f"with the bf16 tower the kernel's gradients deviate {above}, more "
                     f"than 4x the plain path's own rounding gap {noise}")

    # ---- the text tower's forward + backward, and one profiled step ----
    def text_fb():
        model.forward_text_only().float().sum().backward()
    text_fb_ms = median_ms(torch, text_fb, runs=10)
    model.zero_grad(set_to_none=True)
    batcher.feats_dtype, batcher.precompute_inv = "bfloat16", False
    batch = {k: v.to(device) for k, v in next(batches).items()}
    prof = dict(profile_step(torch, engine, batch), bucket=int(batch["mask"].shape[1]),
                patches=int(batch["mask"].sum()))
    if prof["device_ms"] is None:
        log("profiled step: the profiler shows no device time")
    else:
        log(f"profiled bf16 step (bucket {prof['bucket']}, {prof['patches']} patches): wall "
            f"{prof['wall_ms']:.1f} ms, kernels on the card {prof['device_ms']:.2f} ms, of "
            f"which co-attention {prof['coattn_ms']:.2f} ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(prof["kernels"].items())))
    log(f"text tower forward + backward: {text_fb_ms:.2f} ms")
    bf16 = [r for r in steps if r["variant"] == "bf16"]
    return {"build_s": build_s, "steps": steps, "launches": launches, "grad_check": grad_check,
            "grad_dev_bf16_tower": dev_bf16_tower, "grad_noise_bf16_tower": noise,
            "text_fb_ms": text_fb_ms, "profiled_step": prof,
            "median_bf16_prep_ms": float(np.median([r["prep_ms"] for r in bf16])),
            "median_bf16_step_ms": float(np.median([r["step_ms"] for r in bf16]))}


# ---------------------------------------------------------------- phase 3c

@contextlib.contextmanager
def plain_abmil():
    """Route DeepMIL's ABMIL pooling through the plain versions of both
    kernels (`abmil_fwd_reference`, and `abmil_bwd_reference` as the
    backward), bag by bag to bound their memory, also on the card."""
    import torch
    from vlsa_tpu_torch.models import layers
    from vlsa_tpu_torch.ops import abmil as ab

    def rows(t, i):
        return None if t is None else t[i:i + 1]

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, x_scale, mask, w1, b1, w2):
            parts = [ab.abmil_fwd_reference(x[i:i + 1], mask[i:i + 1], w1, b1, w2,
                                            x_scale=rows(x_scale, i))
                     for i in range(x.shape[0])]
            out, m, l = (torch.cat(t) for t in zip(*parts))
            ctx.save_for_backward(x, x_scale, mask, w1, b1, w2, out, m, l)
            return out

        @staticmethod
        def backward(ctx, g):
            x, x_scale, mask, w1, b1, w2, out, m, l = ctx.saved_tensors
            need_dx = ctx.needs_input_grad[0]
            dxs, sums = [], None
            for i in range(x.shape[0]):
                dx, *dw = ab.abmil_bwd_reference(
                    x[i:i + 1], mask[i:i + 1], w1, b1, w2, g[i:i + 1], out[i:i + 1],
                    m[i:i + 1], l[i:i + 1], x_scale=rows(x_scale, i), need_dx=need_dx)
                dxs.append(dx)
                sums = dw if sums is None else [a + b for a, b in zip(sums, dw)]
            return (torch.cat(dxs) if need_dx else None, None, None, *sums)

    def pool(x, mask, w1, b1, w2, b2=None, x_scale=None):
        return Plain.apply(x, x_scale, mask, w1, b1, w2)
    kernel_pool = layers.abmil_pool
    layers.abmil_pool = pool
    try:
        yield
    finally:
        layers.abmil_pool = kernel_pool


def phase_sa_serving(torch, ab, co, device):
    import numpy as np
    from vlsa_tpu_torch.runner import sa
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags, sa_serving_config

    cfg = sa_serving_config(SA_CFG)
    check(cfg["net_dims"] == "512-256-12", f"SA net_dims {cfg['net_dims']}, not 512-256-12")
    t0 = time.perf_counter()
    model = sa.build_model(cfg, device=device)
    build_s = time.perf_counter() - t0
    log(f"SA model built in {build_s:.2f} s: {sum(p.numel() for p in model.parameters())} "
        f"parameters, net_dims {cfg['net_dims']}")
    engines = {dt: InferEngine(model, feats_dtype=dt, precompute_inv=False)
               for dt, _n in SA_SERVED}
    requests, r = [], 0
    for dt, count in SA_SERVED:
        for _ in range(count):
            requests.append((dt, request_bags(cfg["path_patch"], r, BAGS_PER_REQUEST)))
            r += 1

    # ---- the main path: every launch counter from 0 ----
    ab.reset_launches()
    co.reset_launches()
    batches, outputs, prep_ms, forward_ms = [], [], [], []
    for dt, bags in requests:
        t = time.perf_counter()
        batch = engines[dt].prepare(bags)
        torch.cuda.synchronize()
        t_mid = time.perf_counter()
        out = engines[dt].forward(batch)
        torch.cuda.synchronize()
        prep_ms.append(1e3 * (t_mid - t))
        forward_ms.append(1e3 * (time.perf_counter() - t_mid))
        batches.append((dt, batch))
        outputs.append(out)
    launches = dict(ab.LAUNCHES)
    log(f"SA main path: {len(batches)} requests, ABMIL launches {launches}")
    expected = {"f32": 0, "bf16": 0, "int8": 0}
    for dt, count in SA_SERVED:
        expected[{"float32": "f32", "bfloat16": "bf16", "int8": "int8"}[dt]] += count
    check(launches == expected, f"SA launch counts {launches}, expected {expected}")
    check(sum(ab.LAUNCHES_BWD.values()) == 0 and sum(co.LAUNCHES.values()) == 0,
          "SA serving launched a backward or a co-attention kernel")

    worst, by_mode = 0.0, {}
    with plain_abmil():
        for (dt, batch), out, p_ms, f_ms in zip(batches, outputs, prep_ms, forward_ms):
            probs = out["probs"]
            check(tuple(probs.shape) == (BAGS_PER_REQUEST, 12), f"SA probs shape {probs.shape}")
            check(bool(torch.isfinite(out["logits"]).all()), "SA: non-finite logits")
            check(float((probs.sum(-1) - 1).abs().max()) <= 1e-5,
                  "SA: probabilities do not sum to 1")
            dev = float((probs - engines[dt].forward(batch)["probs"]).abs().max())
            worst = max(worst, dev)
            check(dev <= 1e-3, f"SA {dt}: kernel and plain probabilities differ by {dev:.3e}")
            rec = by_mode.setdefault(dt, {"requests": 0, "prep": [], "forward": [],
                                          "max_prob_dev": 0.0})
            rec["requests"] += 1
            rec["prep"].append(p_ms)
            rec["forward"].append(f_ms)
            rec["max_prob_dev"] = max(rec["max_prob_dev"], dev)
    check(dict(ab.LAUNCHES) == launches, "the plain run launched an ABMIL kernel")
    for dt, rec in by_mode.items():
        rec["median_prep_ms"] = float(np.median(rec.pop("prep")))
        rec["median_forward_ms"] = float(np.median(rec.pop("forward")))
        log(f"SA served {dt:8s} {rec['requests']} requests of {BAGS_PER_REQUEST} bags: median "
            f"host prep {rec['median_prep_ms']:.1f} ms + model {rec['median_forward_ms']:.2f} ms,"
            f" max |p_kernel - p_plain| {rec['max_prob_dev']:.2e}")
    return {"build_s": build_s, "launches": launches, "max_prob_dev": worst,
            "by_mode": by_mode, "max_patches": max(int(b["mask"].shape[1]) for _d, b in batches)}


# ---------------------------------------------------------------- phase 3d

def phase_sa_training(torch, ab, co, device):
    import numpy as np
    from vlsa_tpu_torch.config import training_config
    from vlsa_tpu_torch.runner.train import Trainer

    trainers = {}
    t0 = time.perf_counter()
    for proj in (False, True):
        cfg = training_config(dict(SA_CFG, deepmil_use_feat_proj=proj), fold=0)
        trainers[proj] = Trainer(cfg, device)
        # the storage changes between steps: each batch built on demand
        trainers[proj].batcher.prefetch = 0
        check(trainers[proj].meta.num_bins == 12 and cfg["net_dims"] == "512-256-12",
              f"SA fold 0: {trainers[proj].meta.num_bins} bins, net_dims {cfg['net_dims']}")
    build_s = time.perf_counter() - t0
    log(f"SA trainers built in {build_s:.1f} s: {len(trainers[False].dataset)} training "
        f"patients; parameters {[n for n, _p in trainers[True].model.named_parameters()]}")
    batches = {proj: tr.batches() for proj, tr in trainers.items()}

    # ---- the main path: every launch counter from 0 ----
    ab.reset_launches()
    co.reset_launches()
    steps, last_batch = [], {}
    exp_fwd, exp_bwd = dict.fromkeys(ab.LAUNCHES, 0), dict.fromkeys(ab.LAUNCHES_BWD, 0)
    for feats_dtype, proj, count in SA_TRAIN_STEPS:
        tr = trainers[proj]
        tr.batcher.feats_dtype = feats_dtype
        for _ in range(count):
            t = time.perf_counter()
            batch = {k: v.to(device) for k, v in next(batches[proj]).items()}
            torch.cuda.synchronize()
            t_mid = time.perf_counter()
            before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
            loss, raw = tr.engine.train_step(batch)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t_mid)
            dtype = batch["feats"].dtype
            variant = ab.bwd_variant(dtype, proj)
            exp_fwd[variant.split("_")[0]] += 1
            exp_bwd[variant] += 1
            last_batch[variant] = (proj, batch)
            rec = {"variant": variant, "loss": float(loss), "bags": int(batch["valid"].sum()),
                   "bucket": int(batch["mask"].shape[1]), "patches": int(batch["mask"].sum()),
                   "prep_ms": 1e3 * (t_mid - t), "step_ms": step_ms}
            check(bool(np.isfinite(rec["loss"])) and bool(torch.isfinite(raw).all()),
                  f"SA step {len(steps)} ({variant}): non-finite loss or logits")
            for n, p in tr.model.named_parameters():
                moved = not torch.equal(p.detach(), before[n])
                # fc2's bias cancels in the softmax: no gradient, no decay
                check(moved != (n == "sigma.fc2_bias"), f"SA step {len(steps)} ({variant}): "
                                                        f"{n} {'moved' if moved else 'stayed'}")
            steps.append(rec)
            log(f"SA train step {len(steps) - 1} {variant:8s} loss {rec['loss']:.4f}  "
                f"{rec['bags']} bags, bucket {rec['bucket']}, {rec['patches']} patches: "
                f"host prep {rec['prep_ms']:.0f} ms + step {step_ms:.1f} ms")
    launches = {"fwd": dict(ab.LAUNCHES), "bwd": dict(ab.LAUNCHES_BWD)}
    log(f"SA main path: {len(steps)} training steps, ABMIL launches {launches}")
    check(launches == {"fwd": exp_fwd, "bwd": exp_bwd},
          f"SA training launches {launches}, expected {exp_fwd} and {exp_bwd}")
    check(sum(co.LAUNCHES.values()) + sum(co.LAUNCHES_BWD.values()) == 0,
          "SA training launched a co-attention kernel")

    # ---- gradients through the kernels against the plain versions, on the
    # main path's last batch of each variant; the patients censored in the
    # last bin are left out of `valid` (see phase_training) ----
    grad_check, K = {}, trainers[False].meta.num_bins
    for variant, (proj, b) in last_batch.items():
        ill = b["valid"] & (b["e"] == 0) & (b["t"] == K - 1)
        b = dict(b, valid=b["valid"] & ~ill)
        tr = trainers[proj]
        g_kernel = param_grads(torch, tr.model, tr.engine, b)
        with plain_abmil():
            g_plain = param_grads(torch, tr.model, tr.engine, b)
        # fc2's bias cancels in the softmax: every other parameter has a gradient
        dev = grad_devs(g_kernel, g_plain, [n for n, _p in tr.model.named_parameters()
                                            if n != "sigma.fc2_bias"])
        worst = max(dev, key=dev.get)
        grad_check[variant] = {"bucket": int(b["mask"].shape[1]), "bags": int(b["valid"].sum()),
                               "dev": dev}
        log(f"SA gradients, kernels vs plain, {variant} batch: {int(b['valid'].sum())} bags, "
            f"bucket {b['mask'].shape[1]}: worst {worst} {dev[worst]:.2e} (tol {TOL_GRAD:g})")
        check(dev[worst] <= TOL_GRAD, f"SA {variant}: gradient of {worst} deviates "
                                      f"{dev[worst]:.3e}")
        del g_kernel, g_plain
    del last_batch
    torch.cuda.empty_cache()

    # one profiled step each in bf16 and in f32 (the shipped config's
    # storage), with the step's peak device memory
    tr, profiled = trainers[False], {}
    for feats_dtype in ("bfloat16", "float32"):
        tr.batcher.feats_dtype = feats_dtype
        batch = {k: v.to(device) for k, v in next(batches[False]).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = dict(profile_step(torch, tr.engine, batch, family="abmil"),
                    bucket=int(batch["mask"].shape[1]), patches=int(batch["mask"].sum()),
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        profiled[feats_dtype] = prof
        del batch
        if prof["device_ms"] is None:
            log(f"SA profiled {feats_dtype} step: the profiler shows no device time")
        else:
            log(f"SA profiled {feats_dtype} step (bucket {prof['bucket']}, {prof['patches']} "
                f"patches): wall {prof['wall_ms']:.1f} ms, kernels on the card "
                f"{prof['device_ms']:.2f} ms, of which ABMIL {prof['abmil_ms']:.2f} ms "
                f"({100 * prof['abmil_ms'] / prof['device_ms']:.0f}%): {prof['kernels']}; "
                f"peak device memory {prof['peak_gb']:.2f} GB")
    bf16 = [r for r in steps if r["variant"] == "bf16"]
    return {"build_s": build_s, "steps": steps, "launches": launches,
            "grad_check": grad_check, "profiled_step": profiled["bfloat16"],
            "profiled_step_f32": profiled["float32"],
            "median_bf16_prep_ms": float(np.median([r["prep_ms"] for r in bf16])),
            "median_bf16_step_ms": float(np.median([r["step_ms"] for r in bf16]))}


# ---------------------------------------------------------------- phase 3e

@contextlib.contextmanager
def plain_flash():
    """Route the ViT trunk's attention through the plain version, also on
    the card."""
    from vlsa_tpu_torch.models import vision_tower
    from vlsa_tpu_torch.ops.flash_attn import flash_self_attention_reference
    kernel_attention = vision_tower.flash_self_attention
    vision_tower.flash_self_attention = flash_self_attention_reference
    try:
        yield
    finally:
        vision_tower.flash_self_attention = kernel_attention


class OnePatient:
    """A label table of one patient "p0" holding `sids` (what SurvBagDataset
    asks of MetaSurvData)."""

    def __init__(self, sids):
        self.sids = list(sids)

    def collect_info_by_pids(self, pids):
        return list(pids), {"p0": self.sids}, {"p0": [0, 1]}


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def tf32_rounded(torch, t):
    """f32 `t` rounded to TF32 (10 mantissa bits, to nearest even), as one
    TF32 tensor-core pass takes its operands."""
    b = t.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


def write_tile_slides(src, rng):
    """EXTRACT_TILES slides of random EXTRACT_TILE_PX u8 tiles as
    `<src>/slide<i>.npy`; returns slide 0's tiles."""
    import numpy as np
    os.makedirs(src)
    for i, n in enumerate(EXTRACT_TILES):
        np.save(os.path.join(src, f"slide{i}.npy"), rng.integers(
            0, 256, size=(n, EXTRACT_TILE_PX, EXTRACT_TILE_PX, 3), dtype=np.uint8))
    return np.load(os.path.join(src, "slide0.npy"))


def phase_extraction(torch, fa, ab, co, device):
    """CONCH feature extraction at full width through the port's entry
    points: two synthetic slides of 512x512 u8 tiles to .npy and .q8npz
    stores (bf16, device preprocessing, batch 64), one batch in f32, then
    the checks, the tower's time per batch and one profiled batch."""
    import types
    import numpy as np
    from vlsa_tpu_torch.data.bags import SurvBagDataset, read_patch_data
    from vlsa_tpu_torch.data.extract import FeatureExtractor, extract_to_store
    from vlsa_tpu_torch.data.quant import quantize_feats_int8
    from vlsa_tpu_torch.data.transforms import center_crop, preprocess_tile, resize_shortest_edge
    from vlsa_tpu_torch.data.transforms_device import build_device_preprocess

    t0 = time.perf_counter()
    ex = FeatureExtractor(image_size=448, batch_size=64, compute_dtype="bfloat16", seed=0,
                          device=device)
    ex32 = FeatureExtractor(image_size=448, batch_size=64, compute_dtype="float32", seed=0,
                            device=device)
    build_s = time.perf_counter() - t0
    layers = ex.model.trunk.layers
    check(ex._device_preprocess and ex.feat_dim == 512 and layers == 12,
          "the extractor is not CONCH at full width with device preprocessing")
    log(f"extractors built in {build_s:.1f} s: {sum(p.numel() for p in ex.model.parameters())} "
        f"parameters, {layers} layers, image 448, batch 64")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_extract_") as tmp:
        src = os.path.join(tmp, "tiles")
        tiles0 = write_tile_slides(src, np.random.default_rng(0))
        sids = [f"slide{i}" for i in range(len(EXTRACT_TILES))]
        batch = tiles0[:64]

        # ---- the main path: every launch counter from 0 ----
        for kernels in (fa, ab, co):
            kernels.reset_launches()
        runs = {}
        for fmt in ("npy", "q8npz"):
            runs[fmt] = extract_to_store(src, os.path.join(tmp, fmt), ex, fmt=fmt, verbose=False)
        feats32 = ex32.extract(batch)  # one batch of the --dtype float32 path
        launches, path_launches = dict(fa.LAUNCHES), dict(fa.LAUNCHES_PATH)
        n_batches = sum(-(-n // 64) for n in EXTRACT_TILES)
        expected = {"bf16": 2 * layers * n_batches, "f32": layers}
        log(f"extraction main path: {sum(EXTRACT_TILES)} tiles of {EXTRACT_TILE_PX} px to .npy "
            f"({runs['npy']['tiles_per_sec']:.1f} tiles/s, the first run) and .q8npz "
            f"({runs['q8npz']['tiles_per_sec']:.1f} tiles/s), one f32 batch; flash launches "
            f"{launches}, bf16 by path {path_launches}")
        check(launches == expected, f"flash launches {launches}, expected {expected}")
        L = 1 + (448 // ex.model.trunk.patch_size) ** 2
        plan = fa.flash_plan(L)[0]
        check(path_launches == {p: expected["bf16"] if p == plan else 0 for p in path_launches},
              f"bf16 flash launches by path {path_launches}: all {expected['bf16']} should take "
              f"{plan}, the path of flash_plan({L})")
        check(sum(ab.LAUNCHES.values()) + sum(ab.LAUNCHES_BWD.values())
              + sum(co.LAUNCHES.values()) + sum(co.LAUNCHES_BWD.values()) == 0,
              "extraction launched an ABMIL or co-attention kernel")
        for fmt, stats in runs.items():
            check(stats["slides"] == 2 and stats["tiles"] == sum(EXTRACT_TILES)
                  and stats["empty"] == 0, f"{fmt} run: {stats}")

        # ---- the stores, read back as training reads them ----
        feats = {s: read_patch_data(os.path.join(tmp, "npy", f"{s}.npy")) for s in sids}
        for s, n in zip(sids, EXTRACT_TILES):
            check(feats[s].shape == (n, 512) and bool(np.isfinite(feats[s]).all()),
                  f"{s}: features {feats[s].shape}, finite {np.isfinite(feats[s]).all()}")
        every = np.concatenate([feats[s] for s in sids])
        bag, _label = SurvBagDataset(["p0"], os.path.join(tmp, "npy"), OnePatient(sids),
                                     read_format="npy")[0]
        check(np.array_equal(bag, every), "the .npy bag differs from the stores")
        bag8, _label = SurvBagDataset(["p0"], os.path.join(tmp, "q8npz"), OnePatient(sids),
                                      read_format="q8npz")[0]
        q, scale = quantize_feats_int8(every)
        q8_dev = float(np.abs(bag8.dequantize() - q.astype(np.float32) * scale[:, None]).max())
        log(f"stores read back through SurvBagDataset: .npy {bag.shape} exact; .q8npz "
            f"{bag8.shape}, max |stored - quantized .npy features| {q8_dev:.3e}")
        check(q8_dev <= float(scale.max()), f".q8npz bag deviates {q8_dev} from the .npy one")

        # ---- features against the same run with the plain attention ----
        with plain_flash():
            plain = ex.extract(tiles0)
            plain32 = ex32.extract(batch)
        check(dict(fa.LAUNCHES) == launches and dict(fa.LAUNCHES_PATH) == path_launches,
              "the plain run launched the flash kernel")
        feat_err = {"bf16": rel_err(torch.from_numpy(feats["slide0"]), torch.from_numpy(plain)),
                    "f32": rel_err(torch.from_numpy(feats32), torch.from_numpy(plain32))}
        bf16_vs_f32 = rel_err(torch.from_numpy(feats["slide0"][:64]), torch.from_numpy(feats32))
        log(f"features, flash kernel vs plain attention (max|a-b| / max|b|): bf16 "
            f"{feat_err['bf16']:.3e} (tol {TOL_FEATS['bf16']:g}), f32 {feat_err['f32']:.3e} "
            f"(tol {TOL_FEATS['f32']:g}); bf16 vs f32 compute {bf16_vs_f32:.3e}")
        for v, e in feat_err.items():
            check(e <= TOL_FEATS[v], f"{v} features deviate {e:.3e} from the plain attention's")

    # ---- device preprocessing against the host stack ----
    few = tiles0[:4]
    got_u8 = build_device_preprocess((EXTRACT_TILE_PX,) * 2, 448, normalize=False)(
        torch.from_numpy(few).to(device)).cpu().numpy()
    want_u8 = np.stack([center_crop(resize_shortest_edge(t, 448), 448) for t in few])
    got = build_device_preprocess((EXTRACT_TILE_PX,) * 2, 448)(
        torch.from_numpy(few).to(device)).cpu().numpy()
    want = np.stack([preprocess_tile(t, 448) for t in few])
    u8_exact, norm_dev = bool(np.array_equal(got_u8, want_u8)), float(np.abs(got - want).max())
    norm_ulp = float((np.abs(got - want) / np.spacing(np.abs(want))).max())
    log(f"device preprocessing of {len(few)} tiles 512 -> 448 vs the host stack: u8 byte-exact "
        f"{u8_exact}, normalize within {norm_ulp:g} ulp, max|dev| {norm_dev:.3e}")
    check(u8_exact and got.shape == want.shape and norm_ulp <= 1,
          f"device preprocessing: u8 exact {u8_exact}, normalize off by {norm_ulp:g} ulp")

    # ---- the tower's time per batch, and one profiled batch ----
    x = build_device_preprocess((EXTRACT_TILE_PX,) * 2, 448)(torch.from_numpy(batch).to(device))

    def tower():
        with torch.inference_mode():
            return ex.model.forward_no_head(x)
    tower_ms = median_ms(torch, tower, runs=10, warmup=2)
    prof = profile_step(torch, types.SimpleNamespace(train_step=ex.extract), batch,
                        family="flash_fwd", groups=PROFILE_GROUPS)
    if prof["device_ms"] is None:
        log("profiled batch: the profiler shows no device time")
    else:
        log(f"profiled batch of 64 tiles (u8 copy, preprocessing, tower, read-back): wall "
            f"{prof['wall_ms']:.1f} ms, kernels on the card {prof['device_ms']:.2f} ms: "
            + ", ".join(f"{g} {ms:.2f}" for g, ms in prof["groups"].items())
            + f" ms; top {prof['top']}")
    log(f"tower forward, batch 64 bf16 (CUDA events, median of 10): {tower_ms:.2f} ms, "
        f"{64e3 / tower_ms:.0f} tiles/s")
    return {"build_s": build_s, "launches": launches, "path_launches": path_launches,
            "runs": runs, "q8_dev": q8_dev,
            "feat_err": feat_err, "bf16_vs_f32": bf16_vs_f32, "preprocess_u8_exact": u8_exact,
            "preprocess_norm_dev": norm_dev, "preprocess_norm_ulp": norm_ulp, "tower_ms": tower_ms, "profiled_batch": prof}


def phase_extraction_512(torch, fa, ab, co, device):
    """CONCH at full width at 512 px (L = 1025), the path of `python -m
    vlsa_tpu_torch.runner.extract --image_size 512`: one synthetic slide of
    EXTRACT_512_TILES 512x512 u8 tiles (a ragged last batch) through
    `extract_to_store` in bf16, batch 64, device preprocessing; the flash
    launches by path (12 a batch, on the path of flash_plan(1025)); the
    features against the same run through the plain attention; tiles/s and
    the tower's time per batch."""
    import numpy as np
    from vlsa_tpu_torch.data.bags import read_patch_data
    from vlsa_tpu_torch.data.extract import FeatureExtractor, extract_to_store
    from vlsa_tpu_torch.data.transforms_device import build_device_preprocess

    ex = FeatureExtractor(image_size=512, batch_size=64, compute_dtype="bfloat16", seed=0,
                          device=device)
    layers = ex.model.trunk.layers
    L = 1 + (512 // ex.model.trunk.patch_size) ** 2
    check(ex._device_preprocess and ex.feat_dim == 512 and layers == 12 and L == 1025,
          f"the 512-px extractor is not CONCH at full width (L={L}, {layers} layers)")
    plan = fa.flash_plan(L)[0]
    n_batches = -(-EXTRACT_512_TILES // 64)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_extract512_") as tmp:
        src = os.path.join(tmp, "tiles")
        os.makedirs(src)
        rng = np.random.default_rng(1)
        tiles = rng.integers(0, 256, size=(EXTRACT_512_TILES, EXTRACT_TILE_PX, EXTRACT_TILE_PX, 3),
                             dtype=np.uint8)
        np.save(os.path.join(src, "slide512.npy"), tiles)

        # ---- the main path: every launch counter from 0 ----
        for kernels in (fa, ab, co):
            kernels.reset_launches()
        stats = extract_to_store(src, os.path.join(tmp, "npy"), ex, fmt="npy", verbose=False)
        launches, path_launches = dict(fa.LAUNCHES), dict(fa.LAUNCHES_PATH)
        expected = layers * n_batches
        log(f"extraction at 512 px (L={L}): {EXTRACT_512_TILES} tiles to .npy in {n_batches} "
            f"batches ({stats['tiles_per_sec']:.1f} tiles/s); flash launches {launches}, bf16 by "
            f"path {path_launches}")
        check(launches == {"bf16": expected, "f32": 0}, f"flash launches {launches}, expected "
                                                        f"{expected} bf16")
        check(path_launches == {p: expected if p == plan else 0 for p in path_launches},
              f"bf16 flash launches by path {path_launches}: all {expected} should take {plan}, "
              f"the path of flash_plan({L})")
        check(sum(ab.LAUNCHES.values()) + sum(ab.LAUNCHES_BWD.values())
              + sum(co.LAUNCHES.values()) + sum(co.LAUNCHES_BWD.values()) == 0,
              "extraction launched an ABMIL or co-attention kernel")
        check(stats["slides"] == 1 and stats["tiles"] == EXTRACT_512_TILES and stats["empty"] == 0,
              f"512-px run: {stats}")
        feats = read_patch_data(os.path.join(tmp, "npy", "slide512.npy"))
        check(feats.shape == (EXTRACT_512_TILES, 512) and bool(np.isfinite(feats).all()),
              f"512-px features {feats.shape}, finite {np.isfinite(feats).all()}")
        with plain_flash():
            plain = ex.extract(tiles)
        feat_err = rel_err(torch.from_numpy(feats), torch.from_numpy(plain))
        log(f"512-px features, flash kernel vs plain attention (max|a-b| / max|b|): "
            f"{feat_err:.3e} (tol {TOL_FEATS['bf16']:g})")
        check(feat_err <= TOL_FEATS["bf16"], f"512-px features deviate {feat_err:.3e} from the "
                                             f"plain attention's")

    x = build_device_preprocess((EXTRACT_TILE_PX,) * 2, 512)(
        torch.from_numpy(tiles[:64]).to(device))

    def tower():
        with torch.inference_mode():
            return ex.model.forward_no_head(x)
    tower_ms = median_ms(torch, tower, runs=10, warmup=2)
    log(f"tower forward at 512 px, batch 64 bf16 (CUDA events, median of 10): {tower_ms:.2f} ms, "
        f"{64e3 / tower_ms:.0f} tiles/s")
    return {"L": L, "launches": launches, "path_launches": path_launches, "run": stats,
            "feat_err": feat_err, "tower_ms": tower_ms}


# ---------------------------------------------------------------- phase 3q

def cosines(a, b):
    import numpy as np
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def only_flash_launched(fa, ab, co, flash_bf16):
    """True when the only kernel launches since the counters' reset are
    `flash_bf16` bf16 flash launches, all on flash_plan(785)'s path."""
    plan = fa.flash_plan(785)[0]
    return (dict(fa.LAUNCHES) == {"f32": 0, "bf16": flash_bf16}
            and dict(fa.LAUNCHES_PATH) == {p: flash_bf16 if p == plan else 0
                                           for p in fa.LAUNCHES_PATH}
            and sum(ab.LAUNCHES.values()) + sum(ab.LAUNCHES_BWD.values())
            + sum(co.LAUNCHES.values()) + sum(co.LAUNCHES_BWD.values()) == 0)


def int_mm_exactness(torch):
    """torch._int_mm at the trunk's largest int8 product, as the w8a8 linear
    calls it (w [out, in] transposed), against the exact sums: products of
    integers below 128 summed in float64 are exact (every partial sum is
    below 3072 * 127^2 < 2^53)."""
    M, K, N = INT_MM_SHAPE
    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randint(64, 128, (M, K), dtype=torch.int8, device="cuda", generator=g)
    w = torch.randint(64, 128, (N, K), dtype=torch.int8, device="cuda", generator=g)
    got = torch._int_mm(a, w.T)
    want = a.double() @ w.double().T
    exact = bool(torch.equal(got.long(), want.long()))
    top = float(want.abs().max())
    del a, w, want
    log(f"torch._int_mm [{M}, {K}] x [{K}, {N}] (same-sign int8): int32 sums equal to the "
        f"exact ones {exact}, largest {top:.0f} (2^24 = {2 ** 24})")
    check(exact and got.dtype == torch.int32 and top > 2 ** 24,
          f"torch._int_mm is not exact in int32 at {INT_MM_SHAPE}")
    # the whole w8a8 linear, card against CPU: the same f32 operations and
    # exact int32 sums give the same bits (fc1's widths, 4096 tokens)
    from vlsa_tpu_torch.models.precision import quantize_rows
    from vlsa_tpu_torch.models.vision_tower import int8_dynamic_linear
    gen = torch.Generator().manual_seed(8)
    h = torch.randn(4, 1024, 768, generator=gen) * 3.0
    w = torch.randn(3072, 768, generator=gen)
    w_q, w_s = quantize_rows(w)
    w_q_card, w_s_card = quantize_rows(w.to("cuda"))
    want = int8_dynamic_linear(h, w_q, w_s)
    got = int8_dynamic_linear(h.to("cuda"), w_q_card, w_s_card).cpu()
    linear_same = bool(torch.equal(w_q_card.cpu(), w_q) and torch.equal(w_s_card.cpu(), w_s)
                       and torch.equal(got, want))
    log(f"the w8a8 linear ([4, 1024, 768] x [3072, 768]) and quantize_rows, card against CPU: "
        f"bit for bit {linear_same}")
    check(linear_same, "the w8a8 linear or quantize_rows differs between the card and the CPU")
    return {"shape": list(INT_MM_SHAPE), "exact": exact, "largest": top,
            "linear_card_equals_cpu": linear_same}


def rn50_card_vs_cpu(torch, device):
    """CLIP's RN50 (f32) from a seed, BatchNorm statistics drawn too: a
    batch of RN50_CARD_BATCH on the card against the CPU, and the card's ms
    a batch of 64."""
    import numpy as np
    from vlsa_tpu_torch.models.vision_tower import BatchNorm, CLIPModifiedResNet
    from vlsa_tpu_torch.utils.device import disable_tf32
    disable_tf32()
    gen = torch.Generator().manual_seed(RN50_SEED)
    model = CLIPModifiedResNet(generator=gen, **RN50).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    images = torch.randn(RN50_CARD_BATCH, 3, 224, 224, generator=gen)
    with torch.inference_mode():
        want = model(images)
        card = model.to(device)
        got = card(images.to(device)).cpu()
    err = rel_err(got, want)
    check(got.shape == (RN50_CARD_BATCH, RN50["output_dim"]) and bool(torch.isfinite(got).all()),
          f"RN50 output {tuple(got.shape)}")
    check(err <= TOL_RN50, f"RN50 on the card deviates {err:.3e} from the CPU (tol {TOL_RN50:g})")
    x = torch.randn(64, 3, 224, 224, device=device)

    def tower():
        with torch.inference_mode():
            return card(x)
    ms = median_ms(torch, tower, runs=10, warmup=2)
    params = sum(p.numel() for p in model.parameters())
    log(f"RN50 (CLIP ModifiedResNet, {params} parameters) f32 at 224 px: card vs CPU on "
        f"{RN50_CARD_BATCH} images {err:.3e} (tol {TOL_RN50:g}); a batch of 64 {ms:.2f} ms "
        f"(CUDA events, median of 10), {64e3 / ms:.0f} images/s")
    return {"card_vs_cpu": err, "ms": ms, "parameters": params}


def phase_extraction_rest(torch, fa, ab, co, device, conch):
    """The rest of extraction through the port's entry points (CLIP ViT-B/16
    and the w8a8 CONCH trunk at 448 px, batch 64, bf16, device
    preprocessing, EXTRACT_TILES to .npy), then CLIP's RN50 card against
    CPU; every tower's ms a batch.  `conch`: phase 3e's record (its runs'
    tiles/s and its tower's ms, for comparison)."""
    import types
    import numpy as np
    from vlsa_tpu_torch.data.bags import read_patch_data
    from vlsa_tpu_torch.data.extract import FeatureExtractor, extract_to_store
    from vlsa_tpu_torch.data.transforms_device import build_device_preprocess

    n_batches = sum(-(-n // 64) for n in EXTRACT_TILES)
    conch_tps = ", ".join(f"{fmt} {r['tiles_per_sec']:.1f}" for fmt, r in conch["runs"].items())
    out = {"conch_bf16_tiles_per_sec": {fmt: r["tiles_per_sec"]
                                        for fmt, r in conch["runs"].items()}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_extract_rest_") as tmp:
        tiles0 = write_tile_slides(os.path.join(tmp, "tiles"), np.random.default_rng(0))
        batch = tiles0[:64]
        x = build_device_preprocess((EXTRACT_TILE_PX,) * 2, 448)(
            torch.from_numpy(batch).to(device))

        def stored(fmt_dir):
            feats = {}
            for i, n in enumerate(EXTRACT_TILES):
                f = read_patch_data(os.path.join(tmp, fmt_dir, f"slide{i}.npy"))
                check(f.shape == (n, 512) and bool(np.isfinite(f).all()),
                      f"{fmt_dir} slide{i}: features {f.shape}, finite {np.isfinite(f).all()}")
                feats[i] = f
            return feats

        # ---- CLIP ViT-B/16: every counter from 0, no kernel on its path ----
        clip = FeatureExtractor(model_name="clip_vit", image_size=448, batch_size=64,
                                compute_dtype="bfloat16", seed=0, device=device)
        clip32 = FeatureExtractor(model_name="clip_vit", image_size=448, batch_size=64,
                                  compute_dtype="float32", seed=0, device=device)
        check(clip.feat_dim == 512 and clip.model.layers == 12 and clip._device_preprocess
              and tuple(clip.model.positional_embedding.shape) == (785, 768),
              "the CLIP extractor is not ViT-B/16 at 448 px with device preprocessing")
        for kernels in (fa, ab, co):
            kernels.reset_launches()
        run = extract_to_store(os.path.join(tmp, "tiles"), os.path.join(tmp, "clip"), clip,
                               fmt="npy", verbose=False)
        feats32 = clip32.extract(batch)
        check(only_flash_launched(fa, ab, co, 0), f"CLIP ViT's path launched a kernel: flash "
                                                  f"{dict(fa.LAUNCHES)}")
        check(run["slides"] == 2 and run["tiles"] == sum(EXTRACT_TILES), f"CLIP run: {run}")
        feats = stored("clip")
        cos = cosines(feats[0][:64], feats32)
        err = rel_err(torch.from_numpy(feats[0][:64]), torch.from_numpy(feats32))
        check(cos.min() > MIN_COSINE, f"CLIP bf16 features' cosine to f32 {cos.min():.5f}")

        def clip_tower():
            with torch.inference_mode():
                return clip.model(x)
        clip_ms = median_ms(torch, clip_tower, runs=10, warmup=2)
        log(f"CLIP ViT-B/16 at 448 px: {sum(EXTRACT_TILES)} tiles to .npy "
            f"({run['tiles_per_sec']:.1f} tiles/s; 3e's CONCH bf16 runs {conch_tps}), no kernel "
            f"launched; bf16 vs the f32 batch "
            f"{err:.3e}, cosine min {cos.min():.6f}; tower, batch 64 bf16 (CUDA events, median "
            f"of 10): {clip_ms:.2f} ms, {64e3 / clip_ms:.0f} tiles/s")
        out["clip_vit"] = {"run": run, "bf16_vs_f32": err, "bf16_vs_f32_cos_min": float(cos.min()),
                           "tower_ms": clip_ms}
        del clip, clip32, feats32

        # ---- the w8a8 CONCH trunk: 12 bf16 flash launches a batch ----
        q8 = FeatureExtractor(image_size=448, batch_size=64, compute_dtype="bfloat16", seed=0,
                              trunk_quant=True, device=device)
        blk = q8.model.trunk.block_0
        check(q8.trunk_quant and blk.quantized and blk.fc2_weight.dtype == torch.int8
              and q8.model.trunk.layers == 12 and q8.feat_dim == 512,
              "the w8a8 extractor is not CONCH at full width with int8 trunk linears")
        for kernels in (fa, ab, co):
            kernels.reset_launches()
        run = extract_to_store(os.path.join(tmp, "tiles"), os.path.join(tmp, "q8"), q8,
                               fmt="npy", verbose=False)
        launches, path_launches = dict(fa.LAUNCHES), dict(fa.LAUNCHES_PATH)
        expected = 12 * n_batches
        log(f"w8a8 CONCH at 448 px: {sum(EXTRACT_TILES)} tiles to .npy "
            f"({run['tiles_per_sec']:.1f} tiles/s; 3e's bf16 runs {conch_tps}); flash launches "
            f"{launches}, bf16 by path "
            f"{path_launches}")
        check(only_flash_launched(fa, ab, co, expected),
              f"w8a8 path: flash launches {launches} by path {path_launches}, expected "
              f"{expected} bf16 on {fa.flash_plan(785)[0]} and no other kernel")
        check(run["slides"] == 2 and run["tiles"] == sum(EXTRACT_TILES), f"w8a8 run: {run}")
        feats = stored("q8")
        with plain_flash():
            plain = q8.extract(tiles0)
        check(dict(fa.LAUNCHES) == launches, "the plain run launched the flash kernel")
        feat_err = rel_err(torch.from_numpy(feats[0]), torch.from_numpy(plain))
        check(feat_err <= TOL_FEATS["bf16"], f"w8a8 features deviate {feat_err:.3e} from the "
                                             f"plain attention's")
        flt = FeatureExtractor(image_size=448, batch_size=64, compute_dtype="bfloat16", seed=0,
                               device=device)
        cos = cosines(feats[0], flt.extract(tiles0))
        del flt
        check(cos.min() > MIN_COSINE, f"w8a8 features' cosine to the float tower {cos.min():.5f}")
        int_mm = int_mm_exactness(torch)

        def q8_tower():
            with torch.inference_mode():
                return q8.model.forward_no_head(x)
        q8_ms = median_ms(torch, q8_tower, runs=10, warmup=2)
        prof = profile_step(torch, types.SimpleNamespace(train_step=q8.extract), batch,
                            family="flash_fwd", groups=Q8_PROFILE_GROUPS)
        log(f"w8a8 features vs the plain attention (max|a-b| / max|b|) {feat_err:.3e} (tol "
            f"{TOL_FEATS['bf16']:g}); cosine to the float bf16 tower (3e's weights) min "
            f"{cos.min():.6f}, mean {cos.mean():.6f}; tower, batch 64 (CUDA events, median of "
            f"10): {q8_ms:.2f} ms, {64e3 / q8_ms:.0f} tiles/s (3e's bf16 tower "
            f"{conch['tower_ms']:.2f} ms)")
        if prof["device_ms"] is None:
            log("profiled w8a8 batch: the profiler shows no device time")
        else:
            log(f"profiled w8a8 batch of 64 tiles: wall {prof['wall_ms']:.1f} ms, kernels "
                f"{prof['device_ms']:.2f} ms: " + ", ".join(
                    f"{g} {ms:.2f}" for g, ms in prof["groups"].items()) + f" ms; top {prof['top']}")
        out["w8a8"] = {"run": run, "launches": launches, "path_launches": path_launches,
                       "feat_err": feat_err, "cos_min": float(cos.min()),
                       "cos_mean": float(cos.mean()), "tower_ms": q8_ms, "int_mm": int_mm,
                       "profiled_batch": prof}
        del q8
    out["rn50"] = rn50_card_vs_cpu(torch, device)
    out["launches"] = out["w8a8"]["launches"]
    return out


# ---------------------------------------------------------------- phase 3r

def caption_checks(name, ids, seq_len, beam):
    """Every row starts with <sot> = 1; a sampling path's buffer keeps its
    full width with only pads after the first <eos> (forced at seq_len - 1);
    the beam's rows are at most seq_len wide, pads only after an <eos>."""
    import numpy as np
    check((ids[:, 0] == 1).all(), f"{name}: a caption does not start with <sot>: {ids[:, 0]}")
    check(ids.shape[1] <= seq_len if beam else ids.shape == (CAPTION_TILES, seq_len),
          f"{name}: captions of shape {ids.shape}")
    for row in ids:
        check(beam or (row == 2).any(), f"{name}: a sampled caption without <eos>: {row}")
        if (row == 2).any():
            eos = int(np.argmax(row == 2))
            check((row[eos + 1:] == 0).all(), f"{name}: tokens after <eos>: {row}")


def decided_positions(ids):
    """(row, position) of the logits that chose each generated token: t - 1
    for t = 1 up to the row's first <eos>."""
    import numpy as np
    out = []
    for r, row in enumerate(ids):
        end = int(np.argmax(row == 2)) if (row == 2).any() else len(row) - 1
        out += [(r, t - 1) for t in range(1, end + 1)]
    return out


def greedy_processed(logits, ids, t):
    """The greedy path's logits at step t as coca_generate processes them
    (min length, then the repetition penalty) before its argmax."""
    from vlsa_tpu_torch.models.generation import min_length_process, repetition_penalty_process
    out = min_length_process(logits, t, CAPTION_MIN_SEQ_LEN, 2)
    return repetition_penalty_process(out, ids[:, :t], CAPTION_PATHS["greedy"]["repetition_penalty"])


def greedy_against_cpu(ids, card, cpu):
    """Each greedy token the card chose against the CPU's argmax, wherever the
    CPU's top-2 margin (processed logits) exceeds twice the processed
    logits' card-CPU gap; returns (positions held, positions under the
    margin, the gap)."""
    import numpy as np
    held, under, gap = [], 0, 0.0
    steps = []
    for t in range(1, ids.shape[1] - 1):  # seq_len - 1 is forced <eos>
        live = [r for r in range(ids.shape[0]) if not (ids[r, :t] == 2).any()]
        if not live:
            break
        a = greedy_processed(card[:, t - 1], ids, t)[live]
        b = greedy_processed(cpu[:, t - 1], ids, t)[live]
        finite = np.isfinite(b)
        gap = max(gap, float(np.abs(a[finite] - b[finite]).max()))
        steps.append((t, live, b))
    for t, live, b in steps:
        top2 = np.sort(b, axis=-1)[:, -2:]
        for i, r in enumerate(live):
            if top2[i, 1] - top2[i, 0] > 2 * gap:
                held.append((r, t))
                check(int(ids[r, t]) == int(np.argmax(b[i])),
                      f"greedy: the card chose {ids[r, t]} at ({r}, {t}), the CPU's argmax is "
                      f"{int(np.argmax(b[i]))} with a margin {top2[i, 1] - top2[i, 0]:.3e} above "
                      f"twice the gap {gap:.3e}")
            else:
                under += 1
    return len(held), under, gap


def phase_captions(torch, fa, ab, co, device, card):
    """Phase 3r: CoCa caption generation at CONCH's full width on the card
    through `coca_generate`, over row 11's kernel in the visual trunk (see
    CAPTION_PATHS); the checks, the card against the CPU, and the times."""
    import copy
    import types
    import numpy as np
    from vlsa_tpu_torch.data.extract import FeatureExtractor
    from vlsa_tpu_torch.data.transforms_device import build_device_preprocess
    from vlsa_tpu_torch.models.multimodal import MultimodalDecoder, caption_logits, coca_generate
    from vlsa_tpu_torch.models.text_encoder import make_text_tower
    from vlsa_tpu_torch.ops.flags import disable_kernels

    t0 = time.perf_counter()
    visual = FeatureExtractor(image_size=448, batch_size=64, compute_dtype="bfloat16",
                              seed=CAPTION_SEED, device=device).model  # TF32 off from here
    gen = torch.Generator().manual_seed(CAPTION_SEED)
    tower = make_text_tower("CONCH", generator=gen).eval()
    decoder = MultimodalDecoder(generator=gen).eval()
    tower_card, decoder_card = copy.deepcopy(tower).to(device), copy.deepcopy(decoder).to(device)
    build_s = time.perf_counter() - t0
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in (("visual", visual), ("text", tower), ("decoder", decoder))}
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the caption decoder")
    tiles = np.random.default_rng(0).integers(0, 256, size=(CAPTION_TILES, EXTRACT_TILE_PX,
                                                              EXTRACT_TILE_PX, 3), dtype=np.uint8)
    x = build_device_preprocess((EXTRACT_TILE_PX,) * 2, 448)(torch.from_numpy(tiles).to(device))
    gen_kw = dict(seq_len=CAPTION_SEQ_LEN, min_seq_len=CAPTION_MIN_SEQ_LEN)

    # ---- the main path: every launch counter from 0 ----
    for kernels in (fa, ab, co):
        kernels.reset_launches()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.inference_mode():
        _pooled, cap = visual(x)
    torch.cuda.synchronize()
    visual_ms = 1e3 * (time.perf_counter() - t)
    runs = {}
    for name, kw in CAPTION_PATHS.items():
        timings = {}
        t = time.perf_counter()
        ids = coca_generate(tower_card, decoder_card, cap, timings=timings, **gen_kw, **kw)
        runs[name] = {"ids": ids, "wall_s": time.perf_counter() - t, **timings}
    launches, path_launches = dict(fa.LAUNCHES), dict(fa.LAUNCHES_PATH)
    peak = torch.cuda.max_memory_allocated()
    check(launches == {"bf16": 12, "f32": 0} and path_launches.get("streamed") == 12,
          f"captions: flash launches {launches} by path {path_launches}, expected 12 bf16 "
          f"streamed (the trunk's 12 layers, once)")
    check(sum(ab.LAUNCHES.values()) + sum(ab.LAUNCHES_BWD.values()) + sum(co.LAUNCHES.values())
          + sum(co.LAUNCHES_BWD.values()) == 0, "captions launched an ABMIL or co-attention kernel")

    # ---- the caption tokens against the plain attention, on the card ----
    check(cap.shape == (CAPTION_TILES, 256, tower.width) and bool(torch.isfinite(cap).all()),
          f"caption tokens {tuple(cap.shape)}, finite {bool(torch.isfinite(cap).all())}")
    with disable_kernels(), torch.inference_mode():
        _pooled, cap_plain = visual(x)
    check(dict(fa.LAUNCHES) == launches, "the plain trunk launched the flash kernel")
    cap_err = rel_err(cap.float(), cap_plain.float())
    check(cap_err <= TOL_FEATS["bf16"], f"caption tokens deviate {cap_err:.3e} from the plain "
                                        f"attention's (tol {TOL_FEATS['bf16']:g})")

    # ---- every path's final buffers re-scored: the card against the CPU ----
    cap_cpu = cap.float().cpu()
    out = {"build_s": build_s, "parameters": n_params, "visual_ms": visual_ms,
           "launches": launches, "path_launches": path_launches, "peak_device_bytes": peak,
           "caption_token_err": cap_err, "paths": {}}
    for name, run in runs.items():
        ids = run["ids"]
        caption_checks(name, ids, CAPTION_SEQ_LEN, beam=name == "beam")
        buf = np.zeros((ids.shape[0], CAPTION_SEQ_LEN), np.int64)
        buf[:, :ids.shape[1]] = ids
        t = time.perf_counter()
        with torch.inference_mode():
            on_card = caption_logits(tower_card, decoder_card, cap,
                                     torch.from_numpy(buf).to(device)).cpu().numpy()
            on_cpu = caption_logits(tower, decoder, cap_cpu, torch.from_numpy(buf)).numpy()
        rescore_s = time.perf_counter() - t
        pos = decided_positions(ids)
        rows, cols = np.array([p[0] for p in pos]), np.array([p[1] for p in pos])
        a, b = on_card[rows, cols], on_cpu[rows, cols]
        logit_err = float(np.abs(a - b).max() / np.abs(b).max())
        check(np.isfinite(a).all() and logit_err <= TOL_CAPTION_LOGITS,
              f"{name}: step logits card vs CPU {logit_err:.3e} (tol {TOL_CAPTION_LOGITS:g})")
        steps = run["steps"]
        rec = {"ids": ids.tolist(), "positions": len(pos), "logit_err": logit_err,
               "rescore_s": rescore_s, "wall_s": run["wall_s"], "steps": steps,
               "step_wall_ms": 1e3 * run["step_s"] / steps,
               "host_ms_per_step": 1e3 * run["host_s"] / steps,
               "captions_per_s": CAPTION_TILES / run["wall_s"]}
        if name == "greedy":
            rec["argmax_held"], rec["argmax_under_margin"], rec["greedy_gap"] = \
                greedy_against_cpu(ids, on_card, on_cpu)
        out["paths"][name] = rec

    # ---- the decode step alone (CUDA events) and one profiled beam step ----
    rng = np.random.default_rng(1)
    for name, R in (("beam", CAPTION_TILES * 6), ("sampling", CAPTION_TILES)):
        embs = cap.float().repeat_interleave(R // CAPTION_TILES, dim=0)
        buf = torch.from_numpy(rng.integers(3, 32007, size=(R, CAPTION_SEQ_LEN))).to(device)

        def step(embs=embs, buf=buf):
            with torch.inference_mode():
                return caption_logits(tower_card, decoder_card, embs, buf)
        out[f"step_ms_{name}"] = median_ms(torch, step, runs=CAPTION_STEP_RUNS, warmup=1)
        if name == "beam":
            out["profiled_beam_step"] = profile_step(
                torch, types.SimpleNamespace(train_step=lambda _b: step()), None,
                family="gemm", groups=CAPTION_GROUPS)
    prof = out["profiled_beam_step"]
    log(f"captions: visual model, CONCH text tower and decoder built in {build_s:.1f} s "
        f"({n_params} parameters); {CAPTION_TILES} tiles of 448 px through the bf16 trunk "
        f"{visual_ms:.1f} ms (host clock, first call), flash launches {launches} "
        f"({path_launches}); caption tokens {tuple(cap.shape)} vs plain attention "
        f"{cap_err:.3e} (tol {TOL_FEATS['bf16']:g}); peak device memory {peak / 2**30:.2f} GiB")
    for name, rec in out["paths"].items():
        extra = (f"; greedy argmax = the CPU's at {rec['argmax_held']} positions, "
                 f"{rec['argmax_under_margin']} under the margin (2 x {rec['greedy_gap']:.3e})"
                 if name == "greedy" else "")
        log(f"captions {name}: {rec['steps']} steps, {rec['wall_s'] * 1e3:.1f} ms for "
            f"{CAPTION_TILES} captions ({rec['captions_per_s']:.2f} captions/s), a step "
            f"{rec['step_wall_ms']:.2f} ms with the logits' copy (host clock) and "
            f"{rec['host_ms_per_step']:.2f} ms of host work; card vs CPU logits "
            f"{rec['logit_err']:.3e} over {rec['positions']} positions (tol "
            f"{TOL_CAPTION_LOGITS:g}, CPU re-score {rec['rescore_s']:.1f} s){extra}; first "
            f"caption {rec['ids'][0]}")
    log(f"decode step (CUDA events, median of {CAPTION_STEP_RUNS}, L2 flushed): beam rows "
        f"{CAPTION_TILES * 6} x {CAPTION_SEQ_LEN} {out['step_ms_beam']:.2f} ms, sampling rows "
        f"{CAPTION_TILES} x {CAPTION_SEQ_LEN} {out['step_ms_sampling']:.2f} ms; profiled beam "
        + ("step: no device time" if prof["device_ms"] is None else
           f"step {prof['device_ms']:.2f} ms of kernels: "
           + ", ".join(f"{g} {ms:.2f}" for g, ms in prof["groups"].items()))
        + f"; on {card}")
    del visual, tower, decoder, tower_card, decoder_card, cap, cap_plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 3s

def pack_flax_msgpack(tree) -> bytes:
    """`flax.serialization.msgpack_serialize`'s layout, as vlsa_tpu's
    runner/ckpt.py writes it: each numpy array as the msgpack extension
    type 1 holding packb((shape, dtype name, C-order bytes)), everything
    else as msgpack's own types (arrays here are far under flax's 2**30-byte
    chunk size)."""
    import msgpack
    import numpy as np

    def ext(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(1, msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")),
                                                    use_bin_type=True))
        raise TypeError(f"cannot pack {type(x)}")
    return msgpack.packb(tree, default=ext, strict_types=True)


def phase_flax_checkpoint(torch, ab, co, device, card, tmp, keep):
    """Phase 3s: phase 3h's kept flagship model (INTERP_RUN) written as a
    vlsa_tpu checkpoint (flax's msgpack layout, the module filter applied)
    in a copy of its run directory; `test_model` from it and from 3h's torch
    checkpoint, and `load_vlsa_from_run` on both directories, bit for bit."""
    import numpy as np
    from vlsa_tpu_torch.config import load_config
    from vlsa_tpu_torch.data.pipeline import BagBatcher
    from vlsa_tpu_torch.interpret import load_vlsa_from_run
    from vlsa_tpu_torch.runner.ckpt import filter_state, load_checkpoint
    from vlsa_tpu_torch.runner.train import make_dataset
    from vlsa_tpu_torch.runner.vlsa import VLSAHandler
    from vlsa_tpu_torch.utils.weights import jax_tree_from_state_dict

    run_dir, flax_dir = os.path.join(tmp, INTERP_RUN), os.path.join(tmp, FLAX_RUN)
    torch_ckpt = os.path.join(run_dir, "train_model-last.ckpt")
    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    t0 = time.perf_counter()
    state = filter_state(keep[INTERP_RUN].state_dict(), cfg.get("model_saver_module_filter"))
    epoch = load_checkpoint(torch_ckpt)["epoch"]
    os.makedirs(flax_dir)
    shutil.copy(os.path.join(run_dir, "config.yaml"), flax_dir)
    flax_ckpt = os.path.join(flax_dir, "train_model-last.ckpt")
    with open(flax_ckpt, "wb") as f:
        f.write(pack_flax_msgpack({"epoch": epoch, "model": jax_tree_from_state_dict(state)}))
    write_s = time.perf_counter() - t0
    read = {"torch": load_checkpoint(torch_ckpt), "flax": load_checkpoint(flax_ckpt)}
    check(read["flax"]["epoch"] == epoch and read["flax"]["model"].keys() == state.keys()
          and all(torch.equal(read["flax"]["model"][k], read["torch"]["model"][k]) for k in state),
          "the flax checkpoint's tensors differ from the torch checkpoint's")

    # ---- test_model from each checkpoint ----
    co.reset_launches()
    ab.reset_launches()
    handler = VLSAHandler(dict(cfg, save_path=os.path.join(tmp, FLAX_RUN + "_eval")),
                          device=device)
    test_set = make_dataset(handler.cfg, handler.data_meta, handler.data_split["test"])
    handler.uid["test"] = test_set.uid
    probs = {}
    for fmt, path in (("torch", torch_ckpt), ("flax", flax_ckpt)):
        t = time.perf_counter()
        probs[fmt] = handler.test_model(test_set, "test", ckpt_path=path)["pred"]["y_hat"]
        probs[fmt + "_s"] = time.perf_counter() - t
    check(np.array_equal(probs["flax"], probs["torch"]) and np.isfinite(probs["flax"]).all(),
          f"test probabilities from the flax checkpoint differ from the torch one's by "
          f"{np.abs(probs['flax'] - probs['torch']).max():.3e}")
    del handler

    # ---- load_vlsa_from_run on both directories ----
    models = {fmt: load_vlsa_from_run(d, ckpt_type="last", device=device)
              for fmt, d in (("torch", run_dir), ("flax", flax_dir))}
    batch = BagBatcher(test_set, batch_size=INTERP_BATCH,
                       feats_dtype=cfg.get("feats_dtype", "float32"),
                       prefetch=0).make_batch(range(INTERP_BATCH))
    feats, mask = batch["feats"].to(device), batch["mask"].to(device)
    with torch.inference_mode():
        logits = {fmt: m(feats, mask)[0] for fmt, m in models.items()}
    check(torch.equal(logits["flax"], logits["torch"]),
          "load_vlsa_from_run: the flax run directory's logits differ from the torch one's")
    launches = dict(co.LAUNCHES)  # the two passes' and the two models' forwards
    check(sum(launches.values()) > 0 and sum(ab.LAUNCHES.values()) == 0,
          f"flax checkpoint: co-attention launches {launches}, ABMIL {dict(ab.LAUNCHES)}")
    size = os.path.getsize(flax_ckpt)
    log(f"flax checkpoint: {len(state)} tensors of {INTERP_RUN} ({size / 2**20:.1f} MiB, "
        f"written in {write_s:.2f} s); test_model from it: {len(test_set)} patients' "
        f"probabilities bit-identical to the torch checkpoint's ({probs['flax_s']:.2f} s vs "
        f"{probs['torch_s']:.2f} s a pass; co-attention launches {launches}); "
        f"load_vlsa_from_run on both directories: logits of {INTERP_BATCH} bags bit-identical; "
        f"on {card}")
    del models, feats, mask, batch
    torch.cuda.empty_cache()
    return {"tensors": len(state), "bytes": size, "write_s": write_s, "epoch": epoch,
            "test_pass_s": {k: probs[k + "_s"] for k in ("torch", "flax")},
            "launches": {"coattn_fwd": launches}, "patients": len(test_set)}


# ---------------------------------------------------------------- phase 3u

def _masked(tree: dict, frozen: dict) -> dict:
    """`tree` with an empty dict (optax's MaskedNode) at every leaf of
    `frozen`'s paths."""
    return {k: ({} if not isinstance(frozen[k], dict) else _masked(v, frozen[k]))
            if k in frozen else v for k, v in tree.items()}


def optax_adam_tree(model, opt_state_dict: dict, weight_decay: float) -> dict:
    """vlsa_tpu's optimizer tree for `opt_name: adam`, flax's state dict of
    the state its runner builds (vlsa_tpu/optim/factory.py:108-140:
    inject_hyperparams over multi_transform's train and frozen labels, the
    train chain add_decayed_weights (masked; identity without weight decay),
    scale_by_adam, scale), from the port's torch Adam over `model`: mu and nu
    in vlsa_tpu's layout over every parameter, an empty dict at each frozen
    one (requires_grad False), zeros where a trainable parameter never had a
    gradient (torch keeps no state for it, optax zero moments); optax's one
    count is the most steps any parameter took, the learning rate each
    group's as f32."""
    import numpy as np
    from vlsa_tpu_torch.utils.weights import jax_tree_from_state_dict

    state = {}
    for group in opt_state_dict["param_groups"]:
        for name, i in zip(group["names"], group["params"]):
            if i in opt_state_dict["state"]:
                state[name] = opt_state_dict["state"][i]
    params = dict(model.named_parameters())
    frozen = jax_tree_from_state_dict({n: p for n, p in params.items() if not p.requires_grad})
    count = np.asarray(max(int(st["step"]) for st in state.values()), np.int32)

    def moments(key):
        return _masked(jax_tree_from_state_dict(
            {n: state[n][key] if n in state else p.detach().float().cpu().zero_()
             for n, p in params.items()}), frozen)
    lrs = {group["lr"] for group in opt_state_dict["param_groups"]}
    if len(lrs) != 1:
        raise ValueError(f"the groups' learning rates differ: {lrs}")
    adam = {"count": count, "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")}
    train = {"0": {"inner_state": {}} if weight_decay else {}, "1": adam, "2": {}}
    return {"count": count, "hyperparams": {"learning_rate": np.asarray(lrs.pop(), np.float32)},
            "hyperparams_states": {},
            "inner_state": {"inner_states": {"train": {"inner_state": train},
                                             "frozen": {"inner_state": {}}}}}


def _flat_tree(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tree(v, path + (k,))
    else:
        yield path, tree


def _same_leaves(torch, a: dict, b: dict) -> bool:
    """Two trees of arrays and tensors with the same keys, dtypes and bits."""
    import numpy as np
    fa, fb = dict(_flat_tree(a)), dict(_flat_tree(b))
    if fa.keys() != fb.keys():
        return False
    for k, x in fa.items():
        y = fb[k]
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif not (np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y)):
            return False
    return True


def _eval_events(save_path: str) -> list:
    """The run's metrics.jsonl evaluation events, without their times."""
    with open(os.path.join(save_path, "metrics.jsonl")) as f:
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in map(json.loads, f) if e.get("event") == "eval"]


def zstd_throughput() -> dict:
    """The port's zstd decoder over every chunk of the orbax fixtures,
    ZSTD_REPEATS passes, on this host (no card needed: `python3 -c "import
    chip_smoke; print(chip_smoke.zstd_throughput())"`): {frames, bytes a
    pass, MB/s}."""
    sys.path.insert(0, ROOT)
    from vlsa_tpu_torch.runner.orbax import read_ocdbt
    from vlsa_tpu_torch.utils.zstd import decompress

    frames = []
    for rel in ("sa_orbax/train_model-last.ckpt.orbax", "mixed_orbax.ckpt.orbax"):
        frames += [v for v in read_ocdbt(os.path.join(RESUME_FIXTURES, rel)).values()
                   if v[:4] == b"\x28\xb5\x2f\xfd"]
    t = time.perf_counter()
    decoded = sum(len(decompress(f)) for _ in range(ZSTD_REPEATS) for f in frames)
    return {"frames": len(frames), "bytes": decoded // ZSTD_REPEATS,
            "mb_s": decoded / (time.perf_counter() - t) / 1e6}


def phase_resume(torch, ab, co, device, card, tmp, keep):
    """Phase 3u: vlsa_tpu's checkpoints resumed.  The committed fixtures read
    from both backends (the orbax directories through the port's OCDBT, zarr
    and zstd readers) into the same state dicts and optimizer states; the
    zstd decoder's MB/s over their frames; the fixture's SA run resumed for
    its second epoch (the general ABMIL instances, rows 7-8) with finite
    metrics; then INTERP_RUN's Adam state packed into optax's tree beside
    its weights in vlsa_tpu's msgpack layout (RESUMED_RUN), and one epoch
    resumed through `auto_resume` (the training loop of `exec`, with its
    evaluation of the epoch) from it and from the port's own torch
    checkpoint of the same run: the same evaluation losses and metrics and
    test probabilities, bit for bit (rows 1 and 6)."""
    import importlib.util
    import numpy as np
    from vlsa_tpu_torch.config import load_config
    from vlsa_tpu_torch.optim import create_optimizer
    from vlsa_tpu_torch.optim.optax_state import load_optax_state
    from vlsa_tpu_torch.runner.ckpt import filter_state, load_checkpoint
    from vlsa_tpu_torch.runner.sa import SAHandler, build_model
    from vlsa_tpu_torch.runner.vlsa import VLSAHandler
    from vlsa_tpu_torch.utils.weights import jax_tree_from_state_dict

    present = {m: importlib.util.find_spec(m) is not None
               for m in ("orbax", "tensorstore", "zstandard", "zstd")}
    log(f"modules on this machine: {present}")

    # ---- the fixtures from both backends ----
    paths = {("sa", "msgpack"): "sa_msgpack/train_model-last.ckpt",
             ("sa", "orbax"): "sa_orbax/train_model-last.ckpt",
             ("mixed", "msgpack"): "mixed_msgpack.ckpt", ("mixed", "orbax"): "mixed_orbax.ckpt"}
    read, read_s = {}, {}
    for key, rel in paths.items():
        t = time.perf_counter()
        read[key] = load_checkpoint(os.path.join(RESUME_FIXTURES, rel))
        read_s["/".join(key)] = time.perf_counter() - t
    for kind in ("sa", "mixed"):
        a, b = read[(kind, "msgpack")], read[(kind, "orbax")]
        check(a["epoch"] == b["epoch"] and _same_leaves(torch, a["model"], b["model"])
              and ("optax_state" in a) == ("optax_state" in b) == (kind == "sa")
              and (kind != "sa" or _same_leaves(torch, a["optax_state"], b["optax_state"])),
              f"the {kind} fixture reads differently from its two backends")
    dtypes = sorted({str(t.dtype) for t in read[("mixed", "orbax")]["model"].values()})
    check(dtypes == ["torch.bfloat16", "torch.float32", "torch.int8"],
          f"the mixed fixture's dtypes {dtypes}")
    sa_cfg = {"arch": "DeepMIL", "net_dims": RESUME_SA_DIMS, "deepmil_network": "ABMIL",
              "deepmil_pooling": "attention", "deepmil_use_feat_proj": False,
              "deepmil_drop_rate": 0.0, "seed": 0}
    model = build_model(sa_cfg, device=device)
    model.load_state_dict(read[("sa", "msgpack")]["model"], strict=True)
    opt_states = {}
    for backend in ("msgpack", "orbax"):
        opt = create_optimizer("adam", 1e-3, 1e-5, model)
        load_optax_state(opt, "adam", read[("sa", backend)]["optax_state"])
        opt_states[backend] = opt.state_dict()
    a, b = opt_states["msgpack"], opt_states["orbax"]
    check(a["param_groups"] == b["param_groups"] and a["state"].keys() == b["state"].keys()
          and len(a["state"]) == len(list(model.parameters()))
          and all(torch.equal(a["state"][i][k], b["state"][i][k])
                  for i in a["state"] for k in a["state"][i]),
          "the SA fixture's optimizer states differ between its backends")
    del model
    zstd = zstd_throughput()
    log(f"fixtures read (s): { {k: round(v, 4) for k, v in read_s.items()} }, both backends "
        f"bit-identical (state dicts and optimizer states); the zstd decoder: "
        f"{zstd['frames']} frames, {zstd['bytes']} bytes a pass, {zstd['mb_s']:.2f} MB/s")

    # ---- the fixture's SA run, resumed for its second epoch ----
    sa_dir = os.path.join(tmp, "resume_sa")
    shutil.copytree(os.path.join(RESUME_FIXTURES, "sa_msgpack"), sa_dir)
    ab.reset_launches()
    co.reset_launches()
    handler = SAHandler(dict(LIFECYCLE_SA_CFG, net_dims=RESUME_SA_DIMS, path_patch=RESUME_SA_BAGS,
                             epochs=2, auto_resume=True, save_path=sa_dir), device=device)
    t = time.perf_counter()
    sa_metrics = handler.exec()
    sa_s = time.perf_counter() - t
    sa_launches = launch_counts(ab, co)
    values = [v for split in sa_metrics.values() for _k, v in split]
    check([e["epoch"] for e in handler.timings["epochs"]] == [2]
          and all(np.isfinite(v) for v in values)
          and all(g["lr"] == 1e-3 for g in handler.optimizer.param_groups),
          f"the resumed SA run: epochs {handler.timings['epochs']}, metrics {sa_metrics}")
    check(sa_launches["abmil_fwd"]["f32"] > 0 and sa_launches["abmil_bwd"]["f32"] > 0
          and sum(sa_launches["coattn_fwd"].values()) == 0,
          f"the resumed SA run's launches {sa_launches}")
    log(f"the fixture's SA run ({RESUME_SA_DIMS}) resumed at epoch 1 for epoch 2 in "
        f"{sa_s:.2f} s: finite metrics {dict(sa_metrics['test'])}; ABMIL launches fwd "
        f"{sa_launches['abmil_fwd']}, bwd {sa_launches['abmil_bwd']}")
    del handler

    # ---- the flagship, resumed from optax's tree and from the torch file ----
    run_dir = os.path.join(tmp, INTERP_RUN)
    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    torch_ckpt = load_checkpoint(os.path.join(run_dir, "train_model-last.ckpt"))
    dirs = {"optax": os.path.join(tmp, RESUMED_RUN),
            "torch": os.path.join(tmp, INTERP_RUN + "_resumed")}
    for d in dirs.values():  # the config alone: metrics.jsonl takes the resumed epoch only
        os.makedirs(d)
        shutil.copy(os.path.join(run_dir, "config.yaml"), d)
    shutil.copy(os.path.join(run_dir, "train_model-last.ckpt"), dirs["torch"])
    t = time.perf_counter()
    tree = {"epoch": torch_ckpt["epoch"],
            "model": jax_tree_from_state_dict(filter_state(
                torch_ckpt["model"], cfg.get("model_saver_module_filter"))),
            "optimizer": optax_adam_tree(keep[INTERP_RUN], torch_ckpt["optimizer"],
                                         cfg.get("opt_weight_decay", 0.0))}
    optax_ckpt = os.path.join(dirs["optax"], "train_model-last.ckpt")
    with open(optax_ckpt, "wb") as f:
        f.write(pack_flax_msgpack(tree))
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    got = load_checkpoint(optax_ckpt)
    flagship_read_s = time.perf_counter() - t
    check("optax_state" in got and got["model"].keys() == torch_ckpt["model"].keys(),
          "the flagship's optax checkpoint")
    runs = {}
    for fmt in ("optax", "torch"):
        ab.reset_launches()
        co.reset_launches()
        handler = VLSAHandler(dict(cfg, save_path=dirs[fmt], epochs=torch_ckpt["epoch"] + 1,
                                   auto_resume=True), device=device)
        # exec's training loop with its evaluation each epoch (the test split;
        # fold 0 has no validation split), without its final passes, for the
        # script's time; each pass's predictions kept
        test_set = handler.prepare_dataset(handler.data_split["test"], "test")
        handler.uid.update(train=handler.trainer.dataset.uid, test=test_set.uid)
        passes, test_model = [], handler.test_model

        def keep_pass(dataset, name, ckpt_path=None, _run=test_model, _out=passes):
            out = _run(dataset, name, ckpt_path)
            _out.append((name, out["pred"]["y_hat"]))
            return out
        handler.test_model = keep_pass
        t = time.perf_counter()
        handler._run_training(handler.cfg["epochs"], "train", val_loaders={"test": test_set},
                              val_name="validation", save_ckpt=True, run_name="train")
        seconds = time.perf_counter() - t
        runs[fmt] = {"launches": launch_counts(ab, co), "seconds": seconds,
                     "epochs": [e["epoch"] for e in handler.timings["epochs"]],
                     "events": _eval_events(dirs[fmt]),
                     "probs": [p for name, p in passes if name == "test"][-1]}
        del handler, keep_pass
        torch.cuda.empty_cache()
    a, b = runs["optax"], runs["torch"]
    check(a["epochs"] == b["epochs"] == [torch_ckpt["epoch"] + 1],
          f"the resumed flagship's epochs {a['epochs']}, {b['epochs']}")
    check(len(a["events"]) >= 2 and a["events"] == b["events"],
          "the flagship resumed from optax's tree evaluates otherwise than from the torch "
          "checkpoint")
    check(np.array_equal(a["probs"], b["probs"]) and np.isfinite(a["probs"]).all(),
          f"test probabilities resumed from optax's tree differ from the torch checkpoint's "
          f"by {np.abs(a['probs'] - b['probs']).max():.3e}")
    for fmt in runs:
        fwd, dq = runs[fmt]["launches"]["coattn_fwd"], runs[fmt]["launches"]["coattn_bwd_dq"]
        check(fwd["bf16"] > 0 and dq["bf16"] > 0, f"the flagship resumed from {fmt}: "
                                                    f"co-attention launches {fwd}, dQ {dq}")
        del runs[fmt]["probs"]
    size = os.path.getsize(optax_ckpt)
    log(f"flagship {INTERP_RUN} with Adam's state in optax's tree ({size / 2**20:.1f} MiB, "
        f"written in {write_s:.2f} s, read in {flagship_read_s:.2f} s), resumed at epoch "
        f"{torch_ckpt['epoch']} through auto_resume: {a['seconds']:.2f} s, beside the torch "
        f"checkpoint's {b['seconds']:.2f} s; every evaluation event, metric and test "
        f"probability bit-identical; launches fwd {a['launches']['coattn_fwd']}, dQ "
        f"{a['launches']['coattn_bwd_dq']}; on {card}")
    return {"modules_present": present, "fixture_read_s": read_s, "zstd": zstd,
            "sa": {"launches": sa_launches, "seconds": sa_s, "metrics": sa_metrics},
            "flagship": {"bytes": size, "write_s": write_s, "read_s": flagship_read_s,
                         "runs": runs}}


# ---------------------------------------------------------------- phase 3f

@contextlib.contextmanager
def plain_full_backward(torch, co):
    """Run `CoattnPoolFull` on the plain versions of both of its kernels
    (`coattn_fwd_reference`, `coattn_bwd_dx_reference`), bag by bag to bound
    their memory, also on the card."""
    def fwd(q, x, mask, scale, x_scale=None, x_inv=None):
        parts = [co.coattn_fwd_reference(q, x[i:i + 1], mask[i:i + 1], scale)
                 for i in range(x.shape[0])]
        return tuple(torch.cat(t) for t in zip(*parts))

    def bwd(q, x, mask, scale, g, out, m, l):
        dq, dxs = 0.0, []
        for i in range(x.shape[0]):
            b = slice(i, i + 1)
            dq_b, dx_b = co.coattn_bwd_dx_reference(q, x[b], mask[b], scale, g[b], out[b],
                                                    m[b], l[b])
            dq = dq + dq_b
            dxs.append(dx_b)
        return dq, torch.cat(dxs)
    kernels = co.coattn_fwd, co.coattn_bwd_dx
    co.coattn_fwd, co.coattn_bwd_dx = fwd, bwd
    try:
        yield
    finally:
        co.coattn_fwd, co.coattn_bwd_dx = kernels


def phase_feat_proj_training(torch, co, device):
    """The flagship trainer with `vlsa_img_encoder_use_feat_proj: True`:
    Adam steps in every storage through the forward and dX kernels, the
    gradient checks, one served request and one profiled step."""
    import numpy as np
    from vlsa_tpu_torch.config import training_config
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags
    from vlsa_tpu_torch.runner.train import Trainer

    cfg = training_config(dict(TRAIN_CFG, vlsa_img_encoder_use_feat_proj=True), fold=0)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device)
    build_s = time.perf_counter() - t0
    model, engine, batcher = trainer.model, trainer.engine, trainer.batcher
    batcher.prefetch = 0  # the storage changes between steps: each batch built on demand
    check(trainer.meta.num_bins == 12 and model.mil_encoder.use_feat_proj,
          f"fold 0 gives {trainer.meta.num_bins} bins; projecter {model.mil_encoder.use_feat_proj}")
    tower = model.prompt_encoder
    tower0 = {k: v.detach().clone() for k, v in tower.state_dict().items()}
    learnable = [n for n, p in model.named_parameters() if p.requires_grad]
    prefixes = LEARNABLE + ("mil_encoder.feat_proj.",)
    check(all(any(n.startswith(prefix) for n in learnable) for prefix in prefixes)
          and not any(n.startswith("prompt_encoder.") for n in learnable),
          f"unexpected learnable parameters {learnable}")
    log(f"feature-projecter trainer built in {build_s:.1f} s: {len(learnable)} learnable "
        f"tensors, {[n for n in learnable if 'feat_proj' in n]} among them")

    def on_card(host, with_inv):
        batch = {k: v.to(device) for k, v in host.items()}
        if with_inv and "feats_scale" not in batch:
            batch["feats_inv"] = inv_norms(torch, batch["feats"])
        return batch

    # ---- the main path: every launch counter from 0 ----
    batches = trainer.batches()
    torch.cuda.empty_cache()
    co.reset_launches()
    steps, last_batch = [], {}  # storage mode -> (its last host batch, 1/||x|| shipped)
    exp_fwd, exp_dx = dict.fromkeys(co.LAUNCHES, 0), dict.fromkeys(co.LAUNCHES_DX, 0)
    for feats_dtype, with_inv, count in FEAT_PROJ_STEPS:
        batcher.feats_dtype, batcher.precompute_inv = feats_dtype, with_inv
        for _ in range(count):
            t = time.perf_counter()
            host = next(batches)
            batch = on_card(host, with_inv)
            torch.cuda.synchronize()
            t_mid = time.perf_counter()
            before = {n: p.detach().clone() for n, p in model.named_parameters()
                      if p.requires_grad}
            torch.cuda.reset_peak_memory_stats()
            t_step = time.perf_counter()
            loss, raw = engine.train_step(batch)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t_step)
            mode = co.variant_name(batch["feats"].dtype, "feats_inv" in batch)
            # VLFAN drops the sidecars and pools the projected features in
            # f32 for f32 storage, else in bf16
            kernel = "f32" if batch["feats"].dtype == torch.float32 else "bf16"
            exp_fwd[kernel] += 1
            exp_dx[kernel] += 1
            # a copy: the batcher writes the batch's buffer again once the next
            # batch is asked for
            last_batch[mode] = ({k: v.clone() for k, v in host.items()}, with_inv)
            rec = {"mode": mode, "kernel": kernel, "loss": float(loss),
                   "bags": int(batch["valid"].sum()), "bucket": int(batch["mask"].shape[1]),
                   "patches": int(batch["mask"].sum()), "prep_ms": 1e3 * (t_mid - t),
                   "step_ms": step_ms, "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            check(bool(np.isfinite(rec["loss"])) and bool(torch.isfinite(raw).all()),
                  f"feat-proj step {len(steps)} ({mode}): non-finite loss or logits")
            check(all(torch.equal(v, tower0[k]) for k, v in tower.state_dict().items()),
                  f"feat-proj step {len(steps)} ({mode}): the frozen tower changed")
            still = [n for n, p in model.named_parameters()
                     if p.requires_grad and torch.equal(p.detach(), before[n])]
            check(not still, f"feat-proj step {len(steps)} ({mode}): {still} did not move")
            steps.append(rec)
            log(f"feat-proj train step {len(steps) - 1} {mode:9s} loss {rec['loss']:.4f}  "
                f"{rec['bags']} bags, bucket {rec['bucket']}, {rec['patches']} patches: host "
                f"prep {rec['prep_ms']:.0f} ms + step {step_ms:.1f} ms, peak device memory "
                f"{rec['max_memory_gb']:.2f} GB")
            del batch, before, loss, raw
    launches = {"fwd": dict(co.LAUNCHES), "bwd": dict(co.LAUNCHES_BWD),
                "dx": dict(co.LAUNCHES_DX)}
    log(f"feat-proj main path: {len(steps)} training steps, launches {launches}")
    check(launches["fwd"] == exp_fwd and launches["dx"] == exp_dx,
          f"feat-proj launches {launches}, expected forward {exp_fwd} and dX {exp_dx}")
    check(sum(launches["bwd"].values()) == 0, "feat-proj training launched the dQ-only kernel")

    # ---- the gradients through the kernels against CoattnPoolFull on the
    # plain versions and against autograd through the plain pooling, on the
    # main path's last batch of each storage (see phase_training for the
    # text tower in f32 and the patients censored in the last bin) ----
    K = trainer.meta.num_bins
    grad_check = {}
    with f32_text_tower(torch, tower):
        for mode, (host, with_inv) in last_batch.items():
            b = on_card(host, with_inv)
            ill = b["valid"] & (b["e"] == 0) & (b["t"] == K - 1)
            b = dict(b, valid=b["valid"] & ~ill)
            torch.cuda.reset_peak_memory_stats()
            g_kernel = param_grads(torch, model, engine, b)
            with plain_full_backward(torch, co):
                dev = grad_devs(g_kernel, param_grads(torch, model, engine, b), learnable)
            with plain_coattention():
                dev_auto = grad_devs(g_kernel, param_grads(torch, model, engine, b), learnable)
            worst, worst_auto = max(dev, key=dev.get), max(dev_auto, key=dev_auto.get)
            grad_check[mode] = {"bucket": int(b["mask"].shape[1]), "bags": int(b["valid"].sum()),
                                "dev_plain_kernels": dev, "dev_autograd": dev_auto,
                                "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            log(f"feat-proj gradients, {mode} batch: {grad_check[mode]['bags']} bags, bucket "
                f"{grad_check[mode]['bucket']}, text tower in f32: kernels vs plain kernels worst "
                f"{worst} {dev[worst]:.2e} (tol {TOL_GRAD:g}); vs autograd of the plain pooling "
                f"worst {worst_auto} {dev_auto[worst_auto]:.2e}"
                + (f" (tol {TOL_GRAD:g})" if mode == "f32" else " (logged: autograd does not "
                   "round a, g and dl)") + f"; peak {grad_check[mode]['max_memory_gb']:.2f} GB")
            check(dev[worst] <= TOL_GRAD, f"feat-proj {mode}: gradient of {worst} deviates "
                                          f"{dev[worst]:.3e} from the plain kernels'")
            if mode == "f32":
                check(dev_auto[worst_auto] <= TOL_GRAD, f"feat-proj f32: gradient of "
                      f"{worst_auto} deviates {dev_auto[worst_auto]:.3e} from autograd's")
            del b, g_kernel
            torch.cuda.empty_cache()

    # ---- one request of 8 bf16 bags served by the trained model ----
    infer = InferEngine(model, feats_dtype="bfloat16", precompute_inv=False)
    req = infer.prepare(request_bags(cfg["path_patch"], 0, BAGS_PER_REQUEST))
    fwd_before = dict(co.LAUNCHES)
    probs = infer.forward(req)["probs"]
    torch.cuda.synchronize()
    check(co.LAUNCHES["bf16"] == fwd_before["bf16"] + 1, "the served request missed the kernel")
    with plain_coattention():
        serve_dev = float((probs - infer.forward(req)["probs"]).abs().max())
    log(f"feat-proj model served {BAGS_PER_REQUEST} bf16 bags: max |p_kernel - p_plain| "
        f"{serve_dev:.2e} (tol 1e-3)")
    check(tuple(probs.shape) == (BAGS_PER_REQUEST, 12)
          and float((probs.sum(-1) - 1).abs().max()) <= 1e-5, "feat-proj probabilities")
    check(serve_dev <= 1e-3, f"feat-proj kernel and plain probabilities differ by {serve_dev:.3e}")

    # ---- one profiled bf16 step ----
    batcher.feats_dtype, batcher.precompute_inv = "bfloat16", False
    batch = on_card(next(batches), False)
    prof = dict(profile_step(torch, engine, batch, family="coattn", groups=FEAT_PROJ_GROUPS),
                bucket=int(batch["mask"].shape[1]), patches=int(batch["mask"].sum()))
    if prof["device_ms"] is None:
        log("feat-proj profiled step: the profiler shows no device time")
    else:
        log(f"feat-proj profiled bf16 step (bucket {prof['bucket']}, {prof['patches']} patches): "
            f"wall {prof['wall_ms']:.1f} ms, kernels on the card {prof['device_ms']:.2f} ms: "
            + ", ".join(f"{g} {ms:.2f}" for g, ms in prof["groups"].items())
            + f" ms; co-attention kernels {prof['kernels']}; top {prof['top']}")
    bf16 = [r for r in steps if r["mode"] == "bf16"]
    return {"build_s": build_s, "steps": steps, "launches": launches, "grad_check": grad_check,
            "serve_max_prob_dev": serve_dev, "profiled_step": prof,
            "median_bf16_prep_ms": float(np.median([r["prep_ms"] for r in bf16])),
            "median_bf16_step_ms": float(np.median([r["step_ms"] for r in bf16]))}


# ---------------------------------------------------------------- phase 3g

def read_prediction_csv(path):
    """(patient ids, [n, 3 + K] values: t, e, risk, the survival curve)."""
    import csv
    import numpy as np
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return [r[0] for r in rows[1:]], np.array([[float(x) for x in r[1:]] for r in rows[1:]])


def comparable_pair_gaps(t, e, estimate):
    """|estimate_i - estimate_j| over the comparable pairs of the C-index
    (an event at t_i, and t_j later or censored at t_i)."""
    import numpy as np
    t, e, estimate = np.asarray(t, float), np.asarray(e).astype(bool), np.asarray(estimate)
    later = (t[None, :] > t[:, None]) | ((t[None, :] == t[:, None]) & ~e[None, :])
    pairs = later & e[:, None]
    return np.abs(estimate[:, None] - estimate[None, :])[pairs]


def hold_c_index(name, c_kernel, c_plain, gaps, est_gap):
    """The kernel path's C-index differs from the plain path's by at most the
    share of comparable pairs that could change order: those whose plain
    gap is below max(PAIR_GAP, 2 max|kernel - plain| of the estimate)."""
    import numpy as np
    limit = max(PAIR_GAP, 2 * est_gap)
    share = float(np.mean(gaps < limit))
    share_2e3 = float(np.mean(gaps < PAIR_GAP))
    log(f"  {name}: kernels {c_kernel:.6f}, plain {c_plain:.6f}, |diff| "
        f"{abs(c_kernel - c_plain):.2e}; {gaps.size} comparable pairs, share with a plain gap "
        f"below {PAIR_GAP:g}: {share_2e3:.4f}, below {limit:.2e}: {share:.4f}")
    check(abs(c_kernel - c_plain) <= share, f"{name}: the kernel path's C-index moved "
                                            f"{abs(c_kernel - c_plain):.3e} > {share:.4f}")
    return {"kernel": c_kernel, "plain": c_plain, "pairs": int(gaps.size),
            "share_below_2e-3": share_2e3, "gap_limit": limit, "share_below_limit": share}


def exec_handler(torch, ab, co, device, cfg, before_exec=None, via_main=False) -> dict:
    """`exec()` of the handler of `cfg` (VLSA, SA or CLF, by its task) with every
    launch counter and the batcher's batch counts from 0 just before the
    handler is built: the handler, its metrics, the collected predictions of
    each evaluation pass by split, the launches by kernel family and
    variant, the batches by path, the seconds of the build, exec() and
    each evaluation pass, and the device memory allocated at the start and
    at the peak of the build and exec().  `before_exec(handler)` runs
    between the two (it launches no kernel).  With `via_main`, the run goes
    through the command line's entry, `vlsa_tpu_torch.main.main(["--config",
    <cfg as YAML beside its save path>, "--handler", "SA", "VLSA" or "CLF"])`, whose
    handler class is wrapped for these records."""
    from vlsa_tpu_torch import main as port_main
    from vlsa_tpu_torch.data import pipeline
    from vlsa_tpu_torch.runner.clf import CLFHandler
    from vlsa_tpu_torch.runner.sa import SAHandler
    from vlsa_tpu_torch.runner.vlsa import VLSAHandler

    families = {"coattn_fwd": co.LAUNCHES, "coattn_bwd_dq": co.LAUNCHES_BWD,
                "coattn_bwd_dx": co.LAUNCHES_DX, "abmil_fwd": ab.LAUNCHES,
                "abmil_bwd": ab.LAUNCHES_BWD, "abmil_fwd_route": ab.LAUNCHES_ROUTE,
                "abmil_bwd_route": ab.LAUNCHES_BWD_ROUTE}
    passes = {}  # split -> the collected predictions of each evaluation pass
    co.reset_launches()
    ab.reset_launches()
    pipeline.reset_batch_counts()
    gc.collect()  # earlier handlers sit in reference cycles: free their tensors first
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    base, name = {"vlsa": (VLSAHandler, "VLSA"), "sa": (SAHandler, "SA"),
                  "clf": (CLFHandler, "CLF")}[cfg["task"]]
    made = {}  # the handler, its build's seconds and its exec()'s

    class Recorded(base):
        def __init__(self, *args, **kws):
            t0 = time.perf_counter()
            super().__init__(*args, **kws)
            made.update(handler=self, build_s=time.perf_counter() - t0)

        def exec(self):
            if before_exec is not None:
                before_exec(self)
            test_model = self.test_model

            def recording(dataset, name, ckpt_path=None):
                out = test_model(dataset, name, ckpt_path=ckpt_path)
                passes.setdefault(name, []).append(out["pred"])
                return out
            self.test_model = recording
            made["window"] = HostMemoryWindow(torch)
            t0 = time.perf_counter()
            try:
                return super().exec()
            finally:
                torch.cuda.synchronize()
                made["exec_s"] = time.perf_counter() - t0
                self.test_model = test_model

    if via_main:
        import yaml
        path = cfg["save_path"].rstrip("/") + ".yaml"  # the handler writes its own config.yaml
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        shipped = port_main.HANDLERS[name]
        port_main.HANDLERS[name] = Recorded
        try:
            metrics = port_main.main(["--config", path, "--handler", name,
                                      "--device", str(device)])
        finally:
            port_main.HANDLERS[name] = shipped
    else:
        metrics = Recorded(cfg, device=device).exec()
    handler, build_s, exec_s = made["handler"], made["build_s"], made["exec_s"]
    window = made["window"]
    return {"handler": handler, "metrics": metrics, "passes": passes,
            "launches": {name: dict(counts) for name, counts in families.items()},
            "batches": dict(pipeline.BATCHES), "build_s": build_s, "exec_s": exec_s,
            "eval_passes": list(handler.timings["eval"]), "host_memory": window.close(),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "device_bytes_at_start": start_bytes}


def _proc_status_bytes(key: str) -> Optional[int]:
    """A `kB` line of /proc/self/status in bytes (None off Linux)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def host_memory_bytes() -> Optional[int]:
    """The host's memory (MemTotal of /proc/meminfo) in bytes (None off
    Linux)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class HostMemoryWindow:
    """The host memory of one stretch of the process: the resident set at
    its start and its peak within the stretch (VmRSS read every
    `RSS_SAMPLE_S` by a thread; None off Linux), and torch's page-locked
    pool: the peak bytes of its blocks (active and cached, each a power of
    two), the blocks it asked CUDA for and the seconds that took (None where
    this torch has no host statistics); and the batches' page-locked pool
    (`data.pipeline.PINNED_POOL`): its peak bytes, the largest batch built
    in it, the buffers it allocated and the seconds that took."""

    def __init__(self, torch):
        import threading
        from vlsa_tpu_torch.data.pipeline import PINNED_POOL
        self.pool = PINNED_POOL
        self.pool.reset_peak()
        self.start = self.peak = _proc_status_bytes("VmRSS")
        self.done = threading.Event()
        self.sampler = threading.Thread(target=self._sample, daemon=True)
        if self.start is not None:
            self.sampler.start()
        self.stats = getattr(torch.cuda, "host_memory_stats", None)
        try:
            torch.cuda.reset_peak_host_memory_stats()
            self.before = self.stats()
        except (AttributeError, RuntimeError, TypeError):
            self.stats = None

    def _sample(self) -> None:
        while not self.done.wait(RSS_SAMPLE_S):
            self.peak = max(self.peak, _proc_status_bytes("VmRSS") or 0)

    def close(self) -> dict:
        self.done.set()
        if self.sampler.is_alive():
            self.sampler.join()
            self.peak = max(self.peak, _proc_status_bytes("VmRSS") or 0)
        out = {"rss_start_bytes": self.start, "rss_peak_bytes": self.peak,
               "rss_rise_bytes": None if self.start is None else self.peak - self.start,
               "batch_pool_peak_bytes": self.pool.peak_bytes,
               "batch_pool_largest_batch_bytes": self.pool.largest,
               "batch_pool_buffers_made": self.pool.buffers_made,
               "batch_pool_buffers_s": self.pool.buffers_s}
        if self.stats is not None:
            after = self.stats()
            out.update(pinned_peak_bytes=after.get("allocated_bytes.peak"),
                       pinned_blocks_made=after.get("num_host_alloc", 0)
                       - self.before.get("num_host_alloc", 0),
                       pinned_alloc_s=(after.get("host_alloc_time.total", 0)
                                       - self.before.get("host_alloc_time.total", 0)) / 1e6)
        return out


def describe_host_memory(m: dict) -> str:
    gib = lambda b: "not measured" if b is None else f"{b / 2**30:.1f} GiB"  # noqa: E731
    text = (f"host memory: resident {gib(m['rss_start_bytes'])} at the start, peak "
            f"{gib(m['rss_peak_bytes'])} within the run ({gib(m['rss_rise_bytes'])} above "
            f"its start)")
    if "pinned_peak_bytes" in m:
        text += (f"; torch's page-locked blocks peak {gib(m['pinned_peak_bytes'])}, "
                 f"{m['pinned_blocks_made']} made in {m['pinned_alloc_s']:.2f} s")
    if "batch_pool_peak_bytes" in m:
        text += (f"; the batch pool peak {gib(m['batch_pool_peak_bytes'])} (largest batch "
                 f"{gib(m['batch_pool_largest_batch_bytes'])}), "
                 f"{m['batch_pool_buffers_made']} buffers made in "
                 f"{m['batch_pool_buffers_s']:.2f} s")
    return text


def expected_launches(handler, launches, variant) -> dict:
    """The launches an `exec()` of fold 0 makes (no validation split): each
    epoch trains the training split's batches and evaluates the test split;
    the final passes evaluate both splits again.  All in `variant` of the
    model's kernels (co-attention forward and dQ, or ABMIL forward and
    backward); none of any other.  `variant` None: no kernel at all (a
    model whose pooling is plain ops)."""
    cfg = handler.cfg
    epochs = len(handler.timings["epochs"])
    n_train = len(handler.trainer.batcher)
    test_set = handler.prepare_dataset(handler.data_split["test"], "test")
    n_test = -(-len(test_set) // cfg.get("eval_batch_size", cfg["bp_every_batch"]))
    fwd, bwd = (("coattn_fwd", "coattn_bwd_dq") if cfg["task"] == "vlsa"
                else ("abmil_fwd", "abmil_bwd"))
    expected = {name: dict.fromkeys(counts, 0) for name, counts in launches.items()}
    if variant is None:
        return expected
    # adahessian's training steps run the plain versions (the switch): only
    # the evaluation passes launch
    steps = 0 if str(cfg.get("opt_name", "")).lower() == "adahessian" else n_train
    expected[fwd][variant] = epochs * (steps + n_test) + n_train + n_test
    expected[bwd][variant] = epochs * steps
    if cfg["task"] != "vlsa":  # ABMIL: each call on the instances of the model's width
        import torch
        from vlsa_tpu_torch.ops import abmil as ab
        D, H = (int(d) for d in str(cfg["net_dims"]).split("-")[:2])
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[variant]
        rt = ab.route(dtype, D, H)
        expected["abmil_fwd_route"][rt] = expected[fwd][variant]
        expected["abmil_bwd_route"][rt] = expected[bwd][variant]
    return expected


def log_run_times(name, epochs, eval_passes, card) -> None:
    for r in epochs:
        log(f"{name} epoch {r['epoch']} on {card}: {r['wall_s']:.1f} s, "
            f"{r['slides_per_sec']:.2f} slides/s; waiting for batches {r['prep_s']:.1f} s "
            f"({100 * r['prep_s'] / r['wall_s']:.0f}% of the epoch), building them "
            f"{r['build_s']:.1f} s ({100 * r['build_s'] / r['wall_s']:.0f}%)")
    for r in eval_passes:
        log(f"{name} eval pass {r['split']:5s} ({r['bags']} bags): {r['seconds']:.1f} s")


def phase_lifecycle(torch, ab, co, device, kind, card, **changes):
    """One run of `python -m vlsa_tpu_torch.main`'s handler on the card:
    exec() of the shipped config's fold 0 (epochs cut; `changes` to the
    config), every launch counter from 0 just before, then its files, the
    reload and the plain path checked."""
    import numpy as np
    from vlsa_tpu_torch.eval import predict_mean_survival_time
    from vlsa_tpu_torch.runner.ckpt import load_checkpoint, merge_state
    from vlsa_tpu_torch.runner.train import make_dataset

    vlsa = kind == "vlsa"
    base_cfg = LIFECYCLE_VLSA_CFG if vlsa else LIFECYCLE_SA_CFG
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{kind}_")
    try:
        cfg = dict(base_cfg, **changes, save_path=os.path.join(tmp, "run"))
        # ---- the main path: every launch counter from 0 ----
        run = exec_handler(torch, ab, co, device, cfg)
        handler, metrics, passes, launches = (run[k] for k in ("handler", "metrics", "passes",
                                                                "launches"))
        build_s, exec_s, eval_passes = run["build_s"], run["exec_s"], run["eval_passes"]

        epochs = cfg["epochs"]
        test_set = make_dataset(handler.cfg, handler.data_meta, handler.data_split["test"])
        check(len(handler.trainer.dataset) == 298 and len(test_set) == 75
              and "validation" not in handler.data_split,
              f"fold 0: {len(handler.trainer.dataset)} training, {len(test_set)} test patients")
        expected = expected_launches(handler, launches, "bf16" if vlsa else "f32")
        log(f"{kind} lifecycle launches {launches}")
        check(launches == expected, f"{kind} lifecycle launches {launches}, expected {expected}")

        # ---- every epoch's and the final metrics ----
        names = LIFECYCLE_METRICS + (("loss_SurvEMD",) if vlsa else ())
        with open(os.path.join(cfg["save_path"], "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        evals = [e for e in events if e["event"] == "eval"]
        groups = [f"{s}/pred" for s in ("train", "test")] + \
            [f"lastckpt/train/{s}/pred" for s in ("train", "test")]
        seen = 0
        for e in evals:
            for g in groups:
                vals = {m: e.get(f"{g}/{m}") for m in names}
                if vals[names[0]] is None:
                    continue
                seen += 1
                check(all(v is not None and np.isfinite(v) for v in vals.values()),
                      f"{kind} epoch {e['at']} {g}: a missing or non-finite metric {vals}")
                check(0.0 <= vals["c_index"] <= 1.0 and 0.0 <= vals["c_index2"] <= 1.0,
                      f"{kind} epoch {e['at']} {g}: a C-index outside [0, 1]")
        check(seen == 2 * epochs + 2, f"{kind}: {seen} metric groups, expected {2 * epochs + 2}")
        epoch_metrics = {e["at"]: {k: v for k, v in e.items() if k.endswith(names)}
                         for e in evals}

        # ---- the checkpoint, reload and files ----
        ckpt_path = os.path.join(cfg["save_path"], "train_model-last.ckpt")
        check(os.path.exists(ckpt_path), f"{kind}: no {ckpt_path}")
        ckpt = load_checkpoint(ckpt_path)
        check(ckpt["epoch"] == epochs and ckpt["optimizer"]["state"],
              f"{kind}: checkpoint epoch {ckpt['epoch']}, optimizer state missing")
        if vlsa:
            check(not any(k.startswith("prompt_encoder.") for k in ckpt["model"])
                  and any(k.startswith("prompt_learner.") for k in ckpt["model"]),
                  "the checkpoint holds the frozen text tower, or no prompt learner")
        merge_state(handler.model, ckpt["model"])
        # the last epoch's test pass ran on the in-memory final weights, the
        # final one after loading the checkpoint: bit for bit the same
        in_memory, reloaded = passes["test"][-2], passes["test"][-1]
        check(np.array_equal(in_memory["y_hat"], reloaded["y_hat"]),
              f"{kind}: the reloaded checkpoint's test probabilities differ from the in-memory "
              f"model's by {np.abs(in_memory['y_hat'] - reloaded['y_hat']).max():.3e}")
        rows = {}
        for split, n in (("train", 298), ("test", 75)):
            ids, vals = read_prediction_csv(os.path.join(
                cfg["save_path"], f"{cfg['task']}_train_last_pred_{split}.csv"))
            rows[split] = len(ids)
            check(len(ids) == n and vals.shape[1] == 3 + handler.data_meta.num_bins,
                  f"{kind} {split} CSV: {len(ids)} rows, {vals.shape[1]} columns")
            check(bool(np.all(np.diff(vals[:, 3:], axis=1) <= 0)),
                  f"{kind} {split} CSV: a survival curve rises")

        # ---- the same weights through the plain pooling ----
        t0 = time.perf_counter()
        with (plain_coattention() if vlsa else plain_abmil()):
            plain = handler.test_model(test_set, "test")["pred"]
        plain_s = time.perf_counter() - t0
        prob_gap = float(np.abs(reloaded["y_hat"] - plain["y_hat"]).max())
        log(f"{kind} test probabilities, kernels vs plain: max|k-p| {prob_gap:.3e} "
            f"(tol {TOL_LIFECYCLE_PROBS:g})")
        check(prob_gap <= TOL_LIFECYCLE_PROBS, f"{kind}: test probabilities deviate "
                                               f"{prob_gap:.3e} from the plain path's")
        c_kernel = handler.evaluator.compute(reloaded, ["c_index", "c_index2"])
        c_plain = handler.evaluator.compute(plain, ["c_index", "c_index2"])
        coords = handler.data_meta.time_coordinates
        actual = handler.data_meta.get_patient_data(pids=plain["uid"], ret_columns=["t", "e"])

        def risk(p):  # c_index2's risk: the sum of the survival curve
            return np.sum(np.clip(1.0 - np.cumsum(p["y_hat"], axis=1), 0, None), axis=1)

        def mean_time(p):  # c_index's estimate: the predicted mean survival time
            return np.array([predict_mean_survival_time(s, coords) for s in
                             np.clip(1.0 - np.cumsum(p["y_hat"], axis=1), 0, None)])
        c_check = {
            "c_index2": hold_c_index("c_index2 (risk = sum of the survival curve)",
                                     c_kernel["c_index2"], c_plain["c_index2"],
                                     comparable_pair_gaps(plain["y"][:, 0], plain["y"][:, 1],
                                                          risk(plain)),
                                     float(np.abs(risk(reloaded) - risk(plain)).max())),
            "c_index": hold_c_index("c_index (predicted mean survival time)",
                                    c_kernel["c_index"], c_plain["c_index"],
                                    comparable_pair_gaps(actual["t"], actual["e"],
                                                         mean_time(plain)),
                                    float(np.abs(mean_time(reloaded) - mean_time(plain)).max()))}

        ep = handler.timings["epochs"]
        log_run_times(kind, ep, eval_passes, card)
        log(f"{kind} lifecycle: build {build_s:.1f} s, exec {exec_s:.1f} s, plain test pass "
            f"{plain_s:.1f} s, {describe_host_memory(run['host_memory'])}, on {card}; final "
            f"metrics {metrics}")
        return {"config": {k: v for k, v in cfg.items() if k != "save_path"},
                "reduced": LIFECYCLE_REDUCED[kind], "card": card, "build_s": build_s,
                "exec_s": exec_s, "metrics": metrics, "epoch_metrics": epoch_metrics,
                "epochs": ep, "eval_passes": eval_passes, "plain_test_pass_s": plain_s,
                "launches": launches, "host_memory": run["host_memory"],
                "csv_rows": rows, "test_prob_gap_to_plain": prob_gap, "c_index_check": c_check,
                "reload_bit_identical": True}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 3h

def same_bytes(torch, a: dict, b: dict) -> bool:
    """Two batches with the same keys, dtypes, shapes and bytes."""
    def raw(t):
        return t.contiguous().view(-1).view(torch.uint8)
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and raw(a[k]).equal(raw(b[k]))
        for k in a)


def write_stores(tmp, sids, bags=STORE_BAGS, slide_bytes=STORE_SLIDE_BYTES,
                 convert=True) -> dict:
    """The .npy store of `sids` (their `bags`, 8 threads) and, with
    `convert`, its .q8npz conversion by the port's CLI: {store: (directory,
    bytes, s)}."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from vlsa_tpu_torch.data.io import synthetic_bag

    need = int(STORE_MARGIN * len(sids) * slide_bytes)
    free = shutil.disk_usage(tmp).free
    log(f"stores: {free} bytes free under {tmp}, about {need} needed")
    check(free >= need, f"the stores need about {need} bytes of disk, {free} are free")
    npy, q8 = os.path.join(tmp, "npy"), os.path.join(tmp, "q8npz")
    os.makedirs(npy)

    def write(sid):
        np.save(os.path.join(npy, sid + ".npy"), synthetic_bag(sid, bags))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, sids))
    npy_s = time.perf_counter() - t0

    def size(d):
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    stores = {"npy": (npy, size(npy), npy_s)}
    if convert:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "vlsa_tpu_torch.data.convert", "--src",
                               npy, "--dst", q8, "--dtype", "int8"], cwd=ROOT,
                              capture_output=True, text=True)
        q8_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"the store conversion failed:\n{proc.stderr[-3000:]}")
        stores["q8npz"] = (q8, size(q8), q8_s)
    for name, (d, nbytes, sec) in stores.items():
        n = len(os.listdir(d))
        check(n == len(sids), f"the {name} store holds {n} files, not {len(sids)}")
        log(f"{name} store: {n} slides, {nbytes} bytes ({nbytes / 1e9:.2f} GB), written in "
            f"{sec:.1f} s")
    return stores


def hold_native_batches(torch, stores, meta, pids) -> dict:
    """One batch of 32 test patients from each store, native (in pinned
    memory) and numpy (the same dataset with `bag_paths` hidden): the same
    bytes."""
    from vlsa_tpu_torch.data import pipeline
    from vlsa_tpu_torch.data.bags import SurvBagDataset
    from vlsa_tpu_torch.data.pipeline import BagBatcher

    out = {}
    for store, feats_dtype in (("npy", "float32"), ("npy", "bfloat16"), ("q8npz", "int8")):
        d = stores[store][0]
        native_ds = SurvBagDataset(pids, d, meta, read_format=store)
        plain_ds = SurvBagDataset(pids, d, meta, read_format=store)
        plain_ds.bag_paths = lambda i: None
        kw = dict(batch_size=32, feats_dtype=feats_dtype, precompute_inv=True, prefetch=0)
        pipeline.reset_batch_counts()
        t0 = time.perf_counter()
        # the main path's batch: page-locked, as a run on the card makes it
        native = BagBatcher(native_ds, pin_memory=True, **kw).make_batch(range(32))
        check(native["feats"].is_pinned(), f"{store} {feats_dtype}: the batch is not pinned")
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = BagBatcher(plain_ds, **kw).make_batch(range(32))
        plain_s = time.perf_counter() - t0
        check(pipeline.BATCHES == {"native": 1, "numpy": 1},
              f"{store} {feats_dtype}: batches by path {pipeline.BATCHES}")
        same = same_bytes(torch, native, plain)
        key = f"{store}_{feats_dtype}"
        copy_s = copy_seconds(torch, native["feats"])
        out[key] = {"bucket": int(native["mask"].shape[1]), "native_s": native_s,
                    "numpy_s": plain_s, "identical": same, "feats_bytes":
                    native["feats"].nbytes, "copy_s": copy_s}
        log(f"{key}: one batch of 32 bags (bucket {out[key]['bucket']}, keys "
            f"{sorted(native)}): native {native_s:.2f} s, numpy {plain_s:.2f} s, "
            f"byte-identical {same}; its {native['feats'].nbytes} bytes of features to the "
            f"card from page-locked memory {copy_s['pinned']:.3f} s, from pageable "
            f"{copy_s['pageable']:.3f} s")
        check(same, f"{key}: the native batch differs from the numpy path's")
    return out


def copy_seconds(torch, pinned) -> dict:
    """Seconds of the copy of a host tensor to the card (host clock to a
    synchronize), from page-locked memory and from a pageable copy of it,
    in turns (pinned, pageable, pageable, pinned): the least of each."""
    pageable = torch.empty_like(pinned, pin_memory=False).copy_(pinned)
    check(pinned.is_pinned() and not pageable.is_pinned(), "the copies' memory kinds")
    times = {"pinned": [], "pageable": []}
    for kind in ("pinned", "pageable", "pageable", "pinned"):
        src = pinned if kind == "pinned" else pageable
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst = src.to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        times[kind].append(time.perf_counter() - t0)
        del dst
    return {k: min(v) for k, v in times.items()}


def store_run(torch, ab, co, device, card, stores, tmp, name, base_cfg, store, changes,
              variant, epochs=1, before_exec=None, after_exec=None, keep=None,
              hold_reload=False, via_main=False) -> dict:
    """One run of STORE_RUNS (of `epochs` epochs): `exec()` of a fresh
    handler from `store` with every launch and batch counter from 0 just
    before (`before_exec` as exec_handler's), then its checks (with
    `hold_reload`, also the reloaded checkpoint's test probabilities equal
    to the in-memory model's bit for bit) and `after_exec(handler)`, whose
    result goes to the record's "after"; `keep[name]` is then the trained
    model.  `via_main`: through the command line's entry (exec_handler)."""
    import numpy as np
    from vlsa_tpu_torch.data.bags import FewShotSurvBagDataset, SurvBagDataset
    from vlsa_tpu_torch.data.pipeline import release_pinned_batches
    from vlsa_tpu_torch.runner.train import make_dataset

    cfg = dict(base_cfg, **changes, epochs=epochs, path_patch=stores[store][0], feat_format=store,
               save_path=os.path.join(tmp, name))
    run = exec_handler(torch, ab, co, device, cfg, before_exec=before_exec, via_main=via_main)
    handler, launches = run["handler"], run["launches"]
    check(run["batches"]["numpy"] == 0 and run["batches"]["native"] > 0,
          f"{name}: batches by path {run['batches']}: every batch must be native")
    expected = expected_launches(handler, launches, variant)
    check(launches == expected, f"{name}: launches {launches}, expected {expected}")
    # every metric of every evaluation finite, each C-index in [0, 1]
    with open(os.path.join(cfg["save_path"], "metrics.jsonl")) as f:
        evals = [e for e in map(json.loads, f) if e["event"] == "eval"]
    values = {k: v for e in evals for k, v in e.items() if k not in ("event", "at", "ts")}
    check(len(evals) == 2 * epochs + 2 and values
          and all(np.isfinite(v) for v in values.values()),
          f"{name}: {len(evals)} evaluations, a non-finite metric in {values}")
    c_idx = {k: v for k, v in values.items() if k.endswith(("/c_index", "/c_index2"))}
    check(c_idx and all(0.0 <= v <= 1.0 for v in c_idx.values()),
          f"{name}: a C-index outside [0, 1]: {c_idx}")
    n_train = len(handler.trainer.dataset)
    if cfg.get("num_shot", -1) > 0:
        plain_set = SurvBagDataset(handler.data_split["train"], stores[store][0],
                                   handler.data_meta, read_format=store)
        idx = FewShotSurvBagDataset(plain_set, cfg["num_shot"],
                                    cfg.get("seed_shot", 42)).few_shot_idx
        check(handler.trainer.dataset.few_shot_idx == idx and n_train == len(idx),
              f"{name}: {n_train} training patients, the sample has {len(idx)}")
    else:
        check(n_train == 298, f"{name}: {n_train} training patients")
    # the final test pass against the same weights through the plain pooling
    test_set = make_dataset(handler.cfg, handler.data_meta, handler.data_split["test"])
    with (plain_coattention() if cfg["task"] == "vlsa" else plain_abmil()):
        plain = handler.test_model(test_set, "test")["pred"]
    release_pinned_batches()  # the next run starts, as this one did, with none kept
    gap = float(np.abs(run["passes"]["test"][-1]["y_hat"] - plain["y_hat"]).max())
    check(gap <= TOL_LIFECYCLE_PROBS, f"{name}: test predictions deviate {gap:.3e} "
                                      f"from the plain pooling's")
    if hold_reload:  # the final pass after loading the checkpoint: bit for bit the same
        in_memory, reloaded = run["passes"]["test"][-2], run["passes"]["test"][-1]
        check(np.array_equal(in_memory["y_hat"], reloaded["y_hat"]),
              f"{name}: the reloaded checkpoint's test probabilities differ from the in-memory "
              f"model's by {np.abs(in_memory['y_hat'] - reloaded['y_hat']).max():.3e}")
    log_run_times(name, handler.timings["epochs"], run["eval_passes"], card)
    log(f"{name}: {n_train} training patients, build {run['build_s']:.1f} s, exec "
        f"{run['exec_s']:.1f} s, {run['batches']['native']} native batches, launches "
        f"{ {k: {v: n for v, n in c.items() if n} for k, c in launches.items()} }, "
        f"test predictions vs plain {gap:.3e} (tol {TOL_LIFECYCLE_PROBS:g}), "
        f"{describe_host_memory(run['host_memory'])}, peak device memory "
        f"{run['peak_device_bytes'] / 2**30:.2f} GiB, on {card}; the store read from a page "
        f"cache its writing warmed; final metrics {run['metrics']}")
    after = after_exec(handler) if after_exec is not None else None
    if keep is not None:
        keep[name] = handler.model
    out = {"config": {k: v for k, v in cfg.items() if k != "save_path"},
           "reduced": STORE_REDUCED, "card": card, "variant": variant,
           "train_patients": n_train, "build_s": run["build_s"], "exec_s": run["exec_s"],
           "epochs": handler.timings["epochs"], "eval_passes": run["eval_passes"],
           "batches": run["batches"], "launches": launches, "metrics": run["metrics"],
           "test_pred_gap_to_plain": gap, "host_memory": run["host_memory"],
           "peak_device_bytes": run["peak_device_bytes"]}
    if hold_reload:
        out["reload_bit_identical"] = True
    if after is not None:
        out["after"] = after
    del handler, run
    torch.cuda.empty_cache()
    return out


def fold0_slides():
    """(label table, split, the ids of fold 0's 437 slides)."""
    from vlsa_tpu_torch.config import training_config
    from vlsa_tpu_torch.data.label_converter import MetaSurvData
    from vlsa_tpu_torch.data.splits import read_file_data_splitting

    cfg = training_config(dict(LIFECYCLE_SA_CFG), 0)
    split = read_file_data_splitting(cfg["data_split_path"])
    meta = MetaSurvData(cfg["path_table"], data_split=split)
    meta.generate_discrete_label(use_quantiles=False)
    sids = sorted({s for p in split["train"] + split["test"]
                   for s in meta.collect_info_by_pids([p])[1][p]})
    check(len(sids) == 437, f"fold 0 has {len(sids)} slides, not 437")
    return meta, split, sids


def phase_store_runs(torch, ab, co, device, card, tmp, keep):
    """Phase 3h: the stores in `tmp` (kept for phases 3i and 3j, as is
    INTERP_RUN's directory, whose trained model goes to `keep`; the caller
    removes them), one batch of each native against numpy, then every run
    of STORE_RUNS."""
    from vlsa_tpu_torch.data.pipeline import release_pinned_batches

    meta, split, sids = fold0_slides()
    stores = write_stores(tmp, sids)
    batches_check = hold_native_batches(torch, stores, meta, split["test"][:32])
    release_pinned_batches()  # each run starts with no page-locked block kept
    runs = {spec[0]: store_run(torch, ab, co, device, card, stores, tmp, *spec,
                               keep=keep if spec[0] == INTERP_RUN else None)
            for spec in STORE_RUNS}
    return {"stores": {k: {"bytes": v[1], "seconds": v[2]} for k, v in stores.items()},
            "native_vs_numpy": batches_check, "runs": runs}


# ---------------------------------------------------------------- phases 3k and 3m

def sa_wide_after(torch, ab, co, device, storage, bags, net_dims):
    """After a run of phase 3k or 3m: one request of BAGS_PER_REQUEST bags of
    `bags` served by the trained model in the run's storage type
    (`InferEngine`, as `python -m vlsa_tpu_torch.runner.serve`), exactly one
    general forward launched, probabilities within 1e-3 of the plain
    pooling's; then one training batch's parameter gradients through the
    kernels against the plain versions (TOL_GRAD; patients censored in the
    last bin left out of `valid`, as phase 3d).  The model's net_dims must
    be `net_dims`."""
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags

    feats_dtype = {"f32": "float32", "int8": "int8"}[storage]
    what = f"SA {net_dims} {storage}"

    def after(handler):
        model = handler.model
        model.eval()
        engine = InferEngine(model, feats_dtype=feats_dtype, precompute_inv=False)
        batch = engine.prepare(request_bags(bags, 0, BAGS_PER_REQUEST))
        ab.reset_launches()
        co.reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = engine.forward(batch)
        torch.cuda.synchronize()
        serve_ms = 1e3 * (time.perf_counter() - t0)
        check(dict(ab.LAUNCHES) == dict.fromkeys(ab.LAUNCHES, 0) | {storage: 1}
              and ab.LAUNCHES_ROUTE["general"] == 1 and sum(ab.LAUNCHES_BWD.values()) == 0
              and sum(co.LAUNCHES.values()) == 0,
              f"{what} served request launches {ab.LAUNCHES}, {ab.LAUNCHES_ROUTE}")
        with plain_abmil(), torch.inference_mode():
            plain = engine.forward(batch)
        dev = float((out["probs"] - plain["probs"]).abs().max())
        check(bool(torch.isfinite(out["logits"]).all()) and dev <= TOL_LIFECYCLE_PROBS,
              f"{what} request: probabilities {dev:.3e} from the plain pooling's")
        check(handler.cfg["net_dims"] == net_dims,
              f"{what}: net_dims {handler.cfg['net_dims']}, not {net_dims}")
        batcher = handler.trainer.batcher  # the model stays in eval mode: no dropout draws
        b = {k: v.to(device) for k, v in
             batcher.make_batch(range(min(batcher.batch_size, len(batcher.dataset)))).items()}
        K = handler.data_meta.num_bins
        ill = b["valid"] & (b["e"] == 0) & (b["t"] == K - 1)
        b = dict(b, valid=b["valid"] & ~ill)
        g_kernel = param_grads(torch, model, handler.engine, b)
        with plain_abmil():
            g_plain = param_grads(torch, model, handler.engine, b)
        devs = grad_devs(g_kernel, g_plain, [n for n, _p in model.named_parameters()
                                             if n != "sigma.fc2_bias"])
        worst = max(devs, key=devs.get)
        log(f"{what}: a request of {BAGS_PER_REQUEST} bags {serve_ms:.1f} ms, "
            f"probabilities vs plain {dev:.2e}; gradients of a batch of "
            f"{int(b['valid'].sum())} bags (bucket {b['mask'].shape[1]}) vs plain: worst "
            f"{worst} {devs[worst]:.2e} (tol {TOL_GRAD:g})")
        check(devs[worst] <= TOL_GRAD, f"{what}: gradient of {worst} deviates "
                                       f"{devs[worst]:.3e}")
        del g_kernel, g_plain, b
        return {"net_dims": handler.cfg["net_dims"], "serve_ms": serve_ms,
                "served_prob_dev": dev, "grad_dev": devs}
    return after


def sa_wide_runs(torch, ab, co, device, card, tmp, bags, slide_bytes, runs, net_dims,
                 reduced, after_runs=None) -> dict:
    """`runs` (as SA1024_RUNS) from the stores of fold 0's slides as `bags`
    in `tmp` (the .q8npz conversion only where a run reads it), each through
    `main` with the reload held and `sa_wide_after`'s checks, every launch
    on the general instances; then `after_runs(stores)`, whose result goes to
    the record's "after_runs".  The host's peak resident set is in each
    run's record (store_run logs it)."""
    _meta, _split, sids = fold0_slides()
    stores = write_stores(tmp, sids, bags, slide_bytes,
                          convert=any(spec[2] == "q8npz" for spec in runs))
    out = {}
    for spec in runs:
        run = store_run(torch, ab, co, device, card, stores, tmp, *spec, hold_reload=True,
                        after_exec=sa_wide_after(torch, ab, co, device, spec[4], bags,
                                                 net_dims),
                        via_main=True)
        check(run["launches"]["abmil_fwd_route"]["general"] > 0,
              f"{spec[0]}: routes {run['launches']['abmil_fwd_route']}")
        peak, total = run["host_memory"]["rss_peak_bytes"], host_memory_bytes()
        if peak is not None and total is not None:
            log(f"{spec[0]}: the host's resident set peaked at {peak / total:.3f} of its "
                f"{total / 2**30:.1f} GiB (limit {HOST_RSS_SHARE})")
            check(peak <= HOST_RSS_SHARE * total,
                  f"{spec[0]}: the host's resident set peaked at {peak / 2**30:.1f} GiB, "
                  f"above {HOST_RSS_SHARE} of its {total / 2**30:.1f} GiB")
        hm = run["host_memory"]
        slots = run["config"].get("prefetch", 2) + 2
        bound = slots * hm["batch_pool_largest_batch_bytes"]
        log(f"{spec[0]}: the batch pool peaked at {hm['batch_pool_peak_bytes']} bytes, bound "
            f"{slots} x the largest batch = {bound}")
        check(0 < hm["batch_pool_peak_bytes"] <= bound,
              f"{spec[0]}: the batch pool's {hm['batch_pool_peak_bytes']} bytes pass {bound}")
        run["reduced"] = dict(run["reduced"], **reduced)
        out[spec[0]] = run
    rec = {"stores": {k: {"bytes": v[1], "seconds": v[2]} for k, v in stores.items()},
           "runs": out, "reduced": reduced}
    if after_runs is not None:
        rec["after_runs"] = after_runs(stores)
    return rec


def phase_sa_1024(torch, ab, co, device, card):
    """Phase 3k: SA1024_RUNS from their own store in a temporary directory,
    removed at the end."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sa1024_")
    try:
        return sa_wide_runs(torch, ab, co, device, card, tmp, SA1024_BAGS, SA1024_SLIDE_BYTES,
                            SA1024_RUNS, "1024-256-12", SA1024_REDUCED)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sa2560_feat_proj_step(torch, ab, co, device, stores) -> dict:
    """One Adam step of the SA at 2560-256-12 with `deepmil_use_feat_proj:
    True` (a 2560 -> 2560 projecter: the pooling's features need a gradient)
    on a batch of the f32 store, every counter from 0: one general forward
    and one general backward with dX ("f32_dx"); finite loss, every
    parameter but fc2's bias moved; then that batch's gradients against the
    plain path (TOL_GRAD)."""
    import numpy as np
    from vlsa_tpu_torch.config import training_config
    from vlsa_tpu_torch.runner.train import Trainer

    cfg = training_config(dict(SA2560_CFG, deepmil_use_feat_proj=True,
                               path_patch=stores["npy"][0], feat_format="npy"), fold=0)
    trainer = Trainer(cfg, device)
    trainer.batcher.prefetch = 0
    check(cfg["net_dims"] == "2560-256-12", f"SA 2560 projecter: net_dims {cfg['net_dims']}")
    b = {k: v.to(device) for k, v in trainer.batcher.make_batch(
        range(min(trainer.batcher.batch_size, len(trainer.dataset)))).items()}
    model = trainer.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ab.reset_launches()
    co.reset_launches()
    t0 = time.perf_counter()
    loss, raw = trainer.engine.train_step(b)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    launches = {"fwd": dict(ab.LAUNCHES), "bwd": dict(ab.LAUNCHES_BWD),
                "fwd_route": dict(ab.LAUNCHES_ROUTE), "bwd_route": dict(ab.LAUNCHES_BWD_ROUTE)}
    check(launches["fwd"] == dict.fromkeys(ab.LAUNCHES, 0) | {"f32": 1}
          and launches["bwd"] == dict.fromkeys(ab.LAUNCHES_BWD, 0) | {"f32_dx": 1}
          and launches["fwd_route"]["general"] == 1 and launches["bwd_route"]["general"] == 1,
          f"SA 2560 projecter step launches {launches}")
    check(bool(np.isfinite(float(loss))) and bool(torch.isfinite(raw).all()),
          "SA 2560 projecter step: a non-finite loss or logits")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n]) != (n == "sigma.fc2_bias")]
    check(not still, f"SA 2560 projecter step: {still} moved or stayed against the rule")
    K = trainer.meta.num_bins
    ill = b["valid"] & (b["e"] == 0) & (b["t"] == K - 1)
    b = dict(b, valid=b["valid"] & ~ill)
    g_kernel = param_grads(torch, model, trainer.engine, b)
    with plain_abmil():
        g_plain = param_grads(torch, model, trainer.engine, b)
    devs = grad_devs(g_kernel, g_plain, [n for n, _p in model.named_parameters()
                                         if n != "sigma.fc2_bias"])
    worst = max(devs, key=devs.get)
    log(f"SA 2560 projecter step: loss {float(loss):.4f}, {int(b['valid'].sum())} bags, bucket "
        f"{b['mask'].shape[1]}, step {step_ms:.1f} ms, launches {launches}; gradients vs plain "
        f"worst {worst} {devs[worst]:.2e} (tol {TOL_GRAD:g})")
    check(devs[worst] <= TOL_GRAD, f"SA 2560 projecter: gradient of {worst} deviates "
                                   f"{devs[worst]:.3e}")
    out = {"loss": float(loss), "bucket": int(b["mask"].shape[1]), "step_ms": step_ms,
           "launches": launches, "grad_dev": devs}
    del trainer, model, g_kernel, g_plain, b
    torch.cuda.empty_cache()
    return out


def phase_sa_2560(torch, ab, co, device, card):
    """Phase 3m: SA2560_RUNS from their own stores in a temporary directory,
    then the projecter step from the f32 store; the stores removed at the
    end."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sa2560_")
    try:
        return sa_wide_runs(torch, ab, co, device, card, tmp, SA2560_BAGS, SA2560_SLIDE_BYTES,
                            SA2560_RUNS, "2560-256-12", SA2560_REDUCED,
                            after_runs=lambda stores: sa2560_feat_proj_step(
                                torch, ab, co, device, stores))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 3n

def eval_loss(model, objective, batch):
    """The training objective of `batch` with the model in eval mode (no
    dropout draw: the card's and the CPU's generators differ), as
    `TrainEngine.loss` forms it otherwise."""
    from vlsa_tpu_torch.runner.engine import feats_inputs, model_extras

    feats, kws = feats_inputs(model, batch)
    out = model(feats, batch["mask"], **kws, **model_extras(batch))
    raw = out[0] if isinstance(out, tuple) else out
    vl = {}
    if getattr(model, "uses_vl", False):
        vl = {"logit_scale": model.get_logit_scale(), "query_div_fn": model.query_div_loss}
    return objective(raw, batch["t"], batch["e"], batch["valid"].to(raw.dtype), **vl)


def hessian_card_vs_cpu(torch, model, cpu_model, objective, batch, K, what, seed=0) -> dict:
    """The Hessian diagonal's estimate (`hutchinson_hessian_diag`) of the
    eval-mode objective on OPT_HESSIAN_BAGS bags of `batch` (cropped to
    their longest bag), one z drawn from `seed` for both: on the card inside
    `disable_kernels()` (the plain versions there: no launch) and by the port
    on the CPU with `cpu_model` (built on the CPU from the card model's
    weights; its parameters then take the card model's requires_grad, its
    buffers the card model's values); each
    leaf within TOL_HESSIAN of its largest element, or within
    HESSIAN_NOISE_FACTOR times the gap that a change of the CPU model's
    trainable weights at the size of f32 rounding (1e-7 relative, two draws)
    makes on its own there: a second derivative through the flagship's
    12-layer text tower amplifies f32 rounding far more than the SA's (as
    phase 3b holds the bf16 tower's gradients against such a floor).
    Patients censored in
    the last of the K bins are left out of `valid`, as phase 3b leaves them
    out of its gradient checks: their SurvIFMLE term is -log of rounding
    noise, whose derivatives are that noise amplified.  Returns {leaf:
    gap}."""
    from vlsa_tpu_torch.ops import abmil as ab
    from vlsa_tpu_torch.ops import coattn as co
    from vlsa_tpu_torch.ops.flags import disable_kernels
    from vlsa_tpu_torch.optim.extra import hutchinson_hessian_diag, rademacher

    n = OPT_HESSIAN_BAGS
    live = batch["mask"][:n].any(0).nonzero()
    N = int(live.max()) + 1 if live.numel() else 1
    sub = {k: (v[:n, :N] if k in ("feats", "mask", "feats_scale", "feats_inv") else v[:n])
           for k, v in batch.items()}
    ill = sub["valid"] & (sub["e"] == 0) & (sub["t"] == K - 1)
    sub["valid"] = sub["valid"] & ~ill
    names = [nm for nm, p in model.named_parameters() if p.requires_grad]
    gen = torch.Generator(device=batch["feats"].device).manual_seed(seed)
    z = [rademacher(p, gen) for nm, p in model.named_parameters() if p.requires_grad]

    def diag(m, b, zs):
        params = [p for _nm, p in m.named_parameters() if p.requires_grad]
        with disable_kernels():
            _g, d = hutchinson_hessian_diag(eval_loss(m, objective, b), params, names, z=zs)
        return dict(zip(names, d))
    before = sum(ab.LAUNCHES.values()) + sum(co.LAUNCHES.values())
    card = diag(model, sub, z)
    torch.cuda.synchronize()
    check(sum(ab.LAUNCHES.values()) + sum(co.LAUNCHES.values()) == before,
          f"{what}: the Hessian estimate under the switch launched a kernel")
    wants = {nm: p.requires_grad for nm, p in model.named_parameters()}
    for nm, p in cpu_model.named_parameters():
        p.requires_grad_(wants[nm])
    # the buffers too: the query adapter's prompt features, encoded once at
    # build time by the frozen bf16 tower, differ between the two devices by
    # bf16 roundings (3.7e-3 of the query on an H100; phase 3i's 2.68e-3)
    cpu_buffers = dict(cpu_model.named_buffers())
    with torch.no_grad():
        for nm, b in model.named_buffers():
            cpu_buffers[nm].copy_(b.cpu())
    cpu_model.eval()
    sub_cpu = {k: v.cpu() for k, v in sub.items()}
    z_cpu = [t.cpu() for t in z]
    cpu = diag(cpu_model, sub_cpu, z_cpu)

    def gaps_to_cpu(got):
        return {nm: float((got[nm].cpu().double() - cpu[nm].double()).abs().max()
                          / cpu[nm].double().abs().max().clamp_min(1e-300)) for nm in names}
    gaps = gaps_to_cpu(card)
    # the CPU's own sensitivity: the estimate again after its trainable
    # weights move by f32 rounding
    floor = dict.fromkeys(names, 0.0)
    weights = {nm: p.detach().clone() for nm, p in cpu_model.named_parameters()
               if p.requires_grad}
    for draw in range(2):
        gen_cpu = torch.Generator().manual_seed(100 + draw)
        with torch.no_grad():
            for nm, p in cpu_model.named_parameters():
                if p.requires_grad:
                    p.copy_(weights[nm] * (1 + 1e-7 * torch.randn(p.shape, generator=gen_cpu)))
        for nm, g in gaps_to_cpu(diag(cpu_model, sub_cpu, z_cpu)).items():
            floor[nm] = max(floor[nm], g)
    with torch.no_grad():
        for nm, p in cpu_model.named_parameters():
            if p.requires_grad:
                p.copy_(weights[nm])
    limits = {nm: max(TOL_HESSIAN, HESSIAN_NOISE_FACTOR * floor[nm]) for nm in names}
    worst = max(gaps, key=lambda nm: gaps[nm] / limits[nm])
    log(f"{what}: the Hessian diagonal's estimate on {int(sub['valid'].sum())} of {n} bags "
        f"({int(ill.sum())} censored in the last bin left out; bucket {N}), card on the plain "
        f"versions vs the port on the CPU | the CPU's own gap at 1e-7 weight noise: "
        + ", ".join(f"{nm} {gaps[nm]:.2e} | {floor[nm]:.2e}" for nm in names)
        + f"; worst {worst} against its limit {limits[worst]:.2e}")
    check(gaps[worst] <= limits[worst], f"{what}: the Hessian estimate of {worst} deviates "
                                        f"{gaps[worst]:.3e} from the CPU's, above "
                                        f"{limits[worst]:.3e}")
    del card, cpu
    return {"gap": gaps, "noise_floor": floor, "limit": limits}


def adahessian_steps(torch, ab, co, model, engine, batch, what, feats_dtype) -> dict:
    """ADAHESSIAN_STEPS adahessian steps on `batch`, each with every counter
    from 0: no kernel launched, a finite loss, the learnable parameters
    moved; then an evaluation forward (`InferEngine`) that launches the
    model's forward kernel once."""
    import numpy as np
    from vlsa_tpu_torch.runner.engine import InferEngine

    steps = []
    for i in range(ADAHESSIAN_STEPS):
        before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
        ab.reset_launches()
        co.reset_launches()
        t0 = time.perf_counter()
        loss, raw = engine.train_step(batch)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        launched = all_launches(ab, co)
        check(not any(v for c in launched.values() for v in c.values()),
              f"{what} adahessian step {i}: kernels launched {launched}")
        check(bool(np.isfinite(float(loss))) and bool(torch.isfinite(raw).all()),
              f"{what} adahessian step {i}: a non-finite loss or logits")
        still = [n for n, p in model.named_parameters() if p.requires_grad
                 and n != "sigma.fc2_bias" and torch.equal(p.detach(), before[n])]
        check(not still, f"{what} adahessian step {i}: {still} did not move")
        steps.append({"loss": float(loss), "step_ms": step_ms,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        log(f"{what} adahessian step {i}: loss {float(loss):.4f}, {step_ms:.1f} ms, no kernel "
            f"launched")
    model.eval()
    infer = InferEngine(model, feats_dtype=feats_dtype, precompute_inv=False)
    ab.reset_launches()
    co.reset_launches()
    out = infer.forward(batch)
    torch.cuda.synchronize()
    launched = all_launches(ab, co)
    n_launched = sum(v for c in launched.values() for v in c.values())
    check(n_launched == 1 and bool(torch.isfinite(out["probs"]).all()),
          f"{what}: the evaluation pass after the adahessian steps launched {launched}")
    log(f"{what}: the evaluation forward after them launched {launched}")
    return {"steps": steps, "eval_launches": launched}


def phase_optimizers(torch, ab, co, device, card, tmp):
    """Phase 3n: every name of the factory on the SA at 2560 (OPT_STEPS
    steps on the kernels, launches counted); adahessian on the flagship and
    the SA (`adahessian_steps`, `hessian_card_vs_cpu`); a double backward
    through the kernels raises; the flagship's adahessian epoch through
    `main` from phase 3h's stores in `tmp`."""
    import numpy as np
    from vlsa_tpu_torch.config import training_config
    from vlsa_tpu_torch.optim import create_optimizer
    from vlsa_tpu_torch.runner import sa
    from vlsa_tpu_torch.runner import vlsa as vlsa_runner
    from vlsa_tpu_torch.runner.engine import TrainEngine
    from vlsa_tpu_torch.runner.train import Trainer

    rec = {}
    # ---- every optimizer name on the SA at 2560-256-12, f32, on the kernels ----
    cfg = training_config(dict(SA2560_CFG, path_patch=OPT_SA_BAGS, bp_every_batch=OPT_BATCH),
                          fold=0)
    trainer = Trainer(cfg, device)
    trainer.batcher.prefetch = 0
    batches = [{k: v.to(device) for k, v in trainer.batcher.make_batch(
        range(i * OPT_BATCH, (i + 1) * OPT_BATCH)).items()}
        for i in range(max(OPT_STEPS, ADAHESSIAN_STEPS))]
    init = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    objective = trainer.engine.objective
    del trainer
    runs = {}
    for name in OPT_NAMES:
        model = sa.build_model(cfg, device=device, state_dict=init)
        model.train()
        opt = create_optimizer(name, cfg["opt_lr"], cfg["opt_weight_decay"], model)
        engine = TrainEngine(model, opt, objective, needs_hessian=name == "adahessian")
        hessian = name == "adahessian"
        if hessian:  # the steps on the plain versions, then the evaluation pass
            runs[name] = adahessian_steps(torch, ab, co, model, engine, batches[0],
                                          f"SA 2560 {name}", "float32")
            runs[name]["hessian_gap"] = hessian_card_vs_cpu(
                torch, model, sa.build_model(cfg, device="cpu", state_dict=model.state_dict()),
                objective, batches[0], int(str(cfg["net_dims"]).split("-")[-1]),
                f"SA 2560 {name}")
            continue
        losses, launched = [], {"fwd": 0, "bwd": 0}
        for i in range(OPT_STEPS):
            ab.reset_launches()
            co.reset_launches()
            loss, raw = engine.train_step(batches[i])
            torch.cuda.synchronize()
            check(ab.LAUNCHES == dict.fromkeys(ab.LAUNCHES, 0) | {"f32": 1}
                  and ab.LAUNCHES_BWD == dict.fromkeys(ab.LAUNCHES_BWD, 0) | {"f32": 1}
                  and ab.LAUNCHES_ROUTE["general"] == 1 and ab.LAUNCHES_BWD_ROUTE["general"] == 1
                  and sum(co.LAUNCHES.values()) == 0,
                  f"SA 2560 {name} step {i}: launches {ab.LAUNCHES}, {ab.LAUNCHES_BWD}, "
                  f"routes {ab.LAUNCHES_ROUTE}")
            launched["fwd"] += ab.LAUNCHES["f32"]
            launched["bwd"] += ab.LAUNCHES_BWD["f32"]
            losses.append(float(loss))
            check(bool(np.isfinite(float(loss))) and bool(torch.isfinite(raw).all()),
                  f"SA 2560 {name} step {i}: a non-finite loss")
        bad = [n for n, p in model.named_parameters() if not torch.isfinite(p).all()]
        check(not bad, f"SA 2560 {name}: non-finite parameters {bad}")
        still = [n for n, p in model.named_parameters() if torch.equal(p.detach(), init[n])]
        check(still in ([], ["sigma.fc2_bias"]), f"SA 2560 {name}: {still} did not move")
        runs[name] = {"optimizer": type(opt).__name__, "losses": losses, "launches": launched}
        log(f"SA 2560 {name} ({type(opt).__name__}): {OPT_STEPS} steps, losses "
            f"{[round(v, 4) for v in losses]}, launches {launched}")
        del model, opt, engine
    rec["sa_optimizers"] = runs
    rec["sa_launches"] = {k: sum(r["launches"][k] for r in runs.values() if "launches" in r)
                          for k in ("fwd", "bwd")}
    # ---- the loud failure: the Hessian estimate through the kernels raises ----
    from vlsa_tpu_torch.optim.extra import hutchinson_hessian_diag
    model = sa.build_model(cfg, device=device, state_dict=init)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for p in model.parameters() if p.requires_grad]
    raised = None
    try:
        hutchinson_hessian_diag(eval_loss(model, objective, batches[0]), params, names)
    except RuntimeError as exc:
        raised = str(exc)
    check(raised is not None and "disable_kernels" in raised,
          f"the Hessian estimate through the ABMIL kernels did not raise ({raised})")
    raised = raised or ""
    log(f"the Hessian estimate through the ABMIL kernels outside the switch raises: "
        f"{raised[:120]}")
    rec["double_backward_raises"] = raised[:300]
    del model, params, batches
    torch.cuda.empty_cache()

    # ---- adahessian on the flagship: phase 3b's batch, the text tower in f32 ----
    fcfg = training_config(dict(TRAIN_CFG, opt_name="adahessian"), fold=0)
    trainer = Trainer(fcfg, device)
    trainer.batcher.prefetch = 0
    check(trainer.engine.needs_hessian, "the flagship's engine does not take adahessian's step")
    batch = {k: v.to(device) for k, v in next(trainer.batches()).items()}
    model, engine = trainer.model, trainer.engine
    tower = model.prompt_encoder
    tower0 = {k: v.detach().clone() for k, v in tower.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    cpu_model = None
    with f32_text_tower(torch, tower):
        flag = adahessian_steps(torch, ab, co, model, engine, batch, "flagship", "bfloat16")
        check(all(torch.equal(v, tower0[k]) for k, v in tower.state_dict().items()),
              "flagship adahessian: the frozen tower changed")
        cpu_model = vlsa_runner.build_model(fcfg, device="cpu", state_dict=model.state_dict())
        with f32_text_tower(torch, cpu_model.prompt_encoder):
            flag["hessian_gap"] = hessian_card_vs_cpu(torch, model, cpu_model, engine.objective,
                                                      batch, trainer.meta.num_bins, "flagship")
    del cpu_model
    flag["bucket"] = int(batch["mask"].shape[1])
    flag["bags"] = int(batch["valid"].sum())
    rec["flagship"] = flag
    del trainer, model, engine, batch
    torch.cuda.empty_cache()

    # ---- the flagship's adahessian epoch through main, from 3h's bf16 store ----
    stores = {"npy": (os.path.join(tmp, "npy"),), "q8npz": (os.path.join(tmp, "q8npz"),)}
    rec["run"] = store_run(torch, ab, co, device, card, stores, tmp, *ADAHESSIAN_RUN,
                           via_main=True)
    return rec



# ---------------------------------------------------------------- phase 3o

def write_zoo_aux(torch, tmp, npy_dir) -> dict:
    """Beside phase 3h's .npy store in `tmp` (`npy_dir`): ZOO_CLUSTERS
    cluster ids a patch for each of fold 0's patients (`clusters/<pid>.npy`)
    and each slide's 8-neighbour grid graph (`graphs/<sid>.npz`, about 8N
    edges); one graph also written as a torch_geometric pickle (stub
    classes) and converted by `python -m vlsa_tpu_torch.data.convert
    --graphs`, which must give the same edge list."""
    import numpy as np
    from vlsa_tpu_torch.data.convert import install_tg_unpickle_stubs
    from vlsa_tpu_torch.data.io import grid_edge_index, synthetic_cluster_ids

    meta, split, sids = fold0_slides()
    pids = split["train"] + split["test"]
    _found, pid2sids, _labels = meta.collect_info_by_pids(pids)
    cdir, gdir = os.path.join(tmp, "clusters"), os.path.join(tmp, "graphs")
    os.makedirs(cdir)
    os.makedirs(gdir)
    t0 = time.perf_counter()
    lengths = {sid: np.load(os.path.join(npy_dir, sid + ".npy"), mmap_mode="r").shape[0]
               for sid in sids}
    edges = 0
    for sid, n in lengths.items():
        ei = grid_edge_index(n)
        edges += ei.shape[1]
        np.savez(os.path.join(gdir, sid + ".npz"), edge_index=ei)
    for pid, ps in pid2sids.items():
        n = sum(lengths[s] for s in ps)
        np.save(os.path.join(cdir, f"{pid}.npy"), synthetic_cluster_ids(pid, n, ZOO_CLUSTERS))
    write_s = time.perf_counter() - t0
    # one slide's graph as the reference's torch_geometric .pt, through the CLI
    install_tg_unpickle_stubs()
    tgd = sys.modules["torch_geometric.data.data"]
    sid = sids[0]
    g = tgd.Data.__new__(tgd.Data)
    g.__dict__.update({"edge_index": torch.from_numpy(grid_edge_index(lengths[sid]))})
    ptdir, outdir = os.path.join(tmp, "graphs_pt"), os.path.join(tmp, "graphs_converted")
    os.makedirs(ptdir)
    torch.save(g, os.path.join(ptdir, sid + ".pt"))
    proc = subprocess.run([sys.executable, "-m", "vlsa_tpu_torch.data.convert", "--graphs",
                           "--src", ptdir, "--dst", outdir], cwd=ROOT, capture_output=True,
                          text=True)
    check(proc.returncode == 0, f"convert --graphs failed:\n{proc.stderr[-3000:]}")
    converted = np.load(os.path.join(outdir, sid + ".npz"))["edge_index"]
    check(np.array_equal(converted, np.load(os.path.join(gdir, sid + ".npz"))["edge_index"]),
          "convert --graphs wrote another edge list than the slide's graph")
    nbytes = {d: sum(os.path.getsize(os.path.join(p, f)) for f in os.listdir(p))
              for d, p in (("clusters", cdir), ("graphs", gdir))}
    log(f"zoo inputs: {len(pid2sids)} cluster files ({nbytes['clusters']} bytes), {len(sids)} "
        f"slide graphs ({nbytes['graphs']} bytes, {edges} edges, {edges / sum(lengths.values()):.2f}"
        f" a patch) written in {write_s:.1f} s; convert --graphs of a stub-tg .pt: the same edges")
    return {"cluster_dir": cdir, "graph_dir": gdir, "edges": edges, "patches":
            int(sum(lengths.values())), "bytes": nbytes, "write_s": write_s}


def zoo_step_card_vs_cpu(torch, handler, device, what) -> dict:
    """One training step's loss and parameter gradients on ZOO_CPU_BAGS bags
    of the run's training set, the trained model on the card against the
    same weights in f32 on the CPU, Dropout off (the devices' generators
    differ; patients censored in the last bin left out of `valid`, as phase
    3d): the loss within TOL_GRAD relative, each leaf's gradient within
    TOL_GRAD of max(its largest element, ZOO_GRAD_FLOOR x the model's
    largest gradient) -- a leaf the softmax makes zero (a score's constant
    shift: the gated readout's fc2 bias, ILRA's key biases) is rounding
    noise on both."""
    from vlsa_tpu_torch.runner import sa
    from vlsa_tpu_torch.runner.train import make_batcher

    cfg = handler.cfg
    batcher = make_batcher(handler.trainer.dataset, dict(cfg, bp_every_batch=ZOO_CPU_BAGS,
                                                         prefetch=0), shuffle=False)
    cpu_batch = batcher.make_batch(range(ZOO_CPU_BAGS))
    K = handler.data_meta.num_bins
    ill = cpu_batch["valid"] & (cpu_batch["e"] == 0) & (cpu_batch["t"] == K - 1)
    cpu_batch = dict(cpu_batch, valid=cpu_batch["valid"] & ~ill)
    objective = handler.engine.objective
    out = {}
    for dev, model in (("card", handler.model),
                       ("cpu", sa.build_model(cfg, device="cpu", state_dict={
                           k: v.detach().cpu() for k, v in handler.model.state_dict().items()}))):
        batch = {k: v.to(dev if dev == "cpu" else device) for k, v in cpu_batch.items()}
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = eval_loss(model, objective, batch)
        loss.backward()
        if dev == "card":
            torch.cuda.synchronize()
        out[dev] = (float(loss), {n: p.grad.detach().float().cpu()
                                  for n, p in model.named_parameters() if p.grad is not None},
                    time.perf_counter() - t0)
        model.zero_grad(set_to_none=True)
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = out["card"], out["cpu"]
    check(set(g_card) == set(g_cpu) and g_cpu, f"{what}: gradient leaves differ")
    floor = ZOO_GRAD_FLOOR * max(float(g.abs().max()) for g in g_cpu.values())
    devs = {n: float((g_card[n] - g_cpu[n]).abs().max() / max(float(g_cpu[n].abs().max()),
                                                             floor)) for n in g_cpu}
    worst = max(devs, key=devs.get)
    loss_dev = abs(l_card - l_cpu) / max(abs(l_cpu), 1e-30)
    log(f"{what}: a step on {int(cpu_batch['valid'].sum())} bags (bucket "
        f"{cpu_batch['mask'].shape[1]}), card {s_card:.2f} s against CPU f32 {s_cpu:.2f} s: loss "
        f"{l_card:.6f} vs {l_cpu:.6f} ({loss_dev:.2e}), worst gradient {worst} {devs[worst]:.2e} "
        f"(tol {TOL_GRAD:g})")
    check(loss_dev <= TOL_GRAD and devs[worst] <= TOL_GRAD,
          f"{what}: card against CPU loss {loss_dev:.3e}, {worst} {devs[worst]:.3e}")
    return {"loss_card": l_card, "loss_cpu": l_cpu, "loss_dev": loss_dev, "grad_dev": devs,
            "card_s": s_card, "cpu_s": s_cpu}


def zoo_serve(torch, ab, co, handler, bags, what) -> dict:
    """One request of BAGS_PER_REQUEST bags of `bags` (with the config's
    synthetic cluster ids or grid graphs) served by the trained model, as
    `python -m vlsa_tpu_torch.runner.serve` does: probabilities finite and
    summing to 1, no kernel launched."""
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_aux, request_bags

    engine = InferEngine(handler.model, feats_dtype="float32", precompute_inv=False)
    req = request_bags(bags, 0, BAGS_PER_REQUEST)
    launched = all_launches(ab, co)
    t0 = time.perf_counter()
    out = engine.predict(req, **request_aux(handler.cfg, 0, req))
    ms = 1e3 * (time.perf_counter() - t0)
    probs = out["probs"]
    check(probs.shape == (BAGS_PER_REQUEST, handler.data_meta.num_bins)
          and bool((abs(probs.sum(-1) - 1) <= 1e-5).all()),
          f"{what}: served probabilities {probs.shape}")
    check(all_launches(ab, co) == launched, f"{what}: the request launched a kernel")
    log(f"{what}: a request of {BAGS_PER_REQUEST} bags {ms:.1f} ms (host prep included)")
    return {"serve_ms": ms}


def zoo_flagship(torch, ab, co, device, stores, encoder) -> dict:
    """The full-width flagship (CONCH tower, width 768, 12 layers, bf16) with
    `vlsa_img_encoder_name` `encoder`: one served request of
    BAGS_PER_REQUEST bags, one Adam step on a batch of phase 3h's .npy store
    in bf16 (buckets up to 8,192, as the zoo's runs); no kernel launched,
    finite outputs, the encoder's parameters moved, the frozen tower not."""
    import numpy as np
    from vlsa_tpu_torch.config import serving_config, training_config
    from vlsa_tpu_torch.models import mil_ext
    from vlsa_tpu_torch.runner.train import Trainer
    from vlsa_tpu_torch.runner.vlsa import build_model
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags

    enc = dict(vlsa_img_encoder_name=encoder, vlsa_img_encoder_num_cls=512)
    cfg = serving_config(dict(FLAGSHIP_CFG, **enc))
    model = build_model(cfg, device=device)
    check(isinstance(model.mil_encoder, getattr(mil_ext, encoder)),
          f"flagship {encoder}: the encoder is {type(model.mil_encoder).__name__}")
    engine = InferEngine(model, feats_dtype="bfloat16", precompute_inv=False)
    engine.text_precompute()
    ab.reset_launches()
    co.reset_launches()
    bags = request_bags(cfg["path_patch"], 0, BAGS_PER_REQUEST)
    t0 = time.perf_counter()
    out = engine.predict(bags)
    serve_ms = 1e3 * (time.perf_counter() - t0)
    check(bool(np.isfinite(out["probs"]).all())
          and np.allclose(out["probs"].sum(-1), 1.0, atol=1e-5),
          f"flagship {encoder}: served probabilities")
    del model, engine
    tcfg = training_config(dict(TRAIN_CFG, **enc, path_patch=stores["npy"][0],
                                feat_format="npy", max_bucket=ZOO_CFG["max_bucket"],
                                bag_overflow=ZOO_CFG["bag_overflow"]), fold=0)
    trainer = Trainer(tcfg, device)
    trainer.batcher.prefetch = 0
    batch = trainer.batcher.make_batch(range(trainer.batcher.batch_size))
    model = trainer.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, raw = trainer.engine.train_step(batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    check(only_launches(all_launches(ab, co)), f"flagship {encoder}: a kernel launched")
    check(bool(np.isfinite(float(loss))) and bool(torch.isfinite(raw).all()),
          f"flagship {encoder}: a non-finite loss")
    moved = {n for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])}
    tower = {n for n in before if n.startswith("prompt_encoder.")}
    check(not (moved & tower) and any(n.startswith("mil_encoder.") for n in moved),
          f"flagship {encoder}: moved {sorted(moved)[:8]}")
    peak = torch.cuda.max_memory_allocated()
    log(f"flagship VLSA with {encoder} (CONCH tower 768 x 12, bf16): a request of "
        f"{BAGS_PER_REQUEST} bags {serve_ms:.1f} ms; an Adam step on {int(batch['valid'].sum())}"
        f" bags (bucket {batch['mask'].shape[1]}) {step_ms:.1f} ms, loss {float(loss):.4f}, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    del trainer, model, batch
    torch.cuda.empty_cache()
    return {"serve_ms": serve_ms, "step_ms": step_ms, "loss": float(loss),
            "peak_device_bytes": peak}


def zoo_skewed_degrees(torch, handler, device, what) -> dict:
    """Peak device memory of one PatchGCN training step (forward and
    backward of the objective, eval mode) on ZOO_SKEW_BAGS random bags of
    ZOO_CFG's largest bucket, with each bag's 8-neighbour grid graph and
    with the same edges, half of their destinations drawn among
    ZOO_SKEW_HUBS nodes: {graph: peak bytes above the step's start, the
    largest in-degree}.  Held: the hub graph's peak within ZOO_SKEW_RATIO
    of the grid's."""
    import numpy as np
    from vlsa_tpu_torch.data.io import grid_edge_index

    B, N = ZOO_SKEW_BAGS, ZOO_CFG["max_bucket"]
    grid = grid_edge_index(N).astype(np.int32)
    hubs = grid.copy()
    half = grid.shape[1] // 2
    hubs[1, :half] = np.random.default_rng(ZOO_SKEW_HUBS).integers(0, ZOO_SKEW_HUBS, half)
    g = torch.Generator(device=device).manual_seed(ZOO_SKEW_HUBS)
    feats = torch.randn(B, N, int(ZOO_CFG["net_dims"].split("-")[0]), generator=g,
                        device=device)
    labels = {"mask": torch.ones(B, N, dtype=torch.bool, device=device),
              "t": torch.arange(B, device=device).float() % 4,
              "e": torch.ones(B, device=device), "valid": torch.ones(B, dtype=torch.bool,
                                                                       device=device)}
    model, objective = handler.model, handler.engine.objective
    model.eval()
    out = {}
    for kind, ei in (("grid", grid), ("hubs", hubs)):
        batch = dict(labels, feats=feats,
                     edge_index=torch.from_numpy(ei).to(device)[None].expand(B, -1, -1),
                     edge_valid=torch.ones(B, ei.shape[1], dtype=torch.bool, device=device))
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        eval_loss(model, objective, batch).backward()
        torch.cuda.synchronize()
        out[kind] = {"peak_bytes": torch.cuda.max_memory_allocated() - start,
                     "max_in_degree": int(np.bincount(ei[1]).max()), "edges": int(ei.shape[1])}
        model.zero_grad(set_to_none=True)
        del batch
    ratio = out["hubs"]["peak_bytes"] / out["grid"]["peak_bytes"]
    log(f"{what}: a training step on {B} bags of {N} nodes, {grid.shape[1]} edges a bag: peak "
        f"device memory {out['grid']['peak_bytes'] / 2**30:.2f} GiB on the grid (largest "
        f"in-degree {out['grid']['max_in_degree']}), {out['hubs']['peak_bytes'] / 2**30:.2f} "
        f"GiB with half the edges into {ZOO_SKEW_HUBS} nodes (largest in-degree "
        f"{out['hubs']['max_in_degree']}): {ratio:.3f}x")
    check(ratio <= ZOO_SKEW_RATIO, f"{what}: skewed in-degrees take {ratio:.3f}x the memory")
    return dict(out, ratio=ratio)


def phase_zoo(torch, ab, co, device, card, tmp):
    """Phase 3o: TransMIL, ILRA (patch bags from phase 3h's .npy store in
    `tmp`), DeepAttnMISL (cluster bags) and PatchGCN (graph bags) at
    net_dims 512-256-12, each 1 epoch through `python -m
    vlsa_tpu_torch.main --handler SA` with every counter from 0 before (no
    kernel launched, finite metrics, the reloaded checkpoint's test
    probabilities bit for bit the in-memory model's), then a served request
    and a step card against CPU; then the flagship with TransMIL and ILRA
    encoders served and trained a step."""
    import numpy as np

    stores = {"npy": (os.path.join(tmp, "npy"),)}
    aux = write_zoo_aux(torch, tmp, stores["npy"][0])
    runs = {}
    for network, mode, changes in ZOO_NETWORKS:
        name = f"zoo_{network}_{mode}"
        cfg = dict(ZOO_CFG, **changes, deepmil_network=network, data_mode=mode,
                   path_cluster=aux["cluster_dir"], path_graph=aux["graph_dir"],
                   path_patch=stores["npy"][0], feat_format="npy",
                   save_path=os.path.join(tmp, name))
        run = exec_handler(torch, ab, co, device, cfg, via_main=True)
        handler = run["handler"]
        check(run["launches"] == expected_launches(handler, run["launches"], None),
              f"{name}: a kernel launched: {run['launches']}")
        native = mode == "patch"
        check((run["batches"]["native"] > 0) == native and (run["batches"]["numpy"] > 0) != native,
              f"{name}: batches by path {run['batches']}")
        with open(os.path.join(cfg["save_path"], "metrics.jsonl")) as f:
            evals = [e for e in map(json.loads, f) if e["event"] == "eval"]
        values = [v for e in evals for k, v in e.items() if k not in ("event", "at", "ts")]
        check(len(evals) == 4 and values and all(np.isfinite(v) for v in values),
              f"{name}: {len(evals)} evaluations, a non-finite metric")
        in_memory, reloaded = run["passes"]["test"][-2], run["passes"]["test"][-1]
        check(np.array_equal(in_memory["y_hat"], reloaded["y_hat"]),
              f"{name}: the reloaded checkpoint's test probabilities differ by "
              f"{np.abs(in_memory['y_hat'] - reloaded['y_hat']).max():.3e}")
        peak, total = run["host_memory"]["rss_peak_bytes"], host_memory_bytes()
        check(peak is None or total is None or peak <= HOST_RSS_SHARE * total,
              f"{name}: the host's resident set peaked at {peak} bytes")
        log_run_times(name, handler.timings["epochs"], run["eval_passes"], card)
        log(f"{name}: exec {run['exec_s']:.1f} s, batches {run['batches']}, "
            f"{describe_host_memory(run['host_memory'])}, peak device memory "
            f"{run['peak_device_bytes'] / 2**30:.2f} GiB, on {card}; final metrics "
            f"{run['metrics']}")
        rec = {"config": {k: v for k, v in cfg.items() if k != "save_path"}, "card": card,
               "reduced": ZOO_REDUCED, "exec_s": run["exec_s"], "epochs": handler.timings["epochs"],
               "eval_passes": run["eval_passes"], "batches": run["batches"],
               "launches": run["launches"], "metrics": run["metrics"],
               "host_memory": run["host_memory"], "peak_device_bytes": run["peak_device_bytes"],
               "reload_bit_identical": True}
        if network == "PatchGCN":
            rec["edges"] = aux["edges"]
            rec["skewed_degrees"] = zoo_skewed_degrees(torch, handler, device, name)
        rec.update(zoo_serve(torch, ab, co, handler, STORE_BAGS, name))
        rec["card_vs_cpu"] = zoo_step_card_vs_cpu(torch, handler, device, name)
        runs[name] = rec
        del handler, run
        gc.collect()
        torch.cuda.empty_cache()
    flagship = {enc: zoo_flagship(torch, ab, co, device, stores, enc)
                for enc in ZOO_VLSA_ENCODERS}
    return {"inputs": {k: v for k, v in aux.items() if not k.endswith("_dir")},
            "runs": runs, "flagship": flagship}

# ---------------------------------------------------------------- phase 3p

def write_clf_table(tmp, classes: int) -> str:
    """A CLF label table of fold 0's slides (patient_id, pathology_id,
    label): one class a patient, drawn uniformly from CLF_LABEL_SEED."""
    import csv
    import numpy as np
    meta, split, _sids = fold0_slides()
    rng = np.random.default_rng(CLF_LABEL_SEED + classes)
    path = os.path.join(tmp, f"clf_labels_{classes}.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "pathology_id", "label"])
        for pid in split["train"] + split["test"]:
            label = int(rng.integers(0, classes))
            for sid in meta.collect_info_by_pids([pid])[1][pid]:
                w.writerow([pid, sid, label])
    return path


def clf_metrics_from_csv(handler, save_path, what) -> dict:
    """Each split's metrics recomputed by the port's evaluator from the run's
    own prediction CSV must equal what the run reported (metrics.jsonl's
    last evaluation of the split), exactly: the CSV keeps the float32
    values."""
    import numpy as np
    from vlsa_tpu_torch.data.io import read_prediction_clf
    with open(os.path.join(save_path, "metrics.jsonl")) as f:
        evals = [e for e in map(json.loads, f) if e["event"] == "eval"]
    out = {}
    for split in sorted(handler.uid):
        prefix = f"lastckpt/train/{split}/pred/"
        path = os.path.join(save_path, f"clf_train_last_pred_{split}.csv")
        if not os.path.exists(path):
            continue
        reported = [e for e in evals if prefix + "auc" in e][-1]
        got = handler.evaluator.compute(read_prediction_clf(path), handler.metrics_list)
        for k, v in got.items():
            want = reported[prefix + k]
            check(v == want or (np.isnan(v) and np.isnan(want)),
                  f"{what} {split}: {k} from the CSV {v!r}, the run reported {want!r}")
        out[split] = got
    check(out, f"{what}: no prediction CSV")
    return out


def clf_serve_vs_cpu(torch, ab, co, handler, what) -> dict:
    """One request of BAGS_PER_REQUEST bags (f32, N~8192) served by the
    handler's model on the card (one f32 ABMIL forward launched) against the
    same weights on the CPU (the plain pooling): probabilities within
    TOL_LIFECYCLE_PROBS, finite, summing to 1."""
    from vlsa_tpu_torch.runner import sa
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags

    bags = request_bags(STORE_BAGS, 0, BAGS_PER_REQUEST)
    engine = InferEngine(handler.model, feats_dtype="float32", precompute_inv=False)
    ab.reset_launches()
    co.reset_launches()
    t0 = time.perf_counter()
    card = engine.predict(bags)["probs"]
    ms = 1e3 * (time.perf_counter() - t0)
    launched = only_launches(all_launches(ab, co), "abmil_fwd", "f32", 1)
    check(launched, f"{what}: a request launched {all_launches(ab, co)}, not one f32 ABMIL "
                    f"forward")
    cpu_model = sa.build_model(handler.cfg, device="cpu", state_dict={
        k: v.detach().cpu() for k, v in handler.model.state_dict().items()})
    cpu = InferEngine(cpu_model, feats_dtype="float32", precompute_inv=False).predict(bags)["probs"]
    C = int(str(handler.cfg["net_dims"]).split("-")[-1])
    gap = float(abs(card - cpu).max())
    check(card.shape == (BAGS_PER_REQUEST, C) and bool((abs(card.sum(-1) - 1) <= 1e-5).all()),
          f"{what}: served probabilities {card.shape}")
    check(gap <= TOL_LIFECYCLE_PROBS, f"{what}: served probabilities {gap:.3e} from the CPU's")
    log(f"{what}: a request of {BAGS_PER_REQUEST} bags {ms:.1f} ms (host prep included), "
        f"card against CPU max|p| gap {gap:.3e} (tol {TOL_LIFECYCLE_PROBS:g})")
    return {"serve_ms": ms, "serve_gap_to_cpu": gap}


def profiled_kernels(torch, step, batch, family, expect, what) -> dict:
    """The kernels of one `step(batch)` on the card whose names hold
    `family`, by name: launches (the profiler's count) and ms.  A trace here
    can miss kernels (one dropped a step's forward, another recorded no
    device time at all), so up to PROFILE_TRIES steps are profiled and the
    first trace that names every prefix of `expect` is kept, else the
    fullest, marked incomplete: the launch counters, not the profiler,
    decide the phase."""
    import types
    best = {}
    for _ in range(PROFILE_TRIES):
        prof = profile_step(torch, types.SimpleNamespace(train_step=step), batch, family=family)
        got = {k: {"launches": prof["counts"][k], "ms": prof["kernels"][k]}
               for k in prof["counts"]}
        if all(any(k.startswith(p) for k in got) for p in expect):
            log(f"{what}: the profiled kernels {got}")
            return {"kernels": got, "complete": True}
        if len(got) >= len(best):
            best = got
    log(f"{what}: {PROFILE_TRIES} profiler traces missed some of {list(expect)}; the fullest "
        f"{best} (the launch counters above decide)")
    return {"kernels": best, "complete": False}


def clf_run(torch, ab, co, device, card, tmp, npy_dir, table) -> dict:
    """CLF binary: 1 epoch through `main --handler CLF` with every counter from
    0 before: native batches, the exact ABMIL f32 launches (rows 7 and 8),
    finite metrics, the reloaded checkpoint's test probabilities bit for bit
    the in-memory model's, the metrics again from the CSVs; then a request
    against the CPU and a profiled training step."""
    import numpy as np
    name = "clf_binary_f32_npy"
    cfg = dict(CLF_CFG, path_table=table, path_patch=npy_dir, save_path=os.path.join(tmp, name),
               data_split_path=os.path.join(ROOT, "assets/data_split/5foldcv/{0}/splits_{2}.csv"))
    run = exec_handler(torch, ab, co, device, cfg, via_main=True)
    handler, launches = run["handler"], run["launches"]
    check(run["batches"]["numpy"] == 0 and run["batches"]["native"] > 0,
          f"{name}: batches by path {run['batches']}: every batch must be native")
    expected = expected_launches(handler, launches, "f32")
    check(launches == expected and launches["abmil_fwd"]["f32"] > 0
          and launches["abmil_bwd"]["f32"] > 0,
          f"{name}: launches {launches}, expected {expected}")
    with open(os.path.join(cfg["save_path"], "metrics.jsonl")) as f:
        values = [v for e in map(json.loads, f) if e["event"] == "eval"
                  for k, v in e.items() if k not in ("event", "at", "ts")]
    check(values and all(np.isfinite(v) for v in values), f"{name}: a non-finite metric")
    in_memory, reloaded = run["passes"]["test"][-2], run["passes"]["test"][-1]
    check(np.array_equal(in_memory["y_hat"], reloaded["y_hat"]),
          f"{name}: the reloaded checkpoint's test probabilities differ by "
          f"{np.abs(in_memory['y_hat'] - reloaded['y_hat']).max():.3e}")
    from_csv = clf_metrics_from_csv(handler, cfg["save_path"], name)
    log_run_times(name, handler.timings["epochs"], run["eval_passes"], card)
    log(f"{name}: {len(handler.trainer.dataset)} training slides, exec {run['exec_s']:.1f} s, "
        f"peak device memory {run['peak_device_bytes'] / 2**30:.2f} GiB, launches "
        f"{ {k: {v: n for v, n in c.items() if n} for k, c in launches.items()} }, on {card}; "
        f"final metrics {run['metrics']}")
    rec = {"config": {k: v for k, v in cfg.items() if k != "save_path"}, "card": card,
           "reduced": CLF_REDUCED, "train_slides": len(handler.trainer.dataset),
           "exec_s": run["exec_s"], "epochs": handler.timings["epochs"],
           "eval_passes": run["eval_passes"], "batches": run["batches"], "launches": launches,
           "metrics": run["metrics"], "metrics_from_csv": from_csv,
           "peak_device_bytes": run["peak_device_bytes"], "host_memory": run["host_memory"],
           "reload_bit_identical": True}
    rec.update(clf_serve_vs_cpu(torch, ab, co, handler, name))
    batch = handler.trainer.batcher.make_batch(range(handler.cfg["bp_every_batch"]))
    rec["profiled_step"] = profiled_kernels(torch, handler.engine.train_step, batch, "abmil",
                                            ("abmil_fwd", "abmil_bwd"), f"{name} training step")
    del handler, run, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def clf_served_only(torch, ab, co, device, card, tmp, npy_dir, table) -> dict:
    """CLF multi-class, served only: the test split's evaluation pass of the
    seeded model (counters from 0: only f32 ABMIL forwards, one a batch),
    its metrics again from its CSV, a request against the CPU, the
    request's kernels from the profiler."""
    from vlsa_tpu_torch.runner.clf import CLFHandler
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags
    name = "clf_multi_f32_npy"
    cfg = dict(CLF_CFG, **CLF_MULTI, path_table=table, path_patch=npy_dir,
               save_path=os.path.join(tmp, name),
               data_split_path=os.path.join(ROOT, "assets/data_split/5foldcv/{0}/splits_{2}.csv"))
    handler = CLFHandler(cfg, device=device)
    test_set = handler.prepare_dataset(handler.data_split["test"], "test")
    handler.uid["test"] = test_set.uid
    torch.cuda.reset_peak_memory_stats()
    ab.reset_launches()
    co.reset_launches()
    t0 = time.perf_counter()
    metrics = handler._eval_all({"test": test_set}, ckpt_type="last")
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    launches = all_launches(ab, co)
    n_batches = -(-len(test_set) // cfg["bp_every_batch"])
    check(only_launches(launches, "abmil_fwd", "f32", n_batches),
          f"{name}: launches {launches}, expected {n_batches} f32 ABMIL forwards")
    from_csv = clf_metrics_from_csv(handler, cfg["save_path"], name)
    peak = torch.cuda.max_memory_allocated()
    log(f"{name}: the test pass of {len(test_set)} slides {pass_s:.1f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB, launches {launches}, on {card}; metrics {from_csv}")
    rec = {"config": {k: v for k, v in cfg.items() if k != "save_path"}, "card": card,
           "reduced": CLF_REDUCED, "test_slides": len(test_set), "pass_s": pass_s,
           "launches": all_launches(ab, co), "metrics": metrics, "metrics_from_csv": from_csv,
           "peak_device_bytes": peak}
    rec.update(clf_serve_vs_cpu(torch, ab, co, handler, name))
    engine = InferEngine(handler.model, feats_dtype="float32", precompute_inv=False)
    batch = engine.prepare(request_bags(STORE_BAGS, 1, BAGS_PER_REQUEST))
    rec["profiled_request"] = profiled_kernels(torch, engine.forward, batch, "abmil",
                                               ("abmil_fwd",), f"{name} request")
    del handler, engine, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def write_clip_checkpoint(torch, path) -> dict:
    """An OpenAI-CLIP-layout checkpoint of the HF api's text tower at its
    published width (the tower's keys at the top level, no cls_emb; random
    from CLIP_TEXT_SEED), a `visual.*` decoy and `logit_scale`: its tensors
    by name."""
    from vlsa_tpu_torch.models.text_encoder import make_text_tower
    tower = make_text_tower("HF", generator=torch.Generator().manual_seed(CLIP_TEXT_SEED))
    state = {conch_name(k)[len("text."):]: v.detach().clone()
             for k, v in tower.state_dict().items()}
    state.update({"visual.proj": torch.ones(768, 512),
                  "logit_scale": torch.tensor(CLIP_LOGIT_SCALE)})
    torch.save(state, path)
    return state


def text_api_serve(torch, co, device, cfg, what, written=None) -> dict:
    """The flagship with `cfg`'s text api built on the card (the frozen bf16
    tower; with `written`, imported from that checkpoint) and on the CPU
    from its state dict; one bf16 request of BAGS_PER_REQUEST bags on each,
    the text tower computing in f32 on both (f32_text_tower): one bf16
    co-attention forward launched, probabilities within TOL_LIFECYCLE_PROBS."""
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags
    from vlsa_tpu_torch.runner.vlsa import build_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    build_s = time.perf_counter() - t0
    tower = model.prompt_encoder
    check(tower.api == cfg["vlsa_api"] and tower.width == 512 and len(tower.resblocks) == 12
          and not hasattr(tower, "cls_emb"),
          f"{what}: tower {tower.api}, width {tower.width}, {len(tower.resblocks)} layers")
    if written is not None:
        hold_imported_tower(torch, model, written, what, prefix="",
                            logit_scale=CLIP_LOGIT_SCALE)
    cpu = build_model(cfg, device="cpu", state_dict={k: v.detach().cpu()
                                                     for k, v in model.state_dict().items()})
    bags = request_bags(cfg["path_patch"], 0, BAGS_PER_REQUEST)
    probs = {}
    for dev, m in (("card", model), ("cpu", cpu)):
        engine = InferEngine(m, feats_dtype="bfloat16", precompute_inv=False)
        with f32_text_tower(torch, m.prompt_encoder):
            engine.text_precompute()
        co.reset_launches()
        t0 = time.perf_counter()
        probs[dev] = engine.predict(bags)["probs"]
        ms = 1e3 * (time.perf_counter() - t0)
        if dev == "card":
            serve_ms, launched = ms, dict(co.LAUNCHES)
    check(launched == dict(dict.fromkeys(launched, 0), bf16=1),
          f"{what}: a request launched {launched}, not one bf16 co-attention forward")
    gap = float(abs(probs["card"] - probs["cpu"]).max())
    check(probs["card"].shape == (BAGS_PER_REQUEST, 12)
          and bool((abs(probs["card"].sum(-1) - 1) <= 1e-5).all()),
          f"{what}: served probabilities {probs['card'].shape}")
    check(gap <= TOL_LIFECYCLE_PROBS, f"{what}: served probabilities {gap:.3e} from the CPU's")
    peak = torch.cuda.max_memory_allocated()
    log(f"{what}: built in {build_s:.1f} s, text trim {model.text_trim_len}; a request of "
        f"{BAGS_PER_REQUEST} bags {serve_ms:.1f} ms, card against CPU (f32 tower) max|p| gap "
        f"{gap:.3e} (tol {TOL_LIFECYCLE_PROBS:g}), peak device memory {peak / 2**30:.2f} GiB, "
        f"on the card")
    del model, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return {"build_s": build_s, "serve_ms": serve_ms, "serve_gap_to_cpu": gap,
            "peak_device_bytes": peak}


def text_api_run(torch, ab, co, device, card, tmp, npy_dir, api, extra) -> dict:
    """VLSA with `vlsa_api` `api`: a request served against the CPU, then 1
    epoch from 3h's bf16 .npy store through `main` (native batches, the exact
    bf16 co-attention launches: rows 1 and 6; finite metrics, C-indices in
    [0, 1], the reload bit for bit) and a profiled training step."""
    import numpy as np
    from vlsa_tpu_torch.config import serving_config
    name = f"vlsa_{api.lower()}_bf16_npy"
    written = None
    if api == "HF":
        written = write_clip_checkpoint(
            torch, os.path.join(extra["path_clip_model"], extra["vlsa_txt_encoder_name"],
                                "pytorch_model.bin"))
    served = text_api_serve(torch, co, device, serving_config(
        dict(FLAGSHIP_CFG, vlsa_api=api, **extra)), f"{name} serve", written)
    cfg = dict(LIFECYCLE_VLSA_CFG, vlsa_api=api, **extra, feats_dtype="bfloat16",
               path_patch=npy_dir, feat_format="npy", save_path=os.path.join(tmp, name),
               max_bucket=TEXT_API_BUCKET, bag_overflow="truncate")
    run = exec_handler(torch, ab, co, device, cfg, via_main=True)
    handler, launches = run["handler"], run["launches"]
    check(handler.model.prompt_encoder.api == api, f"{name}: the tower's api")
    check(run["batches"]["numpy"] == 0 and run["batches"]["native"] > 0,
          f"{name}: batches by path {run['batches']}: every batch must be native")
    expected = expected_launches(handler, launches, "bf16")
    check(launches == expected and launches["coattn_fwd"]["bf16"] > 0
          and launches["coattn_bwd_dq"]["bf16"] > 0,
          f"{name}: launches {launches}, expected {expected}")
    with open(os.path.join(cfg["save_path"], "metrics.jsonl")) as f:
        evals = [e for e in map(json.loads, f) if e["event"] == "eval"]
    values = {k: v for e in evals for k, v in e.items() if k not in ("event", "at", "ts")}
    check(len(evals) == 4 and all(np.isfinite(v) for v in values.values()),
          f"{name}: {len(evals)} evaluations, a non-finite metric")
    check(all(0.0 <= v <= 1.0 for k, v in values.items() if k.endswith(("/c_index", "/c_index2"))),
          f"{name}: a C-index outside [0, 1]")
    in_memory, reloaded = run["passes"]["test"][-2], run["passes"]["test"][-1]
    check(np.array_equal(in_memory["y_hat"], reloaded["y_hat"]),
          f"{name}: the reloaded checkpoint's test probabilities differ by "
          f"{np.abs(in_memory['y_hat'] - reloaded['y_hat']).max():.3e}")
    log_run_times(name, handler.timings["epochs"], run["eval_passes"], card)
    log(f"{name}: exec {run['exec_s']:.1f} s, peak device memory "
        f"{run['peak_device_bytes'] / 2**30:.2f} GiB, launches "
        f"{ {k: {v: n for v, n in c.items() if n} for k, c in launches.items()} }, on {card}; "
        f"final metrics {run['metrics']}")
    rec = {"config": {k: v for k, v in cfg.items() if k != "save_path"}, "card": card,
           "reduced": TEXT_API_REDUCED, "served": served, "exec_s": run["exec_s"],
           "epochs": handler.timings["epochs"], "eval_passes": run["eval_passes"],
           "batches": run["batches"], "launches": launches, "metrics": run["metrics"],
           "peak_device_bytes": run["peak_device_bytes"], "host_memory": run["host_memory"],
           "reload_bit_identical": True}
    batch = handler.trainer.batcher.make_batch(range(handler.cfg["bp_every_batch"]))
    rec["profiled_step"] = profiled_kernels(torch, handler.engine.train_step, batch, "coattn",
                                            ("coattn_fwd", "coattn_bwd"), f"{name} training step")
    del handler, run, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_clf_and_text_apis(torch, ab, co, device, card, tmp):
    """Phase 3p: the CLF handler (binary 1 epoch, multi-class served) and
    VLSA on the CLIP and HF text towers, from phase 3h's stores in `tmp`;
    prints the launches this phase adds to rows 1, 6, 7 and 8."""
    from vlsa_tpu_torch.models.hf_export import export_hf_clip_tokenizer

    npy_dir = os.path.join(tmp, "npy")
    out = {"clf_binary": clf_run(torch, ab, co, device, card, tmp, npy_dir,
                                 write_clf_table(tmp, 2)),
           "clf_multi": clf_served_only(torch, ab, co, device, card, tmp, npy_dir,
                                        write_clf_table(tmp, 3))}
    hf_root = os.path.join(tmp, "hf_clip")
    export_hf_clip_tokenizer(os.path.join(hf_root, "hf"))
    for api in TEXT_APIS:
        extra = (dict(path_clip_model=hf_root, vlsa_txt_encoder_name="hf") if api == "HF"
                 else {})
        out[api] = text_api_run(torch, ab, co, device, card, tmp, npy_dir, api, extra)
    runs = [out["clf_binary"], out["clf_multi"], out["CLIP"], out["HF"]]
    rows = {"1 coattn_fwd[bf16]": sum(r["launches"]["coattn_fwd"]["bf16"] for r in runs),
            "6 coattn_bwd_dq[bf16]": sum(r["launches"]["coattn_bwd_dq"]["bf16"] for r in runs),
            "7 abmil_fwd[f32]": sum(r["launches"]["abmil_fwd"]["f32"] for r in runs),
            "8 abmil_bwd[f32]": sum(r["launches"]["abmil_bwd"]["f32"] for r in runs)}
    check(all(n > 0 for n in rows.values()), f"phase 3p: a row never launched: {rows}")
    log(f"phase 3p launches by row (the runs' main paths): {rows}")
    out["rows"] = rows
    return out


# ---------------------------------------------------------------- phase 3i

def write_conch_checkpoint(path, torch) -> dict:
    """A CONCH-format `pytorch_model.bin` at ZS_TOWER's width (the
    reference's key names under `text.`, random from ZS_SEED; LayerNorms
    near 1; a few `visual.*` and `text_decoder.*` decoys; `logit_scale`):
    its tensors by name."""
    g = torch.Generator().manual_seed(ZS_SEED)
    W, out = ZS_TOWER["width"], ZS_TOWER["output"]

    def r(*shape, std=0.02):
        return torch.randn(*shape, generator=g) * std

    state = {"text.token_embedding.weight": r(ZS_TOWER["vocab"], W),
             "text.positional_embedding": r(ZS_TOWER["context"], W, std=0.01),
             "text.text_projection": r(W, out, std=W ** -0.5), "text.cls_emb": r(W, std=0.01),
             "text.ln_final.weight": 1 + r(W, std=0.1), "text.ln_final.bias": r(W, std=0.1)}
    for i in range(ZS_TOWER["layers"]):
        rb = f"text.transformer.resblocks.{i}."
        state.update({
            rb + "ln_1.weight": 1 + r(W, std=0.1), rb + "ln_1.bias": r(W, std=0.1),
            rb + "ln_2.weight": 1 + r(W, std=0.1), rb + "ln_2.bias": r(W, std=0.1),
            rb + "attn.in_proj_weight": r(3 * W, W, std=W ** -0.5),
            rb + "attn.in_proj_bias": r(3 * W), rb + "attn.out_proj.weight": r(W, W, std=W ** -0.5),
            rb + "attn.out_proj.bias": r(W), rb + "mlp.c_fc.weight": r(4 * W, W, std=(2 * W) ** -0.5),
            rb + "mlp.c_fc.bias": r(4 * W), rb + "mlp.c_proj.weight": r(W, 4 * W, std=(4 * W) ** -0.5),
            rb + "mlp.c_proj.bias": r(W)})
    state.update({"visual.trunk.patch_embed.proj.weight": r(W, 3, 16, 16),
                  "visual.proj_contrast": r(W, out), "text_decoder.ln_final.weight": r(W),
                  "logit_scale": torch.tensor(ZS_LOGIT_SCALE)})
    torch.save(state, path)
    return state


def conch_name(name: str) -> str:
    """The reference's key of a TextTower state-dict entry (independent of
    utils.torch_import's table)."""
    if name == "token_embedding":
        return "text.token_embedding.weight"
    if not name.startswith("resblocks."):
        return "text." + name
    _, i, rest = name.split(".", 2)
    rest = {"attn.out_proj_weight": "attn.out_proj.weight",
            "attn.out_proj_bias": "attn.out_proj.bias",
            "c_fc_weight": "mlp.c_fc.weight", "c_fc_bias": "mlp.c_fc.bias",
            "c_proj_weight": "mlp.c_proj.weight", "c_proj_bias": "mlp.c_proj.bias"}.get(rest, rest)
    return f"text.transformer.resblocks.{i}.{rest}"


def hold_imported_tower(torch, model, written, what, prefix="text.",
                        logit_scale=ZS_LOGIT_SCALE) -> None:
    """The model's text tower is the file's, tensor for tensor (bf16 where
    the frozen tower stores its matmul weights so), every file tensor
    taken (the tower's keys under `prefix`: CONCH's `text.`, CLIP's none);
    its logit scale starts at the file's."""
    tower = model.prompt_encoder.state_dict()
    keys = [k for k in written if k.startswith(prefix) and not k.startswith("visual.")
            and k != "logit_scale" and not k.startswith("text_decoder.")]
    check(len(tower) == len(keys), f"{what}: {len(tower)} tower tensors, the file has "
                                   f"{len(keys)}")
    for name, t in tower.items():
        want = written[prefix + conch_name(name)[len("text."):]].to(t.dtype)
        check(torch.equal(t.cpu(), want), f"{what}: the tower's {name} is not the file's")
    check(model.logit_scale.item() == logit_scale,
          f"{what}: logit scale {model.logit_scale.item()}, the file's is {logit_scale}")


def zero_shot_cfg(tmp, ckpt, store, feats_dtype, pooling) -> dict:
    """ZS_CONFIG for fold 0 with one pooling, read from phase 3h's `store`."""
    from vlsa_tpu_torch.config import load_config
    cfg = load_config(os.path.join(ROOT, ZS_CONFIG))
    cfg.update(dataset_name="tcga_blca", data_split_seed=0, vlsa_img_encoder_pooling=pooling,
               path_patch=os.path.join(tmp, store), feat_format=store, feats_dtype=feats_dtype,
               path_clip_model=ckpt, save_path=os.path.join(tmp, f"zs_{store}_{pooling}"),
               path_table=os.path.join(ROOT, cfg["path_table"]),
               data_split_path=os.path.join(ROOT, cfg["data_split_path"]))
    return cfg


def zero_shot_reference(torch, model, batch, text):
    """A batch's probabilities from the port on the CPU (`model` a CPU copy)
    and in float64 (every step after the stored features in f64), from the
    same text prototypes `text` (the card's)."""
    from vlsa_tpu_torch.models.mil import logit_pooling
    from vlsa_tpu_torch.ops.coattn import dequantize_feats
    feats, mask = batch["feats"], batch["mask"]
    kws = {"x_scale": batch["feats_scale"]} if "feats_scale" in batch else {}
    with torch.inference_mode():
        cpu = torch.softmax(model(feats, mask, text_features=text, **kws)[0], dim=-1)
        x = (dequantize_feats(feats, kws["x_scale"]).to(torch.bfloat16) if kws else feats).double()
        img = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        t = text.double() / text.double().norm(dim=-1, keepdim=True)
        scale = torch.exp(model.logit_scale.detach().double())
        _, pooled = logit_pooling(scale * torch.einsum("bne,ke->bnk", img, t), model.pooling, mask)
        f64 = torch.softmax(pooled, dim=-1)
    valid = batch["valid"]
    return cpu[valid].numpy(), f64[valid].numpy()


def text_prototypes(torch, model) -> dict:
    """The model's text prototypes on the host: as it computes them (bf16
    operands for a bf16 tower) and with its tower computing in f32."""
    with torch.inference_mode():
        out = {"as_run": model.forward_text_only().float().cpu()}
        with f32_text_tower(torch, model.prompt_encoder):
            out["f32"] = model.forward_text_only().float().cpu()
    return out


def zero_shot_run(torch, ab, co, device, card, tmp, ckpt, written, store, feats_dtype,
                  pooling, cpu_ref) -> dict:
    """One zero-shot `exec()` of ZS_CONFIG from `store` with one pooling,
    every launch counter from 0 just before; then its checks against the
    file and the port on the CPU."""
    import copy
    import numpy as np
    from vlsa_tpu_torch.runner.train import make_batcher, make_dataset

    name = f"zero-shot {store} {feats_dtype} {pooling}"
    cfg = zero_shot_cfg(tmp, ckpt, store, feats_dtype, pooling)
    run = exec_handler(torch, ab, co, device, cfg)
    handler, launches = run["handler"], run["launches"]
    check(all(n == 0 for counts in launches.values() for n in counts.values()),
          f"{name}: launched kernels {launches}; zero-shot launches none")
    check(handler.optimizer is None and handler.timings["epochs"] == [],
          f"{name}: the run trained, or built an optimizer")
    hold_imported_tower(torch, handler.model, written, name)
    with open(os.path.join(cfg["save_path"], "metrics.jsonl")) as f:
        evals = [e for e in map(json.loads, f) if e["event"] == "eval"]
    values = {k: v for e in evals for k, v in e.items() if k not in ("event", "at", "ts")}
    check(len(evals) == 1 and values and all(np.isfinite(v) for v in values.values()),
          f"{name}: {len(evals)} evaluations, a non-finite metric in {values}")
    c_idx = {k: v for k, v in values.items() if k.endswith(("/c_index", "/c_index2"))}
    check(c_idx and all(0.0 <= v <= 1.0 for v in c_idx.values()),
          f"{name}: a C-index outside [0, 1]: {c_idx}")
    files = sorted(os.listdir(cfg["save_path"]))
    check("vlsa_zero-shot_last_pred_test.csv" in files and "zero-shot_metrics-best.txt" in files,
          f"{name}: the run wrote {files}")

    # the first test batch: the card's probabilities against the port on the CPU
    test_set = make_dataset(handler.cfg, handler.data_meta, handler.data_split["test"])
    check(len(test_set) == 75, f"{name}: {len(test_set)} test patients")
    batcher = make_batcher(test_set, handler.cfg, shuffle=False)
    batch = batcher.make_batch(range(min(batcher.batch_size, len(test_set))))
    card_probs = run["passes"]["test"][-1]["y_hat"][:int(batch["valid"].sum())]
    if "model" not in cpu_ref:
        cpu_ref["model"] = copy.deepcopy(handler.model).to("cpu")
        t0 = time.perf_counter()
        cpu_ref["text"] = text_prototypes(torch, cpu_ref["model"])
        cpu_ref["text_s"] = time.perf_counter() - t0
    model = cpu_ref["model"]
    model.mil_encoder.pooling, model.pooling = handler.model.mil_encoder.pooling, pooling
    card_text = text_prototypes(torch, handler.model)
    text_gap = {k: float((card_text[k] - v).abs().max() / v.abs().max())
                for k, v in cpu_ref["text"].items()}
    check(text_gap["f32"] <= TOL_ZS_TEXT_F32,
          f"{name}: the f32 tower's text prototypes {text_gap['f32']:.2e} from the CPU's "
          f"(tol {TOL_ZS_TEXT_F32:g})")
    t0 = time.perf_counter()
    cpu_probs, f64_probs = zero_shot_reference(torch, model, batch, card_text["as_run"])
    ref_s = time.perf_counter() - t0
    gap = float(np.abs(card_probs - cpu_probs).max())
    gap64 = float(np.abs(card_probs - f64_probs).max())
    check(gap <= TOL_ZS_PROBS, f"{name}: test probabilities {gap:.3e} from the port's CPU "
                               f"computation (tol {TOL_ZS_PROBS:g})")
    passes = [f"{p['split']} {p['bags']} bags {p['seconds']:.2f} s" for p in run["eval_passes"]]
    log(f"{name}: build {run['build_s']:.1f} s, exec {run['exec_s']:.1f} s (pass {passes}), "
        f"peak device memory {run['peak_device_bytes'] / 2**30:.2f} GiB (at the start "
        f"{run['device_bytes_at_start'] / 2**30:.2f}), no kernel launched; "
        f"first test batch (bucket {int(batch['mask'].shape[1])}, {card_probs.shape[0]} "
        f"patients): probabilities vs the port on the CPU {gap:.3e} (tol {TOL_ZS_PROBS:g}), "
        f"vs float64 {gap64:.3e} (both from the card's text prototypes); text prototypes "
        f"card vs CPU: the tower in f32 {text_gap['f32']:.2e} (tol {TOL_ZS_TEXT_F32:g}), in "
        f"bf16 as run {text_gap['as_run']:.2e} (CPU reference {ref_s:.1f} s); metrics "
        f"{run['metrics']}; on {card}")
    out = {"config": {k: v for k, v in cfg.items() if k != "save_path"}, "store": store,
           "feats_dtype": feats_dtype, "pooling": pooling, "build_s": run["build_s"],
           "exec_s": run["exec_s"], "eval_passes": run["eval_passes"], "launches": launches,
           "peak_device_bytes": run["peak_device_bytes"],
           "device_bytes_at_start": run["device_bytes_at_start"], "metrics": run["metrics"],
           "test_prob_gap_to_cpu": gap, "test_prob_gap_to_f64": gap64,
           "text_gap_to_cpu": text_gap, "bucket": int(batch["mask"].shape[1]), "files": files}
    del handler, run
    torch.cuda.empty_cache()
    return out


def write_coop_checkpoint(torch, path, cfg) -> dict:
    """A reference-format training checkpoint ({"model": the learnable
    tensors under the reference's names, "epoch"}) whose CoOp embeddings
    have the shapes of `cfg`'s learner, random from ZS_SEED."""
    import numpy as np
    from vlsa_tpu_torch.config import fetch_kws
    from vlsa_tpu_torch.models.prompt_build import build_prompt_learner
    from vlsa_tpu_torch.models.tokenizer import Tokenizer

    pl_cfg = dict(fetch_kws(cfg, prefix="vlsa_pmt_learner_coop"), num_ranks=12)
    learner = build_prompt_learner(pl_cfg["method"], pl_cfg, Tokenizer(),
                                   np.zeros((ZS_TOWER["vocab"], ZS_TOWER["width"]), np.float32),
                                   ZS_TOWER["context"] - 1, ZS_TOWER["width"])
    g = torch.Generator().manual_seed(ZS_SEED + 1)
    model = {"prompt_learner.context_embeds":
             torch.randn(learner.context_embeds.shape, generator=g) * 0.02,
             "prompt_learner.rank_embeds": torch.randn(learner.rank_embeds.shape, generator=g) * 0.02,
             "logit_scale": torch.tensor(4.6)}
    torch.save({"model": model, "epoch": 10}, path)
    return model


def phase_zero_shot(torch, ab, co, device, card, tmp):
    """Phase 3i: the CONCH checkpoint, then ZS_CONFIG's three poolings from
    both of phase 3h's stores, then the flagship with the imported tower
    and a warm-started CoOp learner (phase 3h's bf16 .npy run)."""
    ckpt = os.path.join(tmp, "conch", "pytorch_model.bin")
    os.makedirs(os.path.dirname(ckpt))
    t0 = time.perf_counter()
    written = write_conch_checkpoint(ckpt, torch)
    log(f"CONCH-format checkpoint: {len(written)} tensors, {os.path.getsize(ckpt)} bytes, "
        f"written in {time.perf_counter() - t0:.1f} s")
    cpu_ref = {}
    runs = {f"{store}_{feats_dtype}_{pooling}": zero_shot_run(
                torch, ab, co, device, card, tmp, os.path.dirname(ckpt), written, store,
                feats_dtype, pooling, cpu_ref)
            for store, feats_dtype in ZS_STORES for pooling in ZS_POOLINGS}
    log(f"zero-shot: the CPU's text prototypes (bf16 and f32 tower) took "
        f"{cpu_ref['text_s']:.1f} s")
    del cpu_ref

    coop = write_coop_checkpoint(torch, os.path.join(tmp, ZS_COOP_CKPT.format(0, "rank")),
                                 LIFECYCLE_VLSA_CFG)

    def warm_started(handler):
        model = handler.model
        hold_imported_tower(torch, model, written, "flagship")
        for key in ("context_embeds", "rank_embeds"):
            check(torch.equal(getattr(model.prompt_learner, key).detach().cpu(),
                              coop[f"prompt_learner.{key}"]),
                  f"flagship: the CoOp learner's {key} is not the checkpoint's")
    stores = {store: (os.path.join(tmp, store),) for store, _ in ZS_STORES}
    flagship = store_run(torch, ab, co, device, card, stores, tmp, "vlsa_imported_coop_bf16_npy",
                         LIFECYCLE_VLSA_CFG, "npy",
                         dict(feats_dtype="bfloat16", path_clip_model=ckpt,
                              vlsa_pmt_learner_pretrained=True,
                              vlsa_pmt_learner_coop_ckpt=os.path.join(tmp, ZS_COOP_CKPT)),
                         "bf16", before_exec=warm_started)
    return {"checkpoint": {"tensors": len(written), "bytes": os.path.getsize(ckpt),
                           "tower": ZS_TOWER, "logit_scale": ZS_LOGIT_SCALE},
            "runs": runs, "flagship": flagship}


# ---------------------------------------------------------------- phase 3j

def interp_dataset(cfg, tmp, store):
    """Fold 0's 75 test patients from phase 3h's `store`, as the run's
    config names them."""
    from vlsa_tpu_torch.data.splits import read_file_data_splitting
    from vlsa_tpu_torch.runner.sa import build_surv_meta
    from vlsa_tpu_torch.runner.train import make_dataset

    split = read_file_data_splitting(cfg["data_split_path"])
    meta = build_surv_meta(dict(cfg), split)
    return make_dataset(dict(cfg, path_patch=os.path.join(tmp, store), feat_format=store),
                        meta, split["test"])


def all_launches(ab, co) -> dict:
    return {"coattn_fwd": dict(co.LAUNCHES), "coattn_bwd_dq": dict(co.LAUNCHES_BWD),
            "coattn_bwd_dx": dict(co.LAUNCHES_DX), "abmil_fwd": dict(ab.LAUNCHES),
            "abmil_bwd": dict(ab.LAUNCHES_BWD)}


def only_launches(launches: dict, family=None, variant=None, n=0) -> bool:
    """Exactly `n` launches of `family[variant]` and none of any other."""
    return all(c == (n if (f, v) == (family, variant) else 0)
               for f, counts in launches.items() for v, c in counts.items())


@contextlib.contextmanager
def cohort_events(torch, events):
    """CUDA event pairs around each batch's encode + decoupled product and
    around its Shapley values in interpret_cohort, by part into `events`."""
    from vlsa_tpu_torch.interpret import cohort

    def timed(fn, key):
        def run(*args, **kws):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kws)
            end.record()
            events.setdefault(key, []).append((start, end))
            return out
        return run
    originals = cohort.batch_decoupled, cohort.batched_shapley
    cohort.batch_decoupled = timed(originals[0], "encode_decoupled")
    cohort.batched_shapley = timed(originals[1], "shapley")
    try:
        yield
    finally:
        cohort.batch_decoupled, cohort.batched_shapley = originals


def cohort_pass(torch, ab, co, model, dataset, csv_path=None) -> tuple:
    """interpret_cohort over `dataset`, every launch counter from 0 just
    before: (its output, {wall seconds, patients/s, card ms by part, peak
    device memory, launches})."""
    from vlsa_tpu_torch.interpret import interpret_cohort

    co.reset_launches()
    ab.reset_launches()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = {}
    t0 = time.perf_counter()
    with cohort_events(torch, events):
        out = interpret_cohort(model, dataset, batch_size=INTERP_BATCH, save_path=csv_path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {"wall_s": wall, "patients_per_s": len(out["uid"]) / wall,
                 "card_ms": {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()},
                 "peak_device_bytes": torch.cuda.max_memory_allocated(),
                 "launches": all_launches(ab, co)}


def risk_values_f64(sims, ls):
    """v(S) of every coalition in float64: the reference's enumeration
    (ref utils/model_inference.py:23-79), coalition j holding prior i when
    bit i of j is set, v(empty) = 1.  sims [P, K] -> (V [2^P], members
    [2^P, P])."""
    import numpy as np
    sims = np.asarray(sims, np.float64)
    P, K = sims.shape
    members = (np.arange(2 ** P)[:, None] >> np.arange(P)) & 1
    z = ls * (members @ sims) / np.maximum(members.sum(1, keepdims=True), 1)
    p = np.exp(z - z.max(1, keepdims=True))
    V = (p / p.sum(1, keepdims=True)) @ (K - np.arange(K))
    V[0] = 1.0
    return V, members


def shapley_f64(sims, ls):
    """The reference's Shapley sums over risk_values_f64, in float64."""
    import numpy as np
    V, members = risk_values_f64(sims, ls)
    P = members.shape[1]
    fac = [math.factorial(i) for i in range(P + 1)]
    W = np.array([fac[s] * fac[P - s - 1] / fac[P] for s in range(P)])
    size, j = members.sum(1), np.arange(len(V))
    return np.array([np.sum(W[size[members[:, i] == 0]]
                            * (V[j[members[:, i] == 0] + 2 ** i] - V[j[members[:, i] == 0]]))
                     for i in range(P)])


def check_cohort(name, out, uids, ls, csv_path) -> dict:
    """The cohort's shapes, finite values, probabilities summing to 1, the
    efficiency axiom per patient (v(all) in float64 from the returned
    similarities) and its CSV; returns the largest gaps."""
    import csv as csv_mod
    import numpy as np
    n = len(uids)
    dec, shap, probs = (out[k] for k in INTERP_KEYS)
    check(out["uid"] == list(uids), f"{name}: the patients are not the dataset's, in order")
    check(dec.shape == (n, 12, 12) and shap.shape == (n, 12) and probs.shape == (n, 12),
          f"{name}: shapes {dec.shape}, {shap.shape}, {probs.shape}")
    check(all(np.isfinite(out[k]).all() for k in INTERP_KEYS), f"{name}: a value is not finite")
    sum_gap = float(np.abs(probs.astype(np.float64).sum(-1) - 1).max())
    check(sum_gap <= TOL_INTERP_SUM, f"{name}: probabilities sum to 1 within {sum_gap:.2e}")
    eff = []
    for b in range(n):
        v_all = risk_values_f64(dec[b], ls)[0][-1]
        eff.append(abs(float(shap[b].astype(np.float64).sum()) - (v_all - 1.0))
                   / max(1.0, abs(v_all)))
    check(max(eff) <= TOL_INTERP_EFFICIENCY,
          f"{name}: the efficiency axiom holds within {max(eff):.2e} (tol "
          f"{TOL_INTERP_EFFICIENCY:g})")
    with open(csv_path, newline="") as f:
        rows = list(csv_mod.reader(f))
    header = (["patient_id"] + [f"shap_prior_{i}" for i in range(12)]
              + [f"incidence_{k}" for k in range(12)])
    check(rows[0] == header and len(rows) == n + 1 and [r[0] for r in rows[1:]] == list(uids),
          f"{name}: the CSV has {len(rows) - 1} rows, header {rows[0][:3]}...")
    values = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    check(np.array_equal(values, np.concatenate([shap, probs], 1).astype(np.float64)),
          f"{name}: the CSV's values are not the cohort's")
    return {"prob_sum_gap": sum_gap, "efficiency_gap": max(eff)}


def rel_gaps(got: dict, want: dict, n=None) -> dict:
    import numpy as np
    return {k: float(np.abs(got[k][:n] - want[k][:n]).max() / np.abs(want[k][:n]).max())
            for k in INTERP_KEYS}


def cpu_first_batch(torch, model, dataset, text, query, ls) -> dict:
    """The cohort's first batch through the port on the CPU from the card's
    text prototypes and queries (the model's image side copied over)."""
    import copy
    from vlsa_tpu_torch.data.pipeline import BagBatcher
    from vlsa_tpu_torch.interpret.cohort import batch_decoupled
    from vlsa_tpu_torch.interpret.shapley import batched_shapley

    batch = BagBatcher(dataset, batch_size=INTERP_BATCH, prefetch=0).make_batch(
        range(INTERP_BATCH))
    tower, model.prompt_encoder = model.prompt_encoder, None
    try:
        cpu = copy.deepcopy(model).to("cpu")
    finally:
        model.prompt_encoder = tower
    with torch.inference_mode():
        dec, probs = batch_decoupled(cpu, batch["feats"], batch["mask"], query.cpu(),
                                     text.cpu(), ls)
        shap = batched_shapley(dec, ls)
    valid = batch["valid"].numpy()
    return {"decoupled_similarity": dec.numpy()[valid], "shap_importance": shap.numpy()[valid],
            "probs": probs.numpy()[valid]}


def padded_bag(torch, dataset, device):
    """Test patient 0's stored bag [1, n + INTERP_PAD, 512] f32 with
    INTERP_PAD rows of noise after it, masked out."""
    feats = torch.from_numpy(dataset[0][0])
    g = torch.Generator().manual_seed(17)
    x = torch.cat([feats, 5 * torch.randn(INTERP_PAD, feats.shape[1], generator=g)])[None]
    mask = torch.zeros(x.shape[:2], dtype=torch.bool)
    mask[0, :feats.shape[0]] = True
    return x.to(device), mask.to(device), feats.shape[0]


def timed_call(torch, fn, runs=3):
    """(the first call's output, the least host-clock seconds of `runs`
    calls, each ending with its numpy outputs on the host)."""
    out, best = None, float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        best = min(best, time.perf_counter() - t0)
        out = res if out is None else out
    return out, best


def single_bags(torch, ab, co, model, cfg, dataset, device, card) -> dict:
    """calc_text_img_similarity on a padded stored bag in f32 and in bf16,
    and calc_abmil_text_img_similarity with a full-width DeepMIL-encoder
    VLSA (D=512, hid=256, Adapter head) on it."""
    from vlsa_tpu_torch.interpret import (calc_abmil_text_img_similarity,
                                          calc_text_img_similarity)
    from vlsa_tpu_torch.runner.vlsa import build_model

    x, mask, n = padded_bag(torch, dataset, device)
    N = x.shape[1]
    shapes = {"attention": (12, N), "coattn_score": (12, N), "probs": (1, 12),
              "probs_decoupled": (1, 12), "decoupled_similarity": (12, 12),
              "decoupled_imp": (12, 12), "shap_importance": (12,)}
    out = {"patches": n, "rows": N}
    for dtype, variant in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        name = f"single bag {variant}"
        co.reset_launches()
        ab.reset_launches()
        res, sec = timed_call(torch, lambda: calc_text_img_similarity(model, x.to(dtype), mask))
        launches = all_launches(ab, co)
        check(only_launches(launches, "coattn_fwd", variant, 3),
              f"{name}: launches {launches}, expected one {variant} forward a call")
        check(set(res) == set(shapes) | {"logit_scale"}
              and all(res[k].shape == s for k, s in shapes.items()),
              f"{name}: keys and shapes { {k: getattr(v, 'shape', v) for k, v in res.items()} }")
        A = res["coattn_score"]
        row_gap = float(abs(A[:, :n].astype("float64").sum(-1) - 1).max())
        check(row_gap <= TOL_INTERP_SUM and float(abs(A[:, n:]).max()) == 0.0,
              f"{name}: attention rows sum to 1 within {row_gap:.2e}, padding "
              f"{float(abs(A[:, n:]).max()):.2e}")
        check(all(bool((abs(res[k]) < float("inf")).all()) for k in shapes),
              f"{name}: a value is not finite")
        out[variant] = {"seconds": sec, "row_sum_gap": row_gap, "launches_per_call": 1}
        log(f"{name}: {n} patches padded to {N}, calc_text_img_similarity {sec * 1e3:.1f} ms "
            f"(least of 3, host clock), one {variant} co-attention forward a call, rows sum to "
            f"1 within {row_gap:.1e}, padding 0, on {card}")

    abmil_cfg = dict(cfg, vlsa_img_encoder_name="DeepMIL", vlsa_img_encoder_dim_hid=256,
                     vlsa_img_encoder_pred_head="Adapter", vlsa_img_encoder_mil_pooling="attention")
    abmil_model = build_model(abmil_cfg, device=device)
    co.reset_launches()
    ab.reset_launches()
    res, sec = timed_call(torch, lambda: calc_abmil_text_img_similarity(abmil_model, x, mask))
    launches = all_launches(ab, co)
    check(only_launches(launches), f"abmil single bag: launches {launches}, expected none")
    A = res["attention"]
    gap = float(abs(A[0, :n].astype("float64").sum() - 1))
    check(A.shape == (1, N) and res["probs"].shape == (1, 12) and gap <= TOL_INTERP_SUM
          and float(abs(A[0, n:]).max()) == 0.0,
          f"abmil single bag: attention {A.shape} sums to 1 within {gap:.2e}, padding "
          f"{float(abs(A[0, n:]).max()):.2e}")
    out["abmil"] = {"seconds": sec, "sum_gap": gap}
    log(f"abmil single bag (DeepMIL D=512, hid=256, Adapter): "
        f"calc_abmil_text_img_similarity {sec * 1e3:.1f} ms, no kernel launched, the "
        f"attention sums to 1 within {gap:.1e}, padding 0, on {card}")
    del abmil_model
    torch.cuda.empty_cache()
    return out


def a10_run(torch, ab, co, device, card, tmp, name, base_cfg, store, changes, variant, moved):
    """One A10_RUNS run: store_run's checks, and the new pooling's
    parameters moved by the epoch."""
    before = {}

    def snapshot(handler):
        params = dict(handler.model.named_parameters())
        before.update({k: params[k].detach().float().cpu().clone() for k in moved})

    def has_moved(handler):
        params = dict(handler.model.named_parameters())
        still = [k for k in moved if torch.equal(params[k].detach().float().cpu(), before[k])]
        check(not still, f"{name}: parameters that did not move: {still}")
    stores = {s: (os.path.join(tmp, s),) for s in INTERP_STORES}
    return store_run(torch, ab, co, device, card, stores, tmp, name, base_cfg, store, changes,
                     variant, before_exec=snapshot, after_exec=has_moved)


def phase_interpretation(torch, ab, co, device, card, tmp, keep):
    """Phase 3j: phase 3h's flagship run reloaded; the cohort from both
    stores, held against the plain pooling, the CPU and a float64
    enumeration; single bags; the §A.10 runs."""
    import numpy as np
    from vlsa_tpu_torch.data.pipeline import BagBatcher
    from vlsa_tpu_torch.interpret import load_vlsa_from_run
    from vlsa_tpu_torch.ops.masked import l2_normalize

    run_dir = os.path.join(tmp, INTERP_RUN)
    t0 = time.perf_counter()
    model, cfg = load_vlsa_from_run(run_dir, ckpt_type="last", return_cfg=True)
    reload_s = time.perf_counter() - t0
    trained = keep.pop(INTERP_RUN).eval()
    npy_set = interp_dataset(cfg, tmp, "npy")
    batch = BagBatcher(npy_set, batch_size=INTERP_BATCH, feats_dtype=cfg["feats_dtype"],
                       prefetch=0).make_batch(range(INTERP_BATCH))
    feats, mask = batch["feats"].to(device), batch["mask"].to(device)
    with torch.inference_mode():
        got, want = model(feats, mask)[0], trained(feats, mask)[0]
    reload_gap = float((got - want).abs().max())
    check(reload_gap <= TOL_INTERP_RELOAD, f"reload: logits {reload_gap:.2e} from the trained "
                                           f"model's (tol {TOL_INTERP_RELOAD:g})")
    log(f"reload: {run_dir} rebuilt in {reload_s:.1f} s, logits of {INTERP_BATCH} test bags "
        f"({cfg['feats_dtype']}) {reload_gap:.2e} from the model phase 3h trained")
    del trained, feats, mask, batch
    keep.clear()

    ls = float(torch.exp(model.logit_scale.detach().float()))
    out = {"run": INTERP_RUN, "reload_s": reload_s, "reload_logit_gap": reload_gap,
           "cohort": {}, "launches": {"coattn_fwd": dict.fromkeys(co.LAUNCHES, 0)}}
    n_batches = -(-len(npy_set) // INTERP_BATCH)
    cohorts = {}
    for store in INTERP_STORES:
        name = f"cohort {store}"
        dataset = npy_set if store == "npy" else interp_dataset(cfg, tmp, store)
        check(len(dataset) == 75, f"{name}: {len(dataset)} test patients, not 75")
        csv_path = os.path.join(tmp, f"cohort_{store}.csv")
        res, stats = cohort_pass(torch, ab, co, model, dataset, csv_path)
        check(only_launches(stats["launches"], "coattn_fwd", "f32", n_batches),
              f"{name}: launches {stats['launches']}, expected {n_batches} f32 forwards")
        out["launches"]["coattn_fwd"]["f32"] += n_batches
        stats.update(check_cohort(name, res, dataset.uid, ls, csv_path))
        cohorts[store] = res
        out["cohort"][store] = stats
        ms = stats["card_ms"]
        log(f"{name}: {len(dataset)} patients in {stats['wall_s']:.2f} s "
            f"({stats['patients_per_s']:.1f} patients/s, host clock, batch {INTERP_BATCH}); "
            f"card time encode + decoupled {ms['encode_decoupled']:.1f} ms, Shapley "
            f"{ms['shapley']:.1f} ms (CUDA events); peak device memory "
            f"{stats['peak_device_bytes'] / 2**30:.2f} GiB; {n_batches} f32 co-attention "
            f"forwards, no other kernel; efficiency within {stats['efficiency_gap']:.1e}; "
            f"on {card}")

    # the references: the plain pooling on the card, the CPU, float64
    npy = cohorts["npy"]
    with plain_coattention():
        plain, plain_stats = cohort_pass(torch, ab, co, model, npy_set)
    check(only_launches(plain_stats["launches"]), "the plain cohort launched a kernel")
    plain_gap = rel_gaps(npy, plain)
    check(max(plain_gap.values()) <= TOL_INTERP_PLAIN,
          f"cohort vs the plain pooling: {plain_gap} (tol {TOL_INTERP_PLAIN:g})")
    with torch.inference_mode():
        text = l2_normalize(model.forward_text_only().float(), dim=-1)
        query = model.get_query()
    t0 = time.perf_counter()
    cpu = cpu_first_batch(torch, model, npy_set, text, query, ls)
    cpu_s = time.perf_counter() - t0
    cpu_gap = rel_gaps(npy, cpu, n=len(cpu["probs"]))
    check(max(cpu_gap.values()) <= TOL_INTERP_CPU,
          f"first batch, card vs CPU: {cpu_gap} (tol {TOL_INTERP_CPU:g})")
    f64_gap = []
    for b in range(INTERP_F64_PATIENTS):
        ref = shapley_f64(npy["decoupled_similarity"][b], ls)
        f64_gap.append(float(np.abs(npy["shap_importance"][b] - ref).max() / np.abs(ref).max()))
    check(max(f64_gap) <= TOL_INTERP_F64,
          f"Shapley values vs float64 enumeration: {f64_gap} (tol {TOL_INTERP_F64:g})")
    q8_gap = rel_gaps(cohorts["q8npz"], npy)
    out.update(plain_gap=plain_gap, plain=plain_stats, cpu_gap=cpu_gap, cpu_s=cpu_s,
               f64_gap=f64_gap, q8npz_vs_npy=q8_gap, logit_scale=ls,
               max_abs_shap=float(np.abs(npy["shap_importance"]).max()))
    log(f"cohort references: kernel vs plain pooling {plain_gap} (tol {TOL_INTERP_PLAIN:g}; "
        f"plain pass {plain_stats['wall_s']:.2f} s); first batch card vs CPU {cpu_gap} (tol "
        f"{TOL_INTERP_CPU:g}, {cpu_s:.1f} s); Shapley vs float64 enumeration of "
        f"{INTERP_F64_PATIENTS} patients {max(f64_gap):.2e} of max|phi| (tol "
        f"{TOL_INTERP_F64:g}; max|phi| {out['max_abs_shap']:.3e}); .q8npz vs .npy {q8_gap} "
        f"(int8 storage rounding)")

    single = single_bags(torch, ab, co, model, cfg, npy_set, device, card)
    for v in ("f32", "bf16"):
        out["launches"]["coattn_fwd"][v] += 3
    out["single"] = single
    del model
    torch.cuda.empty_cache()
    out["runs"] = {spec[0]: a10_run(torch, ab, co, device, card, tmp, *spec)
                   for spec in A10_RUNS}
    return out


# ---------------------------------------------------------------- phase 3l

def queries_batch(torch, batches, device, K):
    """The next of a trainer's `batches` on the card, patients censored in
    the last of its K bins left out of `valid` (see phase_training)."""
    b = {k: v.to(device) for k, v in next(batches).items()}
    ill = b["valid"] & (b["e"] == 0) & (b["t"] == K - 1)
    return dict(b, valid=b["valid"] & ~ill)


def phase_queries(torch, ab, co, device, card, tmp):
    """Phase 3l: the flagship with 32 learned, gated VLFAN queries (P = 32)
    through the entry points, every launch counter from 0 before each path:
    served (QUERIES_SERVED; probabilities within 1e-3 of the plain
    co-attention), trained 1 epoch from phase 3h's bf16 .npy store through
    `python -m vlsa_tpu_torch.main` (store_run's checks, the reload bit for
    bit), a store batch's gradients through the kernels against the plain
    co-attention (text tower in f32) within TOL_GRAD, and with the feature
    projecter QUERIES_FEAT_PROJ_STEPS Adam steps from the store whose last
    batch's gradients meet CoattnPoolFull on the plain kernels within
    TOL_GRAD; every launch on the query routes ("grid", "loop")."""
    import numpy as np
    from vlsa_tpu_torch.config import serving_config, training_config
    from vlsa_tpu_torch.models.vlsa_build import build_vlsa_from_config
    from vlsa_tpu_torch.runner.engine import InferEngine
    from vlsa_tpu_torch.runner.serve import request_bags
    from vlsa_tpu_torch.runner.train import Trainer

    # ---- serving ----
    cfg = serving_config(dict(FLAGSHIP_CFG, **GATED_QUERIES))
    model, _tok = build_vlsa_from_config(cfg, device=device)
    enc = model.mil_encoder
    check(tuple(enc.Q.shape) == (33, 512) and tuple(enc.effective_query().shape) == (32, 512),
          f"the gated queries: Q {tuple(enc.Q.shape)}, P = {enc.effective_query().shape[0]}")
    engines, requests = {}, []
    for feats_dtype, inv, count in QUERIES_SERVED:
        engines[(feats_dtype, inv)] = InferEngine(model, feats_dtype=feats_dtype,
                                                  precompute_inv=inv)
        requests += [((feats_dtype, inv), request_bags(cfg["path_patch"], len(requests) + i,
                                                       BAGS_PER_REQUEST)) for i in range(count)]
    for e in engines.values():
        e.text_precompute()
    co.reset_launches()
    served = []
    for key, bags in requests:
        t = time.perf_counter()
        batch = engines[key].prepare(bags)
        torch.cuda.synchronize()
        t_mid = time.perf_counter()
        out = engines[key].forward(batch)
        torch.cuda.synchronize()
        served.append((key, batch, out, 1e3 * (t_mid - t), 1e3 * (time.perf_counter() - t_mid)))
    serve_launches, serve_paths = dict(co.LAUNCHES), dict(co.LAUNCHES_QUERY_PATH)
    expected = dict.fromkeys(VARIANTS, 0)
    for (feats_dtype, inv), *_rest in served:
        expected["int8_inv" if feats_dtype == "int8" else "bf16"] += 1
    log(f"P=32 served {len(served)} requests: launches {serve_launches}, query routes "
        f"{serve_paths}")
    check(serve_launches == expected and serve_paths == {"single": 0, "grid": len(served),
                                                         "chunked": 0, "loop": 0},
          f"P=32 serving launches {serve_launches} {serve_paths}, expected {expected}")
    serve_dev = 0.0
    with plain_coattention():
        for key, batch, out, prep_ms, fwd_ms in served:
            probs = out["probs"]
            check(tuple(probs.shape) == (BAGS_PER_REQUEST, 12)
                  and float((probs.sum(-1) - 1).abs().max()) <= 1e-5, "P=32 probabilities")
            dev = float((probs - engines[key].forward(batch)["probs"]).abs().max())
            serve_dev = max(serve_dev, dev)
            log(f"P=32 served {key[0]}{'_inv' if key[1] else ''}: host prep {prep_ms:.1f} ms + "
                f"model {fwd_ms:.2f} ms, max |p_kernel - p_plain| {dev:.2e} (tol 1e-3)")
    check(serve_dev <= 1e-3, f"P=32 served probabilities deviate {serve_dev:.3e} from plain")
    check(co.LAUNCHES == serve_launches, "the plain serving pass launched a kernel")
    del model, engines, served, requests
    torch.cuda.empty_cache()

    # ---- training: 1 epoch from the store through main, the reload ----
    stores = {"npy": (os.path.join(tmp, "npy"),)}
    run = store_run(torch, ab, co, device, card, stores, tmp, *QUERIES_RUN,
                    after_exec=lambda h: dict(co.LAUNCHES_QUERY_PATH), hold_reload=True,
                    via_main=True)
    n_run = sum(run["launches"]["coattn_fwd"].values()) \
        + sum(run["launches"]["coattn_bwd_dq"].values())
    check(run["after"] == {"single": 0, "grid": n_run, "chunked": 0, "loop": 0},
          f"P=32 run: query routes {run['after']}, expected {n_run} grid launches")
    shutil.rmtree(os.path.join(tmp, QUERIES_RUN[0]), ignore_errors=True)

    # ---- gradients through the kernels (dQ) against the plain co-attention ----
    store_cfg = dict(TRAIN_CFG, **GATED_QUERIES, path_patch=stores["npy"][0], feat_format="npy")
    trainer = Trainer(training_config(store_cfg, fold=0), device)
    trainer.batcher.prefetch = 0  # a batch or two taken: none built ahead
    K = trainer.meta.num_bins
    learnable = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    check("mil_encoder.Q" in learnable, f"the queries are not learnable: {learnable}")
    b = queries_batch(torch, trainer.batches(), device, K)
    with f32_text_tower(torch, trainer.model.prompt_encoder):
        co.reset_launches()
        g_kernel = param_grads(torch, trainer.model, trainer.engine, b)
        check(co.LAUNCHES_QUERY_PATH == {"single": 0, "grid": 2, "chunked": 0, "loop": 0},
              f"P=32 gradient: query routes {co.LAUNCHES_QUERY_PATH}")
        with plain_coattention():
            dev_dq = grad_devs(g_kernel, param_grads(torch, trainer.model, trainer.engine, b),
                               learnable)
    worst = max(dev_dq, key=dev_dq.get)
    log(f"P=32 gradients, kernels vs plain co-attention, bf16 store batch: "
        f"{int(b['valid'].sum())} bags, bucket {b['mask'].shape[1]}, text tower in f32: worst "
        f"{worst} {dev_dq[worst]:.2e} (tol {TOL_GRAD:g}); mil_encoder.Q "
        f"{dev_dq['mil_encoder.Q']:.2e}")
    check(dev_dq[worst] <= TOL_GRAD, f"P=32: gradient of {worst} deviates {dev_dq[worst]:.3e}")
    del trainer, b, g_kernel
    torch.cuda.empty_cache()

    # ---- the feature projecter: Adam steps from the store, then gradients ----
    trainer = Trainer(training_config(dict(store_cfg, vlsa_img_encoder_use_feat_proj=True),
                                      fold=0), device)
    model, engine = trainer.model, trainer.engine
    trainer.batcher.prefetch = 0
    check(model.mil_encoder.use_feat_proj, "the projecter is off")
    tower0 = {k: v.detach().clone() for k, v in model.prompt_encoder.state_dict().items()}
    learnable = [n for n, p in model.named_parameters() if p.requires_grad]
    batches = trainer.batches()
    co.reset_launches()
    steps = []
    for i in range(QUERIES_FEAT_PROJ_STEPS):
        t = time.perf_counter()
        batch = {k: v.to(device) for k, v in next(batches).items()}
        torch.cuda.synchronize()
        t_mid = time.perf_counter()
        before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
        torch.cuda.reset_peak_memory_stats()
        loss, raw = engine.train_step(batch)
        torch.cuda.synchronize()
        rec = {"loss": float(loss), "bags": int(batch["valid"].sum()),
               "bucket": int(batch["mask"].shape[1]), "prep_ms": 1e3 * (t_mid - t),
               "step_ms": 1e3 * (time.perf_counter() - t_mid),
               "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        check(bool(np.isfinite(rec["loss"])) and bool(torch.isfinite(raw).all()),
              f"P=32 feat-proj step {i}: non-finite loss or logits")
        check(all(torch.equal(v, tower0[k]) for k, v in model.prompt_encoder.state_dict().items()),
              f"P=32 feat-proj step {i}: the frozen tower changed")
        still = [n for n, p in model.named_parameters()
                 if p.requires_grad and torch.equal(p.detach(), before[n])]
        check(not still, f"P=32 feat-proj step {i}: {still} did not move")
        steps.append(rec)
        log(f"P=32 feat-proj step {i} loss {rec['loss']:.4f}  {rec['bags']} bags, bucket "
            f"{rec['bucket']}: host prep {rec['prep_ms']:.0f} ms + step {rec['step_ms']:.1f} ms, "
            f"peak device memory {rec['max_memory_gb']:.2f} GB")
        del batch, before, loss, raw
    fp_launches = {"fwd": dict(co.LAUNCHES), "bwd": dict(co.LAUNCHES_BWD),
                   "dx": dict(co.LAUNCHES_DX)}
    fp_paths = dict(co.LAUNCHES_QUERY_PATH)
    n = QUERIES_FEAT_PROJ_STEPS
    check(fp_launches["fwd"] == dict(dict.fromkeys(VARIANTS, 0), bf16=n)
          and fp_launches["dx"] == {"f32": 0, "bf16": n}
          and sum(fp_launches["bwd"].values()) == 0
          and fp_paths == {"single": 0, "grid": n, "chunked": 0, "loop": n},
          f"P=32 feat-proj launches {fp_launches}, query routes {fp_paths}")
    b = queries_batch(torch, batches, device, K)
    with f32_text_tower(torch, model.prompt_encoder):
        g_kernel = param_grads(torch, model, engine, b)
        with plain_full_backward(torch, co):
            dev_fp = grad_devs(g_kernel, param_grads(torch, model, engine, b), learnable)
        with plain_coattention():
            dev_auto = grad_devs(g_kernel, param_grads(torch, model, engine, b), learnable)
    worst, worst_auto = max(dev_fp, key=dev_fp.get), max(dev_auto, key=dev_auto.get)
    log(f"P=32 feat-proj gradients, bf16 store batch: {int(b['valid'].sum())} bags, bucket "
        f"{b['mask'].shape[1]}, text tower in f32: kernels vs plain kernels worst {worst} "
        f"{dev_fp[worst]:.2e} (tol {TOL_GRAD:g}); vs autograd of the plain pooling worst "
        f"{worst_auto} {dev_auto[worst_auto]:.2e} (logged: autograd does not round a, g and dl)")
    check(dev_fp[worst] <= TOL_GRAD, f"P=32 feat-proj: gradient of {worst} deviates "
                                     f"{dev_fp[worst]:.3e} from the plain kernels'")
    del trainer, model, engine, b, g_kernel
    torch.cuda.empty_cache()

    launches = {
        "fwd": {v: serve_launches[v] + run["launches"]["coattn_fwd"][v] + fp_launches["fwd"][v]
                for v in VARIANTS},
        "dq": dict(run["launches"]["coattn_bwd_dq"]), "dx": dict(fp_launches["dx"])}
    log(f"P=32 paths' launches {launches}")
    return {"queries": 32, "serving": {"launches": serve_launches, "max_prob_dev": serve_dev},
            "run": run, "grad_dev_dq": dev_dq, "feat_proj": {
                "steps": steps, "launches": fp_launches, "grad_dev_plain_kernels": dev_fp,
                "grad_dev_autograd": dev_auto},
            "launches": launches}


# ---------------------------------------------------------------- phase 3t

# phase 3t: multi-process runs on the one card.  Four ranks (spawned, gloo:
# they share the card, so each collective stages through host memory) on
# data x model grids; the card time-slices them, so no time here is a scaling
# figure.  The sequence-parallel pools at SHAPE on {data: 2, model: 2} and
# {data: 1, model: 4}: (storage, x needs a gradient: the projecter's dX)
MP_WORLD = 4
MP_GRIDS = {"model2": (2, 2), "model4": (1, 4)}
MP_COATTN = (("f32", False), ("bf16", False), ("bf16", True))
MP_ABMIL = (("f32", False), ("bf16", False), ("f32", True), ("bf16", True))
# the flagship (bf16, the CONCH tower at full width, tensor and sequence
# parallel) and the SA 512-256-12 (f32, ABMIL sequence parallel) on
# {data: 2, model: 2}: MP_STEPS steps of 32 bags and an evaluation pass of
# the test split, against the same on one rank; bags of N~512 (fold 0's
# largest patient 4,399 patches: one fixed bucket, as the ranks need, that
# splits over model=2; cut from N~1024 and 3 steps for the script's time).  The SA's losses are held at TOL_MP_LOSS.  The
# flagship's bf16 tower sums its tensor-parallel MLP in another order than
# one rank does, which moves bf16 roundings of the next operands (and of the
# cotangents) by an ulp, as vlsa_tpu's own bf16 mesh step moves them
# (tests/test_torch_parallel.py::test_flagship_step_with_a_bf16_tower: there,
# on the CPU, each package's gap between its grid and one device, in the loss
# and in every learned leaf's gradient, is no larger than bf16's whole effect,
# the one-device bf16 step's gap from the f32 tower's; at most 0.83 of it in
# the port, 0.54 in vlsa_tpu).  Once a flipped rounding has spread, the two
# runs carry two draws of bf16's noise, which differ by up to sqrt(2) of one
# draw's distance from the f32 tower.  So the first step's loss and every
# gradient of it are held within MP_BF16_TP times that effect, measured here
# (one rank's bf16 step against one rank's with the tower in f32), or within
# TOL_MP_LOSS where that is larger; 2 leaves room for the spread of a max
# over a leaf's elements.  The later steps' losses are printed, not held:
# Adam's first update is near sign(g), so an element whose gradient bf16
# leaves at noise level steps by the full rate either way, and the runs part
# by more than bf16 moves the step itself.
MP_BF16_TP = 2.0
MP_MESH = {"data": 2, "model": 2}
MP_STEPS = 2
MP_BAGS = "synthetic://N=512,D=512,seed=7"
MP_BUCKET = 4608
TOL_MP_LOSS = 1e-4  # the SA grid's losses against one rank's (relative)
# the two-process `distributed` SA run through `python -m vlsa_tpu_torch.main`:
# one epoch, bags of N~128 (largest patient 1,099; cut from N~512 for the
# script's time)
MP_DIST_BAGS = "synthetic://N=128,D=512,seed=7"
MP_DIST_BUCKET = 1152
MP_DIST_TIMEOUT_S = 300
MP_REDUCED = {"epochs": "10 -> 2 steps and one evaluation pass (the two-process run: 1 epoch;"
                        " the MP_A18_RUNS: 2 steps, no evaluation)",
              "bag N": "~8192 -> ~512 (two-process run ~128), one fixed bucket"}
# what a mesh ran only on one rank before (ROADMAP.md §A.18), each run
# held against one rank's run of the same global steps (the first step's
# gradients and Hessian estimate within TOL_GRAD, the losses within
# TOL_MP_LOSS): 2 adahessian steps of the flagship (the tower in f32: bf16's
# rounding flips would blur the check) on {data: 2, model: 2} with TP and
# SP, and of the SA on {data: 4, model: 1}, every rank and the one rank
# drawing the same z (the engine's generator, one seed, the optimizer's
# parameter order; the second loss follows the first update, H z's); and 2
# steps of the SA's Cox model (SurvPLE, which couples the bags) with
# accum_steps 2 on {4, 1} and {2, 2}, each rank fed its shares of vlsa_tpu's
# contiguous micro-batches.  (name, kind, changes, mesh, steps)
MP_PLE = dict(loss_type="SurvPLE", time_format="origin", evaluator="Cox",
              net_output_converter=None, net_dims="512-256-1")
# the leaf a loss is invariant to: the Cox likelihood of a shift of every
# risk (the output bias) is the same, so that leaf's gradient is f32
# rounding noise, some 1e-6 of the largest gradient: it is held against the
# model's largest gradient, at TOL_GRAD, and must stay below MP_SHIFT_NOISE
# of it
MP_SHIFT_LEAF = {"SurvPLE": "g.bias"}
MP_SHIFT_NOISE = 1e-5
MP_A18_RUNS = (
    ("vlsa_adahessian", "vlsa_f32", dict(opt_name="adahessian"), {"data": 2, "model": 2}, 2),
    ("sa_adahessian", "sa", dict(opt_name="adahessian"), {"data": 4, "model": 1}, 2),
    ("sa_ple_accum_4x1", "sa", dict(MP_PLE, accum_steps=2), {"data": 4, "model": 1}, 2),
    ("sa_ple_accum_2x2", "sa", dict(MP_PLE, accum_steps=2), {"data": 2, "model": 2}, 2),
)


def phase_tol(family: str, quantity: str, storage: str) -> float:
    """The limit phases 2-2e hold a kernel's quantity to against its plain
    version (relative; bf16 co-attention dX by ulps, `hold_ulp`)."""
    if family == "coattn":
        if quantity == "out":
            return TOL_F32_FWD if storage == "f32" else TOL[storage]
        if quantity == "dq":
            return TOL_F32_BWD["dq"] if storage == "f32" else TOL_DQ[storage]
        return TOL_F32_BWD["dx"]  # f32 dX; bf16 by ulps (hold_ulp)
    if quantity in ("out", "l"):
        return TOL_ABMIL[storage]
    return TOL_ABMIL_DX[storage] if quantity == "dX" else TOL_ABMIL_DW[storage]


def hold_ulp(what, got, ref, ulps=1) -> dict:
    """bf16 dX within `ulps` bf16 ulps of its largest element."""
    ulp = ulps * bf16_ulp_of_max(ref)
    diff = (got.float() - ref.float()).abs().max().item()
    log(f"{what}: max|k-p| {diff:.3e}  (tol {ulps} bf16 ulp of the largest, {ulp:.3e})")
    check(bool(got.isfinite().all()) and diff <= ulp,
          f"{what}: {diff:.3e} beyond {ulps} bf16 ulp ({ulp:.3e})")
    return {"max_abs_err": diff, "rel_err": diff / max(ref.float().abs().max().item(), 1e-30)}


def hold_sp(what, family, quantity, storage, got, ref, merged):
    """A rank's launch against its plain version on its chunk at the limit
    of phases 2-2e, or (`merged`) the merged pool against the single-process
    kernel on the whole bag at twice it: both are held within that limit of
    one plain function."""
    k = 2 if merged else 1
    if family == "coattn" and quantity == "dX" and storage == "bf16":
        return hold_ulp(what, got, ref, ulps=k)
    return hold(what, got.float(), ref.float(), k * phase_tol(family, quantity, storage))


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def launch_counts(ab, co) -> dict:
    return {"coattn_fwd": dict(co.LAUNCHES), "coattn_bwd_dq": dict(co.LAUNCHES_BWD),
            "coattn_bwd_dx": dict(co.LAUNCHES_DX), "abmil_fwd": dict(ab.LAUNCHES),
            "abmil_bwd": dict(ab.LAUNCHES_BWD)}


def launch_delta(after: dict, before: dict) -> dict:
    return {fam: count_delta(c, before[fam]) for fam, c in after.items()}


def count_delta(after: dict, before: dict) -> dict:
    return {k: n - before[k] for k, n in after.items()}


def mp_slices(mesh, B, N):
    nd, nm = mesh.n_data, mesh.n_model
    lb, n = B // nd, N // nm
    return (slice(mesh.data_index * lb, (mesh.data_index + 1) * lb),
            slice(mesh.model_index * n, (mesh.model_index + 1) * n))


def mp_coattn_case(torch, ab, co, mesh, grid, storage, dx, device) -> dict:
    """One co-attention case on a rank: its forward and backward launches
    on its chunk against the plain versions (with the merged stats), the
    pool as VLFAN calls it (its launches counted), and the merged result
    against the single-process kernels on the data rank's whole bags."""
    from vlsa_tpu_torch.parallel import coattn_pool_sp
    from vlsa_tpu_torch.parallel.coattn_sp import merge_partials
    B, N, C, P = SHAPE["B"], SHAPE["N"], SHAPE["C"], SHAPE["P"]
    rows, cols = mp_slices(mesh, B, N)
    where = f"3t {grid} rank {mesh.rank} coattn {storage}{' dX' if dx else ''}"
    q, x, mask, _s, _i = make_inputs(torch, B, N, C, P, storage, seed=0, device=device,
                                     keep_masked=dx)
    g = make_cotangent(torch, B, P, C, device=device)
    xs, ms, gs = x[rows, cols].contiguous(), mask[rows, cols].contiguous(), g[rows].contiguous()
    errs = {}
    out_i, m_i, l_i = co.coattn_fwd(q, xs, ms, SCALE)
    ref = co.coattn_fwd_reference(q, xs, ms, SCALE)
    errs["fwd"] = hold_sp(f"{where} fwd", "coattn", "out", storage, out_i, ref[0], False)
    if not bool(ms[-1].any()):  # the empty bag, as phase 2 holds it
        check(float(out_i[-1].abs().max()) == 0.0 and bool(torch.all(m_i[-1] == -1e30))
              and bool(torch.all(l_i[-1] == 1e-30)), f"{where}: the empty bag's (out, m, l)")
    out_m, m_g, l_g = merge_partials(out_i, m_i, l_i, mesh.model_group)
    if dx:
        dq_i, dx_i = co.coattn_bwd_dx(q, xs, ms, SCALE, gs, out_m, m_g, l_g)
        rdq, rdx = co.coattn_bwd_dx_reference(q, xs, ms, SCALE, gs, out_m, m_g, l_g)
        errs["dx_dq"] = hold(f"{where} dq", dq_i, rdq, TOL_DX_DQ[storage])
        errs["dx"] = hold_sp(f"{where} dX", "coattn", "dX", storage, dx_i, rdx, False)
    else:
        dq_i = co.coattn_bwd_dq(q, xs, ms, SCALE, gs, out_m, m_g, l_g)
        rdq = co.coattn_bwd_dq_reference(q, xs, ms, SCALE, gs, out_m, m_g, l_g)
        errs["dq"] = hold_sp(f"{where} dq", "coattn", "dq", storage, dq_i, rdq, False)
    del ref
    before = launch_counts(ab, co)
    qq, xx = q.clone().requires_grad_(True), xs.clone().requires_grad_(dx)
    out = coattn_pool_sp(qq, xx, ms, SCALE, mesh)
    (out * gs).sum().backward()
    sync(torch, device)
    launches = launch_delta(launch_counts(ab, co), before)
    check(torch.equal(out, out_m), f"{where}: the pool merged otherwise than its steps")
    xw, mw = x[rows].contiguous(), mask[rows].contiguous()
    ow, mwg, lw = co.coattn_fwd(q, xw, mw, SCALE)
    errs["merged_out"] = hold_sp(f"{where} merged vs whole out", "coattn", "out", storage, out,
                                 ow, True)
    if dx:
        dqw, dxw = co.coattn_bwd_dx(q, xw, mw, SCALE, gs, ow, mwg, lw)
        errs["merged_dx"] = hold_sp(f"{where} merged vs whole dX", "coattn", "dX", storage,
                                    xx.grad, dxw[:, cols], True)
        errs["merged_dq"] = hold(f"{where} merged vs whole dq", qq.grad, dqw,
                                 2 * TOL_DX_DQ[storage])
    else:
        dqw = co.coattn_bwd_dq(q, xw, mw, SCALE, gs, ow, mwg, lw)
        errs["merged_dq"] = hold_sp(f"{where} merged vs whole dq", "coattn", "dq", storage,
                                    qq.grad, dqw, True)
    return {"errors": errs, "launches": launches}


def mp_abmil_case(torch, ab, co, mesh, grid, storage, dx, device) -> dict:
    """As `mp_coattn_case`, for the ABMIL pool at (512, 256)."""
    from vlsa_tpu_torch.parallel import abmil_pool_sp
    from vlsa_tpu_torch.parallel.coattn_sp import merge_partials
    B, N = SHAPE["B"], SHAPE["N"]
    rows, cols = mp_slices(mesh, B, N)
    where = f"3t {grid} rank {mesh.rank} abmil {storage}{' dX' if dx else ''}"
    x, _xs, mask, w1, b1, w2, g = make_abmil_inputs(torch, B, N, storage, device=device)
    xs, ms, gs = x[rows, cols].contiguous(), mask[rows, cols].contiguous(), g[rows].contiguous()
    errs = {}
    out_i, m_i, l_i = ab.abmil_fwd(xs, ms, w1, b1, w2)
    ref = ab.abmil_fwd_reference(xs, ms, w1, b1, w2)
    errs["fwd"] = hold_sp(f"{where} fwd", "abmil", "out", storage, out_i, ref[0], False)
    hold_sp(f"{where} fwd l", "abmil", "l", storage, l_i, ref[2], False)
    out_m, m_g, l_g = merge_partials(out_i, m_i, l_i, mesh.model_group)
    got = ab.abmil_bwd(xs, ms, w1, b1, w2, gs, out_m, m_g, l_g, need_dx=dx)
    want = ab.abmil_bwd_reference(xs, ms, w1, b1, w2, gs, out_m, m_g, l_g, need_dx=dx)
    for leaf, a, b in zip(("dX", "dW1", "db1", "dw2"), got, want):
        if b is not None:
            errs[leaf] = hold_sp(f"{where} {leaf}", "abmil", leaf, storage, a, b, False)
    del ref, got, want
    before = launch_counts(ab, co)
    params = [t.clone().requires_grad_(True) for t in (w1, b1, w2)]
    xx = xs.clone().requires_grad_(dx)
    out = abmil_pool_sp(xx, ms, *params, mesh)
    (out * gs).sum().backward()
    sync(torch, device)
    launches = launch_delta(launch_counts(ab, co), before)
    check(torch.equal(out, out_m), f"{where}: the pool merged otherwise than its steps")
    xw, mw = x[rows].contiguous(), mask[rows].contiguous()
    ow, mwg, lw = ab.abmil_fwd(xw, mw, w1, b1, w2)
    errs["merged_out"] = hold_sp(f"{where} merged vs whole out", "abmil", "out", storage, out,
                                 ow, True)
    whole = ab.abmil_bwd(xw, mw, w1, b1, w2, gs, ow, mwg, lw, need_dx=dx)
    mine = [xx.grad] + [p.grad for p in params]
    for leaf, a, b in zip(("dX", "dW1", "db1", "dw2"), mine, whole):
        if b is not None:
            b = b[:, cols] if leaf == "dX" else b
            errs[f"merged_{leaf}"] = hold_sp(f"{where} merged vs whole {leaf}", "abmil", leaf,
                                             storage, a, b, True)
    return {"errors": errs, "launches": launches}


def mp_cfg(kind: str, root: str, name: str, mesh, **changes) -> dict:
    """The flagship (bf16 features and text tower; "vlsa_f32": the tower
    in f32) or the SA (f32) run of phase 3g at MP_BAGS in one fixed bucket,
    evaluated in batches of 32, with `changes`; `mesh`: on MP_MESH (True)
    or on the grid it gives."""
    base = LIFECYCLE_SA_CFG if kind == "sa" else LIFECYCLE_VLSA_CFG
    cfg = dict(base, save_path=os.path.join(root, name), path_patch=MP_BAGS,
               fixed_bucket=MP_BUCKET, eval_batch_size=32, **changes)
    if kind == "vlsa_f32":
        cfg["vlsa_txt_encoder_dtype"] = "float32"
    if mesh:
        cfg["mesh"] = dict(MP_MESH if mesh is True else mesh)
    return cfg


def mp_steps(torch, ab, co, device, cfg, n_steps=MP_STEPS, evaluate=True) -> dict:
    """`n_steps` training steps of 32 bags and (`evaluate`) one evaluation
    pass of the test split through the handler (on a mesh when `cfg` has
    one): the losses, each step's ms and collective seconds, the first
    step's gradients and (adahessian) the Hessian estimate it handed the
    optimizer, the evaluation's seconds and metrics, the kernels'
    launches."""
    from vlsa_tpu_torch.data.pipeline import release_pinned_batches
    from vlsa_tpu_torch.parallel.collectives import COLLECTIVES, reset_collectives
    from vlsa_tpu_torch.runner.sa import SAHandler
    from vlsa_tpu_torch.runner.train import make_batcher
    from vlsa_tpu_torch.runner.vlsa import VLSAHandler
    handler = (VLSAHandler if cfg["task"] == "vlsa" else SAHandler)(dict(cfg), device=device)
    batches = iter(make_batcher(handler.trainer.dataset, handler.cfg, shuffle=True,
                                pin_memory=handler.device.type == "cuda",
                                mesh=handler.trainer.mesh))
    co.reset_launches()
    ab.reset_launches()
    reset_collectives()
    steps, grads, kept = [], None, {}
    if handler.engine.needs_hessian:  # the first step's Hessian estimate, by name
        names = {id(p): n for n, p in handler.model.named_parameters()}
        opt_step = handler.engine.optimizer.step

        def keep_hessian(*args, hessian=None, **kws):
            kept.setdefault("hessian", {names[id(p)]: h.detach().float().cpu()
                                        for p, h in hessian.items()})
            return opt_step(*args, hessian=hessian, **kws)
        handler.engine.optimizer.step = keep_hessian
    try:
        for _ in range(n_steps):
            batch = next(batches)
            sync(torch, device)
            t, c0 = time.perf_counter(), COLLECTIVES["seconds"]
            loss = float(handler.engine.train_step(batch)[0])
            sync(torch, device)
            steps.append({"loss": loss, "ms": 1e3 * (time.perf_counter() - t),
                          "collective_s": COLLECTIVES["seconds"] - c0})
            check(math.isfinite(loss), f"{cfg['task']}: a non-finite loss {loss}")
            if grads is None:  # the first step's gradients, summed over the grid's groups
                grads = {n: p.grad.detach().float().cpu()
                         for n, p in handler.model.named_parameters() if p.grad is not None}
    finally:
        batches.close()
    mesh = handler.mesh
    out = {"losses": [s["loss"] for s in steps], "steps": steps, "grads": grads,
           "hessian": kept.get("hessian"),
           "layout": "one rank" if mesh is None else f"data={mesh.n_data} model={mesh.n_model}"}
    if evaluate:
        test_set = handler.prepare_dataset(handler.data_split["test"], "test")
        handler.uid["test"] = test_set.uid
        t, c0 = time.perf_counter(), COLLECTIVES["seconds"]
        cltor = handler.test_model(test_set, "test")["pred"]
        out.update(eval_s=time.perf_counter() - t, eval_collective_s=COLLECTIVES["seconds"] - c0,
                   bags_evaluated=int(len(cltor["uid"])))
        metrics = handler.evaluator.compute(cltor, handler.metrics_list, **handler.eval_kws())
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["launches"] = launch_counts(ab, co)
    release_pinned_batches()
    return out


def mp_rank(rank: int, world: int, rendezvous: str, root: str, device_type: str = "cuda") -> None:
    """One rank of phase 3t: every SP pool case on each grid, then the
    flagship's and the SA's steps on MP_MESH; its record, with the failures
    it gathered (`DEFERRED`), to <root>/rank<r>.pt."""
    global DEFERRED, QUIET
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    torch.set_num_threads(2)
    from vlsa_tpu_torch.ops import abmil as ab
    from vlsa_tpu_torch.ops import coattn as co
    from vlsa_tpu_torch.parallel import make_mesh
    from vlsa_tpu_torch.parallel.multihost import init_local_rank, rank_device
    init_local_rank(rank, world, rendezvous, device_type)
    device = rank_device(device_type)
    record = {"rank": rank, "device": str(device), "failures": [], "sp": {}, "runs": {}}
    DEFERRED, QUIET = record["failures"], rank != 0
    try:
        t0 = time.perf_counter()
        for grid, shape in MP_GRIDS.items():
            mesh = make_mesh(*shape)
            for storage, dx in MP_COATTN:
                record["sp"][f"{grid} coattn {storage}{' dX' if dx else ''}"] = mp_coattn_case(
                    torch, ab, co, mesh, grid, storage, dx, device)
            for storage, dx in MP_ABMIL:
                record["sp"][f"{grid} abmil {storage}{' dX' if dx else ''}"] = mp_abmil_case(
                    torch, ab, co, mesh, grid, storage, dx, device)
        record["sp_s"] = time.perf_counter() - t0
        for kind in ("vlsa", "sa"):
            t0 = time.perf_counter()
            record["runs"][kind] = mp_steps(torch, ab, co, device,
                                            mp_cfg(kind, root, f"{kind}_grid", True))
            record[f"{kind}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name, kind, changes, grid, n_steps in MP_A18_RUNS:
            record["runs"][name] = mp_steps(torch, ab, co, device,
                                            mp_cfg(kind, root, f"{name}_grid", grid, **changes),
                                            n_steps=n_steps, evaluate=False)
        record["a18_s"] = time.perf_counter() - t0
        torch.save(record, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def torch_device_type(device) -> str:
    return str(device).split(":")[0]


def mp_distributed_sa(tmp, device) -> dict:
    """Two processes of `python -m vlsa_tpu_torch.main --handler SA`, joined
    through a `distributed` dict on mesh {data: 2}, each with its own save
    path: both finish, evaluate rank 0's last checkpoint (it alone reads it
    and sends it on), print the same final metrics, and only rank 0 writes
    the run's files."""
    import yaml
    from vlsa_tpu_torch.main import read_metrics
    from vlsa_tpu_torch.parallel.multihost import coordinator_port
    port, held = coordinator_port()
    procs, saves, outs = [], [], []
    t0 = time.perf_counter()
    try:
        for pid in (0, 1):
            cfg = dict(LIFECYCLE_SA_CFG, save_path=os.path.join(tmp, f"sa_dist{pid}"),
                       path_patch=MP_DIST_BAGS, fixed_bucket=MP_DIST_BUCKET, mesh={"data": 2},
                       distributed={"coordinator_address": f"127.0.0.1:{port}",
                                    "num_processes": 2, "process_id": pid})
            path = os.path.join(tmp, f"sa_dist{pid}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            saves.append(cfg["save_path"])
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "vlsa_tpu_torch.main", "--config", path, "--handler",
                 "SA", "--device", torch_device_type(device)], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            outs.append(p.communicate(timeout=MP_DIST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        held.close()
    seconds = time.perf_counter() - t0
    for pid, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"3t distributed SA process {pid} exited {p.returncode}: "
                                 f"{out[-3000:]}")
    got = [read_metrics(out) for out in outs]
    check(all(len(m) == 1 for m in got), f"3t distributed SA: metrics lines {got}")
    check(got[0] == got[1], f"3t distributed SA: the ranks' metrics differ: {got}")
    check(os.path.exists(os.path.join(saves[0], "train_model-last.ckpt"))
          and not os.path.exists(saves[1]), "3t distributed SA: the run's files are not "
                                            "rank 0's alone")
    check(all("[lastckpt/train/test/pred]" in out for out in outs),
          "3t distributed SA: a rank did not evaluate the last checkpoint")
    metrics = got[0][0]
    check(all(math.isfinite(v) for m in metrics.values() for v in m.values()),
          f"3t distributed SA: non-finite metrics {metrics}")
    log(f"3t distributed SA (2 processes, gloo on one card): {seconds:.1f} s, test "
        f"c-index {metrics['test']['pred_c_index']:.4f}, the same on both ranks")
    return {"seconds": seconds, "metrics": metrics, "backend": "gloo" if "(gloo)" in outs[0]
            else "other"}


def rel_gap(a, b) -> float:
    """max|a - b| / max|b| (a tensor), or |a - b| / |b| (a float)."""
    if isinstance(a, float):
        return abs(a - b) / abs(b)
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def mp_bf16_tower(grid, one, one_f32) -> dict:
    """The flagship's first step on the grid against one rank's, both with
    the bf16 tower: its loss and each gradient within MP_BF16_TP times
    bf16's own effect there (one rank's against one rank's with the tower
    in f32), or within TOL_MP_LOSS where that is larger."""
    held = {"loss": (grid["losses"][0], one["losses"][0], one_f32["losses"][0])}
    check(grid["grads"].keys() == one["grads"].keys() == one_f32["grads"].keys(),
          "3t vlsa: the grid and one rank train other parameters")
    held.update({n: (grid["grads"][n], one["grads"][n], one_f32["grads"][n])
                 for n in one["grads"]})
    out = {}
    for n, (g, o, f) in held.items():
        gap, effect = rel_gap(g, o), rel_gap(o, f)
        out[n] = {"grid_vs_one": gap, "bf16_vs_f32": effect}
        check(gap <= max(MP_BF16_TP * effect, TOL_MP_LOSS),
              f"3t vlsa first step {n}: the grid is {gap:.2e} off one rank, bf16's own effect "
              f"{effect:.2e}")
    worst = max(out, key=lambda n: out[n]["grid_vs_one"] / max(out[n]["bf16_vs_f32"], 1e-30))
    log(f"3t vlsa first step, bf16 tower: loss grid vs one rank {out['loss']['grid_vs_one']:.2e} "
        f"(bf16 vs f32 tower {out['loss']['bf16_vs_f32']:.2e}); {len(out) - 1} gradients, the "
        f"nearest its limit {worst} {out[worst]['grid_vs_one']:.2e} "
        f"(bf16 vs f32 {out[worst]['bf16_vs_f32']:.2e})")
    return out


def mp_a18_held(torch, ab, co, device, tmp, ranks) -> dict:
    """Each of MP_A18_RUNS on the grid (every rank's losses, first-step
    gradients and Hessian estimates the same) against one rank's run of the
    same global steps: the losses within TOL_MP_LOSS, the first step's
    gradients and (adahessian) Hessian estimate within TOL_GRAD (max|a - b|
    / max|b|, each parameter; MP_SHIFT_LEAF against the largest
    gradient)."""
    held = {}
    for name, kind, changes, _grid, n_steps in MP_A18_RUNS:
        grid = [r["runs"][name] for r in ranks]
        for r in grid[1:]:
            check(r["losses"] == grid[0]["losses"] and r["grads"].keys() == grid[0]["grads"].keys()
                  and all(torch.equal(r["grads"][n], grid[0]["grads"][n]) for n in r["grads"]),
                  f"3t {name}: the ranks disagree")
        one = mp_steps(torch, ab, co, device, mp_cfg(kind, tmp, f"{name}_one", False, **changes),
                       n_steps=n_steps, evaluate=False)
        g, o = grid[0], one
        check(g["grads"].keys() == o["grads"].keys() and g["grads"],
              f"3t {name}: the grid and one rank train other parameters")
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], o["losses"]))
        grad_gaps = {n: rel_gap(g["grads"][n], o["grads"][n]) for n in o["grads"]}
        shift = MP_SHIFT_LEAF.get(changes.get("loss_type"))
        if shift is not None:
            top = max(float(t.abs().max()) for t in o["grads"].values())
            noise = float(o["grads"][shift].abs().max()) / top
            grad_gaps[shift] = float((g["grads"][shift] - o["grads"][shift]).abs().max()) / top
            log(f"3t {name}: {shift}, the shift the loss is invariant to: its gradient "
                f"{noise:.2e} of the largest (at most {MP_SHIFT_NOISE:g}), held against the "
                f"largest")
            check(noise <= MP_SHIFT_NOISE, f"3t {name}: {shift}'s gradient is {noise:.2e} of "
                                           f"the largest, not rounding noise")
        worst = max(grad_gaps, key=grad_gaps.get)
        log(f"3t {name} ({g['layout']}, {n_steps} steps): losses grid {g['losses']} one rank "
            f"{o['losses']} (gap {loss_gap:.2e}, tol {TOL_MP_LOSS}); first step's gradients: "
            f"{len(grad_gaps)}, the farthest {worst} {grad_gaps[worst]:.2e} (tol {TOL_GRAD})")
        check(len(g["losses"]) == n_steps == len(o["losses"]), f"3t {name}: steps")
        check(loss_gap <= TOL_MP_LOSS, f"3t {name}: the grid's losses are {loss_gap:.2e} off "
                                       f"one rank's")
        check(grad_gaps[worst] <= TOL_GRAD, f"3t {name}: gradient {worst} is "
                                            f"{grad_gaps[worst]:.2e} off one rank's")
        held[name] = {"losses_grid": g["losses"], "losses_one": o["losses"],
                      "loss_gap": loss_gap, "grad_gap_max": grad_gaps[worst],
                      "grad_gap_leaf": worst, "steps_grid": g["steps"], "steps_one": o["steps"],
                      "layout": g["layout"]}
        if changes.get("opt_name") == "adahessian":
            for r in grid[1:]:
                check(all(torch.equal(r["hessian"][n], grid[0]["hessian"][n])
                          for n in grid[0]["hessian"]), f"3t {name}: the ranks' Hessian "
                                                        f"estimates disagree")
            check(g["hessian"].keys() == o["hessian"].keys()
                  and any(float(h.abs().max()) > 0 for h in o["hessian"].values()),
                  f"3t {name}: the grid and one rank estimate other parameters, or only zeros")
            h_gaps = {n: rel_gap(g["hessian"][n], o["hessian"][n]) for n in o["hessian"]}
            h_worst = max(h_gaps, key=h_gaps.get)
            log(f"3t {name}: the first step's Hessian estimates: {len(h_gaps)}, the farthest "
                f"{h_worst} {h_gaps[h_worst]:.2e} (tol {TOL_GRAD})")
            check(h_gaps[h_worst] <= TOL_GRAD, f"3t {name}: Hessian estimate {h_worst} is "
                                               f"{h_gaps[h_worst]:.2e} off one rank's")
            held[name].update(hessian_gap_max=h_gaps[h_worst], hessian_gap_leaf=h_worst)
        o.pop("grads")
        o.pop("hessian")
    return held


def phase_multiprocess(torch, ab, co, device, card) -> dict:
    """Phase 3t: four ranks on the card (`mp_rank`), the same runs on one
    rank here, then the two-process `distributed` SA through the command
    line.  Fails on any rank's failure, a loss off one rank's by more than
    TOL_MP_LOSS, or ranks whose metrics differ."""
    import torch.multiprocessing as mp
    from vlsa_tpu_torch.parallel.multihost import local_rendezvous
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        t0 = time.perf_counter()
        try:
            mp.start_processes(mp_rank, args=(MP_WORLD, local_rendezvous(tmp), tmp, device.type),
                               nprocs=MP_WORLD, join=True, start_method="spawn")
        except Exception as exc:  # a rank that died: its traceback
            raise SmokeFailure(f"3t: a rank failed: {exc}") from exc
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(MP_WORLD)]
        failures = [f for r in ranks for f in r["failures"]]
        check(not failures, f"3t: {failures}")
        single = {kind: mp_steps(torch, ab, co, device, mp_cfg(kind, tmp, f"{kind}_one", False))
                  for kind in ("vlsa", "vlsa_f32", "sa")}
        bf16_tower = mp_bf16_tower(ranks[0]["runs"]["vlsa"], single["vlsa"], single["vlsa_f32"])
        a18 = mp_a18_held(torch, ab, co, device, tmp, ranks)
        for run in [*single.values(), *(r["runs"][k] for r in ranks for k in r["runs"])]:
            run.pop("grads", None)  # held above; the record stays JSON
            run.pop("hessian", None)
        for kind in ("vlsa", "sa"):
            grid = [r["runs"][kind] for r in ranks]
            for r in grid[1:]:
                check(r["losses"] == grid[0]["losses"] and r["metrics"] == grid[0]["metrics"],
                      f"3t {kind}: the ranks disagree: {r['losses']} {grid[0]['losses']}")
            gaps = [abs(a - b) / abs(b) for a, b in zip(grid[0]["losses"], single[kind]["losses"])]
            log(f"3t {kind} losses: grid {grid[0]['losses']} one rank {single[kind]['losses']} "
                f"(gap {max(gaps):.2e}" + (f", tol {TOL_MP_LOSS})" if kind == "sa" else ")"))
            if kind == "sa":
                check(max(gaps) <= TOL_MP_LOSS, f"3t sa: the grid's losses are {max(gaps):.2e} "
                                                f"off one rank's")
            check(grid[0]["bags_evaluated"] == single[kind]["bags_evaluated"],
                  f"3t {kind}: {grid[0]['bags_evaluated']} bags evaluated, one rank "
                  f"{single[kind]['bags_evaluated']}")
            for layout, run in (("data=2 model=2", grid[0]), ("one rank", single[kind])):
                coll = sum(s["collective_s"] for s in run["steps"])
                step_s = sum(s["ms"] for s in run["steps"]) / 1e3
                log(f"3t {kind} step ms by layout [{layout}]: "
                    f"{[round(s['ms'], 1) for s in run['steps']]}, collectives "
                    f"{coll:.3f} s of {step_s:.3f} s ({100 * coll / step_s:.1f}%), evaluation "
                    f"{run['eval_s']:.2f} s ({run['eval_collective_s']:.3f} s collectives) "
                    f"[{card}]")
        dist_sa = mp_distributed_sa(tmp, device)
        launches = {}
        for r in ranks:
            parts = [c["launches"] for c in r["sp"].values()] \
                + [run["launches"] for run in r["runs"].values()]
            for part in parts:
                for fam, counts in part.items():
                    for v, n in counts.items():
                        launches.setdefault(fam, {}).setdefault(v, 0)
                        launches[fam][v] += n
        sp_errs = {k: v["errors"] for k, v in ranks[0]["sp"].items()}
        return {"ranks_s": ranks_s, "ranks": [{k: r[k] for k in ("rank", "device", "sp_s",
                                                                  "vlsa_s", "sa_s", "a18_s")}
                                               for r in ranks],
                "grid": {k: ranks[0]["runs"][k] for k in ("vlsa", "sa")}, "one_rank": single,
                "bf16_tower": bf16_tower, "a18": a18,
                "sp_errors_rank0": sp_errs, "distributed_sa": dist_sa, "launches": launches,
                "reduced": MP_REDUCED, "card": card}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 4

def median_ms(torch, fn, runs=25, warmup=3):
    """Median over `runs` launches of fn, each timed with CUDA events after
    the L2 cache was flushed by a 256 MiB write."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def bound(B, N, C, P, variant):
    """Least time for the work on an H100, as `bound_ms` reckons it.  Bytes: x, mask, the
    sidecar rows and q read once; out, m and l written once.  Operations:
    the logit dot and the PV product, 2*P*C each per element, plus the row
    norm (2*C per element) where the kernel computes it."""
    storage = storage_of(variant)
    item = {"f32": 4, "bf16": 2, "int8": 1}[storage]
    rows = (1 if storage == "int8" else 0) + (1 if variant.endswith("_inv") else 0)
    nbytes = B * N * C * item + B * N + 4 * B * N * rows + 4 * P * C + 4 * B * P * (C + 2)
    ops = B * N * C * (4 * P + (0 if variant.endswith("_inv") else 2))
    return bound_ms(nbytes, ops, storage)


def time_variant(torch, co, variant, B, N, C, P):
    import torch.nn.functional as F
    q, x, mask, xs, xi = make_inputs(torch, B, N, C, P, variant, seed=1)
    fwd_err = hold(f"kernel {variant} at B={B} N={N}", co.coattn_fwd(q, x, mask, SCALE, xs, xi)[0],
                   co.coattn_pool_reference(q, x, mask, SCALE, xs), TOL[storage_of(variant)])
    k_ms = median_ms(torch, lambda: co.coattn_fwd(q, x, mask, SCALE, xs, xi))
    p_ms = median_ms(torch, lambda: co.coattn_pool_reference(q, x, mask, SCALE, xs))
    # yardstick: one fused attention call on pre-normalised keys (values in
    # f32 for f32 storage, else bf16: the library takes no int8)
    xf = co.dequantize_feats(x, xs).float()
    lib_dtype = torch.float32 if storage_of(variant) == "f32" else torch.bfloat16
    kn = torch.nn.functional.normalize(xf, dim=-1).to(lib_dtype)[:, None]
    vv = xf.to(lib_dtype)[:, None]
    qq = q.to(lib_dtype)[None, None].expand(B, 1, P, C)
    am = mask[:, None, None, :]
    del xf
    lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kn, vv, attn_mask=am, scale=SCALE))
    b_ms, b_by = bound(B, N, C, P, variant)
    return {"B": B, "N": N, "C": C, "P": P, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by, "fwd_err": fwd_err}


def bound_dq(B, N, C, P, variant):
    """Least time for the dQ work on an H100, as `bound` reckons it.  Bytes:
    x, mask, the sidecar rows, g, out, the stats (m, l) and q read once; dq
    written once (the kernel's partial-dq workspace is its own design, not
    the function's work).  Operations: the q and g dots and the dq product,
    2*P*C each per element, plus the row norm (2*C per element) where the
    kernel computes it."""
    storage = storage_of(variant)
    item = {"f32": 4, "bf16": 2, "int8": 1}[storage]
    rows = (1 if storage == "int8" else 0) + (1 if variant.endswith("_inv") else 0)
    nbytes = (B * N * C * item + B * N + 4 * B * N * rows + 4 * 2 * B * P * C
              + 4 * 2 * B * P + 4 * P * C + 4 * P * C)
    ops = B * N * C * (6 * P + (0 if variant.endswith("_inv") else 2))
    return bound_ms(nbytes, ops, storage)


def time_dq_variant(torch, co, variant, B, N, C, P):
    import torch.nn.functional as F
    q, x, mask, xs, xi = make_inputs(torch, B, N, C, P, variant, seed=1)
    out, m, l = co.coattn_fwd(q, x, mask, SCALE, xs, xi)
    g = make_cotangent(torch, B, P, C)
    shape = f"B={B} N={N}"
    fwd_err = hold(f"kernel {variant} at {shape}", out,
                   co.coattn_pool_reference(q, x, mask, SCALE, xs), TOL[storage_of(variant)])
    dq_err = hold(f"dq kernel {variant} at {shape}",
                  co.coattn_bwd_dq(q, x, mask, SCALE, g, out, m, l, xs, xi),
                  co.coattn_bwd_dq_reference(q, x, mask, SCALE, g, out, m, l, xs, xi),
                  TOL_DQ[storage_of(variant)])
    k_ms = median_ms(torch, lambda: co.coattn_bwd_dq(q, x, mask, SCALE, g, out, m, l, xs, xi))
    p_ms = median_ms(torch, lambda: co.coattn_bwd_dq_reference(
        q, x, mask, SCALE, g, out, m, l, xs, xi))
    # yardstick: the gradient with respect to q of one fused attention call
    # (its forward included) on pre-normalised keys, as in `time_variant`
    xf = co.dequantize_feats(x, xs).float()
    lib_dtype = torch.float32 if storage_of(variant) == "f32" else torch.bfloat16
    kn = torch.nn.functional.normalize(xf, dim=-1).to(lib_dtype)[:, None]
    vv = xf.to(lib_dtype)[:, None]
    del xf
    qq = q.to(lib_dtype)[None, None].expand(B, 1, P, C).contiguous().requires_grad_(True)
    gg = g.to(lib_dtype)[:, None]
    am = mask[:, None, None, :]
    lib_ms = median_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qq, kn, vv, attn_mask=am, scale=SCALE), qq, gg))
    b_ms, b_by = bound_dq(B, N, C, P, variant)
    plan = co.kernel_plan("coattn_bwd_dq", x.dtype, B, N,
                          torch.cuda.get_device_properties(0).multi_processor_count, C, P)
    return {"B": B, "N": N, "C": C, "P": P, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "blocks": plan["blocks"] * plan["groups"] * co.query_groups(P), "L": plan["L"],
            "fwd_err": fwd_err, "dq_err": dq_err}


def phase_times(torch, co):
    times = {"fwd_b8": {}, "fwd_b64": {}, "fwd_wide": {}, "dq_b8": {}, "dq_train": {}}
    for v in VARIANTS:
        times["fwd_b8"][v] = time_variant(torch, co, v, **SHAPE)
        torch.cuda.empty_cache()
        times["dq_b8"][v] = time_dq_variant(torch, co, v, **SHAPE)
        torch.cuda.empty_cache()
    for P in QUERY_TIMED:  # the query groups on the grid
        times[f"fwd_q{P}"], times[f"dq_q{P}"] = {}, {}
        for v in VARIANTS:
            times[f"fwd_q{P}"][v] = time_variant(torch, co, v, **dict(SHAPE, P=P))
            torch.cuda.empty_cache()
            times[f"dq_q{P}"][v] = time_dq_variant(torch, co, v, **dict(SHAPE, P=P))
            torch.cuda.empty_cache()
    for v in VARIANTS:
        times["fwd_b64"][v] = time_variant(torch, co, v, **dict(SHAPE, B=64))
        torch.cuda.empty_cache()
    for v in ("f32", "bf16", "int8_inv"):  # the wide instance, one variant a storage
        times["fwd_wide"][v] = time_variant(torch, co, v, **dict(SHAPE, C=FWD_WIDE["C"]))
        torch.cuda.empty_cache()
    for v in ("bf16", "int8_inv"):
        times["dq_train"][v] = time_dq_variant(torch, co, v, **TRAIN_SHAPE)
        torch.cuda.empty_cache()
    for key, recs in times.items():
        for v, t in recs.items():
            log(f"time {key:8s} B={t['B']:<3d} N={t['N']:<6d} C={t['C']:<4d} {v:9s} "
                f"kernel {t['ms']:.4f} ms"
                f"  plain {t['plain_ms']:.4f} ms  library {t['library_ms']:.4f} ms"
                f"  bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
                f"  kernel/bound {t['ms'] / t['bound_ms']:.1f}x"
                f"  kernel/library {t['ms'] / t['library_ms']:.2f}x"
                + (f"  blocks {t['blocks']} of L={t['L']} tiles" if "blocks" in t else ""))
    # what bounds each row at SHAPE with the shipped P and at QUERY_BOUND_P
    turns = {}
    for v in VARIANTS:
        for name, fn in (("coattn_fwd", bound), ("coattn_bwd_dq", bound_dq)):
            turns[f"{name}[{v}]"] = {P: fn(SHAPE["B"], SHAPE["N"], SHAPE["C"], P, v)
                                     for P in (SHAPE["P"], QUERY_BOUND_P)}
    for s_ in DX_STORAGES:
        turns[f"coattn_bwd_dx[{s_}]"] = {P: bound_dx(SHAPE["B"], SHAPE["N"], SHAPE["C"], P, s_)
                                         for P in (SHAPE["P"], QUERY_BOUND_P)}
    log(f"bound at B={SHAPE['B']} N={SHAPE['N']} C={SHAPE['C']}, P={SHAPE['P']} -> "
        f"P={QUERY_BOUND_P}: " + "; ".join(
            f"{k} {r[SHAPE['P']][0]:.4f} ms ({r[SHAPE['P']][1]}) -> "
            f"{r[QUERY_BOUND_P][0]:.4f} ms ({r[QUERY_BOUND_P][1]})" for k, r in turns.items()))
    times["bound_by_P"] = {k: {str(P): {"bound_ms": b, "bound_by": by} for P, (b, by) in r.items()}
                           for k, r in turns.items()}
    return times


# ---------------------------------------------------------------- phase 4b

def bound_abmil(name, B, N, storage, D=512, H=256, precise=False):
    """Least time for an ABMIL kernel's work on an H100 at x [B, N, D], W1
    [H, D], as `bound` reckons it, every patch slot of the batch counted,
    and what bounds it.  Bytes: x, the mask, the int8 scales, W1, b1 and w2
    read once, and out, m, l written once (forward); the backward reads g,
    out, m and l besides and writes dW1, db1, dw2 and, with dX, dX in the
    storage type.  Operations: the forward's bottleneck product 2*D*hid per
    patch plus the w2 dot and the PV sum (2*hid + 2*D); the backward's
    4*D*hid per patch for the weight gradients (the h and dW1 products),
    6*D*hid with dX (vlsa_tpu/ops/abmil.py:307's count); bf16 in precise
    mode does each of those products twice (W1 or dz as hi + lo); f32 as
    `bound_ms` reckons it."""
    item = {"f32": 4, "bf16": 2, "int8": 1}[storage]
    parts = 2 if precise else 1
    rows = B * N
    weights = 4 * (H * D + 2 * H)
    nbytes = rows * D * item + rows + (4 * rows if storage == "int8" else 0) + weights
    if name == "abmil_fwd":
        nbytes += 4 * B * D + 8 * B
        ops = rows * (2 * D * H * parts + 2 * H + 2 * D)
    else:
        nbytes += 4 * 2 * B * D + 8 * B + weights
        ops = rows * D * H * (6 if name == "abmil_bwd_dx" else 4) * parts
        if name == "abmil_bwd_dx":
            nbytes += rows * D * item
    return bound_ms(nbytes, ops, storage)


def floor_abmil_bf16_bwd(name, B, N, storage="bf16", D=512, H=256, precise=False):
    """The bf16-operand backward design's byte floor in ms (not a bound of
    the function): x read twice (passes 1 and 2) and the bf16 dz workspace
    [B, N, H] (int8 and precise: two planes) written and read once, plus dX
    written (with dX)."""
    item = 1 if storage == "int8" else 2
    planes = 2 if storage == "int8" or precise else 1
    nbytes = (2 * B * N * D * item + 2 * planes * B * N * H * 2
              + (B * N * D * 2 if name == "abmil_bwd_dx" else 0))
    return 1e3 * nbytes / HBM_BYTES_PER_S


def gemm_yardstick(torch, x, w1):
    """One cuBLAS x @ W1^T [B*N, hid] in the storage type (int8: torch._int_mm
    against W1 quantized to int8), which the port never calls."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.int8:
        s = w1.abs().amax() / 127.0
        wq = torch.round(w1 / s).to(torch.int8).T  # [D, hid], column-major
        return lambda: torch._int_mm(x2, wq)
    w = w1.to(x.dtype)
    return lambda: x2 @ w.T


def time_abmil(torch, ab, storage, B, N, D=512, H=256, precise=False):
    """Each kernel's time (forward; backward weights only; with dX for f32
    and bf16) beside its plain version's, the gemm yardstick and the bound,
    at x [B, N, D], W1 [H, D]; bf16 in precise mode when `precise` (its
    plain version then the model of its rounding)."""
    x, xs, mask, w1, b1, w2, g = inputs = make_abmil_inputs(torch, B, N, storage, seed=1, D=D,
                                                            H=H)
    mode = abmil_precise(ab) if precise else contextlib.nullcontext()
    with mode:
        if precise:
            errs, (out, m, l) = hold_abmil_precise(torch, ab, x, mask, w1, b1, w2, g,
                                                   f"at B={B} N={N}")
        else:
            errs, (out, m, l) = hold_abmil(torch, ab, *inputs, storage, f"at B={B} N={N}")
        try:
            gemm_ms = median_ms(torch, gemm_yardstick(torch, x, w1))
        except RuntimeError as exc:  # the yardstick only: the port never calls it
            log(f"gemm yardstick {storage} at B={B} N={N} unavailable: {exc}")
            gemm_ms = None
        recs = {"abmil_fwd": {
            "ms": median_ms(torch, lambda: abmil_fwd_kernel(ab, x, xs, mask, w1, b1, w2)),
            "plain_ms": median_ms(torch, lambda: ab.abmil_fwd_rounded(
                x, mask, w1, b1, w2, x_scale=xs, precise=True) if precise
                else ab.abmil_fwd_reference(x, mask, w1, b1, w2, x_scale=xs))}}
        for need_dx in ((False,) if storage == "int8" else (False, True)):
            name = "abmil_bwd_dx" if need_dx else "abmil_bwd"
            recs[name] = {
                "ms": median_ms(torch, lambda: abmil_bwd_kernel(ab, x, xs, mask, w1, b1, w2, g,
                                                                out, m, l, need_dx)),
                "plain_ms": median_ms(torch, lambda: ab.abmil_bwd_rounded(
                    x, mask, w1, b1, w2, g, out, m, l, x_scale=xs, need_dx=need_dx,
                    precise=precise))}
    for name, rec in recs.items():
        b_ms, b_by = bound_abmil(name, B, N, storage, D, H, precise)
        rec.update(B=B, N=N, D=D, hid=H, precise=precise, route=ab.route(x.dtype, D, H, precise),
                   gemm_ms=gemm_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   err=errs[name])
        if storage != "f32" and name != "abmil_fwd":
            rec["design_floor_ms"] = floor_abmil_bf16_bwd(name, B, N, storage, D, H, precise)
    return recs


def phase_abmil_times(torch, ab):
    """Every storage at D=512, hid=256 at B=8, N=10240 and the training
    shape; at the other ABMIL_WIDTHS and at ABMIL_ANY_TIMED at B=8,
    N=10240; precise bf16 at ABMIL_PRECISE_WIDTHS."""
    times = {"b8": {}, "train": {}}
    for key, shape in (("b8", ABMIL_SHAPE), ("train", ABMIL_TRAIN_SHAPE)):
        for s in ABMIL_STORAGES:
            for name, rec in time_abmil(torch, ab, s, **shape).items():
                times[key][f"{name}[{s}]"] = rec
            torch.cuda.empty_cache()
    for D, H in ABMIL_WIDTHS[1:]:
        for s in ABMIL_STORAGES:
            for name, rec in time_abmil(torch, ab, s, **ABMIL_SHAPE, D=D, H=H).items():
                times["b8"][f"{name}[{s},D={D},hid={H}]"] = rec
            torch.cuda.empty_cache()
    for D, H in ABMIL_ANY_TIMED:
        for s in ABMIL_STORAGES:
            for name, rec in time_abmil(torch, ab, s, **ABMIL_SHAPE, D=D, H=H).items():
                times["b8"][f"{name}[{s},D={D},hid={H}]"] = rec
            torch.cuda.empty_cache()
    for D, H in ABMIL_PRECISE_WIDTHS:
        for name, rec in time_abmil(torch, ab, "bf16", **ABMIL_SHAPE, D=D, H=H,
                                    precise=True).items():
            times["b8"][f"{name}[bf16_precise,D={D},hid={H}]"] = rec
        torch.cuda.empty_cache()
    times["wide"] = {}  # the wide route (D past 8192), phase 2g's
    for s in ABMIL_STORAGES:
        for name, rec in time_abmil(torch, ab, s, **ANY_WIDTH_TIMED_4B).items():
            times["wide"][f"{name}[{s}]"] = rec
        torch.cuda.empty_cache()
    for key, recs in times.items():
        for k, t in recs.items():
            gemm = "n/a" if t["gemm_ms"] is None else f"{t['gemm_ms']:.4f} ms"
            floor = (f"  design byte floor {t['design_floor_ms']:.4f} ms"
                     if "design_floor_ms" in t else "")
            log(f"time {k:38s} B={t['B']:<3d} N={t['N']:<6d} kernel {t['ms']:.4f} ms"
                f"  plain {t['plain_ms']:.4f} ms  gemm {gemm}"
                f"  bound {t['bound_ms']:.4f} ms ({t['bound_by']}){floor}"
                f"  kernel/bound {t['ms'] / t['bound_ms']:.1f}x  ({t['route']})")
    return times


# ---------------------------------------------------------------- phase 4c

def bound_flash(B, H, L, variant, hd=64):
    """Least time for the attention on an H100: max(bytes / HBM rate,
    products / peak of the type, exponentials / SFU rate).  Bytes: q, k, v
    read once in the variant's type, the f32 output written once.
    Operations: Q K^T and P V, 2*L*hd each per query row; one exponential
    per score, B*H*L^2, at EXP_PER_S."""
    item = 2 if variant == "bf16" else 4
    nbytes = 3 * B * H * L * hd * item + 4 * B * H * L * hd
    ops = 4 * B * H * L * L * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[variant]
    t_exp = B * H * L * L / EXP_PER_S
    return 1e3 * max(t_bytes, t_ops, t_exp), ("bytes" if t_bytes >= max(t_ops, t_exp)
                                              else "operations")


def floor_flash_streamed(B, H, L, hd=64):
    """The streamed bf16 design's own floor in ms (not a bound of the
    function), and what sets it: its two sweeps over query and key tiles of
    64 (L padded to Lp = 64 ceil(L / 64)) do 6 * hd products per padded
    score (Q K^T twice, P V once: 1.5x the function's) and 2 exponentials
    per padded score, at the card's bf16 and SFU peaks, beside the
    function's bytes."""
    from vlsa_tpu_torch.ops.flash_attn import STREAMED_ROWS, STREAMED_TILE_K
    lq = -(-L // STREAMED_ROWS) * STREAMED_ROWS
    lk = -(-L // STREAMED_TILE_K) * STREAMED_TILE_K
    t_bytes = (3 * B * H * L * hd * 2 + 4 * B * H * L * hd) / HBM_BYTES_PER_S
    t_ops = 6 * B * H * lq * lk * hd / PEAK_OPS["bf16"]
    t_exp = 2 * B * H * lq * lk / EXP_PER_S
    by = max((t_bytes, "bytes"), (t_ops, "operations"), (t_exp, "exponentials"))[1]
    return 1e3 * max(t_bytes, t_ops, t_exp), by


def phase_flash_times(torch, fa):
    """The flash kernels at B=64, H=12: bf16 at L = 197 and 785 on both
    paths, in turns (resident, streamed, streamed, resident), and at L =
    1025 on the streamed path, f32 at 785; each beside its plain version and
    one scaled_dot_product_attention call on the same inputs (the yardstick;
    the port never calls it), the bound and, for the streamed path, the
    design's floor."""
    import torch.nn.functional as F
    times = {}
    B, H = FLASH_SHAPE["B"], FLASH_SHAPE["H"]
    cases = [("bf16", L) for L in FLASH_TIMED_LENGTHS] + [("f32", FLASH_SHAPE["L"])]
    for v, L in cases:
        q, k, vv = make_qkv(torch, B, H, L, variant=v, seed=1)
        if v == "f32":
            paths = (None,)
        else:
            paths = ("resident", "streamed") if L <= fa.RESIDENT_CAPACITY else ("streamed",)
        ref = fa.flash_self_attention_reference(q, k, vv)
        errs = {p: hold(f"flash {v}{'' if p is None else ' ' + p} at the timed shape L={L}",
                        fa.flash_attn_fwd(q, k, vv, _force_path=p), ref, TOL_FLASH[v])
                for p in paths}
        del ref
        runs = {p: [] for p in paths}
        for p in paths + paths[::-1]:
            runs[p].append(median_ms(torch, lambda: fa.flash_attn_fwd(q, k, vv, _force_path=p)))
        b_ms, b_by = bound_flash(B, H, L, variant=v)
        common = dict(B=B, H=H, L=L, bound_ms=b_ms, bound_by=b_by,
                      plain_ms=median_ms(torch, lambda: fa.flash_self_attention_reference(
                          q, k, vv)),
                      library_ms=median_ms(torch, lambda: F.scaled_dot_product_attention(
                          q, k, vv)))
        for p in paths:
            name = v if p is None else f"{v}_{p}"
            t = times[f"{name}_L{L}"] = dict(common, path=p, err=errs[p], ms=runs[p][0],
                                              ms_runs=runs[p])
            extra = ""
            if p == "streamed":
                t["floor_ms"], t["floor_by"] = floor_flash_streamed(B, H, L)
                extra = (f"  design floor {t['floor_ms']:.4f} ms ({t['floor_by']})  "
                         f"kernel/floor {t['ms'] / t['floor_ms']:.2f}x")
            log(f"time flash_attn_fwd[{name}] B=64 H=12 L={L} kernel "
                + " / ".join(f"{ms:.4f}" for ms in t["ms_runs"]) + f" ms  plain "
                f"{t['plain_ms']:.4f} ms  library {t['library_ms']:.4f} ms  bound {b_ms:.4f} ms "
                f"({b_by})  kernel/bound {t['ms'] / b_ms:.1f}x  kernel/library "
                f"{t['ms'] / t['library_ms']:.2f}x" + extra)
        del q, k, vv
        torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------- phase 4d

def bound_dx(B, N, C, P, storage):
    """Least time for the full backward's work on an H100, as `bound`
    reckons it.  Bytes: x read and dX written once in the storage type, the
    mask, and q, g, out, the stats (m, l) and dq in f32 (the partial-dq
    workspace is the kernel's design, not the function's work).
    Operations: the q and g dots, the dxhat and a^T g products and the dq
    product, 2*P*C each per element, plus the row norm, the projection and
    the combine, 6 per element."""
    item = {"f32": 4, "bf16": 2}[storage]
    nbytes = 2 * B * N * C * item + B * N + 4 * (2 * P * C + 2 * B * P * C + 2 * B * P)
    ops = B * N * C * (10 * P + 6)
    return bound_ms(nbytes, ops, storage)


def time_dx(torch, co, storage, B, N, C, P):
    import torch.nn.functional as F
    q, x, mask, _xs, _xi = make_inputs(torch, B, N, C, P, storage, seed=1, keep_masked=True)
    g = make_cotangent(torch, B, P, C)
    err, dx = hold_dx(torch, co, storage, q, x, mask, g, f"at B={B} N={N}")
    del dx
    out, m, l = co.coattn_fwd(q, x, mask, SCALE)
    k_ms = median_ms(torch, lambda: co.coattn_bwd_dx(q, x, mask, SCALE, g, out, m, l))
    p_ms = median_ms(torch, lambda: co.coattn_bwd_dx_reference(q, x, mask, SCALE, g, out, m, l))
    # yardstick: the gradient with respect to q, k and v of one fused
    # attention call (its forward included) on pre-normalised keys, as in
    # `time_dq_variant`
    xf = x.float()
    lib_dtype = torch.float32 if storage == "f32" else torch.bfloat16
    kn = F.normalize(xf, dim=-1).to(lib_dtype)[:, None].requires_grad_(True)
    vv = xf.to(lib_dtype)[:, None].requires_grad_(True)
    del xf
    qq = q.to(lib_dtype)[None, None].expand(B, 1, P, C).contiguous().requires_grad_(True)
    gg = g.to(lib_dtype)[:, None]
    am = mask[:, None, None, :]
    lib_ms = median_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qq, kn, vv, attn_mask=am, scale=SCALE), (qq, kn, vv), gg))
    b_ms, b_by = bound_dx(B, N, C, P, storage)
    plan = co.kernel_plan("coattn_bwd_dx", x.dtype, B, N,
                          torch.cuda.get_device_properties(0).multi_processor_count, C, P)
    return {"B": B, "N": N, "C": C, "P": P, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "blocks": plan["blocks"] * plan["groups"], "L": plan["L"], "err": err}


def phase_dx_times(torch, co):
    """The dX kernel at SHAPE, TRAIN_SHAPE, QUERY_TIMED and LOOP_TIMED_4D
    (phase 2g's route past 8,656 queries); then phase 2g's "chunked" forward
    and dQ (GRID_TIMED_VARIANT at GRID_TIMED_4D), as phase 4 times them."""
    loop = f"q{LOOP_TIMED_4D['P']}"
    times = {"b8": {}, "train": {}, **{f"q{P}": {} for P in QUERY_TIMED}, loop: {}}
    for key, storage, shape in (("b8", "f32", SHAPE), ("b8", "bf16", SHAPE),
                                ("train", "bf16", TRAIN_SHAPE),
                                *((f"q{P}", s_, dict(SHAPE, P=P))
                                  for P in QUERY_TIMED for s_ in DX_STORAGES),
                                *((loop, s_, LOOP_TIMED_4D) for s_ in DX_STORAGES)):
        times[key][storage] = t = time_dx(torch, co, storage, **shape)
        torch.cuda.empty_cache()
        log(f"time coattn_bwd_dx[{storage}] B={t['B']:<3d} N={t['N']:<6d} P={t['P']:<3d} "
            f"kernel {t['ms']:.4f} ms"
            f"  plain {t['plain_ms']:.4f} ms  library {t['library_ms']:.4f} ms"
            f"  bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
            f"  kernel/bound {t['ms'] / t['bound_ms']:.1f}x"
            f"  blocks {t['blocks']} of L={t['L']} tiles")
    v = GRID_TIMED_VARIANT
    times["chunked"] = {"fwd": time_variant(torch, co, v, **GRID_TIMED_4D),
                        "dq": time_dq_variant(torch, co, v, **GRID_TIMED_4D)}
    torch.cuda.empty_cache()
    for kind, t in times["chunked"].items():
        log(f"time {kind} chunked B={t['B']} N={t['N']} C={t['C']} P={t['P']} {v} "
            f"kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  library "
            f"{t['library_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return times


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full record here (JSON)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device is available")
        return 1
    sys.path.insert(0, ROOT)
    try:
        from vlsa_tpu_torch.data.pipeline import release_pinned_batches
        from vlsa_tpu_torch.ops import abmil as ab
        from vlsa_tpu_torch.ops import coattn as co
        from vlsa_tpu_torch.ops import flash_attn as fa
    except ImportError as exc:
        log(f"FAIL: the port is not beside this script ({exc})")
        return 1

    t_start = time.perf_counter()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else \
        "nvidia-smi unavailable"
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_s = {}

    def timed(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        release_pinned_batches()  # the batches a phase built outside a run
        return out
    try:
        errs = timed("2", phase_kernel, torch, co)
        coattn_ptxas_lines = coattn_fwd_ptxas(co)
        errs_dq = timed("2b", phase_backward_kernel, torch, co)
        coattn_bwd_ptxas_lines = coattn_bwd_ptxas(co)
        errs_abmil = timed("2c", phase_abmil_kernels, torch, ab)
        abmil_ptxas_lines = abmil_ptxas(ab)
        errs_flash, flash_ptxas_lines = timed("2d", phase_flash_kernel, torch, fa)
        errs_dx = timed("2e", phase_dx_kernel, torch, co)
        errs_q = timed("2f", phase_query_kernels, torch, co)
        any_2g = timed("2g", phase_any_width_and_queries, torch, ab, co)
        serving = timed("3", phase_serving, torch, co, device)
        training = timed("3b", phase_training, torch, co, device)
        sa_serving = timed("3c", phase_sa_serving, torch, ab, co, device)
        sa_training = timed("3d", phase_sa_training, torch, ab, co, device)
        extraction = timed("3e", phase_extraction, torch, fa, ab, co, device)
        extraction_512 = timed("3e-512", phase_extraction_512, torch, fa, ab, co, device)
        extraction_rest = timed("3q", phase_extraction_rest, torch, fa, ab, co, device,
                                extraction)
        captions = timed("3r", phase_captions, torch, fa, ab, co, device, card)
        feat_proj = timed("3f", phase_feat_proj_training, torch, co, device)
        lifecycle_vlsa = timed("3g-VLSA", phase_lifecycle, torch, ab, co, device, "vlsa", card)
        lifecycle_sa = timed("3g-SA", lambda: phase_lifecycle(
            torch, ab, co, device, "sa", card, path_patch=LIFECYCLE_SA_BAGS))
        stores_tmp = tempfile.mkdtemp(prefix="chip_smoke_stores_")
        kept = {}  # phase 3h's flagship model, for phase 3j's reload
        try:
            store_runs = timed("3h", phase_store_runs, torch, ab, co, device, card, stores_tmp,
                               kept)
            multiprocess = timed("3t", phase_multiprocess, torch, ab, co, device, card)
            flax_ckpt = timed("3s", phase_flax_checkpoint, torch, ab, co, device, card,
                              stores_tmp, kept)
            resume = timed("3u", phase_resume, torch, ab, co, device, card, stores_tmp, kept)
            zero_shot = timed("3i", phase_zero_shot, torch, ab, co, device, card, stores_tmp)
            interpretation = timed("3j", phase_interpretation, torch, ab, co, device, card,
                                   stores_tmp, kept)
            queries = timed("3l", phase_queries, torch, ab, co, device, card, stores_tmp)
            optim = timed("3n", phase_optimizers, torch, ab, co, device, card, stores_tmp)
            zoo = timed("3o", phase_zoo, torch, ab, co, device, card, stores_tmp)
            clf_text = timed("3p", phase_clf_and_text_apis, torch, ab, co, device, card,
                             stores_tmp)
        finally:
            kept.clear()
            shutil.rmtree(stores_tmp, ignore_errors=True)
        sa_1024 = timed("3k", phase_sa_1024, torch, ab, co, device, card)
        sa_2560 = timed("3m", phase_sa_2560, torch, ab, co, device, card)
        times = timed("4", phase_times, torch, co)
        abmil_times = timed("4b", phase_abmil_times, torch, ab)
        flash_times = timed("4c", phase_flash_times, torch, fa)
        dx_times = timed("4d", phase_dx_times, torch, co)
    except SmokeFailure as exc:
        log(f"FAIL: {exc}")
        return 1

    kernels = []
    # the whole runs' launches: phase 3g's, each of phase 3h's, 3i's, 3j's,
    # 3k's, 3m's, 3n's and 3p's, 3u's resumed flagship runs; 3s's evaluation
    # passes
    runs = [lifecycle_vlsa, lifecycle_sa] + list(store_runs["runs"].values()) \
        + list(resume["flagship"]["runs"].values()) \
        + list(zero_shot["runs"].values()) + [zero_shot["flagship"]] \
        + list(interpretation["runs"].values()) + list(sa_1024["runs"].values()) \
        + list(sa_2560["runs"].values()) + [optim["run"]] \
        + [clf_text[k] for k in ("clf_binary", "clf_multi", "CLIP", "HF")]

    def run_launches(family, variant):
        return sum(r["launches"][family][variant] for r in runs)
    mp_launches = multiprocess["launches"]  # phase 3t's ranks' pools and runs
    fwd_launches = {v: serving["launches"][v] + training["launches"]["fwd"][v]
                    + feat_proj["launches"]["fwd"][v] + run_launches("coattn_fwd", v)
                    + interpretation["launches"]["coattn_fwd"][v]
                    + flax_ckpt["launches"]["coattn_fwd"][v] + mp_launches["coattn_fwd"][v]
                    for v in VARIANTS}
    dq_launches = {v: training["launches"]["bwd"][v] + run_launches("coattn_bwd_dq", v)
                   + mp_launches["coattn_bwd_dq"][v] for v in VARIANTS}
    for name, source, replaces, err, t_by_variant, launches in (
            ("coattn_fwd", SOURCE, REPLACES, errs, times["fwd_b8"], fwd_launches),
            ("coattn_bwd_dq", SOURCE_DQ, REPLACES_DQ, errs_dq, times["dq_b8"], dq_launches)):
        for v in VARIANTS:
            t = t_by_variant[v]
            kernels.append({
                "name": f"{name}[{v}]", "route": "cuda", "source": source,
                "replaces": replaces[v], "launches": launches[v],
                "max_abs_err": err[v]["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"].split()[0],
                "library_ms": t["library_ms"]})
    for s in DX_STORAGES:
        t = dx_times["b8"][s]
        kernels.append({
            "name": f"coattn_bwd_dx[{s}]", "route": "cuda", "source": SOURCE_DX,
            "replaces": REPLACES_DX,
            "launches": feat_proj["launches"]["dx"][s] + mp_launches["coattn_bwd_dx"][s],
            "max_abs_err": errs_dx[s]["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"].split()[0], "library_ms": t["library_ms"]})
    # rows 1-6 at P=32 (the query groups' routes): launches of phase 3l's
    # paths, errors of 2f, times of 4 and 4d; the variants those paths do
    # not run are held and timed here alone ("on_main_path" false)
    for kind, name, source, replaces, variants in (
            ("fwd", "coattn_fwd", SOURCE, REPLACES, VARIANTS),
            ("dq", "coattn_bwd_dq", SOURCE_DQ, REPLACES_DQ, VARIANTS),
            ("dx", "coattn_bwd_dx", SOURCE_DX, dict.fromkeys(DX_STORAGES, REPLACES_DX),
             DX_STORAGES)):
        for v in variants:
            t = dx_times["q32"][v] if kind == "dx" else times[f"{kind}_q32"][v]
            err = errs_q[f"dx[{v}] P=32"] if kind == "dx" else errs_q[f"{v} P=32"][kind]
            kernels.append({
                "name": f"{name}[{v}] P=32", "route": "cuda", "source": source,
                "replaces": replaces[v], "launches": queries["launches"][kind][v],
                "max_abs_err": err["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"].split()[0],
                "library_ms": t["library_ms"], "queries": 32,
                "on_main_path": (kind, v) in QUERIES_PATH_KERNELS})
    abmil_launches = {"abmil_fwd": {s: sa_serving["launches"][s] + sa_training["launches"]["fwd"][s]
                                    + run_launches("abmil_fwd", s) + mp_launches["abmil_fwd"][s]
                                    for s in ABMIL_STORAGES},
                      "abmil_bwd": {s: sa_training["launches"]["bwd"][s]
                                    + run_launches("abmil_bwd", s) + mp_launches["abmil_bwd"][s]
                                    for s in ABMIL_STORAGES},
                      "abmil_bwd_dx": {s: sa_training["launches"]["bwd"][f"{s}_dx"]
                                       + mp_launches["abmil_bwd"][f"{s}_dx"]
                                       for s in ("f32", "bf16")}}
    # the D=512, hid=256 instances' launches come from the runs above but
    # 3k's and 3m's; the general instances' at 1024 from 3k's SA run at
    # 1024-256-12, at 2560 from 3m's runs at 2560-256-12, its projecter step
    # (the backward with dX) and 3n's optimizer steps (served requests and
    # gradient checks besides)
    def wide_launches(runs_):
        return {fam: {s: sum(r["launches"][fam][s] for r in runs_.values())
                      for s in ("f32", "int8")} for fam in ("abmil_fwd", "abmil_bwd")}
    general = wide_launches(sa_1024["runs"])
    any_width = wide_launches(sa_2560["runs"])
    for fam in ("abmil_fwd", "abmil_bwd"):
        for s in ("f32", "int8"):
            abmil_launches[fam][s] -= general[fam][s] + any_width[fam][s]
    any_width["abmil_fwd"]["f32"] += (sa_2560["after_runs"]["launches"]["fwd"]["f32"]
                                      + optim["sa_launches"]["fwd"])
    any_width["abmil_bwd"]["f32"] += optim["sa_launches"]["bwd"]
    for fam in ("abmil_fwd", "abmil_bwd"):  # 3u's resumed SA run at 64-32-12
        any_width[fam]["f32"] += resume["sa"]["launches"][fam]["f32"]
    any_width["abmil_bwd_dx"] = {"f32": sa_2560["after_runs"]["launches"]["bwd"]["f32_dx"]}
    held = [list(w) for w in ABMIL_WIDTHS]
    for name, storages in (("abmil_fwd", ABMIL_STORAGES), ("abmil_bwd", ABMIL_STORAGES),
                           ("abmil_bwd_dx", ("f32", "bf16"))):
        fwd = name == "abmil_fwd"
        for s in storages:
            t = abmil_times["b8"][f"{name}[{s}]"]
            kernels.append({
                "name": f"{name}[{s}]", "route": "cuda",
                "source": SOURCE_ABMIL if fwd else SOURCE_ABMIL_BWD,
                "replaces": (REPLACES_ABMIL if fwd else REPLACES_ABMIL_BWD)[s],
                "launches": abmil_launches[name][s],
                "max_abs_err": errs_abmil[s][name]["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"].split()[0], "library_ms": None,
                "widths": [[512, 256]]})
    # the general instances, timed at (1024, 256); bf16 in precise mode at
    # (512, 256).  The main paths run the general f32 and int8 forward and
    # weights-only backward (3k); the rest are held (2c) and timed (4b)
    # here alone: "on_main_path" false, their launches 0
    for name, storages in (("abmil_fwd", ABMIL_STORAGES), ("abmil_bwd", ABMIL_STORAGES),
                           ("abmil_bwd_dx", ("f32", "bf16"))):
        fwd = name == "abmil_fwd"
        for s, precise in [(s, False) for s in storages] + [("bf16", True)]:
            D, H = (512, 256) if precise else (1024, 256)
            tag = f"{s}_precise" if precise else s
            t = abmil_times["b8"][f"{name}[{tag},D={D},hid={H}]"]
            on_path = not precise and general.get(name, {}).get(s, 0) > 0
            kernels.append({
                "name": f"{name}_{'precise' if precise else 'general'}[{s}]", "route": "cuda",
                "source": SOURCE_ABMIL if fwd else SOURCE_ABMIL_BWD,
                "replaces": (REPLACES_ABMIL if fwd else REPLACES_ABMIL_BWD)[s],
                "launches": general[name][s] if on_path else 0,
                "max_abs_err": errs_abmil[f"{tag}_D{D}_h{H}"][name]["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"].split()[0], "library_ms": None,
                "widths": ([list(w) for w in ABMIL_PRECISE_WIDTHS] if precise
                           else [w for w in held if w != [512, 256]]),
                "timed_at": [D, H], "on_main_path": on_path})
    # every width: timed at (2560, 256), launches of 3m and 3n; the
    # variants those paths do not run are held (2c) and timed (4b) here
    # alone: "on_main_path" false, their launches 0
    for name, storages in (("abmil_fwd", ABMIL_STORAGES), ("abmil_bwd", ABMIL_STORAGES),
                           ("abmil_bwd_dx", ("f32", "bf16"))):
        fwd = name == "abmil_fwd"
        D, H = ABMIL_ANY_TIMED[0]
        for s in storages:
            t = abmil_times["b8"][f"{name}[{s},D={D},hid={H}]"]
            n = any_width.get(name, {}).get(s, 0)
            kernels.append({
                "name": f"{name}_any[{s}]", "route": "cuda",
                "source": SOURCE_ABMIL if fwd else SOURCE_ABMIL_BWD,
                "replaces": (REPLACES_ABMIL if fwd else REPLACES_ABMIL_BWD)[s],
                "launches": n, "max_abs_err": errs_abmil[f"{s}_D{D}_h{H}"][name]["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"].split()[0], "library_ms": None,
                "widths": [list(w) for w in ABMIL_ANY_WIDTHS], "timed_at": [D, H],
                "on_main_path": n > 0})
    # phase 2g's routes past the old limits, which no main path reaches (no
    # shipped config has D past 8192, hid past 1024 or P past 8,656): held in
    # 2g (their launches there in "held_launches"), timed in 4b and 4d,
    # "on_main_path" false, their main-path launches 0
    held_2g = any_2g["launches"]
    D, H = ANY_WIDTH_TIMED_4B["D"], ANY_WIDTH_TIMED_4B["H"]
    for name, storages in (("abmil_fwd", ABMIL_STORAGES), ("abmil_bwd", ABMIL_STORAGES),
                           ("abmil_bwd_dx", DX_STORAGES)):
        fwd = name == "abmil_fwd"
        for s in storages:
            t = abmil_times["wide"][f"{name}[{s}]"]
            kernels.append({
                "name": f"{name}_wide[{s}]", "route": "cuda",
                "source": SOURCE_ABMIL if fwd else SOURCE_ABMIL_BWD,
                "replaces": (REPLACES_ABMIL if fwd else REPLACES_ABMIL_BWD)[s], "launches": 0,
                "max_abs_err": any_2g["errors"][f"{s}_D{D}_h{H}"][name]["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"].split()[0], "library_ms": None,
                "widths": [list(w) for w in ANY_WIDTHS_2G if w[0] > 8192], "timed_at": [D, H],
                "on_main_path": False, "held_launches": held_2g["abmil_wide"][name][s]})
    P = LOOP_TIMED_4D["P"]
    for s in DX_STORAGES:
        t = dx_times[f"q{P}"][s]
        kernels.append({
            "name": f"coattn_bwd_dx[{s}] P={P}", "route": "cuda", "source": SOURCE_DX,
            "replaces": REPLACES_DX, "launches": 0,
            "max_abs_err": any_2g["errors"][f"dx[{s}] P={P}"]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"].split()[0], "library_ms": t["library_ms"], "queries": P,
            "on_main_path": False, "held_launches": held_2g["dx"][s][P]})
    v, P = GRID_TIMED_VARIANT, GRID_TIMED_4D["P"]
    for kind, name, source, replaces in (("fwd", "coattn_fwd", SOURCE, REPLACES),
                                         ("dq", "coattn_bwd_dq", SOURCE_DQ, REPLACES_DQ)):
        t = dx_times["chunked"][kind]
        kernels.append({
            "name": f"{name}[{v}] P={P}", "route": "cuda", "source": source,
            "replaces": replaces[v], "launches": 0,
            "max_abs_err": any_2g["errors"][f"{v} P={P}"][kind]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"].split()[0], "library_ms": t["library_ms"], "queries": P,
            "on_main_path": False, "held_launches": held_2g["chunked"][v][kind]})
    # bf16 on the path flash_plan names (the streamed kernel), timed at the
    # extraction shape; its launches those of both CONCH extraction runs, of
    # phase 3q's w8a8 trunk and of phase 3r's caption trunk
    for v in FLASH_VARIANTS:
        t = flash_times[f"{v}_{fa.flash_plan(FLASH_SHAPE['L'])[0]}_L{FLASH_SHAPE['L']}"
                        if v == "bf16" else f"{v}_L{FLASH_SHAPE['L']}"]
        kernels.append({
            "name": f"flash_attn_fwd[{v}]", "route": "cuda", "source": SOURCE_FLASH,
            "replaces": REPLACES_FLASH,
            "launches": (extraction["launches"][v] + extraction_512["launches"][v]
                         + extraction_rest["launches"][v] + captions["launches"][v]),
            "max_abs_err": errs_flash[v][FLASH_SHAPE["L"]]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    never = [k["name"] for k in kernels if k["launches"] <= 0 and k.get("on_main_path", True)]
    if never:
        log(f"FAIL: never launched on the main paths: {never}")
        return 1
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "shape": SHAPE, "train_shape": TRAIN_SHAPE, "kernel_errors": errs,
              "dq_errors": errs_dq, "serving": serving, "training": training,
              "times": times, "abmil_shape": ABMIL_SHAPE, "abmil_train_shape": ABMIL_TRAIN_SHAPE,
              "abmil_errors": errs_abmil, "sa_serving": sa_serving, "sa_training": sa_training,
              "abmil_times": abmil_times, "abmil_ptxas": abmil_ptxas_lines,
              "coattn_fwd_ptxas": coattn_ptxas_lines, "coattn_bwd_ptxas": coattn_bwd_ptxas_lines,
              "flash_shape": FLASH_SHAPE, "flash_errors": errs_flash,
              "flash_ptxas": flash_ptxas_lines,
              "flash_plan": {L: list(fa.flash_plan(L)) for L in FLASH_LENGTHS},
              "extraction": extraction, "extraction_512": extraction_512,
              "extraction_rest": extraction_rest, "flash_times": flash_times, "dx_errors": errs_dx,
              "feat_proj_training": feat_proj, "dx_times": dx_times,
              "lifecycle_vlsa": lifecycle_vlsa, "lifecycle_sa": lifecycle_sa,
              "store_runs": store_runs, "zero_shot": zero_shot,
              "interpretation": interpretation, "sa_1024": sa_1024, "sa_2560": sa_2560,
              "optimizers": optim, "zoo": zoo, "clf_text_apis": clf_text,
              "captions": captions, "flax_checkpoint": flax_ckpt, "multiprocess": multiprocess,
              "resume": resume,
              "query_errors": errs_q, "any_width_and_queries": any_2g,
              "queries": queries, "kernels": kernels,
              "phase_seconds": phase_s, "seconds": time.perf_counter() - t_start}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    log(f"all phases passed in {record['seconds']:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
